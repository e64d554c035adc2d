"""The device ray march (smh_tpu_torch/ops/lsd.py) against smh_tpu/ops/lsd.py
on seeded masks; the lane's sequential state machine and the CUDA kernel's
word-at-a-time march and u64-key reduction (re-stated here in numpy)
against the plain span formulation; and the three LSD engines (CudaBackend
"cuda" and "native", TpuBackend "tpu") on frames. The kernel itself runs
only on the card (chip_smoke.py)."""

import math
import pathlib
import re

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smh_tpu.ops import lsd as jlsd
from smh_tpu.vision import tpu_backend as tb
from smh_tpu_torch import consts as C, testing
from smh_tpu_torch.geometry import Point
from smh_tpu_torch.ops import lsd as tlsd
from smh_tpu_torch.vision import cuda_backend as cb
from smh_tpu_torch.vision import pixmath
from smh_tpu_torch.vision import reference as oracle
from test_torch_reference import _reference_native  # noqa: F401  (module-scoped autouse fixture)

torch.set_num_threads(1)


MAX_GAP = int(C.LSD_MAX_GAP)


def _mask(seed: int, h: int = 150, w: int = 230) -> np.ndarray:
    """Two dilated lines, one touching the plane's edge, plus white specks."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((h, w), np.uint8)
    cv2.line(mask, (10, 20), (w - 30, h - 30), 255, 1)
    cv2.line(mask, (30, h - 10), (w - 1, 10), 255, 1)
    mask = pixmath.dilate_l1_radius1(mask)
    mask[rng.integers(0, h, 40), rng.integers(0, w, 40)] = 255
    return mask


def _seeds(mask: np.ndarray, b: int, seed: int) -> np.ndarray:
    """b seeds on white pixels (line and specks), f32 [b, 2] (x, y)."""
    ys, xs = np.nonzero(mask == 255)
    idx = np.random.default_rng(seed).choice(ys.size, b, replace=False)
    return np.stack([xs[idx], ys[idx]], axis=1).astype(np.float32)


def _jax_lanes(mask, pts, max_gap, max_len):
    """smh_tpu's span loop (find_longest_lines_batch's), keeping the lanes."""
    h, w = mask.shape
    b, n = pts.shape[0], jlsd.N_ANGLES
    m, p = jnp.asarray(mask), jnp.asarray(pts)
    done = jnp.zeros((b, n), bool)
    prev = jnp.zeros((b, n, max_gap), bool)
    ex = jnp.broadcast_to(p[:, 0][:, None], (b, n))
    ey = jnp.broadcast_to(p[:, 1][:, None], (b, n))
    k, kspan = 0, jlsd.SPAN0
    max_k = jlsd._max_k(h, w)
    needed = max_k if max_len is None else min(max_k, int(max_len) + max_gap + 2)
    while k == 0 or k < needed:
        done, prev, ex, ey, _ = jlsd._march_span(m, p, done, prev, ex, ey, k, h=h, w=w, max_gap=max_gap, kspan=kspan)
        k += kspan
        kspan = jlsd.SPAN
    bx, by, bl = jlsd._finalize(p, ex, ey)
    return [np.asarray(a) for a in (ex, ey, bx, by, bl)]


def test_theta_table_against_jax():
    """The port's table (f32 angle, cos/sin rounded once from f64) against
    XLA's f32 cos/sin: a few entries differ, each by one ulp."""
    cos_t, sin_t = tlsd.theta_tables_np()
    jc, js = (np.asarray(a) for a in jlsd._theta_tables())
    n_diff = int((cos_t != jc).sum() + (sin_t != js).sum())
    print(f"theta table: {n_diff} of {2 * tlsd.N_ANGLES} entries differ from smh_tpu's _theta_tables()")
    assert n_diff <= 2 * tlsd.N_ANGLES // 20, n_diff
    for mine, theirs in ((cos_t, jc), (sin_t, js)):
        assert np.all(np.abs(mine - theirs) <= np.spacing(np.maximum(np.abs(mine), np.abs(theirs))))
    t_cos, t_sin = tlsd.theta_tables("cpu")
    assert t_cos.dtype == torch.float32 and np.array_equal(t_cos.numpy(), cos_t)
    assert tlsd.theta_tables("cpu")[1] is t_sin  # built once per device


def test_step_bound_is_the_jax_span_count():
    for h, w in ((150, 230), (411, 493), (822, 986), (1644, 1972)):
        max_k = jlsd._max_k(h, w)
        assert tlsd._max_k(h, w) == max_k
        for max_len in (None, 0.0, 10.5, 300.0, 255.0 - MAX_GAP - 2, 1e6):
            needed = max_k if max_len is None else min(max_k, int(max_len) + MAX_GAP + 2)
            k = jlsd.SPAN0
            while k < needed:
                k += jlsd.SPAN
            assert tlsd.step_bound(h, w, MAX_GAP, max_len) == k
    for b in (1, 2, 3, 5, 8, 9):
        assert tlsd._bucket(b) == jlsd._bucket(b)


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("max_len", [None, 120.0])
def test_plain_march_matches_jax(b, max_len):
    """With JAX's own theta table, every lane's end equals JAX's apart from
    float rounding: XLA contracts pos = start + k * d (and the squared
    length) to FMA, so most differing lanes move by ulps and a few, whose
    sample crossed a pixel edge, by a step. Both are counted and bounded;
    the winners' lengths agree to 1e-6 and their ends to 1.5 px."""
    mask = _mask(b)
    pts = _seeds(mask, b, seed=10 + b)
    want = _jax_lanes(mask, pts, MAX_GAP, max_len)
    jc, js = (torch.from_numpy(np.array(a)) for a in jlsd._theta_tables())
    k_total = tlsd.step_bound(*mask.shape, MAX_GAP, max_len)
    got = [t.numpy() for t in tlsd.ray_march(torch.from_numpy(mask), torch.from_numpy(pts), MAX_GAP, k_total, jc, js)]
    moved = np.maximum(np.abs(got[0] - want[0]), np.abs(got[1] - want[1]))
    n_lanes = moved.size
    n_ulp = int(((moved > 0) & (moved <= 1e-3)).sum())
    n_step = int((moved > 1e-3).sum())
    print(f"B={b} max_len={max_len}: {n_ulp} lanes moved by rounding, {n_step} by a step, of {n_lanes}")
    assert n_ulp <= n_lanes // 5 and n_step <= max(2, n_lanes // 1000)
    assert np.all(moved[moved <= 1e-3] <= 1e-4)
    np.testing.assert_allclose(got[4], want[4], rtol=1e-6)
    assert np.all(np.abs(got[2] - want[2]) <= 1.5) and np.all(np.abs(got[3] - want[3]) <= 1.5)


def _lane_loop(mask, x0, y0, dx, dy, max_gap, k_total):
    """The lane's sequential state machine, one step at a time, in numpy
    f32 scalars (each op rounds once; no FMA): what csrc/ray_march.cu's
    word-at-a-time march must equal."""
    h, w = mask.shape
    f = np.float32
    run = 0
    for k in range(k_total):
        px = f(x0 + f(dx * f(k)))
        py = f(y0 + f(dy * f(k)))
        if not (px >= 0 and py >= 0 and px < f(w) and py < f(h)):
            cxi, cyi = int(max(px, f(0))), int(max(py, f(0)))
            if cxi < w and cyi < h and mask[cyi, cxi] == 0:
                return f(px - dx), f(py - dy)
            return x0, y0
        run = 0 if mask[int(py), int(px)] == 255 else run + 1
        if run >= max_gap + 1:
            ke = f(k - max_gap - 1)
            return f(x0 + f(dx * ke)), f(y0 + f(dy * ke))
    return x0, y0


def _oracle_lane(mask, x0, y0, dx, dy, max_gap, k_total):
    """The oracle's lane (vision/reference.py's find_longest_line, one
    angle), stopped after k_total steps with end = start as the kernel is:
    the offset accumulated one rounded addition a step, a gap's end its
    first sample, then the final check one step back onto a black pixel."""
    h, w = mask.shape
    f = np.float32
    x, y, ox, oy = f(x0), f(y0), f(0), f(0)
    gap, gx, gy = 0, f(0), f(0)
    for _ in range(k_total):
        if not (x >= 0 and y >= 0 and x < f(w) and y < f(h)):
            break
        if mask[int(y), int(x)] == 255:
            gap = 0
        elif gap >= max_gap:
            x, y = gx, gy
            break
        elif gap == 0:
            gap, gx, gy = 1, x, y
        else:
            gap += 1
        ox, oy = f(ox + dx), f(oy + dy)
        x, y = f(ox + f(x0)), f(oy + f(y0))
    else:
        return f(x0), f(y0)
    cxi, cyi = int(max(x, f(0))), int(max(y, f(0)))
    if cxi < w and cyi < h and mask[cyi, cxi] == 0:
        return f(x - dx), f(y - dy)
    return f(x0), f(y0)


@pytest.mark.parametrize("max_gap,max_len,accumulate", [
    (MAX_GAP, None, False), (MAX_GAP, 60.0, False), (0, None, False), (3, 40.0, False),
    (MAX_GAP, None, True), (MAX_GAP, 60.0, True), (1, None, True), (3, 40.0, True)])
def test_kernel_lane_loop_equals_the_plain_version(max_gap, max_len, accumulate):
    """The lane's sequential state machine, stated in numpy, gives the
    plain span formulation's ends bit for bit on a sample of lanes (every
    7th angle), max_gap 0 and step bounds that cut live lanes included;
    with accumulate the oracle's loop does, from max_gap 1 (at 0 the oracle
    restores a gap start it never saved); the reduction's rule (largest
    length, ties to the higher angle) equals finalize_plain's."""
    mask = _mask(5)
    pts = _seeds(mask, 3, seed=7)
    cos_t, sin_t = tlsd.theta_tables("cpu")
    k_total = tlsd.step_bound(*mask.shape, max_gap, max_len)
    ex, ey, bx, by, bl = (t.numpy() for t in tlsd.ray_march(
        torch.from_numpy(mask), torch.from_numpy(pts), max_gap, k_total, cos_t, sin_t, accumulate=accumulate))
    c, s = cos_t.numpy(), sin_t.numpy()
    lane = _oracle_lane if accumulate else _lane_loop
    for i, (x0, y0) in enumerate(pts):
        for a in range(0, tlsd.N_ANGLES, 7):
            got = lane(mask, x0, y0, c[a], s[a], max_gap, k_total)
            assert (got[0], got[1]) == (ex[i, a], ey[i, a]), (i, a)
        lx = np.float32(x0) - ex[i]
        ly = np.float32(y0) - ey[i]
        lengths = lx * lx + ly * ly
        best = max(range(tlsd.N_ANGLES), key=lambda j: (lengths[j], j))
        assert (bx[i], by[i], bl[i]) == (ex[i, best], ey[i, best], lengths[best])


@pytest.mark.parametrize("accumulate", [False, True])
def test_plain_chunking_changes_nothing(monkeypatch, accumulate):
    mask = _mask(2)
    pts = torch.from_numpy(_seeds(mask, 3, seed=2))
    cos_t, sin_t = tlsd.theta_tables("cpu")
    k_total = tlsd.step_bound(*mask.shape, MAX_GAP, None)
    want = tlsd.ray_march(torch.from_numpy(mask), pts, MAX_GAP, k_total, cos_t, sin_t, accumulate=accumulate)
    monkeypatch.setattr(tlsd, "_PLAIN_BLOCK", 3 * tlsd.N_ANGLES * 5)  # 5-step chunks < max_gap
    got = tlsd.ray_march(torch.from_numpy(mask), pts, MAX_GAP, k_total, cos_t, sin_t, accumulate=accumulate)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


# -- csrc/ray_march.cu's word-at-a-time march, restated in numpy --------------------

FULL = 0xFFFFFFFF


def _cu_const(name: str) -> int:
    """An integer constexpr of csrc/ray_march.cu."""
    text = (pathlib.Path(tlsd.__file__).parent.parent / "csrc" / "ray_march.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


WORD = _cu_const("WORD")


def _ffs0(x):
    """Index of the lowest set bit of each 32-bit word (WORD for 0)."""
    low = x & (~x + np.uint64(1))
    return np.where(x == 0, WORD, np.frexp(low.astype(np.float64))[1] - 1)


def _clz(x):
    """Leading zeros of each 32-bit word (32 for 0)."""
    return np.where(x == 0, 32, 32 - np.frexp(x.astype(np.float64))[1])


def _word_event(white, inb, valid, window, carry):
    """word_event of csrc/ray_march.cu on arrays of 32-bit words (bit j =
    step k0 + j): (kind, j, carry after the word); kind 1 gap, 2 out of the
    plane, 3 alive at the bound, 0 none."""
    out = np.where(inb == FULL, WORD, _ffs0(~inb & FULL))
    lim = np.minimum(out, valid)
    live = np.where(lim >= WORD, FULL, (np.uint64(1) << lim.astype(np.uint64)) - np.uint64(1))
    z = np.where(white != 0, _ffs0(white), WORD)
    g = window - 1 - carry  # the run carried in
    g = np.where(g >= np.minimum(z, lim), WORD, g)
    if window <= WORD:  # a run that starts inside the word: shift-and doubling
        t = ~white & live & FULL
        n = 1
        while 2 * n <= window:
            t &= (t << np.uint64(n)) & FULL
            n *= 2
        if n < window:
            t &= (t << np.uint64(window - n)) & FULL
        g = np.where(t != 0, np.minimum(g, _ffs0(t)), g)
    kind = np.where(g < WORD, 1, np.where((out < WORD) & (out < valid), 2, np.where(valid <= WORD, 3, 0)))
    j = np.where(kind == 1, g, np.where(kind == 2, out, valid))
    carry = np.where(white != 0, _clz(white), carry + WORD)
    return kind, j, carry


def _accumulated(d, n):
    """[N, n] f32: d added k times in column k, each addition rounded."""
    out = np.zeros((d.size, n), np.float32)
    for k in range(1, n):
        out[:, k] = out[:, k - 1] + d
    return out


def _word_march(mask, pts, max_gap, k_total, cos_t, sin_t, accumulate=False):
    """The kernel's march over all (seed, angle) lanes: words of WORD steps,
    every sample of a word taken before any test, the word's first event in
    step order, the run of non-white samples carried to the next word as a
    count. Its thread and warp phases (LANE_CHUNKS, WARP_WORDS) take the
    same words in the same order, so they do not appear here. accumulate:
    the oracle's positions and gap ends (smh_ray_march_acc)."""
    f32 = np.float32
    h, w = mask.shape
    if accumulate:
        off_x, off_y = _accumulated(cos_t, k_total + WORD + 1), _accumulated(sin_t, k_total + WORD + 1)
        lanes = np.arange(cos_t.size)[None, :]
    window = max_gap + 1
    x0, y0 = pts[:, 0:1, None], pts[:, 1:2, None]  # [B, 1, 1]
    dx, dy = cos_t[None, :, None], sin_t[None, :, None]  # [1, N, 1]
    shape = (pts.shape[0], cos_t.size)
    ex = np.broadcast_to(pts[:, 0:1], shape).copy()
    ey = np.broadcast_to(pts[:, 1:2], shape).copy()
    carry = np.zeros(shape, np.int64)
    done = np.zeros(shape, bool)
    bit = np.uint64(1) << np.arange(WORD, dtype=np.uint64)
    k0 = 0
    while k0 < k_total and not done.all():
        k = np.arange(k0, k0 + WORD).astype(f32)
        if accumulate:
            px = x0 + off_x[None, :, k0 : k0 + WORD]  # f32: one rounding
            py = y0 + off_y[None, :, k0 : k0 + WORD]
        else:
            px = x0 + dx * k  # f32: each op rounds once
            py = y0 + dy * k
        inb = (px >= 0) & (py >= 0) & (px < f32(w)) & (py < f32(h))
        cx = np.maximum(px, f32(0)).astype(np.int64)
        cy = np.maximum(py, f32(0)).astype(np.int64)
        v = np.where((cx < w) & (cy < h), mask[np.minimum(cy, h - 1), np.minimum(cx, w - 1)], 1)
        word = lambda b: (b.astype(np.uint64) * bit).sum(axis=-1, dtype=np.uint64)  # noqa: E731
        white, in_w, black = word((v == 255) & inb), word(inb), word(v == 0)
        kind, j, new_carry = _word_event(white, in_w, k_total - k0, window, carry)
        act = ~done
        ks = (k0 + j).astype(np.int64)
        gap = act & (kind == 1)
        zero = ((black >> np.minimum(j, WORD - 1).astype(np.uint64)) & np.uint64(1)) == 1
        if accumulate:  # the gap's first sample, one step back if its byte is 0
            first = np.clip(ks - max_gap, 0, k_total)
            fx, fy = pts[:, 0:1] + off_x[lanes, first], pts[:, 1:2] + off_y[lanes, first]
            fb = mask[np.clip(fy, 0, h - 1).astype(np.int64), np.clip(fx, 0, w - 1).astype(np.int64)] == 0
            gx = np.where(fb, fx - cos_t[None, :], pts[:, 0:1])
            gy = np.where(fb, fy - sin_t[None, :], pts[:, 1:2])
            kc = np.clip(ks, 0, k_total + WORD)
            ox = (pts[:, 0:1] + off_x[lanes, kc]) - cos_t[None, :]
            oy = (pts[:, 1:2] + off_y[lanes, kc]) - sin_t[None, :]
        else:
            gx = pts[:, 0:1] + cos_t[None, :] * (ks - window).astype(f32)
            gy = pts[:, 1:2] + sin_t[None, :] * (ks - window).astype(f32)
            ox = (pts[:, 0:1] + cos_t[None, :] * ks.astype(f32)) - cos_t[None, :]
            oy = (pts[:, 1:2] + sin_t[None, :] * ks.astype(f32)) - sin_t[None, :]
        out = act & (kind == 2) & zero
        ex = np.where(gap, gx, np.where(out, ox, ex))
        ey = np.where(gap, gy, np.where(out, oy, ey))
        done |= act & (kind != 0)
        carry = np.where(done, carry, new_carry)
        k0 += WORD
    return ex, ey


def _edge_mask(seed: int, density: float, h: int = 150, w: int = 230) -> np.ndarray:
    """_mask's lines (one reaching the last column) over random white
    specks of the given density: gaps of every length."""
    rng = np.random.default_rng(seed)
    mask = _mask(seed, h, w)
    mask[rng.random((h, w)) < density] = 255
    mask[rng.random((h, w)) < 0.02] = 7  # neither black nor white
    return mask


def _edge_seeds(mask: np.ndarray, seed: int) -> np.ndarray:
    """Seeds on the plane's four edges and corners (rays leave the plane
    mid-word) and on white pixels inside."""
    h, w = mask.shape
    edge = [(0, 0), (w - 1, h - 1), (0, h // 2), (w - 1, 7), (w // 3, 0), (w // 2 + 0.5, h - 1), (w - 1, 0)]
    return np.concatenate([np.array(edge, np.float32), _seeds(mask, 3, seed)]).astype(np.float32)


def _plain(mask, pts, max_gap, k_total, accumulate=False):
    cos_t, sin_t = tlsd.theta_tables("cpu")
    ex, ey = tlsd.march_plain(torch.from_numpy(mask), torch.from_numpy(pts), max_gap, k_total, cos_t, sin_t,
                              accumulate=accumulate)
    return ex.numpy(), ey.numpy()


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("max_gap", [0, 15, 31, 47])
@pytest.mark.parametrize("density", [0.05, 0.45])
def test_word_march_equals_the_plain_version(max_gap, density, accumulate):
    """The kernel's word-at-a-time march, restated in numpy, gives
    march_plain's ends bit for bit on every lane: seeds on the plane's
    edges, runs carried across word seams, rays that leave the plane
    mid-word, and bounds that leave lanes alive (k_total 0, inside a word,
    on a seam, and the span-rounded bound); on either kind of positions."""
    mask = _edge_mask(max_gap + int(100 * density), density)
    pts = _edge_seeds(mask, max_gap)
    cos_t, sin_t = (t.numpy() for t in tlsd.theta_tables("cpu"))
    ends = {}
    for k_total in (tlsd.step_bound(*mask.shape, max_gap, None), 45, 2 * WORD, 0):
        ends[k_total] = _word_march(mask, pts, max_gap, k_total, cos_t, sin_t, accumulate)
        want = _plain(mask, pts, max_gap, k_total, accumulate)
        for g, w_ in zip(ends[k_total], want):
            np.testing.assert_array_equal(g, w_, err_msg=f"k_total {k_total}")
    for k_total, (ex, ey) in ends.items():
        at_start = (ex == pts[:, 0:1]) & (ey == pts[:, 1:2])
        assert at_start.all() if k_total == 0 else 0 < at_start.sum() < at_start.size, k_total


@pytest.mark.parametrize("max_gap", [0, 15, 31, 47])
def test_word_march_gaps_that_close_on_a_word_seam(max_gap):
    """Angle 0 marches along a row at exact integer positions. A white run
    of every length from the seed, then black: the gap completes at every
    step offset around the word seams, and the model and march_plain agree
    (the endpoint is pos(k - max_gap - 1) wherever k falls)."""
    window = max_gap + 1
    runs = list(range(0, 3 * WORD + 3))
    h, w = len(runs), 4 * WORD + window + 8
    mask = np.zeros((h, w), np.uint8)
    for y, n in enumerate(runs):
        mask[y, : n + 1] = 255
    pts = np.stack([np.zeros(h), np.arange(h)], axis=1).astype(np.float32)
    cos_t, sin_t = (t[::40].contiguous() for t in tlsd.theta_tables("cpu"))  # every 4th degree, 0 first
    k_total = tlsd.step_bound(h, w, max_gap, None)
    got = _word_march(mask, pts, max_gap, k_total, cos_t.numpy(), sin_t.numpy())
    want = [t.numpy() for t in tlsd.march_plain(
        torch.from_numpy(mask), torch.from_numpy(pts), max_gap, k_total, cos_t, sin_t)]
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)
    completes = np.array(runs) + window  # the step that completes the gap on angle 0
    assert {int(c) % WORD for c in completes} == set(range(WORD))
    np.testing.assert_array_equal(got[0][:, 0], np.array(runs, np.float32))  # end = last white pixel


def _advance(s, d, n):
    """csrc/ray_march.cu's advance, restated in numpy over arrays of lanes:
    s with d added n times, each addition rounded; three real additions a
    binade, then a jump over the additions whose increment is constant."""
    f = np.float32
    s, d, n = np.broadcast_arrays(np.asarray(s, f), np.asarray(d, f), np.asarray(n, np.int64))
    n = n.copy()
    neg, a = d < 0, np.abs(d)
    t = np.where(neg, -s, s)
    live = (n > 0) & (d != 0)
    while live.any():
        ts = []
        for _ in range(3):
            t = np.where(live, t + a, t)
            n = np.where(live, n - 1, n)
            ts.append(t)
            live = live & (n > 0)
        t1, t2, t3 = ts
        top = ((t1.view(np.int32) & 0x7F800000) + 0x00800000).astype(np.int32).view(f)
        jump = live & (t3 < top)
        with np.errstate(all="ignore"):
            u = top * f(2.0**-24)
            inc = t3 - t2
            steps = np.where(jump, inc / u, 0).astype(np.int64)
            room = np.where(jump, (top - t3) / u, 0).astype(np.int64)
        live = live & ~(jump & (steps == 0))
        m = np.where(jump & (steps > 0), np.minimum(n, room // np.maximum(steps, 1)), 0)
        t = np.where(m > 0, t3 + m.astype(f) * inc, t)
        n = n - m
        live = live & (n > 0)
    return np.where(d == 0, np.where(n > 0, s + d, s), np.where(neg, -t, t))


@pytest.mark.parametrize("table", ["port", "oracle"])
def test_advance_equals_one_rounded_addition_a_step(table):
    """The kernel's jump over a binade's additions gives every lane's
    offset bit for bit, from 0 and from any step, for both signs of every
    cos and sin of a theta table (the port's, and the oracle's numpy f32
    one), over the steps of a 4K map's march."""
    if table == "port":
        c, s_ = tlsd.theta_tables_np()
    else:
        theta = (np.arange(tlsd.N_ANGLES, dtype=np.float32) / np.float32(10.0)) * (
            np.float32(np.pi) / np.float32(180.0))
        c, s_ = np.cos(theta).astype(np.float32), np.sin(theta).astype(np.float32)
    k_max = tlsd.step_bound(1644, 1972, MAX_GAP, None)
    rng = np.random.default_rng(3)
    for d in (c, s_):
        seq = _accumulated(d, k_max + 1)  # [N, k_max + 1]
        lanes = np.arange(d.size)
        for k in list(range(0, 70)) + [int(v) for v in rng.integers(70, k_max + 1, 40)] + [k_max]:
            np.testing.assert_array_equal(_advance(0.0, d, k), seq[:, k], err_msg=f"k {k}")
        for _ in range(30):
            kb = rng.integers(0, k_max // 2, d.size)
            n = rng.integers(0, k_max - kb + 1)
            np.testing.assert_array_equal(_advance(seq[lanes, kb], d, n), seq[lanes, kb + n])


def test_accumulated_march_is_the_oracles():
    """On the oracle's own theta table, the accumulated march's winner of
    every seed (its end and squared length) is vision/reference.py's
    find_longest_line's, bit for bit: line, speck and edge seeds, whole and
    half-pixel positions, with the step bound of an unbounded march."""
    theta = (np.arange(tlsd.N_ANGLES, dtype=np.float32) / np.float32(10.0)) * (
        np.float32(np.pi) / np.float32(180.0))
    cos_t, sin_t = (torch.from_numpy(v(theta).astype(np.float32)) for v in (np.cos, np.sin))
    for seed in range(3):
        mask = _mask(seed, 180, 260)
        h, w = mask.shape
        pts = np.concatenate([_seeds(mask, 6, seed) + np.float32(0.5 * seed),
                              np.array([[0, 0], [w - 1, h - 1], [0, h / 2]], np.float32)]).astype(np.float32)
        _, _, bx, by, bl = tlsd.ray_march(torch.from_numpy(mask), torch.from_numpy(pts), MAX_GAP,
                                          tlsd.step_bound(h, w, MAX_GAP, None), cos_t, sin_t, accumulate=True)
        for i, (x, y) in enumerate(pts):
            line, length = oracle.find_longest_line(mask, Point(float(x), float(y)), float(MAX_GAP))
            assert (float(bx[i]), float(by[i]), float(bl[i])) == (line.p1.x, line.p1.y, length), (seed, i)


def test_u64_key_max_is_finalize_plains_winner():
    """The kernel's reduction: each lane's key (f32 bits of its squared
    length << 32 | angle), the max over blocks of the max over lanes, gives
    finalize_plain's winner (the last angle with the largest length), ties
    included; non-negative f32 bits order as the values do."""
    rng = np.random.default_rng(3)
    n = tlsd.N_ANGLES
    per = -(-n // _cu_const("CLUSTER"))
    pts = rng.integers(0, 50, (6, 2)).astype(np.float32)
    ex = (pts[:, 0:1] + rng.integers(-3, 4, (6, n))).astype(np.float32)  # many equal lengths
    ey = (pts[:, 1:2] + rng.integers(-3, 4, (6, n))).astype(np.float32)
    ex[1], ey[1] = pts[1, 0], pts[1, 1]  # every length 0
    ex[2, 17], ey[2, 17] = ex[2, 17] + 1000, ey[2, 17]  # one clear winner
    ex[3] += rng.random(n).astype(np.float32)  # distinct lengths
    lx, ly = pts[:, 0:1] - ex, pts[:, 1:2] - ey
    lengths = lx * lx + ly * ly  # f32, one rounding each, as the kernel
    keys = (lengths.view(np.uint32).astype(np.uint64) << np.uint64(32)) | np.arange(n, dtype=np.uint64)
    blocks = [keys[:, i : i + per].max(axis=1) for i in range(0, n, per)]
    best = np.max(blocks, axis=0)
    angle = (best & np.uint64(FULL)).astype(np.int64)
    want = [t.numpy() for t in tlsd.finalize_plain(*(torch.from_numpy(a) for a in (pts, ex, ey)))]
    rows = np.arange(6)
    np.testing.assert_array_equal(ex[rows, angle], want[0])
    np.testing.assert_array_equal(ey[rows, angle], want[1])
    np.testing.assert_array_equal((best >> np.uint64(32)).astype(np.uint32).view(np.float32), want[2])
    assert angle[1] == n - 1 and angle[2] == 17
    vals = np.sort(rng.random(1000).astype(np.float32) * 1e6)
    assert (np.diff(vals.view(np.uint32).astype(np.int64)) >= 0).all()


def test_find_longest_lines_batch_against_jax():
    mask = _mask(4)
    pts = [Point(float(x), float(y)) for x, y in _seeds(mask, 5, seed=4)]
    for max_len in (None, math.hypot(*mask.shape) + 1.0):
        got = tlsd.find_longest_lines_batch(torch.from_numpy(mask), pts, float(MAX_GAP), max_len=max_len)
        want = jlsd.find_longest_lines_batch(jnp.asarray(mask), pts, float(MAX_GAP), max_len=max_len)
        assert len(got) == len(want) == len(pts)
        for (lg, ng), (lw, nw), p in zip(got, want, pts):
            assert (lg.p0.x, lg.p0.y) == (p.x, p.y)
            assert abs(lg.p1.x - lw.p1.x) <= 1.5 and abs(lg.p1.y - lw.p1.y) <= 1.5
            assert abs(ng - nw) <= max(4.0, 0.01 * nw)
    line, n = tlsd.find_longest_line(torch.from_numpy(mask), pts[0], float(MAX_GAP))
    assert (line, n) == tlsd.find_longest_lines_batch(torch.from_numpy(mask), pts[:1], float(MAX_GAP))[0]
    assert tlsd.find_longest_lines_batch(torch.from_numpy(mask), [], 15.0) == []


def test_ray_march_rejects_bad_inputs():
    cos_t, sin_t = tlsd.theta_tables("cpu")
    mask = torch.zeros((4, 6), dtype=torch.uint8)
    pts = torch.zeros((1, 2))
    with pytest.raises(ValueError):
        tlsd.ray_march(mask.float(), pts, 2, 10, cos_t, sin_t)
    with pytest.raises(ValueError):
        tlsd.ray_march(mask, pts.double(), 2, 10, cos_t, sin_t)
    with pytest.raises(ValueError):
        tlsd.ray_march(mask, pts, -1, 10, cos_t, sin_t)
    with pytest.raises(ValueError):
        tlsd.ray_march(mask.to("meta"), pts.to("meta"), 2, 10, cos_t.to("meta"), sin_t.to("meta"))


# -- the engines on frames ------------------------------------------------------


def _lines(backend, frame):
    backend.load_frame(frame)
    assert backend.crop_to_map(True) is not None
    backend.mask_marker_lines()
    return [(l.p0.x, l.p0.y, l.p1.x, l.p1.y) for l in backend.find_marker_lines(C.LSD_MAX_GAP)]


@pytest.mark.parametrize("sparse", ["1", "0"])
def test_cuda_engine_matches_native_and_tpu(sparse, monkeypatch):
    """lsd_engine="cuda" (the device march over the rebuilt u8 mask) finds
    the lines "native" and TpuBackend's "tpu" engine find, within 1.5 px
    (tests/test_tpu_parity.py:139-140), on the sparse route and, with
    SMH_SPARSE=0, through a window crop pasted into a full canvas."""
    monkeypatch.setenv("SMH_SPARSE", sparse)
    frame = testing.make_frame(960, 540, marker_lines=[((60, 75), (190, 160)), ((100, 40), (110, 150))])
    engines = [cb.CudaBackend("cpu", lsd_engine="cuda"), cb.CudaBackend("cpu", lsd_engine="native"),
               tb.TpuBackend(lsd_engine="tpu")]
    results = [_lines(be, frame) for be in engines]
    port = engines[0]
    assert "lsd_mask" in port._results and port._march_max_len is not None
    if sparse == "0":
        assert port._host["lsd_crop_shape"] != (port.geom.map_h, port.geom.map_w)
    assert all(len(r) == 2 for r in results)
    for other in results[1:]:
        for a, b in zip(sorted(results[0]), sorted(other), strict=True):
            assert all(abs(x - y) <= 1.5 for x, y in zip(a, b)), (a, b)


def test_lsd_engine_choices():
    assert cb.CudaBackend("cpu").lsd_engine == "native"
    assert cb.CudaBackend("cpu", lsd_engine="auto").lsd_engine == "native"
    with pytest.raises(ValueError):
        cb.CudaBackend("cpu", lsd_engine="tpu")
