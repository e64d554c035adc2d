"""The device ray march (smh_tpu_torch/ops/lsd.py) against smh_tpu/ops/lsd.py
on seeded masks, the CUDA kernel's sequential lane loop (re-stated here in
numpy f32 scalars) against the plain span formulation, and the three LSD
engines (CudaBackend "cuda" and "native", TpuBackend "tpu") on frames."""

import math

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
    """csrc/ray_march.cu's ray_march_lanes for one lane, in numpy f32
    scalars (each op rounds once; no FMA)."""
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


@pytest.mark.parametrize("max_gap,max_len", [(MAX_GAP, None), (MAX_GAP, 60.0), (0, None), (3, 40.0)])
def test_kernel_lane_loop_equals_the_plain_version(max_gap, max_len):
    """The kernel's sequential state machine, stated in numpy, gives the
    plain span formulation's ends bit for bit on a sample of lanes (every
    7th angle), max_gap 0 and step bounds that cut live lanes included;
    the block reduction's rule (largest length, ties to the higher angle)
    equals finalize_plain's."""
    mask = _mask(5)
    pts = _seeds(mask, 3, seed=7)
    cos_t, sin_t = tlsd.theta_tables("cpu")
    k_total = tlsd.step_bound(*mask.shape, max_gap, max_len)
    ex, ey, bx, by, bl = (t.numpy() for t in tlsd.ray_march(
        torch.from_numpy(mask), torch.from_numpy(pts), max_gap, k_total, cos_t, sin_t))
    c, s = cos_t.numpy(), sin_t.numpy()
    for i, (x0, y0) in enumerate(pts):
        for a in range(0, tlsd.N_ANGLES, 7):
            got = _lane_loop(mask, x0, y0, c[a], s[a], max_gap, k_total)
            assert (got[0], got[1]) == (ex[i, a], ey[i, a]), (i, a)
        lx = np.float32(x0) - ex[i]
        ly = np.float32(y0) - ey[i]
        lengths = lx * lx + ly * ly
        best = max(range(tlsd.N_ANGLES), key=lambda j: (lengths[j], j))
        assert (bx[i], by[i], bl[i]) == (ex[i, best], ey[i, best], lengths[best])


def test_plain_chunking_changes_nothing(monkeypatch):
    mask = _mask(2)
    pts = torch.from_numpy(_seeds(mask, 3, seed=2))
    cos_t, sin_t = tlsd.theta_tables("cpu")
    k_total = tlsd.step_bound(*mask.shape, MAX_GAP, None)
    want = tlsd.ray_march(torch.from_numpy(mask), pts, MAX_GAP, k_total, cos_t, sin_t)
    monkeypatch.setattr(tlsd, "_PLAIN_BLOCK", 3 * tlsd.N_ANGLES * 5)  # 5-step chunks < max_gap
    got = tlsd.ray_march(torch.from_numpy(mask), pts, MAX_GAP, k_total, cos_t, sin_t)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


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
