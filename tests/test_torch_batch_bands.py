"""The batch delta path's roll in row bands (native/smhroll.cpp) against the
frame-by-frame roll it replaced, on the CPU.

`native.roll_band` rolls one band of map rows of the flat upload layout
through a batch and `native.roll_merge` joins the bands: every frame's
changed sub-chunk indices and payloads, and the rolled buffer, equal
`pack_diff_roll` + `gather_subchunks` run frame by frame, for any cut of
the rows (band edges on and off multiples of 8 rows, so on and off the
32 B grid in every plane) and any order the bands run in. Then
`BatchPipeline._roll_delta`'s upload buffer and mirror equal the serial
roll's byte for byte over a chain of video batches at 4K and 1080p, a short
last batch, and a noisy batch that overflows the ladder and reseeds."""

import threading
import time

import numpy as np
import pytest
import torch

from smh_tpu_torch import native
from smh_tpu_torch import testing
from smh_tpu_torch.ops import pipeline as tpp
from smh_tpu_torch.vision import batch as tbatch
from smh_tpu_torch.vision import cuda_backend as cb
from test_torch_reference import port_native  # noqa: F401  (module-scoped fixture)

pytestmark = pytest.mark.usefixtures("port_native")

SUB = cb._DELTA_SUB


def _serial(maps, btns, roll):
    """The frame-by-frame roll: -> [(indices, payloads, sub-chunk 0)] a frame."""
    n_sub = roll.size // SUB
    dirty, scratch = np.empty(n_sub, np.uint8), np.empty(n_sub, np.int32)
    out = []
    for m, b in zip(maps, btns):
        cnt = native.pack_diff_roll(m, b, roll, dirty, scratch)
        tmp = np.empty(cnt * (4 + SUB), np.uint8)
        if cnt:
            native.gather_subchunks(roll, scratch, cnt, cnt, tmp)
        out.append((tmp[: cnt * 4].view(np.int32).copy(), tmp[cnt * 4 :].reshape(cnt, SUB).copy(), roll[:SUB].copy()))
    return out


def _bands(rows, total, n):
    """Each band's (dirty, idx, data, cnt) for n frames."""
    out = []
    for y0, y1, mh, mw in rows:
        cap = native.roll_band_cap(mh, mw, y0, y1, total)
        out.append((np.empty(total // SUB, np.uint8), np.empty((n, cap), np.int32),
                    np.empty((n, cap, SUB), np.uint8), np.empty((n, 3), np.int32)))
    return out


def _banded(maps, btns, roll, cuts, order="rows"):
    """Roll the bands cut at `cuts` (in row order, reversed, or on threads
    at once) and merge: -> (counts, rows of the batch buffer)."""
    mh, mw = maps[0].shape[:2]
    n = len(maps)
    rows = [(y0, y1, mh, mw) for y0, y1 in zip(cuts[:-1], cuts[1:])]
    bufs = _bands(rows, roll.size, n)
    frames = native.roll_frames(maps, btns)

    def run(j):
        native.roll_band(frames, roll, rows[j][0], rows[j][1], *bufs[j])

    if order == "threads":
        ts = [threading.Thread(target=run, args=(j,)) for j in range(len(rows))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    else:
        for j in (range(len(rows)) if order == "rows" else reversed(range(len(rows)))):
            run(j)
    _, idxs, datas, cnts = zip(*bufs)
    counts = native.roll_merge(idxs, datas, cnts, n)
    bucket = int(counts.max()) + 3  # room to pad every row
    buf = np.full((n + 1) * bucket * (4 + SUB), 0xEE, np.uint8)  # one row more: the caller's
    native.roll_merge(idxs, datas, cnts, n, bucket, buf)
    assert (buf[n * bucket * 4 : (n + 1) * bucket * 4] == 0xEE).all()
    assert (buf[(n + 1) * bucket * 4 + n * bucket * SUB :] == 0xEE).all()
    idx = buf[: (n + 1) * bucket * 4].view(np.int32).reshape(n + 1, bucket)[:n]
    data = buf[(n + 1) * bucket * 4 :].reshape(n + 1, bucket, SUB)[:n]
    return counts, (idx, data)


def _scene(mh, mw, seed, cuts):
    """Frames of BGRA whose map and button ROIs are strided views: a random
    first frame, sparse changes, changes on both sides of every band edge,
    on one side only (each side in turn), no change, the button alone, the
    map's first and last pixels (the planes' seams)."""
    rng = np.random.default_rng(seed)
    h, w = mh + 40, mw + 60
    f = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    frames = [f.copy()]

    def step(edit):
        g = frames[-1].copy()
        edit(g[10 : 10 + mh, 20 : 20 + mw], g[h - 25 : h - 5, w - 35 : w - 5])
        frames.append(g)

    def sparse(m, b):
        m[rng.integers(0, mh, 30), rng.integers(0, mw, 30), :3] ^= 0x5A

    def both(m, b):
        for y in cuts[1:-1]:
            m[y - 1, mw - 1, :3] += 1
            m[y, 0, :3] += 1

    def above(m, b):
        for y in cuts[1:-1]:
            m[y - 1, mw - 1, :3] += 1

    def below(m, b):
        for y in cuts[1:-1]:
            m[y, 0, :3] += 1

    def button(m, b):
        b[3, 4, :3] += 1

    def seams(m, b):
        m[0, 0, :3] += 1
        m[mh - 1, mw - 1, :3] += 1

    for edit in (sparse, both, above, below, lambda m, b: None, button, seams, sparse):
        step(edit)
    return ([g[10 : 10 + mh, 20 : 20 + mw] for g in frames], [g[h - 25 : h - 5, w - 35 : w - 5] for g in frames])


def _total(mh, mw):
    return ((mh * mw + 20 * 30) * 3 + 127) // 128 * 128


@pytest.mark.parametrize("mh", [64, 53])
@pytest.mark.parametrize("mw", [585, 986, 1972])
@pytest.mark.parametrize("n_bands", range(1, 9))
def test_bands_equal_the_serial_roll(mw, mh, n_bands):
    """Each frame's changed indices, payloads and keep-alive, and the rolled
    buffer, equal the frame-by-frame roll's, the bands run in row order."""
    cuts = [j * mh // n_bands for j in range(n_bands + 1)]
    maps, btns = _scene(mh, mw, seed=mw + mh + n_bands, cuts=cuts)
    total = _total(mh, mw)
    start = np.zeros(total, np.uint8)  # the chain's mirror: the first frame packed
    native.pack_diff(maps[0], btns[0], start, None, None, None)
    ref_roll, roll = start.copy(), start.copy()
    want = _serial(maps[1:], btns[1:], ref_roll)
    counts, (idx, data) = _banded(maps[1:], btns[1:], roll, cuts)
    assert roll.tobytes() == ref_roll.tobytes()
    assert counts.tolist() == [w[0].size for w in want]
    for f, (wi, wd, chunk0) in enumerate(want):
        if wi.size == 0:  # keep-alive: sub-chunk 0 of the frame
            wi, wd = np.zeros(1, np.int32), chunk0[None]
        np.testing.assert_array_equal(idx[f, : wi.size], wi)
        np.testing.assert_array_equal(data[f, : wi.size], wd)
        assert (idx[f, wi.size :] == wi[-1]).all() and (data[f, wi.size :] == wd[-1]).all()
    assert counts[4] == 0 and counts[5] > 0  # no change; the button alone
    assert n_bands == 1 or (counts[2] > 0 and counts[3] > 0)  # one side of each edge


@pytest.mark.parametrize("order", ["reversed", "threads"])
@pytest.mark.parametrize("cuts", [[0, 7, 8, 29, 61], [0, 16, 32, 48, 61], [0, 1, 60, 61]])
def test_bands_equal_the_serial_roll_in_any_order(order, cuts):
    """Uneven cuts (one-row bands, edges on and off multiples of 8), the
    bands run last first or all at once: the same bytes."""
    mh, mw = 61, 985
    maps, btns = _scene(mh, mw, seed=sum(cuts), cuts=cuts)
    total = _total(mh, mw)
    start = np.zeros(total, np.uint8)
    native.pack_diff(maps[0], btns[0], start, None, None, None)
    ref_roll, roll = start.copy(), start.copy()
    want = _serial(maps[1:], btns[1:], ref_roll)
    counts, (idx, data) = _banded(maps[1:], btns[1:], roll, cuts, order)
    assert roll.tobytes() == ref_roll.tobytes()
    assert counts.tolist() == [w[0].size for w in want]
    for f, (wi, wd, _) in enumerate(want):
        np.testing.assert_array_equal(idx[f, : wi.size], wi)
        np.testing.assert_array_equal(data[f, : wi.size], wd)


@pytest.fixture(scope="module")
def video():
    return {(w, h): testing.make_video_frames(w, h, 15) for w, h in [(3840, 2160), (1920, 1080)]}


class _Serial:
    """The frame-by-frame roll that BatchPipeline._roll_delta ran before the
    bands, on a mirror of its own."""

    def __init__(self, bp, mirror):
        self.bp, self.mirror = bp, mirror.copy()

    def roll(self, frames):
        bp, g, w = self.bp, self.bp.geom, self.mirror
        n_sub = w.size // SUB
        scratch, dirty = np.empty(n_sub, np.int32), np.empty(n_sub, np.uint8)
        tmps = []
        for f in frames:
            m = f[g.map_y : g.map_y + g.map_h, g.map_x : g.map_x + g.map_w]
            b = f[g.btn_y : g.btn_y + g.btn_h, g.btn_x : g.btn_x + g.btn_w]
            cnt = native.pack_diff_roll(m, b, w, dirty, scratch)
            if cnt == 0:
                scratch[0] = 0
                cnt = 1
            if cb._delta_bucket(cnt, n_sub) is None:
                return None
            tmp = np.empty(cnt * 4 + cnt * SUB, dtype=np.uint8)
            native.gather_subchunks(w, scratch, cnt, cnt, tmp)
            tmps.append((cnt, tmp))
        bucket = cb._delta_bucket(max(c for c, _ in tmps), n_sub)
        bsz = bp.batch
        buf = np.empty(bsz * bucket * 4 + bsz * bucket * SUB, np.uint8)
        idxs = buf[: bsz * bucket * 4].view(np.int32).reshape(bsz, bucket)
        datas = buf[bsz * bucket * 4 :].reshape(bsz, bucket, SUB)
        for i in range(bsz):
            if i < len(tmps):
                cnt, tmp = tmps[i]
                ti, td = tmp[: cnt * 4].view(np.int32), tmp[cnt * 4 :].reshape(cnt, SUB)
                idxs[i, :cnt], idxs[i, cnt:] = ti, ti[-1]
                datas[i, :cnt], datas[i, cnt:] = td, td[-1]
            else:
                idxs[i, :] = 0
                datas[i, :] = w[:SUB]
        return buf, bucket


@pytest.mark.parametrize("res", [(3840, 2160), (1920, 1080)])
def test_roll_delta_equals_the_serial_roll_over_a_chain(video, res):
    """Three batches of a video chain, the last one short (a padding row):
    the upload buffer, its bucket and the mirror equal the serial roll's
    after every batch; every batch ran every band."""
    frames = video[res]
    bp = tbatch.BatchPipeline(*res, batch=4, device="cpu")
    try:
        assert len(bp._roll_rows) == 4 and bp._roll_rows[-1][1] == bp.geom.map_h
        bp._mirror = bp._pack_rois_native(frames[:4])[3].copy()
        ref = _Serial(bp, bp._mirror)
        for batch in (frames[4:8], frames[8:12], frames[12:15]):
            got, want = bp._roll_delta(batch), ref.roll(batch)
            assert got is not None and want is not None
            assert got[1] == want[1] and got[0].tobytes() == want[0].tobytes()
            assert bp._mirror.tobytes() == ref.mirror.tobytes()
        assert bp.stats["roll_bands"] == 3 * 4
    finally:
        bp.close()


def test_a_noisy_batch_overflows_and_the_next_reseeds(video, monkeypatch):
    """At 1080p: a noisy batch overflows the ladder, the submit reseeds with
    a full upload, and the next batches roll against the reseeded mirror as
    the serial roll does; one band overflows as four do."""
    frames = video[(1920, 1080)]
    calls, uploads = [], []

    def fake(kind):
        def run(*args, **kw):  # the host half's contract with the pass: a resident row, the hostpacks
            calls.append(kind)
            uploads.append((args[1].numpy().tobytes(), kw["bucket"]) if kind == "delta" else None)
            return {"resident": torch.zeros(1), "hostpack": torch.zeros((4, 8), dtype=torch.uint8)}
        return run

    monkeypatch.setattr(tpp, "analyze_batch_packed_flat", fake("full"))
    monkeypatch.setattr(tpp, "analyze_batch_delta_flat", fake("delta"))
    rng = np.random.default_rng(3)
    noisy = [f.copy() for f in frames[4:8]]
    for f in noisy[:3]:  # the last frame clean: the reseeded chain goes on with the video
        f[..., :3] = rng.integers(0, 256, f[..., :3].shape, dtype=np.uint8)
    bp = tbatch.BatchPipeline(1920, 1080, batch=4, device="cpu")
    try:
        bp.submit(frames[:4])
        assert _Serial(bp, bp._mirror).roll(noisy) is None
        bp.submit(noisy)
        assert calls == ["full", "full"] and bp.stats["roll_bands"] == 4
        assert bp.stats["full_batches"] == 2 and bp.stats["delta_batches"] == 0
        ref = _Serial(bp, bp._mirror)
        for batch in (frames[8:12], frames[12:15]):
            buf, bucket = ref.roll(batch)
            bp.submit(batch)
            assert uploads[-1] == (buf.tobytes(), bucket)
            assert bp._mirror.tobytes() == ref.mirror.tobytes()
        assert calls == ["full", "full", "delta", "delta"] and bp.stats["delta_batches"] == 2
        assert bp.stats["roll_bands"] == 3 * 4
    finally:
        bp.close()
    one = tbatch.BatchPipeline(1920, 1080, batch=4, host_workers=1, device="cpu")
    try:
        assert one._roll_rows == [(0, one.geom.map_h)]
        one._mirror = one._pack_rois_native(frames[:4])[3].copy()
        assert one._roll_delta(noisy) is None
        assert one.stats["roll_bands"] == 1
    finally:
        one.close()


def test_each_band_is_a_span_of_the_batch(video, monkeypatch):
    """One `batch.roll_band` work span a band, with its thread CPU, on a roll
    pool thread, under the batch's id and inside its `batch.pack`."""
    from smh_tpu_torch.utils import timeshares as T

    def fake(*args, **kw):
        return {"resident": torch.zeros(1), "hostpack": torch.zeros((4, 8), dtype=torch.uint8)}

    monkeypatch.setattr(tpp, "analyze_batch_packed_flat", fake)
    monkeypatch.setattr(tpp, "analyze_batch_delta_flat", fake)
    frames = video[(1920, 1080)]
    bp = tbatch.BatchPipeline(1920, 1080, batch=4, device="cpu")
    try:
        bp.submit(frames[:4])
        t0 = time.perf_counter()
        jobs = [bp.submit(frames[4:8]), bp.submit(frames[8:12])]
        recs = [r for r in T.RING.records(t0) if r.start >= t0]
    finally:
        bp.close()
    me = threading.get_ident()
    for job in jobs:
        pack = next(r for r in recs if r.name == "batch.pack" and r.frame == job["frame"])
        bands = [r for r in recs if r.name == "batch.roll_band" and r.frame == job["frame"]]
        assert len(bands) == len(bp._roll_rows) == 4
        assert all(r.kind == T.WORK and r.cpu is not None and r.thread != me and r.parent is None for r in bands)
        assert all(T.RING.threads[r.thread].startswith("batch-roll") for r in bands)
        assert all(pack.start <= r.start and r.end <= pack.end for r in bands)
    assert bp.stats["roll_bands"] == 2 * 4 and bp.stats["delta_batches"] == 2
