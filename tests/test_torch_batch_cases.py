"""The cases of tests/test_batch.py on the port's BatchPipeline (device="cpu",
the plain versions of the kernels): the batch against the per-frame backend,
the cross-batch delta chain against full uploads (whole and partial
batches), pipelined submits against sequential ones, the scales read with
the images inline, stream() against process(), errors and early
abandonment of stream(), and the numpy fallbacks where the native module is
missing."""

import threading
import time

import numpy as np
import pytest
import torch

from smh_tpu_torch import testing
from smh_tpu_torch.ocr import FakeOcrEngine, OcrResult
from smh_tpu_torch.vision.batch import BatchPipeline
from smh_tpu_torch.vision.cuda_backend import CudaBackend

torch.set_num_threads(1)

W, H = 960, 540
BSZ = 3
BAR = (30, 96, 60, 1)
RATIO = 300.0 / 58.0  # a 60 px bar with end bars measures 58


def drag(n: int, bar: bool = False) -> list:
    return [
        testing.make_frame(W, H, marker_lines=[((60 + 6 * i, 75 + 2 * i), (300 + 6 * i, 200))],
                           scale_bars=[BAR] if bar else None)
        for i in range(n)
    ]


def lines(results) -> list:
    return [[l.as_tuple() for l in r.markers] for r in results]


def run(frames, mode: str, **kw):
    bp = BatchPipeline(W, H, batch=BSZ, device="cpu", **kw)
    bp.delta_mode = mode
    try:
        results = []
        for s in range(0, len(frames), BSZ):
            results.extend(bp.process(frames[s : s + BSZ]))
        return results, dict(bp.stats)
    finally:
        bp.close()


def test_batch_matches_single():
    frames = [
        testing.make_frame(W, H, marker_lines=[((100, 100), (420, 300))]),
        testing.make_frame(W, H, marker_lines=[((50, 350), (400, 330))]),
        testing.make_frame(W, H, with_button=False),  # sleeping
    ]
    bp = BatchPipeline(W, H, batch=4, device="cpu")
    try:
        results = bp.process(frames)
    finally:
        bp.close()
    assert [r.sleeping for r in results] == [False, False, True]
    assert all(len(r.markers) == 1 for r in results[:2])
    be = CudaBackend("cpu")
    for frame, r in zip(frames[:2], results):
        be.load_frame(frame)
        assert be.crop_to_map(True) is not None
        be.mask_marker_lines()
        assert [l.as_tuple() for l in be.find_marker_lines(15)] == [l.as_tuple() for l in r.markers]
        assert r.minimap_bounds == be.minimap_rect()


def test_batch_delta_chain_matches_full():
    """A video-style sequence through the cross-batch delta chain equals the
    same sequence through full uploads, frame for frame (the chunk updates
    rebuild each frame's exact bytes); the last batch is partial."""
    seq = drag(7, bar=True)
    full, fstats = run(seq, "off")
    delta, dstats = run(seq, "on")
    assert fstats["delta_batches"] == 0 and fstats["full_batches"] == 3
    assert dstats["delta_batches"] == 2  # batch 0 seeds, batches 1-2 ride deltas
    assert dstats["h2d_bytes"] < fstats["h2d_bytes"] / 2
    assert lines(full) == lines(delta) and all(lines(full))
    assert [r.minimap_bounds for r in full] == [r.minimap_bounds for r in delta]


def test_batch_delta_partial_batch_keeps_chain_consistent():
    """A short batch pads with zero-change repeats of its last frame; the
    next batch must still diff against the right chain tail."""
    seq = drag(5)
    bp = BatchPipeline(W, H, batch=4, device="cpu")
    bp.delta_mode = "on"
    try:
        got = bp.process(seq[:3]) + bp.process(seq[3:])  # partial seed, then a delta batch vs seq[2]
        assert bp.stats["delta_batches"] == 1
    finally:
        bp.close()
    bp_full = BatchPipeline(W, H, batch=4, device="cpu")
    bp_full.delta_mode = "off"
    try:
        want = bp_full.process(seq[:3]) + bp_full.process(seq[3:])
    finally:
        bp_full.close()
    assert lines(got) == lines(want)


def test_pipelined_batches_match_sequential():
    """submit(N+1) while N is in flight gives sequential process()'s
    results, with an intact cross-batch delta chain."""
    seq = drag(9)
    want, _ = run(seq, "on")
    bp = BatchPipeline(W, H, batch=BSZ, device="cpu")
    bp.delta_mode = "on"
    try:
        jobs, piped = [], []
        for s in range(0, 9, BSZ):
            jobs.append(bp.submit(seq[s : s + BSZ]))
            if len(jobs) > 1:
                piped.extend(bp.collect(jobs.pop(0)))
        while jobs:
            piped.extend(bp.collect(jobs.pop(0)))
        assert bp.stats["delta_batches"] == 2
    finally:
        bp.close()
    assert lines(piped) == lines(want)
    assert [r.minimap_bounds for r in piped] == [r.minimap_bounds for r in want]


@pytest.mark.parametrize("binary_ok", [True, False])
def test_batch_with_scales(binary_ok):
    """An engine the device read does not replace gets the images inline:
    bit-packed for binary_ok engines, gray otherwise."""
    ocr = FakeOcrEngine([OcrResult("300m", 91.0, 34, 76, 88, 91)])
    ocr.binary_ok = binary_ok
    frames = [testing.make_frame(W, H, marker_lines=[((100, 100), (420, 300))], scale_bars=[BAR])]
    bp = BatchPipeline(W, H, batch=2, ocr_engine=ocr, device="cpu")
    try:
        job = bp.submit(frames)
        assert job["inline"] == ("binary" if binary_ok else "gray")
        results = bp.collect(job)
    finally:
        bp.close()
    assert results[0].meters_to_px_ratio == pytest.approx(RATIO)


def test_stream_matches_sequential_process():
    seq = drag(9, bar=True)
    batches = [seq[s : s + BSZ] for s in range(0, len(seq), BSZ)]
    bp_seq = BatchPipeline(W, H, batch=BSZ, device="cpu")
    try:
        expect = [bp_seq.process(b) for b in batches]
        seq_stats = dict(bp_seq.stats)
    finally:
        bp_seq.close()
    bp_str = BatchPipeline(W, H, batch=BSZ, device="cpu")
    try:
        got = list(bp_str.stream(iter(batches)))
        str_stats = dict(bp_str.stats)
    finally:
        bp_str.close()
    assert len(got) == len(expect)
    assert str_stats["delta_batches"] == seq_stats["delta_batches"]
    assert [lines(b) for b in got] == [lines(b) for b in expect]


def test_stream_propagates_source_errors():
    class Boom(Exception):
        pass

    def batches():
        yield [testing.make_frame(W, H, marker_lines=[((100, 100), (420, 300))])]
        raise Boom()

    bp = BatchPipeline(W, H, batch=BSZ, device="cpu")
    try:
        it = bp.stream(batches())
        first = next(it)
        assert len(first) == 1 and first[0].markers
        with pytest.raises(Boom):
            list(it)
    finally:
        bp.close()


def test_stream_abandoned_early_collects_in_flight():
    """Breaking out of stream() must not leak the submitter thread or leave
    dispatched batches uncollected; the pipeline stays usable."""
    seq = drag(12)
    batches = [seq[s : s + BSZ] for s in range(0, len(seq), BSZ)]
    bp = BatchPipeline(W, H, batch=BSZ, device="cpu")
    try:
        for rs in bp.stream(iter(batches), depth=2):
            assert rs[0].markers
            break  # abandon after the first yield
        deadline = time.time() + 5
        while any(t.name == "batch-submit" for t in threading.enumerate()) and time.time() < deadline:
            time.sleep(0.05)
        assert not any(t.name == "batch-submit" for t in threading.enumerate())
        assert bp._fetched_seq == bp._seq, "in-flight job left uncollected"
        assert all(r.markers for r in bp.process(seq[-BSZ:]))
    finally:
        bp.close()


def test_numpy_fallbacks_match_the_native_module():
    """Without the native module the batch packs and diffs with numpy and
    marches with the oracle's LSD: the same chain, lines within the
    oracle's tolerance (tests/test_tpu_parity.py:139-140)."""
    seq = drag(6)
    want, wstats = run(seq, "on")
    bp = BatchPipeline(W, H, batch=BSZ, device="cpu")
    bp._native = None
    bp.delta_mode = "on"
    try:
        got = bp.process(seq[:BSZ]) + bp.process(seq[BSZ:])
        stats = dict(bp.stats)
    finally:
        bp.close()
    assert (stats["delta_batches"], stats["h2d_bytes"]) == (wstats["delta_batches"], wstats["h2d_bytes"])
    for a, b in zip(lines(got), lines(want)):
        assert len(a) == len(b) == 1
        assert np.allclose(a[0], b[0], atol=1.5)


def test_frames_the_roll_cannot_read_take_the_two_pass_delta():
    """BGR frames (no alpha) are not what the native pack and roll read:
    they are packed row by row and diffed by _delta_updates with the native
    index sets, and give the rolled chain's results and upload bytes."""
    seq = drag(6)
    want, wstats = run(seq, "on")
    bgr = [np.ascontiguousarray(f[..., :3]) for f in seq]
    bp = BatchPipeline(W, H, batch=BSZ, device="cpu")
    bp.delta_mode = "on"
    assert bp._native is not None and bp._fused_ok(seq) and not bp._fused_ok(bgr)
    try:
        got = bp.process(bgr[:BSZ]) + bp.process(bgr[BSZ:])
        stats = dict(bp.stats)
    finally:
        bp.close()
    assert (stats["delta_batches"], stats["h2d_bytes"]) == (wstats["delta_batches"], wstats["h2d_bytes"])
    assert lines(got) == lines(want) and all(lines(got))
    assert [r.minimap_bounds for r in got] == [r.minimap_bounds for r in want]
