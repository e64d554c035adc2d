"""The port's batch throughput path against the JAX package's on the CPU:
the batched fused pass (`analyze_batch_packed_flat`, `analyze_batch_delta_flat`
against `_analyze_batch_packed`, `_analyze_batch_delta`: the stacked
hostpacks, bit planes, scalespacks and the chain's resident tail), then
`BatchPipeline(device="cpu")` against smh_tpu's BatchPipeline and against the
port's per-frame VisionState on the same frames, and the delta chain dropped
after a failed batch dispatch. The JAX outputs are built once per module."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smh_tpu.ocr import smhocr as jsmhocr
from smh_tpu.ops import pipeline as jpp
from smh_tpu.vision.batch import BatchPipeline as JBatchPipeline
from smh_tpu_torch import consts as C
from smh_tpu_torch import testing
from smh_tpu_torch.ocr import smhocr as tsmhocr
from smh_tpu_torch.ops import pipeline as tpp
from smh_tpu_torch.ops import scales_device as sd
from smh_tpu_torch.settings import Settings
from smh_tpu_torch.squadex.capture import Frame
from smh_tpu_torch.vision import batch as tbatch
from smh_tpu_torch.vision.pipeline import VisionState
from test_torch_reference import _reference_native  # noqa: F401  (module-scoped autouse fixture)

torch.set_num_threads(1)

W, H = 960, 540
G = C.map_geometry(W, H)
BSZ = 3
TEXT = ("300m", (30, 70))  # BRQ coordinates; the bar sits below it
BAR = (30, 96, 60, 1)
RATIO = 300.0 / 58.0  # a 60 px bar with end bars measures 58


def drag(n: int, start: int = 0) -> list:
    """A marker drag with the scale legend: frame i's far end moves 6 px
    right and 3 px up."""
    return [
        testing.make_frame(W, H, marker_lines=[((60 + 6 * i, 75), (300 + 6 * i, 200 - 3 * i))],
                           scale_texts=[TEXT], scale_bars=[BAR])
        for i in range(start, start + n)
    ]


def _kw(inline: str, sparse, crop) -> dict:
    return dict(map_h=G.map_h, map_w=G.map_w, btn_h=G.btn_h, btn_w=G.btn_w, grayscale=True,
                with_ocr=inline != "off", crop_h=crop, crop_w=crop and 2 * crop,
                scales_inline="none" if inline == "off" else inline, sparse_budget=sparse)


def _rows(frames) -> np.ndarray:
    bp = tbatch.BatchPipeline(W, H, batch=BSZ, device="cpu")
    try:
        return bp._pack_rois(frames).copy()
    finally:
        bp.close()


def hostpacks_match(a: np.ndarray, b: np.ndarray, kw: dict) -> bool:
    """Equal bytes, except that scales_rec score lanes may differ by 1."""
    if a.shape != b.shape:
        return False
    diff = np.nonzero(a != b)[0]
    if diff.size == 0:
        return True
    layout = tpp.hostpack_layout(G.map_h, G.map_w, with_ocr=kw["with_ocr"], crop_h=kw["crop_h"],
                                 crop_w=kw["crop_w"], scales_inline=kw["scales_inline"],
                                 sparse_budget=kw["sparse_budget"])
    if "scales_rec" not in layout:
        return False
    off, size = layout["scales_rec"]
    if diff.min() < off or diff.max() >= off + size:
        return False
    ra = a[off : off + size].view(np.int16).astype(np.int32)
    rb = b[off : off + size].view(np.int16).astype(np.int32)
    return bool(sd.score_lanes()[ra != rb].all()) and int(np.abs(ra - rb).max()) <= 1


def _assert_outputs_equal(got: dict, want: dict, kw: dict) -> None:
    assert set(got) == set(want)
    packs = got["hostpack"].numpy()
    assert packs.shape == np.asarray(want["hostpack"]).shape
    for i in range(packs.shape[0]):
        assert hostpacks_match(packs[i], np.asarray(want["hostpack"])[i], kw), f"frame {i}"
    for key in set(got) - {"hostpack"}:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


# (scales transport, sparse budget, window crop height or None): the device
# read with sparse words, the binary images with a window crop, the gray
# images with the full plane, checksum-only scales with a small word budget
# (frames past it), no OCR at all.
CONFIGS = {"device": ("device", 1592, None), "binary": ("binary", None, 100),
           "gray": ("gray", None, None), "none": ("none", 256, None), "off": ("off", 1592, None)}


@pytest.fixture(scope="module")
def jax_batches():
    """{config: (kw, rows, JAX packed outputs, buf, bucket, JAX delta outputs)}
    over a drag with a sleeping frame, and a partial delta batch."""
    frames = drag(BSZ)
    frames[1] = testing.make_frame(W, H, with_button=False)
    rows = _rows(frames)
    nxt = _rows(drag(2, start=BSZ))
    bp = tbatch.BatchPipeline(W, H, batch=BSZ, device="cpu")
    bp._mirror = rows[BSZ - 1].copy()
    buf, bucket = bp._delta_updates(nxt, 2)  # a partial batch: row 2 replays row 1
    bp.close()
    out = {}
    for name, (inline, sparse, crop) in CONFIGS.items():
        kw = _kw(inline, sparse, crop)
        packed = jpp._analyze_batch_packed(jnp.asarray(rows), resident_row=BSZ - 1, channels=3, **kw)
        delta = jpp._analyze_batch_delta(jnp.asarray(rows[BSZ - 1]), jnp.asarray(buf), bucket=bucket,
                                         chunk=32, channels=3, **kw)
        out[name] = (kw, rows, {k: np.asarray(v) for k, v in packed.items()}, buf, bucket,
                     {k: np.asarray(v) for k, v in delta.items()})
    return out


def _templates():
    return sd.templates_to_device(sd.device_templates(), "cpu")


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_batch_packed_flat_equals_jax(jax_batches, config):
    kw, rows, want, *_ = jax_batches[config]
    got = tpp.analyze_batch_packed_flat(torch.from_numpy(rows), resident_row=BSZ - 1, templates=_templates(), **kw)
    _assert_outputs_equal(got, want, kw)
    # Each row is the per-frame pass's.
    one = tpp.analyze_packed_flat(torch.from_numpy(rows[2].copy()), with_quiet=True, templates=_templates(), **kw)
    assert hostpacks_match(got["hostpack"][2].numpy(), one["hostpack"].numpy(), kw)
    assert torch.equal(got["lsd_bits"][2], one["lsd_bits"])


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_batch_delta_flat_equals_jax(jax_batches, config):
    kw, rows, _, buf, bucket, want = jax_batches[config]
    resident = torch.from_numpy(rows[BSZ - 1].copy())
    before = resident.clone()
    got = tpp.analyze_batch_delta_flat(resident, torch.from_numpy(buf), bucket=bucket, chunk=32,
                                       templates=_templates(), **kw)
    _assert_outputs_equal(got, want, kw)
    assert torch.equal(resident, before), "the delta pass wrote into the resident buffer"


def test_batch_delta_flat_rejects_a_ragged_buffer():
    with pytest.raises(ValueError):
        tpp.analyze_batch_delta_flat(torch.zeros(256, dtype=torch.uint8), torch.zeros(100, dtype=torch.uint8),
                                     bucket=16, chunk=32)


def _summary(results) -> list:
    return [
        (r.sleeping, [l.as_tuple() for l in r.markers], r.meters_to_px_ratio,
         None if r.minimap_bounds is None else (r.minimap_bounds.left, r.minimap_bounds.top,
                                                r.minimap_bounds.right, r.minimap_bounds.bottom))
        for r in results
    ]


@pytest.fixture(scope="module")
def drag_frames():
    frames = drag(2 * BSZ)
    frames[4] = testing.make_frame(W, H, with_button=False)
    return frames


@pytest.fixture(scope="module")
def jax_pipeline_results(drag_frames):
    """smh_tpu's BatchPipeline over two batches (a full upload, then the
    delta chain) with smhocr: the device scales read."""
    bp = JBatchPipeline(W, H, batch=BSZ, ocr_engine=jsmhocr.SmhOcrEngine())
    bp.delta_mode = "on"
    try:
        return _summary(bp.process(drag_frames[:BSZ]) + bp.process(drag_frames[BSZ:])), dict(bp.stats)
    finally:
        bp.close()


def test_batch_pipeline_equals_jax_and_the_per_frame_state(drag_frames, jax_pipeline_results):
    want, jstats = jax_pipeline_results
    bp = tbatch.BatchPipeline(W, H, batch=BSZ, ocr_engine=tsmhocr.SmhOcrEngine(), device="cpu")
    bp.delta_mode = "on"
    try:
        got = _summary(bp.process(drag_frames[:BSZ]) + bp.process(drag_frames[BSZ:]))
        stats = dict(bp.stats)
    finally:
        bp.close()
    assert got == want
    assert (stats["full_batches"], stats["delta_batches"], stats["h2d_bytes"]) == (
        jstats["full_batches"], jstats["delta_batches"], jstats["h2d_bytes"]) == (1, 1, stats["h2d_bytes"])
    assert [r[0] for r in got] == [False] * 4 + [True, False]
    assert all(len(r[1]) == 1 and r[2] == pytest.approx(RATIO) for r in got if not r[0])

    s = Settings(path=None)
    s.set("hardware_acceleration", True, save=False)
    state = VisionState(settings=s, ocr_engine=tsmhocr.SmhOcrEngine(), device="cpu")
    try:
        per_frame = []
        for f in drag_frames:
            r = state.process(Frame(f, 96))
            per_frame.append((True, [], None, None) if r is None else _summary([tbatch.BatchResult(
                False, r.markers, r.minimap_bounds, r.meters_to_px_ratio)])[0])
    finally:
        state.close()
    assert got == per_frame


def test_failed_batch_dispatch_drops_the_delta_chain(monkeypatch):
    """The rolling delta path packs the next batch INTO the host mirror
    before the dispatch. When the batched pass raises, the chain must be
    dropped: the next batch is a full upload whose hostpacks equal a fresh
    pipeline's. (With the chain kept, the next batch would diff against a
    mirror the device never got, and the rows the failed batch changed
    would stay stale on the device.)"""
    batches = [
        [testing.make_frame(W, H, marker_lines=[((60, 75), (300, 200))]) for _ in range(BSZ)],
        # The failed batch adds a second line ...
        [testing.make_frame(W, H, marker_lines=[((60, 75), (300, 200)), ((40, 300), (400, 260 + i))])
         for i in range(BSZ)],
        # ... which the next batch keeps, unchanged against the failed tail.
        [testing.make_frame(W, H, marker_lines=[((60 + 4 * i, 75), (300, 200)), ((40, 300), (400, 262))])
         for i in range(BSZ)],
    ]
    bp = tbatch.BatchPipeline(W, H, batch=BSZ, device="cpu")
    bp.delta_mode = "on"
    real = tpp.analyze_batch_delta_flat
    failures = []

    def fail_once(*args, **kw):
        if not failures:
            failures.append(1)
            raise RuntimeError("injected batch dispatch failure")
        return real(*args, **kw)

    monkeypatch.setattr(tpp, "analyze_batch_delta_flat", fail_once)
    try:
        bp.process(batches[0])
        with pytest.raises(RuntimeError, match="injected"):
            bp.submit(batches[1])
        packs = bp.submit(batches[2])["shards"][0]["hostpack"].numpy()
        stats = dict(bp.stats)
    finally:
        bp.close()
    fresh = tbatch.BatchPipeline(W, H, batch=BSZ, device="cpu")
    try:
        want = fresh.submit(batches[2])["shards"][0]["hostpack"].numpy()
    finally:
        fresh.close()
    np.testing.assert_array_equal(packs, want)
    assert stats["full_batches"] == 2 and stats["delta_batches"] == 0


def test_mesh_and_an_absent_card_raise():
    from smh_tpu_torch.parallel import spmd

    with pytest.raises(ValueError, match="not divisible by dp=2"):
        tbatch.BatchPipeline(W, H, batch=BSZ, mesh=spmd.make_mesh(["cpu"] * 2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tbatch.BatchPipeline(W, H, device="cuda")
