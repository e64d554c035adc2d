"""Kernel 8, the delta apply (csrc/delta_apply.cu), on the CPU: its plain
twin `delta_apply_plain` (which the wrapper takes for CPU tensors) against
the JAX package's scatter -- the "resident" output of _analyze_delta_flat
for one frame, the chain tail and per-row hostpacks of _analyze_batch_delta
for B = 1, 3 and 8 -- and the index order the kernel relies on: every
producer of delta index tables (CudaBackend's per-frame diff, BatchPipeline's
rolled and two-pass diffs, native and numpy) emits each frame's indices
non-decreasing. The kernel itself runs only on the card (chip_smoke.py's
delta_apply phase holds it to this twin). All comparisons are exact."""

import pathlib

import jax
import numpy as np
import pytest
import torch

from smh_tpu.ops import pipeline as jpp
from smh_tpu_torch import _probe, probe_delta_apply
from smh_tpu_torch import consts as C
from smh_tpu_torch import testing
from smh_tpu_torch.ops import kernels as K
from smh_tpu_torch.ops import pipeline as tpp
from smh_tpu_torch.vision import batch as tbatch
from smh_tpu_torch.vision import cuda_backend as cb
from test_torch_reference import _reference_native, port_native  # noqa: F401  (module-scoped fixtures)

torch.set_num_threads(1)

CSRC = pathlib.Path(K.__file__).resolve().parent.parent / "csrc"

FW, FH = 641, 361  # map 275 x 329
G = C.map_geometry(FW, FH)
SUB = cb._DELTA_SUB
KW = dict(map_h=G.map_h, map_w=G.map_w, btn_h=G.btn_h, btn_w=G.btn_w, grayscale=True, scales_inline="none",
          sparse_budget=256)


def packed(off: int = 0) -> np.ndarray:
    """The flat upload of a frame with a marker line `off` px right."""
    f = testing.make_frame(FW, FH, marker_lines=[((20 + off, 30), (150 + off, 90))], scale_bars=[(10, 50, 60, 1)])
    mr = f[G.map_y : G.map_y + G.map_h, G.map_x : G.map_x + G.map_w]
    br = f[G.btn_y : G.btn_y + G.btn_h, G.btn_x : G.btn_x + G.btn_w]
    return cb._pack_rois_bgr(mr, br, cb._DELTA_CHUNK)


def upload(tables: list, datas: list) -> np.ndarray:
    """B index tables then B blocks of chunks, as one u8 upload."""
    idx = np.stack(tables).astype(np.int32)
    return np.concatenate([idx.reshape(-1).view(np.uint8), np.stack(datas).reshape(-1)])


def padded_table(chunks: np.ndarray, data: np.ndarray, bucket: int) -> tuple:
    """A bucket of sorted chunk indices padded by repeating the last one
    with its data (native.gather_subchunks' padding)."""
    n = chunks.size
    idx = np.concatenate([chunks, np.full(bucket - n, chunks[-1])]).astype(np.int32)
    dat = np.concatenate([data, np.repeat(data[-1:], bucket - n, axis=0)])
    return idx, dat


def case(name: str, base: np.ndarray, rng) -> tuple:
    """(bucket, upload) of a per-frame case."""
    n_sub = base.size // SUB
    chunks = base.reshape(n_sub, SUB)
    if name == "no change":  # one repeated index with its own bytes
        idx, dat = padded_table(np.array([7]), chunks[7:8].copy(), 16)
    elif name == "chunk 0":
        idx, dat = padded_table(np.array([0]), rng.integers(0, 256, (1, SUB), dtype=np.uint8), 16)
    elif name == "last chunk":
        idx, dat = padded_table(np.array([n_sub - 1]), rng.integers(0, 256, (1, SUB), dtype=np.uint8), 16)
    elif name == "every chunk":  # another frame's bytes in every chunk
        idx, dat = np.arange(n_sub, dtype=np.int32), packed(11).reshape(n_sub, SUB)
    else:  # "padded duplicates": the diff of a moved marker line, padded
        new = packed(5)
        ne = np.nonzero((new.reshape(n_sub, SUB) != chunks).any(axis=1))[0]
        bucket = next(b for b in cb._DELTA_BUCKETS if b > ne.size)
        idx, dat = padded_table(ne, new.reshape(n_sub, SUB)[ne], bucket)
    return idx.size, upload([idx], [dat])


@pytest.mark.parametrize("name", ["no change", "chunk 0", "last chunk", "every chunk", "padded duplicates"])
def test_delta_apply_matches_jax_resident(name):
    """The rebuilt frame equals JAX's "resident" byte for byte, the
    resident buffer is left as it was, and the pass over the frame gives
    JAX's hostpack."""
    rng = np.random.default_rng(len(name))
    base = packed(0)
    bucket, buf = case(name, base, rng)
    want = jax.device_get(jpp._analyze_delta_flat(base, buf, bucket=bucket, chunk=SUB, channels=3, **KW))
    resident = torch.from_numpy(base.copy())
    rows = K.delta_apply_plain(resident, torch.from_numpy(buf), bucket, SUB)
    assert rows.shape == (1, base.size)
    np.testing.assert_array_equal(rows[0].numpy(), np.asarray(want["resident"]))
    assert torch.equal(K.delta_apply(resident, torch.from_numpy(buf), bucket, SUB), rows)  # CPU: the twin
    got = tpp.analyze_delta_flat(resident, torch.from_numpy(buf), bucket=bucket, chunk=SUB, **KW)
    np.testing.assert_array_equal(got["resident"].numpy(), np.asarray(want["resident"]))
    np.testing.assert_array_equal(got["hostpack"].numpy(), np.asarray(want["hostpack"]))
    np.testing.assert_array_equal(resident.numpy(), base)
    if name == "no change":
        np.testing.assert_array_equal(rows[0].numpy(), base)


@pytest.mark.parametrize("bsz", [1, 3, 8])
def test_delta_apply_batch_matches_jax_chain(bsz):
    """B frames of a marker drag as chunk updates in chain order (each
    frame's changed chunks against the frame before), chunk 40 written by
    frames 0 and 2 with different data (black, then white): each row is
    the row before with its frame's updates (the lax.scan's semantics), the
    last row JAX's chain tail, the rows' hostpacks JAX's, and the resident
    buffer untouched."""
    base = packed(0)
    n_sub = base.size // SUB
    tables, datas = [], []
    prev = base.reshape(n_sub, SUB)
    for f in range(bsz):
        cur = packed(3 * f + 3).reshape(n_sub, SUB).copy()
        if f in (0, 2):
            cur[40] = 0 if f == 0 else 255
        chunks = np.nonzero((cur != prev).any(axis=1))[0]
        tables.append(chunks)
        datas.append(cur[chunks])
        prev = cur
    bucket = next(b for b in cb._DELTA_BUCKETS if b > max(t.size for t in tables))
    for f in range(bsz):
        tables[f], datas[f] = padded_table(tables[f], datas[f], bucket)
    buf = upload(tables, datas)
    want = jax.device_get(jpp._analyze_batch_delta(base, buf, bucket=bucket, chunk=SUB, channels=3,
                                                   **KW))
    resident = torch.from_numpy(base.copy())
    rows = K.delta_apply_plain(resident, torch.from_numpy(buf), bucket, SUB)
    prev = base.reshape(n_sub, SUB)
    for f in range(bsz):
        cur = prev.copy()
        cur[tables[f]] = datas[f]
        np.testing.assert_array_equal(rows[f].numpy(), cur.reshape(-1), err_msg=f"row {f}")
        prev = cur
    np.testing.assert_array_equal(rows[-1].numpy(), np.asarray(want["resident"]))
    assert (rows[0].numpy().reshape(n_sub, SUB)[40] == 0).all()
    if bsz > 2:
        assert 40 in tables[2] and (rows[2].numpy().reshape(n_sub, SUB)[40] == 255).all()
    got = tpp.analyze_batch_delta_flat(resident, torch.from_numpy(buf), bucket=bucket, chunk=SUB,
                                       **KW)
    np.testing.assert_array_equal(got["hostpack"].numpy(), np.asarray(want["hostpack"]))
    np.testing.assert_array_equal(got["resident"].numpy(), np.asarray(want["resident"]))
    np.testing.assert_array_equal(resident.numpy(), base)


def test_delta_apply_rejects_bad_uploads():
    resident = torch.zeros(4096, dtype=torch.uint8)
    buf = torch.zeros(16 * (4 + SUB), dtype=torch.uint8)
    assert K.delta_apply(resident, buf, 16, SUB).shape == (1, 4096)
    for bad in (buf[:-1], buf.view(2, -1), buf.to(torch.int8)):
        with pytest.raises(ValueError):
            K.delta_apply(resident, bad, 16, SUB)
    with pytest.raises(ValueError):
        K.delta_apply(resident[:-1], buf, 16, SUB)  # not whole chunks
    with pytest.raises(ValueError):
        K.delta_apply(resident.to("meta"), buf.to("meta"), 16, SUB)  # neither the CPU nor a card
    with pytest.raises(ValueError):
        tpp.analyze_batch_delta_flat(resident, buf[:-1], bucket=16, chunk=SUB, **KW)


# -- the index order kernel 8 relies on --------------------------------------------


def _assert_non_decreasing(buf: np.ndarray, bucket: int, bsz: int, label: str) -> None:
    idx = np.asarray(buf[: 4 * bucket * bsz]).view(np.int32).reshape(bsz, bucket)
    assert (np.diff(idx, axis=1) >= 0).all(), f"{label}: an index table is not non-decreasing"


def _drag(n: int, w: int = 960, h: int = 540) -> list:
    return [testing.make_frame(w, h, marker_lines=[((60 + 9 * i, 75), (300 + 9 * i, 200 - 5 * i))],
                               scale_texts=[("300m", (30, 70))], scale_bars=[(30, 96, 60, 1)]) for i in range(n)]


@pytest.mark.usefixtures("port_native")
def test_cuda_backend_index_tables_are_non_decreasing():
    """CudaBackend's per-frame delta: the fused pack + diff (against a
    mirror and rolled in place) and the two-pass diff of a frame the fused
    pack cannot read (not BGRA-contiguous)."""
    be = cb.CudaBackend(device="cpu")
    be.delta_mode = "on"
    seen = 0
    frames = _drag(5) + [np.asfortranarray(f) for f in _drag(3)]
    for i, f in enumerate(frames):
        be.load_frame(f)
        if be._pending[0] == "delta":
            _, buf, bucket, _ = be._pending
            _assert_non_decreasing(buf.numpy(), bucket, 1, f"frame {i}")
            seen += 1
        be.crop_to_map(True)
    assert seen == len(frames) - 1  # every frame after the first, the two-pass ones too


@pytest.mark.usefixtures("port_native")
@pytest.mark.parametrize("route", ["roll", "two-pass native", "two-pass numpy"])
def test_batch_pipeline_index_tables_are_non_decreasing(route):
    """BatchPipeline's delta uploads: the rolled pack + diff, and the
    two-pass diff with the native module and with numpy; a partial batch
    pads with chunk 0."""
    bp = tbatch.BatchPipeline(960, 540, batch=4, device="cpu")
    try:
        frames = _drag(7)
        rows = bp._pack_rois(frames[:4]).copy()
        bp._mirror = rows[3].copy()
        if route == "roll":  # the row bands, merged
            got = bp._roll_delta(frames[4:])
            assert bp.stats["roll_bands"] == len(bp._roll_rows) > 1
        else:
            if route == "two-pass numpy":
                bp._native = None
            got = bp._delta_updates(bp._pack_rois(frames[4:]), 3)
        assert got is not None
        buf, bucket = got
        _assert_non_decreasing(buf, bucket, 4, route)
    finally:
        bp.close()


@pytest.mark.parametrize("variant", sorted(probe_delta_apply.VARIANTS))
def test_probe_patches_apply(variant):
    """Each ablation and chain variant of probe_delta_apply applies to the
    kernel source as it is, each of its texts exactly once, and changes it
    (except the unpatched build); the source names what it replaces."""
    text = (CSRC / "delta_apply.cu").read_text()
    patches = probe_delta_apply.VARIANTS[variant][0]
    src = text
    for old, new in patches:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    assert src == _probe.patched(CSRC, ("delta_apply.cu",), {"delta_apply.cu": list(patches)})["delta_apply.cu"]
    assert (src == text) == (not patches)
    assert "smh_delta_apply" in src and "_analyze_delta_flat" in src and "_analyze_batch_delta" in src


def test_probe_variants_and_chain_steps():
    """The probe's chain floor counts the launch, the load round trips and
    the barriers; its builds that keep the outputs (held to the twin on the
    card) are the ones that are neither an ablation nor a chain variant,
    and its timeline stamps one point more than it has phases."""
    assert set(probe_delta_apply.CHAIN_STEPS) == {"launch", "dependent load", "block barrier"}
    for name, (_patches, keeps) in probe_delta_apply.VARIANTS.items():
        assert keeps == (not name.startswith(("ablation", "chain"))), name
    assert len(probe_delta_apply._STAMPS) == len(probe_delta_apply.TIMELINE_PHASES) + 1
