"""The port's multi-device path (smh_tpu_torch/parallel/) on CPU meshes,
against the JAX package's unsharded functions and the port's own unsharded
pass: analyze_frame against smh_tpu's, analyze_batch over (dp, sp) meshes
(even and uneven row splits, 128x160 and 1080p) against analyze_frame frame
by frame, the batched march (kernel 4's batch of masks; its plain version
here) against smh_tpu's lsd._march, full_step's winners, BatchPipeline over
a mesh against one device, the mesh's validation and the dry run.

Tolerance: exact for every output of the fused pass (integers, and the red
ratio's same f32 operations), and for the march against the port's own
per-frame march. The march against smh_tpu's differs by float rounding
only: XLA contracts pos = start + k * d and the squared length to FMA, and
its theta table differs by an ulp in a few entries (test_torch_lsd.py
states the same bounds). smh_tpu's own slow tests (test_parallel.py) pin
its sharded functions to the unsharded ones these tests compare against."""

import jax
import numpy as np
import pytest
import torch

from smh_tpu.ops import lsd as jlsd
from smh_tpu.ops import pipeline as jpp
from smh_tpu_torch import consts as C
from smh_tpu_torch import testing
from smh_tpu_torch.ocr.smhocr import SmhOcrEngine
from smh_tpu_torch.ops import lsd as tlsd
from smh_tpu_torch.ops import pipeline as tpp
from smh_tpu_torch.parallel import dryrun, spmd
from smh_tpu_torch.vision import batch as tbatch
from smh_tpu_torch.vision.reference import ReferenceBackend

torch.set_num_threads(1)

MAX_GAP = int(C.LSD_MAX_GAP)
SHARED = ("ui", "ui_check", "lsd_bool", "lsd_mask", "lsd_bits", "scales_bits", "scales_bool", "ocr_img",
          "quiet_bool")


def _random_frames(b: int, seed: int, h: int = 128, w: int = 160) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(b, h, w, 4), dtype=np.uint8)


def _equal_to_frames(out: dict, frames: np.ndarray, grayscale: bool = True) -> None:
    got = spmd.gather(out, "cpu")
    for i, f in enumerate(frames):
        want = tpp.analyze_frame(f, grayscale=grayscale, device="cpu")
        for k in SHARED:
            assert torch.equal(got[k][i], want[k]), (i, k)
        btn_g = C.map_geometry(f.shape[1], f.shape[0])
        btn = f[btn_g.btn_y : btn_g.btn_y + btn_g.btn_h, btn_g.btn_x : btn_g.btn_x + btn_g.btn_w, :3]
        assert torch.equal(got["red_ratio"][i], tpp._red_gate_roi(torch.from_numpy(np.ascontiguousarray(btn))))


# -- the whole-frame entry against smh_tpu's -----------------------------------


@pytest.mark.parametrize("seed,grayscale", [(0, True), (1, True), (2, False)])
def test_analyze_frame_matches_jax(seed, grayscale):
    frame = _random_frames(1, seed)[0]
    frame[40:60, 120:150, :3] = (0, 255, 64)  # a block of the alpha marker colour
    want = jpp.analyze_frame(jax.numpy.asarray(frame), grayscale=grayscale)
    got = tpp.analyze_frame(frame, grayscale=grayscale, device="cpu")
    assert set(SHARED) <= set(got) and set(SHARED) <= set(want)
    for k in SHARED:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got["lsd_mask"].dtype == torch.uint8 and set(np.unique(got["lsd_mask"].numpy())) <= {0, 255}


def test_analyze_frame_with_isolated_and_a_tensor_input():
    frame = _random_frames(1, 3)[0]
    got = tpp.analyze_frame(torch.from_numpy(frame), with_isolated=True)  # a tensor runs where it lies
    want = jpp.analyze_frame(jax.numpy.asarray(frame), with_isolated=True)
    for k in ("isolated_map", "cropped_brq", "lsd_mask", "quiet_bool"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_analyze_frame_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpp.analyze_frame(_random_frames(1, 0)[0])


@pytest.mark.parametrize("row0,rows", [(0, 20), (17, 31), (40, 8), (44, 4)])
def test_ocr_preprocess_of_a_row_block_is_the_quadrants_rows(row0, rows):
    """A block of quadrant rows with 3 rows of context each side gives the
    whole quadrant's rows: the last-rows clip is taken in quadrant rows."""
    rng = np.random.default_rng(row0)
    h, w = 48, 40
    planes = [torch.from_numpy(rng.integers(150, 256, (h, w), dtype=np.uint8)) for _ in range(3)]
    planes[0][::5] = planes[1][::5]  # monochrome rows: strict and edge pixels
    whole = tpp._ocr_preprocess_planes(*planes)
    halo = 3
    lo, hi = max(0, row0 - halo), min(h, row0 + rows + halo)
    block = tpp._ocr_preprocess_planes(*(p[lo:hi] for p in planes), row0=lo, total_h=h)
    assert torch.equal(block[row0 - lo : row0 - lo + rows], whole[row0 : row0 + rows])


# -- analyze_batch over (dp, sp) against the unsharded pass ----------------------


@pytest.mark.parametrize("dp,sp", [(8, 1), (4, 2), (2, 3), (1, 8), (2, 4)])
def test_analyze_batch_matches_analyze_frame(dp, sp):
    """128x160: a 97-row map, so sp = 3 and 8 split it unevenly (32/32/33,
    12-13 rows a shard; the quadrant starts at row 48)."""
    frames = _random_frames(8, 10 + sp)
    frames[:, 60:80, 115:150, :3] = (0, 255, 64)  # a marker block across the seams
    out = spmd.analyze_batch(frames, spmd.make_mesh(["cpu"] * (dp * sp), sp=sp))
    assert len(out["ui"]) == dp and all(t.shape[0] == 8 // dp for t in out["ui"])
    _equal_to_frames(out, frames)


def test_analyze_batch_in_colour():
    frames = _random_frames(4, 7)
    out = spmd.analyze_batch(torch.from_numpy(frames), spmd.make_mesh(["cpu"] * 6, sp=3), grayscale=False)
    _equal_to_frames(out, frames, grayscale=False)


@pytest.mark.parametrize("dp,sp", [(1, 2), (1, 3)])
def test_analyze_batch_at_1080p_across_seams(dp, sp):
    frames, _ = dryrun.seam_frames(2)
    out = spmd.analyze_batch(frames, spmd.make_mesh(["cpu"] * (dp * sp), sp=sp))
    _equal_to_frames(out, frames)
    got = spmd.gather(out, "cpu")
    assert int(got["lsd_bool"][:, 270:280].sum()) > 0 and int(got["lsd_bool"][:, 540:555].sum()) > 0
    assert int((got["ocr_img"][:, 130:145] < 255).sum()) > 0  # the text's pixels around the seam


def test_row_splits_are_even_and_cover_the_rows():
    for n, sp in ((97, 3), (822, 2), (822, 3), (8, 8), (10, 4)):
        splits = spmd.row_splits(n, sp)
        assert splits[0][0] == 0 and splits[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(splits, splits[1:]))
        assert max(r1 - r0 for r0, r1 in splits) - min(r1 - r0 for r0, r1 in splits) <= 1
    with pytest.raises(ValueError, match="sp=3"):
        spmd.row_splits(2, 3)


# -- the batched march against smh_tpu's lsd._march -------------------------------


def _march_inputs():
    """test_parallel.py's 320x200 masks (the oracle's dilated marker masks)
    and seeds on the lines."""
    masks, pts = [], []
    for i in range(8):
        f = testing.make_frame(320, 200, marker_lines=[((10 + i, 12), (100 + i, 64))])
        be = ReferenceBackend()
        be.load_frame(f)
        be.crop_to_map(True)
        be.isolate_map_markers()
        be.mask_marker_lines()
        masks.append(be.lsd_image)
        pts.append([55.0 + i, 38.0])
    return np.stack(masks), np.asarray(pts, np.float32)


@pytest.fixture(scope="module")
def march_case():
    masks, pts = _march_inputs()
    mh, mw = masks.shape[1:]
    jax_rows = []
    for i in range(len(masks)):
        e1, l1 = jlsd._march(jax.numpy.asarray(masks[i]), jax.numpy.asarray(pts[i]), h=mh, w=mw, max_gap=MAX_GAP,
                             max_k=jlsd._max_k(mh, mw))
        jax_rows.append((np.asarray(e1), np.asarray(l1)))
    return masks, pts, jax_rows


def test_march_batch_matches_jax_march(march_case):
    masks, pts, jax_rows = march_case
    ends, lengths = spmd.march_batch(masks, pts, spmd.make_mesh(["cpu"] * 8, sp=2))
    assert len(ends) == 4 and tuple(ends[0].shape) == (2, tlsd.N_ANGLES, 2)
    ends, lengths = spmd.gather(ends, "cpu").numpy(), spmd.gather(lengths, "cpu").numpy()
    for i, (e1, l1) in enumerate(jax_rows):
        moved = np.abs(ends[i] - e1).max(axis=-1)
        n_step = int((moved > 1e-3).sum())
        assert np.all(moved[moved <= 1e-3] <= 1e-4) and n_step <= 2, (i, n_step)
        np.testing.assert_allclose(lengths[i], l1, rtol=1e-6, atol=1e-3)


def test_march_batch_equals_the_per_frame_march(march_case):
    """Exact: the batch of masks against the single-mask march, mask by
    mask (one call per dp row against one call per frame)."""
    masks, pts, _ = march_case
    mh, mw = masks.shape[1:]
    ends, lengths = (spmd.gather(x, "cpu") for x in spmd.march_batch(torch.from_numpy(masks), pts,
                                                                       spmd.make_mesh(["cpu"] * 2)))
    cos_t, sin_t = tlsd.theta_tables("cpu")
    for i in range(len(masks)):
        p = torch.from_numpy(pts[i : i + 1])
        ex, ey, *_ = tlsd.ray_march(torch.from_numpy(masks[i]), p, MAX_GAP, tlsd._max_k(mh, mw), cos_t, sin_t)
        assert torch.equal(ends[i], torch.stack([ex[0], ey[0]], dim=-1))
        lx, ly = p[:, 0:1] - ex, p[:, 1:2] - ey
        assert torch.equal(lengths[i], (lx * lx + ly * ly)[0])


@pytest.mark.parametrize("b", [1, 3])
def test_ray_march_over_a_batch_of_masks(b):
    """ops/lsd.py::ray_march on [B, h, w] masks (seed b marches mask b)
    equals one call per mask, all five outputs."""
    masks, pts = _march_inputs()
    masks, pts = torch.from_numpy(masks[:b].copy()), torch.from_numpy(pts[:b].copy())
    masks[-1, :, ::9] = 0  # the masks differ
    cos_t, sin_t = tlsd.theta_tables("cpu")
    k_total = tlsd.step_bound(*masks.shape[1:], MAX_GAP, None)
    got = tlsd.ray_march(masks, pts, MAX_GAP, k_total, cos_t, sin_t)
    for i in range(b):
        one = tlsd.ray_march(masks[i], pts[i : i + 1], MAX_GAP, k_total, cos_t, sin_t)
        for g, o in zip(got, one):
            assert torch.equal(g[i], o[0])


def test_ray_march_masks_and_seeds_must_agree():
    cos_t, sin_t = tlsd.theta_tables("cpu")
    with pytest.raises(ValueError, match="2 masks for 3 seeds"):
        tlsd.ray_march(torch.zeros((2, 8, 8), dtype=torch.uint8), torch.zeros((3, 2)), 2, 10, cos_t, sin_t)
    with pytest.raises(ValueError, match=r"\[B, h, w\]"):
        tlsd.ray_march(torch.zeros((1, 2, 8, 8), dtype=torch.uint8), torch.zeros((1, 2)), 2, 10, cos_t, sin_t)


def test_full_step_winners_match_jax(march_case):
    """full_step on 1080p frames: each frame's winner is smh_tpu's _march
    over the port's mask plus the reversed argmax (lengths to float
    rounding, ends within 1.5 px) and the port's per-frame march (exact)."""
    frames, pts = dryrun.seam_frames(2)
    mesh = spmd.make_mesh(["cpu"] * 4, sp=2)
    out = spmd.gather(spmd.full_step(frames, pts, mesh), "cpu")
    assert set(out) == {"red_ratio", "ui", "best_end", "best_length_sqr"}
    for i, f in enumerate(frames):
        mask = tpp.analyze_frame(f, device="cpu")["lsd_mask"]
        end, length = dryrun.single_march(mask, pts[i])
        assert torch.equal(out["best_end"][i], end) and torch.equal(out["best_length_sqr"][i], length)
        mh, mw = mask.shape
        e1, l1 = (np.asarray(a) for a in jlsd._march(jax.numpy.asarray(mask.numpy()), jax.numpy.asarray(pts[i]),
                                                        h=mh, w=mw, max_gap=MAX_GAP, max_k=jlsd._max_k(mh, mw)))
        best = (l1.shape[0] - 1) - int(np.argmax(l1[::-1]))
        np.testing.assert_allclose(float(out["best_length_sqr"][i]), l1[best], rtol=1e-6)
        assert np.all(np.abs(out["best_end"][i].numpy() - e1[best]) <= 1.5)
        assert float(length) >= 50.0**2


# -- BatchPipeline over a mesh ------------------------------------------------------

W, H = 960, 540


def _drag(n: int) -> list:
    return [
        testing.make_frame(W, H, marker_lines=[((60 + 6 * i, 75), (300 + 6 * i, 200 - 3 * i))],
                           scale_texts=[("300m", (30, 70))], scale_bars=[(30, 96, 60, 1)])
        for i in range(n)
    ]


def test_a_batch_of_one_frame_packs_as_the_frame():
    """A dp shard of one frame: the batched pass over a [1, padded] buffer
    gives analyze_packed_flat's hostpack (the parent raised on it: a
    [1, 1] section's stride refused the byte view)."""
    from smh_tpu_torch.ops import scales_device as sd

    g = C.map_geometry(W, H)
    bp = tbatch.BatchPipeline(W, H, batch=1, device="cpu")
    try:
        rows = bp._pack_rois(_drag(1))
    finally:
        bp.close()
    kw = dict(map_h=g.map_h, map_w=g.map_w, btn_h=g.btn_h, btn_w=g.btn_w, grayscale=True, scales_inline="device",
              sparse_budget=256, templates=sd.templates_to_device(sd.device_templates(), "cpu"))
    got = tpp.analyze_batch_packed_flat(torch.from_numpy(rows), **kw)["hostpack"]
    want = tpp.analyze_packed_flat(torch.from_numpy(rows[0]), **kw)["hostpack"]
    assert torch.equal(got[0], want)


@pytest.mark.parametrize("sparse", [True, False])
def test_batch_pipeline_on_a_mesh_matches_one_device(sparse, monkeypatch):
    """Hostpack bytes and detections equal; a mesh batch is always a full
    upload, where one device's second batch rides the delta chain. Without
    the sparse transport a quarter window misses, so each frame's full bit
    plane is fetched from the device that holds it."""
    monkeypatch.setenv("SMH_SPARSE", "1" if sparse else "0")
    monkeypatch.setenv("SMH_DELTA", "1")
    frames = _drag(4)
    mesh = spmd.make_mesh(["cpu"] * 8, sp=2)  # dp = 4: a frame a row
    got = {}
    for name, kw in (("single", {"device": "cpu"}), ("mesh", {"mesh": mesh})):
        bp = tbatch.BatchPipeline(W, H, batch=4, ocr_engine=SmhOcrEngine(), lsd_window=0.25, **kw)
        try:
            jobs = [bp.submit(frames), bp.submit(frames[::-1])]
            packs = [j["fetch"][0].numpy().copy() for j in jobs]
            results = [[dryrun.summarize(r) for r in bp.collect(j)] for j in jobs]
            got[name] = (packs, results, dict(bp.stats), len(jobs[0]["shards"]))
        finally:
            bp.close()
    (p1, r1, s1, n1), (p2, r2, s2, n2) = got["single"], got["mesh"]
    for a, b in zip(p2, p1):
        np.testing.assert_array_equal(a, b)
    assert r2 == r1
    assert all(len(r[0]) == 1 and r[1] is not None for batch in r2 for r in batch)
    assert (n1, n2) == (1, 4)
    assert s2["full_batches"] == 2 and s2["delta_batches"] == 0
    assert s1["full_batches"] == 1 and s1["delta_batches"] == 1


# -- the mesh --------------------------------------------------------------------------


def test_make_mesh_shapes_and_validation():
    mesh = spmd.make_mesh(["cpu"] * 8, sp=2)
    assert mesh.shape == {"dp": 4, "sp": 2} and mesh.devices[3][1] == torch.device("cpu")
    assert spmd.make_mesh([torch.device("cpu")] * 3).shape == {"dp": 3, "sp": 1}
    for n, sp in ((6, 4), (4, 0), (0, 1)):
        with pytest.raises(ValueError):
            spmd.make_mesh(["cpu"] * n, sp=sp)
    with pytest.raises(ValueError, match="dp=2"):
        spmd.analyze_batch(_random_frames(3, 0), mesh=spmd.make_mesh(["cpu"] * 2))
    with pytest.raises(ValueError, match="dp=2"):
        spmd.march_batch(np.zeros((3, 8, 8), np.uint8), np.zeros((3, 2), np.float32), spmd.make_mesh(["cpu"] * 2))
    with pytest.raises(ValueError, match="BGRA"):
        spmd.analyze_batch(_random_frames(2, 0)[..., :3], mesh=spmd.make_mesh(["cpu"] * 2))


def test_make_mesh_of_every_card_or_none():
    if torch.cuda.is_available():
        mesh = spmd.make_mesh()
        assert [d for row in mesh.devices for d in row] == [torch.device(f"cuda:{i}")
                                                             for i in range(torch.cuda.device_count())]
        with pytest.raises(RuntimeError, match="visible"):
            spmd.make_mesh([f"cuda:{torch.cuda.device_count()}"])
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            spmd.make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            spmd.make_mesh(["cuda:0", "cpu"])


def test_dryrun_in_process(capsys):
    assert dryrun.main(["--devices", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "halos bit-exact" in out and "full-DAG BatchPipeline on dp=4" in out and "dryrun OK" in out
