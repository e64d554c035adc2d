"""Kernel 7 (csrc/mask_words.cu) on the CPU: its wrapper's plain twin
against the JAX package's _mask_bbox and _sparse_words (the "search" engine
of _compact_words) on the unpacked mask, at the edges the kernel must get
right -- an empty and a full mask, a pixel at each corner, budget - 1,
budget and budget + 1 non-zero words, ragged widths -- and on a batch of
masks cut from the rows of one buffer; the host's sparse_mask_host
rebuilds the bit plane from its words. All comparisons are exact (integer
functions, run op by op). Also: the wrapper refuses what the kernel does
not take and launches nothing on the CPU. (The CUDA kernel itself is held
against the twin on the card by chip_smoke.py.)"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smh_tpu.ops import pipeline as opp
from smh_tpu_torch import _probe, probe_mask_words, testing
from smh_tpu_torch.ops import kernels
from smh_tpu_torch.ops import pipeline as tpp

torch.set_num_threads(1)

CSRC = pathlib.Path(kernels.__file__).resolve().parent.parent / "csrc"
BUDGETS = (0, 1, 16, 64, 256)


def _want(bits: np.ndarray, w: int, budget: int) -> np.ndarray:
    """JAX's bbox, the crop origin 0, nz, idx and dat, as kernel 7 lays them out."""
    m = jnp.asarray(opp.unpack_bits_host(bits, w).astype(bool))
    bbox = [int(v) for v in opp._mask_bbox(m)]
    nz, idx, dat = (np.asarray(x) for x in opp._sparse_words(m, budget))
    return np.concatenate([np.array(bbox + [0, 0, int(nz)], np.int32), idx.astype(np.int32), dat.view(np.int32)])


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("name", sorted(testing.mask_bits_cases(64)))
def test_plain_twin_matches_jax(name, budget):
    bits, w = testing.mask_bits_cases(64)[name]
    got = kernels.mask_bbox_sparse(torch.from_numpy(bits), w, budget)
    assert got.dtype == torch.int32 and got.shape == (kernels.MASK_META + 2 * budget,)
    np.testing.assert_array_equal(got.numpy(), _want(bits, w, budget))


@pytest.mark.parametrize("n", [255, 256, 257])
def test_nz_around_the_budget(n):
    """nz = budget - 1, budget and budget + 1: nz is the total, the slots
    hold the first min(nz, budget) words, the rest are zero."""
    bits, w = testing.mask_bits_cases(256)[f"nz_{n}"]
    got = kernels.mask_bbox_sparse(torch.from_numpy(bits), w, 256).numpy()
    np.testing.assert_array_equal(got, _want(bits, w, 256))
    assert got[6] == n
    idx = got[kernels.MASK_META : kernels.MASK_META + 256]
    assert (np.diff(idx[: min(n, 256)]) > 0).all() and not idx[min(n, 256) :].any()


@pytest.mark.parametrize("bsz", [1, 3])
def test_a_batch_cut_from_strided_rows_matches_each_frame(bsz):
    cases = testing.mask_bits_cases(64)
    w = 250
    names = [f"ragged_{w}", "nz_63", "nz_65"][:bsz]
    rows = torch.zeros((bsz, 70 * 32 + 5), dtype=torch.uint8)
    planes = rows[:, : 70 * 32].view(bsz, 70, 32)
    for i, name in enumerate(names):
        bits, _ = cases[name]
        planes[i, : bits.shape[0]] = torch.from_numpy(bits)
    got = kernels.mask_bbox_sparse(planes, w, 64)
    assert got.shape == (bsz, kernels.MASK_META + 128)
    for i in range(bsz):
        np.testing.assert_array_equal(got[i].numpy(), _want(planes[i].numpy(), w, 64), err_msg=names[i])


@pytest.mark.parametrize("shape", [(822, 986), (97, 161)])
def test_the_host_rebuilds_the_bit_plane_from_the_words(shape):
    h, w = shape
    m = np.random.default_rng(h).random((h, w)) < 0.002
    bits = np.packbits(m, axis=1)
    got = kernels.mask_bbox_sparse(torch.from_numpy(bits), w, 4096).numpy()
    nz = int(got[6])
    assert 0 < nz <= 4096
    idx = got[kernels.MASK_META : kernels.MASK_META + 4096]
    dat = got[kernels.MASK_META + 4096 :].view(np.uint32)
    np.testing.assert_array_equal(tpp.sparse_mask_host(nz, idx, dat, h, w), bits)
    ys, xs = np.nonzero(m)
    assert tuple(got[:4]) == (ys.min(), ys.max() + 1, xs.min(), xs.max() + 1)


def test_wrapper_refuses_what_the_kernel_does_not_take_and_launches_nothing_on_the_cpu():
    kernels.reset_launches()
    bits = torch.zeros((5, 4), dtype=torch.uint8)
    with pytest.raises(ValueError):
        kernels.mask_bbox_sparse(bits.to(torch.int32), 30, 4)
    with pytest.raises(ValueError):
        kernels.mask_bbox_sparse(bits, 40, 4)  # 40 columns take 5 bytes a row
    with pytest.raises(ValueError):
        kernels.mask_bbox_sparse(bits[None, None], 30, 4)
    with pytest.raises(ValueError):
        kernels.mask_bbox_sparse(bits, 30, -1)
    with pytest.raises(ValueError):
        kernels.mask_bbox_sparse(bits[:0], 30, 4)
    with pytest.raises(ValueError):
        kernels.mask_bbox_sparse(torch.zeros((5, 4), dtype=torch.uint8, device="meta"), 30, 4)
    kernels.mask_bbox_sparse(bits, 30, 4)
    assert kernels.LAUNCHES["mask_words"] == 0


def test_kernel_capacity_matches_the_cuda_source():
    import re

    src = (CSRC / "mask_words.cu").read_text()
    threads = int(re.search(r"constexpr int THREADS = (\d+);", src).group(1))
    rounds = int(re.search(r"constexpr int ROUNDS = (\d+);", src).group(1))
    assert threads == kernels.MASK_THREADS and threads * rounds == kernels.MASK_TILE_WORDS
    assert "constexpr int TILE_WORDS = THREADS * ROUNDS;" in src
    assert int(re.search(r"constexpr int MAX_TILES = (\d+);", src).group(1)) == kernels.MASK_MAX_TILES
    assert int(re.search(r"constexpr int META = (\d+);", src).group(1)) == kernels.MASK_META
    assert int(re.search(r"constexpr int HEAD = (\d+);", src).group(1)) == kernels.MASK_SCRATCH_HEAD
    assert int(re.search(r"constexpr int STATE = (\d+);", src).group(1)) == kernels.MASK_STATE_WORDS
    assert "H > 0xffff || W > 0xffff" in src and kernels.MASK_MAX_DIM == 0xFFFF
    assert "_mask_bbox" in src and "_sparse_words" in src and "_compact_words" in src
    # The largest map users run (3440x1440 -> 1096 x 2194) fits with room to spare.
    assert 1096 * tpp.sparse_word_pad((2194 + 7) // 8) // 4 < kernels.MASK_WORDS_MAX
    assert kernels.mask_tiles(1096, 2194) <= kernels.MASK_MAX_TILES // 8


@pytest.mark.parametrize("h,w,tiles", [(822, 986, 13), (1644, 1972, 50), (556, 250, 3), (1, 1, 1),
                                       (1096, 2194, 38), (5, 32768, 3), (5, 65535, 5), (65535, 8, 32),
                                       (65536, 8, None), (8, 65536, None), (5000, 65535, None)])
def test_mask_tiles_are_whole_rows_of_at_most_the_tile_words(h, w, tiles):
    """mask_tiles mirrors smh_mask_words_tiles: a tile is the most whole
    rows of at most MASK_TILE_WORDS words; a frame of more than
    MASK_MAX_DIM rows or columns or of more than MASK_MAX_TILES tiles is
    not taken (None)."""
    assert kernels.mask_tiles(h, w) == tiles


@pytest.mark.parametrize("variant", sorted(probe_mask_words.VARIANTS))
def test_probe_patches_apply(variant):
    """Each variant, ablation and chain step of probe_mask_words applies to
    the source as it is, and changes it (except the unpatched build)."""
    patches = list(probe_mask_words.VARIANTS[variant][0])
    src = _probe.patched(CSRC, ("mask_words.cu",), {"mask_words.cu": patches})["mask_words.cu"]
    assert (src == (CSRC / "mask_words.cu").read_text()) == (not patches)
    assert "smh_mask_words" in src and "__global__" in src
