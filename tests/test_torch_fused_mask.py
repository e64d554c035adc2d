"""Kernel 3 (csrc/fused_mask.cu) on the CPU: its plain twin against the JAX
package's XLA path and its Pallas kernel in interpret mode, the pad-bit
divergence of that Pallas kernel, and the wrapper's launch counter. All
comparisons are exact. (The CUDA kernel itself is held against the twin on
the card by chip_smoke.py.)

The marker classify is taken from JAX op by op: under jit, XLA fuses the
HSV chain and contracts multiply-adds into FMAs, which flips a truncated
value in ~1e-5 of random pixels (tests/test_pallas.py:21-26). Op by op, JAX
agrees with pixmath, as the port does over the whole colour cube."""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smh_tpu.ops import hsv as jhsv
from smh_tpu.ops import pipeline as opp
from smh_tpu.ops.pallas_kernels import fused_mask_bits_pallas
from smh_tpu_torch import testing
from smh_tpu_torch.ops import kernels
from smh_tpu_torch.vision import pixmath

torch.set_num_threads(1)

CSRC = pathlib.Path(kernels.__file__).resolve().parent.parent / "csrc"


_j_dilate_pack = jax.jit(lambda m: opp.pack_bits(opp._dilate_l1_radius1_bool(m)))
_j_marker = jax.jit(jhsv.is_any_map_marker_color)


def _xla_bits(rgb):
    """The JAX package's lsd_bits, pack_bits(_dilate_l1_radius1_bool(marker)),
    with the marker classified op by op."""
    return _j_dilate_pack(jhsv.is_any_map_marker_color(jnp.asarray(rgb)))


def _twin(rgb: np.ndarray) -> np.ndarray:
    planes = [torch.from_numpy(np.ascontiguousarray(rgb[..., c])) for c in range(3)]
    return kernels.fused_mask_bits(*planes).numpy()


def _marker_rich(shape, seed) -> np.ndarray:
    """Random RGB with ~10% alpha-marker pixels, ~10% near-marker colours
    (HSV threshold edges) and marker pixels down the last column."""
    rng = np.random.default_rng(seed)
    h, w = shape
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    pick = rng.random((h, w))
    rgb[pick < 0.1] = testing.ALPHA_MARKER_RGB
    near = (pick >= 0.1) & (pick < 0.2)
    jitter = rng.integers(-12, 13, (int(near.sum()), 3))
    rgb[near] = np.clip(np.array(testing.ALPHA_MARKER_RGB) + jitter, 0, 255).astype(np.uint8)
    rgb[h // 3 : h // 3 + 5, w - 1] = testing.ALPHA_MARKER_RGB
    return rgb


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (9, 16), (33, 65), (101, 37), (300, 521)])
def test_plain_twin_matches_xla_bytes(shape):
    rgb = _marker_rich(shape, sum(shape))
    got = _twin(rgb)
    want = np.asarray(_xla_bits(rgb))
    assert got.dtype == np.uint8 and got.shape == (shape[0], (shape[1] + 7) // 8)
    np.testing.assert_array_equal(got, want)


def test_plain_twin_matches_pallas_on_random_pixels():
    """tests/test_pallas.py's ragged 300 x 521 input. The Pallas kernel
    classifies like jitted XLA (same FMA flips) and equals that path
    exactly on [:, :w]; the twin equals the op-by-op path exactly. So the
    twin and the kernel differ exactly on the dilated flip pixels."""
    rgb = np.random.default_rng(1).integers(0, 256, size=(300, 521, 3), dtype=np.uint8)
    w = rgb.shape[1]
    pallas = opp.unpack_bits_host(
        np.asarray(fused_mask_bits_pallas(jnp.asarray(rgb), interpret=True)), w
    )
    jit_marker = np.asarray(_j_marker(jnp.asarray(rgb)))
    np.testing.assert_array_equal(
        pallas, opp.unpack_bits_host(np.asarray(_j_dilate_pack(jit_marker)), w)
    )
    twin = opp.unpack_bits_host(_twin(rgb), w)
    np.testing.assert_array_equal(twin, opp.unpack_bits_host(np.asarray(_xla_bits(rgb)), w))
    flips = jit_marker != pixmath.is_any_map_marker_color(rgb)
    assert 0 < flips.sum() <= 10  # 5 of 156,300 pixels with this seed
    near_flip = np.asarray(opp._dilate_l1_radius1_bool(jnp.asarray(flips)))
    assert ((twin != pallas) <= near_flip).all()
    np.testing.assert_array_equal(twin[~near_flip], pallas[~near_flip])


def test_plain_twin_matches_pallas_across_the_band_seam():
    """tests/test_pallas.py's solid box across the Pallas kernel's 256-row
    band seam (and the CUDA kernel's 16-row tile seams)."""
    rgb = np.full((520, 264, 3), 40, dtype=np.uint8)
    rgb[250:262, 100:140] = testing.ALPHA_MARKER_RGB
    bits_p = np.asarray(fused_mask_bits_pallas(jnp.asarray(rgb), interpret=True))
    got = _twin(rgb)
    np.testing.assert_array_equal(got, bits_p)  # w = 264: no pad bits
    expected = np.zeros((520, 264), bool)
    expected[249:263, 100:140] = True
    expected[250:262, 99:141] = True
    np.testing.assert_array_equal(opp.unpack_bits_host(got, 264).astype(bool), expected)


@pytest.mark.parametrize("w", [13, 21])
def test_pallas_sets_pad_bits_the_port_keeps_zero(w):
    """The Pallas kernel's dilate reads the zero-padded column w as the left
    neighbour's tap, so a marker run down the last column of a ragged row
    sets the pad bit after it. The port keeps the XLA path's bytes (pad
    bits zero); on [:, :w] all three agree."""
    rgb = np.full((16, w, 3), 40, dtype=np.uint8)
    rgb[5:8, w - 1] = testing.ALPHA_MARKER_RGB
    last = (w + 7) // 8 - 1
    pad_bit = 1 << (7 - w % 8)  # the first column past w in the last byte
    cols = (1 << (8 - (w - 8 * last))) * 3  # columns w-2 and w-1
    got = _twin(rgb)
    xla = np.asarray(_xla_bits(rgb))
    pallas = np.asarray(fused_mask_bits_pallas(jnp.asarray(rgb), interpret=True))
    np.testing.assert_array_equal(got, xla)
    assert got[5:8, last].tolist() == [cols] * 3  # 24 at w = 13 and 21
    assert pallas[5:8, last].tolist() == [cols | pad_bit] * 3  # 28
    np.testing.assert_array_equal(
        opp.unpack_bits_host(got, w), opp.unpack_bits_host(pallas, w)
    )


def test_no_launch_on_cpu_tensors():
    kernels.reset_launches()
    p = torch.zeros((3, 11), dtype=torch.uint8)
    bits = kernels.fused_mask_bits(p, p, p)
    assert bits.shape == (3, 2) and not bits.any()
    assert kernels.LAUNCHES["fused_mask"] == 0
    with pytest.raises(ValueError):
        kernels.fused_mask_bits(p, p, p[None])


def test_tile_and_source_notes_match_the_cuda_source():
    """The tile constants the tests and the chip smoke place their seams
    around are the source's, and the source packs as the restatement below
    does (ballot, __brev, __byte_perm 0x0123)."""
    src = (CSRC / "fused_mask.cu").read_text()
    assert int(re.search(r"constexpr int TH = (\d+);", src).group(1)) == kernels.FUSED_TILE_H == TH
    wpr = int(re.search(r"constexpr int WPR = (\d+);", src).group(1))
    assert "constexpr int TW = 32 * WPR;" in src
    assert 32 * wpr == kernels.FUSED_TILE_W == TW and TH >= 16
    assert "_fused_mask_kernel" in src and '#include "classify.cuh"' in src
    assert "__ballot_sync(FULL" in src and "__byte_perm(__brev(d), 0, 0x0123)" in src
    assert '#include "classify.cuh"' in (CSRC / "classify_luma.cu").read_text()


# -- the CUDA kernel's word dilate and pack (csrc/fused_mask.cu), restated ----

TH, TW = kernels.FUSED_TILE_H, kernels.FUSED_TILE_W
WPR = TW // 32
M32 = 0xFFFFFFFF


def _brev(x: np.ndarray) -> np.ndarray:
    """__brev: bit i -> bit 31 - i."""
    x = x.astype(np.uint64)
    for shift, mask in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F), (8, 0x00FF00FF)):
        x = ((x >> shift) & mask) | ((x & mask) << shift)
    return ((x >> 16) | (x << 16)) & M32


def _byte_perm(x: np.ndarray, y: int, selector: int) -> np.ndarray:
    """__byte_perm: byte n of the result is byte (selector >> 4n) & 7 of the
    eight bytes y:x."""
    src = x.astype(np.uint64) | (np.uint64(y) << np.uint64(32))
    out = np.zeros(x.shape, np.uint64)
    for n in range(4):
        out |= ((src >> np.uint64(8 * ((selector >> (4 * n)) & 7))) & np.uint64(0xFF)) << np.uint64(8 * n)
    return out


def _ballots(marker: np.ndarray, y: int, xs: np.ndarray) -> np.ndarray:
    """One warp ballot per x in xs: bit i = marker[y, x + i]; lanes at or
    past W and rows outside the plane vote 0."""
    h, w = marker.shape
    words = np.zeros(xs.shape, np.uint64)
    if 0 <= y < h:
        for i in range(32):
            x = xs + i
            votes = np.zeros(xs.shape, bool)
            votes[x < w] = marker[y, x[x < w]]
            words |= votes.astype(np.uint64) << np.uint64(i)
    return words


def _fused_restated(marker: np.ndarray) -> np.ndarray:
    """fused_mask.cu tile by tile on a bool [H, W] marker plane: ballot
    words of TH + 2 staged rows, the pixels one past each tile edge, the
    word dilate with carry bits, bits at x >= W masked, MSB-first bytes by
    __byte_perm(__brev(word), 0, 0x0123), a row's bytes cut at ceil(W/8)."""
    h, w = marker.shape
    bpr = (w + 7) // 8
    out = np.zeros((h, bpr), np.uint8)
    js = np.arange(WPR)
    for y0 in range(0, h, TH):
        for x0 in range(0, w, TW):
            m = np.stack([_ballots(marker, y0 - 1 + r, x0 + 32 * js) for r in range(TH + 2)])
            edge = np.array([[0 <= y0 - 1 + r < h and 0 <= x < w and marker[y0 - 1 + r, x] for r in range(TH + 2)]
                             for x in (x0 - 1, x0 + TW)], dtype=np.uint64)
            c = m[1:-1]
            left = np.concatenate([edge[0, 1:-1, None], c[:, :-1] >> np.uint64(31)], axis=1)
            right = np.concatenate([(c[:, 1:] << np.uint64(31)) & M32, edge[1, 1:-1, None] << np.uint64(31)], axis=1)
            d = c | m[:-2] | m[2:] | ((c << np.uint64(1)) & M32) | left | (c >> np.uint64(1)) | right
            valid = np.clip(w - (x0 + 32 * js), 0, 32).astype(np.uint64)
            d &= (np.uint64(1) << valid) - np.uint64(1)
            word_bytes = _byte_perm(_brev(d), 0, 0x0123)
            for r in range(min(TH, h - y0)):
                for j in range(WPR):
                    xb = (x0 + 32 * j) // 8
                    for k in range(max(0, min(4, bpr - xb))):
                        out[y0 + r, xb + k] = (int(word_bytes[r, j]) >> (8 * k)) & 0xFF
    return out


def test_restated_bit_intrinsics():
    x = np.array([1, 0x80000000, 0x12345678, M32], dtype=np.uint64)
    assert _brev(x).tolist() == [0x80000000, 1, 0x1E6A2C48, M32]
    assert _byte_perm(np.array([0x11223344], np.uint64), 0, 0x0123).tolist() == [0x44332211]
    # pixel 0 alone -> bit 0 of the word -> the MSB of the first byte in memory
    assert _byte_perm(_brev(np.array([1], np.uint64)), 0, 0x0123).tolist() == [0x80]


@pytest.mark.parametrize("w", [13, 21, 37, 263, 987, 1973])
def test_restated_word_pack_at_ragged_widths(w):
    """Ragged widths (W % 8 != 0, W % 32 != 0) with markers down the last
    column: the restated kernel equals the twin and the XLA bytes, pad bits
    zero."""
    rgb = _marker_rich((2 * TH + 5, w), w)
    rgb[:, w - 1][::3] = testing.ALPHA_MARKER_RGB
    marker = pixmath.is_any_map_marker_color(rgb)
    got = _fused_restated(marker)
    np.testing.assert_array_equal(got, _twin(rgb))
    np.testing.assert_array_equal(got, np.asarray(_xla_bits(rgb)))
    if w % 8:
        assert not (got[:, -1] & ((1 << (8 - w % 8)) - 1)).any()


@pytest.mark.parametrize(
    "shape", [(TH - 1, TW - 1), (TH, TW), (TH + 1, TW + 1), (2 * TH + 1, 2 * TW + 3), (3 * TH - 1, TW + 33)]
)
def test_restated_word_pack_across_tile_seams(shape):
    """Marker boxes across the row seam, the column seam, a word seam inside
    the tile and the corners: the restated kernel equals the twin and the
    XLA bytes."""
    h, w = shape
    rgb = np.full((h, w, 3), 40, dtype=np.uint8)
    rgb[max(TH - 2, 0) : TH + 2, TW - 3 : min(TW + 3, w)] = testing.ALPHA_MARKER_RGB
    rgb[max(TH - 2, 0) : TH + 2, 30:34] = testing.ALPHA_MARKER_RGB
    rgb[h - 1, w - 1] = rgb[0, 0] = rgb[h // 2, w - 1] = testing.ALPHA_MARKER_RGB
    marker = pixmath.is_any_map_marker_color(rgb)
    got = _fused_restated(marker)
    np.testing.assert_array_equal(got, _twin(rgb))
    np.testing.assert_array_equal(got, np.asarray(_xla_bits(rgb)))
