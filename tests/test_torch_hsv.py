"""The port's plain classify + luma (ops/hsv.py, the CPU twin of the
classify_luma CUDA kernel) against the numpy oracle and the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smh_tpu.ops import hsv as jhsv
from smh_tpu.ops.pallas_kernels import classify_luma_pallas_planes
from smh_tpu_torch import consts as C
from smh_tpu_torch.ops import hsv, kernels
from smh_tpu_torch.vision import pixmath

torch.set_num_threads(1)


def _cube_planes(r_lo: int, r_hi: int):
    """Every RGB colour with r in [r_lo, r_hi): planes [n*256, 256]."""
    r, g, b = np.meshgrid(
        np.arange(r_lo, r_hi, dtype=np.uint8),
        np.arange(256, dtype=np.uint8),
        np.arange(256, dtype=np.uint8),
        indexing="ij",
    )
    return [np.ascontiguousarray(x.reshape(-1, 256)) for x in (r, g, b)]


@pytest.mark.parametrize("r_lo", [0, 64, 128, 192])
def test_plain_classify_luma_exact_over_the_colour_cube(r_lo):
    """Exact against pixmath over the whole 256^3 cube (a quarter per case):
    same f32 order of operations, truncating casts, no FMA contraction."""
    planes = _cube_planes(r_lo, r_lo + 64)
    rgb = np.stack(planes, axis=-1)
    before = dict(kernels.LAUNCHES)
    marker, luma = kernels.classify_luma_planes(*(torch.from_numpy(p) for p in planes))
    assert kernels.LAUNCHES == before  # CPU tensors take the plain version
    assert marker.dtype == torch.uint8 and luma.dtype == torch.uint8
    np.testing.assert_array_equal(marker.numpy().astype(bool), pixmath.is_any_map_marker_color(rgb))
    np.testing.assert_array_equal(luma.numpy(), pixmath.luma8(rgb))


def test_hsv_planes_exact_against_oracle():
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, size=(257, 311, 3), dtype=np.uint8)
    rgb[0, :6] = [(0, 0, 0), (255, 255, 255), (255, 0, 0), (0, 255, 0), (0, 0, 255), (64, 255, 0)]
    h, s, v = hsv.rgb_to_hsv_u8_planes(*(torch.from_numpy(rgb[..., c].copy()) for c in range(3)))
    ho, so, vo = pixmath.rgb_to_hsv_u8(rgb)
    np.testing.assert_array_equal(h.numpy(), ho.astype(np.int32))
    np.testing.assert_array_equal(s.numpy(), so.astype(np.int32))
    np.testing.assert_array_equal(v.numpy(), vo.astype(np.int32))


def test_classify_luma_against_jax_and_pallas_interpret():
    """The same 300x520 ragged-tile input as tests/test_pallas.py. The JAX
    graph and the Pallas kernel may flip a truncated value at an integer
    boundary through FMA contraction (the tolerance of
    tests/test_pallas.py:21-26); the port is exact against the oracle."""
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, size=(300, 520, 3), dtype=np.uint8)
    planes = [np.ascontiguousarray(rgb[..., c]) for c in range(3)]
    marker, luma = kernels.classify_luma_planes(*(torch.from_numpy(p) for p in planes))
    marker = marker.numpy().astype(bool)
    luma = luma.numpy()

    marker_j = np.asarray(jhsv.is_any_map_marker_color_planes(*(jnp.asarray(p) for p in planes)))
    luma_j = np.asarray(jhsv.luma8_planes(*(jnp.asarray(p) for p in planes)))
    marker_p, luma_p = classify_luma_pallas_planes(*(jnp.asarray(p) for p in planes), interpret=True)
    for m_ref, l_ref in ((marker_j, luma_j), (np.asarray(marker_p).astype(bool), np.asarray(luma_p))):
        assert (marker == m_ref).mean() > 0.9999
        assert (luma == l_ref).mean() > 0.9999
        assert (np.abs(luma.astype(int) - l_ref.astype(int)) <= 1).all()
    np.testing.assert_array_equal(marker, pixmath.is_any_map_marker_color(rgb))
    np.testing.assert_array_equal(luma, pixmath.luma8(rgb))


# -- the CUDA kernels' order of operations (csrc/classify.cuh), restated ------

F32 = np.float32
_COLOURS = (C.ALPHA_MARKER_COLOR_HSV, C.BRAVO_MARKER_COLOR_HSV, C.CHARLIE_MARKER_COLOR_HSV)
# The tables: k / 255 (numpy's f32 division is correctly rounded, as
# __fdiv_rn is), and bit c of _VIB[max byte], _SAT[(int)s] and _HUE[(int)h]
# for colour c's value, saturation (with min_sat) and hue tests.
_UNIT = np.arange(256, dtype=F32) / F32(255)
_VI = (F32(100) * _UNIT).astype(np.int32)
_K = np.arange(361)
_VIB = np.zeros(256, dtype=np.uint8)
_SAT = np.zeros(101, dtype=np.uint8)
_HUE = np.zeros(361, dtype=np.uint8)
for _c, (_h, _s, _v) in enumerate(_COLOURS):
    _VIB |= (np.abs(_VI - _v) <= C.FIND_MARKER_HSV_VIB_TOLERANCE).astype(np.uint8) << _c
    _sat_ok = (np.abs(_K[:101] - _s) <= C.FIND_MARKER_HSV_SAT_TOLERANCE) | (
        np.abs(_K[:101] - (_s - C.FIND_MARKER_PLAYER_DIR_ARC_SAT)) <= C.FIND_MARKER_HSV_SAT_TOLERANCE
    )
    _SAT |= (_sat_ok & (_K[:101] >= C.FIND_MARKER_HSV_MIN_SAT)).astype(np.uint8) << _c
    _HUE |= (np.abs(_K - _h) <= C.FIND_MARKER_HSV_HUE_TOLERANCE).astype(np.uint8) << _c


def _classify_restated(r8: np.ndarray, g8: np.ndarray, b8: np.ndarray) -> np.ndarray:
    """classify.cuh's predicate, step by step in f32: the integer max and
    the max-byte mask (_VIB non-zero); then, only on the pixels past it, the
    saturation division, ONE hue division on the numerator selected by max
    byte == r / == g, and the colour tests as a shared bit of the three
    tables."""
    r8, g8, b8 = (x.astype(np.int32).ravel() for x in (r8, g8, b8))
    out = np.zeros(r8.shape, dtype=bool)
    mx8 = np.maximum(r8, np.maximum(g8, b8))
    idx = np.flatnonzero(_VIB[mx8])  # the early-out: no division for the rest
    r8, g8, b8, mx8 = r8[idx], g8[idx], b8[idx], mx8[idx]
    mn8 = np.minimum(r8, np.minimum(g8, b8))
    r, g, b, mx = _UNIT[r8], _UNIT[g8], _UNIT[b8], _UNIT[mx8]
    delta = mx - _UNIT[mn8]
    s = np.where(mx8 > 0, (F32(100) * delta) / np.where(mx8 > 0, mx, F32(1)), F32(0))
    si = s.astype(np.int32)
    red = r8 == mx8
    green = ~red & (g8 == mx8)
    num = np.where(red, g - b, np.where(green, b - r, r - g))
    q = num / np.where(mx8 != mn8, delta, F32(1))  # the one hue division
    h = np.where(red, F32(60) * q, F32(60) * (q + np.where(green, F32(2), F32(4))))
    h = np.where(h < 0, h + F32(360), h)
    hi = np.where(mx8 != mn8, h.astype(np.int32), 0)
    out[idx] = (_VIB[mx8] & _SAT[si] & _HUE[hi]) != 0
    return out


def test_restated_tables_are_exact():
    """The unit table is k / 255 correctly rounded, where a reciprocal
    multiply is not (126 of the 256 bytes differ); it is strictly
    increasing, so the max byte's entry is the max of the three; the mask
    holds max bytes 179-255 with the repo's colours; and the tables are
    byte for byte the plain twin of the table kernel, in its layout."""
    assert _UNIT.dtype == np.float32 and (np.diff(_UNIT) > 0).all()
    np.testing.assert_array_equal(_UNIT, (np.arange(256, dtype=np.float64) / 255).astype(F32))
    assert int((np.arange(256, dtype=F32) * F32(1 / 255) != _UNIT).sum()) == 126
    assert np.flatnonzero(_VIB).tolist() == list(range(179, 256))
    plain = kernels.classify_tables_plain()
    assert plain.dtype == np.uint8 and plain.size == 1760 and plain.size % 16 == 0
    np.testing.assert_array_equal(plain[:1024].view(np.float32), _UNIT)
    np.testing.assert_array_equal(plain[1024:1280], _VIB)
    np.testing.assert_array_equal(plain[1280:1381], _SAT)
    np.testing.assert_array_equal(plain[1384:1745], _HUE)
    assert not plain[1381:1384].any() and not plain[1745:].any()


def test_restated_table_indices_stay_in_range():
    """(int)s and (int)h index the tables: over every (max byte, min byte)
    the saturation truncates into [0, 100]; over every 7th colour of the
    cube the hue into [0, 359] (the kernel's tables hold 361 entries)."""
    mx8, mn8 = np.meshgrid(np.arange(1, 256), np.arange(256), indexing="ij")
    ok = mn8 <= mx8
    mx, delta = _UNIT[mx8[ok]], _UNIT[mx8[ok]] - _UNIT[mn8[ok]]
    si = ((F32(100) * delta) / mx).astype(np.int32)
    assert si.min() == 0 and si.max() == 100
    planes = _cube_planes(0, 256)
    rgb = np.stack(planes, axis=-1).reshape(-1, 3)[::7]
    h, _, _ = pixmath.rgb_to_hsv_u8(rgb)
    assert h.min() == 0 and h.max() <= 359


@pytest.mark.parametrize("r_lo", [0, 64, 128, 192])
def test_restated_classify_exact_over_the_colour_cube(r_lo):
    """The kernels' order of operations equals pixmath over the whole 256^3
    cube (a quarter per case), and every marker colour passes the max-byte
    mask."""
    planes = _cube_planes(r_lo, r_lo + 64)
    want = pixmath.is_any_map_marker_color(np.stack(planes, axis=-1)).ravel()
    got = _classify_restated(*planes)
    np.testing.assert_array_equal(got, want)
    assert _VIB[np.maximum(planes[0], np.maximum(planes[1], planes[2])).ravel()[want]].all()


def test_restated_classify_against_jax_and_pallas_interpret():
    """A seeded slice with marker and near-marker colours: exact against
    smh_tpu.ops.hsv op by op; against the Pallas kernel in interpret mode
    within the FMA-flip tolerance of tests/test_pallas.py:21-26."""
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, size=(192, 256, 3), dtype=np.uint8)
    near = rng.random(rgb.shape[:2]) < 0.3
    jitter = rng.integers(-14, 15, (int(near.sum()), 3))
    base = np.array([(64, 255, 0), (192, 117, 217), (93, 232, 181)])[rng.integers(0, 3, int(near.sum()))]
    rgb[near] = np.clip(base + jitter, 0, 255).astype(np.uint8)
    planes = [np.ascontiguousarray(rgb[..., c]) for c in range(3)]
    got = _classify_restated(*planes).reshape(rgb.shape[:2])
    assert got.sum() > 1000
    marker_j = np.asarray(jhsv.is_any_map_marker_color_planes(*(jnp.asarray(p) for p in planes)))
    np.testing.assert_array_equal(got, marker_j)
    marker_p, _ = classify_luma_pallas_planes(*(jnp.asarray(p) for p in planes), interpret=True)
    assert (got == np.asarray(marker_p).astype(bool)).mean() > 0.9999
