"""The port's plain classify + luma (ops/hsv.py, the CPU twin of the
classify_luma CUDA kernel) against the numpy oracle and the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smh_tpu.ops import hsv as jhsv
from smh_tpu.ops.pallas_kernels import classify_luma_pallas_planes
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
