"""CudaBackend's debug views (set_debug, the debug re-pass, get_debug_view)
on the CPU against smh_tpu's TpuBackend, for each scales transport; the
isolated marker pixels (LSD_PREPROCESS) against the pixmath classify, as
the jitted XLA classify contracts the HSV math to FMA."""

import numpy as np
import pytest
import torch

from smh_tpu import consts as C, testing
from smh_tpu.vision import pixmath
from smh_tpu.vision import tpu_backend as tb
from smh_tpu.vision.reference import DebugView
from smh_tpu_torch.vision import cuda_backend as cb

torch.set_num_threads(1)

W, H = 960, 540
G = C.map_geometry(W, H)


def _frame():
    return testing.make_frame(
        W, H, marker_lines=[((60, 75), (190, 160))],
        scale_texts=[("300m", (30, 70))], scale_bars=[(30, 96, 60, 1)],
    )


# (scales_device_ok, scales_binary_ok, scales_image_derived) per engine kind
ENGINES = {
    "device_read": (True, True, True),
    "binary": (False, True, True),  # smhocr without the device read
    "gray": (False, False, True),  # Tesseract
    "fake": (False, True, False),
}


def _pair(engine: str, debug: bool, grayscale: bool = True):
    frame = _frame()
    out = []
    for be in (cb.CudaBackend(device="cpu"), tb.TpuBackend(lsd_engine="native")):
        be.scales_device_ok, be.scales_binary_ok, be.scales_image_derived = ENGINES[engine]
        be.set_debug(debug)
        be.load_frame(frame)
        assert be.crop_to_map(grayscale) is not None
        out.append(be)
    return frame, out


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_debug_views_match_tpu_backend(engine):
    frame, (port, ref) = _pair(engine, debug=True)
    assert port._dispatch_flags.band is None  # debug turns the band off
    assert port._dispatch_flags.inline == ref._dispatch_flags[6]
    for view in DebugView:
        got, want = port.get_debug_view(view), ref.get_debug_view(view)
        assert (got is None) == (want is None), view
        if got is None:
            assert view == DebugView.NONE
            continue
        assert got.dtype == np.uint8 and got.shape == want.shape and (got[..., 3] == 255).all()
        if view == DebugView.LSD_PREPROCESS:
            m = frame[G.map_y : G.map_y + G.map_h, G.map_x : G.map_x + G.map_w]
            rgb = m[..., 2::-1]
            marker = pixmath.is_any_map_marker_color(rgb)
            np.testing.assert_array_equal(got[..., :3], np.where(marker[..., None], rgb, 0))
            assert marker.any()
        else:
            np.testing.assert_array_equal(got, want, err_msg=view.name)
    assert port.stats == ref.stats


def test_views_without_debug_match_tpu_backend():
    """Debug off: the mask and scales views are served, the re-pass views
    are not — on both backends."""
    _, (port, ref) = _pair("device_read", debug=False)
    for view in DebugView:
        got, want = port.get_debug_view(view), ref.get_debug_view(view)
        assert (got is None) == (want is None), view
        if got is not None:
            np.testing.assert_array_equal(got, want)
    assert port.get_debug_view(DebugView.LSD_PREPROCESS) is None
    assert port.get_debug_view(DebugView.LSD_INPUT) is not None


def test_debug_view_on_a_consume_view_is_its_frame():
    """The debug re-pass of a consume view reads its own frame's resident
    buffer, not the next dispatch's."""
    be = cb.CudaBackend(device="cpu")
    be.scales_device_ok = True
    be.set_debug(True)
    be.load_frame(_frame())
    be.dispatch(grayscale=True)
    view = be.snapshot_job()
    other = testing.make_frame(W, H, marker_lines=[((300, 40), (310, 300))])
    be.load_frame(other)
    be.dispatch(grayscale=True)
    assert view.crop_to_map(True) is not None
    solo = cb.CudaBackend(device="cpu")
    solo.scales_device_ok = True
    solo.set_debug(True)
    solo.load_frame(_frame())
    assert solo.crop_to_map(True) is not None
    for v in (DebugView.LSD_PREPROCESS, DebugView.CROPPED_BRQ, DebugView.LSD_INPUT):
        np.testing.assert_array_equal(view.get_debug_view(v), solo.get_debug_view(v))
