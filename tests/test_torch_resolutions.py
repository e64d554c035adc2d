"""One port VisionState (device="cpu": the kernels' plain versions) against
one smh_tpu VisionState (TpuBackend on JAX's CPU) through every screen size
of testing.RESOLUTIONS (chip_smoke.py's resolutions phase), resizing
mid-stream: markers, ratio, minimap and hostpack bytes equal at each size,
and each size reads its marker line and its "300m" scale. The map shapes
leave ragged tiles at the fused mask's and the quiet walk's tile edges, and
three have H * W = 2 (mod 4)."""

import dataclasses

import numpy as np
import pytest
import torch

from smh_tpu.ocr.smhocr import SmhOcrEngine as JSmhOcrEngine
from smh_tpu.settings import Settings as JSettings
from smh_tpu.squadex.capture import Frame as JFrame
from smh_tpu.vision import pipeline as jpipeline
from smh_tpu_torch import consts as C
from smh_tpu_torch.ocr.smhocr import SmhOcrEngine
from smh_tpu_torch.settings import Settings
from smh_tpu_torch.squadex.capture import Frame
from smh_tpu_torch.testing import RESOLUTIONS, resolution_frame
from smh_tpu_torch.vision import pipeline as tpipeline
from test_torch_reference import _reference_native  # noqa: F401  (module-scoped autouse fixture)

torch.set_num_threads(1)


def _settings(cls):
    s = cls(path=None)
    s.set("hardware_acceleration", True, save=False)
    return s


def test_the_sizes_cover_the_kernels_edges():
    shapes = [(g.map_h, g.map_w) for g in (C.map_geometry(w, h) for w, h in RESOLUTIONS)]
    assert sorted({w % 128 for _, w in shapes}) == [10, 18, 34, 54, 62, 90, 104]
    assert sum(h * w % 4 == 2 for h, w in shapes) == 3 and len(set(shapes)) == 7


def test_one_state_matches_smh_tpu_through_every_resolution(monkeypatch):
    # Full uploads on the JAX side (its delta path compiles a bucket per
    # changed-chunk count); each size change is a full upload anyway.
    monkeypatch.setenv("SMH_DELTA", "0")
    port = tpipeline.VisionState(settings=_settings(Settings), ocr_engine=SmhOcrEngine(), device="cpu")
    ref = jpipeline.VisionState(settings=_settings(JSettings), ocr_engine=JSmhOcrEngine())
    seen = []
    try:
        for w, h in RESOLUTIONS:
            frame = resolution_frame(w, h)
            rp = port.process(Frame(frame, 96))
            rr = ref.process(JFrame(frame, 96))
            bp, br = port.delegate.backend, ref.delegate.backend
            assert bp.name == "cuda" and br.name == "tpu"
            lines = [(l.p0.x, l.p0.y, l.p1.x, l.p1.y) for l in rp.markers]
            assert lines == [(l.p0.x, l.p0.y, l.p1.x, l.p1.y) for l in rr.markers], (w, h)
            assert rp.meters_to_px_ratio == rr.meters_to_px_ratio == pytest.approx(300 / 118), (w, h)
            assert dataclasses.astuple(rp.minimap_bounds) == dataclasses.astuple(rr.minimap_bounds), (w, h)
            np.testing.assert_array_equal(bp._results["hostpack"].numpy(), np.asarray(br._results["hostpack"]))
            assert (bp.geom.map_w, bp.geom.map_h) == (C.map_geometry(w, h).map_w, C.map_geometry(w, h).map_h)
            seen.append(len(lines))
    finally:
        port.close()
        ref.close()
    assert seen == [1] * len(RESOLUTIONS)
