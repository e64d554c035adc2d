"""The port's warmup (smh_tpu_torch/ops/warmup.py) on the CPU: it drives a
CudaBackend through the rungs of smh_tpu's warmup (sparse budgets around
the default and the probation window, or the window diagonal under
SMH_SPARSE=0; the two band rungs; the delta buckets; checksum-only scales;
the quiet pass off) and leaves the rung hysteresis virgin; and
`python -m smh_tpu_torch.app --warmup` runs it on --device before serving."""

import time

import pytest
import torch

from smh_tpu_torch import app as tapp
from smh_tpu_torch.ops import warmup as wu
from smh_tpu_torch.vision import cuda_backend as cb

torch.set_num_threads(1)

# The rung state a live session must start from (smh_tpu's warmup restores
# the same; the display caches, the per-geometry ladders and the scales
# checksum streak, which any new checksum resets, aside).
RUNG_FIELDS = (
    "rung_h", "rung_w", "shrink_streak", "sp_rung", "sp_streak", "sp_miss_streak", "sp_probation",
    "band_rung", "band_streak", "band_probation",
)


@pytest.fixture
def warmed(monkeypatch):
    """warmup's backends, each with the flags of every dispatch it made."""
    made = []

    class Recording(cb.CudaBackend):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.flags = []
            made.append(self)

        def dispatch(self, grayscale=None):
            super().dispatch(grayscale)
            self.flags.append(self._dispatch_flags)

    monkeypatch.setattr(wu, "CudaBackend", Recording)
    return made


def _virgin(be) -> None:
    fresh = cb._AdaptState()
    assert {f: getattr(be._adapt, f) for f in RUNG_FIELDS} == {f: getattr(fresh, f) for f in RUNG_FIELDS}


def test_warmup_640x360_leaves_the_rungs_virgin(warmed):
    wu.warmup(((640, 360),), device="cpu")
    (be,) = warmed
    assert be.device.type == "cpu" and be.geom.frame_w == 640
    _virgin(be)
    assert len(be.flags) >= 6 and any(not f.with_quiet for f in be.flags)  # tiny map: no sparse rungs


def test_warmup_visits_the_sparse_band_delta_and_scales_rungs(warmed, monkeypatch):
    monkeypatch.setenv("SMH_DELTA", "1")
    wu.warmup(((960, 540),), device="cpu")
    (be,) = warmed
    _virgin(be)
    flags = be.flags
    assert {f.sparse for f in flags} >= {512, 1024, 2048, None}  # rungs 1-3 and the probation window
    assert {f.inline for f in flags} == {"device", "binary", "none"}
    assert {f.band is None for f in flags} == {True, False}
    assert any(not f.with_quiet for f in flags)
    assert be.stats["delta_frames"] >= 4 and be.stats["full_uploads"] == 1


def test_warmup_walks_the_window_diagonal_without_sparse(warmed, monkeypatch):
    monkeypatch.setenv("SMH_SPARSE", "0")
    wu.warmup(((960, 540),), device="cpu")
    (be,) = warmed
    _virgin(be)
    g = be.geom
    windows = {(f.crop_h or g.map_h, f.crop_w or g.map_w) for f in be.flags}
    assert {f.sparse for f in be.flags} == {None}
    assert set(zip(cb._dim_ladder(g.map_h), cb._dim_ladder(g.map_w))) <= windows  # each rung of the diagonal


def test_warmup_on_an_absent_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        wu.warmup(((640, 360),), device="cuda")


def test_app_warmup_flag_warms_the_device_before_serving(monkeypatch, tmp_path):
    """`--synthetic --warmup --no-web --backend cuda --device cpu`: main runs
    the warmup on the device, then the App delivers its first frame."""
    calls = []
    real = wu.warmup
    monkeypatch.setattr(wu, "COMMON_RESOLUTIONS", ((640, 360),))
    monkeypatch.setattr(wu, "warmup", lambda **kw: (calls.append(kw), real(**kw)))
    monkeypatch.setattr(tapp.signal, "signal", lambda *args: None)
    served = []

    def wait(app):
        deadline = time.time() + 60
        while time.time() < deadline:
            be = app.state.delegate.backend
            if be is not None and be.stats["frames"] >= 1:
                served.append(be)
                return
            time.sleep(0.05)

    monkeypatch.setattr(tapp.App, "wait", wait)
    rc = tapp.main(["--synthetic", "--warmup", "--no-web", "--backend", "cuda", "--device", "cpu",
                    "--settings", str(tmp_path / "settings.json")])
    assert rc == 0 and calls == [{"device": "cpu"}]
    assert served and served[0].name == "cuda" and served[0].device.type == "cpu"
