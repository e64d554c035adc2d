"""The port's app entry point (smh_tpu_torch.app) on the CPU: the command
line, the port's state inside smh_tpu's App, a pipelined run that
delivers an update, and the flags that are not ported yet."""

import time

import pytest
import torch

from smh_tpu import native
from smh_tpu.ocr.smhocr import SmhOcrEngine
from smh_tpu.settings import Settings
from smh_tpu.squadex.capture import StaticSource
from smh_tpu_torch import app as tapp
from smh_tpu_torch import testing
from smh_tpu_torch.vision import pipeline as tpipeline

torch.set_num_threads(1)


def test_parser_mirrors_the_jax_app_without_warmup():
    args = tapp.build_parser().parse_args(["--synthetic", "--pipelined", "--no-web"])
    assert args.synthetic and args.pipelined and args.no_web
    assert args.device == "cuda" and args.backend is None and not args.sync_scales
    args = tapp.build_parser().parse_args(["--backend", "numpy", "--device", "cuda:1", "--sync-scales"])
    assert (args.backend, args.device, args.sync_scales) == ("numpy", "cuda:1", True)
    for bad in (["--backend", "tpu"], ["--warmup"], ["--synthetic", "--image", "x.png"]):
        with pytest.raises(SystemExit):
            tapp.build_parser().parse_args(bad)


@pytest.mark.parametrize("flag", ["--worker", "--debug-web"])
def test_flags_not_ported_exit_with_a_message(flag, capsys):
    with pytest.raises(SystemExit) as exc:
        tapp.main(["--synthetic", "--no-web", flag])
    assert "not ported" in str(exc.value.code)
    with pytest.raises(NotImplementedError, match="not ported"):
        tapp.App(StaticSource(testing.make_frame(640, 480)), serve=False, device="cpu",
                 **{flag[2:].replace("-", "_"): True})


def test_cuda_asked_for_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    s = Settings(path=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapp.App(StaticSource(testing.make_frame(640, 480)), settings=s, serve=False,
                 ocr_engine=SmhOcrEngine())


@pytest.mark.skipif(not native.available(), reason="the native host module did not build")
def test_pipelined_app_on_cpu_delivers_an_update():
    frame = testing.make_frame(
        1280, 720, marker_lines=[((120, 150), (380, 320))],
        scale_texts=[("300m", (60, 170))], scale_bars=[(60, 200, 120, 1)],
    )
    s = Settings(path=None)
    s.set("hardware_acceleration", True, save=False)
    app = tapp.App(
        StaticSource(frame, dpi=96), settings=s, device="cpu", serve=False,
        pipelined=True, scales_async=True, ocr_engine=SmhOcrEngine(),
    )
    assert isinstance(app.state, tpipeline.VisionState) and app.loop.state is app.state
    assert app.loop.pipelined and app.state.scales_async
    updates = []
    deliver = app.loop.on_update
    app.loop.on_update = lambda r, d: (updates.append(r), deliver(r, d))
    app.start()
    try:
        deadline = time.time() + 60
        while not updates and time.time() < deadline:
            time.sleep(0.02)
    finally:
        app.stop()
    assert updates, "no update within 60 s"
    res = updates[0]
    assert res is not None and len(res.markers) == 1
    assert res.meters_to_px_ratio == pytest.approx(300 / 118)
    be = app.state.delegate.backend
    assert be.name == "cuda" and be.device.type == "cpu"
    status, body = app._api("/api/status", {})
    assert status == 200 and body["backend"] == "cuda"
