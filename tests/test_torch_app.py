"""The port's app entry point (smh_tpu_torch.app) on the CPU: the command
line, the port's state inside smh_tpu's App, a pipelined run that
delivers an update, --debug-web and /api/debug-view against smh_tpu's App,
and the flag that is not ported yet."""

import io
import time

import numpy as np
import pytest
import torch
from PIL import Image

from smh_tpu import app as smh_app
from smh_tpu import native
from smh_tpu.ocr.smhocr import SmhOcrEngine
from smh_tpu.settings import Settings
from smh_tpu.squadex.capture import Frame, StaticSource
from smh_tpu.vision.reference import DebugView
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


@pytest.mark.parametrize("flag", ["--worker"])
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


def _hw_settings():
    s = Settings(path=None)
    s.set("hardware_acceleration", True, save=False)
    return s


@pytest.mark.skipif(not native.available(), reason="the native host module did not build")
def test_debug_view_endpoint_answers_as_the_jax_app():
    """/api/debug-view is served whenever the web server runs: after one
    processed frame, every view answers with the JAX App's status, and the
    PNGs decode to the same pixels (LSD_INPUT among them); views whose
    intermediates this frame did not keep answer 404 on both."""
    frame = testing.make_frame(
        640, 480, marker_lines=[((40, 50), (200, 160))],
        scale_texts=[("300m", (20, 60))], scale_bars=[(20, 90, 60, 1)],
    )
    port = tapp.App(StaticSource(frame, dpi=96), settings=_hw_settings(), device="cpu",
                    serve=False, ocr_engine=SmhOcrEngine())
    ref = smh_app.App(StaticSource(frame, dpi=96), settings=_hw_settings(), serve=False,
                      ocr_engine=SmhOcrEngine())
    try:
        for app in (port, ref):
            assert app.state.process(Frame(frame, 96)) is not None
        assert port.state.delegate.backend.name == "cuda" and ref.state.delegate.backend.name == "tpu"
        statuses = {}
        for view in DebugView:
            got = port._api("/api/debug-view", {"choice": view.name})
            want = ref._api("/api/debug-view", {"choice": view.name})
            assert got[0] == want[0], view
            statuses[view.name] = got[0]
            if got[0] == 200:
                assert got[1][0] == want[1][0] == "image/png"
                np.testing.assert_array_equal(
                    np.asarray(Image.open(io.BytesIO(got[1][1]))),
                    np.asarray(Image.open(io.BytesIO(want[1][1]))),
                )
            else:
                assert set(got[1]) == set(want[1]) == {"error"}
        assert statuses["LSD_INPUT"] == 200 and statuses["LSD_PREPROCESS"] == 404
        assert port._api("/api/debug-view", {"choice": "NOPE"})[0] == 400
    finally:
        port.state.close()
        ref.state.close()


def test_debug_web_builds_the_state_as_the_jax_app():
    """--debug-web collects the debug overlays and joins the scales branch
    every frame (smh_tpu's App), and the CLI flag reaches the App."""
    source = StaticSource(testing.make_frame(640, 480))
    app = tapp.App(source, device="cpu", serve=False, ocr_engine=SmhOcrEngine(),
                   scales_async=True, debug_web=True)
    ref = smh_app.App(source, serve=False, ocr_engine=SmhOcrEngine(), scales_async=True, debug_web=True)
    try:
        assert isinstance(app.state, tpipeline.VisionState) and app.debug_web
        for a in (app, ref):
            assert a.state.collect_debug_overlays and not a.state.scales_async
    finally:
        app.state.close()
        ref.state.close()
    assert tapp.build_parser().parse_args(["--synthetic", "--debug-web"]).debug_web
    assert "debug_web" not in tapp.NOT_PORTED
