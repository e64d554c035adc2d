"""The port's operator entry points (smh_tpu_torch/tools/) on the CPU, each
against its counterpart in the repo's tools/ (which drives smh_tpu on JAX's
CPU) on the same inputs: analyze_video's rows, compare_backends' report
("cuda" for "tpu"), render_detections' PNG bytes. Then what only the port's
tools do: soak_corpus refuses to pass over absent samples and audits a
synthetic corpus, soak_worker sees the recycle guard fire, probe_cold_start
prints every stage, and every tool asks for the card by default."""

import importlib
import json
import logging
import pathlib
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from smh_tpu.squadex.capture import load_frame_bgra as jload_frame_bgra
from smh_tpu.vision import tpu_backend as tb
from smh_tpu.vision.reference import ReferenceBackend as JReferenceBackend
from smh_tpu_torch import testing
from smh_tpu_torch.tools import (
    analyze_video,
    compare_backends,
    probe_cold_start,
    render_detections,
    soak_corpus,
    soak_worker,
)
from test_torch_reference import _reference_native  # noqa: F401  (module-scoped autouse fixture)

torch.set_num_threads(1)

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"


def _jax_tool(name: str, argv: list, monkeypatch, capsys) -> tuple:
    """Run tools/<name>.py's main() in this process with `argv` (its JAX
    runs on the CPU, as tests/conftest.py set it) -> (exit code, stdout)."""
    monkeypatch.syspath_prepend(str(TOOLS))
    mod = importlib.import_module(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    capsys.readouterr()
    rc = mod.main()
    return rc, capsys.readouterr().out


def _port_tool(main, argv: list, capsys) -> tuple:
    capsys.readouterr()
    rc = main(argv)
    return rc, capsys.readouterr().out


def _png(path, w: int = 1280, h: int = 720, **kw) -> str:
    """A synthesized frame saved as a PNG (RGBA)."""
    kw.setdefault("marker_lines", [((120, 150), (500, 420))])
    kw.setdefault("scale_texts", [("300m", (30, 170))])
    kw.setdefault("scale_bars", [(30, 192, 120, 1)])
    Image.fromarray(testing.make_frame(w, h, **kw)[..., [2, 1, 0, 3]]).save(path)
    return str(path)


def test_analyze_video_rows_equal_the_jax_tool(tmp_path, monkeypatch, capsys):
    """An MJPG clip (as tests/test_cli.py writes it), --batch 2 --ocr none
    --limit 4: the port's rows equal tools/analyze_video.py's."""
    cv2 = pytest.importorskip("cv2")
    w, h = 1280, 720
    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (w, h))
    assert writer.isOpened()
    for i in range(5):
        bgra = testing.make_frame(w, h, marker_lines=[((100 + 5 * i, 100), (420, 300))], scale_bars=[(60, 200, 120, 1)])
        writer.write(np.ascontiguousarray(bgra[..., :3]))
    writer.release()
    args = [path, "--batch", "2", "--ocr", "none", "--limit", "4"]
    rc, out = _port_tool(analyze_video.main, args + ["--device", "cpu"], capsys)
    assert rc == 0
    rows = [json.loads(line) for line in out.strip().splitlines()]
    rc_j, out_j = _jax_tool("analyze_video", args, monkeypatch, capsys)
    assert rc_j == 0
    assert rows == [json.loads(line) for line in out_j.strip().splitlines()]
    assert len(rows) == 4 and all(not r["sleeping"] and r["markers"] for r in rows)


def test_analyze_video_without_opencv_exits_naming_it(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "cv2", None)  # `import cv2` raises ImportError
    rc = analyze_video.main([str(tmp_path / "clip.avi"), "--device", "cpu"])
    assert rc == 2
    assert "OpenCV" in capsys.readouterr().err


def test_analyze_reads_any_frame_iterator():
    """The frame function: an empty iterator analyzes nothing; frames from
    a generator come back as one row each, in order, up to the limit."""
    assert analyze_video.analyze(iter(()), device="cpu") == 0
    frames = (testing.make_frame(640, 360, marker_lines=[((30 + 5 * i, 40), (220, 160))]) for i in range(5))
    rows = []
    assert analyze_video.analyze(frames, batch=2, device="cpu", limit=3, emit=rows.append) == 3
    assert [r["frame"] for r in rows] == [0, 1, 2]
    assert all(not r["sleeping"] and len(r["markers"]) == 1 for r in rows)


def _collapse(report: str) -> list:
    return [" ".join(line.split()) for line in report.strip().splitlines()]


def test_compare_backends_report_equals_the_jax_tool(tmp_path, monkeypatch, capsys):
    """The same report lines, "cuda" for "tpu", and exit 0. The JAX tool
    reads a `_lsd_mask_host` that TpuBackend does not have (it raises
    AttributeError on any frame with a map); the test lends it TpuBackend's
    full 0/255 mask, the one the port's tool reads from CudaBackend."""
    png = _png(tmp_path / "frame.png")
    rc, out = _port_tool(compare_backends.main, [png, "--device", "cpu"], capsys)
    assert rc == 0 and out.strip().splitlines()[-1] == "RESULT: PASS"
    monkeypatch.setattr(tb.TpuBackend, "_lsd_mask_host", property(lambda be: be._full_mask_host()), raising=False)
    rc_j, out_j = _jax_tool("compare_backends", [png], monkeypatch, capsys)
    assert rc_j == 0
    assert _collapse(out) == _collapse(out_j.replace("tpu", "cuda"))


def test_compare_backends_sleeping_frame(tmp_path, capsys):
    png = _png(tmp_path / "closed.png", with_button=False)
    rc, out = _port_tool(compare_backends.main, [png, "--device", "cpu"], capsys)
    assert rc == 0 and out.strip() == "sleeping: oracle=True cuda=True"


def test_render_detections_png_equals_the_jax_tool(tmp_path, monkeypatch, capsys):
    """--backend cuda (plain versions) writes the bytes
    tools/render_detections.py writes with its TPU backend, --backend numpy
    the bytes it writes with the oracle (whose Python LSD ends this line
    within 1.5 px of the native one, so the two PNGs differ here)."""
    png = _png(tmp_path / "frame.png")
    for port, jax in (("cuda", "tpu"), ("numpy", "numpy")):
        dst, jdst = str(tmp_path / f"port_{port}.png"), str(tmp_path / f"jax_{jax}.png")
        rc, printed = _port_tool(render_detections.main, [png, dst, "--backend", port, "--device", "cpu"], capsys)
        assert rc == 0 and printed.startswith(f"1 line(s) -> {dst}")
        rc_j, printed_j = _jax_tool("render_detections", [png, jdst, "--backend", jax], monkeypatch, capsys)
        assert rc_j == 0
        assert (tmp_path / f"port_{port}.png").read_bytes() == (tmp_path / f"jax_{jax}.png").read_bytes(), port
        assert printed.splitlines()[1:] == printed_j.splitlines()[1:]


@pytest.mark.parametrize("given", [True, False], ids=["absent-dir", "no-flag"])
def test_soak_corpus_without_samples_exits_nonzero(given, tmp_path, capsys):
    """An absent directory and a missing --samples (there is no default) each
    exit 2, checking nothing."""
    rc = soak_corpus.main((["--samples", str(tmp_path / "absent")] if given else []) + ["--device", "cpu"])
    assert rc == 2
    err = capsys.readouterr().err
    assert ("26 of 26 samples missing" if given else "no --samples DIR given") in err and "nothing checked" in err


def test_soak_corpus_audits_a_synthetic_corpus(tmp_path, capsys):
    """Three screenshots (two sizes, one with the map closed) with goldens
    from smh_tpu's oracle: no mismatch, exit 0; a wrong golden line is a
    mismatch, exit 1."""
    samples = tmp_path / "samples"
    samples.mkdir()
    specs = {
        "a.png": dict(w=1280, h=720),
        "b.png": dict(w=1024, h=768, marker_lines=[((40, 100), (250, 360))]),
        "closed.png": dict(w=1280, h=720, with_button=False),
    }
    goldens = {}
    for name, kw in specs.items():
        path = _png(samples / name, **kw)
        oracle = JReferenceBackend()
        oracle.load_frame(jload_frame_bgra(path))
        if oracle.crop_to_map(True) is None:
            goldens[name] = {"sleeping": True}
            continue
        oracle.isolate_map_markers()
        oracle.mask_marker_lines()
        lines = oracle.find_marker_lines(15)
        goldens[name] = {"sleeping": False, "lines": [[l.p0.x, l.p0.y, l.p1.x, l.p1.y] for l in lines]}
    assert [g.get("lines") and len(g["lines"]) for g in goldens.values()] == [1, 1, None]
    gpath = tmp_path / "detections.json"
    gpath.write_text(json.dumps(goldens))
    args = ["--goldens", str(gpath), "--samples", str(samples), "--device", "cpu"]
    rc, out = _port_tool(soak_corpus.main, args, capsys)
    assert rc == 0, out
    assert out.strip().splitlines() == [
        "a.png: 1/1 lines OK", "b.png: 1/1 lines OK", "closed.png: sleeping OK", "TOTAL MISMATCHES: 0",
    ]
    goldens["b.png"]["lines"][0][2] += 3.0
    gpath.write_text(json.dumps(goldens))
    rc, out = _port_tool(soak_corpus.main, args, capsys)
    assert rc == 1 and "b.png: 1/1 lines MISMATCH" in out and out.strip().endswith("TOTAL MISMATCHES: 1")


def test_soak_worker_sees_the_recycle_guard_fire(capsys, caplog):
    """A 1 MB upload budget recycles the worker after its first 1080p
    frame: at least one restart, each one a recycle (the child said so
    before it exited; frames still unread on its socket do not make it a
    supervision error), results before it, RSS per incarnation."""
    caplog.set_level(logging.INFO, logger="smh_tpu_torch.worker")
    soak_worker.main(["--minutes", "0.25", "--res", "1080p", "--recycle-mb", "1", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["restarts"] >= 1, out
    said = [r.getMessage() for r in caplog.records if r.name == "smh_tpu_torch.worker"]
    assert sum(m.startswith("worker recycling after") for m in said) >= out["restarts"], said
    assert not [m for m in said if "supervision error" in m or "worker died" in m], said
    assert out["frames_processed"] >= 1 and out["markers_total"] >= 2, out
    assert "0" in out["max_rss_per_incarnation_mb"] and out["max_worker_rss_mb"] > 0, out


def test_probe_cold_start_prints_every_stage(capsys):
    probe_cold_start.main(["--res", "1080p", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("cuda_context_s", "kernel_build_s", "classify_tables_s", "first_h2d_s", "nvcc_s"):
        assert key in out and out[key] is None, key  # the CPU has no such step
    for key in ("to_main_s", "import_torch_s", "native_build_s", "build_state_s", "build_backend_s"):
        assert isinstance(out[key], float) and out[key] >= 0, key
    assert out["native_available"] is True and out["device"] == "cpu"
    for i in range(3):
        stages = out[f"frame{i}_stages_s"]
        assert out[f"frame{i}_s"] > 0 and {"load_frame", "crop_to_map", "find_marker_lines"} <= set(stages), stages
        assert abs(out[f"frame{i}_unattributed_s"]) < out[f"frame{i}_s"]


@pytest.mark.parametrize("tool", ["analyze_video", "compare_backends", "render_detections", "soak_corpus",
                                  "soak_worker", "probe_cold_start"])
def test_each_tool_asks_for_the_card_by_default(tool, tmp_path):
    """Without --device each tool runs on "cuda", so with no card it raises
    before it does any work; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    png = _png(tmp_path / "frame.png", w=640, h=360, scale_texts=[], scale_bars=[])
    argv = {
        "analyze_video": [str(tmp_path / "clip.avi")],
        "compare_backends": [png],
        "render_detections": [png, str(tmp_path / "out.png")],
        "soak_corpus": ["--samples", str(tmp_path)],
        "soak_worker": ["--res", "1080p", "--minutes", "0.01"],
        "probe_cold_start": ["--res", "1080p"],
    }[tool]
    main = importlib.import_module(f"smh_tpu_torch.tools.{tool}").main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    assert not (tmp_path / "out.png").exists()
