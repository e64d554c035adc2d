"""The PyTorch port imports no JAX and nothing of the JAX package smh_tpu
(not even its jax-free host modules: the port has its own copies), builds
its kernels for sm_90a, and never picks a device behind the caller's back."""

import ast
import pathlib
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "smh_tpu_torch"

# Top-level packages the port must never import.
FORBIDDEN = ("jax", "jaxlib", "smh_tpu")


def _leaked(modules) -> list:
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def _run_and_list_modules(code: str) -> tuple[list, str]:
    """Run `code` in a fresh interpreter (tests/conftest.py has imported jax
    and smh_tpu into this one) -> (its sys.modules at exit, its output)."""
    code += "\nprint('MODULES', ' '.join(sorted(sys.modules)))\n"
    proc = subprocess.run(
        [sys.executable, "-c", "import sys\n" + code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = next(x for x in proc.stdout.splitlines() if x.startswith("MODULES "))
    return line.split()[1:], proc.stdout


def _port_sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_import_leaves_jax_out_in_a_subprocess():
    """Every module of the port, then chip_smoke: neither jax nor any module
    of smh_tpu is loaded."""
    modules, out = _run_and_list_modules(
        "import importlib, pkgutil\n"
        "import smh_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(smh_tpu_torch.__path__, 'smh_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
    )
    assert not _leaked(modules), _leaked(modules)
    for name in ("smh_tpu_torch.native", "smh_tpu_torch.vision.reference", "smh_tpu_torch.app",
                 "smh_tpu_torch.ops.lsd", "smh_tpu_torch.web.server", "chip_smoke"):
        assert name in modules, name


def test_app_import_leaves_jax_out():
    """The app, its App (built on the CPU with the numpy oracle) and the
    CLI's synthetic source import neither JAX nor smh_tpu."""
    modules, _ = _run_and_list_modules(
        "import smh_tpu_torch.app as a\n"
        "from smh_tpu_torch.settings import Settings\n"
        "args = a.build_parser().parse_args(['--synthetic', '--backend', 'numpy', '--device', 'cpu', '--no-web'])\n"
        "s = Settings(path=None)\n"
        "s.set('hardware_acceleration', False, save=False)\n"
        "app = a.App(a._build_source(args), settings=s, device=args.device, serve=False)\n"
        "app.state.close()\n"
    )
    assert not _leaked(modules), _leaked(modules)
    assert "smh_tpu_torch.app" in modules and "smh_tpu_torch.testing" in modules


def test_app_cli_runs_without_smh_tpu(tmp_path):
    """`python -m smh_tpu_torch.app --synthetic --backend numpy --device cpu
    --no-web` starts, processes frames and stops on SIGINT; `-X importtime`
    lists every module it imported, and none is of jax or smh_tpu."""
    proc = subprocess.Popen(
        [sys.executable, "-X", "importtime", "-m", "smh_tpu_torch.app", "--synthetic", "--backend", "numpy",
         "--device", "cpu", "--no-web", "--settings", str(tmp_path / "settings.json")],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
    )
    lines: list[str] = []
    running = threading.Event()

    def read():
        for line in proc.stderr:
            lines.append(line)
            if "running on cpu" in line:
                running.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        assert running.wait(90), "".join(lines[-20:])
        time.sleep(2.0)  # a few oracle frames
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=60)
        reader.join(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    err = "".join(lines)
    assert proc.returncode == 0, err[-3000:]
    imported = [line.split("|")[-1].strip() for line in err.splitlines() if line.startswith("import time:")]
    assert "smh_tpu_torch.vision.reference" in imported and "smh_tpu_torch.vision.pipeline" in imported
    assert not _leaked(imported), _leaked(imported)


def test_worker_child_imports_neither_jax_nor_smh_tpu():
    """The child WorkerClient spawns (`python -m smh_tpu_torch.worker`, on
    the CPU here) warms up and reports ready; `-X importtime` (through
    PYTHONPROFILEIMPORTTIME) lists every module it imported into its stderr
    log, and none is of jax or smh_tpu."""
    from smh_tpu_torch.worker import WorkerClient

    wc = WorkerClient(640, 360, lambda msg: None, env={"PYTHONPROFILEIMPORTTIME": "1"}, device="cpu")
    try:
        assert wc.wait_ready_progress(idle_timeout=60, max_s=120), wc.diagnose()
        err = pathlib.Path(wc._stderr_path).read_text()
    finally:
        wc.close()
    imported = [line.split("|")[-1].strip() for line in err.splitlines() if line.startswith("import time:")]
    assert "smh_tpu_torch.vision.pipeline" in imported and "smh_tpu_torch.ocr.smhocr" in imported
    assert not _leaked(imported), _leaked(imported)


def test_tools_import_neither_jax_nor_the_repos_tools(tmp_path):
    """Every module of smh_tpu_torch.tools, then compare_backends,
    render_detections and analyze_video's frame function run on the CPU in
    a fresh interpreter: no module of jax or smh_tpu, and none from the
    repo's tools/ directory, is loaded."""
    from PIL import Image

    from smh_tpu_torch import testing

    png = tmp_path / "frame.png"
    Image.fromarray(testing.make_frame(640, 360, marker_lines=[((30, 40), (220, 160))])[..., [2, 1, 0, 3]]).save(png)
    modules, out = _run_and_list_modules(
        "import importlib, pathlib, pkgutil\n"
        "import smh_tpu_torch.tools as T\n"
        "for m in pkgutil.iter_modules(T.__path__): importlib.import_module('smh_tpu_torch.tools.' + m.name)\n"
        "from smh_tpu_torch import testing\n"
        "from smh_tpu_torch.tools import analyze_video, compare_backends, render_detections\n"
        f"assert compare_backends.main([{str(png)!r}, '--device', 'cpu']) == 0\n"
        f"assert render_detections.main([{str(png)!r}, {str(tmp_path / 'out.png')!r}, '--device', 'cpu']) == 0\n"
        "frames = [testing.make_frame(640, 360, marker_lines=[((30, 40), (220, 160))])] * 2\n"
        "assert analyze_video.analyze(frames, batch=2, device='cpu', emit=lambda row: None) == 2\n"
        f"tools = pathlib.Path({str(ROOT / 'tools')!r})\n"
        "print('FROM_TOOLS', [n for n, m in list(sys.modules.items())\n"
        "      if getattr(m, '__file__', None) and pathlib.Path(m.__file__).parent == tools])\n"
    )
    assert not _leaked(modules), _leaked(modules)
    assert "FROM_TOOLS []" in out, out
    names = {p.stem for p in (PKG / "tools").glob("*.py") if p.stem != "__init__"}
    assert names == {"analyze_video", "compare_backends", "render_detections", "soak_corpus", "soak_worker",
                     "probe_cold_start"}
    assert {f"smh_tpu_torch.tools.{n}" for n in names} <= set(modules)


@pytest.mark.parametrize("path", sorted((PKG / "tools").glob("*.py")), ids=lambda p: p.name)
def test_tools_import_nothing_of_the_repos_tools_directory(path):
    """The repo's tools/*.py are scripts that drive smh_tpu; no tool of the
    port imports one of them (by its module name or through `tools`)."""
    scripts = {p.stem for p in (ROOT / "tools").glob("*.py")} | {"tools"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in scripts, f"{path.name} imports {name}"


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    """No `import jax...` or `import smh_tpu...` (nor `from` forms) in any
    module of the port or in chip_smoke.py."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path.name} imports {name}"


def test_cuda_backend_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from smh_tpu_torch.vision.cuda_backend import CudaBackend
    from smh_tpu_torch.vision.pipeline import VisionState

    with pytest.raises(RuntimeError, match="CUDA"):
        CudaBackend()
    with pytest.raises(RuntimeError, match="CUDA"):
        VisionState()
    assert CudaBackend(device="cpu").device.type == "cpu"


def test_unsupported_device_raises():
    from smh_tpu_torch import resolve_device

    with pytest.raises(ValueError):
        resolve_device("meta")


def test_build_dir_is_ignored_by_git():
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "smh_tpu_torch/build/" in ignored
