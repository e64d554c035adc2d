"""The PyTorch port imports no JAX, builds its kernels for sm_90a, and never
picks a device behind the caller's back."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "smh_tpu_torch"

# smh_tpu modules that import jax at module level (directly or through them).
# smh_tpu.app is not one of them: only its main() imports jax (for the
# compile cache), and the port reuses its App class
# (test_app_import_leaves_jax_out checks it).
JAX_MODULES = (
    "jax", "jaxlib", "smh_tpu.ops", "smh_tpu.vision.tpu_backend",
    "smh_tpu.vision.batch", "smh_tpu.jax_cache", "smh_tpu.parallel",
    "smh_tpu.worker",
)


def _port_sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_import_leaves_jax_out_in_a_subprocess():
    """tests/conftest.py imports jax into this process, so the check runs in
    a fresh interpreter: every module of the port, then sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import smh_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(smh_tpu_torch.__path__, 'smh_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 10 or 'smh_tpu_torch.ops.lsd' not in names else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_app_import_leaves_jax_out():
    """The app module, smh_tpu's App it builds on, and the CLI's argument
    parsing import no JAX (smh_tpu.app.main would, the port's main does not)."""
    code = (
        "import sys\n"
        "import smh_tpu_torch.app as a\n"
        "a.build_parser().parse_args(['--synthetic', '--pipelined', '--no-web'])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "print(bad)\n"
        "sys.exit(1 if bad or 'smh_tpu.app' not in sys.modules else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert not name.startswith(JAX_MODULES), f"{path.name} imports {name}"


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
