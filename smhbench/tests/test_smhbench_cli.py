"""The command exits non-zero and prints no result where it cannot measure:
without the program beside it, and without a CUDA card."""

import shutil
import subprocess
import sys

from smhbench import harness
from smhbench.profile import _short

ARGS = ["--workload", "smhocr-4k.drag", "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"]


def _run(cwd) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "smhbench/run.py", *ARGS], cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_a_directory_with_only_the_benchmark_gives_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "smhbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == "", out.stderr
    assert "smh_tpu_torch" in out.stderr


def test_no_card_gives_no_result(cuda_absent):
    out = _run(harness.ROOT)
    assert out.returncode != 0 and out.stdout == "", out.stderr
    assert "CUDA card" in out.stderr


def test_kernel_names_come_out_of_demangled_signatures():
    assert _short("void (anonymous namespace)::ocr_band_kernel<true, (Inline)1>(unsigned char const*, long)") == \
        "ocr_band_kernel"
    assert _short("(anonymous namespace)::quiet_walk_kernel(unsigned char const*, int*)") == "quiet_walk_kernel"
    assert _short("Memcpy HtoD (Pinned -> Device)") == "Memcpy HtoD (Pinned -> Device)"
