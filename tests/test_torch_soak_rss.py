"""The worker child's host memory by stage on the CPU: the port's, from
`python -m smh_tpu_torch.tools.soak_worker --rss-stages` (a fresh child
through smh_tpu_torch.worker._serve's start, frame by frame from the shared
ring), and the JAX worker child's start as smh_tpu.worker._serve makes it,
up to its VisionState (its first frame compiles the fused pass for minutes
on the CPU). Each prints its report as one JSON line (pytest -s)."""

import json
import os
import subprocess
import sys

from smh_tpu_torch.tools import soak_worker

# smh_tpu.worker._serve's start, stage by stage: RSS, anonymous,
# file-backed and shared memory (MB) after each.
_JAX_CHILD = """import json
def rss():
    with open("/proc/self/status") as f:
        kb = dict(l.split(":", 1) for l in f)
    return [round(int(kb[k].split()[0]) / 1024.0, 1) for k in ("VmRSS", "RssAnon", "RssFile", "RssShmem")]
stages = [["python", *rss()]]
import jax
stages.append(["import jax", *rss()])
jax.devices()
stages.append(["JAX backend (CPU)", *rss()])
from smh_tpu import consts
from smh_tpu.ocr.smhocr import SmhOcrEngine
from smh_tpu.settings import Settings
from smh_tpu.vision.pipeline import VisionState
stages.append(["import smh_tpu", *rss()])
settings = Settings(path=None)
settings.set("hardware_acceleration", True, save=False)
state = VisionState(settings=settings, ocr_engine=SmhOcrEngine(), scales_async=True)
stages.append(["VisionState", *rss()])
print(json.dumps({"stages": stages}))
"""


def _increasing_from_python(stages) -> bool:
    return stages[0][0] == "python" and all(s[1] > 0 for s in stages) and stages[1][1] > stages[0][1]


def test_rss_stages_cover_the_port_worker_childs_start():
    report = soak_worker.rss_stages("cpu", "1080p", frames=4)
    print(json.dumps(report))
    names = [stage[0] for stage in report["stages"]]
    assert all(len(stage) == 5 and stage[1] >= stage[2] for stage in report["stages"])  # RSS, anon, file, shmem
    assert names[:3] == ["python", "import torch", "import smh_tpu_torch"]
    for stage in ("native module", "VisionState", "frame ring", "first frame", "4 frames", "6 frames"):
        assert any(name.startswith(stage) for name in names), stage
    assert "CUDA context" not in names and report["pinned_mb"] is None  # the CPU: no context, no pinned pool
    assert _increasing_from_python(report["stages"])
    assert report["growth_mb_per_frame"] == report["growth_mb_per_frame"]  # a number


def test_rss_stages_of_the_jax_worker_childs_start():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", _JAX_CHILD], capture_output=True, text=True, timeout=600, env=env,
                          cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    print(json.dumps(report))
    assert [stage[0] for stage in report["stages"]] == [
        "python", "import jax", "JAX backend (CPU)", "import smh_tpu", "VisionState"]
    assert _increasing_from_python(report["stages"])
