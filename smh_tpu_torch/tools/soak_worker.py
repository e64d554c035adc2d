"""Recorded worker soak: bounded host RSS under the recycle guard.

The worker bounds a long-lived pipeline's host memory by RECYCLING itself
past SMH_WORKER_RECYCLE_MB of uploads; this soak drives continuous
distinct frames through the supervised worker (smh_tpu_torch.worker) for
--minutes and records the evidence:

  * worker RSS sampled every second across every incarnation (the bound),
  * restart count (the guard firing),
  * detections flowing before AND after each restart (availability).

Run on the card:  python -m smh_tpu_torch.tools.soak_worker --minutes 10
                  [--res 4k|1080p] [--recycle-mb MB] [--device cuda|cuda:N|cpu]
Output: one JSON line (suitable for checking max_worker_rss_mb stays flat
across restarts instead of compounding).

With --rss-stages it soaks nothing: a fresh child process goes through the
worker child's start as smh_tpu_torch.worker._serve does it, stage by stage
(the torch import, the CUDA context, the kernels' library and the native
module, the VisionState with its classify tables and scales templates, the
shared-memory frame ring, the first frame with its pinned staging and
hostpack buffers, then 40 more frames read from the ring), and
the tool prints one JSON line: the child's RSS (MB) after each stage,
split into anonymous, file-backed (the mapped libraries) and shared memory,
the growth per frame over the last frames, and the pinned host memory torch
holds.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time


def rss_mb(pid: int, field: str = "VmRSS") -> float:
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith(field + ":"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def rss_split(pid: int) -> list:
    """[RSS, of it anonymous, file-backed (mapped libraries) and shared
    memory] in MB, from /proc/<pid>/status; where a kernel does not split
    RSS there, /proc/<pid>/statm's resident and shared pages: [RSS, RSS -
    shared, shared, None]."""
    fields = ("VmRSS", "RssAnon", "RssFile", "RssShmem")
    try:
        with open(f"/proc/{pid}/status") as f:
            kb = dict(line.split(":", 1) for line in f if ":" in line)
        if all(k in kb for k in fields):
            return [round(int(kb[k].split()[0]) / 1024.0, 1) for k in fields]
        with open(f"/proc/{pid}/statm") as f:
            resident, shared = (int(x) * os.sysconf("SC_PAGE_SIZE") / 2**20 for x in f.read().split()[1:3])
        return [round(resident, 1), round(resident - shared, 1), round(shared, 1), None]
    except OSError:
        return [0.0, None, None, None]


def _pinned_mb() -> "float | None":
    """Pinned host memory torch's host allocator holds (MB), where this
    torch reports it."""
    import torch

    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is None or not torch.cuda.is_available():
        return None
    held = stats().get("reserved_bytes.current", stats().get("allocated_bytes.current"))
    return None if held is None else held / 2**20


def _stages_child(device: str, res: str, frames: int, stages: list) -> dict:
    """The worker child's start, stage by stage, in this process, after the
    stages already in `stages` ([name, RSS, anonymous, file-backed, shared
    memory], MB): the same after each stage. Prints nothing; returns the
    report."""
    import torch

    def mark(name: str) -> None:
        stages.append([name, *rss_split(os.getpid())])

    from .. import _build, native, testing
    from ..ocr.smhocr import SmhOcrEngine
    from ..settings import Settings
    from ..squadex.capture import Frame
    from ..vision.pipeline import VisionState
    from ..worker import N_SLOTS, FrameRing

    mark("import smh_tpu_torch")
    if device.startswith("cuda"):
        torch.cuda.init()
        torch.zeros(8, dtype=torch.uint8).to(device).cpu()
        mark("CUDA context")
        _build.load()
        mark("kernels' library")
    native.load()
    mark("native module")
    settings = Settings(path=None)
    settings.set("hardware_acceleration", True, save=False)
    state = VisionState(settings=settings, ocr_engine=SmhOcrEngine(), scales_async=True, device=device)
    mark("VisionState (classify tables, scales templates)")
    w, h = (3840, 2160) if res == "4k" else (1920, 1080)
    video = testing.make_video_frames(w, h, 16)
    mark("16 frames in this process (the soak's, not the worker's)")
    ring = FrameRing(f"smh-rss-{os.getpid()}", w, h, create=True)
    try:
        mark(f"frame ring ({N_SLOTS + 1} slots, {(N_SLOTS + 1) * w * h * 4 / 2**20:.0f} MB shared)")

        def one(i: int) -> None:
            k = ring.try_publish(video[i % len(video)], i, 96)
            img, _seq, dpi = ring.view(k)
            state.process(Frame(img, dpi))
            ring.release(k)

        one(0)
        mark("first frame (pinned staging, hostpack, device buffers)")
        for i in range(1, frames):
            one(i)
        mark(f"{frames} frames")
        tail = max(frames // 2, 1)
        before = rss_mb(os.getpid())
        for i in range(frames, frames + tail):
            one(i)
        mark(f"{frames + tail} frames")
        growth = (rss_mb(os.getpid()) - before) / tail
    finally:
        ring.close(unlink=True)
    return {"res": res, "device": device, "stages": stages, "growth_mb_per_frame": round(growth, 3),
            "pinned_mb": _pinned_mb(), "torch": torch.__version__,
            "card": torch.cuda.get_device_name(0) if device.startswith("cuda") else None}


# The child: its RSS before any import of this package (which imports
# torch), after the torch import, then _stages_child.
_CHILD = """import os
def rss():  # rss_split's, before this package (which imports torch) is imported
    fields = ("VmRSS", "RssAnon", "RssFile", "RssShmem")
    with open("/proc/self/status") as f:
        kb = dict(l.split(":", 1) for l in f if ":" in l)
    if all(k in kb for k in fields):
        return [round(int(kb[k].split()[0]) / 1024.0, 1) for k in fields]
    with open("/proc/self/statm") as f:
        resident, shared = (int(x) * os.sysconf("SC_PAGE_SIZE") / 2**20 for x in f.read().split()[1:3])
    return [round(resident, 1), round(resident - shared, 1), round(shared, 1), None]
stages = [["python", *rss()]]
import json
import torch
stages.append(["import torch", *rss()])
from smh_tpu_torch.tools import soak_worker
print(json.dumps(soak_worker._stages_child({device!r}, {res!r}, {frames}, stages)))
"""


def rss_stages(device: str, res: str, frames: int = 40) -> dict:
    """The worker child's RSS by stage, from a fresh child process."""
    cmd = [sys.executable, "-c", _CHILD.format(device=device, res=res, frames=frames)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"rss stages child failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=10.0)
    ap.add_argument("--res", default="4k", choices=["4k", "1080p"])
    ap.add_argument("--recycle-mb", type=float, default=192.0,
                    help="worker upload budget; small enough that a soak "
                         "sees several recycles")
    ap.add_argument("--device", default="cuda", help='"cuda", "cuda:N" or "cpu" (the plain versions)')
    ap.add_argument("--rss-stages", action="store_true",
                    help="no soak: the worker child's RSS by stage, from a fresh child")
    args = ap.parse_args(argv)
    if args.rss_stages:
        print(json.dumps(rss_stages(args.device, args.res)))
        return

    from .. import testing
    from ..worker import WorkerClient

    w, h = (3840, 2160) if args.res == "4k" else (1920, 1080)
    frames = testing.make_video_frames(w, h, 16)

    results = {"n": 0, "markers": 0, "last_seq": 0}
    lock = threading.Lock()

    def on_result(msg):
        with lock:
            results["n"] += 1
            results["markers"] += len(msg.get("markers") or [])
            results["last_seq"] = msg["seq"]

    wc = WorkerClient(
        w, h, on_result, env={"SMH_WORKER_RECYCLE_MB": str(args.recycle_mb)}, device=args.device
    )
    out = {"res": args.res, "recycle_mb": args.recycle_mb,
           "minutes": args.minutes}
    rss_samples: list[float] = []
    client_rss: list[float] = []
    per_incarnation_max: dict[int, float] = {}
    try:
        if not wc.wait_ready(timeout=900):
            raise RuntimeError("worker never ready: " + wc.diagnose())
        t_end = time.time() + args.minutes * 60
        i = 0
        last_sample = 0.0
        while time.time() < t_end:
            # Submit at full rate (the ring applies backpressure; drops are
            # mailbox semantics); sample RSS ~1 Hz.
            wc.submit(frames[i % len(frames)])
            i += 1
            now = time.time()
            if now - last_sample >= 1.0:
                last_sample = now
                pid = wc._proc.pid if wc._proc else None
                if pid:
                    r = rss_mb(pid)
                    if r > 0:
                        rss_samples.append(r)
                        key = wc.restarts
                        per_incarnation_max[key] = max(
                            per_incarnation_max.get(key, 0.0), r
                        )
                client_rss.append(rss_mb(os.getpid()))
            time.sleep(0.01)
        with lock:
            out.update(
                frames_processed=results["n"],
                markers_total=results["markers"],
            )
        out.update(
            submitted=i,
            restarts=wc.restarts,
            max_worker_rss_mb=round(max(rss_samples), 1) if rss_samples else None,
            max_rss_per_incarnation_mb={
                k: round(v, 1) for k, v in sorted(per_incarnation_max.items())
            },
            max_client_rss_mb=round(max(client_rss), 1) if client_rss else None,
        )
    finally:
        wc.close()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
