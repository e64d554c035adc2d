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
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time


def rss_mb(pid: int) -> float:
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=10.0)
    ap.add_argument("--res", default="4k", choices=["4k", "1080p"])
    ap.add_argument("--recycle-mb", type=float, default=192.0,
                    help="worker upload budget; small enough that a soak "
                         "sees several recycles")
    ap.add_argument("--device", default="cuda", help='"cuda", "cuda:N" or "cpu" (the plain versions)')
    args = ap.parse_args(argv)

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
