"""The readings the limits of `correct` are set from, on the card.

    python3 smhbench/control.py --workload <name> --seeds 1,2,3 [--faults stale,stale_ratio,frozen,half,altered]
        [--fault-seeds 3] [--seconds 4]

In one process (the kernels built once): for each seed, a sound run of the
cell at its own size, then, on the first `--fault-seeds` seeds, a run with
each fault planted where the answers are produced (`stale`, the control:
each frame served the previous frame's answer, the guarantee every update
is of the frame the loop took broken). Prints one JSON line per run with
every number compared; the benchmark's own runs plant no fault.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

if __package__ in (None, ""):
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--faults", default="stale,stale_ratio,frozen,half,altered")
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    from smhbench import harness

    seeds = [int(s) for s in args.seeds.split(",")]
    faults = [f for f in args.faults.split(",") if f]
    for k, seed in enumerate(seeds):
        cache: dict = {}
        for fault in [None] + (faults if k < args.fault_seeds else []):
            out = harness.run(args.workload, seed, args.seconds, False, device=args.device, fault=fault,
                              ref_cache=cache)
            print(json.dumps({"workload": args.workload, "seed": seed, "fault": fault or "none",
                              "correct": out["correct"], "numbers": out["_numbers"], "attempted": out["attempted"],
                              "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                              "errors": out["_errors"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
