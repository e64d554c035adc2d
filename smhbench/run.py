"""Run one cell of the benchmark once and print its result line.

    python3 smhbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the CUDA cards the cell asks
for. The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), `device`, with --trace 1 `breakdown`, and
last `checks`, each number compared beside its limit; the same numbers end
standard error. Exits non-zero, printing no result, where smh_tpu_torch is
absent, where no CUDA card (or too few) is present, and where JAX or the
JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read: {e}"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import importlib.util

    from smhbench import harness

    if importlib.util.find_spec("smh_tpu_torch") is None:
        print("smhbench: smh_tpu_torch, the program it measures, is not in this checkout", file=sys.stderr)
        return 2
    bench = harness.benchmark()
    wl = harness.cell(bench, args.workload)
    harness.apply_environment(harness.config(wl["config"]))

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"smhbench: {args.workload} needs {wl['chips']} CUDA card(s); this machine has {n}", file=sys.stderr)
        return 2
    out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), device="cuda:0", t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"smhbench: the run loaded {bad}: the benchmark measures smh_tpu_torch alone", file=sys.stderr)
        return 3
    out["device"]["count"] = wl["chips"]
    out["device"]["card"] = power_limit()
    numbers, errors, diag = out.pop("_numbers"), out.pop("_errors"), out.pop("_diag")
    print(f"smhbench: {args.workload} seed {args.seed}: answers per second of the window, the traffic's drawing (s), the host's cores {json.dumps(diag)}", file=sys.stderr)
    print(f"smhbench: {args.workload} seed {args.seed}: numbers {json.dumps(numbers)}; first frame errors "
          f"{errors}", file=sys.stderr)
    checks = out.pop("checks")
    out["checks"] = checks
    print(json.dumps(out), flush=True)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
