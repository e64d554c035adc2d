"""The golden screenshot corpus through the CUDA backend: crash soak +
detection audit against the goldens.

    python -m smh_tpu_torch.tools.soak_corpus [--goldens detections.json]
        [--samples DIR] [--device cuda|cuda:N|cpu]

--goldens defaults to tests/goldens/detections.json of this checkout;
--samples (the reference's vision-common/samples) has no default. Prints
one line per sample and "TOTAL MISMATCHES: N"; exits 1 on a mismatch, and
2 without a sample to check (no --samples, a missing directory or a
missing file) rather than reporting a pass over nothing.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
GOLDENS = REPO / "tests" / "goldens" / "detections.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the golden corpus through CudaBackend")
    ap.add_argument("--goldens", type=pathlib.Path, default=GOLDENS)
    ap.add_argument("--samples", type=pathlib.Path, help="the screenshots the goldens name")
    ap.add_argument("--device", default="cuda", help='"cuda", "cuda:N" or "cpu" (the plain versions)')
    args = ap.parse_args(argv)

    from ..squadex.capture import load_frame_bgra
    from ..vision.cuda_backend import CudaBackend

    be = CudaBackend(args.device)
    goldens = json.loads(args.goldens.read_text())
    samples = args.samples
    if samples is None:
        print("soak_corpus: no --samples DIR given; nothing checked", file=sys.stderr)
        return 2
    missing = sorted(name for name in goldens if not (samples / name).is_file())
    if not goldens or missing:
        print(f"soak_corpus: {len(missing)} of {len(goldens)} samples missing under {samples} "
              f"({', '.join(missing[:3])}{', ...' if len(missing) > 3 else ''}); nothing checked",
              file=sys.stderr)
        return 2
    bad = 0
    for name, g in sorted(goldens.items()):
        frame = load_frame_bgra(str(samples / name))
        be.load_frame(frame)
        c = be.crop_to_map(True)
        if g["sleeping"]:
            status = "OK" if c is None else "MISMATCH(sleep)"
            if c is not None: bad += 1
            print(f"{name}: sleeping {status}")
            continue
        if c is None:
            print(f"{name}: MISMATCH (cuda sleeping, golden not)"); bad += 1; continue
        lines = be.find_marker_lines(15)
        exp = g["lines"]
        ok = len(lines) == len(exp) and all(
            abs(l.p1.x - e[2]) <= 1.5 and abs(l.p1.y - e[3]) <= 1.5 for l, e in zip(lines, exp)
        )
        if not ok: bad += 1
        print(f"{name}: {len(lines)}/{len(exp)} lines {'OK' if ok else 'MISMATCH'}")
    print("TOTAL MISMATCHES:", bad)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
