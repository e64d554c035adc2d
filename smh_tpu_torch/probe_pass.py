"""The fused pass end to end on the card, for this checkout and, with
--against, beside another tree, in turns.

Each run is a child process whose working directory is a tree (this
checkout, or DIR), so it times that tree's code with its own kernels, on
one route (--route):

  main           smhocr's device read with the sparse mask words, over warm
                 frames of chip_smoke.frame_for's static frame;
  window-gray    SMH_SPARSE=0 (the window crop) and the gray row band (a
                 Tesseract-flagged engine: binary_ok and device_ok off);
  window-binary  SMH_SPARSE=0 and the binary row band (smhocr without the
                 device read);

the window routes over frame_for's marker with the scale legend moving
2 px a frame, so the images stay inline (each frame a delta frame). At
1080p and 4K: the sync `process()` p50, the CUDA rows of a warm sync frame
(torch.profiler: kernels, memset/copy rows, device busy), and for
`BatchPipeline(batch=8)` with the route's engine over chip_smoke's marker
drag the rows of a delta batch and `process()`'s frames/s. The runs go in
turns: this, DIR, DIR, this, and so on (--rounds pairs), on one card in one
call, so host and clock drift fall on both sides. Each child prints one
JSON line; this prints them with the card's name and power limit. Needs a
CUDA device; run from the root of a checkout:

    python -m smh_tpu_torch.probe_pass [--against DIR] [--rounds 2] [--route main|window-gray|window-binary]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

CHILD = r"""
import json, os, statistics, sys, time
import torch
route = sys.argv[1]
if route != "main":
    os.environ["SMH_SPARSE"] = "0"  # the window crop
import chip_smoke as cs
from smh_tpu_torch import testing
from smh_tpu_torch.ocr.smhocr import SmhOcrEngine
from smh_tpu_torch.squadex.capture import Frame
from smh_tpu_torch.vision.batch import BatchPipeline


class Flagged(SmhOcrEngine):
    # smhocr's reader under the route's transport flags
    binary_ok = route != "window-gray"
    device_ok = route == "main"


def frames_for(w, h):
    if route == "main":
        return [cs.frame_for(w, h)]
    k = w // 1920
    (x0, y0), (x1, y1) = cs.MARKER[0]
    return [testing.make_frame(w, h, marker_lines=[((x0 * k, y0 * k), (x1 * k, y1 * k))],
                               scale_texts=[("300m", ((60 + 2 * i) * k, 170 * k))],
                               scale_bars=[((60 + 2 * i) * k, 170 * k + 30, 120 * k, 1)]) for i in range(12)]


dev = torch.device("cuda:0")
out = {}
for w, h in cs.LIVE_SIZES:
    frames = frames_for(w, h)
    state = cs.new_state(dev, engine=Flagged())
    try:
        samples, _, _ = cs._timed(state, frames, warm=5 if route == "main" else 3 * len(frames))
        at = [0]

        def step():
            at[0] += 1
            state.process(Frame(frames[at[0] % len(frames)], 96))

        sync = cs.device_profile(step, n=len(frames) if route != "main" else 5)
        flags = state.delegate.backend._dispatch_flags
    finally:
        state.close()
    batches = cs._batches(cs.drag_frames(w, h), 8)
    bp = BatchPipeline(w, h, batch=8, ocr_engine=Flagged(), device=dev)
    try:
        for b in batches:
            bp.process(b)
        batch = cs.device_profile(lambda: bp.process(batches[1]), n=1, tries=6)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            bp.process(b)
        fps = len(batches) * 8 / (time.perf_counter() - t0)
        delta = bp.stats["delta_batches"]
    finally:
        bp.close()
    out[f"{w}x{h}"] = {
        "p50_ms": statistics.median(samples), "min_ms": min(samples), "max_ms": max(samples),
        "sync_kernels": sync["kernels"], "sync_rows": sync["launches"] - sync["kernels"],
        "sync_busy_ms": sync["us"] / 1e3,
        "batch_kernels": batch["kernels"], "batch_rows": batch["launches"] - batch["kernels"],
        "batch_busy_ms": batch["kernel_us"] / 1e3, "batch_fps": fps, "delta_batches": delta,
        "flags": [flags.inline, flags.sparse, flags.crop_h, flags.crop_w, flags.band],
    }
print("PASS " + json.dumps(out), flush=True)
"""


ROUTES = ("main", "window-gray", "window-binary")


def run(tree: pathlib.Path, route: str = "main") -> dict:
    """One child's numbers on `route`, run in `tree`."""
    proc = subprocess.run([sys.executable, "-c", CHILD, route], cwd=tree, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"probe_pass in {tree} failed:\n{proc.stderr[-3000:]}")
    return json.loads(next(l for l in proc.stdout.splitlines() if l.startswith("PASS "))[5:])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=pathlib.Path, help="a tree timed in turns with this one")
    parser.add_argument("--rounds", type=int, default=2, help="pairs of runs of each tree")
    parser.add_argument("--route", choices=ROUTES, default="main", help="the transports the pass takes")
    args = parser.parse_args(argv)
    here = pathlib.Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(here))
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_pass needs a CUDA device")
    card = cs.card_line()
    print(f"card: {card}; route {args.route}", flush=True)
    trees = {"this": here}
    if args.against is not None:
        trees["against"] = args.against.resolve()
    pair = list(trees)
    order = []
    for r in range(args.rounds):
        order += pair if r % 2 == 0 else pair[::-1]
    for name in order:
        print(f"{name}: " + json.dumps(run(trees[name], args.route)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
