"""Offline gameplay-recording analysis: video -> per-frame detections JSONL.

The batched counterpart of the live loop (VideoSource -> vision/batch.py):
decodes a recording, runs B frames per batched pass on the device, and
prints one JSON line per analyzed frame with markers / minimap / scale
ratio. The throughput-mode answer to the reference's live-only design.

Usage:
  python -m smh_tpu_torch.tools.analyze_video clip.mp4 [--batch 8] [--step 3]
      [--limit N] [--ocr auto|none] [--device cuda|cuda:N|cpu] [--trace-out PATH]

Decoding needs OpenCV (the cv2 module): without it the tool exits with
status 2 and says so. `analyze` takes any iterator of BGRA frames.
--trace-out writes the run's spans (the batch's submit, pack, diff, queue
waits, fetch wait and host stages) as Chrome trace-event JSON at the end.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Iterable


def row(frame: int, r) -> dict:
    """One analyzed frame's JSON row."""
    return {
        "frame": frame,
        "sleeping": r.sleeping,
        "markers": [[[l.p0.x, l.p0.y], [l.p1.x, l.p1.y]] for l in r.markers],
        "meters_to_px_ratio": r.meters_to_px_ratio,
        "minimap": None
        if r.minimap_bounds is None
        else [r.minimap_bounds.left, r.minimap_bounds.top,
              r.minimap_bounds.right, r.minimap_bounds.bottom],
    }


def print_row(out: dict) -> None:
    print(json.dumps(out), flush=True)


def analyze(frames: Iterable, batch: int = 8, ocr_engine=None, device="cuda", limit: int = 0,
            emit: Callable[[dict], None] = print_row) -> int:
    """Run BatchPipeline.stream over BGRA `frames` (all of one size), B at a
    time, calling emit(row) for each analyzed frame in order; stop after
    `limit` frames when it is > 0. -> the number of frames analyzed (0 when
    `frames` is empty)."""
    from ..vision.batch import BatchPipeline

    frames = iter(frames)
    n = 0
    emitted = 0
    try:
        first = next(frames)
    except StopIteration:
        return 0
    h, w = first.shape[:2]
    bp = BatchPipeline(w, h, batch=batch, ocr_engine=ocr_engine, device=device)

    def batches():
        """Decode into batch-sized groups. Runs on stream()'s submitter
        thread, so decode + pack + diff of batch N+1 overlap the collect
        (fetch + host stages) of batch N on the main thread."""
        nonlocal n
        pending = [first]
        n = 1
        for img in frames:
            if limit and n >= limit:
                break
            pending.append(img)
            n += 1
            if len(pending) == batch:
                yield pending
                pending = []
        if pending:
            yield pending

    try:
        for results in bp.stream(batches()):
            for r in results:
                emit(row(emitted, r))
                emitted += 1
    finally:
        bp.close()
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("video")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--step", type=int, default=1, help="analyze every Nth frame")
    ap.add_argument("--limit", type=int, default=0, help="stop after N analyzed frames")
    ap.add_argument("--ocr", choices=["auto", "none"], default="auto")
    ap.add_argument("--device", default="cuda", help='"cuda", "cuda:N" or "cpu" (the plain versions)')
    ap.add_argument("--trace-out", metavar="PATH", help="write the run's spans as Chrome trace-event JSON")
    args = ap.parse_args(argv)

    from .. import resolve_device
    from ..ocr import tesseract
    from ..squadex.capture import VideoSource

    device = resolve_device(args.device)
    try:
        src = VideoSource(args.video, step=args.step)
    except ImportError as e:
        print(f"analyze_video: decoding a recording needs OpenCV (the cv2 module): {e}", file=sys.stderr)
        return 2
    engine = tesseract.create_default_engine() if args.ocr == "auto" else None

    t0 = time.time()
    try:
        n = analyze(src.iter_frames(), args.batch, engine, device, args.limit)
    finally:
        src.close()
    if n == 0:
        print("no frames decoded", file=sys.stderr)
        return 1
    dt = time.time() - t0
    print(f"analyzed {n} frames in {dt:.1f}s ({n/max(dt,1e-9):.1f} fps)", file=sys.stderr)
    if args.trace_out:
        from ..utils.timeshares import write_chrome_trace

        print(f"wrote {write_chrome_trace(args.trace_out)} spans to {args.trace_out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
