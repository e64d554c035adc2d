"""Render detected marker lines over a frame -> PNG (visual harness).

The counterpart of the reference's `open_image!` eyeball checks
(util/src/debug.rs:7-21, used by test_gpu_computer_vision). Usage:

    python -m smh_tpu_torch.tools.render_detections <frame.png> [out.png]
        [--backend cuda|numpy] [--device cuda|cuda:N|cpu]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="draw detected marker lines over a frame")
    ap.add_argument("frame")
    ap.add_argument("out", nargs="?", default="detections.png")
    ap.add_argument("--backend", choices=["cuda", "numpy"], default="cuda")
    ap.add_argument("--device", default="cuda", help='"cuda", "cuda:N" or "cpu" (the plain versions)')
    args = ap.parse_args(argv)
    out = args.out

    from PIL import Image

    from ..squadex.capture import load_frame_bgra
    from ..utils.plot import plot_line
    from ..vision.pipeline import make_backend

    frame = load_frame_bgra(args.frame)
    be = make_backend(args.backend, args.device)
    be.load_frame(frame)
    cropped = be.crop_to_map(grayscale=True)
    if cropped is None:
        print("sleeping (deployment map closed / no red button)")
        return 1
    ui_map, bbox = cropped
    if callable(ui_map):
        ui_map = ui_map()
    be.isolate_map_markers()
    be.mask_marker_lines()
    lines = be.find_marker_lines(15)

    img = ui_map.copy()
    for line in lines:
        plot_line(img, int(line.p0.x), int(line.p0.y), int(line.p1.x), int(line.p1.y), (255, 0, 0, 255))
        for px, py in ((line.p0.x, line.p0.y), (line.p1.x, line.p1.y)):
            x, y = int(px), int(py)
            img[max(0, y - 2) : y + 3, max(0, x - 2) : x + 3] = (255, 255, 0, 255)

    Image.fromarray(img).save(out)
    print(f"{len(lines)} line(s) -> {out}")
    for line in lines:
        print(f"  ({line.p0.x:.1f},{line.p0.y:.1f}) -> ({line.p1.x:.1f},{line.p1.y:.1f})  len={line.length():.1f}px")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
