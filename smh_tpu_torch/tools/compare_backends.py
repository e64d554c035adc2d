"""A/B a frame through the numpy oracle and the CUDA backend, diff everything.

The operational counterpart of the reference's live CPU/GPU toggle
(src/vision/hardware.rs:14-45) — but as an automated diff instead of an
eyeball check. Usage:

    python -m smh_tpu_torch.tools.compare_backends <frame.png> [--device cuda|cuda:N|cpu]

Prints the report and "RESULT: PASS" (exit 0) or "RESULT: FAIL" (exit 1).
The backend's LSD mask is its full 0/255 mask (`_full_mask_host`).
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="A/B a frame through the numpy oracle and CudaBackend")
    ap.add_argument("frame")
    ap.add_argument("--device", default="cuda", help='"cuda", "cuda:N" or "cpu" (the plain versions)')
    args = ap.parse_args(argv)

    from ..squadex.capture import load_frame_bgra
    from ..vision.cuda_backend import CudaBackend
    from ..vision.reference import ReferenceBackend

    frame = load_frame_bgra(args.frame)

    def run(be):
        be.load_frame(frame)
        cropped = be.crop_to_map(grayscale=True)
        if cropped is None:
            return None
        ui, bbox = cropped
        if callable(ui):
            ui = ui()
        be.isolate_map_markers()
        be.mask_marker_lines()
        lines = be.find_marker_lines(15)
        ocr = be.ocr_preprocess()
        scales = be.find_scales_preprocess(0)
        mask = be.lsd_image if hasattr(be, "lsd_image") else be._full_mask_host()
        return dict(ui=ui, bbox=bbox, lines=lines, ocr=ocr, scales=scales, mask=mask)

    ref = run(ReferenceBackend())
    cuda = run(CudaBackend(args.device))

    if ref is None or cuda is None:
        print(f"sleeping: oracle={ref is None} cuda={cuda is None}")
        return 0 if (ref is None) == (cuda is None) else 1

    ok = True

    def pct(a, b):
        return float((a == b).mean()) * 100.0

    print(f"map bbox: oracle={ref['bbox']} cuda={cuda['bbox']} "
          f"{'OK' if ref['bbox'] == cuda['bbox'] else 'MISMATCH'}")
    print(f"ui map agreement:     {pct(ref['ui'], cuda['ui']):8.4f}%")
    print(f"lsd mask agreement:   {pct(ref['mask'], cuda['mask']):8.4f}%")
    print(f"ocr image agreement:  {pct(ref['ocr'], cuda['ocr']):8.4f}%")
    print(f"scales agreement:     {pct(ref['scales'] != 0, cuda['scales'] != 0):8.4f}%")

    print(f"lines: oracle={len(ref['lines'])} cuda={len(cuda['lines'])}")
    if len(ref["lines"]) != len(cuda["lines"]):
        ok = False
    for i, (a, b) in enumerate(zip(ref["lines"], cuda["lines"])):
        d0 = max(abs(a.p0.x - b.p0.x), abs(a.p0.y - b.p0.y))
        d1 = max(abs(a.p1.x - b.p1.x), abs(a.p1.y - b.p1.y))
        status = "OK" if max(d0, d1) <= 1.5 else "MISMATCH"
        if status != "OK":
            ok = False
        print(f"  line {i}: start d={d0:.3f} end d={d1:.3f}  {status}")
        print(f"    oracle ({a.p0.x:.1f},{a.p0.y:.1f})->({a.p1.x:.1f},{a.p1.y:.1f})")
        print(f"    cuda   ({b.p0.x:.1f},{b.p0.y:.1f})->({b.p1.x:.1f},{b.p1.y:.1f})")

    print("RESULT:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
