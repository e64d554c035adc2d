"""Dry run of the multi-device path: the full sharded step over an N-entry
(dp, sp) mesh, held against the unsharded path.

    python -m smh_tpu_torch.parallel.dryrun --devices N --device cpu|cuda

The counterpart of smh_tpu's `__graft_entry__.dryrun_multichip`. A torch
mesh needs no platform provisioning, so it runs in this process: "cpu" is
a mesh of N CPU entries (the plain PyTorch versions), "cuda" cycles the N
entries over the visible cards (a mesh of "cuda:0" repeated on one card).
Three checks, each raising on a mismatch:

  1. `full_step` on 128x160 random frames (sp = 2 when N is even, B =
     2 dp): its winner for frame 0 equals the unsharded single-frame march
     of that frame's mask, ends and length exact;
  2. with sp = 2 at 1080p, frames with a marker line across the seams: the
     row-sharded lsd_mask equals the unsharded pass bit for bit on the
     first and last frame, and the sharded march reproduces the unsharded
     winner, of at least 50 px;
  3. the full-DAG BatchPipeline over a dp-only mesh gives the single-device
     pipeline's sleeping flag, markers, minimap and ratio on 640x360 frames
     with a marker, a scale bar and a rendered "300m"; every frame has a
     marker and a ratio.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import consts as C
from .. import resolve_device
from ..ops import lsd as ops_lsd
from ..ops import pipeline as opp
from . import spmd


def devices_for(n: int, kind: str) -> list:
    """N mesh entries: "cpu" N times, or "cuda:i" cycling over the cards."""
    if kind == "cpu":
        return ["cpu"] * n
    resolve_device("cuda")  # raises without a card
    count = torch.cuda.device_count()
    return [f"cuda:{i % count}" for i in range(n)]


def single_march(mask: torch.Tensor, pt) -> tuple:
    """(best end [2], best length^2) of the unsharded single-frame march of
    one mask from one seed (lsd._march + the last-angle argmax)."""
    cos_t, sin_t = ops_lsd.theta_tables(mask.device)
    pts = torch.as_tensor(np.asarray(pt, np.float32)).reshape(1, 2).to(mask.device)
    ex, ey, *_ = ops_lsd.ray_march(mask, pts, int(C.LSD_MAX_GAP), ops_lsd._max_k(*mask.shape), cos_t, sin_t)
    lx, ly = pts[:, 0:1] - ex, pts[:, 1:2] - ey
    lengths = (lx * lx + ly * ly)[0]
    best = (lengths.numel() - 1) - int(torch.argmax(lengths.flip(0)))
    return torch.stack([ex[0, best], ey[0, best]]).cpu(), lengths[best].cpu()


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun: {msg}")


def _sp_for(n: int) -> int:
    return 2 if n % 2 == 0 and n >= 2 else 1


def check_step(devices: list) -> str:
    """Check 1: full_step's winner on 128x160 random frames."""
    n = len(devices)
    sp = _sp_for(n)
    mesh = spmd.make_mesh(devices, sp=sp)
    dp = mesh.shape["dp"]
    h, w = 128, 160
    b = max(2 * dp, 2)
    frames = np.random.default_rng(0).integers(0, 256, size=(b, h, w, 4), dtype=np.uint8)
    g = C.map_geometry(w, h)
    pts = np.tile(np.array([[g.map_w / 2.0, g.map_h / 2.0]], dtype=np.float32), (b, 1))
    out = spmd.gather(spmd.full_step(frames, pts, mesh), "cpu")
    _require(tuple(out["red_ratio"].shape) == (b,), f"red_ratio {tuple(out['red_ratio'].shape)}")
    _require(tuple(out["ui"].shape) == (b, g.map_h, g.map_w), f"ui {tuple(out['ui'].shape)}")
    _require(tuple(out["best_end"].shape) == (b, 2), f"best_end {tuple(out['best_end'].shape)}")
    single = opp.analyze_frame(frames[0], device=mesh.devices[0][0])
    end, length = single_march(single["lsd_mask"], pts[0])
    _require(torch.equal(out["best_end"][0], end) and torch.equal(out["best_length_sqr"][0], length),
             f"sharded march diverged: end {out['best_end'][0]} vs {end}, "
             f"len {out['best_length_sqr'][0]} vs {length}")
    return f"mesh=({dp}x{sp}) batch={b} map={g.map_w}x{g.map_h}: full_step == the unsharded march of frame 0"


def seam_frames(b: int) -> tuple:
    """b 1080p frames whose marker line crosses every row seam of sp = 2
    and 3 (map rows 274, 411, 548) and whose "300m" and bar cross quadrant
    row 137 (sp = 3's seam at map row 548); frames differ by index. ->
    (u8 [b, 1080, 1920, 4], a seed on each line's midpoint f32 [b, 2])."""
    from .. import testing

    frames = np.stack([
        testing.make_frame(1920, 1080, marker_lines=[((120 + 4 * i, 150), (700 + 4 * i, 690))],
                           scale_texts=[("300m", (60 + 7 * i, 124))], scale_bars=[(60, 150, 120, 1)])
        for i in range(b)
    ])
    return frames, np.array([[410.0 + 4 * i, 420.0] for i in range(b)], np.float32)


def check_rows(devices: list) -> str:
    """Check 2: the row-sharded 1080p pass and march (sp = 2)."""
    mesh = spmd.make_mesh(devices, sp=2)
    dp = mesh.shape["dp"]
    b = max(dp, 2)
    frames, pts = seam_frames(b)
    home = mesh.devices[0][0]
    masks = spmd.gather(spmd.analyze_batch(frames, mesh), "cpu")["lsd_mask"]
    for i in (0, b - 1):
        single = opp.analyze_frame(frames[i], device=home)["lsd_mask"].cpu()
        _require(torch.equal(masks[i], single), f"1080p sp=2 halo mismatch on frame {i}")
    out = spmd.gather(spmd.full_step(frames, pts, mesh), "cpu")
    end, length = single_march(masks[0].to(home), pts[0])
    _require(torch.equal(out["best_end"][0], end) and torch.equal(out["best_length_sqr"][0], length),
             f"1080p sharded march diverged: {out['best_end'][0]} vs {end}")
    _require(float(length) >= 50.0**2, f"the 1080p march found no 50 px line (len^2 {float(length)})")
    return f"1080p mesh=({dp}x2): halos bit-exact, the sharded march == single-device (len^2 {float(length):.0f})"


def testing_frame(w: int, h: int, i: int) -> np.ndarray:
    """A detection frame at 640x360 (map 329x274, quadrant 164x137): a
    marker line over 50 px, a scale bar within the bar scan's reach below
    a rendered "300m"; frames differ by index."""
    from .. import testing

    return testing.make_frame(
        w, h,
        marker_lines=[((30 + 2 * i, 30), (150 + 2 * i, 120 + (i % 3)))],
        scale_texts=[("300m", (30, 100))],
        scale_bars=[(30, 122, 60, 1)],
    )


def summarize(r) -> tuple:
    """A per-frame or batch result as comparable values: (markers' ends,
    meters-to-px ratio, minimap bounds)."""
    return (tuple((m.p0.x, m.p0.y, m.p1.x, m.p1.y) for m in r.markers), r.meters_to_px_ratio, r.minimap_bounds)


def check_pipeline(devices: list) -> str:
    """Check 3: BatchPipeline over a dp-only mesh against one device."""
    from ..ocr.smhocr import SmhOcrEngine
    from ..vision.batch import BatchPipeline

    mesh = spmd.make_mesh(devices, sp=1)
    bb = max(len(devices), 2)
    bw, bh = 640, 360
    frames = [testing_frame(bw, bh, i) for i in range(bb)]
    results = []
    for kw in ({"device": mesh.devices[0][0]}, {"mesh": mesh}):
        bp = BatchPipeline(bw, bh, batch=bb, ocr_engine=SmhOcrEngine(), **kw)
        try:
            results.append([(r.sleeping, *summarize(r)) for r in bp.process(frames)])
        finally:
            bp.close()
    single, sharded = results
    for i, (a, c) in enumerate(zip(single, sharded)):
        _require(a == c, f"frame {i}: mesh {c} != single device {a}")
    n_marked = sum(1 for r in single if r[1])
    n_ratio = sum(1 for r in single if r[2] is not None)
    _require(n_marked == bb and n_ratio == bb, f"{n_marked} markers and {n_ratio} ratios in {bb} frames")
    return f"full-DAG BatchPipeline on dp={mesh.shape['dp']} == single device ({bb} frames, markers and ratios)"


def run(devices: list) -> list:
    """The three checks on a mesh of `devices`; their lines."""
    lines = [check_step(devices)]
    if _sp_for(len(devices)) == 2:
        lines.append(check_rows(devices))
    lines.append(check_pipeline(devices))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=8, help="mesh entries")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    args = ap.parse_args(argv)
    if args.devices < 1:
        ap.error("--devices must be at least 1")
    devices = devices_for(args.devices, args.device)
    for line in run(devices):
        print(f"dryrun: {line}", flush=True)
    print(f"dryrun OK: {args.devices} entries on {sorted(set(devices))}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
