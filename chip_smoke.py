#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (smh_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA device. In phases,
each printing a line, each failing loudly:

  1. device  — requires torch.cuda.is_available(); prints the versions and
               the card's name and power limit (nvidia-smi);
  2. build   — compiles smh_tpu_torch/csrc/*.cu with nvcc for sm_90a (one
               nvcc per source, all started together);
  3. kernels — each CUDA kernel against its plain PyTorch version on the
               card at the main path's shapes (exact), the classify and
               fused mask kernels also over the whole 256^3 colour cube
               (classify against the numpy oracle too), the fused mask
               kernel at ragged widths with markers in the last column and
               across its tile seams, the ray march on masks at both map
               sizes with background seeds and seeds on drawn lines (B = 1
               and 8, with and without max_len: ends and lengths
               bit-equal), with CUDA-event times of kernel and plain
               version;
  4. slice   — the port's VisionState on 1080p and 4K frames with a marker
               line and a "300m" scale: markers, ratio and minimap against
               the numpy oracle, the on-device scales read, every kernel
               launched by the main path, and the hostpack bytes against
               the same backend on the CPU (plain versions); then a
               dense-marker sequence until the sparse transport steps
               aside, its full-plane hostpacks (kernel 3's bytes) against
               the CPU path;
  5. transports — with SMH_SPARSE=0 at 1080p and 4K: the window route
               (fit, miss -> full-plane fetch -> escalation), the gray band
               under a Tesseract-flagged engine and the binary band under
               smhocr without the device read; hostpacks equal the same
               backend's CPU path, and the OCR and scales images handed to
               the engine equal the numpy oracle's (the scales image in the
               band's rows, background outside); prints D2H bytes per
               frame;
     debug   — every debug view with the debug re-pass equals the CPU
               path's;
     engine  — lsd_engine="cuda" (the device ray march) gives markers
               within 1.5 px of the oracle;
  6. timing  — p50 of process() over warm frames at 1080p and 4K: smhocr's
               device read with the native and the cuda LSD engine, and a
               Tesseract-flagged engine on a static frame and over the drag;
  7. loop    — CaptureThread -> VisionLoop delivers an update;
  8. live    — the pipelined VisionLoop (delta upload, consume views, async
               fetch) over a cycling marker-drag sequence at 1080p and 4K,
               threaded submit off and on, at the 15 FPS cap and uncapped:
               every update equals the synchronous result of some input
               frame, no frame error is logged, one full upload per chain,
               and the submit half runs under sync-debug mode "error";
               prints fps, H2D bytes per delta frame and frame -> update
               p50/p90; then, threaded and uncapped, the drag with a panning
               scale legend, SMH_SPARSE=0 and the gray band (window rungs
               and band gathers in the submit half, also under "error");
  9. app     — smh_tpu_torch.app.App on the CLI's synthetic source,
               pipelined with async scales, delivers an update and stops.

The last lines are a JSON object with the per-kernel results, the card's
name and power limit, and {"ok": true, "device": {...}}. Any failed check
raises, so the script exits non-zero and prints no result. Imports no JAX.
"""

from __future__ import annotations

import json
import logging
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

MARKER = [((120, 150), (700, 520))]  # map-ROI coordinates at 1080p
CUBE_SIDE = 4096  # 4096 x 4096 = every 8-bit RGB colour once
N_TIMED = 50
ALPHA_BGRA = (0, 255, 64, 255)  # the alpha fireteam's marker colour
DRAG_FRAMES = 12  # frames in the live loop's cycling marker drag
LIVE_SIZES = ((1920, 1080), (3840, 2160))
LIVE_UPDATES = ((15.0, 24), (None, 90))  # (fps cap or None, updates per run)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def tesseract_flagged():
    """smhocr's reader under Tesseract's transport flags (binary_ok False,
    image_derived True, no device read): the gray band route. The card's
    machine has no libtesseract."""
    from smh_tpu.ocr.smhocr import SmhOcrEngine

    class TesseractFlagged(SmhOcrEngine):
        binary_ok = False
        image_derived = True
        device_ok = False

    return TesseractFlagged()


class sparse_off:
    """SMH_SPARSE=0 (the window transport) for the duration of a block."""

    def __enter__(self):
        self.before = os.environ.get("SMH_SPARSE")
        os.environ["SMH_SPARSE"] = "0"

    def __exit__(self, *exc):
        if self.before is None:
            os.environ.pop("SMH_SPARSE", None)
        else:
            os.environ["SMH_SPARSE"] = self.before


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    require(bool(out), "nvidia-smi printed no card")
    return out


def cuda_ms(fn, n: int = N_TIMED) -> float:
    """Mean device time of fn() over n calls (CUDA events, after warm-up)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def frame_for(w: int, h: int) -> np.ndarray:
    """The verify-skill frame at 1080p; its 2x-scaled counterpart at 4K."""
    from smh_tpu_torch import testing

    k = w // 1920
    (x0, y0), (x1, y1) = MARKER[0]
    return testing.make_frame(
        w, h,
        marker_lines=[((x0 * k, y0 * k), (x1 * k, y1 * k))],
        scale_texts=[("300m", (60 * k, 170 * k))],
        scale_bars=[(60 * k, 170 * k + 30, 120 * k, 1)],
    )


class ErrorCount(logging.Handler):
    """Counts ERROR records: VisionLoop logs and drops a failing frame."""

    def __init__(self) -> None:
        super().__init__(level=logging.ERROR)
        self.messages: list[str] = []

    def emit(self, record) -> None:
        self.messages.append(record.getMessage())


def percentile(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def phase_kernels(dev: torch.device) -> dict:
    from smh_tpu import consts as C
    from smh_tpu.vision import pixmath
    from smh_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(0)
    results = {}

    # -- kernel 1: the whole colour cube, then the map-ROI shapes ------------
    v = np.arange(256, dtype=np.uint8)
    r, g, b = np.meshgrid(v, v, v, indexing="ij")
    cube = [torch.from_numpy(x.reshape(CUBE_SIDE, CUBE_SIDE).copy()).to(dev) for x in (r, g, b)]
    mk, lk = K.classify_luma_planes(*cube)
    mp, lp = K.classify_luma_planes_plain(*cube)
    require(bool((mk == mp).all()) and bool((lk == lp).all()), "classify kernel != plain on the cube")
    rgb = np.stack([r, g, b], axis=-1).reshape(CUBE_SIDE, CUBE_SIDE, 3)
    m_oracle = pixmath.is_any_map_marker_color(rgb)
    l_oracle = pixmath.luma8(rgb)
    require(bool((mk.cpu().numpy().astype(bool) == m_oracle).all()), "classify kernel != pixmath marker")
    require(bool((lk.cpu().numpy() == l_oracle).all()), "classify kernel != pixmath luma")
    err = 0
    print(f"kernels: classify_luma exact on the 256^3 cube (kernel == plain == pixmath), "
          f"{int(m_oracle.sum())} marker colours", flush=True)
    times = {}
    for w, h in ((1920, 1080), (3840, 2160)):
        gm = C.map_geometry(w, h)
        planes = [torch.from_numpy(rng.integers(0, 256, (gm.map_h, gm.map_w), dtype=np.uint8)).to(dev)
                  for _ in range(3)]
        mk, lk = K.classify_luma_planes(*planes)
        mp, lp = K.classify_luma_planes_plain(*planes)
        err = max(err, int((mk.int() - mp.int()).abs().max()), int((lk.int() - lp.int()).abs().max()))
        require(err == 0, f"classify kernel != plain at {gm.map_h}x{gm.map_w}")
        t_k = cuda_ms(lambda: K.classify_luma_planes(*planes))
        t_p = cuda_ms(lambda: K.classify_luma_planes_plain(*planes))
        times[h] = (t_k, t_p)
        print(f"kernels: classify_luma {gm.map_h}x{gm.map_w} exact; kernel {t_k:.4f} ms, "
              f"plain {t_p:.4f} ms", flush=True)
    results["classify_luma"] = {
        "name": "classify_luma", "route": "cuda",
        "source": "smh_tpu_torch/csrc/classify_luma.cu",
        "replaces": "smh_tpu/ops/pallas_kernels.py:42",
        "max_abs_err": err, "ms": times[1080][0], "plain_ms": times[1080][1],
    }

    # -- kernel 2: the tile-height schedule, a random trial, the map shapes ----
    th = K.QUIET_TILE_H
    heights = [int(0.7 * th), th + 3, int(2.4 * th) + 1, 4 * th - 5, int(rng.integers(30, 300))]
    err = 0

    def planes_for(views):
        return [torch.from_numpy(np.ascontiguousarray(views[..., c])).to(dev) for c in range(3)]

    def check_rect(views, label):
        nonlocal err
        p = planes_for(views)
        got = K.minimap_rect_planes(*p)
        want = K.minimap_rect_planes_plain(*p)
        err = max(err, int((got - want).abs().max()))
        require(err == 0, f"quiet_walk kernel != plain ({label})")
        return p, got

    for trial, h in enumerate(heights):
        w = int(rng.integers(40, 400)) | 1
        views = rng.integers(0, 256, (3, h, w, 3), dtype=np.uint8)
        for i in range(3):
            y0, x0 = h // (4 + 4 * (i % 2)), w // (4 + 4 * (i % 2))
            box = views[i, y0 : h - y0, x0 : w - x0]
            if i == 2:  # edgy centre inside a quiet surround: a minimap-like layout
                quiet = np.full_like(views[i], 90 + trial)
                quiet[y0 : h - y0, x0 : w - x0] = box
                views[i] = quiet
            else:  # quiet box over the centre
                box[...] = 120 + trial
        _, got = check_rect(views, f"h={h} w={w}")
        print(f"kernels: quiet_walk B=3 {h}x{w} exact, rects {got.cpu().tolist()}", flush=True)
    times = {}
    for w, h in ((1920, 1080), (3840, 2160)):
        gm = C.map_geometry(w, h)
        frame = frame_for(w, h)
        roi = frame[gm.map_y : gm.map_y + gm.map_h, gm.map_x : gm.map_x + gm.map_w, :3]
        noisy = roi.copy()
        cy0, cx0 = gm.map_h // 5, gm.map_w // 5
        noisy[cy0:-cy0, cx0:-cx0] = rng.integers(0, 256, noisy[cy0:-cy0, cx0:-cx0].shape, dtype=np.uint8)
        p, got = check_rect(np.stack([roi, noisy]), f"{gm.map_h}x{gm.map_w}")
        t_k = cuda_ms(lambda: K.minimap_rect_planes(*p))
        t_p = cuda_ms(lambda: K.minimap_rect_planes_plain(*p))
        times[h] = (t_k, t_p)
        print(f"kernels: quiet_walk B=2 {gm.map_h}x{gm.map_w} exact, rects {got.cpu().tolist()}; "
              f"kernel+tail {t_k:.4f} ms, plain {t_p:.4f} ms", flush=True)
    results["quiet_walk"] = {
        "name": "quiet_walk", "route": "cuda",
        "source": "smh_tpu_torch/csrc/quiet_walk.cu",
        "replaces": "smh_tpu/ops/pallas_kernels.py:321",
        "max_abs_err": err, "ms": times[1080][0], "plain_ms": times[1080][1],
    }

    # -- kernel 3: the cube, ragged widths, tile seams, the map shapes ---------
    err = 0

    def check_mask(rgb: np.ndarray, label: str):
        nonlocal err
        p = [torch.from_numpy(np.ascontiguousarray(rgb[..., c])).to(dev) for c in range(3)]
        got = K.fused_mask_bits(*p)
        want = K.fused_mask_bits_plain(*p)
        require(got.shape == want.shape, f"fused_mask shape {tuple(got.shape)} != {tuple(want.shape)} ({label})")
        err = max(err, int((got.int() - want.int()).abs().max()))
        require(err == 0, f"fused_mask kernel != plain ({label})")
        return p, got

    def marker_rich(h: int, w: int) -> np.ndarray:
        rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        rgb[rng.random((h, w)) < 0.1] = ALPHA_BGRA[2::-1]
        rgb[rng.random(h) < 0.5, w - 1] = ALPHA_BGRA[2::-1]  # the last column
        return rgb

    _, got = check_mask(np.stack([r, g, b], axis=-1).reshape(CUBE_SIDE, CUBE_SIDE, 3), "cube")
    print(f"kernels: fused_mask exact on the 256^3 cube ({int(got.sum())} byte sum)", flush=True)
    ragged = (13, 21, 37, 263, 987, 1973)  # W % 8 != 0 and W % 32 != 0
    for w in ragged:
        check_mask(marker_rich(int(rng.integers(5, 70)), w), f"ragged w={w}")
    th, tw = K.FUSED_TILE_H, K.FUSED_TILE_W
    for h in (th - 1, th, th + 1, 2 * th + 1, 3 * th - 1):
        for w in (tw - 1, tw, tw + 1, 2 * tw + 3):
            rgb = np.full((h, w, 3), 40, dtype=np.uint8)
            rgb[max(th - 2, 0) : th + 2, tw - 3 : min(tw + 3, w)] = ALPHA_BGRA[2::-1]  # across both seams
            rgb[h - 1, w - 1] = rgb[0, 0] = ALPHA_BGRA[2::-1]
            check_mask(rgb, f"seams {h}x{w}")
    print(f"kernels: fused_mask exact at ragged widths {ragged} with last-column markers and "
          f"across the {th}x{tw} tile seams", flush=True)
    times = {}
    for w, h in ((1920, 1080), (3840, 2160)):
        gm = C.map_geometry(w, h)
        p, _ = check_mask(marker_rich(gm.map_h, gm.map_w), f"{gm.map_h}x{gm.map_w}")
        t_k = cuda_ms(lambda: K.fused_mask_bits(*p))
        t_p = cuda_ms(lambda: K.fused_mask_bits_plain(*p))
        times[h] = (t_k, t_p)
        print(f"kernels: fused_mask {gm.map_h}x{gm.map_w} exact; kernel {t_k:.4f} ms, "
              f"plain {t_p:.4f} ms", flush=True)
    results["fused_mask"] = {
        "name": "fused_mask", "route": "cuda",
        "source": "smh_tpu_torch/csrc/fused_mask.cu",
        "replaces": "smh_tpu/ops/pallas_kernels.py:155",
        "max_abs_err": err, "ms": times[1080][0], "plain_ms": times[1080][1],
    }
    return results


def line_mask(h: int, w: int, lines) -> np.ndarray:
    """u8 0/255 mask of 1-px lines, L1-dilated like the fused pass's."""
    m = np.zeros((h, w), dtype=bool)
    for (x0, y0), (x1, y1) in lines:
        n = 2 * max(abs(x1 - x0), abs(y1 - y0)) + 1
        m[np.round(np.linspace(y0, y1, n)).astype(int), np.round(np.linspace(x0, x1, n)).astype(int)] = True
    d = m.copy()
    d[1:] |= m[:-1]
    d[:-1] |= m[1:]
    d[:, 1:] |= m[:, :-1]
    d[:, :-1] |= m[:, 1:]
    return d.astype(np.uint8) * np.uint8(255)


def phase_ray_march(dev: torch.device) -> dict:
    """Kernel 4 against its plain version: ends, winners and lengths
    bit-equal, on the map shapes, background and line seeds."""
    from smh_tpu import consts as C
    from smh_tpu_torch.ops import lsd as L

    rng = np.random.default_rng(1)
    mg = int(C.LSD_MAX_GAP)
    cos_t, sin_t = L.theta_tables(dev)
    times = {}
    err = 0.0
    for w, h in ((1920, 1080), (3840, 2160)):
        gm = C.map_geometry(w, h)
        k = w // 1920
        (x0, y0), (x1, y1) = MARKER[0]
        lines = [((x0 * k, y0 * k), (x1 * k, y1 * k)), ((30 * k, 700 * k), (900 * k, 60 * k))]
        mask = line_mask(gm.map_h, gm.map_w, lines)
        white_y, white_x = np.nonzero(mask == 255)
        black_y, black_x = np.nonzero(mask[::7, ::7] == 0)
        mask_t = torch.from_numpy(mask).to(dev)
        diag = float(np.hypot(*mask.shape)) + 1.0
        for b in (1, 8):
            on_line = rng.choice(white_y.size, (b + 1) // 2, replace=False)
            off_line = rng.choice(black_y.size, b // 2, replace=False)
            pts = np.concatenate([
                np.stack([white_x[on_line], white_y[on_line]], axis=1),
                np.stack([black_x[off_line] * 7, black_y[off_line] * 7], axis=1),
            ]).astype(np.float32)
            pts_t = torch.from_numpy(pts).to(dev)
            for max_len in (None, diag):
                k_total = L.step_bound(gm.map_h, gm.map_w, mg, max_len)
                got = L.ray_march(mask_t, pts_t, mg, k_total, cos_t, sin_t)
                ex, ey = L.march_plain(mask_t, pts_t, mg, k_total, cos_t, sin_t)
                want = (ex, ey, *L.finalize_plain(pts_t, ex, ey))
                torch.cuda.synchronize()
                for name, g_, w_ in zip(("end_x", "end_y", "best_x", "best_y", "best_len"), got, want):
                    err = max(err, float((g_ - w_).abs().max()))
                    require(torch.equal(g_, w_), f"ray_march {name} != plain at {gm.map_h}x{gm.map_w} "
                            f"B={b} max_len={max_len}")
            longest = float(got[4].max().sqrt())
            print(f"kernels: ray_march {gm.map_h}x{gm.map_w} B={b} ({(b + 1) // 2} line, {b // 2} background "
                  f"seeds) bit-equal with and without max_len; longest ray {longest:.2f} px", flush=True)
        k_total = L.step_bound(gm.map_h, gm.map_w, mg, diag)
        t_k = cuda_ms(lambda: L.ray_march(mask_t, pts_t, mg, k_total, cos_t, sin_t))
        t_p = cuda_ms(lambda: L.finalize_plain(pts_t, *L.march_plain(mask_t, pts_t, mg, k_total, cos_t, sin_t)), n=5)
        times[h] = (t_k, t_p)
        print(f"kernels: ray_march {gm.map_h}x{gm.map_w} B=8 k_total={k_total}: kernel {t_k:.4f} ms, "
              f"plain {t_p:.4f} ms", flush=True)
    return {
        "name": "ray_march", "route": "cuda",
        "source": "smh_tpu_torch/csrc/ray_march.cu",
        "replaces": "smh_tpu/ops/lsd.py:96",
        "max_abs_err": err, "ms": times[1080][0], "plain_ms": times[1080][1],
    }


def new_state(device, hardware: bool = True, engine=None):
    from smh_tpu.ocr.smhocr import SmhOcrEngine
    from smh_tpu.settings import Settings
    from smh_tpu_torch.vision.pipeline import VisionState

    s = Settings(path=None)
    s.set("hardware_acceleration", hardware, save=False)
    return VisionState(settings=s, ocr_engine=engine or SmhOcrEngine(), device=device)


def hostpacks_match(a: np.ndarray, b: np.ndarray, layout: dict) -> bool:
    """Equal bytes, except that scales_rec score lanes may differ by 1 (the
    f32 template dot sums in another order on the card)."""
    if a.shape != b.shape:
        return False
    diff = np.nonzero(a != b)[0]
    if diff.size == 0:
        return True
    if "scales_rec" not in layout:
        return False
    from smh_tpu_torch.ops import scales_device as sd

    off, size = layout["scales_rec"]
    if diff.min() < off or diff.max() >= off + size:
        return False
    ra = a[off : off + size].view(np.int16).astype(np.int32)
    rb = b[off : off + size].view(np.int16).astype(np.int32)
    return bool(sd.score_lanes()[ra != rb].all()) and int(np.abs(ra - rb).max()) <= 1


def phase_slice(dev: torch.device) -> dict:
    from smh_tpu.squadex.capture import Frame
    from smh_tpu_torch import testing
    from smh_tpu_torch.ops import kernels as K
    from smh_tpu_torch.ops import pipeline as opp

    fonts = testing.fonts_present()
    print(f"slice: DejaVu fonts {fonts}", flush=True)
    require(all(fonts.values()), f"DejaVu fonts missing: {fonts}")

    launches = {name: 0 for name in K.LAUNCHES}
    for w, h in ((1920, 1080), (3840, 2160)):
        frame = frame_for(w, h)
        state = new_state(dev)
        try:
            K.reset_launches()
            res = state.process(Frame(frame, 96))
            torch.cuda.synchronize()
            for name, n in K.LAUNCHES.items():
                launches[name] += n
            require(all(K.LAUNCHES[n] > 0 for n in K.FUSED_PASS), f"main path skipped a kernel: {K.LAUNCHES}")
            be = state.delegate.backend
            require(be.name == "cuda" and be.device.type == "cuda", "the CUDA backend did not run")
            pack_gpu = be._results["hostpack"].cpu().numpy()
            spack_gpu = be._results["scalespack"].cpu().numpy()
            layout = opp.hostpack_layout(
                be.geom.map_h, be.geom.map_w, with_ocr=True, with_quiet=True,
                scales_inline=be._dispatch_flags[3], sparse_budget=be._dispatch_flags[4],
            )
            stats = dict(be.stats)
        finally:
            state.close()
        require(res is not None, "map gate closed on a frame with the button")

        oracle_state = new_state("cpu", hardware=False)
        try:
            ref = oracle_state.process(Frame(frame, 96))
        finally:
            oracle_state.close()
        cpu_state = new_state("cpu")
        try:
            cpu_state.process(Frame(frame, 96))
            pack_cpu = cpu_state.delegate.backend._results["hostpack"].numpy()
            spack_cpu = cpu_state.delegate.backend._results["scalespack"].numpy()
        finally:
            cpu_state.close()

        markers = [(l.p0, l.p1) for l in res.markers]
        ref_markers = [(l.p0, l.p1) for l in ref.markers]
        require(len(markers) == len(ref_markers) == 1, f"markers {markers} vs oracle {ref_markers}")
        for (a0, a1), (b0, b1) in zip(markers, ref_markers):
            # tests/test_tpu_parity.py:139-140: ray ends agree within 1.5 px
            require(all(abs(p.x - q.x) <= 1.5 and abs(p.y - q.y) <= 1.5 for p, q in ((a0, b0), (a1, b1))),
                    f"marker {markers} vs oracle {ref_markers}")
        k = w // 1920
        want_ratio = 300.0 / (120 * k - 2)
        # The drawn bar spans 120k px with end bars, so it measures 120k - 2.
        # (The oracle's host OCR reads system fonts, which a machine may lack,
        # so the ratio is held to the frame's geometry instead.)
        require(res.meters_to_px_ratio is not None and abs(res.meters_to_px_ratio - want_ratio) < 1e-9,
                f"ratio {res.meters_to_px_ratio} vs {want_ratio}")
        require(res.minimap_bounds == ref.minimap_bounds, f"minimap {res.minimap_bounds} vs {ref.minimap_bounds}")
        require(stats["device_scales_frames"] >= 1 and stats["device_scales_fallbacks"] == 0,
                f"scales not read on the device: {stats}")
        require(hostpacks_match(pack_gpu, pack_cpu, layout), "hostpack bytes differ from the CPU path")
        require(bool((spack_gpu == spack_cpu).all()), "scalespack bytes differ from the CPU path")
        print(f"slice: {w}x{h} markers {markers} (oracle {ref_markers}), ratio {res.meters_to_px_ratio:.6f}, "
              f"minimap {res.minimap_bounds}, launches {dict(K.LAUNCHES)}, "
              f"device_scales_frames {stats['device_scales_frames']}, fallbacks "
              f"{stats['device_scales_fallbacks']}, hostpack {pack_gpu.size} B == CPU path", flush=True)
    return launches


def phase_dense(dev: torch.device) -> dict:
    """The non-sparse route: marker stripes on every 4th row overflow every
    sparse rung, so after _SP_OFF_AFTER misses (each fetching kernel 3's
    full bit plane) the sparse transport steps aside and the hostpack
    carries that plane. Hostpacks and the reconstructed masks equal the
    CPU path's, frame by frame."""
    from smh_tpu import consts as C
    from smh_tpu_torch.ops import kernels as K
    from smh_tpu_torch.ops import pipeline as opp
    from smh_tpu_torch.vision import cuda_backend as cb

    launches = {name: 0 for name in K.LAUNCHES}
    for w, h in ((1920, 1080), (3840, 2160)):
        g = C.map_geometry(w, h)
        frame = frame_for(w, h)
        frame[g.map_y : g.map_y + g.map_h : 4, g.map_x : g.map_x + g.map_w] = ALPHA_BGRA
        backends = [cb.CudaBackend(dev), cb.CudaBackend("cpu")]
        for be in backends:
            be.scales_device_ok = True
        K.reset_launches()
        routes = []
        for i in range(cb._SP_OFF_AFTER + 2):
            packs = []
            for be in backends:
                be.load_frame(frame)
                require(be.crop_to_map(True) is not None, "map gate closed on the dense frame")
                packs.append((be._fetch[0].numpy(), be._host["lsd_crop_bits"], be._dispatch_flags))
            (pg, bits_g, flags), (pc, bits_c, flags_c) = packs
            require(flags == flags_c, f"dispatch flags differ: {flags} vs {flags_c}")
            layout = opp.hostpack_layout(
                g.map_h, g.map_w, with_ocr=True, with_quiet=True, scales_inline=flags[3],
                sparse_budget=flags[4],
            )
            require(hostpacks_match(pg, pc, layout), f"dense frame {i}: hostpack differs from the CPU path")
            require(bits_g.shape == bits_c.shape and bool((bits_g == bits_c).all()),
                    f"dense frame {i}: mask bits differ from the CPU path")
            routes.append("sparse" if flags[4] is not None else "full-plane")
        torch.cuda.synchronize()
        for name, n in K.LAUNCHES.items():
            launches[name] += n
        st = backends[0].stats
        require(routes[-1] == "full-plane" and st["lsd_sparse_misses"] == cb._SP_OFF_AFTER,
                f"sparse did not step aside: {routes}, {st}")
        require(K.LAUNCHES["fused_mask"] > 0, f"the non-sparse route skipped kernel 3: {K.LAUNCHES}")
        print(f"slice: dense {w}x{h} routes {routes}, sparse misses {st['lsd_sparse_misses']}, "
              f"hostpacks and masks == CPU path, launches {dict(K.LAUNCHES)}", flush=True)
    return launches


def _drive(be, frame, grayscale: bool = True) -> list:
    """One frame through a backend's stages -> the marker lines."""
    from smh_tpu import consts as C

    be.load_frame(frame)
    require(be.crop_to_map(grayscale) is not None, "map gate closed")
    be.mask_marker_lines()
    return [(l.p0.x, l.p0.y, l.p1.x, l.p1.y) for l in be.find_marker_lines(C.LSD_MAX_GAP)]


def _pair_checks(pair, frame, label: str) -> tuple:
    """The frame through the card's backend and the CPU path's: the same
    lines, flags and stats, hostpack bytes equal. -> (flags, hostpack
    bytes, extra D2H bytes of a miss fetch)."""
    from smh_tpu_torch.ops import pipeline as opp

    gpu, cpu = pair
    mask_misses = gpu.stats["lsd_window_misses"] + gpu.stats["lsd_sparse_misses"]
    fetches = gpu.stats["scalespack_fetches"]
    lines = [_drive(be, frame) for be in pair]
    require(lines[0] == lines[1], f"{label}: lines {lines[0]} vs CPU path {lines[1]}")
    f = gpu._dispatch_flags
    require(f == cpu._dispatch_flags, f"{label}: flags {f} vs {cpu._dispatch_flags}")
    require(gpu.stats == cpu.stats, f"{label}: stats {gpu.stats} vs {cpu.stats}")
    g = gpu.geom
    layout = opp.hostpack_layout(
        g.map_h, g.map_w, with_ocr=f.with_ocr, with_quiet=f.with_quiet, crop_h=f.crop_h, crop_w=f.crop_w,
        scales_inline=f.inline, scales_band=f.band, sparse_budget=f.sparse,
    )
    pg, pc = gpu._fetch[0].numpy(), cpu._fetch[0].numpy()
    require(hostpacks_match(pg, pc, layout), f"{label}: hostpack differs from the CPU path")
    # A window or sparse miss fetches the full bit plane once; a band miss
    # or a lazy read the scalespack.
    extra = (gpu.stats["lsd_window_misses"] + gpu.stats["lsd_sparse_misses"] - mask_misses) * (
        g.map_h * ((g.map_w + 7) // 8)
    ) + (gpu.stats["scalespack_fetches"] - fetches) * opp.scalespack_layout(g.map_h, g.map_w)["__total__"]
    return f, pg.size, extra


def phase_transports(dev: torch.device) -> dict:
    """SMH_SPARSE=0: the window route (fit, miss -> escalate), the gray band
    under Tesseract's flags and the binary band under smhocr without the
    device read, each frame on the card and on the CPU path."""
    from smh_tpu import consts as C
    from smh_tpu.ocr.engine import OCR_BINARY_THRESHOLD
    from smh_tpu.vision.reference import ReferenceBackend
    from smh_tpu_torch import testing
    from smh_tpu_torch.ops import kernels as K
    from smh_tpu_torch.vision import cuda_backend as cb

    launches = {name: 0 for name in K.LAUNCHES}
    d2h = {}
    with sparse_off():
        for w, h in ((1920, 1080), (3840, 2160)):
            k = w // 1920
            g = C.map_geometry(w, h)
            K.reset_launches()
            pair = [cb.CudaBackend(dev), cb.CudaBackend("cpu")]
            for be in pair:
                be.scales_device_ok = True
            small = testing.make_frame(
                w, h, marker_lines=[((120 * k, 150 * k), (380 * k, 320 * k))],
                scale_texts=[("300m", (60 * k, 170 * k))], scale_bars=[(60 * k, 170 * k + 30, 120 * k, 1)],
            )
            routes = []
            for i, frame in enumerate((small, frame_for(w, h), frame_for(w, h))):
                f, nbytes, extra = _pair_checks(pair, frame, f"window {w}x{h} frame {i}")
                routes.append((f.crop_h, f.crop_w, pair[0].stats["lsd_window_misses"], nbytes + extra))
            require(routes[0][:3] == (g.map_h // 2, g.map_w // 2, 0), f"window did not fit: {routes}")
            require(routes[1][2] == 1 and routes[2][2] == 1, f"window miss did not escalate: {routes}")
            require((routes[2][0] or g.map_h) * (routes[2][1] or g.map_w) > routes[1][0] * routes[1][1],
                    f"window did not grow: {routes}")
            d2h[f"{w}x{h} window"] = [r[3] for r in routes]
            print(f"transports: {w}x{h} window route (crop_h, crop_w, misses, D2H bytes) {routes}: "
                  f"fit, miss -> full-plane fetch -> escalation; hostpacks == CPU path", flush=True)

            oracle = ReferenceBackend()
            oracle.load_frame(frame_for(w, h))
            require(oracle.crop_to_map(True) is not None, "oracle gate closed")
            o_ocr, o_scales = oracle.ocr_preprocess(), oracle.find_scales_preprocess(0)
            for inline, binary_ok in (("gray", False), ("binary", True)):
                pair = [cb.CudaBackend(dev), cb.CudaBackend("cpu")]
                for be in pair:
                    be.scales_binary_ok, be.scales_image_derived = binary_ok, True
                f, nbytes, extra = _pair_checks(pair, frame_for(w, h), f"{inline} band {w}x{h}")
                gpu = pair[0]
                band = gpu._host.get("scales_band")
                require(f.inline == inline and f.band is not None and isinstance(band, tuple) and not band[2],
                        f"{inline} band not taken: {f}, {band}")
                want_ocr = np.where(o_ocr < OCR_BINARY_THRESHOLD, np.uint8(0), np.uint8(255)) if binary_ok else o_ocr
                require(np.array_equal(gpu.ocr_preprocess(), want_ocr), f"{inline} band OCR image != oracle")
                # The band carries every row the bar scan can read; the
                # canvas outside it is background.
                rows = slice(band[1], band[1] + f.band)
                scales_img = gpu.find_scales_preprocess(0)
                require(np.array_equal(scales_img[rows], o_scales[rows]) and not scales_img[: band[1]].any()
                        and not scales_img[band[1] + f.band :].any(), f"{inline} band scales image != oracle")
                require(gpu.stats["scalespack_fetches"] == 0, f"{inline} band fetched the scalespack: {gpu.stats}")
                d2h[f"{w}x{h} {inline} band"] = nbytes + extra
                print(f"transports: {w}x{h} {inline} band of {f.band} rows at {band[1]}: hostpack {nbytes} B "
                      f"== CPU path; OCR and scales images == oracle; no scalespack fetch", flush=True)
            torch.cuda.synchronize()
            for name, n in K.LAUNCHES.items():
                launches[name] += n
            require(all(K.LAUNCHES[n] > 0 for n in K.FUSED_PASS), f"transports skipped a kernel: {K.LAUNCHES}")
    print("transports: D2H bytes per frame " + json.dumps(d2h), flush=True)
    return launches


def phase_debug(dev: torch.device) -> dict:
    """Every debug view of the card's backend with the debug re-pass equals
    the CPU path's."""
    from smh_tpu.vision.reference import DebugView
    from smh_tpu_torch.ops import kernels as K
    from smh_tpu_torch.vision import cuda_backend as cb

    launches = {name: 0 for name in K.LAUNCHES}
    for w, h in ((1920, 1080), (3840, 2160)):
        K.reset_launches()
        pair = [cb.CudaBackend(dev), cb.CudaBackend("cpu")]
        for be in pair:
            be.scales_device_ok = True
            be.set_debug(True)
            be.load_frame(frame_for(w, h))
            require(be.crop_to_map(True) is not None, "map gate closed")
        torch.cuda.synchronize()
        for name, n in K.LAUNCHES.items():
            launches[name] += n
        shapes = {}
        for view in DebugView:
            got, want = (be.get_debug_view(view) for be in pair)
            require((got is None) == (view == DebugView.NONE) and (want is None) == (got is None),
                    f"debug view {view.name}: {got is None} vs {want is None}")
            if got is not None:
                require(np.array_equal(got, want), f"debug view {view.name} differs from the CPU path")
                shapes[view.name] = list(got.shape)
        print(f"debug: {w}x{h} every view == CPU path: {shapes}", flush=True)
    return launches


def phase_device_engine(dev: torch.device) -> dict:
    """lsd_engine="cuda": the seed scan over the device ray march finds the
    oracle's markers within 1.5 px."""
    from smh_tpu.squadex.capture import Frame
    from smh_tpu_torch.ops import kernels as K

    launches = {name: 0 for name in K.LAUNCHES}
    for w, h in ((1920, 1080), (3840, 2160)):
        frame = frame_for(w, h)
        oracle_state = new_state("cpu", hardware=False)
        try:
            ref = oracle_state.process(Frame(frame, 96))
        finally:
            oracle_state.close()
        state = new_state(dev)
        try:
            be = state.delegate.current()
            be.lsd_engine = "cuda"
            K.reset_launches()
            res = state.process(Frame(frame, 96))
            torch.cuda.synchronize()
            for name, n in K.LAUNCHES.items():
                launches[name] += n
            require(K.LAUNCHES["ray_march"] > 0, f"the cuda engine did not march: {K.LAUNCHES}")
        finally:
            state.close()
        markers = [(l.p0, l.p1) for l in res.markers]
        ref_markers = [(l.p0, l.p1) for l in ref.markers]
        require(len(markers) == len(ref_markers) == 1, f"cuda engine markers {markers} vs oracle {ref_markers}")
        for (a0, a1), (b0, b1) in zip(markers, ref_markers):
            require(all(abs(p.x - q.x) <= 1.5 and abs(p.y - q.y) <= 1.5 for p, q in ((a0, b0), (a1, b1))),
                    f"cuda engine marker {markers} vs oracle {ref_markers}")
        print(f"engine: {w}x{h} lsd_engine=cuda markers {markers} (oracle {ref_markers}), "
              f"{K.LAUNCHES['ray_march']} ray_march launches", flush=True)
    return launches


def _timed(state, frames, n: int = 20, warm: int = 5) -> tuple:
    """process() wall times (ms) over n frames cycling through `frames`,
    after `warm` frames -> (samples, {stage: per-frame ms}, the last result)."""
    from smh_tpu.squadex.capture import Frame
    from smh_tpu.vision.pipeline import DebugBox

    samples, stages = [], {}
    for i in range(warm + n):
        frame = Frame(frames[i % len(frames)], 96)
        debug = DebugBox()
        t0 = time.perf_counter()
        res = state.process(frame, debug)
        if i >= warm:
            samples.append((time.perf_counter() - t0) * 1e3)
            for stage, sec in debug.timeshares.stages.items():
                stages.setdefault(stage, []).append(sec * 1e3)
        require(res is not None and len(res.markers) == 1, "warm frame lost its marker")
    return samples, stages, res


def _summary(samples, stages) -> str:
    """p50 with its spread, and the three largest stage medians."""
    top = sorted(((statistics.median(v), k) for k, v in stages.items()), reverse=True)[:3]
    return (f"p50 {statistics.median(samples):.3f} ms (min {min(samples):.3f}, max {max(samples):.3f}, "
            f"{len(samples)} warm frames; stage p50s " + ", ".join(f"{k} {v:.2f}" for v, k in top) + ")")


def phase_timing(dev: torch.device, card: str) -> None:
    """Sync process() p50: smhocr's device read (the main path), the same
    with lsd_engine="cuda", and a Tesseract-flagged engine on a static frame
    (checksum-only once the checksum settles) and over a panning marker drag
    (the gray band every frame). smh_tpu's host smhocr reads system fonts, which
    the card's machine lacks, so the Tesseract-flagged ratio may be None
    there: those rows time the transport, not the read."""
    from smh_tpu_torch.ops import pipeline as opp

    for w, h in ((1920, 1080), (3840, 2160)):
        static = [frame_for(w, h)]
        for label, frames in (("static", static), ("panning drag", drag_frames(w, h, pan=True))):
            state = new_state(dev, engine=tesseract_flagged())
            try:
                samples, stages, res = _timed(state, frames)
                f = state.delegate.backend._dispatch_flags
            finally:
                state.close()
            print(f"timing: process() {w}x{h} Tesseract-flagged engine, {label} {_summary(samples, stages)}, "
                  f"inline {f.inline!r} band {f.band} on {card}", flush=True)
        state = new_state(dev)
        try:
            state.delegate.current().lsd_engine = "cuda"
            samples, stages, res = _timed(state, static)
        finally:
            state.close()
        print(f"timing: process() {w}x{h} lsd_engine=cuda {_summary(samples, stages)} on {card}", flush=True)
        state = new_state(dev)
        try:
            samples, stages, res = _timed(state, static)
            # The fused pass must queue on the stream without waiting for it.
            be = state.delegate.backend
            g = be.geom
            torch.cuda.set_sync_debug_mode("error")
            try:
                opp.analyze_packed_flat(
                    be._resident, map_h=g.map_h, map_w=g.map_w, btn_h=g.btn_h, btn_w=g.btn_w,
                    grayscale=True, scales_inline="device", sparse_budget=be._dispatch_flags[4],
                    templates=be._templates,
                )
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
        finally:
            state.close()
        print(f"timing: process() {w}x{h} {_summary(samples, stages)} on {card}; "
              f"the fused pass queued with no host sync", flush=True)


def phase_loop(dev: torch.device) -> None:
    from smh_tpu.squadex.capture import CaptureThread, StaticSource
    from smh_tpu_torch.vision.pipeline import VisionLoop

    state = new_state(dev)
    updates = []
    cap = CaptureThread(StaticSource(frame_for(1920, 1080), dpi=96)).start()
    loop = VisionLoop(state, cap, lambda r, d: updates.append(r)).start()
    try:
        deadline = time.time() + 120
        while time.time() < deadline and not any(u is not None for u in updates):
            time.sleep(0.05)
    finally:
        loop.stop()
        cap.stop()
    got = next((u for u in updates if u is not None), None)
    require(got is not None, "VisionLoop delivered no update within 120 s")
    require(len(got.markers) == 1 and got.meters_to_px_ratio is not None, "loop update incomplete")
    print(f"loop: VisionLoop update: markers {[(l.p0, l.p1) for l in got.markers]}, "
          f"ratio {got.meters_to_px_ratio:.6f}", flush=True)


def drag_frames(w: int, h: int, pan: bool = False) -> list:
    """A marker drag: the far end moves 8 px right and 5 px up per frame
    (at 1080p scale). pan=True also moves the scale legend 2 px right per
    frame, so the scales checksum changes every frame and the scales
    images stay inline (a static legend drops to checksum-only)."""
    from smh_tpu_torch import testing

    k = w // 1920
    (x0, y0), (x1, y1) = MARKER[0]
    frames = []
    for i in range(DRAG_FRAMES):
        sx = (60 + (2 * i if pan else 0)) * k
        frames.append(testing.make_frame(
            w, h,
            marker_lines=[((x0 * k, y0 * k), ((x1 + 8 * i) * k, (y1 - 5 * i) * k))],
            scale_texts=[("300m", (sx, 170 * k))],
            scale_bars=[(sx, 170 * k + 30, 120 * k, 1)],
        ))
    return frames


def summarize(r) -> tuple:
    return (
        tuple((l.p0.x, l.p0.y, l.p1.x, l.p1.y) for l in r.markers),
        r.meters_to_px_ratio,
        r.minimap_bounds,
    )


def _truth(dev: torch.device, frames: list, engine_factory=None) -> dict:
    """{summary of the synchronous result: frame index} over `frames`."""
    from smh_tpu.squadex.capture import Frame

    state = new_state(dev, engine=engine_factory() if engine_factory else None)
    try:
        truth = {summarize(state.process(Frame(f, 96))): i for i, f in enumerate(frames)}
    finally:
        state.close()
    require(len(truth) == len(frames), f"drag frames are not distinct: {len(truth)}")
    return truth


def _live_run(dev, frames, truth, threaded: bool, fps, want: int, engine_factory=None) -> tuple:
    """The pipelined VisionLoop over `frames` cycling until `want` updates
    (at most 120 s) -> (updates as (time, truth index or -1, ms since the
    loop took that frame), the backend, the launch counts of the run)."""
    from smh_tpu.squadex.capture import CaptureThread, Frame
    from smh_tpu_torch.ops import kernels as K
    from smh_tpu_torch.vision.pipeline import VisionLoop

    ids = {id(f): i for i, f in enumerate(frames)}
    t_take, t_up = {}, []

    class Cycle:
        def __init__(self):
            self.i = 0

        def grab(self):
            self.i += 1
            return Frame(frames[self.i % len(frames)], 96)

    def on_update(r, _debug):
        now = time.perf_counter()
        i = truth.get(summarize(r) if r is not None else None, -1)
        t_up.append((now, i, (now - t_take[i]) * 1e3 if i in t_take else None))

    state = new_state(dev, engine=engine_factory() if engine_factory else None)
    cap = CaptureThread(Cycle()).start()
    take = cap.fresh_frame

    def fresh_frame():
        f = take()
        if f is not None:
            t_take[ids[id(f.image)]] = time.perf_counter()
        return f

    cap.fresh_frame = fresh_frame
    loop = VisionLoop(state, cap, on_update, fps=fps or 1e6, pipelined=True, threaded_submit=threaded)
    K.reset_launches()
    loop.start()
    try:
        deadline = time.time() + 120
        while len(t_up) < want and time.time() < deadline:
            time.sleep(0.01)
    finally:
        loop.stop()
        cap.stop()
        state.close()
    torch.cuda.synchronize()
    return t_up, state.delegate.backend, dict(K.LAUNCHES)


def _steady(t_up: list, want: int) -> tuple:
    """(fps, [frame -> update ms]) over the window before stop(): stopping
    drains the pending frames in a burst, and the first 4 are warm-up."""
    steady = t_up[4:want]
    return (len(steady) - 1) / (steady[-1][0] - steady[0][0]), [ms for _, _, ms in steady]


def phase_live(dev: torch.device, card: str) -> dict:
    """The pipelined live loop at 1080p and 4K, threaded submit off and on,
    at the 15 FPS cap and uncapped."""
    from smh_tpu.squadex.capture import Frame
    from smh_tpu_torch.ops import kernels as K

    launches = {name: 0 for name in K.LAUNCHES}
    table = []
    errors = ErrorCount()
    logging.getLogger("smh_tpu").addHandler(errors)
    try:
        for w, h in LIVE_SIZES:
            frames = drag_frames(w, h)
            truth = _truth(dev, frames)

            # The submit half queues on the stream without a host sync: a
            # full upload on a fresh backend, then two deltas.
            state = new_state(dev)
            try:
                state.process(Frame(frames[0], 96))
                be = state.delegate.backend
                fresh = type(be)(dev)
                fresh.scales_device_ok = True
                torch.cuda.set_sync_debug_mode("error")
                try:
                    for b, f in ((fresh, frames[1]), (be, frames[2]), (be, frames[3])):
                        b.load_frame(f)
                        b.dispatch(grayscale=True)
                        b.snapshot_job()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                require(fresh.stats["full_uploads"] == 1 and be.stats["delta_frames"] == 2,
                        f"submit half: {fresh.stats} / {be.stats}")
            finally:
                state.close()
            print(f"live: {w}x{h} submit half (load_frame + dispatch + snapshot_job, full and delta) "
                  f"raised no sync under sync-debug mode 'error'", flush=True)

            for threaded in (False, True):
                for fps, want in LIVE_UPDATES:
                    n_err = len(errors.messages)
                    t_up, be, run = _live_run(dev, frames, truth, threaded, fps, want)
                    for name, n in run.items():
                        launches[name] += n
                    label = f"{w}x{h} threaded={threaded} fps={'uncapped' if fps is None else int(fps)}"
                    require(len(errors.messages) == n_err, f"{label}: frame errors {errors.messages[n_err:]}")
                    require(len(t_up) >= want, f"{label}: {len(t_up)} updates in 120 s")
                    bad = [i for _, i, _ in t_up if i < 0]
                    require(not bad, f"{label}: {len(bad)} updates outside the truth set")
                    require(len({i for _, i, _ in t_up}) >= DRAG_FRAMES // 2, f"{label}: low coverage")
                    require(all(run[n] > 0 for n in K.FUSED_PASS), f"{label}: skipped a kernel {run}")
                    st = dict(be.stats)
                    require(st["full_uploads"] == 1 and st["delta_frames"] > 0,
                            f"{label}: not one full upload then deltas: {st}")
                    rate, lat = _steady(t_up, want)
                    row = {
                        "res": f"{w}x{h}", "threaded": threaded,
                        "fps_cap": "uncapped" if fps is None else int(fps),
                        "updates": len(t_up), "fps": rate,
                        "p50_ms": percentile(lat, 0.5), "p90_ms": percentile(lat, 0.9),
                        "h2d_bytes_per_delta_frame": (st["h2d_bytes"] - be._mirror.size) / st["delta_frames"],
                        "full_uploads": st["full_uploads"], "delta_frames": st["delta_frames"],
                        "frame_errors": 0,
                    }
                    table.append(row)
                    print(f"live: {label}: {row['updates']} updates all in the truth set, "
                          f"{rate:.2f} fps, frame->update p50 {row['p50_ms']:.2f} ms p90 {row['p90_ms']:.2f} ms, "
                          f"H2D {row['h2d_bytes_per_delta_frame']:.0f} B per delta frame "
                          f"({st['delta_frames']} deltas, 1 full upload of {be._mirror.size} B), "
                          f"0 frame errors, launches {run} on {card}", flush=True)
    finally:
        logging.getLogger("smh_tpu").removeHandler(errors)
    print("live: " + json.dumps(table), flush=True)
    return launches


def phase_live_window(dev: torch.device, card: str) -> dict:
    """The panning drag, pipelined, threaded and uncapped, with SMH_SPARSE=0
    and the gray band (a Tesseract-flagged engine): window rungs and band
    gathers ride the submit half, which must not sync the host."""
    from smh_tpu.squadex.capture import Frame
    from smh_tpu_torch.ops import kernels as K

    launches = {name: 0 for name in K.LAUNCHES}
    want = 60
    errors = ErrorCount()
    logging.getLogger("smh_tpu").addHandler(errors)
    try:
        with sparse_off():
            for w, h in LIVE_SIZES:
                frames = drag_frames(w, h, pan=True)
                truth = _truth(dev, frames, tesseract_flagged)
                state = new_state(dev, engine=tesseract_flagged())
                try:
                    state.process(Frame(frames[0], 96))
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        for f in frames[1:4]:
                            job = state.submit(Frame(f, 96))
                            require(job is not None, "submit failed (see the log)")
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                    flags = job["job"]._dispatch_flags
                    require(flags.sparse is None and flags.inline == "gray" and flags.band is not None,
                            f"not the window + gray band route: {flags}")
                finally:
                    state.close()

                t_up, be, run = _live_run(dev, frames, truth, True, None, want, tesseract_flagged)
                for name, n in run.items():
                    launches[name] += n
                label = f"{w}x{h} SMH_SPARSE=0 gray band"
                require(not errors.messages, f"{label}: frame errors {errors.messages}")
                require(len(t_up) >= want, f"{label}: {len(t_up)} updates in 120 s")
                require(all(i >= 0 for _, i, _ in t_up), f"{label}: updates outside the truth set")
                require(be._dispatch_flags.inline == "gray", f"{label}: the scales left the gray band: {be._dispatch_flags}")
                st = dict(be.stats)
                rate, lat = _steady(t_up, want)
                print(f"live: {label}, threaded, uncapped: {len(t_up)} updates all in the truth set, "
                      f"{rate:.2f} fps, frame->update p50 {percentile(lat, 0.5):.2f} ms "
                      f"p90 {percentile(lat, 0.9):.2f} ms, window misses {st['lsd_window_misses']}, "
                      f"band misses {st['scales_band_misses']}, scalespack fetches {st['scalespack_fetches']}; "
                      f"the submit half raised no sync under 'error'; launches {run} on {card}",
                      flush=True)
    finally:
        logging.getLogger("smh_tpu").removeHandler(errors)
    return launches


def phase_app(dev: torch.device) -> dict:
    """`python -m smh_tpu_torch.app --synthetic --pipelined --no-web` without
    the signal handler: the CLI's source and flags, an update, a clean stop."""
    from smh_tpu import app as smh_app
    from smh_tpu.settings import Settings
    from smh_tpu_torch import app as tapp
    from smh_tpu_torch.ops import kernels as K

    args = tapp.build_parser().parse_args(["--synthetic", "--pipelined", "--no-web", "--device", str(dev)])
    settings = Settings(path=None)
    settings.set("hardware_acceleration", True, save=False)
    errors = ErrorCount()
    logging.getLogger("smh_tpu").addHandler(errors)
    K.reset_launches()
    app = tapp.App(
        smh_app._build_source(args), settings=settings, device=args.device,
        serve=not args.no_web, pipelined=args.pipelined, scales_async=not args.sync_scales,
    )
    updates = []
    deliver = app.loop.on_update

    def on_update(results, debug):
        updates.append(results)
        deliver(results, debug)

    app.loop.on_update = on_update
    try:
        app.start()
        deadline = time.time() + 120
        while not any(r is not None and len(r.markers) == 1 for r in updates) and time.time() < deadline:
            time.sleep(0.05)
    finally:
        app.stop()
        logging.getLogger("smh_tpu").removeHandler(errors)
    torch.cuda.synchronize()
    res = next((r for r in updates if r is not None and len(r.markers) == 1), None)
    require(res is not None, "the app delivered no update with one marker in 120 s")
    require(not errors.messages, f"the app logged errors: {errors.messages}")
    require(not app.loop._thread.is_alive() and not app.capture._thread.is_alive(), "the app did not stop")
    be = app.state.delegate.backend
    require(be.name == "cuda" and be.device.type == "cuda", "the app did not run the CUDA backend")
    require(all(K.LAUNCHES[n] > 0 for n in K.FUSED_PASS), f"the app skipped a kernel: {K.LAUNCHES}")
    print(f"app: smh_tpu_torch.app.App (synthetic, pipelined, async scales, engine "
          f"{type(app.ocr_engine).__name__}) delivered {len(updates)} updates, markers "
          f"{[(l.p0, l.p1) for l in res.markers]}, stats {be.stats}, launches {dict(K.LAUNCHES)}; "
          f"stopped cleanly", flush=True)
    return dict(K.LAUNCHES)


def main() -> int:
    if not torch.cuda.is_available():
        print("device: torch.cuda.is_available() is False; this smoke needs a CUDA device",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    card = card_line()
    print(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; nvidia-smi: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from smh_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load()
    print(f"build: {_build.lib_path()} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'})", flush=True)

    kernels = phase_kernels(dev)
    kernels["ray_march"] = phase_ray_march(dev)
    launches = phase_slice(dev)
    main_paths = [launches, phase_dense(dev), phase_transports(dev), phase_debug(dev), phase_device_engine(dev)]
    phase_timing(dev, card)
    phase_loop(dev)
    main_paths += [phase_live(dev, card), phase_live_window(dev, card), phase_app(dev)]
    require("jax" not in sys.modules, "the port imported jax")

    for name, entry in kernels.items():
        entry["launches"] = sum(p[name] for p in main_paths)
        require(entry["launches"] > 0, f"no main path launched {name}")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
