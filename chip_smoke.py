#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (smh_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA device. In phases,
each printing a line, each failing loudly:

  1. device  — requires torch.cuda.is_available(); prints the versions and
               the card's name and power limit (nvidia-smi);
  2. build   — compiles smh_tpu_torch/csrc/*.cu with nvcc for sm_90a (one
               nvcc per source, all started together) and the native host
               module (g++) from smh_tpu_torch/native/;
  3. kernels — each CUDA kernel against its plain PyTorch version on the
               card at the main path's shapes (exact): the classify tables
               against their plain twin; the classify and fused mask
               kernels over the whole 256^3 colour cube (classify against
               the numpy oracle too), on planes 1-15 bytes past an aligned
               address, and in the main path's layout (three views of one
               flat buffer) on random planes and on the verify frame's map
               ROI, each timed on both with the share of pixels past the
               max-byte mask; the quiet walk at
               the walk's gate edge cases (maps under 8 px, a run range
               starting below 3, empty run ranges, all-quiet and all-edgy
               maps) and around its tile seams with B = 3, the fused mask
               kernel at ragged widths with markers in the last column and
               across its tile seams, the ray march on masks at both map
               sizes with border, background and line seeds and lines
               that touch the border (B = 1, 8 and 16, max_gap 15 and 31,
               with and without max_len: ends, winners and lengths
               bit-equal; one CUDA launch per call); each with its
               wrapper's CUDA-event time beside
               its bound (bytes over 3.35 TB/s, operations over 67 T/s), its
               plain version's time, and its device time per call
               (profiler);
     scales_read — kernel 5, the scales read, against its plain version:
               every record lane equal but the glyph scores (within 1; the
               count of differing score lanes printed) on the edge cases of
               testing.scales_read_cases (one at a time, and B = 1, 3 and 8
               at a time from strided buffers), random words, bars and
               blobs, the verify frame's BRQ at 1080p and 4K, the BRQs of
               the seven screen sizes (one frame and B = 3), and B = 1, 3
               and 8 frames cut from the rows of one buffer (== the
               per-frame kernel too); one CUDA launch per call; wrapper ms,
               device us and plain ms at the 1080p and 4K BRQs, device us
               per batch at B = 8, beside the bound and the chain floor
               (probe_scales_read.chain_floor: its patched builds time each
               dependent step of the cluster's chain);
     brq_preprocess — kernel 6, the quadrant's text preprocess, against its
               plain twin (every output bit-equal: ocr_img, the text and
               scales planes, the scales bits, the checksums) on
               testing.brq_preprocess_cases (ragged widths, strict pixels
               by the last rows and columns, the seams of its 16 x 124
               tiles, dense planes; contiguous and as windows of a padded
               plane), windows whose start column and row pitch take every
               value mod 16 (R, G, B and the luma each their own), shapes
               around the tiles and their R halo, random planes at both
               quadrant shapes, the mesh's row bands (edges on the tiles'
               row seams; every output == the whole quadrant's rows), the
               verify frame's quadrant at 1080p and 4K, the seven screen
               sizes' quadrants (one and B = 3), and B = 1, 3 and 8
               quadrants of rows one buffer apart, the luma's an odd stride
               apart too (== the per-frame kernel); one CUDA launch per call
               and no memset (profiler); timed at both quadrants and at B =
               8 beside its bound (its chain floor: probe_brq_preprocess);
     mask_words — kernel 7, the marker mask's bbox and sparse words,
               against its plain twin (every lane) on
               testing.mask_bits_cases (empty, full, corners, nz around the
               budget, ragged widths, rows of 0-3 mod 4 bytes, words on both
               sides of its tiles' seams, nz = budget - 1, budget, budget +
               1 with the budget-th word at a seam) at budgets 0, 1, 64 and
               256, the verify frame's mask bits, random masks at every
               sparse rung (a dense 4K mask among them), rows of 0-3 mod 4
               bytes and words at every tile seam at the map shapes, and B
               = 1, 3 and 8 planes of one buffer (== the per-frame kernel);
               one launch per call; timed at both map shapes and at B = 8
               beside its bound (its chain floor: probe_mask_words);
     delta_apply — kernel 8, the delta apply, against its plain twin
               (every byte of every row; the resident buffer unchanged) at
               the 1080p and 4K frames' buffers: no change (one repeated
               index), chunk 0, the last chunk, every chunk, 1000 chunks
               padded by repeats, the ladder's top bucket, and chains of B
               = 1, 3 and 8 frames (chunk 40 written by frames 0 and 2);
               one launch per call, no memset (profiler); timed per frame
               and at B = 8 beside its bound, its plain twin (the eager
               copy and index_copy_ it replaced) and torch.index_copy;
     hostpack — kernel 9, the ui checksum, the red gate and the hostpack,
               against its plain twin (every byte): all-255 4K planes (the
               weighted u32 sum wraps), gray and colour, 1-row, 1-column,
               unaligned and interleaved planes, the button shapes of the
               seven screen sizes and 4K with 0, 1, n - 1 and n red pixels,
               the table of every route of the fused pass (recorded from
               the pass on the card) and of the batch routes at B = 1, 3
               and 8; one launch per call, no memset; timed on the main
               path's table at 1080p, 4K and B = 8 beside its bound, its
               plain twin and torch.cat of the parts;
     window_crop — kernel 10, the window crop, against its plain twin
               (meta and window bits, every byte) on
               testing.window_crop_cases (an empty mask, the bbox at each
               border, the origin's column at every value mod 8, ragged
               crop widths, one full dimension each way), random masks at
               both map shapes at every pair of the window ladder's rungs,
               the verify frame's mask at 1080p and 4K, and B = 1, 3 and 8
               masks of one buffer, an origin per frame (== the per-frame
               kernel); one launch per call, no memset; timed at the
               half-size windows and at B = 8 beside its bound;
     ocr_band — kernel 11, the OCR row band and the keep bits, against
               its plain twin (every section) banded (binary and gray) and
               unbanded on testing.ocr_band_cases (textless, text on the
               first or last row, band == h, a single pixel, text at the
               cluster's strip seams, ragged widths), kernel 6's outputs at
               both quadrant shapes at every band rung, the verify frame's
               quadrant at 1080p and 4K, and B = 1, 3 and 8 quadrants of one
               buffer (== the per-frame kernel); one launch per call, no
               memset; timed on the verify frame's gray band and on B = 8
               unbanded keep bits beside its bound;
     repeated — kernels 6, 7 and 9, 100 calls each in turns over shapes,
               batch sizes and budgets (every tenth on a second stream),
               each == its plain twin: the scratch each keeps between
               launches comes back clean;
  4. slice   — the port's VisionState on 1080p and 4K frames with a marker
               line and a "300m" scale: markers, ratio and minimap against
               the numpy oracle, the on-device scales read, every kernel
               launched once per pass by the main path, and the hostpack
               bytes against the same backend on the CPU (plain versions);
               then a
               dense-marker sequence until the sparse transport steps
               aside, its full-plane hostpacks (kernel 3's bytes) against
               the CPU path;
  5. transports — with SMH_SPARSE=0 at 1080p and 4K: the window route
               (fit, miss -> full-plane fetch -> escalation), the gray band
               under a Tesseract-flagged engine and the binary band under
               smhocr without the device read; hostpacks equal the same
               backend's CPU path, and the OCR and scales images handed to
               the engine equal the numpy oracle's (the scales image in the
               band's rows, background outside), kernels 10 and 11
               launched; prints D2H bytes per frame;
     debug   — every debug view with the debug re-pass equals the CPU
               path's;
     engine  — lsd_engine="cuda" (the device ray march) gives markers
               within 1.5 px of the oracle;
  6. timing  — p50 of process() over warm frames at 1080p and 4K: smhocr's
               device read with the native and the cuda LSD engine (and
               the latter's ray_march launches per frame), and a
               Tesseract-flagged engine on a static frame and over the drag;
               CUDA launches (kernels and memset/copy rows) and device
               time per sync frame (profiler), one launch of each kernel
               of the pass and of the delta apply, at most 10 kernels;
     routes  — with SMH_SPARSE=0, CUDA rows per sync frame (profiler) of
               the window + gray band and window + binary band routes:
               kernels 1-3 and 6-11 once each, 9 kernels, at most 3
               memset/copy rows; per delta batch of BatchPipeline(batch=8)
               with its window and the binary keep bits, over a drag that
               stays in the window: the same 9 kernels once each, at most
               3 memset/copy rows;
  7. loop    — CaptureThread -> VisionLoop delivers an update;
  8. live    — the pipelined VisionLoop (delta upload, consume views, async
               fetch) over a cycling marker-drag sequence at 1080p and 4K,
               threaded submit off and on, at the 15 FPS cap and uncapped:
               every update equals the synchronous result of some input
               frame, no frame error is logged, one full upload per chain,
               and the submit half runs under sync-debug mode "error";
               prints fps, H2D bytes per delta frame and frame -> update
               p50/p90; then, threaded and uncapped, the drag with a panning
               scale legend, SMH_SPARSE=0 and the gray band (the window crop
               and the band, kernels 10 and 11, in the submit half, also
               under "error");
  9. app     — smh_tpu_torch.app.App on the CLI's synthetic source,
               pipelined with async scales, delivers an update and stops;
 10. batch kernels — kernels 1-3, 6 and 7 over a whole batch in one
               launch: B = 1, 3 and 8 frames cut from the rows of a [B, padded] buffer (and
               rows one byte longer: odd frame strides) at the 1080p and 4K
               map shapes, each torch.equal to its plain version and to the
               per-frame kernel frame by frame; one kernel launch per
               batched call (profiler rows); device us per call at B = 1, 3
               and 8 and per frame;
 11. batch   — BatchPipeline(batch=8) with smhocr over the marker drag at
               1080p and 4K: a full batch, then delta batches; results equal
               to the per-frame VisionState's and to the oracle's; stream()
               equals process(); CUDA launches per delta batch (profiler:
               each kernel of the pass and the delta apply once, at most 10
               kernels), H2D bytes per batch, frames/s of process() and
               stream();
 12. mesh    — the multi-device path (smh_tpu_torch/parallel/) on a mesh
               of cuda:0 repeated (and of distinct cards where there are
               two or more): kernel 4 over a batch of masks (B = 1, 3, 8 at
               both map shapes) bit-equal to its plain version and to the
               single-mask kernel, one launch per call, its device us beside
               8 seeds on one mask; analyze_batch at 1080p on (dp, sp) =
               (2, 2) and (1, 3) (kernels 1 and 3 on row blocks with
               halos) equal to the unsharded analyze_frame on the CPU, the
               kernels' plain versions; full_step's winners; the dry run's
               full_step check; BatchPipeline(batch=8) over the drag on
               dp = 4 equal to one device, kernels 1-3 at dp launches per
               batch, frames/s beside one device's;
 13. warmup  — two child processes, with and without ops/warmup.py: the
               first process() ms of each; after the warmup the first frame
               builds nothing and launches no table kernel;
 14. worker  — WorkerClient at 1080p on the card: the ready event, a child
               that imports neither jax nor smh_tpu, a recycle and the
               recovery, results equal to the in-process state's; then the
               CLI's App with --worker delivers an update;
 15. resolutions — (run after the batch kernels) one VisionState on the card
               resizing mid-stream through 1024x768, 1280x1024, 1600x900,
               1366x768, 2560x1440, 3440x1440 and 1920x1080: markers, ratio
               and minimap equal to the oracle's, hostpack bytes equal to a
               CPU state's, lsd_engine="cuda" against the oracle at 1024x768
               and 3440x1440; kernels 1-3, 6 and 7 at each map shape
               bit-equal to their plain versions per frame and at B=3,
               their device us beside their bound;
 16. tools   — (run after the mesh) the operator entry points of
               smh_tpu_torch/tools/: analyze_video's frame function over the
               video goldens (24 frames 5 times at B=8, frames/s after the
               first batch) and over a
               1600x900 drag (== the per-frame state), compare_backends on
               the verify frame's PNG (RESULT: PASS), render_detections'
               cuda PNG == its numpy PNG.

The last lines are a JSON object with the per-kernel results, the card's
name and power limit, and {"ok": true, "device": {...}}. Any failed check
raises, so the script exits non-zero and prints no result. Imports neither
JAX nor the JAX package smh_tpu.
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import math
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
# The card's peaks for a kernel's bound (NVIDIA's H100 SXM data sheet at
# 700 W): device memory bytes per second, and float32 operations per second
# outside the tensor cores (the rate integer work is counted against too).
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
# Operations per pixel each function needs: the quiet mask's 4 symmetric
# 3-channel SAD terms (sub, abs, add) with their compares and ANDs. The
# classify's depend on the data: (every pixel, each pixel whose max byte
# passes the value mask) -- the max, min and mask test, then the HSV and
# colour tests; classify_luma adds the luma to the first, fused_mask the
# cross dilate and the bit pack.
OPS_PER_PX = {"quiet_walk": 40, "brq_preprocess": 40, "mask_words": 8}
# The kernels every fused pass launches whatever the OCR engine: the
# scales read (kernel 5) runs only where smhocr reads the scales on the
# card (K.FUSED_PASS holds all six).
EVERY_PASS = ("classify_luma", "quiet_walk", "fused_mask", "brq_preprocess", "mask_words")
# The budget kernel 7 is checked and timed at outside the main path: the
# sparse ladder's starting rung (vision/cuda_backend.py::_SPARSE_BUDGETS
# [_SP_RUNG_DEFAULT]), which holds the verify frame's mask at 1080p and 4K.
MASK_BUDGET = 1024
CLASSIFY_OPS = {"classify_luma": (12, 30), "fused_mask": (10, 30)}
# Kernels a sync delta frame and a delta batch may launch: the seven of the
# pass, the delta apply and at most two more.
MAX_KERNELS_PER_PASS = 10
# Kernels 10 and 11 as their design before this one ran (a byte a thread;
# device us on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md's kernel table),
# printed beside this build's.
BYTEWISE_US = {"window_crop": "1.43-1.44 / 1.64-1.65, B=8 1.94-1.95",
           "ocr_band": "gray band 4.95-5.24 / 8.29-8.33, unbanded B=8 7.95-8.27"}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def tesseract_flagged():
    """smhocr's reader under Tesseract's transport flags (binary_ok False,
    image_derived True, no device read): the gray band route. The card's
    machine has no libtesseract."""
    from smh_tpu_torch.ocr.smhocr import SmhOcrEngine

    class TesseractFlagged(SmhOcrEngine):
        binary_ok = False
        image_derived = True
        device_ok = False

    return TesseractFlagged()


class environ:
    """Environment variables set for the duration of a block."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.before = {k: os.environ.get(k) for k in self.values}
        os.environ.update(self.values)

    def __exit__(self, *exc):
        for k, v in self.before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def sparse_off() -> environ:
    """SMH_SPARSE=0 (the window transport) for the duration of a block."""
    return environ(SMH_SPARSE="0")


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


def kernel_bytes(name: str, map_h: int, map_w: int, budget: int = MASK_BUDGET) -> int:
    """The bytes one frame's call of a kernel of the fused pass must move
    at a map shape: each input read once, each output written once."""
    n_px, bits = map_h * map_w, map_h * ((map_w + 7) // 8)
    q_px, q_bits = (map_h // 2) * (map_w // 2), (map_h // 2) * ((map_w // 2 + 7) // 8)
    return {
        "classify_luma": 5 * n_px,
        "fused_mask": 3 * n_px + bits,
        "quiet_walk": 3 * n_px + 16,
        # R, G, B and luma in; ocr, text, sbool and the scales bits out; 16 B of checks
        "brq_preprocess": 7 * q_px + q_bits + 16,
        # the bit plane in; the bbox, nz and the budget's idx and dat out
        "mask_words": bits + 4 * (7 + 2 * budget),
    }[name]


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


SPINS = 20  # spin kernels before and after each profiled run


def device_profile(fn, n: int = 20, names=(), tries: int = 4) -> dict:
    """torch.profiler over n calls of fn(), after one warm call. Per call:
    `us`, the device time of the rows that ran on the card; `launches`,
    those rows (kernels, memsets, copies); `kernels` and `kernel_us`, the
    kernels among them and their time; `named` and `named_us`, {name:
    launches and device time of the kernels whose name holds
    `name`_kernel}. A trace loses the records
    that come first (on an H100: 2 as a rule; after traces of thousands of
    launches, up to all of them), so the calls sit between two runs of
    SPINS spin kernels (torch.cuda._sleep), left out of every count. A
    loss at either edge that reaches the calls takes at least SPINS spin
    kernels with it, so a trace is taken again when it holds SPINS or
    fewer, or fewer kernels than calls (every fn() launches one)."""
    from torch.profiler import ProfilerActivity, profile

    def spin():
        for _ in range(SPINS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    fn()
    torch.cuda.synchronize()
    for t in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            spin()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            spin()
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        spins = sum(e.count for e in events if "spin_kernel" in e.key)
        rows = [e for e in events if "spin_kernel" not in e.key]
        kernels = [e for e in rows if not e.key.startswith(("Memcpy", "Memset"))]
        if spins > SPINS and sum(e.count for e in kernels) >= n:
            break
        print(f"device_profile: trace {t + 1} of {tries} held {spins} of {2 * SPINS} spin kernels and "
              f"{sum(e.count for e in kernels)} kernels for {n} calls", flush=True)
    return {
        "us": sum(e.self_device_time_total for e in rows) / n,
        "launches": sum(e.count for e in rows) / n,
        "kernels": sum(e.count for e in kernels) / n,
        "kernel_us": sum(e.self_device_time_total for e in kernels) / n,
        "named": {name: sum(e.count for e in kernels if f"{name}_kernel" in e.key) / n for name in names},
        "named_us": {name: sum(e.self_device_time_total for e in kernels if f"{name}_kernel" in e.key) / n
                     for name in names},
        "rows": {e.key: e.count / n for e in rows if e not in kernels},
    }


def device_us(fn, n: int = 20) -> float:
    """Device time per call of fn() (us)."""
    return device_profile(fn, n)["us"]


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


def timing_line(t: dict) -> str:
    return (f"wrapper {t['ms']:.4f} ms (device {t['device_us']:.2f} us per call) beside its bound "
            f"{t['bound_ms']:.5f} ms ({t['bound_by']}); plain {t['plain_ms']:.4f} ms")


def percentile(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def mask_share(rgb: np.ndarray) -> float:
    """Share of the pixels whose max byte passes the classify's value mask
    (a non-zero byte of the tables' vib[256], after the f32 unit[256]): the
    pixels the classify takes past its early-out."""
    from smh_tpu_torch.ops import kernels as K

    vib = K.classify_tables_plain()[1024:1280]
    return float((vib[rgb.max(axis=-1)] != 0).mean())


def flat_planes(rgb: np.ndarray, dev: torch.device):
    """(r, g, b) as the main path lays them out: B, G, R planes of one flat
    buffer at k * H * W (ops/pipeline.py::analyze_packed_flat)."""
    h, w, _ = rgb.shape
    bgr = np.ascontiguousarray(np.moveaxis(rgb[..., ::-1], -1, 0))
    planes = torch.from_numpy(bgr).to(dev)
    return planes[2], planes[1], planes[0]


def offset_planes(rgb: np.ndarray, dev: torch.device, offset: int):
    """(r, g, b), each plane in its own buffer `offset` bytes past an
    aligned address."""
    out = []
    for c in range(3):
        flat = torch.zeros(rgb[..., c].size + offset, dtype=torch.uint8, device=dev)
        flat[offset:] = torch.from_numpy(np.ascontiguousarray(rgb[..., c])).reshape(-1).to(dev)
        out.append(flat[offset:].view(rgb.shape[:2]))
    return out


def map_inputs(rng, w: int, h: int) -> dict:
    """The two inputs each classify kernel is timed on at a map shape:
    uniform random planes and the verify frame's map ROI (RGB)."""
    from smh_tpu_torch import consts as C

    gm = C.map_geometry(w, h)
    frame = frame_for(w, h)
    roi = frame[gm.map_y : gm.map_y + gm.map_h, gm.map_x : gm.map_x + gm.map_w, 2::-1]
    return {
        "random": rng.integers(0, 256, (gm.map_h, gm.map_w, 3), dtype=np.uint8),
        "verify frame": np.ascontiguousarray(roi),
    }


def phase_kernels(dev: torch.device) -> dict:
    from smh_tpu_torch import consts as C
    from smh_tpu_torch.vision import pixmath
    from smh_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(0)
    results = {}
    inputs = {(w, h): map_inputs(rng, w, h) for w, h in ((1920, 1080), (3840, 2160))}

    # -- the classify tables, then kernel 1: the cube, offsets, map shapes ---
    from smh_tpu_torch import _build

    tables = K._classify_tables(_build.load(), dev).cpu().numpy()
    require(np.array_equal(tables, K.classify_tables_plain()), "classify tables != plain")
    print(f"kernels: classify tables ({tables.size} B: k/255 by __fdiv_rn, the max-byte mask, the colour "
          f"tests) == plain", flush=True)
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

    def check_classify(p, label: str) -> None:
        nonlocal err
        mk, lk = K.classify_luma_planes(*p)
        mp, lp = K.classify_luma_planes_plain(*p)
        err = max(err, int((mk.int() - mp.int()).abs().max()), int((lk.int() - lp.int()).abs().max()))
        require(err == 0, f"classify kernel != plain ({label})")

    odd_shapes = ((37, 263), (2 * K.FUSED_TILE_H + 3, 987), (5, 13))  # n % 4 = 3, 1, 1
    for offset in range(1, 16):
        for h, w in odd_shapes:
            check_classify(offset_planes(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), dev, offset),
                           f"offset {offset} {h}x{w}")
    print(f"kernels: classify_luma exact on planes 1-15 bytes past an aligned address at {odd_shapes}",
          flush=True)
    times = {}
    for (w, h), ins in inputs.items():
        gm = C.map_geometry(w, h)
        n_px = gm.map_h * gm.map_w
        for name, rgb in ins.items():
            p = flat_planes(rgb, dev)
            check_classify(p, f"{gm.map_h}x{gm.map_w} {name}, main-path layout")
            share = mask_share(rgb)
            base, hsv_ops = CLASSIFY_OPS["classify_luma"]
            t = {
                "ms": cuda_ms(lambda: K.classify_luma_planes(*p)),
                "plain_ms": cuda_ms(lambda: K.classify_luma_planes_plain(*p)),
                "device_us": device_us(lambda: K.classify_luma_planes(*p)),
                **bound(5 * n_px, (base + hsv_ops * share) * n_px),  # 3 B read + 2 B written
            }
            print(f"kernels: classify_luma {gm.map_h}x{gm.map_w} {name} (main-path layout; {100 * share:.2f} % "
                  f"of pixels pass the max-byte mask) exact; " + timing_line(t), flush=True)
            if name == "random":
                times[h] = t
    results["classify_luma"] = {
        "name": "classify_luma", "route": "cuda",
        "source": "smh_tpu_torch/csrc/classify_luma.cu",
        "replaces": "smh_tpu/ops/pallas_kernels.py:42",
        "max_abs_err": err, **times[1080], "library_ms": None, "shape": "822x986",
    }

    # -- kernel 2: gate edge cases, the tile seams, B=3, the map shapes --------
    th, tw = K.QUIET_TILE_H, K.QUIET_TILE_W
    err = 0

    def planes_for(views, offset: int = 0):
        """Channel planes of BGR views; offset > 0 starts each plane that many
        bytes into a larger buffer, so its rows sit at odd addresses."""
        out = []
        for c in range(3):
            flat = torch.zeros(views[..., c].size + offset, dtype=torch.uint8, device=dev)
            flat[offset:] = torch.from_numpy(np.ascontiguousarray(views[..., c])).reshape(-1).to(dev)
            out.append(flat[offset:].view(views.shape[:3]))
        return out

    def check_rect(views, label, offset: int = 0):
        nonlocal err
        p = planes_for(views, offset)
        got = K.minimap_rect_planes(*p)
        want = K.minimap_rect_planes_plain(*p)
        require(got.shape == want.shape and got.dtype == torch.int32, f"quiet_walk shape/dtype ({label})")
        err = max(err, int((got - want).abs().max()))
        require(err == 0, f"quiet_walk kernel != plain ({label}): {got.tolist()} vs {want.tolist()}")
        return p, got

    def minimap_views(h: int, w: int, trial: int) -> np.ndarray:
        """B=3: a quiet box over the centre, a minimap-like layout (an edgy
        centre inside a quiet surround), and an all-edgy checkerboard."""
        views = rng.integers(0, 256, (3, h, w, 3), dtype=np.uint8)
        y0, x0 = h // 4, w // 4
        views[0, y0 : h - y0, x0 : w - x0] = 120 + trial
        inner = views[1, h // 5 : h - h // 5, w // 5 : w - w // 5].copy()
        views[1] = 90 + trial
        views[1, h // 5 : h - h // 5, w // 5 : w - w // 5] = inner
        views[2] = 0
        views[2, ::2, ::2] = views[2, 1::2, 1::2] = 255
        return views

    # Maps under 8 px, a run range starting below 3 (h = 7), empty run ranges
    # (h = 6), then all-quiet maps, each with the B=3 layouts above.
    for trial, (h, w) in enumerate(((5, 40), (40, 6), (3, 3), (1, 9), (7, 50), (6, 33), (45, 70))):
        views = minimap_views(h, w, trial)
        _, got = check_rect(views, f"edge {h}x{w}")
        quiet = np.full((3, h, w, 3), 77, np.uint8)
        check_rect(quiet, f"all-quiet {h}x{w}")
    print(f"kernels: quiet_walk exact at the gate edge cases (h or w < 8, lo < 3, hi <= lo, all-quiet, "
          f"all-edgy), B=3", flush=True)
    seams = sorted({th - 1, th, th + 1, 2 * th + 1, 3 * th - 1, int(0.7 * th), 4 * th - 5, int(rng.integers(30, 300))})
    for trial, h in enumerate(seams):
        for w in (tw - 1, tw, tw + 1, 2 * tw + 3, int(rng.integers(40, 400)) | 1):
            check_rect(minimap_views(h, w, trial), f"seams {h}x{w}")
    print(f"kernels: quiet_walk exact at heights {seams} x widths around the {th}x{tw} tile, B=3", flush=True)
    for offset in (1, 2, 3):
        for trial, (h, w) in enumerate(((th + 1, tw + 3), (2 * th + 5, 3 * tw - 1), (822, 986))):
            check_rect(minimap_views(h, w, trial), f"offset {offset} {h}x{w}", offset)
    print("kernels: quiet_walk exact on planes that start 1, 2 and 3 bytes past an aligned address, B=3",
          flush=True)
    times = {}
    for w, h in ((1920, 1080), (3840, 2160)):
        gm = C.map_geometry(w, h)
        frame = frame_for(w, h)
        roi = frame[gm.map_y : gm.map_y + gm.map_h, gm.map_x : gm.map_x + gm.map_w, :3]
        noisy = roi.copy()
        cy0, cx0 = gm.map_h // 5, gm.map_w // 5
        noisy[cy0:-cy0, cx0:-cx0] = rng.integers(0, 256, noisy[cy0:-cy0, cx0:-cx0].shape, dtype=np.uint8)
        edgy = minimap_views(gm.map_h, gm.map_w, 0)[2]
        _, got3 = check_rect(np.stack([roi, noisy, edgy]), f"{gm.map_h}x{gm.map_w} B=3")
        p1, _ = check_rect(roi[None], f"{gm.map_h}x{gm.map_w} B=1")
        p2, _ = check_rect(np.stack([roi, noisy]), f"{gm.map_h}x{gm.map_w} B=2")
        n_px = gm.map_h * gm.map_w
        row = {}
        for bsz, p in ((1, p1), (2, p2)):
            row[bsz] = {
                "ms": cuda_ms(lambda: K.minimap_rect_planes(*p)),
                "plain_ms": cuda_ms(lambda: K.minimap_rect_planes_plain(*p)),
                "device_us": device_us(lambda: K.minimap_rect_planes(*p)),
                **bound(bsz * (3 * n_px + 16), bsz * OPS_PER_PX["quiet_walk"] * n_px),  # 3 B/px read, 16 B out
            }
            print(f"kernels: quiet_walk {gm.map_h}x{gm.map_w} B={bsz} exact; " + timing_line(row[bsz]), flush=True)
        times[h] = row[1]
        print(f"kernels: quiet_walk {gm.map_h}x{gm.map_w} B=3 rects {got3.cpu().tolist()}", flush=True)
        if h == 1080:  # the redesign's target for the wrapper (not a check: host time varies)
            print(f"kernels: quiet_walk B=2 wrapper {row[2]['ms']:.4f} ms "
                  f"{'within' if row[2]['ms'] <= 0.1 else 'ABOVE'} the 0.1 ms target", flush=True)
    results["quiet_walk"] = {
        "name": "quiet_walk", "route": "cuda",
        "source": "smh_tpu_torch/csrc/quiet_walk.cu",
        "replaces": "smh_tpu/ops/pallas_kernels.py:321",
        "max_abs_err": err, **times[1080], "library_ms": None, "shape": "1x822x986",
    }

    # -- kernel 3: the cube, ragged widths, tile seams, the map shapes ---------
    err = 0

    def check_mask(rgb: np.ndarray, label: str, planes=None):
        nonlocal err
        p = planes or [torch.from_numpy(np.ascontiguousarray(rgb[..., c])).to(dev) for c in range(3)]
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
        for w in (tw - 1, tw, tw + 1, 2 * tw + 3, tw + 31, tw + 33):
            rgb = np.full((h, w, 3), 40, dtype=np.uint8)
            rgb[max(th - 2, 0) : th + 2, tw - 3 : min(tw + 3, w)] = ALPHA_BGRA[2::-1]  # across both seams
            rgb[max(th - 2, 0) : th + 2, 30:34] = ALPHA_BGRA[2::-1]  # across a word seam inside the tile
            rgb[h - 1, w - 1] = rgb[0, 0] = ALPHA_BGRA[2::-1]
            check_mask(rgb, f"seams {h}x{w}")
    print(f"kernels: fused_mask exact at ragged widths {ragged} with last-column markers and "
          f"across the {th}x{tw} tile seams and a word seam", flush=True)
    for offset in range(1, 16):
        for h, w in odd_shapes:
            rgb = marker_rich(h, w)
            check_mask(rgb, f"offset {offset} {h}x{w}", offset_planes(rgb, dev, offset))
    print(f"kernels: fused_mask exact on planes 1-15 bytes past an aligned address at {odd_shapes}", flush=True)
    times = {}
    for (w, h), ins in inputs.items():
        gm = C.map_geometry(w, h)
        n_px = gm.map_h * gm.map_w
        rich = marker_rich(gm.map_h, gm.map_w)
        check_mask(rich, f"{gm.map_h}x{gm.map_w} marker-rich, main-path layout", flat_planes(rich, dev))
        for name, rgb in ins.items():
            p, _ = check_mask(rgb, f"{gm.map_h}x{gm.map_w} {name}, main-path layout", flat_planes(rgb, dev))
            share = mask_share(rgb)
            base, hsv_ops = CLASSIFY_OPS["fused_mask"]
            t = {
                "ms": cuda_ms(lambda: K.fused_mask_bits(*p)),
                "plain_ms": cuda_ms(lambda: K.fused_mask_bits_plain(*p)),
                "device_us": device_us(lambda: K.fused_mask_bits(*p)),
                # 3 B/px read, the bit plane written
                **bound(3 * n_px + gm.map_h * ((gm.map_w + 7) // 8), (base + hsv_ops * share) * n_px),
            }
            print(f"kernels: fused_mask {gm.map_h}x{gm.map_w} {name} (main-path layout; {100 * share:.2f} % of "
                  f"pixels pass the max-byte mask) exact; " + timing_line(t), flush=True)
            if name == "random":
                times[h] = t
    results["fused_mask"] = {
        "name": "fused_mask", "route": "cuda",
        "source": "smh_tpu_torch/csrc/fused_mask.cu",
        "replaces": "smh_tpu/ops/pallas_kernels.py:155",
        "max_abs_err": err, **times[1080], "library_ms": None, "shape": "822x986",
    }
    return results


def brq_planes(frame: np.ndarray) -> tuple:
    """(text, sbool) bool planes of a BGRA frame's BRQ as the fused pass
    makes them, from the numpy oracle: the OCR text mask and the scales
    binarize (False = black)."""
    from smh_tpu_torch import consts as C
    from smh_tpu_torch.ocr.engine import OCR_BINARY_THRESHOLD
    from smh_tpu_torch.vision import pixmath

    g = C.map_geometry(frame.shape[1], frame.shape[0])
    brq = np.ascontiguousarray(frame[g.brq_y : g.brq_y + g.brq_h, g.brq_x : g.brq_x + g.brq_w, 2::-1])
    return pixmath.ocr_preprocess(brq) < OCR_BINARY_THRESHOLD, pixmath.find_scales_binarize(brq) != 0


def random_scales_planes(rng, h: int, w: int) -> tuple:
    """(text, sbool) of h x w: random "<n>m" words (real glyphs, 12-24 px)
    with |----| bars below most of them, text-like noise blobs, and a
    background whose black pixels come in runs of every length."""
    from smh_tpu_torch import testing

    text = rng.random((h, w)) < 0.002
    sbool = rng.random((h, w)) < 0.9
    for _ in range(int(rng.integers(1, 12))):
        glyphs = testing.render_text_mask(f"{int(rng.integers(1, 10000))}m", int(rng.integers(12, 25))) != 0
        gh, gw = glyphs.shape
        if gh + 8 >= h or gw + 2 >= w:
            continue
        y, x = int(rng.integers(0, h - gh - 6)), int(rng.integers(0, w - gw))
        text[y : y + gh, x : x + gw] |= glyphs
        if rng.random() < 0.8:
            by, x0, x1 = y + gh + int(rng.integers(0, 5)), max(x - int(rng.integers(0, 20)), 0), min(x + gw + 20, w - 1)
            sbool[by, x0 : x1 + 1] = False
            sbool[by : by + 4, x0] = sbool[by : by + 4, x1] = False
    for _ in range(int(rng.integers(0, 20))):
        bh, bw = int(rng.integers(1, 30)), int(rng.integers(1, 20))
        y, x = int(rng.integers(0, h)), int(rng.integers(0, w))
        text[y : y + bh, x : x + bw] = True
    return text, sbool


def phase_scales_read(dev: torch.device) -> dict:
    """Kernel 5 (csrc/scales_read.cu) against its plain version on the
    card: every lane equal but the glyph scores, which may differ by 1 (the
    192-term sums and the template dots sum in another order; the count of
    differing score lanes is printed), on the edge cases of
    testing.scales_read_cases (also B = 1, 3 and 8 of them at a time from
    strided buffers), random planes, the verify frame's BRQ at 1080p and
    4K, the BRQs of the seven screen sizes, and B = 1, 3 and 8 frames cut
    from the rows of one buffer (odd strides; == the per-frame kernel too);
    one CUDA launch per call (profiler); timed at the 1080p and 4K BRQs and
    per batch at B = 8 beside the bound and the chain floor."""
    from smh_tpu_torch import testing
    from smh_tpu_torch.ops import kernels as K
    from smh_tpu_torch.ops import scales_device as sd

    rng = np.random.default_rng(10)
    tpl = sd.templates_to_device(sd.device_templates(), dev)
    n_tpl = tpl.shape[0]
    score = torch.from_numpy(sd.score_lanes()).to(dev)
    stats = {"calls": 0, "records": 0, "score_lanes_off": 0, "max_abs_err": 0}

    # templates 4 bytes past an aligned address: the wrapper refuses them and launches nothing
    odd = torch.empty(tpl.numel() + 1, dtype=tpl.dtype, device=dev)[1:].view_as(tpl)
    odd.copy_(tpl)
    blank, before = torch.zeros((20, 40), dtype=torch.bool, device=dev), K.LAUNCHES["scales_read"]
    try:
        sd.scales_records(blank, blank, odd)
        refused = False
    except ValueError:
        refused = True
    require(refused and K.LAUNCHES["scales_read"] == before, "scales_read took templates at an unaligned address")

    def on_card(text, sbool):
        return torch.from_numpy(np.ascontiguousarray(text)).to(dev), torch.from_numpy(np.ascontiguousarray(sbool)).to(dev)

    def check(t, s, label: str) -> torch.Tensor:
        before = K.LAUNCHES["scales_read"]
        got = sd.scales_records(t, s, tpl)
        require(K.LAUNCHES["scales_read"] == before + 1, f"scales_read: not one launch for {label}")
        want = sd.scales_records_plain(t, s, tpl)
        require(got.shape == want.shape and got.dtype == torch.int16, f"scales_read shape/dtype ({label})")
        g_, w_ = got.reshape(-1, sd.REC_I16).int(), want.reshape(-1, sd.REC_I16).int()
        require(torch.equal(g_[:, ~score], w_[:, ~score]),
                f"scales_read kernel != plain outside the score lanes ({label}): lanes "
                f"{torch.nonzero(g_ != w_)[:8].tolist()}, got {g_[g_ != w_][:8].tolist()} want {w_[g_ != w_][:8].tolist()}")
        d = (g_[:, score] - w_[:, score]).abs()
        err = int(d.max())
        require(err <= 1, f"scales_read score lanes differ by {err} ({label})")
        stats["calls"] += 1
        stats["records"] += g_.shape[0]
        stats["score_lanes_off"] += int((d != 0).sum())
        stats["max_abs_err"] = max(stats["max_abs_err"], err)
        return got

    cases = testing.scales_read_cases()
    for name, (text, sbool) in cases.items():
        check(*on_card(text, sbool), name)
    # The edge cases B at a time, padded to one shape (no text, no black),
    # cut from the rows of one buffer an odd number of bytes apart.
    names = sorted(cases)
    for bsz in BATCH_SIZES:
        for start in range(0, len(names), bsz):
            group = [names[(start + i) % len(names)] for i in range(bsz)]
            h = max(cases[n][0].shape[0] for n in group)
            w = max(cases[n][0].shape[1] for n in group)
            t_rows = torch.zeros((bsz, h * w + 37), dtype=torch.bool, device=dev)
            s_rows = torch.ones((bsz, h * w + 11), dtype=torch.bool, device=dev)
            t = t_rows[:, : h * w].view(bsz, h, w)
            s_ = s_rows[:, : h * w].view(bsz, h, w)
            for i, n in enumerate(group):
                ph, pw = cases[n][0].shape
                t[i, :ph, :pw], s_[i, :ph, :pw] = on_card(*cases[n])
            got = check(t, s_, f"edge cases {group}")
            for i in range(bsz):
                require(torch.equal(got[i], sd.scales_records(t[i], s_[i], tpl)),
                        f"scales_read edge cases B={bsz} frame {i} ({group[i]}) != per frame")
    print(f"scales_read: kernel == plain on the edge cases {names}, one at a time and B = {BATCH_SIZES} at a "
          f"time from strided buffers (== the per-frame kernel)", flush=True)
    shapes = ((411, 493), (822, 986), (37, 53), (5, 15), (100, 2000))
    for h, w in shapes:
        for trial in range(4):
            check(*on_card(*random_scales_planes(rng, h, w)), f"random {h}x{w} #{trial}")
    print(f"scales_read: kernel == plain on random words, bars and blobs at {shapes}", flush=True)
    brqs = {(w, h): brq_planes(frame_for(w, h)) for w, h in ((1920, 1080), (3840, 2160))}
    for (w, h), planes in brqs.items():
        rec = check(*on_card(*planes), f"verify frame {w}x{h}").cpu().numpy()
        words = [x.text for x in sd.decode_records(rec).words]
        require(words == ["300m"], f"scales_read on the verify frame's BRQ at {w}x{h} read {words}")
    for w, h in testing.RESOLUTIONS:
        frames = [brq_planes(testing.resolution_frame(w, h, step)) for step in range(3)]
        check(*on_card(*frames[0]), f"resolution {w}x{h}")
        check(*(torch.from_numpy(np.stack(p)).to(dev) for p in zip(*frames)), f"resolution {w}x{h} B=3")
    print(f"scales_read: kernel == plain on the verify frame's BRQ at 1080p and 4K (read '300m') and on the "
          f"BRQs of {len(testing.RESOLUTIONS)} screen sizes, one frame and B=3", flush=True)

    # B frames cut from the rows of one buffer, the rows an odd length apart.
    vt, vs = brqs[(1920, 1080)]
    h, w = vt.shape
    batches = {}
    for bsz in BATCH_SIZES:
        planes = [(vt, vs) if i % 3 == 0 else random_scales_planes(rng, h, w) for i in range(bsz)]
        t_rows = torch.zeros((bsz, h * w + 37), dtype=torch.bool, device=dev)
        s_rows = torch.ones((bsz, h * w + 11), dtype=torch.bool, device=dev)
        t = t_rows[:, : h * w].view(bsz, h, w)
        s_ = s_rows[:, : h * w].view(bsz, h, w)
        for i, (a, b) in enumerate(planes):
            t[i], s_[i] = on_card(a, b)
        got = check(t, s_, f"B={bsz} strided")
        for i in range(bsz):
            require(torch.equal(got[i], sd.scales_records(t[i], s_[i], tpl)), f"scales_read B={bsz} frame {i} != per frame")
        prof = device_profile(lambda: sd.scales_records(t, s_, tpl), names=("scales_read",))
        require(prof["launches"] == 1.0 and prof["named"]["scales_read"] == 1.0,
                f"scales_read B={bsz}: {prof['launches']} CUDA launches per call")
        batches[bsz] = (t, s_, prof["named_us"]["scales_read"], got)
    print(f"scales_read: B = {BATCH_SIZES} from one buffer (frame strides {h * w + 37} and {h * w + 11}) == plain "
          f"and == the per-frame kernel; one CUDA launch per call (profiler); device us per call "
          f"{ {b: round(v[2], 2) for b, v in batches.items()} }", flush=True)

    def bound_of(recs: torch.Tensor, h: int, w: int) -> dict:
        """Bytes: both planes read once, the templates, the records written;
        operations: a test per text pixel and, per glyph the record holds,
        the resample (~30 per pixel) and the template dots."""
        recs = recs.reshape(-1, sd.REC_I16).cpu().numpy()
        glyphs = int(recs[:, sd.HDR_I16 :].reshape(len(recs), sd.N_WORDS, sd.WORD_I16)[:, :, 0].sum())
        nbytes = len(recs) * (2 * h * w + sd.REC_BYTES) + n_tpl * sd.GLYPH_H * sd.GLYPH_W * 4
        return bound(nbytes, len(recs) * h * w + glyphs * sd.GLYPH_H * sd.GLYPH_W * (30 + 2 * n_tpl))

    times = {}
    for (fw, fh), planes in brqs.items():
        t, s_ = on_card(*planes)
        rec = sd.scales_records(t, s_, tpl)
        times[fh] = {
            "ms": cuda_ms(lambda: sd.scales_records(t, s_, tpl)),
            "plain_ms": cuda_ms(lambda: sd.scales_records_plain(t, s_, tpl), n=10),
            "device_us": device_us(lambda: sd.scales_records(t, s_, tpl)),
            **bound_of(rec, *t.shape),
        }
        print(f"scales_read: {t.shape[0]}x{t.shape[1]} BRQ of the {fw}x{fh} verify frame: " + timing_line(times[fh]),
              flush=True)
    from smh_tpu_torch import probe_scales_read

    t, s_ = on_card(*brqs[(1920, 1080)])
    chain = probe_scales_read.chain_floor(t[None], s_[None], tpl, device_profile)
    lat = chain["latency_us"]
    print(f"scales_read: chain floor at 411x493 {chain['floor_us']:.2f} us = "
          + " + ".join(f"{k} x {step} {lat[step]:.3f}" for step, k in chain["steps"].items())
          + f" (probe builds, as built {chain['kernel_us']:.2f} us), beside the bytes bound "
          f"{times[1080]['bound_ms'] * 1e3:.3f} us and the kernel's {times[1080]['device_us']:.2f} us", flush=True)
    t, s_, us8, rec8 = batches[BATCH]
    b8 = {"ms": cuda_ms(lambda: sd.scales_records(t, s_, tpl)), "device_us": us8, **bound_of(rec8, h, w)}
    print(f"scales_read: B={BATCH} at {h}x{w} (one launch): wrapper {b8['ms']:.4f} ms, device {us8:.2f} us per "
          f"batch ({us8 / BATCH:.2f} per frame) beside its bound {b8['bound_ms']:.5f} ms ({b8['bound_by']}); "
          f"{stats['calls']} calls ({stats['records']} records) held against plain, {stats['score_lanes_off']} "
          f"score lanes off by 1, every other lane equal", flush=True)
    return {
        "name": "scales_read", "route": "cuda", "source": "smh_tpu_torch/csrc/scales_read.cu",
        "replaces": "smh_tpu/ops/scales_device.py:237", "max_abs_err": stats["max_abs_err"], **times[1080],
        "library_ms": None, "shape": f"{h}x{w}", "device_us_4k": times[2160]["device_us"],
        "device_us_b8": us8, "chain_floor_us": chain["floor_us"],
    }


def map_brq(frame: np.ndarray, dev: torch.device) -> tuple:
    """(r, g, b, luma) of a BGRA frame's bottom-right quadrant as the fused
    pass hands them to kernel 6: windows of the map ROI's B, G, R planes
    (one flat buffer, as uploaded) and of kernel 1's luma."""
    from smh_tpu_torch import consts as C
    from smh_tpu_torch.ops import kernels as K

    g = C.map_geometry(frame.shape[1], frame.shape[0])
    roi = frame[g.map_y : g.map_y + g.map_h, g.map_x : g.map_x + g.map_w, :3]
    planes = torch.from_numpy(np.ascontiguousarray(np.moveaxis(roi, -1, 0))).to(dev)
    b8, g8, r8 = planes[0], planes[1], planes[2]
    _, luma = K.classify_luma_planes(r8, g8, b8)
    q = (slice(g.map_h // 2, 2 * (g.map_h // 2)), slice(g.map_w // 2, 2 * (g.map_w // 2)))
    return r8[q], g8[q], b8[q], luma[q]


def phase_brq_preprocess(dev: torch.device) -> dict:
    """Kernel 6 (csrc/brq_preprocess.cu), the quadrant's text preprocess,
    bit-equal to its plain twin on the card, every output: on
    testing.brq_preprocess_cases (as windows of a padded plane too), the
    verify frame's quadrant at 1080p and 4K, the quadrants of the seven
    screen sizes, random dense planes at both quadrant shapes, the mesh's
    row bands (row0 > 0 in a taller quadrant), and B = 1, 3 and 8 frames cut
    from the rows of one buffer an odd number of bytes apart (== the
    per-frame kernel too); one launch per call (LAUNCHES, and the profiler's
    kernel rows). Timed at both quadrants and at B = 8 beside its bound."""
    from smh_tpu_torch import testing
    from smh_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(12)
    calls = 0

    def check(planes, label: str, **kw) -> dict:
        nonlocal calls
        before = K.LAUNCHES["brq_preprocess"]
        got = K.brq_preprocess(*planes, **kw)
        require(K.LAUNCHES["brq_preprocess"] == before + 1, f"brq_preprocess: not one launch for {label}")
        want = K.brq_preprocess_plain(*planes, **kw)
        for k, v in want.items():
            require(got[k].shape == v.shape and got[k].dtype == v.dtype, f"brq_preprocess {k} shape/dtype ({label})")
            if not torch.equal(got[k], v):
                at = torch.nonzero(got[k] != v)[:8].tolist()
                raise RuntimeError(f"check failed: brq_preprocess {k} kernel != plain ({label}) at {at}")
        calls += 1
        return got

    def windows(rgb: np.ndarray, pad: tuple = (0, 0)) -> tuple:
        """rgb's planes as windows of planes pad rows and columns larger,
        with their plain luma."""
        h, w, _ = rgb.shape
        big = np.zeros((3, h + pad[0], w + pad[1]), np.uint8)
        big[:, pad[0] :, pad[1] :] = np.moveaxis(rgb, -1, 0)
        planes = torch.from_numpy(big).to(dev)
        luma = K.classify_luma_planes_plain(planes[0], planes[1], planes[2])[1]
        return tuple(p[pad[0] :, pad[1] :] for p in (planes[0], planes[1], planes[2], luma))

    cases = testing.brq_preprocess_cases(rng)
    for name, rgb in cases.items():
        check(windows(rgb), name)
        check(windows(rgb, (3, 5)), f"{name} in a padded plane")
    print(f"brq_preprocess: kernel == plain on the edge cases {sorted(cases)}, contiguous and as windows of a "
          f"padded plane", flush=True)

    def placed(rgb: np.ndarray, col: int, pitch_mod: int, lcol: int, lpitch_mod: int) -> tuple:
        """rgb's planes as windows starting at column `col` of planes whose
        rows are a pitch = pitch_mod (mod 16) bytes apart (R, G, B in one
        buffer), the plain luma a window at `lcol` of a plane of its own
        whose pitch = lpitch_mod (mod 16)."""
        h, w, _ = rgb.shape
        pitch = w + col + (pitch_mod - (w + col)) % 16
        big = torch.zeros((3, h, pitch), dtype=torch.uint8, device=dev)
        big[:, :, col : col + w] = torch.from_numpy(np.ascontiguousarray(np.moveaxis(rgb, -1, 0))).to(dev)
        r8, g8, b8 = (big[c, :, col : col + w] for c in range(3))
        lpitch = w + lcol + (lpitch_mod - (w + lcol)) % 16
        lbig = torch.zeros((h, lpitch), dtype=torch.uint8, device=dev)
        lbig[:, lcol : lcol + w] = K.classify_luma_planes_plain(r8, g8, b8)[1]
        return r8, g8, b8, lbig[:, lcol : lcol + w]

    # Window starts and row pitches at every value mod 16, each plane's own
    # (the kernel reads aligned words and shifts them; it stores aligned
    # words whose bytes come from two lanes), across two tile seams.
    for k in range(16):
        rgb = testing.text_rgb(rng, 37, 250, 0.4)
        check(placed(rgb, k, (7 * k + 3) % 16, (k + 5) % 16, (3 * k + 1) % 16), f"window at {k} mod 16")
    # Widths and heights around the 16 x 124 tiles and their R halo.
    for h, w in ((47, 369), (48, 372), (49, 375), (61, 496), (64, 497), (65, 500), (13, 1000), (19, 1117)):
        for share in (0.3, 0.9):
            check(placed(testing.text_rgb(rng, h, w, share), 3, 1, 6, 9), f"{h}x{w} share {share}")
    print("brq_preprocess: kernel == plain on windows at every start column and row pitch mod 16 (R, G, B and "
          "the luma each their own) and on shapes around the 16 x 124 tiles", flush=True)
    for h, w in ((411, 493), (822, 986)):
        for share in (0.05, 0.5, 0.95):
            check(windows(testing.text_rgb(rng, h, w, share), (h, w)), f"random {h}x{w} share {share}")
    rgb = testing.text_rgb(rng, 120, 260, 0.6)
    whole = check(windows(rgb), "the quadrant the bands cut")
    # Bands whose edges fall on the tiles' row seams and their R halo.
    for row0, rows in ((0, 40), (37, 43), (97, 23), (13, 19), (16, 16), (29, 35), (45, 20), (3, 110)):
        lo, hi = max(0, row0 - 3), min(120, row0 + rows + 3)
        band = check(windows(rgb[lo:hi]), f"band {lo}..{hi}", row0=lo, total_h=120)
        for k in ("ocr_img", "text", "sbool", "scales_bits"):
            require(torch.equal(band[k][row0 - lo : row0 - lo + rows], whole[k][row0 : row0 + rows]),
                    f"brq_preprocess band at {row0}: {k} != the whole quadrant's rows")
    print("brq_preprocess: kernel == plain on random planes at 411x493 and 822x986 (5-95 % of pixels at the "
          "thresholds) and on mesh bands (row0 > 0, == the whole quadrant's rows)", flush=True)
    verify = {}
    for w, h in ((1920, 1080), (3840, 2160)):
        verify[h] = map_brq(frame_for(w, h), dev)
        got = check(verify[h], f"verify frame {w}x{h}")
        require(int(got["text"].sum()) > 0, f"no text in the verify frame's quadrant at {w}x{h}")
    for w, h in testing.RESOLUTIONS:
        frames = [map_brq(testing.resolution_frame(w, h, step), dev) for step in range(3)]
        check(frames[0], f"resolution {w}x{h}")
        check(tuple(torch.stack([f[c] for f in frames]) for c in range(4)), f"resolution {w}x{h} B=3")
    print(f"brq_preprocess: kernel == plain on the verify frame's quadrant at 1080p and 4K and on the quadrants "
          f"of {len(testing.RESOLUTIONS)} screen sizes, one frame and B=3", flush=True)

    # B frames as the batched pass cuts them: plane-major rows of one buffer
    # an odd number of bytes apart, the quadrant windows of each, kernel 1's
    # luma of the batch.
    h, w = 822, 986
    batched = {}
    for bsz in BATCH_SIZES:
        rows = torch.zeros((bsz, 3 * h * w + 37), dtype=torch.uint8, device=dev)
        for i in range(bsz):
            rgb = testing.text_rgb(rng, h, w, 0.2)
            rows[i, : 3 * h * w] = torch.from_numpy(np.moveaxis(rgb[..., ::-1], -1, 0).reshape(-1)).to(dev)
        planes = rows[:, : 3 * h * w].view(bsz, 3, h, w)
        b8, g8, r8 = planes[:, 0], planes[:, 1], planes[:, 2]
        lrows = torch.zeros((bsz, h * w + 11), dtype=torch.uint8, device=dev)  # the luma's frames an odd stride apart
        luma = lrows[:, : h * w].view(bsz, h, w)
        luma.copy_(K.classify_luma_planes(r8, g8, b8)[1])
        brq = tuple(p[:, h // 2 :, w // 2 :] for p in (r8, g8, b8, luma))
        got = check(brq, f"B={bsz} strided")
        for i in range(bsz):
            one = K.brq_preprocess(*(p[i] for p in brq))
            require(all(torch.equal(got[k][i], one[k]) for k in one), f"brq_preprocess B={bsz} frame {i} != per frame")
        prof = device_profile(lambda: K.brq_preprocess(*brq), names=("brq_preprocess",))
        require(prof["launches"] == 1.0 and prof["named"]["brq_preprocess"] == 1.0,
                f"brq_preprocess B={bsz}: {prof['launches']} CUDA launches per call (kernels and memsets)")
        batched[bsz] = (brq, prof["named_us"]["brq_preprocess"], prof["us"])
    print(f"brq_preprocess: B = {BATCH_SIZES} quadrants of 411x493 from one buffer (frame stride {3 * h * w + 37}, "
          f"the luma's {h * w + 11}) == plain and == the per-frame kernel; one CUDA launch per call, no memset "
          f"(profiler); device us per call {({b: round(v[1], 2) for b, v in batched.items()})}", flush=True)

    def bound_of(bsz: int, qh: int, qw: int) -> dict:
        return bound(bsz * kernel_bytes("brq_preprocess", 2 * qh, 2 * qw), bsz * OPS_PER_PX["brq_preprocess"] * qh * qw)

    times = {}
    for (fw, fh), hh in (((1920, 1080), 1080), ((3840, 2160), 2160)):
        planes = verify[hh]
        prof = device_profile(lambda: K.brq_preprocess(*planes), names=("brq_preprocess",))
        times[hh] = {
            "ms": cuda_ms(lambda: K.brq_preprocess(*planes)),
            "plain_ms": cuda_ms(lambda: K.brq_preprocess_plain(*planes), n=10),
            "device_us": prof["named_us"]["brq_preprocess"], "call_us": prof["us"],
            **bound_of(1, *planes[0].shape),
        }
        print(f"brq_preprocess: {planes[0].shape[0]}x{planes[0].shape[1]} quadrant of the {fw}x{fh} verify frame: "
              + timing_line(times[hh]) + f"; the call's CUDA rows {prof['launches']:.0f}, {prof['us']:.2f} us",
              flush=True)
    brq, us8, call8 = batched[BATCH]
    b8 = {"ms": cuda_ms(lambda: K.brq_preprocess(*brq)), **bound_of(BATCH, *brq[0].shape[-2:])}
    print(f"brq_preprocess: B={BATCH} quadrants of {brq[0].shape[-2]}x{brq[0].shape[-1]} (one launch): wrapper "
          f"{b8['ms']:.4f} ms, device {us8:.2f} us per batch ({us8 / BATCH:.2f} per frame) beside its bound "
          f"{b8['bound_ms']:.5f} ms ({b8['bound_by']}); {calls} calls held against plain, every output equal",
          flush=True)
    return {
        "name": "brq_preprocess", "route": "cuda", "source": "smh_tpu_torch/csrc/brq_preprocess.cu",
        "replaces": "smh_tpu/ops/pipeline.py:497", "max_abs_err": 0, **times[1080], "library_ms": None,
        "shape": "411x493", "device_us_4k": times[2160]["device_us"], "device_us_b8": us8,
    }


def phase_mask_words(dev: torch.device) -> dict:
    """Kernel 7 (csrc/mask_words.cu), the marker mask's bbox and sparse
    words, bit-equal to its plain twin on the card, every lane: on
    testing.mask_bits_cases at budgets 0, 1, 64 and 256 (empty and full
    masks, a pixel at each corner, nz = budget - 1, budget, budget + 1,
    ragged widths), the verify frame's mask bits at 1080p and 4K, random
    masks at both map shapes at every _SPARSE_BUDGETS rung (a dense 4K mask
    among them), and B = 1, 3 and 8 planes cut from the rows of one buffer
    (== the per-frame kernel); one launch per call. Timed at both map
    shapes and at B = 8 beside its bound."""
    from smh_tpu_torch import consts as C
    from smh_tpu_torch import testing
    from smh_tpu_torch.ops import kernels as K
    from smh_tpu_torch.vision.cuda_backend import _SPARSE_BUDGETS

    rng = np.random.default_rng(13)
    calls = 0

    def check(bits: torch.Tensor, w: int, budget: int, label: str) -> torch.Tensor:
        nonlocal calls
        before = K.LAUNCHES["mask_words"]
        got = K.mask_bbox_sparse(bits, w, budget)
        require(K.LAUNCHES["mask_words"] == before + 1, f"mask_words: not one launch for {label}")
        want = K.mask_bbox_sparse_plain(bits, w, budget)
        require(got.shape == want.shape and got.dtype == torch.int32, f"mask_words shape/dtype ({label})")
        if not torch.equal(got, want):
            at = torch.nonzero(got != want)[:8].tolist()
            raise RuntimeError(f"check failed: mask_words kernel != plain ({label}, budget {budget}) at {at}")
        calls += 1
        return got

    def on_card(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for budget in (0, 1, 64, 256):
        cases = testing.mask_bits_cases(max(budget, 2))
        for name, (bits, w) in cases.items():
            check(on_card(bits), w, budget, name)
    print(f"mask_words: kernel == plain on the edge cases {sorted(cases)} at budgets 0, 1, 64 and 256", flush=True)
    verify = {}
    for w, h in ((1920, 1080), (3840, 2160)):
        gm = C.map_geometry(w, h)
        frame = frame_for(w, h)
        roi = frame[gm.map_y : gm.map_y + gm.map_h, gm.map_x : gm.map_x + gm.map_w, :3]
        planes = torch.from_numpy(np.ascontiguousarray(np.moveaxis(roi, -1, 0))).to(dev)
        verify[h] = (K.fused_mask_bits(planes[2], planes[1], planes[0]), gm.map_w)
        got = check(*verify[h], MASK_BUDGET, f"verify frame {w}x{h}")
        require(0 < int(got[6]) <= MASK_BUDGET, f"the verify frame's mask at {w}x{h} holds {int(got[6])} words")
    dense = {}
    for h, w in ((822, 986), (1644, 1972)):
        for density in (0.0005, 0.02, 0.5):
            bits = on_card(np.packbits(rng.random((h, w)) < density, axis=1))
            for budget in _SPARSE_BUDGETS:
                got = check(bits, w, budget, f"random {h}x{w} density {density}")
            dense[f"{h}x{w} {density}"] = int(got[6])
    print(f"mask_words: kernel == plain on the verify frame's mask bits at 1080p and 4K and on random masks at every "
          f"rung {_SPARSE_BUDGETS} (non-zero words {dense})", flush=True)
    # Rows of (W + 7) / 8 bytes with every remainder mod 4, and words on both
    # sides of every tile seam (K.mask_tiles: whole rows a tile), in each
    # row's first and last words.
    for mw in (986, 993, 1001, 984):
        bits = on_card(np.packbits(rng.random((822, mw)) < 0.01, axis=1))
        check(bits, mw, MASK_BUDGET, f"822x{mw}, {(mw + 7) // 8 % 4} mod 4 bytes a row")
    seams = {}
    for mh, mw in ((822, 986), (1644, 1972)):
        nw = ((mw + 7) // 8 + 3) // 4
        rows = K.MASK_TILE_WORDS // nw
        m = np.zeros((mh, mw), bool)
        for y in range(rows - 1, mh, rows):
            m[y : y + 2, [0, 31, 32, mw - 1]] = True
        bits = on_card(np.packbits(m, axis=1))
        for budget in (0, 64, MASK_BUDGET):
            got = check(bits, mw, budget, f"words at the tile seams {mh}x{mw}")
        seams[f"{mh}x{mw}"] = (K.mask_tiles(mh, mw), rows, int(got[6]))
    print(f"mask_words: kernel == plain on rows of 0-3 mod 4 bytes and on words at every tile seam "
          f"({{shape: (tiles, rows a tile, nz)}} {seams})", flush=True)
    from smh_tpu_torch import _build

    for mh, mw in ((822, 986), (1644, 1972), (1096, 2194), (1, 1), (65535, 8), (5, 65535), (5000, 65535), (8, 65536)):
        tiles = _build.load().smh_mask_words_tiles(mh, mw)
        require(tiles == (K.mask_tiles(mh, mw) or -1), f"mask_tiles({mh}, {mw}) != the kernel's {tiles}")
    h, w = 822, 986
    bpr = (w + 7) // 8
    batched = {}
    for bsz in BATCH_SIZES:
        rows = torch.zeros((bsz, h * bpr + 3), dtype=torch.uint8, device=dev)
        for i in range(bsz):
            rows[i, : h * bpr] = on_card(np.packbits(rng.random((h, w)) < 0.0002 * (i + 1), axis=1)).reshape(-1)
        bits = rows[:, : h * bpr].view(bsz, h, bpr)
        got = check(bits, w, MASK_BUDGET, f"B={bsz} strided")
        for i in range(bsz):
            require(torch.equal(got[i], K.mask_bbox_sparse(bits[i], w, MASK_BUDGET)), f"mask_words B={bsz} frame {i}")
        prof = device_profile(lambda: K.mask_bbox_sparse(bits, w, MASK_BUDGET), names=("mask_words",))
        require(prof["launches"] == 1.0 and prof["named"]["mask_words"] == 1.0,
                f"mask_words B={bsz}: {prof['launches']} CUDA launches per call")
        batched[bsz] = (bits, prof["named_us"]["mask_words"])
    print(f"mask_words: B = {BATCH_SIZES} bit planes of {h}x{w} from one buffer (frame stride {h * bpr + 3}) == plain "
          f"and == the per-frame kernel; one CUDA launch per call (profiler); device us per call "
          f"{({b: round(v[1], 2) for b, v in batched.items()})}", flush=True)

    def bound_of(bsz: int, mh: int, mw: int) -> dict:
        words = mh * (((mw + 7) // 8 + 3) // 4)
        return bound(bsz * kernel_bytes("mask_words", mh, mw), bsz * OPS_PER_PX["mask_words"] * words)

    times = {}
    for hh, (bits, mw) in verify.items():
        times[hh] = {
            "ms": cuda_ms(lambda: K.mask_bbox_sparse(bits, mw, MASK_BUDGET)),
            "plain_ms": cuda_ms(lambda: K.mask_bbox_sparse_plain(bits, mw, MASK_BUDGET), n=10),
            "device_us": device_us(lambda: K.mask_bbox_sparse(bits, mw, MASK_BUDGET)),
            **bound_of(1, bits.shape[0], mw),
        }
        print(f"mask_words: {bits.shape[0]}x{mw} mask bits of the verify frame at {hh}p, budget {MASK_BUDGET}: "
              + timing_line(times[hh]), flush=True)
    bits, us8 = batched[BATCH]
    b8 = {"ms": cuda_ms(lambda: K.mask_bbox_sparse(bits, w, MASK_BUDGET)), **bound_of(BATCH, h, w)}
    print(f"mask_words: B={BATCH} at {h}x{w} (one launch): wrapper {b8['ms']:.4f} ms, device {us8:.2f} us per batch "
          f"({us8 / BATCH:.2f} per frame) beside its bound {b8['bound_ms']:.5f} ms ({b8['bound_by']}); {calls} calls "
          f"held against plain, every lane equal", flush=True)
    return {
        "name": "mask_words", "route": "cuda", "source": "smh_tpu_torch/csrc/mask_words.cu",
        "replaces": "smh_tpu/ops/pipeline.py:326", "max_abs_err": 0, **times[1080], "library_ms": None,
        "shape": "822x986", "device_us_4k": times[2160]["device_us"], "device_us_b8": us8,
    }


def padded_table(chunks: np.ndarray, data: np.ndarray, bucket: int) -> tuple:
    """A bucket of sorted chunk indices padded by repeating the last one
    with its data, as the host's diff pads it."""
    n = chunks.size
    idx = np.concatenate([chunks, np.full(bucket - n, chunks[-1])]).astype(np.int32)
    return idx, np.concatenate([data, np.repeat(data[-1:], bucket - n, axis=0)])


def delta_upload(tables: list, datas: list) -> np.ndarray:
    """B index tables, then B blocks of chunks: one u8 delta upload."""
    idx = np.stack(tables).astype(np.int32)
    return np.concatenate([idx.reshape(-1).view(np.uint8), np.stack(datas).reshape(-1)])


def delta_chain(rng, n_sub: int, bsz: int, bucket: int, changed: int) -> np.ndarray:
    """A batch's upload: frame f changes `changed` random chunks (sorted),
    chunk 40 among them in frames 0 and 2 with different data."""
    from smh_tpu_torch.vision.cuda_backend import _DELTA_SUB

    tables, datas = [], []
    for f in range(bsz):
        chunks = np.sort(rng.choice(n_sub, size=changed, replace=False))
        if f in (0, 2):
            chunks = np.union1d(chunks[:-1], [40])
        idx, dat = padded_table(chunks, rng.integers(0, 256, (chunks.size, _DELTA_SUB), dtype=np.uint8), bucket)
        tables.append(idx)
        datas.append(dat)
    return delta_upload(tables, datas)


def delta_in_order(resident: np.ndarray, tables: list, datas: list) -> np.ndarray:
    """The rows of a delta upload by a numpy loop that applies each frame's
    entries in table order to the row before (an index outside the frame
    updates nothing): a duplicate index ends with its last entry's data."""
    n_sub, sub = resident.size // datas[0].shape[1], datas[0].shape[1]
    rows, prev = [], resident.reshape(n_sub, sub)
    for idx, dat in zip(tables, datas):
        row = prev.copy()
        for j, c in enumerate(idx):
            if 0 <= c < n_sub:
                row[c] = dat[j]
        rows.append(row.reshape(-1))
        prev = row
    return np.stack(rows)


def frame_bytes(w: int, h: int) -> int:
    """A frame's flat upload at a screen size, padded to the delta chunk."""
    from smh_tpu_torch import consts as C
    from smh_tpu_torch.vision.cuda_backend import _DELTA_CHUNK

    gm = C.map_geometry(w, h)
    return -(-(gm.map_h * gm.map_w + gm.btn_h * gm.btn_w) * 3 // _DELTA_CHUNK) * _DELTA_CHUNK


DELTA_TIMED = (2000, 2048)  # (changed chunks, bucket) of the timed delta uploads


def phase_delta_apply(dev: torch.device) -> dict:
    """Kernel 8 (csrc/delta_apply.cu), the delta apply, bit-equal to its
    plain twin on the card, every byte of every row, with the resident
    buffer unchanged: at the 1080p and 4K frames' buffers, no change (one
    repeated index), chunk 0, the last chunk, every chunk, 1000 chunks
    padded by repeats, a bucket at the top of the ladder, and chains of B =
    1, 3 and 8 frames with chunk 40 written by frames 0 and 2; and equal to
    a numpy loop that applies the entries in order (the twin's index_copy_
    leaves duplicates unordered on the card) on runs across tile seams, an
    index repeated with different data, one chunk padded by the top
    bucket's repeats (131,071 at 4K), 2000 chunks padded to it, and one
    chunk written by every frame of a chain of 8; one launch per call and no
    memset (profiler). Timed per frame at both sizes and for B = 8 at 1080p
    beside its bound, its plain twin (the eager copy and index_copy_ it
    replaced) and torch.index_copy (its call and its device time)."""
    from smh_tpu_torch.ops import kernels as K
    from smh_tpu_torch.vision import cuda_backend as cb

    rng = np.random.default_rng(21)
    sub = cb._DELTA_SUB
    calls = 0

    def check(resident: torch.Tensor, buf: torch.Tensor, bucket: int, label: str) -> torch.Tensor:
        nonlocal calls
        before, kept = K.LAUNCHES["delta_apply"], resident.clone()
        got = K.delta_apply(resident, buf, bucket, sub)
        require(K.LAUNCHES["delta_apply"] == before + 1, f"delta_apply: not one launch for {label}")
        want = K.delta_apply_plain(resident, buf, bucket, sub)
        if not torch.equal(got, want):
            at = torch.nonzero(got != want)[:8].tolist()
            raise RuntimeError(f"check failed: delta_apply kernel != plain ({label}) at {at}")
        require(torch.equal(resident, kept), f"delta_apply wrote the resident buffer ({label})")
        calls += 1
        return got

    inputs = {}
    for w, h in LIVE_SIZES:
        padded = frame_bytes(w, h)
        n_sub = padded // sub
        top = max(b for b in cb._DELTA_BUCKETS if b < n_sub * cb._DELTA_MAX_FRACTION)
        base = rng.integers(0, 256, padded, dtype=np.uint8)
        resident = torch.from_numpy(base).to(dev)

        def rand(k: int) -> np.ndarray:
            return rng.integers(0, 256, (k, sub), dtype=np.uint8)

        def some(k: int) -> np.ndarray:
            return np.sort(rng.choice(n_sub, size=k, replace=False))

        cases = {
            "no change": padded_table(np.array([7]), base.reshape(n_sub, sub)[7:8], 16),
            "chunk 0": padded_table(np.array([0]), rand(1), 16),
            "the last chunk": padded_table(np.array([n_sub - 1]), rand(1), 16),
            "every chunk": (np.arange(n_sub, dtype=np.int32), rand(n_sub)),
            "1000 chunks padded by repeats": padded_table(some(1000), rand(1000), 1024),
            f"the ladder's top bucket {top}": padded_table(some(top - 17), rand(top - 17), top),
        }
        for name, (idx, dat) in cases.items():
            buf = torch.from_numpy(delta_upload([idx], [dat])).to(dev)
            got = check(resident, buf, idx.size, f"{w}x{h} {name}")
            if name == "no change":
                require(torch.equal(got[0], resident), f"delta_apply changed a frame with no change at {w}x{h}")
        for bsz in BATCH_SIZES:
            buf = torch.from_numpy(delta_chain(rng, n_sub, bsz, 1024, 900)).to(dev)
            got = check(resident, buf, 1024, f"{w}x{h} B={bsz}")
            if bsz >= 3:
                require(not torch.equal(got[0].view(n_sub, sub)[40], got[2].view(n_sub, sub)[40]),
                        "chunk 40 of frames 0 and 2")
        # Against delta_in_order (index_copy_ on the card leaves duplicates
        # unordered): runs across tile seams (a tile: 256 pieces of 16 B),
        # an index repeated with different data in a frame, one chunk
        # written by every frame of a chain, and the top bucket of repeats.
        tile = 256 * 16 // sub
        seams = np.unique(np.concatenate([np.arange(tile - 40, tile + 40), [2 * tile - 1, 2 * tile],
                                          np.arange(n_sub - tile - 3, n_sub - tile + 3), [n_sub - 1]]))
        repeated = np.sort(np.concatenate([some(301), [5 * tile - 1] * 4, [5 * tile] * 3]))  # 308: 16-byte aligned data
        chain77 = []
        for _ in range(BATCH):
            chunks = np.union1d(some(200), [77])
            chain77.append(padded_table(chunks, rand(chunks.size), 256))
        ordered = {
            "runs across tile seams": [padded_table(seams, rand(seams.size), 256)],
            "an index repeated with different data": [(repeated.astype(np.int32), rand(repeated.size))],
            f"one chunk padded by {top - 1} repeats of the top bucket {top}": [
                padded_table(np.array([n_sub // 2]), rand(1), top)],
            f"{DELTA_TIMED[0]} chunks padded to the top bucket {top}": [
                padded_table(some(DELTA_TIMED[0]), rand(DELTA_TIMED[0]), top)],
            f"chunk 77 written by every frame of {BATCH}": chain77,
        }
        for name, pairs in ordered.items():
            tables, datas = [t for t, _ in pairs], [d for _, d in pairs]
            buf = torch.from_numpy(delta_upload(tables, datas)).to(dev)
            before, kept = K.LAUNCHES["delta_apply"], resident.clone()
            got = K.delta_apply(resident, buf, tables[0].size, sub)
            require(K.LAUNCHES["delta_apply"] == before + 1, f"delta_apply: not one launch for {name}")
            want = delta_in_order(base, tables, datas)
            if not np.array_equal(got.cpu().numpy(), want):
                raise RuntimeError(f"check failed: delta_apply kernel != the in-order loop ({w}x{h} {name})")
            require(torch.equal(resident, kept), f"delta_apply wrote the resident buffer ({name})")
            calls += 1
        changed, bucket = DELTA_TIMED
        idx, dat = padded_table(some(changed), rand(changed), bucket)
        inputs[h] = (resident, torch.from_numpy(delta_upload([idx], [dat])).to(dev), bucket, padded)
        if h == 1080:
            inputs["b8"] = (resident, torch.from_numpy(delta_chain(rng, n_sub, BATCH, bucket, changed)).to(dev),
                            bucket, padded)
        print(f"delta_apply: {w}x{h} ({padded} B, {n_sub} chunks): kernel == plain, every byte, resident unchanged, "
              f"on {sorted(cases)} and chains of B = {BATCH_SIZES} (chunk 40 by frames 0 and 2); == the in-order "
              f"loop on {sorted(ordered)}", flush=True)

    times = {}
    for key, (resident, buf, bucket, padded) in inputs.items():
        bsz = buf.numel() // (bucket * (4 + sub))
        prof = device_profile(lambda: K.delta_apply(resident, buf, bucket, sub), names=("delta_apply",))
        require(prof["launches"] == 1.0 and prof["named"]["delta_apply"] == 1.0,
                f"delta_apply {key}: {prof['launches']} CUDA rows per call (a memset?)")
        idx64 = buf[: 4 * bucket].view(torch.int32).to(torch.int64)
        rows2d, data = resident.view(-1, sub), buf[4 * bucket * bsz :].view(bsz, bucket, sub)[0]

        def library():
            return torch.index_copy(rows2d, 0, idx64, data)

        times[key] = {
            "ms": cuda_ms(lambda: K.delta_apply(resident, buf, bucket, sub)),
            "plain_ms": cuda_ms(lambda: K.delta_apply_plain(resident, buf, bucket, sub), n=20),
            "library_ms": cuda_ms(library) if bsz == 1 else None,
            "library_device_us": device_profile(library)["us"] if bsz == 1 else None,
            "device_us": prof["named_us"]["delta_apply"],
            **bound(padded * (1 + bsz) + buf.numel(), 0.0),
        }
        t = times[key]
        print(f"delta_apply: {'B=8 at 1080p' if key == 'b8' else f'{key}p'} ({bsz} frame(s) of {padded} B, "
              f"bucket {bucket}, {DELTA_TIMED[0]} changed chunks a frame): " + timing_line(t)
              + (f"; torch.index_copy {t['library_ms']:.4f} ms (device {t['library_device_us']:.2f} us per call)"
                 if t["library_ms"] is not None else ""), flush=True)
    print(f"delta_apply: {calls} calls held against plain or the in-order loop, every byte equal; one launch per "
          f"call, no memset", flush=True)
    return {
        "name": "delta_apply", "route": "cuda", "source": "smh_tpu_torch/csrc/delta_apply.cu",
        "replaces": "smh_tpu/ops/pipeline.py:1060", "max_abs_err": 0, **times[1080], "shape": "1080p frame",
        "device_us_4k": times[2160]["device_us"], "device_us_b8": times["b8"]["device_us"],
        "ms_b8": times["b8"]["ms"], "plain_ms_b8": times["b8"]["plain_ms"], "bound_ms_b8": times["b8"]["bound_ms"],
    }


@contextlib.contextmanager
def recorded_tails():
    """Records the inputs of every kernels.hostpack_tail call in the block
    (the fused pass calls it through the module), into the yielded list."""
    from smh_tpu_torch.ops import kernels as K

    seen, real = [], K.hostpack_tail
    K.hostpack_tail = lambda ui, btn, sections=(): (seen.append((ui, btn, list(sections))), real(ui, btn, sections))[1]
    try:
        yield seen
    finally:
        K.hostpack_tail = real


# (scales transport, sparse budget, window crop as a share of the map, scales
# band rows): every route's table of kernel 9
TAIL_ROUTES = {
    "device + sparse": ("device", MASK_BUDGET, None, None), "window + binary": ("binary", None, 2, None),
    "binary band": ("binary", MASK_BUDGET, None, 48), "gray band": ("gray", MASK_BUDGET, None, 48),
    "gray": ("gray", None, None, None), "none": ("none", None, None, None),
}


def phase_hostpack(dev: torch.device) -> dict:
    """Kernel 9 (csrc/hostpack.cu), the ui checksum, the red gate and the
    hostpack, bit-equal to its plain twin on the card, every byte: all-255
    planes at the 4K map (the weighted u32 sum wraps), gray and colour; 1-row
    and 1-column planes, planes 1-3 bytes past an aligned address and
    interleaved (the mesh's colour ui); the button shapes of the seven
    screen sizes and 4K with 0, 1, n - 1 and n button-red pixels; the table
    of every route of the fused pass (recorded from the pass on the card,
    gray and colour, at 1080p and 4K) and of the batch routes at B = 1, 3
    and 8, then every one of those tables twice over in a shuffled order
    (the wrapper's plans, built once per shapes and strides, across changes
    of route, shape and batch size); one launch per call, no memset
    (profiler). Timed on the main path's table at 1080p and 4K and at B = 8
    beside its bound, its plain twin (the eager ops it replaced) and
    torch.cat of the hostpack's parts."""
    from smh_tpu_torch import consts as C
    from smh_tpu_torch import testing
    from smh_tpu_torch.ops import kernels as K
    from smh_tpu_torch.ops import pipeline as opp
    from smh_tpu_torch.ops import scales_device as sd

    from smh_tpu_torch.vision import cuda_backend as cb

    rng = np.random.default_rng(23)
    calls = 0
    red = torch.tensor([49, 67, 217], dtype=torch.uint8, device=dev)  # BGR of the button

    def check(ui, btn, sections, label: str) -> torch.Tensor:
        nonlocal calls
        before = K.LAUNCHES["hostpack"]
        got = K.hostpack_tail(ui, btn, sections)
        require(K.LAUNCHES["hostpack"] == before + 1, f"hostpack: not one launch for {label}")
        want = K.hostpack_tail_plain(ui, btn, sections)
        if not torch.equal(got, want):
            at = torch.nonzero(got != want)[:8].tolist()
            raise RuntimeError(f"check failed: hostpack kernel != plain ({label}) at {at}")
        calls += 1
        return got

    def on_card(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    btn = on_card(rng.integers(0, 256, (41, 255, 3), dtype=np.uint8))
    full = torch.full((1644, 1972), 255, dtype=torch.uint8, device=dev)
    for ui in ((full,), (full, full, full)):
        got = check(ui, btn, [], f"all-255 1644x1972, {len(ui)} plane(s)")
        require(got.numel() == 12, "the tail's head")
    shapes = {"1 row": (1, 997), "1 column": (613, 1), "1080p map": (822, 986), "odd": (37, 53)}
    for name, (h, w) in shapes.items():
        planes = [on_card(rng.integers(0, 256, (h, w), dtype=np.uint8)) for _ in range(3)]
        check(planes[:1], btn, [], f"{name} gray")
        check(planes, btn, [], f"{name} colour")
        for offset in (1, 2, 3):
            flat = torch.zeros(3, h * w + offset, dtype=torch.uint8, device=dev)
            flat[:, offset:] = torch.stack(planes).view(3, -1)
            moved = [flat[c, offset:].view(h, w) for c in range(3)]
            check(moved[:1], btn, [], f"{name} gray {offset} B past an aligned address")
            check(moved, btn, [], f"{name} colour {offset} B past an aligned address")
        rgb = torch.stack(planes, dim=-1)
        check((rgb[..., 0], rgb[..., 1], rgb[..., 2]), btn, [], f"{name} interleaved colour")
    for size in testing.RESOLUTIONS + ((3840, 2160),):
        gm = C.map_geometry(*size)
        n = gm.btn_h * gm.btn_w
        for k in (0, 1, n - 1, n):
            b = rng.integers(0, 256, (gm.btn_h, gm.btn_w, 3), dtype=np.uint8)
            b[np.all(np.abs(b.astype(int) - (49, 67, 217)) <= C.CLOSE_DEPLOYMENT_BUTTON_TOLERANCE, axis=-1)] = 0
            bt = on_card(b)
            bt.view(-1, 3)[torch.randperm(n, device=dev)[:k]] = red
            got = check((full[:5, :7],), bt, [], f"button {gm.btn_h}x{gm.btn_w} with {k} red")
            want = np.float32(k) * (np.float32(1) / np.float32(n))
            require(got[:4].cpu().numpy().view(np.float32)[0] == want, f"red share {k}/{n}")
    print(f"hostpack: kernel == plain on all-255 4K planes (gray and colour), planes {sorted(shapes)} (gray, colour, "
          f"1-3 B past an aligned address, interleaved) and the 8 screen sizes' buttons with 0, 1, n - 1, n red",
          flush=True)

    templates = sd.templates_to_device(sd.device_templates(), dev)
    tables, every = {}, []
    for w, h in LIVE_SIZES:
        gm = C.map_geometry(w, h)
        rows = torch.from_numpy(batch_rows(rng, BATCH, w, h)[0]).to(dev)
        frame = frame_for(w, h)
        mr = frame[gm.map_y : gm.map_y + gm.map_h, gm.map_x : gm.map_x + gm.map_w]
        br = frame[gm.btn_y : gm.btn_y + gm.btn_h, gm.btn_x : gm.btn_x + gm.btn_w]
        flat = on_card(cb._pack_rois_bgr(mr, br, cb._DELTA_CHUNK))
        geo = dict(map_h=gm.map_h, map_w=gm.map_w, btn_h=gm.btn_h, btn_w=gm.btn_w, templates=templates)
        for route, (inline, sparse, crop, band) in TAIL_ROUTES.items():
            cut = {} if crop is None else {"crop_h": gm.map_h // crop, "crop_w": gm.map_w // crop}
            for gray in (True, False):
                with recorded_tails() as seen:
                    opp.analyze_packed_flat(flat, grayscale=gray, scales_inline=inline, sparse_budget=sparse,
                                            scales_band=band, **cut, **geo)
                require(len(seen) == 1, f"{route}: {len(seen)} tails a pass")
                every.append((seen[0], f"{w}x{h} {route} {'gray' if gray else 'colour'}"))
                got = check(*seen[0], every[-1][1])
                layout = opp.hostpack_layout(gm.map_h, gm.map_w, scales_inline=inline, sparse_budget=sparse,
                                             scales_band=band, **cut)
                require(got.numel() == layout["__total__"], f"{route}: {got.numel()} B, layout {layout['__total__']}")
                if route == "device + sparse" and gray:
                    tables[h] = seen[0]
            if band is not None:
                continue
            for bsz in BATCH_SIZES:
                with recorded_tails() as seen:
                    opp.analyze_batch_packed_flat(rows[:bsz], grayscale=True, scales_inline=inline,
                                                  sparse_budget=sparse, **cut, **geo)
                every.append((seen[0], f"{w}x{h} {route} B={bsz}"))
                got = check(*seen[0], every[-1][1])
                require(got.shape[0] == bsz, f"{route} B={bsz}: {tuple(got.shape)}")
                if route == "device + sparse" and bsz == BATCH and h == 1080:
                    tables["b8"] = seen[0]
        print(f"hostpack: {w}x{h}: kernel == plain on the tables of {sorted(TAIL_ROUTES)} (gray and colour, the "
              f"hostpack's size that of hostpack_layout) and of the batch routes at B = {BATCH_SIZES}", flush=True)

    # The plans (each call's table and offsets, reused by shapes and strides)
    # across changes of route, shape and batch: every recorded table twice
    # over in a shuffled order, each call == its twin.
    for k in np.concatenate([rng.permutation(len(every)), rng.permutation(len(every))]):
        check(*every[k][0], f"{every[k][1]} among the other routes and shapes")
    plans = {id(K.hostpack_plan_for(*tail)) for tail, _label in every}
    print(f"hostpack: {2 * len(every)} calls over the {len(every)} tables in a shuffled order (routes, shapes and "
          f"batch sizes changing call to call), each == plain; {len(plans)} plans", flush=True)

    times = {}
    for key, (ui, btn, sections) in tables.items():
        prof = device_profile(lambda: K.hostpack_tail(ui, btn, sections), names=("hostpack",))
        require(prof["launches"] == 1.0 and prof["named"]["hostpack"] == 1.0,
                f"hostpack {key}: {prof['launches']} CUDA rows per call (a memset?)")
        lead = tuple(ui[0].shape[:-2])
        parts = [opp._bytes(opp._red_gate_roi(btn).reshape(*lead, 1), lead),
                 opp._u32_bytes(opp._weighted_check(ui[0]), lead), *sections]
        total = sum(p.shape[-1] for p in parts) * (lead[0] if lead else 1)
        n_in = ui[0].numel() + btn.numel() + sum(s.numel() for s in sections)
        times[key] = {
            "ms": cuda_ms(lambda: K.hostpack_tail(ui, btn, sections)),
            "plain_ms": cuda_ms(lambda: K.hostpack_tail_plain(ui, btn, sections), n=20),
            "library_ms": cuda_ms(lambda: torch.cat(parts, dim=-1)),
            "device_us": prof["named_us"]["hostpack"],
            **bound(n_in + total, 3 * ui[0].numel() + 9 * btn.numel() // 3),
        }
        print(f"hostpack: the main path's table {'B=8 at 1080p' if key == 'b8' else f'at {key}p'} ({total} B of "
              f"hostpack, {len(sections)} sections): " + timing_line(times[key])
              + f"; torch.cat of the parts {times[key]['library_ms']:.4f} ms", flush=True)
    print(f"hostpack: {calls} calls held against plain, every byte equal; one launch per call, no memset", flush=True)
    return {
        "name": "hostpack", "route": "cuda", "source": "smh_tpu_torch/csrc/hostpack.cu",
        "replaces": "smh_tpu/ops/pipeline.py:886", "max_abs_err": 0, **times[1080], "shape": "822x986 gray",
        "device_us_4k": times[2160]["device_us"], "device_us_b8": times["b8"]["device_us"],
        "ms_b8": times["b8"]["ms"], "plain_ms_b8": times["b8"]["plain_ms"],
        "library_ms_b8": times["b8"]["library_ms"], "bound_ms_b8": times["b8"]["bound_ms"],
    }


def phase_window_crop(dev: torch.device) -> dict:
    """Kernel 10 (csrc/window_crop.cu), the window crop, byte-equal to its
    plain twin on the card (meta and window bits): on
    testing.window_crop_cases (an empty mask, the bbox at each border, the
    origin's column at every value mod 8, ragged crop widths, the row's last
    byte under the window, the window at the right border with its origin at
    every value mod 8, one full dimension each way, the whole plane, 1-row
    and 1-column planes, random planes), random masks at both map
    shapes at every pair of the window ladder's rungs, the origin's column
    at every value mod 8 at both map shapes, the verify frame's mask at 1080p
    and 4K, and B = 1, 3 and 8 masks cut from the rows of one buffer, each
    frame its own origin (== the per-frame kernel); kernel 7's bbox lanes on
    the card as its input; one launch per call, no memset (profiler). Timed
    at the 1080p and 4K half-size windows and at B = 8 beside its bound and
    the bytewise design's times."""
    from smh_tpu_torch import consts as C
    from smh_tpu_torch import testing
    from smh_tpu_torch.ops import kernels as K
    from smh_tpu_torch.ops import pipeline as opp
    from smh_tpu_torch.vision import cuda_backend as cb

    rng = np.random.default_rng(29)
    margin = int(opp.LSD_CROP_MARGIN)
    calls = 0

    def check(bits: torch.Tensor, w: int, crop_h: int, crop_w: int, label: str, words=None) -> tuple:
        nonlocal calls
        words = K.mask_bbox_sparse(bits, w, 0) if words is None else words
        before = K.LAUNCHES["window_crop"]
        got = K.window_crop(bits, words, w, crop_h, crop_w, margin)
        require(K.LAUNCHES["window_crop"] == before + 1, f"window_crop: not one launch for {label}")
        want = K.window_crop_plain(bits, words, w, crop_h, crop_w, margin)
        for name, g_, w_ in zip(("meta", "window"), got, want):
            require(g_.shape == w_.shape and g_.dtype == w_.dtype, f"window_crop {name} shape/dtype ({label})")
            if not torch.equal(g_, w_):
                at = torch.nonzero(g_ != w_)[:8].tolist()
                raise RuntimeError(f"check failed: window_crop {name} kernel != plain ({label}) at {at}")
        calls += 1
        return got

    def on_card(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    cases = testing.window_crop_cases(margin)
    for name, (bits, w, crop_h, crop_w) in cases.items():
        check(on_card(bits), w, crop_h, crop_w, name)
    print(f"window_crop: kernel == plain on the edge cases {sorted(cases)}", flush=True)
    mods = {}
    for mh, mw in ((822, 986), (1644, 1972)):
        lh, lw = cb._dim_ladder(mh), cb._dim_ladder(mw)
        for density in (0.0002, 0.01):
            m = np.zeros((mh, mw), bool)
            y, x = rng.integers(0, mh // 2), rng.integers(0, mw // 2)
            m[y : y + mh // 3, x : x + mw // 3] = rng.random((mh // 3, mw // 3)) < density
            bits = on_card(np.packbits(m, axis=1))
            for ch in lh:
                for cw in lw:
                    check(bits, mw, ch, cw, f"random {mh}x{mw} window {ch}x{cw}")
        for k in range(8):
            m = np.zeros((mh, mw), bool)
            m[mh // 3, margin + 200 + k] = m[mh // 3 + 40, margin + 260 + k] = True
            meta, _ = check(on_card(np.packbits(m, axis=1)), mw, mh // 2, mw // 2, f"{mh}x{mw} cx0 {200 + k}")
            mods.setdefault(f"{mh}x{mw}", set()).add(int(meta[20:24].cpu().view(torch.int32)) % 8)
    require(all(v == set(range(8)) for v in mods.values()), f"window_crop: origin columns mod 8 {mods}")
    print("window_crop: kernel == plain on random masks at 822x986 and 1644x1972 at every pair of the window "
          "ladder's rungs, and with the origin's column at every value mod 8", flush=True)
    verify = {}
    for w, h in LIVE_SIZES:
        gm = C.map_geometry(w, h)
        planes = torch.from_numpy(np.ascontiguousarray(np.moveaxis(
            frame_for(w, h)[gm.map_y : gm.map_y + gm.map_h, gm.map_x : gm.map_x + gm.map_w, :3], -1, 0))).to(dev)
        bits = K.fused_mask_bits(planes[2], planes[1], planes[0])
        words = K.mask_bbox_sparse(bits, gm.map_w, 0)
        verify[h] = (bits, words, gm.map_w, gm.map_h // 2, gm.map_w // 2)
        meta, _ = check(bits, gm.map_w, gm.map_h // 2, gm.map_w // 2, f"verify frame {w}x{h}", words)
        require(int(meta[:4].cpu().view(torch.int32)) < gm.map_h, f"no marker in the verify frame's mask at {w}x{h}")

    h, w = 822, 986
    bpr = (w + 7) // 8
    batched = {}
    for bsz in BATCH_SIZES:
        rows = torch.zeros((bsz, h * bpr + 5), dtype=torch.uint8, device=dev)
        for i in range(bsz):
            m = np.zeros((h, w), bool)
            if i != 1:  # frame 1 empty: its origin the clamped (H - crop_h, W - crop_w)
                y, x = 30 + 37 * i, 17 + 53 * i
                m[y : y + 200, x : x + 300] = rng.random((200, 300)) < 0.01
            rows[i, : h * bpr] = on_card(np.packbits(m, axis=1)).reshape(-1)
        bits = rows[:, : h * bpr].view(bsz, h, bpr)
        words = K.mask_bbox_sparse(bits, w, 0)
        meta, crop = check(bits, w, h // 2, w // 2, f"B={bsz} strided", words)
        for i in range(bsz):
            one = K.window_crop(bits[i], words[i], w, h // 2, w // 2, margin)
            require(torch.equal(meta[i], one[0]) and torch.equal(crop[i], one[1]), f"window_crop B={bsz} frame {i}")
        origins = {tuple(meta[i, 16:24].cpu().view(torch.int32).tolist()) for i in range(bsz)}
        require(len(origins) == bsz, f"window_crop B={bsz}: origins {origins} not one per frame")
        prof = device_profile(lambda: K.window_crop(bits, words, w, h // 2, w // 2, margin), names=("window_crop",))
        require(prof["launches"] == 1.0 and prof["named"]["window_crop"] == 1.0,
                f"window_crop B={bsz}: {prof['launches']} CUDA rows per call (kernels and memsets)")
        batched[bsz] = (bits, words, prof["named_us"]["window_crop"])
    print(f"window_crop: the verify frame's mask at 1080p and 4K, and B = {BATCH_SIZES} masks of {h}x{w} from one "
          f"buffer (frame stride {h * bpr + 5}, an origin per frame) == plain and == the per-frame kernel; one CUDA "
          f"launch per call, no memset (profiler); device us per call "
          f"{({b: round(v[2], 2) for b, v in batched.items()})}", flush=True)

    def bound_of(bsz: int, crop_h: int, crop_w: int) -> dict:
        # the bbox and the window's source bytes in, the meta and the window out
        n = crop_h * ((crop_w + 7) // 8)
        return bound(bsz * (16 + n + K.WINDOW_META + n), bsz * 6 * n)

    times = {}
    for hh, (bits, words, mw, ch, cw) in verify.items():
        prof = device_profile(lambda: K.window_crop(bits, words, mw, ch, cw, margin), names=("window_crop",))
        times[hh] = {
            "ms": cuda_ms(lambda: K.window_crop(bits, words, mw, ch, cw, margin)),
            "plain_ms": cuda_ms(lambda: K.window_crop_plain(bits, words, mw, ch, cw, margin), n=10),
            "device_us": prof["named_us"]["window_crop"], **bound_of(1, ch, cw),
        }
        print(f"window_crop: the {ch}x{cw} window of the verify frame's {bits.shape[0]}x{mw} mask at {hh}p: "
              + timing_line(times[hh]), flush=True)
    bits, words, us8 = batched[BATCH]
    b8 = {"ms": cuda_ms(lambda: K.window_crop(bits, words, w, h // 2, w // 2, margin)),
          **bound_of(BATCH, h // 2, w // 2)}
    print(f"window_crop: B={BATCH} {h // 2}x{w // 2} windows of {h}x{w} masks (one launch): wrapper {b8['ms']:.4f} "
          f"ms, device {us8:.2f} us per batch ({us8 / BATCH:.2f} per frame) beside its bound {b8['bound_ms']:.5f} ms "
          f"({b8['bound_by']}); {calls} calls held against plain, every byte equal", flush=True)
    print(f"window_crop: device us {times[1080]['device_us']:.2f} / {times[2160]['device_us']:.2f}, B={BATCH} "
          f"{us8:.2f}, beside the bytewise design's {BYTEWISE_US['window_crop']} and the bounds "
          f"{times[1080]['bound_ms'] * 1e3:.3f} / {times[2160]['bound_ms'] * 1e3:.3f}, B={BATCH} "
          f"{b8['bound_ms'] * 1e3:.3f} us", flush=True)
    return {
        "name": "window_crop", "route": "cuda", "source": "smh_tpu_torch/csrc/window_crop.cu",
        "replaces": "smh_tpu/ops/pipeline.py:815", "max_abs_err": 0, **times[1080], "library_ms": None,
        "shape": "411x493 of 822x986", "device_us_4k": times[2160]["device_us"], "device_us_b8": us8,
    }


def phase_ocr_band(dev: torch.device) -> dict:
    """Kernel 11 (csrc/ocr_band.cu), the OCR row band and the keep bits,
    byte-equal to its plain twin on the card (every section), banded
    (binary and gray) and unbanded (binary): on testing.ocr_band_cases (a
    textless quadrant, text on the first or last row or near the bottom,
    band == h, a single text pixel, text at the strip seams of a cluster of
    8 and of 16, ragged widths (w % 16 of 1 and 15, w < 16), bands whose
    start puts both sections' first bytes at every value mod 16), kernel
    6's outputs on random text-like quadrants at both quadrant shapes at
    every rung of the band ladder, the verify frame's quadrant at 1080p and
    4K, and B = 1, 3 and 8 quadrants cut from the rows of one buffer (kernel
    6's batch; == the per-frame kernel); one launch per call, no memset
    (profiler). Timed on the verify frame's gray band at 1080p and 4K and on
    the unbanded keep bits at B = 8 beside its bound and the bytewise
    design's times."""
    from smh_tpu_torch import testing
    from smh_tpu_torch.ocr.engine import OCR_BINARY_THRESHOLD
    from smh_tpu_torch.ops import kernels as K
    from smh_tpu_torch.vision import cuda_backend as cb

    rng = np.random.default_rng(31)
    calls = 0

    def check(text, sbits, ocr, inline: str, band, label: str) -> tuple:
        nonlocal calls
        before = K.LAUNCHES["ocr_band"]
        got = K.ocr_band(text, sbits, ocr, inline, band)
        require(K.LAUNCHES["ocr_band"] == before + 1, f"ocr_band: not one launch for {label}")
        want = K.ocr_band_plain(text, sbits, ocr, inline, band)
        require(len(got) == len(want), f"ocr_band sections ({label})")
        for k, (g_, w_) in enumerate(zip(got, want)):
            require(g_.shape == w_.shape and g_.dtype == w_.dtype, f"ocr_band section {k} shape/dtype ({label})")
            if not torch.equal(g_, w_):
                at = torch.nonzero(g_ != w_)[:8].tolist()
                raise RuntimeError(f"check failed: ocr_band section {k} kernel != plain ({label}, {inline}, band "
                                   f"{band}) at {at}")
        calls += 1
        return got

    def every_route(text, sbits, ocr, bands, label: str) -> None:
        check(text, sbits, ocr, "binary", None, f"{label} unbanded")
        for band in bands:
            for inline in ("binary", "gray"):
                check(text, sbits, ocr, inline, band, f"{label} band {band}")

    def on_card(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    cases = testing.ocr_band_cases()
    for name, (ocr, band) in cases.items():
        h, w = ocr.shape
        sbits = on_card(rng.integers(0, 256, (h, (w + 7) // 8), dtype=np.uint8))
        every_route(on_card((ocr < OCR_BINARY_THRESHOLD).astype(np.uint8)), sbits, on_card(ocr), (band,), name)
    print(f"ocr_band: kernel == plain on the edge cases {sorted(cases)}, banded (binary, gray) and unbanded",
          flush=True)
    for h, w in ((411, 493), (822, 986)):
        for share in (0.005, 0.05, 0.5):
            q = torch.from_numpy(np.moveaxis(testing.text_rgb(rng, h, w, share), -1, 0).copy()).to(dev)
            out = K.brq_preprocess(q[0], q[1], q[2], K.classify_luma_planes(q[0], q[1], q[2])[1])
            every_route(out["text"], out["scales_bits"], out["ocr_img"], cb._dim_ladder(h),
                        f"kernel 6's {h}x{w} share {share}")
    print("ocr_band: kernel == plain on kernel 6's outputs over random text-like quadrants at 411x493 and 822x986 "
          "at every rung of the band ladder", flush=True)
    verify = {}
    for w, h in LIVE_SIZES:
        out = K.brq_preprocess(*map_brq(frame_for(w, h), dev))
        qh = out["text"].shape[0]
        band = cb._dim_ladder(qh)[1]
        every_route(out["text"], out["scales_bits"], out["ocr_img"], cb._dim_ladder(qh), f"verify frame {w}x{h}")
        smeta = check(out["text"], out["scales_bits"], out["ocr_img"], "gray", band, f"verify {w}x{h}")[0]
        oy0, oy1, b0 = smeta.cpu().view(torch.int32).tolist()
        require(0 <= oy0 < oy1 <= qh and b0 == min(oy0, qh - band), f"the verify frame's text rows {oy0}..{oy1}, "
                f"band at {b0}, at {w}x{h}")
        verify[h] = (out, band)

    h, w = 822, 986
    batched = {}
    for bsz in BATCH_SIZES:
        rows = torch.zeros((bsz, 3 * h * w + 37), dtype=torch.uint8, device=dev)
        for i in range(bsz):
            rgb = testing.text_rgb(rng, h, w, 0.01 * (i + 1))
            rows[i, : 3 * h * w] = torch.from_numpy(np.moveaxis(rgb[..., ::-1], -1, 0).reshape(-1)).to(dev)
        planes = rows[:, : 3 * h * w].view(bsz, 3, h, w)
        b8, g8, r8 = planes[:, 0], planes[:, 1], planes[:, 2]
        luma = K.classify_luma_planes(r8, g8, b8)[1]
        out = K.brq_preprocess(*(p[:, h // 2 :, w // 2 :] for p in (r8, g8, b8, luma)))
        args = (out["text"], out["scales_bits"], out["ocr_img"])
        for inline, band in (("binary", None), ("binary", 51), ("gray", 51)):
            got = check(*args, inline, band, f"B={bsz} strided")
            for i in range(bsz):
                one = K.ocr_band(*(a[i] for a in args), inline, band)
                require(all(torch.equal(g_[i], o_) for g_, o_ in zip(got, one)), f"ocr_band B={bsz} frame {i}")
        prof = device_profile(lambda: K.ocr_band(*args, "binary"), names=("ocr_band",))
        require(prof["launches"] == 1.0 and prof["named"]["ocr_band"] == 1.0,
                f"ocr_band B={bsz}: {prof['launches']} CUDA rows per call (kernels and memsets)")
        batched[bsz] = (args, prof["named_us"]["ocr_band"])
    print(f"ocr_band: B = {BATCH_SIZES} quadrants of {h // 2}x{w // 2} (kernel 6's outputs over one buffer's rows) "
          f"== plain and == the per-frame kernel, unbanded and banded; one CUDA launch per call, no memset "
          f"(profiler); device us per call, unbanded {({b: round(v[1], 2) for b, v in batched.items()})}", flush=True)

    def bound_of(bsz: int, qh: int, qw: int, band) -> dict:
        # the keep plane in (the band's start needs all of it); the band's
        # rows in and out (banded) or the keep bits out (unbanded)
        bpr = (qw + 7) // 8
        moved = qh * qw + (qh * bpr if band is None else 2 * band * (bpr + qw) + K.BAND_META)
        return bound(bsz * moved, bsz * 2 * qh * qw)

    times = {}
    for hh, (out, band) in verify.items():
        args = (out["text"], out["scales_bits"], out["ocr_img"], "gray", band)
        prof = device_profile(lambda: K.ocr_band(*args), names=("ocr_band",))
        require(prof["launches"] == 1.0, f"ocr_band: {prof['launches']} CUDA rows per call")
        times[hh] = {
            "ms": cuda_ms(lambda: K.ocr_band(*args)),
            "plain_ms": cuda_ms(lambda: K.ocr_band_plain(*args), n=10),
            "device_us": prof["named_us"]["ocr_band"], **bound_of(1, *out["text"].shape, band),
        }
        print(f"ocr_band: the gray band of {band} rows of the verify frame's {out['text'].shape[0]}x"
              f"{out['text'].shape[1]} quadrant at {hh}p: " + timing_line(times[hh]), flush=True)
    args, us8 = batched[BATCH]
    b8 = {"ms": cuda_ms(lambda: K.ocr_band(*args, "binary")), **bound_of(BATCH, h // 2, w // 2, None)}
    print(f"ocr_band: B={BATCH} unbanded keep bits of {h // 2}x{w // 2} quadrants (one launch): wrapper "
          f"{b8['ms']:.4f} ms, device {us8:.2f} us per batch ({us8 / BATCH:.2f} per frame) beside its bound "
          f"{b8['bound_ms']:.5f} ms ({b8['bound_by']}); {calls} calls held against plain, every byte equal",
          flush=True)
    print(f"ocr_band: device us, gray band {times[1080]['device_us']:.2f} / {times[2160]['device_us']:.2f}, unbanded "
          f"B={BATCH} {us8:.2f}, beside the bytewise design's {BYTEWISE_US['ocr_band']} and the bounds "
          f"{times[1080]['bound_ms'] * 1e3:.3f} / {times[2160]['bound_ms'] * 1e3:.3f}, B={BATCH} "
          f"{b8['bound_ms'] * 1e3:.3f} us", flush=True)
    return {
        "name": "ocr_band", "route": "cuda", "source": "smh_tpu_torch/csrc/ocr_band.cu",
        "replaces": "smh_tpu/ops/pipeline.py:826", "max_abs_err": 0, **times[1080], "library_ms": None,
        "shape": f"gray band of {verify[1080][1]} rows of 411x493", "device_us_4k": times[2160]["device_us"],
        "device_us_b8": us8,
    }


def phase_repeated(dev: torch.device) -> None:
    """Kernels 6, 7 and 9 called 100 times each, in turns, alternating
    shapes, batch sizes and budgets (every tenth call on a second stream,
    which has a scratch of its own), each result held to its plain twin:
    the state each kernel keeps between launches (its scratch) comes back
    clean."""
    from smh_tpu_torch import testing
    from smh_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(17)

    def quadrants(bsz: int, h: int, w: int) -> tuple:
        rows = torch.zeros((bsz, 3 * h * w + 37), dtype=torch.uint8, device=dev)
        for i in range(bsz):
            rgb = testing.text_rgb(rng, h, w, 0.3)
            rows[i, : 3 * h * w] = torch.from_numpy(np.moveaxis(rgb, -1, 0).reshape(-1)).to(dev)
        planes = rows[:, : 3 * h * w].view(bsz, 3, h, w)
        luma = K.classify_luma_planes_plain(planes[:, 0], planes[:, 1], planes[:, 2])[1]
        out = tuple(p[:, h // 2 :, w // 2 :] for p in (planes[:, 0], planes[:, 1], planes[:, 2], luma))
        return out if bsz > 1 else tuple(p[0] for p in out)

    def masks(bsz: int, h: int, w: int, density: float) -> torch.Tensor:
        n = h * ((w + 7) // 8)
        rows = torch.zeros((bsz, n + 5), dtype=torch.uint8, device=dev)
        for i in range(bsz):
            rows[i, :n] = torch.from_numpy(np.packbits(rng.random((h, w)) < density, axis=1).reshape(-1)).to(dev)
        bits = rows[:, :n].view(bsz, h, (w + 7) // 8)
        return bits if bsz > 1 else bits[0]

    k6 = [quadrants(b, h, w) for b, h, w in ((1, 822, 986), (3, 74, 500), (1, 1644, 1972), (8, 822, 986))]
    k6 = [(p, K.brq_preprocess_plain(*p)) for p in k6]
    k7 = [(masks(b, h, w, d), w, budget) for b, h, w, d, budget in
          ((1, 822, 986, 0.001, 1024), (3, 300, 250, 0.02, 64), (1, 1644, 1972, 0.5, 32768),
           (8, 822, 986, 0.0005, 256), (1, 1644, 1972, 0.0005, 1024), (8, 822, 986, 0.0005, 2048),
           (1, 1644, 1972, 0.0005, 32768))]
    k7 = [(bits, w, budget, K.mask_bbox_sparse_plain(bits, w, budget)) for bits, w, budget in k7]

    def tails(bsz: int, h: int, w: int, n_ui: int, bh: int, bw: int, sections: tuple) -> tuple:
        lead = (bsz,) if bsz > 1 else ()
        ui = tuple(torch.randint(0, 256, (*lead, h, w), dtype=torch.uint8, device=dev) for _ in range(n_ui))
        btn = torch.randint(0, 256, (*lead, bh, bw, 3), dtype=torch.uint8, device=dev)
        btn.view(-1, 3)[::3] = torch.tensor([49, 67, 217], dtype=torch.uint8, device=dev)
        return ui, btn, [torch.randint(0, 256, (*lead, n), dtype=torch.uint8, device=dev) for n in sections]

    k9 = [tails(*a) for a in ((1, 822, 986, 1, 41, 255, (24, 16, 1168, 16, 4, 4096, 4096)),
                              (3, 74, 500, 3, 5, 7, (24, 13)), (1, 1644, 1972, 3, 83, 510, (24, 16, 1168, 16)),
                              (8, 822, 986, 1, 41, 255, (24, 16, 1168, 16, 4, 8192, 8192)))]
    k9 = [(args, K.hostpack_tail_plain(*args)) for args in k9]
    side = torch.cuda.Stream(dev)
    for i in range(100):
        planes, want6 = k6[i % len(k6)]
        bits, w, budget, want7 = k7[i % len(k7)]
        stream = side if i % 10 == 9 else torch.cuda.current_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        args9, want9 = k9[i % len(k9)]
        with torch.cuda.stream(stream):
            got6 = K.brq_preprocess(*planes)
            got7 = K.mask_bbox_sparse(bits, w, budget)
            got9 = K.hostpack_tail(*args9)
        torch.cuda.synchronize(dev)
        require(torch.equal(got9, want9), f"repeated call {i}: hostpack != plain")
        for k, v in want6.items():
            require(torch.equal(got6[k], v), f"repeated call {i}: brq_preprocess {k} != plain")
        require(torch.equal(got7, want7), f"repeated call {i}: mask_words != plain (budget {budget})")
    print(f"repeated: 100 calls each of brq_preprocess ({len(k6)} shapes and batch sizes in turn), mask_words "
          f"({len(k7)} shapes, batch sizes and budgets in turn) and hostpack ({len(k9)} shapes, plane counts and "
          f"batch sizes in turn), every tenth on a second stream, each == its plain twin", flush=True)


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


def ray_march_lines(w: int, h: int) -> list:
    """The ray march's test lines for a frame size (map-ROI coordinates):
    the verify frame's marker, a long diagonal, one line that ends on the
    last column and one that touches the first column and the first row."""
    from smh_tpu_torch import consts as C

    k = w // 1920
    (x0, y0), (x1, y1) = MARKER[0]
    map_w = C.map_geometry(w, h).map_w
    return [((x0 * k, y0 * k), (x1 * k, y1 * k)), ((30 * k, 700 * k), (900 * k, 60 * k)),
            ((200 * k, 420 * k), (map_w - 1, 330 * k)), ((0, 500 * k), (400 * k, 0))]


def ray_march_seeds(rng, mask: np.ndarray, b: int, edge: bool) -> np.ndarray:
    """f32 [b, 2] (x, y) seeds: with `edge`, b // 4 on the plane's border
    (corners, edge midpoints, the border ends of the lines: their rays leave
    the plane at once); then half the rest on drawn lines and the others on
    background pixels."""
    h, w = mask.shape
    border = [(0, 0), (w - 1, h - 1), (w - 1, 0), (0, h - 1), (w // 2, 0), (0, h // 2), (w - 1, h // 3),
              (w // 3 + 0.5, h - 1)]
    border += [(float(x), float(y)) for y, x in np.argwhere(mask == 255) if x in (0, w - 1) or y in (0, h - 1)]
    n_edge = b // 4 if edge else 0
    picked = [border[i] for i in rng.choice(len(border), n_edge, replace=False)]
    white_y, white_x = np.nonzero(mask == 255)
    black_y, black_x = np.nonzero(mask[::7, ::7] == 0)
    n_line = (b - n_edge + 1) // 2
    on_line = rng.choice(white_y.size, n_line, replace=False)
    off_line = rng.choice(black_y.size, b - n_edge - n_line, replace=False)
    return np.concatenate([
        np.array(picked, np.float32).reshape(-1, 2),
        np.stack([white_x[on_line], white_y[on_line]], axis=1),
        np.stack([black_x[off_line] * 7, black_y[off_line] * 7], axis=1),
    ]).astype(np.float32)


def touched_mask_bytes(shape, pts_t, cos_t, sin_t, steps) -> int:
    """The distinct mask bytes that steps 0 .. steps - 1 of each (seed,
    angle) lane sample, steps i64 [B, N]: the in-plane positions' pixels,
    each counted once however many lanes read it."""
    h, w = shape
    n = cos_t.numel()
    flat = steps.flatten()
    lane = torch.repeat_interleave(torch.arange(flat.numel(), device=flat.device), flat)
    k = (torch.arange(lane.numel(), device=flat.device) - (torch.cumsum(flat, 0) - flat)[lane]).float()
    px = pts_t[lane // n, 0] + cos_t[lane % n] * k
    py = pts_t[lane // n, 1] + sin_t[lane % n] * k
    inside = (px >= 0) & (py >= 0) & (px < w) & (py < h)
    return int(torch.unique(py[inside].long() * w + px[inside].long()).numel())


def phase_ray_march(dev: torch.device) -> dict:
    """Kernel 4 against its plain version: ends, winners and lengths
    bit-equal, on the map shapes, with border, line and background seeds,
    B = 1, 8 and 16, max_gap 15 and 31 (a run across a word seam), with and
    without max_len, on both kinds of positions (closed form, and the
    oracle's accumulated offsets that the live engine marches on); then its
    time and launches per call at B = 8, each kind."""
    from smh_tpu_torch import consts as C
    from smh_tpu_torch.ops import lsd as L

    rng = np.random.default_rng(1)
    mg = int(C.LSD_MAX_GAP)
    cos_t, sin_t = L.theta_tables(dev)
    times = {}
    err = 0.0
    for w, h in ((1920, 1080), (3840, 2160)):
        gm = C.map_geometry(w, h)
        mask = line_mask(gm.map_h, gm.map_w, ray_march_lines(w, h))
        mask_t = torch.from_numpy(mask).to(dev)
        diag = float(np.hypot(*mask.shape)) + 1.0
        for b in (1, 8, 16):
            pts = ray_march_seeds(rng, mask, b, edge=True)
            pts_t = torch.from_numpy(pts).to(dev)
            for gap in (mg, 31):
                for max_len, acc in ((None, False), (diag, False), (None, True), (diag, True)):
                    k_total = L.step_bound(gm.map_h, gm.map_w, gap, max_len)
                    got = L.ray_march(mask_t, pts_t, gap, k_total, cos_t, sin_t, accumulate=acc)
                    ex, ey = L.march_plain(mask_t, pts_t, gap, k_total, cos_t, sin_t, accumulate=acc)
                    want = (ex, ey, *L.finalize_plain(pts_t, ex, ey))
                    torch.cuda.synchronize()
                    for name, g_, w_ in zip(("end_x", "end_y", "best_x", "best_y", "best_len"), got, want):
                        err = max(err, float((g_ - w_).abs().max()))
                        require(torch.equal(g_, w_), f"ray_march {name} != plain at {gm.map_h}x{gm.map_w} "
                                f"B={b} max_gap={gap} max_len={max_len} accumulate={acc}")
            at_start = int(((got[0] == pts_t[:, 0:1]) & (got[1] == pts_t[:, 1:2])).sum())
            print(f"kernels: ray_march {gm.map_h}x{gm.map_w} B={b} ({b // 4} border, {(b - b // 4 + 1) // 2} line, "
                  f"rest background seeds) bit-equal at max_gap {mg} and 31, with and without max_len, closed "
                  f"and accumulated positions; longest "
                  f"ray {float(got[4].max().sqrt()):.2f} px, {at_start} of {got[0].numel()} lanes end at their "
                  f"start", flush=True)
        pts_t = torch.from_numpy(ray_march_seeds(rng, mask, 8, edge=False)).to(dev)
        k_total = L.step_bound(gm.map_h, gm.map_w, mg, diag)
        got = L.ray_march(mask_t, pts_t, mg, k_total, cos_t, sin_t)
        ex, ey = L.march_plain(mask_t, pts_t, mg, k_total, cos_t, sin_t)
        for name, g_, w_ in zip(("end_x", "end_y", "best_x", "best_y", "best_len"), got,
                                (ex, ey, *L.finalize_plain(pts_t, ex, ey))):
            require(torch.equal(g_, w_), f"ray_march {name} != plain at {gm.map_h}x{gm.map_w} on the timed seeds")
        # The samples this run's lanes must take: each from its seed to its
        # end and max_gap + 2 steps past it; ~10 float32 operations each
        # (two multiplies and two adds for the position, four compares for
        # the plane, two casts). The bytes: the distinct mask bytes those
        # samples read, the ends (8 B per lane), the winners (12 B per seed),
        # the seeds and the theta table.
        steps = torch.hypot(ex - pts_t[:, 0:1], ey - pts_t[:, 1:2]).ceil().long() + mg + 2
        nbytes = (touched_mask_bytes(mask.shape, pts_t, cos_t, sin_t, steps) + 8 * ex.numel()
                  + 20 * pts_t.shape[0] + 8 * cos_t.numel())
        prof = device_profile(lambda: L.ray_march(mask_t, pts_t, mg, k_total, cos_t, sin_t))
        us, per_call = prof["us"], prof["launches"]
        require(per_call == 1.0, f"ray_march made {per_call} CUDA launches per call, not 1")
        times[h] = {
            "ms": cuda_ms(lambda: L.ray_march(mask_t, pts_t, mg, k_total, cos_t, sin_t)),
            "plain_ms": cuda_ms(
                lambda: L.finalize_plain(pts_t, *L.march_plain(mask_t, pts_t, mg, k_total, cos_t, sin_t)), n=5),
            "device_us": us,
            **bound(nbytes, 10 * float(steps.sum())),
        }
        print(f"kernels: ray_march {gm.map_h}x{gm.map_w} B=8 k_total={k_total}: {per_call:.0f} CUDA launch per "
              f"call, longest ray {float(torch.hypot(ex - pts_t[:, 0:1], ey - pts_t[:, 1:2]).max()):.2f} px; "
              + timing_line(times[h]), flush=True)
        got = L.ray_march(mask_t, pts_t, mg, k_total, cos_t, sin_t, accumulate=True)
        ex, ey = L.march_plain(mask_t, pts_t, mg, k_total, cos_t, sin_t, accumulate=True)
        for name, g_, w_ in zip(("end_x", "end_y", "best_x", "best_y", "best_len"), got,
                                (ex, ey, *L.finalize_plain(pts_t, ex, ey))):
            require(torch.equal(g_, w_), f"accumulated ray_march {name} != plain at {gm.map_h}x{gm.map_w} on the "
                    "timed seeds")
        prof = device_profile(lambda: L.ray_march(mask_t, pts_t, mg, k_total, cos_t, sin_t, accumulate=True))
        require(prof["launches"] == 1.0, f"accumulated ray_march made {prof['launches']} CUDA launches per call")
        acc = {"ms": cuda_ms(lambda: L.ray_march(mask_t, pts_t, mg, k_total, cos_t, sin_t, accumulate=True)),
               "plain_ms": cuda_ms(lambda: L.finalize_plain(
                   pts_t, *L.march_plain(mask_t, pts_t, mg, k_total, cos_t, sin_t, accumulate=True)), n=2),
               "device_us": prof["us"], **bound(nbytes, 10 * float(steps.sum()))}
        print(f"kernels: ray_march accumulated {gm.map_h}x{gm.map_w} B=8 k_total={k_total}: 1 CUDA launch per "
              f"call; " + timing_line(acc), flush=True)
    return {
        "name": "ray_march", "route": "cuda",
        "source": "smh_tpu_torch/csrc/ray_march.cu",
        "replaces": "smh_tpu/ops/lsd.py:96",
        "max_abs_err": err, **times[1080], "library_ms": None, "shape": "822x986, 8 seeds",
        "device_us_by_height": {h: t["device_us"] for h, t in times.items()},
    }


def new_state(device, hardware: bool = True, engine=None):
    from smh_tpu_torch.ocr.smhocr import SmhOcrEngine
    from smh_tpu_torch.settings import Settings
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


ORACLE: dict = {}  # (w, h) -> summary of the oracle's result on frame_for(w, h), from phase_slice


def phase_slice(dev: torch.device) -> dict:
    from smh_tpu_torch.squadex.capture import Frame
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
            require(all(K.LAUNCHES[n] == 1 for n in K.FUSED_PASS), f"not one launch of each kernel: {K.LAUNCHES}")
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
        ORACLE[(w, h)] = summarize(ref)
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
        # The drawn bar spans 120k px with end bars, so it measures 120k - 2;
        # the oracle's host OCR reads the same text from the bundled fonts.
        require(res.meters_to_px_ratio is not None and abs(res.meters_to_px_ratio - want_ratio) < 1e-9,
                f"ratio {res.meters_to_px_ratio} vs {want_ratio}")
        require(ref.meters_to_px_ratio == res.meters_to_px_ratio,
                f"ratio {res.meters_to_px_ratio} vs oracle {ref.meters_to_px_ratio}")
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
    from smh_tpu_torch import consts as C
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
    from smh_tpu_torch import consts as C

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
    from smh_tpu_torch import consts as C
    from smh_tpu_torch.ocr.engine import OCR_BINARY_THRESHOLD
    from smh_tpu_torch.vision.reference import ReferenceBackend
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
            require(all(K.LAUNCHES[n] > 0 for n in EVERY_PASS + ("hostpack",) + K.WINDOW_PASS + K.BAND_PASS),
                    f"transports skipped a kernel: {K.LAUNCHES}")
    print("transports: D2H bytes per frame " + json.dumps(d2h), flush=True)
    return launches


def phase_debug(dev: torch.device) -> dict:
    """Every debug view of the card's backend with the debug re-pass equals
    the CPU path's."""
    from smh_tpu_torch.vision.reference import DebugView
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
    from smh_tpu_torch.squadex.capture import Frame
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
            state.settings.set("lsd_engine", "cuda", save=False)
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
    from smh_tpu_torch.squadex.capture import Frame
    from smh_tpu_torch.vision.pipeline import DebugBox

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
    (the gray band every frame). The host smhocr reads the port's bundled
    fonts, so the Tesseract-flagged rows time the transport and the read.
    On the main path's state, a torch.profiler trace of warm sync frames
    counts the CUDA launches (kernels, memsets and copies: the rows whose
    device_type is CUDA), the scales read's one launch, and the device time
    per frame."""
    from smh_tpu_torch.ops import kernels as K
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
            state.settings.set("lsd_engine", "cuda", save=False)
            K.reset_launches()
            samples, stages, res = _timed(state, static, warm=5)
            marches = K.LAUNCHES["ray_march"] / (len(samples) + 5)
        finally:
            state.close()
        print(f"timing: process() {w}x{h} lsd_engine=cuda {_summary(samples, stages)}, {marches:.2f} ray_march "
              f"launches per sync frame on {card}", flush=True)
        state = new_state(dev)
        try:
            samples, stages, res = _timed(state, static)
            per_frame = launches_per_frame(state, static[0])
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
        named = ", ".join(f"{n} {per_frame['named'][n]:.1f} of {per_frame['named_us'][n]:.2f} us"
                          for n in per_frame["named"])
        print(f"timing: sync process() {w}x{h}: {per_frame['launches']:.1f} CUDA launches per frame "
              f"({per_frame['kernels']:.1f} kernels and {per_frame['launches'] - per_frame['kernels']:.1f} "
              f"memset/copy rows; among the kernels {named}), device busy "
              f"{per_frame['device_ms']:.3f} ms per frame (profiler, {per_frame['frames']} warm frames) on {card}",
              flush=True)


def binary_flagged():
    """smhocr's reader without the device read (binary_ok and image_derived,
    device_ok False): the binary band route."""
    from smh_tpu_torch.ocr.smhocr import SmhOcrEngine

    class BinaryFlagged(SmhOcrEngine):
        device_ok = False

    return BinaryFlagged()


@functools.lru_cache(maxsize=None)
def legend_pan_frames(w: int, h: int) -> tuple:
    """frame_for's marker line with the scale legend moving 2 px right a
    frame (at 1080p scale): the marker's window fits every frame and the
    scales checksum changes every frame, so the scales images stay inline."""
    from smh_tpu_torch import testing

    k = w // 1920
    (x0, y0), (x1, y1) = MARKER[0]
    return tuple(
        testing.make_frame(
            w, h, marker_lines=[((x0 * k, y0 * k), (x1 * k, y1 * k))],
            scale_texts=[("300m", ((60 + 2 * i) * k, 170 * k))],
            scale_bars=[((60 + 2 * i) * k, 170 * k + 30, 120 * k, 1)],
        )
        for i in range(DRAG_FRAMES)
    )


@functools.lru_cache(maxsize=None)
def short_drag_frames(w: int, h: int) -> tuple:
    """A marker drag whose line stays inside BatchPipeline's half-size
    window with its margin (the far end from (300, 320) moving 8 px right
    and 5 px up a frame, at 1080p scale), with frame_for's scale legend."""
    from smh_tpu_torch import testing

    k = w // 1920
    return tuple(
        testing.make_frame(
            w, h, marker_lines=[((120 * k, 150 * k), ((300 + 8 * i) * k, (320 - 5 * i) * k))],
            scale_texts=[("300m", (60 * k, 170 * k))], scale_bars=[(60 * k, 170 * k + 30, 120 * k, 1)],
        )
        for i in range(DRAG_FRAMES)
    )


def phase_routes(dev: torch.device, card: str) -> None:
    """With SMH_SPARSE=0, torch.profiler's CUDA rows per warm sync frame of
    the window + gray band route (a Tesseract-flagged engine) and of the
    window + binary band route (smhocr without the device read), over
    frame_for's marker with a panning legend (the ladders settled first):
    kernels 1-3 and 6-11 once each and no other kernel (9, no scales read),
    at most 3 memset/copy rows; then per delta batch of BatchPipeline(batch=8)
    with its half-size window and the unbanded binary keep bits over a
    marker drag that stays in the window: each of those kernels once and no
    other, at most 3 memset/copy rows (a window miss would add the fetch of
    its frames' full mask)."""
    from smh_tpu_torch.squadex.capture import Frame
    from smh_tpu_torch.ops import kernels as K
    from smh_tpu_torch.vision.batch import BatchPipeline

    # The pass's kernels but the scales read, the delta apply, the window
    # crop and the OCR band.
    names = tuple(n for n in K.FUSED_PASS if n != "scales_read") + K.DELTA_PASS + K.WINDOW_PASS + K.BAND_PASS
    with sparse_off():
        for w, h in LIVE_SIZES:
            frames = legend_pan_frames(w, h)
            for label, factory, inline in (("window + gray band", tesseract_flagged, "gray"),
                                           ("window + binary band", binary_flagged, "binary")):
                state = new_state(dev, engine=factory())
                try:
                    for i in range(3 * len(frames)):  # the window and band ladders settle
                        require(state.process(Frame(frames[i % len(frames)], 96)) is not None, "map gate closed")
                    be = state.delegate.backend
                    before = dict(be.stats)
                    at = [0]

                    def step():
                        at[0] += 1
                        state.process(Frame(frames[at[0] % len(frames)], 96))

                    prof = device_profile(step, n=len(frames), names=names)
                    f, after = be._dispatch_flags, dict(be.stats)
                finally:
                    state.close()
                tag = f"{w}x{h} {label}"
                require(f.sparse is None and f.crop_h is not None and f.inline == inline and f.band is not None,
                        f"{tag}: not the route: {f}")
                require(all(after[k] == before[k] for k in ("lsd_window_misses", "scales_band_misses",
                                                             "scalespack_fetches")),
                        f"{tag}: misses or fetches while profiled: {before} -> {after}")
                require(prof["named"] == {n: 1.0 for n in names}, f"{tag}: not one launch of each kernel per sync "
                        f"frame: {prof['named']}")
                rows = prof["launches"] - prof["kernels"]
                require(prof["kernels"] == len(names) and rows <= 3,
                        f"{tag}: {prof['kernels']} kernels and {rows} memset/copy rows per sync frame")
                named = ", ".join(f"{n} {prof['named_us'][n]:.2f}" for n in names)
                print(f"routes: sync process() {tag} (window {f.crop_h}x{f.crop_w}, band {f.band}): "
                      f"{prof['kernels']:.1f} kernels ({named} us) and {rows:.1f} memset/copy rows per frame "
                      f"{prof['rows']}, device "
                      f"busy {prof['us'] / 1e3:.4f} ms per frame (profiler, {len(frames)} warm frames) on {card}",
                      flush=True)
            batches = _batches(short_drag_frames(w, h), BATCH)
            bp = BatchPipeline(w, h, batch=BATCH, ocr_engine=binary_flagged(), device=dev)
            try:
                require(bp.crop_h is not None and bp.sparse_budget is None and bp._scales_inline() == "binary",
                        f"{w}x{h} batch: not the window + binary route")
                for b in batches:
                    bp.process(b)
                prof = device_profile(lambda: bp.process(batches[1]), n=1, names=names, tries=6)
            finally:
                bp.close()
            tag = f"{w}x{h} batch window + binary B={BATCH}"
            require(prof["named"] == {n: 1.0 for n in names}, f"{tag}: {prof['named']}")
            rows = prof["launches"] - prof["kernels"]
            require(prof["kernels"] == len(names) <= MAX_KERNELS_PER_PASS and rows <= 3,
                    f"{tag}: {prof['kernels']} kernels and {rows} memset/copy rows per delta batch {prof['rows']}")
            print(f"routes: {tag} ({bp.crop_h}x{bp.crop_w}): {prof['kernels']:.0f} kernels and "
                  f"{rows:.0f} memset/copy rows per delta batch {prof['rows']}, device "
                  f"{prof['kernel_us'] / 1e3:.4f} ms per batch on {card}", flush=True)


def launches_per_frame(state, frame_np, frames: int = 5) -> dict:
    """device_profile over `frames` warm sync process() calls: the CUDA rows
    (kernels, memsets, copies) per frame, the kernels among them, the quiet
    walk's launches, and the device time per frame."""
    from smh_tpu_torch.squadex.capture import Frame

    from smh_tpu_torch.ops import kernels as K

    names = K.FUSED_PASS + K.DELTA_PASS  # a warm sync frame of a static scene is a delta frame
    prof = device_profile(lambda: state.process(Frame(frame_np, 96)), n=frames, names=names)
    require(prof["launches"] > 0, "the profiler saw no device rows")
    require(prof["named"] == {n: 1.0 for n in names}, f"not one launch of each kernel per sync frame: "
            f"{prof['named']}")
    require(prof["kernels"] <= MAX_KERNELS_PER_PASS, f"{prof['kernels']} kernels per sync frame")
    return {"frames": frames, "launches": prof["launches"], "kernels": prof["kernels"], "named": prof["named"],
            "named_us": prof["named_us"], "device_ms": prof["us"] / 1e3}


def phase_loop(dev: torch.device) -> None:
    from smh_tpu_torch.squadex.capture import CaptureThread, StaticSource
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


@functools.lru_cache(maxsize=None)
def drag_frames(w: int, h: int, pan: bool = False) -> tuple:
    """A marker drag: the far end moves 8 px right and 5 px up per frame
    (at 1080p scale). pan=True also moves the scale legend 2 px right per
    frame, so the scales checksum changes every frame and the scales
    images stay inline (a static legend drops to checksum-only). Made once
    per process: the phases only read them."""
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
    return tuple(frames)


def summarize(r) -> tuple:
    from smh_tpu_torch.parallel.dryrun import summarize as values

    return values(r)


_TRUTHS: dict = {}  # (device, id(frames), engine_factory) -> (frames, truth)


def _truth(dev: torch.device, frames: tuple, engine_factory=None) -> dict:
    """{summary of the synchronous result: frame index} over `frames` (once
    per process for each drag and engine)."""
    from smh_tpu_torch.squadex.capture import Frame

    key = (str(dev), id(frames), engine_factory)
    if key not in _TRUTHS:
        state = new_state(dev, engine=engine_factory() if engine_factory else None)
        try:
            truth = {summarize(state.process(Frame(f, 96))): i for i, f in enumerate(frames)}
        finally:
            state.close()
        require(len(truth) == len(frames), f"drag frames are not distinct: {len(truth)}")
        _TRUTHS[key] = (frames, truth)  # holding the frames keeps their id theirs
    return _TRUTHS[key][1]


def _live_run(dev, frames, truth, threaded: bool, fps, want: int, engine_factory=None) -> tuple:
    """The pipelined VisionLoop over `frames` cycling until `want` updates
    (at most 120 s) -> (updates as (time, truth index or -1, ms since the
    loop took that frame), the backend, the launch counts of the run)."""
    from smh_tpu_torch.squadex.capture import CaptureThread, Frame
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
    from smh_tpu_torch.squadex.capture import Frame
    from smh_tpu_torch.ops import kernels as K

    launches = {name: 0 for name in K.LAUNCHES}
    table = []
    errors = ErrorCount()
    logging.getLogger("smh_tpu_torch").addHandler(errors)
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
                    require(all(run[n] > 0 for n in K.FUSED_PASS + K.DELTA_PASS), f"{label}: skipped a kernel {run}")
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
        logging.getLogger("smh_tpu_torch").removeHandler(errors)
    print("live: " + json.dumps(table), flush=True)
    return launches


def phase_live_window(dev: torch.device, card: str) -> dict:
    """The panning drag, pipelined, threaded and uncapped, with SMH_SPARSE=0
    and the gray band (a Tesseract-flagged engine): the window crop and the
    band (kernels 10 and 11, each launched) ride the submit half, which must
    not sync the host."""
    from smh_tpu_torch.squadex.capture import Frame
    from smh_tpu_torch.ops import kernels as K

    launches = {name: 0 for name in K.LAUNCHES}
    want = 60
    errors = ErrorCount()
    logging.getLogger("smh_tpu_torch").addHandler(errors)
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
                require(all(run[n] > 0 for n in K.WINDOW_PASS + K.BAND_PASS), f"{label}: launches {run}")
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
        logging.getLogger("smh_tpu_torch").removeHandler(errors)
    return launches


def phase_app(dev: torch.device) -> dict:
    """`python -m smh_tpu_torch.app --synthetic --pipelined --no-web` without
    the signal handler: the CLI's source and flags, an update, a clean stop."""
    from smh_tpu_torch import app as tapp
    from smh_tpu_torch.settings import Settings
    from smh_tpu_torch.ops import kernels as K

    args = tapp.build_parser().parse_args(["--synthetic", "--pipelined", "--no-web", "--device", str(dev)])
    settings = Settings(path=None)
    settings.set("hardware_acceleration", True, save=False)
    errors = ErrorCount()
    logging.getLogger("smh_tpu_torch").addHandler(errors)
    K.reset_launches()
    app = tapp.App(
        tapp._build_source(args), settings=settings, device=args.device,
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
        logging.getLogger("smh_tpu_torch").removeHandler(errors)
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


BATCH_SIZES = (1, 3, 8)
BATCH = 8  # the batch pipeline's batch


def batch_rows(rng, bsz: int, w: int, h: int, extra: int = 0) -> tuple:
    """(u8 [B, padded + extra] rows on the host, padded): each row a frame
    as BatchPipeline packs it (B, G, R planes of the map ROI, then the
    button); random pixels with a quiet box over the centre and sprinkled
    marker-coloured pixels."""
    from smh_tpu_torch import consts as C
    from smh_tpu_torch.vision.cuda_backend import _DELTA_CHUNK

    gm = C.map_geometry(w, h)
    mh, mw = gm.map_h, gm.map_w
    used = (mh * mw + gm.btn_h * gm.btn_w) * 3
    padded = (used + _DELTA_CHUNK - 1) // _DELTA_CHUNK * _DELTA_CHUNK
    rows = rng.integers(0, 256, (bsz, padded + extra), dtype=np.uint8)
    planes = rows[:, : 3 * mh * mw].reshape(bsz, 3, mh, mw)
    for i in range(bsz):
        planes[i, :, mh // 4 : mh - mh // 4, mw // 4 : mw - mw // 4] = 90 + 20 * i
        hit = rng.random((mh, mw)) < 0.02
        for c, v in enumerate(ALPHA_BGRA[:3]):
            planes[i, c][hit] = v
    return rows, padded


def batch_calls(planes: torch.Tensor) -> dict:
    """{kernel: (the batched call, frame i's plain call, frame i's per-frame
    kernel call)} on u8 [B, 3, H, W] planes (B, G, R), each returning a
    tuple of outputs. Kernel 6 reads the quadrant's windows of the planes
    and of their luma, kernel 7 their dilated marker mask's bits (from the
    plain versions), at budget MASK_BUDGET."""
    from smh_tpu_torch.ops import kernels as K

    b8, g8, r8 = planes[:, 0], planes[:, 1], planes[:, 2]
    h, w = r8.shape[-2:]
    luma = K.classify_luma_planes_plain(r8, g8, b8)[1]
    bits = K.fused_mask_bits_plain(r8, g8, b8)
    q = (Ellipsis, slice(h // 2, 2 * (h // 2)), slice(w // 2, 2 * (w // 2)))
    brq = [p[q] for p in (r8, g8, b8, luma)]
    return {
        "classify_luma": (lambda: K.classify_luma_planes(r8, g8, b8),
                          lambda i: K.classify_luma_planes_plain(r8[i], g8[i], b8[i]),
                          lambda i: K.classify_luma_planes(r8[i], g8[i], b8[i])),
        "fused_mask": (lambda: (K.fused_mask_bits(r8, g8, b8),),
                       lambda i: (K.fused_mask_bits_plain(r8[i], g8[i], b8[i]),),
                       lambda i: (K.fused_mask_bits(r8[i], g8[i], b8[i]),)),
        "quiet_walk": (lambda: (K.minimap_rect_planes(b8, g8, r8),),
                       lambda i: (K.minimap_rect_planes_plain(b8[i : i + 1], g8[i : i + 1], r8[i : i + 1])[0],),
                       lambda i: (K.minimap_rect_planes(b8[i : i + 1], g8[i : i + 1], r8[i : i + 1])[0],)),
        "brq_preprocess": (lambda: tuple(K.brq_preprocess(*brq).values()),
                           lambda i: tuple(K.brq_preprocess_plain(*(p[i] for p in brq)).values()),
                           lambda i: tuple(K.brq_preprocess(*(p[i] for p in brq)).values())),
        "mask_words": (lambda: (K.mask_bbox_sparse(bits, w, MASK_BUDGET),),
                       lambda i: (K.mask_bbox_sparse_plain(bits[i], w, MASK_BUDGET),),
                       lambda i: (K.mask_bbox_sparse(bits[i], w, MASK_BUDGET),)),
    }


def check_batched(name: str, calls: tuple, bsz: int, label: str) -> None:
    """The batched call's frames are bit-equal to the plain version's and
    to the per-frame kernel's."""
    batched, plain, single = calls
    got = batched()
    for i in range(bsz):
        for g_, p_, s_ in zip(got, plain(i), single(i)):
            require(torch.equal(g_[i], p_), f"batched {name} != plain at {label}, frame {i}")
            require(torch.equal(g_[i], s_), f"batched {name} != per-frame kernel at {label}, frame {i}")


def phase_batch_kernels(dev: torch.device) -> dict:
    """Kernels 1-3, 6 and 7 over a whole batch in one launch, against their
    plain versions and the per-frame kernels, frame by frame; their device
    time per call and per frame."""
    from smh_tpu_torch import consts as C

    rng = np.random.default_rng(3)
    table = {}
    for w, h in LIVE_SIZES:
        gm = C.map_geometry(w, h)
        n_px = gm.map_h * gm.map_w
        for bsz in BATCH_SIZES:
            for extra in (0, 1):
                host, padded = batch_rows(rng, bsz, w, h, extra)
                rows = torch.from_numpy(host).to(dev)
                label = f"{gm.map_h}x{gm.map_w} B={bsz} frame stride {padded + extra}"
                for name, calls in batch_calls(rows[:, : 3 * n_px].view(bsz, 3, gm.map_h, gm.map_w)).items():
                    check_batched(name, calls, bsz, label)
                    if extra:
                        continue
                    prof = device_profile(calls[0])
                    us, per_call, other = prof["kernel_us"], prof["kernels"], prof["launches"] - prof["kernels"]
                    require(per_call == 1.0, f"batched {name} made {per_call} kernel launches per call at {label}")
                    b = bound(bsz * kernel_bytes(name, gm.map_h, gm.map_w), 0.0)
                    table.setdefault(name, {}).setdefault(f"{gm.map_h}x{gm.map_w}", {})[bsz] = {
                        "us": us, "us_per_frame": us / bsz, "bound_us": b["bound_ms"] * 1e3,
                        "ms": cuda_ms(calls[0]), "other_rows": other,
                    }
                    print(f"batch kernels: {name} {label}: bit-equal to the plain version and the per-frame "
                          f"kernel, 1 kernel launch per call (+{other:.0f} memset/copy rows), device {us:.2f} us "
                          f"per call = {us / bsz:.2f} us per frame, bound {b['bound_ms'] * 1e3:.2f} us (bytes)",
                          flush=True)
            print(f"batch kernels: {gm.map_h}x{gm.map_w} B={bsz}: the {len(table)} batched entries bit-equal at frame "
                  f"strides {padded} and {padded + 1}", flush=True)
    # H * W % 4 != 0: the batched classify writes each frame's outputs into
    # a row padded to 4 bytes, and returns views of them.
    mh, mw, bsz = 37, 53, 3
    host = rng.integers(0, 256, (bsz, 3 * mh * mw + 5), dtype=np.uint8)
    host[:, : 3 * mh * mw].reshape(bsz, 3, mh * mw)[:, :, ::7] = np.array(ALPHA_BGRA[:3], np.uint8)[:, None]
    rows = torch.from_numpy(host).to(dev)
    label = f"{mh}x{mw} B={bsz} frame stride {host.shape[1]}"
    for name, calls in batch_calls(rows[:, : 3 * mh * mw].view(bsz, 3, mh, mw)).items():
        check_batched(name, calls, bsz, label)
    print(f"batch kernels: {label}: the batched entries bit-equal (classify's outputs in padded rows)",
          flush=True)
    print("batch kernels: " + json.dumps(table), flush=True)
    return table


def _batches(frames: list, bsz: int) -> list:
    """24 frames of the cycling drag as 3 batches: a full upload, then delta
    batches (the second starts over the cycle's end)."""
    seq = (frames * 3)[: 3 * bsz]
    return [seq[i : i + bsz] for i in range(0, len(seq), bsz)]


def phase_batch(dev: torch.device, card: str) -> dict:
    """BatchPipeline(batch=8) with smhocr over the marker drag: results
    against the per-frame VisionState and the oracle, stream() against
    process(), launches per batch, H2D bytes per batch, frames/s."""
    from smh_tpu_torch.ocr.smhocr import SmhOcrEngine
    from smh_tpu_torch.ops import kernels as K
    from smh_tpu_torch.vision.batch import BatchPipeline

    launches = {name: 0 for name in K.LAUNCHES}
    for w, h in LIVE_SIZES:
        frames = drag_frames(w, h)
        want = {i: s for s, i in _truth(dev, frames).items()}
        # The drag's first frame is frame_for's, whose oracle result
        # phase_slice kept.
        ref, got = ORACLE[(w, h)], want[0]
        require(np.array_equal(frames[0], frame_for(w, h)), "the drag does not start on frame_for's frame")
        require(len(ref[0]) == len(got[0]) == 1 and ref[1] == got[1] and ref[2] == got[2],
                f"per-frame state {got} vs oracle {ref}")
        require(all(abs(a - b) <= 1.5 for a, b in zip(ref[0][0], got[0][0])), f"{got} vs oracle {ref}")
        batches = _batches(frames, BATCH)
        label = f"{w}x{h} B={BATCH}"

        secs = {}  # the phase's own seconds, by step
        t0 = time.perf_counter()
        K.reset_launches()
        bp = BatchPipeline(w, h, batch=BATCH, ocr_engine=SmhOcrEngine(), device=dev)
        try:
            h2d = []
            results = []
            for batch in batches:
                before = bp.stats["h2d_bytes"]
                results.append(bp.process(batch))
                h2d.append(bp.stats["h2d_bytes"] - before)
            torch.cuda.synchronize()
            run = dict(K.LAUNCHES)
            stats = dict(bp.stats)
            secs["checked"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            prof = device_profile(lambda: bp.process(batches[1]), n=1, names=K.FUSED_PASS + K.DELTA_PASS, tries=6)
            secs["profile"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            for batch in batches:
                bp.process(batch)
            secs["process"] = time.perf_counter() - t0
            fps_process = len(batches) * BATCH / secs["process"]
            # stream() on the warm pipeline: its first batch rides the chain
            # from the last process() batch; the results are the same.
            t0 = time.perf_counter()
            streamed = list(bp.stream(iter(batches), depth=2))
            secs["stream"] = time.perf_counter() - t0
            fps_stream = len(batches) * BATCH / secs["stream"]
        finally:
            bp.close()
        for name, n in run.items():
            launches[name] += n
        require(all(run[n] == len(batches) for n in K.FUSED_PASS), f"{label}: not one launch per batch: {run}")
        require(run["delta_apply"] == len(batches) - 1, f"{label}: not one delta_apply per delta batch: {run}")
        require(prof["named"] == {n: 1.0 for n in K.FUSED_PASS + K.DELTA_PASS},
                f"{label}: kernels 1-3 and 5-9 per delta batch (profiler) {prof}")
        require(prof["kernels"] <= MAX_KERNELS_PER_PASS, f"{label}: {prof['kernels']} kernels per delta batch")
        require(stats["full_batches"] == 1 and stats["delta_batches"] == len(batches) - 1,
                f"{label}: not a full batch, then deltas: {stats}")
        for bi, (batch, res) in enumerate(zip(batches, results)):
            for fi, (f, r) in enumerate(zip(batch, res)):
                i = next(k for k, fr in enumerate(frames) if fr is f)
                require(not r.sleeping and summarize(r) == want[i],
                        f"{label} batch {bi} frame {fi}: {summarize(r)} != per-frame {want[i]}")
        require([[summarize(r) for r in b] for b in streamed] == [[summarize(r) for r in b] for b in results],
                f"{label}: stream() != process()")
        print(f"batch: {label} over {len(batches)} batches of the drag: results == the per-frame VisionState "
              f"(== the oracle within 1.5 px on frame 0), stream(depth=2) == process(); "
              f"{prof['kernels']:.0f} kernel launches + {prof['launches'] - prof['kernels']:.0f} memset/copy rows "
              f"per delta batch (profiler; each kernel of the pass and the delta apply {prof['named']}), device "
              f"{prof['kernel_us'] / 1e3:.3f} ms per batch; H2D bytes per batch {h2d} (full, then deltas); "
              f"process() {fps_process:.2f} frames/s, stream() {fps_stream:.2f} frames/s; stats t_* "
              f"{{{', '.join(f'{k} {v:.1f}' for k, v in stats.items() if k.startswith('t_'))}}} on {card}; "
              f"seconds {', '.join(f'{k} {v:.1f}' for k, v in secs.items())}", flush=True)
    return launches


MESH_BATCHES = (1, 3, 8)  # masks per call of kernel 4 over a batch of masks


def _count(launches: dict, fn):
    """fn()'s result, its kernel launches added into `launches` (counts set
    to 0 just before and read just after)."""
    from smh_tpu_torch.ops import kernels as K

    torch.cuda.synchronize()
    K.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    for name, n in K.LAUNCHES.items():
        launches[name] = launches.get(name, 0) + n
    return out


def mesh_masks(rng, w: int, h: int, b: int) -> tuple:
    """b different line masks at a map shape (the ray march's lines moved 3
    px right per mask) and one seed on each: on a line for even b, on the
    background for odd. -> (u8 [b, mh, mw] on the host, f32 [b, 2])."""
    from smh_tpu_torch import consts as C

    gm = C.map_geometry(w, h)
    masks, pts = [], []
    for i in range(b):
        lines = [((min(x0 + 3 * i, gm.map_w - 1), y0), (min(x1 + 3 * i, gm.map_w - 1), y1))
                 for (x0, y0), (x1, y1) in ray_march_lines(w, h)]
        masks.append(line_mask(gm.map_h, gm.map_w, lines))
        pts.append(ray_march_seeds(rng, masks[-1], 2, edge=False)[i % 2])
    return np.stack(masks), np.stack(pts).astype(np.float32)


def _mesh_kernel(dev: torch.device, single_b8: dict) -> dict:
    """Kernel 4 over a batch of masks: bit-equal to the plain version and
    to the single-mask kernel mask by mask, one launch per call; device us
    per call beside 8 seeds on one mask."""
    from smh_tpu_torch import consts as C
    from smh_tpu_torch.ops import lsd as L

    rng = np.random.default_rng(4)
    mg = int(C.LSD_MAX_GAP)
    cos_t, sin_t = L.theta_tables(dev)
    table = {}
    for w, h in LIVE_SIZES:
        gm = C.map_geometry(w, h)
        k_total = L._max_k(gm.map_h, gm.map_w)  # march_batch's fixed depth
        shape = f"{gm.map_h}x{gm.map_w}"
        for b in MESH_BATCHES:
            masks, pts = mesh_masks(rng, w, h, b)
            masks_t, pts_t = torch.from_numpy(masks).to(dev), torch.from_numpy(pts).to(dev)
            got = L.ray_march(masks_t, pts_t, mg, k_total, cos_t, sin_t)
            ex, ey = L.march_plain(masks_t, pts_t, mg, k_total, cos_t, sin_t)
            plain = (ex, ey, *L.finalize_plain(pts_t, ex, ey))
            for i in range(b):
                one = L.ray_march(masks_t[i], pts_t[i : i + 1], mg, k_total, cos_t, sin_t)
                for name, g_, p_, o_ in zip(("end_x", "end_y", "best_x", "best_y", "best_len"), got, plain, one):
                    require(torch.equal(g_[i], p_[i]), f"ray_march over masks {name} != plain at {shape} B={b}, mask {i}")
                    require(torch.equal(g_[i], o_[0]), f"ray_march over masks {name} != the single-mask kernel at "
                            f"{shape} B={b}, mask {i}")
            prof = device_profile(lambda: L.ray_march(masks_t, pts_t, mg, k_total, cos_t, sin_t), names=("ray_march",))
            require(prof["launches"] == 1.0 and prof["named"]["ray_march"] == 1.0,
                    f"ray_march over {b} masks: {prof['launches']} launches per call, not 1")
            table.setdefault(shape, {})[b] = {"us": prof["us"], "us_per_mask": prof["us"] / b,
                                              "longest_ray_px": float(got[4].max().sqrt())}
        # Like for like at B = 8: the same 8 seeds on mask 0, by the
        # single-mask kernel and by the batch of masks over 8 copies of it.
        copies = masks_t[:1].expand(8, -1, -1).contiguous()
        one = L.ray_march(masks_t[0], pts_t, mg, k_total, cos_t, sin_t)
        for name, g_, o_ in zip(("end_x", "end_y", "best_x", "best_y", "best_len"),
                                L.ray_march(copies, pts_t, mg, k_total, cos_t, sin_t), one):
            require(torch.equal(g_, o_), f"ray_march over 8 copies of a mask {name} != the single-mask kernel at {shape}")
        us_one = device_profile(lambda: L.ray_march(masks_t[0], pts_t, mg, k_total, cos_t, sin_t))["us"]
        us_copies = device_profile(lambda: L.ray_march(copies, pts_t, mg, k_total, cos_t, sin_t))["us"]
        table[shape]["b8_one_mask"] = {"single_mask_us": us_one, "batch_of_copies_us": us_copies,
                                       "longest_ray_px": float(one[4].max().sqrt())}
        print(f"mesh: ray_march over a batch of masks at {shape} k_total={k_total}: bit-equal to march_plain and to "
              f"the single-mask kernel mask by mask, 1 launch per call; device us per call "
              + ", ".join(f"B={b} {table[shape][b]['us']:.2f} ({table[shape][b]['us_per_mask']:.2f} per mask, longest "
                          f"ray {table[shape][b]['longest_ray_px']:.1f} px)" for b in MESH_BATCHES)
              + f"; the B=8 seeds on mask 0 (longest ray {float(one[4].max().sqrt()):.1f} px): single-mask kernel "
              f"{us_one:.2f}, batch of 8 copies {us_copies:.2f}; the kernel phase's single-mask B=8 (its seeds, k_total "
              f"from max_len) {single_b8[h]:.2f}", flush=True)
    return table


def phase_mesh(dev: torch.device, card: str, single_b8: dict) -> dict:
    """The multi-device path on a mesh of `dev` repeated (and, with two or
    more cards, of distinct cards): kernel 4 over a batch of masks;
    analyze_batch at 1080p on (dp, sp) = (2, 2) and (1, 3), so kernels 1 and
    3 run on row blocks with halos, against the unsharded analyze_frame on
    the CPU (the kernels' plain versions); full_step's winners against the
    per-frame march; the dry run's full_step check on random frames;
    BatchPipeline(batch=8) on dp = 4 against one device over the drag,
    kernels 1-3 and 5-7 at dp launches per batch. Returns the kernel launches of
    the driven calls."""
    from smh_tpu_torch.ocr.smhocr import SmhOcrEngine
    from smh_tpu_torch.ops import kernels as K
    from smh_tpu_torch.ops import pipeline as opp
    from smh_tpu_torch.parallel import dryrun, spmd
    from smh_tpu_torch.vision.batch import BatchPipeline

    secs = {}
    t0 = time.perf_counter()
    table = _mesh_kernel(dev, single_b8)
    secs["kernel"] = time.perf_counter() - t0
    launches: dict = {}
    meshes = [("one card", [dev] * 4)]
    if torch.cuda.device_count() >= 2:
        meshes.append(("distinct cards", [torch.device(f"cuda:{i % torch.cuda.device_count()}") for i in range(4)]))
    frames, pts = dryrun.seam_frames(4)
    t0 = time.perf_counter()
    plain = [opp.analyze_frame(f, device="cpu") for f in frames]
    secs["plain"] = time.perf_counter() - t0
    for label, devices in meshes:
        t0 = time.perf_counter()
        for dp, sp in ((2, 2), (1, 3)):
            mesh = spmd.make_mesh(devices[: dp * sp], sp=sp)
            got = spmd.gather(_count(launches, lambda: spmd.analyze_batch(frames, mesh)), "cpu")
            for i, want in enumerate(plain):
                for k, v in want.items():
                    require(torch.equal(got[k][i], v),
                            f"analyze_batch ({dp}, {sp}) {k} != the plain analyze_frame on the CPU, frame {i}")
            require(len(got) == 10, f"analyze_batch keys {sorted(got)}")
        mesh = spmd.make_mesh(devices, sp=2)
        out = spmd.gather(_count(launches, lambda: spmd.full_step(frames, pts, mesh)), "cpu")
        for i, want in enumerate(plain):
            end, length = dryrun.single_march(want["lsd_mask"].to(devices[0]), pts[i])
            require(torch.equal(out["best_end"][i], end) and torch.equal(out["best_length_sqr"][i], length),
                    f"full_step winner {out['best_end'][i]} != the per-frame march's {end}, frame {i}")
        step = _count(launches, lambda: dryrun.check_step(devices))
        secs[f"analyze ({label})"] = time.perf_counter() - t0
        print(f"mesh: on {label} {[str(d) for d in devices]}: analyze_batch at 1080p on (dp, sp) = (2, 2) and (1, 3) "
              f"(a marker line across every seam, scale text across sp = 3's second) == the plain analyze_frame on "
              f"the CPU for every output and frame; full_step's winners == the per-frame march (longest "
              f"{float(out['best_length_sqr'].max().sqrt()):.1f} px); dry run: {step}", flush=True)

    # BatchPipeline over the drag: one device, then dp = 4.
    w, h = LIVE_SIZES[0]
    batches = _batches(list(drag_frames(w, h)), BATCH)
    rates, results = {}, {}
    t0 = time.perf_counter()
    for label, kw in (("one device", {"device": dev}), ("dp=4", {"mesh": spmd.make_mesh([dev] * 4)})):
        bp = BatchPipeline(w, h, batch=BATCH, ocr_engine=SmhOcrEngine(), **kw)
        try:
            run = _count(launches, lambda: [bp.process(b) for b in batches])
            results[label] = [[summarize(r) for r in b] for b in run]
            stats = dict(bp.stats)
            if "mesh" in kw:
                require(stats["full_batches"] == len(batches) and stats["delta_batches"] == 0,
                        f"{label}: not a full upload per batch: {stats}")
                prof = device_profile(lambda: bp.process(batches[1]), n=1, names=K.FUSED_PASS, tries=6)
                require(prof["named"] == {n: 4.0 for n in K.FUSED_PASS},
                        f"{label}: kernels 1-3 and 5-7 per batch (profiler) {prof['named']}, not 4 each")
            t1 = time.perf_counter()
            for b in batches:
                bp.process(b)
            rates[label] = len(batches) * BATCH / (time.perf_counter() - t1)
        finally:
            bp.close()
        require(results[label] == results["one device"], f"BatchPipeline {label} != one device")
    secs["batch pipeline"] = time.perf_counter() - t0
    print(f"mesh: BatchPipeline(batch={BATCH}) at {w}x{h} over {len(batches)} batches of the drag on {dev}: results of "
          f"dp=4 == one device; kernels 1-3 and 5-7 per batch (profiler) {prof['named']}; process() frames/s "
          + ", ".join(f"{k} {v:.2f}" for k, v in rates.items())
          + f" (one card: the cost of the split, not scaling) on {card}; seconds "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()), flush=True)
    print("mesh: " + json.dumps({"ray_march_masks_us": table, "batch_fps": rates, "card": card}), flush=True)
    return launches


CUDA_ENGINE_SIZES = ((1024, 768), (3440, 1440))  # lsd_engine="cuda" held to the oracle there too


def ends_close(got, want) -> bool:
    """Equal counts of marker lines (x0, y0, x1, y1) whose ends each lie
    within 1.5 px of the other's (tests/test_video_goldens.py's rule)."""
    return len(got) == len(want) and all(
        math.hypot(g[0] - e[0], g[1] - e[1]) <= 1.5 and math.hypot(g[2] - e[2], g[3] - e[3]) <= 1.5
        for g, e in zip(got, want)
    )


def phase_resolutions(dev: torch.device, card: str) -> dict:
    """One VisionState on the card resizing mid-stream through
    testing.RESOLUTIONS.
    At each size: markers, ratio and minimap == the oracle's (ends within
    1.5 px), hostpack and scalespack bytes == a CPU state's, every kernel of
    the pass launched by it; lsd_engine="cuda" == the oracle at
    CUDA_ENGINE_SIZES; at each map shape kernels 1-3, 6 and 7 bit-equal to
    their plain versions per frame (the frame's map ROI, its quadrant and
    its mask bits) and at B=3 (random rows), their device us per frame
    beside their bound."""
    from smh_tpu_torch import consts as C
    from smh_tpu_torch import testing
    from smh_tpu_torch.ops import kernels as K
    from smh_tpu_torch.ops import pipeline as opp
    from smh_tpu_torch.squadex.capture import Frame

    rng = np.random.default_rng(9)
    launches = {name: 0 for name in K.LAUNCHES}
    table = {}
    card_state, cpu_state, oracle = new_state(dev), new_state("cpu"), new_state("cpu", hardware=False)
    try:
        for w, h in testing.RESOLUTIONS:
            frame = testing.resolution_frame(w, h)
            gm = C.map_geometry(w, h)
            shape = f"{gm.map_h}x{gm.map_w}"
            label = f"{w}x{h} (map {shape})"
            res = _count(launches, lambda: card_state.process(Frame(frame, 96)))
            require(all(K.LAUNCHES[n] > 0 for n in K.FUSED_PASS), f"{label}: the pass skipped a kernel: {K.LAUNCHES}")
            be = card_state.delegate.backend
            pack_gpu = be._results["hostpack"].cpu().numpy()
            spack_gpu = be._results["scalespack"].cpu().numpy()
            layout = opp.hostpack_layout(
                gm.map_h, gm.map_w, with_ocr=True, with_quiet=True,
                scales_inline=be._dispatch_flags[3], sparse_budget=be._dispatch_flags[4],
            )
            ref = oracle.process(Frame(frame, 96))
            cpu_state.process(Frame(frame, 96))
            pack_cpu = cpu_state.delegate.backend._results["hostpack"].numpy()
            spack_cpu = cpu_state.delegate.backend._results["scalespack"].numpy()
            require(res is not None and ref is not None, f"{label}: map gate closed")
            got, want = summarize(res), summarize(ref)
            require(len(got[0]) == 1 and ends_close(got[0], want[0]), f"{label}: markers {got[0]} vs oracle {want[0]}")
            require(got[1] is not None and got[1] == want[1], f"{label}: ratio {got[1]} vs oracle {want[1]}")
            require(got[2] == want[2], f"{label}: minimap {got[2]} vs oracle {want[2]}")
            require(hostpacks_match(pack_gpu, pack_cpu, layout), f"{label}: hostpack bytes differ from the CPU path")
            require(np.array_equal(spack_gpu, spack_cpu), f"{label}: scalespack bytes differ from the CPU path")
            engine = ""
            if (w, h) in CUDA_ENGINE_SIZES:
                card_state.settings.set("lsd_engine", "cuda", save=False)
                try:
                    res_c = _count(launches, lambda: card_state.process(Frame(frame, 96)))
                finally:
                    card_state.settings.set("lsd_engine", "native", save=False)
                require(K.LAUNCHES["ray_march"] > 0, f"{label}: the cuda engine did not march: {K.LAUNCHES}")
                got_c = summarize(res_c)
                require(len(got_c[0]) == 1 and ends_close(got_c[0], want[0]),
                        f"{label}: lsd_engine=cuda markers {got_c[0]} vs oracle {want[0]}")
                engine = f"; lsd_engine=cuda markers {got_c[0]} == oracle within 1.5 px"

            # Kernels 1-3 at this map shape: per frame on the frame's map ROI
            # (B, G, R planes as the pass lays them out), then a batch of 3.
            roi = frame[gm.map_y : gm.map_y + gm.map_h, gm.map_x : gm.map_x + gm.map_w, :3]
            planes = torch.from_numpy(np.ascontiguousarray(np.moveaxis(roi, -1, 0))[None]).to(dev)
            calls = batch_calls(planes)
            for name, c in calls.items():
                check_batched(name, c, 1, f"{shape} the frame's map ROI")
            n_px = gm.map_h * gm.map_w
            host, padded = batch_rows(rng, 3, w, h)
            rows = torch.from_numpy(host).to(dev)
            for name, c in batch_calls(rows[:, : 3 * n_px].view(3, 3, gm.map_h, gm.map_w)).items():
                check_batched(name, c, 3, f"{shape} B=3 frame stride {padded}")
            prof = device_profile(lambda: [c[2](0) for c in calls.values()], names=EVERY_PASS)
            share = mask_share(np.ascontiguousarray(roi[..., ::-1]))
            ops = {name: (base + hsv_ops * share) * n_px for name, (base, hsv_ops) in CLASSIFY_OPS.items()}
            ops["quiet_walk"] = OPS_PER_PX["quiet_walk"] * n_px
            ops["brq_preprocess"] = OPS_PER_PX["brq_preprocess"] * (gm.map_h // 2) * (gm.map_w // 2)
            ops["mask_words"] = OPS_PER_PX["mask_words"] * gm.map_h * (((gm.map_w + 7) // 8 + 3) // 4)
            bounds = {name: bound(kernel_bytes(name, gm.map_h, gm.map_w), ops[name]) for name in EVERY_PASS}
            table[shape] = {name: {"us": prof["named_us"][name], "bound_us": b["bound_ms"] * 1e3, "bound_by": b["bound_by"]}
                            for name, b in bounds.items()}
            print(f"resolutions: {label}: markers {got[0]}, ratio {got[1]:.6f}, minimap {got[2]} == oracle; hostpack "
                  f"{pack_gpu.size} B == CPU path{engine}; kernels 1-3, 6 and 7 bit-equal to their plain "
                  f"versions per frame and at B=3; device us per frame on the frame's map ROI ({100 * share:.2f} % of pixels past the "
                  f"max-byte mask; kernel rows; bound) "
                  + ", ".join(f"{n} {t['us']:.2f} ({t['bound_us']:.2f}, {t['bound_by']})" for n, t in table[shape].items())
                  + f" on {card}", flush=True)
    finally:
        for state in (card_state, cpu_state, oracle):
            state.close()
    print("resolutions: " + json.dumps(table), flush=True)
    return launches


VIDEO_GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens", "video_1080p.json")
VIDEO_LAPS = 5  # analyze_video reads the 24 golden frames this many times over, for a rate past the set-up


def phase_tools(dev: torch.device, card: str) -> dict:
    """The port's operator entry points (smh_tpu_torch/tools/) on the card:
    analyze_video's frame function over the video goldens' 24 frames, 5
    times over, at B=8 (each row == tests/goldens/video_1080p.json:
    sleeping, line counts, ends within 1.5 px; frames/s after the first
    batch) and over an 8-frame drag at 1600x900 (an H * W = 2
    mod 4 batch; rows == the per-frame state's); compare_backends on the
    verify frame as a PNG (RESULT: PASS, exit 0); render_detections
    --backend cuda writes the PNG bytes --backend numpy does."""
    import contextlib
    import io
    import tempfile
    import types

    from PIL import Image

    from smh_tpu_torch import testing
    from smh_tpu_torch.ocr.smhocr import SmhOcrEngine
    from smh_tpu_torch.ops import kernels as K
    from smh_tpu_torch.squadex.capture import Frame
    from smh_tpu_torch.tools import analyze_video, compare_backends, render_detections

    launches = {name: 0 for name in K.LAUNCHES}
    with open(VIDEO_GOLDENS) as f:
        golden = json.load(f)
    frames = testing.make_video_frames(golden["w"], golden["h"], golden["n"]) * VIDEO_LAPS
    rows, stamps = [], []

    def emit(r):
        rows.append(r)
        stamps.append(time.perf_counter())

    t0 = time.perf_counter()
    n = _count(launches, lambda: analyze_video.analyze(frames, 8, SmhOcrEngine(), dev, emit=emit))
    secs = time.perf_counter() - t0
    batches = -(-len(frames) // 8)
    require(n == len(rows) == len(frames), f"analyze_video: {n} frames, {len(rows)} rows")
    require(all(K.LAUNCHES[k] == batches for k in K.FUSED_PASS), f"analyze_video: kernels 1-3 and 5-7 per batch {K.LAUNCHES}")
    for r in rows:
        g = golden["frames"][r["frame"] % golden["n"]]
        require(r["sleeping"] == g["sleeping"], f"analyze_video frame {r['frame']}: sleeping {r['sleeping']}")
        got = [(*p0, *p1) for p0, p1 in r["markers"]]
        require(ends_close(got, g["lines"]), f"analyze_video frame {r['frame']}: lines {got} vs golden {g['lines']}")
    # The rate from the first batch's rows to the last's: the pipeline's
    # construction and the first batch's full upload lie before it.
    steady = (n - 8) / (stamps[-1] - stamps[7])
    print(f"tools: analyze_video over the {golden['w']}x{golden['h']} video goldens' {golden['n']} frames "
          f"{VIDEO_LAPS} times ({n} frames, {batches} batches at B=8): every row == tests/goldens/video_1080p.json "
          f"(ends within 1.5 px); {secs:.3f} s wall for the call (construction included), {steady:.2f} frames/s "
          f"over the {n - 8} frames after the first batch on {card}", flush=True)

    w, h = 1600, 900
    drag = [testing.resolution_frame(w, h, i) for i in range(8)]
    rows = []
    _count(launches, lambda: analyze_video.analyze(drag, 8, SmhOcrEngine(), dev, emit=rows.append))
    require(all(K.LAUNCHES[k] == 1 for k in K.FUSED_PASS), f"analyze_video {w}x{h}: kernels 1-3 and 5-7 {K.LAUNCHES}")
    state = new_state(dev)
    try:
        want = []
        for i, img in enumerate(drag):
            r = state.process(Frame(img, 96))
            want.append(analyze_video.row(i, types.SimpleNamespace(
                sleeping=r is None, markers=r.markers if r else [], meters_to_px_ratio=r.meters_to_px_ratio if r else None,
                minimap_bounds=r.minimap_bounds if r else None)))
    finally:
        state.close()
    require(rows == want, f"analyze_video {w}x{h}: rows {rows} != the per-frame state's {want}")
    print(f"tools: analyze_video over an 8-frame drag at {w}x{h} (H * W = 2 mod 4) at B=8: rows == the per-frame "
          f"state's; markers {rows[0]['markers']} .. {rows[-1]['markers']}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "verify.png")
        Image.fromarray(frame_for(1920, 1080)[..., [2, 1, 0, 3]]).save(png)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = _count(launches, lambda: compare_backends.main([png, "--device", str(dev)]))
        report = out.getvalue()
        require(rc == 0 and report.splitlines()[-1] == "RESULT: PASS", f"compare_backends exit {rc}:\n{report}")
        renders = {}
        for backend in ("cuda", "numpy"):
            dst = os.path.join(tmp, f"{backend}.png")
            with contextlib.redirect_stdout(io.StringIO()):
                rc = _count(launches, lambda: render_detections.main(
                    [png, dst, "--backend", backend, "--device", str(dev)]))
            require(rc == 0, f"render_detections --backend {backend} exit {rc}")
            with open(dst, "rb") as f:
                renders[backend] = f.read()
        require(renders["cuda"] == renders["numpy"], "render_detections: the cuda PNG differs from the numpy PNG")
    print("tools: compare_backends on the verify frame's PNG: RESULT: PASS, exit 0 ("
          + "; ".join(l.strip() for l in report.splitlines()[:-1]) + f"); render_detections --backend cuda wrote "
          f"the {len(renders['cuda'])} PNG bytes --backend numpy wrote", flush=True)
    return launches


WARMUP_CHILD = r"""
import json, sys, time
import torch
import chip_smoke as cs
from smh_tpu_torch import _build
from smh_tpu_torch.ops import kernels as K
from smh_tpu_torch.squadex.capture import Frame

warm = sys.argv[1] == "1"
dev = sys.argv[2]
sync = torch.cuda.synchronize if dev.startswith("cuda") else (lambda: None)
builds = []
real_build = _build.build
_build.build = lambda: (builds.append(1), real_build())[1]
t0 = time.perf_counter()
if warm:
    from smh_tpu_torch.ops.warmup import warmup
    warmup(((1920, 1080),), device=dev)
warm_s = time.perf_counter() - t0
state = cs.new_state(dev)
frame = cs.frame_for(1920, 1080)
n_builds, n_tables = len(builds), len(K._tables)
t0 = time.perf_counter()
res = state.process(Frame(frame, 96))
sync()
first_ms = (time.perf_counter() - t0) * 1e3
t0 = time.perf_counter()
state.process(Frame(frame, 96))
sync()
second_ms = (time.perf_counter() - t0) * 1e3
state.close()
print("WARMUP " + json.dumps({"warmup": warm, "warmup_s": warm_s, "first_ms": first_ms, "second_ms": second_ms,
      "builds_in_first": len(builds) - n_builds, "tables_in_first": len(K._tables) - n_tables,
      "markers": len(res.markers)}))
"""


def phase_warmup(dev: torch.device) -> None:
    """The first process() of a fresh process with and without warmup():
    the two children run at once, sharing the host and the card."""
    root = os.path.dirname(os.path.abspath(__file__))
    procs = {warm: subprocess.Popen([sys.executable, "-c", WARMUP_CHILD, warm, str(dev)], cwd=root,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for warm in ("0", "1")}
    rows = {}
    try:
        for warm, proc in procs.items():
            out, err = proc.communicate(timeout=300)
            require(proc.returncode == 0, f"warmup child ({warm}) failed:\n{err[-3000:]}")
            row = json.loads(next(l for l in out.splitlines() if l.startswith("WARMUP "))[7:])
            require(row["markers"] == 1, f"warmup child ({warm}): {row}")
            rows[warm] = row
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    warmed, cold = rows["1"], rows["0"]
    require(warmed["builds_in_first"] == 0 and warmed["tables_in_first"] == 0,
            f"the first frame after warmup built or launched tables: {warmed}")
    require(cold["tables_in_first"] == 1, f"the cold first frame did not build the tables: {cold}")
    print(f"warmup: first process() at 1080p {cold['first_ms']:.1f} ms cold (second {cold['second_ms']:.1f} ms) vs "
          f"{warmed['first_ms']:.1f} ms after warmup() of {warmed['warmup_s']:.1f} s (second "
          f"{warmed['second_ms']:.1f} ms; the two children ran at once); after warmup the first frame built "
          f"nothing and launched no table kernel", flush=True)


def _worker_result(dev, img) -> tuple:
    """What a fresh worker answers for a frame, computed in this process: a
    new VisionState of the worker's settings (async scales) that submits
    and then consumes it."""
    from smh_tpu_torch.ocr.smhocr import SmhOcrEngine
    from smh_tpu_torch.settings import Settings
    from smh_tpu_torch.squadex.capture import Frame
    from smh_tpu_torch.vision.pipeline import VisionState

    s = Settings(path=None)
    s.set("hardware_acceleration", True, save=False)
    state = VisionState(settings=s, ocr_engine=SmhOcrEngine(), scales_async=True, device=dev)
    try:
        f = Frame(img, 96)
        return summarize(state.process(f, submitted=state.submit(f)))
    finally:
        state.close()


def phase_worker(dev: torch.device) -> None:
    """The CLI's App with --worker on the card, one supervised worker child
    at a time: ready, the child's imports, a recycle at a 1-byte upload
    budget after its first frame and the restarted child serving the frame
    again, each result == the in-process state's."""
    from smh_tpu_torch import app as tapp
    from smh_tpu_torch.settings import Settings

    args = tapp.build_parser().parse_args(["--synthetic", "--worker", "--no-web", "--device", str(dev)])
    settings = Settings(path=None)
    settings.set("hardware_acceleration", True, save=False)
    source = tapp._build_source(args)
    app = tapp.App(source, settings=settings, device=args.device, serve=not args.no_web, worker=args.worker)
    updates = []
    deliver = app._on_update
    app._on_update = lambda r, d: (updates.append(r), deliver(r, d))

    def wait_for(cond, what: str, timeout: float = 120) -> None:
        deadline = time.time() + timeout
        while not cond() and time.time() < deadline:
            time.sleep(0.05)
        wc = app._worker_client
        require(cond(), f"{what} within {timeout:.0f} s ({wc.diagnose() if wc is not None else 'no worker'})")

    def served() -> list:
        return [r for r in updates if r is not None and len(r.markers) == 1]

    t0 = time.perf_counter()
    try:
        # Only the first child gets the 1-byte budget and the import trace:
        # the restarted one serves on without recycling.
        with environ(SMH_WORKER_RECYCLE_MB="0.000001", PYTHONPROFILEIMPORTTIME="1"):
            app.start()
            wait_for(lambda: app._worker_client is not None and app._worker_client._proc is not None,
                     "no worker child started")
        wc = app._worker_client
        wait_for(lambda: len(served()) >= 1, "no update with one marker")
        ready_s, ready = time.perf_counter() - t0, wc.ready_info
        wait_for(lambda: wc.restarts == 1 and wc.last_exit_code == 42, "no recycle (exit 42) and restart")
        recycled_s = time.perf_counter() - t0
        app._wake()  # the static scene again, for the restarted child
        wait_for(lambda: len(served()) >= 2, "the restarted worker served no update")
        again_s = time.perf_counter() - t0
        err = open(wc._stderr_path).read()
    finally:
        app.stop()
    stopped_s = time.perf_counter() - t0
    require(not app._worker_thread.is_alive(), "the --worker app did not stop")
    want = _worker_result(dev, source.grab().image)
    got = [summarize(r) for r in served()[:2]]
    require(got == [want, want], f"worker results {got} != in process {want}")
    imported = [line.split("|")[-1].strip() for line in err.splitlines() if line.startswith("import time:")]
    leaked = sorted(m for m in imported if m.split(".")[0] in ("jax", "jaxlib", "smh_tpu"))
    require("smh_tpu_torch.vision.cuda_backend" in imported and not leaked, f"worker child imported {leaked}")
    print(f"worker: the CLI's App with --worker on {dev}: first update in {ready_s:.1f} s (ready {ready}); the "
          f"child imported {len(imported)} modules, none of jax or smh_tpu; a 1-byte upload budget recycled it "
          f"(exit 42) after its first frame and the restarted worker served the frame again; markers "
          f"{got[0][0]}, ratio {got[0][1]}, minimap {got[0][2]} == the in-process state's, twice; stopped cleanly "
          f"(at {recycled_s:.1f} s the recycle, {again_s:.1f} s the second update, {stopped_s:.1f} s stopped)",
          flush=True)


def timed_phase(name: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"{name}: phase took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


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

    from smh_tpu_torch import native

    t0 = time.perf_counter()
    _build.load()
    print(f"build: {_build.lib_path()} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'})", flush=True)
    t0 = time.perf_counter()
    require(native.available(), f"the native host module did not build: {native.build_error}")
    print(f"build: {native.lib_path()} in {time.perf_counter() - t0:.1f} s", flush=True)

    kernels = phase_kernels(dev)
    kernels["ray_march"] = phase_ray_march(dev)
    kernels["scales_read"] = timed_phase("scales_read", phase_scales_read, dev)
    kernels["brq_preprocess"] = timed_phase("brq_preprocess", phase_brq_preprocess, dev)
    kernels["mask_words"] = timed_phase("mask_words", phase_mask_words, dev)
    kernels["delta_apply"] = timed_phase("delta_apply", phase_delta_apply, dev)
    kernels["hostpack"] = timed_phase("hostpack", phase_hostpack, dev)
    kernels["window_crop"] = timed_phase("window_crop", phase_window_crop, dev)
    kernels["ocr_band"] = timed_phase("ocr_band", phase_ocr_band, dev)
    timed_phase("repeated", phase_repeated, dev)
    # Before the traces of thousands of launches (phase_timing, phase_batch):
    # late in a run, short traces lost most of their records four times
    # running (device_profile).
    timed_phase("batch kernels", phase_batch_kernels, dev)
    main_paths = [timed_phase("resolutions", phase_resolutions, dev, card)]
    main_paths += [phase_slice(dev), phase_dense(dev), phase_transports(dev), phase_debug(dev),
                   phase_device_engine(dev)]
    phase_timing(dev, card)
    timed_phase("routes", phase_routes, dev, card)
    phase_loop(dev)
    main_paths += [phase_live(dev, card), phase_live_window(dev, card), phase_app(dev)]
    main_paths.append(timed_phase("batch", phase_batch, dev, card))
    single_b8 = {h: us for h, us in kernels["ray_march"].pop("device_us_by_height").items()}
    main_paths.append(timed_phase("mesh", phase_mesh, dev, card, single_b8))
    main_paths.append(timed_phase("tools", phase_tools, dev, card))
    timed_phase("warmup", phase_warmup, dev)
    timed_phase("worker", phase_worker, dev)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "smh_tpu"))
    require(not leaked, f"the port imported {leaked}")

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
