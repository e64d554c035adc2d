"""Device longest-line search: the ray march of the `lsd_engine="cuda"` path.

Port of smh_tpu/ops/lsd.py (all of it but `_march`, the multi-chip path).
For every seed, 3600 rays (one per 0.1 degree) march over the u8 LSD mask
until they leave the plane or cross a gap of more than max_gap non-white
samples; each seed keeps the last angle with the largest squared length.

* `march_plain` / `finalize_plain` are the plain PyTorch version: the span
  formulation of smh_tpu's `_march_span` / `_finalize` (positions along a
  ray on a dense step axis, the gap run as a windowed all-black test, first
  indices and closed-form endpoints), processed in step chunks sized to
  bound memory; the chunking does not change a result.
* `ray_march` is the wrapper: the plain version for a mask on the CPU, the
  hand-written kernel csrc/ray_march.cu for a mask on a CUDA device (one
  thread per (seed, angle) lane running the sequential state machine, then
  a block reduction per seed). Both sample pos(k) = start + k * d with two
  roundings (no FMA), so their ends and lengths are bit-equal.

Both read one theta table, built once on the host in f32 (`theta_tables`),
so the two never see different `cos`/`sin` roundings.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from smh_tpu import consts as C
from smh_tpu.geometry import Line, Point

from .. import _build
from . import kernels
from . import scales_device as sd

F32 = torch.float32
I32 = torch.int32
I64 = torch.int64

N_ANGLES = C.LSD_NUM_ANGLES
SPAN0 = 256  # the JAX march's first span
SPAN = 512  # its follow-up spans
# Elements of one [B, N, chunk] step block of the plain version.
_PLAIN_BLOCK = 1 << 22

_tables: dict = {}


def theta_tables_np() -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) f32 [N_ANGLES] of theta = (i / 10) * (pi / 180), with the
    angle in f32 as smh_tpu's `_theta_tables` forms it, and cos/sin taken in
    f64 and rounded once to f32."""
    theta = (np.arange(N_ANGLES, dtype=np.float32) / np.float32(10.0)) * (
        np.float32(math.pi) / np.float32(180.0)
    )
    t64 = theta.astype(np.float64)
    return np.cos(t64).astype(np.float32), np.sin(t64).astype(np.float32)


def theta_tables(device) -> tuple[torch.Tensor, torch.Tensor]:
    """The theta table on `device`, built once per device."""
    device = torch.device(device)
    if device not in _tables:
        cos_np, sin_np = theta_tables_np()
        _tables[device] = (torch.from_numpy(cos_np).to(device), torch.from_numpy(sin_np).to(device))
    return _tables[device]


def _bucket(b: int) -> int:
    return 1 << max(0, (b - 1).bit_length())


def _max_k(h: int, w: int) -> int:
    diag = int(math.ceil(math.hypot(h, w))) + 2
    return ((diag + SPAN - 1) // SPAN) * SPAN


def step_bound(h: int, w: int, max_gap: int, max_len: float | None = None) -> int:
    """Steps the JAX march takes: SPAN0, then whole SPANs until it passes
    max_len + max_gap + 2 (every ray provably dies by then) or, without
    max_len, _max_k. A lane alive at the bound keeps end = start."""
    max_k = _max_k(h, w)
    needed = max_k if max_len is None else min(max_k, int(max_len) + int(max_gap) + 2)
    k = SPAN0
    while k < needed:
        k += SPAN
    return k


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


def march_plain(mask, pts, max_gap: int, k_total: int, cos_t, sin_t):
    """Plain twin of the lane kernel: u8 mask [h, w], f32 seeds [B, 2] ->
    (end_x, end_y) f32 [B, N]. Seeds lie inside the plane."""
    h, w = mask.shape
    bsz = pts.shape[0]
    n = cos_t.numel()
    dev = mask.device
    window = max_gap + 1
    flat = mask.reshape(-1)
    x0 = pts[:, 0:1]  # [B, 1]
    y0 = pts[:, 1:2]
    dx = cos_t[None, :]  # [1, N]
    dy = sin_t[None, :]
    done = torch.zeros((bsz, n), dtype=torch.bool, device=dev)
    prev_black = torch.zeros((bsz, n, max_gap), dtype=torch.bool, device=dev)  # pre-start: white
    end_x = x0.expand(bsz, n).clone()
    end_y = y0.expand(bsz, n).clone()
    chunk = max(1, min(SPAN, _PLAIN_BLOCK // max(bsz * n, 1)))
    k0 = 0
    while k0 < k_total:
        kspan = min(chunk, k_total - k0)
        kf = torch.arange(k0, k0 + kspan, dtype=F32, device=dev)
        px = x0[:, :, None] + dx[:, :, None] * kf  # two roundings, as the kernel
        py = y0[:, :, None] + dy[:, :, None] * kf
        inb = (px >= 0) & (py >= 0) & (px < w) & (py < h)
        xi = px.to(I32).clamp(0, w - 1)
        yi = py.to(I32).clamp(0, h - 1)
        white = (flat[(yi.to(I64) * w + xi)] == 255) & inb
        black = ~white

        # The first step whose trailing max_gap + 1 samples are all black
        # (window sums over the carry + this chunk), and the first step out.
        black_ext = torch.cat([prev_black, black], dim=2)
        cs = torch.nn.functional.pad(torch.cumsum(black_ext.to(I32), dim=2), (1, 0))
        run_full = (cs[:, :, window:] - cs[:, :, :kspan]) == window
        ka_rel = sd._first_true(run_full & inb)
        ko_rel = inb.sum(dim=2)  # in-plane steps are a prefix
        abort_any = ka_rel < kspan
        oob_any = ko_rel < kspan

        ks_end = (k0 + ka_rel - window).to(F32)
        abort_x = x0 + dx * ks_end
        abort_y = y0 + dy * ks_end
        kof = (k0 + ko_rel).to(F32)
        fx = x0 + dx * kof
        fy = y0 + dy * kof
        cxi = fx.clamp(min=0).to(I32)
        cyi = fy.clamp(min=0).to(I32)
        final_inb = (cxi < w) & (cyi < h)
        fpix = flat[cyi.clamp(0, h - 1).to(I64) * w + cxi.clamp(0, w - 1)]
        final_black = final_inb & (fpix == 0)
        oob_x = torch.where(final_black, fx - dx, x0)
        oob_y = torch.where(final_black, fy - dy, y0)

        act = ~done
        finish_abort = act & abort_any
        finish_oob = act & ~abort_any & oob_any
        end_x = torch.where(finish_abort, abort_x, torch.where(finish_oob, oob_x, end_x))
        end_y = torch.where(finish_abort, abort_y, torch.where(finish_oob, oob_y, end_y))
        done = done | finish_abort | finish_oob
        carry = black_ext[:, :, black_ext.shape[2] - max_gap :]  # the last max_gap samples
        prev_black = torch.where(done[:, :, None], prev_black, carry)
        k0 += kspan
        if bool(done.all()):  # every lane has ended: later steps change nothing
            break
    return end_x, end_y


def finalize_plain(pts, end_x, end_y):
    """Plain twin of the reduce kernel: per seed, the last angle with the
    largest squared length -> (best_x, best_y, best_len) f32 [B]."""
    lx = pts[:, 0:1] - end_x
    ly = pts[:, 1:2] - end_y
    lengths = lx * lx + ly * ly
    n = lengths.shape[1]
    best = ((n - 1) - torch.argmax(lengths.flip(1), dim=1))[:, None]
    return (
        end_x.gather(1, best)[:, 0],
        end_y.gather(1, best)[:, 0],
        lengths.gather(1, best)[:, 0],
    )


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------


def ray_march(mask, pts, max_gap: int, k_total: int, cos_t, sin_t):
    """u8 mask [h, w], f32 seeds [B, 2] (x, y) inside the plane, theta table
    f32 [N] x2 -> (end_x, end_y f32 [B, N], best_x, best_y, best_len f32
    [B]). The plain version on the CPU; on a CUDA device the kernel."""
    tensors = (mask, pts, cos_t, sin_t)
    dev = mask.device
    if any(t.device != dev for t in tensors):
        raise ValueError("mask, seeds and theta table must share a device")
    if mask.dtype != torch.uint8 or mask.dim() != 2:
        raise ValueError(f"expected a u8 [h, w] mask, got {mask.dtype} {tuple(mask.shape)}")
    if pts.dtype != F32 or pts.dim() != 2 or pts.shape[1] != 2:
        raise ValueError(f"expected f32 [B, 2] seeds, got {pts.dtype} {tuple(pts.shape)}")
    if cos_t.dtype != F32 or sin_t.dtype != F32 or cos_t.shape != sin_t.shape or cos_t.dim() != 1:
        raise ValueError("expected f32 [N] cos and sin tables")
    if max_gap < 0 or k_total < 0:
        raise ValueError(f"max_gap {max_gap} and k_total {k_total} must be >= 0")
    if dev.type == "cpu":
        end_x, end_y = march_plain(mask, pts, max_gap, k_total, cos_t, sin_t)
        return (end_x, end_y, *finalize_plain(pts, end_x, end_y))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    mask, pts, cos_t, sin_t = (t.contiguous() for t in tensors)
    h, w = mask.shape
    bsz, n = pts.shape[0], cos_t.numel()
    end_x = torch.empty((bsz, n), dtype=F32, device=dev)
    end_y = torch.empty_like(end_x)
    best = torch.empty((3, bsz), dtype=F32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        code = lib.smh_ray_march(
            mask.data_ptr(), h, w, pts.data_ptr(), bsz, cos_t.data_ptr(), sin_t.data_ptr(), n,
            max_gap, k_total, end_x.data_ptr(), end_y.data_ptr(),
            best[0].data_ptr(), best[1].data_ptr(), best[2].data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(code, "smh_ray_march")
    kernels.LAUNCHES["ray_march"] += 1
    return end_x, end_y, best[0], best[1], best[2]


# ---------------------------------------------------------------------------
# Entry points (smh_tpu.ops.lsd's)
# ---------------------------------------------------------------------------


def find_longest_lines_batch(
    mask_dev: torch.Tensor, pts: list[Point], max_gap: float, max_len: float | None = None
) -> list[tuple[Line, float]]:
    """March a batch of seeds over the device mask; (Line, length_sqr) per
    seed, in order. max_len bounds every line from these seeds (the mask
    bbox diagonal): the march then stops at the span-rounded step bound
    past max_len + max_gap + 2, as the JAX march does."""
    if not pts:
        return []
    h, w = mask_dev.shape
    mg = int(max_gap)
    pts_np = np.zeros((_bucket(len(pts)), 2), dtype=np.float32)
    for i, p in enumerate(pts):
        pts_np[i] = (p.x, p.y)
    cos_t, sin_t = theta_tables(mask_dev.device)
    pts_t = torch.from_numpy(pts_np).to(mask_dev.device)
    _, _, bx, by, bl = ray_march(mask_dev, pts_t, mg, step_bound(h, w, mg, max_len), cos_t, sin_t)
    bx, by, bl = (t.cpu().numpy() for t in (bx, by, bl))
    return [
        (Line(Point(float(p.x), float(p.y)), Point(float(bx[i]), float(by[i]))), float(bl[i]))
        for i, p in enumerate(pts)
    ]


def find_longest_line(
    mask_dev: torch.Tensor, pt: Point, max_gap: float, max_len: float | None = None
) -> tuple[Line, float]:
    """Single-seed convenience wrapper (backend-contract parity)."""
    return find_longest_lines_batch(mask_dev, [pt], max_gap, max_len=max_len)[0]
