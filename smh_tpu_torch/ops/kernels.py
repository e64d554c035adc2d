"""The fused pass's three hand-written CUDA kernels, their wrappers, their
plain PyTorch twins, and the launch counts of all four of the port's kernels
(the fourth, the ray march, lives in ops/lsd.py).

Counterpart of smh_tpu/ops/pallas_kernels.py. Each wrapper takes the plain
version for tensors on the CPU, launches its kernel for tensors on a CUDA
device, and raises for anything else: there is no fallback from the kernel
to the plain version and no switch that bypasses the kernel. `LAUNCHES`
counts kernel launches (and nothing else), so a run can show that the main
path went through the kernels.

* classify_luma_planes -> csrc/classify_luma.cu
  Replaces pallas_kernels.py::_classify_luma_kernel
  (classify_luma_pallas_planes). Bound by bytes: 3 read + 2 written per
  pixel at ~40 flops. One coalesced elementwise pass, one thread per pixel;
  __f*_rn intrinsics keep it bit-exact with the oracle (no FMA contraction,
  correctly rounded division).
* minimap_rect_planes -> csrc/quiet_walk.cu
  Replaces pallas_kernels.py::_quiet_walk_kernel_factory
  (_rect_pallas_batched, minimap_rect_pallas_planes). Bound by bytes: the
  three planes are read once; the 8-neighbour SAD runs from a shared-memory
  tile with a 1-px halo. The quiet mask never reaches device memory: each
  block ANDs its column and row partials into [B, W] / [B, H] 3-bit words
  with atomicAnd (bitwise, so block order cannot matter), and the walks run
  in PyTorch on those vectors.
* fused_mask_bits -> csrc/fused_mask.cu
  Replaces pallas_kernels.py::_fused_mask_kernel + _fused_mask_kernel_hbm
  (fused_mask_bits_pallas). Bound by bytes: 3 read per pixel, 1/8 written;
  classify -> L1 dilate -> MSB-first pack from a shared-memory tile with a
  1-px halo, so the marker mask never reaches device memory. Pad bits are
  zero, as in the XLA path (the Pallas kernel sets them where a marker
  touches the last column of a ragged row).
"""

from __future__ import annotations

import ctypes

import torch

from smh_tpu import consts as C

from .. import _build

LAUNCHES = {"classify_luma": 0, "quiet_walk": 0, "fused_mask": 0, "ray_march": 0}
# The kernels every fused pass launches (ray_march runs on the
# lsd_engine="cuda" path only; its wrapper is ops/lsd.py::ray_march).
FUSED_PASS = ("classify_luma", "quiet_walk", "fused_mask")

# Rows per block of the quiet-walk kernel (TH in csrc/quiet_walk.cu): the
# tile seams the tests and the chip smoke place their heights around.
QUIET_TILE_H = 8
# Tile of the fused mask kernel (TH rows x TW pixels in csrc/fused_mask.cu).
FUSED_TILE_H = 8
FUSED_TILE_W = 256


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_planes(planes, ndim: int) -> torch.device:
    first = planes[0]
    for p in planes:
        if p.dtype != torch.uint8 or p.dim() != ndim:
            raise ValueError(f"expected u8 planes of rank {ndim}, got {p.dtype} {tuple(p.shape)}")
        if p.shape != first.shape or p.device != first.device:
            raise ValueError("planes differ in shape or device")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {first.device}")
    return first.device


# -- kernel 1: classify + luma ---------------------------------------------------

_CLASSIFY_PARAMS = (ctypes.c_int * 14)(
    *C.ALPHA_MARKER_COLOR_HSV,
    *C.BRAVO_MARKER_COLOR_HSV,
    *C.CHARLIE_MARKER_COLOR_HSV,
    C.FIND_MARKER_HSV_HUE_TOLERANCE,
    C.FIND_MARKER_HSV_SAT_TOLERANCE,
    C.FIND_MARKER_PLAYER_DIR_ARC_SAT,
    C.FIND_MARKER_HSV_VIB_TOLERANCE,
    C.FIND_MARKER_HSV_MIN_SAT,
)


def classify_luma_planes_plain(r8, g8, b8):
    """Plain PyTorch twin of the classify kernel: (marker u8 0/1, luma u8)."""
    from . import hsv

    marker = hsv.is_any_map_marker_color_planes(r8, g8, b8).to(torch.uint8)
    return marker, hsv.luma8_planes(r8, g8, b8)


def classify_luma_planes(r8: torch.Tensor, g8: torch.Tensor, b8: torch.Tensor):
    """u8 [H, W] R, G, B planes -> (marker u8 0/1 [H, W], luma u8 [H, W])."""
    device = _check_planes((r8, g8, b8), 2)
    if device.type == "cpu":
        return classify_luma_planes_plain(r8, g8, b8)
    r8, g8, b8 = (p.contiguous() for p in (r8, g8, b8))
    marker = torch.empty_like(r8)
    luma = torch.empty_like(r8)
    if r8.numel() == 0:
        return marker, luma
    lib = _build.load()
    with torch.cuda.device(device):
        code = lib.smh_classify_luma(
            r8.data_ptr(), g8.data_ptr(), b8.data_ptr(),
            marker.data_ptr(), luma.data_ptr(), r8.numel(),
            ctypes.addressof(_CLASSIFY_PARAMS), _stream_ptr(r8),
        )
    _build.check(code, "smh_classify_luma")
    LAUNCHES["classify_luma"] += 1
    return marker, luma


# -- kernel 2: minimap quiet mask + walk reductions -------------------------------


def _run_lengths(h: int, w: int) -> tuple[int, int, int, int]:
    cy, cx = h // 2, w // 2
    lv = abs(h - cy) // 2 - 1  # vertical run length (left/right candidates)
    lh = abs(w - cx) // 2 - 1  # horizontal run length (up/down candidates)
    return cy, lv, cx, lh


def minimap_rect_planes_plain(p0, p1, p2) -> torch.Tensor:
    """Plain PyTorch twin of the quiet-walk kernel + tail: u8 [B, H, W] x3 ->
    i32 [B, 4] (left, top, right, bottom)."""
    from . import pipeline as opp

    return opp._minimap_rect(opp._edgy_quiet_planes(p0, p1, p2))


def rect_from_bits(colbits: torch.Tensor, rowbits: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The walk tail on the kernel's [B, W] / [B, H] 3-bit words -> i32 [B, 4]
    (the bound_gate + walks tail of pallas_kernels._rect_pallas_batched)."""
    from . import pipeline as opp

    cy, lv, cx, lh = _run_lengths(h, w)

    def bit(v, k):
        return ((v >> k) & 1) == 1

    def bound_gate(vec, lo, hi, dim):
        if hi <= lo:
            return torch.ones_like(vec)
        if lo < 3 or (hi - 1) > dim - 3:
            return torch.zeros_like(vec)
        return vec

    down_run = bound_gate(bit(colbits, 0), cy + 1, cy + 1 + lv, h)
    up_run = bound_gate(bit(colbits, 1), cy - lv, cy, h)
    centre_row = bit(colbits, 2)
    right_run = bound_gate(bit(rowbits, 0), cx + 1, cx + 1 + lh, w)
    left_run = bound_gate(bit(rowbits, 1), cx - lh, cx, w)
    centre_col = bit(rowbits, 2)
    return opp._minimap_walks(
        centre_row & down_run,
        centre_row & up_run,
        centre_col & right_run,
        centre_col & left_run,
        h,
        w,
    )


def minimap_rect_planes(p0: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Channel planes u8 [B, H, W] x3 -> i32 [B, 4] minimap rects (one launch
    for the whole batch; SAD sums channels, so plane order does not matter)."""
    device = _check_planes((p0, p1, p2), 3)
    if device.type == "cpu":
        return minimap_rect_planes_plain(p0, p1, p2)
    p0, p1, p2 = (p.contiguous() for p in (p0, p1, p2))
    bsz, h, w = p0.shape
    if p0.numel() == 0:
        raise ValueError(f"empty planes {tuple(p0.shape)}")
    cy, lv, cx, lh = _run_lengths(h, w)
    colbits = torch.full((bsz, w), 7, dtype=torch.int32, device=device)
    rowbits = torch.full((bsz, h), 7, dtype=torch.int32, device=device)
    lib = _build.load()
    with torch.cuda.device(device):
        code = lib.smh_quiet_walk(
            p0.data_ptr(), p1.data_ptr(), p2.data_ptr(),
            colbits.data_ptr(), rowbits.data_ptr(),
            bsz, h, w, cy, lv, cx, lh, _stream_ptr(p0),
        )
    _build.check(code, "smh_quiet_walk")
    LAUNCHES["quiet_walk"] += 1
    return rect_from_bits(colbits, rowbits, h, w)


# -- kernel 3: fused classify -> dilate -> bit-pack ---------------------------------


def fused_mask_bits_plain(r8, g8, b8) -> torch.Tensor:
    """Plain PyTorch twin of the fused mask kernel:
    pack_bits(_dilate_l1_radius1_bool(classify)) -> u8 [H, ceil(W/8)]."""
    from . import hsv
    from . import pipeline as opp

    marker = hsv.is_any_map_marker_color_planes(r8, g8, b8)
    return opp.pack_bits(opp._dilate_l1_radius1_bool(marker))


def fused_mask_bits(r8: torch.Tensor, g8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """u8 [H, W] R, G, B planes -> the dilated marker mask bit-packed MSB
    first, u8 [H, ceil(W/8)], pad bits zero."""
    device = _check_planes((r8, g8, b8), 2)
    if device.type == "cpu":
        return fused_mask_bits_plain(r8, g8, b8)
    r8, g8, b8 = (p.contiguous() for p in (r8, g8, b8))
    h, w = r8.shape
    bits = torch.empty((h, (w + 7) // 8), dtype=torch.uint8, device=device)
    if bits.numel() == 0:
        return bits
    lib = _build.load()
    with torch.cuda.device(device):
        code = lib.smh_fused_mask(
            r8.data_ptr(), g8.data_ptr(), b8.data_ptr(), bits.data_ptr(), h, w,
            ctypes.addressof(_CLASSIFY_PARAMS), _stream_ptr(r8),
        )
    _build.check(code, "smh_fused_mask")
    LAUNCHES["fused_mask"] += 1
    return bits
