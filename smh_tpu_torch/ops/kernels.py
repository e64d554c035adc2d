"""The fused pass's three hand-written CUDA kernels, their wrappers, their
plain PyTorch twins, and the launch counts of all five of the port's kernels
(the fourth, the ray march, lives in ops/lsd.py; the fifth, the scales
read, in ops/scales_device.py).

Counterpart of smh_tpu/ops/pallas_kernels.py. Each wrapper takes the plain
version for tensors on the CPU, launches its kernel for tensors on a CUDA
device, and raises for anything else: there is no fallback from the kernel
to the plain version and no switch that bypasses the kernel. `LAUNCHES`
counts kernel launches (and nothing else), so a run can show that the main
path went through the kernels.

Each wrapper also takes a batch: [B, H, W] planes whose frames are
contiguous and start stride(0) >= H * W bytes apart (the batched pass cuts
them from the rows of one [B, padded] buffer with no copy). A batch is ONE
launch over a grid with a batch axis, counted once: the counterpart of the
vmapped pallas_call of smh_tpu's batch pipeline. Each frame's result is the
per-frame kernel's; the plain versions are shape-generic, so on a batch
they compute each frame's plain result.

* classify_luma_planes -> csrc/classify_luma.cu
  Replaces pallas_kernels.py::_classify_luma_kernel
  (classify_luma_pallas_planes). 3 bytes read + 2 written per pixel, but
  bound on the card by the launch and the blocks' ramp, and where pixels
  pass the max-byte mask by the classify's issue, not by those bytes.
  csrc/classify.cuh classifies from shared tables (k/255, the colour tests
  by truncated h, s and max byte) with no division for a pixel whose max
  byte no colour's value test passes and two past it; each thread takes 4
  pixels as aligned 32-bit words of each plane (__funnelshift_r where a
  plane starts unaligned) and stores word-wide. Every float op is rounded
  once (no FMA contraction) and every division correctly rounded, so it is
  bit-exact with the oracle. The tables are built once per device
  (_classify_tables).
* minimap_rect_planes -> csrc/quiet_walk.cu
  Replaces pallas_kernels.py::_quiet_walk_kernel_factory and the walk tail
  of _rect_pallas_batched (minimap_rect_pallas_planes). Bound by bytes (the
  three planes read once) and, at map sizes, by launch latency. ONE C call
  returns the i32 [B, 4] rects: it clears a scratch of cleared-bit run words
  (merged with atomicOr), runs the quiet pass from 64x32 shared-memory tiles,
  and the last block of each batch element runs the four walks as
  block-wide index reductions. No PyTorch op runs between the kernel and
  the result.
* fused_mask_bits -> csrc/fused_mask.cu
  Replaces pallas_kernels.py::_fused_mask_kernel + _fused_mask_kernel_hbm
  (fused_mask_bits_pallas). 3 bytes read per pixel, 1/8 written, but bound
  on the card by the launch and each block's chain of dependent phases, and
  where pixels pass the max-byte mask by the classify's issue, not by those
  bytes. classify -> L1 dilate -> MSB-first pack: a warp classifies 32
  pixels of a row and packs them with one ballot into a shared tile of
  marker words (TH + 2 rows, so only the row halo is classified twice);
  the dilate runs on words with carry bits, so the marker mask never
  reaches device memory. Pad bits are zero, as in the XLA path (the Pallas
  kernel sets them where a marker touches the last column of a ragged
  row).
* scales_device.scales_records -> csrc/scales_read.cu
  Replaces smh_tpu/ops/scales_device.py::scales_records (XLA ops: a
  lax.scan over glyph slots and vmaps over bands, word slots and frames;
  plain twin scales_device.scales_records_plain). Two planes read, a
  1,168 B record written per frame, but bound by the latency of its chain
  of dependent phases (bands, glyph runs, windows, words, bar rows): one
  block per frame, so a batch is one launch.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from .. import _build, consts as C

LAUNCHES = {"classify_luma": 0, "quiet_walk": 0, "fused_mask": 0, "ray_march": 0, "scales_read": 0}
# The kernels every smhocr fused pass launches (ray_march runs on the
# lsd_engine="cuda" path only; its wrapper is ops/lsd.py::ray_march; the
# scales read runs where the pass reads the scales on the device, i.e.
# under smhocr: scales_inline="device").
FUSED_PASS = ("classify_luma", "quiet_walk", "fused_mask", "scales_read")

# Tile of the quiet-walk kernel (TH rows x TW pixels in csrc/quiet_walk.cu):
# the seams the tests and the chip smoke place their shapes around.
QUIET_TILE_H = 32
QUIET_TILE_W = 64
# Tile of the fused mask kernel (TH rows x TW = 32 * WPR pixels in
# csrc/fused_mask.cu).
FUSED_TILE_H = 16
FUSED_TILE_W = 128


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _frame_stride(planes) -> int:
    """The bytes between the frames of [B, H, W] planes (H * W for [H, W]),
    as the kernels read them from data_ptr(): each frame contiguous, the
    three planes sharing one stride of at least H * W, or ValueError."""
    first = planes[0]
    h, w = first.shape[-2:]
    if first.numel() == 0:
        return h * w
    if not all((p[0] if p.dim() == 3 else p).is_contiguous() for p in planes):
        raise ValueError("the kernels read planes whose frames are contiguous")
    if first.dim() == 3 and first.shape[0] > 1:
        strides = {p.stride(0) for p in planes}
        if len(strides) != 1 or min(strides) < h * w:
            raise ValueError(f"the planes' frames must share one stride of at least H * W: {strides}")
        return strides.pop()
    return h * w


def _check_planes(planes, ranks) -> tuple:
    """(device, frame stride in bytes) of u8 [H, W] or [B, H, W] planes of
    one shape and device (`ranks`: the ranks the kernel takes); the layout
    is checked where a kernel reads it, on a CUDA device."""
    first = planes[0]
    for p in planes:
        if p.dtype != torch.uint8 or p.dim() not in ranks:
            raise ValueError(f"expected u8 planes of rank {' or '.join(map(str, ranks))}, "
                             f"got {p.dtype} {tuple(p.shape)}")
        if p.shape != first.shape or p.device != first.device:
            raise ValueError("planes differ in shape or device")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {first.device}")
    if first.device.type == "cpu":
        return first.device, None
    return first.device, _frame_stride(planes)


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


_COLOURS = (C.ALPHA_MARKER_COLOR_HSV, C.BRAVO_MARKER_COLOR_HSV, C.CHARLIE_MARKER_COLOR_HSV)


def classify_tables_plain() -> np.ndarray:
    """Plain twin of the table kernel (csrc/classify.cuh, ClassifyTables):
    u8 bytes of f32 unit[256] = k / 255 (numpy's f32 division is correctly
    rounded, as __fdiv_rn is), then by max byte, (int)s and (int)h the bits
    of the colours whose value, saturation (with min_sat) and hue tests
    pass."""
    unit = np.arange(256, dtype=np.float32) / np.float32(255)
    vi = (np.float32(100) * unit).astype(np.int32)
    k = np.arange(361)
    vib, sat, hue = np.zeros(256, np.uint8), np.zeros(104, np.uint8), np.zeros(376, np.uint8)
    for c, (h, s, v) in enumerate(_COLOURS):
        vib |= (np.abs(vi - v) <= C.FIND_MARKER_HSV_VIB_TOLERANCE).astype(np.uint8) << c
        ks = k[:101]
        sat_ok = (np.abs(ks - s) <= C.FIND_MARKER_HSV_SAT_TOLERANCE) | (
            np.abs(ks - (s - C.FIND_MARKER_PLAYER_DIR_ARC_SAT)) <= C.FIND_MARKER_HSV_SAT_TOLERANCE
        )
        sat[:101] |= (sat_ok & (ks >= C.FIND_MARKER_HSV_MIN_SAT)).astype(np.uint8) << c
        hue[:361] |= (np.abs(k - h) <= C.FIND_MARKER_HSV_HUE_TOLERANCE).astype(np.uint8) << c
    return np.concatenate([unit.view(np.uint8), vib, sat, hue])


_tables: dict = {}  # device index -> (tables, the stream that built them, its event)
_tables_lock = threading.Lock()


def _classify_tables(lib, device: torch.device) -> torch.Tensor:
    """The tables kernels 1 and 3 classify with (csrc/classify.cuh: k/255,
    the max-byte mask and the colour tests), on this device. One launch
    builds them from the 14 params at first use, no host sync; a stream
    other than the one that built them waits for that launch's event."""
    stream = torch.cuda.current_stream(device)
    with _tables_lock:
        entry = _tables.get(device.index)
        if entry is None:
            tables = torch.empty(lib.smh_classify_tables_bytes(), dtype=torch.uint8, device=device)
            code = lib.smh_classify_tables(tables.data_ptr(), ctypes.addressof(_CLASSIFY_PARAMS), stream.cuda_stream)
            _build.check(code, "smh_classify_tables")
            built = torch.cuda.Event()
            built.record(stream)
            entry = _tables[device.index] = (tables, stream.cuda_stream, built)
    tables, built_on, built = entry
    if stream.cuda_stream != built_on:
        stream.wait_event(built)
    return tables


def classify_luma_planes_plain(r8, g8, b8):
    """Plain PyTorch twin of the classify kernel: (marker u8 0/1, luma u8),
    pixel by pixel, so of any shape."""
    from . import hsv

    marker = hsv.is_any_map_marker_color_planes(r8, g8, b8).to(torch.uint8)
    return marker, hsv.luma8_planes(r8, g8, b8)


def classify_luma_planes(r8: torch.Tensor, g8: torch.Tensor, b8: torch.Tensor):
    """u8 [H, W] R, G, B planes -> (marker u8 0/1 [H, W], luma u8 [H, W]);
    [B, H, W] planes -> [B, H, W] outputs in one launch (each frame's
    outputs start 4-byte aligned, for the kernel's word stores: where H * W
    is not a multiple of 4 they are views of rows padded to one)."""
    device, stride = _check_planes((r8, g8, b8), (2, 3))
    if device.type == "cpu":
        return classify_luma_planes_plain(r8, g8, b8)
    h, w = r8.shape[-2:]
    out_stride = -(-h * w // 4) * 4
    bsz = r8.shape[0] if r8.dim() == 3 else 1
    if r8.dim() == 3 and out_stride != h * w:
        marker = torch.empty((bsz, out_stride), dtype=torch.uint8, device=device)[:, : h * w].view(bsz, h, w)
        luma = torch.empty((bsz, out_stride), dtype=torch.uint8, device=device)[:, : h * w].view(bsz, h, w)
    else:
        marker = torch.empty(r8.shape, dtype=torch.uint8, device=device)
        luma = torch.empty(r8.shape, dtype=torch.uint8, device=device)
    if r8.numel() == 0:
        return marker, luma
    lib = _build.load()
    with torch.cuda.device(device):
        code = lib.smh_classify_luma(
            r8.data_ptr(), g8.data_ptr(), b8.data_ptr(),
            marker.data_ptr(), luma.data_ptr(), h * w, bsz, stride, out_stride,
            _classify_tables(lib, device).data_ptr(), _stream_ptr(r8),
        )
    _build.check(code, "smh_classify_luma")
    LAUNCHES["classify_luma"] += 1
    return marker, luma


# -- kernel 2: minimap quiet mask + walk reductions -------------------------------


def minimap_rect_planes_plain(p0, p1, p2) -> torch.Tensor:
    """Plain PyTorch twin of the quiet-walk kernel: u8 [B, H, W] x3 -> i32
    [B, 4] (left, top, right, bottom)."""
    from . import pipeline as opp

    return opp._minimap_rect(opp._edgy_quiet_planes(p0, p1, p2))


def minimap_rect_planes(p0: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Channel planes u8 [B, H, W] x3 -> i32 [B, 4] minimap rects (one C call
    for the whole batch: a scratch clear and one launch; SAD sums channels,
    so plane order does not matter). Each frame must be contiguous; the
    frames may lie any stride(0) >= H * W bytes apart."""
    device, stride = _check_planes((p0, p1, p2), (3,))
    if device.type == "cpu":
        return minimap_rect_planes_plain(p0, p1, p2)
    bsz, h, w = p0.shape
    if p0.numel() == 0:
        raise ValueError(f"empty planes {tuple(p0.shape)}")
    out = torch.empty((bsz, 4), dtype=torch.int32, device=device)
    scratch = torch.empty(bsz * (w + h + 1), dtype=torch.int32, device=device)
    lib = _build.load()
    with torch.cuda.device(device):
        code = lib.smh_quiet_walk(
            p0.data_ptr(), p1.data_ptr(), p2.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            bsz, h, w, stride, 4, _stream_ptr(p0),
        )
    _build.check(code, "smh_quiet_walk")
    LAUNCHES["quiet_walk"] += 1
    return out


# -- kernel 3: fused classify -> dilate -> bit-pack ---------------------------------


def fused_mask_bits_plain(r8, g8, b8) -> torch.Tensor:
    """Plain PyTorch twin of the fused mask kernel:
    pack_bits(_dilate_l1_radius1_bool(classify)) -> u8 [H, ceil(W/8)] (or
    [B, H, ceil(W/8)]: both steps are per frame)."""
    from . import hsv
    from . import pipeline as opp

    marker = hsv.is_any_map_marker_color_planes(r8, g8, b8)
    return opp.pack_bits(opp._dilate_l1_radius1_bool(marker))


def fused_mask_bits(r8: torch.Tensor, g8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """u8 [H, W] R, G, B planes -> the dilated marker mask bit-packed MSB
    first, u8 [H, ceil(W/8)], pad bits zero; [B, H, W] planes -> u8
    [B, H, ceil(W/8)] in one launch."""
    device, stride = _check_planes((r8, g8, b8), (2, 3))
    if device.type == "cpu":
        return fused_mask_bits_plain(r8, g8, b8)
    h, w = r8.shape[-2:]
    bsz = r8.shape[0] if r8.dim() == 3 else 1
    bits = torch.empty((*r8.shape[:-1], (w + 7) // 8), dtype=torch.uint8, device=device)
    if bits.numel() == 0:
        return bits
    lib = _build.load()
    with torch.cuda.device(device):
        code = lib.smh_fused_mask(
            r8.data_ptr(), g8.data_ptr(), b8.data_ptr(), bits.data_ptr(), h, w, bsz, stride,
            h * ((w + 7) // 8), _classify_tables(lib, device).data_ptr(), _stream_ptr(r8),
        )
    _build.check(code, "smh_fused_mask")
    LAUNCHES["fused_mask"] += 1
    return bits
