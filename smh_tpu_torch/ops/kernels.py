"""The fused pass's hand-written CUDA kernels (all but the ray march and
the scales read), their wrappers, their plain PyTorch twins, and the launch
counts of all eleven of the port's kernels (the fourth, the ray march,
lives in ops/lsd.py; the fifth, the scales read, in ops/scales_device.py):

   1 classify_luma    pallas_kernels.py::_classify_luma_kernel
   2 quiet_walk       pallas_kernels.py::_quiet_walk_kernel_factory + walk tail
   3 fused_mask       pallas_kernels.py::_fused_mask_kernel[_hbm]
   4 ray_march        smh_tpu/ops/lsd.py::_march_span, _finalize, _march
   5 scales_read      smh_tpu/ops/scales_device.py::scales_records
   6 brq_preprocess   pipeline.py: _ocr_preprocess_planes, pack_bits, _weighted_check x2
   7 mask_words       pipeline.py: _mask_bbox, _sparse_words
   8 delta_apply      pipeline.py: the delta dispatches' scatter and lax.scan
   9 hostpack         pipeline.py: the ui _weighted_check, _red_gate_roi, the concatenate
  10 window_crop      pipeline.py: the window crop's clip, dynamic_slice and pack_bits
  11 ocr_band         pipeline.py: the OCR row band and the binary keep bits

Counterpart of smh_tpu/ops/pallas_kernels.py, of the regions of smh_tpu's
jitted fused pass (smh_tpu/ops/pipeline.py::_analyze_flat_core) that
kernels 6, 7 and 9-11 take, and of the delta dispatches' scatter (kernel 8).
Each wrapper takes the plain version for tensors on the CPU, launches its
kernel for tensors on a CUDA device, and raises for anything else: there
is no fallback from the kernel to the plain version and no switch that
bypasses the kernel. `LAUNCHES`
counts kernel launches (and nothing else), so a run can show that the main
path went through the kernels.

Each wrapper also takes a batch: [B, H, W] planes whose frames start
stride(0) bytes apart (the batched pass cuts them from the rows of one
[B, padded] buffer with no copy). A batch is ONE
launch over a grid with a batch axis, counted once: the counterpart of the
vmapped pallas_call of smh_tpu's batch pipeline. Each frame's result is the
per-frame kernel's; the plain versions are shape-generic, so on a batch
they compute each frame's plain result.

* classify_luma_planes -> csrc/classify_luma.cu (kernel 1)
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
* minimap_rect_planes -> csrc/quiet_walk.cu (kernel 2)
  Replaces pallas_kernels.py::_quiet_walk_kernel_factory and the walk tail
  of _rect_pallas_batched (minimap_rect_pallas_planes). Bound by bytes (the
  three planes read once) and, at map sizes, by launch latency. ONE C call
  returns the i32 [B, 4] rects: it clears a scratch of cleared-bit run words
  (merged with atomicOr), runs the quiet pass from 64x32 shared-memory tiles,
  and the last block of each batch element runs the four walks as
  block-wide index reductions. No PyTorch op runs between the kernel and
  the result.
* fused_mask_bits -> csrc/fused_mask.cu (kernel 3)
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
* scales_device.scales_records -> csrc/scales_read.cu (kernel 5)
  Replaces smh_tpu/ops/scales_device.py::scales_records (XLA ops: a
  lax.scan over glyph slots and vmaps over bands, word slots and frames;
  plain twin scales_device.scales_records_plain). Two planes read, a
  1,168 B record written per frame, but bound by the latency of its chain
  of dependent phases (bands, glyph runs, windows, words, bar rows): a
  cluster of 8 blocks per frame, so a batch is one launch.
* brq_preprocess -> csrc/brq_preprocess.cu (kernel 6)
  Replaces the bottom-right quadrant's text preprocess of smh_tpu's fused
  pass (XLA ops): _ocr_preprocess_planes with its R = 3 box dilate, the
  scales binarize luma != 0 and its pack_bits, the two _weighted_checks of
  _pack_outputs and the text mask ocr_img < OCR_BINARY_THRESHOLD. Reads
  the quadrant's R, G, B and luma (kernel 1's) in place; writes ocr_img
  and the scales bits straight into the scalespack, the text and scales
  planes that kernel 5 reads, and the four u32 checksums. 7.125 B/px, but
  bound by the launch and one tile's chain (loads, word ORs, two
  barriers): a lane a quad of 4 pixels, each plane read as aligned 32-bit
  words, each output stored as aligned 4-byte words; the checksums are
  summed in a scratch whose last adder writes them out and zeroes it, so
  no memset precedes the launch (_scratch).
* mask_bbox_sparse -> csrc/mask_words.cu (kernel 7)
  Replaces _mask_bbox and _sparse_words (_pack_words32 + the "search"
  engine of _compact_words) of smh_tpu's _pack_outputs (XLA ops), which
  read the dilated marker mask: from kernel 3's bits it writes the bbox,
  the crop origin 0, the total count of non-zero u32 words and the first
  `budget` of them (index and word), as the hostpack's i32 bytes. Bound by
  the launch and the scan across blocks: a tile of whole rows a block
  (mask_tiles), the tiles joined by a decoupled look-back through a
  scratch that every launch leaves zeroed (_scratch).
* delta_apply -> csrc/delta_apply.cu (kernel 8)
  Replaces the scatter of smh_tpu's delta dispatches (XLA ops):
  _analyze_delta_flat's `.at[idx].set(data)` and the lax.scan of
  _analyze_batch_delta, which applies each frame's chunks to the frame
  before. Writes a fresh [B, padded] buffer whose row i is row i - 1 (row
  -1: the resident buffer, never written) with frame i's chunks applied.
  Bound by bytes (the resident read once, each row written once): a block a
  tile of 16-byte pieces kept in registers down the chain, each frame's
  run of updates in the tile found by a search of its (non-decreasing)
  index table, so no grid barrier and no memset.
* hostpack_tail -> csrc/hostpack.cu (kernel 9)
  Replaces the fused pass's tail (XLA ops): the ui checksum
  _weighted_check(ui_flat), the red gate _red_gate_roi and the hostpack's
  concatenation in _pack_outputs. Reads the ui plane(s) once, the button
  and the sections the other kernels wrote, and writes every byte of the
  hostpack; bound by the launch and one round trip of its reduction, which
  sums in a scratch every launch leaves zeroed (_scratch), as kernel 6's.
* window_crop -> csrc/window_crop.cu (kernel 10)
  Replaces the window crop of smh_tpu's _pack_outputs (XLA ops): the
  origin jnp.clip(bbox - margin), the dynamic_slice of lsd_bool, the meta
  and the window's pack_bits. From kernel 3's bits and kernel 7's bbox it
  writes the meta and the window's bits, a thread an aligned 32-bit word
  of an output row funnel-shifted from the two aligned source words under
  it, in blocks of whole rows. Bound by the launch and two dependent loads
  (the bbox, then the bits), not by its ~26 KB.
* ocr_band -> csrc/ocr_band.cu (kernel 11)
  Replaces the OCR row band of smh_tpu's _pack_outputs (XLA ops): the keep
  mask's row bbox by two _first_true_counts, the band's start, the smeta
  and the dynamic_slices of the scales bits and of pack_bits(keep) or
  ocr_img; and the unbanded binary transport's pack_bits(keep). Banded, a
  thread block cluster of 16 blocks a frame finds the text rows (each
  block a strip, its rows sent to every block by asynchronous distributed
  shared memory stores that an mbarrier counts) and copies the band 16
  bytes a thread; unbanded, a thread packs 16 pixels. Bound by the launch
  and the reduction over the whole keep plane before the copy. The calls
  of kernels 10 and 11 take their checks and arguments from a plan built
  once per inputs' shapes and strides (window_crop_plan_for,
  ocr_band_plan_for).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import NamedTuple

import numpy as np
import torch

from .. import _build, consts as C
from ..ocr.engine import OCR_BINARY_THRESHOLD

LAUNCHES = {
    "classify_luma": 0, "quiet_walk": 0, "fused_mask": 0, "ray_march": 0, "scales_read": 0,
    "brq_preprocess": 0, "mask_words": 0, "delta_apply": 0, "hostpack": 0, "window_crop": 0, "ocr_band": 0,
}
# The kernels every smhocr fused pass launches (ray_march runs on the
# lsd_engine="cuda" path only; its wrapper is ops/lsd.py::ray_march; the
# scales read runs where the pass reads the scales on the device, i.e.
# under smhocr: scales_inline="device").
FUSED_PASS = ("classify_luma", "quiet_walk", "fused_mask", "brq_preprocess", "mask_words", "scales_read", "hostpack")
# The kernel a delta pass launches besides (a full upload has none): one a
# frame, one a batch.
DELTA_PASS = ("delta_apply",)
# The kernel a pass launches besides where the marker mask travels as a
# window crop (SMH_SPARSE=0, the sparse -> window hand-over, a batch's
# lsd_window), and the one where the scales travel as a row band or as
# binary images: one a frame, one a batch.
WINDOW_PASS = ("window_crop",)
BAND_PASS = ("ocr_band",)

# Tile of the quiet-walk kernel (TH rows x TW pixels in csrc/quiet_walk.cu):
# the seams the tests and the chip smoke place their shapes around.
QUIET_TILE_H = 32
QUIET_TILE_W = 64
# Tile of the fused mask kernel (TH rows x TW = 32 * WPR pixels in
# csrc/fused_mask.cu).
FUSED_TILE_H = 16
FUSED_TILE_W = 128
# Kernel 6 (csrc/brq_preprocess.cu): tiles of BRQ_TILE_H rows (of
# BRQ_TILE_H_SMALL where BRQ_TILE_H-row tiles would leave SMs idle) x
# BRQ_TILE_W pixels (the 31 quads of lanes 1 .. 31; lane 0 holds the 4
# pixels before), and the u32s of its scratch a frame.
BRQ_TILE_H = 16
BRQ_TILE_H_SMALL = 8
BRQ_TILE_W = 124
BRQ_SCRATCH = 8
# Kernel 7 (csrc/mask_words.cu): a tile of whole rows, at most
# MASK_TILE_WORDS u32 words, a block of MASK_THREADS threads; a frame at
# most MASK_MAX_TILES tiles, so at most MASK_WORDS_MAX words, and at most
# MASK_MAX_DIM rows and columns; its scratch MASK_SCRATCH_HEAD u32s a frame
# and MASK_STATE_WORDS a tile.
MASK_THREADS = 512
MASK_TILE_WORDS = 2048
MASK_MAX_TILES = 4096
MASK_WORDS_MAX = MASK_MAX_TILES * MASK_TILE_WORDS
MASK_SCRATCH_HEAD = 4
MASK_STATE_WORDS = 4
MASK_MAX_DIM = 0xFFFF
# The i32 lanes of kernel 7's output before its idx and dat: y0, y1, x0,
# x1, the crop origin (0, 0) and nz.
MASK_META = 7
# Kernel 8 (csrc/delta_apply.cu): at most this many frames a launch.
DELTA_MAX_FRAMES = 4096
# Kernel 9 (csrc/hostpack.cu): at most this many sections a launch, and
# the u32s of its scratch a frame (three u64 slots, a 128-byte line each).
HOSTPACK_MAX_SECTIONS = 16
HOSTPACK_SCRATCH = 3 * 32
# Kernels 10 and 11: the bytes of the meta before the window's bits (6
# i32) and before the band's rows (3 i32).
WINDOW_META = 24
BAND_META = 12


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_SCRATCH: dict = {}
_scratch_lock = threading.Lock()


def _scratch(kernel: str, device: torch.device, stream: int, words: int) -> torch.Tensor:
    """A u32 scratch (as int32) of at least `words` for `kernel` on `device`
    and the stream `stream` (its cudaStream_t; the device's current
    stream), kept across calls: the kernel leaves it zeroed at the end of
    every launch, so it is zeroed once, when it is made (or grows). One per
    device and stream, so launches that may run at once never share one;
    calls on one stream run in order. An existing scratch is found with no
    lock (a dict read is atomic); the lock guards making one."""
    key = (kernel, device.index, stream)
    buf = _SCRATCH.get(key)
    if buf is not None and buf.numel() >= words:
        return buf
    with _scratch_lock:
        buf = _SCRATCH.get(key)
        if buf is None or buf.numel() < words:
            buf = torch.zeros(words, dtype=torch.int32, device=device)
            _SCRATCH[key] = buf
        return buf


def _raw_stream(index: int) -> int:
    """The current stream of CUDA device `index`, its cudaStream_t as an
    int, read with no torch.cuda.Stream built: torch._C.
    _cuda_getCurrentRawStream is a private PyTorch API (the one Triton's
    launcher reads)."""
    return torch._C._cuda_getCurrentRawStream(index)


def _stream_ptr(t: torch.Tensor) -> int:
    return _raw_stream(t.device.index)


_CURRENT = contextlib.nullcontext()


def _on(device: torch.device):
    """A context that makes `device` the current CUDA device for a launch:
    none where it already is."""
    return _CURRENT if torch.cuda.current_device() == device.index else torch.cuda.device(device)


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


def _u32_as_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values < 2^32 -> i32 with the same 32 bits (the u32 bytes the
    hostpack carries, in a dtype PyTorch computes with)."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _strided_planes(planes) -> tuple:
    """(row pitch, frame stride) in bytes of u8 [h, w] or [B, h, w] planes
    that may be windows of larger planes (each row contiguous): planes
    that share them, or ValueError."""
    first = planes[0]
    if any(p.stride(-1) != 1 for p in planes):
        raise ValueError("the kernel reads planes whose rows are contiguous")
    pitches = {p.stride(-2) for p in planes}
    strides = {p.stride(0) if p.dim() == 3 else 0 for p in planes}
    if len(pitches) != 1 or len(strides) != 1:
        raise ValueError(f"the planes differ in row pitch or frame stride: {pitches}, {strides}")
    pitch, stride = pitches.pop(), strides.pop()
    h, w = first.shape[-2:]
    if pitch < w or (first.dim() == 3 and first.shape[0] > 1 and stride < (h - 1) * pitch + w):
        raise ValueError(f"rows {pitch} bytes apart or frames {stride} apart overlap a {h}x{w} plane")
    return pitch, stride


# -- kernel 6: the quadrant's text preprocess -------------------------------------


def _brq_outputs(spack: torch.Tensor, text: torch.Tensor, sbool: torch.Tensor, scheck: torch.Tensor,
                 h: int, w: int) -> dict:
    """Kernel 6's outputs as the fused pass reads them: the scalespack
    [..., h * ceil(w/8) + h * w] (scalespack_layout) and views of its two
    sections, the u8 0/1 text and scales planes [..., h, w] and the i32
    [..., 4] checksums."""
    lead = spack.shape[:-1]
    nbits = h * ((w + 7) // 8)
    return {
        "scalespack": spack,
        "scales_bits": spack[..., :nbits].view(*lead, h, (w + 7) // 8),
        "ocr_img": spack[..., nbits:].view(*lead, h, w),
        "text": text,
        "sbool": sbool,
        "scheck": scheck,
    }


def brq_preprocess_plain(r8, g8, b8, luma, row0: int = 0, total_h: int | None = None) -> dict:
    """Plain PyTorch twin of the quadrant preprocess kernel: the eager
    composition smh_tpu's fused pass writes -- _ocr_preprocess_planes,
    pack_bits(luma != 0), the _weighted_checks of the scales bits and of
    ocr_img, and the text mask -- with brq_preprocess's outputs."""
    from . import pipeline as opp

    ocr = opp._ocr_preprocess_planes(r8, g8, b8, luma=luma, row0=row0, total_h=total_h)
    sbool = luma != 0
    bits = opp.pack_bits(sbool)
    scheck = torch.cat([opp._weighted_check(bits), opp._weighted_check(ocr)], dim=-1)
    lead = ocr.shape[:-2]
    spack = torch.cat([bits.reshape(*lead, -1), ocr.reshape(*lead, -1)], dim=-1)
    text = (ocr < OCR_BINARY_THRESHOLD).to(torch.uint8)
    return _brq_outputs(spack, text, sbool.to(torch.uint8), _u32_as_i32(scheck), *ocr.shape[-2:])


def brq_preprocess(r8: torch.Tensor, g8: torch.Tensor, b8: torch.Tensor, luma: torch.Tensor,
                   row0: int = 0, total_h: int | None = None) -> dict:
    """The bottom-right quadrant's text preprocess. r8, g8, b8, luma: u8
    [h, w] or [B, h, w] windows of larger planes (rows contiguous; r, g, b
    sharing a row pitch and a frame stride, luma its own). The planes may
    be rows row0 .. row0 + h of a quadrant total_h rows high (a mesh block
    with halos; default: the whole quadrant). Returns {"scalespack" u8
    [..., h * ceil(w/8) + h * w], "scales_bits" u8 [..., h, ceil(w/8)] and
    "ocr_img" u8 [..., h, w] (views of the scalespack), "text" and "sbool"
    u8 0/1 [..., h, w] (ocr_img < OCR_BINARY_THRESHOLD, luma != 0),
    "scheck" i32 [..., 4] (the u32 sum and weighted sum of the scales bits,
    then of ocr_img)}; one launch for a batch."""
    planes = (r8, g8, b8, luma)
    for p in planes:
        if p.dtype != torch.uint8 or p.dim() not in (2, 3):
            raise ValueError(f"expected u8 planes of rank 2 or 3, got {p.dtype} {tuple(p.shape)}")
        if p.shape != r8.shape or p.device != r8.device:
            raise ValueError("planes differ in shape or device")
    h, w = r8.shape[-2:]
    total_h = h if total_h is None else total_h
    if r8.numel() == 0 or row0 < 0 or row0 + h > total_h:
        raise ValueError(f"planes {tuple(r8.shape)} at row {row0} of a quadrant {total_h} rows high")
    if r8.device.type == "cpu":
        return brq_preprocess_plain(r8, g8, b8, luma, row0=row0, total_h=total_h)
    if r8.device.type != "cuda":
        raise ValueError(f"unsupported device {r8.device}")
    pitch, stride = _strided_planes((r8, g8, b8))
    lpitch, lstride = _strided_planes((luma,))
    lead = r8.shape[:-2]
    bsz = r8.shape[0] if r8.dim() == 3 else 1
    bpr = (w + 7) // 8
    spack = torch.empty((*lead, h * bpr + h * w), dtype=torch.uint8, device=r8.device)
    planes_out = torch.empty((2, *lead, h, w), dtype=torch.uint8, device=r8.device)
    scheck = torch.empty((*lead, 4), dtype=torch.int32, device=r8.device)
    stream = _stream_ptr(r8)
    scratch = _scratch("brq_preprocess", r8.device, stream, BRQ_SCRATCH * bsz)
    lib = _build.load()
    with torch.cuda.device(r8.device):
        code = lib.smh_brq_preprocess(
            r8.data_ptr(), g8.data_ptr(), b8.data_ptr(), pitch, stride, luma.data_ptr(), lpitch, lstride,
            spack.data_ptr(), h * bpr + h * w, planes_out[0].data_ptr(), planes_out[1].data_ptr(), h * w,
            scheck.data_ptr(), scratch.data_ptr(), h, w, bsz, row0, total_h,
            C.OCR_PREPROCESS_MONOCHROMATICY_THRESHOLD, C.OCR_PREPROCESS_BRIGHTNESS_THRESHOLD,
            C.OCR_PREPROCESS_SIMILARITY_EDGE_THRESHOLD, C.OCR_PREPROCESS_BRIGHTNESS_EDGE_THRESHOLD,
            OCR_BINARY_THRESHOLD, stream,
        )
    _build.check(code, "smh_brq_preprocess")
    LAUNCHES["brq_preprocess"] += 1
    return _brq_outputs(spack, planes_out[0], planes_out[1], scheck, h, w)


# -- kernel 7: the marker mask's bbox and sparse words ---------------------------


def mask_bbox_sparse_plain(bits: torch.Tensor, w: int, budget: int) -> torch.Tensor:
    """Plain PyTorch twin of the mask words kernel: unpack_bits_bool, then
    smh_tpu's _mask_bbox and _sparse_words, in mask_bbox_sparse's i32
    layout."""
    from . import pipeline as opp

    m = opp.unpack_bits_bool(bits, w)
    y0, y1, x0, x1 = opp._mask_bbox(m)
    nz, idx, dat = opp._sparse_words(m, budget)
    zero = torch.zeros_like(y0)
    meta = torch.stack([y0, y1, x0, x1, zero, zero, nz], dim=-1)
    return torch.cat([meta.to(torch.int32), idx.to(torch.int32), _u32_as_i32(dat)], dim=-1)


def mask_tiles(h: int, w: int) -> int | None:
    """Kernel 7's tiles for an h x w mask (csrc/mask_words.cu's
    smh_mask_words_tiles): the most whole rows of at most MASK_TILE_WORDS
    u32 words a tile; None where the frame has more than MASK_MAX_DIM rows
    or columns, a row more than MASK_TILE_WORDS words or the frame more
    than MASK_MAX_TILES tiles."""
    nw = -(-((w + 7) // 8) // 4)
    if not (0 < h <= MASK_MAX_DIM and 0 < w <= MASK_MAX_DIM) or nw > MASK_TILE_WORDS:
        return None
    tiles = -(-h // (MASK_TILE_WORDS // nw))
    return tiles if tiles <= MASK_MAX_TILES else None


def mask_bbox_sparse(bits: torch.Tensor, w: int, budget: int) -> torch.Tensor:
    """The dilated marker mask's bbox and sparse words from its bit plane,
    u8 [H, ceil(w/8)] or [B, H, ceil(w/8)] (kernel 3's lsd_bits; each frame
    contiguous, the frames any stride(0) apart; bits past column w are
    read as zero) -> i32 [..., MASK_META + 2 * budget]: y0, y1, x0, x1
    (end-exclusive; H, 0, w, 0 when empty), 0, 0 (the sparse transport's
    crop origin), nz (the TOTAL count of non-zero u32 words), then the
    word index (i * ceil(ceil(w/8) / 4) + j) and the word (its u32 bits) of
    the first `budget` non-zero words in index order, zero past
    min(nz, budget): the hostpack's lsd_meta and lsd_nz / lsd_sp_idx /
    lsd_sp_dat bytes. Budget 0 gives the bbox and nz alone. One launch for
    a batch."""
    if bits.dtype != torch.uint8 or bits.dim() not in (2, 3) or bits.shape[-1] != (w + 7) // 8:
        raise ValueError(f"expected u8 [H, {(w + 7) // 8}] or [B, H, {(w + 7) // 8}] bits, got "
                         f"{bits.dtype} {tuple(bits.shape)}")
    if budget < 0 or bits.numel() == 0:
        raise ValueError(f"budget {budget} for bits {tuple(bits.shape)}")
    if bits.device.type == "cpu":
        return mask_bbox_sparse_plain(bits, w, budget)
    if bits.device.type != "cuda":
        raise ValueError(f"unsupported device {bits.device}")
    tiles = mask_tiles(bits.shape[-2], w)
    if tiles is None:
        raise ValueError(f"a {bits.shape[-2]}x{w} mask: the kernel takes frames of at most {MASK_MAX_DIM} rows and "
                         f"columns and {MASK_MAX_TILES} tiles")
    stride = _frame_stride((bits,))
    bsz = bits.shape[0] if bits.dim() == 3 else 1
    out = torch.empty((*bits.shape[:-2], MASK_META + 2 * budget), dtype=torch.int32, device=bits.device)
    words = bsz * (MASK_SCRATCH_HEAD + MASK_STATE_WORDS * tiles)
    stream = _stream_ptr(bits)
    scratch = _scratch("mask_words", bits.device, stream, words)
    lib = _build.load()
    with torch.cuda.device(bits.device):
        code = lib.smh_mask_words(bits.data_ptr(), stride, bits.shape[-2], w, bsz, budget, scratch.data_ptr(),
                                  scratch.numel(), out.data_ptr(), stream)
    _build.check(code, "smh_mask_words")
    LAUNCHES["mask_words"] += 1
    return out


# -- kernel 8: the delta apply ---------------------------------------------------


def _delta_frames(buf: torch.Tensor, bucket: int, chunk: int) -> int:
    """The frames of a delta upload (from its size), or ValueError."""
    per_frame = bucket * (4 + chunk)
    n = buf.numel()
    if buf.dtype != torch.uint8 or buf.dim() != 1 or bucket <= 0 or chunk <= 0 or n == 0 or n % per_frame:
        raise ValueError(f"delta buffer of {n} bytes does not hold frames of {bucket} chunks of {chunk}")
    return n // per_frame


def delta_apply_plain(resident: torch.Tensor, buf: torch.Tensor, bucket: int, chunk: int) -> torch.Tensor:
    """Plain PyTorch twin of the delta apply kernel: a copy of the row
    before and an index_copy_ of the frame's chunks, frame by frame (any
    index order)."""
    bsz = _delta_frames(buf, bucket, chunk)
    idxs = buf[: 4 * bucket * bsz].view(torch.int32).view(bsz, bucket)
    datas = buf[4 * bucket * bsz :].view(bsz, bucket, chunk)
    rows = torch.empty((bsz, resident.numel()), dtype=torch.uint8, device=resident.device)
    prev = resident
    for i in range(bsz):
        rows[i].copy_(prev)
        rows[i].view(-1, chunk).index_copy_(0, idxs[i].to(torch.int64), datas[i])
        prev = rows[i]
    return rows


def delta_apply(resident: torch.Tensor, buf: torch.Tensor, bucket: int, chunk: int) -> torch.Tensor:
    """The frames of a delta upload rebuilt on the device. resident: u8
    [padded], the frame before (a multiple of `chunk` bytes; never
    written); buf: u8, B index tables of `bucket` i32 chunk indices, then B
    blocks of `bucket` chunks of `chunk` bytes -> a FRESH u8 [B, padded]
    whose row i is row i - 1 (row -1: resident) with frame i's chunks
    written over it (the chain of smh_tpu's _analyze_batch_delta; B = 1:
    _analyze_delta_flat's scatter). One launch, no memset.

    On a CUDA device each frame's indices must be NON-DECREASING (the
    host's diff emits them in ascending order and pads a bucket by
    repeating the last index with its data), and a duplicate index takes
    its last entry's data; chunk must be a multiple of 16, and resident and
    the upload's chunks 16-byte aligned. The plain twin (CPU tensors) takes
    the indices in any order."""
    bsz = _delta_frames(buf, bucket, chunk)
    if resident.dtype != torch.uint8 or resident.dim() != 1 or resident.numel() % chunk:
        raise ValueError(f"resident of {resident.dtype} {tuple(resident.shape)} is not u8 chunks of {chunk}")
    device = resident.device
    if device != buf.device:
        raise ValueError(f"resident on {device}, upload on {buf.device}")
    if device.type == "cpu":
        return delta_apply_plain(resident, buf, bucket, chunk)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if chunk % 16 or bsz > DELTA_MAX_FRAMES or not resident.is_contiguous() or not buf.is_contiguous() \
            or (resident.data_ptr() | (buf.data_ptr() + 4 * bucket * bsz)) % 16:
        raise ValueError(f"the kernel takes chunks of a multiple of 16 bytes at 16-byte aligned addresses and at "
                         f"most {DELTA_MAX_FRAMES} frames: chunk {chunk}, {bsz} frames")
    n = resident.numel()
    out = torch.empty((bsz, n), dtype=torch.uint8, device=device)
    lib = _build.load()
    with _on(device):
        code = lib.smh_delta_apply(resident.data_ptr(), n, buf.data_ptr(), bucket, chunk, bsz, out.data_ptr(),
                                   _raw_stream(device.index))
    _build.check(code, "smh_delta_apply")
    LAUNCHES["delta_apply"] += 1
    return out


# -- kernel 9: the ui checksum, the red gate and the hostpack ----------------------


def _tail_inputs(ui_planes, btn, sections) -> tuple:
    """The leading batch shape of kernel 9's inputs (() or (B,)), checked:
    1 or 3 u8 [..., h, w] ui planes, an optional u8 [..., bh, bw, 3] button,
    u8 [..., n] sections, all of that batch shape on one device."""
    if len(ui_planes) not in (1, 3):
        raise ValueError(f"{len(ui_planes)} ui planes: one (the luma) or three (r, g, b)")
    first = ui_planes[0]
    lead = tuple(first.shape[:-2])
    if len(lead) > 1:
        raise ValueError(f"ui planes of shape {tuple(first.shape)}: [h, w] or [B, h, w]")
    for p in ui_planes:
        if p.dtype != torch.uint8 or p.shape != first.shape or p.device != first.device or p.dim() < 2:
            raise ValueError(f"ui planes must be u8 of one shape and device: {p.dtype} {tuple(p.shape)}")
    if btn is not None and (btn.dtype != torch.uint8 or tuple(btn.shape[:-3]) != lead or btn.dim() < 3
                            or btn.shape[-1] != 3 or btn.device != first.device):
        raise ValueError(f"the button must be u8 [*{lead}, bh, bw, 3] on {first.device}: {btn.dtype} {tuple(btn.shape)}")
    for t in sections:
        if t.dtype != torch.uint8 or tuple(t.shape[:-1]) != lead or t.dim() != len(lead) + 1 or t.device != first.device:
            raise ValueError(f"a section must be u8 [*{lead}, n] on {first.device}: {t.dtype} {tuple(t.shape)}")
    return lead


def hostpack_tail_plain(ui_planes, btn, sections=()) -> torch.Tensor:
    """Plain PyTorch twin of the hostpack kernel: the eager _red_gate_roi,
    _weighted_check of the luma (or of r + g + b) and torch.cat of their
    bytes and the sections."""
    from . import pipeline as opp

    lead = tuple(ui_planes[0].shape[:-2])
    if len(ui_planes) == 1:
        ui_flat = ui_planes[0]
    else:
        ui_flat = ui_planes[0].to(torch.int32) + ui_planes[1].to(torch.int32) + ui_planes[2].to(torch.int32)
    parts = [] if btn is None else [opp._bytes(opp._red_gate_roi(btn).reshape(*lead, 1), lead)]
    parts += [opp._u32_bytes(opp._weighted_check(ui_flat), lead), *sections]
    return torch.cat(parts, dim=-1)


def hostpack_tail(ui_planes, btn, sections=()) -> torch.Tensor:
    """The fused pass's tail in one launch -> u8 [..., 4 + 8 + sum of the
    sections' bytes]: the red gate's f32 share of button-red pixels of btn
    (u8 [..., bh, bw, 3] BGR; None leaves it and its 4 bytes out), the u32
    sum and weighted sum of the ui plane (ui_planes: (luma,), or (r, g, b)
    whose sum it takes; u8 [..., h, w], any strides shared by the three),
    then each section's bytes (u8 [..., n], rows contiguous) in order: the
    hostpack (hostpack_layout) when the sections are its others. A batch
    ([B, ...] inputs) is one launch, its hostpacks the rows of [B, bytes].
    No memset: the kernel writes every byte."""
    first = ui_planes[0]
    device = first.device
    if device.type == "cpu":
        sections = [t for t in sections if t.shape[-1] > 0]
        _tail_inputs(ui_planes, btn, sections)
        return hostpack_tail_plain(ui_planes, btn, sections)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    args, out, _alive = hostpack_args(ui_planes, btn, sections)  # _alive: the table the args point at
    lib = _build.load()
    with _on(device):
        code = lib.smh_hostpack(*args)
    _build.check(code, "smh_hostpack")
    LAUNCHES["hostpack"] += 1
    return out


class HostpackPlan(NamedTuple):
    """What kernel 9's call takes from its inputs' shapes and strides alone,
    built once per (planes, button, sections) shapes and strides and reused
    (hostpack_plan): the row's size and its offsets (red_off, ui_off, each
    section's), the ui planes' geometry (step, pitch and frame stride in
    bytes, h, w), the button's (pixels, frame stride), and the sections'
    table of smh_hostpack (source address, frame stride, offset, bytes)
    with its addresses left 0, `keep` naming the sections (of those given)
    that have bytes."""

    lead: tuple
    bsz: int
    row: int
    red_off: int
    ui_off: int
    n_ui: int
    step: int
    pitch: int
    stride: int
    h: int
    w: int
    btn_px: int
    btn_stride: int
    keep: tuple
    offsets: tuple
    table: tuple


def hostpack_plan(ui_shape, ui_strides, n_ui: int, btn_shape=None, btn_strides=None, sections=()) -> HostpackPlan:
    """Kernel 9's plan (HostpackPlan) for ui planes of `ui_shape` ([h, w] or
    [B, h, w]) and strides `ui_strides` (elements; shared by the n_ui
    planes), a button of `btn_shape` / `btn_strides` ([..., bh, bw, 3];
    None: none) and the sections' (shape, strides) in order; a pure
    function of them, or ValueError where the kernel does not take them."""
    lead = tuple(ui_shape[:-2])
    bsz = lead[0] if lead else 1
    h, w = ui_shape[-2:]
    step, pitch = ui_strides[-1], ui_strides[-2]
    stride = ui_strides[0] if lead and bsz > 1 else 0
    if h * w == 0 or h > 0xFFFF or w > 0xFFFF or step < 1 or pitch < (w - 1) * step + 1:
        raise ValueError(f"ui planes {tuple(ui_shape)} of strides {tuple(ui_strides)}: the kernel takes planes "
                         f"of at most 65535 rows and columns")
    keep = tuple(i for i, (shape, _) in enumerate(sections) if shape[-1] > 0)
    if len(keep) > HOSTPACK_MAX_SECTIONS:
        raise ValueError(f"{len(keep)} sections: the kernel takes at most {HOSTPACK_MAX_SECTIONS}")
    off = 12 if btn_shape is not None else 8
    table, offsets = [], []
    for i in keep:
        shape, strides = sections[i]
        if strides[-1] != 1:
            raise ValueError(f"a section's bytes must be contiguous: strides {tuple(strides)}")
        table += [0, strides[0] if lead and bsz > 1 else 0, off, shape[-1]]
        offsets.append(off)
        off += shape[-1]
    btn_px = btn_stride = 0
    if btn_shape is not None:
        bh, bw = btn_shape[-3:-1]
        if btn_strides[-1] != 1 or btn_strides[-2] != 3 or btn_strides[-3] != 3 * bw or bh * bw == 0:
            raise ValueError(f"the button's pixels must be contiguous BGR: strides {tuple(btn_strides)}")
        btn_px, btn_stride = bh * bw, btn_strides[0] if lead and bsz > 1 else 0
    return HostpackPlan(lead=lead, bsz=bsz, row=off, red_off=0 if btn_shape is not None else -1,
                        ui_off=4 if btn_shape is not None else 0, n_ui=n_ui, step=step, pitch=pitch, stride=stride,
                        h=h, w=w, btn_px=btn_px, btn_stride=btn_stride, keep=keep, offsets=tuple(offsets),
                        table=tuple(table))


_PLANS: dict = {}  # the inputs' (dtype, shape, strides, device) -> HostpackPlan
_tls = threading.local()  # each thread's sections tables: id of a plan in _PLANS -> a ctypes array


def hostpack_plan_for(ui_planes, btn, sections) -> HostpackPlan:
    """The plan of these inputs: the one built for inputs of the same
    dtypes, shapes, strides and devices, else a new one, after every check
    of _tail_inputs and hostpack_plan (a plan found was built from inputs
    that passed them)."""
    key = (len(ui_planes), *[None if t is None else (t.dtype, t.shape, t.stride(), t.device)
                             for t in (*ui_planes, btn, *sections)])
    plan = _PLANS.get(key)
    if plan is None:
        _tail_inputs(ui_planes, btn, [t for t in sections if t.shape[-1] > 0])
        first = ui_planes[0]
        batch = first.dim() == 3 and first.shape[0] > 1
        steps = {(p.stride(-1), p.stride(-2), p.stride(0) if batch else 0) for p in ui_planes}
        if len(steps) != 1:
            raise ValueError(f"the ui planes differ in strides: {steps}")
        plan = _PLANS[key] = hostpack_plan(
            first.shape, first.stride(), len(ui_planes), None if btn is None else btn.shape,
            None if btn is None else btn.stride(), tuple((t.shape, t.stride()) for t in sections))
    return plan


def hostpack_args(ui_planes, btn, sections, own_table: bool = False) -> tuple:
    """(the arguments of smh_hostpack, the fresh output, what must live
    until the call returns) for CUDA inputs (hostpack_tail's; the kernel
    probe calls other builds with them, with a table of its own:
    own_table). Only the addresses are filled in per call: the rest is the
    plan's."""
    plan = hostpack_plan_for(ui_planes, btn, sections)
    first = ui_planes[0]
    device = first.device
    n = len(plan.keep)
    if own_table:
        rows = (ctypes.c_int64 * max(4 * n, 1))(*plan.table)
    else:
        tables = getattr(_tls, "tables", None)
        if tables is None:
            tables = _tls.tables = {}
        rows = tables.get(id(plan))  # the plans in _PLANS live as long as the process
        if rows is None:
            rows = tables[id(plan)] = (ctypes.c_int64 * max(4 * n, 1))(*plan.table)
    if n:
        rows[0 : 4 * n : 4] = [sections[i].data_ptr() for i in plan.keep]
    out = torch.empty((*plan.lead, plan.row), dtype=torch.uint8, device=device)
    stream = _raw_stream(device.index)
    scratch = _scratch("hostpack", device, stream, HOSTPACK_SCRATCH * plan.bsz)
    planes = [p.data_ptr() for p in ui_planes] * (3 // plan.n_ui)
    args = (
        *planes, plan.n_ui, plan.step, plan.pitch, plan.stride, plan.h, plan.w,
        None if btn is None else btn.data_ptr(), plan.btn_stride, plan.btn_px, *_BUTTON_RGB_TOL,
        ctypes.addressof(rows), n, out.data_ptr(), plan.row, plan.red_off, plan.ui_off, plan.bsz, scratch.data_ptr(),
        stream,
    )
    return args, out, (rows, scratch)


# The button's colour (r, g, b) and tolerance, as smh_hostpack takes them.
_BUTTON_RGB_TOL = (*(int(c) for c in C.CLOSE_DEPLOYMENT_BUTTON_COLOR), int(C.CLOSE_DEPLOYMENT_BUTTON_TOLERANCE))


# -- kernel 10: the window crop --------------------------------------------------


def window_crop_plain(bits: torch.Tensor, words: torch.Tensor, w: int, crop_h: int, crop_w: int,
                      margin: int) -> tuple:
    """Plain PyTorch twin of the window crop kernel: unpack_bits_bool, a
    gather of the window at the clamped origin and pack_bits, with the meta
    -- window_crop's outputs."""
    from . import pipeline as opp

    lead = tuple(bits.shape[:-2])
    cy0 = torch.clamp(words[..., 0] - margin, 0, bits.shape[-2] - crop_h)
    cx0 = torch.clamp(words[..., 2] - margin, 0, w - crop_w)
    crop = opp.pack_bits(opp._window_at(opp.unpack_bits_bool(bits, w), cy0, cx0, crop_h, crop_w))
    meta = torch.cat([words[..., :4], torch.stack([cy0, cx0], dim=-1)], dim=-1)
    return opp._bytes(meta, lead), crop.reshape(*lead, -1)


class WindowPlan(NamedTuple):
    """What kernel 10's call takes from its inputs' shapes and strides alone,
    built once per key (window_crop_plan_for): the output's shape, its row
    and window bytes, the row's pieces (meta, window, padding), and
    smh_window_crop's arguments but the addresses (the bits' rows and frame
    stride, the words' frame stride, the frames)."""

    out_shape: tuple
    row: int
    n: int
    pieces: tuple
    h: int
    stride: int
    words_stride: int
    bsz: int


def window_crop_plan(bits_shape, words_strides, crop_h: int, crop_w: int, frame_stride: int) -> WindowPlan:
    """Kernel 10's plan (WindowPlan) for a crop_h x crop_w window of bits of
    `bits_shape` whose frames lie `frame_stride` bytes apart, and words of
    `words_strides`; a pure function of them."""
    lead = tuple(bits_shape[:-2])
    n = crop_h * ((crop_w + 7) // 8)
    row = -(-(WINDOW_META + n) // 4) * 4
    return WindowPlan(out_shape=(*lead, row), row=row, n=n, pieces=(WINDOW_META, n, row - WINDOW_META - n),
                      h=bits_shape[-2], stride=frame_stride,
                      words_stride=words_strides[0] if lead else 0, bsz=lead[0] if lead else 1)


_WINDOW_PLANS: dict = {}  # the inputs' (dtype, shape, strides, device), w, crop and margin -> WindowPlan


def window_crop_plan_for(bits: torch.Tensor, words: torch.Tensor, w: int, crop_h: int, crop_w: int,
                         margin: int) -> WindowPlan:
    """The plan of these inputs: the one built for inputs of the same
    dtypes, shapes, strides and devices and the same w, crop and margin,
    else a new one after every check (a plan found was built from inputs
    that passed them), or ValueError. Found with no lock (a dict read is
    atomic)."""
    key = (bits.dtype, bits.shape, bits.stride(), bits.device, words.dtype, words.shape, words.stride(),
           words.device, w, crop_h, crop_w, margin)
    plan = _WINDOW_PLANS.get(key)
    if plan is not None:
        return plan
    if bits.dtype != torch.uint8 or bits.dim() not in (2, 3) or bits.shape[-1] != (w + 7) // 8 or bits.numel() == 0:
        raise ValueError(f"expected u8 [H, {(w + 7) // 8}] or [B, H, {(w + 7) // 8}] bits, got "
                         f"{bits.dtype} {tuple(bits.shape)}")
    lead = tuple(bits.shape[:-2])
    if words.dtype != torch.int32 or tuple(words.shape[:-1]) != lead or words.dim() != len(lead) + 1 \
            or words.shape[-1] < 4:
        raise ValueError(f"expected i32 [*{lead}, n >= 4] words, got {words.dtype} {tuple(words.shape)}")
    h = bits.shape[-2]
    if not (0 < crop_h <= h and 0 < crop_w <= w) or margin < 0:
        raise ValueError(f"a {crop_h}x{crop_w} window (margin {margin}) of a {h}x{w} mask")
    device = bits.device
    if words.device != device:
        raise ValueError(f"bits on {device}, words on {words.device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    stride = 0
    if device.type == "cuda":
        if words.stride(-1) != 1:
            raise ValueError("the kernel reads words whose lanes are contiguous")
        stride = _frame_stride((bits,))
    plan = _WINDOW_PLANS[key] = window_crop_plan(bits.shape, words.stride(), crop_h, crop_w, stride)
    return plan


def window_crop(bits: torch.Tensor, words: torch.Tensor, w: int, crop_h: int, crop_w: int, margin: int) -> tuple:
    """The crop_h x crop_w window of the dilated marker mask's bit plane
    (kernel 3's lsd_bits, u8 [H, ceil(w/8)] or [B, H, ceil(w/8)], each frame
    contiguous, the frames any stride(0) apart) at its bbox (lanes 0-3 of
    kernel 7's i32 words [..., n]) less `margin`, clamped into the plane ->
    (meta u8 [..., 24]: y0, y1, x0, x1, cy0, cx0 as i32; the window's bits
    u8 [..., crop_h * ceil(crop_w/8)], MSB first, pad bits zero): the
    hostpack's lsd_meta and lsd_crop. One launch for a batch (each frame its
    own origin), no memset, no host sync. The checks and the call's
    arguments come from a plan built once per key (window_crop_plan_for)."""
    plan = window_crop_plan_for(bits, words, w, crop_h, crop_w, margin)
    device = bits.device
    if device.type == "cpu":
        return window_crop_plain(bits, words, w, crop_h, crop_w, margin)
    out = torch.empty(plan.out_shape, dtype=torch.uint8, device=device)
    lib = _build.load()
    with _on(device):
        code = lib.smh_window_crop(bits.data_ptr(), plan.stride, plan.h, w, words.data_ptr(), plan.words_stride,
                                   crop_h, crop_w, margin, plan.bsz, out.data_ptr(), plan.row,
                                   _raw_stream(device.index))
    _build.check(code, "smh_window_crop")
    LAUNCHES["window_crop"] += 1
    meta, crop, _ = out.split_with_sizes(plan.pieces, -1)
    return meta, crop


# -- kernel 11: the OCR row band and the keep bits -----------------------------------


def ocr_band_plain(text: torch.Tensor, scales_bits: torch.Tensor, ocr_img: torch.Tensor, inline: str,
                   band: int | None = None) -> tuple:
    """Plain PyTorch twin of the OCR band kernel: the keep mask's row flags
    and their first-true searches, the band's start, gathers of its rows
    and pack_bits of the keep mask -- ocr_band's outputs."""
    from . import pipeline as opp
    from . import scales_device as sd

    keep = text != 0
    lead = tuple(text.shape[:-2])
    if band is None:
        return scales_bits.reshape(*lead, -1), opp.pack_bits(keep).reshape(*lead, -1)
    brq_h = keep.shape[-2]
    krows = keep.any(dim=-1)
    oy0 = sd._first_true(krows)
    oy1 = brq_h - sd._first_true(krows.flip(-1))
    b0 = torch.clamp(oy0, 0, brq_h - band)
    zero = torch.zeros_like(b0)
    other = opp.pack_bits(keep) if inline == "binary" else ocr_img
    return (
        opp._bytes(torch.stack([oy0, oy1, b0], dim=-1).to(torch.int32), lead),
        opp._window_at(scales_bits, b0, zero, band, scales_bits.shape[-1]).reshape(*lead, -1),
        opp._window_at(other, b0, zero, band, other.shape[-1]).reshape(*lead, -1),
    )


def _plane_layout(t: torch.Tensor, w: int, name: str) -> int:
    """The frame stride in bytes of u8 [h, w] or [B, h, w] rows that lie w
    bytes apart (any frame stride), or ValueError."""
    if t.stride(-1) != 1 or (t.shape[-2] > 1 and t.stride(-2) != w):
        raise ValueError(f"the kernel reads {name} rows {w} bytes apart: strides {tuple(t.stride())}")
    return t.stride(0) if t.dim() == 3 and t.shape[0] > 1 else 0


class BandPlan(NamedTuple):
    """What kernel 11's call takes from its inputs' shapes and strides alone,
    built once per key (ocr_band_plan_for): the output's shape and row, the
    sections' bytes (nb, nx; the unbanded keep mask's is nx), and
    smh_ocr_band's arguments but the addresses (the text plane's frame
    stride, the scales bits' and ocr_img's, h, w, band, binary, frames);
    pieces: the banded row's (smeta, scales bits, keep bits or ocr_img,
    padding)."""

    lead: tuple
    out_shape: tuple
    row: int
    nb: int
    nx: int
    pieces: tuple
    stride: int
    sbits_stride: int
    ocr_stride: int
    h: int
    w: int
    band: int
    binary: int
    bsz: int


def ocr_band_plan(text_shape, inline: str, band: int | None, strides: tuple = (0, 0, 0)) -> BandPlan:
    """Kernel 11's plan (BandPlan) for a text plane of `text_shape` and the
    frame strides (bytes) of the text plane, the scales bits and ocr_img;
    a pure function of them."""
    lead, (h, w) = tuple(text_shape[:-2]), tuple(text_shape[-2:])
    bpr = (w + 7) // 8
    if band is None:
        nb, nx = 0, h * bpr
        row = nx
    else:
        nb, nx = band * bpr, band * (bpr if inline == "binary" else w)
        row = -(-(BAND_META + nb + nx) // 4) * 4
    pieces = (BAND_META, nb, nx, row - BAND_META - nb - nx) if band is not None else ()
    return BandPlan(lead=lead, out_shape=(*lead, row), row=row, nb=nb, nx=nx, pieces=pieces, stride=strides[0],
                    sbits_stride=strides[1], ocr_stride=strides[2], h=h, w=w, band=band or 0,
                    binary=int(inline == "binary"), bsz=lead[0] if lead else 1)


_BAND_PLANS: dict = {}  # the inputs' (dtype, shape, strides, device), inline and band -> BandPlan


def ocr_band_plan_for(text: torch.Tensor, scales_bits: torch.Tensor, ocr_img: torch.Tensor, inline: str,
                      band: int | None) -> BandPlan:
    """The plan of these inputs: the one built for inputs of the same
    dtypes, shapes, strides and devices and the same inline and band, else
    a new one after every check (a plan found was built from inputs that
    passed them), or ValueError. Found with no lock (a dict read is
    atomic)."""
    key = (inline, band, text.dtype, text.shape, text.stride(), text.device, scales_bits.dtype, scales_bits.shape,
           scales_bits.stride(), scales_bits.device, ocr_img.dtype, ocr_img.shape, ocr_img.stride(), ocr_img.device)
    plan = _BAND_PLANS.get(key)
    if plan is not None:
        return plan
    if inline not in ("binary", "gray") or (band is None and inline != "binary"):
        raise ValueError(f"the kernel takes the binary transport or a band: {inline!r}, band {band}")
    if text.dtype != torch.uint8 or text.dim() not in (2, 3) or text.numel() == 0:
        raise ValueError(f"expected a u8 [h, w] or [B, h, w] text plane, got {text.dtype} {tuple(text.shape)}")
    lead, (h, w) = tuple(text.shape[:-2]), text.shape[-2:]
    bpr = (w + 7) // 8
    for t, shape in ((scales_bits, (*lead, h, bpr)), (ocr_img, (*lead, h, w))):
        if t.dtype != torch.uint8 or tuple(t.shape) != shape or t.device != text.device:
            raise ValueError(f"expected u8 {shape} on {text.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if band is not None and not 0 < band <= h:
        raise ValueError(f"a band of {band} rows of a {h}-row quadrant")
    device = text.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    strides = (0, 0, 0)
    if device.type == "cuda":
        strides = (_frame_stride((text,)),
                   *((0, 0) if band is None else (_plane_layout(scales_bits, bpr, "scales bits"),
                                                  _plane_layout(ocr_img, w, "ocr_img"))))
    plan = _BAND_PLANS[key] = ocr_band_plan(text.shape, inline, band, strides)
    return plan


def ocr_band(text: torch.Tensor, scales_bits: torch.Tensor, ocr_img: torch.Tensor, inline: str,
             band: int | None = None) -> tuple:
    """The quadrant's inline scales sections, in the hostpack's order, from
    kernel 6's outputs: the keep (text) plane u8 0/1 [h, w] or [B, h, w],
    the scales bits u8 [..., h, ceil(w/8)] and ocr_img u8 [..., h, w] (rows
    contiguous; the frames any stride apart). inline "binary" or "gray".
    band None ("binary" only): (the scales bits, the packed keep mask u8
    [..., h * ceil(w/8)]); band rows: (smeta u8 [..., 12]: oy0, oy1 and b0
    as i32, the keep mask's first text row, one past its last, and the
    band's start clamp(oy0, 0, h - band); rows b0 .. b0 + band of the scales
    bits; the same rows of the packed keep mask ("binary") or of ocr_img
    ("gray")), each u8 [..., n]. One launch for a batch, no memset, no host
    sync. The checks and the call's arguments come from a plan built once
    per key (ocr_band_plan_for)."""
    plan = ocr_band_plan_for(text, scales_bits, ocr_img, inline, band)
    device = text.device
    if device.type == "cpu":
        return ocr_band_plain(text, scales_bits, ocr_img, inline, band)
    out = torch.empty(plan.out_shape, dtype=torch.uint8, device=device)
    if band is None:
        planes = (None, 0, None, 0)
    else:
        planes = (scales_bits.data_ptr(), plan.sbits_stride, ocr_img.data_ptr(), plan.ocr_stride)
    lib = _build.load()
    with _on(device):
        code = lib.smh_ocr_band(text.data_ptr(), plan.stride, *planes, plan.h, plan.w, plan.band, plan.binary,
                                plan.bsz, out.data_ptr(), plan.row, _raw_stream(device.index))
    _build.check(code, "smh_ocr_band")
    LAUNCHES["ocr_band"] += 1
    if band is None:
        return scales_bits.reshape(*plan.lead, -1), out
    return tuple(out.split_with_sizes(plan.pieces, -1)[:3])
