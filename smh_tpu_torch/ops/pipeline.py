"""The fused per-frame pass in PyTorch.

Port of smh_tpu/ops/pipeline.py (the `channels=3` plane-major flat upload;
the LSD mask as a window crop, the full plane or sparse words; the scales
transports "none", "device", "binary" and "gray", the last two whole or as
a row band). One call of `analyze_packed_flat` runs the whole device half of
a frame: marker classify + luma (CUDA kernel 1), the dilated marker mask's
bit plane (CUDA kernel 3), the OCR preprocess, scales binarize, text mask
and their checksums over the map's bottom-right quadrant (CUDA kernel 6),
the minimap rect (CUDA kernel 2), the on-device scales read (CUDA kernel
5), the mask bbox and sparse word compaction (CUDA kernel 7), the window
crop (CUDA kernel 10), the OCR row band or the binary keep bits (CUDA
kernel 11), then the red gate and the ui checksum, written with every other
section into ONE u8 hostpack (CUDA kernel 9) whose bytes equal the JAX
package's hostpack. `analyze_delta_flat` first rebuilds the frame from a
device-resident buffer and the changed 32 B chunks of the delta upload
(CUDA kernel 8). `analyze_map_planar` is the debug re-pass, which also keeps
the isolated marker pixels and the cropped quadrant.

`analyze_batch_packed_flat` and `analyze_batch_delta_flat` run the same pass
over B frames at once (smh_tpu's batch throughput path): the building
blocks below take an optional leading batch dimension, and each kernel
runs ONCE per batch on [B, H, W] planes cut from the rows of the [B,
padded] upload (kernels 5 and 7: a cluster of blocks per frame).

The window and band origins are device scalars: kernels 10 and 11 compute
them and cut at them on the device (their plain twins by a gather at origin
+ iota), never by slicing at a host int.

On a CUDA tensor the kernels launch; on a CPU tensor their plain twins run
(ops/kernels.py, ops/scales_device.py). Nothing here reads a tensor's value on the host or
copies from host memory (constants are made on the device: a pageable
host-to-device copy would synchronise the stream), so a dispatch queues on
the stream without waiting for it.

uint32 arithmetic (checksums, the packed mask words) is done in int64 and
masked to 32 bits: PyTorch neither wraps uint32 sums nor shifts uint32.

The host helpers at the bottom (`hostpack_layout`, `sparse_mask_host`, ...)
are jax-free copies of the originals, pinned to them by the tests.
"""

from __future__ import annotations

import torch

from .. import consts as C
from . import hsv, kernels
from . import scales_device as sd

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
U32_MASK = 0xFFFFFFFF

# Black context around the LSD bbox inside a crop window (>= LSD_MAX_GAP + 2
# and >= LSD_CENTRE_MAX_DIST makes crop-local detection exact).
LSD_CROP_MARGIN = C.LSD_MAX_GAP + C.LSD_CENTRE_MAX_DIST + 4  # 24


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def _dilate_l1_radius1_bool(m: torch.Tensor) -> torch.Tensor:
    """Cross-shaped (L1 r=1) binary dilation via shifted ORs, of a [..., h, w]
    mask (each [h, w] plane on its own)."""
    out = m.clone()
    out[..., 1:, :] |= m[..., :-1, :]
    out[..., :-1, :] |= m[..., 1:, :]
    out[..., :, 1:] |= m[..., :, :-1]
    out[..., :, :-1] |= m[..., :, 1:]
    return out


def _box_dilate_bool(m: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1)^2 separable box dilation with edge clamping, of [..., h, w]."""
    out = m
    for axis in (0, 1):
        acc = out.clone()
        for d in range(1, radius + 1):
            if axis == 0:
                acc[..., d:, :] |= out[..., :-d, :]
                acc[..., :-d, :] |= out[..., d:, :]
            else:
                acc[..., :, d:] |= out[..., :, :-d]
                acc[..., :, :-d] |= out[..., :, d:]
        out = acc
    return out


def pack_bits(mask_bool: torch.Tensor) -> torch.Tensor:
    """bool [..., h, w] -> u8 [..., h, ceil(w/8)], MSB first (np.unpackbits
    order)."""
    *lead, h, w = mask_bool.shape
    w8 = ((w + 7) // 8) * 8
    padded = torch.zeros((*lead, h, w8), dtype=torch.uint8, device=mask_bool.device)
    padded[..., :w] = mask_bool
    shifts = 7 - torch.arange(8, dtype=I32, device=mask_bool.device)
    weights = torch.ones_like(shifts) << shifts  # 128 .. 1
    return (padded.view(*lead, h, w8 // 8, 8).to(I32) * weights).sum(dim=-1).to(torch.uint8)


def _pack_words32(mask_bool: torch.Tensor) -> torch.Tensor:
    """bool [..., h, w] -> flat u32 word plane [..., words] (as int64 values
    < 2^32): word j of row i covers pixels [32j, 32j+32), laid out so the
    host byte view of each little-endian u32 reproduces pack_bits'
    MSB-first bytes (pixel p -> byte lane p//8 % 4, bit 7 - p%8)."""
    *lead, h, w = mask_bool.shape
    w32 = ((w + 31) // 32) * 32
    padded = torch.zeros((*lead, h, w32), dtype=torch.bool, device=mask_bool.device)
    padded[..., :w] = mask_bool
    p = torch.arange(32, dtype=I64, device=mask_bool.device)
    weights = torch.ones_like(p) << (8 * (p // 8) + (7 - p % 8))
    return (padded.view(*lead, h, w32 // 32, 32).to(I64) * weights).sum(dim=-1).reshape(*lead, -1)


def _compact_words(words: torch.Tensor, budget: int):
    """First `budget` nonzero words of a flat word plane [..., n]: (nz = TOTAL
    nonzero count [...], idx [..., budget], dat [..., budget]); slots past
    min(nz, budget) are zero. Binary search of each output rank over the
    inclusive prefix count (the JAX "search" engine): static shapes, no
    nonzero(), no host sync; a leading batch dimension searches each plane
    in the same call."""
    nzmask = words != 0
    count = torch.cumsum(nzmask.to(I64), dim=-1)  # inclusive: rank+1 at hits
    nz = count[..., -1]
    ranks = torch.arange(1, budget + 1, dtype=I64, device=words.device)
    found = torch.searchsorted(count, ranks.expand(*count.shape[:-1], budget).contiguous(), side="left")
    valid = torch.arange(budget, dtype=I64, device=words.device) < torch.clamp(nz, max=budget)[..., None]
    src = torch.where(valid, torch.clamp(found, max=words.shape[-1] - 1), 0)
    dat = torch.where(valid, words.gather(-1, src), 0)
    return nz, src, dat  # src doubles as idx (0 in invalid slots)


def _sparse_words(mask_bool: torch.Tensor, budget: int):
    """Compact the nonzero u32 words of a bool [..., h, w] mask plane. Word
    indices are in the padded grid (sparse_word_pad bytes per row)."""
    return _compact_words(_pack_words32(mask_bool), budget)


def _mask_bbox(m: torch.Tensor):
    """Bounding box (y0, y1, x0, x1) of True pixels of [..., h, w],
    end-exclusive, each [...]. Empty mask -> y0 == h, y1 == 0."""
    rowany = m.any(dim=-1)
    colany = m.any(dim=-2)
    h, w = m.shape[-2:]
    y0 = sd._first_true(rowany)
    y1 = h - sd._first_true(rowany.flip(-1))
    x0 = sd._first_true(colany)
    x1 = w - sd._first_true(colany.flip(-1))
    return y0, y1, x0, x1


def _weighted_check(plane: torch.Tensor) -> torch.Tensor:
    """[..., 2] u32 content checksum (sum + position-weighted sum) of each
    [h, w] plane of [..., h, w], as int64 values < 2^32 (uint32 wraparound
    done in int64, masked)."""
    p = plane.to(I64)
    h, w = p.shape[-2:]
    rows = torch.arange(1, h + 1, dtype=I64, device=p.device)
    cols = torch.arange(7, w + 7, dtype=I64, device=p.device)
    weighted = ((p * rows[:, None]) * cols[None, :]).sum(dim=(-2, -1))
    return torch.stack([p.sum(dim=(-2, -1)), weighted], dim=-1) & U32_MASK


def _dense(t: torch.Tensor) -> torch.Tensor:
    """t in row-major strides: contiguous() keeps a size-1 dimension's odd
    stride (a [1, 1] slice of a batch of one), which a dtype view refuses."""
    t = t.contiguous()
    return t if t.dim() == 0 or t.stride(-1) == 1 else t.clone(memory_format=torch.contiguous_format)


def _bytes(t: torch.Tensor, lead: tuple = ()) -> torch.Tensor:
    """Little-endian byte view of a tensor (the JAX bitcast_convert_type),
    flat per frame of the leading batch shape `lead`."""
    return _dense(t).view(torch.uint8).reshape(*lead, -1)


def _u32_bytes(v: torch.Tensor, lead: tuple = ()) -> torch.Tensor:
    """Bytes of int64 values < 2^32 as little-endian u32 (the low 4 bytes),
    flat per frame of the leading batch shape `lead`."""
    return _dense(v).view(torch.uint8).reshape(*lead, -1, 8)[..., :4].reshape(*lead, -1)


def _window_at(plane: torch.Tensor, r0: torch.Tensor, c0: torch.Tensor, hh: int, ww: int) -> torch.Tensor:
    """plane[..., r0 : r0 + hh, c0 : c0 + ww] of [h, w] or [B, h, w] with
    device-scalar origins r0, c0 of shape [] or [B] (in range by
    construction): one gather over the frames (a plane is a batch of one),
    no host sync."""
    if plane.dim() == 2:
        return _window_at(plane[None], r0.reshape(1), c0.reshape(1), hh, ww)[0]
    dev = plane.device
    rows = r0[:, None] + torch.arange(hh, dtype=I64, device=dev)
    cols = c0[:, None] + torch.arange(ww, dtype=I64, device=dev)
    frame = torch.arange(plane.shape[0], dtype=I64, device=dev)
    return plane[frame[:, None, None], rows[:, :, None], cols[:, None, :]]


# -- minimap (the plain version of kernel 2) ----------------------------------


def _edgy_quiet_planes(p0: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Low-edginess mask on channel planes [..., h, w]: quiet[y, x] <=> max
    over the 8 neighbours of sum_ch |a - b| <= 7; the 1-px border is False."""
    planes = [p.to(torch.int16) for p in (p0, p1, p2)]
    *lead, h, w = planes[0].shape
    quiet = torch.zeros((*lead, h, w), dtype=torch.bool, device=p0.device)
    if h < 3 or w < 3:
        return quiet
    best = torch.zeros((*lead, h - 2, w - 2), dtype=torch.int16, device=p0.device)
    centres = [p[..., 1:-1, 1:-1] for p in planes]
    for dy in range(3):
        for dx in range(3):
            if dy == 1 and dx == 1:
                continue
            d = torch.zeros_like(best)
            for p, c in zip(planes, centres):
                d = d + (c - p[..., dy : dy + h - 2, dx : dx + w - 2]).abs()
            best = torch.maximum(best, d)
    quiet[..., 1:-1, 1:-1] = best <= 7
    return quiet


def _minimap_rect(quiet: torch.Tensor) -> torch.Tensor:
    """Minimap bounds from the low-edginess mask [..., h, w] -> i32 [..., 4]
    (left, top, right, bottom): the reference walk from the map centre.
    Unlike the JAX graph's packed popcount there is no run-length limit."""
    h, w = quiet.shape[-2:]
    cx, cy = w // 2, h // 2
    lv = abs(h - cy) // 2 - 1  # vertical run length (left/right candidates)
    lh = abs(w - cx) // 2 - 1  # horizontal run length (up/down candidates)

    centre_row = quiet[..., cy, :]
    centre_col = quiet[..., :, cx]

    def run_check(runs_all, lo: int, hi: int, dim: int, like: torch.Tensor):
        """Walk-bound rule: empty run -> all pass; run outside [3, dim-3] ->
        none pass; else every pixel of the run must be quiet."""
        if hi <= lo:
            return torch.ones_like(like)
        if lo < 3 or (hi - 1) > dim - 3:
            return torch.zeros_like(like)
        return runs_all(lo, hi)

    def col_all(lo, hi):
        return quiet[..., lo:hi, :].all(dim=-2)

    def row_all(lo, hi):
        return quiet[..., :, lo:hi].all(dim=-1)

    down_run = run_check(col_all, cy + 1, cy + 1 + lv, h, centre_row)
    up_run = run_check(col_all, cy - lv, cy, h, centre_row)
    right_run = run_check(row_all, cx + 1, cx + 1 + lh, w, centre_col)
    left_run = run_check(row_all, cx - lh, cx, w, centre_col)
    return _minimap_walks(
        centre_row & down_run,  # left: run downward
        centre_row & up_run,  # right: run upward
        centre_col & right_run,  # top: run rightward
        centre_col & left_run,  # bottom: run leftward
        h,
        w,
    )


def _minimap_walks(left_q, right_q, up_q, down_q, h: int, w: int) -> torch.Tensor:
    """The centre-out first-true walks over the per-direction qualifier
    vectors [..., n] -> i32 [..., 4] (csrc/quiet_walk.cu runs them as index
    reductions on the card)."""
    cx, cy = w // 2, h // 2

    def walk_down(q, start: int):
        """First qualifying index walking start-1, ..., 3; one step back
        toward the centre, or 0 when exhausted."""
        seg = q[..., 3:start].flip(-1)
        k = sd._first_true(seg)
        found = k < seg.shape[-1]
        return torch.where(found, (start - 1) - k + 1, 0)

    def walk_up(q, start: int, c_max: int):
        """First qualifying index walking start+1, ..., c_max; one step
        back, or c_max + 2 when exhausted."""
        seg = q[..., start + 1 : c_max + 1]
        k = sd._first_true(seg)
        found = k < seg.shape[-1]
        return torch.where(found, (start + 1) + k - 1, c_max + 2)

    left = walk_down(left_q, cx)
    right = walk_up(right_q, cx, w - 3)
    top = walk_down(up_q, cy)
    bottom = walk_up(down_q, cy, h - 3)
    return torch.stack([left, top, right, bottom], dim=-1).to(I32)


# -- OCR preprocess + red gate --------------------------------------------------


def _ocr_preprocess_planes(r8, g8, b8, luma=None, row0: int = 0, total_h: int | None = None) -> torch.Tensor:
    """Whiteish-text isolation of u8 planes [..., h, w] (oracle:
    pixmath.ocr_preprocess). `luma` may pass the planes' Rec.709 luma when
    it is already computed. The planes may be rows row0 .. row0 + h of a
    quadrant total_h rows high (a row-sharded block; default: the whole
    quadrant): the reference's last-rows clip is taken in the quadrant's
    rows."""
    h, w = r8.shape[-2:]
    total_h = h if total_h is None else total_h
    r = r8.to(torch.int16)
    g = g8.to(torch.int16)
    b = b8.to(torch.int16)
    mono = 2 * ((r - g).abs() + (r - b).abs() + (g - b).abs())
    mn = torch.minimum(torch.minimum(r8, g8), b8)

    strict = (mono <= C.OCR_PREPROCESS_MONOCHROMATICY_THRESHOLD) & (
        mn >= C.OCR_PREPROCESS_BRIGHTNESS_THRESHOLD
    )
    edge_cand = (mono <= C.OCR_PREPROCESS_SIMILARITY_EDGE_THRESHOLD) & (
        mn >= C.OCR_PREPROCESS_BRIGHTNESS_EDGE_THRESHOLD
    )

    R = C.OCR_PREPROCESS_DILATE_RADIUS
    # The reference never examines neighbours in the last R-1 columns/rows.
    clipped = strict.clone()
    clipped[..., :, max(w - R + 1, 0) :] = False
    clipped[..., max(total_h - R + 1 - row0, 0) :, :] = False
    near_strict = _box_dilate_bool(clipped, R)

    keep = strict | (edge_cand & near_strict)
    if luma is None:
        luma = hsv.luma8_planes(r8, g8, b8)
    return torch.where(keep, 255 - luma, torch.full_like(luma, 255))


def _red_gate_roi(btn: torch.Tensor) -> torch.Tensor:
    """btn: interleaved BGR u8 [..., bh, bw, 3] close-button ROI -> f32 red
    fraction [...] (0-dim for one frame)."""
    bh, bw = btn.shape[-3:-1]
    ok = torch.ones(btn.shape[:-1], dtype=torch.bool, device=btn.device)
    for i, c in enumerate(C.CLOSE_DEPLOYMENT_BUTTON_COLOR):  # R, G, B
        chan = btn[..., 2 - i].to(torch.int16)
        ok = ok & ((int(c) - chan).abs() <= C.CLOSE_DEPLOYMENT_BUTTON_TOLERANCE)
    # XLA lowers the JAX package's `count / n` to count * (1/n) (docs/DESIGN.md
    # §4); the same rounding keeps the hostpack bytes equal.
    recip = hsv.f32_scalar(1.0, btn.device) / hsv.f32_scalar(bh * bw, btn.device)
    return ok.sum(dim=(-2, -1)).to(F32) * recip


# ---------------------------------------------------------------------------
# The fused pass
# ---------------------------------------------------------------------------


def _analyze_map_planes(
    b8: torch.Tensor,
    g8: torch.Tensor,
    r8: torch.Tensor,
    grayscale: bool,
    with_ocr: bool = True,
    with_quiet: bool = True,
    with_isolated: bool = False,
) -> dict:
    """The fused pass over the map ROI as BGR channel planes ([h, w] each,
    or [B, h, w] for a batch: each kernel then runs once for all frames).
    The dilated marker mask is kernel 3's bit plane "lsd_bits" (no bool
    plane: unpack_bits_bool makes one where a consumer reads it).
    "ui_planes" are the planes the ui checksum reads: kernel 1's luma, or
    r, g and b whose sum it takes (kernel 9 sums them). with_ocr
    adds kernel 6's outputs over the bottom-right quadrant ("scalespack",
    "scales_bits", "ocr_img", "text", "sbool", "scheck"). with_isolated adds the debug views' planes: the map
    with non-marker pixels black and the bottom-right quadrant, both
    interleaved RGB."""
    map_h, map_w = b8.shape[-2:]
    marker_u8, luma = kernels.classify_luma_planes(r8, g8, b8)

    # ui_map: grayscale travels as the luma plane; colour re-interleaves.
    ui = luma if grayscale else torch.stack([r8, g8, b8], dim=-1)

    out = {
        "ui": ui,
        "ui_planes": (luma,) if grayscale else (r8, g8, b8),
        "lsd_bits": kernels.fused_mask_bits(r8, g8, b8),
    }
    if with_ocr:
        brq_h, brq_w = map_h // 2, map_w // 2

        def brq(p):
            return p[..., brq_h : brq_h + brq_h, brq_w : brq_w + brq_w]

        # The quadrant's windows of the planes and of kernel 1's luma, read
        # in place by kernel 6.
        out.update(kernels.brq_preprocess(brq(r8), brq(g8), brq(b8), brq(luma)))
    if with_quiet:
        if b8.dim() == 3:
            out["minimap_rect"] = kernels.minimap_rect_planes(b8, g8, r8)
        else:
            out["minimap_rect"] = kernels.minimap_rect_planes(b8[None], g8[None], r8[None])[0]
    if with_isolated:
        brq_h, brq_w = map_h // 2, map_w // 2
        rgb = torch.stack([r8, g8, b8], dim=-1)
        out["isolated_map"] = torch.where(marker_u8[..., None] != 0, rgb, torch.zeros_like(rgb))
        out["cropped_brq"] = rgb[..., brq_h : brq_h + brq_h, brq_w : brq_w + brq_w, :]
    return out


def _ui_check(ui_planes) -> torch.Tensor:
    """The ui checksum, [..., 2] u32 as int64 values < 2^32, of the ui
    planes by kernel 9 with no button and no section (the entries whose
    outputs carry it outside a hostpack)."""
    return kernels.hostpack_tail(ui_planes, None).view(I32).to(I64) & U32_MASK


def _pack_outputs(
    out: dict,
    btn: torch.Tensor,
    map_w: int,
    with_ocr: bool,
    with_quiet: bool,
    scales_inline: str = "none",
    sparse_budget: int | None = None,
    templates: torch.Tensor | None = None,
    crop_h: int | None = None,
    crop_w: int | None = None,
    scales_band: int | None = None,
) -> dict:
    """Pack every detection-path output into ONE u8 hostpack (layout:
    hostpack_layout with the same flags). For a batch (outputs with a
    leading [B] dimension) the hostpacks are the rows of a [B, bytes]
    tensor. Kernel 7 reads kernel 3's bits of the map_w-wide mask once for
    its bbox (and, with a sparse budget, its sparse words), in the
    hostpack's i32 bytes; kernel 10 cuts the window crop at that bbox and
    kernel 11 the OCR row band (or packs the binary keep bits) from kernel
    6's planes; the scalespack is kernel 6's buffer. Kernel 9
    computes the red gate over btn (interleaved BGR u8 [..., bh, bw, 3])
    and the ui checksum and writes them and every other section into the
    hostpack, in one launch."""
    lsd_bits = out["lsd_bits"]
    *lead, map_h, _ = lsd_bits.shape
    lead = tuple(lead)
    crop_h = map_h if crop_h is None else crop_h
    crop_w = map_w if crop_w is None else crop_w
    # [..., 7 + 2 budget] i32: bbox, crop origin 0, nz, idx, dat
    words = kernels.mask_bbox_sparse(lsd_bits, map_w, sparse_budget or 0)
    word_bytes = words.view(torch.uint8)
    if sparse_budget is not None or (crop_h, crop_w) == (map_h, map_w):
        # Sparse words or the full plane: the crop origin is the plane
        # origin, and the full plane's bits are kernel 3's.
        meta = word_bytes[..., :24]
        crop_bits = lsd_bits
    else:
        # Window crop at the bbox less the margin, clamped into the plane:
        # kernel 10 computes the origin on the device and writes the meta
        # and the window's bits.
        meta, crop_bits = kernels.window_crop(lsd_bits, words, map_w, crop_h, crop_w, int(LSD_CROP_MARGIN))
    parts = [meta]  # after the red ratio and the ui checksum, which kernel 9 computes
    banded = with_ocr and scales_inline in ("binary", "gray") and scales_band is not None
    if banded and lead:
        raise ValueError("the scales row band is per frame")
    if with_ocr:
        parts.append(_bytes(out["scheck"], lead))
        if banded or scales_inline == "binary":
            # Kernel 11, from kernel 6's text plane (ocr_img <
            # OCR_BINARY_THRESHOLD): the packed keep mask, or the OCR
            # text-row band. Every text pixel lies in the keep mask's row
            # bbox and the bar scan reads at most scales_scan_budget rows
            # below it, so a band anchored at the bbox is read-complete.
            parts += kernels.ocr_band(out["text"], out["scales_bits"], out["ocr_img"], scales_inline, scales_band)
        elif scales_inline == "gray":
            parts += [out["scales_bits"].reshape(*lead, -1), out["ocr_img"].reshape(*lead, -1)]
        elif scales_inline == "device":
            if templates is None:
                raise ValueError('scales_inline="device" needs the template tensor')
            rec = sd.scales_records(out["text"], out["sbool"], templates)  # one launch for the batch
            parts.append(_bytes(rec, lead))
        elif scales_inline != "none":
            raise ValueError(f"unsupported scales_inline {scales_inline!r}")
    if with_quiet:
        parts.append(_bytes(out["minimap_rect"], lead))
    if sparse_budget is not None:
        parts.append(word_bytes[..., 24:])  # nz, idx, dat: the hostpack's order
    else:
        parts.append(crop_bits.reshape(*lead, -1))
    res = {
        "hostpack": kernels.hostpack_tail(out["ui_planes"], btn, parts),
        "ui": out["ui"],
        "lsd_bits": out["lsd_bits"],  # full mask: the window/sparse-miss fallback
    }
    if with_ocr and (scales_inline in ("none", "device") or banded):
        # The lazy transport's payload, and the fallback of the band (a miss)
        # and of the device read (overflow with nothing trusted): kernel 6
        # wrote the scales bits and ocr_img into it.
        res["scalespack"] = out["scalespack"]
    return res


def analyze_packed_flat(
    rois: torch.Tensor,
    map_h: int,
    map_w: int,
    btn_h: int,
    btn_w: int,
    grayscale: bool,
    with_ocr: bool = True,
    with_quiet: bool = True,
    scales_inline: str = "none",
    sparse_budget: int | None = None,
    templates: torch.Tensor | None = None,
    crop_h: int | None = None,
    crop_w: int | None = None,
    scales_band: int | None = None,
) -> dict:
    """The full-upload dispatch: one flat u8 buffer holding the map ROI as
    PLANE-MAJOR BGR (B, G, R planes) followed by the interleaved-BGR button
    ROI (bytes past map+btn are ignored) -> {"hostpack", "ui", "lsd_bits",
    "scalespack"?}. The JAX counterpart is
    smh_tpu.ops.pipeline._analyze_packed_flat(..., channels=3)."""
    if rois.dtype != torch.uint8 or rois.dim() != 1:
        raise ValueError("rois must be a flat u8 tensor")
    map_bytes = map_h * map_w * 3
    planes = rois[:map_bytes].view(3, map_h, map_w)  # a view: no layout copy
    btn = rois[map_bytes : map_bytes + btn_h * btn_w * 3].view(btn_h, btn_w, 3)
    out = _analyze_map_planes(
        planes[0], planes[1], planes[2], grayscale, with_ocr=with_ocr,
        with_quiet=with_quiet,
    )
    return _pack_outputs(
        out, btn, map_w, with_ocr, with_quiet, scales_inline,
        sparse_budget=sparse_budget, templates=templates, crop_h=crop_h,
        crop_w=crop_w, scales_band=scales_band,
    )


def analyze_delta_flat(
    resident: torch.Tensor, buf: torch.Tensor, bucket: int, chunk: int, **kw
) -> dict:
    """The delta-upload dispatch: `resident` is the previous frame's flat
    buffer on the device, `buf` the upload — `bucket` int32 chunk indices
    (non-decreasing: kernel 8's order) then `bucket` chunks of `chunk`
    bytes. Kernel 8 writes the new frame into a FRESH buffer: a consume
    view of the previous frame may still re-dispatch from `resident`, so it
    is never written in place. Index padding repeats a real index with
    identical data, so the duplicate writes leave one deterministic result.
    Returns analyze_packed_flat's outputs (`kw` are its flags) plus
    "resident", the new buffer. The JAX counterpart is
    smh_tpu.ops.pipeline._analyze_delta_flat(..., channels=3)."""
    if buf.dtype != torch.uint8 or buf.numel() != bucket * (4 + chunk):
        raise ValueError(f"delta buffer of {buf.numel()} bytes does not hold {bucket} chunks of {chunk}")
    rois = kernels.delta_apply(resident, buf, bucket, chunk)[0]
    out = analyze_packed_flat(rois, **kw)
    out["resident"] = rois
    return out


def analyze_batch_packed_flat(
    rois: torch.Tensor,
    map_h: int,
    map_w: int,
    btn_h: int,
    btn_w: int,
    grayscale: bool,
    with_ocr: bool = True,
    crop_h: int | None = None,
    crop_w: int | None = None,
    scales_inline: str = "none",
    sparse_budget: int | None = None,
    templates: torch.Tensor | None = None,
    resident_row: int | None = None,
) -> dict:
    """The batched fused pass: B flat buffers as the rows of u8 [B, padded]
    (each laid out as analyze_packed_flat's) -> {"hostpack" [B, bytes],
    "lsd_bits" [B, map_h, ceil(map_w/8)], "scalespack" [B, bytes]?,
    "resident"?}. Frame b's planes are views of row b (no layout copy), so
    each kernel runs once for the batch: kernels 1-3 on [B, H, W] planes
    that lie a row apart, kernels 6 and 5 on the batch's [B, h, w]
    quadrants, kernel 7 on the [B, H, ceil(W/8)] bits. `resident_row`
    returns a copy of that row as "resident": it seeds the batch delta
    chain. The
    JAX counterpart is smh_tpu.ops.pipeline._analyze_batch_packed(...,
    channels=3); each row's outputs equal analyze_packed_flat's."""
    if rois.dtype != torch.uint8 or rois.dim() != 2:
        raise ValueError("rois must be a u8 [B, padded] tensor")
    bsz = rois.shape[0]
    map_bytes = map_h * map_w * 3
    planes = rois[:, :map_bytes].view(bsz, 3, map_h, map_w)  # views: no layout copy
    btn = rois[:, map_bytes : map_bytes + btn_h * btn_w * 3].view(bsz, btn_h, btn_w, 3)
    out = _analyze_map_planes(planes[:, 0], planes[:, 1], planes[:, 2], grayscale, with_ocr=with_ocr)
    packed = _pack_outputs(
        out, btn, map_w, with_ocr, True, scales_inline, sparse_budget=sparse_budget,
        templates=templates, crop_h=crop_h, crop_w=crop_w,
    )
    res = {"hostpack": packed["hostpack"], "lsd_bits": packed["lsd_bits"]}
    if "scalespack" in packed:
        res["scalespack"] = packed["scalespack"]
    if resident_row is not None:
        res["resident"] = rois[resident_row].clone()
    return res


def analyze_batch_delta_flat(
    resident: torch.Tensor, buf: torch.Tensor, bucket: int, chunk: int, **kw
) -> dict:
    """The batched delta pass: B frames as chunk updates against the
    device-resident chain, `buf` = B index tables of `bucket` int32 (each
    non-decreasing) then B blocks of `bucket` chunks of `chunk` bytes.
    Kernel 8 writes frame i, frame i-1 (frame 0: `resident`) with its
    updates applied, into row i of a FRESH [B, padded] buffer in one launch
    (`resident` is never written: a consume view may still hold it); then
    analyze_batch_packed_flat (`kw` are its flags) runs once over the rows.
    Returns its outputs plus "resident", the last frame (the next batch's
    chain input): a view of the last row, since nothing writes the rows
    after the kernel. It keeps the batch's B rows alive until the next
    batch replaces it, (B - 1) * padded bytes more than a copy would hold
    (17 MB at the 1080p map and B = 8), and saves writing a copy. The JAX
    counterpart is smh_tpu.ops.pipeline._analyze_batch_delta(...,
    channels=3), whose lax.scan the kernel's chain replaces."""
    rois = kernels.delta_apply(resident, buf, bucket, chunk)
    out = analyze_batch_packed_flat(rois, **kw)
    out["resident"] = rois[rois.shape[0] - 1]
    return out


def analyze_map_planar(planes: torch.Tensor, grayscale: bool = True, with_isolated: bool = False) -> dict:
    """The fused pass over a plane-major BGR u8 [3, h, w] map ROI (the
    resident layout): the debug re-pass reads the resident buffer with no
    layout copy. The JAX counterpart is smh_tpu.ops.pipeline.analyze_map_planar."""
    out = _analyze_map_planes(
        planes[0], planes[1], planes[2], grayscale, with_quiet=False, with_isolated=with_isolated,
    )
    out["ui_check"] = _ui_check(out.pop("ui_planes"))
    return out


def analyze_map(map_bgra: torch.Tensor, grayscale: bool = True, with_isolated: bool = False) -> dict:
    """The fused pass over an INTERLEAVED map ROI, u8 [h, w, 4] BGRA or
    [h, w, 3] BGR on its device (the alpha byte is never read): the
    outputs of smh_tpu's `_analyze_map` with its defaults (the XLA quiet
    mask, no Pallas) -- `_analyze_map_planes`' (less kernel 6's hostpack
    outputs) plus "lsd_bool" (unpacked from kernel 3's bits), "quiet_bool"
    and "lsd_mask" (u8 0/255, the march's input). The ROI is split into
    contiguous planes first: the kernels read contiguous planes. Not a
    transport (the production path uploads planes): the whole-frame entry
    of the multi-device path and its checks. The JAX counterpart is
    smh_tpu.ops.pipeline.analyze_map."""
    b8, g8, r8 = (map_bgra[..., c].contiguous() for c in range(3))
    out = _analyze_map_planes(b8, g8, r8, grayscale, with_quiet=False, with_isolated=with_isolated)
    out["ui_check"] = _ui_check(out.pop("ui_planes"))
    for key in ("scalespack", "text", "scheck"):  # the hostpack's, not _analyze_map's
        del out[key]
    out["scales_bool"] = out.pop("sbool").view(torch.bool)
    out["lsd_bool"] = unpack_bits_bool(out["lsd_bits"], map_bgra.shape[1])
    out["lsd_mask"] = mask_u8(out["lsd_bool"])
    out["quiet_bool"] = _edgy_quiet_planes(b8, g8, r8)
    return out


def analyze_frame(frame, grayscale: bool = True, with_isolated: bool = False, device="cuda") -> dict:
    """analyze_map over the map ROI of a whole BGRA u8 [H, W, 4] frame: a
    tensor runs on its own device, a numpy array is uploaded to `device`
    first. The JAX counterpart is smh_tpu.ops.pipeline.analyze_frame."""
    if not isinstance(frame, torch.Tensor):
        from .. import resolve_device

        frame = torch.from_numpy(frame).to(resolve_device(device))
    h, w = frame.shape[:2]
    g = C.map_geometry(w, h)
    roi = frame[g.map_y : g.map_y + g.map_h, g.map_x : g.map_x + g.map_w]
    return analyze_map(roi, grayscale=grayscale, with_isolated=with_isolated)


def mask_u8(lsd_bool: torch.Tensor) -> torch.Tensor:
    """The u8 0/255 LSD mask of a bool mask."""
    return lsd_bool.to(torch.uint8) * 255


def unpack_bits_device(packed: torch.Tensor, w: int) -> torch.Tensor:
    """Device-side inverse of pack_bits -> 0/255 u8 [..., h, w]: the u8 mask
    the device ray march samples, rebuilt from the bit plane."""
    return _unpack_bits(packed, w) * 255


def unpack_bits_bool(packed: torch.Tensor, w: int) -> torch.Tensor:
    """Device-side inverse of pack_bits -> bool [..., h, w]: the dilated
    marker mask lsd_bool, where a consumer reads a bool plane (the window
    crop, analyze_map, the mesh blocks), from kernel 3's bits."""
    return _unpack_bits(packed, w).view(torch.bool)


def _unpack_bits(packed: torch.Tensor, w: int) -> torch.Tensor:
    """u8 0/1 [..., h, w] of the MSB-first bit plane u8 [..., h, row]."""
    *lead, h, row = packed.shape
    shifts = 7 - torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*lead, h, row * 8)[..., :w]


# ---------------------------------------------------------------------------
# Host helpers (jax-free copies of smh_tpu/ops/pipeline.py)
# ---------------------------------------------------------------------------


def unpack_bits_host(packed, w: int):
    """Host-side inverse of pack_bits -> 0/1 u8 [h, w]."""
    import numpy as np

    return np.unpackbits(packed, axis=1)[:, :w]


def binary_ocr_image_host(keep_bits, w: int):
    """The 0/255 OCR image from the bit-packed text mask: the host side of
    the binary transport (exact for binary_ok engines, which only evaluate
    `gray < OCR_BINARY_THRESHOLD`)."""
    import numpy as np

    keep = unpack_bits_host(keep_bits, w)
    return np.where(keep != 0, np.uint8(0), np.uint8(255))


def bbox_crop_host(bits, bbox, origin, shape):
    """Unpack ONLY the mask-bbox + LSD_CROP_MARGIN slice of a bit-packed LSD
    plane -> (0/255 u8 crop, (ox, oy) full-plane offset of the crop).
    bits: (ch, (cw+7)//8) bit rows of a crop whose top-left is `origin`
    (ox, oy); bbox: absolute end-exclusive (y0, y1, x0, x1); shape: logical
    (ch, cw) of the crop. Caller handles the empty bbox."""
    import numpy as np

    y0, y1, x0, x1 = bbox
    ox, oy = origin
    ch, cw = shape
    m = int(LSD_CROP_MARGIN)
    r0 = max(0, y0 - oy - m)
    r1 = min(ch, y1 - oy + m)
    b0 = max(0, x0 - ox - m) // 8
    b1 = min((cw + 7) // 8, (x1 - ox + m + 7) // 8)
    sub = np.ascontiguousarray(bits[r0:r1, b0:b1])
    wlim = min(b1 * 8, cw) - b0 * 8
    crop = np.unpackbits(sub, axis=1)[:, :wlim] * np.uint8(255)
    return crop, (ox + b0 * 8, oy + r0)


def sparse_word_pad(bpr: int) -> int:
    """Bit-row bytes padded up to whole u32 words."""
    return ((bpr + 3) // 4) * 4


def sparse_mask_host(nz: int, idx, dat, map_h: int, map_w: int):
    """Host-side inverse of _sparse_words -> bit-packed u8 [map_h, bpr]
    plane. Exact only when nz fit the budget (idx.size)."""
    import numpy as np

    bpr = (map_w + 7) // 8
    bpr4 = sparse_word_pad(bpr)
    buf = np.zeros(map_h * (bpr4 // 4), dtype=np.uint32)
    k = min(int(nz), idx.size)
    buf[idx[:k]] = dat[:k]
    return buf.view(np.uint8).reshape(map_h, bpr4)[:, :bpr]


def hostpack_layout(
    map_h: int,
    map_w: int,
    with_ocr: bool = True,
    with_quiet: bool = True,
    crop_h: int | None = None,
    crop_w: int | None = None,
    scales_inline: str = "none",
    scales_band: int | None = None,
    sparse_budget: int | None = None,
) -> dict:
    """Byte offsets (offset, size) of each section inside the hostpack
    (v2 layout of smh_tpu.ops.pipeline.hostpack_layout)."""
    crop_h = map_h if crop_h is None else crop_h
    crop_w = map_w if crop_w is None else crop_w
    brq_h, brq_w = map_h // 2, map_w // 2
    crop_bytes = crop_h * ((crop_w + 7) // 8)
    sections = [
        ("red_ratio", 4),
        ("ui_check", 8),
        ("lsd_meta", 24),
    ]
    if with_ocr:
        sections += [("scales_check", 16)]
        rows = brq_h if scales_band is None else scales_band
        row_bits = (brq_w + 7) // 8
        if scales_inline in ("binary", "gray") and scales_band is not None:
            sections += [("scales_meta", 12)]
        if scales_inline == "binary":
            sections += [("scales_bits", rows * row_bits), ("ocr_bits", rows * row_bits)]
        elif scales_inline == "gray":
            sections += [("scales_bits", rows * row_bits), ("ocr_img", rows * brq_w)]
        elif scales_inline == "device":
            sections += [("scales_rec", sd.REC_BYTES)]
    if with_quiet:
        sections += [("minimap_rect", 16)]
    if sparse_budget is not None:
        sections += [
            ("lsd_nz", 4),
            ("lsd_sp_idx", 4 * sparse_budget),
            ("lsd_sp_dat", 4 * sparse_budget),
        ]
    else:
        sections += [("lsd_crop", crop_bytes)]
    layout = {}
    off = 0
    for name, size in sections:
        layout[name] = (off, size)
        off += size
    layout["__total__"] = off
    return layout


def scales_scan_budget(brq_w: int) -> int:
    """Rows the bar scan can read below a text's bottom (scan budget plus
    the 4-px vertical-bar probe)."""
    return int((20.0 / 640.0) * brq_w + 0.5) + 4


def scalespack_layout(map_h: int, map_w: int) -> dict:
    """Sections of the lazily-fetched scales/OCR device buffer."""
    brq_h, brq_w = map_h // 2, map_w // 2
    scales_bytes = brq_h * ((brq_w + 7) // 8)
    ocr_bytes = brq_h * brq_w
    return {
        "scales_bits": (0, scales_bytes),
        "ocr_img": (scales_bytes, ocr_bytes),
        "__total__": scales_bytes + ocr_bytes,
    }
