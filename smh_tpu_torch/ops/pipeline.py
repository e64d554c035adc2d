"""The fused per-frame pass in PyTorch.

Port of smh_tpu/ops/pipeline.py (the `channels=3` plane-major flat upload;
the LSD mask as a window crop, the full plane or sparse words; the scales
transports "none", "device", "binary" and "gray", the last two whole or as
a row band). One call of `analyze_packed_flat` runs the whole device half of
a frame: marker classify + luma (CUDA kernel 1), the L1 dilate, the dilated
mask's bit plane (CUDA kernel 3), the OCR preprocess and scales binarize of
the map's bottom-right quadrant, the minimap rect (CUDA kernel 2), the red
gate, the on-device scales read, the mask bbox, the window crop or sparse
word compaction and the checksums — all packed into ONE u8 hostpack whose
bytes equal the JAX package's hostpack. `analyze_delta_flat` first rebuilds
the frame from a device-resident buffer and the changed 32 B chunks (the
delta upload). `analyze_map_planar` is the debug re-pass, which also keeps
the isolated marker pixels and the cropped quadrant.

The window and band origins are device scalars: both are cut by a gather at
origin + iota (scales_device._window), never by slicing at a host int.

On a CUDA tensor the three kernels launch; on a CPU tensor their plain twins
run (ops/kernels.py). Nothing here reads a tensor's value on the host or
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

from smh_tpu import consts as C
from smh_tpu.ocr.engine import OCR_BINARY_THRESHOLD

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
    """Cross-shaped (L1 r=1) binary dilation via shifted ORs."""
    out = m.clone()
    out[1:, :] |= m[:-1, :]
    out[:-1, :] |= m[1:, :]
    out[:, 1:] |= m[:, :-1]
    out[:, :-1] |= m[:, 1:]
    return out


def _box_dilate_bool(m: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1)^2 separable box dilation with edge clamping."""
    out = m
    for axis in (0, 1):
        acc = out.clone()
        for d in range(1, radius + 1):
            if axis == 0:
                acc[d:, :] |= out[:-d, :]
                acc[:-d, :] |= out[d:, :]
            else:
                acc[:, d:] |= out[:, :-d]
                acc[:, :-d] |= out[:, d:]
        out = acc
    return out


def pack_bits(mask_bool: torch.Tensor) -> torch.Tensor:
    """bool [h, w] -> u8 [h, ceil(w/8)], MSB first (np.unpackbits order)."""
    h, w = mask_bool.shape
    w8 = ((w + 7) // 8) * 8
    padded = torch.zeros((h, w8), dtype=torch.uint8, device=mask_bool.device)
    padded[:, :w] = mask_bool
    shifts = 7 - torch.arange(8, dtype=I32, device=mask_bool.device)
    weights = torch.ones_like(shifts) << shifts  # 128 .. 1
    return (padded.view(h, w8 // 8, 8).to(I32) * weights).sum(dim=2).to(torch.uint8)


def _pack_words32(mask_bool: torch.Tensor) -> torch.Tensor:
    """bool [h, w] -> flat u32 word plane (as int64 values < 2^32): word j of
    row i covers pixels [32j, 32j+32), laid out so the host byte view of each
    little-endian u32 reproduces pack_bits' MSB-first bytes (pixel p -> byte
    lane p//8 % 4, bit 7 - p%8)."""
    h, w = mask_bool.shape
    w32 = ((w + 31) // 32) * 32
    padded = torch.zeros((h, w32), dtype=torch.bool, device=mask_bool.device)
    padded[:, :w] = mask_bool
    p = torch.arange(32, dtype=I64, device=mask_bool.device)
    weights = torch.ones_like(p) << (8 * (p // 8) + (7 - p % 8))
    return (padded.view(h, w32 // 32, 32).to(I64) * weights).sum(dim=2).reshape(-1)


def _compact_words(words: torch.Tensor, budget: int):
    """First `budget` nonzero words of a flat word plane: (nz = TOTAL nonzero
    count, idx [budget], dat [budget]); slots past min(nz, budget) are zero.
    Binary search of each output rank over the inclusive prefix count (the
    JAX "search" engine): static shapes, no nonzero(), no host sync."""
    nzmask = words != 0
    count = torch.cumsum(nzmask.to(I64), dim=0)  # inclusive: rank+1 at hits
    nz = count[-1]
    ranks = torch.arange(1, budget + 1, dtype=I64, device=words.device)
    found = torch.searchsorted(count, ranks, side="left")
    valid = torch.arange(budget, dtype=I64, device=words.device) < torch.clamp(nz, max=budget)
    src = torch.where(valid, torch.clamp(found, max=words.numel() - 1), 0)
    dat = torch.where(valid, words[src], 0)
    return nz, src, dat  # src doubles as idx (0 in invalid slots)


def _sparse_words(mask_bool: torch.Tensor, budget: int):
    """Compact the nonzero u32 words of a bool [h, w] mask plane. Word
    indices are in the padded grid (sparse_word_pad bytes per row)."""
    return _compact_words(_pack_words32(mask_bool), budget)


def _mask_bbox(m: torch.Tensor):
    """Bounding box (y0, y1, x0, x1) of True pixels, end-exclusive.
    Empty mask -> y0 == h, y1 == 0."""
    rowany = m.any(dim=1)
    colany = m.any(dim=0)
    h, w = m.shape
    y0 = sd._first_true(rowany)
    y1 = h - sd._first_true(rowany.flip(0))
    x0 = sd._first_true(colany)
    x1 = w - sd._first_true(colany.flip(0))
    return y0, y1, x0, x1


def _weighted_check(plane: torch.Tensor) -> torch.Tensor:
    """[2] u32 content checksum (sum + position-weighted sum) of a 2D plane,
    as int64 values < 2^32 (uint32 wraparound done in int64, masked)."""
    p = plane.to(I64)
    h, w = p.shape
    rows = torch.arange(1, h + 1, dtype=I64, device=p.device)
    cols = torch.arange(7, w + 7, dtype=I64, device=p.device)
    weighted = ((p * rows[:, None]) * cols[None, :]).sum()
    return torch.stack([p.sum(), weighted]) & U32_MASK


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """Little-endian byte view of a tensor (the JAX bitcast_convert_type)."""
    return t.contiguous().view(torch.uint8).reshape(-1)


def _u32_bytes(v: torch.Tensor) -> torch.Tensor:
    """Bytes of int64 values < 2^32 as little-endian u32 (the low 4 bytes)."""
    return v.contiguous().view(torch.uint8).reshape(-1, 8)[:, :4].reshape(-1)


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
    vectors [..., n] (shared by the plain path and the quiet-walk kernel's
    tail) -> i32 [..., 4]."""
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


def _ocr_preprocess_planes(r8, g8, b8, luma=None) -> torch.Tensor:
    """Whiteish-text isolation of u8 planes (oracle: pixmath.ocr_preprocess).
    `luma` may pass the planes' Rec.709 luma when it is already computed."""
    h, w = r8.shape
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
    clipped[:, max(w - R + 1, 0) :] = False
    clipped[max(h - R + 1, 0) :, :] = False
    near_strict = _box_dilate_bool(clipped, R)

    keep = strict | (edge_cand & near_strict)
    if luma is None:
        luma = hsv.luma8_planes(r8, g8, b8)
    return torch.where(keep, 255 - luma, torch.full_like(luma, 255))


def _red_gate_roi(btn: torch.Tensor) -> torch.Tensor:
    """btn: interleaved BGR u8 [bh, bw, 3] close-button ROI -> f32 red
    fraction (0-dim)."""
    bh, bw = btn.shape[:2]
    ok = torch.ones((bh, bw), dtype=torch.bool, device=btn.device)
    for i, c in enumerate(C.CLOSE_DEPLOYMENT_BUTTON_COLOR):  # R, G, B
        chan = btn[..., 2 - i].to(torch.int16)
        ok = ok & ((int(c) - chan).abs() <= C.CLOSE_DEPLOYMENT_BUTTON_TOLERANCE)
    # XLA lowers the JAX package's `count / n` to count * (1/n) (docs/DESIGN.md
    # §4); the same rounding keeps the hostpack bytes equal.
    recip = hsv.f32_scalar(1.0, btn.device) / hsv.f32_scalar(bh * bw, btn.device)
    return ok.sum().to(F32) * recip


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
    """The fused pass over the map ROI as BGR channel planes ([h, w] each).
    with_isolated adds the debug views' planes: the map with non-marker
    pixels black and the bottom-right quadrant, both interleaved RGB."""
    map_h, map_w = b8.shape
    marker_u8, luma = kernels.classify_luma_planes(r8, g8, b8)
    marker = marker_u8 != 0

    # ui_map: grayscale travels as the luma plane; colour re-interleaves.
    ui = luma if grayscale else torch.stack([r8, g8, b8], dim=-1)
    ui_flat = luma if grayscale else r8.to(I32) + g8.to(I32) + b8.to(I32)

    # lsd_bool feeds the bbox and the sparse words; the bit plane comes from
    # the fused mask kernel (the same bytes as pack_bits(lsd_bool)).
    lsd_bool = _dilate_l1_radius1_bool(marker)
    out = {
        "ui": ui,
        "ui_check": _weighted_check(ui_flat),
        "lsd_bool": lsd_bool,
        "lsd_bits": kernels.fused_mask_bits(r8, g8, b8),
    }
    if with_ocr:
        brq_h, brq_w = map_h // 2, map_w // 2

        def brq(p):
            return p[brq_h : brq_h + brq_h, brq_w : brq_w + brq_w]

        brq_luma = brq(luma)
        scales_bool = brq_luma != 0
        out["ocr_img"] = _ocr_preprocess_planes(brq(r8), brq(g8), brq(b8), luma=brq_luma)
        out["scales_bool"] = scales_bool
        out["scales_bits"] = pack_bits(scales_bool)
    if with_quiet:
        out["minimap_rect"] = kernels.minimap_rect_planes(b8[None], g8[None], r8[None])[0]
    if with_isolated:
        brq_h, brq_w = map_h // 2, map_w // 2
        rgb = torch.stack([r8, g8, b8], dim=-1)
        out["isolated_map"] = torch.where(marker[..., None], rgb, torch.zeros_like(rgb))
        out["cropped_brq"] = rgb[brq_h : brq_h + brq_h, brq_w : brq_w + brq_w]
    return out


def _row_band(plane: torch.Tensor, r0: torch.Tensor, rows: int) -> torch.Tensor:
    """plane[r0 : r0 + rows] for a device-scalar r0 (in range by
    construction), as a gather: no host sync."""
    zero = torch.zeros_like(r0)
    return sd._window(plane, r0.reshape(1), zero.reshape(1), rows, plane.shape[1])[0]


def _pack_outputs(
    out: dict,
    red: torch.Tensor,
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
    hostpack_layout with the same flags)."""
    lsd_bool = out["lsd_bool"]
    map_h, map_w = lsd_bool.shape
    crop_h = map_h if crop_h is None else crop_h
    crop_w = map_w if crop_w is None else crop_w
    y0, y1, x0, x1 = _mask_bbox(lsd_bool)
    if sparse_budget is not None or (crop_h, crop_w) == (map_h, map_w):
        # Sparse words or the full plane: the crop origin is the plane
        # origin, and the full plane's bits are kernel 3's.
        cy0 = cx0 = torch.zeros((), dtype=I64, device=lsd_bool.device)
        crop_bits = out["lsd_bits"]
    else:
        # Window crop at the bbox less the margin, clamped into the plane.
        # The origin is a device scalar and not byte aligned, so the window
        # is gathered from the bool plane and packed afresh.
        margin = int(LSD_CROP_MARGIN)
        cy0 = torch.clamp(y0 - margin, 0, map_h - crop_h)
        cx0 = torch.clamp(x0 - margin, 0, map_w - crop_w)
        crop_bits = pack_bits(sd._window(lsd_bool, cy0.reshape(1), cx0.reshape(1), crop_h, crop_w)[0])
    meta = torch.stack([y0, y1, x0, x1, cy0, cx0]).to(I32)
    parts = [_bytes(red.reshape(1)), _u32_bytes(out["ui_check"]), _bytes(meta)]
    banded = with_ocr and scales_inline in ("binary", "gray") and scales_band is not None
    if with_ocr:
        scheck = torch.cat([_weighted_check(out["scales_bits"]), _weighted_check(out["ocr_img"])])
        parts.append(_u32_bytes(scheck))
        keep = out["ocr_img"] < OCR_BINARY_THRESHOLD  # the text mask
        if banded:
            # OCR text-row band: every text pixel lies in the keep mask's row
            # bbox and the bar scan reads at most scales_scan_budget rows
            # below it, so a band anchored at the bbox is read-complete.
            brq_h = keep.shape[0]
            krows = keep.any(dim=1)
            oy0 = sd._first_true(krows)
            oy1 = brq_h - sd._first_true(krows.flip(0))
            b0 = torch.clamp(oy0, 0, brq_h - scales_band)
            parts.append(_bytes(torch.stack([oy0, oy1, b0]).to(I32)))
            parts.append(_row_band(out["scales_bits"], b0, scales_band).reshape(-1))
            if scales_inline == "binary":
                parts.append(_row_band(pack_bits(keep), b0, scales_band).reshape(-1))
            else:
                parts.append(_row_band(out["ocr_img"], b0, scales_band).reshape(-1))
        elif scales_inline == "binary":
            parts += [out["scales_bits"].reshape(-1), pack_bits(keep).reshape(-1)]
        elif scales_inline == "gray":
            parts += [out["scales_bits"].reshape(-1), out["ocr_img"].reshape(-1)]
        elif scales_inline == "device":
            if templates is None:
                raise ValueError('scales_inline="device" needs the template tensor')
            rec = sd.scales_records(keep, out["scales_bool"], templates)
            parts.append(_bytes(rec))
        elif scales_inline != "none":
            raise ValueError(f"unsupported scales_inline {scales_inline!r}")
    if with_quiet:
        parts.append(_bytes(out["minimap_rect"]))
    if sparse_budget is not None:
        nz, sp_idx, sp_dat = _sparse_words(lsd_bool, sparse_budget)
        parts += [_bytes(nz.to(I32).reshape(1)), _bytes(sp_idx.to(I32)), _u32_bytes(sp_dat)]
    else:
        parts.append(crop_bits.reshape(-1))
    res = {
        "hostpack": torch.cat(parts),
        "ui": out["ui"],
        "lsd_bits": out["lsd_bits"],  # full mask: the window/sparse-miss fallback
    }
    if with_ocr and (scales_inline in ("none", "device") or banded):
        # The lazy transport's payload, and the fallback of the band (a miss)
        # and of the device read (overflow with nothing trusted).
        res["scalespack"] = torch.cat([out["scales_bits"].reshape(-1), out["ocr_img"].reshape(-1)])
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
        out, _red_gate_roi(btn), with_ocr, with_quiet, scales_inline,
        sparse_budget=sparse_budget, templates=templates, crop_h=crop_h,
        crop_w=crop_w, scales_band=scales_band,
    )


def analyze_delta_flat(
    resident: torch.Tensor, buf: torch.Tensor, bucket: int, chunk: int, **kw
) -> dict:
    """The delta-upload dispatch: `resident` is the previous frame's flat
    buffer on the device, `buf` the upload — `bucket` int32 chunk indices
    then `bucket` chunks of `chunk` bytes. The new frame is scattered into
    a FRESH buffer (clone, then `index_copy_`): a consume view of the
    previous frame may still re-dispatch from `resident`, so it is never
    written in place. Index padding repeats a real index with identical
    data, so the duplicate writes leave one deterministic result. Returns
    analyze_packed_flat's outputs (`kw` are its flags) plus "resident", the
    new buffer. The JAX counterpart is
    smh_tpu.ops.pipeline._analyze_delta_flat(..., channels=3)."""
    if buf.dtype != torch.uint8 or buf.numel() != bucket * (4 + chunk):
        raise ValueError(f"delta buffer of {buf.numel()} bytes does not hold {bucket} chunks of {chunk}")
    idx = buf[: 4 * bucket].view(I32).to(I64)
    data = buf[4 * bucket :].view(bucket, chunk)
    rois = resident.clone()
    rois.view(-1, chunk).index_copy_(0, idx, data)
    out = analyze_packed_flat(rois, **kw)
    out["resident"] = rois
    return out


def analyze_map_planar(planes: torch.Tensor, grayscale: bool = True, with_isolated: bool = False) -> dict:
    """The fused pass over a plane-major BGR u8 [3, h, w] map ROI (the
    resident layout): the debug re-pass reads the resident buffer with no
    layout copy. The JAX counterpart is smh_tpu.ops.pipeline.analyze_map_planar."""
    return _analyze_map_planes(
        planes[0], planes[1], planes[2], grayscale, with_quiet=False, with_isolated=with_isolated,
    )


def unpack_bits_device(packed: torch.Tensor, w: int) -> torch.Tensor:
    """Device-side inverse of pack_bits -> 0/255 u8 [h, w]: the u8 mask the
    device ray march samples, rebuilt from the bit plane."""
    h, row = packed.shape
    shifts = 7 - torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, :, None] >> shifts) & 1
    return bits.reshape(h, row * 8)[:, :w] * 255


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
