"""On-device scale reading in PyTorch: glyph segmentation, template
classification and the scale-bar scan, as one part of the fused pass.

Port of smh_tpu/ops/scales_device.py. The device half reads the OCR text
mask and the scales binarize plane and emits the same fixed-shape i16
record vector: `scales_records` launches the hand-written CUDA kernel
csrc/scales_read.cu (one launch per call, a frame or a [B, H, W] batch,
a thread block cluster per frame)
for tensors on a CUDA device and runs `scales_records_plain` for tensors
on the CPU; there is no fallback from one to the other. The host half
(`decode_records`, `ratio_from_records`) and `device_templates` are
jax-free copies of the originals, pinned to them by the tests.

Translation notes for the plain version:
  * `vmap` over bands / glyph slots / word slots is a written-out leading
    batch dimension;
  * the `lax.scan` that groups glyphs into words is a Python loop over the
    MAX_GPB glyph slots on [MAX_BANDS] tensors;
  * `.at[].set/add(mode="drop")` scatters into one extra dump slot that is
    sliced away;
  * `jax.scipy.ndimage.map_coordinates(order=1, mode="nearest")` is a
    bilinear gather with clamped indices in JAX's own order of operations
    (`grid_sample` treats the edges differently);
  * dynamic slices are gathers at (start + iota), so nothing syncs the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ocr.engine import OCR_BINARY_THRESHOLD, OcrResult  # noqa: F401  (re-export)
from ..ocr.smhocr import FONTS

from .. import _build
from . import kernels
from .hsv import f32_scalar

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32

# Canonical glyph box (shared with ocr/smhocr.py).
GLYPH_W, GLYPH_H = 12, 16
CHARS = "0123456789m"

# Static record capacities.
MAX_BANDS = 6  # text-row bands in the BRQ
MAX_GPB = 16  # glyph column-runs per band
MAX_WPB = 4  # words per band
MAX_WG = 6  # glyphs per word ("10000m" = 6)
WIN_H = 64  # band slice height (>= MAX_GLYPH_H + slack)
WIN_W = 48  # glyph window width cap

MIN_GLYPH_PX = 8
MIN_GLYPH_H = 5
MAX_GLYPH_H = 48
MIN_CONFIDENCE = 0.55

MIN_SCALE_WIDTH = 10
BAR_H = 4  # MIN_SCALE_VERTICAL_BAR_HEIGHT

# Record layout (i16 lanes); see smh_tpu/ops/scales_device.py.
HDR_I16 = 8
FLAG_BAND_OVERFLOW = 1
WORD_I16 = 24
N_WORDS = MAX_BANDS * MAX_WPB
REC_I16 = HDR_I16 + N_WORDS * WORD_I16
REC_BYTES = REC_I16 * 2

# Capacities of the kernel's shared memory (csrc/scales_read.cu): the
# wrapper raises past them.
MAX_TEMPLATES = 32
MAX_DIM = 4096  # rows and columns of a plane
# The kernel's launch: a thread block cluster of CLUSTER blocks of THREADS
# threads per frame (one block per band, MAX_BANDS <= CLUSTER).
CLUSTER = 8
THREADS = 512


def score_lanes() -> np.ndarray:
    """bool [REC_I16]: the lanes holding glyph scores (x1000). Between
    devices they may differ by 1: the f32 template dot sums in another
    order. Every other lane is exact."""
    lanes = np.arange(REC_I16)
    in_word = (lanes - HDR_I16) % WORD_I16
    return (lanes >= HDR_I16) & (in_word >= 10 + MAX_WG) & (in_word < 10 + 2 * MAX_WG)


# ---------------------------------------------------------------------------
# Templates (the system's only parameters)
# ---------------------------------------------------------------------------


def _resample_np(window: np.ndarray) -> np.ndarray:
    """Numpy twin of the device glyph resample: bilinear sample of `window`
    (float [h, w]) onto the canonical GLYPH_H x GLYPH_W grid with edge
    clamping. Templates are built with THIS function."""
    from scipy import ndimage as ndi

    h, w = window.shape
    vi = (np.arange(GLYPH_H, dtype=np.float64) + 0.5) * (h / GLYPH_H) - 0.5
    uj = (np.arange(GLYPH_W, dtype=np.float64) + 0.5) * (w / GLYPH_W) - 0.5
    vv, uu = np.meshgrid(vi, uj, indexing="ij")
    return ndi.map_coordinates(
        window.astype(np.float64), [vv, uu], order=1, mode="nearest"
    ).astype(np.float32)


def _normalize_feat(arr: np.ndarray) -> np.ndarray:
    arr = arr - arr.mean()
    n = np.linalg.norm(arr)
    return arr / n if n > 1e-6 else arr


@functools.lru_cache(maxsize=1)
def device_templates() -> np.ndarray:
    """[T, GLYPH_H*GLYPH_W] f32 normalized templates (DejaVu digits + 'm',
    regular + bold), resampled by the numpy twin of the device operator.
    Row t classifies as CHARS[t % len(CHARS)]."""
    from PIL import Image, ImageDraw, ImageFont

    rows = []
    for path in FONTS:
        try:
            font = ImageFont.truetype(str(path), 32)
        except OSError:
            continue
        for ch in CHARS:
            img = Image.new("L", (64, 64), 0)
            ImageDraw.Draw(img).text((8, 8), ch, fill=255, font=font)
            arr = np.asarray(img)
            ys, xs = np.nonzero(arr > 64)
            if ys.size == 0:
                rows.append(np.zeros(GLYPH_H * GLYPH_W, np.float32))
                continue
            crop = arr[ys.min() : ys.max() + 1, xs.min() : xs.max() + 1]
            canon = _resample_np(crop.astype(np.float32) / 255.0)
            rows.append(_normalize_feat(canon).reshape(-1))
    if not rows:  # no fonts in the image: classification disabled
        rows = [np.zeros(GLYPH_H * GLYPH_W, np.float32)]
    return np.stack(rows)


def templates_to_device(np_templates: np.ndarray, device) -> torch.Tensor:
    """Carry the template matrix (f32 [T, 192], e.g. device_templates()) over
    to the port: one contiguous f32 tensor on `device`."""
    arr = np.ascontiguousarray(np_templates, dtype=np.float32)
    if arr.ndim != 2 or arr.shape[1] != GLYPH_H * GLYPH_W:
        raise ValueError(f"templates must be [T, {GLYPH_H * GLYPH_W}], got {arr.shape}")
    return torch.from_numpy(arr).to(device)


def scan_budget(brq_w: int) -> int:
    """Rows below a text bottom the bar scan examines: round-half-up of
    (20/640) * image_width."""
    return int((20.0 / 640.0) * brq_w + 0.5)


MAX_BUDGET = scan_budget(MAX_DIM)  # the most rows the kernel's bar scan reads below a word


# ---------------------------------------------------------------------------
# Device half
# ---------------------------------------------------------------------------


def _first_true(v: torch.Tensor) -> torch.Tensor:
    """Count of leading Falses along the last axis (== index of the first
    True; the axis length if none)."""
    n = v.shape[-1]
    if n == 0:
        return torch.zeros(v.shape[:-1], dtype=I64, device=v.device)
    first = v.to(torch.uint8).argmax(dim=-1)
    return torch.where(v.any(dim=-1), first, torch.full_like(first, n))


def _runs(mask: torch.Tensor, max_runs: int):
    """First `max_runs` True-runs along the last axis of a bool mask:
    (starts, ends_exclusive, count). Padded slots have start == n."""
    n = mask.shape[-1]
    dev = mask.device
    pad = torch.zeros((*mask.shape[:-1], 1), dtype=torch.bool, device=dev)
    prev = torch.cat([pad, mask[..., :-1]], dim=-1)
    nxt = torch.cat([mask[..., 1:], pad], dim=-1)
    is_start = mask & ~prev
    is_end = mask & ~nxt
    iota = torch.arange(n, dtype=I64, device=dev)
    rank = torch.cumsum(is_start.to(I64), dim=-1) - 1
    slots = torch.arange(max_runs, dtype=I64, device=dev)
    hit = rank[..., None, :] == slots[:, None]
    starts = ((is_start[..., None, :] & hit) * iota).sum(dim=-1)
    ends = ((is_end[..., None, :] & hit) * iota).sum(dim=-1)
    count = is_start.sum(dim=-1)
    occupied = slots < count[..., None]
    starts = torch.where(occupied, starts, n)
    ends = torch.where(occupied, ends, n) + 1
    return starts, ends, count


def _window(plane: torch.Tensor, r0: torch.Tensor, c0: torch.Tensor, hh: int, ww: int):
    """Batched dynamic slice plane[r0:r0+hh, c0:c0+ww] for [N] starts (in
    range by construction) -> [N, hh, ww], as one gather."""
    dev = plane.device
    rows = r0[:, None] + torch.arange(hh, dtype=I64, device=dev)
    cols = c0[:, None] + torch.arange(ww, dtype=I64, device=dev)
    return plane[rows[:, :, None], cols[:, None, :]]


def _map_coordinates_linear(win: torch.Tensor, vv: torch.Tensor, uu: torch.Tensor):
    """jax.scipy.ndimage.map_coordinates(win, [vv, uu], order=1,
    mode="nearest") batched over the leading axis, in JAX's order of
    operations: per corner (weight_v * weight_u) * value, summed in the
    product order (lower,lower), (lower,upper), (upper,lower), (upper,upper).

    win: f32 [N, H, W]; vv, uu: f32 [N, GH, GW] coordinates."""
    n, hh, ww = win.shape
    lower_v = torch.floor(vv)
    upper_wv = vv - lower_v
    lower_wv = 1 - upper_wv
    iv = lower_v.to(I64)
    lower_u = torch.floor(uu)
    upper_wu = uu - lower_u
    lower_wu = 1 - upper_wu
    iu = lower_u.to(I64)
    flat = win.reshape(n, hh * ww)
    out = None
    for ivk, wv in ((iv, lower_wv), (iv + 1, upper_wv)):
        ivc = ivk.clamp(0, hh - 1)
        for iuk, wu in ((iu, lower_wu), (iu + 1, upper_wu)):
            iuc = iuk.clamp(0, ww - 1)
            val = torch.gather(flat, 1, (ivc * ww + iuc).reshape(n, -1)).reshape(vv.shape)
            term = (wv * wu) * val
            out = term if out is None else out + term
    return out


def _classify_windows(text_pad, by0s, bhs, gx0s, gws, valids, templates):
    """Glyph feature extraction for every glyph slot + one matmul against
    the templates. Returns (char_idx, score, gy0, gy1, count, ok), each [G]."""
    dev = text_pad.device
    win = _window(text_pad, by0s, gx0s, WIN_H, WIN_W)  # [G, WIN_H, WIN_W]
    rmask = torch.arange(WIN_H, dtype=I64, device=dev)[None, :] < bhs[:, None]
    cmask = torch.arange(WIN_W, dtype=I64, device=dev)[None, :] < gws[:, None]
    win = win & rmask[:, :, None] & cmask[:, None, :]
    rowany = win.any(dim=2)
    gy0 = _first_true(rowany)
    gy1 = WIN_H - _first_true(rowany.flip(-1))
    h = gy1 - gy0
    count = win.sum(dim=(1, 2))
    ok = (
        valids
        & (count >= MIN_GLYPH_PX)
        & (h >= MIN_GLYPH_H)
        & (h <= MAX_GLYPH_H)
        & (gws <= MAX_GLYPH_H)
    )
    # Canonical resample (device half of the _resample_np twin).
    fh = h.to(F32)
    fw = gws.to(F32)
    k_gh = f32_scalar(GLYPH_H, dev)
    k_gw = f32_scalar(GLYPH_W, dev)
    ar_h = torch.arange(GLYPH_H, dtype=F32, device=dev) + 0.5
    ar_w = torch.arange(GLYPH_W, dtype=F32, device=dev) + 0.5
    vi = gy0.to(F32)[:, None] + ar_h[None, :] * (fh / k_gh)[:, None] - 0.5
    uj = ar_w[None, :] * (fw / k_gw)[:, None] - 0.5
    g = win.shape[0]
    vv = vi[:, :, None].expand(g, GLYPH_H, GLYPH_W)
    uu = uj[:, None, :].expand(g, GLYPH_H, GLYPH_W)
    canon = _map_coordinates_linear(win.to(F32), vv, uu).reshape(g, -1)
    k_n = f32_scalar(GLYPH_H * GLYPH_W, dev)
    feat = canon - (canon.sum(dim=1) / k_n)[:, None]
    norm = torch.sqrt((feat * feat).sum(dim=1))
    safe = torch.where(norm > 1e-6, norm, torch.ones_like(norm))
    feat = torch.where((norm > 1e-6)[:, None], feat / safe[:, None], torch.zeros_like(feat))
    scores = feat @ templates.T  # [G, T]
    return scores.argmax(dim=1), scores.amax(dim=1), gy0, gy1, count, ok


def scales_records_plain(text: torch.Tensor, sbool: torch.Tensor, templates: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the scales read kernel -> i16 [REC_I16] record
    vector ([B, REC_I16] for [B, H, W] planes, frame by frame).

    text:  bool [H, W] OCR text mask (ocr_img < OCR_BINARY_THRESHOLD).
    sbool: bool [H, W] scales binarize plane (True = non-black).
    templates: f32 [T, 192] from templates_to_device(device_templates(), dev).
    """
    if text.dim() == 3:
        return torch.stack([scales_records_plain(t, s, templates) for t, s in zip(text, sbool)])
    h, w = text.shape
    dev = text.device
    text_pad = torch.zeros((h + WIN_H, w + WIN_W), dtype=torch.bool, device=dev)
    text_pad[:h, :w] = text

    rowany = text.any(dim=1)
    b_starts, b_ends, n_bands = _runs(rowany, MAX_BANDS)
    flags = torch.where(n_bands > MAX_BANDS, FLAG_BAND_OVERFLOW, 0)

    # Per-band glyph column runs ([MAX_BANDS] leading axis).
    band_ids = torch.arange(MAX_BANDS, dtype=I64, device=dev)
    by0_b = b_starts.clamp(max=h)  # padded slot -> degenerate band
    by1_b = b_ends.clamp(max=h)
    bh_full = (by1_b - by0_b).clamp(min=0)
    band_valid = band_ids < n_bands
    band = _window(text_pad, by0_b, torch.zeros_like(by0_b), WIN_H, w)
    band = band & (torch.arange(WIN_H, dtype=I64, device=dev)[None, :] < bh_full[:, None])[:, :, None]
    colany = band.any(dim=1)  # [MAX_BANDS, w]
    g_starts, g_ends, n_g = _runs(colany, MAX_GPB)
    band_bad = band_valid & ((bh_full > WIN_H) | (n_g > MAX_GPB))
    gx0_bg = g_starts.clamp(max=w)
    gw_bg = (g_ends.clamp(max=w) - gx0_bg).clamp(min=0)
    slot_ids = torch.arange(MAX_GPB, dtype=I64, device=dev)
    valid_bg = band_valid[:, None] & (slot_ids[None, :] < n_g[:, None])
    bh_b = bh_full.clamp(max=WIN_H)

    by0s = by0_b.repeat_interleave(MAX_GPB)
    bhs = bh_b.repeat_interleave(MAX_GPB)
    gx0s = gx0_bg.reshape(-1)
    gws = gw_bg.reshape(-1)
    valids = valid_bg.reshape(-1)
    bands = band_ids.repeat_interleave(MAX_GPB)

    chars, scores, gy0s, gy1s, _counts, oks = _classify_windows(
        text_pad, by0s, bhs, gx0s, gws, valids, templates
    )
    ay0 = by0s + gy0s  # absolute glyph bbox
    ay1 = by0s + gy1s
    ax0 = gx0s
    ax1 = gx0s + gws
    heights = ay1 - ay0

    # Word grouping per band: x-ordered surviving glyphs chain into the same
    # word while the horizontal gap stays within max(4, 0.9*min_h) and the
    # vertical overlap exceeds half the smaller height (ocr/smhocr.py).
    alive_all = oks.reshape(MAX_BANDS, MAX_GPB)
    x0_all = ax0.reshape(MAX_BANDS, MAX_GPB)
    x1_all = ax1.reshape(MAX_BANDS, MAX_GPB)
    y0_all = ay0.reshape(MAX_BANDS, MAX_GPB)
    y1_all = ay1.reshape(MAX_BANDS, MAX_GPB)
    hh_all = heights.reshape(MAX_BANDS, MAX_GPB)
    zero = torch.zeros(MAX_BANDS, dtype=I64, device=dev)
    wid = zero - 1
    has_prev = torch.zeros(MAX_BANDS, dtype=torch.bool, device=dev)
    px1, py0, py1, ph = zero, zero, zero, zero
    word_cols = []
    for j in range(MAX_GPB):
        alive = alive_all[:, j]
        x0, x1, y0, y1, hh = x0_all[:, j], x1_all[:, j], y0_all[:, j], y1_all[:, j], hh_all[:, j]
        gap = x0 - px1
        v_overlap = torch.minimum(y1, py1) - torch.maximum(y0, py0)
        min_h = torch.minimum(hh, ph)
        gap_max = torch.clamp((9 * min_h) // 10, min=4)
        same = has_prev & (v_overlap > min_h // 2) & (gap >= -2) & (gap <= gap_max)
        new_wid = torch.where(same, wid, wid + 1)
        word_cols.append(torch.where(alive, new_wid, torch.full_like(new_wid, -1)))
        wid = torch.where(alive, new_wid, wid)
        has_prev = has_prev | alive
        px1 = torch.where(alive, x1, px1)
        py0 = torch.where(alive, y0, py0)
        py1 = torch.where(alive, y1, py1)
        ph = torch.where(alive, hh, ph)
    word_of = torch.stack(word_cols, dim=1).reshape(-1)
    words_in_band = wid + 1
    band_bad = band_bad | (words_in_band > MAX_WPB)

    # Scatter glyphs into word slots (invalid -> the dump slot N_WORDS).
    slot_b = bands * MAX_WPB + word_of.clamp(0, MAX_WPB - 1)
    slot = torch.where((word_of >= 0) & (word_of < MAX_WPB), slot_b, N_WORDS)
    ginband = torch.arange(MAX_BANDS * MAX_GPB, dtype=I64, device=dev) % MAX_GPB
    same_slot = (slot[None, :] == slot[:, None]) & (ginband[None, :] < ginband[:, None])
    pos = same_slot.sum(dim=1)
    over = pos >= MAX_WG
    # A word that hit the glyph cap lost a SUFFIX of its glyphs: it carries a
    # truncated flag and the host never trusts it.
    trunc_idx = torch.where((slot < N_WORDS) & over, slot, N_WORDS)
    w_trunc = (
        torch.zeros(N_WORDS + 1, dtype=I64, device=dev)
        .index_add_(0, trunc_idx, torch.ones_like(trunc_idx))[:N_WORDS]
        > 0
    ).to(I64)
    drop = torch.where((slot < N_WORDS) & ~over, slot, N_WORDS)
    pos_c = pos.clamp(max=MAX_WG - 1)

    def scat(vals: torch.Tensor, fill: int) -> torch.Tensor:
        buf = torch.full((N_WORDS + 1, MAX_WG), fill, dtype=I64, device=dev)
        buf[drop, pos_c] = vals.to(I64)
        return buf[:N_WORDS]

    w_chars = scat(chars, -1)
    w_scores = scat((scores * 1000.0).to(I32), 0)
    w_n = scat(torch.ones_like(slot), 0).sum(dim=1)
    big = 1 << 14
    w_x0 = scat(ax0, big).amin(dim=1)
    w_y0 = scat(ay0, big).amin(dim=1)
    w_x1 = scat(ax1, 0).amax(dim=1)
    w_y1 = scat(ay1, 0).amax(dim=1)

    # Speculative bar scan for every word slot (src/vision/mpx_ratio.rs
    # semantics incl. the right-1/left+1 steps and the ==0 sentinel quirks).
    budget = scan_budget(w)
    black = ~sbool
    bar_black = black.clone()
    for k in range(1, BAR_H):
        shifted = torch.zeros_like(black)
        shifted[: h - k] = black[k:]
        bar_black = bar_black & shifted
    riota = torch.arange(h, dtype=I64, device=dev)
    bar_black = bar_black & (riota <= h - BAR_H)[:, None]
    ciota = torch.arange(w, dtype=I64, device=dev)

    x = (w_x0 + w_x1) // 2  # [N_WORDS]
    ys = w_y1[:, None] + torch.arange(budget, dtype=I64, device=dev)[None, :]
    ys_c = ys.clamp(0, h - 1)
    bb = bar_black[ys_c]  # [N_WORDS, budget, w]
    # Empty word slots put x out of range; their scan is masked below, so
    # the clamp only keeps the gather in bounds.
    anchor_black = black[ys_c, x.clamp(0, w - 1)[:, None]]
    right_cand = torch.where(bb & (ciota >= x[:, None, None]), ciota, w)
    rx = right_cand.amin(dim=2)
    left_cand = torch.where(bb & (ciota < x[:, None, None]), ciota, -1)
    lx = left_cand.amax(dim=2)
    right = rx - 1
    left = lx + 1
    width = right - left
    okrow = (
        (ys < h)
        & anchor_black
        & (rx < w)
        & (rx != 0)  # reference sentinel: a bar at column 0 reads as miss
        & (lx >= 0)
        & (lx != 0)  # same sentinel on the left walk
        & (width >= MIN_SCALE_WIDTH)
    )
    kk = _first_true(okrow)
    bar_found = (kk < budget) & (w_n > 0) & (w_y1 >= BAR_H)
    k_c = kk.clamp(0, max(budget - 1, 0))[:, None]
    if budget == 0:  # plane too narrow to scan: nothing found, gather from a dummy row
        ys = left = right = torch.zeros((N_WORDS, 1), dtype=I64, device=dev)
    bar_y = torch.where(bar_found, ys.gather(1, k_c)[:, 0], 0)
    bar_l = torch.where(bar_found, left.gather(1, k_c)[:, 0], 0)
    bar_r = torch.where(bar_found, right.gather(1, k_c)[:, 0], 0)

    band_bits = (band_bad.to(I64) * (torch.ones_like(band_ids) << band_ids)).sum()
    # Assembled from device scalars: assigning a Python int into a CUDA
    # tensor is a pageable host copy, which synchronises the stream.
    zero = torch.zeros_like(n_bands)
    hdr = torch.stack(
        [n_bands.clamp(max=MAX_BANDS), flags, torch.full_like(n_bands, templates.shape[0]), band_bits]
        + [zero] * (HDR_I16 - 4)
    )
    has = w_n > 0
    word_rec = torch.cat(
        [
            w_n[:, None],
            torch.where(has, w_x0, 0)[:, None],
            torch.where(has, w_y0, 0)[:, None],
            w_x1[:, None],
            w_y1[:, None],
            bar_found.to(I64)[:, None],
            bar_y[:, None],
            bar_l[:, None],
            bar_r[:, None],
            w_trunc[:, None],
            w_chars,
            w_scores.clamp(-(1 << 14), 1 << 14),
            torch.zeros((N_WORDS, WORD_I16 - 10 - 2 * MAX_WG), dtype=I64, device=dev),
        ],
        dim=1,
    )
    rec = torch.cat([hdr, word_rec.reshape(-1)])
    return rec.to(torch.int16)


def scales_records(text: torch.Tensor, sbool: torch.Tensor, templates: torch.Tensor) -> torch.Tensor:
    """The device scales read -> i16 [REC_I16] record vector, or i16
    [B, REC_I16] for [B, H, W] planes in ONE launch (a cluster of CLUSTER
    blocks per frame).

    text, sbool: bool or u8 (nonzero = True) [H, W] or [B, H, W] planes of
    one shape and device; each frame contiguous, the frames any stride(0)
    >= H * W elements apart (the batched pass's rows). templates: f32
    [T, 192] on the same device, T <= MAX_TEMPLATES. On the CPU the plain
    version runs; on a CUDA device the kernel launches (LAUNCHES
    "scales_read" counts it); anything else raises."""
    for name, t in (("text", text), ("sbool", sbool)):
        if t.dtype not in (torch.bool, torch.uint8) or t.dim() not in (2, 3):
            raise ValueError(f"{name} must be a bool or u8 [H, W] or [B, H, W] plane, got {t.dtype} {tuple(t.shape)}")
    if sbool.shape != text.shape or sbool.device != text.device or templates.device != text.device:
        raise ValueError("text, sbool and templates differ in shape or device")
    if templates.dtype != F32 or templates.dim() != 2 or templates.shape[1] != GLYPH_H * GLYPH_W:
        raise ValueError(f"templates must be f32 [T, {GLYPH_H * GLYPH_W}], got {templates.dtype} {tuple(templates.shape)}")
    if not 1 <= templates.shape[0] <= MAX_TEMPLATES:
        raise ValueError(f"{templates.shape[0]} templates: the kernel holds 1 to {MAX_TEMPLATES}")
    if text.numel() == 0:
        raise ValueError(f"empty planes {tuple(text.shape)}")
    device = text.device
    if device.type == "cpu":
        return scales_records_plain(text.bool(), sbool.bool(), templates)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    h, w = text.shape[-2:]
    if h > MAX_DIM or w > MAX_DIM:
        raise ValueError(f"planes of {h}x{w}: the kernel takes at most {MAX_DIM} rows and columns")
    if not templates.is_contiguous() or templates.data_ptr() % 16:
        raise ValueError("the kernel reads contiguous templates from a 16-byte aligned address")
    bsz = text.shape[0] if text.dim() == 3 else 1
    out = torch.empty((bsz, REC_I16), dtype=torch.int16, device=device)
    lib = _build.load()
    with torch.cuda.device(device):
        code = lib.smh_scales_read(
            text.data_ptr(), kernels._frame_stride((text,)), sbool.data_ptr(), kernels._frame_stride((sbool,)),
            templates.data_ptr(), templates.shape[0], h, w, bsz, scan_budget(w), out.data_ptr(),
            kernels._stream_ptr(text),
        )
    _build.check(code, "smh_scales_read")
    kernels.LAUNCHES["scales_read"] += 1
    return out if text.dim() == 3 else out[0]


# ---------------------------------------------------------------------------
# Host-side decode (jax-free copies of smh_tpu/ops/scales_device.py)
# ---------------------------------------------------------------------------


class DeviceScales:
    """Decoded record buffer: OcrResult-compatible words + per-word bar scans.

    `complete` means the device saw the whole plane with no capacity loss;
    when False, `trusted[i]` still marks the words whose band was clean and
    whose glyphs were not truncated — those reads are exact."""

    __slots__ = (
        "complete", "words", "bars", "trusted", "n_bands", "flags",
        "band_bits", "_ratio_memo",
    )

    def __init__(self, complete, words, bars, trusted, n_bands, flags, band_bits):
        self.complete = complete
        self.words = words  # list[OcrResult]
        self.bars = bars  # per word: None | (y, left, right)
        self.trusted = trusted  # per word: band clean & not truncated
        self.n_bands = n_bands
        self.flags = flags
        self.band_bits = band_bits
        self._ratio_memo = ()  # unset sentinel (None is a valid ratio)

    @property
    def ok(self) -> bool:
        return self.complete


def decode_records(rec_i16: np.ndarray) -> DeviceScales:
    """Parse the i16 record vector (already byte-order native)."""
    hdr = rec_i16[:HDR_I16]
    n_bands = int(hdr[0])
    flags = int(hdr[1])
    band_bits = int(hdr[3])
    complete = flags == 0 and band_bits == 0
    words: list = []
    bars: list = []
    trusted: list = []
    recs = rec_i16[HDR_I16:].reshape(N_WORDS, WORD_I16)
    for slot_idx, r in enumerate(recs):
        n = int(r[0])
        if n <= 0:
            continue
        chars = r[10 : 10 + MAX_WG]
        scores = r[10 + MAX_WG : 10 + 2 * MAX_WG].astype(np.float32) / 1000.0
        text = ""
        ss = []
        for i in range(min(n, MAX_WG)):
            idx = int(chars[i])
            sc = float(scores[i])
            ch = CHARS[idx % len(CHARS)] if idx >= 0 else "?"
            text += ch if sc >= MIN_CONFIDENCE else "?"
            ss.append(max(sc, 0.0))
        words.append(
            OcrResult(
                text=text,
                confidence=float(np.mean(ss)) * 100.0 if ss else 0.0,
                left=int(r[1]),
                top=int(r[2]),
                right=int(r[3]),
                bottom=int(r[4]),
            )
        )
        bars.append((int(r[6]), int(r[7]), int(r[8])) if int(r[5]) else None)
        band = slot_idx // MAX_WPB
        trusted.append(not (band_bits >> band) & 1 and not int(r[9]))
    return DeviceScales(complete, words, bars, trusted, n_bands, flags, band_bits)


def ratio_from_records(dev: DeviceScales) -> "float | None":
    """meters/px from the TRUSTED decoded records: the first <=3 distinct
    "<N>m" scales in band-major record-slot order, averaged over those whose
    bar scan found a bar. Memoized per record object."""
    if dev._ratio_memo != ():
        return dev._ratio_memo[0]
    scales = []
    seen = set()
    for word, bar, trust in zip(dev.words, dev.bars, dev.trusted):
        if not trust:
            continue
        m = word.text.rfind("m")
        if m < 0:
            continue
        prefix = word.text[:m]
        if not prefix.isdigit():
            continue
        meters = int(prefix)
        if meters == 0 or meters in seen:
            continue
        seen.add(meters)
        scales.append((meters, bar))
        if len(scales) == 3:
            break
    found = []
    for meters, bar in scales:
        if bar is None:
            continue
        _y, left, right = bar
        width = right - left
        if width >= MIN_SCALE_WIDTH:
            found.append(meters / width)
    ratio = sum(found) / len(found) if found else None
    dev._ratio_memo = (ratio,)
    return ratio
