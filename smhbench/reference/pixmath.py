"""Exact-semantics pixel math shared by the numpy oracle backend.

Every function here is written to reproduce the reference CPU backend's
arithmetic bit-for-bit (float32 order-of-operations, truncating casts),
because upstream's vision-cpu backend is the oracle.

Parity citations:
  * RGB -> HSV:            upstream util/src/image.rs:159-202
  * luma (Rec.709, f32):   image crate 0.23.14 rgb_to_luma, mirrored by
                           upstream vision-gpu/cuda/cuda.cu:23-26
  * marker classifier:     upstream vision-common/src/markers/mod.rs:16-54
  * OCR preprocess:        upstream vision-cpu/src/lib.rs:39-53,173-231
  * scales binarize:       upstream vision-cpu/src/lib.rs:233-251
  * red-button gate:       upstream vision-cpu/src/lib.rs:115-135
  * L1-dilate radius 1:    imageproc 0.22 morphology::dilate_mut, called at
                           upstream vision-cpu/src/lib.rs:372
"""

from __future__ import annotations

import numpy as np

from . import consts as C

F32 = np.float32


def luma8(rgb: np.ndarray) -> np.ndarray:
    """Rec.709 luma with f32 accumulation and truncation, per image-0.23.

    rgb: uint8 array [..., 3] -> uint8 [...].
    """
    r = rgb[..., 0].astype(F32)
    g = rgb[..., 1].astype(F32)
    b = rgb[..., 2].astype(F32)
    l = (F32(0.2126) * r + F32(0.7152) * g) + F32(0.0722) * b
    return l.astype(np.uint8)  # trunc toward zero; l is in [0, 255]


def rgb_to_hsv_u8(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(h: uint16 [0,360), s: uint8 [0,100], v: uint8 [0,100]).

    f32 arithmetic with truncating casts, matching util/src/image.rs:159-187
    including its quirks: h=0 when max==min, and s becomes 0 for pure black
    (Rust casts the 0/0 NaN to 0).
    """
    r = rgb[..., 0].astype(F32) / F32(255.0)
    g = rgb[..., 1].astype(F32) / F32(255.0)
    b = rgb[..., 2].astype(F32) / F32(255.0)

    mx = np.maximum(r, np.maximum(g, b))
    mn = np.minimum(r, np.minimum(g, b))
    delta = mx - mn

    with np.errstate(divide="ignore", invalid="ignore"):
        # Rust: 60.0 * (((g - b) / delta) % 6.0). The operand is in (-6, 6)
        # and Rust % truncates toward zero, so it is the identity here.
        h_r = F32(60.0) * ((g - b) / delta)
        h_g = F32(60.0) * (((b - r) / delta) + F32(2.0))
        h_b = F32(60.0) * (((r - g) / delta) + F32(4.0))
        s_raw = (F32(100.0) * delta) / mx

    h = np.where(mx == mn, F32(0.0), np.where(mx == r, h_r, np.where(mx == g, h_g, h_b)))
    # modulo(h, 360): h in (-60, 360) here, so a single +360 fixup suffices.
    h = np.where(h < F32(0.0), h + F32(360.0), h)

    s = np.where(mx > F32(0.0), s_raw, F32(0.0))
    v = F32(100.0) * mx

    return h.astype(np.uint16), s.astype(np.uint8), v.astype(np.uint8)


def is_any_map_marker_color(rgb: np.ndarray) -> np.ndarray:
    """Vectorized fireteam marker-color classifier -> bool mask.

    Follows vision-common/src/markers/mod.rs:40-54 including the
    player-direction-arc alternate saturation band (l.16-19).
    """
    h, s, v = rgb_to_hsv_u8(rgb)
    h = h.astype(np.int32)
    s = s.astype(np.int32)
    v = v.astype(np.int32)

    ok = np.zeros(h.shape, dtype=bool)
    for mh, ms, mv in (
        C.ALPHA_MARKER_COLOR_HSV,
        C.BRAVO_MARKER_COLOR_HSV,
        C.CHARLIE_MARKER_COLOR_HSV,
    ):
        hue_ok = np.abs(h - mh) <= C.FIND_MARKER_HSV_HUE_TOLERANCE
        sat_ok = np.abs(s - ms) <= C.FIND_MARKER_HSV_SAT_TOLERANCE
        arc_sat_ok = np.abs(s - (ms - C.FIND_MARKER_PLAYER_DIR_ARC_SAT)) <= C.FIND_MARKER_HSV_SAT_TOLERANCE
        vib_ok = np.abs(v - mv) <= C.FIND_MARKER_HSV_VIB_TOLERANCE
        ok |= hue_ok & (sat_ok | arc_sat_ok) & vib_ok

    return ok & (s >= C.FIND_MARKER_HSV_MIN_SAT)


def close_button_red_mask(rgb: np.ndarray) -> np.ndarray:
    """Per-pixel close-deployment-button red test (vision-cpu:120-129)."""
    ok = np.ones(rgb.shape[:-1], dtype=bool)
    for i, c in enumerate(C.CLOSE_DEPLOYMENT_BUTTON_COLOR):
        diff = np.abs(np.int16(c) - rgb[..., i].astype(np.int16)).astype(np.uint16)
        ok &= diff <= C.CLOSE_DEPLOYMENT_BUTTON_TOLERANCE
    return ok


def ocr_monochromaticy(rgb: np.ndarray) -> np.ndarray:
    """Sum of pairwise channel abs-diffs, all ordered pairs (vision-cpu:44-53).

    Equals 2 * (|r-g| + |r-b| + |g-b|); fits u16.
    """
    r = rgb[..., 0].astype(np.int16)
    g = rgb[..., 1].astype(np.int16)
    b = rgb[..., 2].astype(np.int16)
    return (2 * (np.abs(r - g) + np.abs(r - b) + np.abs(g - b))).astype(np.uint16)


def _box_dilate_bool(mask: np.ndarray, radius: int) -> np.ndarray:
    """(2r+1)^2 box dilation of a boolean mask with edge clamping."""
    out = mask
    for axis in (0, 1):
        acc = out.copy()
        for d in range(1, radius + 1):
            shifted_fwd = np.zeros_like(out)
            shifted_bwd = np.zeros_like(out)
            if axis == 0:
                shifted_fwd[d:, :] = out[:-d, :]
                shifted_bwd[:-d, :] = out[d:, :]
            else:
                shifted_fwd[:, d:] = out[:, :-d]
                shifted_bwd[:, :-d] = out[:, d:]
            acc |= shifted_fwd | shifted_bwd
        out = acc
    return out


def ocr_preprocess(brq_rgb: np.ndarray) -> np.ndarray:
    """Isolate bright monochrome (whiteish) text for the OCR engine.

    Mirrors vision-cpu/src/lib.rs:173-231: a pixel is kept if it is strictly
    bright+monochrome, or if it is moderately bright+monochrome and has a
    strict pixel within the dilate window. The reference's window upper bound
    is min(x+R, w-R) inclusive (l.201-206), which is equivalent to a standard
    clamped box window over a strict-mask whose last R-1... precisely whose
    columns > w-R-1 and rows > h-R-1 are cleared (neighbours at the last R-1
    columns/rows are never examined).

    Kept pixels output inverted luma (dark text on white); others 255.
    """
    h, w = brq_rgb.shape[:2]
    mono = ocr_monochromaticy(brq_rgb)
    mn = np.minimum(np.minimum(brq_rgb[..., 0], brq_rgb[..., 1]), brq_rgb[..., 2])

    strict = (mono <= C.OCR_PREPROCESS_MONOCHROMATICY_THRESHOLD) & (
        mn >= C.OCR_PREPROCESS_BRIGHTNESS_THRESHOLD
    )
    edge_cand = (mono <= C.OCR_PREPROCESS_SIMILARITY_EDGE_THRESHOLD) & (
        mn >= C.OCR_PREPROCESS_BRIGHTNESS_EDGE_THRESHOLD
    )

    R = C.OCR_PREPROCESS_DILATE_RADIUS
    strict_clipped = strict.copy()
    if w > R:
        strict_clipped[:, w - R + 1 :] = False
    if h > R:
        strict_clipped[h - R + 1 :, :] = False
    near_strict = _box_dilate_bool(strict_clipped, R)

    keep = strict | (edge_cand & near_strict)

    inv = np.uint8(255) - luma8(brq_rgb)
    return np.where(keep, inv, np.uint8(255))


def find_scales_binarize(brq_rgb: np.ndarray) -> np.ndarray:
    """Binarize: non-zero luma -> 255, zero luma -> 0 (vision-cpu:233-251).

    Computed over the whole BRQ; the reference only fills rows >=
    scales_start_y (rows above keep stale data which nothing reads), so
    slicing this full result at scales_start_y is behaviour-identical.
    """
    return np.where(luma8(brq_rgb) != 0, np.uint8(255), np.uint8(0))


def dilate_l1_radius1(mask_u8: np.ndarray) -> np.ndarray:
    """Binary dilation by the L1 ball of radius 1 (a cross), like
    imageproc 0.22 dilate_mut(Norm::L1, 1) on a 0/255 image."""
    m = mask_u8 != 0
    out = m.copy()
    out[1:, :] |= m[:-1, :]
    out[:-1, :] |= m[1:, :]
    out[:, 1:] |= m[:, :-1]
    out[:, :-1] |= m[:, 1:]
    return np.where(out, np.uint8(255), np.uint8(0))


def bgra_to_rgb(bgra: np.ndarray) -> np.ndarray:
    """BGRA u8 [...,4] -> RGB u8 [...,3] (util/src/image.rs:290-298)."""
    return bgra[..., [2, 1, 0]]
