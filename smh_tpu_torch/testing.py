"""Synthetic frame generation for tests, the fake-input harness, and bench.

The reference ships a screenshot corpus (vision-common/samples) and a
"Fake Input" debug mode that substitutes samples for live capture
(src/ui/debug.rs:46-82). This module generates fully synthetic frames with
*known* ground truth — marker lines, scale bars, the red close-deployment
button — so the suite can assert detections without any game assets.
Real reference samples are additionally used by the golden tests when the
read-only reference checkout is present.

The port's copy of smh_tpu/testing.py: scale texts are rendered with the
DejaVu Sans copy bundled in `smh_tpu_torch/fonts/` (the OCR templates read
the same files), so frames with real glyphs can be made on machines without
system fonts.
"""

from __future__ import annotations

import numpy as np

from . import consts as C
from .ocr.smhocr import FONTS
from .utils.plot import plot_line

# An RGB color that passes the alpha-fireteam marker classifier:
# HSV (105, 100, 100) -> RGB (64, 255, 0).
ALPHA_MARKER_RGB = (64, 255, 0)
# Close-deployment-button red (consts: CLOSE_DEPLOYMENT_BUTTON_COLOR).
BUTTON_RED_RGB = tuple(int(v) for v in C.CLOSE_DEPLOYMENT_BUTTON_COLOR)


def fonts_present() -> dict:
    """{font path: exists} for the fonts the templates and frames read."""
    return {str(p): p.exists() for p in FONTS}


def _put_rgb(frame_bgra: np.ndarray, y, x, rgb) -> None:
    frame_bgra[y, x, 0] = rgb[2]
    frame_bgra[y, x, 1] = rgb[1]
    frame_bgra[y, x, 2] = rgb[0]


def make_frame(
    frame_w: int = 1920,
    frame_h: int = 1080,
    marker_lines: list[tuple[tuple[int, int], tuple[int, int]]] = (),
    with_button: bool = True,
    scale_bars: list[tuple[int, int, int, int]] = (),  # (x, y, width, thickness)
    scale_texts: list[tuple[str, tuple[int, int]]] = (),  # ("300m", (x, y)) in BRQ coords
    background: tuple[int, int, int] = (90, 80, 70),
    line_thickness: int = 2,
) -> np.ndarray:
    """Build a BGRA u8 frame.

    marker_lines are given in *map-ROI* coordinates; scale_bars and
    scale_texts in *BRQ* coordinates. scale_texts renders real glyphs
    (DejaVu Sans, bright monochrome) that survive the OCR preprocess and are
    readable by the self-contained smhocr engine — end-to-end scales-branch
    tests/benches without canned engine results. The background is a
    non-marker, non-monochrome color so it neither triggers the classifier
    nor the OCR keep-mask.
    """
    g = C.map_geometry(frame_w, frame_h)
    frame = np.empty((frame_h, frame_w, 4), dtype=np.uint8)
    frame[..., 0] = background[2]
    frame[..., 1] = background[1]
    frame[..., 2] = background[0]
    frame[..., 3] = 255

    if with_button:
        frame[g.btn_y : g.btn_y + g.btn_h, g.btn_x : g.btn_x + g.btn_w, 0] = BUTTON_RED_RGB[2]
        frame[g.btn_y : g.btn_y + g.btn_h, g.btn_x : g.btn_x + g.btn_w, 1] = BUTTON_RED_RGB[1]
        frame[g.btn_y : g.btn_y + g.btn_h, g.btn_x : g.btn_x + g.btn_w, 2] = BUTTON_RED_RGB[0]

    # Marker lines drawn into the map ROI in the alpha fireteam color.
    map_view = frame[g.map_y : g.map_y + g.map_h, g.map_x : g.map_x + g.map_w]
    mask = np.zeros(map_view.shape[:2], dtype=np.uint8)
    for (x0, y0), (x1, y1) in marker_lines:
        plot_line(mask, x0, y0, x1, y1, 255)
    if line_thickness > 1:
        from .vision.pixmath import dilate_l1_radius1

        for _ in range(line_thickness - 1):
            mask = dilate_l1_radius1(mask)
    ys, xs = np.nonzero(mask)
    _put_rgb(map_view, ys, xs, ALPHA_MARKER_RGB)

    # Scale bars drawn into the BRQ in black: |----| shape. The background is
    # already non-zero-luma, which is all the scales binarize needs; a bright
    # surround would bleed into the OCR keep-mask as a giant blob.
    if scale_bars:
        brq_view = frame[g.brq_y : g.brq_y + g.brq_h, g.brq_x : g.brq_x + g.brq_w]
        for x, y, width, thickness in scale_bars:
            # horizontal line
            brq_view[y : y + thickness, x : x + width + 1, :3] = 0
            # vertical end bars (4 px down from the line's row)
            brq_view[y : y + 4, x, :3] = 0
            brq_view[y : y + 4, x + width, :3] = 0

    if scale_texts:
        from PIL import Image, ImageDraw, ImageFont

        brq_view = frame[g.brq_y : g.brq_y + g.brq_h, g.brq_x : g.brq_x + g.brq_w]
        font = None
        for path in FONTS:
            try:
                # 20 px reads at ~95% confidence with smhocr; below ~18 px the
                # thresholded glyph shapes drift too far from the templates.
                font = ImageFont.truetype(str(path), 20)
                break
            except OSError:
                continue
        if font is None:
            # PIL's default bitmap font renders ~10 px glyphs the smhocr
            # templates cannot match — failing silently would make frames
            # textless and send callers debugging the wrong layer.
            raise RuntimeError("scale_texts needs DejaVu Sans installed")
        for text, (tx, ty) in scale_texts:
            img = Image.new("L", (20 * len(text) + 8, 30), 0)
            d = ImageDraw.Draw(img)
            d.text((2, 2), text, fill=255, font=font)
            glyph = np.asarray(img)
            ys, xs = np.nonzero(glyph > 128)
            for yy, xx in zip(ys, xs):
                py, px = ty + yy, tx + xx
                if 0 <= py < brq_view.shape[0] and 0 <= px < brq_view.shape[1]:
                    brq_view[py, px, :3] = 236  # bright monochrome: OCR keeps it

    return frame


def draw_marker_line(
    frame_bgra: np.ndarray,
    p0: tuple[int, int],
    p1: tuple[int, int],
    thickness: int = 2,
) -> None:
    """Draw one alpha-fireteam marker line into a frame's map ROI in place
    (map-ROI coordinates) — overlays live-play-like motion onto REAL
    screenshots (bench `--mode corpus` live sequences)."""
    from . import consts as C

    g = C.map_geometry(frame_bgra.shape[1], frame_bgra.shape[0])
    map_view = frame_bgra[g.map_y : g.map_y + g.map_h, g.map_x : g.map_x + g.map_w]
    mask = np.zeros(map_view.shape[:2], dtype=np.uint8)
    plot_line(mask, p0[0], p0[1], p1[0], p1[1], 255)
    if thickness > 1:
        from .vision.pixmath import dilate_l1_radius1

        for _ in range(thickness - 1):
            mask = dilate_l1_radius1(mask)
    ys, xs = np.nonzero(mask)
    _put_rgb(map_view, ys, xs, ALPHA_MARKER_RGB)


def make_video_frames(w: int, h: int, n: int) -> list[np.ndarray]:
    """A deterministic video-like sequence: marker lines move continuously
    frame to frame and a BRQ patch changes every frame (defeats the ratio
    cache), while the map background stays — a delta-chain consumer ships
    only the real inter-frame motion, as it would for game footage. Shared
    by bench.py's batch metric and the video-golden test (the goldens pin
    the oracle's per-frame detections on this exact sequence)."""
    from . import consts as C

    g = C.map_geometry(w, h)
    frames = []
    for i in range(n):
        # Bounded triangle-wave motion: equal to 5*i on the first rising
        # edge (the golden-pinned frames 0..23 use off <= 115, unchanged),
        # then the lines sweep back instead of drifting off-frame — long
        # sequences (e.g. bench --batch 16 needs 350+ frames) keep both
        # markers on screen at every supported resolution.
        p = (5 * i) % 400
        off = p if p < 200 else 400 - p
        frame = make_frame(
            w,
            h,
            marker_lines=[
                ((120 + off, 150 + off // 2), (700 + off, 520)),
                ((w // 4, h // 3 + off), (w // 4 + 450, h // 3 + 60 + off)),
            ],
            scale_texts=[("300m", (60, 170))],
            scale_bars=[(60, 200, 120, 1)],
        )
        frame[g.brq_y + 300 + off % 40 : g.brq_y + 310 + off % 40,
              g.brq_x + 300 : g.brq_x + 340, :3] = 255
        frames.append(frame)
    return frames


# Screen sizes users run, in the order chip_smoke.py's resolutions phase
# resizes through. Map shapes 585x360, 779x394, 685x822, 585x702,
# 1096x1314, 1096x2194 and 822x986: ragged edges at the fused mask's 128-px
# and the quiet walk's 64-px tiles, and three with H * W = 2 (mod 4), where
# the batched classify writes each frame's outputs into a padded row.
RESOLUTIONS = ((1024, 768), (1280, 1024), (1600, 900), (1366, 768), (2560, 1440), (3440, 1440), (1920, 1080))


def resolution_frame(w: int, h: int, step: int = 0) -> np.ndarray:
    """A frame at any screen size: a marker line across the map ROI whose
    far end moves 8 px right and 5 px up a step, "300m" in the BRQ and its
    bar 22 px below the text's top (the bar scan reads 20/640 of the BRQ's
    width below the text: 6 rows at 1024x768)."""
    g = C.map_geometry(w, h)
    return make_frame(
        w, h,
        marker_lines=[((int(0.12 * g.map_w), int(0.18 * g.map_h)),
                       (int(0.7 * g.map_w) + 8 * step, int(0.63 * g.map_h) - 5 * step))],
        scale_texts=[("300m", (30, 170))],
        scale_bars=[(30, 192, 120, 1)],
    )


def upscale_frame(frame: np.ndarray, w: int, h: int) -> np.ndarray:
    """Nearest-neighbour upscale of a BGRA frame (4K stress corpus from the
    reference's 1440p screenshots — tests/goldens/detections_4k.json records
    this provenance; NEAREST keeps every pixel an exact original color, so
    the HSV classifier sees real game colors, just bigger)."""
    try:
        import cv2

        return cv2.resize(frame, (w, h), interpolation=cv2.INTER_NEAREST)
    except ImportError:  # pragma: no cover
        ys = (np.arange(h) * frame.shape[0]) // h
        xs = (np.arange(w) * frame.shape[1]) // w
        return frame[ys][:, xs]


def render_text_mask(text: str, height: int = 20) -> np.ndarray:
    """Tightly-cropped u8 0/255 glyph mask of `text` (DejaVu Sans) — for
    tests that need raw glyph pixels outside a full frame (e.g. feeding a
    real OCR engine directly)."""
    from PIL import Image, ImageDraw, ImageFont

    font = None
    for path in FONTS:
        try:
            font = ImageFont.truetype(str(path), height)
            break
        except OSError:
            continue
    if font is None:
        raise RuntimeError("render_text_mask needs DejaVu Sans installed")
    img = Image.new("L", (height * len(text) + 8, height + 12), 0)
    ImageDraw.Draw(img).text((2, 2), text, fill=255, font=font)
    mask = (np.asarray(img) > 128).astype(np.uint8) * np.uint8(255)
    ys, xs = np.nonzero(mask)
    return mask[ys.min() : ys.max() + 1, xs.min() : xs.max() + 1]


def make_ocr_text_patch(
    frame: np.ndarray, brq_x: int, brq_y: int, w: int = 30, h: int = 12
) -> None:
    """Stamp a bright monochrome block into the BRQ (something the OCR
    preprocess keeps). Does not render a real glyph — tests that need real
    OCR inject results through the engine seam instead."""
    g = C.map_geometry(frame.shape[1], frame.shape[0])
    ys = g.brq_y + brq_y
    xs = g.brq_x + brq_x
    frame[ys : ys + h, xs : xs + w, :3] = 230


def scales_read_cases() -> dict:
    """{name: (text, sbool)}: bool [H, W] planes (OCR text mask, scales
    binarize with False = black) at the edges the scales read must get
    right, each a plane as the BRQ would give it: real glyphs (DejaVu Sans)
    and |----| bars with 4-row end ticks."""

    def plane(h: int, w: int):
        return np.zeros((h, w), bool), np.ones((h, w), bool)

    def stamp(text_plane, label: str, x: int, y: int, height: int = 16) -> tuple:
        glyphs = render_text_mask(label, height) != 0
        gh, gw = glyphs.shape
        text_plane[y : y + gh, x : x + gw] |= glyphs
        return x, y, x + gw, y + gh  # the stamp's box

    def bar(sbool, x0: int, y: int, x1: int, tick: int = 4) -> None:
        sbool[y, x0 : x1 + 1] = False
        sbool[y : y + tick, x0] = False
        sbool[y : y + tick, x1] = False

    cases = {}
    # A word of 9 glyphs: the record keeps the first MAX_WG and flags it.
    text, sbool = plane(60, 240)
    x0, _, x1, y1 = stamp(text, "12345678m", 8, 8)
    bar(sbool, x0, y1 + 2, x1)
    cases["word_over_max_wg"] = (text, sbool)
    # Six words in one band: more than MAX_WPB.
    text, sbool = plane(50, 400)
    for k in range(6):
        x0, _, x1, y1 = stamp(text, f"{k + 1}m", 10 + 64 * k, 10)
        bar(sbool, x0, y1 + 1, x1 + 14)
    cases["words_over_max_wpb"] = (text, sbool)
    # A band 80 rows tall (a stroke beside the text): taller than WIN_H.
    text, sbool = plane(120, 160)
    text[10:90, 4:7] = True
    x0, _, x1, y1 = stamp(text, "300m", 30, 30)
    bar(sbool, x0, y1 + 3, x1 + 40)
    cases["band_taller_than_win_h"] = (text, sbool)
    # 15 columns: scan_budget(15) = 0 rows.
    text, sbool = plane(40, 15)
    stamp(text, "3", 3, 6, height=14)
    bar(sbool, 1, 24, 13)
    cases["narrow_plane"] = (text, sbool)
    # A bar from column 0: the left walk's sentinel reads it as a miss.
    text, sbool = plane(50, 200)
    x0, _, x1, y1 = stamp(text, "300m", 2, 8)
    bar(sbool, 0, y1 + 2, x1 + 60)
    cases["bar_at_column_0"] = (text, sbool)
    # Text ending 10 rows above the last (scan_budget(320) = 10 rows), and
    # bars whose ticks end on the last row (found) or would run past it
    # (drawn 3 rows long: missed).
    text, sbool = plane(40, 320)
    gh = render_text_mask("50m", 16).shape[0]
    x0, _, x1, _ = stamp(text, "50m", 10, 30 - gh)
    bar(sbool, x0 - 4, 36, x1 + 20)
    x0, _, x1, _ = stamp(text, "90m", 160, 30 - gh)
    bar(sbool, x0 - 4, 37, x1 + 20, tick=3)
    cases["bar_in_last_rows"] = (text, sbool)
    # No text, every pixel black.
    cases["empty_plane"] = (np.zeros((60, 80), bool), np.zeros((60, 80), bool))
    # The kernel's cluster reads the rows in strips of whole 32-row words:
    # a band whose rows straddle the seam at row 32 (and one at row 64).
    text, sbool = plane(140, 200)
    x0, _, x1, y1 = stamp(text, "300m", 12, 26)
    bar(sbool, x0 - 2, y1 + 2, x1 + 30)
    x0, _, x1, y1 = stamp(text, "75m", 100, 58)
    bar(sbool, x0, y1 + 1, x1 + 10)
    cases["bands_across_strip_seams"] = (text, sbool)
    # A band taller than WIN_H whose word lies below the band's first WIN_H
    # rows: the window holds only the stroke; the band is flagged.
    text, sbool = plane(150, 160)
    text[4:110, 2:4] = True
    x0, _, x1, y1 = stamp(text, "200m", 40, 80)
    bar(sbool, x0, y1 + 2, x1 + 20)
    cases["word_below_win_h"] = (text, sbool)
    # Eight text lines: more than MAX_BANDS bands (the overflow flag; the
    # first MAX_BANDS read).
    text, sbool = plane(8 * 22 + 6, 120)
    for k in range(8):
        x0, _, x1, y1 = stamp(text, f"{k + 1}0m", 8 + 6 * k, 4 + 22 * k)
        bar(sbool, x0, y1 + 1, x1 + 12)
    cases["bands_over_max_bands"] = (text, sbool)
    # scan_budget(640) = 20 rows below words that end 8 rows above the last:
    # the scan's rows run past h - BAR_H. One bar fits in the last rows
    # (found), one would need rows past the plane (missed).
    text, sbool = plane(40, 640)
    gh = render_text_mask("400m", 16).shape[0]
    x0, _, x1, _ = stamp(text, "400m", 20, 32 - gh)
    bar(sbool, x0, 36, x1 + 10)
    x0, _, x1, _ = stamp(text, "800m", 300, 32 - gh)
    bar(sbool, x0, 38, x1 + 10, tick=2)
    cases["bar_rows_past_the_plane"] = (text, sbool)
    # Bars that reach the last column (found: the right walk stops there)
    # and that span the whole row (the column-0 sentinel: missed).
    text, sbool = plane(70, 180)
    x0, _, x1, y1 = stamp(text, "100m", 120, 6)
    bar(sbool, x0 - 10, y1 + 2, 179)
    x0, _, x1, y1 = stamp(text, "5m", 60, 40)
    bar(sbool, 0, y1 + 2, 179)
    cases["bars_to_the_last_column"] = (text, sbool)
    # 77 columns: rows start at every byte offset mod 16, so no staged span
    # is 16-byte aligned.
    text, sbool = plane(90, 77)
    for k, y in enumerate((5, 35, 62)):
        x0, _, x1, y1 = stamp(text, f"{k + 2}m", 3 + 9 * k, y)
        bar(sbool, x0 + 1, y1 + 1, min(x1 + 15, 75))
    cases["width_77"] = (text, sbool)
    # 20 rows: fewer than one 32-row strip, so one block of the cluster
    # reads them all.
    text, sbool = plane(20, 120)
    x0, _, x1, y1 = stamp(text, "60m", 10, 2)
    bar(sbool, x0, y1 + 1, x1 + 20)
    cases["plane_shorter_than_a_strip"] = (text, sbool)
    return cases


def text_rgb(rng, h: int, w: int, share: float = 0.5) -> np.ndarray:
    """RGB u8 [h, w, 3] for the quadrant preprocess (kernel 6): a `share`
    of the pixels near its thresholds -- grey at 195-255 (strict from 200:
    strict needs r == g == b), grey-ish at 125-255 with a channel spread up
    to 13 (edge needs a spread of at most 12 and a min of 130) -- the rest
    uniform."""
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.int64)
    pick = rng.random((h, w))
    grey = rng.integers(195, 256, (h, w))
    strict = pick < share / 2
    rgb[strict] = grey[strict, None]
    edge = (pick >= share / 2) & (pick < share)
    lo = rng.integers(125, 256, (h, w))
    spread = rng.integers(0, 14, (h, w, 3))
    rgb[edge] = np.minimum(lo[edge, None] + spread[edge] * (rng.random((int(edge.sum()), 3)) < 0.5), 255)
    return rgb.astype(np.uint8)


def brq_preprocess_cases(rng) -> dict:
    """{name: RGB u8 [h, w, 3]}: quadrant planes at the edges kernel 6 must
    get right (the text_rgb mix unless named): widths with w % 8 and w % 32
    != 0, strict pixels within R of the last rows and columns, the seams of
    its 16 x 128 tiles, all-strict and all-edge planes, and a plane
    narrower and shorter than R."""
    R = int(C.OCR_PREPROCESS_DILATE_RADIUS)
    cases = {f"ragged_{h}x{w}": text_rgb(rng, h, w) for h, w in ((37, 53), (19, 7), (40, 101), (9, 250))}
    for h, w in ((33, 129), (17, 257), (48, 384)):
        cases[f"tile_seams_{h}x{w}"] = text_rgb(rng, h, w, share=0.2)
    # Strict pixels on the last R + 1 rows and columns among edge pixels:
    # the clip drops their dilation, but they stay text themselves.
    h, w = 30, 70
    edge = np.full((h, w, 3), 150, np.uint8)
    edge[..., 0] = 156
    for k in range(R + 1):
        edge[h - 1 - k, 5 + 9 * k] = 230
        edge[3 + 6 * k, w - 1 - k] = 240
    cases["strict_by_the_last_rows_and_columns"] = edge
    cases["all_strict"] = np.full((24, 45, 3), 220, np.uint8)
    half = np.full((24, 45, 3), 140, np.uint8)
    half[..., 1] = 146
    cases["all_edge"] = half
    cases["dense"] = text_rgb(rng, 64, 200, share=0.95)
    cases["smaller_than_r"] = text_rgb(rng, 2, 2, share=1.0)
    # The seams of the kernel's 16 x 124 tiles (each owns the output words
    # from up to 3 pixels before its first column) and their R rows and
    # columns of halo: widths 124 k - 4 .. 124 k + 4, heights 16 k - R ..
    # 16 k + R, and strict pixels on the seams among edge pixels.
    for h, w in ((13, 120), (15, 123), (16, 124), (17, 125), (19, 127), (29, 128), (32, 244), (35, 247),
                 (45, 248), (48, 251), (51, 372), (3, 121), (1, 126), (4, 5)):
        cases[f"tile124_seams_{h}x{w}"] = text_rgb(rng, h, w, share=0.3)
    h, w = 40, 260
    seams = np.full((h, w, 3), 150, np.uint8)
    seams[..., 0] = 156
    for y in (0, 12, 15, 16, 19, 31, 32, 35):
        for x in (0, 3, 120, 123, 124, 127, 244, 247, 248, 251, 259):
            seams[y, x] = 230
    cases["strict_on_the_tile124_seams"] = seams
    return cases


def mask_bits_cases(budget: int) -> dict:
    """{name: (bits u8 [H, ceil(W/8)], W)}: bit planes (MSB first, pad bits
    zero) at the edges kernel 7 must get right: an empty and a full mask,
    one pixel at each corner, budget - 1, budget and budget + 1 non-zero
    u32 words, and ragged widths (W % 8 and W % 32 != 0)."""

    def packed(m: np.ndarray) -> np.ndarray:
        return np.packbits(m, axis=1)

    cases = {"empty": (packed(np.zeros((40, 100), bool)), 100), "full": (packed(np.ones((40, 100), bool)), 100)}
    for name, (y, x) in {"top_left": (0, 0), "top_right": (0, 99), "bottom_left": (39, 0),
                         "bottom_right": (39, 99)}.items():
        m = np.zeros((40, 100), bool)
        m[y, x] = True
        cases[f"corner_{name}"] = (packed(m), 100)
    h, w = max(70, budget // 8 + 2), 250  # 8 words a row, the last 26 pixels wide
    for n in (budget - 1, budget, budget + 1):
        m = np.zeros((h, w), bool)
        for s in np.random.default_rng(n).choice(h * 8, size=n, replace=False):
            m[s // 8, 32 * (s % 8) + int(s % 26)] = True
        cases[f"nz_{n}"] = (packed(m), w)
    for w in (1, 7, 33, 61, 250):
        m = np.random.default_rng(w).random((23, w)) < 0.05
        cases[f"ragged_{w}"] = (packed(m), w)
    # Rows of (W + 7) / 8 bytes with every remainder mod 4: the kernel forms
    # each row's words from an odd row pitch.
    for w in (256, 264, 272, 277):
        m = np.random.default_rng(w + 1).random((45, w)) < 0.03
        cases[f"bpr_mod4_{((w + 7) // 8) % 4}"] = (packed(m), w)
    # The kernel's tiles are whole rows of at most MASK_TILE_WORDS words: at
    # W = 250 (8 words a row) seams every MASK_TILE_WORDS / 8 rows. Non-zero
    # words on both sides of two seams, in a row's first and last words;
    # then nz = budget - 1, budget, budget + 1 with the budget-th word (or
    # the last) the last word of the first tile or the first of the second.
    from .ops.kernels import MASK_TILE_WORDS

    seam = MASK_TILE_WORDS // 8 * 8  # the second tile's first word
    h, w = 2 * seam // 8 + 44, 250
    m = np.zeros((h, w), bool)
    for y in (0, seam // 8 - 1, seam // 8, 2 * seam // 8 - 1, 2 * seam // 8, h - 1):
        m[y, [0, 31, 32, 224, w - 1]] = True
    cases["tile_seams"] = (packed(m), w)
    for where, at in (("end", seam - 1), ("start", seam)):
        for n in (budget - 1, budget, budget + 1):
            rng = np.random.default_rng(1000 * n + at)
            before = min(n, budget) - 1  # words before the one at the seam
            words = np.concatenate([rng.choice(at, size=before, replace=False), [at],
                                    at + 1 + rng.choice(h * 8 - at - 1, size=n - before - 1, replace=False)])
            m = np.zeros((h, w), bool)
            for k in words:
                j = int(k % 8)
                m[k // 8, 32 * j + int(k % min(32, w - 32 * j))] = True
            cases[f"nz_{n}_at_the_seam_{where}"] = (packed(m), w)
    return cases


def window_crop_cases(margin: int) -> dict:
    """{name: (bits u8 [H, ceil(W/8)], W, crop_h, crop_w)}: bit planes (MSB
    first, pad bits zero) of the marker mask at the edges kernel 10 must get
    right, for windows at the bbox less `margin`: an empty mask (its origin
    clamped as JAX clamps y0 = H, x0 = W), the bbox at each border, the
    origin's column at every value mod 8, ragged crop widths, the last byte
    of a ragged row under the window, the window at the right border with
    its origin at every value mod 8, one full dimension (crop_w == W with
    crop_h < H, and crop_h == H with crop_w < W), the whole plane, 1-row and
    1-column planes, and dense random planes."""
    h, w = 97, 203  # 203 = 25 bytes and 3 bits a row

    def one(points, shape=(h, w)) -> np.ndarray:
        m = np.zeros(shape, bool)
        for y, x in points:
            m[y, x] = True
        return np.packbits(m, axis=1)

    cases = {"empty": (one([]), w, 41, 61)}
    for name, pts in {"top_left": [(0, 0)], "bottom_right": [(h - 1, w - 1)], "left_column": [(30, 0), (50, 0)],
                      "right_column": [(30, w - 1), (50, w - 1)], "top_row": [(0, 70), (0, 90)],
                      "bottom_row": [(h - 1, 70), (h - 1, 90)]}.items():
        cases[f"border_{name}"] = (one(pts), w, 41, 61)
    for k in range(8):  # cx0 = 40 + k: every shift of the source bytes
        cases[f"cx0_mod8_{(40 + k) % 8}"] = (one([(50, margin + 40 + k), (60, margin + 90 + k)]), w, 41, 61)
    rng = np.random.default_rng(margin)
    blob = rng.random((h, w)) < 0.3
    blob[:20], blob[:, :30] = False, False  # the bbox away from the origin
    for cw in (53, 57, 64, 1):
        cases[f"ragged_crop_w_{cw}"] = (np.packbits(blob, axis=1), w, 41, cw)
    cases["last_byte"] = (one([(60, w - 2)]), w, 41, 61)  # cx0 = W - 61: its last byte is the row's
    # The window at the right border, cx0 = W - crop_w at every value mod 8:
    # the row's last output bytes, and the 16-byte chunk that holds them,
    # take source bytes up to the row's end and none past it.
    for cw in (29, 30, 31, 33, 36, 40, 130, 195):
        cases[f"row_end_{cw}"] = (one([(50, w - 1), (60, w - 2), (70, w - 3)]), w, 41, cw)
    cases["full_width"] = (np.packbits(blob, axis=1), w, 41, w)
    cases["full_height"] = (np.packbits(blob, axis=1), w, h, 61)
    cases["full_plane"] = (np.packbits(blob, axis=1), w, h, w)
    cases["one_row"] = (one([(0, 100)], (1, w)), w, 1, 29)
    cases["one_column"] = (one([(40, 0)], (h, 1)), 1, 33, 1)
    for i, p in enumerate((0.01, 0.5)):
        m = rng.random((h, w)) < p
        cases[f"random_{p}"] = (np.packbits(m, axis=1), w, 41 + 7 * i, 61 + 11 * i)
    return cases


def ocr_band_cases() -> dict:
    """{name: (ocr_img u8 [h, w], band)}: quadrants at the edges kernel 11
    must get right (its keep mask is ocr_img < OCR_BINARY_THRESHOLD): a
    textless quadrant, text on the first or the last row, text near the
    bottom (the band clamped to the last rows), band == h, a single text
    pixel, text on the rows around the seams of the row strips of a cluster
    of 8 or of 16 blocks (ceil(h / 8) or ceil(h / 16) rows a block), ragged
    widths (w % 8, w % 16 and w % 32 != 0, w % 16 of 1 and 15, w < 16), 1-row
    and narrow quadrants, dense text, and bands whose start puts both
    sections' first bytes at every value mod 16."""
    from .ocr.engine import OCR_BINARY_THRESHOLD

    rng = np.random.default_rng(11)
    h, w = 83, 203

    def text_at(rows, shape=(h, w), cols=slice(10, 60)) -> np.ndarray:
        img = np.full(shape, 255, np.uint8)
        for r in rows:
            img[r, cols] = rng.integers(0, OCR_BINARY_THRESHOLD, img[r, cols].shape, dtype=np.uint8)
        return img

    cases = {
        "textless": (text_at([]), 20),
        "first_row": (text_at([0]), 20),
        "last_row": (text_at([h - 1]), 20),
        "near_bottom": (text_at(range(h - 5, h)), 20),
        "band_is_h": (text_at([30, 40]), h),
        "single_pixel": (text_at([41], cols=slice(101, 102)), 16),
        "last_column": (text_at([7], cols=slice(w - 1, w)), 16),
        "one_row": (text_at([0], (1, w)), 1),
        "narrow": (text_at([3, 9], (17, 13), slice(0, 13)), 5),
        "dense": (rng.integers(0, 256, (h, w), dtype=np.uint8), 33),
    }
    per = -(-h // 8)  # rows a block of a cluster of 8
    for k in (1, 4, 7):
        cases[f"strip_seam_{k}"] = (text_at([k * per - 1, k * per]), 24)
    per = -(-h // 16)  # rows a block of a cluster of 16
    for k in (1, 7, 13):
        cases[f"strip16_seam_{k}"] = (text_at([k * per - 1, k * per]), 24)
    for cw in (1, 5, 9, 15, 17, 31, 33, 47, 49, 64, 493):
        cases[f"ragged_{cw}"] = (text_at([5, 20], (29, cw), slice(0, cw)), 12)
    # The band's start at every value mod 16 of both sections: w = 193 and
    # its 25-byte rows are odd, so b0 = k puts b0 w and b0 bpr at k and 9 k
    # mod 16.
    for k in range(16):
        cases[f"b0_mod16_{k}"] = (text_at([k, k + 3], (40, 193), slice(3, 190)), 12)
    return cases
