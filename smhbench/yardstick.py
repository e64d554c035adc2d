"""The yardstick: the card's peak, each kernel's bytes, and the statistics.

A kernel's roofline share is the least time the card could take for the
bytes it must move (each input byte read once, each output byte written
once) over the time it took. Every kernel of the fused pass is bound by
bytes: its operations are a few per byte (the kernel table in PERF.md).
Where the bytes depend on the frame (the sparse mask's words, the window,
the OCR band), they are counted by what these inputs need, from the plain
reference's masks, never from the program's choices.
"""

from __future__ import annotations

import math

# NVIDIA's H100 SXM data sheet at 700 W: device memory bytes per second. A
# card set below 700 W (nvidia-smi's power.limit, printed beside) is slower.
HBM_BYTES_PER_S = 3.35e12

# Constants of the program's formats that a kernel's bytes depend on (the
# port's ops/scales_device.py and ops/kernels.py): a scales record, the
# templates the scales read loads (22 glyphs of 16 x 12 f32), the window's
# and the band's meta, the delta chunk a flat frame is padded to.
SCALES_RECORD_BYTES = 1168
SCALES_TEMPLATE_BYTES = 22 * 16 * 12 * 4
WINDOW_META_BYTES = 24
BAND_META_BYTES = 12
DELTA_CHUNK = 128
MASK_WORDS_HEAD = 7  # u32 words before the sparse words: the bbox and the count


def shapes(geom, need: dict) -> dict:
    """Everything the byte counts read, for one frame of a screen size:
    `geom` is the reference's map geometry, `need` what the inputs need
    (`nz`: non-zero u32 words of the marker mask; `win`: (rows, cols) of
    the mask's bounding box; `band`: the OCR keep mask's text rows)."""
    mh, mw, qh, qw = geom.map_h, geom.map_w, geom.brq_h, geom.brq_w
    btn = geom.btn_h * geom.btn_w * 3
    flat = -(-(mh * mw * 3 + btn) // DELTA_CHUNK) * DELTA_CHUNK
    return {"px": mh * mw, "bits": mh * ((mw + 7) // 8), "qpx": qh * qw, "qbits": qh * ((qw + 7) // 8),
            "qbpr": (qw + 7) // 8, "qw": qw, "btn": btn, "flat": flat, **need}


def _window_bytes(s: dict) -> int:
    rows, cols = s["win"]
    return rows * ((cols + 7) // 8)


ROUTES = ("sparse", "window-gray")  # the transport routes whose sections are counted


def _sections(s: dict, route: str) -> int:
    """The hostpack's sections as the route needs them for these inputs:
    `sparse` (the sparse mask's words and the device scales record) or
    `window-gray` (the mask's window and the gray OCR band). A route whose
    sections are not counted here raises."""
    if route == "window-gray":
        return WINDOW_META_BYTES + _window_bytes(s) + BAND_META_BYTES + s["band"] * (s["qbpr"] + s["qw"])
    if route == "sparse":
        return 4 * (MASK_WORDS_HEAD + 2 * s["nz"]) + SCALES_RECORD_BYTES
    raise ValueError(f"the yardstick counts no sections of route {route!r}; it knows {ROUTES}")


def kernel_bytes(name: str, s: dict, route: str, b: int = 1) -> float:
    """Bytes one launch of kernel `name` must move for b frames, or None for
    a kernel the yardstick does not count."""
    per_frame = {
        "classify_luma": lambda: 5 * s["px"],  # 3 planes in, marker and luma out
        "quiet_walk": lambda: 3 * s["px"] + 16,
        "fused_mask": lambda: 3 * s["px"] + s["bits"],
        # R, G, B and luma of the quadrant in; ocr, text, sbool and the bits out; the checks
        "brq_preprocess": lambda: 7 * s["qpx"] + s["qbits"] + 16,
        # the bit plane in; the bbox, the count and the words the mask needs out
        "mask_words": lambda: s["bits"] + 4 * (MASK_WORDS_HEAD + 2 * s["nz"]),
        # the text and scales planes in, a record out (the templates once a launch)
        "scales_read": lambda: 2 * s["qpx"] + SCALES_RECORD_BYTES,
        # the luma, the button and the sections in, the hostpack out
        "hostpack": lambda: s["px"] + s["btn"] + 2 * _sections(s, route) + 5,
        # each row written from the resident (read once a launch); the changed
        # chunks it uploads are a few KB, left out
        "delta_apply": lambda: s["flat"],
        # the bbox and the window's source bits in, the meta and the window out
        "window_crop": lambda: 16 + 2 * _window_bytes(s) + WINDOW_META_BYTES,
        # the keep plane in, the band's rows in and out
        "ocr_band": lambda: s["qpx"] + 2 * s["band"] * (s["qbpr"] + s["qw"]) + BAND_META_BYTES,
    }.get(name)
    if per_frame is None:
        return None
    once = {"scales_read": SCALES_TEMPLATE_BYTES, "delta_apply": s["flat"]}.get(name, 0)
    return b * per_frame() + once


def bound_s(nbytes: float) -> float:
    """The least time the card could take to move nbytes."""
    return nbytes / HBM_BYTES_PER_S


def quantile(values, q: float) -> float:
    """The q-quantile of all values by nearest rank: the smallest value with
    at least a share q of the values at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    return xs[max(0, math.ceil(q * len(xs)) - 1)]


def union_s(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a >= hi:
            break
        if a > end:
            out.append((end, a))
        end = max(end, b)
    if end < hi:
        out.append((end, hi))
    return out
