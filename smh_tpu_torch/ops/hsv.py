"""HSV conversion and marker classification in PyTorch (oracle-matching f32).

Port of smh_tpu/ops/hsv.py. Mirrors smh_tpu.vision.pixmath (the numpy
oracle): float32 arithmetic in the oracle's order of operations, truncating
casts, comparisons on the truncated integer h/s/v. Each operation is its own
PyTorch op, so nothing is contracted into an FMA. Every division is by a
tensor, never by a Python scalar: PyTorch's CUDA division by a host scalar
multiplies by the reciprocal, which is not correctly rounded.

Hue goes straight to int32 (PyTorch's uint16 support is thin; the values are
in [0, 360]).
"""

from __future__ import annotations

import torch

from smh_tpu import consts as C

F32 = torch.float32


def f32_scalar(value: float, device) -> torch.Tensor:
    """0-dim f32 divisor made on the device (a fill, no host copy). Dividing
    by a tensor keeps `/` correctly rounded: PyTorch's CUDA division by a
    host scalar multiplies by its reciprocal."""
    return torch.full((), float(value), dtype=F32, device=device)


def luma8_planes(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rec.709 luma on u8 channel planes: (0.2126r + 0.7152g) + 0.0722b in
    f32, truncated to u8."""
    l = (0.2126 * r.to(F32) + 0.7152 * g.to(F32)) + 0.0722 * b.to(F32)
    return l.to(torch.int32).to(torch.uint8)


def rgb_to_hsv_u8_planes(r8: torch.Tensor, g8: torch.Tensor, b8: torch.Tensor):
    """(h i32, s i32, v i32) with the oracle's truncation semantics."""
    k255 = f32_scalar(255.0, r8.device)
    r = r8.to(F32) / k255
    g = g8.to(F32) / k255
    b = b8.to(F32) / k255

    mx = torch.maximum(r, torch.maximum(g, b))
    mn = torch.minimum(r, torch.minimum(g, b))
    delta = mx - mn
    safe_delta = torch.where(delta == 0, 1.0, delta)

    h_r = 60.0 * ((g - b) / safe_delta)
    h_g = 60.0 * (((b - r) / safe_delta) + 2.0)
    h_b = 60.0 * (((r - g) / safe_delta) + 4.0)

    h = torch.where(mx == mn, 0.0, torch.where(mx == r, h_r, torch.where(mx == g, h_g, h_b)))
    h = torch.where(h < 0.0, h + 360.0, h)

    safe_mx = torch.where(mx == 0, 1.0, mx)
    s = torch.where(mx > 0.0, (100.0 * delta) / safe_mx, 0.0)
    v = 100.0 * mx
    return h.to(torch.int32), s.to(torch.int32), v.to(torch.int32)


def is_any_map_marker_color_planes(
    r8: torch.Tensor, g8: torch.Tensor, b8: torch.Tensor
) -> torch.Tensor:
    """Fireteam marker-colour predicate -> bool, matching the oracle."""
    h, s, v = rgb_to_hsv_u8_planes(r8, g8, b8)
    ok = torch.zeros(h.shape, dtype=torch.bool, device=h.device)
    for mh, ms, mv in (
        C.ALPHA_MARKER_COLOR_HSV,
        C.BRAVO_MARKER_COLOR_HSV,
        C.CHARLIE_MARKER_COLOR_HSV,
    ):
        hue_ok = (h - mh).abs() <= C.FIND_MARKER_HSV_HUE_TOLERANCE
        sat_ok = (s - ms).abs() <= C.FIND_MARKER_HSV_SAT_TOLERANCE
        arc_ok = (s - (ms - C.FIND_MARKER_PLAYER_DIR_ARC_SAT)).abs() <= C.FIND_MARKER_HSV_SAT_TOLERANCE
        vib_ok = (v - mv).abs() <= C.FIND_MARKER_HSV_VIB_TOLERANCE
        ok = ok | (hue_ok & (sat_ok | arc_ok) & vib_ok)
    return ok & (s >= C.FIND_MARKER_HSV_MIN_SAT)
