"""The binary WebSocket event protocol — byte-compatible with the reference.

Wire format (little-endian, u16 event id prefix) mirrors
/root/reference/web/src/lib.rs:74-214:

  Map(1):           w u32, h u32, RGBA bytes
  Markers(2):       custom u8, count u32, count * 4 f32 (p0.x p0.y p1.x p1.y)
  UpdateState(3):   meters_to_px_ratio f64 (0.0 encodes None),
                    flag u8 [+ minimap left,right,top,bottom u32]
  Heightmap(4):     flag u8 [+ 1 pad byte (JS Uint16Array alignment hack,
                    lib.rs:193-195) + w,h u32 + bounds[0][0],bounds[0][1] i32
                    + scale.z f32 + u16-LE heightmap data]
  HeightmapFitToMinimap(5): u8

Client->server interactions (lib.rs:33-72):
  AddCustomMarker(1):    4 f32
  DeleteCustomMarker(2): u32

smh_tpu extensions (ids chosen far above the reference's; unknown ids are
ignorable by either peer):
  InspectPixel(3):       2 u32 map-ROI coords -> server replies with
                         Inspect(101), the pixel-inspector breakdown the
                         reference renders in its debug UI
                         (src/ui/debug.rs:350-475)
  Debug(100):            JSON telemetry (fps, timeshares, OCR boxes, scale
                         overlays) when --debug-web is on
  Inspect(101):          JSON pixel inspection reply
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional, Union

import numpy as np

from ..geometry import Rect
from ..squadex.heightmaps import Heightmap

EVENT_MAP = 1
EVENT_MARKERS = 2
EVENT_UPDATE_STATE = 3
EVENT_HEIGHTMAP = 4
EVENT_FIT_TO_MINIMAP = 5
# Extension (not in the reference protocol, opt-in via --debug-web): JSON
# debug telemetry — fps, per-stage timeshares, backend name. Sent only when
# enabled; clients that don't know the id can ignore it.
EVENT_DEBUG = 100
EVENT_INSPECT = 101

INTERACTION_ADD_CUSTOM_MARKER = 1
INTERACTION_DELETE_CUSTOM_MARKER = 2
INTERACTION_INSPECT_PIXEL = 3


def encode_map(map_rgba: np.ndarray) -> bytes:
    h, w = map_rgba.shape[:2]
    assert map_rgba.dtype == np.uint8 and map_rgba.shape[2] == 4
    return struct.pack("<HII", EVENT_MAP, w, h) + np.ascontiguousarray(map_rgba).tobytes()


def encode_markers(markers: list[tuple[tuple[float, float], tuple[float, float]]], custom: bool) -> bytes:
    buf = struct.pack("<HBI", EVENT_MARKERS, int(custom), len(markers))
    for (x0, y0), (x1, y1) in markers:
        buf += struct.pack("<ffff", x0, y0, x1, y1)
    return buf


def encode_update_state(meters_to_px_ratio: Optional[float], minimap_bounds: Optional[Rect]) -> bytes:
    buf = struct.pack("<Hd", EVENT_UPDATE_STATE, meters_to_px_ratio or 0.0)
    if minimap_bounds is not None:
        buf += struct.pack(
            "<BIIII",
            1,
            minimap_bounds.left,
            minimap_bounds.right,
            minimap_bounds.top,
            minimap_bounds.bottom,
        )
    else:
        buf += b"\x00"
    return buf


def encode_heightmap(hm: Optional[Heightmap]) -> bytes:
    if hm is None:
        return struct.pack("<HB", EVENT_HEIGHTMAP, 0)
    data = np.ascontiguousarray(hm.data.astype("<u2")).tobytes()
    return (
        struct.pack("<HB", EVENT_HEIGHTMAP, 1)
        + b"\x00"  # alignment pad so the JS Uint16Array starts on an even offset
        + struct.pack("<IIiif", hm.width, hm.height, hm.bounds[0][0], hm.bounds[0][1], hm.scale[2])
        + data
    )


def encode_fit_to_minimap(fit: bool) -> bytes:
    return struct.pack("<HB", EVENT_FIT_TO_MINIMAP, int(fit))


def encode_debug(payload: dict) -> bytes:
    import json

    return struct.pack("<H", EVENT_DEBUG) + json.dumps(payload).encode()


def encode_inspect(payload: dict) -> bytes:
    import json

    return struct.pack("<H", EVENT_INSPECT) + json.dumps(payload).encode()


@dataclasses.dataclass(frozen=True)
class AddCustomMarker:
    p0: tuple[float, float]
    p1: tuple[float, float]


@dataclasses.dataclass(frozen=True)
class DeleteCustomMarker:
    index: int


@dataclasses.dataclass(frozen=True)
class InspectPixel:
    x: int
    y: int  # map-ROI coordinates


Interaction = Union[AddCustomMarker, DeleteCustomMarker, InspectPixel]


def decode_interaction(data: bytes) -> Optional[Interaction]:
    """Parse a client->server interaction (lib.rs:38-71)."""
    if len(data) < 2:
        return None
    (kind,) = struct.unpack_from("<H", data, 0)
    body = data[2:]
    if kind == INTERACTION_ADD_CUSTOM_MARKER:
        if len(body) != 16:
            return None
        x0, y0, x1, y1 = struct.unpack("<ffff", body)
        return AddCustomMarker((x0, y0), (x1, y1))
    if kind == INTERACTION_DELETE_CUSTOM_MARKER:
        if len(body) != 4:
            return None
        (idx,) = struct.unpack("<I", body)
        return DeleteCustomMarker(idx)
    if kind == INTERACTION_INSPECT_PIXEL:
        if len(body) != 8:
            return None
        x, y = struct.unpack("<II", body)
        return InspectPixel(x, y)
    return None
