"""Heightmap type, global store, and the SMHHM disk format.

Counterparts of:
  * Heightmap struct + height():  /root/reference/heightmap-ripper/src/lib.rs:8-26
  * global current-heightmap:     /root/reference/src/squadex/heightmaps/mod.rs:8-30
  * SMHHM serde (xz-compressed):  /root/reference/src/squadex/heightmaps/serde.rs:14-86

The SMHHM byte format is preserved exactly (big-endian magic 0xBADFEEF,
little-endian fields, lzma/xz-compressed u16-LE data) so caches written by
the reference app load unchanged.
"""

from __future__ import annotations

import dataclasses
import io
import lzma
import struct
import threading
from typing import BinaryIO, Optional

import numpy as np

SMH_MAGIC_NUMBER = 0x0BADFEEF
HEIGHTMAP_FILE_VER = 0

# Unreal's default landscape Z scale reference: u16 height 65535 spans
# scale_z / 0.1953125 meters (heightmap-ripper/src/lib.rs:22-26).
_UE_Z_DIVISOR = 0.1953125


@dataclasses.dataclass
class Heightmap:
    width: int
    height: int
    bounds: tuple[tuple[int, int], tuple[int, int]]  # [[x0,y0],[x1,y1]]
    scale: tuple[float, float, float]
    data: np.ndarray  # u16 [height, width]

    def height_at(self, x: int, y: int) -> float:
        """Height in meters at heightmap pixel (x, y)."""
        h = float(self.data[y, x])
        return (h / 65535.0) * (float(self.scale[2]) / _UE_Z_DIVISOR)

    def as_image(self) -> np.ndarray:
        return self.data


def serialize(w: BinaryIO, hm: Heightmap) -> None:
    w.write(struct.pack(">I", SMH_MAGIC_NUMBER))
    w.write(struct.pack("<H", HEIGHTMAP_FILE_VER))
    w.write(struct.pack(">I", SMH_MAGIC_NUMBER))
    w.write(struct.pack("<II", hm.width, hm.height))
    for pair in hm.bounds:
        for b in pair:
            w.write(struct.pack("<i", int(b)))
    for s in hm.scale:
        w.write(struct.pack("<f", float(s)))
    raw = np.ascontiguousarray(hm.data.astype("<u2")).tobytes()
    # xz container, preset 9, like xz2::write::XzEncoder::new(w, 9)
    w.write(lzma.compress(raw, format=lzma.FORMAT_XZ, preset=9))


def deserialize(r: BinaryIO) -> Optional[Heightmap]:
    head = r.read(4 + 2 + 4)
    if len(head) != 10:
        return None
    (magic1,) = struct.unpack(">I", head[0:4])
    (ver,) = struct.unpack("<H", head[4:6])
    (magic2,) = struct.unpack(">I", head[6:10])
    if magic1 != SMH_MAGIC_NUMBER or ver != HEIGHTMAP_FILE_VER or magic2 != SMH_MAGIC_NUMBER:
        return None

    width, height = struct.unpack("<II", r.read(8))
    b = struct.unpack("<iiii", r.read(16))
    bounds = ((b[0], b[1]), (b[2], b[3]))
    scale = struct.unpack("<fff", r.read(12))

    raw = lzma.decompress(r.read(), format=lzma.FORMAT_XZ)
    expected = width * height * 2
    if len(raw) < expected:
        return None
    data = np.frombuffer(raw[:expected], dtype="<u2").reshape(height, width).copy()

    return Heightmap(width=width, height=height, bounds=bounds, scale=scale, data=data)


def save_smhhm(path, hm: Heightmap) -> None:
    buf = io.BytesIO()
    serialize(buf, hm)
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def load_smhhm(path) -> Optional[Heightmap]:
    with open(path, "rb") as f:
        return deserialize(f)


# ---------------------------------------------------------------------------
# Global current-heightmap store (src/squadex/heightmaps/mod.rs:8-30). When a
# heightmap is set, the pipeline skips the OCR-scales branch
# (src/vision/mod.rs:121-123).
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_current: Optional[Heightmap] = None


def is_set() -> bool:
    with _lock:
        return _current is not None


def get_current() -> Optional[Heightmap]:
    with _lock:
        return _current


def set_current(hm: Optional[Heightmap]) -> None:
    global _current
    with _lock:
        _current = hm
