"""Stub SquadHeightmapRipper: speaks the exact subprocess contract.

The reference's C# ripper source is an empty submodule in the checkout
(SURVEY.md 2.9), so tests (and demo setups without game files) use this
stand-in. It emits a deterministic synthetic heightmap in the wire format of
heightmap-ripper/src/lib.rs:109-132, or a layer list for list-maps mode.

Usage (as the ripper `exe`):  python -m smh_tpu_torch.heightmaps.stub_ripper -p ... [-m map] [-k aes]
"""

from __future__ import annotations

import struct
import sys
import zlib

import numpy as np

LAYERS = [
    "SquadGame/Content/Maps/Mutaha/Mutaha.umap",
    "SquadGame/Content/Maps/Yehorivka/Yehorivka_AAS_v1.umap",
    "SquadGame/Content/Maps/Narva/Narva_RAAS_v1.umap",
    "SquadGame/Content/Maps/Mutaha/lighting_layers/Mutaha_LL.umap",  # filtered
    "SquadGame/Content/SomethingElse/Not_A_Map.umap",  # filtered
]


def synth_heightmap(map_path: str, w: int = 257, h: int = 257):
    seed = zlib.crc32(map_path.encode()) & 0xFFFF
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    z = (
        0.5
        + 0.3 * np.sin(xx / 37.0 + seed)
        + 0.2 * np.cos(yy / 23.0 - seed / 7.0)
    )
    z = (z - z.min()) / max(float(np.ptp(z)), 1e-9)
    return (z * 65535).astype("<u2")


def main(argv: list[str]) -> int:
    paks: list[str] = []
    map_path = None
    i = 0
    while i < len(argv):
        if argv[i] == "-p":
            i += 1
            while i < len(argv) and not argv[i].startswith("-"):
                paks.append(argv[i])
                i += 1
        elif argv[i] == "-m":
            i += 1
            map_path = argv[i]
            i += 1
        elif argv[i] == "-k":
            i += 2
        else:
            i += 1

    out = sys.stdout.buffer
    if map_path is None:
        for layer in LAYERS:
            out.write(layer.encode() + b"\n")
        return 0

    if "empty" in map_path.lower():
        out.write(struct.pack("<II", 0, 0))
        return 0

    data = synth_heightmap(map_path)
    h, w = data.shape
    out.write(struct.pack("<II", w, h))
    out.write(struct.pack("<iiii", -100, -100, 100, 100))
    out.write(struct.pack("<fff", 100.0, 100.0, 512.0))
    out.write(data.tobytes())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
