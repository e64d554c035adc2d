"""Heightmap browsing flows: cached rip, preview, PNG export.

Counterpart of the reference's heightmap browser logic
(/root/reference/src/ui/heightmaps.rs): the `.smhhm` disk cache around the
ripper subprocess (l.127-166), L16 PNG export (l.639-672), and a false-color
preview (l.169-207). Surfaced through the CLI (smh_tpu.app) and usable from
the web layer.
"""

from __future__ import annotations

import pathlib
import re
from typing import Iterable, Optional

import numpy as np

from ..squadex import heightmaps as hms
from . import ripper

DEFAULT_CACHE_DIR = "heightmaps"


def _cache_name(layer: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", layer) + ".smhhm"


def load_or_rip(
    layer: str,
    paks_dirs: Iterable[str],
    aes_key: Optional[str],
    cache_dir: str = DEFAULT_CACHE_DIR,
    exe: str = ripper.DEFAULT_EXE,
    skip_cache: bool = False,
) -> Optional[hms.Heightmap]:
    """Cache-aware heightmap load: .smhhm hit -> deserialize; miss -> rip the
    layer via the subprocess and populate the cache (heightmaps.rs:127-166)."""
    cache = pathlib.Path(cache_dir)
    path = cache / _cache_name(layer)

    if not skip_cache and path.exists():
        hm = hms.load_smhhm(path)
        if hm is not None:
            return hm  # corrupt/old-version cache falls through to re-rip

    hm = ripper.get_heightmap(paks_dirs, aes_key, layer, exe=exe)
    if hm is None:
        return None

    cache.mkdir(parents=True, exist_ok=True)
    hms.save_smhhm(path, hm)
    return hm


def export_png(hm: hms.Heightmap, path: str) -> None:
    """Export as 16-bit grayscale PNG (heightmaps.rs:639-672)."""
    from PIL import Image

    img = Image.fromarray(hm.data.astype(np.uint16), mode="I;16")
    img.save(path, format="PNG")


def false_color(hm: hms.Heightmap) -> np.ndarray:
    """RGB u8 preview: hypsometric tint from low (blue/green) to high
    (brown/white), like the in-app preview (heightmaps.rs:169-207)."""
    z = hm.data.astype(np.float32) / 65535.0
    stops = np.array(
        [
            (0.00, (40, 70, 160)),
            (0.15, (60, 130, 90)),
            (0.40, (110, 150, 70)),
            (0.65, (150, 120, 70)),
            (0.85, (140, 100, 90)),
            (1.00, (245, 245, 245)),
        ],
        dtype=object,
    )
    xs = np.array([s[0] for s in stops], dtype=np.float32)
    cs = np.array([s[1] for s in stops], dtype=np.float32)
    out = np.empty((*z.shape, 3), dtype=np.uint8)
    for c in range(3):
        out[..., c] = np.interp(z, xs, cs[:, c]).astype(np.uint8)
    return out
