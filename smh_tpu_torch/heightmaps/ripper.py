"""SquadHeightmapRipper subprocess contract.

The reference drives a C# CUE4Parse tool over argv + raw little-endian stdout
(/root/reference/heightmap-ripper/src/lib.rs:74-259). The same contract is
preserved here so the actual ripper binary works unchanged:

  get_heightmap: `<exe> -p <paks...> -m <map> [-k <aes>]`
    stdout: w u32 LE, h u32 LE (0,0 => no data), bounds 2x2 i32 LE,
            scale 3 f32 LE, then w*h u16 LE heightmap samples
            (all-zero payload => no data).

  list_maps: `<exe> -p <paks...> [-k <aes>]`
    stdout: one asset path per line; layers filtered to "/Content/Maps/"
            minus lighting/sound/vfx/gameplay layer variants.

The executable name is configurable; tests point it at the stub generator
(smh_tpu/heightmaps/stub_ripper.py) since the C# source is an empty submodule
in the reference checkout (SURVEY.md 2.9).
"""

from __future__ import annotations

import pathlib
import struct
import subprocess
from typing import Iterable, Optional

import numpy as np

from ..squadex.heightmaps import Heightmap

DEFAULT_EXE = "SquadHeightmapRipper"

# Layer-path fragments excluded from list_maps (heightmap-ripper lib.rs:221-249).
_LAYER_FILTERS = (
    "/lighting_layers/", "/lightinglayers/", "/lightlayers/", "/light_layers/",
    "/lighting_layer/", "/lightinglayer/", "/lightlayer/", "/light_layer/",
    "/sound_layer/", "/vfx_layers/", "/vfxlayers/", "/vfxlayer/",
    "/fx_layers/", "/fxlayers/", "/fxlayer/",
    "/gameplay_layer/", "/gameplay_layers/", "/gameplaylayers/", "/gameplaylayer/",
    "/gamplaylayer/", "/gamplaylayers/", "/gamplay_layers/", "/gamplay_layer/",
    "/vfx_sound_layers/", "/vfx_sound_layer/", "/vfxsoundlayer/", "/vfxsoundlayers/",
)


class RipperError(RuntimeError):
    pass


def _invoke(args: list[str], exe: str) -> bytes:
    try:
        proc = subprocess.run([exe, *args], capture_output=True, timeout=600)
    except FileNotFoundError as e:
        raise RipperError(f"ripper executable not found: {exe}") from e
    if proc.returncode != 0:
        raise RipperError(
            f"Status: {proc.returncode}\n\n======= STDOUT =======\n"
            f"{proc.stdout.decode(errors='replace')}\n\n======= STDERR =======\n"
            f"{proc.stderr.decode(errors='replace')}"
        )
    return proc.stdout


def get_heightmap(
    paks_dirs: Iterable[str],
    aes_key: Optional[str],
    map_path: str,
    exe: str = DEFAULT_EXE,
) -> Optional[Heightmap]:
    args = ["-p", *paks_dirs, "-m", map_path]
    if aes_key:
        args += ["-k", aes_key]
    out = _invoke(args, exe)

    if len(out) < 8:
        raise RipperError("truncated ripper output")
    width, height = struct.unpack_from("<II", out, 0)
    if width == 0 and height == 0:
        return None

    if len(out) < 8 + 16 + 12:
        raise RipperError("truncated ripper header")
    b = struct.unpack_from("<iiii", out, 8)
    scale = struct.unpack_from("<fff", out, 24)

    payload = out[36:]
    if not any(payload):
        return None  # all-zero => layer has no heightmap (lib.rs:133-137)

    expected = width * height * 2
    if len(payload) < expected:
        raise RipperError(f"heightmap payload short: {len(payload)} < {expected}")
    data = np.frombuffer(payload[:expected], dtype="<u2").reshape(height, width).copy()

    return Heightmap(
        width=width,
        height=height,
        bounds=((b[0], b[1]), (b[2], b[3])),
        scale=scale,
        data=data,
    )


def list_maps(
    paks_dirs: Iterable[str],
    aes_key: Optional[str],
    exe: str = DEFAULT_EXE,
) -> list[str]:
    args = ["-p", *paks_dirs]
    if aes_key:
        args += ["-k", aes_key]
    out = _invoke(args, exe)

    layers = []
    for raw in out.split(b"\n"):
        line = raw.rstrip(b"\r")
        if not line:
            continue
        try:
            s = line.decode()
        except UnicodeDecodeError:
            continue
        if "/Content/Maps/" not in s:
            continue
        low = s.lower()
        if any(f in low for f in _LAYER_FILTERS):
            continue
        layers.append(s)
    return layers


SQUAD_APP_ID = 393380  # heightmap-ripper lib.rs:56


def _steam_roots() -> list[pathlib.Path]:
    return [
        pathlib.Path.home() / ".steam/steam",
        pathlib.Path.home() / ".local/share/Steam",
        pathlib.Path("C:/Program Files (x86)/Steam"),
    ]


def _library_dirs(root: pathlib.Path) -> list[pathlib.Path]:
    """Steam library roots: the install root plus every ``"path"`` entry in
    steamapps/libraryfolders.vdf (what steamlocate does for lib.rs:57)."""
    libs = [root]
    vdf = root / "steamapps" / "libraryfolders.vdf"
    if vdf.is_file():
        try:
            for line in vdf.read_text(errors="replace").splitlines():
                parts = line.strip().split('"')
                # VDF lines look like:  "path"  "/mnt/games/SteamLibrary"
                if len(parts) >= 4 and parts[1] == "path":
                    p = pathlib.Path(parts[3].replace("\\\\", "\\"))
                    if p not in libs:
                        libs.append(p)
        except OSError:
            pass
    return libs


def find_squad_dir(steam_roots: Optional[list[pathlib.Path]] = None) -> Optional[pathlib.Path]:
    """Locate the Squad install dir (app 393380) across Steam libraries.

    Python analog of steamlocate in heightmap-ripper lib.rs:56-59: probe the
    default Steam roots, follow extra libraries from libraryfolders.vdf, and
    require the appmanifest (or the game dir itself) to exist.
    """
    for root in steam_roots if steam_roots is not None else _steam_roots():
        if not root.is_dir():
            continue
        for lib in _library_dirs(root):
            game = lib / "steamapps" / "common" / "Squad"
            if game.is_dir():
                return game
    return None


def find_workshop_paks(squad_dir: pathlib.Path) -> list[str]:
    """Workshop pak dirs for app 393380 (src/ui/heightmaps.rs:26-64).

    squad_dir is <lib>/steamapps/common/Squad; the workshop tree lives at
    <lib>/steamapps/workshop/content/393380. Collect the unique parent dirs
    of *.pak files whose parent is named WindowsNoEditor, sorted (the
    reference uses a BTreeSet).
    """
    workshop = squad_dir.parent.parent / "workshop" / "content" / str(SQUAD_APP_ID)
    if not workshop.is_dir():
        return []
    dirs: set[str] = set()
    for pak in workshop.rglob("*.pak"):
        parent = pak.parent
        if parent.name == "WindowsNoEditor":
            dirs.add(str(parent))
    return sorted(dirs)


def discover_paks(steam_roots: Optional[list[pathlib.Path]] = None) -> list[str]:
    """Auto-discover pak dirs like the reference UI does when no explicit dir
    is set (src/ui/heightmaps.rs LoadLayersOp::load_layers): workshop paks
    first, then the main game paks dir. Empty list when Squad isn't found.
    """
    squad = find_squad_dir(steam_roots)
    if squad is None:
        return []
    return find_workshop_paks(squad) + [str(squad / "SquadGame" / "Content" / "Paks")]
