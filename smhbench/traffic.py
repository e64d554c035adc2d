"""The one traffic generator: a mix's parameters in, the frames of a cycle out.

A traffic mix is `smhbench/traffic/<name>.json`. It names the feed that
offers the frames (`live`: a capture mailbox the live loop takes the newest
frame from; `video`: batches of a recording) and what the frames show:

- `period`: distinct frames in the cycle the feed repeats;
- `wave`: `saw` (phase = frame index) or `triangle` (phase rises by `step`
  to `amplitude`, then falls back, so the cycle is continuous);
- `lines`: marker lines, each `p0` and `p1` in map-ROI pixels at 1080p and
  `v0`, `v1` the pixels each end moves per unit of phase;
- `legend`: the scale label `text` at (`x`, `y`) in BRQ pixels, its bar
  `bar_dy` rows below and `bar_w` wide, moving `v` per unit of phase
  (`bar_dy` does not scale: the label's glyphs do not); `text` and `bar_w`
  may each be a list, one entry per position of the cycle, modulo its
  length, so the scale changes from frame to frame;
- `patch` (optional): a white block (`x`, `y`, `w`, `h`) in the BRQ whose row
  moves by phase modulo `y_mod`, so every frame changes the legend's corner;
- `shift`: the seed moves the whole drawing by up to this many pixels in x
  and y and picks the cycle's first frame; the work (lengths, counts) is the
  same for every seed;
- feed parameters: `fps_cap` (live: the loop's frame rate, as the app
  caps it; null = uncapped, a closed loop), `batch` and `depth` (video).

Coordinates scale with the screen: k = width // 1920 (2 at 4K), as the game
scales its map; glyphs stay at FONT_PX.
"""

from __future__ import annotations

import json
import math
import pathlib

import numpy as np

from . import frames as F

HERE = pathlib.Path(__file__).resolve().parent


def load(name: str) -> dict:
    """The parameters of traffic mix `name`."""
    path = HERE / "traffic" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} at {path}")
    return json.loads(path.read_text())


def phase(t: dict, i: int) -> int:
    """The phase of frame i of the cycle."""
    if t.get("wave", "saw") == "saw":
        return i * t.get("step", 1)
    p = (i * t["step"]) % (2 * t["amplitude"])
    return p if p <= t["amplitude"] else 2 * t["amplitude"] - p


def _at(xy, v, ph: int, k: int, shift) -> tuple:
    return tuple(k * (int(c) + math.floor(dv * ph) + s) for c, dv, s in zip(xy, v, shift))


def scene(t: dict, w: int, h: int, seed: int) -> dict:
    """What the seed fixes: the drawing's shift and the cycle's first frame."""
    rng = np.random.default_rng(seed)
    s = int(t.get("shift", 0))
    shift = tuple(int(v) for v in rng.integers(-s, s + 1, size=2)) if s else (0, 0)
    start = int(rng.integers(0, t["period"]))
    return {"k": max(1, w // 1920), "shift": shift, "start": start, "w": w, "h": h}


def lines_of(t: dict, sc: dict, i: int) -> list:
    """The marker lines of cycle frame i, in map-ROI pixels."""
    ph = phase(t, (sc["start"] + i) % t["period"])
    return [(_at(ln["p0"], ln.get("v0", (0, 0)), ph, sc["k"], sc["shift"]),
             _at(ln["p1"], ln.get("v1", (0, 0)), ph, sc["k"], sc["shift"])) for ln in t.get("lines", ())]


def _nth(v, j: int):
    """v, or its entry for cycle position j where v is a list."""
    return v[j % len(v)] if isinstance(v, list) else v


def legend_of(t: dict, i: int, start: int = 0) -> tuple:
    """(label text, bar width at 1080p) of cycle frame i."""
    lg, j = t["legend"], (start + i) % t["period"]
    return _nth(lg["text"], j), _nth(lg["bar_w"], j)


def frame(t: dict, sc: dict, i: int, base: np.ndarray = None) -> np.ndarray:
    """Cycle frame i (BGRA u8), drawn into a copy of `base` when given (the
    background and the button, drawn once per run)."""
    k, shift = sc["k"], sc["shift"]
    ph = phase(t, (sc["start"] + i) % t["period"])
    out = base.copy() if base is not None else F.background(sc["w"], sc["h"])
    F.draw_lines(out, lines_of(t, sc, i))
    lg = t.get("legend")
    if lg:
        tx, ty = _at((lg["x"], lg["y"]), lg.get("v", (0, 0)), ph, k, shift)
        text, bar_w = legend_of(t, i, sc["start"])
        F.draw_legend(out, text, tx, ty, (tx, ty + lg["bar_dy"], k * bar_w))
    pt = t.get("patch")
    if pt:
        F.draw_patch(out, k * pt["x"], k * pt["y"] + ph % pt["y_mod"], k * pt["w"], k * pt["h"])
    return out


def cycle(t: dict, w: int, h: int, seed: int) -> list:
    """The distinct frames of one cycle for `seed`, in the order offered."""
    sc = scene(t, w, h, seed)
    base = F.background(w, h)
    return [frame(t, sc, i, base) for i in range(t["period"])]
