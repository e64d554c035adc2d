"""The generator: the same seed gives the same frames, each seed the same
work, and every frame of a cycle is its own."""

import numpy as np
import pytest

from smhbench import traffic as T
from smhbench.reference import consts as C

SCREENS = {"drag": (1920, 1080), "pan": (1920, 1080), "video": (1920, 1080)}
SEED = 2**31 + 9


@pytest.mark.parametrize("name", sorted(SCREENS))
def test_the_same_seed_gives_the_same_frames(name):
    t = T.load(name)
    a, b = T.cycle(t, *SCREENS[name], SEED), T.cycle(t, *SCREENS[name], SEED)
    assert len(a) == t["period"] and all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", sorted(SCREENS))
def test_frames_of_a_cycle_change_every_frame(name):
    """Each frame differs from the one before it, the cycle's wrap too (the
    capture publishes only a changed frame); a live cycle's frames are all
    distinct, a triangle wave's repeat on the way back."""
    t = T.load(name)
    fr = T.cycle(t, *SCREENS[name], SEED)
    assert all(not np.array_equal(a, b) for a, b in zip(fr, fr[1:] + fr[:1]))
    distinct = len({f.tobytes() for f in fr})
    assert distinct == (len(fr) if t["wave"] == "saw" else t["amplitude"] // t["step"] + 1)


@pytest.mark.parametrize("name", sorted(SCREENS))
def test_every_seed_gets_the_same_work(name):
    """Another seed moves the drawing and the cycle's first frame: the same
    frames' marker pixels, in another place and order."""
    t = T.load(name)
    w, h = SCREENS[name]
    g = C.map_geometry(w, h)

    def marker_px(fr) -> int:
        roi = fr[g.map_y : g.map_y + g.map_h, g.map_x : g.map_x + g.map_w]
        return int(((roi[..., 1] == 255) & (roi[..., 2] == 64)).sum())

    a = sorted(marker_px(f) for f in T.cycle(t, w, h, 1))
    b = sorted(marker_px(f) for f in T.cycle(t, w, h, 2**31 + 5))
    assert a == b
    assert T.scene(t, w, h, 1) != T.scene(t, w, h, 2**31 + 5)


def test_the_pans_scale_changes_from_every_frame_to_the_next():
    """Each frame of the pan's cycle, its wrap too, has another label or bar,
    so another meters-to-px ratio."""
    t = T.load("pan")
    legends = [T.legend_of(t, i) for i in range(t["period"])]
    ratios = [int(text[:-1]) / w for text, w in legends]
    assert all(a != b for a, b in zip(ratios, ratios[1:] + ratios[:1]))
    assert T.legend_of(t, 0, start=1) == legends[1]


def test_large_seeds_are_taken():
    t = T.load("drag")
    sc = T.scene(t, 3840, 2160, 2**33 + 1)
    assert sc["k"] == 2 and abs(sc["shift"][0]) <= t["shift"] and 0 <= sc["start"] < t["period"]


def test_the_triangle_wave_keeps_the_cycle_continuous():
    t = T.load("video")
    ph = [T.phase(t, i) for i in range(t["period"] + 1)]
    assert ph[0] == ph[-1] == 0 and max(ph) == t["amplitude"]
    assert all(abs(a - b) == t["step"] for a, b in zip(ph, ph[1:]))


def test_lines_stay_inside_the_map_at_every_seed_shift():
    for name, (w, h) in {"drag": (3840, 2160), "pan": (1920, 1080), "video": (3840, 2160)}.items():
        t = T.load(name)
        g = C.map_geometry(w, h)
        for sx in (-t["shift"], t["shift"]):
            for sy in (-t["shift"], t["shift"]):
                sc = {"k": max(1, w // 1920), "shift": (sx, sy), "start": 0, "w": w, "h": h}
                for i in range(t["period"]):
                    for p in sum(map(list, T.lines_of(t, sc, i)), []):
                        assert 0 <= p[0] < g.map_w and 0 <= p[1] < g.map_h, (name, sx, sy, i, p)
