"""The comparison that decides `correct`: served answers against the reference.

The reference's answers are computed once per distinct frame, after the
window has closed, in worker processes that draw the frames again from the
seed (the traffic is deterministic), so no frame crosses a process and the
program's process keeps its memory peak. Each number compared has a limit
in `smhbench/limits/<workload>.json`; PERF.md gives the readings each limit
was set from.
"""

from __future__ import annotations

import json
import math
import multiprocessing
import pathlib

import numpy as np

from . import reference as R
from . import traffic as T

HERE = pathlib.Path(__file__).resolve().parent


def _one(args) -> tuple:
    name, w, h, seed, i, dpi, detect = args
    t = T.load(name)
    return R.run(T.frame(t, T.scene(t, w, h, seed), i), dpi, detect)


def answers(traffic_name: str, w: int, h: int, seed: int, idxs, dpi, detect: bool, workers: int,
            cache: dict = None) -> dict:
    """{cycle index: (Answer, needs)} for the frames `idxs` of the cycle;
    `cache`, where given, keeps them for the next run of the same frames."""
    jobs = [(traffic_name, w, h, seed, i, dpi, detect) for i in sorted(set(idxs))]
    todo = [j for j in jobs if cache is None or j not in cache]
    if workers <= 1 or len(todo) <= 1:
        out = list(map(_one, todo))
    else:
        pool = multiprocessing.get_context("spawn").Pool(min(workers, len(todo)))
        try:
            out = pool.map(_one, todo, chunksize=1)
        finally:
            pool.close()
            pool.join()
    done = dict(zip(todo, out))
    if cache is not None:
        cache.update(done)
        done = cache
    return {j[4]: done[j] for j in jobs}


def limits(workload: str) -> dict:
    """{number: limit} of a cell."""
    return json.loads((HERE / "limits" / f"{workload}.json").read_text())


def _diagonal(w: int, h: int) -> float:
    return math.hypot(w, h)


def marker_gap(got: R.Answer, want: R.Answer, far: float) -> float:
    """The widest distance between a served line's end and the reference's
    (lines in the order the seed scan finds them); `far` where the number
    of lines or the sleeping state differ."""
    if got.sleeping != want.sleeping or len(got.markers) != len(want.markers):
        return far
    gap = 0.0
    for a, b in zip(got.markers, want.markers):
        for p, q in zip(a, b):
            gap = max(gap, math.hypot(p[0] - q[0], p[1] - q[1]))
    return gap


def ratio_gap(got: R.Answer, want: R.Answer) -> float:
    """|served - reference| / reference of the meters-to-px ratio; 1 where
    only one side has a ratio."""
    if got.ratio is None or want.ratio is None:
        return 0.0 if got.ratio is None and want.ratio is None else 1.0
    return abs(got.ratio - want.ratio) / abs(want.ratio)


def minimap_gap(got: R.Answer, want: R.Answer, far: float) -> float:
    """The widest difference of the minimap bounds' sides (px); `far` where
    only one side found the minimap."""
    if got.minimap is None or want.minimap is None:
        return 0.0 if got.minimap is None and want.minimap is None else far
    return float(max(abs(a - b) for a, b in zip(got.minimap, want.minimap)))


def numbers(served, refs: dict, screen, counts: dict) -> dict:
    """The numbers compared: the widest gaps over every served answer whose
    frame the reference read, then the counts of the guarantees."""
    from .reference import consts as C

    g = C.map_geometry(*screen)
    far = _diagonal(g.map_w, g.map_h)
    gaps = {"marker_gap_px": 0.0, "ratio_gap": 0.0, "minimap_gap_px": 0.0}
    compared = 0
    for idx, got in served:
        if idx not in refs:
            continue
        want = refs[idx][0]
        compared += 1
        gaps["marker_gap_px"] = max(gaps["marker_gap_px"], marker_gap(got, want, far))
        gaps["ratio_gap"] = max(gaps["ratio_gap"], ratio_gap(got, want))
        gaps["minimap_gap_px"] = max(gaps["minimap_gap_px"], minimap_gap(got, want, far))
    if compared == 0:
        gaps = {k: far if k != "ratio_gap" else 1.0 for k in gaps}
    return {**gaps, **counts, "compared": compared}


def judge(nums: dict, lim: dict) -> tuple:
    """(correct, [(name, number, limit)]) over the numbers the cell limits."""
    rows = [(k, nums[k], lim[k]) for k in lim]
    return all(v <= l for _, v, l in rows), rows


def sample(n: int, k: int, seed: int) -> list:
    """k of the cycle's n frames, drawn from the seed."""
    if k >= n:
        return list(range(n))
    return sorted(int(i) for i in np.random.default_rng([seed, 7]).choice(n, size=k, replace=False))
