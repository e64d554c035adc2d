"""What the per-layer metrics' readers share: means over the window, and
the device's slices reduced to kernel time, busy time and roofline.

Each reader returns None where its run holds nothing to read."""

from __future__ import annotations

from . import yardstick as Y
from .harness import STAGES


def stage_ms(run, stage: str):
    """Mean DebugBox time of a stage per update of the window (ms), counting
    0 where the update did not run it."""
    if not run.updates:
        return None
    k = STAGES.index(stage)
    return 1e3 * sum(u[3][k] for u in run.updates) / len(run.updates)


def latency_ms(run, q: float):
    """The q-quantile of frame -> update over every update of the window (ms)."""
    return Y.quantile([u[2] for u in run.updates], q) if run.updates else None


def screen_ms(run, field: int):
    """Screen -> update (field 4) or screen -> take (field 5) of every
    update of the window whose frame the benchmark's source stamped (ms)."""
    return [u[field] for u in run.updates if u[field] is not None]


def span_ms(run, kind: str):
    """Mean length of the benchmark's spans of one kind begun in the window (ms)."""
    spans = run.spans_in(kind)
    return 1e3 * sum(b - a for a, b in spans) / len(spans) if spans else None


def _frames(run, s: dict) -> int:
    """Frames whose pass ran in a slice: one hostpack launch a frame or a batch."""
    passes = sum(1 for name, _, _, kind in s["rows"] if kind == "kernel" and name == "hostpack_kernel")
    return passes * run.counters.get("batch", 1)


def kernel_us_per_frame(run):
    """Kernel time on the card per frame in the profiled slices (us)."""
    frames = sum(_frames(run, s) for s in run.slices)
    if not frames:
        return None
    return 1e6 * sum(b - a for s in run.slices for _, a, b, kind in s["rows"] if kind == "kernel") / frames


def device_idle_pct(run):
    """The share of the profiled slices in which nothing ran on the card (%)."""
    window = sum(s["hi"] - s["lo"] for s in run.slices)
    if window <= 0:
        return None
    busy = sum(Y.union_s([(a, b) for _, a, b, _ in s["rows"]], s["lo"], s["hi"]) for s in run.slices)
    return 100.0 * (1.0 - busy / window)


def pass_roofline(run):
    """The fused pass's kernels' share of their byte bound: the least time
    their launches could take at the peak rate over the kernel time they
    took (%). Kernels the yardstick does not count add time and no bytes."""
    route, b = run.cfg["route"], run.counters.get("batch", 1)
    least, took = 0.0, 0.0
    for s in run.slices:
        for name, a, t, kind in s["rows"]:
            if kind != "kernel":
                continue
            took += t - a
            nbytes = Y.kernel_bytes(name[: -len("_kernel")] if name.endswith("_kernel") else name, run.shapes,
                                    route, b)
            if nbytes is not None:
                least += Y.bound_s(nbytes)
    return 100.0 * least / took if least > 0 else None
