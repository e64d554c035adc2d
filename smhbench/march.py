"""What the readers of the cuda line search share: its spans and counters,
and the yardstick of its ray march (kernel 4).

With the `lsd_engine` setting "cuda", the program scans the marker mask
for seeds on the host (`lsd.scan`, once an update), marches each batch of
seeds on the card (`lsd.march`: the seeds' upload and the launch) and waits
for the winners' copy back (`lsd.march_wait`); `CudaBackend.stats` counts
the batches (`lsd_marches`) and their seeds (`lsd_seeds_marched`). Each
function returns None where the run holds nothing to read (a program
without the engine's spans or counters); a cell on the native engine
reads None or 0.

The march's operations: every seed marches LSD_NUM_ANGLES rays, each ray
at least LSD_MAX_GAP + 2 samples (its run of max_gap + 1 black samples and
the step past it; the steps along a line depend on the mask and are left
out), each sample OPS_PER_SAMPLE float32 operations (two multiplies and
two adds for the position, four compares for the plane, two casts), as
the kernel table in PERF.md counts kernel 4. The seeds are the program's
counter, so the share is the least time those seeds could take at the
card's peak over the time the kernel took.
"""

from __future__ import annotations

from . import readers, spans
from .reference import consts as C

# NVIDIA's H100 SXM data sheet at 700 W: float32 operations per second
# outside the tensor cores.
OPS_PER_S = 67e12
OPS_PER_SAMPLE = 10
OPS_PER_SEED = OPS_PER_SAMPLE * int(C.LSD_NUM_ANGLES) * (int(C.LSD_MAX_GAP) + 2)
KERNEL = "ray_march_kernel"  # the profiled rows' short name (profile._short)
MARCHES = ("lsd.march", "lsd.march_wait")


def _scans(run):
    """(the ring's records, the `lsd.scan` spans begun in the window), or None."""
    recs = spans.records(run)
    scans = spans.began(run, recs, "lsd.scan") if recs else []
    return (recs, scans) if scans else None


def scan_ms(run):
    """The host's own part of the seed scan: `lsd.scan` less the marches
    and waits under it, mean per update that scanned (ms)."""
    got = _scans(run)
    if got is None:
        return None
    recs, scans = got
    return (spans.wall_ms(scans) - spans.wall_ms(spans.children(recs, scans, MARCHES))) / len(scans)


def march_wait_ms(run):
    """Σ `lsd.march_wait` under the scans, mean per update that scanned (ms)."""
    got = _scans(run)
    if got is None:
        return None
    recs, scans = got
    return spans.wall_ms(spans.children(recs, scans, "lsd.march_wait")) / len(scans)


def per_update(run, key: str):
    """A counter of CudaBackend.stats over the window per frame consumed."""
    st = run.counters["stats"]
    return st[key] / st["frames"] if key in st and st.get("frames") else None


def _rows(run) -> list:
    return [(a, b) for s in run.slices for name, a, b, kind in s["rows"] if kind == "kernel" and name == KERNEL]


def us_per_update(run):
    """The ray march's kernel time in the profiled slices per frame whose
    pass ran in them (us)."""
    rows = _rows(run)
    frames = sum(readers._frames(run, s) for s in run.slices)
    return 1e6 * sum(b - a for a, b in rows) / frames if rows and frames else None


def roofline(run):
    """Kernel 4's share of its operation bound: the launches in the
    profiled slices times the window's seeds per launch times OPS_PER_SEED,
    at OPS_PER_S, over the time the launches took (%)."""
    rows = _rows(run)
    st = run.counters["stats"]
    if not rows or not st.get("lsd_marches"):
        return None
    seeds = len(rows) * st["lsd_seeds_marched"] / st["lsd_marches"]
    return 100.0 * seeds * OPS_PER_SEED / OPS_PER_S / sum(b - a for a, b in rows)
