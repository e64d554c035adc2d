"""What the readers of the program's own spans share.

smh_tpu_torch records its host half's spans in a process-wide ring
(`smh_tpu_torch.utils.timeshares.RING`) on time.perf_counter, the clock the
benchmark's window and the profiled slices' device rows are on; the readers
read it in the process that ran the cell, once the run has ended. Each
function returns None where the program keeps no such ring (a tree before
it), where it is off (SMH_TRACE=0) and so holds nothing of the run, or
where the ring evicted a record the reading needs.

The device's idle time in the profiled slices is split by what the host
was doing: "feeding" while a work span directly under a submit span
(`vision.submit`, `batch.submit`) is open, "blocked" while the submitter
waits on a full queue (`loop.queue_put`, `batch.queue_put`) and no
feeding span is open.
"""

from __future__ import annotations

from . import yardstick as Y

SUBMITS = ("vision.submit", "batch.submit")
FETCH_WAITS = ("vision.fetch_wait", "batch.fetch_wait")
PUTS = ("loop.queue_put", "batch.queue_put")


def records(run, since=None):
    """The ring's records that end at or after the window's start (or at
    or after `since`; since=float("-inf") reads from the process's start),
    or None."""
    try:
        from smh_tpu_torch.utils import timeshares
    except ImportError:
        return None
    ring = getattr(timeshares, "RING", None)
    if ring is None:
        return None
    t0 = run.t0 if since is None else since
    if ring.dropped and ring.evicted_until >= t0:
        return None
    recs = ring.records(None if since == float("-inf") else t0)
    return recs or None


def began(run, recs: list, names) -> list:
    """The records of `names` (a name or a tuple of names) that began in the window."""
    names = (names,) if isinstance(names, str) else names
    return [r for r in recs if r.name in names and run.t0 <= r.start < run.t1]


def children(recs: list, parents: list, names) -> list:
    """The records of `names` whose parent is one of `parents`."""
    names = (names,) if isinstance(names, str) else names
    ids = {p.id for p in parents}
    return [r for r in recs if r.name in names and r.parent in ids]


def wall_ms(rs: list) -> float:
    return 1e3 * sum(r.end - r.start for r in rs)


def offcpu_ms(rs: list):
    """Σ (wall − the thread's CPU time) of records that read the CPU time (ms), or None."""
    rs = [r for r in rs if r.cpu is not None]
    return 1e3 * sum(r.end - r.start - r.cpu for r in rs) if rs else None


def mean_ms(run, name: str):
    """Mean length of the spans `name` begun in the window (ms)."""
    recs = records(run)
    rs = began(run, recs, name) if recs else []
    return wall_ms(rs) / len(rs) if rs else None


def per_submit_ms(run, names, offcpu: bool = False):
    """Σ of the spans `names` under each submit begun in the window, mean
    per submit (ms): their wall time, or with offcpu their wall time less
    the thread's CPU time."""
    recs = records(run)
    subs = began(run, recs, SUBMITS) if recs else []
    if not subs:
        return None
    rs = children(recs, subs, names)
    total = offcpu_ms(rs) if offcpu else wall_ms(rs)
    return None if total is None else total / len(subs)


def per_frame_ms(run, names, offcpu: bool = False):
    """Σ of the spans `names` begun in the window per frame submitted in it (ms)."""
    n = run.counters.get("frames_in")
    recs = records(run)
    if not n or not recs:
        return None
    rs = began(run, recs, names)
    total = offcpu_ms(rs) if offcpu else wall_ms(rs)
    return None if total is None or not rs else total / n


def d2h_per_frame(run, frames: str):
    """Bytes copied device -> host per frame: the program's `d2h_bytes`
    over the window ÷ the count `frames` (a stats key, or a counter)."""
    st = run.counters["stats"]
    n = st.get(frames, run.counters.get(frames))
    return st["d2h_bytes"] / n if "d2h_bytes" in st and n else None


def idle_split(run):
    """(feeding %, blocked %) of the device's idle time in the profiled
    slices, or None."""
    recs = records(run)
    if not recs or not run.slices:
        return None
    subs = {r.id for r in recs if r.name in SUBMITS}
    feeding = [(r.start, r.end) for r in recs if r.kind == "work" and r.parent in subs]
    blocked = [(r.start, r.end) for r in recs if r.name in PUTS]
    idle = feed = either = 0.0
    for s in run.slices:
        lo, hi = s["lo"], s["hi"]
        f = [(a, b) for a, b in feeding if b > lo and a < hi]
        fb = f + [(a, b) for a, b in blocked if b > lo and a < hi]
        for g0, g1 in Y.gaps([(a, b) for _, a, b, _ in s["rows"]], lo, hi):
            idle += g1 - g0
            feed += Y.union_s(f, g0, g1)
            either += Y.union_s(fb, g0, g1)
    if idle <= 0:
        return None
    return 100.0 * feed / idle, 100.0 * (either - feed) / idle


def setup_kernels_s(run):
    """The kernel library's lookup or build and its dlopen (s): the union
    of the `setup.kernels` spans before the window."""
    recs = records(run, since=float("-inf"))
    rs = [(r.start, r.end) for r in recs or [] if r.name == "setup.kernels" and r.start < run.t0]
    return Y.union_s(rs, min(a for a, _ in rs), run.t0) if rs else None


def setup_first_pass_s(run):
    """The process's first frame (or batch): its submit's start to the end
    of its fetch wait (s)."""
    recs = records(run, since=float("-inf"))
    subs = sorted((r for r in recs or [] if r.name in SUBMITS), key=lambda r: r.start)
    if not subs:
        return None
    first = subs[0]
    waits = [r.end for r in recs if r.name in FETCH_WAITS and r.frame == first.frame]
    return min(waits) - first.start if waits else None
