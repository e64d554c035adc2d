"""Per-stage wall-clock "timeshares" for the vision pipeline.

Counterpart of the reference's Timeshares struct + debug_waterfall! guard
(/root/reference/vision-common/src/debug.rs:3-29,
 /root/reference/src/vision/mod.rs:14-20,54-64). Stage names and legend
colors match so a UI can render the same waterfall.

The same timing is the port's span recorder. Every `timeshare` stage and
every `span` of the host half also appends one record to a process-wide
bounded ring (`RING`): (id, name, kind, frame, parent, thread, start, end,
cpu), `start` and `end` read from `time.perf_counter()`. `parent` is the id
of the innermost span open on the same thread; `frame` is the id the loop
gives a frame when it takes it (or a batch at submit), inherited from the
parent when not given; `cpu` is the thread's CPU seconds inside the span
(spans opened with cpu=True), else None. `kind` is WORK (the host
computes), WAIT (a thread blocks on a sleep, a queue or an event) or QUEUE
(an item's time in a queue, which belongs to no thread). Names are
"layer.stage": `vision.crop_to_map` is the timeshare stage `crop_to_map`.

SMH_TRACE=0 turns the ring off; a span then costs one flag test beside its
perf_counter pair. `write_chrome_trace` is the ring's one writer.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import Dict, Iterator, Optional, Tuple

STAGES: Dict[str, Tuple[float, float, float]] = {
    "load_frame": (0.0, 1.0, 1.0),
    "crop_to_map": (1.0, 0.4, 0.0),
    "find_minimap": (0.0, 0.0, 1.0),
    "ocr_preprocess": (0.0, 0.35, 1.0),
    "ocr": (0.35, 0.0, 1.0),
    "find_scales_preprocess": (1.0, 0.0, 1.0),
    "calc_meters_to_px_ratio": (1.0, 0.0, 0.4),
    "isolate_map_markers": (0.0, 1.0, 0.0),
    "filter_map_marker_icons": (1.0, 0.65, 0.0),
    "mask_marker_lines": (1.0, 1.0, 0.0),
    "find_marker_lines": (1.0, 0.0, 0.0),
}


class Timeshares:
    """Mutable per-frame stage timing record (seconds)."""

    def __init__(self) -> None:
        self.entire_frame: Optional[float] = None
        self.stages: Dict[str, float] = {}

    def record(self, stage: str, seconds: float) -> None:
        self.stages[stage] = seconds

    def iter(self) -> Iterator[Tuple[str, Tuple[float, float, float], float]]:
        for name, color in STAGES.items():
            if name in self.stages:
                yield name, color, self.stages[name]

    def as_dict(self) -> Dict[str, float]:
        d = dict(self.stages)
        if self.entire_frame is not None:
            d["entire_frame"] = self.entire_frame
        return d


ENABLED = os.environ.get("SMH_TRACE", "1") != "0"
CAPACITY = 1 << 17
WORK, WAIT, QUEUE = "work", "wait", "queue"

Record = collections.namedtuple("Record", "id name kind frame parent thread start end cpu")
_START, _END = Record._fields.index("start"), Record._fields.index("end")


class Ring:
    """A bounded ring of span records, oldest evicted first. Appends take
    no lock (a deque's append is atomic); only eviction, once the ring is
    full, takes one, so `dropped` counts every record evicted."""

    def __init__(self, capacity: int = CAPACITY) -> None:
        self.capacity = capacity
        self.dropped = 0
        self.evicted_until = float("-inf")  # the latest end among evicted records
        self.threads: Dict[int, str] = {}  # thread ident -> name
        self._records: collections.deque = collections.deque()
        self._evict = threading.Lock()

    def append(self, rec: tuple) -> None:
        d = self._records
        d.append(rec)
        if len(d) > self.capacity:
            with self._evict:
                while len(d) > self.capacity:
                    self.evicted_until = max(self.evicted_until, d.popleft()[_END])
                    self.dropped += 1

    def records(self, t0: Optional[float] = None, t1: Optional[float] = None) -> list:
        """Records whose span overlaps [t0, t1] (None: unbounded), in the
        order they ended."""
        return [
            Record._make(r) for r in list(self._records)
            if (t0 is None or r[_END] >= t0) and (t1 is None or r[_START] <= t1)
        ]


RING = Ring()
_ids = itertools.count(1)
_frames = itertools.count(1)
_local = threading.local()


def new_frame() -> int:
    """A fresh frame (or batch) id, unique in the process."""
    return next(_frames)


def _stack() -> list:
    """This thread's open spans, innermost last."""
    try:
        return _local.stack
    except AttributeError:
        t = threading.current_thread()
        RING.threads[t.ident] = t.name
        _local.stack = []
        return _local.stack


class span:
    """Context manager timing a block as one record of the ring; `seconds`
    is its wall time once it has closed, whether or not tracing is on.
    cpu=True also reads time.thread_time() at its start and end."""

    __slots__ = ("name", "kind", "frame", "cpu", "start", "end", "_id", "_parent", "_cpu0", "_shares", "_stage")

    def __init__(self, name: str, kind: str = WORK, frame: Optional[int] = None, cpu: bool = False) -> None:
        self.name, self.kind, self.frame, self.cpu = name, kind, frame, cpu
        self._shares: Optional[Timeshares] = None
        self._id = None

    def __enter__(self) -> "span":
        if ENABLED:
            stack = _stack()
            if stack:
                top = stack[-1]
                self._parent = top._id
                if self.frame is None:
                    self.frame = top.frame
            else:
                self._parent = None
            self._id = next(_ids)
            stack.append(self)
            self._cpu0 = time.thread_time() if self.cpu else None
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.end = end = time.perf_counter()
        if self._shares is not None:
            self._shares.record(self._stage, end - self.start)
        if self._id is not None:
            cpu = time.thread_time() - self._cpu0 if self._cpu0 is not None else None
            _local.stack.pop()
            RING.append((self._id, self.name, self.kind, self.frame, self._parent, threading.get_ident(),
                         self.start, end, cpu))

    @property
    def seconds(self) -> float:
        return self.end - self.start


def add(name: str, kind: str, start: float, end: float, frame: Optional[int] = None) -> None:
    """Record an interval the caller timed on time.perf_counter: a queue's
    wait, or a wait that spans several polls. A QUEUE record has no thread
    and no parent; any other takes this thread's innermost open span as
    its parent."""
    if not ENABLED:
        return
    parent = thread = None
    if kind != QUEUE:
        stack = _stack()
        thread = threading.get_ident()
        if stack:
            parent = stack[-1]._id
            if frame is None:
                frame = stack[-1].frame
    RING.append((next(_ids), name, kind, frame, parent, thread, start, end, None))


_STAGE_SPANS = {stage: f"vision.{stage}" for stage in STAGES}


def timeshare(shares: Optional[Timeshares], stage: str) -> span:
    """Context manager recording elapsed wall time into `shares` (when
    given) and the span `vision.<stage>`."""
    s = span(_STAGE_SPANS.get(stage) or f"vision.{stage}")
    s._shares, s._stage = shares, stage
    return s


def write_chrome_trace(path: str, ring: Optional[Ring] = None) -> int:
    """Write the ring (default RING) as Chrome trace-event JSON (Perfetto
    and chrome://tracing open it): one "X" event a record, in microseconds,
    a track per thread and one per queue, the frame id in `args.frame`.
    -> the number of events written."""
    ring = RING if ring is None else ring
    tids: Dict[object, int] = {}
    names: Dict[int, str] = {}
    events = []
    pid = os.getpid()
    for r in ring.records():
        key = r.thread if r.thread is not None else ("queue", r.name)
        tid = tids.setdefault(key, len(tids) + 1)
        names.setdefault(tid, ring.threads.get(r.thread, str(r.thread)) if r.thread is not None else r.name)
        args = {"frame": r.frame, "id": r.id, "parent": r.parent}
        if r.cpu is not None:
            args["cpu_us"] = r.cpu * 1e6
        events.append({"name": r.name, "cat": r.kind, "ph": "X", "ts": r.start * 1e6,
                       "dur": (r.end - r.start) * 1e6, "pid": pid, "tid": tid, "args": args})
    meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid, "args": {"name": name}}
            for tid, name in names.items()]
    with open(path, "w") as f:
        json.dump({"traceEvents": meta + events, "displayTimeUnit": "ms",
                   "otherData": {"dropped": ring.dropped}}, f)
    return len(events)
