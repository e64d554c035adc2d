"""One run of one cell: set-up, the measured window, the comparison, the line.

The cell's configuration (`configs/<name>.json`), traffic mix
(`traffic/<name>.json`) and per-layer metrics (`metrics/<name>.py`) are
found by the names `BENCHMARK.json` gives. Two feeds offer the frames to
smh_tpu_torch's own entry points:

- `live`: `VisionLoop(pipelined=True, threaded_submit=True)` over a
  `VisionState` (the `CudaBackend`), fed by a `CaptureThread` around the
  cycle of frames, as the app runs it, at the traffic's `fps_cap` (the
  app's 15 FPS). The warm-up runs uncapped; the cap holds from CAP_LEAD
  updates before the window opens, so no frame queued by the warm-up is in
  it. An update's latency runs from the loop taking its frame out of the
  mailbox to `on_update` with its result; what a player waits runs from
  the screen's read, stamped when the benchmark's source is grabbed, to
  the same update.
- `video`: `BatchPipeline(batch).stream(depth=...)` over batches of the
  cycle, as `tools/analyze_video` runs it. Its end-to-end metric is the
  card's time a frame, its kernels' and copies', read from profiled slices
  of the window in every run; the frames per second are per-layer.

Set-up runs from the process's start to the first timed frame, less the
drawing of the traffic: imports, the kernels' build (cached in the
checkout), the backend and warm frames of the cell's own shapes. The window
then runs `seconds` by the host clock; rates and percentiles are taken over
every update in it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import logging
import os
import pathlib
import sys
import threading
import time

from . import compare
from . import profile as P
from . import reference as R
from . import traffic as T
from . import yardstick as Y

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "smh_tpu")
WARM_UPDATES = 96  # live: past the transports' re-probe (30 fitting frames) three times
CAP_LEAD = 8  # live: updates before the window at the traffic's cap (a depth-3 queue drains in 3)
WARM_LAPS = 2  # video: laps of the cycle before the window
SETUP_TIMEOUT_S = 900  # the first run in a checkout builds the kernels
DRAIN_S = 60  # a minute past the close for answers still due
QUIET_S = 3.0  # no answer for this long ends the drain early
SLICES, SLICE_S = 3, 2.0  # profiled slices of a traced or video window, each at the middle of its third
REF_SAMPLE = 16  # frames of a video cycle the reference reads, drawn from the seed
REF_WORKERS = 4
STAGES = ("crop_to_map", "find_marker_lines", "ocr")  # the DebugBox stages an update keeps
FAULTS = ("stale", "stale_ratio", "frozen", "half", "altered")

clock = time.perf_counter


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    path = HERE / "configs" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no configuration {name!r} at {path}")
    return json.loads(path.read_text())


def reader(name: str):
    """The `read(run)` function of per-layer metric `name`."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"smhbench.metrics.{name}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def in_cell(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def apply_environment(cfg: dict) -> None:
    """The configuration's environment and thread counts: set before torch
    is imported, the same for every run of the cell."""
    for k, v in cfg.get("env", {}).items():
        os.environ[k] = str(v)
    n = str(cfg["threads"]["omp"])
    for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[k] = n


class ErrorCount(logging.Handler):
    """ERROR records of the program: the loop logs and drops a failing frame."""

    def __init__(self) -> None:
        super().__init__(level=logging.ERROR)
        self.messages: list = []

    def emit(self, record) -> None:
        self.messages.append(record.getMessage())


class Fault:
    """A fault planted where the answers are produced, for the control and
    the tests: `stale` serves each frame the previous frame's answer,
    `stale_ratio` each frame's own markers and minimap with the previous
    frame's ratio (a scales read skipped or a band left unchanged),
    `frozen` the first answer for ever, `half` leaves out every other
    answer (the second half of each batch), `altered` shrinks the ratio as
    a 300 m bar read one pixel wider would and moves each line's far end
    by 2 px."""

    def __init__(self, kind) -> None:
        if kind not in (None, *FAULTS):
            raise ValueError(f"unknown fault {kind!r}")
        self.kind, self.prev, self.first, self.n = kind, None, None, 0

    def __call__(self, ans, batch_pos: int = 0, batch: int = 1):
        """The answer to serve in place of `ans`, or None to leave it out."""
        k, self.n = self.kind, self.n + 1
        if k == "stale":
            out, self.prev = self.prev or ans, ans
            return out
        if k == "stale_ratio":
            prev, self.prev = self.prev or ans, ans
            return dataclasses.replace(ans, ratio=prev.ratio)
        if k == "frozen":
            self.first = self.first or ans
            return self.first
        if k == "half":
            return None if (batch_pos >= batch // 2 if batch > 1 else self.n % 2 == 0) else ans
        if k == "altered" and not ans.sleeping:
            ratio = None if ans.ratio is None else ans.ratio / (1 + ans.ratio / 300.0)
            lines = tuple((p0, (p1[0] + 2.0, p1[1])) for p0, p1 in ans.markers)
            return dataclasses.replace(ans, ratio=ratio, markers=lines)
        return ans


def answer_of(markers, ratio, minimap, sleeping: bool) -> R.Answer:
    if sleeping:
        return R.Answer(True, (), None, None)
    rect = None if minimap is None else (minimap.left, minimap.top, minimap.right, minimap.bottom)
    return R.Answer(False, tuple(((l.p0.x, l.p0.y), (l.p1.x, l.p1.y)) for l in markers), ratio, rect)


def make_engine(cfg: dict):
    """The configuration's OCR reader: `engine.reader` names a class of the
    program as "module:Class"; `engine.flags` override its transport flags."""
    import importlib

    eng = cfg["engine"]
    module, _, cls = eng["reader"].partition(":")
    if module.split(".")[0] != "smh_tpu_torch" or not cls:
        raise ValueError(f"reader {eng['reader']!r} is not a class of smh_tpu_torch (module:Class)")
    reader_cls = getattr(importlib.import_module(module), cls)
    if eng.get("flags"):
        reader_cls = type("FlaggedReader", (reader_cls,), dict(eng["flags"]))
    return reader_cls()


def set_options(obj, options: dict, what: str) -> None:
    """Set a configuration's options on an object of the program, each an
    attribute it already has."""
    for k, v in options.items():
        if not hasattr(obj, k):
            raise AttributeError(f"{what} has no option {k!r}")
        setattr(obj, k, v)


@dataclasses.dataclass
class Run:
    """What a run recorded, for the per-layer readers."""

    cfg: dict
    t0: float
    t1: float
    paused_s: float  # the program held in the window while the profiler started and stopped
    updates: list  # live, delivered in the window: (t, cycle idx, take -> update ms, seconds of each of STAGES,
    #                screen -> update ms, screen -> take ms), the last two None for a frame with no screen stamp
    spans: list  # (kind, start, end) of the benchmark's spans
    counters: dict  # deltas over the window: backend or batch stats, launches, frames
    slices: list  # profiled slices (traced runs)
    shapes: dict  # the yardstick's shapes and what the frames need (the reference's masks), averaged

    def spans_in(self, kind: str) -> list:
        return [(a, b) for k, a, b in self.spans if k == kind and self.t0 <= a < self.t1]


def _window(t0: float, seconds: float, trace: bool, launches, pause, resume) -> list:
    """Wait out the window; in a traced run, take profiled slices of it,
    the program paused while the profiler starts and stops."""
    t1, slices = t0 + seconds, []
    for k in range(SLICES if trace else 0):
        start = t0 + (k + 0.5) * seconds / SLICES - SLICE_S / 2
        if start < t0 or start + SLICE_S > t1:
            continue
        time.sleep(max(0.0, start - clock()))
        pause()
        s = P.take(SLICE_S, launches, clock, pause, resume)
        if s is not None:
            slices.append(s)
    time.sleep(max(0.0, t1 - clock()))
    return slices


class Pauses:
    """Holds the program at the door where its frames enter (the live
    loop's submit, the video's next batch), so nothing waits busily, and
    keeps how long it was held: `quiet()` says when every frame let in is
    answered."""

    def __init__(self, quiet) -> None:
        self.quiet, self.open, self.intervals, self._since = quiet, threading.Event(), [], None
        self.open.set()

    def pause(self) -> None:
        if not self.open.is_set():
            return
        self.open.clear()
        self._since = clock()
        deadline = clock() + DRAIN_S
        while not self.quiet() and clock() < deadline:
            time.sleep(0.001)

    def resume(self) -> None:
        if not self.open.is_set():
            self.intervals.append((self._since, clock()))
            self.open.set()

    def within(self, t0: float, t1: float) -> float:
        return sum(max(0.0, min(b, t1) - max(a, t0)) for a, b in self.intervals)


def live(ctx: dict) -> dict:
    """The live loop over the cycle; -> what the run saw."""
    from smh_tpu_torch.ops import kernels as K
    from smh_tpu_torch.settings import Settings
    from smh_tpu_torch.squadex.capture import CaptureThread, Frame
    from smh_tpu_torch.vision.pipeline import VisionLoop, VisionState

    frames, tr, cfg, fault = ctx["frames"], ctx["traffic"], ctx["cfg"], ctx["fault"]
    n, dpi, spans = len(frames), cfg.get("dpi"), ctx["spans"]
    index = {id(f): i for i, f in enumerate(frames)}
    takes: list = []  # the time each frame was taken out of the mailbox
    answered: set = set()  # the take times of the frames answered
    served: list = []  # (cycle idx, Answer) of every update, each distinct Answer kept once
    distinct: dict = {}
    window: dict = {}
    started = threading.Event()
    state_box: dict = {}

    class Source:
        closed = False
        i = 0

        def grab(self):
            t = clock()  # the screen is read
            if self.closed:
                return None
            f = Frame(frames[self.i % n], dpi)
            f.grabbed = t
            self.i += 1
            return f

    class TimedCapture(CaptureThread):
        def fresh_frame(self):
            f = super().fresh_frame()
            if f is not None:
                f.take = (index[id(f.image)], clock())
                takes.append(f.take[1])
            return f

    class BenchState(VisionState):
        current = None
        at_door = False  # the submit thread waits for the door to open
        submits = 0  # submits done

        def submit(self, frame):
            if not hold.open.is_set():
                self.at_door = True
                hold.open.wait()
                self.at_door = False
            t = clock()
            job = super().submit(frame)
            spans.append(("submit", t, clock()))
            self.submits += 1
            return job

        def process(self, frame, debug=None, submitted=None):
            t = clock()
            r = super().process(frame, debug, submitted)
            spans.append(("consume", t, clock()))
            self.current = frame
            return r

    def on_update(results, debug) -> None:
        now = clock()
        if tr.get("fps_cap") and len(served) == ctx["warm"] - CAP_LEAD:
            loop._interval = 1.0 / float(tr["fps_cap"])  # the warm-up ran uncapped
        frame = state_box["state"].current
        idx, t_take = frame.take
        grabbed = getattr(frame, "grabbed", None)  # None: a frame the benchmark's source did not read
        ans = answer_of(results.markers, results.meters_to_px_ratio, results.minimap_bounds, False) \
            if results is not None else answer_of((), None, None, True)
        ans = fault(ans)
        if ans is None:
            return
        answered.add(t_take)
        served.append((idx, distinct.setdefault(ans, ans)))
        st = debug.timeshares.stages
        ctx["updates"].append((now, idx, (now - t_take) * 1e3, tuple(st.get(k, 0.0) for k in STAGES),
                               None if grabbed is None else (now - grabbed) * 1e3,
                               None if grabbed is None else (t_take - grabbed) * 1e3))
        if len(served) == ctx["warm"] and not started.is_set():
            window.update(t0=now, stats=dict(state_box["state"].delegate.backend.stats), launches=dict(K.LAUNCHES),
                          taken=len(takes))
            started.set()

    # Quiet: the submit thread waits at the door, and every frame it submitted is answered.
    hold = ctx["hold"] = Pauses(lambda: state.at_door and state.submits == len(answered))
    settings = Settings(path=None)
    for k, v in cfg["settings"].items():
        settings.set(k, v, save=False)
    state = state_box["state"] = BenchState(settings=settings, ocr_engine=make_engine(cfg), device=ctx["device"],
                                            **cfg.get("state", {}))
    if cfg.get("backend"):
        set_options(state.delegate.current(), cfg["backend"], "the backend")
    source = Source()
    cap = TimedCapture(source).start()
    loop = VisionLoop(state, cap, on_update, fps=1e6 if ctx["warm"] > CAP_LEAD or not tr.get("fps_cap")
                      else float(tr["fps_cap"]), pipelined=True, threaded_submit=True, **cfg.get("loop", {}))
    loop.start()
    try:
        if not started.wait(SETUP_TIMEOUT_S):
            raise RuntimeError(f"{len(served)} updates in {SETUP_TIMEOUT_S} s: the window never opened")
        t0 = window["t0"]
        slices = _window(t0, ctx["seconds"], ctx["trace"], lambda: sum(K.LAUNCHES.values()), hold.pause,
                         hold.resume)
        t1 = t0 + ctx["seconds"]
        stats1, launches1 = dict(state.delegate.backend.stats), dict(K.LAUNCHES)
        source.closed = True
        deadline, last = clock() + DRAIN_S, (len(served), clock())
        while clock() < deadline and len(answered) < len(takes):
            time.sleep(0.01)
            if len(served) != last[0]:
                last = (len(served), clock())
            elif clock() - last[1] > QUIET_S:
                break
        ctx["memory_peak"] = ctx["read_peak"]()
    finally:
        loop.stop()
        cap.stop()
        state.close()
    be_stats = state.delegate.backend.stats
    in_window = [t for t in takes if t0 <= t < t1]
    ctx["attempted"] = len(in_window)
    ctx["unanswered"] = sum(1 for t in in_window if t not in answered)
    ctx["served"] = served
    ctx["full_uploads"] = be_stats["full_uploads"]
    ctx["scales_fallbacks"] = be_stats["device_scales_fallbacks"]
    ctx["counters"] = {
        "stats": {k: stats1[k] - window["stats"][k] for k in stats1},
        "launches": {k: launches1[k] - window["launches"][k] for k in launches1},
        "submits": len([1 for k, a, _ in spans if k == "submit" and t0 <= a < t1]),
    }
    return {"t0": t0, "t1": t1, "slices": slices}


def video(ctx: dict) -> dict:
    """BatchPipeline.stream over batches of the cycle; -> what the run saw."""
    from smh_tpu_torch.ops import kernels as K
    from smh_tpu_torch.vision.batch import BatchPipeline

    frames, tr, cfg, fault, spans = ctx["frames"], ctx["traffic"], ctx["cfg"], ctx["fault"], ctx["spans"]
    n, b = len(frames), int(tr["batch"])
    h, w = frames[0].shape[:2]
    submitted: list = []  # (cycle idx, time submitted)
    served: list = []
    answered: set = set()  # positions in `submitted` whose answer was served
    distinct: dict = {}
    collected = [0]
    window: dict = {}
    started, done = threading.Event(), threading.Event()
    closed = [False]
    failure: list = []

    class BenchBatch(BatchPipeline):
        def submit(self, fr):
            t = clock()
            job = super().submit(fr)
            spans.append(("batch_pack", t, clock()))
            return job

        def collect(self, job):
            t = clock()
            out = super().collect(job)
            spans.append(("batch_host", t, clock()))
            return out

    bp = BenchBatch(w, h, batch=b, ocr_engine=make_engine(cfg), device=ctx["device"], **cfg.get("batch_options", {}))

    hold = ctx["hold"] = Pauses(lambda: collected[0] == len(submitted))

    def batches():
        i = 0
        while not closed[0]:
            hold.open.wait()
            now = clock()
            submitted.extend((k % n, now) for k in range(i, i + b))
            yield [frames[k % n] for k in range(i, i + b)]
            i += b

    def consume() -> None:
        try:
            for results in bp.stream(batches(), depth=int(tr["depth"])):
                now = clock()
                for pos, r in enumerate(results):
                    j = collected[0]
                    collected[0] += 1
                    ans = fault(answer_of(r.markers, r.meters_to_px_ratio, r.minimap_bounds, r.sleeping), pos, b)
                    if ans is not None:
                        served.append((submitted[j][0], distinct.setdefault(ans, ans)))
                        answered.add(j)
                    ctx["collect_times"].append(now)
                if collected[0] >= ctx["warm"] * n and not started.is_set():
                    window.update(t0=now, stats=dict(bp.stats), collected=collected[0])
                    started.set()
        except Exception as e:  # a failed batch: counted, and the run goes on to its line
            logging.getLogger("smh_tpu_torch").exception("batch failed")
            failure.append(e)
        finally:
            done.set()

    worker = threading.Thread(target=consume, name="bench-consume", daemon=True)
    worker.start()
    try:
        while not started.wait(1.0):
            if done.is_set():
                raise RuntimeError(f"the stream ended before the window: {failure}")
            if clock() - ctx["t_setup0"] > SETUP_TIMEOUT_S:
                raise RuntimeError(f"{collected[0]} frames in {SETUP_TIMEOUT_S} s: the window never opened")
        t0 = window["t0"]
        # The video's end-to-end metric is the card's time a frame, so every run on a card takes the slices.
        slices = _window(t0, ctx["seconds"], ctx["trace"] or ctx["device"] != "cpu", lambda: sum(K.LAUNCHES.values()),
                         hold.pause, hold.resume)
        t1 = t0 + ctx["seconds"]
        stats1 = dict(bp.stats)
        closed[0] = True
        done.wait(DRAIN_S)
        ctx["memory_peak"] = ctx["read_peak"]()
    finally:
        closed[0] = True
        done.wait(DRAIN_S)
        worker.join(5.0)
        bp.close()
    in_window = [i for i, (_, t) in enumerate(submitted) if t0 <= t < t1]
    ctx["attempted"] = len(in_window)
    ctx["unanswered"] = sum(1 for i in in_window if i not in answered) + (b if failure else 0)
    ctx["served"] = served
    ctx["full_uploads"] = bp.stats["full_batches"]
    ctx["scales_fallbacks"] = 0
    ctx["counters"] = {
        "stats": {k: stats1[k] - window["stats"][k] for k in stats1},
        "frames_in": len(in_window),
        "frames_out": sum(1 for t in ctx["collect_times"] if t0 < t <= t1),
        "batch": b,
    }
    return {"t0": t0, "t1": t1, "slices": slices}


FEEDS = {"live": live, "video": video}


def _end_to_end(ctx: dict, win: dict, setup_s: float) -> dict:
    seconds = win["t1"] - win["t0"]
    out = {"setup_s": setup_s}
    if ctx["traffic"]["feed"] == "live":
        ups = [u for u in ctx["updates"] if win["t0"] < u[0] <= win["t1"]]
        lat = [u[2] for u in ups]
        out["live_fps"] = len(lat) / seconds
        out["update_p50_ms"] = Y.quantile(lat, 0.5)
        out["update_p95_ms"] = Y.quantile(lat, 0.95)
        waits = [u[4] for u in ups if u[4] is not None]
        if waits:
            out["screen_to_update_ms"] = Y.quantile(waits, 0.5)
    else:
        out["video_fps"] = ctx["counters"]["frames_out"] / seconds
        # Each slice holds whole batches (the feed is quiet at both ends): one hostpack launch a batch.
        slices, b = win["slices"], ctx["counters"]["batch"]
        frames = b * sum(1 for s in slices for name, _, _, kind in s["rows"]
                         if kind == "kernel" and name == "hostpack_kernel")
        if frames:  # every kernel's and copy's time, each counted whole where two overlap
            out["video_device_us_per_frame"] = 1e6 * sum(z - a for s in slices for _, a, z, _ in s["rows"]) / frames
    return out


def breakdown(slices: list, spans: list) -> dict:
    """The device operations that took most time, and the longest idle gaps
    labelled by the benchmark's span that covers most of each."""
    ops: dict = {}
    idle = []
    for s in slices:
        for name, a, b, _ in s["rows"]:
            ops[name] = ops.get(name, 0.0) + (b - a)
        for g0, g1 in Y.gaps([(a, b) for _, a, b, _ in s["rows"]], s["lo"], s["hi"]):
            cover: dict = {}
            for kind, a, b in spans:
                o = min(b, g1) - max(a, g0)
                if o > 0:
                    cover[kind] = cover.get(kind, 0.0) + o
            idle.append((max(cover, key=cover.get) if cover else "no span", g1 - g0))
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in sorted(idle, key=lambda x: -x[1])[:10]]}


def forbidden_modules() -> list:
    """Modules of JAX or of the JAX package loaded in this process."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda", fault=None,
        t_start: float = None, screen=None, ref_workers: int = REF_WORKERS, warm: int = None,
        ref_cache: dict = None) -> dict:
    """One run of a cell -> its result (the line the benchmark prints, and
    the numbers compared under `checks`). `screen` overrides the
    configuration's and `warm` the warm-up (the CPU tests run few frames);
    `ref_cache` keeps the reference's answers across runs of one seed;
    `fault` plants one of FAULTS (the control and the tests; the
    benchmark's own runs plant none)."""
    t_start = clock() if t_start is None else t_start
    bench = benchmark()
    wl = cell(bench, workload)
    cfg, tr = config(wl["config"]), T.load(wl["traffic"])
    apply_environment(cfg)
    w, h = screen or cfg["screen"]
    g0 = clock()
    frames = T.cycle(tr, w, h, seed)
    gen_s = clock() - g0

    import torch

    torch.set_num_threads(int(cfg["threads"]["torch_intra_op"]))
    errors = ErrorCount()
    logging.getLogger("smh_tpu_torch").addHandler(errors)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if warm is None:
        warm = WARM_UPDATES if tr["feed"] == "live" else WARM_LAPS
    ctx = {"frames": frames, "traffic": tr, "cfg": cfg, "fault": Fault(fault), "spans": [], "updates": [], "warm": warm,
           "collect_times": [], "device": device, "seconds": seconds, "trace": trace, "t_setup0": t_start,
           "read_peak": (lambda: torch.cuda.max_memory_allocated(dev)) if cuda else (lambda: 0)}
    try:
        win = FEEDS[tr["feed"]](ctx)
    finally:
        logging.getLogger("smh_tpu_torch").removeHandler(errors)
    setup_s = win["t0"] - t_start - gen_s
    del frames
    ctx["frames"] = None
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()

    # The reference, once the window has closed and the program's frames are freed.
    served = ctx["served"]
    n = tr["period"]
    idxs = sorted({i for i, _ in served}) if tr["feed"] == "live" else compare.sample(n, REF_SAMPLE, seed)
    refs = compare.answers(wl["traffic"], w, h, seed, idxs, cfg.get("dpi"), cfg["settings"]["detect_markers"],
                           ref_workers, ref_cache)
    counts = {"frame_errors": len(errors.messages), "unanswered": ctx["unanswered"],
              "extra_full_uploads": max(0, ctx["full_uploads"] - 1), "scales_fallbacks": ctx["scales_fallbacks"]}
    nums = compare.numbers(served, refs, (w, h), counts)
    correct, rows = compare.judge(nums, compare.limits(workload))

    need = {k: sum(r[1][k] for r in refs.values()) / max(1, len(refs)) for k in ("nz", "band")}
    need["win"] = tuple(sum(r[1]["win"][j] for r in refs.values()) / max(1, len(refs)) for j in (0, 1))
    rec = Run(cfg, win["t0"], win["t1"], ctx["hold"].within(win["t0"], win["t1"]),
              [u for u in ctx["updates"] if win["t0"] < u[0] <= win["t1"]], ctx["spans"], ctx["counters"],
              win["slices"], Y.shapes(R.consts.map_geometry(w, h), need))
    if trace:
        metrics = {}
        for m in bench["per_layer"]:
            if in_cell(m, workload):
                v = reader(m["name"])(rec)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = _end_to_end(ctx, win, setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"] if in_cell(m, workload) and m["name"] in values}
    device_info = {"platform": "gpu" if cuda else "cpu", "count": 1, "memory_peak_bytes": ctx.get("memory_peak", 0)}
    if cuda:
        device_info["kind"] = torch.cuda.get_device_name(dev)
    if trace:
        device_info["busy_s"] = sum(Y.union_s([(a, b) for _, a, b, _ in s["rows"]], s["lo"], s["hi"])
                                    for s in win["slices"])
        device_info["window_s"] = sum(s["hi"] - s["lo"] for s in win["slices"])
    out = {"correct": correct, "attempted": ctx["attempted"],
           "failed": counts["frame_errors"] + counts["unanswered"], "metrics": metrics, "device": device_info}
    if trace:
        out["breakdown"] = breakdown(win["slices"], ctx["spans"])
    out["checks"] = {k: {"value": v, "limit": l} for k, v, l in rows}
    out["_numbers"] = nums
    out["_errors"] = errors.messages[:5]
    times = [u[0] for u in ctx["updates"]] if tr["feed"] == "live" else ctx["collect_times"]
    per_s = [0] * max(1, int(seconds))
    for t in times:
        k = int(t - win["t0"])
        if win["t0"] < t <= win["t1"] and k < len(per_s):
            per_s[k] += 1
    out["_diag"] = {"per_second": per_s, "gen_s": gen_s, "cores": os.cpu_count()}
    if tr["feed"] == "video" and not trace:  # the rate, per-layer as `frames_per_s.video` in the traced run
        out["_diag"]["video_fps"] = values["video_fps"]
    if tr["feed"] == "live" and rec.updates:  # the candidates' spreads are read from the untraced runs
        out["_diag"].update(p95_ms=Y.quantile([u[2] for u in rec.updates], 0.95),
                            updates_per_s=len(rec.updates) / (win["t1"] - win["t0"] - rec.paused_s))
    return out
