"""The port's span recorder on the CPU (smh_tpu_torch.utils.timeshares): the
live loop and the batch stream over the plain twins record their spans on
time.perf_counter, each frame's submit and consume under one frame id,
children inside their parent on its thread, the DebugBox stages equal to
their records; the D2H byte counters; SMH_TRACE=0; the ring's eviction
count; the Chrome trace writer and its two command-line switches; and the
benchmark's readers of the spans (smhbench/spans.py, smhbench/metrics/)
on hand-built runs with known answers."""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from smh_tpu_torch import app as tapp
from smh_tpu_torch import testing
from smh_tpu_torch.ocr.smhocr import SmhOcrEngine
from smh_tpu_torch.settings import Settings
from smh_tpu_torch.squadex.capture import CaptureThread, Frame
from smh_tpu_torch.tools import analyze_video
from smh_tpu_torch.utils import timeshares as T
from smh_tpu_torch.vision.batch import BatchPipeline
from smh_tpu_torch.vision.pipeline import DebugBox, VisionLoop, VisionState
from smhbench import harness, spans
from test_torch_reference import _reference_native, port_native  # noqa: F401  (module-scoped fixtures)

torch.set_num_threads(1)

W, H = 1280, 720
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.usefixtures("port_native")


def frame_with(off: int) -> np.ndarray:
    return testing.make_frame(
        W, H,
        marker_lines=[((120 + off, 150), (380 + off, 320))],
        scale_texts=[("300m", (60, 170))],
        scale_bars=[(60, 200, 120, 1)],
    )


FRAMES = [frame_with(10 * i) for i in range(3)]


def make_state(**kw) -> VisionState:
    s = Settings(path=None)
    s.set("hardware_acceleration", True, save=False)
    return VisionState(settings=s, ocr_engine=SmhOcrEngine(), device="cpu", **kw)


class Cycle:
    def __init__(self):
        self.i = 0

    def grab(self):
        self.i += 1
        return Frame(FRAMES[self.i % len(FRAMES)], 96)


@pytest.fixture(scope="module")
def loop_run():
    """A threaded, pipelined VisionLoop over the CPU backend until 6
    updates: (records of the run, perf_counter before and after it)."""
    assert T.ENABLED
    state = make_state()
    updates = []
    before = time.perf_counter()
    cap = CaptureThread(Cycle(), hz=120).start()
    loop = VisionLoop(state, cap, lambda r, d: updates.append(r), fps=60, pipelined=True,
                      threaded_submit=True).start()
    try:
        deadline = time.time() + 120
        while len(updates) < 6 and time.time() < deadline:
            time.sleep(0.02)
    finally:
        loop.stop()
        cap.stop()
    after = time.perf_counter()
    assert len(updates) >= 6
    return [r for r in T.RING.records(before, after) if r.start >= before], before, after


def test_every_update_has_its_mailbox_submit_and_fetch_wait_under_one_frame_id(loop_run):
    recs, _, _ = loop_run
    updated = [r.frame for r in recs if r.name == "loop.on_update"]
    assert len(updated) >= 6 and len(set(updated)) == len(updated)
    by_frame = {}
    for r in recs:
        by_frame.setdefault(r.frame, set()).add(r.name)
    for fid in updated:
        assert {"capture.mailbox", "vision.submit", "vision.load_frame", "vision.dispatch", "vision.consume",
                "vision.fetch_wait", "vision.parse", "vision.crop_to_map"} <= by_frame[fid], fid
    assert {"loop.queue_put", "loop.queue_get", "capture.grab"} <= {r.name for r in recs}


def test_children_nest_inside_their_parent_on_one_thread(loop_run):
    recs, before, after = loop_run
    by_id = {r.id: r for r in recs}
    nested = 0
    for r in recs:
        assert before <= r.start <= r.end <= after, r  # on time.perf_counter's clock
        assert r.kind in (T.WORK, T.WAIT, T.QUEUE)
        if r.kind == T.QUEUE:
            assert r.thread is None and r.parent is None
            continue
        assert r.thread is not None
        if r.parent is None:
            continue
        p = by_id[r.parent]
        assert p.thread == r.thread and p.start <= r.start and r.end <= p.end, (p, r)
        assert r.frame == p.frame
        nested += 1
    assert nested >= 6 * 5
    for r in recs:
        if r.name in ("vision.load_frame", "vision.dispatch", "vision.prepare", "vision.snapshot"):
            assert by_id[r.parent].name == "vision.submit"
        if r.name in ("vision.fetch_wait", "vision.parse"):
            assert by_id[r.parent].name == "vision.crop_to_map"
            assert by_id[by_id[r.parent].parent].name == "vision.consume"
    cpu = [r for r in recs if r.name in ("vision.load_frame", "vision.dispatch")]
    assert cpu and all(r.cpu is not None and r.cpu >= 0 for r in cpu)
    assert all(r.cpu is None for r in recs if r.name == "vision.submit")


def test_debugbox_stages_equal_their_records_and_the_hostpack_is_the_d2h():
    state = make_state()
    try:
        frame = Frame(FRAMES[0], 96)
        debug = DebugBox()
        assert state.process(frame, debug) is not None
        be = state.delegate.backend
        stats = dict(be.stats)
        assert stats["lsd_sparse_misses"] == stats["lsd_window_misses"] == stats["scalespack_fetches"] == 0
        assert stats["d2h_bytes"] == be._results["hostpack"].nbytes > 0
        recs = [r for r in T.RING.records() if r.frame == frame.seq]
        stages = debug.timeshares.stages
        assert {"crop_to_map", "find_minimap", "find_marker_lines", "load_frame"} <= set(stages)
        for stage, seconds in stages.items():
            match = [r for r in recs if r.name == f"vision.{stage}"]
            assert len(match) == 1 and match[0].end - match[0].start == seconds, stage
        crop = next(r for r in recs if r.name == "vision.crop_to_map")
        parts = [r for r in recs if r.parent == crop.id]
        assert {r.name for r in parts} == {"vision.fetch_wait", "vision.parse"}
        # A fetch of the ui map is one more copy of its bytes.
        before = be.stats["d2h_bytes"]
        state.process(Frame(FRAMES[1], 96)).map
        assert be.stats["d2h_bytes"] - before == be._results["hostpack"].nbytes + be._results["ui"].nbytes
    finally:
        state.close()


def test_batch_stream_spans_share_the_batch_id_and_feed_the_stats():
    bp = BatchPipeline(W, H, batch=2, ocr_engine=SmhOcrEngine(), device="cpu")
    try:
        before = time.perf_counter()
        out = list(bp.stream([[FRAMES[0], FRAMES[1]], [FRAMES[2], FRAMES[0]], [FRAMES[1], FRAMES[2]]]))
        recs = [r for r in T.RING.records(before) if r.start >= before]
        assert len(out) == 3
        assert "t_dispatch_ms" not in bp.stats and "t_fetch_ms" not in bp.stats
        by_id = {r.id: r for r in recs}
        subs = [r for r in recs if r.name == "batch.submit"]
        cols = [r for r in recs if r.name == "batch.collect"]
        assert len(subs) == len(cols) == 3
        assert sorted(r.frame for r in subs) == sorted(r.frame for r in cols)
        for name, parent in (("batch.pack", "batch.submit"), ("batch.diff", "batch.submit"),
                             ("batch.dispatch", "batch.submit"), ("batch.fetch_wait", "batch.collect"),
                             ("batch.host", "batch.collect")):
            rs = [r for r in recs if r.name == name]
            assert len(rs) == 3 and all(by_id[r.parent].name == parent for r in rs), name
            assert all(r.frame == by_id[r.parent].frame for r in rs)
        assert len([r for r in recs if r.name == "batch.chain_wait"]) == 2  # batches 2 and 3 ride deltas
        assert len([r for r in recs if r.name == "batch.queue_put"]) == 3
        assert [r for r in recs if r.name == "batch.queue_get"]
        for key, name in (("t_pack_ms", "batch.pack"), ("t_diff_ms", "batch.diff"), ("t_poke_ms", "batch.chain_wait"),
                          ("t_host_ms", "batch.host")):
            assert bp.stats[key] == pytest.approx(1e3 * sum(r.end - r.start for r in recs if r.name == name))
        # One batch: its hostpacks are the only copy back.
        d0 = bp.stats["d2h_bytes"]
        job = bp.submit([FRAMES[0], FRAMES[1]])
        assert bp.stats["d2h_bytes"] - d0 == job["fetch"][0].nbytes > 0
        bp.collect(job)
        assert bp.stats["d2h_bytes"] - d0 == job["fetch"][0].nbytes
    finally:
        bp.close()


def test_tracing_off_records_nothing(monkeypatch):
    monkeypatch.setattr(T, "ENABLED", False)
    state = make_state()
    try:
        n0 = len(T.RING.records())
        debug = DebugBox()
        state.process(Frame(FRAMES[0], 96), debug)
        assert len(T.RING.records()) == n0
        assert debug.timeshares.stages["crop_to_map"] > 0  # the debug panel's timings stay
    finally:
        state.close()


def test_smh_trace_0_turns_the_ring_off():
    code = ("from smh_tpu_torch.utils import timeshares as T\n"
            "with T.span('a', cpu=True) as s:\n"
            "    T.add('b', T.WAIT, 0.0, 1.0)\n"
            "    with T.timeshare(T.Timeshares(), 'ocr'):\n"
            "        pass\n"
            "print(T.ENABLED, len(T.RING.records()), s.seconds >= 0)\n")
    env = dict(os.environ, SMH_TRACE="0", PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "0", "True"]


def test_the_ring_counts_what_it_evicts():
    ring = T.Ring(capacity=8)
    for i in range(20):
        ring.append((i, "x", T.WORK, None, None, 1, float(i), float(i) + 0.5, None))
    recs = ring.records()
    assert ring.dropped == 12 and [r.id for r in recs] == list(range(12, 20))
    assert ring.evicted_until == 11.5
    assert [r.id for r in ring.records(14.6, 16.0)] == [15, 16]


def test_the_ring_counts_every_eviction_under_contending_threads():
    ring = T.Ring(capacity=64)
    n_threads, per = 16, 3000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(per):
                ring.append((k * per + i, "x", T.WORK, None, None, k, 0.0, 1.0, None))

        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(ring.records()) == ring.capacity
    assert ring.dropped + ring.capacity == n_threads * per


def test_chrome_trace_holds_every_record(tmp_path):
    ring = T.Ring()
    ring.threads[11] = "vision-submit"
    ring.append((1, "vision.submit", T.WORK, 7, None, 11, 1.0, 1.002, None))
    ring.append((2, "vision.load_frame", T.WORK, 7, 1, 11, 1.0005, 1.001, 0.0004))
    ring.append((3, "capture.mailbox", T.QUEUE, 7, None, None, 0.9, 1.0, None))
    path = tmp_path / "trace.json"
    assert T.write_chrome_trace(str(path), ring) == 3
    doc = json.loads(path.read_text())
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    names = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"] if e["ph"] == "M"}
    assert [e["name"] for e in xs] == ["vision.submit", "vision.load_frame", "capture.mailbox"]
    assert all(e["args"]["frame"] == 7 for e in xs)
    assert xs[0]["ts"] == pytest.approx(1e6) and xs[0]["dur"] == pytest.approx(2e3)
    assert xs[1]["args"]["parent"] == 1 and xs[1]["args"]["cpu_us"] == pytest.approx(400.0)
    assert xs[0]["tid"] == xs[1]["tid"] != xs[2]["tid"]
    assert names[xs[0]["tid"]] == "vision-submit" and names[xs[2]["tid"]] == "capture.mailbox"


def test_trace_out_switches(tmp_path, capsys):
    assert tapp.build_parser().parse_args(["--trace-out", "t.json"]).trace_out == "t.json"
    cv2 = pytest.importorskip("cv2")
    clip = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"MJPG"), 10, (W, H))
    assert writer.isOpened()
    for f in FRAMES:
        writer.write(np.ascontiguousarray(f[..., :3]))
    writer.release()
    out = tmp_path / "trace.json"
    assert analyze_video.main([clip, "--batch", "2", "--ocr", "none", "--device", "cpu", "--trace-out", str(out)]) == 0
    names = {e["name"] for e in json.loads(out.read_text())["traceEvents"] if e["ph"] == "X"}
    assert {"batch.submit", "batch.pack", "batch.collect", "batch.fetch_wait", "batch.queue_put"} <= names
    capsys.readouterr()


# -- the benchmark's readers, on hand-built runs ------------------------------------


def _rec(i, name, kind, frame, parent, start, end, cpu=None, thread=1):
    return (i, name, kind, frame, parent, None if kind == T.QUEUE else thread, start, end, cpu)


LIVE = [
    _rec(1, "setup.kernels", T.WORK, 1, 3, 1.0, 1.5),
    _rec(2, "setup.kernels", T.WORK, None, None, 1.2, 1.6, thread=2),
    _rec(3, "vision.submit", T.WORK, 1, None, 0.9, 1.7),
    _rec(4, "vision.fetch_wait", T.WAIT, 1, None, 1.9, 2.0),
    _rec(5, "capture.mailbox", T.QUEUE, 1, None, 0.8, 0.9),
    _rec(6, "capture.mailbox", T.QUEUE, 9, None, 9.9, 10.0),  # before the window
    _rec(7, "capture.mailbox", T.QUEUE, 10, None, 10.5, 10.56),
    _rec(8, "capture.mailbox", T.QUEUE, 11, None, 11.0, 11.05),
    _rec(10, "vision.submit", T.WORK, 10, None, 10.56, 10.566),
    _rec(11, "vision.load_frame", T.WORK, 10, 10, 10.560, 10.563, cpu=0.002),
    _rec(12, "vision.dispatch", T.WORK, 10, 10, 10.563, 10.565, cpu=0.0015),
    _rec(20, "vision.submit", T.WORK, 11, None, 11.05, 11.06),
    _rec(21, "vision.load_frame", T.WORK, 11, 20, 11.05, 11.054, cpu=0.003),
    _rec(22, "vision.dispatch", T.WORK, 11, 20, 11.054, 11.058, cpu=0.001),
    _rec(23, "vision.fetch_wait", T.WAIT, 10, None, 10.57, 10.5705, thread=3),
    _rec(24, "vision.fetch_wait", T.WAIT, 11, None, 11.06, 11.0612, thread=3),
    _rec(30, "loop.queue_put", T.WAIT, 10, None, 10.566, 10.6),
]
LIVE_SLICE = {"lo": 10.5, "hi": 10.7, "rows": [("k", 10.565, 10.567, "kernel"), ("k", 10.65, 10.7, "kernel")]}

VIDEO = [
    _rec(1, "setup.kernels", T.WORK, 1, 2, 1.0, 1.4),
    _rec(2, "batch.submit", T.WORK, 1, None, 0.95, 1.8),
    _rec(3, "batch.fetch_wait", T.WAIT, 1, 4, 2.0, 2.25),
    _rec(5, "batch.submit", T.WORK, 2, None, 10.0, 10.006),
    _rec(6, "batch.pack", T.WORK, 2, 5, 10.0, 10.004, cpu=0.003),
    _rec(7, "batch.diff", T.WORK, 2, 5, 10.004, 10.005, cpu=0.0005),
    _rec(8, "batch.queue_put", T.WAIT, 2, None, 10.1, 10.2),
    _rec(9, "batch.queue_put", T.WAIT, 3, None, 11.0, 11.05),
    _rec(10, "batch.queue_get", T.WAIT, None, None, 10.3, 10.31, thread=2),
]
VIDEO_SLICE = {"lo": 10.0, "hi": 10.2, "rows": [("k", 10.005, 10.05, "kernel")]}


def _run(recs, monkeypatch, **kw):
    ring = T.Ring()
    for r in recs:
        ring.append(r)
    monkeypatch.setattr(T, "RING", ring)
    base = dict(cfg={}, t0=10.0, t1=12.0, paused_s=0.0, updates=[], spans=[], counters={}, slices=[], shapes={})
    base.update(kw)
    return harness.Run(**base), ring


def _read(name, run):
    return harness.reader(name)(run)


def test_live_readers_of_the_spans(monkeypatch):
    run, _ = _run(LIVE, monkeypatch, slices=[LIVE_SLICE], counters={"stats": {"d2h_bytes": 3000, "frames": 3}})
    assert _read("mailbox_wait_ms.live", run) == pytest.approx(55.0)
    assert _read("submit_pack_ms.live", run) == pytest.approx(3.5)
    assert _read("submit_enqueue_ms.live", run) == pytest.approx(3.0)
    assert _read("submit_offcpu_ms.live", run) == pytest.approx((1.0 + 0.5 + 1.0 + 3.0) / 2)
    assert _read("fetch_wait_ms.live", run) == pytest.approx(0.85)
    assert _read("d2h_bytes_per_frame.live", run) == pytest.approx(1000.0)
    idle = 0.065 + 0.083  # the slice less its two kernels
    assert _read("idle_feeding_pct.live", run) == pytest.approx(100 * 0.005 / idle)  # load + dispatch of frame 10
    assert _read("idle_blocked_pct.live", run) == pytest.approx(100 * 0.033 / idle)  # the put, up to 10.6
    assert _read("setup_kernels_s", run) == pytest.approx(0.6)  # the union of two overlapping loads
    assert _read("setup_first_pass_s", run) == pytest.approx(1.1)  # frame 1: 0.9 -> its fetch wait's end


def test_video_readers_of_the_spans(monkeypatch):
    run, _ = _run(VIDEO, monkeypatch, slices=[VIDEO_SLICE],
                  counters={"stats": {"d2h_bytes": 5000}, "frames_in": 10, "frames_out": 10, "batch": 2})
    assert _read("batch_put_wait_ms_per_frame", run) == pytest.approx(15.0)
    assert _read("batch_get_wait_ms_per_frame", run) == pytest.approx(1.0)
    assert _read("batch_pack_offcpu_ms_per_frame", run) == pytest.approx((1.0 + 0.5) / 10)
    assert _read("d2h_bytes_per_frame.video", run) == pytest.approx(500.0)
    idle = 0.2 - 0.045
    assert _read("idle_feeding_pct.video", run) == pytest.approx(100 * 0.005 / idle)  # pack + diff
    assert _read("idle_blocked_pct.video", run) == pytest.approx(100 * 0.1 / idle)  # the first put
    assert _read("setup_kernels_s", run) == pytest.approx(0.4)
    assert _read("setup_first_pass_s", run) == pytest.approx(1.3)


NEW_READERS = [
    "mailbox_wait_ms.live", "submit_pack_ms.live", "submit_enqueue_ms.live", "submit_offcpu_ms.live",
    "fetch_wait_ms.live", "d2h_bytes_per_frame.live", "idle_feeding_pct.live", "idle_blocked_pct.live",
    "batch_put_wait_ms_per_frame", "batch_get_wait_ms_per_frame", "batch_pack_offcpu_ms_per_frame",
    "d2h_bytes_per_frame.video", "idle_feeding_pct.video", "idle_blocked_pct.video", "setup_kernels_s",
    "setup_first_pass_s",
]


@pytest.mark.parametrize("name", NEW_READERS)
def test_a_reader_finds_nothing_where_the_program_keeps_no_ring(name, monkeypatch):
    """A program without the recorder (no RING, no d2h_bytes) reads None and raises nothing."""
    run, _ = _run(LIVE + VIDEO[3:], monkeypatch, slices=[LIVE_SLICE],
                  counters={"stats": {"frames": 3}, "frames_in": 10, "frames_out": 10, "batch": 2})
    monkeypatch.delattr(T, "RING")
    assert _read(name, run) is None


def test_a_reader_refuses_a_ring_that_evicted_what_it_needs(monkeypatch):
    run, ring = _run(LIVE, monkeypatch, slices=[LIVE_SLICE])
    ring.dropped, ring.evicted_until = 5, 9.0  # evicted before the window: the window's readings stand
    assert _read("mailbox_wait_ms.live", run) == pytest.approx(55.0)
    assert _read("setup_kernels_s", run) is None  # set-up needs the process's first records
    ring.evicted_until = 10.2
    assert spans.records(run) is None and _read("fetch_wait_ms.live", run) is None
