"""The port's worker process (smh_tpu_torch/worker.py) on the CPU: the shm
frame ring (its mailbox semantics, and one ring shared with smh_tpu.worker's
FrameRing in both directions), WorkerClient(device="cpu") end to end against
the in-process VisionState, the recycle past a tiny upload budget and the
recovery, the fast diagnosis of a dead child, the map slot, and the App in
worker mode delivering the protocol's events."""

import os
import threading
import time

import numpy as np
import pytest
import torch

from smh_tpu import worker as jworker
from smh_tpu_torch import app as tapp
from smh_tpu_torch import consts as C
from smh_tpu_torch import testing
from smh_tpu_torch.ocr.smhocr import SmhOcrEngine
from smh_tpu_torch.settings import Settings
from smh_tpu_torch.squadex.capture import Frame, StaticSource
from smh_tpu_torch.vision.pipeline import VisionState
from smh_tpu_torch.web import protocol
from smh_tpu_torch.worker import FrameRing, WorkerClient

torch.set_num_threads(1)

W, H = 640, 360  # small: the child warms two frames of this size on the CPU


class Collector:
    def __init__(self) -> None:
        self.results: dict[int, dict] = {}
        self.cond = threading.Condition()

    def __call__(self, msg: dict) -> None:
        with self.cond:
            self.results[msg["seq"]] = msg
            self.cond.notify_all()

    def wait_for(self, seq: int, timeout: float = 120.0) -> dict:
        deadline = time.monotonic() + timeout
        with self.cond:
            while seq not in self.results:
                left = deadline - time.monotonic()
                assert left > 0, f"no result for seq {seq}"
                self.cond.wait(min(left, 1.0))
            return self.results[seq]


def make_frames(n: int = 3) -> list[np.ndarray]:
    return [testing.make_frame(W, H, marker_lines=[((30 + 5 * i, 40), (220 + 5 * i, 160))]) for i in range(n)]


def submit_until_accepted(wc: WorkerClient, img, timeout: float = 120.0):
    """submit() drops frames while the worker is (re)starting or the ring is
    full: retry until one is accepted, like a capture loop would."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        seq = wc.submit(img)
        if seq is not None:
            return seq
        time.sleep(0.1)
    raise AssertionError("worker never accepted a frame: " + wc.diagnose())


def test_frame_ring_mailbox_semantics():
    """try_publish drops when all slots are busy; release frees them."""
    ring = FrameRing("smht-test-ring-%d" % os.getpid(), 64, 48, create=True)
    try:
        img = np.zeros((48, 64, 4), dtype=np.uint8)
        slots = [ring.try_publish(img, seq=i + 1, dpi=96) for i in range(4)]
        assert all(s is not None for s in slots)
        assert ring.try_publish(img, seq=99, dpi=96) is None  # full: drop
        view, seq, dpi = ring.view(slots[0])
        assert (seq, dpi) == (1, 96) and view.shape == (48, 64, 4)
        ring.release(slots[0])
        assert ring.try_publish(img, seq=100, dpi=96) is not None
    finally:
        ring.close(unlink=True)


@pytest.mark.parametrize("creator", ["port", "jax"])
def test_frame_ring_is_shared_with_smh_tpus(creator):
    """One ring, created by either package and attached by the other: the
    same frame bytes, headers and map slot both ways."""
    mods = (FrameRing, jworker.FrameRing) if creator == "port" else (jworker.FrameRing, FrameRing)
    name = f"smht-x-{creator}-{os.getpid()}"
    owner = mods[0](name, 50, 30, create=True)
    try:
        peer = mods[1](name, 50, 30, create=False)
        rng = np.random.default_rng(5)
        img = rng.integers(0, 256, (30, 50, 4), dtype=np.uint8)
        slot = owner.try_publish(img, seq=7, dpi=120)
        view, seq, dpi = peer.view(slot)
        assert (seq, dpi) == (7, 120) and np.array_equal(view, img)
        peer.release(slot)
        rgba = rng.integers(0, 256, (20, 25, 4), dtype=np.uint8)
        assert peer.try_write_map(rgba, 3)
        got, mseq = owner.read_map()
        assert mseq == 3 and np.array_equal(got, rgba)
        peer.close()
    finally:
        owner.close(unlink=True)


def _in_process(frames) -> list:
    """The worker's own handling of a frame in this process: a VisionState
    of the same settings, engine and device, each frame submitted and then
    consumed (a client waiting on each result)."""
    s = Settings(path=None)
    s.set("hardware_acceleration", True, save=False)
    state = VisionState(settings=s, ocr_engine=SmhOcrEngine(), scales_async=True, device="cpu")
    out = []
    try:
        for img in frames:
            frame = Frame(img, 96)
            r = state.process(frame, submitted=state.submit(frame))
            mb = None if r is None else r.minimap_bounds
            out.append(None if r is None else (
                [[l.p0.x, l.p0.y, l.p1.x, l.p1.y] for l in r.markers], r.meters_to_px_ratio,
                None if mb is None else [mb.left, mb.top, mb.right, mb.bottom]))
    finally:
        state.close()
    return out


def test_worker_end_to_end_equals_the_in_process_state():
    col = Collector()
    wc = WorkerClient(W, H, col, device="cpu")
    try:
        assert wc.wait_ready_progress(idle_timeout=60, max_s=120), wc.diagnose()
        assert wc.last_warming is not None and wc.last_warming["total"] == 2
        assert wc.ready_info is not None and wc.ready_info["warmup_s"] >= 0
        frames = make_frames(3) + [testing.make_frame(W, H, with_button=False)]  # a sleeping frame last
        got = []
        for img in frames:
            msg = col.wait_for(submit_until_accepted(wc, img))
            assert msg["ms"] > 0
            got.append(None if msg["sleeping"] else (msg["markers"], msg["ratio"], msg["minimap"]))
        assert "markers" not in col.results[max(col.results)]
    finally:
        wc.close()
    assert got == _in_process(frames)
    assert all(len(g[0]) == 1 for g in got[:3]) and got[3] is None


def test_worker_recycles_and_recovers():
    """A tiny upload budget forces the recycle: the worker reports
    `recycling`, exits, the supervisor restarts it, and results keep
    flowing."""
    col = Collector()
    wc = WorkerClient(W, H, col, env={"SMH_WORKER_RECYCLE_MB": "0.000001"}, device="cpu")
    try:
        assert wc.wait_ready(timeout=120), wc.diagnose()
        img = make_frames(1)[0]
        col.wait_for(submit_until_accepted(wc, img))
        deadline = time.monotonic() + 120
        while wc.restarts == 0 and time.monotonic() < deadline:
            time.sleep(0.1)
        assert wc.restarts >= 1 and wc.last_exit_code == 42
        msg = col.wait_for(submit_until_accepted(wc, img))
        assert msg["sleeping"] is False and len(msg["markers"]) == 1
    finally:
        wc.close()


def test_worker_map_slot():
    """set_maps(True): the worker publishes the RGBA ui map through the shm
    map slot; the client callback gets a map-sized opaque image."""
    col = Collector()
    maps = []
    ev = threading.Event()

    def on_map(rgba, seq):
        maps.append((rgba, seq))
        ev.set()

    wc = WorkerClient(W, H, col, on_map=on_map, device="cpu")
    try:
        assert wc.wait_ready(timeout=120), wc.diagnose()
        wc.set_maps(True)
        col.wait_for(submit_until_accepted(wc, make_frames(1)[0]))
        assert ev.wait(timeout=60), "no map published"
        rgba, _ = maps[0]
        g = C.map_geometry(W, H)
        assert rgba.shape == (g.map_h, g.map_w, 4) and rgba[..., 3].min() == 255
    finally:
        wc.close()


def test_dead_worker_diagnosed_fast():
    """A child that dies on startup fails wait_ready_progress in seconds and
    diagnose() names the exit code and the child's stderr tail."""
    t0 = time.monotonic()
    wc = WorkerClient(W, H, Collector(), env={"PYTHONHOME": "/nonexistent"}, max_restarts=0, device="cpu")
    try:
        assert not wc.wait_ready_progress(idle_timeout=6, max_s=60)
        assert time.monotonic() - t0 < 55
        d = wc.diagnose()
        assert "ready=False" in d and "exit_code=" in d and "exit_code=None" not in d
        assert "stderr:" in d
    finally:
        wc.close()


def test_worker_client_on_an_absent_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        WorkerClient(W, H, Collector(), device="cuda")


class _Web:
    """What the App pushes to web clients, encoded by the protocol."""

    addr = "stub"

    def __init__(self) -> None:
        self.events: list[bytes] = []

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass

    def num_clients(self) -> int:
        return 0

    def recv(self):
        return None

    def send_markers(self, markers, custom: bool) -> None:
        self.events.append(protocol.encode_markers(markers, custom))

    def send_update_state(self, ratio, minimap) -> None:
        self.events.append(protocol.encode_update_state(ratio, minimap))


def test_app_in_worker_mode_serves_the_protocols_events():
    """`App(worker=True, device="cpu")`: the feeder starts a WorkerClient on
    the device, and the worker's results reach the web layer as the Markers
    and UpdateState events the in-process App sends for the same frame."""
    frame = make_frames(1)[0]
    s = Settings(path=None)
    s.set("hardware_acceleration", True, save=False)
    app = tapp.App(StaticSource(frame, dpi=96), settings=s, serve=False, device="cpu", worker=True,
                   ocr_engine=SmhOcrEngine())
    assert app.loop is None and app.worker_mode
    app.web = web = _Web()
    app.start()
    try:
        deadline = time.time() + 120
        while len(web.events) < 2 and time.time() < deadline:
            time.sleep(0.05)
        assert app._worker_client is not None and app._worker_client.device == "cpu"
    finally:
        app.stop()
    assert not app._worker_thread.is_alive()
    (r,) = [x for x in _in_process([frame])]
    markers = [((x0, y0), (x1, y1)) for x0, y0, x1, y1 in r[0]]
    from smh_tpu_torch.geometry import Rect

    mm = Rect(left=r[2][0], top=r[2][1], right=r[2][2], bottom=r[2][3])
    assert web.events[:2] == [protocol.encode_markers(markers, False), protocol.encode_update_state(r[1], mm)]
