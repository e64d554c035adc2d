"""Persistent pipeline worker process, on a CUDA device or the CPU.

The port's copy of smh_tpu/worker.py. The reference runs capture, vision and
UI in ONE process (src/main.rs:52-74, src/vision/mod.rs:243-315); this
deployment shape splits them: a thin capture/UI client and a PERSISTENT
WORKER process that owns the device and the vision pipeline, connected by a
shared-memory frame ring (frames never cross a socket: the client writes
pixels into the ring, the worker's pack stage reads them in place) and a
unix-domain socket carrying JSON result lines back.

* Deployment: the worker sits with the card; any number of thin capture
  clients connect over the socket. frame -> markers latency is then device
  work + host stages + IPC (a socket line and one shm write).
* Upload budget: the worker watches its own uploaded-byte count and
  RECYCLES itself past a budget (SMH_WORKER_RECYCLE_MB): it finishes the
  in-flight frames, reports `{"event": "recycling"}` and exits; the
  supervising client restarts it, so a long session's host memory stays
  bounded by a fresh process.

What differs from smh_tpu's: `--device` goes to the child and to its
VisionState; the device attach before the warm frames is a CUDA init plus
an 8-byte H2D/D2H round trip; the child has no compile cache to enable and
is spawned as `python -m smh_tpu_torch.worker`; the socket and the child's
stderr log live in the temporary directory (TMPDIR).

Protocol (all little-endian, same-host only):

  shm ring        N_SLOTS x [SLOT_HDR | h*w*4 frame bytes]; SLOT_HDR is
                  (seq u64, w u32, h u32, dpi u32, state u32); state is
                  FREE -> client writes, READY -> worker may pack,
                  PACKING -> client must not touch, then FREE again.
  client->worker  one JSON line per message over the socket:
                  {"cmd": "frame", "slot": k, "seq": n}   frame ready
                  {"cmd": "ping"} / {"cmd": "stop"}
  worker->client  {"event": "ready", "pid": ...}          after warmup
                  {"event": "result", "seq": n, "sleeping": ..,
                   "markers": [[x0,y0,x1,y1]..], "ratio": ..,
                   "minimap": [l,t,r,b] | null, "ms": ..}
                  {"event": "recycling", "h2d_bytes": ...} then EOF
                  {"event": "pong"}
"""

from __future__ import annotations

import json
import logging
import os
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from multiprocessing import shared_memory
from typing import Callable, Optional

import numpy as np

log = logging.getLogger(__name__)

SLOT_HDR = struct.Struct("<QIIII")  # seq, w, h, dpi, state
FREE, READY, PACKING = 0, 1, 2
N_SLOTS = 4


def _slot_size(w: int, h: int) -> int:
    return SLOT_HDR.size + w * h * 4


class FrameRing:
    """Shared-memory ring: N_SLOTS frame slots (client -> worker) plus ONE
    map slot (worker -> client, index N_SLOTS) carrying the RGBA ui map when
    a viewer asked for it — pixels never cross the socket in either
    direction. The map slot's state field runs the opposite direction:
    FREE = worker may write, READY = client may read."""

    def __init__(self, name: str, w: int, h: int, create: bool) -> None:
        self.w, self.h = w, h
        size = (N_SLOTS + 1) * _slot_size(w, h)  # +1: the map slot
        self.shm = shared_memory.SharedMemory(name=name, create=create, size=size)
        if create:
            self.shm.buf[:size] = b"\0" * size
        else:
            # Python <=3.12 registers ATTACHED segments with the resource
            # tracker, which unlinks them when this process exits — a
            # recycled worker would destroy the ring its own replacement
            # (and the supervising client) still needs. Only the creator
            # may own the name.
            try:
                from multiprocessing import resource_tracker

                resource_tracker.unregister(self.shm._name, "shared_memory")
            except Exception:  # pragma: no cover - tracker internals moved
                pass
        self._next = 0

    def _hdr(self, k: int) -> tuple:
        off = k * _slot_size(self.w, self.h)
        return SLOT_HDR.unpack_from(self.shm.buf, off)

    def _set_hdr(self, k: int, seq: int, dpi: int, state: int) -> None:
        off = k * _slot_size(self.w, self.h)
        SLOT_HDR.pack_into(self.shm.buf, off, seq, self.w, self.h, dpi, state)

    def try_publish(self, image: np.ndarray, seq: int, dpi: int) -> Optional[int]:
        """Write a BGRA frame into a FREE slot; None when the ring is full
        (the client drops the frame — mailbox semantics, newest wins)."""
        h, w = image.shape[:2]
        assert (w, h) == (self.w, self.h) and image.dtype == np.uint8
        for _ in range(N_SLOTS):
            k = self._next
            self._next = (self._next + 1) % N_SLOTS
            if self._hdr(k)[4] == FREE:
                off = k * _slot_size(self.w, self.h) + SLOT_HDR.size
                dst = np.ndarray((h, w, 4), dtype=np.uint8, buffer=self.shm.buf, offset=off)
                dst[...] = image if image.shape[2] == 4 else np.dstack(
                    [image, np.full((h, w, 1), 255, np.uint8)]
                )
                self._set_hdr(k, seq, dpi, READY)
                return k
        return None

    def view(self, k: int) -> tuple[np.ndarray, int, int]:
        """(frame view, seq, dpi) of a READY slot; marks it PACKING."""
        seq, w, h, dpi, _state = self._hdr(k)
        self._set_hdr(k, seq, dpi, PACKING)
        off = k * _slot_size(self.w, self.h) + SLOT_HDR.size
        return (
            np.ndarray((h, w, 4), dtype=np.uint8, buffer=self.shm.buf, offset=off),
            seq,
            dpi,
        )

    def release(self, k: int) -> None:
        seq, w, h, dpi, _ = self._hdr(k)
        self._set_hdr(k, seq, dpi, FREE)

    # -- map slot (worker -> client) ----------------------------------------

    def try_write_map(self, rgba: np.ndarray, seq: int) -> bool:
        """Worker side: publish the RGBA ui map if the slot is writable
        (client has consumed the previous one). The map is a crop of the
        frame, so it always fits a frame-sized slot."""
        mh, mw = rgba.shape[:2]
        k = N_SLOTS
        if self._hdr(k)[4] != FREE or mh * mw * 4 > self.w * self.h * 4:
            return False
        off = k * _slot_size(self.w, self.h) + SLOT_HDR.size
        dst = np.ndarray((mh, mw, 4), dtype=np.uint8, buffer=self.shm.buf, offset=off)
        dst[...] = rgba
        SLOT_HDR.pack_into(self.shm.buf, k * _slot_size(self.w, self.h), seq, mw, mh, 0, READY)
        return True

    def read_map(self) -> Optional[tuple[np.ndarray, int]]:
        """Client side: copy the published map out and free the slot."""
        k = N_SLOTS
        seq, mw, mh, _dpi, state = self._hdr(k)
        if state != READY:
            return None
        off = k * _slot_size(self.w, self.h) + SLOT_HDR.size
        src = np.ndarray((mh, mw, 4), dtype=np.uint8, buffer=self.shm.buf, offset=off)
        out = src.copy()
        SLOT_HDR.pack_into(self.shm.buf, k * _slot_size(self.w, self.h), seq, mw, mh, 0, FREE)
        return out, seq

    def close(self, unlink: bool = False) -> None:
        self.shm.close()
        if unlink:
            try:
                self.shm.unlink()
            except FileNotFoundError:
                pass


# ---------------------------------------------------------------------------
# worker main (child process)


def _serve(sock_path: str, shm_name: str, w: int, h: int, device: str = "cuda") -> int:
    from . import consts as C  # noqa: F401  (config side effects)
    from .ocr.smhocr import SmhOcrEngine
    from .settings import Settings
    from .squadex.capture import Frame
    from .vision.pipeline import VisionState

    recycle_mb = float(os.environ.get("SMH_WORKER_RECYCLE_MB", "2048"))
    ring = FrameRing(shm_name, w, h, create=False)
    settings = Settings(path=None)
    settings.set("hardware_acceleration", True, save=False)
    state = VisionState(settings=settings, ocr_engine=SmhOcrEngine(), scales_async=True, device=device)

    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    conn.connect(sock_path)
    # NOTE: socket.makefile(buffering=1) does NOT line-flush (measured on
    # this CPython: the line sits in the writer's buffer forever) — every
    # send flushes explicitly.
    wfile = conn.makefile("w")

    # Explicit read buffer instead of makefile("r"): the serve loop must
    # know whether a complete COMMAND LINE is already buffered (a burst of
    # frame messages can arrive in one recv; selecting on the raw socket
    # alone would miss them and needlessly drain the pipeline).
    rbuf = bytearray()

    def buffered_line() -> bool:
        return b"\n" in rbuf

    def read_line() -> str:
        """Blocking read of one newline-terminated message ('' on EOF)."""
        while b"\n" not in rbuf:
            chunk = conn.recv(65536)
            if not chunk:
                return ""
            rbuf.extend(chunk)
        line, _, rest = bytes(rbuf).partition(b"\n")
        rbuf[:] = rest
        return line.decode()

    send_lock = threading.Lock()

    def send(obj: dict) -> None:
        with send_lock:
            wfile.write(json.dumps(obj) + "\n")
            wfile.flush()

    # Warm THIS resolution before reporting ready, so the first real frame
    # doesn't pay the kernels' build, the tables and the allocator's growth.
    # Warming events + a heartbeat flow to the client throughout, so the
    # supervising client can tell "slow warmup" (a cold nvcc build) from
    # "dead child".
    from . import testing

    t_warm = time.time()
    send({"event": "warming", "step": 0, "total": 2, "elapsed_s": 0.0})
    hb_stop = threading.Event()
    attach_s = [0.0]

    def heartbeat() -> None:
        while not hb_stop.wait(15.0):
            try:
                send({
                    "event": "warming", "step": None, "total": 2,
                    "elapsed_s": round(time.time() - t_warm, 1),
                })
            except Exception:
                return

    hb = threading.Thread(target=heartbeat, daemon=True, name="smh-warm-hb")
    hb.start()
    try:
        # Attach the device BEFORE the pipeline warmup so the two costs are
        # separable in the ready event: the CUDA context and a first copy
        # each way are not a pipeline cost.
        if state.settings.get("hardware_acceleration") and device.startswith("cuda"):
            import torch

            t0 = time.time()
            torch.cuda.init()
            torch.zeros(8, dtype=torch.uint8).to(device).cpu()
            attach_s[0] = round(time.time() - t0, 1)
        warm = testing.make_frame(w, h, marker_lines=[((50, 50), (200, 120))])
        for i in range(2):
            state.process(Frame(warm, 96))
            send({
                "event": "warming", "step": i + 1, "total": 2,
                "elapsed_s": round(time.time() - t_warm, 1),
            })
    finally:
        hb_stop.set()
    send({"event": "ready", "pid": os.getpid(),
          "warmup_s": round(time.time() - t_warm, 1),
          "attach_s": attach_s[0]})

    maps_on = [False]  # {"cmd": "maps", "on": true} from a viewer-ful client
    last_map_id = [0]

    def finish(frame: "Frame", seq: int, t0: float, sub: Optional[dict]) -> None:
        results = state.process(frame, submitted=sub)
        out = {
            "event": "result",
            "seq": seq,
            "ms": round((time.perf_counter() - t0) * 1e3, 3),
        }
        if results is None:
            out["sleeping"] = True
        else:
            out["sleeping"] = False
            out["markers"] = [
                [l.p0.x, l.p0.y, l.p1.x, l.p1.y] for l in results.markers
            ]
            out["ratio"] = results.meters_to_px_ratio
            mb = results.minimap_bounds
            out["minimap"] = [mb.left, mb.top, mb.right, mb.bottom] if mb else None
        send(out)
        # Map push, display-cadence: only when a viewer asked, only when the
        # backend's checksum cache says the pixels changed (identical object
        # = unchanged, mirroring app._on_update's id() dedup), and only when
        # the client freed the slot (a slow viewer drops map frames, never
        # detections).
        if maps_on[0] and results is not None:
            m = results.map  # lazy device fetch, checksum-deduped
            if m is not None and id(m) != last_map_id[0]:
                if ring.try_write_map(m, seq):
                    last_map_id[0] = id(m)
                    send({"event": "map", "seq": seq,
                          "mw": m.shape[1], "mh": m.shape[0]})

    # Pipelined consumption, same shape as VisionLoop: when the client is
    # STREAMING (another frame message is already waiting on the socket, or
    # fewer than `depth` frames are in flight) submit the new frame and defer
    # its consume, so its background hostpack D2H overlaps the host stages of
    # the previous frames; when the client is waiting (no queued input),
    # drain immediately — a sync client sees plain request/response latency.
    import select
    from collections import deque

    depth = 3
    pending: deque = deque()  # (frame, seq, t0, submitted)
    try:
        while True:
            if (
                pending
                and not buffered_line()
                and not select.select([conn], [], [], 0)[0]
            ):
                f, seq, t0, sub = pending.popleft()
                finish(f, seq, t0, sub)
                continue
            line = read_line()
            if not line:
                break
            msg = json.loads(line)
            cmd = msg.get("cmd")
            if cmd == "stop":
                break
            if cmd == "ping":
                send({"event": "pong"})
                continue
            if cmd == "maps":
                maps_on[0] = bool(msg.get("on"))
                continue
            if cmd != "frame":
                continue
            image, seq, dpi = ring.view(msg["slot"])
            t0 = time.perf_counter()
            frame = Frame(image, dpi or None)
            sub = state.submit(frame)
            if sub is None:
                # Unpipelined fallback path: process() will read the frame
                # during load_frame, AFTER the slot could recycle — copy.
                frame = Frame(image.copy(), dpi or None)
                ring.release(msg["slot"])
                finish(frame, seq, t0, None)
            else:
                # submit() already packed the ROIs out of the slot; the only
                # later reader of frame.image would be the numpy minimap
                # fallback, which the CUDA backend never takes (the minimap
                # rect ships in the hostpack). Releasing now saves a 33 MB
                # frame copy per 4K frame.
                ring.release(msg["slot"])
                pending.append((frame, seq, t0, sub))
                if len(pending) >= depth:
                    f, seq2, t2, sub2 = pending.popleft()
                    finish(f, seq2, t2, sub2)
            backend = state.delegate.backend  # re-read: may hot-swap/fall back
            h2d = getattr(backend, "stats", {}).get("h2d_bytes", 0)
            if h2d > recycle_mb * 1e6:
                # Upload budget: recycle; the supervisor restarts us.
                while pending:
                    f, seq2, t2, sub2 = pending.popleft()
                    finish(f, seq2, t2, sub2)
                send({"event": "recycling", "h2d_bytes": int(h2d)})
                return 42
        while pending:
            f, seq2, t2, sub2 = pending.popleft()
            finish(f, seq2, t2, sub2)
    finally:
        state.close()
        ring.close()
        conn.close()
    return 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="smh_tpu_torch pipeline worker")
    ap.add_argument("--sock", required=True)
    ap.add_argument("--shm", required=True)
    ap.add_argument("--width", type=int, required=True)
    ap.add_argument("--height", type=int, required=True)
    ap.add_argument("--device", default="cuda", help='"cuda", "cuda:N" or "cpu"')
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return _serve(args.sock, args.shm, args.width, args.height, args.device)


# ---------------------------------------------------------------------------
# client (parent process)


class WorkerClient:
    """Supervises a worker process: spawns it, feeds frames through the shm
    ring, delivers result lines to a callback, and TRANSPARENTLY restarts
    the worker when it recycles itself (or dies). Frames submitted while no
    worker is up are dropped (mailbox semantics — the next frame catches
    up), mirroring the per-frame error tolerance of the in-process loop."""

    def __init__(
        self,
        w: int,
        h: int,
        on_result: Callable[[dict], None],
        sock_dir: Optional[str] = None,
        env: Optional[dict] = None,
        max_restarts: int = 100,
        on_map: Optional[Callable[[np.ndarray, int], None]] = None,
        device="cuda",
    ) -> None:
        """device: the worker's ("cuda", "cuda:N" or "cpu"); a CUDA device
        that is absent raises here. sock_dir: where the socket and the
        child's stderr log go (default: the temporary directory)."""
        from . import resolve_device

        self.device = str(resolve_device(device))
        sock_dir = tempfile.gettempdir() if sock_dir is None else sock_dir
        self.w, self.h = w, h
        self.on_result = on_result
        self.on_map = on_map
        self._maps_on = False
        self._env = env
        self._max_restarts = max_restarts
        self.restarts = 0
        tag = f"smhw-{os.getpid()}-{id(self) & 0xFFFF:x}"
        self.sock_path = os.path.join(sock_dir, tag + ".sock")
        self.shm_name = tag
        self.ring = FrameRing(self.shm_name, w, h, create=True)
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(self.sock_path)
        self._listener.listen(1)
        self._proc: Optional[subprocess.Popen] = None
        self._wfile = None
        self._seq = 0
        self._lock = threading.Lock()
        self._ready = threading.Event()
        self._closed = False
        # Diagnostics: the child's stderr is teed to a file (compile
        # tracebacks land there), every socket event stamps
        # last_event_ts, and warming events carry the child's own warmup
        # progress — diagnose() folds all of it into one line so a failed
        # readiness wait names the actual failure.
        self._stderr_path = os.path.join(sock_dir, tag + ".stderr")
        self.last_event_ts: float = time.time()
        self.last_warming: Optional[dict] = None
        self.ready_info: Optional[dict] = None
        self.last_exit_code: Optional[int] = None
        self._thread = threading.Thread(target=self._supervise, daemon=True, name="smh-worker-sup")
        self._thread.start()

    # -- supervisor thread --------------------------------------------------

    def _spawn(self) -> None:
        env = dict(os.environ)
        if self._env:
            env.update(self._env)
        stderr_fh = open(self._stderr_path, "ab")
        stderr_fh.write(b"\n--- spawn ---\n")
        try:
            self._proc = subprocess.Popen(
                [
                    sys.executable, "-m", "smh_tpu_torch.worker",
                    "--sock", self.sock_path, "--shm", self.shm_name,
                    "--width", str(self.w), "--height", str(self.h), "--device", self.device,
                ],
                env=env,
                cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                stderr=stderr_fh,
            )
        finally:
            stderr_fh.close()  # the child holds its own fd now

    def _supervise(self) -> None:
        while not self._closed and self.restarts <= self._max_restarts:
            self._spawn()
            try:
                self._listener.settimeout(1.0)
                while not self._closed:
                    try:
                        conn, _ = self._listener.accept()
                        break
                    except socket.timeout:
                        if self._proc.poll() is not None:
                            raise RuntimeError(
                                f"worker exited rc={self._proc.returncode} before connecting"
                            )
                else:
                    return
                rfile = conn.makefile("r")
                with self._lock:
                    self._wfile = conn.makefile("w")
                recycling = False
                try:
                    for line in rfile:
                        msg = json.loads(line)
                        ev = msg.get("event")
                        self.last_event_ts = time.time()
                        if ev == "warming":
                            self.last_warming = msg
                        elif ev == "ready":
                            self.ready_info = msg
                            self._ready.set()
                            if self._maps_on:  # re-arm after a recycle restart
                                self._send_cmd({"cmd": "maps", "on": True})
                        elif ev == "recycling":
                            recycling = True
                            log.info("worker recycling after %s uploaded bytes", msg.get("h2d_bytes"))
                        elif ev == "map":
                            got = self.ring.read_map()
                            if got is not None and self.on_map is not None:
                                self.on_map(got[0], got[1])
                        elif ev == "result":
                            self.on_result(msg)
                except ConnectionResetError:
                    # The child exited with frames still unread on its
                    # socket (a recycle mid-stream): that is its EOF.
                    pass
                conn.close()
                try:
                    self._proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    # A worker that reported EOF but never exited must not
                    # coexist with its replacement (two device clients).
                    log.warning("worker pid %s hung after EOF; terminating", self._proc.pid)
                    self._proc.terminate()
                    try:
                        self._proc.wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        self._proc.kill()
                        self._proc.wait(timeout=10)
                self.last_exit_code = self._proc.returncode
                if not recycling and not self._closed:
                    log.warning("worker died rc=%s; restarting", self._proc.returncode)
            except Exception:
                if self._proc is not None:
                    self.last_exit_code = self._proc.poll()
                if not self._closed:
                    log.exception("worker supervision error; restarting")
                    time.sleep(1.0)
            finally:
                self._ready.clear()
                with self._lock:
                    self._wfile = None
            if not self._closed:
                self.restarts += 1

    # -- client API -----------------------------------------------------------

    def wait_ready(self, timeout: float = 600.0) -> bool:
        return self._ready.wait(timeout)

    def wait_ready_progress(
        self, idle_timeout: float = 180.0, max_s: float = 2400.0
    ) -> bool:
        """Progress-aware readiness wait: keep waiting while the child shows
        signs of life (warming heartbeats arrive every ~15 s during even the
        slowest compile), fail FAST when it stops — a dead child is detected
        in ~idle_timeout instead of a flat-deadline burn (round 4's 900 s).
        max_s bounds a pathological heartbeat-forever child."""
        t0 = time.monotonic()
        while not self._closed:
            if self._ready.wait(5.0):
                return True
            now = time.monotonic()
            if now - t0 > max_s:
                return False
            if time.time() - self.last_event_ts > idle_timeout:
                # No event in the window: the supervisor is either between
                # restarts or the child is wedged. Give restarts a chance
                # only while the process object looks alive.
                proc = self._proc
                if proc is None or proc.poll() is not None:
                    return False
                if time.time() - self.last_event_ts > 2 * idle_timeout:
                    return False  # alive but mute for 2 windows: give up
        return False

    def stderr_tail(self, n: int = 600) -> str:
        try:
            with open(self._stderr_path, "rb") as fh:
                fh.seek(0, os.SEEK_END)
                size = fh.tell()
                fh.seek(max(0, size - n))
                return fh.read().decode(errors="replace").strip()
        except OSError:
            return ""

    def diagnose(self) -> str:
        """One line naming the worker's current state — for error paths
        (the bench's worker_error must say WHAT failed, not just that a
        wait expired)."""
        proc = self._proc
        rc = proc.poll() if proc is not None else None
        parts = [
            f"ready={self._ready.is_set()}",
            f"restarts={self.restarts}",
            f"exit_code={rc if rc is not None else self.last_exit_code}",
            f"last_event_age_s={round(time.time() - self.last_event_ts, 1)}",
        ]
        if self.last_warming is not None:
            lw = self.last_warming
            parts.append(
                f"warming(step={lw.get('step')}/{lw.get('total')},"
                f" elapsed_s={lw.get('elapsed_s')})"
            )
        tail = self.stderr_tail()
        if tail:
            parts.append("stderr: " + " | ".join(tail.splitlines()[-4:]))
        return "; ".join(parts)

    def _send_cmd(self, obj: dict) -> bool:
        with self._lock:
            wfile = self._wfile
            if wfile is None:
                return False
            try:
                wfile.write(json.dumps(obj) + "\n")
                wfile.flush()
                return True
            except Exception:
                return False

    def set_maps(self, on: bool) -> None:
        """Ask the worker to publish the ui map (through the shm map slot)
        whenever its device checksum changes. Survives worker recycles."""
        self._maps_on = on
        self._send_cmd({"cmd": "maps", "on": on})

    def submit(self, image: np.ndarray, dpi: int = 96) -> Optional[int]:
        """Publish a frame; returns its seq, or None if dropped (ring full /
        worker down). Never blocks on the worker."""
        with self._lock:
            wfile = self._wfile
            if wfile is None or not self._ready.is_set():
                return None
            self._seq += 1
            seq = self._seq
            slot = self.ring.try_publish(image, seq, dpi)
            if slot is None:
                return None
            try:
                wfile.write(json.dumps({"cmd": "frame", "slot": slot, "seq": seq}) + "\n")
                wfile.flush()
            except Exception:
                return None
            return seq

    def close(self) -> None:
        self._closed = True
        with self._lock:
            if self._wfile is not None:
                try:
                    self._wfile.write('{"cmd": "stop"}\n')
                    self._wfile.flush()
                except Exception:
                    pass
        if self._proc is not None:
            try:
                self._proc.wait(timeout=10)
            except Exception:
                self._proc.terminate()
                try:
                    self._proc.wait(timeout=10)
                except Exception:
                    self._proc.kill()
        self._thread.join(timeout=5)
        try:
            self._listener.close()
        finally:
            self.ring.close(unlink=True)
            try:
                os.unlink(self.sock_path)
            except FileNotFoundError:
                pass
            try:
                os.unlink(self._stderr_path)
            except FileNotFoundError:
                pass


if __name__ == "__main__":
    sys.exit(main())
