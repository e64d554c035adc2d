"""Application entry point of the port: capture -> vision -> web on CUDA.

The port's copy of smh_tpu/app.py (counterpart of
/root/reference/src/main.rs:33-124 and the UI data bus,
src/ui/mod.rs:93-141), with the port's VisionState on an explicit device.
--warmup runs ops/warmup.py on that device before serving; --worker runs
the pipeline in a worker process (worker.py) on it. Left out: the compile
cache (no JAX here).

Usage:
  python -m smh_tpu_torch.app --synthetic --pipelined --no-web   # on a CUDA device
  python -m smh_tpu_torch.app --synthetic --warmup --worker --no-web   # warmed, in a worker process
  python -m smh_tpu_torch.app --synthetic --pipelined --lsd-engine cuda --no-web   # line search on the card
  python -m smh_tpu_torch.app --synthetic --debug-web   # debug telemetry + /api/debug-view
  python -m smh_tpu_torch.app --synthetic --backend numpy --device cpu   # the numpy oracle, no card
  python -m smh_tpu_torch.app --image frame.png --device cuda:1
  python -m smh_tpu_torch.app --list-maps --paks ... --ripper .. # heightmap tools
"""

from __future__ import annotations

import argparse
import logging
import pathlib
import signal
import threading
from typing import Optional

import numpy as np

from . import consts as C
from .ocr import tesseract
from .settings import LSD_ENGINES, Settings
from .squadex import heightmaps as hm_store
from .squadex.capture import (
    BlackoutFallbackSource,
    CaptureThread,
    DirectorySource,
    ScreenSource,
    StaticSource,
    VideoSource,
    load_frame_bgra,
)
from .vision.pipeline import VisionLoop, VisionResults, VisionState
from .web.server import WebServer
from .web import protocol

log = logging.getLogger(__name__)

class App:
    """Owns the threads and the UI-data bus between vision and web."""

    def __init__(
        self,
        source,
        settings: Optional[Settings] = None,
        port: int = 8080,
        ocr_engine=None,
        serve: bool = True,
        pipelined: bool = False,
        debug_web: bool = False,
        scales_async: bool = False,
        paks: Optional[list[str]] = None,
        aes: Optional[str] = None,
        ripper_exe: Optional[str] = None,
        cache_dir: str = "heightmaps",
        device="cuda",
        worker: bool = False,
    ) -> None:
        """device: "cuda" / "cuda:N" runs the CUDA backend, "cpu" its plain
        PyTorch versions.

        worker=True runs the vision pipeline in a PERSISTENT WORKER PROCESS
        (smh_tpu_torch/worker.py) on that device instead of an in-process
        thread: frames cross a shared-memory ring, detections come back over
        a unix socket, and the worker recycles itself past its upload
        budget. The in-process knobs that live inside the pipeline (debug
        views, backend hot-swap) are owned by the worker in this mode."""
        self.device = device
        self.settings = settings or Settings()
        # Log observability surface (reference: in-app log window fed by a
        # channel with repeat-collapse + auto-open-on-error,
        # src/ui/logs.rs:22-56,195-259): a process-wide ring buffer feeds
        # /api/logs; the web client polls it and auto-opens on new errors.
        from .utils import ringlog

        self.ringlog = ringlog.install()
        self.ocr_engine = ocr_engine if ocr_engine is not None else tesseract.create_default_engine()
        # --debug-web collects per-frame OCR boxes + scale overlays for the
        # client debug surface (the reference's debug UI recomputes them the
        # same way while open, src/ui/debug.rs:288-345).
        self.state = VisionState(
            settings=self.settings,
            ocr_engine=self.ocr_engine,
            collect_debug_overlays=debug_web,
            scales_async=scales_async and not debug_web,
            device=device,
        )
        self.paks = paks or []  # CLI override; see _effective_paks()
        self.aes = aes
        self.ripper_exe = ripper_exe
        self.cache_dir = cache_dir
        self.capture = CaptureThread(source)
        self.worker_mode = worker
        self._worker_client = None
        self._worker_thread: Optional[threading.Thread] = None
        self._worker_map = None  # latest ui map pushed through the shm slot
        if worker:
            self.loop = None
        else:
            self.loop = VisionLoop(self.state, self.capture, self._on_update, pipelined=pipelined)
        self.web = WebServer(port=port) if serve else None
        self.custom_markers: list[tuple[tuple[float, float], tuple[float, float]]] = []
        self._lock = threading.Lock()
        self._shutdown = threading.Event()
        self._last_results = None
        self.fit_to_minimap = False
        self.debug_web = debug_web
        self._last_update_ts = None
        if self.web is not None:
            self.web.on_client_connect = self._on_client_connect
            # Wake path for client interactions so custom markers work even
            # when no new frames arrive (static --image sources): the
            # reference wakes its UI loop the same way (web/src/ws.rs:60-74).
            self.web.on_interaction = self._drain_interactions
            self.web.api_handler = self._api
        self._last_map_id: int = 0

    # -- vision -> web push (src/ui/map.rs:222-233, state.rs:81-88) ---------

    def _on_update(self, results, debug) -> None:
        if self.web is None:
            return
        # Drain client interactions even while sleeping (map closed): custom
        # markers placed then must not queue up invisibly until it reopens.
        self._drain_interactions()
        if results is None:
            return  # sleeping: keep the last map on clients
        self._last_results = results
        # The ui map is lazy: only pull it off the device (and encode 1-13 MB
        # of websocket traffic) when someone is watching AND it changed — the
        # backend's checksum cache returns the identical array object for an
        # unchanged map (the reference skips on crc32, src/ui/map.rs:213-226).
        if self.web.num_clients() > 0 and results.map is not None:
            if id(results.map) != self._last_map_id:
                self.web.send_map(results.map)
                self._last_map_id = id(results.map)
        self.web.send_markers(
            [((l.p0.x, l.p0.y), (l.p1.x, l.p1.y)) for l in results.markers], custom=False
        )
        self.web.send_update_state(results.meters_to_px_ratio, results.minimap_bounds)
        if self.debug_web:
            import time as _time

            now = _time.time()
            fps = 1.0 / (now - self._last_update_ts) if self._last_update_ts else 0.0
            self._last_update_ts = now
            backend = self.state.delegate.backend
            payload = {
                "fps": round(fps, 2),
                "backend": backend.name if backend else "?",
                "timeshares_ms": {k: round(v * 1000, 2) for k, v in debug.timeshares.as_dict().items()},
                "markers": len(results.markers),
                # OCR boxes + scale-bar overlays in map-ROI coordinates
                # (src/ui/debug.rs:288-317).
                "ocr": [
                    {"text": o.text, "conf": round(o.confidence, 1),
                     "l": o.left, "t": o.top, "r": o.right, "b": o.bottom}
                    for o in debug.ocr
                ],
                "scales": [
                    {"m": m, "x0": l.p0.x, "y0": l.p0.y, "x1": l.p1.x, "y1": l.p1.y}
                    for m, l in debug.scales
                ],
            }
            stats = getattr(backend, "stats", None)
            if stats:
                payload["stats"] = dict(stats)
            host = getattr(backend, "_host", None)
            if host and "lsd_bbox" in host:
                payload["lsd_bbox"] = list(host["lsd_bbox"])
                payload["lsd_window"] = list(host.get("lsd_offset", (0, 0))) + list(
                    host.get("lsd_crop_shape", (0, 0))[::-1]
                )
            self.web.send_debug(payload)

    def _on_client_connect(self) -> None:
        """A viewer just joined: materialize and push the current map."""
        results = self._last_results
        if results is not None and self.web is not None and results.map is not None:
            self.web.send_map(results.map)

    # -- web -> app interactions (src/ui/web.rs:131-144) --------------------

    def _drain_interactions(self) -> None:
        assert self.web is not None
        changed = False
        while True:
            inter = self.web.recv()
            if inter is None:
                break
            with self._lock:
                if isinstance(inter, protocol.AddCustomMarker):
                    self.custom_markers.append((inter.p0, inter.p1))
                    changed = True
                elif isinstance(inter, protocol.DeleteCustomMarker):
                    if 0 <= inter.index < len(self.custom_markers):
                        self.custom_markers.pop(inter.index)
                        changed = True
                elif isinstance(inter, protocol.InspectPixel):
                    self._inspect_pixel(inter.x, inter.y)
        if changed:
            with self._lock:
                markers = list(self.custom_markers)
            self.web.send_markers(markers, custom=True)

    def _inspect_pixel(self, x: int, y: int) -> None:
        """Pixel inspector (src/ui/debug.rs:350-475): HSV + per-fireteam
        predicate breakdown for a map-ROI pixel, pushed as event 101."""
        if self.web is None:
            return
        try:
            backend = self.state.delegate.backend
            frame = getattr(backend, "frame_np", None) if backend is not None else None
            if frame is None:
                return  # no frame processed yet
            g = C.map_geometry(frame.shape[1], frame.shape[0])
            if not (0 <= x < g.map_w and 0 <= y < g.map_h):
                return
            b, gr, r = (int(v) for v in frame[g.map_y + y, g.map_x + x, :3])
            from .vision.inspect import inspect_pixel

            ins = inspect_pixel(r, gr, b)
            self.web.send_inspect(
                {
                    "x": x, "y": y,
                    "rgb": list(ins.rgb), "h": ins.h, "s": ins.s, "v": ins.v,
                    "min_sat_ok": ins.min_sat_ok,
                    "is_marker": ins.is_marker,
                    "fireteams": {
                        name: {"hue": ft.hue_ok, "sat": ft.sat_ok, "vib": ft.vib_ok,
                               "passed": ft.passed}
                        for name, ft in ins.fireteams.items()
                    },
                }
            )
        except Exception:
            log.exception("pixel inspection failed")

    # -- heightmap browser HTTP API (src/ui/heightmaps.rs:254-321,413-792) ----

    def _effective_paks(self) -> list:
        """Pak dirs for the heightmap browser: CLI --paks wins; otherwise the
        persisted squad_dir setting is scanned (workshop paks + the game's
        Paks dir) — so /api/settings/set squad_dir actually takes effect,
        like the reference's SQUAD_DIR setting (src/ui/heightmaps.rs:26-64)."""
        if self.paks:
            return self.paks
        sd = self.settings.squad_dir()
        if sd:
            from .heightmaps import ripper as _ripper

            p = pathlib.Path(sd)
            cand = _ripper.find_workshop_paks(p) + [
                str(p / "SquadGame" / "Content" / "Paks")
            ]
            return [d for d in cand if pathlib.Path(d).is_dir()]
        return []

    def _effective_aes(self):
        return self.aes or self.settings.squad_pak_aes()

    def _api(self, path: str, query: dict) -> tuple[int, object]:
        import pathlib

        from .heightmaps import browser, ripper
        from .squadex import heightmaps as hms

        if path == "/api/status":
            hm = hm_store.get_current()
            backend = self.state.delegate.backend
            return 200, {
                "heightmap": None if hm is None else {"w": hm.width, "h": hm.height},
                "fit_to_minimap": self.fit_to_minimap,
                "clients": self.web.num_clients() if self.web else 0,
                "backend": backend.name if backend else None,
                "paks_configured": bool(self._effective_paks()),
            }
        if path == "/api/heightmaps/cached":
            d = pathlib.Path(self.cache_dir)
            files = sorted(p.name for p in d.glob("*.smhhm")) if d.is_dir() else []
            return 200, {"files": files}
        if path == "/api/heightmaps/layers":
            paks = self._effective_paks()
            if not paks:
                return 400, {"error": "no paks configured (--paks or the squad_dir setting)"}
            exe = self.ripper_exe or ripper.DEFAULT_EXE
            try:
                layers = ripper.list_maps(paks, self._effective_aes(), exe=exe)
            except Exception as e:
                return 500, {"error": str(e)}
            return 200, {"layers": layers}
        if path == "/api/heightmaps/select":
            layer = query.get("layer")
            fname = query.get("file")
            hm = None
            if fname:
                fp = pathlib.Path(self.cache_dir) / pathlib.Path(fname).name
                if not fp.is_file():
                    return 404, {"error": f"{fname} not cached"}
                hm = hms.load_smhhm(fp)
            elif layer:
                paks = self._effective_paks()
                if not paks:
                    return 400, {"error": "no paks configured (--paks or the squad_dir setting)"}
                exe = self.ripper_exe or ripper.DEFAULT_EXE
                try:
                    hm = browser.load_or_rip(
                        layer, paks, self._effective_aes(),
                        cache_dir=self.cache_dir, exe=exe,
                    )
                except Exception as e:
                    return 500, {"error": str(e)}
            else:
                return 400, {"error": "need ?layer= or ?file="}
            if hm is None:
                return 404, {"error": "layer has no heightmap"}
            self.select_heightmap(hm)
            return 200, {"ok": True, "w": hm.width, "h": hm.height}
        if path == "/api/heightmaps/deselect":
            self.select_heightmap(None)
            return 200, {"ok": True}
        if path == "/api/fit":
            self.set_fit_to_minimap(query.get("on", "0") in ("1", "true"))
            return 200, {"ok": True, "fit_to_minimap": self.fit_to_minimap}
        if path == "/api/logs":
            # Ring-buffer log surface (src/ui/logs.rs:22-56): entries past
            # ?since= (a seq cursor), plus the running ERROR+ count so the
            # client can auto-open the panel on new errors (logs.rs:195-259).
            try:
                since = int(query.get("since", "0"))
            except ValueError:
                since = 0
            ents, seq, errors = self.ringlog.snapshot(since=since)
            entries = [
                {
                    "seq": e.seq,
                    "ts": round(e.ts, 3),
                    "level": logging.getLevelName(e.level),
                    "message": e.message,
                    "count": e.count,
                }
                for e in ents
            ]
            return 200, {"entries": entries, "seq": seq, "errors": errors}
        if path == "/api/settings":
            # Runtime settings surface (reference settings UI,
            # src/settings.rs:30-142): read everything; paused rides along
            # (non-persisted, settings.rs:5).
            return 200, {
                "hardware_acceleration": self.settings.hardware_acceleration(),
                "detect_markers": self.settings.detect_markers(),
                "grayscale_map": self.settings.grayscale_map(),
                "paused": self.settings.paused(),
                "squad_dir": self.settings.squad_dir(),
                "squad_pak_aes": self.settings.squad_pak_aes(),
                "lsd_engine": self.settings.lsd_engine(),
            }
        if path == "/api/settings/set":
            key = query.get("key")
            value = query.get("value")
            if key is None or value is None:
                return 400, {"error": "need ?key= and ?value="}
            bool_keys = ("hardware_acceleration", "detect_markers", "grayscale_map")
            if key == "paused":
                # Not persisted; the vision loop re-checks it per frame and
                # parks (reference PAUSED atomic, settings.rs:5).
                self.settings.set_paused(value in ("1", "true", "on"))
                self._wake()
            elif key in bool_keys:
                # Saved on set like every reference setting; the vision loop
                # reads these per frame, so hardware_acceleration flips the
                # backend live (BackendDelegate re-checks each frame) and
                # grayscale_map re-dispatches with the new ui plane.
                self.settings.set(key, value in ("1", "true", "on"))
                self._wake()
            elif key in ("squad_dir", "squad_pak_aes"):
                self.settings.set(key, value or None)
            elif key == "lsd_engine":
                if value not in LSD_ENGINES:
                    return 400, {"error": f"lsd_engine must be one of {list(LSD_ENGINES)}"}
                self.settings.set(key, value)
            else:
                return 400, {"error": f"unknown setting {key}"}
            _, obj = self._api("/api/settings", {})
            return 200, obj
        if path == "/api/debug-view":
            # The reference's "Computer Vision Outputs" debug window
            # (vision-common/src/debug.rs:33-52, backends' get_debug_view):
            # serve any intermediate pipeline image as a PNG. Costs a device
            # fetch + a re-dispatch with intermediates on the next frame.
            from io import BytesIO

            from PIL import Image

            from .vision.reference import DebugView

            name = query.get("choice", "LSD_INPUT").upper()
            try:
                choice = DebugView[name]
            except KeyError:
                return 400, {"error": f"unknown view {name}", "choices": [v.name for v in DebugView]}
            backend = self.state.delegate.backend
            if backend is None:
                return 404, {"error": "no frames processed yet"}
            if hasattr(backend, "set_debug"):
                backend.set_debug(True)  # materialize intermediates from now on
            img = backend.get_debug_view(choice)
            if img is None:
                return 404, {
                    "error": f"{name} not available yet (debug intermediates "
                    "materialize from the next frame on)",
                }
            buf = BytesIO()
            Image.fromarray(img).save(buf, format="PNG")
            return 200, ("image/png", buf.getvalue())
        return 404, {"error": f"unknown endpoint {path}"}

    # -- heightmap selection (src/ui/heightmaps.rs:590-593) ------------------

    def select_heightmap(self, hm) -> None:
        hm_store.set_current(hm)
        if self.web is not None:
            self.web.send_heightmap(hm)

    def set_fit_to_minimap(self, fit: bool) -> None:
        """Heightmap alignment mode (heightmaps.rs:794-826): fit the
        heightmap to the detected minimap bounds vs apply its world offset."""
        self.fit_to_minimap = fit
        if self.web is not None:
            self.web.send_fit_to_minimap(fit)

    # -- lifecycle ----------------------------------------------------------

    def _wake(self) -> None:
        """Re-deliver the current frame after a runtime settings flip. In
        worker mode the feeder polls the mailbox anyway; invalidating the
        capture dedup is all that's needed."""
        if self.loop is not None:
            self.loop.wake()
        else:
            resend = getattr(self.capture, "resend", None)
            if resend is not None:
                resend()

    # -- worker mode: feed the worker process from the capture mailbox -------

    def _run_worker_feeder(self) -> None:
        from . import consts as C_
        from .geometry import Line, Rect
        from .utils.timeshares import Timeshares
        from .vision.pipeline import DebugBox
        from .worker import WorkerClient

        interval = 1.0 / float(C_.VISION_FPS)

        def on_map(rgba, _seq) -> None:
            self._worker_map = rgba  # fresh object per push: id() dedup works
            # The worker emits the map AFTER its frame's result event, and a
            # static scene produces no further results — push to viewers now
            # and backfill the retained results so late connectors get it.
            if self._last_results is not None:
                self._last_results._map = rgba
            if self.web is not None and self.web.num_clients() > 0:
                self.web.send_map(rgba)
                self._last_map_id = id(rgba)

        def on_result(msg: dict) -> None:
            debug = DebugBox(timeshares=Timeshares())
            debug.timeshares.entire_frame = msg.get("ms", 0.0) / 1000.0
            if msg.get("sleeping"):
                self._on_update(None, debug)
                return
            results = VisionResults()
            results.markers = [
                Line.from_tuple(((x0, y0), (x1, y1)))
                for x0, y0, x1, y1 in msg.get("markers", [])
            ]
            results.meters_to_px_ratio = msg.get("ratio")
            mm = msg.get("minimap")
            results.minimap_bounds = (
                Rect(left=mm[0], top=mm[1], right=mm[2], bottom=mm[3]) if mm else None
            )
            results._map = self._worker_map
            self._on_update(results, debug)

        wc = None
        undelivered = None  # last frame the worker hasn't accepted yet:
        # a static source publishes each distinct frame ONCE (capture
        # dedup), and the worker spends its first ~minute warming up —
        # dropping that one frame would leave the session blank forever.
        try:
            while not self._shutdown.is_set():
                if self.settings.paused():
                    self._shutdown.wait(0.05)
                    continue
                frame = self.capture.fresh_frame()
                if frame is None:
                    frame = undelivered
                if frame is None:
                    self._shutdown.wait(interval)
                    continue
                h, w = frame.image.shape[:2]
                if wc is None or (wc.w, wc.h) != (w, h):
                    if wc is not None:
                        wc.close()
                    log.info("starting pipeline worker for %dx%d", w, h)
                    wc = WorkerClient(w, h, on_result, on_map=on_map, device=self.device)
                    self._worker_client = wc
                    wc.set_maps(self.web is not None)
                accepted = wc.submit(frame.image, frame.dpi or 96)
                undelivered = None if accepted is not None else frame
                self._shutdown.wait(interval)
        finally:
            if wc is not None:
                wc.close()
            self._worker_client = None

    def start(self) -> "App":
        if self.web is not None:
            self.web.start()
            log.info("web UI at %s", self.web.addr)
        self.capture.start()
        if self.loop is not None:
            self.loop.start()
        else:
            self._worker_thread = threading.Thread(
                target=self._run_worker_feeder, name="worker-feeder", daemon=True
            )
            self._worker_thread.start()
        return self

    def stop(self) -> None:
        self._shutdown.set()
        if self.loop is not None:
            self.loop.stop()
        if self._worker_thread is not None:
            self._worker_thread.join(timeout=15.0)
        self.capture.stop()
        if self.web is not None:
            self.web.stop()

    def wait(self) -> None:
        try:
            while not self._shutdown.wait(0.5):
                pass
        except KeyboardInterrupt:
            pass


def _build_source(args):
    from . import testing

    if args.image:
        return StaticSource(load_frame_bgra(args.image), dpi=args.dpi)
    if args.dir:
        return DirectorySource(args.dir, dpi=args.dpi)
    if args.video:
        return VideoSource(args.video, dpi=args.dpi, loop=True)
    if args.screen:
        region = None
        if args.region:
            region = tuple(int(v) for v in args.region.split(","))
            if len(region) != 4:
                raise SystemExit("--region wants x,y,w,h")
        return ScreenSource(region=region, dpi=args.dpi)
    frame = testing.make_frame(
        1920, 1080,
        marker_lines=[((120, 150), (700, 520))],
        scale_bars=[(60, 200, 120, 1)],
    )
    return StaticSource(frame, dpi=args.dpi)


def build_parser() -> argparse.ArgumentParser:
    """smh_tpu.app's command line with --device and the backends "cuda" and
    "numpy"."""
    ap = argparse.ArgumentParser(description="Squad Mortar Helper (PyTorch + CUDA)")
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--image", help="use a single screenshot as the frame source")
    src.add_argument("--dir", help="cycle screenshots from a directory")
    src.add_argument("--video", help="loop frames from a video recording")
    src.add_argument("--screen", action="store_true",
                     help="live screen capture (X11 root window / ImageGrab)")
    src.add_argument("--synthetic", action="store_true", help="built-in demo frame")
    ap.add_argument("--region", default=None, metavar="X,Y,W,H",
                    help="with --screen: clip to the game window's bounds")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--dpi", type=int, default=None)
    ap.add_argument("--backend", choices=["cuda", "numpy"], default=None)
    ap.add_argument("--device", default="cuda", help='CUDA device of the cuda backend ("cuda:N")')
    ap.add_argument("--lsd-engine", choices=list(LSD_ENGINES), default=None,
                    help='the cuda backend\'s line search: "native" (the C++ march on the host) or "cuda" '
                         "(the host seed scan over the device ray march); sets the lsd_engine setting "
                         "for this run")
    ap.add_argument("--no-web", action="store_true")
    ap.add_argument(
        "--pipelined", action="store_true",
        help="overlap the next frame's upload and device work with the current "
             "frame's result processing",
    )
    ap.add_argument("--worker", action="store_true",
                    help="run the vision pipeline in a persistent worker process "
                         "(shm frame ring + unix socket results) on --device; the "
                         "worker recycles itself past SMH_WORKER_RECYCLE_MB of uploads")
    ap.add_argument("--debug-web", action="store_true",
                    help="broadcast debug telemetry to web clients (event id 100): "
                         "per-frame timeshares, OCR boxes and scale overlays")
    ap.add_argument("--sync-scales", action="store_true",
                    help="join the scales branch every frame like the reference "
                         "(default: async — markers publish immediately, the ratio "
                         "lags <=1 frame; it only changes on zoom)")
    ap.add_argument("--settings", default="settings.json")
    ap.add_argument("--warmup", action="store_true",
                    help="before serving, run every static shape the transport ladders reach "
                         "at the common resolutions on --device (the kernels' build, the "
                         "classify tables, the allocator's growth)")
    ap.add_argument("--dumplogs", action="store_true", help="also log to smh.log")
    ap.add_argument("--list-maps", action="store_true")
    ap.add_argument("--rip", metavar="MAP_PATH", help="rip a heightmap into the .smhhm cache")
    ap.add_argument("--paks", nargs="*", default=[])
    ap.add_argument("--aes", default=None)
    ap.add_argument("--ripper", default=None, help="ripper executable override")
    ap.add_argument("--cache-dir", default="heightmaps")
    ap.add_argument("--skip-cache", action="store_true")
    ap.add_argument("--export-png", metavar="OUT.png", help="with --rip: export L16 PNG")
    ap.add_argument("--heightmap", help="load a .smhhm heightmap at startup")
    ap.add_argument("--fit-to-minimap", action="store_true",
                    help="align the heightmap by fitting it to the detected minimap bounds")
    ap.add_argument("--trace-out", metavar="PATH",
                    help="at exit, write the host half's spans (capture, loop, submit, fetch, host "
                         "stages) as Chrome trace-event JSON, which Perfetto opens; with --worker "
                         "the pipeline's spans stay in the worker process")
    return ap


def load_settings(args) -> Settings:
    """The settings file with the command line's overrides: --backend and
    --lsd-engine hold for this run only and never rewrite the file."""
    settings = Settings(path=args.settings)
    if args.backend:
        settings.set("hardware_acceleration", args.backend == "cuda", save=False)
    if args.lsd_engine:
        settings.set("lsd_engine", args.lsd_engine, save=False)
    return settings


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    handlers: list[logging.Handler] = [logging.StreamHandler()]
    if args.dumplogs:
        from .utils.ringlog import CollapsingFileHandler

        handlers.append(CollapsingFileHandler("smh.log"))
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s",
        handlers=handlers,
    )

    if not args.paks:
        from .heightmaps import ripper as _ripper

        discovered = _ripper.discover_paks()
        if discovered:
            log.info("auto-discovered %d pak dir(s): %s", len(discovered), discovered)
            args.paks = discovered

    if args.list_maps or args.rip:
        from .heightmaps import browser, ripper

        exe = args.ripper or ripper.DEFAULT_EXE
        if args.list_maps:
            for layer in ripper.list_maps(args.paks, args.aes, exe=exe):
                print(layer)
            return 0
        hm = browser.load_or_rip(
            args.rip, args.paks, args.aes,
            cache_dir=args.cache_dir, exe=exe, skip_cache=args.skip_cache,
        )
        if hm is None:
            print("layer has no heightmap")
            return 1
        print(f"cached {args.rip} ({hm.width}x{hm.height}) in {args.cache_dir}/")
        if args.export_png:
            browser.export_png(hm, args.export_png)
            print(f"wrote {args.export_png}")
        return 0

    settings = load_settings(args)

    if args.warmup and settings.hardware_acceleration():
        from .ops.warmup import warmup

        warmup(device=args.device)

    app = App(
        _build_source(args), settings=settings, device=args.device, port=args.port,
        serve=not args.no_web, pipelined=args.pipelined, scales_async=not args.sync_scales,
        debug_web=args.debug_web, paks=args.paks, aes=args.aes, ripper_exe=args.ripper, cache_dir=args.cache_dir,
        worker=args.worker,
    )

    if args.heightmap:
        from .squadex import heightmaps as hms

        hm = hms.load_smhhm(args.heightmap)
        if hm is None:
            log.error("failed to load heightmap %s", args.heightmap)
            return 1
        app.select_heightmap(hm)
    if args.fit_to_minimap:
        app.set_fit_to_minimap(True)

    # The first Ctrl+C requests a clean shutdown, the third force-exits.
    sigint_count = [0]

    def handle_sigint(signum, frame):
        sigint_count[0] += 1
        if sigint_count[0] >= 3:
            log.error("third interrupt: force exit")
            import os

            os._exit(130)
        log.info("shutting down... (Ctrl+C x%d; 3rd force-exits)", sigint_count[0])
        app._shutdown.set()

    signal.signal(signal.SIGINT, handle_sigint)

    app.start()
    log.info("running on %s (Ctrl+C stops)", args.device)
    app.wait()
    app.stop()
    if args.trace_out:
        from .utils.timeshares import write_chrome_trace

        log.info("wrote %d spans to %s", write_chrome_trace(args.trace_out), args.trace_out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
