"""Asyncio web server: one-page HTTP + binary-protocol WebSocket broadcast.

Counterpart of /root/reference/web/src/{lib,http,ws}.rs:
  * runs on its own thread with its own event loop (lib.rs:242-268);
  * keeps the latest EventData snapshot and replays it to new clients
    (ws.rs:31-56);
  * fans events out to all clients, dropping any client that cannot accept a
    send within 10 s (ws.rs:92-99);
  * serves a single inlined HTML page with the WebSocket port substituted
    for "{{ WEBSOCKET_PORT }}" (http.rs:3-18).

Client interactions (add/delete custom marker) are queued for the app thread
to drain (lib.rs:282-284).
"""

from __future__ import annotations

import asyncio
import logging
import pathlib
import queue
import socket
import threading
from typing import Optional

import numpy as np
import websockets

from ..geometry import Rect
from ..squadex.heightmaps import Heightmap
from . import protocol

log = logging.getLogger(__name__)

WWW = pathlib.Path(__file__).parent / "www"
SEND_TIMEOUT = 10.0


class _Client:
    """Per-connection send queue (websockets forbids concurrent send()).
    `dead` flips exactly once, at the overflow/timeout decision point; a
    dead client is removed from the broadcast set immediately, so no event
    broadcast after the overflow can reach it (the reference's drop is
    equally exact, ws.rs:92-99)."""

    __slots__ = ("queue", "websocket", "dead")

    def __init__(self, websocket) -> None:
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=256)
        self.websocket = websocket
        self.dead = False


class EventData:
    """Latest-state snapshot for new clients (web/src/lib.rs:216-225)."""

    def __init__(self) -> None:
        self.map_bytes: Optional[bytes] = None
        self.update_state_bytes: Optional[bytes] = None
        self.cv_markers_bytes: Optional[bytes] = None
        self.custom_markers_bytes: Optional[bytes] = None
        self.heightmap_bytes: Optional[bytes] = None
        self.fit_bytes: bytes = protocol.encode_fit_to_minimap(False)

    def snapshot(self) -> list[bytes]:
        out = []
        for b in (
            self.map_bytes,
            self.update_state_bytes,
            self.cv_markers_bytes,
            self.custom_markers_bytes,
            self.heightmap_bytes,
        ):
            if b is not None:
                out.append(b)
        out.append(self.fit_bytes)
        return out


class WebServer:
    def __init__(self, port: int = 8080, ws_port: Optional[int] = None, host: str = "0.0.0.0") -> None:
        self.port = port
        self.ws_port = ws_port if ws_port is not None else port + 1
        self.host = host
        self._event_data = EventData()
        self._clients: set = set()
        self._interactions: "queue.Queue[protocol.Interaction]" = queue.Queue()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._stop_event: Optional[asyncio.Event] = None
        self.on_interaction = None  # optional callback (app wake)
        self.on_client_connect = None  # optional callback (push fresh state)
        # Optional HTTP API handler: (path, query: dict) -> (status, obj).
        # Runs in an executor (handlers may spawn ripper subprocesses).
        self.api_handler = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "WebServer":
        self._thread = threading.Thread(target=self._run, name="web", daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=10.0):
            raise RuntimeError("web server failed to start")
        return self

    def stop(self) -> None:
        if self._loop is not None and self._stop_event is not None:
            self._loop.call_soon_threadsafe(self._stop_event.set)
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    @property
    def addr(self) -> str:
        # LAN address discovery via the UDP connect trick (lib.rs:336-360).
        try:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.connect(("8.8.8.8", 80))
            ip = s.getsockname()[0]
            s.close()
            return f"http://{ip}:{self.port}"
        except OSError:
            return f"http://localhost:{self.port}"

    def num_clients(self) -> int:
        return len(self._clients)

    # -- app-facing sends (thread-safe) --------------------------------------

    def send_map(self, map_rgba: np.ndarray) -> None:
        data = protocol.encode_map(map_rgba)
        self._event_data.map_bytes = data
        self._broadcast(data)

    def send_markers(self, markers, custom: bool) -> None:
        data = protocol.encode_markers(markers, custom)
        if custom:
            self._event_data.custom_markers_bytes = data
        else:
            self._event_data.cv_markers_bytes = data
        self._broadcast(data)

    def send_update_state(self, ratio: Optional[float], minimap: Optional[Rect]) -> None:
        data = protocol.encode_update_state(ratio, minimap)
        self._event_data.update_state_bytes = data
        self._broadcast(data)

    def send_heightmap(self, hm: Optional[Heightmap]) -> None:
        data = protocol.encode_heightmap(hm)
        self._event_data.heightmap_bytes = data
        self._broadcast(data)

    def send_fit_to_minimap(self, fit: bool) -> None:
        data = protocol.encode_fit_to_minimap(fit)
        self._event_data.fit_bytes = data
        self._broadcast(data)

    def send_debug(self, payload: dict) -> None:
        """Opt-in telemetry (event id 100; not part of the reference wire
        protocol; unknown ids are ignorable by clients)."""
        self._broadcast(protocol.encode_debug(payload))

    def send_inspect(self, payload: dict) -> None:
        """Pixel-inspector reply (event id 101, smh_tpu extension)."""
        self._broadcast(protocol.encode_inspect(payload))

    def recv(self) -> Optional[protocol.Interaction]:
        try:
            return self._interactions.get_nowait()
        except queue.Empty:
            return None

    # -- internals ------------------------------------------------------------

    def _broadcast(self, data: bytes) -> None:
        loop = self._loop
        if loop is None:
            return
        try:
            loop.call_soon_threadsafe(self._broadcast_on_loop, data)
        except RuntimeError:
            pass  # server stopped between the check and the call

    def _broadcast_on_loop(self, data: bytes) -> None:
        # A slow client must not block the rest (10 s policy, ws.rs:92-99).
        # A client whose queue overflows is dropped HERE — removed from the
        # broadcast set and its socket closed — so the drop is exact: no
        # event after the overflow is ever delivered to it.
        for c in list(self._clients):
            try:
                c.queue.put_nowait(data)
            except asyncio.QueueFull:
                c.dead = True
                self._clients.discard(c)
                log.warning(
                    "dropping client %s: send queue overflow",
                    c.websocket.remote_address,
                )
                asyncio.ensure_future(self._close_client(c))

    @staticmethod
    async def _close_client(c: "_Client") -> None:
        try:
            await c.websocket.close()
        except Exception:
            pass

    async def _ws_handler(self, websocket) -> None:
        log.info("WebSocket connection opened with %s", websocket.remote_address)
        # Register the client BEFORE replaying the snapshot so events
        # broadcast during the replay awaits land in its queue instead of
        # being lost (they may duplicate snapshot state; all state events
        # are idempotent).
        client = _Client(websocket)
        self._clients.add(client)
        for data in self._event_data.snapshot():
            await websocket.send(data)

        if self.on_client_connect is not None:
            # App-side hook: lets a lazily-fetched map be pushed to the first
            # viewer even when the scene is static (no new vision updates).
            await asyncio.get_running_loop().run_in_executor(None, self.on_client_connect)

        async def sender():
            # A slow/stuck client must be disconnected (10 s policy,
            # ws.rs:92-99): on send timeout, drop it and close the socket so
            # the reader loop below terminates too. Queue overflow is
            # handled at broadcast time (_broadcast_on_loop); the dead check
            # here just stops draining once that decision landed.
            try:
                while not client.dead:
                    data = await client.queue.get()
                    if client.dead:
                        break
                    await asyncio.wait_for(websocket.send(data), timeout=SEND_TIMEOUT)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                log.warning("dropping client %s: %s", websocket.remote_address, e)
                client.dead = True
                self._clients.discard(client)
                try:
                    await websocket.close()
                except Exception:
                    pass

        sender_task = asyncio.ensure_future(sender())
        try:
            async for msg in websocket:
                if isinstance(msg, str):
                    msg = msg.encode()
                interaction = protocol.decode_interaction(msg)
                if interaction is None:
                    log.warning("unknown interaction from %s", websocket.remote_address)
                    continue
                self._interactions.put(interaction)
                if self.on_interaction is not None:
                    self.on_interaction()
        except websockets.ConnectionClosed:
            pass
        finally:
            self._clients.discard(client)
            sender_task.cancel()
            log.info("WebSocket connection closed with %s", websocket.remote_address)

    @staticmethod
    def _http_head(status: int, ctype: str, body: bytes) -> bytes:
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found", 500: "Internal Server Error"}.get(status, "OK")
        return (
            f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Content-Type: {ctype}\r\n"
            "Connection: Closed\r\n\r\n"
        ).encode()

    def _index_response(self) -> bytes:
        html = (WWW / "index.html").read_text()
        html = html.replace("{{ WEBSOCKET_PORT }}", str(self.ws_port))
        body = html.encode()
        return self._http_head(200, "text/html; charset=utf-8", body) + body

    async def _api_response(self, path: str, query: dict) -> bytes:
        import json

        if self.api_handler is None:
            body = json.dumps({"error": "no api handler"}).encode()
            return self._http_head(404, "application/json", body) + body
        try:
            status, obj = await asyncio.get_running_loop().run_in_executor(
                None, self.api_handler, path, query
            )
        except Exception as e:  # handler bugs must not kill the server
            log.exception("api handler failed for %s", path)
            status, obj = 500, {"error": str(e)}
        if isinstance(obj, tuple) and len(obj) == 2 and isinstance(obj[1], (bytes, bytearray)):
            ctype, body = obj[0], bytes(obj[1])  # raw payload (e.g. a PNG)
            return self._http_head(status, ctype, body) + body
        body = json.dumps(obj).encode()
        return self._http_head(status, "application/json", body) + body

    async def _http_handler(self, reader, writer) -> None:
        try:
            line = await asyncio.wait_for(reader.readline(), timeout=SEND_TIMEOUT)
            parts = line.decode("latin-1").split()
            target = parts[1] if len(parts) >= 2 else "/"
            if target.startswith("/api/"):
                from urllib.parse import parse_qsl, unquote, urlsplit

                sp = urlsplit(target)
                query = dict(parse_qsl(sp.query))
                resp = await self._api_response(unquote(sp.path), query)
            else:
                resp = self._index_response()
            writer.write(resp)
            await asyncio.wait_for(writer.drain(), timeout=SEND_TIMEOUT)
        except Exception:
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    def _run(self) -> None:
        asyncio.run(self._serve())

    async def _serve(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._stop_event = asyncio.Event()
        http_server = await asyncio.start_server(self._http_handler, self.host, self.port)
        ws_server = await websockets.serve(self._ws_handler, self.host, self.ws_port)
        log.info("HTTP on %s:%d, WebSocket on %s:%d", self.host, self.port, self.host, self.ws_port)
        self._started.set()
        try:
            await self._stop_event.wait()
        finally:
            ws_server.close()
            await ws_server.wait_closed()
            http_server.close()
            await http_server.wait_closed()
