"""Frame sources + the capture thread with its one-deep frame mailbox.

The reference captures the game window with win32 PrintWindow/PlgBlt
(src/squadex/capture/windows.rs) — OS capture is out of scope on a TPU host,
so the framework exposes a FrameSource seam with file/directory/synthetic
sources (the reference's own test path: Fake Inputs, src/ui/debug.rs:46-82).

The capture thread semantics mirror /root/reference/src/capture.rs:8-95:
  * 20 Hz poll (CAPTURE_HZ),
  * content dedup of identical frames (the reference's crc32 skip,
    src/capture.rs:44-47, as an early-exit block compare — see _run),
  * a one-slot mailbox: the thread parks after delivering a frame and is
    unparked when the vision loop consumes it.
"""

from __future__ import annotations

import dataclasses
import itertools
import pathlib
import threading
import time
from typing import Iterator, Optional, Protocol

import numpy as np

from .. import consts as C
from ..utils.timeshares import QUEUE, add, new_frame, span


@dataclasses.dataclass
class Frame:
    image: np.ndarray  # BGRA u8 [H, W, 4]
    dpi: Optional[int] = None
    seq: Optional[int] = dataclasses.field(default=None, compare=False)  # the id the loop gave it at its take


class FrameSource(Protocol):
    def grab(self) -> Optional[Frame]:
        """Return the current frame (may be identical to the previous one).

        CONTRACT: the returned buffer must never be mutated afterwards —
        the mailbox's duplicate test keeps a reference to the previous
        frame and treats object identity as equality (CaptureThread.
        _frames_equal). A source that recycles its grab buffer (the mss/
        dxcam pattern) must hand out copies."""
        ...


class StaticSource:
    """Always returns the same frame (like Fake Input with one sample)."""

    def __init__(self, frame: np.ndarray, dpi: Optional[int] = None) -> None:
        self._frame = frame
        self._dpi = dpi

    def grab(self) -> Optional[Frame]:
        return Frame(self._frame, self._dpi)


class DirectorySource:
    """Cycles image files from a directory (PNG/JPG), BGRA-converted."""

    def __init__(self, path: str, dpi: Optional[int] = None) -> None:
        from PIL import Image

        self._images: list[np.ndarray] = []
        for p in sorted(pathlib.Path(path).iterdir()):
            if p.suffix.lower() not in (".png", ".jpg", ".jpeg"):
                continue
            rgba = np.asarray(Image.open(p).convert("RGBA"))
            self._images.append(np.ascontiguousarray(rgba[..., [2, 1, 0, 3]]))
        if not self._images:
            raise ValueError(f"no images in {path}")
        self._iter: Iterator[np.ndarray] = itertools.cycle(self._images)
        self._dpi = dpi

    def grab(self) -> Optional[Frame]:
        return Frame(next(self._iter), self._dpi)


class BlackoutFallbackSource:
    """Primary/fallback source pair with blackout detection.

    Mirrors the reference's capture "Blackout" state machine
    (src/squadex/capture/windows.rs:9-47,148-158,274-278): when the primary
    source produces all-black frames (the DX12-fullscreen window-capture
    failure mode), switch to the fallback source; periodically re-probe the
    primary (the reference re-probes when the window handle changes; without
    window handles we re-probe every `reprobe_every` grabs).
    """

    def __init__(self, primary: FrameSource, fallback: FrameSource, reprobe_every: int = 60) -> None:
        self._primary = primary
        self._fallback = fallback
        self._reprobe_every = reprobe_every
        self._blackout = False
        self._since_probe = 0

    @staticmethod
    def _is_black(frame: Optional[Frame]) -> bool:
        if frame is None:
            return True
        return not frame.image[..., :3].any()

    def grab(self) -> Optional[Frame]:
        if self._blackout:
            self._since_probe += 1
            if self._since_probe >= self._reprobe_every:
                self._since_probe = 0
                probe = self._primary.grab()
                if not self._is_black(probe):
                    self._blackout = False
                    return probe
            return self._fallback.grab()

        frame = self._primary.grab()
        if self._is_black(frame):
            self._blackout = True
            self._since_probe = 0
            return self._fallback.grab()
        return frame


def load_frame_bgra(path: str) -> np.ndarray:
    """Load an image file as a BGRA frame array."""
    from PIL import Image

    rgba = np.asarray(Image.open(path).convert("RGBA"))
    return np.ascontiguousarray(rgba[..., [2, 1, 0, 3]])


class VideoSource:
    """Video-file frames (OpenCV decoder), BGRA-converted.

    The offline counterpart of live capture: feed a gameplay recording
    through the same pipeline (per-frame via CaptureThread, or batched via
    vision/batch.py — see tools/analyze_video.py). `step` subsamples (every
    Nth frame); `loop` restarts at EOF (for serving demos); non-loop sources
    return None at EOF, which the capture thread treats as "no frame".
    """

    def __init__(self, path: str, dpi: Optional[int] = None, loop: bool = False, step: int = 1) -> None:
        import cv2

        self._cv2 = cv2
        self._path = str(path)
        self._cap = cv2.VideoCapture(self._path)
        if not self._cap.isOpened():
            raise ValueError(f"cannot open video {path}")
        self._dpi = dpi
        self._loop = loop
        self._step = max(1, step)
        self.fps = float(self._cap.get(cv2.CAP_PROP_FPS) or 0.0)

    def _read(self) -> Optional[np.ndarray]:
        ok, bgr = self._cap.read()
        if not ok:
            return None
        h, w = bgr.shape[:2]
        bgra = np.empty((h, w, 4), dtype=np.uint8)
        bgra[..., :3] = bgr
        bgra[..., 3] = 255
        return bgra

    def grab(self) -> Optional[Frame]:
        for _ in range(self._step - 1):
            if self._read() is None:
                break
        img = self._read()
        if img is None:
            if not self._loop:
                return None
            self._cap.set(self._cv2.CAP_PROP_POS_FRAMES, 0)
            img = self._read()
            if img is None:
                return None
        return Frame(img, self._dpi)

    def iter_frames(self) -> Iterator[np.ndarray]:
        """Offline iteration (ignores loop): yields BGRA arrays to EOF."""
        while True:
            for _ in range(self._step - 1):
                if self._read() is None:
                    return
            img = self._read()
            if img is None:
                return
            yield img

    def close(self) -> None:
        self._cap.release()


def _x11_bgra(raw: bytes, w: int, h: int, bytes_per_line: int) -> np.ndarray:
    """32bpp ZPixmap rows (little-endian BGRX) -> contiguous BGRA frame.
    The X server leaves the pad byte undefined; alpha is forced opaque like
    the reference does after GetDIBits (capture/windows.rs:266-269)."""
    rows = np.frombuffer(raw, dtype=np.uint8).reshape(h, bytes_per_line)[:, : w * 4]
    bgra = np.ascontiguousarray(rows.reshape(h, w, 4))
    bgra[..., 3] = 255
    return bgra


class ScreenSource:
    """Live screen capture for hosts with a display.

    The reference grabs the game window with win32 PrintWindow and falls back
    to whole-screen capture (src/squadex/capture/windows.rs:140-280); on
    Linux hosts this grabs the X11 root window via libX11 (ctypes, ZPixmap),
    with PIL.ImageGrab as a portability fallback. `region` = (x, y, w, h)
    clips to a window's bounds (the PlgBlt-clip analog). Raises RuntimeError
    when no display exists — callers pair it with BlackoutFallbackSource or
    choose a file source instead.
    """

    def __init__(self, region: Optional[tuple[int, int, int, int]] = None, dpi: Optional[int] = None) -> None:
        self._region = region
        self._dpi = dpi
        self._mode = None
        self._x11 = None
        try:
            self._x11 = _X11Grabber()
            self._mode = "x11"
        except Exception:
            try:
                from PIL import ImageGrab

                ImageGrab.grab(bbox=(0, 0, 8, 8))  # probe
                self._grab_pil = ImageGrab.grab
                self._mode = "pil"
            except Exception as e:
                raise RuntimeError(f"no usable screen capture (headless host?): {e}")

    def grab(self) -> Optional[Frame]:
        try:
            if self._mode == "x11":
                img = self._x11.grab(self._region)
            else:
                bbox = None
                if self._region is not None:
                    x, y, w, h = self._region
                    bbox = (x, y, x + w, y + h)
                rgba = np.asarray(self._grab_pil(bbox=bbox).convert("RGBA"))
                img = np.ascontiguousarray(rgba[..., [2, 1, 0, 3]])
                img[..., 3] = 255
            return Frame(img, self._dpi)
        except Exception:
            return None  # transient failures read as "no frame" (mailbox skips)

    def close(self) -> None:
        if self._x11 is not None:
            self._x11.close()


class _X11Grabber:
    """Minimal ctypes libX11 root-window grabber (XGetImage, ZPixmap)."""

    ZPIXMAP = 2
    ALL_PLANES = 0xFFFFFFFF

    def __init__(self) -> None:
        import ctypes
        import ctypes.util

        self._ct = ctypes
        name = ctypes.util.find_library("X11") or "libX11.so.6"
        self._lib = ctypes.CDLL(name)
        self._lib.XOpenDisplay.restype = ctypes.c_void_p
        self._lib.XDefaultRootWindow.restype = ctypes.c_ulong
        self._lib.XGetImage.restype = ctypes.c_void_p
        self._lib.XDisplayWidth.restype = ctypes.c_int
        self._lib.XDisplayHeight.restype = ctypes.c_int
        self._dpy = self._lib.XOpenDisplay(None)
        if not self._dpy:
            raise RuntimeError("XOpenDisplay failed (no DISPLAY)")
        self._root = self._lib.XDefaultRootWindow(ctypes.c_void_p(self._dpy))
        self._screen_w = self._lib.XDisplayWidth(ctypes.c_void_p(self._dpy), 0)
        self._screen_h = self._lib.XDisplayHeight(ctypes.c_void_p(self._dpy), 0)

    def grab(self, region: Optional[tuple[int, int, int, int]]) -> np.ndarray:
        ct = self._ct
        x, y, w, h = region if region is not None else (0, 0, self._screen_w, self._screen_h)
        ximage_p = self._lib.XGetImage(
            ct.c_void_p(self._dpy), ct.c_ulong(self._root),
            ct.c_int(x), ct.c_int(y), ct.c_uint(w), ct.c_uint(h),
            ct.c_ulong(self.ALL_PLANES), ct.c_int(self.ZPIXMAP),
        )
        if not ximage_p:
            raise RuntimeError("XGetImage failed")
        try:
            # XImage layout (Xlib.h, LP64): 4 ints (width, height, xoffset,
            # format), then char *data @16, then ints byte_order @24,
            # bitmap_unit, bitmap_bit_order, bitmap_pad, depth,
            # bytes_per_line @44, bits_per_pixel @48.
            ints = ct.cast(ximage_p, ct.POINTER(ct.c_int))
            width, height = ints[0], ints[1]
            data_p = ct.cast(ximage_p + 16, ct.POINTER(ct.c_char_p)).contents.value
            bytes_per_line = ct.cast(ximage_p + 44, ct.POINTER(ct.c_int)).contents.value
            bits_per_pixel = ct.cast(ximage_p + 48, ct.POINTER(ct.c_int)).contents.value
            if bits_per_pixel != 32:
                raise RuntimeError(
                    f"unsupported X visual: {bits_per_pixel} bpp (need 32bpp ZPixmap)"
                )
            if bytes_per_line <= 0:
                bytes_per_line = width * 4
            raw = ct.string_at(data_p, bytes_per_line * height)
            return _x11_bgra(raw, width, height, bytes_per_line)
        finally:
            # XDestroyImage frees both the struct and the pixel buffer; it is
            # an exported symbol in modern libX11 (verified on this image).
            # On ancient builds where it is macro-only, XFree at least frees
            # the struct — warn, because the pixel buffer then leaks.
            try:
                self._lib.XDestroyImage(ct.c_void_p(ximage_p))
            except AttributeError:
                if not getattr(self, "_warned_leak", False):
                    self._warned_leak = True
                    import logging

                    logging.getLogger(__name__).warning(
                        "libX11 lacks XDestroyImage: XImage pixel buffers leak"
                    )
                self._lib.XFree(ct.c_void_p(ximage_p))

    def close(self) -> None:
        try:
            self._lib.XCloseDisplay(self._ct.c_void_p(self._dpy))
        except Exception:
            pass


class CaptureThread:
    """One-slot latest-frame mailbox fed by a FrameSource at CAPTURE_HZ."""

    def __init__(self, source: FrameSource, hz: float = float(C.CAPTURE_HZ)) -> None:
        self._source = source
        self._interval = 1.0 / hz
        self._cond = threading.Condition()
        self._slot: Optional[Frame] = None
        self._published = 0.0  # perf_counter time the slot's frame was published
        self._consumed = threading.Event()
        self._consumed.set()
        self._shutdown = threading.Event()
        self._last_image: Optional[np.ndarray] = None
        # Small sampled copy of the last published frame: guards the `a is b`
        # dedup shortcut against a source that RECYCLES its grab buffer (the
        # mss/dxcam pattern) — same object, new pixels. ~16 KB at 4K.
        self._last_sample: Optional[np.ndarray] = None
        self._thread: Optional[threading.Thread] = None

    def fresh_frame(self) -> Optional[Frame]:
        """Take the mailbox frame if present; unparks the capture thread
        either way (capture.rs:15-22 unparks even when the slot is empty).
        A frame taken gets its id and a `capture.mailbox` record of its
        time in the slot."""
        with self._cond:
            frame = self._slot
            self._slot = None
            taken, published = time.perf_counter(), self._published
        self._consumed.set()
        if frame is not None:
            frame.seq = new_frame()
            add("capture.mailbox", QUEUE, published, taken, frame.seq)
        return frame

    def resend(self) -> None:
        """Invalidate the dedup so the next grab republishes the frame
        even when the scene is static — used when a runtime setting changes
        what the pipeline renders (grayscale_map / backend flips)."""
        self._last_image = None
        self._last_sample = None
        self._consumed.set()

    _SAMPLE_STRIDE = 8191  # prime: samples stay unaligned with row pitches

    @classmethod
    def _sample(cls, image: np.ndarray) -> np.ndarray:
        return image.reshape(-1)[:: cls._SAMPLE_STRIDE].copy()

    def _frames_equal(self, a: np.ndarray, b: Optional[np.ndarray]) -> bool:
        """Duplicate-frame test, replacing the reference's whole-frame crc32
        (src/capture.rs:44-47). A crc reads the full 33 MB 4K frame every
        grab (~12 ms on this 1-core host) even when the frame CHANGED — and
        changing frames are exactly when the capture thread competes with
        the vision thread for the core. The block compare exits on the
        first differing MiB, so changing frames cost ~0.1-0.5 ms and only
        static frames (vision idle anyway) pay the full read. Sources must
        not mutate a returned frame buffer afterwards (all of ours allocate
        fresh or return stable preloaded arrays, so identity => equal); the
        shortcut is still GUARDED by a sampled-byte check so a source that
        breaks the contract (recycled grab buffer) degrades to re-publishing
        changed frames instead of silently freezing the pipeline."""
        if b is None:
            return False
        if a is b:
            sample = self._last_sample
            if sample is None:  # no sample retained: republish (safe side)
                return False
            return bool(np.array_equal(self._sample(a), sample))
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        if not (a.flags.c_contiguous and b.flags.c_contiguous):
            return bool(np.array_equal(a, b))
        av = a.reshape(-1)
        bv = b.reshape(-1)
        if av.nbytes % 8 == 0:
            av = av.view(np.uint64)
            bv = bv.view(np.uint64)
        step = 1 << 17  # 1 MiB blocks
        for off in range(0, av.size, step):
            if not np.array_equal(av[off : off + step], bv[off : off + step]):
                return False
        return True

    def _run(self) -> None:
        while not self._shutdown.is_set():
            with span("capture.grab"):
                frame = self._source.grab()
                fresh = frame is not None and not self._frames_equal(frame.image, self._last_image)
            if not fresh:
                self._shutdown.wait(self._interval)
                continue
            self._last_image = frame.image
            self._last_sample = self._sample(frame.image)
            # Clear BEFORE publishing: a consumer that takes the frame
            # between publish and wait would otherwise have its set() lost
            # and the capture thread would stall a tick.
            self._consumed.clear()
            with self._cond:
                self._slot = frame
                self._published = time.perf_counter()
            # Park until the vision loop consumes the frame (capture.rs:83).
            self._consumed.wait(timeout=1.0)

    def start(self) -> "CaptureThread":
        self._thread = threading.Thread(target=self._run, name="capture", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._shutdown.set()
        self._consumed.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
