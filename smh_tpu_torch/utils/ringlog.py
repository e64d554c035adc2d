"""In-memory ring-buffer log sink with repeat collapsing.

Counterpart of the reference's log window + "(xN)" dedup
(/root/reference/src/ui/logs.rs:22-144). Attach as a logging handler; the
buffer is exposed for any surface (CLI dump, web debug endpoint).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time
from typing import Optional


@dataclasses.dataclass
class LogEntry:
    ts: float
    level: int
    message: str
    count: int = 1  # collapsed repeats ("(xN)")
    seq: int = 0  # monotonically increasing id (client poll cursor)


class RingLogHandler(logging.Handler):
    def __init__(self, capacity: int = 1000) -> None:
        super().__init__()
        self._entries: collections.deque[LogEntry] = collections.deque(maxlen=capacity)
        self._lock2 = threading.Lock()
        self._seq = 0  # bumped on every emit (repeats bump too: poll cursors
        # must see the "(xN)" count grow)
        self._errors = 0  # total records at ERROR+ (auto-open-on-error hook)

    def emit(self, record: logging.LogRecord) -> None:
        try:
            msg = self.format(record)
        except Exception:
            return
        with self._lock2:
            self._seq += 1
            if record.levelno >= logging.ERROR:
                self._errors += 1
            if self._entries and self._entries[-1].message == msg and self._entries[-1].level == record.levelno:
                self._entries[-1].count += 1
                self._entries[-1].ts = time.time()
                self._entries[-1].seq = self._seq
            else:
                self._entries.append(
                    LogEntry(ts=time.time(), level=record.levelno, message=msg, seq=self._seq)
                )

    def entries(self, since: int = 0) -> list[LogEntry]:
        """SNAPSHOT of entries whose seq is past `since` (0 = everything
        retained). Copies under the lock: the ring's LogEntry objects are
        mutated in place by the repeat collapse, so handing out the live
        instances would let readers see torn count/ts/seq combinations."""
        with self._lock2:
            return [
                dataclasses.replace(e) for e in self._entries if e.seq > since
            ]

    def snapshot(self, since: int = 0) -> tuple[list[LogEntry], int, int]:
        """(entries-past-since, seq, errors) read atomically — a poller that
        reads the three under separate lock acquisitions can pair a new
        cursor with old entries and permanently skip a collapsed repeat."""
        with self._lock2:
            return (
                [dataclasses.replace(e) for e in self._entries if e.seq > since],
                self._seq,
                self._errors,
            )

    @property
    def seq(self) -> int:
        with self._lock2:
            return self._seq

    @property
    def errors(self) -> int:
        """Total ERROR+ records ever seen (clients auto-open on increase)."""
        with self._lock2:
            return self._errors

    def formatted(self) -> list[str]:
        out = []
        for e in self.entries():
            suffix = f" (x{e.count})" if e.count > 1 else ""
            out.append(f"{logging.getLevelName(e.level)} {e.message}{suffix}")
        return out


class CollapsingFileHandler(logging.Handler):
    """File sink with in-place "(xN)" repeat collapsing.

    Counterpart of the reference's --dumplogs logger, which seeks back over
    the previous line and rewrites it with an incremented repeat count
    instead of appending duplicates (/root/reference/src/ui/logs.rs:58-144).
    """

    def __init__(self, path: str) -> None:
        """Preserves prior sessions' content like logging.FileHandler's
        default append mode — but POSIX append mode forces every write to
        EOF, which would break the seek-back rewrite, so an existing file
        is opened 'r+' and positioned at the end instead."""
        super().__init__()
        import os

        if os.path.exists(path):
            self._stream = open(path, "r+")
            self._stream.seek(0, 2)  # end
        else:
            self._stream = open(path, "w")
        self._lock2 = threading.Lock()
        self._last_msg: Optional[str] = None
        self._last_level: Optional[int] = None
        self._last_pos = self._stream.tell()  # byte offset of the last line
        self._count = 1

    def emit(self, record: logging.LogRecord) -> None:
        try:
            msg = self.format(record)
        except Exception:
            return
        try:
            with self._lock2:
                if msg == self._last_msg and record.levelno == self._last_level:
                    # Seek back over the previous line and rewrite it with
                    # the bumped count (logs.rs:93-144).
                    self._count += 1
                    self._stream.seek(self._last_pos)
                    self._stream.truncate()
                    self._stream.write(f"{msg} (x{self._count})\n")
                else:
                    self._last_pos = self._stream.tell()
                    self._last_msg = msg
                    self._last_level = record.levelno
                    self._count = 1
                    self._stream.write(msg + "\n")
                self._stream.flush()
        except Exception:
            # stdlib handler contract: stream failures (disk full, closed
            # stream during shutdown) must not propagate into the caller
            # that happened to log.
            self.handleError(record)

    def close(self) -> None:
        with self._lock2:
            try:
                self._stream.close()
            finally:
                super().close()


_default: Optional[RingLogHandler] = None


def install(capacity: int = 1000, level: int = logging.INFO) -> RingLogHandler:
    """Install a process-wide ring sink on the root logger."""
    global _default
    if _default is None:
        _default = RingLogHandler(capacity)
        _default.setLevel(level)
        _default.setFormatter(logging.Formatter("%(name)s: %(message)s"))
        logging.getLogger().addHandler(_default)
    return _default


def get() -> Optional[RingLogHandler]:
    return _default
