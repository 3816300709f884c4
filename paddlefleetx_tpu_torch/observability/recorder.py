"""Crash-surviving flight recorder: an append-only ``events.jsonl``
stream (the port's copy of the JAX package's
``observability/recorder.py``).

Every ``emit`` writes one JSON line and flushes and fsyncs it before
returning, so a run killed without a handler still leaves its last
known state on disk, and a SIGTERM handler needs only ``emit`` one more
event for it to be durable.

Schema: ``{"ts": <unix seconds>, "event": <name>, ...fields}``, with the
JAX package's event names (its ``docs/observability.md``). ``tail``
re-reads the file, so another process sees everything flushed so far.

Rotation: when the file would exceed ``max_bytes`` (an argument,
default 64 MiB, where the JAX module reads ``PFX_RECORDER_MAX_BYTES``)
it rolls once to ``<path>.1``; the new file opens with a
``recorder_rotated`` event, and ``read_tail`` / ``read_events`` read
the rotated file first, so diagnostics see across the roll.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

#: the rotation threshold when none is given: 64 MiB
_DEFAULT_MAX_BYTES = 64 * 1024 * 1024


class FlightRecorder:
    """Append-only JSONL event log that survives crashes: every
    ``emit`` is flushed and fsynced, so the last record is on disk
    even if the process is SIGKILLed right after. Size-capped: the
    stream rolls once to ``<path>.1`` at ``max_bytes``.

    Thread-safe: ``emit`` / ``close`` serialize on ``self._lock``, so a
    rotation racing an emit from another thread cannot write through a
    closed handle (``_write`` / ``_rotate`` run only inside that region
    and need no lock of their own)."""

    def __init__(self, path: str, max_bytes: Optional[int] = None):
        self.path = path
        self.max_bytes = int(max_bytes) if max_bytes and max_bytes > 0 \
            else _DEFAULT_MAX_BYTES
        self._lock = threading.Lock()
        self._f = None
        self._size = 0
        try:
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
            self._f = open(path, "a")
            self._size = os.fstat(self._f.fileno()).st_size
        except OSError:
            pass   # telemetry must never kill the run it observes

    def _write(self, record: Dict[str, Any]) -> None:
        """Serialize + append one record durably, tracking file size."""
        try:
            line = json.dumps(record, default=str) + "\n"
            self._f.write(line)
            self._f.flush()
            os.fsync(self._f.fileno())
            self._size += len(line)
        except (OSError, ValueError):
            pass

    def _rotate(self) -> None:
        """Roll the stream to ``<path>.1`` (replacing any previous
        roll) and restart the live file with a ``recorder_rotated``
        event, so the roll itself is on the record."""
        old_size = self._size
        try:
            self._f.close()
            os.replace(self.path, self.path + ".1")
            self._f = open(self.path, "a")
            self._size = 0
        except OSError:
            # re-open best-effort; a failed roll keeps appending to
            # whatever file handle survives
            try:
                self._f = open(self.path, "a")
                self._size = os.fstat(self._f.fileno()).st_size
            except OSError:
                self._f = None
                return
        self._write({"ts": round(time.time(), 3),
                     "event": "recorder_rotated",
                     "rotated_bytes": old_size,
                     "rotated_to": self.path + ".1"})

    def emit(self, event: str, **fields: Any) -> None:
        """Append one event line, durably (flush + fsync), rotating
        first when the file would exceed ``max_bytes``."""
        with self._lock:
            if self._f is None:
                return
            if self._size >= self.max_bytes and self._size > 0:
                self._rotate()
                if self._f is None:
                    return
            # stamped AFTER any rotation: the roll writes its own
            # recorder_rotated event, and a pre-roll stamp would order
            # this record before it whenever the roll's fsync crosses
            # a millisecond boundary
            record = {"ts": round(time.time(), 3), "event": event}
            record.update(fields)
            self._write(record)

    def tail(self, n: int = 10) -> List[Dict[str, Any]]:
        return read_tail(self.path, n)

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None


def _read_lines(path: Optional[str]) -> List[str]:
    if not path:
        return []
    try:
        with open(path) as f:
            return f.readlines()
    except OSError:
        return []


def _parse(lines: List[str]) -> List[Dict[str, Any]]:
    out = []
    for line in lines:
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict):
            out.append(rec)
    return out


def read_tail(path: Optional[str], n: int = 10) -> List[Dict[str, Any]]:
    """Last ``n`` parseable event records of ``path`` (missing or
    malformed files yield ``[]`` — the tail decorates diagnostics, it
    must never raise over them). When the live file holds fewer than
    ``n`` lines and a rotated ``<path>.1`` exists, the tail continues
    across the roll."""
    if not path:
        return []
    lines = _read_lines(path)
    if len(lines) < n:
        lines = _read_lines(path + ".1")[-(n - len(lines)):] + lines
    return _parse(lines[-n:])


def read_events(path: Optional[str]) -> List[Dict[str, Any]]:
    """EVERY parseable record of the stream, rotated file first — the
    full-timeline reader the trace exporter and tests use."""
    if not path:
        return []
    return _parse(_read_lines(path + ".1") + _read_lines(path))
