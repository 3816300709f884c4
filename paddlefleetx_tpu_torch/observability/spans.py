"""Trace / span primitives emitted through the flight recorder (the
port's copy of the JAX package's ``observability/spans.py``).

Spans make the host-side schedule durable: every begin / end / point is
one fsynced ``events.jsonl`` line (``observability/recorder.py``), so
the training engine's ``engine/fit`` -> ``engine/step`` ->
``engine/h2d`` tree and its ``engine/save`` spans survive a crash.

Id grammar: ``trace_id`` is 16 lowercase hex chars (one per fit),
``span_id`` 8 hex chars; children carry ``parent`` so the tree
re-nests. Record kinds (each also carries the recorder's ``ts``
wall-clock seconds):

- ``span_begin``: ``name, trace, span[, parent]`` and open attributes;
- ``span_end``: ``name, trace, span, dur_ms`` and close attributes;
- ``span``: a complete span reported after the fact (``dur_ms``
  measured by the caller; it starts at ``ts - dur_ms``);
- ``span_point``: an instant event on a parent span.

A :class:`Tracer` over ``recorder=None`` hands out the shared
:data:`NULL_SPAN`, whose methods are no-ops returning itself: call
sites never branch on whether tracing is on.
"""

from __future__ import annotations

import os
import time
from typing import Any, Optional


def _new_id(nbytes: int) -> str:
    """A fresh random id as ``2 * nbytes`` lowercase hex chars."""
    return os.urandom(nbytes).hex()


class Span:
    """One open span; ``end()`` (idempotent) emits its duration.
    Usable as a context manager — ``__exit__`` ends it."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id",
                 "_tracer", "_t0", "_ended")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent_id: Optional[str] = None, **attrs: Any):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_id(4)
        self.parent_id = parent_id
        self._tracer = tracer
        self._t0 = time.perf_counter()
        self._ended = False
        fields = {"name": name, "trace": trace_id,
                  "span": self.span_id}
        if parent_id is not None:
            fields["parent"] = parent_id
        tracer._emit("span_begin", **fields, **attrs)

    # -- tree ----------------------------------------------------------
    def start_span(self, name: str, **attrs: Any) -> "Span":
        """Open a child span under this one (same trace)."""
        return Span(self._tracer, name, self.trace_id,
                    parent_id=self.span_id, **attrs)

    def span_point(self, name: str, **attrs: Any) -> None:
        """Emit an instant event attached to this span."""
        self._tracer._emit("span_point", name=name,
                           trace=self.trace_id, parent=self.span_id,
                           **attrs)

    def complete_span(self, name: str, dur_s: float,
                      **attrs: Any) -> None:
        """Report an already-measured child span in one record (used
        for phases timed by existing code, e.g. compile/h2d/save)."""
        self._tracer._emit("span", name=name, trace=self.trace_id,
                           span=_new_id(4), parent=self.span_id,
                           dur_ms=round(dur_s * 1000.0, 3), **attrs)

    # -- lifecycle -----------------------------------------------------
    def end(self, **attrs: Any) -> None:
        """Close the span, emitting ``span_end`` with ``dur_ms``.
        Idempotent — a second call is a no-op, so defensive cleanup
        paths can end unconditionally."""
        if self._ended:
            return
        self._ended = True
        self._tracer._emit(
            "span_end", name=self.name, trace=self.trace_id,
            span=self.span_id,
            dur_ms=round((time.perf_counter() - self._t0) * 1000.0, 3),
            **attrs)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()


class _NullSpan:
    """The do-nothing span a disabled tracer hands out; every method
    is a no-op and child-creation returns the same singleton, so call
    sites stay branch-free."""

    __slots__ = ()
    name = ""
    trace_id = None
    span_id = None
    parent_id = None

    def start_span(self, name: str, **attrs: Any) -> "_NullSpan":
        return self

    def span_point(self, name: str, **attrs: Any) -> None:
        pass

    def complete_span(self, name: str, dur_s: float,
                      **attrs: Any) -> None:
        pass

    def end(self, **attrs: Any) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


#: the shared no-op span — a safe initial value for "current span"
#: attributes, and what a disabled tracer returns
NULL_SPAN = _NullSpan()


class Tracer:
    """Span factory over one flight recorder (or None = disabled)."""

    __slots__ = ("_recorder",)

    def __init__(self, recorder=None):
        self._recorder = recorder

    @property
    def enabled(self) -> bool:
        """Whether spans will actually reach a recorder."""
        return self._recorder is not None

    def _emit(self, event: str, **fields: Any) -> None:
        if self._recorder is not None:
            self._recorder.emit(event, **fields)

    def start_trace(self, name: str, trace_id: Optional[str] = None,
                    **attrs: Any):
        """Open a ROOT span under a fresh trace id (or ``trace_id``,
        which is how a resumed request links back to its original
        trace). Returns :data:`NULL_SPAN` when disabled."""
        if self._recorder is None:
            return NULL_SPAN
        return Span(self, name, trace_id or _new_id(8), **attrs)
