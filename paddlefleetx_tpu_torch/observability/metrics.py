"""Counter / gauge / timer / histogram registry of the port (the
JAX package's ``observability/metrics.py``).

The counter names are the JAX package's (``docs/attention_dispatch.md``
for ``attention/*``, ``docs/inference.md`` for ``serving/*``,
``docs/lora.md`` for ``lora/*`` and the adapter cache's
``serving/adapter_*``), so a run of either package reads the same way;
a name needs no declaration before its first ``inc``. One
process-global registry (:func:`get_registry`) collects the dispatch
and serving counters; it is disabled until a caller turns it on
(:func:`set_enabled`), and then ``inc`` / ``observe`` are one boolean
test. Unlike the JAX package, where dispatch counters fire once per
compiled trace, the port runs eagerly and its counters fire once per
call.

Components keep their own always-on registries beside it (a
``GenerationServer``'s latency histograms, an ``Engine``'s gauges).
Histograms (:meth:`MetricsRegistry.observe`) are fixed-memory
log-bucketed estimators (``observability/histogram.py``), so a
long-lived server's percentile series never grow.

Thread model: the watchdog thread (``core/resilience.py``) and the
metrics endpoint's per-request threads (``observability/server.py``)
read and increment registries the main loop mutates, so every table
access goes through the registry's lock; the ``enabled`` test stays
outside it.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional

from .histogram import LogHistogram


class MetricsRegistry:
    """Counters, gauges, timers and histograms in plain dicts,
    guarded by one lock."""

    def __init__(self, enabled: bool = True):
        # an Event, not a bool: the hot path reads it without the lock
        # while another thread may turn the registry on or off
        self._on = threading.Event()
        if enabled:
            self._on.set()
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, Any] = {}
        self._timers: Dict[str, float] = {}
        self._hists: Dict[str, LogHistogram] = {}

    @property
    def enabled(self) -> bool:
        """Whether the registry records (one ``Event.is_set``)."""
        return self._on.is_set()

    def set_enabled(self, flag: bool) -> None:
        """Turn recording on or off."""
        if flag:
            self._on.set()
        else:
            self._on.clear()

    # -- counters ------------------------------------------------------
    def inc(self, name: str, n: float = 1) -> None:
        """Add ``n`` to counter ``name`` (no-op while disabled)."""
        if not self.enabled:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def counter(self, name: str) -> float:
        """Current value of counter ``name`` (0 if never incremented)."""
        with self._lock:
            return self._counters.get(name, 0)

    # -- gauges --------------------------------------------------------
    def set_gauge(self, name: str, value: Any) -> None:
        """Set gauge ``name`` (no-op while disabled)."""
        if not self.enabled:
            return
        with self._lock:
            self._gauges[name] = value

    def gauge(self, name: str, default: Any = None) -> Any:
        """Current value of gauge ``name``."""
        with self._lock:
            return self._gauges.get(name, default)

    # -- timers --------------------------------------------------------
    def add_time(self, name: str, seconds: float) -> None:
        """Add ``seconds`` to timer ``name`` (no-op while disabled)."""
        if not self.enabled:
            return
        with self._lock:
            self._timers[name] = self._timers.get(name, 0.0) + seconds

    @contextmanager
    def timer(self, name: str):
        """Accumulate the block's wall time under ``name`` and count its
        entries under ``name + "/calls"``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add_time(name, time.perf_counter() - t0)
            self.inc(name + "/calls")

    # -- histograms ----------------------------------------------------
    def observe(self, name: str, value: float) -> None:
        """Record one sample into the log-bucketed histogram under
        ``name`` (created on first use): O(1), O(buckets) memory."""
        if not self.enabled:
            return
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = LogHistogram()
            h.observe(value)

    def histogram(self, name: str) -> Optional[LogHistogram]:
        """The live histogram registered under ``name``, or None
        (main-thread state: exporters read :meth:`snapshot`)."""
        with self._lock:
            return self._hists.get(name)

    # -- lifecycle -----------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time copy: ``{"counters", "gauges", "timers",
        "histograms"}`` (histograms as summary dicts): the one safe
        cross-thread read."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "timers": dict(self._timers),
                "histograms": {k: h.snapshot()
                               for k, h in self._hists.items()},
            }

    def reset(self) -> None:
        """Zero everything; histograms are reset in place, so a handle
        from :meth:`histogram` stays live."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._timers.clear()
            for h in self._hists.values():
                h.reset()


#: the process-global registry; disabled until a caller turns it on
_global = MetricsRegistry(enabled=False)


def get_registry() -> MetricsRegistry:
    """The process-global registry."""
    return _global


def set_enabled(flag: bool) -> None:
    """Turn the process-global registry on or off."""
    _global.set_enabled(flag)


def inc(name: str, n: float = 1) -> None:
    """Increment a counter of the process-global registry."""
    if not _global.enabled:
        return
    _global.inc(name, n)


def observe(name: str, value: float) -> None:
    """Record a histogram sample in the process-global registry."""
    if not _global.enabled:
        return
    _global.observe(name, value)
