"""Minimal counter / gauge / timer registry of the port.

The counter names are the JAX package's (``docs/attention_dispatch.md``
for ``attention/*``, ``docs/inference.md`` for ``serving/*``,
``docs/lora.md`` for ``lora/*`` and the adapter cache's
``serving/adapter_*``), so a run of either package reads the same way;
a name needs no declaration before its first ``inc``. One process-global registry
(:func:`get_registry`) collects the dispatch and serving counters; it
is disabled until a caller turns it on (:func:`set_enabled`), and then
``inc`` is one boolean test. Unlike the JAX package, where dispatch
counters fire once per compiled trace, the port runs eagerly and its
counters fire once per call.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Dict


class MetricsRegistry:
    """Counters, gauges and accumulated timers in plain dicts."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, Any] = {}
        self._timers: Dict[str, float] = {}

    def inc(self, name: str, n: float = 1) -> None:
        """Add ``n`` to counter ``name`` (no-op while disabled)."""
        if self.enabled:
            self._counters[name] = self._counters.get(name, 0) + n

    def counter(self, name: str) -> float:
        """Current value of counter ``name`` (0 if never incremented)."""
        return self._counters.get(name, 0)

    def set_gauge(self, name: str, value: Any) -> None:
        """Set gauge ``name`` (no-op while disabled)."""
        if self.enabled:
            self._gauges[name] = value

    def gauge(self, name: str, default: Any = None) -> Any:
        """Current value of gauge ``name``."""
        return self._gauges.get(name, default)

    @contextmanager
    def timer(self, name: str):
        """Accumulate the block's wall time under ``name`` and count its
        entries under ``name + "/calls"``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.enabled:
                self._timers[name] = self._timers.get(name, 0.0) + \
                    time.perf_counter() - t0
            self.inc(name + "/calls")

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Copy of ``{"counters", "gauges", "timers"}``."""
        return {"counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "timers": dict(self._timers)}

    def reset(self) -> None:
        """Zero every counter, gauge and timer."""
        self._counters.clear()
        self._gauges.clear()
        self._timers.clear()


#: the process-global registry; disabled until a caller turns it on
_global = MetricsRegistry(enabled=False)


def get_registry() -> MetricsRegistry:
    """The process-global registry."""
    return _global


def set_enabled(flag: bool) -> None:
    """Turn the process-global registry on or off."""
    _global.enabled = bool(flag)


def inc(name: str, n: float = 1) -> None:
    """Increment a counter of the process-global registry."""
    _global.inc(name, n)
