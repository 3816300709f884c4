"""Fixed-memory log-bucketed latency histogram with quantile estimation
(the port's copy of the JAX package's ``observability/histogram.py``).

:class:`LogHistogram` keeps a fixed array of log-spaced buckets:
``observe`` is O(1) (one ``math.log`` and an int increment), memory is
O(buckets) for the life of the process, and any quantile is recovered
by a cumulative walk with bounded RELATIVE error, the bucket width
ratio (~8% at the default 30 buckets a decade). The serving
summaries' ``*_p50_ms`` / ``*_p99_ms`` come from these, not from exact
percentiles over sample lists.

Values at or below ``lo`` land in the underflow bucket (reported as
``lo/2``); values above ``hi`` clamp to the top bucket. Quantiles
interpolate geometrically inside the winning bucket and clamp to the
exact observed ``[min, max]``, so ``quantile(0)`` / ``quantile(1)``
are exact.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, Iterator, Tuple

#: default range, tuned for millisecond-denominated latencies:
#: 1 microsecond .. ~2.8 hours, 10 decades
_DEFAULT_LO = 1e-3
_DEFAULT_HI = 1e7
_DEFAULT_BPD = 30


class LogHistogram:
    """Log-bucketed histogram: O(1) observe, O(buckets) memory,
    quantiles within one bucket's relative width."""

    __slots__ = ("lo", "hi", "ratio", "_log_ratio", "_n", "_counts",
                 "_count", "_sum", "_min", "_max", "_lock")

    def __init__(self, lo: float = _DEFAULT_LO,
                 hi: float = _DEFAULT_HI,
                 buckets_per_decade: int = _DEFAULT_BPD):
        if not (0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
        if buckets_per_decade < 1:
            raise ValueError(
                f"buckets_per_decade must be >= 1, got "
                f"{buckets_per_decade}")
        self.lo = float(lo)
        self.hi = float(hi)
        self.ratio = 10.0 ** (1.0 / buckets_per_decade)
        self._log_ratio = math.log(self.ratio)
        # bucket 0 is the underflow bucket [0, lo]; bucket i >= 1 spans
        # (lo * ratio^(i-1), lo * ratio^i]; the top bucket absorbs
        # everything past hi
        self._n = 1 + int(math.ceil(
            math.log(self.hi / self.lo) / self._log_ratio))
        # the histogram synchronizes itself: the registry observes
        # under its own lock, but always-on local registries (the
        # server's) are read from other threads too (the metrics
        # endpoint): reentrant because snapshot() walks
        # quantile()/cumulative() inline
        self._lock = threading.RLock()
        self._counts = [0] * (self._n + 1)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    # -- recording -----------------------------------------------------
    def observe(self, value: float) -> None:
        """Record one sample; non-finite values are dropped (telemetry
        must never raise over a NaN latency)."""
        v = float(value)
        if not math.isfinite(v):
            return
        if v <= self.lo:
            idx = 0
        else:
            idx = 1 + int(math.log(v / self.lo) / self._log_ratio)
            if idx > self._n:
                idx = self._n
        with self._lock:
            self._counts[idx] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    def reset(self) -> None:
        """Zero every bucket and the running stats, in place."""
        with self._lock:
            self._counts = [0] * (self._n + 1)
            self._count = 0
            self._sum = 0.0
            self._min = math.inf
            self._max = -math.inf

    # -- reading -------------------------------------------------------
    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def min(self) -> float:
        """Smallest observed sample (``inf`` when empty)."""
        with self._lock:
            return self._min

    @property
    def max(self) -> float:
        """Largest observed sample (``-inf`` when empty)."""
        with self._lock:
            return self._max

    def bounds(self, idx: int) -> Tuple[float, float]:
        """``(lower, upper)`` value bounds of bucket ``idx``."""
        if idx <= 0:
            return (0.0, self.lo)
        return (self.lo * self.ratio ** (idx - 1),
                self.lo * self.ratio ** idx)

    def quantile(self, q: float) -> float:
        """Estimated value at quantile ``q`` in [0, 1]; 0.0 when the
        histogram is empty. Monotonic in ``q``; exact at 0 and 1
        (clamped to the observed min/max)."""
        with self._lock:
            if self._count == 0:
                return 0.0
            q = min(max(float(q), 0.0), 1.0)
            # rank of the target sample among count samples (midpoint
            # convention keeps single-sample histograms exact)
            target = q * (self._count - 1)
            cum = 0
            for idx, c in enumerate(self._counts):
                if c == 0:
                    continue
                if cum + c > target:
                    lower, upper = self.bounds(idx)
                    if idx == 0:
                        est = self.lo / 2.0
                    else:
                        # geometric interpolation inside the bucket:
                        # the error bound is the bucket's relative
                        # width
                        frac = (target - cum + 0.5) / c
                        est = lower * (upper / lower) ** min(frac, 1.0)
                    return min(max(est, self._min), self._max)
                cum += c
            return self._max

    def percentile(self, p: float) -> float:
        """``quantile(p / 100)`` — the ``np.percentile`` spelling."""
        return self.quantile(p / 100.0)

    def cumulative(self) -> Iterator[Tuple[float, int]]:
        """``(upper_bound, cumulative_count)`` over non-empty buckets,
        ascending — the Prometheus ``le`` bucket series."""
        with self._lock:
            cum = 0
            for idx, c in enumerate(self._counts):
                if c == 0:
                    continue
                cum += c
                yield self.bounds(idx)[1], cum

    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time summary dict (count/sum/min/max + p50/p90/p99
        + cumulative ``buckets``), the shape the registry snapshot,
        ``/vars``, and the Prometheus exporter consume — exporters on
        other threads read this copy, never the live bucket arrays."""
        with self._lock:
            if self._count == 0:
                return {"count": 0, "sum": 0.0, "buckets": []}
            return {
                "count": self._count,
                "sum": round(self._sum, 6),
                "min": round(self._min, 6),
                "max": round(self._max, 6),
                "p50": round(self.quantile(0.50), 6),
                "p90": round(self.quantile(0.90), 6),
                "p99": round(self.quantile(0.99), 6),
                "buckets": [[upper, cum]
                            for upper, cum in self.cumulative()],
            }
