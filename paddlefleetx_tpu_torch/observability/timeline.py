"""Per-thread activity timeline: who was doing what, when (the port's
copy of the JAX package's ``observability/timeline.py``).

Every long-lived thread of the port (the data loader's producer, the
checkpoint writer) registers a named **track** and appends ``(state,
t0, t1, trace)`` intervals to it. From the intervals the pure functions
below derive per-thread utilization and the ``overlap_ratio`` of a set
of tracks (how many of them are busy at once, normalized by their
number).

The recorder is DISABLED by default, and a disabled ``begin`` / ``add``
is an attribute load plus one boolean test. Enabled appends take no
lock: each track's ring is a ``collections.deque(maxlen=...)`` whose
``append`` is one GIL-atomic call, so memory stays bounded at ``cap``
intervals per track (the oldest fall off). The module lock guards only
track registration and ``snapshot()``.

Where the JAX module reads ``PFX_TIMELINE`` and ``PFX_TIMELINE_RING``
at import, the port takes both as arguments: :class:`ThreadTimeline`'s
``enabled`` and ``cap``, and :func:`set_enabled` for the process-global
instance (off, 4096 intervals a track).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

#: one recorded interval: (state, t0, t1, trace-id-or-None); times are
#: wall-clock ``time.time()`` seconds so tracks align with span ``ts``
#: in the merged Perfetto view
Interval = Tuple[str, float, float, Any]

#: states that count as *not busy* for utilization / overlap math —
#: threads parked on queues, events or poll sleeps
WAIT_STATES = frozenset(
    {"idle", "wait", "park", "poll", "harvest_wait"})


class Track:
    """One thread's interval ring.

    ``begin()``/``add()`` are the whole hot-path API: ``begin``
    stamps a start time (0.0 when the recorder is off), ``add``
    appends the closed interval (a no-op when the recorder is off or
    the matching ``begin`` happened while it was off — a mid-interval
    enable never fabricates a since-epoch-long interval)."""

    def __init__(self, name: str, on: threading.Event, cap: int):
        self.name = name
        self._on = on
        self._buf: Deque[Interval] = deque(maxlen=cap)

    def begin(self) -> float:
        """Start-of-interval timestamp, or 0.0 while disabled."""
        if self._on.is_set():
            return time.time()
        return 0.0

    def add(self, state: str, t0: float,
            t1: Optional[float] = None, trace: Any = None) -> None:
        """Record ``[t0, t1]`` (``t1`` defaults to now) under
        ``state``; drops the oldest interval once the ring is full."""
        if not self._on.is_set() or not t0:
            return
        self._buf.append(
            (state, t0, time.time() if t1 is None else t1, trace))

    def intervals(self) -> List[Interval]:
        """Copy of the ring, oldest first (one atomic C call)."""
        return list(self._buf)


class ThreadTimeline:
    """Registry of named tracks plus the shared enabled flag.

    One process-global instance (``get_timeline``) backs the module
    helpers; tests construct private instances freely."""

    def __init__(self, enabled: bool = False, cap: int = 4096):
        self._on = threading.Event()
        if enabled:
            self._on.set()
        self._cap = max(1, int(cap))
        self._lock = threading.Lock()
        self._tracks: Dict[str, Track] = {}

    @property
    def enabled(self) -> bool:
        return self._on.is_set()

    def set_enabled(self, flag: bool) -> None:
        """Flip recording; existing intervals are kept either way."""
        if flag:
            self._on.set()
        else:
            self._on.clear()

    def track(self, name: str) -> Track:
        """The track registered under ``name`` (created on first
        use). Idempotent — a restarted thread reattaches to the same
        ring rather than forking a duplicate Perfetto row."""
        with self._lock:
            tr = self._tracks.get(name)
            if tr is None:
                tr = self._tracks[name] = Track(
                    name, self._on, self._cap)
            return tr

    def snapshot(self, since: float = 0.0
                 ) -> Dict[str, List[Interval]]:
        """Point-in-time ``{track name: [intervals]}`` copy, keeping
        intervals that end after ``since`` (pass a router/bench start
        stamp to scope a long-lived process's rings to one run).
        Empty tracks are kept — an instrumented-but-idle thread still
        earns its Perfetto row. The one safe cross-thread read."""
        with self._lock:
            tracks = list(self._tracks.values())
        return {tr.name: [iv for iv in tr.intervals()
                          if iv[2] > since]
                for tr in tracks}


def utilization(snapshot: Dict[str, List[Interval]]
                ) -> Dict[str, Dict[str, float]]:
    """Per-track time attribution over a ``snapshot()``.

    Returns ``{track: {"busy_s", "wait_s", "util", "window_s"}}``:
    busy = summed duration of non-``WAIT_STATES`` intervals, wait =
    the complement, util = busy / (busy + wait) (0.0 for an empty
    track). Intervals are summed as recorded — the recorder never
    nests states on one track, so no de-overlap pass is needed."""
    out: Dict[str, Dict[str, float]] = {}
    for name, ivs in snapshot.items():
        busy = wait = 0.0
        for state, t0, t1, _ in ivs:
            d = max(0.0, t1 - t0)
            if state in WAIT_STATES:
                wait += d
            else:
                busy += d
        total = busy + wait
        out[name] = {
            "busy_s": busy, "wait_s": wait,
            "util": busy / total if total > 0 else 0.0,
            "window_s": total,
        }
    return out


def overlap_ratio(snapshot: Dict[str, List[Interval]],
                  prefix: str = "fleet-worker-",
                  state: str = "tick") -> Optional[float]:
    """Mean ``state`` concurrency across ``prefix`` tracks, normalized
    by track count — how much of the fleet is mid-tick at once.

    Sweep-line over the matching intervals: with ``depth(t)`` = how
    many tracks are ticking at instant ``t``, the ratio is
    ``mean(depth over the time depth >= 1) / N`` where ``N`` is the
    number of distinct contributing tracks. A lockstep router that
    ticks its N replicas back-to-back scores exactly 1/N (depth never
    exceeds 1); the async router's overlapping ticks push the ratio
    toward 1 (all N busy simultaneously). Returns None when no
    matching intervals exist (recorder off or no fleet)."""
    edges: List[Tuple[float, int]] = []
    tracks = set()
    for name, ivs in snapshot.items():
        if not name.startswith(prefix):
            continue
        for st, t0, t1, _ in ivs:
            if st == state and t1 > t0:
                tracks.add(name)
                edges.append((t0, 1))
                edges.append((t1, -1))
    if not edges:
        return None
    edges.sort()
    depth = 0
    busy_any = depth_time = 0.0
    prev = edges[0][0]
    for t, d in edges:
        span = t - prev
        if depth >= 1:
            busy_any += span
            depth_time += depth * span
        depth += d
        prev = t
    if busy_any <= 0.0:
        return None
    return depth_time / busy_any / len(tracks)


#: the process-global timeline: off until a caller turns it on
_global = ThreadTimeline(enabled=False, cap=4096)


def get_timeline() -> ThreadTimeline:
    """The process-global recorder."""
    return _global


def track(name: str) -> Track:
    """Register (or reattach to) the global track ``name`` — the call
    every thread entrypoint must make (pfxlint PFX304)."""
    return _global.track(name)


def set_enabled(flag: bool) -> None:
    """Flip the global recorder."""
    _global.set_enabled(flag)


def enabled() -> bool:
    """Whether the global recorder is recording."""
    return _global.enabled
