"""Metric and trace exporters: Prometheus text and Perfetto / Chrome
JSON (the port's copy of the JAX package's ``observability/export.py``).

- :func:`prometheus_text` walks one or more live
  :class:`~.metrics.MetricsRegistry` objects into the Prometheus text
  exposition format (version 0.0.4): counters as ``pfx_<name>_total``,
  numeric gauges as ``pfx_<name>``, timers as
  ``pfx_<name>_seconds_total``, histograms as cumulative
  ``_bucket{le=...}`` series plus ``_sum`` / ``_count``. Series names
  have ``/`` mapped to ``_`` (``serving/ttft_ms`` ->
  ``pfx_serving_ttft_ms``).
- :func:`merge_snapshots` merges registry snapshots for ``/vars``.
- :func:`chrome_trace` converts flight-recorder span records
  (``observability/spans.py``) into the Chrome trace-event JSON that
  Perfetto / ``chrome://tracing`` loads: each trace id gets its own
  track under a ``requests`` process, and a thread-timeline snapshot
  (``observability/timeline.py``) adds one track per instrumented
  thread under a ``threads`` process (pid / tid assignment is stable
  across exports).

Both are served live by ``observability/server.py`` (``/metrics`` and
``/trace``).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterable, List

_SANITIZE_RE = re.compile(r"[^a-zA-Z0-9_]")

#: flight-recorder event kinds the trace exporter understands
_SPAN_EVENTS = ("span_begin", "span_end", "span", "span_point")


def _metric_name(name: str, suffix: str = "") -> str:
    """``serving/ttft_ms`` -> ``pfx_serving_ttft_ms<suffix>``."""
    return "pfx_" + _SANITIZE_RE.sub("_", name) + suffix


def _fmt(value: Any) -> str:
    """A Prometheus-grammar sample value (floats in repr precision)."""
    return repr(float(value))


def prometheus_text(registries: Iterable[Any]) -> str:
    """Text exposition of the given registries, merged.

    Args:
        registries: live ``MetricsRegistry`` objects. Each is read
            exactly once through ``snapshot()`` — the one
            lock-protected cross-thread read — so the HTTP serving
            thread never touches live tables or bucket arrays the
            main loop is mutating. Counter/timer values merge by
            summation, gauges last-wins, histograms first-wins.

    Returns:
        The exposition body, one ``# TYPE`` comment + samples per
        metric, trailing newline included.
    """
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    timers: Dict[str, float] = {}
    hists: Dict[str, Dict[str, Any]] = {}
    for reg in registries:
        snap = reg.snapshot()
        for k, v in snap["counters"].items():
            counters[k] = counters.get(k, 0) + v
        for k, v in snap["gauges"].items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                gauges[k] = float(v)
        for k, v in snap["timers"].items():
            timers[k] = timers.get(k, 0.0) + v
        for k, h in snap["histograms"].items():
            hists.setdefault(k, h)
    lines: List[str] = []
    for name, val in sorted(counters.items()):
        m = _metric_name(name, "_total")
        lines += [f"# TYPE {m} counter", f"{m} {_fmt(val)}"]
    for name, val in sorted(gauges.items()):
        m = _metric_name(name)
        lines += [f"# TYPE {m} gauge", f"{m} {_fmt(val)}"]
    for name, val in sorted(timers.items()):
        m = _metric_name(name, "_seconds_total")
        lines += [f"# TYPE {m} counter", f"{m} {_fmt(val)}"]
    for name, h in sorted(hists.items()):
        m = _metric_name(name)
        count = h.get("count", 0)
        lines.append(f"# TYPE {m} histogram")
        for upper, cum in h.get("buckets", []):
            lines.append(f'{m}_bucket{{le="{_fmt(upper)}"}} {cum}')
        lines.append(f'{m}_bucket{{le="+Inf"}} {count}')
        lines.append(f"{m}_sum {_fmt(h.get('sum', 0.0))}")
        lines.append(f"{m}_count {count}")
    return "\n".join(lines) + "\n"


def merge_snapshots(snapshots: Iterable[Dict[str, Any]]
                    ) -> Dict[str, Any]:
    """Merge registry ``snapshot()`` dicts for the ``/vars`` endpoint
    (counters/timers sum, gauges/series/histograms last-wins)."""
    out: Dict[str, Any] = {"counters": {}, "gauges": {}, "timers": {},
                           "series": {}, "histograms": {}}
    for snap in snapshots:
        for k, v in snap.get("counters", {}).items():
            out["counters"][k] = out["counters"].get(k, 0) + v
        for k, v in snap.get("timers", {}).items():
            out["timers"][k] = out["timers"].get(k, 0.0) + v
        out["gauges"].update(snap.get("gauges", {}))
        out["series"].update(snap.get("series", {}))
        out["histograms"].update(snap.get("histograms", {}))
    return out


def _span_args(rec: Dict[str, Any]) -> Dict[str, Any]:
    """Everything a span record carries beyond the envelope fields."""
    return {k: v for k, v in rec.items()
            if k not in ("ts", "event", "name", "trace", "span",
                         "parent", "dur_ms")}


#: stable Perfetto process ids: request/span tracks vs thread tracks
_PID_REQUESTS = 1
_PID_THREADS = 2


def chrome_trace(records: Iterable[Dict[str, Any]],
                 timeline: Any = None) -> Dict[str, Any]:
    """Chrome trace-event JSON from flight-recorder records, plus
    (optionally) per-thread activity tracks.

    Args:
        records: parsed events.jsonl records (non-span events are
            skipped); ``observability.recorder.read_events`` provides
            them rotation-aware.
        timeline: optional ``{track name: [(state, t0, t1, trace)]}``
            snapshot from ``observability.timeline`` — each track
            renders as a thread row under a second ``threads``
            process, interval states as ``X`` slices (trace-tagged
            slices carry the request's trace id in ``args`` so a
            handoff lines up against its span row).

    Returns:
        ``{"traceEvents": [...], "displayTimeUnit": "ms"}`` — loadable
        by Perfetto and ``chrome://tracing``. pid/tid assignment is
        STABLE: span tracks live in pid 1 (``requests``) with tids
        assigned 1..N over the sorted trace ids, timeline tracks in
        pid 2 (``threads``) with tids 1..M over the sorted track
        names — two exports of the same data group identically.
        ``span``/``span_begin``/``span_end`` map to phases ``X``/
        ``B``/``E``, points to ``i``.
    """
    recs = [r for r in records if r.get("event") in _SPAN_EVENTS]
    tids = {key: i + 1 for i, key in enumerate(
        sorted({str(r.get("trace")) for r in recs}))}
    events: List[Dict[str, Any]] = []
    if recs:
        events.append({"ph": "M", "name": "process_name",
                       "pid": _PID_REQUESTS, "tid": 0,
                       "args": {"name": "requests"}})
        for key, tid in sorted(tids.items(), key=lambda kv: kv[1]):
            events.append({"ph": "M", "name": "thread_name",
                           "pid": _PID_REQUESTS, "tid": tid,
                           "args": {"name": f"trace {key}"}})
    for rec in recs:
        kind = rec.get("event")
        ts_us = float(rec.get("ts", 0.0)) * 1e6
        base = {"name": rec.get("name", "?"), "pid": _PID_REQUESTS,
                "tid": tids[str(rec.get("trace"))],
                "args": _span_args(rec)}
        if kind == "span_begin":
            events.append({**base, "ph": "B", "ts": ts_us})
        elif kind == "span_end":
            events.append({**base, "ph": "E", "ts": ts_us})
        elif kind == "span":
            dur_us = float(rec.get("dur_ms", 0.0)) * 1e3
            events.append({**base, "ph": "X",
                           "ts": ts_us - dur_us, "dur": dur_us})
        else:   # span_point
            events.append({**base, "ph": "i", "ts": ts_us, "s": "t"})
    if timeline:
        events.append({"ph": "M", "name": "process_name",
                       "pid": _PID_THREADS, "tid": 0,
                       "args": {"name": "threads"}})
        for tid, name in enumerate(sorted(timeline), start=1):
            events.append({"ph": "M", "name": "thread_name",
                           "pid": _PID_THREADS, "tid": tid,
                           "args": {"name": name}})
            for state, t0, t1, trace in timeline[name]:
                events.append({
                    "ph": "X", "name": state, "pid": _PID_THREADS,
                    "tid": tid, "ts": t0 * 1e6,
                    "dur": max(0.0, t1 - t0) * 1e6,
                    "args": ({"trace": trace}
                             if trace is not None else {})})
    return {"traceEvents": events, "displayTimeUnit": "ms"}
