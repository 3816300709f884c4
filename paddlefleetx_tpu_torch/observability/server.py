"""Live telemetry endpoints: a stdlib HTTP server for /metrics & co. (the
port's copy of the JAX package's ``observability/server.py``).

A ``ThreadingHTTPServer`` runs next to the process on daemon threads so
Prometheus (or ``curl``) can read it live. Endpoints:

- ``/metrics``: Prometheus text exposition of every attached registry
  (``observability/export.py``);
- ``/vars``: the merged registry snapshot as JSON (histograms as
  summary dicts);
- ``/healthz``: liveness and drain state: HTTP 200 with ``{"status":
  "ok", ...}`` normally, HTTP 503 with ``{"status": "draining", ...}``
  once the generation server enters drain, the signal a load balancer
  needs to stop routing to a preempted worker while in-flight requests
  finish;
- ``/trace``: the span records of the attached ``events.jsonl`` plus
  the live thread-timeline tracks, merged into one Perfetto / Chrome
  trace-event JSON;
- ``/timeline``: the raw thread-timeline snapshot as JSON (``tracks``
  plus ``utilization`` and ``overlap_ratio``).

Wiring: where the JAX package starts the server from
``PFX_METRICS_PORT``, the port takes the port as an argument:
:func:`start` (``port=0`` binds an ephemeral port; read it back from
``.port``), which ``GenerationServer(metrics_port=...)`` and ``cli.py
serve --metrics-port`` call. One process-wide singleton serves every
component that attaches to it.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional

from . import export
from . import metrics as metrics_mod
from . import timeline as timeline_mod
from .recorder import read_events


class MetricsServer:
    """One live telemetry HTTP server over attached registries.

    Starts serving on construction (daemon thread — never blocks
    process exit); ``close()`` shuts it down. The process-global
    registry is always attached; components add their own via
    :meth:`add_registry`.
    """

    def __init__(self, port: int = 0, host: str = "0.0.0.0",
                 registries: Optional[List[Any]] = None,
                 health: Optional[Callable[[], Dict[str, Any]]] = None,
                 events_path: Optional[str] = None):
        # the wiring tables are written by the main thread (attach
        # calls after construction) and read by per-request threads,
        # so both sides go through _cb_lock; handlers snapshot under
        # it and do their (blocking) socket IO outside it
        self._cb_lock = threading.Lock()
        self._registries: List[Any] = [metrics_mod.get_registry()]
        for reg in registries or []:
            self.add_registry(reg)
        self._health = health
        self._events_path = events_path
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            """Request handler bound to the owning server."""

            def do_GET(self):          # noqa: N802 (stdlib API name)
                outer._handle(self)

            def log_message(self, fmt, *args):
                pass   # scrapes must not spam the serving log

        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._serve, name="pfx-metrics", daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        """The accept loop's thread: its lifetime is one ``serve`` span
        on the ``pfx-metrics-accept`` track; each request's handling is
        timed on the ``pfx-metrics`` track by :meth:`_handle`."""
        tl = timeline_mod.track("pfx-metrics-accept")
        t0 = tl.begin()
        try:
            self._httpd.serve_forever(poll_interval=0.1)
        finally:
            tl.add("serve", t0)

    # -- wiring --------------------------------------------------------
    @property
    def port(self) -> int:
        """The bound port (useful when constructed with port=0)."""
        return self._httpd.server_address[1]

    def url(self, path: str = "/metrics") -> str:
        """A loopback URL for ``path`` — the curl-equivalent tests
        and the CI smoke scrape use."""
        return f"http://127.0.0.1:{self.port}{path}"

    def add_registry(self, reg: Any) -> None:
        """Attach another live registry to /metrics and /vars."""
        with self._cb_lock:
            if reg is not None and reg not in self._registries:
                self._registries.append(reg)

    def set_health(self, fn: Callable[[], Dict[str, Any]]) -> None:
        """Install the /healthz payload provider (dict with a
        ``status`` key; anything but ``"ok"`` answers 503)."""
        with self._cb_lock:
            self._health = fn

    def set_events_path(self, path: str) -> None:
        """Point /trace at an events.jsonl stream."""
        with self._cb_lock:
            self._events_path = path

    def close(self) -> None:
        """Stop serving and release the port. Idempotent."""
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except OSError:
            pass

    # -- request handling ----------------------------------------------
    def _respond(self, handler, code: int, body: str,
                 content_type: str) -> None:
        data = body.encode("utf-8")
        handler.send_response(code)
        handler.send_header("Content-Type", content_type)
        handler.send_header("Content-Length", str(len(data)))
        handler.end_headers()
        handler.wfile.write(data)

    def _handle(self, handler) -> None:
        # per-request handler threads share one timeline track (the
        # deque append is atomic, so interleaved scrapes are safe)
        tl = timeline_mod.track("pfx-metrics")
        tl_t0 = tl.begin()
        path = handler.path.split("?", 1)[0]
        # snapshot the wiring under the lock, then render and answer
        # outside it — _respond blocks on the client socket and must
        # never do so while holding _cb_lock
        with self._cb_lock:
            registries = list(self._registries)
            health = self._health
            events_path = self._events_path
        try:
            if path == "/metrics":
                self._respond(
                    handler, 200,
                    export.prometheus_text(registries),
                    "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/vars":
                snap = export.merge_snapshots(
                    r.snapshot() for r in registries)
                self._respond(handler, 200,
                              json.dumps(snap, default=str),
                              "application/json")
            elif path == "/healthz":
                payload = health() if health is not None \
                    else {"status": "ok"}
                code = 200 if payload.get("status") == "ok" else 503
                self._respond(handler, code, json.dumps(payload),
                              "application/json")
            elif path == "/trace":
                if not events_path:
                    self._respond(handler, 404,
                                  '{"error": "no events stream"}',
                                  "application/json")
                    return
                trace = export.chrome_trace(
                    read_events(events_path),
                    timeline=timeline_mod.get_timeline().snapshot())
                self._respond(handler, 200,
                              json.dumps(trace, default=str),
                              "application/json")
            elif path == "/timeline":
                snap = timeline_mod.get_timeline().snapshot()
                ratio = timeline_mod.overlap_ratio(snap)
                self._respond(
                    handler, 200,
                    json.dumps({
                        "enabled": timeline_mod.enabled(),
                        "tracks": snap,
                        "utilization":
                            timeline_mod.utilization(snap),
                        "overlap_ratio": ratio,
                    }, default=str),
                    "application/json")
            else:
                self._respond(handler, 404, '{"error": "not found"}',
                              "application/json")
        except Exception as exc:   # noqa: BLE001 — a scrape racing a
            # mutating registry must answer 500, never kill the server
            try:
                self._respond(handler, 500,
                              json.dumps({"error": str(exc)}),
                              "application/json")
            except OSError:
                pass   # client hung up mid-answer
        finally:
            tl.add("serve", tl_t0)


#: the process-wide server (every component shares one port)
_server: Optional[MetricsServer] = None
_lock = threading.Lock()


def get_server() -> Optional[MetricsServer]:
    """The live singleton, or None when nothing started one."""
    return _server


def start(port: int = 0, host: str = "0.0.0.0", registry: Any = None,
          health: Optional[Callable[[], Dict[str, Any]]] = None,
          events_path: Optional[str] = None) -> Optional[MetricsServer]:
    """Start (or attach to) the process-wide server on ``port``.

    Args:
        port: the TCP port (``0``: an ephemeral one). Ignored when the
            singleton already runs: every component shares its port.
        host: the interface to bind.
        registry: a component registry to attach (the global one is
            always included).
        health: /healthz payload provider (last caller wins; in
            practice the GenerationServer, whose drain state is the
            payload that matters).
        events_path: events.jsonl to serve on /trace (last caller
            wins).

    Returns:
        The singleton server, or None when the port cannot be bound
        (telemetry never kills the run it observes).
    """
    global _server
    with _lock:
        if _server is None:
            try:
                _server = MetricsServer(port=int(port), host=host)
            except OSError:
                return None
        if registry is not None:
            _server.add_registry(registry)
        if health is not None:
            _server.set_health(health)
        if events_path is not None:
            _server.set_events_path(events_path)
        return _server


def stop() -> None:
    """Shut the singleton down (tests; long-lived runs just exit —
    the serving thread is a daemon). The singleton swap happens under
    ``_lock`` but the actual shutdown — which BLOCKS until the serve
    loop exits — runs outside it, so a request thread that needs the
    module lock can finish and the loop can drain."""
    global _server
    with _lock:
        doomed, _server = _server, None
    if doomed is not None:
        doomed.close()
