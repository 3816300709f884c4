"""Failure as a tested code path: fault injection and the step watchdog
(the port of the JAX package's ``core/resilience.py``).

- :class:`FaultInjector` parses a fault spec, e.g. ``kill@step=7``,
  ``corrupt_ckpt@save=2``, ``hang@step=5:0.5s``, ``admit_fail@req=3``,
  in the JAX package's grammar, and the engine's step and save loop
  and the serving tick call :meth:`FaultInjector.fire` at the matching
  sites. Tests drive real kill -> resume loops with it (raise mode) and
  assert loss- and token-exact continuation.
- :class:`StepWatchdog` is a monitor thread timing train steps and
  decode ticks against an adaptive deadline (a multiple of the
  trailing median); a stall dumps every thread's stack, emits a
  ``watchdog_stall`` event and the ``engine/watchdog_stalls`` counter,
  and with ``action="abort"`` exits the process.

Where the JAX package reads ``PFX_FAULTS``, ``PFX_FAULTS_SEED``,
``PFX_FAULTS_MODE`` and ``PFX_WATCHDOG_*`` from the environment, the
port takes the same values as keyword arguments with the JAX defaults
(``spec``, ``seed``, ``kill_mode``; ``factor``, ``min_interval_s``,
``action``), which ``cli.py``'s ``--faults`` / ``--watchdog-min-s``
fill.
"""

from __future__ import annotations

import os
import random
import re
import signal
import statistics
import sys
import threading
import time
import traceback
from collections import deque
from typing import Dict, List, Optional

from ..observability import metrics
from ..observability import timeline
from ..utils.log import logger


class InjectedKill(RuntimeError):
    """The in-process stand-in for a kill fault (``kill_mode="raise"``):
    tests drill the save -> die -> resume loop without paying a
    subprocess per case, while the default mode delivers a real
    ``SIGKILL``."""


#: ``kind@site=trigger[:durations]`` — trigger is a 1-based ordinal
#: (``kill@step=7``) or a seeded probability (``hang@tick=p0.05``);
#: the optional suffix is a duration in seconds (``hang@step=5:30s``)
_FAULT_RE = re.compile(
    r"^(?P<kind>[a-z_]+)@(?P<site>[a-z_]+)="
    r"(?P<trigger>p?\d+(?:\.\d+)?)"
    r"(?::(?P<duration>\d+(?:\.\d+)?)s?)?$")

_KINDS = ("kill", "hang", "corrupt_ckpt", "admit_fail")
_SITES = ("step", "save", "tick", "req")


class _Fault:
    """One parsed fault-spec entry; one-shot once fired."""

    def __init__(self, spec: str):
        m = _FAULT_RE.match(spec.strip())
        if not m:
            raise ValueError(
                f"bad fault spec entry {spec!r}: expected "
                f"kind@site=N[:SECONDSs], e.g. kill@step=7 or "
                f"hang@tick=p0.1:2s")
        self.kind = m.group("kind")
        self.site = m.group("site")
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} in "
                             f"{spec!r}; known: {_KINDS}")
        if self.site not in _SITES:
            raise ValueError(f"unknown fault site {self.site!r} in "
                             f"{spec!r}; known: {_SITES}")
        trig = m.group("trigger")
        self.prob: Optional[float] = None
        self.at: Optional[int] = None
        if trig.startswith("p"):
            self.prob = float(trig[1:])
        else:
            self.at = int(float(trig))
        self.duration = float(m.group("duration") or 30.0)
        self.fired = False
        self.spec = spec.strip()


class FaultInjector:
    """Deterministic fault injection driven by a fault spec
    (comma-separated ``kind@site=trigger[:SECONDSs]`` entries).

    Call sites pass a monotonically increasing 1-based ``count`` per
    site (step number, save ordinal, tick ordinal, submit ordinal);
    ordinal triggers fire when they match, probabilistic triggers
    (``p0.05``) draw from a ``seed``-seeded stream (Python's
    ``random.Random``, as in the JAX package) so a chaos run replays
    bit-identically. ``kill_mode`` is ``"kill"`` (a real ``SIGKILL``)
    or ``"raise"`` (:class:`InjectedKill`). Every fault is one-shot and
    emits a ``fault_injected`` recorder event BEFORE acting — the
    flight record must show the fault even when the action is
    ``SIGKILL``."""

    def __init__(self, spec: str, seed: int = 0, recorder=None,
                 kill_mode: Optional[str] = None):
        self._faults = [_Fault(s) for s in spec.split(",")
                        if s.strip()]
        self._rng = random.Random(seed)
        self._recorder = recorder
        # hang faults wait on this rather than time.sleep so an
        # injected stall stays interruptible (and, on a serving
        # surface, sleeps inside the lock the way a real stalled
        # step would — the watchdog must see the lock held)
        self._hang_cv = threading.Condition()
        self.kill_mode = kill_mode or "kill"
        if self.kill_mode not in ("kill", "raise"):
            raise ValueError(
                f"kill_mode must be 'kill' or 'raise', got "
                f"{self.kill_mode!r}")

    def fire(self, site: str, count: int, **ctx) -> Optional[str]:
        """Evaluate every armed fault at ``site`` for this ``count``;
        acts on a match and returns the fault kind (``admit_fail`` is
        returned for the CALLER to act on — the injector cannot shed a
        request). None when nothing fired."""
        for f in self._faults:
            if f.fired or f.site != site:
                continue
            if f.prob is not None:
                if self._rng.random() >= f.prob:
                    continue
            elif f.at != count:
                continue
            f.fired = True
            logger.error("FAULT INJECTED: %s (site=%s count=%d)",
                         f.spec, site, count)
            if self._recorder is not None:
                self._recorder.emit("fault_injected", kind=f.kind,
                                    site=site, count=count,
                                    spec=f.spec)
            return self._act(f, ctx)
        return None

    def _act(self, f: _Fault, ctx: Dict) -> str:
        if f.kind == "kill":
            if self.kill_mode == "raise":
                raise InjectedKill(f.spec)
            os.kill(os.getpid(), signal.SIGKILL)
        elif f.kind == "hang":
            with self._hang_cv:
                self._hang_cv.wait(timeout=f.duration)
        elif f.kind == "corrupt_ckpt":
            self._corrupt(ctx.get("path"))
        return f.kind

    def _corrupt(self, path: Optional[str]) -> None:
        """Garble the just-written checkpoint at ``path``: wait for
        any in-flight async write (corrupting a half-written dir
        proves nothing — the manifest never commits), then truncate
        one byte off the largest payload file so the committed
        manifest disagrees with the bytes on disk."""
        from . import checkpoint as ckpt
        if path is None or not os.path.isdir(path):
            logger.error("corrupt_ckpt fault: no checkpoint dir in "
                         "context (path=%r); nothing corrupted", path)
            return
        ckpt.wait_for_pending_save()
        victim, size = None, -1
        for root, _dirs, names in os.walk(path):
            for name in names:
                if name == ckpt.MANIFEST_NAME:
                    continue
                full = os.path.join(root, name)
                n = os.path.getsize(full)
                if n > size:
                    victim, size = full, n
        if victim is None:
            logger.error("corrupt_ckpt fault: %s holds no files", path)
            return
        with open(victim, "ab") as fh:
            fh.truncate(max(size - 1, 0))
        logger.error("corrupt_ckpt fault: truncated %s (%d -> %d "
                     "bytes)", victim, size, max(size - 1, 0))


# -- step watchdog ------------------------------------------------------


def dump_all_stacks() -> str:
    """Every live thread's Python stack, formatted — the first thing
    an engineer needs from a hung step and the last thing a stuck
    process can still produce."""
    frames = sys._current_frames()
    lines: List[str] = []
    for t in threading.enumerate():
        frame = frames.get(t.ident)
        if frame is None:
            continue
        lines.append(f'--- thread "{t.name}" (daemon={t.daemon}) ---')
        lines.extend(x.rstrip("\n")
                     for x in traceback.format_stack(frame))
    return "\n".join(lines)


class StepWatchdog:
    """Monitor thread timing armed phases (train steps, decode ticks)
    against an adaptive deadline.

    The loop brackets each unit of work with :meth:`arm` /
    :meth:`disarm`; completed durations feed a trailing window and the
    deadline is ``max(min_interval, factor * trailing median)`` — a
    step 10x slower than its recent peers is a stall, but a cold
    compile before any history only trips the absolute floor. On a
    stall the watchdog dumps all-thread stacks, emits a
    ``watchdog_stall`` event, bumps ``engine/watchdog_stalls`` and —
    under ``action='abort'`` — exits the process with status 134 so an
    external supervisor restarts it instead of holding the card on a
    wedged step. One stall fires at most once per armed phase. The
    defaults are the JAX package's: ``factor`` 10, ``min_interval_s``
    60, ``action`` ``"log"``."""

    def __init__(self, name: str = "train_step",
                 factor: Optional[float] = None,
                 min_interval_s: Optional[float] = None,
                 action: Optional[str] = None,
                 recorder=None, history: int = 32):
        self.name = name
        self.factor = float(factor if factor is not None else 10.0)
        self.min_interval_s = float(
            min_interval_s if min_interval_s is not None else 60.0)
        self.action = (action or "log").strip().lower()
        if self.action not in ("log", "abort"):
            raise ValueError(
                f"watchdog action must be 'log' or 'abort', got "
                f"{self.action!r}")
        self._recorder = recorder
        self._durations: deque = deque(maxlen=history)
        self._lock = threading.Lock()
        self._armed_at: Optional[float] = None
        self._tag: Optional[str] = None
        self._gen = 0            # arm generation, guards stall dedup
        self._stalled_gen = -1   # last generation that already stalled
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stalls = 0
        # swappable in tests; 134 = 128 + SIGABRT, what a supervisor
        # expects from a self-aborted worker
        self._abort_fn = lambda: os._exit(134)

    def deadline_s(self) -> float:
        """Current stall threshold for an armed phase."""
        with self._lock:
            med = statistics.median(self._durations) \
                if self._durations else 0.0
        return max(self.min_interval_s, self.factor * med)

    def arm(self, tag: Optional[str] = None) -> None:
        """Mark the start of one timed phase."""
        with self._lock:
            self._armed_at = time.monotonic()
            self._tag = tag
            self._gen += 1

    def disarm(self) -> None:
        """Mark the phase complete; its duration joins the trailing
        window that sets future deadlines."""
        with self._lock:
            if self._armed_at is not None:
                self._durations.append(
                    time.monotonic() - self._armed_at)
            self._armed_at = None
            self._tag = None

    def start(self) -> None:
        """Spawn the monitor thread (daemon — it must never keep a
        dying process alive)."""
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"watchdog:{self.name}",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop and join the monitor thread."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _run(self) -> None:
        tl = timeline.track(f"watchdog:{self.name}")
        poll = min(1.0, max(0.02, self.min_interval_s / 5.0))
        while True:
            t0 = tl.begin()
            stopped = self._stop.wait(poll)
            tl.add("poll", t0)
            if stopped:
                return
            t0 = tl.begin()
            self._run_once()
            tl.add("check", t0)

    def _run_once(self) -> None:
        """One deadline check (the body of each monitor poll)."""
        with self._lock:
            armed_at, tag, gen = self._armed_at, self._tag, \
                self._gen
            already = gen == self._stalled_gen
        if armed_at is None or already:
            return
        waited = time.monotonic() - armed_at
        deadline = self.deadline_s()
        if waited <= deadline:
            return
        with self._lock:
            if self._gen != gen:   # phase ended while we decided
                return
            self._stalled_gen = gen
        self._on_stall(tag, waited, deadline)

    def _on_stall(self, tag: Optional[str], waited: float,
                  deadline: float) -> None:
        self.stalls += 1
        metrics.inc("engine/watchdog_stalls")
        stacks = dump_all_stacks()
        logger.error(
            "WATCHDOG: %s%s stalled for %.1fs (deadline %.1fs = "
            "max(%.1fs, %.1f x trailing median)); all-thread "
            "stacks:\n%s", self.name,
            f" [{tag}]" if tag else "", waited, deadline,
            self.min_interval_s, self.factor, stacks)
        if self._recorder is not None:
            # tail-bounded: the event stream is line-oriented JSON and
            # a deep stack must not balloon it past usefulness
            self._recorder.emit(
                "watchdog_stall", name=self.name, tag=tag,
                waited_s=round(waited, 3),
                deadline_s=round(deadline, 3),
                action=self.action, stacks=stacks[-8000:])
        if self.action == "abort":
            logger.error("WATCHDOG: aborting (action=abort)")
            self._abort_fn()
