"""One captured CUDA graph of a serving loop's tick, replayed up to T
times per host round trip (the counterpart of the JAX package's
``jax.jit`` of ``decode_loop`` / ``verify_loop``).

A :class:`TickGraph` wraps a zero-argument tick (the server's closure
over ``models/gpt/generation.py::loop_tick``, whose every input and
output is a device buffer written in place). On the card the first
:meth:`TickGraph.replay` runs one eager warm-up tick (``warm``, a tick
the loop masks, so the slot state stays as it was), which builds and
loads every kernel, then captures one tick into a
``torch.cuda.CUDAGraph``; every replay after it launches that graph,
with no Python between the ticks of a round trip. A failed capture
raises: nothing falls back to eager ticks. On the CPU the same tick
runs eagerly, ``n`` times.

The kernels' launch counts (each wrapper's counts, registered in
``ops/cuda/launch_counts.py``) and the registry's counters fire in
Python, once a call. A replay runs no Python, so the graph records what
one captured tick added to them and adds it once per replay; the warm-up
tick counts (its kernels did launch), the capture does not (it launched
nothing). ``replays`` and ``warmups`` count the ticks launched each way.
That the replays launched those kernels is checked by a device trace,
not by these counts: ``chip_smoke.py`` holds every hand-written
kernel's events in a profiled round trip against them.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..observability import metrics
from ..ops.cuda import launch_counts

#: ``(kernel counts, registry counters)``
Counts = Tuple[launch_counts.Counts, Dict[str, float]]


def _counts() -> Counts:
    """Every wrapper's launch counts and every registry counter now."""
    return (launch_counts.snapshot(),
            dict(metrics.get_registry().snapshot()["counters"]))


def _delta(after: Counts, before: Counts) -> Counts:
    """What moved from ``before`` to ``after``."""
    moved = {name: n - before[1].get(name, 0)
             for name, n in after[1].items() if n != before[1].get(name, 0)}
    return launch_counts.delta(after[0], before[0]), moved


def _add(moved: Counts, times: int) -> None:
    """Add ``times`` x ``moved`` to the wrappers' counts and the
    registry's counters."""
    launch_counts.add(moved[0], times)
    for name, n in moved[1].items():
        metrics.inc(name, n * times)


class TickGraph:
    """A loop tick, captured once and replayed (CUDA), or run eagerly
    (CPU).

    Args:
        tick: one loop iteration on device buffers alone.
        warm: an eager tick that leaves the state as it was (the loop's
            masked iteration), run once before the capture.
        device: where the buffers live.
    """

    def __init__(self, tick: Callable[[], None], warm: Callable[[], None],
                 device: torch.device):
        self._tick = tick
        self._warm = warm
        self._cuda = torch.device(device).type == "cuda"
        self._graph = None
        self._delta: Counts = ({}, {})
        #: ticks launched by a replay (CUDA) or an eager call (CPU)
        self.replays = 0
        #: eager warm-up ticks run before a capture
        self.warmups = 0

    @property
    def captured(self) -> bool:
        """Whether the next :meth:`replay` replays a captured graph (on
        the CPU, always: nothing is captured there)."""
        return self._graph is not None or not self._cuda

    def replay(self, n: int) -> None:
        """Launch ``n`` ticks back to back, with no read of the device
        between them."""
        if not self._cuda:
            for _ in range(n):
                self._tick()
            self.replays += n
            return
        if self._graph is None:
            self._capture()
        for _ in range(n):
            self._graph.replay()
        _add(self._delta, n)
        self.replays += n

    def _capture(self) -> None:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._warm()
        torch.cuda.current_stream().wait_stream(side)
        self.warmups += 1
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._tick()
        self._delta = _delta(_counts(), before)
        # the capture launched nothing: take its counts back
        _add(self._delta, -1)
        self._graph = graph
