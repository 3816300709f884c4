"""Launch counts of the hand-written kernels' wrappers.

Each wrapper counts its launches in plain attributes of its own function
object (``launches``, by route in ``launches_by_route``, ...), one where
it launches its kernel. :func:`register` gives a wrapper those
attributes, zeroed, and records them, so that :func:`snapshot` and
:func:`add` reach every wrapper's counts with no list kept elsewhere. A
CUDA graph replays a captured tick without running Python, so
``core/decode_graph.py`` adds the captured tick's counts once a replay
through them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

#: (wrapper, its int count attributes, its per-route tables' keys)
_REGISTRY: List[Tuple[Callable, Tuple[str, ...],
                      Dict[str, Tuple[str, ...]]]] = []

#: ``(wrapper index, attribute, route or None)`` -> launches
Counts = Dict[Tuple[int, str, Optional[str]], int]


def register(fn: Callable, counts: Sequence[str] = ("launches",),
             tables: Optional[Mapping[str, Sequence[str]]] = None
             ) -> Callable:
    """Give ``fn`` an int attribute per name in ``counts`` and a dict
    ``{route: 0}`` per entry of ``tables`` (attribute -> routes), all
    zero, and record them for :func:`snapshot` and :func:`add`."""
    tables = {attr: tuple(keys) for attr, keys in (tables or {}).items()}
    for attr in counts:
        setattr(fn, attr, 0)
    for attr, keys in tables.items():
        setattr(fn, attr, dict.fromkeys(keys, 0))
    _REGISTRY.append((fn, tuple(counts), tables))
    return fn


def snapshot() -> Counts:
    """Every registered wrapper's counts now."""
    out: Counts = {}
    for i, (fn, counts, tables) in enumerate(_REGISTRY):
        for attr in counts:
            out[(i, attr, None)] = getattr(fn, attr)
        for attr in tables:
            for route, n in getattr(fn, attr).items():
                out[(i, attr, route)] = n
    return out


def delta(after: Counts, before: Counts) -> Counts:
    """The counts that moved from ``before`` to ``after``, by how much."""
    return {key: n - before.get(key, 0) for key, n in after.items()
            if n != before.get(key, 0)}


def add(moved: Counts, times: int) -> None:
    """Add ``times`` x ``moved`` (a :func:`delta`) to the wrappers'
    counts."""
    for (i, attr, route), n in moved.items():
        fn = _REGISTRY[i][0]
        if route is None:
            setattr(fn, attr, getattr(fn, attr) + n * times)
        else:
            table = getattr(fn, attr)
            table[route] = table.get(route, 0) + n * times
