"""Multi-tenant LoRA adapter trees and the serving-side bank cache (the
port of the JAX package's ``core/adapters.py``).

The model holds every resident adapter in stacked per-site banks: the
``lora_a [A, K, r]`` / ``lora_b [A, r, N]`` parameters of each layer's
``models/gpt/model.py::LoRADelta``. Bank row 0 is the reserved zero
adapter; rows ``1 .. A-1`` are cache capacity the server fills and
evicts at run time.

- **Adapter trees**, the canonical single-adapter format of both
  packages: ``{"<site>/<leaf>": [num_layers, ...]}`` over the eight
  ``(site, leaf)`` pairs (``qkv_proj_lora`` / ``out_proj_lora`` /
  ``linear1_lora`` / ``linear2_lora`` x ``lora_a`` / ``lora_b``), each
  stacked over layers. :func:`extract_adapter` reads one bank row of a
  model into that format and :func:`insert_adapter` writes one in,
  so an adapter the JAX package extracted (from either of its layouts)
  drops into the port's bank and back. ``core/checkpoint.py`` persists
  the format as the JAX package does.
- :class:`AdapterCache`: host bookkeeping from adapter id to bank row
  with refcounts, as the page allocator keeps pages: a row is pinned
  while any slot serves its adapter and only refcount-0 residents are
  evicted, least recently released first; a miss loads the tree from
  the ``source`` before it claims a row. The cache owns no device
  state: the server inserts the tree a lease reports. Counted
  ``serving/adapter_{hits,misses,evictions}`` with the
  ``serving/adapters_resident`` gauge.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import (
    Any, Callable, Dict, Mapping, NamedTuple, Optional,
)

import numpy as np
import torch

from ..models.gpt.model import LoRADelta
from ..observability import metrics

#: leaf names a LoRA site module owns
LORA_LEAVES = ("lora_a", "lora_b")


def _banks(model: torch.nn.Module) -> Dict[str, Dict[int, torch.Tensor]]:
    """``{"site/leaf": {layer: bank [A, ...]}}`` of every
    :class:`LoRADelta` of ``model``."""
    out: Dict[str, Dict[int, torch.Tensor]] = {}
    for name, mod in model.named_modules():
        if not isinstance(mod, LoRADelta):
            continue
        parts = name.split(".")
        layer = next((int(parts[i + 1]) for i in range(len(parts) - 1)
                      if parts[i] == "decoder"), 0)
        for leaf in LORA_LEAVES:
            out.setdefault(f"{parts[-1]}/{leaf}", {})[layer] = \
                getattr(mod, leaf)
    if not out:
        raise ValueError("the model holds no LoRA banks (lora_rank is off?)")
    return out


@torch.no_grad()
def extract_adapter(model: torch.nn.Module, row: int
                    ) -> Dict[str, torch.Tensor]:
    """Bank row ``row`` of ``model`` as a canonical adapter tree:
    ``{"site/leaf": [num_layers, ...]}``, copies stacked over layers.

    Raises:
        ValueError: the model holds no LoRA banks, or ``row`` is out of
            range.
    """
    tree = {}
    for key, layers in _banks(model).items():
        first = next(iter(layers.values()))
        if not 0 <= row < first.shape[0]:
            raise ValueError(f"adapter row {row} out of range for bank "
                             f"{key} with {first.shape[0]} rows")
        tree[key] = torch.stack([layers[i][row] for i in sorted(layers)])
    return tree


@torch.no_grad()
def insert_adapter(model: torch.nn.Module, tree: Mapping[str, Any],
                   row: int) -> None:
    """Write a canonical adapter tree into bank row ``row`` of ``model``,
    in place, each value cast to its bank's dtype and device.

    All or nothing: every bank must find its key and every key its
    bank, with every shape matching, before anything is written (a
    partial insert would serve a chimera adapter).

    Raises:
        ValueError: a key is missing or matches no bank, a shape does
            not fit, ``row`` is out of range, or the model holds no
            LoRA banks.
    """
    banks = _banks(model)
    for key in banks:
        if key not in tree:
            raise ValueError(f"adapter tree missing {key}")
    extra = set(tree) - set(banks)
    if extra:
        raise ValueError(f"adapter tree keys matched no bank: "
                         f"{sorted(extra)}")
    writes = []
    for key, layers in banks.items():
        val = tree[key]
        val = val if torch.is_tensor(val) else torch.tensor(np.asarray(val))
        first = next(iter(layers.values()))
        if not 0 <= row < first.shape[0]:
            raise ValueError(f"adapter row {row} out of range for bank "
                             f"{key} with {first.shape[0]} rows")
        if tuple(val.shape) != (len(layers),) + tuple(first.shape[1:]):
            raise ValueError(f"adapter {key} shape {tuple(val.shape)} does "
                             f"not fit {len(layers)} layers of bank "
                             f"{tuple(first.shape)}")
        writes += [(layers[i], val[j]) for j, i in enumerate(sorted(layers))]
    # The writes go on the current stream, behind every kernel already
    # queued there, so a row being rewritten is read by earlier ticks in
    # its old state and by later ones in its new state, never torn. The
    # server inserts outside any autograd graph, recompute region or
    # autocast context, so no saved tensor or cached cast of a bank
    # outlives the write.
    for bank, val in writes:
        bank[row].copy_(val.to(device=bank.device, dtype=bank.dtype))


class AdapterCacheFull(RuntimeError):
    """Every bank row is pinned by a live slot: admission waits for a
    release (the queue-head blocking rule of page starvation)."""


class AdapterLease(NamedTuple):
    """Result of :meth:`AdapterCache.acquire`. ``tree`` is not None on a
    miss: the caller inserts it into row ``row`` before serving.
    ``evicted`` names the refcount-0 resident whose row was reclaimed,
    if any."""

    row: int
    tree: Optional[Dict[str, Any]]
    evicted: Optional[Any]


class AdapterCache:
    """Adapter id -> bank row with refcounts and LRU eviction.

    ``num_rows`` is the bank's adapter axis (``lora_num_adapters``);
    ``num_rows - 1`` rows are usable (row 0 is the zero adapter).
    ``source`` maps an adapter id to its canonical tree, as a Mapping or
    a callable; an unknown id raises ``KeyError``. Host bookkeeping
    behind its own lock.

    Invariants (:meth:`check`): a row is never reassigned while its
    adapter's refcount is above 0; eviction takes only the least
    recently released refcount-0 resident; ``acquire`` with no free and
    no evictable row raises :class:`AdapterCacheFull` and changes
    nothing.
    """

    def __init__(self, num_rows: int,
                 source: Callable[[Any], Mapping[str, Any]]):
        if num_rows < 2:
            raise ValueError(
                f"num_rows must be >= 2 (row 0 is the reserved zero "
                f"adapter), got {num_rows}")
        self._lock = threading.Lock()
        self._free = list(range(num_rows - 1, 0, -1))   # pop() -> row 1
        self._source = source
        self._rows: Dict[Any, int] = {}        # adapter id -> row
        self._refs: Dict[Any, int] = {}        # adapter id -> pins
        #: refcount-0 residents, least recently released first
        self._lru: "OrderedDict[Any, None]" = OrderedDict()
        self.stats = {"adapter_hits": 0, "adapter_misses": 0,
                      "adapter_evictions": 0}

    @property
    def resident(self) -> int:
        """Adapters holding a bank row."""
        with self._lock:
            return len(self._rows)

    @property
    def capacity(self) -> int:
        """Usable bank rows (free and resident)."""
        with self._lock:
            return len(self._free) + len(self._rows)

    def resident_ids(self):
        """The ids of the resident adapters."""
        with self._lock:
            return list(self._rows)

    def is_resident(self, adapter_id) -> bool:
        """Whether ``adapter_id`` holds a bank row."""
        with self._lock:
            return adapter_id in self._rows

    def refcount(self, adapter_id) -> int:
        """The pins on ``adapter_id`` (0 when not resident)."""
        with self._lock:
            return self._refs.get(adapter_id, 0)

    def can_admit(self, adapter_id) -> bool:
        """Whether :meth:`acquire` would find a row now (the source may
        still refuse the id)."""
        with self._lock:
            return adapter_id in self._rows or bool(self._free) or \
                bool(self._lru)

    def _load(self, adapter_id) -> Mapping[str, Any]:
        if callable(self._source):
            return self._source(adapter_id)
        return self._source[adapter_id]

    def acquire(self, adapter_id) -> AdapterLease:
        """Pin ``adapter_id`` to a bank row. A hit bumps the refcount. A
        miss loads the tree from the source first (an unknown id evicts
        no one), then claims a free row or evicts the least recently
        released refcount-0 resident.

        Raises:
            AdapterCacheFull: every row is pinned.
            KeyError: the source does not know ``adapter_id``.
        """
        with self._lock:
            if adapter_id in self._rows:
                self._refs[adapter_id] += 1
                self._lru.pop(adapter_id, None)
                self.stats["adapter_hits"] += 1
                metrics.inc("serving/adapter_hits")
                self._gauge()
                return AdapterLease(self._rows[adapter_id], None, None)
            if not self._free and not self._lru:
                raise AdapterCacheFull(
                    f"all {len(self._rows)} adapter rows pinned by live "
                    f"slots")
            tree = self._load(adapter_id)
            evicted = None
            if self._free:
                row = self._free.pop()
            else:
                evicted, _ = self._lru.popitem(last=False)
                row = self._rows.pop(evicted)
                del self._refs[evicted]
                self.stats["adapter_evictions"] += 1
                metrics.inc("serving/adapter_evictions")
            self._rows[adapter_id] = row
            self._refs[adapter_id] = 1
            self.stats["adapter_misses"] += 1
            metrics.inc("serving/adapter_misses")
            self._gauge()
            return AdapterLease(row, dict(tree), evicted)

    def release(self, adapter_id) -> None:
        """Drop one pin. At refcount 0 the adapter stays resident (a
        later request for it is a hit) and becomes evictable.

        Raises:
            KeyError: ``adapter_id`` is not resident.
            AssertionError: its refcount is already 0.
        """
        with self._lock:
            refs = self._refs.get(adapter_id)
            if refs is None:
                raise KeyError(f"release of non-resident adapter "
                               f"{adapter_id!r}")
            if refs < 1:
                raise AssertionError(
                    f"adapter {adapter_id!r} refcount underflow")
            self._refs[adapter_id] = refs - 1
            if refs == 1:
                self._lru[adapter_id] = None
            self._gauge()

    def check(self) -> None:
        """Assert the invariants (a test hook)."""
        with self._lock:
            assert set(self._lru) <= set(self._rows)
            assert set(self._refs) == set(self._rows)
            for aid, refs in self._refs.items():
                assert refs >= 0
                assert (refs == 0) == (aid in self._lru), \
                    f"{aid!r}: refs={refs}, lru={aid in self._lru}"
            rows = list(self._rows.values()) + self._free
            assert len(rows) == len(set(rows)), "row leaked or double-used"
            assert 0 not in rows, "reserved row 0 entered circulation"

    def _gauge(self) -> None:
        metrics.get_registry().set_gauge("serving/adapters_resident",
                                         len(self._rows))

