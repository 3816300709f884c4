"""Paged KV-cache bookkeeping: the host side of the serving cache (the
port of the JAX package's ``core/paging.py``, device tier only).

The physical KV store of a paged server is one global pool of
fixed-size pages per layer (``[kv_pool_pages, heads, kv_page_size,
head_dim]`` in the port's layout, on the card), and each slot reaches
its tokens through a ``page_table [slots, max_pages]`` int32
indirection that the paged decode kernels walk
(``ops/cuda/flash_attention.py::flash_decode_paged``) and the dense
path resolves with a gather (``gather_kv_pages``).

Everything here is host-side and cheap: which physical page holds which
logical page of which request, reference counts for pages shared
between requests, and two content-addressed registries that make the
sharing happen:

- the **prefix registry** keys each FULL page of a prompt by the chain
  hash of every token up to and including that page, so two requests
  with the same prefix map the same physical pages and prefill the
  shared region once;
- the **prompt registry** keys a whole finished prefill (pages + the
  final-token logits), so an identical prompt admits with zero
  prefill, and the forks share even the partial last page until their
  first divergent decode write splits it copy-on-write (the server
  checks ``refcount > 1`` before every write and copies the page
  first).

Page 0 is reserved as the null page: empty ``page_table`` entries
point at it, so an inactive slot's dead decode writes land in a
dedicated garbage page instead of corrupting live data.

The JAX package's second tier (pinned-host spill / rehydrate,
``host_pages``) is not ported; ids, refcounts and registry answers are
otherwise the JAX allocator's on the same trace.

Invariants (asserted by :meth:`PageAllocator.check`): ``free + in_use
== num_pages - 1``; every refcount is positive; every registered page
is live; releasing a page to refcount 0 returns it to the free list and
drops every registry entry that mentions it.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: the reserved garbage page every empty page_table entry points at
NULL_PAGE = 0


def page_prefix_keys(tokens: Sequence[int], page_size: int) -> List[str]:
    """Chain-hash key per FULL page of ``tokens``: key ``j`` digests
    every token in pages ``0..j``, so equal keys mean equal prompt
    prefixes (KV at position ``i`` depends only on tokens ``<= i``
    under causal attention)."""
    h = hashlib.sha1()
    out: List[str] = []
    for j in range(len(tokens) // page_size):
        chunk = np.asarray(
            tokens[j * page_size:(j + 1) * page_size], np.int64)
        h.update(chunk.tobytes())
        out.append(h.hexdigest())
    return out


def prompt_key(tokens: Sequence[int]) -> str:
    """Content key for a WHOLE prompt (length-tagged so a prefix never
    collides with its extension)."""
    h = hashlib.sha1(np.asarray(tokens, np.int64).tobytes())
    return f"L{len(tokens)}:{h.hexdigest()}"


class PagePoolExhausted(RuntimeError):
    """Raised by :meth:`PageAllocator.alloc` when no free page exists;
    the server preempts a slot and retries."""


class PageAllocator:
    """Refcounted allocator over ``num_pages`` physical KV pages.

    Pure host bookkeeping: device traffic (pool writes, copy-on-write
    page copies, page-table uploads) stays with the caller
    (``core/serving.py``), which consults this object between decode
    ticks. Page 0 (:data:`NULL_PAGE`) is reserved and never allocated.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is the reserved null "
                f"page), got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        # LIFO free list, low page ids first (deterministic traces)
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._ref: Dict[int, int] = {}
        #: chain-hash key -> physical page (full prompt pages only)
        self._prefix: Dict[str, int] = {}
        #: whole-prompt key -> (pages tuple, opaque payload: the server
        #: stores the final-token logits row here)
        self._prompt: Dict[str, Tuple[Tuple[int, ...], object]] = {}
        #: reverse maps so releasing a page drops its registry entries
        self._page_prefix_keys: Dict[int, str] = {}
        self._page_prompt_keys: Dict[int, set] = {}
        self.stats = {"allocs": 0, "frees": 0, "prefix_hits": 0,
                      "prompt_hits": 0, "cow_splits": 0}

    # -- pool accounting ----------------------------------------------

    @property
    def free_pages(self) -> int:
        """Pages available for allocation right now."""
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        """Live (refcount > 0) pages, null page excluded."""
        return self.num_pages - 1 - len(self._free)

    def refcount(self, pid: int) -> int:
        """Current reference count of ``pid`` (0 when free)."""
        return self._ref.get(pid, 0)

    def alloc(self) -> int:
        """Take a free page at refcount 1."""
        if not self._free:
            raise PagePoolExhausted(
                f"page pool exhausted ({self.num_pages - 1} usable "
                f"pages, all referenced)")
        pid = self._free.pop()
        self._ref[pid] = 1
        self.stats["allocs"] += 1
        return pid

    def try_alloc(self) -> Optional[int]:
        """Like :meth:`alloc`, but None instead of raising on an
        empty pool."""
        try:
            return self.alloc()
        except PagePoolExhausted:
            return None

    def retain(self, pid: int) -> int:
        """Add a reference to a live page; returns the new refcount."""
        if self._ref.get(pid, 0) < 1:
            raise ValueError(f"retain of free/unknown page {pid}")
        self._ref[pid] += 1
        return self._ref[pid]

    def release(self, pid: int) -> bool:
        """Drop one reference; at zero the page returns to the free
        list and every registry entry naming it is dropped. Returns
        True when the page was actually freed."""
        if self._ref.get(pid, 0) < 1:
            raise ValueError(f"release of free/unknown page {pid}")
        self._ref[pid] -= 1
        if self._ref[pid]:
            return False
        del self._ref[pid]
        self._drop_registrations(pid)
        self._free.append(pid)
        self.stats["frees"] += 1
        return True

    def _drop_registrations(self, pid: int) -> None:
        """Remove every registry entry naming ``pid``: its prefix key,
        and every whole-prompt entry it belongs to (with that entry's
        reverse-map mentions on the other member pages)."""
        key = self._page_prefix_keys.pop(pid, None)
        if key is not None:
            self._prefix.pop(key, None)
        for pk in self._page_prompt_keys.pop(pid, set()):
            entry = self._prompt.pop(pk, None)
            if entry is None:
                continue
            for other in entry[0]:
                if other == pid:
                    continue
                keys = self._page_prompt_keys.get(other)
                if keys is not None:
                    keys.discard(pk)
                    if not keys:
                        del self._page_prompt_keys[other]

    # -- content-addressed sharing ------------------------------------

    def lookup_prefix(self, key: str) -> Optional[int]:
        """Physical page holding this full-page prefix, or None."""
        return self._prefix.get(key)

    def register_prefix(self, key: str, pid: int) -> None:
        """Publish a full prompt page for prefix sharing. First writer
        wins: an already-registered key keeps its page (both copies
        hold identical KV)."""
        if self._ref.get(pid, 0) < 1:
            raise ValueError(f"register_prefix of free page {pid}")
        if key not in self._prefix:
            self._prefix[key] = pid
            self._page_prefix_keys[pid] = key

    def lookup_prompt(self, key: str):
        """``(pages, payload)`` of an identical finished prefill, or
        None. The caller must :meth:`retain` every page it maps."""
        return self._prompt.get(key)

    def register_prompt(self, key: str, pages: Sequence[int],
                        payload) -> None:
        """Publish a whole finished prefill (its page list plus an
        opaque payload, the final-token logits) so an identical prompt
        can admit with zero prefill compute."""
        pages = tuple(int(p) for p in pages)
        for pid in pages:
            if self._ref.get(pid, 0) < 1:
                raise ValueError(
                    f"register_prompt names free page {pid}")
        if key in self._prompt:
            return
        self._prompt[key] = (pages, payload)
        for pid in pages:
            self._page_prompt_keys.setdefault(pid, set()).add(key)

    def page_registered(self, pid: int) -> bool:
        """True when any registry entry (prefix or prompt) names
        ``pid``."""
        return pid in self._page_prefix_keys or \
            pid in self._page_prompt_keys

    # -- invariants ----------------------------------------------------

    def check(self) -> None:
        """Assert the allocator invariants (test hook)."""
        assert NULL_PAGE not in self._ref and NULL_PAGE not in self._free
        assert len(self._free) + len(self._ref) == self.num_pages - 1
        assert not (set(self._free) & set(self._ref))
        assert all(c > 0 for c in self._ref.values())
        assert all(0 < p < self.num_pages
                   for p in list(self._free) + list(self._ref))
        for key, pid in self._prefix.items():
            assert self._ref.get(pid, 0) > 0, (key, pid)
            assert self._page_prefix_keys.get(pid) == key
        for key, (pages, _) in self._prompt.items():
            for pid in pages:
                assert self._ref.get(pid, 0) > 0, (key, pid)
                assert key in self._page_prompt_keys.get(pid, set())
        # an empty prompt-key set would make page_registered() lie
        assert all(self._page_prompt_keys.values())
        for pid, keys in self._page_prompt_keys.items():
            for key in keys:
                assert key in self._prompt, (pid, key)


# -- pool sizing -------------------------------------------------------

def kv_page_bytes(num_heads: int, head_dim: int, page_size: int,
                  kv_cache_dtype: str = "bf16") -> int:
    """Device bytes ONE K or V page costs per layer: ``bf16``, 2 bytes
    per element; ``int8``, 1 byte per element plus one fp32 scale per
    (head, position) (the int8 cache, sized as the JAX package sizes
    it)."""
    if kv_cache_dtype == "int8":
        per_token = num_heads * (head_dim + 4)
    elif kv_cache_dtype == "bf16":
        per_token = num_heads * head_dim * 2
    else:
        raise ValueError(
            f"unknown kv_cache_dtype {kv_cache_dtype!r} "
            f"(expected 'bf16' or 'int8')")
    return per_token * page_size


def pool_bytes(num_layers: int, num_heads: int, head_dim: int,
               page_size: int, num_pages: int,
               kv_cache_dtype: str = "bf16") -> int:
    """Total device bytes of a ``num_pages`` KV pool (K and V, all
    layers)."""
    return 2 * num_layers * num_pages * kv_page_bytes(
        num_heads, head_dim, page_size, kv_cache_dtype)


def pool_pages_for_bytes(budget_bytes: int, num_layers: int,
                         num_heads: int, head_dim: int,
                         page_size: int,
                         kv_cache_dtype: str = "bf16") -> int:
    """Largest pool (in pages) fitting ``budget_bytes``: the inverse of
    :func:`pool_bytes`."""
    per_page = 2 * num_layers * kv_page_bytes(
        num_heads, head_dim, page_size, kv_cache_dtype)
    return int(budget_bytes) // max(per_page, 1)
