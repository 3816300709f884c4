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

The second tier: constructed with ``host_pages > 0`` the allocator
also tracks a bounded pinned-host pool occupying the id range
``num_pages .. num_pages + host_pages - 1``. A registered page whose
refcount drops to its last reference can be **spilled** (its registry
entries move onto a host id and the device page frees), and a later
registry hit **promotes** it back onto a freshly allocated device page
(the server scatters the saved bytes first). Both registries span the
tiers: a lookup may return a host id, which the caller detects with
:meth:`PageAllocator.is_host`. Host ids are never mapped in a page
table, so a divergent write can only target a device page and a
copy-on-write split leaves the host copy untouched. The bytes live with
the server (one pinned slab, ``core/serving.py``); the allocator only
hands out ids and residency generations. Ids, refcounts, stats and
registry answers are the JAX allocator's on the same trace.

Invariants (asserted by :meth:`PageAllocator.check`): ``free + in_use
== num_pages - 1``; every refcount is positive; every registered page
is live or host-resident; releasing a page to refcount 0 returns it to
the free list and drops every registry entry that mentions it; no id
is at once free, live and host-resident; every host-resident page
carries at least one registration (orphans are evicted eagerly).
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
    under causal attention — the PagedAttention sharing argument)."""
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

    Pure host bookkeeping — device traffic (pool writes, COW page
    copies, page-table uploads, spill gathers, rehydrate scatters)
    stays with the caller (``core/serving.py``), which consults this
    object between decode ticks. Page 0 (:data:`NULL_PAGE`) is
    reserved and never allocated.

    With ``host_pages > 0`` a second id range (``num_pages ..
    num_pages + host_pages - 1``) models the pinned-host spill tier:
    :meth:`spill` moves a dying page's registrations onto a host id,
    :meth:`promote` moves them back onto a fresh HBM id on a registry
    hit, and a full host tier evicts its least-recently-spilled
    resident to make room. The allocator never touches the page BYTES
    — the caller keeps the host copies and drains
    :meth:`pop_host_evicted` after every mutating call so its byte
    store tracks this bookkeeping exactly.
    """

    def __init__(self, num_pages: int, page_size: int,
                 host_pages: int = 0):
        if num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is the reserved null "
                f"page), got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if host_pages < 0:
            raise ValueError(
                f"host_pages must be >= 0, got {host_pages}")
        self.num_pages = num_pages
        self.page_size = page_size
        self.host_pages = host_pages
        # LIFO free list, low page ids first (deterministic traces)
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._ref: Dict[int, int] = {}
        #: chain-hash key -> physical page (full prompt pages only)
        self._prefix: Dict[str, int] = {}
        #: whole-prompt key -> (pages tuple, opaque payload — the
        #: server stores the final-token logits row here)
        self._prompt: Dict[str, Tuple[Tuple[int, ...], object]] = {}
        #: reverse maps so releasing a page drops its registry entries
        self._page_prefix_keys: Dict[int, str] = {}
        self._page_prompt_keys: Dict[int, set] = {}
        # -- host tier (ids >= num_pages) --
        self._host_free: List[int] = list(
            range(num_pages + host_pages - 1, num_pages - 1, -1))
        #: resident host id -> monotone spill sequence (LRU order)
        self._hosted: Dict[int, int] = {}
        self._host_seq = 0
        #: host ids the allocator evicted since the caller last drained
        #: them (the caller drops its byte copies for these)
        self._host_evicted: List[int] = []
        self.stats = {"allocs": 0, "frees": 0, "prefix_hits": 0,
                      "prompt_hits": 0, "cow_splits": 0, "spills": 0,
                      "rehydrates": 0, "host_evictions": 0}

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

    def alloc_many(self, n: int) -> List[int]:
        """Take ``n`` free pages at refcount 1 in one call (a batched
        rehydrate scatters all its destination pages at once).
        All-or-nothing: an exhausted pool raises before any page is
        taken."""
        if n > len(self._free):
            raise PagePoolExhausted(
                f"page pool exhausted ({len(self._free)} free of "
                f"{self.num_pages - 1} usable, {n} requested)")
        return [self.alloc() for _ in range(n)]

    def retain(self, pid: int) -> int:
        """Add a reference to a live page; returns the new refcount."""
        if self._ref.get(pid, 0) < 1:
            raise ValueError(f"retain of free/unknown page {pid}")
        self._ref[pid] += 1
        return self._ref[pid]

    def retain_many(self, pids: Sequence[int]) -> None:
        """Pin a whole page set in one call. All-or-nothing: validates
        every id before taking the first reference, so a bad id never
        leaves a partially pinned set."""
        for pid in pids:
            if self._ref.get(pid, 0) < 1:
                raise ValueError(f"retain of free/unknown page {pid}")
        for pid in pids:
            self._ref[pid] += 1

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
        """Remove every registry entry naming ``pid`` — the single
        teardown shared by every way a page leaves a tier: an HBM page
        freeing to the pool (:meth:`release`) and a host-resident page
        evicted to make room. Dropping a prompt entry can strand a
        hosted co-member with no surviving registration; such orphans
        are unreachable by any lookup, so they are evicted here too
        (recorded in :meth:`pop_host_evicted` for the byte store)."""
        key = self._page_prefix_keys.pop(pid, None)
        if key is not None:
            self._prefix.pop(key, None)
        affected = set()
        for pk in self._page_prompt_keys.pop(pid, set()):
            entry = self._prompt.pop(pk, None)
            if entry is not None:
                for other in entry[0]:
                    if other != pid:
                        keys = self._page_prompt_keys.get(other)
                        if keys is not None:
                            keys.discard(pk)
                            if not keys:
                                # an empty reverse-map set would make
                                # page_registered() lie True
                                del self._page_prompt_keys[other]
                            affected.add(other)
        for other in affected:
            if other in self._hosted and not self.page_registered(other):
                self._evict_host(other)

    # -- content-addressed sharing ------------------------------------

    def lookup_prefix(self, key: str) -> Optional[int]:
        """Physical page holding this full-page prefix, or None."""
        return self._prefix.get(key)

    def register_prefix(self, key: str, pid: int) -> None:
        """Publish a full prompt page for prefix sharing. First writer
        wins — an already-registered key keeps its page (both copies
        hold identical KV, deduping them after the fact is not worth
        the device copy). Host-resident pages may be (re)registered —
        the restart warm-start import path does exactly that."""
        if self._ref.get(pid, 0) < 1 and pid not in self._hosted:
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
        opaque payload — the server stores the final-token logits) so
        an identical prompt can admit with zero prefill compute.
        Members may live in either tier (live HBM or host-resident)."""
        pages = tuple(int(p) for p in pages)
        for pid in pages:
            if self._ref.get(pid, 0) < 1 and pid not in self._hosted:
                raise ValueError(
                    f"register_prompt names free page {pid}")
        if key in self._prompt:
            return
        self._prompt[key] = (pages, payload)
        for pid in pages:
            self._page_prompt_keys.setdefault(pid, set()).add(key)

    # -- host spill tier ----------------------------------------------

    @property
    def host_pages_resident(self) -> int:
        """Host-tier pages currently holding spilled KV."""
        return len(self._hosted)

    def is_host(self, pid: int) -> bool:
        """True when ``pid`` is a resident host-tier id (a registry
        lookup returned a spilled page the caller must rehydrate)."""
        return pid in self._hosted

    def page_registered(self, pid: int) -> bool:
        """True when any registry entry (prefix or prompt) names
        ``pid`` — the spill-eligibility gate: an unregistered page can
        never be found again, so spilling it would be pure leak."""
        return pid in self._page_prefix_keys or \
            pid in self._page_prompt_keys

    def spill(self, pid: int) -> Optional[int]:
        """Move a refcount-1 page's registrations onto a fresh host id
        and free the HBM page — the bookkeeping half of a spill; the
        caller gathers the page's KV (before calling this) and stages
        it to host memory under the returned id. A full host tier
        evicts its least-recently-spilled resident first. Returns None
        — page NOT freed, caller falls back to a plain release — when
        no host tier exists or ``pid`` carries no registration."""
        if self._ref.get(pid, 0) != 1:
            raise ValueError(
                f"spill of page {pid} with refcount "
                f"{self._ref.get(pid, 0)} != 1")
        if not self.host_pages or not self.page_registered(pid):
            return None
        hpid = self._host_alloc()
        if not self.page_registered(pid):
            # the LRU eviction inside _host_alloc cascaded through a
            # prompt entry this page co-membered with the victim and
            # took its last registration — nothing left to keep warm
            del self._hosted[hpid]
            self._host_free.append(hpid)
            return None
        self._move_registrations(pid, hpid)
        del self._ref[pid]
        self._free.append(pid)
        self.stats["frees"] += 1
        self.stats["spills"] += 1
        return hpid

    def promote(self, hpid: int, pid: int) -> None:
        """Move a host-resident page's registrations onto live HBM
        page ``pid`` and free the host slot — the bookkeeping half of
        rehydration; the caller allocates ``pid`` (its refcount-1
        reference belongs to the admitting request) and scatters the
        saved bytes into it BEFORE calling this."""
        if hpid not in self._hosted:
            raise ValueError(f"promote of non-resident host id {hpid}")
        if self._ref.get(pid, 0) < 1:
            raise ValueError(f"promote onto free page {pid}")
        self._move_registrations(hpid, pid)
        del self._hosted[hpid]
        self._host_free.append(hpid)
        self.stats["rehydrates"] += 1

    def host_import(self) -> Optional[int]:
        """A fresh resident host id with NO eviction — the restart
        warm-start import fills free host slots and stops; evicting
        this replica's own spills to adopt another's would be a wash.
        The caller registers content keys against the returned id."""
        if not self._host_free:
            return None
        hpid = self._host_free.pop()
        self._host_seq += 1
        self._hosted[hpid] = self._host_seq
        return hpid

    def host_generation(self, hpid: int) -> Optional[int]:
        """Monotone residency generation of a host id (its spill
        sequence), or None when not resident. A recycled id gets a
        NEW generation, so the byte-store owner can tell staged bytes
        of an evicted earlier residency from the live one's — the ids
        alone are ambiguous the moment the LRU recycles them."""
        return self._hosted.get(hpid)

    def evict_host(self, hpid: int) -> None:
        """Evict one resident host page by id — the caller lost its
        byte copy (e.g. the spill stage failed on the writer thread),
        so the registrations pointing at it must die before a lookup
        hands out a page that can never rehydrate. The id shows up in
        :meth:`pop_host_evicted` like any other eviction; a
        non-resident id is a no-op (it may already have been LRU'd)."""
        if hpid in self._hosted:
            self._evict_host(hpid)

    def pop_host_evicted(self) -> List[int]:
        """Host ids this allocator evicted (LRU pressure, orphan
        sweep) since the last call — returned once so the caller can
        drop its byte copies before the ids are reused."""
        out, self._host_evicted = self._host_evicted, []
        return out

    def sweep_host_orphans(self) -> None:
        """Evict every host-resident page with no surviving
        registration (partial-import leftovers); the evicted ids show
        up in :meth:`pop_host_evicted` like any other eviction."""
        for hpid in [h for h in self._hosted
                     if not self.page_registered(h)]:
            self._evict_host(hpid)

    def host_snapshot(self):
        """``(prefixes, prompts)`` restricted to the host tier —
        prefix key -> host id, prompt key -> (ids list, payload) for
        entries whose EVERY member is host-resident (a mixed entry
        pins live HBM pages a restart cannot carry). This is the
        registry half of the restart-persistent prefix store."""
        prefixes = {k: p for k, p in self._prefix.items()
                    if p in self._hosted}
        prompts = {k: (list(pages), payload)
                   for k, (pages, payload) in self._prompt.items()
                   if all(p in self._hosted for p in pages)}
        return prefixes, prompts

    def _host_alloc(self) -> int:
        """A resident host id, evicting the least-recently-spilled
        page (registrations dropped, id recycled) when the tier is
        full — the boundedness contract of ``host_pool_bytes``."""
        if not self._host_free:
            victim = min(self._hosted, key=self._hosted.get)
            self._evict_host(victim)
        hpid = self._host_free.pop()
        self._host_seq += 1
        self._hosted[hpid] = self._host_seq
        return hpid

    def _evict_host(self, hpid: int) -> None:
        """Drop a resident host page: registrations die, the slot
        frees, and the id is queued for :meth:`pop_host_evicted`."""
        del self._hosted[hpid]
        self._drop_registrations(hpid)
        self._host_free.append(hpid)
        self._host_evicted.append(hpid)
        self.stats["host_evictions"] += 1

    def _move_registrations(self, src: int, dst: int) -> None:
        """Re-point every registry entry from ``src`` to ``dst`` —
        the cross-tier move both :meth:`spill` and :meth:`promote`
        reduce to. ``dst`` must carry no registrations of its own
        (always true: spill targets a fresh host id, promote a fresh
        HBM page)."""
        key = self._page_prefix_keys.pop(src, None)
        if key is not None:
            self._prefix[key] = dst
            self._page_prefix_keys[dst] = key
        pks = self._page_prompt_keys.pop(src, set())
        if pks:
            self._page_prompt_keys.setdefault(dst, set()).update(pks)
            for pk in pks:
                pages, payload = self._prompt[pk]
                self._prompt[pk] = (tuple(
                    dst if p == src else p for p in pages), payload)

    # -- invariants ----------------------------------------------------

    def check(self) -> None:
        """Assert the allocator invariants (test hook)."""
        assert NULL_PAGE not in self._ref and NULL_PAGE not in self._free
        assert len(self._free) + len(self._ref) == self.num_pages - 1
        assert not (set(self._free) & set(self._ref))
        assert all(c > 0 for c in self._ref.values())
        # cross-tier partition: HBM ids below num_pages, host ids at or
        # above it, and no id is simultaneously free, live, and
        # host-resident — the three states are mutually exclusive
        host_ids = set(self._host_free) | set(self._hosted)
        assert not (set(self._free) | set(self._ref)) & host_ids
        assert not set(self._host_free) & set(self._hosted)
        assert len(self._host_free) + len(self._hosted) == \
            self.host_pages
        assert all(h >= self.num_pages for h in host_ids)
        assert all(p < self.num_pages
                   for p in list(self._free) + list(self._ref))
        # every host-resident page is reachable through a registry
        for hpid in self._hosted:
            assert self.page_registered(hpid), hpid
        for key, pid in self._prefix.items():
            assert self._ref.get(pid, 0) > 0 or pid in self._hosted, \
                (key, pid)
            assert self._page_prefix_keys.get(pid) == key
        for key, (pages, _) in self._prompt.items():
            for pid in pages:
                assert self._ref.get(pid, 0) > 0 or \
                    pid in self._hosted, (key, pid)
                assert key in self._page_prompt_keys.get(pid, set())
        # the reverse maps never hold dead weight: an empty prompt-key
        # set would make page_registered() (the spill gate) lie True
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
