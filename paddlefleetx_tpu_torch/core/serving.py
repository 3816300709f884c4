"""Continuous-batching generation server (the port of the JAX package's
``core/serving.py::GenerationServer``).

A persistent KV store lives on the card; the host owns a request queue,
admits requests into free slots, ticks every active slot forward per
:meth:`GenerationServer.step` and evicts finished slots between ticks,
so new requests ride in as soon as a slot frees. Greedy completions
equal the lockstep ``generate()`` rows, whatever the slot count,
admission order, prompt-length mix, paging or speculation.

Contiguous mode (the default): one ``[slots, heads, capacity,
head_dim]`` cache, each admission one bucketed prefill
(``prefill_into_slots``: powers of two from 16 up to the longest
admissible prompt), each tick the ragged decode kernel.

Paged mode (``page_size`` / ``pool_pages``, or a config with
``kv_page_size`` / ``kv_pool_pages``): the KV store is one global pool
of fixed-size pages reached through a slot -> page table
(``core/paging.py``), as in the JAX package:

- **density**: a slot holds only the pages its tokens fill; when the
  pool runs dry the youngest other slot is preempted back to the queue
  head (its tokens and sampling stream kept) and resumes token-exactly;
- **prefix sharing**: full prompt pages are content-addressed (chain
  hash), so requests sharing a prefix prefill it once and map the same
  physical pages; an identical prompt admits with zero prefill through
  the whole-prompt registry. Shared pages split copy-on-write at the
  first divergent write;
- **chunked prefill**: admissions run as page-aligned chunks, at most
  one per ``step()``, between decode ticks (``prefill_chunk_paged``).
  The decode tick is the paged decode kernel.

Speculative decoding (``GenerationConfig.spec_method`` /
``spec_tokens``): the tick drafts ``k`` tokens per slot from a host
draft source (``core/spec.py``, n-gram self-speculation), scores the
``[slots, k+1]`` window in ONE forward through the verify kernel
(``verify_step``, contiguous or paged) and commits each slot's accepted
prefix, 1..k+1 tokens; pages wholly past a slot's accepted point go
straight back to the pool. Greedy speculative output is token-exact
against the plain server.

Device-resident decode (``device_loop_ticks=T``, the JAX package's):
with T > 1 every :meth:`GenerationServer.step` launches up to T ticks
of one loop (``decode_loop`` / ``verify_loop``'s :func:`loop_tick`)
and reads the device once: on the card a CUDA graph of one tick,
captured at the first round trip and replayed ``n`` times
(``core/decode_graph.py``), on the CPU the same tick eagerly. ``n`` is
1 while the host has scheduling work (a queued request, a chunked
prefill, or a page pool that cannot cover the T-tick window), else
``min(T, the least remaining budget)``; on the device a tick after a
slot finishes or spends its budget commits nothing, so the loop stops
where the JAX package's ``lax.while_loop`` stops. The host then replays
the per-tick buffers (tokens, interpolated TTFT, spec counts) so the
telemetry stays tick-accurate. Any T commits the tokens of T = 1. Paged
servers pre-map the whole T-tick write window before the launch and
hand the pages past the committed point back after it.

Telemetry: the ``serving/admitted``, ``serving/evicted``,
``serving/preempted``, ``serving/prefix_hits``, ``serving/cow_splits``,
``serving/prefill_chunks``, ``serving/decode_tokens`` (committed
tokens, not ticks), ``serving/spec_drafted`` and
``serving/spec_accepted`` counters, ``serving/device_ticks`` and
``serving/loop_exit/{finished,budget,admission}`` (one a round trip
of the loop), the ``serving/slot_occupancy``,
``serving/pages_in_use`` and ``serving/spec_accept_rate`` gauges and
the ``serving/decode_tick`` timer (one timing a round trip) in the
process-global registry (the JAX package's names,
``docs/inference.md``), and a :meth:`GenerationServer.summary` with
decode tokens/s and TTFT, tick and host round-trip percentiles.

Multi-tenant LoRA (``adapter_source``, a model with ``lora_rank > 0``):
each request names an adapter (``submit(..., adapter_id=)``, 0 the base
model). Admission pins the adapter to a bank row through an
:class:`~.adapters.AdapterCache` (loading it into the model's banks on a
miss, evicting the least recently released unpinned adapter when the
bank is full) and blocks the queue head while every row is pinned;
completion and preemption release the pin. Every forward takes the
per-slot bank rows (``adapter_ids``), uploaded only when they change,
and runs the grouped LoRA delta (``ops/lora.py``). An unknown adapter
fails only its own request (``finish_reason="adapter_missing"``).
Adapter requests neither consult nor seed the prefix and prompt
registries: an adapter changes every layer's KV for the same tokens.
Counted ``serving/adapter_{hits,misses,evictions}`` with the
``serving/adapters_resident`` gauge; the JAX package's
``serving_adapter_load`` / ``serving_adapter_evict`` events belong to
its event recorder, which is not ported.

MoE models (``moe_num_experts > 0``) serve in every mode above. Each
forward routes each batch row as its own group, whose expert capacity
comes from the forward's sequence length, as in the JAX package: a
contiguous admission routes its prompt at its bucket's length, a paged
one chunk by chunk (a preempted request's re-prefill is a new group), a
decode tick one token a slot, a verify tick the slot's window. So an
MoE model's rows may differ between modes (they do in the JAX package),
while slot count and admission order leave them unchanged.

Not ported yet (asking for them raises ``NotImplementedError``): the
host KV tier (``host_pool_bytes``), deadlines, queue shedding, SIGTERM
drain,
fault injection, KV export / import, the prefix store and the event
trace.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.gpt.generation import (
    LOOP_EXIT_BUDGET, LOOP_EXIT_FINISHED, GenerationConfig, activate_slot,
    copy_kv_pages, decode_step, init_loop_carry, init_page_pool,
    init_slot_cache, init_slot_state, loop_tick, prefill_chunk_paged,
    prefill_into_slots, read_loop, release_slot, reset_loop_carry,
    verify_step,
)
from ..models.gpt.model import GPTForPretraining
from ..observability import metrics
from ..utils.log import logger
from .adapters import AdapterCache, insert_adapter
from .decode_graph import TickGraph
from .paging import (
    NULL_PAGE, PageAllocator, PagePoolExhausted, page_prefix_keys,
    pool_bytes, prompt_key,
)
from .spec import make_draft_source


def default_prefill_buckets(max_prompt_len: int) -> Tuple[int, ...]:
    """Powers of two from 16 up to ``max_prompt_len``, which is always
    included."""
    out = []
    b = 16
    while b < max_prompt_len:
        out.append(b)
        b *= 2
    out.append(max_prompt_len)
    return tuple(out)


@dataclass
class Completion:
    """One finished request as returned by :meth:`GenerationServer.step`."""

    request_id: int
    prompt: List[int]
    #: emitted tokens in order, EOS included when hit
    tokens: List[int]
    #: "eos" | "length" (hit max_dec_len) | "adapter_missing" (an
    #: unknown adapter id, failed at admission)
    finish_reason: str
    #: time to first token in ms
    ttft_ms: Optional[float] = None


class GenerationServer:
    """Host-side queue / admit / evict loop around the slot primitives.

    Args:
        model (GPTForPretraining): the port's model, on the device the
            server runs on.
        gen_cfg (GenerationConfig): sampling or greedy_search; with
            ``spec_method`` the ticks are speculative.
        num_slots (int): concurrent requests.
        prefill_buckets (Sequence[int]): prompt-length buckets of the
            contiguous mode (default :func:`default_prefill_buckets`).
        seed (int): sampling seed; request ``r`` draws its step ``t``
            with ``stream_seed(seed, nonce_r, t)``.
        page_size (int): tokens per KV page; with ``pool_pages`` (or the
            config's ``kv_page_size``) it turns paged mode on.
        pool_pages (int): physical pages in the pool, null page
            included (default: the contiguous footprint, every slot at
            full capacity, plus the null page).
        prefill_chunk_pages (int): pages per chunked-prefill step.
        prefix_sharing (bool): share prompt pages through the prefix
            and whole-prompt registries.
        device_loop_ticks (int): ticks per host round trip (T): T > 1
            runs the device-resident loop, a captured CUDA graph of the
            tick on the card.
        adapter_source: adapter id -> canonical LoRA adapter tree
            (``core/adapters.py``), a Mapping or a callable that raises
            ``KeyError`` for an unknown id; needs a model with
            ``lora_rank > 0``. None serves the base model only.
    """

    def __init__(self, model: GPTForPretraining, gen_cfg: GenerationConfig,
                 num_slots: int = 4,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 seed: int = 0, page_size: Optional[int] = None,
                 pool_pages: Optional[int] = None,
                 prefill_chunk_pages: int = 2, prefix_sharing: bool = True,
                 device_loop_ticks: int = 1, adapter_source=None,
                 **unported):
        if unported:
            raise NotImplementedError(
                f"GenerationServer options not ported to the PyTorch "
                f"package yet: {sorted(unported)} (the host KV tier, "
                f"deadlines, shedding, drain, fault injection and KV "
                f"export are later slices)")
        if device_loop_ticks < 1:
            raise ValueError(f"device_loop_ticks must be >= 1, got "
                             f"{device_loop_ticks}")
        if gen_cfg.decode_strategy == "beam_search":
            raise ValueError("GenerationServer serves sampling/"
                             "greedy_search; beam search stays on the "
                             "lockstep path")
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        cfg = model.config
        self.paged = bool(page_size or pool_pages or cfg.kv_page_size)
        if self.paged:
            page_size = int(page_size or cfg.kv_page_size)
            if not pool_pages:
                # the contiguous layout's footprint + the null page: the
                # same memory behind the paged indirection
                pool_pages = cfg.kv_pool_pages or (
                    num_slots * (cfg.cache_capacity // max(page_size, 1))
                    + 1)
            # validated as GPTConfig validates the YAML knobs
            cfg = dataclasses.replace(cfg, kv_page_size=page_size,
                                      kv_pool_pages=int(pool_pages))
            if prefill_chunk_pages < 1:
                raise ValueError(f"prefill_chunk_pages must be >= 1, got "
                                 f"{prefill_chunk_pages}")
            if cfg.max_kv_pages % prefill_chunk_pages:
                raise ValueError(
                    f"prefill_chunk_pages ({prefill_chunk_pages}) must "
                    f"divide max_kv_pages ({cfg.max_kv_pages}) so a "
                    f"padded prefill never outgrows the page table")
            self._page = cfg.kv_page_size
            self._max_pages = cfg.max_kv_pages
            self._chunk = self._page * prefill_chunk_pages
            if self._chunk > cfg.max_position_embeddings:
                raise ValueError(
                    f"prefill chunk ({self._chunk} tokens) exceeds "
                    f"max_position_embeddings "
                    f"{cfg.max_position_embeddings}")
            self._prefix_sharing = bool(prefix_sharing)
            self._alloc = PageAllocator(cfg.kv_pool_pages, self._page)
            self._pt = np.full((num_slots, self._max_pages), NULL_PAGE,
                               np.int32)
            # device views written in place: a captured tick reads them
            self._pt_dev = torch.full((num_slots, self._max_pages),
                                      NULL_PAGE, dtype=torch.int32,
                                      device=model.word_embeddings.device)
            self._pt_dev_dec = torch.full_like(self._pt_dev, NULL_PAGE)
            self._pt_dirty = True
            self._prefilling: deque = deque()
            self._admit_seq = 0
            self._prefill_chunk_count = 0
        self.config = cfg
        self.model = model
        self.gen_cfg = gen_cfg
        self.num_slots = num_slots
        self.seed = int(seed)
        self._loop_ticks = int(device_loop_ticks)
        self._loop = None     # (LoopCarry, TickGraph), built on first use
        self.spec = gen_cfg.spec_method is not None
        self._spec_k = gen_cfg.spec_tokens
        self._draft = make_draft_source(gen_cfg.spec_method) \
            if self.spec else None
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._max_prompt = cfg.max_position_embeddings - gen_cfg.max_dec_len
        if self._max_prompt < 1:
            raise ValueError(
                f"max_dec_len ({gen_cfg.max_dec_len}) leaves no room for "
                f"prompts under max_position_embeddings "
                f"{cfg.max_position_embeddings}")
        buckets = tuple(sorted(set(
            prefill_buckets or default_prefill_buckets(self._max_prompt))))
        if buckets[-1] < self._max_prompt:
            buckets = buckets + (self._max_prompt,)
        self._buckets = buckets
        self._device = model.word_embeddings.device
        self._cache = init_page_pool(model, cfg) if self.paged else \
            init_slot_cache(model, num_slots)
        self._state = init_slot_state(num_slots, cfg.vocab_size,
                                      self._device)
        self._queue: deque = deque()
        self._slots: List[Optional[dict]] = [None] * num_slots
        self._next_id = 0
        self._nonce = 0
        self._counts = {"admitted": 0, "evicted": 0, "preempted": 0}
        # each slot's bank row (0: the base model), uploaded for the
        # ticks only when it changed
        self._adapters: Optional[AdapterCache] = None
        if adapter_source is not None:
            if not cfg.lora_rank:
                raise ValueError("adapter_source requires a LoRA model "
                                 "(lora_rank > 0)")
            self._adapters = AdapterCache(cfg.lora_num_adapters,
                                          adapter_source)
            self._aid_np = np.zeros((num_slots,), np.int32)
            self._aid_dev = torch.as_tensor(self._aid_np,
                                            device=self._device)
            self._aid_dirty = False
        #: requests failed at admission (an unknown adapter id), returned
        #: by the next step()
        self._dead: List[Completion] = []
        self._ticks = 0
        self._roundtrips = 0
        self._decode_tokens = 0
        self._tick_time = 0.0
        self._ttft_ms: List[float] = []
        self._tick_ms: List[float] = []
        self._roundtrip_ms: List[float] = []
        if self.paged:
            logger.info(
                "GenerationServer (paged): %d slots, %d-page pool of "
                "%d-token pages (capacity %d = %d pages/slot max), "
                "prefill chunk %d tokens, prefix sharing %s, spec %s, "
                "%d ticks a round trip on %s", num_slots, cfg.kv_pool_pages,
                self._page, cfg.cache_capacity, self._max_pages, self._chunk,
                self._prefix_sharing, gen_cfg.spec_method, self._loop_ticks,
                self._device)
        else:
            logger.info("GenerationServer: %d slots, prefill buckets %s, "
                        "capacity %d, spec %s, %d ticks a round trip on %s",
                        num_slots, list(buckets), cfg.cache_capacity,
                        gen_cfg.spec_method, self._loop_ticks, self._device)

    @property
    def occupancy(self) -> int:
        """Number of slots currently holding a live request."""
        return sum(s is not None for s in self._slots)

    @property
    def pending(self) -> int:
        """Number of submitted requests still waiting for a slot."""
        return len(self._queue)

    def check_alloc(self) -> None:
        """Assert the page allocator's invariants (paged mode)."""
        if self.paged:
            self._alloc.check()

    @property
    def has_adapters(self) -> bool:
        """Whether this server serves non-zero adapter ids at all (LoRA
        banks and an adapter source)."""
        return self._adapters is not None

    def adapter_affinity(self, adapter_id: int) -> int:
        """A router's score: 1 when ``adapter_id`` is resident in this
        server's bank (its admission is a hit), else 0; base requests
        (id 0) and base-only servers score 0."""
        if not adapter_id or self._adapters is None:
            return 0
        return int(self._adapters.is_resident(adapter_id))

    def submit(self, prompt: Sequence[int],
               nonce: Optional[int] = None, adapter_id: int = 0) -> int:
        """Queue a request and return its id.

        Raises ``ValueError`` for an empty prompt, one that can never
        fit (``prompt + max_dec_len > max_position_embeddings``), a
        negative ``adapter_id`` or a non-zero one on a server without an
        ``adapter_source``. ``nonce`` overrides the server's per-request
        sampling-stream counter (submission order by default).
        ``adapter_id`` serves the request through that LoRA adapter (0:
        the base model); admission pins its bank row until the request
        leaves the card.
        """
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) > self._max_prompt:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_dec_len "
                f"({self.gen_cfg.max_dec_len}) exceeds "
                f"max_position_embeddings "
                f"{self.model.config.max_position_embeddings}")
        adapter_id = int(adapter_id)
        if adapter_id < 0:
            raise ValueError(f"adapter_id must be >= 0, got {adapter_id}")
        if adapter_id and self._adapters is None:
            raise ValueError("adapter_id requires an adapter_source (this "
                             "server serves the base model only)")
        if nonce is None:
            nonce = self._nonce
            self._nonce += 1
        rid = self._next_id
        self._next_id += 1
        self._queue.append({"id": rid, "prompt": prompt, "tokens": [],
                            "nonce": int(nonce), "adapter_id": adapter_id,
                            "submit_t": time.perf_counter()})
        return rid

    def _bucket_for(self, n: int) -> int:
        return next(b for b in self._buckets if b >= n)

    # -- the adapter cache -------------------------------------------
    #
    # The host maps each slot to the bank row of its request's adapter
    # (_aid_np, row 0 the base model); the rows ride down with every
    # forward as an int32 tensor. A request whose adapter cannot claim a
    # row yet blocks the queue head, as page starvation does.

    def _adapter_admissible(self, req: dict) -> bool:
        aid = req["adapter_id"]
        return not aid or self._adapters.can_admit(aid)

    def _set_row(self, slot: int, row: int) -> None:
        if self._aid_np[slot] != row:
            self._aid_np[slot] = row
            self._aid_dirty = True

    def _claim(self, req: dict, slot: int) -> bool:
        """Pop the queue head ``req`` and point ``slot`` at its adapter's
        bank row (row 0 for a base request), pinning the adapter and
        inserting it into the model's banks on a miss. False for an
        unknown adapter: the request completes as ``adapter_missing``
        with its tokens so far, and the queue moves on."""
        self._queue.popleft()
        if self._adapters is None:
            return True
        row = 0
        if req["adapter_id"]:
            try:
                lease = self._adapters.acquire(req["adapter_id"])
            except KeyError:
                self._counts["evicted"] += 1
                metrics.inc("serving/evicted")
                self._dead.append(Completion(
                    request_id=req["id"], prompt=req["prompt"],
                    tokens=req["tokens"], finish_reason="adapter_missing",
                    ttft_ms=req.get("ttft_ms")))
                return False
            if lease.tree is not None:
                insert_adapter(self.model, lease.tree, lease.row)
            row = lease.row
        self._set_row(slot, row)
        return True

    def _release_adapter(self, slot: int, req: dict) -> None:
        """Unpin a departing request's adapter (it stays resident and
        evictable) and park the slot on the zero row."""
        if self._adapters is None:
            return
        if req["adapter_id"]:
            self._adapters.release(req["adapter_id"])
        self._set_row(slot, 0)

    def _rows_arg(self, slot: int) -> Optional[torch.Tensor]:
        """One admission's ``[1]`` bank-row tensor, None on a base-only
        server (no LoRA compute at all)."""
        if self._adapters is None:
            return None
        return torch.as_tensor(self._aid_np[slot:slot + 1],
                               device=self._device)

    def _aid_arg(self) -> Optional[torch.Tensor]:
        """The ticks' ``[slots]`` bank rows, written in place when they
        changed (a captured tick reads this buffer); None on a base-only
        server."""
        if self._adapters is None:
            return None
        if self._aid_dirty:
            self._aid_dev.copy_(torch.from_numpy(self._aid_np))
            self._aid_dirty = False
        return self._aid_dev

    def _admit(self) -> None:
        """Move queued requests into free slots: one prefill each
        (contiguous), or the paged admission."""
        if self.paged:
            self._admit_paged()
            return
        while self._queue and None in self._slots:
            req = self._queue[0]
            if not self._adapter_admissible(req):
                break
            slot = self._slots.index(None)
            if not self._claim(req, slot):
                continue
            seq = req["prompt"]
            bucket = self._bucket_for(len(seq))
            row = np.full((1, bucket), self.gen_cfg.pad_token_id, np.int64)
            row[0, :len(seq)] = seq
            prefill_into_slots(self.model, self._cache, self._state, [slot],
                               torch.as_tensor(row, device=self._device),
                               [len(seq)], [req["nonce"]],
                               self._rows_arg(slot))
            self._slots[slot] = req
            self._counts["admitted"] += 1
            metrics.inc("serving/admitted")

    # -- paged scheduling ---------------------------------------------
    #
    # The host owns every paging decision: the numpy page-table master
    # and the PageAllocator's refcounts live here, and the device sees
    # the tables uploaded as int32 tensors. Two device views exist: the
    # full one (a prefill chunk reads the shared / owned pages of a
    # still-inactive slot) and the decode one, where every non-active
    # slot's row is null, so an inactive slot's dead decode write lands
    # in the garbage page instead of a page another request is still
    # prefilling or sharing.

    def _sync_pt(self) -> None:
        if not self._pt_dirty:
            return
        act = np.zeros((self.num_slots, 1), bool)
        for s, r in enumerate(self._slots):
            if r is not None and r.get("active"):
                act[s, 0] = True
        # one upload of both views, written in place
        both = np.stack([self._pt, np.where(act, self._pt, NULL_PAGE)])
        both = torch.from_numpy(both.astype(np.int32)).to(self._device)
        self._pt_dev.copy_(both[0])
        self._pt_dev_dec.copy_(both[1])
        self._pt_dirty = False

    def _place(self, req: dict, slot: int, num_pages: int) -> None:
        """Common bookkeeping of both paged admission paths."""
        req["num_pages"] = num_pages
        req["active"] = False
        req["admit_seq"] = self._admit_seq
        self._admit_seq += 1
        self._slots[slot] = req
        self._counts["admitted"] += 1
        metrics.inc("serving/admitted")

    def _activate(self, slot: int, last_logits_row: torch.Tensor) -> None:
        """Flip a placed slot live from the host's view of the request
        (seq = prompt + already emitted tokens, so a preempted request
        re-enters mid-request)."""
        req = self._slots[slot]
        seq = req["prompt"] + req["tokens"]
        appeared = np.zeros((self.config.vocab_size,), bool)
        appeared[np.asarray(seq, np.int64)] = True
        activate_slot(self._state, slot, len(seq), len(req["tokens"]),
                      req["nonce"],
                      torch.as_tensor(appeared, device=self._device),
                      last_logits_row, req.pop("spec_rejected", -1))
        req["active"] = True
        req["cur_len"] = len(seq)
        self._pt_dirty = True   # the decode view must unhide this row

    def _admit_paged(self) -> None:
        """Paged admission: a whole-prompt registry hit shares every
        page and activates with zero prefill; otherwise map shared
        prefix pages plus fresh owned pages and queue the slot for
        chunked prefill. The queue HEAD blocks while the pool cannot
        cover its owned pages: admitting smaller later requests over it
        would starve long prompts; so does an adapter with no free bank
        row. Adapter requests neither share nor register pages: the
        registries hold base-model KV."""
        while self._queue and None in self._slots:
            req = self._queue[0]
            if not self._adapter_admissible(req):
                break
            seq = req["prompt"] + req["tokens"]
            L = len(seq)
            slot = self._slots.index(None)
            share = self._prefix_sharing and not req["adapter_id"]
            hit = self._alloc.lookup_prompt(prompt_key(seq)) \
                if share else None
            if hit is not None:
                pages, last = hit
                if not self._claim(req, slot):
                    continue
                for pid in pages:
                    self._alloc.retain(pid)
                self._pt[slot, :] = NULL_PAGE
                self._pt[slot, :len(pages)] = pages
                self._pt_dirty = True
                self._alloc.stats["prompt_hits"] += 1
                metrics.inc("serving/prefix_hits")
                self._place(req, slot, num_pages=len(pages))
                self._activate(slot, last)
                continue
            shared: List[int] = []
            if share:
                # share only FULL pages strictly before the one holding
                # the last prompt token: that page recomputes locally
                # so the first sampling logits exist
                for key in page_prefix_keys(
                        seq, self._page)[:(L - 1) // self._page]:
                    pid = self._alloc.lookup_prefix(key)
                    if pid is None:
                        break
                    shared.append(pid)
                # chunked prefill resumes at a CHUNK boundary: keep a
                # chunk-aligned count of shared pages, or the rounded
                # tail below could outgrow the page table
                cpp = self._chunk // self._page
                del shared[len(shared) - len(shared) % cpp:]
            start = len(shared) * self._page
            n_chunks = -(-(L - start) // self._chunk)
            total_pages = (start + n_chunks * self._chunk) // self._page
            if self._alloc.free_pages < total_pages - len(shared):
                break
            if not self._claim(req, slot):
                continue
            self._pt[slot, :] = NULL_PAGE
            for j, pid in enumerate(shared):
                self._alloc.retain(pid)
                self._pt[slot, j] = pid
            for j in range(len(shared), total_pages):
                self._pt[slot, j] = self._alloc.alloc()
            self._pt_dirty = True
            if shared:
                self._alloc.stats["prefix_hits"] += len(shared)
                metrics.inc("serving/prefix_hits", len(shared))
            self._place(req, slot, num_pages=total_pages)
            req["prefill_pos"] = start
            self._prefilling.append(slot)

    def _prefill_pump(self) -> None:
        """Run at most ONE page-aligned prefill chunk per step: the
        oldest prefilling slot advances while every other slot's decode
        tick proceeds, so a long admission never stalls the rest."""
        if not self._prefilling:
            return
        slot = self._prefilling[0]
        req = self._slots[slot]
        seq = req["prompt"] + req["tokens"]
        L = len(seq)
        c0 = req["prefill_pos"]
        row = np.full((1, self._chunk), self.gen_cfg.pad_token_id, np.int64)
        piece = seq[c0:c0 + self._chunk]
        row[0, :len(piece)] = piece
        self._sync_pt()
        # the last prompt token sits at chunk row L - 1 - c0 of the
        # final chunk; other chunks' logits are not used
        logits = prefill_chunk_paged(
            self.model, self._cache, torch.as_tensor(row,
                                                     device=self._device),
            [c0], self._pt_dev[slot:slot + 1],
            logit_rows=[min(L - 1 - c0, self._chunk - 1)],
            adapter_ids=self._rows_arg(slot))
        req["prefill_pos"] = c0 + self._chunk
        self._prefill_chunk_count += 1
        metrics.inc("serving/prefill_chunks")
        if req["prefill_pos"] < L:
            return
        self._prefilling.popleft()
        del req["prefill_pos"]
        # the chunk-rounded admission also mapped the final chunk's pad
        # tail; that KV is never read, so its pages go straight back
        self._trim_pages(slot, -(-L // self._page))
        last = logits[0]
        self._activate(slot, last)
        if self._prefix_sharing and not req["adapter_id"]:
            for j, key in enumerate(page_prefix_keys(seq, self._page)):
                self._alloc.register_prefix(key, int(self._pt[slot, j]))
            self._alloc.register_prompt(
                prompt_key(seq),
                [int(p) for p in self._pt[slot, :req["num_pages"]]], last)

    def _trim_pages(self, slot: int, keep: int) -> None:
        """Release the slot's mapped pages past its first ``keep``
        (``keep = 0``: all of them) and null their table entries."""
        req = self._slots[slot]
        mapped = req.get("num_pages", 0)
        if keep >= mapped:
            return
        for j in range(keep, mapped):
            pid = int(self._pt[slot, j])
            if pid != NULL_PAGE:
                self._alloc.release(pid)
            self._pt[slot, j] = NULL_PAGE
        req["num_pages"] = keep
        self._pt_dirty = True

    def _alloc_or_preempt(self, needy_slot: int) -> int:
        """A free page, preempting the youngest OTHER occupied slot
        (whole request back to the queue head, pages released) until
        one exists. The config guarantees a lone slot can always grow
        to its maximum length, so this terminates."""
        pid = self._alloc.try_alloc()
        while pid is None:
            victims = [s for s, r in enumerate(self._slots)
                       if r is not None and s != needy_slot]
            if not victims:
                raise PagePoolExhausted(
                    f"slot {needy_slot} needs a page with none free and "
                    f"no one to preempt (pool {self._alloc.num_pages} "
                    f"pages)")
            victim = max(victims, key=lambda s: self._slots[s]["admit_seq"])
            self._preempt_slot(victim)
            pid = self._alloc.try_alloc()
        return pid

    def _preempt_slot(self, victim: int) -> None:
        """Take a request off the card to reclaim its pages, keeping its
        host state (emitted tokens, nonce): re-admission prefills
        prompt + tokens and resumes the sampling stream at the kept
        ``dec_count``, token for token as if never preempted."""
        req = self._slots[victim]
        if req.get("active") and self.spec:
            # a pending rejection residual must survive the round trip
            req["spec_rejected"] = int(self._state.host.rejected[victim])
        self._trim_pages(victim, 0)
        # the pin drops, the adapter stays resident: re-admission re-pins
        # it and resumes token for token
        self._release_adapter(victim, req)
        if victim in self._prefilling:
            self._prefilling.remove(victim)
        self._slots[victim] = None
        release_slot(self._state, victim)
        req["active"] = False
        req.pop("prefill_pos", None)
        self._queue.appendleft(req)
        self._counts["preempted"] += 1
        metrics.inc("serving/preempted")

    def _page_maintenance(self, window: int = 1) -> None:
        """Before every tick: each active slot's next ``window`` write
        positions (``cur_len .. cur_len + window - 1``: one for a plain
        tick, k+1 for a verify tick) must land in pages it owns alone:
        map fresh pages at page boundaries and split shared pages
        copy-on-write (a device page copy and a refcount handoff) at the
        first divergent write. Pages mapped for positions past a verify
        tick's accepted point go back after the tick (:meth:`step`)."""
        for slot in range(self.num_slots):
            req = self._slots[slot]
            if req is None or not req.get("active"):
                continue
            for w in range(window):
                pos = req["cur_len"] + w
                if pos >= self.config.cache_capacity:
                    # a verify window's tail past the capacity clips to
                    # the last column and is never committed
                    break
                j = pos // self._page
                if j >= req["num_pages"]:
                    self._pt[slot, j] = self._alloc_or_preempt(slot)
                    req["num_pages"] = j + 1
                    self._pt_dirty = True
                else:
                    pid = int(self._pt[slot, j])
                    if self._alloc.refcount(pid) > 1:
                        new = self._alloc_or_preempt(slot)
                        copy_kv_pages(self._cache, [pid], [new])
                        self._alloc.release(pid)
                        self._pt[slot, j] = new
                        self._pt_dirty = True
                        self._alloc.stats["cow_splits"] += 1
                        metrics.inc("serving/cow_splits")

    def _evict(self, slot: int, reason: str) -> Completion:
        req = self._slots[slot]
        if self.paged:
            self._trim_pages(slot, 0)
            if slot in self._prefilling:
                self._prefilling.remove(slot)
        self._release_adapter(slot, req)
        self._slots[slot] = None
        release_slot(self._state, slot)
        self._counts["evicted"] += 1
        metrics.inc("serving/evicted")
        return Completion(request_id=req["id"], prompt=req["prompt"],
                          tokens=req["tokens"], finish_reason=reason,
                          ttft_ms=req.get("ttft_ms"))

    def _tick(self, live: List[int]) -> Tuple[List[List[int]], List[int]]:
        """One decode or verify tick over every slot: ``(window,
        counts)``, slot ``s`` committing ``window[s][:counts[s]]``."""
        pt = None
        if self.spec:
            # host drafts ride down with the tick; inactive rows are
            # zeros the verify never commits
            k = self._spec_k
            drafts = [[0] * k for _ in range(self.num_slots)]
            for slot in live:
                req = self._slots[slot]
                drafts[slot] = self._draft.propose(
                    req["prompt"] + req["tokens"], k)
            if self.paged:
                # growth / COW decisions cover the whole k+1 window
                self._page_maintenance(window=k + 1)
                self._sync_pt()
                pt = self._pt_dev_dec
            return verify_step(self.model, self._cache, self._state,
                               drafts, self.gen_cfg, self.seed, pt,
                               self._aid_arg())
        if self.paged:
            self._page_maintenance()
            self._sync_pt()
            pt = self._pt_dev_dec
        tokens = decode_step(self.model, self._cache, self._state,
                             self.gen_cfg, self.seed, pt, self._aid_arg())
        return [[t] for t in tokens], [1] * self.num_slots

    def step(self) -> List[Completion]:
        """Admit what fits, advance at most one prefill chunk (paged),
        tick every ACTIVE slot (one token plain, 1..k+1 committed tokens
        speculative; with ``device_loop_ticks > 1`` up to that many
        ticks in one round trip, :meth:`_step_loop`), then evict and
        return whatever finished (with any request that failed
        admission)."""
        step_t0 = time.perf_counter()
        self._admit()
        reg = metrics.get_registry()
        if self.paged:
            self._prefill_pump()
            reg.set_gauge("serving/pages_in_use", self._alloc.pages_in_use)
        live = [s for s, r in enumerate(self._slots)
                if r is not None and (not self.paged or r.get("active"))]
        dead, self._dead = self._dead, []
        if not live:
            reg.set_gauge("serving/slot_occupancy", self.occupancy)
            return dead
        if self._loop_ticks > 1:
            done = self._step_loop(live)
        else:
            done = self._step_one(live)
        reg.set_gauge("serving/slot_occupancy", self.occupancy)
        # one round trip's whole host cost: admission, drafting, the
        # launch, the read back and the replay of its ticks
        self._roundtrips += 1
        self._roundtrip_ms.append((time.perf_counter() - step_t0) * 1e3)
        return dead + done

    def _step_one(self, live: List[int]) -> List[Completion]:
        """The ``device_loop_ticks = 1`` body of :meth:`step`: one tick,
        one read of the device."""
        reg = metrics.get_registry()
        t0 = time.perf_counter()
        with reg.timer("serving/decode_tick"):
            # each tick ends in a device->host copy of its tokens, so
            # the timer covers the tick's device work
            window, counts = self._tick(live)
        now = time.perf_counter()
        self._tick_time += now - t0
        self._tick_ms.append((now - t0) * 1e3)
        self._ticks += 1
        metrics.inc("serving/device_ticks")
        committed = ticked = 0
        for slot in live:
            req = self._slots[slot]
            if req is None or (self.paged and not req.get("active")):
                # preempted by the tick's page maintenance
                continue
            ticked += 1
            m = counts[slot]
            req["tokens"].extend(window[slot][:m])
            if "ttft_ms" not in req:
                req["ttft_ms"] = (now - req["submit_t"]) * 1e3
                self._ttft_ms.append(req["ttft_ms"])
            if self.paged:
                req["cur_len"] += m
                if self.spec:
                    # rejected-KV rollback: pages wholly past the
                    # accepted point go straight back to the pool (the
                    # partial page's stale columns sit past cur_len and
                    # are overwritten before any read)
                    self._trim_pages(slot, -(-req["cur_len"] // self._page))
            committed += m
        self._decode_tokens += committed
        metrics.inc("serving/decode_tokens", committed)
        if self.spec:
            self._count_spec(ticked, committed)
        return self._evict_done(live)

    def _count_spec(self, ticked: int, committed: int) -> None:
        """One tick's drafted / accepted counts (the t0s are not
        drafts)."""
        drafted = self._spec_k * ticked
        accepted = committed - ticked
        self._spec_drafted += drafted
        self._spec_accepted += accepted
        metrics.inc("serving/spec_drafted", drafted)
        metrics.inc("serving/spec_accepted", accepted)
        metrics.get_registry().set_gauge(
            "serving/spec_accept_rate",
            self._spec_accepted / max(self._spec_drafted, 1))

    def _evict_done(self, live: List[int]) -> List[Completion]:
        """Evict every live slot that emitted EOS or spent its budget,
        as the host mirror read back with the last tick says."""
        done = []
        for slot in live:
            req = self._slots[slot]
            if req is None or (self.paged and not req.get("active")):
                continue
            if self._state.host.finished[slot]:
                done.append(self._evict(slot, "eos"))
            elif self._state.host.dec_count[slot] >= self.gen_cfg.max_dec_len:
                done.append(self._evict(slot, "length"))
        return done

    # -- device-resident decode (device_loop_ticks > 1) ----------------
    #
    # One step() launches up to T ticks of one loop and reads the device
    # once; the host amortizes admission, drafting, page maintenance and
    # telemetry over the ticks it gets back. The device stops ticking
    # when a slot finishes or spends its budget; the host asks for one
    # tick only while it has scheduling work, so chunked prefill and
    # admission keep their one-unit-of-progress-per-step cadence.

    def _loop_host_flag(self, live: List[int]) -> bool:
        """Should the loop hand control back after ONE tick? While any
        request is queued (a full-T launch would defer its admission by
        T ticks), while a chunked prefill is unfinished (paged), or when
        the page pool cannot cover every live slot's T-tick write window
        without preempting (better one short loop than an avoidable
        preemption)."""
        if self._queue:
            return True
        if not self.paged:
            return False
        if self._prefilling:
            return True
        span = self._loop_ticks * ((self._spec_k + 1) if self.spec else 1)
        cap = self.config.cache_capacity
        need = 0
        for slot in live:
            req = self._slots[slot]
            first = req["cur_len"] // self._page
            last = -(-min(req["cur_len"] + span, cap) // self._page)
            for j in range(first, last):
                if j >= req["num_pages"] or self._alloc.refcount(
                        int(self._pt[slot, j])) > 1:
                    need += 1   # a fresh map, or a COW split's copy
        return need > self._alloc.free_pages

    def _loop_graph(self):
        """``(LoopCarry, TickGraph)`` of this server's one tick shape,
        built at the first round trip: the tick reads the slot state,
        the cache, the decode page table and the adapter rows, all
        written in place between round trips."""
        if self._loop is None:
            carry = init_loop_carry(self.num_slots, self._loop_ticks,
                                    self.gen_cfg, self._device,
                                    self._spec_k if self.spec else None)
            pt = self._pt_dev_dec if self.paged else None
            aid = self._aid_arg()

            def tick():
                loop_tick(self.model, self._cache, self._state, carry,
                          self.gen_cfg, self.seed, pt, aid)

            def warm():
                # an iteration past the last is masked: it changes no
                # slot state, and its ring column is reset after it
                carry.tick.fill_(self._loop_ticks)
                tick()
                carry.tick.zero_()
            self._loop = (carry, TickGraph(tick, warm, self._device))
        return self._loop

    def _step_loop(self, live: List[int]) -> List[Completion]:
        """The ``device_loop_ticks > 1`` body of :meth:`step`: drafts
        for every tick (proposed from the pre-loop history) and the
        whole write window mapped, ``n`` ticks launched and one read of
        the device, then a per-tick replay of the returned buffers so
        ``serving/decode_tokens``, TTFT (interpolated over the loop's
        wall time), ``serving/tick_ms`` and the spec counts stay
        tick-accurate."""
        T = self._loop_ticks
        k = self._spec_k
        host_flag = self._loop_host_flag(live)
        # flag up -> one tick runs, so drafting and page pre-mapping
        # cover one tick's window only
        eff = 1 if host_flag else T
        reg = metrics.get_registry()
        t0 = time.perf_counter()
        with reg.timer("serving/decode_tick"):
            drafts = None
            if self.spec:
                drafts = np.zeros((self.num_slots, T, k), np.int64)
                for slot in live:
                    req = self._slots[slot]
                    drafts[slot, :eff] = np.asarray(self._draft.propose(
                        req["prompt"] + req["tokens"], k * eff),
                        np.int64).reshape(eff, k)
            if self.paged:
                self._page_maintenance(
                    window=eff * ((k + 1) if self.spec else 1))
                self._sync_pt()
            live = [s for s in live if self._slots[s] is not None and
                    (not self.paged or self._slots[s].get("active"))]
            # the device masks every tick past an exit, so only an EOS
            # mid-loop leaves replays that commit nothing
            n = 1 if host_flag else min(
                [T] + [self.gen_cfg.max_dec_len -
                       int(self._state.host.dec_count[s]) for s in live])
            carry, graph = self._loop_graph()
            self._aid_arg()
            reset_loop_carry(carry, self.gen_cfg, host_flag, drafts)
            graph.replay(n)
            tokens, counts, n_ticks, exit_code = read_loop(
                self._state, carry, self.gen_cfg)
        loop_s = time.perf_counter() - t0
        self._tick_time += loop_s
        per_tick_s = loop_s / n_ticks
        self._tick_ms.extend([per_tick_s * 1e3] * n_ticks)
        self._ticks += n_ticks
        metrics.inc("serving/device_ticks", n_ticks)
        metrics.inc("serving/loop_exit/" + (
            "finished" if exit_code == LOOP_EXIT_FINISHED else
            "budget" if exit_code == LOOP_EXIT_BUDGET else "admission"))
        if not self.spec:
            tokens = tokens[:, :, None]
            counts = np.zeros((self.num_slots, T), np.int64)
            counts[:, :n_ticks] = 1
        committed = 0
        for j in range(n_ticks):
            t_j = t0 + (j + 1) * per_tick_s
            tick_committed = ticked = 0
            for slot in live:
                req = self._slots[slot]
                ticked += 1
                m = int(counts[slot, j])
                req["tokens"].extend(int(t) for t in tokens[slot, j, :m])
                if "ttft_ms" not in req:
                    req["ttft_ms"] = (t_j - req["submit_t"]) * 1e3
                    self._ttft_ms.append(req["ttft_ms"])
                tick_committed += m
            committed += tick_committed
            if self.spec and ticked:
                self._count_spec(ticked, tick_committed)
        self._decode_tokens += committed
        metrics.inc("serving/decode_tokens", committed)
        if self.paged:
            # past the committed tokens: the pre-mapped tail of an early
            # exit and spec's rejected KV go back to the pool
            for slot in live:
                req = self._slots[slot]
                req["cur_len"] += int(counts[slot, :n_ticks].sum())
                self._trim_pages(slot, -(-req["cur_len"] // self._page))
        return self._evict_done(live)

    def run(self, prompts: Sequence[Sequence[int]],
            adapter_ids: Optional[Sequence[int]] = None
            ) -> List[Completion]:
        """Serve prompts to completion; completions return in submission
        order. ``adapter_ids`` pairs each prompt with a LoRA adapter (0,
        the default, the base model)."""
        if adapter_ids is None:
            adapter_ids = [0] * len(prompts)
        ids = [self.submit(p, adapter_id=a)
               for p, a in zip(prompts, adapter_ids)]
        done: Dict[int, Completion] = {}
        while self.pending or self.occupancy:
            for c in self.step():
                done[c.request_id] = c
        return [done[i] for i in ids]

    def summary(self) -> dict:
        """Counters, decode tokens/s (committed tokens over tick time),
        device ticks against host round trips, and TTFT / tick-time /
        round-trip percentiles over the server's lifetime (host clock;
        each round trip ends in a device sync); paged servers
        add the pool's occupancy and the allocator's sharing stats,
        speculative ones the draft and accept counts."""
        s = {"slots": self.num_slots, "occupancy": self.occupancy,
             "pending": self.pending, "decode_ticks": self._ticks,
             "decode_tokens": self._decode_tokens,
             "decode_time_sec": self._tick_time,
             "tokens_per_sec": self._decode_tokens / self._tick_time
             if self._tick_time > 0 else 0.0,
             # the host-overhead line: device ticks against host round
             # trips, equal at T = 1
             "device_loop_ticks": self._loop_ticks,
             "device_ticks": self._ticks,
             "host_roundtrips": self._roundtrips, **self._counts}
        if self._loop_ticks > 1:
            # ticks launched (masked ones included) and eager warm-ups:
            # the kernels launched (ticks_replayed + graph_warmups)
            # times a tick
            graph = self._loop[1] if self._loop else None
            s["ticks_replayed"] = graph.replays if graph else 0
            s["graph_warmups"] = graph.warmups if graph else 0
        for name, series in (("ttft", self._ttft_ms),
                             ("tick", self._tick_ms),
                             ("host_roundtrip", self._roundtrip_ms)):
            if series:
                s[f"{name}_p50_ms"] = float(np.percentile(series, 50))
                s[f"{name}_p99_ms"] = float(np.percentile(series, 99))
        if self.spec:
            s["spec_tokens"] = self._spec_k
            s["spec_drafted"] = self._spec_drafted
            s["spec_accepted"] = self._spec_accepted
            s["spec_accept_rate"] = \
                self._spec_accepted / max(self._spec_drafted, 1)
        if self._adapters is not None:
            s["adapter_rows"] = self._adapters.capacity
            s["adapters_resident"] = self._adapters.resident
            s.update(self._adapters.stats)
        if self.paged:
            cfg = self.config
            s["paged"] = True
            s["page_size"] = self._page
            s["pool_pages"] = self._alloc.num_pages
            s["pages_in_use"] = self._alloc.pages_in_use
            s["prefill_chunks"] = self._prefill_chunk_count
            # density: the same pool bytes hold ~1.9x the pages in int8
            s["kv_cache_dtype"] = cfg.kv_cache_dtype
            s["pool_bytes"] = pool_bytes(
                cfg.num_layers, cfg.num_attention_heads, cfg.head_dim,
                self._page, self._alloc.num_pages, cfg.kv_cache_dtype)
            s.update(self._alloc.stats)
        return s
