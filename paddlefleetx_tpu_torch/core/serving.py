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

The host KV tier (``host_pool_bytes``, paged with prefix sharing): a
bounded tier of pinned host memory under the device pool, allocated
once as one slab of page rows. A registered page's last reference is
held as a spill pin instead of freed; at the next yield point (step
entry, between device launches) every pinned page moves its
registrations onto a host id (``PageAllocator.spill``), its KV is
packed on the device into one contiguous row buffer
(``pack_kv_pages``: one indexed read per pool tensor, whatever the page
count), and the ``kv-spill-writer`` thread copies that buffer to host
memory in one copy on a copy stream, waiting on the pack's event and
on nothing else, so decode ticks never wait for a spill. A later
registry hit rehydrates: the staged rows go back in one host-to-device
copy and one in-place indexed write per pool tensor
(``unpack_kv_pages``) into fresh device pages, and the registrations
move back (``PageAllocator.promote``) instead of a re-prefill. Host
residencies are tagged with generations, so a recycled host id's stale
bytes never rehydrate; a failed stage evicts its pages at the next
yield (``serving/spill_failed``) and their prompts re-prefill cold.
:meth:`GenerationServer.export_prefix_store` /
:meth:`GenerationServer.import_prefix_store` carry the tier across
restarts (``core/checkpoint.py`` ``save_prefix_store`` /
``load_prefix_store``), guarded by a model fingerprint.

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
1 while the host has scheduling work (a queued request, a drain, a
chunked prefill, a pending spill, or a page pool that cannot cover the
T-tick window), else ``min(T, the least remaining budget)``; on the
device a tick after a slot finishes or spends its budget commits
nothing, so the loop stops where the JAX package's ``lax.while_loop``
stops. Spills, rehydrates and drains happen only between replays. The
host then replays the per-tick buffers (tokens, interpolated TTFT,
spec counts) so the telemetry stays tick-accurate. Any T commits the
tokens of T = 1.

Graceful degradation: per-request deadlines (``submit(deadline_s=)``
or the server-wide ``request_ttl_s``) end expired requests, queued or
mid-decode, as ``deadline_exceeded`` partials; a bounded queue
(``max_queue_depth``) sheds excess submits with :class:`RequestShed`
(``serving/shed``); :meth:`GenerationServer.drain` (or a SIGTERM under
``drain_on_sigterm``) stops admitting, finishes or preempts in-flight
slots and returns partials, and ``submit(resume_tokens=...)``
re-enters a partial on a fresh server token-exactly. Fault sites
(``fault_injector``, ``core/resilience.py``): ``req`` (``admit_fail``
sheds the submit) and ``tick`` (``hang`` / ``kill``); a ``watchdog``
(``StepWatchdog``) is armed around every tick or round trip.

Telemetry: the JAX package's ``serving/*`` counters and gauges
(``docs/inference.md``) in the process-global registry, among them
``serving/spill``, ``serving/rehydrate``, ``serving/spill_failed``,
``serving/shed``, ``serving/deadline_exceeded``,
``serving/loop_exit/{finished,budget,admission,drain}`` and the
``serving/host_pages`` gauge; the latency series (``serving/ttft_ms``,
``serving/queue_wait_ms``, ``serving/tpot_ms``, ``serving/tick_ms``,
``serving/host_roundtrip_ms``, ``serving/rehydrate_ms``) as
fixed-memory log-bucketed histograms in a server-local registry, from
which :meth:`GenerationServer.summary` reads its percentiles. With
``events_path`` a flight recorder takes the JAX package's events
(``serving_start``, ``serving_admit``, ``serving_shed``,
``serving_evict``, ``serving_spill``, ``serving_rehydrate``,
``serving_yield``, ``serving_drain_start`` / ``_end``, ...) and every
request gets a trace: a ``serving/request`` root span with
``serving/queue`` -> ``serving/prefill`` -> ``serving/decode`` phases
and a ``serving/first_token`` point, a preemption or a resume (pass
``trace_id``) continuing the same trace. ``metrics_port`` serves live
``/metrics``, ``/vars``, ``/healthz`` (503 while draining), ``/trace``
and ``/timeline`` (``observability/server.py``).

Thread safety: every public entry point serializes on one re-entrant
surface lock; blocking waits (the spill queue, the writer) run outside
it or on the spill condition, which the writer takes alone.

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
``serving/adapters_resident`` gauge and the ``serving_adapter_load`` /
``serving_adapter_evict`` events.

MoE models (``moe_num_experts > 0``) serve in every mode above. Each
forward routes each batch row as its own group, whose expert capacity
comes from the forward's sequence length, as in the JAX package: a
contiguous admission routes its prompt at its bucket's length, a paged
one chunk by chunk (a preempted request's re-prefill is a new group), a
decode tick one token a slot, a verify tick the slot's window. So an
MoE model's rows may differ between modes (they do in the JAX package),
while slot count and admission order leave them unchanged.

Not ported yet: beam search, KV export / import between servers and the
fleet router.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import queue
import signal
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.gpt.generation import (
    LOOP_EXIT_BUDGET, LOOP_EXIT_FINISHED, GenerationConfig, activate_slot,
    copy_kv_pages, decode_step, init_loop_carry, init_page_pool,
    init_slot_cache, init_slot_state, kv_row_bytes, loop_tick,
    pack_kv_pages, prefill_chunk_paged, prefill_into_slots, read_loop,
    release_slot, reset_loop_carry, stack_kv_rows, unpack_kv_pages,
    verify_step,
)
from ..models.gpt.model import GPTForPretraining
from ..observability import metrics
from ..observability import server as obs_server
from ..observability import timeline
from ..observability.histogram import LogHistogram
from ..observability.recorder import FlightRecorder
from ..observability.spans import Tracer
from ..utils.log import logger
from .adapters import AdapterCache, insert_adapter
from .decode_graph import TickGraph
from .paging import (
    NULL_PAGE, PageAllocator, PagePoolExhausted, page_prefix_keys,
    pool_bytes, pool_pages_for_bytes, prompt_key,
)
from .resilience import FaultInjector, StepWatchdog
from .spec import make_draft_source


class RequestShed(RuntimeError):
    """Admission refused: the queue is at ``max_queue_depth``, the
    server is draining, or an ``admit_fail`` fault fired. The caller
    backs off and retries elsewhere; everything already admitted is
    unaffected."""


class _RehydrateMiss(Exception):
    """A host page's staged bytes are gone because its spill stage
    failed on the writer thread; the page has been evicted (reaped) and
    admission unwinds what it mapped and retries the request, which
    re-prefills cold on the next pass. Internal to the admission loop,
    never escapes :meth:`GenerationServer.step`."""


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
    #: "eos" | "length" (hit max_dec_len) | "preempted" (drain or
    #: :meth:`GenerationServer.preempt`; ``tokens`` holds the partial)
    #: | "deadline_exceeded" (its deadline passed; the partial) |
    #: "adapter_missing" (an unknown adapter id, failed at admission)
    finish_reason: str
    #: the request's trace id (None without an event stream): pass it
    #: back with ``submit(resume_tokens=..., trace_id=...)`` so the
    #: resumed request's spans continue the original trace
    trace_id: Optional[str] = None
    #: time to first token in ms on this server (None when the request
    #: never decoded here)
    ttft_ms: Optional[float] = None


#: the latency histograms of a server's local registry and the summary
#: key prefix each is read under
_LATENCY_SERIES = (("ttft", "serving/ttft_ms"),
                   ("queue_wait", "serving/queue_wait_ms"),
                   ("tpot", "serving/tpot_ms"),
                   ("tick", "serving/tick_ms"),
                   ("host_roundtrip", "serving/host_roundtrip_ms"),
                   ("rehydrate", "serving/rehydrate_ms"))


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
            from the Philox stream of ``(seed, nonce_r, t)``.
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
        host_pool_bytes (int): the host KV tier's byte budget (paged
            with prefix sharing only), turned into pages for the KV
            dtype (``pool_pages_for_bytes``; int8 fits ~1.9x the
            pages).
        request_ttl_s (float): every request's default deadline, from
            its submit (queued time included).
        max_queue_depth (int): submits past this many queued requests
            raise :class:`RequestShed`.
        drain_on_sigterm (bool): install a SIGTERM handler (main thread
            only) that flips the server into drain mode; :meth:`close`
            restores the previous one.
        fault_injector (FaultInjector): fires at the ``req`` and
            ``tick`` sites.
        events_path (str): the flight recorder's ``events.jsonl``
            (events and request spans); None records nothing.
        watchdog (StepWatchdog): armed around every tick (T = 1) or
            round trip; started here if it is not running, stopped by
            :meth:`close`.
        metrics_port (int): serve ``/metrics``, ``/healthz`` & co. on
            this port (0: an ephemeral one; None: no endpoint).
    """

    #: upper bound on waiting for the writer to publish a page's bytes
    #: at rehydrate or export time: generous next to one copy, reached
    #: only when the writer died
    _SPILL_WAIT_S = 30.0

    def __init__(self, model: GPTForPretraining, gen_cfg: GenerationConfig,
                 num_slots: int = 4,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 seed: int = 0, page_size: Optional[int] = None,
                 pool_pages: Optional[int] = None,
                 prefill_chunk_pages: int = 2, prefix_sharing: bool = True,
                 device_loop_ticks: int = 1, adapter_source=None,
                 host_pool_bytes: Optional[int] = None,
                 request_ttl_s: Optional[float] = None,
                 max_queue_depth: Optional[int] = None,
                 drain_on_sigterm: bool = False,
                 fault_injector: Optional[FaultInjector] = None,
                 events_path: Optional[str] = None,
                 watchdog: Optional[StepWatchdog] = None,
                 metrics_port: Optional[int] = None):
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
        self._tiered = False
        host_pages = 0
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
            if host_pool_bytes:
                if not self._prefix_sharing:
                    raise ValueError(
                        "host_pool_bytes requires prefix_sharing: the "
                        "host tier holds only registry-reachable pages")
                host_pages = pool_pages_for_bytes(
                    int(host_pool_bytes), cfg.num_layers,
                    cfg.num_attention_heads, cfg.head_dim, self._page,
                    cfg.kv_cache_dtype)
                if host_pages < 1:
                    raise ValueError(f"host_pool_bytes ({host_pool_bytes}) "
                                     f"smaller than one KV page")
            self._tiered = host_pages > 0
            self._alloc = PageAllocator(cfg.kv_pool_pages, self._page,
                                        host_pages=host_pages)
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
        elif host_pool_bytes:
            raise ValueError("host_pool_bytes requires paged mode "
                             "(page_size / pool_pages): the host tier "
                             "holds KV pages")
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
        self._counts = {"admitted": 0, "evicted": 0, "preempted": 0,
                        "shed": 0, "deadline_exceeded": 0}
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
        # graceful degradation
        self.request_ttl_s = request_ttl_s
        self.max_queue_depth = max_queue_depth
        self._draining = False
        self._submits = 0
        self._closed = False
        # latency histograms in a server-local always-on registry (the
        # summary's percentiles work with the global registry off)
        self._metrics = metrics.MetricsRegistry(enabled=True)
        self._recorder = FlightRecorder(events_path) if events_path \
            else None
        self._tracer = Tracer(self._recorder)
        # every public entry point serializes on this re-entrant lock;
        # blocking waits never run under it (the spill queue's puts
        # happen in _ship_spills after it is released, writer waits go
        # through the _spill_lock condition)
        self._surface_lock = threading.RLock()
        # /healthz is answered on the metrics endpoint's threads: they
        # read the snapshot the main loop republishes under this lock
        self._health_lock = threading.Lock()
        self._health_snapshot = {"status": "ok", "slots": num_slots,
                                 "occupancy": 0, "pending": 0, "ticks": 0}
        self._faults = fault_injector
        self._watchdog = watchdog
        if watchdog is not None:
            watchdog.start()
        if self._tiered:
            # the host tier, allocated once: one pinned slab (pinned when
            # the pool is on the card) of host_pages residency rows plus
            # the writer's and the rehydrate's transfer rows, each one
            # contiguous copy's landing area; then the writer thread
            host_pool_bytes = int(host_pool_bytes)
            self._host_pool_bytes = host_pool_bytes
            self._row_bytes = kv_row_bytes(self._cache)
            self._host_base = self.config.kv_pool_pages
            # a yield's live spill batch is at most every device page
            # or the whole tier; a rehydrate at most one request's pages
            n_spill = min(host_pages, self.config.kv_pool_pages - 1)
            n_rehy = min(host_pages, self._max_pages)
            cuda = self._device.type == "cuda"
            slab = torch.empty(
                (host_pages + n_spill + n_rehy, self._row_bytes),
                dtype=torch.uint8, pin_memory=cuda)
            self._slab_bytes = slab.numel()
            self._host_slab = slab[:host_pages]
            self._spill_xfer = slab[host_pages:host_pages + n_spill]
            self._rehy_xfer = slab[host_pages + n_spill:]
            self._copy_stream = torch.cuda.Stream(self._device) if cuda \
                else None
            #: the last rehydrate's copy out of _rehy_xfer (an event),
            #: which the next one waits on before refilling the rows
            self._rehy_done = None
            # pages whose LAST reference is held back as a spill pin
            # until the next yield-point drain (insertion order = spill
            # order)
            self._spill_pin: Dict[int, None] = {}
            # host id -> residency generation whose bytes sit in the id's
            # slab row; shared with the writer, every access under
            # _spill_lock. The generation keeps a recycled id's stale
            # bytes (an old spill still queued when the LRU evicted and
            # reused the id) from ever rehydrating as the new page's KV
            self._host_data: Dict[int, int] = {}
            # (hpid, gen) pairs whose stage failed on the writer; the
            # main loop evicts them at the next yield point. Under
            # _spill_lock
            self._spill_failed: List[Tuple[int, int]] = []
            # a Condition: the rehydrate slow path and the prefix-store
            # export wait on it for the writer's publishes, from under
            # the surface lock, which the writer never takes
            self._spill_lock = threading.Condition()
            #: writer items shipped but not yet published or failed
            self._spill_outstanding = 0
            #: writer items _drain_spills collected this entry, shipped
            #: by _ship_spills once the surface lock is released
            self._spill_outbox: List[tuple] = []
            self._spill_q: queue.Queue = queue.Queue()
            #: the writer's copy time a batch (host clock, ms)
            self._d2h_hist = LogHistogram()
            self._spill_writer_thread = threading.Thread(
                target=self._spill_writer, name="kv-spill-writer",
                daemon=True)
            self._spill_writer_thread.start()
        self._model_fp: Optional[str] = None
        if self._tiered:
            # computed once at build: the prefix-store paths under the
            # surface lock read the cached value
            self._model_fingerprint()
        self._prev_sigterm = None
        self._sigterm_installed = False
        if drain_on_sigterm:
            try:
                self._prev_sigterm = signal.signal(signal.SIGTERM,
                                                   self._on_sigterm)
                self._sigterm_installed = True
            except ValueError:
                logger.warning(
                    "drain_on_sigterm: cannot install SIGTERM handler "
                    "outside the main thread; call drain() explicitly")
        self._metrics_server = None
        if metrics_port is not None:
            self._metrics_server = obs_server.start(
                metrics_port, registry=self._metrics,
                health=self.health_snapshot, events_path=events_path)
        self._emit("serving_start", slots=num_slots, buckets=list(buckets),
                   max_dec_len=gen_cfg.max_dec_len, paged=self.paged,
                   page_size=self._page if self.paged else 0,
                   pool_pages=cfg.kv_pool_pages if self.paged else 0,
                   host_pages=self._alloc.host_pages if self.paged else 0,
                   spec=self.spec,
                   spec_tokens=self._spec_k if self.spec else 0,
                   loop_ticks=self._loop_ticks,
                   adapter_rows=self._adapters.capacity
                   if self._adapters else 0)
        if self.paged:
            logger.info(
                "GenerationServer (paged): %d slots, %d-page pool of "
                "%d-token pages (capacity %d = %d pages/slot max), "
                "prefill chunk %d tokens, prefix sharing %s, host tier "
                "%d pages, spec %s, %d ticks a round trip on %s",
                num_slots, cfg.kv_pool_pages, self._page,
                cfg.cache_capacity, self._max_pages, self._chunk,
                self._prefix_sharing, host_pages, gen_cfg.spec_method,
                self._loop_ticks, self._device)
        else:
            logger.info("GenerationServer: %d slots, prefill buckets %s, "
                        "capacity %d, spec %s, %d ticks a round trip on %s",
                        num_slots, list(buckets), cfg.cache_capacity,
                        gen_cfg.spec_method, self._loop_ticks, self._device)

    # -- host bookkeeping ---------------------------------------------

    def _emit(self, event: str, **fields) -> None:
        if self._recorder is not None:
            self._recorder.emit(event, **fields)

    def _refresh_health(self) -> None:
        """Rebuild the ``/healthz`` payload from live state (main loop)
        and publish it under the health lock, at the loop's choke
        points (submit, step end, drain, SIGTERM)."""
        payload = {"status": "draining" if self._draining else "ok",
                   "slots": self.num_slots, "occupancy": self.occupancy,
                   "pending": self.pending, "ticks": self._ticks}
        with self._health_lock:
            self._health_snapshot = payload

    def health_snapshot(self) -> dict:
        """This server's health (``status``, ``slots``, ``occupancy``,
        ``pending``, ``ticks``), the ``/healthz`` payload: ``status`` is
        ``draining`` (HTTP 503) from the moment drain mode is entered.
        Thread-safe: the last published snapshot, never live state."""
        with self._health_lock:
            return dict(self._health_snapshot)

    # -- per-request tracing -------------------------------------------
    #
    # Every request owns a root span (req["span"]) and ONE open phase
    # child (req["phase"]): queue -> prefill -> decode, looping back to
    # queue on preemption under the same trace id. Without an event
    # stream the tracer hands out NULL_SPAN and these calls do nothing.

    def _begin_trace(self, req: dict, trace_id: Optional[str] = None
                     ) -> None:
        req["span"] = self._tracer.start_trace(
            "serving/request", trace_id=trace_id, request=req["id"],
            prompt_len=len(req["prompt"]),
            resumed=bool(req["tokens"]) or None)
        req["phase"] = req["span"].start_span("serving/queue")
        req["queue_t0"] = time.time()

    def _phase(self, req: dict, name: str, **attrs) -> None:
        """End the open phase child and begin the next one."""
        req["phase"].end()
        req["phase"] = req["span"].start_span(name, **attrs)

    def _trace_id(self, req: dict) -> Optional[str]:
        return req["span"].trace_id if "span" in req else None

    def _observe_queue_wait(self, req: dict) -> None:
        """This queue episode's wait (a requeue resets the clock)."""
        self._metrics.observe(
            "serving/queue_wait_ms",
            (time.time() - req.get("queue_t0", req["submit_t"])) * 1e3)

    def _end_request_spans(self, req: dict, reason: str) -> None:
        """Close the open phase and the root span (idempotent)."""
        phase = req.pop("phase", None)
        if phase is not None:
            phase.end(reason=reason)
        span = req.pop("span", None)
        if span is not None:
            span.end(reason=reason, tokens=len(req["tokens"]))
            req["span"] = span   # kept for _trace_id after eviction

    def _first_token(self, req: dict, t: float) -> None:
        """Record a request's first committed token at time ``t``."""
        req["ttft_ms"] = (t - req["submit_t"]) * 1e3
        req["first_tok_t"] = t
        self._metrics.observe("serving/ttft_ms", req["ttft_ms"])
        req["span"].span_point("serving/first_token",
                               ttft_ms=round(req["ttft_ms"], 3))

    @property
    def occupancy(self) -> int:
        """Number of slots currently holding a live request."""
        with self._surface_lock:
            return sum(s is not None for s in self._slots)

    @property
    def pending(self) -> int:
        """Number of submitted requests still waiting for a slot."""
        with self._surface_lock:
            return len(self._queue)

    @property
    def draining(self) -> bool:
        """True once drain mode is entered (SIGTERM or :meth:`drain`)."""
        with self._surface_lock:
            return self._draining

    def check_alloc(self) -> None:
        """Assert the page allocator's invariants (paged mode)."""
        with self._surface_lock:
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
        with self._surface_lock:
            if not adapter_id or self._adapters is None:
                return 0
            return int(self._adapters.is_resident(adapter_id))

    def submit(self, prompt: Sequence[int],
               deadline_s: Optional[float] = None,
               resume_tokens: Optional[Sequence[int]] = None,
               trace_id: Optional[str] = None,
               nonce: Optional[int] = None, adapter_id: int = 0) -> int:
        """Queue a request and return its id.

        Raises ``ValueError`` for an empty prompt, one that can never
        fit (``prompt + max_dec_len > max_position_embeddings``),
        ``resume_tokens`` that already meet ``max_dec_len``, a negative
        ``adapter_id`` or a non-zero one on a server without an
        ``adapter_source``; :class:`RequestShed` when admission is
        refused (queue at ``max_queue_depth``, server draining, or an
        injected ``admit_fail`` fault).

        ``deadline_s`` bounds this request's wall-clock lifetime (queued
        time included), overriding ``request_ttl_s``; on expiry it
        completes as ``deadline_exceeded`` with the tokens it earned.
        ``resume_tokens`` re-enters a partial from a drained or
        preempted completion: admission prefills prompt + tokens and the
        sampling stream and budget go on at the kept decode count, so a
        greedy resume is token-exact with the uninterrupted run.
        ``trace_id`` (with an event stream) continues an earlier trace:
        pass ``Completion.trace_id`` back with ``resume_tokens``.
        ``nonce`` overrides the server's per-request sampling-stream
        counter (submission order by default). ``adapter_id`` serves the
        request through that LoRA adapter (0: the base model);
        admission pins its bank row until the request leaves the card.
        """
        with self._surface_lock:
            return self._submit_impl(prompt, deadline_s, resume_tokens,
                                     trace_id, nonce, adapter_id)

    def _submit_impl(self, prompt, deadline_s, resume_tokens, trace_id,
                     nonce, adapter_id) -> int:
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) > self._max_prompt:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_dec_len "
                f"({self.gen_cfg.max_dec_len}) exceeds "
                f"max_position_embeddings "
                f"{self.model.config.max_position_embeddings}")
        tokens = [int(t) for t in resume_tokens or []]
        if tokens and len(tokens) >= self.gen_cfg.max_dec_len:
            raise ValueError(
                f"resume_tokens ({len(tokens)}) already meets max_dec_len "
                f"({self.gen_cfg.max_dec_len})")
        adapter_id = int(adapter_id)
        if adapter_id < 0:
            raise ValueError(f"adapter_id must be >= 0, got {adapter_id}")
        if adapter_id and self._adapters is None:
            raise ValueError("adapter_id requires an adapter_source (this "
                             "server serves the base model only)")
        self._submits += 1
        if self._draining:
            return self._shed("draining")
        if self._faults is not None and \
                self._faults.fire("req", self._submits) == "admit_fail":
            return self._shed("fault")
        if self.max_queue_depth is not None and \
                len(self._queue) >= self.max_queue_depth:
            return self._shed("queue_depth")
        if nonce is None:
            nonce = self._nonce
            self._nonce += 1
        rid = self._next_id
        self._next_id += 1
        ttl = deadline_s if deadline_s is not None else self.request_ttl_s
        now = time.time()
        req = {"id": rid, "prompt": prompt, "tokens": tokens,
               "nonce": int(nonce), "adapter_id": adapter_id,
               "submit_t": now,
               "deadline": now + ttl if ttl is not None else None}
        self._begin_trace(req, trace_id)
        self._queue.append(req)
        self._refresh_health()
        return rid

    def _shed(self, reason: str) -> int:
        """Refuse admission: count it, record it, raise."""
        self._counts["shed"] += 1
        metrics.inc("serving/shed")
        self._emit("serving_shed", reason=reason, pending=self.pending,
                   occupancy=self.occupancy)
        raise RequestShed(f"request shed ({reason}): {self.pending} "
                          f"queued, {self.occupancy}/{self.num_slots} "
                          f"slots busy")

    def _on_sigterm(self, signum, frame) -> None:
        """Preemption notice: flip into drain mode, so the running
        :meth:`run` / :meth:`step` loop stops admitting and returns
        partials. The surface lock is re-entrant, so a signal landing
        mid-step on the main thread takes it safely."""
        with self._surface_lock:
            self._draining = True
            self._refresh_health()
            self._emit("serving_drain_start", signum=signum,
                       pending=self.pending, occupancy=self.occupancy)

    def _expire_deadlines(self) -> List[Completion]:
        """End every queued or running request whose deadline passed as
        a ``deadline_exceeded`` partial: expiry is a result the client
        sees, not a silent drop."""
        now = time.time()
        out: List[Completion] = []
        if any(r.get("deadline") is not None and now > r["deadline"]
               for r in self._queue):
            keep: deque = deque()
            for req in self._queue:
                dl = req.get("deadline")
                if dl is not None and now > dl:
                    self._counts["deadline_exceeded"] += 1
                    metrics.inc("serving/deadline_exceeded")
                    self._end_request_spans(req, "deadline_exceeded")
                    self._emit("serving_evict", request=req["id"], slot=-1,
                               reason="deadline_exceeded",
                               tokens=len(req["tokens"]),
                               trace=self._trace_id(req))
                    out.append(Completion(
                        request_id=req["id"], prompt=req["prompt"],
                        tokens=req["tokens"],
                        finish_reason="deadline_exceeded",
                        trace_id=self._trace_id(req)))
                else:
                    keep.append(req)
            self._queue = keep
        for slot, req in enumerate(self._slots):
            if req is not None and req.get("deadline") is not None \
                    and now > req["deadline"]:
                self._counts["deadline_exceeded"] += 1
                metrics.inc("serving/deadline_exceeded")
                out.append(self._evict(slot, "deadline_exceeded"))
        return out

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if b >= n:
                return b
        # buckets cover prompt lengths; a resume's prompt + tokens can
        # pass the largest one, and prefills at its own length
        return n

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
                self._fail_admission(req, "adapter_missing")
                return False
            if lease.evicted is not None:
                self._emit("serving_adapter_evict", adapter=lease.evicted,
                           row=lease.row)
            if lease.tree is not None:
                insert_adapter(self.model, lease.tree, lease.row)
                self._emit("serving_adapter_load", adapter=req["adapter_id"],
                           row=lease.row, request=req["id"])
            row = lease.row
        self._set_row(slot, row)
        return True

    def _fail_admission(self, req: dict, reason: str) -> None:
        """An admission-time failure (an unknown adapter id): complete
        the request with its partial tokens instead of wedging the
        queue."""
        self._counts["evicted"] += 1
        metrics.inc("serving/evicted")
        self._end_request_spans(req, reason)
        self._emit("serving_evict", request=req["id"], slot=-1,
                   reason=reason, tokens=len(req["tokens"]),
                   trace=self._trace_id(req))
        self._dead.append(Completion(
            request_id=req["id"], prompt=req["prompt"],
            tokens=req["tokens"], finish_reason=reason,
            trace_id=self._trace_id(req), ttft_ms=req.get("ttft_ms")))

    def _take_dead(self) -> List[Completion]:
        out, self._dead = self._dead, []
        return out

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
        (contiguous), or the paged admission. A resumed request
        prefills prompt + its tokens and goes on at that decode
        count."""
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
            seq = req["prompt"] + req["tokens"]
            bucket = self._bucket_for(len(seq))
            self._observe_queue_wait(req)
            self._phase(req, "serving/prefill", slot=slot)
            row = np.full((1, bucket), self.gen_cfg.pad_token_id, np.int64)
            row[0, :len(seq)] = seq
            prefill_into_slots(self.model, self._cache, self._state, [slot],
                               torch.as_tensor(row, device=self._device),
                               [len(seq)], [req["nonce"]],
                               self._rows_arg(slot),
                               dec_counts=[len(req["tokens"])])
            self._slots[slot] = req
            self._counts["admitted"] += 1
            metrics.inc("serving/admitted")
            self._emit("serving_admit", request=req["id"], slot=slot,
                       prompt_len=len(req["prompt"]), bucket=bucket,
                       trace=self._trace_id(req))
            self._phase(req, "serving/decode", slot=slot)

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
        self._observe_queue_wait(req)
        self._phase(req, "serving/prefill", slot=slot)

    def _activate(self, slot: int, last_logits_row: torch.Tensor) -> None:
        """Flip a placed slot live from the host's view of the request
        (seq = prompt + already emitted tokens, so a preempted or
        resumed request re-enters mid-request)."""
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
        self._phase(req, "serving/decode", slot=slot)

    def _unwind_admission(self, req: dict, slot: int) -> None:
        """Undo a claim whose rehydrate missed: the request goes back to
        the queue head and retries (it re-prefills cold)."""
        self._drop_evicted_host_data()
        self._release_adapter(slot, req)
        self._queue.appendleft(req)

    def _admit_paged(self) -> None:
        """Paged admission: a whole-prompt registry hit shares every
        page and activates with zero prefill; otherwise map shared
        prefix pages plus fresh owned pages and queue the slot for
        chunked prefill. Host-resident pages of either come back in one
        batched rehydrate. The queue HEAD blocks while the pool cannot
        cover its owned (and rehydrated) pages: admitting smaller later
        requests over it would starve long prompts; so does an adapter
        with no free bank row. Adapter requests neither share nor
        register pages: the registries hold base-model KV."""
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
                host_ids = [p for p in pages if self._alloc.is_host(p)]
                n_host = len(host_ids)
                if n_host and self._alloc.free_pages < n_host:
                    # rehydration needs fresh device pages
                    break
                if not self._claim(req, slot):
                    continue
                try:
                    promoted = dict(zip(host_ids,
                                        self._rehydrate_many(host_ids)))
                except _RehydrateMiss:
                    # nothing was mapped yet, and the reap dropped the
                    # dead page's registrations: the retry re-prefills
                    self._unwind_admission(req, slot)
                    continue
                mapped = []
                for pid in pages:
                    if pid in promoted:
                        mapped.append(promoted[pid])
                    else:
                        self._alloc.retain(pid)
                        mapped.append(pid)
                self._pt[slot, :] = NULL_PAGE
                self._pt[slot, :len(mapped)] = mapped
                self._pt_dirty = True
                self._alloc.stats["prompt_hits"] += 1
                metrics.inc("serving/prefix_hits")
                self._place(req, slot, num_pages=len(mapped))
                self._activate(slot, last)
                self._emit("serving_admit", request=req["id"], slot=slot,
                           prompt_len=L, mode="prompt_hit",
                           shared_pages=len(mapped),
                           rehydrated=n_host or None,
                           trace=self._trace_id(req))
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
            host_ids = [p for p in shared if self._alloc.is_host(p)]
            # host-resident shared pages need fresh device ids on top of
            # the owned pages the chunked tail allocates
            if self._alloc.free_pages < \
                    total_pages - len(shared) + len(host_ids):
                break
            if not self._claim(req, slot):
                continue
            try:
                promoted = dict(zip(host_ids,
                                    self._rehydrate_many(host_ids)))
            except _RehydrateMiss:
                self._unwind_admission(req, slot)
                continue
            self._pt[slot, :] = NULL_PAGE
            for j, pid in enumerate(shared):
                if pid in promoted:
                    pid = promoted[pid]
                else:
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
            self._emit("serving_admit", request=req["id"], slot=slot,
                       prompt_len=L, mode="chunked",
                       shared_pages=len(shared), chunks=n_chunks,
                       rehydrated=len(host_ids) or None,
                       trace=self._trace_id(req))

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
        self._emit("serving_prefill_chunk", request=req["id"], slot=slot,
                   start=c0, tokens=min(self._chunk, L - c0),
                   trace=self._trace_id(req))
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
                self._release_page(pid)
            self._pt[slot, j] = NULL_PAGE
        req["num_pages"] = keep
        self._pt_dirty = True

    # -- the host KV tier: device pool -> pinned host slab ----------------
    #
    # With host_pool_bytes set, a REGISTERED page's last reference is
    # never dropped outright: _release_page keeps it as a spill pin, and
    # _drain_spills, called only at the host yield point (step entry,
    # between device launches), moves its registrations onto a host id
    # (PageAllocator.spill), frees the device page and packs every
    # spilled page's KV into one row buffer on the device. The
    # kv-spill-writer thread copies that buffer to pinned host memory in
    # one copy on a copy stream, waiting on the pack's event only, and
    # files each row into the slab under its host id, tagged with the
    # residency generation. A later registry hit rehydrates: fresh
    # device pages, one host-to-device copy and one indexed write per
    # pool tensor, registrations moved back (promote). Host ids never
    # appear in a page table, so a divergent write can only target a
    # device page and the host copy is never mutated. The writer touches
    # only the spill queue and the _spill_lock-guarded state
    # (_host_data, the slab rows, the failure list); the allocator, the
    # cache and the telemetry stay with the main loop.

    def _d2h(self, rows: torch.Tensor, ready, dst: torch.Tensor) -> None:
        """Copy a packed row buffer into ``dst`` (host rows) in one copy:
        on the card on the copy stream, after the pack's ``ready`` event,
        and wait for that copy alone (never the whole device)."""
        if self._copy_stream is None:
            dst.copy_(rows)
            return
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(ready)
            dst.copy_(rows, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        done.synchronize()

    def _spill_writer(self) -> None:
        """Background spill writer: copy each writer item's row buffer
        to the pinned transfer rows in one copy, then file every row
        into the slab under its host id and publish it under the spill
        condition, tagged with its residency generation (a stale
        residency never overwrites a fresher one's row). The
        outstanding count drops and the condition notifies on EVERY
        path, success or failure: the rehydrate slow path and the
        prefix-store export wait for ``outstanding == 0``, and a failed
        item must never strand them. A failed stage records its pages
        instead (the main loop evicts them at the next yield point, so
        the loss surfaces as a cold re-prefill, never a hang or wrong
        KV). Every queue wait has a timeout; ``close`` queues the
        ``None`` that stops it."""
        tl = timeline.track("kv-spill-writer")
        while True:
            t0 = tl.begin()
            try:
                item = self._spill_q.get(timeout=0.5)
            except queue.Empty:
                tl.add("idle", t0)
                continue
            tl.add("idle", t0)
            if item is None:
                return
            entries, rows, ready = item
            t0 = tl.begin()
            w0 = time.perf_counter()
            xfer = self._spill_xfer[:len(entries)]
            try:
                self._d2h(rows, ready, xfer)
            except Exception:
                logger.exception(
                    "kv-spill-writer: staging %d host pages failed; their "
                    "KV is lost and the pages will be evicted",
                    len(entries))
                with self._spill_lock:
                    self._spill_failed.extend(entries)
                    self._spill_outstanding -= 1
                    self._spill_lock.notify_all()
                tl.add("spill_copy", t0)
                continue
            del rows   # the copy is done: the device buffer may go
            self._d2h_hist.observe((time.perf_counter() - w0) * 1e3)
            with self._spill_lock:
                for i, (hpid, gen) in enumerate(entries):
                    cur = self._host_data.get(hpid)
                    if cur is None or cur <= gen:
                        self._host_slab[hpid - self._host_base].copy_(
                            xfer[i])
                        self._host_data[hpid] = gen
                self._spill_outstanding -= 1
                self._spill_lock.notify_all()
            tl.add("spill_copy", t0)

    def _release_page(self, pid: int) -> None:
        """Release one reference to a slot-mapped page. With the host
        tier a registered page's LAST reference becomes a spill pin
        instead of freeing: the page stays whole until
        :meth:`_drain_spills` moves it to the host at the next yield
        point."""
        if self._tiered and pid not in self._spill_pin and \
                self._alloc.refcount(pid) == 1 and \
                self._alloc.page_registered(pid):
            self._spill_pin[pid] = None
            return
        self._alloc.release(pid)
        if self._tiered:
            self._drop_evicted_host_data()

    def _drop_evicted_host_data(self) -> None:
        """Forget the published bytes of host pages the allocator
        evicted (LRU pressure, orphan sweep, failed spill) before their
        ids are reused. Generation-checked: if an evicted id was
        already recycled AND the writer already published the new
        residency, those bytes are live and stay."""
        evicted = self._alloc.pop_host_evicted()
        if not evicted:
            return
        with self._spill_lock:
            for hpid in evicted:
                gen = self._host_data.get(hpid)
                if gen is not None and \
                        gen != self._alloc.host_generation(hpid):
                    del self._host_data[hpid]

    def _reap_failed_spills(self) -> None:
        """Evict host pages whose stage failed on the writer (their
        bytes never reached host memory), dropping the registrations
        that point at them so no lookup hands out a page that cannot
        rehydrate. Main loop only."""
        with self._spill_lock:
            failed, self._spill_failed = self._spill_failed, []
        for hpid, gen in failed:
            # the failed residency may be gone and the id recycled:
            # never evict the successor
            if self._alloc.host_generation(hpid) == gen:
                self._alloc.evict_host(hpid)
                metrics.inc("serving/spill_failed")
        if failed:
            self._drop_evicted_host_data()

    def _take_row(self, hpid: int, dst: torch.Tensor) -> None:
        """Copy ``hpid``'s slab row into ``dst`` and forget its
        publication (the bytes move into the admitting request). Under
        _spill_lock."""
        dst.copy_(self._host_slab[hpid - self._host_base])
        del self._host_data[hpid]

    def _pop_host_bytes(self, hpid: int, gen: int,
                        dst: torch.Tensor) -> bool:
        """Copy the CURRENT residency of ``hpid`` into ``dst`` if the
        writer published it; False when not published. An entry of an
        older generation is a recycled id's stale spill whose publish
        raced the eviction drain: discard it and report a miss."""
        with self._spill_lock:
            cur = self._host_data.get(hpid)
            if cur is None:
                return False
            if cur != gen:
                del self._host_data[hpid]
                return False
            self._take_row(hpid, dst)
            return True

    def _outbox_page(self, hpid: int, gen: int) -> Optional[torch.Tensor]:
        """A page's device row from a writer item still in the spill
        outbox (a spill collected this step entry, shipped only after
        the surface lock releases): rehydrating straight from the
        packed buffer skips the host round trip. The item stays queued;
        its later publish of this residency is discarded by the
        generation guards once the promote recycles the id."""
        for entries, rows, _ in self._spill_outbox:
            for i, (h, g) in enumerate(entries):
                if h == hpid and g == gen:
                    return rows[i:i + 1]
        return None

    def _await_host_bytes(self, hpid: int, gen: int,
                          dst: torch.Tensor) -> bool:
        """Wait (admission time only, never between decode ticks) for
        the writer to publish the CURRENT residency of ``hpid`` and copy
        it into ``dst``. False once the bytes are known gone: the
        residency's failure was recorded, a fresher residency owns the
        id, the writer went idle with nothing published, or the wait
        timed out. Waits on the spill condition, which the writer
        publishes under without ever taking the surface lock."""
        deadline = time.monotonic() + self._SPILL_WAIT_S
        with self._spill_lock:
            while True:
                cur = self._host_data.get(hpid)
                if cur is not None:
                    if cur == gen:
                        self._take_row(hpid, dst)
                        return True
                    if cur < gen:
                        del self._host_data[hpid]   # stale: keep waiting
                    else:
                        return False   # this residency is dead
                elif (hpid, gen) in self._spill_failed:
                    return False
                elif self._spill_outstanding == 0:
                    return False
                if time.monotonic() >= deadline:
                    return False
                self._spill_lock.wait(timeout=0.05)

    def _drain_spills(self) -> None:
        """Collect every pinned spill into ONE writer item: per page,
        move its registrations to a host id and free the device page;
        then pack every live spilled page's KV in one batched gather and
        record its event, and append the item to the spill outbox. Runs
        under the surface lock at the step-entry yield point only; the
        public wrappers ship the outbox to the writer queue after
        releasing the lock (:meth:`_ship_spills`). Every
        ``serving_spill`` event pairs with the ``serving_yield`` that
        opened the drain. Freeing the page ids before the pack is safe:
        nothing allocates in between. A page whose host id the LRU
        evicted again within this batch is dead and is not packed."""
        if not self._tiered:
            return
        self._reap_failed_spills()
        if not self._spill_pin:
            return
        self._emit("serving_yield", ticks=self._ticks,
                   roundtrips=self._roundtrips,
                   pending_spills=len(self._spill_pin))
        spilled: List[Tuple[int, int, int]] = []
        while self._spill_pin:
            pid = next(iter(self._spill_pin))   # FIFO: oldest pin first
            del self._spill_pin[pid]
            if self._alloc.refcount(pid) > 1:
                # re-shared while pinned: drop the pin, stay on the card
                self._alloc.release(pid)
                continue
            hpid = self._alloc.spill(pid)
            if hpid is None:
                # registrations died while pinned; the release can
                # cascade host evictions of its own: drain them now
                self._alloc.release(pid)
                self._drop_evicted_host_data()
                continue
            gen = self._alloc.host_generation(hpid)
            self._drop_evicted_host_data()
            spilled.append((pid, hpid, gen))
            metrics.inc("serving/spill")
            self._emit("serving_spill", page=pid, host_page=hpid,
                       ticks=self._ticks, roundtrips=self._roundtrips)
        live = [(pid, hpid, gen) for pid, hpid, gen in spilled
                if self._alloc.host_generation(hpid) == gen]
        if live:
            rows = pack_kv_pages(self._cache, [p for p, _, _ in live])
            ready = None
            if self._copy_stream is not None:
                ready = torch.cuda.Event()
                ready.record()
            self._spill_outbox.append(
                ([(h, g) for _, h, g in live], rows, ready))
        metrics.get_registry().set_gauge("serving/host_pages",
                                         self._alloc.host_pages_resident)

    def _ship_spills(self) -> None:
        """Hand the writer items :meth:`_drain_spills` collected to the
        spill queue, after the surface lock is released."""
        if not self._tiered:
            return
        with self._surface_lock:
            items, self._spill_outbox = self._spill_outbox, []
        if not items:
            return
        with self._spill_lock:
            self._spill_outstanding += len(items)
        for item in items:
            self._spill_q.put(item)

    def _rehydrate_many(self, hpids: Sequence[int]) -> List[int]:
        """Bring N host-resident pages back onto the card in one batch:
        take (or await) every page's staged bytes, allocate N fresh
        page ids, copy the stacked rows to the device in ONE copy and
        write them with one indexed write per pool tensor
        (``unpack_kv_pages``), whatever N, then move each page's
        registrations back. Each fresh page's refcount-1 reference
        belongs to the admitting request; the callers check
        ``free_pages`` first. Raises :class:`_RehydrateMiss`, with every
        already-taken page's bytes put back, when a page's stage
        failed; the caller unwinds and retries cold."""
        if not hpids:
            return []
        t0 = time.time()
        if self._rehy_done is not None:
            # the transfer rows' last copy to the card must be done
            # before they are refilled
            self._rehy_done.synchronize()
            self._rehy_done = None
        host: List[Tuple[int, int]] = []         # in _rehy_xfer order
        dev: List[Tuple[int, int, torch.Tensor]] = []
        miss: Optional[int] = None
        for hpid in hpids:
            gen = self._alloc.host_generation(hpid)
            dst = self._rehy_xfer[len(host)]
            if self._pop_host_bytes(hpid, gen, dst):
                host.append((hpid, gen))
                continue
            row = self._outbox_page(hpid, gen)
            if row is not None:
                dev.append((hpid, gen, row))
                continue
            if self._await_host_bytes(hpid, gen, dst):
                host.append((hpid, gen))
                continue
            miss = hpid
            break
        if miss is not None:
            with self._spill_lock:
                for i, (hpid, gen) in enumerate(host):
                    self._host_slab[hpid - self._host_base].copy_(
                        self._rehy_xfer[i])
                    self._host_data[hpid] = gen
            # the one legitimate way here: the page's stage failed on
            # the writer after its lookup and before the failure was
            # reaped; reap now and let admission unwind. Anything else
            # is an invariant bug and fails loudly
            self._reap_failed_spills()
            if self._alloc.is_host(miss):
                raise RuntimeError(f"host page {miss} resident but its "
                                   f"bytes are gone")
            raise _RehydrateMiss(miss)
        parts = []
        if host:
            parts.append(self._rehy_xfer[:len(host)].to(
                self._device, non_blocking=True))
            if self._device.type == "cuda":
                self._rehy_done = torch.cuda.Event()
                self._rehy_done.record()
        parts += [row for _, _, row in dev]
        order = [(h, g) for h, g in host] + [(h, g) for h, g, _ in dev]
        pids = self._alloc.alloc_many(len(order))
        unpack_kv_pages(self._cache, stack_kv_rows(parts), pids)
        for (hpid, _), pid in zip(order, pids):
            self._alloc.promote(hpid, pid)
            self._emit("serving_rehydrate", host_page=hpid, page=pid,
                       ticks=self._ticks)
        out = dict(zip([h for h, _ in order], pids))
        metrics.inc("serving/rehydrate", len(pids))
        self._metrics.observe("serving/rehydrate_ms",
                              (time.time() - t0) * 1e3)
        metrics.get_registry().set_gauge("serving/host_pages",
                                         self._alloc.host_pages_resident)
        return [out[h] for h in hpids]

    # -- preemption and growth ------------------------------------------

    def _alloc_or_preempt(self, needy_slot: int) -> int:
        """A free page, preempting the youngest OTHER occupied slot
        (whole request back to the queue head, pages released) until
        one exists. A pinned to-be-spilled page is idle KV and goes
        first: reclaiming it costs one lost spill, never a preemption.
        The config guarantees a lone slot can always grow to its
        maximum length, so this terminates."""
        pid = self._alloc.try_alloc()
        while pid is None:
            if self._tiered and self._spill_pin:
                held = next(iter(self._spill_pin))
                del self._spill_pin[held]
                self._alloc.release(held)
                self._drop_evicted_host_data()
                pid = self._alloc.try_alloc()
                continue
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
        # the same root span survives the round trip: the running phase
        # ends and a fresh queue phase opens under the same trace id
        self._phase(req, "serving/queue", requeued=True)
        req["queue_t0"] = time.time()
        self._queue.appendleft(req)
        self._counts["preempted"] += 1
        metrics.inc("serving/preempted")
        self._emit("serving_preempt", request=req["id"], slot=victim,
                   reason="pages", tokens=len(req["tokens"]),
                   trace=self._trace_id(req))

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
                        self._release_page(pid)
                        self._pt[slot, j] = new
                        self._pt_dirty = True
                        self._alloc.stats["cow_splits"] += 1
                        metrics.inc("serving/cow_splits")
                        self._emit("serving_cow_split", request=req["id"],
                                   slot=slot, page=j, src=pid, dst=new)

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
        if reason == "preempted":
            self._counts["preempted"] += 1
            metrics.inc("serving/preempted")
        ft = req.get("first_tok_t")
        if ft is not None and len(req["tokens"]) > 1:
            # steady-state decode latency: the wall time past the first
            # token over the tokens it bought
            self._metrics.observe(
                "serving/tpot_ms",
                (time.time() - ft) * 1e3 / (len(req["tokens"]) - 1))
        self._end_request_spans(req, reason)
        self._emit("serving_evict", request=req["id"], slot=slot,
                   reason=reason, tokens=len(req["tokens"]),
                   trace=self._trace_id(req))
        return Completion(request_id=req["id"], prompt=req["prompt"],
                          tokens=req["tokens"], finish_reason=reason,
                          trace_id=self._trace_id(req),
                          ttft_ms=req.get("ttft_ms"))

    def preempt(self, request_id: int) -> Optional[Completion]:
        """Cancel a request (a client abort or a scheduler decision):
        evict its slot, or drop it from the queue, and return the
        partial completion (``preempted``). None when the id is unknown
        or already finished."""
        with self._surface_lock:
            return self._preempt_impl(request_id)

    def _preempt_impl(self, request_id: int) -> Optional[Completion]:
        for slot, req in enumerate(self._slots):
            if req is not None and req["id"] == request_id:
                return self._evict(slot, "preempted")
        for i, req in enumerate(self._queue):
            if req["id"] == request_id:
                del self._queue[i]
                self._counts["preempted"] += 1
                metrics.inc("serving/preempted")
                self._end_request_spans(req, "preempted")
                self._emit("serving_evict", request=request_id, slot=-1,
                           reason="preempted", tokens=len(req["tokens"]),
                           trace=self._trace_id(req))
                return Completion(request_id=request_id,
                                  prompt=req["prompt"],
                                  tokens=req["tokens"],
                                  finish_reason="preempted",
                                  trace_id=self._trace_id(req))
        return None

    # -- the restart-persistent prefix store ----------------------------
    #
    # A drained tiered server's shareable KV is all host-resident (every
    # registered page released to its last reference spilled).
    # export_prefix_store snapshots that tier (slab rows and the
    # registry entries that reach them) as a plain dict;
    # core/checkpoint.py's save / load_prefix_store round it through a
    # committed-last manifest directory, and a restarted server's
    # import_prefix_store serves its first requests warm.

    def _model_fingerprint(self) -> str:
        """Identity of the served model: a digest over the config and,
        per state-dict entry, its name, shape, dtype and fp32 sum (one
        reduction a tensor, one device read). Stamped into every
        exported prefix store and checked on import, so KV saved under
        one deploy never warm-starts different weights. Computed once
        and cached."""
        if self._model_fp is None:
            h = hashlib.sha256()
            cfg = dataclasses.asdict(self.model.config)
            h.update(json.dumps({k: str(v) for k, v in cfg.items()},
                                sort_keys=True).encode())
            state = self.model.state_dict()
            with torch.inference_mode():
                sums = torch.stack([t.sum(dtype=torch.float32)
                                    for t in state.values()]).cpu().numpy()
            for (name, t), s in zip(state.items(), sums):
                h.update(name.encode())
                h.update(str((tuple(t.shape), str(t.dtype))).encode())
                h.update(np.float32(s).tobytes())
            self._model_fp = h.hexdigest()[:16]
        return self._model_fp

    def _await_spill_writer(self) -> None:
        """Wait (bounded) for the writer to finish every shipped item:
        the prefix-store export's quiesce point, and the graph
        capture's (a capture admits no other stream's work)."""
        deadline = time.monotonic() + self._SPILL_WAIT_S
        with self._spill_lock:
            while self._spill_outstanding > 0 and \
                    time.monotonic() < deadline:
                self._spill_lock.wait(timeout=0.05)

    def export_prefix_store(self) -> Optional[dict]:
        """Snapshot the host tier for a restart warm start: drain any
        pending spill pins first, ship them and wait out the writer,
        and return the page rows (``{host id: [uint8 row]}``) plus the
        host-resident registry entries, the geometry and the model
        fingerprint. None on a server without the host tier."""
        with self._surface_lock:
            if not self.paged or not self._tiered:
                return None
            self._drain_spills()
        self._ship_spills()
        self._await_spill_writer()
        with self._surface_lock:
            return self._export_prefix_store_impl()

    def _export_prefix_store_impl(self) -> dict:
        # the quiesce flushed every publish and failure record: reap
        # now so dead pages drop out of the snapshot
        self._reap_failed_spills()
        prefixes, prompts = self._alloc.host_snapshot()
        needed = set(prefixes.values())
        for pages, _ in prompts.values():
            needed.update(pages)
        with self._spill_lock:
            data = {h: [self._host_slab[h - self._host_base].numpy().copy()]
                    for h in needed
                    if self._host_data.get(h) ==
                    self._alloc.host_generation(h)}
        store = {
            "page_size": self._page,
            "kv_cache_dtype": self.config.kv_cache_dtype,
            "model_fingerprint": self._model_fp,
            "pages": data,
            "prefixes": {k: h for k, h in prefixes.items() if h in data},
            "prompts": {k: (pages, payload.detach().float().cpu().numpy()
                            if torch.is_tensor(payload) else payload)
                        for k, (pages, payload) in prompts.items()
                        if all(p in data for p in pages)},
        }
        self._emit("serving_prefix_store_export", pages=len(store["pages"]),
                   prefixes=len(store["prefixes"]),
                   prompts=len(store["prompts"]))
        return store

    def import_prefix_store(self, store: Optional[dict]) -> int:
        """Adopt an exported prefix store on a fresh server (the restart
        warm start): fill free host rows with the saved pages and
        re-register their content keys, so the next admission of a
        covered prompt rehydrates instead of re-prefilling. A geometry
        mismatch (page size, KV dtype, row bytes) imports nothing, and
        so does a model-fingerprint mismatch: KV computed by different
        weights under the same geometry would scatter cleanly and serve
        wrong attention. Returns the pages adopted."""
        with self._surface_lock:
            return self._import_prefix_store_impl(store)

    def _import_prefix_store_impl(self, store: Optional[dict]) -> int:
        if not store or not self.paged or not self._tiered:
            return 0
        cfg = self.config
        rows_ok = all(len(leaves) == 1 and
                      np.asarray(leaves[0]).nbytes == self._row_bytes
                      for leaves in store.get("pages", {}).values())
        if store.get("page_size") != self._page or \
                store.get("kv_cache_dtype") != cfg.kv_cache_dtype or \
                not rows_ok:
            logger.warning(
                "prefix store geometry mismatch (page %s dtype %s vs page "
                "%d dtype %s, rows of %d bytes): starting cold",
                store.get("page_size"), store.get("kv_cache_dtype"),
                self._page, cfg.kv_cache_dtype, self._row_bytes)
            return 0
        fp = self._model_fp
        if store.get("model_fingerprint") != fp:
            logger.warning(
                "prefix store model fingerprint mismatch (%s vs %s): its "
                "KV was computed by different weights; starting cold",
                store.get("model_fingerprint"), fp)
            return 0
        remap: Dict[int, int] = {}

        def _adopt(old: int) -> Optional[int]:
            if old in remap:
                return remap[old]
            leaves = store["pages"].get(old)
            if leaves is None:
                return None
            hpid = self._alloc.host_import()
            if hpid is None:   # the tier is full: import what fits
                return None
            row = torch.from_numpy(
                np.ascontiguousarray(leaves[0]).view(np.uint8).reshape(-1))
            with self._spill_lock:
                self._host_slab[hpid - self._host_base].copy_(row)
                self._host_data[hpid] = self._alloc.host_generation(hpid)
            remap[old] = hpid
            return hpid

        for key, old in store.get("prefixes", {}).items():
            hpid = _adopt(old)
            if hpid is not None:
                self._alloc.register_prefix(key, hpid)
        for key, (pages, payload) in store.get("prompts", {}).items():
            new_pages = [_adopt(p) for p in pages]
            if all(p is not None for p in new_pages):
                last = torch.as_tensor(np.asarray(payload, np.float32),
                                       device=self._device)
                self._alloc.register_prompt(key, new_pages, last)
        # a page adopted for a prompt entry that then failed to remap
        # whole may be unreachable: evict such orphans now
        self._alloc.sweep_host_orphans()
        self._drop_evicted_host_data()
        adopted = self._alloc.host_pages_resident
        metrics.get_registry().set_gauge("serving/host_pages", adopted)
        self._emit("serving_prefix_store_import", pages=adopted,
                   prefixes=len(store.get("prefixes", {})),
                   prompts=len(store.get("prompts", {})))
        return adopted

    # -- the serving loop ---------------------------------------------

    def step(self) -> List[Completion]:
        """Admit what fits (unless draining), advance at most one prefill
        chunk (paged), tick every ACTIVE slot (one token plain, 1..k+1
        committed tokens speculative; with ``device_loop_ticks > 1`` up
        to that many ticks in one round trip, :meth:`_step_loop`), then
        evict and return whatever finished, deadline-expired requests
        and failed admissions included. Pinned spills move to the host
        tier at its start, the one yield point; the writer items are
        shipped after the surface lock is released."""
        with self._surface_lock:
            out = [] if self._closed else self._step_impl()
        self._ship_spills()
        return out

    def _step_impl(self) -> List[Completion]:
        step_t0 = time.time()
        expired = self._expire_deadlines()
        if self._faults is not None:
            self._faults.fire("tick", self._ticks + 1)
        # the host yield point: between device launches is the only
        # place pinned spills move to the host tier
        self._drain_spills()
        if not self._draining:
            self._admit()
        reg = metrics.get_registry()
        if self.paged:
            self._prefill_pump()
            reg.set_gauge("serving/pages_in_use", self._alloc.pages_in_use)
        live = [s for s, r in enumerate(self._slots)
                if r is not None and (not self.paged or r.get("active"))]
        if not live:
            reg.set_gauge("serving/slot_occupancy", self.occupancy)
            self._refresh_health()
            return expired + self._take_dead()
        if self._watchdog is not None:
            self._watchdog.arm(
                tag=f"tick {self._ticks + 1}" if self._loop_ticks == 1 else
                f"ticks {self._ticks + 1}..{self._ticks + self._loop_ticks}")
        if self._loop_ticks > 1:
            done = self._step_loop(live)
        else:
            done = self._step_one(live)
        if self._watchdog is not None:
            self._watchdog.disarm()
        reg.set_gauge("serving/slot_occupancy", self.occupancy)
        # one round trip's whole host cost: admission, drafting, the
        # launch, the read back and the replay of its ticks
        self._roundtrips += 1
        self._metrics.observe("serving/host_roundtrip_ms",
                              (time.time() - step_t0) * 1e3)
        self._refresh_health()
        return expired + self._take_dead() + done

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

    def _step_one(self, live: List[int]) -> List[Completion]:
        """The ``device_loop_ticks = 1`` body of :meth:`step`: one tick,
        one read of the device."""
        reg = metrics.get_registry()
        t0 = time.time()
        with reg.timer("serving/decode_tick"):
            # each tick ends in a device->host copy of its tokens, so
            # the timer covers the tick's device work
            window, counts = self._tick(live)
        now = time.time()
        self._tick_time += now - t0
        self._metrics.observe("serving/tick_ms", (now - t0) * 1e3)
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
                self._first_token(req, now)
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
        self._emit("serving_spec", drafted=drafted, accepted=accepted,
                   committed=committed)

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
    # tick only while it has scheduling work, so chunked prefill,
    # admission, drain and the spill drain keep their
    # one-unit-of-progress-per-step cadence.

    def _loop_host_flag(self, live: List[int]) -> bool:
        """Should the loop hand control back after ONE tick? While
        draining (drain()'s tick bound counts step calls), while any
        request is queued (a full-T launch would defer its admission,
        deadline and shed decisions by T ticks), while a chunked
        prefill is unfinished (paged), while spill pins wait for the
        next yield point, or when the page pool cannot cover every live
        slot's T-tick write window without preempting (better one short
        loop than an avoidable preemption)."""
        if self._draining or self._queue:
            return True
        if not self.paged:
            return False
        if self._prefilling:
            return True
        if self._tiered and self._spill_pin:
            # pinned spills drain at step entry: exit after one tick so
            # the writer gets its work this round trip
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
        t0 = time.time()
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
            if self._tiered and not graph.captured:
                # a capture admits no other stream's work: the writer's
                # shipped copies finish first
                self._await_spill_writer()
            self._aid_arg()
            reset_loop_carry(carry, self.gen_cfg, host_flag, drafts)
            graph.replay(n)
            tokens, counts, n_ticks, exit_code = read_loop(
                self._state, carry, self.gen_cfg)
        loop_s = time.time() - t0
        self._tick_time += loop_s
        per_tick_s = loop_s / n_ticks
        for _ in range(n_ticks):
            self._metrics.observe("serving/tick_ms", per_tick_s * 1e3)
        self._ticks += n_ticks
        metrics.inc("serving/device_ticks", n_ticks)
        metrics.inc(
            "serving/loop_exit/finished" if exit_code == LOOP_EXIT_FINISHED
            else "serving/loop_exit/budget" if exit_code == LOOP_EXIT_BUDGET
            else "serving/loop_exit/drain" if self._draining
            else "serving/loop_exit/admission")
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
                    self._first_token(req, t_j)
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

    # -- drain and shutdown ----------------------------------------------

    def drain(self, max_ticks: Optional[int] = None) -> List[Completion]:
        """Graceful shutdown: stop admitting, return every QUEUED request
        at once as a ``preempted`` partial (its tokens kept), tick the
        in-flight slots to completion (at most ``max_ticks`` steps; the
        survivors are then preempted too) and return every completion.
        ``max_ticks=0`` preempts everything at once. Partials re-enter a
        fresh server through ``submit(resume_tokens=...)`` with no
        committed token lost."""
        with self._surface_lock:
            out = self._drain_impl(max_ticks)
        self._ship_spills()
        return out

    def _drain_impl(self, max_ticks: Optional[int]) -> List[Completion]:
        if not self._draining:
            self._draining = True
            self._refresh_health()
            self._emit("serving_drain_start", signum=None,
                       pending=self.pending, occupancy=self.occupancy)
        out: List[Completion] = self._flush_queue()
        ticks = 0
        while not self._closed and self.occupancy and \
                (max_ticks is None or ticks < max_ticks):
            out.extend(self.step())
            ticks += 1
        for slot in range(self.num_slots):
            if self._slots[slot] is not None:
                out.append(self._evict(slot, "preempted"))
        # a pool-exhaustion preemption during the ticks requeued to the
        # (no longer admitting) queue: hand those back too
        out.extend(self._flush_queue())
        out.extend(self._take_dead())
        self._refresh_health()
        self._emit("serving_drain_end", completions=len(out), ticks=ticks)
        return out

    def _flush_queue(self) -> List[Completion]:
        """Every queued request back to its client as a ``preempted``
        partial (committed tokens kept)."""
        out: List[Completion] = []
        while self._queue:
            req = self._queue.popleft()
            self._counts["preempted"] += 1
            metrics.inc("serving/preempted")
            self._end_request_spans(req, "preempted")
            self._emit("serving_evict", request=req["id"], slot=-1,
                       reason="preempted", tokens=len(req["tokens"]),
                       trace=self._trace_id(req))
            out.append(Completion(request_id=req["id"],
                                  prompt=req["prompt"],
                                  tokens=req["tokens"],
                                  finish_reason="preempted",
                                  trace_id=self._trace_id(req),
                                  ttft_ms=req.get("ttft_ms")))
        return out

    def close(self) -> None:
        """Detach the OS-level hooks: stop the spill writer and the
        watchdog, restore the SIGTERM handler ``drain_on_sigterm``
        replaced and close the flight recorder. Marks the server closed
        (a racing step() returns []). Idempotent."""
        with self._surface_lock:
            self._closed = True
        # the last collected spills still reach the writer before the
        # sentinel below stops it
        self._ship_spills()
        if self._watchdog is not None:
            self._watchdog.stop()
        if self._tiered and self._spill_writer_thread is not None:
            self._spill_q.put(None)
            self._spill_writer_thread.join(timeout=10.0)
            self._spill_writer_thread = None
        if self._sigterm_installed:
            signal.signal(signal.SIGTERM, self._prev_sigterm)
            self._sigterm_installed = False
        if self._recorder is not None:
            self._recorder.close()

    def run(self, prompts: Sequence[Sequence[int]],
            adapter_ids: Optional[Sequence[int]] = None
            ) -> List[Completion]:
        """Serve prompts to completion; completions return in submission
        order. ``adapter_ids`` pairs each prompt with a LoRA adapter (0,
        the default, the base model). A drain (a SIGTERM under
        ``drain_on_sigterm``, or a concurrent :meth:`drain`) ends the
        loop early with partials in place of unfinished requests."""
        if adapter_ids is None:
            adapter_ids = [0] * len(prompts)
        ids = [self.submit(p, adapter_id=a)
               for p, a in zip(prompts, adapter_ids)]
        done: Dict[int, Completion] = {}
        while self.pending or self.occupancy:
            if self.draining:
                for c in self.drain():
                    done[c.request_id] = c
                break
            for c in self.step():
                done[c.request_id] = c
        return [done[i] for i in ids]

    def summary(self) -> dict:
        """Counters, decode tokens/s (committed tokens over tick time),
        device ticks against host round trips, and TTFT, queue-wait,
        TPOT, tick, round-trip and rehydrate p50 / p99 over the
        server's lifetime (host clock, from the log-bucketed histograms:
        within a bucket's ~8% relative width of the exact percentile);
        paged servers add the pool's occupancy and the allocator's
        sharing and tier stats, speculative ones the draft and accept
        counts. Also emitted to the flight recorder."""
        with self._surface_lock:
            return self._summary_impl()

    def _summary_impl(self) -> dict:
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
        for prefix, series in _LATENCY_SERIES:
            h = self._metrics.histogram(series)
            if h is not None and h.count:
                s[f"{prefix}_p50_ms"] = h.percentile(50)
                s[f"{prefix}_p99_ms"] = h.percentile(99)
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
            if self._tiered:
                s["tiered"] = True
                s["host_pool_bytes"] = self._host_pool_bytes
                s["host_pages_cap"] = self._alloc.host_pages
                s["host_pages"] = self._alloc.host_pages_resident
                s["host_slab_bytes"] = self._slab_bytes
                if self._d2h_hist.count:
                    s["spill_d2h_p50_ms"] = self._d2h_hist.percentile(50)
                    s["spill_d2h_p99_ms"] = self._d2h_hist.percentile(99)
            s.update(self._alloc.stats)
        self._emit("serving_summary", **s)
        return s
