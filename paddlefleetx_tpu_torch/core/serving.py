"""Continuous-batching generation server (the port of the JAX package's
``core/serving.py::GenerationServer``, contiguous mode).

A persistent ``[slots, heads, capacity, head_dim]`` KV cache lives on
the card; the host owns a request queue, admits each request into a
free slot with a bucketed prefill (``prefill_into_slots``: powers of
two from 16 up to the longest admissible prompt), ticks every occupied
slot one token per :meth:`GenerationServer.step` (``decode_step``, the
ragged decode kernel) and evicts finished slots between ticks, so new
requests ride in as soon as a slot frees. Greedy completions equal the
lockstep ``generate()`` rows, whatever the slot count, admission order
or prompt-length mix.

Telemetry: the ``serving/admitted``, ``serving/evicted`` and
``serving/decode_tokens`` counters, the ``serving/slot_occupancy``
gauge and the ``serving/decode_tick`` timer in the process-global
registry (names as in the JAX package's ``docs/inference.md``), and a
:meth:`GenerationServer.summary` with decode tokens/s and TTFT
percentiles. Not ported yet (asking for them raises
``NotImplementedError``): paged KV and prefix sharing, chunked prefill,
the host KV tier, speculative decoding, device-resident decode loops,
LoRA adapters, deadlines, queue shedding, SIGTERM drain, fault
injection and the event trace.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.gpt.generation import (
    GenerationConfig, decode_step, init_slot_cache, init_slot_state,
    prefill_into_slots,
)
from ..models.gpt.model import GPTForPretraining
from ..observability import metrics
from ..utils.log import logger


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
    #: "eos" | "length" (hit max_dec_len)
    finish_reason: str
    #: time to first token in ms
    ttft_ms: Optional[float] = None


class GenerationServer:
    """Host-side queue / admit / evict loop around the slot primitives.

    Args:
        model (GPTForPretraining): the port's model, on the device the
            server runs on.
        gen_cfg (GenerationConfig): sampling or greedy_search.
        num_slots (int): concurrent requests (KV-cache rows).
        prefill_buckets (Sequence[int]): prompt-length buckets
            (default :func:`default_prefill_buckets`).
        seed (int): sampling seed; request ``r`` draws its step ``t``
            with ``stream_seed(seed, nonce_r, t)``.
    """

    def __init__(self, model: GPTForPretraining, gen_cfg: GenerationConfig,
                 num_slots: int = 4,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 seed: int = 0, **unported):
        if unported:
            raise NotImplementedError(
                f"GenerationServer options not ported to the PyTorch "
                f"package yet: {sorted(unported)} (this slice serves the "
                f"contiguous cache, one tick per step)")
        if gen_cfg.decode_strategy == "beam_search":
            raise ValueError("GenerationServer serves sampling/"
                             "greedy_search; beam search stays on the "
                             "lockstep path")
        if gen_cfg.spec_method is not None:
            raise NotImplementedError(
                "speculative decoding is not ported yet")
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        cfg = model.config
        self.model = model
        self.gen_cfg = gen_cfg
        self.num_slots = num_slots
        self.seed = int(seed)
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
        self._cache = init_slot_cache(model, num_slots)
        self._state = init_slot_state(num_slots, cfg.vocab_size,
                                      self._device)
        self._queue: deque = deque()
        self._slots: List[Optional[dict]] = [None] * num_slots
        self._next_id = 0
        self._nonce = 0
        self._counts = {"admitted": 0, "evicted": 0}
        self._ticks = 0
        self._decode_tokens = 0
        self._tick_time = 0.0
        self._ttft_ms: List[float] = []
        self._tick_ms: List[float] = []
        logger.info("GenerationServer: %d slots, prefill buckets %s, "
                    "capacity %d on %s", num_slots, list(buckets),
                    cfg.cache_capacity, self._device)

    @property
    def occupancy(self) -> int:
        """Number of slots currently holding a live request."""
        return sum(s is not None for s in self._slots)

    @property
    def pending(self) -> int:
        """Number of submitted requests still waiting for a slot."""
        return len(self._queue)

    def submit(self, prompt: Sequence[int],
               nonce: Optional[int] = None) -> int:
        """Queue a request and return its id.

        Raises ``ValueError`` for an empty prompt or one that can never
        fit (``prompt + max_dec_len > max_position_embeddings``).
        ``nonce`` overrides the server's per-request sampling-stream
        counter (submission order by default).
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
        if nonce is None:
            nonce = self._nonce
            self._nonce += 1
        rid = self._next_id
        self._next_id += 1
        self._queue.append({"id": rid, "prompt": prompt, "tokens": [],
                            "nonce": int(nonce),
                            "submit_t": time.perf_counter()})
        return rid

    def _bucket_for(self, n: int) -> int:
        return next(b for b in self._buckets if b >= n)

    def _admit(self) -> None:
        """Move queued requests into free slots, one prefill each."""
        while self._queue and None in self._slots:
            req = self._queue.popleft()
            slot = self._slots.index(None)
            seq = req["prompt"]
            bucket = self._bucket_for(len(seq))
            row = np.full((1, bucket), self.gen_cfg.pad_token_id, np.int64)
            row[0, :len(seq)] = seq
            prefill_into_slots(self.model, self._cache, self._state, [slot],
                               torch.as_tensor(row, device=self._device),
                               [len(seq)], [req["nonce"]])
            self._slots[slot] = req
            self._counts["admitted"] += 1
            metrics.inc("serving/admitted")

    def _evict(self, slot: int, reason: str) -> Completion:
        req = self._slots[slot]
        self._slots[slot] = None
        self._state.active[slot] = False
        self._state.finished[slot] = False
        self._counts["evicted"] += 1
        metrics.inc("serving/evicted")
        return Completion(request_id=req["id"], prompt=req["prompt"],
                          tokens=req["tokens"], finish_reason=reason,
                          ttft_ms=req.get("ttft_ms"))

    def step(self) -> List[Completion]:
        """Admit what fits, tick every occupied slot one token, then
        evict and return whatever finished."""
        self._admit()
        live = [s for s, r in enumerate(self._slots) if r is not None]
        if not live:
            return []
        reg = metrics.get_registry()
        t0 = time.perf_counter()
        with reg.timer("serving/decode_tick"):
            # decode_step ends in a device->host copy of the tokens, so
            # the timer covers the tick's device work
            tokens = decode_step(self.model, self._cache, self._state,
                                 self.gen_cfg, self.seed)
        now = time.perf_counter()
        self._tick_time += now - t0
        self._tick_ms.append((now - t0) * 1e3)
        self._ticks += 1
        done: List[Completion] = []
        for slot in live:
            req = self._slots[slot]
            req["tokens"].append(tokens[slot])
            if "ttft_ms" not in req:
                req["ttft_ms"] = (now - req["submit_t"]) * 1e3
                self._ttft_ms.append(req["ttft_ms"])
            if self._state.finished[slot]:
                done.append(self._evict(slot, "eos"))
            elif self._state.dec_count[slot] >= self.gen_cfg.max_dec_len:
                done.append(self._evict(slot, "length"))
        self._decode_tokens += len(live)
        metrics.inc("serving/decode_tokens", len(live))
        reg.set_gauge("serving/slot_occupancy", self.occupancy)
        return done

    def run(self, prompts: Sequence[Sequence[int]]) -> List[Completion]:
        """Serve prompts to completion; completions return in submission
        order."""
        ids = [self.submit(p) for p in prompts]
        done: Dict[int, Completion] = {}
        while self.pending or self.occupancy:
            for c in self.step():
                done[c.request_id] = c
        return [done[i] for i in ids]

    def summary(self) -> dict:
        """Counters, decode tokens/s and TTFT / tick-time percentiles
        over the server's lifetime (host clock; each tick ends in a
        device sync)."""
        s = {"slots": self.num_slots, "occupancy": self.occupancy,
             "pending": self.pending, "decode_ticks": self._ticks,
             "decode_tokens": self._decode_tokens,
             "decode_time_sec": self._tick_time,
             "tokens_per_sec": self._decode_tokens / self._tick_time
             if self._tick_time > 0 else 0.0, **self._counts}
        for name, series in (("ttft", self._ttft_ms),
                             ("tick", self._tick_ms)):
            if series:
                s[f"{name}_p50_ms"] = float(np.percentile(series, 50))
                s[f"{name}_p99_ms"] = float(np.percentile(series, 99))
        return s
