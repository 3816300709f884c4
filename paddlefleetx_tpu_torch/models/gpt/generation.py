"""Autoregressive generation with a fixed-capacity KV cache (the port of
the JAX package's ``models/gpt/generation.py``): the lockstep
:func:`generate` and the continuous-batching slot primitives the server
(``core/serving.py``) drives.

- :func:`generate` takes left-padded prompts, prefills them through the
  flash forward kernel (pad keys masked by a ``[b, 1, 1, prompt]``
  bias), then decodes every row at one shared cache index through
  ``flash_decode`` (shared offset + the ``[b, 1, 1, capacity]``
  validity bias). Greedy and sampling; beam search is not ported yet.
  An MoE model routes each row of the batch as one group, its pads
  first, as the JAX ``generate()`` does: its prefill takes the JAX
  package's cached-prefill mask whole, as one ``[b, 1, prompt,
  prompt]`` bias (:func:`prefill_bias`), so that its pad rows are the
  JAX rows.
- The slot primitives keep a persistent ``[slots, ...]`` cache whose
  rows are independent requests at independent lengths:
  :func:`prefill_into_slots` admits requests into free rows (right
  padded to a bucket; causality masks the pad tail),
  :func:`decode_step` advances every slot one token through the ragged
  decode kernel with per-slot offsets, and :func:`verify_step` (the
  speculative tick) scores a drafted window per slot in one forward
  through the verify kernel and commits each slot's accepted prefix.
- Under paged serving the cache is a global page pool
  (:func:`init_page_pool`) reached through a page table: both ticks
  take the table, :func:`prefill_chunk_paged` runs one page-aligned
  prefill chunk, :func:`copy_kv_pages` is the copy half of a
  copy-on-write split and :func:`activate_slot` flips an admitted slot
  live from host-computed state.

All paths sample from the same processor pipeline (repetition
penalty, min-length, temperature, exact top-k / top-p). Sampling draws
from a ``torch.Generator`` seeded per (seed, stream, step): the row
index in :func:`generate`, the request nonce in the server, so a
request's sample depends on neither its slot nor its neighbours; the
verify tick's accept test draws its uniform from the same keys with a
salt (:func:`accept_uniform`). The numbers differ from the JAX
package's ``jax.random`` streams; greedy decoding is token-exact
against it. The cache is updated in place. Every function here runs
under ``torch.inference_mode`` (serving needs no autograd, and the
mode drops its bookkeeping from each of a tick's launches); the slot
state it returns holds inference tensors, which only these functions
write.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import GPTConfig
from .model import (
    GPTForPretraining, KVCache, init_kv_cache, init_kv_pool, tied_logits,
)
from .processors import (
    NEG_INF, min_length_processor, repetition_penalty_processor,
    top_k_top_p_filter,
)

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Knobs named as in the reference YAML ``Generation`` section (the
    JAX package's fields). Not ported yet: ``beam_search``
    (``generate`` raises). ``spec_method`` (``"ngram"`` or None) and
    ``spec_tokens`` turn speculative decoding on in the server.
    ``approx_top_k`` is accepted; the port's top-k is always exact,
    which meets the approximate filter's superset contract."""

    max_dec_len: int = 20
    min_dec_len: int = 0
    decode_strategy: str = "sampling"
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    num_beams: int = 1
    num_beam_groups: int = 1
    diversity_rate: float = 0.0
    length_penalty: float = 0.0
    repetition_penalty: float = 1.0
    num_return_sequences: int = 1
    eos_token_id: int = 50256
    pad_token_id: int = 50256
    approx_top_k: bool = True
    spec_method: Optional[str] = None
    spec_tokens: int = 4

    def __post_init__(self):
        if self.spec_method is not None:
            if self.spec_method not in ("ngram",):
                raise ValueError(
                    f"unknown spec_method {self.spec_method!r} "
                    f"(supported: 'ngram')")
            if self.spec_tokens < 1:
                raise ValueError(
                    f"spec_tokens must be >= 1, got {self.spec_tokens}")
            if self.decode_strategy == "beam_search":
                raise ValueError(
                    "speculative decoding (spec_method) serves "
                    "sampling/greedy_search only; beam search stays on "
                    "the lockstep generate() path")
        if self.decode_strategy not in ("sampling", "greedy_search",
                                        "beam_search"):
            raise ValueError(
                f"unknown decode_strategy {self.decode_strategy!r}")
        if self.num_return_sequences < 1:
            raise ValueError(f"num_return_sequences must be >= 1, got "
                             f"{self.num_return_sequences}")
        if self.max_dec_len < 1:
            raise ValueError(f"max_dec_len must be >= 1, got "
                             f"{self.max_dec_len}")

    @classmethod
    def from_config(cls, section) -> "GenerationConfig":
        """Build from a YAML ``Generation`` section (unknown keys, such
        as ``vocab_dir``, are ignored)."""
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in dict(section or {}).items()
                      if k in fields and v is not None})


def left_pad_batch(sequences, pad_id: int):
    """Left-pad id lists to their max length: ``(ids [b, L] int32,
    mask [b, L] int32)`` numpy arrays, mask 1 on real tokens."""
    max_len = max(len(s) for s in sequences)
    ids = np.full((len(sequences), max_len), pad_id, np.int32)
    mask = np.zeros((len(sequences), max_len), np.int32)
    for i, s in enumerate(sequences):
        if len(s) == 0:
            raise ValueError("empty prompt")
        ids[i, max_len - len(s):] = s
        mask[i, max_len - len(s):] = 1
    return ids, mask


def stream_seed(*keys: int) -> int:
    """A 63-bit generator seed from integer keys (splitmix64 rounds), so
    (seed, stream, step) triples give independent draws."""
    x = 0x9E3779B97F4A7C15
    for key in keys:
        x = ((x ^ (int(key) & _MASK64)) * 0xBF58476D1CE4E5B9) & _MASK64
        x ^= x >> 31
        x = (x * 0x94D049BB133111EB) & _MASK64
        x ^= x >> 29
    return x & ((1 << 63) - 1)


def _decode_bias(valid: torch.Tensor) -> torch.Tensor:
    """``[b, kv]`` validity -> additive ``[b, 1, 1, kv]`` fp32 bias."""
    return torch.where(valid, 0.0, NEG_INF).to(torch.float32)[:, None,
                                                                None, :]


def prefill_bias(valid: torch.Tensor) -> torch.Tensor:
    """The mask of the lockstep prefill over a left-padded batch as one
    additive fp32 ``[b, 1, s, s]`` bias, from the ``[b, s]`` validity of
    its keys: the JAX package's cached prefill (its dense route) fills
    the causally masked scores with ``NEG_INF`` and then adds the pad
    bias, so a pad query, whose causal keys are all pads, spreads its
    weight evenly over its earlier pads and every real key, and that
    row then takes expert capacity in an MoE block. The same sums here
    (``s + NEG_INF`` rounds to ``NEG_INF`` in fp32) make the port's pad
    rows the JAX rows; a real query's masked keys weigh 0 either way.
    The prefill takes it with ``causal=False``."""
    s = valid.shape[-1]
    live = torch.ones((s, s), dtype=torch.bool,
                      device=valid.device).tril()
    fill = torch.where(live, 0.0, NEG_INF).to(torch.float32)
    return fill + _decode_bias(valid)


def _processed(logits: torch.Tensor, appeared: torch.Tensor, dec_count,
               gen_cfg: GenerationConfig) -> torch.Tensor:
    """Repetition penalty over ``appeared``, then min-length over
    ``dec_count`` (an int or a ``[b, 1]`` tensor)."""
    logits = repetition_penalty_processor(logits, appeared,
                                          gen_cfg.repetition_penalty)
    return min_length_processor(logits, dec_count, gen_cfg.min_dec_len,
                                gen_cfg.eos_token_id)


def _filtered(logits: torch.Tensor, gen_cfg: GenerationConfig
              ) -> torch.Tensor:
    """Temperature, then the top-k / top-p filter (sampling)."""
    logits = logits / max(gen_cfg.temperature, 1e-6)
    return top_k_top_p_filter(logits, gen_cfg.top_k, gen_cfg.top_p)


def next_token(logits: torch.Tensor, appeared: torch.Tensor, dec_count,
               gen_cfg: GenerationConfig, seeds: Sequence[int],
               rejected: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Pick one token per row: repetition penalty over ``appeared``,
    min-length over ``dec_count`` (tokens generated so far: an int or a
    ``[b, 1]`` tensor), then argmax (greedy) or a draw from the
    temperature-scaled, top-k / top-p filtered distribution with row
    ``i``'s generator seeded by ``seeds[i]``. Under sampling,
    ``rejected[i] >= 0`` is a draft the previous verify tick rejected,
    masked out after the filter (the rejection-sampling residual);
    ``-1`` masks nothing."""
    logits = _processed(logits, appeared, dec_count, gen_cfg)
    if gen_cfg.decode_strategy == "greedy_search":
        return torch.argmax(logits, dim=-1)
    if gen_cfg.decode_strategy != "sampling":
        raise NotImplementedError(
            f"decode_strategy {gen_cfg.decode_strategy!r} is not ported "
            f"(greedy_search and sampling are)")
    logits = _filtered(logits, gen_cfg)
    if rejected is not None and any(r >= 0 for r in rejected):
        rej = torch.as_tensor(list(rejected), device=logits.device)
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(vocab[None, :] == rej[:, None],
                             torch.full_like(logits, NEG_INF), logits)
    probs = torch.softmax(logits, dim=-1)
    picks = []
    for row, seed in enumerate(seeds):
        gen = torch.Generator(device=logits.device).manual_seed(seed)
        picks.append(torch.multinomial(probs[row], 1, generator=gen))
    return torch.cat(picks)


def _last_logits(model: GPTForPretraining, hidden: torch.Tensor
                 ) -> torch.Tensor:
    return tied_logits(hidden, model.word_embeddings).float()


@torch.inference_mode()
def generate(model: GPTForPretraining, input_ids, attention_mask,
             gen_cfg: GenerationConfig, seed: int = 0) -> torch.Tensor:
    """Lockstep generation: ``[b * num_return_sequences, max_dec_len]``
    token ids (int64, on the model's device; rows of one prompt are
    adjacent), pad after a row's EOS.

    Args:
        model (GPTForPretraining): the port's model.
        input_ids: left-padded ``[b, prompt_len]`` ids.
        attention_mask: 1 on real tokens, 0 on pads (None: no pads).
        gen_cfg (GenerationConfig): the decode strategy and limits.
        seed (int): sampling seed (row ``i``'s step ``t`` draws with
            ``stream_seed(seed, i, t)``).
    """
    if gen_cfg.decode_strategy == "beam_search":
        raise NotImplementedError("beam search is not ported yet")
    cfg: GPTConfig = model.config
    dev = model.word_embeddings.device
    ids = torch.as_tensor(np.asarray(input_ids), device=dev).long()
    mask = torch.ones_like(ids) if attention_mask is None else \
        torch.as_tensor(np.asarray(attention_mask), device=dev).long()
    n = gen_cfg.num_return_sequences
    if n > 1:
        ids = ids.repeat_interleave(n, dim=0)
        mask = mask.repeat_interleave(n, dim=0)
    b, prompt_len = ids.shape
    if prompt_len + gen_cfg.max_dec_len > cfg.max_position_embeddings:
        raise ValueError(
            f"prompt ({prompt_len}) + max_dec_len ({gen_cfg.max_dec_len}) "
            f"exceeds max_position_embeddings "
            f"{cfg.max_position_embeddings}")
    real = mask > 0
    lengths = mask.sum(dim=-1)
    position_ids = (torch.cumsum(mask, dim=-1) - 1).clamp(min=0)
    valid = torch.zeros((b, cfg.cache_capacity), dtype=torch.bool,
                        device=dev)
    valid[:, :prompt_len] = real
    cache = init_kv_cache(cfg, b, dev)
    # a dense model's pad rows feed no real row; an MoE model's take
    # expert capacity, so they must be the JAX rows
    moe = bool(cfg.moe_num_experts)
    bias = prefill_bias if moe else _decode_bias
    hidden = model.gpt(ids, position_ids,
                       attn_bias=bias(valid[:, :prompt_len]), cache=cache,
                       causal=not moe)
    logits = _last_logits(model, hidden[:, -1])
    rows = torch.arange(b, device=dev)
    appeared = torch.zeros((b, cfg.vocab_size), dtype=torch.bool,
                           device=dev)
    appeared[rows[:, None].expand_as(ids)[real], ids[real]] = True
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    out = []
    for step in range(gen_cfg.max_dec_len):
        token = next_token(logits, appeared, step, gen_cfg,
                           [stream_seed(seed, i, step) for i in range(b)])
        token = torch.where(finished, gen_cfg.pad_token_id, token)
        finished |= token == gen_cfg.eos_token_id
        appeared[rows, token] = True
        out.append(token)
        if step + 1 == gen_cfg.max_dec_len:
            break
        slot = prompt_len + step
        valid[:, slot] = True
        hidden = model.gpt(token[:, None], (lengths + step)[:, None],
                           attn_bias=_decode_bias(valid), cache=cache,
                           decode_offset=slot)
        logits = _last_logits(model, hidden[:, -1])
    return torch.stack(out, dim=1)


# -- continuous-batching slot primitives -------------------------------


@dataclasses.dataclass
class SlotState:
    """Per-slot decode state carried across serving ticks: the
    per-request scalars on the host, the vocabulary-wide rows on the
    device."""

    #: valid cache positions per slot (the slot's token count)
    lengths: List[int]
    #: tokens generated so far per slot (the lockstep step index)
    dec_count: List[int]
    #: per-request sampling stream id
    nonce: List[int]
    #: slot emitted EOS
    finished: List[bool]
    #: slot holds a live request
    active: List[bool]
    #: ``[slots, V]`` bool — the repetition-penalty token sets
    appeared: torch.Tensor
    #: ``[slots, V]`` fp32 — logits the next tick samples from
    last_logits: torch.Tensor
    #: draft token the previous verify tick REJECTED under sampling (-1
    #: = none): the next tick's draw from ``last_logits`` masks it out
    #: (the rejection-sampling residual). Always -1 under greedy and
    #: with speculation off.
    rejected: List[int]


def init_slot_state(num_slots: int, vocab_size: int,
                    device: torch.device) -> SlotState:
    """All-free slot state (no request admitted anywhere)."""
    return SlotState(
        lengths=[0] * num_slots, dec_count=[0] * num_slots,
        nonce=[0] * num_slots, finished=[False] * num_slots,
        active=[False] * num_slots,
        appeared=torch.zeros((num_slots, vocab_size), dtype=torch.bool,
                             device=device),
        last_logits=torch.zeros((num_slots, vocab_size),
                                dtype=torch.float32, device=device),
        rejected=[-1] * num_slots)


def init_slot_cache(model: GPTForPretraining, num_slots: int) -> KVCache:
    """The zeroed persistent ``[slots, heads, capacity, head_dim]``
    per-layer cache on the model's device (int8 plus ``[slots, heads,
    capacity]`` scales under the int8 cache, ``model.init_kv_cache``)."""
    return init_kv_cache(model.config, num_slots,
                         model.word_embeddings.device)


@torch.inference_mode()
def prefill_into_slots(model: GPTForPretraining, cache: KVCache,
                       state: SlotState, slot_ids: Sequence[int],
                       input_ids: torch.Tensor, true_lengths: Sequence[int],
                       nonces: Sequence[int],
                       adapter_ids: Optional[torch.Tensor] = None) -> None:
    """Admit requests into free slots, in place: prefill the RIGHT-padded
    ``input_ids [n, bucket]`` (prompts start at cache position 0; the
    pad tail past ``true_lengths`` is causally masked during prefill and
    length-masked during decode) straight into cache rows ``slot_ids``,
    and set those slots' state from each row's last real token.
    ``adapter_ids [n]`` (int32 LoRA bank rows) tint each row's KV and
    logits with its adapter; None serves the base model."""
    dev = model.word_embeddings.device
    n, bucket = input_ids.shape
    rows = torch.as_tensor(list(slot_ids), device=dev)
    hidden = model.gpt(input_ids, cache=cache, cache_rows=rows,
                       adapter_ids=adapter_ids)
    last = torch.as_tensor([t - 1 for t in true_lengths], device=dev)
    state.last_logits[rows] = _last_logits(
        model, hidden[torch.arange(n, device=dev), last])
    real = torch.arange(bucket, device=dev)[None, :] < \
        torch.as_tensor(list(true_lengths), device=dev)[:, None]
    appeared = torch.zeros((n, model.config.vocab_size), dtype=torch.bool,
                           device=dev)
    appeared[torch.arange(n, device=dev)[:, None].expand_as(input_ids)[real],
             input_ids[real]] = True
    state.appeared[rows] = appeared
    for slot, length, nonce in zip(slot_ids, true_lengths, nonces):
        state.lengths[slot] = int(length)
        state.dec_count[slot] = 0
        state.nonce[slot] = int(nonce)
        state.finished[slot] = False
        state.active[slot] = True
        state.rejected[slot] = -1


@torch.inference_mode()
def decode_step(model: GPTForPretraining, cache: KVCache, state: SlotState,
                gen_cfg: GenerationConfig, seed: int = 0,
                page_table: Optional[torch.Tensor] = None,
                adapter_ids: Optional[torch.Tensor] = None) -> List[int]:
    """One decode tick over every slot, in place: sample from each
    slot's ``last_logits`` (min-length over its own ``dec_count``,
    sampling stream ``stream_seed(seed, nonce, dec_count)``), write the
    token's keys/values at each slot's own length and attend through
    the ragged decode kernel, or with a ``page_table [slots,
    max_pages]`` through the page pool ``cache`` and the paged decode
    kernel. Free and finished slots ride along as pad tokens with
    frozen lengths (their writes are overwritten before any read, or
    land in the null page). ``adapter_ids [slots]`` (int32 LoRA bank
    rows) select each slot's adapter. Returns the token each slot
    emitted (pad where inactive)."""
    dev = state.last_logits.device
    slots = len(state.lengths)
    dec = torch.as_tensor(state.dec_count, device=dev)[:, None]
    seeds = [stream_seed(seed, state.nonce[i], state.dec_count[i])
             for i in range(slots)]
    token = next_token(state.last_logits, state.appeared, dec, gen_cfg,
                       seeds)
    idle = torch.as_tensor([f or not a for f, a in
                            zip(state.finished, state.active)], device=dev)
    token = torch.where(idle, gen_cfg.pad_token_id, token)
    state.appeared[torch.arange(slots, device=dev), token] = True
    lengths = torch.as_tensor(state.lengths, dtype=torch.int32, device=dev)
    pos = lengths.clamp(0, model.config.max_position_embeddings - 1)
    hidden = model.gpt(token[:, None], pos[:, None].long(), cache=cache,
                       decode_offset=lengths, page_table=page_table,
                       adapter_ids=adapter_ids)
    state.last_logits = _last_logits(model, hidden[:, -1])
    tokens = token.tolist()
    for i in range(slots):
        if state.active[i]:
            state.lengths[i] += 1
            state.dec_count[i] += 1
            if tokens[i] == gen_cfg.eos_token_id:
                state.finished[i] = True
    return tokens


#: salt separating a verify tick's ACCEPT uniform at request step c + j
#: from the draw the next tick makes at the same step when that draft
#: is rejected (the JAX package's ``SPEC_ACCEPT_SALT``)
SPEC_ACCEPT_SALT = 7919


def accept_uniform(seed: int, nonce: int, step: int) -> float:
    """The accept test's uniform in ``[0, 1)`` for request ``nonce`` at
    request step ``step``: the top 53 bits of ``stream_seed(seed,
    nonce, step, SPEC_ACCEPT_SALT)``. It depends on neither the slot
    nor the neighbours, like the draws of :func:`next_token`."""
    return (stream_seed(seed, nonce, step, SPEC_ACCEPT_SALT) >> 10) / \
        float(1 << 53)


@torch.inference_mode()
def verify_step(model: GPTForPretraining, cache: KVCache, state: SlotState,
                drafts: Sequence[Sequence[int]], gen_cfg: GenerationConfig,
                seed: int = 0, page_table: Optional[torch.Tensor] = None,
                adapter_ids: Optional[torch.Tensor] = None
                ) -> Tuple[List[List[int]], List[int]]:
    """One SPECULATIVE tick, in place: score ``k`` drafted tokens per
    slot in a single forward and commit the accepted prefix (+1 sampled
    token). The port of the JAX package's ``verify_step``.

    ``drafts [slots][k]`` are the draft source's guesses for each
    request's NEXT k tokens AFTER the one this tick samples
    (``core/spec.py``; draft content only affects throughput, never
    output). The tick:

    1. samples ``t0`` from ``last_logits`` through exactly
       :func:`decode_step`'s pipeline and stream, with the previous
       tick's ``rejected`` draft masked out after the filter;
    2. runs the model ONCE over the ``[slots, k+1]`` window ``[t0,
       d_1..d_k]`` at positions ``lengths .. lengths + k`` (the verify
       kernel over the contiguous cache, or with ``page_table`` the
       paged verify kernel);
    3. walks the drafts left to right: ``d_j`` commits iff every earlier
       window token committed, none was EOS, the request's budget
       allows it (``dec_count + j < max_dec_len``) and it passes the
       accept test. Greedy: ``d_j`` is the argmax of the processed
       logits at its position (teacher-forced logits are the sequential
       ones, so greedy output is token-exact with speculation off).
       Sampling: ``u < p(d_j)`` with ``u`` from :func:`accept_uniform`
       and ``p`` the filtered distribution; a rejected draft is
       recorded in ``rejected`` for the next tick's residual.

    ``adapter_ids [slots]`` (int32 LoRA bank rows) select each slot's
    adapter for the whole window.

    Rejected KV needs no device-side undo: lengths advance only by the
    committed count, and the next window overwrites the stale columns
    before any read reaches them (paged: the server hands pages past
    the accepted point back to the pool).

    Returns:
        ``(window, counts)``: ``window [slots][k+1]`` is the tick's
        token run (entry 0 = ``t0``, pad where inactive), ``counts
        [slots]`` how many of them committed (1..k+1).
    """
    dev = state.last_logits.device
    slots = len(state.lengths)
    k = len(drafts[0])
    eos, pad = gen_cfg.eos_token_id, gen_cfg.pad_token_id
    rows = torch.arange(slots, device=dev)
    active = torch.as_tensor(state.active, device=dev)
    fin = torch.as_tensor(state.finished, device=dev)
    dec = torch.as_tensor(state.dec_count, device=dev)[:, None]
    seeds = [stream_seed(seed, state.nonce[i], state.dec_count[i])
             for i in range(slots)]
    t0 = next_token(state.last_logits, state.appeared, dec, gen_cfg, seeds,
                    state.rejected)
    t0 = torch.where(fin | ~active, pad, t0)
    window = torch.cat([t0[:, None], torch.as_tensor(
        [list(d) for d in drafts], dtype=t0.dtype, device=dev)], dim=1)
    lengths = torch.as_tensor(state.lengths, dtype=torch.int32, device=dev)
    pos = (lengths.long()[:, None] + torch.arange(k + 1, device=dev)[None]
           ).clamp(0, model.config.max_position_embeddings - 1)
    hidden = model.gpt(window, pos, cache=cache, decode_offset=lengths,
                       page_table=page_table, adapter_ids=adapter_ids)
    logits_w = _last_logits(model, hidden)                 # [slots, k+1, V]

    sampling = gen_cfg.decode_strategy == "sampling"
    if sampling:
        uniforms = torch.as_tensor(
            [[accept_uniform(seed, state.nonce[i], state.dec_count[i] + j)
              for j in range(1, k + 1)] for i in range(slots)],
            dtype=torch.float32, device=dev)
    fin = fin | (active & (t0 == eos))
    state.appeared[rows, t0] = True
    commit = torch.ones((slots,), dtype=torch.bool, device=dev)
    counts = torch.ones((slots,), dtype=torch.long, device=dev)
    rejected = torch.full((slots,), -1, dtype=torch.long, device=dev)
    budget = torch.as_tensor([gen_cfg.max_dec_len - c
                              for c in state.dec_count], device=dev)
    for j in range(1, k + 1):
        dj = window[:, j]
        lg = _processed(logits_w[:, j - 1], state.appeared, dec + j, gen_cfg)
        if sampling:
            p = torch.softmax(_filtered(lg, gen_cfg), dim=-1)
            ok = uniforms[:, j - 1] < p.gather(1, dj[:, None])[:, 0]
        else:
            ok = dj == torch.argmax(lg, dim=-1)
        can = commit & ~fin & active & (j < budget)
        cj = can & ok
        if sampling:
            # at most one (can & ~ok) per slot: the chain stops there
            rejected = torch.where(can & ~ok, dj, rejected)
        commit = cj
        counts = counts + cj
        state.appeared[rows, dj] = state.appeared[rows, dj] | cj
        fin = fin | (cj & (dj == eos))
    # the logits after the last committed token: the next tick's t0
    state.last_logits = logits_w[rows, counts - 1]
    host = torch.cat([window, counts[:, None], fin[:, None].long(),
                      rejected[:, None]], dim=1).tolist()
    out_window, out_counts = [], []
    for i, row in enumerate(host):
        n = int(row[k + 1])
        out_window.append([int(t) for t in row[:k + 1]])
        out_counts.append(n)
        if state.active[i]:
            state.lengths[i] += n
            state.dec_count[i] += n
        state.finished[i] = bool(row[k + 2])
        state.rejected[i] = int(row[k + 3])
    return out_window, out_counts


# -- the paged pool ------------------------------------------------------


def init_page_pool(model: GPTForPretraining, cfg: GPTConfig) -> KVCache:
    """The zeroed global page pool of a paged server on the model's
    device: per layer ``(k, v)`` of ``[kv_pool_pages, heads,
    kv_page_size, head_dim]`` (int8 plus scale pools under the int8
    cache, ``model.init_kv_pool``). ``cfg`` is the model's config with
    the server's ``kv_page_size`` / ``kv_pool_pages``."""
    return init_kv_pool(cfg, model.word_embeddings.device)


@torch.inference_mode()
def prefill_chunk_paged(model: GPTForPretraining, pool: KVCache,
                        input_chunk: torch.Tensor,
                        chunk_start: torch.Tensor,
                        page_table: torch.Tensor,
                        logit_rows: Optional[torch.Tensor] = None,
                        adapter_ids: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """One page-aligned chunk of a chunked prefill, in place.

    ``input_chunk [n, chunk]`` are token ids (a tail past the prompt
    padded with any token: its KV lands past the prompt, where the
    per-slot masks never read and the first decode writes overwrite);
    ``chunk_start [n]`` is each row's position of the chunk's first
    token (a multiple of ``kv_page_size``); ``page_table [n,
    max_pages]`` carries the prefilling rows. The chunk's KV drops
    straight into its pages while its queries attend to every earlier
    position through the page table (the gather + dense route, as in
    the JAX package). Returns fp32 logits ``[n, chunk, V]``, or with
    ``logit_rows [n]`` only those rows' ``[n, V]`` (the server wants
    the last prompt token's). ``adapter_ids [n]`` (int32 LoRA bank
    rows) select each row's adapter."""
    n, c = input_chunk.shape
    dev = input_chunk.device
    start = torch.as_tensor(chunk_start, device=dev).long()
    pos = (start[:, None] + torch.arange(c, device=dev)[None, :]).clamp(
        0, model.config.max_position_embeddings - 1)
    hidden = model.gpt(input_chunk, pos, cache=pool, page_table=page_table,
                       chunk_start=start, adapter_ids=adapter_ids)
    if logit_rows is not None:
        hidden = hidden[torch.arange(n, device=dev),
                        torch.as_tensor(logit_rows, device=dev).long()]
    return _last_logits(model, hidden)


@torch.inference_mode()
def copy_kv_pages(pool: KVCache, src: Sequence[int],
                  dst: Sequence[int]) -> None:
    """Copy physical pages ``src -> dst`` in every layer's K and V pool
    (and an int8 pool's scale pools, or a split page would keep stale
    scales), in place: the copy half of a copy-on-write split (the
    server rewires the page table and the refcounts around it)."""
    dev = pool[0][0].device
    s = torch.as_tensor(list(src), device=dev)
    d = torch.as_tensor(list(dst), device=dev)
    for layer in pool:
        for t in layer:
            t[d] = t[s]


@torch.inference_mode()
def activate_slot(state: SlotState, slot: int, length: int, dec_count: int,
                  nonce: int, appeared_row: torch.Tensor,
                  last_logits_row: torch.Tensor, rejected: int = -1) -> None:
    """Flip one slot live from host-computed state, in place: the paged
    admission paths (chunked-prefill completion, whole-prompt registry
    hit, a preempted request's resume) activate through here.
    ``dec_count`` is nonzero only for resumes, so a requeued request's
    min-length and sampling stream continue where they stopped;
    ``rejected`` likewise restores a pending rejection residual."""
    state.lengths[slot] = int(length)
    state.dec_count[slot] = int(dec_count)
    state.nonce[slot] = int(nonce)
    state.finished[slot] = False
    state.active[slot] = True
    state.rejected[slot] = int(rejected)
    state.appeared[slot] = appeared_row
    state.last_logits[slot] = last_logits_row
