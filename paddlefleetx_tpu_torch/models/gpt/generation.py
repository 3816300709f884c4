"""Autoregressive generation with a fixed-capacity KV cache (the port of
the JAX package's ``models/gpt/generation.py``): the lockstep
:func:`generate` and the continuous-batching slot primitives the server
(``core/serving.py``) drives.

- :func:`generate` takes left-padded prompts, prefills them through the
  flash forward kernel (pad keys masked by a ``[b, 1, 1, prompt]``
  bias), then decodes every row at one shared cache index through
  ``flash_decode`` (shared offset + the ``[b, 1, 1, capacity]``
  validity bias). Greedy and sampling; beam search is not ported yet.
- The slot primitives keep a persistent ``[slots, ...]`` cache whose
  rows are independent requests at independent lengths:
  :func:`prefill_into_slots` admits requests into free rows (right
  padded to a bucket; causality masks the pad tail),
  :func:`decode_step` advances every slot one token through
  ``flash_decode_ragged`` with per-slot offsets.

Both paths sample from the same processor pipeline (repetition
penalty, min-length, temperature, exact top-k / top-p). Sampling draws
from a ``torch.Generator`` seeded per (seed, stream, step): the row
index in :func:`generate`, the request nonce in the server, so a
request's sample depends on neither its slot nor its neighbours. The
numbers differ from the JAX package's ``jax.random`` streams; greedy
decoding is token-exact against it. The cache is updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from .config import GPTConfig
from .model import GPTForPretraining, KVCache, init_kv_cache, tied_logits
from .processors import (
    NEG_INF, min_length_processor, repetition_penalty_processor,
    top_k_top_p_filter,
)

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Knobs named as in the reference YAML ``Generation`` section (the
    JAX package's fields). Not ported yet: ``beam_search`` (``generate``
    raises) and ``spec_method`` (the server raises). ``approx_top_k``
    is accepted; the port's top-k is always exact, which meets the
    approximate filter's superset contract."""

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


def next_token(logits: torch.Tensor, appeared: torch.Tensor, dec_count,
               gen_cfg: GenerationConfig, seeds: Sequence[int]
               ) -> torch.Tensor:
    """Pick one token per row: repetition penalty over ``appeared``,
    min-length over ``dec_count`` (tokens generated so far: an int or a
    ``[b, 1]`` tensor), then argmax (greedy) or a draw from the
    temperature-scaled, top-k / top-p filtered distribution with row
    ``i``'s generator seeded by ``seeds[i]``."""
    logits = repetition_penalty_processor(logits, appeared,
                                          gen_cfg.repetition_penalty)
    logits = min_length_processor(logits, dec_count, gen_cfg.min_dec_len,
                                  gen_cfg.eos_token_id)
    if gen_cfg.decode_strategy == "greedy_search":
        return torch.argmax(logits, dim=-1)
    if gen_cfg.decode_strategy != "sampling":
        raise NotImplementedError(
            f"decode_strategy {gen_cfg.decode_strategy!r} is not ported "
            f"(greedy_search and sampling are)")
    logits = logits / max(gen_cfg.temperature, 1e-6)
    probs = torch.softmax(top_k_top_p_filter(logits, gen_cfg.top_k,
                                             gen_cfg.top_p), dim=-1)
    picks = []
    for row, seed in enumerate(seeds):
        gen = torch.Generator(device=logits.device).manual_seed(seed)
        picks.append(torch.multinomial(probs[row], 1, generator=gen))
    return torch.cat(picks)


def _last_logits(model: GPTForPretraining, hidden: torch.Tensor
                 ) -> torch.Tensor:
    return tied_logits(hidden, model.word_embeddings).float()


@torch.no_grad()
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
    hidden = model.gpt(ids, position_ids,
                       attn_bias=_decode_bias(valid[:, :prompt_len]),
                       cache=cache)
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
                                dtype=torch.float32, device=device))


def init_slot_cache(model: GPTForPretraining, num_slots: int) -> KVCache:
    """The zeroed persistent ``[slots, heads, capacity, head_dim]``
    per-layer cache on the model's device."""
    return init_kv_cache(model.config, num_slots,
                         model.word_embeddings.device)


@torch.no_grad()
def prefill_into_slots(model: GPTForPretraining, cache: KVCache,
                       state: SlotState, slot_ids: Sequence[int],
                       input_ids: torch.Tensor, true_lengths: Sequence[int],
                       nonces: Sequence[int]) -> None:
    """Admit requests into free slots, in place: prefill the RIGHT-padded
    ``input_ids [n, bucket]`` (prompts start at cache position 0; the
    pad tail past ``true_lengths`` is causally masked during prefill and
    length-masked during decode) straight into cache rows ``slot_ids``,
    and set those slots' state from each row's last real token."""
    dev = model.word_embeddings.device
    n, bucket = input_ids.shape
    rows = torch.as_tensor(list(slot_ids), device=dev)
    hidden = model.gpt(input_ids, cache=cache, cache_rows=rows)
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


@torch.no_grad()
def decode_step(model: GPTForPretraining, cache: KVCache, state: SlotState,
                gen_cfg: GenerationConfig, seed: int = 0) -> List[int]:
    """One decode tick over every slot, in place: sample from each
    slot's ``last_logits`` (min-length over its own ``dec_count``,
    sampling stream ``stream_seed(seed, nonce, dec_count)``), write the
    token's keys/values at each slot's own length and attend through
    the ragged decode kernel. Free and finished slots ride along as pad
    tokens with frozen lengths (their writes are overwritten before any
    read). Returns the token each slot emitted (pad where inactive)."""
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
                       decode_offset=lengths)
    state.last_logits = _last_logits(model, hidden[:, -1])
    tokens = token.tolist()
    for i in range(slots):
        if state.active[i]:
            state.lengths[i] += 1
            state.dec_count[i] += 1
            if tokens[i] == gen_cfg.eos_token_id:
                state.finished[i] = True
    return tokens
