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

- The device-resident loops (:func:`decode_loop`, :func:`verify_loop`)
  run up to ``T`` of those ticks per host round trip over the same tick
  bodies: :func:`loop_tick` is one iteration, which reads and writes
  only device tensors (the slot state, a :class:`LoopCarry` of ring
  buffers), so the server can capture it once in a CUDA graph and
  replay it (``core/decode_graph.py``). A tick after the loop's exit
  condition holds commits nothing, so any ``T`` commits the tokens of
  ``T = 1``.

All paths sample from the same processor pipeline (repetition
penalty, min-length, temperature, exact top-k / top-p). A draw is the
inverse CDF of the filtered distribution at a counter-based uniform
computed on the device, Philox4x32-10 keyed by the seed over (stream,
step, salt) (:func:`stream_uniform`): the stream is the row index in
:func:`generate`, the request nonce in the server, so a request's
sample depends on neither its slot nor its neighbours nor the number
of ticks per round trip; the verify tick's accept test draws its
uniform from the same keys with a salt (``SPEC_ACCEPT_SALT``). The
numbers differ from the JAX package's ``jax.random`` streams; greedy
decoding is token-exact against it. The slot state lives on the device
(:class:`SlotState`), with a host mirror of what scheduling reads that
the T = 1 wrappers and the loops' read-back refresh in one copy. The
cache is updated in place. Every function here runs under
``torch.inference_mode`` (serving needs no autograd, and the mode drops
its bookkeeping from each of a tick's launches).
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
from ...ops.cuda.philox import M32, philox4x32_10


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


#: salt separating a verify tick's ACCEPT uniform at request step c + j
#: from the draw the next tick makes at the same step when that draft
#: is rejected (the JAX package's ``SPEC_ACCEPT_SALT``)
SPEC_ACCEPT_SALT = 7919


def stream_uniform(seed: int, stream: torch.Tensor, step: torch.Tensor,
                   salt=0) -> torch.Tensor:
    """Uniforms in ``[0, 1)`` (fp32) over the broadcast of ``stream``,
    ``step`` and ``salt`` (int64 tensors, or an int salt), computed on
    their device: word 0 of ``philox4x32_10(ctr=(stream & M32, stream >>
    32, step & M32, salt), key=(seed & M32, seed >> 32))``, its top 24
    bits over 2^24. A function of those keys alone, so a draw depends
    on no slot, neighbour or loop depth; the uint32 arithmetic stays in
    int64 without overflow (``ops/cuda/philox.py``)."""
    stream = stream.long()
    w0, _, _, _ = philox4x32_10(stream & M32, (stream >> 32) & M32,
                                step.long() & M32, salt, seed & M32,
                                (seed >> 32) & M32)
    return (w0 >> 8).float() * (1.0 / (1 << 24))


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


def _inverse_cdf(probs: torch.Tensor, uniforms: torch.Tensor
                 ) -> torch.Tensor:
    """The token whose CDF interval holds ``uniforms[i]`` times the
    row's total mass: the first index whose running sum exceeds it,
    never past the last token of non-zero probability."""
    cdf = torch.cumsum(probs, dim=-1)
    x = uniforms[:, None].to(cdf.dtype) * cdf[:, -1:]
    token = torch.searchsorted(cdf, x, right=True)[:, 0]
    # argmax returns the first maximum: the last token with mass
    return torch.minimum(token, torch.argmax(cdf, dim=-1))


def next_token(logits: torch.Tensor, appeared: torch.Tensor, dec_count,
               gen_cfg: GenerationConfig,
               uniforms: Optional[torch.Tensor] = None,
               rejected: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pick one token per row: repetition penalty over ``appeared``,
    min-length over ``dec_count`` (tokens generated so far: an int or a
    ``[b, 1]`` tensor), then argmax (greedy) or the inverse CDF of the
    temperature-scaled, top-k / top-p filtered distribution at
    ``uniforms [b]`` (:func:`stream_uniform`). Under sampling,
    ``rejected [b]`` holds a draft the previous verify tick rejected,
    masked out after the filter (the rejection-sampling residual), or
    ``-1``, which masks nothing."""
    logits = _processed(logits, appeared, dec_count, gen_cfg)
    if gen_cfg.decode_strategy == "greedy_search":
        return torch.argmax(logits, dim=-1)
    if gen_cfg.decode_strategy != "sampling":
        raise NotImplementedError(
            f"decode_strategy {gen_cfg.decode_strategy!r} is not ported "
            f"(greedy_search and sampling are)")
    logits = _filtered(logits, gen_cfg)
    if rejected is not None:
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(vocab[None, :] == rejected[:, None],
                             torch.full_like(logits, NEG_INF), logits)
    return _inverse_cdf(torch.softmax(logits, dim=-1), uniforms)


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
        seed (int): sampling seed (row ``i``'s step ``t`` draws at
            ``stream_uniform(seed, i, t)``).
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
    sampling = gen_cfg.decode_strategy == "sampling"
    for step in range(gen_cfg.max_dec_len):
        u = stream_uniform(seed, rows, torch.full_like(rows, step)) \
            if sampling else None
        token = next_token(logits, appeared, step, gen_cfg, u)
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
class SlotMirror:
    """The host's copy of the per-slot scalars scheduling reads, numpy
    rows refreshed from the device once per host round trip (by the
    wrapper that read the tick or the loop back) and written beside the
    device state by admission and release."""

    #: tokens generated so far per slot (int64)
    dec_count: np.ndarray
    #: slot emitted EOS (bool)
    finished: np.ndarray
    #: the draft the last verify tick rejected, -1 for none (int64)
    rejected: np.ndarray


@dataclasses.dataclass
class SlotState:
    """Per-slot decode state carried across serving ticks, on the
    device (the JAX package's ``SlotState``), plus the host mirror
    :attr:`host`. The ticks write every tensor in place, never rebind
    one, so a captured graph of a tick stays valid across admissions."""

    #: ``[slots]`` int32 — valid cache positions (the slot's token count)
    lengths: torch.Tensor
    #: ``[slots]`` int64 — tokens generated so far (the lockstep step)
    dec_count: torch.Tensor
    #: ``[slots]`` int64 — per-request sampling stream id
    nonce: torch.Tensor
    #: ``[slots]`` bool — slot emitted EOS
    finished: torch.Tensor
    #: ``[slots]`` bool — slot holds a live request
    active: torch.Tensor
    #: ``[slots, V]`` bool — the repetition-penalty token sets
    appeared: torch.Tensor
    #: ``[slots, V]`` fp32 — logits the next tick samples from
    last_logits: torch.Tensor
    #: ``[slots]`` int64 — draft token the previous verify tick REJECTED
    #: under sampling (-1 = none): the next tick's draw from
    #: ``last_logits`` masks it out (the rejection-sampling residual).
    #: Always -1 under greedy and with speculation off.
    rejected: torch.Tensor
    #: what scheduling reads, on the host
    host: SlotMirror


def init_slot_state(num_slots: int, vocab_size: int,
                    device: torch.device) -> SlotState:
    """All-free slot state (no request admitted anywhere)."""
    def zeros(dtype):
        return torch.zeros((num_slots,), dtype=dtype, device=device)
    return SlotState(
        lengths=zeros(torch.int32), dec_count=zeros(torch.int64),
        nonce=zeros(torch.int64), finished=zeros(torch.bool),
        active=zeros(torch.bool),
        appeared=torch.zeros((num_slots, vocab_size), dtype=torch.bool,
                             device=device),
        last_logits=torch.zeros((num_slots, vocab_size),
                                dtype=torch.float32, device=device),
        rejected=torch.full((num_slots,), -1, dtype=torch.int64,
                            device=device),
        host=SlotMirror(dec_count=np.zeros(num_slots, np.int64),
                        finished=np.zeros(num_slots, bool),
                        rejected=np.full(num_slots, -1, np.int64)))


def _read_back(state: SlotState, *extra: torch.Tensor) -> List[np.ndarray]:
    """Refresh the host mirror and fetch ``extra`` (integer tensors) in
    ONE device-to-host copy; returns ``extra`` as numpy arrays."""
    n = state.lengths.shape[0]
    flat = torch.cat([state.finished.long(), state.dec_count,
                      state.rejected] +
                     [t.reshape(-1).long() for t in extra]).cpu().numpy()
    state.host.finished[:] = flat[:n] != 0
    state.host.dec_count[:] = flat[n:2 * n]
    state.host.rejected[:] = flat[2 * n:3 * n]
    out, i = [], 3 * n
    for t in extra:
        out.append(flat[i:i + t.numel()].reshape(tuple(t.shape)))
        i += t.numel()
    return out


def init_slot_cache(model: GPTForPretraining, num_slots: int) -> KVCache:
    """The zeroed persistent ``[slots, heads, capacity, head_dim]``
    per-layer cache on the model's device (int8 plus ``[slots, heads,
    capacity]`` scales under the int8 cache, ``model.init_kv_cache``)."""
    return init_kv_cache(model.config, num_slots,
                         model.word_embeddings.device)


def _mirror_admit(state: SlotState, slot: int, dec_count: int,
                  rejected: int) -> None:
    state.host.dec_count[slot] = dec_count
    state.host.finished[slot] = False
    state.host.rejected[slot] = rejected


@torch.inference_mode()
def prefill_into_slots(model: GPTForPretraining, cache: KVCache,
                       state: SlotState, slot_ids: Sequence[int],
                       input_ids: torch.Tensor, true_lengths: Sequence[int],
                       nonces: Sequence[int],
                       adapter_ids: Optional[torch.Tensor] = None,
                       dec_counts: Optional[Sequence[int]] = None) -> None:
    """Admit requests into free slots, in place: prefill the RIGHT-padded
    ``input_ids [n, bucket]`` (prompts start at cache position 0; the
    pad tail past ``true_lengths`` is causally masked during prefill and
    length-masked during decode) straight into cache rows ``slot_ids``,
    and set those slots' state, on the device and in the mirror, from
    each row's last real token. ``adapter_ids [n]`` (int32 LoRA bank
    rows) tint each row's KV and logits with its adapter; None serves
    the base model. ``dec_counts [n]`` (default zeros) are the tokens
    each row already generated: a resumed request's prefill covers
    prompt + those tokens, and its sampling stream and budget go on
    from there."""
    dev = model.word_embeddings.device
    n, bucket = input_ids.shape
    rows = torch.as_tensor(list(slot_ids), device=dev)
    hidden = model.gpt(input_ids, cache=cache, cache_rows=rows,
                       adapter_ids=adapter_ids)
    last = torch.as_tensor([t - 1 for t in true_lengths], device=dev)
    state.last_logits[rows] = _last_logits(
        model, hidden[torch.arange(n, device=dev), last])
    lengths = torch.as_tensor(list(true_lengths), device=dev)
    real = torch.arange(bucket, device=dev)[None, :] < lengths[:, None]
    appeared = torch.zeros((n, model.config.vocab_size), dtype=torch.bool,
                           device=dev)
    appeared[torch.arange(n, device=dev)[:, None].expand_as(input_ids)[real],
             input_ids[real]] = True
    state.appeared[rows] = appeared
    state.lengths[rows] = lengths.to(torch.int32)
    state.nonce[rows] = torch.as_tensor(list(nonces), dtype=torch.int64,
                                        device=dev)
    counts = [int(c) for c in dec_counts] if dec_counts is not None \
        else [0] * n
    state.dec_count[rows] = torch.as_tensor(counts, dtype=torch.int64,
                                            device=dev)
    state.finished[rows] = False
    state.active[rows] = True
    state.rejected[rows] = -1
    for slot, count in zip(slot_ids, counts):
        _mirror_admit(state, slot, count, -1)


@torch.inference_mode()
def release_slot(state: SlotState, slot: int) -> None:
    """Mark a slot free (eviction or preemption), on the device and in
    the mirror: it rides along the ticks as a pad row from now on."""
    state.active[slot] = False
    state.finished[slot] = False
    state.host.finished[slot] = False


def _decode_tick(model: GPTForPretraining, cache: KVCache, state: SlotState,
                 gen_cfg: GenerationConfig, seed: int,
                 page_table: Optional[torch.Tensor],
                 adapter_ids: Optional[torch.Tensor],
                 go: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One plain decode tick on device tensors alone, in place (the JAX
    package's ``_decode_tick_impl``): the shared body of
    :func:`decode_step` and :func:`loop_tick`. ``go`` (a bool scalar
    tensor, None for True) masks the tick: with ``go`` false it commits
    nothing and leaves lengths, counts, ``appeared`` and
    ``last_logits`` as they were (its KV write lands at each slot's
    frozen length, where the next real tick overwrites it). Returns
    the ``[slots]`` tokens, pad where a slot is idle."""
    slots = state.lengths.shape[0]
    dev = state.last_logits.device
    rows = torch.arange(slots, device=dev)
    u = stream_uniform(seed, state.nonce, state.dec_count) \
        if gen_cfg.decode_strategy == "sampling" else None
    token = next_token(state.last_logits, state.appeared,
                       state.dec_count[:, None], gen_cfg, u)
    token = torch.where(state.finished | ~state.active,
                        gen_cfg.pad_token_id, token)
    live = state.active if go is None else state.active & go
    state.appeared[rows, token] = state.appeared[rows, token] | \
        (True if go is None else go)
    pos = state.lengths.clamp(0, model.config.max_position_embeddings - 1)
    hidden = model.gpt(token[:, None], pos[:, None].long(), cache=cache,
                       decode_offset=state.lengths, page_table=page_table,
                       adapter_ids=adapter_ids)
    logits = _last_logits(model, hidden[:, -1])
    state.last_logits.copy_(logits if go is None else
                            torch.where(go, logits, state.last_logits))
    state.finished |= live & (token == gen_cfg.eos_token_id)
    state.lengths += live.to(torch.int32)
    state.dec_count += live.long()
    return token


@torch.inference_mode()
def decode_step(model: GPTForPretraining, cache: KVCache, state: SlotState,
                gen_cfg: GenerationConfig, seed: int = 0,
                page_table: Optional[torch.Tensor] = None,
                adapter_ids: Optional[torch.Tensor] = None) -> List[int]:
    """One decode tick over every slot, in place: sample from each
    slot's ``last_logits`` (min-length over its own ``dec_count``,
    sampling at ``stream_uniform(seed, nonce, dec_count)``), write the
    token's keys/values at each slot's own length and attend through
    the ragged decode kernel, or with a ``page_table [slots,
    max_pages]`` through the page pool ``cache`` and the paged decode
    kernel. Free and finished slots ride along as pad tokens with
    frozen lengths (their writes are overwritten before any read, or
    land in the null page). ``adapter_ids [slots]`` (int32 LoRA bank
    rows) select each slot's adapter. Reads the tokens and the host
    mirror back in one copy; returns the token each slot emitted (pad
    where inactive)."""
    token = _decode_tick(model, cache, state, gen_cfg, seed, page_table,
                         adapter_ids)
    return _read_back(state, token)[0].tolist()


def _verify_tick(model: GPTForPretraining, cache: KVCache, state: SlotState,
                 drafts: torch.Tensor, gen_cfg: GenerationConfig, seed: int,
                 page_table: Optional[torch.Tensor],
                 adapter_ids: Optional[torch.Tensor],
                 go: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One speculative tick on device tensors alone, in place (the JAX
    package's ``_verify_tick_impl``, see :func:`verify_step`): the shared
    body of :func:`verify_step` and :func:`loop_tick`, masked by ``go``
    as :func:`_decode_tick` is. Returns ``(window [slots, k+1], counts
    [slots])``."""
    slots, k = drafts.shape
    dev = state.last_logits.device
    eos, pad = gen_cfg.eos_token_id, gen_cfg.pad_token_id
    rows = torch.arange(slots, device=dev)
    live = state.active if go is None else state.active & go
    dec = state.dec_count[:, None]
    sampling = gen_cfg.decode_strategy == "sampling"
    u = None
    if sampling:
        # column 0 is t0's draw (decode_step's stream), columns 1..k the
        # accept uniforms at request steps dec + j
        j = torch.arange(k + 1, device=dev)
        u = stream_uniform(seed, state.nonce[:, None], dec + j[None],
                           (j > 0).long() * SPEC_ACCEPT_SALT)
    t0 = next_token(state.last_logits, state.appeared, dec, gen_cfg,
                    u[:, 0] if sampling else None, state.rejected)
    t0 = torch.where(state.finished | ~state.active, pad, t0)
    window = torch.cat([t0[:, None], drafts.to(t0.dtype)], dim=1)
    pos = (state.lengths.long()[:, None] +
           torch.arange(k + 1, device=dev)[None]
           ).clamp(0, model.config.max_position_embeddings - 1)
    hidden = model.gpt(window, pos, cache=cache, decode_offset=state.lengths,
                       page_table=page_table, adapter_ids=adapter_ids)
    logits_w = _last_logits(model, hidden)                 # [slots, k+1, V]

    fin = state.finished | (live & (t0 == eos))
    state.appeared[rows, t0] = state.appeared[rows, t0] | \
        (True if go is None else go)
    commit = torch.ones((slots,), dtype=torch.bool, device=dev)
    counts = torch.ones((slots,), dtype=torch.long, device=dev)
    rejected = torch.full((slots,), -1, dtype=torch.long, device=dev)
    budget = gen_cfg.max_dec_len - state.dec_count
    for j in range(1, k + 1):
        dj = window[:, j]
        lg = _processed(logits_w[:, j - 1], state.appeared, dec + j, gen_cfg)
        if sampling:
            p = torch.softmax(_filtered(lg, gen_cfg), dim=-1)
            ok = u[:, j] < p.gather(1, dj[:, None])[:, 0]
        else:
            ok = dj == torch.argmax(lg, dim=-1)
        can = commit & ~fin & live & (j < budget)
        cj = can & ok
        if sampling:
            # at most one (can & ~ok) per slot: the chain stops there
            rejected = torch.where(can & ~ok, dj, rejected)
        commit = cj
        counts = counts + cj
        state.appeared[rows, dj] = state.appeared[rows, dj] | cj
        fin = fin | (cj & (dj == eos))
    # the logits after the last committed token: the next tick's t0
    last = logits_w[rows, counts - 1]
    if go is not None:
        last = torch.where(go, last, state.last_logits)
        rejected = torch.where(go, rejected, state.rejected)
    state.last_logits.copy_(last)
    state.rejected.copy_(rejected)
    state.finished.copy_(fin)
    adv = torch.where(live, counts, 0)
    state.lengths += adv.to(torch.int32)
    state.dec_count += adv
    return window, counts


@torch.inference_mode()
def verify_step(model: GPTForPretraining, cache: KVCache, state: SlotState,
                drafts, gen_cfg: GenerationConfig,
                seed: int = 0, page_table: Optional[torch.Tensor] = None,
                adapter_ids: Optional[torch.Tensor] = None
                ) -> Tuple[List[List[int]], List[int]]:
    """One SPECULATIVE tick, in place: score ``k`` drafted tokens per
    slot in a single forward and commit the accepted prefix (+1 sampled
    token). The port of the JAX package's ``verify_step``.

    ``drafts [slots][k]`` (nested lists or an integer array) are the
    draft source's guesses for each request's NEXT k tokens AFTER the
    one this tick samples (``core/spec.py``; draft content only affects
    throughput, never output). The tick:

    1. samples ``t0`` from ``last_logits`` through exactly
       :func:`decode_step`'s pipeline and stream, with the previous
       tick's ``rejected`` draft masked out after the filter;
    2. runs the model ONCE over the ``[slots, k+1]`` window ``[t0,
       d_1..d_k]`` at positions ``lengths .. lengths + k`` (the verify
       kernel over the contiguous cache, or with ``page_table`` the
       paged verify kernel);
    3. walks the drafts left to right: ``d_j`` commits iff every earlier
       window token committed, none was EOS, the request's budget
       allows it (``dec_count + j < max_dec_len``, on the device) and it
       passes the accept test. Greedy: ``d_j`` is the argmax of the
       processed logits at its position (teacher-forced logits are the
       sequential ones, so greedy output is token-exact with
       speculation off). Sampling: ``u < p(d_j)`` with ``u =
       stream_uniform(seed, nonce, dec_count + j, SPEC_ACCEPT_SALT)``
       and ``p`` the filtered distribution; a rejected draft is recorded
       in ``rejected`` for the next tick's residual.

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
    drafts = torch.as_tensor(np.asarray(drafts, np.int64),
                             device=state.last_logits.device)
    window, counts = _verify_tick(model, cache, state, drafts, gen_cfg,
                                  seed, page_table, adapter_ids)
    window, counts = _read_back(state, window, counts)
    return window.tolist(), counts.tolist()


# -- device-resident decode: up to T ticks per host round trip -----------
#
# The loops run the same tick bodies up to T times between two reads of
# the device, buffering each tick's tokens in [slots, T] rings the host
# replays afterwards. An iteration runs its tick iff it is the first or
# no exit condition holds: an active slot finished, a slot's budget is
# spent, or the host flagged pending work at launch. A masked iteration
# commits nothing, so the host may launch more iterations than will run
# (the server launches min(T, least remaining budget) of them) and the
# device stops where the JAX package's lax.while_loop stops.

#: a slot emitted EOS: the host must evict before the next tick
LOOP_EXIT_FINISHED = 1
#: a slot's decode budget expired (dec_count hit max_dec_len), or the
#: loop ran its full T ticks with nothing else to do
LOOP_EXIT_BUDGET = 2
#: the host flag was set at launch (pending admission, chunked prefill
#: or page-pool pressure): the loop ran exactly one tick
LOOP_EXIT_HOST = 3


@dataclasses.dataclass
class LoopCarry:
    """The device buffers of one host round trip of a loop, written in
    place by :func:`reset_loop_carry` and :func:`loop_tick` (so a CUDA
    graph of the tick reads the same memory every replay)."""

    #: ticks per round trip (the rings' T axis)
    loop_ticks: int
    #: ``[1]`` int64 — the next iteration's index
    tick: torch.Tensor
    #: ``[]`` bool — the host asked for control back after one tick
    host_flag: torch.Tensor
    #: ``[]`` int64 — iterations that ran their tick
    ticks_run: torch.Tensor
    #: ``[slots, T]`` tokens (decode) or ``[slots, T, k+1]`` windows
    #: (verify), int64, pad past ``ticks_run``
    tokens: torch.Tensor
    #: ``[slots, T]`` int64 committed counts (verify), 0 past
    #: ``ticks_run``; None for a decode loop
    counts: Optional[torch.Tensor] = None
    #: ``[slots, T, k]`` int64 drafts, tick ``j`` verifying ``[:, j]``;
    #: None for a decode loop
    drafts: Optional[torch.Tensor] = None


def init_loop_carry(num_slots: int, loop_ticks: int,
                    gen_cfg: GenerationConfig, device: torch.device,
                    spec_tokens: Optional[int] = None) -> LoopCarry:
    """A loop's buffers: a verify loop's with ``spec_tokens`` = k."""
    if loop_ticks < 1:
        raise ValueError(f"loop_ticks must be >= 1, got {loop_ticks}")

    def buf(*shape, fill=0):
        return torch.full((num_slots, loop_ticks) + shape, fill,
                          dtype=torch.int64, device=device)
    spec = spec_tokens is not None
    return LoopCarry(
        loop_ticks=loop_ticks,
        tick=torch.zeros((1,), dtype=torch.int64, device=device),
        host_flag=torch.zeros((), dtype=torch.bool, device=device),
        ticks_run=torch.zeros((), dtype=torch.int64, device=device),
        tokens=buf(spec_tokens + 1, fill=gen_cfg.pad_token_id) if spec
        else buf(fill=gen_cfg.pad_token_id),
        counts=buf() if spec else None,
        drafts=buf(spec_tokens) if spec else None)


@torch.inference_mode()
def reset_loop_carry(carry: LoopCarry, gen_cfg: GenerationConfig,
                     host_flag: bool, drafts=None) -> None:
    """Start a round trip, in place: iteration 0, empty rings, the host
    flag and (verify) this round trip's ``drafts [slots, T, k]``."""
    carry.tick.zero_()
    carry.ticks_run.zero_()
    carry.host_flag.fill_(bool(host_flag))
    carry.tokens.fill_(gen_cfg.pad_token_id)
    if carry.counts is not None:
        carry.counts.zero_()
        carry.drafts.copy_(torch.as_tensor(np.asarray(drafts, np.int64)))


def _loop_exit_flags(state: SlotState, gen_cfg: GenerationConfig):
    """``(fin_any, bud_any)`` — does any ACTIVE slot need the host: it
    emitted EOS (eviction), or spent its decode budget (``dec_count >=
    max_dec_len``, the server's length eviction)."""
    fin_any = (state.active & state.finished).any()
    bud_any = (state.active & ~state.finished &
               (state.dec_count >= gen_cfg.max_dec_len)).any()
    return fin_any, bud_any


def _loop_exit_reason(state: SlotState, gen_cfg: GenerationConfig,
                      host_flag: torch.Tensor) -> torch.Tensor:
    """Why the loop stopped, by priority: a finished slot beats a spent
    budget beats the host flag; a full-T run with none of them reads as
    the tick budget expiring (``LOOP_EXIT_BUDGET``)."""
    fin_any, bud_any = _loop_exit_flags(state, gen_cfg)
    return torch.where(fin_any, LOOP_EXIT_FINISHED, torch.where(
        bud_any, LOOP_EXIT_BUDGET, torch.where(
            host_flag, LOOP_EXIT_HOST, LOOP_EXIT_BUDGET)))


@torch.inference_mode()
def loop_tick(model: GPTForPretraining, cache: KVCache, state: SlotState,
              carry: LoopCarry, gen_cfg: GenerationConfig, seed: int = 0,
              page_table: Optional[torch.Tensor] = None,
              adapter_ids: Optional[torch.Tensor] = None) -> None:
    """One iteration of a device loop, on device tensors alone: the tick
    body a CUDA graph captures. Iteration ``carry.tick`` runs its tick
    (:func:`_decode_tick`, or :func:`_verify_tick` on its slice of
    ``carry.drafts``) iff it is the first, or ticks remain and no exit
    condition holds (:func:`_loop_exit_flags`, the host flag); it writes
    the tick's tokens (and counts) into ring column ``tick % T``, pad
    (and 0) where masked, and counts the tick in ``ticks_run``."""
    fin_any, bud_any = _loop_exit_flags(state, gen_cfg)
    go = (carry.tick[0] == 0) | ((carry.tick[0] < carry.loop_ticks) &
                                 ~fin_any & ~bud_any & ~carry.host_flag)
    col = torch.remainder(carry.tick, carry.loop_ticks)
    pad = gen_cfg.pad_token_id
    if carry.drafts is None:
        token = _decode_tick(model, cache, state, gen_cfg, seed, page_table,
                             adapter_ids, go)
        carry.tokens.index_copy_(1, col, torch.where(go, token, pad)[:, None])
    else:
        drafts = carry.drafts.index_select(1, col)[:, 0]
        window, counts = _verify_tick(model, cache, state, drafts, gen_cfg,
                                      seed, page_table, adapter_ids, go)
        carry.tokens.index_copy_(1, col,
                                 torch.where(go, window, pad)[:, None])
        carry.counts.index_copy_(1, col, torch.where(go, counts, 0)[:, None])
    carry.ticks_run += go.long()
    carry.tick += 1


@torch.inference_mode()
def read_loop(state: SlotState, carry: LoopCarry, gen_cfg: GenerationConfig
              ) -> Tuple[np.ndarray, Optional[np.ndarray], int, int]:
    """The round trip's one read of the device: ``(tokens, counts,
    ticks_run, exit_reason)`` (``counts`` None for a decode loop), the
    host mirror refreshed in the same copy."""
    reason = _loop_exit_reason(state, gen_cfg, carry.host_flag)
    bufs = [carry.tokens] + ([carry.counts] if carry.counts is not None
                             else [])
    out = _read_back(state, *bufs, carry.ticks_run.reshape(1),
                     reason.reshape(1))
    counts = out[1] if carry.counts is not None else None
    return out[0], counts, int(out[-2][0]), int(out[-1][0])


def decode_loop(model: GPTForPretraining, cache: KVCache, state: SlotState,
                gen_cfg: GenerationConfig, host_flag: bool, seed: int = 0,
                page_table: Optional[torch.Tensor] = None,
                adapter_ids: Optional[torch.Tensor] = None, *,
                loop_ticks: int = 1) -> Tuple[np.ndarray, int, int]:
    """Up to ``loop_ticks`` plain decode ticks in one round trip, eager
    (the JAX package's ``decode_loop``; the server replays the same
    :func:`loop_tick` from a CUDA graph on the card). Each tick that
    runs is :func:`decode_step`'s tick body, so the committed tokens are
    those of ``loop_ticks`` sequential ``decode_step`` calls. At least
    one tick runs; then ticks run while ticks remain, no active slot
    finished or spent its budget, and ``host_flag`` is off.

    Returns ``(tokens_buf [slots, loop_ticks], ticks_run, exit_reason)``:
    tick ``j``'s token per slot in column ``j`` (pad beyond
    ``ticks_run``) and one of the ``LOOP_EXIT_*`` codes.
    """
    carry = init_loop_carry(state.lengths.shape[0], loop_ticks, gen_cfg,
                            state.last_logits.device)
    reset_loop_carry(carry, gen_cfg, host_flag)
    for _ in range(loop_ticks):
        loop_tick(model, cache, state, carry, gen_cfg, seed, page_table,
                  adapter_ids)
    tokens, _, ticks, reason = read_loop(state, carry, gen_cfg)
    return tokens, ticks, reason


def verify_loop(model: GPTForPretraining, cache: KVCache, state: SlotState,
                drafts, gen_cfg: GenerationConfig, host_flag: bool,
                seed: int = 0, page_table: Optional[torch.Tensor] = None,
                adapter_ids: Optional[torch.Tensor] = None, *,
                loop_ticks: int = 1
                ) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Up to ``loop_ticks`` speculative verify ticks in one round trip,
    eager (the JAX package's ``verify_loop``): tick ``j`` verifies
    ``drafts[:, j]`` of ``drafts [slots, loop_ticks, k]`` through
    exactly :func:`verify_step`'s tick body; exits as
    :func:`decode_loop` does.

    Returns ``(window_buf [slots, T, k+1], counts_buf [slots, T],
    ticks_run, exit_reason)``: tick ``j``'s token run and how many of it
    committed per slot (0 beyond ``ticks_run``).
    """
    drafts = np.asarray(drafts, np.int64)
    slots, t_axis, k = drafts.shape
    if t_axis != loop_ticks:
        raise ValueError(f"drafts tick axis ({t_axis}) != loop_ticks "
                         f"({loop_ticks})")
    carry = init_loop_carry(slots, loop_ticks, gen_cfg,
                            state.last_logits.device, spec_tokens=k)
    reset_loop_carry(carry, gen_cfg, host_flag, drafts)
    for _ in range(loop_ticks):
        loop_tick(model, cache, state, carry, gen_cfg, seed, page_table,
                  adapter_ids)
    return read_loop(state, carry, gen_cfg)


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


#: alignment of a page row's length in bytes: every pool tensor's
#: segment of a row views back into its own dtype in place
_ROW_ALIGN = 16


def _row_layout(pool: KVCache) -> List[torch.Tensor]:
    """The pool tensors in page-row order: every layer's K and V pools
    and, under the int8 cache, their fp32 scale pools, widest element
    first, so each segment of a row starts at a multiple of its own
    element size."""
    flat = [t for layer in pool for t in layer]
    return sorted(flat, key=lambda t: -t.element_size())


def kv_row_bytes(pool: KVCache) -> int:
    """Bytes of one page's row: its slice of every pool tensor
    (:func:`pack_kv_pages`), padded to ``_ROW_ALIGN``."""
    used = sum(t[0].numel() * t.element_size() for t in _row_layout(pool))
    return -(-used // _ROW_ALIGN) * _ROW_ALIGN


@torch.inference_mode()
def pack_kv_pages(pool: KVCache, pids: Sequence[int]) -> torch.Tensor:
    """Pack physical pages ``pids`` of every pool tensor (K, V and the
    int8 cache's scales, every layer) into one contiguous ``uint8 [n,
    kv_row_bytes(pool)]`` buffer on the pool's device, one row a page:
    the gather half of a spill (the JAX package's
    ``gather_kv_pages``, named apart from
    ``ops/cuda/flash_attention.py::gather_kv_pages``, which reads a
    page *table* into a contiguous cache). One indexed read per pool
    tensor and one concatenation, whatever ``n``: the row buffer then
    leaves the card in one copy."""
    dev = pool[0][0].device
    idx = torch.as_tensor(list(pids), dtype=torch.long, device=dev)
    n = idx.numel()
    parts = [t.index_select(0, idx).reshape(n, -1).view(torch.uint8)
             for t in _row_layout(pool)]
    pad = kv_row_bytes(pool) - sum(p.shape[1] for p in parts)
    if pad:
        parts.append(torch.zeros((n, pad), dtype=torch.uint8, device=dev))
    return torch.cat(parts, dim=1)


def stack_kv_rows(rows: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concatenate page rows (``[k, row_bytes]`` slices of
    :func:`pack_kv_pages` buffers, or their host copies) into one
    ``[n, row_bytes]`` buffer (the JAX package's ``stack_kv_pages``;
    its ``split_kv_pages`` is a row slice here), so a batched rehydrate
    scatters all its pages in one :func:`unpack_kv_pages`."""
    if len(rows) == 1:
        return rows[0]
    return torch.cat(list(rows), dim=0)


@torch.inference_mode()
def unpack_kv_pages(pool: KVCache, rows: torch.Tensor,
                    pids: Sequence[int]) -> None:
    """Write page rows (:func:`pack_kv_pages`'s layout, on the pool's
    device) into physical pages ``pids`` of every pool tensor, in
    place: one indexed write per pool tensor, whatever the page count
    (the JAX package's ``scatter_kv_pages``). In place, never a new
    pool: a captured decode graph holds the pool tensors' addresses.
    The destination ids need not be the pages the rows came from."""
    dev = pool[0][0].device
    idx = torch.as_tensor(list(pids), dtype=torch.long, device=dev)
    n = idx.numel()
    if rows.shape != (n, kv_row_bytes(pool)):
        raise ValueError(f"page rows {tuple(rows.shape)} do not fit {n} "
                         f"pages of {kv_row_bytes(pool)} bytes")
    off = 0
    for t in _row_layout(pool):
        nbytes = t[0].numel() * t.element_size()
        src = rows[:, off:off + nbytes].view(t.dtype).view(
            n, *t.shape[1:])
        t.index_copy_(0, idx, src)
        off += nbytes


@torch.inference_mode()
def activate_slot(state: SlotState, slot: int, length: int, dec_count: int,
                  nonce: int, appeared_row: torch.Tensor,
                  last_logits_row: torch.Tensor, rejected: int = -1) -> None:
    """Flip one slot live from host-computed state, in place on the
    device and in the mirror: the paged admission paths
    (chunked-prefill completion, whole-prompt registry hit, a preempted
    request's resume) activate through here. ``dec_count`` is nonzero
    only for resumes, so a requeued request's min-length and sampling
    stream continue where they stopped; ``rejected`` likewise restores a
    pending rejection residual."""
    state.lengths[slot] = int(length)
    state.dec_count[slot] = int(dec_count)
    state.nonce[slot] = int(nonce)
    state.finished[slot] = False
    state.active[slot] = True
    state.rejected[slot] = int(rejected)
    state.appeared[slot] = appeared_row
    state.last_logits[slot] = last_logits_row
    _mirror_admit(state, slot, int(dec_count), int(rejected))
