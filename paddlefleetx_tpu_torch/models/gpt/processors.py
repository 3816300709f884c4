"""Logits processors for generation (the port of the JAX package's
``models/gpt/processors.py``): min-length, repetition penalty and the
fused top-k / top-p filter, each ``(logits [b, V], ...) -> logits``.

The port's top-k is always exact (``torch.topk``). The JAX package may
use ``lax.approx_max_k`` instead (``GenerationConfig.approx_top_k``,
recall 0.99), whose contract is that the candidate set is a superset
of the exact one; the exact set satisfies it, so the config flag is
accepted and the port filters exactly.
"""

from __future__ import annotations

import torch

NEG_INF = -1e9


def min_length_processor(logits: torch.Tensor, cur_len, min_length: int,
                         eos_token_id: int) -> torch.Tensor:
    """Suppress EOS while the generated length ``cur_len`` (an int or a
    ``[b, 1]`` tensor) is below ``min_length``."""
    suppress = torch.as_tensor(cur_len, device=logits.device) < min_length
    eos = torch.arange(logits.shape[-1], device=logits.device) == \
        eos_token_id
    return torch.where(suppress & eos[None, :],
                       torch.full_like(logits, NEG_INF), logits)


def repetition_penalty_processor(logits: torch.Tensor,
                                 appeared: torch.Tensor,
                                 penalty: float) -> torch.Tensor:
    """Penalize tokens in ``appeared [b, V]``: positive logits divided
    by ``penalty``, negative ones multiplied."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(appeared, penalized, logits)


def top_k_filter(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Keep the ``top_k`` highest logits per row (ties at the k-th
    value kept); ``top_k <= 0`` keeps everything."""
    if top_k <= 0:
        return logits
    top_k = min(top_k, logits.shape[-1])
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF),
                       logits)


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filter: keep the smallest set of tokens whose cumulative
    probability exceeds ``top_p`` (a token is dropped once the mass
    before it reaches ``top_p``)."""
    if top_p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    return _nucleus(logits, sorted_logits, probs, top_p)


def _nucleus(logits, sorted_logits, probs, top_p):
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p
    threshold = torch.where(keep, sorted_logits,
                            torch.full_like(sorted_logits, float("inf"))
                            ).amin(dim=-1, keepdim=True)
    return torch.where(logits < threshold, torch.full_like(logits, NEG_INF),
                       logits)


def top_k_top_p_filter(logits: torch.Tensor, top_k: int,
                       top_p: float) -> torch.Tensor:
    """Top-k then top-p from one ``topk`` of the vocabulary, equal to
    ``top_p_filter(top_k_filter(x, top_k), top_p)``: the nucleus mass
    uses the full filtered vector's logsumexp, so ties at the k-th
    value count as in the two-pass form."""
    vocab = logits.shape[-1]
    if top_k <= 0 or top_k >= vocab:
        return top_p_filter(top_k_filter(logits, top_k), top_p)
    sorted_logits = torch.topk(logits, top_k, dim=-1).values
    filtered = torch.where(logits < sorted_logits[..., -1:],
                           torch.full_like(logits, NEG_INF), logits)
    if top_p >= 1.0:
        return filtered
    denom = torch.logsumexp(filtered, dim=-1, keepdim=True)
    probs = torch.exp(sorted_logits - denom)
    return _nucleus(filtered, sorted_logits, probs, top_p)
