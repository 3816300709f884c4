"""Scaled dot-product attention dispatch of the port.

The counterpart of the JAX package's ``ops/attention.py::
dot_product_attention``, with its counter names
(``docs/attention_dispatch.md``):

- ``use_flash`` and fresh ``[b, s, h, d]`` keys (training forward and
  the port's prefill) -> kernel 1, :func:`ops.cuda.flash_attention.
  flash_attention` (``attention/flash``);
- ``use_flash`` and one query token against the ``[b, h, S, d]`` KV
  cache -> kernel 2: per-row offsets (a ``[b]`` tensor, the serving
  tick) take ``flash_decode_ragged`` (``attention/flash_decode_ragged``),
  one shared offset plus a per-key bias (the lockstep ``generate()``)
  takes ``flash_decode`` (``attention/flash_decode``);
- ``use_flash=False`` -> the dense PyTorch path below
  (``attention/fallback/flash_disabled`` + ``attention/dense``), as the
  JAX package does. That is a configuration choice: the port never
  takes the dense path because a kernel refused or failed, and
  attention shapes the kernels do not take (a multi-token window
  against the cache) raise ``NotImplementedError``.

Layout: ``q [b, sq, h, d]``; ``k/v [b, skv, h, d]``, or with
``kv_cache_layout`` the cache ``[b, h, S, d]`` (the port's cache
layout; the JAX package keeps ``[b, h, d, S]``). Output
``[b, sq, h, d]``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..observability import metrics
from .cuda import flash_attention as fa

#: score fill of the dense path (the JAX dense path's value)
NEG_INF = -1e9


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, causal: bool = True,
                    query_offset: Union[int, torch.Tensor] = 0,
                    kv_cache_layout: bool = False) -> torch.Tensor:
    """Attention that materializes the ``[b, h, sq, sk]`` scores, in
    the order of the JAX dense path (``_xla_attention``): scale q,
    scores in fp32, causal mask against ``i + query_offset`` (an int
    or a ``[b]`` tensor of per-row offsets), additive bias, softmax,
    probabilities cast to v's dtype."""
    head_dim = q.shape[-1]
    kk = k if kv_cache_layout else k.permute(0, 2, 1, 3)   # [b, h, sk, d]
    vv = v if kv_cache_layout else v.permute(0, 2, 1, 3)
    scores = torch.matmul((q * head_dim ** -0.5).permute(0, 2, 1, 3),
                          kk.transpose(-1, -2)).float()   # [b, h, sq, sk]
    if causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        q_pos = torch.arange(sq, device=q.device)[:, None]
        if torch.is_tensor(query_offset) and query_offset.dim() == 1:
            q_pos = q_pos + query_offset.to(q.device)[:, None, None, None]
        else:
            q_pos = q_pos + int(query_offset)
        live = torch.arange(sk, device=q.device)[None, :] <= q_pos
        scores = torch.where(live, scores, torch.full_like(scores, NEG_INF))
    if bias is not None:
        scores = scores + bias.float()
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(weights, vv).permute(0, 2, 1, 3)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          causal: bool = True,
                          query_offset: Union[int, torch.Tensor] = 0,
                          use_flash: bool = True,
                          kv_cache_layout: bool = False) -> torch.Tensor:
    """Causal attention through the port's kernels (see the module
    docstring for the dispatch and its counters).

    Args:
        q (torch.Tensor): ``[b, sq, h, d]``.
        k (torch.Tensor): ``[b, skv, h, d]``, or the cache
            ``[b, h, S, d]`` with ``kv_cache_layout``; ``v`` likewise.
        bias (torch.Tensor): additive, broadcastable to
            ``[b, h, sq, skv]``; on the decode path a per-key
            ``[b, 1, 1, S]`` bias.
        causal (bool): causal mask (query ``i`` sees keys
            ``<= i + query_offset``).
        query_offset: int, or a ``[b]`` int32 tensor of per-row
            offsets (ragged decode).
        use_flash (bool): the config's ``use_flash_attention``.
        kv_cache_layout (bool): k/v are the KV cache.

    Returns:
        ``[b, sq, h, d]`` in q's dtype.
    """
    if not use_flash:
        metrics.inc("attention/fallback/flash_disabled")
        metrics.inc("attention/dense")
        return dense_attention(q, k, v, bias, causal, query_offset,
                               kv_cache_layout)
    ragged = torch.is_tensor(query_offset) and query_offset.dim() == 1
    if kv_cache_layout:
        if not causal or q.shape[1] != 1:
            raise NotImplementedError(
                "the port's decode kernel takes one causal query token "
                "against the cache; multi-token windows (speculative "
                "verify, chunked prefill) are not ported")
        if ragged:
            if bias is not None:
                raise NotImplementedError(
                    "ragged decode carries no bias: per-slot validity "
                    "lives in the offsets")
            metrics.inc("attention/flash_decode_ragged")
            return fa.flash_decode_ragged(q, k, v, query_offset)
        metrics.inc("attention/flash_decode")
        return fa.flash_decode(q, k, v, int(query_offset), bias)
    if ragged or int(query_offset) != 0:
        raise NotImplementedError(
            "the flash forward kernel attends from query offset 0; "
            "offset queries go through the KV cache")
    metrics.inc("attention/flash")
    out, _ = fa.flash_attention(q, k, v, causal=causal, bias=bias)
    return out
