"""Scaled dot-product attention dispatch of the port.

The counterpart of the JAX package's ``ops/attention.py::
dot_product_attention``, with its counter names
(``docs/attention_dispatch.md``):

- ``use_flash`` and fresh ``[b, s, h, d]`` keys (training forward and
  the port's prefill) -> kernel 1, :func:`ops.cuda.flash_attention.
  flash_attention` (``attention/flash``), whose gradient runs kernels 3
  and 4; with a dropout rate > 0 (training) the same kernel drops
  probabilities in-kernel (``attention/flash_dropout``). The JAX
  package gates in-kernel dropout behind a per-TPU certificate file
  (its ``ops/attention.py:32-120``); the port has no gate: the chip
  smoke run checks the kernel's mask against the plain version on
  every run, so training always takes the kernel with dropout;
- ``use_flash`` and one query token against the ``[b, h, S, d]`` KV
  cache -> kernel 2: per-row offsets (a ``[b]`` tensor, the serving
  tick) take ``flash_decode_ragged`` (``attention/flash_decode_ragged``),
  one shared offset plus a per-key bias (the lockstep ``generate()``)
  takes ``flash_decode`` (``attention/flash_decode``);
- ``use_flash``, per-row offsets and a window of ``1 < W <= 32``
  queries against the contiguous cache (the speculative verify) ->
  kernel 5, ``flash_decode_verify``
  (``attention/flash_decode_ragged_verify``, the JAX counter of
  ``flash_decode_ragged`` with ``sq > 1``);
- ``use_flash`` and a ``page_table`` (``k/v`` are the paged pool
  ``[P, h, page, d]``): one query token with per-row offsets -> kernel
  6a, ``flash_decode_paged`` (``attention/flash_decode_paged``); a
  window of ``1 < W <= 32`` -> kernel 6b, ``flash_decode_paged_verify``
  (``attention/flash_decode_paged_verify``); every other paged shape
  (the page-sized chunks of a chunked prefill) gathers the rows'
  pages back into a contiguous cache and takes the dense path
  (``attention/fallback/kv_cache_layout`` + ``attention/dense``), as
  the JAX package does: that is the reference's own route for those
  shapes, not a retreat from a kernel;
- ``use_flash=False`` -> the dense PyTorch path below
  (``attention/fallback/flash_disabled`` + ``attention/dense``), as the
  JAX package does; it drops probabilities with the same Philox mask
  as the kernel (``ops/cuda/philox.py``), so both paths compare. That
  is a configuration choice: the port never
  takes the dense path because a kernel refused or failed, and
  attention shapes the kernels do not take (a window with a shared
  offset or a bias against the contiguous cache) raise
  ``NotImplementedError``.

An int8 cache (``kv_cache_dtype: int8``) comes with ``k_scale`` /
``v_scale``: each kernel branch takes its int8 instance and fires the
JAX counter with ``_int8`` appended (``attention/flash_decode_int8``,
``…_ragged_int8``, ``…_ragged_verify_int8``, ``…_paged_int8``,
``…_paged_verify_int8``); the dense route widens the cache up front,
``(k.float() * k_scale).to(q.dtype)``, and attends as it would over a
bf16 cache, as the JAX package's dense route does.

Layout: ``q [b, sq, h, d]``; ``k/v [b, skv, h, d]``, or with
``kv_cache_layout`` the cache ``[b, h, S, d]`` or, with a page table,
the pool ``[P, h, page, d]`` (the port's layouts; the JAX package keeps
``[b, h, d, S]`` and ``[P, h, d, page]``); an int8 cache's scales are
``[b, h, S]`` / ``[P, h, page]`` (the JAX package's ``[b, h, 1, S]`` /
``[P, h, 1, page]``). Output ``[b, sq, h, d]``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..observability import metrics
from .cuda import flash_attention as fa
from .cuda import philox

#: score fill of the dense path (the JAX dense path's value)
NEG_INF = -1e9


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, causal: bool = True,
                    query_offset: Union[int, torch.Tensor] = 0,
                    kv_cache_layout: bool = False,
                    dropout_rate: float = 0.0,
                    dropout_seed: Optional[int] = None) -> torch.Tensor:
    """Attention that materializes the ``[b, h, sq, sk]`` scores, in
    the order of the JAX dense path (``_xla_attention``): scale q,
    scores in fp32, causal mask against ``i + query_offset`` (an int
    or a ``[b]`` tensor of per-row offsets), additive bias, softmax,
    dropout with the kernels' Philox mask of ``dropout_seed``,
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
    weights = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0:
        b, h, sq, sk = weights.shape
        keep = philox.attention_keep_mask(dropout_seed, dropout_rate, b, h,
                                          sq, sk, weights.device)
        weights = torch.where(keep, weights * philox.keep_scale(
            dropout_rate), torch.zeros_like(weights))
    return torch.matmul(weights.to(v.dtype), vv).permute(0, 2, 1, 3)


def _dense_over_cache(q, k, v, bias, causal, query_offset, kv_cache_layout,
                      page_table, k_scale, v_scale, dropout_rate=0.0,
                      dropout_seed=None) -> torch.Tensor:
    """The dense route (``attention/dense``): a paged pool gathered back
    into per-row caches (scales too), an int8 cache widened up front
    with its scales to q's dtype, then :func:`dense_attention`."""
    metrics.inc("attention/dense")
    if page_table is not None:
        k = fa.gather_kv_pages(k, page_table)
        v = fa.gather_kv_pages(v, page_table)
        if k_scale is not None:
            k_scale = fa.gather_kv_pages(k_scale, page_table)
            v_scale = fa.gather_kv_pages(v_scale, page_table)
    if k_scale is not None:
        k = fa.dequantize_cache(k, k_scale).to(q.dtype)
        v = fa.dequantize_cache(v, v_scale).to(q.dtype)
    return dense_attention(q, k, v, bias, causal, query_offset,
                           kv_cache_layout, dropout_rate, dropout_seed)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          causal: bool = True,
                          query_offset: Union[int, torch.Tensor] = 0,
                          use_flash: bool = True,
                          kv_cache_layout: bool = False,
                          dropout_rate: float = 0.0,
                          dropout_seed: Optional[int] = None,
                          page_table: Optional[torch.Tensor] = None,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Causal attention through the port's kernels (see the module
    docstring for the dispatch and its counters).

    Args:
        q (torch.Tensor): ``[b, sq, h, d]``.
        k (torch.Tensor): ``[b, skv, h, d]``, or the cache
            ``[b, h, S, d]`` with ``kv_cache_layout``, or the pool
            ``[P, h, page, d]`` with a ``page_table``; ``v`` likewise.
        bias (torch.Tensor): additive, broadcastable to
            ``[b, h, sq, skv]``; on the decode path a per-key
            ``[b, 1, 1, S]`` bias.
        causal (bool): causal mask (query ``i`` sees keys
            ``<= i + query_offset``).
        query_offset: int, or a ``[b]`` int32 tensor of per-row
            offsets (ragged decode, verify, chunked prefill).
        use_flash (bool): the config's ``use_flash_attention``.
        kv_cache_layout (bool): k/v are the KV cache.
        dropout_rate (float): attention-probability dropout (training
            only: callers pass 0 in eval and generation).
        dropout_seed (int): the seed of the dropout mask.
        page_table (torch.Tensor): ``[b, max_pages]`` int32 physical
            page ids of each row's logical pages (requires
            ``kv_cache_layout``).
        k_scale, v_scale (torch.Tensor): an int8 cache's fp32 scales,
            the cache minus its d axis (both or neither; require
            ``kv_cache_layout``).

    Returns:
        ``[b, sq, h, d]`` in q's dtype.
    """
    ragged = torch.is_tensor(query_offset) and query_offset.dim() == 1
    if (k_scale is None) is not (v_scale is None):
        raise ValueError("k_scale and v_scale come together")
    if k_scale is not None and not kv_cache_layout:
        raise ValueError("KV scales require kv_cache_layout (the int8 "
                         "cache is decode-only)")
    if page_table is not None and not kv_cache_layout:
        raise ValueError("page_table requires kv_cache_layout")
    int8 = "_int8" if k_scale is not None else ""
    scales = {"k_scale": k_scale, "v_scale": v_scale}
    if not use_flash:
        metrics.inc("attention/fallback/flash_disabled")
        return _dense_over_cache(q, k, v, bias, causal, query_offset,
                                 kv_cache_layout, page_table, k_scale,
                                 v_scale, dropout_rate, dropout_seed)
    window = q.shape[1]
    if kv_cache_layout:
        if dropout_rate > 0.0:
            raise NotImplementedError(
                "attention dropout is a training feature; the decode "
                "kernels take none")
        verify = causal and ragged and bias is None and \
            1 < window <= fa.MAX_VERIFY_WINDOW
        if page_table is not None:
            if causal and ragged and bias is None and window == 1:
                metrics.inc("attention/flash_decode_paged" + int8)
                return fa.flash_decode_paged(q, k, v, query_offset,
                                             page_table, **scales)
            if verify:
                metrics.inc("attention/flash_decode_paged_verify" + int8)
                return fa.flash_decode_paged_verify(q, k, v, query_offset,
                                                    page_table, **scales)
            # chunked prefill (page-sized windows) and other paged
            # shapes: the JAX package's gather + dense route
            metrics.inc("attention/fallback/kv_cache_layout")
            return _dense_over_cache(q, k, v, bias, causal, query_offset,
                                     True, page_table, k_scale, v_scale)
        if verify:
            metrics.inc("attention/flash_decode_ragged_verify" + int8)
            return fa.flash_decode_verify(q, k, v, query_offset, **scales)
        if not causal or window != 1:
            raise NotImplementedError(
                "the port's decode kernels take one causal query token, "
                f"or a window of up to {fa.MAX_VERIFY_WINDOW} with per-row "
                "offsets and no bias, against the contiguous cache")
        if ragged:
            if bias is not None:
                raise NotImplementedError(
                    "ragged decode carries no bias: per-slot validity "
                    "lives in the offsets")
            metrics.inc("attention/flash_decode_ragged" + int8)
            return fa.flash_decode_ragged(q, k, v, query_offset, **scales)
        metrics.inc("attention/flash_decode" + int8)
        return fa.flash_decode(q, k, v, int(query_offset), bias, **scales)
    if ragged or int(query_offset) != 0:
        raise NotImplementedError(
            "the flash forward kernel attends from query offset 0; "
            "offset queries go through the KV cache")
    if dropout_rate > 0.0:
        metrics.inc("attention/flash_dropout")
    else:
        metrics.inc("attention/flash")
    out, _ = fa.flash_attention(q, k, v, causal=causal, bias=bias,
                                dropout_rate=dropout_rate,
                                seed=dropout_seed)
    return out
