"""The multi-adapter LoRA delta of a mixed-adapter batch (the port of the
JAX package's ``ops/lora.py``).

Multi-tenant LoRA serving puts requests for different adapters in one
batch: every row carries a bank row id and the delta of a dense site is
``(x @ A[id]) @ B[id]`` against that row's adapter pair, from the
stacked banks ``lora_a [A, K, r]`` / ``lora_b [A, r, N]``
(``models/gpt/model.py::LoRADelta``). :func:`grouped_lora_delta` runs
it as the JAX package does, with adapters in the role of the MoE
experts of the grouped GEMM (kernel 8, ``ops/cuda/grouped_matmul.py``):

1. a stable sort of the ``M`` rows by id (the counting-sort layout of
   the MoE sort dispatch);
2. a scatter into an ``[A, C, K]`` buffer, ``C`` = M rounded up to 8,
   group ``g`` holding its rows at positions ``0 .. counts[g] - 1``;
3. two grouped GEMMs, ``x @ A`` then ``(xA) @ B``, the banks cast to
   x's dtype; a group no row uses is skipped by the kernel (zeros);
4. a gather back into row order.

Its gradient is the grouped GEMM's: dx by kernel 8 over the transposed
bank, the banks' gradient by kernel 9. On CUDA tensors the grouped GEMM
launches its kernel or raises; nothing here falls back.
:func:`fallback_lora_delta`, the JAX package's gather-einsum form, is
the plain version the tests hold the grouped form to; the model never
calls it, and it counts ``lora/fallback`` when it runs.

Row semantics: id 0 is the reserved zero adapter (the base model). The
caller zeroes id-0 rows before the delta and masks them after it, so
whatever bank row 0 holds never reaches the output.
"""

from __future__ import annotations

import torch

from ..observability import metrics
from .cuda import grouped_matmul as gmm


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def grouped_lora_delta(x2: torch.Tensor, ids: torch.Tensor,
                       lora_a: torch.Tensor,
                       lora_b: torch.Tensor) -> torch.Tensor:
    """Per-row adapter delta ``out[m] = (x2[m] @ A[ids[m]]) @ B[ids[m]]``
    through the grouped-GEMM pair (kernel 8 twice).

    Args:
        x2 (torch.Tensor): ``[M, K]`` site input rows (id-0 rows zeroed
            by the caller).
        ids (torch.Tensor): ``[M]`` integer bank row per row, in
            ``[0, A)``.
        lora_a (torch.Tensor): ``[A, K, r]`` down-projection bank.
        lora_b (torch.Tensor): ``[A, r, N]`` up-projection bank.

    Returns:
        ``[M, N]`` in x2's dtype, unscaled (the caller applies the scale
        and the id-0 mask).

    Raises:
        NotImplementedError: the operands are not of that layout (the
            JAX package's admission).
    """
    if x2.dim() != 2 or lora_a.dim() != 3 or lora_b.dim() != 3:
        raise NotImplementedError(
            f"grouped_lora_delta wants x[M,K] a[A,K,r] b[A,r,N], got "
            f"{tuple(x2.shape)} / {tuple(lora_a.shape)} / "
            f"{tuple(lora_b.shape)}")
    m, k = x2.shape
    num_adapters, k_a, r = lora_a.shape
    if k_a != k or tuple(lora_b.shape[:2]) != (num_adapters, r):
        raise NotImplementedError(
            f"grouped_lora_delta bank mismatch: x {tuple(x2.shape)}, a "
            f"{tuple(lora_a.shape)}, b {tuple(lora_b.shape)}")
    ids = ids.to(device=x2.device, dtype=torch.long)
    # counting-sort layout: at worst every row lands on one adapter, so
    # each group's capacity is M rounded up to 8 (the JAX sublane tile)
    capacity = _round_up(max(m, 1), 8)
    order = torch.argsort(ids, stable=True)
    sids = ids[order]
    # JAX's bincount(length=A), counted on the device: torch.bincount
    # reads the ids' maximum back to the host on CUDA, a sync per site
    counts = torch.zeros(num_adapters, dtype=torch.long,
                         device=ids.device).index_add_(
        0, ids, torch.ones_like(ids))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(m, device=x2.device) - starts[sids]
    xg = x2.new_zeros((num_adapters, capacity, k)).index_put(
        (sids, pos), x2[order])
    h = gmm.grouped_matmul(xg, lora_a.to(x2.dtype), counts)
    d = gmm.grouped_matmul(h, lora_b.to(x2.dtype), counts)
    return d.new_zeros((m, d.shape[-1])).index_put((order,), d[sids, pos])


def fallback_lora_delta(x2: torch.Tensor, ids: torch.Tensor,
                        lora_a: torch.Tensor,
                        lora_b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`grouped_lora_delta`, the JAX package's
    gather-einsum form: per-row bank gathers and two batched
    contractions, in x2's dtype. Counts ``lora/fallback``."""
    metrics.inc("lora/fallback")
    ids = ids.to(device=x2.device, dtype=torch.long)
    a = lora_a.to(x2.dtype)[ids]              # [M, K, r]
    b = lora_b.to(x2.dtype)[ids]              # [M, r, N]
    h = torch.einsum("mk,mkr->mr", x2, a)
    return torch.einsum("mr,mrn->mn", h, b)
