"""Mixture-of-Experts FFN (the port of the JAX package's
``models/gpt/moe.py``).

A fp32 router picks the top-k experts of each token (GShard / Switch
routing, capacity-limited per expert and batch row); the tokens reach
their experts' capacity slots through one of the ``moe_dispatch``
lowerings:

- ``"einsum"``: the one-hot dispatch / gate-weighted combine tensors
  ``[b, s, E, C]`` and batched matmuls (the reference formulation);
- ``"sort"``: counting-sort routing (:func:`sort_routing`), a gather
  into the grouped ``[E, b, C, h]`` buffer, batched matmuls over it and
  a gather + gate weighting back;
- ``"sort_pallas"``: ``"sort"`` with the two expert matmuls on the
  grouped GEMM (kernel 8, ``ops/cuda/grouped_matmul.py``; its gradient
  runs kernel 8 for dx and kernel 9 for dw), which gives zeros for the
  (expert, row) groups no token was routed to.

The layer takes whatever ``[b, s, h]`` a forward gives it, and each
batch row is one routing group with the capacity of ``s`` tokens
(:func:`expert_capacity`): a training microbatch's rows, and in serving
a contiguous admission ``[n, bucket, h]``, a paged prefill chunk ``[1,
chunk, h]``, a decode tick ``[slots, 1, h]`` or a verify window
``[slots, W, h]``, as the JAX layer routes them. A forward that asks
for no router loss (``need_aux`` False: every serving forward) skips
it; ``y`` does not depend on it.

All three keep the same dropped-token set (the positions of
:func:`_routing_plan`) and the same parameters, with the JAX names and
layouts: ``router_kernel [h, E]``, ``wi [E, h, m]``, ``wi_bias [E, m]``,
``wo [E, m, h]``, ``wo_bias [E, h]``. The layer returns its weighted
auxiliary loss (Switch load balance ``E * sum_e f_e P_e`` plus the
router z-loss ``mean(logsumexp(logits)^2)``), which the training loss
adds. Each call counts its lowering in ``moe/einsum``, ``moe/sort`` or
``moe/sort_pallas``. The JAX ``moe/fallback/pallas_rejected`` route has
no counterpart: ``sort_pallas`` always calls the grouped GEMM, which
launches its kernel on CUDA tensors or raises.

In the port the router runs outside ``torch.autocast``, in fp32 on fp32
weights (bf16 logits would make top-k ties and the z-loss noisy), and
the expert GEMMs run on operands cast to the compute dtype explicitly,
as the JAX ``w1.astype(dtype)``. The expert GEMMs run in the recompute
sites ``mlp1`` and ``mlp2``, so ``save_dots`` keeps them. Expert
dropout (``hidden_dropout_prob``) draws with the seed of the block's
site ``MoEMLP.DROPOUT_SITE`` (:func:`model.fold_seed`): its streams
differ from flax's.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...observability import metrics
from ...ops.cuda import grouped_matmul as gmm
from .config import GPTConfig
from .model import _site, compute_dtype, hidden_dropout


def expert_capacity(cfg: GPTConfig, seq_len: int) -> int:
    """Per-expert capacity slots of one routing group (one batch row):
    ``ceil(top_k * seq * capacity_factor / num_experts)``, at least 1."""
    return max(1, int(math.ceil(
        cfg.moe_top_k * seq_len * cfg.moe_capacity_factor
        / cfg.moe_num_experts)))


def _routing_plan(probs: torch.Tensor, top_k: int, capacity: int):
    """Routing decisions shared by every dispatch lowering (the JAX
    ``_routing_plan``).

    Returns ``(gate, idx, pos, keep, flat, aux_frac)``: fp32 ``[b, s, k]``
    top-k gates (renormalized for k > 1), int64 ``[b, s, k]`` expert ids,
    int32 ``[b, s*k]`` position of each (token, choice) in its expert's
    slot queue (earlier tokens first, a token's choices adjacent), bool
    ``[b, s*k]`` whether it fits under ``capacity``, int32 ``[b, s*k,
    E]`` one-hot choices, and fp32 ``[E]`` the fraction of tokens whose
    first choice is each expert (before capacity drops)."""
    b, s, n_exp = probs.shape
    gate, idx = torch.topk(probs, top_k, dim=-1)
    if top_k > 1:
        gate = gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    onehot = F.one_hot(idx, n_exp).to(torch.int32)       # [b, s, k, E]
    flat = onehot.reshape(b, s * top_k, n_exp)
    pos = ((torch.cumsum(flat, dim=1, dtype=torch.int32) - flat) *
           flat).sum(dim=-1, dtype=torch.int32)           # [b, s*k]
    keep = pos < capacity
    aux_frac = onehot[:, :, 0, :].float().mean(dim=(0, 1))
    return gate, idx, pos, keep, flat, aux_frac


def router_dispatch(probs: torch.Tensor, top_k: int, capacity: int):
    """Token-choice routing as dense one-hot tensors (the einsum path):
    ``(dispatch, combine, aux_frac)`` with 0/1 ``dispatch [b, s, E, C]``
    (a capacity-dropped token's row is zero: it passes through the
    residual only), fp32 gate-weighted ``combine [b, s, E, C]`` and
    ``aux_frac`` as in :func:`_routing_plan`."""
    b, s, n_exp = probs.shape
    gate, _, pos, keep, flat, aux_frac = _routing_plan(probs, top_k,
                                                       capacity)
    kept = keep[..., None] * flat                          # [b, s*k, E]
    # a position past the capacity has no slot (jax.nn.one_hot's zeros)
    slot = F.one_hot(pos.long().clamp_max(capacity),
                     capacity + 1)[..., :capacity].float()
    dispatch = torch.einsum("bte,btc->btec", kept.float(), slot)
    dispatch = dispatch.reshape(b, s, top_k, n_exp, capacity)
    combine = torch.einsum("bskec,bsk->bsec", dispatch, gate)
    return dispatch.sum(dim=2), combine, aux_frac


def sort_routing(probs: torch.Tensor, top_k: int, capacity: int):
    """Counting-sort routing plan (the sort paths; the JAX
    ``sort_routing``).

    Returns ``(gate, dest, src, counts, aux_frac)``: fp32 ``[b, s, k]``
    gates; int32 ``dest [b, s*k]``, the grouped-buffer slot ``e * C +
    pos`` of each (token, choice), ``E * C`` (one past the end) for a
    dropped one; int32 ``src [b, E*C]``, the token row feeding each slot,
    ``s`` (the zero pad row) for an empty one; int32 ``counts [b, E]``
    kept tokens per (batch row, expert); ``aux_frac``. The dropped
    choices are scattered into a column past the end, which is cut: on
    the card a scatter out of range would be a device-side assert."""
    b, s, n_exp = probs.shape
    c = capacity
    gate, idx, pos, keep, flat, aux_frac = _routing_plan(probs, top_k, c)
    t = s * top_k
    flat_e = idx.reshape(b, t).to(torch.int32)
    dest = torch.where(keep, flat_e * c + pos,
                       torch.full_like(pos, n_exp * c))
    src_choice = torch.full((b, n_exp * c + 1), t, dtype=torch.int32,
                            device=probs.device)
    choice = torch.arange(t, dtype=torch.int32,
                          device=probs.device).expand(b, t)
    src_choice.scatter_(1, dest.long(), choice)
    # choice i came from token i // k; an empty slot holds t, and
    # t // k == s is the zero pad row
    src = src_choice[:, :n_exp * c] // top_k
    counts = flat.sum(dim=1).clamp_max(c).to(torch.int32)
    return gate, dest, src, counts, aux_frac


class MoEMLP(nn.Module):
    """The decoder block's FFN as ``moe_num_experts`` routed experts.

    ``forward(x, dropout_seed)`` returns ``(y, aux)``: ``y [b, s, h]``
    in the compute dtype and the weighted auxiliary loss, an fp32
    scalar. The parameters are the same in every ``moe_dispatch``
    mode."""

    #: the block's dropout site of the expert FFN (0-2: attention,
    #: dropout1, dropout2)
    DROPOUT_SITE = 3

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        n_exp, h, m = cfg.moe_num_experts, cfg.hidden_size, \
            cfg.ffn_hidden_size
        self.router_kernel = nn.Parameter(torch.zeros(h, n_exp))
        self.wi = nn.Parameter(torch.zeros(n_exp, h, m))
        self.wi_bias = nn.Parameter(torch.zeros(n_exp, m))
        self.wo = nn.Parameter(torch.zeros(n_exp, m, h))
        self.wo_bias = nn.Parameter(torch.zeros(n_exp, h))

    def forward(self, x: torch.Tensor, dropout_seed: Optional[int] = None,
                need_aux: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """Route ``x [b, s, h]`` through the experts; ``dropout_seed``
        the expert dropout's (None: none). Without ``need_aux`` the aux
        loss returned is 0 (not computed)."""
        cfg = self.cfg
        n_exp, k = cfg.moe_num_experts, cfg.moe_top_k
        b, s, h = x.shape
        dtype = compute_dtype(cfg)
        with torch.autocast(x.device.type, enabled=False):
            logits = torch.einsum("bsh,he->bse", x.float(),
                                  self.router_kernel.float())
            probs = torch.softmax(logits, dim=-1)
        xd = x.to(dtype)
        c = expert_capacity(cfg, s)
        if cfg.moe_dispatch == "einsum":
            metrics.inc("moe/einsum")
            dispatch, combine, aux_frac = router_dispatch(probs, k, c)
            xe = torch.einsum("bsec,bsh->ebch", dispatch.to(dtype), xd)
            y = self._expert_ffn(xe, None, dropout_seed)
            out = torch.einsum("ebch,bsec->bsh", y, combine.to(dtype))
        else:
            gate, dest, src, counts, aux_frac = sort_routing(probs, k, c)
            x_pad = torch.cat([xd, xd.new_zeros(b, 1, h)], dim=1)
            xs = torch.gather(x_pad, 1, src.long()[..., None].expand(
                b, n_exp * c, h))
            xe = xs.reshape(b, n_exp, c, h).transpose(0, 1)
            y = self._expert_ffn(
                xe, counts if cfg.moe_dispatch == "sort_pallas" else None,
                dropout_seed)
            # combine: per-choice gather, gate weighted; a dropped choice
            # reads the zero pad slot (a fully dropped token: residual)
            yf = y.transpose(0, 1).reshape(b, n_exp * c, h)
            yf = torch.cat([yf, yf.new_zeros(b, 1, h)], dim=1)
            yc = torch.gather(yf, 1, dest.long()[..., None].expand(
                b, s * k, h))
            out = torch.einsum("bskh,bsk->bsh", yc.reshape(b, s, k, h),
                               gate.to(y.dtype))
        aux = probs.new_zeros(())
        if not need_aux:
            return out, aux
        if cfg.moe_aux_loss_weight:
            load_balance = n_exp * (aux_frac * probs.mean(dim=(0, 1))).sum()
            aux = aux + cfg.moe_aux_loss_weight * load_balance
        if cfg.moe_z_loss_weight:
            z = torch.logsumexp(logits, dim=-1).pow(2).mean()
            aux = aux + cfg.moe_z_loss_weight * z
        return out, aux

    def _expert_ffn(self, xe: torch.Tensor, counts: Optional[torch.Tensor],
                    dropout_seed: Optional[int]) -> torch.Tensor:
        """The expert MLP over the grouped ``[E, b, C, h]`` buffer.

        ``counts`` (int32 ``[b, E]``, sort_pallas only) puts the two
        matmuls on the grouped GEMM, the groups ordered (expert, row);
        None keeps batched matmuls. Biases, GELU and dropout stay
        outside the kernel, so every mode shares them."""
        cfg = self.cfg
        dtype = compute_dtype(cfg)
        n_exp, bb, c, h = xe.shape
        m = cfg.ffn_hidden_size
        w1, w2 = self.wi.to(dtype), self.wo.to(dtype)
        g_counts = None
        if counts is not None:
            g_counts = counts.t().reshape(n_exp * bb)
            metrics.inc("moe/sort_pallas")
        elif cfg.moe_dispatch == "sort":
            metrics.inc("moe/sort")
        with _site("mlp1"):
            if g_counts is not None:
                y = gmm.grouped_matmul(xe.reshape(n_exp * bb, c, h), w1,
                                       g_counts).reshape(n_exp, bb, c, m)
            else:
                y = torch.einsum("ebch,ehm->ebcm", xe, w1)
        y = y + self.wi_bias.to(dtype)[:, None, None, :]
        y = F.gelu(y, approximate="tanh")
        y = hidden_dropout(y, cfg.hidden_dropout_prob, dropout_seed)
        with _site("mlp2"):
            if g_counts is not None:
                # the padding rows here are gelu(b1), not zero: their
                # outputs are never combined, so their gradient is zero
                y = gmm.grouped_matmul(y.reshape(n_exp * bb, c, m), w2,
                                       g_counts).reshape(n_exp, bb, c, h)
            else:
                y = torch.einsum("ebcm,emh->ebch", y, w2)
        return y + self.wo_bias.to(dtype)[:, None, None, :]
