"""GPT in PyTorch: the port of the JAX package's ``models/gpt/model.py``.

Architecture parity (and parameter parity through ``convert.py``):
learned word + position embeddings; pre-LayerNorm decoder blocks
(``LayerNorm(eps=1e-5)``) with a fused ``qkv_proj`` whose features are
``(3, nh, hd)`` and an ``out_proj`` over ``(nh, hd)``; a tanh-GELU MLP;
a final LayerNorm; logits tied to the word embedding. The decoder is a
plain ``nn.ModuleList`` (the JAX ``scan_layers`` choice is a compile
time trade that eager PyTorch does not have; ``convert.py`` reads both
JAX layouts).

Training (``build_model(..., train=True)``) keeps fp32 master weights
and computes in bf16 through ``torch.autocast`` when the config asks
for bf16 (:func:`compute_context`). Dropout sits at the JAX sites: the
embeddings, ``dropout1`` / ``dropout2`` of each block and the attention
probabilities. Every mask is a pure function of the step's dropout seed
and its site (:func:`fold_seed`): the hidden masks come from a
``torch.Generator`` seeded per site, the attention mask from Philox in
the kernel, so a recompute redraws the same masks. With
``use_recompute`` each block runs under ``torch.utils.checkpoint``
(non-reentrant); the granularities other than ``full`` are selective
activation checkpointing policies that read the site a dispatched op
belongs to (:func:`recompute_policy`). The LM losses are
:func:`cross_entropy_loss` and :func:`chunked_lm_loss`.

KV cache: one ``(k, v)`` pair per layer, each ``[b, h, S, d]`` with
``S = cache_capacity`` (the port's layout, see ``ops/attention.py``),
or under paged serving a global page pool ``[kv_pool_pages, h,
kv_page_size, d]`` per layer that every row reaches through its
``page_table`` row (the JAX pool is ``[P, h, d, page]``). Under
``kv_cache_dtype: int8`` each layer holds ``(k, v, k_scale, v_scale)``:
int8 K and V and one fp32 scale per (row, head, position), ``[b, h,
S]`` or ``[P, h, page]`` (the JAX ``[b, h, 1, S]`` / ``[P, h, 1,
page]``); every write quantizes (:func:`quantize_kv`) and writes values
and scales to the same positions. The cache is
updated IN PLACE (PyTorch is not functional): a prefill writes
positions ``0..s-1`` of its rows, a decode step writes ``s >= 1``
positions per row from that row's offset (``s > 1``: the speculative
verify window), a paged chunk (``chunk_start``) drops a page-aligned
chunk straight into its pages. Prefill attends over the prompt's fresh
q/k/v through the flash forward kernel (``attention/flash``): with
query offset 0 every key past the prompt is causally masked, so this
equals the JAX package's dense attention over the whole capacity. A
prefill asked for with ``causal=False`` (an MoE model's lockstep
``generate()``) takes its whole mask from a ``[b, 1, s, s]`` bias.
Decode and verify attend over the cache through the decode kernels
(``ops/attention.py`` lists the routes and their counters); a paged
prefill chunk takes the JAX package's gather + dense route. Under the
int8 cache the prefill attends over the round-tripped keys and values
(quantized, then widened back), which is what the JAX package's dense
prefill reads from its int8 cache.

Under ``quant_execution: weight_only_int8`` the four dense sites (qkv,
out, fc1, fc2) are :class:`QuantLinear`: an int8 weight and fp32 scales
through the int8 matmul kernel (``ops/cuda/quantized_matmul.py``).

With ``lora_rank > 0`` each of those four sites also carries a bank of
adapters (:class:`LoRADelta`: ``qkv_proj_lora``, ``out_proj_lora``,
``linear1_lora``, ``linear2_lora``), whose delta is added after the
site's bias for the bank rows the forward's ``adapter_ids`` name (one a
batch row; row 0 is the base model), through the grouped GEMM
(``ops/lora.py``). Without ``adapter_ids`` the delta is zero and runs
nothing, as in the JAX package.

With ``moe_num_experts > 0`` each block's FFN is ``moe_mlp``, the routed
experts of ``moe.py`` (under ``sort_pallas`` on the grouped GEMM,
kernels 8 and 9); each block returns its router auxiliary loss beside
its output, :class:`GPTModel` sums them (``return_aux``) and the
training losses add the sum, as the JAX package's sown ``moe_aux``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import List, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from ...core.quantize import quantize_state_dict
from ...observability import metrics
from ...ops.attention import dot_product_attention
from ...ops.cuda import flash_attention as fa
from ...ops.cuda import grouped_matmul  # noqa: F401 (pfx::grouped_matmul)
from ...ops.cuda import quantized_matmul as qmm
from ...ops.lora import grouped_lora_delta
from .config import GPTConfig

#: per layer ``(k, v)``, or ``(k, v, k_scale, v_scale)`` for an int8 cache
KVCache = List[Tuple[torch.Tensor, ...]]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_M64 = (1 << 64) - 1


def compute_dtype(cfg: GPTConfig) -> torch.dtype:
    """The torch dtype of ``cfg.dtype``."""
    return _DTYPES[cfg.dtype]


def compute_context(cfg: GPTConfig, device: torch.device):
    """The context a training forward runs in: ``torch.autocast`` to
    bf16 over fp32 weights when ``cfg.dtype`` is bf16, else nothing."""
    if cfg.dtype == "bfloat16":
        return torch.autocast(device.type, dtype=torch.bfloat16)
    return contextlib.nullcontext()


def fold_seed(seed: int, *keys: int) -> int:
    """A dropout seed in ``[0, 2^63)`` for site ``keys`` under ``seed``
    (a splitmix64 fold): step, microbatch, layer and site each get
    their own stream, and the same keys give the same seed."""
    x = int(seed) & _M64
    for k in keys:
        x = (x + 0x9E3779B97F4A7C15 * (int(k) + 1)) & _M64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
        x ^= x >> 31
    return x >> 1


def hidden_dropout(x: torch.Tensor, rate: float,
                   seed: Optional[int]) -> torch.Tensor:
    """Dropout of ``x`` at ``rate`` with the mask of a generator seeded
    with ``seed`` (None or rate 0: ``x`` unchanged); kept values are
    divided by ``1 - rate``, as flax's ``nn.Dropout`` does."""
    if seed is None or rate <= 0.0:
        return x
    gen = torch.Generator(device=x.device)
    gen.manual_seed(int(seed))
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


# -- recompute ----------------------------------------------------------
#
# The JAX package names the block's matmul outputs with checkpoint_name
# ("attn": q/k/v and the flash output + lse, "attn_out", "mlp1",
# "mlp2"; "core_attn": the dense path's internals) and picks a remat
# policy by name (its model.py:300-324). Here the model marks the site
# each op runs in (``_site``) and the selective checkpoint policy reads
# it as each op is dispatched.

_SITE: List[Optional[str]] = [None]


@contextlib.contextmanager
def _site(name: str):
    prev = _SITE[0]
    _SITE[0] = name
    try:
        yield
    finally:
        _SITE[0] = prev


@functools.lru_cache(maxsize=None)
def _dot_ops() -> frozenset:
    # bmm: the expert einsums of the MoE einsum and sort modes; the
    # grouped GEMM: sort_pallas
    return frozenset((torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                      torch.ops.aten.bmm.default,
                      torch.ops.pfx.flash_attention.default,
                      torch.ops.pfx.grouped_matmul.default))


def recompute_policy(granularity: str):
    """The selective checkpoint policy of a recompute granularity:
    ``save_dots`` keeps the matmul and flash-attention outputs of the
    ``attn``, ``attn_out``, ``mlp1`` and ``mlp2`` sites and recomputes
    the rest (norms, GELU, residuals, dropout); ``full_attn`` keeps all
    but the attention sites; ``core_attn`` all but the dense path's
    internals. ``full`` has no policy: the whole block recomputes."""
    if granularity not in ("save_dots", "full_attn", "core_attn"):
        raise ValueError(granularity)

    def policy(ctx, op, *args, **kwargs):
        site = _SITE[0]
        if granularity == "save_dots":
            save = site in ("attn", "attn_out", "mlp1", "mlp2") and \
                op in _dot_ops()
        elif granularity == "full_attn":
            save = site not in ("attn", "core_attn")
        else:
            save = site != "core_attn"
        return ckpt.CheckpointPolicy.MUST_SAVE if save else \
            ckpt.CheckpointPolicy.PREFER_RECOMPUTE

    return policy


class QuantLinear(nn.Module):
    """Weight-only int8 twin of ``nn.Linear`` at a dense site
    (``quant_execution: weight_only_int8``; the port of the JAX
    package's ``_QuantDense``).

    It holds an int8 ``weight`` ``[out, in]`` buffer and an fp32
    ``weight_scale`` ``[out]`` buffer (the frozen PTQ artifact
    ``core/quantize.py`` emits) and the ``bias``. A site the kernel
    admits (in and out multiples of 128) runs the int8 matmul kernel
    (``quant/matmul``); any other takes the JAX package's own per-site
    route, dequantize then matmul (``quant/fallback/kernel_rejected``).
    The scales stay fp32 whatever dtype the module is cast to, as the
    JAX scales do. The weight and scales are frozen (buffers, no
    gradient); the input's gradient runs kernel 7's dx route, as the
    JAX package's ``_quantized_matmul_bwd`` does.
    """

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.register_buffer("weight", torch.zeros(
            (out_features, in_features), dtype=torch.int8))
        self.register_buffer("weight_scale", torch.ones(
            out_features, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def _apply(self, fn, recurse=True):
        # the scales move with the module but keep fp32
        scale = self._buffers.pop("weight_scale")
        try:
            super()._apply(fn, recurse)
            scale = scale.to(fn(scale[:0]).device)
        finally:
            self._buffers["weight_scale"] = scale
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ dequant(weight)^T + bias`` over the last dim of x."""
        lead = x.shape[:-1]
        x2 = x.reshape(-1, self.in_features).contiguous()
        if qmm.admits(self.in_features, self.out_features):
            y = qmm.quantized_matmul(x2, self.weight, self.weight_scale)
            metrics.inc("quant/matmul")
        else:
            metrics.inc("quant/fallback/kernel_rejected")
            w = (self.weight.float() * self.weight_scale[:, None]).to(
                x.dtype)
            y = x2 @ w.t()
        return (y + self.bias.to(y.dtype)).view(*lead, self.out_features)


class LoRADelta(nn.Module):
    """The stacked multi-adapter LoRA delta of one dense site
    (``lora_rank > 0``; the port of the JAX package's ``_LoRADelta``).

    It holds ``lora_a [A, K, r]`` (the dense initializer's normal) and
    ``lora_b [A, r, N]`` (zeros: a fresh bank is a zero delta), A =
    ``lora_num_adapters`` bank rows, in the JAX layout (not
    ``nn.Linear``'s: the grouped GEMM reads ``w [Gw, K, N]``). Row 0 is
    the reserved zero adapter: its rows are zeroed before the GEMMs and
    masked after them, so adapter id 0 reproduces the base model
    exactly whatever the bank holds. The base site (``nn.Linear`` or
    :class:`QuantLinear`) is unchanged beside it.
    """

    def __init__(self, cfg: GPTConfig, in_features: int, out_features: int):
        super().__init__()
        self.cfg = cfg
        self.out_features = out_features
        self.lora_a = nn.Parameter(torch.empty(
            cfg.lora_num_adapters, in_features, cfg.lora_rank))
        self.lora_b = nn.Parameter(torch.zeros(
            cfg.lora_num_adapters, cfg.lora_rank, out_features))

    def forward(self, x: torch.Tensor,
                adapter_ids: Optional[torch.Tensor]) -> torch.Tensor:
        """``scale * (x @ A[id]) @ B[id]`` over the last dim of ``x [b,
        ..., K]`` in the compute dtype, one bank row ``adapter_ids[i]``
        for every position of batch row ``i``; zeros, computing nothing,
        when ``adapter_ids`` is None. Counts ``lora/grouped``."""
        out_shape = x.shape[:-1] + (self.out_features,)
        if adapter_ids is None:
            return x.new_zeros(out_shape)
        dtype = compute_dtype(self.cfg)
        x2 = x.to(dtype).reshape(-1, x.shape[-1])
        ids = torch.as_tensor(adapter_ids, device=x.device).long()
        ids = ids.repeat_interleave(x2.shape[0] // x.shape[0])
        live = (ids != 0)[:, None]
        x2 = torch.where(live, x2, torch.zeros_like(x2))
        d = grouped_lora_delta(x2, ids, self.lora_a.to(dtype),
                               self.lora_b.to(dtype))
        metrics.inc("lora/grouped")
        # the scale rounded to the compute dtype on the host, as JAX
        # rounds it (a device tensor would cost a copy and a sync a site)
        d = d * float(torch.tensor(self.cfg.lora_scale, dtype=dtype))
        d = torch.where(live, d, torch.zeros_like(d))
        return d.reshape(out_shape).to(x.dtype)


def _dense(cfg: GPTConfig, in_features: int, out_features: int
           ) -> nn.Module:
    """A dense site: ``nn.Linear``, or :class:`QuantLinear` under
    ``quant_execution: weight_only_int8``."""
    if cfg.quant_execution == "weight_only_int8":
        return QuantLinear(in_features, out_features)
    return nn.Linear(in_features, out_features)


def quantize_kv(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(row, token, head) abs-max int8 quantization of a
    ``[b, s, h, d]`` K or V (the port of the JAX package's
    ``_quantize_kv``): ``(int8 [b, s, h, d], fp32 scales [b, s, h])``,
    the scale clamped at ``1e-8`` so an all-zero row round-trips."""
    f = t.float()
    scale = torch.clamp_min(f.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-8)
    q = torch.clamp(torch.round(f / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


class MultiHeadAttention(nn.Module):
    """Self-attention with a fused QKV projection and a per-layer slice
    of the KV cache."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.qkv_proj = _dense(cfg, cfg.hidden_size, 3 * cfg.hidden_size)
        self.out_proj = _dense(cfg, cfg.hidden_size, cfg.hidden_size)
        if cfg.lora_rank:
            self.qkv_proj_lora = LoRADelta(cfg, cfg.hidden_size,
                                           3 * cfg.hidden_size)
            self.out_proj_lora = LoRADelta(cfg, cfg.hidden_size,
                                           cfg.hidden_size)

    def forward(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor],
                kv: Optional[Tuple[torch.Tensor, ...]],
                cache_rows: Optional[torch.Tensor],
                decode_offset: Union[int, torch.Tensor, None],
                dropout_seed: Optional[int] = None,
                paged: Optional[PagedWrite] = None,
                adapter_ids: Optional[torch.Tensor] = None,
                causal: bool = True) -> torch.Tensor:
        """Attention of ``x [b, s, hidden]``.

        Without ``kv``: causal attention over x itself, with the
        attention-probability dropout of ``dropout_seed`` (training;
        None: none). With ``kv`` and neither ``decode_offset`` nor
        ``chunk_start``: a prefill that attends over x and writes its
        keys/values at positions ``0..s-1`` of cache rows
        ``cache_rows`` (rows ``0..b-1`` when None); causal, or with
        ``causal`` False masked by ``attn_bias`` alone. With
        ``decode_offset`` (an int for every row, or a ``[b]`` int32
        tensor per row): write the ``s`` tokens at positions
        ``offset .. offset + s - 1`` (clipped to the capacity) and
        attend over the cache, query ``j`` up to ``offset + j``. With
        ``paged`` (:func:`page_write`, resolved once per forward) ``kv``
        is the page pool: the tokens land where ``paged`` points and
        attention reads through its page table. ``adapter_ids [b]``
        (bank rows) add the LoRA deltas of ``qkv_proj`` and ``out_proj``.
        """
        cfg = self.cfg
        b, s, _ = x.shape
        nh, hd = cfg.num_attention_heads, cfg.head_dim
        with _site("attn"):
            qkv = self.qkv_proj(x)
            if cfg.lora_rank:
                qkv = qkv + self.qkv_proj_lora(x, adapter_ids)
            qkv = qkv.view(b, s, 3, nh, hd)
            q, k, v = (t.contiguous() for t in qkv.unbind(2))  # [b,s,nh,hd]
        use_flash = cfg.use_flash_attention
        # what lands in the cache: k and v, or under the int8 cache their
        # int8 values and [b, s, nh] scales, written to the same positions
        fresh, scales = (k, v), {}
        if kv is not None and cfg.kv_cache_dtype == "int8":
            (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
            fresh = (kq, vq, ks, vs)
            scales = {"k_scale": kv[2], "v_scale": kv[3]}
        if paged is not None:
            for dst, t in zip(kv, fresh):
                if paged.column is None:
                    # [b, s, h(, d)] -> [b, cp, h, page(, d)] page-major
                    # blocks
                    cp = paged.pids.shape[1]
                    dst[paged.pids] = t.unflatten(1, (cp, -1)).transpose(
                        2, 3)
                else:
                    # advanced indices on dims 0 and 2 put [b, s] first
                    dst[paged.pids, :, paged.column] = t
            out = dot_product_attention(q, kv[0], kv[1], attn_bias,
                                        causal=True,
                                        query_offset=paged.offset,
                                        use_flash=use_flash,
                                        kv_cache_layout=True,
                                        page_table=paged.page_table,
                                        **scales)
        elif kv is None or decode_offset is None:
            rate = cfg.attention_probs_dropout_prob \
                if dropout_seed is not None else 0.0
            if scales:
                # the JAX package's prefill reads its int8 cache back
                k = fa.dequantize_cache(kq, ks).to(k.dtype)
                v = fa.dequantize_cache(vq, vs).to(v.dtype)
            with _site("attn" if use_flash else "core_attn"):
                out = dot_product_attention(
                    q, k, v, attn_bias, causal=causal or kv is None,
                    use_flash=use_flash,
                    dropout_rate=rate,
                    dropout_seed=dropout_seed if rate > 0.0 else None)
            if kv is not None:
                for cache, t in zip(kv, fresh):
                    t = t.transpose(1, 2)               # [b, nh, s(, hd)]
                    if cache_rows is None:
                        cache[:b, :, :s] = t
                    else:
                        cache[cache_rows, :, :s] = t
        else:
            cap = kv[0].shape[2]
            if torch.is_tensor(decode_offset):
                pos = decode_offset.clamp(0, cap - 1)
                rows = torch.arange(b, device=x.device)
                if s == 1:
                    for cache, t in zip(kv, fresh):
                        cache[rows, :, pos.long()] = t[:, 0]
                else:
                    # the verify window: row i's tokens at pos[i] + j;
                    # columns past the accepted point are overwritten
                    # by the next window before any read
                    wpos = (pos.long()[:, None] + torch.arange(
                        s, device=x.device)[None, :]).clamp(0, cap - 1)
                    for cache, t in zip(kv, fresh):
                        cache[rows[:, None], :, wpos] = t
                offset = pos.to(torch.int32)
            else:
                if s != 1:
                    raise NotImplementedError(
                        "a multi-token window against the cache takes "
                        "per-row offsets")
                offset = min(max(int(decode_offset), 0), cap - 1)
                for cache, t in zip(kv, fresh):
                    cache[:, :, offset] = t[:, 0]
            out = dot_product_attention(q, kv[0], kv[1], attn_bias,
                                        causal=True, query_offset=offset,
                                        use_flash=use_flash,
                                        kv_cache_layout=True, **scales)
        attn_inner = out.reshape(b, s, nh * hd)
        with _site("attn_out"):
            out = self.out_proj(attn_inner)
            if cfg.lora_rank:
                out = out + self.out_proj_lora(attn_inner, adapter_ids)
            return out


class PagedWrite(NamedTuple):
    """Where a paged forward's ``s`` fresh tokens per row land in the
    page pool, resolved once for every layer by :func:`page_write`.

    ``pids`` are physical page ids: ``[b, s]`` with ``column [b, s]``
    the column inside each page (decode / verify), or ``[b, s / page]``
    whole pages with ``column`` None (a page-aligned prefill chunk).
    ``offset [b]`` int32 is the per-row query offset attention masks
    against; ``page_table [b, max_pages]`` is what it reads through."""

    page_table: torch.Tensor
    pids: torch.Tensor
    column: Optional[torch.Tensor]
    offset: torch.Tensor


def page_write(page_table: torch.Tensor, s: int, page: int, capacity: int,
               decode_offset, chunk_start) -> PagedWrite:
    """Resolve ``s`` tokens per row through ``page_table``.

    Decode / verify (``decode_offset [b]``): token ``j`` of row ``i``
    lands at position ``clip(offset_i + j, 0, capacity - 1)``, column
    ``pos % page`` of physical page ``page_table[i, pos // page]`` (an
    inactive slot's table row is all null pages, so its dead write
    lands in the garbage page 0). Chunked prefill (``chunk_start
    [b]``): the chunk spans whole pages, so it drops into its pages
    with one scatter, as in the JAX package."""
    dev = page_table.device
    pt = page_table.long()
    if chunk_start is not None:
        if s % page:
            raise ValueError(f"chunked prefill length {s} must be a "
                             f"multiple of kv_page_size {page}")
        c0 = torch.as_tensor(chunk_start, device=dev).long()
        pids = torch.gather(pt, 1, (c0 // page)[:, None] + torch.arange(
            s // page, device=dev)[None, :])
        return PagedWrite(page_table, pids, None, c0.to(torch.int32))
    if not torch.is_tensor(decode_offset):
        raise ValueError("a paged cache takes per-row decode offsets "
                         "or a chunk start")
    base = decode_offset.clamp(0, capacity - 1).long()
    wpos = (base[:, None] + torch.arange(s, device=dev)[None, :]).clamp(
        0, capacity - 1)
    return PagedWrite(page_table, torch.gather(pt, 1, wpos // page),
                      wpos % page, base.to(torch.int32))


class TransformerDecoderLayer(nn.Module):
    """Pre-LN decoder block: ``x + dropout1(attn(ln1(x)))``, then
    ``x + dropout2(mlp(ln2(x)))`` with a tanh-approximated GELU, or with
    ``moe_num_experts > 0`` the routed experts ``moe_mlp`` as the mlp."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.norm1 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.self_attn = MultiHeadAttention(cfg)
        self.norm2 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        if cfg.moe_num_experts:
            from .moe import MoEMLP
            self.moe_mlp = MoEMLP(cfg)
        else:
            self.linear1 = _dense(cfg, cfg.hidden_size, cfg.ffn_hidden_size)
            self.linear2 = _dense(cfg, cfg.ffn_hidden_size, cfg.hidden_size)
            if cfg.lora_rank:
                self.linear1_lora = LoRADelta(cfg, cfg.hidden_size,
                                              cfg.ffn_hidden_size)
                self.linear2_lora = LoRADelta(cfg, cfg.ffn_hidden_size,
                                              cfg.hidden_size)

    def forward(self, x, attn_bias=None, kv=None, cache_rows=None,
                decode_offset=None, dropout_seed=None, paged=None,
                adapter_ids=None, causal=True, need_aux=True):
        """One block; the cache arguments, ``adapter_ids`` and
        ``causal`` are :meth:`MultiHeadAttention.forward`'s,
        ``dropout_seed`` the block's (None: no dropout). Returns the
        block's output, and with ``moe_num_experts > 0`` the pair
        ``(output, router aux loss)``, the loss not computed (0) unless
        ``need_aux``."""
        drop = dropout_seed is not None
        rate = self.cfg.hidden_dropout_prob

        def seed(site):
            return fold_seed(dropout_seed, site) if drop else None

        y = self.self_attn(self.norm1(x), attn_bias, kv, cache_rows,
                           decode_offset, seed(0), paged, adapter_ids,
                           causal)
        x = x + hidden_dropout(y, rate, seed(1))
        if self.cfg.moe_num_experts:
            y, aux = self.moe_mlp(self.norm2(x),
                                  seed(self.moe_mlp.DROPOUT_SITE), need_aux)
            return x + hidden_dropout(y, rate, seed(2)), aux
        lora = self.cfg.lora_rank
        with _site("mlp1"):
            mlp_in = self.norm2(x)
            y = self.linear1(mlp_in)
            if lora:
                y = y + self.linear1_lora(mlp_in, adapter_ids)
        y = F.gelu(y, approximate="tanh")
        with _site("mlp2"):
            mlp_mid = y
            y = self.linear2(mlp_mid)
            if lora:
                y = y + self.linear2_lora(mlp_mid, adapter_ids)
        return x + hidden_dropout(y, rate, seed(2))


class GPTEmbeddings(nn.Module):
    """Word + learned position embeddings."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)

    def forward(self, input_ids, position_ids) -> torch.Tensor:
        """``word[input_ids] + position[position_ids]``."""
        return self.word_embeddings(input_ids) + \
            self.position_embeddings(position_ids)


class GPTModel(nn.Module):
    """Embeddings -> decoder blocks -> final LayerNorm."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = GPTEmbeddings(cfg)
        self.decoder = nn.ModuleList(TransformerDecoderLayer(cfg)
                                     for _ in range(cfg.num_layers))
        self.final_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)

        ctx_fn = ckpt.noop_context_fn
        if cfg.recompute_granularity != "full":
            ctx_fn = functools.partial(
                ckpt.create_selective_checkpoint_contexts,
                recompute_policy(cfg.recompute_granularity))
        self._context_fn = ctx_fn

    def forward(self, input_ids: torch.Tensor,
                position_ids: Optional[torch.Tensor] = None,
                attn_bias: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None,
                cache_rows: Optional[torch.Tensor] = None,
                decode_offset: Union[int, torch.Tensor, None] = None,
                dropout_seed: Optional[int] = None,
                page_table: Optional[torch.Tensor] = None,
                chunk_start: Optional[torch.Tensor] = None,
                return_aux: bool = False,
                adapter_ids: Optional[torch.Tensor] = None,
                causal: bool = True):
        """Hidden states ``[b, s, hidden]`` after the final norm (cache
        arguments as in :meth:`MultiHeadAttention.forward`; ``cache``
        is one ``(k, v)`` pair per layer, the page pools with a
        ``page_table [b, max_pages]``, through which the tokens land at
        ``decode_offset [b]`` or, a page-aligned prefill chunk, at
        ``chunk_start [b]``: :func:`page_write` resolves them once for
        every layer). ``dropout_seed`` turns the
        configured dropout on (training); with ``use_recompute`` and
        gradients enabled each block runs under activation
        checkpointing. With ``return_aux`` the pair ``(hidden states, the
        MoE router aux loss summed over the blocks)``, the loss None for
        a dense model; without it the blocks compute no router loss.
        ``adapter_ids [b]`` (int bank rows, 0 the base model) select each
        row's LoRA adapter; None computes no delta. ``causal`` False
        (a prefill with a cache only) leaves the whole mask to a ``[b,
        1, s, s]`` ``attn_bias``."""
        cfg = self.cfg
        s = input_ids.shape[-1]
        if position_ids is None:
            if s > cfg.max_position_embeddings:
                raise ValueError(
                    f"sequence length {s} exceeds max_position_embeddings "
                    f"{cfg.max_position_embeddings}")
            position_ids = torch.arange(s, device=input_ids.device)[None]
            position_ids = position_ids.expand_as(input_ids)
        drop = dropout_seed is not None
        x = self.embeddings(input_ids, position_ids)
        x = hidden_dropout(x, cfg.hidden_dropout_prob,
                           fold_seed(dropout_seed, 0) if drop else None)
        recompute = cfg.use_recompute and cache is None and \
            torch.is_grad_enabled()
        paged = None if page_table is None else page_write(
            page_table, s, cache[0][0].shape[2],
            cfg.cache_capacity, decode_offset, chunk_start)
        aux = x.new_zeros((), dtype=torch.float32) \
            if cfg.moe_num_experts and return_aux else None
        for i, layer in enumerate(self.decoder):
            seed = fold_seed(dropout_seed, i + 1) if drop else None
            if recompute:
                x = ckpt.checkpoint(layer, x, attn_bias, None, None, None,
                                    seed, None, adapter_ids,
                                    need_aux=return_aux,
                                    use_reentrant=False,
                                    preserve_rng_state=False,
                                    context_fn=self._context_fn)
            else:
                x = layer(x, attn_bias,
                          cache[i] if cache is not None else None,
                          cache_rows, decode_offset, seed, paged,
                          adapter_ids, causal, return_aux)
            if cfg.moe_num_experts:
                x, layer_aux = x
                if aux is not None:
                    aux = aux + layer_aux
        x = self.final_norm(x)
        return (x, aux) if return_aux else x


def tied_logits(x: torch.Tensor, word_emb: torch.Tensor) -> torch.Tensor:
    """LM head against the word-embedding table: ``x @ word_emb.T``."""
    return x @ word_emb.to(x.dtype).t()


class GPTForPretraining(nn.Module):
    """GPT with the tied-embedding LM head."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.config = cfg
        self.gpt = GPTModel(cfg)

    @property
    def word_embeddings(self) -> torch.Tensor:
        """The tied ``[vocab, hidden]`` embedding table."""
        return self.gpt.embeddings.word_embeddings.weight

    def forward(self, input_ids, position_ids=None, attn_bias=None,
                cache=None, cache_rows=None, decode_offset=None,
                dropout_seed=None, page_table=None,
                chunk_start=None, return_aux: bool = False,
                adapter_ids=None):
        """Logits ``[b, s, vocab]``, with ``return_aux`` the pair
        ``(logits, MoE aux loss)`` (arguments as in
        :meth:`GPTModel.forward`)."""
        x = self.gpt(input_ids, position_ids, attn_bias, cache,
                     cache_rows, decode_offset, dropout_seed, page_table,
                     chunk_start, return_aux=return_aux,
                     adapter_ids=adapter_ids)
        if return_aux:
            x, aux = x
            return tied_logits(x, self.word_embeddings), aux
        return tied_logits(x, self.word_embeddings)


def masked_nll_sums(logits: torch.Tensor, labels: torch.Tensor,
                    loss_mask: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked token NLL in fp32: ``(sum of nll over unmasked tokens,
    mask sum)`` (the JAX package's ``masked_nll_sums``)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    label_logits = torch.gather(logits, -1,
                                labels.long()[..., None])[..., 0]
    mask = loss_mask.float().reshape(logz.shape)
    return ((logz - label_logits) * mask).sum(), mask.sum()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       loss_mask: torch.Tensor,
                       moe_aux: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Masked LM criterion: mean NLL over unmasked positions, fp32, plus
    ``moe_aux`` (the MoE router loss of a training forward) when
    given."""
    nll, msum = masked_nll_sums(logits, labels, loss_mask)
    loss = nll / msum.clamp_min(1.0)
    return loss if moe_aux is None else loss + moe_aux


def _chunk_nll(h, word_emb, labels, loss_mask):
    return masked_nll_sums(tied_logits(h, word_emb), labels, loss_mask)


def chunked_nll_sums(h: torch.Tensor, word_emb: torch.Tensor,
                     labels: torch.Tensor, loss_mask: torch.Tensor,
                     chunks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The :func:`masked_nll_sums` of the tied LM head on the final
    hidden states ``h`` ``[b, s, hidden]``, the head and its softmax
    computed over ``chunks`` sequence chunks of ``ceil(s / chunks)``
    positions:
    the ``[b, s, V]`` logits never exist beyond one chunk. Under autograd
    each chunk runs under activation checkpointing, so the backward
    recomputes its logits. The sums are exact."""
    s = h.shape[1]
    step = -(-s // max(chunks, 1))
    nll = msum = torch.zeros((), dtype=torch.float32, device=h.device)
    for start in range(0, s, step):
        sl = slice(start, start + step)
        args = (h[:, sl], word_emb, labels[:, sl], loss_mask[:, sl])
        if torch.is_grad_enabled():
            n, m = ckpt.checkpoint(_chunk_nll, *args, use_reentrant=False,
                                   preserve_rng_state=False)
        else:
            n, m = _chunk_nll(*args)
        nll, msum = nll + n, msum + m
    return nll, msum


def chunked_lm_loss(model: GPTForPretraining, input_ids: torch.Tensor,
                    labels: torch.Tensor, loss_mask: torch.Tensor,
                    chunks: int, position_ids=None,
                    dropout_seed: Optional[int] = None,
                    return_aux: bool = True) -> torch.Tensor:
    """The masked-CE loss with the LM head over ``chunks`` sequence
    chunks (:func:`chunked_nll_sums`). Without dropout this equals
    :func:`cross_entropy_loss` of the full logits. With ``return_aux``
    (training) an MoE model computes its router loss and adds it, as in
    the JAX package; without it the router loss is not computed."""
    b, s = input_ids.shape
    if s % chunks:
        raise ValueError(f"loss_chunks ({chunks}) must divide the sequence "
                         f"length ({s})")
    h = model.gpt(input_ids, position_ids, dropout_seed=dropout_seed,
                  return_aux=return_aux)
    h, aux = h if return_aux else (h, None)
    nll, msum = chunked_nll_sums(h, model.word_embeddings, labels,
                                 loss_mask, chunks)
    loss = nll / msum.clamp_min(1.0)
    return loss + aux if aux is not None else loss


@torch.no_grad()
def init_weights(model: GPTForPretraining, seed: int) -> None:
    """Random weights from ``seed``, drawn on the model's device with a
    ``torch.Generator``: embeddings, dense kernels, the MoE leaves
    ``router_kernel`` / ``wi`` / ``wo`` and the LoRA ``lora_a`` banks ~
    N(0, ``initializer_range``), biases (``wi_bias`` and ``wo_bias``
    too) and the ``lora_b`` banks 0, LayerNorm scale 1 and bias 0 (the
    JAX package's initializers; the numbers differ)."""
    std = model.config.initializer_range
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    for name, p in model.named_parameters():
        if "norm" in name:
            p.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name.endswith(("bias", "lora_b")):
            p.zero_()
        else:
            p.copy_(torch.randn(p.shape, generator=gen, device=dev,
                                dtype=torch.float32) * std)


def build_model(cfg: GPTConfig, device: torch.device,
                state_dict=None, seed: int = 0,
                train: bool = False) -> GPTForPretraining:
    """A GPT on ``device`` with weights from ``state_dict`` (e.g.
    ``convert.torch_state_dict_from_flax``) or drawn from ``seed``.
    Serving (``train=False``): the weights in ``cfg.dtype``, eval mode.
    Training: fp32 master weights, train mode; the forward computes in
    ``cfg.dtype`` under :func:`compute_context`.

    Under ``quant_execution: weight_only_int8`` (serving only) the dense
    sites load int8 weights and fp32 scales: those of ``state_dict``
    (``core/quantize.py::quantize_state_dict`` or the converter), and
    any fp dense weight it holds, or the fp32 weights drawn from
    ``seed`` when it is None, quantized here first (the JAX workflow
    "train, quantize the checkpoint, serve"), before the cast to the
    compute dtype. Such a model still back-propagates into its floating
    leaves (LoRA banks, biases, norms, embeddings) through kernel 7's dx
    route, what ``jax.grad`` over the floating subtree gives in the JAX
    package."""
    quant = cfg.quant_execution == "weight_only_int8"
    if quant and train:
        raise NotImplementedError(
            "training under quant_execution is refused as the JAX engine "
            "refuses it: its step differentiates the whole params tree, "
            "and JAX cannot differentiate int8 leaves")
    with torch.device(device):
        model = GPTForPretraining(cfg)
    if quant:
        if state_dict is None:
            fp_cfg = dataclasses.replace(cfg, quant_execution="off")
            with torch.device(device):
                fp = GPTForPretraining(fp_cfg)
            init_weights(fp, seed)
            state_dict = fp.state_dict()
            del fp
        state_dict, _ = quantize_state_dict(state_dict)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    else:
        init_weights(model, seed)
    if train:
        return model.float().train()
    return model.to(compute_dtype(cfg)).eval()


def _zeroed_kv(cfg: GPTConfig, shape, device: torch.device) -> KVCache:
    """Per layer ``(k, v)`` of ``shape`` in the compute dtype, or under
    the int8 cache ``(k, v, k_scale, v_scale)``: int8 values and fp32
    scales of ``shape`` minus its d axis."""
    def zeros(shp, dtype):
        return torch.zeros(shp, dtype=dtype, device=device)
    if cfg.kv_cache_dtype == "int8":
        return [(zeros(shape, torch.int8), zeros(shape, torch.int8),
                 zeros(shape[:-1], torch.float32),
                 zeros(shape[:-1], torch.float32))
                for _ in range(cfg.num_layers)]
    dtype = compute_dtype(cfg)
    return [(zeros(shape, dtype), zeros(shape, dtype))
            for _ in range(cfg.num_layers)]


def init_kv_pool(cfg: GPTConfig, device: torch.device) -> KVCache:
    """A zeroed paged pool: per layer a ``(k, v)`` pair of
    ``[kv_pool_pages, heads, kv_page_size, head_dim]`` in the compute
    dtype, or int8 with ``[kv_pool_pages, heads, kv_page_size]`` fp32
    scale pools under the int8 cache (``cfg`` must carry
    ``kv_page_size`` / ``kv_pool_pages``)."""
    if not cfg.kv_page_size or not cfg.kv_pool_pages:
        raise ValueError("init_kv_pool needs kv_page_size and "
                         "kv_pool_pages")
    return _zeroed_kv(cfg, (cfg.kv_pool_pages, cfg.num_attention_heads,
                            cfg.kv_page_size, cfg.head_dim), device)


def init_kv_cache(cfg: GPTConfig, batch: int, device: torch.device
                  ) -> KVCache:
    """A zeroed cache: per layer a ``(k, v)`` pair of
    ``[batch, heads, cache_capacity, head_dim]`` in the compute dtype,
    or int8 with ``[batch, heads, cache_capacity]`` fp32 scales under
    the int8 cache."""
    return _zeroed_kv(cfg, (batch, cfg.num_attention_heads,
                            cfg.cache_capacity, cfg.head_dim), device)
