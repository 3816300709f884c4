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
``S = cache_capacity`` (the port's layout, see ``ops/attention.py``).
The cache is updated IN PLACE (PyTorch is not functional): a prefill
writes positions ``0..s-1`` of its rows, a decode step writes one
position per row. Prefill attends over the prompt's fresh q/k/v through
the flash forward kernel (``attention/flash``): with query offset 0
every key past the prompt is causally masked, so this equals the JAX
package's dense attention over the whole capacity. Decode attends over
the cache through the decode kernel (``attention/flash_decode`` with
one shared offset, ``attention/flash_decode_ragged`` with per-row
offsets).
"""

from __future__ import annotations

import contextlib
import functools
from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from ...ops.attention import dot_product_attention
from .config import GPTConfig

KVCache = List[Tuple[torch.Tensor, torch.Tensor]]

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
    return frozenset((torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                      torch.ops.pfx.flash_attention.default))


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


class MultiHeadAttention(nn.Module):
    """Self-attention with a fused QKV projection and a per-layer slice
    of the KV cache."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.qkv_proj = nn.Linear(cfg.hidden_size, 3 * cfg.hidden_size)
        self.out_proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor],
                kv: Optional[Tuple[torch.Tensor, torch.Tensor]],
                cache_rows: Optional[torch.Tensor],
                decode_offset: Union[int, torch.Tensor, None],
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        """Attention of ``x [b, s, hidden]``.

        Without ``kv``: causal attention over x itself, with the
        attention-probability dropout of ``dropout_seed`` (training;
        None: none). With ``kv`` and no ``decode_offset``: a prefill
        that attends over x and writes its keys/values at positions
        ``0..s-1`` of cache rows ``cache_rows`` (rows ``0..b-1`` when
        None). With ``decode_offset`` (s == 1): write at that position
        (an int for every row, or a ``[b]`` int32 tensor per row) and
        attend over the cache up to it.
        """
        cfg = self.cfg
        b, s, _ = x.shape
        nh, hd = cfg.num_attention_heads, cfg.head_dim
        with _site("attn"):
            qkv = self.qkv_proj(x).view(b, s, 3, nh, hd)
            q, k, v = (t.contiguous() for t in qkv.unbind(2))  # [b,s,nh,hd]
        use_flash = cfg.use_flash_attention
        if kv is None or decode_offset is None:
            rate = cfg.attention_probs_dropout_prob \
                if dropout_seed is not None else 0.0
            with _site("attn" if use_flash else "core_attn"):
                out = dot_product_attention(
                    q, k, v, attn_bias, causal=True, use_flash=use_flash,
                    dropout_rate=rate,
                    dropout_seed=dropout_seed if rate > 0.0 else None)
            if kv is not None:
                for cache, t in zip(kv, (k, v)):
                    t = t.permute(0, 2, 1, 3)                 # [b, nh, s, hd]
                    if cache_rows is None:
                        cache[:b, :, :s] = t
                    else:
                        cache[cache_rows, :, :s] = t
        else:
            if s != 1:
                raise NotImplementedError(
                    "cached decode takes one token per row")
            cap = kv[0].shape[2]
            if torch.is_tensor(decode_offset):
                pos = decode_offset.clamp(0, cap - 1)
                rows = torch.arange(b, device=x.device)
                for cache, t in zip(kv, (k, v)):
                    cache[rows, :, pos.long()] = t[:, 0]
                offset = pos.to(torch.int32)
            else:
                offset = min(max(int(decode_offset), 0), cap - 1)
                for cache, t in zip(kv, (k, v)):
                    cache[:, :, offset] = t[:, 0]
            out = dot_product_attention(q, kv[0], kv[1], attn_bias,
                                        causal=True, query_offset=offset,
                                        use_flash=use_flash,
                                        kv_cache_layout=True)
        with _site("attn_out"):
            return self.out_proj(out.reshape(b, s, nh * hd))


class TransformerDecoderLayer(nn.Module):
    """Pre-LN decoder block: ``x + dropout1(attn(ln1(x)))``, then
    ``x + dropout2(mlp(ln2(x)))`` with a tanh-approximated GELU."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.norm1 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.self_attn = MultiHeadAttention(cfg)
        self.norm2 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.linear1 = nn.Linear(cfg.hidden_size, cfg.ffn_hidden_size)
        self.linear2 = nn.Linear(cfg.ffn_hidden_size, cfg.hidden_size)

    def forward(self, x, attn_bias=None, kv=None, cache_rows=None,
                decode_offset=None, dropout_seed=None) -> torch.Tensor:
        """One block; the cache arguments are
        :meth:`MultiHeadAttention.forward`'s, ``dropout_seed`` the
        block's (None: no dropout)."""
        drop = dropout_seed is not None
        rate = self.cfg.hidden_dropout_prob

        def seed(site):
            return fold_seed(dropout_seed, site) if drop else None

        y = self.self_attn(self.norm1(x), attn_bias, kv, cache_rows,
                           decode_offset, seed(0))
        x = x + hidden_dropout(y, rate, seed(1))
        with _site("mlp1"):
            y = self.linear1(self.norm2(x))
        y = F.gelu(y, approximate="tanh")
        with _site("mlp2"):
            y = self.linear2(y)
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
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        """Hidden states ``[b, s, hidden]`` after the final norm (cache
        arguments as in :meth:`MultiHeadAttention.forward`; ``cache``
        is one ``(k, v)`` pair per layer). ``dropout_seed`` turns the
        configured dropout on (training); with ``use_recompute`` and
        gradients enabled each block runs under activation
        checkpointing."""
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
        for i, layer in enumerate(self.decoder):
            seed = fold_seed(dropout_seed, i + 1) if drop else None
            if recompute:
                x = ckpt.checkpoint(layer, x, attn_bias, None, None, None,
                                    seed, use_reentrant=False,
                                    preserve_rng_state=False,
                                    context_fn=self._context_fn)
            else:
                x = layer(x, attn_bias,
                          cache[i] if cache is not None else None,
                          cache_rows, decode_offset, seed)
        return self.final_norm(x)


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
                dropout_seed=None) -> torch.Tensor:
        """Logits ``[b, s, vocab]`` (arguments as in
        :meth:`GPTModel.forward`)."""
        x = self.gpt(input_ids, position_ids, attn_bias, cache, cache_rows,
                     decode_offset, dropout_seed)
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
                       loss_mask: torch.Tensor) -> torch.Tensor:
    """Masked LM criterion: mean NLL over unmasked positions, fp32."""
    nll, msum = masked_nll_sums(logits, labels, loss_mask)
    return nll / msum.clamp_min(1.0)


def _chunk_nll(h, word_emb, labels, loss_mask):
    return masked_nll_sums(tied_logits(h, word_emb), labels, loss_mask)


def chunked_lm_loss(model: GPTForPretraining, input_ids: torch.Tensor,
                    labels: torch.Tensor, loss_mask: torch.Tensor,
                    chunks: int, position_ids=None,
                    dropout_seed: Optional[int] = None) -> torch.Tensor:
    """The masked-CE loss with the LM head and softmax computed over
    ``chunks`` sequence chunks, each under activation checkpointing: the
    ``[b, s, V]`` logits never exist beyond ``[b, s / chunks, V]`` and
    the backward recomputes each chunk's logits. The NLL sums are exact,
    so without dropout this equals :func:`cross_entropy_loss` of the
    full logits."""
    b, s = input_ids.shape
    if s % chunks:
        raise ValueError(f"loss_chunks ({chunks}) must divide the sequence "
                         f"length ({s})")
    h = model.gpt(input_ids, position_ids, dropout_seed=dropout_seed)
    csz = s // chunks
    nll = msum = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(chunks):
        sl = slice(c * csz, (c + 1) * csz)
        args = (h[:, sl], model.word_embeddings, labels[:, sl],
                loss_mask[:, sl])
        if torch.is_grad_enabled():
            n, m = ckpt.checkpoint(_chunk_nll, *args, use_reentrant=False,
                                   preserve_rng_state=False)
        else:
            n, m = _chunk_nll(*args)
        nll, msum = nll + n, msum + m
    return nll / msum.clamp_min(1.0)


@torch.no_grad()
def init_weights(model: GPTForPretraining, seed: int) -> None:
    """Random weights from ``seed``, drawn on the model's device with a
    ``torch.Generator``: embeddings and dense kernels ~ N(0,
    ``initializer_range``), biases 0, LayerNorm scale 1 and bias 0 (the
    JAX package's initializers; the numbers differ)."""
    std = model.config.initializer_range
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    for name, p in model.named_parameters():
        if "norm" in name:
            p.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("bias"):
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
    ``cfg.dtype`` under :func:`compute_context`."""
    with torch.device(device):
        model = GPTForPretraining(cfg)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    else:
        init_weights(model, seed)
    if train:
        return model.float().train()
    return model.to(compute_dtype(cfg)).eval()


def init_kv_cache(cfg: GPTConfig, batch: int, device: torch.device
                  ) -> KVCache:
    """A zeroed cache: per layer a ``(k, v)`` pair of
    ``[batch, heads, cache_capacity, head_dim]`` in the compute
    dtype."""
    shape = (batch, cfg.num_attention_heads, cfg.cache_capacity,
             cfg.head_dim)
    dtype = compute_dtype(cfg)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.num_layers)]
