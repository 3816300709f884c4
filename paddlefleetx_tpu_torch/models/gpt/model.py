"""GPT in PyTorch: the port of the JAX package's ``models/gpt/model.py``.

Architecture parity (and parameter parity through ``convert.py``):
learned word + position embeddings; pre-LayerNorm decoder blocks
(``LayerNorm(eps=1e-5)``) with a fused ``qkv_proj`` whose features are
``(3, nh, hd)`` and an ``out_proj`` over ``(nh, hd)``; a tanh-GELU MLP;
a final LayerNorm; logits tied to the word embedding. The decoder is a
plain ``nn.ModuleList`` (the JAX ``scan_layers`` choice is a compile
time trade that eager PyTorch does not have; ``convert.py`` reads both
JAX layouts). This slice serves: there is no dropout, the model is
inference-only.

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

from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import dot_product_attention
from .config import GPTConfig

KVCache = List[Tuple[torch.Tensor, torch.Tensor]]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: GPTConfig) -> torch.dtype:
    """The torch dtype of ``cfg.dtype``."""
    return _DTYPES[cfg.dtype]


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
                decode_offset: Union[int, torch.Tensor, None]
                ) -> torch.Tensor:
        """Attention of ``x [b, s, hidden]``.

        Without ``kv``: causal attention over x itself. With ``kv`` and
        no ``decode_offset``: a prefill that attends over x and writes
        its keys/values at positions ``0..s-1`` of cache rows
        ``cache_rows`` (rows ``0..b-1`` when None). With
        ``decode_offset`` (s == 1): write at that position (an int for
        every row, or a ``[b]`` int32 tensor per row) and attend over
        the cache up to it.
        """
        cfg = self.cfg
        b, s, _ = x.shape
        nh, hd = cfg.num_attention_heads, cfg.head_dim
        qkv = self.qkv_proj(x).view(b, s, 3, nh, hd)
        q, k, v = (t.contiguous() for t in qkv.unbind(2))   # [b, s, nh, hd]
        use_flash = cfg.use_flash_attention
        if kv is None or decode_offset is None:
            out = dot_product_attention(q, k, v, attn_bias, causal=True,
                                        use_flash=use_flash)
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
        return self.out_proj(out.reshape(b, s, nh * hd))


class TransformerDecoderLayer(nn.Module):
    """Pre-LN decoder block: ``x + attn(ln1(x))``, then
    ``x + mlp(ln2(x))`` with a tanh-approximated GELU."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.self_attn = MultiHeadAttention(cfg)
        self.norm2 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.linear1 = nn.Linear(cfg.hidden_size, cfg.ffn_hidden_size)
        self.linear2 = nn.Linear(cfg.ffn_hidden_size, cfg.hidden_size)

    def forward(self, x, attn_bias=None, kv=None, cache_rows=None,
                decode_offset=None) -> torch.Tensor:
        """One block; the cache arguments are
        :meth:`MultiHeadAttention.forward`'s."""
        x = x + self.self_attn(self.norm1(x), attn_bias, kv, cache_rows,
                               decode_offset)
        y = F.gelu(self.linear1(self.norm2(x)), approximate="tanh")
        return x + self.linear2(y)


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

    def forward(self, input_ids: torch.Tensor,
                position_ids: Optional[torch.Tensor] = None,
                attn_bias: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None,
                cache_rows: Optional[torch.Tensor] = None,
                decode_offset: Union[int, torch.Tensor, None] = None
                ) -> torch.Tensor:
        """Hidden states ``[b, s, hidden]`` after the final norm (cache
        arguments as in :meth:`MultiHeadAttention.forward`; ``cache``
        is one ``(k, v)`` pair per layer)."""
        s = input_ids.shape[-1]
        if position_ids is None:
            if s > self.cfg.max_position_embeddings:
                raise ValueError(
                    f"sequence length {s} exceeds max_position_embeddings "
                    f"{self.cfg.max_position_embeddings}")
            position_ids = torch.arange(s, device=input_ids.device)[None]
            position_ids = position_ids.expand_as(input_ids)
        x = self.embeddings(input_ids, position_ids)
        for i, layer in enumerate(self.decoder):
            x = layer(x, attn_bias, cache[i] if cache is not None else None,
                      cache_rows, decode_offset)
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
                cache=None, cache_rows=None, decode_offset=None
                ) -> torch.Tensor:
        """Logits ``[b, s, vocab]`` (arguments as in
        :meth:`GPTModel.forward`)."""
        x = self.gpt(input_ids, position_ids, attn_bias, cache, cache_rows,
                     decode_offset)
        return tied_logits(x, self.word_embeddings)


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
                state_dict=None, seed: int = 0) -> GPTForPretraining:
    """A GPT on ``device`` in ``cfg.dtype``, eval mode, weights from
    ``state_dict`` (e.g. ``convert.torch_state_dict_from_flax``) or
    drawn from ``seed``."""
    with torch.device(device):
        model = GPTForPretraining(cfg)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    else:
        init_weights(model, seed)
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
