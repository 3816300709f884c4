"""Weight bridge between the JAX package's GPT parameters and the port's.

:func:`torch_state_dict_from_flax` takes the JAX ``GPTForPretraining``
``params`` tree (a nested mapping of numpy-convertible arrays, already
unboxed) and returns the port's ``state_dict``;
:func:`flax_from_torch_state_dict` is its inverse. Both move values by
reshape and transpose only, so a JAX -> torch -> JAX round trip is
bit-exact.

Layouts (flax -> torch, ``nn.Linear`` stores ``[out, in]``):

- ``qkv_proj`` kernel ``[h, 3, nh, hd]`` -> weight ``[3*nh*hd, h]``,
  bias ``[3, nh, hd]`` -> ``[3*nh*hd]`` (features ``(3, nh, hd)``,
  ``model.py:354-374`` of the JAX package);
- ``out_proj`` kernel ``[nh, hd, h]`` -> weight ``[h, nh*hd]``;
- ``linear1`` / ``linear2`` kernels ``[in, out]`` -> ``[out, in]``;
- LayerNorm ``scale`` / ``bias`` -> ``weight`` / ``bias``;
- the tied ``word_embeddings`` and the ``position_embeddings`` tables
  as they are.

The decoder stack comes either unrolled (``decoder_{i}`` subtrees) or
scanned (one ``decoder`` subtree whose leaves lead with the layer
axis); both read, and the inverse writes the layout
``cfg.scan_layers`` names.

A training checkpoint of the port (``core/checkpoint.py``) stores the
fp32 master weights as this ``state_dict``, under the same names, so
:func:`flax_from_torch_state_dict` reads it into the JAX layout too; the
same function maps the port's gradients (``{name: p.grad}``) onto the
JAX ``params`` tree, for a leaf-by-leaf comparison with ``jax.grad``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .config import GPTConfig


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _layer_from_flax(p: Mapping, cfg: GPTConfig) -> Dict[str, np.ndarray]:
    h = cfg.hidden_size
    attn = p["self_attn"]
    return {
        "norm1.weight": _np(p["norm1"]["scale"]),
        "norm1.bias": _np(p["norm1"]["bias"]),
        "self_attn.qkv_proj.weight":
            _np(attn["qkv_proj"]["kernel"]).reshape(h, -1).T,
        "self_attn.qkv_proj.bias": _np(attn["qkv_proj"]["bias"]).reshape(-1),
        "self_attn.out_proj.weight":
            _np(attn["out_proj"]["kernel"]).reshape(-1, h).T,
        "self_attn.out_proj.bias": _np(attn["out_proj"]["bias"]),
        "norm2.weight": _np(p["norm2"]["scale"]),
        "norm2.bias": _np(p["norm2"]["bias"]),
        "linear1.weight": _np(p["linear1"]["kernel"]).T,
        "linear1.bias": _np(p["linear1"]["bias"]),
        "linear2.weight": _np(p["linear2"]["kernel"]).T,
        "linear2.bias": _np(p["linear2"]["bias"]),
    }


def _layer_to_flax(sd: Mapping[str, np.ndarray], cfg: GPTConfig) -> dict:
    h, nh, hd = cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim
    return {
        "norm1": {"scale": sd["norm1.weight"], "bias": sd["norm1.bias"]},
        "self_attn": {
            "qkv_proj": {
                "kernel": sd["self_attn.qkv_proj.weight"].T.reshape(
                    h, 3, nh, hd),
                "bias": sd["self_attn.qkv_proj.bias"].reshape(3, nh, hd)},
            "out_proj": {
                "kernel": sd["self_attn.out_proj.weight"].T.reshape(
                    nh, hd, h),
                "bias": sd["self_attn.out_proj.bias"]}},
        "norm2": {"scale": sd["norm2.weight"], "bias": sd["norm2.bias"]},
        "linear1": {"kernel": sd["linear1.weight"].T,
                    "bias": sd["linear1.bias"]},
        "linear2": {"kernel": sd["linear2.weight"].T,
                    "bias": sd["linear2.bias"]},
    }


def torch_state_dict_from_flax(params: Mapping, cfg: GPTConfig
                               ) -> Dict[str, torch.Tensor]:
    """The port's ``GPTForPretraining`` state_dict from the JAX
    package's ``params`` tree (scanned or unrolled decoder).

    Args:
        params (Mapping): ``variables["params"]`` of the JAX model,
            unboxed, with array leaves.
        cfg (GPTConfig): the model's configuration.

    Returns:
        dict of contiguous CPU tensors (copies) in the leaves' dtype.
    """
    gpt = params["gpt"]
    emb = gpt["embeddings"]
    flat = {
        "gpt.embeddings.word_embeddings.weight":
            _np(emb["word_embeddings"]),
        "gpt.embeddings.position_embeddings.weight":
            _np(emb["position_embeddings"]),
        "gpt.final_norm.weight": _np(gpt["final_norm"]["scale"]),
        "gpt.final_norm.bias": _np(gpt["final_norm"]["bias"]),
    }
    for i in range(cfg.num_layers):
        if "decoder" in gpt:
            layer = _map_leaves(gpt["decoder"], lambda x, i=i: _np(x)[i])
        else:
            layer = gpt[f"decoder_{i}"]
        for key, val in _layer_from_flax(layer, cfg).items():
            flat[f"gpt.decoder.{i}.{key}"] = val
    return {k: torch.from_numpy(np.array(v, order="C"))
            for k, v in flat.items()}


def flax_from_torch_state_dict(sd: Mapping[str, torch.Tensor],
                               cfg: GPTConfig) -> dict:
    """Inverse of :func:`torch_state_dict_from_flax`: the JAX package's
    ``params`` tree of numpy arrays, with the decoder scanned
    (``decoder``, layer-stacked leaves) when ``cfg.scan_layers`` and
    unrolled (``decoder_{i}``) otherwise."""
    arr = {k: v.detach().cpu().numpy() for k, v in sd.items()}
    layers = []
    for i in range(cfg.num_layers):
        prefix = f"gpt.decoder.{i}."
        layers.append(_layer_to_flax(
            {k[len(prefix):]: v for k, v in arr.items()
             if k.startswith(prefix)}, cfg))
    gpt = {
        "embeddings": {
            "word_embeddings": arr["gpt.embeddings.word_embeddings.weight"],
            "position_embeddings":
                arr["gpt.embeddings.position_embeddings.weight"]},
        "final_norm": {"scale": arr["gpt.final_norm.weight"],
                       "bias": arr["gpt.final_norm.bias"]},
    }
    if cfg.scan_layers:
        gpt["decoder"] = _stack_leaves(layers)
    else:
        for i, layer in enumerate(layers):
            gpt[f"decoder_{i}"] = layer
    return {"gpt": gpt}


def _map_leaves(tree, fn):
    if isinstance(tree, Mapping):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    return fn(tree)


def _stack_leaves(trees):
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _stack_leaves([t[k] for t in trees]) for k in first}
    return np.stack(trees)

