"""Post-training quantization to the weight-only int8 format (the port's
copy of the JAX package's ``core/quantize.py``).

It rewrites a GPT ``state_dict`` into the storage format of
``quant_execution: weight_only_int8`` (``models/gpt/model.py::
QuantLinear``): each dense-site ``weight`` becomes int8 values plus a
sibling fp32 ``weight_scale``, one scale per output row, so a base
checkpoint quantizes into exactly the state dict a quantized model
loads. The grid is the JAX package's: symmetric abs-max with ``qmax =
127``, the scale clamped away from zero at ``1e-8``.

Layout: the port's sites are ``nn.Linear`` weights ``[N, K]`` (output
rows, contraction columns), so the scale reduces over dim 1. That is
the JAX ``[K, N]`` kernel's reduction over its contraction axes on the
same elements, so both packages give the same int8 values and scales
bit for bit (``models/gpt/convert.py`` carries them across). Sites are
keyed by the module name the ``state_dict`` key carries; every other
entry (embeddings, norms, biases, already-int8 weights) passes through.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import torch

#: the dense sites, by module name: the fused qkv, the attention output
#: and the two MLP projections (the JAX package's ``q_proj`` /
#: ``k_proj`` / ``v_proj`` sites wait for ``fuse_attn_qkv=False``)
QUANT_SITES = ("qkv_proj", "out_proj", "linear1", "linear2")

#: symmetric int8 grid
QMAX = 127.0
_EPS = 1e-8


def quantize_kernel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ``[N, K]`` weight -> ``(int8 [N, K], fp32 [N] scales)``: the
    abs-max of each output row over K, over ``QMAX``, clamped at
    ``1e-8``; values rounded half to even and clipped to ``[-127,
    127]``."""
    if w.dim() != 2:
        raise ValueError(f"quantize_kernel wants an [N, K] weight, got "
                         f"{tuple(w.shape)}")
    f = w.float()
    scale = torch.clamp_min(f.abs().amax(dim=1) / QMAX, _EPS)
    q = torch.clamp(torch.round(f / scale[:, None]), -QMAX, QMAX)
    return q.to(torch.int8), scale


def dequantize_kernel(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The fp32 ``[N, K]`` weight an int8 one stands for."""
    return q.float() * scale.float()[:, None]


def _site(key: str) -> str:
    parts = key.split(".")
    return parts[-2] if len(parts) >= 2 else ""


def quantize_state_dict(sd: Mapping[str, torch.Tensor]
                        ) -> Tuple[Dict[str, torch.Tensor],
                                   List[Dict[str, Any]]]:
    """Rewrite a GPT ``state_dict`` into the weight-only int8 format.

    Returns ``(quantized, report)``: every ``<site>.weight`` with
    ``<site>`` in :data:`QUANT_SITES` is replaced by its int8 values plus
    a new ``<site>.weight_scale``; every other entry passes through by
    reference. The report has one row per quantized site, as the JAX
    package's ``quantize_param_tree`` writes them (``path``, ``shape``,
    ``stacked``, ``bytes_fp``, ``bytes_int8``)."""
    out: Dict[str, torch.Tensor] = {}
    report: List[Dict[str, Any]] = []
    for key, t in sd.items():
        if not key.endswith(".weight") or _site(key) not in QUANT_SITES \
                or t.dtype == torch.int8:
            out[key] = t
            continue
        q, scale = quantize_kernel(t)
        out[key] = q
        out[key + "_scale"] = scale
        report.append({"path": key, "shape": list(t.shape),
                       "stacked": False,
                       "bytes_fp": t.numel() * t.element_size(),
                       "bytes_int8": t.numel() + 4 * scale.numel()})
    return out, report


def dequantize_state_dict(qsd: Mapping[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`quantize_state_dict`: fold every
    ``weight_scale`` back into an fp32 ``weight``."""
    out: Dict[str, torch.Tensor] = {}
    for key, t in qsd.items():
        if key.endswith(".weight_scale"):
            continue
        skey = key + "_scale"
        if key.endswith(".weight") and _site(key) in QUANT_SITES and \
                skey in qsd:
            out[key] = dequantize_kernel(t, qsd[skey])
        else:
            out[key] = t
    return out
