"""The port's two attention kernels, their wrappers and plain versions.

- :func:`flash_attention` launches ``csrc/flash_fwd.cu``, the port of
  the TPU forward kernel ``_fwd_kernel``
  (``paddlefleetx_tpu/ops/pallas/flash_attention.py:209``): causal or
  full online-softmax attention over ``[b, s, h, d]`` inputs with an
  optional additive bias, returning O and the per-row logsumexp. The
  serving path runs it as prefill, over the prompt's fresh q/k/v.
- :func:`flash_decode` and :func:`flash_decode_ragged` launch
  ``csrc/flash_decode.cu``, the port of ``_decode_kernel``
  (``flash_attention.py:1055``): one query per row against the KV
  cache, keys ``0..offset`` (one shared offset plus a per-key bias, or
  one offset per row).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream and raises
if the launch returns a CUDA error. On tensors that lie on the CPU it
runs the plain PyTorch version from this module instead
(:func:`flash_attention_reference`, :func:`flash_decode_reference`);
on CUDA tensors it launches the kernel or raises — there is no fallback
from a launch to the plain version. Each kernel counts its launches in
a plain integer, ``flash_attention.launches`` and
``flash_decode.launches`` (kernel 2's two entry points share one
count), so a run can show that its main path went through the kernels.

Cache layout: the port's KV cache is ``[b, h, S, d]``. The TPU cache
``[b, h, d, S]`` was a TPU tiling choice (``ops/attention.py:11-15`` of
the JAX package); here a key's ``d`` values are contiguous, which is
what the decode kernel's 16-byte loads want.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build

#: masked-score fill of the TPU kernels (kept for parity)
NEG_INF = -1e30

_DTYPES = (torch.bfloat16, torch.float32)
_HEAD_DIMS = (64, 128)


def _on_cpu(*tensors) -> bool:
    return all(t is None or t.device.type == "cpu" for t in tensors)


def _check_cuda(name: str, *tensors) -> None:
    """Raise unless every tensor is a contiguous, 16-byte aligned CUDA
    tensor on the first one's device."""
    dev = tensors[0].device
    for t in tensors:
        if t is None:
            continue
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: tensors must share one CUDA device, "
                             f"got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")


def _canon_bias(bias: torch.Tensor, b: int, h: int, sq: int,
                skv: int) -> torch.Tensor:
    """A 4-D ``[b0, h0, q0, skv]`` bias with each leading dim 1 or full
    (the TPU kernel's rule, ``_canon_bias``), as fp32."""
    if bias.dim() != 4:
        raise ValueError(f"bias must be 4-D, got shape {tuple(bias.shape)}")
    b0, h0, q0, k0 = bias.shape
    if k0 != skv or b0 not in (1, b) or h0 not in (1, h) or \
            q0 not in (1, sq):
        raise ValueError(f"bias shape {tuple(bias.shape)} does not "
                         f"broadcast to [{b}, {h}, {sq}, {skv}]")
    return bias.to(torch.float32)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              bias: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`flash_attention`, in fp32.

    Args:
        q (torch.Tensor): ``[b, sq, h, d]``.
        k (torch.Tensor): ``[b, skv, h, d]``; ``v`` likewise.
        causal (bool): mask key ``j`` for query ``i`` when ``j > i``.
        bias (torch.Tensor): additive, broadcastable from
            ``[b0, h0, q0, skv]``, applied after the causal mask.

    Returns:
        ``(O [b, sq, h, d] in q's dtype, lse [b, h, sq] fp32)``.
    """
    b, sq, h, d = q.shape
    skv = k.shape[1]
    qf = q.float().permute(0, 2, 1, 3) * d ** -0.5
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    s = qf @ kf.transpose(-1, -2)                       # [b, h, sq, skv]
    if causal:
        live = torch.arange(skv, device=q.device)[None, :] <= \
            torch.arange(sq, device=q.device)[:, None]
        s = torch.where(live, s, torch.full_like(s, NEG_INF))
    if bias is not None:
        s = s + _canon_bias(bias, b, h, sq, skv)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    lsum = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = (p @ vf) / lsum
    lse = (m + torch.log(lsum)).squeeze(-1)
    return out.permute(0, 2, 1, 3).to(q.dtype), lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    bias: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward (kernel 1, ``csrc/flash_fwd.cu``).

    Same contract as :func:`flash_attention_reference`: any ``sq`` and
    ``skv``, bf16 or fp32 inputs, ``d`` in {64, 128} on the card. On CPU
    tensors the plain version runs; on CUDA tensors the kernel launches
    or this raises.

    Returns:
        ``(O [b, sq, h, d], lse [b, h, sq] fp32)``.
    """
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or \
            k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         f"[b, s, h, d] with matching b, h, d")
    if _on_cpu(q, k, v, bias):
        return flash_attention_reference(q, k, v, causal, bias)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtype {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; the kernel takes bf16 or fp32")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in "
                         f"{_HEAD_DIMS}")
    sb = sh = sqs = 0
    if bias is not None:
        bias = _canon_bias(bias, b, h, sq, skv).contiguous()
        b0, h0, q0, _ = bias.shape
        sqs = skv if q0 > 1 else 0
        sh = q0 * skv if h0 > 1 else 0
        sb = h0 * q0 * skv if b0 > 1 else 0
    _check_cuda("flash_attention", q, k, v, bias)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.pfx_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            out.data_ptr(), lse.data_ptr(), b, h, sq, skv, d, sb, sh, sqs,
            d ** -0.5, int(causal), int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with "
                           f"cudaError {rc}")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0


def flash_decode_reference(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, offsets,
                           bias: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_decode` /
    :func:`flash_decode_ragged`, in fp32.

    Args:
        q (torch.Tensor): ``[b, 1, h, d]``.
        k (torch.Tensor): the cache ``[b, h, S, d]``; ``v`` likewise.
        offsets: last live position, an int for every row or a ``[b]``
            integer tensor.
        bias (torch.Tensor): per-key additive bias ``[b, 1, 1, S]`` or
            ``[b, S]``, added before the mask.

    Returns:
        ``[b, 1, h, d]`` in q's dtype.
    """
    b, _, h, d = q.shape
    S = k.shape[2]
    s = torch.einsum("bhd,bhsd->bhs", q.float()[:, 0], k.float()) * d ** -0.5
    if bias is not None:
        s = s + bias.reshape(b, 1, S).float()
    # a shared int offset stays a host scalar: copying it to the card
    # would make every call wait for the stream
    off = offsets if isinstance(offsets, int) else \
        torch.as_tensor(offsets, device=q.device).reshape(-1, 1, 1)
    live = torch.arange(S, device=q.device)[None, None, :] <= off
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(s - m), torch.zeros_like(s))
    lsum = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhs,bhsd->bhd", p, v.float()) / lsum
    return out[:, None].to(q.dtype)


def _check_decode(q, k, v) -> None:
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or \
            k.shape != v.shape or k.shape[0] != q.shape[0] or \
            k.shape[1] != q.shape[2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} must be "
                         f"[b, 1, h, d] and k/v {tuple(k.shape)} the cache "
                         f"[b, h, S, d]")


def _launch_decode(q, k, v, offsets: Optional[torch.Tensor],
                   shared_offset: int, bias: Optional[torch.Tensor]
                   ) -> torch.Tensor:
    """Launch kernel 2 (either entry point) and count the launch."""
    b, _, h, d = q.shape
    S = k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_decode: dtype {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; the kernel takes bf16 or fp32")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_decode: head_dim {d} not in {_HEAD_DIMS}")
    if offsets is not None and (offsets.dtype != torch.int32 or
                                offsets.shape != (b,)):
        raise ValueError(f"flash_decode_ragged: offsets must be int32 "
                         f"[{b}], got {offsets.dtype} {tuple(offsets.shape)}")
    if bias is not None:
        if bias.numel() != b * S:
            raise ValueError(f"flash_decode: bias {tuple(bias.shape)} is "
                             f"not a per-key [b, S] = [{b}, {S}] bias")
        bias = bias.reshape(b, S).to(torch.float32).contiguous()
    _check_cuda("flash_decode", q, k, v, offsets, bias)
    out = torch.empty_like(q)
    lib = build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.pfx_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            offsets.data_ptr() if offsets is not None else None,
            int(shared_offset),
            bias.data_ptr() if bias is not None else None,
            out.data_ptr(), b, h, S, d, d ** -0.5,
            int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode: kernel launch failed with "
                           f"cudaError {rc}")
    flash_decode.launches += 1
    return out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 offset: int, bias: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """One decode step with one shared cache index (kernel 2, the
    lockstep ``generate()`` path): every row of ``q [b, 1, h, d]``
    attends to cache positions ``<= offset`` of ``k/v [b, h, S, d]``,
    with an optional per-key bias ``[b, 1, 1, S]`` (the left-pad mask).

    ``offset`` is a host int, passed to the kernel as an argument. On
    CPU tensors the plain version runs; on CUDA tensors the kernel
    launches or this raises.
    """
    _check_decode(q, k, v)
    offset = int(offset)
    if _on_cpu(q, k, v, bias):
        return flash_decode_reference(q, k, v, offset, bias)
    return _launch_decode(q, k, v, None, offset, bias)


flash_decode.launches = 0


def flash_decode_ragged(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        offsets: torch.Tensor) -> torch.Tensor:
    """One decode step with per-row offsets (kernel 2, the serving
    tick): row ``i`` of ``q [b, 1, h, d]`` attends to positions
    ``<= offsets[i]`` of its own cache row and walks no further, so a
    short slot never pays for a long one. ``offsets`` is a ``[b]`` int32
    tensor on q's device. Launches count in ``flash_decode.launches``.
    """
    _check_decode(q, k, v)
    if _on_cpu(q, k, v, offsets):
        return flash_decode_reference(q, k, v, offsets)
    return _launch_decode(q, k, v, offsets, 0, None)
