"""The port's attention kernels, their wrappers and plain versions.

- :func:`flash_attention` launches ``csrc/flash_fwd.cu`` (kernel 1),
  the port of the TPU forward kernel ``_fwd_kernel``
  (``paddlefleetx_tpu/ops/pallas/flash_attention.py:209``): causal or
  full online-softmax attention over ``[b, s, h, d]`` inputs with an
  optional additive bias and optional in-kernel dropout (a Philox mask
  on absolute coordinates, ``philox.py``), returning O and the per-row
  logsumexp. Serving runs it as prefill; training runs it with its
  gradient, which launches kernels 3 and 4.
- :func:`flash_attention_backward` launches ``csrc/flash_bwd.cu``:
  kernel 3 (``flash_bwd_dkv``: dK, dV) and kernel 4 (``flash_bwd_dq``:
  dQ), the port of the TPU backward family (``_bwd_combined_kernel``,
  ``_bwd_dkv_kernel`` + ``_bwd_dq_kernel``, ``_bwd_fused_kernel``,
  chosen by ``_flash_backward`` at ``:686``).
- :func:`flash_decode` and :func:`flash_decode_ragged` launch
  ``csrc/flash_decode.cu`` (kernel 2), the port of ``_decode_kernel``
  (``flash_attention.py:1055``): one query per row against the KV
  cache, keys ``0..offset`` (one shared offset plus a per-key bias, or
  one offset per row).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream and raises
if the launch returns a CUDA error. On tensors that lie on the CPU it
runs the plain PyTorch version from this module instead
(:func:`flash_attention_reference`,
:func:`flash_attention_backward_reference`,
:func:`flash_decode_reference`); on CUDA tensors it launches the kernel
or raises — there is no fallback from a launch to the plain version.
Each kernel counts its launches in a plain integer:
``flash_attention.launches`` (kernel 1),
``flash_attention_backward.launches_dkv`` (kernel 3),
``flash_attention_backward.launches_dq`` (kernel 4) and
``flash_decode.launches`` (kernel 2, both entry points), so a run can
show that its main path went through the kernels.

The gradient of :func:`flash_attention` is wired through
``torch.library.custom_op`` (``pfx::flash_attention``), so activation
checkpointing can name the op and keep its outputs (O, lse): under the
``save_dots`` policy the backward reuses them and never re-runs the
forward kernel. The bias is a mask and gets no gradient, as in the JAX
package (``flash_attention.py:932-934``).

Cache layout: the port's KV cache is ``[b, h, S, d]``. The TPU cache
``[b, h, d, S]`` was a TPU tiling choice (``ops/attention.py:11-15`` of
the JAX package); here a key's ``d`` values are contiguous, which is
what the decode kernel's 16-byte loads want.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build, philox

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


def _bias_strides(bias: torch.Tensor, sq: int, skv: int):
    """Element strides (batch, head, query) of a contiguous canonical
    bias, 0 along broadcast dims, as the kernels take them."""
    b0, h0, q0, _ = bias.shape
    return (h0 * q0 * skv if b0 > 1 else 0, q0 * skv if h0 > 1 else 0,
            skv if q0 > 1 else 0)


def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    """fp64 stays fp64 (the tests' autograd reference); all else fp32."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _check_dropout(rate: float, seed: Optional[int]) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} not in [0, 1)")
    if rate > 0.0 and (seed is None or not 0 <= int(seed) < 2 ** 63):
        raise ValueError("attention dropout needs a seed in [0, 2^63)")


def _dropout_args(rate: float, seed: Optional[int]):
    """The kernels' dropout arguments: on/off, threshold, scale, seed."""
    if rate <= 0.0:
        return 0, 0, 1.0, 0
    return (1, philox.keep_threshold(rate), philox.keep_scale(rate),
            int(seed))


def _scores(q, k, causal, bias):
    """Masked, biased fp32 (fp64 for fp64 inputs) scores
    ``[b, h, sq, skv]`` in the kernels' order: q k^T * scale, causal
    fill, then the bias."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    ct = _compute_dtype(q)
    qf = q.to(ct).permute(0, 2, 1, 3) * d ** -0.5
    s = qf @ k.to(ct).permute(0, 2, 3, 1)
    if causal:
        live = torch.arange(skv, device=q.device)[None, :] <= \
            torch.arange(sq, device=q.device)[:, None]
        s = torch.where(live, s, torch.full_like(s, NEG_INF))
    if bias is not None:
        s = s + _canon_bias(bias, b, h, sq, skv).to(ct)
    return s


def _dropped(x, rate, seed):
    """``x * keep / (1 - rate)`` with the Philox mask of ``seed`` for
    ``x`` of shape ``[b, h, sq, skv]``."""
    b, h, sq, skv = x.shape
    keep = philox.attention_keep_mask(seed, rate, b, h, sq, skv, x.device)
    return torch.where(keep, x * philox.keep_scale(rate),
                       torch.zeros_like(x))


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              bias: Optional[torch.Tensor] = None,
                              dropout_rate: float = 0.0,
                              seed: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`flash_attention`, in fp32 (fp64
    for fp64 inputs).

    Args:
        q (torch.Tensor): ``[b, sq, h, d]``.
        k (torch.Tensor): ``[b, skv, h, d]``; ``v`` likewise.
        causal (bool): mask key ``j`` for query ``i`` when ``j > i``.
        bias (torch.Tensor): additive, broadcastable from
            ``[b0, h0, q0, skv]``, applied after the causal mask.
        dropout_rate (float): drop probabilities with the Philox mask of
            ``seed``; the normaliser and lse sum the undropped ones.
        seed (int): the dropout seed.

    Returns:
        ``(O [b, sq, h, d] in q's dtype, lse [b, h, sq] fp32)``.
    """
    _check_dropout(dropout_rate, seed)
    s = _scores(q, k, causal, bias)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    lsum = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    pv = _dropped(p, dropout_rate, seed) if dropout_rate > 0.0 else p
    out = (pv @ v.to(s.dtype).permute(0, 2, 1, 3)) / lsum
    lse = (m + torch.log(lsum)).squeeze(-1)
    return out.permute(0, 2, 1, 3).to(q.dtype), \
        lse.to(torch.promote_types(lse.dtype, torch.float32))


def _check_qkv(q, k, v) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or \
            k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         f"[b, s, h, d] with matching b, h, d")


def _check_kernel_inputs(name, q, k, v) -> None:
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: dtype {q.dtype}/{k.dtype}/{v.dtype}; "
                         f"the kernel takes bf16 or fp32")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {q.shape[-1]} not in "
                         f"{_HEAD_DIMS}")


def _launch_forward(q, k, v, causal, bias, dropout_rate, seed):
    """Launch kernel 1 and count the launch."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    _check_kernel_inputs("flash_attention", q, k, v)
    sb = sh = sqs = 0
    if bias is not None:
        bias = _canon_bias(bias, b, h, sq, skv).contiguous()
        sb, sh, sqs = _bias_strides(bias, sq, skv)
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
            d ** -0.5, int(causal), int(q.dtype == torch.bfloat16),
            *_dropout_args(dropout_rate, seed), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with "
                           f"cudaError {rc}")
    flash_attention.launches += 1
    return out, lse


@torch.library.custom_op("pfx::flash_attention", mutates_args=())
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor], causal: bool,
                        dropout_rate: float, seed: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    if _on_cpu(q, k, v, bias):
        out, lse = flash_attention_reference(
            q, k, v, causal, bias, dropout_rate,
            seed if dropout_rate > 0.0 else None)
        return out.contiguous(), lse.contiguous()
    return _launch_forward(q, k, v, causal, bias, dropout_rate, seed)


def _flash_setup(ctx, inputs, output) -> None:
    q, k, v, bias, causal, dropout_rate, seed = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse, bias)
    ctx.causal, ctx.dropout_rate, ctx.seed = causal, dropout_rate, seed


def _flash_grad(ctx, g_out, g_lse):
    q, k, v, out, lse, bias = ctx.saved_tensors
    dq, dk, dv = flash_attention_backward(
        q, k, v, out, lse, g_out, g_lse, ctx.causal, bias,
        ctx.dropout_rate, ctx.seed if ctx.dropout_rate > 0.0 else None)
    return dq, dk, dv, None, None, None, None


torch.library.register_autograd("pfx::flash_attention", _flash_grad,
                                setup_context=_flash_setup)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    bias: Optional[torch.Tensor] = None,
                    dropout_rate: float = 0.0, seed: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward (kernel 1, ``csrc/flash_fwd.cu``), with
    its gradient through kernels 3 and 4.

    Same contract as :func:`flash_attention_reference`: any ``sq`` and
    ``skv``, bf16 or fp32 inputs, ``d`` in {64, 128} on the card,
    optional dropout at ``dropout_rate`` with the Philox mask of
    ``seed``. On CPU tensors the plain version runs; on CUDA tensors the
    kernel launches or this raises.

    Returns:
        ``(O [b, sq, h, d], lse [b, h, sq] fp32)``.
    """
    _check_qkv(q, k, v)
    _check_dropout(dropout_rate, seed)
    return _flash_attention_op(q, k, v, bias, bool(causal),
                               float(dropout_rate),
                               int(seed) if dropout_rate > 0.0 else 0)


flash_attention.launches = 0


def flash_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
        lse: torch.Tensor, do: torch.Tensor,
        g_lse: Optional[torch.Tensor] = None, causal: bool = True,
        bias: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
        seed: Optional[int] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`flash_attention_backward`, by the
    explicit formulas (not autograd), in fp32 (fp64 for fp64 inputs):
    recompute the scores, ``p = exp(s - lse)``, regenerate the keep
    mask, ``dP = dO v^T``, ``delta = rowsum(dO * O) - g_lse``,
    ``dS = p * (dP * keep / (1 - rate) - delta)``.

    Returns:
        ``(dq, dk, dv)`` in the dtypes of q, k and v.
    """
    _check_dropout(dropout_rate, seed)
    s = _scores(q, k, causal, bias)
    ct = s.dtype
    p = torch.exp(s - lse.to(ct)[..., None])
    dof = do.to(ct).permute(0, 2, 1, 3)                 # [b, h, sq, d]
    qf, kf, vf = (t.to(ct).permute(0, 2, 1, 3) for t in (q, k, v))
    dp = dof @ vf.transpose(-1, -2)
    p_dv = p
    if dropout_rate > 0.0:
        p_dv = _dropped(p, dropout_rate, seed)
        dp = _dropped(dp, dropout_rate, seed)
    delta = (dof * o.to(ct).permute(0, 2, 1, 3)).sum(-1)
    if g_lse is not None:
        delta = delta - g_lse.to(ct)
    ds = p * (dp - delta[..., None])
    scale = q.shape[-1] ** -0.5
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf) * scale
    dv = p_dv.transpose(-1, -2) @ dof
    return (dq.permute(0, 2, 1, 3).to(q.dtype),
            dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def _launch_backward(q, k, v, o, lse, do, g_lse, causal, bias,
                     dropout_rate, seed):
    """Launch kernels 3 and 4 and count each launch."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    _check_kernel_inputs("flash_attention_backward", q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or o.shape != q.shape:
        raise ValueError(f"flash_attention_backward: dO {tuple(do.shape)} "
                         f"{do.dtype} / O {tuple(o.shape)} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    if lse.shape != (b, h, sq):
        raise ValueError(f"flash_attention_backward: lse "
                         f"{tuple(lse.shape)} is not [{b}, {h}, {sq}]")
    do = do.contiguous()
    # delta = rowsum(dO * O) - g_lse in fp32, outside the kernels as in
    # the JAX package (flash_attention.py:693-699)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1)
    if g_lse is not None:
        delta = delta - g_lse.float()
    delta = delta.contiguous()
    lse = lse.float().contiguous()
    sb = sh = sqs = 0
    if bias is not None:
        bias = _canon_bias(bias, b, h, sq, skv).contiguous()
        sb, sh, sqs = _bias_strides(bias, sq, skv)
    _check_cuda("flash_attention_backward", q, k, v, do, lse, delta, bias)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    args = (b, h, sq, skv, d, sb, sh, sqs, d ** -0.5, int(causal),
            int(q.dtype == torch.bfloat16),
            *_dropout_args(dropout_rate, seed))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            bias.data_ptr() if bias is not None else None)
    lib = build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.pfx_flash_bwd_dkv(*ptrs, dk.data_ptr(), dv.data_ptr(),
                                   *args, stream)
        if rc != 0:
            raise RuntimeError(f"flash_bwd_dkv: kernel launch failed with "
                               f"cudaError {rc}")
        flash_attention_backward.launches_dkv += 1
        rc = lib.pfx_flash_bwd_dq(*ptrs, dq.data_ptr(), *args, stream)
        if rc != 0:
            raise RuntimeError(f"flash_bwd_dq: kernel launch failed with "
                               f"cudaError {rc}")
        flash_attention_backward.launches_dq += 1
    return dq, dk, dv


def flash_attention_backward(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
        lse: torch.Tensor, do: torch.Tensor,
        g_lse: Optional[torch.Tensor] = None, causal: bool = True,
        bias: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
        seed: Optional[int] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of :func:`flash_attention`: kernel 3 (dK, dV) and
    kernel 4 (dQ) of ``csrc/flash_bwd.cu``.

    Args:
        q, k, v, o (torch.Tensor): the forward's inputs and output.
        lse (torch.Tensor): the forward's ``[b, h, sq]`` logsumexp.
        do (torch.Tensor): the cotangent of O.
        g_lse (torch.Tensor): the cotangent of lse, or None.
        causal, bias, dropout_rate, seed: as given to the forward.

    Returns:
        ``(dq, dk, dv)`` in q's dtype. On CPU tensors the plain version
        runs; on CUDA tensors both kernels launch or this raises.
    """
    _check_qkv(q, k, v)
    _check_dropout(dropout_rate, seed)
    if _on_cpu(q, k, v, o, lse, do, g_lse, bias):
        return flash_attention_backward_reference(
            q, k, v, o, lse, do, g_lse, causal, bias, dropout_rate, seed)
    return _launch_backward(q, k, v, o, lse, do, g_lse, causal, bias,
                            dropout_rate, seed)


flash_attention_backward.launches_dkv = 0
flash_attention_backward.launches_dq = 0


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
