"""Kernel 7: the weight-only int8 matmul, its wrapper and plain version.

:func:`quantized_matmul` launches ``csrc/quantized_matmul.cu``, the port
of the TPU kernel ``_qmm_kernel``
(``paddlefleetx_tpu/ops/pallas/quantized_matmul.py:44``): ``out = (x @
w^T) * scale`` with ``x [M, K]`` bf16 or fp32, the frozen int8 weight
``w [N, K]`` (``nn.Linear``'s layout, K contiguous; the JAX weight is
``[K, N]``), one fp32 ``scale [N]`` per output row, an fp32 accumulator
and the scale applied after the sum over K. On tensors that lie on the
CPU the wrapper runs :func:`quantized_matmul_reference`; on CUDA tensors
it launches the kernel or raises. Launches count in
``quantized_matmul.launches``.

The kernel takes the JAX kernel's admission for K and N (multiples of
128, :func:`admits`); a dense site that fails it takes the JAX package's
own per-site route, dequantize then matmul (``models/gpt/model.py::
QuantLinear``). The JAX rule ``M % 8 == 0`` was a TPU tiling rule: the
kernel masks the M edge and takes every M.

The gradient is the JAX VJP's (``_quantized_matmul_bwd``,
``:129-145``): ``dx = gs @ w`` with ``gs = (g.float() * scale)`` rounded
to g's dtype first, fp32 accumulation, dx in g's dtype, through kernel
7's dx route (:func:`quantized_matmul_dx`: a second instance of the
kernel that reads the same ``[N, K]`` int8 storage the other way, no
copy). The weight is a frozen PTQ artifact and the scales calibration
constants: neither gets a gradient. dx launches count in
``quantized_matmul.dx_launches``.
"""

from __future__ import annotations

import torch

from . import build

_DTYPES = (torch.bfloat16, torch.float32)


def admits(k: int, n: int) -> bool:
    """Whether the kernel takes a ``[*, k] @ [n, k]^T`` site: ``k`` and
    ``n`` multiples of 128, the JAX kernel's admission."""
    return k > 0 and n > 0 and k % 128 == 0 and n % 128 == 0


def quantized_matmul_reference(x: torch.Tensor, w: torch.Tensor,
                               scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`quantized_matmul`, in the
    kernel's order of operations: ``((x.float() @ w.float().t()) *
    scale).to(x.dtype)``."""
    return ((x.float() @ w.float().t()) * scale.float()).to(x.dtype)


def _check(x, w, scale) -> None:
    if x.dim() != 2 or w.dim() != 2 or scale.dim() != 1 or \
            x.shape[1] != w.shape[1] or w.shape[0] != scale.shape[0]:
        raise ValueError(f"quantized_matmul: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, scale {tuple(scale.shape)} are "
                         f"not [M, K], [N, K], [N]")
    if w.dtype != torch.int8:
        raise ValueError(f"quantized_matmul: the weight is {w.dtype}, not "
                         f"int8")


def _launch(x, w, scale) -> torch.Tensor:
    """Launch kernel 7 and count the launch."""
    m, k = x.shape
    n = w.shape[0]
    if x.dtype not in _DTYPES:
        raise ValueError(f"quantized_matmul: x is {x.dtype}; the kernel "
                         f"takes bf16 or fp32")
    if scale.dtype != torch.float32:
        raise ValueError(f"quantized_matmul: scale is {scale.dtype}, not "
                         f"fp32")
    if not admits(k, n):
        raise ValueError(f"quantized_matmul: K={k}, N={n} must be "
                         f"multiples of 128")
    tensors = (x, w, scale)
    dev = x.device
    for t in tensors:
        if t.device != dev or dev.type != "cuda" or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("quantized_matmul: x, w and scale must be "
                             "contiguous, 16-byte aligned tensors on one "
                             "CUDA device")
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pfx_quantized_matmul(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
            m, n, k, int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"quantized_matmul: kernel launch failed with "
                           f"cudaError {rc}")
    quantized_matmul.launches += 1
    return out


def quantized_matmul_dx_reference(gs: torch.Tensor,
                                  w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`quantized_matmul_dx`: ``(gs.float()
    @ w.float()).to(gs.dtype)``."""
    return (gs.float() @ w.float()).to(gs.dtype)


def quantized_matmul_dx(gs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Kernel 7's dx route: ``gs [M, N] @ w [N, K]`` with an fp32
    accumulator, out ``[M, K]`` in gs's dtype (bf16 or fp32), ``w`` the
    forward's int8 weight as stored; ``gs`` is the output gradient
    already scaled and rounded (:class:`_QuantizedMatmul`). On CPU
    tensors the plain version runs; on CUDA tensors the kernel launches
    (K and N multiples of 128) or this raises."""
    if gs.dim() != 2 or w.dim() != 2 or gs.shape[1] != w.shape[0] or \
            w.dtype != torch.int8:
        raise ValueError(f"quantized_matmul_dx: gs {tuple(gs.shape)}, w "
                         f"{tuple(w.shape)} {w.dtype} are not [M, N], int8 "
                         f"[N, K]")
    if gs.device.type == "cpu" and w.device.type == "cpu":
        return quantized_matmul_dx_reference(gs, w)
    m, n = gs.shape
    k = w.shape[1]
    if gs.dtype not in _DTYPES:
        raise ValueError(f"quantized_matmul_dx: gs is {gs.dtype}; the "
                         f"kernel takes bf16 or fp32")
    if not admits(k, n):
        raise ValueError(f"quantized_matmul_dx: K={k}, N={n} must be "
                         f"multiples of 128")
    dev = gs.device
    for t in (gs, w):
        if t.device != dev or dev.type != "cuda" or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("quantized_matmul_dx: gs and w must be "
                             "contiguous, 16-byte aligned tensors on one "
                             "CUDA device")
    dx = torch.empty((m, k), dtype=gs.dtype, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pfx_quantized_matmul_dx(
            gs.data_ptr(), w.data_ptr(), dx.data_ptr(), m, n, k,
            int(gs.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"quantized_matmul_dx: kernel launch failed with "
                           f"cudaError {rc}")
    quantized_matmul.dx_launches += 1
    return dx


class _QuantizedMatmul(torch.autograd.Function):
    """The kernel (or, on the CPU, its plain version) and the JAX VJP:
    dx through kernel 7's dx route, no gradient for the int8 weight or
    the scales."""

    @staticmethod
    def forward(ctx, x, w, scale):
        ctx.save_for_backward(w, scale)
        if all(t.device.type == "cpu" for t in (x, w, scale)):
            return quantized_matmul_reference(x, w, scale)
        return _launch(x, w, scale)

    @staticmethod
    def backward(ctx, grad):
        w, scale = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            # the scale folded into the cotangent (exact: it is per N,
            # the contraction axis here), rounded to g's dtype first
            gs = (grad.float() * scale).to(grad.dtype).contiguous()
            dx = quantized_matmul_dx(gs, w)
        return dx, None, None


def quantized_matmul(x: torch.Tensor, w: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """Weight-only int8 matmul (kernel 7, ``csrc/quantized_matmul.cu``).

    Args:
        x (torch.Tensor): ``[M, K]`` activations, bf16 or fp32.
        w (torch.Tensor): ``[N, K]`` int8 weight.
        scale (torch.Tensor): ``[N]`` fp32 per-output-row scales.

    Returns:
        ``[M, N]`` in x's dtype. On CPU tensors the plain version runs;
        on CUDA tensors the kernel launches (K and N multiples of 128)
        or this raises.
    """
    _check(x, w, scale)
    return _QuantizedMatmul.apply(x, w, scale)


quantized_matmul.launches = 0
quantized_matmul.dx_launches = 0
