"""The port's attention kernels, their wrappers and plain versions.

- :func:`flash_attention` launches ``csrc/flash_fwd.cu`` (kernel 1),
  the port of the TPU forward kernel ``_fwd_kernel``
  (``paddlefleetx_tpu/ops/pallas/flash_attention.py:209``): causal or
  full online-softmax attention over ``[b, s, h, d]`` inputs with an
  optional additive bias and optional in-kernel dropout (a Philox mask
  on absolute coordinates, ``philox.py``), returning O and the per-row
  logsumexp. Serving runs it as prefill; training runs it with its
  gradient, which launches kernels 3 and 4. Each call takes one of
  three routes, which :func:`plan` picks from the shape: ``wgmma``
  (bf16: Hopper's warpgroup products fed by a TMA ring of K / V tiles
  of 64 or 128 keys), ``f32`` (fp32's CUDA-core kernel), or ``mma``
  (the first bf16 design on ``mma.sync``, kept and planned for no call;
  ``chip_smoke.py`` times it beside the planned route through the
  private ``route`` argument of ``_launch_forward``).
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
- :func:`flash_decode_verify` launches kernel 5, the port of
  ``_verify_kernel`` (``:1140``):
  a window of ``1 < W <= 32`` queries per row at positions
  ``offset + j``, the speculative verify.
- :func:`flash_decode_paged` and :func:`flash_decode_paged_verify`
  launch kernels 6a and 6b, the ports of ``_paged_decode_kernel``
  (``:1422``) and ``_paged_verify_kernel`` (``:1433``): the same
  through a page table over a ``[P, h, page, d]`` page pool.

  The four decode kernels are one family with two routes, which
  :func:`plan_decode` picks from the shape: ``mma`` (bf16 queries: the
  tensor cores, the key length split over a thread-block cluster) and
  ``simt`` (fp32's CUDA-core body, kept as bf16's comparison route;
  ``chip_smoke.py`` times it through each wrapper's ``route``
  argument). On either route verify query ``j`` equals kernel 2 at
  offset ``offset + j`` and the paged kernels equal the contiguous ones
  on the gathered cache, bit for bit.
- Each decode entry point also reads an int8 cache
  (``kv_cache_dtype: int8``, the ``quantized=True`` branch of the TPU
  kernels): given ``k_scale`` / ``v_scale`` (one fp32 scale per (row,
  head, position): ``[b, h, S]``, or ``[P, h, page]`` for a pool), the
  int8 instance of the same body dequantizes each element in-kernel,
  and the plain versions dequantize in fp32 before the same math.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream and raises
if the launch returns a CUDA error. On tensors that lie on the CPU it
runs the plain PyTorch version from this module instead
(:func:`flash_attention_reference`,
:func:`flash_attention_backward_reference`,
:func:`flash_decode_reference`, :func:`flash_decode_paged_reference`);
on CUDA tensors it launches the kernel or raises — there is no fallback
from a launch to the plain version. Each kernel counts its launches in
a plain integer: ``flash_attention.launches`` (kernel 1; by route in
``flash_attention.launches_by_route``),
``flash_attention_backward.launches_dkv`` (kernel 3),
``flash_attention_backward.launches_dq`` (kernel 4),
``flash_decode.launches`` (kernel 2, both one-query entry points),
``flash_decode_verify.launches`` (kernel 5),
``flash_decode_paged.launches`` (kernel 6a) and
``flash_decode_paged_verify.launches`` (kernel 6b), the int8 instances
of the last four apart in ``.launches_int8`` of the same wrappers and
both by route in their ``.launches_by_route``, so a run can show that
its main path went through the kernels and which instance and route
ran.

The gradient of :func:`flash_attention` is wired through
``torch.library.custom_op`` (``pfx::flash_attention``), so activation
checkpointing can name the op and keep its outputs (O, lse): under the
``save_dots`` policy the backward reuses them and never re-runs the
forward kernel. The bias is a mask and gets no gradient, as in the JAX
package (``flash_attention.py:932-934``).

Cache layout: the port's KV cache is ``[b, h, S, d]`` and its page
pool ``[P, h, page, d]``. The TPU's ``[b, h, d, S]`` / ``[P, h, d,
page]`` were a TPU tiling choice (``ops/attention.py:11-15`` of the JAX
package); here a key's ``d`` values are contiguous, which is what the
decode kernels' 16-byte loads want.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import build, launch_counts, philox

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


def _check_kernel_inputs(name, q, k, v, quantized: bool = False) -> None:
    cache = torch.int8 if quantized else q.dtype
    if q.dtype not in _DTYPES or k.dtype != cache or v.dtype != cache:
        raise ValueError(f"{name}: dtype {q.dtype}/{k.dtype}/{v.dtype}; "
                         f"the kernel takes bf16 or fp32 (and an int8 "
                         f"cache with scales)")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {q.shape[-1]} not in "
                         f"{_HEAD_DIMS}")


#: kernel 1's routes (``csrc/flash_fwd.cu``): ``wgmma`` (bf16, planned),
#: ``mma`` (bf16, the first design's ``mma.sync`` kernel, planned for no
#: call) and ``f32`` (fp32's CUDA-core kernel)
ROUTES = ("wgmma", "mma", "f32")
#: each route's code in the C entry point (fp32 runs with code 0)
_ROUTE_CODE = {"mma": 0, "f32": 0, "wgmma": 1}
#: the key tile each route takes: ``mma`` 64 and ``f32`` 32 keys; the
#: ``wgmma`` route 64, or 128 at head_dim 64 (:func:`plan`)
_BLOCK_N = {"mma": 64, "f32": 32}
#: the ``wgmma`` route's key tiles at head_dim 64; the 128-key tile's
#: shortest key length, and the most 64-row blocks (two an SM of the
#: H100's 132) it is planned for
WGMMA_BLOCK_N = (64, 128)
WIDE_MIN_SKV = 512
WIDE_MAX_BLOCKS = 2 * 132


class Plan(NamedTuple):
    """A kernel-1 call's route and the keys of its K / V tiles."""
    route: str
    block_n: int


def plan(b: int, h: int, sq: int, skv: int, d: int, dtype: torch.dtype,
         dropout: bool) -> Plan:
    """The route of one kernel-1 call, from its shape alone (pure
    Python: the CPU tests hold it).

    Args:
        b, h, sq, skv, d (int): batch, heads, query and key lengths,
            head_dim.
        dtype (torch.dtype): q's type.
        dropout (bool): whether the call drops probabilities (on the
            H100 the same tile won with and without; ``PERF.md`` §6).

    Returns:
        ``f32`` for fp32; for bf16 ``wgmma``: 128-key tiles at head_dim
        64 where the grid of 64-row blocks fits two an SM
        (``WIDE_MAX_BLOCKS``) and the walk is long (``skv >=
        WIDE_MIN_SKV``): a serving prefill, one prompt, whose blocks run
        nearly alone on their SMs, so halving the walk's steps (each
        with its own waits, product latency and softmax) pays; else
        64-key tiles, which keep three blocks an SM to hide that latency
        and waste less of a short walk's last tile (d 128's O
        accumulator leaves no registers for the wider tile). Never
        ``mma``. ``chip_smoke.py`` times the tile the plan did not pick
        beside the planned one (``PERF.md`` §6).
    """
    if dtype != torch.bfloat16:
        return Plan("f32", _BLOCK_N["f32"])
    blocks = b * h * -(-sq // 64)
    wide = d == 64 and skv >= WIDE_MIN_SKV and blocks <= WIDE_MAX_BLOCKS
    return Plan("wgmma", WGMMA_BLOCK_N[int(wide)])


def _route(b, h, sq, skv, d, dtype, dropout, route=None,
           block_n=None) -> Plan:
    """The planned route, or the one the caller named, with its own tile
    or ``block_n`` (private arguments: ``chip_smoke.py`` and the card
    test time and hold the ``mma`` kernel, which took every bf16 call
    before the ``wgmma`` route, and the ``wgmma`` tile the plan did not
    pick, beside the planned one). The kernel refuses a route or tile
    that cannot take the shape."""
    planned = plan(b, h, sq, skv, d, dtype, dropout)
    route = planned.route if route is None else route
    if route not in ROUTES or (route == "f32") != (dtype == torch.float32):
        raise ValueError(f"flash_attention: route {route!r} for a {dtype} "
                         f"call")
    if block_n is None:
        block_n = planned.block_n if route == planned.route else \
            _BLOCK_N.get(route, WGMMA_BLOCK_N[0])
    return Plan(route, int(block_n))


def _launch_forward(q, k, v, causal, bias, dropout_rate, seed, route=None,
                    block_n=None):
    """Launch kernel 1 by the planned route (or ``route``, with its tile
    or ``block_n``) and count the launch."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    _check_kernel_inputs("flash_attention", q, k, v)
    p = _route(b, h, sq, skv, d, q.dtype, dropout_rate > 0.0, route,
               block_n)
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
            *_dropout_args(dropout_rate, seed), _ROUTE_CODE[p.route],
            p.block_n, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: {p.route} kernel launch "
                           f"failed with cudaError {rc}")
    flash_attention.launches += 1
    flash_attention.launches_by_route[p.route] += 1
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


launch_counts.register(flash_attention,
                       tables={"launches_by_route": ROUTES})


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


launch_counts.register(flash_attention_backward,
                       counts=("launches_dkv", "launches_dq"))


#: widest query window the decode kernels take (the JAX package's
#: ``MAX_VERIFY_WINDOW``): a speculative verify of up to 31 drafts
MAX_VERIFY_WINDOW = 32
#: the decode kernels' routes (``csrc/flash_decode.cu``): ``mma`` (bf16
#: queries over a bf16 or int8 cache: the tensor cores, the key length
#: split over a thread-block cluster; planned) and ``simt`` (CUDA cores:
#: fp32's only route, and the bf16 / int8 comparison route that
#: ``chip_smoke.py`` times beside ``mma``)
DECODE_ROUTES = ("mma", "simt")
#: a decode wrapper's launch counts: bf16 / fp32 caches, int8 caches
DECODE_COUNTS = ("launches", "launches_int8")
#: each route's code in the C entry points
_DECODE_ROUTE_CODE = {"simt": 0, "mma": 1}
#: the ``mma`` route's chunk of absolute key positions (block ``r`` of a
#: cluster walks chunks ``r, r + cluster, ...``), its largest cluster
#: (the portable limit; half at head_dim 128, where the leader block's
#: slots for 8 blocks' partials of 16 window rows would pass the 227 KB
#: of shared memory a block may have), and the chunks a block walks
#: before the plan adds blocks to the cluster: 8 over a bf16 cache, 4
#: over an int8 one, whose tiles are half the bytes and cost a widening
DECODE_CHUNK = 128
DECODE_MAX_CLUSTER = 8
DECODE_CHUNKS_PER_BLOCK = {"bf16": 8, "int8": 4}


class DecodePlan(NamedTuple):
    """A decode call's route, the keys of a block's chunk and the blocks
    of a cluster (``simt``: one block walks the whole capacity)."""
    route: str
    chunk: int
    cluster: int


def plan_decode(b: int, w: int, h: int, S: int, d: int, dtype: torch.dtype,
                int8: bool, paged: bool, page: int) -> DecodePlan:
    """The route of one decode-kernel call (kernels 2, 5, 6a, 6b), from
    its shape alone (pure Python: the CPU tests hold it).

    Args:
        b, w, h, S, d (int): rows, window queries, heads, capacity (the
            contiguous cache's ``S``, a pool's ``max_pages * page``),
            head_dim.
        dtype (torch.dtype): q's type.
        int8 (bool): whether the cache is int8.
        paged (bool), page (int): whether the cache is a page pool, and
            its page size.

    Returns:
        ``simt`` for fp32 queries (TF32 misses fp32 parity); else
        ``mma`` with ``DECODE_CHUNK``-key chunks in clusters of the
        largest power of two up to ``DECODE_MAX_CLUSTER`` (4 at head_dim
        128) that leaves each block ``DECODE_CHUNKS_PER_BLOCK`` chunks
        of its cache type (one block below that): a block's warps stream
        their tiles through a two-stage ring, and on the H100 larger
        clusters paid more to launch than they saved at the serving
        ticks' shapes (``PERF.md`` §6). The chunk and the cluster follow
        from the capacity, d and the cache type alone, never from ``w``,
        the offsets or the addressing (the other arguments take part in
        no choice): verify
        query ``j`` equals kernel 2 at offset ``offset + j``, and a pool
        equals its gathered cache, bit for bit only where both split the
        keys alike.
    """
    if dtype != torch.bfloat16:
        return DecodePlan("simt", S, 1)
    chunks = -(-S // DECODE_CHUNK)
    most = DECODE_MAX_CLUSTER if d == 64 else DECODE_MAX_CLUSTER // 2
    per_block = DECODE_CHUNKS_PER_BLOCK["int8" if int8 else "bf16"]
    cluster = 1
    while cluster * 2 <= min(chunks // per_block, most):
        cluster *= 2
    return DecodePlan("mma", DECODE_CHUNK, cluster)


def _decode_route(name, q, S, quantized, page, route=None) -> DecodePlan:
    """The planned route of a decode call, or the one the caller named
    (``chip_smoke.py`` times ``simt`` beside ``mma``); raises on a route
    that is not one, or ``mma`` for a query that is not bf16."""
    b, w, h, d = q.shape
    planned = plan_decode(b, w, h, S, d, q.dtype, quantized, page > 0, page)
    if route is None or route == planned.route:
        return planned
    if route != "simt":
        raise ValueError(f"{name}: route {route!r} for a {q.dtype} query; "
                         f"the routes are {DECODE_ROUTES}, mma for bf16")
    return DecodePlan("simt", S, 1)


def dequantize_cache(t: torch.Tensor, scale: Optional[torch.Tensor]
                     ) -> torch.Tensor:
    """A cache, pool or fresh ``[.., d]`` K / V in fp32: ``t.float()``,
    times ``scale`` (``t`` minus its d axis) for an int8 one; each
    element one rounded product, as the int8 kernels widen it."""
    if scale is None:
        return t.float()
    return t.float() * scale.float()[..., None]


def flash_decode_reference(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, offsets,
                           bias: Optional[torch.Tensor] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain PyTorch version of every decode kernel on a contiguous
    cache (:func:`flash_decode`, :func:`flash_decode_ragged`,
    :func:`flash_decode_verify`), in fp32. A window is its queries
    decoded one by one: query ``j`` of row ``i`` is the one-query
    version at offset ``offset_i + j``, the property the verify kernel
    keeps bit for bit.

    Args:
        q (torch.Tensor): ``[b, W, h, d]`` (``W = 1``: plain decode).
        k (torch.Tensor): the cache ``[b, h, S, d]``; ``v`` likewise.
        offsets: the first query's last live position, an int for every
            row or a ``[b]`` integer tensor.
        bias (torch.Tensor): per-key additive bias ``[b, 1, 1, S]`` or
            ``[b, S]``, added before the mask.
        k_scale, v_scale (torch.Tensor): an int8 cache's ``[b, h, S]``
            fp32 scales (both or neither); the cache is dequantized in
            fp32 first.

    Returns:
        ``[b, W, h, d]`` in q's dtype.
    """
    b, w, h, d = q.shape
    k, v = dequantize_cache(k, k_scale), dequantize_cache(v, v_scale)
    if w > 1:
        return torch.cat([flash_decode_reference(
            q[:, j:j + 1].contiguous(), k, v, offsets + j, bias)
            for j in range(w)], dim=1)
    S = k.shape[2]
    s = torch.einsum("bhd,bhsd->bhs", q.float()[:, 0], k) * d ** -0.5
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
    out = torch.einsum("bhs,bhsd->bhd", p, v) / lsum
    return out[:, None].to(q.dtype)


def gather_kv_pages(pool: torch.Tensor,
                    page_table: torch.Tensor) -> torch.Tensor:
    """A paged pool ``[P, h, page, d]`` read through ``page_table
    [b, max_pages]`` back into the contiguous ``[b, h, max_pages * page,
    d]`` cache, each row's logical positions in order (the port of the
    JAX package's ``ops/attention.py::_gather_kv_pages``); a scale pool
    ``[P, h, page]`` likewise into ``[b, h, max_pages * page]``. It
    materializes every row at full capacity: the plain versions' and
    the dense path's read, never a kernel's."""
    g = pool[page_table.long()].transpose(1, 2)   # [b, h, m, page, (d)]
    b, h, m, page = g.shape[:4]
    return g.reshape(b, h, m * page, *pool.shape[3:])


def flash_decode_paged_reference(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, offsets: torch.Tensor,
                                 page_table: torch.Tensor,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_decode_paged` and
    :func:`flash_decode_paged_verify`: gather each row's pages (and an
    int8 pool's scale pages, :func:`gather_kv_pages`), then
    :func:`flash_decode_reference`."""
    if k_scale is not None:
        k_scale = gather_kv_pages(k_scale, page_table)
        v_scale = gather_kv_pages(v_scale, page_table)
    return flash_decode_reference(q, gather_kv_pages(k, page_table),
                                  gather_kv_pages(v, page_table), offsets,
                                  k_scale=k_scale, v_scale=v_scale)


def _check_decode(q, k, v, windows=range(1, 2)) -> None:
    if q.dim() != 4 or q.shape[1] not in windows or k.dim() != 4 or \
            k.shape != v.shape or k.shape[0] != q.shape[0] or \
            k.shape[1] != q.shape[2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} must be "
                         f"[b, W, h, d] with W in {windows} and k/v "
                         f"{tuple(k.shape)} the cache [b, h, S, d]")


def _check_paged(q, k, v, page_table, windows=range(1, 2)) -> None:
    if q.dim() != 4 or q.shape[1] not in windows or \
            k.dim() != 4 or k.shape != v.shape or \
            k.shape[1] != q.shape[2] or k.shape[3] != q.shape[3] or \
            page_table.dim() != 2 or page_table.shape[0] != q.shape[0]:
        raise ValueError(f"flash_decode_paged: q {tuple(q.shape)} must be "
                         f"[b, W, h, d] with W in {windows}, the pool "
                         f"{tuple(k.shape)} [P, h, page, d] and the page "
                         f"table {tuple(page_table.shape)} [b, max_pages]")


def _check_kv_scales(name, k, v, k_scale, v_scale) -> bool:
    """Whether the cache is int8 (the port of the JAX kernels'
    ``_check_kv_scales``): scales come both or neither, with scales
    the cache must be int8, and each scale is the cache minus its d
    axis (``[b, h, S]`` or ``[P, h, page]``) in fp32."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: int8 KV wants both k_scale and v_scale "
                         f"(or neither)")
    if k_scale is None:
        return False
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise ValueError(f"{name}: KV scales given but the cache is "
                         f"{k.dtype}/{v.dtype}, not int8")
    want = tuple(k.shape[:3])
    for s in (k_scale, v_scale):
        if tuple(s.shape) != want or s.dtype != torch.float32:
            raise ValueError(f"{name}: KV scales must be fp32 {want}, got "
                             f"{s.dtype} {tuple(s.shape)}")
    return True


def _scale_ptrs(k_scale, v_scale):
    """The scale pointers a decode entry point takes (None: no int8)."""
    if k_scale is None:
        return None, None
    return k_scale.data_ptr(), v_scale.data_ptr()


def _count(wrapper, quantized: bool, route: str) -> None:
    """Count one launch of a decode kernel's bf16/fp32 or int8 instance,
    and under its route."""
    if quantized:
        wrapper.launches_int8 += 1
    else:
        wrapper.launches += 1
    wrapper.launches_by_route[route] += 1


def _check_offsets(name, offsets, b) -> None:
    if offsets.dtype != torch.int32 or offsets.shape != (b,):
        raise ValueError(f"{name}: offsets must be int32 [{b}], got "
                         f"{offsets.dtype} {tuple(offsets.shape)}")


def _launch_rc(name: str, rc: int, route: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: {route} kernel launch failed with "
                           f"cudaError {rc}")


def _launch_decode(q, k, v, offsets: Optional[torch.Tensor],
                   shared_offset: int, bias: Optional[torch.Tensor],
                   k_scale, v_scale, quantized: bool,
                   p: DecodePlan) -> torch.Tensor:
    """Launch kernel 2 (either entry point) by the route ``p`` and count
    the launch."""
    b, _, h, d = q.shape
    S = k.shape[2]
    _check_kernel_inputs("flash_decode", q, k, v, quantized)
    if offsets is not None:
        _check_offsets("flash_decode_ragged", offsets, b)
    if bias is not None:
        if bias.numel() != b * S:
            raise ValueError(f"flash_decode: bias {tuple(bias.shape)} is "
                             f"not a per-key [b, S] = [{b}, {S}] bias")
        bias = bias.reshape(b, S).to(torch.float32).contiguous()
    _check_cuda("flash_decode", q, k, v, offsets, bias, k_scale, v_scale)
    out = torch.empty_like(q)
    lib = build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.pfx_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *_scale_ptrs(k_scale, v_scale),
            offsets.data_ptr() if offsets is not None else None,
            int(shared_offset),
            bias.data_ptr() if bias is not None else None,
            out.data_ptr(), b, h, S, d, d ** -0.5,
            int(q.dtype == torch.bfloat16), _DECODE_ROUTE_CODE[p.route],
            p.cluster, stream)
    _launch_rc("flash_decode", rc, p.route)
    _count(flash_decode, quantized, p.route)
    return out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 offset: int, bias: Optional[torch.Tensor] = None,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None,
                 route: Optional[str] = None) -> torch.Tensor:
    """One decode step with one shared cache index (kernel 2, the
    lockstep ``generate()`` path): every row of ``q [b, 1, h, d]``
    attends to cache positions ``<= offset`` of ``k/v [b, h, S, d]``,
    with an optional per-key bias ``[b, 1, 1, S]`` (the left-pad mask);
    with ``k_scale`` / ``v_scale`` (``[b, h, S]`` fp32) the cache is
    int8 and the int8 instance runs (``flash_decode.launches_int8``).

    ``offset`` is a host int, passed to the kernel as an argument. On
    CPU tensors the plain version runs; on CUDA tensors the kernel
    launches by the route :func:`plan_decode` picks, or by ``route``
    (one of ``DECODE_ROUTES``; counted in ``.launches_by_route``), or
    this raises.
    """
    _check_decode(q, k, v)
    quantized = _check_kv_scales("flash_decode", k, v, k_scale, v_scale)
    p = _decode_route("flash_decode", q, k.shape[2], quantized, 0, route)
    offset = int(offset)
    if _on_cpu(q, k, v, bias, k_scale, v_scale):
        return flash_decode_reference(q, k, v, offset, bias, k_scale,
                                      v_scale)
    return _launch_decode(q, k, v, None, offset, bias, k_scale, v_scale,
                          quantized, p)


launch_counts.register(flash_decode, counts=DECODE_COUNTS,
                       tables={"launches_by_route": DECODE_ROUTES})


def flash_decode_ragged(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        offsets: torch.Tensor,
                        k_scale: Optional[torch.Tensor] = None,
                        v_scale: Optional[torch.Tensor] = None,
                        route: Optional[str] = None) -> torch.Tensor:
    """Decode with per-row offsets over the contiguous cache, the
    serving tick: row ``i`` of ``q [b, 1, h, d]`` attends to positions
    ``<= offsets[i]`` of its own cache row and walks no further, so a
    short slot never pays for a long one. ``offsets`` is a ``[b]`` int32
    tensor on q's device; ``k_scale`` / ``v_scale`` as in
    :func:`flash_decode`. Launches kernel 2 (counted in
    ``flash_decode.launches`` or ``.launches_int8``, and by route, as
    there); the window is :func:`flash_decode_verify`.
    """
    _check_decode(q, k, v)
    quantized = _check_kv_scales("flash_decode_ragged", k, v, k_scale,
                                 v_scale)
    p = _decode_route("flash_decode_ragged", q, k.shape[2], quantized, 0,
                      route)
    if _on_cpu(q, k, v, offsets, k_scale, v_scale):
        return flash_decode_reference(q, k, v, offsets, None, k_scale,
                                      v_scale)
    return _launch_decode(q, k, v, offsets, 0, None, k_scale, v_scale,
                          quantized, p)


def flash_decode_verify(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        offsets: torch.Tensor,
                        k_scale: Optional[torch.Tensor] = None,
                        v_scale: Optional[torch.Tensor] = None,
                        route: Optional[str] = None) -> torch.Tensor:
    """The speculative verify window over the contiguous cache (kernel
    5, ``csrc/flash_decode.cu``): query ``j`` of row ``i`` of ``q [b, W,
    h, d]`` (``1 < W <= 32``) sits at position ``offsets[i] + j`` and
    attends to keys ``<= offsets[i] + j`` of ``k/v [b, h, S, d]``
    (int8 with ``k_scale`` / ``v_scale``, as in :func:`flash_decode`).
    On the card query ``j`` equals kernel 2 at offset ``offsets[i] + j``
    bit for bit. On CPU tensors the plain version runs; on CUDA tensors
    the kernel launches by the planned route or ``route``, as in
    :func:`flash_decode` (``flash_decode_verify.launches`` or
    ``.launches_int8``, and ``.launches_by_route``), or this raises.
    """
    _check_decode(q, k, v, range(2, MAX_VERIFY_WINDOW + 1))
    quantized = _check_kv_scales("flash_decode_verify", k, v, k_scale,
                                 v_scale)
    p = _decode_route("flash_decode_verify", q, k.shape[2], quantized, 0,
                      route)
    if _on_cpu(q, k, v, offsets, k_scale, v_scale):
        return flash_decode_reference(q, k, v, offsets, None, k_scale,
                                      v_scale)
    b, w, h, d = q.shape
    S = k.shape[2]
    _check_kernel_inputs("flash_decode_verify", q, k, v, quantized)
    _check_offsets("flash_decode_verify", offsets, b)
    _check_cuda("flash_decode_verify", q, k, v, offsets, k_scale, v_scale)
    out = torch.empty_like(q)
    lib = build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.pfx_flash_decode_verify(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *_scale_ptrs(k_scale, v_scale), offsets.data_ptr(),
            out.data_ptr(), b, w, h, S, d, d ** -0.5,
            int(q.dtype == torch.bfloat16), _DECODE_ROUTE_CODE[p.route],
            p.cluster, stream)
    _launch_rc("flash_decode_verify", rc, p.route)
    _count(flash_decode_verify, quantized, p.route)
    return out


launch_counts.register(flash_decode_verify, counts=DECODE_COUNTS,
                       tables={"launches_by_route": DECODE_ROUTES})


def _launch_paged(wrapper, q, k, v, offsets, page_table, dims, k_scale,
                  v_scale, quantized: bool, p: DecodePlan) -> torch.Tensor:
    """Launch kernel 6a or 6b through its C entry point
    ``pfx_<wrapper name>``, whose leading sizes are ``dims``, by the
    route ``p``, and count the launch."""
    name = wrapper.__name__
    b, _, _, d = q.shape
    _check_kernel_inputs(name, q, k, v, quantized)
    _check_offsets(name, offsets, b)
    if page_table.dtype != torch.int32:
        raise ValueError(f"{name}: page_table must be int32, got "
                         f"{page_table.dtype}")
    _check_cuda(name, q, k, v, offsets, page_table, k_scale, v_scale)
    out = torch.empty_like(q)
    lib = build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, "pfx_" + name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *_scale_ptrs(k_scale, v_scale), offsets.data_ptr(),
            page_table.data_ptr(), out.data_ptr(), *dims, k.shape[2],
            page_table.shape[1], d, d ** -0.5,
            int(q.dtype == torch.bfloat16), _DECODE_ROUTE_CODE[p.route],
            p.cluster, stream)
    _launch_rc(name, rc, p.route)
    _count(wrapper, quantized, p.route)
    return out


def flash_decode_paged(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       offsets: torch.Tensor,
                       page_table: torch.Tensor,
                       k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None,
                       route: Optional[str] = None) -> torch.Tensor:
    """Decode through a paged KV pool (kernel 6a; the window is
    :func:`flash_decode_paged_verify`): row ``i`` of ``q [b, 1, h, d]``
    attends to positions ``<= offsets[i]`` of its logical cache, whose
    logical page ``j`` is physical page
    ``page_table[i, j]`` of the pool ``k/v [P, h, page, d]`` (the port's
    page layout; the JAX pool is ``[P, h, d, page]``). ``offsets`` is a
    ``[b]`` int32 tensor and ``page_table`` a ``[b, max_pages]`` int32
    tensor, both on q's device; an int8 pool comes with its ``[P, h,
    page]`` fp32 scale pools ``k_scale`` / ``v_scale``. On the card the
    result equals kernel 2 on the gathered cache bit for bit. On CPU
    tensors the plain version (:func:`flash_decode_paged_reference`)
    runs; on CUDA tensors the kernel launches by the planned route or
    ``route``, as in :func:`flash_decode` (``flash_decode_paged.launches``
    or ``.launches_int8``, and ``.launches_by_route``), or this raises.
    """
    _check_paged(q, k, v, page_table)
    quantized = _check_kv_scales("flash_decode_paged", k, v, k_scale,
                                 v_scale)
    p = _decode_route("flash_decode_paged", q,
                      k.shape[2] * page_table.shape[1], quantized,
                      k.shape[2], route)
    if _on_cpu(q, k, v, offsets, page_table, k_scale, v_scale):
        return flash_decode_paged_reference(q, k, v, offsets, page_table,
                                            k_scale, v_scale)
    return _launch_paged(flash_decode_paged, q, k, v, offsets, page_table,
                         (q.shape[0], q.shape[2]), k_scale, v_scale,
                         quantized, p)


launch_counts.register(flash_decode_paged, counts=DECODE_COUNTS,
                       tables={"launches_by_route": DECODE_ROUTES})


def flash_decode_paged_verify(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, offsets: torch.Tensor,
                              page_table: torch.Tensor,
                              k_scale: Optional[torch.Tensor] = None,
                              v_scale: Optional[torch.Tensor] = None,
                              route: Optional[str] = None) -> torch.Tensor:
    """The speculative verify window through a paged pool (kernel 6b):
    :func:`flash_decode_verify`'s within-window causal mask over
    :func:`flash_decode_paged`'s addressing (int8 pools as there),
    ``1 < W <= 32``. On the card it equals kernel 5 on the gathered
    cache bit for bit. Launches (by the planned route or ``route``)
    count in ``flash_decode_paged_verify.launches`` or
    ``.launches_int8``, and ``.launches_by_route``."""
    _check_paged(q, k, v, page_table, range(2, MAX_VERIFY_WINDOW + 1))
    quantized = _check_kv_scales("flash_decode_paged_verify", k, v,
                                 k_scale, v_scale)
    p = _decode_route("flash_decode_paged_verify", q,
                      k.shape[2] * page_table.shape[1], quantized,
                      k.shape[2], route)
    if _on_cpu(q, k, v, offsets, page_table, k_scale, v_scale):
        return flash_decode_paged_reference(q, k, v, offsets, page_table,
                                            k_scale, v_scale)
    return _launch_paged(flash_decode_paged_verify, q, k, v, offsets,
                         page_table, q.shape[:3], k_scale, v_scale,
                         quantized, p)


launch_counts.register(flash_decode_paged_verify, counts=DECODE_COUNTS,
                       tables={"launches_by_route": DECODE_ROUTES})
