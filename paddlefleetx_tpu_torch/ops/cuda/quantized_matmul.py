"""Kernel 7: the weight-only int8 matmul, its wrapper, planner and plain
version.

:func:`quantized_matmul` launches ``csrc/quantized_matmul.cu``, the port
of the TPU kernel ``_qmm_kernel``
(``paddlefleetx_tpu/ops/pallas/quantized_matmul.py:44``): ``out = (x @
w^T) * scale`` with ``x [M, K]`` bf16 or fp32, the frozen int8 weight
``w [N, K]`` (``nn.Linear``'s layout, K contiguous; the JAX weight is
``[K, N]``), one fp32 ``scale [N]`` per output row, an fp32 accumulator
and the scale applied after the sum over K. On tensors that lie on the
CPU the wrapper runs :func:`quantized_matmul_reference`; on CUDA tensors
it launches the planned route's kernel or raises.

The kernel takes the JAX kernel's admission for K and N (multiples of
128, :func:`admits`); a dense site that fails it takes the JAX package's
own per-site route, dequantize then matmul (``models/gpt/model.py::
QuantLinear``). The JAX rule ``M % 8 == 0`` was a TPU tiling rule: the
kernel masks the M edge and takes every M.

The gradient is the JAX VJP's (``_quantized_matmul_bwd``,
``:129-145``): ``dx = gs @ w`` with ``gs = (g.float() * scale)`` rounded
to g's dtype first, fp32 accumulation, dx in g's dtype, through kernel
7's dx route (:func:`quantized_matmul_dx`: a second instance of each of
the kernel's routes that reads the same ``[N, K]`` int8 storage the
other way, no copy). The weight is a frozen PTQ artifact and the scales
calibration constants: neither gets a gradient.

Each call takes one of four routes, which :func:`plan` picks from the
shape alone:

- ``stream`` (bf16, M <= ``STREAM_MAX_M``: the decode tick), bound by
  the int8 weight's bytes: a cluster of up to 8 blocks splits the
  reduction of each 64 output channels, each block loads its whole slice
  at once with TMA, and each block pushes its partials into the blocks
  that own their channels (``st.async`` counted on an mbarrier), which
  sum them in a fixed order;
- ``wgmma`` (bf16, larger M: the verify window, prefill chunks, prompts,
  the gradient phase's 4096, forward and dx), bound by the products:
  Hopper's warpgroup products fed by a TMA ring, the int8 weight widened
  in registers as their A operand, the activations their B; a cluster
  splits the reduction where the tiles fill under half the card;
- ``mma`` (bf16): the first design's ``mma.sync`` kernel, kept; no shape
  is planned to it (``chip_smoke.py`` times it beside the planned route
  through the private ``route`` argument);
- ``f32``: fp32's CUDA-core kernel.

The boundary ``STREAM_MAX_M`` and the cluster capacities in
``WGMMA_CLUSTERS`` were measured on the H100 (``PERF.md`` §6):
from M 48 up the wgmma route is as fast as the stream route or faster.
Every route is one launch, uses no atomics and gives the same bits on
every run. Launches count in ``quantized_matmul.launches`` and
``quantized_matmul.dx_launches``, and by route in
``quantized_matmul.launches_by_route`` and ``dx_launches_by_route``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import build, launch_counts

_DTYPES = (torch.bfloat16, torch.float32)

#: the routes a launch counts under
ROUTES = ("stream", "wgmma", "mma", "f32")
#: each route's code in the C entry points (fp32 runs with code 0)
_ROUTE_CODE = {"mma": 0, "f32": 0, "wgmma": 1, "stream": 2}
#: streaming multiprocessors of the H100
SMS = 132
#: the stream route: the most tokens it takes, its output channels a
#: cluster, the reduction depth of one of its TMA stages, a block's
#: slice at most and the slice it aims for (measured at the decode
#: tick: shorter slices add more partials than they save, longer ones
#: serialize a block's loads), and the largest (portable) cluster
STREAM_MAX_M, STREAM_TILE, STREAM_STAGE = 32, 64, 128
STREAM_MAX_SLICE, STREAM_SLICE, SPLIT_MAX = 512, 256, 8
#: the wgmma route's output tile (tokens, channels) and the reduction
#: depth of a stage; the clusters of 8, 4 and 2 of its blocks (one block
#: an SM) that the H100 keeps at once (``cudaOccupancyMaxActiveClusters``,
#: which ``chip_smoke.py`` records as ``max_active_clusters``)
WGMMA_TILE, WGMMA_STEP = (128, 128), 64
WGMMA_CLUSTERS = {8: 15, 4: 30, 2: 66}


class Plan(NamedTuple):
    """A call's route and the blocks a cluster splits its reduction
    over (1 on the ``mma`` and ``f32`` routes)."""
    route: str
    splits: int


def admits(k: int, n: int) -> bool:
    """Whether the kernel takes a ``[*, k] @ [n, k]^T`` site: ``k`` and
    ``n`` multiples of 128, the JAX kernel's admission."""
    return k > 0 and n > 0 and k % 128 == 0 and n % 128 == 0


def _stream_splits(red: int):
    """The stream route's cluster size for a reduction of ``red``: the
    one (at most 8) whose slice, a whole number of 128-deep stages of at
    most ``STREAM_MAX_SLICE``, lies nearest ``STREAM_SLICE`` (the fewer
    blocks on a tie); None where no cluster size gives such a slice."""
    cands = [s for s in range(1, SPLIT_MAX + 1)
             if red % (s * STREAM_STAGE) == 0 and
             red // s <= STREAM_MAX_SLICE]
    if not cands:
        return None
    return min(cands, key=lambda s: abs(red // s - STREAM_SLICE))


def _wgmma_splits(m: int, out: int, red: int) -> int:
    """The wgmma route's cluster size: 1 (a persistent grid) where the
    128 x 128 tiles fill at least half the card, else the largest of 8,
    4, 2 whose clusters (one a tile) all fit on the card at once and
    split the reduction into whole pairs of stages."""
    tiles = -(-m // WGMMA_TILE[0]) * (out // WGMMA_TILE[1])
    if 2 * tiles > SMS:
        return 1
    for s, fit in WGMMA_CLUSTERS.items():
        if tiles <= fit and red % (s * 2 * WGMMA_STEP) == 0:
            return s
    return 1


def plan(op: str, m: int, k: int, n: int, dtype: torch.dtype) -> Plan:
    """The route of one call, from its shape alone (pure Python: the CPU
    tests hold it).

    Args:
        op (str): ``"fwd"`` (``[M, K] @ w [N, K]^T``) or ``"dx"`` (``gs
            [M, N] @ w [N, K]``).
        m (int): rows of x (gs).
        k, n (int): the weight's ``[N, K]`` (multiples of 128).
        dtype (torch.dtype): x's (gs's) type.

    Returns:
        ``stream`` for bf16 with ``m <= STREAM_MAX_M``, ``wgmma`` for
        every larger bf16 M, ``f32`` for fp32; never ``mma``.
    """
    if op not in ("fwd", "dx"):
        raise ValueError(f"plan: op {op!r} is not fwd or dx")
    if dtype != torch.bfloat16:
        return Plan("f32", 1)
    out, red = (n, k) if op == "fwd" else (k, n)
    if m <= STREAM_MAX_M:
        splits = _stream_splits(red)
        if splits is not None:
            return Plan("stream", splits)
    return Plan("wgmma", _wgmma_splits(m, out, red))


def _route(op, m, k, n, dtype, route) -> Plan:
    """The planned route, or the one the caller named (a private
    argument: ``chip_smoke.py`` times the ``mma`` kernel, which took
    every bf16 shape before the stream and wgmma routes, and the other
    route beside the planned one, and the card test holds every route at
    every shape). A named route's kernel refuses a shape it cannot
    take."""
    planned = plan(op, m, k, n, dtype)
    if route is None or route == planned.route:
        return planned
    if route not in ROUTES or (route == "f32") != (dtype == torch.float32):
        raise ValueError(f"quantized_matmul: route {route!r} for a "
                         f"{dtype} call")
    out, red = (n, k) if op == "fwd" else (k, n)
    if route == "stream":
        return Plan(route, _stream_splits(red) or 1)
    if route == "wgmma":
        return Plan(route, _wgmma_splits(m, out, red))
    return Plan(route, 1)


def _enqueue(op, a, w, out, scale, m, k, n, dtype, device, route=None):
    """Launch the planned (or named) route's kernel on the current
    stream of ``device``, raise if the launch was refused, and count
    it."""
    p = _route(op, m, k, n, dtype, route)
    lib = build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        args = (int(dtype == torch.bfloat16), _ROUTE_CODE[p.route],
                p.splits, stream)
        if op == "fwd":
            rc = lib.pfx_quantized_matmul(a, w, scale, out, m, n, k, *args)
        else:
            rc = lib.pfx_quantized_matmul_dx(a, w, out, m, n, k, *args)
    name = "quantized_matmul" if op == "fwd" else "quantized_matmul_dx"
    if rc != 0:
        raise RuntimeError(f"{name}: {p.route} kernel launch failed with "
                           f"cudaError {rc}")
    if op == "fwd":
        quantized_matmul.launches += 1
        quantized_matmul.launches_by_route[p.route] += 1
    else:
        quantized_matmul.dx_launches += 1
        quantized_matmul.dx_launches_by_route[p.route] += 1
    return p


def max_active_clusters(op: str, m: int, k: int, n: int, p: Plan) -> int:
    """How many clusters of the stream or wgmma kernel a call planned as
    ``p`` can keep on the card at once (``cudaOccupancyMaxActiveClusters``;
    the card's current device). Raises on another route or a refused
    query."""
    import ctypes
    red = k if op == "fwd" else n
    count = ctypes.c_int(-1)
    rc = build.load().pfx_quantized_matmul_clusters(
        _ROUTE_CODE[p.route] if p.route in ("stream", "wgmma") else -1,
        int(op == "dx"), m, red, p.splits, ctypes.addressof(count))
    if rc != 0:
        raise RuntimeError(f"max_active_clusters: {p} refused ({rc})")
    return count.value


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


def _launch(x, w, scale, route=None) -> torch.Tensor:
    """Launch kernel 7 by the planned route (or ``route``) and count the
    launch."""
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
    _enqueue("fwd", x.data_ptr(), w.data_ptr(), out.data_ptr(),
             scale.data_ptr(), m, k, n, x.dtype, dev, route)
    return out


def quantized_matmul_dx_reference(gs: torch.Tensor,
                                  w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`quantized_matmul_dx`: ``(gs.float()
    @ w.float()).to(gs.dtype)``."""
    return (gs.float() @ w.float()).to(gs.dtype)


def quantized_matmul_dx(gs: torch.Tensor, w: torch.Tensor,
                        route=None) -> torch.Tensor:
    """Kernel 7's dx route: ``gs [M, N] @ w [N, K]`` with an fp32
    accumulator, out ``[M, K]`` in gs's dtype (bf16 or fp32), ``w`` the
    forward's int8 weight as stored; ``gs`` is the output gradient
    already scaled and rounded (:class:`_QuantizedMatmul`). On CPU
    tensors the plain version runs; on CUDA tensors the planned route's
    kernel launches (K and N multiples of 128) or this raises. ``route``
    is private: it names another route (``chip_smoke.py``, the card
    test)."""
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
    _enqueue("dx", gs.data_ptr(), w.data_ptr(), dx.data_ptr(), None, m, k, n,
             gs.dtype, dev, route)
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


launch_counts.register(quantized_matmul,
                       counts=("launches", "dx_launches"),
                       tables={"launches_by_route": ROUTES,
                               "dx_launches_by_route": ROUTES})
