"""Kernels 8 and 9: the grouped GEMM, its wrappers, plain versions and
gradient.

:func:`grouped_matmul` launches kernel 8 of ``csrc/grouped_matmul.cu``,
the port of the TPU kernel ``_gmm_kernel``
(``paddlefleetx_tpu/ops/pallas/grouped_matmul.py:52``): ``out[g] = x[g]
@ w[g // rep]`` for the groups with ``counts[g] > 0`` and exact zeros
for the others, fp32 accumulation, the output in x's dtype. The layout
is the JAX package's: ``x [G, C, K]``, ``w [Gw, K, N]``, ``counts [G]``
int32, ``G % Gw == 0``, ``rep = G // Gw`` consecutive groups sharing one
weight. Its gradient mirrors ``_grouped_matmul_bwd`` (``:186-196``): dx
is kernel 8 again over ``w.transpose(1, 2)``, passed to the kernel as
strides (no copy), and dw is kernel 9 (:func:`grouped_matmul_dw`, the
port of ``_gmm_dw_kernel``, ``:76``), fp32, cast to w's dtype; counts
get no gradient. The op is ``torch.ops.pfx.grouped_matmul``, a
``torch.library.custom_op``, so the ``save_dots`` recompute policy can
keep its output (``models/gpt/model.py``).

Each bf16 call takes one of three routes, which :func:`plan` picks from
the shape alone: ``wgmma`` (route (a), Hopper's warpgroup products fed
by TMA, for outputs of at least 64 x 64: the MoE recipe's calls),
``split`` (route (b), one launch that splits a long reduction over a
cluster of blocks and sums the partials in a fixed order, for outputs
of at most 16 rows or 8 columns: the LoRA banks) and ``mma`` (route
(c), the ``mma.sync`` kernels, for every other shape: ragged or
unaligned K or N, odd strides, reductions under 16); fp32 calls take
the CUDA-core kernels (``f32``). Every route is one launch, writes
every output element, uses no atomics and gives the same bits on every
run.

On tensors that lie on the CPU the wrappers run the plain versions
(:func:`grouped_matmul_reference`, :func:`grouped_matmul_dw_reference`);
on CUDA tensors they launch the planned route's kernel or raise. Launches
count in ``grouped_matmul.launches`` (forward and dx) and
``grouped_matmul_dw.launches``, and by route in their
``launches_by_route``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import build, launch_counts

_DTYPES = (torch.bfloat16, torch.float32)

#: the routes a launch counts under: (a), (b), (c) and fp32's kernels
ROUTES = ("wgmma", "split", "mma", "f32")
#: each route's code in the C entry points (fp32 runs with code 0)
_ROUTE_CODE = {"mma": 0, "f32": 0, "wgmma": 1, "split": 2}
#: output tiles (rows, columns) of the mma and fp32 kernels
MMA_TILE, F32_TILE = (64, 128), (64, 64)
#: the wgmma route's tiles, and the tiles of the wide one a call needs
#: for it (4 waves on 132 SMs; fewer leave the last wave's SMs idle)
WGMMA_TILES, WGMMA_WIDE_MIN = ((128, 128), (128, 256)), 4 * 132
#: the split route: a warp's reduction step, warps a block, the largest
#: (portable) cluster, and the blocks it aims for at most (4 on each of
#: the H100's 132 streaming multiprocessors)
SPLIT_STEP, SPLIT_WARPS, SPLIT_MAX, SPLIT_BLOCKS = 32, 8, 8, 4 * 132


class Plan(NamedTuple):
    """A call's route, its output tile (rows, columns) and the blocks a
    cluster splits the reduction over (1 but on the split route)."""
    route: str
    tile: Tuple[int, int]
    splits: int


def _split_plan(g: int, rows: int, cols: int, red: int) -> Plan:
    """The split route's tile (16 rows when the output has at most 16,
    else 64; 8 columns when it has at most 8, else 64: never 64 x 64)
    and cluster size: enough blocks that each warp takes about one step
    of the reduction, no more than 8, and no more than keeps the grid
    near ``SPLIT_BLOCKS``."""
    tile = (16 if rows <= 16 else 64, 8 if cols <= 8 else 64)
    tiles = g * -(-rows // tile[0]) * -(-cols // tile[1])
    steps = -(-red // SPLIT_STEP)
    splits = max(1, min(SPLIT_MAX, -(-steps // SPLIT_WARPS),
                        SPLIT_BLOCKS // tiles))
    return Plan("split", tile, splits)


def _wgmma_plan(g: int, rows: int, cols: int) -> Plan:
    """The wgmma route's tile: 128 x 256 (three stages of 48 KB, a
    quarter fewer bytes through L2 for each product) where that still
    gives ``WGMMA_WIDE_MIN`` tiles, else 128 x 128 (four of 32 KB)."""
    wide = g * -(-rows // 128) * -(-cols // 256) >= WGMMA_WIDE_MIN
    return Plan("wgmma", WGMMA_TILES[wide], 1)


def plan(op: str, g: int, c: int, k: int, n: int, dtype: torch.dtype,
         aligned: bool = True) -> Plan:
    """The route of one call, from its shape alone (pure Python: the CPU
    tests hold it).

    Args:
        op (str): ``"fwd"`` (kernel 8, B ``[K, N]`` with N contiguous),
            ``"dx"`` (kernel 8, B with K contiguous) or ``"dw"`` (kernel
            9: the output is ``[K, N]``, the reduction each group's C).
        g (int): output groups (kernel 8: G; kernel 9: Gw).
        c, k, n (int): the call's C, K and N.
        dtype (torch.dtype): the operands' type.
        aligned (bool): K, N and the operands' strides are multiples of
            8 elements (16 bytes), the pointers 16-byte aligned.

    Returns:
        ``wgmma`` for bf16 outputs of at least 64 x 64 over a reduction
        of at least 16 (:func:`_wgmma_plan` picks its tile); ``split``
        for outputs of at most 16 rows or 8 columns over a reduction of
        at least 64; ``mma`` for every other bf16 shape (and every
        unaligned one); ``f32`` for fp32.
    """
    if op not in ("fwd", "dx", "dw"):
        raise ValueError(f"plan: op {op!r} is not fwd, dx or dw")
    if dtype != torch.bfloat16:
        return Plan("f32", F32_TILE, 1)
    rows, cols, red = (k, n, c) if op == "dw" else (c, n, k)
    if aligned and red >= 16 and rows >= 64 and cols >= 64:
        return _wgmma_plan(g, rows, cols)
    if aligned and red >= 64 and (rows <= 16 or cols <= 8):
        return _split_plan(g, rows, cols, red)
    return Plan("mma", MMA_TILE, 1)


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def plan_call(x: torch.Tensor, w: torch.Tensor) -> Plan:
    """The :func:`plan` of kernel 8 on ``x [G, C, K]`` and ``w [Gw, K, N]``
    (N or K contiguous)."""
    g, c, k = x.shape
    gw, _, n = w.shape
    sw, sbk, sbn = w.stride()
    op = "fwd" if sbn == 1 else "dx"
    ldb = sbk if op == "fwd" else sbn
    aligned = k % 8 == 0 and n % 8 == 0 and ldb % 8 == 0 and \
        sw % 8 == 0 and (gw == 1 or sw > 0) and _aligned(x, w)
    return plan(op, g, c, k, n, x.dtype, aligned)


def plan_call_dw(x: torch.Tensor, dy: torch.Tensor, w_groups: int) -> Plan:
    """The :func:`plan` of kernel 9 on ``x [G, C, K]``, ``dy [G, C, N]``."""
    _, c, k = x.shape
    n = dy.shape[-1]
    aligned = k % 8 == 0 and n % 8 == 0 and _aligned(x, dy)
    return plan("dw", w_groups, c, k, n, x.dtype, aligned)


def _route(planned: Plan, route) -> Plan:
    """The planned route, or the ``mma`` route that the caller named (a
    private argument: ``chip_smoke.py`` times the mma kernels, which took
    every bf16 shape before the wgmma and split routes, beside the
    planned route at the same shape; fp32 has only its ``f32``
    kernels)."""
    if route is None or route == planned.route:
        return planned
    if route != "mma" or planned.route == "f32":
        raise ValueError(f"grouped_matmul: route {route!r} for a "
                         f"{planned.route} call")
    return Plan("mma", MMA_TILE, 1)


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def check_shapes(x: torch.Tensor, w: torch.Tensor,
                 counts: torch.Tensor) -> None:
    """The JAX package's admission (``_check_shapes``): ``x [G, C, K]``,
    ``w [Gw, K, N]`` with ``Gw`` dividing ``G``, integer ``counts [G]``.

    Raises:
        NotImplementedError: the operands are not of that layout.
    """
    if x.dim() != 3 or w.dim() != 3 or counts.dim() != 1:
        raise NotImplementedError(
            f"grouped_matmul wants x[G,C,K] w[Gw,K,N] counts[G], got "
            f"{tuple(x.shape)} / {tuple(w.shape)} / {tuple(counts.shape)}")
    if x.shape[0] != counts.shape[0] or x.shape[0] % w.shape[0] or \
            x.shape[2] != w.shape[1]:
        raise NotImplementedError(
            f"grouped_matmul shape mismatch: x {tuple(x.shape)}, w "
            f"{tuple(w.shape)}, counts {tuple(counts.shape)}")
    if counts.dtype.is_floating_point or counts.dtype.is_complex or \
            counts.dtype == torch.bool:
        raise NotImplementedError("counts must be integer")


def grouped_matmul_reference(x: torch.Tensor, w: torch.Tensor,
                             counts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel 8: ``x[g].float() @ w[g //
    rep].float()`` where ``counts[g] > 0``, zeros elsewhere, cast to
    x's dtype (``w`` may be any strided view)."""
    rep = x.shape[0] // w.shape[0]
    out = torch.bmm(x.float(), w.float().repeat_interleave(rep, dim=0))
    live = (counts > 0).to(out.device)[:, None, None]
    return torch.where(live, out, torch.zeros_like(out)).to(x.dtype)


def grouped_matmul_dw_reference(x: torch.Tensor, dy: torch.Tensor,
                                counts: torch.Tensor,
                                w_groups: int) -> torch.Tensor:
    """Plain PyTorch version of kernel 9: fp32 ``dw [Gw, K, N]``, per
    expert the sum over its live groups of ``x[g]^T @ dy[g]``."""
    g, _, k = x.shape
    n = dy.shape[-1]
    prod = torch.bmm(x.float().transpose(1, 2), dy.float())
    live = (counts > 0).to(prod.device)[:, None, None]
    prod = torch.where(live, prod, torch.zeros_like(prod))
    return prod.view(w_groups, g // w_groups, k, n).sum(dim=1)


def _check_cuda(name: str, *tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda" or t.data_ptr() % 16:
            raise ValueError(f"{name}: the operands must be 16-byte "
                             f"aligned tensors on one CUDA device")
    if tensors[-1].dtype != torch.int32 or not tensors[-1].is_contiguous():
        raise ValueError(f"{name}: counts must be contiguous int32")


def _check_dtype(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise ValueError(f"{name}: dtypes {a.dtype} / {b.dtype}; the kernel "
                         f"takes bf16 or fp32, both alike")
    if not a.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if min(a.shape) < 1 or min(b.shape) < 1:
        raise ValueError(f"{name}: empty operand {tuple(a.shape)} / "
                         f"{tuple(b.shape)}")


def _launch(x, w, counts, route=None) -> torch.Tensor:
    """Launch kernel 8 on ``w`` as strided ([K, N] with N or K
    contiguous) by the planned route (or ``route``) and count the
    launch."""
    g, c, k = x.shape
    gw, _, n = w.shape
    _check_dtype("grouped_matmul", x, w)
    sw, sbk, sbn = w.stride()
    if sbn != 1 and sbk != 1:
        raise ValueError(f"grouped_matmul: w strides {w.stride()} have "
                         f"neither N nor K contiguous")
    _check_cuda("grouped_matmul", x, w, counts)
    p = _route(plan_call(x, w), route)
    out = torch.empty((g, c, n), dtype=x.dtype, device=x.device)
    lib = build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pfx_grouped_matmul(
            x.data_ptr(), w.data_ptr(), counts.data_ptr(), out.data_ptr(),
            g, c, k, n, g // gw, sw, sbk, sbn,
            int(x.dtype == torch.bfloat16), _ROUTE_CODE[p.route], *p.tile,
            p.splits, stream)
    if rc != 0:
        raise RuntimeError(f"grouped_matmul: {p.route} kernel launch "
                           f"failed with cudaError {rc}")
    grouped_matmul.launches += 1
    grouped_matmul.launches_by_route[p.route] += 1
    return out


def _forward(x, w, counts) -> torch.Tensor:
    """Kernel 8, or its plain version on CPU tensors (``w`` may be a
    transposed view: the dx route)."""
    if _on_cpu(x, w, counts):
        return grouped_matmul_reference(x, w, counts)
    return _launch(x, w, counts)


@torch.library.custom_op("pfx::grouped_matmul", mutates_args=())
def _grouped_matmul_op(x: torch.Tensor, w: torch.Tensor,
                       counts: torch.Tensor) -> torch.Tensor:
    return _forward(x, w, counts)


def _gmm_setup(ctx, inputs, output) -> None:
    x, w, counts = inputs
    ctx.save_for_backward(x, w, counts)


def _gmm_grad(ctx, grad):
    x, w, counts = ctx.saved_tensors
    grad = grad.contiguous()
    dx = dw = None
    if ctx.needs_input_grad[0]:
        dx = grouped_matmul_dx(grad, w, counts).to(x.dtype)
    if ctx.needs_input_grad[1]:
        dw = grouped_matmul_dw(x, grad, counts, w.shape[0]).to(w.dtype)
    return dx, dw, None


torch.library.register_autograd("pfx::grouped_matmul", _gmm_grad,
                                setup_context=_gmm_setup)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   counts: torch.Tensor) -> torch.Tensor:
    """Per-group matmul ``out[g] = x[g] @ w[g // (G // Gw)]`` that gives
    zeros for the groups with ``counts[g] == 0`` (kernel 8,
    ``csrc/grouped_matmul.cu``), with its gradient through kernels 8
    (dx) and 9 (dw).

    Args:
        x (torch.Tensor): ``[G, C, K]``, bf16 or fp32: G groups of C
            capacity-padded rows.
        w (torch.Tensor): ``[Gw, K, N]`` in x's dtype; ``Gw`` divides G
            and consecutive blocks of ``G // Gw`` groups share a weight.
        counts (torch.Tensor): ``[G]`` integer live rows per group.

    Returns:
        ``[G, C, N]`` in x's dtype. On CPU tensors the plain version runs;
        on CUDA tensors the kernel launches or this raises.

    Raises:
        NotImplementedError: the layout is not the one above
            (:func:`check_shapes`).
    """
    check_shapes(x, w, counts)
    return torch.ops.pfx.grouped_matmul(x, w, counts.to(torch.int32))


launch_counts.register(grouped_matmul,
                       tables={"launches_by_route": ROUTES})


def grouped_matmul_dx(dy: torch.Tensor, w: torch.Tensor,
                      counts: torch.Tensor) -> torch.Tensor:
    """The input gradient of :func:`grouped_matmul`: ``dx[g] = dy[g] @
    w[g // rep]^T`` (zeros for an empty group, as in the forward), kernel
    8 reading ``w [Gw, K, N]`` transposed through its strides (no copy);
    ``dy [G, C, N]``, int32 ``counts [G]``. Launches count in
    ``grouped_matmul.launches``."""
    return _forward(dy, w.transpose(1, 2), counts)


def grouped_matmul_dw(x: torch.Tensor, dy: torch.Tensor,
                      counts: torch.Tensor, w_groups: int) -> torch.Tensor:
    """The weight gradient of :func:`grouped_matmul` (kernel 9): fp32
    ``dw [w_groups, K, N]``, per expert ``e`` the sum over its groups
    ``e * rep .. e * rep + rep - 1`` with ``counts > 0`` of ``x[g]^T @
    dy[g]`` (``x [G, C, K]``, ``dy [G, C, N]``, int32 ``counts [G]``).
    On CPU tensors the plain version runs; on CUDA tensors the kernel
    launches or this raises."""
    if _on_cpu(x, dy, counts):
        return grouped_matmul_dw_reference(x, dy, counts, w_groups)
    return _launch_dw(x, dy, counts, w_groups)


def _launch_dw(x, dy, counts, w_groups, route=None) -> torch.Tensor:
    """Launch kernel 9 by the planned route (or ``route``) and count the
    launch."""
    g, c, k = x.shape
    n = dy.shape[-1]
    _check_dtype("grouped_matmul_dw", x, dy)
    if dy.shape[:2] != x.shape[:2] or g % w_groups or \
            not dy.is_contiguous():
        raise ValueError(f"grouped_matmul_dw: x {tuple(x.shape)}, dy "
                         f"{tuple(dy.shape)}, {w_groups} weight groups")
    _check_cuda("grouped_matmul_dw", x, dy, counts)
    p = _route(plan_call_dw(x, dy, w_groups), route)
    dw = torch.empty((w_groups, k, n), dtype=torch.float32, device=x.device)
    lib = build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pfx_grouped_matmul_dw(
            x.data_ptr(), dy.data_ptr(), counts.data_ptr(), dw.data_ptr(),
            g, w_groups, c, k, n, int(x.dtype == torch.bfloat16),
            _ROUTE_CODE[p.route], *p.tile, p.splits, stream)
    if rc != 0:
        raise RuntimeError(f"grouped_matmul_dw: {p.route} kernel launch "
                           f"failed with cudaError {rc}")
    grouped_matmul_dw.launches += 1
    grouped_matmul_dw.launches_by_route[p.route] += 1
    return dw


launch_counts.register(grouped_matmul_dw,
                       tables={"launches_by_route": ROUTES})
