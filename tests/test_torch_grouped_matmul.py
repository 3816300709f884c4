"""Kernels 8 and 9 (the grouped GEMM) against the JAX package: the plain
versions and the ``pfx::grouped_matmul`` op's gradient on the CPU
against the JAX Pallas ``grouped_matmul`` in interpret mode and its
``jax.vjp`` (fp32, 1e-5 relative: the same products summed in another
order), the empty-group zeros, ragged C / K / N, and the admission; the
route planner and the C entry points' ctypes signatures. The launches
need the card: their test is marked ``cuda`` and skips here. JAX is
imported inside the tests that use it, so that the ``cuda`` test runs
on a machine with the card and without JAX::

    python -m pytest --noconftest -q -m cuda tests/test_torch_grouped_matmul.py
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from paddlefleetx_tpu_torch.ops.cuda import build
from paddlefleetx_tpu_torch.ops.cuda import grouped_matmul as gmm

rng = np.random.default_rng


def _jax():
    """``(jax, jax.numpy, the JAX package's grouped_matmul)``."""
    import jax
    import jax.numpy as jnp
    from paddlefleetx_tpu.ops.pallas.grouped_matmul import grouped_matmul
    return jax, jnp, grouped_matmul

#: fp32: the same products in another summation order
RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("PFX_PALLAS_INTERPRET", "1")


def _case(g=6, gw=3, c=8, k=16, n=24, seed=0, fill=0.6, pad=False):
    """``x [G, C, K]`` with the rows past each group's count zeroed, ``w
    [Gw, K, N]``, int32 counts with some groups empty (the JAX test's
    generator). ``pad`` keeps those rows non-zero instead, as the fc2
    input's ``gelu(b1)`` padding rows are."""
    r = rng(seed)
    counts = r.integers(0, c + 1, size=g).astype(np.int32)
    counts[: max(1, int(g * (1 - fill)))] = 0
    r.shuffle(counts)
    x = r.normal(size=(g, c, k)).astype(np.float32)
    if not pad:
        x = x * (np.arange(c)[None, :, None] < counts[:, None, None])
    w = r.normal(size=(gw, k, n)).astype(np.float32)
    return x, w, counts


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("g,gw", [(4, 4), (6, 3), (8, 2)])
def test_forward_matches_jax(g, gw):
    _, jnp, jax_gmm = _jax()
    x, w, counts = _case(g=g, gw=gw, seed=g)
    want = jax_gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(counts))
    got = gmm.grouped_matmul(*_t(x, w, counts))
    assert got.dtype == torch.float32 and got.shape == (g, 8, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert gmm.grouped_matmul.launches == 0    # the CPU ran the plain one


def test_empty_groups_are_exact_zeros():
    """An empty group's block is zeros even where its x rows are not (the
    fc2 input's padding rows are gelu(b1)); all groups empty: all
    zeros."""
    _, jnp, jax_gmm = _jax()
    x, w, counts = _case(fill=0.3, seed=3)
    x[counts == 0] = 1.0
    got = gmm.grouped_matmul(*_t(x, w, counts)).numpy()
    want = np.asarray(jax_gmm(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(counts)))
    assert (counts == 0).sum() >= 2
    for gi in np.nonzero(counts == 0)[0]:
        np.testing.assert_array_equal(got[gi], 0.0)
        np.testing.assert_array_equal(want[gi], 0.0)
    zero = np.zeros_like(counts)
    got = gmm.grouped_matmul(*_t(x, w, zero))
    np.testing.assert_array_equal(got.numpy(), 0.0)
    dw = gmm.grouped_matmul_dw(*_t(x, x[..., :5], zero), 3)
    assert dw.shape == (3, 16, 5)
    np.testing.assert_array_equal(dw.numpy(), 0.0)


@pytest.mark.parametrize("c,k,n", [(5, 12, 20), (7, 9, 13), (16, 64, 40)])
def test_ragged_shapes_match_jax(c, k, n):
    _, jnp, jax_gmm = _jax()
    x, w, counts = _case(g=4, gw=2, c=c, k=k, n=n, seed=c + k)
    want = jax_gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(counts))
    got = gmm.grouped_matmul(*_t(x, w, counts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("g,gw,c,k,n", [(6, 3, 8, 16, 24),
                                        (8, 2, 5, 12, 20)])
def test_grads_match_jax_vjp(g, gw, c, k, n):
    """dx (kernel 8 over w transposed) and dw (kernel 9, fp32) against
    the JAX custom VJP; counts get no gradient."""
    jax, jnp, jax_gmm = _jax()
    x, w, counts = _case(g=g, gw=gw, c=c, k=k, n=n, seed=40 + g)
    dy = rng(41).normal(size=(g, c, n)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jax_gmm(a, b, jnp.asarray(counts)),
                     jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(dy))
    xt, wt, ct, dyt = _t(x, w, counts, dy)
    xt.requires_grad_(True)
    wt.requires_grad_(True)
    gmm.grouped_matmul(xt, wt, ct).backward(dyt)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_dw),
                               rtol=RTOL, atol=ATOL)
    # kernel 9 on its own: the fp32 sums per expert
    np.testing.assert_allclose(
        gmm.grouped_matmul_dw(xt.detach(), dyt, ct, gw).numpy(),
        np.asarray(want_dw), rtol=RTOL, atol=ATOL)
    for gi in np.nonzero(counts == 0)[0]:
        np.testing.assert_array_equal(xt.grad[gi].numpy(), 0.0)


def test_bf16_plain_matches_jax():
    """bf16 in, bf16 out: both round one fp32 sum to bf16 (within an
    ulp, 2^-7 relative)."""
    _, jnp, jax_gmm = _jax()
    x, w, counts = _case(seed=7)
    want = jax_gmm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(
        w, jnp.bfloat16), jnp.asarray(counts))
    xt, wt, ct = _t(x, w, counts)
    got = gmm.grouped_matmul(xt.bfloat16(), wt.bfloat16(), ct)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2.0 ** -7, atol=1e-6)


def test_admission():
    """The JAX admission raises NotImplementedError; int64 counts are
    taken (cast to int32)."""
    x, w, counts = _t(*_case())
    for bad in [(x[0], w, counts), (x, w[:, :5], counts),
                (x, w[:1].expand(4, -1, -1), counts), (x, w, counts[:3]),
                (x, w, counts.float())]:
        with pytest.raises(NotImplementedError):
            gmm.grouped_matmul(*bad)
    np.testing.assert_array_equal(
        gmm.grouped_matmul(x, w, counts.long()).numpy(),
        gmm.grouped_matmul_reference(x, w, counts).numpy())


def test_dx_reads_w_through_strides(monkeypatch):
    """The gradient's dx is kernel 8's route over ``w.transpose(1, 2)``:
    the weight's own storage read through swapped strides, no copy (on
    the CPU the plain version is handed the view the kernel reads)."""
    x, w, counts = _t(*_case())
    seen = []
    plain = gmm.grouped_matmul_reference

    def spy(a, b, cnt):
        seen.append(b)
        return plain(a, b, cnt)
    monkeypatch.setattr(gmm, "grouped_matmul_reference", spy)
    x.requires_grad_(True)
    w.requires_grad_(True)
    gmm.grouped_matmul(x, w, counts).sum().backward()
    assert len(seen) == 2
    dx_w = seen[1]
    assert dx_w.data_ptr() == w.data_ptr()
    assert dx_w.shape == (3, 24, 16) and dx_w.stride() == (16 * 24, 1, 24)
    assert x.grad is not None and w.grad is not None


#: (op, groups, C, K, N, dtype, aligned) -> (route, tile, splits): the
#: MoE recipe's six calls (G 16, Gw 8, C 320), the LoRA banks' (5 rows,
#: rank 8, C 16 and 4096), and shapes only the mma kernels take
BF = torch.bfloat16
PLANS = [
    (("fwd", 16, 320, 1024, 4096, BF, True), ("wgmma", (128, 256), 1)),
    (("fwd", 16, 320, 4096, 1024, BF, True), ("wgmma", (128, 128), 1)),
    (("dx", 16, 320, 4096, 1024, BF, True), ("wgmma", (128, 128), 1)),
    (("dx", 16, 320, 1024, 4096, BF, True), ("wgmma", (128, 256), 1)),
    (("dw", 8, 320, 1024, 4096, BF, True), ("wgmma", (128, 256), 1)),
    (("dw", 8, 320, 4096, 1024, BF, True), ("wgmma", (128, 256), 1)),
    (("fwd", 5, 16, 1024, 8, BF, True), ("split", (16, 8), 4)),
    (("fwd", 5, 16, 4096, 8, BF, True), ("split", (16, 8), 8)),
    (("fwd", 5, 4096, 1024, 8, BF, True), ("split", (64, 8), 1)),
    (("dw", 5, 4096, 1024, 8, BF, True), ("split", (64, 8), 6)),
    (("dw", 5, 4096, 8, 3072, BF, True), ("split", (16, 64), 2)),
    (("dx", 5, 4096, 3072, 8, BF, True), ("split", (64, 8), 1)),
    (("fwd", 5, 16, 8, 3072, BF, True), ("mma", (64, 128), 1)),
    (("dx", 5, 16, 8, 1024, BF, True), ("mma", (64, 128), 1)),
    (("fwd", 16, 320, 1024, 4096, BF, False), ("mma", (64, 128), 1)),
    (("fwd", 5, 16, 1024, 8, BF, False), ("mma", (64, 128), 1)),
    (("fwd", 6, 37, 24, 40, BF, True), ("mma", (64, 128), 1)),
    (("fwd", 16, 320, 1024, 4096, torch.float32, True),
     ("f32", (64, 64), 1)),
]


@pytest.mark.parametrize("call,want", PLANS)
def test_plan_routes(call, want):
    """The recipe's six calls take wgmma (the 128 x 256 tile where it
    still makes 4 waves), the LoRA bank calls the split route (mma where
    the reduction is the rank, 8), unaligned or small shapes mma, fp32
    its CUDA-core kernels."""
    assert tuple(gmm.plan(*call)) == want


def test_every_admitted_shape_gets_a_route():
    """Across ragged and aligned shapes each call gets a route whose
    kernel takes it: wgmma only aligned with a 64 x 64 output, split
    only aligned with at most 16 rows or 8 columns (never a 64 x 64
    tile) and 1-8 blocks a cluster."""
    sizes = (1, 7, 8, 16, 17, 64, 100, 320, 4104)
    for op in ("fwd", "dx", "dw"):
        for c in sizes:
            for k in sizes:
                for n in sizes:
                    for aligned in (True, False):
                        route, tile, splits = gmm.plan(op, 5, c, k, n, BF,
                                                       aligned)
                        rows, cols = (k, n) if op == "dw" else (c, n)
                        assert route in gmm.ROUTES
                        if route == "wgmma":
                            assert aligned and min(rows, cols) >= 64
                            assert tile in gmm.WGMMA_TILES and splits == 1
                        elif route == "split":
                            assert aligned and (rows <= 16 or cols <= 8)
                            assert tile != (64, 64) and 1 <= splits <= 8
                        else:
                            assert route == "mma" and splits == 1


def test_plan_call_reads_layout_and_alignment():
    """The wrapper plans from the operands: N contiguous is the forward,
    the transposed view the dx route; K or N off a multiple of 8, or a
    padded row stride, take the mma kernels."""
    x = torch.zeros(16, 320, 1024, dtype=BF)
    w = torch.zeros(8, 1024, 4096, dtype=BF)
    assert gmm.plan_call(x, w).route == "wgmma"
    dy = torch.zeros(16, 320, 4096, dtype=BF)
    assert gmm.plan_call(dy, w.transpose(1, 2)).route == "wgmma"
    assert gmm.plan_call_dw(x, dy, 8).route == "wgmma"
    padded = torch.zeros(8, 1024, 4100, dtype=BF)[:, :, :4096]
    assert gmm.plan_call(x, padded).route == "mma"
    assert gmm.plan_call(x[..., :1020], w[:, :1020]).route == "mma"
    a = torch.zeros(5, 1024, 8, dtype=BF)
    assert gmm.plan_call(torch.zeros(5, 16, 1024, dtype=BF), a).route == \
        "split"
    assert gmm.plan_call_dw(torch.zeros(5, 4096, 1024, dtype=BF),
                            torch.zeros(5, 4096, 8, dtype=BF), 5).route == \
        "split"


def _c_types(decl):
    """ctypes of a C parameter list: pointers (and the stream) as
    void*, ``long long``, ``int``."""
    types = []
    for arg in decl.split(","):
        arg = " ".join(arg.split())
        if "*" in arg:
            types.append(ctypes.c_void_p)
        elif arg.startswith("long long"):
            types.append(ctypes.c_longlong)
        elif arg.startswith("int"):
            types.append(ctypes.c_int)
        else:
            raise AssertionError(f"unexpected C parameter {arg!r}")
    return types


def test_signatures_match_the_c_entry_points():
    """``build.SIGNATURES`` of kernels 8 and 9 has one ctypes type per
    parameter of their C entry points, route and cluster size
    included."""
    with open(os.path.join(build.CSRC_DIR, "grouped_matmul.cu")) as f:
        src = f.read()
    found = dict(re.findall(r'extern "C" int (pfx_\w+)\(([^)]*)\)', src))
    assert set(found) == {"pfx_grouped_matmul", "pfx_grouped_matmul_dw"}
    for name, decl in found.items():
        assert build.SIGNATURES[name] == _c_types(decl), name
    assert "int route, int tile_m, int tile_n, int splits, void* stream" \
        in " ".join(found["pfx_grouped_matmul"].split())


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    """Kernels 8 (forward and the transposed dx route) and 9 launched on
    the card, bf16 and fp32, at ragged and aligned shapes that take each
    route (wgmma, at both its tiles; split, mma, fp32), against their
    plain versions; each
    call counts one launch, under the route it planned, and gives the
    same bits when launched again. The rows past each group's count are
    non-zero in x and dy, so every row of a live group is held; K 4104
    and C 4000 split their reduction unevenly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch kernels 8 and 9")
    for (g, gw, c, k, n), dtype, tol, routes in (
            ((16, 8, 320, 256, 512), torch.bfloat16, 2e-2,
             ("wgmma", "wgmma", "wgmma")),
            ((16, 8, 320, 1024, 4096), torch.bfloat16, 2e-2,
             ("wgmma", "wgmma", "wgmma")),
            ((6, 3, 100, 200, 136), torch.bfloat16, 2e-2,
             ("wgmma", "wgmma", "wgmma")),
            ((5, 5, 16, 4104, 8), torch.bfloat16, 2e-2,
             ("split", "mma", "mma")),
            ((5, 5, 4000, 1024, 8), torch.bfloat16, 2e-2,
             ("split", "mma", "split")),
            ((6, 3, 37, 24, 40), torch.bfloat16, 2e-2,
             ("mma", "mma", "mma")),
            ((6, 3, 37, 9, 13), torch.float32, 1e-4, ("f32",) * 3)):
        x, w, counts = (t.cuda() for t in _t(*_case(g, gw, c, k, n,
                                                    seed=c, pad=True)))
        x, w = (t.to(dtype) * 0.1 for t in (x, w))
        dy = torch.randn((g, c, n), device="cuda").to(dtype)
        calls = (lambda: gmm.grouped_matmul(x, w, counts),
                 lambda: gmm.grouped_matmul_dx(dy, w, counts),
                 lambda: gmm.grouped_matmul_dw(x, dy, counts, gw))
        refs = (gmm.grouped_matmul_reference(x.float(), w, counts),
                gmm.grouped_matmul_reference(dy.float(), w.transpose(1, 2),
                                             counts),
                gmm.grouped_matmul_dw_reference(x, dy, counts, gw))
        for i, (call, ref, route) in enumerate(zip(calls, refs, routes)):
            wrapper = gmm.grouped_matmul_dw if i == 2 else gmm.grouped_matmul
            before = wrapper.launches, dict(wrapper.launches_by_route)
            got = call()
            again = call()
            torch.cuda.synchronize()
            assert wrapper.launches == before[0] + 2
            assert wrapper.launches_by_route[route] == \
                before[1][route] + 2, (g, c, k, n, i)
            assert torch.equal(got, again), (g, c, k, n, i)
            scale = float(ref.abs().max().clamp_min(1.0))
            assert float((got.float() - ref).abs().max()) <= tol * scale, \
                (g, c, k, n, i)
