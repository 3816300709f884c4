"""Kernel 7 (the weight-only int8 matmul) and ``quant_execution`` against
the JAX package: the plain version against the JAX Pallas kernel in
interpret mode, the wrapper's CPU route, its gradient (the dx route's
plain version against ``jax.vjp`` through the JAX kernel, nothing for
the weight and scales) and its admission, and a quantized model's
logits against the JAX quantized
model on the same quantized weights, every dense site through the
kernel on both sides (the port of ``tests/test_quantized_matmul.py``'s
end-to-end and fallback cases). The launch itself needs the card: its
test is marked ``cuda`` and skips here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import build_quant_pair, jax_counters, rng
from paddlefleetx_tpu.ops.pallas.quantized_matmul import (
    quantized_matmul as jax_qmm,
)
from paddlefleetx_tpu_torch.observability import metrics
from paddlefleetx_tpu_torch.ops.cuda import quantized_matmul as qmm

#: the JAX kernel test's tolerances (fp32: the same products summed in
#: another order)
RTOL, ATOL = 1e-5, 1e-4
#: bf16 out: both sides round one fp32 sum of exact products to bf16;
#: the sums differ in order only, so the outputs are within a bf16 ulp
BF16_RTOL = 2.0 ** -7
#: quantized model logits, fp32, as the port's other model parity tests
LOGIT_ATOL = 1e-4
SHAPES = [(8, 128, 128), (16, 256, 384), (24, 128, 256)]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("PFX_PALLAS_INTERPRET", "1")


@pytest.fixture
def port_counters():
    reg = metrics.get_registry()
    metrics.set_enabled(True)
    reg.reset()
    yield reg
    reg.reset()
    metrics.set_enabled(False)


def _inputs(m, k, n, seed):
    """``x [M, K]`` fp32, the JAX ``[K, N]`` int8 weight, fp32 scales."""
    r = rng(seed)
    return (r.standard_normal((m, k)).astype(np.float32),
            r.integers(-127, 128, (k, n)).astype(np.int8),
            r.uniform(0.001, 0.02, (n,)).astype(np.float32))


def _port(x, w, s, dtype=torch.float32):
    """The port's operands: x in ``dtype``, the weight ``[N, K]``."""
    return (torch.from_numpy(x).to(dtype),
            torch.from_numpy(np.ascontiguousarray(w.T)), torch.from_numpy(s))


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_matches_jax_kernel_fp32(m, k, n):
    x, w, s = _inputs(m, k, n, m)
    ref = jax_qmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s))
    got = qmm.quantized_matmul(*_port(x, w, s))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    assert qmm.quantized_matmul.launches == 0    # the CPU ran the plain one


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_matches_jax_kernel_bf16(m, k, n):
    x, w, s = _inputs(m, k, n, 100 + m)
    ref = jax_qmm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                  jnp.asarray(s))
    got = qmm.quantized_matmul(*_port(x, w, s, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=BF16_RTOL, atol=1e-6)


def test_wrapper_route_admission_and_gradient():
    """On CPU tensors the wrapper is the plain version; it refuses
    operands that are not ``[M, K]``, int8 ``[N, K]``, ``[N]``; the
    kernel admits K and N multiples of 128 and any M; a backward
    through it gives x the dx route's plain version of the scaled,
    rounded gradient, on the CPU, and counts no launch."""
    x, w, s = _port(*_inputs(5, 256, 128, 9))
    np.testing.assert_array_equal(
        qmm.quantized_matmul(x, w, s).numpy(),
        qmm.quantized_matmul_reference(x, w, s).numpy())
    for bad in [(x[0], w, s), (x[:, :128], w, s), (x, w.float(), s),
                (x, w, s[:64])]:
        with pytest.raises(ValueError):
            qmm.quantized_matmul(*bad)
    assert qmm.admits(128, 384) and qmm.admits(4096, 1024)
    assert not qmm.admits(32, 128) and not qmm.admits(128, 96)
    x.requires_grad_(True)
    out = qmm.quantized_matmul(x, w, s)
    g = torch.from_numpy(rng(10).standard_normal(out.shape).astype(
        np.float32))
    out.backward(g)
    np.testing.assert_array_equal(
        x.grad.numpy(),
        qmm.quantized_matmul_dx_reference(g * s, w).numpy())
    assert qmm.quantized_matmul.dx_launches == 0
    with pytest.raises(ValueError):
        qmm.quantized_matmul_dx(g, w.float())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_dx_route_matches_jax_vjp(m, k, n, dtype):
    """The port's dx through the autograd of :func:`quantized_matmul`
    (the dx route's plain version on the CPU) equals ``jax.vjp``
    through the JAX kernel in interpret mode (``_quantized_matmul_bwd``:
    the cotangent scaled and rounded to its dtype, then the kernel over
    the transposed weight): fp32 within the kernel test's tolerances,
    bf16 within one bf16 ulp. The int8 weight and the scales get no
    gradient (JAX: a float0 and zeros)."""
    x, w, s = _inputs(m, k, n, 200 + m)
    g = rng(300 + m).standard_normal((m, n)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    out, vjp = jax.vjp(lambda a, sc: jax_qmm(a, jnp.asarray(w), sc),
                       jnp.asarray(x, jdt), jnp.asarray(s))
    ref, ref_ds = vjp(jnp.asarray(g, jdt))
    np.testing.assert_array_equal(np.asarray(ref_ds), 0.0)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    px, pw, ps = _port(x, w, s, tdt)
    px.requires_grad_(True)
    ps.requires_grad_(True)
    qmm.quantized_matmul(px, pw, ps).backward(torch.from_numpy(g).to(tdt))
    assert px.grad.dtype == tdt and ps.grad is None
    if dtype == "float32":
        np.testing.assert_allclose(px.grad.numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(px.grad.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   rtol=BF16_RTOL, atol=1e-6)


@pytest.mark.cuda
def test_kernel_launch_matches_plain_on_the_card():
    """Kernel 7 launched on the card at a decode shape and a ragged M,
    bf16 and fp32, against its plain version; each call counts one
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch kernel 7")
    for m, dtype, tol in ((16, torch.bfloat16, 2e-2), (37, torch.float32,
                                                        1e-4)):
        x, w, s = (t.cuda() for t in _port(*_inputs(m, 1024, 3072, m),
                                           dtype))
        before = qmm.quantized_matmul.launches
        got = qmm.quantized_matmul(x, w, s)
        torch.cuda.synchronize()
        assert qmm.quantized_matmul.launches == before + 1
        ref = qmm.quantized_matmul_reference(x.float(), w, s)
        assert float((got.float() - ref).abs().max()) <= tol


@pytest.mark.cuda
def test_dx_kernel_matches_plain_on_the_card():
    """Kernel 7's dx route launched on the card at the fc1 and fc2
    sites (tiles of opposite aspect), a ragged M, bf16 and fp32, against
    its plain version; each call counts one dx launch and no forward
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch kernel 7's dx route")
    for m, k, n, dtype, tol in ((16, 1024, 4096, torch.bfloat16, 2e-2),
                                (37, 4096, 1024, torch.bfloat16, 2e-2),
                                (37, 1024, 3072, torch.float32, 1e-4)):
        _, w, s = _port(*_inputs(m, k, n, m))
        g = torch.randn((m, n), device="cuda") * 0.01
        gs = (g * s.cuda()).to(dtype)
        w = w.cuda()
        before = (qmm.quantized_matmul.launches,
                  qmm.quantized_matmul.dx_launches)
        got = qmm.quantized_matmul_dx(gs, w)
        torch.cuda.synchronize()
        assert (qmm.quantized_matmul.launches,
                qmm.quantized_matmul.dx_launches) == (before[0],
                                                      before[1] + 1)
        ref = qmm.quantized_matmul_dx_reference(gs.float(), w)
        assert got.shape == (m, k) and got.dtype == dtype
        assert float((got.float() - ref).abs().max()) <= tol


def test_quant_model_logits_match_jax(port_counters):
    """The port of ``test_gpt_quant_execution_end_to_end``: the JAX
    quantized GPT and the port's on the same quantized weights give the
    same fp32 logits; every dense site (4 a layer) ran the int8 matmul
    on both sides, none fell back."""
    jmodel, qparams, model = build_quant_pair(seed=2)
    ids = rng(7).integers(0, 96, (2, 8)).astype(np.int32)
    with jax_counters() as reg:
        ref = jmodel.apply({"params": qparams}, jnp.asarray(ids))
        assert reg.counter("quant/matmul") == 4 * 2
        assert reg.counter("quant/fallback/kernel_rejected") == 0
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=LOGIT_ATOL)
    assert port_counters.counter("quant/matmul") == 4 * 2
    assert port_counters.counter("quant/fallback/kernel_rejected") == 0


def test_quant_fallback_on_small_hidden(port_counters):
    """The port of ``test_gpt_quant_fallback_on_small_hidden``: at hidden
    32 no site passes the K / N admission, so every site takes the JAX
    package's dequantize-then-matmul route on both sides (counted), with
    equal logits."""
    jmodel, qparams, model = build_quant_pair(
        seed=3, hidden_size=32, num_attention_heads=2, ffn_hidden_size=128,
        use_flash_attention=False)
    ids = rng(8).integers(0, 96, (1, 4)).astype(np.int32)
    with jax_counters() as reg:
        ref = jmodel.apply({"params": qparams}, jnp.asarray(ids))
        assert reg.counter("quant/fallback/kernel_rejected") == 4 * 2
        assert reg.counter("quant/matmul") == 0
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=LOGIT_ATOL)
    assert port_counters.counter("quant/fallback/kernel_rejected") == 4 * 2
    assert port_counters.counter("quant/matmul") == 0
