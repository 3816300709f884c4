"""The gradient of the port's ``flash_attention`` (kernels 3 and 4 on the
card, their plain version ``flash_attention_backward_reference`` here)
against the JAX package's backward kernels, and against autograd.

The JAX side runs its Pallas backward in interpret mode; each case
takes the shape that makes ``_flash_backward`` pick one of its three
regimes: ``_bwd_combined_kernel`` (one q block), the split pair
``_bwd_dkv_kernel`` + ``_bwd_dq_kernel`` (several q blocks and a bias)
and ``_bwd_fused_kernel`` (several q blocks, no bias, no dropout). The
port reaches its plain backward through ``torch.autograd`` of
``flash_attention``, as training does. Tolerance: 2e-5 abs on fp32
inputs (both sides sum in fp32, in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rng
from paddlefleetx_tpu.ops.pallas import flash_attention as jax_fa
from paddlefleetx_tpu_torch.ops.cuda import flash_attention as fa
from paddlefleetx_tpu_torch.ops.cuda import philox

TOL = 2e-5


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("PFX_PALLAS_INTERPRET", "1")


def _inputs(seed, b, s, h, d=64):
    r = rng(seed)
    return [r.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(4)]


def _port_grads(q, k, v, g_out, causal, bias=None, g_lse=None,
                rate=0.0, seed=None, dtype=torch.float32):
    t = [torch.tensor(x, dtype=dtype, requires_grad=True)
         for x in (q, k, v)]
    out, lse = fa.flash_attention(
        *t, causal=causal,
        bias=None if bias is None else torch.tensor(bias, dtype=dtype),
        dropout_rate=rate, seed=seed)
    loss = (out * torch.tensor(g_out, dtype=dtype)).sum()
    if g_lse is not None:
        loss = loss + (lse * torch.tensor(g_lse, dtype=dtype)).sum()
    return torch.autograd.grad(loss, t)


# (s, block, bias): the regime _flash_backward picks for it
REGIMES = {
    "combined": (128, None, False),   # num_q == 1 -> _bwd_combined_kernel
    "split": (256, 128, True),        # bias -> _bwd_dkv + _bwd_dq
    "fused": (1024, 512, False),      # num_q 2, no bias -> _bwd_fused
}


@pytest.mark.parametrize("regime,causal", [
    ("combined", True), ("combined", False), ("split", True),
    ("split", False), ("fused", True), ("fused", False)])
def test_backward_matches_each_jax_regime(regime, causal):
    s, block, with_bias = REGIMES[regime]
    b, h = (2, 2) if s < 1024 else (1, 1)
    q, k, v, g_out = _inputs(s + int(causal), b, s, h)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    if with_bias:
        pads = rng(s).integers(0, 9, size=b)
        bias = np.where(np.arange(s)[None, :] >= pads[:, None], 0.0,
                        -1e9).astype(np.float32)[:, None, None, :]
        _, vjp = jax.vjp(lambda a, bb, c: jax_fa.flash_attention(
            a, bb, c, causal=causal, block_q=block, block_kv=block,
            bias=jnp.asarray(bias)), jq, jk, jv)
        want = vjp(jnp.asarray(g_out))
        got = _port_grads(q, k, v, g_out, causal, bias=bias)
    else:
        g_lse = rng(s + 7).standard_normal((b, h, s)).astype(np.float32)
        _, vjp = jax.vjp(lambda a, bb, c: jax_fa.flash_attention_with_lse(
            a, bb, c, causal=causal, block_q=block, block_kv=block),
            jq, jk, jv)
        want = vjp((jnp.asarray(g_out), jnp.asarray(g_lse)))
        got = _port_grads(q, k, v, g_out, causal, g_lse=g_lse)
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=TOL,
                                   err_msg=f"d{name} ({regime})")


def test_regime_shapes_pick_the_intended_jax_kernels():
    """The shapes above do reach the three JAX regimes: one q block for
    s=128 at the default blocks, several for the other two, and the
    fused kernel takes s=1024 at 512 blocks."""
    assert jax_fa.check_shapes(128, 128, 64) == (128, 128)
    assert jax_fa.check_shapes(256, 256, 64, 128, 128) == (128, 128)
    z = jnp.zeros((1, 1024, 64), jnp.float32)
    r = jnp.zeros((1, 1024, 1), jnp.float32)
    assert jax_fa._flash_backward_fused(z, z, z, z, r, r, 1.0, True,
                                        0) is not None


@pytest.mark.parametrize("causal,with_bias", [(True, False), (True, True),
                                              (False, True)])
def test_backward_with_dropout_equals_autograd_in_fp64(causal, with_bias):
    """The explicit-formula backward equals autograd of the plain forward
    in fp64, with dropout 0.1 and the same Philox mask, and with a
    nonzero lse cotangent (1e-10)."""
    b, s, h, d = 2, 37, 2, 16
    r = rng(3)
    q, k, v, g_out = (r.standard_normal((b, s, h, d)) for _ in range(4))
    g_lse = r.standard_normal((b, h, s))
    bias = r.standard_normal((b, 1, 1, s)) if with_bias else None
    t = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    bt = None if bias is None else torch.tensor(bias)
    out, lse = fa.flash_attention_reference(*t, causal, bt, 0.1, 99)
    loss = (out * torch.tensor(g_out)).sum() + \
        (lse * torch.tensor(g_lse)).sum()
    want = torch.autograd.grad(loss, t)
    got = _port_grads(q, k, v, g_out, causal, bias=bias, g_lse=g_lse,
                      rate=0.1, seed=99, dtype=torch.float64)
    for a, w in zip(got, want):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=1e-10)


def test_backward_counts_no_launch_on_cpu_and_rejects_bad_inputs():
    q = torch.zeros(1, 8, 2, 64)
    before = (fa.flash_attention_backward.launches_dkv,
              fa.flash_attention_backward.launches_dq)
    o, lse = fa.flash_attention(q, q, q)
    fa.flash_attention_backward(q, q, q, o, lse, q)
    assert (fa.flash_attention_backward.launches_dkv,
            fa.flash_attention_backward.launches_dq) == before
    with pytest.raises(ValueError):
        fa.flash_attention_backward(q, q, q, o, lse, q, dropout_rate=0.1)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q, dropout_rate=1.0, seed=1)
    assert philox.keep_threshold(0.1) == round(0.9 * 2 ** 32)
