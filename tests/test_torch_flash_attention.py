"""Kernel 1's plain version against the JAX flash forward kernel.

On the CPU the port's ``flash_attention`` wrapper runs its plain
version (``flash_attention_reference``); the JAX side runs the Pallas
``_fwd_kernel`` in interpret mode. Causal cases also go through the
JAX dispatch and assert that ``attention/flash`` fired, so the
reference is the kernel and not the dense fallback; non-causal cases at
these lengths would be sent to the dense path by the JAX dispatch
(``short_noncausal``), so they call the kernel's public wrapper
directly, which either runs the kernel or raises. The JAX kernel needs
128-multiple lengths; the port's takes any length.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_counters, rng
from paddlefleetx_tpu.ops import attention as jax_attn
from paddlefleetx_tpu.ops.pallas import flash_attention as jax_fa
from paddlefleetx_tpu_torch.ops import attention as port_attn
from paddlefleetx_tpu_torch.ops.cuda import flash_attention as fa

TOL = 1e-5


def _qkv(seed, b=2, s=128, h=2, d=64):
    r = rng(seed)
    return [r.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


def _pad_bias(seed, b, s):
    """A [b, 1, 1, s] left-pad mask: the first few keys of each row
    dropped with the generation path's -1e9."""
    pads = rng(seed).integers(0, 9, size=b)
    valid = np.arange(s)[None, :] >= pads[:, None]
    return np.where(valid, 0.0, -1e9).astype(np.float32)[:, None, None, :]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("PFX_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("s", [128, 256])
def test_causal_matches_jax_kernel(s):
    q, k, v = _qkv(s, s=s)
    o_ref, lse_ref = jax_fa.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    o, lse = fa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                causal=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=TOL)
    with jax_counters() as reg:
        o_disp = jax_attn.dot_product_attention(
            *map(jnp.asarray, (q, k, v)), causal=True, use_flash=True)
        assert reg.counter("attention/flash") == 1
        assert reg.counter("attention/dense") == 0
    np.testing.assert_allclose(o.numpy(), np.asarray(o_disp), atol=TOL)


@pytest.mark.parametrize("s", [128, 256])
def test_non_causal_matches_jax_kernel(s):
    q, k, v = _qkv(s + 1, s=s)
    o_ref, lse_ref = jax_fa.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False)
    o, lse = fa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                causal=False)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=TOL)


@pytest.mark.parametrize("s", [128, 256])
def test_pad_bias_matches_jax_kernel(s):
    q, k, v = _qkv(s + 2, s=s)
    bias = _pad_bias(s, 2, s)
    with jax_counters() as reg:
        o_ref = jax_attn.dot_product_attention(
            *map(jnp.asarray, (q, k, v)), bias=jnp.asarray(bias),
            causal=True, use_flash=True)
        assert reg.counter("attention/flash") == 1
        assert reg.counter("attention/dense") == 0
    o, _ = fa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=True, bias=torch.from_numpy(bias))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=TOL)


def test_prompt_prefill_equals_jax_dense_cached_prefill():
    """The port's prefill attends over the prompt's fresh q/k/v; the
    JAX package attends (dense) over the whole cache capacity with the
    pad bias. With query offset 0 every key past the prompt is causally
    masked, so the two agree whatever the unwritten cache holds."""
    b, s, h, d, cap = 2, 37, 2, 64, 128
    q, k, v = _qkv(7, b=b, s=s)
    r = rng(8)
    # [b, h, d, cap] TPU cache: the prompt's keys, then garbage
    k_cache = r.standard_normal((b, h, d, cap)).astype(np.float32)
    v_cache = r.standard_normal((b, h, d, cap)).astype(np.float32)
    k_cache[..., :s] = k.transpose(0, 2, 3, 1)
    v_cache[..., :s] = v.transpose(0, 2, 3, 1)
    bias = _pad_bias(9, b, cap)
    with jax_counters() as reg:
        o_ref = jax_attn.dot_product_attention(
            jnp.asarray(q), jnp.asarray(k_cache), jnp.asarray(v_cache),
            bias=jnp.asarray(bias), causal=True, query_offset=0,
            use_flash=True, kv_cache_layout=True)
        assert reg.counter("attention/fallback/kv_cache_layout") == 1
        assert reg.counter("attention/dense") == 1
    o, _ = fa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=True,
                              bias=torch.from_numpy(bias[..., :s]))
    # pad query rows attend to nothing real on either side; compare the
    # rows whose own key is live
    live = bias[:, 0, 0, :s] == 0                       # [b, s]
    np.testing.assert_allclose(o.numpy()[live], np.asarray(o_ref)[live],
                               atol=TOL)


def test_any_length_and_broadcast_bias_shapes():
    """The port's kernel contract takes ragged lengths (prefill buckets
    are not 128-multiples) and every broadcastable bias form; the plain
    version equals the port's dense path there."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(11, b=3, s=37, h=2))
    full = torch.from_numpy(rng(12).standard_normal(
        (3, 2, 37, 37)).astype(np.float32))
    for bias in (None, full[:, :1, :1], full[:1, :, :1], full):
        o, lse = fa.flash_attention(q, k, v, causal=True, bias=bias)
        dense = port_attn.dense_attention(q, k, v, bias, causal=True)
        np.testing.assert_allclose(o.numpy(), dense.numpy(), atol=TOL)
        assert lse.shape == (3, 2, 37)
    assert fa.flash_attention.launches == 0   # the CPU never launches


def test_wrapper_rejects_bad_shapes():
    q = torch.zeros(2, 8, 2, 64)
    with pytest.raises(ValueError):
        fa.flash_attention(q, torch.zeros(2, 8, 3, 64),
                           torch.zeros(2, 8, 3, 64))
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q, bias=torch.zeros(2, 1, 8))
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q, bias=torch.zeros(2, 1, 1, 9))


def test_dispatch_counts_and_refuses_offsets():
    from paddlefleetx_tpu_torch.observability import metrics
    q = torch.zeros(1, 4, 2, 64)
    metrics.set_enabled(True)
    reg = metrics.get_registry()
    reg.reset()
    try:
        port_attn.dot_product_attention(q, q, q, use_flash=True)
        port_attn.dot_product_attention(q, q, q, use_flash=False)
        assert reg.counter("attention/flash") == 1
        assert reg.counter("attention/fallback/flash_disabled") == 1
        assert reg.counter("attention/dense") == 1
        with pytest.raises(NotImplementedError):
            port_attn.dot_product_attention(q, q, q, query_offset=3)
    finally:
        reg.reset()
        metrics.set_enabled(False)
