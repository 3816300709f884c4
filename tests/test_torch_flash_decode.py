"""Kernel 2's plain version against the JAX decode kernel.

The JAX side goes through its dispatch with ``use_flash`` and the cache
layout, in interpret mode, and each case asserts that the kernel
counter (``attention/flash_decode`` for a shared offset plus bias,
``attention/flash_decode_ragged`` for per-row offsets) fired and the
dense path did not. The JAX cache is ``[b, h, d, S]``; the port's is
``[b, h, S, d]``, so the tests transpose at the comparison boundary.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_counters, rng
from paddlefleetx_tpu.ops import attention as jax_attn
from paddlefleetx_tpu_torch.ops import attention as port_attn
from paddlefleetx_tpu_torch.ops.cuda import flash_attention as fa

TOL = 1e-5
S = 256
OFFSETS = [0, 1, 127, 128, S - 1]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("PFX_PALLAS_INTERPRET", "1")


def _inputs(seed, b, h, d):
    r = rng(seed)
    q = r.standard_normal((b, 1, h, d)).astype(np.float32)
    k = r.standard_normal((b, h, d, S)).astype(np.float32)   # TPU layout
    v = r.standard_normal((b, h, d, S)).astype(np.float32)
    return q, k, v


def _port(t):
    """TPU cache [b, h, d, S] -> the port's [b, h, S, d]."""
    return torch.from_numpy(np.ascontiguousarray(t.transpose(0, 1, 3, 2)))


@pytest.mark.parametrize("d", [8, 64])
def test_ragged_offsets_match_jax_kernel(d):
    b, h = len(OFFSETS), 2
    q, k, v = _inputs(d, b, h, d)
    offs = np.asarray(OFFSETS, np.int32)
    with jax_counters() as reg:
        ref = jax_attn.dot_product_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
            query_offset=jnp.asarray(offs), use_flash=True,
            kv_cache_layout=True)
        assert reg.counter("attention/flash_decode_ragged") == 1
        assert reg.counter("attention/dense") == 0
    got = fa.flash_decode_ragged(torch.from_numpy(q), _port(k), _port(v),
                                 torch.from_numpy(offs))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)
    # the port's dispatch takes the same route
    got2 = port_attn.dot_product_attention(
        torch.from_numpy(q), _port(k), _port(v), causal=True,
        query_offset=torch.from_numpy(offs), use_flash=True,
        kv_cache_layout=True)
    np.testing.assert_array_equal(got2.numpy(), got.numpy())


@pytest.mark.parametrize("d", [8, 64])
@pytest.mark.parametrize("offset", OFFSETS)
def test_shared_offset_with_bias_matches_jax_kernel(d, offset):
    b, h = 3, 2
    q, k, v = _inputs(1000 + offset + d, b, h, d)
    # the lockstep generate() left-pad bias: invalid keys -1e9
    pads = np.asarray([0, 3, min(offset, 9)])
    valid = (np.arange(S)[None, :] >= pads[:, None]) & \
        (np.arange(S)[None, :] <= offset)
    bias = np.where(valid, 0.0, -1e9).astype(np.float32)[:, None, None, :]
    with jax_counters() as reg:
        ref = jax_attn.dot_product_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            bias=jnp.asarray(bias), causal=True, query_offset=offset,
            use_flash=True, kv_cache_layout=True)
        assert reg.counter("attention/flash_decode") == 1
        assert reg.counter("attention/dense") == 0
    got = fa.flash_decode(torch.from_numpy(q), _port(k), _port(v), offset,
                          torch.from_numpy(bias))
    # a row whose every live key is a pad averages pad values on both
    # sides; compare the rows with a real key
    real = valid.any(axis=1)
    np.testing.assert_allclose(got.numpy()[real], np.asarray(ref)[real],
                               atol=TOL)


def test_plain_version_equals_dense_path():
    """The port's dense path (``use_flash=False``) reads the same cache
    the same way."""
    b, h, d = 4, 2, 16
    q, k, v = _inputs(5, b, h, d)
    offs = torch.tensor([3, 0, 255, 77], dtype=torch.int32)
    plain = fa.flash_decode_reference(torch.from_numpy(q), _port(k),
                                      _port(v), offs)
    dense = port_attn.dot_product_attention(
        torch.from_numpy(q), _port(k), _port(v), query_offset=offs,
        use_flash=False, kv_cache_layout=True)
    np.testing.assert_allclose(plain.numpy(), dense.numpy(), atol=TOL)
    assert fa.flash_decode.launches == 0


def test_wrappers_reject_bad_inputs():
    q = torch.zeros(2, 1, 2, 8)
    cache = torch.zeros(2, 2, 16, 8)
    with pytest.raises(ValueError):
        fa.flash_decode(torch.zeros(2, 2, 2, 8), cache, cache, 3)
    with pytest.raises(ValueError):
        fa.flash_decode_ragged(q, torch.zeros(2, 3, 16, 8),
                               torch.zeros(2, 3, 16, 8),
                               torch.zeros(2, dtype=torch.int32))
    with pytest.raises(NotImplementedError):
        port_attn.dot_product_attention(
            torch.zeros(2, 3, 2, 8), cache, cache, query_offset=2,
            kv_cache_layout=True)
