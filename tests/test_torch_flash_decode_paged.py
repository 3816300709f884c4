"""Kernels 5, 6a and 6b's plain versions against the JAX decode kernels.

The JAX side goes through its dispatch with ``use_flash``, the cache
layout and (paged) a page table, in interpret mode, and each case
asserts which kernel counter fired (``attention/flash_decode_paged``,
``attention/flash_decode_paged_verify``,
``attention/flash_decode_ragged_verify``) and that the dense path did
not. The inputs hold a shuffled page table, pages shared between rows
and garbage in the null page past each row's live length. The JAX pool
is ``[P, h, d, page]`` and its cache ``[b, h, d, S]``; the port's are
``[P, h, page, d]`` and ``[b, h, S, d]``, so the tests transpose at the
comparison boundary. The port's own dispatch is checked to take the
same route under the same counter names.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_counters, rng
from paddlefleetx_tpu.ops import attention as jax_attn
from paddlefleetx_tpu_torch.observability import metrics
from paddlefleetx_tpu_torch.ops import attention as port_attn
from paddlefleetx_tpu_torch.ops.cuda import flash_attention as fa

TOL = 1e-5
H, D, PAGE, MAX_PAGES = 2, 64, 128, 2
CAP = PAGE * MAX_PAGES


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


def _offsets(window):
    return np.asarray([0, 5, 127, 128, CAP - window], np.int32)


def _paged_inputs(seed, offsets, window):
    """q ``[b, W, h, d]``, the JAX pools ``[P, h, d, page]`` and a page
    table: each row's live pages on shuffled ids, rows 0 and 1 sharing
    their first page, the null page 0 (full of garbage) past each
    row's live length."""
    r = rng(seed)
    b = len(offsets)
    live = [(int(o) + window - 1) // PAGE + 1 for o in offsets]
    pages = 1 + sum(live)
    ids = r.permutation(np.arange(1, pages))
    pt = np.zeros((b, MAX_PAGES), np.int32)
    n = 0
    for i, m in enumerate(live):
        pt[i, :m] = ids[n:n + m]
        n += m
    pt[1, 0] = pt[0, 0]
    q = r.standard_normal((b, window, H, D)).astype(np.float32)
    k = r.standard_normal((pages, H, D, PAGE)).astype(np.float32)
    v = r.standard_normal((pages, H, D, PAGE)).astype(np.float32)
    k[0] = v[0] = 30.0
    return q, k, v, pt


def _port(t):
    """A JAX ``[.., d, S]`` cache or pool -> the port's ``[.., S, d]``."""
    return torch.from_numpy(np.ascontiguousarray(t.transpose(0, 1, 3, 2)))


@pytest.mark.parametrize("window", [1, 2, 5])
def test_paged_plain_matches_jax_kernel(window, port_counters):
    offs = _offsets(window)
    q, k, v, pt = _paged_inputs(window, offs, window)
    counter = "attention/flash_decode_paged" if window == 1 else \
        "attention/flash_decode_paged_verify"
    with jax_counters() as reg:
        ref = jax_attn.dot_product_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
            query_offset=jnp.asarray(offs), use_flash=True,
            kv_cache_layout=True, page_table=jnp.asarray(pt))
        assert reg.counter(counter) == 1
        assert reg.counter("attention/dense") == 0
    args = (torch.from_numpy(q), _port(k), _port(v), torch.from_numpy(offs),
            torch.from_numpy(pt))
    if window == 1:
        got = fa.flash_decode_paged(*args)
    else:
        got = fa.flash_decode_paged_verify(*args)
        # one route per kernel: the decode wrapper takes no window
        with pytest.raises(ValueError):
            fa.flash_decode_paged(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)
    # the port's dispatch takes the same route under the same name
    got2 = port_attn.dot_product_attention(
        args[0], args[1], args[2], causal=True, query_offset=args[3],
        use_flash=True, kv_cache_layout=True, page_table=args[4])
    np.testing.assert_array_equal(got2.numpy(), got.numpy())
    assert port_counters.counter(counter) == 1
    assert port_counters.counter("attention/dense") == 0
    assert fa.flash_decode_paged.launches == 0
    assert fa.flash_decode_paged_verify.launches == 0


@pytest.mark.parametrize("window", [2, 5, 8])
def test_verify_plain_matches_jax_kernel(window, port_counters):
    """The contiguous verify window: JAX ``flash_decode_ragged`` with
    ``sq > 1`` (its ``_verify_kernel``)."""
    offs = _offsets(window)
    b = len(offs)
    r = rng(100 + window)
    q = r.standard_normal((b, window, H, D)).astype(np.float32)
    k = r.standard_normal((b, H, D, CAP)).astype(np.float32)
    v = r.standard_normal((b, H, D, CAP)).astype(np.float32)
    with jax_counters() as reg:
        ref = jax_attn.dot_product_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
            query_offset=jnp.asarray(offs), use_flash=True,
            kv_cache_layout=True)
        assert reg.counter("attention/flash_decode_ragged_verify") == 1
        assert reg.counter("attention/dense") == 0
    args = (torch.from_numpy(q), _port(k), _port(v), torch.from_numpy(offs))
    got = fa.flash_decode_verify(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)
    with pytest.raises(ValueError):
        fa.flash_decode_ragged(*args)
    got2 = port_attn.dot_product_attention(
        *args[:3], causal=True, query_offset=args[3], use_flash=True,
        kv_cache_layout=True)
    np.testing.assert_array_equal(got2.numpy(), got.numpy())
    assert port_counters.counter("attention/flash_decode_ragged_verify") == 1
    assert fa.flash_decode_verify.launches == 0
    # query j of the window is plain decode at offset off + j
    for j in range(window):
        one = fa.flash_decode_ragged(args[0][:, j:j + 1].contiguous(),
                                     args[1], args[2], args[3] + j)
        np.testing.assert_allclose(one.numpy()[:, 0], got.numpy()[:, j],
                                   atol=TOL)


def test_paged_chunk_takes_the_jax_dense_route(port_counters):
    """A page-sized prefill chunk against the pool: JAX gathers the
    pages and attends densely (``attention/fallback/kv_cache_layout`` +
    ``attention/dense``); the port takes the same route and agrees."""
    offs = np.asarray([0, 128], np.int32)
    q, k, v, pt = _paged_inputs(7, [CAP - PAGE] * 2, PAGE)
    q = q[:, :PAGE]
    with jax_counters() as reg:
        ref = jax_attn.dot_product_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
            query_offset=jnp.asarray(offs), use_flash=True,
            kv_cache_layout=True, page_table=jnp.asarray(pt))
        assert reg.counter("attention/fallback/kv_cache_layout") == 1
        assert reg.counter("attention/dense") == 1
    got = port_attn.dot_product_attention(
        torch.from_numpy(q), _port(k), _port(v), causal=True,
        query_offset=torch.from_numpy(offs), use_flash=True,
        kv_cache_layout=True, page_table=torch.from_numpy(pt))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)
    assert port_counters.counter("attention/fallback/kv_cache_layout") == 1
    assert port_counters.counter("attention/dense") == 1


def test_gather_kv_pages_matches_jax():
    q, k, v, pt = _paged_inputs(3, _offsets(1), 1)
    ref = np.asarray(jax_attn._gather_kv_pages(jnp.asarray(k),
                                               jnp.asarray(pt)))
    got = fa.gather_kv_pages(_port(k), torch.from_numpy(pt))
    np.testing.assert_array_equal(got.numpy(), ref.transpose(0, 1, 3, 2))


def test_wrappers_reject_bad_windows_and_tables():
    q = torch.zeros(2, 1, 2, 8)
    pool = torch.zeros(3, 2, 4, 8)
    pt = torch.zeros(2, 2, dtype=torch.int32)
    off = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        fa.flash_decode_paged(torch.zeros(2, 33, 2, 8), pool, pool, off, pt)
    with pytest.raises(ValueError):
        fa.flash_decode_paged(q, pool, pool, off, torch.zeros(3, 2))
    with pytest.raises(ValueError):
        fa.flash_decode_paged_verify(q, pool, pool, off, pt)
    cache = torch.zeros(2, 2, 16, 8)
    with pytest.raises(ValueError):
        fa.flash_decode_verify(q, cache, cache, off)
    with pytest.raises(ValueError):
        port_attn.dot_product_attention(q, pool, pool, query_offset=off,
                                        page_table=pt)
