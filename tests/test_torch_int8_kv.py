"""The int8 KV cache (``kv_cache_dtype: int8``) against the JAX package,
at the kernel level: ``quantize_kv`` against ``_quantize_kv``; the int8
plain versions of kernels 2, 5, 6a and 6b against the JAX decode
kernels' ``quantized`` branch in interpret mode (the JAX
``attention/*_int8`` counter fired, the port's dispatch takes the same
route under the same name); the dense route widening the cache up
front; the cache layouts and the page copy. The model and its servers
are held in ``test_torch_int8_kv_serving.py``. The JAX cache is ``[b,
h, d, S]`` with ``[b, h, 1, S]`` scales (pool ``[P, h, d, page]`` /
``[P, h, 1, page]``); the port's ``[b, h, S, d]`` / ``[b, h, S]``, so
the tests transpose at the comparison."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    CPU, jax_counters, rng, tiny_kwargs,
)
from paddlefleetx_tpu.models.gpt.model import _quantize_kv
from paddlefleetx_tpu.ops import attention as jax_attn
from paddlefleetx_tpu_torch.models.gpt import generation as gen
from paddlefleetx_tpu_torch.models.gpt.model import (
    init_kv_cache, init_kv_pool, quantize_kv,
)
from paddlefleetx_tpu_torch.observability import metrics
from paddlefleetx_tpu_torch.ops import attention as port_attn
from paddlefleetx_tpu_torch.ops.cuda import flash_attention as fa

TOL = 1e-5
#: fp32 logits, as the port's other model parity tests
LOGIT_ATOL = 1e-4
H, D, PAGE, MAX_PAGES = 2, 64, 128, 2
CAP = PAGE * MAX_PAGES
EOS = PAD = 95
PROMPTS = [[5, 9, 2, 7, 1], [11, 3], [4, 4, 8, 1, 2, 6, 9],
           [13, 2, 2], [1], [7, 8]]
MAX_DEC = 8


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


def test_quantize_kv_matches_jax():
    """Per-(row, token, head) abs-max int8: the same values and scales
    bit for bit, an all-zero row included (scale 1e-8, zeros back)."""
    x = rng(1).standard_normal((3, 5, H, D)).astype(np.float32) * 3.0
    x[0, 1, 0] = 0.0
    x[1, 2, 1, :4] = [127.0, -63.5, 0.5, -0.5]
    q, s = quantize_kv(torch.from_numpy(x))
    jq, js = _quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js)[..., 0])
    assert not q[0, 1, 0].any() and float(s[0, 1, 0]) == pytest.approx(1e-8)


def _int8(shape, seed, garbage_page=False):
    """A JAX-layout int8 cache / pool ``[.., h, d, S]`` and its ``[.., h,
    1, S]`` scales, quantized from seeded normals (page 0 garbage)."""
    f = rng(seed).standard_normal(shape).astype(np.float32)
    if garbage_page:
        f[0] = 30.0
    q, s = _quantize_kv(jnp.asarray(f.transpose(0, 1, 3, 2)))  # over d
    return (np.asarray(q).transpose(0, 1, 3, 2),
            np.asarray(s).transpose(0, 1, 3, 2))


def _port_cache(q, s):
    """JAX ``[.., h, d, S]`` int8 + ``[.., h, 1, S]`` scales -> the port's
    ``[.., h, S, d]`` + ``[.., h, S]``."""
    return (torch.from_numpy(np.array(q.transpose(0, 1, 3, 2), order="C")),
            torch.from_numpy(np.array(s[:, :, 0], order="C")))


def _page_table(offsets, window, seed):
    r = rng(seed)
    live = [(int(o) + window - 1) // PAGE + 1 for o in offsets]
    pages = 1 + sum(live)
    ids = r.permutation(np.arange(1, pages))
    pt = np.zeros((len(offsets), MAX_PAGES), np.int32)
    n = 0
    for i, m in enumerate(live):
        pt[i, :m] = ids[n:n + m]
        n += m
    pt[1, 0] = pt[0, 0]
    return pt, pages


#: (case, window, paged, shared offset + bias, JAX / port counter)
CASES = [
    ("decode_shared_bias", 1, False, True, "attention/flash_decode_int8"),
    ("decode_ragged", 1, False, False,
     "attention/flash_decode_ragged_int8"),
    ("verify", 5, False, False,
     "attention/flash_decode_ragged_verify_int8"),
    ("paged", 1, True, False, "attention/flash_decode_paged_int8"),
    ("paged_verify", 3, True, False,
     "attention/flash_decode_paged_verify_int8"),
]


@pytest.mark.parametrize("name,window,paged,shared,counter", CASES,
                         ids=[c[0] for c in CASES])
def test_int8_plain_matches_jax_kernel(name, window, paged, shared,
                                       counter, port_counters):
    offs = np.asarray([0, 5, 127, 128, CAP - window], np.int32)
    b = len(offs)
    seed = 10 + len(name)
    q = rng(seed).standard_normal((b, window, H, D)).astype(np.float32)
    kw, pkw = {}, {}
    if paged:
        pt, pages = _page_table(offs, window, seed)
        (k, ks), (v, vs) = (_int8((pages, H, D, PAGE), seed + i, True)
                            for i in (1, 2))
        kw["page_table"] = jnp.asarray(pt)
        pkw["page_table"] = torch.from_numpy(pt)
    else:
        (k, ks), (v, vs) = (_int8((b, H, D, CAP), seed + i) for i in (1, 2))
    if shared:
        pad = np.asarray([0, 3, 1, 0, 7])
        bias = np.where(np.arange(CAP)[None] < pad[:, None], -1e9,
                        0.0).astype(np.float32)[:, None, None, :]
        off_j, off_p = jnp.asarray(int(offs.max()), jnp.int32), \
            int(offs.max())
        kw["bias"], pkw["bias"] = jnp.asarray(bias), torch.from_numpy(bias)
    else:
        off_j, off_p = jnp.asarray(offs), torch.from_numpy(offs)
    with jax_counters() as reg:
        ref = jax_attn.dot_product_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
            query_offset=off_j, use_flash=True, kv_cache_layout=True,
            k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), **kw)
        assert reg.counter(counter) == 1
        assert reg.counter("attention/dense") == 0
    (pk, pks), (pv, pvs) = _port_cache(k, ks), _port_cache(v, vs)
    got = port_attn.dot_product_attention(
        torch.from_numpy(q), pk, pv, causal=True, query_offset=off_p,
        use_flash=True, kv_cache_layout=True, k_scale=pks, v_scale=pvs,
        **pkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)
    assert port_counters.counter(counter) == 1
    assert port_counters.counter("attention/dense") == 0
    for wrapper in (fa.flash_decode, fa.flash_decode_verify,
                    fa.flash_decode_paged, fa.flash_decode_paged_verify):
        assert wrapper.launches == wrapper.launches_int8 == 0


def test_int8_dense_route_widens_up_front(port_counters):
    """``use_flash=False`` and a paged prefill chunk: the cache (the
    gathered pages and scale pages) widened to q's dtype, then dense
    attention, as the JAX dense route does."""
    offs = np.asarray([0, 5, 200], np.int32)
    q = rng(3).standard_normal((3, 1, H, D)).astype(np.float32)
    (k, ks), (v, vs) = (_int8((3, H, D, CAP), i) for i in (4, 5))
    ref = jax_attn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        query_offset=jnp.asarray(offs), use_flash=False,
        kv_cache_layout=True, k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs))
    (pk, pks), (pv, pvs) = _port_cache(k, ks), _port_cache(v, vs)
    got = port_attn.dot_product_attention(
        torch.from_numpy(q), pk, pv, causal=True,
        query_offset=torch.from_numpy(offs), use_flash=False,
        kv_cache_layout=True, k_scale=pks, v_scale=pvs)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)
    assert port_counters.counter("attention/dense") == 1
    with pytest.raises(ValueError, match="together"):
        port_attn.dot_product_attention(
            torch.from_numpy(q), pk, pv, kv_cache_layout=True, k_scale=pks)
    with pytest.raises(ValueError, match="int8"):
        fa.flash_decode_ragged(torch.from_numpy(q), pk.float(), pv.float(),
                               torch.from_numpy(offs), k_scale=pks,
                               v_scale=pvs)
    # a page-sized chunk against the int8 pool: the gather + dense route
    start = np.asarray([PAGE, PAGE], np.int32)
    pt, pages = _page_table([CAP - PAGE] * 2, PAGE, 6)
    (k, ks), (v, vs) = (_int8((pages, H, D, PAGE), i, True) for i in (7, 8))
    qc = rng(9).standard_normal((2, PAGE, H, D)).astype(np.float32)
    ref = jax_attn.dot_product_attention(
        jnp.asarray(qc), jnp.asarray(k), jnp.asarray(v), causal=True,
        query_offset=jnp.asarray(start), use_flash=True,
        kv_cache_layout=True, page_table=jnp.asarray(pt),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    (pk, pks), (pv, pvs) = _port_cache(k, ks), _port_cache(v, vs)
    got = port_attn.dot_product_attention(
        torch.from_numpy(qc), pk, pv, causal=True,
        query_offset=torch.from_numpy(start), use_flash=True,
        kv_cache_layout=True, page_table=torch.from_numpy(pt),
        k_scale=pks, v_scale=pvs)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)
    assert port_counters.counter("attention/fallback/kv_cache_layout") == 1


def test_int8_cache_layouts_and_page_copy():
    """The int8 cache and pool: int8 values and fp32 scales, ``[b, h,
    S]`` / ``[P, h, page]`` (the JAX ``[b, h, 1, S]`` / ``[P, h, 1,
    page]`` minus the dummy axis); a page copy moves values and
    scales."""
    from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
    cfg = GPTConfig(**tiny_kwargs(kv_cache_dtype="int8", kv_page_size=128,
                                  kv_pool_pages=4))
    cache = init_kv_cache(cfg, 3, CPU)
    pool = init_kv_pool(cfg, CPU)
    assert len(cache) == len(pool) == cfg.num_layers
    k, v, ks, vs = cache[0]
    assert k.shape == v.shape == (3, H, 128, D) and k.dtype == torch.int8
    assert ks.shape == vs.shape == (3, H, 128) and ks.dtype == torch.float32
    k, v, ks, vs = pool[0]
    assert k.shape == (4, H, 128, D) and ks.shape == (4, H, 128)
    for layer in pool:
        for t in layer:
            t[1] = torch.arange(t[1].numel()).reshape(t[1].shape).to(t.dtype)
    gen.copy_kv_pages(pool, [1], [3])
    for layer in pool:
        for t in layer:
            assert torch.equal(t[3], t[1])
