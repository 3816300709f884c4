"""The int8 KV cache (``kv_cache_dtype: int8``) against the JAX package:
``quantize_kv`` against ``_quantize_kv``; the int8 plain versions of
kernels 2, 5, 6a and 6b against the JAX decode kernels' ``quantized``
branch in interpret mode (the JAX ``attention/*_int8`` counter fired,
the port's dispatch takes the same route under the same name); the
dense route widening the cache up front; the int8 prefill's last logits
(the prompt attends over its round-tripped keys and values, as the JAX
prefill reads its int8 cache); and the int8 lockstep ``generate()`` and
contiguous, paged and speculative servers against the JAX int8
lockstep, greedy, with both int8 knobs on (the ports of
``tests/test_serving.py:1744`` / ``:1758`` and
``tests/test_quantized_matmul.py:303``), and a preempting,
prefix-sharing int8 pool against the JAX int8 server. The JAX cache is
``[b, h, d, S]`` with ``[b, h, 1, S]`` scales (pool ``[P, h, d, page]``
/ ``[P, h, 1, page]``); the port's ``[b, h, S, d]`` / ``[b, h, S]``, so
the tests transpose at the comparison."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    CPU, build_quant_pair, jax_counters, rng, tiny_kwargs,
)
from paddlefleetx_tpu.core.serving import GenerationServer as JaxServer
from paddlefleetx_tpu.models.gpt import generation as jax_gen
from paddlefleetx_tpu.models.gpt.model import _quantize_kv
from paddlefleetx_tpu.ops import attention as jax_attn
from paddlefleetx_tpu_torch.core.serving import GenerationServer
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


@pytest.fixture(scope="module", params=["kv", "kv+quant"])
def int8_pair(request):
    """``(jax model, params, port model)`` with the int8 cache, and with
    ``quant_execution`` too for ``kv+quant`` (JAX-initialized weights,
    quantized by the JAX PTQ)."""
    kw = dict(max_position_embeddings=256, kv_cache_dtype="int8")
    if request.param == "kv":
        from _torch_parity import build_pair
        return build_pair(seed=7, **kw)
    return build_quant_pair(seed=7, **kw)


def test_int8_prefill_last_logits_match_jax(int8_pair):
    """The prompt's last logits with the int8 cache: the JAX prefill
    attends over its dequantized cache, the port's kernel 1 over the
    round-tripped keys and values: equal in fp32, and off from the
    logits over fresh keys and values by more than the tolerance (so
    the test would see a prefill that skipped the round trip)."""
    jmodel, params, model = int8_pair
    ids, mask = gen.left_pad_batch(PROMPTS[:4], PAD)
    b, s = ids.shape
    cap = model.config.cache_capacity
    pos = np.clip(np.cumsum(mask, -1) - 1, 0, None)
    valid = np.zeros((b, cap), bool)
    valid[:, :s] = mask > 0
    jbias = jax_gen._decode_bias(jnp.asarray(valid))
    ref, _ = jmodel.apply({"params": params}, jnp.asarray(ids),
                          position_ids=jnp.asarray(pos), attn_bias=jbias,
                          use_cache=True, deterministic=True,
                          mutable=["cache"])
    bias = gen._decode_bias(torch.from_numpy(valid[:, :s]))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(),
                    torch.from_numpy(pos).long(), attn_bias=bias,
                    cache=init_kv_cache(model.config, b, CPU))
        fresh = model(torch.from_numpy(ids).long(),
                      torch.from_numpy(pos).long(), attn_bias=bias)
    np.testing.assert_allclose(got[:, -1].numpy(),
                               np.asarray(ref)[:, -1], atol=LOGIT_ATOL)
    assert float((got[:, -1] - fresh[:, -1]).abs().max()) > 10 * LOGIT_ATOL


def _cfg(cls, **kw):
    return cls(max_dec_len=kw.pop("max_dec_len", MAX_DEC),
               decode_strategy="greedy_search", eos_token_id=EOS,
               pad_token_id=PAD, **kw)


def _truncate(rows):
    out = []
    for row in rows:
        r = []
        for t in row:
            r.append(int(t))
            if int(t) == EOS:
                break
        out.append(r)
    return out


@pytest.fixture(scope="module")
def jax_lockstep(int8_pair):
    """The JAX int8 lockstep rows (interpret mode), greedy."""
    jmodel, params, _ = int8_pair
    ids, mask = gen.left_pad_batch(PROMPTS, PAD)
    mp = pytest.MonkeyPatch()
    mp.setenv("PFX_PALLAS_INTERPRET", "1")
    try:
        with jax_counters() as reg:
            rows = np.asarray(jax_gen.generate(
                jmodel, params, jnp.asarray(ids), jnp.asarray(mask),
                jax.random.key(0), _cfg(jax_gen.GenerationConfig)))
            assert reg.counter("attention/flash_decode_int8") >= 1
            assert reg.counter("attention/flash_decode") == 0
    finally:
        mp.undo()
    return _truncate(rows.tolist())


@pytest.mark.parametrize("mode", ["lockstep", "contiguous", "paged",
                                  "contiguous_spec", "paged_spec"])
def test_int8_greedy_rows_match_jax_lockstep(int8_pair, jax_lockstep, mode,
                                             port_counters):
    """Greedy rows of the port's int8 lockstep and servers equal the JAX
    int8 lockstep rows, each tick through its kernel's int8 instance."""
    _, _, model = int8_pair
    pcfg = _cfg(gen.GenerationConfig)
    if mode == "lockstep":
        ids, mask = gen.left_pad_batch(PROMPTS, PAD)
        rows = _truncate(gen.generate(model, ids, mask, pcfg).tolist())
        counter = "attention/flash_decode_int8"
    else:
        if mode.endswith("spec"):
            pcfg = dataclasses.replace(pcfg, spec_method="ngram",
                                       spec_tokens=3)
        kw = dict(page_size=PAGE, prefill_chunk_pages=1) \
            if mode.startswith("paged") else {}
        srv = GenerationServer(model, pcfg, num_slots=3, **kw)
        rows = [c.tokens for c in srv.run(PROMPTS)]
        srv.check_alloc()
        counter = {"contiguous": "attention/flash_decode_ragged_int8",
                   "paged": "attention/flash_decode_paged_int8",
                   "contiguous_spec":
                   "attention/flash_decode_ragged_verify_int8",
                   "paged_spec":
                   "attention/flash_decode_paged_verify_int8"}[mode]
    assert rows == jax_lockstep
    assert port_counters.counter(counter) > 0
    for name in ("attention/flash_decode", "attention/flash_decode_ragged",
                 "attention/flash_decode_paged"):
        assert port_counters.counter(name) == 0
    if model.config.quant_execution != "off":
        assert port_counters.counter("quant/matmul") > 0
        assert port_counters.counter("quant/fallback/kernel_rejected") == 0


def _long_prompts():
    """Prompts past one page sharing a page-sized prefix, one identical
    to another (the prompt registry), arriving in two waves."""
    r = rng(3)
    base = r.integers(0, 90, 128).tolist()
    x = base + r.integers(0, 90, 6).tolist()
    a = base[:120]
    return [x, a], [base + r.integers(0, 90, 3).tolist(), list(a), [7, 8, 9]]


def _serve(srv, first, later, gap=2):
    done = {}
    ids = [srv.submit(p) for p in first]
    for _ in range(gap):
        for c in srv.step():
            done[c.request_id] = c
    ids += [srv.submit(p) for p in later]
    while srv.pending or srv.occupancy:
        for c in srv.step():
            done[c.request_id] = c
    return [done[i].tokens for i in ids]


def test_int8_pool_preemption_and_cow_match_jax_server(int8_pair):
    """A 5-page int8 pool under long prompts sharing a prefix, one
    repeated: requests are preempted and resume, pages are shared and
    split copy-on-write (the split copies the scale pools too), and the
    rows and every count equal the JAX int8 server's."""
    jmodel, params, model = int8_pair
    kw = dict(num_slots=3, page_size=PAGE, prefill_chunk_pages=1,
              pool_pages=5)
    jsrv = JaxServer(jmodel, params, _cfg(jax_gen.GenerationConfig,
                                          max_dec_len=16), **kw)
    ref = _serve(jsrv, *_long_prompts())
    srv = GenerationServer(model, _cfg(gen.GenerationConfig,
                                       max_dec_len=16), **kw)
    rows = _serve(srv, *_long_prompts())
    srv.check_alloc()
    summ, jsumm = srv.summary(), jsrv.summary()
    assert rows == ref
    assert summ["preempted"] > 0 and summ["cow_splits"] > 0
    for key in ("preempted", "prefill_chunks", "prefix_hits", "prompt_hits",
                "cow_splits", "admitted", "decode_ticks", "kv_cache_dtype",
                "pool_bytes"):
        assert summ[key] == jsumm[key], key


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


def test_int8_cow_split_keeps_the_prompt_cache(int8_pair):
    """A repeated prompt shares the first one's pages, its partial last
    page included; the first write into that page splits it
    copy-on-write. Afterwards both slots hold the same dequantized keys
    and values over the prompt: the split copied the scale pools with
    the int8 values (a greedy row may not show stale scales; this
    does)."""
    _, _, model = int8_pair
    srv = GenerationServer(model, _cfg(gen.GenerationConfig,
                                       max_dec_len=16),
                           num_slots=2, page_size=PAGE, prefill_chunk_pages=1)
    prompt = _long_prompts()[0][1]          # 120 tokens: one partial page
    srv.submit(prompt)
    while not (srv._slots[0] or {}).get("active"):
        srv.step()
    srv.step()
    srv.submit(prompt)
    srv.step()
    srv.step()
    summ = srv.summary()
    assert summ["prompt_hits"] == 1 and summ["cow_splits"] >= 1
    pt = torch.as_tensor(srv._pt)
    assert pt[0, 0] != pt[1, 0]
    n = len(prompt)
    for layer in srv._cache:
        k, v, ks, vs = (fa.gather_kv_pages(t, pt) for t in layer)
        for q8, sc in ((k, ks), (v, vs)):
            deq = q8.float() * sc[..., None]
            assert torch.equal(deq[0, :, :n], deq[1, :, :n])
            assert bool(sc[:, :, :n].gt(0).all())
