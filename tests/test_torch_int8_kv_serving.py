"""The int8 KV cache (``kv_cache_dtype: int8``) against the JAX package,
at the model and server level: the int8 prefill's last logits (the
prompt attends over its round-tripped keys and values, as the JAX
prefill reads its int8 cache); the int8 lockstep ``generate()`` and the
contiguous, paged and speculative servers against the JAX int8
lockstep, greedy, with both int8 knobs on (the ports of
``tests/test_serving.py:1744`` / ``:1758`` and
``tests/test_quantized_matmul.py:303``); and a preempting,
prefix-sharing int8 pool against the JAX int8 server. The kernel-level
checks are in ``test_torch_int8_kv.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    CPU, build_quant_pair, jax_counters, rng,
)
from paddlefleetx_tpu.core.serving import GenerationServer as JaxServer
from paddlefleetx_tpu.models.gpt import generation as jax_gen
from paddlefleetx_tpu_torch.core.serving import GenerationServer
from paddlefleetx_tpu_torch.models.gpt import generation as gen
from paddlefleetx_tpu_torch.models.gpt.model import init_kv_cache
from paddlefleetx_tpu_torch.observability import metrics
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
