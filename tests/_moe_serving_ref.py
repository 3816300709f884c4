"""Shared pieces of the MoE serving parity tests
(``tests/test_torch_moe_serving*.py``): the tiny MoE model (the 8x345M
recipe's routing, 8 experts, top-2, capacity factor 1.25, at 2 layers
and hidden 128, fp32), its weights in both packages, the prompts, the
JAX server and ``generate()`` references, and the port's server run.

The routing group is one batch row of one forward, and its capacity
comes from that forward's sequence length, so each server mode routes
a prompt with its own capacity (the bucket of a contiguous admission,
the chunk of a paged one, the window of a verify tick). The port is
held against the JAX package mode by mode, never one mode against
another. Each reference clears JAX's compilation caches first: the
JAX ``moe/*`` counters count traces, and a model traced by an earlier
test in the same process would not count again.
"""

import dataclasses
from contextlib import contextmanager

import jax
import numpy as np
import pytest

from _torch_parity import (
    CPU, build_pair, build_quant_pair, jax_counters, rng,
)
from paddlefleetx_tpu.core.serving import GenerationServer as JaxServer
from paddlefleetx_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddlefleetx_tpu.models.gpt import generation as jax_gen
from paddlefleetx_tpu_torch.core.serving import GenerationServer
from paddlefleetx_tpu_torch.models.gpt import generation as gen
from paddlefleetx_tpu_torch.models.gpt.model import build_model
from paddlefleetx_tpu_torch.observability import metrics

EOS = PAD = 95
MAX_DEC = 8
#: the 8x345M recipe's routing on the tiny GPT; capacity 256 holds two
#: 128-token pages
MOE_KW = dict(moe_num_experts=8, moe_top_k=2, moe_capacity_factor=1.25,
              moe_dispatch="sort_pallas", ffn_hidden_size=256,
              max_position_embeddings=256)
#: paged: 128-token pages, one page a prefill chunk (capacity 40)
PAGED = dict(page_size=128, prefill_chunk_pages=1)
#: seed of the weights
SEED = 7


def prompts(n: int = 8, seed: int = 5, lo: int = 3, hi: int = 20):
    """``n`` seeded prompts of ``lo..hi - 1`` tokens below 90. Their
    buckets (16 and 32: capacity 5 and 10) bind where the paged chunk's
    capacity (40) does not, so the contiguous and paged servers route
    some of them differently, in the JAX package as in the port."""
    r = rng(seed)
    return [r.integers(0, 90, int(m)).tolist()
            for m in r.integers(lo, hi, n)]


def long_prompts():
    """``(first, later)``: prompts past one 128-token page that share a
    128-token prefix, one a repeat (the whole-prompt registry) and a
    short one; ``later`` arrive two steps after ``first``."""
    r = rng(3)
    base = r.integers(0, 90, 128).tolist()
    x = base + r.integers(0, 90, 6).tolist()
    a = base[:120]
    y = base + r.integers(0, 90, 3).tolist()
    return [x, a], [y, list(a), [7, 8, 9]]


def moe_pair(quant: bool = False, seed: int = SEED, **over):
    """``(jax model, jax params, port model)`` of the tiny MoE GPT
    (``build_pair``), or under ``quant``, ``quant_execution:
    weight_only_int8`` (``build_quant_pair``); ``over`` may set
    ``kv_cache_dtype``."""
    kw = dict(MOE_KW, **over)
    return build_quant_pair(seed, **kw) if quant else build_pair(seed, **kw)


def with_dispatch(pair, dispatch: str):
    """The same weights under another ``moe_dispatch`` (the parameter
    trees are the same in every mode)."""
    jmodel, params, model = pair
    jmodel = JaxGPT(dataclasses.replace(jmodel.config,
                                        moe_dispatch=dispatch))
    port = build_model(dataclasses.replace(model.config,
                                           moe_dispatch=dispatch), CPU,
                       state_dict=model.state_dict())
    return jmodel, params, port


def gen_cfg(cls, spec: int = 0, max_dec_len: int = MAX_DEC):
    """Greedy decoding, EOS / pad 95, ``spec`` n-gram drafts a tick."""
    return cls(max_dec_len=max_dec_len, decode_strategy="greedy_search",
               eos_token_id=EOS, pad_token_id=PAD,
               **({"spec_method": "ngram", "spec_tokens": spec}
                  if spec else {}))


def serve(srv, work):
    """Serve ``work`` (a prompt list, or ``(first, later)``: ``later``
    submitted two steps after ``first``) to completion; the tokens in
    submission order."""
    if not isinstance(work, tuple):
        return [c.tokens for c in srv.run(work)]
    first, later = work
    done = {}
    ids = [srv.submit(p) for p in first]
    for _ in range(2):
        for c in srv.step():
            done[c.request_id] = c
    ids += [srv.submit(p) for p in later]
    while srv.pending or srv.occupancy:
        for c in srv.step():
            done[c.request_id] = c
    assert all(done[i].finish_reason in ("eos", "length") for i in ids)
    return [done[i].tokens for i in ids]


def jax_serve(pair, work, spec: int = 0, max_dec_len: int = MAX_DEC,
              counter: str = "moe/sort_pallas", **kw):
    """The JAX server's greedy rows of ``work`` and its summary; asserts
    that the JAX model traced its experts through ``counter``."""
    jmodel, params, _ = pair
    jax.clear_caches()
    with jax_counters() as reg:
        srv = JaxServer(jmodel, params, gen_cfg(jax_gen.GenerationConfig,
                                                spec, max_dec_len), **kw)
        rows = serve(srv, work)
        assert reg.counter(counter) >= 1
        assert not [k for k in reg.snapshot()["counters"]
                    if k.startswith("moe/fallback/")]
    if srv.paged:
        srv._alloc.check()
        assert srv._alloc.pages_in_use == 0
    return rows, srv.summary()


def jax_generate(pair, batch):
    """JAX ``generate()`` rows of the left-padded ``batch``, cut after
    EOS; asserts the ``moe/sort_pallas`` trace."""
    jmodel, params, _ = pair
    ids, mask = gen.left_pad_batch(batch, PAD)
    jax.clear_caches()
    with jax_counters() as reg:
        out = jax_gen.generate(jmodel, params, np.asarray(ids),
                               np.asarray(mask), jax.random.key(0),
                               gen_cfg(jax_gen.GenerationConfig))
        out = np.asarray(out)
        assert reg.counter("moe/sort_pallas") >= 1
    return [truncate(r) for r in out.tolist()]


def truncate(row):
    """A generated row up to and including its first EOS."""
    out = []
    for t in row:
        out.append(int(t))
        if int(t) == EOS:
            break
    return out


@contextmanager
def port_counters():
    """The port's registry, enabled and zeroed for the block."""
    reg = metrics.get_registry()
    metrics.set_enabled(True)
    reg.reset()
    try:
        yield reg
    finally:
        reg.reset()
        metrics.set_enabled(False)


def port_serve(model, work, spec: int = 0, max_dec_len: int = MAX_DEC,
               counter: str = "moe/sort_pallas", **kw):
    """The port server's greedy rows of ``work`` and its summary (with
    the run's registry counters under ``"counters"``); asserts that the
    experts ran through ``counter`` once a layer and forward, and that
    a paged pool drained whole."""
    with port_counters() as reg:
        srv = GenerationServer(model, gen_cfg(gen.GenerationConfig, spec,
                                              max_dec_len), **kw)
        rows = serve(srv, work)
        summ = srv.summary()
        forwards = summ["decode_ticks"] + (
            summ["prefill_chunks"] if srv.paged else summ["admitted"])
        assert reg.counter(counter) == \
            forwards * model.config.num_layers > 0
        summ["counters"] = reg.snapshot()["counters"]
    if srv.paged:
        srv.check_alloc()
        assert summ["pages_in_use"] == 0
    return rows, summ


@contextmanager
def interpret():
    """The JAX package's Pallas kernels in interpret mode for the block
    (a module-scoped reference outlives a test's ``monkeypatch``)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PFX_PALLAS_INTERPRET", "1")
    try:
        yield
    finally:
        mp.undo()
