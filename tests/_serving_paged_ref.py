"""Shared pieces of the paged and speculative serving parity tests
(``tests/test_torch_serving_paged*.py``): the prompts, the server
configurations, the JAX servers' reference rows (one module-scoped
fixture a test file) and the port's server run."""

import pytest

from _torch_parity import build_pair, rng
from paddlefleetx_tpu.core.serving import GenerationServer as JaxServer
from paddlefleetx_tpu.models.gpt import generation as jax_gen
from paddlefleetx_tpu_torch.core.serving import GenerationServer
from paddlefleetx_tpu_torch.models.gpt import generation as gen

EOS = PAD = 95
MAX_DEC = 8
PROMPTS = [[5, 9, 2, 7, 1], [11, 3], [4, 4, 8, 1, 2, 6, 9],
           [13, 2, 2], [1], [7, 8], [5, 9, 2, 7, 1]]
PAGED = dict(page_size=128, prefill_chunk_pages=1)
#: the long trace's decode length: its requests grow past a page
LONG_DEC = 16


def _long_prompts():
    """``(first, later)``: prompts past one 128-token page that share a
    128-token prefix, one identical to another (the prompt registry)
    and a short one; ``later`` arrive two steps after ``first``."""
    r = rng(3)
    base = r.integers(0, 90, 128).tolist()
    x = base + r.integers(0, 90, 6).tolist()
    a = base[:120]
    y = base + r.integers(0, 90, 3).tolist()
    return [x, a], [y, list(a), [7, 8, 9]]


def _serve(srv, first, later, gap=2):
    """Submit ``first``, step ``gap`` times, submit ``later``, drain;
    the completions' tokens in submission order."""
    done = {}
    ids = [srv.submit(p) for p in first]
    for _ in range(gap):
        for c in srv.step():
            done[c.request_id] = c
    ids += [srv.submit(p) for p in later]
    while srv.pending or srv.occupancy:
        for c in srv.step():
            done[c.request_id] = c
    assert all(done[i].finish_reason in ("eos", "length") for i in ids)
    return [done[i].tokens for i in ids]


def _cfg(cls, **kw):
    return cls(max_dec_len=kw.pop("max_dec_len", MAX_DEC),
               decode_strategy="greedy_search", eos_token_id=EOS,
               pad_token_id=PAD, **kw)


def _jax_run(jmodel, params, prompts, spec=0, max_dec_len=MAX_DEC, **kw):
    cfg = _cfg(jax_gen.GenerationConfig, max_dec_len=max_dec_len,
               **({"spec_method": "ngram", "spec_tokens": spec} if spec
                  else {}))
    srv = JaxServer(jmodel, params, cfg, **kw)
    if isinstance(prompts, tuple):
        rows = _serve(srv, *prompts)
    else:
        rows = [c.tokens for c in srv.run(prompts)]
    if srv.paged:
        srv._alloc.check()
        assert srv._alloc.pages_in_use == 0
    return rows, srv.summary()


@pytest.fixture(scope="module")
def ref():
    """The port model and the JAX servers' greedy rows: the short
    prompts through the paged server, the long ones through a paged
    server whose 5-page pool (4 usable) forces preemption."""
    jmodel, params, model = build_pair(seed=7, max_position_embeddings=256)
    short, _ = _jax_run(jmodel, params, PROMPTS, num_slots=2, **PAGED)
    spec_short, _ = _jax_run(jmodel, params, PROMPTS, spec=3, num_slots=3)
    long_, long_summary = _jax_run(jmodel, params, _long_prompts(),
                                   max_dec_len=LONG_DEC, num_slots=3,
                                   pool_pages=5, **PAGED)
    assert spec_short == short
    return {"model": model, "short": short, "long": long_,
            "long_summary": long_summary, "jmodel": jmodel,
            "params": params}


def _port(ref, prompts, spec=0, draft=None, max_dec_len=MAX_DEC, **kw):
    cfg = _cfg(gen.GenerationConfig, max_dec_len=max_dec_len,
               **({"spec_method": "ngram", "spec_tokens": spec} if spec
                  else {}))
    srv = GenerationServer(ref["model"], cfg, **kw)
    if draft is not None:
        srv._draft = draft
    if isinstance(prompts, tuple):
        rows = _serve(srv, *prompts)
    else:
        comps = srv.run(prompts)
        assert all(c.finish_reason in ("eos", "length") for c in comps)
        rows = [c.tokens for c in comps]
    srv.check_alloc()
    if srv.paged:
        assert srv._alloc.pages_in_use == 0     # the drained pool is whole
    return rows, srv.summary()
