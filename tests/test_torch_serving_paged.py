"""The port's paged and speculative ``GenerationServer`` against the JAX
package's, on the same converted weights, in fp32: greedy rows equal
the JAX paged server's and the port's lockstep ``generate()`` over the
parity matrices of ``tests/test_serving.py`` (paged; paged +
speculative; contiguous + speculative), wrong drafts change no token,
preemption and re-admission resume token-exactly with the JAX server's
counts, prefix sharing and copy-on-write split as in JAX, the drained
pool is whole, the sampling accept rule and the rejected-draft residual
decide as the JAX ``verify_step`` does, and sampling depends on neither
slot, order nor pool size. The JAX servers run their default CPU route (the whole-server
parity is the point here; the kernels' own parity is
``test_torch_flash_decode_paged.py``)."""

import copy
import dataclasses

import numpy as np
import pytest

from _torch_parity import build_pair, rng
from paddlefleetx_tpu.core.serving import GenerationServer as JaxServer
from paddlefleetx_tpu.models.gpt import generation as jax_gen
from paddlefleetx_tpu_torch.core.serving import GenerationServer
from paddlefleetx_tpu_torch.models.gpt import generation as gen
from paddlefleetx_tpu_torch.observability import metrics

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


def test_port_lockstep_equals_jax_paged_server(ref):
    ids, mask = gen.left_pad_batch(PROMPTS, PAD)
    rows = gen.generate(ref["model"], ids, mask,
                        _cfg(gen.GenerationConfig)).tolist()
    trunc = []
    for row in rows:
        out = []
        for t in row:
            out.append(int(t))
            if t == EOS:
                break
        trunc.append(out)
    assert trunc == ref["short"]


MATRIX = [(1, list(range(7))), (2, [6, 5, 4, 3, 2, 1, 0]),
          (3, [2, 0, 4, 1, 6, 5, 3]), (7, list(range(7)))]


@pytest.mark.parametrize("num_slots,order", MATRIX)
def test_paged_parity_matrix_greedy(ref, num_slots, order):
    rows, summ = _port(ref, [PROMPTS[i] for i in order],
                       num_slots=num_slots, **PAGED)
    assert rows == [ref["short"][i] for i in order]
    assert summ["paged"] and summ["prefill_chunks"] >= 1


@pytest.mark.parametrize("num_slots,order", MATRIX[::2] + MATRIX[3:])
def test_paged_spec_parity_matrix_greedy(ref, num_slots, order):
    rows, summ = _port(ref, [PROMPTS[i] for i in order], spec=3,
                       num_slots=num_slots, **PAGED)
    assert rows == [ref["short"][i] for i in order]
    assert summ["spec_drafted"] > 0


@pytest.mark.parametrize("num_slots,order,k", [
    (1, list(range(7)), 3), (2, list(range(7)), 1),
    (2, [6, 5, 4, 3, 2, 1, 0], 3), (3, [2, 0, 4, 1, 6, 5, 3], 4),
    (7, list(range(7)), 3)])
def test_spec_parity_matrix_greedy(ref, num_slots, order, k):
    rows, _ = _port(ref, [PROMPTS[i] for i in order], spec=k,
                    num_slots=num_slots)
    assert rows == [ref["short"][i] for i in order]


class _WrongDraft:
    """Drafts a token run the model does not emit at temperature 0:
    every draft rejected, t0 still commits."""

    def propose(self, history, k):
        return [(history[-1] + 31) % 90] * k


class _OracleDraft:
    """Drafts each request's true continuation: every draft accepted."""

    def __init__(self, prompts, rows):
        self.full = [list(p) + r for p, r in zip(prompts, rows)]

    def propose(self, history, k):
        h = list(history)
        for full in self.full:
            if full[:len(h)] == h:
                tail = full[len(h) + 1:len(h) + 1 + k]
                return tail + [0] * (k - len(tail))
        return [0] * k


@pytest.mark.parametrize("paged", [False, True])
def test_wrong_and_oracle_drafts_stay_exact(ref, paged):
    kw = dict(PAGED) if paged else {}
    rows, summ = _port(ref, PROMPTS, spec=3, draft=_WrongDraft(),
                       num_slots=3, **kw)
    assert rows == ref["short"]
    assert summ["spec_accepted"] <= summ["spec_drafted"] // 10
    rows, summ = _port(ref, PROMPTS, spec=3,
                       draft=_OracleDraft(PROMPTS, ref["short"]),
                       num_slots=3, **kw)
    assert rows == ref["short"]
    assert summ["spec_accept_rate"] > 0.5
    assert summ["decode_ticks"] < sum(len(r) for r in rows) / 2


@pytest.mark.parametrize("spec", [0, 3])
def test_preemption_and_prefix_sharing_match_jax(ref, spec):
    """A 5-page pool (4 usable) under long prompts sharing a page-sized
    prefix, some arriving two steps late: requests are preempted back
    to the queue and resume token-exactly, prefix and whole-prompt
    pages are shared and split copy-on-write, and (speculation off)
    every count is the JAX server's."""
    metrics.set_enabled(True)
    reg = metrics.get_registry()
    reg.reset()
    try:
        rows, summ = _port(ref, _long_prompts(), spec=spec,
                           max_dec_len=LONG_DEC, num_slots=3,
                           pool_pages=5, **PAGED)
        assert reg.counter("serving/preempted") == summ["preempted"] > 0
        assert reg.counter("serving/prefill_chunks") == \
            summ["prefill_chunks"] > 0
        assert reg.counter("serving/prefix_hits") >= 1
        assert reg.counter("attention/dense") == \
            reg.counter("attention/fallback/kv_cache_layout") == \
            summ["prefill_chunks"] * ref["model"].config.num_layers
        name = "attention/flash_decode_paged_verify" if spec else \
            "attention/flash_decode_paged"
        assert reg.counter(name) > 0
    finally:
        reg.reset()
        metrics.set_enabled(False)
    assert rows == ref["long"]
    if not spec:
        for key in ("preempted", "prefill_chunks", "prefix_hits",
                    "prompt_hits", "cow_splits", "admitted", "evicted",
                    "decode_ticks", "decode_tokens"):
            assert summ[key] == ref["long_summary"][key], key


def test_cow_split_on_shared_partial_page(ref):
    """Identical prompts admitted together share even the partial last
    page through the prompt registry; the first divergent write splits
    it copy-on-write (sampling makes the forks diverge)."""
    cfg = gen.GenerationConfig(max_dec_len=6, decode_strategy="sampling",
                               top_k=8, temperature=0.7, eos_token_id=EOS,
                               pad_token_id=PAD)
    srv = GenerationServer(ref["model"], cfg, num_slots=3, **PAGED)
    p = _long_prompts()[0][1]
    comps = _serve(srv, [p], [p, p], gap=1)
    summ = srv.summary()
    assert summ["prompt_hits"] == 2 and summ["cow_splits"] >= 2
    assert all(len(tokens) >= 1 for tokens in comps)
    srv.check_alloc()
    assert summ["pages_in_use"] == 0


@pytest.mark.parametrize("spec", [0, 2])
def test_sampling_independent_of_slot_order_and_pool(ref, spec):
    cfg = gen.GenerationConfig(max_dec_len=6, decode_strategy="sampling",
                               top_k=8, top_p=0.9, temperature=0.7,
                               eos_token_id=EOS, pad_token_id=PAD,
                               spec_method="ngram" if spec else None,
                               spec_tokens=max(spec, 1))
    prompts = _long_prompts()[0] + PROMPTS[:3]
    runs = []
    for num_slots, order, pool in ((1, [0, 1, 2, 3, 4], None),
                                   (3, [4, 1, 0, 3, 2], None),
                                   (3, [2, 0, 4, 1, 3], 3)):
        srv = GenerationServer(ref["model"], cfg, num_slots=num_slots,
                               seed=5, pool_pages=pool, **PAGED)
        ids = {i: srv.submit(prompts[i], nonce=i) for i in order}
        done = {}
        while srv.pending or srv.occupancy:
            for c in srv.step():
                done[c.request_id] = c.tokens
        runs.append([done[ids[i]] for i in range(len(prompts))])
        srv.check_alloc()
    assert runs[0] == runs[1] == runs[2]
    # and the contiguous server draws the same tokens
    srv = GenerationServer(ref["model"], cfg, num_slots=2, seed=5)
    ids = [srv.submit(p, nonce=i) for i, p in enumerate(prompts)]
    done = {}
    while srv.pending or srv.occupancy:
        for c in srv.step():
            done[c.request_id] = c.tokens
    assert [done[i] for i in ids] == runs[0]


#: sampling at the point-mass limit: at temperature 1e-4 the filtered
#: distribution puts all its mass on one token, so the two packages'
#: random streams no longer decide anything and their verify ticks can
#: be compared token for token
POINT_MASS = dict(max_dec_len=8, decode_strategy="sampling", top_k=4,
                  top_p=1.0, temperature=1e-4, eos_token_id=EOS,
                  pad_token_id=PAD)
SPEC_K = 2


@pytest.fixture(scope="module")
def jax_verify(ref):
    """The JAX package's ``verify_step`` on two admitted prompts at the
    point-mass limit (as in ``tests/test_serving.py``'s accept-rule
    tests): the sequential continuation ``seq [2, k+1]`` from three
    ``decode_step`` ticks, and ``(window, counts, rejected)`` of a
    verify tick fed that continuation, fed a wrong first draft, fed
    zeros, and fed zeros with ``rejected`` set to the zeros tick's
    ``t0``."""
    import jax.numpy as jnp
    cfg = jax_gen.GenerationConfig(**POINT_MASS)
    srv = JaxServer(ref["jmodel"], ref["params"], cfg, num_slots=2)
    for p in PROMPTS[:2]:
        srv.submit(p)
    srv._admit()
    model, params, key = srv.model, srv.params, srv._rng
    cache, state = srv._cache, srv._state
    seq, c, st = [], cache, state
    for _ in range(SPEC_K + 1):
        c, st, tok = jax_gen.decode_step(model, params, c, st, key, cfg)
        seq.append(np.asarray(tok))
    seq = np.stack(seq, 1)

    def verify(drafts, st=state):
        _, after, window, counts = jax_gen.verify_step(
            model, params, cache, st, jnp.asarray(drafts, jnp.int32), key,
            cfg)
        return (np.asarray(window).tolist(), np.asarray(counts).tolist(),
                np.asarray(after.rejected).tolist())

    wrong = (seq[:, 1:] + 11) % 90
    zeros = np.zeros((2, SPEC_K), np.int32)
    plain = verify(zeros)
    t0 = [w[0] for w in plain[0]]
    return {"seq": seq, "wrong": wrong, "oracle": verify(seq[:, 1:]),
            "rejected": verify(wrong), "plain": plain,
            "excluded": verify(zeros, state._replace(
                rejected=jnp.asarray(t0, jnp.int32)))}


def _port_verify_server(ref, paged):
    """The port's server on the same two prompts, admitted and (paged)
    prefilled, and ``verify(drafts, rejected=None)``: one verify tick on
    copies of its cache and state, ``(window, counts, rejected)``."""
    cfg = gen.GenerationConfig(**POINT_MASS)
    srv = GenerationServer(ref["model"], cfg, num_slots=2,
                           **(PAGED if paged else {}))
    for p in PROMPTS[:2]:
        srv.submit(p)
    srv._admit()
    pt = None
    if paged:
        while srv._prefilling:
            srv._prefill_pump()
        srv._page_maintenance(window=SPEC_K + 1)
        srv._sync_pt()
        pt = srv._pt_dev_dec

    def verify(drafts, rejected=None):
        cache, state = copy.deepcopy((srv._cache, srv._state))
        if rejected is not None:
            state.rejected = list(rejected)
        window, counts = gen.verify_step(srv.model, cache, state,
                                         np.asarray(drafts).tolist(), cfg,
                                         srv.seed, pt)
        return window, counts, state.rejected

    def sequential(ticks):
        cache, state = copy.deepcopy((srv._cache, srv._state))
        return np.stack([gen.decode_step(srv.model, cache, state, cfg,
                                         srv.seed, pt)
                         for _ in range(ticks)], 1)
    return verify, sequential


@pytest.mark.parametrize("paged", [False, True])
def test_spec_sampling_accept_rule_matches_jax(ref, jax_verify, paged):
    """The rejection-sampling rule ``u < p(d_j)`` against the JAX
    package's at its deterministic limits: drafting the sequential
    continuation accepts every draft in both packages (``p(d) ~ 1``),
    drafting anything else rejects at the first draft (``p(d) ~ 0``),
    commits only ``t0`` and records the rejected draft for the next
    tick's residual, the same in both."""
    verify, sequential = _port_verify_server(ref, paged)
    seq = jax_verify["seq"]
    np.testing.assert_array_equal(sequential(SPEC_K + 1), seq)
    window, counts, rejected = verify(seq[:, 1:])
    assert (window, counts, rejected) == jax_verify["oracle"]
    assert counts == [SPEC_K + 1] * 2 and window == seq.tolist()
    assert rejected == [-1, -1]
    window, counts, rejected = verify(jax_verify["wrong"])
    assert (window, counts, rejected) == jax_verify["rejected"]
    assert counts == [1, 1]
    assert [w[0] for w in window] == seq[:, 0].tolist()
    assert rejected == jax_verify["wrong"][:, 0].tolist()


@pytest.mark.parametrize("paged", [False, True])
def test_spec_rejected_token_excluded_from_next_draw_matches_jax(
        ref, jax_verify, paged):
    """The residual exclusion against the JAX package's: when
    ``rejected`` holds the very token the filtered distribution puts
    its mass on, the next tick's ``t0`` is another token, the same one
    in both packages."""
    verify, _ = _port_verify_server(ref, paged)
    zeros = np.zeros((2, SPEC_K), np.int64)
    plain = verify(zeros)
    assert plain[0] == jax_verify["plain"][0]
    t0 = [w[0] for w in plain[0]]
    excluded = verify(zeros, rejected=t0)
    want = [w[0] for w in jax_verify["excluded"][0]]
    assert [w[0] for w in excluded[0]] == want
    assert all(a != b for a, b in zip(want, t0))


def test_accept_uniform_and_rejected_residual():
    """The accept uniforms are in [0, 1), depend on (seed, nonce, step)
    alone and differ from the plain draw's stream; a rejected draft is
    masked out of the next draw."""
    us = [gen.accept_uniform(0, n, s) for n in range(20) for s in range(20)]
    assert all(0.0 <= u < 1.0 for u in us)
    assert len(set(us)) == len(us)
    assert 0.3 < float(np.mean(us)) < 0.7
    import torch
    logits = torch.zeros(2, 5)
    logits[:, 3] = 5.0
    appeared = torch.zeros(2, 5, dtype=torch.bool)
    cfg = gen.GenerationConfig(decode_strategy="sampling", eos_token_id=4,
                               pad_token_id=4)
    picks = gen.next_token(logits, appeared, 1, cfg, [1, 2], [3, -1])
    assert int(picks[0]) != 3


def test_serving_knobs_reach_the_server_from_the_config(ref):
    """``Model.kv_page_size`` / ``kv_pool_pages`` turn paged mode on, as
    in the JAX constructor; the server validates its pool like
    GPTConfig does."""
    model = ref["model"]
    paged_cfg = dataclasses.replace(model.config, kv_page_size=128,
                                    kv_pool_pages=5)
    model.config = paged_cfg
    try:
        srv = GenerationServer(model, _cfg(gen.GenerationConfig),
                               num_slots=2)
        assert srv.paged and srv.summary()["pool_pages"] == 5
    finally:
        model.config = dataclasses.replace(paged_cfg, kv_page_size=0,
                                           kv_pool_pages=0)
    with pytest.raises(ValueError, match="max_kv_pages"):
        GenerationServer(model, _cfg(gen.GenerationConfig), page_size=128,
                         pool_pages=2)
    with pytest.raises(ValueError, match="divide"):
        GenerationServer(model, _cfg(gen.GenerationConfig), page_size=128,
                         prefill_chunk_pages=3)
    srv = GenerationServer(model, _cfg(gen.GenerationConfig), num_slots=3,
                           page_size=128)
    assert srv.summary()["pool_pages"] == 3 * 2 + 1
