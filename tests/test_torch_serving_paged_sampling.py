"""The port's paged and speculative ``GenerationServer`` against the JAX
package's, on the same converted weights, in fp32, when it samples:
sampling depends on neither slot, order nor pool size (paged, and the
contiguous server draws the same tokens), and the speculative accept
rule and the rejected-draft residual decide as the JAX ``verify_step``
does at the point-mass limit. The greedy parity is in
``test_torch_serving_paged.py``."""

import copy

import numpy as np
import pytest

from _serving_paged_ref import (  # noqa: F401
    EOS, PAD, PAGED, PROMPTS, _long_prompts, ref,
)
from paddlefleetx_tpu.core.serving import GenerationServer as JaxServer
from paddlefleetx_tpu.models.gpt import generation as jax_gen
from paddlefleetx_tpu_torch.core.serving import GenerationServer
from paddlefleetx_tpu_torch.models.gpt import generation as gen


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
