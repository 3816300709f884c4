"""The port's paged and speculative ``GenerationServer`` against the JAX
package's, on the same converted weights, in fp32: greedy rows equal
the JAX paged server's and the port's lockstep ``generate()`` over the
parity matrices of ``tests/test_serving.py`` (paged; paged +
speculative; contiguous + speculative), wrong drafts change no token,
preemption and re-admission resume token-exactly with the JAX server's
counts, prefix sharing and copy-on-write split as in JAX, and the
drained pool is whole. The sampling accept rule, the rejected-draft
residual and sampling's independence of slot, order and pool size are
in ``test_torch_serving_paged_sampling.py``. The JAX servers run their
default CPU route (the whole-server parity is the point here; the
kernels' own parity is ``test_torch_flash_decode_paged.py``)."""

import dataclasses

import pytest

from _serving_paged_ref import (  # noqa: F401
    EOS, LONG_DEC, PAD, PAGED, PROMPTS, _cfg, _long_prompts, _port, _serve,
    ref,
)
from paddlefleetx_tpu_torch.core.serving import GenerationServer
from paddlefleetx_tpu_torch.models.gpt import generation as gen
from paddlefleetx_tpu_torch.observability import metrics


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
