"""The port's ``GenerationServer``: greedy completions equal the JAX
package's server (ragged decode kernel, interpret mode) and the port's
own lockstep ``generate()`` over the parity matrix of
``tests/test_serving.py`` — slot count, admission order and mid-run
admission are invisible — and sampling depends on neither slot nor
order. On the CPU the kernels' plain versions run, so the dispatch
counts show which kernel each call would launch."""

import pytest

from _torch_parity import build_pair, jax_counters
from paddlefleetx_tpu.core.serving import GenerationServer as JaxServer
from paddlefleetx_tpu.models.gpt import generation as jax_gen
from paddlefleetx_tpu_torch.core.serving import (
    GenerationServer, default_prefill_buckets,
)
from paddlefleetx_tpu_torch.models.gpt import generation as gen
from paddlefleetx_tpu_torch.observability import metrics
from paddlefleetx_tpu_torch.ops.cuda import flash_attention as fa

EOS = PAD = 95
PROMPTS = [[5, 9, 2, 7, 1], [11, 3], [4, 4, 8, 1, 2, 6, 9],
           [13, 2, 2], [1], [7, 8]]
MAX_DEC = 8


def _greedy():
    return gen.GenerationConfig(max_dec_len=MAX_DEC,
                                decode_strategy="greedy_search",
                                eos_token_id=EOS, pad_token_id=PAD)


def _truncate(row):
    out = []
    for t in row:
        out.append(int(t))
        if int(t) == EOS:
            break
    return out


@pytest.fixture(scope="module")
def served():
    """(port model, JAX server completions of PROMPTS): the reference
    rows come from the JAX server through its ragged decode kernel."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PFX_PALLAS_INTERPRET", "1")
    try:
        jmodel, params, model = build_pair(seed=7,
                                           max_position_embeddings=48)
        jcfg = jax_gen.GenerationConfig(max_dec_len=MAX_DEC,
                                        decode_strategy="greedy_search",
                                        eos_token_id=EOS, pad_token_id=PAD)
        with jax_counters() as reg:
            srv = JaxServer(jmodel, params, jcfg, num_slots=2)
            ref = [c.tokens for c in srv.run(PROMPTS)]
            assert reg.counter("attention/flash_decode_ragged") >= 1
            assert reg.counter("attention/fallback/kernel_rejected") == 0
    finally:
        mp.undo()
    return model, ref


def test_port_lockstep_equals_jax_server(served):
    model, ref = served
    ids, mask = gen.left_pad_batch(PROMPTS, PAD)
    rows = gen.generate(model, ids, mask, _greedy()).tolist()
    assert [_truncate(r) for r in rows] == ref


@pytest.mark.parametrize("num_slots,order", [
    (1, list(range(6))),            # fully sequential
    (2, [5, 4, 3, 2, 1, 0]),        # reversed admission
    (3, [2, 0, 4, 1, 5, 3]),        # shuffled admission
    (6, list(range(6))),            # everything admitted at once
])
def test_parity_matrix_greedy(served, num_slots, order):
    model, ref = served
    srv = GenerationServer(model, _greedy(), num_slots=num_slots)
    comps = srv.run([PROMPTS[i] for i in order])
    assert [c.tokens for c in comps] == [ref[i] for i in order]
    assert all(c.finish_reason in ("eos", "length") for c in comps)


def test_mid_run_admission_parity(served):
    model, ref = served
    srv = GenerationServer(model, _greedy(), num_slots=2)
    done = {}
    ids = [srv.submit(p) for p in PROMPTS[:2]]
    for _ in range(3):
        for c in srv.step():
            done[c.request_id] = c
    ids += [srv.submit(p) for p in PROMPTS[2:]]
    while srv.pending or srv.occupancy:
        for c in srv.step():
            done[c.request_id] = c
    assert [done[i].tokens for i in ids] == ref


def test_sampling_is_slot_and_order_independent(served):
    model, _ = served
    cfg = gen.GenerationConfig(max_dec_len=6, decode_strategy="sampling",
                               top_k=8, top_p=0.9, temperature=0.7,
                               eos_token_id=EOS, pad_token_id=PAD)
    runs = []
    for num_slots, order in ((1, [0, 1, 2, 3]), (3, [3, 1, 0, 2])):
        srv = GenerationServer(model, cfg, num_slots=num_slots, seed=5)
        ids = {i: srv.submit(PROMPTS[i], nonce=i) for i in order}
        done = {}
        while srv.pending or srv.occupancy:
            for c in srv.step():
                done[c.request_id] = c.tokens
        runs.append([done[ids[i]] for i in range(4)])
    assert runs[0] == runs[1]


def test_counters_and_summary(served):
    """Each admission is one prefill (one flash-forward call per layer)
    and each tick one ragged decode per layer; no dense attention."""
    model, ref = served
    layers = model.config.num_layers
    metrics.set_enabled(True)
    reg = metrics.get_registry()
    reg.reset()
    try:
        srv = GenerationServer(model, _greedy(), num_slots=3)
        comps = srv.run(PROMPTS)
        summ = srv.summary()
        assert [c.tokens for c in comps] == ref
        assert reg.counter("serving/admitted") == summ["admitted"] == 6
        assert reg.counter("serving/evicted") == summ["evicted"] == 6
        assert reg.counter("serving/decode_tokens") == \
            summ["decode_tokens"] == sum(len(c.tokens) for c in comps)
        assert reg.counter("serving/decode_tick/calls") == \
            summ["decode_ticks"]
        assert reg.counter("attention/flash") == 6 * layers
        assert reg.counter("attention/flash_decode_ragged") == \
            summ["decode_ticks"] * layers
        assert reg.counter("attention/dense") == 0
        assert reg.gauge("serving/slot_occupancy") == 0
        assert summ["tokens_per_sec"] > 0 and "ttft_p50_ms" in summ
        assert all(c.ttft_ms is not None for c in comps)
    finally:
        reg.reset()
        metrics.set_enabled(False)
    assert fa.flash_attention.launches == fa.flash_decode.launches == 0


def test_unported_options_and_bad_requests_raise(served):
    model, _ = served
    with pytest.raises(NotImplementedError, match="host_pool_bytes"):
        GenerationServer(model, _greedy(), page_size=128,
                         host_pool_bytes=1 << 20)
    with pytest.raises(ValueError, match="device_loop_ticks"):
        GenerationServer(model, _greedy(), device_loop_ticks=0)
    loop = GenerationServer(model, gen.GenerationConfig(
        max_dec_len=4, decode_strategy="greedy_search",
        spec_method="ngram"), device_loop_ticks=4)
    assert loop.summary()["device_loop_ticks"] == 4
    with pytest.raises(ValueError, match="beam"):
        GenerationServer(model, gen.GenerationConfig(
            max_dec_len=4, decode_strategy="beam_search", num_beams=2))
    srv = GenerationServer(model, _greedy(), num_slots=1)
    with pytest.raises(ValueError, match="empty"):
        srv.submit([])
    with pytest.raises(ValueError, match="exceeds"):
        srv.submit([1] * 41)
    assert default_prefill_buckets(40) == (16, 32, 40)
