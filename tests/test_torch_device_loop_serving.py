"""The port's ``GenerationServer(device_loop_ticks=T)`` against the JAX
package's at the same T, on the same converted weights, fp32, greedy:
token-exact rows, the same loop exits (``serving/loop_exit/*``), device
ticks and host round trips, contiguous and paged, speculation on and
off, at T = 4 and 16; then against the port's own T = 1 rows under
preemption, a mid-loop EOS and a queue that refills (the ports of
``tests/test_serving.py``'s device-loop parity matrix). On the CPU the
loop's tick runs eagerly; the JAX servers run their decode kernels in
interpret mode."""

import dataclasses

import pytest

from _serving_paged_ref import _long_prompts, _serve
from _torch_parity import build_pair, jax_counters
from paddlefleetx_tpu.core.serving import GenerationServer as JaxServer
from paddlefleetx_tpu.models.gpt import generation as jax_gen
from paddlefleetx_tpu_torch.core.serving import GenerationServer
from paddlefleetx_tpu_torch.models.gpt import generation as gen
from paddlefleetx_tpu_torch.observability import metrics

EOS = PAD = 95
PROMPTS = [[5, 9, 2, 7, 1], [11, 3], [4, 4, 8, 1, 2, 6, 9],
           [13, 2, 2], [1], [7, 8]]
PAGED = dict(page_size=128, prefill_chunk_pages=1)
EXITS = ("finished", "budget", "admission")
#: the summary keys both packages report the same way
KEYS = ("decode_ticks", "decode_tokens", "device_loop_ticks",
        "device_ticks", "host_roundtrips", "admitted", "evicted")


def _cfg(cls, spec=0, **kw):
    extra = {"spec_method": "ngram", "spec_tokens": spec} if spec else {}
    return cls(**dict(dict(max_dec_len=8, decode_strategy="greedy_search",
                           eos_token_id=EOS, pad_token_id=PAD), **kw),
               **extra)


@pytest.fixture(scope="module")
def pair():
    mp = pytest.MonkeyPatch()
    mp.setenv("PFX_PALLAS_INTERPRET", "1")
    yield build_pair(seed=7, max_position_embeddings=256)
    mp.undo()


@pytest.fixture
def counters():
    reg = metrics.get_registry()
    metrics.set_enabled(True)
    reg.reset()
    yield reg
    reg.reset()
    metrics.set_enabled(False)


def _port(model, cfg, T, **kw):
    reg = metrics.get_registry()
    reg.reset()
    srv = GenerationServer(model, cfg, num_slots=2, device_loop_ticks=T, **kw)
    rows = [c.tokens for c in srv.run(PROMPTS)]
    exits = {r: reg.counter(f"serving/loop_exit/{r}") for r in EXITS}
    return rows, srv.summary(), exits, reg.counter("serving/device_ticks")


@pytest.mark.parametrize("loop_ticks", [4, 16])
@pytest.mark.parametrize("spec", [0, 3])
@pytest.mark.parametrize("paged", [False, True])
def test_server_loop_matches_jax(pair, counters, paged, spec, loop_ticks):
    """Token-exact against the JAX server at the same T, with the same
    exit reasons, device ticks and round trips; the T = 1 rows too."""
    jmodel, params, model = pair
    kw = PAGED if paged else {}
    with jax_counters() as reg:
        jsrv = JaxServer(jmodel, params, _cfg(jax_gen.GenerationConfig,
                                              spec),
                         num_slots=2, device_loop_ticks=loop_ticks, **kw)
        want = [c.tokens for c in jsrv.run(PROMPTS)]
        want_exits = {r: reg.counter(f"serving/loop_exit/{r}")
                      for r in EXITS}
        want_ticks = reg.counter("serving/device_ticks")
        assert reg.counter("attention/fallback/kernel_rejected") == 0
    jsum = jsrv.summary()
    cfg = _cfg(gen.GenerationConfig, spec)
    rows, summ, exits, ticks = _port(model, cfg, loop_ticks, **kw)
    assert rows == want
    assert exits == want_exits and ticks == want_ticks
    assert {k: summ[k] for k in KEYS} == {k: jsum[k] for k in KEYS}
    assert sum(exits.values()) == summ["host_roundtrips"]
    assert exits["admission"] >= 1 and exits["budget"] >= 1
    assert summ["host_roundtrips"] < summ["device_ticks"]
    assert summ["ticks_replayed"] >= summ["device_ticks"]
    assert summ["graph_warmups"] == 0       # eager on the CPU
    assert "host_roundtrip_p50_ms" in summ and "tick_p99_ms" in summ
    t1 = _port(model, cfg, 1, **kw)[0]
    assert t1 == rows
    if paged:
        assert summ["pages_in_use"] == 0


def test_t1_counts_one_tick_a_round_trip(pair, counters):
    """At T = 1 every round trip is one device tick, counted as such,
    and no loop exit fires."""
    _, _, model = pair
    _, summ, exits, ticks = _port(model, _cfg(gen.GenerationConfig), 1)
    assert summ["host_roundtrips"] == summ["device_ticks"] == \
        summ["decode_ticks"] == ticks
    assert not any(exits.values()) and "ticks_replayed" not in summ


def test_mid_loop_eos_and_preemption_match_t1(pair, counters):
    """A slot finishing mid-loop is evicted on time, and a 5-page pool
    (4 usable) that preempts and prefix-shares gives the T = 1 rows at
    T = 4 and 16; the drained pool is whole."""
    _, _, model = pair
    probe = _port(model, _cfg(gen.GenerationConfig), 1)[0]
    eos = probe[1][4]
    cfg = _cfg(gen.GenerationConfig, eos_token_id=eos)
    ref, ref_summ, _, _ = _port(model, cfg, 1)
    for T in (4, 16):
        rows, summ, exits, _ = _port(model, cfg, T)
        assert rows == ref
        assert summ["decode_tokens"] == ref_summ["decode_tokens"]
    assert any(len(r) < 8 for r in ref) and exits["finished"] >= 1
    long_cfg = dataclasses.replace(_cfg(gen.GenerationConfig),
                                   max_dec_len=16)
    runs = []
    for T in (1, 4, 16):
        srv = GenerationServer(model, long_cfg, num_slots=3, pool_pages=5,
                               device_loop_ticks=T, **PAGED)
        runs.append(_serve(srv, *_long_prompts()))
        srv.check_alloc()
        assert srv.summary()["pages_in_use"] == 0
        if T == 4:
            assert srv.summary()["preempted"] >= 1
    assert runs[0] == runs[1] == runs[2]


def test_serve_cli_takes_device_loop_ticks(capsys):
    """``cli serve --device-loop-ticks 4`` passes T to the server (the
    recipe samples): the same completions as T = 1 in fewer round
    trips."""
    from test_torch_cli import _argv
    from paddlefleetx_tpu_torch import cli
    args = ("--requests", "3", "--slots", "2", "--max-prompt-len", "20")
    t1 = cli.serve_main(_argv(*args))
    t4 = cli.serve_main(_argv(*args, "--device-loop-ticks", "4"))
    assert (t1["device_loop_ticks"], t4["device_loop_ticks"]) == (1, 4)
    assert t4["decode_tokens"] == t1["decode_tokens"] > 0
    assert t4["device_ticks"] == t1["device_ticks"]
    assert t4["host_roundtrips"] < t1["host_roundtrips"]
    # one line a completion, equal but for its time to first token
    lines = [ln.split(', "ttft_ms"')[0] for ln in
             capsys.readouterr().out.splitlines()
             if ln.startswith('{"request"')]
    assert len(lines) == 6 and lines[:3] == lines[3:]
