"""The port's device-resident loops (``decode_loop`` / ``verify_loop``)
against the JAX package's on the same converted weights and admitted
slot states, fp32, greedy (the ports of ``tests/test_serving.py``'s
loop tests): token buffers, ``ticks_run`` and ``exit_reason`` equal at
T = 1 and 4, a host-flag exit after one tick, a budget exit and a
mid-loop EOS; the masked iterations past the exit leave the state as
it was. The JAX references run its ragged decode kernel in interpret
mode, with its dispatch counters shown to fire."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import build_pair, jax_counters
from paddlefleetx_tpu.core.serving import GenerationServer as JaxServer
from paddlefleetx_tpu.models.gpt import generation as jax_gen
from paddlefleetx_tpu_torch.core.serving import GenerationServer
from paddlefleetx_tpu_torch.models.gpt import generation as gen

EOS = PAD = 95
PROMPTS = [[5, 9, 2, 7, 1], [11, 3], [4, 4, 8, 1, 2, 6, 9]]
K = 2


def _cfg(cls, **kw):
    base = dict(max_dec_len=8, decode_strategy="greedy_search",
                eos_token_id=EOS, pad_token_id=PAD)
    base.update(kw)
    return cls(**base)


def _jax_admitted(jmodel, params, cfg):
    srv = JaxServer(jmodel, params, cfg, num_slots=2)
    for p in PROMPTS[:2]:
        srv.submit(p)
    srv._admit()
    return srv


def _port_admitted(model, cfg):
    srv = GenerationServer(model, cfg, num_slots=2)
    for p in PROMPTS[:2]:
        srv.submit(p)
    srv._admit()
    return srv


@pytest.fixture(scope="module")
def ref():
    """The pair and every JAX loop result the tests compare against,
    traced afresh (the JAX dispatch counters count traces)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PFX_PALLAS_INTERPRET", "1")
    jmodel, params, model = build_pair(seed=7, max_position_embeddings=48)
    out = {"model": model}
    try:
        jax.clear_caches()
        with jax_counters() as reg:
            cfg = _cfg(jax_gen.GenerationConfig)
            probe = _jax_admitted(jmodel, params, cfg)
            seq = []
            c, st = probe._cache, probe._state
            for _ in range(6):
                c, st, tok = jax_gen.decode_step(
                    probe.model, probe.params, c, st, probe._rng, cfg)
                seq.append(np.asarray(tok))
            out["seq"] = np.stack(seq, 1)
            for T in (1, 4):
                srv = _jax_admitted(jmodel, params, cfg)
                _, st, buf, ticks, reason = jax_gen.decode_loop(
                    srv.model, srv.params, srv._cache, srv._state, srv._rng,
                    cfg, jnp.int32(0), loop_ticks=T)
                out[("decode", T)] = (np.asarray(buf), int(ticks),
                                      int(reason),
                                      np.asarray(st.dec_count).tolist())
            srv = _jax_admitted(jmodel, params, cfg)
            _, _, buf, ticks, reason = jax_gen.decode_loop(
                srv.model, srv.params, srv._cache, srv._state, srv._rng,
                cfg, jnp.int32(1), loop_ticks=8)
            out["host"] = (np.asarray(buf), int(ticks), int(reason))
            short = _cfg(jax_gen.GenerationConfig, max_dec_len=3)
            srv = _jax_admitted(jmodel, params, short)
            _, st, buf, ticks, reason = jax_gen.decode_loop(
                srv.model, srv.params, srv._cache, srv._state, srv._rng,
                short, jnp.int32(0), loop_ticks=16)
            out["budget"] = (np.asarray(buf), int(ticks), int(reason),
                             np.asarray(st.dec_count).tolist())
            # row 1's fifth token, new in both rows, as EOS: the loop
            # stops after its fifth tick
            eos = int(out["seq"][1, 4])
            assert eos not in out["seq"][:, :4]
            early = _cfg(jax_gen.GenerationConfig, eos_token_id=eos)
            srv = _jax_admitted(jmodel, params, early)
            _, st, buf, ticks, reason = jax_gen.decode_loop(
                srv.model, srv.params, srv._cache, srv._state, srv._rng,
                early, jnp.int32(0), loop_ticks=8)
            out["eos"] = (eos, np.asarray(buf), int(ticks), int(reason),
                          np.asarray(st.finished).tolist())
            spec = _cfg(jax_gen.GenerationConfig, spec_method="ngram",
                        spec_tokens=K)
            for T in (1, 4):
                # tick j drafts the sequential continuation past its t0
                # for row 0 (accepted) and junk for row 1 (rejected)
                drafts = np.zeros((2, T, K), np.int32)
                drafts[0, 0] = out["seq"][0, 1:1 + K]
                drafts[1] = 7
                srv = _jax_admitted(jmodel, params, spec)
                _, st, wbuf, cbuf, ticks, reason = jax_gen.verify_loop(
                    srv.model, srv.params, srv._cache, srv._state,
                    jnp.asarray(drafts), srv._rng, spec, jnp.int32(0),
                    loop_ticks=T)
                out[("verify", T)] = (drafts, np.asarray(wbuf),
                                      np.asarray(cbuf), int(ticks),
                                      int(reason),
                                      np.asarray(st.dec_count).tolist())
            assert reg.counter("attention/flash_decode_ragged") >= 1
            assert reg.counter("attention/flash_decode_ragged_verify") >= 1
            assert reg.counter("attention/fallback/kernel_rejected") == 0
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("loop_ticks", [1, 4])
def test_decode_loop_matches_jax(ref, loop_ticks):
    """Full-T runs: the same token columns, ticks and exit reason."""
    srv = _port_admitted(ref["model"], _cfg(gen.GenerationConfig))
    buf, ticks, reason = gen.decode_loop(
        srv.model, srv._cache, srv._state, srv.gen_cfg, False, srv.seed,
        loop_ticks=loop_ticks)
    want_buf, want_ticks, want_reason, want_dec = ref[("decode", loop_ticks)]
    np.testing.assert_array_equal(buf, want_buf)
    assert (ticks, reason) == (want_ticks, want_reason) == \
        (loop_ticks, gen.LOOP_EXIT_BUDGET)
    assert srv._state.host.dec_count.tolist() == want_dec
    np.testing.assert_array_equal(buf, ref["seq"][:, :loop_ticks])


def test_decode_loop_t1_matches_decode_step(ref):
    """The loop at T = 1 is ``decode_step``: the same token and the same
    state, tensor for tensor."""
    import copy
    import torch
    srv = _port_admitted(ref["model"], _cfg(gen.GenerationConfig))
    cache, state = copy.deepcopy((srv._cache, srv._state))
    tok = gen.decode_step(srv.model, cache, state, srv.gen_cfg, srv.seed)
    buf, ticks, reason = gen.decode_loop(
        srv.model, srv._cache, srv._state, srv.gen_cfg, False, srv.seed,
        loop_ticks=1)
    assert buf[:, 0].tolist() == tok and ticks == 1
    for f in dataclasses.fields(state):
        a, b = getattr(state, f.name), getattr(srv._state, f.name)
        if torch.is_tensor(a):
            assert torch.equal(a, b), f.name
    for a, b in zip(cache, srv._cache):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_decode_loop_host_flag_exits_after_one_tick(ref):
    """Host flag up: one tick, ``LOOP_EXIT_HOST``, pad past it."""
    srv = _port_admitted(ref["model"], _cfg(gen.GenerationConfig))
    buf, ticks, reason = gen.decode_loop(
        srv.model, srv._cache, srv._state, srv.gen_cfg, True, srv.seed,
        loop_ticks=8)
    want_buf, want_ticks, want_reason = ref["host"]
    np.testing.assert_array_equal(buf, want_buf)
    assert (ticks, reason) == (want_ticks, want_reason) == \
        (1, gen.LOOP_EXIT_HOST)
    assert (buf[:, 1:] == PAD).all()


def test_decode_loop_budget_exit(ref):
    """``max_dec_len`` 3 in a 16-tick loop: three ticks run, the other
    13 iterations are masked, ``LOOP_EXIT_BUDGET``."""
    cfg = _cfg(gen.GenerationConfig, max_dec_len=3)
    srv = _port_admitted(ref["model"], cfg)
    lengths = srv._state.lengths.clone()
    buf, ticks, reason = gen.decode_loop(
        srv.model, srv._cache, srv._state, cfg, False, srv.seed,
        loop_ticks=16)
    want_buf, want_ticks, want_reason, want_dec = ref["budget"]
    np.testing.assert_array_equal(buf, want_buf)
    assert (ticks, reason) == (want_ticks, want_reason) == \
        (3, gen.LOOP_EXIT_BUDGET)
    assert srv._state.host.dec_count.tolist() == want_dec == [3, 3]
    assert (srv._state.lengths - lengths).tolist() == [3, 3]


def test_decode_loop_mid_loop_eos(ref):
    """A slot emitting EOS on the loop's fifth tick stops it there
    (``LOOP_EXIT_FINISHED``); the masked iterations after it commit
    nothing, the other slot's count included."""
    eos, want_buf, want_ticks, want_reason, want_fin = ref["eos"]
    cfg = _cfg(gen.GenerationConfig, eos_token_id=eos)
    srv = _port_admitted(ref["model"], cfg)
    buf, ticks, reason = gen.decode_loop(
        srv.model, srv._cache, srv._state, cfg, False, srv.seed,
        loop_ticks=8)
    np.testing.assert_array_equal(buf, want_buf)
    assert (ticks, reason) == (want_ticks, want_reason) == \
        (5, gen.LOOP_EXIT_FINISHED)
    assert srv._state.host.finished.tolist() == want_fin == [False, True]
    assert srv._state.host.dec_count.tolist() == [5, 5]
    assert (buf[:, 5:] == PAD).all()


@pytest.mark.parametrize("loop_ticks", [1, 4])
def test_verify_loop_matches_jax(ref, loop_ticks):
    """Verify loops: the same windows, counts, ticks and exit reason,
    an accepted draft run and a rejected one among them."""
    cfg = _cfg(gen.GenerationConfig, spec_method="ngram", spec_tokens=K)
    drafts, wbuf, cbuf, ticks, reason, dec = ref[("verify", loop_ticks)]
    srv = _port_admitted(ref["model"], cfg)
    w, c, t, r = gen.verify_loop(srv.model, srv._cache, srv._state, drafts,
                                 cfg, False, srv.seed, loop_ticks=loop_ticks)
    np.testing.assert_array_equal(w, wbuf)
    np.testing.assert_array_equal(c, cbuf)
    assert (t, r) == (ticks, reason)
    assert srv._state.host.dec_count.tolist() == dec
    assert int(c[0, 0]) == K + 1 and int(c[1, 0]) == 1


def test_verify_loop_rejects_bad_drafts_shape(ref):
    cfg = _cfg(gen.GenerationConfig, spec_method="ngram", spec_tokens=K)
    srv = _port_admitted(ref["model"], cfg)
    with pytest.raises(ValueError, match="tick axis"):
        gen.verify_loop(srv.model, srv._cache, srv._state,
                        np.zeros((2, 3, K)), cfg, False, loop_ticks=4)
    with pytest.raises(ValueError, match="loop_ticks"):
        gen.init_loop_carry(2, 0, cfg, srv._device)
