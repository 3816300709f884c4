"""Generation parity: the port's logits processors equal the JAX
package's (exact top-k), and the port's greedy lockstep ``generate()``
is token-exact against the JAX ``generate()`` on left-padded prompts of
mixed lengths, on the same weights."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import build_pair, jax_counters, rng
from paddlefleetx_tpu.models.gpt import generation as jax_gen
from paddlefleetx_tpu.models.gpt import processors as jax_proc
from paddlefleetx_tpu_torch.models.gpt import generation as gen
from paddlefleetx_tpu_torch.models.gpt import processors as proc

EOS = PAD = 95
PROMPTS = [[5, 9, 2, 7, 1], [11, 3], [4, 4, 8, 1, 2, 6, 9, 30, 31],
           [13, 2, 2], [1], [7, 8, 64, 70]]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("PFX_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("top_k,top_p", [
    (0, 1.0), (5, 1.0), (0, 0.8), (8, 0.9), (96, 0.5), (200, 0.9),
    (1, 0.3), (12, 0.999)])
def test_top_k_top_p_filter_matches_jax(top_k, top_p):
    logits = rng(top_k * 1000 + int(top_p * 100)).standard_normal(
        (4, 96)).astype(np.float32) * 3
    # ties at the k-th value must be kept on both sides
    logits[1, :6] = logits[1, 0]
    ref = np.asarray(jax_proc.top_k_top_p_filter(
        jnp.asarray(logits), top_k, top_p, approx=False))
    got = proc.top_k_top_p_filter(torch.from_numpy(logits), top_k,
                                  top_p).numpy()
    np.testing.assert_array_equal(got == proc.NEG_INF,
                                  ref == jax_proc.NEG_INF)
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_repetition_and_min_length_match_jax():
    r = rng(3)
    logits = r.standard_normal((3, 96)).astype(np.float32)
    appeared = r.random((3, 96)) < 0.2
    for penalty in (1.0, 1.3, 0.7):
        ref = jax_proc.repetition_penalty_processor(
            jnp.asarray(logits), jnp.asarray(appeared), penalty)
        got = proc.repetition_penalty_processor(
            torch.from_numpy(logits), torch.from_numpy(appeared), penalty)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    cur = np.asarray([[0], [2], [5]])
    ref = jax_proc.min_length_processor(jnp.asarray(logits),
                                        jnp.asarray(cur), 3, EOS)
    got = proc.min_length_processor(torch.from_numpy(logits),
                                    torch.from_numpy(cur), 3, EOS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=4, max_position_embeddings=72)


def test_greedy_generate_token_exact_vs_jax(pair):
    jmodel, params, model = pair
    ids, mask = gen.left_pad_batch(PROMPTS, PAD)
    jcfg = jax_gen.GenerationConfig(max_dec_len=10,
                                    decode_strategy="greedy_search",
                                    eos_token_id=EOS, pad_token_id=PAD)
    with jax_counters() as reg:
        ref = np.asarray(jax_gen.generate(
            jmodel, params, jnp.asarray(ids), jnp.asarray(mask),
            jax.random.key(0), jcfg))
        assert reg.counter("attention/flash_decode") >= 1
        assert reg.counter("attention/fallback/kernel_rejected") == 0
    pcfg = gen.GenerationConfig(max_dec_len=10,
                                decode_strategy="greedy_search",
                                eos_token_id=EOS, pad_token_id=PAD)
    got = gen.generate(model, ids, mask, pcfg).numpy()
    np.testing.assert_array_equal(got, ref)
    # num_return_sequences tiles each prompt; greedy copies agree
    tiled = gen.generate(model, ids[:2], mask[:2], dataclasses.replace(
        pcfg, num_return_sequences=2)).numpy()
    np.testing.assert_array_equal(tiled, np.repeat(ref[:2], 2, axis=0))


def test_sampling_is_seeded_and_filtered(pair):
    _, _, model = pair
    ids, mask = gen.left_pad_batch(PROMPTS[:3], PAD)
    cfg = gen.GenerationConfig(max_dec_len=6, decode_strategy="sampling",
                               top_k=4, top_p=0.9, temperature=0.8,
                               eos_token_id=EOS, pad_token_id=PAD)
    a = gen.generate(model, ids, mask, cfg, seed=11)
    b = gen.generate(model, ids, mask, cfg, seed=11)
    c = gen.generate(model, ids, mask, cfg, seed=12)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert a.shape == (3, 6) and int(a.max()) < 96


def test_unported_strategies_raise(pair):
    _, _, model = pair
    ids, mask = gen.left_pad_batch(PROMPTS[:2], PAD)
    with pytest.raises(NotImplementedError, match="beam"):
        gen.generate(model, ids, mask, gen.GenerationConfig(
            max_dec_len=2, decode_strategy="beam_search", num_beams=2))
    with pytest.raises(ValueError, match="max_position_embeddings"):
        gen.generate(model, ids, mask, gen.GenerationConfig(
            max_dec_len=70, decode_strategy="greedy_search"))
    with pytest.raises(ValueError):
        gen.GenerationConfig(decode_strategy="contrastive")


def test_stream_seed_separates_streams():
    """The device draw's uniform, keyed by (seed, stream, step), gives
    every (stream, step) pair of a seed its own value in [0, 1), and
    another seed other values."""
    import torch
    n, c = torch.meshgrid(torch.arange(20), torch.arange(20), indexing="ij")
    u = gen.stream_uniform(0, n.reshape(-1), c.reshape(-1))
    assert u.dtype == torch.float32 and u.shape == (400,)
    assert len(set(u.tolist())) == 400
    assert bool(((u >= 0) & (u < 1)).all())
    other = gen.stream_uniform(2 ** 63 - 1, n.reshape(-1), c.reshape(-1))
    assert not torch.equal(u, other)
