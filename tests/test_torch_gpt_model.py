"""The port's GPT against the JAX ``GPTForPretraining`` on converted
weights: full-sequence logits (JAX flash forward kernel), cached prefill
logits (JAX dense cached prefill) and one ragged decode step (JAX
ragged decode kernel), fp32, no dropout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import build_pair, jax_counters, rng
from paddlefleetx_tpu_torch.models.gpt.model import init_kv_cache

ATOL = 1e-4


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("PFX_PALLAS_INTERPRET", "1")


@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=0, max_position_embeddings=136)


def test_full_sequence_logits(pair):
    jmodel, params, model = pair
    ids = rng(0).integers(0, 96, size=(2, 128))
    with jax_counters() as reg:
        ref = jmodel.apply({"params": params}, jnp.asarray(ids, jnp.int32))
        assert reg.counter("attention/flash") == 2       # one per layer
        assert reg.counter("attention/dense") == 0
    with torch.no_grad():
        got = model(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_cached_prefill_and_ragged_decode(pair):
    jmodel, params, model = pair
    cfg = model.config
    b, bucket = 3, 16
    lengths = np.asarray([5, 16, 9], np.int32)
    ids = rng(1).integers(0, 96, size=(b, bucket))
    with jax_counters() as reg:
        ref, mutated = jmodel.apply(
            {"params": params}, jnp.asarray(ids, jnp.int32), use_cache=True,
            mutable=["cache"])
        assert reg.counter("attention/fallback/kv_cache_layout") == 2
    cache = init_kv_cache(cfg, b, torch.device("cpu"))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    # the written cache rows equal the JAX cache (transposed)
    jk = np.asarray(mutated["cache"]["gpt"]["decoder_0"]["self_attn"][
        "cached_key"])                                   # [b, h, d, S]
    np.testing.assert_allclose(cache[0][0][:, :, :bucket].numpy(),
                               jk[..., :bucket].transpose(0, 1, 3, 2),
                               atol=ATOL)

    # one ragged decode step: each row writes and reads at its own length
    tok = rng(2).integers(0, 96, size=(b, 1))
    with jax_counters() as reg:
        ref2, _ = jmodel.apply(
            {"params": params, "cache": mutated["cache"]},
            jnp.asarray(tok, jnp.int32),
            position_ids=jnp.asarray(lengths)[:, None], use_cache=True,
            cache_lengths=jnp.asarray(lengths), mutable=["cache"])
        assert reg.counter("attention/flash_decode_ragged") == 2
        assert reg.counter("attention/dense") == 0
    with torch.no_grad():
        got2 = model(torch.from_numpy(tok),
                     torch.from_numpy(lengths).long()[:, None],
                     cache=cache, decode_offset=torch.from_numpy(lengths))
    np.testing.assert_allclose(got2.numpy(), np.asarray(ref2), atol=ATOL)


def test_dense_path_matches_flash_path(pair):
    """``use_flash_attention: False`` (the dense PyTorch path) gives the
    same logits as the kernel path's plain versions."""
    import dataclasses
    from paddlefleetx_tpu_torch.models.gpt.model import build_model
    _, _, model = pair
    dense = build_model(dataclasses.replace(model.config,
                                            use_flash_attention=False),
                        torch.device("cpu"), state_dict=model.state_dict())
    ids = torch.from_numpy(rng(3).integers(0, 96, size=(2, 40)))
    with torch.no_grad():
        np.testing.assert_allclose(model(ids).numpy(), dense(ids).numpy(),
                                   atol=ATOL)


def test_sequence_longer_than_positions_raises(pair):
    _, _, model = pair
    with pytest.raises(ValueError, match="max_position_embeddings"):
        model(torch.zeros((1, 137), dtype=torch.long))
