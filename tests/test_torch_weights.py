"""Weight bridge: JAX ``params`` -> the port's ``state_dict`` -> JAX is
bit-exact, for the scanned and the unrolled decoder, and the converted
dict loads into the port's model with the embedding tied."""

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (
    CPU, JaxGPT, jax_params, numpy_tree, tiny_kwargs,
)
from paddlefleetx_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
from paddlefleetx_tpu_torch.models.gpt.convert import (
    flax_from_torch_state_dict, torch_state_dict_from_flax,
)
from paddlefleetx_tpu_torch.models.gpt.model import build_model


@pytest.mark.parametrize("scan_layers", [True, False])
def test_round_trip_is_bit_exact(scan_layers):
    kw = tiny_kwargs(num_layers=3, scan_layers=scan_layers,
                     vocab_size=80, hidden_size=64, num_attention_heads=4)
    params = numpy_tree(jax_params(JaxGPT(JaxGPTConfig(**kw)), seed=1))
    cfg = GPTConfig(**kw)
    sd = torch_state_dict_from_flax(params, cfg)
    back = flax_from_torch_state_dict(sd, cfg)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    # the same weights load strictly into the port's module tree
    model = build_model(cfg, CPU, state_dict=sd)
    assert set(model.state_dict()) == set(sd)


def test_scanned_and_unrolled_give_one_state_dict():
    kw = tiny_kwargs(num_layers=2, hidden_size=64, num_attention_heads=4)
    scanned = numpy_tree(jax_params(
        JaxGPT(JaxGPTConfig(**{**kw, "scan_layers": True})), seed=2))
    cfg = GPTConfig(**kw)
    sd_scan = torch_state_dict_from_flax(scanned, cfg)
    unrolled = flax_from_torch_state_dict(sd_scan, cfg)   # decoder_{i}
    assert "decoder_1" in unrolled["gpt"]
    sd_unrolled = torch_state_dict_from_flax(unrolled, cfg)
    for key in sd_scan:
        assert torch.equal(sd_scan[key], sd_unrolled[key]), key


def test_layouts_and_tied_embedding():
    kw = tiny_kwargs(num_layers=1, vocab_size=50, hidden_size=64,
                     num_attention_heads=4)
    params = numpy_tree(jax_params(JaxGPT(JaxGPTConfig(**kw)), seed=3))
    cfg = GPTConfig(**kw)
    sd = torch_state_dict_from_flax(params, cfg)
    attn = params["gpt"]["decoder_0"]["self_attn"]
    qkv = attn["qkv_proj"]["kernel"]                   # [h, 3, nh, hd]
    w = sd["gpt.decoder.0.self_attn.qkv_proj.weight"].numpy()
    # output feature (i, head, d) of the fused projection
    np.testing.assert_array_equal(w[1 * 64 + 2 * 16 + 5], qkv[:, 1, 2, 5])
    out = attn["out_proj"]["kernel"]                   # [nh, hd, h]
    wo = sd["gpt.decoder.0.self_attn.out_proj.weight"].numpy()
    np.testing.assert_array_equal(wo[7, 3 * 16 + 9], out[3, 9, 7])
    model = build_model(cfg, CPU, state_dict=sd)
    np.testing.assert_array_equal(
        model.word_embeddings.detach().numpy(),
        params["gpt"]["embeddings"]["word_embeddings"])
    assert model.word_embeddings.shape == (50, 64)
