"""MoE serving with the int8 KV cache (``kv_cache_dtype: int8``): the
port's greedy rows of the tiny 8-expert model through the paged server
equal the JAX server's, token for token, each tick on the int8 instance
of kernel 6a. Under ``quant_execution: weight_only_int8`` (served in
``test_torch_moe_serving_quant.py``) only the attention's ``qkv_proj``
and ``out_proj`` are int8, as in the JAX package, whose quantized sites
are the ``<site>/kernel`` leaves: the expert stacks ``wi`` / ``wo`` and
the router stay in the compute dtype, in the port's state dict too."""

import pytest
import torch

from _moe_serving_ref import (
    MOE_KW, PAGED, interpret, jax_serve, moe_pair, port_serve, prompts,
)
from _torch_parity import CPU, tiny_kwargs
from paddlefleetx_tpu_torch.core.quantize import quantize_state_dict
from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
from paddlefleetx_tpu_torch.models.gpt.model import build_model

PROMPTS = prompts()


@pytest.fixture(scope="module")
def kv():
    """The port model with the int8 cache and the JAX paged server's
    rows of the seeded prompts."""
    with interpret():
        pair = moe_pair(kv_cache_dtype="int8")
        paged, _ = jax_serve(pair, PROMPTS, num_slots=2, **PAGED)
    return {"model": pair[2], "paged": paged}


def test_int8_kv_paged_server_matches_jax(kv):
    rows, summ = port_serve(kv["model"], PROMPTS, num_slots=2, **PAGED)
    assert rows == kv["paged"]
    c = summ["counters"]
    assert c["attention/flash_decode_paged_int8"] == \
        summ["decode_ticks"] * kv["model"].config.num_layers
    assert "quant/matmul" not in c


def test_quantized_sites_of_an_moe_model():
    """``build_model`` under ``quant_execution`` with an MoE model (its
    fp32 weights drawn from a seed, then ``quantize_state_dict``) holds
    int8 weights only at the attention projections, the JAX
    ``QUANT_SITES`` ``<site>/kernel`` leaves; the experts and the router
    stay in the compute dtype and pass through by reference."""
    cfg = GPTConfig(**tiny_kwargs(**MOE_KW,
                                  quant_execution="weight_only_int8"))
    state = build_model(cfg, CPU, seed=3).state_dict()
    int8_keys = {k for k, t in state.items() if t.dtype == torch.int8}
    assert int8_keys == {f"gpt.decoder.{i}.self_attn.{site}.weight"
                         for i in range(cfg.num_layers)
                         for site in ("qkv_proj", "out_proj")}
    for key in ("wi", "wo", "router_kernel"):
        assert state[f"gpt.decoder.0.moe_mlp.{key}"].dtype == torch.float32
    fp = {k: t.float() if t.dtype == torch.int8 else t
          for k, t in state.items() if not k.endswith("_scale")}
    quantized, report = quantize_state_dict(fp)
    assert {r["path"] for r in report} == int8_keys
    assert quantized["gpt.decoder.1.moe_mlp.wi"] is \
        fp["gpt.decoder.1.moe_mlp.wi"]
