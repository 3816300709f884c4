"""The device-resident loop on the port's other server modes against the
JAX package's servers at the same T, greedy, fp32 weights: the int8 KV
cache at T = 16 (contiguous and paged, and paged with weight-only int8
too), the 8x345M recipe's MoE routing paged at T = 4, and multi-tenant
LoRA at T = 4 (adapter 0 against the base model, and three adapters
mixed with the base in one loop). On the CPU every loop iteration runs
eagerly, masked ones included, so each kernel's dispatch counter fires
once a layer and iteration."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest

from _moe_serving_ref import (
    PAGED, interpret, jax_serve, moe_pair, port_counters, prompts, serve,
)
from _torch_parity import CPU, build_pair, build_quant_pair, jax_counters
from _torch_parity import tiny_kwargs
from paddlefleetx_tpu.core.serving import GenerationServer as JaxServer
from paddlefleetx_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddlefleetx_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddlefleetx_tpu.models.gpt import generation as jax_gen
from paddlefleetx_tpu_torch.core.serving import GenerationServer
from paddlefleetx_tpu_torch.models.gpt import generation as gen
from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
from paddlefleetx_tpu_torch.models.gpt.convert import (
    flax_from_torch_state_dict,
)
from paddlefleetx_tpu_torch.models.gpt.model import build_model

EOS = PAD = 95
PROMPTS = [[5, 9, 2, 7, 1], [11, 3], [4, 4, 8, 1, 2, 6, 9],
           [13, 2, 2], [1], [7, 8]]


def _cfg(cls, **kw):
    return cls(**dict(dict(max_dec_len=8, decode_strategy="greedy_search",
                           eos_token_id=EOS, pad_token_id=PAD), **kw))


def _forwards(summ, paged):
    """Model forwards of a loop server on the CPU: every iteration
    launched, plus each prefill chunk or admission."""
    return summ["ticks_replayed"] + summ["graph_warmups"] + (
        summ["prefill_chunks"] if paged else summ["admitted"])


@pytest.mark.parametrize("mode", ["kv", "kv_paged", "kv+quant_paged"])
def test_int8_loop_matches_jax(mode):
    """int8 KV at T = 16: the JAX server's rows, exits and ticks, each
    iteration one int8 decode dispatch a layer."""
    kw = dict(max_position_embeddings=256, kv_cache_dtype="int8")
    jmodel, params, model = (build_quant_pair if "quant" in mode
                             else build_pair)(seed=7, **kw)
    paged = mode.endswith("paged")
    skw = dict(num_slots=2, device_loop_ticks=16,
               **({"page_size": 128, "prefill_chunk_pages": 1}
                  if paged else {}))
    with interpret(), jax_counters() as reg:
        jsrv = JaxServer(jmodel, params, _cfg(jax_gen.GenerationConfig),
                         **skw)
        want = [c.tokens for c in jsrv.run(PROMPTS)]
        assert reg.counter("attention/flash_decode_" +
                           ("paged_int8" if paged else "ragged_int8")) >= 1
    jsum = jsrv.summary()
    with port_counters() as preg:
        srv = GenerationServer(model, _cfg(gen.GenerationConfig), **skw)
        rows = [c.tokens for c in srv.run(PROMPTS)]
        summ = srv.summary()
        name = "attention/flash_decode_" + ("paged_int8" if paged
                                            else "ragged_int8")
        assert preg.counter(name) == \
            summ["ticks_replayed"] * model.config.num_layers
        if "quant" in mode:
            assert preg.counter("quant/matmul") == \
                4 * model.config.num_layers * _forwards(summ, paged)
    assert rows == want
    for key in ("device_ticks", "host_roundtrips", "decode_tokens"):
        assert summ[key] == jsum[key]


def test_moe_paged_loop_matches_jax():
    """The MoE model paged at T = 4: the JAX server's rows at T = 4 (an
    MoE row depends on the server mode, so T = 4 is held to T = 4), the
    experts run once a layer and forward through kernel 8's route."""
    work = prompts()
    skw = dict(num_slots=3, device_loop_ticks=4, **PAGED)
    with interpret():
        pair = moe_pair()
        want, jsum = jax_serve(pair, work, **skw)
    model = pair[2]
    with port_counters() as reg:
        srv = GenerationServer(model, _cfg(gen.GenerationConfig), **skw)
        rows = serve(srv, work)
        summ = srv.summary()
        assert reg.counter("moe/sort_pallas") == \
            _forwards(summ, True) * model.config.num_layers
    assert rows == want
    assert summ["device_ticks"] == jsum["device_ticks"]
    assert summ["host_roundtrips"] == jsum["host_roundtrips"]
    srv.check_alloc()


LORA = dict(lora_rank=4, lora_num_adapters=4)


def _lora_models():
    """``(lora_model, base_model)`` with the same base weights."""
    from _torch_parity import rng
    from paddlefleetx_tpu_torch.core.adapters import extract_adapter
    cfg = GPTConfig(**tiny_kwargs(**LORA))
    lora = build_model(cfg, CPU, seed=0)
    base = build_model(dataclasses.replace(cfg, lora_rank=0,
                                           lora_num_adapters=0), CPU,
                       state_dict={k: v for k, v in lora.state_dict().items()
                                   if "_lora." not in k})
    shapes = {k: tuple(v.shape) for k, v in extract_adapter(lora, 0).items()}

    def source(aid):
        g = rng(1000 + int(aid))
        return {k: g.normal(0.0, 0.2, s).astype("float32")
                for k, s in shapes.items()}
    return lora, base, source


@pytest.mark.parametrize("paged", [False, True])
def test_lora_loop_matches_jax(paged):
    """LoRA at T = 4: adapter 0 everywhere gives the base model's rows,
    and adapters 1-3 mixed with the base in one loop give the JAX
    server's rows at T = 4 and the port's own at T = 1, each forward one
    grouped delta a site."""
    lora, base, source = _lora_models()
    skw = dict(num_slots=4, device_loop_ticks=4,
               **({"page_size": 128, "prefill_chunk_pages": 1}
                  if paged else {}))
    cfg = _cfg(gen.GenerationConfig, max_dec_len=5)
    ids = [1, 2, 3, 0, 2, 1]
    with port_counters() as reg:
        srv = GenerationServer(lora, cfg, adapter_source=source, **skw)
        zero = [c.tokens for c in srv.run(PROMPTS)]
        assert zero == [c.tokens for c in GenerationServer(
            base, cfg, **skw).run(PROMPTS)]
        reg.reset()
        srv = GenerationServer(lora, cfg, adapter_source=source, **skw)
        mixed = [c.tokens for c in srv.run(PROMPTS, adapter_ids=ids)]
        summ = srv.summary()
        # q/k/v, out, fc1 and fc2 in every layer of every forward
        assert reg.counter("lora/grouped") == \
            4 * lora.config.num_layers * _forwards(summ, paged)
        assert reg.counter("lora/fallback") == 0
    assert mixed != zero
    t1 = GenerationServer(lora, cfg, adapter_source=source,
                          **dict(skw, device_loop_ticks=1))
    assert [c.tokens for c in t1.run(PROMPTS, adapter_ids=ids)] == mixed
    jsrv = JaxServer(JaxGPT(JaxGPTConfig(**tiny_kwargs(**LORA))),
                     jax.tree.map(jnp.asarray, flax_from_torch_state_dict(
                         lora.state_dict(), lora.config)),
                     _cfg(jax_gen.GenerationConfig, max_dec_len=5),
                     adapter_source=source, **skw)
    assert [c.tokens for c in jsrv.run(PROMPTS, adapter_ids=ids)] == mixed
