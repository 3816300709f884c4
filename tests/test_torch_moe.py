"""The port's MoE (``models/gpt/moe.py``) against the JAX package's.

Routing decisions (``_routing_plan``, ``router_dispatch``,
``sort_routing``) equal JAX's integer outputs exactly, with capacity
drops (``moe_capacity_factor`` 0.75) and top_k 1, 2 and E. ``MoEMLP`` in
each of its three modes equals the JAX einsum layer on the same weights
(output, aux and gradients, fp32 at 1e-5); a 2-layer MoE GPT built from
the 8x345M recipe cut to a tiny size equals the JAX ``GPTModule`` (train
loss with the router aux, eval loss without it, the chunked loss and
the gradients). ``save_dots`` keeps the expert GEMMs (the grouped GEMM's
op is in the policy's dot set, counted), the engine trains, the
converter carries the ``moe_mlp`` leaves both ways bit for bit, and the
refusals of this slice raise."""

import dataclasses
import functools
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_counters, jax_params, numpy_tree, rng
from paddlefleetx_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddlefleetx_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddlefleetx_tpu.models.gpt import moe as jax_moe
from paddlefleetx_tpu.models.gpt.modules import GPTModule as JaxGPTModule
from paddlefleetx_tpu.utils.config import get_config as jax_get_config
from paddlefleetx_tpu_torch.core.engine import Engine
from paddlefleetx_tpu_torch.core.serving import GenerationServer
from paddlefleetx_tpu_torch.models.gpt import moe
from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
from paddlefleetx_tpu_torch.models.gpt.convert import (
    flax_from_torch_state_dict, torch_state_dict_from_flax,
)
from paddlefleetx_tpu_torch.models.gpt.generation import (
    GenerationConfig, generate,
)
from paddlefleetx_tpu_torch.models.gpt.model import build_model
from paddlefleetx_tpu_torch.models.gpt.modules import GPTModule
from paddlefleetx_tpu_torch.observability import metrics
from paddlefleetx_tpu_torch.ops.cuda import grouped_matmul as gmm
from paddlefleetx_tpu_torch.utils.config import get_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "nlp", "gpt",
                      "pretrain_moe_gpt_8x345M_ep8.yaml")
#: fp32 layer and model parity: the same products in another order
RTOL, ATOL = 1e-5, 1e-5
#: the layer tests' MoE (the JAX test_moe.py geometry)
MOE_KW = dict(vocab_size=64, hidden_size=16, num_layers=2,
              num_attention_heads=4, max_position_embeddings=32,
              hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
              moe_num_experts=4, moe_top_k=2, moe_capacity_factor=0.75,
              moe_z_loss_weight=1e-3)
#: the 8x345M recipe on one device at a tiny size, fp32, dropout 0
TINY = ["Model.num_layers=2", "Model.hidden_size=128",
        "Model.num_attention_heads=2", "Model.ffn_hidden_size=256",
        "Model.vocab_size=96", "Model.max_position_embeddings=64",
        "Model.moe_num_experts=4", "Model.hidden_dropout_prob=0.0",
        "Model.attention_probs_dropout_prob=0.0",
        "Model.initializer_range=0.05", "Model.use_flash_attention=False",
        "Engine.mix_precision.use_pure_fp16=False",
        "Global.local_batch_size=2", "Global.micro_batch_size=2",
        "Data.Train.dataset.max_seq_len=64", "Distributed.dp_degree=1",
        "Distributed.sharding.sharding_degree=1", "Distributed.ep_degree=1"]


@pytest.fixture
def port_counters():
    reg = metrics.get_registry()
    metrics.set_enabled(True)
    reg.reset()
    yield reg
    reg.reset()
    metrics.set_enabled(False)


def _probs(b, s, n_exp, seed):
    logits = rng(seed).normal(size=(b, s, n_exp)).astype(np.float32) * 2
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("top_k,cf", [(1, 0.75), (2, 0.75), (2, 1.25),
                                      (4, 0.75)])
def test_routing_equals_jax(top_k, cf):
    """Every integer routing output equal to JAX's, drops included; the
    gates and the combine weights to fp32 rounding."""
    b, s, n_exp = 2, 16, 4
    cap = int(np.ceil(top_k * s * cf / n_exp))
    p = _probs(b, s, n_exp, 10 + top_k)
    pj, pt = jnp.asarray(p), torch.from_numpy(p)
    want = jax_moe._routing_plan(pj, top_k, cap)
    got = moe._routing_plan(pt, top_k, cap)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6)
    for a, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
    # some choices were dropped, and none at the ample capacity
    assert got[3].all().item() == (cf > 1)
    d, c, f = moe.router_dispatch(pt, top_k, cap)
    dj, cj, fj = jax_moe.router_dispatch(pj, top_k, cap)
    np.testing.assert_array_equal(d.numpy(), np.asarray(dj))
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), rtol=1e-6)
    np.testing.assert_array_equal(f.numpy(), np.asarray(fj))
    got = moe.sort_routing(pt, top_k, cap)
    want = jax_moe.sort_routing(pj, top_k, cap)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6)
    for a, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))


def _layer_input():
    return rng(11).normal(size=(4, 16, 16)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_layer(top_k):
    """The JAX einsum layer's weights, output, aux, loss and grads on
    :func:`_layer_input`."""
    x = _layer_input()
    layer = jax_moe.MoEMLP(JaxGPTConfig(**dict(MOE_KW, moe_top_k=top_k)))
    params = nn.meta.unbox(jax.jit(layer.init)(
        {"params": jax.random.key(2)}, jnp.asarray(x)))["params"]

    def loss(p, xx):
        y, aux = layer.apply({"params": p}, xx)
        return (y ** 2).sum() + aux, (y, aux)
    (val, (y, aux)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    return numpy_tree(params), float(val), np.asarray(y), float(aux), \
        numpy_tree(grads)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("mode", ["einsum", "sort", "sort_pallas"])
def test_layer_equals_jax(port_counters, mode, top_k):
    x = _layer_input()
    params, want_loss, want_y, want_aux, (pgrads, xgrad) = _jax_layer(top_k)
    layer = moe.MoEMLP(GPTConfig(**dict(MOE_KW, moe_top_k=top_k,
                                        moe_dispatch=mode)))
    layer.load_state_dict({k: torch.tensor(v) for k, v in params.items()})
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = layer(xt)
    loss = (y ** 2).sum() + aux
    loss.backward()
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=RTOL,
                               atol=ATOL)
    assert float(aux.detach()) == pytest.approx(want_aux, rel=RTOL)
    assert float(loss.detach()) == pytest.approx(want_loss, rel=RTOL)
    np.testing.assert_allclose(xt.grad.numpy(), xgrad, rtol=RTOL, atol=ATOL)
    for name, p in layer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), pgrads[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    assert port_counters.counter("moe/" + mode) == 1
    assert not [k for k in port_counters.snapshot()["counters"]
                if k.startswith("moe/fallback/")]


@pytest.mark.parametrize("mode", ["einsum", "sort", "sort_pallas"])
def test_all_tokens_dropped_is_pure_residual(monkeypatch, mode):
    """Capacity forced to 0: every choice drops, the layer's output is
    exactly zero (the block keeps its residual alone) and the router
    loss stays finite."""
    monkeypatch.setattr(moe, "expert_capacity", lambda cfg, s: 0)
    layer = moe.MoEMLP(GPTConfig(**dict(MOE_KW, moe_dispatch=mode)))
    for p in layer.parameters():
        p.data.normal_()
    x = torch.from_numpy(rng(3).normal(size=(2, 8, 16)).astype(np.float32))
    y, aux = layer(x)
    np.testing.assert_array_equal(y.detach().numpy(), 0.0)
    assert np.isfinite(float(aux)) and float(aux) > 0


def _batch(b=2, s=64, vocab=96):
    r = rng(21)
    tokens = r.integers(0, vocab, (b, s))
    labels = r.integers(0, vocab, (b, s))
    mask = (r.random((b, s)) > 0.2).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s)).copy()
    return tokens, pos, labels, mask


@functools.lru_cache(maxsize=None)
def _jax_model(chunks):
    """The JAX GPTModule's weights, train loss, eval loss and gradients
    on :func:`_batch` (einsum lowering, ``loss_chunks`` ``chunks``)."""
    jmod = JaxGPTModule(jax_get_config(
        CONFIG, TINY + [f"Model.loss_chunks={chunks}",
                        "Model.moe_dispatch=einsum"], nranks=1))
    params = jax_params(jmod.model)
    jbatch = tuple(jnp.asarray(x) for x in _batch())
    with jax_counters() as reg:
        loss, grads = jax.jit(jax.value_and_grad(lambda p: jmod.loss_fn(
            p, jbatch, jax.random.key(1), train=True)))(params)
        assert reg.counter("moe/einsum") > 0
    ev = jax.jit(lambda p: jmod.loss_fn(p, jbatch, jax.random.key(1),
                                        train=False))(params)
    return numpy_tree(params), float(loss), float(ev), numpy_tree(grads)


@pytest.mark.parametrize("mode,chunks", [("sort_pallas", 1),
                                         ("sort_pallas", 2), ("sort", 1)])
def test_model_loss_and_grads_equal_jax(port_counters, mode, chunks):
    """The recipe's 2-layer cut (save_dots, fp32): the port's train loss
    (CE + router aux), eval loss (pure CE) and gradients in each sort
    mode equal the JAX GPTModule's through its reference einsum
    lowering (the JAX modes agree, its tests/test_moe.py)."""
    over = TINY + [f"Model.loss_chunks={chunks}"]
    params, jloss, jeval, jgrads = _jax_model(chunks)
    cfg = get_config(CONFIG, over + [f"Model.moe_dispatch={mode}"])
    state = torch_state_dict_from_flax(params, GPTConfig.from_config(cfg))
    module = GPTModule(cfg, device="cpu", state_dict=state)
    assert module.model_config.recompute_granularity == "save_dots"
    batch = tuple(torch.from_numpy(np.asarray(x)) for x in _batch())
    loss = module.loss_fn(module.model, batch, seed=0, train=True)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=RTOL)
    with torch.no_grad():
        ev = module.loss_fn(module.model, batch, seed=0, train=False)
    assert float(ev) == pytest.approx(jeval, rel=RTOL)
    assert float(loss.detach()) - float(ev) > 1e-4   # aux: train only
    assert port_counters.counter("moe/" + mode) > 0
    got = flax_from_torch_state_dict(
        {n: p.grad for n, p in module.model.named_parameters()},
        module.model_config)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(jgrads))
    assert len(flat_got) == len(flat_want)
    for path, g in flat_got:
        np.testing.assert_allclose(g, flat_want[path], rtol=RTOL, atol=ATOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("granularity,per_layer", [("save_dots", 4),
                                                   ("full", 6)])
def test_save_dots_keeps_the_expert_gemms(monkeypatch, granularity,
                                          per_layer):
    """Kernel 8 runs 2 forward + 2 dx a layer under ``save_dots`` (the
    policy keeps the grouped GEMM's output), 2 more under ``full`` (the
    block recomputes); kernel 9 twice a layer either way. The plain
    versions stand in for the kernels here."""
    calls = {"gmm": 0, "dw": 0}
    fwd, dw = gmm.grouped_matmul_reference, gmm.grouped_matmul_dw_reference

    def count(key, fn):
        def shim(*args):
            calls[key] += 1
            return fn(*args)
        return shim
    monkeypatch.setattr(gmm, "grouped_matmul_reference", count("gmm", fwd))
    monkeypatch.setattr(gmm, "grouped_matmul_dw_reference", count("dw", dw))
    cfg = get_config(CONFIG, TINY + [
        f"Model.recompute_granularity={granularity}",
        "Model.hidden_size=64", "Model.num_attention_heads=1"])
    module = GPTModule(cfg, device="cpu")
    batch = tuple(torch.from_numpy(np.asarray(x)) for x in _batch(s=32))
    module.loss_fn(module.model, batch, seed=0, train=True).backward()
    layers = module.model_config.num_layers
    assert calls == {"gmm": per_layer * layers, "dw": 2 * layers}


def test_engine_trains_three_steps():
    """Three optimizer steps of the tiny recipe (bf16 autocast, dropout
    on) on one batch: the loss falls."""
    over = [o for o in TINY if "dropout" not in o and "fp16" not in o]
    cfg = get_config(CONFIG, over + [
        "Model.hidden_size=64", "Model.num_attention_heads=1",
        "Optimizer.lr.warmup_rate=0.0", "Optimizer.lr.max_lr=1e-2",
        "Optimizer.lr.decay_steps=100"])
    module = GPTModule(cfg, device="cpu")
    assert module.model_config.dtype == "bfloat16"
    engine = Engine(cfg, module, device="cpu")
    batch = _batch(s=32)
    losses = [float(engine.train_step(batch)[0]) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[2] < losses[0]


def test_converter_round_trip_is_bit_exact():
    """The scanned JAX tree -> port -> scanned and unrolled JAX trees ->
    port, every leaf bit for bit."""
    kw = dict(MOE_KW, scan_layers=True)
    params = numpy_tree(nn.meta.unbox(jax.jit(JaxGPT(JaxGPTConfig(**kw)).init)(
        {"params": jax.random.key(0)}, jnp.zeros((1, 8), jnp.int32))
        ["params"]))
    cfg = GPTConfig(**kw)
    state = torch_state_dict_from_flax(params, cfg)
    assert state["gpt.decoder.1.moe_mlp.wi"].shape == (4, 16, 64)
    assert "gpt.decoder.0.linear1.weight" not in state
    back = flax_from_torch_state_dict(state, cfg)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(params),
                                jax.tree_util.tree_leaves_with_path(back)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
    unrolled = dataclasses.replace(cfg, scan_layers=False)
    tree = flax_from_torch_state_dict(state, unrolled)
    assert set(tree["gpt"]["decoder_1"]["moe_mlp"]) == {
        "router_kernel", "wi", "wi_bias", "wo", "wo_bias"}
    again = torch_state_dict_from_flax(tree, unrolled)
    assert again.keys() == state.keys()
    for name, t in state.items():
        assert torch.equal(again[name], t), name
    model = build_model(cfg, torch.device("cpu"), state_dict=state,
                        train=True)
    assert model.gpt.decoder[0].moe_mlp.router_kernel.shape == (16, 4)


def test_refusals():
    """``ep_degree > 1``, LoRA beside MoE and bad MoE knobs raise;
    serving an MoE model does not (``test_torch_moe_serving*.py`` hold
    its rows to the JAX package's)."""
    cfg = get_config(CONFIG, TINY[:-1] + ["Distributed.ep_degree=2"])
    module = GPTModule(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ep_degree"):
        Engine(cfg, module, device="cpu")
    with pytest.raises(ValueError, match="incompatible"):
        GPTConfig(**dict(MOE_KW, lora_rank=4, lora_num_adapters=2))
    for bad in ({"moe_top_k": 5}, {"moe_top_k": 0},
                {"moe_capacity_factor": 0.0}, {"moe_dispatch": "ragged"}):
        with pytest.raises(ValueError):
            GPTConfig(**dict(MOE_KW, **bad))
    model = build_model(GPTConfig(**MOE_KW), torch.device("cpu"))
    gen = GenerationConfig(max_dec_len=4, decode_strategy="greedy_search",
                           eos_token_id=63, pad_token_id=63)
    done = GenerationServer(model, gen, num_slots=2).run([[1, 2, 3]])
    assert done[0].finish_reason in ("eos", "length")
    assert generate(model, np.zeros((1, 4), np.int64), None,
                    gen).shape == (1, 4)
