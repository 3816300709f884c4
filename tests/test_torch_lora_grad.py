"""Gradients through the LoRA banks over an int8 base, and the frozen-base
fine-tune, against the JAX package.

The JAX engine cannot train over an int8 base (``jax.grad`` refuses int8
inputs), so the reference for the port's backward through kernel 7's dx
route is ``jax.grad`` of the JAX model's loss with respect to its
floating leaves (banks, biases, LayerNorms, embeddings), the int8
kernels and their scales closed over: the JAX side runs
``_quantized_matmul_bwd`` and the grouped GEMM's VJP (Pallas in
interpret mode). The fine-tune reproduces the JAX engine's LoRA run:
the base bit-frozen with no optimizer state, and, since the training
forward passes no adapter ids in either package, ``lora_b`` staying 0
while weight decay alone moves ``lora_a``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from _torch_parity import CPU, jax_counters, numpy_tree, rng, tiny_kwargs
from paddlefleetx_tpu.core import Engine as JaxEngine
from paddlefleetx_tpu.core.quantize import quantize_param_tree
from paddlefleetx_tpu.data import build_dataloader as jax_build_dataloader
from paddlefleetx_tpu.models import build_module as jax_build_module
from paddlefleetx_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddlefleetx_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddlefleetx_tpu.utils.config import get_config as jax_get_config
from paddlefleetx_tpu_torch.core.engine import Engine
from paddlefleetx_tpu_torch.data import build_dataloader
from paddlefleetx_tpu_torch.data.synthetic import write_corpus
from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
from paddlefleetx_tpu_torch.models.gpt.convert import (
    flax_from_torch_state_dict, torch_state_dict_from_flax,
)
from paddlefleetx_tpu_torch.models.gpt.model import (
    build_model, cross_entropy_loss,
)
from paddlefleetx_tpu_torch.models.gpt.modules import GPTModule
from paddlefleetx_tpu_torch.ops.cuda import quantized_matmul as qmm
from paddlefleetx_tpu_torch.utils.config import get_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "nlp", "gpt",
                      "pretrain_gpt_345M_single_card.yaml")
LORA = dict(lora_rank=4, lora_num_adapters=3)
#: gradients normwise per leaf, loss relative: fp32 (the same products
#: summed in another order) and bf16 (both packages round to bf16 at
#: their own places)
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 2e-2)}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("PFX_PALLAS_INTERPRET", "1")


@pytest.fixture(scope="module")
def int8_lora_tree():
    """JAX params of a 2-layer LoRA GPT over an int8 base: the port's
    seeded fp32 weights with tinted ``lora_b`` banks, quantized by the
    JAX package's PTQ."""
    kw = tiny_kwargs(**LORA)
    model = build_model(GPTConfig(**kw), CPU, seed=0)
    g = rng(1)
    sd = model.state_dict()
    for k in sd:
        if k.endswith("lora_b"):
            sd[k] = torch.from_numpy(
                g.normal(0.0, 0.2, sd[k].shape).astype(np.float32))
    qparams, _ = quantize_param_tree(numpy_tree(
        flax_from_torch_state_dict(sd, model.config)))
    return numpy_tree(qparams)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_floating_leaf_grads_over_int8_base_equal_jax(int8_lora_tree,
                                                     dtype):
    """With mixed adapter ids, the port's loss and the gradient of every
    floating leaf (through kernel 7's dx route and the grouped GEMM's
    dx / dw) equal ``jax.grad`` over the JAX model's floating subtree,
    normwise per leaf; the JAX side ran its int8 kernel and grouped
    LoRA kernel at every site."""
    qparams = int8_lora_tree
    kw = tiny_kwargs(**LORA, quant_execution="weight_only_int8",
                     dtype=dtype)
    ids = rng(2).integers(0, 96, (3, 16))
    labels = rng(3).integers(0, 96, (3, 16))
    aid = np.asarray([1, 0, 2], np.int32)

    flat = traverse_util.flatten_dict(qparams)
    fixed = {k: v for k, v in flat.items()
             if v.dtype == np.int8 or k[-1] == "kernel_scale"}
    free = {k: jnp.asarray(v) for k, v in flat.items() if k not in fixed}
    jmodel = JaxGPT(JaxGPTConfig(**kw))

    def loss_fn(free):
        params = traverse_util.unflatten_dict({**fixed, **free})
        logits = jmodel.apply({"params": params}, jnp.asarray(ids),
                              adapter_ids=jnp.asarray(aid))
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        return -jnp.take_along_axis(logp, jnp.asarray(labels)[..., None],
                                    axis=-1).mean()

    with jax_counters() as reg:
        jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(free)
        assert reg.counter("quant/matmul") == 4 * 2
        assert reg.counter("quant/fallback/kernel_rejected") == 0
        assert reg.counter("lora/grouped") == 4 * 2
    cfg = GPTConfig(**kw)
    model = build_model(cfg, CPU, state_dict=torch_state_dict_from_flax(
        qparams, cfg))
    logits = model(torch.from_numpy(ids), adapter_ids=torch.from_numpy(aid))
    loss = cross_entropy_loss(logits, torch.from_numpy(labels),
                              torch.ones(labels.shape))
    loss.backward()
    assert qmm.quantized_matmul.dx_launches == 0     # the CPU: plain
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert all(g is not None for g in grads.values())
    # the JAX gradients in the port's layout (the closed-over int8 leaves
    # ride along only to complete the tree)
    want = torch_state_dict_from_flax(traverse_util.unflatten_dict(
        {**fixed, **numpy_tree(jgrads)}), cfg)
    leaf_tol, loss_tol = TOL[dtype]
    assert abs(loss.item() - float(jloss)) <= loss_tol * abs(float(jloss))
    assert len(grads) == len(free)
    for name, got in grads.items():
        ref = want[name].float()
        rel = float((got.float() - ref).norm() / ref.norm().clamp_min(1e-30))
        assert rel <= leaf_tol, (name, rel)
    lora_b = [n for n in grads if n.endswith("lora_b")]
    assert lora_b and all(float(grads[n].abs().sum()) > 0 for n in lora_b)


def _over(data_dir, out_dir):
    over = {
        "Model.num_layers": 2, "Model.hidden_size": 32,
        "Model.num_attention_heads": 4, "Model.ffn_hidden_size": 64,
        "Model.vocab_size": 128, "Model.max_position_embeddings": 64,
        "Model.hidden_dropout_prob": 0.0,
        "Model.attention_probs_dropout_prob": 0.0,
        "Model.use_recompute": False, "Model.loss_chunks": 1,
        "Model.use_flash_attention": False,
        "Model.lora_rank": 4, "Model.lora_num_adapters": 2,
        "Engine.mix_precision.use_pure_fp16": False,
        "Engine.max_steps": 3, "Engine.logging_freq": 1,
        "Engine.eval_freq": 100, "Engine.eval_iters": 1,
        "Engine.save_load.save_steps": 100,
        "Engine.save_load.output_dir": out_dir,
        "Global.local_batch_size": 4, "Global.micro_batch_size": 2,
        "Optimizer.lr.decay_steps": 100, "Optimizer.lr.warmup_rate": 0.01,
        "Optimizer.lr.max_lr": 0.01, "Optimizer.lr.min_lr": 0.001,
    }
    for mode in ("Train", "Eval"):
        over[f"Data.{mode}.dataset.input_dir"] = data_dir
        over[f"Data.{mode}.dataset.max_seq_len"] = 32
        over[f"Data.{mode}.dataset.eos_id"] = 127
    return [f"{k}={v}" for k, v in over.items()]


def test_finetune_freezes_the_base_as_jax_does(tmp_path):
    """Three steps of ``Engine.fit`` with ``lora_rank`` 4 from the JAX
    engine's initial weights: the base stays bit for bit, optimizer
    state exists for the banks alone, ``lora_b`` stays exactly 0 (no
    adapter ids in the training forward, as in JAX), ``lora_a`` equals
    the JAX engine's after the same steps, and the losses and the
    logged gradient norms (over every leaf) equal the JAX engine's."""
    data = str(tmp_path / "data")
    write_corpus(data, 128, 30000, seed=1)
    jcfg = jax_get_config(CONFIG, _over(data, str(tmp_path / "jout")),
                          nranks=1)
    jmodule = jax_build_module(jcfg)
    jengine = JaxEngine(jcfg, jmodule, mode="train",
                        devices=jax.devices()[:1])
    jloader = jax_build_dataloader(jcfg.Data, "Train")
    jloader.batch_sampler.batch_size = jcfg.Global.global_batch_size
    init = numpy_tree(jengine.state["params"])
    jlogs = []
    orig = jmodule.training_step_end
    jmodule.training_step_end = lambda log: (jlogs.append(dict(log)),
                                             orig(log))
    jengine.fit(epoch=1, train_data_loader=jloader)
    jfinal = numpy_tree(jengine.state["params"])

    cfg = get_config(CONFIG, _over(data, str(tmp_path / "out")))
    mcfg = GPTConfig.from_config(cfg)
    assert mcfg.lora_rank == 4
    module = GPTModule(cfg, state_dict=torch_state_dict_from_flax(init, mcfg),
                       device="cpu")
    engine = Engine(cfg, module, device="cpu")
    loader = build_dataloader(cfg.Data, "Train")
    loader.batch_sampler.batch_size = cfg.Global.global_batch_size
    before = {k: v.clone() for k, v in engine.model.state_dict().items()}
    lora_bytes = sum(v.numel() * v.element_size() for k, v in before.items()
                     if "_lora." in k)
    assert lora_bytes > 0
    engine.fit(epoch=1, train_data_loader=loader)
    after = engine.model.state_dict()
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    assert moved and all("_lora.lora_a" in k for k in moved), moved
    assert all(float(after[k].abs().sum()) == 0 for k in after
               if k.endswith("lora_b"))
    state = engine.optimizer.state_dict()["state"]
    opt_bytes = sum(t.numel() * t.element_size() for s in state.values()
                    for t in s.values() if torch.is_tensor(t))
    assert 0 < opt_bytes <= 2 * lora_bytes + 4096
    want = torch_state_dict_from_flax(jfinal, mcfg)
    for k in moved:
        np.testing.assert_allclose(after[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-8, err_msg=k)
    assert len(engine.history) == len(jlogs) == 3
    np.testing.assert_allclose([h["loss"] for h in engine.history],
                               [j["loss"] for j in jlogs], rtol=1e-5)
    np.testing.assert_allclose([h["grad_norm"] for h in engine.history],
                               [j["grad_norm"] for j in jlogs], rtol=1e-4)
