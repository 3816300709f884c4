"""Shared set-up of the engine-level parity tests of the port
(``tests/test_torch_{auto,prefetch,checkpoint_async,preemption,
telemetry}.py``): a tiny configuration of a recipe as ``-o`` overrides,
a seeded corpus, and the port's and the JAX package's engines built on
it from the same weights, each with its Train loader. The JAX package is
imported inside the functions that build its side, so a file that uses
only the port's side also runs on the card, where JAX is not
installed."""

import os

from paddlefleetx_tpu_torch.core.engine import Engine
from paddlefleetx_tpu_torch.data import build_dataloader
from paddlefleetx_tpu_torch.data.synthetic import write_corpus
from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
from paddlefleetx_tpu_torch.models.gpt.convert import (
    torch_state_dict_from_flax,
)
from paddlefleetx_tpu_torch.models.gpt.modules import GPTModule
from paddlefleetx_tpu_torch.utils.config import get_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "nlp", "gpt",
                      "pretrain_gpt_345M_single_card.yaml")
AUTO_CONFIG = os.path.join(ROOT, "configs", "nlp", "gpt", "auto",
                           "pretrain_gpt_345M_single_card.yaml")
VOCAB = 128


def corpus(path, tokens=30000, seed=1):
    """A seeded token corpus in ``path``; returns ``path``."""
    write_corpus(str(path), VOCAB, tokens, seed=seed)
    return str(path)


def tiny_over(data_dir, out_dir, **extra):
    """``-o`` overrides cutting a GPT pretraining recipe to 2 layers,
    hidden 32, fp32, no dropout, batch 4 x 32, 3 steps, on the corpus in
    ``data_dir``, saving under ``out_dir``; ``extra`` on top."""
    over = {
        "Model.num_layers": 2, "Model.hidden_size": 32,
        "Model.num_attention_heads": 4, "Model.ffn_hidden_size": 64,
        "Model.vocab_size": VOCAB, "Model.max_position_embeddings": 64,
        "Model.hidden_dropout_prob": 0.0,
        "Model.attention_probs_dropout_prob": 0.0,
        "Model.use_recompute": False, "Model.loss_chunks": 1,
        "Model.use_flash_attention": False,
        "Engine.mix_precision.use_pure_fp16": False,
        "Engine.max_steps": 3, "Engine.logging_freq": 1,
        "Engine.eval_freq": 100, "Engine.eval_iters": 1,
        "Engine.save_load.save_steps": 100,
        "Engine.save_load.output_dir": out_dir,
        "Global.global_batch_size": 4, "Global.local_batch_size": 4,
        "Global.micro_batch_size": 4,
        "Optimizer.lr.decay_steps": 100, "Optimizer.lr.warmup_rate": 0.01,
        "Optimizer.lr.max_lr": 0.01, "Optimizer.lr.min_lr": 0.001,
    }
    for mode in ("Train", "Eval"):
        over[f"Data.{mode}.dataset.input_dir"] = data_dir
        over[f"Data.{mode}.dataset.max_seq_len"] = 32
        over[f"Data.{mode}.dataset.eos_id"] = VOCAB - 1
    over.update(extra)
    return [f"{k}={v}" for k, v in over.items()]


def port_engine(over, state_dict=None, config=CONFIG, module_cls=GPTModule):
    """``(cfg, engine, Train loader)`` of the port on the CPU."""
    cfg = get_config(config, over)
    module = module_cls(cfg, state_dict=state_dict, device="cpu")
    engine = Engine(cfg, module, device="cpu")
    loader = build_dataloader(cfg.Data, "Train")
    loader.batch_sampler.batch_size = cfg.Global.global_batch_size
    return cfg, engine, loader


def jax_engine(over, config=CONFIG):
    """``(cfg, engine, Train loader)`` of the JAX package on one CPU
    device."""
    import jax
    from paddlefleetx_tpu.core import Engine as JaxEngine
    from paddlefleetx_tpu.data import \
        build_dataloader as jax_build_dataloader
    from paddlefleetx_tpu.models import build_module as jax_build_module
    from paddlefleetx_tpu.utils.config import get_config as jax_get_config
    cfg = jax_get_config(config, over, nranks=1)
    engine = JaxEngine(cfg, jax_build_module(cfg), mode="train",
                       devices=jax.devices()[:1])
    loader = jax_build_dataloader(cfg.Data, "Train")
    loader.batch_sampler.batch_size = cfg.Global.global_batch_size
    return cfg, engine, loader


def jax_params_as_port_state(jengine, over, config=CONFIG):
    """The JAX engine's parameters as the port's state dict."""
    from _torch_parity import numpy_tree
    return torch_state_dict_from_flax(
        numpy_tree(jengine.state["params"]),
        GPTConfig.from_config(get_config(config, over)))
