"""Shared helpers of the ``tests/test_torch_*.py`` parity tests.

Each parity test builds the same tiny GPT in both packages from one set
of keyword arguments, draws the JAX parameters with the JAX package's
own initializer, carries them into the port through
``convert.torch_state_dict_from_flax`` and holds the port's output to
the JAX output on the same inputs. The JAX side runs its Pallas kernels
in interpret mode (``PFX_PALLAS_INTERPRET=1``, set by each test through
``monkeypatch``), and :func:`jax_counters` lets a test assert which JAX
dispatch path (kernel or dense fallback) actually produced the
reference.
"""

from contextlib import contextmanager

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from paddlefleetx_tpu.core.quantize import quantize_param_tree
from paddlefleetx_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddlefleetx_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddlefleetx_tpu.observability import metrics as jax_metrics
from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
from paddlefleetx_tpu_torch.models.gpt.convert import (
    torch_state_dict_from_flax,
)
from paddlefleetx_tpu_torch.models.gpt.model import build_model

CPU = torch.device("cpu")

#: One intra-op thread in every test process. The suite runs under
#: pytest-xdist, several workers on a few cores, and PyTorch's default of
#: one thread per core makes every tiny CPU op of one worker wait on
#: threads that the others keep busy (the chip-smoke training rehearsal
#: alone on 8 cores: 70 s with 8 threads, 14 s with one). Each worker
#: collects every test file, so each imports this module before it runs
#: a test.
torch.set_num_threads(1)


def tiny_kwargs(**over):
    """A 2-layer, hidden-128, head_dim-64 GPT (head_dim 64 is what the
    JAX flash kernel takes), fp32, no dropout."""
    kw = dict(vocab_size=96, hidden_size=128, num_layers=2,
              num_attention_heads=2, max_position_embeddings=128,
              hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
              initializer_range=0.05, use_flash_attention=True,
              scan_layers=False)
    kw.update(over)
    return kw


def jax_params(model, seed: int = 0):
    """Unboxed JAX parameters from the JAX package's initializer."""
    variables = model.init({"params": jax.random.key(seed)},
                           jnp.zeros((1, 8), jnp.int32))
    return nn.meta.unbox(variables["params"])


def numpy_tree(params):
    """The parameter tree with numpy leaves."""
    return jax.tree.map(np.asarray, params)


def build_pair(seed: int = 0, **over):
    """``(jax_model, jax_params, port_model)`` with the same weights,
    the port model on the CPU."""
    kw = tiny_kwargs(**over)
    jmodel = JaxGPT(JaxGPTConfig(**kw))
    params = jax_params(jmodel, seed)
    cfg = GPTConfig(**kw)
    model = build_model(cfg, CPU, state_dict=torch_state_dict_from_flax(
        numpy_tree(params), cfg))
    return jmodel, params, model


def build_quant_pair(seed: int = 0, **over):
    """``(jax_model, jax_qparams, port_model)`` under ``quant_execution:
    weight_only_int8``: the JAX package's initializer draws the fp
    weights, its ``quantize_param_tree`` quantizes them, and the port
    loads the quantized tree through the converter (``over`` may set
    ``kv_cache_dtype`` too)."""
    kw = tiny_kwargs(**over)
    fp_kw = dict(kw, quant_execution="off", kv_cache_dtype="bf16")
    params = jax_params(JaxGPT(JaxGPTConfig(**fp_kw)), seed)
    qparams, _ = quantize_param_tree(params)
    kw["quant_execution"] = "weight_only_int8"
    jmodel = JaxGPT(JaxGPTConfig(**kw))
    cfg = GPTConfig(**kw)
    model = build_model(cfg, CPU, state_dict=torch_state_dict_from_flax(
        numpy_tree(qparams), cfg))
    return jmodel, qparams, model


@contextmanager
def jax_counters():
    """The JAX package's process-global dispatch registry, enabled and
    zeroed for the block, then reset and disabled again."""
    reg = jax_metrics.get_registry()
    jax_metrics.set_enabled(True)
    reg.reset()
    try:
        yield reg
    finally:
        reg.reset()
        jax_metrics.set_enabled(False)


def rng(seed: int) -> np.random.Generator:
    """The numpy generator every test draws its inputs from."""
    return np.random.default_rng(seed)


@contextmanager
def one_thread():
    """One intra-op thread for the block: a test that compares two runs
    bit for bit must not let the CPU's thread count (which a loaded
    machine may vary) change how a sum is split."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
