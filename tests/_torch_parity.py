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

from paddlefleetx_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddlefleetx_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddlefleetx_tpu.observability import metrics as jax_metrics
from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
from paddlefleetx_tpu_torch.models.gpt.convert import (
    torch_state_dict_from_flax,
)
from paddlefleetx_tpu_torch.models.gpt.model import build_model

CPU = torch.device("cpu")


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
