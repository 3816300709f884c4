"""The port's training loss and gradients against the JAX package's.

Both ``GPTModule``s are built from the 345M pretraining recipe cut to a
tiny size (2 layers, hidden 128, two heads of 64, sequence 128, fp32,
dropout 0), the JAX parameters carried into the port with
``torch_state_dict_from_flax``. For each ``loss_chunks`` x
``recompute_granularity`` the port's ``loss_fn`` and its gradients
equal JAX ``loss_fn`` and ``jax.grad`` (loss 1e-6 rel, gradients 1e-5
abs per leaf); the JAX side went through its flash kernel (interpret
mode). Under ``save_dots`` the port runs the attention forward once per
layer (its output is kept), under ``full`` twice (the block recomputes).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_counters, jax_params, numpy_tree, rng
from paddlefleetx_tpu.models.gpt.modules import GPTModule as JaxGPTModule
from paddlefleetx_tpu.utils.config import get_config as jax_get_config
from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
from paddlefleetx_tpu_torch.models.gpt.convert import (
    flax_from_torch_state_dict, torch_state_dict_from_flax,
)
from paddlefleetx_tpu_torch.models.gpt.modules import GPTModule
from paddlefleetx_tpu_torch.ops.cuda import flash_attention as fa
from paddlefleetx_tpu_torch.utils.config import get_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "nlp", "gpt",
                      "pretrain_gpt_345M_single_card.yaml")
TINY = ["Model.num_layers=2", "Model.hidden_size=128",
        "Model.num_attention_heads=2", "Model.ffn_hidden_size=256",
        "Model.vocab_size=96", "Model.max_position_embeddings=128",
        "Model.hidden_dropout_prob=0.0",
        "Model.attention_probs_dropout_prob=0.0",
        "Model.initializer_range=0.05",
        "Engine.mix_precision.use_pure_fp16=False",
        "Global.local_batch_size=2", "Global.micro_batch_size=2",
        "Data.Train.dataset.max_seq_len=128"]


def _batch(b=2, s=128, vocab=96):
    r = rng(21)
    tokens = r.integers(0, vocab, (b, s))
    labels = r.integers(0, vocab, (b, s))
    mask = (r.random((b, s)) > 0.2).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s)).copy()
    return tokens, pos, labels, mask


def _jax_side(over):
    jmod = JaxGPTModule(jax_get_config(CONFIG, over, nranks=1))
    params = jax_params(jmod.model)
    batch = tuple(jnp.asarray(x) for x in _batch())
    with jax_counters() as reg:
        loss, grads = jax.value_and_grad(lambda p: jmod.loss_fn(
            p, batch, jax.random.key(1), train=True))(params)
        assert reg.counter("attention/flash") > 0
        assert reg.counter("attention/dense") == 0
    return params, float(loss), numpy_tree(grads)


@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("granularity", ["full", "save_dots"])
def test_loss_and_grads_match_jax(monkeypatch, chunks, granularity):
    monkeypatch.setenv("PFX_PALLAS_INTERPRET", "1")
    over = TINY + ["Model.use_recompute=True",
                   f"Model.recompute_granularity={granularity}",
                   f"Model.loss_chunks={chunks}"]
    params, jloss, jgrads = _jax_side(over)
    cfg = get_config(CONFIG, over)
    state = torch_state_dict_from_flax(numpy_tree(params),
                                       GPTConfig.from_config(cfg))
    module = GPTModule(cfg, device="cpu", state_dict=state)
    assert module.model.word_embeddings.dtype == torch.float32
    calls = []
    plain = fa.flash_attention_reference

    def counting(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)
    monkeypatch.setattr(fa, "flash_attention_reference", counting)
    batch = tuple(torch.from_numpy(np.asarray(x)) for x in _batch())
    loss = module.loss_fn(module.model, batch, seed=0, train=True)
    loss.backward()
    layers = module.model_config.num_layers
    assert len(calls) == (layers if granularity == "save_dots"
                          else 2 * layers)
    assert float(loss.detach()) == pytest.approx(jloss, rel=1e-6)
    got = flax_from_torch_state_dict(
        {n: p.grad for n, p in module.model.named_parameters()},
        module.model_config)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(jgrads))
    assert len(flat_got) == len(flat_want)
    for path, g in flat_got:
        np.testing.assert_allclose(g, flat_want[path], atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))
