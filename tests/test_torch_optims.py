"""The port's LR schedule, AdamW and global-norm clipping against the JAX
package's optax chain, built from the same YAML ``Optimizer`` section
(``pretrain_gpt_base.yaml``)."""

import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import rng
from paddlefleetx_tpu.optims import build_lr_scheduler as jax_build_lr
from paddlefleetx_tpu.optims import build_optimizer as jax_build_optimizer
from paddlefleetx_tpu.utils.config import get_config as jax_get_config
from paddlefleetx_tpu_torch.optims import build_lr_scheduler, build_optimizer
from paddlefleetx_tpu_torch.optims.optimizer import (
    clip_by_global_norm_, decays,
)
from paddlefleetx_tpu_torch.utils.config import get_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "nlp", "gpt",
                      "pretrain_gpt_345M_single_card.yaml")
OVER = ["Optimizer.lr.decay_steps=100", "Optimizer.lr.warmup_rate=0.05",
        "Optimizer.lr.max_lr=0.01", "Optimizer.lr.min_lr=0.001",
        "Optimizer.weight_decay=0.1"]


def _sections():
    return (jax_get_config(CONFIG, OVER, nranks=1).Optimizer,
            get_config(CONFIG, OVER).Optimizer)


def test_lr_schedule_matches_jax():
    jsec, psec = _sections()
    jsched, psched = jax_build_lr(jsec.lr), build_lr_scheduler(psec.lr)
    # 0, 1, mid-warmup end (5), mid-decay, decay_steps, beyond
    for step in (0, 1, 5, 37, 100, 150):
        assert psched(step) == pytest.approx(float(jsched(step)),
                                             rel=1e-6, abs=1e-12)
    assert psched(0) == 0.0 and psched(150) == pytest.approx(0.001)


def test_three_adamw_updates_match_optax():
    jsec, psec = _sections()
    r = rng(5)
    shapes = {"linear.weight": (8, 6), "linear.bias": (8,),
              "norm1.weight": (6,), "word_embeddings": (10, 6)}
    init = {k: r.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    grads = [{k: (r.standard_normal(s) * (3.0 if i == 1 else 0.05)
                  ).astype(np.float32) for k, s in shapes.items()}
             for i in range(3)]
    # the JAX tree: one subtree per parameter, named like the port's
    def tree(d):
        return {k.replace(".", "/"): jnp.asarray(v) for k, v in d.items()}
    tx = jax_build_optimizer(jsec, jax_build_lr(jsec.lr))
    jparams = tree(init)
    state = tx.init(jparams)
    for g in grads:
        upd, state = tx.update(tree(g), state, jparams)
        jparams = optax.apply_updates(jparams, upd)

    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    opt = build_optimizer(psec, params.items(), build_lr_scheduler(psec.lr))
    for step, g in enumerate(grads):
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step(step)
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jparams[k.replace(".", "/")]),
                                   atol=1e-6, err_msg=k)
    # the decay mask: bias and norm parameters get no weight decay
    assert [decays(k) for k in shapes] == [True, False, False, True]
    groups = opt.opt.param_groups
    assert groups[0]["weight_decay"] == 0.1 and \
        groups[1]["weight_decay"] == 0.0
    assert len(groups[1]["params"]) == 2


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_matches_optax(scale):
    r = rng(9)
    gs = [(r.standard_normal(s) * scale).astype(np.float32)
          for s in ((4, 5), (7,), (3, 3))]
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in gs], optax.EmptyState())
    got = [torch.from_numpy(g.copy()) for g in gs]
    norm = clip_by_global_norm_(got, 1.0)
    assert float(norm) == pytest.approx(
        float(optax.global_norm([jnp.asarray(g) for g in gs])), rel=1e-6)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-9)
