"""Optimizer and LR factories (the port's counterpart of the JAX
package's ``optims/__init__.py``): ``FusedAdamW`` / ``AdamW`` and the
``CosineAnnealingWithWarmupDecay`` schedule of the YAML ``Optimizer``
section; other names raise ``NotImplementedError``."""

from __future__ import annotations

import copy
from typing import Callable

from .lr_scheduler import cosine_annealing_with_warmup_decay
from .optimizer import TrainOptimizer


def build_lr_scheduler(lr_config) -> Callable[[int], float]:
    """``step -> lr`` from the ``Optimizer.lr`` section; a section with
    no ``name`` is a constant ``learning_rate``."""
    lr_config = copy.deepcopy(dict(lr_config))
    name = lr_config.pop("name", None)
    if name is None:
        rate = float(lr_config["learning_rate"])
        return lambda step: rate
    if name != "CosineAnnealingWithWarmupDecay":
        raise NotImplementedError(f"lr scheduler {name!r} is not ported")
    return cosine_annealing_with_warmup_decay(**lr_config)


def build_optimizer(config, named_params,
                    lr_scheduler: Callable[[int], float]) -> TrainOptimizer:
    """AdamW with the decay mask over ``named_params``, clipped to the
    global norm of the ``grad_clip`` section. ``state_dtype`` (set to
    ``bfloat16`` by ``mix_precision.level: o3``) stores the first moment
    in bf16, as the JAX package's optax ``mu_dtype`` does; the second
    moment stays fp32, and any other reduced dtype raises.
    ``tensor_fusion`` and ``multi_precision`` are accepted and have no
    effect, as in the JAX package (one fused update; fp32 master weights
    always)."""
    grad_clip = config.get("grad_clip") or {}
    if grad_clip.get("name", "ClipGradByGlobalNorm") != \
            "ClipGradByGlobalNorm":
        raise ValueError(f"unknown grad_clip {grad_clip.get('name')!r}")
    if config.get("name") not in ("FusedAdamW", "AdamW"):
        raise NotImplementedError(
            f"optimizer {config.get('name')!r} is not ported (FusedAdamW, "
            f"AdamW are)")
    state_dtype = config.get("state_dtype")
    if state_dtype not in (None, "float32", "bfloat16"):
        raise NotImplementedError(
            f"Optimizer.state_dtype={state_dtype!r} is not ported (float32 "
            f"and bfloat16 are)")
    return TrainOptimizer(
        named_params, lr_scheduler, beta1=config.get("beta1", 0.9),
        beta2=config.get("beta2", 0.999),
        epsilon=config.get("epsilon", 1e-8),
        weight_decay=config.get("weight_decay", 0.01),
        grad_clip_norm=grad_clip.get("clip_norm"), state_dtype=state_dtype)
