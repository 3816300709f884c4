"""LR schedules as ``step -> lr`` functions (the port's copy of the JAX
package's ``optims/lr_scheduler.py``).

``CosineAnnealingWithWarmupDecay``: linear warmup over ``warmup_rate *
decay_steps`` steps to ``max_lr``, cosine decay to ``min_lr`` by
``decay_steps``, flat ``min_lr`` after. The arithmetic is float32, as
in the JAX package, so both give the same rate at every step.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

_F = np.float32


def cosine_annealing_with_warmup_decay(max_lr: float, min_lr: float,
                                       warmup_rate: float,
                                       decay_steps: int, **_
                                       ) -> Callable[[int], float]:
    """Linear warmup -> cosine decay -> ``min_lr`` floor.

    Args:
        max_lr (float): the rate at the end of the warmup.
        min_lr (float): the floor after ``decay_steps``.
        warmup_rate (float): the warmup's share of ``decay_steps``.
        decay_steps (int): the step at which the cosine reaches
            ``min_lr``.

    Returns:
        ``schedule(step) -> lr`` as a Python float.
    """
    warmup_step = _F(warmup_rate * decay_steps)
    max_lr, min_lr = _F(max_lr), _F(min_lr)

    def schedule(step: int) -> float:
        s = _F(step)
        if s > decay_steps:
            return float(min_lr)
        if warmup_step > 0 and s <= warmup_step:
            return float(max_lr * s / max(warmup_step, _F(1.0)))
        ratio = (s - warmup_step) / max(_F(decay_steps) - warmup_step,
                                        _F(1.0))
        coeff = _F(0.5) * (np.cos(_F(np.pi) * ratio) + _F(1.0))
        return float(min_lr + coeff * (max_lr - min_lr))

    return schedule
