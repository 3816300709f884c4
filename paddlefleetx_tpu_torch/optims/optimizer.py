"""AdamW with the reference's weight-decay mask and global-norm clipping
(the port's counterpart of the JAX package's ``optims/optimizer.py``).

``FusedAdamW`` excludes parameters whose name contains "bias" or "norm"
from weight decay; here that is two parameter groups of one
``torch.optim.AdamW`` (the JAX package runs optax here, not a
hand-written kernel). Gradients are clipped to a global norm before the
update, as ``optax.clip_by_global_norm`` does: unchanged below the
limit, otherwise ``g / norm * limit``. Parameters and both moments stay
fp32 (AMP-O2: the model computes in bf16 on fp32 master weights).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch


def decays(name: str) -> bool:
    """Whether the parameter ``name`` receives weight decay (not a bias
    and not a norm's parameter)."""
    low = name.lower()
    return "bias" not in low and "norm" not in low


def clip_by_global_norm_(grads: List[torch.Tensor],
                         max_norm: Optional[float]) -> torch.Tensor:
    """Clip ``grads`` in place to the global norm ``max_norm`` (None:
    leave them) and return their global norm before clipping, as a
    0-d fp32 tensor on their device (no host sync)."""
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))
    if max_norm:
        scale = torch.where(norm < max_norm, torch.ones_like(norm),
                            max_norm / norm)
        torch._foreach_mul_(grads, scale)
    return norm


class TrainOptimizer:
    """One optimizer step: clip, set the scheduled rate, AdamW update.

    Args:
        named_params: ``(name, parameter)`` pairs of the model.
        lr_schedule (Callable): ``step -> lr``.
        beta1, beta2, epsilon, weight_decay: AdamW's.
        grad_clip_norm (float): the global-norm limit, or None.
    """

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 lr_schedule: Callable[[int], float], beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: float = 0.01,
                 grad_clip_norm: Optional[float] = None):
        decay, no_decay = [], []
        for name, p in named_params:
            if p.requires_grad:
                (decay if decays(name) else no_decay).append(p)
        self.params = decay + no_decay
        self.lr_schedule = lr_schedule
        self.grad_clip_norm = grad_clip_norm
        self.opt = torch.optim.AdamW(
            [{"params": decay, "weight_decay": weight_decay},
             {"params": no_decay, "weight_decay": 0.0}],
            lr=lr_schedule(0), betas=(beta1, beta2), eps=epsilon)

    def step(self, step: int) -> torch.Tensor:
        """Clip the accumulated gradients, update with the rate of
        ``step`` (the number of updates done so far), zero the
        gradients, and return the global norm before clipping."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = clip_by_global_norm_(grads, self.grad_clip_norm)
        lr = self.lr_schedule(step)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        return norm

    def state_dict(self) -> Dict:
        """The AdamW state (moments and step counts)."""
        return self.opt.state_dict()

    def load_state_dict(self, state: Dict) -> None:
        """Restore :meth:`state_dict`."""
        self.opt.load_state_dict(state)
