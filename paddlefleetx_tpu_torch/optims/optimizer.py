"""AdamW with the reference's weight-decay mask and global-norm clipping
(the port's counterpart of the JAX package's ``optims/optimizer.py``).

``FusedAdamW`` excludes parameters whose name contains "bias" or "norm"
from weight decay; here that is two parameter groups of one
``torch.optim.AdamW`` (the JAX package runs optax here, not a
hand-written kernel). Gradients are clipped to a global norm before the
update, as ``optax.clip_by_global_norm`` does: unchanged below the
limit, otherwise ``g / norm * limit``. Parameters and the second
moment stay fp32 (AMP-O2: the model computes in bf16 on fp32 master
weights). ``state_dtype: bfloat16`` (AMP-O3) stores the first moment in
bf16 as optax's ``mu_dtype`` does (:class:`AdamWBf16Moment`): the
moment is updated and used in fp32 and only its stored copy is rounded.
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


class AdamWBf16Moment(torch.optim.Optimizer):
    """AdamW with the first moment stored in bf16, the arithmetic of
    ``optax.adamw(..., mu_dtype=jnp.bfloat16)`` (the JAX package's
    ``Optimizer.state_dtype: bfloat16``): ``mu = (1 - b1) g + b1 mu``
    with ``b1 mu`` in bf16 and the sum in fp32. In ``b1 mu`` JAX's weak
    typing rounds ``b1`` itself to bf16 (0.9 becomes 0.8984375), and so
    does this step; ``(1 - b1)`` stays fp32. The update divides that
    fp32 ``mu`` (bias corrected) by ``sqrt(nu_hat) + eps``, adds the
    decay ``wd p`` and scales by ``-lr``; only then is ``mu`` stored in
    bf16. ``nu`` and the parameters stay fp32. One ``_foreach`` pass per
    parameter group."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, {"lr": lr, "betas": betas, "eps": eps,
                                  "weight_decay": weight_decay})

    @torch.no_grad()
    def step(self, closure=None):
        """One update of every parameter that has a gradient."""
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            grads = [p.grad.float() for p in params]
            mus, nus = [], []
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p,
                                                     dtype=torch.bfloat16)
                    st["exp_avg_sq"] = torch.zeros_like(
                        p, dtype=torch.float32)
                st["step"] += 1
                mus.append(st["exp_avg"])
                nus.append(st["exp_avg_sq"])
            count = self.state[params[0]]["step"]
            b1_bf16 = float(torch.tensor(b1, dtype=torch.bfloat16))
            mu32 = [m.float() for m in torch._foreach_mul(mus, b1_bf16)]
            torch._foreach_add_(mu32, torch._foreach_mul(grads, 1.0 - b1))
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1.0 - b2))
            mu_hat = torch._foreach_div(mu32, 1.0 - b1 ** count)
            den = torch._foreach_sqrt(torch._foreach_div(nus,
                                                         1.0 - b2 ** count))
            torch._foreach_add_(den, group["eps"])
            upd = torch._foreach_div(mu_hat, den)
            if group["weight_decay"]:
                torch._foreach_add_(upd, torch._foreach_mul(
                    params, group["weight_decay"]))
            torch._foreach_add_(params, torch._foreach_mul(upd,
                                                           -group["lr"]))
            for m, m32 in zip(mus, mu32):
                m.copy_(m32)
        return None


class TrainOptimizer:
    """One optimizer step: clip, set the scheduled rate, AdamW update.

    Args:
        named_params: ``(name, parameter)`` pairs of the model.
        lr_schedule (Callable): ``step -> lr``.
        beta1, beta2, epsilon, weight_decay: AdamW's.
        grad_clip_norm (float): the global-norm limit, or None.
        state_dtype (str): ``None`` / ``"float32"`` (``torch.optim.AdamW``,
            fp32 moments) or ``"bfloat16"`` (:class:`AdamWBf16Moment`).
    """

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 lr_schedule: Callable[[int], float], beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: float = 0.01,
                 grad_clip_norm: Optional[float] = None,
                 state_dtype: Optional[str] = None):
        decay, no_decay = [], []
        for name, p in named_params:
            if p.requires_grad:
                (decay if decays(name) else no_decay).append(p)
        self.params = decay + no_decay
        self.lr_schedule = lr_schedule
        self.grad_clip_norm = grad_clip_norm
        opt = AdamWBf16Moment if state_dtype == "bfloat16" else \
            torch.optim.AdamW
        self.opt = opt(
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
