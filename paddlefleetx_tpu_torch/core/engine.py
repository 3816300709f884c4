"""The training engine of the port (the counterpart of the JAX package's
``core/engine.py``, one GPU).

``Engine(configs, module, mode="train", device=None)`` owns the step
loop: ``fit`` walks the train loader from the resume point, runs
``accumulate_steps`` microbatches per step (each with its own dropout
stream; loss and gradients averaged over them), clips and updates with
the scheduled rate, logs every ``logging_freq`` steps, evaluates every
``eval_freq`` steps for ``eval_iters`` batches and saves every
``save_steps``; ``save`` / ``load`` write and restore a checkpoint
(``core/checkpoint.py``) and ``Engine.save_load.ckpt_dir`` resumes at
construction. The engine knobs this slice does not port (data, model,
pipeline or sharding parallelism, optimizer offload, the profiler
window, telemetry, asynchronous or preemption saves, retention, epoch
run mode) raise ``NotImplementedError``; none is ignored.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..models.gpt.model import fold_seed
from ..optims import build_lr_scheduler, build_optimizer
from ..utils.device import resolve_device
from ..utils.log import logger
from . import checkpoint as ckpt


def _unported_knobs(configs) -> List[str]:
    """The engine knobs of ``configs`` this slice does not port."""
    dist = configs.get("Distributed") or {}
    sharding = dist.get("sharding") or {}
    eng = configs.get("Engine") or {}
    save_load = eng.get("save_load") or {}
    asked = {
        "Distributed.dp_degree": (dist.get("dp_degree") or 1) > 1,
        "Distributed.mp_degree": (dist.get("mp_degree") or 1) > 1,
        "Distributed.pp_degree": (dist.get("pp_degree") or 1) > 1,
        "Distributed.cp_degree": (dist.get("cp_degree") or 1) > 1,
        "Distributed.sharding.sharding_degree":
            (sharding.get("sharding_degree") or 1) > 1,
        "Distributed.sharding.sharding_offload":
            bool(sharding.get("sharding_offload")),
        "Profiler.enable": bool((configs.get("Profiler") or {}).get(
            "enable")),
        "Telemetry.enable": bool((configs.get("Telemetry") or {}).get(
            "enable")),
        "Engine.save_load.async_save": bool(save_load.get("async_save")),
        "Engine.save_load.save_on_preemption":
            bool(save_load.get("save_on_preemption")),
        "Engine.save_load.keep_last_k":
            bool(save_load.get("keep_last_k")),
        "Engine.run_mode": eng.get("run_mode", "step") != "step",
    }
    return sorted(k for k, on in asked.items() if on)


class Engine:
    """Trainer for a module with the ``BasicModule`` contract on one
    device.

    Args:
        configs: the parsed config tree.
        module: e.g. ``GPTModule``; its model lives on ``device``.
        mode (str): ``"train"`` builds the optimizer; else evaluation.
        device: ``None`` (the card; raises without one), ``"cuda"`` or
            ``"cpu"``.
    """

    def __init__(self, configs, module, mode: str = "train",
                 device: Optional[Union[str, torch.device]] = None):
        asked = _unported_knobs(configs)
        if asked:
            raise NotImplementedError(
                f"engine knobs not ported to the PyTorch package yet: "
                f"{asked} (one GPU, synchronous saves; multi-GPU is the "
                f"next slice)")
        self.device = resolve_device(device)
        if torch.device(module.device) != self.device:
            raise ValueError(f"module on {module.device}, engine on "
                             f"{self.device}")
        self.configs = configs
        self.module = module
        self.model = module.model
        self.mode = mode
        eng = configs.Engine
        max_steps = eng.get("max_steps")
        self.max_steps = max_steps if max_steps and max_steps > 0 \
            else sys.maxsize
        self.logging_freq = eng.get("logging_freq", 1)
        self.eval_freq = eng.get("eval_freq") or sys.maxsize
        eval_iters = eng.get("eval_iters", 10)
        self.eval_iters = eval_iters if eval_iters and eval_iters > 0 \
            else None
        self.accumulate_steps = eng.get("accumulate_steps", 1) or 1
        save_load = eng.get("save_load", {}) or {}
        self.save_steps = save_load.get("save_steps") or sys.maxsize
        self.save_epoch = save_load.get("save_epoch", 1) or 1
        self.output_dir = save_load.get("output_dir", "./output")
        self.ckpt_dir = save_load.get("ckpt_dir")
        self.global_batch_size = configs.Global.global_batch_size
        self.seed = int(configs.Global.get("seed", 1024))
        self.optimizer = None
        self.lr_schedule = lambda step: 0.0
        if mode == "train":
            opt_cfg = configs.Optimizer
            self.lr_schedule = build_lr_scheduler(
                opt_cfg.lr if "lr" in opt_cfg else
                {"learning_rate": opt_cfg.get("learning_rate", 1e-4)})
            self.optimizer = build_optimizer(
                opt_cfg, self.model.named_parameters(), self.lr_schedule)
        #: optimizer steps done (the LR step and the dropout stream)
        self.step = 0
        #: every logged step's record (loss, lr, grad_norm, train_cost)
        self.history: List[Dict[str, Any]] = []
        self._load_recovery = {"epoch": 0, "step": 0, "consumed_samples": 0}
        n_params = sum(p.numel() for p in self.model.parameters())
        logger.info("initialized model: %.1fM params on %s",
                    n_params / 1e6, self.device)
        if self.ckpt_dir:
            self.load()

    # -- steps ----------------------------------------------------------

    def _to_device(self, batch):
        return tuple(torch.from_numpy(np.asarray(x)).to(self.device)
                     for x in batch)

    def train_step(self, batch):
        """One optimizer step over a collated batch (host arrays):
        ``accumulate_steps`` microbatches, each with the dropout seed of
        (Global.seed, step, microbatch), their loss and gradients
        averaged; clip and update. Returns ``(loss, grad_norm, lr)``,
        the first two as 0-d device tensors."""
        self.model.train()
        batch = self._to_device(batch)
        acc = self.accumulate_steps
        step_seed = fold_seed(self.seed, self.step)
        micro = zip(*(t.chunk(acc) for t in batch))
        loss_sum = None
        for i, mb in enumerate(micro):
            loss = self.module.loss_fn(self.model, mb,
                                       fold_seed(step_seed, i), train=True)
            loss.backward()
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        if acc > 1:
            grads = [p.grad for p in self.model.parameters()
                     if p.grad is not None]
            torch._foreach_div_(grads, float(acc))
            loss_sum = loss_sum / acc
        lr = self.lr_schedule(self.step)
        norm = self.optimizer.step(self.step)
        self.step += 1
        return loss_sum, norm, lr

    def fit(self, epoch: int = 1, train_data_loader=None,
            valid_data_loader=None) -> None:
        """Train for ``epoch`` epochs or ``max_steps`` steps, from the
        resume point, with the configured eval, log and save cadence."""
        start_epoch = self._load_recovery["epoch"]
        consumed = self._load_recovery["consumed_samples"]
        for ep in range(start_epoch, epoch):
            if hasattr(train_data_loader, "batch_sampler"):
                train_data_loader.batch_sampler.set_epoch(ep, consumed)
            t0 = time.time()
            self._train_one_epoch(ep, train_data_loader, valid_data_loader)
            self.module.training_epoch_end(
                {"epoch": ep, "train_cost": time.time() - t0})
            if (ep + 1) % self.save_epoch == 0 and \
                    self.step % self.save_steps != 0:
                self.save(ep + 1)
            consumed = 0
            if self.step >= self.max_steps:
                break

    def _train_one_epoch(self, epoch: int, train_data_loader,
                         valid_data_loader=None) -> None:
        step_start = time.time()
        for batch in train_data_loader:
            if self.step >= self.max_steps:
                return
            loss, norm, lr = self.train_step(batch)
            if self.step % self.logging_freq == 0:
                log = {"epoch": epoch, "batch": self.step,
                       "loss": float(loss), "lr": lr,
                       "grad_norm": float(norm),
                       "train_cost": (time.time() - step_start)
                       / self.logging_freq}
                self.history.append(log)
                self.module.training_step_end(dict(log))
                step_start = time.time()
            if self.step % self.eval_freq == 0 and \
                    valid_data_loader is not None:
                self.evaluate(epoch, valid_data_loader, self.eval_iters)
                step_start = time.time()
            if self.step % self.save_steps == 0:
                self.save(epoch)
                step_start = time.time()

    @torch.no_grad()
    def evaluate(self, epoch: int = 1, valid_data_loader=None,
                 max_iters: Optional[int] = None) -> float:
        """Mean eval loss over ``max_iters`` batches of the loader (None:
        all of it), with an ``[eval]`` line per batch."""
        self.model.eval()
        losses = []
        t0 = time.time()
        for i, batch in enumerate(valid_data_loader):
            if max_iters is not None and i >= max_iters:
                break
            loss = self.module.loss_fn(self.model, self._to_device(batch),
                                       self.seed, train=False)
            losses.append(float(loss))
            self.module.validation_step_end({
                "epoch": epoch, "batch": i, "loss": losses[-1],
                "eval_cost": (time.time() - t0) / (i + 1)})
        self.model.train()
        mean = float(np.mean(losses)) if losses else float("nan")
        self.module.validation_epoch_end(
            {"epoch": epoch, "loss": mean, "eval_cost": time.time() - t0})
        return mean

    # -- checkpoint -----------------------------------------------------

    def save(self, epoch: int = 0) -> str:
        """Checkpoint the model, the optimizer and the resume point
        (``consumed_samples = step * global_batch_size``)."""
        meta = {"epoch": epoch, "step": self.step,
                "consumed_samples": self.step * self.global_batch_size,
                "seed": self.seed}
        return ckpt.save_checkpoint(
            self.output_dir, epoch, self.step, self.model.state_dict(),
            self.optimizer.state_dict() if self.optimizer else None, meta)

    def load(self) -> None:
        """Restore the checkpoint ``ckpt_dir`` names (a step dir, or the
        newest verified one below it) and set the resume point; start
        fresh, with a warning, when there is none."""
        path = ckpt.latest_checkpoint(self.ckpt_dir)
        if path is None:
            logger.warning("no checkpoint found under %s; starting fresh",
                           self.ckpt_dir)
            return
        model_state, opt_state, meta = ckpt.load_checkpoint(path,
                                                            self.device)
        self.model.load_state_dict(model_state)
        if self.optimizer is not None and opt_state is not None:
            self.optimizer.load_state_dict(opt_state)
        self.step = int(meta.get("step", 0))
        self._load_recovery = {
            "epoch": int(meta.get("epoch", 0)), "step": self.step,
            "consumed_samples": int(meta.get("consumed_samples", 0))}
        logger.info("resumed at epoch %s step %s from %s",
                    self._load_recovery["epoch"], self.step, path)
