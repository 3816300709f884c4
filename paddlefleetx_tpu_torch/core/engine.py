"""The training engine of the port (the counterpart of the JAX package's
``core/engine.py``, one GPU).

``Engine(configs, module, mode="train", device=None)`` owns the step
loop: ``fit`` walks the train loader from the resume point, runs
``accumulate_steps`` microbatches per step (each with its own dropout
stream; loss and gradients averaged over them), clips and updates with
the scheduled rate, logs every ``logging_freq`` steps, evaluates every
``eval_freq`` steps for ``eval_iters`` batches and saves every
``save_steps``; with ``Engine.print_summary`` it ends by printing the
run summary (:meth:`summary_stats`: step-time windows, tokens/s, model
FLOPs and MFU against the H100's bf16 peak, goodput with its eval and
save buckets, the dispatch counters). ``evaluate`` walks an eval loader,
and ``predict`` walks a test loader through ``module.predict_step`` for
at most ``test_iters`` batches (default ``eval_iters * 10``; a value
<= 0 walks it all). Each host batch passes ``module.pretreating_batch``
before it moves to the device. ``save`` / ``load`` write and restore a
checkpoint (``core/checkpoint.py``) and ``Engine.save_load.ckpt_dir``
resumes at construction, in every mode. A model with LoRA banks
(``lora_rank > 0``) fine-tunes
with the base frozen, as the JAX engine's ``optax.multi_transform``
does: AdamW, its clipping and decay mask cover the ``*_lora`` parameters
only, the base parameters keep no optimizer state and never move, and
the logged ``grad_norm`` is over every parameter's gradient. The
training forward passes no adapter ids, as the JAX ``GPTModule`` does,
so the banks see zero gradients there and only weight decay moves
``lora_a``: the port reproduces the JAX package here. The engine knobs
this slice does not port (data, model,
pipeline, sharding or expert parallelism, optimizer offload, the profiler
window, telemetry, asynchronous or preemption saves, retention, epoch
run mode) raise ``NotImplementedError``; none is ignored. The summary
has no lines for what the port does not have: the prefetch thread's
waits, the compile bucket, the model-parallel probe and the HBM
telemetry.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..models.gpt.model import fold_seed
from ..observability import flops
from ..observability import metrics as obs_metrics
from ..optims import build_lr_scheduler, build_optimizer
from ..optims.optimizer import clip_by_global_norm_
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
        "Distributed.ep_degree": (dist.get("ep_degree") or 1) > 1,
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


def _to_host(out):
    """A predict output on the host: tensors as numpy, a dict's entries
    each."""
    if isinstance(out, dict):
        return {k: _to_host(v) for k, v in out.items()}
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return out


class Engine:
    """Trainer for a module with the ``BasicModule`` contract on one
    device.

    Args:
        configs: the parsed config tree.
        module: e.g. ``GPTModule``; its model lives on ``device``.
        mode (str): ``"train"`` builds the optimizer; else evaluation
            and prediction only.
        device: ``None`` (the card; raises without one), ``"cuda"`` or
            ``"cpu"``.
    """

    def __init__(self, configs, module, mode: str = "train",
                 device: Optional[Union[str, torch.device]] = None):
        asked = _unported_knobs(configs)
        if asked:
            raise NotImplementedError(
                f"engine knobs not ported to the PyTorch package yet: "
                f"{asked} (one GPU, synchronous saves; multi-GPU, expert "
                f"parallelism included, is a later slice)")
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
        test_iters = eng.get("test_iters",
                             eval_iters * 10 if eval_iters else 0)
        self.test_iters = test_iters if test_iters and test_iters > 0 \
            else sys.maxsize
        #: whether ``fit`` ends with the run summary (the JAX default
        #: also prints it under the profiler or telemetry, both refused)
        self.print_summary = bool(eng.get("print_summary"))
        self.accumulate_steps = eng.get("accumulate_steps", 1) or 1
        save_load = eng.get("save_load", {}) or {}
        self.save_steps = save_load.get("save_steps") or sys.maxsize
        self.save_epoch = save_load.get("save_epoch", 1) or 1
        self.output_dir = save_load.get("output_dir", "./output")
        self.ckpt_dir = save_load.get("ckpt_dir")
        self.global_batch_size = configs.Global.global_batch_size
        self.seed = int(configs.Global.get("seed", 1024))
        self.optimizer = None
        #: the parameters a LoRA fine-tune freezes (none otherwise)
        self._frozen: List[torch.nn.Parameter] = []
        self.lr_schedule = lambda step: 0.0
        if mode == "train":
            opt_cfg = configs.Optimizer
            self.lr_schedule = build_lr_scheduler(
                opt_cfg.lr if "lr" in opt_cfg else
                {"learning_rate": opt_cfg.get("learning_rate", 1e-4)})
            named = list(self.model.named_parameters())
            if getattr(getattr(self.model, "config", None), "lora_rank", 0):
                logger.info("LoRA fine-tune: base weights frozen (no "
                            "optimizer state), training only the *_lora "
                            "adapter banks")
                self._frozen = [p for n, p in named if "_lora." not in n]
                named = [(n, p) for n, p in named if "_lora." in n]
            self.optimizer = build_optimizer(opt_cfg, named,
                                             self.lr_schedule)
        #: optimizer steps done (the LR step and the dropout stream)
        self.step = 0
        #: every logged step's record (loss, lr, grad_norm, train_cost)
        self.history: List[Dict[str, Any]] = []
        #: the seconds a step of each clean logging window (no eval or
        #: save inside it) of the last ``fit``
        self._step_costs: List[float] = []
        #: host wall time of the last ``fit`` not spent in steps
        self._time_buckets = {"eval": 0.0, "save": 0.0}
        self._fit_t0: Optional[float] = None
        #: the last ``fit``'s :meth:`summary_stats`
        self.summary: Dict[str, Any] = {}
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
        if self._frozen:
            # the logged norm is over every leaf's gradient, as the JAX
            # engine's; the update (and its clipping) sees the banks only
            norm = clip_by_global_norm_(
                [p.grad for p in self.model.parameters()
                 if p.grad is not None], None)
            for p in self._frozen:
                p.grad = None
            # a bank the forward never reached (no adapter ids) has the
            # zero gradient JAX computes for it, and still decays
            for p in self.optimizer.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            self.optimizer.step(self.step)
        else:
            norm = self.optimizer.step(self.step)
        self.step += 1
        return loss_sum, norm, lr

    def fit(self, epoch: int = 1, train_data_loader=None,
            valid_data_loader=None) -> None:
        """Train for ``epoch`` epochs or ``max_steps`` steps, from the
        resume point, with the configured eval, log and save cadence;
        then set ``summary`` and, with ``print_summary``, log it."""
        self._step_costs = []
        self._time_buckets = {"eval": 0.0, "save": 0.0}
        self._fit_t0 = time.time()
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
        self.summary = self.summary_stats()
        if self.print_summary:
            self._print_summary(self.summary)

    def _train_one_epoch(self, epoch: int, train_data_loader,
                         valid_data_loader=None) -> None:
        step_start = time.time()
        window_clean = True
        for batch in train_data_loader:
            if self.step >= self.max_steps:
                return
            loss, norm, lr = self.train_step(
                self.module.pretreating_batch(batch))
            if self.step % self.logging_freq == 0:
                log = {"epoch": epoch, "batch": self.step,
                       "loss": float(loss), "lr": lr,
                       "grad_norm": float(norm),
                       "train_cost": (time.time() - step_start)
                       / self.logging_freq}
                self.history.append(log)
                self.module.training_step_end(dict(log))
                # a window that an eval or a save reset is not a sample
                if window_clean:
                    self._step_costs.append(log["train_cost"])
                window_clean = True
                step_start = time.time()
            if self.step % self.eval_freq == 0 and \
                    valid_data_loader is not None:
                self.evaluate(epoch, valid_data_loader, self.eval_iters)
                step_start = time.time()
                window_clean = False
            if self.step % self.save_steps == 0:
                self.save(epoch)
                step_start = time.time()
                window_clean = False

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
            batch = self._to_device(self.module.pretreating_batch(batch))
            loss = self.module.loss_fn(self.model, batch, self.seed,
                                       train=False)
            losses.append(float(loss))
            self.module.validation_step_end({
                "epoch": epoch, "batch": i, "loss": losses[-1],
                "eval_cost": (time.time() - t0) / (i + 1)})
        self.model.train()
        mean = float(np.mean(losses)) if losses else float("nan")
        eval_s = time.time() - t0
        self._time_buckets["eval"] += eval_s
        self.module.validation_epoch_end(
            {"epoch": epoch, "loss": mean, "eval_cost": eval_s})
        return mean

    @torch.no_grad()
    def predict(self, epoch: int = 1, test_data_loader=None) -> List[Any]:
        """Walk at most ``test_iters`` batches of the test loader through
        ``module.predict_step`` (the eval-mode loss by default), with a
        ``test_step_end`` call per batch; returns each batch's output
        on the host (numpy; a dict's entries each)."""
        self.model.eval()
        outs = []
        t0 = time.time()
        for i, batch in enumerate(test_data_loader):
            if i >= self.test_iters:
                logger.info("The predicting process is complete.")
                break
            batch = self._to_device(self.module.pretreating_batch(batch))
            out = _to_host(self.module.predict_step(self.model, batch,
                                                    self.seed))
            outs.append(out)
            arr = out.get("loss") if isinstance(out, dict) else out
            self.module.test_step_end({
                "epoch": epoch, "batch": i,
                # a dict without a loss entry logs nan
                "loss": float(np.mean(arr)) if arr is not None
                else float("nan"),
                "test_cost": (time.time() - t0) / (i + 1)})
        self.model.train()
        return outs

    # -- run summary ----------------------------------------------------

    def summary_stats(self) -> Dict[str, Any]:
        """The last ``fit``'s summary: its clean step-time windows (the
        first apart: it holds the warm-up), tokens/s over the steady
        windows' mean, model FLOPs a token and MFU against one H100's
        bf16 peak (``observability/flops.py``), the goodput (the wall
        time less the eval and save buckets, over the wall time) and the
        process-global dispatch counters when they are on."""
        costs = list(self._step_costs)
        stats: Dict[str, Any] = {"windows": costs,
                                 "logging_freq": self.logging_freq}
        mean = 0.0
        if costs:
            steady = costs[1:] or costs
            mean = sum(steady) / len(steady)
            stats["first_window_s_per_step"] = costs[0]
            stats["steady_mean_s_per_step"] = mean
            stats["steady_min_s_per_step"] = min(steady)
            stats["steady_max_s_per_step"] = max(steady)
        seq = ((self.configs.get("Data") or {}).get("Train") or {}).get(
            "dataset", {}).get("max_seq_len", 0)
        tokens = self.global_batch_size * seq
        mcfg = getattr(self.model, "config", None)
        if tokens and mean > 0:
            tps = tokens / mean
            stats["tokens_per_sec"] = tps
            if mcfg is not None:
                fpt = flops.model_flops_per_token(
                    mcfg.num_layers, mcfg.hidden_size, mcfg.vocab_size, seq)
                stats["model_flops_per_token"] = fpt
                stats["achieved_tflops"] = tps * fpt / 1e12
                stats["mfu"] = flops.mfu(tps, fpt)
        if self._fit_t0 is not None:
            total = max(time.time() - self._fit_t0, 1e-9)
            b = self._time_buckets
            stats["wall_total_s"] = total
            stats["bucket_eval_s"] = b["eval"]
            stats["bucket_save_s"] = b["save"]
            stats["goodput_pct"] = 100.0 * max(
                total - b["eval"] - b["save"], 0.0) / total
        registry = obs_metrics.get_registry()
        if registry.enabled:
            counters = registry.snapshot()["counters"]
            if counters:
                stats["dispatch_counters"] = counters
        return stats

    def _print_summary(self, stats: Dict[str, Any]) -> None:
        """Log the run summary ``stats`` (nothing without a window)."""
        costs = stats.get("windows") or []
        if not costs:
            return
        mean = stats["steady_mean_s_per_step"]
        logger.info("-" * 60)
        logger.info("Run summary (host step times, %d windows of %d "
                    "steps)", len(costs), self.logging_freq)
        logger.info("  first window (incl. warm-up): %.4f s/step",
                    costs[0])
        logger.info("  steady state: mean %.4f / min %.4f / max %.4f "
                    "s/step (%.2f step/s)", mean,
                    stats["steady_min_s_per_step"],
                    stats["steady_max_s_per_step"],
                    1.0 / mean if mean else 0.0)
        if "tokens_per_sec" in stats:
            logger.info("  throughput: %.0f tokens/s (global batch %d)",
                        stats["tokens_per_sec"], self.global_batch_size)
        if "model_flops_per_token" in stats:
            logger.info(
                "  model FLOPs: %.3e /token; achieved %.2f TFLOP/s; "
                "MFU %.4f of the H100's bf16 peak",
                stats["model_flops_per_token"], stats["achieved_tflops"],
                stats["mfu"])
        if "goodput_pct" in stats:
            logger.info(
                "  goodput: %.1f%% productive step time of %.1f s wall "
                "(eval %.2f / save %.2f s)", stats["goodput_pct"],
                stats["wall_total_s"], stats["bucket_eval_s"],
                stats["bucket_save_s"])
        if "dispatch_counters" in stats:
            logger.info("  dispatch counters: %s",
                        stats["dispatch_counters"])
        logger.info("-" * 60)

    # -- checkpoint -----------------------------------------------------

    def save(self, epoch: int = 0) -> str:
        """Checkpoint the model, the optimizer and the resume point
        (``consumed_samples = step * global_batch_size``)."""
        meta = {"epoch": epoch, "step": self.step,
                "consumed_samples": self.step * self.global_batch_size,
                "seed": self.seed}
        t0 = time.time()
        path = ckpt.save_checkpoint(
            self.output_dir, epoch, self.step, self.model.state_dict(),
            self.optimizer.state_dict() if self.optimizer else None, meta)
        self._time_buckets["save"] += time.time() - t0
        return path

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
