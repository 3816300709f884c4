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
FLOPs and MFU against the H100's bf16 peak, goodput with its eval, save
and input-wait buckets, the HBM watermark, the dispatch counters; by
default it prints whenever the profiler or telemetry is on, as the JAX
engine's does). ``evaluate`` walks an eval loader,
and ``predict`` walks a test loader through ``module.predict_step`` for
at most ``test_iters`` batches (default ``eval_iters * 10``; a value
<= 0 walks it all). Every loop takes its batches through
:meth:`Engine._prefetch_iter`: each host batch passes
``module.pretreating_batch``, lands in a pinned host tensor and is
copied to the card on a copy stream, ``Engine.prefetch_depth`` batches
(default 2) ahead of the batch handed out; the compute stream waits for
a batch's copy event before it uses it (0 copies each batch
synchronously). ``save`` / ``load`` write and restore a checkpoint
(``core/checkpoint.py``; ``save_load.async_save`` writes it from a
thread, ``keep_last_k`` bounds how many stay) and
``Engine.save_load.ckpt_dir`` resumes at construction, in every mode,
falling back past a corrupt newest checkpoint. With
``save_on_preemption`` (default on, as in the JAX engine) a SIGTERM
during ``fit`` saves at the next step boundary (breaking out of an eval
in progress) and stops. ``Engine.run_mode: epoch`` evaluates at the end
of every ``eval_freq``-th epoch instead of every ``eval_freq`` steps.
``Telemetry.enable`` turns on the dispatch counters and the flight
recorder (``events.jsonl``, ``observability/recorder.py``: the JAX
engine's events and its ``engine/fit`` -> ``engine/step`` ->
``engine/h2d`` span tree, with ``engine/save``), and samples the HBM
watermark at every logging window (``observability/memory.py``).
``Profiler.enable`` traces the steps ``[start, stop)`` of
``Profiler.scheduler`` with ``torch.profiler`` (CPU and CUDA) and writes
a chrome trace into ``Profiler.profiler_log``. A model with LoRA banks
(``lora_rank > 0``) fine-tunes
with the base frozen, as the JAX engine's ``optax.multi_transform``
does: AdamW, its clipping and decay mask cover the ``*_lora`` parameters
only, the base parameters keep no optimizer state and never move, and
the logged ``grad_norm`` is over every parameter's gradient. The
training forward passes no adapter ids, as the JAX ``GPTModule`` does,
so the banks see zero gradients there and only weight decay moves
``lora_a``: the port reproduces the JAX package here. The engine knobs
the port does not have (data, model, pipeline, sharding or expert
parallelism, optimizer offload) raise ``NotImplementedError``; none is
ignored. The summary has no lines for what the port does not have: the
compile bucket (eager PyTorch compiles nothing; the JAX ``compile``
event and ``engine/compile`` span have no counterpart) and the
model-parallel probe.
"""

from __future__ import annotations

import os
import signal
import sys
import time
from collections import deque
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..models.gpt.model import fold_seed
from ..observability import flops
from ..observability import metrics as obs_metrics
from ..observability import timeline as obs_timeline
from ..observability.memory import device_memory_stats, format_bytes
from ..observability.recorder import FlightRecorder
from ..observability.spans import NULL_SPAN, Tracer
from ..optims import build_lr_scheduler, build_optimizer
from ..optims.optimizer import clip_by_global_norm_
from ..utils.device import resolve_device
from ..utils.log import logger
from . import checkpoint as ckpt


#: the JAX engine's mesh axes, each of size 1 on one card (the
#: ``fit_start`` event's ``mesh``)
MESH_AXES = ("pp", "dp", "cp", "fsdp", "mp")


def _unported_knobs(configs) -> List[str]:
    """The engine knobs of ``configs`` the port does not have."""
    dist = configs.get("Distributed") or {}
    sharding = dist.get("sharding") or {}
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


class _Staged(tuple):
    """A batch staged on the card by :meth:`Engine._put_batch`: its
    device tensors, the copy stream's event the compute stream waits on
    before it uses them (None on the CPU)."""

    event = None


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
                f"{asked} (one GPU; multi-GPU, expert parallelism "
                f"included, is a later slice)")
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
        # "step" evaluates every eval_freq steps, "epoch" at the end of
        # every eval_freq-th epoch
        self.run_mode = eng.get("run_mode", "step")
        if self.run_mode not in ("step", "epoch"):
            raise ValueError(f"Engine.run_mode must be step or epoch, got "
                             f"{self.run_mode!r}")
        self.eval_freq = eng.get("eval_freq") or sys.maxsize
        eval_iters = eng.get("eval_iters", 10)
        self.eval_iters = eval_iters if eval_iters and eval_iters > 0 \
            else None
        test_iters = eng.get("test_iters",
                             eval_iters * 10 if eval_iters else 0)
        self.test_iters = test_iters if test_iters and test_iters > 0 \
            else sys.maxsize
        self.accumulate_steps = eng.get("accumulate_steps", 1) or 1
        save_load = eng.get("save_load", {}) or {}
        self.save_steps = save_load.get("save_steps") or sys.maxsize
        self.save_epoch = save_load.get("save_epoch", 1) or 1
        self.async_save = bool(save_load.get("async_save", False))
        self.save_on_preemption = bool(
            save_load.get("save_on_preemption", True))
        #: 0 keeps every checkpoint; k >= 1 the newest k verified ones
        self.keep_last_k = int(save_load.get("keep_last_k", 0) or 0)
        #: batches staged on the card ahead of the one handed out
        self.prefetch_depth = int(eng.get("prefetch_depth", 2))
        self.output_dir = save_load.get("output_dir", "./output")
        self.ckpt_dir = save_load.get("ckpt_dir")
        prof = configs.get("Profiler") or {}
        self._prof_window = None
        self._prof = None
        #: the chrome trace the profiler window wrote
        self.profiler_trace: Optional[str] = None
        if prof.get("enable", False):
            start, stop = (prof.get("scheduler") or [1, 5])[:2]
            self._prof_window = (int(start), int(stop))
            self._prof_dir = prof.get("profiler_log", "./profiler_log")
            self._prof_detailed = bool(prof.get("detailed"))
            logger.warning("Profiler is enabled, do not enable it in "
                           "production.")
        tele = configs.get("Telemetry") or {}
        self._tele_enabled = bool(tele.get("enable", False))
        #: the flight recorder (``events.jsonl``) under telemetry
        self.recorder: Optional[FlightRecorder] = None
        if self._tele_enabled:
            obs_metrics.set_enabled(True)
            self.recorder = FlightRecorder(
                tele.get("events_path") or
                os.path.join(self.output_dir, "events.jsonl"))
        self._tracer = Tracer(self.recorder)
        self._fit_span = NULL_SPAN
        #: engine-local gauges (``hbm/peak_bytes_in_use``)
        self.metrics = obs_metrics.MetricsRegistry(enabled=True)
        self._hbm_watermark: Optional[Dict[str, int]] = None
        self._preempt_signum: Optional[int] = None
        self._copy_stream = None
        #: pinned host batches whose copies may still be running
        self._inflight: deque = deque()
        self._print_summary_cfg = eng.get("print_summary", None)
        #: whether ``fit`` ends with the run summary: an explicit
        #: ``Engine.print_summary`` wins, else the profiler or telemetry
        self.print_summary = self._summary_enabled()
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
        #: the host seconds each step of the last ``fit`` waited for its
        #: batch's staging (the ``host/h2d_wait`` series)
        self._h2d_waits: List[float] = []
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

    # -- input staging --------------------------------------------------

    def _put_batch(self, batch) -> "_Staged":
        """Stage one host batch on the device: on the card each array
        lands in a pinned host tensor and is copied non-blocking on the
        copy stream, whose event the compute stream waits on before the
        batch is used (:meth:`_to_device`); the pinned tensors stay
        referenced until that event has passed. On the CPU, plain
        tensors."""
        if self.device.type != "cuda":
            return _Staged(torch.from_numpy(np.asarray(x)).to(self.device)
                           for x in batch)
        while self._inflight and self._inflight[0][0].query():
            self._inflight.popleft()
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        host = [torch.from_numpy(np.ascontiguousarray(x)).pin_memory()
                for x in batch]
        with torch.cuda.stream(self._copy_stream):
            staged = _Staged(h.to(self.device, non_blocking=True)
                             for h in host)
            staged.event = torch.cuda.Event()
            staged.event.record(self._copy_stream)
        self._inflight.append((staged.event, host))
        return staged

    def _prefetch_iter(self, loader, depth=None):
        """Yield ``(device batch, h2d_wait seconds)`` over ``loader``
        with up to ``depth`` batches (default ``prefetch_depth``)
        staged ahead: batch N + depth is staged before batch N is handed
        out, in the loader's order. ``h2d_wait`` is the host time spent
        staging (``pretreating_batch`` and :meth:`_put_batch`) per batch
        handed out, the fill of the pipeline added to the first. Staged
        batches that are never handed out are dropped: the resume point
        is derived from the steps trained, never from the loader's
        position. ``depth <= 0`` stages each batch when it is asked
        for."""
        if depth is None:
            depth = self.prefetch_depth
        buf = deque()
        it = iter(loader)

        def stage():
            try:
                batch = next(it)
            except StopIteration:
                return False
            buf.append(self._put_batch(self.module.pretreating_batch(batch)))
            return True

        try:
            if depth <= 0:
                while True:
                    t0 = time.time()
                    if not stage():
                        return
                    yield buf.popleft(), time.time() - t0
            prime = time.time()
            for _ in range(depth):
                if not stage():
                    break
            prime = time.time() - prime
            first = True
            while buf:
                t0 = time.time()
                stage()      # issue batch N + depth before handing out N
                wait = time.time() - t0
                yield buf.popleft(), (wait + prime if first else wait)
                first = False
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    # -- steps ----------------------------------------------------------

    def _to_device(self, batch):
        """The batch's tensors, usable on the compute stream: a staged
        batch after the compute stream waits on its copy event; host
        arrays copied now."""
        if isinstance(batch, _Staged):
            if batch.event is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(batch.event)
                for t in batch:
                    t.record_stream(stream)
            return tuple(batch)
        return tuple(x if isinstance(x, torch.Tensor)
                     and x.device == self.device
                     else torch.from_numpy(np.asarray(x)).to(self.device)
                     for x in batch)

    def train_step(self, batch):
        """One optimizer step over a collated batch (host arrays or a
        staged batch): ``accumulate_steps`` microbatches, each with the
        dropout seed of (Global.seed, step, microbatch), their loss and
        gradients averaged; clip and update. Returns ``(loss,
        grad_norm, lr)``, the first two as 0-d device tensors."""
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
        # an async save's snapshot copies must finish before the update
        # writes the parameters and moments in place
        ckpt.fence_pending_snapshot()
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

    def _on_sigterm(self, signum, frame):
        """Preemption notice: set the flag the step loop polls and put
        the signal on the flight record now (the grace window may not
        outlast the save at the next step boundary)."""
        self._preempt_signum = signum
        if self.recorder is not None:
            self.recorder.emit("sigterm", signum=signum, step=self.step)

    def fit(self, epoch: int = 1, train_data_loader=None,
            valid_data_loader=None) -> None:
        """Train for ``epoch`` epochs or ``max_steps`` steps, from the
        resume point, with the configured eval, log and save cadence;
        then set ``summary`` and, with ``print_summary``, log it. With
        ``save_on_preemption`` a SIGTERM handler is installed for the
        call (main thread only) and the previous one restored after."""
        self._step_costs = []
        self._h2d_waits = []
        self._time_buckets = {"eval": 0.0, "save": 0.0}
        self._fit_t0 = time.time()
        self._preempt_signum = None
        if self.recorder is not None:
            self.recorder.emit(
                "fit_start", step=self.step, epochs=epoch,
                global_batch_size=self.global_batch_size,
                mesh={a: 1 for a in MESH_AXES})
        self._fit_span = self._tracer.start_trace(
            "engine/fit", start_step=self.step, epochs=epoch)
        prev_handler, installed = None, False
        if self.save_on_preemption:
            try:
                prev_handler = signal.signal(signal.SIGTERM,
                                             self._on_sigterm)
                installed = True
            except ValueError:
                # Python installs handlers in the main thread only
                logger.warning(
                    "save_on_preemption: cannot install SIGTERM handler "
                    "outside the main thread; preemption will not "
                    "checkpoint")
        try:
            self._fit_epochs(epoch, train_data_loader, valid_data_loader)
        finally:
            if installed:   # prev_handler may legitimately be None
                signal.signal(signal.SIGTERM, prev_handler)
            if self._prof is not None:
                self._stop_profiler()
            self._fit_span.end()   # idempotent: no-op on a clean exit

    def _fit_epochs(self, epoch, train_data_loader, valid_data_loader):
        start_epoch = self._load_recovery["epoch"]
        consumed = self._load_recovery["consumed_samples"]
        for ep in range(start_epoch, epoch):
            if hasattr(train_data_loader, "batch_sampler"):
                train_data_loader.batch_sampler.set_epoch(ep, consumed)
            t0 = time.time()
            self._train_one_epoch(ep, train_data_loader, valid_data_loader)
            if self._preempt_signum is not None:
                # before the epoch-end hook: the epoch did not complete
                logger.warning(
                    "signal %d (preemption) received: saving checkpoint "
                    "at step %d and stopping cleanly",
                    self._preempt_signum, self.step)
                if self.recorder is not None:
                    self.recorder.emit("preemption",
                                       signum=self._preempt_signum,
                                       step=self.step)
                self.save(ep)
                ckpt.wait_for_pending_save()
                break
            self.module.training_epoch_end(
                {"epoch": ep, "train_cost": time.time() - t0})
            if self.run_mode == "epoch" and \
                    (ep + 1) % self.eval_freq == 0 and \
                    valid_data_loader is not None:
                self.evaluate(ep, valid_data_loader, self.eval_iters)
            if (ep + 1) % self.save_epoch == 0 and \
                    self.step % self.save_steps != 0:
                self.save(ep + 1)
            consumed = 0
            if self.step >= self.max_steps:
                break
        if self._prof is not None:
            self._stop_profiler()
        if self.async_save:
            # the run's last save is durable (and retention applied to
            # it) when fit returns
            ckpt.wait_for_pending_save()
            if self.keep_last_k:
                ckpt.gc_checkpoints(self.output_dir, self.keep_last_k,
                                    recorder=self.recorder)
        self.summary = self.summary_stats()
        if self.print_summary:
            self._print_summary(self.summary)
        # the fit trace closes before fit_end, the stream's last record
        self._fit_span.end(step=self.step)
        if self.recorder is not None:
            stats = self.summary
            self.recorder.emit(
                "fit_end", step=self.step,
                n_windows=len(stats.get("windows", ())),
                **{k: v for k, v in stats.items() if k != "windows"})

    def _train_one_epoch(self, epoch: int, train_data_loader,
                         valid_data_loader=None) -> None:
        step_start = time.time()
        window_clean = True
        tl = obs_timeline.track("main")
        for batch, h2d_wait in self._prefetch_iter(train_data_loader):
            if self.step >= self.max_steps:
                return
            self._profiler_step(self.step)
            step_span = self._fit_span.start_span("engine/step",
                                                  step=self.step + 1)
            tl_t0 = tl.begin()
            loss, norm, lr = self.train_step(batch)
            self._h2d_waits.append(h2d_wait)
            step_span.complete_span("engine/h2d", h2d_wait)
            if self.step % self.logging_freq == 0:
                log = {"epoch": epoch, "batch": self.step,
                       "loss": float(loss), "lr": lr,
                       "grad_norm": float(norm),
                       "train_cost": (time.time() - step_start)
                       / self.logging_freq}
                mem = self._sample_memory()
                if mem is not None:
                    log["hbm_bytes_in_use"] = mem.get("bytes_in_use")
                    log["hbm_peak_bytes"] = mem.get("peak_bytes_in_use")
                self.history.append(log)
                self.module.training_step_end(dict(log))
                # a window that an eval or a save reset is not a sample
                if window_clean:
                    self._step_costs.append(log["train_cost"])
                if self.recorder is not None:
                    w = self._h2d_waits[-self.logging_freq:]
                    self.recorder.emit(
                        "step_window", step=self.step, loss=log["loss"],
                        lr=log["lr"], grad_norm=log["grad_norm"],
                        step_time=round(log["train_cost"], 5),
                        h2d_wait=round(sum(w) / len(w), 5) if w else 0.0,
                        hbm=mem)
                window_clean = True
                step_start = time.time()
            tl.add("step", tl_t0)
            step_span.end()
            if self.run_mode == "step" and \
                    self.step % self.eval_freq == 0 and \
                    valid_data_loader is not None:
                self.evaluate(epoch, valid_data_loader, self.eval_iters)
                step_start = time.time()
                window_clean = False
            if self.step % self.save_steps == 0:
                self.save(epoch)
                step_start = time.time()
                window_clean = False
            if self._preempt_signum is not None:
                return   # _fit_epochs saves, then stops

    def _profiler_step(self, step: int) -> None:
        """Start the ``torch.profiler`` trace at the window's first step
        and stop it at its end. A range check, so a resume that lands
        past ``start`` still traces the rest of the window."""
        if self._prof_window is None:
            return
        start, stop = self._prof_window
        if start <= step < stop and self._prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
        elif step >= stop and self._prof is not None:
            self._stop_profiler()

    def _stop_profiler(self) -> None:
        """Stop the trace after the card has finished the traced steps'
        work and write it as a chrome trace into ``profiler_log``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self._prof_dir, exist_ok=True)
        start, stop = self._prof_window
        path = os.path.join(self._prof_dir,
                            f"trace_steps_{start}_{stop}_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        self.profiler_trace = path
        logger.info("profiler trace written to %s (chrome://tracing or "
                    "Perfetto)", path)

    def _summary_enabled(self) -> bool:
        """Whether ``fit`` ends with the run summary: an explicit
        ``Engine.print_summary`` wins; otherwise on iff the profiler or
        telemetry is on (the JAX engine's gate)."""
        if self._print_summary_cfg is not None:
            return bool(self._print_summary_cfg)
        return self._prof_window is not None or self._tele_enabled

    def _sample_memory(self) -> Optional[Dict[str, int]]:
        """An HBM sample at a logging-window edge, folded into the run's
        watermark and the ``hbm/peak_bytes_in_use`` gauge. None without
        telemetry or on the CPU."""
        if not self._tele_enabled:
            return None
        mem = device_memory_stats(self.device)
        if mem:
            keep = dict(self._hbm_watermark or {})
            for k, v in mem.items():
                keep[k] = v if k == "bytes_limit" else \
                    max(keep.get(k, 0), v)
            self._hbm_watermark = keep
            self.metrics.set_gauge("hbm/peak_bytes_in_use",
                                   keep.get("peak_bytes_in_use"))
        return mem

    @torch.no_grad()
    def evaluate(self, epoch: int = 1, valid_data_loader=None,
                 max_iters: Optional[int] = None) -> float:
        """Mean eval loss over ``max_iters`` batches of the loader (None:
        all of it), with an ``[eval]`` line per batch; a preemption
        signal breaks out of it."""
        self.model.eval()
        losses = []
        t0 = time.time()
        if self.recorder is not None:
            self.recorder.emit("eval_start", step=self.step, epoch=epoch)
        for i, (batch, _h2d) in enumerate(
                self._prefetch_iter(valid_data_loader)):
            if max_iters is not None and i >= max_iters:
                break
            if self._preempt_signum is not None:
                break
            loss = self.module.loss_fn(self.model, self._to_device(batch),
                                       self.seed, train=False)
            losses.append(float(loss))
            self.module.validation_step_end({
                "epoch": epoch, "batch": i, "loss": losses[-1],
                "eval_cost": (time.time() - t0) / (i + 1)})
        self.model.train()
        mean = float(np.mean(losses)) if losses else float("nan")
        eval_s = time.time() - t0
        self._time_buckets["eval"] += eval_s
        if self.recorder is not None:
            self.recorder.emit("eval_end", step=self.step, epoch=epoch,
                               loss=mean, n_batches=len(losses),
                               eval_s=round(eval_s, 4))
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
        for i, (batch, _h2d) in enumerate(
                self._prefetch_iter(test_data_loader)):
            if i >= self.test_iters:
                logger.info("The predicting process is complete.")
                break
            out = _to_host(self.module.predict_step(
                self.model, self._to_device(batch), self.seed))
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
        bf16 peak (``observability/flops.py``), the input waits (the
        first, which holds the prefetch fill, apart), the goodput (the
        wall time less the eval, save and input-wait buckets, over the
        wall time), the HBM watermark under telemetry, and the
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
        if self._h2d_waits:
            waits = self._h2d_waits[1:] or self._h2d_waits
            stats["h2d_fill_s"] = self._h2d_waits[0]
            stats["h2d_mean_s"] = sum(waits) / len(waits)
            stats["h2d_max_s"] = max(waits)
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
            h2d = sum(self._h2d_waits)
            stats["wall_total_s"] = total
            stats["bucket_eval_s"] = b["eval"]
            stats["bucket_save_s"] = b["save"]
            stats["bucket_h2d_s"] = h2d
            stats["goodput_pct"] = 100.0 * max(
                total - b["eval"] - b["save"] - h2d, 0.0) / total
        if self._hbm_watermark:
            stats["hbm_bytes_in_use"] = self._hbm_watermark.get(
                "bytes_in_use")
            stats["hbm_peak_bytes"] = self._hbm_watermark.get(
                "peak_bytes_in_use")
            stats["hbm_bytes_limit"] = self._hbm_watermark.get(
                "bytes_limit")
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
        if "h2d_mean_s" in stats:
            logger.info("  h2d input wait: mean %.4f / max %.4f s/step "
                        "after fill %.4f s (prefetch depth %d)",
                        stats["h2d_mean_s"], stats["h2d_max_s"],
                        stats["h2d_fill_s"], self.prefetch_depth)
        if self._prof_window is not None and self._prof_detailed:
            for i, c in enumerate(costs):
                logger.info("    window %3d: %.4f s/step", i, c)
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
                "(eval %.2f / save %.2f / h2d %.2f s)",
                stats["goodput_pct"], stats["wall_total_s"],
                stats["bucket_eval_s"], stats["bucket_save_s"],
                stats["bucket_h2d_s"])
        logger.info(
            "  HBM watermark: %s",
            "%s in use / %s peak of %s" % (
                format_bytes(stats["hbm_bytes_in_use"]),
                format_bytes(stats["hbm_peak_bytes"]),
                format_bytes(stats.get("hbm_bytes_limit")))
            if "hbm_peak_bytes" in stats
            else "unavailable (no telemetry, or a device without "
                 "allocator stats)")
        if "dispatch_counters" in stats:
            logger.info("  dispatch counters: %s",
                        stats["dispatch_counters"])
        if self.profiler_trace:
            logger.info("  device-time breakdown: open %s in Perfetto",
                        self.profiler_trace)
        if self.recorder is not None:
            logger.info("  flight record: %s", self.recorder.path)
        logger.info("-" * 60)

    # -- checkpoint -----------------------------------------------------

    def save(self, epoch: int = 0) -> str:
        """Checkpoint the model, the optimizer and the resume point
        (``consumed_samples = step * global_batch_size``); with
        ``async_save`` the files are written by a thread, and with
        ``keep_last_k`` the older verified checkpoints are deleted. The
        save bucket and the ``engine/save`` span count the host time
        the loop spent here."""
        meta = {"epoch": epoch, "step": self.step,
                "consumed_samples": self.step * self.global_batch_size,
                "seed": self.seed}
        t0 = time.time()
        path = ckpt.save_checkpoint(
            self.output_dir, epoch, self.step, self.model.state_dict(),
            self.optimizer.state_dict() if self.optimizer else None, meta,
            async_save=self.async_save)
        save_s = time.time() - t0
        self._time_buckets["save"] += save_s
        self._fit_span.complete_span("engine/save", save_s, step=self.step)
        if self.recorder is not None:
            self.recorder.emit("save", step=self.step, epoch=epoch,
                               save_s=round(save_s, 4),
                               async_save=self.async_save)
        if self.keep_last_k:
            ckpt.gc_checkpoints(self.output_dir, self.keep_last_k,
                                recorder=self.recorder)
        return path

    def load(self) -> None:
        """Restore the checkpoint ``ckpt_dir`` names (a step dir, or the
        newest verified one below it) and set the resume point; start
        fresh, with a warning, when there is none. A checkpoint that
        fails verification falls back to the newest older verified one
        in its directory, with a ``ckpt_fallback`` event."""
        path = ckpt.latest_checkpoint(self.ckpt_dir, recorder=self.recorder)
        if path is None:
            logger.warning("no checkpoint found under %s; starting fresh",
                           self.ckpt_dir)
            return
        named_step = ckpt._STEP_DIR.search(os.path.normpath(self.ckpt_dir))
        fallback = os.path.dirname(os.path.abspath(path)) if named_step \
            else self.ckpt_dir
        model_state, opt_state, meta = ckpt.load_checkpoint(
            path, self.device, fallback_dir=fallback,
            recorder=self.recorder)
        self.model.load_state_dict(model_state)
        if self.optimizer is not None and opt_state is not None:
            self.optimizer.load_state_dict(opt_state)
        self.step = int(meta.get("step", 0))
        self._load_recovery = {
            "epoch": int(meta.get("epoch", 0)), "step": self.step,
            "consumed_samples": int(meta.get("consumed_samples", 0))}
        logger.info("resumed at epoch %s step %s from %s",
                    self._load_recovery["epoch"], self.step, path)
