"""Command-line entry points of the port.

    python -m paddlefleetx_tpu_torch.cli generate -c <yaml> [-o k=v] \
        [--text TEXT] [--device cuda|cpu]
    python -m paddlefleetx_tpu_torch.cli serve -c <yaml> [-o k=v] \
        [--requests N] [--slots S] [--max-prompt-len L] \
        [--device-loop-ticks T] [--device ...]
    python -m paddlefleetx_tpu_torch.cli train -c <yaml> [-o k=v] \
        [--device cuda|cpu]
    python -m paddlefleetx_tpu_torch.cli auto -c <yaml> [-o k=v] \
        [--device cuda|cpu]
    python -m paddlefleetx_tpu_torch.cli eval -c <yaml> [-o k=v] \
        [--device cuda|cpu]

``train`` is the counterpart of the JAX package's ``cli.train_main``:
config -> ``GPTModule`` -> ``Engine`` -> the Train / Eval loaders of the
``Data`` section -> ``Engine.fit`` (a token corpus of ``*_ids.npy`` +
``*_idx.npz`` files in ``Data.*.dataset.input_dir``; resume with ``-o
Engine.save_load.ckpt_dir=<dir>``). ``Model.module`` may name
``GPTModule`` or ``GPTModuleAuto``. ``auto`` is the counterpart of the
JAX ``cli.auto_main``: the auto schema (``configs/nlp/gpt/auto/``) runs
the same trainer. With ``Telemetry.enable`` the run writes
``events.jsonl`` (``Telemetry.events_path``, default under
``Engine.save_load.output_dir``); with ``Profiler.enable`` it writes a
chrome trace of the ``Profiler.scheduler`` steps into
``Profiler.profiler_log``.

``eval`` is the counterpart of the JAX package's ``cli.eval_main``:
config -> ``GPTEvalModule`` (whatever ``Model.module`` says) -> ``Engine``
in eval mode (no optimizer; ``Engine.save_load.ckpt_dir`` loads a
checkpoint) -> the ``Eval`` loader over ``Offline_Eval.eval_path`` ->
``Engine.evaluate``; it returns the module's metrics (WikiText
``loss`` / ``ppl`` / ``adjusted_ppl``, or with ``Offline_Eval.cloze_eval``
LAMBADA ``acc`` / ``correct``).

``generate`` is the counterpart of the JAX package's
``tasks/gpt/generation.py``: config -> ``GPTGenerationModule`` ->
lockstep ``generate`` on ``--text``. ``serve`` submits ``--requests``
prompts of seeded random tokens (lengths uniform in 5..``--max-prompt-
len``, capped at the longest prompt the server admits beside
``max_dec_len``; seed ``Global.seed``) to a ``GenerationServer`` with
``--slots`` slots (``--device-loop-ticks`` ticks per host round trip,
default 1: T > 1 replays a captured CUDA graph of the tick on the card),
runs it to completion and prints one JSON line per
completion and a summary line; the recipe's ``Model.kv_page_size`` /
``kv_pool_pages`` turn the paged server on and
``Generation.spec_method`` / ``spec_tokens`` speculative decoding, and
``Model.kv_cache_dtype=int8`` / ``Model.quant_execution=weight_only_int8``
the int8 KV cache and the int8 dense sites, as in the JAX package (no
flag of their own). Both draw their weights from
``Global.seed`` (they load no checkpoint yet). All four run on the card
unless ``--device cpu``.
"""

from __future__ import annotations

import json
import sys
from typing import List, Optional

import numpy as np

from .core.engine import Engine
from .core.serving import GenerationServer
from .data import build_dataloader
from .models.gpt.modules import (
    GPTEvalModule, GPTGenerationModule, GPTModule, GPTModuleAuto,
)
from .utils.config import get_config, parse_args
from .utils.log import logger


def generate_main(argv: Optional[List[str]] = None) -> str:
    """Generate from ``--text``; returns the generated text (one line
    per output row) and logs it."""
    args = parse_args(argv, extra=lambda p: (
        p.add_argument("--text", default="Where is the capital of France?"),
        p.add_argument("--device", default=None)))
    module = GPTGenerationModule(get_config(args.config, args.override),
                                 device=args.device)
    outputs = module.generate(args.text)
    for text in outputs:
        logger.info("generated: %s", text)
    return "\n".join(outputs)


def serve_main(argv: Optional[List[str]] = None) -> dict:
    """Serve seeded random prompts to completion; returns the server's
    summary with the completions' finish reasons added."""
    args = parse_args(argv, extra=lambda p: (
        p.add_argument("--requests", type=int, default=16),
        p.add_argument("--slots", type=int, default=8),
        p.add_argument("--max-prompt-len", type=int, default=700),
        p.add_argument("--device-loop-ticks", type=int, default=1),
        p.add_argument("--device", default=None)))
    module = GPTGenerationModule(get_config(args.config, args.override),
                                 device=args.device)
    rng = np.random.default_rng(module.seed)
    vocab = module.model_config.vocab_size
    # the longest prompt the server admits next to max_dec_len new tokens
    longest = min(args.max_prompt_len,
                  module.model_config.max_position_embeddings
                  - module.generation_cfg.max_dec_len)
    prompts = [rng.integers(0, vocab, size=int(n)).tolist()
               for n in rng.integers(min(5, longest), longest + 1,
                                     size=args.requests)]
    server = GenerationServer(module.model, module.generation_cfg,
                              num_slots=args.slots, seed=module.seed,
                              device_loop_ticks=args.device_loop_ticks)
    completions = server.run(prompts)
    for c in completions:
        print(json.dumps({"request": c.request_id,
                          "prompt_len": len(c.prompt),
                          "tokens": len(c.tokens),
                          "finish_reason": c.finish_reason,
                          "ttft_ms": c.ttft_ms}), flush=True)
    summary = server.summary()
    summary["finish_reasons"] = [c.finish_reason for c in completions]
    summary["prompt_lens"] = [len(c.prompt) for c in completions]
    print(json.dumps({"summary": summary}), flush=True)
    return summary


#: the modules ``train`` builds by ``Model.module``
TRAIN_MODULES = {"GPTModule": GPTModule, "GPTModuleAuto": GPTModuleAuto}


def train_main(argv: Optional[List[str]] = None) -> Engine:
    """Train the configured model: config -> ``GPTModule`` -> ``Engine``
    -> loaders -> ``Engine.fit``; returns the engine (its ``history``
    holds the logged steps)."""
    args = parse_args(argv, extra=lambda p: p.add_argument(
        "--device", default=None))
    cfg = get_config(args.config, args.override)
    name = cfg.Model.get("module", "GPTModule")
    if name not in TRAIN_MODULES:
        raise NotImplementedError(f"module {name!r} is not ported "
                                  f"({', '.join(TRAIN_MODULES)} are)")
    module = TRAIN_MODULES[name](cfg, device=args.device)
    engine = Engine(cfg, module, mode="train", device=args.device)
    seed = cfg.Global.get("seed")
    loaders = [build_dataloader(cfg.Data, mode, seed=seed)
               for mode in ("Train", "Eval")]
    for loader in loaders:
        if loader is not None:
            loader.batch_sampler.batch_size = cfg.Global.global_batch_size
    engine.fit(epoch=cfg.Engine.get("num_train_epochs", 1),
               train_data_loader=loaders[0], valid_data_loader=loaders[1])
    logger.info("training finished")
    return engine


def auto_main(argv: Optional[List[str]] = None) -> Engine:
    """The auto schema's entry point: :func:`train_main`, as the JAX
    ``cli.auto_main`` runs its ``train_main``."""
    return train_main(argv)


def build_eval(argv: Optional[List[str]] = None):
    """The ``eval`` command's pieces: config -> ``GPTEvalModule`` ->
    ``Engine`` (eval mode); returns ``(engine, Eval loader)``."""
    args = parse_args(argv, extra=lambda p: p.add_argument(
        "--device", default=None))
    cfg = get_config(args.config, args.override)
    cfg.Model.module = "GPTEvalModule"
    module = GPTEvalModule(cfg, device=args.device)
    engine = Engine(cfg, module, mode="eval", device=args.device)
    return engine, build_dataloader(cfg.Data, "Eval")


def eval_main(argv: Optional[List[str]] = None) -> dict:
    """Evaluate offline: :func:`build_eval`, then ``Engine.evaluate``
    over the Eval loader; returns the module's metrics."""
    engine, loader = build_eval(argv)
    engine.evaluate(epoch=0, valid_data_loader=loader)
    return engine.module.metrics


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m paddlefleetx_tpu_torch.cli
    {generate,serve,train,auto,eval} ...``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    commands = {"generate": generate_main, "serve": serve_main,
                "train": train_main, "auto": auto_main, "eval": eval_main}
    if not argv or argv[0] not in commands:
        print(f"usage: python -m paddlefleetx_tpu_torch.cli "
              f"{{{','.join(commands)}}} -c <yaml> [-o k=v ...]",
              file=sys.stderr)
        return 2
    commands[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
