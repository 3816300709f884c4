"""Language-model config derivations (the port's copy of the JAX
package's ``models/language_utils.py``).

Only the single-device derivations are kept: ffn defaults to 4*hidden,
a recompute granularity defaults to "full", and each data mode's
``num_samples`` follows from the step and eval cadence. Pipeline,
sequence, context and expert parallelism arrive with the multi-GPU
slice.
"""

from __future__ import annotations


def process_model_configs(config) -> None:
    """Fill model-section defaults in place: ``ffn_hidden_size = 4 *
    hidden_size`` and ``recompute_granularity = "full"`` when recompute
    is on without one."""
    model = config.Model
    if model.get("ffn_hidden_size") is None:
        model["ffn_hidden_size"] = 4 * model["hidden_size"]
    if model.get("use_recompute") and \
            not model.get("recompute_granularity"):
        model["recompute_granularity"] = "full"


def process_data_configs(config) -> None:
    """Derive each data mode's ``num_samples`` from the step and eval
    cadence (train: ``global_batch_size * max_steps``; eval:
    ``global_batch_size * (max_steps // eval_freq + 1) * eval_iters``;
    test: ``global_batch_size * test_iters``), its mode, seed and the
    sampler's batch size, in place."""
    g = config.Global
    engine = config.Engine
    max_steps = engine.get("max_steps", 500000)
    eval_freq = engine.get("eval_freq") or max(max_steps, 1)
    eval_iters = engine.get("eval_iters", 10)
    test_iters = engine.get("test_iters", eval_iters * 10)
    mode_to_num_samples = {
        "Train": g.global_batch_size * max_steps,
        "Eval": g.global_batch_size *
        (max_steps // eval_freq + 1) * eval_iters,
        "Test": g.global_batch_size * test_iters,
    }
    for mode, num in mode_to_num_samples.items():
        if mode in config.get("Data", {}):
            dataset = config.Data[mode]["dataset"]
            dataset.setdefault("num_samples", num)
            dataset.setdefault("mode", mode)
            dataset.setdefault("seed", g.get("seed", 1024))
            sampler = config.Data[mode].setdefault("sampler", {})
            sampler.setdefault("batch_size", g.local_batch_size)


def process_configs(config):
    """Model and data derivations, in place; returns ``config``."""
    process_model_configs(config)
    process_data_configs(config)
    return config
