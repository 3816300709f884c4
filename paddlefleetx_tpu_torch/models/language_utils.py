"""Language-model config derivations (the port's copy of the JAX
package's ``models/language_utils.py::process_model_configs``).

Only the single-device derivations are kept: ffn defaults to 4*hidden
and a recompute granularity defaults to "full". Pipeline, sequence,
context and expert parallelism arrive with the multi-GPU slice.
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
