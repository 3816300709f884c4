"""The GPT collate functions (the port's copies of the JAX package's
``data/sampler/collate.py::gpt_collate_fn`` and ``gpt_eval_collate_fn``).
Outputs are numpy; the engine moves a whole batch to the device once per
step."""

from __future__ import annotations

import numpy as np


def _stack_fields(batch, n: int):
    return tuple(np.stack([sample[i] for sample in batch])
                 for i in range(n))


def gpt_collate_fn(batch):
    """``(tokens, position_ids, labels, loss_mask)`` stacked over the
    samples of ``batch``."""
    return _stack_fields(batch, 4)


def gpt_eval_collate_fn(batch):
    """``(tokens, loss_mask, attention_mask, position_ids, labels,
    info)`` of the offline evaluation datasets, stacked over the samples
    of ``batch``."""
    return _stack_fields(batch, 6)


#: the collate functions ``build_dataloader`` takes by name
COLLATE_FNS = {"gpt_collate_fn": gpt_collate_fn,
               "gpt_eval_collate_fn": gpt_eval_collate_fn}
