"""The GPT collate function (the port's copy of the JAX package's
``data/sampler/collate.py::gpt_collate_fn``). Outputs are numpy; the
engine moves a whole batch to the device once per step."""

from __future__ import annotations

import numpy as np


def gpt_collate_fn(batch):
    """``(tokens, position_ids, labels, loss_mask)`` stacked over the
    samples of ``batch``."""
    return tuple(np.stack([sample[i] for sample in batch])
                 for i in range(4))
