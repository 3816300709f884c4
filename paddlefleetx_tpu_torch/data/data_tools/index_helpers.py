"""The GPT sample-index builder (the port's copy of the Python builder
of the JAX package's ``data/dataset/gpt_dataset.py:93-125``).

Only the pure-Python builder is kept: the JAX package's C++
``fast_index_map`` belongs to that package and is not loaded here.
"""

from __future__ import annotations

import numpy as np


def build_sample_idx(sizes, doc_idx, seq_length: int, num_epochs: int,
                     tokens_per_epoch: int) -> np.ndarray:
    """Row ``i`` holds ``(doc_idx position, in-doc offset)`` of sample
    ``i``'s first token; one sample spans ``seq_length + 1`` tokens and
    consecutive samples overlap by one (the label shift).

    Args:
        sizes: tokens per document.
        doc_idx: the epoch-repeated document order.
        seq_length (int): tokens per sample.
        num_epochs (int): epochs ``doc_idx`` covers.
        tokens_per_epoch (int): tokens of one epoch.

    Returns:
        ``[num_samples + 1, 2]`` int32.
    """
    sizes = np.asarray(sizes, np.int32)
    doc_idx = np.asarray(doc_idx, np.int32)
    num_samples = (num_epochs * tokens_per_epoch - 1) // seq_length
    sample_idx = np.zeros((num_samples + 1, 2), np.int32)
    di, offset = 0, 0
    for s in range(1, num_samples + 1):
        remaining = seq_length + 1
        while remaining != 0:
            doc_len = sizes[doc_idx[di]] - offset
            remaining -= doc_len
            if remaining <= 0:
                offset += remaining + doc_len - 1
                remaining = 0
            else:
                di += 1
                offset = 0
        sample_idx[s] = (di, offset)
    return sample_idx
