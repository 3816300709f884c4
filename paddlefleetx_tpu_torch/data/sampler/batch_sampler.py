"""Resumable batch sampler (the port's copy of the JAX package's
``data/sampler/batch_sampler.py::GPTBatchSampler``).

Rank ``r`` of ``n`` dataflow ranks takes the ``r``-th ``batch_size``
slice of each ``batch_size * n`` index block; ``consumed_samples``
resumes the stream mid-epoch after a checkpoint restore.
"""

from __future__ import annotations

import math
from typing import Iterator, List

import numpy as np


class GPTBatchSampler:
    """Rank-sharded batch sampler resumable from ``consumed_samples``."""

    def __init__(self, dataset, batch_size: int, num_replicas: int = 1,
                 rank: int = 0, shuffle: bool = False,
                 drop_last: bool = True, consumed_samples: int = 0,
                 seed: int = 1234):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} out of range for "
                             f"{num_replicas} replicas")
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas
        self.local_rank = rank
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.consumed_samples = consumed_samples
        self.seed = seed
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / num_replicas))
        self.total_size = self.num_samples * num_replicas

    def __iter__(self) -> Iterator[List[int]]:
        if self.consumed_samples % self.nranks != 0:
            raise ValueError(
                f"consumed_samples ({self.consumed_samples}) must be "
                f"divisible by the dataflow world size ({self.nranks})")
        indices = np.arange(self.total_size)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(indices)
        block = self.batch_size * self.nranks
        start = self.local_rank * self.batch_size
        batch: List[int] = []
        for idx in indices[self.consumed_samples:]:
            batch.append(int(idx % len(self.dataset)))
            if len(batch) == block:
                yield batch[start:start + self.batch_size]
                batch = []
        if not self.drop_last and batch:
            yield batch

    def __len__(self) -> int:
        n = self.num_samples + int(not self.drop_last) * (
            self.batch_size - 1)
        return n // self.batch_size

    def set_epoch(self, epoch: int = 0, consumed_samples: int = 0) -> None:
        """Start epoch ``epoch`` after ``consumed_samples`` samples (the
        resume point)."""
        self.epoch = epoch
        self.consumed_samples = consumed_samples
