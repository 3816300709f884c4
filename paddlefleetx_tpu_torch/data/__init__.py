"""Data layer of the port: the GPT dataset, its sampler and collate,
the loader factories (counterparts of the JAX package's
``data/__init__.py``), and the tokenizer.

The loader fetches and collates in the calling thread: on one GPU the
fetch of a memory-mapped token batch is a copy, and a loader thread
would need a timeline track of its own. A loader thread is later work.
"""

from __future__ import annotations

import copy
from typing import Callable, Iterator

from .dataset.gpt_dataset import GPTDataset
from .sampler.batch_sampler import GPTBatchSampler
from .sampler.collate import gpt_collate_fn


class DataLoader:
    """Batches of ``dataset`` in the order of ``batch_sampler``, collated
    by ``collate_fn``, fetched in the calling thread."""

    def __init__(self, dataset, batch_sampler, collate_fn: Callable):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collate_fn = collate_fn

    def __iter__(self) -> Iterator:
        for indices in self.batch_sampler:
            yield self.collate_fn([self.dataset[i] for i in indices])

    def __len__(self) -> int:
        return len(self.batch_sampler)


def build_dataset(config, mode: str):
    """The dataset named in ``config[mode]["dataset"]``, or None when the
    mode has no section."""
    if mode not in ("Train", "Eval", "Test"):
        raise ValueError("mode must be Train, Eval or Test")
    if mode not in config:
        return None
    cfg = copy.deepcopy(dict(config[mode]["dataset"]))
    name = cfg.pop("name")
    if name != "GPTDataset":
        raise NotImplementedError(
            f"dataset {name!r} is not ported (GPTDataset is)")
    return GPTDataset(**cfg)


def build_dataloader(config, mode: str, num_replicas: int = 1,
                     rank: int = 0):
    """Dataset + rank-sliced sampler + loader of ``config[mode]`` (the
    ``Data`` section), or None when the mode has no section.
    ``loader.num_workers`` is accepted; loading happens in the calling
    thread whatever it says."""
    dataset = build_dataset(config, mode)
    if dataset is None:
        return None
    sampler_cfg = copy.deepcopy(dict(config[mode].get("sampler", {})))
    name = sampler_cfg.pop("name", "GPTBatchSampler")
    loader_cfg = dict(config[mode].get("loader", {}) or {})
    collate = loader_cfg.get("collate_fn") or \
        config[mode].get("collate_fn") or "gpt_collate_fn"
    if name != "GPTBatchSampler" or collate != "gpt_collate_fn":
        raise NotImplementedError(
            f"sampler {name!r} / collate_fn {collate!r} are not ported "
            f"(GPTBatchSampler / gpt_collate_fn are)")
    sampler_cfg.setdefault("batch_size", 1)
    sampler = GPTBatchSampler(dataset, num_replicas=num_replicas, rank=rank,
                              **sampler_cfg)
    return DataLoader(dataset, sampler, gpt_collate_fn)
