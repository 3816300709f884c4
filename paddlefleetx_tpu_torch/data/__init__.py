"""Data layer of the port: the GPT dataset, the offline evaluation
datasets (WikiText LM, LAMBADA cloze), the sampler and the collates, the
loader factories (counterparts of the JAX package's
``data/__init__.py``), and the tokenizer.

The loader fetches and collates in the calling thread: on one GPU the
fetch of a memory-mapped token batch is a copy, and a loader thread
would need a timeline track of its own. A loader thread is later work.
"""

from __future__ import annotations

import copy
from typing import Callable, Iterator

from .dataset.gpt_dataset import GPTDataset
from .dataset.gpt_dataset_eval import Lambada_Eval_Dataset, LM_Eval_Dataset
from .sampler.batch_sampler import GPTBatchSampler
from .sampler.collate import (  # noqa: F401
    COLLATE_FNS, gpt_collate_fn, gpt_eval_collate_fn,
)

#: the datasets ``build_dataset`` takes by name; every other name raises
DATASETS = {"GPTDataset": GPTDataset, "LM_Eval_Dataset": LM_Eval_Dataset,
            "Lambada_Eval_Dataset": Lambada_Eval_Dataset}


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
    if name not in DATASETS:
        raise NotImplementedError(
            f"dataset {name!r} is not ported ({', '.join(DATASETS)} are)")
    return DATASETS[name](**cfg)


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
    if name != "GPTBatchSampler" or collate not in COLLATE_FNS:
        raise NotImplementedError(
            f"sampler {name!r} / collate_fn {collate!r} are not ported "
            f"(GPTBatchSampler / {', '.join(COLLATE_FNS)} are)")
    sampler_cfg.setdefault("batch_size", 1)
    sampler = GPTBatchSampler(dataset, num_replicas=num_replicas, rank=rank,
                              **sampler_cfg)
    return DataLoader(dataset, sampler, COLLATE_FNS[collate])
