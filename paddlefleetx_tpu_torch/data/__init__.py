"""Data layer of the port: the GPT dataset, the offline evaluation
datasets (WikiText LM, LAMBADA cloze), the sampler and the collates, the
loader factories (counterparts of the JAX package's
``data/__init__.py``), the loader (``data/loader.py``: a producer
thread, or a process pool with ``num_workers > 1``), and the tokenizer.
"""

from __future__ import annotations

import copy

from .dataset.gpt_dataset import GPTDataset
from .dataset.gpt_dataset_eval import Lambada_Eval_Dataset, LM_Eval_Dataset
from .loader import DataLoader
from .sampler.batch_sampler import GPTBatchSampler
from .sampler.collate import (  # noqa: F401
    COLLATE_FNS, gpt_collate_fn, gpt_eval_collate_fn,
)

#: the datasets ``build_dataset`` takes by name; every other name raises
DATASETS = {"GPTDataset": GPTDataset, "LM_Eval_Dataset": LM_Eval_Dataset,
            "Lambada_Eval_Dataset": Lambada_Eval_Dataset}


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
                     rank: int = 0, seed=None):
    """Dataset + rank-sliced sampler + loader of ``config[mode]`` (the
    ``Data`` section), or None when the mode has no section. The
    ``loader`` block's ``num_workers`` and ``prefetch_depth`` reach the
    :class:`DataLoader`, and ``seed`` (``Global.seed``) its workers'
    seed, offset by ``1009 * rank``, as in the JAX package. The auto
    schema's section-level ``collate_fn`` is read as the ``loader``
    block's, and its ``sample_split`` is accepted and has no effect, as
    on the JAX side."""
    dataset = build_dataset(config, mode)
    if dataset is None:
        return None
    sampler_cfg = copy.deepcopy(dict(config[mode].get("sampler", {})))
    name = sampler_cfg.pop("name", "GPTBatchSampler")
    loader_cfg = copy.deepcopy(dict(config[mode].get("loader", {}) or {}))
    loader_cfg.pop("return_list", None)
    collate = loader_cfg.pop("collate_fn", None) or \
        config[mode].get("collate_fn") or "gpt_collate_fn"
    if name != "GPTBatchSampler" or collate not in COLLATE_FNS:
        raise NotImplementedError(
            f"sampler {name!r} / collate_fn {collate!r} are not ported "
            f"(GPTBatchSampler / {', '.join(COLLATE_FNS)} are)")
    sampler_cfg.setdefault("batch_size", 1)
    sampler = GPTBatchSampler(dataset, num_replicas=num_replicas, rank=rank,
                              **sampler_cfg)
    if seed is not None:
        loader_cfg.setdefault("seed", int(seed) + 1009 * rank)
    return DataLoader(dataset, sampler, COLLATE_FNS[collate], **loader_cfg)
