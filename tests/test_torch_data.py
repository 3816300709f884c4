"""The port's data path against the JAX package's on one synthetic
corpus: ``GPTDataset`` items, ``GPTBatchSampler`` batches (resumed from
``consumed_samples`` too) and ``gpt_collate_fn`` output are equal. Each
package builds its index files in a directory of its own."""

import os
import shutil

import numpy as np
import pytest

from paddlefleetx_tpu.data import GPTBatchSampler as JaxSampler
from paddlefleetx_tpu.data import GPTDataset as JaxDataset
from paddlefleetx_tpu.data import gpt_collate_fn as jax_collate
from paddlefleetx_tpu_torch.data import (
    GPTBatchSampler, GPTDataset, build_dataloader, gpt_collate_fn,
)
from paddlefleetx_tpu_torch.data.dataset.gpt_dataset import (
    get_train_valid_test_split_,
)
from paddlefleetx_tpu_torch.utils.config import AttrDict

from test_data import make_corpus


def _dirs(tmp_path):
    """The same corpus in two directories."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    make_corpus(jdir, n_docs=60, doc_len_range=(5, 90), vocab=500, eos=499)
    shutil.copytree(jdir, pdir)
    return str(jdir), str(pdir)


@pytest.mark.parametrize("mode", ["Train", "Eval"])
def test_dataset_items_equal(tmp_path, mode):
    jdir, pdir = _dirs(tmp_path)
    kw = dict(split=[8, 2, 0], max_seq_len=32, num_samples=70, mode=mode,
              seed=7, eos_id=499, build_data_file=True)
    jds, pds = JaxDataset(jdir, **kw), GPTDataset(pdir, **kw)
    assert len(jds) == len(pds) >= 70
    for i in range(len(pds)):
        for a, b in zip(pds[i], jds[i]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))


def test_sampler_resume_and_collate_equal(tmp_path):
    jdir, pdir = _dirs(tmp_path)
    kw = dict(split=[1, 0, 0], max_seq_len=16, num_samples=50,
              mode="Train", seed=3, eos_id=499, build_data_file=True)
    jds, pds = JaxDataset(jdir, **kw), GPTDataset(pdir, **kw)
    for consumed in (0, 12):
        js = JaxSampler(jds, batch_size=4, consumed_samples=consumed)
        ps = GPTBatchSampler(pds, batch_size=4, consumed_samples=consumed)
        jb, pb = list(js), list(ps)
        assert jb == pb and len(ps) == len(js)
        for idx in pb[:3]:
            for a, b in zip(gpt_collate_fn([pds[i] for i in idx]),
                            jax_collate([jds[i] for i in idx])):
                np.testing.assert_array_equal(a, b)
    ps.set_epoch(1, 8)
    assert next(iter(ps)) == list(range(8, 12))
    assert get_train_valid_test_split_([949, 50, 1], 40) == [0, 38, 40, 40]


def test_build_dataloader_from_a_data_section(tmp_path):
    _, pdir = _dirs(tmp_path)
    section = AttrDict({"Train": AttrDict({
        "dataset": AttrDict({"name": "GPTDataset", "input_dir": pdir,
                             "split": [1, 0, 0], "max_seq_len": 16,
                             "num_samples": 20, "mode": "Train",
                             "eos_id": 499}),
        "sampler": AttrDict({"name": "GPTBatchSampler", "batch_size": 4,
                             "shuffle": False, "drop_last": True}),
        "loader": AttrDict({"num_workers": 1,
                            "collate_fn": "gpt_collate_fn"})})})
    loader = build_dataloader(section, "Train")
    tokens, pos, labels, mask = next(iter(loader))
    assert tokens.shape == pos.shape == labels.shape == mask.shape == (4, 16)
    assert build_dataloader(section, "Eval") is None
    section.Train.dataset.name = "BlendedGPTDataset"
    with pytest.raises(NotImplementedError):
        build_dataloader(section, "Train")
