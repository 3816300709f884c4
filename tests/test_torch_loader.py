"""The port's ``DataLoader`` (``data/loader.py``) against the JAX
package's on one synthetic corpus: the producer thread (``num_workers``
<= 1) and the process pool (``num_workers`` 2) both give exactly the JAX
loader's batches in its order, shuffled over two epochs too; an early
break leaves no producer parked; a worker's or the producer's error is
raised in the consumer; an unpicklable dataset takes the thread path
with a warning; ``build_dataloader`` passes ``num_workers``,
``prefetch_depth`` and the rank-offset seed as the JAX factory does."""

import logging
import shutil
import threading
import time

import numpy as np
import pytest

from paddlefleetx_tpu.data import DataLoader as JaxLoader
from paddlefleetx_tpu.data import GPTBatchSampler as JaxSampler
from paddlefleetx_tpu.data import GPTDataset as JaxDataset
from paddlefleetx_tpu.data import gpt_collate_fn as jax_collate
from paddlefleetx_tpu_torch.data import (
    DataLoader, GPTBatchSampler, GPTDataset, build_dataloader,
    gpt_collate_fn,
)
from paddlefleetx_tpu_torch.utils.config import AttrDict
from paddlefleetx_tpu_torch.utils.log import logger

from test_data import make_corpus

KW = dict(split=[1, 0, 0], max_seq_len=16, num_samples=60, mode="Train",
          seed=3, eos_id=499, build_data_file=True)


def _datasets(tmp_path):
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    make_corpus(jdir, n_docs=60, doc_len_range=(5, 90), vocab=500, eos=499)
    shutil.copytree(jdir, pdir)
    return JaxDataset(str(jdir), **KW), GPTDataset(str(pdir), **KW)


def _epochs(loader, epochs=2):
    out = []
    for ep in range(epochs):
        loader.batch_sampler.set_epoch(ep)
        out.append([tuple(np.array(x) for x in b) for b in loader])
    return out


@pytest.mark.parametrize("workers,shuffle", [
    (0, False), (1, True), (2, False), (2, True)])
def test_both_paths_give_the_jax_loaders_batches(tmp_path, workers,
                                                 shuffle):
    """Thread path (0 / 1 workers) and process pool (2) against the JAX
    loader (its thread path), batch for batch over two epochs."""
    jds, pds = _datasets(tmp_path)
    jl = JaxLoader(jds, JaxSampler(jds, batch_size=4, shuffle=shuffle),
                   jax_collate, num_workers=1, seed=11)
    pl = DataLoader(pds, GPTBatchSampler(pds, batch_size=4,
                                         shuffle=shuffle),
                    gpt_collate_fn, num_workers=workers, seed=11)
    want, got = _epochs(jl), _epochs(pl)
    assert len(got[0]) == len(want[0]) == len(pl) > 10
    for ep in range(2):
        for a, b in zip(got[ep], want[ep]):
            assert len(a) == len(b) == 4
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
                assert x.dtype == y.dtype
    if shuffle:
        assert not all(np.array_equal(a[0], b[0])
                       for a, b in zip(got[0], got[1]))


def _producers():
    return [t for t in threading.enumerate() if t.name == "data-loader"]


def test_early_break_does_not_hang(tmp_path):
    """A consumer that breaks after one batch: the producer, parked on a
    full queue of depth 1, sees the stop event and exits."""
    _, pds = _datasets(tmp_path)
    before = len(_producers())
    loader = DataLoader(pds, GPTBatchSampler(pds, batch_size=2),
                        gpt_collate_fn, num_workers=0)
    for _batch in loader:
        time.sleep(0.05)       # let the producer fill the queue
        break
    deadline = time.time() + 5.0
    while len(_producers()) > before and time.time() < deadline:
        time.sleep(0.02)
    assert len(_producers()) == before
    pool = DataLoader(pds, GPTBatchSampler(pds, batch_size=2),
                      gpt_collate_fn, num_workers=2)
    t0 = time.time()
    for _batch in pool:
        break
    assert time.time() - t0 < 60


class _Boom:
    """A picklable dataset whose item 5 raises."""

    def __init__(self, n=16):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == 5:
            raise KeyError(f"sample {i} is broken")
        return (np.full(4, i, np.int64),)


class _Sampler:
    def __init__(self, n, bs):
        self.n, self.bs = n, bs

    def __iter__(self):
        return iter([list(range(i, i + self.bs))
                     for i in range(0, self.n, self.bs)])

    def __len__(self):
        return self.n // self.bs


def _stack(samples):
    return tuple(np.stack(f) for f in zip(*samples))


@pytest.mark.parametrize("workers", [0, 2])
def test_a_fetch_error_is_raised_in_the_consumer(workers):
    """The producer thread's and a pool worker's exception reach the
    consumer after the batches before it, in order."""
    loader = DataLoader(_Boom(), _Sampler(16, 2), _stack,
                        num_workers=workers)
    got = []
    with pytest.raises(KeyError, match="sample 5"):
        for batch in loader:
            got.append(int(batch[0][0, 0]))
    assert got == [0, 2]


def test_an_unpicklable_dataset_takes_the_thread_path(tmp_path):
    """``num_workers`` 2 over a dataset that does not pickle: a warning,
    and the same batches from the producer thread."""
    lock = threading.Lock()

    class Local(_Boom):
        def __getitem__(self, i):
            with lock:
                return (np.full(4, i, np.int64),)

    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())
    handler = Keep()
    logger.addHandler(handler)
    try:
        got = [int(b[0][0, 0]) for b in DataLoader(
            Local(), _Sampler(16, 4), _stack, num_workers=2)]
    finally:
        logger.removeHandler(handler)
    assert got == [0, 4, 8, 12]
    assert any("picklable" in r and "threaded loader" in r
               for r in records), records


def test_build_dataloader_passes_the_loader_knobs(tmp_path):
    """``loader.num_workers`` / ``prefetch_depth`` reach the loader, the
    seed is ``Global.seed + 1009 * rank`` as in the JAX factory, and the
    auto schema's section-level ``collate_fn`` and ``sample_split``
    parse."""
    _, pds = _datasets(tmp_path)
    dataset = dict(KW, name="GPTDataset",
                   input_dir=str(tmp_path / "port"))
    cfg = AttrDict({"Train": AttrDict({
        "dataset": AttrDict(dataset),
        "sampler": AttrDict({"name": "GPTBatchSampler", "batch_size": 4}),
        "loader": AttrDict({"num_workers": 2, "prefetch_depth": 3,
                            "return_list": False,
                            "collate_fn": "gpt_collate_fn"})}),
        "Eval": AttrDict({"dataset": AttrDict(dataset),
                          "collate_fn": "gpt_collate_fn",
                          "sample_split": 2})})
    loader = build_dataloader(cfg, "Train", num_replicas=2, rank=1, seed=5)
    assert (loader.num_workers, loader.prefetch_depth, loader.seed) == \
        (2, 3, 5 + 1009)
    ev = build_dataloader(cfg, "Eval", seed=5)
    assert ev.collate_fn is gpt_collate_fn and ev.num_workers == 1
    assert ev.seed == 5 and len(next(iter(ev))) == 4
