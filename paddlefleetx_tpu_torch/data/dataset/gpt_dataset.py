"""Megatron-style GPT pretraining dataset over memory-mapped token files
(the port's copy of the JAX package's ``data/dataset/gpt_dataset.py``).

- data files: ``{prefix}_ids.npy`` (all token ids, 1-D) and
  ``{prefix}_idx.npz`` with ``lens`` per document;
- train/valid/test document split from a ratio list;
- document, sample and shuffle indices, cached next to the data as
  ``.npy`` files;
- a sample is ``(tokens, position_ids, labels, loss_mask)`` with EOS
  positions masked out of the loss.

One difference: whether this process builds the index files is the
``build_data_file`` argument (default True: one process on one GPU);
the JAX copy asks ``jax.process_index()``.
"""

from __future__ import annotations

import os
import time
from typing import List, Sequence

import numpy as np

from ...utils.log import logger
from ..data_tools.index_helpers import build_sample_idx

MODE_TO_INDEX = {"Train": 0, "Eval": 1, "Test": 2}


def get_train_data_file(input_dir: str) -> List[str]:
    """All dataset prefixes in a directory (files named ``*_idx.npz``)."""
    files = sorted(
        os.path.join(input_dir, f[: -len("_idx.npz")])
        for f in os.listdir(input_dir)
        if f.endswith("_idx.npz")
        and os.path.isfile(os.path.join(input_dir, f)))
    if not files:
        raise RuntimeError(
            f"no dataset (xxx_ids.npy + xxx_idx.npz) found in {input_dir!r}")
    return files


def get_train_valid_test_split_(splits: Sequence[float],
                                size: int) -> List[int]:
    """Split ``size`` docs by normalized ratios into 4 boundary indices."""
    splits = [float(s) for s in splits]
    splits += [0.0] * (3 - len(splits))
    splits = splits[:3]
    total = sum(splits)
    if total <= 0:
        raise ValueError("split ratios must sum to > 0")
    bounds = [0]
    for ratio in splits:
        bounds.append(bounds[-1] + int(round(ratio / total * size)))
    bounds[3] = size
    return bounds


def _num_epochs(tokens_per_epoch: int, seq_length: int,
                num_samples: int) -> int:
    if tokens_per_epoch <= 0:
        raise ValueError(
            "document split is empty (0 tokens) — check Data.*.dataset"
            ".split; small corpora can round a split share to zero docs")
    epochs = 0
    total_tokens = 0
    while True:
        epochs += 1
        total_tokens += tokens_per_epoch
        if (total_tokens - 1) // seq_length >= num_samples:
            return epochs


def _build_doc_idx(documents: np.ndarray, num_epochs: int,
                   separate_last_epoch: bool) -> np.ndarray:
    """Documents repeated per epoch, in order (samples are shuffled by
    the shuffle index, not here)."""
    if not separate_last_epoch or num_epochs == 1:
        return np.tile(np.asarray(documents, np.int32),
                       num_epochs).astype(np.int32)
    head = _build_doc_idx(documents, num_epochs - 1, False)
    tail = _build_doc_idx(documents, 1, False)
    return np.concatenate([head, tail])


def _build_shuffle_idx(num_samples: int, total_size: int,
                       np_rng: np.random.RandomState) -> np.ndarray:
    dtype = np.uint32 if total_size < np.iinfo(np.uint32).max - 1 \
        else np.int64
    first = np.arange(num_samples, dtype=dtype)
    np_rng.shuffle(first)
    if num_samples == total_size:
        return first
    last = np.arange(num_samples, total_size, dtype=dtype)
    np_rng.shuffle(last)
    return np.concatenate([first, last])


def _save_atomic(fn: str, arr: np.ndarray) -> None:
    """``np.save`` to a temporary name, then rename: a reader never
    sees a half-written index file."""
    tmp = fn + ".tmp.npy"
    np.save(tmp, arr)
    os.replace(tmp, fn)


def construct_samples_and_shuffle_data(name: str, data_prefix: str,
                                       documents: np.ndarray,
                                       sizes: np.ndarray, num_samples: int,
                                       seq_length: int, seed: int,
                                       build_data_file: bool):
    """Build (or load the cached) document, sample and shuffle indices.

    Returns:
        ``(doc_idx, sample_idx, shuffle_idx)``, memory-mapped.
    """
    tokens_per_epoch = int(np.sum(sizes[documents]))
    num_epochs = _num_epochs(tokens_per_epoch, seq_length, num_samples)
    np_rng = np.random.RandomState(seed=seed)

    stem = f"{data_prefix}_{name}_indexmap_{num_samples}ns_{seq_length}sl"
    filenames = (stem + "_doc_idx.npy", stem + "_sample_idx.npy",
                 stem + "_shuffle_idx.npy")

    if build_data_file and not all(os.path.isfile(f) for f in filenames):
        if num_epochs == 1:
            separate_last_epoch = False
        else:
            samples_before_last = ((num_epochs - 1) * tokens_per_epoch
                                   - 1) // seq_length
            last_epoch_samples = num_samples - samples_before_last
            samples_per_epoch = (tokens_per_epoch - 1) // seq_length
            # per-epoch sample counts alternate between floor(T/s) and
            # floor(T/s) + 1, so the last epoch may hold one more
            if not 0 <= last_epoch_samples <= samples_per_epoch + 1:
                raise ValueError("inconsistent sample/epoch accounting")
            separate_last_epoch = (
                last_epoch_samples < int(0.80 * samples_per_epoch))
        t0 = time.time()
        doc_idx = _build_doc_idx(documents, num_epochs, separate_last_epoch)
        _save_atomic(filenames[0], doc_idx)
        sample_idx = build_sample_idx(sizes, doc_idx, seq_length,
                                      num_epochs, tokens_per_epoch)
        _save_atomic(filenames[1], sample_idx)
        shuffle_n = samples_before_last if separate_last_epoch \
            else sample_idx.shape[0] - 1
        _save_atomic(filenames[2], _build_shuffle_idx(
            shuffle_n, sample_idx.shape[0] - 1, np_rng))
        logger.info("built index mappings for %s in %.2fs (%d samples)",
                    name, time.time() - t0, sample_idx.shape[0] - 1)
    elif not build_data_file:
        while not all(os.path.isfile(f) for f in filenames):
            time.sleep(1)

    return tuple(np.load(f, mmap_mode="r") for f in filenames)


class GPTDataset:
    """Index-mapped LM dataset; ``__getitem__`` returns ``[tokens,
    position_ids, labels, loss_mask]`` (Test mode: the first two).

    Args:
        input_dir (str): directory of ``*_ids.npy`` + ``*_idx.npz``.
        split: train/valid/test document ratios.
        max_seq_len (int): tokens per sample.
        num_samples (int): samples the index must cover.
        mode (str): ``Train``, ``Eval`` or ``Test``.
        seed (int): the shuffle seed.
        eos_id (int): EOS token, masked out of the loss.
        build_data_file (bool): whether this process writes the index
            files (others wait for them).
    """

    def __init__(self, input_dir: str, split: Sequence[float],
                 max_seq_len: int, num_samples: int, mode: str,
                 seed: int = 1234, eos_id: int = 50256,
                 build_data_file: bool = True):
        if mode not in MODE_TO_INDEX:
            raise ValueError(f"mode must be one of {list(MODE_TO_INDEX)}")
        prefix = get_train_data_file(input_dir)[0]
        for suffix in ("_ids.npy", "_idx.npz"):
            if not os.path.isfile(prefix + suffix):
                raise ValueError(f"file not found: {prefix + suffix}")
        self.sample_ids = np.load(prefix + "_ids.npy", mmap_mode="r",
                                  allow_pickle=True)
        self.sample_lens = np.load(prefix + "_idx.npz")["lens"].astype(
            np.int32)

        bounds = get_train_valid_test_split_(split, len(self.sample_lens))
        idx = MODE_TO_INDEX[mode]
        documents = np.arange(bounds[idx], bounds[idx + 1], dtype=np.int32)

        self.mode = mode
        self.max_seq_len = max_seq_len
        self.eos_id = eos_id
        self.name = "gpt_" + mode
        self.doc_idx, self.sample_idx, self.shuffle_idx = \
            construct_samples_and_shuffle_data(
                self.name, prefix, documents, self.sample_lens, num_samples,
                max_seq_len, seed, build_data_file)
        self.start_pos = np.concatenate(
            [[0], np.cumsum(self.sample_lens)]).astype(np.int64)

    def _tokens_for(self, doc_f: int, doc_l: int, off_f: int,
                    off_l: int) -> np.ndarray:
        if doc_f == doc_l:
            start = self.start_pos[self.doc_idx[doc_f]]
            return np.asarray(
                self.sample_ids[start + off_f: start + off_l + 1])
        chunks = []
        start = self.start_pos[self.doc_idx[doc_f]]
        end = self.start_pos[self.doc_idx[doc_f] + 1]
        chunks.append(self.sample_ids[start + off_f: end])
        for i in range(doc_f + 1, doc_l):
            start = self.start_pos[self.doc_idx[i]]
            end = self.start_pos[self.doc_idx[i] + 1]
            chunks.append(self.sample_ids[start:end])
        start = self.start_pos[self.doc_idx[doc_l]]
        chunks.append(self.sample_ids[start: start + off_l + 1])
        return np.concatenate(chunks)

    def __getitem__(self, index: int):
        idx = int(self.shuffle_idx[index])
        doc_f, off_f = self.sample_idx[idx]
        doc_l, off_l = self.sample_idx[idx + 1]
        seq = self._tokens_for(int(doc_f), int(doc_l), int(off_f),
                               int(off_l)).astype(np.int64)
        tokens, labels = seq[:-1], seq[1:]
        position_ids = np.arange(len(tokens), dtype=np.int64)
        if self.mode == "Test":
            return [tokens, position_ids]
        loss_mask = (tokens != self.eos_id).astype(np.float32)
        return [tokens, position_ids, labels, loss_mask]

    def __len__(self) -> int:
        return self.sample_idx.shape[0] - 1
