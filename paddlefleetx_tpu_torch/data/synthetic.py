"""A synthetic token corpus in the ``GPTDataset`` file format.

No corpus ships with the repository, so the tests and the chip smoke
run write one from a seed: ``{prefix}_ids.npy`` (int32 token ids) and
``{prefix}_idx.npz`` (``lens`` per document), as
``data/dataset/gpt_dataset.py`` reads them. Tokens follow a Zipf law
and documents are stitched from a bank of recurring phrases, so a
model can learn something and the loss falls.
"""

from __future__ import annotations

import os

import numpy as np


def write_corpus(out_dir: str, vocab_size: int, n_tokens: int,
                 seed: int = 0, eos_id: int = None,
                 name: str = "synthetic") -> str:
    """Write a corpus of about ``n_tokens`` tokens into ``out_dir``.

    Args:
        out_dir (str): directory for ``{name}_ids.npy`` and
            ``{name}_idx.npz`` (created if missing).
        vocab_size (int): token ids are in ``[0, vocab_size)``.
        n_tokens (int): lower bound on the corpus's token count.
        seed (int): the ``numpy.random.default_rng`` seed.
        eos_id (int): the token ending each document (default
            ``vocab_size - 1``; other tokens never take it).
        name (str): the file prefix.

    Returns:
        The prefix ``out_dir/name``.
    """
    eos = vocab_size - 1 if eos_id is None else eos_id
    rng = np.random.default_rng(seed)

    def zipf(n):
        t = (rng.zipf(1.3, size=n) - 1) % (vocab_size - 1)
        return np.where(t >= eos, t + 1, t) % vocab_size

    phrases = [zipf(int(rng.integers(4, 17))) for _ in range(256)]
    # a phrase often follows a fixed successor: learnable structure
    successor = rng.integers(0, len(phrases), size=len(phrases))
    docs, total = [], 0
    while total < n_tokens:
        parts, length = [], int(rng.integers(64, 1536))
        cur = int(rng.integers(0, len(phrases)))
        while sum(len(p) for p in parts) < length:
            if rng.random() < 0.8:
                parts.append(phrases[cur])
                cur = int(successor[cur]) if rng.random() < 0.7 else \
                    int(rng.integers(0, len(phrases)))
            else:
                parts.append(zipf(int(rng.integers(1, 8))))
        doc = np.concatenate(parts + [np.asarray([eos])]).astype(np.int32)
        docs.append(doc)
        total += len(doc)
    os.makedirs(out_dir, exist_ok=True)
    prefix = os.path.join(out_dir, name)
    np.save(prefix + "_ids.npy", np.concatenate(docs))
    np.savez(prefix + "_idx.npz",
             lens=np.asarray([len(d) for d in docs], np.int32))
    return prefix
