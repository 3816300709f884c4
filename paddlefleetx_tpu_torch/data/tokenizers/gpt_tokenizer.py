"""GPT-2 byte-level BPE tokenizer, fully offline (the port's copy of the
JAX package's ``data/tokenizers/gpt_tokenizer.py``).

``from_pretrained`` reads ``vocab.json`` + ``merges.txt`` (standard
GPT-2 format) from a local directory; without them it falls back to a
pure byte-level vocabulary (256 byte tokens + ``<|endoftext|>``) that
round-trips arbitrary text. Nothing is downloaded and no environment
variable is read.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import Dict, List, Optional

EOS_TOKEN = "<|endoftext|>"
#: GPT-2's eos id in the standard 50257-token vocab
GPT2_EOS_ID = 50256


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode mapping."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


# GPT-2 pre-tokenization pattern (contractions / words / numbers /
# punctuation / whitespace), via the `regex` module when available for
# \p classes, else a close ASCII approximation.
try:
    import regex as _re
    _PAT = _re.compile(
        r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
        r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")
except ImportError:  # pragma: no cover
    import re as _re
    _PAT = _re.compile(
        r"'s|'t|'re|'ve|'m|'ll|'d| ?[A-Za-z]+| ?[0-9]+"
        r"| ?[^\sA-Za-z0-9]+|\s+(?!\S)|\s+")


class GPTTokenizer:
    """Byte-level BPE: ``encode``, ``decode`` and the eos / pad ids, as
    in the reference (``gpt_tokenizer.py:90-392``)."""

    def __init__(self, vocab: Optional[Dict[str, int]] = None,
                 merges: Optional[List[str]] = None,
                 eos_token: str = EOS_TOKEN):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        if vocab is None:
            # byte-level fallback: one token per mapped byte + eos
            chars = sorted(self.byte_encoder.values())
            vocab = {c: i for i, c in enumerate(chars)}
            vocab[eos_token] = len(vocab)
            merges = []
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        merges = merges or []
        self.bpe_ranks = {
            tuple(m.split()): i for i, m in enumerate(merges)
            if m and not m.startswith("#version")}
        self.eos_token = eos_token
        self.cache: Dict[str, str] = {}

    @property
    def eos_token_id(self) -> int:
        return self.encoder[self.eos_token]

    # GPT-2 pads with eos
    pad_token_id = property(lambda self: self.eos_token_id)

    @classmethod
    def from_pretrained(cls, path: str = "gpt2") -> "GPTTokenizer":
        """Load ``vocab.json`` / ``merges.txt`` from the directory
        ``path``; fall back to the byte-level vocabulary when either is
        missing. Never downloads."""
        vocab_file = os.path.join(path, "vocab.json")
        merges_file = os.path.join(path, "merges.txt")
        if os.path.isfile(vocab_file) and os.path.isfile(merges_file):
            with open(vocab_file, encoding="utf-8") as f:
                vocab = json.load(f)
            with open(merges_file, encoding="utf-8") as f:
                merges = f.read().split("\n")
            return cls(vocab, merges)
        return cls()

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token)
        pairs = _get_pairs(word)
        if not pairs:
            return token
        while True:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def tokenize(self, text: str) -> List[str]:
        """BPE tokens of ``text`` (pre-tokenized by the GPT-2 pattern)."""
        tokens = []
        for piece in _PAT.findall(text):
            piece = "".join(self.byte_encoder[b]
                            for b in piece.encode("utf-8"))
            tokens.extend(self._bpe(piece).split(" "))
        return tokens

    def encode(self, text: str) -> List[int]:
        """Token ids of ``text``."""
        return [self.encoder[t] for t in self.tokenize(text)]

    def decode(self, ids) -> str:
        """Text of token ids; eos and ids outside the vocabulary are
        dropped."""
        text = "".join(
            self.decoder[int(i)] for i in ids
            if int(i) in self.decoder and self.decoder[int(i)]
            != self.eos_token)
        return bytearray(
            self.byte_decoder[c] for c in text if c in self.byte_decoder
        ).decode("utf-8", errors="replace")
