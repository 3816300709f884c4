"""Offline evaluation datasets (the port's copy of the JAX package's
``data/dataset/gpt_dataset_eval.py``): WikiText LM perplexity and the
LAMBADA cloze.

- ``LM_Eval_Dataset``: raw text -> WikiText detokenizer -> tokens;
  windows of ``max_seq_len`` with stride ``overlapping_eval``; a
  window after the first scores only its last ``overlapping_eval``
  targets; each sample carries ``[num_original_tokens,
  num_tokenized_tokens]`` for the adjusted perplexity.
- ``Lambada_Eval_Dataset``: JSONL with ``text``; the last word is the
  cloze target, and only its tokens are in the loss mask.

Both return the 6-field sample ``[tokens, loss_mask, attention_mask,
position_ids, labels, info]``; the attention mask is a placeholder kept
for the collate's six fields (the model applies causality itself). The
pad token is ``eos`` and the loss mask is ``tokens != pad``, so a real
``eos`` inside the text is masked too, as in the JAX package.
"""

from __future__ import annotations

import json
import math
import re
from typing import List, Optional

import numpy as np

from ..tokenizers.gpt_tokenizer import GPTTokenizer


def wikitext_detokenizer(string: str) -> str:
    """Invert the WikiText tokenization quirks (`` @-@ ``, spaced
    punctuation) so perplexity is scored on natural text."""
    string = string.replace("s '", "s'")
    string = re.sub(r"/' [0-9]/", r"/'[0-9]/", string)
    string = string.replace(" @-@ ", "-")
    string = string.replace(" @,@ ", ",")
    string = string.replace(" @.@ ", ".")
    string = string.replace(" : ", ": ")
    string = string.replace(" ; ", "; ")
    string = string.replace(" . ", ". ")
    string = string.replace(" ! ", "! ")
    string = string.replace(" ? ", "? ")
    string = string.replace(" , ", ", ")
    string = re.sub(r"\(\s*([^\)]*?)\s*\)", r"(\1)", string)
    string = re.sub(r"\[\s*([^\]]*?)\s*\]", r"[\1]", string)
    string = re.sub(r"{\s*([^}]*?)\s*}", r"{\1}", string)
    string = re.sub(r"\"\s*([^\"]*?)\s*\"", r'"\1"', string)
    string = re.sub(r"'\s*([^']*?)\s*'", r"'\1'", string)
    string = string.replace("= = = =", "====")
    string = string.replace("= = =", "===")
    string = string.replace("= =", "==")
    string = string.replace(" " + chr(176) + " ", chr(176))
    string = string.replace(" \n", "\n")
    string = string.replace("\n ", "\n")
    string = string.replace(" N ", " 1 ")
    string = string.replace(" 's", "'s")
    return string


def _construct_sample(tokens: List[int], pad_idx: int):
    tokens = np.asarray(tokens, np.int64)
    labels, tokens = tokens[1:], tokens[:-1]
    # the reference ships a [1, seq, seq] tril mask per sample
    # (gpt_dataset.py:497-510); the model applies causality internally,
    # so a scalar placeholder keeps the 6-field collate contract
    # without the O(seq^2) allocation + transfer per sample
    attention_mask = np.zeros(1, np.float32)
    position_ids = np.arange(len(tokens), dtype=np.int64)
    return tokens, attention_mask, position_ids, labels


class LM_Eval_Dataset:
    """Sliding-window LM perplexity eval over a raw text file
    (WikiText-style; ``overlapping_eval`` sets the window stride)."""

    def __init__(self, input_dir: str, max_seq_len: int,
                 overlapping_eval: Optional[int] = None,
                 tokenizer: Optional[GPTTokenizer] = None, **_):
        tokenizer = tokenizer or GPTTokenizer.from_pretrained("gpt2")
        with open(input_dir, "rb") as f:
            raw = f.read().decode("utf-8")
        self.num_original_tokens = len(raw.strip().split(" "))
        self.tokens = tokenizer.encode(wikitext_detokenizer(raw))
        self.num_tokenized_tokens = len(self.tokens)
        self.seq_len = max_seq_len
        self.pad_idx = tokenizer.eos_token_id
        self.overlapping_eval = max(1, overlapping_eval or max_seq_len)
        targets = max(len(self.tokens) - 1 - self.overlapping_eval, 0)
        self.total_sequences = max(
            math.ceil(targets / self.overlapping_eval) + 1, 1)

    def __len__(self) -> int:
        return self.total_sequences

    def __getitem__(self, idx: int):
        start = idx * self.overlapping_eval
        tokens = list(self.tokens[start: start + self.seq_len + 1])
        tokens += [self.pad_idx] * (self.seq_len + 1 - len(tokens))
        toks, attn, pos, labels = _construct_sample(tokens, self.pad_idx)
        loss_mask = (toks != self.pad_idx).astype(np.float32)
        if self.overlapping_eval != self.seq_len and idx != 0:
            loss_mask[: -self.overlapping_eval] = 0.0
        info = np.array([self.num_original_tokens,
                         self.num_tokenized_tokens], np.int64)
        return [toks, loss_mask, attn, pos, labels, info]


class Lambada_Eval_Dataset:
    """LAMBADA last-word cloze eval from the jsonl release; the loss
    mask covers only the target word's tokens."""

    def __init__(self, input_dir: str, max_seq_len: int,
                 tokenizer: Optional[GPTTokenizer] = None, **_):
        tokenizer = tokenizer or GPTTokenizer.from_pretrained("gpt2")
        self.pad_idx = tokenizer.eos_token_id
        self.seq_len = max_seq_len
        self.tokens: List[List[int]] = []
        self.labels: List[List[int]] = []
        with open(input_dir, "r", encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                text = json.loads(line)["text"]
                toks, label = self._get_tokens(tokenizer, text)
                self.tokens.append(toks)
                self.labels.append(label)

    @staticmethod
    def _get_tokens(tokenizer, text: str, strict: bool = True):
        if not strict:
            ids = tokenizer.encode(text)
            return ids[:-1], [ids[-1]]
        last_word = text.split()[-1]
        start = text.rfind(last_word)
        prefix = tokenizer.encode(text[:start].strip())
        target = tokenizer.encode(" " + last_word)
        return prefix, target

    def __len__(self) -> int:
        return len(self.tokens)

    def __getitem__(self, idx: int):
        tokens = self.tokens[idx][: self.seq_len]
        labels = self.labels[idx]
        seq = tokens + labels
        n = len(seq)
        seq = seq + [self.pad_idx] * (self.seq_len + 1 - n)
        loss_mask = np.zeros(self.seq_len, np.float32)
        loss_mask[n - len(labels) - 1: n - 1] = 1.0
        toks, attn, pos, lab = _construct_sample(seq, self.pad_idx)
        info = np.array([len(self.tokens)], np.int64)
        return [toks, loss_mask, attn, pos, lab, info]
