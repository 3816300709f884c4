"""Draft sources for speculative decoding on the slot server (the port
of the JAX package's ``core/spec.py``).

A draft source proposes, per request, ``k`` guesses for the tokens the
request will emit AFTER the one the current tick samples
(``verify_step`` scores the window ``[t0, d_1..d_k]`` in one forward,
``models/gpt/generation.py``). Drafts only affect throughput, never
output: a wrong draft just wastes its window column.

The shipped source is n-gram self-speculation ("prompt lookup"): match
the request's trailing n-gram against its own earlier history and
propose the continuation that followed last time. It needs no second
model. The :class:`DraftSource` protocol is minimal so another source
can sit behind the same ``GenerationConfig.spec_method`` switch.
"""

from __future__ import annotations

from typing import Protocol, Sequence


class DraftSource(Protocol):
    """Per-request draft proposal interface."""

    def propose(self, history: Sequence[int], k: int) -> list[int]:
        """Return exactly ``k`` guesses for the tokens following
        ``history`` PLUS the one token the verify tick samples itself
        (i.e. guesses for positions ``len(history) + 2 ..``, given that
        position ``len(history) + 1`` is sampled, not drafted).

        A source only needs to return ``k`` in-vocab ids; a bad guess
        costs accept rate, never correctness."""
        ...


class NgramDraftSource:
    """Suffix-match the last ``n`` tokens of ``history`` (``n`` from
    ``max_ngram`` down to 1) against earlier history; on a hit at
    position ``i`` the continuation ``history[i + n] ..`` is what
    followed that n-gram last time. Its first token ``g0`` is a guess
    for the tick's own sampled ``t0``, so the k DRAFTS are the
    continuation shifted by one. No match ⇒ zeros (cheap guaranteed
    rejection)."""

    def __init__(self, max_ngram: int = 3):
        if max_ngram < 1:
            raise ValueError(f"max_ngram must be >= 1, got {max_ngram}")
        self.max_ngram = max_ngram

    def propose(self, history: Sequence[int], k: int) -> list[int]:
        """Draft up to ``k`` tokens by replaying the continuation of
        the most recent n-gram match in ``history`` (longest n
        first); zeros when nothing matches. The JAX package's search,
        visiting only the earlier positions that hold the last token
        (every match of a suffix ends on one), latest first: the same
        drafts for a fraction of the host time."""
        hist = list(history)
        L = len(hist)
        last = hist[-1] if hist else None
        ends = [e for e in range(L - 2, -1, -1) if hist[e] == last]
        for n in range(min(self.max_ngram, L - 1), 0, -1):
            pattern = hist[L - n:]
            for e in ends:
                i = e - n + 1
                if i < 0:
                    break
                if hist[i:e + 1] == pattern:
                    drafts = hist[i + n + 1:i + n + k + 1]
                    return drafts + [0] * (k - len(drafts))
        return [0] * k


def make_draft_source(method: str, **kwargs) -> DraftSource:
    """Factory behind ``GenerationConfig.spec_method``."""
    if method == "ngram":
        return NgramDraftSource(**kwargs)
    raise ValueError(
        f"unknown spec_method {method!r} (supported: 'ngram')")
