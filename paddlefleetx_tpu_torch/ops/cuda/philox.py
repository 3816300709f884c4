"""Philox4x32-10 in plain PyTorch: the attention-dropout keep mask.

The same function as ``csrc/philox.cuh``, element for element: the
keep decision of score element ``(bh, row, col)`` (``row`` a query,
``col`` a key, ``bh = batch * heads + head``) is

    bits = philox4x32_10(ctr=(col >> 2, row, bh, 0),
                         key=(seed & 0xffffffff, seed >> 32))[col & 3]
    keep = bits < keep_threshold(rate)

so it depends on absolute coordinates only, never on a tile size: the
forward kernel, both backward kernels, the plain versions and the dense
attention path all rebuild the same mask. uint32 arithmetic is done in
int64 tensors masked to 32 bits; the 32 x 32 -> 64 bit multiply is
split into 16-bit halves so no intermediate leaves int64.
"""

from __future__ import annotations

from typing import Tuple

import torch

M32 = 0xFFFFFFFF
#: Philox4x32 round multipliers and Weyl key increments (Random123)
MUL0, MUL1 = 0xD2511F53, 0xCD9E8D57
WEYL0, WEYL1 = 0x9E3779B9, 0xBB67AE85


def keep_threshold(rate: float) -> int:
    """The uint32 threshold: keep iff the bits fall below
    ``(1 - rate) * 2^32``, clamped so a tiny rate keeps nearly all
    (the TPU kernel's ``_dropout_threshold``)."""
    return min(M32, int(round((1.0 - rate) * 4294967296.0)))


def keep_scale(rate: float) -> float:
    """``1 / (1 - rate)`` rounded to fp32, the factor kept values get."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` 32-bit halves of ``a * b`` for a constant ``a`` and
    uint32 values ``b`` held in int64."""
    p_lo = a * (b & 0xFFFF)          # < 2^48
    p_hi = a * (b >> 16)             # < 2^48
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & M32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Ten Philox4x32 rounds over counters ``c0..c3`` (int64 tensors or
    ints holding uint32 values, broadcastable); returns the four output
    words as int64 tensors."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64)
                      for c in (c0, c1, c2, c3))
    for i in range(10):
        if i:
            k0 = (k0 + WEYL0) & M32
            k1 = (k1 + WEYL1) & M32
        hi0, lo0 = _mulhilo(MUL0, c0)
        hi1, lo1 = _mulhilo(MUL1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_bits(seed: int, bh: torch.Tensor, row0: int, n_rows: int,
                 col0: int, n_cols: int) -> torch.Tensor:
    """The uint32 bits (in int64) of elements ``(bh, row0 + i, col0 +
    j)`` as a ``[len(bh), n_rows, n_cols]`` tensor on ``bh``'s device;
    one Philox call covers four neighbouring keys of a row."""
    dev = bh.device
    g0, g1 = col0 >> 2, (col0 + n_cols - 1) >> 2
    groups = torch.arange(g0, g1 + 1, dtype=torch.int64, device=dev)
    rows = torch.arange(row0, row0 + n_rows, dtype=torch.int64, device=dev)
    words = philox4x32_10(groups[None, None, :], rows[None, :, None],
                          bh.to(torch.int64)[:, None, None], 0,
                          seed & M32, (seed >> 32) & M32)
    full = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    full = full.reshape(len(bh), n_rows, -1)
    start = col0 - 4 * g0
    return full[:, :, start:start + n_cols]


def keep_mask(seed: int, rate: float, bh: torch.Tensor, row0: int,
              n_rows: int, col0: int, n_cols: int) -> torch.Tensor:
    """Boolean keep mask of the same elements as :func:`dropout_bits`."""
    return dropout_bits(seed, bh, row0, n_rows, col0, n_cols) < \
        keep_threshold(rate)


def attention_keep_mask(seed: int, rate: float, b: int, h: int, sq: int,
                        skv: int, device) -> torch.Tensor:
    """The whole ``[b, h, sq, skv]`` keep mask of one attention call."""
    bh = torch.arange(b * h, device=device)
    return keep_mask(seed, rate, bh, 0, sq, 0, skv).reshape(b, h, sq, skv)
