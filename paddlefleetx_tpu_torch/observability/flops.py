"""Model FLOPs and MFU (the port's copy of the JAX package's
``observability/flops.py:29-75``, with the GPU's peak instead of the
TPUs' table)."""

from __future__ import annotations

from typing import Optional

#: dense bf16 tensor-core peak of one H100 SXM (NVIDIA data sheet, at the
#: full 700 W power limit)
H100_BF16_PEAK_FLOPS = 989e12


def model_flops_per_token(num_layers: int, hidden_size: int,
                          vocab_size: int, seq: int) -> float:
    """Megatron fwd+bwd model FLOPs per token of a GPT geometry:
    ``72*L*h^2*(1 + s/6h + V/12Lh)`` (ffn = 4h; recompute burns
    hardware FLOPs but counts no model FLOPs)."""
    L, h, V = num_layers, hidden_size, vocab_size
    return 72.0 * L * h * h * (1 + seq / (6.0 * h) + V / (12.0 * L * h))


def mfu(tokens_per_sec: float, flops_per_token: float,
        peak_per_chip: Optional[float] = H100_BF16_PEAK_FLOPS,
        n_chips: int = 1) -> Optional[float]:
    """Achieved model FLOPs over the aggregate peak, or None when the
    peak or the rate is unknown."""
    if not peak_per_chip or not tokens_per_sec:
        return None
    return tokens_per_sec * flops_per_token / (peak_per_chip * n_chips)
