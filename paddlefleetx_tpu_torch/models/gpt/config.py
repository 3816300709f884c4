"""GPT hyper-parameters (the port's copy of the JAX package's
``models/gpt/config.py::GPTConfig``).

Same fields, defaults and ``from_config`` as the JAX package, so one
YAML ``Model`` section builds either model. The knobs whose code paths
this port does not have yet raise ``NotImplementedError`` at
construction instead of being ignored: paged KV (``kv_page_size``,
``kv_pool_pages``), the int8 KV cache, weight-only int8 execution,
LoRA, MoE and context parallelism. The training knobs act on the
training path (``model.py``): ``use_recompute`` and all four
``recompute_granularity`` values, ``loss_chunks`` and the two dropout
probabilities. The model-parallel knobs (pipeline schedule, virtual
pipeline degree, collective matmul, sequence parallelism) are
validated here and only matter across devices, which the engine
refuses for now (``core/engine.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ...utils.config import bf16_enabled


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """Frozen GPT hyper-parameters (the YAML ``Model`` section)."""

    vocab_size: int = 51200
    hidden_size: int = 768
    num_layers: int = 12
    num_attention_heads: int = 12
    ffn_hidden_size: Optional[int] = None
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 16
    initializer_range: float = 0.02
    use_recompute: bool = False
    recompute_granularity: str = "full"
    fused_linear: bool = False
    fuse_attn_qkv: bool = True
    sequence_parallel: bool = False
    use_collective_matmul: bool = False
    virtual_pp_degree: int = 1
    pipeline_schedule: str = "1F1B"
    zb_h2_depth: int = -1
    scan_layers: bool = True
    #: attention through the hand-written kernels (flash prefill, flash
    #: decode); False takes the dense PyTorch path
    use_flash_attention: bool = False
    context_parallel: bool = False
    context_parallel_algo: str = "ring"
    loss_chunks: int = 1
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_loss_weight: float = 0.01
    moe_z_loss_weight: float = 0.0
    moe_dispatch: str = "einsum"
    kv_page_size: int = 0
    kv_pool_pages: int = 0
    kv_cache_dtype: str = "bf16"
    quant_execution: str = "off"
    lora_rank: int = 0
    lora_num_adapters: int = 0
    lora_alpha: float = 0.0
    dtype: str = "float32"                # compute dtype (bf16 for AMP-O2)
    param_dtype: str = "float32"

    def __post_init__(self):
        if self.ffn_hidden_size is None:
            object.__setattr__(self, "ffn_hidden_size", 4 * self.hidden_size)
        if self.hidden_size % self.num_attention_heads != 0:
            raise ValueError(
                f"num_attention_heads ({self.num_attention_heads}) must "
                f"divide hidden_size ({self.hidden_size})")
        if self.recompute_granularity not in ("full", "full_attn",
                                              "core_attn", "save_dots"):
            raise ValueError(f"unknown recompute_granularity "
                             f"{self.recompute_granularity!r}")
        canon = {"1f1b": "1F1B", "gpipe": "GPipe", "zb": "zb",
                 "zb_h2": "zb_h2", "zb_auto": "zb_auto"}.get(
            str(self.pipeline_schedule).lower().replace("-", "_"))
        if canon is None:
            raise ValueError(f"unknown pipeline_schedule "
                             f"{self.pipeline_schedule!r}")
        object.__setattr__(self, "pipeline_schedule", canon)
        if self.context_parallel_algo not in ("ring", "ulysses"):
            raise ValueError(f"unknown context_parallel_algo "
                             f"{self.context_parallel_algo!r}")
        if self.kv_cache_dtype not in ("bf16", "int8"):
            raise ValueError(f"unknown kv_cache_dtype "
                             f"{self.kv_cache_dtype!r}")
        if self.quant_execution not in ("off", "weight_only_int8"):
            raise ValueError(f"unknown quant_execution "
                             f"{self.quant_execution!r}")
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute dtype {self.dtype!r}")
        unported = {
            "kv_page_size": self.kv_page_size != 0,
            "kv_pool_pages": self.kv_pool_pages != 0,
            "kv_cache_dtype": self.kv_cache_dtype == "int8",
            "quant_execution": self.quant_execution != "off",
            "lora_rank": self.lora_rank != 0,
            "lora_num_adapters": self.lora_num_adapters != 0,
            "moe_num_experts": self.moe_num_experts != 0,
            "context_parallel": self.context_parallel,
            "fuse_attn_qkv": not self.fuse_attn_qkv,
        }
        asked = sorted(k for k, on in unported.items() if on)
        if asked:
            raise NotImplementedError(
                f"GPTConfig knobs not ported to the PyTorch package yet: "
                f"{asked} (paged KV, int8 KV, int8 execution, LoRA, MoE, "
                f"context parallelism and unfused q/k/v are later slices)")

    @property
    def head_dim(self) -> int:
        """Per-head width ``hidden_size // num_attention_heads``."""
        return self.hidden_size // self.num_attention_heads

    @property
    def cache_capacity(self) -> int:
        """KV-cache positions per row: ``max_position_embeddings``
        rounded up to a multiple of 128, as in the JAX package (the
        rounding was a TPU tile rule; it is kept so both packages size
        their caches alike)."""
        return -(-self.max_position_embeddings // 128) * 128

    @classmethod
    def from_config(cls, config) -> "GPTConfig":
        """Build from a parsed YAML tree (Model + Engine sections)."""
        model = dict(config.get("Model", {}))
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in model.items()
                  if k in fields and v is not None}
        if model.get("use_recompute") and \
                not model.get("recompute_granularity"):
            kwargs["recompute_granularity"] = "full"
        if bf16_enabled(config):
            kwargs.setdefault("dtype", "bfloat16")
        return cls(**kwargs)
