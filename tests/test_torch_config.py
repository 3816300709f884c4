"""Config parity: the port's copy of the YAML system and ``GPTConfig``
read the serving recipe exactly as the JAX package does."""

import dataclasses
import os

import pytest

from paddlefleetx_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddlefleetx_tpu.models.language_utils import (
    process_model_configs as jax_process_model_configs,
)
from paddlefleetx_tpu.utils.config import get_config as jax_get_config
from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
from paddlefleetx_tpu_torch.models.language_utils import (
    process_model_configs,
)
from paddlefleetx_tpu_torch.utils.config import get_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN = os.path.join(ROOT, "configs", "nlp", "gpt",
                   "generation_gpt_345M_single_card.yaml")


@pytest.mark.parametrize("overrides", [
    [],
    ["Generation.max_dec_len=16", "Model.num_layers=2",
     "Engine.mix_precision.use_pure_fp16=False"],
])
def test_same_tree_in_both_packages(overrides):
    ours = get_config(GEN, overrides)
    theirs = jax_get_config(GEN, overrides, nranks=1)
    assert ours == theirs
    process_model_configs(ours)
    jax_process_model_configs(theirs)
    assert ours == theirs


def test_gpt_config_fields_match_jax():
    ours = GPTConfig.from_config(get_config(GEN))
    theirs = JaxGPTConfig.from_config(jax_get_config(GEN, nranks=1))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.dtype == "bfloat16"
    assert ours.num_layers == 24 and ours.hidden_size == 1024
    assert ours.num_attention_heads == 16 and ours.head_dim == 64
    assert ours.vocab_size == 50304
    assert ours.max_position_embeddings == 1024
    assert ours.use_flash_attention is True
    assert ours.cache_capacity == theirs.cache_capacity == 1024
    assert [f.name for f in dataclasses.fields(GPTConfig)] == \
        [f.name for f in dataclasses.fields(JaxGPTConfig)]


def test_fp32_override_gives_fp32_compute():
    cfg = GPTConfig.from_config(get_config(
        GEN, ["Engine.mix_precision.use_pure_fp16=False"]))
    assert cfg.dtype == "float32"


#: the int8 and LoRA knobs (ported) beside a knob that is not: only the
#: latter is named
@pytest.mark.parametrize("knob", [
    {"kv_page_size": 128, "kv_pool_pages": 9, "kv_cache_dtype": "int8",
     "fuse_attn_qkv": False},
    {"kv_cache_dtype": "int8", "context_parallel": True},
    {"quant_execution": "weight_only_int8", "fuse_attn_qkv": False},
    {"lora_rank": 4, "lora_num_adapters": 2, "context_parallel": True},
    {"context_parallel": True, "context_parallel_algo": "ulysses"},
    {"context_parallel": True},
    {"fuse_attn_qkv": False},
])
def test_unported_knobs_raise(knob):
    with pytest.raises(NotImplementedError, match="not ported") as err:
        GPTConfig(vocab_size=64, hidden_size=32, num_layers=1,
                  num_attention_heads=2, max_position_embeddings=128,
                  **knob)
    assert "kv_cache_dtype" not in str(err.value)
    assert "quant_execution" not in str(err.value)
    assert "lora" not in str(err.value).lower()


@pytest.mark.parametrize("knob", [
    {"kv_page_size": 128, "kv_pool_pages": 9, "kv_cache_dtype": "int8"},
    {"kv_cache_dtype": "int8"},
    {"quant_execution": "weight_only_int8"},
])
def test_int8_knobs_validate_like_jax(knob):
    """The int8 knobs build as in the JAX package, field for field, and
    reach the config from the YAML through ``-o`` overrides."""
    kw = {"vocab_size": 64, "hidden_size": 32, "num_layers": 1,
          "num_attention_heads": 2, "max_position_embeddings": 1024,
          **knob}
    assert dataclasses.asdict(GPTConfig(**kw)) == \
        dataclasses.asdict(JaxGPTConfig(**kw))
    over = [f"Model.{k}={v}" for k, v in knob.items()]
    ours = GPTConfig.from_config(get_config(GEN, over))
    theirs = JaxGPTConfig.from_config(jax_get_config(GEN, over, nranks=1))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for k, v in knob.items():
        assert getattr(ours, k) == v


@pytest.mark.parametrize("bad", [
    {"recompute_granularity": "nope"},
    {"pipeline_schedule": "nope"},
    {"kv_cache_dtype": "fp8"},
    {"quant_execution": "int4"},
    {"num_attention_heads": 5},
])
def test_invalid_values_raise_like_jax(bad):
    kw = {"vocab_size": 64, "hidden_size": 32, "num_layers": 1,
          "num_attention_heads": 2, **bad}
    with pytest.raises(ValueError):
        JaxGPTConfig(**kw)
    with pytest.raises(ValueError):
        GPTConfig(**kw)


def test_override_semantics():
    cfg = get_config(GEN, ["Global.seed=7", "Model.scan_layers=True"])
    assert cfg.Global.seed == 7 and cfg.Model.scan_layers is True
    with pytest.raises(TypeError, match="scalar"):
        get_config(GEN, ["Global.seed.x=1"])
    with pytest.raises(ValueError, match="key=value"):
        get_config(GEN, ["Global.seed"])


@pytest.mark.parametrize("paged", [
    {"kv_page_size": 128, "kv_pool_pages": 9},      # accepted
    {"kv_page_size": 128, "kv_pool_pages": 2},      # pool < max pages + 1
    {"kv_page_size": 64, "kv_pool_pages": 9},       # not a 128 multiple
    {"kv_page_size": 384, "kv_pool_pages": 9},      # does not tile 1024
    {"kv_pool_pages": 9},                           # pool without a page
])
def test_paged_knobs_validate_like_jax(paged):
    """``kv_page_size`` / ``kv_pool_pages`` are accepted or refused by
    both packages alike, with the same ``max_kv_pages``."""
    kw = {"vocab_size": 64, "hidden_size": 32, "num_layers": 1,
          "num_attention_heads": 2, "max_position_embeddings": 1024,
          **paged}
    try:
        theirs = JaxGPTConfig(**kw)
    except ValueError as e:
        with pytest.raises(ValueError) as ours:
            GPTConfig(**kw)
        assert str(ours.value) == str(e)
        return
    ours = GPTConfig(**kw)
    assert ours.max_kv_pages == theirs.max_kv_pages == 8


def test_paged_recipe_override_reaches_the_config():
    over = ["Model.kv_page_size=128", "Model.kv_pool_pages=65"]
    ours = GPTConfig.from_config(get_config(GEN, over))
    theirs = JaxGPTConfig.from_config(jax_get_config(GEN, over, nranks=1))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.max_kv_pages == 8 and ours.kv_pool_pages == 65
