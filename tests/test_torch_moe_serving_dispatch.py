"""MoE serving under the other two ``moe_dispatch`` lowerings, and the
entry points. ``einsum`` (the one-hot dispatch / combine tensors) and
``sort`` (counting-sort routing, batched matmuls) serve the tiny
8-expert model token for token as the JAX server does in the same mode,
on the same weights as ``sort_pallas``; each run counts its own lowering
once a layer and forward. ``cli serve`` and ``cli generate`` take the
MoE model through ``-o Model.moe_*`` overrides on the generation recipe
(bf16 on the CPU, paged and speculative through the recipe's knobs)."""

import os

import pytest

from _moe_serving_ref import (
    interpret, jax_serve, moe_pair, port_serve, prompts, with_dispatch,
)
from paddlefleetx_tpu_torch import cli

PROMPTS = prompts()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "nlp", "gpt",
                      "generation_gpt_345M_single_card.yaml")
#: the generation recipe cut to 2 layers and hidden 128, with the
#: 8x345M recipe's experts
TINY_MOE = ["Model.num_layers=2", "Model.hidden_size=128",
            "Model.num_attention_heads=2", "Model.ffn_hidden_size=256",
            "Model.vocab_size=300", "Model.max_position_embeddings=256",
            "Model.moe_num_experts=8", "Model.moe_top_k=2",
            "Model.moe_capacity_factor=1.25",
            "Model.moe_dispatch=sort_pallas", "Generation.max_dec_len=4"]


@pytest.fixture(scope="module")
def pair():
    with interpret():
        return moe_pair()


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_dispatch_modes_match_jax(pair, dispatch):
    """The contiguous server under ``dispatch``: the JAX rows traced
    through ``moe/<dispatch>``, the port's counted there."""
    other = with_dispatch(pair, dispatch)
    with interpret():
        want, _ = jax_serve(other, PROMPTS, num_slots=2,
                            counter=f"moe/{dispatch}")
    rows, summ = port_serve(other[2], PROMPTS, num_slots=2,
                            counter=f"moe/{dispatch}")
    assert rows == want
    assert "moe/sort_pallas" not in summ["counters"]


def _argv(*extra, over=()):
    out = ["-c", CONFIG, "--device", "cpu"]
    for o in (*TINY_MOE, *over):
        out += ["-o", o]
    return out + list(extra)


@pytest.mark.parametrize("over", [
    (),
    ("Model.kv_page_size=128", "Model.kv_pool_pages=5",
     "Generation.spec_method=ngram"),
])
def test_cli_serve_takes_an_moe_model(over):
    summary = cli.serve_main(_argv("--requests", "3", "--slots", "2",
                                   "--max-prompt-len", "20", over=over))
    assert summary["admitted"] == summary["evicted"] == 3
    assert set(summary["finish_reasons"]) <= {"eos", "length"}
    assert summary["decode_tokens"] > 0
    assert summary.get("paged", False) == bool(over)


def test_cli_generate_takes_an_moe_model():
    assert isinstance(cli.generate_main(_argv("--text", "Historia est")),
                      str)
