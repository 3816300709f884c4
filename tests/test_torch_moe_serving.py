"""MoE serving on the contiguous cache and the lockstep ``generate()``:
the port's greedy rows of the tiny 8-expert model (top-2, capacity
factor 1.25, ``sort_pallas``) equal the JAX package's, token for token,
mode by mode: the contiguous server (each admission routed at its
prompt-length bucket, each decode tick one group a slot), the
speculative contiguous server (the verify window of 4 tokens, capacity
1) and ``generate()`` over a left-padded batch, whose pads come first in
each row's routing group and take capacity before the real tokens. The
JAX references run their Pallas kernels in interpret mode and show a
``moe/sort_pallas`` trace; the port's runs count ``moe/sort_pallas``
once a layer and forward. Slot count and admission order leave the
port's rows unchanged, as they leave the JAX server's (each admission
is its own routing group)."""

import pytest
import torch

from _moe_serving_ref import (
    MOE_KW, PAD, SEED, interpret, jax_generate, jax_serve, moe_pair,
    port_counters, port_serve, prompts, truncate,
)
from paddlefleetx_tpu_torch.core.serving import GenerationServer
from paddlefleetx_tpu_torch.models.gpt import generation as gen
from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
from paddlefleetx_tpu_torch.models.gpt.generation import (
    GenerationConfig, generate,
)
from paddlefleetx_tpu_torch.models.gpt.model import build_model

PROMPTS = prompts()


@pytest.fixture(scope="module")
def ref():
    """The port model and the JAX rows: the contiguous server (2
    slots), the speculative contiguous server (3 slots, 3 drafts) and
    ``generate()`` over the left-padded prompts."""
    with interpret():
        pair = moe_pair()
        contiguous, _ = jax_serve(pair, PROMPTS, num_slots=2)
        spec, _ = jax_serve(pair, PROMPTS, spec=3, num_slots=3)
        lockstep = jax_generate(pair, PROMPTS)
    return {"model": pair[2], "contiguous": contiguous, "spec": spec,
            "generate": lockstep}


def test_contiguous_server_matches_jax(ref):
    rows, summ = port_serve(ref["model"], PROMPTS, num_slots=2)
    assert rows == ref["contiguous"]
    assert summ["admitted"] == len(PROMPTS)


def test_spec_contiguous_server_matches_jax(ref):
    """The verify window routes each slot's 4 tokens as one group."""
    rows, summ = port_serve(ref["model"], PROMPTS, spec=3, num_slots=3)
    assert rows == ref["spec"]
    assert summ["counters"]["attention/flash_decode_ragged_verify"] > 0
    assert summ["spec_drafted"] > 0


def test_generate_matches_jax_generate(ref):
    """The left-padded batch's pad rows attend as the JAX package's
    cached prefill lets them, and then take capacity before the real
    tokens of their row."""
    ids, mask = gen.left_pad_batch(PROMPTS, PAD)
    with port_counters() as reg:
        out = generate(ref["model"], ids, mask, GenerationConfig(
            max_dec_len=8, decode_strategy="greedy_search",
            eos_token_id=PAD, pad_token_id=PAD))
        cfg = ref["model"].config
        assert reg.counter("moe/sort_pallas") == 8 * cfg.num_layers
    assert [truncate(r) for r in out.tolist()] == ref["generate"]


@pytest.mark.parametrize("num_slots,order", [
    (1, list(range(8))),            # one request at a time
    (3, [2, 0, 7, 4, 1, 6, 5, 3]),  # shuffled admission
    (4, list(range(7, -1, -1))),    # reversed admission
    (8, list(range(8))),            # every request admitted at once
])
def test_slot_count_and_admission_order_invariance(ref, num_slots, order):
    srv = GenerationServer(ref["model"], GenerationConfig(
        max_dec_len=8, decode_strategy="greedy_search", eos_token_id=PAD,
        pad_token_id=PAD), num_slots=num_slots)
    comps = srv.run([PROMPTS[i] for i in order])
    got = {i: c.tokens for i, c in zip(order, comps)}
    assert [got[i] for i in range(len(PROMPTS))] == ref["contiguous"]


def test_lora_beside_moe_stays_refused():
    """The JAX config refuses LoRA on an MoE model (the experts replace
    the fc1 / fc2 sites the adapters ride on); so does the port's."""
    with pytest.raises(ValueError, match="incompatible"):
        GPTConfig(moe_num_experts=8, lora_rank=4, lora_num_adapters=2)


def test_router_loss_only_when_asked():
    """The router loss is computed where a forward asks for it
    (``return_aux``), under inference mode too, and skipping it leaves
    the hidden states bit for bit as they were."""
    torch.manual_seed(SEED)
    model = build_model(GPTConfig(**MOE_KW), torch.device("cpu"))
    ids = torch.as_tensor([PROMPTS[0], PROMPTS[0][::-1]])
    with torch.no_grad():
        want, want_aux = model.gpt(ids, return_aux=True)
    with torch.inference_mode():
        got, aux = model.gpt(ids, return_aux=True)
        bare = model.gpt(ids)
    assert float(want_aux) > 0 and torch.equal(aux, want_aux)
    assert torch.equal(got, want) and torch.equal(bare, want)
