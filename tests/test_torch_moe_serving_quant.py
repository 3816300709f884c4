"""MoE serving with both int8 knobs (``kv_cache_dtype: int8`` and
``quant_execution: weight_only_int8``): the port's greedy rows of the
tiny 8-expert model equal the JAX server's, token for token, through
the contiguous server and the paged speculative one. Kernel 7 runs at
the two attention sites of every forward (the experts stay in the
compute dtype, as in the JAX package) and each tick on the int8
instance of its decode kernel."""

import pytest

from _moe_serving_ref import (
    PAGED, interpret, jax_serve, moe_pair, port_serve, prompts,
)

PROMPTS = prompts()


@pytest.fixture(scope="module")
def quant():
    """The port model with both int8 knobs and the JAX rows of the
    seeded prompts through the contiguous server and the paged
    speculative one."""
    with interpret():
        pair = moe_pair(quant=True, kv_cache_dtype="int8")
        contiguous, _ = jax_serve(pair, PROMPTS, num_slots=2)
        spec, _ = jax_serve(pair, PROMPTS, spec=3, num_slots=2, **PAGED)
    return {"model": pair[2], "contiguous": contiguous, "spec": spec}


def test_int8_quant_contiguous_server_matches_jax(quant):
    """Kernel 7 at the two attention sites of every forward, the int8
    instance of kernel 2 every tick."""
    rows, summ = port_serve(quant["model"], PROMPTS, num_slots=2)
    assert rows == quant["contiguous"]
    c = summ["counters"]
    layers = quant["model"].config.num_layers
    assert c["attention/flash_decode_ragged_int8"] == \
        summ["decode_ticks"] * layers
    assert c["quant/matmul"] == \
        2 * layers * (summ["decode_ticks"] + summ["admitted"])


def test_int8_quant_spec_paged_server_matches_jax(quant):
    rows, summ = port_serve(quant["model"], PROMPTS, spec=3, num_slots=2,
                            **PAGED)
    assert rows == quant["spec"]
    assert summ["counters"]["attention/flash_decode_paged_verify_int8"] \
        == summ["decode_ticks"] * quant["model"].config.num_layers
