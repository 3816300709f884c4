"""MoE serving through the paged pool: the port's greedy rows of the tiny
8-expert model equal the JAX paged server's, token for token, with
prefill chunks of one 128-token page (each chunk one routing group,
capacity 40), plain and speculative; under a 5-page pool (4 usable)
where long prompts share a page-sized prefix, requests are preempted
and resume (their re-prefill a new routing group, as in the JAX
package), and every count is the JAX server's. The reference's outputs
depend on the mode: on the seeded prompts the JAX contiguous server
(capacity from the prompt's bucket) and the JAX paged server (from the
chunk) give different rows, and the port reproduces both."""

import pytest

from _moe_serving_ref import (
    PAGED, interpret, jax_serve, long_prompts, moe_pair, port_serve,
    prompts,
)

PROMPTS = prompts()
LONG_DEC = 16


@pytest.fixture(scope="module")
def ref():
    """The port model and the JAX rows of the seeded prompts through the
    paged server (plain, speculative) and the contiguous one, and of the
    long prompts through the preempting 5-page pool."""
    with interpret():
        pair = moe_pair()
        paged, _ = jax_serve(pair, PROMPTS, num_slots=2, **PAGED)
        spec, _ = jax_serve(pair, PROMPTS, spec=3, num_slots=2, **PAGED)
        contiguous, _ = jax_serve(pair, PROMPTS, num_slots=2)
        long_, long_summary = jax_serve(pair, tuple(long_prompts()),
                                        max_dec_len=LONG_DEC, num_slots=3,
                                        pool_pages=5, **PAGED)
    return {"model": pair[2], "paged": paged, "spec": spec,
            "contiguous": contiguous, "long": long_,
            "long_summary": long_summary}


def test_paged_server_matches_jax(ref):
    rows, summ = port_serve(ref["model"], PROMPTS, num_slots=2, **PAGED)
    assert rows == ref["paged"]
    layers = ref["model"].config.num_layers
    assert summ["counters"]["attention/flash_decode_paged"] == \
        summ["decode_ticks"] * layers


def test_spec_paged_server_matches_jax(ref):
    rows, summ = port_serve(ref["model"], PROMPTS, spec=3, num_slots=2,
                            **PAGED)
    assert rows == ref["spec"]
    assert summ["counters"]["attention/flash_decode_paged_verify"] > 0


def test_mode_dependence_is_the_reference_s(ref):
    """The JAX contiguous and paged servers route the shorter prompts at
    different capacities and differ on some rows; the port gives each
    mode's rows."""
    assert ref["contiguous"] != ref["paged"]
    contiguous, _ = port_serve(ref["model"], PROMPTS, num_slots=2)
    paged, _ = port_serve(ref["model"], PROMPTS, num_slots=2, **PAGED)
    assert contiguous == ref["contiguous"]
    assert paged == ref["paged"]


def test_preemption_and_prefix_sharing_match_jax(ref):
    """Preempted requests resume through a fresh chunked prefill, shared
    prefix pages carry the first prefill's KV, a repeated prompt admits
    through the prompt registry and splits copy-on-write; rows and
    counts are the JAX server's."""
    rows, summ = port_serve(ref["model"], tuple(long_prompts()),
                            max_dec_len=LONG_DEC, num_slots=3,
                            pool_pages=5, **PAGED)
    assert rows == ref["long"]
    assert summ["preempted"] > 0 and summ["prefix_hits"] > 0
    assert summ["cow_splits"] > 0
    for key in ("preempted", "prefill_chunks", "prefix_hits",
                "prompt_hits", "cow_splits", "admitted", "evicted",
                "decode_ticks", "decode_tokens"):
        assert summ[key] == ref["long_summary"][key], key
