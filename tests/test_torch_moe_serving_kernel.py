"""Kernel 8 (the grouped GEMM) at the MoE serving path's shapes: the
8x345M model's expert GEMMs (``w [8, 1024, 4096]`` for fc1, ``[8, 4096,
1024]`` for fc2) over the grouped buffer ``[E * rows, C, K]`` that each
forward of the server routes, one group an (expert, batch row):

- decode: 16 slots, one token a row, C 1 (G 128, 32 groups live);
- the speculative verify window of 5 tokens: C 2;
- a paged prefill chunk of 256 tokens: one row, C 80;
- the contiguous admission of one prompt, right-padded to its bucket:
  C = ceil(0.3125 * bucket), 5 to 160 for the buckets 16 to 512.

The route planner (pure Python) at each shape, kernel 8's plain version
against ``torch.einsum`` at those groups and capacities (narrow K and N:
the plain version materializes each expert's weight once a group), and
on the card the planned route against the plain version, bit-equal when
launched again, with exact zeros in the groups no token was routed to.
This file imports no JAX, so the card's test runs where JAX is absent::

    python -m pytest --noconftest -q -m cuda tests/test_torch_moe_serving_kernel.py
"""

import math

import numpy as np
import pytest
import torch

from paddlefleetx_tpu_torch.ops.cuda import grouped_matmul as gmm

BF = torch.bfloat16
#: the 8x345M model's experts, top-k and capacity factor
EXPERTS, TOP_K, FACTOR = 8, 2, 1.25
#: fc1 and fc2 as (K, N)
SITES = {"fc1": (1024, 4096), "fc2": (4096, 1024)}


def capacity(s: int) -> int:
    """The routing group's capacity at sequence length ``s`` (``moe.
    expert_capacity`` of the 8x345M model)."""
    return max(1, math.ceil(TOP_K * s * FACTOR / EXPERTS))


#: (name, batch rows, tokens a row): the serving forwards
FORWARDS = (("decode", 16, 1), ("verify", 16, 5), ("chunk", 1, 256),
            *((f"bucket{b}", 1, b) for b in (16, 32, 64, 128, 256, 512)))

#: the planned (route, tile, splits) of each forward's fc1 and fc2
PLANNED = {
    "decode": (("split", (16, 64), 1), ("split", (16, 64), 1)),
    "verify": (("split", (16, 64), 1), ("split", (16, 64), 1)),
    "chunk": (("wgmma", (128, 128), 1), ("wgmma", (128, 128), 1)),
    "bucket16": (("split", (16, 64), 1), ("split", (16, 64), 4)),
    "bucket32": (("split", (16, 64), 1), ("split", (16, 64), 4)),
    "bucket64": (("mma", (64, 128), 1), ("mma", (64, 128), 1)),
    "bucket128": (("mma", (64, 128), 1), ("mma", (64, 128), 1)),
    "bucket256": (("wgmma", (128, 128), 1), ("wgmma", (128, 128), 1)),
    "bucket512": (("wgmma", (128, 128), 1), ("wgmma", (128, 128), 1)),
}


def routed_counts(rows: int, s: int, seed: int) -> torch.Tensor:
    """int32 ``counts [E * rows]`` in the (expert, row) order of
    ``MoEMLP._expert_ffn``: each of a row's ``s`` tokens picks ``TOP_K``
    distinct experts from a seeded skewed distribution, each (expert,
    row) keeps at most the capacity of ``s`` tokens."""
    r = np.random.default_rng(seed)
    pref = r.dirichlet(np.ones(EXPERTS))
    counts = np.zeros((rows, EXPERTS), np.int64)
    for row in range(rows):
        for _ in range(s):
            counts[row, r.choice(EXPERTS, TOP_K, replace=False, p=pref)] += 1
    counts = np.minimum(counts, capacity(s))
    return torch.as_tensor(counts.T.reshape(-1), dtype=torch.int32)


def operands(name, rows, s, site, k, n, dtype, seed, device="cpu"):
    """``(x [E * rows, C, K], w [E, K, N], counts)`` of one forward's
    expert GEMM: x zero past each group's count at fc1 (the dispatch's
    empty slots) and non-zero there at fc2 (``gelu(b1)``)."""
    c = capacity(s)
    counts = routed_counts(rows, s, seed).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((EXPERTS * rows, c, k), generator=gen, device=device)
    live = torch.arange(c, device=device)[None, :, None] < \
        counts[:, None, None].long()
    pad = torch.randn((1, 1, k), generator=gen, device=device) \
        if site == "fc2" else torch.zeros((), device=device)
    x = torch.where(live, x, pad).to(dtype)
    w = (torch.randn((EXPERTS, k, n), generator=gen, device=device) *
         k ** -0.5).to(dtype)
    return x, w, counts


@pytest.mark.parametrize("name,rows,s", FORWARDS)
def test_plan_at_serving_shapes(name, rows, s):
    """Each serving forward's fc1 and fc2 plan a route whose kernel
    takes the shape: ``split`` for the decode tick and the verify
    window (at most 16 rows a group), ``wgmma`` for the paged chunk
    and the longer buckets, ``mma`` between."""
    c = capacity(s)
    for site, want in zip(("fc1", "fc2"), PLANNED[name]):
        k, n = SITES[site]
        assert tuple(gmm.plan("fwd", EXPERTS * rows, c, k, n, BF)) == want
        x = torch.zeros((EXPERTS * rows, c, k), dtype=BF)
        w = torch.zeros((EXPERTS, k, n), dtype=BF)
        assert tuple(gmm.plan_call(x, w)) == want


def test_serving_capacities():
    """The capacities the serving forwards route with: the decode tick
    1, the verify window of 5 tokens 2, the 256-token paged chunk 80,
    and ceil(0.3125 bucket) for a contiguous admission."""
    assert [capacity(s) for _, _, s in FORWARDS] == \
        [1, 2, 80, 5, 10, 20, 40, 80, 160]


@pytest.mark.parametrize("name,rows,s", FORWARDS)
def test_plain_matches_einsum_at_serving_groups(name, rows, s):
    """Kernel 8's plain version (fp32, narrow K / N) against
    ``torch.einsum`` over the experts' weights at each forward's groups
    and capacity, the empty groups exact zeros; 1e-5 relative, the same
    products summed in another order."""
    for site, (k, n) in (("fc1", (64, 128)), ("fc2", (128, 64))):
        x, w, counts = operands(name, rows, s, site, k, n, torch.float32,
                                seed=len(name) + k)
        got = gmm.grouped_matmul(x, w, counts)
        want = torch.einsum("erck,ekn->ercn",
                            x.view(EXPERTS, rows, -1, k), w)
        want = want.reshape(got.shape) * (counts > 0)[:, None, None]
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert (got[counts == 0] == 0).all()


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch kernel 8")
    return torch.device("cuda")


@pytest.mark.cuda
def test_serving_routes_on_the_card(card):
    """At every serving forward's fc1 and fc2 at full width (bf16), the
    planned route launches once a call (counted under that route), gives
    the same bits when launched again, zeros exactly in the empty
    groups, and agrees with the plain version run in fp32 to 2e-2 of
    the output's scale."""
    for name, rows, s in FORWARDS:
        for i, site in enumerate(("fc1", "fc2")):
            k, n = SITES[site]
            x, w, counts = operands(name, rows, s, site, k, n, BF,
                                    seed=7 + i, device=card)
            route = PLANNED[name][i][0]
            before = dict(gmm.grouped_matmul.launches_by_route)
            with torch.inference_mode():
                got = gmm.grouped_matmul(x, w, counts)
                again = gmm.grouped_matmul(x, w, counts)
            torch.cuda.synchronize()
            assert gmm.grouped_matmul.launches_by_route[route] == \
                before[route] + 2, (name, site)
            assert torch.equal(got, again), (name, site)
            assert (got[counts == 0] == 0).all(), (name, site)
            ref = gmm.grouped_matmul_reference(x.float(), w.float(), counts)
            scale = float(ref.abs().max().clamp_min(1.0))
            err = float((got.float() - ref).abs().max())
            assert err <= 2e-2 * scale, (name, site, err)
