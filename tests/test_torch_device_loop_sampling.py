"""Seeded sampling under the device-resident loop: the draw computed on
the device equals a host reference of the same Philox4x32-10 function
bit for bit (seeds and streams near 2^63 included), and the port's
server at T > 1 gives its T = 1 rows, paged and contiguous, with
speculation on a draft source that does not depend on when it is asked
(as the JAX package pins it), while slot count and admission order stay
invisible."""

import numpy as np
import pytest
import torch

from _serving_paged_ref import _long_prompts, _serve
from _torch_parity import build_pair
from paddlefleetx_tpu_torch.core.serving import GenerationServer
from paddlefleetx_tpu_torch.models.gpt import generation as gen

EOS = PAD = 95
PROMPTS = [[5, 9, 2, 7, 1], [11, 3], [4, 4, 8, 1, 2, 6, 9],
           [13, 2, 2], [1], [7, 8]]
PAGED = dict(page_size=128, prefill_chunk_pages=1)
M32 = 0xFFFFFFFF


def philox_ref(ctr, key):
    """Philox4x32-10 on Python ints (Random123's constants)."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for i in range(10):
        if i:
            k0 = (k0 + 0x9E3779B9) & M32
            k1 = (k1 + 0xBB67AE85) & M32
        p0, p1 = 0xD2511F53 * c0, 0xCD9E8D57 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & M32,
                          (p0 >> 32) ^ c3 ^ k1, p0 & M32)
    return c0, c1, c2, c3


def uniform_ref(seed, stream, step, salt=0):
    """The host reference of ``gen.stream_uniform``."""
    w0 = philox_ref((stream & M32, (stream >> 32) & M32, step & M32,
                     salt & M32), (seed & M32, (seed >> 32) & M32))[0]
    return (w0 >> 8) / float(1 << 24)


@pytest.mark.parametrize("seed", [0, 11, 2 ** 63 - 1, 2 ** 63 - 2 ** 31])
def test_device_draw_equals_host_philox(seed):
    streams = [0, 1, 7, 2 ** 32 + 5, 2 ** 62 + 3, 2 ** 63 - 1]
    steps = [0, 1, 5, 127, 2 ** 31 + 1]
    s, t = (torch.tensor(x, dtype=torch.int64) for x in zip(
        *[(a, b) for a in streams for b in steps]))
    for salt in (0, gen.SPEC_ACCEPT_SALT):
        got = gen.stream_uniform(seed, s, t, salt).tolist()
        want = [uniform_ref(seed, a, b, salt) for a, b in zip(s.tolist(),
                                                               t.tolist())]
        assert got == want


def test_inverse_cdf_draw():
    """The draw is the token whose CDF interval holds the uniform, never
    a filtered (zero-mass) token, even at the interval ends."""
    probs = torch.tensor([[0.0, 0.25, 0.0, 0.75, 0.0]] * 5)
    u = torch.tensor([0.0, 0.2499, 0.25, 0.9999, 1.0 - 2 ** -24])
    assert gen._inverse_cdf(probs, u).tolist() == [1, 1, 3, 3, 3]


@pytest.fixture(scope="module")
def model():
    return build_pair(seed=7, max_position_embeddings=256)[2]


def _sampling(spec=0, **kw):
    extra = {"spec_method": "ngram", "spec_tokens": spec} if spec else {}
    return gen.GenerationConfig(**dict(dict(
        max_dec_len=8, decode_strategy="sampling", top_k=8, top_p=0.9,
        temperature=0.7, eos_token_id=EOS, pad_token_id=PAD), **kw), **extra)


class ConstDraft:
    """Drafts one fixed token whatever the history: ``propose(h, k T)``
    is T copies of ``propose(h, k)``, so every T drafts the same."""

    def propose(self, history, k):
        return [17] * k


def _run(model, cfg, T, num_slots=2, order=None, draft=None, **kw):
    srv = GenerationServer(model, cfg, num_slots=num_slots, seed=5,
                           device_loop_ticks=T, **kw)
    if draft is not None:
        srv._draft = draft
    order = order or list(range(len(PROMPTS)))
    ids = {i: srv.submit(PROMPTS[i], nonce=i) for i in order}
    done = {}
    while srv.pending or srv.occupancy:
        for c in srv.step():
            done[c.request_id] = c.tokens
    if srv.paged:
        srv.check_alloc()
    return [done[ids[i]] for i in range(len(PROMPTS))], srv.summary()


@pytest.mark.parametrize("paged", [False, True])
def test_sampling_rows_equal_across_loop_ticks(model, paged):
    """T = 4 and 16 draw the T = 1 rows; so do 1 and 3 slots with a
    shuffled admission order at T = 4."""
    kw = PAGED if paged else {}
    ref, ref_summ = _run(model, _sampling(), 1, **kw)
    for T in (4, 16):
        rows, summ = _run(model, _sampling(), T, **kw)
        assert rows == ref
        assert summ["host_roundtrips"] < ref_summ["host_roundtrips"]
    for slots, order in ((1, None), (3, [4, 1, 0, 5, 3, 2])):
        assert _run(model, _sampling(), 4, num_slots=slots, order=order,
                    **kw)[0] == ref
    assert any(len(set(r)) > 1 for r in ref)


@pytest.mark.parametrize("paged", [False, True])
def test_spec_sampling_const_draft_equal_across_loop_ticks(model, paged):
    """Sampling with speculation over a history-free draft source: the
    accept uniforms and residual draws line up tick for tick, so T = 4
    replays T = 1 exactly, rejections included."""
    kw = PAGED if paged else {}
    ref, ref_summ = _run(model, _sampling(spec=3), 1, draft=ConstDraft(),
                         **kw)
    rows, summ = _run(model, _sampling(spec=3), 4, draft=ConstDraft(), **kw)
    assert rows == ref
    assert summ["spec_drafted"] > 0
    assert summ["spec_accepted"] == ref_summ["spec_accepted"]


def test_sampling_preemption_equal_across_loop_ticks(model):
    """A preempting 5-page pool resumes each sampling stream where it
    stopped at any T."""
    cfg = _sampling(max_dec_len=16)
    runs = []
    for T in (1, 4):
        srv = GenerationServer(model, cfg, num_slots=3, pool_pages=5,
                               seed=5, device_loop_ticks=T, **PAGED)
        runs.append(_serve(srv, *_long_prompts()))
        srv.check_alloc()
    assert runs[0] == runs[1]
    assert np.mean([len(r) for r in runs[0]]) > 1
