"""The port's multi-tenant LoRA ``GenerationServer`` (ports of
``tests/test_lora.py``'s serving tests): adapter id 0 is token-exact with
the base model over greedy / sampled x paged / contiguous x speculation
on / off, an unknown adapter fails only its own request, and the router
hooks ``has_adapters`` / ``adapter_affinity``. Mixed adapters against
the JAX server, eviction and prefix isolation are in
``test_torch_serving_lora_adapters.py``."""

import dataclasses

import numpy as np
import pytest

from _torch_parity import CPU, rng, tiny_kwargs
from paddlefleetx_tpu_torch.core.adapters import extract_adapter
from paddlefleetx_tpu_torch.core.serving import GenerationServer
from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
from paddlefleetx_tpu_torch.models.gpt.generation import GenerationConfig
from paddlefleetx_tpu_torch.models.gpt.model import build_model

EOS = PAD = 95
PROMPTS = [[5, 9, 2, 7, 1], [11, 3], [4, 4, 8, 1, 2, 6, 9], [13, 2, 2]]
LORA = dict(lora_rank=4, lora_num_adapters=4)


def _models(**over):
    """``(lora_model, base_model)``: the same seeded base weights, the
    LoRA twin with its banks (``lora_b`` zero until an adapter lands)."""
    cfg = GPTConfig(**tiny_kwargs(**{**LORA, **over}))
    lora = build_model(cfg, CPU, seed=0)
    base_cfg = dataclasses.replace(cfg, lora_rank=0, lora_num_adapters=0)
    base = build_model(base_cfg, CPU, state_dict={
        k: v for k, v in lora.state_dict().items() if "_lora." not in k})
    return lora, base


def _source(model, known=frozenset(range(1, 64))):
    """Seeded adapter id -> canonical tree shaped like ``model``'s
    banks (large enough to move greedy argmaxes); unknown ids raise
    ``KeyError`` as a real store does."""
    shapes = {k: tuple(v.shape) for k, v in extract_adapter(model, 0).items()}

    def source(aid):
        if aid not in known:
            raise KeyError(aid)
        g = rng(1000 + int(aid))
        return {k: g.normal(0.0, 0.2, s).astype(np.float32)
                for k, s in shapes.items()}
    return source


def _gen_cfg(sampling=False, spec=False, max_dec=6, cls=GenerationConfig):
    kw = dict(max_dec_len=max_dec, eos_token_id=EOS, pad_token_id=PAD)
    if sampling:
        kw.update(decode_strategy="sampling", top_k=8, top_p=0.9,
                  temperature=0.7)
    else:
        kw.update(decode_strategy="greedy_search")
    if spec:
        kw.update(spec_method="ngram", spec_tokens=3)
    return cls(**kw)


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.mark.parametrize("spec", [False, True])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("sampling", [False, True])
def test_adapter_id0_parity_matrix(models, sampling, paged, spec):
    """Adapter id 0 is structural: a LoRA server serving id 0 is
    token-exact with the base model whatever the strategy, KV layout or
    speculation, and it loads no adapter."""
    lora, base = models
    kw = dict(num_slots=2, seed=5)
    if paged:
        kw.update(page_size=128, prefill_chunk_pages=1)
    cfg = _gen_cfg(sampling, spec)
    ref = [c.tokens for c in GenerationServer(base, cfg, **kw).run(PROMPTS)]
    srv = GenerationServer(lora, cfg, adapter_source=_source(lora), **kw)
    comps = srv.run(PROMPTS, adapter_ids=[0] * len(PROMPTS))
    assert [c.tokens for c in comps] == ref
    assert all(c.finish_reason in ("eos", "length") for c in comps)
    assert srv.summary()["adapters_resident"] == 0


def test_unknown_adapter_fails_only_its_request(models):
    """An unknown id completes as ``adapter_missing`` with no eviction
    and the rest are served; bad ids are refused at submit."""
    lora, base = models
    srv = GenerationServer(lora, _gen_cfg(), num_slots=2,
                           adapter_source=_source(lora))
    comps = srv.run([PROMPTS[0], PROMPTS[1], PROMPTS[2]],
                    adapter_ids=[1, 99, 0])
    assert [c.finish_reason for c in comps][1] == "adapter_missing"
    assert comps[1].tokens == []
    assert {comps[0].finish_reason, comps[2].finish_reason} <= \
        {"eos", "length"}
    srv._adapters.check()
    assert srv.summary()["adapter_evictions"] == 0
    with pytest.raises(ValueError, match="adapter_id"):
        srv.submit(PROMPTS[0], adapter_id=-1)
    with pytest.raises(ValueError, match="adapter_source"):
        GenerationServer(lora, _gen_cfg()).submit(PROMPTS[0], adapter_id=1)
    with pytest.raises(ValueError, match="lora_rank"):
        GenerationServer(base, _gen_cfg(), adapter_source=_source(lora))


def test_router_hooks_and_row_uploads(models):
    """``has_adapters`` and ``adapter_affinity`` score residency; the
    ticks' bank-row tensor is uploaded again only when a row changed."""
    lora, base = models
    assert not GenerationServer(base, _gen_cfg()).has_adapters
    srv = GenerationServer(lora, _gen_cfg(max_dec=6), num_slots=2,
                           adapter_source=_source(lora))
    assert srv.has_adapters
    assert srv.adapter_affinity(2) == 0 and srv.adapter_affinity(0) == 0
    srv.submit(PROMPTS[0], adapter_id=2)
    srv.step()
    first = srv._aid_dev
    assert first.tolist() == [1, 0]
    srv.step()
    assert srv._aid_dev is first
    while srv.pending or srv.occupancy:
        srv.step()
    assert srv.adapter_affinity(2) == 1 and srv.adapter_affinity(3) == 0
    assert srv._aid_np.tolist() == [0, 0]
    assert GenerationServer(base, _gen_cfg()).adapter_affinity(2) == 0
