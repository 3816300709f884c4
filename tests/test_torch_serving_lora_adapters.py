"""The port's multi-tenant LoRA ``GenerationServer`` with mixed
adapters (ports of ``tests/test_lora.py``'s serving tests): three
adapters in one tick equal the JAX server token for token (fp32,
greedy; the JAX server takes its default CPU route), an overfull bank
evicts and requeues without changing a token, and adapter requests
never share prefix KV. Adapter id 0 against the base model, unknown
adapters and the router hooks are in ``test_torch_serving_lora.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import CPU, rng, tiny_kwargs
from paddlefleetx_tpu.core.serving import GenerationServer as JaxServer
from paddlefleetx_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddlefleetx_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddlefleetx_tpu.models.gpt import generation as jax_gen
from paddlefleetx_tpu_torch.core.adapters import extract_adapter
from paddlefleetx_tpu_torch.core.paging import prompt_key
from paddlefleetx_tpu_torch.core.serving import GenerationServer
from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
from paddlefleetx_tpu_torch.models.gpt.convert import (
    flax_from_torch_state_dict,
)
from paddlefleetx_tpu_torch.models.gpt.generation import GenerationConfig
from paddlefleetx_tpu_torch.models.gpt.model import build_model
from paddlefleetx_tpu_torch.observability import metrics

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


@pytest.fixture()
def counters():
    """The registry on and zeroed for the test, then off again."""
    metrics.set_enabled(True)
    reg = metrics.get_registry()
    reg.reset()
    yield reg
    reg.reset()
    metrics.set_enabled(False)


def test_three_adapters_one_tick_equal_jax(counters):
    """One decode tick serves three distinct adapters and the base
    model through the grouped delta, token for token as the JAX server
    on the same weights and adapters; the tokens differ from the base
    model's and repeat on a second run."""
    lora, _ = _models()
    source = _source(lora)
    ids = [1, 2, 3, 0]
    srv = GenerationServer(lora, _gen_cfg(max_dec=5), num_slots=4,
                           adapter_source=source)
    done = {}
    rids = [srv.submit(p, adapter_id=a) for p, a in zip(PROMPTS, ids)]
    max_distinct = 0
    while srv.pending or srv.occupancy:
        for c in srv.step():
            done[c.request_id] = c
        max_distinct = max(max_distinct,
                           len({int(r) for r in srv._aid_np if int(r)}))
    ours = [done[i].tokens for i in rids]
    assert max_distinct >= 3
    assert counters.counter("lora/grouped") > 0
    assert counters.counter("lora/fallback") == 0
    assert counters.counter("serving/adapter_misses") == 3
    assert srv.summary()["adapters_resident"] == 3
    srv._adapters.check()
    kw = tiny_kwargs(**LORA)
    jsrv = JaxServer(JaxGPT(JaxGPTConfig(**kw)),
                     jax.tree.map(jnp.asarray, flax_from_torch_state_dict(
                         lora.state_dict(), lora.config)),
                     _gen_cfg(max_dec=5, cls=jax_gen.GenerationConfig),
                     num_slots=4, adapter_source=source)
    theirs = [c.tokens for c in jsrv.run(PROMPTS, adapter_ids=ids)]
    assert ours == theirs
    again = [c.tokens for c in srv.run(PROMPTS, adapter_ids=ids)]
    assert again == ours
    base = [c.tokens for c in srv.run(PROMPTS)]
    assert base[3] == ours[3] and base[:3] != ours[:3]


@pytest.mark.parametrize("paged", [False, True])
def test_eviction_under_pressure_requeues(paged, counters):
    """More live adapters than bank rows: the overflow request waits at
    the queue head, admits after a release by evicting the least
    recently released adapter, and every request's tokens equal a run
    whose bank holds them all."""
    lora, base = _models(lora_num_adapters=3)        # 2 usable rows
    roomy = build_model(dataclasses.replace(lora.config,
                                            lora_num_adapters=5), CPU)
    roomy.load_state_dict(base.state_dict(), strict=False)
    kw = dict(num_slots=2)
    if paged:
        kw.update(page_size=128, prefill_chunk_pages=1)
    prompts, ids = PROMPTS[:3] + [PROMPTS[0]], [1, 2, 3, 1]
    srv = GenerationServer(lora, _gen_cfg(), adapter_source=_source(lora),
                           **kw)
    comps = srv.run(prompts, adapter_ids=ids)
    assert all(c.finish_reason in ("eos", "length") for c in comps)
    summ = srv.summary()
    assert summ["adapter_evictions"] >= 1 == summ["adapter_rows"] - 1
    assert counters.counter("serving/adapter_evictions") == \
        summ["adapter_evictions"]
    srv._adapters.check()
    ref = GenerationServer(roomy, _gen_cfg(), adapter_source=_source(roomy),
                           **kw).run(prompts, adapter_ids=ids)
    assert [c.tokens for c in comps] == [c.tokens for c in ref]


def test_adapter_requests_never_share_prefix_kv(counters):
    """Adapter requests neither hit nor seed the prefix and prompt
    registries (their KV is tinted); identical base prompts still
    share."""
    lora, _ = _models(max_position_embeddings=512)
    prompt = rng(3).integers(0, EOS, 200).tolist()   # past one page
    srv = GenerationServer(lora, _gen_cfg(max_dec=4), num_slots=2,
                           adapter_source=_source(lora), page_size=128,
                           prefill_chunk_pages=1)

    def staggered_pair(aid):
        done = {}
        ids = [srv.submit(prompt, adapter_id=aid)]
        for _ in range(3):          # 2 prefill chunks + 1 decode tick
            for c in srv.step():
                done[c.request_id] = c
        registered = srv._alloc.lookup_prompt(prompt_key(prompt)) \
            is not None
        ids.append(srv.submit(prompt, adapter_id=aid))
        while srv.pending or srv.occupancy:
            for c in srv.step():
                done[c.request_id] = c
        return [done[i].tokens for i in ids], registered

    tinted, tinted_reg = staggered_pair(1)
    assert not tinted_reg
    assert counters.counter("serving/prefix_hits") == 0
    plain, plain_reg = staggered_pair(0)
    assert plain_reg and counters.counter("serving/prefix_hits") > 0
    assert tinted[0] == tinted[1] and plain[0] == plain[1]
    assert tinted[0] != plain[0]
    srv.check_alloc()
