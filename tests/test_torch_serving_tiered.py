"""The port's host KV tier (``GenerationServer(host_pool_bytes=...)``)
against its untiered twin and the JAX package's tiered server, on the
same converted weights, in fp32 (the counterparts of JAX
``tests/test_serving.py``'s tiered tests).

- The parity matrix: greedy and sampling, bf16 and int8 KV, spec on and
  off, at T = 1 and one case at T = 4, on a multi-turn trace whose KV
  exceeds a 5-page pool: the tiered rows equal the untiered rows on an
  unlimited pool, with spills, rehydrates and fewer prefill chunks; the
  greedy rows equal the JAX tiered server's.
- The batched-launch pin: a spill packs all its pages in one
  ``pack_kv_pages`` and a rehydrate writes all its pages in one
  ``unpack_kv_pages``, whose operator counts do not grow with the page
  count.
- A stale generation is never rehydrated; a writer failure re-prefills
  cold with no hang and no wrong token; a copy-on-write split of a
  rehydrated page lands on the card; the refusals.

The JAX servers take their default CPU route; the port's wrappers run
their plain versions on CPU tensors."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_parity import build_pair
from paddlefleetx_tpu.core.serving import GenerationServer as JaxServer
from paddlefleetx_tpu.models.gpt import generation as jax_gen
from paddlefleetx_tpu_torch.core import serving as serving_mod
from paddlefleetx_tpu_torch.core.serving import GenerationServer
from paddlefleetx_tpu_torch.models.gpt import generation as gen
from paddlefleetx_tpu_torch.observability import metrics

EOS = PAD = 95
TIERED = dict(pool_pages=5, host_pool_bytes=1 << 20)
UNTIERED = dict(pool_pages=64)


def conv_trace(seed=11, users=3, turns=2, sys_len=130):
    """Seeded multi-turn conversations (JAX ``tests/test_serving.py``'s
    ``_conv_trace``): one shared system prompt, each turn resubmitting
    a user's grown history, so every turn's KV is a chain prefix of the
    next."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, EOS, sys_len).tolist()
    hist = [list(system) for _ in range(users)]
    waves = []
    for _ in range(turns):
        wave = []
        for u in range(users):
            hist[u] = hist[u] + rng.integers(0, EOS, 12 + 7 * u).tolist()
            wave.append(list(hist[u]))
        waves.append(wave)
    return waves


def gen_cfg(cls, strategy="greedy", spec=0):
    kw = dict(max_dec_len=4, eos_token_id=EOS, pad_token_id=PAD)
    if strategy == "greedy":
        cfg = cls(decode_strategy="greedy_search", **kw)
    else:
        cfg = cls(decode_strategy="sampling", top_k=8, top_p=0.9,
                  temperature=0.7, **kw)
    if spec:
        cfg = dataclasses.replace(cfg, spec_method="ngram",
                                  spec_tokens=spec)
    return cfg


def serve(model, cfg, waves, loop_ticks=1, **kw):
    """Run the waves one at a time (between waves every conversation's
    refcounts reach zero: the spill window); ``(rows, summary)``."""
    srv = GenerationServer(model, cfg, num_slots=2, seed=5, page_size=128,
                           prefill_chunk_pages=1,
                           device_loop_ticks=loop_ticks, **kw)
    try:
        out = [[c.tokens for c in srv.run(w)] for w in waves]
        summ = srv.summary()
        srv.check_alloc()
        assert summ["pages_in_use"] == 0 or summ.get("tiered")
    finally:
        srv.close()
    return out, summ


@pytest.fixture(scope="module")
def ref():
    """The port models (bf16 and int8 KV, one set of weights) and the
    JAX tiered server's greedy rows on each."""
    out = {}
    for kv in ("bf16", "int8"):
        jmodel, params, model = build_pair(seed=7,
                                           max_position_embeddings=512,
                                           kv_cache_dtype=kv)
        srv = JaxServer(jmodel, params, gen_cfg(jax_gen.GenerationConfig),
                        num_slots=2, rng=jax.random.key(5), page_size=128,
                        prefill_chunk_pages=1, **TIERED)
        rows = [[c.tokens for c in srv.run(w)] for w in conv_trace()]
        summ = srv.summary()
        srv.close()
        assert summ["spills"] > 0 and summ["rehydrates"] > 0
        out[kv] = {"model": model, "jax": rows, "jax_summary": summ}
    return out


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("spec", [0, 2])
@pytest.mark.parametrize("strategy", ["greedy", "sampling"])
def test_tiered_parity_matrix(ref, strategy, spec, kv):
    model = ref[kv]["model"]
    cfg = gen_cfg(gen.GenerationConfig, strategy, spec)
    waves = conv_trace()
    tiered, ts = serve(model, cfg, waves, **TIERED)
    untiered, us = serve(model, cfg, waves, **UNTIERED)
    assert tiered == untiered
    assert ts["tiered"] is True and ts["spills"] > 0
    assert ts["rehydrates"] > 0
    assert ts["prefill_chunks"] < us["prefill_chunks"]
    assert ts["rehydrate_p99_ms"] > 0
    # the byte budget in pages of the KV dtype, as the JAX server sizes it
    assert ts["host_pages_cap"] == ref[kv]["jax_summary"]["host_pages_cap"]
    assert ts["host_pages_cap"] == {"bf16": 8, "int8": 15}[kv]
    if strategy == "greedy":
        assert tiered == ref[kv]["jax"]
        js = ref[kv]["jax_summary"]
        if not spec:
            for key in ("spills", "rehydrates", "prefill_chunks",
                        "host_evictions", "prefix_hits", "prompt_hits"):
                assert ts[key] == js[key], key


@pytest.mark.parametrize("strategy", ["greedy", "sampling"])
def test_tiered_device_loop_t4_equals_t1(ref, strategy):
    """T = 4 (pending spills cap a round trip at one tick) commits the
    rows of T = 1, tiered and untiered."""
    model = ref["bf16"]["model"]
    cfg = gen_cfg(gen.GenerationConfig, strategy)
    waves = conv_trace()
    t1, _ = serve(model, cfg, waves, **TIERED)
    t4, s4 = serve(model, cfg, waves, loop_ticks=4, **TIERED)
    assert t4 == t1
    assert s4["spills"] > 0 and s4["rehydrates"] > 0
    assert s4["device_ticks"] >= s4["host_roundtrips"]
    if strategy == "greedy":
        assert t4 == ref["bf16"]["jax"]


class _Ops(TorchDispatchMode):
    """Counts the ATen operators a region dispatches."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_pack_unpack_ops_independent_of_page_count(ref, kv):
    """The port's form of JAX's one-gather / one-scatter pin: packing
    or writing back N pages dispatches the same operators for N = 1 and
    N = 3 (one indexed read or write a pool tensor, one concatenation),
    and the round trip is exact."""
    cfg = dataclasses.replace(ref[kv]["model"].config, kv_page_size=128,
                              kv_pool_pages=6)
    pool = gen.init_page_pool(ref[kv]["model"], cfg)
    g = torch.Generator().manual_seed(0)
    for layer in pool:
        for t in layer:
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=g))
            else:
                t.copy_(torch.randn(t.shape, generator=g))
    counts = {}
    for pids, dst in (([2], [5]), ([1, 3, 4], [5, 0, 2])):
        with _Ops() as ops:
            rows = gen.pack_kv_pages(pool, pids)
        counts.setdefault("pack", set()).add(ops.n)
        assert rows.shape == (len(pids), gen.kv_row_bytes(pool))
        want = [[t[p].clone() for p in pids] for layer in pool
                for t in layer]
        with _Ops() as ops:
            gen.unpack_kv_pages(pool, rows, dst)
        counts.setdefault("unpack", set()).add(ops.n)
        got = [[t[p] for p in dst] for layer in pool for t in layer]
        for w, o in zip(want, got):
            assert all(torch.equal(a, b) for a, b in zip(w, o))
    assert len(counts["pack"]) == 1 and len(counts["unpack"]) == 1
    with pytest.raises(ValueError, match="page rows"):
        gen.unpack_kv_pages(pool, rows[:1], [1, 2])


def test_spill_and_rehydrate_are_batched(ref, monkeypatch):
    """Exact-repeat waves: each admission of wave 2 is a whole-prompt
    registry hit whose spilled pages come back in ONE
    ``unpack_kv_pages``, and each yield's spills leave in ONE
    ``pack_kv_pages``; the page totals reconcile with the counters."""
    packs, unpacks = [], []
    real_pack, real_unpack = serving_mod.pack_kv_pages, \
        serving_mod.unpack_kv_pages

    def pack(pool, pids):
        packs.append(len(pids))
        return real_pack(pool, pids)

    def unpack(pool, rows, pids):
        unpacks.append(len(pids))
        return real_unpack(pool, rows, pids)

    monkeypatch.setattr(serving_mod, "pack_kv_pages", pack)
    monkeypatch.setattr(serving_mod, "unpack_kv_pages", unpack)
    rng = np.random.default_rng(11)
    wave = [rng.integers(0, EOS, n).tolist() for n in (260, 270, 280)]
    _, ts = serve(ref["bf16"]["model"], gen_cfg(gen.GenerationConfig),
                  [wave, [list(p) for p in wave]], pool_pages=7,
                  host_pool_bytes=1 << 20)
    assert ts["spills"] >= 2 and ts["rehydrates"] >= 2
    # a page the tier's LRU evicted again within its own batch is dead
    # and not packed
    assert sum(packs) <= ts["spills"]
    assert sum(unpacks) == ts["rehydrates"]
    assert len(packs) < ts["spills"] and max(packs) >= 2
    assert len(unpacks) < ts["rehydrates"] and max(unpacks) >= 2


def test_spills_drain_only_at_the_yield_point(ref, tmp_path):
    """With the flight recorder on, every ``serving_spill`` shares its
    tick / round-trip stamp with a ``serving_yield``; the counters and
    the rehydrate events agree with the allocator's stats."""
    events = tmp_path / "events.jsonl"
    metrics.set_enabled(True)
    reg = metrics.get_registry()
    reg.reset()
    try:
        srv = GenerationServer(ref["bf16"]["model"],
                               gen_cfg(gen.GenerationConfig), num_slots=2,
                               seed=5, page_size=128, prefill_chunk_pages=1,
                               events_path=str(events), **TIERED)
        try:
            for w in conv_trace(seed=9):
                srv.run(w)
            assert reg.counter("serving/spill") == \
                srv._alloc.stats["spills"] > 0
            assert reg.counter("serving/rehydrate") == \
                srv._alloc.stats["rehydrates"] > 0
            assert reg.gauge("serving/host_pages") == \
                srv._alloc.host_pages_resident
        finally:
            srv.close()
    finally:
        metrics.set_enabled(False)
        reg.reset()
    evs = [json.loads(line) for line in events.read_text().splitlines()]
    assert evs[0]["event"] == "serving_start" and evs[0]["host_pages"] == 8
    spills = [e for e in evs if e["event"] == "serving_spill"]
    yields = {(e["ticks"], e["roundtrips"]) for e in evs
              if e["event"] == "serving_yield"}
    assert spills and all((e["ticks"], e["roundtrips"]) in yields
                          for e in spills)
    assert any(e["event"] == "serving_rehydrate" for e in evs)
    assert any(e.get("rehydrated") for e in evs
               if e["event"] == "serving_admit")


def test_stale_host_generation_never_rehydrated(ref):
    """A recycled host id's earlier residency (a stale publish) is never
    taken for the live one, and an eviction drain of the id's earlier
    residency keeps the live residency's bytes."""
    srv = GenerationServer(ref["bf16"]["model"],
                           gen_cfg(gen.GenerationConfig), num_slots=2,
                           seed=5, page_size=128, prefill_chunk_pages=1,
                           **TIERED)
    try:
        for w in conv_trace(seed=3, users=2, turns=1):
            srv.run(w)
        with srv._surface_lock:
            srv._drain_spills()
        srv._ship_spills()
        srv._await_spill_writer()
        assert srv._alloc.host_pages_resident > 0
        hpid = next(iter(srv._alloc._hosted))
        gen_ = srv._alloc.host_generation(hpid)
        row = srv._host_slab[hpid - srv._host_base].clone()
        dst = torch.empty_like(row)
        assert srv._pop_host_bytes(hpid, gen_, dst)
        assert torch.equal(dst, row)
        # a dead residency's publish: discarded on pop, never returned
        with srv._spill_lock:
            srv._host_data[hpid] = gen_ - 1
        assert not srv._pop_host_bytes(hpid, gen_, dst)
        with srv._spill_lock:
            assert hpid not in srv._host_data
            srv._host_data[hpid] = gen_
        # the live residency survives a drain of the id's EARLIER
        # eviction (the recycled-id case)...
        srv._alloc._host_evicted.append(hpid)
        srv._drop_evicted_host_data()
        with srv._spill_lock:
            assert srv._host_data[hpid] == gen_
            srv._host_data[hpid] = gen_ - 1
        # ...while a dead generation is dropped by the same drain
        srv._alloc._host_evicted.append(hpid)
        srv._drop_evicted_host_data()
        with srv._spill_lock:
            assert hpid not in srv._host_data
            srv._host_data[hpid] = gen_
        # a stale writer item never overwrites a fresher residency's row
        rows = torch.zeros((1, srv._row_bytes), dtype=torch.uint8)
        with srv._spill_lock:
            srv._spill_outstanding += 1
        srv._spill_q.put(([(hpid, gen_ - 1)], rows, None))
        srv._await_spill_writer()
        assert torch.equal(srv._host_slab[hpid - srv._host_base], row)
        srv.check_alloc()
    finally:
        srv.close()


def test_writer_failure_reprefills_cold_without_hang(ref, monkeypatch):
    """Every stage fails on the kv-spill-writer: the server neither
    waits forever (export returns; the outstanding count drops on every
    path) nor serves a wrong token (failed pages are reaped and their
    prompts re-prefill cold), and the writer thread survives."""
    model = ref["bf16"]["model"]
    cfg = gen_cfg(gen.GenerationConfig)
    waves = conv_trace(seed=7)
    untiered, _ = serve(model, cfg, waves, **UNTIERED)

    def boom(self, rows, ready, dst):
        raise RuntimeError("injected spill-stage failure")

    monkeypatch.setattr(GenerationServer, "_d2h", boom)
    srv = GenerationServer(model, cfg, num_slots=2, seed=5, page_size=128,
                           prefill_chunk_pages=1, **TIERED)
    try:
        out = [[c.tokens for c in srv.run(w)] for w in waves]
        assert out == untiered
        assert srv._alloc.stats["spills"] > 0
        store = srv.export_prefix_store()
        assert store is not None and store["pages"] == {}
        assert srv._alloc.host_pages_resident == 0   # every failure reaped
        assert srv._spill_writer_thread.is_alive()
        srv.check_alloc()
    finally:
        srv.close()
    assert srv._spill_writer_thread is None


def test_cow_split_of_rehydrated_page_lands_on_card(ref):
    """Two requests admitting the same prompt off a rehydrated page
    share it; their divergent sampled writes split copy-on-write on the
    card and never touch the host copy: a third admission after
    everything spilled again still matches the untiered server."""
    model = ref["bf16"]["model"]
    cfg = gen_cfg(gen.GenerationConfig, "sampling")
    prompt = np.random.default_rng(17).integers(0, EOS, 140).tolist()
    waves = [[prompt], [list(prompt), list(prompt)], [list(prompt)]]
    tiered, ts = serve(model, cfg, waves, **TIERED)
    untiered, _ = serve(model, cfg, waves, **UNTIERED)
    assert tiered == untiered
    assert ts["rehydrates"] > 0 and ts["cow_splits"] >= 1


def test_tier_refusals(ref):
    model = ref["bf16"]["model"]
    cfg = gen_cfg(gen.GenerationConfig)
    with pytest.raises(ValueError, match="paged mode"):
        GenerationServer(model, cfg, host_pool_bytes=1 << 20)
    with pytest.raises(ValueError, match="prefix_sharing"):
        GenerationServer(model, cfg, page_size=128, pool_pages=8,
                         prefill_chunk_pages=1, prefix_sharing=False,
                         host_pool_bytes=1 << 20)
    with pytest.raises(ValueError, match="smaller than one KV page"):
        GenerationServer(model, cfg, page_size=128, pool_pages=8,
                         prefill_chunk_pages=1, host_pool_bytes=1024)
    # no tier: no writer thread, no export
    srv = GenerationServer(model, cfg, page_size=128, pool_pages=8,
                           prefill_chunk_pages=1)
    assert srv.export_prefix_store() is None
    assert srv.import_prefix_store({"pages": {}}) == 0
    assert "tiered" not in srv.summary()
    srv.close()
