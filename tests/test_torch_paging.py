"""The port's paging bookkeeping and draft source against the JAX
package's: the same seeded admit / grow / copy-on-write / evict /
preempt trace gives the same page ids, refcounts and registry answers
from both ``PageAllocator``s, the content keys are equal, the pool
sizing agrees, and ``NgramDraftSource`` proposes the same drafts on
random histories."""

import numpy as np
import pytest

from _torch_parity import rng
from paddlefleetx_tpu.core import paging as jax_paging
from paddlefleetx_tpu.core import spec as jax_spec
from paddlefleetx_tpu_torch.core import paging, spec


@pytest.mark.parametrize("page", [2, 4, 128])
def test_content_keys_equal(page):
    r = rng(page)
    for _ in range(20):
        toks = r.integers(0, 50304, int(r.integers(1, 3 * page + 3))).tolist()
        assert paging.page_prefix_keys(toks, page) == \
            jax_paging.page_prefix_keys(toks, page)
        assert paging.prompt_key(toks) == jax_paging.prompt_key(toks)
    assert paging.prompt_key([1, 2]) != paging.prompt_key([1, 2, 0])


def test_pool_sizing_equal():
    for args in ((16, 64, 128), (8, 128, 256)):
        for dt in ("bf16", "int8"):
            assert paging.kv_page_bytes(*args, dt) == \
                jax_paging.kv_page_bytes(*args, dt)
            assert paging.pool_bytes(24, *args, 65, dt) == \
                jax_paging.pool_bytes(24, *args, 65, dt)
            assert paging.pool_pages_for_bytes(1 << 30, 24, *args, dt) == \
                jax_paging.pool_pages_for_bytes(1 << 30, 24, *args, dt)
    with pytest.raises(ValueError):
        paging.kv_page_bytes(16, 64, 128, "fp8")


def test_allocator_validation_and_roundtrip():
    for bad in ((1, 4), (4, 0)):
        with pytest.raises(ValueError):
            paging.PageAllocator(*bad)
        with pytest.raises(ValueError):
            jax_paging.PageAllocator(*bad)
    a = paging.PageAllocator(num_pages=3, page_size=4)
    assert [a.alloc(), a.alloc()] == [1, 2]
    assert a.try_alloc() is None
    with pytest.raises(paging.PagePoolExhausted):
        a.alloc()
    with pytest.raises(ValueError):
        a.retain(0)
    a.register_prefix("k", 1)
    a.register_prompt("p", [1, 2], payload="logits")
    assert a.page_registered(2)
    assert a.release(2)                  # the prompt entry dies with it
    assert a.lookup_prompt("p") is None and a.lookup_prefix("k") == 1
    a.check()


def _step(alloc, live, op, r, page, ledger):
    """One transition of the server's mix on ``alloc`` (the same
    decisions whichever package's allocator it is, since they are made
    from ``r``'s draws and the allocator's answers); appends every
    answer the allocator gave to ``ledger``."""
    if op == "admit":
        base = int(r.integers(0, 3))
        L = int(r.integers(1, 3 * page + 1))
        toks = [base] * L
        hit = alloc.lookup_prompt(paging.prompt_key(toks))
        ledger.append(("prompt_hit", None if hit is None else hit[0]))
        pages = []
        if hit is not None:
            for pid in hit[0]:
                ledger.append(("retain", alloc.retain(pid)))
                pages.append(pid)
        else:
            keys = paging.page_prefix_keys(toks, page)[:(L - 1) // page]
            shared = 0
            for k in keys:
                pid = alloc.lookup_prefix(k)
                ledger.append(("prefix", pid))
                if pid is None:
                    break
                alloc.retain(pid)
                pages.append(pid)
                shared += 1
            need = -(-L // page) - shared
            got = []
            for _ in range(need):
                pid = alloc.try_alloc()
                ledger.append(("alloc", pid))
                if pid is None:
                    break
                got.append(pid)
            if len(got) < need:
                for pid in got + pages:
                    ledger.append(("release", alloc.release(pid)))
                return
            pages += got
            for j, k in enumerate(keys):
                alloc.register_prefix(k, pages[j])
            alloc.register_prompt(paging.prompt_key(toks), pages, payload=L)
        live[len(ledger)] = pages
    elif op == "grow" and live:
        rid = sorted(live)[int(r.integers(0, len(live)))]
        pid = alloc.try_alloc()
        ledger.append(("grow", pid))
        if pid is not None:
            live[rid].append(pid)
    elif op == "cow" and live:
        rid = sorted(live)[int(r.integers(0, len(live)))]
        pages = live[rid]
        j = int(r.integers(0, len(pages)))
        if alloc.refcount(pages[j]) > 1:
            new = alloc.try_alloc()
            ledger.append(("cow", new))
            if new is not None:
                ledger.append(("release", alloc.release(pages[j])))
                pages[j] = new
                alloc.stats["cow_splits"] += 1
    elif op in ("evict", "preempt") and live:
        # a preemption releases like an eviction; the request requeues
        rid = sorted(live)[int(r.integers(0, len(live)))]
        for pid in live.pop(rid):
            ledger.append((op, alloc.release(pid)))


def test_allocator_trace_equals_jax():
    """The randomized admit / grow / COW / evict / preempt trace of the
    JAX package's own tests (``tests/test_paging.py``), replayed on both
    allocators side by side: every answer, refcount, free count and
    registry entry agrees after every step, and the drained pool is
    whole."""
    page = 4
    ours = paging.PageAllocator(num_pages=17, page_size=page)
    theirs = jax_paging.PageAllocator(num_pages=17, page_size=page)
    r_ours, r_theirs = rng(0), rng(0)
    live_ours, live_theirs = {}, {}
    ledger_ours, ledger_theirs = [], []
    ops = ["admit", "grow", "cow", "evict", "preempt"]
    for _ in range(1500):
        op = ops[int(r_ours.integers(0, len(ops)))]
        assert op == ops[int(r_theirs.integers(0, len(ops)))]
        _step(ours, live_ours, op, r_ours, page, ledger_ours)
        _step(theirs, live_theirs, op, r_theirs, page, ledger_theirs)
        assert ledger_ours == ledger_theirs
        assert live_ours == live_theirs
        assert ours._free == theirs._free and ours._ref == theirs._ref
        assert ours._prefix == theirs._prefix
        assert {k: v[0] for k, v in ours._prompt.items()} == \
            {k: v[0] for k, v in theirs._prompt.items()}
        ours.check()
        theirs.check()
    assert {k: ours.stats[k] for k in ours.stats} == \
        {k: theirs.stats[k] for k in ours.stats}
    for rid in list(live_ours):
        for pid in live_ours.pop(rid):
            ours.release(pid)
    ours.check()
    assert ours.pages_in_use == 0 and ours.free_pages == 16
    assert ours.stats["allocs"] == ours.stats["frees"]


@pytest.mark.parametrize("max_ngram", [1, 3])
def test_ngram_drafts_equal_jax(max_ngram):
    r = rng(10 + max_ngram)
    ours = spec.make_draft_source("ngram", max_ngram=max_ngram)
    theirs = jax_spec.make_draft_source("ngram", max_ngram=max_ngram)
    for _ in range(600):
        # a small alphabet makes n-gram matches common
        hist = r.integers(0, int(r.choice([2, 4, 16, 50304])),
                          int(r.integers(0, 80))).tolist()
        k = int(r.integers(1, 6))
        assert ours.propose(hist, k) == theirs.propose(hist, k)
        assert len(ours.propose(hist, k)) == k
    with pytest.raises(ValueError):
        spec.make_draft_source("draft_model")
    with pytest.raises(ValueError):
        spec.NgramDraftSource(0)
    assert np.asarray(ours.propose([7, 8, 9, 7, 8], 2)).tolist() == [7, 8]
