"""The port's ``PageAllocator`` host tier against the JAX package's: one
seeded sequence of alloc / retain / release / register / spill /
promote / evict / import / sweep operations through both allocators
gives the same ids, return values, stats and registries at every step,
and ``check()`` holds throughout; plus the int8-aware
``pool_pages_for_bytes`` and the host tier's refusals."""

import numpy as np
import pytest

from paddlefleetx_tpu.core import paging as jax_paging
from paddlefleetx_tpu_torch.core import paging


def _state(a):
    return (sorted(a._free), dict(a._ref), dict(a._prefix),
            {k: v[0] for k, v in a._prompt.items()}, dict(a._hosted),
            sorted(a._host_free), dict(a.stats), a.host_pages_resident,
            a.free_pages, a.pages_in_use)


def _step(rng, ours, ref, keys):
    """One random operation on both allocators; returns its name."""
    live = sorted(ours._ref)
    hosted = sorted(ours._hosted)
    op = rng.choice(["alloc", "alloc", "alloc_many", "retain",
                     "retain_many", "release", "release", "reg_prefix",
                     "reg_prompt", "spill", "spill", "promote",
                     "evict_host", "host_import", "sweep"])
    args = ()
    if op == "alloc":
        name = "try_alloc"
    elif op == "alloc_many":
        name, args = "alloc_many", (int(rng.integers(1, 3)),)
        if args[0] > ours.free_pages:
            with pytest.raises(paging.PagePoolExhausted):
                ours.alloc_many(args[0])
            with pytest.raises(jax_paging.PagePoolExhausted):
                ref.alloc_many(args[0])
            return op
    elif op in ("retain", "release", "spill") and live:
        pid = int(rng.choice(live))
        if op == "spill" and ours.refcount(pid) != 1:
            op = "release"
        name, args = op, (pid,)
    elif op == "retain_many" and live:
        name = "retain_many"
        args = ([int(p) for p in rng.choice(live, min(2, len(live)),
                                              replace=False)],)
    elif op == "reg_prefix" and any(
            p not in ours._page_prefix_keys for p in live + hosted):
        # one content key a page, as a prefill registers them
        pid = int(rng.choice([p for p in live + hosted
                              if p not in ours._page_prefix_keys]))
        name, args = "register_prefix", (keys.pop(), pid)
    elif op == "reg_prompt" and (live or hosted):
        pages = [int(p) for p in rng.choice(
            live + hosted, min(3, len(live + hosted)), replace=False)]
        name, args = "register_prompt", (keys.pop(), pages, None)
    elif op == "promote" and hosted and ours.free_pages:
        hpid = int(rng.choice(hosted))
        pid = ours.alloc()
        assert ref.alloc() == pid
        name, args = "promote", (hpid, pid)
    elif op == "evict_host":
        hpid = int(rng.choice(hosted)) if hosted and rng.random() < 0.8 \
            else ours.num_pages + ours.host_pages + 5   # not resident
        name, args = "evict_host", (hpid,)
    elif op == "host_import":
        # an import registers what it adopts at once
        hpid = ours.host_import()
        assert ref.host_import() == hpid
        if hpid is not None:
            key = keys.pop()
            ours.register_prefix(key, hpid)
            ref.register_prefix(key, hpid)
        return op
    elif op == "sweep":
        name = "sweep_host_orphans"
    else:
        return None
    got = getattr(ours, name)(*args)
    want = getattr(ref, name)(*args)
    assert got == want, (name, args)
    assert ours.pop_host_evicted() == ref.pop_host_evicted()
    if name == "try_alloc" or op == "spill":
        # keep the ids generation-tagged as the server keeps them
        for h in sorted(ours._hosted):
            assert ours.host_generation(h) == ref.host_generation(h)
    return op


@pytest.mark.parametrize("seed,host_pages", [(0, 3), (1, 1), (2, 6),
                                             (3, 0)])
def test_random_trace_matches_jax_allocator(seed, host_pages):
    rng = np.random.default_rng(seed)
    ours = paging.PageAllocator(9, 128, host_pages=host_pages)
    ref = jax_paging.PageAllocator(9, 128, host_pages=host_pages)
    keys = [f"k{i}" for i in range(2000)]
    seen = set()
    for _ in range(600):
        op = _step(rng, ours, ref, keys)
        seen.add(op)
        ours.check()
        ref.check()
        assert _state(ours) == _state(ref)
        snap, jsnap = ours.host_snapshot(), ref.host_snapshot()
        assert snap[0] == jsnap[0]
        assert {k: v[0] for k, v in snap[1].items()} == \
            {k: v[0] for k, v in jsnap[1].items()}
    if host_pages:
        assert {"spill", "promote", "host_import", "evict_host"} <= seen
        assert ours.stats["spills"] and ours.stats["rehydrates"]


def test_spill_promote_cycle_and_lru_eviction():
    for mod in (paging, jax_paging):
        a = mod.PageAllocator(4, 128, host_pages=2)
        p1, p2, p3 = a.alloc(), a.alloc(), a.alloc()
        a.register_prefix("a", p1)
        a.register_prompt("ab", [p1, p2], "logits")
        a.register_prefix("c", p3)
        h1 = a.spill(p1)
        assert a.is_host(h1) and h1 >= a.num_pages
        assert a.lookup_prefix("a") == h1
        assert a.lookup_prompt("ab")[0] == (h1, p2)
        h3 = a.spill(p3)
        assert a.host_generation(h3) > a.host_generation(h1)
        # the tier is full: the LRU page h1 goes, and with it the prompt
        # entry that was p2's only registration, so p2 stays (None)
        assert a.spill(p2) is None and a.refcount(p2) == 1
        assert a.pop_host_evicted() == [h1]
        assert a.lookup_prefix("a") is None
        assert a.lookup_prompt("ab") is None
        assert a.stats["host_evictions"] == 1
        fresh = a.alloc()
        a.promote(h3, fresh)
        assert a.lookup_prefix("c") == fresh and not a.is_host(h3)
        a.check()


def test_spill_refusals_and_pool_sizing():
    a = paging.PageAllocator(4, 128, host_pages=1)
    p = a.alloc()
    assert a.spill(p) is None                  # unregistered: no spill
    a.retain(p)
    with pytest.raises(ValueError, match="refcount"):
        a.spill(p)
    with pytest.raises(ValueError):
        a.promote(99, p)
    with pytest.raises(ValueError):
        paging.PageAllocator(4, 128, host_pages=-1)
    b = paging.PageAllocator(4, 128)          # no host tier
    pid = b.alloc()
    b.register_prefix("k", pid)
    assert b.spill(pid) is None
    # the byte budget turns into pages for the KV dtype (int8: ~1.9x)
    for dtype in ("bf16", "int8"):
        args = (64 << 20, 24, 16, 64, 128, dtype)
        assert paging.pool_pages_for_bytes(*args) == \
            jax_paging.pool_pages_for_bytes(*args)
    assert paging.pool_pages_for_bytes(384 << 20, 24, 16, 64, 128) == 32
    assert paging.pool_pages_for_bytes(64 << 20, 24, 16, 64, 128,
                                       "int8") == 10
