"""``chip_smoke.py``'s ``serve_tiered`` and ``serve_robust`` phases on the
CPU at a tiny size (a 2-layer model with 512 positions, the trace cut
to 4 users and slots of the same shape): every arm's rows equal its
untiered twin with spills, rehydrates and fewer prefill chunks, arm C's
small int8 tier evicts, the decode kernels' counts are exact (counting
shims stand in for the kernels' launch counts), the batched-launch pin
holds, and the robustness checks pass; a twin that differs fails its
arm."""

import pytest

from _chip_smoke_shims import TINY, _lines, chip_smoke, shims  # noqa: F401

TINY_512 = TINY[:-1] + ["Model.max_position_embeddings=512",
                        "Generation.max_dec_len=4"]
TRACE = dict(chip_smoke.TIERED_TRACE, users=4, slots=3, max_dec_len=4)
#: the arms of the phase at the tiny model's page bytes (131,072 bf16,
#: 69,632 int8): 32 pages for A and B, 6 int8 pages for C
ARMS = (("A", "bf16", True, 0, 1, 32 * 131072),
        ("B", "bf16", True, 0, 4, 32 * 131072),
        ("C", "int8", False, 2, 1, 6 * 69632))


@pytest.fixture(scope="module")
def module():
    return chip_smoke.serving_module("cpu", TINY_512)


def test_serve_tiered_arms(shims, module, capsys):
    records = chip_smoke.phase_serve_tiered(module, "cpu", TRACE, ARMS)
    lines = [d for d in _lines(capsys) if d.get("phase") == "serve_tiered"]
    arms = {d["arm"]: d for d in lines if "arm" in d}
    assert sorted(arms) == ["A", "B", "C"]
    for label, rec in arms.items():
        t, u = rec["tiered"], rec["twin"]
        assert rec["rows_equal_twin"] and t["spills"] > 0
        assert t["rehydrates"] > 0 and t["prefill_chunks"] < \
            u["prefill_chunks"]
        assert rec["prefix_hit_rate"] > rec["prefix_hit_rate_twin"]
        assert t["host_slab_bytes"] > 0 and "ttft_p99_ms" in t
        assert rec["trace"]["requests"] == 12
    assert arms["C"]["tiered"]["host_evictions"] > 0
    assert arms["C"]["launches"]["flash_decode_paged_verify_int8"] > 0
    assert arms["B"]["ticks_replayed"] >= arms["B"]["tiered"]["decode_ticks"]
    assert arms["A"]["launches"]["flash_decode_paged"] == \
        arms["A"]["tiered"]["decode_ticks"] * 2
    pin = records["launch_pin"]
    assert [p["kv_cache_dtype"] for p in pin] == ["bf16", "int8"]
    for p in pin:
        assert len({tuple(v.values()) for v in p["ops"].values()}) == 1


def test_serve_tiered_fails_on_a_differing_twin(shims, module,
                                                monkeypatch):
    real = chip_smoke.serve_waves

    def wrong_twin(*args, **kw):
        rows, summary, counts, wall = real(*args, **kw)
        if "host_pool_bytes" not in kw:
            rows[0][0] = rows[0][0][:-1] + [(rows[0][0][-1] + 1) % 300]
        return rows, summary, counts, wall

    monkeypatch.setattr(chip_smoke, "serve_waves", wrong_twin)
    with pytest.raises(AssertionError, match="untiered twin"):
        chip_smoke.phase_serve_tiered(module, "cpu", TRACE, ARMS[:1])


def test_serve_robust(shims, module, capsys, tmp_path, monkeypatch):
    monkeypatch.setattr(chip_smoke, "OUT_DIR", str(tmp_path))
    rec = chip_smoke.phase_serve_robust(module, "cpu", requests=5, slots=3,
                                        max_dec_len=4, hi=200)
    assert rec["drain_resume"]["rows_equal"]
    assert rec["drain_resume"]["mid_decode"] > 0
    assert rec["healthz"] == [200, 503]
    store = rec["prefix_store"]
    assert store["adopted"] > 0 and store["warm_rehydrates"] > 0
    assert store["warm_prefill_chunks"] < store["cold_prefill_chunks"]
    assert [d for d in _lines(capsys) if d.get("phase") == "serve_robust"]
