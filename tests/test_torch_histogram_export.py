"""The port's ``observability/{histogram,metrics,export}.py`` against the
JAX package's on the same seeded observations: ``LogHistogram``
quantiles, snapshots and Prometheus buckets, the registry's snapshot
and the exposition text, ``merge_snapshots`` and ``chrome_trace``."""

import numpy as np
import pytest

from paddlefleetx_tpu.observability import export as jax_export
from paddlefleetx_tpu.observability import histogram as jax_histogram
from paddlefleetx_tpu.observability import metrics as jax_metrics
from paddlefleetx_tpu_torch.observability import export, histogram, metrics


def _samples(seed, n, kind):
    rng = np.random.default_rng(seed)
    if kind == "lognormal":
        return rng.lognormal(1.0, 1.5, n)
    if kind == "uniform":
        return rng.uniform(0.0, 50.0, n)
    # a mix: underflow, overflow, non-finite (dropped) and ordinary
    x = rng.exponential(3.0, n)
    x[::7] = 1e-5
    x[::11] = 1e9
    x[::13] = np.nan
    return x


@pytest.mark.parametrize("kind", ["lognormal", "uniform", "edges"])
@pytest.mark.parametrize("seed,n", [(0, 1), (1, 37), (2, 2000)])
def test_log_histogram_equals_jax(kind, seed, n):
    ours, ref = histogram.LogHistogram(), jax_histogram.LogHistogram()
    for v in _samples(seed, n, kind):
        ours.observe(v)
        ref.observe(v)
    assert ours.count == ref.count and ours.sum == ref.sum
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert ours.quantile(q) == ref.quantile(q)
    assert ours.snapshot() == ref.snapshot()
    assert list(ours.cumulative()) == list(ref.cumulative())
    finite = np.asarray([v for v in _samples(seed, n, kind)
                         if np.isfinite(v) and 1e-3 < v < 1e7])
    if kind != "edges" and finite.size > 10:
        # within the bucket's relative width of the exact percentile
        exact = np.percentile(finite, 50)
        assert abs(ours.percentile(50) - exact) <= 0.1 * exact


def _fill(reg, seed):
    rng = np.random.default_rng(seed)
    for i in range(40):
        reg.inc("serving/admitted")
        reg.inc("serving/decode_tokens", int(rng.integers(1, 5)))
        reg.observe("serving/ttft_ms", float(rng.lognormal(2, 1)))
        reg.observe("serving/tick_ms", float(rng.uniform(1, 9)))
        reg.add_time("serving/decode_tick", float(rng.uniform(0, 1)))
    reg.set_gauge("serving/slot_occupancy", 3)
    reg.set_gauge("serving/host_pages", 7.5)
    reg.set_gauge("serving/kv_cache_dtype", "bf16")   # not numeric


@pytest.mark.parametrize("seed", [0, 3])
def test_registry_and_prometheus_text_equal_jax(seed):
    ours, ref = metrics.MetricsRegistry(), jax_metrics.MetricsRegistry()
    _fill(ours, seed)
    _fill(ref, seed)
    # the JAX registry also keeps sample series, which the port has no
    # use for: the snapshots agree key for key otherwise
    assert ours.snapshot() == {k: v for k, v in ref.snapshot().items()
                               if k != "series"}
    text = export.prometheus_text([ours])
    assert text == jax_export.prometheus_text([ref])
    assert 'pfx_serving_ttft_ms_bucket{le="+Inf"} 40' in text
    assert "pfx_serving_admitted_total 40.0" in text
    # two registries merge by the JAX rules (sum, last-wins, first-wins)
    other, jother = metrics.MetricsRegistry(), jax_metrics.MetricsRegistry()
    _fill(other, seed + 1)
    _fill(jother, seed + 1)
    assert export.prometheus_text([ours, other]) == \
        jax_export.prometheus_text([ref, jother])
    assert export.merge_snapshots([ours.snapshot(), other.snapshot()]) == \
        jax_export.merge_snapshots([ref.snapshot(), jother.snapshot()])
    assert export.merge_snapshots([ours.snapshot()])["series"] == {}


def test_disabled_registry_records_nothing_and_reset_keeps_handles():
    reg = metrics.MetricsRegistry(enabled=False)
    reg.inc("a")
    reg.observe("h", 1.0)
    assert reg.snapshot()["counters"] == {} and reg.histogram("h") is None
    reg.set_enabled(True)
    reg.observe("h", 2.0)
    h = reg.histogram("h")
    reg.reset()
    assert reg.histogram("h") is h and h.count == 0
    metrics.set_enabled(True)
    try:
        metrics.observe("serving/rehydrate_ms", 4.0)
        assert metrics.get_registry().histogram(
            "serving/rehydrate_ms").count == 1
    finally:
        metrics.get_registry().reset()
        metrics.set_enabled(False)
    metrics.observe("serving/rehydrate_ms", 4.0)   # disabled: dropped
    assert metrics.get_registry().histogram(
        "serving/rehydrate_ms").count == 0


def test_chrome_trace_equals_jax():
    records = [
        {"ts": 1.0, "event": "span_begin", "name": "serving/request",
         "trace": "b", "span": "s1", "request": 0},
        {"ts": 1.5, "event": "span_point", "name": "serving/first_token",
         "trace": "b", "span": "s1", "ttft_ms": 5.0},
        {"ts": 2.0, "event": "span_end", "name": "serving/request",
         "trace": "b", "span": "s1", "dur_ms": 1000.0},
        {"ts": 3.0, "event": "span", "name": "engine/save", "trace": "a",
         "span": "s2", "dur_ms": 20.0},
        {"ts": 3.5, "event": "serving_admit", "request": 1},
    ]
    timeline = {"kv-spill-writer": [("spill_copy", 1.0, 1.25, None),
                                    ("idle", 1.25, 2.0, "b")],
                "main": [("step", 0.5, 0.75, None)]}
    assert export.chrome_trace(records, timeline) == \
        jax_export.chrome_trace(records, timeline)
    assert export.chrome_trace([]) == jax_export.chrome_trace([])
