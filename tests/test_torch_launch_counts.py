"""The kernel wrappers' launch counts (``ops/cuda/launch_counts.py``) and
how a replayed tick graph scales them (``core/decode_graph.py``), on the
CPU."""

import pytest
import torch

from paddlefleetx_tpu_torch.core import decode_graph
from paddlefleetx_tpu_torch.observability import metrics
from paddlefleetx_tpu_torch.ops.cuda import flash_attention as fa
from paddlefleetx_tpu_torch.ops.cuda import grouped_matmul as gmm
from paddlefleetx_tpu_torch.ops.cuda import launch_counts
from paddlefleetx_tpu_torch.ops.cuda import quantized_matmul as qmm


def _registered():
    return {fn for fn, _, _ in launch_counts._REGISTRY}


@pytest.mark.parametrize("module", [fa, gmm, qmm])
def test_every_counting_wrapper_is_registered(module):
    """A wrapper with launch counts that the registry misses would be
    undercounted inside a graph; none is."""
    counting = {fn for fn in vars(module).values()
                if any("launches" in attr
                       for attr in getattr(fn, "__dict__", ()))}
    assert counting and counting <= _registered()


def test_snapshot_delta_add_scale_a_tick():
    before = launch_counts.snapshot()
    fa.flash_decode_paged.launches += 24
    fa.flash_decode_paged.launches_by_route["mma"] += 24
    gmm.grouped_matmul.launches_by_route["split"] += 48
    moved = launch_counts.delta(launch_counts.snapshot(), before)
    assert sorted(moved.values()) == [24, 24, 48]
    launch_counts.add(moved, 3)
    assert fa.flash_decode_paged.launches - before[
        next(k for k in moved if k[1] == "launches")] == 4 * 24
    launch_counts.add(moved, -4)
    assert launch_counts.snapshot() == before


def test_graph_counts_scale_with_replays(monkeypatch):
    """The captured tick's kernel and registry counts are added once a
    replay, the capture's own taken back."""
    monkeypatch.setattr(metrics, "_global", metrics.MetricsRegistry())
    metrics.set_enabled(True)

    def tick():
        fa.flash_decode_paged.launches += 2
        metrics.inc("attention/flash_decode_paged", 2)

    before = decode_graph._counts()
    moved = decode_graph._delta((before[0], before[1]), before)
    assert moved == ({}, {})
    tick()
    moved = decode_graph._delta(decode_graph._counts(), before)
    decode_graph._add(moved, 4)
    assert fa.flash_decode_paged.launches - before[0][next(
        k for k in moved[0])] == 10
    assert metrics.get_registry().counter(
        "attention/flash_decode_paged") == 10
    decode_graph._add(moved, -5)
    assert decode_graph._counts()[0] == before[0]


def test_cpu_graph_runs_the_tick_eagerly():
    calls = []
    graph = decode_graph.TickGraph(lambda: calls.append(1),
                                   lambda: calls.append(0),
                                   torch.device("cpu"))
    graph.replay(3)
    graph.replay(1)
    assert calls == [1, 1, 1, 1]
    assert (graph.replays, graph.warmups) == (4, 0)
