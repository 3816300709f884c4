"""Telemetry, the profiler window, the epoch run mode and the
observability modules of the port, held to the JAX package's
(``tests/test_observability.py``, ``tests/test_engine.py``): the tiny
run's ``events.jsonl`` has the JAX engine's event names in its order on
the same configuration (less its ``compile`` event, which the port has
no counterpart of) and its fields; the span tree nests ``engine/fit`` ->
``engine/step`` -> ``engine/h2d``; a record survives SIGTERM; the
profiler window writes a chrome trace; epoch mode evaluates where JAX's
does; ``device_memory_stats`` is None on the CPU; the recorder rotates
at its ``max_bytes`` and both packages read the stream alike; the
timeline gives the JAX module's ``utilization`` and ``overlap_ratio``
on the same intervals."""

import json
import os
import signal

import numpy as np
import pytest

from _torch_engine_cfg import corpus, jax_engine, port_engine, tiny_over
from paddlefleetx_tpu.observability import memory as jax_memory
from paddlefleetx_tpu.observability import metrics as jax_metrics
from paddlefleetx_tpu.observability import recorder as jax_recorder
from paddlefleetx_tpu.observability import timeline as jax_timeline
from paddlefleetx_tpu_torch.observability import memory, metrics, timeline
from paddlefleetx_tpu_torch.observability.recorder import (
    FlightRecorder, read_events, read_tail,
)
from paddlefleetx_tpu_torch.observability.spans import NULL_SPAN, Tracer


@pytest.fixture
def registries():
    """Both packages' process-global registries left off and empty."""
    yield
    for mod in (metrics, jax_metrics):
        mod.get_registry().reset()
        mod.set_enabled(False)


def _tele(data, out, **extra):
    return tiny_over(data, out, **{
        "Telemetry.enable": True, "Engine.max_steps": 4,
        "Engine.logging_freq": 2, "Engine.eval_freq": 2,
        "Engine.save_load.save_steps": 4, **extra})


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]   # every line parses


def test_events_match_the_jax_engine(tmp_path, registries):
    """Same configuration, both engines: the same event names in the
    same order (JAX's ``compile`` aside), each event with JAX's fields
    (``fit_end`` with the summary's keys the port has), the dispatch
    counters on, and the summary printed by default."""
    data = corpus(tmp_path / "data")
    names, events = {}, {}
    for name, build in (("port", port_engine), ("jax", jax_engine)):
        out = str(tmp_path / name)
        _, engine, loader = build(_tele(data, out))
        valid = [next(iter(loader))]
        engine.fit(epoch=1, train_data_loader=loader,
                   valid_data_loader=valid)
        events[name] = _events(os.path.join(out, "events.jsonl"))
        names[name] = [e["event"] for e in events[name]
                       if not e["event"].startswith("span")]
        if name == "port":
            assert engine.recorder.path == os.path.join(out,
                                                        "events.jsonl")
            assert engine.print_summary     # telemetry turns it on
            assert metrics.get_registry().enabled
    assert "compile" in names["jax"]
    assert names["port"] == [n for n in names["jax"] if n != "compile"]
    assert names["port"] == [
        "fit_start", "step_window", "eval_start", "eval_end",
        "step_window", "eval_start", "eval_end", "save", "fit_end"]
    for ev in ("fit_start", "step_window", "eval_start", "eval_end",
               "save"):
        port = next(e for e in events["port"] if e["event"] == ev)
        jax = next(e for e in events["jax"] if e["event"] == ev)
        assert set(port) == set(jax), ev
    start = events["port"][0]
    assert set(start["mesh"]) == set(events["jax"][0]["mesh"])
    assert all(v == 1 for v in start["mesh"].values())
    win = next(e for e in events["port"] if e["event"] == "step_window")
    assert win["hbm"] is None and win["h2d_wait"] >= 0.0
    end = events["port"][-1]
    assert end["n_windows"] == 1 and end["tokens_per_sec"] > 0
    assert end["bucket_eval_s"] > 0 and end["bucket_save_s"] > 0
    assert 0 <= end["goodput_pct"] <= 100 and "h2d_mean_s" in end
    jend = events["jax"][-1]
    missing = set(jend) - set(end)
    assert missing == {"bucket_compile_s", "bucket_pipeline_bubble_s"}, \
        missing


def test_the_span_tree(tmp_path, registries):
    """``engine/fit`` is the root; each ``engine/step`` opens under it
    with an ``engine/h2d`` child; ``engine/save`` hangs off the fit;
    the fit span ends before ``fit_end``."""
    data = corpus(tmp_path / "data")
    out = str(tmp_path / "out")
    _, engine, loader = port_engine(_tele(data, out))
    engine.fit(epoch=1, train_data_loader=loader)
    events = read_events(engine.recorder.path)
    fit = next(e for e in events if e["event"] == "span_begin"
               and e["name"] == "engine/fit")
    steps = [e for e in events if e["event"] == "span_begin"
             and e["name"] == "engine/step"]
    assert len(steps) == 4 and all(s["parent"] == fit["span"]
                                   for s in steps)
    h2d = [e for e in events if e["event"] == "span"
           and e["name"] == "engine/h2d"]
    assert sorted(e["parent"] for e in h2d) == \
        sorted(s["span"] for s in steps)
    save = [e for e in events if e["event"] == "span"
            and e["name"] == "engine/save"]
    assert len(save) == 1 and save[0]["parent"] == fit["span"]
    kinds = [(e["event"], e.get("name")) for e in events]
    assert kinds.index(("span_end", "engine/fit")) < \
        kinds.index(("fit_end", None)) == len(kinds) - 1
    assert Tracer(None).start_trace("x") is NULL_SPAN


def test_a_record_survives_sigterm(tmp_path, registries):
    """Preempted mid-run: ``sigterm`` lands before the preemption save,
    ``preemption`` names the step, every line parses."""
    data = corpus(tmp_path / "data")
    out = str(tmp_path / "out")
    _, engine, loader = port_engine(_tele(data, out, **{
        "Engine.max_steps": 50, "Engine.eval_freq": 100}))
    orig = engine.module.training_step_end

    def hook(log):
        orig(log)
        if log["batch"] == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    engine.module.training_step_end = hook
    prev = signal.getsignal(signal.SIGTERM)
    engine.fit(epoch=1, train_data_loader=loader)
    assert signal.getsignal(signal.SIGTERM) is prev
    events = _events(os.path.join(out, "events.jsonl"))
    names = [e["event"] for e in events]
    sig = names.index("sigterm")
    assert "preemption" in names[sig:] and "save" in names[sig:]
    assert events[names.index("preemption")]["step"] == engine.step == 2
    assert events[sig]["signum"] == signal.SIGTERM


@pytest.mark.parametrize("window,resume", [((2, 4), 0), ((1, 3), 2)])
def test_profiler_window_writes_a_trace(tmp_path, registries, window,
                                        resume):
    """``Profiler.enable`` traces steps ``[start, stop)`` and writes a
    chrome trace into ``profiler_log``; a run resumed past ``start``
    still traces the rest of the window (a range check)."""
    data = corpus(tmp_path / "data")
    prof = str(tmp_path / "prof")
    extra = {"Profiler.enable": True,
             "Profiler.scheduler": f"[{window[0]},{window[1]}]",
             "Profiler.profiler_log": prof, "Engine.max_steps": 5,
             "Telemetry.enable": False}
    if resume:
        _, first, loader = port_engine(tiny_over(
            data, str(tmp_path / "a"), **{
                "Engine.max_steps": resume,
                "Engine.save_load.save_steps": resume}))
        first.fit(epoch=1, train_data_loader=loader)
        extra["Engine.save_load.ckpt_dir"] = str(
            tmp_path / "a" / f"epoch_0_step_{resume}")
    _, engine, loader = port_engine(tiny_over(data, str(tmp_path / "o"),
                                              **extra))
    assert engine.print_summary        # the profiler turns it on
    engine.fit(epoch=1, train_data_loader=loader)
    assert engine.profiler_trace and os.path.dirname(
        engine.profiler_trace) == prof
    with open(engine.profiler_trace) as f:
        trace = json.load(f)
    assert trace["traceEvents"]


def test_epoch_mode_evaluates_where_jax_does(tmp_path, registries):
    """``run_mode: epoch`` with ``eval_freq`` 1 and ``eval_iters`` -1:
    no mid-epoch eval, one eval at the epoch's end over the whole
    loader, in both engines."""
    data = corpus(tmp_path / "data")
    logs = {}
    for name, build in (("port", port_engine), ("jax", jax_engine)):
        _, engine, loader = build(tiny_over(
            data, str(tmp_path / name), **{
                "Engine.max_steps": 3, "Engine.eval_freq": 1,
                "Engine.eval_iters": -1, "Engine.run_mode": "epoch"}))
        assert engine.eval_iters is None and engine.run_mode == "epoch"
        step_logs, epoch_logs = [], []
        engine.module.validation_step_end = step_logs.append
        engine.module.validation_epoch_end = epoch_logs.append
        valid = [next(iter(loader)) for _ in range(2)]
        engine.fit(epoch=1, train_data_loader=loader,
                   valid_data_loader=valid)
        logs[name] = (len(step_logs), len(epoch_logs), epoch_logs[0])
    assert logs["port"][:2] == logs["jax"][:2] == (2, 1)
    assert np.isfinite(logs["port"][2]["loss"])
    assert logs["port"][2]["epoch"] == logs["jax"][2]["epoch"] == 0


def test_device_memory_stats_on_the_cpu():
    """None on the CPU (no allocator stats), as the JAX module's on its
    CPU devices; ``format_bytes`` as JAX's."""
    import torch
    assert memory.device_memory_stats(torch.device("cpu")) is None
    assert memory.device_memory_stats("cpu") is None
    for n in (None, 0, 3 * 2 ** 30 + 5, 1.5e9):
        assert memory.format_bytes(n) == jax_memory.format_bytes(n)


def test_recorder_rotates_and_reads_as_jax_does(tmp_path):
    """``max_bytes`` is an argument (64 MiB by default): past it the
    stream rolls once to ``<path>.1`` with a ``recorder_rotated`` event;
    the port's and the JAX readers see the same records."""
    path = str(tmp_path / "events.jsonl")
    assert FlightRecorder(str(tmp_path / "d.jsonl")).max_bytes == 64 << 20
    rec = FlightRecorder(path, max_bytes=600)
    for i in range(12):
        rec.emit("tick", i=i, pad="x" * 20)
    rec.close()
    assert os.path.exists(path + ".1")
    events = read_events(path)
    assert sum(e["event"] == "recorder_rotated" for e in events) == 1
    assert events == jax_recorder.read_events(path)
    assert [e["i"] for e in events if e["event"] == "tick"] == list(
        range(12))
    assert any(e["event"] == "recorder_rotated" for e in events)
    assert read_tail(path, 3) == jax_recorder.read_tail(path, 3)


def test_timeline_matches_the_jax_module():
    """The same intervals on tracks of both modules: equal
    ``utilization`` and ``overlap_ratio``; a disabled timeline records
    nothing; enabling is an argument."""
    ivs = {"fleet-worker-0": [("tick", 0.0, 1.0, None),
                              ("park", 1.0, 1.5, None),
                              ("tick", 1.5, 2.0, None)],
           "fleet-worker-1": [("tick", 0.5, 1.8, None),
                              ("idle", 1.8, 2.0, None)],
           "data-loader": [("load", 0.0, 0.2, None),
                           ("wait", 0.2, 2.0, None)]}
    assert timeline.utilization(ivs) == jax_timeline.utilization(ivs)
    assert timeline.overlap_ratio(ivs) == jax_timeline.overlap_ratio(ivs)
    assert timeline.overlap_ratio(ivs, prefix="data-") == \
        jax_timeline.overlap_ratio(ivs, prefix="data-")
    off = timeline.ThreadTimeline()
    tr = off.track("main")
    tr.add("step", tr.begin())
    assert off.snapshot() == {"main": []}
    on = timeline.ThreadTimeline(enabled=True, cap=2)
    tr = on.track("main")
    for _ in range(3):
        tr.add("step", tr.begin())
    assert len(on.snapshot()["main"]) == 2 and on.track("main") is tr
