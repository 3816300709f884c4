"""The port's ``core/resilience.py`` against the JAX package's: the fault
spec grammar, one-shot firing, raise mode, seeded probabilistic firing
equal to JAX's ``FaultInjector`` ordinal for ordinal, ``corrupt_ckpt``,
the watchdog's stall dedup, adaptive deadline and abort, and
``dump_all_stacks``; then the engine's sites: an engine killed in raise
mode at step K (saving every 2 steps) stops where the JAX engine stops
and resumes to the uninterrupted run's losses, a ``corrupt_ckpt`` save
is refused on load, and the ``train_step`` watchdog is armed around
every step. The port takes every knob as an argument; the JAX side
reads the ``PFX_*`` variables the tests set."""

import os
import threading
import time

import pytest

from _torch_engine_cfg import (
    CONFIG, GPTModule, corpus, get_config, jax_engine, port_engine,
    tiny_over,
)
from paddlefleetx_tpu.core import resilience as jax_res
from paddlefleetx_tpu_torch.core import checkpoint as ckpt
from paddlefleetx_tpu_torch.core import resilience as res
from paddlefleetx_tpu_torch.core.engine import Engine
from paddlefleetx_tpu_torch.data import build_dataloader
from paddlefleetx_tpu_torch.observability import metrics


class Recorder:
    """An in-memory flight recorder."""

    def __init__(self):
        self.events = []

    def emit(self, event, **fields):
        self.events.append({"event": event, **fields})

    def of(self, name):
        return [e for e in self.events if e["event"] == name]


GOOD = ["kill@step=7", "hang@tick=p0.5:2s", "corrupt_ckpt@save=2",
        "admit_fail@req=3", "hang@step=5:0.5s", "kill@tick=p0.05"]
BAD = ["kill@step", "nuke@step=1", "kill@lunch=1", "kill", "kill@step=x",
       "hang@tick=p0.1:s2"]


@pytest.mark.parametrize("spec", GOOD)
def test_fault_grammar_parses_as_jax(spec):
    ours = res.FaultInjector(spec, kill_mode="raise")._faults[0]
    ref = jax_res.FaultInjector(spec, kill_mode="raise")._faults[0]
    assert (ours.kind, ours.site, ours.at, ours.prob, ours.duration,
            ours.spec) == (ref.kind, ref.site, ref.at, ref.prob,
                           ref.duration, ref.spec)


@pytest.mark.parametrize("spec", BAD)
def test_bad_fault_specs_raise_as_in_jax(spec):
    with pytest.raises(ValueError):
        jax_res.FaultInjector(spec)
    with pytest.raises(ValueError):
        res.FaultInjector(spec)


def test_fire_is_one_shot_recorded_and_raise_mode_kills():
    rec = Recorder()
    inj = res.FaultInjector("admit_fail@req=3,kill@step=2", recorder=rec,
                            kill_mode="raise")
    assert inj.fire("req", 1) is None
    assert inj.fire("step", 3) is None      # wrong count
    assert inj.fire("req", 3) == "admit_fail"
    assert inj.fire("req", 3) is None       # one-shot
    (ev,) = rec.of("fault_injected")
    assert ev["kind"] == "admit_fail" and ev["count"] == 3
    with pytest.raises(res.InjectedKill):
        inj.fire("step", 2)
    assert rec.of("fault_injected")[-1]["kind"] == "kill"  # before the act
    with pytest.raises(ValueError, match="kill_mode"):
        res.FaultInjector("kill@step=1", kill_mode="maybe")
    assert res.FaultInjector("kill@step=1").kill_mode == "kill"


def test_hang_waits_its_duration():
    inj = res.FaultInjector("hang@tick=2:0.2s")
    t0 = time.monotonic()
    assert inj.fire("tick", 2) == "hang"
    assert time.monotonic() - t0 >= 0.19


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_seeded_probabilistic_firing_equals_jax(seed):
    spec = "admit_fail@req=p0.3,hang@tick=p0.2:0.001s,admit_fail@req=p0.5"
    ours = res.FaultInjector(spec, seed=seed, kill_mode="raise")
    ref = jax_res.FaultInjector(spec, seed=seed, kill_mode="raise")
    got, want = [], []
    for i in range(1, 30):
        site = "tick" if i % 3 == 0 else "req"
        got.append(ours.fire(site, i))
        want.append(ref.fire(site, i))
    assert got == want
    assert "admit_fail" in got


def test_corrupt_ckpt_is_refused_by_verification(tmp_path):
    path = str(tmp_path / "epoch_0_step_1")
    os.makedirs(path)
    with open(os.path.join(path, "model.pt"), "wb") as f:
        f.write(b"x" * 4096)
    with open(os.path.join(path, "meta.json"), "w") as f:
        f.write("{}")
    ckpt.write_manifest(path)
    assert ckpt.verify_checkpoint(path) is None
    inj = res.FaultInjector("corrupt_ckpt@save=1", kill_mode="raise")
    assert inj.fire("save", 1, path=path) == "corrupt_ckpt"
    assert os.path.getsize(os.path.join(path, "model.pt")) == 4095
    assert "mismatch" in ckpt.verify_checkpoint(path)
    # no path in context: nothing happens, nothing raises
    assert res.FaultInjector("corrupt_ckpt@save=1").fire("save", 1) == \
        "corrupt_ckpt"


def _wait_for(predicate, timeout=5.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if predicate():
            return True
        time.sleep(0.01)
    return False


def test_watchdog_stall_fires_once_per_armed_phase():
    rec = Recorder()
    dog = res.StepWatchdog(name="t", factor=2.0, min_interval_s=0.05,
                           recorder=rec)
    dog.start()
    try:
        dog.arm(tag="step 1")
        assert _wait_for(lambda: dog.stalls == 1)
        time.sleep(0.2)            # still armed: must not fire again
        assert dog.stalls == 1
        dog.disarm()
        dog.arm(tag="step 2")      # a new phase may stall again
        assert _wait_for(lambda: dog.stalls == 2)
        dog.disarm()
        ev = rec.of("watchdog_stall")[0]
        assert ev["name"] == "t" and ev["tag"] == "step 1"
        assert ev["waited_s"] > ev["deadline_s"] and ev["action"] == "log"
        assert "watchdog:t" in ev["stacks"]   # the monitor's own thread
    finally:
        dog.stop()
    assert dog._thread is None


def test_watchdog_adaptive_deadline_equals_jax():
    ours = res.StepWatchdog(name="t", factor=4.0, min_interval_s=0.01)
    ref = jax_res.StepWatchdog(name="t", factor=4.0, min_interval_s=0.01,
                               action="log")
    assert ours.deadline_s() == ref.deadline_s() == 0.01
    for d in (0.5, 1.0, 1.5, 0.25):
        ours._durations.append(d)
        ref._durations.append(d)
        assert ours.deadline_s() == ref.deadline_s()
    ours.arm()
    ours.disarm()
    assert len(ours._durations) == 5     # the completed phase counts
    # the JAX defaults, without any environment read
    dflt = res.StepWatchdog()
    assert (dflt.factor, dflt.min_interval_s, dflt.action) == \
        (10.0, 60.0, "log")


def test_watchdog_abort_calls_abort_fn():
    aborted = threading.Event()
    dog = res.StepWatchdog(name="t", factor=2.0, min_interval_s=0.05,
                           action="abort")
    dog._abort_fn = aborted.set         # never os._exit in a test
    dog.start()
    try:
        dog.arm()
        assert _wait_for(aborted.is_set)
    finally:
        dog.disarm()
        dog.stop()
    with pytest.raises(ValueError, match="action"):
        res.StepWatchdog(action="sometimes")


def test_dump_all_stacks_names_every_thread():
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, args=(5.0,), name="sleeper",
                         daemon=True)
    t.start()
    try:
        out = res.dump_all_stacks()
    finally:
        stop.set()
        t.join(timeout=5.0)
    assert "test_dump_all_stacks_names_every_thread" in out
    assert 'thread "MainThread"' in out and 'thread "sleeper"' in out


def _losses(engine):
    got = {}
    orig = engine.module.training_step_end

    def capture(log):
        got[log["batch"]] = log["loss"]
        orig(log)

    engine.module.training_step_end = capture
    return got


def test_engine_killed_at_step_resumes_to_uninterrupted_losses(
        tmp_path, monkeypatch):
    """kill@step=5 with a save every 2 steps: both engines die after
    step 5 with step 4 the newest durable checkpoint; the port resumes
    there and its steps 5 and 6 equal the uninterrupted run's."""
    data = corpus(tmp_path / "data")
    over = {"Engine.max_steps": 6, "Engine.save_load.save_steps": 2}
    _, full, loader = port_engine(tiny_over(data, str(tmp_path / "full"),
                                            **over))
    base = _losses(full)
    full.fit(epoch=1, train_data_loader=loader)
    assert sorted(base) == [1, 2, 3, 4, 5, 6]

    out = str(tmp_path / "chaos")
    _, chaos, loader = port_engine(tiny_over(data, out, **over))
    chaos._faults = res.FaultInjector("kill@step=5", kill_mode="raise")
    got = _losses(chaos)
    with pytest.raises(res.InjectedKill):
        chaos.fit(epoch=1, train_data_loader=loader)
    assert got == {s: base[s] for s in range(1, 6)}
    assert os.path.basename(ckpt.latest_checkpoint(out)) == \
        "epoch_0_step_4"

    jout = str(tmp_path / "jax")
    monkeypatch.setenv("PFX_FAULTS", "kill@step=5")
    monkeypatch.setenv("PFX_FAULTS_MODE", "raise")
    _, jeng, jloader = jax_engine(tiny_over(data, jout, **over))
    with pytest.raises(jax_res.InjectedKill):
        jeng.fit(epoch=1, train_data_loader=jloader)
    monkeypatch.delenv("PFX_FAULTS")
    assert os.path.basename(ckpt.latest_checkpoint(jout)) == \
        "epoch_0_step_4"

    _, resumed, loader = port_engine(tiny_over(data, out, **{
        **over, "Engine.save_load.ckpt_dir": out}))
    assert resumed.step == 4
    res_losses = _losses(resumed)
    resumed.fit(epoch=1, train_data_loader=loader)
    assert res_losses == {5: base[5], 6: base[6]}


def test_engine_corrupt_save_and_step_watchdog(tmp_path):
    """``corrupt_ckpt@save=2`` garbles the second save, which a load
    then refuses (falling back to the first); the ``train_step``
    watchdog is armed and disarmed around every step and takes the
    engine's recorder."""
    data = corpus(tmp_path / "data")
    out = str(tmp_path / "out")
    inj = res.FaultInjector("corrupt_ckpt@save=2", kill_mode="raise")
    dog = res.StepWatchdog(name="train_step", min_interval_s=60.0)
    cfg = get_config(CONFIG, tiny_over(data, out, **{
        "Engine.max_steps": 4, "Engine.save_load.save_steps": 2,
        "Telemetry.enable": True,
        "Telemetry.events_path": str(tmp_path / "events.jsonl")}))
    module = GPTModule(cfg, device="cpu")
    engine = Engine(cfg, module, device="cpu", fault_injector=inj,
                    watchdog=dog)
    try:
        assert dog._thread is not None and dog._recorder is \
            engine.recorder and inj._recorder is engine.recorder
        loader = build_dataloader(cfg.Data, "Train")
        loader.batch_sampler.batch_size = cfg.Global.global_batch_size
        engine.fit(epoch=1, train_data_loader=loader)
        assert len(dog._durations) == 4 and dog._armed_at is None
        assert dog.stalls == 0
    finally:
        dog.stop()
        metrics.set_enabled(False)
    step4 = os.path.join(out, "epoch_0_step_4")
    assert "mismatch" in ckpt.verify_checkpoint(step4)
    assert os.path.basename(ckpt.latest_checkpoint(out)) == \
        "epoch_0_step_2"
