"""SIGTERM preemption in the port's ``Engine.fit``, mirroring the JAX
engine's tests (``tests/test_engine.py``): a SIGTERM sent from a step
hook saves at that step's boundary and stops, where the JAX engine on
the same configuration stops and saves; a SIGTERM during an eval breaks
out of it and still saves; ``save_on_preemption: False`` leaves the
handler alone; the previous handler is restored; a resume from the
preemption checkpoint trains to the same losses as an uninterrupted
run."""

import os
import signal

import numpy as np
import pytest

from _torch_engine_cfg import (
    corpus, jax_engine, port_engine, tiny_over,
)
from _torch_parity import one_thread
from paddlefleetx_tpu_torch.core import checkpoint as ckpt


def _kill_at(module, step):
    """Send this process SIGTERM from ``module``'s step hook once the
    logged step reaches ``step`` (the main thread, between steps)."""
    orig = module.training_step_end

    def hook(log):
        orig(log)
        if log["batch"] == step:
            os.kill(os.getpid(), signal.SIGTERM)

    module.training_step_end = hook


def test_sigterm_saves_and_stops_where_jax_does(tmp_path):
    """SIGTERM at step 3 of 50: both engines save ``epoch_0_step_3``,
    stop there, and restore the previous handler; a fresh port engine
    resumes at step 3."""
    data = corpus(tmp_path / "data")
    stopped = {}
    for name, build in (("port", port_engine), ("jax", jax_engine)):
        out = str(tmp_path / name)
        _, engine, loader = build(tiny_over(data, out, **{
            "Engine.max_steps": 50}))
        assert engine.save_on_preemption   # the JAX default, on
        _kill_at(engine.module, 3)
        prev = signal.getsignal(signal.SIGTERM)
        engine.fit(epoch=1, train_data_loader=loader)
        assert signal.getsignal(signal.SIGTERM) is prev
        stopped[name] = os.path.basename(ckpt.latest_checkpoint(out))
    assert stopped == {"port": "epoch_0_step_3", "jax": "epoch_0_step_3"}
    _, again, _ = port_engine(tiny_over(data, str(tmp_path / "again"), **{
        "Engine.save_load.ckpt_dir": str(tmp_path / "port")}))
    assert again.step == 3


def test_sigterm_during_eval_breaks_out_and_saves(tmp_path):
    """The signal lands while an eval of 100 batches runs: the eval
    stops after the batch in hand, and the step-2 checkpoint is
    written."""
    data = corpus(tmp_path / "data")
    out = str(tmp_path / "out")
    _, engine, loader = port_engine(tiny_over(data, out, **{
        "Engine.max_steps": 4, "Engine.eval_freq": 2,
        "Engine.eval_iters": 100}))
    seen = []

    def eval_loader():
        for i, b in enumerate(loader):
            if i == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            seen.append(i)
            yield b

    prev = signal.getsignal(signal.SIGTERM)
    engine.fit(epoch=1, train_data_loader=loader,
               valid_data_loader=eval_loader())
    assert signal.getsignal(signal.SIGTERM) is prev
    # the prefetch stages 2 ahead of the batch in hand
    assert len(seen) <= 2 + engine.prefetch_depth, seen
    assert engine.step == 2
    assert ckpt.latest_checkpoint(out).endswith("step_2")


def test_opt_out_leaves_the_handler_alone(tmp_path):
    """``save_on_preemption: False``: our handler stays installed the
    whole fit, the run goes on to its end, and the only checkpoint is
    the epoch's end (no preemption save at step 1)."""
    data = corpus(tmp_path / "data")
    _, engine, loader = port_engine(tiny_over(data, str(tmp_path / "o"), **{
        "Engine.max_steps": 2,
        "Engine.save_load.save_on_preemption": False}))
    assert not engine.save_on_preemption
    seen = []

    def mine(*a):
        seen.append(a)

    prev = signal.signal(signal.SIGTERM, mine)
    try:
        _kill_at(engine.module, 1)
        engine.fit(epoch=1, train_data_loader=loader)
        assert signal.getsignal(signal.SIGTERM) is mine
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert len(seen) == 1 and engine.step == 2
    assert sorted(d for d in os.listdir(tmp_path / "o")
                  if ckpt._STEP_DIR.match(d)) == ["epoch_1_step_2"]


def test_the_handler_is_restored_after_an_error(tmp_path):
    """A fit that raises still puts the previous handler back."""
    data = corpus(tmp_path / "data")
    _, engine, loader = port_engine(tiny_over(data, str(tmp_path / "o")))

    def broken(log):
        raise RuntimeError("hook failed")

    engine.module.training_step_end = broken
    prev = signal.getsignal(signal.SIGTERM)
    with pytest.raises(RuntimeError, match="hook failed"):
        engine.fit(epoch=1, train_data_loader=loader)
    assert signal.getsignal(signal.SIGTERM) is prev


def test_resume_after_preemption_equals_an_uninterrupted_run(tmp_path):
    """Preempted at step 2 of 5 with dropout, then resumed: the resumed
    run's steps 3..5 equal the uninterrupted run's bit for bit."""
    data = corpus(tmp_path / "data")
    extra = {"Engine.max_steps": 5, "Model.hidden_dropout_prob": 0.1,
             "Model.attention_probs_dropout_prob": 0.1}
    with one_thread():
        _, full, loader = port_engine(tiny_over(data, str(tmp_path / "a"),
                                                **extra))
        full.fit(epoch=1, train_data_loader=loader)
        _, first, loader = port_engine(tiny_over(data, str(tmp_path / "b"),
                                                 **extra))
        _kill_at(first.module, 2)
        first.fit(epoch=1, train_data_loader=loader)
        assert first.step == 2
        _, resumed, loader = port_engine(tiny_over(
            data, str(tmp_path / "c"), **extra,
            **{"Engine.save_load.ckpt_dir": str(tmp_path / "b")}))
        resumed.fit(epoch=1, train_data_loader=loader)
    assert resumed.step == 5
    got = [h["loss"] for h in resumed.history]
    assert got == [h["loss"] for h in full.history[2:]]
    assert all(np.isfinite(got))
