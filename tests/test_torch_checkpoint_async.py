"""The port's checkpoint services (``core/checkpoint.py``), mirroring
the JAX package's resilience tests (``tests/test_resilience.py``): an
async save then a resume equals a synchronous one bit for bit; the
state an async save writes at step k is the state before step k + 1,
even while k + 1 runs; keep-last-k GC keeps the k newest verified
directories, spares an uncommitted one and deletes exactly what the JAX
``gc_checkpoints`` deletes on the same tree; the resolve skips torn
directories with a ``ckpt_fallback`` event, as JAX's does; a corrupt
newest checkpoint falls back at resolve and at load; a writer that
dies leaves a torn directory that a resume skips."""

import os
import shutil
import threading

import numpy as np
import pytest
import torch

from _torch_engine_cfg import corpus, port_engine, tiny_over
from paddlefleetx_tpu.core import checkpoint as jax_ckpt
from paddlefleetx_tpu_torch.core import checkpoint as ckpt


class Recorder:
    """Event-collecting stand-in for the flight recorder."""

    def __init__(self):
        self.events = []

    def emit(self, event, **fields):
        self.events.append({"event": event, **fields})

    def of(self, event):
        return [e for e in self.events if e["event"] == event]


def _fake_step_dir(root, epoch, step, commit=True, payload=b"x" * 64):
    """A step dir with one payload file, optionally committed."""
    path = os.path.join(root, f"epoch_{epoch}_step_{step}")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "state.bin"), "wb") as f:
        f.write(payload)
    if commit:
        ckpt.write_manifest(path, {"epoch": epoch, "step": step})
    return path


def _tensors(path):
    out = {}
    for name in ("model.pt", "optimizer.pt"):
        def walk(obj, key):
            if isinstance(obj, torch.Tensor):
                out[f"{name}{key}"] = obj
            elif isinstance(obj, dict):
                for k, v in obj.items():
                    walk(v, f"{key}/{k}")
            elif isinstance(obj, (list, tuple)):
                for i, v in enumerate(obj):
                    walk(v, f"{key}/{i}")
            else:
                out[f"{name}{key}"] = obj
        walk(torch.load(os.path.join(path, name), weights_only=True), "")
    return out


def _same(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        if isinstance(ta[k], torch.Tensor):
            assert torch.equal(ta[k], tb[k]), k
        else:
            assert ta[k] == tb[k], k


def _run(data, out, **extra):
    over = tiny_over(data, out, **{"Engine.max_steps": 4,
                                   "Engine.save_load.save_steps": 2,
                                   "Model.hidden_dropout_prob": 0.1,
                                   **extra})
    _, engine, loader = port_engine(over)
    engine.fit(epoch=1, train_data_loader=loader)
    return engine


def test_async_save_and_resume_equal_the_synchronous_ones(tmp_path):
    """Every tensor an async save writes (steps 2 and 4, the first while
    steps 3 and 4 ran) equals the synchronous save's, and a resume from
    each run's step-2 checkpoint trains the same two steps."""
    data = corpus(tmp_path / "data")
    sync = _run(data, str(tmp_path / "sync"))
    asy = _run(data, str(tmp_path / "async"),
               **{"Engine.save_load.async_save": True})
    assert asy.async_save and not sync.async_save
    for step in (2, 4):
        name = f"epoch_0_step_{step}"
        assert ckpt.verify_checkpoint(str(tmp_path / "async" / name)) is None
        _same(str(tmp_path / "sync" / name), str(tmp_path / "async" / name))
    resumed = {}
    for name in ("sync", "async"):
        eng = _run(data, str(tmp_path / f"r_{name}"), **{
            "Engine.save_load.ckpt_dir":
                str(tmp_path / name / "epoch_0_step_2")})
        assert eng.step == 4 and len(eng.history) == 2
        resumed[name] = [h["loss"] for h in eng.history]
    assert resumed["sync"] == resumed["async"] == \
        [h["loss"] for h in sync.history[2:]]


def test_the_snapshot_is_the_state_of_its_step(tmp_path, monkeypatch):
    """The writer is held until the parameters and moments have been
    overwritten in place (what step k + 1's update does): the files
    hold the values at the save, and the next save waits for it."""
    gate = threading.Event()
    write = ckpt._write_step_dir

    def held(*args):
        assert gate.wait(30)
        write(*args)

    monkeypatch.setattr(ckpt, "_write_step_dir", held)
    model = {"w": torch.arange(6, dtype=torch.float32),
             "b": torch.ones(2)}
    opt = {"state": {0: {"exp_avg": torch.full((3,), 2.0), "step": 3}},
           "param_groups": [{"lr": 0.1, "params": [0]}]}
    want = {k: v.clone() for k, v in model.items()}
    path = ckpt.save_checkpoint(str(tmp_path), 0, 5, model, opt,
                                {"step": 5}, async_save=True)
    assert ckpt.verify_checkpoint(path) is not None   # not committed yet
    model["w"].mul_(-1.0)
    model["b"].zero_()
    opt["state"][0]["exp_avg"].fill_(7.0)
    gate.set()
    ckpt.wait_for_pending_save()
    assert ckpt.verify_checkpoint(path) is None
    got, got_opt, meta = ckpt.load_checkpoint(path, torch.device("cpu"))
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got_opt["state"][0]["exp_avg"], torch.full((3,), 2.0))
    assert got_opt["state"][0]["step"] == 3 and meta == {"step": 5}


def test_gc_keeps_k_newest_verified_as_jax_does(tmp_path):
    """GC keeps the 2 newest verified dirs, spares the uncommitted one,
    decommits before deleting, reports ``ckpt_gc``; the JAX
    ``gc_checkpoints`` on a copy of the same tree deletes the same
    dirs."""
    root = str(tmp_path / "port")
    p2 = _fake_step_dir(root, 1, 2)
    p4 = _fake_step_dir(root, 1, 4)
    p6 = _fake_step_dir(root, 1, 6)
    torn = _fake_step_dir(root, 1, 8, commit=False)
    shutil.copytree(root, str(tmp_path / "jax"))
    rec, jrec = Recorder(), Recorder()
    deleted = ckpt.gc_checkpoints(root, keep_last_k=2, recorder=rec)
    jdeleted = jax_ckpt.gc_checkpoints(str(tmp_path / "jax"), keep_last_k=2,
                                       recorder=jrec)
    assert deleted == [p2]
    assert [os.path.basename(p) for p in jdeleted] == ["epoch_1_step_2"]
    assert not os.path.exists(p2)
    assert os.path.isdir(p4) and os.path.isdir(p6) and os.path.isdir(torn)
    (ev,) = rec.of("ckpt_gc")
    (jev,) = jrec.of("ckpt_gc")
    assert ev["keep_last_k"] == jev["keep_last_k"] == 2
    assert ev["kept"] == [p6, p4]
    assert sorted(ev) == sorted(jev)


def test_gc_disabled_and_missing_dir(tmp_path):
    p2 = _fake_step_dir(str(tmp_path), 1, 2)
    assert ckpt.gc_checkpoints(str(tmp_path), keep_last_k=0) == []
    assert ckpt.gc_checkpoints(str(tmp_path), keep_last_k=-1) == []
    assert os.path.isdir(p2)
    assert ckpt.gc_checkpoints(str(tmp_path / "nope"), 1) == []


def test_resolve_skips_torn_dirs_as_jax_does(tmp_path):
    """The newest dir has no manifest: both packages resolve the older
    one and emit the same ``ckpt_fallback`` (stage ``resolve``); with
    nothing verified, ``to`` is None; an explicit step dir passes
    through."""
    rec, jrec = Recorder(), Recorder()
    old = _fake_step_dir(str(tmp_path), 1, 2)
    _fake_step_dir(str(tmp_path), 1, 4, commit=False)
    assert ckpt.latest_checkpoint(str(tmp_path), recorder=rec) == old
    assert jax_ckpt.latest_checkpoint(str(tmp_path), recorder=jrec) == old
    (ev,) = rec.of("ckpt_fallback")
    (jev,) = jrec.of("ckpt_fallback")
    assert ev == jev
    assert ev["stage"] == "resolve" and "manifest" in \
        ev["skipped"][0]["reason"]
    rec = Recorder()
    lone = tmp_path / "lone"
    torn = _fake_step_dir(str(lone), 1, 4, commit=False)
    assert ckpt.latest_checkpoint(str(lone), recorder=rec) is None
    assert rec.of("ckpt_fallback")[0]["to"] is None
    assert ckpt.latest_checkpoint(torn) == torn


def test_corrupt_newest_checkpoint_falls_back(tmp_path):
    """A committed step 4 whose meta file changes after the commit:
    a fresh engine resumes at step 2, and an explicit load of step 4
    with the fallback directory demotes with a ``ckpt_fallback``
    (stage ``load``); without it the load raises."""
    data = corpus(tmp_path / "data")
    out = str(tmp_path / "out")
    _run(data, out)
    newest = ckpt.latest_checkpoint(out)
    assert newest.endswith("step_4")
    with open(os.path.join(newest, "meta.json"), "a") as f:
        f.write(" ")
    _, engine, _ = port_engine(tiny_over(data, str(tmp_path / "o2"), **{
        "Engine.save_load.ckpt_dir": out, "Telemetry.enable": True}))
    assert engine.step == 2
    rec = Recorder()
    model, _opt, meta = ckpt.load_checkpoint(
        newest, torch.device("cpu"), fallback_dir=out, recorder=rec)
    assert meta["step"] == 2 and "gpt.final_norm.weight" in model
    (ev,) = rec.of("ckpt_fallback")
    assert ev["stage"] == "load" and ev["rejected"] == newest
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.load_checkpoint(newest, torch.device("cpu"))
    # the engine's resolve put its fallback on the flight record
    from paddlefleetx_tpu_torch.observability.recorder import read_events
    events = read_events(engine.recorder.path)
    assert [e["stage"] for e in events if e["event"] == "ckpt_fallback"] \
        == ["resolve"]


def test_a_writer_that_dies_leaves_a_torn_dir(tmp_path, monkeypatch):
    """The async writer of step 4 fails before its manifest: the wait
    raises, the dir stays uncommitted, and a resume takes step 2."""
    data = corpus(tmp_path / "data")
    out = str(tmp_path / "out")
    write = ckpt._write_step_dir

    def dies(path, model, opt, meta):
        if path.endswith("step_4"):
            ckpt._write(os.path.join(path, "model.pt"), model)
            raise OSError("disk went away")
        write(path, model, opt, meta)

    monkeypatch.setattr(ckpt, "_write_step_dir", dies)
    with pytest.raises(RuntimeError, match="async checkpoint save"):
        _run(data, out, **{"Engine.save_load.async_save": True})
    torn = os.path.join(out, "epoch_0_step_4")
    assert os.path.isdir(torn) and "manifest" in ckpt.verify_checkpoint(torn)
    monkeypatch.setattr(ckpt, "_write_step_dir", write)
    _, resumed, _ = port_engine(tiny_over(data, str(tmp_path / "r"), **{
        "Engine.save_load.ckpt_dir": out}))
    assert resumed.step == 2 and os.path.isdir(torn)


@pytest.mark.parametrize("async_save", [False, True])
def test_engine_keep_last_k(tmp_path, async_save):
    """``keep_last_k`` 1 through the engine's save path (a save every
    step): only the last step's directory stays, verified."""
    data = corpus(tmp_path / "data")
    out = str(tmp_path / "out")
    engine = _run(data, out, **{"Engine.max_steps": 3,
                                "Engine.save_load.save_steps": 1,
                                "Engine.save_load.keep_last_k": 1,
                                "Engine.save_load.async_save": async_save})
    assert engine.keep_last_k == 1
    steps = sorted(d for d in os.listdir(out) if ckpt._STEP_DIR.match(d))
    assert steps == ["epoch_0_step_3"]
    assert ckpt.verify_checkpoint(os.path.join(out, steps[0])) is None
    assert np.isfinite(engine.history[-1]["loss"])
