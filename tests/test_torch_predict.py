"""The port's ``Engine.predict``, ``Engine.test_iters``,
``Engine.print_summary`` and the ``pretreating_batch`` hook, on the CPU.

``predict`` over the pretraining recipe's evaluation split equals the
JAX ``Engine.predict`` on the same weights (the default ``predict_step``,
the eval-mode loss, within ``RTOL``; a module's own ``predict_step``
returning a dict of predictions, exactly), and stops after
``test_iters`` batches (default ``eval_iters * 10``; a value <= 0 walks
the loader); ``fit`` prints the run summary only when
``Engine.print_summary`` is true; every loop hands the host batch to
``pretreating_batch`` before the move to the device."""

import logging
import os

import jax
import numpy as np
import pytest
import torch

from _torch_parity import jax_counters, numpy_tree
from paddlefleetx_tpu.core import Engine as JaxEngine
from paddlefleetx_tpu.data import build_dataloader as jax_build_dataloader
from paddlefleetx_tpu.models import build_module as jax_build_module
from paddlefleetx_tpu.utils.config import get_config as jax_get_config
from paddlefleetx_tpu_torch.core.engine import Engine
from paddlefleetx_tpu_torch.data import build_dataloader
from paddlefleetx_tpu_torch.data.synthetic import write_corpus
from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
from paddlefleetx_tpu_torch.models.gpt.convert import (
    torch_state_dict_from_flax,
)
from paddlefleetx_tpu_torch.models.gpt.modules import GPTModule
from paddlefleetx_tpu_torch.observability import metrics
from paddlefleetx_tpu_torch.utils.config import get_config
from paddlefleetx_tpu_torch.utils.log import logger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "nlp", "gpt",
                      "pretrain_gpt_345M_single_card.yaml")
VOCAB = 128
#: fp32 losses: the same products summed in another order
RTOL = 1e-5


def _over(data_dir, out_dir, *extra, flash=False):
    """The 345M pretraining recipe cut to a tiny size, fp32, over the
    corpus in ``data_dir``."""
    over = ["Model.num_layers=2", "Model.hidden_size=128",
            "Model.num_attention_heads=2", "Model.ffn_hidden_size=256",
            f"Model.vocab_size={VOCAB}",
            "Model.max_position_embeddings=128",
            f"Model.use_flash_attention={flash}",
            "Engine.mix_precision.use_pure_fp16=False",
            "Engine.max_steps=4", "Engine.logging_freq=1",
            "Engine.eval_freq=100", "Engine.eval_iters=1",
            "Engine.save_load.save_steps=100",
            f"Engine.save_load.output_dir={out_dir}",
            "Global.local_batch_size=2", "Global.micro_batch_size=2",
            "Optimizer.lr.decay_steps=100", "Optimizer.lr.warmup_rate=0.01"]
    for mode in ("Train", "Eval"):
        over += [f"Data.{mode}.dataset.input_dir={data_dir}",
                 f"Data.{mode}.dataset.max_seq_len=128",
                 f"Data.{mode}.dataset.eos_id={VOCAB - 1}"]
    return over + list(extra)


@pytest.fixture
def dirs(tmp_path):
    """Two copies of one seeded corpus: the JAX and the port datasets
    each write their index files beside theirs."""
    for name in ("jdata", "data"):
        write_corpus(str(tmp_path / name), VOCAB, 40000, seed=3)
    return str(tmp_path / "jdata"), str(tmp_path / "data"), \
        str(tmp_path / "out")


def _jax(over):
    jcfg = jax_get_config(CONFIG, over, nranks=1)
    jmod = jax_build_module(jcfg)
    engine = JaxEngine(jcfg, jmod, mode="eval", devices=jax.devices()[:1])
    return jcfg, engine


def _port(over, params=None, mode="eval"):
    cfg = get_config(CONFIG, over)
    state = None if params is None else torch_state_dict_from_flax(
        params, GPTConfig.from_config(cfg))
    module = GPTModule(cfg, state_dict=state, device="cpu")
    return cfg, Engine(cfg, module, mode=mode, device="cpu")


def _logs(module):
    got = []
    orig = module.test_step_end
    module.test_step_end = lambda log: (got.append(log), orig(log))
    return got


def test_predict_equals_jax(dirs, monkeypatch):
    """Three batches (``test_iters`` 3) through the default
    ``predict_step``: each output the eval-mode loss, equal to the JAX
    engine's, each batch logged by ``test_step_end``; the JAX side
    traced its flash kernel (interpret mode) and the port's dispatch
    counted ``attention/flash``."""
    monkeypatch.setenv("PFX_PALLAS_INTERPRET", "1")
    jdata, data, out = dirs
    jcfg, jengine = _jax(_over(jdata, out, "Engine.test_iters=3",
                               flash=True))
    jlogs = _logs(jengine.module)
    with jax_counters() as reg:
        want = jengine.predict(1, jax_build_dataloader(jcfg.Data, "Eval"))
        assert reg.counter("attention/flash") > 0
    cfg, engine = _port(_over(data, out, "Engine.test_iters=3", flash=True),
                        numpy_tree(jengine.state["params"]))
    assert engine.test_iters == 3
    logs = _logs(engine.module)
    reg = metrics.get_registry()
    metrics.set_enabled(True)
    reg.reset()
    try:
        got = engine.predict(1, build_dataloader(cfg.Data, "Eval"))
        assert reg.counter("attention/flash") > 0
    finally:
        reg.reset()
        metrics.set_enabled(False)
    assert len(got) == len(want) == len(logs) == len(jlogs) == 3
    for a, b in zip(got, want):
        assert isinstance(a, np.ndarray) and a.shape == ()
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL)
    assert [g["batch"] for g in logs] == [0, 1, 2]
    np.testing.assert_allclose([g["loss"] for g in logs],
                               [g["loss"] for g in jlogs], rtol=RTOL)
    assert engine.model.training            # predict leaves train mode


def test_predict_honours_a_module_override(dirs):
    """A module's own ``predict_step`` (a dict with a zero loss and the
    argmax tokens) is what ``predict`` calls and returns, as JAX's."""
    jdata, data, out = dirs
    jcfg, jengine = _jax(_over(jdata, out, "Engine.test_iters=1"))

    def jax_argmax(params, batch, rng):
        import jax.numpy as jnp
        logits = jengine.module.model.apply({"params": params}, batch[0])
        return {"loss": jnp.zeros(()), "pred": jnp.argmax(logits, -1)}
    jengine.module.predict_step = jax_argmax
    jengine._build_steps()
    want = jengine.predict(1, jax_build_dataloader(jcfg.Data, "Eval"))
    cfg, engine = _port(_over(data, out, "Engine.test_iters=1"),
                        numpy_tree(jengine.state["params"]))

    def argmax(model, batch, seed):
        return {"loss": torch.zeros(()),
                "pred": model(batch[0], batch[1]).argmax(-1)}
    engine.module.predict_step = argmax
    logs = _logs(engine.module)
    got = engine.predict(1, build_dataloader(cfg.Data, "Eval"))
    assert len(got) == len(want) == 1
    assert got[0]["pred"].shape == (2, 128)
    np.testing.assert_array_equal(got[0]["pred"], np.asarray(
        want[0]["pred"]))
    assert logs[0]["loss"] == 0.0


@pytest.mark.parametrize("knob,batches", [
    ("Engine.test_iters=2", 2), ("Engine.test_iters=-1", None),
    ("Engine.test_iters=0", None), (None, 10)])
def test_test_iters_caps_predict(dirs, knob, batches):
    """``test_iters`` caps the walk; <= 0 walks the whole loader (None);
    unset it is ``eval_iters * 10`` (10)."""
    _, data, out = dirs
    over = _over(data, out, "Data.Eval.dataset.num_samples=28")
    cfg, engine = _port(over + ([knob] if knob else []))
    loader = build_dataloader(cfg.Data, "Eval")
    assert len(loader) > 10
    logs = _logs(engine.module)
    assert len(engine.predict(1, loader)) == len(logs) == \
        (batches or len(loader))


def _fit_lines(over, registry_on=False):
    """The log lines of a 4-step ``fit`` and the engine."""
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())
    handler = Keep()
    logger.addHandler(handler)
    metrics.set_enabled(registry_on)
    try:
        cfg, engine = _port(over, mode="train")
        loader = build_dataloader(cfg.Data, "Train")
        loader.batch_sampler.batch_size = cfg.Global.global_batch_size
        engine.fit(epoch=1, train_data_loader=loader,
                   valid_data_loader=build_dataloader(cfg.Data, "Eval"))
    finally:
        logger.removeHandler(handler)
        metrics.get_registry().reset()
        metrics.set_enabled(False)
    return lines, engine


@pytest.mark.parametrize("knob,printed", [
    ("Engine.print_summary=True", True), ("Engine.print_summary=False",
                                          False), (None, False)])
def test_print_summary(dirs, knob, printed):
    """``Engine.print_summary`` true ends ``fit`` with the summary: the
    step-time windows, tokens/s, model FLOPs and MFU, goodput with its
    eval and save buckets and the dispatch counters; false or unset,
    nothing. The summary is computed either way."""
    _, data, out = dirs
    over = _over(data, out, "Engine.eval_freq=2",
                 "Engine.save_load.save_steps=3")
    lines, engine = _fit_lines(over + ([knob] if knob else []),
                               registry_on=True)
    summary = [x for x in lines if x.startswith("  ") or "Run summary" in x]
    assert engine.print_summary is printed
    stats = engine.summary
    # windows 1 and 2 are clean; an eval ends 2 and a save 3, so 3 and 4
    # are not samples
    assert len(stats["windows"]) == 2
    assert stats["tokens_per_sec"] == pytest.approx(
        2 * 128 / stats["steady_mean_s_per_step"])
    assert 0 < stats["mfu"] < 1 and stats["bucket_eval_s"] > 0 and \
        stats["bucket_save_s"] > 0 and 0 < stats["goodput_pct"] < 100
    assert stats["dispatch_counters"]["attention/dense"] > 0
    if not printed:
        assert summary == []
        return
    text = "\n".join(summary)
    for part in ("Run summary (host step times, 2 windows of 1 steps)",
                 "steady state:", "throughput:", "model FLOPs:", "MFU",
                 "goodput:", "eval", "save", "dispatch counters:",
                 "h2d input wait:", "HBM watermark: unavailable"):
        assert part in text, part
    for absent in ("mp collective", "compile"):
        assert absent not in text, absent


def test_every_loop_pretreats_the_host_batch(dirs):
    """``fit``, ``evaluate`` and ``predict`` each hand every host batch
    (numpy) to ``pretreating_batch`` before the move to the device, and
    use what it returns."""
    _, data, out = dirs
    cfg, engine = _port(_over(data, out, "Engine.test_iters=2",
                              "Engine.max_steps=2"), mode="train")
    seen = []

    def pretreat(batch):
        seen.append(type(batch[0]))
        return tuple(np.zeros_like(x) if i == 3 else x
                     for i, x in enumerate(batch))
    engine.module.pretreating_batch = pretreat
    out = engine.predict(1, build_dataloader(cfg.Data, "Eval"))
    # the loss mask zeroed by the hook: no token counts
    assert all(float(o) == 0.0 for o in out)
    engine.evaluate(1, build_dataloader(cfg.Data, "Eval"), max_iters=3)
    loader = build_dataloader(cfg.Data, "Train")
    engine.fit(epoch=1, train_data_loader=loader)
    # each loop stages prefetch_depth (2) batches ahead of the one it
    # hands out and pretreats each staged batch once: predict hands out
    # 3 (the third breaks at test_iters 2) and staged 2 more, evaluate
    # 4 and 2, fit 3 and 2
    assert engine.prefetch_depth == 2
    assert seen == [np.ndarray] * 16
    assert [h["loss"] for h in engine.history] == [0.0, 0.0]
