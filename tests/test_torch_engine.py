"""The port's ``Engine`` on the CPU: three steps with gradient
accumulation equal the JAX ``Engine``'s from the same weights, training
with dropout lowers the loss, a resumed run equals an uninterrupted one
bit for bit, a torn checkpoint is skipped, the ``[train]`` line keeps
its grammar, and the knobs the port does not have raise."""

import logging
import os
import re

import jax
import numpy as np
import pytest
import torch

from _torch_parity import numpy_tree, one_thread
from paddlefleetx_tpu.core import Engine as JaxEngine
from paddlefleetx_tpu.data import build_dataloader as jax_build_dataloader
from paddlefleetx_tpu.models import build_module as jax_build_module
from paddlefleetx_tpu.utils.config import get_config as jax_get_config
from paddlefleetx_tpu_torch.core import checkpoint as ckpt
from paddlefleetx_tpu_torch.core.engine import Engine
from paddlefleetx_tpu_torch.data import build_dataloader
from paddlefleetx_tpu_torch.data.synthetic import write_corpus
from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
from paddlefleetx_tpu_torch.models.gpt.convert import (
    flax_from_torch_state_dict, torch_state_dict_from_flax,
)
from paddlefleetx_tpu_torch.models.gpt.modules import GPTModule
from paddlefleetx_tpu_torch.utils.config import get_config
from paddlefleetx_tpu_torch.utils.log import TRAIN_LINE_RE, logger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "nlp", "gpt",
                      "pretrain_gpt_345M_single_card.yaml")
VOCAB = 128


def _over(data_dir, out_dir, **extra):
    over = {
        "Model.num_layers": 2, "Model.hidden_size": 32,
        "Model.num_attention_heads": 4, "Model.ffn_hidden_size": 64,
        "Model.vocab_size": VOCAB, "Model.max_position_embeddings": 64,
        "Model.hidden_dropout_prob": 0.0,
        "Model.attention_probs_dropout_prob": 0.0,
        "Model.use_recompute": False, "Model.loss_chunks": 1,
        "Model.use_flash_attention": False,
        "Engine.mix_precision.use_pure_fp16": False,
        "Engine.max_steps": 3, "Engine.logging_freq": 1,
        "Engine.eval_freq": 100, "Engine.eval_iters": 1,
        "Engine.save_load.save_steps": 100,
        "Engine.save_load.output_dir": out_dir,
        "Global.local_batch_size": 4, "Global.micro_batch_size": 2,
        "Optimizer.lr.decay_steps": 100, "Optimizer.lr.warmup_rate": 0.01,
        "Optimizer.lr.max_lr": 0.01, "Optimizer.lr.min_lr": 0.001,
    }
    for mode in ("Train", "Eval"):
        over[f"Data.{mode}.dataset.input_dir"] = data_dir
        over[f"Data.{mode}.dataset.max_seq_len"] = 32
        over[f"Data.{mode}.dataset.eos_id"] = VOCAB - 1
    over.update(extra)
    return [f"{k}={v}" for k, v in over.items()]


@pytest.fixture
def corpus(tmp_path):
    data = tmp_path / "data"
    write_corpus(str(data), VOCAB, 30000, seed=1)
    return str(data)


def _port(over, state_dict=None):
    cfg = get_config(CONFIG, over)
    module = GPTModule(cfg, state_dict=state_dict, device="cpu")
    engine = Engine(cfg, module, device="cpu")
    loader = build_dataloader(cfg.Data, "Train")
    loader.batch_sampler.batch_size = cfg.Global.global_batch_size
    return cfg, engine, loader


def test_three_accumulated_steps_match_the_jax_engine(tmp_path, corpus):
    jcfg = jax_get_config(CONFIG, _over(str(tmp_path / "jdata"),
                                        str(tmp_path / "jout")), nranks=1)
    write_corpus(str(tmp_path / "jdata"), VOCAB, 30000, seed=1)
    jmodule = jax_build_module(jcfg)
    jengine = JaxEngine(jcfg, jmodule, mode="train",
                        devices=jax.devices()[:1])
    assert jengine.accumulate_steps == 2
    jloader = jax_build_dataloader(jcfg.Data, "Train")
    jloader.batch_sampler.batch_size = jcfg.Global.global_batch_size
    init = numpy_tree(jengine.state["params"])
    jlosses = []
    orig = jmodule.training_step_end
    jmodule.training_step_end = lambda log: (jlosses.append(log["loss"]),
                                             orig(log))
    jengine.fit(epoch=1, train_data_loader=jloader)

    over = _over(corpus, str(tmp_path / "out"))
    state = torch_state_dict_from_flax(
        init, GPTConfig.from_config(get_config(CONFIG, over)))
    cfg, engine, loader = _port(over, state)
    assert engine.accumulate_steps == 2
    engine.fit(epoch=1, train_data_loader=loader)
    losses = [h["loss"] for h in engine.history]
    assert len(losses) == len(jlosses) == 3
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    got = flax_from_torch_state_dict(engine.model.state_dict(),
                                     engine.module.model_config)
    want = dict(jax.tree_util.tree_leaves_with_path(
        numpy_tree(jengine.state["params"])))
    for path, leaf in jax.tree_util.tree_leaves_with_path(got):
        name = jax.tree_util.keystr(path)
        ref = want[path]
        if name.endswith("['qkv_proj']['bias']"):
            # the key bias adds q.b to every score of a row, which the
            # softmax cancels: its true gradient is 0 and both sides
            # hold rounding noise, which Adam's normalisation scales up
            # to a few lr * 1e-3; the q and v biases are held as usual
            np.testing.assert_allclose(leaf[1], ref[1], atol=1e-4,
                                       err_msg=name)
            leaf, ref = leaf[0::2], ref[0::2]
        np.testing.assert_allclose(leaf, ref, atol=1e-5, err_msg=name)


def test_training_with_dropout_lowers_the_loss(tmp_path, corpus):
    over = _over(corpus, str(tmp_path / "out"), **{
        "Engine.max_steps": 20, "Model.hidden_dropout_prob": 0.1,
        "Model.attention_probs_dropout_prob": 0.1,
        "Model.use_flash_attention": True, "Model.use_recompute": True,
        "Model.recompute_granularity": "save_dots", "Model.loss_chunks": 2,
        "Global.micro_batch_size": 4})
    _, engine, loader = _port(over)
    engine.fit(epoch=1, train_data_loader=loader)
    losses = [h["loss"] for h in engine.history]
    assert len(losses) == 20 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1


def test_resume_is_bit_exact(tmp_path, corpus):
    with one_thread():
        _resume_is_bit_exact(tmp_path, corpus)


def _resume_is_bit_exact(tmp_path, corpus):
    extra = {"Engine.max_steps": 4, "Model.hidden_dropout_prob": 0.1,
             "Model.attention_probs_dropout_prob": 0.1,
             "Model.use_flash_attention": True}
    _, full, loader = _port(_over(corpus, str(tmp_path / "a"), **extra))
    full.fit(epoch=1, train_data_loader=loader)

    first_over = _over(corpus, str(tmp_path / "b"), **extra,
                       **{"Engine.save_load.save_steps": 2})
    _, first, loader = _port(first_over)
    first.fit(epoch=1, train_data_loader=loader)
    step2 = str(tmp_path / "b" / "epoch_0_step_2")
    assert ckpt.verify_checkpoint(step2) is None
    _, resumed, loader = _port(_over(
        corpus, str(tmp_path / "c"), **extra,
        **{"Engine.save_load.ckpt_dir": step2}))
    assert resumed.step == 2
    resumed.fit(epoch=1, train_data_loader=loader)
    assert resumed.step == 4
    assert [h["loss"] for h in resumed.history] == \
        [h["loss"] for h in full.history[2:]]
    for (name, a), b in zip(full.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_torn_checkpoint_is_skipped(tmp_path):
    good = ckpt.save_checkpoint(str(tmp_path), 0, 2,
                                {"w": torch.ones(3)}, None,
                                {"epoch": 0, "step": 2})
    torn = tmp_path / "epoch_0_step_4"
    torn.mkdir()
    torch.save({"w": torch.zeros(3)}, torn / "model.pt")
    assert "manifest" in ckpt.verify_checkpoint(str(torn))
    assert ckpt.latest_checkpoint(str(tmp_path)) == good
    with open(os.path.join(good, "meta.json"), "a") as f:
        f.write(" ")
    assert ckpt.verify_checkpoint(good) is not None
    assert ckpt.latest_checkpoint(str(tmp_path)) is None
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.load_checkpoint(good, torch.device("cpu"))


def test_train_line_grammar(tmp_path, corpus):
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())
    handler = Keep()
    logger.addHandler(handler)
    try:
        _, engine, loader = _port(_over(corpus, str(tmp_path / "out"), **{
            "Engine.max_steps": 2, "Engine.eval_freq": 2}))
        eval_loader = build_dataloader(engine.configs.Data, "Eval")
        engine.fit(epoch=1, train_data_loader=loader,
                   valid_data_loader=eval_loader)
    finally:
        logger.removeHandler(handler)
    train = [x for x in lines if x.startswith("[train]")]
    assert len(train) == 2
    for line in train:
        assert re.fullmatch(TRAIN_LINE_RE, line), line
    assert any(x.startswith("[eval]") for x in lines)


@pytest.mark.parametrize("knob,nranks", [
    ("Distributed.sharding.sharding_offload=True", 1),
    ("Distributed.ep_degree=2", 1), ("Distributed.mp_degree=2", 2),
    ("Distributed.sharding.sharding_degree=2", 2),
    ("Distributed.cp_degree=2", 2)])
def test_unported_knobs_raise(tmp_path, corpus, knob, nranks):
    """The multi-GPU degrees and optimizer offload still raise, naming
    the knob (the profiler, telemetry, async and preemption saves,
    retention and the epoch run mode are ported: ``test_torch_
    {telemetry,checkpoint_async,preemption}.py``)."""
    cfg = get_config(CONFIG, _over(corpus, str(tmp_path / "out")) + [knob],
                     nranks=nranks)
    name = knob.split("=")[0]
    with pytest.raises(NotImplementedError, match=name.split(".")[-1]):
        Engine(cfg, GPTModule(cfg, device="cpu"), device="cpu")


def test_multi_device_and_cuda_requests_raise(tmp_path, corpus):
    cfg = get_config(CONFIG, _over(corpus, str(tmp_path / "o")), nranks=2)
    assert cfg.Distributed.dp_degree == 2
    module = GPTModule(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="dp_degree"):
        Engine(cfg, module, device="cpu")
    with pytest.raises(NotImplementedError, match="pipeline"):
        GPTModule(get_config(CONFIG, _over(corpus, str(tmp_path / "o")) +
                             ["Distributed.pp_degree=2"], nranks=2),
                  device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(get_config(CONFIG, _over(corpus, str(tmp_path / "o"))),
               module)
