"""The auto schema on the port, held to the JAX engine on the CPU: a
tiny ``auto`` run at head_dim 128 under full recompute equals the JAX
engine's three steps and parameters from the same weights, also at
``mix_precision.level: o3`` (a bf16 first moment); the ``auto`` entry
point runs the auto recipe; ``train`` takes a step of the 1.3B recipe
cut to size."""

import jax
import numpy as np
import pytest
import torch

from _torch_engine_cfg import (
    AUTO_CONFIG, ROOT, corpus, jax_engine, jax_params_as_port_state,
    port_engine, tiny_over,
)
from _torch_parity import numpy_tree, one_thread
from paddlefleetx_tpu_torch import cli
from paddlefleetx_tpu_torch.models.gpt.convert import (
    flax_from_torch_state_dict,
)
from paddlefleetx_tpu_torch.models.gpt.modules import GPTModuleAuto
from paddlefleetx_tpu_torch.optims.optimizer import AdamWBf16Moment

#: the auto recipe cut to hidden 256 with 2 heads: head_dim 128, as in
#: the 1.3B recipes; full recompute (the auto recipe's granularity is
#: unset), no dropout. The peak rate is 1e-3: at the tiny recipe's 1e-2
#: Adam moves these 0.02-std weights by half their size a step, and the
#: third step's loss then moves by 2e-5 relative with the CPU's thread
#: count, in the JAX package against itself as in the port
HD128 = {"Model.hidden_size": 256, "Model.num_attention_heads": 2,
         "Model.ffn_hidden_size": 512, "Model.use_recompute": True,
         "Optimizer.lr.max_lr": 1e-3, "Optimizer.lr.min_lr": 1e-4}


def _parity(tmp_path, extra, atol):
    data = corpus(tmp_path / "data")
    over = tiny_over(data, str(tmp_path / "out"), **HD128, **extra)
    jcfg, jengine, jloader = jax_engine(over, AUTO_CONFIG)
    assert jcfg.Model.module == "GPTModuleAuto"
    state = jax_params_as_port_state(jengine, over, AUTO_CONFIG)
    jlosses = []
    orig = jengine.module.training_step_end
    jengine.module.training_step_end = lambda log: (
        jlosses.append(log["loss"]), orig(log))
    jengine.fit(epoch=1, train_data_loader=jloader)

    cfg, engine, loader = port_engine(over, state, AUTO_CONFIG,
                                      GPTModuleAuto)
    mcfg = engine.module.model_config
    assert mcfg.hidden_size // mcfg.num_attention_heads == 128
    assert mcfg.use_recompute and mcfg.recompute_granularity == "full"
    with one_thread():
        engine.fit(epoch=1, train_data_loader=loader)
    losses = [h["loss"] for h in engine.history]
    assert len(losses) == len(jlosses) == 3
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    got = flax_from_torch_state_dict(engine.model.state_dict(), mcfg)
    want = dict(jax.tree_util.tree_leaves_with_path(
        numpy_tree(jengine.state["params"])))
    for path, leaf in jax.tree_util.tree_leaves_with_path(got):
        name = jax.tree_util.keystr(path)
        ref = want[path]
        if name.endswith("['qkv_proj']['bias']"):
            # the key bias's true gradient is 0 (the softmax cancels it):
            # both sides hold rounding noise, as in test_torch_engine.py
            np.testing.assert_allclose(leaf[1], ref[1], atol=1e-4,
                                       err_msg=name)
            leaf, ref = leaf[0::2], ref[0::2]
        np.testing.assert_allclose(leaf, ref, atol=atol, err_msg=name)
    return engine, jengine


def test_auto_head_dim_128_full_recompute_matches_the_jax_engine(tmp_path):
    """Three steps of the auto recipe at head_dim 128 with full
    recompute: losses at rtol 1e-5 and every parameter at atol 1e-5
    against the JAX engine (the tolerances of
    ``test_torch_engine.py``)."""
    engine, _ = _parity(tmp_path, {}, atol=1e-5)
    assert type(engine.optimizer.opt) is torch.optim.AdamW


def test_level_o3_bf16_first_moment_matches_the_jax_engine(tmp_path):
    """``level: o3`` stores AdamW's first moment in bf16 on both sides
    (optax ``mu_dtype`` there); compute stays fp32 here so only the
    moment's rounding differs from o2. Losses at rtol 1e-5; parameters
    at atol 2e-5: a gradient that differs in its last fp32 bits can round
    the bf16 moment the other way (one bf16 ulp, 2^-8 relative), which
    moves that weight by up to lr * 2^-8 * |m_hat| / sqrt(v_hat) a step,
    about 1e-5 at lr 1e-3 (one weight of 262,144 read 1.01e-5 here); the
    stored moments are bf16 and equal JAX's to one bf16 rounding (their
    sums at rtol 2^-7)."""
    engine, jengine = _parity(tmp_path, {
        "Engine.mix_precision.level": "o3",
        "Engine.mix_precision.use_pure_fp16": False}, atol=2e-5)
    opt = engine.optimizer.opt
    assert isinstance(opt, AdamWBf16Moment)
    assert engine.configs.Optimizer.state_dtype == "bfloat16"
    mus = [opt.state[p]["exp_avg"] for p in engine.optimizer.params]
    assert all(m.dtype == torch.bfloat16 for m in mus)
    assert all(opt.state[p]["exp_avg_sq"].dtype == torch.float32
               for p in engine.optimizer.params)
    jmu = [leaf for leaf in jax.tree_util.tree_leaves(
        jengine.state["opt_state"]) if getattr(leaf, "dtype", None) ==
        jax.numpy.bfloat16]
    assert jmu   # the JAX tree stacks its layers: compare the sums
    total = sum(float(np.abs(np.asarray(m, np.float32)).sum())
                for m in jmu)
    mine = sum(float(m.float().abs().sum()) for m in mus)
    np.testing.assert_allclose(mine, total, rtol=2 ** -7)


def test_auto_entry_point_runs_the_auto_recipe(tmp_path):
    """``python -m paddlefleetx_tpu_torch.cli auto -c <auto 345M recipe>
    --device cpu`` with tiny overrides trains, as ``train`` does."""
    data = corpus(tmp_path / "data")
    argv = ["auto", "-c", AUTO_CONFIG, "--device", "cpu"]
    for o in tiny_over(data, str(tmp_path / "out"),
                       **{"Engine.max_steps": 2}):
        argv += ["-o", o]
    assert cli.main(argv) == 0
    engine = cli.auto_main(argv[1:])
    assert isinstance(engine.module, GPTModuleAuto)
    assert engine.step == 2 and all(np.isfinite(
        [h["loss"] for h in engine.history]))
    # the auto schema's section-level collate_fn and sample_split parse
    assert engine.configs.Data.Train.collate_fn == "gpt_collate_fn"
    assert engine.configs.Data.Train.sample_split == 2


def test_train_takes_a_step_of_the_1p3b_recipe_cut_to_size(tmp_path):
    """``train`` on ``pretrain_gpt_1.3B_single_card.yaml`` (the non-auto
    recipe) at 2 layers and hidden 256, head_dim 128 kept: it parses,
    builds with full recompute and dropout 0.1 and takes a step."""
    data = corpus(tmp_path / "data")
    config = f"{ROOT}/configs/nlp/gpt/pretrain_gpt_1.3B_single_card.yaml"
    argv = ["-c", config, "--device", "cpu"]
    over = {"Model.num_layers": 2, "Model.hidden_size": 256,
            "Model.num_attention_heads": 2, "Model.vocab_size": 128,
            "Model.max_position_embeddings": 64, "Engine.max_steps": 1,
            "Engine.eval_freq": 100, "Global.local_batch_size": 2,
            "Global.micro_batch_size": 2,
            "Engine.save_load.output_dir": str(tmp_path / "out")}
    for mode in ("Train", "Eval"):
        over[f"Data.{mode}.dataset.input_dir"] = data
        over[f"Data.{mode}.dataset.max_seq_len"] = 32
        over[f"Data.{mode}.dataset.eos_id"] = 127
    for k, v in over.items():
        argv += ["-o", f"{k}={v}"]
    with one_thread():
        engine = cli.train_main(argv)
    mcfg = engine.module.model_config
    assert mcfg.recompute_granularity == "full" and mcfg.use_recompute
    assert mcfg.hidden_dropout_prob == 0.1 and mcfg.dtype == "bfloat16"
    assert engine.step == 1 and np.isfinite(engine.history[0]["loss"])


@pytest.mark.parametrize("dtype", ["float16", "int8"])
def test_other_reduced_state_dtypes_stay_refused(tmp_path, dtype):
    """Only fp32 and bf16 moments are ported."""
    data = corpus(tmp_path / "data")
    with pytest.raises(NotImplementedError, match="state_dtype"):
        port_engine(tiny_over(data, str(tmp_path / "out"), **{
            "Optimizer.state_dtype": dtype}))


def test_bf16_first_moment_step_matches_optax_mu_dtype():
    """:class:`AdamWBf16Moment` against ``optax.adamw(mu_dtype=
    bfloat16)`` over five steps on one seeded leaf: parameters within
    1e-7 and the stored bf16 moments equal (optax rounds ``b1`` to bf16
    in ``b1 mu``; so does the port)."""
    import jax.numpy as jnp
    import optax
    rng = np.random.default_rng(0)
    p0 = (rng.standard_normal(4096) * 0.02).astype(np.float32)
    tx = optax.adamw(1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
                     mu_dtype=jnp.bfloat16)
    p = jnp.asarray(p0)
    st = tx.init(p)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = AdamWBf16Moment([tp], lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                          weight_decay=0.01)
    for _ in range(5):
        g = rng.standard_normal(4096).astype(np.float32)
        upd, st = tx.update(jnp.asarray(g), st, p)
        p = optax.apply_updates(p, upd)
        tp.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(p), atol=1e-7)
    np.testing.assert_array_equal(
        opt.state[tp]["exp_avg"].float().numpy(),
        np.asarray(st[0].mu, np.float32))
