"""``chip_smoke.py``'s training path on the CPU at a tiny size: the
recipe's steps through the ``train`` CLI, the fp32 parity of the kernel
path against the dense path, save / resume, the async save against its
synchronous twin, the SIGTERM save and resume, the epoch run mode, and
the 1.3B auto recipe on a 2-layer stand-in (counting shims stand in for
the launch counts)."""

from _chip_smoke_shims import (TRAIN_TINY, _lines, chip_smoke,
                               shims)  # noqa: F401
from _torch_parity import one_thread


def test_training_phases_run_at_tiny_size(shims, capsys):
    """The recipe's training path as the chip run drives it (bf16,
    dropout, save_dots, chunked loss), cut to a tiny size: the loss
    falls, every step launches kernels 1, 3 and 4 once per layer, the
    fp32 kernel path equals the dense path, and the entry point saves
    and resumes."""
    record, engine = chip_smoke.phase_train("cpu", TRAIN_TINY, steps=30)
    assert record["launches_per_step"] == {
        "flash_attention": 2, "flash_bwd_dkv": 2, "flash_bwd_dq": 2}
    assert record["recompute"] == "save_dots" and record["loss_chunks"] == 8
    assert record["mean_last5"] < record["mean_first5"]
    assert engine.module.model_config.dtype == "bfloat16"
    chip_smoke.phase_train_parity("cpu", TRAIN_TINY)
    with one_thread():
        chip_smoke.phase_train_cli("cpu", TRAIN_TINY)
    lines = {d.get("phase"): d for d in _lines(capsys)}
    for phase in ("train", "train_parity", "train_cli"):
        assert phase in lines
    parity = lines["train_parity"]
    assert parity["worst_leaf_rel_diff"] <= parity["tol"]["grad_leaf_rel"] \
        < parity["planted_dq_worst_leaf_rel_diff"]
    assert lines["train_cli"]["bit_exact"]   # the CPU sums in one order
    cli = lines["train_cli"]
    assert cli["async"]["kept"] == ["epoch_0_step_4", "epoch_0_step_6"]
    assert cli["async"]["twin_equal"] and cli["async"]["async_equal_tensors"]
    assert cli["async"]["resume_from_async"]["bit_exact"]
    assert cli["async"]["resume_from_preemption"]["bit_exact"]
    assert cli["preemption"] == {"sigterm_at": 3, "stopped_at": 3,
                                 "saved": ["epoch_0_step_3"]}
    assert cli["epoch_mode"] == {"steps": 2, "evals": 1}


#: the 1.3B auto recipe cut to a 2-layer stand-in at head_dim 128
#: (hidden 256, 2 heads), batch 2 x 64
AUTO_TINY = ["Model.num_layers=2", "Model.hidden_size=256",
             "Model.num_attention_heads=2", "Model.vocab_size=300",
             "Model.max_position_embeddings=64",
             "Data.Train.dataset.max_seq_len=64",
             "Data.Eval.dataset.max_seq_len=64",
             "Global.global_batch_size=2", "Global.local_batch_size=2",
             "Global.micro_batch_size=2"]


def test_train_auto_1p3b_phase_at_tiny_size(shims, capsys):
    """``train_auto_1p3b`` as the chip run drives it (the auto entry
    point, full recompute, dropout, telemetry, a one-step profiler
    window, prefetch 2) on a 2-layer head_dim-128 stand-in: kernel 1
    twice a layer and step plus once a layer and eval batch, kernels 3
    and 4 once a layer and step, the JAX engine's events in its order,
    the chrome trace written, no checkpoint."""
    with one_thread():
        record = chip_smoke.phase_train_auto_1p3b("cpu", AUTO_TINY)
    assert record["module"] == "GPTModuleAuto"
    assert record["head_dim"] == 128 and record["recompute"] == "full"
    assert record["dropout"] == [0.1, 0.1] and record["dtype"] == "bfloat16"
    assert record["launches"] == {"flash_attention": 2 * 8 * 2 + 2 * 2,
                                  "flash_bwd_dkv": 16, "flash_bwd_dq": 16}
    assert record["prefetch_depth"] == 2
    assert record["peak_bytes_in_use"] is None   # the CPU keeps no stats
    lines = {d.get("phase"): d for d in _lines(capsys)}
    assert lines["train_auto_1p3b"]["event_names_match_jax"]


def test_expected_events_follow_the_jax_cadence():
    """The event list ``train_auto_1p3b`` holds ``events.jsonl`` to."""
    assert chip_smoke.expected_events(4, 2) == [
        "fit_start", "step_window", "step_window", "eval_start",
        "eval_end", "step_window", "step_window", "eval_start",
        "eval_end", "fit_end"]


def test_kernels_line_carries_the_1p3b_rows():
    """With the 1.3B cases and ``train_auto_1p3b``'s record, kernels 1, 3
    and 4 carry their head_dim-128 case and that path's launches, added
    to their totals, and keep every key the line needs."""
    case = {"dtype": "bfloat16", "tol": 2e-2, "max_abs_err": 1e-3,
            "ms": 0.1, "call_ms": 0.2, "plain_ms": 1.0, "library_ms": 0.05,
            "bound_ms": 0.01, "bound_by": "bytes", "b": 1, "h": 16,
            "s": 512, "d": 64, "bias": False, "rel_l2": 3e-3,
            "rel_l2_planted": 0.1, "S": 1024}
    fwd = dict(case, b=8, s=1024, d=128, dropout=0.1, route="wgmma",
               block_n=128, mma_ms=0.3, max_abs_err=2e-2)
    bwd = {"regime": "combined", "dtype": "bfloat16", "b": 8, "h": 16,
           "s": 1024, "d": 64, "bias": False, "dropout": 0.1,
           "max_abs_err": {"dq": 0.01, "dk": 0.02, "dv": 0.03},
           "grad_scale": 6.0, "tol": 1e-2, "tol_kind": "relative",
           "plain_ms": 9.0, "library_ms": 1.0, "ms_dkv": 2.0,
           "call_ms_dkv": 2.1, "ms_dq": 1.5, "call_ms_dq": 1.6,
           "bound_ms_dkv": 0.4, "bound_by_dkv": "operations",
           "bound_ms_dq": 0.3, "bound_by_dq": "operations",
           "bound_ms_both": 0.5, "bound_by_both": "operations",
           "rel_l2": {"dq": 4e-3, "dk": 5e-3, "dv": 3e-3},
           "rel_l2_planted": {"dq": 0.2, "dk": 0.1, "dv": 0.3}}
    bwd128 = dict(bwd, regime="1p3b", d=128, ms_dkv=4.0, ms_dq=3.0,
                  max_abs_err={"dq": 0.05, "dk": 0.02, "dv": 0.03})
    serve = {"launches": {"flash_attention": 10, "flash_decode": 12}}
    train = {"launches": {"flash_attention": 4, "flash_bwd_dkv": 4,
                          "flash_bwd_dq": 4}}
    auto = {"launches": {"flash_attention": 432, "flash_bwd_dkv": 192,
                         "flash_bwd_dq": 192},
            "launches_by_route": {"flash_attention": {"wgmma": 432}}}
    line = chip_smoke.kernels_line([case], [case], serve, [], [bwd], train,
                                   run_1p3b=(fwd, bwd128, auto))
    rows = {k["name"]: k for k in line["kernels"]}
    for name, n in (("flash_attention", 432), ("flash_bwd_dkv", 192),
                    ("flash_bwd_dq", 192)):
        row = rows[name]
        assert row["launches_by_path"]["train_auto_1p3b"] == n
        assert row["launches"] == sum(row["launches_by_path"].values())
        assert row["shape_1p3b"]["d"] == 128
        assert {"ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by"} <= set(row["shape_1p3b"])
    assert rows["flash_bwd_dq"]["shape_1p3b"]["ms"] == 3.0
    assert rows["flash_bwd_dq"]["max_abs_err"] == 0.05
    assert rows["flash_attention"]["launches_by_route"]["wgmma"] == 432
