"""``chip_smoke.py``'s training path on the CPU at a tiny size: the
recipe's steps through the ``train`` CLI, the fp32 parity of the kernel
path against the dense path, and save / resume (counting shims stand in
for the launch counts)."""

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
