"""``chip_smoke.py``'s MoE path on the CPU at a tiny size: kernels 8
and 9 against their plain versions, the 8x345M recipe's training path,
``sort_pallas`` against ``sort``, and the kernels line's rows (counting
shims stand in for the launch counts)."""

import torch

from _chip_smoke_shims import (KERNEL_KEYS, _lines, chip_smoke,
                               shims)  # noqa: F401
from paddlefleetx_tpu_torch.ops.cuda import grouped_matmul as gmm


#: the 8x345M MoE recipe cut to a tiny size (hidden 64, 4 experts)
MOE_TINY = ["Model.num_layers=2", "Model.hidden_size=64",
            "Model.num_attention_heads=1", "Model.ffn_hidden_size=128",
            "Model.vocab_size=300", "Model.max_position_embeddings=64",
            "Model.moe_num_experts=4", "Data.Train.dataset.max_seq_len=64",
            "Data.Eval.dataset.max_seq_len=64", "Global.local_batch_size=4",
            "Global.micro_batch_size=2"]
#: the six expert-GEMM calls at a tiny size (K, N multiples of the
#: 64-wide tiles the normwise check reads)
GMM_TINY = (("fc1", 64, 128), ("fc2", 128, 64), ("fc1_dx", 128, 64),
            ("fc2_dx", 64, 128), ("fc1_dw", 64, 128), ("fc2_dw", 128, 64))


def test_moe_phases_run_at_tiny_size(shims, capsys):
    """The MoE slice's phases as the chip run drives them, cut to a tiny
    size: kernels 8 and 9 (their plain versions here) against the plain
    versions with the planted empty groups exactly zero; the recipe's
    training path (bf16, dropout, save_dots, sort_pallas, 2
    microbatches) with kernel 8 at 4 and kernel 9 at 2 a layer and
    microbatch and a falling loss; sort_pallas against sort in fp32 and
    bf16; the kernels line's rows."""
    cases = chip_smoke.phase_kernel_gmm("cpu", {"G": 8, "Gw": 4, "C": 16},
                                        GMM_TINY)
    assert [c["kernel"] for c in cases].count("grouped_matmul_dw") == 4
    assert all(c["empty_exact_zero"] and c["live_groups"] == 5 and
               c["bit_equal_rerun"] for c in cases)
    # the route each call took, as the shims count the planned one
    assert [c["route"] for c in cases[:6]] == [
        gmm.plan("dw" if call.endswith("dw") else "dx" if
                 call.endswith("dx") else "fwd", 4 if call.endswith("dw")
                 else 8, 16, k, n, torch.bfloat16).route
        for call, k, n in GMM_TINY]
    assert {c["route"] for c in cases[6:]} == {"f32"}
    record, engine = chip_smoke.phase_train_moe("cpu", MOE_TINY, steps=20)
    assert record["accumulate_steps"] == 2 and record["layers"] == 2
    assert record["launches_per_step"]["grouped_matmul"] == 4 * 2 * 2
    assert record["launches_per_step"]["grouped_matmul_dw"] == 2 * 2 * 2
    assert record["mean_last5"] < record["mean_first5"]
    assert record["mfu_top_k"] > record["mfu"] > 0
    assert engine.module.model_config.dtype == "bfloat16"
    assert engine.module.model_config.moe_dispatch == "sort_pallas"
    parity = chip_smoke.phase_train_moe_parity("cpu", MOE_TINY)
    for name in ("float32", "bfloat16"):
        assert parity[name]["launches_kernels"] == {
            "grouped_matmul": 8, "grouped_matmul_dw": 4}
        assert parity[name]["launches_bmm"] == {
            "grouped_matmul": 0, "grouped_matmul_dw": 0}
    rows = chip_smoke.gmm_rows(cases, record)
    assert [r["name"] for r in rows] == ["grouped_matmul",
                                         "grouped_matmul_dw"]
    for row in rows:
        assert KERNEL_KEYS <= set(row)
    assert rows[0]["launches"] == record["launches"]["grouped_matmul"]
    phases = [d.get("phase") for d in _lines(capsys)]
    for phase in ("kernel_gmm", "train_moe", "train_moe_parity"):
        assert phase in phases
