"""``chip_smoke.py``'s MoE path on the CPU at a tiny size: kernels 8
and 9 against their plain versions, the 8x345M recipe's training path,
``sort_pallas`` against ``sort``, the MoE serving phases, and the kernels
line's rows (counting shims stand in for the launch counts)."""

import torch

from _chip_smoke_shims import (KERNEL_KEYS, TINY, _lines, chip_smoke,
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


#: the headline trace cut to the tiny model: capacity 256 (two 128-token
#: pages a slot), prefill chunks of one page
TINY_HEADLINE = {"requests": 6, "slots": 3, "lo": 5, "hi": 100,
                 "max_dec_len": 8, "page": 128, "pool_pages": 5,
                 "prefill_chunk_pages": 1, "spec_tokens": 2, "seed": 0,
                 "contiguous_spec_slots": 2}
#: the serving recipe cut to a tiny size with the 8x345M model's 8
#: experts (the serving phases add ``MOE_KNOBS``)
SERVE_TINY = TINY[:-1] + ["Model.max_position_embeddings=256"]
#: kernel 8's serving shapes at a tiny size: 4 slots, the 5-token
#: window, a 64-token chunk; fc1 / fc2 of the tiny experts
GMM_SERVE_TINY = (("decode", 4, 1), ("verify", 4, 5), ("chunk", 1, 64))
GMM_SERVE_CALLS_TINY = (("fc1", 128, 256), ("fc2", 256, 128))


def test_serve_moe_phases_run_at_tiny_size(shims, capsys, monkeypatch):
    """The MoE serving phases as the chip run drives them, cut to a tiny
    size: kernel 8 (its plain version here) at the serving forwards'
    groups and capacities with the planted empty groups exactly zero;
    the contiguous, paged, paged speculative and int8 arms, each with
    kernel 8 twice a layer and forward and every block on sort_pallas;
    the serve and generate entry points; sort_pallas held to sort in
    fp32, contiguous and paged; the kernels line's serving rows."""
    monkeypatch.setattr(chip_smoke, "HEADLINE", TINY_HEADLINE)
    cases = chip_smoke.phase_kernel_gmm_serving(
        "cpu", GMM_SERVE_TINY, GMM_SERVE_CALLS_TINY)
    assert [(c["serving"], c["call"], c["G"], c["C"]) for c in cases] == [
        ("decode", "fc1", 32, 1), ("decode", "fc2", 32, 1),
        ("verify", "fc1", 32, 2), ("verify", "fc2", 32, 2),
        ("chunk", "fc1", 8, 20), ("chunk", "fc2", 8, 20)]
    assert all(c["empty_exact_zero"] and c["bit_equal_rerun"] and
               0 < c["live_groups"] < c["G"] for c in cases)
    assert [c["route"] for c in cases] == [
        gmm.plan("fwd", c["G"], c["C"], c["K"], c["N"],
                 torch.bfloat16).route for c in cases]
    runs, module = chip_smoke.phase_serve_moe("cpu", SERVE_TINY, requests=4)
    assert module.model_config.moe_num_experts == 8
    assert list(runs) == ["contiguous", "paged", "paged_spec", "int8"]
    for arm, rec in runs.items():
        assert rec["model"] == "MoE GPT 8x345M" and rec["layers"] == 2
        assert rec["launches"]["grouped_matmul"] == \
            2 * 2 * rec["forwards"] > 0, arm
        assert sum(rec["launches_by_route"]["grouped_matmul"].values()) == \
            rec["launches"]["grouped_matmul"]
        assert rec["counters"]["moe/sort_pallas"] == 2 * rec["forwards"]
    assert runs["int8"]["quant_execution"] == "weight_only_int8"
    assert runs["int8"]["launches"]["quantized_matmul"] == \
        2 * 2 * runs["int8"]["forwards"]
    chip_smoke.phase_serve_cli("cpu", SERVE_TINY + list(chip_smoke.MOE_KNOBS))
    chip_smoke.phase_generate_cli("cpu", SERVE_TINY +
                                  list(chip_smoke.MOE_KNOBS))
    parity = chip_smoke.phase_parity_moe("cpu", SERVE_TINY, requests=3,
                                         max_dec_len=8)
    assert parity["contiguous_rows_equal"] == parity["paged_rows_equal"] == 3
    assert set(parity["contiguous_routes"]) <= set(gmm.ROUTES)
    train_moe = {"launches": {"grouped_matmul": 768,
                              "grouped_matmul_dw": 384}}
    train_cases = chip_smoke.phase_kernel_gmm(
        "cpu", {"G": 8, "Gw": 4, "C": 16}, GMM_TINY[::4] + GMM_TINY[5:])
    rows = chip_smoke.gmm_rows(train_cases, train_moe,
                               serving=(cases, runs))
    k8 = rows[0]
    assert KERNEL_KEYS <= set(k8)
    assert k8["launches_by_path"]["serve_moe_paged_spec"] == \
        runs["paged_spec"]["launches"]["grouped_matmul"]
    assert k8["launches"] == 768 + sum(
        r["launches"]["grouped_matmul"] for r in runs.values())
    assert set(k8["serving"]) == {f"{c['serving']}_{c['call']}"
                                  for c in cases}
    phases = [d.get("phase") for d in _lines(capsys)]
    for phase in ("kernel_gmm_serving", "serve_moe", "serve_cli_moe",
                  "generate_cli", "parity_moe"):
        assert phase in phases


def test_serving_shapes_cover_every_planned_route():
    """``GMM_SERVE`` holds kernel 8 at every route the 8x345M model's
    serving forwards plan: the decode tick and verify window on
    ``split``, and the contiguous admissions of the headline trace's
    prompts (16..384 tokens), one prompt at its bucket a forward, on
    ``split``, ``mma`` and ``wgmma``; each bucket's C is the capacity the
    model routes that bucket with."""
    from paddlefleetx_tpu_torch.core.serving import default_prefill_buckets
    from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
    from paddlefleetx_tpu_torch.models.gpt.moe import expert_capacity
    # the generation recipe's capacity
    cfg = GPTConfig(moe_num_experts=8, moe_top_k=2,
                    moe_capacity_factor=1.25, max_position_embeddings=1024)
    hl = chip_smoke.HEADLINE
    buckets = default_prefill_buckets(
        cfg.max_position_embeddings - hl["max_dec_len"])
    reached = {next(b for b in buckets if b >= n)
               for n in range(hl["lo"], hl["hi"] + 1)}
    served = {s for name, rows, s in chip_smoke.GMM_SERVE
              if name.startswith("bucket") and rows == 1}
    assert served == reached
    routes = {}
    for name, rows, s in chip_smoke.GMM_SERVE:
        groups, _ = chip_smoke.serve_groups(rows, s)
        assert groups["C"] == expert_capacity(cfg, s)
        for call, k, n in chip_smoke.GMM_SERVE_CALLS:
            routes.setdefault(gmm.plan("fwd", groups["G"], groups["C"], k,
                                       n, torch.bfloat16).route,
                              []).append(name)
    assert set(routes) == {"split", "mma", "wgmma"}
    assert {"bucket16", "decode", "verify"} <= set(routes["split"])
    assert set(routes["mma"]) == {"bucket64", "bucket128"}
    assert {"chunk", "bucket256", "bucket512"} == set(routes["wgmma"])
