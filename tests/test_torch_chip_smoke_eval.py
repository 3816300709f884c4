"""``chip_smoke.py``'s eval slice on the CPU at a tiny size: kernel 8 at
the MoE eval batch against its plain version, the dense, cloze and MoE
``eval`` runs with their counts, the checkpoint round trip, the fp32
parity of the kernel paths against the dense paths, ``predict`` with
``test_iters``, and the kernels line's eval rows (counting shims stand
in for the launch counts)."""

import pytest

from _chip_smoke_shims import (KERNEL_KEYS, TINY, TRAIN_TINY, _lines,
                               chip_smoke, shims)  # noqa: F401
from _torch_parity import one_thread

#: the eval recipe cut to a tiny size: windows of 64 tokens, batches of 3
EVAL_TINY = TINY + ["Offline_Eval.max_seq_len=64",
                    "Offline_Eval.batch_size=3"]
#: kernel 8 at a tiny MoE eval batch: 3 rows x 4 experts, C 16
GMM_EVAL_TINY = {"G": 12, "Gw": 4, "C": 16}


def test_eval_phases_run_at_tiny_size(shims, capsys):
    """Every eval phase as the chip run drives it, at a tiny size: the
    counts (kernel 1 once a layer and batch, the short last batch
    included; kernel 8 twice; no backward, no kernel 9, no dense
    attention), the metrics, the checkpoint's metrics equal to the
    seeded model's, and the kernels line's eval rows."""
    fwd, gmm_cases = chip_smoke.phase_kernels_eval(
        "cpu", groups=GMM_EVAL_TINY, calls=(("fc1", 64, 128),
                                            ("fc2", 128, 64)))
    assert fwd is None and len(gmm_cases) == 2
    assert all(c["live_groups"] == 12 and c["bit_equal_rerun"] and
               c["empty_exact_zero"] is None for c in gmm_cases)
    with one_thread():
        ev = chip_smoke.phase_eval("cpu", EVAL_TINY, words=200)
    assert ev["ckpt_equal"] and ev["metrics"]["ppl"] > 1.0
    assert ev["batches"] > 2 and ev["last_batch"] < ev["batch"]
    assert ev["launches"]["flash_attention"] == 2 * ev["batches"]
    cloze = chip_smoke.phase_eval_cloze("cpu", EVAL_TINY, lines=7,
                                        words=(3, 8))
    assert cloze["samples"] == 7 and cloze["batches"] == 3
    assert cloze["launches"]["flash_attention"] == 2 * 3
    moe = chip_smoke.phase_eval_moe("cpu", EVAL_TINY, words=60)
    assert moe["launches"]["grouped_matmul"] == 2 * 2 * moe["batches"]
    assert moe["counters"]["moe/sort_pallas"] == 2 * moe["batches"]
    parity = chip_smoke.phase_eval_parity("cpu", EVAL_TINY, words=60,
                                          lines=4, line_words=(3, 8))
    assert set(parity["arms"]) == {"dense_lm", "dense_cloze", "moe_lm",
                                   "moe_cloze"}
    for arm in parity["arms"].values():
        assert arm["batches"] >= 1
    assert parity["arms"]["dense_lm"]["max_rel_diff"] <= parity["rtol"]
    predict = chip_smoke.phase_predict(
        "cpu", TRAIN_TINY + ["Data.Eval.dataset.max_seq_len=64"], iters=4)
    assert predict["launches"]["flash_attention"] == 2 * 4
    assert len(predict["losses"]) == 4
    phases = [d.get("phase") for d in _lines(capsys)]
    for phase in ("kernel_gmm_eval", "eval", "eval_cloze", "eval_moe",
                  "eval_parity", "predict"):
        assert phase in phases
    case = {"dtype": "bfloat16", "b": 1, "h": 16, "s": 512, "d": 64,
            "bias": False, "max_abs_err": 1e-3, "tol": 2e-2,
            "rel_l2": 1e-3, "rel_l2_planted": 0.2, "ms": 0.01,
            "call_ms": 0.1, "plain_ms": 0.1, "library_ms": 0.01,
            "bound_ms": 0.001, "bound_by": "bytes", "route": "wgmma",
            "block_n": 128, "mma_ms": 0.02}
    dec = dict(case, offsets=[0], S=1024)
    runs = {"eval": ev, "eval_cloze": cloze, "eval_moe": moe,
            "predict": predict}
    serve = {"launches": {"flash_attention": 4, "flash_decode": 8}}
    bwd = {"regime": "x", "dtype": "bfloat16", "b": 8, "h": 16, "s": 1024,
           "d": 64, "bias": False, "dropout": 0.1, "max_abs_err": {
               "dq": 0.1, "dk": 0.1, "dv": 0.1}, "grad_scale": 100.0,
           "tol": 1e-2, "tol_kind": "rel", "rel_l2": {
               "dq": 1e-3, "dk": 1e-3, "dv": 1e-3},
           "rel_l2_planted": {"dq": 0.2, "dk": 0.1, "dv": 0.3},
           **{f"{k}_{w}": 0.1 for k in ("ms", "call_ms", "bound_ms")
              for w in ("dkv", "dq", "both")},
           **{f"bound_by_{w}": "operations" for w in ("dkv", "dq", "both")},
           "plain_ms": 1.0, "library_ms": 0.2}
    train = {"launches": {"flash_attention": 4, "flash_bwd_dkv": 4,
                          "flash_bwd_dq": 4}}
    line = chip_smoke.kernels_line(
        [case], [dec], serve, [], [bwd], train,
        evals={"fwd": dict(case, s=1024, b=8), "gmm": gmm_cases,
               "runs": runs})
    k1 = {r["name"]: r for r in line["kernels"]}["flash_attention"]
    assert KERNEL_KEYS <= set(k1)
    assert k1["eval_shape"]["b"] == 8
    for path, rec in runs.items():
        assert k1["launches_by_path"][path] == \
            rec["launches"]["flash_attention"]
    assert k1["launches"] == sum(k1["launches_by_path"].values())


def test_eval_rows_add_kernel_8_at_the_eval_batch(shims):
    """``eval_rows`` adds kernel 8's eval cases and ``eval_moe``'s
    launches, by path and route, to its row."""
    rows = [{"name": "flash_attention"},
            {"name": "grouped_matmul", "launches": 10,
             "launches_by_path": {"train_moe": 10},
             "launches_by_route": {"wgmma": 10}, "max_abs_err": 1e-3,
             "max_err": 1e-3}]
    gmm_cases = [{"call": c, "G": 64, "C": 320, "K": k, "N": n,
                  "live_groups": 64, "ms_prev_design": 0.3, "route": "wgmma",
                  "ms": 0.2, "call_ms": 0.2, "plain_ms": 2.0,
                  "library_ms": 0.18, "bound_ms": 0.17,
                  "bound_by": "operations", "max_abs_err": 5e-3,
                  "rel_l2": 2e-3} for c, k, n in (("fc1", 1024, 4096),
                                                  ("fc2", 4096, 1024))]
    run = {"launches": {"grouped_matmul": 96}, "launches_by_route": {
        "grouped_matmul": {"wgmma": 96}}}
    chip_smoke.eval_rows(rows, {"fwd": None, "gmm": gmm_cases,
                                "runs": {"eval_moe": run}})
    k8 = rows[1]
    assert k8["launches"] == 106 and k8["launches_by_path"]["eval_moe"] == 96
    assert k8["launches_by_route"] == {"wgmma": 106}
    assert set(k8["eval"]) == {"fc1", "fc2"}
    assert k8["max_abs_err"] == pytest.approx(5e-3)
    assert "eval_shape" not in rows[0]
