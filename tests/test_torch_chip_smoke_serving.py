"""``chip_smoke.py``'s serving path on the CPU at a tiny size: the
contiguous server, its CLI, the parity phase and ``generate``, and the
kernels line's rows of kernels 1-4 (counting shims stand in for the
launch counts)."""

from _chip_smoke_shims import (KERNEL_KEYS, TINY, _lines, chip_smoke,
                               shims)  # noqa: F401


def test_serving_phases_run_at_tiny_size(shims, capsys):
    serve, module = chip_smoke.phase_serve("cpu", TINY, requests=5,
                                           slots=3, lo=5, hi=60)
    assert module.model_config.num_layers == 2
    assert serve["launches"] == {"flash_attention": 5 * 2,
                                 "flash_decode": serve["decode_ticks"] * 2}
    assert serve["counters"]["serving/admitted"] == 5
    chip_smoke.phase_serve_cli("cpu", TINY)
    chip_smoke.phase_parity("cpu", TINY, hi=60)
    chip_smoke.phase_generate_cli("cpu", TINY)
    phases = [d.get("phase") for d in _lines(capsys)]
    for phase in ("serve", "serve_cli", "parity", "generate_cli"):
        assert phase in phases
    case = {"dtype": "bfloat16", "tol": 2e-2, "max_abs_err": 1e-3,
            "ms": 0.1, "call_ms": 0.2, "plain_ms": 1.0, "library_ms": 0.05,
            "bound_ms": 0.01, "bound_by": "bytes", "b": 1, "h": 16,
            "s": 512, "d": 64, "bias": False, "rel_l2": 3e-3,
            "rel_l2_planted": 0.1}
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
    train = {"launches": {"flash_attention": 4, "flash_bwd_dkv": 4,
                          "flash_bwd_dq": 4}}
    line = chip_smoke.kernels_line(
        [case], [dict(case, S=1024)], serve,
        [dict(case, dropout=0.1, tol=4e-2)], [bwd], train)
    assert [k["name"] for k in line["kernels"]] == [
        "flash_attention", "flash_decode", "flash_bwd_dkv", "flash_bwd_dq"]
    for row in line["kernels"]:
        assert KERNEL_KEYS <= set(row)
    assert line["kernels"][1]["launches"] == serve["launches"][
        "flash_decode"]
    assert line["kernels"][0]["launches"] == 4 + serve["launches"][
        "flash_attention"]
    assert line["kernels"][0]["tol"] == {"bfloat16": 2e-2,
                                         "bfloat16_dropout": 4e-2}
    assert line["kernels"][2]["max_abs_err"] == 0.03
    assert line["kernels"][3]["max_abs_err"] == 0.01
    assert line["kernels"][3]["ms"] == 1.5
    # the pair is held to the bound of the one TPU function it replaces
    assert line["kernels"][2]["pair_ms"] == 3.5
    assert line["kernels"][2]["pair_bound_ms"] == 0.5
    assert line["kernels"][2]["max_rel_l2"] == 5e-3
    assert line["kernels"][2]["min_rel_l2_planted"] == 0.1
