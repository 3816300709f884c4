"""``chip_smoke.py`` on the CPU: its serving, parity, training and
entry-point phases run end to end at a tiny size (the kernels' wrappers
run their plain versions here, so counting shims on the plain versions
stand in for the launch counts), its bound and trace arithmetic is
right, and without a CUDA device it exits non-zero and prints no result
line."""

import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from _chip_smoke_shims import (KERNEL_KEYS, ROOT, TINY, TRAIN_TINY,  # noqa: F401
                               _lines, chip_smoke, shims)
from _torch_parity import one_thread
from paddlefleetx_tpu_torch.ops.cuda import flash_attention as fa
from paddlefleetx_tpu_torch.ops.cuda import grouped_matmul as gmm
from paddlefleetx_tpu_torch.ops.cuda import quantized_matmul as qmm


def test_moe_count_check_catches_a_recompute():
    """Kernel 8 at 6 a layer (save_dots recomputing the expert GEMMs), a
    fallback counter, or a layer off sort_pallas fail the check."""
    ok = {"grouped_matmul": 4 * 8, "grouped_matmul_dw": 2 * 8,
          "flash_attention": 8, "flash_bwd_dkv": 8, "flash_bwd_dq": 8,
          "grouped_matmul_routes": {"wgmma": 4 * 8, "mma": 0},
          "grouped_matmul_dw_routes": {"wgmma": 2 * 8},
          "counters": {"moe/sort_pallas": 16}}
    chip_smoke.check_moe_counts(ok, 1, 4, 2, "t")
    chip_smoke.check_moe_counts(ok, 1, 4, 2, "t", route="wgmma")
    with pytest.raises(AssertionError, match="by route"):
        chip_smoke.check_moe_counts(
            dict(ok, grouped_matmul_routes={"wgmma": 4 * 8 - 1, "mma": 1}),
            1, 4, 2, "t", route="wgmma")
    with pytest.raises(AssertionError, match="launches"):
        chip_smoke.check_moe_counts(dict(ok, grouped_matmul=6 * 8), 1, 4,
                                    2, "t")
    for counters in ({"moe/sort_pallas": 16, "moe/fallback/pallas_rejected":
                      1}, {"moe/sort_pallas": 4, "moe/sort": 12}):
        with pytest.raises(AssertionError, match="counters"):
            chip_smoke.check_moe_counts(dict(ok, counters=counters), 1, 4,
                                        2, "t")


def test_gmm_case_sees_skipped_padding_rows():
    """A grouped GEMM that computed only the rows below each group's
    count (zeros past it) fails the fc2 and fc2_dw checks, whose padding
    rows are non-zero as the real fc2 input's are; the same GEMM passes
    fc1, whose padding rows are zero."""
    def rows_only(x, counts):
        live = torch.arange(x.shape[1])[None, :, None] < \
            counts[:, None, None].long()
        return x * live
    skip = types.SimpleNamespace(
        grouped_matmul=lambda x, w, counts: gmm.grouped_matmul_reference(
            rows_only(x, counts), w, counts),
        grouped_matmul_dw=lambda x, dy, counts, gw:
            gmm.grouped_matmul_dw_reference(rows_only(x, counts), dy,
                                            counts, gw),
        grouped_matmul_reference=gmm.grouped_matmul_reference,
        grouped_matmul_dw_reference=gmm.grouped_matmul_dw_reference)
    groups = {"G": 8, "Gw": 4, "C": 16}
    chip_smoke.gmm_case(skip, torch, torch.float32, "fc1", 32, 64, 1,
                        "cpu", groups)
    for call, k, n in (("fc2", 64, 32), ("fc2_dw", 64, 32)):
        with pytest.raises(AssertionError, match="disagrees"):
            chip_smoke.gmm_case(skip, torch, torch.float32, call, k, n, 1,
                                "cpu", groups)


def test_gmm_bound():
    """Live groups only: 2 of 4 groups live in expert 0 of 2 (rep 2);
    bf16 kernel 8 reads their x and expert 0's weight, writes all four
    outputs; kernel 9 writes the whole fp32 dw."""
    ms, by = chip_smoke._gmm_bound("fwd", [3, 5, 0, 0], 2, 8, 16, 32, 2)
    nbytes = 2 * 8 * 16 * 2 + 16 * 32 * 2 + 4 * 8 * 32 * 2 + 16
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3)
    ms, by = chip_smoke._gmm_bound("dw", [1] * 16, 8, 320, 1024, 4096, 2)
    nbytes = 16 * 320 * (1024 + 4096) * 2 + 8 * 1024 * 4096 * 4 + 64
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3)
    ms, by = chip_smoke._gmm_bound("fwd", [1] * 16, 8, 320, 1024, 4096, 2)
    assert by == "operations"
    assert ms == pytest.approx(2.0 * 16 * 320 * 1024 * 4096 /
                               chip_smoke.BF16_TENSOR_FLOPS * 1e3)


def test_launch_check_catches_a_missing_kernel(shims):
    summary = {"admitted": 2, "decode_ticks": 3}
    counts = {"flash_attention": 4, "flash_decode": 0,
              "counters": {"attention/flash": 4}}
    with pytest.raises(AssertionError, match="flash_decode launched 0"):
        chip_smoke.check_serve_counts(counts, summary, 2, "serve")
    counts = {"flash_attention": 4, "flash_decode": 6,
              "counters": {"attention/flash": 4, "attention/dense": 1,
                           "attention/flash_decode_ragged": 6}}
    with pytest.raises(AssertionError, match="dispatch counters"):
        chip_smoke.check_serve_counts(counts, summary, 2, "serve")


def test_normwise_check_sees_a_skipped_tile():
    """The bf16 check holds each head normwise: the plain backward's
    gradients rounded to bf16 pass it, and the same gradients with one
    64-row tile of one head zeroed (a kernel block that wrote nothing)
    do not."""
    import numpy as np
    import torch
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, 1024, 2, 64))
                                    .astype(np.float32)) for _ in range(4))
    o, lse = fa.flash_attention_reference(q, k, v, True)
    grads = fa.flash_attention_backward_reference(q, k, v, o, lse, do)
    tol = chip_smoke.TOL_REL_L2["bfloat16"]
    for ref in grads:
        rounded = ref.to(torch.bfloat16)
        reading, planted = chip_smoke._hold_normwise(rounded, ref, "test")
        assert reading < tol / 3
        assert planted > tol * 3
        wrong = chip_smoke._zero_tile(rounded)
        with pytest.raises(AssertionError, match="normwise"):
            chip_smoke._hold_normwise(wrong, ref, "test")


def test_build_check_holds_the_wgmma_kernels():
    """``build`` passes when every kernel of ``WGMMA_KERNELS`` is in the
    SASS with ``HGMMA``, and fails when one is missing, holds no
    ``HGMMA``, or, for the bf16 backward kernels, holds ``HMMA``."""
    ok = {f"_ZN_{n}ILi64ELb1EEEv": {"HGMMA": 4, "HMMA": 0}
          for n in chip_smoke.WGMMA_KERNELS}
    chip_smoke.check_wgmma_sass(ok)
    dq = next(k for k in ok if "flash_bwd_dq" in k)
    dkv = next(k for k in ok if "flash_bwd_dkv" in k)
    with pytest.raises(AssertionError, match="missing"):
        chip_smoke.check_wgmma_sass({k: v for k, v in ok.items()
                                     if k != dq})
    with pytest.raises(AssertionError, match="no HGMMA"):
        chip_smoke.check_wgmma_sass(dict(ok, **{dkv: {"HGMMA": 0,
                                                      "HMMA": 0}}))
    with pytest.raises(AssertionError, match="HMMA"):
        chip_smoke.check_wgmma_sass(dict(ok, **{dq: {"HGMMA": 12,
                                                     "HMMA": 8}}))


def test_backward_bound():
    # causal s=2: 3 live pairs; kernel 4 (dq) does 3 products of 2 d
    # FLOPs per pair; bf16 reads q, k, v, dO, lse, delta, writes dq
    ms, by = chip_smoke._bwd_bound("dq", 1, 1, 2, 64, 2, False)
    nbytes = 5 * 2 * 64 * 2 + 2 * 2 * 4
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3)
    ms, by = chip_smoke._bwd_bound("both", 8, 16, 1024, 64, 2, False)
    flops = 10.0 * 8 * 16 * 64 * (1024 * 1025 // 2)
    assert by == "operations"
    assert ms == pytest.approx(flops / chip_smoke.BF16_TENSOR_FLOPS * 1e3)


def test_bounds_and_busy_time():
    # causal s=2: 3 live pairs; bf16 reads q, k, v and writes O + lse
    ms, by = chip_smoke._fwd_bound(1, 1, 2, 2, 64, 2, True, False)
    nbytes = 4 * 2 * 64 * 2 + 1 * 2 * 4
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3)
    # decode: offsets 0 and 3 -> 1 + 4 live keys of K and V per head
    ms, by = chip_smoke._decode_bound([0, 3], 2, 16, 64, 2, False)
    nbytes = 2 * 2 * 64 * 2 * 5 + 2 * 2 * 2 * 64 * 2
    assert ms == pytest.approx(nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3)
    assert chip_smoke._busy_us([(0, 2), (1, 3), (5, 6)]) == 4
    assert chip_smoke._busy_us([]) == 0


@pytest.mark.parametrize("alone", [False, True])
def test_exits_nonzero_without_cuda(tmp_path, alone):
    """Here there is no CUDA device: the script fails at once, in the
    checkout and in a directory that holds nothing else of the repo,
    and prints no ``ok`` line."""
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = str(tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, script], capture_output=True,
                          text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


#: the headline trace cut to the tiny model: capacity 256 (two 128-token
#: pages a slot), prefill chunks of one page
TINY_HEADLINE = {"requests": 6, "slots": 3, "lo": 5, "hi": 100,
                 "max_dec_len": 8, "page": 128, "pool_pages": 5,
                 "prefill_chunk_pages": 1, "spec_tokens": 2, "seed": 0,
                 "contiguous_spec_slots": 2}
#: a tiny model with the 345M recipe's capacity (1024: eight pages a
#: slot), for the parity phase's 256-token shared prefix
TINY_1024 = TINY[:-1] + ["Model.max_position_embeddings=1024"]


def test_paged_serving_phases_run_at_tiny_size(shims, capsys, monkeypatch):
    """The paged and speculative serving phases at a tiny size: each
    prints its line, the counts show the paged, verify and paged-verify
    kernels ran once per layer a tick and the prefill chunks took the
    gather + dense route, and the drained pools are whole."""
    monkeypatch.setattr(chip_smoke, "HEADLINE", TINY_HEADLINE)
    paged, module = chip_smoke.phase_serve_paged("cpu", TINY)
    assert paged["launches"]["flash_decode_paged"] == \
        paged["decode_ticks"] * 2 > 0
    assert paged["counters"]["attention/dense"] == \
        paged["counters"]["attention/fallback/kv_cache_layout"] == \
        paged["prefill_chunks"] * 2
    spec_paged, spec_contig = chip_smoke.phase_serve_spec(module, "cpu")
    assert spec_paged["launches"]["flash_decode_paged_verify"] == \
        spec_paged["decode_ticks"] * 2 > 0
    assert spec_contig["launches"]["flash_decode_verify"] == \
        spec_contig["decode_ticks"] * 2 > 0
    assert spec_contig["slots"] == 2 and not spec_contig["paged"]
    assert 0.0 <= spec_paged["spec_accept_rate"] <= 1.0
    # every decode launch counted under the route the model's dtype plans
    want = "mma" if paged["dtype"] == "bfloat16" else "simt"
    for rec, name in ((paged, "flash_decode_paged"),
                      (spec_paged, "flash_decode_paged_verify"),
                      (spec_contig, "flash_decode_verify")):
        routes = rec["launches_by_route"][name]
        assert routes[want] == rec["launches"][name] == \
            sum(routes.values())
    chip_smoke.phase_serve_cli("cpu", TINY_1024 + ["Model.kv_pool_pages=9"],
                               paged_spec=True)
    lines = {}
    for d in _lines(capsys):
        lines.setdefault(d.get("phase"), []).append(d)
    assert len(lines["serve_paged"]) == 1 and len(lines["serve_spec"]) == 2
    assert "serve_cli_paged_spec" in lines
    window = {p: [_window_case(p, w)] for p, w in (
        ("kernel_paged", 1), ("kernel_verify", 5),
        ("kernel_paged_verify", 5))}
    serve = {"launches": {"flash_attention": 10, "flash_decode": 12}}
    case = {"dtype": "bfloat16", "tol": 2e-2, "max_abs_err": 1e-3,
            "ms": 0.1, "call_ms": 0.2, "plain_ms": 1.0, "library_ms": 0.05,
            "bound_ms": 0.01, "bound_by": "bytes", "b": 1, "h": 16,
            "s": 512, "d": 64, "bias": False, "rel_l2": 3e-3,
            "rel_l2_planted": 0.1, "S": 1024}
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
    line = chip_smoke.kernels_line([case], [case], serve, [], [bwd], train,
                                   window, paged, (spec_paged, spec_contig))
    rows = {k["name"]: k for k in line["kernels"]}
    assert list(rows) == ["flash_attention", "flash_decode",
                          "flash_bwd_dkv", "flash_bwd_dq",
                          "flash_decode_paged", "flash_decode_verify",
                          "flash_decode_paged_verify"]
    for row in rows.values():
        assert KERNEL_KEYS <= set(row)
    assert rows["flash_decode_paged"]["launches"] == \
        paged["launches"]["flash_decode_paged"]
    assert rows["flash_decode_verify"]["launches_by_path"] == {
        "serve_spec_contiguous": spec_contig["launches"][
            "flash_decode_verify"]}
    assert rows["flash_decode_paged_verify"]["replaces"].endswith(":1433")
    assert rows["flash_decode_verify"]["replaces"].endswith(":1140")
    assert rows["flash_decode_paged"]["replaces"].endswith(":1422")
    assert all(rows[n]["exact_max_abs_err"] == 0.0 for n in (
        "flash_decode_paged", "flash_decode_verify",
        "flash_decode_paged_verify"))
    for n in ("flash_decode_paged", "flash_decode_verify",
              "flash_decode_paged_verify"):
        assert rows[n]["kernel_route"] == "mma" and \
            rows[n]["simt_ms"] == 0.05 and rows[n]["cluster"] == 1
    assert rows["flash_decode_paged"]["launches_by_route"] == \
        paged["launches_by_route"]["flash_decode_paged"]


def _window_case(phase, window):
    return {"kind": phase, "dtype": "bfloat16", "b": 16, "h": 16, "d": 64,
            "window": window, "capacity": 1024, "page": 128,
            "max_abs_err": 4e-3, "tol": 2e-2, "rel_l2": 2e-3,
            "rel_l2_planted": 1.0, "exact_vs": "kernel 2",
            "exact_max_abs_err": 0.0, "ms": 0.02, "call_ms": 0.05,
            "counterpart_ms": 0.015, "plain_ms": 0.3, "library_ms": 0.04,
            "library_computes": "SDPA", "bound_ms": 0.008,
            "bound_by": "bytes", "route": "mma", "chunk": 128, "cluster": 1,
            "simt_ms": 0.05}


def test_parity_paged_phase_runs_at_tiny_size(shims, capsys):
    """Five ways to serve four prompts sharing a 256-token prefix give
    the lockstep rows in fp32, also with a pool small enough to preempt;
    the bf16 pass prints its equal-row share."""
    with one_thread():
        records = chip_smoke.phase_parity_paged("cpu", TINY_1024,
                                                max_dec_len=24)
    fp32, bf16 = records
    assert fp32["dtype"] == "float32" and bf16["dtype"] == "bfloat16"
    assert set(fp32["rows_equal"].values()) == {4}
    assert fp32["counts"]["paged_preempted"]["preempted"] > 0
    assert fp32["counts"]["paged_preempted"]["prefix_hits"] >= 1
    assert "rows_equal_share" in bf16 and "first_divergence" in bf16
    assert [d["phase"] for d in _lines(capsys)].count("parity_paged") == 2


def test_decode_kernel_checks_hold_what_they_say(monkeypatch):
    """The kernel phase's checks on the CPU (the wrappers run their plain
    versions): the exact checks pass when the kernel is what it claims,
    and a verify kernel off by one ulp in one query (within every
    tolerance) or a paged kernel that reads a null page fails them."""
    import torch
    case = chip_smoke.decode_window_case(fa, torch, "verify", torch.float32,
                                         5, 3, n_sets=1, device="cpu")
    assert case["exact_max_abs_err"] == 0.0 and case["ms"] is None
    assert case["exact_vs"].startswith("kernel 2 at offset")
    verify = fa.flash_decode_verify

    def off_by_an_ulp(q, k, v, offsets):
        out = verify(q, k, v, offsets).clone()
        out[0, 2, 0, 0] = torch.nextafter(out[0, 2, 0, 0],
                                          torch.tensor(1e9))
        return out
    monkeypatch.setattr(fa, "flash_decode_verify", off_by_an_ulp)
    with pytest.raises(AssertionError, match="the design makes them equal"):
        chip_smoke.decode_window_case(fa, torch, "verify", torch.float32,
                                      5, 3, n_sets=1, device="cpu")
    monkeypatch.undo()
    paged = fa.flash_decode_paged

    def reads_null_pages(q, k, v, offsets, pt):
        return paged(q, k, v, torch.full_like(offsets, 1023), pt)
    monkeypatch.setattr(fa, "flash_decode_paged", reads_null_pages)
    with pytest.raises(AssertionError, match="plain version"):
        chip_smoke.decode_window_case(fa, torch, "paged", torch.float32,
                                      1, 3, n_sets=1, device="cpu")


def test_decode_cases_carry_the_route_on_the_cpu():
    """The CPU rehearsal of the decode kernels' cases records the route
    :func:`plan_decode` picks, its chunk and cluster, and leaves every
    time (the planned route's and ``simt``'s) None."""
    import torch
    case = chip_smoke.decode_case(fa, torch, torch.bfloat16, [0, 5, 130],
                                  2, 256, 64, False, 7, n_sets=1,
                                  device="cpu")
    assert (case["route"], case["cluster"]) == ("mma", 1)
    assert case["ms"] is None and case["simt_ms"] is None
    for dtype, kind, w, route in ((torch.bfloat16, "paged_verify", 5, "mma"),
                                  (torch.float32, "paged", 1, "simt")):
        case = chip_smoke.decode_window_case(fa, torch, kind, dtype, w, 3,
                                             n_sets=1, device="cpu")
        assert case["route"] == route and case["exact_max_abs_err"] == 0.0
        assert (case["chunk"], case["cluster"]) == \
            ((128, 1) if route == "mma" else (1024, 1))
        assert case["ms"] is None and case["simt_ms"] is None


def test_paged_launch_check_catches_wrong_routes(shims):
    summary = {"decode_ticks": 3, "prefill_chunks": 2, "paged": True,
               "admitted": 2}
    good = {"flash_attention": 0, "flash_decode": 0,
            "flash_decode_verify": 0, "flash_decode_paged": 6,
            "flash_decode_paged_verify": 0,
            "counters": {"attention/dense": 4,
                         "attention/fallback/kv_cache_layout": 4}}
    chip_smoke.check_paged_counts(good, summary, 2, "t", "flash_decode_paged")
    bad = dict(good, flash_decode_paged=0)
    with pytest.raises(AssertionError, match="flash_decode_paged launched"):
        chip_smoke.check_paged_counts(bad, summary, 2, "t",
                                      "flash_decode_paged")
    bad = dict(good, counters=dict(good["counters"], **{
        "attention/fallback/kernel_rejected": 1}))
    with pytest.raises(AssertionError, match="fallback"):
        chip_smoke.check_paged_counts(bad, summary, 2, "t",
                                      "flash_decode_paged")
    bad = dict(good, counters={"attention/dense": 6,
                               "attention/fallback/kv_cache_layout": 6})
    with pytest.raises(AssertionError, match="dense"):
        chip_smoke.check_paged_counts(bad, summary, 2, "t",
                                      "flash_decode_paged")


def test_decode_window_bound():
    # offsets 0 and 3, window 2: rows read 2 and 5 keys; pairs 1+2 and
    # 4+5; bf16, h 2, d 64, no table
    ms, by = chip_smoke._paged_bound([0, 3], 2, 2, 64, 16, 2, 0)
    nbytes = 2 * 2 * 64 * 2 * 7 + 2 * 2 * 2 * 2 * 64 * 2 + 4 * 2
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3)
    # fp32 at window 32 over a 1024 cache: operations nearly bind
    ms, by = chip_smoke._paged_bound([1000] * 16, 32, 16, 64, 1024, 4, 8)
    flops = 4.0 * 16 * 64 * 16 * sum(min(1000 + j + 1, 1024)
                                     for j in range(32))
    assert ms >= flops / chip_smoke.FP32_CUDA_CORE_FLOPS * 1e3 * 0.999


def test_int8_serving_phases_run_at_tiny_size(shims, capsys, monkeypatch):
    """The int8 serving phases at a tiny size: the headline trace with
    both int8 knobs from the int8 pool of the bf16 pool's bytes and the
    short arms, each tick an int8 instance once a layer, kernel 7 at
    every dense site of every forward; the ``serve`` entry point with
    both knobs; the kernels line's int8 rows."""
    monkeypatch.setattr(chip_smoke, "HEADLINE", TINY_HEADLINE)
    paged, _ = chip_smoke.phase_serve_paged("cpu", TINY)
    runs, module = chip_smoke.phase_serve_int8(
        paged, "cpu", TINY, short={"requests": 3, "max_dec_len": 6})
    assert module.model_config.kv_cache_dtype == "int8"
    kernels = {"paged": "flash_decode_paged_int8",
               "contiguous": "flash_decode_int8",
               "contiguous_spec": "flash_decode_verify_int8",
               "paged_spec": "flash_decode_paged_verify_int8"}
    for arm, kernel in kernels.items():
        run = runs[arm]
        assert run["kernel"] == kernel
        assert run["launches"][kernel] == run["decode_ticks"] * 2 > 0
        assert run["launches"]["quantized_matmul"] == \
            run["counters"]["quant/matmul"] == 4 * 2 * run["forwards"]
        routes = run["launches_by_route"]["quantized_matmul"]
        assert sum(routes.values()) == run["launches"]["quantized_matmul"]
        assert routes["mma"] == 0
    # the bf16 pool's bytes hold 9 int8 pages for 5 bf16 ones at the tiny
    # width (head_dim 64: 68 bytes a key and head against 128)
    assert runs["paged"]["pool_pages"] == 9
    chip_smoke.phase_serve_cli("cpu", TINY_1024, int8=True)
    lines = {}
    for d in _lines(capsys):
        lines.setdefault(d.get("phase"), []).append(d)
    ab = lines["serve_int8_ab"][0]
    assert ab["slots_admitted"] == 4 and ab["slots_admitted_bf16"] == 2
    assert len(lines["serve_int8"]) == 4 and "serve_cli_int8" in lines
    qcase = {"dtype": "bfloat16", "site": "qkv", "M": 16, "K": 1024,
             "N": 3072, "max_abs_err": 4e-3, "tol": 2e-2, "rel_l2": 2e-3,
             "rel_l2_planted": 1.0, "ms": 0.02, "call_ms": 0.03,
             "plain_ms": 0.1, "library_ms": 0.01, "int8pack_ms": None,
             "library_computes": "F.linear", "bound_ms": 0.001,
             "bound_by": "bytes"}
    dcase = {"dtype": "bfloat16", "b": 8, "h": 16, "S": 1024, "d": 64,
             "offsets": [0, 5], "shared_offset_bias": False,
             "max_abs_err": 4e-3, "tol": 2e-2, "rel_l2": 2e-3,
             "rel_l2_planted": 1.0, "ms": 0.02, "call_ms": 0.03,
             "plain_ms": 0.1, "library_ms": 0.02, "bound_ms": 0.002,
             "bound_by": "bytes", "library_computes": "SDPA"}
    window8 = {p + "_int8": [_window_case(p, w)] for p, w in (
        ("kernel_paged", 1), ("kernel_verify", 5),
        ("kernel_paged_verify", 5))}
    rows = {r["name"]: r for r in chip_smoke.int8_rows(
        [dcase], window8, [qcase], runs)}
    assert list(rows) == ["quantized_matmul", "flash_decode_int8",
                          "flash_decode_paged_int8", "flash_decode_verify_int8",
                          "flash_decode_paged_verify_int8"]
    for row in rows.values():
        assert KERNEL_KEYS <= set(row)
    assert rows["quantized_matmul"]["replaces"].endswith(
        "quantized_matmul.py:44")
    assert rows["quantized_matmul"]["launches"] == sum(
        r["launches"]["quantized_matmul"] for r in runs.values()) == \
        sum(rows["quantized_matmul"]["launches_by_route"].values())
    assert rows["quantized_matmul"]["launches_by_route"]["mma"] == 0
    for arm, kernel in kernels.items():
        assert rows[kernel]["launches"] == runs[arm]["launches"][kernel]
    assert rows["flash_decode_paged_int8"]["int8_branch"].endswith(
        ":1536-1548")


def test_parity_int8_phase_runs_at_tiny_size(shims, capsys):
    """The int8 servers' greedy rows equal the int8 lockstep rows in
    fp32, also with a pool small enough that the repeated prompt shares
    a partial page and splits it copy-on-write and a request is
    preempted; the bf16 pass prints its equal-row share."""
    with one_thread():
        fp32, bf16 = chip_smoke.phase_parity_int8("cpu", TINY_1024,
                                                  max_dec_len=24)
    assert fp32["dtype"] == "float32" and bf16["dtype"] == "bfloat16"
    assert set(fp32["rows_equal"].values()) == {4}
    small = fp32["counts"]["paged_small_pool"]
    assert small["cow_splits"] >= 1 and small["preempted"] >= 1
    assert fp32["lockstep_launches"]["flash_decode_int8"] == 23 * 2
    assert fp32["lockstep_launches"]["quantized_matmul"] == 4 * 2 * 24
    assert "rows_equal_share" in bf16
    assert [d["phase"] for d in _lines(capsys)].count("parity_int8") == 2


def test_int8_kernel_checks_hold_what_they_say(monkeypatch):
    """The int8 kernel phases' checks on the CPU (the wrappers run their
    plain versions): kernel 7's case passes and refuses a kernel that
    skips one output tile; kernel 2's int8 case passes; the int8 verify
    and paged cases are exact against kernel 2 / 5's int8 instance, and
    an int8 verify kernel that reads one key's scale wrong fails."""
    import torch
    case = chip_smoke.qmm_case(qmm, torch, torch.bfloat16, "t", 80, 256,
                               384, 3, device="cpu")
    assert case["max_abs_err"] <= case["tol"] and case["ms"] is None
    assert case["rel_l2_planted"] == 1.0
    assert case["bit_equal_rerun"] and case["ms_mma"] is None
    assert case["splits"] == qmm.plan("fwd", 80, 256, 384,
                                      torch.bfloat16).splits
    real = qmm.quantized_matmul

    def skips_a_tile(x, w, scale):
        out = real(x, w, scale).clone()
        out[:, 128:192] = 0
        return out
    monkeypatch.setattr(qmm, "quantized_matmul", skips_a_tile)
    with pytest.raises(AssertionError, match="disagrees|normwise"):
        chip_smoke.qmm_case(qmm, torch, torch.bfloat16, "t", 80, 256, 384,
                            3, device="cpu")
    monkeypatch.undo()
    for shared_bias in (False, True):
        case = chip_smoke.decode_case(fa, torch, torch.float32, [0, 5, 300],
                                      2, 512, 64, shared_bias, 4, n_sets=1,
                                      int8=True, device="cpu")
        assert case["kv_cache"] == "int8"
    for kind, window in (("verify", 5), ("paged", 1), ("paged_verify", 2)):
        case = chip_smoke.decode_window_case(fa, torch, kind, torch.float32,
                                             window, 3, n_sets=1,
                                             device="cpu", int8=True)
        assert case["exact_max_abs_err"] == 0.0
        assert case["kv_cache"] == "int8"
    verify = fa.flash_decode_verify

    def one_scale_off(q, k, v, offsets, k_scale, v_scale):
        v_scale = v_scale.clone()
        v_scale[0, 0, 3] *= 1.5
        return verify(q, k, v, offsets, k_scale=k_scale, v_scale=v_scale)
    monkeypatch.setattr(fa, "flash_decode_verify", one_scale_off)
    with pytest.raises(AssertionError, match="plain version"):
        chip_smoke.decode_window_case(fa, torch, "verify", torch.float32,
                                      5, 3, n_sets=1, device="cpu",
                                      int8=True)


def test_int8_bounds():
    # kernel 7, bf16, M 16 at the qkv site: x, int8 w, fp32 scales, out
    ms, by = chip_smoke._qmm_bound(16, 1024, 3072, 2)
    nbytes = 16 * 1024 * 2 + 1024 * 3072 + 4 * 3072 + 16 * 3072 * 2
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3)
    ms, by = chip_smoke._qmm_bound(512, 4096, 1024, 4)
    assert by == "operations"
    assert ms == pytest.approx(2.0 * 512 * 4096 * 1024 /
                               chip_smoke.FP32_CUDA_CORE_FLOPS * 1e3)
    # the int8 cache: 2 (d + 4) bytes a live key and head
    ms, by = chip_smoke._decode_bound([0, 3], 2, 16, 64, 2, False,
                                      2 * (64 + 4))
    nbytes = 2 * (64 + 4) * 2 * 5 + 2 * 2 * 2 * 64 * 2
    assert ms == pytest.approx(nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3)
    ms, _ = chip_smoke._paged_bound([0, 3], 2, 2, 64, 16, 2, 0,
                                    2 * (64 + 4))
    nbytes = 2 * (64 + 4) * 2 * 7 + 2 * 2 * 2 * 2 * 64 * 2 + 4 * 2
    assert ms == pytest.approx(nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3)


#: the four dense sites at a tiny width (K, N multiples of 128)
QMM_TINY = (("qkv", 128, 384), ("out", 128, 128), ("fc1", 128, 256),
            ("fc2", 256, 128))


def test_lora_kernel_phases_run_at_tiny_size(shims, capsys):
    """Kernel 7's dx route at the four sites and kernels 8 / 9 at the
    bank shapes (rank 8, one group empty, dw at the larger C) against
    their plain versions, with the grouped delta against the
    gather-einsum form; the kernels line's dx row and the LoRA entries
    of kernels 8 and 9."""
    dx = chip_smoke.phase_kernel_qmm_dx("cpu", rows=(16, 40),
                                        sites=QMM_TINY)
    assert len(dx) == 16 and dx[0]["M"] == 40
    for c in dx:
        planned = qmm.plan("dx", c["M"], c["K"], c["N"],
                           getattr(torch, c["dtype"]))
        assert (c["route"], c["splits"]) == tuple(planned)
        assert c["bit_equal_rerun"] and c["route"] == (
            "f32" if c["dtype"] == "float32" else
            "stream" if c["M"] <= qmm.STREAM_MAX_M else "wgmma")
    assert all(c["rel_l2"] <= chip_smoke.TOL_REL_L2[c["dtype"]] <
               c["rel_l2_planted"] for c in dx)
    calls = chip_smoke.lora_calls(QMM_TINY)
    assert calls[:2] == [("qkv_down", 128, 8), ("qkv_up", 8, 384)]
    cases, deltas = chip_smoke.phase_kernel_gmm_lora(
        "cpu", cs=(16, 40), calls=calls,
        edges=(("edge_down", 136, 8, 16), ("edge_down_dw", 64, 8, 72)))
    assert [c["kernel"] for c in cases].count("grouped_matmul_dw") == 9
    # x @ A and the edges on the split route, (xA) @ B (a reduction of
    # 8) and the dw at C 40 (a reduction under 64) on mma
    route = {c["call"] + str(c["C"]) + c["dtype"]: c["route"]
             for c in cases}
    assert route["qkv_down16bfloat16"] == route["edge_down16bfloat16"] \
        == route["edge_down_dw72bfloat16"] == "split"
    assert route["qkv_up16bfloat16"] == route["qkv_down_dw40bfloat16"] \
        == "mma"
    assert all(c["bit_equal_rerun"] for c in cases)
    assert all(c["empty_exact_zero"] and c["live_groups"] == 4 and
               c["G"] == 5 for c in cases)
    assert len(deltas) == 8
    grad = {"full": {"launches": {"quantized_matmul_dx": 96,
                                  "grouped_matmul": 384,
                                  "grouped_matmul_dw": 192}}}
    serve_lora = {"arms": {
        "id0": {"launches": {"grouped_matmul": 10}},
        "mixed": {"launches": {"grouped_matmul": 12}}}}
    train_moe = {"launches": {"grouped_matmul": 768,
                              "grouped_matmul_dw": 384}}
    rows = {r["name"]: r for r in chip_smoke.gmm_rows(
        [], train_moe, (cases, deltas, serve_lora, grad))}
    assert rows["grouped_matmul"]["kernel_route"] == "split"
    assert "ms_prev_design" in rows["grouped_matmul_dw"]
    assert rows["grouped_matmul"]["launches_by_path"] == {
        "train_moe": 768, "serve_lora_id0": 10, "serve_lora_mixed": 12,
        "grad_int8_lora": 384}
    assert rows["grouped_matmul_dw"]["launches"] == 384 + 192
    assert "qkv_C16" in rows["grouped_matmul"]["lora_delta"]
    (row,) = chip_smoke.lora_rows(dx, grad)
    assert KERNEL_KEYS <= set(row) and row["launches"] == 96
    assert row["kernel_route"] == dx[0]["route"] == "wgmma"
    assert row["replaces"].endswith("quantized_matmul.py:129")
    phases = [d.get("phase") for d in _lines(capsys)]
    for phase in ("kernel_qmm_dx", "kernel_gmm_lora",
                  "kernel_gmm_lora_delta"):
        assert phase in phases


def test_lora_serving_phases_run_at_tiny_size(shims, capsys, monkeypatch):
    """The LoRA serving phases at a tiny size: the trace on adapter 0
    (token-exact with the rank-0 twin) and on mixed adapters, every bank
    through the grouped delta (kernel 8 twice a site), no gather-einsum;
    the int8 arms with LoRA (kernels 5, 6a, 6b, 7, 8); the 2-layer
    parity against a CPU copy and the eviction run."""
    monkeypatch.setattr(chip_smoke, "HEADLINE", TINY_HEADLINE)
    record, module = chip_smoke.phase_serve_lora("cpu", TINY)
    assert module.model_config.lora_rank == 8
    assert record["mixed_requests_differing"] > 0
    for arm in ("id0", "mixed"):
        assert record[f"lora_grouped_{arm}"] == \
            4 * 2 * record[f"forwards_{arm}"] > 0
        assert record[f"kernel8_launches_{arm}"] == \
            2 * record[f"lora_grouped_{arm}"]
        assert record[f"lora_fallback_{arm}"] == 0
    assert record["adapters_resident_id0"] == 0
    assert record["adapter_misses_mixed"] == 4
    runs = chip_smoke.phase_serve_lora_int8(
        "cpu", TINY, short={"requests": 3, "max_dec_len": 4})
    for arm, kernel in (("contiguous_spec", "flash_decode_verify"),
                        ("paged", "flash_decode_paged"),
                        ("paged_spec", "flash_decode_paged_verify")):
        run = runs[arm]
        assert run["kernel"] == kernel and run["launches"][kernel] > 0
        assert run["launches"]["quantized_matmul"] > 0
        assert run["launches"]["grouped_matmul"] == \
            2 * run["counters"]["lora/grouped"] > 0
    with one_thread():
        fp32, bf16 = chip_smoke.phase_parity_lora(
            "cpu", TINY, requests=4, max_dec_len=6, hi=60)
    assert fp32["rows_equal"] == 4 and fp32["evictions"] > 0
    assert fp32["eviction_tokens_equal"] and bf16["dtype"] == "bfloat16"
    phases = [d.get("phase") for d in _lines(capsys)]
    for phase in ("serve_lora_id0", "serve_lora_mixed", "serve_lora_rank0",
                  "serve_lora", "serve_lora_int8", "parity_lora"):
        assert phase in phases


def test_lora_training_phases_run_at_tiny_size(shims, capsys):
    """The gradient over an int8 base with mixed ids against the CPU
    copy (fp32 and bf16) with kernels 7 (and its dx route), 8 and 9 at
    their counts a layer, and a full-size pass; then the frozen-base
    fine-tune through the entry point."""
    grad = chip_smoke.phase_grad_int8_lora("cpu", TINY, batch=2, seq=32,
                                           full=(2, 64))
    assert grad["float32"]["launches"] == {
        k: 2 * v for k, v in chip_smoke.GRAD_LORA_PER_LAYER.items()}
    assert grad["full"]["launches"]["quantized_matmul_dx"] == 4 * 2
    for name in ("quantized_matmul", "quantized_matmul_dx"):
        routes = grad["full"]["launches_by_route"][name]
        assert sum(routes.values()) == 4 * 2 and routes["mma"] == 0
    assert grad["float32"]["worst_leaf_rel_diff"] <= 1e-4
    record = chip_smoke.phase_finetune_lora("cpu", TRAIN_TINY)
    assert record["base_bit_equal"] and record["lora_b_max_abs"] == 0.0
    assert record["lora_a_norm_ratio_max"] < 1.0
    assert record["trained_params"] == record["state_entries"] == 16
    phases = [d.get("phase") for d in _lines(capsys)]
    assert "grad_int8_lora" in phases and "finetune_lora" in phases


def test_qmm_route_check_refuses_mma():
    """A path's kernel 7 launches pass the route check when each is
    counted under ``stream``, ``wgmma`` or ``f32``; one on ``mma`` (the
    first design, planned for no shape) or one counted under no route
    fails it, for the forward and the dx route alike."""
    routes = dict.fromkeys(qmm.ROUTES, 0)
    ok = {"quantized_matmul": 10, "quantized_matmul_dx": 4,
          "quantized_matmul_routes": dict(routes, stream=6, wgmma=4),
          "quantized_matmul_dx_routes": dict(routes, f32=4)}
    chip_smoke.check_qmm_routes(ok, "t")
    chip_smoke.check_qmm_routes(ok, "t", dx=True)
    for bad, dx in ((dict(ok, quantized_matmul_routes=dict(
            routes, stream=6, mma=4)), False),
                    (dict(ok, quantized_matmul=11), False),
                    (dict(ok, quantized_matmul_dx_routes=dict(
                        routes, wgmma=3, mma=1)), True)):
        with pytest.raises(AssertionError, match="no mma"):
            chip_smoke.check_qmm_routes(bad, "t", dx)


def test_lora_count_check_catches_a_fallback():
    """Kernel 8 launched other than twice a bank call, a missing site,
    or any gather-einsum fail the LoRA check."""
    ok = {"grouped_matmul": 2 * 4 * 2 * 3,
          "grouped_matmul_routes": {"split": 4 * 2 * 3, "mma": 4 * 2 * 3},
          "counters": {"lora/grouped": 4 * 2 * 3}}
    chip_smoke.check_lora_counts(ok, 2, 3, "t")
    chip_smoke.check_lora_counts(
        dict(ok, grouped_matmul_routes={"f32": 2 * 4 * 2 * 3}), 2, 3, "t",
        "float32")
    for bad in (dict(ok, grouped_matmul=5),
                dict(ok, grouped_matmul_routes={"split": 4 * 2 * 3 - 1,
                                                "mma": 4 * 2 * 3 + 1}),
                dict(ok, counters={"lora/grouped": 4 * 2 * 3,
                                   "lora/fallback": 1}),
                dict(ok, counters={"lora/grouped": 4 * 2 * 3 - 1})):
        with pytest.raises(AssertionError, match="lora/grouped"):
            chip_smoke.check_lora_counts(bad, 2, 3, "t")
