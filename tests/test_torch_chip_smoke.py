"""``chip_smoke.py`` on the CPU: its serving, parity, training and
entry-point phases run end to end at a tiny size (the kernels' wrappers
run their plain versions here, so counting shims on the plain versions
stand in for the launch counts), its bound and trace arithmetic is
right, and without a CUDA device it exits non-zero and prints no result
line."""

import functools
import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from _torch_parity import one_thread  # noqa: E402
from paddlefleetx_tpu_torch.observability import metrics  # noqa: E402
from paddlefleetx_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402

TINY = ["Model.num_layers=2", "Model.hidden_size=128",
        "Model.num_attention_heads=2", "Model.ffn_hidden_size=256",
        "Model.vocab_size=300", "Model.max_position_embeddings=160"]
KERNEL_KEYS = {"name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms"}


def _counting(fn):
    @functools.wraps(fn)
    def shim(*args, **kwargs):
        shim.launches += 1
        return fn(*args, **kwargs)
    shim.launches = 0
    return shim


@pytest.fixture
def shims(monkeypatch):
    """Count every run of a kernel's plain version as a launch of the
    kernel (on the CPU the wrappers launch nothing; a recompute that
    reuses a saved attention output runs neither), and leave the global
    registry as found."""
    fwd_plain = fa.flash_attention_reference
    bwd_plain = fa.flash_attention_backward_reference

    def fwd_shim(*args, **kwargs):
        fa.flash_attention.launches += 1
        return fwd_plain(*args, **kwargs)

    def bwd_shim(*args, **kwargs):
        fa.flash_attention_backward.launches_dkv += 1
        fa.flash_attention_backward.launches_dq += 1
        return bwd_plain(*args, **kwargs)
    monkeypatch.setattr(fa, "flash_attention_reference", fwd_shim)
    monkeypatch.setattr(fa, "flash_attention_backward_reference", bwd_shim)
    decode = _counting(fa.flash_decode)
    ragged = fa.flash_decode_ragged

    def ragged_shim(*args, **kwargs):
        decode.launches += 1
        return ragged(*args, **kwargs)
    monkeypatch.setattr(fa, "flash_decode", decode)
    monkeypatch.setattr(fa, "flash_decode_ragged", ragged_shim)
    yield
    metrics.get_registry().reset()
    metrics.set_enabled(False)


def _lines(capsys):
    out = capsys.readouterr().out.splitlines()
    return [json.loads(line) for line in out if line.startswith("{")]


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


TRAIN_TINY = ["Model.num_layers=2", "Model.hidden_size=128",
              "Model.num_attention_heads=2", "Model.ffn_hidden_size=256",
              "Model.vocab_size=300", "Model.max_position_embeddings=64",
              "Data.Train.dataset.max_seq_len=64",
              "Data.Eval.dataset.max_seq_len=64",
              "Global.local_batch_size=2", "Global.micro_batch_size=2"]


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
