"""``chip_smoke.py`` on the CPU: its serving, parity and entry-point
phases run end to end at a tiny size (the kernels' wrappers run their
plain versions here, so counting shims stand in for the launch counts),
its bound and trace arithmetic is right, and without a CUDA device it
exits non-zero and prints no result line."""

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
    """Count every wrapper call as a launch (on the CPU the wrappers
    launch nothing), and leave the global registry as found."""
    monkeypatch.setattr(fa, "flash_attention", _counting(fa.flash_attention))
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
            "s": 512, "d": 64, "bias": False}
    line = chip_smoke.kernels_line([case], [dict(case, S=1024)], serve)
    assert [k["name"] for k in line["kernels"]] == ["flash_attention",
                                                    "flash_decode"]
    for row in line["kernels"]:
        assert KERNEL_KEYS <= set(row)
    assert line["kernels"][1]["launches"] == serve["launches"][
        "flash_decode"]


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
