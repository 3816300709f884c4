"""Shared pieces of the ``chip_smoke.py`` rehearsals on the CPU
(``tests/test_torch_chip_smoke*.py``): the tiny configurations, the
kernels line's required keys, the counting shims that stand in for the
kernels' launch counts (the wrappers run their plain versions here and
launch nothing) and the reader of the JSON lines a phase prints."""

import functools
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from paddlefleetx_tpu_torch.observability import metrics  # noqa: E402
from paddlefleetx_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402
from paddlefleetx_tpu_torch.ops.cuda import grouped_matmul as gmm  # noqa: E402
from paddlefleetx_tpu_torch.ops.cuda import quantized_matmul as qmm  # noqa: E402

TINY = ["Model.num_layers=2", "Model.hidden_size=128",
        "Model.num_attention_heads=2", "Model.ffn_hidden_size=256",
        "Model.vocab_size=300", "Model.max_position_embeddings=160"]
KERNEL_KEYS = {"name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms"}


def _counting(fn):
    """A decode wrapper that counts its runs as the kernel counts its
    launches: the int8 instance (KV scales given) apart."""
    @functools.wraps(fn)
    def shim(*args, **kwargs):
        if kwargs.get("k_scale") is not None:
            shim.launches_int8 += 1
        else:
            shim.launches += 1
        return fn(*args, **kwargs)
    shim.launches = 0
    shim.launches_int8 = 0
    return shim


def _launching(plain, wrapper, planner=None):
    """``plain`` counting each run as a launch of ``wrapper``'s kernel
    (with ``planner``, also under the route it plans for the
    arguments)."""
    @functools.wraps(plain)
    def shim(*args, **kwargs):
        wrapper.launches += 1
        if planner is not None:
            wrapper.launches_by_route[planner(*args).route] += 1
        return plain(*args, **kwargs)
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
        # kernel 2's second entry point counts in flash_decode.launches
        if kwargs.get("k_scale") is not None:
            decode.launches_int8 += 1
        else:
            decode.launches += 1
        return ragged(*args, **kwargs)
    monkeypatch.setattr(fa, "flash_decode", decode)
    monkeypatch.setattr(fa, "flash_decode_ragged", ragged_shim)
    for name in ("flash_decode_paged", "flash_decode_verify",
                 "flash_decode_paged_verify"):
        monkeypatch.setattr(fa, name, _counting(getattr(fa, name)))
    qmm_plain = qmm.quantized_matmul_reference
    dx_plain = qmm.quantized_matmul_dx_reference

    def qmm_shim(*args, **kwargs):
        qmm.quantized_matmul.launches += 1
        return qmm_plain(*args, **kwargs)

    def dx_shim(*args, **kwargs):
        qmm.quantized_matmul.dx_launches += 1
        return dx_plain(*args, **kwargs)
    monkeypatch.setattr(qmm, "quantized_matmul_reference", qmm_shim)
    monkeypatch.setattr(qmm, "quantized_matmul_dx_reference", dx_shim)
    for name, wrapper, planner in (
            ("grouped_matmul_reference", gmm.grouped_matmul,
             lambda x, w, counts: gmm.plan_call(x, w)),
            ("grouped_matmul_dw_reference", gmm.grouped_matmul_dw,
             lambda x, dy, counts, gw: gmm.plan_call_dw(x, dy, gw))):
        monkeypatch.setattr(gmm, name, _launching(getattr(gmm, name),
                                                  wrapper, planner))
    yield
    # the shims counted runs as launches; a later test in this process
    # reads the real wrappers' counts from zero
    chip_smoke.reset_counts()
    metrics.get_registry().reset()
    metrics.set_enabled(False)


def _lines(capsys):
    out = capsys.readouterr().out.splitlines()
    return [json.loads(line) for line in out if line.startswith("{")]


TRAIN_TINY = ["Model.num_layers=2", "Model.hidden_size=128",
              "Model.num_attention_heads=2", "Model.ffn_hidden_size=256",
              "Model.vocab_size=300", "Model.max_position_embeddings=64",
              "Data.Train.dataset.max_seq_len=64",
              "Data.Eval.dataset.max_seq_len=64",
              "Global.local_batch_size=2", "Global.micro_batch_size=2"]
