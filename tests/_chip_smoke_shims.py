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


def _decode_route(args, kwargs, paged):
    """The route :func:`fa.plan_decode` picks for a decode wrapper's call
    (``args``: q, the cache or pool, ..., and a pool's page table)."""
    q, k = args[:2]
    b, w, h, d = q.shape
    page = k.shape[2] if paged else 0
    S = page * args[4].shape[1] if paged else k.shape[2]
    return fa.plan_decode(b, w, h, S, d, q.dtype,
                          kwargs.get("k_scale") is not None, paged,
                          page).route


def _counting(fn, counted=None, paged=False):
    """A decode wrapper that counts its runs as the kernel counts its
    launches (on ``counted``, by default the shim itself): the int8
    instance (KV scales given) apart, and by planned route."""
    @functools.wraps(fn)
    def shim(*args, **kwargs):
        into = counted or shim
        if kwargs.get("k_scale") is not None:
            into.launches_int8 += 1
        else:
            into.launches += 1
        into.launches_by_route[_decode_route(args, kwargs, paged)] += 1
        return fn(*args, **kwargs)
    shim.launches = 0
    shim.launches_int8 = 0
    shim.launches_by_route = dict.fromkeys(fa.DECODE_ROUTES, 0)
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

    def fwd_shim(q, k, v, *args, **kwargs):
        f = fa.flash_attention
        f.launches += 1
        rate = args[2] if len(args) > 2 else kwargs.get("dropout_rate", 0.0)
        f.launches_by_route[fa.plan(q.shape[0], q.shape[2], q.shape[1],
                                    k.shape[1], q.shape[3], q.dtype,
                                    rate > 0.0).route] += 1
        return fwd_plain(q, k, v, *args, **kwargs)

    def bwd_shim(*args, **kwargs):
        fa.flash_attention_backward.launches_dkv += 1
        fa.flash_attention_backward.launches_dq += 1
        return bwd_plain(*args, **kwargs)
    monkeypatch.setattr(fa, "flash_attention_reference", fwd_shim)
    monkeypatch.setattr(fa, "flash_attention_backward_reference", bwd_shim)
    decode = _counting(fa.flash_decode)
    monkeypatch.setattr(fa, "flash_decode", decode)
    # kernel 2's second entry point counts in flash_decode's counts
    monkeypatch.setattr(fa, "flash_decode_ragged",
                        _counting(fa.flash_decode_ragged, decode))
    for name in ("flash_decode_paged", "flash_decode_verify",
                 "flash_decode_paged_verify"):
        monkeypatch.setattr(fa, name, _counting(getattr(fa, name),
                                                paged="paged" in name))
    qmm_plain = qmm.quantized_matmul_reference
    dx_plain = qmm.quantized_matmul_dx_reference

    def qmm_shim(x, w, scale):
        f = qmm.quantized_matmul
        f.launches += 1
        f.launches_by_route[qmm.plan("fwd", x.shape[0], x.shape[1],
                                     w.shape[0], x.dtype).route] += 1
        return qmm_plain(x, w, scale)

    def dx_shim(gs, w):
        f = qmm.quantized_matmul
        f.dx_launches += 1
        f.dx_launches_by_route[qmm.plan("dx", gs.shape[0], w.shape[1],
                                        w.shape[0], gs.dtype).route] += 1
        return dx_plain(gs, w)
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
