"""Kernel 1's routes: the planner that picks ``wgmma`` (and its key tile)
or ``f32`` from a call's shape, the C entry point's ctypes signature, and
the wrapper handing the planned route and tile to the library (a
recording stand-in here). The launches need the card: the test marked
``cuda`` holds every route against the plain version at ragged lengths
(sq and skv 37, 200, 1000, equal and not), head_dim 64 and 128, causal
or not, a ``[b, 1, 1, s]`` bias and dropout 0.1, and skips here. This
file imports no JAX, so the card's machine runs it as it stands::

    python -m pytest --noconftest -q -m cuda tests/test_torch_flash_forward_routes.py
"""

import contextlib
import ctypes
import os
import re
import sys
import types

import pytest
import torch

from paddlefleetx_tpu_torch.ops.cuda import build
from paddlefleetx_tpu_torch.ops.cuda import flash_attention as fa

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

BF = torch.bfloat16

#: (b, h, sq, skv, d, dtype, dropout) -> (route, key tile) at the paths'
#: shapes: serving prefill (one prompt, the 345M heads, its buckets),
#: training (the 345M recipe, 8 x 1024, dropout 0.1; the MoE recipe's
#: micro-batches), chip_smoke.py's head_dim-128 case, and fp32
PLANS = [
    ((1, 16, 16, 16, 64, BF, False), ("wgmma", 64)),
    ((1, 16, 256, 256, 64, BF, False), ("wgmma", 64)),
    ((1, 16, 511, 511, 64, BF, False), ("wgmma", 64)),
    ((1, 16, 512, 512, 64, BF, False), ("wgmma", 128)),
    ((1, 16, 960, 960, 64, BF, False), ("wgmma", 128)),
    ((1, 16, 1024, 1024, 64, BF, False), ("wgmma", 128)),
    ((1, 16, 1088, 1088, 64, BF, False), ("wgmma", 64)),
    ((2, 16, 512, 512, 64, BF, False), ("wgmma", 128)),
    ((8, 16, 1024, 1024, 64, BF, True), ("wgmma", 64)),
    ((8, 16, 1024, 1024, 64, BF, False), ("wgmma", 64)),
    ((2, 16, 1024, 1024, 64, BF, True), ("wgmma", 64)),
    ((1, 16, 512, 512, 128, BF, False), ("wgmma", 64)),
    ((2, 8, 300, 300, 128, BF, False), ("wgmma", 64)),
    ((4, 16, 1024, 1024, 128, BF, True), ("wgmma", 64)),
    ((8, 16, 1024, 1024, 64, torch.float32, True), ("f32", 32)),
    ((1, 16, 37, 37, 128, torch.float32, False), ("f32", 32)),
]


@pytest.mark.parametrize("call,want", PLANS)
def test_plan_routes(call, want):
    """bf16 takes ``wgmma``: 128-key tiles at head_dim 64 where the walk
    is at least 512 keys and the 64-row blocks fit two an SM (a serving
    prefill of one prompt up to 1024 tokens at 16 heads), 64-key tiles
    elsewhere (short walks, the training grids, head_dim 128); fp32 its
    CUDA-core kernel."""
    assert tuple(fa.plan(*call)) == want


def test_every_shape_gets_one_route():
    """Every shape gets exactly one route, never ``mma``, with a tile its
    kernel takes: ``wgmma`` 64 or 128 keys (128 only at head_dim 64) for
    bf16, ``f32`` 32 for fp32."""
    for b, h in ((1, 1), (1, 16), (8, 16), (64, 1024)):
        for sq in (1, 16, 37, 64, 65, 127, 128, 200, 1000, 4096):
            for skv in (1, 37, 64, 127, 128, 129, 1000, 4096):
                for d in (64, 128):
                    for drop in (False, True):
                        assert fa.plan(b, h, sq, skv, d, torch.float32,
                                       drop) == ("f32", 32)
                        route, bn = fa.plan(b, h, sq, skv, d, BF, drop)
                        assert route == "wgmma" and bn in fa.WGMMA_BLOCK_N
                        assert bn == 64 or d == 64


def test_named_routes():
    """The private ``route`` argument names any route its dtype has
    (``f32`` only for fp32, the others only for bf16), each with its own
    tile unless ``block_n`` names one."""
    call = (8, 16, 1024, 1024, 64, BF, True)
    assert fa._route(*call) == ("wgmma", 64)
    assert fa._route(*call, "mma") == ("mma", 64)
    assert fa._route(*call, "wgmma", 128) == ("wgmma", 128)
    assert fa._route(1, 16, 512, 512, 64, BF, False, "wgmma") == \
        ("wgmma", 128)
    assert fa._route(2, 8, 300, 300, 128, BF, False, "wgmma") == \
        ("wgmma", 64)
    assert fa._route(1, 1, 37, 37, 64, torch.float32, False, "f32") == \
        ("f32", 32)
    for dtype, route in ((BF, "f32"), (torch.float32, "mma"),
                         (torch.float32, "wgmma"), (BF, "split")):
        with pytest.raises(ValueError):
            fa._route(1, 1, 37, 37, 64, dtype, False, route)


def _c_types(decl):
    """ctypes of a C parameter list: pointers (and the stream) as void*,
    ``long long``, ``unsigned long long``, ``unsigned int``, ``int``,
    ``float``."""
    types_ = []
    for arg in decl.split(","):
        arg = " ".join(arg.split())
        if "*" in arg:
            types_.append(ctypes.c_void_p)
        elif arg.startswith("unsigned long long"):
            types_.append(ctypes.c_ulonglong)
        elif arg.startswith("long long"):
            types_.append(ctypes.c_longlong)
        elif arg.startswith("unsigned int"):
            types_.append(ctypes.c_uint)
        elif arg.startswith("int"):
            types_.append(ctypes.c_int)
        elif arg.startswith("float"):
            types_.append(ctypes.c_float)
        else:
            raise AssertionError(f"unexpected C parameter {arg!r}")
    return types_


def test_signature_matches_the_c_entry_point():
    """``build.SIGNATURES`` of kernel 1 has one ctypes type per parameter
    of its C entry point, the route and its key tile last before the
    stream."""
    with open(os.path.join(build.CSRC_DIR, "flash_fwd.cu")) as f:
        src = f.read()
    found = dict(re.findall(r'extern "C" int (pfx_\w+)\(([^)]*)\)', src))
    assert set(found) == {"pfx_flash_fwd"}
    assert build.SIGNATURES["pfx_flash_fwd"] == \
        _c_types(found["pfx_flash_fwd"])
    assert "int route, int block_n, void* stream" in \
        " ".join(found["pfx_flash_fwd"].split())


class _Recorder:
    """A stand-in for the kernels' library: ``pfx_flash_fwd`` converts its
    arguments with the declared ctypes (as ctypes would at a real call),
    records them and returns ``rc``."""

    def __init__(self, rc=0):
        self.calls, self.rc = [], rc

    def __getattr__(self, name):
        if name != "pfx_flash_fwd":
            raise AttributeError(name)
        argtypes = build.SIGNATURES[name]

        def call(*args):
            assert len(args) == len(argtypes), len(args)
            for a, t in zip(args, argtypes):
                t(a)   # raises on an argument the C type cannot take
            self.calls.append(args)
            return self.rc
        return call


@pytest.fixture
def recorder(monkeypatch):
    """The recording library behind ``build.load``, no device checks or
    context, and kernel 1's launch counts restored afterwards."""
    lib = _Recorder()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(fa, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(fa.flash_attention, "launches", 0)
    monkeypatch.setattr(fa.flash_attention, "launches_by_route",
                        dict.fromkeys(fa.ROUTES, 0))
    return lib


def _qkv(b, sq, skv, h, d, dtype):
    g = torch.Generator().manual_seed(3)
    q = torch.randn((b, sq, h, d), generator=g).to(dtype)
    k, v = (torch.randn((b, skv, h, d), generator=g).to(dtype)
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("sq,skv,d,dtype,rate", [
    (1024, 1024, 64, BF, 0.1), (37, 37, 64, BF, 0.0),
    (300, 200, 128, BF, 0.1), (37, 200, 64, torch.float32, 0.0)])
def test_wrapper_passes_the_planned_route(recorder, sq, skv, d, dtype,
                                          rate):
    """The wrapper hands the C entry point the shape, the dropout
    arguments, the planned route's code and tile and the current stream,
    and counts the launch in its total and under its route."""
    b, h = 2, 3
    q, k, v = _qkv(b, sq, skv, h, d, dtype)
    bias = torch.zeros((b, 1, 1, skv))
    out, lse = fa._launch_forward(q, k, v, True, bias, rate,
                                  11 if rate else None)
    p = fa.plan(b, h, sq, skv, d, dtype, rate > 0)
    (args,) = recorder.calls
    assert args[:6] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        bias.data_ptr(), out.data_ptr(), lse.data_ptr())
    assert args[6:14] == (b, h, sq, skv, d, skv, 0, 0)
    assert args[14] == pytest.approx(d ** -0.5)
    assert args[15:18] == (1, int(dtype == BF), int(rate > 0))
    assert args[-3:] == ({"wgmma": 1, "mma": 0, "f32": 0}[p.route],
                         p.block_n, 7)
    f = fa.flash_attention
    assert f.launches == 1 and f.launches_by_route == {
        r: int(r == p.route) for r in fa.ROUTES}
    assert out.shape == q.shape and lse.shape == (b, h, sq)


def test_wrapper_raises_on_a_refused_launch(recorder):
    """A launch the library refuses raises and counts nothing; a named
    route and tile reach the library as named."""
    q, k, v = _qkv(1, 40, 40, 2, 128, BF)
    recorder.rc = 1
    with pytest.raises(RuntimeError, match="wgmma kernel launch failed"):
        fa._launch_forward(q, k, v, True, None, 0.0, None, route="wgmma",
                           block_n=128)
    assert fa.flash_attention.launches == 0
    recorder.rc = 0
    fa._launch_forward(q, k, v, False, None, 0.0, None, route="mma")
    assert recorder.calls[-1][-3:] == (0, 64, 7)
    assert fa.flash_attention.launches_by_route["mma"] == 1


# -- on the card -----------------------------------------------------------

#: (sq, skv, d, causal, bias, dropout): ragged lengths (not multiples of
#: the 64-row blocks or 64 / 128-key tiles), sq != skv both ways, both
#: head dims
CARD_CASES = (
    (37, 37, 64, True, False, 0.0),
    (200, 200, 64, True, True, 0.1),
    (1000, 1000, 64, True, False, 0.1),
    (1000, 1000, 128, True, True, 0.0),
    (200, 1000, 64, False, True, 0.1),
    (1000, 200, 64, True, False, 0.0),
    (1000, 200, 128, False, False, 0.1),
    (200, 1000, 128, True, False, 0.1),
    (37, 200, 64, True, True, 0.0),
    (200, 37, 128, False, True, 0.0),
)


@pytest.fixture
def card():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch kernel 1")
    return torch.device("cuda")


def _routes(d):
    """Every bf16 route and tile at head_dim ``d``, the planned one's
    among them."""
    tiles = fa.WGMMA_BLOCK_N if d == 64 else fa.WGMMA_BLOCK_N[:1]
    return [("wgmma", bn) for bn in tiles] + [("mma", None)]


@pytest.mark.cuda
def test_every_route_matches_plain_on_the_card(card):
    """Every bf16 route and tile, and the fp32 kernel, at ragged shapes
    against the plain version run in fp32 on the same inputs, within
    ``chip_smoke.py``'s ``TOL`` (``TOL_DROPOUT`` with dropout) on O and
    lse; a second launch gives the same bits; the public entry point
    counts one launch on the planned route; rate 0 is bit-identical to
    the call without dropout; the wgmma route refuses a 128-key tile at
    head_dim 128."""
    for i, (sq, skv, d, causal, with_bias, rate) in enumerate(CARD_CASES):
        g = torch.Generator(device=card).manual_seed(i)
        b, h = 2, 3
        q = torch.randn((b, sq, h, d), generator=g, device=card)
        k, v = (torch.randn((b, skv, h, d), generator=g, device=card)
                for _ in range(2))
        bias = None
        if with_bias:
            bias = torch.where(torch.arange(skv, device=card) < 7, -1e9,
                               0.0)[None, None, None, :].expand(
                                   b, 1, 1, skv).contiguous()
        seed = 70 + i if rate else None
        ref_o, ref_lse = fa.flash_attention_reference(q, k, v, causal, bias,
                                                      rate, seed)
        runs = [(BF, r, bn) for r, bn in _routes(d)]
        runs.append((torch.float32, "f32", None))
        for dtype, route, bn in runs:
            qc, kc, vc = (t.to(dtype) for t in (q, k, v))
            what = (sq, skv, d, causal, with_bias, rate, route, bn)
            got = fa._launch_forward(qc, kc, vc, causal, bias, rate, seed,
                                     route=route, block_n=bn)
            again = fa._launch_forward(qc, kc, vc, causal, bias, rate, seed,
                                       route=route, block_n=bn)
            torch.cuda.synchronize()
            assert got[0].dtype == dtype and got[0].shape == q.shape, what
            assert torch.equal(got[0], again[0]) and \
                torch.equal(got[1], again[1]), what
            name = chip_smoke._dtype_name(dtype)
            tol = (chip_smoke.TOL_DROPOUT if rate else chip_smoke.TOL)[name]
            err = max(float((got[0].float() - ref_o).abs().max()),
                      float((got[1] - ref_lse).abs().max()))
            assert err <= tol, (what, err)
        qb, kb, vb = (t.to(BF) for t in (q, k, v))
        planned = fa.plan(b, h, sq, skv, d, BF, rate > 0)
        before = dict(fa.flash_attention.launches_by_route)
        fa.flash_attention(qb, kb, vb, causal, bias, rate, seed)
        now = fa.flash_attention.launches_by_route
        assert {r: now[r] - before[r] for r in fa.ROUTES} == {
            r: int(r == planned.route) for r in fa.ROUTES}
        o0, l0 = fa.flash_attention(qb, kb, vb, causal, bias, 0.0, 5)
        o1, l1 = fa.flash_attention(qb, kb, vb, causal, bias)
        assert torch.equal(o0, o1) and torch.equal(l0, l1)
        if d == 128:
            with pytest.raises(RuntimeError, match="launch failed"):
                fa._launch_forward(qb, kb, vb, causal, bias, 0.0, None,
                                   route="wgmma", block_n=128)


# -- chip_smoke.py's checks of kernel 1 --------------------------------------


def test_path_route_check_refuses_mma():
    """``chip_smoke.py`` passes a path whose kernel 1 launches all counted
    under ``wgmma`` or ``f32``, and fails one with a launch on ``mma`` or a
    launch counted under no route."""
    good = {"flash_attention": 5,
            "flash_attention_routes": {"wgmma": 4, "mma": 0, "f32": 1}}
    chip_smoke.check_fwd_routes(good, "serve")
    for routes in ({"wgmma": 4, "mma": 1, "f32": 0},
                   {"wgmma": 4, "mma": 0, "f32": 0}):
        with pytest.raises(AssertionError, match="no mma allowed"):
            chip_smoke.check_fwd_routes(
                dict(good, flash_attention_routes=routes), "train")


def test_build_check_holds_kernel_1_to_hgmma():
    """``build`` fails when kernel 1's wgmma kernel is missing from the
    SASS or holds ``HMMA`` (mma.sync), and passes with ``HGMMA`` alone."""
    ok = {f"_ZN_{n}ILi64ELb1EEEv": {"HGMMA": 4, "HMMA": 0}
          for n in chip_smoke.WGMMA_KERNELS}
    chip_smoke.check_wgmma_sass(ok)
    fwd = next(k for k in ok if "flash_fwd_wgmma" in k)
    with pytest.raises(AssertionError, match=r"missing \['flash_fwd"):
        chip_smoke.check_wgmma_sass({k: v for k, v in ok.items()
                                     if k != fwd})
    with pytest.raises(AssertionError, match="run mma.sync"):
        chip_smoke.check_wgmma_sass(dict(ok, **{fwd: {"HGMMA": 12,
                                                      "HMMA": 8}}))


def test_build_check_reads_only_the_wgmma_kernels():
    """The SASS reader's names cover kernel 1's wgmma kernel and no other
    kernel-1 route."""
    names = chip_smoke.WGMMA_KERNELS
    assert any("flash_fwd_wgmma" in n for n in names)
    assert not any(n in "flash_fwd_mma_kernel" or n in "flash_fwd_kernel"
                   for n in names)


def test_kernels_line_carries_kernel_1_routes():
    """The kernels line's kernel-1 row sums the paths' launches by route
    and carries the planned route, its tile and the ``mma`` time of the
    serving case, and the training case's beside it."""
    case = {"dtype": "bfloat16", "tol": 2e-2, "max_abs_err": 1e-3,
            "ms": 0.01, "call_ms": 0.02, "plain_ms": 0.1,
            "library_ms": 0.01, "bound_ms": 0.001, "bound_by": "bytes",
            "b": 1, "h": 16, "s": 512, "d": 64, "bias": False,
            "rel_l2": 3e-3, "rel_l2_planted": 0.1, "route": "wgmma",
            "block_n": 128, "mma_ms": 0.027, "other_block_n": 64,
            "other_tile_ms": 0.012}
    drop = dict(case, b=8, s=1024, dropout=0.1, tol=4e-2, block_n=64,
                mma_ms=0.33)
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
    serve = {"launches": {"flash_attention": 10, "flash_decode": 12},
             "launches_by_route": {"flash_attention": {
                 "wgmma": 10, "mma": 0, "f32": 0}}}
    train = {"launches": {"flash_attention": 4, "flash_bwd_dkv": 4,
                          "flash_bwd_dq": 4},
             "launches_by_route": {"flash_attention": {
                 "wgmma": 4, "mma": 0, "f32": 0}}}
    line = chip_smoke.kernels_line([case], [dict(case, S=1024)], serve,
                                   [drop], [bwd], train)
    row = line["kernels"][0]
    assert row["name"] == "flash_attention" and row["route"] == "cuda"
    assert row["launches"] == 14 and row["launches_by_route"] == {
        "wgmma": 14, "mma": 0, "f32": 0}
    assert (row["kernel_route"], row["block_n"], row["mma_ms"]) == \
        ("wgmma", 128, 0.027)
    assert row["train_shape"]["mma_ms"] == 0.33
    assert row["train_shape"]["block_n"] == 64
