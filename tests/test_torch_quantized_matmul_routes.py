"""Kernel 7's routes: the planner that picks ``stream``, ``wgmma``,
``mma`` or ``f32`` from a call's shape, the C entry points' ctypes
signatures, and the wrapper handing the planned route and cluster size
to the library (a recording stand-in here). The launches need the card:
the test marked ``cuda`` holds every route against the plain version at
ragged M and the four GPT-345M site shapes, forward and dx, and skips
here. This file imports no JAX, so the card's machine runs it as it
stands: ``python -m pytest --noconftest -q -m cuda
tests/test_torch_quantized_matmul_routes.py``."""

import contextlib
import ctypes
import os
import re
import types

import pytest
import torch

from paddlefleetx_tpu_torch.ops.cuda import build
from paddlefleetx_tpu_torch.ops.cuda import quantized_matmul as qmm

BF = torch.bfloat16
#: the GPT-345M dense sites, ``(name, K, N)`` of ``x [M, K] @ w [N, K]^T``
SITES = (("qkv", 1024, 3072), ("out", 1024, 1024), ("fc1", 1024, 4096),
         ("fc2", 4096, 1024))
#: ragged and path M: decode ticks, the verify window, a paged prefill
#: chunk, a prompt, the gradient phase's 4 x 1024
ROWS = (1, 7, 16, 17, 80, 129, 256, 511, 4096)

#: (op, M, K, N, dtype) -> (route, splits) at the path's shapes
PLANS = [
    (("fwd", 16, 1024, 3072, BF), ("stream", 4)),
    (("fwd", 16, 1024, 1024, BF), ("stream", 4)),
    (("fwd", 16, 1024, 4096, BF), ("stream", 4)),
    (("fwd", 16, 4096, 1024, BF), ("stream", 8)),
    (("fwd", 32, 4096, 1024, BF), ("stream", 8)),
    (("fwd", 48, 4096, 1024, BF), ("wgmma", 8)),
    (("fwd", 80, 4096, 1024, BF), ("wgmma", 8)),
    (("fwd", 8, 1024, 3072, BF), ("stream", 4)),
    (("fwd", 256, 1024, 3072, BF), ("wgmma", 2)),
    (("fwd", 256, 1024, 1024, BF), ("wgmma", 4)),
    (("fwd", 256, 4096, 1024, BF), ("wgmma", 4)),
    (("fwd", 512, 1024, 3072, BF), ("wgmma", 1)),
    (("fwd", 512, 4096, 1024, BF), ("wgmma", 2)),
    (("fwd", 4096, 1024, 4096, BF), ("wgmma", 1)),
    (("fwd", 4096, 4096, 1024, BF), ("wgmma", 1)),
    (("dx", 16, 1024, 3072, BF), ("stream", 8)),
    (("dx", 16, 4096, 1024, BF), ("stream", 4)),
    (("dx", 512, 1024, 3072, BF), ("wgmma", 2)),
    (("dx", 4096, 1024, 3072, BF), ("wgmma", 1)),
    (("dx", 4096, 1024, 4096, BF), ("wgmma", 1)),
    (("dx", 4096, 4096, 1024, BF), ("wgmma", 1)),
    (("fwd", 16, 1024, 3072, torch.float32), ("f32", 1)),
    (("dx", 4096, 4096, 1024, torch.float32), ("f32", 1)),
]


@pytest.mark.parametrize("call,want", PLANS)
def test_plan_routes(call, want):
    """Decode M takes ``stream`` (a slice near 256 deep a block); from
    the verify window up (and dx at the gradient's 4096) ``wgmma``,
    split over a cluster where its tiles fill under half the card; fp32
    its CUDA-core kernel."""
    assert tuple(qmm.plan(*call)) == want


def _stream_takes(m, out, red, s):
    return m <= qmm.STREAM_MAX_M and 1 <= s <= qmm.SPLIT_MAX and \
        red % (s * qmm.STREAM_STAGE) == 0 and \
        red // s <= qmm.STREAM_MAX_SLICE and out % qmm.STREAM_TILE == 0


def test_every_admitted_shape_gets_one_route():
    """Every admitted ``(op, M, K, N, dtype)`` gets exactly one route,
    never ``mma``, with a cluster size its kernel takes: ``stream`` only
    up to ``STREAM_MAX_M`` rows over slices of whole 128-deep stages of
    at most 512; ``wgmma`` with 1, 2, 4 or 8 blocks whose slices are
    whole pairs of 64-deep steps; fp32 always ``f32``."""
    dims = (128, 256, 384, 1024, 1152, 3072, 4096, 8192)
    for op in ("fwd", "dx"):
        for m in (1, 7, 8, 16, 17, 64, 80, 127, 128, 129, 256, 511, 4096):
            for k in dims:
                for n in dims:
                    assert qmm.admits(k, n)
                    out, red = (n, k) if op == "fwd" else (k, n)
                    assert qmm.plan(op, m, k, n, torch.float32) == \
                        ("f32", 1)
                    route, s = qmm.plan(op, m, k, n, BF)
                    assert route in ("stream", "wgmma")
                    if route == "stream":
                        assert _stream_takes(m, out, red, s)
                    else:
                        assert s in (1, 2, 4, 8) and red % (s * 128) == 0
                        assert m > qmm.STREAM_MAX_M or \
                            qmm._stream_splits(red) is None
    with pytest.raises(ValueError):
        qmm.plan("dw", 16, 1024, 1024, BF)


def test_named_routes():
    """The private ``route`` argument names any route its dtype has
    (``f32`` only for fp32, the others only for bf16) with that route's
    own cluster size; the kernel refuses a shape the route cannot
    take."""
    assert qmm._route("fwd", 16, 1024, 1024, BF, "mma") == ("mma", 1)
    assert qmm._route("fwd", 16, 1024, 1024, BF, "wgmma") == ("wgmma", 8)
    assert qmm._route("fwd", 16, 1024, 3072, BF, "wgmma") == ("wgmma", 4)
    assert qmm._route("dx", 4096, 1024, 3072, BF, "stream") == \
        ("stream", 8)
    assert qmm._route("fwd", 4096, 1024, 1024, BF, "stream") == \
        ("stream", 4)
    assert qmm._route("fwd", 16, 1024, 1024, torch.float32, None) == \
        ("f32", 1)
    for dtype, route in ((BF, "f32"), (torch.float32, "mma"),
                         (torch.float32, "stream"), (BF, "split")):
        with pytest.raises(ValueError):
            qmm._route("fwd", 16, 1024, 1024, dtype, route)


def _c_types(decl):
    """ctypes of a C parameter list: pointers (and the stream) as
    void*, ``int``."""
    types_ = []
    for arg in decl.split(","):
        arg = " ".join(arg.split())
        if "*" in arg:
            types_.append(ctypes.c_void_p)
        elif arg.startswith("int"):
            types_.append(ctypes.c_int)
        else:
            raise AssertionError(f"unexpected C parameter {arg!r}")
    return types_


def test_signatures_match_the_c_entry_points():
    """``build.SIGNATURES`` of kernel 7 has one ctypes type per
    parameter of its C entry points, route and cluster size included."""
    with open(os.path.join(build.CSRC_DIR, "quantized_matmul.cu")) as f:
        src = f.read()
    found = dict(re.findall(r'extern "C" int (pfx_\w+)\(([^)]*)\)', src))
    assert set(found) == {"pfx_quantized_matmul", "pfx_quantized_matmul_dx",
                          "pfx_quantized_matmul_clusters"}
    for name, decl in found.items():
        assert build.SIGNATURES[name] == _c_types(decl), name
    for name in ("pfx_quantized_matmul", "pfx_quantized_matmul_dx"):
        assert "int is_bf16, int route, int splits, void* stream" in \
            " ".join(found[name].split())


class _Recorder:
    """A stand-in for the kernels' library: records each entry point's
    arguments and returns ``rc``."""

    def __init__(self, rc=0):
        self.calls, self.rc = [], rc

    def __getattr__(self, name):
        if not name.startswith("pfx_quantized_matmul"):
            raise AttributeError(name)

        def call(*args):
            self.calls.append((name, args))
            return self.rc
        return call


@pytest.fixture
def recorder(monkeypatch):
    """The recording library behind ``build.load``, no device context,
    and kernel 7's launch counts restored afterwards."""
    lib = _Recorder()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=77))
    f = qmm.quantized_matmul
    for attr in ("launches", "dx_launches"):
        monkeypatch.setattr(f, attr, 0)
    for attr in ("launches_by_route", "dx_launches_by_route"):
        monkeypatch.setattr(f, attr, dict.fromkeys(qmm.ROUTES, 0))
    return lib


@pytest.mark.parametrize("op,m,k,n,dtype", [
    ("fwd", 16, 4096, 1024, BF), ("fwd", 512, 4096, 1024, BF),
    ("fwd", 4096, 1024, 3072, BF), ("dx", 16, 1024, 3072, BF),
    ("dx", 4096, 4096, 1024, BF), ("fwd", 37, 1024, 1024, torch.float32),
    ("dx", 37, 1024, 1024, torch.float32)])
def test_wrapper_passes_the_planned_route(recorder, op, m, k, n, dtype):
    """The wrapper hands the C entry point the shape, the planned route's
    code and cluster size and the current stream, and counts the launch
    in its op's total and under its route."""
    p = qmm._enqueue(op, 11, 22, 33, 44, m, k, n, dtype, "cuda")
    assert p == qmm.plan(op, m, k, n, dtype)
    code = {"stream": 2, "wgmma": 1, "mma": 0, "f32": 0}[p.route]
    tail = (int(dtype == BF), code, p.splits, 77)
    if op == "fwd":
        want = ("pfx_quantized_matmul", (11, 22, 44, 33, m, n, k) + tail)
    else:
        want = ("pfx_quantized_matmul_dx", (11, 22, 33, m, n, k) + tail)
    assert recorder.calls == [want]
    f = qmm.quantized_matmul
    total, by_route = (f.launches, f.launches_by_route) if op == "fwd" \
        else (f.dx_launches, f.dx_launches_by_route)
    assert total == 1 and by_route == {r: int(r == p.route)
                                       for r in qmm.ROUTES}


def test_wrapper_raises_on_a_refused_launch(recorder):
    """A launch the library refuses raises and counts nothing; a named
    route reaches the library with its own code."""
    recorder.rc = 1
    with pytest.raises(RuntimeError, match="stream kernel launch failed"):
        qmm._enqueue("fwd", 1, 2, 3, 4, 129, 1024, 1024, BF, "cuda",
                     route="stream")
    assert qmm.quantized_matmul.launches == 0
    recorder.rc = 0
    qmm._enqueue("dx", 1, 2, 3, None, 16, 1024, 1024, BF, "cuda",
                 route="mma")
    assert recorder.calls[-1][1][-4:] == (1, 0, 1, 77)
    assert qmm.quantized_matmul.dx_launches_by_route["mma"] == 1


# -- on the card -----------------------------------------------------------

#: kernel 7 against its plain version in fp32 on the same inputs (outputs
#: of std ~0.5): bf16 the output's own rounding, fp32 the JAX kernel
#: test's atol (``chip_smoke.py`` ``TOL_QMM``)
TOL = {BF: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def card():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch kernel 7")
    return torch.device("cuda")


def _operands(op, m, k, n, dtype, gen, dev):
    """x (or gs), the int8 weight and the scales, with outputs of std
    ~0.5."""
    w = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                      dtype=torch.int8)
    red = k if op == "fwd" else n
    a = (torch.randn((m, red), generator=gen, device=dev) *
         (0.5 / (73.6 * red ** 0.5) if op == "dx" else 1.0)).to(dtype)
    unit = 0.5 / (73.6 * k ** 0.5)
    scale = unit * (0.75 + 0.5 * torch.rand(n, generator=gen, device=dev))
    return a, w, scale


@pytest.mark.cuda
def test_every_route_matches_plain_on_the_card(card):
    """Every route (``stream``, ``wgmma`` and ``mma`` in bf16, ``f32`` in
    fp32) launched by name at ragged M and the four site shapes, forward
    and dx, against the plain version within ``TOL``; a second launch
    gives the same bits; the stream route refuses an M above
    ``STREAM_MAX_M`` with an error, not a wrong result."""
    gen = torch.Generator(device=card).manual_seed(7)
    for op in ("fwd", "dx"):
        for site, k, n in SITES:
            for m in ROWS:
                for route, dtype in (("stream", BF), ("wgmma", BF),
                                     ("mma", BF), ("f32", torch.float32)):
                    a, w, scale = _operands(op, m, k, n, dtype, gen, card)
                    what = (op, site, m, route)
                    if op == "fwd":
                        def run():
                            return qmm._launch(a, w, scale, route=route)
                        ref = qmm.quantized_matmul_reference(a.float(), w,
                                                             scale)
                    else:
                        def run():
                            return qmm.quantized_matmul_dx(a, w,
                                                           route=route)
                        ref = qmm.quantized_matmul_dx_reference(a.float(), w)
                    if route == "stream" and m > qmm.STREAM_MAX_M:
                        with pytest.raises((ValueError, RuntimeError)):
                            run()
                        continue
                    got, again = run(), run()
                    torch.cuda.synchronize()
                    assert got.dtype == dtype and got.shape == ref.shape, what
                    assert torch.equal(got, again), what
                    err = float((got.float() - ref.float()).abs().max())
                    assert err <= TOL[dtype], (what, err)
