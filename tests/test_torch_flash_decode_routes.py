"""The decode kernels' routes (kernels 2, 5, 6a and 6b): the planner that
picks ``mma`` (bf16 queries, with its chunk and cluster size) or ``simt``
(fp32) from a call's shape, the C entry points' ctypes signatures, and
each wrapper handing the planned (or named) route to the library (a
recording stand-in here) and refusing a route that is not one. The
launches need the card: the test marked ``cuda`` holds every route and
instance against the plain version and against the exactness contract
(verify query ``j`` equals kernel 2 at ``offset + j``, a pool equals its
gathered cache, bit for bit), and skips here. This file imports no JAX,
so the card's machine runs it as it stands::

    python -m pytest --noconftest -q -m cuda tests/test_torch_flash_decode_routes.py
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
F32 = torch.float32

#: (b, w, h, S, d, dtype, int8, paged, page) -> (route, chunk, cluster) at
#: the paths' shapes: the serve tick (8 slots), the paged and spec ticks
#: (16 slots, W 5), their int8 instances, head_dim 128, short and long
#: capacities, and fp32
PLANS = [
    ((8, 1, 16, 1024, 64, BF, False, False, 0), ("mma", 128, 1)),
    ((16, 5, 16, 1024, 64, BF, False, False, 0), ("mma", 128, 1)),
    ((16, 1, 16, 1024, 64, BF, False, True, 128), ("mma", 128, 1)),
    ((16, 5, 16, 1024, 64, BF, False, True, 128), ("mma", 128, 1)),
    ((16, 5, 16, 1024, 64, BF, True, True, 128), ("mma", 128, 2)),
    ((8, 1, 16, 1024, 64, BF, True, False, 0), ("mma", 128, 2)),
    ((4, 32, 8, 512, 128, BF, False, False, 0), ("mma", 128, 1)),
    ((2, 1, 2, 160, 64, BF, True, False, 0), ("mma", 128, 1)),
    ((2, 3, 2, 2048, 64, BF, False, True, 32), ("mma", 128, 2)),
    ((2, 3, 2, 2048, 64, BF, True, True, 32), ("mma", 128, 4)),
    ((2, 1, 2, 64, 64, BF, False, False, 0), ("mma", 128, 1)),
    ((1, 17, 2, 4096, 64, BF, True, False, 0), ("mma", 128, 8)),
    ((1, 2, 2, 16384, 64, BF, False, True, 128), ("mma", 128, 8)),
    ((1, 32, 2, 16384, 128, BF, False, True, 128), ("mma", 128, 4)),
    ((8, 1, 16, 1024, 64, F32, False, False, 0), ("simt", 1024, 1)),
    ((16, 5, 16, 1024, 64, F32, True, True, 128), ("simt", 1024, 1)),
]


@pytest.mark.parametrize("call,want", PLANS)
def test_plan_decode_routes(call, want):
    """bf16 queries (bf16 or int8 cache) take ``mma`` with 128-key chunks
    in clusters of the largest power of two up to 8 (4 at head_dim 128)
    that leaves each block 8 chunks over a bf16 cache, 4 over an int8
    one (one block below that); fp32 takes ``simt``, one block over the
    capacity."""
    assert tuple(fa.plan_decode(*call)) == want


def test_split_depends_on_capacity_d_and_cache_type_alone():
    """The chunk and cluster are the same for W 1, 2, 5 and 32, any rows
    and heads, and paged or contiguous, at every capacity, head_dim and
    cache type: the split the exactness contract needs."""
    for S in (64, 128, 129, 256, 384, 1000, 1024, 2048, 4096, 16384):
        for d in (64, 128):
            for int8 in (False, True):
                got = {fa.plan_decode(b, w, h, S, d, BF, int8, paged,
                                      128 if paged else 0)[1:]
                       for b in (1, 16) for w in (1, 2, 5, 32)
                       for h in (2, 16) for paged in (False, True)}
                assert len(got) == 1, (S, d, int8, got)
                chunk, cluster = got.pop()
                assert chunk == fa.DECODE_CHUNK
                per_block = 4 if int8 else 8
                assert cluster <= max(1, min(fa.DECODE_MAX_CLUSTER * 64 // d,
                                             -(-S // chunk) // per_block))
                assert cluster & (cluster - 1) == 0


def _c_types(decl):
    """ctypes of a C parameter list: pointers (and the stream) as void*,
    ``int``, ``float``."""
    types_ = []
    for arg in decl.split(","):
        arg = " ".join(arg.split())
        if "*" in arg:
            types_.append(ctypes.c_void_p)
        elif arg.startswith("int"):
            types_.append(ctypes.c_int)
        elif arg.startswith("float"):
            types_.append(ctypes.c_float)
        else:
            raise AssertionError(f"unexpected C parameter {arg!r}")
    return types_


ENTRY_POINTS = ("pfx_flash_decode", "pfx_flash_decode_verify",
                "pfx_flash_decode_paged", "pfx_flash_decode_paged_verify")


def test_signatures_match_the_c_entry_points():
    """``build.SIGNATURES`` of the four decode entry points has one
    ctypes type per C parameter, the route and its cluster size last
    before the stream."""
    with open(os.path.join(build.CSRC_DIR, "flash_decode.cu")) as f:
        src = f.read()
    found = dict(re.findall(r'extern "C" int (pfx_\w+)\(([^)]*)\)', src))
    assert set(found) == set(ENTRY_POINTS)
    for name in ENTRY_POINTS:
        assert build.SIGNATURES[name] == _c_types(found[name]), name
        assert "int is_bf16, int route, int cluster, void* stream" in \
            " ".join(found[name].split())


class _Recorder:
    """A stand-in for the kernels' library: each decode entry point
    converts its arguments with the declared ctypes (as ctypes would at a
    real call), records them under its name and returns ``rc``."""

    def __init__(self, rc=0):
        self.calls, self.rc = [], rc

    def __getattr__(self, name):
        if name not in ENTRY_POINTS:
            raise AttributeError(name)
        argtypes = build.SIGNATURES[name]

        def call(*args):
            assert len(args) == len(argtypes), len(args)
            for a, t in zip(args, argtypes):
                t(a)   # raises on an argument the C type cannot take
            self.calls.append((name, args))
            return self.rc
        return call


WRAPPERS = ("flash_decode", "flash_decode_verify", "flash_decode_paged",
            "flash_decode_paged_verify")


@pytest.fixture
def recorder(monkeypatch):
    """The recording library behind ``build.load``, CPU tensors taken
    down the launch path with no device checks or context, and the
    decode kernels' launch counts restored afterwards."""
    lib = _Recorder()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(fa, "_on_cpu", lambda *a: False)
    monkeypatch.setattr(fa, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    for name in WRAPPERS:
        w = getattr(fa, name)
        monkeypatch.setattr(w, "launches", 0)
        monkeypatch.setattr(w, "launches_int8", 0)
        monkeypatch.setattr(w, "launches_by_route",
                            dict.fromkeys(fa.DECODE_ROUTES, 0))
    return lib


def _call(kind, dtype, int8, w=1, route=None, b=2, h=3, S=256, d=64,
          page=32):
    """One wrapper call of ``kind`` ("decode", "ragged", "verify",
    "paged", "paged_verify") on seeded CPU inputs; returns the wrapper
    whose counts it moves and the capacity."""
    g = torch.Generator().manual_seed(5)
    q = torch.randn((b, w, h, d), generator=g).to(dtype)
    paged = kind.startswith("paged")
    shape = (S // page + 1, h, page, d) if paged else (b, h, S, d)
    if int8:
        k = v = torch.zeros(shape, dtype=torch.int8)
        sc = {"k_scale": torch.ones(shape[:3]),
              "v_scale": torch.ones(shape[:3])}
    else:
        k, v = (torch.randn(shape, generator=g).to(dtype) for _ in range(2))
        sc = {}
    if route is not None:
        sc["route"] = route
    off = torch.tensor([3, 200][:b], dtype=torch.int32)
    pt = torch.arange(1, S // page + 1, dtype=torch.int32)[None].expand(
        b, -1).contiguous()
    if kind == "decode":
        fa.flash_decode(q, k, v, 7, torch.zeros((b, 1, 1, S)), **sc)
        return fa.flash_decode, S
    if kind == "ragged":
        fa.flash_decode_ragged(q, k, v, off, **sc)
        return fa.flash_decode, S
    if kind == "verify":
        fa.flash_decode_verify(q, k, v, off, **sc)
        return fa.flash_decode_verify, S
    wrapper = getattr(fa, "flash_decode_" + kind)
    wrapper(q, k, v, off, pt, **sc)
    return wrapper, S


KINDS = (("decode", 1), ("ragged", 1), ("verify", 5), ("paged", 1),
         ("paged_verify", 5))


@pytest.mark.parametrize("kind,w", KINDS)
@pytest.mark.parametrize("dtype,int8", [(BF, False), (BF, True),
                                        (F32, False), (F32, True)])
def test_wrapper_passes_the_planned_route(recorder, kind, w, dtype, int8):
    """Each wrapper hands its C entry point the planned route's code and
    cluster size before the stream, and counts the launch in its
    instance's total and under its route."""
    wrapper, S = _call(kind, dtype, int8, w)
    (name, args), = recorder.calls
    assert name == "pfx_" + wrapper.__name__
    p = fa.plan_decode(2, w, 3, S, 64, dtype, int8, kind.startswith("paged"),
                       32 if kind.startswith("paged") else 0)
    assert args[-3:] == ({"simt": 0, "mma": 1}[p.route], p.cluster, 7)
    assert p.route == ("mma" if dtype == BF else "simt")
    assert (wrapper.launches, wrapper.launches_int8) == \
        ((0, 1) if int8 else (1, 0))
    assert wrapper.launches_by_route == {
        r: int(r == p.route) for r in fa.DECODE_ROUTES}


@pytest.mark.parametrize("kind,w", KINDS)
def test_wrapper_takes_a_named_route(recorder, kind, w):
    """``route="simt"`` reaches the library as code 0 with cluster 1 and
    counts under ``simt``; a refused launch raises naming the route and
    counts nothing."""
    wrapper, _ = _call(kind, BF, False, w, route="simt")
    assert recorder.calls[-1][1][-3:] == (0, 1, 7)
    assert wrapper.launches_by_route == {"mma": 0, "simt": 1}
    recorder.rc = 1
    with pytest.raises(RuntimeError, match="mma kernel launch failed"):
        _call(kind, BF, True, w)
    assert wrapper.launches_int8 == 0


@pytest.mark.parametrize("kind,w", KINDS)
def test_wrapper_raises_on_a_bad_route(kind, w):
    """On CPU tensors too, a route that is not one, or ``mma`` for an
    fp32 query, raises before anything runs."""
    for dtype, route in ((BF, "wgmma"), (BF, "f32"), (F32, "mma"),
                         (F32, "cuda")):
        with pytest.raises(ValueError, match="route"):
            _call(kind, dtype, False, w, route=route)


# -- chip_smoke.py's checks of the decode family ----------------------------


def test_path_route_check_refuses_simt():
    """``chip_smoke.py`` passes a bf16 path whose decode launches (bf16
    and int8 instances together) are all counted under ``mma``, an fp32
    one all under ``simt``, and fails a bf16 path with a launch on
    ``simt`` or one counted under no route."""
    good = {"counters": {}}
    for name in chip_smoke.DECODE_KERNELS:
        good.update({name: 3, name + "_int8": 2,
                     name + "_routes": {"mma": 5, "simt": 0}})
    chip_smoke.check_decode_routes(good, "serve", "bfloat16")
    with pytest.raises(AssertionError, match="all simt"):
        chip_smoke.check_decode_routes(good, "serve", "float32")
    for routes in ({"mma": 4, "simt": 1}, {"mma": 4, "simt": 0}):
        bad = dict(good, flash_decode_paged_verify_routes=routes)
        with pytest.raises(AssertionError, match="all mma"):
            chip_smoke.check_decode_routes(bad, "serve_spec", "bfloat16")


def test_build_check_holds_the_decode_kernel_to_hmma():
    """``build`` fails when the decode family's mma kernel is missing
    from the SASS or an instance of it holds no ``HMMA``, and its name
    is no kernel that must hold no ``HMMA``."""
    ok = {f"_ZN_decode_kernel_mmaI{i}EEv": {"HGMMA": 0, "HMMA": 64}
          for i in range(4)}
    chip_smoke.check_hmma_sass(ok)
    with pytest.raises(AssertionError, match="missing"):
        chip_smoke.check_hmma_sass({})
    with pytest.raises(AssertionError, match="no HMMA"):
        chip_smoke.check_hmma_sass(dict(ok, _ZN_decode_kernel_mmaI9EEv={
            "HGMMA": 0, "HMMA": 0}))
    assert not any(n in "decode_kernel_mma"
                   for n in chip_smoke.NO_HMMA_KERNELS)


# -- on the card -----------------------------------------------------------

#: offsets at 0 and the chunk and tile edges, and near the end of a
#: capacity of 2048 (8 chunks for each block of a 2-block cluster over a
#: bf16 cache, 4 of a 4-block cluster over an int8 one; 2016 with
#: 48-key pages)
CARD_OFFSETS = [0, 63, 64, 127, 128, 255, 256, 1023, 1500, 2015]
CARD_CAP = 2048
CARD_WINDOWS = (1, 2, 5, 16, 17, 32)


@pytest.fixture
def card():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch the decode kernels")
    return torch.device("cuda")


def _card_inputs(dev, d, int8, page, seed):
    """Seeded q (W 32) and a pool of ``page``-key pages with its table,
    each row on its own shuffled pages (the null page 0 past each row's
    live length holds large values), and the gathered contiguous cache;
    int8 caches come with their scales."""
    from paddlefleetx_tpu_torch.models.gpt.model import quantize_kv
    g = torch.Generator(device=dev).manual_seed(seed)
    b, h = len(CARD_OFFSETS), 2
    m = CARD_CAP // page
    q = torch.randn((b, 32, h, d), generator=g, device=dev)
    perm = torch.randperm(b * m, generator=g, device=dev).to(torch.int32) + 1
    pt = perm.reshape(b, m)
    for i, o in enumerate(CARD_OFFSETS):   # pages past the window: null
        pt[i, min(o + 32, CARD_CAP - 1) // page + 1:] = 0
    pool = []
    for _ in range(2):
        f = torch.randn((b * m + 1, h, page, d), generator=g, device=dev)
        f[0] = 30.0
        pool.append(quantize_kv(f) if int8 else (f, None))
    return q, pt, pool


@pytest.mark.cuda
@pytest.mark.parametrize("d", (64, 128))
@pytest.mark.parametrize("int8", (False, True))
def test_every_route_matches_plain_and_is_exact_on_the_card(card, d, int8):
    """Every route and instance, W 1, 2, 5, 16, 17 and 32, contiguous and
    paged (page 128, and 48: tiles that span pages), bf16 (``mma`` and
    ``simt``) and fp32 (``simt``) queries: within ``chip_smoke.py``'s
    ``TOL`` of the plain version, the same output on a second launch,
    verify query ``j`` equal to kernel 2 at ``offset + j`` and a pool
    equal to its gathered cache, bit for bit, on each route; the planned
    route counted."""
    off = torch.tensor(CARD_OFFSETS, dtype=torch.int32, device=card)
    for page in (128, 48):
        q32, pt, ((k, ks), (v, vs)) = _card_inputs(card, d, int8, page,
                                                  d + page)
        gather = (lambda t: None if t is None else fa.gather_kv_pages(t, pt))
        kc, vc, ksc, vsc = (gather(t) for t in (k, v, ks, vs))
        for dtype, routes in ((BF, ("mma", "simt")), (F32, ("simt",))):
            qd = q32.to(dtype)
            if not int8:
                kd, vd, kcd, vcd = (t.to(dtype) for t in (k, v, kc, vc))
            else:
                kd, vd, kcd, vcd = k, v, kc, vc
            sc = {"k_scale": ks, "v_scale": vs} if int8 else {}
            scc = {"k_scale": ksc, "v_scale": vsc} if int8 else {}
            for route in routes:
                # kernel 2 at offset + j, query j of the window
                one = [fa.flash_decode_ragged(
                    qd[:, j:j + 1].contiguous(), kcd, vcd, off + j,
                    route=route, **scc) for j in range(32)]
                for w in CARD_WINDOWS:
                    q = qd[:, :w].contiguous()
                    what = (d, int8, page, dtype, route, w)
                    if w == 1:
                        contig = fa.flash_decode_ragged(q, kcd, vcd, off,
                                                        route=route, **scc)
                        again = fa.flash_decode_ragged(q, kcd, vcd, off,
                                                       route=route, **scc)
                        pooled = fa.flash_decode_paged(q, kd, vd, off, pt,
                                                       route=route, **sc)
                    else:
                        contig = fa.flash_decode_verify(q, kcd, vcd, off,
                                                        route=route, **scc)
                        again = fa.flash_decode_verify(q, kcd, vcd, off,
                                                       route=route, **scc)
                        pooled = fa.flash_decode_paged_verify(
                            q, kd, vd, off, pt, route=route, **sc)
                    torch.cuda.synchronize()
                    ref = fa.flash_decode_reference(
                        q.float(), kcd if int8 else kcd.float(),
                        vcd if int8 else vcd.float(), off, None, ksc, vsc)
                    err = float((contig.float() - ref).abs().max())
                    tol = chip_smoke.TOL[chip_smoke._dtype_name(dtype)]
                    assert torch.isfinite(contig.float()).all(), what
                    assert err <= tol, (what, err)
                    assert torch.equal(contig, again), what
                    assert torch.equal(pooled, contig), what
                    for j in range(w):
                        assert torch.equal(contig[:, j], one[j][:, 0]), \
                            (what, j)
        # the planned route of each entry point is counted
        for wrapper, call in (
                (fa.flash_decode_verify, lambda: fa.flash_decode_verify(
                    q32[:, :5].to(BF).contiguous(), kc.to(BF) if not int8
                    else kc, vc.to(BF) if not int8 else vc, off, **scc)),
                (fa.flash_decode_paged, lambda: fa.flash_decode_paged(
                    q32[:, :1].to(BF).contiguous(), k.to(BF) if not int8
                    else k, v.to(BF) if not int8 else v, off, pt, **sc))):
            before = dict(wrapper.launches_by_route)
            call()
            now = wrapper.launches_by_route
            assert {r: now[r] - before[r] for r in now} == {"mma": 1,
                                                            "simt": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("int8", (False, True))
def test_shared_offset_with_bias_on_the_card(card, int8):
    """Kernel 2's shared-offset entry with a left-pad bias, on both bf16
    routes, within ``TOL`` of the plain version."""
    from paddlefleetx_tpu_torch.models.gpt.model import quantize_kv
    g = torch.Generator(device=card).manual_seed(11)
    b, h, S, d = 4, 2, 1024, 64
    q = torch.randn((b, 1, h, d), generator=g, device=card).to(BF)
    kv = [torch.randn((b, h, S, d), generator=g, device=card)
          for _ in range(2)]
    if int8:
        (k, ks), (v, vs) = (quantize_kv(t) for t in kv)
    else:
        (k, v), ks, vs = (t.to(BF) for t in kv), None, None
    pad = torch.tensor([0, 3, 17, 100], device=card)
    bias = torch.where(torch.arange(S, device=card)[None, :] < pad[:, None],
                       -1e9, 0.0)[:, None, None, :]
    sc = {"k_scale": ks, "v_scale": vs} if int8 else {}
    ref = fa.flash_decode_reference(q.float(), k if int8 else k.float(),
                                    v if int8 else v.float(), 700, bias,
                                    ks, vs)
    for route in fa.DECODE_ROUTES:
        out = fa.flash_decode(q, k, v, 700, bias, route=route, **sc)
        torch.cuda.synchronize()
        err = float((out.float() - ref).abs().max())
        assert err <= chip_smoke.TOL["bfloat16"], (route, err)


@pytest.mark.cuda
@pytest.mark.parametrize("d", (64, 128))
@pytest.mark.parametrize("int8", (False, True))
def test_long_capacity_on_the_card(card, d, int8):
    """At capacity 8192 (clusters of 8 at head_dim 64, of 4 at 128, each
    block walking several chunks): W 32 within ``TOL`` of the plain
    version and each query equal to kernel 2 at ``offset + j``, bit for
    bit."""
    from paddlefleetx_tpu_torch.models.gpt.model import quantize_kv
    g = torch.Generator(device=card).manual_seed(d + int8)
    S, h = 8192, 2
    off = torch.tensor([0, 130, 4095, 8160], dtype=torch.int32, device=card)
    b = off.numel()
    q = torch.randn((b, 32, h, d), generator=g, device=card).to(BF)
    kv = [torch.randn((b, h, S, d), generator=g, device=card)
          for _ in range(2)]
    if int8:
        (k, ks), (v, vs) = (quantize_kv(t) for t in kv)
        sc = {"k_scale": ks, "v_scale": vs}
    else:
        (k, v), ks, vs, sc = (t.to(BF) for t in kv), None, None, {}
    assert fa.plan_decode(b, 32, h, S, d, BF, int8, False, 0).cluster == \
        (8 if d == 64 else 4)
    out = fa.flash_decode_verify(q, k, v, off, **sc)
    ref = fa.flash_decode_reference(q.float(), k if int8 else k.float(),
                                    v if int8 else v.float(), off, None,
                                    ks, vs)
    torch.cuda.synchronize()
    assert float((out.float() - ref).abs().max()) <= \
        chip_smoke.TOL["bfloat16"]
    for j in range(32):
        one = fa.flash_decode_ragged(q[:, j:j + 1].contiguous(), k, v,
                                     off + j, **sc)
        assert torch.equal(out[:, j], one[:, 0]), j
