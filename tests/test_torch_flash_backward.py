"""The gradient of the port's ``flash_attention`` (kernels 3 and 4 on the
card, their plain version ``flash_attention_backward_reference`` here)
against the JAX package's backward kernels, and against autograd.

The JAX side runs its Pallas backward in interpret mode; each case
takes the shape that makes ``_flash_backward`` pick one of its three
regimes: ``_bwd_combined_kernel`` (one q block), the split pair
``_bwd_dkv_kernel`` + ``_bwd_dq_kernel`` (several q blocks and a bias)
and ``_bwd_fused_kernel`` (several q blocks, no bias, no dropout). The
port reaches its plain backward through ``torch.autograd`` of
``flash_attention``, as training does. Tolerance: 2e-5 abs on fp32
inputs (both sides sum in fp32, in another order).

The wrapper's arguments are held to the C entry points' signatures on
the CPU; the launches need the card: their test is marked ``cuda`` and
skips here. JAX is imported inside the tests that use it, so that the
``cuda`` test runs on a machine with the card and without JAX::

    python -m pytest --noconftest -q -m cuda tests/test_torch_flash_backward.py
"""

import contextlib
import ctypes
import os
import re

import numpy as np
import pytest
import torch

from paddlefleetx_tpu_torch.ops.cuda import build
from paddlefleetx_tpu_torch.ops.cuda import flash_attention as fa
from paddlefleetx_tpu_torch.ops.cuda import philox

rng = np.random.default_rng

TOL = 2e-5


def _jax():
    """``(jax, jax.numpy, the JAX package's flash_attention module)``."""
    import jax
    import jax.numpy as jnp
    from paddlefleetx_tpu.ops.pallas import flash_attention as jax_fa
    return jax, jnp, jax_fa


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("PFX_PALLAS_INTERPRET", "1")


def _inputs(seed, b, s, h, d=64):
    r = rng(seed)
    return [r.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(4)]


def _port_grads(q, k, v, g_out, causal, bias=None, g_lse=None,
                rate=0.0, seed=None, dtype=torch.float32):
    t = [torch.tensor(x, dtype=dtype, requires_grad=True)
         for x in (q, k, v)]
    out, lse = fa.flash_attention(
        *t, causal=causal,
        bias=None if bias is None else torch.tensor(bias, dtype=dtype),
        dropout_rate=rate, seed=seed)
    loss = (out * torch.tensor(g_out, dtype=dtype)).sum()
    if g_lse is not None:
        loss = loss + (lse * torch.tensor(g_lse, dtype=dtype)).sum()
    return torch.autograd.grad(loss, t)


# (s, block, bias): the regime _flash_backward picks for it
REGIMES = {
    "combined": (128, None, False),   # num_q == 1 -> _bwd_combined_kernel
    "split": (256, 128, True),        # bias -> _bwd_dkv + _bwd_dq
    "fused": (1024, 512, False),      # num_q 2, no bias -> _bwd_fused
}


@pytest.mark.parametrize("regime,causal", [
    ("combined", True), ("combined", False), ("split", True),
    ("split", False), ("fused", True), ("fused", False)])
def test_backward_matches_each_jax_regime(regime, causal):
    jax, jnp, jax_fa = _jax()
    s, block, with_bias = REGIMES[regime]
    b, h = (2, 2) if s < 1024 else (1, 1)
    q, k, v, g_out = _inputs(s + int(causal), b, s, h)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    if with_bias:
        pads = rng(s).integers(0, 9, size=b)
        bias = np.where(np.arange(s)[None, :] >= pads[:, None], 0.0,
                        -1e9).astype(np.float32)[:, None, None, :]
        _, vjp = jax.vjp(lambda a, bb, c: jax_fa.flash_attention(
            a, bb, c, causal=causal, block_q=block, block_kv=block,
            bias=jnp.asarray(bias)), jq, jk, jv)
        want = vjp(jnp.asarray(g_out))
        got = _port_grads(q, k, v, g_out, causal, bias=bias)
    else:
        g_lse = rng(s + 7).standard_normal((b, h, s)).astype(np.float32)
        _, vjp = jax.vjp(lambda a, bb, c: jax_fa.flash_attention_with_lse(
            a, bb, c, causal=causal, block_q=block, block_kv=block),
            jq, jk, jv)
        want = vjp((jnp.asarray(g_out), jnp.asarray(g_lse)))
        got = _port_grads(q, k, v, g_out, causal, g_lse=g_lse)
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=TOL,
                                   err_msg=f"d{name} ({regime})")


def test_regime_shapes_pick_the_intended_jax_kernels():
    """The shapes above do reach the three JAX regimes: one q block for
    s=128 at the default blocks, several for the other two, and the
    fused kernel takes s=1024 at 512 blocks."""
    _, jnp, jax_fa = _jax()
    assert jax_fa.check_shapes(128, 128, 64) == (128, 128)
    assert jax_fa.check_shapes(256, 256, 64, 128, 128) == (128, 128)
    z = jnp.zeros((1, 1024, 64), jnp.float32)
    r = jnp.zeros((1, 1024, 1), jnp.float32)
    assert jax_fa._flash_backward_fused(z, z, z, z, r, r, 1.0, True,
                                        0) is not None


@pytest.mark.parametrize("causal,with_bias", [(True, False), (True, True),
                                              (False, True)])
def test_backward_with_dropout_equals_autograd_in_fp64(causal, with_bias):
    """The explicit-formula backward equals autograd of the plain forward
    in fp64, with dropout 0.1 and the same Philox mask, and with a
    nonzero lse cotangent (1e-10)."""
    b, s, h, d = 2, 37, 2, 16
    r = rng(3)
    q, k, v, g_out = (r.standard_normal((b, s, h, d)) for _ in range(4))
    g_lse = r.standard_normal((b, h, s))
    bias = r.standard_normal((b, 1, 1, s)) if with_bias else None
    t = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    bt = None if bias is None else torch.tensor(bias)
    out, lse = fa.flash_attention_reference(*t, causal, bt, 0.1, 99)
    loss = (out * torch.tensor(g_out)).sum() + \
        (lse * torch.tensor(g_lse)).sum()
    want = torch.autograd.grad(loss, t)
    got = _port_grads(q, k, v, g_out, causal, bias=bias, g_lse=g_lse,
                      rate=0.1, seed=99, dtype=torch.float64)
    for a, w in zip(got, want):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=1e-10)


def test_backward_counts_no_launch_on_cpu_and_rejects_bad_inputs():
    q = torch.zeros(1, 8, 2, 64)
    before = (fa.flash_attention_backward.launches_dkv,
              fa.flash_attention_backward.launches_dq)
    o, lse = fa.flash_attention(q, q, q)
    fa.flash_attention_backward(q, q, q, o, lse, q)
    assert (fa.flash_attention_backward.launches_dkv,
            fa.flash_attention_backward.launches_dq) == before
    with pytest.raises(ValueError):
        fa.flash_attention_backward(q, q, q, o, lse, q, dropout_rate=0.1)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q, dropout_rate=1.0, seed=1)
    assert philox.keep_threshold(0.1) == round(0.9 * 2 ** 32)


def _c_types(decl):
    """ctypes of a C parameter list: pointers (and the stream) as
    void*, ``long long``, ``unsigned long long``, ``unsigned int``,
    ``int``, ``float``."""
    types = []
    for arg in decl.split(","):
        arg = " ".join(arg.split())
        if "*" in arg:
            types.append(ctypes.c_void_p)
        elif arg.startswith("unsigned long long"):
            types.append(ctypes.c_ulonglong)
        elif arg.startswith("long long"):
            types.append(ctypes.c_longlong)
        elif arg.startswith("unsigned int"):
            types.append(ctypes.c_uint)
        elif arg.startswith("int"):
            types.append(ctypes.c_int)
        elif arg.startswith("float"):
            types.append(ctypes.c_float)
        else:
            raise AssertionError(f"unexpected C parameter {arg!r}")
    return types


def test_signatures_match_the_c_entry_points():
    """``build.SIGNATURES`` of kernels 3 and 4 has one ctypes type per
    parameter of their C entry points."""
    with open(os.path.join(build.CSRC_DIR, "flash_bwd.cu")) as f:
        src = f.read()
    found = dict(re.findall(r'extern "C" int (pfx_\w+)\(([^)]*)\)', src))
    assert set(found) == {"pfx_flash_bwd_dkv", "pfx_flash_bwd_dq"}
    for name, decl in found.items():
        assert build.SIGNATURES[name] == _c_types(decl), name


class _Recorder:
    """Stands in for the kernels' library: each entry point of
    ``build.SIGNATURES`` converts its arguments with the declared ctypes
    (as ctypes would at a real call) and records them."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        argtypes = build.SIGNATURES[name]

        def call(*args):
            assert len(args) == len(argtypes), (name, len(args))
            for a, t in zip(args, argtypes):
                t(a)   # raises on an argument the C type cannot take
            self.calls.append((name, args))
            return 0
        return call


@pytest.mark.parametrize("dtype,rate,with_bias", [
    (torch.bfloat16, 0.1, False), (torch.float32, 0.0, True)])
def test_wrapper_arguments_match_the_c_entry_points(monkeypatch, dtype,
                                                    rate, with_bias):
    """``_launch_backward`` calls each C entry point once, with one
    argument of the declared type per parameter, in the declared order:
    the tensors' pointers, the outputs, the shape, the bias strides, the
    scale, causal, the dtype flag, the dropout arguments and the stream;
    each call counts one launch."""
    lib = _Recorder()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(fa, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None:
                        type("Stream", (), {"cuda_stream": 7})())
    b, sq, skv, h, d = 2, 40, 24, 3, 64
    r = rng(5)
    q, do, o = (torch.tensor(r.standard_normal((b, sq, h, d)), dtype=dtype)
                for _ in range(3))
    k, v = (torch.tensor(r.standard_normal((b, skv, h, d)), dtype=dtype)
            for _ in range(2))
    lse = torch.zeros((b, h, sq))
    bias = torch.zeros((b, 1, 1, skv)) if with_bias else None
    before = (fa.flash_attention_backward.launches_dkv,
              fa.flash_attention_backward.launches_dq)
    dq, dk, dv = fa._launch_backward(q, k, v, o, lse, do, None, False, bias,
                                     rate, 11 if rate else None)
    assert (fa.flash_attention_backward.launches_dkv,
            fa.flash_attention_backward.launches_dq) == (before[0] + 1,
                                                         before[1] + 1)
    assert [n for n, _ in lib.calls] == ["pfx_flash_bwd_dkv",
                                         "pfx_flash_bwd_dq"]
    (_, dkv_args), (_, dq_args) = lib.calls
    assert dkv_args[0] == q.data_ptr() and dkv_args[7] == dk.data_ptr() \
        and dkv_args[8] == dv.data_ptr() and dq_args[7] == dq.data_ptr()
    assert dkv_args[6] == (bias.data_ptr() if with_bias else None)
    # b, h, sq, skv, d, then the bias strides ([b, 1, 1, skv]: batch only)
    assert dkv_args[9:17] == (b, h, sq, skv, d, skv if with_bias else 0,
                              0, 0)
    assert dkv_args[9:] == dq_args[8:]
    assert dkv_args[17] == pytest.approx(d ** -0.5)
    assert dkv_args[18:21] == (0, int(dtype == torch.bfloat16), int(rate > 0))
    if rate:
        assert dkv_args[21:24] == (philox.keep_threshold(rate),
                                   pytest.approx(philox.keep_scale(rate)),
                                   11)
    assert dkv_args[-1] == 7
    assert dq.shape == q.shape and dk.shape == k.shape and dv.dtype == dtype


#: (sq, skv, d, causal, bias, dropout): ragged lengths (not multiples of
#: the kernels' 64-row tiles or 128-row blocks), both head dims, and
#: sq != skv in both directions
CARD_CASES = (
    (200, 200, 64, True, False, 0.1),
    (200, 200, 128, False, True, 0.0),
    (1000, 1000, 64, False, True, 0.1),
    (1000, 1000, 128, True, False, 0.1),
    (1000, 1000, 64, True, True, 0.0),
    (200, 1000, 64, False, False, 0.1),
    (1000, 200, 128, True, False, 0.0),
)


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    """Kernels 3 and 4 launched on the card at ragged shapes, bf16 (the
    wgmma kernels) and one fp32 case, against the plain backward in fp32
    on the same inputs (q, k, v, dO and kernel 1's O and lse), held as
    ``chip_smoke.py`` holds them (bf16: max abs error over the largest
    |gradient| within 1e-2; fp32: 1e-4 abs); each call counts one launch
    of each kernel and gives the same bits when launched again."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch kernels 3 and 4")
    cases = [c + (torch.bfloat16,) for c in CARD_CASES]
    cases.append((200, 200, 64, True, True, 0.1, torch.float32))
    for i, (sq, skv, d, causal, with_bias, rate, dtype) in enumerate(cases):
        g = torch.Generator(device="cuda").manual_seed(i)
        b, h = 2, 3
        q, do = (torch.randn((b, sq, h, d), generator=g, device="cuda")
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn((b, skv, h, d), generator=g, device="cuda")
                .to(dtype) for _ in range(2))
        bias = None
        if with_bias:
            bias = torch.where(torch.arange(skv, device="cuda") < 7, -1e9,
                               0.0)[None, None, None, :].expand(
                                   b, 1, 1, skv).contiguous()
        seed = 50 + i if rate else None
        o, lse = fa.flash_attention(q, k, v, causal, bias, rate, seed)
        before = (fa.flash_attention_backward.launches_dkv,
                  fa.flash_attention_backward.launches_dq)
        got = fa.flash_attention_backward(q, k, v, o, lse, do, None, causal,
                                          bias, rate, seed)
        again = fa.flash_attention_backward(q, k, v, o, lse, do, None,
                                            causal, bias, rate, seed)
        torch.cuda.synchronize()
        assert (fa.flash_attention_backward.launches_dkv,
                fa.flash_attention_backward.launches_dq) == (before[0] + 2,
                                                             before[1] + 2)
        ref = fa.flash_attention_backward_reference(
            q.float(), k.float(), v.float(), o.float(), lse, do.float(),
            None, causal, bias, rate, seed)
        what = (sq, skv, d, causal, with_bias, rate, dtype)
        scale = max(float(r.abs().max()) for r in ref)
        for name, a, a2, r in zip(("dq", "dk", "dv"), got, again, ref):
            assert a.shape == r.shape and a.dtype == dtype, (name, what)
            assert torch.equal(a, a2), (name, what)
            err = float((a.float() - r).abs().max())
            if dtype == torch.bfloat16:
                assert err / scale <= 1e-2, (name, what, err, scale)
            else:
                assert err <= 1e-4, (name, what, err)
