#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddlefleetx_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``paddlefleetx_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version on the card at the
serving path's shapes, by max abs error and normwise per head, and
shows each check would refuse the output with one tile zeroed (and
times kernel, plain version, a library call and the kernel's bound),
serves GPT-345M (full width, 24 layers, bf16,
weights from a seed) through ``GenerationServer`` with the launch
counters reset just before and read just after, profiles one admission
step and 16 decode ticks (device kernel time by category, idle share),
runs the ``serve`` entry point with the recipe's sampling, checks the
fp32 server against the lockstep ``generate()`` and the kernel path
against the dense PyTorch path token for token, and runs the
``generate`` entry point. Then training: kernel 1 with in-kernel
dropout and the backward kernels 3 and 4 against their plain versions
(at the 345M recipe's shape, with a bias, and at s = 4096), the 345M
pretraining recipe as written (bf16, dropout, ``save_dots``, chunked
loss, batch 8 x 1024) for 30 steps through ``cli.train_main`` with the
counts reset just before and read just after, one profiled training
step, fp32 gradients and two steps through the kernels against the
dense path from non-uniform attention (and refused with dQ planted
wrong), and a
save / resume through the ``train`` entry point. Each phase prints one
JSON object per line;
the ``kernels`` line and the card's name and power limit come before
the last line, which is ``{"ok": true, "device": {...}}``. Any failure
raises, so the exit code is non-zero and the last line is not printed.
Without a CUDA device, or without the package beside it, it exits
non-zero at once. Long output goes to ``chiprun_out/chip_smoke/``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "nlp", "gpt",
                      "generation_gpt_345M_single_card.yaml")
TRAIN_CONFIG = os.path.join(ROOT, "configs", "nlp", "gpt",
                            "pretrain_gpt_345M_single_card.yaml")
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")

#: H100 SXM published peaks (NVIDIA data sheet; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
FP32_CUDA_CORE_FLOPS = 67e12

#: kernel-vs-plain tolerances, max abs error against the plain version
#: run in fp32 on the same inputs: bf16 covers the output's own rounding
#: to bf16 (half an ulp, 7.8e-3 for a value in [2, 4)) and kernel 1's
#: bf16 probabilities in its P.V product; fp32 covers summation order
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
#: kernel 1 with dropout: kept probabilities are scaled by 1 / 0.9, so the
#: outputs of the first rows (few live keys) reach [4, 8), where half a
#: bf16 ulp is 1.6e-2, on top of the bf16 P operand; fp32 as above
TOL_DROPOUT = {"bfloat16": 4e-2, "float32": 2e-5}
#: kernels 3 and 4 against the plain backward run in fp32 on the same
#: inputs: bf16 as max abs error over the largest |gradient| (bf16 P and
#: dS operands and bf16 outputs, ~2^-8 relative each); fp32 max abs
TOL_BWD = {"bfloat16": 1e-2, "float32": 1e-4}
#: every kernel-vs-plain case is also held normwise: the worst (batch,
#: head)'s ||kernel - plain||_2 / ||plain||_2, which late rows and keys
#: (small values, under any max-abs tolerance) move as much as early
#: ones. On the H100, bf16 cases read 1.8e-3 to 2.6e-3 and fp32 ones at
#: most 5.7e-7, while one zeroed 64-row tile in the middle of one head
#: reads 0.024 to 1.0: the bf16 limit sits ~3x from both
TOL_REL_L2 = {"bfloat16": 8e-3, "float32": 1e-5}
#: rows of the tile that the planted faults zero (one kernel block)
TILE = 64


def emit(obj) -> None:
    """Print one JSON object on a line of its own."""
    print(json.dumps(obj), flush=True)


def kernel_events(prof, label):
    """The device kernel events (``ts``, ``dur`` in us, ``name``) of a
    finished ``torch.profiler`` run, read from its Chrome trace, which
    is written to ``chiprun_out/chip_smoke/trace_<label>.json``."""
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, f"trace_{label}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return [e for e in json.load(f).get("traceEvents", [])
                if e.get("cat") == "kernel" and "dur" in e]


#: spin lengths (GPU clock cycles, ~5 ms and up at H100 clocks) that
#: ``time_ms`` queues ahead of the timed calls, tried in turn
SPIN_CYCLES = (10_000_000, 40_000_000, 160_000_000, 640_000_000)


def time_ms(fn, n_sets: int, iters: int = 20, warmup: int = 3):
    """``(device_ms, call_ms)`` of ``fn(i)`` over ``iters`` calls that
    rotate through ``n_sets`` input sets (several sets so that a
    cache-sized working set is not served from L2), both by CUDA events.

    ``device_ms`` is the device's time per call: the calls are queued
    behind a spin kernel (``torch.cuda._sleep``), so the host's launches
    run ahead and the events around them time the device's work alone.
    The spin is lengthened until the start event is still pending once
    the last call has been queued (the host stayed ahead); should no
    spin in ``SPIN_CYCLES`` be long enough, the last span stands, host
    gaps included. ``call_ms`` is the time per call of back-to-back
    calls with nothing queued ahead, which also holds the host's launch
    cost where that is the larger."""
    import torch
    for i in range(warmup):
        fn(i % n_sets)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_sets)
    end.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(end) / iters
    for cycles in SPIN_CYCLES:
        torch.cuda._sleep(cycles)
        start.record()
        for i in range(iters):
            fn(i % n_sets)
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            break
    return start.elapsed_time(end) / iters, call_ms


def card_line() -> str:
    """``name, power.limit`` of GPU 0 as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _rel_l2(a, ref) -> float:
    """The worst (batch, head)'s ``||a - ref||_2 / ||ref||_2`` of two
    ``[b, s, h, d]`` tensors."""
    diff = (a.float() - ref.float()).pow(2).sum(dim=(1, 3)).sqrt()
    norm = ref.float().pow(2).sum(dim=(1, 3)).sqrt().clamp_min(1e-30)
    return float((diff / norm).max())


def _zero_tile(t, head=0):
    """A copy of ``[b, s, h, d]`` ``t`` with the ``TILE`` rows at the
    middle of the sequence zeroed in batch 0, ``head`` (all heads when
    None): a planted fault, one kernel block that wrote nothing."""
    t = t.clone()
    lo = (t.shape[1] // 2) // TILE * TILE
    if head is None:
        t[:, lo:lo + TILE] = 0
    else:
        t[0, lo:lo + TILE, head] = 0
    return t


def _hold_normwise(out, ref, what):
    """``(reading, planted)``: the normwise error of the output ``out``
    against ``ref``, which must be within ``TOL_REL_L2`` of ``out``'s
    dtype, and that of ``out`` with one tile zeroed, which must not be
    (else the check could not see a skipped block)."""
    tol = TOL_REL_L2[_dtype_name(out.dtype)]
    reading = _rel_l2(out, ref)
    planted = _rel_l2(_zero_tile(out), ref)
    if not reading <= tol < planted:
        raise AssertionError(
            f"{what}: normwise error {reading:.3e} (planted fault "
            f"{planted:.3e}) is not within {tol:.0e} < planted")
    return reading, planted


# -- kernel 1: flash attention forward --------------------------------


def _fwd_bound(b, h, sq, skv, d, itemsize, causal, has_bias):
    """(bound_ms, bound_by) of one forward call: the larger of its bytes
    (q, k, v, bias read once; O and lse written once) over HBM and its
    products' FLOPs over the peak for its type (bf16 tensor cores; fp32
    CUDA cores, since TF32 is off)."""
    pairs = sum(min(i + 1, skv) for i in range(sq)) if causal else sq * skv
    flops = 4.0 * b * h * d * pairs
    nbytes = (b * sq * h * d + 2 * b * skv * h * d) * itemsize \
        + b * sq * h * d * itemsize + b * h * sq * 4 \
        + (b * skv * 4 if has_bias else 0)
    peak = BF16_TENSOR_FLOPS if itemsize == 2 else FP32_CUDA_CORE_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def fwd_case(fa, torch, dtype, b, h, s, d, with_bias, seed, n_sets=4):
    """Kernel 1 against its plain version (and SDPA, timed only) on one
    shape; returns the case record."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(seed)
    sets = []
    for _ in range(n_sets):
        q, k, v = (torch.randn((b, s, h, d), generator=g, device="cuda",
                               dtype=torch.float32).to(dtype)
                   for _ in range(3))
        bias = None
        if with_bias:
            # a left-pad style mask: the first few keys of some rows
            # are dropped with -1e9
            pad = torch.randint(0, max(1, s // 4), (b,), generator=g,
                                device="cuda")
            bias = torch.where(
                torch.arange(s, device="cuda")[None, :] < pad[:, None],
                -1e9, 0.0).to(torch.float32)[:, None, None, :]
        sets.append((q, k, v, bias))
    q, k, v, bias = sets[0]
    out, lse = fa.flash_attention(q, k, v, causal=True, bias=bias)
    torch.cuda.synchronize()
    ref_o, ref_lse = fa.flash_attention_reference(q.float(), k.float(),
                                                  v.float(), True, bias)
    err = max(_max_err(out, ref_o), _max_err(lse, ref_lse))
    if not (torch.isfinite(out.float()).all() and torch.isfinite(lse).all()):
        raise AssertionError(f"flash_attention: non-finite output "
                             f"({dtype}, b={b}, s={s}, bias={with_bias})")
    tol = TOL[str(dtype).split(".")[-1]]
    if err > tol:
        raise AssertionError(
            f"flash_attention disagrees with its plain version: max abs "
            f"err {err:.3e} > {tol:.0e} ({dtype}, b={b}, h={h}, s={s}, "
            f"bias={with_bias})")
    rel_l2, planted = _hold_normwise(out, ref_o, f"flash_attention ({dtype}"
                                     f", b={b}, s={s}, bias={with_bias})")
    ms, call_ms = time_ms(lambda i: fa.flash_attention(
        *sets[i][:3], True, sets[i][3]), n_sets)
    plain_ms, _ = time_ms(lambda i: fa.flash_attention_reference(
        *sets[i][:3], True, sets[i][3]), n_sets, iters=5)
    tsets = []
    for q, k, v, bias in sets:
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = None
        if bias is not None:
            causal = torch.triu(torch.full((s, s), float("-inf"),
                                           device="cuda"), 1)
            mask = (causal + bias).to(dtype)
        tsets.append((qt, kt, vt, mask))
    library_ms, _ = time_ms(lambda i: F.scaled_dot_product_attention(
        *tsets[i][:3], attn_mask=tsets[i][3],
        is_causal=tsets[i][3] is None), n_sets)
    bound_ms, bound_by = _fwd_bound(b, h, s, s, d, q.element_size(), True,
                                    with_bias)
    return {"dtype": str(dtype).split(".")[-1], "b": b, "h": h, "s": s,
            "d": d, "bias": with_bias, "max_abs_err": err, "tol": tol,
            "rel_l2": rel_l2, "rel_l2_planted": planted,
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


# -- kernel 2: flash decode -------------------------------------------


def _decode_bound(offsets, h, S, d, itemsize, has_bias):
    """(bound_ms, bound_by) of one decode call over these offsets: the
    live K and V rows (plus q, O and the live bias) over HBM, against
    the products' FLOPs over the peak for the type."""
    b = len(offsets)
    live = sum(min(o, S - 1) + 1 for o in offsets)
    nbytes = 2 * h * d * itemsize * live + 2 * b * h * d * itemsize \
        + (4 * live if has_bias else 0)
    flops = 4.0 * h * d * live
    peak = BF16_TENSOR_FLOPS if itemsize == 2 else FP32_CUDA_CORE_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def decode_case(fa, torch, dtype, offsets, h, S, d, shared_bias, seed,
                n_sets=4):
    """Kernel 2 against its plain version (and SDPA, timed only): the
    ragged entry point over ``offsets``, or with ``shared_bias`` the
    shared-offset entry point at ``max(offsets)`` with a left-pad
    bias."""
    import torch.nn.functional as F
    b = len(offsets)
    g = torch.Generator(device="cuda").manual_seed(seed)
    off_t = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    shared = max(offsets)
    sets = []
    for _ in range(n_sets):
        q = torch.randn((b, 1, h, d), generator=g, device="cuda").to(dtype)
        k, v = (torch.randn((b, h, S, d), generator=g, device="cuda")
                .to(dtype) for _ in range(2))
        bias = None
        if shared_bias:
            pad = torch.randint(0, 16, (b,), generator=g, device="cuda")
            bias = torch.where(
                torch.arange(S, device="cuda")[None, :] < pad[:, None],
                -1e9, 0.0).to(torch.float32)[:, None, None, :]
        sets.append((q, k, v, bias))

    def kernel(i):
        q, k, v, bias = sets[i]
        if shared_bias:
            return fa.flash_decode(q, k, v, shared, bias)
        return fa.flash_decode_ragged(q, k, v, off_t)

    def plain(i, upcast=False):
        q, k, v, bias = (t.float() if upcast and t is not None else t
                         for t in sets[i])
        return fa.flash_decode_reference(
            q, k, v, shared if shared_bias else off_t, bias)

    out = kernel(0)
    torch.cuda.synchronize()
    ref = plain(0, upcast=True)
    err = _max_err(out, ref)
    tol = TOL[str(dtype).split(".")[-1]]
    if not torch.isfinite(out.float()).all() or err > tol:
        raise AssertionError(
            f"flash_decode disagrees with its plain version: max abs err "
            f"{err:.3e} > {tol:.0e} ({dtype}, offsets={offsets}, "
            f"shared_bias={shared_bias})")
    rel_l2, planted = _hold_normwise(out, ref, f"flash_decode ({dtype}, "
                                     f"shared_bias={shared_bias})")
    ms, call_ms = time_ms(kernel, n_sets)
    plain_ms, _ = time_ms(plain, n_sets, iters=5)
    pos = torch.arange(S, device="cuda")
    offs = torch.full((b,), shared, device="cuda") if shared_bias else off_t
    mask = (pos[None, :] <= offs[:, None])[:, None, None, :]
    tsets = []
    for q, k, v, bias in sets:
        m = torch.zeros(mask.shape, device="cuda").masked_fill(
            ~mask, float("-inf"))
        if bias is not None:
            m = m + bias
        tsets.append((q.transpose(1, 2), k, v, m.to(dtype)))
    library_ms, _ = time_ms(lambda i: F.scaled_dot_product_attention(
        tsets[i][0], tsets[i][1], tsets[i][2], attn_mask=tsets[i][3]),
        n_sets)
    eff = [shared] * b if shared_bias else list(offsets)
    bound_ms, bound_by = _decode_bound(eff, h, S, d,
                                       sets[0][0].element_size(),
                                       shared_bias)
    return {"dtype": str(dtype).split(".")[-1], "b": b, "h": h, "S": S,
            "d": d, "offsets": offsets, "shared_offset_bias": shared_bias,
            "max_abs_err": err, "tol": tol, "rel_l2": rel_l2,
            "rel_l2_planted": planted, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_build():
    """Build both kernels from csrc/ (timed) and save the compiler's
    report."""
    from paddlefleetx_tpu_torch.ops.cuda import build
    t0 = time.time()
    build.load()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "nvcc.log"), "w") as f:
        f.write(str(build.last_build.get("log", "")))
    emit({"phase": "build", "seconds": round(time.time() - t0, 3),
          "nvcc_seconds": build.last_build.get("seconds"),
          "library": os.path.relpath(str(build.last_build.get("path")),
                                     ROOT)})


def phase_kernels():
    """Kernel-vs-plain phases of both kernels; returns the per-kernel
    case lists (the first case of each is the serving path's shape:
    one admission's prefill at the median bucket, one decode tick over
    eight slots)."""
    import torch
    from paddlefleetx_tpu_torch.ops.cuda import flash_attention as fa
    fwd = [fwd_case(fa, torch, torch.bfloat16, 1, 16, s, 64, False, s)
           for s in (512, 16, 960)]
    seed = 2
    for dtype in (torch.bfloat16, torch.float32):
        for s in (37, 512, 1024):
            for with_bias in (False, True):
                fwd.append(fwd_case(fa, torch, dtype, 8, 16, s, 64,
                                    with_bias, seed))
                seed += 1
        # the head_dim-128 instantiation, which the 345M recipe does not use
        fwd.append(fwd_case(fa, torch, dtype, 2, 8, 300, 128, True, seed))
        seed += 1
    for c in fwd:
        emit({"phase": "kernel1", **c})
    offsets = [0, 1, 127, 128, 511, 1023, 700, 300]
    dec = [decode_case(fa, torch, torch.bfloat16, offsets, 16, 1024, 64,
                       False, 100)]
    dec.append(decode_case(fa, torch, torch.float32, offsets, 16, 1024, 64,
                           False, 101))
    for dtype in (torch.bfloat16, torch.float32):
        dec.append(decode_case(fa, torch, dtype, offsets, 16, 1024, 64,
                               True, 102))
        dec.append(decode_case(fa, torch, dtype, offsets[:4], 8, 512, 128,
                               False, 103))
    for c in dec:
        emit({"phase": "kernel2", **c})
    return fwd, dec


# -- kernel 1 with dropout; kernels 3 and 4: the backward ---------------


def _dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def _qkv_sets(torch, dtype, b, h, s, d, with_bias, seed, n_sets):
    """``n_sets`` of (q, k, v, dO, bias) from a seeded generator; the bias
    is a left-pad style [b, 1, 1, s] mask (-1e9 on the first keys)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    sets = []
    for _ in range(n_sets):
        q, k, v, do = (torch.randn((b, s, h, d), generator=g, device="cuda",
                                   dtype=torch.float32).to(dtype)
                       for _ in range(4))
        bias = None
        if with_bias:
            pad = torch.randint(0, max(1, s // 4), (b,), generator=g,
                                device="cuda")
            bias = torch.where(
                torch.arange(s, device="cuda")[None, :] < pad[:, None],
                -1e9, 0.0).to(torch.float32)[:, None, None, :]
        sets.append((q, k, v, do, bias))
    return sets


def _causal_mask(torch, s, bias, dtype):
    """The additive SDPA mask of a causal call with ``bias``."""
    causal = torch.triu(torch.full((s, s), float("-inf"), device="cuda"), 1)
    return (causal + bias).to(dtype)


def fwd_dropout_case(fa, philox, torch, dtype, b, h, s, d, with_bias, seed,
                     rate=0.1, n_sets=2):
    """Kernel 1 with in-kernel dropout against its plain version on the
    same Philox bits; the kept fraction over the causal entries; rate 0
    bit-identical to the launch without dropout. Returns the record."""
    import torch.nn.functional as F
    sets = _qkv_sets(torch, dtype, b, h, s, d, with_bias, seed, n_sets)
    dseed = 1000 + seed
    q, k, v, _, bias = sets[0]
    out, lse = fa.flash_attention(q, k, v, True, bias, rate, dseed)
    torch.cuda.synchronize()
    ref_o, ref_lse = fa.flash_attention_reference(
        q.float(), k.float(), v.float(), True, bias, rate, dseed)
    err = max(_max_err(out, ref_o), _max_err(lse, ref_lse))
    tol = TOL_DROPOUT[_dtype_name(dtype)]
    if not (torch.isfinite(out.float()).all() and torch.isfinite(lse).all()) \
            or err > tol:
        raise AssertionError(
            f"flash_attention with dropout disagrees with its plain version: "
            f"max abs err {err:.3e} > {tol:.0e} ({dtype}, bias={with_bias})")
    rel_l2, planted = _hold_normwise(out, ref_o, f"flash_attention with "
                                     f"dropout ({dtype}, bias={with_bias})")
    keep = philox.attention_keep_mask(dseed, rate, b, h, s, s, "cuda")
    live = torch.ones((s, s), dtype=torch.bool, device="cuda").tril()
    kept = float(keep[:, :, live].float().mean())
    del keep
    if abs(kept - (1.0 - rate)) > 1e-3:
        raise AssertionError(f"kernel 1 kept {kept:.5f} of the causal "
                             f"probabilities at rate {rate}")
    o0, l0 = fa.flash_attention(q, k, v, True, bias, 0.0, dseed)
    o1, l1 = fa.flash_attention(q, k, v, True, bias)
    if not (torch.equal(o0, o1) and torch.equal(l0, l1)):
        raise AssertionError("kernel 1 at rate 0 differs from the launch "
                             "without dropout")
    ms, call_ms = time_ms(lambda i: fa.flash_attention(
        *sets[i][:3], True, sets[i][4], rate, dseed + i), n_sets)
    plain_ms, _ = time_ms(lambda i: fa.flash_attention_reference(
        *sets[i][:3], True, sets[i][4], rate, dseed + i), n_sets, iters=3)
    tsets = [tuple(t.transpose(1, 2).contiguous() for t in st[:3]) +
             (None if st[4] is None else _causal_mask(torch, s, st[4], dtype),)
             for st in sets]
    library_ms, _ = time_ms(lambda i: F.scaled_dot_product_attention(
        *tsets[i][:3], attn_mask=tsets[i][3], dropout_p=rate,
        is_causal=tsets[i][3] is None), n_sets)
    bound_ms, bound_by = _fwd_bound(b, h, s, s, d, q.element_size(), True,
                                    with_bias)
    return {"dtype": _dtype_name(dtype), "b": b, "h": h, "s": s, "d": d,
            "bias": with_bias, "dropout": rate, "max_abs_err": err,
            "tol": tol, "rel_l2": rel_l2, "rel_l2_planted": planted,
            "kept_fraction": kept, "rate0_bit_identical": True,
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def _bwd_bound(which, b, h, s, d, itemsize, has_bias):
    """(bound_ms, bound_by) of one causal backward call: ``which`` is
    "dkv" (kernel 3: s, dP, dV and dK, 4 products, writes dk and dv),
    "dq" (kernel 4: s, dP and dQ, 3 products, writes dq) or "both" (the
    whole backward, 5 products); each reads q, k, v, dO, lse and delta
    (and O for "both") once, and each product costs 2 d FLOPs per live
    (query, key) pair."""
    pairs = s * (s + 1) // 2
    products = {"dkv": 4, "dq": 3, "both": 5}[which]
    flops = 2.0 * products * b * h * d * pairs
    tok = b * s * h * d * itemsize
    reads = 4 * tok + 2 * b * h * s * 4 + (b * s * 4 if has_bias else 0)
    writes = {"dkv": 2 * tok, "dq": tok, "both": 3 * tok}[which]
    if which == "both":
        reads += tok
    peak = BF16_TENSOR_FLOPS if itemsize == 2 else FP32_CUDA_CORE_FLOPS
    t_ops = flops / peak * 1e3
    t_bytes = (reads + writes) / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _bwd_launchers(fa, q, k, v, o, lse, do, causal, bias, rate, seed):
    """``({"dkv": launch, "dq": launch}, (dq, dk, dv))``: kernel 3 and
    kernel 4 each launched alone through the built library's symbols on
    the current stream, with the inputs prepared once as the wrapper
    prepares them (delta, lse, the canonical bias), writing into the
    returned outputs. Launches made here are not counted."""
    import torch
    from paddlefleetx_tpu_torch.ops.cuda import build
    b, sq, h, d = q.shape
    skv = k.shape[1]
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    lse = lse.float().contiguous()
    sb = sh = sqs = 0
    if bias is not None:
        bias = fa._canon_bias(bias, b, h, sq, skv).contiguous()
        sb, sh, sqs = fa._bias_strides(bias, sq, skv)
    ins = (q, k, v, do, lse, delta)
    args = (b, h, sq, skv, d, sb, sh, sqs, d ** -0.5, int(causal),
            int(q.dtype == torch.bfloat16), *fa._dropout_args(rate, seed))
    lib = build.load()

    def launch(fn, *outs):
        rc = fn(*(t.data_ptr() for t in ins),
                bias.data_ptr() if bias is not None else None,
                *(t.data_ptr() for t in outs), *args,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"flash backward launch failed: cudaError {rc}")

    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    return {"dkv": lambda: launch(lib.pfx_flash_bwd_dkv, dk, dv),
            "dq": lambda: launch(lib.pfx_flash_bwd_dq, dq)}, (dq, dk, dv)


def bwd_case(fa, torch, dtype, b, h, s, d, with_bias, rate, seed,
             regime, n_sets=2):
    """Kernels 3 and 4 against the plain backward (fp32, the same inputs:
    q, k, v, dO and kernel 1's O and lse), by max abs error and normwise;
    times each kernel alone, the plain backward and the SDPA backward (no
    dropout). Returns the record."""
    import torch.nn.functional as F
    sets = _qkv_sets(torch, dtype, b, h, s, d, with_bias, seed, n_sets)
    dseed = 2000 + seed
    args = []
    for i, (q, k, v, do, bias) in enumerate(sets):
        o, lse = fa.flash_attention(q, k, v, True, bias, rate, dseed + i)
        args.append((q, k, v, o, lse, do, None, True, bias, rate, dseed + i))
    dq, dk, dv = fa.flash_attention_backward(*args[0])
    torch.cuda.synchronize()
    q, k, v, o, lse, do = args[0][:6]
    ref = fa.flash_attention_backward_reference(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(), None,
        True, args[0][8], rate, dseed)
    grads = ("dq", "dk", "dv")
    errs = {n: _max_err(a, r) for n, a, r in zip(grads, (dq, dk, dv), ref)}
    scale = max(float(r.abs().max()) for r in ref)
    name = _dtype_name(dtype)
    tol = TOL_BWD[name]
    measure = max(errs.values()) / scale if name == "bfloat16" \
        else max(errs.values())
    finite = all(bool(torch.isfinite(t.float()).all()) for t in (dq, dk, dv))
    what = f"({dtype}, b={b}, s={s}, bias={with_bias}, dropout={rate})"
    if not finite or measure > tol:
        raise AssertionError(
            f"flash backward disagrees with its plain version: {errs} "
            f"(grad scale {scale:.3e}, tol {tol:.0e}) {what}")
    normwise = {n: _hold_normwise(a, r, f"flash backward {n} {what}")
                for n, a, r in zip(grads, (dq, dk, dv), ref)}
    del ref
    launchers = [_bwd_launchers(fa, *a[:6], *a[7:]) for a in args]
    ms = {}
    for which in ("dkv", "dq"):
        ms[which] = time_ms(lambda i, w=which: launchers[i][0][w](), n_sets)
    if not all(torch.equal(a, r) for a, r in zip(launchers[0][1],
                                                 (dq, dk, dv))):
        raise AssertionError(f"flash backward: the kernels launched alone "
                             f"differ from the wrapper's launch {what}")
    del launchers
    plain_ms, _ = time_ms(lambda i: fa.flash_attention_backward_reference(
        *args[i]), n_sets, iters=3)
    lib = []
    for q, k, v, do, bias in sets:
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        mask = None if bias is None else _causal_mask(torch, s, bias, dtype)
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                             is_causal=mask is None)
        lib.append((out, (qt, kt, vt), do.transpose(1, 2).contiguous()))
    library_ms, _ = time_ms(lambda i: torch.autograd.grad(
        lib[i][0], lib[i][1], lib[i][2], retain_graph=True), n_sets)
    item = q.element_size()
    rec = {"regime": regime, "dtype": name, "b": b, "h": h, "s": s, "d": d,
           "bias": with_bias, "dropout": rate, "max_abs_err": errs,
           "grad_scale": scale, "tol": tol,
           "tol_kind": "relative" if name == "bfloat16" else "abs",
           "rel_l2": {n: r[0] for n, r in normwise.items()},
           "rel_l2_planted": {n: r[1] for n, r in normwise.items()},
           "tol_rel_l2": TOL_REL_L2[name],
           "plain_ms": plain_ms, "library_ms": library_ms}
    for which in ("dkv", "dq", "both"):
        rec[f"bound_ms_{which}"], rec[f"bound_by_{which}"] = _bwd_bound(
            which, b, h, s, d, item, with_bias)
    for which in ("dkv", "dq"):
        rec[f"ms_{which}"], rec[f"call_ms_{which}"] = ms[which]
    return rec


def phase_kernel1_dropout():
    """Kernel 1 with dropout at the training shape (b 8, h 16, s 1024,
    d 64, causal, rate 0.1), bf16 and fp32, with and without a bias."""
    import torch
    from paddlefleetx_tpu_torch.ops.cuda import flash_attention as fa
    from paddlefleetx_tpu_torch.ops.cuda import philox
    cases = []
    seed = 300
    for dtype in (torch.bfloat16, torch.float32):
        for with_bias in (False, True):
            cases.append(fwd_dropout_case(fa, philox, torch, dtype, 8, 16,
                                          1024, 64, with_bias, seed))
            seed += 1
    for c in cases:
        emit({"phase": "kernel1_dropout", **c})
    return cases


def phase_backward():
    """Kernels 3 and 4: the recipe's shape (b 8, h 16, s 1024, d 64, the
    TPU's ``_bwd_combined_kernel`` regime) without and with dropout 0.1,
    a [b, 1, 1, s] bias (the split-pair regime) and b 2, s 4096 (the
    ``_bwd_fused_kernel`` regime), each in bf16 and fp32; the first case
    is the training path's (bf16, dropout 0.1)."""
    import torch
    from paddlefleetx_tpu_torch.ops.cuda import flash_attention as fa
    cases = []
    seed = 400
    for dtype in (torch.bfloat16, torch.float32):
        for regime, b, s, with_bias, rate in (
                ("combined", 8, 1024, False, 0.1),
                ("combined", 8, 1024, False, 0.0),
                ("split", 8, 1024, True, 0.0),
                ("fused", 2, 4096, False, 0.0)):
            cases.append(bwd_case(fa, torch, dtype, b, 16, s, 64, with_bias,
                                  rate, seed, regime))
            seed += 1
            torch.cuda.empty_cache()
    for c in cases:
        emit({"phase": "backward", **c})
    return cases


# -- the serving path ---------------------------------------------------


def reset_counts():
    """Zero every kernel's launch count and the process-global registry
    (enabled), just before a run whose counts are read."""
    from paddlefleetx_tpu_torch.observability import metrics
    from paddlefleetx_tpu_torch.ops.cuda import flash_attention as fa
    fa.flash_attention.launches = 0
    fa.flash_decode.launches = 0
    fa.flash_attention_backward.launches_dkv = 0
    fa.flash_attention_backward.launches_dq = 0
    metrics.set_enabled(True)
    metrics.get_registry().reset()


def read_counts() -> dict:
    """Every kernel's launch count and the registry's ``attention/*``
    and ``serving/*`` counters, just after a run."""
    from paddlefleetx_tpu_torch.observability import metrics
    from paddlefleetx_tpu_torch.ops.cuda import flash_attention as fa
    counters = metrics.get_registry().snapshot()["counters"]
    return {"flash_attention": fa.flash_attention.launches,
            "flash_decode": fa.flash_decode.launches,
            "flash_bwd_dkv": fa.flash_attention_backward.launches_dkv,
            "flash_bwd_dq": fa.flash_attention_backward.launches_dq,
            "counters": {k: v for k, v in sorted(counters.items())
                         if k.startswith(("attention/", "serving/"))}}


def seeded_prompts(n, lo, hi, vocab, seed):
    """``n`` prompts of uniform random tokens, lengths uniform in
    ``lo..hi``, from ``numpy.random.default_rng(seed)``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(m)).tolist()
            for m in rng.integers(lo, hi + 1, size=n)]


def check_serve_counts(counts, summary, layers, label):
    """Every admission was one kernel-1 launch per layer, every tick one
    kernel-2 launch per layer, and nothing took the dense path."""
    c = counts["counters"]
    want = {"flash_attention": summary["admitted"] * layers,
            "flash_decode": summary["decode_ticks"] * layers}
    for name, n in want.items():
        if counts[name] != n or n == 0:
            raise AssertionError(f"{label}: {name} launched {counts[name]} "
                                 f"times, expected {n} (> 0)")
    if c.get("attention/dense", 0) != 0 or \
            c.get("attention/flash", 0) != want["flash_attention"] or \
            c.get("attention/flash_decode_ragged", 0) != \
            want["flash_decode"]:
        raise AssertionError(f"{label}: attention dispatch counters "
                             f"{c} do not match the launches {want}")


def phase_serve(device="cuda", overrides=(), requests=16, slots=8,
                lo=5, hi=700):
    """The main path: GPT-345M at full width from the generation recipe
    (bf16, weights from ``Global.seed``) behind ``GenerationServer``,
    greedy, ``max_dec_len`` 64, serving seeded prompts; the counts are
    zeroed just before ``run`` and read just after. Returns the record
    it prints and the module (its model is the profile phase's)."""
    import torch
    from paddlefleetx_tpu_torch.core.serving import GenerationServer
    from paddlefleetx_tpu_torch.models.gpt.modules import GPTGenerationModule
    from paddlefleetx_tpu_torch.utils.config import get_config
    module = GPTGenerationModule(get_config(CONFIG, [
        "Generation.decode_strategy=greedy_search",
        "Generation.max_dec_len=64", *overrides]), device=device)
    cfg = module.model_config
    prompts = seeded_prompts(requests, lo, hi, cfg.vocab_size, 2024)
    server = GenerationServer(module.model, module.generation_cfg,
                              num_slots=slots, seed=module.seed)
    reset_counts()
    t0 = time.perf_counter()
    completions = server.run(prompts)
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    summary = server.summary()
    reasons = [c.finish_reason for c in completions]
    if len(completions) != requests or \
            not set(reasons) <= {"eos", "length"}:
        raise AssertionError(f"serve: finish reasons {reasons}")
    for c in completions:
        if not c.tokens or not all(0 <= t < cfg.vocab_size
                                   for t in c.tokens):
            raise AssertionError(f"serve: request {c.request_id} emitted "
                                 f"{c.tokens}")
    check_serve_counts(counts, summary, cfg.num_layers, "serve")
    generated = sum(len(c.tokens) for c in completions)
    record = {
        "phase": "serve", "model": "GPT-345M", "dtype": cfg.dtype,
        "layers": cfg.num_layers, "hidden": cfg.hidden_size,
        "heads": cfg.num_attention_heads, "vocab": cfg.vocab_size,
        "slots": slots, "requests": requests,
        "prompt_lens": [len(p) for p in prompts],
        "finish_reasons": reasons, "generated_tokens": generated,
        "wall_s": wall, "e2e_tokens_per_s": generated / wall,
        "decode_tokens_per_s": summary["tokens_per_sec"],
        "ttft_p50_ms": summary.get("ttft_p50_ms"),
        "ttft_p99_ms": summary.get("ttft_p99_ms"),
        "decode_tick_p50_ms": summary.get("tick_p50_ms"),
        "decode_tick_p99_ms": summary.get("tick_p99_ms"),
        "decode_ticks": summary["decode_ticks"],
        "admitted": summary["admitted"], "launches": {
            "flash_attention": counts["flash_attention"],
            "flash_decode": counts["flash_decode"]},
        "counters": counts["counters"]}
    if device != "cpu":
        record["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    emit(record)
    return record, module


#: kernel-name pieces that sort a device kernel into a category
KERNEL_CATEGORIES = (("flash_decode", ("flash_decode_kernel",)),
                     ("flash_attention", ("flash_fwd",)),
                     ("flash_backward", ("flash_bwd",)),
                     ("gemm", ("gemm", "nvjet", "splitkreduce", "cutlass",
                               "xmma")))


def _busy_us(spans) -> float:
    """Length of the union of ``(start, end)`` spans."""
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return busy


def profile_window(torch, label, fn, steps):
    """Run ``fn`` under ``torch.profiler`` (device activity only) and
    return where the device time went: the window's host time, the union
    of its device kernel spans, the idle share, the kernel time by
    category and of the costliest kernels, and the kernels launched per
    step. The trace goes to ``chiprun_out/chip_smoke/``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = kernel_events(prof, label)
    by_cat = {name: 0.0 for name, _ in KERNEL_CATEGORIES}
    by_cat["other"] = 0.0
    by_name = {}
    for e in events:
        cat = next((name for name, keys in KERNEL_CATEGORIES
                    if any(k in e["name"].lower() for k in keys)), "other")
        by_cat[cat] += e["dur"]
        ms, n = by_name.get(e["name"][:80], (0.0, 0))
        by_name[e["name"][:80]] = (ms + e["dur"] / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    busy = _busy_us([(e["ts"], e["ts"] + e["dur"]) for e in events])
    return {"window": label, "steps": steps, "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / wall_us if events else None,
            "kernel_ms": {k: v / 1e3 for k, v in by_cat.items()},
            "top_kernels": [{"name": k, "ms": ms, "launches": n}
                            for k, (ms, n) in top],
            "kernels_per_step": len(events) / steps}


def phase_profile(module, slots=8, ticks=16):
    """Where a serving step's time goes, on the serve phase's model: one
    step that admits ``slots`` prompts (a prefill each) and ticks once,
    then ``ticks`` decode ticks with every slot busy, each window under
    ``torch.profiler``. Kernel time by category (kernel 1, kernel 2,
    GEMMs, the rest) and the device's idle share; no device trace (no
    kernel events) is reported as not measured."""
    import torch
    from paddlefleetx_tpu_torch.core.serving import GenerationServer
    cfg = module.model_config
    server = GenerationServer(module.model, module.generation_cfg,
                              num_slots=slots, seed=module.seed)
    for p in seeded_prompts(slots, 5, 700, cfg.vocab_size, 4048):
        server.submit(p)
    admit = profile_window(torch, "admit", server.step, 1)

    def decode():
        for _ in range(ticks):
            server.step()
    tick = profile_window(torch, "decode", decode, ticks)
    if server.occupancy != slots:
        raise AssertionError("profile: a slot finished inside the window")
    emit({"phase": "profile", "slots": slots, "windows": [admit, tick]})


def phase_serve_cli(device="cuda", overrides=()):
    """The ``serve`` entry point as a user calls it, with the recipe's
    own sampling (top-k 50, top-p 0.75): 8 requests, ``max_dec_len``
    16, 4 slots; every request finishes and every admission and tick
    went through the kernels."""
    from paddlefleetx_tpu_torch import cli
    from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
    from paddlefleetx_tpu_torch.utils.config import get_config
    over = ["Generation.max_dec_len=16", *overrides]
    argv = ["-c", CONFIG, "--requests", "8", "--slots", "4",
            "--max-prompt-len", "300"]
    if device != "cuda":
        argv += ["--device", device]
    for o in over:
        argv += ["-o", o]
    reset_counts()
    summary = cli.serve_main(argv)
    counts = read_counts()
    if summary["admitted"] != 8 or \
            not set(summary["finish_reasons"]) <= {"eos", "length"}:
        raise AssertionError(f"serve entry point: {summary}")
    layers = GPTConfig.from_config(get_config(CONFIG, over)).num_layers
    check_serve_counts(counts, summary, layers, "serve entry point")
    emit({"phase": "serve_cli", "strategy": "sampling",
          "finish_reasons": summary["finish_reasons"],
          "decode_ticks": summary["decode_ticks"],
          "launches": {"flash_attention": counts["flash_attention"],
                       "flash_decode": counts["flash_decode"]}})


def top2_gap(model, prompt, prefix):
    """``(top-1 minus top-2 logit, max |logit|)`` of the next token
    after ``prompt + prefix``, from one full forward."""
    import torch
    dev = model.word_embeddings.device
    ids = torch.as_tensor([list(prompt) + list(prefix)], device=dev)
    with torch.no_grad():
        logits = model(ids)[0, -1].float()
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1]), float(logits.abs().max())


def _truncate(row, eos):
    out = []
    for t in row:
        out.append(int(t))
        if int(t) == eos:
            break
    return out


def compare_rows(label, model, prompts, got, want, eos):
    """Hold token rows ``got`` to ``want`` (both cut after EOS). At the
    first mismatch of a row, print its position and the top-2 logit gap
    there, and fail unless the gap is below 1e-4 of the logit scale (a
    true near-tie, where rounding may pick either token)."""
    mismatches = []
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _truncate(g, eos), _truncate(w, eos)
        if g == w:
            continue
        pos = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                   min(len(g), len(w)))
        gap, scale = top2_gap(model, prompts[i], w[:pos])
        mismatches.append({"row": i, "position": pos, "top2_gap": gap,
                           "logit_scale": scale})
        emit({"phase": label, "mismatch": mismatches[-1]})
        if gap >= 1e-4 * scale:
            raise AssertionError(
                f"{label}: row {i} differs at position {pos} where the "
                f"top-2 logit gap {gap:.3e} is no near-tie (scale "
                f"{scale:.3e})")
    return mismatches


def phase_parity(device="cuda", overrides=(), requests=4, hi=300):
    """The same widths in fp32: the server's greedy rows equal the
    lockstep ``generate()`` rows (ragged decode kernel against the
    shared-offset + bias one), and the kernel path's lockstep rows and
    logits equal those of the dense PyTorch path on the same weights
    (no hand-written kernel there)."""
    import dataclasses
    import torch
    from paddlefleetx_tpu_torch.core.serving import GenerationServer
    from paddlefleetx_tpu_torch.models.gpt.generation import (
        generate, left_pad_batch,
    )
    from paddlefleetx_tpu_torch.models.gpt.model import build_model
    from paddlefleetx_tpu_torch.models.gpt.modules import GPTGenerationModule
    from paddlefleetx_tpu_torch.utils.config import get_config
    module = GPTGenerationModule(get_config(CONFIG, [
        "Engine.mix_precision.use_pure_fp16=False",
        "Generation.decode_strategy=greedy_search",
        "Generation.max_dec_len=16", *overrides]), device=device)
    cfg, gcfg, model = module.model_config, module.generation_cfg, \
        module.model
    if cfg.dtype != "float32":
        raise AssertionError(f"parity: compute dtype {cfg.dtype}")
    prompts = seeded_prompts(requests, 5, hi, cfg.vocab_size, 77)
    ids, mask = left_pad_batch(prompts, gcfg.pad_token_id)
    lockstep = generate(model, ids, mask, gcfg).tolist()
    served = [c.tokens for c in GenerationServer(
        model, gcfg, num_slots=2).run(prompts)]
    eos = gcfg.eos_token_id
    server_mm = compare_rows("parity_server", model, prompts, served,
                             lockstep, eos)
    dense = build_model(dataclasses.replace(cfg, use_flash_attention=False),
                        model.word_embeddings.device,
                        state_dict=model.state_dict())
    dense_rows = generate(dense, ids, mask, gcfg).tolist()
    dense_mm = compare_rows("parity_dense", dense, prompts, lockstep,
                            dense_rows, eos)
    probe = torch.as_tensor([prompts[0][:37]],
                            device=model.word_embeddings.device)
    with torch.no_grad():
        logits, ref = model(probe), dense(probe)
    if logits.shape != (1, probe.shape[1], cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"parity: logits {tuple(logits.shape)} "
                             f"not finite or of the wrong shape")
    logit_err = _max_err(logits, ref)
    if logit_err > 1e-3:
        raise AssertionError(f"parity: kernel-path logits differ from the "
                             f"dense path by {logit_err:.3e} > 1e-3")
    emit({"phase": "parity", "dtype": cfg.dtype, "requests": requests,
          "prompt_lens": [len(p) for p in prompts],
          "rows_equal_server": len(prompts) - len(server_mm),
          "rows_equal_dense": len(prompts) - len(dense_mm),
          "near_ties": len(server_mm) + len(dense_mm),
          "logits_max_abs_err_vs_dense": logit_err, "logits_tol": 1e-3})


def phase_generate_cli(device="cuda", overrides=()):
    """``cli.generate_main`` on the recipe as a user calls it (bf16,
    sampling): it returns a string."""
    from paddlefleetx_tpu_torch import cli
    argv = ["-c", CONFIG, "-o", "Generation.max_dec_len=16", "--text",
            "Historia est vitae magistra"]
    if device != "cuda":
        argv += ["--device", device]
    for o in overrides:
        argv += ["-o", o]
    text = cli.generate_main(argv)
    if not isinstance(text, str):
        raise AssertionError(f"generate entry point returned {type(text)}")
    emit({"phase": "generate_cli", "chars": len(text)})


# -- the training path --------------------------------------------------


def train_argv(data_dir, out_dir, overrides, device):
    """``train`` entry-point arguments: the 345M pretraining recipe on
    the corpus in ``data_dir``, plus ``overrides``."""
    argv = ["-c", TRAIN_CONFIG]
    if device != "cuda":
        argv += ["--device", device]
    over = [f"Engine.save_load.output_dir={out_dir}"]
    for mode in ("Train", "Eval"):
        over.append(f"Data.{mode}.dataset.input_dir={data_dir}")
    for o in over + list(overrides):
        argv += ["-o", o]
    return argv


def write_train_corpus(path, overrides, steps):
    """A seeded synthetic corpus (``data/synthetic.py``) covering
    ``steps`` batches of the recipe (cut by ``overrides``), and at least
    200k tokens, so the recipe's 949 / 50 / 1 split leaves documents for
    evaluation."""
    from paddlefleetx_tpu_torch.data.synthetic import write_corpus
    from paddlefleetx_tpu_torch.utils.config import get_config
    cfg = get_config(TRAIN_CONFIG, list(overrides))
    tokens = max(200_000, cfg.Global.global_batch_size *
                 (cfg.Data.Train.dataset.max_seq_len + 1) * (steps + 4))
    write_corpus(path, cfg.Model.vocab_size, tokens,
                 seed=int(cfg.Global.seed),
                 eos_id=min(50256, cfg.Model.vocab_size - 1))
    return cfg


#: the 30-step run's schedule: the recipe's warmup (1% of 360k steps)
#: would keep the rate near 0, so the decay is cut to 1000 steps (a
#: 10-step warmup) and the peak raised to 3e-4
TRAIN_LR = ["Optimizer.lr.decay_steps=1000", "Optimizer.lr.max_lr=3e-4",
            "Optimizer.lr.min_lr=3e-5"]


def _percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def phase_train(device="cuda", overrides=(), steps=30):
    """The main training path: the 345M pretraining recipe as written
    (bf16 on fp32 master weights, dropout 0.1 / 0.1, ``save_dots``,
    ``loss_chunks`` 8, batch 8 x 1024, 24 layers, weights from
    ``Global.seed``) through ``cli.train_main`` for ``steps`` steps on a
    seeded synthetic corpus, with the counts zeroed just before and read
    just after. Asserts finite, falling losses, 24 launches of kernels
    1, 3 and 4 per step and no dense attention. Returns the record and
    the engine."""
    import torch
    from paddlefleetx_tpu_torch import cli
    from paddlefleetx_tpu_torch.observability import flops
    tmp = tempfile.mkdtemp(prefix="pfx_train_")
    try:
        over = [f"Engine.max_steps={steps}", "Engine.logging_freq=1",
                "Engine.eval_freq=1000000", "Engine.eval_iters=1",
                "Engine.save_load.save_steps=1000000", *TRAIN_LR,
                *overrides]
        cfg = write_train_corpus(os.path.join(tmp, "data"), over, steps)
        argv = train_argv(os.path.join(tmp, "data"),
                          os.path.join(tmp, "out"), over, device)
        if device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        engine = cli.train_main(argv)
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    mcfg = engine.module.model_config
    losses = [h["loss"] for h in engine.history]
    if len(losses) != steps or not all(map(lambda x: x == x and
                                           abs(x) < float("inf"), losses)):
        raise AssertionError(f"train: losses {losses}")
    first5, last5 = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    if not last5 < first5:
        raise AssertionError(f"train: the loss did not fall ({first5:.4f} "
                             f"-> {last5:.4f})")
    layers = mcfg.num_layers
    want = steps * layers
    c = counts["counters"]
    for name in ("flash_attention", "flash_bwd_dkv", "flash_bwd_dq"):
        if counts[name] != want:
            raise AssertionError(f"train: {name} launched {counts[name]} "
                                 f"times in {steps} steps, expected {want}")
    # the dispatch counter counts calls of the dispatch, and a recompute
    # replays the block's Python (the kernel's saved output is reused)
    if c.get("attention/flash_dropout", 0) < want or \
            c.get("attention/dense", 0) != 0 or \
            c.get("attention/flash", 0) != 0:
        raise AssertionError(f"train: attention counters {c}")
    costs = [h["train_cost"] for h in engine.history[1:]]
    seq = cfg.Data.Train.dataset.max_seq_len
    tokens = cfg.Global.global_batch_size * seq
    p50 = _percentile(costs, 0.5)
    fpt = flops.model_flops_per_token(layers, mcfg.hidden_size,
                                      mcfg.vocab_size, seq)
    record = {
        "phase": "train", "model": "GPT-345M", "dtype": mcfg.dtype,
        "layers": layers, "hidden": mcfg.hidden_size,
        "heads": mcfg.num_attention_heads, "vocab": mcfg.vocab_size,
        "batch": cfg.Global.global_batch_size, "seq": seq,
        "dropout": [mcfg.hidden_dropout_prob,
                    mcfg.attention_probs_dropout_prob],
        "recompute": mcfg.recompute_granularity,
        "loss_chunks": mcfg.loss_chunks, "lr_overrides": TRAIN_LR,
        "steps": steps, "wall_s": wall,
        "first_step_s": engine.history[0]["train_cost"],
        "step_p50_s": p50, "step_p90_s": _percentile(costs, 0.9),
        "tokens_per_s": tokens / p50,
        "model_flops_per_token": fpt,
        "mfu": flops.mfu(tokens / p50, fpt),
        "mfu_peak": "bf16 dense 989 TFLOP/s",
        "first_loss": losses[0], "last_loss": losses[-1],
        "mean_first5": first5, "mean_last5": last5,
        "launches_per_step": {k: counts[k] / steps for k in (
            "flash_attention", "flash_bwd_dkv", "flash_bwd_dq")},
        "launches": {k: counts[k] for k in (
            "flash_attention", "flash_bwd_dkv", "flash_bwd_dq")},
        "counters": c}
    if device != "cpu":
        record["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    emit(record)
    return record, engine


def phase_train_profile(engine, data_seed=9):
    """Where one training step's device time goes (the train phase's
    engine and model, one more step on a seeded batch): kernel time by
    category and the device's idle share."""
    import numpy as np
    import torch
    cfg = engine.configs
    b = cfg.Global.global_batch_size
    s = cfg.Data.Train.dataset.max_seq_len
    rng = np.random.default_rng(data_seed)
    tokens = rng.integers(0, engine.module.model_config.vocab_size,
                          (b, s + 1))
    batch = (tokens[:, :-1], np.broadcast_to(np.arange(s), (b, s)).copy(),
             tokens[:, 1:], np.ones((b, s), np.float32))
    engine.train_step(batch)
    window = profile_window(torch, "train_step",
                            lambda: engine.train_step(batch), 1)
    emit({"phase": "train_profile", "windows": [window]})
    return window


#: the parity phase's initializer: at the recipe's 0.02 the scores are
#: near uniform (std ~0.4), dS ~ 0, and a wrong dQ or dK would move
#: neither the loss nor the gradient's norm; at 0.05 they spread (std
#: ~2.6 at head_dim 64), so the attention gradient shows in every leaf
PARITY_INIT = 0.05
#: the fp32 parity phase's limits, relative: each step's loss, the
#: global gradient norm, and the worst leaf's gradient of the first
#: batch (on the H100 4.6e-6, and 0.067 with dQ planted wrong)
PARITY_TOL = {"loss_rel": 1e-5, "grad_norm_rel": 1e-4, "grad_leaf_rel": 5e-4}


def _first_grads(module, batch, seed):
    """Every parameter's gradient of one ``loss_fn`` on ``batch`` (host
    arrays), left zeroed in the model."""
    import numpy as np
    import torch
    model = module.model
    model.train()
    dev = next(model.parameters()).device
    data = tuple(torch.from_numpy(np.asarray(x)).to(dev) for x in batch)
    module.loss_fn(model, data, seed, train=True).backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return grads


def _leaf_diff(grads, ref):
    """``(worst leaf, its ||g - ref||_2 / ||ref||_2)`` over the leaves."""
    rel = {n: float((grads[n] - r).norm() / r.norm().clamp_min(1e-30))
           for n, r in ref.items()}
    worst = max(rel, key=rel.get)
    return worst, rel[worst]


def phase_train_parity(device="cuda", overrides=(), steps=2, batch=2):
    """GPT-345M at full width in fp32 without dropout, from weights with
    ``initializer_range`` ``PARITY_INIT`` (non-uniform attention): the
    gradient of the first batch and ``steps`` optimizer steps through the
    kernels, and as much through the dense PyTorch path
    (``use_flash_attention: False``), from the same weights on the same
    batches, held within ``PARITY_TOL``; then the kernels' gradient again
    with dQ planted wrong (one middle tile of 64 query rows zeroed in
    every head), which the leaf check must refuse."""
    import functools
    from paddlefleetx_tpu_torch.core.engine import Engine
    from paddlefleetx_tpu_torch.data import build_dataloader
    from paddlefleetx_tpu_torch.models.gpt.modules import GPTModule
    from paddlefleetx_tpu_torch.ops.cuda import flash_attention as fa
    from paddlefleetx_tpu_torch.utils.config import get_config
    tmp = tempfile.mkdtemp(prefix="pfx_parity_")
    try:
        over = ["Engine.mix_precision.use_pure_fp16=False",
                "Model.hidden_dropout_prob=0.0",
                "Model.attention_probs_dropout_prob=0.0",
                f"Model.initializer_range={PARITY_INIT}",
                "Optimizer.lr.warmup_rate=0.0",
                f"Global.local_batch_size={batch}",
                f"Global.micro_batch_size={batch}",
                f"Engine.save_load.output_dir={tmp}", *overrides]
        for mode in ("Train", "Eval"):
            over.append(f"Data.{mode}.dataset.input_dir={tmp}")
        write_train_corpus(tmp, over, steps)
        runs, grads = {}, {}
        state = first = None
        for name, extra in (("kernels", []),
                            ("dense", ["Model.use_flash_attention=False"])):
            cfg = get_config(TRAIN_CONFIG, over + extra)
            module = GPTModule(cfg, state_dict=state, device=device)
            mcfg = module.model_config
            if mcfg.dtype != "float32" or \
                    mcfg.use_flash_attention != (name == "kernels"):
                raise AssertionError(f"train_parity: {name} run is "
                                     f"{mcfg.dtype}, flash "
                                     f"{mcfg.use_flash_attention}")
            if state is None:
                state = {k: v.clone() for k, v in
                         module.model.state_dict().items()}
            engine = Engine(cfg, module, device=device)
            loader = build_dataloader(cfg.Data, "Train")
            loader.batch_sampler.batch_size = cfg.Global.global_batch_size
            out = []
            reset_counts()
            for i, data in zip(range(steps), loader):
                if i == 0:
                    first = data
                    grads[name] = _first_grads(module, data, engine.seed)
                loss, norm, _ = engine.train_step(data)
                out.append((float(loss), float(norm)))
            counts = read_counts()
            want = (steps + 1) * mcfg.num_layers if name == "kernels" else 0
            if any(counts[k] != want for k in (
                    "flash_attention", "flash_bwd_dkv", "flash_bwd_dq")):
                raise AssertionError(f"train_parity: {name} run launched "
                                     f"{counts}, expected {want} each")
            runs[name] = out
            del engine, module
        module = GPTModule(get_config(TRAIN_CONFIG, over), state_dict=state,
                           device=device)
        backward = fa.flash_attention_backward

        @functools.wraps(backward)
        def planted(*args, **kwargs):
            dq, dk, dv = backward(*args, **kwargs)
            return _zero_tile(dq, head=None), dk, dv

        fa.flash_attention_backward = planted
        try:
            grads["planted"] = _first_grads(module, first, 0)
        finally:
            fa.flash_attention_backward = backward
        del module
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    leaf, leaf_rel = _leaf_diff(grads["kernels"], grads["dense"])
    p_leaf, p_rel = _leaf_diff(grads["planted"], grads["dense"])
    del grads
    rel = [(abs(a[0] - b[0]) / abs(b[0]), abs(a[1] - b[1]) / abs(b[1]))
           for a, b in zip(runs["kernels"], runs["dense"])]
    emit({"phase": "train_parity", "dtype": "float32", "steps": steps,
          "batch": batch, "initializer_range": PARITY_INIT,
          "losses_kernels": [r[0] for r in runs["kernels"]],
          "losses_dense": [r[0] for r in runs["dense"]],
          "grad_norms_kernels": [r[1] for r in runs["kernels"]],
          "grad_norms_dense": [r[1] for r in runs["dense"]],
          "loss_rel_diff": [r[0] for r in rel],
          "grad_norm_rel_diff": [r[1] for r in rel],
          "worst_leaf": leaf, "worst_leaf_rel_diff": leaf_rel,
          "planted_dq_worst_leaf": p_leaf,
          "planted_dq_worst_leaf_rel_diff": p_rel, "tol": PARITY_TOL})
    for i, (rl, rn) in enumerate(rel):
        if rl > PARITY_TOL["loss_rel"] or rn > PARITY_TOL["grad_norm_rel"]:
            raise AssertionError(
                f"train_parity: step {i + 1} loss rel diff {rl:.2e}, grad "
                f"norm rel diff {rn:.2e} (tol {PARITY_TOL})")
    if not leaf_rel <= PARITY_TOL["grad_leaf_rel"] < p_rel:
        raise AssertionError(
            f"train_parity: worst leaf {leaf} rel diff {leaf_rel:.2e}, with "
            f"dQ planted wrong {p_leaf} {p_rel:.2e}: not within "
            f"{PARITY_TOL['grad_leaf_rel']:.0e} < planted")


def phase_train_cli(device="cuda", overrides=(), steps=4):
    """``cli.train_main`` on the recipe at a reduced depth, saving every
    2 steps and evaluating at step 2, then a second call that resumes
    from the step-2 checkpoint: both reach step ``steps`` and the
    resumed run's last loss equals the first run's within 1e-3
    relative (bit-exact is reported, not required: cuBLAS and the
    embedding backward may sum in another order between processes'
    runs)."""
    from paddlefleetx_tpu_torch import cli
    tmp = tempfile.mkdtemp(prefix="pfx_cli_")
    try:
        over = ["Model.num_layers=4", f"Engine.max_steps={steps}",
                "Engine.logging_freq=1", "Engine.eval_freq=2",
                "Engine.eval_iters=1", "Engine.save_load.save_steps=2",
                *TRAIN_LR, *overrides]
        data = os.path.join(tmp, "data")
        write_train_corpus(data, over, steps)
        first = cli.train_main(train_argv(data, os.path.join(tmp, "a"),
                                          over, device))
        step2 = os.path.join(tmp, "a", "epoch_0_step_2")
        second = cli.train_main(train_argv(
            data, os.path.join(tmp, "b"),
            over + [f"Engine.save_load.ckpt_dir={step2}"], device))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if first.step != steps or second.step != steps or \
            len(second.history) != steps - 2:
        raise AssertionError(f"train_cli: steps {first.step} / "
                             f"{second.step}, resumed history "
                             f"{len(second.history)}")
    a, b = first.history[-1]["loss"], second.history[-1]["loss"]
    rel = abs(a - b) / abs(a)
    if rel > 1e-3:
        raise AssertionError(f"train_cli: resumed step-{steps} loss {b} vs "
                             f"{a} (rel {rel:.2e} > 1e-3)")
    emit({"phase": "train_cli", "layers": first.module.model_config.
          num_layers, "steps": steps, "resumed_from_step": 2,
          "loss_first_run": a, "loss_resumed": b, "rel_diff": rel,
          "bit_exact": a == b, "tol_rel": 1e-3})


def kernels_line(fwd, dec, serve, fwd_drop, bwd, train) -> dict:
    """The per-kernel record: each kernel's main-path shape (kernel 1:
    the serving case first, the training case beside it; kernels 3 and
    4: the recipe's bf16 case with dropout), the worst error over all
    its cases (max abs and normwise, with the least planted-fault
    reading), and its launches on the main paths (serve and train),
    each counted from zero just before its path ran. Kernels 3 and 4
    also carry the pair's time and the bound of the one TPU function
    they replace together (5 products, ``bound_ms_both``)."""
    k1_launch = {"serve": serve["launches"]["flash_attention"],
                 "train": train["launches"]["flash_attention"]}
    rows = []
    for name, cases, source, replaces, launches in (
            ("flash_attention", fwd + fwd_drop, "paddlefleetx_tpu_torch/"
             "csrc/flash_fwd.cu", "paddlefleetx_tpu/ops/pallas/"
             "flash_attention.py:209", k1_launch),
            ("flash_decode", dec, "paddlefleetx_tpu_torch/csrc/"
             "flash_decode.cu", "paddlefleetx_tpu/ops/pallas/"
             "flash_attention.py:1055",
             {"serve": serve["launches"]["flash_decode"]})):
        head = cases[0]
        err = max(c["max_abs_err"] for c in cases)
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": err, "max_err": err,
            "tol": {("%s_dropout" % c["dtype"]) if c.get("dropout")
                    else c["dtype"]: c["tol"] for c in cases},
            "max_rel_l2": max(c["rel_l2"] for c in cases),
            "min_rel_l2_planted": min(c["rel_l2_planted"] for c in cases),
            "tol_rel_l2": TOL_REL_L2,
            "ms": head["ms"], "kernel_ms": head["ms"],
            "call_ms": head["call_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": {k: head[k] for k in head
                      if k in ("dtype", "b", "h", "s", "S", "d", "offsets",
                               "bias", "shared_offset_bias")},
            "cases": len(cases)})
    if fwd_drop:
        t = fwd_drop[0]
        rows[0]["train_shape"] = {k: t[k] for k in (
            "dtype", "b", "h", "s", "d", "bias", "dropout", "ms", "call_ms",
            "plain_ms", "library_ms", "bound_ms", "bound_by")}
    for name, which, grads, replaces in (
            ("flash_bwd_dkv", "dkv", ("dk", "dv"),
             "paddlefleetx_tpu/ops/pallas/flash_attention.py:419"),
            ("flash_bwd_dq", "dq", ("dq",),
             "paddlefleetx_tpu/ops/pallas/flash_attention.py:454")):
        head = bwd[0]
        err = max(c["max_abs_err"][g] for c in bwd for g in grads)
        rows.append({
            "name": name, "route": "cuda",
            "source": "paddlefleetx_tpu_torch/csrc/flash_bwd.cu",
            "replaces": replaces,
            "replaces_also": ["paddlefleetx_tpu/ops/pallas/"
                              "flash_attention.py:485 (_bwd_combined_kernel)",
                              "paddlefleetx_tpu/ops/pallas/"
                              "flash_attention.py:555 (_bwd_fused_kernel)"],
            "launches": train["launches"][name],
            "launches_by_path": {"train": train["launches"][name]},
            "max_abs_err": err, "max_err": err,
            "max_rel_err_bf16": max(
                max(c["max_abs_err"][g] for g in grads) / c["grad_scale"]
                for c in bwd if c["dtype"] == "bfloat16"),
            "tol": {c["dtype"]: c["tol"] for c in bwd},
            "tol_kind": {c["dtype"]: c["tol_kind"] for c in bwd},
            "max_rel_l2": max(c["rel_l2"][g] for c in bwd for g in grads),
            "min_rel_l2_planted": min(c["rel_l2_planted"][g] for c in bwd
                                      for g in grads),
            "tol_rel_l2": TOL_REL_L2,
            "ms": head[f"ms_{which}"], "kernel_ms": head[f"ms_{which}"],
            "call_ms": head[f"call_ms_{which}"],
            "plain_ms": head["plain_ms"],
            "plain_computes": "dq, dk and dv together",
            "bound_ms": head[f"bound_ms_{which}"],
            "bound_by": head[f"bound_by_{which}"],
            # the TPU function both replace computes dq, dk and dv in 5
            # products; the split's recompute of S and dP is not in it
            "pair_ms": head["ms_dkv"] + head["ms_dq"],
            "pair_bound_ms": head["bound_ms_both"],
            "pair_bound_by": head["bound_by_both"],
            "library_ms": head["library_ms"],
            "library_computes": "SDPA backward, dq, dk and dv, no dropout",
            "shape": {k: head[k] for k in ("regime", "dtype", "b", "h", "s",
                                           "d", "bias", "dropout")},
            "cases": len(bwd)})
    return {"kernels": rows}


def main() -> int:
    """Run every phase; return 0 only when all of them passed."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "smoke run needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    phase_build()
    fwd, dec = phase_kernels()
    fwd_drop = phase_kernel1_dropout()
    bwd = phase_backward()
    torch.cuda.empty_cache()
    serve, module = phase_serve()
    phase_profile(module)
    del module
    phase_serve_cli()
    phase_parity()
    phase_generate_cli()
    torch.cuda.empty_cache()
    train, engine = phase_train()
    phase_train_profile(engine)
    del engine
    torch.cuda.empty_cache()
    phase_train_parity()
    torch.cuda.empty_cache()
    phase_train_cli()
    print(card, flush=True)
    emit(kernels_line(fwd, dec, serve, fwd_drop, bwd, train))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
