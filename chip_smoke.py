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
(at the 345M recipe's shape, with a bias, at s = 4096, and in bf16 at a
ragged s = 1000 and at head_dim 128; the build fails unless the bf16
attention kernels, kernel 1's planned route and kernels 3 and 4, run
wgmma, not mma.sync; every kernel-1 case is launched twice and bit-equal,
read for its route and timed beside the first design's ``mma`` route and
the other ``wgmma`` tile, and ``serve``, ``train`` and ``train_moe`` fail
if a kernel-1 launch took ``mma``), the 345M
pretraining recipe as written (bf16, dropout, ``save_dots``, chunked
loss, batch 8 x 1024) for 30 steps through ``cli.train_main`` with the
counts reset just before and read just after, one profiled training
step, fp32 gradients and two steps through the kernels against the
dense path from non-uniform attention (and refused with dQ planted
wrong), and a
save / resume through the ``train`` entry point. Then paged and
speculative serving: kernels 5, 6a and 6b (verify, paged decode, paged
verify) against their plain versions and exactly against kernel 2 / 5
at the serving shapes (shuffled page table, shared pages, garbage in
the null page), the JAX package's headline serving trace (16 slots,
65-page pool, 32 requests) through the paged server, then with n-gram
speculation paged and contiguous, the counts zeroed just before each
measured run and read just after; a profile of the paged plain and
speculative ticks; the ``serve`` entry point with the recipe's paging
and speculation knobs; and fp32 greedy rows equal across the paged,
paged speculative, contiguous speculative and contiguous servers and
the lockstep ``generate()``, also with a pool small enough to preempt.
Then int8 serving (``kv_cache_dtype: int8``, ``quant_execution:
weight_only_int8``): the int8 instances of kernels 2, 5, 6a and 6b
against their plain versions and exactly against kernel 2 / 5's, and
kernel 7 (the weight-only int8 matmul) at the four 345M dense-site
shapes; the headline trace with both knobs from an int8 pool of the
bf16 pool's bytes (122 pages for 65) and short contiguous, contiguous
speculative and paged speculative arms, each checked from its counts
(kernel 7 at every dense site, each tick's int8 instance); a profile
of the int8 paged ticks; the ``serve`` entry point with both knobs;
and fp32 greedy rows of the int8 servers equal to the int8 lockstep
``generate()``, with a copy-on-write split and a preemption in the run.
Then MoE training: kernels 8 and 9 (the grouped GEMM: forward, dx over
the transposed weight, dw) against their plain versions at the 8x345M
MoE recipe's six expert-GEMM shapes, bf16 and fp32, with planted empty
groups exactly zero, timed beside ``torch.bmm`` and
``torch._grouped_mm``; the recipe at full width on one card (its
parallel degrees set to 1) for 16 steps through ``cli.train_main``,
with kernel 8 held to 768 and kernel 9 to 384 launches a step; one
profiled MoE step; and ``sort_pallas`` held to ``sort`` (``torch.bmm``)
at 2 layers in fp32 and bf16, refused with one expert's dw planted
wrong. Then MoE serving: kernel 8 (bf16) at the serving forwards' shapes
(the 16-slot decode tick, the 5-token verify window, a 256-token paged
chunk, the contiguous admissions' buckets 16..512; fc1 and fc2) against
its plain version, timed beside its bound and ``torch.bmm`` over the
same weight bytes; the 8x345M model at full width from the generation
recipe (``MOE_KNOBS``) through the contiguous, paged, paged speculative
and int8 (both knobs) servers on the headline trace (``serve_moe``,
each arm's
counts zeroed just before and read just after: kernel 8 exactly twice
a layer and forward, no ``moe/fallback``); a profile of its paged and
speculative ticks; the ``serve`` and ``generate`` entry points with it;
and in fp32 at full width its greedy rows through kernel 8 held to the
same weights under ``sort`` (``torch.bmm``), contiguous and paged.
Then multi-tenant LoRA (``lora_rank`` 8, 5 bank rows): kernel 7's dx
route (the int8 matmul's input gradient) at the four dense sites, M 16
and 4096, bf16 and fp32, timed beside ``torch.matmul``; kernels 8 and 9
at the banks' shapes (rank 8, C 16 and 4096, one group empty) beside
``torch.bmm``, and the grouped delta beside the gather-einsum form; the
headline trace through the paged server on adapter 0 and on four mixed
adapters (``serve_lora``, the slice's main path: every bank through
kernel 8, ``lora/fallback`` 0, the id-0 arm token-exact with the rank-0
model on the same base weights); a profile of the mixed ticks; short
arms under ``quant_execution`` with LoRA (kernels 5, 6a, 6b, 7, 8);
mixed-adapter serving at 2 layers against a CPU copy and an eviction
run (``parity_lora``); the gradient of every floating leaf over an int8
base against a CPU copy, then one full-depth forward and backward
(``grad_int8_lora``: kernels 1, 3, 4, 7, 7's dx route, 8, 9); and the
frozen-base fine-tune, three steps through ``cli.train_main``.
Then offline evaluation: kernel 1 (b8 s1024, no dropout) and kernel 8
(fc1 and fc2 at ``[64, 320, K]``, 8 rows x 8 experts, every group live)
at the eval batch against their plain versions, SDPA and ``torch.bmm``;
the 345M eval recipe as written through ``cli.eval_main`` on a seeded
WikiText-style file (``eval``: kernel 1 exactly 24 a batch on
``wgmma``, no dense attention, no backward kernel, no dropout; the same
metrics again from a checkpoint saved by ``Engine.save`` and loaded
under another seed), the LAMBADA cloze on a seeded ``.jsonl``
(``eval_cloze``), the 8x345M model (``eval_moe``: kernel 8 exactly 48 a
batch, no kernel 9, no ``moe/fallback``), the fp32 kernel paths held to
the dense paths (``eval_parity``: each batch's NLL sum within 1e-5,
the cloze argmax with its top-2 gap), a profile of an eval batch, dense
and MoE (``eval_profile``), and ``Engine.predict`` with ``test_iters`` 4
(``predict``); the ``train`` phase prints the run summary
(``Engine.print_summary``). Then the 1.3B recipes: kernels 1, 3 and 4
at their attention shape (b8 h16 s1024, head_dim 128, causal, dropout
0.1) against their plain versions, launched twice and bit-equal, timed
beside SDPA and its backward (``kernel1_1p3b``, ``backward_1p3b``); the
1.3B auto recipe at full width through ``cli.auto_main`` for 8 steps
(``train_auto_1p3b``: full recompute, so kernel 1 exactly twice a layer
and step plus once a layer and eval batch, kernels 3 and 4 once a layer
and step; telemetry's ``events.jsonl`` held to the JAX engine's event
names in order; one step traced by the engine's profiler window, whose
chrome trace gives the step's device time and idle share and shows
each hand-written kernel beside a step's launches; prefetch 2); and the
``train`` entry point's run-time services at 4 layers (``train_cli``:
async saves with ``keep_last_k`` 2 bit-equal to a synchronous twin
run's, a resume from them, a SIGTERM at step 3 saved and resumed, an
epoch-mode run evaluating once).
Each phase prints one JSON object per line;
the ``kernels`` line and the card's name and power limit come before
the last line, which is ``{"ok": true, "device": {...}}``. Any failure
raises, so the exit code is non-zero and the last line is not printed.
Without a CUDA device, or without the package beside it, it exits
non-zero at once. Long output goes to ``chiprun_out/chip_smoke/``.
"""

from __future__ import annotations

import json
import os
import re
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
MOE_CONFIG = os.path.join(ROOT, "configs", "nlp", "gpt",
                          "pretrain_moe_gpt_8x345M_ep8.yaml")
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


def kernel_events(prof, label, cats=("kernel",)):
    """The device kernel events (``ts``, ``dur`` in us, ``name``) of a
    finished ``torch.profiler`` run (or its events of the categories
    ``cats``), read from its Chrome trace, which is kept gzipped as
    ``trace_<label>.json.gz`` in ``OUT_DIR`` (the windows' raw traces
    together run to tens of MiB)."""
    import gzip
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, f"trace_{label}.json")
    prof.export_chrome_trace(path)
    with open(path, "rb") as f:
        raw = f.read()
    os.remove(path)
    with gzip.open(path + ".gz", "wb") as f:
        f.write(raw)
    return [e for e in json.loads(raw).get("traceEvents", [])
            if e.get("cat") in cats and "dur" in e]


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


def _fwd_route_taken(fa, before) -> str:
    """The one kernel-1 route whose launch count moved since ``before``
    (a copy of ``flash_attention.launches_by_route``)."""
    now = fa.flash_attention.launches_by_route
    moved = [r for r in now if now[r] != before.get(r, 0)]
    if len(moved) != 1 or now[moved[0]] != before.get(moved[0], 0) + 1:
        raise AssertionError(f"flash_attention: one launch moved the route "
                             f"counts {before} -> {now}")
    return moved[0]


def _fwd_other_routes(fa, route, block_n, d, launch, n_sets):
    """``(mma_ms, {other_block_n, other_tile_ms})``: the device times of
    a bf16 call on the first design's ``mma`` route and, at head_dim 64,
    on the ``wgmma`` tile the plan did not pick, each through
    ``launch(i, route=, block_n=)`` (the wrapper's private arguments);
    None and {} for fp32."""
    if route == "f32":
        return None, {}
    mma_ms, _ = time_ms(lambda i: launch(i, route="mma"), n_sets)
    if d != 64:
        return mma_ms, {}
    other = fa.WGMMA_BLOCK_N[0] + fa.WGMMA_BLOCK_N[1] - block_n
    other_ms, _ = time_ms(lambda i: launch(i, route="wgmma", block_n=other),
                          n_sets)
    return mma_ms, {"other_block_n": other, "other_tile_ms": other_ms}


def fwd_case(fa, torch, dtype, b, h, s, d, with_bias, seed, n_sets=4):
    """Kernel 1 against its plain version (and SDPA, timed only) on one
    shape, launched twice and bit-equal; the route it took from the
    counts by route, and the first design's ``mma`` route and the other
    ``wgmma`` tile timed beside it (:func:`_fwd_other_routes`); returns
    the case record."""
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
    before = dict(fa.flash_attention.launches_by_route)
    out, lse = fa.flash_attention(q, k, v, causal=True, bias=bias)
    route = _fwd_route_taken(fa, before)
    again = fa.flash_attention(q, k, v, causal=True, bias=bias)
    torch.cuda.synchronize()
    if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
        raise AssertionError(f"flash_attention: a second launch differs "
                             f"({dtype}, b={b}, s={s}, bias={with_bias})")
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
    block_n = fa.plan(b, h, s, s, d, dtype, False).block_n
    mma_ms, other = _fwd_other_routes(fa, route, block_n, d, lambda i, **r:
                                      fa._launch_forward(*sets[i][:3], True,
                                                         sets[i][3], 0.0,
                                                         None, **r), n_sets)
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
            "d": d, "bias": with_bias, "route": route,
            "block_n": block_n, **other, "max_abs_err": err, "tol": tol,
            "rel_l2": rel_l2, "rel_l2_planted": planted,
            "relaunch_bit_equal": True,
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "mma_ms": mma_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


# -- kernel 2: flash decode -------------------------------------------


def _decode_bound(offsets, h, S, d, itemsize, has_bias, kv_bytes=None):
    """(bound_ms, bound_by) of one decode call over these offsets: the
    live K and V rows (``kv_bytes`` a key and head, ``2 d itemsize`` by
    default, ``2 (d + 4)`` for an int8 cache with its scales; plus q, O
    and the live bias) over HBM, against the products' FLOPs over the
    peak for the query's type."""
    b = len(offsets)
    live = sum(min(o, S - 1) + 1 for o in offsets)
    nbytes = (kv_bytes or 2 * d * itemsize) * h * live \
        + 2 * b * h * d * itemsize + (4 * live if has_bias else 0)
    flops = 4.0 * h * d * live
    peak = BF16_TENSOR_FLOPS if itemsize == 2 else FP32_CUDA_CORE_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _int8_cache(torch, shape, g, device, null_page=False):
    """``(int8 values, fp32 scales)`` of a seeded standard-normal cache
    or pool of ``shape``, quantized as the model's cache writes are
    (``model.quantize_kv``: per key and head over d); with ``null_page``
    the first page holds ``NULL_GARBAGE`` (int8 127 at scale 30/127)."""
    from paddlefleetx_tpu_torch.models.gpt.model import quantize_kv
    f = torch.randn(shape, generator=g, device=device)
    if null_page:
        f[0] = NULL_GARBAGE
    return quantize_kv(f)


def _widened(t, scale, dtype):
    """A cache in ``dtype``: as it is, or an int8 one widened with its
    scales (the library yardstick's input, made before it is timed)."""
    from paddlefleetx_tpu_torch.ops.cuda import flash_attention as fa
    if scale is None:
        return t
    return fa.dequantize_cache(t, scale).to(dtype)


def _hold_decode_launch(wrapper, before, route, out, launch, what, device):
    """Raise unless ``out``, the decode ``wrapper``'s launch (its counts
    by route were ``before``), went by the planned ``route`` and a second
    ``launch()`` on the same inputs gives the same output. On the CPU the
    wrappers run their plain versions and count nothing."""
    if device == "cpu":
        return
    import torch
    again = launch()
    now = wrapper.launches_by_route
    moved = {r: now[r] - before.get(r, 0) for r in now}
    if moved != {r: 2 * (r == route) for r in now}:
        raise AssertionError(f"{what}: two launches counted by route as "
                             f"{moved}, planned {route}")
    if not torch.equal(out, again):
        raise AssertionError(f"{what}: a second launch gave another "
                             f"output")


def decode_case(fa, torch, dtype, offsets, h, S, d, shared_bias, seed,
                n_sets=4, int8=False, device="cuda"):
    """Kernel 2 against its plain version (and SDPA, timed only): the
    ragged entry point over ``offsets``, or with ``shared_bias`` the
    shared-offset entry point at ``max(offsets)`` with a left-pad
    bias; with ``int8`` over an int8 cache and its scales (the int8
    instance). On the CPU (``device``, the tests' rehearsal) the
    wrappers run their plain versions and nothing is timed."""
    import torch.nn.functional as F
    b = len(offsets)
    g = torch.Generator(device=device).manual_seed(seed)
    off_t = torch.tensor(offsets, dtype=torch.int32, device=device)
    shared = max(offsets)
    sets = []
    for _ in range(n_sets):
        q = torch.randn((b, 1, h, d), generator=g, device=device).to(dtype)
        if int8:
            (k, ks), (v, vs) = (_int8_cache(torch, (b, h, S, d), g, device)
                                for _ in range(2))
        else:
            k, v = (torch.randn((b, h, S, d), generator=g, device=device)
                    .to(dtype) for _ in range(2))
            ks = vs = None
        bias = None
        if shared_bias:
            pad = torch.randint(0, 16, (b,), generator=g, device=device)
            bias = torch.where(
                torch.arange(S, device=device)[None, :] < pad[:, None],
                -1e9, 0.0).to(torch.float32)[:, None, None, :]
        sets.append((q, k, v, bias, ks, vs))

    def kernel(i, route=None):
        q, k, v, bias, ks, vs = sets[i]
        sc = {"k_scale": ks, "v_scale": vs} if int8 else {}
        if route is not None:
            sc["route"] = route
        if shared_bias:
            return fa.flash_decode(q, k, v, shared, bias, **sc)
        return fa.flash_decode_ragged(q, k, v, off_t, **sc)

    def plain(i, upcast=False):
        q, k, v, bias, ks, vs = sets[i]
        if upcast:
            q = q.float()
            if not int8:
                k, v = k.float(), v.float()
        return fa.flash_decode_reference(
            q, k, v, shared if shared_bias else off_t, bias, ks, vs)

    plan = fa.plan_decode(b, 1, h, S, d, dtype, int8, False, 0)
    before = dict(fa.flash_decode.launches_by_route) \
        if device != "cpu" else None
    out = kernel(0)
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    sync()
    what = f"flash_decode ({dtype}, int8 {int8}, shared_bias={shared_bias})"
    _hold_decode_launch(fa.flash_decode, before, plan.route, out,
                        lambda: kernel(0), what, device)
    ref = plain(0, upcast=True)
    err = _max_err(out, ref)
    tol = TOL[str(dtype).split(".")[-1]]
    if not torch.isfinite(out.float()).all() or err > tol:
        raise AssertionError(
            f"{what} disagrees with its plain version: max abs err "
            f"{err:.3e} > {tol:.0e} (offsets={offsets})")
    rel_l2, planted = _hold_normwise(out, ref, what)
    ms = call_ms = plain_ms = library_ms = simt_ms = None
    if device != "cpu":
        ms, call_ms = time_ms(kernel, n_sets)
        simt_ms = ms if plan.route == "simt" else time_ms(
            lambda i: kernel(i, route="simt"), n_sets)[0]
        plain_ms, _ = time_ms(plain, n_sets, iters=5)
        pos = torch.arange(S, device=device)
        offs = torch.full((b,), shared, device=device) if shared_bias \
            else off_t
        mask = (pos[None, :] <= offs[:, None])[:, None, None, :]
        tsets = []
        for q, k, v, bias, ks, vs in sets:
            m = torch.zeros(mask.shape, device=device).masked_fill(
                ~mask, float("-inf"))
            if bias is not None:
                m = m + bias
            tsets.append((q.transpose(1, 2), _widened(k, ks, dtype),
                          _widened(v, vs, dtype), m.to(dtype)))
        library_ms, _ = time_ms(lambda i: F.scaled_dot_product_attention(
            tsets[i][0], tsets[i][1], tsets[i][2], attn_mask=tsets[i][3]),
            n_sets)
    eff = [shared] * b if shared_bias else list(offsets)
    bound_ms, bound_by = _decode_bound(eff, h, S, d,
                                       sets[0][0].element_size(),
                                       shared_bias,
                                       2 * (d + 4) if int8 else None)
    rec = {"dtype": str(dtype).split(".")[-1], "b": b, "h": h, "S": S,
           "d": d, "offsets": offsets, "shared_offset_bias": shared_bias,
           "route": plan.route, "cluster": plan.cluster,
           "max_abs_err": err, "tol": tol, "rel_l2": rel_l2,
           "rel_l2_planted": planted, "ms": ms, "call_ms": call_ms,
           "simt_ms": simt_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by}
    if int8:
        rec.update(kv_cache="int8", library_computes="SDPA over the int8 "
                   "cache widened to the query dtype beforehand (the "
                   "widening not counted)")
    return rec


#: the wgmma kernels whose SASS ``build`` reads: kernels 8 and 9's route
#: (a), kernel 1's and kernels 3 and 4's bf16 kernels (the backward's
#: fp32 ones are ``flash_bwd_*_f32``; kernel 1's other routes are
#: ``flash_fwd_mma_kernel`` and ``flash_fwd_kernel``) and kernel 7's
#: wgmma route (forward and dx)
WGMMA_KERNELS = ("gmm_wgmma_", "gmm_dw_wgmma_", "flash_fwd_wgmma",
                 "flash_bwd_dkv_wgmma", "flash_bwd_dq_wgmma", "qmm_wgmma_")
#: the bf16 attention kernels, whose SASS must hold no ``HMMA``
#: (mma.sync)
NO_HMMA_KERNELS = ("flash_fwd_wgmma", "flash_bwd_")
#: the mma.sync kernels whose SASS ``build`` reads and must hold ``HMMA``:
#: the decode family's ``mma`` route (kernels 2, 5, 6a and 6b)
HMMA_KERNELS = ("decode_kernel_mma",)


def sass_tensor_ops(lib_path, names=WGMMA_KERNELS):
    """Per kernel whose name holds one of ``names``: its ``HGMMA``
    (wgmma) and ``HMMA`` (mma.sync) instructions in the built library's
    SASS, as ``cuobjdump --dump-sass`` shows it; None where the toolkit
    has no cuobjdump."""
    from paddlefleetx_tpu_torch.ops.cuda import build
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        return None
    sass = subprocess.run([tool, "--dump-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    found, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            fn = fn if any(n in fn for n in names) else None
            if fn:
                found[fn] = {"HGMMA": 0, "HMMA": 0}
        elif fn:
            for op in ("HGMMA", "HMMA"):
                if f" {op}." in line:
                    found[fn][op] += 1
    return found


def check_hmma_sass(sass) -> None:
    """Raise unless every kernel of ``HMMA_KERNELS`` is in ``sass`` and
    each of its instances holds ``HMMA`` (the tensor cores)."""
    found = {fn: v for fn, v in sass.items()
             if any(n in fn for n in HMMA_KERNELS)}
    missing = [n for n in HMMA_KERNELS if not any(n in fn for fn in found)]
    if missing or not all(v["HMMA"] > 0 for v in found.values()):
        raise AssertionError(f"build: an mma.sync kernel is missing "
                             f"{missing} or its SASS holds no HMMA: {found}")


def check_wgmma_sass(sass) -> None:
    """Raise unless every kernel of ``WGMMA_KERNELS`` is in ``sass`` and
    holds ``HGMMA``, and the bf16 attention kernels (kernel 1's wgmma
    route, kernels 3 and 4) hold no ``HMMA`` (mma.sync)."""
    missing = [n for n in WGMMA_KERNELS
               if not any(n in fn for fn in sass)]
    if missing or not all(v["HGMMA"] > 0 for v in sass.values()):
        raise AssertionError(f"build: a wgmma kernel is missing {missing} "
                             f"or its SASS holds no HGMMA: {sass}")
    mma = {fn: v for fn, v in sass.items()
           if any(n in fn for n in NO_HMMA_KERNELS) and v["HMMA"] > 0}
    if mma:
        raise AssertionError(f"build: bf16 attention kernels run mma.sync "
                             f"(HMMA): {mma}")


def phase_build():
    """Build the kernels from csrc/ (timed), save the compiler's report,
    and count the wgmma and mma.sync kernels' tensor-core instructions in
    the SASS (HGMMA in each wgmma kernel, HMMA in the decode family's
    ``mma`` route)."""
    from paddlefleetx_tpu_torch.ops.cuda import build
    t0 = time.time()
    build.load()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "nvcc.log"), "w") as f:
        f.write(str(build.last_build.get("log", "")))
    sass = sass_tensor_ops(str(build.last_build.get("path")),
                           WGMMA_KERNELS + HMMA_KERNELS)
    wgmma = hmma = None
    if sass is not None:
        wgmma = {fn: v for fn, v in sass.items()
                 if any(n in fn for n in WGMMA_KERNELS)}
        hmma = {fn: v for fn, v in sass.items() if fn not in wgmma}
        check_wgmma_sass(wgmma)
        check_hmma_sass(hmma)
    emit({"phase": "build", "seconds": round(time.time() - t0, 3),
          "nvcc_seconds": build.last_build.get("seconds"),
          "library": os.path.relpath(str(build.last_build.get("path")),
                                     ROOT),
          "wgmma_sass": wgmma, "hmma_sass": hmma})


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


# -- kernels 5, 6a, 6b: verify, paged decode, paged verify --------------

#: the serving path's decode shapes: 345M heads and head_dim, page 128,
#: capacity 1024 (8 pages a row), 16 slots at ragged offsets
PAGED_SHAPE = {"h": 16, "d": 64, "page": 128, "max_pages": 8}
PAGED_OFFSETS = [5, 1000, 127, 128, 300, 511, 640, 17, 900, 255, 256, 999,
                 42, 770, 384, 63]
#: the planted garbage in the null page 0: a kernel that read a null
#: entry (past a row's live length) would see scores ~30x the others
NULL_GARBAGE = 30.0


def _paged_table(np, offsets, window, page, max_pages, seed):
    """``(page_table [b, max_pages] int32, pool pages)``: each row's
    live pages (up to its last window query) on shuffled physical ids,
    pairs of rows sharing their first page (prefix sharing), the null
    page 0 past each row's live length."""
    rng = np.random.default_rng(seed)
    cap = page * max_pages
    live = [min(o + window - 1, cap - 1) // page + 1 for o in offsets]
    pages = 1 + sum(live)
    ids = rng.permutation(np.arange(1, pages))
    pt = np.zeros((len(offsets), max_pages), np.int32)
    n = 0
    for i, m in enumerate(live):
        pt[i, :m] = ids[n:n + m]
        n += m
    for i in range(1, len(offsets), 2):
        pt[i, 0] = pt[i - 1, 0]
    return pt, pages


def _paged_bound(offsets, window, h, d, cap, itemsize, max_pages,
                 kv_bytes=None):
    """(bound_ms, bound_by) of one decode-kernel call: the bytes each
    row's live K and V rows (up to its last query) take, read once for
    all queries (``kv_bytes`` a key and head: ``2 d itemsize`` by
    default, ``2 (d + 4)`` for an int8 cache with its scales), plus q,
    O, the offsets and the page table (when ``max_pages``), over HBM;
    against 4 d FLOPs per live (query, key) pair over the peak for the
    query's type."""
    b = len(offsets)
    keys = sum(min(o + window, cap) for o in offsets)
    pairs = sum(min(o + j + 1, cap) for o in offsets for j in range(window))
    nbytes = (kv_bytes or 2 * d * itemsize) * h * keys \
        + 2 * b * window * h * d * itemsize + 4 * b + 4 * b * max_pages
    flops = 4.0 * h * d * pairs
    peak = BF16_TENSOR_FLOPS if itemsize == 2 else FP32_CUDA_CORE_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def decode_window_case(fa, torch, kind, dtype, window, seed,
                       offsets=PAGED_OFFSETS, n_sets=4, device="cuda",
                       int8=False):
    """One case of kernel 5 (``kind`` "verify"), 6a ("paged", window 1)
    or 6b ("paged_verify") at the serving shapes: held to its plain
    version (fp32, same inputs) by max abs error and normwise, held
    EXACTLY (max abs error 0) to kernel 2 or 5 as the design promises -
    the paged kernels against the contiguous ones on the gathered cache,
    each verify query ``j`` against kernel 2 at offset ``off + j`` -
    and timed with its plain version, SDPA with a boolean mask over an
    already gathered contiguous cache (the gather not counted), and its
    bound. With ``int8`` the cache or pool is int8 with its scales (the
    int8 instances, held exactly to kernel 2 / 5's int8 instances).
    Returns the record. On the CPU (``device``, the tests' rehearsal)
    the wrappers run their plain versions, nothing is timed and the
    times are None."""
    import numpy as np
    import torch.nn.functional as F
    sh = PAGED_SHAPE
    h, d, page, max_pages = sh["h"], sh["d"], sh["page"], sh["max_pages"]
    cap = page * max_pages
    b = len(offsets)
    paged = kind != "verify"
    g = torch.Generator(device=device).manual_seed(seed)
    off = torch.tensor(offsets, dtype=torch.int32, device=device)
    pt_np, pages = _paged_table(np, offsets, window, page, max_pages, seed)
    pt = torch.as_tensor(pt_np, device=device)
    sets = []
    for _ in range(n_sets):
        q = torch.randn((b, window, h, d), generator=g,
                        device=device).to(dtype)
        shape = (pages, h, page, d) if paged else (b, h, cap, d)
        if int8:
            (k, ks), (v, vs) = (_int8_cache(torch, shape, g, device, paged)
                                for _ in range(2))
        else:
            k, v = (torch.randn(shape, generator=g, device=device).to(dtype)
                    for _ in range(2))
            ks = vs = None
            if paged:
                k[0] = NULL_GARBAGE
                v[0] = NULL_GARBAGE
        sets.append((q, k, v, ks, vs))

    def scales(ks, vs):
        return {"k_scale": ks, "v_scale": vs} if int8 else {}

    wrapper = {"paged": fa.flash_decode_paged,
               "paged_verify": fa.flash_decode_paged_verify,
               "verify": fa.flash_decode_verify}[kind]

    def kernel(i, route=None):
        q, k, v, ks, vs = sets[i]
        table = (pt,) if paged else ()
        named = {} if route is None else {"route": route}
        return wrapper(q, k, v, off, *table, **named, **scales(ks, vs))

    def contiguous(i):
        """The cache (gathered for a pool): ``(k, v, k_scale, v_scale)``."""
        _, k, v, ks, vs = sets[i]
        if paged:
            gather = (lambda t: None if t is None else
                      fa.gather_kv_pages(t, pt))
            return tuple(gather(t) for t in (k, v, ks, vs))
        return k, v, ks, vs

    def plain(i, upcast=False):
        q, k, v, ks, vs = sets[i]
        if upcast:
            q = q.float()
            if not int8:
                k, v = k.float(), v.float()
        if paged:
            return fa.flash_decode_paged_reference(q, k, v, off, pt, ks, vs)
        return fa.flash_decode_reference(q, k, v, off, None, ks, vs)

    plan = fa.plan_decode(b, window, h, cap, d, dtype, int8, paged,
                          page if paged else 0)
    before = dict(wrapper.launches_by_route) if device != "cpu" else None
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    out = kernel(0)
    sync()
    what = f"{kind} ({dtype}, window {window}, int8 {int8})"
    _hold_decode_launch(wrapper, before, plan.route, out, lambda: kernel(0),
                        what, device)
    ref = plain(0, upcast=True)
    err = _max_err(out, ref)
    tol = TOL[_dtype_name(dtype)]
    if not torch.isfinite(out.float()).all() or err > tol:
        raise AssertionError(f"{what} disagrees with its plain version: "
                             f"max abs err {err:.3e} > {tol:.0e}")
    rel_l2, planted = _hold_normwise(out, ref, what)
    # the exact checks of the design: kernel 2 or 5 on the contiguous
    # (gathered) cache, or W launches of kernel 2 (a window decoded
    # query by query, its per-query inputs and offsets made once here);
    # ``cat`` joins the per-query outputs for the check, timing leaves
    # it out
    q_split = [[st[0][:, j:j + 1].contiguous() for j in range(window)]
               for st in sets]
    off_j = [off + j for j in range(window)]

    def counterpart(i, cat=True, kv=None):
        q = sets[i][0]
        kc, vc, ksc, vsc = kv or contiguous(i)
        sc = scales(ksc, vsc)
        if kind == "verify":
            outs = [fa.flash_decode_ragged(qj, kc, vc, oj, **sc)
                    for qj, oj in zip(q_split[i], off_j)]
            return torch.cat(outs, dim=1) if cat else outs
        if kind == "paged":
            return fa.flash_decode_ragged(q, kc, vc, off, **sc)
        return fa.flash_decode_verify(q, kc, vc, off, **sc)

    exact_vs = {"verify": "kernel 2 at offset off + j, per query j",
                "paged": "kernel 2 on the gathered cache",
                "paged_verify": "kernel 5 on the gathered cache"}[kind]
    q = sets[0][0]
    same = counterpart(0)
    sync()
    exact_err = _max_err(out, same)
    if exact_err != 0.0:
        raise AssertionError(f"{what} differs from {exact_vs} by "
                             f"{exact_err:.3e}; the design makes them equal")
    ms = call_ms = plain_ms = library_ms = counterpart_ms = simt_ms = None
    if device != "cpu":
        ms, call_ms = time_ms(kernel, n_sets)
        simt_ms = ms if plan.route == "simt" else time_ms(
            lambda i: kernel(i, route="simt"), n_sets)[0]
        plain_ms, _ = time_ms(plain, n_sets, iters=5)
        # the counterpart's time, the paged ones' gather not counted:
        # kernel 2 or 5 on the same live lengths, or W launches of
        # kernel 2 (a window decoded query by query)
        csets = [contiguous(i) for i in range(n_sets)]
        counterpart_ms, _ = time_ms(lambda i: counterpart(
            i, cat=False, kv=csets[i]), n_sets)
        pos = torch.arange(cap, device=device)
        live = (pos[None, None, :] <= off[:, None, None] +
                torch.arange(window, device=device)[None, :, None])[:, None]
        lsets = []
        for i, st in enumerate(sets):
            kc, vc, ksc, vsc = contiguous(i)
            lsets.append((st[0].transpose(1, 2),
                          _widened(kc, ksc, dtype),
                          _widened(vc, vsc, dtype)))
        library_ms, _ = time_ms(lambda i: F.scaled_dot_product_attention(
            *lsets[i], attn_mask=live), n_sets)
    bound_ms, bound_by = _paged_bound(offsets, window, h, d, cap,
                                      q.element_size(),
                                      max_pages if paged else 0,
                                      2 * (d + 4) if int8 else None)
    return {"kind": kind, "dtype": _dtype_name(dtype), "b": b, "h": h,
            "kv_cache": "int8" if int8 else "query dtype",
            "d": d, "window": window, "capacity": cap,
            "route": plan.route, "chunk": plan.chunk,
            "cluster": plan.cluster,
            "page": page if paged else None, "pool_pages":
            pages if paged else None, "offsets": list(offsets),
            "max_abs_err": err, "tol": tol, "rel_l2": rel_l2,
            "rel_l2_planted": planted, "exact_vs": exact_vs,
            "exact_max_abs_err": exact_err, "ms": ms, "call_ms": call_ms,
            "simt_ms": simt_ms, "counterpart_ms": counterpart_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_computes": "SDPA, boolean mask, on the contiguous "
            "cache (the gather" + (" and the int8 widening" if int8
                                   else "") + " not counted)",
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_decode_kernels(device="cuda", int8=False):
    """Kernels 6a, 5 and 6b against their plain versions and exactly
    against kernel 2 / 5, bf16 and fp32, windows 2, 5 and 32 (with
    ``int8`` their int8 instances over int8 caches, the phases named
    ``..._int8``); returns ``{phase: cases}``, each list led by the
    serving path's case (bf16; window 5, the spec path's 4 drafts + 1,
    for the verify kernels)."""
    import torch
    from paddlefleetx_tpu_torch.ops.cuda import flash_attention as fa
    sfx = "_int8" if int8 else ""
    out = {"kernel_paged" + sfx: [], "kernel_verify" + sfx: [],
           "kernel_paged_verify" + sfx: []}
    seed = 700 if int8 else 500
    for dtype in (torch.bfloat16, torch.float32):
        out["kernel_paged" + sfx].append(decode_window_case(
            fa, torch, "paged", dtype, 1, seed, device=device, int8=int8))
        seed += 1
        for window in (5, 2, 32):
            for phase, kind in (("kernel_verify", "verify"),
                                ("kernel_paged_verify", "paged_verify")):
                out[phase + sfx].append(decode_window_case(
                    fa, torch, kind, dtype, window, seed, device=device,
                    int8=int8))
                seed += 1
    for phase, cases in out.items():
        for c in cases:
            emit({"phase": phase, **c})
    return out


def phase_int8_decode_kernels(device="cuda"):
    """The int8 instances of kernels 2, 5, 6a and 6b (``kv_cache_dtype:
    int8``) against their plain versions at the shapes of kernel 2's
    phase and of :func:`phase_decode_kernels`, each of 5, 6a and 6b also
    exactly against kernel 2 / 5's int8 instance; returns ``(kernel 2
    cases, {phase: cases})``."""
    import torch
    from paddlefleetx_tpu_torch.ops.cuda import flash_attention as fa
    offsets = [0, 1, 127, 128, 511, 1023, 700, 300]
    dec = []
    seed = 600
    for shared_bias in (False, True):
        for dtype in (torch.bfloat16, torch.float32):
            dec.append(decode_case(fa, torch, dtype, offsets, 16, 1024, 64,
                                   shared_bias, seed, int8=True,
                                   device=device))
            seed += 1
    dec.append(decode_case(fa, torch, torch.bfloat16, offsets[:4], 8, 512,
                           128, False, seed, int8=True, device=device))
    for c in dec:
        emit({"phase": "kernel2_int8", **c})
    return dec, phase_decode_kernels(device, int8=True)


# -- kernel 7: the weight-only int8 matmul ------------------------------

#: the 345M dense sites ``(name, K, N)``: qkv, out, fc1, fc2
QMM_SITES = (("qkv", 1024, 3072), ("out", 1024, 1024), ("fc1", 1024, 4096),
             ("fc2", 4096, 1024))
#: M at those sites: a 16-slot decode tick, its verify window (16 x 5), a
#: paged prefill chunk (two 128-token pages) and a contiguous prompt;
#: bf16 also the gradient phase's forward (4 x 1024 tokens)
QMM_ROWS = (16, 80, 256, 512)
QMM_BF16_ROWS = QMM_ROWS + (4096,)
#: kernel 7 against its plain version in fp32 on the same inputs, whose
#: outputs have std 0.5: bf16 is the output's own rounding (half an ulp,
#: 7.8e-3 in [2, 4)); fp32 the JAX kernel test's atol, for fp32 sums of
#: up to 4096 products in another order
TOL_QMM = {"bfloat16": 2e-2, "float32": 1e-4}
#: weight bytes each timed case rotates through, beyond the 50 MB L2: at
#: decode a tick reads all 24 layers' weights (302 MB int8) once
QMM_COLD_BYTES = 128e6


def _qmm_bound(m, k, n, itemsize):
    """(bound_ms, bound_by) of one kernel 7 call: x, the int8 weight,
    the fp32 scales and the output moved once over HBM, against 2 M K N
    FLOPs over the peak for x's type (bf16 tensor cores, fp32 CUDA
    cores)."""
    nbytes = m * k * itemsize + k * n + 4 * n + m * n * itemsize
    flops = 2.0 * m * k * n
    peak = BF16_TENSOR_FLOPS if itemsize == 2 else FP32_CUDA_CORE_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _tile_rel_l2(out, ref, tile=TILE):
    """The worst ``tile x tile`` output tile's ``||out - ref||_2 /
    ||ref||_2`` of two ``[M, N]`` matrices (M padded to the tile; an N
    narrower than the tile, as a LoRA bank's rank, is one column of
    tiles)."""
    import torch.nn.functional as F
    m, n = ref.shape
    tn = min(tile, n)
    pad = (0, 0, 0, -m % tile)
    diff = F.pad(out.float() - ref.float(), pad)
    norm = F.pad(ref.float(), pad)

    def tiles(t):
        return t.reshape(-1, tile, n // tn, tn).pow(2).sum(
            dim=(1, 3)).sqrt()
    return float((tiles(diff) / tiles(norm).clamp_min(1e-30)).max())


def _hold_tiles(out, ref, what):
    """``(reading, planted)`` of :func:`_tile_rel_l2`: within
    ``TOL_REL_L2``, and refused with one ``TILE``-column block of the
    output zeroed."""
    tol = TOL_REL_L2[_dtype_name(out.dtype)]
    reading = _tile_rel_l2(out, ref)
    wrong = out.clone()
    c0 = (out.shape[1] // 2) // TILE * TILE
    wrong[:, c0:c0 + TILE] = 0
    planted = _tile_rel_l2(wrong, ref)
    if not reading <= tol < planted:
        raise AssertionError(
            f"{what}: tile normwise error {reading:.3e} (planted fault "
            f"{planted:.3e}) is not within {tol:.0e} < planted")
    return reading, planted


def _qmm_route_counts(qmm, dx) -> dict:
    """Kernel 7's launch counts by route (``dx``: its dx route's)."""
    return dict(getattr(qmm.quantized_matmul, "dx_launches_by_route" if dx
                        else "launches_by_route", None) or {})


def _qmm_held(qmm, torch, op, dtype, m, k, n, call, what, device):
    """Launch one kernel 7 call twice (``call()``): the two outputs
    bit-equal, the launch counted under the planned route. Returns
    ``(output, route, plan)``."""
    dx = op == "dx"
    before = _qmm_route_counts(qmm, dx)
    out = call()
    route = _route_moved(before, _qmm_route_counts(qmm, dx))
    again = call()
    if device != "cpu":
        torch.cuda.synchronize()
    planned = qmm.plan(op, m, k, n, dtype)
    if device != "cpu" and route != planned.route:
        raise AssertionError(f"{what}: launched on {route}, planned "
                             f"{planned}")
    if not torch.equal(out, again):
        raise AssertionError(f"{what}: two launches on the same inputs "
                             f"differ")
    return out, route, planned


def _qmm_routes_ms(qmm, torch, op, m, k, n, dtype, run, n_sets):
    """``({route: device ms}, max active clusters)`` of kernel 7 at this
    call: every route that takes it (bf16: ``stream`` up to
    ``STREAM_MAX_M`` rows, ``wgmma``, and ``mma``, the first design,
    which the planner sends nothing; fp32: ``f32``) through the
    wrapper's private ``route`` argument, ``run(i, route)``, and the
    clusters of the planned stream or wgmma kernel that fit on the card
    at once."""
    if dtype == torch.float32:
        routes = ("f32",)
    else:
        routes = tuple(r for r in ("stream", "wgmma", "mma")
                       if r != "stream" or m <= qmm.STREAM_MAX_M)
    times = {r: time_ms(lambda i: run(i, r), n_sets)[0] for r in routes}
    planned = qmm.plan(op, m, k, n, dtype)
    clusters = None
    if planned.route in ("stream", "wgmma"):
        clusters = qmm.max_active_clusters(op, m, k, n, planned)
    return times, clusters


def qmm_case(qmm, torch, dtype, site, m, k, n, seed, device="cuda"):
    """Kernel 7 against its plain version (fp32, the same inputs) by max
    abs error and per 64 x 64 output tile normwise, with a planted fault;
    launched twice, bit-equal, on the planned route (read from the counts
    by route); timed with its plain version, every other route that takes
    the shape (the ``mma`` route is the first design), the library
    yardstick (``F.linear`` on the weight dequantized to x's type
    beforehand: cuBLAS over twice the int8 weight's bytes, four times in
    fp32) and, where this PyTorch has it on the card,
    ``torch._weight_int8pack_mm``, over input sets whose weights together
    exceed the L2 cache (up to M 512; one set at the compute-bound M
    4096). Returns the record. On the CPU (``device``) the wrapper runs
    its plain version and nothing is timed."""
    import math
    import torch.nn.functional as F
    g = torch.Generator(device=device).manual_seed(seed)
    n_sets = 1 if device == "cpu" or m > 512 else \
        max(4, math.ceil(QMM_COLD_BYTES / (k * n)))
    # int8 uniform in [-127, 127] has std 73.6: these scales give
    # outputs of std ~0.5
    unit = 0.5 / (73.6 * k ** 0.5)
    sets = []
    for _ in range(n_sets):
        x = torch.randn((m, k), generator=g, device=device).to(dtype)
        w = torch.randint(-127, 128, (n, k), generator=g, device=device,
                          dtype=torch.int8)
        scale = unit * (0.75 + 0.5 * torch.rand(n, generator=g,
                                                device=device))
        sets.append((x, w, scale))
    x, w, scale = sets[0]
    name = _dtype_name(dtype)
    tol = TOL_QMM[name]
    what = f"quantized_matmul ({name}, {site}, M={m}, K={k}, N={n})"
    out, route, planned = _qmm_held(
        qmm, torch, "fwd", dtype, m, k, n,
        lambda: qmm.quantized_matmul(x, w, scale), what, device)
    ref = qmm.quantized_matmul_reference(x.float(), w, scale)
    err = _max_err(out, ref)
    if out.shape != (m, n) or out.dtype != dtype or \
            not torch.isfinite(out.float()).all() or err > tol:
        raise AssertionError(f"{what} disagrees with its plain version: "
                             f"max abs err {err:.3e} > {tol:.0e}")
    rel_l2, planted = _hold_tiles(out, ref, what)
    ms = call_ms = plain_ms = library_ms = int8pack_ms = None
    routes_ms = clusters = None
    if device != "cpu":
        ms, call_ms = time_ms(lambda i: qmm.quantized_matmul(*sets[i]),
                              n_sets)
        routes_ms, clusters = _qmm_routes_ms(
            qmm, torch, "fwd", m, k, n, dtype,
            lambda i, r: qmm._launch(*sets[i], route=r), n_sets)
        plain_ms, _ = time_ms(lambda i: qmm.quantized_matmul_reference(
            *sets[i]), n_sets, iters=5)
        dq = [(xs, (ws.float() * ss[:, None]).to(dtype))
              for xs, ws, ss in sets]
        library_ms, _ = time_ms(lambda i: F.linear(*dq[i]), n_sets)
        del dq
        try:
            torch._weight_int8pack_mm(x, w, scale.to(dtype))
            int8pack_ms, _ = time_ms(lambda i: torch._weight_int8pack_mm(
                sets[i][0], sets[i][1], sets[i][2].to(dtype)), n_sets)
        except (RuntimeError, NotImplementedError, AttributeError):
            int8pack_ms = None   # not in this build for CUDA / this dtype
    bound_ms, bound_by = _qmm_bound(m, k, n, x.element_size())
    return {"dtype": name, "site": site, "M": m, "K": k, "N": n,
            "route": route, "splits": planned.splits,
            "max_active_clusters": clusters, "bit_equal_rerun": True,
            "max_abs_err": err, "tol": tol, "rel_l2": rel_l2,
            "rel_l2_planted": planted, "ms": ms, "call_ms": call_ms,
            "ms_routes": routes_ms,
            "ms_mma": (routes_ms or {}).get("mma"),
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_computes": "F.linear on the weight dequantized to "
            "x's dtype (cuBLAS)", "int8pack_ms": int8pack_ms,
            "int8pack_computes": "torch._weight_int8pack_mm (x, int8 "
            "[N, K], scales in x's dtype)", "bound_ms": bound_ms,
            "bound_by": bound_by, "weight_sets": n_sets}


def phase_kernel_qmm(device="cuda", rows=QMM_ROWS, sites=QMM_SITES,
                     bf16_rows=QMM_BF16_ROWS):
    """Kernel 7 at the four 345M site shapes x ``bf16_rows`` in bf16 and
    x ``rows`` in fp32; returns the cases, led by the decode tick's
    (bf16, M 16, qkv)."""
    import torch
    from paddlefleetx_tpu_torch.ops.cuda import quantized_matmul as qmm
    cases = []
    seed = 800
    for dtype in (torch.bfloat16, torch.float32):
        for m in (bf16_rows if dtype == torch.bfloat16 else rows):
            for site, k, n in sites:
                cases.append(qmm_case(qmm, torch, dtype, site, m, k, n, seed,
                                      device))
                seed += 1
                if device != "cpu":
                    torch.cuda.empty_cache()
    for c in cases:
        emit({"phase": "kernel_qmm", **c})
    return cases


# -- kernels 8 and 9: the grouped GEMM ---------------------------------

#: the 8x345M MoE recipe's expert GEMMs at micro batch 2 x 1024 tokens:
#: G = E x b = 16 (expert, row) groups, rep = b = 2, C = ceil(2 x 1024 x
#: 1.25 / 8) = 320 slots, h = 1024, m = 4096; ``(name, K, N)`` of each
#: call's x [G, C, K] @ [K, N] (dx: the forward's w read transposed; dw:
#: x^T dy into the fp32 [Gw, K, N])
GMM_GROUPS = {"G": 16, "Gw": 8, "C": 320}
GMM_CALLS = (("fc1", 1024, 4096), ("fc2", 4096, 1024),
             ("fc1_dx", 4096, 1024), ("fc2_dx", 1024, 4096),
             ("fc1_dw", 1024, 4096), ("fc2_dw", 4096, 1024))
#: groups planted empty: group 5 (expert 2 keeps its other row) and both
#: of expert 3's (6, 7), whose dw must then be all zeros
GMM_EMPTY = (5, 6, 7)
#: kernels 8 and 9 against their plain versions in fp32 on the same
#: inputs (outputs of std ~0.5): kernel 7's tolerances
TOL_GMM = TOL_QMM


def _gmm_bound(kind, counts, gw, c, k, n, itemsize):
    """(bound_ms, bound_by) of one call at this run's counts: FLOPs 2 C
    K N a live group (all its C rows); bytes: kernel 8 reads x of the
    live groups and the weights of the experts with one, writes all of
    out; kernel 9 reads x and dy of the live groups and writes the fp32
    dw. bf16 on the tensor cores, fp32 on the CUDA cores."""
    g = len(counts)
    rep = g // gw
    live = [x > 0 for x in counts]
    n_live = sum(live)
    flops = 2.0 * c * k * n * n_live
    if kind == "dw":
        nbytes = n_live * c * (k + n) * itemsize + gw * k * n * 4
    else:
        experts = sum(any(live[e * rep:(e + 1) * rep]) for e in range(gw))
        nbytes = n_live * c * k * itemsize + experts * k * n * itemsize \
            + g * c * n * itemsize
    nbytes += 4 * g
    peak = BF16_TENSOR_FLOPS if itemsize == 2 else FP32_CUDA_CORE_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _gmm_counts(torch, g, c, empty, gen, device):
    """Seeded live rows per group, uniform in [max(1, C / 2), C], the
    ``empty`` groups 0 (the recipe's routing at capacity factor 1.25
    fills most slots)."""
    counts = torch.randint(max(1, c // 2), c + 1, (g,), generator=gen,
                           device=device, dtype=torch.int32)
    counts[list(empty)] = 0
    return counts


def _grouped_mm_ms(torch, a, b):
    """``torch._grouped_mm`` of ``a [Gw, M, K]`` and ``b [Gw, K, N]``
    (PyTorch's grouped GEMM, timed as a yardstick only) and how it was
    called, or None and why it was not."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, "absent in this PyTorch"
    if a.dtype != torch.bfloat16:
        return None, "not called: it takes bf16"
    last = None
    for label, bb in (("b as stored", b),
                      ("b column-major", b.transpose(1, 2).contiguous()
                       .transpose(1, 2))):
        try:
            fn(a, bb)
            return time_ms(lambda i: fn(a, bb), 1)[0], label
        except (RuntimeError, TypeError, NotImplementedError) as err:
            last = f"refused: {str(err).splitlines()[0][:120]}"
    return None, last


def _route_counts(gmm, kind) -> dict:
    """The launch counts by route of kernel 8 (``kind`` fwd or dx) or 9
    (dw); empty for a stand-in module without them."""
    wrapper = getattr(gmm, "grouped_matmul_dw" if kind == "dw"
                      else "grouped_matmul", None)
    return dict(getattr(wrapper, "launches_by_route", None) or {})


def _route_moved(before, now):
    """The one route whose launch count moved from ``before`` to ``now``,
    or None where none did (a stand-in that counts nothing)."""
    moved = [r for r in now if now[r] != before.get(r, 0)]
    if len(moved) > 1:
        raise AssertionError(f"one call moved the counts of {moved}")
    return moved[0] if moved else None


def _route_taken(gmm, kind, before):
    """The one kernel 8 / 9 route whose launch count moved since
    ``before`` (:func:`_route_moved`)."""
    return _route_moved(before, _route_counts(gmm, kind))


def routes_by_kernel(counts) -> dict:
    """Kernels 2, 5, 6a and 6b, 7 (forward and dx), 8 and 9's launches by
    route out of :func:`read_counts`."""
    return {name: counts[f"{name}_routes"]
            for name in ("grouped_matmul", "grouped_matmul_dw",
                         "quantized_matmul", "quantized_matmul_dx",
                         *DECODE_KERNELS)}


def check_fwd_routes(counts, label):
    """Every kernel 1 launch of a path counted under one route, and none
    on ``mma``: the planner sends every bf16 call to ``wgmma`` (fp32 runs
    ``f32``)."""
    routes = counts["flash_attention_routes"]
    if sum(routes.values()) != counts["flash_attention"] or \
            routes.get("mma", 0):
        raise AssertionError(f"{label}: flash_attention launched "
                             f"{counts['flash_attention']} times, by route "
                             f"{routes} (no mma allowed)")


def check_qmm_routes(counts, label, dx=False):
    """Every kernel 7 launch (``dx``: of its dx route) of a path counted
    under one route, and none on ``mma``: the planner sends the path's
    bf16 shapes to ``stream`` or ``wgmma`` (fp32 runs ``f32``)."""
    key = "quantized_matmul_dx" if dx else "quantized_matmul"
    routes = counts[f"{key}_routes"]
    if sum(routes.values()) != counts[key] or routes.get("mma", 0):
        raise AssertionError(f"{label}: {key} launched {counts[key]} "
                             f"times, by route {routes} (no mma allowed)")


def gmm_case(gmm, torch, dtype, call, k, n, seed, device="cuda",
             groups=GMM_GROUPS, empty=GMM_EMPTY):
    """One expert GEMM of the recipe through kernel 8 (forward, or dx
    over the transposed weight) or kernel 9 (dw) against its plain
    version (fp32 math on the same inputs), by max abs error and per 64
    x 64 output tile normwise (planted fault refused), with the planted
    empty groups (and expert 3's dw) exactly zero where ``empty`` names
    any, and in the fc2 calls
    the padding rows non-zero (dy is non-zero on every row); launched
    twice, the two outputs bit-identical; the route it took read from
    the counts by route; timed with its plain version, the mma kernels
    that held every shape before the wgmma and split routes (fp32: its
    one kernel) through the wrapper's
    private route argument, ``torch.bmm`` over ``x.view(Gw, rep C, K)``
    (the same function when no group is empty) and ``torch._grouped_mm``
    where this PyTorch has it. On the CPU the wrappers run their plain
    versions and nothing is timed."""
    g, gw, c = groups["G"], groups["Gw"], groups["C"]
    rep = g // gw
    kind = call.split("_")[-1] if "_" in call else "fwd"
    gen = torch.Generator(device=device).manual_seed(seed)
    counts = _gmm_counts(torch, g, c, empty, gen, device)
    rows = (torch.arange(c, device=device)[None, :, None] <
            counts[:, None, None].long())

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device) *
                scale).to(dtype)
    # x [G, C, K]: the rows past a group's count are zero in the fc1
    # input (the dispatch's zero slots) and one non-zero row in the fc2
    # input (its padding rows are gelu(b1)), so there a kernel that
    # skipped rows of a live group, or read an empty one, disagrees;
    # outputs of std ~0.5
    pad = randn(1, 1, k).float() if call.startswith("fc2") else 0.0
    x = torch.where(rows, randn(g, c, k).float(), pad).to(dtype)
    before = _route_counts(gmm, kind)
    prev_route = "f32" if dtype == torch.float32 else "mma"
    if kind == "dw":
        dy = randn(g, c, n, scale=0.5 / (rep * c) ** 0.5)
        out = gmm.grouped_matmul_dw(x, dy, counts, gw)
        route = _route_taken(gmm, kind, before)
        ref = gmm.grouped_matmul_dw_reference(x, dy, counts, gw)

        def run():
            return gmm.grouped_matmul_dw(x, dy, counts, gw)

        def prev():
            return gmm._launch_dw(x, dy, counts, gw, route=prev_route)

        def plain():
            return gmm.grouped_matmul_dw_reference(x, dy, counts, gw)
        a = x.view(gw, rep * c, k).transpose(1, 2)
        b = dy.view(gw, rep * c, n)
        # the experts whose groups are all empty
        zero = out[[e for e in range(gw) if set(range(e * rep, e * rep + rep))
                    <= set(empty)]]
    else:
        # the forward's w [Gw, K', N'] is stored with N' contiguous; dx
        # reads it transposed, [N', K'] with K' contiguous
        w = randn(gw, n, k, scale=0.5 / k ** 0.5).transpose(1, 2) \
            if kind == "dx" else randn(gw, k, n, scale=0.5 / k ** 0.5)
        if kind == "dx":
            out = gmm.grouped_matmul_dx(x, w.transpose(1, 2), counts)
        else:
            out = gmm.grouped_matmul(x, w, counts)
        route = _route_taken(gmm, kind, before)
        ref = gmm.grouped_matmul_reference(x.float(), w.float(), counts)

        def run():
            if kind == "dx":
                return gmm.grouped_matmul_dx(x, w.transpose(1, 2), counts)
            return gmm.grouped_matmul(x, w, counts)

        def prev():
            return gmm._launch(x, w, counts, route=prev_route)

        def plain():
            return gmm.grouped_matmul_reference(x, w, counts)
        a, b = x.view(gw, rep * c, k), w
        zero = out[list(empty)]
    again = run()
    if device != "cpu":
        torch.cuda.synchronize()
    name = _dtype_name(dtype)
    tol = TOL_GMM[name]
    err = _max_err(out, ref)
    what = f"grouped_matmul{'_dw' if kind == 'dw' else ''} ({name}, {call})"
    if device != "cpu" and route is None:
        raise AssertionError(f"{what}: no route's launch count moved")
    if not torch.equal(out, again):
        raise AssertionError(f"{what}: two launches on the same inputs "
                             f"differ")
    if not torch.isfinite(out.float()).all() or err > tol:
        raise AssertionError(f"{what} disagrees with its plain version: "
                             f"max abs err {err:.3e} > {tol:.0e}")
    if empty and (not zero.numel() or zero.abs().max() != 0):
        raise AssertionError(f"{what}: a planted empty group is not zeros")
    rel_l2, planted = _hold_tiles(out.reshape(-1, out.shape[-1]),
                                  ref.reshape(-1, ref.shape[-1]), what)
    ms = call_ms = plain_ms = bmm_ms = gmm_ms = prev_ms = None
    gmm_how = "not timed on the CPU"
    if device != "cpu":
        ms, call_ms = time_ms(lambda i: run(), 1)
        prev_ms, _ = time_ms(lambda i: prev(), 1)
        plain_ms, _ = time_ms(lambda i: plain(), 1, iters=3, warmup=1)
        bmm_ms, _ = time_ms(lambda i: torch.bmm(a, b), 1)
        gmm_ms, gmm_how = _grouped_mm_ms(torch, a, b)
    bound_ms, bound_by = _gmm_bound(kind, counts.tolist(), gw, c, k, n,
                                    x.element_size())
    return {"dtype": name, "call": call, "kernel": "grouped_matmul_dw"
            if kind == "dw" else "grouped_matmul", "G": g, "Gw": gw,
            "C": c, "K": k, "N": n, "empty_groups": list(empty),
            "live_groups": int((counts > 0).sum()),
            "max_abs_err": err, "tol": tol, "rel_l2": rel_l2,
            "rel_l2_planted": planted,
            "empty_exact_zero": True if empty else None,
            "bit_equal_rerun": True, "route": route,
            "ms": ms, "call_ms": call_ms, "ms_prev_design": prev_ms,
            "prev_design": f"the {prev_route} route, alone before the "
            f"wgmma and split routes",
            "plain_ms": plain_ms,
            "library_ms": bmm_ms, "library_computes":
            "torch.bmm over x.view(Gw, rep C, K) (dw: x^T and dy so "
            "viewed; output in x's dtype)", "grouped_mm_ms": gmm_ms,
            "grouped_mm_call": gmm_how, "bound_ms": bound_ms,
            "bound_by": bound_by}


def phase_kernel_gmm(device="cuda", groups=GMM_GROUPS, calls=GMM_CALLS):
    """Kernels 8 and 9 at the recipe's six expert-GEMM calls (fc1, fc2,
    their dx and dw), bf16 and fp32; returns the cases, led by bf16
    fc1."""
    import torch
    from paddlefleetx_tpu_torch.ops.cuda import grouped_matmul as gmm
    cases = []
    seed = 900
    for dtype in (torch.bfloat16, torch.float32):
        for call, k, n in calls:
            cases.append(gmm_case(gmm, torch, dtype, call, k, n, seed,
                                  device, groups))
            seed += 1
            if device != "cpu":
                torch.cuda.empty_cache()
    for c in cases:
        emit({"phase": "kernel_gmm", **c})
    return cases


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
    same Philox bits, launched twice and bit-equal; the kept fraction over
    the causal entries; rate 0 bit-identical to the launch without
    dropout; the route taken and the ``mma`` route timed beside it (bf16).
    Returns the record."""
    import torch.nn.functional as F
    sets = _qkv_sets(torch, dtype, b, h, s, d, with_bias, seed, n_sets)
    dseed = 1000 + seed
    q, k, v, _, bias = sets[0]
    before = dict(fa.flash_attention.launches_by_route)
    out, lse = fa.flash_attention(q, k, v, True, bias, rate, dseed)
    route = _fwd_route_taken(fa, before)
    again = fa.flash_attention(q, k, v, True, bias, rate, dseed)
    torch.cuda.synchronize()
    if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
        raise AssertionError(f"flash_attention with dropout: a second "
                             f"launch differs ({dtype}, bias={with_bias})")
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
    block_n = fa.plan(b, h, s, s, d, dtype, True).block_n
    mma_ms, other = _fwd_other_routes(fa, route, block_n, d, lambda i, **r:
                                      fa._launch_forward(*sets[i][:3], True,
                                                         sets[i][4], rate,
                                                         dseed + i, **r),
                                      n_sets)
    tsets = [tuple(t.transpose(1, 2).contiguous() for t in st[:3]) +
             (None if st[4] is None else _causal_mask(torch, s, st[4], dtype),)
             for st in sets]
    library_ms, _ = time_ms(lambda i: F.scaled_dot_product_attention(
        *tsets[i][:3], attn_mask=tsets[i][3], dropout_p=rate,
        is_causal=tsets[i][3] is None), n_sets)
    bound_ms, bound_by = _fwd_bound(b, h, s, s, d, q.element_size(), True,
                                    with_bias)
    return {"dtype": _dtype_name(dtype), "b": b, "h": h, "s": s, "d": d,
            "bias": with_bias, "dropout": rate, "route": route,
            "block_n": block_n, **other, "max_abs_err": err,
            "tol": tol, "rel_l2": rel_l2, "rel_l2_planted": planted,
            "kept_fraction": kept, "rate0_bit_identical": True,
            "relaunch_bit_equal": True,
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "mma_ms": mma_ms,
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


#: the backward's cases (regime, b, s, d, bias, dropout), each in bf16
#: and fp32: the recipe's shape (b 8, h 16, s 1024, d 64, the TPU's
#: ``_bwd_combined_kernel`` regime) with and without dropout 0.1, a
#: [b, 1, 1, s] bias (the split-pair regime), b 2, s 4096 (the
#: ``_bwd_fused_kernel`` regime); the first is the training path's
BWD_CASES = (("combined", 8, 1024, 64, False, 0.1),
             ("combined", 8, 1024, 64, False, 0.0),
             ("split", 8, 1024, 64, True, 0.0),
             ("fused", 2, 4096, 64, False, 0.0))
#: bf16 only: a ragged length (s 1000: not a multiple of the kernels'
#: 64-row tiles or 128-row blocks) and head_dim 128
BWD_CASES_BF16 = (("ragged", 8, 1000, 64, False, 0.1),
                  ("d128", 4, 1024, 128, False, 0.1))


def phase_backward():
    """Kernels 3 and 4 at every case of ``BWD_CASES`` in bf16 and fp32,
    then ``BWD_CASES_BF16`` in bf16."""
    import torch
    from paddlefleetx_tpu_torch.ops.cuda import flash_attention as fa
    cases = []
    seed = 400
    runs = [(torch.bfloat16, c) for c in BWD_CASES]
    runs += [(torch.float32, c) for c in BWD_CASES]
    runs += [(torch.bfloat16, c) for c in BWD_CASES_BF16]
    for dtype, (regime, b, s, d, with_bias, rate) in runs:
        cases.append(bwd_case(fa, torch, dtype, b, 16, s, d, with_bias,
                              rate, seed, regime))
        seed += 1
        torch.cuda.empty_cache()
    for c in cases:
        emit({"phase": "backward", **c})
    return cases


#: the 1.3B recipes' attention shape (b 8, h 16, s 1024, head_dim 128,
#: causal, dropout 0.1, bf16), where ``train_auto_1p3b`` runs kernels 1,
#: 3 and 4
SHAPE_1P3B = {"b": 8, "h": 16, "s": 1024, "d": 128, "rate": 0.1}


def phase_kernel1_1p3b():
    """Kernel 1 with dropout at the 1.3B training shape (``SHAPE_1P3B``,
    bf16): held to its plain version, launched twice and bit-equal, its
    route and the other routes timed, SDPA with ``dropout_p`` 0.1
    beside it, and its bound."""
    import torch
    from paddlefleetx_tpu_torch.ops.cuda import flash_attention as fa
    from paddlefleetx_tpu_torch.ops.cuda import philox
    c = SHAPE_1P3B
    rec = fwd_dropout_case(fa, philox, torch, torch.bfloat16, c["b"], c["h"],
                           c["s"], c["d"], False, 310, rate=c["rate"])
    emit({"phase": "kernel1_1p3b", **rec})
    torch.cuda.empty_cache()
    return rec


def phase_backward_1p3b():
    """Kernels 3 and 4 at the 1.3B training shape (``SHAPE_1P3B``,
    bf16, dropout 0.1) against the plain backward, each launched alone
    and equal to the wrapper's launch, timed beside the plain backward
    and SDPA's backward, with their bounds."""
    import torch
    from paddlefleetx_tpu_torch.ops.cuda import flash_attention as fa
    c = SHAPE_1P3B
    rec = bwd_case(fa, torch, torch.bfloat16, c["b"], c["h"], c["s"], c["d"],
                   False, c["rate"], 410, "1p3b")
    emit({"phase": "backward_1p3b", **rec})
    torch.cuda.empty_cache()
    return rec


# -- the serving path ---------------------------------------------------


#: the decode kernels' wrappers, each counting its bf16/fp32 instance in
#: ``launches`` and its int8 instance in ``launches_int8``
DECODE_KERNELS = ("flash_decode", "flash_decode_verify", "flash_decode_paged",
                  "flash_decode_paged_verify")
#: the launch counts :func:`read_counts` reports for them
DECODE_COUNTS = DECODE_KERNELS + tuple(k + "_int8" for k in DECODE_KERNELS)


def reset_counts():
    """Zero every kernel's launch count and the process-global registry
    (enabled), just before a run whose counts are read."""
    from paddlefleetx_tpu_torch.observability import metrics
    from paddlefleetx_tpu_torch.ops.cuda import flash_attention as fa
    from paddlefleetx_tpu_torch.ops.cuda import grouped_matmul as gmm
    from paddlefleetx_tpu_torch.ops.cuda import quantized_matmul as qmm
    fa.flash_attention.launches = 0
    fa.flash_attention.launches_by_route = dict.fromkeys(fa.ROUTES, 0)
    for name in DECODE_KERNELS:
        getattr(fa, name).launches = 0
        getattr(fa, name).launches_int8 = 0
        getattr(fa, name).launches_by_route = dict.fromkeys(fa.DECODE_ROUTES,
                                                            0)
    fa.flash_attention_backward.launches_dkv = 0
    fa.flash_attention_backward.launches_dq = 0
    qmm.quantized_matmul.launches = 0
    qmm.quantized_matmul.dx_launches = 0
    qmm.quantized_matmul.launches_by_route = dict.fromkeys(qmm.ROUTES, 0)
    qmm.quantized_matmul.dx_launches_by_route = dict.fromkeys(qmm.ROUTES, 0)
    for wrapper in (gmm.grouped_matmul, gmm.grouped_matmul_dw):
        wrapper.launches = 0
        wrapper.launches_by_route = dict.fromkeys(gmm.ROUTES, 0)
    metrics.set_enabled(True)
    metrics.get_registry().reset()


def read_counts() -> dict:
    """Every kernel's launch count and the registry's ``attention/*``,
    ``quant/*``, ``moe/*``, ``lora/*`` and ``serving/*`` counters, just
    after a run."""
    from paddlefleetx_tpu_torch.observability import metrics
    from paddlefleetx_tpu_torch.ops.cuda import flash_attention as fa
    from paddlefleetx_tpu_torch.ops.cuda import grouped_matmul as gmm
    from paddlefleetx_tpu_torch.ops.cuda import quantized_matmul as qmm
    counters = metrics.get_registry().snapshot()["counters"]
    counts = {"flash_attention": fa.flash_attention.launches,
              "flash_bwd_dkv": fa.flash_attention_backward.launches_dkv,
              "flash_bwd_dq": fa.flash_attention_backward.launches_dq,
              "quantized_matmul": qmm.quantized_matmul.launches,
              "quantized_matmul_dx": qmm.quantized_matmul.dx_launches,
              "grouped_matmul": gmm.grouped_matmul.launches,
              "grouped_matmul_dw": gmm.grouped_matmul_dw.launches,
              "grouped_matmul_routes":
              dict(gmm.grouped_matmul.launches_by_route),
              "grouped_matmul_dw_routes":
              dict(gmm.grouped_matmul_dw.launches_by_route),
              "quantized_matmul_routes":
              dict(qmm.quantized_matmul.launches_by_route),
              "quantized_matmul_dx_routes":
              dict(qmm.quantized_matmul.dx_launches_by_route),
              "flash_attention_routes":
              dict(fa.flash_attention.launches_by_route),
              "counters": {k: v for k, v in sorted(counters.items())
                           if k.startswith(("attention/", "quant/", "moe/",
                                            "lora/", "serving/"))}}
    for name in DECODE_KERNELS:
        counts[name] = getattr(fa, name).launches
        counts[name + "_int8"] = getattr(fa, name).launches_int8
        counts[name + "_routes"] = dict(getattr(fa, name).launches_by_route)
    return counts


def check_decode_routes(counts, label, dtype):
    """Every launch of kernels 2, 5, 6a and 6b on a path, bf16 and int8
    caches alike, counted under the route its query type plans: ``mma``
    for a bf16 model, with none on ``simt``; ``simt`` for fp32."""
    want = "mma" if dtype == "bfloat16" else "simt"
    for name in DECODE_KERNELS:
        routes = counts[name + "_routes"]
        n = counts[name] + counts[name + "_int8"]
        if routes.get(want, 0) != n or sum(routes.values()) != n:
            raise AssertionError(f"{label}: {name} launched {n} times, by "
                                 f"route {routes} (all {want} for "
                                 f"{dtype})")


def seeded_prompts(n, lo, hi, vocab, seed):
    """``n`` prompts of uniform random tokens, lengths uniform in
    ``lo..hi``, from ``numpy.random.default_rng(seed)``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(m)).tolist()
            for m in rng.integers(lo, hi + 1, size=n)]


def launched_ticks(summary) -> int:
    """The decode ticks a server launched: one a tick at T = 1; with
    ``device_loop_ticks`` > 1 every loop iteration, a masked one past
    the loop's exit too, plus the eager warm-up tick before a capture
    (:class:`~paddlefleetx_tpu_torch.core.decode_graph.TickGraph`)."""
    return summary.get("ticks_replayed", summary["decode_ticks"]) + \
        summary.get("graph_warmups", 0)


def check_serve_counts(counts, summary, layers, label):
    """Every admission was one kernel-1 launch per layer, every tick one
    kernel-2 launch per layer, and nothing took the dense path."""
    c = counts["counters"]
    want = {"flash_attention": summary["admitted"] * layers,
            "flash_decode": launched_ticks(summary) * layers}
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
    check_fwd_routes(counts, "serve")
    check_decode_routes(counts, "serve", cfg.dtype)
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
        "launches_by_route": {
            "flash_attention": counts["flash_attention_routes"],
            **routes_by_kernel(counts)},
        "counters": counts["counters"]}
    if device != "cpu":
        record["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    emit(record)
    record["prompts"] = prompts
    record["tokens"] = [c.tokens for c in completions]
    return record, module


#: kernel-name pieces that sort a device kernel into a category
KERNEL_CATEGORIES = (("flash_decode", ("decode_kernel",)),
                     ("flash_attention", ("flash_fwd",)),
                     ("flash_bwd_dkv", ("flash_bwd_dkv",)),
                     ("flash_bwd_dq", ("flash_bwd_dq",)),
                     ("quantized_matmul", ("qmm_",)),
                     ("grouped_matmul_dw", ("gmm_dw_",)),
                     ("grouped_matmul", ("gmm_mma_", "gmm_f32_", "gmm_wgmma_",
                                         "gmm_split_")),
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


#: a hand-written kernel's name in a device trace: its function and
#: template arguments
_KERNEL_NAME = re.compile(r"::(\w+)(?:<([^<>]*)>)?\(")
#: the wrappers' count keys of kernels 7, 8 and 9, by function prefix
_GEMM_PREFIX = {"qmm": "quantized_matmul", "gmm_dw": "grouped_matmul_dw",
                "gmm": "grouped_matmul"}
#: kernel 1's functions, by route
_FWD_ROUTE = {"flash_fwd_wgmma": "wgmma", "flash_fwd_mma_kernel": "mma",
              "flash_fwd_kernel": "f32"}


def trace_keys(name):
    """The launch keys (:func:`counted_launches`) that one device trace
    event of a hand-written kernel counts under, from its demangled
    name; ``()`` for any other kernel. A kernel counts under its
    wrapper's key and ``{key}/{route}``; kernels 2, 5, 6a and 6b are one
    templated body, counted under ``decode_{paged|contiguous}_{int8|plain}``
    by layout and cache type and ``decode_{layout}/{route}``."""
    m = _KERNEL_NAME.search(name)
    if not m:
        return ()
    fn = m.group(1)
    args = [a.strip() for a in (m.group(2) or "").split(",")]
    if fn in ("decode_kernel", "decode_kernel_mma"):
        layout = "paged" if args[-1] == "true" else "contiguous"
        cache = "int8" if "signed char" in args else "plain"
        route = "mma" if fn.endswith("_mma") else "simt"
        return f"decode_{layout}_{cache}", f"decode_{layout}/{route}"
    gemm = re.fullmatch(r"(qmm|gmm_dw|gmm)_(\w+)_kernel", fn)
    if gemm:
        key = _GEMM_PREFIX[gemm.group(1)]
        if key == "quantized_matmul" and args[0] == "true":
            key += "_dx"
        return key, f"{key}/{gemm.group(2)}"
    if fn in _FWD_ROUTE:
        return "flash_attention", f"flash_attention/{_FWD_ROUTE[fn]}"
    for key in ("flash_bwd_dkv", "flash_bwd_dq"):
        if fn.startswith(key + "_"):
            return (key,)
    return ()


def counted_launches(counts) -> dict:
    """The wrappers' counts of :func:`read_counts` under
    :func:`trace_keys`'s keys, zeros dropped."""
    out = {"flash_bwd_dkv": counts["flash_bwd_dkv"],
           "flash_bwd_dq": counts["flash_bwd_dq"]}
    for key in ("flash_attention", "quantized_matmul", "quantized_matmul_dx",
                "grouped_matmul", "grouped_matmul_dw"):
        out[key] = counts[key]
        for route, n in counts[f"{key}_routes"].items():
            out[f"{key}/{route}"] = n
    for layout, names in (("contiguous", DECODE_KERNELS[:2]),
                          ("paged", DECODE_KERNELS[2:])):
        out[f"decode_{layout}_plain"] = sum(counts[n] for n in names)
        out[f"decode_{layout}_int8"] = sum(counts[n + "_int8"]
                                           for n in names)
        for route in ("mma", "simt"):
            out[f"decode_{layout}/{route}"] = sum(
                counts[n + "_routes"].get(route, 0) for n in names)
    return {k: n for k, n in out.items() if n}


def check_traced_launches(label, traced, counts) -> dict:
    """Hold the launches read from a device trace (``traced``, by
    :func:`trace_keys`) to what the wrappers counted over the same
    window (``counts``, :func:`read_counts`), key by key: kernel, route,
    layout and cache type. Graph replays run no Python, so their
    counts are the captured tick's added once a replay; this is the
    measurement that backs them. Returns ``traced``."""
    want = counted_launches(counts)
    if not want or traced != want:
        raise AssertionError(f"{label}: hand-written kernels in the device "
                             f"trace {traced} differ from the wrappers' "
                             f"counts {want}")
    return traced


#: idle seconds the profiler window keeps before and after the profiled
#: work: the profiler drops a device event that its clock conversion
#: places outside the capture window, and on some hosts a window that
#: stopped right after the synchronize lost up to a tick of its last
#: kernels, so a traced rerun came up short of the launch counts
PROFILE_MARGIN_S = 0.1


def kernel_summary(events):
    """``(ms by category, hand-written kernels' events by
    :func:`trace_keys`, union of the spans in us)`` of device kernel
    events."""
    by_cat = {name: 0.0 for name, _ in KERNEL_CATEGORIES}
    by_cat["other"] = 0.0
    traced = {}
    for e in events:
        cat = next((name for name, keys in KERNEL_CATEGORIES
                    if any(k in e["name"].lower() for k in keys)), "other")
        by_cat[cat] += e["dur"] / 1e3
        for key in trace_keys(e["name"]):
            traced[key] = traced.get(key, 0) + 1
    busy = _busy_us([(e["ts"], e["ts"] + e["dur"]) for e in events])
    return by_cat, traced, busy


def profile_window(torch, label, fn, steps, runtime=False):
    """Run ``fn`` under ``torch.profiler`` (device activity only) and
    return where the device time went: the window's host time, the union
    of its device kernel spans, the idle share, the kernel time by
    category and of the costliest kernels, the kernels launched per
    step, and the hand-written kernels' launches by :func:`trace_keys`
    (``traced_launches``); with ``runtime`` also the CUDA runtime's
    launch calls by name (graph launches against kernel launches). The
    trace goes to
    ``chiprun_out/chip_smoke/``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        time.sleep(PROFILE_MARGIN_S)
    events = kernel_events(prof, label, ("kernel", "cuda_runtime"))
    calls = {}
    for e in events:
        if e["cat"] == "cuda_runtime" and "Launch" in e["name"]:
            calls[e["name"]] = calls.get(e["name"], 0) + 1
    events = [e for e in events if e["cat"] == "kernel"]
    by_cat, traced, busy = kernel_summary(events)
    by_name = {}
    for e in events:
        ms, n = by_name.get(e["name"][:80], (0.0, 0))
        by_name[e["name"][:80]] = (ms + e["dur"] / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    out = {"window": label, "steps": steps, "wall_ms": wall_us / 1e3,
           "device_busy_ms": busy / 1e3,
           "idle_share": 1.0 - busy / wall_us if events else None,
           "kernel_ms": by_cat,
           "top_kernels": [{"name": k, "ms": ms, "launches": n}
                           for k, (ms, n) in top],
           "kernels_per_step": len(events) / steps,
           "traced_launches": traced}
    if runtime:
        out["runtime_launch_calls"] = calls
    return out


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


def phase_serve_cli(device="cuda", overrides=(), paged_spec=False,
                    int8=False):
    """The ``serve`` entry point as a user calls it, with the recipe's
    own sampling (top-k 50, top-p 0.75): 8 requests, ``max_dec_len``
    16, 4 slots; every request finishes and every admission and tick
    went through the kernels (an MoE model's, ``overrides`` with
    ``MOE_KNOBS``, kernel 8 too: :func:`check_moe_serve_counts`). With ``paged_spec`` the recipe's
    ``Model.kv_page_size`` / ``kv_pool_pages`` and
    ``Generation.spec_method`` knobs turn on the paged, speculative
    server (every tick the paged verify kernel). With ``int8`` both
    int8 knobs and the paged knobs with the int8 pool of the bf16
    pool's bytes (every tick kernel 6a's int8 instance, every dense
    site kernel 7)."""
    from paddlefleetx_tpu_torch import cli
    from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
    from paddlefleetx_tpu_torch.utils.config import get_config
    knobs = [f"Model.kv_page_size={HEADLINE['page']}",
             f"Model.kv_pool_pages={HEADLINE['pool_pages']}",
             "Generation.spec_method=ngram"] if paged_spec else []
    if int8:
        mcfg = GPTConfig.from_config(get_config(CONFIG, list(overrides)))
        pages, _ = int8_pool_pages(mcfg, HEADLINE["pool_pages"],
                                   HEADLINE["page"])
        knobs = [*INT8_KNOBS, f"Model.kv_page_size={HEADLINE['page']}",
                 f"Model.kv_pool_pages={pages}"]
    over = ["Generation.max_dec_len=16", *knobs, *overrides]
    argv = ["-c", CONFIG, "--requests", "8", "--slots", "4",
            "--max-prompt-len", "300"]
    if device != "cuda":
        argv += ["--device", device]
    for o in over:
        argv += ["-o", o]
    reset_counts()
    summary = cli.serve_main(argv)
    counts = read_counts()
    if summary["admitted"] < 8 or summary["evicted"] != 8 or \
            not set(summary["finish_reasons"]) <= {"eos", "length"}:
        raise AssertionError(f"serve entry point: {summary}")
    mcfg = GPTConfig.from_config(get_config(CONFIG, over))
    layers = mcfg.num_layers
    label = "serve_cli_paged_spec" if paged_spec else "serve_cli"
    if mcfg.moe_num_experts:
        label += "_moe"
        check_moe_serve_counts(counts, summary, layers, label)
    if int8:
        label = "serve_cli_int8"
        if summary.get("kv_cache_dtype") != "int8" or \
                summary.get("pool_pages") != pages:
            raise AssertionError(f"{label}: the knobs did not reach the "
                                 f"server: {summary}")
        check_paged_counts(counts, summary, layers, label,
                           "flash_decode_paged_int8")
        check_int8_counts(counts, summary, layers, label,
                          "flash_decode_paged_int8", mcfg)
    elif paged_spec:
        if not summary.get("paged") or "spec_accept_rate" not in summary:
            raise AssertionError(f"{label}: the knobs did not reach the "
                                 f"server: {summary}")
        check_paged_counts(counts, summary, layers, label,
                           "flash_decode_paged_verify")
    else:
        check_serve_counts(counts, summary, layers, label)
    emit({"phase": label, "strategy": "sampling", "overrides": over,
          "finish_reasons": summary["finish_reasons"],
          "decode_ticks": summary["decode_ticks"],
          "launches": {k: counts[k] for k in (
              "flash_attention", "flash_decode",
              "flash_decode_paged_verify", "flash_decode_paged_int8",
              "quantized_matmul", "grouped_matmul")}})


def top2_gap(model, prompt, prefix, adapter_row=None):
    """``(top-1 minus top-2 logit, max |logit|)`` of the next token
    after ``prompt + prefix``, from one full forward (through LoRA bank
    row ``adapter_row`` when given)."""
    import torch
    dev = model.word_embeddings.device
    ids = torch.as_tensor([list(prompt) + list(prefix)], device=dev)
    rows = None if adapter_row is None else \
        torch.tensor([adapter_row], device=dev)
    with torch.no_grad():
        logits = model(ids, adapter_ids=rows)[0, -1].float()
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1]), float(logits.abs().max())


def _truncate(row, eos):
    out = []
    for t in row:
        out.append(int(t))
        if int(t) == eos:
            break
    return out


def compare_rows(label, model, prompts, got, want, eos, rows=None,
                 near=1e-4):
    """Hold token rows ``got`` to ``want`` (both cut after EOS). At the
    first mismatch of a row, print its position and the top-2 logit gap
    there (request ``i`` through LoRA bank row ``rows[i]`` when given),
    and fail unless the gap is below ``near`` of the logit scale (a true
    near-tie, where rounding may pick either token)."""
    mismatches = []
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _truncate(g, eos), _truncate(w, eos)
        if g == w:
            continue
        pos = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                   min(len(g), len(w)))
        gap, scale = top2_gap(model, prompts[i], w[:pos],
                              None if rows is None else rows[i])
        mismatches.append({"row": i, "position": pos, "top2_gap": gap,
                           "logit_scale": scale})
        emit({"phase": label, "mismatch": mismatches[-1]})
        if gap >= near * scale:
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


def phase_generate_cli(device="cuda", overrides=(), max_dec_len=16):
    """``cli.generate_main`` on the recipe as a user calls it (bf16,
    sampling): it returns a string, and its ``max_dec_len`` forwards (the
    prefill, then one decode step each) launched kernel 1 once a layer
    (not on ``mma``) and kernel 2 once a layer and step, and with
    ``MOE_KNOBS`` kernel 8 twice a layer and forward
    (:func:`check_moe_forward_counts`); the counts zeroed just before the call
    and read just after."""
    from paddlefleetx_tpu_torch import cli
    from paddlefleetx_tpu_torch.utils.config import get_config
    argv = ["-c", CONFIG, "-o", f"Generation.max_dec_len={max_dec_len}",
            "--text", "Historia est vitae magistra"]
    if device != "cuda":
        argv += ["--device", device]
    for o in overrides:
        argv += ["-o", o]
    mcfg = get_config(CONFIG, list(overrides)).Model
    layers = mcfg.num_layers
    reset_counts()
    text = cli.generate_main(argv)
    counts = read_counts()
    if not isinstance(text, str):
        raise AssertionError(f"generate entry point returned {type(text)}")
    label = "generate_cli"
    want = {"flash_attention": layers,
            "flash_decode": (max_dec_len - 1) * layers}
    got = {name: counts[name] for name in want}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")
    check_fwd_routes(counts, label)
    if mcfg.get("moe_num_experts", 0):
        check_moe_forward_counts(counts, max_dec_len, layers, label)
    emit({"phase": label, "chars": len(text), "launches": {
        **got, "grouped_matmul": counts["grouped_matmul"]},
        "launches_by_route": {
            "flash_attention": counts["flash_attention_routes"],
            "grouped_matmul": counts["grouped_matmul_routes"]},
        "counters": counts["counters"]})


# -- paged and speculative serving --------------------------------------

#: the JAX package's headline serving trace (its bench.py, serving mode):
#: 16 slots over a pool of 8 full-capacity slots' pages plus the null
#: page, 32 requests with prompts of 16..384 tokens, 128 new tokens each,
#: sampling with top-k 50 / top-p 0.75, EOS and pad the last vocab id
HEADLINE = {"requests": 32, "slots": 16, "lo": 16, "hi": 384,
            "max_dec_len": 128, "page": 128, "pool_pages": 65,
            "prefill_chunk_pages": 2, "spec_tokens": 4, "seed": 0,
            "contiguous_spec_slots": 8}


def headline_prompts(vocab, requests, lo, hi, seed):
    """The trace's prompts as the JAX package draws them: lengths
    uniform in ``lo..hi``, then tokens uniform below ``vocab - 2``, from
    ``numpy.random.default_rng(seed)``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lengths = rng.integers(lo, hi + 1, requests)
    return [rng.integers(0, vocab - 2, int(n)).tolist() for n in lengths]


def serving_module(device, overrides, state_dict=None):
    """``GPTGenerationModule`` on the generation recipe with the
    trace's generation knobs (EOS / pad the last vocab id, as the JAX
    trace sets them) and ``overrides``, weights from ``state_dict`` or
    ``Global.seed``."""
    from paddlefleetx_tpu_torch.models.gpt.modules import GPTGenerationModule
    from paddlefleetx_tpu_torch.utils.config import get_config
    cfg = get_config(CONFIG, list(overrides))
    last = int(cfg.Model.vocab_size) - 1
    over = [f"Generation.eos_token_id={last}",
            f"Generation.pad_token_id={last}", "Generation.min_dec_len=0",
            *overrides]
    return GPTGenerationModule(get_config(CONFIG, over),
                               state_dict=state_dict, device=device)


def _fallbacks(counters, allowed=()):
    """The ``attention/fallback/*`` counters other than ``allowed``."""
    return {k: v for k, v in counters.items()
            if k.startswith("attention/fallback/") and k not in allowed}


def check_paged_counts(counts, summary, layers, label, kernel):
    """Every tick was one launch of ``kernel`` (6a, 6b or 5) per layer
    and nothing else decoded; a paged server's prefill chunks took the
    gather + dense route once per layer each (the JAX package's route),
    a contiguous one's admissions kernel 1; no other fallback fired."""
    c = counts["counters"]
    ticks = launched_ticks(summary) * layers
    others = set(DECODE_COUNTS) - {kernel}
    if counts[kernel] != ticks or ticks == 0 or \
            any(counts.get(k, 0) for k in others):
        raise AssertionError(f"{label}: {kernel} launched {counts[kernel]} "
                             f"times for {ticks} layer-ticks (> 0), others "
                             f"{ {k: counts.get(k, 0) for k in others} }")
    if summary.get("paged"):
        chunks = summary["prefill_chunks"] * layers
        allowed = ("attention/fallback/kv_cache_layout",)
        if c.get("attention/dense", 0) != chunks or \
                c.get("attention/fallback/kv_cache_layout", 0) != chunks or \
                counts["flash_attention"] != 0:
            raise AssertionError(f"{label}: dense {c.get('attention/dense')} "
                                 f"and kv_cache_layout fallbacks for {chunks} "
                                 f"chunk-layers; kernel 1 "
                                 f"{counts['flash_attention']}")
    else:
        allowed = ()
        if counts["flash_attention"] != summary["admitted"] * layers or \
                c.get("attention/dense", 0) != 0:
            raise AssertionError(f"{label}: kernel 1 {counts} for "
                                 f"{summary['admitted']} admissions")
    bad = _fallbacks(c, allowed)
    if bad:
        raise AssertionError(f"{label}: fallback counters {bad}")


#: the two int8 knobs as a user sets them
INT8_KNOBS = ("Model.kv_cache_dtype=int8",
              "Model.quant_execution=weight_only_int8")
#: the dispatch counter a serving tick of each decode kernel fires
TICK_COUNTERS = {
    "flash_decode": "attention/flash_decode_ragged",
    "flash_decode_verify": "attention/flash_decode_ragged_verify",
    "flash_decode_paged": "attention/flash_decode_paged",
    "flash_decode_paged_verify": "attention/flash_decode_paged_verify"}


def server_forwards(summary) -> int:
    """A server run's model forwards: one a launched decode tick
    (:func:`launched_ticks`), plus one a prefill chunk (paged) or an
    admission (contiguous)."""
    return launched_ticks(summary) + (summary["prefill_chunks"]
                                      if summary.get("paged")
                                      else summary["admitted"])


def check_quant_counts(counts, layers, forwards, label, sites=4):
    """Under ``quant_execution`` every dense site (``sites`` a layer: 4,
    or 2 in an MoE model, whose experts stay in the compute dtype as in
    the JAX package) of every forward launched kernel 7, and no site
    took the dequantize-then-matmul route."""
    c = counts["counters"]
    want = sites * layers * forwards
    if not c.get("quant/matmul", 0) == counts["quantized_matmul"] == \
            want > 0 or c.get("quant/fallback/kernel_rejected", 0):
        raise AssertionError(
            f"{label}: quant/matmul {c.get('quant/matmul')}, kernel 7 "
            f"launched {counts['quantized_matmul']}, fallbacks "
            f"{c.get('quant/fallback/kernel_rejected', 0)}; expected "
            f"{want} ({sites} sites x {layers} layers x {forwards} "
            f"forwards)")
    check_qmm_routes(counts, label)


def check_int8_counts(counts, summary, layers, label, kernel, cfg):
    """The int8 knobs' checks of a server run beside
    :func:`check_paged_counts`: each tick fired the int8 dispatch
    counter of its kernel once a layer, and under ``quant_execution``
    kernel 7 ran at every dense site."""
    c = counts["counters"]
    if cfg.kv_cache_dtype == "int8":
        name = TICK_COUNTERS[kernel[:-len("_int8")]] + "_int8"
        ticks = launched_ticks(summary) * layers
        if c.get(name, 0) != ticks:
            raise AssertionError(f"{label}: {name} {c.get(name)} for "
                                 f"{ticks} layer-ticks")
    if cfg.quant_execution != "off":
        check_quant_counts(counts, layers, server_forwards(summary), label,
                           sites=2 if cfg.moe_num_experts else 4)


def serve_trace(module, label, device, spec=False, paged=True, slots=None,
                pool_pages=None, requests=None, max_dec_len=None,
                adapters=None, warm=True, loop_ticks=1, draft=None,
                trace=False):
    """The headline trace twice on fresh servers, warm then measured
    (the counts zeroed just before the measured ``run``, read just
    after); checks that every request finished with in-vocab tokens, that
    the drained pool is whole and, under the int8 knobs, that their
    kernels ran (:func:`check_int8_counts`). ``pool_pages``,
    ``requests`` and ``max_dec_len`` replace the trace's. ``adapters``,
    ``(source, ids)``, serves request ``i`` through adapter ``ids[i %
    len(ids)]`` (:func:`check_lora_counts`); ``warm`` False skips the
    warm run, an int cuts it to that many requests of 8 new tokens.
    ``loop_ticks`` is the servers' ``device_loop_ticks``, ``draft`` a
    draft source in place of the n-gram one; ``trace`` runs the trace
    once more under ``torch.profiler`` (:func:`traced_rerun`). Returns
    the measured record, with the completions' tokens added after it is
    printed."""
    import dataclasses
    import torch
    from paddlefleetx_tpu_torch.core.serving import GenerationServer
    hl = HEADLINE
    cfg = module.model_config
    gcfg = module.generation_cfg
    if max_dec_len:
        gcfg = dataclasses.replace(gcfg, max_dec_len=max_dec_len)
    if spec:
        gcfg = dataclasses.replace(gcfg, spec_method="ngram",
                                   spec_tokens=hl["spec_tokens"])
    slots = slots or hl["slots"]
    kw = dict(page_size=hl["page"], pool_pages=pool_pages or hl["pool_pages"],
              prefill_chunk_pages=hl["prefill_chunk_pages"]) if paged else {}
    kw["device_loop_ticks"] = loop_ticks
    prompts = headline_prompts(cfg.vocab_size, requests or hl["requests"],
                               hl["lo"], hl["hi"], hl["seed"])
    ids = None
    if adapters is not None:
        kw["adapter_source"] = adapters[0]
        ids = [adapters[1][i % len(adapters[1])] for i in range(len(prompts))]
    if warm:
        n = len(prompts) if warm is True else warm
        wcfg = gcfg if warm is True else dataclasses.replace(gcfg,
                                                              max_dec_len=8)
        GenerationServer(module.model, wcfg, num_slots=slots,
                         seed=module.seed, **kw).run(
            prompts[:n], ids and ids[:n])
    def make_server():
        server = GenerationServer(module.model, gcfg, num_slots=slots,
                                  seed=module.seed, **kw)
        if draft is not None:
            server._draft = draft
        return server
    server = make_server()
    reset_counts()
    t0 = time.perf_counter()
    completions = server.run(prompts, ids)
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    summary = server.summary()
    reasons = [c.finish_reason for c in completions]
    if len(completions) != len(prompts) or \
            not set(reasons) <= {"eos", "length"}:
        raise AssertionError(f"{label}: finish reasons {reasons}")
    for c in completions:
        if not c.tokens or not all(0 <= t < cfg.vocab_size
                                   for t in c.tokens):
            raise AssertionError(f"{label}: request {c.request_id} emitted "
                                 f"{c.tokens}")
    if paged:
        server.check_alloc()
        if summary["pages_in_use"] != 0:
            raise AssertionError(f"{label}: {summary['pages_in_use']} pages "
                                 f"still in use after the drain")
    kernel = {(True, False): "flash_decode_paged",
              (True, True): "flash_decode_paged_verify",
              (False, True): "flash_decode_verify",
              (False, False): "flash_decode"}[(paged, spec)]
    int8 = cfg.kv_cache_dtype == "int8"
    if int8:
        kernel += "_int8"
    check_paged_counts(counts, summary, cfg.num_layers, label, kernel)
    check_decode_routes(counts, label, cfg.dtype)
    if int8 or cfg.quant_execution != "off":
        check_int8_counts(counts, summary, cfg.num_layers, label, kernel,
                          cfg)
    if adapters is not None:
        check_lora_counts(counts, cfg.num_layers, server_forwards(summary),
                          label, cfg.dtype)
    if cfg.moe_num_experts:
        check_moe_serve_counts(counts, summary, cfg.num_layers, label)
    generated = sum(len(c.tokens) for c in completions)
    record = {
        "phase": label, "dtype": cfg.dtype,
        "model": "MoE GPT 8x345M" if cfg.moe_num_experts else "GPT-345M",
        "layers": cfg.num_layers, "hidden": cfg.hidden_size,
        "kv_cache_dtype": cfg.kv_cache_dtype,
        "quant_execution": cfg.quant_execution,
        "paged": paged, "spec": spec, "slots": slots,
        "requests": len(prompts), "max_dec_len": gcfg.max_dec_len,
        "trace": hl,
        "generated_tokens": generated, "wall_s": wall,
        "e2e_tokens_per_s": generated / wall,
        "decode_tokens_per_s": summary["tokens_per_sec"],
        "decode_tokens": summary["decode_tokens"],
        "decode_ticks": summary["decode_ticks"],
        "ttft_p50_ms": summary.get("ttft_p50_ms"),
        "ttft_p99_ms": summary.get("ttft_p99_ms"),
        "tick_p50_ms": summary.get("tick_p50_ms"),
        "tick_p99_ms": summary.get("tick_p99_ms"),
        "kernel": kernel, "launches": {kernel: counts[kernel],
                                       "flash_attention":
                                       counts["flash_attention"],
                                       "quantized_matmul":
                                       counts["quantized_matmul"],
                                       "grouped_matmul":
                                       counts["grouped_matmul"]},
        "launches_by_route": routes_by_kernel(counts),
        "forwards": server_forwards(summary),
        "counters": counts["counters"]}
    for key in ("device_loop_ticks", "device_ticks", "host_roundtrips",
                "ticks_replayed", "graph_warmups", "host_roundtrip_p50_ms",
                "host_roundtrip_p99_ms",
                "prefill_chunks", "prefix_hits", "prompt_hits", "cow_splits",
                "preempted", "pages_in_use", "pool_pages", "pool_bytes",
                "spec_drafted", "spec_accepted", "spec_accept_rate",
                "adapter_rows", "adapters_resident", "adapter_hits",
                "adapter_misses", "adapter_evictions"):
        if key in summary:
            record[key] = summary[key]
    if ids is not None:
        record["adapter_ids"] = sorted(set(ids))
    if trace:
        record["traced_launches"] = traced_rerun(
            label, make_server, prompts, ids, [c.tokens for c in completions])
    if device != "cpu":
        record["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    emit(record)
    record["tokens"] = [c.tokens for c in completions]
    return record


#: the warm run of a serving phase before its measured one: 4 requests
#: of 8 new tokens, the measured run's tick and chunk shapes (the whole
#: trace again cost ~50 s of set-up on a slow host)
WARM = 4


def phase_serve_paged(device="cuda", overrides=()):
    """The JAX package's headline serving trace at full width through
    the paged server (GPT-345M, bf16, weights from ``Global.seed``),
    the page size, pool and chunk given to the server as the JAX trace
    gives them (``serve_cli_paged_spec`` turns paging on through the
    recipe's ``Model.kv_page_size`` / ``kv_pool_pages`` instead)."""
    module = serving_module(device, [
        f"Generation.max_dec_len={HEADLINE['max_dec_len']}", *overrides])
    return serve_trace(module, "serve_paged", device, warm=WARM), module


#: the most of its drafts ``serve_spec`` may accept. On the trace's
#: random-token prompts the n-gram drafts are near-random tokens, which
#: the sampling rule ``u < p(d)`` accepts with probability ``p(d)``,
#: about 0 (0.00043 paged and 0.00080 contiguous on an H100); a rule
#: turned round (``u > p(d)``) would accept nearly all of them
SPEC_ACCEPT_LIMIT = 0.05


def phase_serve_spec(module, device="cuda"):
    """The same trace with n-gram speculation (4 drafts a tick), paged,
    then on the contiguous cache with 8 slots; each run's accept rate
    is held under ``SPEC_ACCEPT_LIMIT``."""
    paged = serve_trace(module, "serve_spec", device, spec=True, warm=WARM)
    contiguous = serve_trace(module, "serve_spec", device, spec=True,
                             warm=WARM,
                             paged=False,
                             slots=HEADLINE["contiguous_spec_slots"])
    for run in (paged, contiguous):
        if not 0.0 <= run["spec_accept_rate"] <= SPEC_ACCEPT_LIMIT:
            raise AssertionError(
                f"serve_spec (paged {run['paged']}) accepted "
                f"{run['spec_accept_rate']:.4f} of its drafts on random "
                f"prompts, over the limit {SPEC_ACCEPT_LIMIT}: the accept "
                f"rule is broken")
    return paged, contiguous


def phase_profile_paged(module, ticks=16, pool_pages=None, suffix=""):
    """Where a paged tick's time goes, plain and speculative: the
    headline server (16 slots, 65-page pool, or ``pool_pages``) fed its
    first 16 prompts and stepped until every slot decodes, then
    ``ticks`` steps under ``torch.profiler`` (kernel time by category,
    idle share); the windows and the phase are named with ``suffix``."""
    import dataclasses
    import torch
    from paddlefleetx_tpu_torch.core.serving import GenerationServer
    hl = HEADLINE
    cfg = module.model_config
    prompts = headline_prompts(cfg.vocab_size, hl["requests"], hl["lo"],
                               hl["hi"], hl["seed"])[:hl["slots"]]
    windows = []
    for label, spec in (("decode_paged" + suffix, False),
                        ("verify_paged" + suffix, True)):
        gcfg = module.generation_cfg
        if spec:
            gcfg = dataclasses.replace(gcfg, spec_method="ngram",
                                       spec_tokens=hl["spec_tokens"])
        server = GenerationServer(
            module.model, gcfg, num_slots=hl["slots"], seed=module.seed,
            page_size=hl["page"], pool_pages=pool_pages or hl["pool_pages"],
            prefill_chunk_pages=hl["prefill_chunk_pages"])
        for p in prompts:
            server.submit(p)
        while server.pending or server._prefilling:
            server.step()

        def run():
            for _ in range(ticks):
                server.step()
        reset_counts()
        windows.append(profile_window(torch, label, run, ticks))
        counts = read_counts()
        windows[-1]["occupancy"] = server.occupancy
        windows[-1]["launches_by_route"] = routes_by_kernel(counts)
        if cfg.quant_execution != "off":
            check_qmm_routes(counts, label)
    emit({"phase": "profile_paged" + suffix, "slots": hl["slots"],
          "pool_pages": pool_pages or hl["pool_pages"], "windows": windows})
    return windows


# -- serve_loop: the device-resident loop on the serving paths -----------

#: ticks a host round trip of the ``serve_loop`` arms
LOOP_TICKS = 16
#: the token the ``serve_loop`` speculative arm drafts
CONST_DRAFT = 17
#: the summary figures a ``serve_loop`` arm prints beside its T = 1 run
LOOP_KEYS = ("decode_tokens_per_s", "e2e_tokens_per_s", "tick_p50_ms",
             "tick_p99_ms", "host_roundtrip_p50_ms", "host_roundtrip_p99_ms",
             "ttft_p50_ms", "ttft_p99_ms", "decode_ticks", "device_ticks",
             "host_roundtrips", "ticks_replayed", "graph_warmups", "wall_s")


class ConstDraft:
    """A draft source that proposes one token whatever the history: the
    ``k T`` drafts a round trip of T ticks asks for are T copies of what
    T = 1 asks for each tick, so a sampling speculative server draws the
    same tokens at any T (an n-gram source drafts every tick of a round
    trip from the pre-loop history, which moves the accept draws)."""

    def propose(self, history, k):
        """``k`` copies of ``CONST_DRAFT``."""
        return [CONST_DRAFT] * k


def check_loop_run(rec, t1, label, model, prompts, eos, device):
    """Hold a ``serve_loop`` arm to its T = 1 run: every row token-equal
    (:func:`compare_rows`: a differing row prints its first divergence
    and top-2 gap and fails unless that is a near-tie), fewer round
    trips than ticks, every round trip booked under one loop exit, and
    (on the card) one eager warm-up before the capture; the launch
    counts were held exact by :func:`serve_trace`. Prints the arm's
    figures beside the T = 1 run's and returns them."""
    compare_rows(label, model, prompts, rec["tokens"], t1["tokens"], eos)
    c = rec["counters"]
    exits = {r: c.get(f"serving/loop_exit/{r}", 0)
             for r in ("finished", "budget", "admission")}
    if sum(exits.values()) != rec["host_roundtrips"] or \
            not rec["host_roundtrips"] < rec["device_ticks"] or \
            rec["ticks_replayed"] < rec["device_ticks"] or \
            rec["graph_warmups"] != int(device != "cpu") or \
            c.get("serving/device_ticks", 0) != rec["device_ticks"]:
        raise AssertionError(f"{label}: exits {exits}, round trips "
                             f"{rec['host_roundtrips']}, ticks "
                             f"{rec['device_ticks']}, replayed "
                             f"{rec['ticks_replayed']}, warm-ups "
                             f"{rec['graph_warmups']}")
    line = {"phase": "serve_loop", "arm": label, "loop_ticks": LOOP_TICKS,
            "rows_equal_t1": True, "loop_exit": exits,
            "launches": rec["launches"],
            "launches_by_route": rec.get("launches_by_route"),
            "traced_launches": rec.get("traced_launches"),
            **{k: rec.get(k) for k in LOOP_KEYS},
            "t1": {k: t1.get(k) for k in LOOP_KEYS}}
    emit(line)
    return line


def phase_serve_loop_contiguous(module, serve, device="cuda"):
    """``serve_loop``'s contiguous arm on the serve phase's module: its
    prompts, greedy, again at ``LOOP_TICKS`` ticks a round trip, each
    row equal to the serve phase's (its record holds prompts and rows
    after it is printed), kernel 1
    once a layer and admission and kernel 2 once a layer and launched
    tick; then the same run again under ``torch.profiler``
    (:func:`traced_rerun`)."""
    import torch
    from paddlefleetx_tpu_torch.core.serving import GenerationServer
    cfg = module.model_config
    prompts = serve["prompts"]

    def make_server():
        return GenerationServer(module.model, module.generation_cfg,
                                num_slots=serve["slots"], seed=module.seed,
                                device_loop_ticks=LOOP_TICKS)
    server = make_server()
    reset_counts()
    t0 = time.perf_counter()
    completions = server.run(prompts)
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    summary = server.summary()
    check_serve_counts(counts, summary, cfg.num_layers,
                       "serve_loop_contiguous")
    check_decode_routes(counts, "serve_loop_contiguous", cfg.dtype)
    rec = {**summary, "counters": counts["counters"], "wall_s": wall,
           "decode_tokens_per_s": summary["tokens_per_sec"],
           "e2e_tokens_per_s": sum(len(c.tokens) for c in completions) / wall,
           "launches": {"flash_attention": counts["flash_attention"],
                        "flash_decode": counts["flash_decode"]},
           "tokens": [c.tokens for c in completions]}
    rec["traced_launches"] = traced_rerun(
        "serve_loop_contiguous", make_server, prompts, None, rec["tokens"])
    t1 = dict(serve, tick_p50_ms=serve.get("decode_tick_p50_ms"),
              tick_p99_ms=serve.get("decode_tick_p99_ms"))
    return check_loop_run(rec, t1, "serve_loop_contiguous", module.model,
                          prompts, module.generation_cfg.eos_token_id,
                          device)


def phase_serve_loop_paged(module, serve_paged, t1_windows, device="cuda"):
    """``serve_loop``'s dense paged arms on the ``serve_paged`` module:
    the headline trace with the recipe's sampling at ``LOOP_TICKS``
    against ``serve_paged``'s rows; the trace paged and speculative
    with a constant draft (:class:`ConstDraft`) at T = 1 and at
    ``LOOP_TICKS``; then one round trip of each profiled
    (:func:`profile_loop`) beside the T = 1 windows ``t1_windows`` of
    ``profile_paged``. Returns the arms' lines."""
    hl = HEADLINE
    prompts = headline_prompts(module.model_config.vocab_size,
                               hl["requests"], hl["lo"], hl["hi"],
                               hl["seed"])
    eos = module.generation_cfg.eos_token_id
    arms = {}
    rec = serve_trace(module, "serve_loop_paged", device, warm=False,
                      loop_ticks=LOOP_TICKS)
    arms["paged"] = check_loop_run(rec, serve_paged, "serve_loop_paged",
                                   module.model, prompts, eos, device)
    t1 = serve_trace(module, "serve_loop_spec_t1", device, spec=True,
                     warm=False, draft=ConstDraft())
    rec = serve_trace(module, "serve_loop_spec", device, spec=True,
                      warm=False, loop_ticks=LOOP_TICKS, draft=ConstDraft())
    arms["paged_spec"] = check_loop_run(rec, t1, "serve_loop_spec",
                                        module.model, prompts, eos, device)
    t1_window = {w["window"]: w for w in t1_windows}
    arms["profile"] = profile_loop(module, t1_window["decode_paged"],
                                   device)
    arms["profile_spec"] = profile_loop(
        module, t1_window["verify_paged"], device, "verify_paged_loop",
        spec=True)
    return arms


#: the conversational trace of the JAX bench's tiered serving record
#: (``bench.py``'s ``PFX_BENCH_SERVING_TIERED`` block): 3 turns of 10
#: users (32 requests // 3 turns) over a shared system prompt of one
#: page + 2 tokens, each turn a 24-48-token message and 16 seeded reply
#: tokens after it; 16 new tokens a request, 10 slots, one page a
#: prefill chunk, an HBM pool of half the trace's footprint
TIERED_TRACE = {"users": 10, "turns": 3, "max_dec_len": 16, "slots": 10,
                "page": 128, "seed": 0, "msg": (24, 48), "reply": 16}
#: the three tiered arms: (label, KV dtype, sampling, spec tokens, T,
#: host_pool_bytes); arm C's 64 MiB host tier is 10 int8 pages, small
#: enough that the host LRU evicts
TIERED_ARMS = (("A", "bf16", True, 0, 1, 384 << 20),
               ("B", "bf16", True, 0, LOOP_TICKS, 384 << 20),
               ("C", "int8", False, 4, 1, 64 << 20))


def conversation_waves(vocab, cap, trace=TIERED_TRACE):
    """The JAX bench's conversational trace (``bench.py``): ``turns``
    waves of ``users`` prompts, each a user's grown history, from
    ``numpy.random.default_rng(seed)``; a history that would outgrow
    ``cap`` positions restarts from the system prompt."""
    import numpy as np
    rng = np.random.default_rng(trace["seed"])
    system = rng.integers(0, vocab - 2, trace["page"] + 2).tolist()
    hist = [list(system) for _ in range(trace["users"])]
    room = cap - trace["max_dec_len"] - 8
    waves = []
    for _ in range(trace["turns"]):
        wave = []
        for u in range(trace["users"]):
            lo, hi = trace["msg"]
            msg = rng.integers(0, vocab - 2,
                               int(rng.integers(lo, hi + 1))).tolist()
            if len(hist[u]) + len(msg) + 16 > room:
                hist[u] = list(system)
            hist[u] = hist[u] + msg
            wave.append(list(hist[u]))
            hist[u] = hist[u] + rng.integers(
                0, vocab - 2, trace["reply"]).tolist()
        waves.append(wave)
    return waves


def kv_twin(model, kv_cache_dtype):
    """The serving model with another KV cache dtype, sharing its weight
    tensors (built on the meta device, the weights assigned): no new
    weights and no copy."""
    import dataclasses
    import torch
    from paddlefleetx_tpu_torch.models.gpt.model import GPTForPretraining
    cfg = dataclasses.replace(model.config, kv_cache_dtype=kv_cache_dtype)
    with torch.device("meta"):
        twin = GPTForPretraining(cfg)
    twin.load_state_dict(model.state_dict(), assign=True)
    return twin.eval()


def hit_rate(summary) -> float:
    """Prefix and prompt hits over hits plus prefill chunks (the JAX
    bench's ``prefix_hit_rate``)."""
    hits = summary.get("prefix_hits", 0) + summary.get("prompt_hits", 0)
    return hits / max(hits + summary.get("prefill_chunks", 0), 1)


def serve_waves(model, gcfg, waves, device, label, seed,
                trace=TIERED_TRACE, **kw):
    """Serve ``waves`` one at a time on a fresh paged server (the counts
    zeroed just before, read just after) and close it; ``(rows,
    summary, counts, wall_s)``, having checked that every request
    finished, the allocator is whole and every launched tick was one
    decode-kernel launch a layer (:func:`check_paged_counts`)."""
    import torch
    from paddlefleetx_tpu_torch.core.serving import GenerationServer
    server = GenerationServer(model, gcfg, num_slots=trace["slots"],
                              seed=seed, page_size=trace["page"],
                              prefill_chunk_pages=1, **kw)
    try:
        reset_counts()
        t0 = time.perf_counter()
        rows = []
        for wave in waves:
            done = server.run(wave)
            if not all(c.finish_reason in ("eos", "length") for c in done):
                raise AssertionError(f"{label}: finish reasons "
                                     f"{[c.finish_reason for c in done]}")
            rows.append([c.tokens for c in done])
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        summary = server.summary()
        server.check_alloc()
    finally:
        server.close()
    cfg = model.config
    kernel = "flash_decode_paged_verify" if gcfg.spec_method else \
        "flash_decode_paged"
    if cfg.kv_cache_dtype == "int8":
        kernel += "_int8"
    check_paged_counts(counts, summary, cfg.num_layers, label, kernel)
    check_decode_routes(counts, label, cfg.dtype)
    check_int8_counts(counts, summary, cfg.num_layers, label, kernel, cfg)
    return rows, summary, counts, wall


#: the summary keys a serve_tiered arm prints for each of its servers
TIER_KEYS = ("spills", "rehydrates", "host_evictions", "prefill_chunks",
             "prefix_hits", "prompt_hits", "cow_splits", "preempted",
             "ttft_p50_ms", "ttft_p99_ms", "rehydrate_p50_ms",
             "rehydrate_p99_ms", "spill_d2h_p50_ms", "spill_d2h_p99_ms",
             "host_pages_cap", "host_slab_bytes", "pool_pages",
             "decode_ticks", "host_roundtrips", "tokens_per_sec")


class _OpCount:
    """Counts the ATen operators (each at least one launch on the card)
    that a region dispatches."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        class Mode(TorchDispatchMode):
            """Counts each dispatched operator, then runs it."""

            def __torch_dispatch__(mode, func, types, args=(), kwargs=None):
                self.n += 1
                return func(*args, **(kwargs or {}))
        self.n = 0
        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)


def tier_launch_pin(model, kv_cache_dtype, device, pages=(1, 8)):
    """The batched-launch pin on the card, on a pool of the serving
    model's pages: packing N pages (``pack_kv_pages``, a spill) and
    writing N rows back (``unpack_kv_pages``, a rehydrate) dispatch the
    same operators for every N in ``pages``, and the round trip is
    exact; the ms of each at each N."""
    import dataclasses
    import torch
    from paddlefleetx_tpu_torch.models.gpt import generation as gen
    cfg = dataclasses.replace(model.config, kv_cache_dtype=kv_cache_dtype,
                              kv_page_size=TIERED_TRACE["page"],
                              kv_pool_pages=2 * max(pages) + 1)
    pool = gen.init_page_pool(model, cfg)
    g = torch.Generator(device=device).manual_seed(0)
    for layer in pool:
        for t in layer:
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=g,
                                      device=device, dtype=torch.int8))
            else:
                t.copy_(torch.randn(t.shape, generator=g, device=device,
                                    dtype=t.dtype))
    out = {"kv_cache_dtype": kv_cache_dtype,
           "row_bytes": gen.kv_row_bytes(pool), "ops": {}, "ms": {}}
    for n in pages:
        src = list(range(1, n + 1))
        dst = list(range(max(pages) + 1, max(pages) + 1 + n))
        with _OpCount() as pack_ops:
            rows = gen.pack_kv_pages(pool, src)
        host = torch.empty(rows.shape, dtype=torch.uint8,
                           pin_memory=device != "cpu")
        host.copy_(rows)
        back = host.to(device)
        with _OpCount() as unpack_ops:
            gen.unpack_kv_pages(pool, back, dst)
        for layer in pool:
            for t in layer:
                if not torch.equal(t[src], t[dst]):
                    raise AssertionError(f"tier_launch_pin: {n} pages "
                                         f"did not round-trip exactly")
        out["ops"][n] = {"pack": pack_ops.n, "unpack": unpack_ops.n}
        if device != "cpu":
            out["ms"][n] = {
                "pack": time_ms(lambda i: gen.pack_kv_pages(pool, src),
                                1)[0],
                "unpack": time_ms(lambda i: gen.unpack_kv_pages(
                    pool, back, dst), 1)[0]}
    if len({tuple(v.values()) for v in out["ops"].values()}) != 1:
        raise AssertionError(f"tier_launch_pin: operator counts grow with "
                             f"the page count: {out['ops']}")
    del pool
    return out


def phase_serve_tiered(module, device="cuda", trace=TIERED_TRACE,
                       arms=TIERED_ARMS):
    """The host KV tier on ``serve_paged``'s 345M module (no new model:
    arm C's int8 cache serves a twin sharing its weights), on the JAX
    bench's conversational trace (:func:`conversation_waves`) with an
    HBM pool of half the trace's footprint: arms A (bf16, sampling top-k
    50 / top-p 0.75, T = 1, 384 MiB host tier), B (the same at
    ``LOOP_TICKS``) and C (int8 KV, greedy, n-gram spec of 4 tokens, 64
    MiB: the host LRU evicts). Each arm's rows equal its untiered twin's
    on an unlimited pool (A and B share one), with spills, rehydrates,
    fewer prefill chunks than the twin and the decode kernels' launch
    counts exact; arm C evicts host pages. Then the batched-launch pin
    (:func:`tier_launch_pin`) at bf16 and int8. Prints one line an
    arm."""
    import dataclasses
    cfg = module.model_config
    page = trace["page"]
    waves = conversation_waves(cfg.vocab_size, cfg.max_position_embeddings,
                               trace)
    footprint = sum(-(-(len(w[-1]) + trace["max_dec_len"]) // page)
                    for w in zip(*waves))
    cap_pages = -(-cfg.max_position_embeddings // page)
    tiered_pool = max(cap_pages + 1, footprint // 2)
    twin_pool = footprint + trace["slots"] * cap_pages + 1
    sampling = dataclasses.replace(
        module.generation_cfg, max_dec_len=trace["max_dec_len"],
        decode_strategy="sampling", top_k=50, top_p=0.75)
    greedy = dataclasses.replace(
        module.generation_cfg, max_dec_len=trace["max_dec_len"],
        decode_strategy="greedy_search", spec_method="ngram",
        spec_tokens=4)
    twins = {}
    records = {}
    for label, kv, sample, spec, ticks, host in arms:
        model = module.model if kv == "bf16" else kv_twin(module.model, kv)
        gcfg = sampling if sample else greedy
        name = f"serve_tiered_{label}"
        if (kv, sample) not in twins:
            twins[(kv, sample)] = serve_waves(
                model, gcfg, waves, device, name + "_twin", module.seed,
                trace, pool_pages=twin_pool)
        want, us, _, uwall = twins[(kv, sample)]
        got, ts, counts, wall = serve_waves(
            model, gcfg, waves, device, name, module.seed, trace,
            pool_pages=tiered_pool, host_pool_bytes=host,
            device_loop_ticks=ticks)
        if got != want:
            bad = [(i, j) for i, (a, b) in enumerate(zip(got, want))
                   for j, (x, y) in enumerate(zip(a, b)) if x != y]
            raise AssertionError(f"{name}: rows differ from the untiered "
                                 f"twin at (wave, request) {bad}")
        c = counts["counters"]
        if not (ts["spills"] > 0 and ts["rehydrates"] > 0 and
                ts["prefill_chunks"] < us["prefill_chunks"]):
            raise AssertionError(f"{name}: spills {ts['spills']}, "
                                 f"rehydrates {ts['rehydrates']}, chunks "
                                 f"{ts['prefill_chunks']} against the "
                                 f"twin's {us['prefill_chunks']}")
        if c.get("serving/spill", 0) != ts["spills"] or \
                c.get("serving/rehydrate", 0) != ts["rehydrates"] or \
                c.get("serving/spill_failed", 0):
            raise AssertionError(f"{name}: counters {c} against the "
                                 f"summary {ts}")
        if label == "C" and not ts["host_evictions"]:
            raise AssertionError(f"{name}: the {host >> 20} MiB host tier "
                                 f"evicted nothing")
        rec = {"phase": "serve_tiered", "arm": label, "kv_cache_dtype": kv,
               "strategy": gcfg.decode_strategy, "spec_tokens": spec,
               "loop_ticks": ticks, "host_pool_bytes": host,
               "trace": dict(trace, requests=sum(map(len, waves)),
                             footprint_pages=footprint),
               "hbm_pool_pages": tiered_pool, "twin_pool_pages": twin_pool,
               "rows_equal_twin": True, "wall_s": wall, "twin_wall_s": uwall,
               "prefix_hit_rate": hit_rate(ts),
               "prefix_hit_rate_twin": hit_rate(us),
               "tiered": {k: ts[k] for k in TIER_KEYS if k in ts},
               "twin": {k: us[k] for k in TIER_KEYS if k in us},
               "launches": {k: counts[k] for k in DECODE_COUNTS
                            if counts[k]}}
        if ticks > 1:
            rec["ticks_replayed"] = ts["ticks_replayed"]
            rec["graph_warmups"] = ts["graph_warmups"]
        emit(rec)
        records[label] = rec
    records["launch_pin"] = [tier_launch_pin(module.model, kv, device)
                             for kv in ("bf16", "int8")]
    emit({"phase": "serve_tiered", "launch_pin": records["launch_pin"]})
    return records


def phase_serve_robust(module, device="cuda", requests=6, slots=4,
                       max_dec_len=16, hi=300):
    """Serving robustness on ``serve_paged``'s module, on a short greedy
    paged trace: a drain after 3 steps and a resume of every partial on
    a fresh server (``resume_tokens``, ``trace_id``) whose stitched rows
    equal the uninterrupted run's, one trace per request across the
    restart; a queued request past its deadline and a shed submit; a
    ``/healthz`` scrape that reads 200, then 503 once draining; a
    prefix-store export, save, load and import into a fresh tiered
    server whose first wave rehydrates instead of re-prefilling, rows
    equal."""
    import dataclasses
    import urllib.error
    import urllib.request
    from paddlefleetx_tpu_torch.core.checkpoint import (
        load_prefix_store, save_prefix_store,
    )
    from paddlefleetx_tpu_torch.core.serving import (
        GenerationServer, RequestShed,
    )
    from paddlefleetx_tpu_torch.observability import server as obs_server
    from paddlefleetx_tpu_torch.observability.recorder import read_events
    cfg = module.model_config
    gcfg = dataclasses.replace(module.generation_cfg,
                               max_dec_len=max_dec_len,
                               decode_strategy="greedy_search")
    prompts = seeded_prompts(requests, 16, hi, cfg.vocab_size - 2, 5)
    kw = dict(num_slots=slots, seed=module.seed, page_size=128,
              prefill_chunk_pages=1)
    rec = {"phase": "serve_robust", "requests": requests, "slots": slots,
           "max_dec_len": max_dec_len}
    os.makedirs(OUT_DIR, exist_ok=True)
    events = os.path.join(OUT_DIR, "serve_robust_events.jsonl")
    if os.path.exists(events):
        os.remove(events)

    def drive(srv, done):
        while srv.pending or srv.occupancy:
            for c in srv.step():
                done[c.request_id] = c
        return done

    srv = GenerationServer(module.model, gcfg, **kw)
    try:
        want = [c.tokens for c in srv.run(prompts)]
    finally:
        srv.close()
    # drain -> resume
    t0 = time.perf_counter()
    srv = GenerationServer(module.model, gcfg, events_path=events, **kw)
    try:
        ids = [srv.submit(p) for p in prompts]
        done = {}
        for _ in range(3):
            for c in srv.step():
                done[c.request_id] = c
        for c in srv.drain(max_ticks=0):
            done[c.request_id] = c
    finally:
        srv.close()
    partials = [c for c in done.values() if c.finish_reason == "preempted"]
    srv = GenerationServer(module.model, gcfg, events_path=events, **kw)
    try:
        remap = {srv.submit(c.prompt, resume_tokens=c.tokens or None,
                            trace_id=c.trace_id): c for c in partials}
        done2 = drive(srv, {})
    finally:
        srv.close()
    final = {rid: done[rid].tokens for rid in ids}
    for nid, c in remap.items():
        final[c.request_id] = done2[nid].tokens
    if [final[i] for i in ids] != want or \
            not any(c.tokens for c in partials):
        raise AssertionError("serve_robust: drained and resumed rows "
                             "differ from the uninterrupted run")
    roots = [e for e in read_events(events) if e["event"] == "span_begin"
             and e["name"] == "serving/request"]
    for c in partials:
        if sum(r["trace"] == c.trace_id for r in roots) != 2:
            raise AssertionError(f"serve_robust: trace {c.trace_id} not "
                                 f"continued across the resume")
    rec["drain_resume"] = {"partials": len(partials),
                           "mid_decode": sum(bool(c.tokens)
                                             for c in partials),
                           "rows_equal": True,
                           "s": time.perf_counter() - t0}
    # deadline and shed
    srv = GenerationServer(module.model, gcfg, max_queue_depth=2,
                           **dict(kw, num_slots=1))
    try:
        a = srv.submit(prompts[0])
        b = srv.submit(prompts[1], deadline_s=0.0)
        try:
            srv.submit(prompts[2])
            raise AssertionError("serve_robust: a third queued submit was "
                                 "not shed at max_queue_depth 2")
        except RequestShed:
            pass
        done = drive(srv, {})
        summ = srv.summary()
    finally:
        srv.close()
    if done[b].finish_reason != "deadline_exceeded" or done[b].tokens or \
            done[a].tokens != want[0] or summ["shed"] != 1 or \
            summ["deadline_exceeded"] != 1:
        raise AssertionError(f"serve_robust: deadline / shed {done} {summ}")
    rec["deadline_shed"] = {"deadline_exceeded": 1, "shed": 1}
    # /healthz 200 -> 503 on drain
    obs_server.stop()
    srv = GenerationServer(module.model, gcfg, metrics_port=0, **kw)
    def healthz():
        try:
            with urllib.request.urlopen(
                    obs_server.get_server().url("/healthz"),
                    timeout=10) as resp:
                return resp.status
        except urllib.error.HTTPError as err:
            return err.code

    try:
        srv.run(prompts[:2])
        codes = [healthz()]
        srv.drain()
        codes.append(healthz())
        with urllib.request.urlopen(obs_server.get_server().url(
                "/metrics"), timeout=10) as resp:
            metrics_body = resp.read()
    finally:
        srv.close()
        obs_server.stop()
    if codes != [200, 503] or b"pfx_serving_ttft_ms_bucket" not in \
            metrics_body:
        raise AssertionError(f"serve_robust: /healthz answered {codes}")
    rec["healthz"] = codes
    # the prefix store across a restart
    tkw = dict(kw, pool_pages=9, host_pool_bytes=384 << 20)
    wave = prompts[:4]
    srv = GenerationServer(module.model, gcfg, **tkw)
    try:
        cold = [c.tokens for c in srv.run(wave)]
        cold_summary = srv.summary()
        store = srv.export_prefix_store()
    finally:
        srv.close()
    path = os.path.join(OUT_DIR, "prefix_store")
    shutil.rmtree(path, ignore_errors=True)
    save_prefix_store(path, store)
    loaded = load_prefix_store(path)
    srv = GenerationServer(module.model, gcfg, **tkw)
    try:
        adopted = srv.import_prefix_store(loaded)
        warm = [c.tokens for c in srv.run(wave)]
        warm_summary = srv.summary()
    finally:
        srv.close()
    shutil.rmtree(path, ignore_errors=True)
    if warm != cold or not adopted or not warm_summary["rehydrates"] or \
            warm_summary["prefill_chunks"] >= cold_summary["prefill_chunks"]:
        raise AssertionError(f"serve_robust: the imported store ({adopted} "
                             f"pages) gave {warm_summary}")
    rec["prefix_store"] = {
        "pages": len(store["pages"]), "adopted": adopted,
        "rows_equal": True,
        "cold_prefill_chunks": cold_summary["prefill_chunks"],
        "warm_prefill_chunks": warm_summary["prefill_chunks"],
        "warm_rehydrates": warm_summary["rehydrates"],
        "rehydrate_p50_ms": warm_summary.get("rehydrate_p50_ms")}
    emit(rec)
    return rec


def profile_loop(module, t1, device="cuda", label="decode_paged_loop",
                 spec=False, adapters=None):
    """Where a round trip of ``LOOP_TICKS`` ticks goes, once the queue is
    empty: the headline server fed its first 16 prompts at
    ``LOOP_TICKS`` ticks a round trip (``spec``: speculative with a
    constant draft; ``adapters``, ``(source, ids)``: prompt ``i`` on
    adapter ``ids[i % len(ids)]``), stepped until every slot decodes and
    once more (the capture), then one round trip under
    ``torch.profiler``: the device's busy and idle share, kernels a
    tick, and the CUDA runtime's graph launches against its kernel
    launches, printed beside ``t1``, the T = 1 window of the same path
    in the same call. Every hand-written kernel's events in the trace
    must equal its wrapper's counts (:func:`check_traced_launches`), and
    the decode kernel's ``layers`` x replayed ticks."""
    import dataclasses
    import torch
    from paddlefleetx_tpu_torch.core.serving import GenerationServer
    hl = HEADLINE
    cfg = module.model_config
    gcfg = module.generation_cfg
    if spec:
        gcfg = dataclasses.replace(gcfg, spec_method="ngram",
                                   spec_tokens=hl["spec_tokens"])
    prompts = headline_prompts(cfg.vocab_size, hl["requests"], hl["lo"],
                               hl["hi"], hl["seed"])[:hl["slots"]]
    server = GenerationServer(
        module.model, gcfg, num_slots=hl["slots"],
        seed=module.seed, page_size=hl["page"], pool_pages=hl["pool_pages"],
        prefill_chunk_pages=hl["prefill_chunk_pages"],
        device_loop_ticks=LOOP_TICKS,
        adapter_source=adapters[0] if adapters else None)
    if spec:
        server._draft = ConstDraft()
    for i, p in enumerate(prompts):
        server.submit(p, adapter_id=adapters[1][i % len(adapters[1])]
                      if adapters else 0)
    while server.pending or server._prefilling:
        server.step()
    server.step()
    before = server.summary()
    reset_counts()
    window = profile_window(torch, label, server.step, LOOP_TICKS,
                            runtime=device != "cpu")
    counts = read_counts()
    after = server.summary()
    replays = after["ticks_replayed"] - before["ticks_replayed"]
    ticks = after["device_ticks"] - before["device_ticks"]
    window["steps"] = replays
    window["kernels_per_step"] *= LOOP_TICKS / max(replays, 1)
    window.update({"graph_replays": replays, "ticks_run": ticks,
                   "occupancy": server.occupancy,
                   "launches_by_route": routes_by_kernel(counts)})
    kernel = "flash_decode_paged_verify" if spec else "flash_decode_paged"
    if counts[kernel] != replays * cfg.num_layers:
        raise AssertionError(f"{label}: {kernel} launched {counts[kernel]} "
                             f"times for {replays} replayed ticks")
    check_traced_launches(label, window["traced_launches"], counts)
    keys = ("window", "wall_ms", "device_busy_ms", "idle_share",
            "kernels_per_step", "steps")
    emit({"phase": "profile_loop", "loop_ticks": LOOP_TICKS,
          "windows": [window], "t1": {k: t1.get(k) for k in keys},
          "tick_ms": window["wall_ms"] / max(ticks, 1),
          "tick_ms_t1": t1["wall_ms"] / t1["steps"],
          "busy_ms_per_tick": window["device_busy_ms"] / max(ticks, 1),
          "busy_ms_per_tick_t1": t1["device_busy_ms"] / t1["steps"]})
    return window


def traced_rerun(label, make_server, prompts, ids, rows):
    """A measured ``serve_loop`` run again, on ``make_server()`` under
    ``torch.profiler``: the same ``rows``, and every hand-written
    kernel's events in the device trace, graph replays included, equal
    to what its wrapper counted in that run
    (:func:`check_traced_launches`). Returns the traced launches."""
    import torch
    server = make_server()
    done = []
    reset_counts()
    window = profile_window(torch, label + "_traced",
                            lambda: done.extend(server.run(prompts, ids)), 1)
    counts = read_counts()
    if [c.tokens for c in done] != rows:
        raise AssertionError(f"{label}: the traced rerun's rows differ "
                             f"from the measured run's")
    return check_traced_launches(label, window["traced_launches"], counts)


def phase_serve_loop_int8(module, runs, device="cuda", short=None):
    """``serve_loop``'s int8 arms on the ``serve_int8`` module (both int8
    knobs): the headline trace paged at ``LOOP_TICKS`` against
    ``serve_int8``'s paged rows, then ``short`` paged speculative arms
    with a constant draft at T = 1 and at ``LOOP_TICKS``, so that kernel
    7's ``wgmma`` route (the verify window's M 80), whose TMA maps the
    host encodes at each call, replays from the graph too (``short``:
    ``INT8_SHORT`` by default), the latter again under the profiler
    (:func:`traced_rerun`). Returns the arms' lines."""
    short = short or INT8_SHORT
    pages = runs["paged"]["pool_pages"]
    arms = {"int8": serve_loop_arm(module, "serve_loop_int8", runs["paged"],
                                   device, pool_pages=pages)}
    t1 = serve_trace(module, "serve_loop_int8_spec_t1", device, spec=True,
                     pool_pages=pages, warm=False, draft=ConstDraft(),
                     **short)
    arms["int8_spec"] = serve_loop_arm(
        module, "serve_loop_int8_spec", t1, device, spec=True,
        pool_pages=pages, draft=ConstDraft(), trace=True, **short)
    if arms["int8_spec"]["launches_by_route"]["quantized_matmul"].get(
            "wgmma", 0) == 0:
        raise AssertionError("serve_loop_int8_spec: no kernel 7 launch "
                             "took the wgmma route")
    return arms


def serve_loop_arm(module, label, t1, device="cuda", **kw):
    """One ``serve_loop`` arm through :func:`serve_trace` (no warm run:
    the T = 1 phase before it warmed the kernels) at ``LOOP_TICKS``
    ticks a round trip, held to that phase's T = 1 record ``t1``
    (:func:`check_loop_run`)."""
    hl = HEADLINE
    prompts = headline_prompts(module.model_config.vocab_size,
                               kw.get("requests") or hl["requests"],
                               hl["lo"], hl["hi"], hl["seed"])
    rec = serve_trace(module, label, device, warm=False,
                      loop_ticks=LOOP_TICKS, **kw)
    return check_loop_run(rec, t1, label, module.model, prompts,
                          module.generation_cfg.eos_token_id, device)


def _first_divergence(got, want, eos):
    """``(equal rows, first divergent position per row or None)``."""
    pos = []
    for g, w in zip(got, want):
        g, w = _truncate(g, eos), _truncate(w, eos)
        pos.append(None if g == w else next(
            (j for j, (a, b) in enumerate(zip(g, w)) if a != b),
            min(len(g), len(w))))
    return sum(p is None for p in pos), pos


def parity_prompts(vocab, requests=4, prefix=256, seed=31):
    """``requests`` prompts sharing a ``prefix``-token prefix (two full
    pages, shared through the prefix registry), tails of 118..126 so
    every request grows into its fourth page within a few tokens."""
    import numpy as np
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab - 2, prefix).tolist()
    return [head + rng.integers(0, vocab - 2, int(n)).tolist()
            for n in rng.integers(118, 127, requests)]


def phase_parity_paged(device="cuda", overrides=(), max_dec_len=48,
                       small_pool=9):
    """Greedy rows of five ways to serve the same prompts, at the 345M
    width: the paged server spec off and on, the contiguous server spec
    on and off, and lockstep ``generate()``. In fp32 they must be equal
    (a mismatch only at a true near-tie), also with a pool so small that
    requests are preempted (``small_pool``); in bf16 the share of equal
    rows and the first divergent positions are printed, not held (the
    verify forward's GEMMs have another M than the decode tick's)."""
    import dataclasses
    from paddlefleetx_tpu_torch.core.serving import GenerationServer
    from paddlefleetx_tpu_torch.models.gpt.generation import (
        generate, left_pad_batch,
    )
    hl = HEADLINE
    records = []
    for dtype_over in (["Engine.mix_precision.use_pure_fp16=False"], []):
        module = serving_module(device, [
            *dtype_over, "Generation.decode_strategy=greedy_search",
            f"Generation.max_dec_len={max_dec_len}", *overrides])
        cfg, gcfg, model = module.model_config, module.generation_cfg, \
            module.model
        prompts = parity_prompts(cfg.vocab_size)
        ids, mask = left_pad_batch(prompts, gcfg.pad_token_id)
        eos = gcfg.eos_token_id
        lockstep = [_truncate(r, eos)
                    for r in generate(model, ids, mask, gcfg).tolist()]
        spec = dataclasses.replace(gcfg, spec_method="ngram",
                                   spec_tokens=hl["spec_tokens"])
        paged = dict(page_size=hl["page"],
                     prefill_chunk_pages=hl["prefill_chunk_pages"])
        runs = {"paged": (gcfg, paged), "paged_spec": (spec, paged),
                "contiguous_spec": (spec, {}), "contiguous": (gcfg, {}),
                "paged_preempted": (gcfg, dict(paged,
                                               pool_pages=small_pool)),
                "paged_spec_preempted": (spec, dict(paged,
                                                    pool_pages=small_pool))}
        rows, summaries = {}, {}
        for name, (g, kw) in runs.items():
            srv = GenerationServer(model, g, num_slots=len(prompts), **kw)
            rows[name] = [c.tokens for c in srv.run(prompts)]
            summaries[name] = srv.summary()
            if srv.paged:
                srv.check_alloc()
                if summaries[name]["pages_in_use"]:
                    raise AssertionError(f"parity_paged: {name} left pages "
                                         f"in use")
        for name in ("paged_preempted", "paged_spec_preempted"):
            if summaries[name]["preempted"] == 0:
                raise AssertionError(f"parity_paged: {name} with a "
                                     f"{small_pool}-page pool preempted "
                                     f"nothing")
        record = {"phase": "parity_paged", "dtype": cfg.dtype,
                  "requests": len(prompts),
                  "prompt_lens": [len(p) for p in prompts],
                  "max_dec_len": max_dec_len, "small_pool": small_pool,
                  "counts": {n: {k: s.get(k) for k in (
                      "prefill_chunks", "prefix_hits", "prompt_hits",
                      "cow_splits", "preempted", "spec_accept_rate",
                      "decode_ticks")} for n, s in summaries.items()}}
        if cfg.dtype == "float32":
            near = 0
            for name, got in rows.items():
                near += len(compare_rows(f"parity_paged_{name}", model,
                                         prompts, got, lockstep, eos))
            record["rows_equal"] = {n: _first_divergence(r, lockstep,
                                                         eos)[0]
                                    for n, r in rows.items()}
            record["near_ties"] = near
        else:
            record["rows_equal_share"] = {
                n: _first_divergence(r, lockstep, eos)[0] / len(prompts)
                for n, r in rows.items()}
            record["first_divergence"] = {
                n: _first_divergence(r, lockstep, eos)[1]
                for n, r in rows.items()}
            # speculation and paging against their own plain layout
            record["rows_equal_share_pairs"] = {
                f"{a}~{b}": _first_divergence(rows[a], rows[b], eos)[0]
                / len(prompts) for a, b in (
                    ("paged_spec", "paged"),
                    ("contiguous_spec", "contiguous"),
                    ("paged", "contiguous"),
                    ("paged_preempted", "paged"))}
        emit(record)
        records.append(record)
        del module, model
    return records


# -- int8 serving: kv_cache_dtype int8, quant_execution weight_only_int8 --

#: the short arms of ``serve_int8`` (contiguous, contiguous and paged
#: speculative): enough ticks for every int8 instance to run on a main
#: path, not a second measurement of the trace
INT8_SHORT = {"requests": 8, "max_dec_len": 32}


def int8_pool_pages(cfg, bf16_pages, page):
    """``(int8 pages, bytes)``: the int8 pool that fits the device bytes
    of a ``bf16_pages`` bf16 pool (``core/paging.py``'s
    ``pool_pages_for_bytes``, as the JAX package's serving A/B sizes
    it)."""
    from paddlefleetx_tpu_torch.core.paging import (
        pool_bytes, pool_pages_for_bytes,
    )
    dims = (cfg.num_layers, cfg.num_attention_heads, cfg.head_dim, page)
    budget = pool_bytes(*dims, bf16_pages, "bf16")
    return pool_pages_for_bytes(budget, *dims, "int8"), budget


def phase_serve_int8(bf16_paged, device="cuda", overrides=(),
                     short=INT8_SHORT):
    """The JAX package's int8 serving A/B at full width: the headline
    trace with both int8 knobs on (weights from ``Global.seed``,
    quantized at build) through the paged server from an int8 pool that
    fits the bf16 pool's device bytes (122 pages for 65 at 345M), then
    ``short`` contiguous, contiguous speculative and paged speculative
    arms, so that every int8 instance and kernel 7 run on a main path,
    each with its counts zeroed just before and read just after (and
    checked: :func:`check_int8_counts`). ``bf16_paged`` is the
    ``serve_paged`` record of the same call, printed beside. Returns
    ``({arm: record}, module)``."""
    hl = HEADLINE
    module = serving_module(device, [
        *INT8_KNOBS, f"Generation.max_dec_len={hl['max_dec_len']}",
        *overrides])
    cfg = module.model_config
    pages, budget = int8_pool_pages(cfg, hl["pool_pages"], hl["page"])
    runs = {"paged": serve_trace(module, "serve_int8", device,
                                 pool_pages=pages, warm=WARM)}
    runs["contiguous"] = serve_trace(
        module, "serve_int8", device, paged=False,
        slots=hl["contiguous_spec_slots"], warm=WARM, **short)
    runs["contiguous_spec"] = serve_trace(
        module, "serve_int8", device, spec=True, paged=False,
        slots=hl["contiguous_spec_slots"], warm=WARM, **short)
    runs["paged_spec"] = serve_trace(module, "serve_int8", device, spec=True,
                                     pool_pages=pages, warm=WARM, **short)
    for name in ("contiguous_spec", "paged_spec"):
        rate = runs[name]["spec_accept_rate"]
        if not 0.0 <= rate <= SPEC_ACCEPT_LIMIT:
            raise AssertionError(f"serve_int8 {name} accepted {rate:.4f} of "
                                 f"its drafts, over {SPEC_ACCEPT_LIMIT}")
    cap_pages = cfg.cache_capacity // hl["page"]
    admit, admit_bf16 = (pages - 1) // cap_pages, \
        (hl["pool_pages"] - 1) // cap_pages
    p = runs["paged"]
    ab = {"phase": "serve_int8_ab", "pool_bytes": budget,
          "pool_pages": pages, "pool_pages_bf16": hl["pool_pages"],
          "slots_admitted": admit, "slots_admitted_bf16": admit_bf16,
          "slot_ratio": admit / max(admit_bf16, 1)}
    for key in ("decode_tokens_per_s", "e2e_tokens_per_s", "tick_p50_ms",
                "tick_p99_ms", "ttft_p50_ms", "ttft_p99_ms",
                "peak_mem_gib"):
        if key in p:
            ab[key] = p[key]
            ab[key + "_bf16"] = bf16_paged.get(key)
    emit(ab)
    return runs, module


def phase_parity_int8(device="cuda", overrides=(), max_dec_len=48,
                      small_pool=9):
    """Greedy rows under both int8 knobs, at the 345M width: the paged,
    paged speculative, contiguous speculative and contiguous servers
    against the int8 lockstep ``generate()`` (kernel 2's shared-offset
    int8 instance, its counts checked), on four prompts sharing a
    256-token prefix, the last a repeat of the first. In fp32 every row
    must equal lockstep (a mismatch only at a true near-tie), also with
    a ``small_pool``-page pool in which the repeat is admitted late,
    shares the first prompt's pages, partial last page included, and
    splits it copy-on-write, and a request is preempted: a split that
    left the scale pools behind would change its row. bf16 prints its
    equal-row share; both print the share of int8 lockstep rows equal to
    the lockstep rows of the same weights with both knobs off."""
    import dataclasses
    from paddlefleetx_tpu_torch.core.serving import GenerationServer
    from paddlefleetx_tpu_torch.models.gpt.generation import (
        generate, left_pad_batch,
    )
    hl = HEADLINE
    records = []
    for dtype_over in (["Engine.mix_precision.use_pure_fp16=False"], []):
        base = [*dtype_over, "Generation.decode_strategy=greedy_search",
                f"Generation.max_dec_len={max_dec_len}", *overrides]
        module = serving_module(device, [*INT8_KNOBS, *base])
        cfg, gcfg, model = module.model_config, module.generation_cfg, \
            module.model
        prompts = parity_prompts(cfg.vocab_size)
        prompts[3] = list(prompts[0])
        ids, mask = left_pad_batch(prompts, gcfg.pad_token_id)
        eos = gcfg.eos_token_id
        reset_counts()
        lockstep = [_truncate(r, eos)
                    for r in generate(model, ids, mask, gcfg).tolist()]
        counts = read_counts()
        layers = cfg.num_layers
        steps = (max_dec_len - 1) * layers
        if counts["flash_decode_int8"] != steps or counts["flash_decode"] or \
                counts["counters"].get("attention/flash_decode_int8") != steps:
            raise AssertionError(f"parity_int8: lockstep launched kernel 2's "
                                 f"int8 instance {counts['flash_decode_int8']} "
                                 f"times for {steps} layer-steps: {counts}")
        check_quant_counts(counts, layers, max_dec_len, "parity_int8")
        spec = dataclasses.replace(gcfg, spec_method="ngram",
                                   spec_tokens=hl["spec_tokens"])
        paged = dict(page_size=hl["page"],
                     prefill_chunk_pages=hl["prefill_chunk_pages"])
        small = dict(paged, pool_pages=small_pool)
        runs = {"paged": (gcfg, paged), "paged_spec": (spec, paged),
                "contiguous_spec": (spec, {}), "contiguous": (gcfg, {}),
                "paged_small_pool": (gcfg, small),
                "paged_spec_small_pool": (spec, small)}
        rows, summaries = {}, {}
        for name, (g, kw) in runs.items():
            srv = GenerationServer(model, g, num_slots=len(prompts), **kw)
            rows[name] = [c.tokens for c in srv.run(prompts)]
            summaries[name] = srv.summary()
            if srv.paged:
                srv.check_alloc()
                if summaries[name]["pages_in_use"]:
                    raise AssertionError(f"parity_int8: {name} left pages "
                                         f"in use")
        near = 0
        if cfg.dtype == "float32":
            for name, got in rows.items():
                near += len(compare_rows(f"parity_int8_{name}", model,
                                         prompts, got, lockstep, eos))
        del module, model
        ref = serving_module(device, base)
        ref_rows = [_truncate(r, eos) for r in generate(
            ref.model, ids, mask, ref.generation_cfg).tolist()]
        del ref
        record = {"phase": "parity_int8", "dtype": cfg.dtype,
                  "kv_cache_dtype": cfg.kv_cache_dtype,
                  "quant_execution": cfg.quant_execution,
                  "requests": len(prompts),
                  "prompt_lens": [len(p) for p in prompts],
                  "max_dec_len": max_dec_len, "small_pool": small_pool,
                  "lockstep_launches": {
                      k: counts[k] for k in ("flash_attention",
                                             "flash_decode_int8",
                                             "quantized_matmul")},
                  "counts": {n: {k: sm.get(k) for k in (
                      "prefill_chunks", "prefix_hits", "prompt_hits",
                      "cow_splits", "preempted", "spec_accept_rate",
                      "decode_ticks")} for n, sm in summaries.items()},
                  "lockstep_rows_equal_share_vs_knobs_off":
                  _first_divergence(lockstep, ref_rows, eos)[0]
                  / len(prompts)}
        if cfg.dtype == "float32":
            for name in ("paged_small_pool", "paged_spec_small_pool"):
                sm = summaries[name]
                if sm["preempted"] == 0 or sm["cow_splits"] == 0:
                    raise AssertionError(
                        f"parity_int8: {name} with a {small_pool}-page pool "
                        f"preempted {sm['preempted']} and split "
                        f"{sm['cow_splits']} pages (each must be > 0)")
            record["rows_equal"] = {n: _first_divergence(r, lockstep, eos)[0]
                                    for n, r in rows.items()}
            record["near_ties"] = near
        else:
            record["rows_equal_share"] = {
                n: _first_divergence(r, lockstep, eos)[0] / len(prompts)
                for n, r in rows.items()}
            record["first_divergence"] = {
                n: _first_divergence(r, lockstep, eos)[1]
                for n, r in rows.items()}
        emit(record)
        records.append(record)
    return records


# -- the training path --------------------------------------------------


def train_argv(data_dir, out_dir, overrides, device, config=TRAIN_CONFIG):
    """``train`` entry-point arguments: the pretraining recipe
    ``config`` (the 345M one by default) on the corpus in ``data_dir``,
    plus ``overrides``."""
    argv = ["-c", config]
    if device != "cuda":
        argv += ["--device", device]
    over = [f"Engine.save_load.output_dir={out_dir}"]
    for mode in ("Train", "Eval"):
        over.append(f"Data.{mode}.dataset.input_dir={data_dir}")
    for o in over + list(overrides):
        argv += ["-o", o]
    return argv


def write_train_corpus(path, overrides, steps, config=TRAIN_CONFIG):
    """A seeded synthetic corpus (``data/synthetic.py``) covering
    ``steps`` batches of the recipe ``config`` (cut by ``overrides``),
    and at least 200k tokens, so the recipe's 949 / 50 / 1 split leaves
    documents for evaluation."""
    from paddlefleetx_tpu_torch.data.synthetic import write_corpus
    from paddlefleetx_tpu_torch.utils.config import get_config
    cfg = get_config(config, list(overrides))
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
                "Engine.save_load.save_steps=1000000",
                "Engine.print_summary=True", *TRAIN_LR, *overrides]
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
    check_fwd_routes(counts, "train")
    # the dispatch counter counts calls of the dispatch, and a recompute
    # replays the block's Python (the kernel's saved output is reused)
    if c.get("attention/flash_dropout", 0) < want or \
            c.get("attention/dense", 0) != 0 or \
            c.get("attention/flash", 0) != 0:
        raise AssertionError(f"train: attention counters {c}")
    if not engine.print_summary or not engine.summary.get("tokens_per_sec"):
        raise AssertionError(f"train: no run summary ({engine.summary})")
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
        "summary": {k: engine.summary.get(k) for k in (
            "tokens_per_sec", "mfu", "steady_mean_s_per_step",
            "goodput_pct", "wall_total_s")},
        "first_loss": losses[0], "last_loss": losses[-1],
        "mean_first5": first5, "mean_last5": last5,
        "launches_per_step": {k: counts[k] / steps for k in (
            "flash_attention", "flash_bwd_dkv", "flash_bwd_dq")},
        "launches": {k: counts[k] for k in (
            "flash_attention", "flash_bwd_dkv", "flash_bwd_dq")},
        "launches_by_route": {
            "flash_attention": counts["flash_attention_routes"]},
        "counters": c}
    if device != "cpu":
        record["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    emit(record)
    return record, engine


def phase_train_profile(engine, data_seed=9, phase="train_profile"):
    """Where one training step's device time goes (the train phase's
    engine and model, one more step on a seeded batch): kernel time by
    category and the device's idle share, printed as ``phase``."""
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
    window = profile_window(torch, phase.replace("profile", "step"),
                            lambda: engine.train_step(batch), 1)
    emit({"phase": phase, "windows": [window]})
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
    return _loss_and_grads(module, batch, seed)[1]


def _loss_and_grads(module, batch, seed):
    """The training loss of one ``loss_fn`` on ``batch`` (host arrays)
    and every parameter's gradient, left zeroed in the model."""
    import numpy as np
    import torch
    model = module.model
    model.train()
    dev = next(model.parameters()).device
    data = tuple(torch.from_numpy(np.asarray(x)).to(dev) for x in batch)
    loss = module.loss_fn(model, data, seed, train=True)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


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


def _step_dirs(out):
    """The ``epoch_*_step_*`` directories under ``out``, sorted."""
    return sorted(d for d in os.listdir(out) if re.fullmatch(
        r"epoch_\d+_step_\d+", d))


def _same_files(a, b, label):
    """Hold two step directories' ``model.pt`` and ``optimizer.pt`` to
    each other tensor for tensor, bit for bit (loaded on the CPU)."""
    import torch

    def flat(obj, key=""):
        """``{path: leaf}`` of a nested state dict."""
        if isinstance(obj, torch.Tensor):
            return {key: obj}
        if isinstance(obj, dict):
            out = {}
            for k, v in obj.items():
                out.update(flat(v, f"{key}/{k}"))
            return out
        if isinstance(obj, (list, tuple)):
            out = {}
            for n, v in enumerate(obj):
                out.update(flat(v, f"{key}/{n}"))
            return out
        return {key: obj}

    n = 0
    for name in ("model.pt", "optimizer.pt"):
        x = flat(torch.load(os.path.join(a, name), map_location="cpu",
                            weights_only=True))
        y = flat(torch.load(os.path.join(b, name), map_location="cpu",
                            weights_only=True))
        if x.keys() != y.keys():
            raise AssertionError(f"{label}: {name} keys differ")
        for k in x:
            same = torch.equal(x[k], y[k]) if isinstance(x[k], torch.Tensor) \
                else x[k] == y[k]
            if not same:
                raise AssertionError(f"{label}: {name} {k} differs between "
                                     f"{a} and {b}")
            n += 1
    return n


def _sigterm_at(step):
    """A step hook on ``GPTModule.training_step_end`` that sends this
    process SIGTERM once the logged step reaches ``step``; returns the
    hook's undo."""
    import signal
    from paddlefleetx_tpu_torch.models.gpt.modules import GPTModule
    orig = GPTModule.training_step_end

    def hook(self, log):
        orig(self, log)
        if log["batch"] == step:
            os.kill(os.getpid(), signal.SIGTERM)

    GPTModule.training_step_end = hook
    return lambda: setattr(GPTModule, "training_step_end", orig)


def phase_train_cli(device="cuda", overrides=(), steps=4, async_steps=6):
    """``cli.train_main`` on the recipe at a reduced depth, saving every
    2 steps and evaluating at step 2, then a second call that resumes
    from the step-2 checkpoint: both reach step ``steps`` and the
    resumed run's last loss equals the first run's within 1e-3
    relative (bit-exact is reported, not required: cuBLAS and the
    embedding backward may sum in another order between processes'
    runs). Then the engine's run-time services through the same entry
    point: an async run (``async_save``, ``keep_last_k`` 2, a save
    every 2 steps to ``async_steps``) leaves only its two newest step
    directories, each equal bit for bit to a synchronous twin run's
    save of the same step (the async snapshot raced the next step's
    update); a resume from its newest reaches step ``async_steps`` + 2
    within 1e-3 of the twin's loss there; a SIGTERM sent from a step
    hook at step 3 saves ``epoch_0_step_3`` and stops, and a resume from
    it reaches step ``async_steps`` within 1e-3 of the async run's
    loss; a ``run_mode: epoch`` run evaluates once, at the epoch's
    end (its ``events.jsonl``)."""
    from paddlefleetx_tpu_torch import cli
    from paddlefleetx_tpu_torch.observability.recorder import read_events
    tmp = tempfile.mkdtemp(prefix="pfx_cli_")
    rec = {}
    try:
        over = ["Model.num_layers=4", f"Engine.max_steps={steps}",
                "Engine.logging_freq=1", "Engine.eval_freq=2",
                "Engine.eval_iters=1", "Engine.save_load.save_steps=2",
                *TRAIN_LR, *overrides]
        data = os.path.join(tmp, "data")
        write_train_corpus(data, over, async_steps + 2)

        def run(name, *extra):
            return cli.train_main(train_argv(
                data, os.path.join(tmp, name), over + list(extra), device))

        first = run("a")
        step2 = os.path.join(tmp, "a", "epoch_0_step_2")
        second = run("b", f"Engine.save_load.ckpt_dir={step2}")
        shutil.rmtree(os.path.join(tmp, "a"))
        shutil.rmtree(os.path.join(tmp, "b"))
        t0 = time.perf_counter()
        asy = run("async", f"Engine.max_steps={async_steps}",
                  "Engine.save_load.async_save=True",
                  "Engine.save_load.keep_last_k=2")
        rec["async_run_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        twin = run("twin", f"Engine.max_steps={async_steps + 2}")
        rec["sync_twin_run_s"] = time.perf_counter() - t0
        kept = _step_dirs(os.path.join(tmp, "async"))
        want = [f"epoch_0_step_{async_steps - 2}",
                f"epoch_0_step_{async_steps}"]
        if kept != want:
            raise AssertionError(f"train_cli: keep_last_k 2 left {kept}, "
                                 f"expected {want}")
        rec["async_equal_tensors"] = sum(
            _same_files(os.path.join(tmp, "async", d),
                        os.path.join(tmp, "twin", d), "train_cli async")
            for d in kept)
        shutil.rmtree(os.path.join(tmp, "twin"))
        resumed = run("resumed", f"Engine.max_steps={async_steps + 2}",
                      "Engine.save_load.save_steps=1000000",
                      f"Engine.save_load.ckpt_dir={tmp}/async")
        shutil.rmtree(os.path.join(tmp, "async"))
        undo = _sigterm_at(3)
        try:
            pre = run("preempt", f"Engine.max_steps={async_steps}",
                      "Engine.save_load.save_steps=1000000")
        finally:
            undo()
        pre_dirs = _step_dirs(os.path.join(tmp, "preempt"))
        after = run("after", f"Engine.max_steps={async_steps}",
                    "Engine.save_load.save_steps=1000000",
                    f"Engine.save_load.ckpt_dir={tmp}/preempt/"
                    f"epoch_0_step_3")
        shutil.rmtree(os.path.join(tmp, "preempt"))
        epoch = run("epoch", "Engine.run_mode=epoch", "Engine.eval_freq=1",
                    "Engine.max_steps=2", "Telemetry.enable=True",
                    "Engine.save_load.save_steps=1000000",
                    "Engine.save_load.save_epoch=2")
        epoch_events = [e["event"] for e in read_events(
            os.path.join(tmp, "epoch", "events.jsonl"))]
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
    checks = {
        "resume_from_async": (resumed, twin, async_steps + 2, 2),
        "resume_from_preemption": (after, asy, async_steps,
                                   async_steps - 3)}
    for name, (got, ref, last, n) in checks.items():
        x, y = got.history[-1]["loss"], ref.history[-1]["loss"]
        r = abs(x - y) / abs(y)
        if got.step != last or len(got.history) != n or r > 1e-3:
            raise AssertionError(
                f"train_cli {name}: step {got.step} (want {last}), "
                f"{len(got.history)} steps run, loss {x} vs {y} (rel "
                f"{r:.2e})")
        rec[name] = {"loss": x, "reference": y, "rel_diff": r,
                     "bit_exact": x == y}
    if pre.step != 3 or pre_dirs != ["epoch_0_step_3"]:
        raise AssertionError(f"train_cli: SIGTERM at step 3 stopped at "
                             f"{pre.step} with {pre_dirs}")
    n_eval = epoch_events.count("eval_start")
    if epoch.step != 2 or n_eval != 1 or \
            epoch_events.index("eval_start") < \
            len(epoch_events) - 1 - epoch_events[::-1].index("step_window"):
        raise AssertionError(f"train_cli: epoch mode ran {epoch.step} "
                             f"steps, events {epoch_events}")
    emit({"phase": "train_cli", "layers": first.module.model_config.
          num_layers, "steps": steps, "resumed_from_step": 2,
          "loss_first_run": a, "loss_resumed": b, "rel_diff": rel,
          "bit_exact": a == b, "tol_rel": 1e-3,
          "async": {"steps": async_steps, "keep_last_k": 2, "kept": kept,
                    "twin_equal": True, **rec},
          "preemption": {"sigterm_at": 3, "stopped_at": pre.step,
                         "saved": pre_dirs},
          "epoch_mode": {"steps": epoch.step, "evals": n_eval}})


#: the 1.3B recipe the auto entry point drives
AUTO_1P3B_CONFIG = os.path.join(ROOT, "configs", "nlp", "gpt", "auto",
                                "pretrain_gpt_1.3B_single_card.yaml")


def expected_events(steps, eval_freq, logging_freq=1):
    """The JAX engine's non-span event names, in order, for a ``fit``
    of ``steps`` steps with ``eval_freq`` (run mode step), no save and
    no compile event (the port has none): ``fit_start``, a
    ``step_window`` per logging window, ``eval_start`` / ``eval_end``
    after every ``eval_freq``-th step, ``fit_end``."""
    names = ["fit_start"]
    for step in range(1, steps + 1):
        if step % logging_freq == 0:
            names.append("step_window")
        if step % eval_freq == 0:
            names += ["eval_start", "eval_end"]
    return names + ["fit_end"]


def trace_breakdown(path):
    """Where the device time of an engine profiler window went, from its
    chrome trace at ``path``: the window's span (first to last event of
    any kind), the union of its kernel spans, the idle share, the kernel
    time by category and the hand-written kernels' events by
    :func:`trace_keys` (``traced_launches``)."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if "dur" in e and "ts" in e]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        return {"kernels": 0}
    span = max(e["ts"] + e["dur"] for e in events) - \
        min(e["ts"] for e in events)
    by_cat, traced, busy = kernel_summary(kernels)
    return {"window_ms": span / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / span, "kernels": len(kernels),
            "kernel_ms": by_cat, "traced_launches": traced}


def phase_train_auto_1p3b(device="cuda", overrides=(), steps=8, eval_freq=4,
                          config=AUTO_1P3B_CONFIG, phase="train_auto_1p3b"):
    """The 1.3B auto recipe through ``cli.auto_main`` at full width (24
    layers, hidden 2048, 16 heads, head_dim 128, b8 x 1024, full
    recompute, dropout 0.1 / 0.1, bf16 on fp32 masters; ``overrides``
    cut it on the CPU) for ``steps`` steps with telemetry and a
    one-step profiler window on and ``prefetch_depth`` at its default.
    ``-o`` sets only the rate (``TRAIN_LR``), the steps, the eval
    cadence (every ``eval_freq`` steps, one batch: the recipe evaluates
    every step for 10) and a ``save_epoch`` above the epochs run, so no
    checkpoint is written. Asserts finite losses; kernel 1 launched
    twice a layer and step (the forward and the backward's recompute)
    plus once a layer and eval batch, kernels 3 and 4 once a layer and
    step, every kernel-1 launch on its planned route, no
    ``attention/fallback/*`` and no dense attention; the JAX engine's
    event names in its order in ``events.jsonl``; the chrome trace in
    ``profiler_log``."""
    import torch
    from paddlefleetx_tpu_torch import cli
    from paddlefleetx_tpu_torch.observability import flops
    from paddlefleetx_tpu_torch.observability.recorder import read_events
    tmp = tempfile.mkdtemp(prefix="pfx_auto_")
    try:
        over = [f"Engine.max_steps={steps}", f"Engine.eval_freq={eval_freq}",
                "Engine.eval_iters=1", "Engine.save_load.save_epoch=2",
                "Telemetry.enable=True", "Profiler.enable=True",
                "Profiler.scheduler=[2,3]",
                f"Profiler.profiler_log={tmp}/prof", *TRAIN_LR,
                *overrides]
        cfg = write_train_corpus(os.path.join(tmp, "data"), over,
                                 max(steps, 30), config=config)
        argv = train_argv(os.path.join(tmp, "data"),
                          os.path.join(tmp, "out"), over, device,
                          config=config)
        if device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        engine = cli.auto_main(argv)
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        events = read_events(os.path.join(tmp, "out", "events.jsonl"))
        trace = engine.profiler_trace
        trace_ok = bool(trace) and os.path.isfile(trace) and \
            os.path.getsize(trace) > 0
        profiled = trace_breakdown(trace) if trace_ok and \
            device != "cpu" else None
        kept = _step_dirs(os.path.join(tmp, "out"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    mcfg = engine.module.model_config
    losses = [h["loss"] for h in engine.history]
    if len(losses) != steps or not all(map(lambda x: x == x and
                                           abs(x) < float("inf"), losses)):
        raise AssertionError(f"{phase}: losses {losses}")
    layers = mcfg.num_layers
    evals = steps // eval_freq
    want = {"flash_attention": 2 * steps * layers + evals * layers,
            "flash_bwd_dkv": steps * layers, "flash_bwd_dq": steps * layers}
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{phase}: {name} launched {counts[name]} "
                                 f"times, expected {n} ({steps} steps, "
                                 f"{evals} eval batches, {layers} layers)")
    check_fwd_routes(counts, phase)
    c = counts["counters"]
    if c.get("attention/dense", 0) or any(
            k.startswith("attention/fallback") for k in c):
        raise AssertionError(f"{phase}: attention counters {c}")
    names = [e["event"] for e in events if not e["event"].startswith("span")]
    if names != expected_events(steps, eval_freq):
        raise AssertionError(f"{phase}: events {names}, expected "
                             f"{expected_events(steps, eval_freq)}")
    spans = {e["name"] for e in events if e["event"].startswith("span")}
    if not {"engine/fit", "engine/step", "engine/h2d"} <= spans:
        raise AssertionError(f"{phase}: spans {spans}")
    if not trace_ok or kept:
        raise AssertionError(f"{phase}: trace {trace}, step dirs {kept}")
    if mcfg.recompute_granularity != "full" or not mcfg.use_recompute:
        raise AssertionError(f"{phase}: recompute "
                             f"{mcfg.recompute_granularity}")
    per_step = {"flash_attention": 2 * layers, "flash_bwd_dkv": layers,
                "flash_bwd_dq": layers}
    if profiled is not None:
        # the engine's window traces one step, CPU and CUDA: every one of
        # its hand-written kernels must show in the trace. Its events are
        # reported beside a step's launches, not held equal to them: the
        # profiler has lost one kernel event of such a step (47 of 48
        # kernel-1 events in two runs on the H100, 48 in another), and
        # the launches are held exactly by the counts above
        traced = profiled["traced_launches"]
        if any(traced.get(k, 0) == 0 for k in per_step):
            raise AssertionError(f"{phase}: the traced step holds {traced}, "
                                 f"a step launches {per_step}")
    costs = [h["train_cost"] for h in engine.history[1:]]
    seq = cfg.Data.Train.dataset.max_seq_len
    tokens = cfg.Global.global_batch_size * seq
    p50 = _percentile(costs, 0.5)
    fpt = flops.model_flops_per_token(layers, mcfg.hidden_size,
                                      mcfg.vocab_size, seq)
    waits = engine._h2d_waits[1:] or engine._h2d_waits
    record = {
        "phase": phase, "model": "GPT-1.3B", "module": cfg.Model.module,
        "dtype": mcfg.dtype, "layers": layers, "hidden": mcfg.hidden_size,
        "heads": mcfg.num_attention_heads,
        "head_dim": mcfg.hidden_size // mcfg.num_attention_heads,
        "vocab": mcfg.vocab_size, "batch": cfg.Global.global_batch_size,
        "seq": seq, "dropout": [mcfg.hidden_dropout_prob,
                                mcfg.attention_probs_dropout_prob],
        "recompute": mcfg.recompute_granularity, "steps": steps,
        "eval_batches": evals, "prefetch_depth": engine.prefetch_depth,
        "wall_s": wall, "first_step_s": engine.history[0]["train_cost"],
        "step_p50_s": p50, "step_p90_s": _percentile(costs, 0.9),
        "tokens_per_s": tokens / p50, "model_flops_per_token": fpt,
        "mfu": flops.mfu(tokens / p50, fpt),
        "mfu_peak": "bf16 dense 989 TFLOP/s",
        "h2d_wait_p50_s": _percentile(waits, 0.5),
        "h2d_fill_s": engine._h2d_waits[0],
        "peak_bytes_in_use": engine.summary.get("hbm_peak_bytes"),
        "hbm_bytes_limit": engine.summary.get("hbm_bytes_limit"),
        "first_loss": losses[0], "last_loss": losses[-1],
        "launches": {k: counts[k] for k in want},
        "launches_per_step_expected": per_step,
        "launches_by_route": {
            "flash_attention": counts["flash_attention_routes"]},
        "events": len(events), "event_names_match_jax": True,
        "profiler_trace": os.path.basename(trace), "profiled_step": profiled,
        "counters": c}
    emit(record)
    return record


# -- MoE training: the 8x345M recipe on one card -----------------------

#: the MoE recipe's parallel degrees collapse to one card (its expert
#: axis then takes the JAX package's own ``ep_degree: 1`` route)
MOE_ONE_CARD = ["Distributed.dp_degree=1",
                "Distributed.sharding.sharding_degree=1",
                "Distributed.ep_degree=1"]
#: kernel 8 launches a layer and microbatch (fc1, fc2 forward; their dx)
#: and kernel 9's (their dw), under ``save_dots``
GMM_PER_LAYER = {"grouped_matmul": 4, "grouped_matmul_dw": 2}


def moe_flops_per_token(mcfg, seq) -> float:
    """Model FLOPs a token of an MoE GPT's training step with the top-k
    experts each token runs: the dense (Megatron) formula, which counts
    one FFN of width ``4 h``, plus ``k - 1`` more expert FFNs (forward
    and backward, ``3 x 2 x 2 h m``) and the router (``3 x 2 h E``) in
    every layer."""
    from paddlefleetx_tpu_torch.observability import flops
    L, h, m = mcfg.num_layers, mcfg.hidden_size, mcfg.ffn_hidden_size
    dense = flops.model_flops_per_token(L, h, mcfg.vocab_size, seq)
    return dense + L * (12.0 * (mcfg.moe_top_k - 1) * h * m +
                        6.0 * h * mcfg.moe_num_experts)


#: the route every expert GEMM of the MoE recipe takes on the card
MOE_ROUTE = "wgmma"


def check_moe_counts(counts, steps, acc, layers, label, route=None):
    """Kernels 8 and 9 launched ``GMM_PER_LAYER`` times a layer and
    microbatch (kernel 8 more often: ``save_dots`` recomputed the expert
    GEMMs), all of them on ``route`` where one is given, kernels 1, 3, 4
    once, every MoE block on ``sort_pallas``, no fallback of either
    dispatch and no dense attention."""
    runs = steps * acc * layers
    want = {k: v * runs for k, v in GMM_PER_LAYER.items()}
    want.update({k: runs for k in ("flash_attention", "flash_bwd_dkv",
                                   "flash_bwd_dq")})
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")
    for name in GMM_PER_LAYER if route else ():
        by_route = counts[f"{name}_routes"]
        if by_route.get(route, 0) != counts[name]:
            raise AssertionError(f"{label}: {name} launches by route "
                                 f"{by_route}, expected all {counts[name]} "
                                 f"on {route}")
    c = counts["counters"]
    fallbacks = sorted(k for k in c if k.startswith(
        ("moe/fallback/", "attention/fallback/")))
    if fallbacks or c.get("moe/sort_pallas", 0) < runs or \
            c.get("moe/sort", 0) or c.get("attention/dense", 0):
        raise AssertionError(f"{label}: counters {c}")


def phase_train_moe(device="cuda", overrides=(), steps=16):
    """The MoE training path: the 8x345M recipe at full width (24
    layers, hidden 1024, 8 experts, top-2, capacity 1.25, aux and z
    losses, ``sort_pallas``, ``save_dots``, dropout 0.1 / 0.1, bf16,
    local batch 16 in microbatches of 2 x 1024) on one card through
    ``cli.train_main`` for ``steps`` steps on a seeded synthetic corpus,
    with the counts zeroed just before and read just after. Asserts
    finite, falling losses and the launches of kernels 8 and 9 a step
    (``check_moe_counts``). Returns the record and the engine."""
    import numpy as np
    import torch
    from paddlefleetx_tpu_torch import cli
    from paddlefleetx_tpu_torch.models.gpt.model import compute_context
    from paddlefleetx_tpu_torch.observability import flops
    tmp = tempfile.mkdtemp(prefix="pfx_moe_")
    try:
        over = [*MOE_ONE_CARD, f"Engine.max_steps={steps}",
                "Engine.logging_freq=1", "Engine.eval_freq=1000000",
                "Engine.eval_iters=1", "Engine.save_load.save_steps=1000000",
                *TRAIN_LR, *overrides]
        data = os.path.join(tmp, "data")
        cfg = write_train_corpus(data, over, steps, MOE_CONFIG)
        argv = train_argv(data, os.path.join(tmp, "out"), over, device,
                          MOE_CONFIG)
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
        raise AssertionError(f"train_moe: losses {losses}")
    first5, last5 = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    if not last5 < first5:
        raise AssertionError(f"train_moe: the loss did not fall "
                             f"({first5:.4f} -> {last5:.4f})")
    acc, layers = engine.accumulate_steps, mcfg.num_layers
    check_moe_counts(counts, steps, acc, layers, "train_moe",
                     route=MOE_ROUTE if device != "cpu" else None)
    check_fwd_routes(counts, "train_moe")
    seq = cfg.Data.Train.dataset.max_seq_len
    micro = cfg.Global.micro_batch_size
    # the trained model's router loss and cross-entropy on a seeded
    # microbatch (no dropout)
    tokens = torch.from_numpy(np.random.default_rng(12).integers(
        0, mcfg.vocab_size, (micro, seq + 1))).to(engine.device)
    with torch.no_grad(), compute_context(mcfg, engine.device):
        logits, aux = engine.model(tokens[:, :-1], return_aux=True)
        ce = torch.nn.functional.cross_entropy(
            logits.float().flatten(0, 1), tokens[:, 1:].flatten())
    costs = [h["train_cost"] for h in engine.history[1:]]
    tokens_step = cfg.Global.global_batch_size * seq
    p50 = _percentile(costs, 0.5)
    fpt = flops.model_flops_per_token(layers, mcfg.hidden_size,
                                      mcfg.vocab_size, seq)
    fpt_moe = moe_flops_per_token(mcfg, seq)
    record = {
        "phase": "train_moe", "model": "MoE GPT 8x345M", "dtype": mcfg.dtype,
        "layers": layers, "hidden": mcfg.hidden_size,
        "heads": mcfg.num_attention_heads, "ffn": mcfg.ffn_hidden_size,
        "vocab": mcfg.vocab_size, "experts": mcfg.moe_num_experts,
        "top_k": mcfg.moe_top_k,
        "capacity_factor": mcfg.moe_capacity_factor,
        "dispatch": mcfg.moe_dispatch,
        "params": sum(p.numel() for p in engine.model.parameters()),
        "batch": cfg.Global.global_batch_size, "micro_batch": micro,
        "accumulate_steps": acc, "seq": seq,
        "dropout": [mcfg.hidden_dropout_prob,
                    mcfg.attention_probs_dropout_prob],
        "recompute": mcfg.recompute_granularity,
        "lr_overrides": TRAIN_LR, "steps": steps, "wall_s": wall,
        "first_step_s": engine.history[0]["train_cost"],
        "step_p50_s": p50, "step_p90_s": _percentile(costs, 0.9),
        "tokens_per_s": tokens_step / p50,
        "model_flops_per_token": fpt, "mfu": flops.mfu(tokens_step / p50,
                                                       fpt),
        "moe_flops_per_token": fpt_moe,
        "mfu_top_k": flops.mfu(tokens_step / p50, fpt_moe),
        "mfu_peak": "bf16 dense 989 TFLOP/s",
        "first_loss": losses[0], "last_loss": losses[-1],
        "mean_first5": first5, "mean_last5": last5,
        "aux_after": float(aux), "ce_after": float(ce),
        "launches_per_step": {k: counts[k] / steps for k in (
            "grouped_matmul", "grouped_matmul_dw", "flash_attention",
            "flash_bwd_dkv", "flash_bwd_dq")},
        "launches": {k: counts[k] for k in (
            "grouped_matmul", "grouped_matmul_dw", "flash_attention",
            "flash_bwd_dkv", "flash_bwd_dq")},
        "launches_by_route": {**routes_by_kernel(counts), "flash_attention":
                              counts["flash_attention_routes"]},
        "counters": counts["counters"]}
    if device != "cpu":
        record["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    emit(record)
    return record, engine


#: the MoE parity phase's limits: fp32, the two runs differ in summation
#: order only; bf16, each GEMM's output rounds to bf16 from sums taken in
#: another order, and a near-tied top-2 choice of the second block's
#: router may flip with it
PARITY_MOE_TOL = {"float32": {"loss_rel": 1e-4, "grad_leaf_rel": 1e-4},
                  "bfloat16": {"loss_rel": 5e-3, "grad_leaf_rel": 5e-2}}


def phase_train_moe_parity(device="cuda", overrides=(), batch=2,
                           data_seed=77):
    """The MoE recipe at full width cut to 2 layers, dropout 0: the same
    weights and batch through ``sort_pallas`` (kernels 8 and 9) and
    ``sort`` (``torch.bmm`` on the same grouped buffer), in fp32 and in
    bf16; the losses and every leaf's gradient held within
    ``PARITY_MOE_TOL``, and the kernels' counts fire in the first run
    and not in the second; then the fp32 kernel gradient again with
    kernel 9's dw of expert 0 planted as zeros, which the leaf check
    must refuse."""
    import functools

    import numpy as np
    from paddlefleetx_tpu_torch.ops.cuda import grouped_matmul as gmm
    from paddlefleetx_tpu_torch.models.gpt.modules import GPTModule
    from paddlefleetx_tpu_torch.utils.config import get_config
    base = [*MOE_ONE_CARD, "Model.num_layers=2",
            "Model.hidden_dropout_prob=0.0",
            "Model.attention_probs_dropout_prob=0.0",
            f"Global.local_batch_size={batch}",
            f"Global.micro_batch_size={batch}", *overrides]
    cfg = get_config(MOE_CONFIG, base)
    seq = cfg.Data.Train.dataset.max_seq_len
    rng = np.random.default_rng(data_seed)
    tokens = rng.integers(0, cfg.Model.vocab_size, (batch, seq + 1))
    data = (tokens[:, :-1], np.broadcast_to(np.arange(seq), (batch, seq))
            .copy(), tokens[:, 1:], np.ones((batch, seq), np.float32))
    record = {"phase": "train_moe_parity", "layers": 2, "batch": batch,
              "seq": seq, "tol": PARITY_MOE_TOL}
    for name, extra in (("float32",
                         ["Engine.mix_precision.use_pure_fp16=False"]),
                        ("bfloat16", [])):
        state, runs = None, {}
        for mode in ("sort_pallas", "sort"):
            module = GPTModule(get_config(MOE_CONFIG, base + extra + [
                f"Model.moe_dispatch={mode}"]), state_dict=state,
                device=device)
            mcfg = module.model_config
            if mcfg.dtype != name or mcfg.moe_dispatch != mode:
                raise AssertionError(f"train_moe_parity: {mode} run is "
                                     f"{mcfg.dtype}, {mcfg.moe_dispatch}")
            if state is None:
                state = {k: v.clone() for k, v in
                         module.model.state_dict().items()}
            reset_counts()
            loss, grads = _loss_and_grads(module, data, 0)
            counts = read_counts()
            layers = mcfg.num_layers
            want = {k: v * layers if mode == "sort_pallas" else 0
                    for k, v in GMM_PER_LAYER.items()}
            got = {k: counts[k] for k in want}
            c = counts["counters"]
            if got != want or c.get(f"moe/{mode}", 0) < layers or \
                    any(k.startswith("moe/fallback/") for k in c):
                raise AssertionError(f"train_moe_parity: {name} {mode} "
                                     f"launched {got} (expected {want}), "
                                     f"counters {c}")
            runs[mode] = (loss, grads, got)
            del module
        (la, ga, na), (lb, gb, nb) = runs["sort_pallas"], runs["sort"]
        leaf, leaf_rel = _leaf_diff(ga, gb)
        loss_rel = abs(la - lb) / abs(lb)
        tol = PARITY_MOE_TOL[name]
        record[name] = {"loss_kernels": la, "loss_bmm": lb,
                        "loss_rel_diff": loss_rel, "worst_leaf": leaf,
                        "worst_leaf_rel_diff": leaf_rel,
                        "launches_kernels": na, "launches_bmm": nb}
        del runs, ga
        if loss_rel > tol["loss_rel"] or leaf_rel > tol["grad_leaf_rel"]:
            emit(record)
            raise AssertionError(
                f"train_moe_parity: {name} loss rel diff {loss_rel:.2e}, "
                f"worst leaf {leaf} {leaf_rel:.2e} (tol {tol})")
        if name == "float32":
            module = GPTModule(get_config(MOE_CONFIG, base + extra),
                               state_dict=state, device=device)
            dw_kernel = gmm.grouped_matmul_dw

            @functools.wraps(dw_kernel)
            def planted(*args, **kwargs):
                dw = dw_kernel(*args, **kwargs).clone()
                dw[0] = 0
                return dw
            gmm.grouped_matmul_dw = planted
            try:
                grads = _loss_and_grads(module, data, 0)[1]
            finally:
                gmm.grouped_matmul_dw = dw_kernel
            p_leaf, p_rel = _leaf_diff(grads, gb)
            record[name].update(planted_dw_worst_leaf=p_leaf,
                                planted_dw_worst_leaf_rel_diff=p_rel)
            del module, grads
            if not p_rel > tol["grad_leaf_rel"]:
                emit(record)
                raise AssertionError(
                    f"train_moe_parity: with expert 0's dw planted as zeros "
                    f"the worst leaf {p_leaf} reads {p_rel:.2e}, within "
                    f"{tol['grad_leaf_rel']:.0e}")
        del gb
    emit(record)
    return record


# -- MoE serving: the 8x345M model behind every server mode ------------

#: the 8x345M recipe's experts (``pretrain_moe_gpt_8x345M_ep8.yaml``) on
#: the generation recipe, whose Model section is otherwise the MoE
#: recipe's: 24 layers, hidden 1024, 16 heads, ffn 4096, vocab 50304
MOE_KNOBS = ("Model.moe_num_experts=8", "Model.moe_top_k=2",
             "Model.moe_capacity_factor=1.25",
             "Model.moe_dispatch=sort_pallas")
#: kernel 8 launches a layer and forward of the serving path (fc1, fc2)
GMM_SERVE_PER_LAYER = 2
#: kernel 8 at the serving forwards' shapes: (name, batch rows, tokens
#: a row): the 16-slot decode tick, the verify window of 5 tokens, a
#: paged prefill chunk of 256 tokens, and the contiguous admissions of
#: the headline trace's prompts (16..384 tokens), one prompt a forward
#: at its bucket: C 5 and 10 on ``split``, 20 and 40 on ``mma``, 80 and
#: 160 on ``wgmma``
GMM_SERVE = (("decode", 16, 1), ("verify", 16, 5), ("chunk", 1, 256),
             ("bucket16", 1, 16), ("bucket32", 1, 32), ("bucket64", 1, 64),
             ("bucket128", 1, 128), ("bucket256", 1, 256),
             ("bucket512", 1, 512))
#: the expert GEMMs of the 8x345M model as (call, K, N)
GMM_SERVE_CALLS = (("fc1", 1024, 4096), ("fc2", 4096, 1024))


def serve_groups(rows, s, experts=8, top_k=2, factor=1.25, seed=0):
    """``(groups, empty)`` of one serving forward's grouped GEMM: ``G =
    experts * rows`` groups in the (expert, row) order of
    ``MoEMLP._expert_ffn``, C the capacity of ``s`` tokens, and the
    groups no token chose: each token picks ``top_k`` distinct experts
    (seeded) among all but the last, which is planted empty so that
    every shape holds an empty group to zeros."""
    import math
    import numpy as np
    rng = np.random.default_rng(seed)
    live = set()
    for row in range(rows):
        for _ in range(s):
            for e in rng.choice(experts - 1, top_k, replace=False):
                live.add(int(e) * rows + row)
    c = max(1, math.ceil(top_k * s * factor / experts))
    return ({"G": experts * rows, "Gw": experts, "C": c},
            tuple(g for g in range(experts * rows) if g not in live))


def phase_kernel_gmm_serving(device="cuda", shapes=GMM_SERVE,
                             calls=GMM_SERVE_CALLS, experts=8):
    """Kernel 8 (bf16) at the MoE serving forwards' shapes, fc1 and fc2
    each (:func:`gmm_case`: against the plain version, the empty groups
    exact zeros, bit-equal when launched again, the route from the
    counts, timed beside the plain version, the ``mma`` route, its bound
    and ``torch.bmm`` over ``[8, rows C, K] @ [8, K, N]``, the same
    weight bytes); returns the cases, led by the decode tick's fc1."""
    import torch
    from paddlefleetx_tpu_torch.ops.cuda import grouped_matmul as gmm
    cases = []
    seed = 950
    for name, rows, s in shapes:
        groups, empty = serve_groups(rows, s, experts, seed=seed)
        for call, k, n in calls:
            case = gmm_case(gmm, torch, torch.bfloat16, call, k, n, seed,
                            device, groups, empty)
            case["serving"] = name
            cases.append(case)
            emit({"phase": "kernel_gmm_serving", **case})
            seed += 1
    return cases


def check_moe_serve_counts(counts, summary, layers, label):
    """The check of :func:`check_moe_forward_counts` over a server run's
    forwards (a tick, an admission or a prefill chunk each)."""
    check_moe_forward_counts(counts, server_forwards(summary), layers,
                             label)


def check_moe_forward_counts(counts, forwards, layers, label):
    """Each of ``forwards`` MoE forwards launched kernel 8
    ``GMM_SERVE_PER_LAYER`` times a layer, each launch counted under one
    route, and routed every block on ``sort_pallas``; kernel 9 never
    ran, and neither another lowering nor a ``moe/fallback`` counter
    fired."""
    want = GMM_SERVE_PER_LAYER * layers * forwards
    routes = counts["grouped_matmul_routes"]
    if counts["grouped_matmul"] != want or want == 0 or \
            sum(routes.values()) != want or counts["grouped_matmul_dw"]:
        raise AssertionError(
            f"{label}: kernel 8 launched {counts['grouped_matmul']} times "
            f"(by route {routes}), kernel 9 {counts['grouped_matmul_dw']}; "
            f"expected {want} ({GMM_SERVE_PER_LAYER} x {layers} layers x "
            f"{forwards} forwards) and 0")
    c = counts["counters"]
    if c.get("moe/sort_pallas", 0) != layers * forwards or \
            c.get("moe/sort", 0) or c.get("moe/einsum", 0) or \
            [k for k in c if k.startswith("moe/fallback/")]:
        raise AssertionError(f"{label}: moe counters {c}")


def phase_serve_moe(device="cuda", overrides=(), requests=None):
    """The 8x345M MoE model at full width (24 layers, hidden 1024, 8
    experts, top-2, capacity factor 1.25, ``sort_pallas``, bf16, weights
    from ``Global.seed``) behind every server mode, on the headline
    trace (32 requests on 16 slots; ``requests`` cuts it to its first
    ones): the contiguous server (16
    slots), the paged one (65-page pool), the paged speculative one, and
    the paged server with both int8 knobs (the 122-page int8 pool);
    each arm's counts zeroed just before its measured run and read just
    after (:func:`check_moe_serve_counts`: kernel 8 twice a layer and
    forward, by route; the arm's attention kernels and, under the int8
    knobs, kernel 7 at the two attention sites). Returns ``({arm:
    record}, module)``, the bf16 module for the profile."""
    hl = HEADLINE
    dec = f"Generation.max_dec_len={hl['max_dec_len']}"
    module = serving_module(device, [*MOE_KNOBS, dec, *overrides])
    cfg = module.model_config
    runs = {"contiguous": serve_trace(module, "serve_moe", device,
                                      paged=False, requests=requests,
                                      warm=4)}
    runs["paged"] = serve_trace(module, "serve_moe", device,
                                requests=requests, warm=False)
    runs["paged_spec"] = serve_trace(module, "serve_moe", device, spec=True,
                                     requests=requests, warm=False)
    rate = runs["paged_spec"]["spec_accept_rate"]
    if not 0.0 <= rate <= SPEC_ACCEPT_LIMIT:
        raise AssertionError(f"serve_moe paged_spec accepted {rate:.4f} of "
                             f"its drafts, over {SPEC_ACCEPT_LIMIT}")
    int8 = serving_module(device, [*MOE_KNOBS, *INT8_KNOBS, dec,
                                   *overrides])
    pages, _ = int8_pool_pages(cfg, hl["pool_pages"], hl["page"])
    runs["int8"] = serve_trace(int8, "serve_moe", device, pool_pages=pages,
                               requests=requests, warm=4)
    del int8
    emit({"phase": "serve_moe", "model": "MoE GPT 8x345M",
          "experts": cfg.moe_num_experts, "top_k": cfg.moe_top_k,
          "capacity_factor": cfg.moe_capacity_factor,
          "dispatch": cfg.moe_dispatch, "layers": cfg.num_layers,
          "requests": requests or hl["requests"],
          "arms": {arm: {k: r.get(k) for k in (
              "paged", "spec", "kv_cache_dtype", "quant_execution",
              "decode_tokens_per_s", "e2e_tokens_per_s", "tick_p50_ms",
              "tick_p99_ms", "ttft_p50_ms", "decode_ticks", "forwards",
              "peak_mem_gib")} | {
              "grouped_matmul": r["launches"]["grouped_matmul"],
              "grouped_matmul_routes":
              r["launches_by_route"]["grouped_matmul"]}
              for arm, r in runs.items()}})
    return runs, module


def phase_parity_moe(device="cuda", overrides=(), requests=4,
                     max_dec_len=32):
    """The 8x345M model at full width in fp32: the greedy rows served
    through kernel 8 (``sort_pallas``, its ``f32`` route) against the
    same weights under ``sort`` (``torch.bmm``, the same function),
    contiguous and paged, token for token up to a near tie
    (:func:`compare_rows`); each routing group is the server's in both,
    so the two differ only in the order of the expert GEMMs' sums."""
    import dataclasses
    from paddlefleetx_tpu_torch.core.serving import GenerationServer
    from paddlefleetx_tpu_torch.models.gpt.model import build_model
    from paddlefleetx_tpu_torch.models.gpt.modules import GPTGenerationModule
    from paddlefleetx_tpu_torch.utils.config import get_config
    hl = HEADLINE
    module = GPTGenerationModule(get_config(CONFIG, [
        "Engine.mix_precision.use_pure_fp16=False",
        "Generation.decode_strategy=greedy_search",
        f"Generation.max_dec_len={max_dec_len}", *MOE_KNOBS, *overrides]),
        device=device)
    cfg, gcfg, model = module.model_config, module.generation_cfg, \
        module.model
    if cfg.dtype != "float32" or cfg.moe_dispatch != "sort_pallas":
        raise AssertionError(f"parity_moe: {cfg.dtype} {cfg.moe_dispatch}")
    plain = build_model(dataclasses.replace(cfg, moe_dispatch="sort"),
                        model.word_embeddings.device,
                        state_dict=model.state_dict())
    prompts = headline_prompts(cfg.vocab_size, requests, hl["lo"], hl["hi"],
                               hl["seed"])
    eos = gcfg.eos_token_id
    record = {"phase": "parity_moe", "dtype": cfg.dtype,
              "requests": requests, "max_dec_len": max_dec_len,
              "prompt_lens": [len(p) for p in prompts]}
    for arm, kw in (("contiguous", {}),
                    ("paged", {"page_size": hl["page"],
                               "pool_pages": hl["pool_pages"],
                               "prefill_chunk_pages":
                               hl["prefill_chunk_pages"]})):
        rows = {}
        for name, m in (("kernel", model), ("bmm", plain)):
            server = GenerationServer(m, gcfg, num_slots=requests, **kw)
            reset_counts()
            rows[name] = [c.tokens for c in server.run(prompts)]
            counts = read_counts()
            if name == "kernel":
                check_moe_serve_counts(counts, server.summary(),
                                       cfg.num_layers, f"parity_moe_{arm}")
                record[f"{arm}_routes"] = counts["grouped_matmul_routes"]
            elif counts["grouped_matmul"] or \
                    counts["counters"].get("moe/sort_pallas", 0):
                raise AssertionError(f"parity_moe_{arm}: the sort model "
                                     f"launched kernel 8")
        mm = compare_rows(f"parity_moe_{arm}", model, prompts,
                          rows["kernel"], rows["bmm"], eos)
        record[f"{arm}_rows_equal"] = requests - len(mm)
        record[f"{arm}_near_ties"] = len(mm)
    emit(record)
    return record


# -- offline eval and predict --------------------------------------------

EVAL_CONFIG = os.path.join(ROOT, "configs", "nlp", "gpt",
                           "eval_gpt_345M_single_card.yaml")
#: kernel 8 at an MoE eval batch: 8 rows, each one routing group of
#: 1024 tokens with capacity C = ceil(2 * 1024 * 1.25 / 8) = 320, so G =
#: 8 experts x 8 rows; at 2048 choices a row every group is live
GMM_EVAL = {"G": 64, "Gw": 8, "C": 320}
#: the words of the WikiText-style stand-in, with the markup the
#: detokenizer rewrites; the recipe's ``wiki.valid.tokens`` is not in
#: the repository
EVAL_WORDS = ("the", "of", "and", "in", "to", "was", "a", "river", "valley",
              "stone", "king", "season", "album", "song", "city", "north",
              "battle", "species", "film", "church", "@-@", "@,@", "@.@",
              ",", ".", "(", ")", '"', "'s", "N", "=", ":", ";", "\n",
              "<unk>", "1998", "2011", "first", "new", "later")
#: the stand-in files, in words (about 4.2 bytes, so 4.2 tokens, each):
#: the dense eval 208 batches of 8 windows of 1024 tokens (a window every
#: 32 tokens), the last one of 4, about 8 s on the card; the MoE eval 45,
#: the last of 7, about 5 s; the parity phase's file a full first window
#: and 2 batches' worth (it scores 2)
EVAL_SIZES = {"dense": 14100, "moe": 3000, "parity": 500,
              "cloze_lines": 36, "parity_cloze_lines": 12}
#: eval_parity's limit on each batch's NLL sum through the kernels
#: against the dense path (fp32; the same products summed in another
#: order), relative
EVAL_PARITY_RTOL = 1e-5


def write_wiki_file(path, words, seed):
    """A seeded WikiText-style text of ``words`` words; returns its
    size in bytes."""
    import numpy as np
    text = " ".join(np.random.default_rng(seed).choice(
        EVAL_WORDS, words).tolist())
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    return os.path.getsize(path)


def write_lambada_file(path, lines, seed, words=(8, 40)):
    """A seeded LAMBADA-style ``.jsonl`` stand-in of ``lines`` lines of
    ``words[0]`` to ``words[1]`` words each, the last word the cloze
    target."""
    import numpy as np
    r = np.random.default_rng(seed)
    vocab = [w for w in EVAL_WORDS if w.isalnum()]
    with open(path, "w", encoding="utf-8") as f:
        for _ in range(lines):
            n = int(r.integers(words[0], words[1] + 1))
            f.write(json.dumps({"text": " ".join(r.choice(vocab, n))})
                    + "\n")
    return os.path.getsize(path)


def eval_argv(path, overrides, device, cloze=False):
    """``eval`` entry-point arguments: the 345M eval recipe on ``path``,
    plus ``overrides``."""
    argv = ["-c", EVAL_CONFIG]
    if device != "cuda":
        argv += ["--device", device]
    for o in [f"Offline_Eval.eval_path={path}",
              f"Offline_Eval.cloze_eval={cloze}", *overrides]:
        argv += ["-o", o]
    return argv


def eval_windows(path, overrides, cloze=False):
    """``(config, windows or lines, tokenize seconds)`` of the eval
    recipe on ``path``: the evaluation dataset that the entry point
    builds, built once here to count its batches and time its
    tokenizing."""
    from paddlefleetx_tpu_torch.data.dataset.gpt_dataset_eval import (
        Lambada_Eval_Dataset, LM_Eval_Dataset,
    )
    from paddlefleetx_tpu_torch.utils.config import get_config
    cfg = get_config(EVAL_CONFIG, [f"Offline_Eval.eval_path={path}",
                                   f"Offline_Eval.cloze_eval={cloze}",
                                   *overrides])
    ev = cfg.Offline_Eval
    t0 = time.perf_counter()
    if cloze:
        ds = Lambada_Eval_Dataset(path, ev.max_seq_len)
    else:
        ds = LM_Eval_Dataset(path, ev.max_seq_len, ev.overlapping_eval)
    return cfg, len(ds), time.perf_counter() - t0


def check_eval_counts(counts, batches, layers, label, moe=False,
                      route=None):
    """Kernel 1 launched once a layer and batch (all on ``route`` when
    one is given; never on ``mma``), through the no-dropout dispatch; no
    dense attention, no backward kernel, no kernel 9; with ``moe``,
    kernel 8 twice a layer and batch, every block on ``sort_pallas``
    and no ``moe/fallback``; without it, no kernel 8."""
    want = layers * batches
    c = counts["counters"]
    routes = counts["flash_attention_routes"]
    if counts["flash_attention"] != want or \
            c.get("attention/flash", 0) != want or \
            c.get("attention/flash_dropout", 0) or \
            c.get("attention/dense", 0) or \
            counts["flash_bwd_dkv"] or counts["flash_bwd_dq"] or \
            counts["grouped_matmul_dw"]:
        raise AssertionError(
            f"{label}: kernel 1 launched {counts['flash_attention']} times "
            f"(expected {want} = {layers} layers x {batches} batches), "
            f"backward {counts['flash_bwd_dkv']} / {counts['flash_bwd_dq']},"
            f" kernel 9 {counts['grouped_matmul_dw']}; counters {c}")
    check_fwd_routes(counts, label)
    if route is not None and routes.get(route, 0) != want:
        raise AssertionError(f"{label}: kernel 1 routes {routes}, expected "
                             f"all {want} on {route}")
    if moe:
        check_moe_forward_counts(counts, batches, layers, label)
    elif counts["grouped_matmul"]:
        raise AssertionError(f"{label}: a dense model launched kernel 8")


def run_eval(label, path, overrides, device, cloze=False, moe=False):
    """One run of the ``eval`` command on ``path`` (``cli.build_eval``
    and ``Engine.evaluate``, the body of ``cli.eval_main``, the engine
    kept to read its evaluation loop's time), the counts zeroed just
    before and read just after (:func:`check_eval_counts`); returns the
    phase record."""
    import math
    import torch
    from paddlefleetx_tpu_torch import cli
    cfg, n, tok_s = eval_windows(path, overrides, cloze)
    batch = int(cfg.Offline_Eval.batch_size)
    seq = int(cfg.Offline_Eval.max_seq_len)
    batches = math.ceil(n / batch)
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    engine, loader = cli.build_eval(eval_argv(path, overrides, device,
                                              cloze))
    engine.evaluate(epoch=0, valid_data_loader=loader)
    got = engine.module.metrics
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    bf16 = bool(cfg.Engine.mix_precision.use_pure_fp16)
    check_eval_counts(counts, batches, cfg.Model.num_layers, label, moe,
                      route=None if device == "cpu" else
                      "wgmma" if bf16 else "f32")
    if not all(math.isfinite(v) for v in got.values()):
        raise AssertionError(f"{label}: metrics {got}")
    eval_s = engine._time_buckets["eval"]
    record = {
        "phase": label, "metrics": got, "file_bytes": os.path.getsize(path),
        "samples": n, "batch": batch, "batches": batches,
        "last_batch": n - (batches - 1) * batch, "seq": seq,
        "layers": cfg.Model.num_layers, "hidden": cfg.Model.hidden_size,
        "dtype": "bfloat16" if bf16 else "float32", "tokenize_s": tok_s, "wall_s": wall,
        "eval_s": eval_s, "ms_per_batch": eval_s / batches * 1e3,
        "forward_tokens_per_s": n * seq / eval_s,
        "launches": {k: counts[k] for k in (
            "flash_attention", "flash_bwd_dkv", "flash_bwd_dq",
            "grouped_matmul", "grouped_matmul_dw")},
        "launches_by_route": {
            "flash_attention": counts["flash_attention_routes"],
            "grouped_matmul": counts["grouped_matmul_routes"]},
        "counters": counts["counters"]}
    if device != "cpu":
        record["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return record


def phase_kernels_eval(device="cuda", b=8, s=1024, groups=GMM_EVAL,
                       calls=GMM_SERVE_CALLS):
    """Kernel 1 at the eval batch (bf16, b8 h16 s1024 d64, causal, no
    bias, no dropout: :func:`fwd_case`, on the card only) and kernel 8
    at the MoE eval batch's fc1 and fc2 (bf16, ``groups``, every group
    live: :func:`gmm_case`), each against its plain version, launched
    twice and bit-equal, its route read from the counts and timed beside
    the other routes, its bound, the plain version and the library call
    (SDPA; ``torch.bmm`` over the same live groups). Returns ``(kernel-1
    case or None, kernel-8 cases)``."""
    import torch
    from paddlefleetx_tpu_torch.ops.cuda import flash_attention as fa
    from paddlefleetx_tpu_torch.ops.cuda import grouped_matmul as gmm
    fwd = None
    if device != "cpu":
        fwd = fwd_case(fa, torch, torch.bfloat16, b, 16, s, 64, False, 1500)
        fwd["path"] = "eval"
        emit({"phase": "kernel1_eval", **fwd})
        torch.cuda.empty_cache()
    cases = []
    for i, (call, k, n) in enumerate(calls):
        case = gmm_case(gmm, torch, torch.bfloat16, call, k, n, 1510 + i,
                        device, groups, empty=())
        case["path"] = "eval_moe"
        cases.append(case)
        emit({"phase": "kernel_gmm_eval", **case})
    return fwd, cases


def phase_eval(device="cuda", overrides=(), words=EVAL_SIZES["dense"]):
    """The dense 345M eval recipe as written (24 layers, hidden 1024,
    bf16, batch 8, ``max_seq_len`` 1024, ``overlapping_eval`` 32, weights
    from ``Global.seed``) through ``cli.eval_main`` on a seeded
    WikiText-style file of ``words`` words, counted (:func:`run_eval`);
    then the seeded model saved with ``Engine.save`` and evaluated again
    from that checkpoint under another seed, which must give the same
    metrics. Returns the record."""
    import torch
    from paddlefleetx_tpu_torch import cli
    from paddlefleetx_tpu_torch.core.engine import Engine
    from paddlefleetx_tpu_torch.models.gpt.modules import GPTEvalModule
    from paddlefleetx_tpu_torch.utils.config import get_config
    tmp = tempfile.mkdtemp(prefix="pfx_eval_")
    try:
        path = os.path.join(tmp, "wiki.valid.tokens")
        write_wiki_file(path, words, seed=41)
        record = run_eval("eval", path, overrides, device)
        got = record["metrics"]
        if not got["ppl"] > 1.0:
            raise AssertionError(f"eval: metrics {got}")
        cfg = get_config(EVAL_CONFIG, [f"Offline_Eval.eval_path={path}",
                                       *overrides])
        module = GPTEvalModule(cfg, device=device)
        engine = Engine(cfg, module, mode="eval", device=device)
        engine.output_dir = os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        engine.save(0)
        save_s = time.perf_counter() - t0
        del engine, module
        if device != "cpu":
            torch.cuda.empty_cache()
        seed = int(cfg.Global.seed) + 1
        loaded = cli.eval_main(eval_argv(path, [
            *overrides, f"Global.seed={seed}",
            "Engine.save_load.ckpt_dir=" + os.path.join(tmp, "ckpt")],
            device))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if loaded != got:
        raise AssertionError(f"eval: from the checkpoint {loaded}, the "
                             f"seeded model {got}")
    record.update(ckpt_metrics=loaded, ckpt_equal=True, ckpt_seed=seed,
                  save_s=save_s)
    emit(record)
    return record


def phase_eval_cloze(device="cuda", overrides=(),
                     lines=EVAL_SIZES["cloze_lines"], words=(8, 40)):
    """``cloze_eval: True`` on a seeded LAMBADA-style stand-in of
    ``lines`` lines through ``cli.eval_main``, counted
    (:func:`run_eval`): ``num_examples`` (the accuracy's denominator)
    equal to the line count and the accuracy in [0, 1]."""
    tmp = tempfile.mkdtemp(prefix="pfx_cloze_")
    try:
        path = os.path.join(tmp, "lambada_test.jsonl")
        write_lambada_file(path, lines, seed=43, words=words)
        record = run_eval("eval_cloze", path, overrides, device, cloze=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    got = record["metrics"]
    if record["samples"] != lines or not 0.0 <= got["acc"] <= 1.0 or \
            abs(got["acc"] * lines - got["correct"]) > 1e-9:
        raise AssertionError(f"eval_cloze: {lines} lines, {record['samples']}"
                             f" samples, metrics {got}")
    emit(record)
    return record


def phase_eval_moe(device="cuda", overrides=(), words=EVAL_SIZES["moe"]):
    """The eval recipe with ``MOE_KNOBS`` (the 8x345M model: 8 experts,
    top-2, capacity factor 1.25, ``sort_pallas``) through
    ``cli.eval_main``, counted (:func:`run_eval`: kernel 8 exactly twice
    a layer and batch on its planned routes, no ``moe/fallback``, no
    kernel 9)."""
    tmp = tempfile.mkdtemp(prefix="pfx_eval_moe_")
    try:
        path = os.path.join(tmp, "wiki.valid.tokens")
        write_wiki_file(path, words, seed=47)
        record = run_eval("eval_moe", path, [*MOE_KNOBS, *overrides],
                          device, moe=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not record["metrics"]["ppl"] > 1.0:
        raise AssertionError(f"eval_moe: metrics {record['metrics']}")
    record["model"] = "MoE GPT 8x345M"
    emit(record)
    return record


def phase_eval_profile(device="cuda", batches=4, words=600):
    """Where an eval batch's time goes: the dense 345M eval recipe and
    the 8x345M model (``MOE_KNOBS``) on a seeded WikiText-style file,
    ``batches`` batches of ``Engine.evaluate`` (each: the host's fetch
    and collate, the copy to the card, the forward and the score's
    read-back) under ``torch.profiler`` after one warm batch; kernel
    time by category, the device's idle share and kernels a batch."""
    import torch
    from paddlefleetx_tpu_torch.core.engine import Engine
    from paddlefleetx_tpu_torch.data import build_dataloader
    from paddlefleetx_tpu_torch.models.gpt.modules import GPTEvalModule
    from paddlefleetx_tpu_torch.utils.config import get_config
    tmp = tempfile.mkdtemp(prefix="pfx_eval_profile_")
    windows = []
    try:
        path = os.path.join(tmp, "wiki.valid.tokens")
        write_wiki_file(path, words, seed=61)
        for label, knobs in (("eval_batch", ()),
                             ("eval_moe_batch", MOE_KNOBS)):
            cfg = get_config(EVAL_CONFIG, [f"Offline_Eval.eval_path={path}",
                                           *knobs])
            module = GPTEvalModule(cfg, device=device)
            engine = Engine(cfg, module, mode="eval", device=device)
            loader = build_dataloader(cfg.Data, "Eval")
            engine.evaluate(0, loader, max_iters=1)
            windows.append(profile_window(
                torch, label, lambda: engine.evaluate(0, loader, batches),
                batches))
            del engine, module
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "eval_profile", "batch": int(cfg.Offline_Eval.batch_size),
          "seq": int(cfg.Offline_Eval.max_seq_len), "windows": windows})
    return windows


def _masked_top2(model, cfg, batch):
    """``(argmax, top-1 minus top-2, max |logit|)`` of the fp32 logits at
    each loss-masked position of an evaluation batch."""
    import torch
    from paddlefleetx_tpu_torch.models.gpt.model import (
        compute_context, tied_logits,
    )
    tokens, mask, _attn, pos, _labels, _info = batch
    with torch.no_grad(), compute_context(cfg, tokens.device):
        h = model.gpt(tokens, pos)
        logits = tied_logits(h[mask > 0], model.word_embeddings).float()
    top = torch.topk(logits, 2)
    return top.indices[:, 0], top.values[:, 0] - top.values[:, 1], \
        logits.abs().max(dim=-1).values


def phase_eval_parity(device="cuda", overrides=(), max_batches=2,
                      words=EVAL_SIZES["parity"],
                      lines=EVAL_SIZES["parity_cloze_lines"],
                      line_words=(8, 40), near=1e-4):
    """In fp32 at full width, each evaluation batch's score through the
    kernels against the same weights on the dense path: the dense model
    (kernel 1) against ``use_flash_attention: False``, the MoE model
    (``sort_pallas``: kernels 1 and 8) against ``sort`` with dense
    attention. WikiText: each batch's NLL sum within
    ``EVAL_PARITY_RTOL``. LAMBADA: the counts equal, and every masked
    position's argmax equal unless its top-2 gap on the kernel path is
    below ``near`` of the logit scale (a near tie, reported); the
    smallest gap is printed either way. Each path's launches are
    counted: the kernels on the first, none on the second."""
    import dataclasses
    import numpy as np
    import torch
    from paddlefleetx_tpu_torch.data import build_dataloader
    from paddlefleetx_tpu_torch.models.gpt.model import build_model
    from paddlefleetx_tpu_torch.models.gpt.modules import GPTEvalModule
    from paddlefleetx_tpu_torch.utils.config import get_config
    tmp = tempfile.mkdtemp(prefix="pfx_eval_parity_")
    record = {"phase": "eval_parity", "dtype": "float32",
              "rtol": EVAL_PARITY_RTOL, "near_tie": near, "arms": {}}
    try:
        wiki = os.path.join(tmp, "wiki.valid.tokens")
        lam = os.path.join(tmp, "lambada_test.jsonl")
        write_wiki_file(wiki, words, seed=53)
        write_lambada_file(lam, lines, seed=59, words=line_words)
        for arm, knobs, plain_over in (
                ("dense", (), {"use_flash_attention": False}),
                ("moe", MOE_KNOBS, {"use_flash_attention": False,
                                    "moe_dispatch": "sort"})):
            for cloze, path in ((False, wiki), (True, lam)):
                cfg = get_config(EVAL_CONFIG, [
                    f"Offline_Eval.eval_path={path}",
                    f"Offline_Eval.cloze_eval={cloze}",
                    "Engine.mix_precision.use_pure_fp16=False", *knobs,
                    *overrides])
                module = GPTEvalModule(cfg, device=device)
                mcfg = module.model_config
                plain = build_model(dataclasses.replace(mcfg, **plain_over),
                                    module.device,
                                    state_dict=module.model.state_dict(),
                                    train=True).eval()
                module.model.eval()
                rec = {"batches": 0, "scores": [], "plain_scores": [],
                       "max_rel_diff": 0.0, "mismatches": [],
                       "min_top2_gap": None, "masked_positions": 0}
                for i, batch in enumerate(build_dataloader(cfg.Data,
                                                           "Eval")):
                    if i >= max_batches:
                        break
                    module.pretreating_batch(batch)
                    dev = tuple(torch.from_numpy(np.asarray(x)).to(
                        module.device) for x in batch)
                    runs = {}
                    for name, m in (("kernel", module.model),
                                    ("plain", plain)):
                        reset_counts()
                        with torch.no_grad():
                            runs[name] = float(module.loss_fn(m, dev, 0))
                        runs[name + "_counts"] = read_counts()
                    check_eval_counts(runs["kernel_counts"], 1,
                                      mcfg.num_layers, f"eval_parity_{arm}",
                                      moe=bool(knobs), route=None if
                                      device == "cpu" else "f32")
                    pc = runs["plain_counts"]
                    if pc["flash_attention"] or pc["grouped_matmul"] or \
                            pc["counters"].get("moe/sort_pallas", 0):
                        raise AssertionError(f"eval_parity_{arm}: the plain "
                                             f"path launched a kernel")
                    rec["batches"] += 1
                    rec["scores"].append(runs["kernel"])
                    rec["plain_scores"].append(runs["plain"])
                    if not cloze:
                        rel = abs(runs["kernel"] - runs["plain"]) / \
                            abs(runs["plain"])
                        rec["max_rel_diff"] = max(rec["max_rel_diff"], rel)
                        continue
                    got, gap, scale = _masked_top2(module.model, mcfg, dev)
                    want, _, _ = _masked_top2(plain, mcfg, dev)
                    rec["masked_positions"] += int(got.numel())
                    low = float(gap.min())
                    rec["min_top2_gap"] = low if rec["min_top2_gap"] is \
                        None else min(rec["min_top2_gap"], low)
                    for j in torch.nonzero(got != want).flatten().tolist():
                        tie = {"batch": i, "position": j,
                               "top2_gap": float(gap[j]),
                               "logit_scale": float(scale[j])}
                        rec["mismatches"].append(tie)
                        if tie["top2_gap"] >= near * tie["logit_scale"]:
                            raise AssertionError(
                                f"eval_parity_{arm}: cloze argmax differs "
                                f"at {tie}, no near tie")
                key = f"{arm}_{'cloze' if cloze else 'lm'}"
                record["arms"][key] = rec
                if not cloze and rec["max_rel_diff"] > EVAL_PARITY_RTOL:
                    raise AssertionError(
                        f"eval_parity_{key}: NLL sums {rec['scores']} vs "
                        f"{rec['plain_scores']} (rel {rec['max_rel_diff']:.2e}"
                        f" > {EVAL_PARITY_RTOL:.0e})")
                if cloze and not rec["mismatches"] and \
                        rec["scores"] != rec["plain_scores"]:
                    raise AssertionError(f"eval_parity_{key}: counts "
                                         f"{rec['scores']} vs "
                                         f"{rec['plain_scores']}")
                if rec["batches"] < 1:
                    raise AssertionError(f"eval_parity_{key}: no batch")
                del module, plain
                if device != "cpu":
                    torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit(record)
    return record


def phase_predict(device="cuda", overrides=(), iters=4):
    """``Engine.predict`` with ``Engine.test_iters`` = ``iters`` on the
    345M pretraining recipe (bf16, weights from ``Global.seed``) over
    ``write_train_corpus``'s held-out split, the recipe's ``Eval``
    section (the recipe has no ``Test`` section, and a ``GPTDataset`` in
    ``Test`` mode yields ``[tokens, position_ids]``, which the default
    ``predict_step``, the eval-mode loss as in the JAX package, cannot
    score), the counts zeroed just before and read just after:
    ``iters`` finite losses and kernel 1 once a layer and batch."""
    import math
    import torch
    from paddlefleetx_tpu_torch.core.engine import Engine
    from paddlefleetx_tpu_torch.data import build_dataloader
    from paddlefleetx_tpu_torch.models.gpt.modules import GPTModule
    from paddlefleetx_tpu_torch.utils.config import get_config
    tmp = tempfile.mkdtemp(prefix="pfx_predict_")
    try:
        data = os.path.join(tmp, "data")
        over = [f"Engine.test_iters={iters}", "Engine.max_steps=4",
                "Engine.eval_freq=1000000", f"Engine.eval_iters={iters}",
                *overrides]
        write_train_corpus(data, over, 4)
        cfg = get_config(TRAIN_CONFIG, over + [
            f"Data.{m}.dataset.input_dir={data}" for m in ("Train", "Eval")])
        module = GPTModule(cfg, device=device)
        engine = Engine(cfg, module, mode="eval", device=device)
        loader = build_dataloader(cfg.Data, "Eval")
        if device != "cpu":
            torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        outs = engine.predict(0, loader)
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    losses = [float(o) for o in outs]
    layers = module.model_config.num_layers
    if engine.test_iters != iters or len(losses) != iters or \
            not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"predict: test_iters {engine.test_iters}, "
                             f"outputs {losses}")
    check_eval_counts(counts, iters, layers, "predict",
                      route=None if device == "cpu" else "wgmma")
    record = {"phase": "predict", "test_iters": iters, "losses": losses,
              "batch": cfg.Global.global_batch_size,
              "seq": cfg.Data.Eval.dataset.max_seq_len, "layers": layers,
              "dtype": module.model_config.dtype, "wall_s": wall,
              "ms_per_batch": wall / iters * 1e3,
              "launches": {k: counts[k] for k in (
                  "flash_attention", "flash_bwd_dkv", "flash_bwd_dq")},
              "launches_by_route": {
                  "flash_attention": counts["flash_attention_routes"]},
              "counters": counts["counters"]}
    emit(record)
    return record


# -- LoRA: kernel 7's dx route, kernel 8 at the bank shapes, serving ----

#: M of kernel 7's dx route: a 16-row batch and the gradient phase's 4 x
#: 1024 tokens
QMM_DX_ROWS = (16, 4096)


def _qmm_dx_bound(m, k, n, itemsize):
    """(bound_ms, bound_by) of one dx call ``gs [M, N] @ w [N, K]``:
    gs, the int8 weight and dx moved once over HBM, against 2 M N K
    FLOPs over the peak for gs's type."""
    nbytes = m * n * itemsize + n * k + m * k * itemsize
    flops = 2.0 * m * k * n
    peak = BF16_TENSOR_FLOPS if itemsize == 2 else FP32_CUDA_CORE_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def qmm_dx_case(qmm, torch, dtype, site, m, k, n, seed, device="cuda"):
    """Kernel 7's dx route at a dense site (forward ``[M, K] @ w [N,
    K]^T``): ``dx = gs [M, N] @ w [N, K]`` against its plain version
    (fp32, the same inputs) by max abs error and per 64 x 64 output tile
    normwise, with a planted fault; the call counts one dx launch and no
    forward launch, on the planned route, and a second launch is
    bit-equal. Timed with its plain version, every other route that
    takes the shape (``mma`` the first design) and the library yardstick
    ``torch.matmul(gs, w.to(dtype))`` (the weight widened beforehand),
    over input sets whose weights exceed the L2 cache at small M. On the
    CPU the wrapper runs its plain version and nothing is timed."""
    import math
    g = torch.Generator(device=device).manual_seed(seed)
    n_sets = 1 if device == "cpu" or m > 256 else \
        max(4, math.ceil(QMM_COLD_BYTES / (k * n)))
    # int8 uniform in [-127, 127] has std 73.6: dx of std ~0.5
    unit = 0.5 / (73.6 * n ** 0.5)
    sets = []
    for _ in range(n_sets):
        gs = (torch.randn((m, n), generator=g, device=device) * unit).to(
            dtype)
        w = torch.randint(-127, 128, (n, k), generator=g, device=device,
                          dtype=torch.int8)
        sets.append((gs, w))
    gs, w = sets[0]
    name = _dtype_name(dtype)
    tol = TOL_QMM[name]
    what = f"quantized_matmul_dx ({name}, {site}, M={m}, K={k}, N={n})"
    before = (qmm.quantized_matmul.launches, qmm.quantized_matmul.dx_launches)
    out, route, planned = _qmm_held(
        qmm, torch, "dx", dtype, m, k, n,
        lambda: qmm.quantized_matmul_dx(gs, w), what, device)
    if device != "cpu" and (qmm.quantized_matmul.launches,
                            qmm.quantized_matmul.dx_launches) != \
            (before[0], before[1] + 2):
        raise AssertionError("quantized_matmul_dx: a call did not count "
                             "one dx launch and no forward launch")
    ref = qmm.quantized_matmul_dx_reference(gs.float(), w)
    err = _max_err(out, ref)
    if out.shape != (m, k) or out.dtype != dtype or \
            not torch.isfinite(out.float()).all() or err > tol:
        raise AssertionError(f"{what} disagrees with its plain version: "
                             f"max abs err {err:.3e} > {tol:.0e}")
    rel_l2, planted = _hold_tiles(out, ref, what)
    ms = call_ms = plain_ms = library_ms = routes_ms = clusters = None
    if device != "cpu":
        ms, call_ms = time_ms(lambda i: qmm.quantized_matmul_dx(*sets[i]),
                              n_sets)
        routes_ms, clusters = _qmm_routes_ms(
            qmm, torch, "dx", m, k, n, dtype,
            lambda i, r: qmm.quantized_matmul_dx(*sets[i], route=r), n_sets)
        plain_ms, _ = time_ms(lambda i: qmm.quantized_matmul_dx_reference(
            *sets[i]), n_sets, iters=5)
        wide = [(a, b.to(dtype)) for a, b in sets]
        library_ms, _ = time_ms(lambda i: torch.matmul(*wide[i]), n_sets)
        del wide
    bound_ms, bound_by = _qmm_dx_bound(m, k, n, gs.element_size())
    return {"dtype": name, "site": site, "M": m, "K": k, "N": n,
            "route": route, "splits": planned.splits,
            "max_active_clusters": clusters, "bit_equal_rerun": True,
            "max_abs_err": err, "tol": tol, "rel_l2": rel_l2,
            "rel_l2_planted": planted, "ms": ms, "call_ms": call_ms,
            "ms_routes": routes_ms,
            "ms_mma": (routes_ms or {}).get("mma"),
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_computes": "torch.matmul(gs, w.to(dtype)) on the "
            "weight widened beforehand (cuBLAS)", "bound_ms": bound_ms,
            "bound_by": bound_by, "weight_sets": n_sets}


def phase_kernel_qmm_dx(device="cuda", rows=QMM_DX_ROWS, sites=QMM_SITES):
    """Kernel 7's dx route at the four 345M site shapes x ``rows``, bf16
    and fp32; returns the cases, led by the gradient phase's (bf16,
    M 4096, qkv)."""
    import torch
    from paddlefleetx_tpu_torch.ops.cuda import quantized_matmul as qmm
    cases = []
    seed = 1200
    for dtype in (torch.bfloat16, torch.float32):
        for m in sorted(rows, reverse=True):
            for site, k, n in sites:
                cases.append(qmm_dx_case(qmm, torch, dtype, site, m, k, n,
                                         seed, device))
                seed += 1
                if device != "cpu":
                    torch.cuda.empty_cache()
    for c in cases:
        emit({"phase": "kernel_qmm_dx", **c})
    return cases


#: the LoRA knobs of this slice: rank 8 (the JAX bench's default) and 5
#: bank rows (row 0 the base model, 4 live adapters)
LORA_KNOBS = ("Model.lora_rank=8", "Model.lora_num_adapters=5")
#: C of the grouped buffer: a 16-slot decode tick, and the gradient
#: phase's 4 x 1024 rows (C = M rounded up to 8)
LORA_C = (16, 4096)
#: the bank group the kernel cases leave empty
LORA_EMPTY = (2,)
#: the banks' rank (``LORA_KNOBS``)
LORA_RANK = 8
#: ``(call, K, N, C)`` where the split route's clusters do not divide
#: the reduction evenly: ``x @ A`` at K 4104 (C 16) and the ``lora_a``
#: dw at C 4000
LORA_EDGE = (("edge_down", 4104, LORA_RANK, 16),
             ("edge_down_dw", 1024, LORA_RANK, 4000))
#: requests of ``serve_lora``'s warm run
LORA_WARM = 4


def lora_calls(sites=QMM_SITES, r=LORA_RANK):
    """``(call, K, N)`` of kernel 8 at every site's bank pair: ``x @ A``
    (``[5, C, K] @ [5, K, r]``) and ``(xA) @ B`` (``[5, C, r] @ [5, r,
    N]``); the banks' dw are the same calls with ``_dw``."""
    calls = []
    for site, k, n in sites:
        calls += [(f"{site}_down", k, r), (f"{site}_up", r, n)]
    return calls


def lora_source(model, seed, std=0.02):
    """Adapter id -> a canonical tree shaped like ``model``'s banks,
    ``normal(0, std)`` from ``numpy.random.default_rng(seed + id)``
    (fp32, cast to the bank's dtype on insert)."""
    import numpy as np
    from paddlefleetx_tpu_torch.core.adapters import extract_adapter
    shapes = {k: tuple(v.shape) for k, v in
              extract_adapter(model, 0).items()}

    def source(aid):
        rng = np.random.default_rng(seed + int(aid))
        return {k: rng.normal(0.0, std, s).astype(np.float32)
                for k, s in shapes.items()}
    return source


def phase_kernel_gmm_lora(device="cuda", cs=LORA_C, calls=None, bank=5,
                          edges=LORA_EDGE):
    """Kernel 8 at the LoRA bank shapes (``bank`` groups, rank 8, every
    site's ``x @ A`` and ``(xA) @ B``, C 16 and 4096, group 2 empty) in
    bf16 (fp32 at C 16 for the qkv pair), kernel 9 at the banks' dw
    (C 4096) and both at ``edges`` (a reduction the split route's
    clusters do not divide evenly), against their plain versions
    (:func:`gmm_case`), timed
    beside ``torch.bmm`` on the same buffer; then each site's whole
    grouped delta (``ops/lora.py``: sort, scatter, two kernel-8 calls,
    gather) beside the gather-einsum form on the same rows and banks.
    Returns ``(cases, deltas)``, led by the decode tick's bf16 qkv
    ``x @ A``."""
    import torch
    from paddlefleetx_tpu_torch.ops import lora
    from paddlefleetx_tpu_torch.ops.cuda import grouped_matmul as gmm
    calls = calls or lora_calls()
    cases = []
    seed = 1300
    for c in sorted(cs):
        groups = {"G": bank, "Gw": bank, "C": c}
        todo = [(torch.bfloat16, call) for call in calls]
        if c == max(cs):
            todo += [(torch.bfloat16, (f"{call}_dw", k, n))
                     for call, k, n in calls]
        else:
            todo += [(torch.float32, call) for call in calls[:2]]
        for dtype, (call, k, n) in todo:
            cases.append(gmm_case(gmm, torch, dtype, call, k, n, seed,
                                  device, groups, LORA_EMPTY))
            cases[-1]["lora"] = True
            seed += 1
            if device != "cpu":
                torch.cuda.empty_cache()
    for call, k, n, c in edges:
        cases.append(gmm_case(gmm, torch, torch.bfloat16, call, k, n, seed,
                              device, {"G": bank, "Gw": bank, "C": c},
                              LORA_EMPTY))
        cases[-1]["lora"] = True
        seed += 1
    for case in cases:
        emit({"phase": "kernel_gmm_lora", **case})
    deltas = []
    g = torch.Generator(device=device).manual_seed(seed)
    for c in sorted(cs):
        for site, k, n in QMM_SITES:
            x = torch.randn((c, k), generator=g, device=device).to(
                torch.bfloat16)
            ids = torch.randint(0, bank, (c,), generator=g, device=device)
            ids[ids == LORA_EMPTY[0]] = 0
            a = (torch.randn((bank, k, LORA_RANK), generator=g,
                             device=device) * k ** -0.5).to(torch.bfloat16)
            b = (torch.randn((bank, LORA_RANK, n), generator=g,
                             device=device) * 0.1).to(torch.bfloat16)
            out = lora.grouped_lora_delta(x, ids, a, b)
            ref = lora.fallback_lora_delta(x.float(), ids, a.float(),
                                           b.float())
            err = _max_err(out, ref)
            if err > TOL_GMM["bfloat16"]:
                raise AssertionError(f"grouped_lora_delta ({site}, C={c}) "
                                     f"disagrees with the gather-einsum "
                                     f"form: {err:.3e}")
            rec = {"site": site, "C": c, "K": k, "N": n, "rank": LORA_RANK,
                   "bank": bank, "max_abs_err": err, "pair_ms": None,
                   "gather_einsum_ms": None}
            if device != "cpu":
                rec["pair_ms"] = time_ms(lambda i: lora.grouped_lora_delta(
                    x, ids, a, b), 1)[0]
                rec["gather_einsum_ms"] = time_ms(
                    lambda i: lora.fallback_lora_delta(x, ids, a, b), 1)[0]
            deltas.append(rec)
            emit({"phase": "kernel_gmm_lora_delta", **rec})
    return cases, deltas


def check_lora_counts(counts, layers, forwards, label, dtype="bfloat16"):
    """With adapter ids every forward ran the grouped delta at the four
    sites of every layer (``lora/grouped``), each two kernel-8 launches
    (in bf16 ``x @ A`` on the split route and ``(xA) @ B``, a reduction
    of r = 8, on the mma route; in fp32 both on the fp32 kernel), and
    the gather-einsum form never ran."""
    c = counts["counters"]
    want = 4 * layers * forwards
    by_route = counts["grouped_matmul_routes"]
    routes = {"split": want, "mma": want} if dtype == "bfloat16" else \
        {"f32": 2 * want}
    if not c.get("lora/grouped", 0) == want > 0 or \
            counts["grouped_matmul"] != 2 * want or \
            c.get("lora/fallback", 0) or \
            {r: n for r, n in by_route.items() if n} != routes:
        raise AssertionError(
            f"{label}: lora/grouped {c.get('lora/grouped')}, kernel 8 "
            f"launched {counts['grouped_matmul']} (by route {by_route}), "
            f"lora/fallback {c.get('lora/fallback', 0)}; expected {want} "
            f"(4 sites x {layers} layers x {forwards} forwards) and "
            f"{2 * want}, by route {routes}")


def phase_serve_lora(device="cuda", overrides=(), requests=None):
    """The main path of the slice: GPT-345M with ``lora_rank`` 8 and 5
    bank rows serving the headline trace through the paged server
    (:func:`serve_trace`), as the JAX bench's A/B does: every request on
    adapter 0, then ids ``(i % 4) + 1`` with adapters ``normal(0,
    0.02)`` seeded by ``Global.seed + id``, the counts zeroed just before
    each measured run (:func:`check_lora_counts`). The id-0 arm must be
    token-exact with the same trace on the same base weights with
    ``lora_rank`` 0, and the mixed arm must differ from it somewhere.
    Returns ``(record, module)``."""
    import dataclasses
    import torch
    hl = HEADLINE
    module = serving_module(device, [
        *LORA_KNOBS, f"Generation.max_dec_len={hl['max_dec_len']}",
        *overrides])
    cfg = module.model_config
    source = lora_source(module.model, module.seed)
    kw = {"requests": requests} if requests else {}
    # a short warm run (every code path, the decode tick's shapes): a
    # LoRA tick is host-bound, and a whole warm trace would cost as much
    # as a measured arm; the mixed arm follows the id-0 arm warm
    base_arm = serve_trace(module, "serve_lora_id0", device,
                           adapters=(source, [0]), warm=LORA_WARM, **kw)
    mixed = serve_trace(module, "serve_lora_mixed", device,
                        adapters=(source, [1, 2, 3, 4]), warm=False, **kw)
    base_sd = {k: v for k, v in module.model.state_dict().items()
               if "_lora." not in k}
    plain = serving_module(device, [
        f"Generation.max_dec_len={hl['max_dec_len']}", *overrides],
        state_dict=base_sd)
    del base_sd
    if dataclasses.replace(cfg, lora_rank=0, lora_num_adapters=0) != \
            plain.model_config:
        raise AssertionError("serve_lora: the rank-0 twin's config differs")
    rank0 = serve_trace(plain, "serve_lora_rank0", device, warm=False, **kw)
    del plain
    if device != "cpu":
        torch.cuda.empty_cache()
    if base_arm["tokens"] != rank0["tokens"]:
        raise AssertionError("serve_lora: the id-0 arm is not token-exact "
                             "with the rank-0 model on the same base "
                             "weights")
    differ = sum(a != b for a, b in zip(mixed["tokens"], base_arm["tokens"]))
    if not differ:
        raise AssertionError("serve_lora: no request of the mixed arm "
                             "differs from the id-0 arm")
    record = {"phase": "serve_lora", "lora_rank": cfg.lora_rank,
              "bank_rows": cfg.lora_num_adapters, "adapter_std": 0.02,
              "id0_token_exact_with_rank0": True,
              "mixed_requests_differing": differ,
              "adapter_slowdown": base_arm["decode_tokens_per_s"] /
              mixed["decode_tokens_per_s"]}
    for name, arm in (("id0", base_arm), ("mixed", mixed), ("rank0", rank0)):
        for key in ("decode_tokens_per_s", "e2e_tokens_per_s",
                    "tick_p50_ms", "tick_p99_ms", "ttft_p50_ms",
                    "ttft_p99_ms", "decode_ticks", "forwards"):
            record[f"{key}_{name}"] = arm.get(key)
        if name != "rank0":
            c = arm["counters"]
            record[f"lora_grouped_{name}"] = c.get("lora/grouped", 0)
            record[f"lora_fallback_{name}"] = c.get("lora/fallback", 0)
            record[f"kernel8_launches_{name}"] = \
                arm["launches"]["grouped_matmul"]
            record[f"kernel8_per_tick_{name}"] = \
                arm["launches"]["grouped_matmul"] / arm["forwards"]
            record[f"kernel8_by_route_{name}"] = \
                arm["launches_by_route"]["grouped_matmul"]
            for key in ("adapter_rows", "adapters_resident", "adapter_hits",
                        "adapter_misses", "adapter_evictions"):
                record[f"{key}_{name}"] = arm.get(key)
    emit(record)
    record["arms"] = {"id0": base_arm, "mixed": mixed}
    return record, module


def phase_profile_lora(module, ticks=16):
    """Where a mixed-adapter paged tick's time goes: the headline server
    with ``adapter_source`` fed its first 16 prompts on ids ``(i % 4) +
    1``, stepped until every slot decodes, then ``ticks`` steps under
    ``torch.profiler`` (kernel time by category, idle share)."""
    import torch
    from paddlefleetx_tpu_torch.core.serving import GenerationServer
    hl = HEADLINE
    cfg = module.model_config
    prompts = headline_prompts(cfg.vocab_size, hl["requests"], hl["lo"],
                               hl["hi"], hl["seed"])[:hl["slots"]]
    server = GenerationServer(
        module.model, module.generation_cfg, num_slots=hl["slots"],
        seed=module.seed, page_size=hl["page"], pool_pages=hl["pool_pages"],
        prefill_chunk_pages=hl["prefill_chunk_pages"],
        adapter_source=lora_source(module.model, module.seed))
    for i, p in enumerate(prompts):
        server.submit(p, adapter_id=i % 4 + 1)
    while server.pending or server._prefilling:
        server.step()

    def run():
        for _ in range(ticks):
            server.step()
    window = profile_window(torch, "decode_paged_lora", run, ticks)
    window["occupancy"] = server.occupancy
    emit({"phase": "profile_lora", "slots": hl["slots"],
          "windows": [window]})
    return window


#: the short arms of ``serve_lora_int8``
LORA_INT8_SHORT = {"requests": 8, "max_dec_len": 32}


def phase_serve_lora_int8(device="cuda", overrides=(),
                          short=LORA_INT8_SHORT):
    """``quant_execution: weight_only_int8`` and LoRA together, mixed
    adapters on ``short`` arms: contiguous speculative (kernel 5), paged
    (6a) and paged speculative (6b), each with kernel 7 at every dense
    site and kernel 8 at every bank (:func:`check_int8_counts`,
    :func:`check_lora_counts`). Returns the records by arm."""
    hl = HEADLINE
    module = serving_module(device, [
        INT8_KNOBS[1], *LORA_KNOBS,
        f"Generation.max_dec_len={hl['max_dec_len']}", *overrides])
    adapters = (lora_source(module.model, module.seed), [1, 2, 3, 4, 0])
    runs = {
        "contiguous_spec": serve_trace(
            module, "serve_lora_int8", device, spec=True, paged=False,
            slots=hl["contiguous_spec_slots"], adapters=adapters, **short),
        "paged": serve_trace(module, "serve_lora_int8", device,
                             adapters=adapters, **short),
        "paged_spec": serve_trace(module, "serve_lora_int8", device,
                                  spec=True, adapters=adapters, **short)}
    del module
    return runs


def phase_parity_lora(device="cuda", overrides=(), requests=6,
                      max_dec_len=24, hi=200):
    """Mixed-adapter greedy serving at full width cut to 2 layers: the
    paged server on the card against the same server on a CPU copy of
    the model (plain versions everywhere), token for token in fp32 (a
    mismatch only at a true near-tie); in bf16 each row's first
    divergence must sit at a near-tie of the bf16 logits (2e-2 of their
    scale). Then, in fp32, a bank of 3 usable rows for 4 adapters
    evicts and completes every request with the tokens of a bank that
    holds them all."""
    import dataclasses
    import torch
    from paddlefleetx_tpu_torch.core.serving import GenerationServer
    from paddlefleetx_tpu_torch.models.gpt.model import build_model
    hl = HEADLINE
    ids = [i % 4 + 1 if i % 3 else 0 for i in range(requests)]
    paged = dict(page_size=hl["page"],
                 prefill_chunk_pages=hl["prefill_chunk_pages"])
    records = []
    for dtype_over in (["Engine.mix_precision.use_pure_fp16=False"], []):
        module = serving_module(device, [
            *dtype_over, *LORA_KNOBS, "Model.num_layers=2",
            "Generation.decode_strategy=greedy_search",
            f"Generation.max_dec_len={max_dec_len}", *overrides])
        cfg, gcfg, model = module.model_config, module.generation_cfg, \
            module.model
        prompts = headline_prompts(cfg.vocab_size, requests, hl["lo"], hi,
                                   41)
        source = lora_source(model, module.seed, std=0.05)
        eos = gcfg.eos_token_id
        srv = GenerationServer(model, gcfg, num_slots=4,
                               adapter_source=source, **paged)
        reset_counts()
        got = [c.tokens for c in srv.run(prompts, ids)]
        counts = read_counts()
        check_lora_counts(counts, cfg.num_layers,
                          server_forwards(srv.summary()), "parity_lora",
                          cfg.dtype)
        cpu = build_model(cfg, torch.device("cpu"), state_dict={
            k: v.cpu() for k, v in model.state_dict().items()})
        want = [c.tokens for c in GenerationServer(
            cpu, gcfg, num_slots=4, adapter_source=source, **paged).run(
                prompts, ids)]
        del cpu
        record = {"phase": "parity_lora", "dtype": cfg.dtype,
                  "layers": cfg.num_layers, "requests": requests,
                  "adapter_ids": ids, "max_dec_len": max_dec_len,
                  "rows_equal": _first_divergence(got, want, eos)[0],
                  "first_divergence": _first_divergence(got, want, eos)[1]}
        # each request's bank row on the card (no eviction in this run)
        rows = [srv._adapters._rows[a] if a else 0 for a in ids]
        near = 1e-4 if cfg.dtype == "float32" else TOL["bfloat16"]
        record["near_ties"] = len(compare_rows(
            f"parity_lora_{cfg.dtype}", model, prompts, got, want, eos,
            rows, near))
        if cfg.dtype == "float32":
            base = {k: v for k, v in model.state_dict().items()
                    if "_lora." not in k}
            out = {}
            for name, bank in (("pressure", 4), ("roomy", 5)):
                m = build_model(dataclasses.replace(
                    cfg, lora_num_adapters=bank), torch.device(device))
                m.load_state_dict(base, strict=False)
                s = GenerationServer(m, gcfg, num_slots=2,
                                     adapter_source=source, **paged)
                comps = s.run(prompts, [i % 4 + 1 for i in range(requests)])
                out[name] = ([c.tokens for c in comps], s.summary(),
                             [c.finish_reason for c in comps])
                s._adapters.check()
                del m, s
            ev = out["pressure"][1]["adapter_evictions"]
            record.update(eviction_adapters=4, eviction_rows=3,
                          evictions=ev,
                          eviction_tokens_equal=out["pressure"][0] ==
                          out["roomy"][0])
            if ev == 0 or not record["eviction_tokens_equal"] or \
                    not set(out["pressure"][2]) <= {"eos", "length"}:
                emit(record)
                raise AssertionError(f"parity_lora: the eviction run "
                                     f"({ev} evictions) does not hold")
        emit(record)
        records.append(record)
        del module, model, srv
        if device != "cpu":
            torch.cuda.empty_cache()
    return records


#: the gradient phase's limits against the CPU copy (plain versions):
#: loss relative and each floating leaf normwise; fp32 sums in another
#: order, bf16 on the card against the fp32 copy of the same weights
GRAD_LORA_TOL = {"float32": {"loss_rel": 1e-5, "grad_leaf_rel": 1e-4},
                 "bfloat16": {"loss_rel": 5e-3, "grad_leaf_rel": 5e-2}}
#: per layer of one forward and backward with adapter ids over an int8
#: base: kernel 7 forward and dx at the four sites, kernel 8 four times a
#: site (two bank GEMMs and their dx), kernel 9 twice a site, and the
#: attention kernels once each
GRAD_LORA_PER_LAYER = {"quantized_matmul": 4, "quantized_matmul_dx": 4,
                       "grouped_matmul": 16, "grouped_matmul_dw": 8,
                       "flash_attention": 1, "flash_bwd_dkv": 1,
                       "flash_bwd_dq": 1}


def _grad_lora_batch(vocab, batch, seq, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (batch, seq + 1))
    return tokens[:, :-1], tokens[:, 1:]


def _lora_loss_and_grads(model, ids, labels, rows):
    """The mean LM loss of ``model`` on ``ids`` through bank rows
    ``rows`` and every parameter's gradient, left zeroed."""
    import torch
    from paddlefleetx_tpu_torch.models.gpt.model import cross_entropy_loss
    dev = model.word_embeddings.device
    ids, labels = (torch.as_tensor(t, device=dev) for t in (ids, labels))
    logits = model(ids, adapter_ids=torch.as_tensor(rows, device=dev))
    loss = cross_entropy_loss(logits, labels,
                              torch.ones(labels.shape, device=dev))
    loss.backward()
    grads = {n: p.grad.detach().float().clone()
             for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def _int8_lora_module(device, overrides):
    """A serving module under ``quant_execution: weight_only_int8`` with
    the LoRA knobs, bank rows 1..4 filled with adapters ``normal(0,
    0.05)``, and without the recipe's ``use_recompute``: kernel 7 is no
    dispatched op, so ``save_dots`` cannot keep its output and a
    recompute would launch it again in the backward."""
    from paddlefleetx_tpu_torch.core.adapters import insert_adapter
    module = serving_module(device, [INT8_KNOBS[1], *LORA_KNOBS,
                                     "Model.use_recompute=False", *overrides])
    source = lora_source(module.model, module.seed, std=0.05)
    for row in range(1, module.model_config.lora_num_adapters):
        insert_adapter(module.model, source(row), row)
    return module


def phase_grad_int8_lora(device="cuda", overrides=(), batch=2, seq=256,
                         full=(4, 1024), data_seed=61):
    """The gradient over an int8 base with mixed adapter ids, what
    ``jax.grad`` over the floating leaves gives in the JAX package: at
    full width cut to 2 layers, fp32 and bf16, ``batch x seq`` tokens,
    the loss and the gradient of every floating leaf (banks, biases,
    norms, embeddings) on the card (kernels 1, 3, 4, 7, 7's dx route, 8,
    9; :data:`GRAD_LORA_PER_LAYER`) against a CPU copy (plain versions,
    fp32), within :data:`GRAD_LORA_TOL`; then at full depth, bf16, one
    forward and backward at ``full`` tokens, timed, with its launches
    counted from zero. Returns the record."""
    import dataclasses
    import torch
    from paddlefleetx_tpu_torch.models.gpt.model import build_model
    record = {"phase": "grad_int8_lora", "batch": batch, "seq": seq,
              "tol": GRAD_LORA_TOL}
    for name, dtype_over in (("float32",
                              ["Engine.mix_precision.use_pure_fp16=False"]),
                             ("bfloat16", [])):
        module = _int8_lora_module(device, [*dtype_over, "Model.num_layers=2",
                                            *overrides])
        cfg, model = module.model_config, module.model
        ids, labels = _grad_lora_batch(cfg.vocab_size, batch, seq, data_seed)
        rows = [i % (cfg.lora_num_adapters - 1) + 1 for i in range(batch)]
        if device != "cpu":
            torch.cuda.synchronize()
        reset_counts()
        loss, grads = _lora_loss_and_grads(model, ids, labels, rows)
        if device != "cpu":
            torch.cuda.synchronize()
        counts = read_counts()
        want = {k: v * cfg.num_layers for k, v in GRAD_LORA_PER_LAYER.items()}
        got = {k: counts[k] for k in want}
        if got != want:
            raise AssertionError(f"grad_int8_lora: {name} launched {got}, "
                                 f"expected {want}")
        for dx in (False, True):
            check_qmm_routes(counts, f"grad_int8_lora {name}", dx)
        cpu = build_model(dataclasses.replace(cfg, dtype="float32"),
                          torch.device("cpu"), state_dict={
                              k: (v.float() if v.is_floating_point()
                                  else v).cpu()
                              for k, v in model.state_dict().items()})
        ref_loss, ref = _lora_loss_and_grads(cpu, ids, labels, rows)
        del cpu
        leaf, leaf_rel = _leaf_diff({k: v.cpu() for k, v in grads.items()},
                                    ref)
        loss_rel = abs(loss - ref_loss) / abs(ref_loss)
        tol = GRAD_LORA_TOL[name]
        record[name] = {"loss": loss, "loss_cpu": ref_loss,
                        "loss_rel_diff": loss_rel, "worst_leaf": leaf,
                        "worst_leaf_rel_diff": leaf_rel, "leaves": len(ref),
                        "launches": got,
                        "launches_by_route": routes_by_kernel(counts)}
        if not loss == loss or loss_rel > tol["loss_rel"] or \
                leaf_rel > tol["grad_leaf_rel"]:
            emit(record)
            raise AssertionError(f"grad_int8_lora: {name} loss rel diff "
                                 f"{loss_rel:.2e}, worst leaf {leaf} "
                                 f"{leaf_rel:.2e} (tol {tol})")
        del module, model, grads, ref
        if device != "cpu":
            torch.cuda.empty_cache()
    module = _int8_lora_module(device, overrides)
    cfg, model = module.model_config, module.model
    b, s = full
    ids, labels = _grad_lora_batch(cfg.vocab_size, b, s, data_seed + 1)
    rows = [i % (cfg.lora_num_adapters - 1) + 1 for i in range(b)]
    _lora_loss_and_grads(model, ids, labels, rows)          # warm
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    loss, grads = _lora_loss_and_grads(model, ids, labels, rows)
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    want = {k: v * cfg.num_layers for k, v in GRAD_LORA_PER_LAYER.items()}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"grad_int8_lora: full-depth pass launched "
                             f"{got}, expected {want}")
    for dx in (False, True):
        check_qmm_routes(counts, "grad_int8_lora full", dx)
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    if not loss == loss or not finite:
        raise AssertionError(f"grad_int8_lora: 24-layer loss {loss}, "
                             f"finite grads {finite}")
    record["full"] = {"dtype": cfg.dtype, "layers": cfg.num_layers,
                      "batch": b, "seq": s, "loss": loss,
                      "fwd_bwd_s": wall, "launches": got,
                      "launches_by_route": routes_by_kernel(counts),
                      "counters": counts["counters"]}
    if device != "cpu":
        record["full"]["peak_mem_gib"] = \
            torch.cuda.max_memory_allocated() / 2 ** 30
    emit(record)
    del module, model, grads
    return record


def phase_finetune_lora(device="cuda", overrides=(), steps=3):
    """The frozen-base fine-tune: the 345M recipe with ``lora_rank`` 8
    and 2 bank rows, ``steps`` steps through ``cli.train_main``. The base
    parameters must be bit-equal before and after, optimizer state must
    exist for the ``*_lora`` banks alone, and the loss finite. The
    training forward passes no adapter ids (as the JAX engine's), so
    ``lora_b`` stays 0 and only weight decay moves ``lora_a``: both are
    printed. Returns the record."""
    import torch
    from paddlefleetx_tpu_torch import cli
    from paddlefleetx_tpu_torch.models.gpt.modules import GPTModule
    tmp = tempfile.mkdtemp(prefix="pfx_lora_")
    try:
        over = [f"Engine.max_steps={steps}", "Engine.logging_freq=1",
                "Engine.eval_freq=1000000", "Engine.eval_iters=1",
                "Engine.save_load.save_steps=1000000", *TRAIN_LR,
                "Model.lora_rank=8", "Model.lora_num_adapters=2",
                *overrides]
        cfg = write_train_corpus(os.path.join(tmp, "data"), over, steps)
        init = GPTModule(cfg, device=device).model.state_dict()
        before = {k: v.detach().cpu().clone() for k, v in init.items()}
        del init
        argv = train_argv(os.path.join(tmp, "data"),
                          os.path.join(tmp, "out"), over, device)
        reset_counts()
        engine = cli.train_main(argv)
        counts = read_counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    after = {k: v.detach().cpu() for k, v in engine.model.state_dict().items()}
    base_moved = [k for k in before if "_lora." not in k and
                  not torch.equal(before[k], after[k])]
    names = {id(p): n for n, p in engine.model.named_parameters()}
    state = engine.optimizer.state_dict()["state"]
    stateful = [names[id(p)] for p in engine.optimizer.params]
    losses = [h["loss"] for h in engine.history]
    lora_b = max(float(after[k].abs().max()) for k in after
                 if k.endswith("lora_b"))
    lora_a = {k: float(after[k].norm() / before[k].norm()) for k in after
              if k.endswith("lora_a")}
    record = {"phase": "finetune_lora", "steps": steps,
              "lora_rank": engine.module.model_config.lora_rank,
              "bank_rows": engine.module.model_config.lora_num_adapters,
              "losses": losses, "grad_norms": [h["grad_norm"]
                                               for h in engine.history],
              "base_bit_equal": not base_moved,
              "trained_params": len(stateful), "state_entries": len(state),
              "lora_b_max_abs": lora_b,
              "lora_a_norm_ratio_min": min(lora_a.values()),
              "lora_a_norm_ratio_max": max(lora_a.values()),
              "launches": {k: counts[k] for k in (
                  "grouped_matmul", "grouped_matmul_dw")}}
    emit(record)
    if base_moved or not stateful or \
            not all("_lora." in n for n in stateful) or \
            len(state) != len(stateful) or len(losses) != steps or \
            not all(x == x and abs(x) < float("inf") for x in losses):
        raise AssertionError(f"finetune_lora: base moved {base_moved[:4]}, "
                             f"optimizer over {stateful[:4]}..., losses "
                             f"{losses}")
    del engine
    return record


def lora_rows(dx_cases, grad) -> list:
    """The kernels line's row of kernel 7's dx route (the gradient
    phase's case, the worst errors over its cases, its launches on
    ``grad_int8_lora``'s 24-layer pass)."""
    head = dx_cases[0]
    err = max(c["max_abs_err"] for c in dx_cases)
    launches = grad["full"]["launches"]["quantized_matmul_dx"]
    return [{
        "name": "quantized_matmul_dx", "route": "cuda",
        "source": "paddlefleetx_tpu_torch/csrc/quantized_matmul.cu",
        "replaces": "paddlefleetx_tpu/ops/pallas/quantized_matmul.py:129",
        "replaces_kernel": "paddlefleetx_tpu/ops/pallas/"
        "quantized_matmul.py:44 (_qmm_kernel, launched again by "
        "_quantized_matmul_bwd)",
        "launches": launches,
        "launches_by_path": {"grad_int8_lora": launches},
        "kernel_route": head.get("route"),
        "launches_by_route": grad["full"].get(
            "launches_by_route", {}).get("quantized_matmul_dx", {}),
        "ms_mma": head.get("ms_mma"),
        "max_abs_err": err, "max_err": err,
        "tol": {c["dtype"]: c["tol"] for c in dx_cases},
        "max_rel_l2": max(c["rel_l2"] for c in dx_cases),
        "min_rel_l2_planted": min(c["rel_l2_planted"] for c in dx_cases),
        "tol_rel_l2": TOL_REL_L2, "normwise_per": "64 x 64 output tile",
        "ms": head["ms"], "kernel_ms": head["ms"],
        "call_ms": head["call_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "library_computes": head["library_computes"],
        "shape": {k: head[k] for k in ("dtype", "site", "M", "K", "N")},
        "by_shape": {f"{c['dtype']}_{c['site']}_M{c['M']}": {
            k: c.get(k) for k in ("route", "splits", "ms", "call_ms",
                                  "ms_routes", "plain_ms", "library_ms",
                                  "bound_ms", "bound_by")}
            for c in dx_cases},
        "cases": len(dx_cases)}]


def gmm_rows(cases, train_moe, lora=None, serving=None) -> list:
    """The kernels line's rows of kernels 8 and 9: the main path's case
    (bf16 fc1, forward and dw) with the worst errors over all their
    cases, the times at every shape, and the launches of ``train_moe``
    (counted from zero just before it); with ``lora``, ``(LoRA cases,
    their deltas, serve_lora, grad_int8_lora)``, also the bank shapes'
    errors and times and the launches of the serving arms and of the
    full-depth gradient pass; with ``serving``, ``(kernel 8's serving
    cases, serve_moe's arms)``, also kernel 8's errors and times at the
    MoE serving shapes (``serving``) and the arms' launches by
    route."""
    lora_cases, deltas, serve_lora, grad = lora or ([], [], None, None)
    serve_cases, serve_moe = serving or ([], {})
    cases = cases + lora_cases
    rows = []

    def routes(rec, name):
        return rec.get("launches_by_route", {}).get(name, {})
    for name, replaces in (
            ("grouped_matmul",
             "paddlefleetx_tpu/ops/pallas/grouped_matmul.py:52"),
            ("grouped_matmul_dw",
             "paddlefleetx_tpu/ops/pallas/grouped_matmul.py:76")):
        mine = [c for c in cases if c["kernel"] == name]
        held = mine + [c for c in serve_cases if c["kernel"] == name]
        head = mine[0]
        err = max(c["max_abs_err"] for c in held)
        by_path = {"train_moe": train_moe["launches"][name]}
        route_recs = [train_moe]
        for arm, rec in serve_moe.items():
            by_path[f"serve_moe_{arm}"] = rec["launches"].get(name, 0)
            route_recs.append(rec)
        if serve_lora is not None:
            for arm, rec in serve_lora["arms"].items():
                by_path[f"serve_lora_{arm}"] = rec["launches"].get(name, 0)
                route_recs.append(rec)
        if grad is not None:
            by_path["grad_int8_lora"] = grad["full"]["launches"][name]
            route_recs.append(grad["full"])
        by_route = {}
        for rec in route_recs:
            for r, n in routes(rec, name).items():
                by_route[r] = by_route.get(r, 0) + n
        rows.append({
            "name": name, "route": "cuda",
            "source": "paddlefleetx_tpu_torch/csrc/grouped_matmul.cu",
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "kernel_route": head["route"], "launches_by_route": by_route,
            "max_abs_err": err, "max_err": err,
            "tol": {c["dtype"]: c["tol"] for c in held},
            "max_rel_l2": max(c["rel_l2"] for c in held),
            "min_rel_l2_planted": min(c["rel_l2_planted"] for c in held),
            "tol_rel_l2": TOL_REL_L2, "normwise_per": "64 x 64 output tile",
            "empty_exact_zero": all(c["empty_exact_zero"] for c in held),
            "ms": head["ms"], "kernel_ms": head["ms"],
            "call_ms": head["call_ms"], "plain_ms": head["plain_ms"],
            "ms_prev_design": head["ms_prev_design"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "library_computes": head["library_computes"],
            "grouped_mm_ms": head["grouped_mm_ms"],
            "grouped_mm_call": head["grouped_mm_call"],
            "shape": {k: head[k] for k in ("dtype", "call", "G", "Gw", "C",
                                           "K", "N", "live_groups")},
            "by_shape": {f"{c['dtype']}_{c['call']}"
                         f"{'_C%d' % c['C'] if c.get('lora') else ''}": {
                k: c[k] for k in ("route", "ms", "ms_prev_design", "call_ms",
                                  "plain_ms", "library_ms", "grouped_mm_ms",
                                  "bound_ms", "bound_by")}
                for c in mine},
            "cases": len(mine)})
    if serve_cases:
        rows[0]["serving"] = {f"{c['serving']}_{c['call']}": {
            k: c[k] for k in ("G", "C", "K", "N", "live_groups", "route",
                              "ms", "ms_prev_design", "call_ms", "plain_ms",
                              "library_ms", "bound_ms", "bound_by",
                              "max_abs_err", "rel_l2")}
            for c in serve_cases}
        rows[0]["serving_library_computes"] = serve_cases[0][
            "library_computes"]
    if deltas:
        rows[0]["lora_delta"] = {f"{d['site']}_C{d['C']}": {
            k: d[k] for k in ("pair_ms", "gather_einsum_ms")}
            for d in deltas}
    return rows


def decode_window_rows(window, serve_paged, spec) -> list:
    """The kernels line's rows of kernels 6a, 5 and 6b: the serving
    path's case (the first of each phase) with the worst errors over
    all cases, the exact checks, and the launches of the main path each
    runs on (``serve_paged``; ``serve_spec`` paged and contiguous),
    counted from zero just before that path."""
    spec_paged, spec_contig = spec
    return _window_rows(window, "", {
        "kernel_paged": {
            "serve_paged": serve_paged["launches"]["flash_decode_paged"]},
        "kernel_verify": {"serve_spec_contiguous":
                          spec_contig["launches"]["flash_decode_verify"]},
        "kernel_paged_verify": {
            "serve_spec_paged":
            spec_paged["launches"]["flash_decode_paged_verify"]}}, {
        "kernel_paged": _sum_routes([serve_paged], "flash_decode_paged"),
        "kernel_verify": _sum_routes([spec_contig], "flash_decode_verify"),
        "kernel_paged_verify": _sum_routes([spec_paged],
                                           "flash_decode_paged_verify")})


def _sum_routes(records, name) -> dict:
    """``name``'s launches by route, summed over the paths' records."""
    out = {}
    for rec in records:
        for r, n in rec.get("launches_by_route", {}).get(name, {}).items():
            out[r] = out.get(r, 0) + n
    return out


def _decode_route_keys(head) -> dict:
    """The route fields of a decode kernel's row from its path case."""
    return {"kernel_route": head.get("route"),
            "cluster": head.get("cluster"), "simt_ms": head.get("simt_ms")}


#: the TPU kernels the decode instances replace (file:line)
_DECODE_REPLACES = {
    "flash_decode": "paddlefleetx_tpu/ops/pallas/flash_attention.py:1055",
    "flash_decode_verify":
    "paddlefleetx_tpu/ops/pallas/flash_attention.py:1140",
    "flash_decode_paged":
    "paddlefleetx_tpu/ops/pallas/flash_attention.py:1422",
    "flash_decode_paged_verify":
    "paddlefleetx_tpu/ops/pallas/flash_attention.py:1433"}
#: where the TPU kernels take their int8 branch (``quantized=True``)
_INT8_BRANCH = {
    "flash_decode": "paddlefleetx_tpu/ops/pallas/flash_attention.py:1088-1117",
    "flash_decode_verify":
    "paddlefleetx_tpu/ops/pallas/flash_attention.py:1165-1189",
    "flash_decode_paged":
    "paddlefleetx_tpu/ops/pallas/flash_attention.py:1536-1548",
    "flash_decode_paged_verify":
    "paddlefleetx_tpu/ops/pallas/flash_attention.py:1549-1559"}


def _window_rows(window, suffix, launches, by_route) -> list:
    """Rows of kernels 6a, 5 and 6b (their int8 instances with
    ``suffix`` "_int8") from the cases of ``window`` and the main-path
    ``launches`` of each phase, in all and ``by_route``."""
    rows = []
    for phase, name in (("kernel_paged", "flash_decode_paged"),
                        ("kernel_verify", "flash_decode_verify"),
                        ("kernel_paged_verify", "flash_decode_paged_verify")):
        replaces = _DECODE_REPLACES[name]
        routes = by_route[phase + suffix]
        phase, name = phase + suffix, name + suffix
        launches_p = launches[phase]
        cases = window[phase]
        head = cases[0]
        err = max(c["max_abs_err"] for c in cases)
        rows.append({
            "name": name, "route": "cuda",
            "source": "paddlefleetx_tpu_torch/csrc/flash_decode.cu",
            "replaces": replaces, "launches": sum(launches_p.values()),
            "launches_by_path": launches_p, "max_abs_err": err,
            "max_err": err,
            "tol": {c["dtype"]: c["tol"] for c in cases},
            "max_rel_l2": max(c["rel_l2"] for c in cases),
            "min_rel_l2_planted": min(c["rel_l2_planted"] for c in cases),
            "tol_rel_l2": TOL_REL_L2,
            "exact_vs": head["exact_vs"],
            "exact_max_abs_err": max(c["exact_max_abs_err"] for c in cases),
            "exact_vs_ms": head["counterpart_ms"],
            "ms": head["ms"], "kernel_ms": head["ms"],
            "call_ms": head["call_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "library_computes": head["library_computes"],
            **_decode_route_keys(head), "launches_by_route": routes,
            "shape": {k: head[k] for k in ("dtype", "b", "h", "d", "window",
                                           "capacity", "page")},
            "by_window": {f"{c['dtype']}_w{c['window']}": {
                k: c.get(k) for k in ("route", "ms", "simt_ms",
                                      "counterpart_ms", "plain_ms",
                                      "library_ms", "bound_ms", "bound_by")}
                for c in cases},
            "cases": len(cases)})
        if suffix:
            rows[-1]["int8_branch"] = _INT8_BRANCH[name[:-len(suffix)]]
    return rows


def int8_rows(dec8, window8, qmm_cases, runs) -> list:
    """The kernels line's rows of kernel 7 and of the int8 instances of
    kernels 2, 5, 6a and 6b: each the main path's case (the first of its
    phase) with the worst errors over all its cases, and its launches
    on the ``serve_int8`` arms (``runs``), each counted from zero just
    before its arm."""
    def launched(key, arms):
        return {f"serve_int8_{a}": runs[a]["launches"].get(key, 0)
                for a in arms}
    head = qmm_cases[0]
    err = max(c["max_abs_err"] for c in qmm_cases)
    qlaunch = launched("quantized_matmul", runs)
    by_route = {}
    for run in runs.values():
        for r, n in run.get("launches_by_route", {}).get(
                "quantized_matmul", {}).items():
            by_route[r] = by_route.get(r, 0) + n
    rows = [{
        "name": "quantized_matmul", "route": "cuda",
        "source": "paddlefleetx_tpu_torch/csrc/quantized_matmul.cu",
        "replaces": "paddlefleetx_tpu/ops/pallas/quantized_matmul.py:44",
        "launches": sum(qlaunch.values()), "launches_by_path": qlaunch,
        "kernel_route": head.get("route"), "launches_by_route": by_route,
        "ms_mma": head.get("ms_mma"),
        "max_abs_err": err, "max_err": err,
        "tol": {c["dtype"]: c["tol"] for c in qmm_cases},
        "max_rel_l2": max(c["rel_l2"] for c in qmm_cases),
        "min_rel_l2_planted": min(c["rel_l2_planted"] for c in qmm_cases),
        "tol_rel_l2": TOL_REL_L2, "normwise_per": "64 x 64 output tile",
        "ms": head["ms"], "kernel_ms": head["ms"],
        "call_ms": head["call_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "library_computes": head["library_computes"],
        "int8pack_ms": head["int8pack_ms"],
        "shape": {k: head[k] for k in ("dtype", "site", "M", "K", "N")},
        "by_shape": {f"{c['dtype']}_{c['site']}_M{c['M']}": {
            k: c.get(k) for k in ("route", "splits", "ms", "call_ms",
                                  "ms_routes", "plain_ms", "library_ms",
                                  "int8pack_ms", "bound_ms", "bound_by")}
            for c in qmm_cases},
        "cases": len(qmm_cases)}]
    head = dec8[0]
    err = max(c["max_abs_err"] for c in dec8)
    klaunch = launched("flash_decode_int8", ("contiguous",))
    rows.append({
        "name": "flash_decode_int8", "route": "cuda",
        "source": "paddlefleetx_tpu_torch/csrc/flash_decode.cu",
        "replaces": _DECODE_REPLACES["flash_decode"],
        "int8_branch": _INT8_BRANCH["flash_decode"],
        "launches": sum(klaunch.values()), "launches_by_path": klaunch,
        "max_abs_err": err, "max_err": err,
        "tol": {c["dtype"]: c["tol"] for c in dec8},
        "max_rel_l2": max(c["rel_l2"] for c in dec8),
        "min_rel_l2_planted": min(c["rel_l2_planted"] for c in dec8),
        "tol_rel_l2": TOL_REL_L2, "ms": head["ms"], "kernel_ms": head["ms"],
        "call_ms": head["call_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "library_computes": head["library_computes"],
        **_decode_route_keys(head),
        "launches_by_route": _sum_routes([runs["contiguous"]],
                                         "flash_decode"),
        "shape": {k: head[k] for k in ("dtype", "b", "h", "S", "d",
                                       "offsets", "shared_offset_bias")},
        "cases": len(dec8)})
    rows += _window_rows(window8, "_int8", {
        "kernel_paged_int8": launched("flash_decode_paged_int8", ("paged",)),
        "kernel_verify_int8": launched("flash_decode_verify_int8",
                                       ("contiguous_spec",)),
        "kernel_paged_verify_int8": launched(
            "flash_decode_paged_verify_int8", ("paged_spec",))}, {
        "kernel_paged_int8": _sum_routes([runs["paged"]],
                                         "flash_decode_paged"),
        "kernel_verify_int8": _sum_routes([runs["contiguous_spec"]],
                                          "flash_decode_verify"),
        "kernel_paged_verify_int8": _sum_routes([runs["paged_spec"]],
                                                "flash_decode_paged_verify")})
    return rows


def kernels_line(fwd, dec, serve, fwd_drop, bwd, train, window=None,
                 serve_paged=None, spec=None, int8=None, moe=None,
                 lora=None, evals=None, run_1p3b=None) -> dict:
    """The per-kernel record: each kernel's main-path shape (kernel 1:
    the serving case first, the training case beside it, each with its
    route and the ``mma`` route's time; kernels 3 and 4: the recipe's
    bf16 case with dropout), the worst error over all its cases (max abs
    and normwise, with the least planted-fault reading), and its
    launches on the main paths (serve and train; kernels 1, 3 and 4 also
    train_moe; kernel 1 also by route), each counted from zero just
    before its path ran. Kernels 3 and 4
    also carry the pair's time and the bound of the one TPU function
    they replace together (5 products, ``bound_ms_both``). With
    ``evals`` (:func:`eval_rows`), kernels 1 and 8 also carry their
    eval-shape cases and the eval paths' launches. With ``run_1p3b``
    (kernel 1's and the backward's 1.3B cases and ``train_auto_1p3b``),
    kernels 1, 3 and 4 carry their head_dim-128 case (``shape_1p3b``)
    and that path's launches."""
    k1_paths = {"serve": serve, "train": train}
    if moe is not None:
        k1_paths["train_moe"] = moe[1]
    if evals is not None:
        k1_paths.update(evals["runs"])
    k1_launch = {p: rec["launches"]["flash_attention"]
                 for p, rec in k1_paths.items()}
    k1_routes = {}
    for rec in k1_paths.values():
        for r, n in rec.get("launches_by_route", {}).get(
                "flash_attention", {}).items():
            k1_routes[r] = k1_routes.get(r, 0) + n
    rows = []
    fwd_eval = [evals["fwd"]] if evals and evals.get("fwd") else []
    for name, cases, source, replaces, launches in (
            ("flash_attention", fwd + fwd_drop + fwd_eval,
             "paddlefleetx_tpu_torch/"
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
    rows[0].update(kernel_route=fwd[0].get("route"),
                   block_n=fwd[0].get("block_n"), mma_ms=fwd[0].get("mma_ms"),
                   launches_by_route=k1_routes)
    rows[1].update(_decode_route_keys(dec[0]),
                   launches_by_route=_sum_routes([serve], "flash_decode"))
    if fwd_drop:
        t = fwd_drop[0]
        rows[0]["train_shape"] = {k: t.get(k) for k in (
            "dtype", "b", "h", "s", "d", "bias", "dropout", "route",
            "block_n", "ms", "call_ms", "plain_ms", "mma_ms", "library_ms",
            "bound_ms", "bound_by")}
    for name, which, grads, replaces in (
            ("flash_bwd_dkv", "dkv", ("dk", "dv"),
             "paddlefleetx_tpu/ops/pallas/flash_attention.py:419"),
            ("flash_bwd_dq", "dq", ("dq",),
             "paddlefleetx_tpu/ops/pallas/flash_attention.py:454")):
        head = bwd[0]
        err = max(c["max_abs_err"][g] for c in bwd for g in grads)
        by_path = {"train": train["launches"][name]}
        if moe is not None:
            by_path["train_moe"] = moe[1]["launches"][name]
        rows.append({
            "name": name, "route": "cuda",
            "source": "paddlefleetx_tpu_torch/csrc/flash_bwd.cu",
            "replaces": replaces,
            "replaces_also": ["paddlefleetx_tpu/ops/pallas/"
                              "flash_attention.py:485 (_bwd_combined_kernel)",
                              "paddlefleetx_tpu/ops/pallas/"
                              "flash_attention.py:555 (_bwd_fused_kernel)"],
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
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
    if window is not None:
        rows += decode_window_rows(window, serve_paged, spec)
    if int8 is not None:
        rows += int8_rows(*int8)
    if moe is not None:
        # moe: (kernel 8 / 9 cases, train_moe[, (kernel 8's serving
        # cases, serve_moe's arms)]); lora: (dx cases, grad_int8_lora,
        # kernel 8 / 9 bank cases, the deltas, serve_lora)
        rows += gmm_rows(moe[0], moe[1], lora=None if lora is None else (
            lora[2], lora[3], lora[4], lora[1]), serving=moe[2] if
            len(moe) > 2 else None)
    if lora is not None:
        rows += lora_rows(lora[0], lora[1])
    if evals is not None:
        eval_rows(rows, evals)
    if run_1p3b is not None:
        rows_1p3b(rows, *run_1p3b)
    return {"kernels": rows}


def rows_1p3b(rows, fwd, bwd, run) -> None:
    """Add the 1.3B slice to the kernels line's ``rows``: kernel 1's and
    kernels 3 and 4's head_dim-128 cases (``shape_1p3b``: ms, plain,
    SDPA, bound, error) and their launches on ``train_auto_1p3b``."""
    by_name = {r["name"]: r for r in rows}
    k1 = by_name["flash_attention"]
    k1["shape_1p3b"] = {k: fwd.get(k) for k in (
        "dtype", "b", "h", "s", "d", "dropout", "route", "block_n",
        "mma_ms", "ms", "call_ms", "plain_ms", "library_ms", "bound_ms",
        "bound_by", "max_abs_err", "rel_l2")}
    for name, which, grads in (("flash_bwd_dkv", "dkv", ("dk", "dv")),
                               ("flash_bwd_dq", "dq", ("dq",))):
        by_name[name]["shape_1p3b"] = {
            **{k: bwd[k] for k in ("dtype", "b", "h", "s", "d", "dropout",
                                   "plain_ms", "library_ms")},
            "ms": bwd[f"ms_{which}"], "call_ms": bwd[f"call_ms_{which}"],
            "bound_ms": bwd[f"bound_ms_{which}"],
            "bound_by": bwd[f"bound_by_{which}"],
            "max_abs_err": max(bwd["max_abs_err"][g] for g in grads),
            "rel_l2": max(bwd["rel_l2"][g] for g in grads)}
    for name in ("flash_attention", "flash_bwd_dkv", "flash_bwd_dq"):
        row = by_name[name]
        n = run["launches"][name]
        row["launches_by_path"]["train_auto_1p3b"] = n
        row["launches"] += n
        row["max_abs_err"] = row["max_err"] = max(
            row["max_abs_err"], row["shape_1p3b"]["max_abs_err"])
    for r, m in run["launches_by_route"]["flash_attention"].items():
        k1["launches_by_route"][r] = k1["launches_by_route"].get(r, 0) + m


_EVAL_KEYS = ("route", "ms", "call_ms", "plain_ms", "library_ms",
              "bound_ms", "bound_by", "max_abs_err", "rel_l2")


def eval_rows(rows, evals) -> None:
    """Add the eval slice to the kernels line's ``rows``: kernel 1's
    eval-shape case (``eval_shape``; its launches on ``eval``,
    ``eval_cloze``, ``eval_moe`` and ``predict`` are in its
    ``launches_by_path`` already) and kernel 8's fc1 and fc2 at the MoE
    eval batch (``eval``), with ``eval_moe``'s launches by path and by
    route. ``evals``: ``{"fwd": kernel-1 case, "gmm": kernel-8 cases,
    "runs": {path: record}}``."""
    by_name = {r["name"]: r for r in rows}
    k1 = by_name["flash_attention"]
    if evals.get("fwd"):
        c = evals["fwd"]
        k1["eval_shape"] = {k: c.get(k) for k in (
            "dtype", "b", "h", "s", "d", "bias", "block_n", "mma_ms",
            *_EVAL_KEYS)}
    k8 = by_name.get("grouped_matmul")
    run = evals["runs"].get("eval_moe")
    if k8 is None or run is None:
        return
    n = run["launches"]["grouped_matmul"]
    k8["launches_by_path"]["eval_moe"] = n
    k8["launches"] += n
    for r, m in run["launches_by_route"]["grouped_matmul"].items():
        k8["launches_by_route"][r] = k8["launches_by_route"].get(r, 0) + m
    k8["eval"] = {c["call"]: {k: c.get(k) for k in (
        "G", "C", "K", "N", "live_groups", "ms_prev_design", *_EVAL_KEYS)}
        for c in evals["gmm"]}
    k8["max_abs_err"] = k8["max_err"] = max(
        [k8["max_abs_err"]] + [c["max_abs_err"] for c in evals["gmm"]])


#: each phase's wall seconds, by name, as :func:`timed` printed them
PHASE_SECONDS = {}


def timed(name, fn, *args, **kw):
    """Run one phase and print its wall seconds on a line of its own
    (``{"phase_seconds": name, "s": ...}``)."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    PHASE_SECONDS[name] = time.perf_counter() - t0
    emit({"phase_seconds": name, "s": PHASE_SECONDS[name]})
    return out


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
    start = time.perf_counter()
    card = card_line()
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    timed("build", phase_build)
    fwd, dec = timed("kernels", phase_kernels)
    window = timed("decode_kernels", phase_decode_kernels)
    dec8, window8 = timed("int8_decode_kernels", phase_int8_decode_kernels)
    qmm_cases = timed("kernel_qmm", phase_kernel_qmm)
    qmm_dx_cases = timed("kernel_qmm_dx", phase_kernel_qmm_dx)
    gmm_cases = timed("kernel_gmm", phase_kernel_gmm)
    gmm_serve = timed("kernel_gmm_serving", phase_kernel_gmm_serving)
    gmm_lora = timed("kernel_gmm_lora", phase_kernel_gmm_lora)
    fwd_eval, gmm_eval = timed("kernels_eval", phase_kernels_eval)
    fwd_drop = timed("kernel1_dropout", phase_kernel1_dropout)
    bwd = timed("backward", phase_backward)
    fwd_1p3b = timed("kernel1_1p3b", phase_kernel1_1p3b)
    bwd_1p3b = timed("backward_1p3b", phase_backward_1p3b)
    torch.cuda.empty_cache()
    serve, module = timed("serve", phase_serve)
    timed("profile", phase_profile, module)
    loop = {"contiguous": timed("serve_loop_contiguous",
                                phase_serve_loop_contiguous, module, serve)}
    del module
    timed("serve_cli", phase_serve_cli)
    timed("parity", phase_parity)
    timed("generate_cli", phase_generate_cli)
    torch.cuda.empty_cache()
    serve_paged, module = timed("serve_paged", phase_serve_paged)
    spec = timed("serve_spec", phase_serve_spec, module)
    paged_windows = timed("profile_paged", phase_profile_paged, module)
    loop.update(timed("serve_loop_paged", phase_serve_loop_paged, module,
                      serve_paged, paged_windows))
    timed("serve_tiered", phase_serve_tiered, module)
    timed("serve_robust", phase_serve_robust, module)
    del module
    timed("serve_cli_paged_spec", phase_serve_cli, paged_spec=True)
    torch.cuda.empty_cache()
    timed("parity_paged", phase_parity_paged)
    torch.cuda.empty_cache()
    int8_runs, module = timed("serve_int8", phase_serve_int8, serve_paged)
    timed("profile_paged_int8", phase_profile_paged, module,
          pool_pages=int8_runs["paged"]["pool_pages"], suffix="_int8")
    loop.update(timed("serve_loop_int8", phase_serve_loop_int8, module,
                      int8_runs))
    del module
    torch.cuda.empty_cache()
    timed("serve_cli_int8", phase_serve_cli, int8=True)
    timed("parity_int8", phase_parity_int8)
    torch.cuda.empty_cache()
    train, engine = timed("train", phase_train)
    timed("train_profile", phase_train_profile, engine)
    del engine
    torch.cuda.empty_cache()
    timed("train_parity", phase_train_parity)
    torch.cuda.empty_cache()
    timed("train_cli", phase_train_cli)
    torch.cuda.empty_cache()
    auto_1p3b = timed("train_auto_1p3b", phase_train_auto_1p3b)
    torch.cuda.empty_cache()
    train_moe, engine = timed("train_moe", phase_train_moe)
    timed("train_moe_profile", phase_train_profile, engine,
          phase="train_moe_profile")
    del engine
    torch.cuda.empty_cache()
    timed("train_moe_parity", phase_train_moe_parity)
    torch.cuda.empty_cache()
    serve_moe, module = timed("serve_moe", phase_serve_moe)
    moe_windows = timed("profile_paged_moe", phase_profile_paged, module,
                        suffix="_moe")
    loop["moe"] = timed("serve_loop_moe", serve_loop_arm, module,
                        "serve_loop_moe", serve_moe["paged"])
    timed("profile_loop_moe", profile_loop, module, moe_windows[0],
          label="decode_paged_moe_loop")
    del module
    torch.cuda.empty_cache()
    timed("serve_cli_moe", phase_serve_cli, overrides=MOE_KNOBS)
    timed("generate_cli_moe", phase_generate_cli, overrides=MOE_KNOBS)
    torch.cuda.empty_cache()
    timed("parity_moe", phase_parity_moe)
    torch.cuda.empty_cache()
    evals = {"fwd": fwd_eval, "gmm": gmm_eval, "runs": {}}
    evals["runs"]["eval"] = timed("eval", phase_eval)
    torch.cuda.empty_cache()
    evals["runs"]["eval_cloze"] = timed("eval_cloze", phase_eval_cloze)
    torch.cuda.empty_cache()
    evals["runs"]["eval_moe"] = timed("eval_moe", phase_eval_moe)
    torch.cuda.empty_cache()
    timed("eval_parity", phase_eval_parity)
    torch.cuda.empty_cache()
    timed("eval_profile", phase_eval_profile)
    torch.cuda.empty_cache()
    evals["runs"]["predict"] = timed("predict", phase_predict)
    torch.cuda.empty_cache()
    serve_lora, module = timed("serve_lora", phase_serve_lora)
    lora_window = timed("profile_lora", phase_profile_lora, module)
    mixed = (lora_source(module.model, module.seed), [1, 2, 3, 4])
    loop["lora"] = timed(
        "serve_loop_lora", serve_loop_arm, module, "serve_loop_lora",
        serve_lora["arms"]["mixed"], adapters=mixed)
    timed("profile_loop_lora", profile_loop, module, lora_window,
          label="decode_paged_lora_loop", adapters=mixed)
    del module
    torch.cuda.empty_cache()
    timed("serve_lora_int8", phase_serve_lora_int8)
    torch.cuda.empty_cache()
    timed("parity_lora", phase_parity_lora)
    torch.cuda.empty_cache()
    grad = timed("grad_int8_lora", phase_grad_int8_lora)
    torch.cuda.empty_cache()
    timed("finetune_lora", phase_finetune_lora)
    emit({"phase": "serve_loop", "loop_ticks": LOOP_TICKS,
          "arms": sorted(loop), "seconds": sum(
              t for name, t in PHASE_SECONDS.items()
              if name.startswith(("serve_loop", "profile_loop")))})
    emit({"phase_seconds": "total", "s": time.perf_counter() - start})
    print(card, flush=True)
    emit(kernels_line(fwd, dec, serve, fwd_drop, bwd, train, window,
                      serve_paged, spec,
                      (dec8, window8, qmm_cases, int8_runs),
                      (gmm_cases, train_moe, (gmm_serve, serve_moe)),
                      (qmm_dx_cases, grad, *gmm_lora, serve_lora), evals,
                      (fwd_1p3b, bwd_1p3b, auto_1p3b)))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
