#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddlefleetx_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``paddlefleetx_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version on the card at the
serving path's shapes (and times kernel, plain version, a library call
and the kernel's bound), serves GPT-345M (full width, 24 layers, bf16,
weights from a seed) through ``GenerationServer`` with the launch
counters reset just before and read just after, profiles one admission
step and 16 decode ticks (device kernel time by category, idle share),
runs the ``serve`` entry point with the recipe's sampling, checks the
fp32 server against the lockstep ``generate()`` and the kernel path
against the dense PyTorch path token for token, and runs the
``generate`` entry point. Each phase prints one JSON object per line;
the ``kernels`` line and the card's name and power limit come before
the last line, which is ``{"ok": true, "device": {...}}``. Any failure
raises, so the exit code is non-zero and the last line is not printed.
Without a CUDA device, or without the package beside it, it exits
non-zero at once. Long output goes to ``chiprun_out/chip_smoke/``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "nlp", "gpt",
                      "generation_gpt_345M_single_card.yaml")
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
    err = _max_err(out, plain(0, upcast=True))
    tol = TOL[str(dtype).split(".")[-1]]
    if not torch.isfinite(out.float()).all() or err > tol:
        raise AssertionError(
            f"flash_decode disagrees with its plain version: max abs err "
            f"{err:.3e} > {tol:.0e} ({dtype}, offsets={offsets}, "
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
            "max_abs_err": err, "tol": tol, "ms": ms, "call_ms": call_ms,
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


# -- the serving path ---------------------------------------------------


def reset_counts():
    """Zero both kernels' launch counts and the process-global registry
    (enabled), just before a run whose counts are read."""
    from paddlefleetx_tpu_torch.observability import metrics
    from paddlefleetx_tpu_torch.ops.cuda import flash_attention as fa
    fa.flash_attention.launches = 0
    fa.flash_decode.launches = 0
    metrics.set_enabled(True)
    metrics.get_registry().reset()


def read_counts() -> dict:
    """Both kernels' launch counts and the registry's ``attention/*``
    and ``serving/*`` counters, just after a run."""
    from paddlefleetx_tpu_torch.observability import metrics
    from paddlefleetx_tpu_torch.ops.cuda import flash_attention as fa
    counters = metrics.get_registry().snapshot()["counters"]
    return {"flash_attention": fa.flash_attention.launches,
            "flash_decode": fa.flash_decode.launches,
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


def kernels_line(fwd, dec, serve) -> dict:
    """The per-kernel record: the serving-shape case's numbers (the
    first case of each list), the worst error over all cases, and the
    main path's launch count."""
    rows = []
    for name, cases, source, replaces, launches in (
            ("flash_attention", fwd, "paddlefleetx_tpu_torch/csrc/"
             "flash_fwd.cu", "paddlefleetx_tpu/ops/pallas/"
             "flash_attention.py:209", serve["launches"]["flash_attention"]),
            ("flash_decode", dec, "paddlefleetx_tpu_torch/csrc/"
             "flash_decode.cu", "paddlefleetx_tpu/ops/pallas/"
             "flash_attention.py:1055", serve["launches"]["flash_decode"])):
        head = cases[0]
        err = max(c["max_abs_err"] for c in cases)
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "max_err": err,
            "tol": {c["dtype"]: c["tol"] for c in cases},
            "ms": head["ms"], "kernel_ms": head["ms"],
            "call_ms": head["call_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": {k: head[k] for k in head
                      if k in ("dtype", "b", "h", "s", "S", "d", "offsets",
                               "bias", "shared_offset_bias")},
            "cases": len(cases)})
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
    serve, module = phase_serve()
    phase_profile(module)
    del module
    phase_serve_cli()
    phase_parity()
    phase_generate_cli()
    print(card, flush=True)
    emit(kernels_line(fwd, dec, serve))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
