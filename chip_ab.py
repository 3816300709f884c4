#!/usr/bin/env python3
"""A/B of the port's dense serving phases between checkouts on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100::

    python3 chip_ab.py --tree parent=DIR --tree change=. [--rounds 5]

Each ``--tree NAME=DIR`` is the root of a checkout (this one, or one
unpacked with ``git archive`` into a directory that ``.gitignore``
lists). The kernels of every tree are built first, all at once. Then
each round runs every tree once, in the given order in even rounds and
in reverse in odd ones (parent, change, change, parent, ...), each run a
fresh process in its tree that serves the three dense phases of that
tree's ``chip_smoke.py`` with their own checks: ``serve`` (GPT-345M,
contiguous, 16 requests on 8 slots), ``serve_paged`` (the headline trace,
32 requests on 16 slots) and ``serve_int8`` (the trace with both int8
knobs, then its short contiguous and speculative arms). Every reading
of every run is printed, a JSON object a line (``"ab": "run"``), then
per tree and metric the readings in run order with their median, least
and most (``"ab": "summary"``), the card's name and power limit, and
last ``{"ok": true}``. Each run's full output goes to
``chiprun_out/ab/<tree>_<round>.log``.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "ab")

#: one run in a tree: its kernels (built already), then its dense
#: serving phases; the last line holds the readings
WORKER = r"""
import json, sys, time
import torch
import chip_smoke as cs
from paddlefleetx_tpu_torch.ops.cuda import build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.load()
t0 = time.perf_counter()
serve, m = cs.phase_serve()
del m
paged, m = cs.phase_serve_paged()
del m
torch.cuda.empty_cache()
int8, m = cs.phase_serve_int8(paged)
del m
out = {"serve": {"tokens_per_s": serve["decode_tokens_per_s"],
                 "e2e_tokens_per_s": serve["e2e_tokens_per_s"],
                 "tick_p50_ms": serve["decode_tick_p50_ms"],
                 "wall_s": serve["wall_s"]},
       "serve_paged": {k: paged[k] for k in (
           "decode_tokens_per_s", "e2e_tokens_per_s", "tick_p50_ms",
           "wall_s")}}
for arm, rec in int8.items():
    out["serve_int8_" + arm] = {k: rec.get(k) for k in (
        "decode_tokens_per_s", "e2e_tokens_per_s", "tick_p50_ms", "wall_s")}
out["phases_s"] = time.perf_counter() - t0
print("AB_RESULT " + json.dumps(out), flush=True)
"""

BUILD = ("from paddlefleetx_tpu_torch.ops.cuda import build; build.load(); "
         "print(build.last_build.get('seconds'))")


def emit(obj) -> None:
    """Print one JSON object on a line of its own."""
    print(json.dumps(obj), flush=True)


def parse_trees(specs):
    """``[(name, absolute root)]`` from ``NAME=DIR`` arguments; each root
    must hold ``chip_smoke.py`` and the port's package."""
    trees = []
    for spec in specs:
        name, sep, path = spec.partition("=")
        root = os.path.abspath(os.path.join(ROOT, path))
        if not sep or not name or not os.path.isfile(
                os.path.join(root, "chip_smoke.py")) or not os.path.isdir(
                os.path.join(root, "paddlefleetx_tpu_torch")):
            raise SystemExit(f"chip_ab: --tree {spec!r} is not NAME=DIR "
                             f"of a checkout")
        trees.append((name, root))
    if len({n for n, _ in trees}) != len(trees) or len(trees) < 2:
        raise SystemExit("chip_ab: give two or more trees with distinct "
                         "names")
    return trees


def build_all(trees, timeout):
    """Build every tree's kernels at once; raise if one fails."""
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", BUILD], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, root in trees}
    for name, proc in procs.items():
        out, _ = proc.communicate(timeout=timeout)
        if proc.returncode:
            raise SystemExit(f"chip_ab: building {name} failed:\n{out}")
        emit({"ab": "build", "tree": name,
              "nvcc_seconds": out.strip().splitlines()[-1]})


def run_once(name, root, rnd, timeout):
    """One run of ``WORKER`` in ``root``; its readings."""
    log = os.path.join(OUT_DIR, f"{name}_{rnd}.log")
    t0 = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.run([sys.executable, "-c", WORKER], cwd=root,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              timeout=timeout)
        f.write(proc.stdout)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("AB_RESULT ")]
    if proc.returncode or not lines:
        raise SystemExit(f"chip_ab: {name} round {rnd} failed (rc "
                         f"{proc.returncode}); see {log}:\n"
                         f"{proc.stdout[-4000:]}")
    out = json.loads(lines[-1][len("AB_RESULT "):])
    out["process_s"] = time.perf_counter() - t0
    return out


def summary(readings):
    """Per tree, phase and metric: the readings in run order, their
    median, least and most."""
    table = {}
    for name, runs in readings.items():
        for run in runs:
            for phase, vals in run.items():
                if not isinstance(vals, dict):
                    continue
                for metric, v in vals.items():
                    table.setdefault(phase, {}).setdefault(
                        metric, {}).setdefault(name, []).append(v)
    for phase, metrics in table.items():
        for metric, by_tree in metrics.items():
            for name, vals in by_tree.items():
                nums = [v for v in vals if v is not None]
                by_tree[name] = {"readings": vals,
                                 "median": statistics.median(nums)
                                 if nums else None,
                                 "min": min(nums, default=None),
                                 "max": max(nums, default=None)}
    return table


def main() -> int:
    """Build, run the rounds, print every reading and the summary."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="NAME=DIR of a checkout (two or more)")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--timeout", type=int, default=600,
                    help="seconds a build or a run may take")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: torch.cuda.is_available() is False; the A/B needs "
              "a CUDA device", file=sys.stderr)
        return 1
    trees = parse_trees(args.tree)
    os.makedirs(OUT_DIR, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    build_all(trees, args.timeout)
    readings = {name: [] for name, _ in trees}
    for rnd in range(args.rounds):
        order = trees if rnd % 2 == 0 else trees[::-1]
        for name, root in order:
            out = run_once(name, root, rnd, args.timeout)
            readings[name].append(out)
            emit({"ab": "run", "tree": name, "round": rnd, **out})
    emit({"ab": "summary", "card": card, "rounds": args.rounds,
          "order": [n for n, _ in trees], "table": summary(readings)})
    print(card, flush=True)
    emit({"ok": True})
    return 0


if __name__ == "__main__":
    sys.exit(main())
