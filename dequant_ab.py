#!/usr/bin/env python3
"""Kernel C (the int8 dequant-matmul) of several source trees, timed in
turns on one NVIDIA GPU.

    python3 dequant_ab.py NAME=ROOT [NAME=ROOT ...] [--rounds N]

Each ROOT is a directory that holds a `deepspeed_tpu_torch/` package: this
checkout, or another commit's unpacked there with `git archive`.  Every
tree is measured in a process of its own, which builds its kernels at
first use into ROOT/build/torch_kernels/.  The host's speed drifts within
a run, so the processes run in turns: the trees in order, then in reverse
(A, B, B, A), N times.  Each process measures `fused_dequant_matmul` at
GPT-2 124M's four int8 products (c_attn [768, 2304], attn c_proj [768,
768], c_fc [768, 3072], mlp c_proj [3072, 768]; one scale group, bf16 x)
at M = 8 (a decode step of batch 8) and M = 1024 (a prefill of 8 x 128
tokens), with two timers:

- ms: device ms of one launch (CUDA events, median of 30, L2 flushed, a
  spin kernel under the enqueue, as chip_smoke.py's time_ms), whose floor
  is the events' own ~8 µs;
- batched_us: device µs per launch of 64 launches back to back under one
  pair of events after a longer spin kernel, rotating over copies of the
  operands that together exceed twice the 50 MB L2 (each launch reads them
  cold from HBM), the median of 5 batches (chip_smoke.py's batched_us);

and host_us: host µs per call (200 calls enqueued back to back, the median
of 5 such batches), and rel_err: max|d| / max|ref| against the plain twin,
to show that each tree computes the product.

Prints the card's name and power limit, one JSON line per process, and,
last, one JSON line of the medians per tree.
"""

import argparse
import importlib
import json
import os
import subprocess
import sys
import time

SHAPES = {"c_attn": (768, 2304), "attn_proj": (768, 768),
          "c_fc": (768, 3072), "mlp_proj": (3072, 768)}
ROWS = (8, 1024)
TIMED_RUNS = 30
SPIN_CYCLES = 2_000_000  # ~1 ms of torch.cuda._sleep: longer than any enqueue
BATCH_LAUNCHES = 64
BATCH_SPIN_CYCLES = 8 * SPIN_CYCLES
BATCH_ROUNDS = 5
L2_BYTES = 50 * 2 ** 20
HOST_CALLS = 200
HOST_BATCHES = 5


def time_ms(torch, fn, flush):
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(TIMED_RUNS):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[TIMED_RUNS // 2]


def batched_us(torch, fn, operands):
    nbytes = sum(t.numel() * t.element_size() for t in operands)
    copies = [tuple(t.clone() for t in operands)
              for _ in range(max(2, -(-2 * L2_BYTES // nbytes) + 1))]
    for args in copies[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(BATCH_ROUNDS):
        torch.cuda._sleep(BATCH_SPIN_CYCLES)
        start.record()
        for i in range(BATCH_LAUNCHES):
            fn(*copies[i % len(copies)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / BATCH_LAUNCHES)
    return sorted(times)[BATCH_ROUNDS // 2]


def host_us(torch, fn):
    fn()
    torch.cuda.synchronize()
    batches = []
    for _ in range(HOST_BATCHES):
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        batches.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        torch.cuda.synchronize()
    return sorted(batches)[HOST_BATCHES // 2]


def measure(root):
    sys.path.insert(0, root)
    import numpy as np
    import torch
    quant = importlib.import_module("deepspeed_tpu_torch.ops.quant")
    wq = importlib.import_module(
        "deepspeed_tpu_torch.runtime.weight_quantizer")
    if not os.path.abspath(quant.__file__).startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {quant.__file__}, not the tree at {root}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    res = {"root": root, "ms": {}, "batched_us": {}, "host_us": {},
           "rel_err": {}}
    for name, (k, n) in SHAPES.items():
        rng = np.random.default_rng(k + n)
        w = wq.quantize_weight((rng.standard_normal((k, n)) * 0.02).astype(
            np.float32), 1, "cuda")
        for m in ROWS:
            case = f"{name} M={m}"
            x = torch.from_numpy(rng.standard_normal((m, k)).astype(
                np.float32)).to("cuda", torch.bfloat16)
            fn = lambda: quant.fused_dequant_matmul(x, w)  # noqa: E731
            ref = quant.dequant_matmul_reference(x, w).float()
            res["rel_err"][case] = ((fn().float() - ref).abs().max()
                                    / ref.abs().max()).item()
            res["ms"][case] = time_ms(torch, fn, flush)
            res["batched_us"][case] = batched_us(
                torch, lambda xx, q, s: quant.fused_dequant_matmul(
                    xx, quant.QuantizedWeight(q, s)), (x, w.qweight, w.scale))
            res["host_us"][case] = host_us(torch, fn)
    return res


def median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", metavar="NAME=ROOT")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker", metavar="ROOT", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(measure(args.worker)), flush=True)
        return
    trees = dict(t.split("=", 1) for t in args.trees)
    if not trees:
        ap.error("name at least one NAME=ROOT")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    names = list(trees)
    runs = {n: [] for n in names}
    for _ in range(args.rounds):
        for name in names + names[::-1]:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 os.path.abspath(trees[name])],
                capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                sys.stderr.write(proc.stdout + proc.stderr)
                raise SystemExit(f"tree {name} failed")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            res["tree"] = name
            print(json.dumps(res), flush=True)
            runs[name].append(res)
    cases = list(runs[names[0]][0]["ms"])
    summary = {
        name: {"us": {c: 1e3 * median([r["ms"][c] for r in rs])
                      for c in cases},
               "batched_us": {c: median([r["batched_us"][c] for r in rs])
                              for c in cases},
               "batched_us_min_max": {
                   c: [min(r["batched_us"][c] for r in rs),
                       max(r["batched_us"][c] for r in rs)] for c in cases},
               "host_us": {c: median([r["host_us"][c] for r in rs])
                           for c in cases},
               "rel_err": {c: max(r["rel_err"][c] for r in rs)
                           for c in cases}}
        for name, rs in runs.items()}
    print(json.dumps({"medians": summary}), flush=True)


if __name__ == "__main__":
    main()
