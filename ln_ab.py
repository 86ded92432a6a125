#!/usr/bin/env python3
"""Kernels A and D (the LayerNorm forward and backward) of several source
trees, timed in turns on one NVIDIA GPU.

    python3 ln_ab.py NAME=ROOT [NAME=ROOT ...] [--rounds N]

Each ROOT is a directory that holds a `deepspeed_tpu_torch/` package: this
checkout, or another commit's unpacked there with `git archive`.  Every
tree is measured in a process of its own, which builds its kernels at
first use into ROOT/build/torch_kernels/.  The host's speed drifts within
a run, so the processes run in turns: the trees in order, then in reverse
(A, B, B, A), N times.  Each process measures, at GPT-2 124M's width
(hidden 768, bf16 x):

- `layer_norm_cuda` at decode's 8 rows, prefill's 1024 and the train
  step's 8192, with fp32 gamma and beta (the serving layout) and, at 8192,
  bf16 (the training layout);
- `layer_norm_bwd_cuda` at the train step's 8192 rows and train_longseq's
  16384, bf16 gamma (the training layout);

with two timers:

- us: device µs of one call (CUDA events, median of 30, L2 flushed, a
  spin kernel under the enqueue, as chip_smoke.py's time_ms), whose floor
  is the events' own ~8 µs;
- batched_us: device µs per call of 64 calls back to back under one pair
  of events after a longer spin kernel, rotating over copies of the
  operands that together exceed twice the 50 MB L2 (each call reads them
  cold from HBM), the median of 5 batches (chip_smoke.py's batched_us);

and host_us: host µs per call (200 calls enqueued back to back, the median
of 5 such batches), and rel_err: max|d| / max|ref| of the output (dx for
D) against the plain twin.  Each process also times the same work by one
PyTorch call, F.layer_norm and aten's native_layer_norm_backward (the
`library` entries, the same in every tree).

Host µs differ between processes by more than between trees, so one more
process imports every tree, each under a name of its own, and times the
host µs of the same calls (and of `fused_layer_norm` without autograd at
decode's 8 rows, the serving path) in turns within that process: a batch
of 200 calls of each tree, the trees in order and then in reverse, 40
times (`host_turns`: each tree's median and minimum µs per call, and the
median of each turn's difference from the first tree).

Prints the card's name and power limit, one JSON line per process, then
the host_turns line, and, last, one JSON line of the medians per tree.
"""

import argparse
import importlib
import json
import os
import subprocess
import sys
import time

HIDDEN = 768
FWD_CASES = ((8, "fp32"), (1024, "fp32"), (8192, "fp32"), (8192, "bf16"))
BWD_ROWS = (8192, 16384)
TIMED_RUNS = 30
SPIN_CYCLES = 2_000_000  # ~1 ms of torch.cuda._sleep: longer than any enqueue
BATCH_LAUNCHES = 64
BATCH_SPIN_CYCLES = 8 * SPIN_CYCLES
BATCH_ROUNDS = 5
L2_BYTES = 50 * 2 ** 20
HOST_CALLS = 200
HOST_BATCHES = 5
HOST_TURNS = 40


def time_us(torch, fn, flush):
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
        times.append(start.elapsed_time(end) * 1e3)
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


def rel_err(out, ref):
    return ((out.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


def measure(root):
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F
    nz = importlib.import_module("deepspeed_tpu_torch.ops.normalize")
    if not os.path.abspath(nz.__file__).startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {nz.__file__}, not the tree at {root}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    res = {"root": root, "us": {}, "batched_us": {}, "host_us": {},
           "rel_err": {}, "library_us": {}, "library_batched_us": {}}

    def inputs(rows, pdtype, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn(rows, HIDDEN, device="cuda", generator=g)
        dy = torch.randn(rows, HIDDEN, device="cuda", generator=g)
        gamma = 1.0 + 0.1 * torch.randn(HIDDEN, device="cuda", generator=g)
        beta = 0.1 * torch.randn(HIDDEN, device="cuda", generator=g)
        return (x.to(torch.bfloat16), dy.to(torch.bfloat16), gamma.to(pdtype),
                beta.to(pdtype))

    for rows, pname in FWD_CASES:
        case = f"A [{rows},{HIDDEN}] gamma {pname}"
        x, _, gamma, beta = inputs(rows, dtypes[pname], rows)
        fn = lambda: nz.layer_norm_cuda(x, gamma, beta)  # noqa: E731
        res["rel_err"][case] = rel_err(
            fn(), nz.layer_norm_reference(x, gamma, beta))
        res["us"][case] = time_us(torch, fn, flush)
        res["batched_us"][case] = batched_us(
            torch, lambda xx, gg, bb: nz.layer_norm_cuda(xx, gg, bb),
            (x, gamma, beta))
        res["host_us"][case] = host_us(torch, fn)
        g16, b16 = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)
        lib = lambda: F.layer_norm(x, (HIDDEN,), g16, b16)  # noqa: E731
        res["library_us"][case] = time_us(torch, lib, flush)
        res["library_batched_us"][case] = batched_us(
            torch, lambda xx, gg, bb: F.layer_norm(xx, (HIDDEN,), gg, bb),
            (x, g16, b16))
    for rows in BWD_ROWS:
        case = f"D [{rows},{HIDDEN}] gamma bf16"
        x, dy, gamma, beta = inputs(rows, torch.bfloat16, rows + 1)
        fn = lambda: nz.layer_norm_bwd_cuda(x, gamma, dy)  # noqa: E731
        res["rel_err"][case] = rel_err(
            fn()[0], nz.layer_norm_bwd_reference(x, gamma, dy)[0])
        res["us"][case] = time_us(torch, fn, flush)
        res["batched_us"][case] = batched_us(
            torch, lambda xx, gg, dd: nz.layer_norm_bwd_cuda(xx, gg, dd),
            (x, gamma, dy))
        res["host_us"][case] = host_us(torch, fn)
        _, mean, rstd = torch.ops.aten.native_layer_norm(
            x, [HIDDEN], gamma, beta, 1e-5)
        lib = lambda xx, dd, gg, bb, mm, rr: (  # noqa: E731
            torch.ops.aten.native_layer_norm_backward(
                dd, xx, [HIDDEN], mm, rr, gg, bb, [True, True, True]))
        res["library_us"][case] = time_us(
            torch, lambda: lib(x, dy, gamma, beta, mean, rstd), flush)
        res["library_batched_us"][case] = batched_us(
            torch, lib, (x, dy, gamma, beta, mean, rstd))
    return res


def import_tree(root, alias):
    """The tree's deepspeed_tpu_torch package, imported as `alias` (its
    modules import one another relatively, so each tree keeps its own)."""
    import importlib.util
    pkg = os.path.join(os.path.abspath(root), "deepspeed_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return importlib.import_module(alias + ".ops.normalize")


def host_turns(trees):
    """Host µs per call of every tree's wrappers, in turns in one process."""
    import torch
    mods = {name: import_tree(root, f"ln_ab_tree_{i}")
            for i, (name, root) in enumerate(trees.items())}
    g = torch.Generator(device="cuda").manual_seed(0)
    calls = {}
    for rows in (8, 1024, 8192):
        x = torch.randn(rows, HIDDEN, device="cuda",
                        generator=g).to(torch.bfloat16)
        gamma = 1.0 + 0.1 * torch.randn(HIDDEN, device="cuda", generator=g)
        beta = 0.1 * torch.randn(HIDDEN, device="cuda", generator=g)
        calls[f"A [{rows},{HIDDEN}] gamma fp32"] = {
            n: (lambda nz=nz, x=x, gamma=gamma, beta=beta:
                nz.layer_norm_cuda(x, gamma, beta))
            for n, nz in mods.items()}
        if rows == 8:
            calls[f"fused_layer_norm no grad [{rows},{HIDDEN}] gamma fp32"] = {
                n: (lambda nz=nz, x=x, gamma=gamma, beta=beta:
                    nz.fused_layer_norm(x, gamma, beta))
                for n, nz in mods.items()}
    x = torch.randn(8192, HIDDEN, device="cuda", generator=g).to(torch.bfloat16)
    dy = torch.randn_like(x)
    gamma = (1.0 + 0.1 * torch.randn(HIDDEN, device="cuda",
                                     generator=g)).to(torch.bfloat16)
    calls[f"D [8192,{HIDDEN}] gamma bf16"] = {
        n: (lambda nz=nz: nz.layer_norm_bwd_cuda(x, gamma, dy))
        for n, nz in mods.items()}
    names = list(mods)
    out = {}
    with torch.no_grad():
        for case, fns in calls.items():
            for fn in fns.values():
                fn()
            torch.cuda.synchronize()
            per = {n: [] for n in names}
            for turn in range(HOST_TURNS):
                for n in (names if turn % 2 == 0 else names[::-1]):
                    fn = fns[n]
                    t0 = time.perf_counter()
                    for _ in range(HOST_CALLS):
                        fn()
                    per[n].append((time.perf_counter() - t0) / HOST_CALLS
                                  * 1e6)
                    torch.cuda.synchronize()
            out[case] = {n: {"median_us": median(v), "min_us": min(v),
                             "median_diff_us": median(
                                 [a - b for a, b in zip(v, per[names[0]])])}
                         for n, v in per.items()}
    return out


def median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", metavar="NAME=ROOT")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker", metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--host-turns", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(measure(args.worker)), flush=True)
        return
    if args.host_turns:
        trees = dict(t.split("=", 1) for t in args.trees)
        print(json.dumps({"host_turns": host_turns(trees)}), flush=True)
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
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--host-turns",
         *(f"{n}={os.path.abspath(trees[n])}" for n in names)],
        capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout + proc.stderr)
        raise SystemExit("the host turns failed")
    print(proc.stdout.strip().splitlines()[-1], flush=True)
    cases = list(runs[names[0]][0]["us"])
    keys = ("us", "batched_us", "host_us", "library_us",
            "library_batched_us")
    summary = {
        name: {**{k: {c: median([r[k][c] for r in rs]) for c in cases}
                  for k in keys},
               "batched_us_min_max": {
                   c: [min(r["batched_us"][c] for r in rs),
                       max(r["batched_us"][c] for r in rs)] for c in cases},
               "rel_err": {c: max(r["rel_err"][c] for r in rs)
                           for c in cases}}
        for name, rs in runs.items()}
    print(json.dumps({"medians": summary}), flush=True)


if __name__ == "__main__":
    main()
