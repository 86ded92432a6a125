#!/usr/bin/env python3
"""Kernels H, I and J (the fused collective-matmul's tile products and J's
collect) of several source trees, timed in turns on one NVIDIA GPU.

    python3 fcm_ab.py NAME=ROOT [NAME=ROOT ...] [--rounds N]

Each ROOT is a directory that holds a `deepspeed_tpu_torch/` package: this
checkout, or another commit's unpacked there with `git archive`.  Every
tree is measured in a process of its own, which builds its kernels at
first use into ROOT/build/torch_kernels/.  The host's speed drifts within
a run, so the processes run in turns: the trees in order, then in reverse
(A, B, B, A), N times.  Each process measures, at GPT-2 124M's c_fc tile
at W = 4 (m = 2048 rows, a [192, 3072] weight shard, int8 payload with
blocks of 256, bf16 operands), the launches

- H: `fcm_tile_ag` (x @ deq), `fcm_tile_ag_t` (g @ deq^T), `fcm_tile_rs`
  (a^T b), kernel H's per-tile products;
- I: `fcm_ag_step` (a step that reads and writes the fp32 accumulator),
  `fcm_ag_step_t` (the transposed step into dx's column block);
- J: `fcm_rs_producer` (a^T b + error rows, quantized blockwise), and
  `fcm_rs_collect` of W = 4 seeded int8 tables of that tile with fp32
  scales per 256 (`rs_collect`) and, off the path, of a [2048, 3072] tile
  (`rs_collect_2048`, ~50 MB moved, well above the timers' floors),

as ms: device ms (CUDA events, median of 30, L2 flushed, a spin kernel
under the enqueue, as chip_smoke.py times), and host_us: host µs per call
(200 calls enqueued back to back, the median of 5 such batches), and
rel_err: max|d| / max|ref| of each against its plain twin, to show that
each tree computes the product (the collect's must be 0: it is bitwise).
The collects also report device_us, the device µs of the one kernel of a
launch by torch.profiler with the L2 flushed first (cold tables; median of
5 sessions), device_us_warm, the same with the tables still in L2 from the
call before (as on the path, where the producers have just written them),
and batched_us, device µs per launch of 64 launches under one pair of CUDA
events after a spin kernel, rotating over copies of the tables that exceed
twice the L2 (cold HBM), median of 5, as chip_smoke.py's batched timer.

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

M, KC, N, BITS, BLOCK = 2048, 192, 3072, 8, 256
COLLECTS = {"rs_collect": (KC, N), "rs_collect_2048": (2048, N)}
LAUNCHES = ("tile_ag", "tile_ag_t", "tile_rs", "ag_step", "ag_step_t",
            "rs_producer") + tuple(COLLECTS)
TIMED_RUNS = 30
SPIN_CYCLES = 2_000_000  # ~1 ms of torch.cuda._sleep: longer than any enqueue
HOST_CALLS = 200
HOST_BATCHES = 5
WORLD = 4
L2_BYTES = 50 * 2 ** 20
BATCH_LAUNCHES = 64
BATCH_SPIN_CYCLES = 8 * SPIN_CYCLES
PROFILER_SESSIONS = 5


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
    for _ in range(HOST_BATCHES):
        torch.cuda._sleep(BATCH_SPIN_CYCLES)
        start.record()
        for i in range(BATCH_LAUNCHES):
            fn(*copies[i % len(copies)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / BATCH_LAUNCHES)
    return sorted(times)[HOST_BATCHES // 2]


def device_us(torch, fn, flush=None):
    """The names of the device kernels of fn() other than a fill, and the
    median µs of the one such kernel over PROFILER_SESSIONS torch.profiler
    sessions (a session that recorded another count is left out); with
    `flush`, zeroed first, the L2 holds none of fn's operands."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    names, times = set(), []
    for _ in range(PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            if flush is not None:
                flush.zero_()
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                  and "spin_kernel" not in e.name and "Fill" not in e.name]
        names.update(e.name for e in events)
        if len(events) == 1:
            times.append(events[0].time_range.elapsed_us())
    return sorted(names), (sorted(times)[len(times) // 2] if times else None)


def measure(root):
    sys.path.insert(0, root)
    import torch
    cm = importlib.import_module("deepspeed_tpu_torch.ops.collective_matmul")
    if not os.path.abspath(cm.__file__).startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {cm.__file__}, not the tree at {root}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(7)
    bf = torch.bfloat16
    w = (torch.randn(KC, N, device="cuda", generator=g) / 8).to(bf)
    q, s = cm._quantize_shard(w, BITS, BLOCK)
    q = q.contiguous()
    x = torch.randn(M, 4 * KC, device="cuda", generator=g).to(bf)[:, KC:2 * KC]
    gr = torch.randn(M, N, device="cuda", generator=g).to(bf)
    acc = torch.randn(M, N, device="cuda", generator=g)
    dx = torch.empty(M, 4 * KC, device="cuda", dtype=bf)[:, KC:2 * KC]
    err = 0.1 * torch.randn(KC, N, device="cuda", generator=g)
    bs = BLOCK
    nb = KC * N // bs
    qo = torch.empty(nb, bs, dtype=torch.int8, device="cuda")
    so = torch.empty(1, nb, device="cuda")
    ne = torch.empty(KC, N, device="cuda")
    acc_in = acc.clone()
    fns = {
        "tile_ag": lambda: cm.fcm_tile_ag_cuda(x, q, s, BITS, KC, N),
        "tile_ag_t": lambda: cm.fcm_tile_ag_t_cuda(gr, q, s, BITS, KC, N),
        "tile_rs": lambda: cm.fcm_tile_rs_cuda(x, gr),
        "ag_step": lambda: cm.fcm_ag_step_cuda(x, q, s, BITS, KC, N, acc,
                                               None, False, False),
        "ag_step_t": lambda: cm.fcm_ag_step_t_cuda(gr, q, s, BITS, KC, N, dx),
        "rs_producer": lambda: cm.fcm_rs_producer_cuda(x, gr, err, qo, so, ne,
                                                       bs)}
    deq = cm._dequant_tile(q, s, KC, N, BITS)
    xf, gf = x.float(), gr.float()

    def rel(a, b):
        return ((a.float() - b).abs().max() / b.abs().max()).item()

    res = {"root": root, "rel_err": {
        "tile_ag": rel(fns["tile_ag"](), xf @ deq),
        "tile_ag_t": rel(fns["tile_ag_t"](), gf @ deq.t()),
        "tile_rs": rel(fns["tile_rs"](), xf.t() @ gf)}}
    acc.copy_(acc_in)
    fns["ag_step"]()
    res["rel_err"]["ag_step"] = rel(acc, acc_in + xf @ deq)
    fns["ag_step_t"]()
    res["rel_err"]["ag_step_t"] = rel(dx, gf @ deq.t())
    fns["rs_producer"]()
    comp = xf.t() @ gf + err
    res["rel_err"]["rs_producer"] = rel(
        (qo.float() * so.reshape(nb, 1)).reshape(KC, N), comp)
    res["device_kernels"], res["device_us"], res["batched_us"] = {}, {}, {}
    res["device_us_warm"] = {}
    for name, (kc, n) in COLLECTS.items():
        nb = kc * n // bs
        qtab = torch.randint(-127, 128, (WORLD, nb, bs), device="cuda",
                             generator=g, dtype=torch.int8)
        stab = torch.rand(WORLD, 1, nb, device="cuda", generator=g) / 64
        collect = (lambda q, sc, kc=kc, n=n:
                   cm.fcm_rs_collect_cuda(q, sc, kc, n))
        fns[name] = lambda f=collect, q=qtab, sc=stab: f(q, sc)
        res["rel_err"][name] = rel(fns[name](), cm.fcm_rs_collect_reference(
            qtab, stab, kc, n))
        res["device_kernels"][name], res["device_us_warm"][name] = \
            device_us(torch, fns[name])
        res["device_us"][name] = device_us(torch, fns[name], flush)[1]
        res["batched_us"][name] = batched_us(torch, collect, (qtab, stab))
    res["ms"] = {n: time_ms(torch, fns[n], flush) for n in LAUNCHES}
    res["host_us"] = {n: host_us(torch, fns[n]) for n in LAUNCHES}
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
    summary = {
        name: {"us": {n: 1e3 * median([r["ms"][n] for r in rs])
                      for n in LAUNCHES},
               "us_min_max": {n: [1e3 * min(r["ms"][n] for r in rs),
                                  1e3 * max(r["ms"][n] for r in rs)]
                              for n in LAUNCHES},
               "host_us": {n: median([r["host_us"][n] for r in rs])
                           for n in LAUNCHES},
               "rel_err": {n: max(r["rel_err"][n] for r in rs)
                           for n in LAUNCHES},
               **{key: {n: median([r[key][n] for r in rs
                                   if r[key][n] is not None]
                                  or [float("nan")])
                        for n in COLLECTS}
                  for key in ("device_us", "device_us_warm")},
               "batched_us": {n: median([r["batched_us"][n] for r in rs])
                              for n in COLLECTS},
               "device_kernels": {n: sorted({k for r in rs
                                             for k in r["device_kernels"][n]})
                                  for n in COLLECTS}}
        for name, rs in runs.items()}
    print(json.dumps({"medians": summary}), flush=True)


if __name__ == "__main__":
    main()
