#!/usr/bin/env python3
"""Kernels B and E (flash attention) and F and G (block-sparse flash
attention) of several source trees, timed in turns on one NVIDIA GPU.

    python3 flash_ab.py NAME=ROOT [NAME=ROOT ...] [--uncapped NAME]
                        [--rounds N]

Each ROOT is a directory that holds a `deepspeed_tpu_torch/` package: this
checkout, or another commit's unpacked there with `git archive`.
`--uncapped NAME` adds the tree `NAME-uncapped`, a copy of NAME's package
under build/flash_ab/ whose tensor-core attention kernels (B, E, F, G)
lose their register caps (the second argument of their
`__launch_bounds__`).

Every tree is measured in a process of its own, which builds its kernels
at first use into ROOT/build/torch_kernels/.  The host's speed drifts
within a run, so the processes run in turns: the trees in order, then in
reverse (A, B, B, A), N times.  Each process measures, in bf16 on the
fused-QKV head views the layer passes, causal:

- host_us: host µs per call of flash_attention_cuda (B) and of
  flash_attention_bwd_dkdv_cuda and flash_attention_bwd_dq_cuda (E's two
  launches) at the training shape, 200 calls enqueued back to back, the
  median of 5 such batches: what a launch costs the CPU, wrapper included;
- ms: device ms of the same three launches (CUDA events, median of 30,
  L2 flushed, a spin kernel under the enqueue, as chip_smoke.py times) at
  the training shape [8, 12, 1024, 64] and train_longseq's [2, 12, 8192,
  64], both with dropout 0.1, and serving prefill's [8, 12, 128, 64]
  without;
- ms of kernels F and G (the forward, and G's dq and dk/dv launches) at
  bench_sparse_longseq's attention: [2, 12, 8192, 64] causal BigBird
  (block 512, 1 random, 3 sliding-window and 1 global block), and their
  host_us there;
- for a tree whose kernels take D = 256 (KERNEL_HEAD_DIMS), the same at
  D = 256: B and E at [2, 12, 1024, 256] without dropout ("wide"), F and
  G at [2, 12, 8192, 256] BigBird ("bigbird_wide");
- for a tree whose kernels take any D (WIDE_CHUNK: the column-chunked
  kernels above D = 256), the same at D = 512: B and E at [2, 12, 1024,
  512] ("d512"), F and G at [2, 12, 2048, 512] BigBird ("bigbird_d512");
- prefill_err: max |B - mha_reference| at the prefill shape, and
  sparse_err: max |F - its plain twin| at the BigBird shape, to show that
  each tree computes attention.

Prints the card's name and power limit, one JSON line per process, and,
last, one JSON line of the medians per tree.
"""

import argparse
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# (batch, heads, seq, head dim, dropout rate)
SHAPES = {"train": (8, 12, 1024, 64, 0.1),
          "longseq": (2, 12, 8192, 64, 0.1),
          "prefill": (8, 12, 128, 64, 0.0)}
# timed only in a tree whose kernels take D = 256
WIDE_SHAPES = {"wide": (2, 12, 1024, 256, 0.0)}
# timed only in a tree whose kernels take any D
D512_SHAPES = {"d512": (2, 12, 1024, 512, 0.0)}
D512_SPARSE_SHAPE = (2, 12, 2048, 512)
HOST_SHAPE = "train"
LAUNCHES = ("fwd", "dkdv", "dq")
# kernels F and G: bench_sparse_longseq's attention
SPARSE_SHAPE = (2, 12, 8192, 64)
WIDE_SPARSE_SHAPE = (2, 12, 8192, 256)
BIGBIRD = dict(num_heads=12, block=512, num_random_blocks=1,
               num_sliding_window_blocks=3, num_global_blocks=1)
SPARSE_LAUNCHES = ("bsf_fwd", "bsf_dq", "bsf_dkdv")
TIMED_RUNS = 30
SPIN_CYCLES = 2_000_000  # ~1 ms of torch.cuda._sleep: longer than any enqueue
HOST_CALLS = 200
HOST_BATCHES = 5
CAPPED_SOURCES = ("flash_attention_fwd.cu", "flash_attention_bwd.cu",
                  "block_sparse_flash_fwd.cu", "block_sparse_flash_bwd.cu")


def strip_caps(src_root, dst_root):
    """Copy src_root's package to dst_root without the register caps of
    its attention kernels; raises if it has none."""
    if os.path.exists(dst_root):
        shutil.rmtree(dst_root)
    dst = os.path.join(dst_root, "deepspeed_tpu_torch")
    shutil.copytree(os.path.join(src_root, "deepspeed_tpu_torch"), dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    found = 0
    for name in CAPPED_SOURCES:
        path = os.path.join(dst, "csrc", name)
        with open(path) as f:
            text, n = re.subn(
                r"__launch_bounds__\((\w+), D == 64 \? \d+ : 1\)",
                r"__launch_bounds__(\1)", f.read())
        with open(path, "w") as f:
            f.write(text)
        found += n
    if not found:
        raise SystemExit(f"found no register caps in {src_root}")
    print(f"stripped {found} register caps from {src_root}", flush=True)


# --------------------------------------------------------------------- #
# one tree, in a process of its own
# --------------------------------------------------------------------- #
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


def measure(root):
    sys.path.insert(0, root)
    import torch
    # the module, not the function ops/__init__ exports under its name
    fa = importlib.import_module("deepspeed_tpu_torch.ops.flash_attention")
    if not os.path.abspath(fa.__file__).startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {fa.__file__}, not the tree at {root}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    seed = torch.tensor([1234], dtype=torch.int32, device="cuda")
    res = {"root": root, "ms": {}, "host_us": {}}
    wide = fa.KERNEL_HEAD_DIMS[-1] >= 256
    any_d = hasattr(fa, "WIDE_CHUNK")
    for shape, (b, h, s, d, rate) in {
            **SHAPES, **(WIDE_SHAPES if wide else {}),
            **(D512_SHAPES if any_d else {})}.items():
        g = torch.Generator(device="cuda").manual_seed(s)
        qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=g)
        q, k, v = (t.view(b, s, h, d).transpose(1, 2) for t in
                   qkv.to(torch.bfloat16).split(h * d, dim=-1))
        do = torch.randn(b, s, h, d, device="cuda", generator=g).to(
            torch.bfloat16).transpose(1, 2)
        kw = dict(causal=True, dropout_rate=rate, dropout_seed=seed)
        out, lse = fa.flash_attention_cuda(q, k, v, **kw)
        delta = (do.float() * out.float()).sum(dim=-1)
        fns = {"fwd": lambda: fa.flash_attention_cuda(q, k, v, **kw),
               "dkdv": lambda: fa.flash_attention_bwd_dkdv_cuda(
                   q, k, v, do, lse, delta, **kw),
               "dq": lambda: fa.flash_attention_bwd_dq_cuda(
                   q, k, v, do, lse, delta, **kw)}
        res["ms"][shape] = {n: time_ms(torch, fns[n], flush)
                            for n in LAUNCHES}
        if shape == HOST_SHAPE:
            res["host_us"] = {n: host_us(torch, fns[n]) for n in LAUNCHES}
        if shape == "prefill":
            ref = fa.mha_reference(q, k, v, causal=True)
            res["prefill_err"] = (out.float() - ref).abs().max().item()
    res["ms"]["bigbird"], sparse_host, res["sparse_err"] = measure_sparse(
        torch, flush, SPARSE_SHAPE)
    res["host_us"].update(sparse_host)
    if wide:
        res["ms"]["bigbird_wide"], _, wide_err = measure_sparse(
            torch, flush, WIDE_SPARSE_SHAPE, host=False)
        res["sparse_err"] = max(res["sparse_err"], wide_err)
    if any_d:
        res["ms"]["bigbird_d512"], _, wide_err = measure_sparse(
            torch, flush, D512_SPARSE_SHAPE, host=False)
        res["sparse_err"] = max(res["sparse_err"], wide_err)
    return res


def measure_sparse(torch, flush, shape, host=True):
    """(device ms, host µs (with `host`; else None), max error of F against
    its plain twin) of kernels F and G at `shape` [B, H, S, D]."""
    bsf = importlib.import_module(
        "deepspeed_tpu_torch.ops.sparse_attention.block_sparse_flash")
    sa = importlib.import_module("deepspeed_tpu_torch.ops.sparse_attention")
    b, h, s, d = shape
    block = BIGBIRD["block"]
    layout = sa.BigBirdSparsityConfig(**BIGBIRD).make_layout(s)
    fidx, fvalid = (torch.as_tensor(a, device="cuda")
                    for a in bsf.layout_gather(layout))
    tidx, tvalid = (torch.as_tensor(a, device="cuda")
                    for a in bsf.layout_gather(layout, transpose=True))
    g = torch.Generator(device="cuda").manual_seed(s + 1)
    qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=g)
    q, k, v = (t.view(b, s, h, d).transpose(1, 2) for t in
               qkv.to(torch.bfloat16).split(h * d, dim=-1))
    do = torch.randn(b, s, h, d, device="cuda", generator=g).to(
        torch.bfloat16).transpose(1, 2)
    out, lse = bsf.block_sparse_flash_fwd_cuda(q, k, v, fidx, fvalid, block,
                                               True)
    delta = (do.float() * out.float()).sum(dim=-1)
    fns = {"bsf_fwd": lambda: bsf.block_sparse_flash_fwd_cuda(
               q, k, v, fidx, fvalid, block, True),
           "bsf_dq": lambda: bsf.block_sparse_flash_bwd_dq_cuda(
               q, k, v, do, lse, delta, fidx, fvalid, block, True),
           "bsf_dkdv": lambda: bsf.block_sparse_flash_bwd_dkdv_cuda(
               q, k, v, do, lse, delta, tidx, tvalid, block, True)}
    ms = {n: time_ms(torch, fns[n], flush) for n in SPARSE_LAUNCHES}
    host = ({n: host_us(torch, fns[n]) for n in SPARSE_LAUNCHES} if host
            else None)
    ref = bsf.block_sparse_flash_fwd_reference(q, k, v, fidx, fvalid, block,
                                               True)[0]
    return ms, host, (out.float() - ref.float()).abs().max().item()


# --------------------------------------------------------------------- #
# the turns
# --------------------------------------------------------------------- #
def median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", metavar="NAME=ROOT")
    ap.add_argument("--uncapped", metavar="NAME")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker", metavar="ROOT", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(measure(args.worker)), flush=True)
        return
    trees = dict(t.split("=", 1) for t in args.trees)
    if not trees:
        ap.error("name at least one NAME=ROOT")
    if args.uncapped:
        dst = os.path.join(HERE, "build", "flash_ab",
                           f"{args.uncapped}-uncapped")
        strip_caps(trees[args.uncapped], dst)
        trees[f"{args.uncapped}-uncapped"] = dst
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
    summary = {}
    for name, rs in runs.items():
        summary[name] = {
            "host_us": {n: median([r["host_us"][n] for r in rs])
                        for n in rs[0]["host_us"]},
            "us": {shape: {n: 1e3 * median([r["ms"][shape][n] for r in rs])
                           for n in launches}
                   for shape, launches in rs[0]["ms"].items()},
            "prefill_err": max(r["prefill_err"] for r in rs),
            "sparse_err": max(r["sparse_err"] for r in rs)}
    print(json.dumps({"medians": summary}), flush=True)


if __name__ == "__main__":
    main()
