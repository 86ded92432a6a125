#!/usr/bin/env python3
"""The stage-2 offload tier's training step of several source trees, timed
in turns on one NVIDIA GPU.

    python3 offload_ab.py NAME=ROOT [NAME=ROOT ...] [--rounds N] [--steps N]

Each ROOT is a directory that holds a `deepspeed_tpu_torch/` package: this
checkout, or another commit's unpacked there with `git archive`.  Every
tree is measured in a process of its own, which builds its kernels at
first use into ROOT/build/.  The host's speed drifts within a run, so the
processes run in turns: the trees in order, then in reverse (A, B, B, A),
N times.  The model and config are bench.py::bench_offload's (GPT-2 124M
at S = 1024, micro-batch 8, bf16, AdamW lr 6e-4 weight decay 0.1,
offload_optimizer "cpu", gas 1, one rank), from one seed, in three rows:

- plain: that config (chip_smoke.py's train_offload row);
- clip: with gradient_clipping 1.0, so every step takes the global norm
  of the host grads;
- sentinel: clip, and the training-health sentinel (policy skip_step),
  whose norm is taken from the same host grads; a tree that refuses the
  pairing reports the row "refused".

Each row: 3 warm-up steps, then --steps steps (default 10), each one
`train_batch` timed on the host clock (it reads its loss, as the host
tier synchronises a step anyway): ms a step and tokens/s; host_adam_ms,
the median over the timed steps of the engine's `offload_split`
host_adam_ms (the tier's finite check, clip and native Adam); norm_ms,
the median of 5 calls of the tier's `global_grad_norm` over the host
grads after the steps.

Prints the card's name and power limit, one JSON line per process, and,
last, one JSON line of the medians per tree and row.
"""

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROWS = ("plain", "clip", "sentinel")
WARMUP = 3


def worker(root, steps):
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import GPT2Config, GPT2Model

    cfg = GPT2Config(vocab_size=50304, n_positions=1024, hidden_size=768,
                     num_layers=12, num_heads=12, bf16=True)
    init = GPT2Model(dataclasses.replace(cfg, bf16=False))
    init.init_params(torch.Generator().manual_seed(0))
    state = {k: v.detach().clone() for k, v in init.state_dict().items()}
    del init
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(8, cfg.n_positions)).astype(np.int32))

    def batches():
        while True:
            yield (ids,)

    base = {"train_micro_batch_size_per_gpu": 8,
            "gradient_accumulation_steps": 1,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 6e-4, "weight_decay": 0.1}},
            "bf16": {"enabled": True, "grads_in_compute_dtype": False},
            "zero_optimization": {"stage": 2,
                                  "offload_optimizer": {"device": "cpu"}},
            "steps_per_print": 10 ** 9, "mesh": {"data": 1}}
    confs = {"plain": base, "clip": dict(base, gradient_clipping=1.0),
             "sentinel": dict(base, gradient_clipping=1.0, resilience={
                 "enabled": True, "verify_lockstep_on_resume": False,
                 "sentinel": {"enabled": True, "policy": "skip_step"}})}
    out = {"root": root}
    for row in ROWS:
        dst.reset_mesh_context()
        try:
            engine = dst.initialize(model=GPT2Model(cfg),
                                    model_parameters=state,
                                    config=confs[row])[0]
        except NotImplementedError as exc:
            out[row] = {"refused": str(exc).splitlines()[0]}
            continue
        it = batches()
        losses = [engine.train_batch(it) for _ in range(WARMUP)]
        seconds, adam = 0.0, []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(engine.train_batch(it))
            seconds += time.perf_counter() - t0
            adam.append(engine.offload_split()["host_adam_ms"])
        tier = engine._offload.tier
        # the tier's module, loaded by the engine (a direct import first
        # can meet the swap package's import cycle)
        norm = sys.modules["deepspeed_tpu_torch.runtime.zero.offload"]
        norms = []
        for _ in range(5):
            t0 = time.perf_counter()
            norm.global_grad_norm(tier.leaf_map, engine._offload.host_grads)
            norms.append((time.perf_counter() - t0) * 1e3)
        if not all(np.isfinite(losses)):
            raise RuntimeError(f"{row}: losses {losses}")
        out[row] = {"ms_per_step": seconds / steps * 1e3,
                    "tokens_per_s": steps * ids.numel() / seconds,
                    "host_adam_ms": float(np.median(adam)),
                    "norm_ms": float(np.median(norms)),
                    "final_loss": losses[-1]}
        del engine, tier
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*", metavar="NAME=ROOT")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--worker", metavar="ROOT", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(os.path.abspath(args.worker), args.steps)
    if not args.trees:
        ap.error("name at least one NAME=ROOT")
    trees = [t.split("=", 1) for t in args.trees]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    runs = {name: [] for name, _ in trees}
    for _ in range(args.rounds):
        for name, root in trees + trees[::-1]:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 os.path.abspath(root), "--steps", str(args.steps)],
                capture_output=True, text=True, cwd=os.path.abspath(root))
            if proc.returncode != 0:
                sys.stderr.write(proc.stderr[-4000:])
                raise SystemExit(f"{name}: exit {proc.returncode}")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            res["name"] = name
            print(json.dumps(res), flush=True)
            runs[name].append(res)
    summary = {}
    for name, results in runs.items():
        summary[name] = {}
        for row in ROWS:
            got = [r[row] for r in results if "refused" not in r[row]]
            summary[name][row] = ({k: statistics.median(g[k] for g in got)
                                   for k in ("ms_per_step", "tokens_per_s",
                                             "host_adam_ms", "norm_ms")}
                                  if got else "refused")
    print(json.dumps({"card": card, "medians": summary}), flush=True)


if __name__ == "__main__":
    main()
