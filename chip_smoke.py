#!/usr/bin/env python3
"""Smoke run of the PyTorch port (deepspeed_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each printing one JSON line before the next starts (a failing
phase prints {"phase": ..., "ok": false, "error": ...} and the script exits
1 without a result):

1. device: the card's name and power limit (nvidia-smi), TF32 off, and the
   build of deepspeed_tpu_torch/csrc/*.cu into build/torch_kernels/; the
   two cuobjdump dumps of the built library start here in the background,
   and a `device_resources` line after phase 2 prints what they read
   (registers, stack bytes, SASS counts), in every mode.
2. parity: every kernel against its plain PyTorch twin on the same CUDA
   tensors at the serving and training paths' shapes, with the tolerances
   below.  Each case is timed with CUDA events (median device time of 30
   runs after a warm-up, L2 flushed and the card kept busy while the host
   enqueues, so the events see the device alone), beside its bound, one
   PyTorch library call as a yardstick (the plain twin and the library call
   median of 5 runs), and the host's cost of one launch (host_us).  That
   timer cannot see below its own ~8 µs, so kernel C's and
   LayerNorm's bf16 cases add a batched timer (batched_us: 64 launches
   under one pair of events after a spin kernel, rotating over copies of
   the operands that exceed twice the L2, so that each launch reads cold
   HBM) of the kernel and of the library call (the dense bf16 matmul on the
   pre-dequantized weight; F.layer_norm), LayerNorm at 8, 1024 and 8192
   rows.  Kernel C runs at GPT-2's four int8 products ([768, 2304], [768,
   768], [768, 3072], [3072, 768]) at M = 1, 8, 77 and 1024, groups 1 and
   8, bf16 and fp32; each case names the kernel its launcher took (gemv
   and gemv_mma at decode, mma at a bf16 prefill, tiled), holds the
   launcher's plan (ds_dequant_matmul_plan) to ops/quant.py dequant_plan's
   and repeats bitwise, and one launch of each route shows its device
   kernel (torch.profiler).  Kernel B with dropout and kernel E are held
   against their
   twins exactly mask for mask (the keep mask is a pure function of the
   seed and the coordinates), and the mask's keep share must lie within
   4 sigma of 230/256; kernels D, E and G must repeat bitwise.  B, E, F and
   G name their route (bf16 on the tensor cores, fp32 on the CUDA cores)
   and run at every head dim they are compiled for (32, 64, 96, 128, 256),
   at D = 40, 80 and 136 (which run the next instantiation up, zero-filled
   past D), at D = 36 (which the bf16 route pads to 40 in the wrapper) and
   at D = 264, 320 and 512 (the wide kernels, csrc/attention_wide.cuh, on
   the CUDA cores in either dtype, their route named cuda_cores_wide) in
   both dtypes; B and E also at [2, 12, 1024, 256] causal bf16 beside
   SDPA's flash forward and backward, and at [2, 12, 1024, 512] beside the
   SDPA backend that takes D = 512 (named); B and E report their achieved
   TFLOP/s beside the library call's; B's dropout cases also time the call
   without dropout; one case each runs train_longseq's S = 8192 (batch 1,
   4 heads, so that the plain twin's [S, S] fp32 scores take 1 GiB).  The realigned_operand cases
   launch B, E, F and G with a bf16 operand off the 16-byte boundary the
   tensor-core route needs: the wrapper copies it, once a launch, and the
   result equals the aligned call's bitwise.  The device phase reports the
   registers and stack (spill) bytes per thread of B's, E's, F's and G's
   kernels on both routes, as cuobjdump reads them from the built library,
   of the wide attention kernels and kernel C's GEMVs, and of the
   tensor-core kernels of C's prefill, H, I and J with the count of HMMA
   instructions in their SASS (the phase fails if one has none), and of
   kernels A's and D's device kernels (layer_norm_resources), and of
   kernel J's collect kernels with their counts of global loads and
   stores in the SASS (collect_resources).
   Kernels A and D (LayerNorm forward and backward) run at hidden 768,
   1024, 1600, 4096, 8192 and 771 (the scalar route) at 8, 77 and 1024
   rows, x and gamma / beta each in bf16 and fp32, at 16385 and 20000
   (the streamed route) at 8 and 1024 rows, at GPT-2 medium's and large's
   training shapes ([8192, 1024] and [4096, 1280], bf16, fp32 gamma,
   timed), and with an fp16 run's fp16 gamma and beta at [8192, 768]
   (timed), [8, 768] fp32 x, [77, 771] and (D) [8, 16385]: within 2e-2
   (bf16) or 1e-5 (fp32) of the plain twins, D's dgamma and dbeta within 1e-4 of
   max|ref| past the one rounding into gamma's dtype, in gamma's dtype, D
   bitwise on a repeat;
   each case names its route and holds the wrapper's plan
   (layer_norm_plan) to the launcher's (ds_layer_norm_plan).  Hidden 768
   is timed, A's bf16 cases and D's at the train step's and
   train_longseq's rows (8192, 16384) also on the batched timer beside
   F.layer_norm and aten's native_layer_norm_backward.  The
   layer_norm_kernels group reads, by torch.profiler, the device kernels
   of one call and the device µs of each: A exactly one, D at most two, no
   cast, copy or fill, by a direct call and through fused_layer_norm's
   autograd on the training layout.
   Two repairs are held here too.  sparse_gather: SparseSelfAttention at
   layout blocks 16 and 32 (which kernels F and G cannot tile), [2, 12,
   1024, 64] bf16, causal and not, takes the gather path on the card,
   counted once a call on SparseSelfAttention.gathered with F and G
   launched 0 times, out and the grads of q, k, v within 2e-2 / 5e-2 of
   the port's CPU fp32 run.  dequant_matmul_grad: kernel C's backward (an
   autograd Function) at M = 8 and 1024, [768, 3072], bf16, groups 1 and
   8: a grad_fn, one launch, the grads of x and of the scales within 5e-2
   of the plain twin's autograd on the card; int8_layer_grad: a GPT-2
   124M layer with int8 weights, forward and backward on [8, 128, 768],
   against the CPU fp32 run (out 2e-2, every grad 5e-2), C launched 4
   times.
3. serve_bf16: GPT-2 124M at full width (hidden 768, 12 layers, 12 heads,
   vocab 50304, n_positions 256, bf16, weights from seed 0) through
   init_inference -> forward / generate: batch 8, prompt 128, 128 new
   tokens, greedy.  The forward's logits, and the head logits of a
   prefill and 127 decode steps fed the reference's greedy tokens, are held
   against the same weights run through the port in fp32 with every
   kernel's plain version in its place, on the card with TF32 off
   (max|d| / max|ref| <= 2e-2 each), and the launch counters must show the
   kernels ran: 12 flash and 25 * 128 = 3200 LayerNorm launches per
   generate.  On this and every training path below, the attention
   wrappers' realigned counters (B, E, F, G, and the tensor-core routes of
   I and J) must stay 0: the layer's own views meet the 16-byte rule, and
   no operand is copied.
4. serve_int8: the same with quantization_setting=1 (4 * 12 * 128 = 6144
   dequant-matmul launches per generate), held against the fp32 reference
   on the dequantized int8 weights.
5. timing: prefill ms and decode tokens/s of both engines, timed in turns
   (bf16, int8, int8, bf16, ...) since the host's speed drifts during a
   run; medians with min and max.
6. profile: the device-busy share of prefill and of a decode step of both
   engines (torch.profiler), after the timing, and kernel C's device ms in
   a decode step and its share of the step's device time.
7. train_grads: GPT-2 124M at full width (n_positions 1024), batch 2 x
   1024, dropout off, weights from seed 0, through initialize -> forward ->
   backward on the card in bf16, held against the same weights through the
   port in fp32 with every kernel's plain PyTorch version in its place (the
   code the CPU tests hold against the JAX package; run on the card, TF32
   off): the loss within max|d|/max|ref| <= 2e-2, every
   parameter's grad within 5e-2 (the chip-lane tolerances of
   tests/tpu/test_kernel_parity_tpu.py), and one step's launch counters
   exact: LN forward 25, LN backward 25, flash forward 12, flash backward
   12 + 12.
8. train: bench.py::bench_gpt2's model and config exactly (batch 8 x 1024,
   bf16, AdamW lr 6e-4 wd 0.1, ZeRO-2, dropout 0.1 inside kernel B) on the
   fixed batch RandomState(0).randint(0, 50304, (8, 1024)), timed as
   bench.py's _time_steps: 3 warm-up steps, then 30 forward / backward /
   step calls on the host clock, closed by fetching the last loss.
   tokens/s, ms per step, MFU against the H100's 989 TFLOP/s bf16 peak,
   first and final loss (every loss finite, the final below the first),
   peak device memory, exact launch counts per step, and one step under
   torch.profiler: its device-busy share, the six ops with the most
   device time, kernels A's and D's launches and device ms in the step,
   and the cast / copy and fill kernels that sit next to them.
9. train_sparse_grads: bench.py::bench_sparse_longseq's attention (BigBird,
   block 512, 1 random, 3 sliding-window and 1 global block) at full width
   (n_positions 8192) but SPARSE_GRADS_LAYERS deep, batch 1 x 8192,
   dropout off, held against the fp32 reference as train_grads is; counters
   exact (kernels F and G once per layer, B and E never).
10. train_sparse: bench_sparse_longseq exactly (12 layers, batch 2 x 8192,
   bf16, AdamW lr 6e-4 wd 0.1, ZeRO-2, dropout 0.1, on the attention
   output for the sparse layers) on the fixed batch
   RandomState(0).randint(0, 50304, (2, 8192)), timed as _run_longseq (2
   warm-up steps, 10 timed): what train reports, the MFU of the dense
   flops_per_token as the bench row counts it, and the layout's density.
11. train_longseq: bench_longseq, the same model, batch and timing with
   dense causal attention (kernels B and E) at S = 8192.

Parity (phase 2) also holds kernels F (block-sparse flash forward) and G
(its dq and dk/dv launches) against their plain twins, which compute in
fp32 on the same inputs: bench_sparse_longseq's attention with fused-QKV
views, the Fixed layout causal and not, D = 128, a layout with an empty
causal row (its out 0 and its lse at the mask value), a non-causal
BigBird, and D = 32, 96, 40, 80, 36, 136 and 256, in bf16 (the tensor
cores) and fp32 (the CUDA cores), and D = 264, 320 and 512 in both (the
wide kernels, CUDA cores); G's two launches must repeat bitwise;
the library yardstick is SDPA with the layout as a boolean mask.

12. fcm_ops: the low-bandwidth collective tier on a mesh of W = 4 logical
   ranks, all on this card (each rank its own compute and copy stream; the
   "wire" is a device-to-device copy, so nothing here says anything about
   NVLink or NCCL), at GPT-2 124M's width: `fused_allgather_matmul`
   forward and backward for c_attn [768, 2304], c_fc [768, 3072] and c_proj
   [3072, 768] row-sharded four ways, M = 2048 rows per rank, block 256,
   (qwz, qgz) = (8, 8), (4, 4), (0, 0), operands bf16 and fp32, the fused
   route (kernels I and J) and the per-tile route (kernel H);
   `fused_matmul_reduce_scatter` for the same dW shapes over six steps with
   the error buffers carried; the layer-2 transports bitwise against the
   modular functions on the card; and c_fc -> gelu -> c_proj as a whole.
   `realigned` stays 0.  Every result is held against the port's run on a
   CPU mesh on the same inputs in the same dtype (the plain twins multiply
   and accumulate in fp32 whatever the operands' dtype; an fp32 copy of
   bf16 inputs would take the quantizer's scale, which is rounded in the
   input's dtype, at another value): max|d| / max|ref| <= 2e-2 for bf16 operands and 1e-4 for
   fp32, and where a quantizer follows a product the one-step rule: the
   elements further off than that are at most 0.1% and each by at most the
   quantization steps of the tiles summed into it.  Launch counters are
   exact per op.
13. fcm_timing: the wall ms (median of FCM_TIMED_RUNS, synchronized at both
   ends) of each whole op at W = 4 on the one card, c_fc in bf16 at 8 bits:
   the fused route, the per-tile route and the modular yardstick
   (`low_bandwidth_all_gather` then `torch.matmul`; `torch.matmul` then
   `qgz_reduce_scatter_inner`), in turns; from torch.profiler traces of
   five calls each, the device ms of the products of the fused forward,
   of the fused reduce-scatter (its producers), and of the per-tile
   forward and reduce-scatter (kernel H's), and the share of the ring's
   copy time that lay under a product.

Parity also holds kernels H (its three tile launchers at the three
matrices' tiles, int8, packed int4 and native payloads; bf16 on the
tensor cores, fp32 on the CUDA cores, each launch repeating bitwise, the
bf16 cases with an int8 or int4 payload within FCM_FP32_DEQUANT_TOL of
the fp32 twin; and, from torch.profiler, the device kernels one launch of
each entry point ran: tile_mma.cuh's in bf16 and not tile_matmul.cuh's,
the reverse in fp32), I (the first
step, a step that accumulates, the last step's cast, the transposed step
writing a column block; bf16 on the tensor cores at every tile and
payload, fp32 on the CUDA cores) and J (the producer by the one-step rule,
bitwise on its own tile, at the three tiles and an odd shape in both
dtypes; the collect bitwise and bitwise on a repeat, its plan
(ds_fcm_rs_collect_plan) equal to collective_matmul.collect_plan's, at W = 4
of the three tiles and of (33, 50) (one element a thread), at W = 2, 8 and 9
and with a q table 4 bytes (4 elements a thread) and 2 bytes (one) off the
16-byte boundary at c_fc's tile, and at an off-path [2048, 3072] tile; at
c_fc's tile and the off-path one also the batched timer and the device
kernel and µs of one launch by torch.profiler, warm and cold in L2)
against their plain twins; I and J must
repeat bitwise, and I's bf16 cases with an int8 or int4 payload must also
lie within FCM_FP32_DEQUANT_TOL (1e-4) of the twin with an fp32
destination, which a single bf16 rounding of the dequantized weights would
miss; the library yardstick is `torch.matmul` on the dequantized
operand.

The train phases above pin `"mesh": {"data": 1}`: one rank, one card's
numbers on any host.  After phase 8:

14. train_dp_grads: GPT-2 124M (dropout off, bf16) through initialize ->
   forward / backward / step with `"mesh": {"data": 4}`: W = 4 ranks of
   the single-controller mesh over every visible card (all four on a
   one-card host, each on its own compute stream), 1 row each, at ZeRO-2
   and then ZeRO-1, against the port's one-rank engine on the card fed
   the same 4 rows: the mean loss within 2e-2, the reduce-scattered grad
   ranges concatenated (divided by W) within 5e-2 for every parameter,
   the parameters after the step within 5e-2 (max|d| / max|ref| over the
   buffer); ZeRO-1 and ZeRO-2 bitwise equal; every rank's parameters equal
   after the all-gather; the launch counters a step's counts times W.
15. train_dp: bench_gpt2's config with `"mesh": {"data": 4}` (ZeRO-2,
   micro-batch 8 a rank) on the global batch RandomState(0).randint(0,
   50304, (32, 1024)), dropout 0.1 in kernel B, timed as train: global
   and per-card tokens/s, ms a step, MFU over the cards in use, the host's
   time to issue a step after a synchronisation (on every train row),
   peak memory a card, the bytes rank 0 holds, and the device ms of one
   step's reduce-scatter and all-gather on the engine's buffers (CUDA
   events, and the kernels torch.profiler records of one call).

After phase 8 and after phase 15 (checkpoints in the JAX package's
layout, written under build/ and removed at the phase's end):

16. checkpoint: bench_gpt2's model and config: 3 steps on the batch of
   `train`, save_checkpoint, 3 more steps (run a); the engine freed, a new
   one from other weights (seed 1), load_checkpoint, the same 3 steps (run
   b).  The restored master buffer, Adam's mu, nu and count, the scaler
   and the generator equal what was saved bitwise, and run b's losses
   equal run a's bitwise; the launch counters 9 steps' counts.  Then
   init_inference(checkpoint=) in bf16 and int8 (quantization_setting=1)
   serves bench_decode's prompt (forward and a generate of 128 tokens):
   logits and tokens equal, bitwise, those of init_inference(
   model_parameters=) on the saved weights, the counters A and B, plus C
   under int8.  Seconds to save and to load (host clock, synchronised),
   bytes written, GB/s.
17. checkpoint_dp: one step of train_dp's config (W = 4, ZeRO-2) and a
   save; the engine freed, a one-rank engine from other weights loads it:
   the full parameters and optimizer state equal the W = 4 engine's
   gathered state bitwise; then one step at W = 1.  Save and load seconds
   and GB/s.

After phase 17, one process a card (torch.distributed over NCCL):

18. train_mp_grads: W = torch.cuda.device_count() worker processes of
   this script, started by `python -m torch.distributed.run --standalone
   --nproc_per_node W` (`--mp-worker`), each joining the group through
   `dst.init_distributed()` from torchrun's env (on one card the world is
   one process, which init_distributed leaves alone as the JAX module
   does: the worker then opens the one-process NCCL group itself, since
   NCCL refuses two ranks on one card).  GPT-2 124M (dropout off, bf16),
   1 row a process, one forward / backward / step at ZeRO-2 and ZeRO-1,
   against the single-controller engine in this process at "mesh":
   {"data": W} over the same cards on the same global rows: the losses,
   the grad ranges and the parameters after the step bitwise (predicted;
   the phase reports which are, and holds the rest at 2e-2 / 5e-2);
   every process's parameters equal, ZeRO-1 = ZeRO-2; each process's
   launch counters one step's counts.
19. train_mp: bench_gpt2's step (ZeRO-2, micro-batch 8 a process, dropout
   0.1 in kernel B) in W processes on the global batch
   RandomState(0).randint(0, 50304, (8W, 1024)), each process its rows,
   timed in every process as train: global and per-card tokens/s, ms a
   step, MFU over the cards, host issue ms, one profiled step's device ms,
   peak memory a card, each process's launch counters, and the device ms
   (CUDA events, the processes lined up by a barrier) of one step's
   reduce-scatter and all-gather over the group beside NCCL's own
   `reduce_scatter_tensor` on the same buffer.  A worker that fails, or a
   group that outlives its deadline, fails the phase.

Activation checkpointing and fp16 (train_fp16 after phase 8; the others
after phase 11):

20. train_fp16: bench_gpt2's row with `"fp16": {"enabled": true}` in place
   of bf16 (the model computes in bf16 on parameters rounded through fp16,
   so kernels A and D take fp16 gamma and beta), the dynamic scaler at its
   defaults (2^32, window 1000, hysteresis 2): steps one at a time until 5
   clean steps follow the skipped ones (at most 48): the skipped steps
   and the scale trajectory, each skipped step leaving the master buffer
   and Adam's state bitwise as they were, skipped_steps equal to them,
   the launch counters exact; a second engine with a window of 2 clean
   steps from a quarter of the settled scale, whose scale must double
   twice; then timed as train (3 + 30 steps from 2^32), its tokens/s
   beside train's of the same run.
21. train_remat_grads: one step of bench_gpt2_medium's config (GPT-2 355M:
   24 layers of 1024, 16 heads, batch 8 x 1024, dropout 0.1, AdamW, ZeRO-2)
   with and without activation_checkpointing from the same weights (seed
   0) and generator seed: loss, grads and the parameters after the step
   bitwise (else the differing parameters named and the pair held at 2e-2
   / 5e-2), counters exact for both (rematted: A 4L + 1, B 2L, D 2L + 1,
   E L + L), and each step's peak GiB.
22. train_medium: bench_gpt2_medium exactly (activation_checkpointing,
   batch 8 x 1024, bf16), timed as the long-context rows (2 + 10 steps):
   what train reports, MFU over flops_per_token (the model's, as bench.py
   counts it) and over the executed operations (the recompute adds each
   layer's forward), then the peak GiB of one step of a new engine
   without activation checkpointing (or that it ran out of memory).
23. train_large: bench_gpt2_large the same way (GPT-2 774M: 36 layers of
   1280, 20 heads, batch 4 x 1024, bf16 grads_in_compute_dtype).

train_large also splits one more step's memory (step_memory): what the
engine holds before it, the forward and backward's peak above that, and
the step's peak above what the backward left.

The fused whole step (one CUDA graph a window, runtime/fused_step.py) and
the resilience block (24-27 after phase 19, 28 after phase 23).  A
replay launches the graph's kernels without calling a wrapper, so the
launch counters of a fused run count its eager first window and the
capture's launch calls (which the capture records into the graph); a
torch.profiler trace of a replay counts kernels A, B, D and E by kernel
name, and each phase holds it against an eager window's counters:

24. train_fused_grads: bench_gpt2's config at gas 2 with dropout 0.1, with
   and without activation_checkpointing, then under fp16 from 2^32 (the
   first windows overflow): 3 windows from the same weights and generator
   seeds through the modular loop and through the fused step (the first
   window eager, then one capture and two replays).  Every window's
   loss, scale and skipped steps, and after the run the master buffer,
   Adam's state, the scaler and the generators, bitwise; one graph, the
   last replay's traced launches an eager window's; the graphed peak
   within the eager run's plus the static input buffers.  Then the same
   at 4 data-parallel ranks of one process on the card (ZeRO-2, one row
   a rank: train_fused_dp).
25. train_fused: bench.py::bench_gpt2_gas4 and bench_gpt2_gas4_fused
   exactly (gas 4, batch 8 x 1024), two engines from the same weights,
   timed as _bench_gpt2_gas (2 warm-up steps, then 8 train_batch calls,
   closed by the loss and a parameter read) in turns (modular, fused,
   fused, modular): tokens/s, MFU, host issue ms a step, one profiled
   step's device ms and busy share, peak GiB, and one replay's device
   time split by kernel name: kernels A, B, D, E, the GEMMs, the step
   (the kernels after the window's last D) and the rest (glue and casts).
26. train_fused_mp (also in --mp-only): the fused step at one process a
   card over NCCL (torchrun, as phase 18) at one process, gas 2, dropout
   0.1: its graphed windows bitwise against its eager process-group
   windows, one graph (the engine graphs no window across cards yet,
   ROADMAP A.6c).
27. resilience: bench_gpt2's 1.494 GB under fused_step and the resilience
   block: a save with atomic_checkpoints off and one with it on (staged,
   a size and CRC32 manifest, renamed), the manifest's CRC pass alone and
   a verified load, in seconds; then 3 windows,
   request_stop(), the 4th window saves emergency_step4 at its boundary
   and raises TrainingInterrupted; an engine from other weights resumes
   from the directory's latest tag, and its 2 windows, parameters, Adam's
   state and generators equal an uninterrupted run's bitwise.
28. train_fused_large: bench_gpt2_large under fused_step, timed as
   train_large (2 + 10 steps), beside train_large's numbers of this run.

The runtime monitor (deepspeed_tpu_torch/monitor/, the engine's `monitor`
and `tensorboard` blocks), after phase 27:

29. monitor: bench_gpt2 (3 + 30 steps) and bench_gpt2_gas4_fused (2 + 8
   windows), each as two engines from the same weights, without and with
   the monitor (every writer, the trace, a flush every 10 steps,
   heartbeats), timed in turns (plain, monitored, monitored, plain).  The
   monitored run's records: a step record a step, each loss the engine's
   returned loss after the monitor's 6-place rounding, dispatches_per_step
   2 (modular) or 1 (fused), the card's allocator as the memory source
   with the peak read at each flush, tokens/s within 5% of the host
   clock over the same steps; the CSV's columns; a valid trace.json with
   three phases a modular step or one fused_step(gas=4) span a window; a
   measured-only reconcile record a window and its degradation record; a
   heartbeat; the tensorboard backend that ran (or the JSONL fallback and
   its degradation record).  Kernels A, B, D and E run as often with the
   monitor as without it (counters; on the fused path a profiled replay's
   trace).  The monitor's per-step calls run under
   torch.cuda.set_sync_debug_mode("error") on every step that closes no
   window.  A profiler capture armed on purpose traces K = 2 steps into a
   Chrome trace whose A/B/D/E launches equal the counters (modular) or K
   replays' (fused).  Reported: monitored / unmonitored tokens/s, the
   monitor's host µs a step, ms a flush (and the batched loss read's
   share), and the fused step's issue split: its fused_step span (the
   batch copy and the replay) against train_batch's host time after a
   synchronisation, with the span's parts.
30. monitor_mp: bench_gpt2's step at one process a visible card
   (torchrun, as phase 18) with monitor.fleet and heartbeats, 20 steps:
   one window exchange a process a full window, at its boundary (over a
   gloo group the engine makes above one process; the local stack at
   one), rank 0's fleet_host and fleet records each window (at W = 1 the
   one-host summary), every process's heartbeat.
31. zero3_grads: GPT-2 at full width and 2 layers at ZeRO-3 on 4 ranks of
   one row each, dropout off, the `off` and `carried` plans: loss (2e-2)
   and every grad (5e-2) against the port's fp32 reference; off and carried
   bitwise equal; with dropout 0.1 carried bitwise off; launch counters a
   step's (carried: a rematted step's, its backward recomputes each
   group).
32. train_zero3: bench.py::bench_gpt2_zero3_stream and _carried exactly
   (4 ranks on the visible cards, global batch 8 x 1024, groups of 2
   layers), timed as phase 8, in turns: tokens/s, MFU, the plan, host
   issue ms and busy share, peak GiB, what rank 0 holds (beside ZeRO-2's
   on the same mesh), the gathered bytes' high-water mark against the
   plan's bound, a step's gathers and reduce-scatters.
33. train_zero3_fcm: bench.py::bench_gpt2_zero3_stream_fcm's engines
   exactly (the carried row with qwZ 8 / qgZ 8), the modular transports
   then the fused ones, 3 + 10 steps each: both rates, fcm_speedup, the
   trajectories bitwise equal.
34. checkpoint_zero3: the carried row saved after 3 steps; a stage-3
   resume at 4 ranks bitwise the uninterrupted run for 2 steps, a stage-2
   load on one rank holding the saved masters and Adam state bitwise and
   its next loss within 2e-2.  The resuming engine (configured for the
   sharded layout, atomic) also saves the sharded layout right after its
   load, for phase 42.
35. train_zero3_fused: graphed vs eager at stage 3 on one card (gas 2,
   dropout 0.1, off and carried), bitwise, a replay's launches traced.
36. offload_grads: bench_offload's model (dropout off, one row), 3 steps
   of the host tier (offload_optimizer cpu) against the device-resident
   stage-2 engine from the same weights (losses 2e-2, each leaf of the
   master's update 0.05 of the engine's, a skipped step above it);
   the NVMe tier bitwise the host tier (losses, device parameters,
   master, moments); a save resumed in a new engine bitwise; the native
   Adam's thread count, the aio backend and the swap directory's file
   system.
37. train_offload: bench.py::bench_offload at gas 1, timed as train, and
   at gas 4 over 3 + 10 steps: tokens/s beside train's, the step split (device, D2H, host
   Adam, H2D), peak GiB beside train's, the pinned host bytes, A/B/D/E a
   step (train's exactly).
38. train_offload_nvme: the same row with offload_optimizer nvme, 2 + 10
   steps: tokens/s, the sweep's read and write GB/s, exposed I/O s.
39. infinity_grads: bench_infinity's model (dropout off), 2 steps with
   offload_param cpu and nvme against the stage-2 engine with the host
   tier (losses 2e-2, the master's update as in 36); the launch counters
   a rematted step's.
40. train_infinity: bench.py::bench_infinity (bench_infinity_stream's
   buffer_count 2, dropout 0.1) at prefetch depth 2 and 0 in turns, 2 + 4
   steps each: the two trajectories and masters bitwise, tokens/s, at
   most 2 groups on the card, peak GiB, the swap report.
41. train_zero3_remat (after 32): train_zero3's engines with
   GPT2Config(activation_checkpointing=True), each layer of the stream
   recomputed in the backward, off and carried, 3 + 10 steps each: every
   loss and, after the warm-up, every rank's pieces, Adam state and
   generator bitwise train_zero3's run without recompute; tokens/s and
   peak GiB beside it; the gathered high-water mark within the plan's
   bound; A/B/D/E a rank-step (off: A 4L + 1, B 2L; carried: A 6L + 1,
   B 3L).
42. checkpoint_sharded (after 34): phase 34's run in the sharded layout
   with atomic checkpoints (`checkpoint.sharded: true`): the files and
   their manifest, a verified load into phase 34's resuming engine whose
   next 2 steps are bitwise the uninterrupted run, a stage-2 load on one
   rank (the resize) with the masters and Adam state bitwise, and
   consolidate_sharded_to_fp32 equal to the masters; save and load
   seconds, bytes and GB/s beside phase 34's consolidated ones.
43. tiled_linear (after 35): TiledLinear.from_dense at c_fc's width
   ([8192, 768] x [768, 3072] bf16, 4 x 4 tiles), forward and backward,
   against the dense x @ W + b in fp32 (output 2e-2, grads 5e-2); peak
   MiB and device ms beside the dense bf16 product's.

Then the `kernels` line (launches by path: bf16, int8, train, train_fp16,
checkpoint, train_dp, checkpoint_dp, train_mp (every process's launches
summed), train_fused, train_fused_mp, resilience, monitor, monitor_mp,
zero3 paths (train_zero3, train_zero3_remat, train_zero3_fcm,
checkpoint_zero3, checkpoint_sharded, train_zero3_fused), the offload
paths (offload: train_offload,
offload_nvme: train_offload_nvme, infinity: train_infinity),
train_sparse, train_longseq, train_medium, train_large,
train_fused_large, fcm; and for the fused paths the traced
launches of their profiled replays, which no counter sees) and, last,
{"ok": true,
"device": {...}}.  A capture that fails fails its
phase, and the script exits 1 without a result.  Without a CUDA device
the script exits 1 in phase 1.

    python3 chip_smoke.py --dp-only

runs phase 1, the parity cases of kernels A, B, D and E and phases 14, 15
and 17 alone, the ranks spread over every visible card (one each on a
host with four), and prints no `kernels` line.

    python3 chip_smoke.py --mp-only

runs phase 1, the parity cases of kernels A, B, D and E and phases 18,
19 and 26 alone, one process a visible card, and prints no `kernels`
line.

    python3 chip_smoke.py --remat-only

runs phase 1, the parity cases of kernels A, B, D and E (the new widths and
fp16 gamma included), phase 8 (train, for train_fp16's comparison) and
phases 20-23 alone, and prints no `kernels` line.

    python3 chip_smoke.py --zero3-only

runs phase 1, the parity cases of kernels A, B, D and E and phases 31-35
and 41-43 alone, and prints no `kernels` line.

    python3 chip_smoke.py --offload-only

runs phase 1, the parity cases of kernels A, B, D and E, phase 8 (train,
for the offload rows' comparison) and phases 36-40 alone, and prints no
`kernels` line.

    python3 chip_smoke.py --fused-only

runs phase 1, the parity cases of kernels A, B, D and E, phases 24-27,
phase 23 (train_large, for train_fused_large's comparison) and phase 28
alone, and prints no `kernels` line.

    python3 chip_smoke.py --monitor-only

runs phase 1, the parity cases of kernels A, B, D and E and phases 29 and
30 alone, and prints no `kernels` line.

    python3 chip_smoke.py --fcm-only

runs phase 1, the parity cases of kernels H, I and J and phases 12 and 13
alone, the W ranks spread over every visible card (one each on a host with
four), and prints no `kernels` line.
"""

import atexit
import contextlib
import csv
import ctypes
import functools
import gc
import hashlib
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.models import (GPT2Config, GPT2Model,
                                        gpt2_params_to_jax)
from deepspeed_tpu_torch.ops import (KERNELS, dispatch, launch_counts,
                                     op_builder, realign_counts,
                                     reset_launch_counts)
from deepspeed_tpu_torch.ops import activations
from deepspeed_tpu_torch.ops import collective_matmul as cm
from deepspeed_tpu_torch.ops.flash_attention import (
    DEFAULT_MASK_VALUE, dropout_keep_mask, flash_attention_bwd_dkdv_cuda,
    flash_attention_bwd_dq_cuda, flash_attention_bwd_reference,
    flash_attention_cuda, head_dim_plan, mha_reference, quantized_threshold)
from deepspeed_tpu_torch.ops.normalize import (LN_ROUTES, fused_layer_norm,
                                               layer_norm_bwd_cuda,
                                               layer_norm_bwd_reference,
                                               layer_norm_cuda, layer_norm_plan,
                                               layer_norm_reference)
from deepspeed_tpu_torch.ops.quant import (DEQUANT_ROUTES, QuantizedWeight,
                                           dequant, dequant_matmul_reference,
                                           dequant_plan, fused_dequant_matmul,
                                           matmul_maybe_int8)
from deepspeed_tpu_torch.ops.sparse_attention import (BigBirdSparsityConfig,
                                                      FixedSparsityConfig,
                                                      SparseSelfAttention,
                                                      layout_gather)
from deepspeed_tpu_torch.ops.sparse_attention.block_sparse_flash import (
    block_sparse_flash_bwd_dkdv_cuda, block_sparse_flash_bwd_dq_cuda,
    block_sparse_flash_bwd_reference, block_sparse_flash_fwd_cuda,
    block_sparse_flash_fwd_reference)
from deepspeed_tpu_torch.ops.transformer import DeepSpeedTransformerLayer
from deepspeed_tpu_torch.parallel import MeshContext
from deepspeed_tpu_torch.runtime import checkpoint as ckpt_mod
from deepspeed_tpu_torch.runtime.comm import low_bandwidth as lb
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import LossScaleState
from deepspeed_tpu_torch.runtime.weight_quantizer import (WeightQuantization,
                                                          quantize_weight)

# H100 SXM, NVIDIA data sheet (dense): device memory rate and the peak
# operation rate by operand type (bf16 on the tensor cores; fp32 on the
# CUDA cores, TF32 being off).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

TIMED_RUNS = 30
# the plain twin's and the library call's runs: yardsticks beside the
# kernel's 30 (fewer, to keep the whole script inside its time limit)
YARDSTICK_RUNS = 5
SPIN_CYCLES = 2_000_000  # ~1 ms of torch.cuda._sleep: longer than any enqueue
BATCH, PROMPT, NEW_TOKENS = 8, 128, 128
TIMING_ROUNDS = 6  # timed generates per engine, in turns
PROFILED_TOKENS = 16  # a short generate under torch.profiler
LOGIT_REL_TOL = 2e-2
# training phases
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
GRADS_BATCH = 2
LOSS_REL_TOL, GRAD_REL_TOL = 2e-2, 5e-2
TRAIN_WARMUP, TRAIN_ITERS = 3, 30  # bench.py _time_steps
HOST_ISSUE_STEPS = 3  # steps whose host issue time is read, after a sync
DROPOUT = 0.1
# bench.py::bench_gpt2's engine config (bench.py:501-509)
BENCH_GPT2_CONFIG = {
    "train_micro_batch_size_per_gpu": TRAIN_BATCH,
    "gradient_accumulation_steps": 1,
    "optimizer": {"type": "AdamW", "params": {"lr": 6e-4,
                                              "weight_decay": 0.1}},
    "bf16": {"enabled": True, "grads_in_compute_dtype": False},
    "zero_optimization": {"stage": 2},
    "steps_per_print": 10 ** 9,
    # one rank, whatever the cards: these rows are one card's numbers
    "mesh": {"data": 1},
}
# data-parallel phases: bench_gpt2's step on W ranks of a single-controller
# mesh over every visible card (all of them on one card of a one-card host)
DP_WORLD = 4
DP_GRADS_MICRO = 1  # rows a rank in train_dp_grads
# checkpoint phases: steps before the save, and after it on each engine;
# the checkpoints go under the repository's build/ and are removed after
CKPT_STEPS = 3
CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
# long-context phases: bench.py::bench_sparse_longseq and bench_longseq
# (bench.py:1324-1377) through _run_longseq (bench.py:1288-1321)
LONG_BATCH, LONG_SEQ = 2, 8192
LONG_WARMUP, LONG_ITERS = 2, 10
SPARSE_GRADS_LAYERS = 2  # train_sparse_grads' depth
BIGBIRD = dict(num_heads=12, block=512, num_random_blocks=1,
               num_sliding_window_blocks=3, num_global_blocks=1)
BENCH_LONGSEQ_CONFIG = {
    "train_micro_batch_size_per_gpu": LONG_BATCH,
    "optimizer": {"type": "AdamW", "params": {"lr": 6e-4,
                                              "weight_decay": 0.1}},
    "bf16": {"enabled": True},
    "zero_optimization": {"stage": 2},
    "steps_per_print": 10 ** 9,
    "mesh": {"data": 1},
}


# the collective tier: W logical ranks on the one card, bench_gpt2's 8 x 1024
# tokens spread over them, GPT-2 124M's three row-sharded matrices [K, N]
FCM_WORLD, FCM_ROWS, FCM_BLOCK = 4, 2048, lb.DEFAULT_BLOCK
FCM_MATRICES = {"c_attn": (768, 2304), "c_fc": (768, 3072),
                "c_proj": (3072, 768)}
FCM_BITS = ((8, 8), (4, 4), (0, 0))  # (qwz, qgz)
FCM_STEPS = 6  # steps the error buffers are carried over
FCM_TIMED_RUNS = 10
FCM_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# kernel I with bf16 operands and a quantized payload, into an fp32
# destination: the tensor-core route's hi / lo split keeps the fp32 dequant
# (one bf16 rounding of the weights would miss this by ~10x)
FCM_FP32_DEQUANT_TOL = 1e-4
# one-step rule: the share of elements that may lie a quantization step off
FCM_FAR_SHARE = 1e-3


class SmokeFailure(Exception):
    pass


def emit(obj):
    print(json.dumps(obj), flush=True)


def run_phase(name, fn, *args):
    t0 = time.perf_counter()
    try:
        result, summary = fn(*args)
    except Exception as exc:  # report the phase, then fail the run
        traceback.print_exc()
        emit({"phase": name, "ok": False,
              "error": f"{type(exc).__name__}: {exc}"})
        sys.exit(1)
    emit({"phase": name, "ok": True,
          "seconds": round(time.perf_counter() - t0, 3), **summary})
    return result


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def check_aligned(path):
    """The attention wrappers copied no operand on this path: its own views
    meet the tensor-core route's 16-byte rule.  Returns the counts."""
    copies = realign_counts()
    check(not any(copies.values()), f"{path}: realigned operands {copies}")
    return copies


# --------------------------------------------------------------------- #
# work that needs no kernel of the port, done while nvcc builds them
# --------------------------------------------------------------------- #
WARM_SECONDS, WARM_ERRORS = {}, []


def _warm(name):
    """Time a warm-up step into WARM_SECONDS; its failure goes to
    WARM_ERRORS, which phase_device checks after the build."""
    def wrap(fn):
        @functools.wraps(fn)
        def run():
            t0 = time.perf_counter()
            try:
                fn()
            except Exception as exc:  # re-raised by phase_device's check
                traceback.print_exc()
                WARM_ERRORS.append(f"{name}: {type(exc).__name__}: {exc}")
            WARM_SECONDS[name] = round(time.perf_counter() - t0, 3)
        return run
    return wrap


def warm_card(groups, profiler):
    """On the card, during the build: the SDPA calls of the parity cases
    of `groups` (two threads share them), and with `profiler` CUPTI's and
    cuBLAS's start-up; the card's generator state as before (the calls
    with dropout draw from it)."""
    with torch.random.fork_rng(devices=[torch.cuda.current_device()]):
        _warm(f"sdpa_graphs {' '.join(groups)}")(
            lambda: sdpa_warm_up(groups))()
        if profiler:
            _warm("cupti_cublas")(profiler_warm_up)()


def warm_host():
    """On the host, during the build: the offload tier's host libraries
    (g++) and the weights init_state gives the phases (_STATES)."""
    @_warm("host_libraries")
    def libraries():
        for builder in (op_builder.CPUAdamBuilder, op_builder.AsyncIOBuilder):
            builder().build()

    @_warm("weights")
    def weights():
        for cfg, seed in ((gpt2_124m_train(), 0), (gpt2_124m_train(), 1),
                          (gpt2_124m_long(), 0), (gpt2_medium(), 0),
                          (gpt2_large(), 0)):
            _STATES[(repr(cfg), seed)] = init_state(cfg, seed)
    libraries()
    weights()


def sdpa_warm_up(groups):
    """Each bf16 parity case's SDPA call of `groups` (its library
    yardstick) once, forward and for the backward cases backward, on
    inputs of the case's shapes and strides.  PyTorch's default SDPA on
    this card is cuDNN's for bf16, whose first call at a shape builds its
    graph (seconds a shape: sdpa_first_call.py), then cached: so the cases time the calls they always timed, without paying
    the builds in the parity phase.  fp32 takes another backend, and
    above D = 256 the cases pin one (sdpa_backend): left out."""
    for group in groups:
        fn, cases = PARITY_CASES.get(group, (None, []))
        for args in cases:
            if torch.float32 in args:
                continue
            if fn is case_block_sparse:
                kind, b, h, s, d, block, dtype, causal, *fused = args
                q, k, v = attention_inputs(b, h, s, d, dtype, s + d + block,
                                           bool(fused and fused[0]))
                kw = {"attn_mask": dense_mask(SPARSE_LAYOUTS[kind](
                    h, block, s), block, causal)}
                backward = True
            else:
                b, h, s, d, causal, dtype, *rest = args
                fused, rate = list(rest) + [False, 0.0][len(rest):]
                if d > 256:
                    continue
                q, k, v = attention_inputs(
                    b, h, s, d, dtype,
                    s + causal if fn is case_flash else s + d, fused)
                kw = {"is_causal": causal, "dropout_p": rate}
                backward = fn is case_flash_bwd
            F.scaled_dot_product_attention(q, k, v, **kw)
            if backward:
                qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
                out = F.scaled_dot_product_attention(qg, kg, vg, **kw)
                do = torch.randn(b, s, h, d, device="cuda").to(
                    dtype).transpose(1, 2)
                torch.autograd.grad(out, (qg, kg, vg), do)
            torch.cuda.synchronize()
    gc_cuda()


def profiler_warm_up():
    """One torch.profiler session of the card and one bf16 and fp32
    product: CUPTI's and cuBLAS's first use, which the first parity case
    paid before."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for dtype in (torch.bfloat16, torch.float32):
            a = torch.ones(256, 256, device="cuda", dtype=dtype)
            a @ a
        torch.cuda.synchronize()
    prof.events()


# --------------------------------------------------------------------- #
# phase 1
# --------------------------------------------------------------------- #
def phase_device():
    """The card, TF32 off, the kernels' build; cuobjdump's two dumps of the
    built library start in the background, to run under the parity phase
    (run_parity reads them after it)."""
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    warm = [threading.Thread(target=fn, args=args) for fn, args in (
        (warm_card, (("flash_attention_fwd", "flash_attention_fwd_dropout",
                      "flash_attention_bwd"), True)),
        (warm_card, (("block_sparse_flash",), False)), (warm_host, ()))]
    for thread in warm:
        thread.start()
    op_builder.load()
    seconds = time.perf_counter() - t0
    for thread in warm:
        thread.join()
    check(not WARM_ERRORS, f"the work done during the build failed: "
          f"{WARM_ERRORS}")
    lib = op_builder.build()
    summary = {"card": card, "torch": torch.__version__,
               "cuda": torch.version.cuda,
               "kind": torch.cuda.get_device_name(0),
               "build_seconds": round(seconds, 3),
               "during_the_build_seconds": WARM_SECONDS,
               "nvcc_seconds": op_builder.build_seconds,
               "sources": [s.split("deepspeed_tpu_torch/")[-1]
                           for s in op_builder.sources()]}
    start_cuobjdumps(lib)
    return card, summary


def phase_device_resources():
    """The built library's registers, stack bytes and SASS counts, read
    from the cuobjdump dumps that phase_device started."""
    lib = op_builder.build()
    out = {"flash_tensor_core_resources": tensor_core_resources(lib),
           "fcm_tensor_core_sass": fcm_tensor_core_sass(lib),
           "wide_and_gemv_resources": wide_and_gemv_resources(lib),
           "layer_norm_resources": layer_norm_resources(lib),
           "collect_resources": collect_resources(lib)}
    cuobjdump.cache_clear()  # the SASS dump is large
    return None, out


# the dumps phase_device starts in the background: flag -> (process, file),
# or the OSError that kept it from starting
_DUMPS = {}
CUOBJDUMP_FLAGS = ("--dump-resource-usage", "-sass")


def start_cuobjdumps(lib_path):
    """Start cuobjdump's two dumps of the library, each into a file under
    build/ (a pipe would stall the dump until read); stop_cuobjdumps ends
    and removes them at exit at the latest."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    os.makedirs(CKPT_DIR, exist_ok=True)
    atexit.register(stop_cuobjdumps)
    for flag in CUOBJDUMP_FLAGS:
        fd, path = tempfile.mkstemp(prefix="chip_smoke_cuobjdump_",
                                    dir=CKPT_DIR)
        try:
            with os.fdopen(fd, "w") as out:
                _DUMPS[flag] = (subprocess.Popen(
                    [tool, flag, lib_path], stdout=out,
                    stderr=subprocess.DEVNULL), path)
        except OSError as e:  # no cuobjdump: the readers report why
            os.remove(path)
            _DUMPS[flag] = e


def stop_cuobjdumps():
    for entry in _DUMPS.values():
        if isinstance(entry, OSError):
            continue
        proc, path = entry
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        with contextlib.suppress(OSError):
            os.remove(path)
    _DUMPS.clear()


@functools.lru_cache(maxsize=None)
def cuobjdump(lib_path, flag):
    """cuobjdump's `flag` output for the built library (--dump-resource-usage
    or -sass): the dump that phase_device started, waited for once and
    shared by the readers below."""
    entry = _DUMPS.pop(flag)
    if isinstance(entry, OSError):
        raise entry
    proc, path = entry
    try:
        code = proc.wait(timeout=300)
        if code != 0:
            raise subprocess.CalledProcessError(code, [flag, lib_path])
        with open(path) as f:
            return f.read()
    finally:
        with contextlib.suppress(OSError):
            os.remove(path)


def tensor_core_resources(lib_path):
    """Registers and stack (spill) bytes per thread of the kernels of B, E,
    F and G on both routes (`..._mma_kernel` the tensor cores, the others
    the CUDA cores; by head dim), as cuobjdump reads them from the built
    library (what nvcc -Xptxas -v reports), or why they could not be read:
    a diagnostic, which fails no phase."""
    try:
        dump = cuobjdump(lib_path, "--dump-resource-usage")
    except (OSError, subprocess.SubprocessError) as e:
        return f"cuobjdump failed: {e}"
    return {f"{name} D={d}{drop and (' dropout' if drop == '1' else '')}":
            {"registers": int(reg), "stack_bytes": int(stack)}
            for name, d, drop, reg, stack in re.findall(
                r"Function \S*?((?:flash|bsf)_(?:fwd|bwd_dkdv|bwd_dq)"
                r"(?:_mma)?_kernel)I(?:f)?Li(\d+)E(?:Lb([01])E)?\S*:\s+"
                r"REG:(\d+) STACK:(\d+)", dump)}


def wide_and_gemv_resources(lib_path):
    """Registers and stack (spill) bytes per thread of the wide attention
    kernels (csrc/attention_wide.cuh: by launch, dtype and walk; the bf16
    ones are the tensor-core `_mma_` kernels) and of
    kernel C's GEMVs (the CUDA-core one by dtype, rows MT and column groups
    CG; the tensor-core one by warps a block), as cuobjdump reads them; or
    why they could not be read (a diagnostic)."""
    try:
        dump = cuobjdump(lib_path, "--dump-resource-usage")
    except (OSError, subprocess.SubprocessError) as e:
        return f"cuobjdump failed: {e}"
    dt = {"f": "fp32", "13__nv_bfloat16": "bf16"}
    out = {f"{kind} {dt[t]} {walk}": {"registers": int(reg),
                                      "stack_bytes": int(stack)}
           for kind, t, walk, reg, stack in re.findall(
               r"Function \S*?(wide_(?:fwd|dq|dkdv)_kernel)I(f|13__nv_bfloat16)"
               r"NS_\d+(DenseWalk|SparseWalk)\S*:\s+REG:(\d+) STACK:(\d+)",
               dump)}
    out.update({f"{kind} bf16 {walk}": {"registers": int(reg),
                                        "stack_bytes": int(stack)}
                for kind, walk, reg, stack in re.findall(
                    r"Function \S*?(wide_(?:fwd|dq|dkdv)_mma_kernel)INS_\d+"
                    r"(DenseWalk|SparseWalk)\S*:\s+REG:(\d+) STACK:(\d+)",
                    dump)})
    out.update({f"dq_gemv_kernel {dt[t]} MT={mt} CG={cg}":
                {"registers": int(reg), "stack_bytes": int(stack)}
                for t, mt, cg, reg, stack in re.findall(
                    r"Function \S*?dq_gemv_kernelI(f|13__nv_bfloat16)Li(\d+)E"
                    r"Li(\d+)E\S*:\s+REG:(\d+) STACK:(\d+)", dump)})
    out.update({f"dq_gemv_mma_kernel warps={nw}":
                {"registers": int(reg), "stack_bytes": int(stack)}
                for nw, reg, stack in re.findall(
                    r"Function \S*?dq_gemv_mma_kernelILi(\d+)E\S*:\s+"
                    r"REG:(\d+) STACK:(\d+)", dump)})
    return out


def layer_norm_resources(lib_path):
    """Registers and stack (spill) bytes per thread of kernels A's and D's
    device kernels (by template: x's and gamma's dtypes, the elements of a
    pack, packs a thread and, for D, the ring's stages), as cuobjdump reads
    them from the built library; or why they could not be read (a
    diagnostic)."""
    try:
        dump = cuobjdump(lib_path, "--dump-resource-usage")
    except (OSError, subprocess.SubprocessError) as e:
        return f"cuobjdump failed: {e}"
    out = {}
    for kind, args, reg, stack in re.findall(
            r"Function \S*?(ln_(?:fwd|bwd)(?:_streamed|_cols)?_kernel)I(\S+?)EE?v"
            r"PK\S*:\s+REG:(\d+) STACK:(\d+)", dump):
        head = args.split("Li", 1)[0]
        types = ["fp32" if t == "f" else "bf16"
                 for t in re.findall(r"13__nv_bfloat16|S\d*_|f", head)]
        label = f"{kind}<{','.join(types + re.findall(r'Li(\d+)E', args))}>"
        out[label] = {"registers": int(reg), "stack_bytes": int(stack)}
    return out


def collect_resources(lib_path):
    """Registers and stack (spill) bytes per thread of kernel J's collect
    kernels (by chunk width and unrolled sources, 0: the run-time world),
    and in the SASS of each the count of global loads (LDG) and stores
    (STG) and of 32-bit integer divisions' reciprocal steps (MUFU.RCP),
    as cuobjdump reads them from the built library; or why they could not
    be read (a diagnostic)."""
    try:
        usage = cuobjdump(lib_path, "--dump-resource-usage")
        sass = cuobjdump(lib_path, "-sass")
    except (OSError, subprocess.SubprocessError) as e:
        return f"cuobjdump failed: {e}"
    pattern = r"collect_kernelILi(\d+)ELi(\d+)E"
    out = {}
    for width, world, reg, stack in re.findall(
            rf"Function \S*?{pattern}\S*:\s+REG:(\d+) STACK:(\d+)", usage):
        out[f"collect_kernel<{width},{world}>"] = {
            "registers": int(reg), "stack_bytes": int(stack)}
    for chunk in sass.split("Function : ")[1:]:
        found = re.search(pattern, chunk.split(None, 1)[0])
        if found:
            entry = out.setdefault(
                f"collect_kernel<{found.group(1)},{found.group(2)}>", {})
            for op in ("LDG", "STG", "MUFU.RCP"):
                entry[op] = len(re.findall(rf"\b{re.escape(op)}\b", chunk))
    return out


# the tensor-core product kernels of I and J (csrc/tile_mma.cuh)
FCM_MMA_KERNELS = ("wprod_mma_kernel", "at_b_mma_kernel")


def fcm_tensor_core_sass(lib_path):
    """Registers, stack (spill) bytes and the count of HMMA instructions
    in the SASS of each tensor-core kernel of I and J, as cuobjdump reads
    them from the built library, by mangled name; or why they could not be
    read.  The phase fails only when the SASS was read and a kernel has no
    HMMA (then the path never reaches the tensor cores)."""
    try:
        usage = cuobjdump(lib_path, "--dump-resource-usage")
        sass = cuobjdump(lib_path, "-sass")
    except (OSError, subprocess.SubprocessError) as e:
        return f"cuobjdump failed: {e}"
    pattern = "|".join(FCM_MMA_KERNELS)
    out = {}
    for name, reg, stack in re.findall(
            rf"Function (\S*(?:{pattern})\S*):\s+REG:(\d+) STACK:(\d+)",
            usage):
        out[name] = {"registers": int(reg), "stack_bytes": int(stack)}
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split(None, 1)[0]
        if re.search(pattern, name):
            out.setdefault(name, {})["hmma"] = len(
                re.findall(r"\bHG?MMA\b", chunk))
    check(out and all(v.get("hmma", 0) > 0 for v in out.values()),
          f"tensor-core kernels of I and J without HMMA: {out}")
    return out


# --------------------------------------------------------------------- #
# phase 2
# --------------------------------------------------------------------- #
_flush = None


def time_ms(fn, before=None, runs=TIMED_RUNS):
    """Median device ms of one call, CUDA events, L2 flushed before each
    run.  A spin kernel keeps the card busy while the host enqueues the
    call, so that the events measure the device's time and not the host's
    launch cost (host_us measures that).  before(), when given, runs
    first in every run (the processes' barrier of a collective)."""
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(runs):
        if before is not None:
            before()
        _cold_l2()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _cold_l2():
    """Evict the L2 (time_ms's flush buffer, made on first use)."""
    global _flush
    if _flush is None:
        _flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    _flush.zero_()


L2_BYTES = 50 * 2 ** 20  # the H100's L2
BATCH_LAUNCHES = 64
BATCH_SPIN_CYCLES = 8 * SPIN_CYCLES  # ~4 ms: longer than 64 enqueues
BATCH_ROUNDS = 5


def batched_us(fn, operands, launches=BATCH_LAUNCHES):
    """Device µs per launch of fn(*operands), BATCH_LAUNCHES launches back
    to back under one pair of CUDA events after a spin kernel (which keeps
    the card busy while the host enqueues them): the timer's own cost is
    spread over the batch, where time_ms's single launch sits on a floor of
    ~8 µs.  The launches rotate over copies of the operands that together
    exceed twice the L2, so each reads them cold from HBM.  Median of
    BATCH_ROUNDS."""
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
        for i in range(launches):
            fn(*copies[i % len(copies)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / launches)
    del copies
    return float(np.median(times))


def host_us(fn, calls=200):
    """Host µs per call when calls are enqueued back to back without a
    synchronize: what one launch costs the CPU."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def timings(kernel, plain, library):
    """Device ms of the kernel, its plain twin and the library call, and
    the host µs of one kernel and one library launch."""
    return {"ms": time_ms(kernel),
            "plain_ms": time_ms(plain, runs=YARDSTICK_RUNS),
            "library_ms": time_ms(library, runs=YARDSTICK_RUNS),
            "host_us": host_us(kernel),
            "library_host_us": host_us(library)}


def bound_ms(nbytes, ops, dtype):
    """Least time for the work: bytes at the memory rate vs operations at
    the peak rate for the operand type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _within(out, ref, atol, rtol):
    return bool(((out - ref).abs() <= atol + rtol * ref.abs()).all())


def _dtname(dtype):
    return str(dtype).split(".")[-1]


# kernels A and D: the widths their parity cases run (GPT-2 124M's, 1024,
# GPT-2 XL's 1600, 4096 and 8192, which kernel D's first design refused, and
# an odd width, the scalar route) at decode's, a prompt's and prefill's rows
LN_WIDTHS = (768, 1024, 1600, 4096, 8192, 771)
LN_ROWS = (8, 77, 1024)
LN_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
LN_SUM_TOL = 1e-4  # dgamma, dbeta: max|d| / max|ref| past the rounding into gamma's dtype
LN_DTYPES = (torch.bfloat16, torch.float32)
# the training shapes of GPT-2 medium (8 x 1024 rows of 1024) and large
# (4 x 1024 rows of 1280): timed as hidden 768 is, bf16 x, fp32 gamma
LN_TRAIN_SHAPES = ((8192, 1024), (4096, 1280))
# rows too wide for 16 warps' registers: the streamed route (odd, and bf16
# past 16384), at decode's rows and at prefill's, where each block takes
# several rows one after another (A 4, D 8)
LN_STREAMED_WIDTHS = (16385, 20000)
LN_STREAMED_ROWS = (8, 1024)
# kernel D's batched timer: the train step's and train_longseq's rows
LN_BWD_BATCHED_ROWS = (TRAIN_BATCH * TRAIN_SEQ, LONG_BATCH * LONG_SEQ)


def ln_inputs(rows, hidden, dtype, pdtype, seed):
    """x and dy [rows, hidden] in dtype, gamma and beta [hidden] in pdtype."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(rows, hidden, device="cuda", generator=g).to(dtype)
    dy = torch.randn(rows, hidden, device="cuda", generator=g).to(dtype)
    gamma = (1.0 + 0.1 * torch.randn(hidden, device="cuda", generator=g)).to(pdtype)
    beta = (0.1 * torch.randn(hidden, device="cuda", generator=g)).to(pdtype)
    return x, dy, gamma, beta


def ln_plan(rows, hidden, dtype, backward):
    """The plan of kernel A or D (ops/normalize.py layer_norm_plan) for an
    aligned launch, its route label ("split" when a row spans several
    warps), and whether the launcher's own plan (ds_layer_norm_plan)
    agrees with it."""
    code = dispatch.kernel_dtype_code(torch.empty(0, dtype=dtype))
    plan = layer_norm_plan(rows, hidden, code, True, backward)
    theirs = (ctypes.c_int * 6)()
    op_builder.load().ds_layer_norm_plan(rows, hidden, code, 1, int(backward),
                                         theirs)
    mine = [LN_ROUTES.index(plan.route), plan.threads_per_row,
            plan.per_thread, plan.slots, plan.rows_per_slot, plan.blocks]
    split = plan.route != "streamed" and plan.threads_per_row > 32
    return {"route": plan.route + (" split" if split else ""),
            "plan": plan._asdict(), "plan_agrees": list(theirs) == mine}


def half_ulp(ref, dtype):
    """Half a unit in the last place of dtype at each value of ref."""
    _, exp = torch.frexp(ref.float())
    bits = {torch.bfloat16: 9, torch.float16: 12}.get(dtype, 25)
    return torch.ldexp(torch.ones_like(ref, dtype=torch.float32), exp - bits)


def sum_rel_err(out, ref, dtype):
    """max|out - ref| / max|ref| of a column sum returned in dtype, beyond
    the one rounding of the fp32 sum into dtype (half an ulp)."""
    excess = ((out.float() - ref.float()).abs() - half_ulp(ref, dtype)).clamp(
        min=0)
    return (excess.max() / ref.float().abs().max()).item()


def _ln_case_name(rows, hidden, dtype, pdtype):
    return f"[{rows},{hidden}] {_dtname(dtype)}, gamma {_dtname(pdtype)}"


def ln_timed(rows, hidden):
    """Whether a LayerNorm case is timed: hidden 768, and the training
    shapes of GPT-2 medium and large."""
    return hidden == 768 or (rows, hidden) in LN_TRAIN_SHAPES


def case_layer_norm(rows, dtype, hidden=768, pdtype=torch.float32):
    """Kernel A against layer_norm_reference, its route and plan; at hidden
    768 and the training shapes of GPT-2 medium and large also timed (bf16
    also on the batched timer, beside F.layer_norm).  gamma and beta in
    bf16, fp32 or fp16 (an fp16 run's)."""
    x, _, gamma, beta = ln_inputs(rows, hidden, dtype, pdtype, rows + hidden)
    out = layer_norm_cuda(x, gamma, beta, 1e-5)
    ref = layer_norm_reference(x, gamma, beta, 1e-5)
    torch.cuda.synchronize()
    tol = LN_TOL[dtype]
    err = (out.float() - ref.float()).abs().max().item()
    plan = ln_plan(rows, hidden, dtype, False)
    res = {"case": _ln_case_name(rows, hidden, dtype, pdtype),
           "ok": _within(out.float(), ref.float(), tol, tol)
           and plan["plan_agrees"],
           "tolerance": f"atol=rtol={tol}", "max_abs_err": err, **plan}
    if not ln_timed(rows, hidden):
        return res
    g_lib, b_lib = gamma.to(dtype), beta.to(dtype)
    nbytes = 2 * x.numel() * x.element_size() + 2 * hidden * gamma.element_size()
    b_ms, b_by = bound_ms(nbytes, 8 * x.numel(), torch.float32)
    res.update(timings(lambda: layer_norm_cuda(x, gamma, beta, 1e-5),
                       lambda: layer_norm_reference(x, gamma, beta, 1e-5),
                       lambda: F.layer_norm(x, (hidden,), g_lib, b_lib, 1e-5)),
               bound_ms=b_ms, bound_by=b_by)
    if dtype == torch.bfloat16:
        res["batched_us"] = batched_us(
            lambda xx, gg, bb: layer_norm_cuda(xx, gg, bb, 1e-5),
            (x, gamma, beta))
        res["library_batched_us"] = batched_us(
            lambda xx, gg, bb: F.layer_norm(xx, (hidden,), gg, bb, 1e-5),
            (x, g_lib, b_lib))
    return res


def attention_inputs(b, h, s, d, dtype, seed, fused):
    """q, k, v [B, H, S, D]; fused: the head views of one [B, S, 3*H*D]
    projection, split and transposed as the layer passes them (strided, not
    copied)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if fused:
        qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=g).to(dtype)
        return [t.view(b, s, h, d).transpose(1, 2)
                for t in qkv.split(h * d, dim=-1)]
    return [torch.randn(b, h, s, d, device="cuda", generator=g).to(dtype)
            for _ in range(3)]


def _case_name(b, h, s, d, causal, dtype, fused, rate):
    return (f"[{b},{h},{s},{d}] {'causal' if causal else 'full'} "
            f"{_dtname(dtype)}{' fused-qkv views' if fused else ''}"
            f"{f' dropout {rate}' if rate else ''}")


def keep_share_check(seed, b, h, sq, sk, rate):
    """The mask's keep share and whether it lies within 4 sigma of the
    8-bit keep probability threshold / 256."""
    share = dropout_keep_mask(seed, b, h, sq, sk, rate,
                              "cuda").float().mean().item()
    p = quantized_threshold(rate) / 256
    n = b * h * sq * sk
    return share, abs(share - p) <= 4 * (p * (1 - p) / n) ** 0.5


def flash_route(dtype, d):
    """The route kernels B, E, F and G take for `dtype` and head dim `d`
    (flash_attention.head_dim_plan, which the launch passes on and the
    launchers check): the tensor cores for bf16 and the CUDA cores for fp32
    up to D = 256, the wide CUDA-core kernels above."""
    return head_dim_plan(dispatch.kernel_dtype_code(
        torch.empty(0, dtype=dtype)), d).route


# SDPA's backends in PyTorch's order of preference
SDPA_BACKENDS = ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION",
                 "MATH")


def sdpa_backend(q, k, v, causal, extra):
    """Above D = 256, where the flash backend stops: the first SDPA backend
    that takes these operands, named in `extra["library_backend"]`, as a
    context factory that pins it; below, PyTorch's own choice (a no-op
    context)."""
    if q.shape[-1] <= 256:
        return contextlib.nullcontext
    from torch.nn.attention import SDPBackend, sdpa_kernel
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:
            with sdpa_kernel(backend):
                F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        except RuntimeError:
            continue
        extra["library_backend"] = name
        return lambda: sdpa_kernel(backend)
    raise SmokeFailure(f"no SDPA backend takes D = {q.shape[-1]}")


def tflops(ops, ms):
    """Achieved TFLOP/s of `ops` operations in `ms` of device time."""
    return ops / (ms * 1e-3) / 1e12


def case_flash(b, h, s, d, causal, dtype, fused=False, rate=0.0):
    """Kernel B against mha_reference; with rate > 0 both drop with the
    mask of the same seed, so they must agree exactly as without.  With
    dropout, ms_dropout_off times the same call without it."""
    q, k, v = attention_inputs(b, h, s, d, dtype, s + causal, fused)
    seed = torch.tensor([1234 + s], dtype=torch.int32, device="cuda")
    kw = dict(causal=causal, dropout_rate=rate, dropout_seed=seed)
    out, lse = flash_attention_cuda(q, k, v, **kw)
    ref, ref_lse = mha_reference(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    tol, lse_tol = (2e-2, 1e-3) if dtype == torch.bfloat16 else (1e-4, 1e-5)
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    ok = _within(out.float(), ref.float(), tol, tol) and lse_err <= lse_tol
    extra = {"route": flash_route(dtype, d)}
    if rate:
        share, share_ok = keep_share_check(seed, b, h, s, s, rate)
        ok = ok and share_ok
        extra.update(keep_share=share,
                     keep_share_expected=quantized_threshold(rate) / 256,
                     ms_dropout_off=time_ms(lambda: flash_attention_cuda(
                         q, k, v, causal=causal)))
    del ref, ref_lse
    pairs = s * (s + 1) // 2 if causal else s * s
    ops = 4 * b * h * d * pairs
    nbytes = 4 * q.numel() * q.element_size() + lse.numel() * 4
    b_ms, b_by = bound_ms(nbytes, ops, dtype)
    backend = sdpa_backend(q, k, v, causal, extra)

    def library():
        with backend():
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                  dropout_p=rate)
    res = {
        "case": _case_name(b, h, s, d, causal, dtype, fused, rate), "ok": ok,
        "tolerance": f"out atol=rtol={tol}, lse atol={lse_tol}",
        "max_abs_err": err, "lse_max_abs_err": lse_err, **extra,
        **timings(lambda: flash_attention_cuda(q, k, v, **kw),
                  lambda: mha_reference(q, k, v, return_lse=True, **kw),
                  library),
        "bound_ms": b_ms, "bound_by": b_by}
    res["tflops"] = tflops(ops, res["ms"])
    res["library_tflops"] = tflops(ops, res["library_ms"])
    return res


def case_layer_norm_bwd(rows, dtype, hidden=768, pdtype=torch.float32):
    """Kernel D against layer_norm_bwd_reference, its route and plan; it
    must also repeat bitwise (its dgamma / dbeta sums take a fixed order,
    no atomics) and return dgamma and dbeta in gamma's dtype (fp16 ones
    too).  At hidden 768 and the training shapes of GPT-2 medium and large
    also timed (bf16 at the training rows also on the batched timer, beside
    F.layer_norm's backward)."""
    x, dy, gamma, _ = ln_inputs(rows, hidden, dtype, pdtype, rows + hidden + 1)
    out = layer_norm_bwd_cuda(x, gamma, dy)
    again = layer_norm_bwd_cuda(x, gamma, dy)
    ref = layer_norm_bwd_reference(x, gamma, dy)
    torch.cuda.synchronize()
    repeat = all(torch.equal(a, b) for a, b in zip(out, again))
    tol = LN_TOL[dtype]
    err = (out[0].float() - ref[0].float()).abs().max().item()
    sum_errs = [sum_rel_err(a, r, pdtype) for a, r in zip(out[1:], ref[1:])]
    dtypes_ok = out[1].dtype == out[2].dtype == pdtype
    plan = ln_plan(rows, hidden, dtype, True)
    res = {"case": _ln_case_name(rows, hidden, dtype, pdtype),
           "ok": (_within(out[0].float(), ref[0].float(), tol, tol)
                  and max(sum_errs) <= LN_SUM_TOL and repeat and dtypes_ok
                  and plan["plan_agrees"]),
           "tolerance": f"dx atol=rtol={tol}; dgamma, dbeta max|d|/max|ref| "
                        f"<= {LN_SUM_TOL} past half an ulp of gamma's dtype "
                        "(the one rounding of the fp32 sums); bitwise "
                        "repeat; dgamma, dbeta in gamma's dtype",
           "max_abs_err": err, "dgamma_dbeta_rel_err": sum_errs,
           "bitwise_repeat": repeat,
           "dgamma_dtype": _dtname(out[1].dtype), **plan}
    if not ln_timed(rows, hidden):
        return res
    nbytes = (3 * x.numel() * x.element_size()
              + 3 * hidden * gamma.element_size())
    b_ms, b_by = bound_ms(nbytes, 20 * x.numel(), torch.float32)
    xg = x.detach().requires_grad_()
    g_lib = gamma.to(dtype).requires_grad_()
    b_lib = torch.zeros(hidden, device="cuda", dtype=dtype,
                        requires_grad=True)
    lib_out = F.layer_norm(xg, (hidden,), g_lib, b_lib, 1e-5)
    res.update(timings(lambda: layer_norm_bwd_cuda(x, gamma, dy),
                       lambda: layer_norm_bwd_reference(x, gamma, dy),
                       lambda: torch.autograd.grad(
                           lib_out, (xg, g_lib, b_lib), dy,
                           retain_graph=True)),
               bound_ms=b_ms, bound_by=b_by)
    if dtype == torch.bfloat16 and rows in LN_BWD_BATCHED_ROWS:
        res["batched_us"] = batched_us(
            lambda xx, gg, dd: layer_norm_bwd_cuda(xx, gg, dd),
            (x, gamma, dy))
        # F.layer_norm's backward as one call: aten's
        # native_layer_norm_backward on the forward's mean and rstd
        g_d, b_d = g_lib.detach(), b_lib.detach()
        _, mean, rstd = torch.ops.aten.native_layer_norm(x, [hidden], g_d,
                                                         b_d, 1e-5)
        res["library_batched_us"] = batched_us(
            lambda xx, dd, gg, bb, mm, rr:
            torch.ops.aten.native_layer_norm_backward(
                dd, xx, [hidden], mm, rr, gg, bb, [True, True, True]),
            (x, dy, g_d, b_d, mean, rstd))
    return res


def case_flash_bwd(b, h, s, d, causal, dtype, fused=False, rate=0.0):
    """Kernel E's two launches against flash_attention_bwd_reference on the
    forward's own out and lse, mask for mask; a second call must repeat the
    first bitwise (no atomics).  Returns the case with one sub-result per
    launch (its device ms, TFLOP/s, host µs and bound); the plain twin and
    the library yardstick (SDPA's backward through autograd, whose dropout
    mask differs: time only) cover dq, dk and dv together."""
    q, k, v = attention_inputs(b, h, s, d, dtype, s + d, fused)
    seed = torch.tensor([4321 + s], dtype=torch.int32, device="cuda")
    kw = dict(causal=causal, dropout_rate=rate, dropout_seed=seed)
    out, lse = flash_attention_cuda(q, k, v, **kw)
    g = torch.Generator(device="cuda").manual_seed(7)
    do = torch.randn(b, s, h, d, device="cuda", generator=g).to(
        dtype).transpose(1, 2)
    delta = (do.float() * out.float()).sum(dim=-1)
    dk, dv = flash_attention_bwd_dkdv_cuda(q, k, v, do, lse, delta, **kw)
    dq = flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
    again = (flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta, **kw),
             *flash_attention_bwd_dkdv_cuda(q, k, v, do, lse, delta, **kw))
    ref = flash_attention_bwd_reference(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    repeat = all(torch.equal(a, b_) for a, b_ in zip((dq, dk, dv), again))
    del again
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
    errs = {name: rel_err(a.float(), r.float())
            for name, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref)}
    max_err = max((a.float() - r.float()).abs().max().item()
                  for a, r in zip((dq, dk, dv), ref))
    del ref
    ok = max(errs.values()) <= tol and repeat
    extra = {"route": flash_route(dtype, d), "bitwise_repeat": repeat}
    if rate:
        share, share_ok = keep_share_check(seed, b, h, s, s, rate)
        ok = ok and share_ok
        extra["keep_share"] = share
    pairs = s * (s + 1) // 2 if causal else s * s
    elt = q.element_size()
    operand = q.numel() * elt
    stats = 2 * lse.numel() * 4  # lse and delta
    launches = {}
    for name, fn, products, outs in (
            ("flash_attention_bwd_dkdv",
             lambda: flash_attention_bwd_dkdv_cuda(q, k, v, do, lse, delta,
                                                   **kw), 4, 2),
            ("flash_attention_bwd_dq",
             lambda: flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta,
                                                 **kw), 3, 1)):
        ops = products * 2 * b * h * d * pairs
        b_ms, b_by = bound_ms((4 + outs) * operand + stats, ops, dtype)
        ms = time_ms(fn)
        launches[name] = {"ms": ms, "tflops": tflops(ops, ms),
                          "host_us": host_us(fn), "bound_ms": b_ms,
                          "bound_by": b_by}
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    with sdpa_backend(q, k, v, causal, extra)():
        sdpa = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                              dropout_p=rate)
    res = {
        "case": _case_name(b, h, s, d, causal, dtype, fused, rate), "ok": ok,
        "tolerance": f"max|d|/max|ref| <= {tol} for dq, dk, dv; bitwise "
                     "repeat",
        "rel_err": errs, "max_abs_err": max_err, **extra,
        "plain_ms": time_ms(lambda: flash_attention_bwd_reference(
            q, k, v, out, lse, do, **kw), runs=YARDSTICK_RUNS),
        "library_ms": time_ms(lambda: torch.autograd.grad(
            sdpa, (qg, kg, vg), do, retain_graph=True),
            runs=YARDSTICK_RUNS),
        "launches": launches}
    # SDPA's backward: five products (S, dP, dV, dK, dQ)
    res["library_tflops"] = tflops(5 * 2 * b * h * d * pairs,
                                   res["library_ms"])
    return res


def grouped_weight(k, n, groups, seed):
    """[k, n] weight whose scale groups differ in magnitude: the rows of
    group g are scaled by 2 ** (g % 4), so that a kernel reading another
    group's scale is off by a factor of 2 or more."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)) * 0.02
    w *= 2.0 ** (np.arange(k) // (k // groups) % 4)[:, None]
    return w.astype(np.float32)


def case_dequant(m, k, n, groups, dtype):
    """Kernel C against its plain twin: the route its launcher took, which
    must be the one ops/quant.py dequant_plan predicts, with the whole plan
    (ds_dequant_matmul_plan); a second launch must repeat the first
    bitwise.  bf16 at groups 1 adds the batched timer (cold HBM) of C and of
    the dense bf16 matmul on the pre-dequantized weight."""
    w = quantize_weight(grouped_weight(k, n, groups, m + k + n + groups),
                        groups, "cuda")
    g = torch.Generator(device="cuda").manual_seed(m)
    x = torch.randn(m, k, device="cuda", generator=g).to(dtype)
    out = fused_dequant_matmul(x, w)
    again = fused_dequant_matmul(x, w)
    ref = dequant_matmul_reference(x, w)
    torch.cuda.synchronize()
    repeat = torch.equal(out, again)
    code = dispatch.kernel_dtype_code(x)
    lib = op_builder.load()
    route = DEQUANT_ROUTES[lib.ds_dequant_matmul_route(
        x.data_ptr(), w.qweight.data_ptr(), m, k, n, code)]
    c_plan = (ctypes.c_int * 5)()
    lib.ds_dequant_matmul_plan(x.data_ptr(), w.qweight.data_ptr(), m, k, n,
                               code, c_plan)
    plan = dequant_plan(m, k, n, dtype)
    plan_agrees = (route, *c_plan[1:]) == tuple(plan) and \
        DEQUANT_ROUTES[c_plan[0]] == route
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    err = (out.float() - ref.float()).abs().max().item()
    rel = err / ref.float().abs().max().item()
    dense = dequant(w, dtype)
    nbytes = (x.numel() * x.element_size() + k * n + groups * 4
              + m * n * x.element_size())
    b_ms, b_by = bound_ms(nbytes, 2 * m * k * n, dtype)
    res = {
        "case": f"M={m} [{k},{n}] groups={groups} {_dtname(dtype)}",
        "route": route, "plan": plan._asdict(), "plan_agrees": plan_agrees,
        "ok": rel <= tol and repeat and plan_agrees,
        "tolerance": f"max|d|/max|ref| <= {tol}; bitwise repeat; the "
                     "launcher's plan is dequant_plan's",
        "max_abs_err": err, "rel_err": rel, "bitwise_repeat": repeat,
        # library: the dense matmul on the pre-dequantized weight (reads
        # 2x the weight bytes in bf16), the product int8 serving replaces
        **timings(lambda: fused_dequant_matmul(x, w),
                  lambda: dequant_matmul_reference(x, w),
                  lambda: torch.matmul(x, dense)),
        "bound_ms": b_ms, "bound_by": b_by}
    if dtype == torch.bfloat16 and groups == 1:
        res["batched_us"] = batched_us(
            lambda xx, q, sc: fused_dequant_matmul(xx, QuantizedWeight(q, sc)),
            (x, w.qweight, w.scale))
        res["library_batched_us"] = batched_us(torch.matmul, (x, dense))
    return res


DEQUANT_ROUTE_KERNELS = {"gemv": "dq_gemv_kernel", "mma": "wprod_mma_kernel",
                         "tiled": "dq_tiled_kernel",
                         "gemv_mma": "dq_gemv_mma_kernel"}


def case_dequant_kernels(m, dtype):
    """The device kernel names of one kernel C launch at M = m, [768, 3072]
    (torch.profiler): its route's kernel ran and the other routes' did
    not."""
    k, n = 768, 3072
    w = quantize_weight(grouped_weight(k, n, 8, 3), 8, "cuda")
    x = torch.randn(m, k, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(4)
                    ).to(dtype)
    route = dequant_plan(m, k, n, dtype).route
    names, attempts = device_kernel_names(lambda: fused_dequant_matmul(x, w))
    want = DEQUANT_ROUTE_KERNELS[route]
    others = [v for r, v in DEQUANT_ROUTE_KERNELS.items() if r != route]
    ok = (len(names) == 1 and want in names[0]
          and not any(o in nm for nm in names for o in others))
    return {"case": f"M={m} [{k},{n}] groups=8 {_dtname(dtype)}", "ok": ok,
            "tolerance": f"one device kernel, {want}", "route": route,
            "device_kernels": names, "profiler_sessions": attempts}


def case_dequant_grad(m, groups):
    """Kernel C's backward (repair C.2): matmul_maybe_int8 of a bf16 x
    [m, 768] that requires grad and an int8 [768, 3072] weight whose scales
    require grad, on the card: the output has a grad_fn, C launches once,
    and the grads of x and of the scales for a seeded cotangent lie within
    max|d| / max|ref| <= 5e-2 of the plain twin's autograd on the same
    card tensors."""
    k, n = 768, 3072
    w = quantize_weight(grouped_weight(k, n, groups, 5 + m), groups, "cuda")
    g = torch.Generator(device="cuda").manual_seed(m + groups)
    x = torch.randn(m, k, device="cuda", generator=g).to(torch.bfloat16)
    dout = torch.randn(m, n, device="cuda", generator=g).to(torch.bfloat16)

    def run(fn):
        xx = x.clone().requires_grad_(True)
        sc = w.scale.clone().requires_grad_(True)
        out = fn(xx, QuantizedWeight(w.qweight, sc))
        has_grad_fn = out.grad_fn is not None
        out.backward(dout)
        return has_grad_fn, xx.grad, sc.grad

    before = fused_dequant_matmul.launches
    has_grad_fn, dx, ds = run(matmul_maybe_int8)
    launched = fused_dequant_matmul.launches - before
    _, rdx, rds = run(dequant_matmul_reference)
    torch.cuda.synchronize()
    dx_err, ds_err = rel_err(dx.float(), rdx.float()), rel_err(ds, rds)
    return {"case": f"M={m} [{k},{n}] groups={groups} bfloat16",
            "ok": has_grad_fn and launched == 1 and dx_err <= GRAD_REL_TOL
            and ds_err <= GRAD_REL_TOL,
            "tolerance": f"max|d|/max|ref| <= {GRAD_REL_TOL} for dx and "
                         "dscale; a grad_fn; one launch of C",
            "grad_fn": has_grad_fn, "launches": launched,
            "dx_rel_err": dx_err, "dscale_rel_err": ds_err}


INT8_LAYER_TOKENS = (BATCH, PROMPT)  # the serving prefill's


def case_int8_layer_grad():
    """A GPT-2 124M DeepSpeedTransformerLayer with its four matmul weights
    int8 (WeightQuantization, 8 groups, as init_inference quantizes them),
    dropout off, forward and backward on the card in bf16 on a seeded
    [8, 128, 768] input against the same layer and int8 bytes on the CPU
    in fp32: the output within 2e-2 and the grads of x and of every
    parameter left (LayerNorm, biases) within 5e-2 (max|d| / max|ref|);
    kernel C launched 4 times, the backward through its autograd."""
    cfg = replace(gpt2_124m().layer_config(), attn_dropout_ratio=0.0,
                  hidden_dropout_ratio=0.0)
    ref_layer = DeepSpeedTransformerLayer(replace(cfg, bf16=False))
    ref_layer.init_params(torch.Generator().manual_seed(6))
    wq = WeightQuantization(quantize_groups=8)
    qweights = wq.quantize_layer_params(
        {name: getattr(ref_layer, name).detach() for name in wq.LAYER_TARGETS},
        "cpu")
    state = {k: v.clone() for k, v in ref_layer.state_dict().items()}
    layer = DeepSpeedTransformerLayer(cfg)
    layer.load_state_dict(state)
    layer.to("cuda")
    for lay, dev in ((ref_layer, "cpu"), (layer, "cuda")):
        for name in wq.LAYER_TARGETS:
            delattr(lay, name)
            qw = qweights[name]
            setattr(lay, name, QuantizedWeight(qw.qweight.to(dev),
                                               qw.scale.to(dev)))
    rng = torch.Generator().manual_seed(7)
    x = torch.randn(*INT8_LAYER_TOKENS, cfg.hidden_size, generator=rng)
    dout = torch.randn(*INT8_LAYER_TOKENS, cfg.hidden_size, generator=rng)

    def run(lay, dev):
        xx = x.to(dev, copy=True).requires_grad_(True)
        out = lay(xx, deterministic=True)
        out.float().backward(dout.to(dev))
        grads = {"x": xx.grad}
        grads.update({n: p.grad for n, p in lay.named_parameters()})
        return out, grads

    ref_out, ref_grads = run(ref_layer, "cpu")
    reset_launch_counts()
    out, grads = run(layer, "cuda")
    torch.cuda.synchronize()
    launched = launch_counts()["dequant_matmul"]
    out_err = rel_err(out.float().cpu(), ref_out)
    errs = {n: rel_err(grads[n].float().cpu(), ref_grads[n])
            for n in ref_grads}
    worst = max(errs, key=errs.get)
    return {"case": f"GPT-2 124M layer, int8 weights (8 groups), x "
                    f"{list(INT8_LAYER_TOKENS)} bfloat16",
            "ok": out_err <= LOGIT_REL_TOL and errs[worst] <= GRAD_REL_TOL
            and launched == 4,
            "tolerance": f"out {LOGIT_REL_TOL}, every grad {GRAD_REL_TOL} "
                         "(max|d|/max|ref|) of the CPU fp32 run; 4 launches "
                         "of C",
            "out_rel_err": out_err, "grads_checked": len(errs),
            "worst_grad": worst, "worst_grad_rel_err": errs[worst],
            "launches": launched}


SPARSE_GATHER_SHAPE = (2, 12, 1024, 64)  # B, H, S, D


def case_sparse_gather(block, causal):
    """SparseSelfAttention at a layout block kernels F and G cannot tile
    (repair C.1): on the card in bf16 it takes the gather path, counted
    once on SparseSelfAttention.gathered, with F and G launched 0 times;
    out and the grads of q, k, v for a seeded cotangent within 2e-2 / 5e-2
    (max|d| / max|ref|) of the port's fp32 run with every kernel's plain
    version (`plain_versions`) on the card."""
    b, h, s, d = SPARSE_GATHER_SHAPE
    cfg = FixedSparsityConfig(num_heads=h, block=block)
    rng = torch.Generator().manual_seed(block + causal)
    q, k, v, dout = (torch.randn(b, h, s, d, generator=rng)
                     for _ in range(4))

    def run(dev, dtype):
        ins = [t.to(dev, dtype, copy=True).requires_grad_(True)
               for t in (q, k, v)]
        out = SparseSelfAttention(cfg)(*ins, causal=causal)
        out.backward(dout.to(dev, dtype))
        return out, [t.grad for t in ins]

    with plain_versions():
        ref, ref_grads = run("cuda", torch.float32)
    ref, ref_grads = ref.cpu(), [g.cpu() for g in ref_grads]
    reset_launch_counts()
    SparseSelfAttention.gathered = 0
    out, grads = run("cuda", torch.bfloat16)
    torch.cuda.synchronize()
    counts = launch_counts()
    flash = {n: counts[n] for n in ("block_sparse_flash_fwd",
                                    "block_sparse_flash_bwd_dq",
                                    "block_sparse_flash_bwd_dkdv")}
    out_err = rel_err(out.float().cpu(), ref)
    grad_err = max(rel_err(g.float().cpu(), r)
                   for g, r in zip(grads, ref_grads))
    return {"case": f"Fixed block {block} {list(SPARSE_GATHER_SHAPE)} "
                    f"{'causal' if causal else 'bidirectional'} bfloat16",
            "ok": out_err <= LOGIT_REL_TOL and grad_err <= GRAD_REL_TOL
            and SparseSelfAttention.gathered == 1 and not any(flash.values()),
            "tolerance": f"out {LOGIT_REL_TOL}, grads {GRAD_REL_TOL} "
                         "(max|d|/max|ref|) of the plain fp32 run; gathered "
                         "1, F and G 0",
            "out_rel_err": out_err, "grad_rel_err": grad_err,
            "gathered": SparseSelfAttention.gathered, "flash_launches": flash}


def bigbird_layout(heads=12, block=512, seq=LONG_SEQ):
    return BigBirdSparsityConfig(**dict(BIGBIRD, num_heads=heads,
                                        block=block)).make_layout(seq)


def fixed_layout(heads, block, seq):
    return FixedSparsityConfig(num_heads=heads, block=block,
                               num_local_blocks=2,
                               num_global_blocks=1).make_layout(seq)


def empty_row_layout(heads=2):
    """4 blocks; q-block 1 allows only the two blocks above the diagonal,
    so under the causal mask its rows see nothing."""
    layout = np.zeros((heads, 4, 4), bool)
    layout[:, 0, 0] = True
    layout[:, 1, [2, 3]] = True
    layout[:, 2, [0, 2]] = True
    layout[:, 3, :] = True
    return layout


# layouts of the F / G parity cases, by (heads, block, seq)
SPARSE_LAYOUTS = {"bigbird": bigbird_layout, "fixed": fixed_layout,
                  "empty-causal-row": lambda h, block, s: empty_row_layout(h)}


def live_pairs(layout, block, causal):
    """Score pairs the layout lets through, summed over heads: a full
    block block**2, a diagonal block under the causal mask
    block * (block + 1) / 2, a block above the diagonal none."""
    if not causal:
        return int(layout.sum()) * block * block
    below = int(np.tril(layout, -1).sum())
    diag = int(np.diagonal(layout, axis1=1, axis2=2).sum())
    return below * block * block + diag * block * (block + 1) // 2


def dense_mask(layout, block, causal):
    """The layout as the boolean [S, S] (or [1, H, S, S] when the heads
    differ) mask of scaled_dot_product_attention, ANDed with the causal
    mask."""
    heads = layout if not (layout == layout[:1]).all() else layout[:1]
    mask = torch.from_numpy(heads).cuda().repeat_interleave(
        block, 1).repeat_interleave(block, 2)
    if causal:
        mask &= torch.ones(mask.shape[-2:], dtype=torch.bool,
                           device="cuda").tril()
    return mask[0] if mask.shape[0] == 1 else mask[None]


def case_block_sparse(kind, b, h, s, d, block, dtype, causal, fused=False):
    """Kernels F and G's two launches against their plain twins on the same
    inputs (the twins compute in fp32 on them), the backward on F's own out
    and lse.  One sub-result per launch: device ms, host µs, bound; F's
    plain and library times are the twin's and SDPA's forward with the
    layout as a boolean mask, G's those of the twin's backward and SDPA's
    backward (dq, dk and dv together)."""
    layout = SPARSE_LAYOUTS[kind](h, block, s)
    q, k, v = attention_inputs(b, h, s, d, dtype, s + d + block, fused)
    fidx, fvalid = (torch.as_tensor(a, device="cuda")
                    for a in layout_gather(layout))
    tidx, tvalid = (torch.as_tensor(a, device="cuda")
                    for a in layout_gather(layout, transpose=True))
    fwd = (q, k, v, fidx, fvalid, block, causal)
    out, lse = block_sparse_flash_fwd_cuda(*fwd)
    ref, ref_lse = block_sparse_flash_fwd_reference(*fwd)
    g = torch.Generator(device="cuda").manual_seed(9)
    do = torch.randn(b, s, h, d, device="cuda", generator=g).to(
        dtype).transpose(1, 2)
    delta = (do.float() * out.float()).sum(dim=-1)
    bwd = (q, k, v, do, lse, delta)
    dq = block_sparse_flash_bwd_dq_cuda(*bwd, fidx, fvalid, block, causal)
    dk, dv = block_sparse_flash_bwd_dkdv_cuda(*bwd, tidx, tvalid, block,
                                              causal)
    again = (block_sparse_flash_bwd_dq_cuda(*bwd, fidx, fvalid, block, causal),
             *block_sparse_flash_bwd_dkdv_cuda(*bwd, tidx, tvalid, block,
                                               causal))
    ref_grads = block_sparse_flash_bwd_reference(q, k, v, out, lse, do, fidx,
                                                 fvalid, block, causal)
    torch.cuda.synchronize()
    repeat = all(torch.equal(a, b_) for a, b_ in zip((dq, dk, dv), again))
    del again
    bf16 = dtype == torch.bfloat16
    tol, lse_tol, grad_tol = (2e-2, 1e-3, 5e-2) if bf16 else (1e-4, 1e-5,
                                                              1e-4)
    live = ref_lse > DEFAULT_MASK_VALUE / 2  # rows that see a live block
    empty_rows = int((~live).sum())
    out_err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse[live] - ref_lse[live]).abs().max().item()
    grad_errs = {name: rel_err(a.float(), r.float()) for name, a, r in
                 zip(("dq", "dk", "dv"), (dq, dk, dv), ref_grads)}
    ok = (_within(out.float(), ref.float(), tol, tol) and lse_err <= lse_tol
          and max(grad_errs.values()) <= grad_tol
          and bool((lse[~live] < DEFAULT_MASK_VALUE / 2).all())
          and bool((out[~live] == 0).all())
          and all(bool(torch.isfinite(t.float()).all())
                  for t in (dq, dk, dv)) and repeat)
    pairs = b * live_pairs(layout, block, causal)
    operand = q.numel() * q.element_size()
    stats = lse.numel() * 4
    mask = dense_mask(layout, block, causal)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
    plain_bwd_ms = time_ms(lambda: block_sparse_flash_bwd_reference(
        q, k, v, out, lse, do, fidx, fvalid, block, causal),
        runs=YARDSTICK_RUNS)
    library_bwd_ms = time_ms(lambda: torch.autograd.grad(
        sdpa, (qg, kg, vg), do, retain_graph=True), runs=YARDSTICK_RUNS)
    launches = {}
    for name, fn, products, nbytes, err, plain_ms, library_ms in (
            ("block_sparse_flash_fwd",
             lambda: block_sparse_flash_fwd_cuda(*fwd), 2,
             4 * operand + stats, out_err,
             time_ms(lambda: block_sparse_flash_fwd_reference(*fwd),
                     runs=YARDSTICK_RUNS),
             time_ms(lambda: F.scaled_dot_product_attention(
                 q, k, v, attn_mask=mask), runs=YARDSTICK_RUNS)),
            ("block_sparse_flash_bwd_dq",
             lambda: block_sparse_flash_bwd_dq_cuda(*bwd, fidx, fvalid,
                                                    block, causal), 3,
             5 * operand + 2 * stats,
             (dq.float() - ref_grads[0].float()).abs().max().item(),
             plain_bwd_ms, library_bwd_ms),
            ("block_sparse_flash_bwd_dkdv",
             lambda: block_sparse_flash_bwd_dkdv_cuda(*bwd, tidx, tvalid,
                                                      block, causal), 4,
             6 * operand + 2 * stats,
             max((a.float() - r.float()).abs().max().item()
                 for a, r in zip((dk, dv), ref_grads[1:])),
             plain_bwd_ms, library_bwd_ms)):
        b_ms, b_by = bound_ms(nbytes, products * 2 * d * pairs, dtype)
        launches[name] = {"ms": time_ms(fn), "host_us": host_us(fn),
                          "bound_ms": b_ms, "bound_by": b_by,
                          "max_abs_err": err, "plain_ms": plain_ms,
                          "library_ms": library_ms}
    return {
        "case": (f"[{b},{h},{s},{d}] {kind} block {block} "
                 f"{'causal' if causal else 'full'} {_dtname(dtype)}"
                 f"{' fused-qkv views' if fused else ''}"),
        "ok": ok, "tolerance": (f"out atol=rtol={tol}, lse atol={lse_tol} on "
                                f"live rows; dq, dk, dv max|d|/max|ref| <= "
                                f"{grad_tol}; empty rows out 0, lse masked; "
                                "bitwise repeat"),
        "route": flash_route(dtype, d), "bitwise_repeat": repeat,
        "density": float(layout.mean()), "score_pairs": pairs,
        "empty_rows": empty_rows, "max_abs_err": out_err,
        "lse_max_abs_err": lse_err, "rel_err": grad_errs,
        "library": "SDPA, layout as a boolean mask", "launches": launches}


def case_realigned(kind):
    """Each launch of kernels B and E ("flash") or F and G ("block_sparse")
    in bf16 with `k` two bytes off a 16-byte boundary (the head view of a
    projection that starts one element in): the wrapper copies it (its
    realigned count rises by one a launch), and the result equals the same
    launch on an aligned copy of k bitwise."""
    b, h, s, d = 2, 4, 1024, 64
    g = torch.Generator(device="cuda").manual_seed(11)
    qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=g).to(
        torch.bfloat16)
    shifted = torch.empty(b, s, 3 * h * d + 8, dtype=torch.bfloat16,
                          device="cuda")[..., 1:1 + 3 * h * d]
    shifted.copy_(qkv)

    def views(t):
        return [x.view(b, s, h, d).transpose(1, 2)
                for x in t.split(h * d, dim=-1)]
    q, _, v = views(qkv)
    k = views(shifted)[1]
    k_aligned = k.clone(memory_format=torch.contiguous_format)
    do = torch.randn(b, s, h, d, device="cuda", generator=g).to(
        torch.bfloat16).transpose(1, 2)
    if kind == "flash":
        out, lse = flash_attention_cuda(q, k_aligned, v, causal=True)
        delta = (do.float() * out.float()).sum(dim=-1)
        launches = {
            "flash_attention_fwd": lambda kk: flash_attention_cuda(
                q, kk, v, causal=True),
            "flash_attention_bwd_dkdv": lambda kk: (
                flash_attention_bwd_dkdv_cuda(q, kk, v, do, lse, delta,
                                              causal=True)),
            "flash_attention_bwd_dq": lambda kk: (
                flash_attention_bwd_dq_cuda(q, kk, v, do, lse, delta,
                                            causal=True),)}
    else:
        block = 128
        layout = bigbird_layout(h, block, s)
        fidx, fvalid = (torch.as_tensor(a, device="cuda")
                        for a in layout_gather(layout))
        tidx, tvalid = (torch.as_tensor(a, device="cuda")
                        for a in layout_gather(layout, transpose=True))
        out, lse = block_sparse_flash_fwd_cuda(q, k_aligned, v, fidx, fvalid,
                                               block, True)
        delta = (do.float() * out.float()).sum(dim=-1)
        launches = {
            "block_sparse_flash_fwd": lambda kk: block_sparse_flash_fwd_cuda(
                q, kk, v, fidx, fvalid, block, True),
            "block_sparse_flash_bwd_dq": lambda kk: (
                block_sparse_flash_bwd_dq_cuda(q, kk, v, do, lse, delta, fidx,
                                               fvalid, block, True),),
            "block_sparse_flash_bwd_dkdv": lambda kk: (
                block_sparse_flash_bwd_dkdv_cuda(q, kk, v, do, lse, delta,
                                                 tidx, tvalid, block, True))}
    results = {}
    for name, fn in launches.items():
        reset_launch_counts()
        got = fn(k)
        copies = realign_counts()[name]
        want = fn(k_aligned)
        torch.cuda.synchronize()
        results[name] = {
            "realigned": copies,
            "realigned_by_the_aligned_call": realign_counts()[name] - copies,
            "bitwise_equal": all(torch.equal(x, y)
                                 for x, y in zip(got, want))}
    ok = all(r["realigned"] == 1 and r["realigned_by_the_aligned_call"] == 0
             and r["bitwise_equal"] for r in results.values())
    return {"case": f"[{b},{h},{s},{d}] {kind} bf16 causal, k 2 bytes off a "
                    "16-byte boundary", "ok": ok,
            "tolerance": "one copy a launch; bitwise equal to the aligned "
                         "call", "route": flash_route(torch.bfloat16, d),
            "launches": results}


# --------------------------------------------------------------------- #
# parity of kernels H, I and J
# --------------------------------------------------------------------- #
def fcm_payload(kc, n, bits, dtype, seed):
    """A [kc, n] weight shard in `dtype` and its ring payload (q, scales)
    at `bits` (0: the native shard)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = (torch.randn(kc, n, device="cuda", generator=g) / 8).to(dtype)
    q, s = cm._quantize_shard(w, bits, FCM_BLOCK)
    return q.contiguous(), s


def payload_bytes(q, s):
    return q.numel() * q.element_size() + (0 if s is None else s.numel() * 4)


def fcm_case_name(m, kc, n, bits, dtype):
    payload = {8: "int8", 4: "int4", 0: "native"}[bits]
    return f"m={m} tile [{kc},{n}] {payload} {_dtname(dtype)}"


def fcm_result(name, out, ref, tol, nbytes, ops, dtype, kernel, plain,
               library):
    torch.cuda.synchronize()
    err = rel_err(out.float(), ref.float())
    b_ms, b_by = bound_ms(nbytes, ops, dtype)
    return {"case": name, "ok": err <= tol,
            "tolerance": f"max|d|/max|ref| <= {tol}", "rel_err": err,
            "max_abs_err": (out.float() - ref.float()).abs().max().item(),
            **timings(kernel, plain, library), "bound_ms": b_ms,
            "bound_by": b_by}


def hold_tile(res, kernel, args, route, bits, splits=None):
    """Kernel H's further holds: a second launch repeats the first bitwise,
    and the bf16 cases with a quantized payload lie within
    FCM_FP32_DEQUANT_TOL of the fp32 twin (H's output is fp32 already)."""
    first, again = kernel(*args), kernel(*args)
    torch.cuda.synchronize()
    repeat = torch.equal(first, again)
    res = {**res, "route": route, "ok": res["ok"] and repeat,
           "repeat_bitwise": repeat}
    if splits is not None:
        res["splits"] = splits if route == cm.ROUTE_TENSOR_CORES else 1
    dtype = args[0].dtype
    return hold_fp32_dequant(res, dtype, bits, res["rel_err"])


def case_fcm_tile_ag(m, kc, n, bits, dtype):
    """Kernel H, forward tile, on a column block of x [m, 4 kc]."""
    q, s = fcm_payload(kc, n, bits, dtype, kc + n + bits)
    g = torch.Generator(device="cuda").manual_seed(m + bits)
    x = torch.randn(m, FCM_WORLD * kc, device="cuda",
                    generator=g).to(dtype)[:, kc:2 * kc]
    args = (x, q, s, bits, kc, n)
    dense = cm._dequant_tile(q, s, kc, n, bits).to(dtype)
    nbytes = x.numel() * x.element_size() + payload_bytes(q, s) + m * n * 4
    res = fcm_result(
        fcm_case_name(m, kc, n, bits, dtype), cm.fcm_tile_ag_cuda(*args),
        cm.fcm_tile_ag_reference(*args), FCM_TOL[dtype], nbytes,
        2 * m * kc * n, dtype, lambda: cm.fcm_tile_ag_cuda(*args),
        lambda: cm.fcm_tile_ag_reference(*args),
        lambda: torch.matmul(x, dense))
    return hold_tile(res, cm.fcm_tile_ag_cuda, args, cm.fcm_route(x), bits)


def case_fcm_tile_ag_t(m, kc, n, bits, dtype):
    """Kernel H, transposed tile: g [m, n] @ deq^T -> [m, kc]."""
    q, s = fcm_payload(kc, n, bits, dtype, kc + n + bits + 1)
    gen = torch.Generator(device="cuda").manual_seed(m + bits + 1)
    g = torch.randn(m, n, device="cuda", generator=gen).to(dtype)
    args = (g, q, s, bits, kc, n)
    dense_t = cm._dequant_tile(q, s, kc, n, bits).to(dtype).t()
    nbytes = g.numel() * g.element_size() + payload_bytes(q, s) + m * kc * 4
    res = fcm_result(
        fcm_case_name(m, kc, n, bits, dtype), cm.fcm_tile_ag_t_cuda(*args),
        cm.fcm_tile_ag_t_reference(*args), FCM_TOL[dtype], nbytes,
        2 * m * kc * n, dtype, lambda: cm.fcm_tile_ag_t_cuda(*args),
        lambda: cm.fcm_tile_ag_t_reference(*args),
        lambda: torch.matmul(g, dense_t))
    return hold_tile(res, cm.fcm_tile_ag_t_cuda, args, cm.fcm_route(g), bits,
                     cm.split_plan(m, kc, n, cm.AG_T_TILE))


def rs_operands(b, kc, n, dtype, seed):
    """a: a column block of lhs [b, 4 kc]; rhs [b, n]."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lhs = torch.randn(b, FCM_WORLD * kc, device="cuda", generator=g).to(dtype)
    rhs = torch.randn(b, n, device="cuda", generator=g).to(dtype)
    return lhs[:, kc:2 * kc], rhs


def case_fcm_tile_rs(b, kc, n, dtype):
    """Kernel H, producer tile: a [b, kc]^T @ rhs [b, n] -> [kc, n]."""
    a, rhs = rs_operands(b, kc, n, dtype, b + kc + n)
    nbytes = (a.numel() + rhs.numel()) * a.element_size() + kc * n * 4
    res = fcm_result(
        f"rows={b} tile [{kc},{n}] {_dtname(dtype)}",
        cm.fcm_tile_rs_cuda(a, rhs), cm.fcm_tile_rs_reference(a, rhs),
        FCM_TOL[dtype], nbytes, 2 * b * kc * n, dtype,
        lambda: cm.fcm_tile_rs_cuda(a, rhs),
        lambda: cm.fcm_tile_rs_reference(a, rhs),
        lambda: torch.matmul(a.t(), rhs))
    return hold_tile(res, cm.fcm_tile_rs_cuda, (a, rhs), cm.fcm_route(a, rhs),
                     0, cm.split_plan(kc, n, b, cm.RS_TILE))


# the device kernels of one launch of each of kernel H's entry points, by
# route (csrc/tile_mma.cuh on the tensor cores, tile_matmul.cuh on the CUDA
# cores)
H_ROUTE_KERNELS = {cm.ROUTE_TENSOR_CORES: {"ag": ("wprod_mma_kernel",),
                                           "ag_t": ("wprod_mma_kernel",
                                                    "split_sum_kernel"),
                                           "rs": ("at_b_mma_kernel",
                                                  "split_sum_kernel")},
                   cm.ROUTE_CUDA_CORES: {"ag": ("tile_matmul_kernel",),
                                         "ag_t": ("tile_matmul_kernel",),
                                         "rs": ("tile_matmul_kernel",)}}


PROFILER_ATTEMPTS = 5


def device_kernel_events(call):
    """The device kernels that call() ran, in launch order, as (name,
    device µs) from torch.profiler (CUDA activity), and the profiler
    sessions it took.  On some machines a session loses the record of its
    first kernel: each session starts with a short spin kernel (left out of
    the list), and one that recorded no kernel of call() at all is
    repeated, up to PROFILER_ATTEMPTS."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILER_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            call()
            torch.cuda.synchronize()
            time.sleep(0.05 * (attempt - 1))  # time for the activity records
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA
                         and "spin_kernel" not in e.name),
                        key=lambda e: e.time_range.start)
        if events:
            break
    return [(e.name, e.time_range.elapsed_us()) for e in events], attempt


def device_kernels(call):
    """The names of the device kernels that call() ran, in launch order,
    and the profiler sessions it took (device_kernel_events)."""
    events, attempts = device_kernel_events(call)
    return [name for name, _ in events], attempts


def device_kernel_names(call):
    """The sorted names of the device kernels that call() ran (each once),
    and the profiler sessions it took (device_kernels)."""
    kernels, attempts = device_kernels(call)
    return sorted(set(kernels)), attempts


def case_fcm_tile_kernels(entry, dtype):
    """The device kernel names of one launch of kernel H's entry point at
    c_fc's tile (int8 payload), from torch.profiler: on the tensor-core
    route (bf16) tile_mma.cuh's kernels ran and tile_matmul.cuh's did not;
    on the CUDA-core route (fp32) the reverse."""
    m, (kc, n) = FCM_ROWS, FCM_PRIMARY_TILE
    q, s = fcm_payload(kc, n, 8, dtype, 5)
    gen = torch.Generator(device="cuda").manual_seed(6)
    if entry == "ag":
        x = torch.randn(m, kc, device="cuda", generator=gen).to(dtype)
        call, route = (lambda: cm.fcm_tile_ag_cuda(x, q, s, 8, kc, n),
                       cm.fcm_route(x))
    elif entry == "ag_t":
        g = torch.randn(m, n, device="cuda", generator=gen).to(dtype)
        call, route = (lambda: cm.fcm_tile_ag_t_cuda(g, q, s, 8, kc, n),
                       cm.fcm_route(g))
    else:
        a, rhs = rs_operands(m, kc, n, dtype, 7)
        call, route = (lambda: cm.fcm_tile_rs_cuda(a, rhs),
                       cm.fcm_route(a, rhs))
    names, attempts = device_kernel_names(call)
    want = H_ROUTE_KERNELS[route][entry]
    other = {k for r, by in H_ROUTE_KERNELS.items() if r != route
             for k in by[entry]} - set(want)
    ran = all(any(w in nm for nm in names) for w in want)
    absent = not any(o in nm for nm in names for o in other)
    return {"case": f"fcm_tile_{entry} m={m} tile [{kc},{n}] int8 "
                    f"{_dtname(dtype)}", "ok": bool(names) and ran and absent,
            "tolerance": f"{', '.join(want)} ran; {', '.join(sorted(other))} "
                         "did not", "route": route, "device_kernels": names,
            "profiler_sessions": attempts}


# kernels A's and D's device kernels (csrc/layer_norm.cu, layer_norm_bwd.cu),
# and the names of PyTorch's cast / copy and fill kernels
LN_KERNEL = re.compile(r"ln_(?:fwd|bwd)\w*_kernel")
CAST_OR_FILL = re.compile(r"copy_kernel|FillFunctor|fill_kernel|_to_copy")


def case_layer_norm_kernels(entry):
    """The device kernels one call launches, from torch.profiler: kernel A
    exactly one, kernel D at most two (ln_bwd_kernel, ln_bwd_cols_kernel),
    and no cast, copy or fill kernel beside them; A on the serving layout
    (bf16 x, fp32 gamma and beta, the prefill's rows), A and D on the
    training layout (bf16 x, gamma, beta, the train step's rows) by a direct
    call and through fused_layer_norm's autograd (forward, then backward
    into fresh grads).  Each kernel's device µs comes with it: D's
    column-sum kernel starts while the first runs (programmatic dependent
    launch), so its µs count from its start, its wait included."""
    rows = 1024 if entry == "A serve" else TRAIN_BATCH * TRAIN_SEQ
    pdtype = torch.float32 if entry == "A serve" else torch.bfloat16
    x, dy, gamma, beta = ln_inputs(rows, 768, torch.bfloat16, pdtype, 3)
    leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    out = fused_layer_norm(*leaves)

    def backward():
        for t in leaves:
            t.grad = None
        out.backward(dy, retain_graph=True)
    call, most = {"A serve": (lambda: layer_norm_cuda(x, gamma, beta), 1),
                  "A train": (lambda: layer_norm_cuda(x, gamma, beta), 1),
                  "D train": (lambda: layer_norm_bwd_cuda(x, gamma, dy), 2),
                  "A train autograd": (lambda: fused_layer_norm(*leaves), 1),
                  "D train autograd": (backward, 2)}[entry]
    events, attempts = device_kernel_events(call)
    kernels = [name for name, _ in events]
    ln = [k for k in kernels if LN_KERNEL.search(k)]
    casts = [k[:140] for k in kernels if CAST_OR_FILL.search(k)]
    return {"case": f"{entry} [{rows},768] bf16, gamma {_dtname(pdtype)}",
            "ok": 1 <= len(kernels) <= most and len(ln) == len(kernels)
            and not casts,
            "tolerance": f"<= {most} device kernel(s), all kernel "
                         f"{entry[0]}'s; no cast, copy or fill",
            "device_kernels": [k[:80] for k in kernels],
            "device_us": [us for _, us in events],
            "count": len(kernels), "casts_and_fills": casts,
            "profiler_sessions": attempts}


def fp32_dequant_err(kernel, twin, args, dest):
    """max|d| / max|ref| of kernel I against its twin with an fp32
    destination (`dest`: the argument index of the accumulator or output
    block, replaced by a fresh fp32 one for each): the tensor-core route's
    hi / lo split has to keep the TPU kernel's fp32 dequant, which a bf16
    cast of the output would hide."""
    outs = []
    for fn in (kernel, twin):
        call = list(args)
        call[dest] = torch.zeros(call[dest].shape, device="cuda")
        fn(*call)
        outs.append(call[dest])
    torch.cuda.synchronize()
    return rel_err(outs[0], outs[1])


def hold_fp32_dequant(res, dtype, bits, err):
    """The bf16 cases with a quantized payload: also within
    FCM_FP32_DEQUANT_TOL of the fp32 twin."""
    if dtype != torch.bfloat16 or not bits:
        return res
    ok = err <= FCM_FP32_DEQUANT_TOL
    return {**res, "ok": res["ok"] and ok, "fp32_dest_rel_err": err,
            "fp32_dest_tolerance": f"max|d|/max|ref| <= "
                                   f"{FCM_FP32_DEQUANT_TOL}"}


def case_fcm_ag_step(m, kc, n, bits, dtype, step):
    """Kernel I, a forward step: the first (reads no accumulator), one that
    accumulates, or the last (writes the cast sum); bitwise on a repeat."""
    first, last = step == "first", step == "last"
    q, s = fcm_payload(kc, n, bits, dtype, kc + n + bits + 2)
    g = torch.Generator(device="cuda").manual_seed(m + bits + 2)
    x = torch.randn(m, FCM_WORLD * kc, device="cuda",
                    generator=g).to(dtype)[:, kc:2 * kc]
    start = torch.randn(m, n, device="cuda", generator=g)
    outs = []
    for fn in (cm.fcm_ag_step_cuda, cm.fcm_ag_step_reference,
               cm.fcm_ag_step_cuda):
        acc = start.clone()
        out = torch.empty(m, n, device="cuda", dtype=dtype)
        fn(x, q, s, bits, kc, n, acc, out, first, last)
        outs.append(out if last else acc)
    torch.cuda.synchronize()
    repeat = torch.equal(outs[0], outs[2])
    acc = start.clone()
    out = torch.empty(m, n, device="cuda", dtype=dtype)
    args = (x, q, s, bits, kc, n, acc, out, first, last)
    dense = cm._dequant_tile(q, s, kc, n, bits).to(dtype)
    moved = m * n * ((0 if first else 4) + (x.element_size() if last else 4))
    nbytes = x.numel() * x.element_size() + payload_bytes(q, s) + moved
    res = fcm_result(
        fcm_case_name(m, kc, n, bits, dtype) + f" {step} step",
        outs[0], outs[1], FCM_TOL[dtype], nbytes, 2 * m * kc * n, dtype,
        lambda: cm.fcm_ag_step_cuda(*args),
        lambda: cm.fcm_ag_step_reference(*args),
        lambda: torch.matmul(x, dense))
    res = {**res, "route": cm.fcm_route(x), "ok": res["ok"] and repeat,
           "repeat_bitwise": repeat}
    if dtype == torch.bfloat16 and bits:
        # an fp32 accumulator step, whatever this case's step
        err = fp32_dequant_err(cm.fcm_ag_step_cuda, cm.fcm_ag_step_reference,
                               (x, q, s, bits, kc, n, start, None, first,
                                False), 6)
        res = hold_fp32_dequant(res, dtype, bits, err)
    return res


def case_fcm_ag_step_t(m, kc, n, bits, dtype):
    """Kernel I, transposed step: the column block src * kc of dx; bitwise
    on a repeat, the other columns untouched."""
    q, s = fcm_payload(kc, n, bits, dtype, kc + n + bits + 3)
    gen = torch.Generator(device="cuda").manual_seed(m + bits + 3)
    g = torch.randn(m, n, device="cuda", generator=gen).to(dtype)
    outs = []
    for fn in (cm.fcm_ag_step_t_cuda, cm.fcm_ag_step_t_reference,
               cm.fcm_ag_step_t_cuda):
        dx = torch.zeros(m, FCM_WORLD * kc, device="cuda", dtype=dtype)
        fn(g, q, s, bits, kc, n, dx[:, 2 * kc:3 * kc])
        outs.append(dx)
    torch.cuda.synchronize()
    repeat = torch.equal(outs[0], outs[2])
    dx = outs[0]
    args = (g, q, s, bits, kc, n, dx[:, 2 * kc:3 * kc])
    dense_t = cm._dequant_tile(q, s, kc, n, bits).to(dtype).t()
    nbytes = (g.numel() + m * kc) * g.element_size() + payload_bytes(q, s)
    res = fcm_result(
        fcm_case_name(m, kc, n, bits, dtype) + " transposed",
        outs[0], outs[1], FCM_TOL[dtype], nbytes, 2 * m * kc * n, dtype,
        lambda: cm.fcm_ag_step_t_cuda(*args),
        lambda: cm.fcm_ag_step_t_reference(*args),
        lambda: torch.matmul(g, dense_t))
    untouched = bool((dx[:, :2 * kc] == 0).all() and (dx[:, 3 * kc:] == 0).all())
    res = {**res, "route": cm.fcm_route(g),
           "splits": (cm.split_plan(m, kc, n, cm.AG_T_TILE)
                      if cm.fcm_route(g) == cm.ROUTE_TENSOR_CORES else 1),
           "ok": res["ok"] and untouched and repeat,
           "other_columns_untouched": untouched, "repeat_bitwise": repeat}
    if dtype == torch.bfloat16 and bits:
        err = fp32_dequant_err(
            cm.fcm_ag_step_t_cuda, cm.fcm_ag_step_t_reference,
            (g, q, s, bits, kc, n, torch.zeros(m, kc, device="cuda")), 6)
        res = hold_fp32_dequant(res, dtype, bits, err)
    return res


def one_step_rule(got, ref, steps, rtol, magnitude=None):
    """Where a quantizer follows a product: the elements that differ by
    more than rtol (of the value, or of the step where the value is
    smaller) must be at most FCM_FAR_SHARE of all and each differ by at
    most `steps`.  An error residual is a small difference of the product
    and its dequantized value, so it is held relative to the product,
    passed as `magnitude`.  Returns (ok, share far, worst difference in
    steps)."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    size = ref.abs() if magnitude is None else magnitude.abs()
    far = diff > rtol * torch.maximum(size, steps)
    share = far.float().mean().item()
    worst = (diff[far] / steps[far]).max().item() if far.any() else 0.0
    finite = bool(torch.isfinite(got).all())
    return (finite and share <= FCM_FAR_SHARE and worst <= 1 + 1e-3, share,
            worst)


def case_fcm_rs_producer(b, kc, n, dtype):
    """Kernel J's producer against its twin by the one-step rule, and
    bitwise against the twin's quantizer fed the kernel's own compensated
    tile."""
    a, rhs = rs_operands(b, kc, n, dtype, b + kc + n + 1)
    g = torch.Generator(device="cuda").manual_seed(kc)
    err = 0.1 * torch.randn(kc, n, device="cuda", generator=g)
    bs = lb.largest_divisor_at_most(kc * n, FCM_BLOCK)
    nb = kc * n // bs

    def run(fn, comp=None):
        q = torch.empty(nb, bs, dtype=torch.int8, device="cuda")
        s = torch.empty(1, nb, device="cuda")
        nerr = torch.empty(kc, n, device="cuda")
        fn(a, rhs, err, q, s, nerr, bs, comp)
        return q, s, nerr

    comp = torch.empty(kc, n, device="cuda")
    q, s, nerr = run(cm.fcm_rs_producer_cuda, comp)
    tq, ts, tnerr = run(cm.fcm_rs_producer_reference)
    oq, os_, onerr = cm.quantize_tile_reference(comp, bs)
    rq, rs_, rnerr = run(cm.fcm_rs_producer_cuda)
    torch.cuda.synchronize()
    own_tile_bitwise = bool((oq == q).all() and (os_ == s).all()
                            and (onerr == nerr).all())
    repeat = bool(torch.equal(rq, q) and torch.equal(rs_, s)
                  and torch.equal(rnerr, nerr))
    steps = ts.reshape(nb, 1).expand(nb, bs).reshape(kc, n)
    deq = (q.float() * s.reshape(nb, 1)).reshape(kc, n)
    tdeq = (tq.float() * ts.reshape(nb, 1)).reshape(kc, n)
    ok_q, share, worst = one_step_rule(deq, tdeq, steps, 1e-4)
    ok_e, share_e, worst_e = one_step_rule(nerr, tnerr, steps, 1e-4,
                                           magnitude=tdeq + tnerr)
    nbytes = ((a.numel() + rhs.numel()) * a.element_size()
              + kc * n * (4 + 1 + 4) + nb * 4)
    b_ms, b_by = bound_ms(nbytes, 2 * b * kc * n, dtype)
    return {
        "case": f"rows={b} tile [{kc},{n}] block {bs} {_dtname(dtype)}",
        "ok": ok_q and ok_e and own_tile_bitwise and repeat,
        "tolerance": "one-step rule (1e-4) on deq(q, scale) and new_error "
                     "against the twin; bitwise against the twin's quantizer "
                     "on the kernel's own tile; bitwise on a repeat",
        "route": cm.fcm_route(a, rhs),
        "splits": (cm.split_plan(kc, n, b, cm.RS_TILE)
                   if cm.fcm_route(a, rhs) == cm.ROUTE_TENSOR_CORES else 0),
        "own_tile_bitwise": own_tile_bitwise, "repeat_bitwise": repeat,
        "far_share": max(share, share_e),
        "worst_steps": max(worst, worst_e),
        "max_abs_err": (deq - tdeq).abs().max().item(),
        **timings(lambda: run(cm.fcm_rs_producer_cuda),
                  lambda: run(cm.fcm_rs_producer_reference),
                  lambda: torch.matmul(a.t(), rhs)),
        "bound_ms": b_ms, "bound_by": b_by}


# an off-path collect well above the timers' floors: W tables of a
# [2048, 3072] tile (~50 MB moved, a ~15 µs bound)
FCM_COLLECT_OFF_PATH = (2048, 3072)


def collect_tables(world, kc, n, bs, offset):
    """W source tables of a [kc, n] tile, the q table `offset` bytes past a
    16-byte boundary: written by the producer kernel from bf16 operands,
    or, at the off-path tile, seeded random bytes and scales."""
    total, nb = kc * n, kc * n // bs
    buf = torch.empty(world * total + 16, dtype=torch.int8, device="cuda")
    qtab = buf[offset:offset + world * total].view(world, nb, bs)
    stab = torch.empty(world, 1, nb, device="cuda")
    if (kc, n) == FCM_COLLECT_OFF_PATH:
        g = torch.Generator(device="cuda").manual_seed(kc + world)
        qtab.copy_(torch.randint(-127, 128, qtab.shape, device="cuda",
                                 generator=g, dtype=torch.int8))
        stab.copy_(torch.rand(stab.shape, device="cuda", generator=g) / 64)
        return qtab, stab
    for src in range(world):
        a, rhs = rs_operands(256, kc, n, torch.bfloat16, src + kc)
        cm.fcm_rs_producer_cuda(a, rhs, None, qtab[src], stab[src], None, bs)
    return qtab, stab


def case_fcm_rs_collect(kc, n, world=FCM_WORLD, offset=0):
    """Kernel J's collect of W tables, bitwise against the ordered sum of
    its twin and against itself on a repeat; the launcher's plan
    (ds_fcm_rs_collect_plan) must be collect_plan's, at the chunk width the
    block size and the q table's offset allow (4 or 1 elements).  At the
    path's tile and the off-path one (W = 4, aligned) also the batched
    timer and, by torch.profiler, the device kernel of one launch and its
    µs with the tables warm in L2 and, L2 flushed first, cold; the share
    of the bound is the cold launch's."""
    bs = lb.largest_divisor_at_most(kc * n, FCM_BLOCK)
    total, nb = kc * n, kc * n // bs
    qtab, stab = collect_tables(world, kc, n, bs, offset)
    kernel = lambda: cm.fcm_rs_collect_cuda(qtab, stab, kc, n)  # noqa: E731
    plain = lambda: cm.fcm_rs_collect_reference(qtab, stab, kc, n)  # noqa: E731
    out, again, ref = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    bitwise = bool((out == ref).all())
    repeat = torch.equal(out, again)
    c_plan = (ctypes.c_int * 4)()
    op_builder.load().ds_fcm_rs_collect_plan(
        qtab.data_ptr(), out.data_ptr(), world, total, bs, c_plan)
    plan = cm.collect_plan(world, total, bs, cm.collect_alignment(
        qtab.data_ptr(), out.data_ptr()))
    want = 4 if bs % 4 == 0 and offset % 4 == 0 else 1
    plan_agrees = tuple(c_plan) == tuple(plan) and plan.width == want
    nbytes = world * (total + nb * 4) + total * 4
    b_ms, b_by = bound_ms(nbytes, 2 * world * total, torch.float32)
    res = {"case": f"W={world} tile [{kc},{n}] block {bs} q offset {offset}",
           "ok": bitwise and repeat and plan_agrees,
           "tolerance": "bitwise; bitwise repeat; the launcher's plan is "
                        "collect_plan's",
           "bitwise": bitwise, "repeat_bitwise": repeat,
           "plan": plan._asdict(), "plan_agrees": plan_agrees,
           "max_abs_err": (out - ref).abs().max().item(),
           "ms": time_ms(kernel),
           "plain_ms": time_ms(plain, runs=YARDSTICK_RUNS),
           "library_ms": None, "host_us": host_us(kernel),
           "bound_ms": b_ms, "bound_by": b_by}
    if world == FCM_WORLD and offset == 0 and (kc, n) in FCM_COLLECT_TIMED:
        res["batched_us"] = batched_us(
            lambda q, sc: cm.fcm_rs_collect_cuda(q, sc, kc, n), (qtab, stab))
    return res


def case_fcm_rs_collect_kernels(kc, n):
    """The device kernels of one collect launch of W = 4 tables of a
    [kc, n] tile (torch.profiler): exactly one, the 4-wide kernel with the
    sources unrolled; its µs with the tables warm in L2 from the call
    before (as on the path, where the producers have just written them)
    and, L2 flushed first, cold, and the cold launch's share of the
    bound."""
    bs = lb.largest_divisor_at_most(kc * n, FCM_BLOCK)
    qtab, stab = collect_tables(FCM_WORLD, kc, n, bs, 0)
    kernel = lambda: cm.fcm_rs_collect_cuda(qtab, stab, kc, n)  # noqa: E731
    events, attempts = device_kernel_events(kernel)
    cold, _ = device_kernel_events(lambda: (_cold_l2(), kernel()))
    cold = [us for name, us in cold if "collect_kernel" in name]
    want = f"collect_kernel<4, {FCM_WORLD}>"
    total = kc * n
    b_ms, _ = bound_ms(FCM_WORLD * (total + total // bs * 4) + total * 4,
                       2 * FCM_WORLD * total, torch.float32)
    device_us_cold = cold[0] if len(cold) == 1 else None
    return {"case": f"W={FCM_WORLD} tile [{kc},{n}] block {bs}",
            "ok": len(events) == 1 and want in events[0][0],
            "tolerance": f"one device kernel, {want}",
            "device_kernels": events, "profiler_sessions": attempts,
            "device_us": events[0][1] if len(events) == 1 else None,
            "device_us_cold": device_us_cold, "bound_us": b_ms * 1e3,
            "bound_share": b_ms * 1e3 / device_us_cold if device_us_cold
            else None}


FCM_TILES = [(k // FCM_WORLD, n) for k, n in FCM_MATRICES.values()]
FCM_DTYPES = (torch.bfloat16, torch.float32)
FCM_PRIMARY_TILE = (FCM_MATRICES["c_fc"][0] // FCM_WORLD,
                    FCM_MATRICES["c_fc"][1])
# the collects also timed on the batched timer and by torch.profiler: the
# path's (c_fc's tile at W = 4) and the off-path one
FCM_COLLECT_TIMED = (FCM_PRIMARY_TILE, FCM_COLLECT_OFF_PATH)


# head dims above the tiled kernels' 256 (csrc/attention_wide.cuh)
WIDE_HEAD_DIMS = (264, 320, 512)
GPT2_INT8_SHAPES = ((768, 2304), (768, 768), (768, 3072), (3072, 768))
PARITY_CASES = {
    # the route checks read device kernel names from torch.profiler, first:
    # on some machines its sessions lose records later in the phase
    # kernel C's four kernels, by the device kernel one launch of each ran
    "dequant_route": (case_dequant_kernels, [
        (8, torch.bfloat16), (8, torch.float32), (1024, torch.bfloat16),
        (1024, torch.float32)]),
    # kernel H's route, by the device kernels one launch of each entry
    # point ran
    "fcm_tile_route": (case_fcm_tile_kernels, [
        (entry, dt) for entry in ("ag", "ag_t", "rs") for dt in FCM_DTYPES]),
    # kernel J's collect: its device kernel and µs, warm and cold
    "fcm_rs_collect_kernels": (case_fcm_rs_collect_kernels,
                               list(FCM_COLLECT_TIMED)),
    # kernels A's and D's device kernels per call, by torch.profiler
    "layer_norm_kernels": (case_layer_norm_kernels, [
        (entry,) for entry in ("A serve", "A train", "D train",
                               "A train autograd", "D train autograd")]),
    # kernel A: every width at decode's, a prompt's and prefill's rows, x
    # and gamma / beta each in bf16 and fp32 (hidden 768 timed), the train
    # step's rows (batched timer), and two widths past the registers (the
    # streamed route)
    "layer_norm_fwd": (case_layer_norm, [
        (rows, dt, h, pdt) for h in LN_WIDTHS for rows in LN_ROWS
        for dt in LN_DTYPES for pdt in LN_DTYPES]
        + [(TRAIN_BATCH * TRAIN_SEQ, torch.bfloat16, 768, pdt)
           for pdt in LN_DTYPES]
        # GPT-2 medium's and large's training shapes; an fp16 run's gamma
        # and beta at the train step's rows, and at decode's and an odd
        # width's (the scalar route)
        + [(rows, torch.bfloat16, h, torch.float32)
           for rows, h in LN_TRAIN_SHAPES]
        + [(TRAIN_BATCH * TRAIN_SEQ, torch.bfloat16, 768, torch.float16),
           (8, torch.float32, 768, torch.float16),
           (77, torch.bfloat16, 771, torch.float16),
           (8, torch.bfloat16, 16385, torch.float16)]
        + [(rows, dt, h, dt) for rows in LN_STREAMED_ROWS
           for h in LN_STREAMED_WIDTHS for dt in LN_DTYPES]),
    "flash_attention_fwd": (case_flash, [
        (8, 12, 128, 64, True, dt) for dt in (torch.bfloat16, torch.float32)]
        + [(2, 12, 1024, 64, causal, dt) for causal in (True, False)
           for dt in (torch.bfloat16, torch.float32)]
        + [(2, 12, 77, 64, True, dt) for dt in (torch.bfloat16, torch.float32)]
        # the layer's layout: strided head views of the fused projection
        + [(8, 12, 128, 64, True, dt, True)
           for dt in (torch.bfloat16, torch.float32)]
        # the other head dims the kernel is built for, at a ragged length
        + [(2, 8, 200, 128, True, dt) for dt in (torch.bfloat16, torch.float32)]
        + [(2, 4, 200, d, True, dt) for d in (32, 96)
           for dt in (torch.bfloat16, torch.float32)]
        # head dims between the compiled ones (80 runs the D = 96 kernel);
        # 36 (the tensor-core route pads it to 40), 136 and 256 (the D = 256
        # kernel: two column groups on the tensor cores, 32-row tiles on
        # the CUDA cores)
        + [(2, 4, 200, d, True, dt) for d in (40, 80, 36, 136, 256)
           for dt in (torch.bfloat16, torch.float32)]
        # D = 256 at the training length, beside SDPA's flash forward
        + [(2, 12, 1024, 256, True, torch.bfloat16)]
        # head dims above 256: the wide kernels, three and four column
        # chunks, in both dtypes; D = 512 at the training length beside
        # SDPA's backend for that D
        + [(2, 4, 200, d, True, dt) for d in WIDE_HEAD_DIMS
           for dt in (torch.bfloat16, torch.float32)]
        + [(2, 12, 1024, 512, True, torch.bfloat16)]),
    # kernel C at GPT-2's four int8 products: one decode row, the decode
    # batch (the GEMV), a 77-token prompt and the 8 x 128 prefill (bf16 on
    # the tensor cores, fp32 the tiled kernel)
    "dequant_matmul": (case_dequant, [
        (m, k, n, groups, dt) for m in (8, 1, 77, 1024)
        for (k, n) in GPT2_INT8_SHAPES
        for groups in (1, 8) for dt in (torch.bfloat16, torch.float32)]),
    # kernel C's backward (an autograd Function, the JAX package's
    # backward in plain PyTorch) at decode's and prefill's rows, and an
    # int8 layer differentiated end to end
    "dequant_matmul_grad": (case_dequant_grad, [
        (m, groups) for m in (8, 1024) for groups in (1, 8)]),
    "int8_layer_grad": (case_int8_layer_grad, [()]),
    # kernel D: the same grid, one row, the train step's and
    # train_longseq's rows (batched timer), and the streamed route
    "layer_norm_bwd": (case_layer_norm_bwd, [
        (rows, dt, h, pdt) for h in LN_WIDTHS for rows in LN_ROWS
        for dt in LN_DTYPES for pdt in LN_DTYPES]
        + [(1, dt, 768, torch.float32) for dt in LN_DTYPES]
        + [(TRAIN_BATCH * TRAIN_SEQ, dt, 768, pdt) for dt in LN_DTYPES
           for pdt in LN_DTYPES]
        + [(LONG_BATCH * LONG_SEQ, torch.bfloat16, 768, torch.bfloat16)]
        + [(rows, torch.bfloat16, h, torch.float32)
           for rows, h in LN_TRAIN_SHAPES]
        + [(TRAIN_BATCH * TRAIN_SEQ, torch.bfloat16, 768, torch.float16),
           (8, torch.float32, 768, torch.float16),
           (77, torch.bfloat16, 771, torch.float16),
           (8, torch.bfloat16, 16385, torch.float16)]
        + [(rows, dt, h, dt) for rows in LN_STREAMED_ROWS
           for h in LN_STREAMED_WIDTHS for dt in LN_DTYPES]),
    # kernel B's training case: dropout inside the kernel, at the train
    # phase's shape and layout, a ragged fp32 one, and train_longseq's
    # length with batch and heads cut so that the plain twin's [S, S] fp32
    # scores fit (1 GiB)
    "flash_attention_fwd_dropout": (case_flash, [
        (TRAIN_BATCH, 12, TRAIN_SEQ, 64, True, torch.bfloat16, True,
         DROPOUT),
        (2, 4, 77, 64, True, torch.float32, False, DROPOUT),
        (1, 4, LONG_SEQ, 64, True, torch.bfloat16, True, DROPOUT)]),
    # kernel E: the train shape with dropout off and on, a ragged fp32
    # length, the other head dim in both routes, and train_longseq's length
    # cut as kernel B's
    "flash_attention_bwd": (case_flash_bwd, [
        (TRAIN_BATCH, 12, TRAIN_SEQ, 64, True, torch.bfloat16, True, rate)
        for rate in (0.0, DROPOUT)]
        + [(2, 4, 77, 64, True, torch.float32, False, DROPOUT)]
        + [(2, 8, 200, 128, True, dt, False, DROPOUT)
           for dt in (torch.float32, torch.bfloat16)]
        + [(2, 4, 200, d, True, dt, False, DROPOUT) for d in (32, 96)
           for dt in (torch.float32, torch.bfloat16)]
        + [(2, 4, 200, d, True, dt, False, DROPOUT)
           for d in (40, 80, 36, 136, 256)
           for dt in (torch.float32, torch.bfloat16)]
        + [(1, 4, LONG_SEQ, 64, True, torch.bfloat16, True, DROPOUT)]
        # D = 256 at the training length, dropout off, beside SDPA's
        # flash backward
        + [(2, 12, 1024, 256, True, torch.bfloat16)]
        # head dims above 256 (the wide kernels), dropout on, both dtypes;
        # D = 512 at the training length, dropout off
        + [(2, 4, 200, d, True, dt, False, DROPOUT) for d in WIDE_HEAD_DIMS
           for dt in (torch.float32, torch.bfloat16)]
        + [(2, 12, 1024, 512, True, torch.bfloat16)]),
    # kernels F and G: (a) bench_sparse_longseq's attention, (b) the
    # Fixed layout of tests/tpu/test_kernel_parity_tpu.py:226-228 causal
    # and not, (c) D = 128, (d) a layout with an empty causal row, (e) a
    # non-causal BigBird, (f) D = 32 and 96; in both dtypes (bf16: the
    # tensor cores, fp32: the CUDA cores) but (a) and (c)
    "block_sparse_flash": (case_block_sparse, [
        ("bigbird", LONG_BATCH, 12, LONG_SEQ, 64, 512, torch.bfloat16, True,
         True)]
        + [("fixed", 1, 4, 1024, 64, 128, dt, causal)
           for causal in (True, False)
           for dt in (torch.float32, torch.bfloat16)]
        + [("bigbird", 2, 4, 1024, 128, 128, torch.bfloat16, True)]
        + [("empty-causal-row", 2, 2, 256, 64, 64, dt, True)
           for dt in (torch.float32, torch.bfloat16)]
        + [("bigbird", 2, 4, 1024, 64, 128, dt, False, True)
           for dt in (torch.bfloat16, torch.float32)]
        + [("bigbird", 2, 4, 1024, d, 128, dt, True, True)
           for d in (32, 96, 40, 80, 36, 136, 256) + WIDE_HEAD_DIMS
           for dt in (torch.bfloat16, torch.float32)]),
    # SparseSelfAttention at layout blocks F and G cannot tile: the gather
    # path on the card, counted, F and G not launched
    "sparse_gather": (case_sparse_gather, [
        (block, causal) for block in (16, 32) for causal in (True, False)]),
    # the 16-byte rule of the tensor-core route: each attention launch with
    # a misaligned bf16 operand, against the same call on an aligned copy
    "realigned_operand": (case_realigned, [("flash",), ("block_sparse",)]),
    # kernel H: its three launchers at the tiles of the three matrices,
    # every payload layout, both operand types
    "fcm_tile_ag": (case_fcm_tile_ag, [
        (FCM_ROWS, kc, n, bits, dt) for kc, n in FCM_TILES
        for bits in (8, 4, 0) for dt in FCM_DTYPES]),
    "fcm_tile_ag_t": (case_fcm_tile_ag_t, [
        (FCM_ROWS, kc, n, bits, dt) for kc, n in FCM_TILES
        for bits in (8, 4, 0) for dt in FCM_DTYPES]),
    "fcm_tile_rs": (case_fcm_tile_rs, [
        (FCM_ROWS, kc, n, dt) for kc, n in FCM_TILES for dt in FCM_DTYPES]),
    # kernel I: a step that accumulates and the last step's cast (int8 at
    # every tile in both dtypes), int4 and native payloads at every tile
    # and the first step at c_fc's in bf16 (the tensor cores; fp32 takes
    # the CUDA cores), and the transposed step likewise
    "fcm_ag_step": (case_fcm_ag_step, [
        (FCM_ROWS, kc, n, 8, dt, step) for kc, n in FCM_TILES
        for dt in FCM_DTYPES for step in ("accumulate", "last")]
        + [(FCM_ROWS, kc, n, bits, torch.bfloat16, "accumulate")
           for kc, n in FCM_TILES for bits in (4, 0)]
        + [(FCM_ROWS, *FCM_PRIMARY_TILE, bits, torch.bfloat16, "first")
           for bits in (8, 4)]),
    "fcm_ag_step_t": (case_fcm_ag_step_t, [
        (FCM_ROWS, kc, n, 8, dt) for kc, n in FCM_TILES for dt in FCM_DTYPES]
        + [(FCM_ROWS, kc, n, bits, torch.bfloat16) for kc, n in FCM_TILES
           for bits in (4, 0)]),
    # kernel J: the producer (and an odd shape whose blocks do not fit the
    # epilogue's tile: the second launch quantizes) and the collect
    "fcm_rs_producer": (case_fcm_rs_producer, [
        (FCM_ROWS, kc, n, dt) for kc, n in FCM_TILES for dt in FCM_DTYPES]
        + [(70, dt_kc, 50, dt) for dt_kc, dt in ((33, torch.float32),
                                                 (33, torch.bfloat16))]),
    # the collect: W = 4 at every tile and at an odd one (bs = 165: one
    # element a thread), W = 2, 8 and 9 (sources in groups of four) and a
    # q table 4 bytes (4 elements a thread) and 2 bytes (one) off the
    # 16-byte boundary at c_fc's, and the off-path [2048, 3072] tile
    "fcm_rs_collect": (case_fcm_rs_collect, FCM_TILES + [(33, 50)] + [
        (*FCM_PRIMARY_TILE, world) for world in (2, 8, 9)]
        + [(*FCM_PRIMARY_TILE, FCM_WORLD, offset) for offset in (4, 2)]
        + [FCM_COLLECT_OFF_PATH]),
}
# the case each kernel's entry of the `kernels` line reports: the shape and
# layout its path runs most (LN forward at prefill, dequant at decode; the
# flash forward, LN backward and flash backward at the training step)
PRIMARY = {"layer_norm_fwd": (1024, torch.bfloat16, 768, torch.float32),
           "flash_attention_fwd_dropout": (TRAIN_BATCH, 12, TRAIN_SEQ, 64,
                                           True, torch.bfloat16, True,
                                           DROPOUT),
           "dequant_matmul": (8, 768, 3072, 1, torch.bfloat16),
           "layer_norm_bwd": (TRAIN_BATCH * TRAIN_SEQ, torch.bfloat16, 768,
                              torch.bfloat16),
           "flash_attention_bwd": (TRAIN_BATCH, 12, TRAIN_SEQ, 64, True,
                                   torch.bfloat16, True, DROPOUT),
           "block_sparse_flash": PARITY_CASES["block_sparse_flash"][1][0],
           # kernels H, I, J: c_fc's tile, int8 payload, bf16 operands
           "fcm_tile_ag": (FCM_ROWS, *FCM_PRIMARY_TILE, 8, torch.bfloat16),
           "fcm_tile_ag_t": (FCM_ROWS, *FCM_PRIMARY_TILE, 8, torch.bfloat16),
           "fcm_tile_rs": (FCM_ROWS, *FCM_PRIMARY_TILE, torch.bfloat16),
           "fcm_ag_step": (FCM_ROWS, *FCM_PRIMARY_TILE, 8, torch.bfloat16,
                           "accumulate"),
           "fcm_ag_step_t": (FCM_ROWS, *FCM_PRIMARY_TILE, 8, torch.bfloat16),
           "fcm_rs_producer": (FCM_ROWS, *FCM_PRIMARY_TILE, torch.bfloat16),
           "fcm_rs_collect": FCM_PRIMARY_TILE}
# the KERNELS entries a group of parity cases reports for
REPORTS_FOR = {"flash_attention_fwd_dropout": ("flash_attention_fwd",),
               "flash_attention_bwd": ("flash_attention_bwd_dkdv",
                                       "flash_attention_bwd_dq"),
               "block_sparse_flash": ("block_sparse_flash_fwd",
                                      "block_sparse_flash_bwd_dq",
                                      "block_sparse_flash_bwd_dkdv")}


def phase_parity():
    results, failed = {}, []
    for group, (fn, cases) in PARITY_CASES.items():
        for args in cases:
            t0 = time.perf_counter()
            res = fn(*args)
            emit({"phase": "parity", "kernel": group, **res,
                  "case_seconds": round(time.perf_counter() - t0, 3)})
            if args == PRIMARY.get(group):
                for name in REPORTS_FOR.get(group, (group,)):
                    per_launch = res.get("launches", {}).get(name, {})
                    results[name] = {**res, **per_launch}
            if not res["ok"]:
                failed.append(f"{group} {res['case']}")
    check(not failed, f"kernels disagree with their plain twins: {failed}")
    n_cases = sum(len(c) for _, c in PARITY_CASES.values())
    return results, {"cases": n_cases}


def run_parity():
    """Phase 2, then the `device_resources` line from phase 1's dumps:
    phase 2's results."""
    results = run_phase("parity", phase_parity)
    run_phase("device_resources", phase_device_resources)
    return results


# --------------------------------------------------------------------- #
# phases 3 and 4
# --------------------------------------------------------------------- #
def gpt2_124m():
    return GPT2Config(vocab_size=50304, n_positions=256, hidden_size=768,
                      num_layers=12, num_heads=12, bf16=True)


def rel_err(out, ref):
    return ((out - ref).abs().max() / ref.abs().max()).item()


def timed(fn, *args, **kwargs):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def fp32_serving_reference(cfg, state, prompt, quantization_setting):
    """`serve`'s reference: the same weights through init_inference in
    fp32 with every kernel's plain version in its place (`plain_versions`,
    on the card, TF32 off): the forward's logits of `prompt`, then a
    prefill and NEW_TOKENS - 1 decode steps fed its own greedy tokens,
    each step's head logits and token, on the host."""
    with plain_versions():
        ref_eng = dst.init_inference(GPT2Model(replace(cfg, bf16=False)),
                                     model_parameters=state,
                                     quantization_setting=quantization_setting)
        prompt = prompt.cuda()
        logits = ref_eng.forward(prompt).cpu()
        total = PROMPT + NEW_TOKENS
        caches = ref_eng.init_caches(BATCH, total)
        out = ref_eng.prefill(prompt, caches)
        steps = []
        for pos in range(PROMPT, total):
            tok = out.argmax(-1)
            steps.append((out.cpu(), tok.cpu()))
            if pos < total - 1:
                out = ref_eng.decode_step(tok, pos, caches)
        del ref_eng, caches, out
    gc_cuda()
    return logits, steps


def teacher_forced_errors(eng, steps, prompt):
    """A prefill and NEW_TOKENS - 1 decode steps (the positions a generate
    of NEW_TOKENS decodes) on the card, fed the reference's greedy tokens
    (`steps`, fp32_serving_reference's): max|d| / max|ref| of each step's
    head logits, and the share of rows whose argmax agrees."""
    caches = eng.init_caches(BATCH, PROMPT + NEW_TOKENS)
    out = eng.prefill(prompt.cuda(), caches).cpu()
    errs, agree = [], []
    for i, (ref, tok) in enumerate(steps):
        errs.append(rel_err(out, ref))
        agree.append((out.argmax(-1) == tok).float().mean().item())
        if i < len(steps) - 1:
            out = eng.decode_step(tok.cuda(), PROMPT + i, caches).cpu()
    return errs, float(np.mean(agree))


def serve(cfg, state, prompt, quantization_setting, expected_launches):
    """One engine on the card, held against its fp32 twin on the same
    weights (fp32_serving_reference: forward, then teacher-forced
    decode), and one counted generate.  Returns the engine, its greedy
    tokens and the phase summary."""
    ref, steps = fp32_serving_reference(cfg, state, prompt,
                                        quantization_setting)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    eng = dst.init_inference(GPT2Model(cfg), model_parameters=state,
                             quantization_setting=quantization_setting)
    logits = eng.forward(prompt.cuda()).cpu()
    check(logits.shape == (BATCH, PROMPT, cfg.vocab_size),
          f"logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    err = rel_err(logits, ref)
    check(err <= LOGIT_REL_TOL, f"logits vs fp32: max|d|/max|ref| = {err}")
    first_agree = (logits[:, -1].argmax(-1) == ref[:, -1].argmax(-1)).float()
    del ref, logits

    step_errs, step_agree = teacher_forced_errors(eng, steps, prompt)
    del steps
    worst = int(np.argmax(step_errs))
    check(step_errs[worst] <= LOGIT_REL_TOL,
          f"teacher-forced step {worst} (0 = prefill) head logits vs "
          f"fp32: max|d|/max|ref| = {step_errs[worst]}")

    eng.generate(prompt, max_new_tokens=4)  # warm-up
    reset_launch_counts()
    toks = eng.generate(prompt, max_new_tokens=NEW_TOKENS)
    counts = launch_counts()
    check(counts == expected_launches,
          f"launch counts {counts}, expected {expected_launches}")
    realigned = check_aligned("generate")
    toks = toks.cpu()
    check(toks.shape == (BATCH, NEW_TOKENS), f"tokens {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "token ids out of range")
    summary = {
        "logits_rel_err": err, "logits_rel_tol": LOGIT_REL_TOL,
        "reference": "the port's plain versions in fp32 on the card",
        "first_token_agreement_vs_fp32": first_agree.mean().item(),
        "decode_steps_checked": len(step_errs) - 1,
        "decode_logits_rel_err_max": step_errs[worst],
        "decode_logits_rel_err_max_step": worst,
        "decode_logits_rel_err_median": float(np.median(step_errs)),
        "decode_argmax_agreement_vs_fp32": step_agree,
        "launches": counts, "realigned": realigned,
        "peak_memory_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30}
    return eng, toks, summary


def _union_us(intervals):
    """Length of the union of (start, end) intervals, in their unit."""
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def device_profile(eng, prompt, prefill_ms, decode_step_ms):
    """Where a generate's time goes: the device-busy time of a prefill-only
    generate and of a PROFILED_TOKENS one under torch.profiler (CUDA
    activity), the decode steps' device time by difference, each as a share
    of the unprofiled wall time, and the ops with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    busy_us, dequant_us, ops = {}, {}, {}
    for new in (1, PROFILED_TOKENS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            timed(eng.generate, prompt, max_new_tokens=new)
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy_us[new] = _union_us((e.time_range.start, e.time_range.end)
                                 for e in kernels)
        ops = {}
        for e in kernels:
            ops[e.name] = ops.get(e.name, 0.0) + e.time_range.elapsed_us()
        dequant_us[new] = sum(us for name, us in ops.items()
                              if any(kn in name for kn in
                                     DEQUANT_ROUTE_KERNELS.values()))
    if not busy_us[PROFILED_TOKENS]:
        return {"device_busy": "not measured: torch.profiler recorded no "
                               "device activity"}
    steps = PROFILED_TOKENS - 1
    step_device_ms = (busy_us[PROFILED_TOKENS] - busy_us[1]) / 1e3 / steps
    step_dequant_ms = (dequant_us[PROFILED_TOKENS] - dequant_us[1]) / 1e3 / steps
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:6]
    return {
        "prefill_device_ms": busy_us[1] / 1e3,
        "prefill_device_busy_share": busy_us[1] / 1e3 / prefill_ms,
        "decode_step_device_ms": step_device_ms,
        "decode_device_busy_share": step_device_ms / decode_step_ms,
        # kernel C's device time in a decode step and in the prefill (0
        # for bf16 serving)
        "decode_step_dequant_device_ms": step_dequant_ms,
        "decode_step_dequant_share": step_dequant_ms / step_device_ms,
        "prefill_dequant_device_ms": dequant_us[1] / 1e3,
        f"top_device_ms_generate_{PROFILED_TOKENS}": {
            name[:80]: us / 1e3 for name, us in top}}


def expected_counts(**launches):
    """Every kernel's expected launch count: the given ones, 0 for the
    rest."""
    return {k.name: launches.get(k.name, 0) for k in KERNELS}


def phase_serve_bf16(cfg, state, prompt):
    per_gen = cfg.num_layers * 2 + 1
    expected = expected_counts(layer_norm_fwd=per_gen * NEW_TOKENS,
                               flash_attention_fwd=cfg.num_layers)
    served = serve(cfg, state, prompt, None, expected)
    return served, served[2]


def phase_serve_int8(cfg, state, prompt, bf16_toks):
    per_gen = cfg.num_layers * 2 + 1
    expected = expected_counts(
        layer_norm_fwd=per_gen * NEW_TOKENS,
        flash_attention_fwd=cfg.num_layers,
        dequant_matmul=4 * cfg.num_layers * NEW_TOKENS)
    served = serve(cfg, state, prompt, 1, expected)
    summary = served[2]
    summary["greedy_agreement_vs_bf16"] = (served[1] == bf16_toks).float().mean().item()
    return served, summary


def phase_timing(prompt, served):
    """Prefill (a generate of one token) and generate of NEW_TOKENS for each
    engine, TIMING_ROUNDS of each, the engines in turns and the order
    reversed every round, so that a drift of the host's speed falls on
    both; decode is the generate minus the median prefill."""
    names = list(served)
    prefill = {name: [] for name in names}
    gen = {name: [] for name in names}
    for r in range(TIMING_ROUNDS):
        for name in (names if r % 2 == 0 else names[::-1]):
            eng = served[name][0]
            prefill[name].append(
                timed(eng.generate, prompt, max_new_tokens=1)[1])
            gen[name].append(
                timed(eng.generate, prompt, max_new_tokens=NEW_TOKENS)[1])
    out = {}
    for name in names:
        pre = float(np.median(prefill[name]))
        tok_s = [BATCH * (NEW_TOKENS - 1) / (g - pre) for g in gen[name]]
        out[name] = {
            "prefill_ms": pre * 1e3,
            "prefill_ms_min_max": [min(prefill[name]) * 1e3,
                                   max(prefill[name]) * 1e3],
            "decode_tokens_per_s": float(np.median(tok_s)),
            "decode_tokens_per_s_min_max": [min(tok_s), max(tok_s)],
            "decode_step_ms": (float(np.median(gen[name])) - pre) * 1e3
                              / (NEW_TOKENS - 1),
            "generate_tokens_per_s": BATCH * NEW_TOKENS
                                     / float(np.median(gen[name]))}
    return out, out


def phase_profile(prompt, served, timing):
    """device_profile of each served engine, once all are timed."""
    return None, {name: device_profile(eng, prompt,
                                       timing[name]["prefill_ms"],
                                       timing[name]["decode_step_ms"])
                  for name, (eng, _, _) in served.items()}


# --------------------------------------------------------------------- #
# phases 7 and 8: training
# --------------------------------------------------------------------- #
def gpt2_124m_train(**overrides):
    """bench_gpt2's model: GPT-2 124M at n_positions = S = 1024, bf16,
    dropout 0.1 with the attention dropout inside kernel B."""
    return replace(gpt2_124m(), n_positions=TRAIN_SEQ, **overrides)


def step_counts(cfg, recomputes=None):
    """Launch counts of one training forward + backward: the dense layers
    run kernels B and E, the sparse ones F and G.  Under activation
    checkpointing the backward runs each layer's forward again (its two
    LayerNorms and its attention), so A counts 4L + 1 and B (or F) 2L,
    while D and E (or G) are unchanged.  `recomputes`: the forwards of
    each layer past the first (default 1 under activation checkpointing,
    else 0)."""
    layers = cfg.num_layers
    n_ln, n_attn = 2 * layers + 1, layers
    if recomputes is None:
        recomputes = int(cfg.activation_checkpointing)
    recompute = recomputes * layers
    fwd_ln, fwd_attn = n_ln + 2 * recompute, n_attn + recompute
    if cfg.sparse_attention is not None:
        return expected_counts(layer_norm_fwd=fwd_ln, layer_norm_bwd=n_ln,
                               block_sparse_flash_fwd=fwd_attn,
                               block_sparse_flash_bwd_dq=n_attn,
                               block_sparse_flash_bwd_dkdv=n_attn)
    return expected_counts(layer_norm_fwd=fwd_ln, layer_norm_bwd=n_ln,
                           flash_attention_fwd=fwd_attn,
                           flash_attention_bwd_dkdv=n_attn,
                           flash_attention_bwd_dq=n_attn)


def train_engine(cfg, state, ds_config):
    """initialize on the card with cfg's model and `state`'s weights, the
    mesh built anew from ds_config's "mesh" block."""
    dst.reset_mesh_context()
    return dst.initialize(model=GPT2Model(cfg), model_parameters=state,
                          config=ds_config)[0]


def phase_train_grads(state):
    """One loss and its parameter grads on the card (bf16, through the
    engine) against the same weights through the port on the CPU in
    fp32."""
    cfg = gpt2_124m_train(embd_dropout=0.0, attn_dropout=0.0,
                          hidden_dropout=0.0)
    ids = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (GRADS_BATCH, TRAIN_SEQ)))
    return grads_vs_cpu(cfg, state, ids, dict(
        BENCH_GPT2_CONFIG, train_micro_batch_size_per_gpu=GRADS_BATCH))


@contextlib.contextmanager
def plain_versions():
    """Every kernel wrapper of the port takes its plain PyTorch version on
    the card too (the `use_kernel` of ops/dispatch.py, where each module
    bound it, answers False), with TF32 off: the code the CPU tests hold
    against the JAX package, run in fp32 on the card."""
    kernel_route = dispatch.use_kernel
    bound = [m for m in list(sys.modules.values())
             if getattr(m, "__name__", "").startswith("deepspeed_tpu_torch")
             and getattr(m, "use_kernel", None) is kernel_route]
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    for mod in bound:
        mod.use_kernel = lambda *tensors: False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        for mod in bound:
            mod.use_kernel = kernel_route
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def fp32_reference(cfg, state, ids):
    """(loss, {name: grad on the host}, seconds) of `ids` through the port
    in fp32 on the card with every kernel's plain version in its place
    (`plain_versions`; no kernel launched), from the weights `state`: the
    _grads phases' reference (the same function the CPU tests hold
    against the JAX package, at the card's speed)."""
    t0 = time.perf_counter()
    reset_launch_counts()
    with plain_versions():
        model = GPT2Model(replace(cfg, bf16=False)).cuda()
        model.load_state_dict(state)
        loss = model.loss(ids.cuda())
        loss.backward()
        torch.cuda.synchronize()
    check(not any(launch_counts().values()),
          f"the fp32 reference launched kernels: {launch_counts()}")
    grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
    loss = loss.item()
    del model
    gc_cuda()
    return loss, grads, time.perf_counter() - t0


def grads_vs_cpu(cfg, state, ids, ds_config):
    """The loss of `ids` and every parameter grad, through initialize ->
    forward -> backward on the card in cfg's dtype, against the same
    weights through the port's plain versions in fp32 (`fp32_reference`);
    launch counters exact."""
    ref_loss, ref_grads, ref_seconds = fp32_reference(cfg, state, ids)

    engine = train_engine(cfg, state, ds_config)
    reset_launch_counts()
    loss = engine.forward(ids)
    engine.backward(loss)
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts == step_counts(cfg),
          f"launch counts {counts}, expected {step_counts(cfg)}")
    realigned = check_aligned("forward + backward")
    loss_err = abs(loss.item() - ref_loss) / abs(ref_loss)
    check(loss_err <= LOSS_REL_TOL, f"loss vs fp32: {loss_err}")
    grad_errs = {}
    for name, p in engine.module.named_parameters():
        grad = p.grad.float().cpu()
        check(bool(torch.isfinite(grad).all()), f"non-finite grad of {name}")
        grad_errs[name] = rel_err(grad, ref_grads[name])
    worst = max(grad_errs, key=grad_errs.get)
    check(grad_errs[worst] <= GRAD_REL_TOL,
          f"grad of {worst} vs fp32: max|d|/max|ref| = "
          f"{grad_errs[worst]}")
    return None, {
        "loss": loss.item(), "fp32_reference_loss": ref_loss,
        "loss_rel_err": loss_err, "loss_rel_tol": LOSS_REL_TOL,
        "grads_checked": len(grad_errs), "worst_param": worst,
        "worst_grad_rel_err": grad_errs[worst], "grad_rel_tol": GRAD_REL_TOL,
        "median_grad_rel_err": float(np.median(list(grad_errs.values()))),
        "launches_per_step": counts, "realigned": realigned,
        "reference": "the port's plain versions in fp32 on the card",
        "reference_seconds": ref_seconds}


def _profile_once(fn):
    """(wall ms, device-busy ms, {op: device ms}, [(name, device ms)] in
    launch order) of one fn() under torch.profiler, synchronised on both
    sides.  Only device activity is traced (as device_spans): the host's
    ops were most of the trace's parse, and slow the enqueueing they
    record.  A session can lose the records of its first kernels (a
    replay's first layer was lost once): it starts with a short spin
    kernel, waited for and left out, as device_kernel_events does."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        _, wall = timed(fn)
    # a record_function range on the card (the fused transports'
    # "fcm_fused") is an annotation, not a kernel: left out of busy time
    kernels = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and "spin_kernel" not in e.name
                      and not getattr(e, "is_user_annotation", False)),
                     key=lambda e: e.time_range.start)
    ops = {}
    for e in kernels:
        ops[e.name] = ops.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = _union_us((e.time_range.start, e.time_range.end)
                     for e in kernels) / 1e3
    return wall * 1e3, busy, ops, [(e.name, e.time_range.elapsed_us() / 1e3)
                                   for e in kernels]


def layer_norm_in_step(kernels):
    """Kernels A's and D's part of a profiled step: their launches and
    device ms, and the cast / copy and fill kernels that sit next to a run
    of them in launch order (with their names)."""
    ln = [i for i, (name, _) in enumerate(kernels) if LN_KERNEL.search(name)]
    beside = {}
    for i in ln:
        for j in (i - 1, i + 1):
            if 0 <= j < len(kernels) and j not in beside \
                    and not LN_KERNEL.search(kernels[j][0]) \
                    and CAST_OR_FILL.search(kernels[j][0]):
                beside[j] = kernels[j][0][:140]
    names = {}
    for name in beside.values():
        names[name] = names.get(name, 0) + 1
    return {"ln_kernels": len(ln),
            "ln_device_ms": sum(kernels[i][1] for i in ln),
            "ln_casts_and_fills_beside": len(beside),
            "ln_casts_and_fills_beside_by_name": names}


def timed_training(cfg, state, ds_config, warmup, iters, rank_step=None,
                   keep_losses=False, after_warmup=None):
    """Train on the fixed batch RandomState(0).randint(0, vocab,
    (micro batch x data-parallel world, n_positions)) as bench.py's
    _time_steps times it: warmup steps, then `iters` forward / backward /
    step calls on the host clock (one train_batch call a step when the
    config enables fused_step), closed by fetching the last loss.  Every
    loss finite, the final below the first, the launch counters exact (a
    step's counts on every rank this process drives); the host's time to
    issue a step after a synchronisation; then one step under
    torch.profiler.  Under a process world each process feeds its ranks'
    rows of the global batch, and the rates count the global batch over
    every process's cards.  `rank_step`: what a rank's step launches
    (default step_counts(cfg)); `keep_losses`: the summary holds every step's loss;
    `after_warmup(engine)` runs after the warm-up steps, outside the timed
    steps.  Returns the engine too."""
    micro, seq = ds_config["train_micro_batch_size_per_gpu"], cfg.n_positions
    cards = ([torch.cuda.current_device()] if dist.is_initialized()
             else range(torch.cuda.device_count()))
    torch.cuda.empty_cache()
    base = {}
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
        base[d] = torch.cuda.memory_allocated(d)
    engine = train_engine(cfg, state, ds_config)
    world, local = engine.world_size, engine.local_ranks
    batch = micro * world
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(batch, seq)).astype(np.int32)
    ids = ids[local[0] * micro:(local[-1] + 1) * micro]  # this process's

    fused = ds_config.get("fused_step", {}).get("enabled", False)
    batches = repeat_batch(ids)

    def step():
        if fused:
            return engine.train_batch(batches)
        loss = engine.forward(ids)
        engine.backward(loss)
        engine.step()
        return loss

    check(fused == (engine._fused is not None),
          f"fused_step: {engine.fused_step_reason}")
    reset_launch_counts()
    losses = [step().detach() for _ in range(warmup)]
    losses[-1].item()
    if after_warmup is not None:
        after_warmup(engine)
    t0 = time.perf_counter()
    for _ in range(iters):
        losses.append(step().detach())
    final_loss = losses[-1].item()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    n_steps = warmup + iters
    gas = ds_config.get("gradient_accumulation_steps", 1)
    per_step = {k: gas * len(local) * v
                for k, v in (rank_step or step_counts(cfg)).items()}
    # the fused step's counters count its eager first window and its
    # capture's launch calls; its replays are counted from a trace below
    counted = min(n_steps, 2) if fused else n_steps
    check(counts == {k: counted * v for k, v in per_step.items()},
          f"launch counts {counts} over {n_steps} steps, expected "
          f"{counted} x {per_step}")
    realigned = check_aligned("training steps")
    losses = torch.stack(losses).float().cpu()
    check(bool(torch.isfinite(losses).all()), f"non-finite loss: {losses}")
    check(final_loss < losses[0].item(),
          f"loss did not fall: {losses[0].item()} -> {final_loss}")
    issue_ms = []
    for _ in range(HOST_ISSUE_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step()
        issue_ms.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    used = sorted({engine.mesh.device_of(r).index for r in local})
    n_cards = len(used) * engine.mesh.process_count
    tokens_per_s = iters * gas * batch * seq / seconds
    peak = PEAK_OPS_PER_S[torch.bfloat16] * n_cards
    peaks = {d: (torch.cuda.max_memory_allocated(d) - base[d]) / 2 ** 30
             for d in used}
    wall_ms, busy_ms, ops, kernels = _profile_once(step)
    traced = {}
    if fused:
        traced = traced_launches(kernels)
        check(traced == traced_part(per_step),
              f"a replay's traced launches {traced}, a window's "
              f"{traced_part(per_step)}")
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:6]
    return counts, {
        "batch": [batch, seq], "data_parallel_world": world,
        "cards_used": n_cards,
        "tokens_per_s": tokens_per_s,
        "tokens_per_s_per_card": tokens_per_s / n_cards,
        "ms_per_step": seconds / iters * 1e3,
        "host_issue_ms_per_step": float(np.median(issue_ms)),
        "host_issue_ms_each": issue_ms,
        "flops_per_token": cfg.flops_per_token(),
        "tflops": tokens_per_s * cfg.flops_per_token() / 1e12,
        "mfu": tokens_per_s * cfg.flops_per_token() / peak,
        "mfu_peak": "989 TFLOP/s a card in use, H100 SXM bf16 dense "
                    "(NVIDIA data sheet)",
        "first_loss": losses[0].item(), "final_loss": final_loss,
        "steps": n_steps, "timed_steps": iters,
        "peak_memory_gib": max(peaks.values()),
        "peak_memory_gib_by_card": peaks,
        "launches_per_step": per_step, "realigned": realigned,
        "profiled_step_wall_ms": wall_ms, "profiled_step_device_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "top_device_ms_one_step": {name[:80]: ms for name, ms in top},
        **({"replay_launches_traced": traced} if fused else {}),
        **({"losses": losses.tolist()} if keep_losses else {}),
        **layer_norm_in_step(kernels)}, engine


def phase_train(state):
    """bench_gpt2's step, timed as bench.py's _time_steps.  Returns the
    launch counts and the summary (train_fp16 reads its tokens/s)."""
    counts, summary, _ = timed_training(gpt2_124m_train(), state,
                                        BENCH_GPT2_CONFIG, TRAIN_WARMUP,
                                        TRAIN_ITERS)
    return (counts, summary), summary


# --------------------------------------------------------------------- #
# phases 14 and 15: ZeRO-1/2 data parallelism over W ranks
# --------------------------------------------------------------------- #
def dp_config(micro, stage, world=DP_WORLD):
    """bench_gpt2's config at `micro` rows a rank and ZeRO `stage` on a
    mesh of `world` data-parallel ranks."""
    return dict(BENCH_GPT2_CONFIG, train_micro_batch_size_per_gpu=micro,
                zero_optimization={"stage": stage},
                mesh={"data": world})


def check_ranks(engine):
    """The engine's ranks: DP_WORLD of them, each on a card, and after a
    step every rank's parameters equal rank 0's bitwise."""
    check(engine.world_size == DP_WORLD
          and all(engine.mesh.device_of(r).type == "cuda"
                  for r in range(DP_WORLD)),
          f"the mesh is {engine.mesh}")
    for flat in engine._flats[1:]:
        check(torch.equal(flat.to(engine.device), engine._flat),
              "the ranks' parameters differ after the all-gather")


def phase_train_dp_grads(state):
    """One forward / backward / step of GPT-2 124M (dropout off, bf16) on
    DP_WORLD ranks, DP_GRADS_MICRO rows each, at ZeRO-2 and ZeRO-1, against
    the port's one-rank engine on the card at DP_WORLD rows: the mean loss
    (2e-2), the reduce-scattered grad ranges concatenated (each parameter
    within 5e-2) and the parameters after the step (max|d| / max|ref| over
    the buffer, 5e-2); stages 1 and 2 bitwise equal; the launch counters a
    step's counts on every rank."""
    cfg = gpt2_124m_train(embd_dropout=0.0, attn_dropout=0.0,
                          hidden_dropout=0.0)
    rows = DP_WORLD * DP_GRADS_MICRO
    ids = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (rows, TRAIN_SEQ)))
    ref = train_engine(cfg, state, dict(
        BENCH_GPT2_CONFIG, train_micro_batch_size_per_gpu=rows))
    ref_loss = ref.forward(ids)
    ref.backward(ref_loss)
    n = ref.num_params
    ref_grads = ref._flat_grad[:n].clone()
    ref.step()
    ref_params, ref_loss = ref._flat[:n].clone(), ref_loss.item()
    del ref
    torch.cuda.empty_cache()
    per_step = {k: DP_WORLD * v for k, v in step_counts(cfg).items()}
    stats, flats = {}, {}
    for stage in (2, 1):
        engine = train_engine(cfg, state, dp_config(DP_GRADS_MICRO, stage))
        reset_launch_counts()
        loss = engine.forward(ids)
        engine.backward(loss)
        if stage == 2:
            grads = torch.cat([acc.float().to(engine.device)
                               for acc in engine._acc])[:n] / DP_WORLD
        engine.step()
        torch.cuda.synchronize()
        counts = launch_counts()
        check(counts == per_step,
              f"ZeRO-{stage} launch counts {counts}, expected {per_step}")
        check_ranks(engine)
        check_aligned(f"ZeRO-{stage} forward + backward")
        loss_err = abs(loss.item() - ref_loss) / abs(ref_loss)
        check(loss_err <= LOSS_REL_TOL, f"ZeRO-{stage} loss vs one rank: "
              f"{loss_err}")
        param_err = rel_err(engine._flat[:n], ref_params)
        check(param_err <= GRAD_REL_TOL, f"ZeRO-{stage} parameters after "
              f"the step vs one rank: {param_err}")
        stats[f"zero{stage}"] = {"loss": loss.item(),
                                 "loss_rel_err": loss_err,
                                 "params_rel_err": param_err}
        if stage == 2:
            errs = {name: rel_err(grads[o:o + size], ref_grads[o:o + size])
                    for (name, _), (o, size) in zip(engine._named_params,
                                                    engine._segments)}
            worst = max(errs, key=errs.get)
            check(errs[worst] <= GRAD_REL_TOL,
                  f"ZeRO-2 grad range of {worst} vs one rank: {errs[worst]}")
            stats["zero2"].update(
                worst_param=worst, worst_grad_rel_err=errs[worst],
                median_grad_rel_err=float(np.median(list(errs.values()))))
        flats[stage] = engine._flat.clone()
        del engine
        torch.cuda.empty_cache()
    check(torch.equal(flats[1], flats[2]),
          "ZeRO-1 and ZeRO-2 parameters differ")
    return None, {
        "world": DP_WORLD, "rows_a_rank": DP_GRADS_MICRO,
        "one_rank_loss": ref_loss, **stats,
        "loss_rel_tol": LOSS_REL_TOL, "rel_tol": GRAD_REL_TOL,
        "zero1_zero2_bitwise": True, "launches_per_step": per_step}


def held_bytes(engine):
    """What rank 0 holds for the model: the fp32 parameters and the grad
    buffer autograd fills (whole), the ZeRO-2 grad range, the optimizer
    state's range."""
    mib = lambda *ts: sum(t.numel() * t.element_size()  # noqa: E731
                          for t in ts) / 2 ** 20
    acc = engine._acc[0]
    return {"params_mib": mib(engine._flat),
            "grad_buffer_mib": mib(engine._flat_grad),
            "grad_range_mib": mib(acc) if acc is not None else 0.0,
            "optimizer_range_mib": mib(*engine.opt_state.values()),
            "estimate_memory_bytes": engine.estimate_memory()}


def collectives_device_ms(engine):
    """One step's ZeRO-2 reduce-scatter of the grad buffers and all-gather
    of the parameter ranges, on the engine's own buffers: device ms by
    CUDA events (time_ms: the events on the caller's stream, which the
    ranks' streams wait for and rejoin), and the kernels torch.profiler
    records of one call and the sum of their µs (sessions here can lose
    records: the count says how many it kept)."""
    mesh = engine.mesh

    def reduce_scatter():
        with mesh.forked():
            mesh.reduce_scatter_flat(engine._flat_grads)

    def all_gather():
        with mesh.forked():
            mesh.all_gather_flat([f[lo:hi] for f, (lo, hi) in
                                  zip(engine._flats, engine._ranges)],
                                 out=engine._flats)

    out = {}
    for name, fn in (("reduce_scatter", reduce_scatter),
                     ("all_gather", all_gather)):
        events, sessions = device_kernel_events(fn)
        out[name] = {"device_ms": time_ms(fn),
                     "profiled_kernels": len(events),
                     "profiled_kernel_ms": sum(us for _, us in events) / 1e3,
                     "profiler_sessions": sessions}
    return out


def phase_train_dp(state):
    """bench_gpt2's step on DP_WORLD data-parallel ranks at ZeRO-2, its
    micro-batch of 8 a rank, timed as phase_train."""
    counts, summary, engine = timed_training(
        gpt2_124m_train(), state, dp_config(TRAIN_BATCH, 2), TRAIN_WARMUP,
        TRAIN_ITERS)
    check_ranks(engine)
    summary.update(held_bytes_rank0=held_bytes(engine),
                   collectives=collectives_device_ms(engine))
    coll = summary["collectives"]
    step_ms = summary["profiled_step_device_ms"]
    summary["collectives_share_of_step_device_ms"] = (
        (coll["reduce_scatter"]["device_ms"] + coll["all_gather"]["device_ms"])
        / step_ms if step_ms > 0
        else "not measured: the step's trace held no device kernel")
    return counts, summary


# --------------------------------------------------------------------- #
# phases 16 and 17: checkpoints
# --------------------------------------------------------------------- #
@contextlib.contextmanager
def checkpoint_dir():
    """A fresh directory under build/, removed on exit whether the phase
    passes or fails."""
    os.makedirs(CKPT_DIR, exist_ok=True)
    path = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=CKPT_DIR)
    try:
        yield path
    finally:
        shutil.rmtree(path, ignore_errors=True)


def restorable_state(engine, generators=True):
    """Host copies of what load_checkpoint restores: the parameters,
    every optimizer state tensor over the whole buffer (the ranks' ranges
    gathered), the scaler and, with `generators`, every rank's generator
    state."""
    n = engine.num_params
    host = lambda t: t.detach().to("cpu", copy=True)  # noqa: E731
    out = {"params": host(engine._flat[:n])}
    for key, value in engine.opt_state.items():
        out[key] = (host(value) if key == "count"
                    else torch.from_numpy(engine._gathered(key)[:n].copy()))
    for field, value in zip(LossScaleState._fields, engine.scaler_state):
        out[f"scaler.{field}"] = host(value)
    if generators:
        for r, gen in enumerate(engine._rngs):
            out[f"generator{r}"] = gen.get_state()
    return out


def check_restored(engine, saved, generators=True):
    got = restorable_state(engine, generators)
    check(sorted(got) == sorted(saved), f"restored {sorted(got)}, saved "
          f"{sorted(saved)}")
    for key, value in saved.items():
        check(torch.equal(got[key], value),
              f"the restored {key} differs from what was saved")
    return sorted(saved)


def loss_values(engine, ids, steps):
    """`steps` forward / backward / step calls; the losses as floats."""
    losses = []
    for _ in range(steps):
        loss = engine.forward(ids)
        engine.backward(loss)
        engine.step()
        losses.append(loss.detach())
    return [x.item() for x in losses]


def timed_save(engine, path, tag):
    """(seconds, bytes written, split) of one save_checkpoint,
    synchronised.  The split: the seconds of a separate gather of the
    state into the host trees the save writes, in the engine's layout
    (`gather_seconds`)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if engine._sharded_checkpoints():
        engine._sharded_trees()
    else:
        engine._module_tree(), engine._engine_state()
    gather_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tag_dir = engine.save_checkpoint(path, tag=tag)
    seconds = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(tag_dir, f))
                 for f in os.listdir(tag_dir))
    return seconds, nbytes, {"gather_seconds": gather_s}


def timed_load(engine, path):
    """(seconds, split) of one load_checkpoint, synchronised.  The split:
    the seconds of reading the tag's two .npz files alone (`read_seconds`,
    the files warm in the page cache)."""
    tag_dir = os.path.join(path, ckpt_mod.read_latest_tag(path))
    t0 = time.perf_counter()
    for name in os.listdir(tag_dir):
        if name.endswith(".npz"):
            with np.load(os.path.join(tag_dir, name)) as data:
                [data[k] for k in data.files]
    read_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.load_checkpoint(path)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, {"read_seconds": read_s}


def io_summary(save_s, load_s, nbytes, save_split, load_split):
    return {"save_seconds": save_s, "load_seconds": load_s,
            "bytes_written": nbytes,
            "save_gb_per_s": nbytes / save_s / 1e9,
            "load_gb_per_s": nbytes / load_s / 1e9,
            **save_split, **load_split}


def add_counts(*counts):
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def serve_from_checkpoint(cfg, path, weights, prompt, quant):
    """init_inference(checkpoint=path) against init_inference(
    model_parameters=weights) on the card: the forward's logits and a
    generate of NEW_TOKENS equal bitwise.  Returns the checkpoint engine's
    launch counts (the reference engine's runs are not counted)."""
    ref = dst.init_inference(GPT2Model(cfg), model_parameters=weights,
                             quantization_setting=quant)
    ref_logits = ref.forward(prompt)
    ref_toks = ref.generate(prompt, max_new_tokens=NEW_TOKENS)
    del ref
    reset_launch_counts()
    eng = dst.init_inference(GPT2Model(cfg), checkpoint=path,
                             quantization_setting=quant)
    logits = eng.forward(prompt)
    toks = eng.generate(prompt, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    counts = launch_counts()
    what = "int8" if quant else "bf16"
    check(torch.equal(logits, ref_logits), f"{what} logits served from the "
          "checkpoint differ from model_parameters=")
    check(torch.equal(toks, ref_toks), f"{what} tokens served from the "
          "checkpoint differ from model_parameters=")
    check(bool(torch.isfinite(logits).all()), f"{what}: non-finite logits")
    n_ln, layers = 2 * cfg.num_layers + 1, cfg.num_layers
    expected = expected_counts(
        layer_norm_fwd=n_ln * (1 + NEW_TOKENS),
        flash_attention_fwd=2 * layers,
        dequant_matmul=4 * layers * (1 + NEW_TOKENS) if quant else 0)
    check(counts == expected, f"{what} served from the checkpoint: launch "
          f"counts {counts}, expected {expected}")
    return counts


def phase_checkpoint(state):
    """bench_gpt2's run saved and resumed bitwise, then served from the
    checkpoint in bf16 and int8 (phase 16 of the module docstring)."""
    cfg = gpt2_124m_train()
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)
    other = init_state(cfg, seed=1)
    with checkpoint_dir() as path:
        torch.cuda.empty_cache()
        reset_launch_counts()
        engine = train_engine(cfg, state, BENCH_GPT2_CONFIG)
        before = loss_values(engine, ids, CKPT_STEPS)
        save_s, nbytes, save_split = timed_save(engine, path, "ckpt")
        saved = restorable_state(engine)
        weights = {name: p.detach().cpu().clone()
                   for name, p in engine.module.named_parameters()}
        run_a = loss_values(engine, ids, CKPT_STEPS)
        del engine
        torch.cuda.empty_cache()
        engine = train_engine(cfg, other, BENCH_GPT2_CONFIG)
        load_s, load_split = timed_load(engine, path)
        restored = check_restored(engine, saved)
        run_b = loss_values(engine, ids, CKPT_STEPS)
        torch.cuda.synchronize()
        train_counts = launch_counts()
        del engine
        torch.cuda.empty_cache()
        check(run_b == run_a, f"resumed losses {run_b} differ from the "
              f"uninterrupted run's {run_a}")
        per_step = step_counts(cfg)
        steps = 3 * CKPT_STEPS
        check(train_counts == {k: steps * v for k, v in per_step.items()},
              f"launch counts {train_counts} over {steps} steps, expected "
              f"{per_step} a step")
        prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                               generator=torch.Generator().manual_seed(1))
        served = {what: serve_from_checkpoint(cfg, path, weights, prompt, q)
                  for what, q in (("bf16", None), ("int8", 1))}
    counts = add_counts(train_counts, *served.values())
    return counts, {
        "steps_before_save": CKPT_STEPS, "losses_before_save": before,
        "run_a_losses": run_a, "run_b_losses": run_b,
        "resume_bitwise": True, "restored_bitwise": restored,
        **io_summary(save_s, load_s, nbytes, save_split, load_split),
        "served_from_checkpoint": {
            what: {"logits_and_tokens_bitwise_vs_model_parameters": True,
                   "launches": c} for what, c in served.items()},
        "launches_train": train_counts}


def phase_checkpoint_dp(state):
    """One step at train_dp's config (W = 4, ZeRO-2), saved and loaded at
    W = 1 (phase 17 of the module docstring)."""
    cfg = gpt2_124m_train()
    world_ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(DP_WORLD * TRAIN_BATCH, TRAIN_SEQ)
    ).astype(np.int32)
    other = init_state(cfg, seed=1)
    with checkpoint_dir() as path:
        torch.cuda.empty_cache()
        reset_launch_counts()
        engine = train_engine(cfg, state, dp_config(TRAIN_BATCH, 2))
        check(engine.world_size == DP_WORLD, f"the mesh is {engine.mesh}")
        loss_w4 = loss_values(engine, world_ids, 1)
        save_s, nbytes, save_split = timed_save(engine, path, "w4")
        saved = restorable_state(engine, generators=False)
        del engine
        torch.cuda.empty_cache()
        engine = train_engine(cfg, other, BENCH_GPT2_CONFIG)
        check(engine.world_size == 1, f"the mesh is {engine.mesh}")
        load_s, load_split = timed_load(engine, path)
        restored = check_restored(engine, saved, generators=False)
        loss_w1 = loss_values(engine, world_ids[:TRAIN_BATCH], 1)
        torch.cuda.synchronize()
        counts = launch_counts()
        del engine
        torch.cuda.empty_cache()
    expected = {k: (DP_WORLD + 1) * v for k, v in step_counts(cfg).items()}
    check(counts == expected, f"launch counts {counts}, expected {expected}")
    check(all(np.isfinite(loss_w4 + loss_w1)), "non-finite loss")
    return counts, {"saved_world": DP_WORLD, "loaded_world": 1,
                    "loss_w4": loss_w4, "loss_w1_after_load": loss_w1,
                    "restored_bitwise": restored,
                    **io_summary(save_s, load_s, nbytes, save_split,
                                 load_split)}


# --------------------------------------------------------------------- #
# phases 18 and 19: one process a card (torch.distributed, NCCL)
# --------------------------------------------------------------------- #
MP_TIMEOUT_S = {"train_mp_grads": 600, "train_mp": 900,
                "train_fused_mp": 600, "monitor_mp": 600, "offload_mp": 600,
                "infinity_mp": 600}


@contextlib.contextmanager
def mp_dir():
    """A fresh directory under build/ for the workers' results, removed on
    exit."""
    os.makedirs(CKPT_DIR, exist_ok=True)
    path = tempfile.mkdtemp(prefix="chip_smoke_mp_", dir=CKPT_DIR)
    try:
        yield path
    finally:
        shutil.rmtree(path, ignore_errors=True)


# the mp phases this run drives (main sets them for its mode); the first
# of them launches every one of the same process count in one group
MP_PLANNED = []
_MP_RUNS = {}  # phase: (its directory, each rank's result)


def mp_world(phase):
    """`phase`'s process count: one a visible card; train_fused_mp one (the
    engine graphs no window across cards: ROADMAP A.6c)."""
    return 1 if phase == "train_fused_mp" else torch.cuda.device_count()


@contextlib.contextmanager
def mp_results(phase):
    """(directory, each rank's result) of `phase`'s workers.  The first mp
    phase of a run launches, in one torchrun group, every planned mp phase
    of its process count that has not run (each worker runs them in turn,
    each in a directory of its own), so that a group's start-up, two
    interpreters, CUDA and NCCL (sdpa_first_call.py times one
    interpreter's), is paid once; each phase then takes its own results.
    The directory goes when the phase is done with it."""
    if phase not in _MP_RUNS:
        world = mp_world(phase)
        batch = [phase] + [p for p in MP_PLANNED if p != phase
                           and p not in _MP_RUNS and mp_world(p) == world]
        os.makedirs(CKPT_DIR, exist_ok=True)
        root = tempfile.mkdtemp(prefix="chip_smoke_mp_", dir=CKPT_DIR)
        atexit.register(shutil.rmtree, root, True)
        _MP_RUNS.update(launch_mp(batch, root, world))
    out_dir, results = _MP_RUNS[phase]
    try:
        yield out_dir, results
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def launch_mp(phases, root, world):
    """Run `phases`' workers in `world` processes of this script, one a
    card, through torchrun (`python -m torch.distributed.run
    --standalone`); each joins the group by init_distributed from
    torchrun's env and runs the phases in turn, each into root/<phase>.  A
    worker that fails, or a group that outlives the phases' MP_TIMEOUT_S,
    fails the phase (the group's processes killed).  Returns {phase: (its
    directory, each rank's result)}."""
    log_path = os.path.join(root, "torchrun.log")
    timeout = sum(MP_TIMEOUT_S[p] for p in phases)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={world}", os.path.abspath(__file__),
           "--mp-worker", ",".join(phases), root]
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True,
                                cwd=os.path.dirname(os.path.abspath(__file__)))
        try:
            code = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            code = f"killed after {timeout} s"
        finally:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    if code != 0:
        with open(log_path) as f:
            tail = f.read()[-4000:]
        print(tail, file=sys.stderr, flush=True)
        raise SmokeFailure(f"{','.join(phases)}: the {world} worker "
                           f"processes failed (torchrun: {code}); log tail: "
                           f"{tail[-600:]}")
    runs = {}
    for phase in phases:
        out_dir = os.path.join(root, phase)
        results = []
        for rank in range(world):
            with open(os.path.join(out_dir, f"rank{rank}.json")) as f:
                results.append(json.load(f))
        runs[phase] = (out_dir, results)
    return runs


def mp_worker(phases, root):
    """One worker process of `phases` (comma-separated; run by launch_mp
    under torchrun): it joins the group through init_distributed, runs
    each phase's part in turn and writes rank<r>.json into root/<phase>."""
    dst.init_distributed()
    if not dist.is_initialized():
        # a world of one process: init_distributed leaves it alone, as the
        # JAX module does, so open the one-process NCCL group here for the
        # phase to run the process-group transport all the same
        dist.init_process_group("nccl", rank=0, world_size=1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    op_builder.load()
    for phase in phases.split(","):
        out_dir = os.path.join(root, phase)
        os.makedirs(out_dir, exist_ok=True)
        result = MP_WORKERS[phase](out_dir)
        with open(os.path.join(out_dir, f"rank{dist.get_rank()}.json"),
                  "w") as f:
            json.dump(result, f)
        dist.barrier()
        gc_cuda()
    dist.destroy_process_group()


def sha256(tensor):
    """The digest of a tensor's bytes (any dtype, bf16 included)."""
    raw = tensor.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()


def grad_ranges(engine):
    """The summed grads of the ranges this process's ranks step (fp32):
    the ZeRO-2 accumulator, or the full grad buffer's range."""
    return [acc.float() if acc is not None else grad[lo:hi]
            for acc, grad, (lo, hi) in zip(engine._acc, engine._flat_grads,
                                           engine._ranges)]


def grads_step(engine, rows):
    """One forward / backward / step of `rows` on a fresh count: (loss, the
    grad ranges before the step, the launch counts)."""
    reset_launch_counts()
    loss = engine.forward(rows)
    engine.backward(loss)
    grads = torch.cat([g.to(engine.device) for g in grad_ranges(engine)])
    engine.step()
    torch.cuda.synchronize()
    return loss.item(), grads, launch_counts()


def mp_grads_ids(cfg, world):
    return torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (world * DP_GRADS_MICRO, TRAIN_SEQ)))


def mp_grads_worker(out_dir):
    """train_mp_grads in one process: its DP_GRADS_MICRO rows of the
    global batch through one step at ZeRO-2 and ZeRO-1."""
    cfg = gpt2_124m_train(embd_dropout=0.0, attn_dropout=0.0,
                          hidden_dropout=0.0)
    state = init_state(gpt2_124m_train())
    world, rank = dist.get_world_size(), dist.get_rank()
    rows = mp_grads_ids(cfg, world)[rank * DP_GRADS_MICRO:
                                    (rank + 1) * DP_GRADS_MICRO]
    out = {"rank": rank, "world": world,
           "device": torch.cuda.current_device()}
    for stage in (2, 1):
        engine = train_engine(cfg, state, dp_config(DP_GRADS_MICRO, stage,
                                                    world))
        check(engine.local_ranks == [rank]
              and engine.mesh.process_count == world,
              f"the mesh is {engine.mesh}")
        loss, grads, counts = grads_step(engine, rows)
        out[f"zero{stage}"] = {
            "loss": loss, "params_sha256": sha256(engine._flat),
            "launches": counts, "realigned": realign_counts()}
        if stage == 2:
            torch.save(grads.cpu(), os.path.join(out_dir, f"grads{rank}.pt"))
            if rank == 0:
                torch.save(engine._flat[:engine.num_params].cpu(),
                           os.path.join(out_dir, "params0.pt"))
        del engine
        torch.cuda.empty_cache()
    return out


def phase_train_mp_grads(state):
    """One forward / backward / step of GPT-2 124M (dropout off, bf16) in W
    = every visible card processes, one rank each, DP_GRADS_MICRO rows a
    process, at ZeRO-2 and ZeRO-1, against the single-controller engine
    in this process at "mesh": {"data": W} over the same cards on the same
    global rows: the losses, the grad ranges and the parameters after the
    step bitwise (predicted; held at the training tolerances, and
    reported, if not), ZeRO-1 = ZeRO-2 bitwise, every process's launch
    counters one step's counts."""
    cfg = gpt2_124m_train(embd_dropout=0.0, attn_dropout=0.0,
                          hidden_dropout=0.0)
    torch.cuda.empty_cache()
    with mp_results("train_mp_grads") as (out_dir, results):
        world = len(results)
        grads = torch.cat([torch.load(os.path.join(out_dir, f"grads{r}.pt"))
                           for r in range(world)])
        params = torch.load(os.path.join(out_dir, "params0.pt"))
    ids = mp_grads_ids(cfg, world)
    ref = {}
    for stage in (2, 1):
        engine = train_engine(cfg, state, dp_config(DP_GRADS_MICRO, stage,
                                                    world))
        loss, stage_grads, _ = grads_step(engine, ids)
        ref[stage] = {"loss": loss, "params_sha256": sha256(engine._flat)}
        if stage == 2:
            ref_grads = stage_grads.cpu()
            ref_params = engine._flat[:engine.num_params].cpu()
        del engine
        torch.cuda.empty_cache()
    expected = step_counts(cfg)
    for res in results:
        for stage in (2, 1):
            got = res[f"zero{stage}"]
            check(got["launches"] == expected,
                  f"rank {res['rank']} ZeRO-{stage} launches "
                  f"{got['launches']}, expected {expected}")
            check(not any(got["realigned"].values()),
                  f"rank {res['rank']}: realigned {got['realigned']}")
    check(len({res["device"] for res in results}) == world,
          f"the processes share cards: {[r['device'] for r in results]}")
    digests = {res[f"zero{s}"]["params_sha256"]
               for res in results for s in (2, 1)}
    check(len(digests) == 1, "the processes' parameters differ after the "
          "step, or ZeRO-1 from ZeRO-2")
    losses = {res[f"zero{s}"]["loss"] for res in results for s in (2, 1)}
    bitwise = {"loss": losses == {ref[2]["loss"]} == {ref[1]["loss"]},
               "grads": torch.equal(grads, ref_grads),
               "params": digests == {ref[2]["params_sha256"]}
               == {ref[1]["params_sha256"]}}
    errs = {"loss": max(abs(x - ref[2]["loss"]) for x in losses)
            / abs(ref[2]["loss"]),
            "grads": rel_err(grads, ref_grads),
            "params": rel_err(params, ref_params)}
    check(errs["loss"] <= LOSS_REL_TOL and errs["grads"] <= GRAD_REL_TOL
          and errs["params"] <= GRAD_REL_TOL,
          f"processes vs the single controller: {errs}")
    return None, {
        "world": world, "rows_a_process": DP_GRADS_MICRO,
        "loss": results[0]["zero2"]["loss"],
        "single_controller_loss": ref[2]["loss"],
        "bitwise_vs_single_controller": bitwise,
        "rel_err_vs_single_controller": errs,
        "held_at": "bitwise predicted; max|d| / max|ref| loss 2e-2, grads "
                   "and parameters 5e-2 otherwise",
        "zero1_zero2_bitwise": True, "launches_per_step_a_process": expected}


def mp_collectives_ms(engine):
    """One step's ZeRO-2 reduce-scatter of the grad buffer and all-gather
    of the parameter ranges over the process group, on the engine's own
    buffers, and NCCL's own `reduce_scatter_tensor` (ring order, not rank
    order: the library yardstick, not used by the engine) on the same
    buffer: device ms by CUDA events, the processes lined up by a barrier
    before each run."""
    mesh = engine.mesh
    lo, hi = engine._ranges[0]
    chunk = torch.empty_like(engine._flat_grad[lo:hi])

    def reduce_scatter():
        with mesh.forked():
            mesh.reduce_scatter_flat(engine._flat_grads)

    def all_gather():
        with mesh.forked():
            mesh.all_gather_flat([f[lo:hi] for f, (lo, hi) in
                                  zip(engine._flats, engine._ranges)],
                                 out=engine._flats)

    def nccl_reduce_scatter():
        dist.reduce_scatter_tensor(chunk, engine._flat_grad)

    def lined_up():
        dist.barrier()
        torch.cuda.synchronize()

    nbytes = engine._flat_grad.numel() * 4
    out = {"buffer_bytes": nbytes,
           "bytes_sent_a_rank": nbytes * (engine.world_size - 1)
           // engine.world_size}
    for name, fn in (("reduce_scatter", reduce_scatter),
                     ("all_gather", all_gather),
                     ("nccl_reduce_scatter_tensor", nccl_reduce_scatter)):
        out[f"{name}_device_ms"] = time_ms(fn, before=lined_up)
    return out


def mp_train_worker(out_dir):
    """train_mp in one process: bench_gpt2's step on its rows, timed as
    train, then the collectives."""
    state = init_state(gpt2_124m_train())
    world = dist.get_world_size()
    counts, summary, engine = timed_training(
        gpt2_124m_train(), state, dp_config(TRAIN_BATCH, 2, world),
        TRAIN_WARMUP, TRAIN_ITERS)
    summary.update(rank=dist.get_rank(), launches=counts,
                   collectives=mp_collectives_ms(engine))
    return summary


MP_WORKERS = {"train_mp_grads": mp_grads_worker, "train_mp": mp_train_worker,
              "train_fused_mp": lambda out_dir: mp_fused_worker(out_dir),
              "monitor_mp": lambda out_dir: mp_monitor_worker(out_dir),
              "offload_mp": lambda out_dir: mp_offload_worker(out_dir),
              "infinity_mp": lambda out_dir: mp_infinity_worker(out_dir)}


def phase_train_mp(state):
    """bench_gpt2's step (ZeRO-2, micro-batch 8 a process, dropout 0.1 in
    kernel B) in W = every visible card processes, one rank each, on the
    global batch RandomState(0).randint(0, 50304, (8W, 1024)), timed as
    train in every process.  The row is rank 0's, with the slowest
    process's rate and every process's host issue beside it; the launch
    counts are every process's summed."""
    del state  # each worker makes the same weights from the seed
    torch.cuda.empty_cache()
    with mp_results("train_mp") as (_, results):
        pass
    row = {k: v for k, v in results[0].items() if k != "launches"}
    counts = {name: sum(res["launches"][name] for res in results)
              for name in results[0]["launches"]}
    row.update(
        processes=len(results),
        slowest_tokens_per_s=min(r["tokens_per_s"] for r in results),
        host_issue_ms_per_step_by_rank=[r["host_issue_ms_per_step"]
                                        for r in results],
        peak_memory_gib_by_rank=[r["peak_memory_gib"] for r in results],
        collectives_by_rank=[r["collectives"] for r in results],
        launches_all_processes=counts)
    return counts, row


def gpt2_124m_long(**overrides):
    """_run_longseq's model: GPT-2 124M at n_positions = S = 8192, bf16,
    dropout 0.1; `sparse_attention=bigbird()` is bench_sparse_longseq's."""
    return replace(gpt2_124m(), n_positions=LONG_SEQ, **overrides)


def bigbird():
    return BigBirdSparsityConfig(**BIGBIRD)


_STATES = {}  # init_state's weights made during the build (warm_host)


def init_state(cfg, seed=0):
    """fp32 weights of cfg's model from `seed`, on the CPU (the phases
    treat them as read-only, so those made during the build are shared)."""
    made = _STATES.get((repr(cfg), seed))
    if made is not None:
        return made
    model = GPT2Model(replace(cfg, bf16=False))
    model.init_params(torch.Generator().manual_seed(seed))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def phase_train_sparse_grads():
    """bench_sparse_longseq's attention at full width, SPARSE_GRADS_LAYERS
    deep, batch 1 x 8192, dropout
    off: the loss and every grad on the card in bf16 against the CPU in
    fp32."""
    cfg = gpt2_124m_long(num_layers=SPARSE_GRADS_LAYERS, embd_dropout=0.0,
                         attn_dropout=0.0, hidden_dropout=0.0,
                         sparse_attention=bigbird())
    ids = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (1, LONG_SEQ)))
    return grads_vs_cpu(cfg, init_state(cfg), ids, dict(
        BENCH_LONGSEQ_CONFIG, train_micro_batch_size_per_gpu=1))


def phase_train_sparse(state):
    """bench_sparse_longseq exactly, timed as _run_longseq."""
    cfg = gpt2_124m_long(sparse_attention=bigbird())
    counts, summary, _ = timed_training(cfg, state, BENCH_LONGSEQ_CONFIG,
                                        LONG_WARMUP, LONG_ITERS)
    summary["tflops_dense_equiv"] = summary.pop("tflops")
    summary["attn_density"] = SparseSelfAttention(bigbird()).density(LONG_SEQ)
    return counts, summary


def phase_train_longseq(state):
    """bench_longseq: the same model, batch and timing with dense causal
    flash attention (kernels B / E) at S = 8192, the comparison
    bench_sparse_longseq's row is defined against."""
    return timed_training(gpt2_124m_long(), state, BENCH_LONGSEQ_CONFIG,
                          LONG_WARMUP, LONG_ITERS)[:2]


# --------------------------------------------------------------------- #
# phases 20-23: activation checkpointing (GPT-2 medium and large) and fp16
# --------------------------------------------------------------------- #
def gpt2_bench(hidden, layers, heads, **overrides):
    """bench.py::bench_gpt2's model at another width and depth (GPT-2 medium
    and large, bench.py:1673-1699): S = 1024, bf16, dropout 0.1 with the
    attention dropout inside kernel B, every layer rematted."""
    return GPT2Config(vocab_size=50304, n_positions=TRAIN_SEQ,
                      hidden_size=hidden, num_layers=layers, num_heads=heads,
                      bf16=True, activation_checkpointing=True, **overrides)


def gpt2_medium():
    """bench_gpt2_medium's model: GPT-2 355M, 24 layers of 1024, 16 heads."""
    return gpt2_bench(1024, 24, 16)


def gpt2_large():
    """bench_gpt2_large's model: GPT-2 774M, 36 layers of 1280, 20 heads."""
    return gpt2_bench(1280, 36, 20)


# bench_gpt2_large's engine config: micro-batch 4 and bf16 grads
BENCH_LARGE_CONFIG = dict(BENCH_GPT2_CONFIG, train_micro_batch_size_per_gpu=4,
                          bf16={"enabled": True,
                                "grads_in_compute_dtype": True})
# bench_gpt2's engine config under fp16 in place of bf16 (the model keeps
# its default bf16 compute), the scaler at its defaults: 2^32, a window of
# 1000 clean steps, hysteresis 2
BENCH_FP16_CONFIG = dict({k: v for k, v in BENCH_GPT2_CONFIG.items()
                          if k != "bf16"}, fp16={"enabled": True})
# the rematted rows run as the long-context rows do, to stay in the limit
REMAT_WARMUP, REMAT_ITERS = LONG_WARMUP, LONG_ITERS
# train_fp16: steps until this many clean steps follow the skipped ones
FP16_CLEAN_STEPS, FP16_MAX_STEPS = 5, 48
# its second run: a window of 2 clean steps from a quarter of the settled
# scale, long enough to double twice
FP16_WINDOW, FP16_WINDOW_STEPS = 2, 6


def bench_ids(cfg, micro, seed=0):
    """bench_gpt2's fixed batch: RandomState(seed).randint(0, vocab,
    (micro, n_positions))."""
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, size=(micro, cfg.n_positions)).astype(np.int32)


def recompute_ratio(cfg):
    """The operations a rematted step executes over the model's own
    (flops_per_token, which MFU counts): the recompute adds each layer's
    forward, 2N + 4 L H S a token of the 6N + 12 L H S + 6 H V."""
    n = cfg.num_params(include_embeddings=False)
    forward = 2 * n + 4 * cfg.num_layers * cfg.hidden_size * cfg.n_positions
    return (cfg.flops_per_token() + forward) / cfg.flops_per_token()


def one_step_peak(cfg, state, ds_config):
    """Peak GiB above the start of one forward / backward / step of a new
    engine (None when the card runs out of memory, reported as such)."""
    gc_cuda()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    engine = None
    try:
        engine = train_engine(cfg, state, ds_config)
        ids = bench_ids(cfg, ds_config["train_micro_batch_size_per_gpu"])
        loss = engine.forward(ids)
        engine.backward(loss)
        engine.step()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    except torch.cuda.OutOfMemoryError:
        return None
    finally:
        del engine
        gc_cuda()


def gc_cuda():
    """Free what the last engine held, for the next phase's peak."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_train_remat_grads(state):
    """One step of bench_gpt2_medium's config with every dropout on, with
    and without activation checkpointing, from the same weights and the
    engine's same generator seed: the loss, the grads after the backward
    and the parameters after the step must be bitwise equal (predicted:
    the kernels use no atomics and the recompute draws every mask again
    from the saved generator state).  Where they are not, the parameters
    whose grads differ are named and the pair is held at 2e-2 (loss) and
    5e-2 (each grad, max|d|/max|ref|).  Launch counters exact for both."""
    cfg_remat = gpt2_medium()
    runs = {}
    for remat in (True, False):
        cfg = replace(cfg_remat, activation_checkpointing=remat)
        gc_cuda()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        engine = train_engine(cfg, state, BENCH_GPT2_CONFIG)
        ids = bench_ids(cfg, TRAIN_BATCH)
        reset_launch_counts()
        loss = engine.forward(ids)
        engine.backward(loss)
        torch.cuda.synchronize()
        counts = launch_counts()
        check(counts == step_counts(cfg),
              f"remat={remat}: launch counts {counts}, expected "
              f"{step_counts(cfg)}")
        grads = engine._flat_grads[0][:engine.num_params].cpu()
        engine.step()
        params = engine._flats[0][:engine.num_params].cpu()
        torch.cuda.synchronize()
        names = [(name, o, n) for (name, _), (o, n)
                 in zip(engine._named_params, engine._segments)]
        runs[remat] = {"loss": loss.item(), "grads": grads, "params": params,
                       "counts": counts,
                       "peak_gib": (torch.cuda.max_memory_allocated() - base)
                       / 2 ** 30}
        del engine, loss
    on, off = runs[True], runs[False]
    bitwise = {"loss": on["loss"] == off["loss"],
               "grads": torch.equal(on["grads"], off["grads"]),
               "params_after_step": torch.equal(on["params"], off["params"])}
    differing, worst = [], 0.0
    if not all(bitwise.values()):
        for name, o, n in names:
            a, b = on["grads"][o:o + n], off["grads"][o:o + n]
            if not torch.equal(a, b):
                differing.append(name)
                worst = max(worst, rel_err(a, b))
        loss_err = abs(on["loss"] - off["loss"]) / abs(off["loss"])
        check(loss_err <= LOSS_REL_TOL and worst <= GRAD_REL_TOL,
              f"remat vs not: loss {loss_err}, worst grad {worst} "
              f"({differing[:5]})")
    return None, {
        "batch": [TRAIN_BATCH, TRAIN_SEQ], "dropout": DROPOUT,
        "bitwise": bitwise, "grads_differ_in": differing[:10],
        "worst_grad_rel_err": worst, "loss": on["loss"],
        "launches_per_step_remat": on["counts"],
        "launches_per_step_no_remat": off["counts"],
        "peak_memory_gib_step_remat": on["peak_gib"],
        "peak_memory_gib_step_no_remat": off["peak_gib"]}


def phase_train_rematted(cfg, state, ds_config):
    """A rematted bench row (bench_gpt2_medium or bench_gpt2_large), timed
    as the long-context rows (2 + 10 steps): what train reports, with the
    launch counters' recompute (A 4L + 1, B 2L a step), MFU over the
    model's flops_per_token as bench.py counts it and, beside it, over
    the operations the recompute adds; one more step's memory split
    (step_memory); then the peak GiB of one step of a new engine without
    activation checkpointing."""
    counts, summary, engine = timed_training(cfg, state, ds_config,
                                             REMAT_WARMUP, REMAT_ITERS)
    summary["step_memory"] = step_memory(
        engine, bench_ids(cfg, ds_config["train_micro_batch_size_per_gpu"]))
    del engine
    ratio = recompute_ratio(cfg)
    no_remat = one_step_peak(replace(cfg, activation_checkpointing=False),
                             state, ds_config)
    summary.update(
        model={"hidden": cfg.hidden_size, "layers": cfg.num_layers,
               "heads": cfg.num_heads, "params": cfg.num_params()},
        recompute_ratio=ratio, mfu_executed=summary["mfu"] * ratio,
        peak_memory_gib_no_remat_step=no_remat,
        no_remat_out_of_memory=no_remat is None)
    return counts, summary


def phase_train_medium(state):
    return phase_train_rematted(gpt2_medium(), state, BENCH_GPT2_CONFIG)


def phase_train_large(state):
    """train_large; returns the launch counts and the summary
    (train_fused_large reads it)."""
    counts, summary = phase_train_rematted(gpt2_large(), state,
                                           BENCH_LARGE_CONFIG)
    return (counts, summary), summary


def fp16_steps(engine, ids, max_steps, clean_needed=None):
    """Steps of an fp16 engine, one at a time: each step's loss, scale after
    it and overflow; on every skipped step the master buffer and the
    optimizer state must be bitwise unchanged.  Stops after max_steps, or
    once `clean_needed` clean steps have followed the last skipped one."""
    trajectory, clean = [], 0
    for i in range(max_steps):
        before = (engine._flats[0].clone(),
                  {k: v.clone() for k, v in engine.opt_states[0].items()})
        loss = engine.forward(ids)
        engine.backward(loss)
        engine.step()
        overflow = engine.overflow
        trajectory.append({"step": i + 1, "loss": loss.item(),
                           "scale": engine.loss_scale, "skipped": overflow})
        if overflow:
            check(torch.equal(engine._flats[0], before[0]) and all(
                torch.equal(v, before[1][k])
                for k, v in engine.opt_states[0].items()),
                f"skipped step {i + 1} changed the parameters or the "
                "optimizer state")
            clean = 0
        else:
            clean += 1
        del before
        if clean_needed is not None and clean >= clean_needed:
            break
    return trajectory


def phase_train_fp16(state, train_summary):
    """bench_gpt2's row under `"fp16": {"enabled": true}` (the model's bf16
    compute, every parameter rounded through fp16: A and D take fp16 gamma
    and beta), the scaler at its defaults.  (1) From 2^32, steps until
    FP16_CLEAN_STEPS clean steps follow the skipped ones: the skipped
    steps, the scale trajectory, each skipped step bitwise without effect
    on the parameters and Adam's state, skipped_steps equal to them, the
    launch counters exact.  (2) A new engine with a window of 2 clean steps
    from a quarter of the settled scale: the scale doubles.  (3) Timed as
    train (3 + 30 steps, a fresh engine from 2^32): tokens/s beside
    train's of this run."""
    cfg = gpt2_124m_train()
    ids = bench_ids(cfg, TRAIN_BATCH)
    engine = train_engine(cfg, state, BENCH_FP16_CONFIG)
    check(engine.compute_dtype == torch.float16 and engine.dynamic_loss_scale(),
          "the fp16 engine does not compute in fp16 with a dynamic scaler")
    reset_launch_counts()
    trajectory = fp16_steps(engine, ids, FP16_MAX_STEPS, FP16_CLEAN_STEPS)
    counts = launch_counts()
    steps = len(trajectory)
    expected = {k: steps * v for k, v in step_counts(cfg).items()}
    check(counts == expected, f"launch counts {counts} over {steps} steps, "
          f"expected {expected}")
    skipped = sum(t["skipped"] for t in trajectory)
    clean_losses = [t["loss"] for t in trajectory if not t["skipped"]]
    check(0 < skipped == engine.skipped_steps,
          f"skipped {skipped}, engine.skipped_steps {engine.skipped_steps}")
    check(len(clean_losses) >= FP16_CLEAN_STEPS
          and all(np.isfinite(clean_losses))
          and clean_losses[-1] < clean_losses[0],
          f"fp16 run did not settle and learn: {trajectory}")
    settled = engine.loss_scale
    del engine
    gc_cuda()
    power = int(np.log2(settled)) - 2
    window = train_engine(cfg, state, dict(BENCH_FP16_CONFIG, fp16={
        "enabled": True, "initial_scale_power": power,
        "loss_scale_window": FP16_WINDOW}))
    doubling = fp16_steps(window, ids, FP16_WINDOW_STEPS)
    check(max(t["scale"] for t in doubling) >= 4 * 2.0 ** power,
          f"the scale did not double twice: {doubling}")
    del window
    gc_cuda()
    timed_counts, timed, engine = timed_training(
        cfg, state, BENCH_FP16_CONFIG, TRAIN_WARMUP, TRAIN_ITERS)
    timed_skipped = engine.skipped_steps
    del engine
    bf16_rate = train_summary["tokens_per_s"]
    return timed_counts, {
        "skipped_steps": skipped, "steps_to_settle": steps,
        "settled_scale": settled,
        "scale_trajectory": [t["scale"] for t in trajectory],
        "losses": [t["loss"] for t in trajectory],
        "launches_per_step": step_counts(cfg),
        "window_run": {"initial_scale_power": power,
                       "loss_scale_window": FP16_WINDOW,
                       "scales": [t["scale"] for t in doubling],
                       "skipped": [t["skipped"] for t in doubling]},
        "timed": {k: timed[k] for k in (
            "tokens_per_s", "ms_per_step", "mfu", "host_issue_ms_per_step",
            "profiled_step_device_ms", "device_busy_share",
            "peak_memory_gib", "first_loss", "final_loss")},
        "timed_skipped_steps": timed_skipped,
        "train_bf16_tokens_per_s": bf16_rate,
        "fp16_over_bf16": timed["tokens_per_s"] / bf16_rate}


# --------------------------------------------------------------------- #
# phases 24-28: the fused whole step (one CUDA graph a window) and the
# resilience block
# --------------------------------------------------------------------- #
# bench.py::bench_gpt2_gas4 / _fused: bench_gpt2's model and config at
# gas 4, timed as _bench_gpt2_gas (2 warm-up steps, 8 timed)
BENCH_GAS4_CONFIG = dict(BENCH_GPT2_CONFIG, gradient_accumulation_steps=4)
GAS4_WARMUP, GAS4_ITERS = 2, 8
FUSED_ROUNDS = 2  # timed turns of each path: modular, fused, fused, modular
# train_fused_grads: gas 2, three windows a run (the eager first, the
# capture and two replays)
FUSED_GRADS_GAS, FUSED_GRADS_STEPS = 2, 3
# the eager run's own peak moves by up to ~0.7% between runs of the script
# (the caching allocator's state after earlier phases); the graphed peak
# is held within it, the static inputs and this share of it
FUSED_PEAK_SLACK = 0.01
# resilience: windows before the stop, and after the resume
RES_STEPS, RES_RESUMED = 3, 2
GEMM_KERNEL = re.compile(r"gemm|nvjet|cutlass|xmma|cublas", re.I)
# kernels A, B, D and E by their names in a torch.profiler trace: the one
# kernel a call of their wrapper launches on the training path (D's
# column-sum kernel is the same call's second launch, and is not counted)
TRACED_KERNELS = {
    "layer_norm_fwd": re.compile(r"\bln_fwd(?:_streamed)?_kernel\b"),
    "layer_norm_bwd": re.compile(r"\bln_bwd(?:_streamed)?_kernel\b"),
    "flash_attention_fwd": re.compile(r"\bflash_fwd(?:_mma)?_kernel\b"),
    "flash_attention_bwd_dkdv": re.compile(
        r"\bflash_bwd_dkdv(?:_mma)?_kernel\b"),
    "flash_attention_bwd_dq": re.compile(
        r"\bflash_bwd_dq(?:_mma)?_kernel\b"),
}


def traced_launches(kernels):
    """Kernels A, B, D and E's launches among a profiled run's device
    kernels ([(name, ms)] as _profile_once gives them), by wrapper name.
    A CUDA graph's replay launches its kernels without calling a wrapper,
    so no launch counter moves then: its trace is what counts them."""
    return {name: sum(1 for k, _ in kernels if pattern.search(k))
            for name, pattern in TRACED_KERNELS.items()}


def traced_part(counts):
    """The wrappers' counts of the kernels a trace counts."""
    return {name: counts[name] for name in TRACED_KERNELS}


def fused_config(ds_config, fused=True, **extra):
    return dict(ds_config, fused_step={"enabled": fused}, **extra)


def repeat_batch(ids):
    """An endless iterator of the one batch (bench.py's batch_iter)."""
    while True:
        yield (ids,)


def window_batches(cfg, micro, windows, gas, seed=10):
    """A different batch for every micro-step of `windows` windows."""
    return [(bench_ids(cfg, micro, seed=seed + k),)
            for k in range(windows * gas)]


def engine_state_bits(engine):
    """Host copies of the state a step moves: each rank's master buffer and
    optimizer state tensors, the scaler and each rank's generator."""
    n = engine.num_params
    out = {}
    for r, (flat, opt) in enumerate(zip(engine._flats, engine.opt_states)):
        out[f"params{r}"] = flat[:n].cpu()
        for key, value in opt.items():
            out[f"adam{r}.{key}"] = value.cpu()
    for field, value in zip(LossScaleState._fields, engine.scaler_state):
        out[f"scaler.{field}"] = value.cpu()
    for r, gen in enumerate(engine._rngs):
        out[f"generator{r}"] = gen.get_state()
    return out


def run_windows(engine, batches, windows):
    """`windows` train_batch calls over `batches`: each window's loss,
    the scale after it and skipped_steps, on the host; and kernels A, B,
    D and E's launches in the last window, read from its torch.profiler
    trace."""
    it = iter(batches)
    out = []

    def window():
        loss = engine.train_batch(it)
        out.append({"loss": float(loss), "scale": engine.loss_scale,
                    "skipped_steps": engine.skipped_steps})

    for _ in range(windows - 1):
        window()
    kernels = _profile_once(window)[3]
    return out, traced_launches(kernels)


def graphed_vs_eager(cfg, state, ds_config, windows, what,
                     rank_step=None):
    """The same windows from the same weights and generator seeds through
    the modular loop and through the fused step (the first window eager,
    then one capture and its replays): every window's loss, scale and
    skipped steps, and after the run every rank's master buffer and Adam
    state, the scaler and the generators, all bitwise; the fused engine
    captured one graph and replayed it every window after; the graphed
    peak within the eager run's plus the static inputs.  Launches: the
    eager run's counters count every window; the fused run's count the
    eager first window and the capture's launch calls, which the capture
    records into the graph; the last window's trace (a replay under the
    fused step) holds an eager window's launches of kernels A, B, D and
    E."""
    gas = ds_config["gradient_accumulation_steps"]
    world = ds_config.get("mesh", {}).get("data", 1)
    batches = window_batches(
        cfg, ds_config["train_micro_batch_size_per_gpu"] * world, windows,
        gas)
    runs = {}
    for fused in (False, True):
        gc_cuda()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        engine = train_engine(cfg, state, fused_config(ds_config, fused))
        check(fused == (engine._fused is not None),
              f"{what}: fused_step {engine.fused_step_reason}")
        window = {k: gas * len(engine.local_ranks) * v
                  for k, v in (rank_step or step_counts(cfg)).items()}
        reset_launch_counts()
        trajectory, traced = run_windows(engine, batches, windows)
        run = {"trajectory": trajectory, "counts": launch_counts(),
               "traced_last": traced,
               "bits": engine_state_bits(engine),
               "peak_gib": (torch.cuda.max_memory_allocated() - base)
               / 2 ** 30,
               "reserved_gib": torch.cuda.memory_reserved() / 2 ** 30}
        if fused:
            fs = engine._fused
            check(fs.graph is not None and fs.calls == windows
                  and fs.replays == windows - 1,
                  f"{what}: {fs.calls} calls, graph "
                  f"{fs.graph is not None}, {fs.replays} replays")
            run.update(captured=fs.launches_captured,
                       static_gib=fs.static_bytes() / 2 ** 30)
        runs[fused] = run
        del engine
    eager, graphed = runs[False], runs[True]
    check(eager["counts"] == {k: windows * v for k, v in window.items()},
          f"{what}: eager launch counts {eager['counts']} over {windows} "
          f"windows of {window}")
    check(graphed["captured"] == window
          and graphed["counts"] == {k: 2 * v for k, v in window.items()},
          f"{what}: the capture's launch calls {graphed['captured']}, the "
          f"fused run's counts {graphed['counts']}; a window's {window}")
    check(eager["traced_last"] == graphed["traced_last"]
          == traced_part(window),
          f"{what}: traced launches of the last window: eager "
          f"{eager['traced_last']}, a replay {graphed['traced_last']}, "
          f"counted a window {traced_part(window)}")
    same_traj = json.dumps(eager["trajectory"]) == json.dumps(
        graphed["trajectory"])
    differ = [k for k, v in eager["bits"].items()
              if not torch.equal(v, graphed["bits"][k])]
    check(same_traj and not differ,
          f"{what}: graphed vs eager differ in {differ}; trajectories "
          f"{eager['trajectory']} / {graphed['trajectory']}")
    check(graphed["peak_gib"] <= eager["peak_gib"] * (1 + FUSED_PEAK_SLACK)
          + graphed["static_gib"],
          f"{what}: graphed peak {graphed['peak_gib']} GiB over the eager "
          f"{eager['peak_gib']} + static {graphed['static_gib']}")
    return {
        "windows": windows, "gas": gas, "bitwise": True,
        "compared": sorted(eager["bits"]) + ["loss", "scale",
                                             "skipped_steps"],
        "trajectory": graphed["trajectory"], "graphs_captured": 1,
        "replays": windows - 1, "launches_per_window": window,
        "replay_launches_traced": graphed["traced_last"],
        "peak_gib_eager": eager["peak_gib"],
        "peak_gib_graphed": graphed["peak_gib"],
        "static_input_gib": graphed["static_gib"],
        "reserved_gib_eager": eager["reserved_gib"],
        "reserved_gib_graphed": graphed["reserved_gib"]}


def phase_train_fused_grads(state):
    """bench_gpt2_gas4's config at gas 2, dropout 0.1 (kernel B's in-kernel
    mask and the hidden masks), with and without activation_checkpointing,
    then fp16 from 2^32 (the first windows overflow): graphed_vs_eager
    on each."""
    base = dict(BENCH_GPT2_CONFIG, gradient_accumulation_steps=FUSED_GRADS_GAS)
    out = {}
    for what, cfg, ds_config in (
            ("bf16", gpt2_124m_train(), base),
            ("bf16_remat", gpt2_124m_train(activation_checkpointing=True),
             base),
            ("fp16", gpt2_124m_train(),
             dict(BENCH_FP16_CONFIG,
                  gradient_accumulation_steps=FUSED_GRADS_GAS))):
        out[what] = graphed_vs_eager(cfg, state, ds_config,
                                     FUSED_GRADS_STEPS, what)
    check(out["fp16"]["trajectory"][0]["skipped_steps"] >= 1,
          f"fp16 from 2^32 did not overflow: {out['fp16']['trajectory']}")
    return None, dict(out, dropout=DROPOUT)


def phase_train_fused_dp(state):
    """graphed_vs_eager at DP_WORLD data-parallel ranks of one process on
    one card (ZeRO-2, DP_GRADS_MICRO rows a rank, gas 2, dropout 0.1):
    every rank's streams fork from the capture stream and join it again,
    and its reduce-scatter and all-gather are captured with its
    kernels."""
    check(torch.cuda.device_count() == 1,
          "train_fused_dp puts every rank on one card")
    summary = graphed_vs_eager(
        gpt2_124m_train(), state,
        dict(dp_config(DP_GRADS_MICRO, 2),
             gradient_accumulation_steps=FUSED_GRADS_GAS),
        FUSED_GRADS_STEPS, f"ZeRO-2 at {DP_WORLD} ranks")
    return None, dict(summary, world=DP_WORLD, rows_a_rank=DP_GRADS_MICRO,
                      dropout=DROPOUT)


def device_split(kernels):
    """One window's device ms by kernel name: kernels A, B, D and E, the
    GEMMs, the step (every kernel after the window's last D: the
    embeddings' grads, the unscale, the finite flag, the optimizer, the
    scaler) and the rest (glue and casts: elementwise, copies, the loss)."""
    last_d = max((i for i, (name, _) in enumerate(kernels)
                  if "ln_bwd" in name), default=len(kernels))
    split = {}
    for i, (name, ms) in enumerate(kernels):
        if "ln_fwd" in name:
            key = "A_layer_norm_fwd"
        elif "ln_bwd" in name:
            key = "D_layer_norm_bwd"
        elif "flash_fwd" in name:
            key = "B_flash_fwd"
        elif "flash_bwd" in name:
            key = "E_flash_bwd"
        elif GEMM_KERNEL.search(name):
            key = "gemm"
        elif i > last_d:
            key = "step_after_last_D"
        else:
            key = "glue_and_casts"
        split[key] = split.get(key, 0.0) + ms
    return split


def host_issue_ms(step):
    """The host's ms to issue one step after a synchronisation, for
    HOST_ISSUE_STEPS steps."""
    out = []
    for _ in range(HOST_ISSUE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        out.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return out


def counts_added(fn):
    """fn()'s result and the launch counts it added."""
    before = launch_counts()
    out = fn()
    after = launch_counts()
    return out, {k: after[k] - before[k] for k in after}


def phase_train_fused(state):
    """bench.py::bench_gpt2_gas4 and bench_gpt2_gas4_fused exactly (gas 4,
    batch 8 x 1024, bf16, AdamW, ZeRO-2, dropout 0.1), two engines from
    the same weights, timed as _bench_gpt2_gas (2 warm-up steps, then 8
    train_batch calls on the host clock, closed by the last loss and a
    parameter read) in turns, FUSED_ROUNDS each: tokens/s, MFU, host issue
    ms a step, device ms and busy share of one profiled step, peak GiB
    (each engine's warm-up from its own start), and one replay's device
    time split by kernel name.  The fused engine's launch counters count
    its eager first window and its capture's launch calls, and move at no
    replay; the profiled replay's trace holds an eager window's launches
    of kernels A, B, D and E, as the profiled modular window's trace holds
    what its counters counted."""
    cfg = gpt2_124m_train()
    ids = bench_ids(cfg, TRAIN_BATCH)
    tokens = GAS4_ITERS * 4 * TRAIN_BATCH * TRAIN_SEQ
    engines, its, rows, counts, traced = {}, {}, {}, None, {}
    for kind in ("modular", "fused"):
        gc_cuda()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        engines[kind] = eng = train_engine(
            cfg, state, fused_config(BENCH_GAS4_CONFIG, kind == "fused"))
        its[kind] = repeat_batch(ids)
        reset_launch_counts()
        losses = [float(eng.train_batch(its[kind]))
                  for _ in range(GAS4_WARMUP)]
        torch.cuda.synchronize()
        if kind == "fused":
            counts = launch_counts()
        rows[kind] = {"warmup_losses": losses,
                      "peak_memory_gib": (torch.cuda.max_memory_allocated()
                                          - base) / 2 ** 30,
                      "tokens_per_s_rounds": []}
    check(engines["fused"]._fused.graph is not None, "no graph captured")
    rows["fused"]["static_input_gib"] = \
        engines["fused"]._fused.static_bytes() / 2 ** 30

    def step(kind):
        return engines[kind].train_batch(its[kind])

    for kind in ("modular", "fused", "fused", "modular") * (FUSED_ROUNDS // 2):
        eng = engines[kind]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GAS4_ITERS):
            loss, added = counts_added(lambda: step(kind))
            if kind == "fused":
                counts = add_counts(counts, added)
        final = float(loss)
        eng._flats[0][0].item()  # the last update, as bench.py's param_sync
        seconds = time.perf_counter() - t0
        rows[kind]["tokens_per_s_rounds"].append(tokens / seconds)
        rows[kind]["final_loss"] = final
    for kind, eng in engines.items():
        row = rows[kind]
        rate = float(np.median(row["tokens_per_s_rounds"]))
        issue, added = counts_added(lambda: host_issue_ms(lambda: step(kind)))
        (wall_ms, busy_ms, ops, kernels), added2 = counts_added(
            lambda: _profile_once(lambda: step(kind)))
        traced[kind] = traced_launches(kernels)
        if kind == "fused":
            counts = add_counts(counts, added, added2)
            check(not any(added2.values()),
                  f"a replay moved the launch counters: {added2}")
        else:
            check(traced[kind] == traced_part(added2),
                  f"modular window: traced launches {traced[kind]}, "
                  f"counted {traced_part(added2)}")
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:6]
        row.update(
            tokens_per_s=rate, mfu=rate * cfg.flops_per_token()
            / PEAK_OPS_PER_S[torch.bfloat16],
            ms_per_step=4 * TRAIN_BATCH * TRAIN_SEQ / rate * 1e3,
            host_issue_ms_per_step=float(np.median(issue)),
            host_issue_ms_each=issue,
            profiled_step_wall_ms=wall_ms, profiled_step_device_ms=busy_ms,
            device_busy_share=busy_ms / wall_ms,
            device_kernels_one_step=len(kernels),
            launches_traced_one_step=traced[kind],
            device_ms_split=device_split(kernels),
            top_device_ms_one_step={n[:80]: ms for n, ms in top},
            dispatches_per_step=eng._dispatches_per_step)
        check(np.isfinite(row["final_loss"])
              and row["final_loss"] < row["warmup_losses"][0],
              f"{kind}: loss did not fall: {row}")
    fs = engines["fused"]._fused
    window = {k: 4 * v for k, v in step_counts(cfg).items()}
    check(fs.launches_captured == window
          and counts == {k: 2 * v for k, v in window.items()},
          f"the capture's launch calls {fs.launches_captured} and the fused "
          f"counts {counts} (the eager window and the capture), a window "
          f"{window}")
    check(traced["fused"] == traced_part(window),
          f"a replay's traced launches {traced['fused']}, a window's "
          f"{traced_part(window)}")
    steps = fs.calls
    check(fs.replays == steps - 1, f"{fs.replays} replays of {steps} calls")
    del engines, eng
    gc_cuda()
    rows["fused_over_modular"] = (rows["fused"]["tokens_per_s"]
                                  / rows["modular"]["tokens_per_s"])
    rows.update(batch=[TRAIN_BATCH, TRAIN_SEQ], gas=4, windows_fused=steps,
                launches_per_window=window, realigned=check_aligned(
                    "fused windows"))
    return (counts, traced["fused"]), rows


def step_memory(engine, ids):
    """One more forward / backward / step of a modular engine, split:
    (GiB held before it, the forward and backward's peak above that (the
    activations and the grads' temporaries), the step's peak above what
    the backward left (the unscale's and the optimizer's temporaries))."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss = engine.forward(ids)
    engine.backward(loss)
    torch.cuda.synchronize()
    fwd_bwd = torch.cuda.max_memory_allocated() - held
    after = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    engine.step()
    torch.cuda.synchronize()
    step = torch.cuda.max_memory_allocated() - after
    del loss
    return {"held_gib": held / 2 ** 30,
            "forward_backward_peak_gib": fwd_bwd / 2 ** 30,
            "step_peak_gib": step / 2 ** 30}


def phase_train_fused_large(state, large_summary):
    """bench_gpt2_large (rematted, bf16 grads) under fused_step, timed as
    train_large (2 + 10 steps), beside train_large's numbers of this run."""
    counts, summary, engine = timed_training(
        gpt2_large(), state, fused_config(BENCH_LARGE_CONFIG),
        REMAT_WARMUP, REMAT_ITERS)
    fs = engine._fused
    check(fs.graph is not None and fs.replays == fs.calls - 1,
          f"{fs.calls} calls, {fs.replays} replays")
    summary["static_input_gib"] = fs.static_bytes() / 2 ** 30
    traced = summary["replay_launches_traced"]
    del engine, fs
    gc_cuda()
    if large_summary is not None:
        summary["modular"] = {k: large_summary.get(k) for k in (
            "tokens_per_s", "ms_per_step", "mfu", "host_issue_ms_per_step",
            "profiled_step_device_ms", "device_busy_share",
            "peak_memory_gib", "step_memory")}
        summary["fused_over_modular"] = (summary["tokens_per_s"]
                                         / large_summary["tokens_per_s"])
    return (counts, traced), summary


def mp_fused_worker(out_dir):
    """train_fused_mp in one process: bench_gpt2's config at gas 2 and
    dropout 0.1 over the process group, FUSED_GRADS_STEPS windows through
    the modular loop and through the fused step (one NCCL-capturing
    graph): the trajectories and the state's digests."""
    cfg = gpt2_124m_train()
    state = init_state(cfg)
    world, rank = dist.get_world_size(), dist.get_rank()
    ds_config = dict(dp_config(TRAIN_BATCH, 2, world),
                     gradient_accumulation_steps=FUSED_GRADS_GAS)
    batches = window_batches(cfg, TRAIN_BATCH * world, FUSED_GRADS_STEPS,
                             FUSED_GRADS_GAS)
    rows = [(ids[rank * TRAIN_BATCH:(rank + 1) * TRAIN_BATCH],)
            for (ids,) in batches]
    out = {"rank": rank, "world": world,
           "device": torch.cuda.current_device()}
    for fused in (False, True):
        engine = train_engine(cfg, state, fused_config(ds_config, fused))
        check(fused == (engine._fused is not None),
              f"fused_step: {engine.fused_step_reason}")
        reset_launch_counts()
        traj, traced = run_windows(engine, rows, FUSED_GRADS_STEPS)
        bits = engine_state_bits(engine)
        out["fused" if fused else "eager"] = {
            "trajectory": traj, "launches": launch_counts(),
            "traced_last": traced,
            "digests": {k: sha256(v) for k, v in bits.items()}}
        if fused:
            fs = engine._fused
            out["fused"].update(graph=fs.graph is not None,
                                replays=fs.replays,
                                captured=fs.launches_captured)
        del engine
        torch.cuda.empty_cache()
    return out


def phase_train_fused_mp(state):
    """The fused step in one process over NCCL (the engine graphs no
    window across cards: ROADMAP A.6c): its graphed windows bitwise
    against its eager process-group windows (trajectory, parameters,
    Adam, scaler, generators), one graph; the counters count every eager
    window, or the fused step's eager first window and its capture's
    launch calls, and the last window's trace (a replay under the fused
    step) holds a window's launches of kernels A, B, D and E."""
    del state  # each worker makes the same weights from the seed
    torch.cuda.empty_cache()
    with mp_results("train_fused_mp") as (_, results):
        pass
    cfg = gpt2_124m_train()
    window = {k: FUSED_GRADS_GAS * v for k, v in step_counts(cfg).items()}
    for res in results:
        eager, fused = res["eager"], res["fused"]
        check(fused["graph"] and fused["replays"] == FUSED_GRADS_STEPS - 1
              and fused["captured"] == window
              and fused["launches"] == {k: 2 * v for k, v in window.items()}
              and eager["launches"] == {k: FUSED_GRADS_STEPS * v
                                        for k, v in window.items()},
              f"rank {res['rank']}: graph {fused['graph']}, replays "
              f"{fused['replays']}, captured {fused['captured']}, counts "
              f"fused {fused['launches']} eager {eager['launches']}")
        check(eager["traced_last"] == fused["traced_last"]
              == traced_part(window),
              f"rank {res['rank']}: traced launches of the last window: "
              f"eager {eager['traced_last']}, a replay "
              f"{fused['traced_last']}, a window {traced_part(window)}")
        check(eager["trajectory"] == fused["trajectory"]
              and eager["digests"] == fused["digests"],
              f"rank {res['rank']}: graphed vs eager over NCCL differ: "
              f"{eager['trajectory']} / {fused['trajectory']}, digests "
              f"{[k for k in eager['digests'] if eager['digests'][k] != fused['digests'][k]]}")
    counts = {name: sum(res["fused"]["launches"][name] for res in results)
              for name in results[0]["fused"]["launches"]}
    traced = {name: sum(res["fused"]["traced_last"][name]
                        for res in results) for name in TRACED_KERNELS}
    return (counts, traced), {
        "processes": len(results), "gas": FUSED_GRADS_GAS,
        "windows": FUSED_GRADS_STEPS, "bitwise": True,
        "trajectory_rank0": results[0]["fused"]["trajectory"],
        "launches_per_window": window,
        "replay_launches_traced_all_processes": traced}


def phase_resilience(state):
    """The resilience block on bench_gpt2's 1.494 GB under fused_step:
    one engine's save with atomic_checkpoints off, then on (a staged
    directory, a size and CRC32 manifest, a rename), and a verified load
    (the manifest's CRCs read, then the load), in seconds, and the CRC pass
    alone; then RES_STEPS fused windows, request_stop(): the next window
    saves emergency_step<N> at its boundary and raises
    TrainingInterrupted; a new engine from other weights resumes from the
    directory's latest tag and its next RES_RESUMED windows equal an
    uninterrupted run's bitwise, as do the parameters and Adam's state.
    Each of the three engines captures once: the counters count its eager
    first window and its capture's launch calls, and the uninterrupted
    run's last window (a replay) is traced."""
    from deepspeed_tpu_torch.runtime.resilience import (TrainingInterrupted,
                                                         verify_manifest)
    cfg = gpt2_124m_train()
    batches = window_batches(cfg, TRAIN_BATCH, RES_STEPS + 1 + RES_RESUMED, 1)
    other = init_state(cfg, seed=1)
    reset_launch_counts()
    with checkpoint_dir() as path:
        res_block = {"enabled": True, "verify_lockstep_on_resume": False,
                     "preemption": {"enabled": True, "reraise": False,
                                    "save_dir": path}}
        ds_config = fused_config(BENCH_GPT2_CONFIG, resilience=res_block)
        gc_cuda()
        engine = train_engine(cfg, state, ds_config)
        it = iter(batches)
        ref = [float(engine.train_batch(it)) for _ in range(RES_STEPS)]
        atomic_cfg = engine.resilience
        engine.resilience = replace(atomic_cfg, atomic_checkpoints=False)
        plain_s, nbytes, _ = timed_save(engine, path, "plain")
        engine.resilience = atomic_cfg
        atomic_s, _, _ = timed_save(engine, path, "atomic")
        check(not os.path.exists(os.path.join(path, "plain",
                                              "manifest.json"))
              and not verify_manifest(os.path.join(path, "atomic")),
              "the atomic save's manifest does not verify")
        t0 = time.perf_counter()
        problems = verify_manifest(os.path.join(path, "atomic"))
        crc_s = time.perf_counter() - t0
        verified_s, _ = timed_load(engine, path)
        shutil.rmtree(os.path.join(path, "plain"))
        # the stop: one more window, then the boundary's emergency save
        engine._preemption.request_stop()
        try:
            engine.train_batch(it)
            check(False, "request_stop() did not stop the fused loop")
        except TrainingInterrupted as stop:
            tag = stop.emergency_tag
        expected_tag = f"emergency_step{RES_STEPS + 1}"
        check(tag == expected_tag and ckpt_mod.read_latest_tag(path) == tag
              and not verify_manifest(os.path.join(path, tag)),
              f"emergency tag {tag!r}, latest "
              f"{ckpt_mod.read_latest_tag(path)!r}, expected {expected_tag}")
        del engine
        gc_cuda()
        resumed = train_engine(cfg, other, ds_config)
        resumed.load_checkpoint(path)
        check(resumed.global_steps == RES_STEPS + 1,
              f"resumed at step {resumed.global_steps}")
        it_b = iter(batches[RES_STEPS + 1:])
        run_b = [float(resumed.train_batch(it_b)) for _ in range(RES_RESUMED)]
        bits_b = engine_state_bits(resumed)
        resumed._preemption.uninstall()
        del resumed
        gc_cuda()
        whole = train_engine(cfg, state, ds_config)
        it_a = iter(batches)
        run_a = [float(whole.train_batch(it_a))
                 for _ in range(RES_STEPS + RES_RESUMED)]
        kernels = _profile_once(
            lambda: run_a.append(float(whole.train_batch(it_a))))[3]
        bits_a = engine_state_bits(whole)
        whole._preemption.uninstall()
        del whole
        gc_cuda()
    counts = launch_counts()
    window = step_counts(cfg)
    traced = traced_launches(kernels)
    check(counts == {k: 3 * 2 * v for k, v in window.items()}
          and traced == traced_part(window),
          f"launch counts {counts} (expected three engines' eager window "
          f"and capture of {window}), a replay's traced {traced}")
    differ = [k for k in bits_a if not torch.equal(bits_a[k], bits_b[k])]
    check(run_a[:RES_STEPS] == ref and run_a[RES_STEPS + 1:] == run_b
          and not differ,
          f"resume vs uninterrupted: {run_b} / {run_a}, state differs in "
          f"{differ}")
    return (counts, traced), {
        "bytes": nbytes, "plain_save_seconds": plain_s,
        "atomic_save_seconds": atomic_s,
        "atomic_over_plain": atomic_s / plain_s,
        "manifest_crc_seconds": crc_s, "manifest_problems": problems,
        "verified_load_seconds": verified_s,
        "emergency_tag": tag, "resume_bitwise": True,
        "losses_resumed": run_b, "losses_uninterrupted": run_a,
        "windows": RES_STEPS + 1 + RES_RESUMED,
        "replay_launches_traced": traced}


# --------------------------------------------------------------------- #
# phases 29 and 30: the runtime monitor on bench_gpt2's modular and fused
# steps, and its fleet layer at one process a card
# --------------------------------------------------------------------- #
MONITOR_WINDOW = 10  # the monitor's write_interval (a flush a window)
MONITOR_TRACE_STEPS = 128  # every step of a phase's monitored run
MONITOR_CAPTURE_STEPS = 2  # K, the steps a capture traces
MONITOR_RATE_TOL = 0.05  # records' tokens/s against the phase's clock
MONITOR_MP_STEPS = 20  # monitor_mp: two windows
MONITOR_CALLS = ("mark_step_start", "add_phase", "end_step")


def monitor_config(ds_config, out_dir, **extra):
    """ds_config with the monitor on (every writer, the trace, a flush
    every MONITOR_WINDOW steps, heartbeats, the capture armed on demand)
    and the tensorboard block that feeds the monitor's tensorboard
    writer."""
    block = dict({"enabled": True, "output_path": out_dir,
                  "writers": ["jsonl", "csv", "tensorboard"], "trace": True,
                  "trace_steps": MONITOR_TRACE_STEPS,
                  "write_interval": MONITOR_WINDOW, "heartbeat": True,
                  "capture": {"enabled": True,
                              "steps": MONITOR_CAPTURE_STEPS,
                              "max_captures": 1, "cooldown_steps": 0}},
                 **extra)
    return dict(ds_config, monitor=block, tensorboard={
        "enabled": True, "write_interval": MONITOR_WINDOW,
        "output_path": os.path.join(out_dir, "tensorboard")})


class MonitorProbe:
    """Wraps a monitor's per-step calls (mark_step_start, add_phase,
    end_step): each call that reads nothing by design (not a flush, no
    capture live) runs under torch.cuda.set_sync_debug_mode("error"), so
    that a synchronising call in it raises; every call's host time is
    kept, and the flushes' apart, with the batched loss read's share of
    them; and the writer thread's seconds inside each writer's write and
    flush."""

    def __init__(self, engine):
        from deepspeed_tpu_torch.monitor import monitor as monitor_mod
        self.mon = mon = engine.monitor
        self.step_us, self.flush_ms = [], []
        # a flush's parts: the boundary reads (the first device read, which
        # waits for the card to drain the queued steps), the batched loss
        # read, the hand-off (heartbeat, trace mark, writer thread)
        self.parts_ms = {"boundary_reads": [], "loss_fetch": [],
                         "hand_off": []}
        self.checked = 0
        self._call_us = 0.0
        stream = mon.stream
        originals = (monitor_mod._batched_loss_fetch, stream._boundary_fn,
                     stream._sink)

        def timed(part, fn):
            def run(*args):
                t0 = time.perf_counter()
                try:
                    return fn(*args)
                finally:
                    self.parts_ms[part].append(
                        (time.perf_counter() - t0) * 1e3)
            return run

        monitor_mod._batched_loss_fetch = timed("loss_fetch", originals[0])
        stream._boundary_fn = timed("boundary_reads", originals[1])
        stream._sink = timed("hand_off", originals[2])

        def restore():
            monitor_mod._batched_loss_fetch = originals[0]
            stream._boundary_fn, stream._sink = originals[1:]

        self._restore = restore
        for name in MONITOR_CALLS:
            setattr(mon, name, self._wrap(name, getattr(mon, name)))
        self.writer_s = {}
        for writer in mon._thread.writers:
            self._time_writer(writer)

    def _time_writer(self, writer):
        name = type(writer).__name__
        self.writer_s[name] = 0.0
        for method in ("write", "flush"):
            fn = getattr(writer, method)

            def timed(*args, _fn=fn):
                t0 = time.perf_counter()
                try:
                    return _fn(*args)
                finally:
                    self.writer_s[name] += time.perf_counter() - t0

            setattr(writer, method, timed)

    def _wrap(self, name, call):
        mon = self.mon

        def probed(*args, **kwargs):
            flush = (name == "end_step"
                     and len(mon.stream._pending) + 1 >= mon.stream.window)
            quiet = not flush and not (mon.capture and mon.capture.armed)
            if quiet:
                torch.cuda.set_sync_debug_mode("error")
            t0 = time.perf_counter()
            try:
                out = call(*args, **kwargs)
            finally:
                us = (time.perf_counter() - t0) * 1e6
                if quiet:
                    torch.cuda.set_sync_debug_mode("default")
            if quiet:
                self.checked += 1
                self._call_us += us
            if flush:
                self.flush_ms.append(us / 1e3)
            if name == "end_step":
                if quiet:
                    self.step_us.append(self._call_us)
                self._call_us = 0.0
            return out
        return probed

    def close(self):
        self._restore()
        for name in MONITOR_CALLS:
            vars(self.mon).pop(name, None)


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def trace_kernel_launches(path):
    """Kernels A, B, D and E's launches in a Chrome trace that
    torch.profiler exported (its device kernels, by name)."""
    with open(path) as f:
        payload = json.load(f)
    return traced_launches([(ev["name"], 0.0)
                            for ev in payload["traceEvents"]
                            if ev.get("cat") == "kernel"])


def check_monitor_files(engine, what, fused, returned, host_times,
                        boundary_peaks):
    """The monitored run's files after close(): a step record a step,
    1..steps, each loss the engine's returned loss for that step after
    the monitor's 6-place rounding, dispatches_per_step 1 (fused) or 2
    (modular, gas 1), the card's allocator as the memory source with the
    peak read at each flush boundary, tokens/s within MONITOR_RATE_TOL of
    the host clock over the same steps; the CSV's columns and a row a
    step record; the trace valid, with its phases a step; a measured-only
    reconcile record a window; the three writers, and in the stream and
    the registry exactly the expected degradations (monitor-predictions,
    and the tensorboard fallback where it ran), so that a writer that
    failed fails the check; a heartbeat.
    Returns the summary's part."""
    from deepspeed_tpu_torch.monitor import (STEP_RECORD_FIELDS,
                                             read_heartbeats,
                                             validate_trace_events)
    from deepspeed_tpu_torch.runtime.resilience.degradation import \
        get_registry
    mon = engine.monitor
    steps = engine.global_steps
    check(len(returned) == steps,
          f"{what}: {len(returned)} returned losses, {steps} steps")
    recs = read_jsonl(mon.jsonl_path)
    by_kind = {}
    for rec in recs:
        by_kind.setdefault(rec["kind"], []).append(rec)
    step_recs = by_kind.get("step", [])
    check([r["step"] for r in step_recs] == list(range(1, steps + 1)),
          f"{what}: step records {[r['step'] for r in step_recs]}")
    want = [round(v, 6) for v in returned]
    got = [r["loss"] for r in step_recs]
    check(got == want, f"{what}: record losses {got[:4]}... against the "
          f"returned {want[:4]}...")
    dispatches = 1 if fused else 2
    check(all(r["dispatches_per_step"] == dispatches for r in step_recs)
          and all(r["mem_source"] == "device" for r in step_recs),
          f"{what}: dispatches / memory source "
          f"{[(r['dispatches_per_step'], r['mem_source']) for r in step_recs][:3]}")
    for step, peak in boundary_peaks.items():
        rec = step_recs[step - 1]
        check(rec["mem_peak_bytes"] == peak,
              f"{what}: step {step}'s mem_peak_bytes {rec['mem_peak_bytes']}"
              f", torch.cuda.max_memory_allocated at its flush {peak}")
    # tokens/s: the records' against the host clock's over the same steps:
    # a turn's first step spans the other engine's turn (left out), and
    # the host clock starts and stops at returns that no flush delays
    rates = []
    for first, last in host_times["turns"]:
        ts = host_times["returns"]
        while first % MONITOR_WINDOW == 0:
            first += 1
        while last % MONITOR_WINDOW == 0:
            last -= 1
        recs_run = step_recs[first:last]  # steps first + 1 .. last
        tokens = sum(r["tokens_per_sec"] * r["wall_time_s"]
                     for r in recs_run)
        rec_rate = tokens / sum(r["wall_time_s"] for r in recs_run)
        host_rate = tokens / (ts[last] - ts[first])
        rates.append((rec_rate, host_rate))
    worst = max(abs(a / b - 1) for a, b in rates)
    check(worst <= MONITOR_RATE_TOL,
          f"{what}: records' tokens/s against the host clock {rates}")
    with open(mon.csv_path, newline="") as f:
        header = next(csv.reader(f))
    check(tuple(header) == STEP_RECORD_FIELDS, f"{what}: csv header {header}")
    with open(mon.trace_path) as f:
        payload = json.load(f)
    problems = validate_trace_events(payload)
    check(not problems, f"{what}: trace problems {problems[:3]}")
    phases = {}
    for ev in payload["traceEvents"]:
        if ev["ph"] == "X":
            phases.setdefault(ev["args"]["step"], []).append(ev["name"])
    expect = (["fused_step(gas=4)"] if fused else
              ["grad_dispatch", "accumulate_dispatch", "apply_dispatch"])
    traced_steps = min(steps, MONITOR_TRACE_STEPS)
    check(sorted(phases) == list(range(1, traced_steps + 1))
          and all(v == expect for v in phases.values()),
          f"{what}: trace phases {dict(list(phases.items())[:3])}")
    recon = by_kind.get("reconcile", [])
    windows = -(-steps // MONITOR_WINDOW)
    check(len(recon) == windows
          and all(r["predicted_step_time_lb_s"] is None and not r["flags"]
                  for r in recon),
          f"{what}: {len(recon)} reconcile records for {windows} windows")
    with open(mon.csv_path, newline="") as f:
        rows = sum(1 for _ in csv.reader(f)) - 1
    check(rows == len(step_recs),
          f"{what}: {rows} csv rows, {len(step_recs)} step records")
    # a writer's failure is a degradation (the writer thread and the
    # tensorboard writer swallow it so that telemetry never raises): the
    # stream and the registry hold the expected ones and no other
    writers = [type(w).__name__ for w in mon._thread.writers]
    check(writers == ["JsonlWriter", "CsvWriter", "TensorBoardWriter"],
          f"{what}: writers {writers}")
    writer = engine._summary_writer
    backend = f"{type(writer).__module__}.{type(writer).__name__}"
    expected = [("monitor-predictions", "static-audit", "measured-only")]
    if type(writer).__name__ == "ScalarJsonlWriter":
        expected.insert(0, ("tensorboard", "torch", "jsonl"))
    degraded = [(r["subsystem"], r["from_tier"], r["to_tier"])
                for r in by_kind.get("degradation", [])]
    registry = [(e["subsystem"], e["from_tier"], e["to_tier"])
                for e in get_registry().events()]
    check(degraded == registry == expected,
          f"{what}: degradation records {degraded}, registry {registry}, "
          f"expected {expected} (tensorboard backend {backend})")
    beats = read_heartbeats(os.path.join(mon.out_dir, "heartbeat"))
    check([(b["process_index"], b["status"], b["step"]) for b in beats]
          == [(0, "stopped", steps)], f"{what}: heartbeats {beats}")
    return {"records": {k: len(v) for k, v in by_kind.items()},
            "tensorboard_backend": backend, "degradations": degraded,
            "record_vs_host_tokens_per_s": rates,
            "reconcile_last": recon[-1],
            "step_record_last": step_recs[-1]}


def monitored_rounds(steps, warmup, iters, per_call):
    """Each engine's warm-up, then `iters` timed calls each in turns
    (plain, monitored, monitored, plain; each turn iters / 2 calls),
    closed by the last loss and a parameter read as bench.py does.
    `steps[name]` runs one step (a train_batch window on the fused path)
    and returns its loss.  Returns (tokens/s by engine, the launches each
    engine's turns counted, the monitored engine's turns as (first step,
    last step) and the host time at each of its returns by step, and the
    allocator's peak after each of its flushing steps), after the
    launches each engine's warm-up counted."""
    counts = {name: None for name in steps}
    warm = {}
    rates = {name: [] for name in steps}
    returns, turns, peaks = {}, [], {}
    mon = steps["monitored"].engine
    for name, step in steps.items():
        def warm_up(name=name, step=step):
            for _ in range(warmup):
                step()
                if name == "monitored":
                    returns[mon.global_steps] = time.perf_counter()
        _, warm[name] = counts_added(warm_up)
    torch.cuda.synchronize()
    half = iters // 2
    for name in ("plain", "monitored", "monitored", "plain"):
        step = steps[name]
        torch.cuda.synchronize()
        first = mon.global_steps + 1
        t0 = time.perf_counter()
        for _ in range(half):
            loss, added = counts_added(step)
            counts[name] = add_counts(counts[name] or
                                      {k: 0 for k in added}, added)
            if name == "monitored":
                returns[mon.global_steps] = time.perf_counter()
                if mon.global_steps % MONITOR_WINDOW == 0:
                    peaks[mon.global_steps] = \
                        torch.cuda.max_memory_allocated()
        float(loss.detach())
        step.engine._flats[0][0].item()
        rates[name].append(per_call * half / (time.perf_counter() - t0))
        if name == "monitored":
            turns.append((first, mon.global_steps))
    return warm, rates, counts, {"turns": turns, "returns": returns}, peaks


class Stepper:
    """One step of `engine` (train_batch on the fused path, else forward /
    backward / step of the batch), keeping every returned loss."""

    def __init__(self, engine, fused, batch):
        self.engine, self.fused = engine, fused
        self.it = repeat_batch(batch) if fused else None
        self.batch = batch
        self.returned = []

    def __call__(self):
        eng = self.engine
        if self.fused:
            loss = eng.train_batch(self.it)
        else:
            loss = eng.forward(self.batch)
            eng.backward(loss)
            eng.step()
        self.returned.append(loss.detach())
        return loss


def capture_on_demand(engine, kind, step_fn):
    """Arm the monitor's capture after this step and run K more: the
    Chrome trace's A/B/D/E launches, the launches the counters counted in
    the K steps, the trace's bytes, the arm's and the K steps' seconds
    (the last step's includes the stop and the export)."""
    cap = engine.monitor.capture
    t0 = time.perf_counter()
    check(cap.arm("chip_smoke", engine.global_steps),
          f"{kind}: the capture did not arm ({cap.failures} failures)")
    arm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, added = counts_added(lambda: [step_fn()
                                     for _ in range(MONITOR_CAPTURE_STEPS)])
    steps_s = time.perf_counter() - t0
    entry = cap.captures[-1]
    check(not cap.armed and cap.failures == 0
          and entry["steps"] == MONITOR_CAPTURE_STEPS
          and os.path.exists(entry["path"]),
          f"{kind}: capture {entry}, failures {cap.failures}")
    return {"path": entry["path"],
            "traced": trace_kernel_launches(entry["path"]),
            "counted": added,
            "bytes": os.path.getsize(entry["path"]), "arm_s": arm_s,
            "captured_steps_s": steps_s}


def fused_issue_split(stepper):
    """HOST_ISSUE_STEPS windows of the monitored fused engine, each after a
    synchronisation: train_batch's host ms, its fused_step span (read back
    from the monitor's trace buffer), and inside the span the wrapper's
    parts (the batch's stacking and cut, its copy into the static
    buffers, the replay call)."""
    fs = stepper.engine._fused
    parts = {"shares": [], "load_inputs": [], "replay": []}
    owners = {"shares": fs, "load_inputs": fs, "replay": fs.graph}
    if fs.graph is None:  # an eager window (the CPU)
        del parts["replay"], owners["replay"]
    names = {"shares": "_shares", "load_inputs": "_load_inputs",
             "replay": "replay"}

    def timed(part, fn):
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            parts[part].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    for part, owner in owners.items():
        setattr(owner, names[part], timed(part, getattr(owner, names[part])))
    issue, spans = [], []
    try:
        for _ in range(HOST_ISSUE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stepper()
            issue.append((time.perf_counter() - t0) * 1e3)
            span = stepper.engine.monitor.trace.events[-1]
            check(span["name"] == "fused_step(gas=4)",
                  f"the last trace event {span}")
            spans.append(span["dur"] / 1e3)
        torch.cuda.synchronize()
    finally:
        for part, owner in owners.items():
            del owner.__dict__[names[part]]
    return {"train_batch_host_ms": issue, "fused_step_span_ms": spans,
            "span_share": float(np.median(spans) / np.median(issue)),
            "rest_of_train_batch_ms": [a - b for a, b in zip(issue, spans)],
            "span_parts_ms": parts}


def phase_monitor(state):
    """bench_gpt2 (3 + 30 steps) and bench_gpt2_gas4_fused (2 + 8
    windows), each path as two engines from the same weights, without and
    with the monitor (monitor_config), timed in turns.  Checks the
    monitored run's files (check_monitor_files); that kernels A, B, D and
    E run as often with the monitor as without it (each engine's counters
    read over its warm-up and its turns: on the fused path the warm-up is
    the eager window and the capture, a replay moves no counter, and a
    profiled replay's trace counts its launches), and that the counters
    read after the capture hold nothing else; that no per-step
    monitor call synchronises (MonitorProbe); and a capture armed on
    purpose: its Chrome trace's A/B/D/E launches equal the counters of
    the K steps it traced (modular) or K traced replays' (fused).
    Reports the monitored / unmonitored tokens/s, the monitor's host µs a
    step and ms a flush (with the batched loss read's share: it waits for
    the card to reach the window's last loss), and on the fused path the
    fused_step span (the batch copy and the replay) against train_batch's
    whole host time after a synchronisation (fused_issue_split)."""
    from deepspeed_tpu_torch.runtime.resilience.degradation import \
        get_registry
    cfg = gpt2_124m_train()
    ids = bench_ids(cfg, TRAIN_BATCH)
    summary, path_counts, replay_traced = {}, None, None
    with mp_dir() as out_dir:
        for kind, ds_config, warmup, iters in (
                ("modular", BENCH_GPT2_CONFIG, TRAIN_WARMUP, TRAIN_ITERS),
                ("fused", fused_config(BENCH_GAS4_CONFIG), GAS4_WARMUP,
                 GAS4_ITERS)):
            gc_cuda()
            fused = kind == "fused"
            gas = 4 if fused else 1
            window = {k: gas * v for k, v in step_counts(cfg).items()}
            # each stream carries its own tensorboard and measured-only
            # records (the registry reports a degradation once a process)
            get_registry().clear()
            steps = {"plain": Stepper(train_engine(cfg, state, ds_config),
                                      fused, ids),
                     "monitored": Stepper(train_engine(
                         cfg, state, monitor_config(
                             ds_config, os.path.join(out_dir, kind))),
                         fused, ids)}
            check(all((st.engine._fused is not None) == fused
                      for st in steps.values()),
                  f"{kind}: fused_step "
                  f"{[st.engine.fused_step_reason for st in steps.values()]}")
            mon_step = steps["monitored"]
            mon_eng = mon_step.engine
            probe = MonitorProbe(mon_eng)
            reset_launch_counts()
            warm, rates, counts, host_times, peaks = monitored_rounds(
                steps, warmup, iters, gas * TRAIN_BATCH * TRAIN_SEQ)
            row = {"tokens_per_s_plain": float(np.median(rates["plain"])),
                   "tokens_per_s_monitored": float(np.median(
                       rates["monitored"])),
                   "tokens_per_s_rounds": rates}
            row["monitored_over_plain"] = (row["tokens_per_s_monitored"]
                                           / row["tokens_per_s_plain"])
            if fused:
                # the counters saw each engine's eager window and capture
                # (its warm-up); a replay moves none: a profiled one's
                # trace counts its launches
                check(all(st.engine._fused.launches_captured == window
                          for st in steps.values())
                      and all(w == {k: 2 * v for k, v in window.items()}
                              for w in warm.values())
                      and all(not any(c.values()) for c in counts.values()),
                      f"fused: captured "
                      f"{[st.engine._fused.launches_captured for st in steps.values()]}"
                      f", the warm-ups counted {warm}, the turns {counts}, "
                      f"a window {window}")
                traced = {name: traced_launches(_profile_once(st)[3])
                          for name, st in steps.items()}
                check(traced["plain"] == traced["monitored"]
                      == traced_part(window),
                      f"fused replays' traces {traced}, a window "
                      f"{traced_part(window)}")
                replay_traced = traced["monitored"]
                row["fused_issue_split"] = fused_issue_split(mon_step)
                # the same windows' host issue without the monitor
                row["fused_issue_split"]["plain_train_batch_host_ms"] = \
                    host_issue_ms(steps["plain"])
            else:
                check(warm["plain"] == warm["monitored"]
                      == {k: warmup * v for k, v in window.items()}
                      and counts["plain"] == counts["monitored"]
                      == {k: iters * v for k, v in window.items()},
                      f"modular: the warm-ups counted {warm}, the turns "
                      f"{counts}, a step {window}")
            counted = add_counts(warm["monitored"], counts["monitored"])
            path_counts = add_counts(path_counts or {k: 0 for k in counted},
                                     counted)
            capture = capture_on_demand(mon_eng, kind, mon_step)
            k_steps = traced_part({k: MONITOR_CAPTURE_STEPS * v
                                   for k, v in window.items()})
            if fused:
                check(capture["traced"] == k_steps
                      and not any(capture["counted"].values()),
                      f"fused capture: traced {capture['traced']}, K "
                      f"replays {k_steps}, counters {capture['counted']}")
            else:
                check(capture["traced"] == traced_part(capture["counted"])
                      == k_steps,
                      f"modular capture: traced {capture['traced']}, "
                      f"counted {capture['counted']}, K steps {k_steps}")
            path_counts = add_counts(path_counts, capture["counted"])
            # every launch since the reset is one of those measured above
            total = add_counts(*warm.values(), *counts.values(),
                               capture["counted"])
            check(launch_counts() == total,
                  f"{kind}: {launch_counts()} launches since the reset, "
                  f"{total} in the warm-ups, turns and capture")
            probe.close()
            mon_eng.monitor.close()
            check(probe.checked > 0, f"{kind}: no per-step call checked")
            losses = [float(v) for v in mon_step.returned]
            row.update(check_monitor_files(mon_eng, kind, fused, losses,
                                           host_times, peaks))
            row.update(
                steps=mon_eng.global_steps,
                monitor_host_us_per_step=float(np.median(probe.step_us)),
                monitor_host_us_per_step_p90=float(
                    np.percentile(probe.step_us, 90)),
                calls_checked_sync_free=probe.checked,
                # the writer thread's ms a step inside each writer (GIL time
                # taken beside the issuing thread, on the modular loop)
                writer_thread_ms_per_step={
                    name: sec * 1e3 / mon_eng.global_steps
                    for name, sec in probe.writer_s.items()},
                flush_ms=probe.flush_ms, flush_parts_ms=probe.parts_ms,
                # a flush's time but its two device reads' (their wait)
                flush_host_ms=[
                    f - b - l for f, b, l in zip(
                        probe.flush_ms, probe.parts_ms["boundary_reads"],
                        probe.parts_ms["loss_fetch"])],
                capture={k: v for k, v in capture.items() if k != "path"},
                trace_bytes=os.path.getsize(mon_eng.monitor.trace_path))
            summary[kind] = row
            del steps, mon_step, mon_eng, probe
            gc_cuda()
    return (path_counts, replay_traced), summary


def mp_monitor_worker(out_dir):
    """monitor_mp in one process: bench_gpt2's step over the process
    group with monitor.fleet and heartbeats, MONITOR_MP_STEPS steps; the
    steps at which the window exchange ran (the gather wrapped)."""
    cfg = gpt2_124m_train()
    state = init_state(cfg)
    world, rank = dist.get_world_size(), dist.get_rank()
    ds_config = dict(dp_config(TRAIN_BATCH, 2, world), monitor={
        "enabled": True, "output_path": os.path.join(out_dir, "monitor"),
        "writers": ["jsonl"], "write_interval": MONITOR_WINDOW,
        "fleet": True, "heartbeat": True})
    engine = train_engine(cfg, state, ds_config)
    mon = engine.monitor
    check(mon is not None and mon.fleet is not None, "no fleet monitor")
    exchanged = []
    gather = mon.fleet._gather

    def counted_gather(vec):
        if vec.dtype == np.float64:
            exchanged.append(engine.global_steps)
        return gather(vec) if gather is not None else vec[None]

    mon.fleet._gather = counted_gather
    ids = bench_ids(cfg, TRAIN_BATCH * world)
    rows = ids[rank * TRAIN_BATCH:(rank + 1) * TRAIN_BATCH]
    reset_launch_counts()
    for _ in range(MONITOR_MP_STEPS):
        loss = engine.forward(rows)
        engine.backward(loss)
        engine.step()
    float(loss.detach())
    counts = launch_counts()
    exchanges = mon.fleet.exchanges
    mon.close()
    return {"rank": rank, "world": world, "exchanged_at": exchanged,
            "exchanges": exchanges, "launches": counts,
            "gloo_group": gather is not None,
            "jsonl": mon.jsonl_path, "out_dir": mon.out_dir}


def phase_monitor_mp(state):
    """launch_mp's processes, one a visible card, with monitor.fleet and
    heartbeats (write_interval MONITOR_WINDOW, MONITOR_MP_STEPS steps):
    every process exchanged once a full window, at its boundary step (over
    the engine's gloo group above one process, the local stack at one);
    rank 0's stream holds a fleet_host record a process and a fleet record
    a window (at W = 1 the degenerate one-host summary); every process
    beat its heartbeat."""
    from deepspeed_tpu_torch.monitor import (read_heartbeats,
                                             straggler_verdict)
    del state  # each worker makes the same weights from the seed
    torch.cuda.empty_cache()
    windows = MONITOR_MP_STEPS // MONITOR_WINDOW
    with mp_results("monitor_mp") as (_, results):
        world = len(results)
        recs = read_jsonl(results[0]["jsonl"])
        beats = read_heartbeats(os.path.join(results[0]["out_dir"],
                                             "heartbeat"))
    # the exchange runs in the boundary step's end_step, after its update
    boundaries = [MONITOR_WINDOW * (w + 1) for w in range(windows)]
    for res in results:
        check(res["exchanges"] == windows
              and res["exchanged_at"] == boundaries
              and res["gloo_group"] == (world > 1),
              f"rank {res['rank']}: {res['exchanges']} exchanges at steps "
              f"{res['exchanged_at']} (boundaries after {boundaries}), "
              f"gloo {res['gloo_group']}")
    kinds = [r["kind"] for r in recs]
    fleet = [r for r in recs if r["kind"] == "fleet"]
    check(kinds.count("fleet_host") == windows * world
          and len(fleet) == windows
          and all(f["hosts"] == world for f in fleet),
          f"rank 0's records: {kinds}")
    check([(b["process_index"], b["status"]) for b in beats]
          == [(r, "stopped") for r in range(world)], f"heartbeats {beats}")
    if world == 1:
        per_host = fleet[-1]["per_host"]
        check(fleet[-1]["step_time_min_s"] == fleet[-1]["step_time_max_s"]
              and len(per_host["host"]) == 1 and fleet[-1]["loss_spread"]
              == 0.0, f"W = 1 fleet record {fleet[-1]}")
    counts = {name: sum(res["launches"][name] for res in results)
              for name in results[0]["launches"]}
    window = step_counts(gpt2_124m_train())
    check(all(res["launches"] == {k: MONITOR_MP_STEPS * v
                                  for k, v in window.items()}
              for res in results),
          f"launch counts {[res['launches'] for res in results]}")
    return counts, {
        "processes": world, "windows": windows,
        "exchanges_by_rank": [res["exchanges"] for res in results],
        "exchanged_at_step": results[0]["exchanged_at"],
        "gloo_group": results[0]["gloo_group"],
        "records": {k: kinds.count(k) for k in sorted(set(kinds))},
        "fleet_last": fleet[-1],
        "health": [r for r in recs if r["kind"] == "health"],
        "heartbeats": [(b["process_index"], b["status"], b["step"])
                       for b in beats]}


# --------------------------------------------------------------------- #
# phases 12 and 13: the low-bandwidth collective tier on W logical ranks
# --------------------------------------------------------------------- #
def fcm_inputs(shape, dtype, seed, scale=1.0):
    """One [*shape] tensor per rank from a CPU generator, in `dtype`; the
    ranks' data differ."""
    g = torch.Generator().manual_seed(seed)
    return [(scale * torch.randn(*shape, generator=g)).to(dtype)
            for _ in range(FCM_WORLD)]


def on_card(mesh, tensors, grad=False):
    """Rank r's tensor on rank r's device."""
    out = [t.detach().to(mesh.device_of(r)) for r, t in enumerate(tensors)]
    return [t.requires_grad_() for t in out] if grad else out


def sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)




def counted(fn, **expected):
    """fn() with its launch counts held exactly to `expected` (every other
    kernel 0)."""
    before = launch_counts()
    out = fn()
    delta = {k: v - before[k] for k, v in launch_counts().items()}
    check(delta == expected_counts(**expected),
          f"launch counts {delta}, expected {expected}")
    return out


def worst_rel(got, ref):
    """max over the ranks of max|d| / max|ref|."""
    return max(rel_err(g.detach().float().cpu(), r.detach().float().cpu())
               for g, r in zip(got, ref))


def scatter_steps(tiles, bits):
    """Per destination rank, how far its reduce-scattered chunk may move
    when rounds flip: the sum over the sources of the scale of the
    element's block, from the sources' exact [K, N] fp32 tiles.  Also each
    source's own steps [K, N] (for its error residual)."""
    k, n = tiles[0].shape
    kc = k // FCM_WORLD
    own = []
    for tile in tiles:
        _, s = lb.blockwise_quantize(tile.reshape(FCM_WORLD, kc, n), dim=0,
                                     bits=bits, block=FCM_BLOCK)
        bs = kc * n // s.shape[1]
        own.append(s.repeat_interleave(bs, dim=1).reshape(FCM_WORLD, kc, n))
    chunk = [sum(o[d].to(own[d].device) for o in own)
             for d in range(FCM_WORLD)]
    return chunk, [o.reshape(k, n) for o in own]


def hold_one_step(what, got, ref, steps, rtol, stats, magnitude=None):
    """The one-step rule over the ranks."""
    for r in range(FCM_WORLD):
        ok, share, worst = one_step_rule(
            got[r], ref[r].to(got[r].device), steps[r], rtol,
            None if magnitude is None else magnitude[r])
        stats["far_share"] = max(stats.get("far_share", 0.0), share)
        stats["worst_steps"] = max(stats.get("worst_steps", 0.0), worst)
        check(ok, f"{what}, rank {r}: {share:.2e} of the elements differ by "
                  f"more than {rtol}, the worst by {worst:.3f} steps")


def ag_launches(route, qgz):
    """Exact launch counts of one fused_allgather_matmul forward and of its
    backward at W = 4 (W steps on each of W ranks)."""
    n = FCM_WORLD * FCM_WORLD
    if route == "per_tile":
        return dict(fcm_tile_ag=n), dict(fcm_tile_ag_t=n, fcm_tile_rs=n)
    if qgz == 8:
        return dict(fcm_ag_step=n), dict(fcm_ag_step_t=n, fcm_rs_producer=n,
                                         fcm_rs_collect=FCM_WORLD)
    return dict(fcm_ag_step=n), dict(fcm_ag_step_t=n, fcm_tile_rs=n)


def sum_of_squares(ys):
    """The sum over the ranks of sum(y ** 2), on the first rank's device."""
    return sum((t.float() ** 2).sum().to(ys[0].device) for t in ys)


def run_ag(mesh, x, w, qwz, qgz, per_tile, counts=None):
    """y, dx, dW of loss = sum of squares through fused_allgather_matmul."""
    fwd, bwd = counts if counts else (None, None)
    op = lambda: cm.fused_allgather_matmul(  # noqa: E731
        x, w, "data", qwz, qgz, FCM_BLOCK, per_tile, mesh=mesh)
    y = counted(op, **fwd) if fwd else op()
    loss = sum_of_squares(y)
    if bwd:
        counted(loss.backward, **bwd)
    else:
        loss.backward()
    return ([t.detach() for t in y], [t.grad for t in x], [t.grad for t in w])


def fcm_allgather_matmul(mesh, plain, name, dtype, qwz, qgz):
    """fused_allgather_matmul forward and backward at one matrix, both
    routes on the card, against the plain versions (`plain`, a mesh of the
    card driven under plain_versions)."""
    k, n = FCM_MATRICES[name]
    seed = k + n + qwz
    x = fcm_inputs((FCM_ROWS, k), dtype, seed)
    w = fcm_inputs((k // FCM_WORLD, n), dtype, seed + 1, scale=0.05)
    with plain_versions():
        ref = run_ag(plain, on_card(plain, x, True), on_card(plain, w, True),
                     qwz, qgz, None)
    tol = FCM_TOL[dtype]
    stats = {"case": f"{name} {_dtname(dtype)} qwz={qwz} qgz={qgz}"}
    got = {}
    for route, per_tile in (("fused", None), ("per_tile", True)):
        got[route] = y, dx, dw = run_ag(
            mesh, on_card(mesh, x, True), on_card(mesh, w, True), qwz, qgz,
            per_tile,
            ag_launches(route, qgz))
        sync_all()
        for what, a, b in (("y", y, ref[0]), ("dx", dx, ref[1])):
            err = worst_rel(a, b)
            stats[f"{route}_{what}_rel_err"] = err
            check(err <= tol, f"{stats['case']} {route} {what}: {err}")
        if qgz:
            # dW sums W quantized tiles x_r^T g_r, g_r the loss's grad.  The
            # reference takes the card's own g_r, so that a bf16 rounding of
            # y that fell the other way does not pass for a flipped round
            grads = [(2 * t.float()).to(dtype) for t in y]
            tiles = [a.float().t() @ g.float()
                     for a, g in zip(on_card(mesh, x), grads)]
            steps, _ = scatter_steps(tiles, qgz)
            with plain_versions():
                ref_dw, _ = cm.fused_matmul_reduce_scatter(
                    on_card(plain, x), on_card(plain, grads), None, "data",
                    qgz, FCM_BLOCK, mesh=plain)
            hold_one_step(f"{stats['case']} {route} dW", dw,
                          [t.to(dtype) for t in ref_dw], steps, tol, stats)
        else:
            err = worst_rel(dw, ref[2])
            stats[f"{route}_dw_rel_err"] = err
            check(err <= tol, f"{stats['case']} {route} dW: {err}")
    stats["routes_bitwise"] = all(
        torch.equal(a, b) for f, p in zip(got["fused"], got["per_tile"])
        for a, b in zip(f, p))
    return stats


def fcm_matmul_reduce_scatter(mesh, plain, name, dtype, qgz):
    """fused_matmul_reduce_scatter over FCM_STEPS steps with the error
    buffers carried on the card; at every step the plain versions (on
    `plain`) are fed the card's buffers, so that a flipped round does not
    compound."""
    k, n = FCM_MATRICES[name]
    kc = k // FCM_WORLD
    lhs = fcm_inputs((FCM_ROWS, k), dtype, k + qgz)
    rhs = fcm_inputs((FCM_ROWS, n), dtype, n + qgz)
    clhs, crhs = on_card(mesh, lhs), on_card(mesh, rhs)
    tiles = [a.float().t() @ b.float() for a, b in zip(clhs, crhs)]
    exact = sum(t.cpu() for t in tiles)
    err = [torch.zeros(k, n, device=mesh.device_of(r))
           for r in range(FCM_WORLD)]
    fused = qgz == 8
    expected = (dict(fcm_rs_producer=FCM_WORLD * FCM_WORLD,
                     fcm_rs_collect=FCM_WORLD) if fused
                else dict(fcm_tile_rs=FCM_WORLD * FCM_WORLD))
    stats = {"case": f"{name} {_dtname(dtype)} qgz={qgz}",
             "route": "fused (kernel J)" if fused else "per-tile (kernel H)"}
    total, first = 0, None
    plhs, prhs = on_card(plain, lhs), on_card(plain, rhs)
    for step in range(FCM_STEPS):
        with plain_versions():
            ref_chunk, ref_err = cm.fused_matmul_reduce_scatter(
                plhs, prhs, on_card(plain, err), "data", qgz, FCM_BLOCK,
                mesh=plain)
        chunk, new_err = counted(
            lambda: cm.fused_matmul_reduce_scatter(
                clhs, crhs, err, "data", qgz, FCM_BLOCK, mesh=mesh),
            **expected)
        sync_all()
        what = f"{stats['case']} step {step}"
        if qgz:
            comp = [t + e for t, e in zip(tiles, err)]
            steps, own = scatter_steps(comp, qgz)
            hold_one_step(what + " chunk", chunk, ref_chunk, steps, 1e-4,
                          stats)
            hold_one_step(what + " new_error", new_err, ref_err, own, 1e-4,
                          stats, magnitude=comp)
        else:
            e = worst_rel(chunk, ref_chunk)
            stats["rel_err"] = max(stats.get("rel_err", 0.0), e)
            check(e <= 1e-4, f"{what} chunk: {e}")
            check(all(bool((t == 0).all()) for t in new_err),
                  f"{what}: the error buffer left zero at 0 bits")
        got = torch.cat([c.cpu() for c in chunk])
        total = total + got
        first = got if first is None else first
        err = new_err
    if qgz:
        err1 = (first - exact).abs().max().item()
        err6 = (total / FCM_STEPS - exact).abs().max().item()
        stats.update(err_first_step=err1, err_mean_of_steps=err6)
        check(err6 < err1 / 2, f"{stats['case']}: the mean of "
              f"{FCM_STEPS} steps is off by {err6}, the first by {err1}")
    return stats


def fcm_transports(mesh, dtype):
    """Layer 2 on the card: the per-tile transports bitwise against the
    modular functions, forward and backward, at c_fc's shard and dW."""
    k, n = FCM_MATRICES["c_fc"]
    w = fcm_inputs((k // FCM_WORLD, n), dtype, 11, scale=0.05)
    same = lambda a, b: all(torch.equal(s, t.to(s.device))  # noqa: E731
                            for s, t in zip(a, b))
    first = mesh.device_of(0)
    stack = lambda ts: torch.stack([t.to(first) for t in ts])  # noqa: E731
    stats = {"case": f"c_fc {_dtname(dtype)}"}
    for qwz, qgz in FCM_BITS:
        grads = {}
        for fn in (cm.fcm_all_gather, lb.low_bandwidth_all_gather):
            ws = on_card(mesh, w, True)
            full = fn(ws, ("data",), 0, qwz, qgz, FCM_BLOCK, mesh=mesh)
            sum_of_squares(full).backward()
            grads[fn] = ([t.detach() for t in full], [t.grad for t in ws])
        sync_all()
        fused, modular = grads[cm.fcm_all_gather], \
            grads[lb.low_bandwidth_all_gather]
        check(same(fused[0], modular[0]),
              f"fcm_all_gather forward differs at ({qwz}, {qgz}) {dtype}")
        if qgz:
            check(same(fused[1], modular[1]),
                  f"fcm_all_gather backward differs at ({qwz}, {qgz})")
        else:  # psum_scatter's order is its own: fp32 rounding of 4 terms
            e = max(rel_err(a.float(), b.float())
                    for a, b in zip(fused[1], modular[1]))
            check(e <= FCM_TOL[dtype], f"fcm_all_gather fp32 backward: {e}")
    dw = on_card(mesh, fcm_inputs((k, n), torch.float32, 12))
    for bits in (8, 4):
        check(same(cm.fcm_reduce_scatter(dw, ("data",), 0, bits, FCM_BLOCK,
                                         mesh=mesh),
                   lb.quantized_psum_scatter(dw, ("data",), 0, bits,
                                             FCM_BLOCK, mesh=mesh)),
              f"fcm_reduce_scatter differs at {bits} bits")
        ferr = merr = serr = lb.init_error_feedback(dw)
        for step in range(FCM_STEPS):
            fred, ferr = cm.fcm_qgz_reduce_scatter_inner(
                dw, ferr, "data", 0, bits, FCM_BLOCK, mesh=mesh)
            mred, merr = lb.qgz_reduce_scatter_inner(
                dw, merr, "data", 0, bits, FCM_BLOCK, mesh=mesh)
            sred, serr_t = lb.qgz_reduce_scatter(
                stack(dw), stack(serr), mesh, "data", bits, FCM_BLOCK)
            serr = list(serr_t.unbind(0))
            check(same(fred, mred) and same(ferr, merr)
                  and same(list(sred.unbind(0)), mred) and same(serr, merr),
                  f"qgz reduce-scatter variants differ at {bits} bits, "
                  f"step {step}")
    e = max(rel_err(a, b) for a, b in zip(
        cm.fcm_reduce_scatter(dw, ("data",), 0, 0, FCM_BLOCK, mesh=mesh),
        lb.f32_psum_scatter(dw, ("data",), 0, mesh=mesh)))
    check(e <= 1e-6, f"fcm_reduce_scatter at 0 bits vs f32_psum_scatter: {e}")
    sync_all()
    stats["bitwise"] = True
    return stats


def mlp_slice(mesh, x, w_fc, w_proj, per_tile=None, counts=False):
    """c_fc -> gelu -> c_proj through two fused_allgather_matmul calls,
    loss = sum of squares, backward.  Returns the per-rank losses, dx and
    the dW shards of both matrices."""
    n = FCM_WORLD * FCM_WORLD
    fwd = dict(fcm_ag_step=n) if counts else None
    op = lambda a, w: cm.fused_allgather_matmul(  # noqa: E731
        a, w, "data", 8, 0, FCM_BLOCK, per_tile, mesh=mesh)
    h = counted(lambda: op(x, w_fc), **fwd) if counts else op(x, w_fc)
    act = [activations.gelu(t) for t in h]
    y = counted(lambda: op(act, w_proj), **fwd) if counts else op(act, w_proj)
    losses = [(t.float() ** 2).sum() for t in y]
    total = sum(t.to(losses[0].device) for t in losses)
    if counts:
        counted(total.backward, fcm_ag_step_t=2 * n, fcm_tile_rs=2 * n)
    else:
        total.backward()
    return ([t.detach() for t in losses], [t.grad for t in x],
            [t.grad for t in w_fc], [t.grad for t in w_proj])


def fcm_slice(mesh, plain, dtype):
    hidden = FCM_MATRICES["c_fc"][0]
    x = fcm_inputs((FCM_ROWS, hidden), dtype, 21)
    w_fc = fcm_inputs((hidden // FCM_WORLD, 4 * hidden), dtype, 22, scale=0.02)
    w_proj = fcm_inputs((4 * hidden // FCM_WORLD, hidden), dtype, 23,
                        scale=0.02)
    with plain_versions():
        ref = mlp_slice(plain, *(on_card(plain, t, True)
                                 for t in (x, w_fc, w_proj)))
    got = mlp_slice(mesh, *(on_card(mesh, t, True)
                            for t in (x, w_fc, w_proj)),
                    counts=True)
    sync_all()
    stats = {"case": f"c_fc -> gelu -> c_proj {_dtname(dtype)}"}
    for what, a, b in zip(("loss", "dx", "dw_fc", "dw_proj"), got, ref):
        check(all(bool(torch.isfinite(t.float()).all()) for t in a),
              f"slice {what}: not finite")
        stats[f"{what}_rel_err"] = err = worst_rel(a, b)
        check(err <= FCM_TOL[dtype], f"slice {dtype} {what}: {err}")
    return stats


def phase_fcm_ops():
    mesh = MeshContext.create(data=FCM_WORLD)
    # the plain versions' mesh: the same ranks, driven under plain_versions
    plain = MeshContext.create(data=FCM_WORLD)
    check(mesh.world_size == FCM_WORLD and mesh.is_cuda,
          f"the mesh is {mesh}")
    reset_launch_counts()
    results = []
    for name in FCM_MATRICES:
        for dtype in FCM_DTYPES:
            for qwz, qgz in FCM_BITS:
                results.append(fcm_allgather_matmul(mesh, plain, name, dtype,
                                                    qwz, qgz))
                emit({"phase": "fcm_ops", "op": "fused_allgather_matmul",
                      **results[-1]})
            for _, qgz in FCM_BITS:
                results.append(fcm_matmul_reduce_scatter(mesh, plain, name,
                                                         dtype, qgz))
                emit({"phase": "fcm_ops",
                      "op": "fused_matmul_reduce_scatter", **results[-1]})
    for dtype in FCM_DTYPES:
        for fn, op in ((fcm_transports, "transports"), (fcm_slice, "slice")):
            args = (mesh, dtype) if fn is fcm_transports else (mesh, plain,
                                                               dtype)
            emit({"phase": "fcm_ops", "op": op, **fn(*args)})
    counts = launch_counts()
    realigned = check_aligned("fcm_ops")
    return counts, {
        "mesh": repr(mesh), "cases": len(results) + 2 * len(FCM_DTYPES),
        "realigned": realigned,
        "worst_far_share": max(r.get("far_share", 0.0) for r in results),
        "worst_steps": max(r.get("worst_steps", 0.0) for r in results),
        "routes_bitwise": all(r.get("routes_bitwise", True)
                              for r in results),
        "launches": {k: v for k, v in counts.items() if v}}


def timed_all(fn):
    """Wall seconds of fn(), every device synchronized at both ends."""
    sync_all()
    t0 = time.perf_counter()
    fn()
    sync_all()
    return time.perf_counter() - t0


def wall_ms(fns, runs=FCM_TIMED_RUNS):
    """Median wall ms of each fn(), synchronized at both ends, the fns in
    turns and the order reversed every round."""
    names = list(fns)
    for name in names:
        fns[name]()
    times = {name: [] for name in names}
    for i in range(runs):
        for name in (names if i % 2 == 0 else names[::-1]):
            times[name].append(timed_all(fns[name]) * 1e3)
    return {name: float(np.median(t)) for name, t in times.items()}


# kernel names of the tile products in a trace: kernel I's and J's on
# either route (CUDA cores: tile_matmul.cuh; tensor cores: tile_mma.cuh,
# with the split passes), the collect excluded
FCM_PRODUCT_KERNELS = ("tile_matmul_kernel", "wprod_mma_kernel",
                       "split_sum_kernel", "at_b_mma_kernel",
                       "split_quantize_kernel")


def device_spans(fn, calls):
    """The device events of a torch.profiler trace of `calls` fn().  Only
    device activity is traced: tracing the host's side as well slows the
    enqueueing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            timed_all(fn)
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def _is_product(name):
    return any(k in name for k in FCM_PRODUCT_KERNELS)


def products_device_ms(fn, calls=5):
    """Device ms per call of the tile products in a trace of `calls` fn(),
    and their number per call."""
    events = [e for e in device_spans(fn, calls) if _is_product(e.name)]
    if not events:
        return {"products": "not measured: the trace holds no product"}
    return {"calls": calls, "products_per_call": len(events) / calls,
            "products_device_ms_per_call":
                sum(e.time_range.end - e.time_range.start
                    for e in events) / 1e3 / calls}


def copy_overlap_share(fn, calls=5):
    """From a torch.profiler trace of `calls` fn(): the share of the
    device-to-device copies' time that lay under a tile product, their
    number and their total ms (the share depends on how soon after a
    product's launch the host enqueues its copy)."""
    events = device_spans(fn, calls)
    spans = lambda pred: sorted(  # noqa: E731
        (e.time_range.start, e.time_range.end) for e in events if pred(e.name))
    copies = spans(lambda name: "memcpy" in name.lower())
    products = spans(_is_product)
    if not copies or not products:
        return {"copy_overlap": "not measured: the trace holds "
                f"{len(copies)} copies and {len(products)} products"}
    under = 0.0
    for start, end in copies:
        under += _union_us((max(start, ps), min(end, pe))
                           for ps, pe in products if ps < end and pe > start)
    total = sum(end - start for start, end in copies)
    return {"calls": calls, "copies": len(copies), "copy_ms": total / 1e3,
            "products": len(products),
            "products_device_ms_per_call":
                sum(e - s for s, e in products) / 1e3 / calls,
            "copy_share_under_a_product": under / total}


def phase_fcm_timing():
    """Whole ops at W = 4 on the one card, c_fc in bf16 at 8 bits."""
    mesh = MeshContext.create(data=FCM_WORLD)
    k, n = FCM_MATRICES["c_fc"]
    dtype = torch.bfloat16
    x = on_card(mesh, fcm_inputs((FCM_ROWS, k), dtype, 31))
    w = on_card(mesh, fcm_inputs((k // FCM_WORLD, n), dtype, 32, scale=0.05))
    g = on_card(mesh, fcm_inputs((FCM_ROWS, n), dtype, 33))
    err = [torch.zeros(k, n, device=mesh.device_of(r))
           for r in range(FCM_WORLD)]

    def ag(per_tile):
        return cm.fused_allgather_matmul(x, w, "data", 8, 8, FCM_BLOCK,
                                         per_tile, mesh=mesh)

    def ag_yardstick():
        full = lb.low_bandwidth_all_gather(w, ("data",), 0, 8, 8, FCM_BLOCK,
                                           mesh=mesh)
        return [torch.matmul(a, b) for a, b in zip(x, full)]

    def rs(per_tile):
        return cm.fused_matmul_reduce_scatter(x, g, err, "data", 8, FCM_BLOCK,
                                              per_tile, mesh=mesh)

    def rs_yardstick():
        dw = [torch.matmul(a.t(), b).float() for a, b in zip(x, g)]
        return lb.qgz_reduce_scatter_inner(dw, err, "data", 0, 8, FCM_BLOCK,
                                           mesh=mesh)

    with torch.no_grad():
        ag_ms = wall_ms({"fused": lambda: ag(None),
                         "per_tile": lambda: ag(True),
                         "yardstick": ag_yardstick})
        rs_ms = wall_ms({"fused": lambda: rs(None),
                         "per_tile": lambda: rs(True),
                         "yardstick": rs_yardstick})
        overlap = copy_overlap_share(lambda: ag(None))
        producers = products_device_ms(lambda: rs(None))
        per_tile_ag = products_device_ms(lambda: ag(True))
        per_tile_rs = products_device_ms(lambda: rs(True))
    return None, {
        "case": f"c_fc [{k},{n}] bf16, 8 bits, M={FCM_ROWS} per rank, "
                f"W={FCM_WORLD} ranks on {len(mesh.devices)} card(s)",
        "allgather_matmul_forward_ms": ag_ms,
        "matmul_reduce_scatter_ms": rs_ms,
        "yardstick": "low_bandwidth_all_gather then torch.matmul; "
                     "torch.matmul then qgz_reduce_scatter_inner",
        "fused_forward_trace": overlap,
        "fused_reduce_scatter_producers": producers,
        "per_tile_forward_products": per_tile_ag,
        "per_tile_reduce_scatter_products": per_tile_rs}


# the parity groups of the kernels a data-parallel train step runs

# --------------------------------------------------------------------- #
# phases 31-35: ZeRO-3, the streamed layer executor
# --------------------------------------------------------------------- #
ZERO3_WORLD, ZERO3_MICRO = 4, 2  # bench.py: global batch 8 over W = 4
ZERO3_GRADS_LAYERS = 2  # zero3_grads' depth
ZERO3_CKPT_RESUMED = 2  # checkpoint_zero3: steps after the save
ZERO3_LOW_BANDWIDTH = {"qwz_bits": 8, "qgz_bits": 8}  # bench.py:906-908
# train_zero3_fcm's timed steps a transport: bench.py's 3 + 30 would take
# ~40 s more of the script's time limit (the fused transports' host issue
# is ~1.3 s a step); the trajectories are held bitwise over these 3 + 10
ZERO3_FCM_ITERS = 10
# train_zero3_remat's timed steps a plan, as train_zero3_fcm's: the
# trajectory is held bitwise over the 3 + 10 steps against train_zero3's
ZERO3_REMAT_ITERS = 10
TILED_ROWS, TILED_SPLITS = TRAIN_BATCH * TRAIN_SEQ, (4, 4)  # tiled_linear


def zero3_per_layer(cfg):
    """A layer's parameters (bench.py's per_layer: 7,087,872 at GPT-2
    124M)."""
    return (cfg.num_params(False) - 2 * cfg.hidden_size) // cfg.num_layers


def zero3_config(cfg, carried, fcm=None, micro=ZERO3_MICRO):
    """bench.py::_zero3_stream_run's engine config (bench.py:806-825) at
    `micro` rows a rank on ZERO3_WORLD ranks: `zero3_stream` (carried
    False: max_live 2 layers, no bucket, mode off), `_carried` (4 layers,
    bucket 2, carried) and, with `fcm` a bool, `_fcm` (the carried knobs
    with qwZ 8 / qgZ 8 and fused_collective_matmul = fcm)."""
    per = zero3_per_layer(cfg)
    zc = {"stage": 3, "stage3_param_persistence_threshold": 0,
          "stage3_max_live_parameters": (4 if carried else 2) * per,
          "stage3_prefetch_bucket_size": 2 * per if carried else 0,
          "stage3_prefetch_mode": "carried" if carried else "off"}
    if fcm is not None:
        zc["low_bandwidth"] = dict(ZERO3_LOW_BANDWIDTH,
                                   fused_collective_matmul=fcm)
    return dict(BENCH_GPT2_CONFIG, train_micro_batch_size_per_gpu=micro,
                zero_optimization=zc, mesh={"data": ZERO3_WORLD})


def zero3_counts(cfg, carried):
    """What a rank's stage-3 step launches: the carried backward runs every
    layer's forward again (its two LayerNorms and its attention), as
    activation checkpointing does, and under activation checkpointing each
    layer's own recompute runs it once more (a carried rematted step runs
    each layer's forward three times)."""
    return step_counts(cfg, int(carried) + int(cfg.activation_checkpointing))


def zero3_whole_grads(engine):
    """The grads of the mean loss by parameter, whole: the ranks' pieces
    (each the sum over the ranks, reduce-scattered by the stream's
    gathers) put together, the leaves every rank holds whole summed here,
    all divided by W."""
    layout, w = engine._layout, engine.world_size
    grads = [g.float().cpu() for g in engine._flat_grads]
    out = {}
    for leaf in layout.leaves:
        pieces = [g[leaf.offset:leaf.offset + leaf.numel].view(
            leaf.piece_shape) for g in grads]
        whole = (torch.stack(pieces).sum(0) if leaf.dim is None
                 else torch.cat(pieces, dim=leaf.dim))
        out[leaf.name] = whole / w
    return out


def zero3_step(engine, ids):
    """One forward and backward; the loss, the grads whole, the launch
    counts and the stream's gathers / reduce-scatters."""
    stream = engine._zero3_stream
    stream.counts = {k: 0 for k in stream.counts}
    reset_launch_counts()
    loss = engine.forward(ids)
    engine.backward(loss)
    torch.cuda.synchronize()
    return (loss.item(), zero3_whole_grads(engine), launch_counts(),
            dict(stream.counts))


def phase_zero3_grads(state):
    """GPT-2 at full width, ZERO3_GRADS_LAYERS layers, ZERO3_WORLD ranks of
    one row each, dropout off: the loss and every grad at stage 3 in the
    `off` and `carried` plans against the port's fp32 run of the same rows
    (`fp32_reference`) (loss 2e-2, grads max|d| / max|ref| 5e-2, as the other _grads
    phases); off and carried bitwise equal on the card; then with dropout
    0.1, carried bitwise off (the recompute redraws the masks); launch
    counters a step's counts on every rank (carried: a rematted step's)."""
    cfg = gpt2_124m_train(num_layers=ZERO3_GRADS_LAYERS, embd_dropout=0.0,
                          attn_dropout=0.0, hidden_dropout=0.0)
    state = {k: v for k, v in state.items()
             if not k.startswith("h.") or int(k.split(".")[1])
             < ZERO3_GRADS_LAYERS}
    ids = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (ZERO3_WORLD, TRAIN_SEQ)))
    ref_loss, ref_grads, ref_seconds = fp32_reference(cfg, state, ids)
    out = {"fp32_reference_loss": ref_loss,
           "reference": "the port's plain versions in fp32 on the card",
           "reference_seconds": ref_seconds,
           "world": ZERO3_WORLD, "layers": ZERO3_GRADS_LAYERS,
           "loss_rel_tol": LOSS_REL_TOL, "grad_rel_tol": GRAD_REL_TOL}
    runs = {}
    for carried in (False, True):
        mode = "carried" if carried else "off"
        gc_cuda()
        engine = train_engine(cfg, state, zero3_config(cfg, carried, micro=1))
        check(engine._zero3_stream.last_plan.mode == mode,
              f"{mode}: plan {engine._zero3_stream.last_plan}")
        loss, grads, counts, wire = zero3_step(engine, ids)
        want = {k: ZERO3_WORLD * v
                for k, v in zero3_counts(cfg, carried).items()}
        check(counts == want, f"{mode}: launch counts {counts}, expected "
              f"{want}")
        check_aligned(f"zero3 {mode} forward + backward")
        loss_err = abs(loss - ref_loss) / abs(ref_loss)
        check(loss_err <= LOSS_REL_TOL, f"{mode}: loss vs fp32 "
              f"{loss_err}")
        errs = {n: rel_err(g, ref_grads[n]) for n, g in grads.items()}
        worst = max(errs, key=errs.get)
        check(errs[worst] <= GRAD_REL_TOL, f"{mode}: grad of {worst} vs "
              f"fp32 {errs[worst]}")
        runs[mode] = (loss, grads)
        out[mode] = {"loss": loss, "loss_rel_err": loss_err,
                     "worst_param": worst, "worst_grad_rel_err": errs[worst],
                     "median_grad_rel_err": float(np.median(list(
                         errs.values()))),
                     "launches_per_step": counts, "gathers_and_scatters": wire,
                     "plan": engine._zero3_stream.last_plan.__dict__}
        del engine
    same = runs["off"][0] == runs["carried"][0] and all(
        torch.equal(runs["off"][1][n], runs["carried"][1][n])
        for n in runs["off"][1])
    check(same, "off and carried differ on the card")
    dropped = {}
    cfg_drop = replace(cfg, embd_dropout=DROPOUT, attn_dropout=DROPOUT,
                       hidden_dropout=DROPOUT)
    for carried in (False, True):
        gc_cuda()
        engine = train_engine(cfg_drop, state,
                              zero3_config(cfg, carried, micro=1))
        loss, grads, _, _ = zero3_step(engine, ids)
        dropped[carried] = (loss, grads, [g.get_state()
                                          for g in engine._rngs])
        del engine
    same_drop = dropped[False][0] == dropped[True][0] and all(
        torch.equal(dropped[False][1][n], dropped[True][1][n])
        for n in dropped[False][1]) and all(
        torch.equal(a, b) for a, b in zip(dropped[False][2],
                                          dropped[True][2]))
    check(same_drop, "dropout 0.1: carried differs from off")
    out.update(off_carried_bitwise=True, dropout_carried_off_bitwise=True,
               dropout=DROPOUT, dropout_loss=dropped[True][0])
    return None, out


def held_bytes_zero3(engine):
    """What rank 0 holds at stage 3: its pieces of the fp32 parameters,
    of the grad buffer and of the optimizer state."""
    mib = lambda *ts: sum(t.numel() * t.element_size()  # noqa: E731
                          for t in ts) / 2 ** 20
    return {"params_mib": mib(engine._flat),
            "grad_buffer_mib": mib(engine._flat_grad),
            "optimizer_mib": mib(*engine.opt_state.values()),
            "estimate_memory_bytes": engine.estimate_memory()}


def zero3_wire_per_step(engine, ids):
    """One more step's gathers and reduce-scatters (group operations over
    every rank: the non-layer leaves' one, each layer group's, and the
    backward's gathers again)."""
    stream = engine._zero3_stream
    stream.counts = {k: 0 for k in stream.counts}
    loss = engine.forward(ids)
    engine.backward(loss)
    engine.step()
    torch.cuda.synchronize()
    return dict(stream.counts)


def timed_zero3(cfg, state, carried, fcm=None, keep_losses=False,
                iters=TRAIN_ITERS, snapshot=None):
    """One bench row timed as phase_train, with the stream's plan, the
    gathered bytes' high-water mark against the plan's bound (the
    compute-dtype width), and a step's gathers and reduce-scatters.
    `snapshot`: a dict that takes engine_state_bits after the warm-up
    steps (outside the timed ones)."""
    ds_config = zero3_config(cfg, carried, fcm)
    after_warmup = None
    if snapshot is not None:
        def after_warmup(engine):
            snapshot.update({k: v.clone() for k, v in
                             engine_state_bits(engine).items()})
    counts, summary, engine = timed_training(
        cfg, state, ds_config, TRAIN_WARMUP, iters,
        rank_step=zero3_counts(cfg, carried), keep_losses=keep_losses,
        after_warmup=after_warmup)
    stream = engine._zero3_stream
    plan = stream.last_plan
    check(plan.layers_per_step == 2 and plan.mode == (
        "carried" if carried else "off"), f"plan {plan}")
    check(stream.fcm == bool(fcm), f"fused_collective_matmul: {stream.fcm}")
    bound = plan.live_parameters * 2  # bf16 bytes a rank
    check(0 < stream.peak_live_bytes <= bound,
          f"gathered high-water mark {stream.peak_live_bytes} B a rank, "
          f"the plan's bound {bound} B")
    ids = bench_ids(cfg, ZERO3_MICRO * ZERO3_WORLD)
    summary.update(
        plan=plan.__dict__, live_parameters=plan.live_parameters,
        gathered_peak_bytes_a_rank=stream.peak_live_bytes,
        gathered_bound_bytes_a_rank=bound,
        held_bytes_rank0=held_bytes_zero3(engine),
        wire_ops_per_step=zero3_wire_per_step(engine, ids))
    return counts, summary


def phase_train_zero3(state):
    """bench.py::bench_gpt2_zero3_stream and _carried exactly (GPT-2 124M,
    bf16, AdamW lr 6e-4 wd 0.1, global batch 8 x 1024 over 4 ranks on the
    visible cards, groups of 2 layers), each timed as phase_train, in
    turns; beside them what rank 0 holds at ZeRO-2 on the same mesh
    (train_dp's engine, not stepped).  Returns the launch counts and, for
    train_zero3_remat, each plan's losses, its state after the warm-up
    and its summary."""
    cfg = gpt2_124m_train()
    out, counts, kept = {}, [], {}
    for carried in (False, True):
        mode = "carried" if carried else "off"
        gc_cuda()
        bits = {}
        c, out[mode] = timed_zero3(cfg, state, carried, keep_losses=True,
                                   snapshot=bits)
        kept[mode] = {"losses": out[mode].pop("losses"), "bits": bits,
                      "summary": out[mode]}
        counts.append(c)
    gc_cuda()
    stage2 = train_engine(cfg, state, dp_config(ZERO3_MICRO, 2,
                                                ZERO3_WORLD))
    out["zero2_held_bytes_rank0"] = held_bytes(stage2)
    del stage2
    return (add_counts(*counts), kept), out


def phase_train_zero3_remat(state, plain):
    """train_zero3's engines (zero3_config) with
    GPT2Config(activation_checkpointing=True): each layer of the stream
    recomputed in the backward (stage3_streaming `_RematLayer`), in the
    `off` and `carried` plans, timed over TRAIN_WARMUP + ZERO3_REMAT_ITERS
    steps.  Each plan bitwise its own run in train_zero3 (`plain`): the
    losses of these steps, and after the warm-up every rank's pieces, Adam
    state, scaler and generator; tokens/s and peak GiB beside train_zero3's;
    the gathered high-water mark within the plan's bound; A, B, D and E a
    rank-step as zero3_counts predicts (each layer's forward twice a step
    in `off`, three times in `carried`)."""
    cfg = gpt2_124m_train(activation_checkpointing=True)
    out, counts = {}, []
    for carried in (False, True):
        mode = "carried" if carried else "off"
        gc_cuda()
        bits = {}
        c, summary = timed_zero3(cfg, state, carried, keep_losses=True,
                                 iters=ZERO3_REMAT_ITERS, snapshot=bits)
        counts.append(c)
        ref = plain[mode]
        losses = summary.pop("losses")
        check(losses == ref["losses"][:len(losses)],
              f"{mode}: rematted losses {losses} differ from "
              f"{ref['losses'][:len(losses)]}")
        differ = [k for k in ref["bits"] if not torch.equal(ref["bits"][k],
                                                            bits[k])]
        check(not differ, f"{mode}: rematted state after the warm-up "
              f"differs in {differ[:6]}")
        predicted = zero3_counts(cfg, carried)
        base = ref["summary"]
        out[mode] = {
            "remat": summary, "losses_bitwise_steps": len(losses),
            "state_bitwise_after_steps": TRAIN_WARMUP,
            "compared": sorted(bits), "predicted_launches_a_rank_step":
            predicted, "no_remat_launches_a_rank_step": zero3_counts(
                replace(cfg, activation_checkpointing=False), carried),
            "no_remat_tokens_per_s": base["tokens_per_s"],
            "no_remat_peak_memory_gib": base["peak_memory_gib"],
            "tokens_per_s_vs_no_remat": summary["tokens_per_s"]
            / base["tokens_per_s"],
            "peak_memory_vs_no_remat": summary["peak_memory_gib"]
            / base["peak_memory_gib"]}
    return add_counts(*counts), out


def phase_train_zero3_fcm(state):
    """bench.py::bench_gpt2_zero3_stream_fcm's engines exactly: the carried
    row with qwZ 8 / qgZ 8, the modular transports then the fused ones,
    each timed over TRAIN_WARMUP + ZERO3_FCM_ITERS steps; the two loss
    trajectories bitwise equal (the port's transports move the modular
    ops' values), both rates and fcm_speedup."""
    cfg = gpt2_124m_train()
    runs, counts = {}, []
    for fcm in (False, True):
        gc_cuda()
        c, runs[fcm] = timed_zero3(cfg, state, True, fcm, keep_losses=True,
                                   iters=ZERO3_FCM_ITERS)
        counts.append(c)
    check(runs[False]["losses"] == runs[True]["losses"],
          "the fused transports' trajectory differs from the modular one")
    out = {"modular": runs[False], "fused": runs[True],
           "trajectories_bitwise": True,
           "fcm_speedup": runs[True]["tokens_per_s"]
           / runs[False]["tokens_per_s"]}
    for run in (runs[False], runs[True]):
        del run["losses"]
    return add_counts(*counts), out


def sharded_config(ds_config):
    """`ds_config` saving the sharded layout atomically (resilience's
    atomic checkpoints and verified loads, its defaults)."""
    return dict(ds_config, checkpoint={"sharded": True},
                resilience={"enabled": True, "atomic_checkpoints": True})


def phase_checkpoint_zero3(state):
    """The carried row at 4 ranks saved after CKPT_STEPS steps, then loaded
    twice: at stage 3 and 4 ranks (into an engine of other weights), whose
    next ZERO3_CKPT_RESUMED steps are bitwise the uninterrupted run's
    (losses, every rank's pieces and Adam state, the generators), and at
    stage 2 on one rank, which holds the saved masters and optimizer state
    bitwise and whose next loss (other dropout draws: the generators are
    restored only at the saved world) is within LOSS_REL_TOL of it.  The
    stage-3 engine that resumes saves the sharded layout (sharded_config)
    right after its load, the saved state bitwise; checkpoint_sharded
    loads that and takes what this phase kept (the engines, the
    uninterrupted run, the saved state)."""
    cfg = gpt2_124m_train()
    ids = bench_ids(cfg, ZERO3_MICRO * ZERO3_WORLD)
    ds_config = zero3_config(cfg, True)
    other = init_state(cfg, seed=1)
    sharded_path = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=CKPT_DIR)
    atexit.register(shutil.rmtree, sharded_path, True)
    with checkpoint_dir() as path:
        gc_cuda()
        engine = train_engine(cfg, state, ds_config)
        reset_launch_counts()
        loss_values(engine, ids, CKPT_STEPS)
        save_s, nbytes, save_split = timed_save(engine, path, "zero3")
        saved = {"module": engine.module_state_dict(),
                 **{k: torch.from_numpy(engine._gathered(k).copy())
                    for k in ("mu", "nu")}}
        cont = loss_values(engine, ids, ZERO3_CKPT_RESUMED)
        cont_bits = engine_state_bits(engine)
        counts = launch_counts()
        del engine
        gc_cuda()
        again = train_engine(cfg, other, sharded_config(ds_config))
        load_s, load_split = timed_load(again, path)
        sharded = timed_save(again, sharded_path, "zero3")
        resumed = loss_values(again, ids, ZERO3_CKPT_RESUMED)
        bits = engine_state_bits(again)
        check(resumed == cont, f"stage-3 resume {resumed} vs {cont}")
        differ = [k for k in cont_bits if not torch.equal(cont_bits[k],
                                                          bits[k])]
        check(not differ, f"stage-3 resume differs in {differ}")
        gc_cuda()
        one = train_engine(cfg, other, BENCH_GPT2_CONFIG)
        one.load_checkpoint(path)
        whole = one.module_state_dict()
        diff = [n for n in saved["module"]
                if not torch.equal(whole[n].cpu(), saved["module"][n])]
        check(not diff, f"stage-2 load: masters differ in {diff[:4]}")
        for key in ("mu", "nu"):
            got = torch.from_numpy(one._gathered(key)[:one.num_params])
            check(torch.equal(got, saved[key]),
                  f"stage-2 load: {key} differs")
        next_loss = loss_values(one, ids, 1)[0]
        err = abs(next_loss - cont[0]) / abs(cont[0])
        check(err <= LOSS_REL_TOL, f"stage-2 resume loss {next_loss} vs "
              f"{cont[0]}: {err}")
    consolidated = io_summary(save_s, load_s, nbytes, save_split,
                              load_split)
    kept = {"path": sharded_path, "save": sharded, "engines": (again, one),
            "ids": ids, "cont": cont, "cont_bits": cont_bits, "saved": saved,
            "consolidated": consolidated}
    return (counts, kept), {
        "steps_before_save": CKPT_STEPS, "resumed_steps": ZERO3_CKPT_RESUMED,
        "stage3_resume_bitwise": True, "compared": sorted(cont_bits),
        "stage2_one_rank_masters_and_adam_bitwise": True,
        "stage2_next_loss": next_loss, "stage3_next_loss": cont[0],
        "stage2_loss_rel_err": err, "loss_rel_tol": LOSS_REL_TOL,
        **consolidated}


def phase_checkpoint_sharded(kept):
    """checkpoint_zero3's run in the sharded layout (the carried row at 4
    ranks of one card, `checkpoint.sharded: true`, atomic checkpoints):
    the save checkpoint_zero3's resuming engine wrote right after its
    load (the saved state), the files it wrote and their manifest; loaded
    into that engine (then at other weights, two steps on), verified, its
    next ZERO3_CKPT_RESUMED steps bitwise the uninterrupted run (losses,
    every rank's pieces and Adam state, the generators); loaded at stage 2
    on one rank (the resize) with the masters and Adam state bitwise the
    saved ones; consolidate_sharded_to_fp32 equal to the masters.  Save and
    load seconds, bytes and GB/s beside the consolidated layout's."""
    from deepspeed_tpu_torch.runtime import sharded_checkpoint as sc
    from deepspeed_tpu_torch.runtime.resilience import verify_manifest
    path, consolidated = kept["path"], kept["consolidated"]
    try:
        (again, one), kept["engines"] = kept["engines"], None
        save_s, nbytes, save_split = kept["save"]
        tag_dir = os.path.join(path, "zero3")
        files = {name: os.path.getsize(os.path.join(tag_dir, name))
                 for name in sorted(os.listdir(tag_dir))}
        check(sorted(files) == [
            "ds_meta.json", "manifest.json", "model_index.json",
            "model_shards_p00000.npz", "optim_index.json",
            "optim_shards_p00000.npz"], f"sharded files {sorted(files)}")
        check(not verify_manifest(tag_dir), "the manifest does not verify")
        check(not [d for d in os.listdir(path) if ".tmp." in d],
              "a staging directory was left")
        gc_cuda()
        load_s, load_split = timed_load(again, path)
        reset_launch_counts()
        resumed = loss_values(again, kept["ids"], ZERO3_CKPT_RESUMED)
        torch.cuda.synchronize()
        counts = launch_counts()
        want = {k: ZERO3_WORLD * ZERO3_CKPT_RESUMED * v for k, v in
                zero3_counts(gpt2_124m_train(), True).items()}
        check(counts == want, f"launch counts {counts}, expected {want}")
        bits = engine_state_bits(again)
        check(resumed == kept["cont"],
              f"sharded resume {resumed} vs {kept['cont']}")
        differ = [k for k in kept["cont_bits"]
                  if not torch.equal(kept["cont_bits"][k], bits[k])]
        check(not differ, f"sharded resume differs in {differ}")
        del again
        gc_cuda()
        saved = kept["saved"]
        t0 = time.perf_counter()
        one.load_checkpoint(path)
        torch.cuda.synchronize()
        resize_s = time.perf_counter() - t0
        whole = one.module_state_dict()
        diff = [n for n in saved["module"]
                if not torch.equal(whole[n].cpu(), saved["module"][n])]
        check(not diff, f"stage-2 sharded load: masters differ in {diff[:4]}")
        for key in ("mu", "nu"):
            got = torch.from_numpy(one._gathered(key)[:one.num_params])
            check(torch.equal(got, saved[key]),
                  f"stage-2 sharded load: {key} differs")
        del one
        t0 = time.perf_counter()
        fp32 = sc.consolidate_sharded_to_fp32(tag_dir)
        consolidate_s = time.perf_counter() - t0
        masters = sc.leaf_paths({"module": gpt2_params_to_jax(
            saved["module"], gpt2_124m_train())})
        check(sorted(fp32) == sorted(masters),
              "consolidate_sharded_to_fp32: other leaves")
        unequal = [k for k in masters if not np.array_equal(fp32[k],
                                                            masters[k])]
        check(not unequal, f"consolidated leaves differ: {unequal[:4]}")
    finally:
        kept.clear()
        shutil.rmtree(path, ignore_errors=True)
    sharded = io_summary(save_s, load_s, nbytes, save_split, load_split)
    return counts, {
        "files_bytes": files, "manifest_verified": True,
        "resumed_steps": ZERO3_CKPT_RESUMED, "stage3_resume_bitwise": True,
        "compared": sorted(bits),
        "stage2_one_rank_masters_and_adam_bitwise": True,
        "stage2_load_seconds": resize_s,
        "consolidated_fp32_equals_masters": True,
        "consolidate_seconds": consolidate_s, "sharded": sharded,
        "consolidated": consolidated,
        "save_seconds_vs_consolidated": save_s
        / consolidated["save_seconds"],
        "load_seconds_vs_consolidated": load_s
        / consolidated["load_seconds"]}


def phase_train_zero3_fused(state):
    """graphed_vs_eager at stage 3 on one card, gas 2, dropout 0.1, in the
    `off` and `carried` plans, and the `off` plan with
    GPT2Config(activation_checkpointing=True) (the window's graph holds
    each `_RematLayer`'s recompute, its masks redrawn from the window's
    registered recompute generators; a rank-step launches A 4L + 1 = 49
    and B 2L = 24): the graphed window replays every rank's streamed
    layers and is bitwise the eager one (losses, every rank's pieces and
    Adam state, the generators)."""
    check(torch.cuda.device_count() == 1,
          "train_zero3_fused puts every rank on one card")
    cfg = gpt2_124m_train()
    remat = replace(cfg, activation_checkpointing=True)
    rematted = zero3_counts(remat, False)
    check(rematted["layer_norm_fwd"] == 4 * cfg.num_layers + 1
          and rematted["flash_attention_fwd"] == 2 * cfg.num_layers,
          f"a rematted off rank-step's counts {rematted}")
    out, traced, counts = {}, {}, []
    for mode, model, carried in (("off", cfg, False),
                                 ("carried", cfg, True),
                                 ("off_remat", remat, False)):
        out[mode] = graphed_vs_eager(
            model, state, dict(zero3_config(model, carried),
                               gradient_accumulation_steps=FUSED_GRADS_GAS),
            FUSED_GRADS_STEPS, f"ZeRO-3 {mode}",
            rank_step=zero3_counts(model, carried))
        for k, v in out[mode]["replay_launches_traced"].items():
            traced[k] = traced.get(k, 0) + v
        # the counters the check held: every eager window, then the fused
        # run's eager first window and its capture
        counts.append({k: (FUSED_GRADS_STEPS + 2) * v for k, v in
                       out[mode]["launches_per_window"].items()})
    return (add_counts(*counts), traced), dict(out, world=ZERO3_WORLD,
                                               dropout=DROPOUT)


def phase_tiled_linear():
    """TiledLinear.from_dense at c_fc's width on the card: x [TILED_ROWS,
    768] through a [768, 3072] weight and a bias, all bf16, in
    TILED_SPLITS (4, 4) tiles, forward and backward (each input tile's
    step recomputed in the backward), against the dense x @ W + b in plain
    PyTorch on the same tensors computed in fp32 (TF32 off): the output
    within LOSS_REL_TOL and the grads of x, W and b within GRAD_REL_TOL
    (max|d| / max|ref|), the bf16 dense product's errors beside them;
    the peak device memory and the device ms (CUDA events) of a forward
    and backward of each."""
    from deepspeed_tpu_torch.runtime.zero import TiledLinear
    k, n = FCM_MATRICES["c_fc"]
    gen = torch.Generator().manual_seed(0)
    on_card = lambda *shape, scale=1.0: (  # noqa: E731
        torch.randn(*shape, generator=gen) * scale).to("cuda",
                                                        torch.bfloat16)
    x, w, b = on_card(TILED_ROWS, k), on_card(k, n, scale=0.02), \
        on_card(n, scale=0.02)
    g = on_card(TILED_ROWS, n)
    ins, outs = TILED_SPLITS

    lin = TiledLinear.from_dense(w, b, ins, outs)

    def tiled():
        lin.zero_grad(set_to_none=True)
        xt = x.detach().requires_grad_()
        y = lin(xt)
        y.backward(g)
        dw = lin.w.grad.permute(0, 2, 1, 3).reshape(k, n)
        return y, xt.grad, dw, lin.b.grad.reshape(n)

    def dense():
        xd, wd, bd = (t.detach().requires_grad_() for t in (x, w, b))
        y = xd @ wd + bd
        y.backward(g)
        return y, xd.grad, wd.grad, bd.grad

    with plain_versions():
        xf, wf, gf = x.float(), w.float(), g.float()
        ref = (xf @ wf + b.float(), gf @ wf.T, xf.T @ gf, gf.sum(0))
    names = ("out", "dx", "dw", "db")
    out, mem, ms = {}, {}, {}
    for what, fn in (("tiled", tiled), ("dense_bf16", dense)):
        gc_cuda()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = fn()
        torch.cuda.synchronize()
        mem[what] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        out[what] = {name: rel_err(t.float(), r)
                     for name, t, r in zip(names, got, ref)}
        check(all(bool(torch.isfinite(t).all()) for t in got),
              f"{what}: non-finite values")
        del got
        ms[what] = time_ms(fn, runs=5)
    errs = out["tiled"]
    check(errs["out"] <= LOSS_REL_TOL, f"tiled output vs fp32: {errs}")
    worst = max(("dx", "dw", "db"), key=errs.get)
    check(errs[worst] <= GRAD_REL_TOL, f"tiled grads vs fp32: {errs}")
    return None, {
        "x": [TILED_ROWS, k], "w": [k, n], "splits": list(TILED_SPLITS),
        "dtype": "bfloat16", "rel_err_vs_fp32": out,
        "out_rel_tol": LOSS_REL_TOL, "grad_rel_tol": GRAD_REL_TOL,
        "peak_mib_forward_backward": mem, "ms_forward_backward": ms,
        "peak_vs_dense": mem["tiled"] / mem["dense_bf16"]}


DP_PARITY = ("layer_norm_kernels", "layer_norm_fwd", "layer_norm_bwd",
             "flash_attention_fwd", "flash_attention_fwd_dropout",
             "flash_attention_bwd")


# --------------------------------------------------------------------- #
# phases 36-40: the offload tier (ZeRO-Offload's host and NVMe Adam on the
# stage-2 engine, ZeRO-Infinity's layer streaming)
# --------------------------------------------------------------------- #
OFFLOAD_GRADS_STEPS = 3  # offload_grads: steps a tier; then 2 resumed
OFFLOAD_RESUMED = 2
# offload_grads / infinity_grads: each leaf's update against the
# reference's (hold_master).  On an H100 the sound tiers' worst leaf read
# 8.1e-3 (3 steps) and 4.3e-3 (2 steps), a skipped last step at least 0.27
# and 0.44: the limit sits between, 6x and 5x from each
UPDATE_REL_TOL = 0.05
# train_offload's timed steps at gas 4: each takes four micro-batches, so
# these 10 see more tokens than gas 1's 30
OFFLOAD_GAS4_ITERS = 10
OFFLOAD_NVME_WARMUP, OFFLOAD_NVME_ITERS = 2, 10
# bench.py::bench_infinity (bench.py:1455-1503): batch 4 x 1024, AdamW lr
# 6e-4, bf16, stage 3, parameters and optimizer state on NVMe; with
# bench_infinity_stream's buffer_count 2 and prefetch_depth 2 against 0
INF_MICRO = 4
INF_WARMUP, INF_ITERS = 2, 4
INF_ROUNDS = 2  # timed turns of one step: depth 2, 0, 0, 2
INF_GRADS_STEPS = 2


def offload_config(gas=1, device="cpu", nvme_path=None, micro=TRAIN_BATCH):
    """bench.py::bench_offload's config (bench.py:1380-1410): bench_gpt2's
    with offload_optimizer on `device`, at `gas`."""
    oo = {"device": device}
    if nvme_path is not None:
        oo["nvme_path"] = nvme_path
    return dict(BENCH_GPT2_CONFIG, train_micro_batch_size_per_gpu=micro,
                gradient_accumulation_steps=gas,
                zero_optimization={"stage": 2, "offload_optimizer": oo})


def infinity_config(nvme_path, params="nvme", optimizer="nvme", depth=2,
                    buffer_count=2):
    """bench.py::bench_infinity's config, the swap files under nvme_path;
    `params` / `optimizer` the offload devices."""
    zo = {"stage": 3,
          "offload_param": {"device": params, "nvme_path": nvme_path,
                            "buffer_count": buffer_count,
                            "prefetch_depth": depth}}
    if optimizer is not None:
        zo["offload_optimizer"] = {"device": optimizer,
                                   "nvme_path": nvme_path}
    return {"train_micro_batch_size_per_gpu": INF_MICRO,
            "optimizer": {"type": "AdamW", "params": {"lr": 6e-4}},
            "bf16": {"enabled": True}, "zero_optimization": zo,
            "steps_per_print": 10 ** 9, "mesh": {"data": 1}}


def fs_type(path):
    """The file system type of the mount that holds `path` (/proc/mounts)."""
    real, best, kind = os.path.realpath(path), "", None
    with open("/proc/mounts") as f:
        for line in f:
            parts = line.split()
            mnt = parts[1]
            if (real == mnt or real.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) >= len(best):
                best, kind = mnt, parts[2]
    return kind


def run_steps(engine, ids, steps):
    """`steps` forward / backward / step calls on one batch: the losses."""
    out = []
    for _ in range(steps):
        loss = engine.forward(ids)
        engine.backward(loss)
        engine.step()
        out.append(loss.item())
    return out


def tier_bits(engine):
    """Host copies of the offload tier's flat buffers (this process's
    part: master, exp_avg, exp_avg_sq) and its step count."""
    tier = engine.optimizer
    return ({k: v.detach().to("cpu", copy=True)
             for k, v in tier.local_state().items()}, tier.step_count())


def same_tier(a, b):
    """Whether two tier_bits() hold the same bits and step count."""
    return a[1] == b[1] and all(torch.equal(a[0][k], b[0][k]) for k in a[0])


def update_errors(tree, ref, start, hidden):
    """Two JAX GPT-2 trees that left `start` compared leaf by leaf: how far
    each leaf's update is from the reference's, ||tree - ref|| /
    ||ref - start||.  A leaf that was not updated reads 1.  The key third
    of attn_qkvb is left out, as the CPU tests leave it out: its true
    gradient is zero (softmax is shift-invariant along the keys), so its
    grads are only rounding noise."""
    from deepspeed_tpu_torch.utils.tree import tree_flatten

    def cut(t):
        t = {k: (dict(v) if isinstance(v, dict) else v) for k, v in t.items()}
        b = np.asarray(t["h"]["attn_qkvb"])
        t["h"]["attn_qkvb"] = np.concatenate(
            [b[:, :hidden], b[:, 2 * hidden:]], axis=1)
        return t

    leaves = [tree_flatten(cut(t))[0] for t in (tree, ref, start)]
    errs = {}
    for name, o, r, w0 in zip(leaf_paths(ref), *leaves):
        o, r, w0 = (np.asarray(x, np.float64) for x in (o, r, w0))
        errs[name] = float(np.linalg.norm(o - r) / np.linalg.norm(r - w0))
    return errs


def hold_master(tree, ref, start, short, hidden, what):
    """Every leaf's update held against the reference's at UPDATE_REL_TOL
    (update_errors), and the limit against a skipped step: `short`, the
    reference's own tree one step before `ref`, is what a tier that
    skipped the last step would hold, and must read above the limit in
    every leaf.  Returns the summary's fields."""
    errs = update_errors(tree, ref, start, hidden)
    skipped = update_errors(short, ref, start, hidden)
    worst = max(errs, key=errs.get)
    least = min(skipped, key=skipped.get)
    check(skipped[least] > UPDATE_REL_TOL,
          f"{what}: a skipped step reads {skipped[least]} at {least}, "
          f"inside the limit {UPDATE_REL_TOL}")
    check(errs[worst] <= UPDATE_REL_TOL,
          f"{what}: the updates vs the reference's {errs}")
    return {"worst_update_leaf": worst,
            "worst_update_rel_err": errs[worst], "update_rel_err": errs,
            "skipped_step_least_leaf": least,
            "skipped_step_least_rel_err": skipped[least]}


def leaf_paths(tree, prefix=""):
    """The dotted paths of a nested dict's leaves, in JAX order."""
    out = []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out += leaf_paths(tree[k], f"{prefix}{k}.")
        else:
            out.append(prefix + k)
    return out




def phase_offload_grads(state):
    """bench_offload's model with dropout off, one row of 1024 tokens, 3
    steps: the host tier (offload_optimizer cpu) against the device-
    resident stage-2 engine from the same weights (losses 2e-2, each leaf
    of the fp32 master's update against the engine's: hold_master); the NVMe
    tier's trajectory, device parameters, master and moments bitwise the
    host tier's; a save after the 3 steps resumed in a new engine bitwise
    for 2 more steps.  The launch counters exact."""
    from deepspeed_tpu_torch.ops.adam import num_threads
    cfg = gpt2_124m_train(embd_dropout=0.0, attn_dropout=0.0,
                          hidden_dropout=0.0)
    ids = torch.from_numpy(bench_ids(cfg, 1))
    steps = OFFLOAD_GRADS_STEPS
    gc_cuda()
    ref = train_engine(cfg, state, dict(BENCH_GPT2_CONFIG,
                                        train_micro_batch_size_per_gpu=1))
    ref_losses = run_steps(ref, ids, steps - 1)
    short = gpt2_params_to_jax(dict(ref.module.named_parameters()), cfg)
    ref_losses += run_steps(ref, ids, 1)
    ref_tree = gpt2_params_to_jax(dict(ref.module.named_parameters()), cfg)
    del ref
    gc_cuda()
    reset_launch_counts()
    cpu = train_engine(cfg, state, offload_config(micro=1))
    losses = run_steps(cpu, ids, steps)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {k: steps * v for k, v in step_counts(cfg).items()}
    check(counts == want, f"launch counts {counts}, expected {want}")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    check(loss_err <= LOSS_REL_TOL, f"losses {losses} vs {ref_losses}")
    out = {"losses": losses, "device_engine_losses": ref_losses,
           "loss_rel_err": loss_err,
           **hold_master(cpu.optimizer.master_params, ref_tree,
                         gpt2_params_to_jax(state, cfg), short,
                         cfg.hidden_size, "cpu tier"),
           "native_adam_threads": num_threads(),
           "launches_per_step": step_counts(cfg)}
    with checkpoint_dir() as swap:
        gc_cuda()
        nvme = train_engine(cfg, state, offload_config(
            micro=1, device="nvme", nvme_path=swap))
        nvme_losses = run_steps(nvme, ids, steps)
        check(nvme_losses == losses,
              f"nvme losses {nvme_losses} vs cpu {losses}")
        check(same_tier(tier_bits(nvme), tier_bits(cpu)),
              "the nvme tier's master / moments differ from the cpu tier's")
        check(torch.equal(nvme._flats[0], cpu._flats[0]),
              "the nvme engine's device parameters differ")
        from deepspeed_tpu_torch.runtime.swap_tensor.aio_handle import (
            io_uring_available)
        out.update(aio_backend=nvme.optimizer.aio_backend,
                   io_uring_available=io_uring_available(),
                   swap_fs=fs_type(swap), nvme_bitwise=True,
                   nvme_sweep=nvme.optimizer.last_sweep_stats)
        del nvme
    with checkpoint_dir() as ckpt:
        cpu.save_checkpoint(ckpt, tag="resume")
        cont = run_steps(cpu, ids, OFFLOAD_RESUMED)
        gc_cuda()
        fresh = train_engine(cfg, state, offload_config(micro=1))
        fresh.load_checkpoint(ckpt, tag="resume")
        resumed = run_steps(fresh, ids, OFFLOAD_RESUMED)
        check(resumed == cont, f"resumed {resumed} vs {cont}")
        check(same_tier(tier_bits(fresh), tier_bits(cpu))
              and torch.equal(fresh._flats[0], cpu._flats[0]),
              "the resumed engine's state differs")
        out.update(resumed_losses=resumed, resume_bitwise=True)
    del cpu, fresh
    gc_cuda()
    return None, out


def timed_offload(cfg, state, ds_config, warmup, iters, train_summary,
                  after_step=None, before_profile=None, after_warmup=None):
    """One offload row timed as phase_train (warmup, then `iters`
    train_batch calls on the host clock; each reads its loss, as the
    host tier synchronises a step anyway): tokens/s beside train's, the
    step split (device ms of a profiled step, the grads' copy to the host,
    the host tier's step, the parameters' copy back), the card's peak GiB
    beside train's, the pinned host bytes, A/B/D/E a step (train's
    exactly, on every rank of the engine's mesh).  The batch is
    bench_gpt2's, micro-batch x world rows.  `after_warmup(engine)` runs
    after the warm-up steps, `after_step(engine)` after each timed step,
    both outside the clock; `before_profile(engine)` after the timed
    steps, before the profiled one.  Returns the counts,
    the summary (every step's loss under "losses") and the engine."""
    gas = ds_config["gradient_accumulation_steps"]
    gc_cuda()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    engine = train_engine(cfg, state, ds_config)
    check(engine._fused is None and engine._offload is not None,
          "the offload engine runs the modular loop")
    batch = ds_config["train_micro_batch_size_per_gpu"] * engine.world_size
    batches = repeat_batch(bench_ids(cfg, batch))
    reset_launch_counts()
    losses = [engine.train_batch(batches) for _ in range(warmup)]
    if after_warmup is not None:
        after_warmup(engine)
    seconds = 0.0
    for _ in range(iters):
        t0 = time.perf_counter()
        losses.append(engine.train_batch(batches))
        seconds += time.perf_counter() - t0
        if after_step is not None:
            after_step(engine)
    counts = launch_counts()
    ranks = len(engine.local_ranks)
    per_step = {k: gas * ranks * v for k, v in step_counts(cfg).items()}
    check(per_step == {k: gas * ranks * v for k, v in
                       train_summary["launches_per_step"].items()},
          f"a step's launches {per_step}, train's x {gas} x {ranks} ranks")
    check(counts == {k: (warmup + iters) * v for k, v in per_step.items()},
          f"launch counts {counts} over {warmup + iters} steps, a step "
          f"{per_step}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"losses {losses}")
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    if before_profile is not None:
        before_profile(engine)
    wall_ms, busy_ms, _, _ = _profile_once(lambda: engine.train_batch(
        batches))
    split = engine.offload_split()
    rate = iters * gas * batch * TRAIN_SEQ / seconds
    return counts, {
        "losses": losses, "data_parallel_world": engine.world_size,
        "gas": gas, "batch": [batch, TRAIN_SEQ],
        "tokens_per_s": rate, "train_tokens_per_s":
            train_summary["tokens_per_s"],
        "vs_train": rate / train_summary["tokens_per_s"],
        "ms_per_step": seconds / iters * 1e3,
        "mfu": rate * cfg.flops_per_token() / PEAK_OPS_PER_S[torch.bfloat16],
        "first_loss": losses[0], "final_loss": losses[-1],
        "steps": warmup + iters, "timed_steps": iters,
        "profiled_step_wall_ms": wall_ms,
        "profiled_step_device_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms, "step_split_ms": split,
        "peak_memory_gib": peak,
        "train_peak_memory_gib": train_summary["peak_memory_gib"],
        "pinned_host_bytes": engine._offload.pinned_bytes,
        "launches_per_step": per_step}, engine


def phase_train_offload(state, train_summary):
    """bench.py::bench_offload at gas 1 (DS_BENCH_GAS), timed as train
    (3 + 30 steps), and at gas 4 over 3 + OFFLOAD_GAS4_ITERS steps."""
    cfg = gpt2_124m_train()
    out, counts = {}, []
    for gas, iters in ((1, TRAIN_ITERS), (4, OFFLOAD_GAS4_ITERS)):
        c, out[f"gas{gas}"], engine = timed_offload(
            cfg, state, offload_config(gas), TRAIN_WARMUP, iters,
            train_summary)
        del out[f"gas{gas}"]["losses"]
        counts.append(c)
        del engine
    gc_cuda()
    return (add_counts(*counts), out["gas1"]["tokens_per_s"]), out


def phase_train_offload_nvme(state, train_summary):
    """bench_offload's row with the optimizer tier in files
    (offload_optimizer nvme), 2 + 10 steps: tokens/s, the sweep's read and
    write GB/s (bytes over the sweep's wall time) and its exposed I/O
    seconds (the host's waits for reads and write-backs), the medians of
    the timed steps."""
    cfg = gpt2_124m_train()
    sweeps = []
    with checkpoint_dir() as swap:
        counts, out, engine = timed_offload(
            cfg, state, offload_config(device="nvme", nvme_path=swap),
            OFFLOAD_NVME_WARMUP, OFFLOAD_NVME_ITERS, train_summary,
            lambda e: sweeps.append(dict(e.optimizer.last_sweep_stats)))
        del out["losses"]
        med = lambda f: float(np.median([f(s) for s in sweeps]))  # noqa
        out.update(
            aio_backend=engine.optimizer.aio_backend, swap_fs=fs_type(swap),
            sweep_wall_s=med(lambda s: s["wall_s"]),
            read_gbps=med(lambda s: s["bytes_read"] / s["wall_s"] / 1e9),
            write_gbps=med(lambda s: s["bytes_written"] / s["wall_s"] / 1e9),
            exposed_io_s=med(lambda s: s["read_wait_s"] + s["write_wait_s"]),
            exposed_read_s=med(lambda s: s["read_wait_s"]),
            exposed_write_s=med(lambda s: s["write_wait_s"]),
            host_adam_s=med(lambda s: s["adam_s"]),
            bytes_read_a_step=sweeps[-1]["bytes_read"],
            bytes_written_a_step=sweeps[-1]["bytes_written"])
        del engine
    gc_cuda()
    return counts, out


def infinity_counts(cfg):
    """A streamed step's launches: the forward's, then each layer's forward
    again in the recompute (a rematted step's)."""
    return step_counts(replace(cfg, activation_checkpointing=True))


def infinity_run(cfg, state, ds_config, ids, steps):
    """(losses, master tree, engine) of `steps` streamed steps, the launch
    counters exact (a streamed step's on every rank) and at most two
    groups on the card."""
    gc_cuda()
    engine = train_engine(cfg, state, ds_config)
    check(type(engine).__name__ == "ZeroInfinityEngine",
          f"initialize returned {type(engine).__name__}")
    reset_launch_counts()
    losses = run_steps(engine, ids, steps)
    torch.cuda.synchronize()
    counts = launch_counts()
    ranks = len(engine.local_ranks)
    want = {k: steps * ranks * v for k, v in infinity_counts(cfg).items()}
    check(counts == want, f"launch counts {counts}, expected {want}")
    check(engine.max_live_param_groups <= 2,
          f"{engine.max_live_param_groups} groups on the card")
    return losses, engine.optimizer.master_params, engine


def phase_infinity_grads(state):
    """bench_infinity's model (4 x 1024, bf16, AdamW lr 6e-4), dropout off,
    2 steps: the streaming engine with its parameters on the host and with
    parameters and optimizer on NVMe against the stage-2 device engine
    with the host tier (losses 2e-2, each leaf of the master's update
    against the engine's: hold_master).  The launch counters exact: a
    rematted step's.  (Prefetch depth 2 against 0 with dropout is held
    bitwise in train_infinity, whose two engines take the same steps.)"""
    cfg = gpt2_124m_train(embd_dropout=0.0, attn_dropout=0.0,
                          hidden_dropout=0.0)
    ids = torch.from_numpy(bench_ids(cfg, INF_MICRO))
    steps = INF_GRADS_STEPS
    gc_cuda()
    ref = train_engine(cfg, state, dict(
        offload_config(micro=INF_MICRO),
        optimizer={"type": "AdamW", "params": {"lr": 6e-4}}))
    ref_losses = run_steps(ref, ids, steps - 1)
    short = ref.optimizer.master_params
    ref_losses += run_steps(ref, ids, 1)
    ref_master = ref.optimizer.master_params
    del ref
    start = gpt2_params_to_jax(state, cfg)
    out = {"device_engine_losses": ref_losses,
           "launches_per_step": infinity_counts(cfg)}
    with checkpoint_dir() as swap:
        for params, opt in (("cpu", "cpu"), ("nvme", "nvme")):
            losses, master, engine = infinity_run(
                cfg, state, infinity_config(swap, params, opt), ids, steps)
            err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
            check(err <= LOSS_REL_TOL, f"{params}: losses {losses} ({err})")
            out[f"params_{params}"] = {
                "losses": losses, "loss_rel_err": err,
                **hold_master(master, ref_master, start, short,
                              cfg.hidden_size, params),
                "max_live_param_groups": engine.max_live_param_groups}
            del engine
    gc_cuda()
    return None, out


def swap_summary(stats):
    """A streamed row's swap report over its timed steps."""
    read = sum(s["read_bytes"] for s in stats)
    window = sum(s["read_hidden_s"] + s["read_exposed_s"] for s in stats)
    return {"read_gbps": read / window / 1e9 if window else 0.0,
            "overlap_fraction": (sum(s["overlap_bytes"] for s in stats)
                                 / read if read else 1.0),
            "read_exposed_s_a_step": float(np.mean(
                [s["read_exposed_s"] for s in stats])),
            "write_exposed_s_a_step": float(np.mean(
                [s["write_exposed_s"] for s in stats])),
            "serialized_swap_ins": sum(len(s["serialized_swap_ins"])
                                       for s in stats),
            "read_bytes_a_step": stats[-1]["read_bytes"],
            "write_bytes_a_step": stats[-1]["write_bytes"],
            "optimizer_sweep_wall_s": float(np.median(
                [s["optimizer_sweep"]["wall_s"] for s in stats])),
            "aio_backend": stats[-1]["aio_backend"]}


def phase_train_infinity(state):
    """bench.py::bench_infinity (GPT-2 124M, 4 x 1024, bf16, AdamW lr 6e-4,
    dropout 0.1, parameters and optimizer state on NVMe) with
    bench_infinity_stream's buffer_count 2, at prefetch depth 2 and 0: two
    engines from the same weights, INF_WARMUP warm-up steps each, then
    INF_ITERS timed steps each in turns (2, 0, 0, 2): tokens/s, the groups
    on the card (at most 2), the card's peak GiB (each engine's warm-up
    from its start), the swap report of the timed steps.  Each engine
    draws its dropout seeds from its own generator and takes the same
    steps, so the two trajectories and masters must be equal bit for bit
    (the JAX row holds them at 1e-6)."""
    from deepspeed_tpu_torch.utils.tree import tree_flatten
    cfg = gpt2_124m_train()
    ids = torch.from_numpy(bench_ids(cfg, INF_MICRO))
    engines, rows, counts = {}, {}, None
    with checkpoint_dir() as swap:
        for depth in (2, 0):
            gc_cuda()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            engines[depth] = eng = train_engine(cfg, state, infinity_config(
                os.path.join(swap, f"depth{depth}"), depth=depth))
            warm, added = counts_added(lambda: run_steps(eng, ids,
                                                         INF_WARMUP))
            torch.cuda.synchronize()
            counts = added if counts is None else add_counts(counts, added)
            rows[depth] = {"losses": warm, "seconds": 0.0, "stats": [],
                           "peak_memory_gib": (torch.cuda.max_memory_allocated()
                                               - base) / 2 ** 30}
        per_round = INF_ITERS // INF_ROUNDS
        for depth in (2, 0, 0, 2) * (INF_ROUNDS // 2):
            eng, row = engines[depth], rows[depth]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(per_round):
                loss, added = counts_added(lambda: run_steps(eng, ids, 1))
                counts = add_counts(counts, added)
                row["losses"] += loss
                row["stats"].append(eng.swap_stats())
            row["seconds"] += time.perf_counter() - t0
        steps = INF_WARMUP + INF_ITERS
        want = {k: 2 * steps * v for k, v in infinity_counts(cfg).items()}
        check(counts == want, f"launch counts {counts}, expected {want}")
        m2, m0 = (tree_flatten(engines[d].optimizer.master_params)[0]
                  for d in (2, 0))
        check(rows[2]["losses"] == rows[0]["losses"] and all(
            np.array_equal(a, b) for a, b in zip(m2, m0)),
            f"prefetch 2 vs 0: losses {rows[2]['losses']} vs "
            f"{rows[0]['losses']}")
        out = {"depth_2_vs_0_bitwise": True}
        for depth, eng in engines.items():
            row = rows[depth]
            rate = INF_ITERS * INF_MICRO * TRAIN_SEQ / row["seconds"]
            check(eng.max_live_param_groups <= 2,
                  f"depth {depth}: {eng.max_live_param_groups} groups")
            check(all(np.isfinite(row["losses"]))
                  and row["losses"][-1] < row["losses"][0],
                  f"depth {depth}: losses {row['losses']}")
            out[f"depth{depth}"] = {
                "tokens_per_s": rate,
                "ms_per_step": row["seconds"] / INF_ITERS * 1e3,
                "losses": row["losses"],
                "max_live_param_groups": eng.max_live_param_groups,
                "peak_memory_gib": row["peak_memory_gib"],
                "serialized_swap_steps": eng.serialized_swap_steps,
                "pinned_host_bytes": eng.pinned_bytes,
                **swap_summary(row["stats"])}
        out["depth2_over_depth0"] = (out["depth2"]["tokens_per_s"]
                                     / out["depth0"]["tokens_per_s"])
        out["swap_fs"] = fs_type(swap)
        out["launches_per_step"] = infinity_counts(cfg)
        del engines, eng
    gc_cuda()
    return counts, out


# --------------------------------------------------------------------- #
# phases 44-48: the rest of the offload tier (the sentinel with the
# tier, stage 3 with the tier over ranks, ZeRO-Infinity over ranks, and
# both tiers over processes)
# --------------------------------------------------------------------- #
OFFLOAD_Z3_ITERS = 10  # offload_zero3: 3 + 10 steps
OFFLOAD_Z3_NVME = 6  # offload_zero3: the nvme tier against the cpu's, 2 + 4
OFFLOAD_Z3_RESUMED = 2
SENTINEL_HEALTHY = 2  # offload_sentinel: steps before the first NaN
NORM_REL_TOL = 1e-6  # the sentinel's norm against the host's of its grads
INF_DP_WARMUP, INF_DP_ITERS = 2, 4  # infinity_dp: 2 + 4 steps
GRAD_LEAF_TOL = 1e-4  # infinity_dp fp32: a leaf's grads, of its largest
EXPLAIN_TOL = 0.1  # infinity_dp fp32: a departure Adam's replay explains
MP_OFFLOAD_STEPS = 2  # offload_mp / infinity_mp: steps in each process
MP_OFFLOAD_CLIP = 1.0  # offload_mp: gradient clipping (the norm exchanged)


def held_bytes_offload(engine):
    """What a rank holds under offload: on the card its compute-dtype
    parameters, its grad buffer and its fp32 accumulator (its pieces at
    stage 3); on the host its share of the tier's master and moments."""
    mib = lambda *ts: sum(t.numel() * t.element_size()  # noqa: E731
                          for t in ts if t is not None) / 2 ** 20
    ranks = len(engine.local_ranks)
    return {"params_mib": mib(engine._flat),
            "grad_buffer_mib": mib(engine._flat_grad),
            "accumulator_mib": mib(engine._acc[0]),
            "card_mib": mib(engine._flat, engine._flat_grad, engine._acc[0]),
            "host_tier_mib": 12 * engine.optimizer.leaf_map.size / ranks
            / 2 ** 20}


def held_bytes_stage2_offload(cfg):
    """held_bytes_offload of bench_offload's stage-2 engine at one rank,
    from the engine's buffers' sizes (bf16 parameters and grads and the
    fp32 accumulator of the whole flat buffer; the host tier's three fp32
    buffers): train_offload's engine, not built again here."""
    n = cfg.num_params()
    mib = 2 ** 20
    return {"params_mib": 2 * n / mib, "grad_buffer_mib": 2 * n / mib,
            "accumulator_mib": 4 * n / mib, "card_mib": 8 * n / mib,
            "host_tier_mib": 12 * n / mib}


def poison_step(engine, ids):
    """A forward and backward whose accumulated grads get a NaN, then the
    step (the sentinel must not let the tier take it)."""
    loss = engine.forward(ids)
    engine.backward(loss)
    buf = engine._acc[0] if engine._acc[0] is not None \
        else engine._flat_grads[0]
    buf[5] = float("nan")
    engine.step()
    return loss.item()


def phase_offload_sentinel(state):
    """bench.py::bench_offload (stage 2, the host tier) with the
    training-health sentinel (policy rewind, grad norm on): SENTINEL_HEALTHY
    steps; a step whose accumulated grads hold a NaN before any save (the
    rewind has no checkpoint, so it skips): the tier's master, moments and
    step count and the card's parameters bitwise as before; a save; a
    healthy step, whose sentinel norm (from the host grads the tier is
    about to step) is held against the norm this script takes of the same
    host grads in float64; a NaN step again: the rewind restores the
    tier and the parameters bitwise to the save's; a healthy step after.
    At full width and depth."""
    cfg = gpt2_124m_train()
    ids = torch.from_numpy(bench_ids(cfg, TRAIN_BATCH))
    conf = dict(offload_config(), resilience={
        "enabled": True, "verify_lockstep_on_resume": False,
        "sentinel": {"enabled": True, "policy": "rewind"}})
    gc_cuda()
    engine = train_engine(cfg, state, conf)
    check(engine.sentinel is not None and engine._offload is not None,
          "the sentinel with the host tier")
    out = {"policy": "rewind", "layers": cfg.num_layers}
    with checkpoint_dir() as ckpt:
        reset_launch_counts()
        losses = run_steps(engine, ids, SENTINEL_HEALTHY)
        before = tier_bits(engine)
        flat = engine._flat.clone()
        poison_step(engine, ids)
        c = engine.sentinel.counters()
        check(same_tier(tier_bits(engine), before)
              and torch.equal(engine._flat, flat),
              "a skipped NaN step moved the tier or the parameters")
        check(c["steps_skipped"] == 1 and engine.skipped_steps == 1
              and not np.isfinite(engine._last_grad_norm_host),
              f"the NaN step: counters {c}, norm "
              f"{engine._last_grad_norm_host}")
        engine.save_checkpoint(ckpt, tag="good")
        saved, flat = tier_bits(engine), engine._flat.clone()
        seen, norm = [], engine._offload_grad_norm

        def spy():
            seen.append(engine._tier_flat(
                engine._offload.host_grads.clone()).double())
            return norm()
        engine._offload_grad_norm = spy
        losses += run_steps(engine, ids, 1)
        del engine._offload_grad_norm
        host_norm = float(torch.sqrt((seen[0] * seen[0]).sum())) / (
            engine.loss_scale * engine.world_size)
        norm_err = abs(engine._last_grad_norm_host - host_norm) / host_norm
        check(norm_err <= NORM_REL_TOL and not same_tier(tier_bits(engine),
                                                         saved),
              f"the sentinel's norm {engine._last_grad_norm_host} vs the "
              f"host's {host_norm}")
        steps_at_save = engine.global_steps - 1
        poison_step(engine, ids)
        c = engine.sentinel.counters()
        check(same_tier(tier_bits(engine), saved)
              and torch.equal(engine._flat, flat)
              and engine.global_steps == steps_at_save
              and c["rewinds"] == 1,
              f"the rewind: counters {c}, steps {engine.global_steps}")
        losses += run_steps(engine, ids, 1)
        torch.cuda.synchronize()
        counts = launch_counts()
    micro_steps = SENTINEL_HEALTHY + 4
    want = {k: micro_steps * v for k, v in step_counts(cfg).items()}
    check(counts == want, f"launch counts {counts}, expected {want}")
    check(all(np.isfinite(losses)), f"losses {losses}")
    out.update(losses=losses, skip_bitwise=True, rewind_bitwise=True,
               sentinel_norm=engine._last_grad_norm_host,
               norm_checked=host_norm, norm_rel_err=norm_err,
               counters=engine.sentinel.counters(),
               launches_per_step=step_counts(cfg))
    del engine
    gc_cuda()
    return counts, out


def offload_zero3_config(cfg, device="cpu", nvme_path=None):
    """train_zero3's `off` engine (zero3_config: 4 ranks of the card, 2 rows
    each, bench_gpt2's global batch) with bench_offload's offload_optimizer
    on `device`."""
    conf = zero3_config(cfg, False)
    oo = {"device": device}
    if nvme_path is not None:
        oo["nvme_path"] = nvme_path
    return dict(conf, zero_optimization=dict(conf["zero_optimization"],
                                             offload_optimizer=oo))


def phase_offload_zero3(state, train_summary, stage2_tokens_per_s):
    """bench_offload at stage 3 over ZERO3_WORLD ranks of the card
    (offload_zero3_config): the device stage-3 engine from the same
    weights and generators (3 + 10 steps) against the cpu tier's timed
    run (3 + 10 steps: tokens/s, the step split, the peak) -- all 13
    losses 2e-2, and each leaf's master update after the 3 warm-up steps
    (hold_master, whose skipped-step control needs a step to be a large
    share of the update, as in offload_grads); the nvme tier bitwise
    the cpu tier after 2 + 4 steps (losses, master and moments, every
    rank's pieces); a save after the timed steps resumed bitwise in a new
    engine for 2 steps; what a rank holds against stage-2 offload's."""
    cfg = gpt2_124m_train()
    steps = TRAIN_WARMUP + OFFLOAD_Z3_ITERS
    ids = torch.from_numpy(bench_ids(cfg, ZERO3_MICRO * ZERO3_WORLD))
    gc_cuda()
    ref = train_engine(cfg, state, zero3_config(cfg, False))
    ref_losses = run_steps(ref, ids, TRAIN_WARMUP - 1)
    short = gpt2_params_to_jax(ref.module_state_dict(), cfg)
    ref_losses += run_steps(ref, ids, 1)
    ref_tree = gpt2_params_to_jax(ref.module_state_dict(), cfg)
    ref_losses += run_steps(ref, ids, OFFLOAD_Z3_ITERS)
    del ref
    kept = {}

    def at_nvme_step(engine):
        if engine.global_steps == OFFLOAD_Z3_NVME:
            kept["bits"] = tier_bits(engine)
            kept["flats"] = [f.clone() for f in engine._flats]

    def after_warmup(engine):
        kept["master"] = engine._module_tree()
    counts, row, engine = timed_offload(
        cfg, state, offload_zero3_config(cfg), TRAIN_WARMUP,
        OFFLOAD_Z3_ITERS, train_summary, after_step=at_nvme_step,
        after_warmup=after_warmup)
    check(engine._zero3 and len(engine.local_ranks) == ZERO3_WORLD,
          f"stage 3 over {engine.local_ranks}")
    losses = row.pop("losses")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    check(len(ref_losses) == len(losses) == steps,
          f"{len(ref_losses)} and {len(losses)} losses")
    check(loss_err <= LOSS_REL_TOL, f"losses {losses} vs {ref_losses}")
    out = {"world": ZERO3_WORLD, "steps": steps, "timed": row,
           "losses": losses, "device_engine_losses": ref_losses,
           "loss_rel_err": loss_err,
           **hold_master(kept.pop("master"), ref_tree,
                         gpt2_params_to_jax(state, cfg), short,
                         cfg.hidden_size, "stage-3 cpu tier"),
           "held_bytes_rank": held_bytes_offload(engine),
           "stage2_held_bytes_rank": held_bytes_stage2_offload(cfg),
           "stage2_offload_tokens_per_s": stage2_tokens_per_s,
           "vs_stage2_offload": row["tokens_per_s"] / stage2_tokens_per_s}
    with checkpoint_dir() as ckpt:
        engine.save_checkpoint(ckpt, tag="resume")
        cont = run_steps(engine, ids, OFFLOAD_Z3_RESUMED)
        after = tier_bits(engine)
        flats = [f.clone() for f in engine._flats]
        del engine
        gc_cuda()
        fresh = train_engine(cfg, state, offload_zero3_config(cfg))
        fresh.load_checkpoint(ckpt, tag="resume")
        resumed = run_steps(fresh, ids, OFFLOAD_Z3_RESUMED)
        check(resumed == cont and same_tier(tier_bits(fresh), after)
              and all(torch.equal(a, b) for a, b in zip(fresh._flats,
                                                        flats)),
              f"resumed {resumed} vs {cont}, or the state differs")
        out.update(resumed_losses=resumed, resume_bitwise=True)
        del fresh
    with checkpoint_dir() as swap:
        gc_cuda()
        nvme = train_engine(cfg, state, offload_zero3_config(
            cfg, "nvme", swap))
        nvme_losses = run_steps(nvme, ids, OFFLOAD_Z3_NVME)
        check(nvme_losses == losses[:OFFLOAD_Z3_NVME]
              and same_tier(tier_bits(nvme), kept["bits"])
              and all(torch.equal(a, b) for a, b in zip(nvme._flats,
                                                        kept["flats"])),
              f"the nvme tier vs the cpu tier after {OFFLOAD_Z3_NVME} "
              f"steps: losses {nvme_losses} vs {losses[:OFFLOAD_Z3_NVME]}")
        out.update(nvme_bitwise=True, nvme_steps=OFFLOAD_Z3_NVME,
                   nvme_sweep=nvme.optimizer.last_sweep_stats)
        del nvme
    gc_cuda()
    return counts, out


def master_entry_ratios(out, ref, rtol=1e-5, atol_rel=1e-4):
    """Leaf by leaf (dotted path: array), each entry's |out - ref| /
    (rtol |ref| + atol_rel max|ref|): tests/test_torch_infinity.py
    `_assert_master_close`'s bound, which holds where every entry is at
    most 1; the key third of attn_qkvb reads 0, left out as there."""
    from deepspeed_tpu_torch.utils.tree import tree_flatten
    out_ratios = {}
    for name, o, r in zip(leaf_paths(ref), tree_flatten(out)[0],
                          tree_flatten(ref)[0]):
        o, r = np.asarray(o, np.float64), np.asarray(r, np.float64)
        ratio = np.abs(o - r) / (rtol * np.abs(r) + atol_rel
                                 * np.abs(r).max())
        if name == "h.attn_qkvb":
            h = r.shape[-1] // 3
            ratio[..., h:2 * h] = 0.0
        out_ratios[name] = ratio
    return out_ratios


def leaf_value(tree, dotted):
    """A nested dict's leaf at a dotted path, as a float64 array."""
    for key in dotted.split("."):
        tree = tree[key]
    return np.asarray(tree, np.float64)


class LeafGrads:
    """A host grad buffer of a leaf map's layout (fp32), read by JAX leaf
    (dotted path) on demand."""

    def __init__(self, leaf_map, flat):
        self.leaf_map, self.flat = leaf_map, flat
        self.index = {".".join(leaf.path): k
                      for k, leaf in enumerate(leaf_map.leaves)}

    def leaf(self, name):
        """The leaf as a float64 array of its shape."""
        return self.leaf_map.gather(self.flat,
                                    self.index[name]).double().numpy()

    def at(self, name, flat_index):
        """The leaf's entries at `flat_index` (float64)."""
        return self.leaf(name).ravel()[flat_index]


def leaf_grad_errors(grads, ref, hidden):
    """Two LeafGrads, leaf by leaf: max|d| / max|ref|, the key third of
    attn_qkvb left out (update_errors)."""
    out = {}
    for name in ref.index:
        g, r = grads.leaf(name), ref.leaf(name)
        if name == "h.attn_qkvb":
            g, r = (np.concatenate([x[..., :hidden], x[..., 2 * hidden:]],
                                   axis=-1) for x in (g, r))
        out[name] = float(np.abs(g - r).max() / np.abs(r).max())
    return out


def phase_infinity_dp(state):
    """bench.py::bench_infinity over DP_WORLD ranks of the card (4 rows a
    rank, dropout 0.1, parameters and optimizer in files, each rank
    streaming the groups and its rows, the groups' grads summed over the
    ranks in rank order), 2 + 4 steps at prefetch depth 2 (the last 4
    timed) and at depth 0: the two bitwise (losses, master).  Then its
    model in fp32 (dropout off, the host tiers) on one 16-row global
    batch, 2 steps, three ways: one rank (the reference), DP_WORLD ranks,
    and one rank at gas 2 (8 rows a micro-step: the same function summed
    in another order, the control).  Against the reference: the losses
    at 1e-5; the first step's host grads leaf by leaf at GRAD_LEAF_TOL of
    the leaf's largest; each leaf's update (hold_master); and the master
    entry by entry against tests/test_torch_infinity.py's
    `_assert_master_close` bound: each entry out of it must be explained
    by the grads, Adam replayed in float64 from the start over each run's
    own grads giving the two masters' difference there within EXPLAIN_TOL
    of it (Adam's normalised step turns a near-zero grad's rounding in
    another summation order into a share of lr).  The control reads the
    same bound, so the four ranks' departures stand beside the one
    rank's own under another order; the worst entries' grads are
    reported."""
    from deepspeed_tpu_torch.utils.tree import tree_flatten
    cfg = gpt2_124m_train()
    steps = INF_DP_WARMUP + INF_DP_ITERS
    rows = INF_MICRO * DP_WORLD
    ids = torch.from_numpy(bench_ids(cfg, rows))
    out = {"world": DP_WORLD, "rows": rows, "steps": steps,
           "launches_per_rank_step": infinity_counts(cfg)}
    runs, counts = {}, []
    with checkpoint_dir() as swap:
        for depth in (2, 0):
            conf = dict(infinity_config(os.path.join(swap, f"d{depth}"),
                                        depth=depth), mesh={"data": DP_WORLD})
            gc_cuda()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            losses, _, eng = infinity_run(cfg, state, conf, ids,
                                          INF_DP_WARMUP)
            check(eng.world_size == DP_WORLD, f"world {eng.world_size}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses += run_steps(eng, ids, INF_DP_ITERS)
            seconds = time.perf_counter() - t0
            counts.append(launch_counts())  # since infinity_run's reset
            want = {k: steps * DP_WORLD * v
                    for k, v in infinity_counts(cfg).items()}
            check(counts[-1] == want,
                  f"launch counts {counts[-1]}, expected {want}")
            runs[depth] = (losses, eng.optimizer.master_params)
            check(eng.max_live_param_groups <= 2
                  and all(np.isfinite(losses)) and losses[-1] < losses[0],
                  f"depth {depth}: {eng.max_live_param_groups} groups, "
                  f"losses {losses}")
            out[f"depth{depth}"] = {
                "tokens_per_s": INF_DP_ITERS * rows * TRAIN_SEQ / seconds,
                "ms_per_step": seconds / INF_DP_ITERS * 1e3,
                "losses": losses,
                "max_live_param_groups": eng.max_live_param_groups,
                "peak_memory_gib": (torch.cuda.max_memory_allocated()
                                    - base) / 2 ** 30,
                "pinned_host_bytes": eng.pinned_bytes}
            del eng
        m2, m0 = (tree_flatten(runs[d][1])[0] for d in (2, 0))
        check(runs[2][0] == runs[0][0] and all(
            np.array_equal(a, b) for a, b in zip(m2, m0)),
            f"depth 2 vs 0: {runs[2][0]} vs {runs[0][0]}")
        out["depth_2_vs_0_bitwise"] = True
        out["fp32_vs_one_rank"] = infinity_dp_fp32(cfg, state, ids, swap,
                                                   counts)
    gc_cuda()
    return add_counts(*counts), out


def infinity_dp_fp32(cfg, state, ids, swap, counts):
    """infinity_dp's fp32 half (its docstring): the summary; each run's
    launch counts appended to `counts`."""
    rows = ids.shape[0]
    fp32 = replace(cfg, bf16=False, embd_dropout=0.0, attn_dropout=0.0,
                   hidden_dropout=0.0)
    held = {}
    for name, world, gas in (("one", 1, 1), ("ranks", DP_WORLD, 1),
                             ("gas2", 1, 2)):
        micro = rows // (world * gas)
        conf = dict(infinity_config(os.path.join(swap, name), "cpu",
                                    "cpu"),
                    bf16={"enabled": False},
                    train_micro_batch_size_per_gpu=micro,
                    gradient_accumulation_steps=gas,
                    mesh={"data": world})
        gc_cuda()
        eng = train_engine(fp32, state, conf)
        check(eng.world_size == world, f"world {eng.world_size}")
        reset_launch_counts()
        losses, grads, masters = [], [], []
        for _ in range(INF_DP_WARMUP):
            parts = []
            for m in range(gas):
                loss = eng.forward(ids[m * rows // gas:
                                       (m + 1) * rows // gas])
                eng.backward(loss)
                if m == gas - 1:  # what the tier is about to step
                    grads.append(LeafGrads(eng._leaf_map,
                                           eng._host_grads / (gas * world)))
                eng.step()
                parts.append(loss.item())
            losses.append(float(np.mean(parts)))
            masters.append(eng.optimizer.master_params)
        torch.cuda.synchronize()
        counts.append(launch_counts())
        want = {k: INF_DP_WARMUP * gas * world * v
                for k, v in infinity_counts(fp32).items()}
        check(counts[-1] == want,
              f"{name}: launch counts {counts[-1]}, expected {want}")
        held[name] = {"losses": losses, "grads": grads,
                      "masters": masters,
                      "hyper": eng.optimizer.hyper}
        del eng
    ref = held["one"]
    hyper = ref["hyper"]
    eps = hyper.eps
    start = gpt2_params_to_jax(state, fp32)
    result = {"layers": fp32.num_layers, "rows": rows,
              "steps": INF_DP_WARMUP, "adam_eps": eps,
              "grad_leaf_tol": GRAD_LEAF_TOL, "explain_tol": EXPLAIN_TOL}
    for name in ("ranks", "gas2"):
        run = held[name]
        err = max(abs(a - b) / abs(b)
                  for a, b in zip(run["losses"], ref["losses"]))
        grad_errs = leaf_grad_errors(run["grads"][0], ref["grads"][0],
                                     cfg.hidden_size)
        ratios = master_entry_ratios(run["masters"][-1], ref["masters"][-1])
        out_of_bound, unexplained, worst = 0, [], []
        for leaf, ratio in ratios.items():
            bad = np.flatnonzero(ratio > 1.0)
            out_of_bound += len(bad)
            top = np.argpartition(ratio, -3, axis=None)[-3:]
            worst += [(float(ratio.ravel()[i]), leaf, int(i)) for i in top]
            if not len(bad):
                continue
            # Adam replayed in float64 from each run's own grads: the part
            # of the departure that the grads' difference explains
            w0 = leaf_value(start, leaf).ravel()[bad]
            replayed = (adam_replay(w0, [g.at(leaf, bad)
                                         for g in run["grads"]], hyper)
                        - adam_replay(w0, [g.at(leaf, bad)
                                           for g in ref["grads"]], hyper))
            actual = (leaf_value(run["masters"][-1], leaf).ravel()[bad]
                      - leaf_value(ref["masters"][-1], leaf).ravel()[bad])
            miss = np.abs(replayed - actual) > EXPLAIN_TOL * np.abs(actual)
            unexplained += [(leaf, int(i)) for i in bad[miss]]
        worst = [{"leaf": leaf, "flat_index": i, "ratio": ratio,
                  "master": float(leaf_value(run["masters"][-1], leaf)
                                  .ravel()[i]),
                  "reference": float(leaf_value(ref["masters"][-1], leaf)
                                     .ravel()[i]),
                  "grads_over_eps": [float(g.at(leaf, [i])[0] / eps)
                                     for g in run["grads"]],
                  "reference_grads_over_eps": [float(g.at(leaf, [i])[0]
                                                     / eps)
                                               for g in ref["grads"]]}
                 for ratio, leaf, i in sorted(worst, reverse=True)[:5]]
        grad_leaf = max(grad_errs, key=grad_errs.get)
        result[name] = {
            "world": DP_WORLD if name == "ranks" else 1,
            "gas": 2 if name == "gas2" else 1,
            "losses": run["losses"], "one_rank_losses": ref["losses"],
            "losses_bitwise": run["losses"] == ref["losses"],
            "loss_rel_err": err, "first_step_grad_rel_err": grad_errs,
            "worst_first_step_grad_leaf": grad_leaf,
            "worst_first_step_grad_rel_err": grad_errs[grad_leaf],
            "master_bound_worst_ratio": worst[0]["ratio"],
            "master_bound_worst_leaf": worst[0]["leaf"],
            "entries_out_of_bound": out_of_bound,
            "out_of_bound_unexplained_by_grads": len(unexplained),
            "worst_entries": worst}
        check(err <= 1e-5, f"fp32 {name} vs one rank: losses "
              f"{run['losses']} vs {ref['losses']}")
        if name == "ranks":
            check(grad_errs[grad_leaf] <= GRAD_LEAF_TOL,
                  f"fp32 over {DP_WORLD} ranks vs one: the first step's "
                  f"grads by leaf {grad_errs}")
            check(not unexplained,
                  f"fp32 over {DP_WORLD} ranks vs one: {len(unexplained)} "
                  "master entries out of the bound that Adam over the two "
                  f"runs' grads does not explain, as {unexplained[:10]}")
            result[name].update(hold_master(
                run["masters"][-1], ref["masters"][-1], start,
                ref["masters"][0], cfg.hidden_size, "infinity dp fp32"))
    return result


def adam_replay(w0, grads, hyper):
    """The host tier's Adam (ops/adam/cpu_adam.py `adam_step_plain`)
    replayed in float64 from `w0` over each step's grads (arrays of one
    shape), with the tier's hyper-parameters."""
    w = np.asarray(w0, np.float64).copy()
    m, v = np.zeros_like(w), np.zeros_like(w)
    b1, b2 = hyper.betas
    wd = hyper.weight_decay
    for t, g in enumerate(grads, 1):
        g = np.asarray(g, np.float64)
        if not hyper.adamw_mode and wd > 0:
            g = g + wd * w
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        denom = np.sqrt(v) / np.sqrt(1 - b2 ** t) + hyper.eps
        if hyper.adamw_mode and wd > 0:
            w = w * (1 - hyper.lr * wd)
        w = w - hyper.lr / (1 - b1 ** t) * m / denom
    return w


def mp_offload_worker(out_dir):
    """offload_mp in one process: bench_offload's stage-2 host tier over
    the group (each process its range; gradient clipping, so the norm's
    partials are exchanged), MP_OFFLOAD_STEPS steps on its rows; the
    whole tier's and the parameters' digests; a save in the sharded
    layout (the default under processes)."""
    cfg = gpt2_124m_train()
    state = init_state(cfg)
    world, rank = dist.get_world_size(), dist.get_rank()
    engine = train_engine(cfg, state, mp_offload_config(world))
    check(engine.local_ranks == [rank] and engine.mesh.process_count
          == world, f"the mesh is {engine.mesh}")
    rows = torch.from_numpy(bench_ids(cfg, TRAIN_BATCH * world)[
        rank * TRAIN_BATCH:(rank + 1) * TRAIN_BATCH])
    reset_launch_counts()
    losses = run_steps(engine, rows, MP_OFFLOAD_STEPS)
    torch.cuda.synchronize()
    counts = launch_counts()
    out = {"rank": rank, "world": world, "losses": losses,
           "launches": counts, **tier_digests(engine),
           "params_sha256": sha256(engine._flat[:engine.num_params])}
    engine.save_checkpoint(os.path.join(out_dir, "ckpt"), tag="mp")
    out["layout"] = engine._partition_topology()["layout"]
    return out


def mp_offload_config(world):
    return dict(offload_config(), mesh={"data": world},
                gradient_clipping=MP_OFFLOAD_CLIP)


def tier_digests(engine):
    """sha256 of the offload tier's whole master and moments (the first
    num_params entries, gathered over the processes: a collective) and
    its step count."""
    tier = engine.optimizer
    n = tier.leaf_map.num_params
    return {"tier_step": tier.step_count(),
            "tier_sha256": {k: sha256(engine._tier_flat(v)[:n])
                            for k, v in tier.local_state().items()}}


def mp_against_single_controller(what, results, ref_losses, ref_digests,
                                 ref_params, loaded_digests):
    """Every process's losses, tier digests and parameters against the
    single controller's at W ranks, and the save at W processes loaded at
    one rank: all bitwise; the launch counters summed over the
    processes."""
    world = len(results)
    for res in results:
        check(res["losses"] == ref_losses,
              f"{what}: rank {res['rank']} losses {res['losses']} vs the "
              f"single controller's {ref_losses}")
        check(res["tier_sha256"] == ref_digests["tier_sha256"]
              and res["tier_step"] == ref_digests["tier_step"]
              == MP_OFFLOAD_STEPS,
              f"{what}: rank {res['rank']}'s tier differs from the single "
              "controller's")
        check(res["params_sha256"] == ref_params,
              f"{what}: rank {res['rank']}'s parameters differ")
    check(loaded_digests == ref_digests,
          f"{what}: the save at {world} process(es) loaded at one rank "
          "differs")
    counts = {name: sum(res["launches"][name] for res in results)
              for name in results[0]["launches"]}
    return counts, {
        "world": world, "processes_vs_single_controller_bitwise": True,
        "loaded_at_one_rank_bitwise": True, "losses": ref_losses,
        "needs_two_cards": ("the exchange between processes: skipped, "
                            "one card visible (a one-process group ran)"
                            if world == 1 else None),
        "launches_all_processes": counts}


def phase_offload_mp(state):
    """bench_offload's stage-2 host tier (clipping 1.0) in W = every visible
    card processes, each tier over its range (the finite flag and the
    norm's partials exchanged), MP_OFFLOAD_STEPS steps, against the single
    controller at W ranks on the same cards: losses, the whole tier
    (digests) and the parameters bitwise; the workers' save (sharded at W
    > 1) loaded by one rank in this process: its tier bitwise.  At W = 1
    the one-process group runs the same code and the comparison between
    processes is reported skipped."""
    cfg = gpt2_124m_train()
    torch.cuda.empty_cache()
    with mp_results("offload_mp") as (out_dir, results):
        world = len(results)
        gc_cuda()
        one = train_engine(cfg, state, dict(
            offload_config(micro=TRAIN_BATCH * world), mesh={"data": 1},
            gradient_clipping=MP_OFFLOAD_CLIP))
        one.load_checkpoint(os.path.join(out_dir, "ckpt"), tag="mp")
        loaded = tier_digests(one)
        del one
    gc_cuda()
    ref = train_engine(cfg, state, mp_offload_config(world))
    ids = torch.from_numpy(bench_ids(cfg, TRAIN_BATCH * world))
    ref_losses = run_steps(ref, ids, MP_OFFLOAD_STEPS)
    digests = tier_digests(ref)
    params = sha256(ref._flat[:ref.num_params])
    del ref
    gc_cuda()
    counts, out = mp_against_single_controller(
        "offload_mp", results, ref_losses, digests, params, loaded)
    out["saved_layout"] = results[0]["layout"]
    return counts, out


def mp_infinity_config(world, swap):
    """bench_infinity's engine over `world` ranks with the parameters and
    the optimizer in the host tiers (the file tiers' bits are the host
    tiers', held in infinity_grads and train_infinity)."""
    return dict(infinity_config(swap, "cpu", "cpu"), mesh={"data": world})


def mp_infinity_worker(out_dir):
    """infinity_mp in one process: bench_infinity's streaming engine over
    the group (its 4 rows, its range of the host tier), MP_OFFLOAD_STEPS
    steps;
    the whole tier's and the host groups' digests; a save (process 0
    writes the whole tier)."""
    cfg = gpt2_124m_train()
    state = init_state(cfg)
    world, rank = dist.get_world_size(), dist.get_rank()
    engine = train_engine(cfg, state, mp_infinity_config(
        world, os.path.join(out_dir, "swap")))
    check(engine.local_ranks == [rank], f"the mesh is {engine.mesh}")
    rows = torch.from_numpy(bench_ids(cfg, INF_MICRO * world)[
        rank * INF_MICRO:(rank + 1) * INF_MICRO])
    reset_launch_counts()
    losses = run_steps(engine, rows, MP_OFFLOAD_STEPS)
    torch.cuda.synchronize()
    counts = launch_counts()
    out = {"rank": rank, "world": world, "losses": losses,
           "launches": counts, **tier_digests(engine),
           "params_sha256": sha256(engine._host_params)}
    engine.save_checkpoint(os.path.join(out_dir, "ckpt"), tag="mp")
    return out


def phase_infinity_mp(state):
    """bench_infinity's streaming engine (mp_infinity_config: the host
    tiers) in W = every visible card processes, 4 rows each, each tier
    over its range, MP_OFFLOAD_STEPS steps, against the single controller
    at W ranks on the same cards: losses, the whole tier and the host
    groups bitwise; the workers' save loaded by one rank here: its tier
    bitwise.  At W = 1 the comparison between processes is reported
    skipped."""
    cfg = gpt2_124m_train()
    torch.cuda.empty_cache()
    with checkpoint_dir() as swap:
        with mp_results("infinity_mp") as (out_dir, results):
            world = len(results)
            gc_cuda()
            one = train_engine(cfg, state, dict(
                mp_infinity_config(1, os.path.join(swap, "one")),
                train_micro_batch_size_per_gpu=INF_MICRO * world))
            one.load_checkpoint(os.path.join(out_dir, "ckpt"), tag="mp")
            loaded = tier_digests(one)
            del one
        gc_cuda()
        ref = train_engine(cfg, state, mp_infinity_config(
            world, os.path.join(swap, "sc")))
        ids = torch.from_numpy(bench_ids(cfg, INF_MICRO * world))
        ref_losses = run_steps(ref, ids, MP_OFFLOAD_STEPS)
        digests = tier_digests(ref)
        params = sha256(ref._host_params)
        del ref
    gc_cuda()
    return mp_against_single_controller(
        "infinity_mp", results, ref_losses, digests, params, loaded)


def run_offload_phases(state, train_summary, path_counts):
    """Phases 36-40 and 44-48, their launch counts into the kernel line's
    map."""
    run_phase("offload_grads", phase_offload_grads, state)
    path_counts["offload"], offload_rate = run_phase(
        "train_offload", phase_train_offload, state, train_summary)
    path_counts["offload_nvme"] = run_phase(
        "train_offload_nvme", phase_train_offload_nvme, state, train_summary)
    run_phase("infinity_grads", phase_infinity_grads, state)
    path_counts["infinity"] = run_phase("train_infinity",
                                        phase_train_infinity, state)
    path_counts["offload_sentinel"] = run_phase(
        "offload_sentinel", phase_offload_sentinel, state)
    path_counts["offload_zero3"] = run_phase(
        "offload_zero3", phase_offload_zero3, state, train_summary,
        offload_rate)
    path_counts["infinity_dp"] = run_phase("infinity_dp", phase_infinity_dp,
                                           state)
    path_counts["offload_mp"] = run_phase("offload_mp", phase_offload_mp,
                                          state)
    path_counts["infinity_mp"] = run_phase("infinity_mp", phase_infinity_mp,
                                           state)


def last_line():
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def run_zero3_phases(state, path_counts, replays_traced):
    """Phases 31-35 and 41-43, their launch counts into the kernel line's
    maps."""
    run_phase("zero3_grads", phase_zero3_grads, state)
    path_counts["train_zero3"], plain = run_phase(
        "train_zero3", phase_train_zero3, state)
    path_counts["train_zero3_remat"] = run_phase(
        "train_zero3_remat", phase_train_zero3_remat, state, plain)
    del plain
    path_counts["train_zero3_fcm"] = run_phase(
        "train_zero3_fcm", phase_train_zero3_fcm, state)
    path_counts["checkpoint_zero3"], kept = run_phase(
        "checkpoint_zero3", phase_checkpoint_zero3, state)
    path_counts["checkpoint_sharded"] = run_phase(
        "checkpoint_sharded", phase_checkpoint_sharded, kept)
    del kept
    path_counts["train_zero3_fused"], replays_traced["train_zero3_fused"] = \
        run_phase("train_zero3_fused", phase_train_zero3_fused, state)
    run_phase("tiled_linear", phase_tiled_linear)


def main():
    if sys.argv[1:2] == ["--mp-worker"]:
        # a worker process of the mp phases (launch_mp)
        return mp_worker(sys.argv[2], sys.argv[3])
    MP_PLANNED[:] = {
        "--mp-only": ["train_mp_grads", "train_mp", "train_fused_mp"],
        "--monitor-only": ["monitor_mp"],
        "--fused-only": ["train_fused_mp"],
        "--offload-only": ["offload_mp", "infinity_mp"]}.get(
            " ".join(sys.argv[1:]),
            [] if sys.argv[1:] else ["train_mp_grads", "train_mp",
                                     "train_fused_mp", "monitor_mp",
                                     "offload_mp", "infinity_mp"])
    card = run_phase("device", phase_device)
    if sys.argv[1:] == ["--fcm-only"]:
        # only the collective tier, its ranks spread over every visible
        # card (with four cards, one rank each)
        for group in [g for g in PARITY_CASES if not g.startswith("fcm_")]:
            del PARITY_CASES[group]
        run_parity()
        run_phase("fcm_ops", phase_fcm_ops)
        run_phase("fcm_timing", phase_fcm_timing)
        print(card, flush=True)
        return last_line()
    if sys.argv[1:] == ["--dp-only"]:
        # kernels A, B, D, E and the data-parallel phases, the ranks spread
        # over every visible card
        for group in [g for g in PARITY_CASES if g not in DP_PARITY]:
            del PARITY_CASES[group]
        run_parity()
        train_state = init_state(gpt2_124m_train())
        run_phase("train_dp_grads", phase_train_dp_grads, train_state)
        run_phase("train_dp", phase_train_dp, train_state)
        run_phase("checkpoint_dp", phase_checkpoint_dp, train_state)
        print(card, flush=True)
        return last_line()
    if sys.argv[1:] == ["--remat-only"]:
        # kernels A, B, D, E, train (for train_fp16's comparison) and the
        # phases of activation checkpointing and fp16
        for group in [g for g in PARITY_CASES if g not in DP_PARITY]:
            del PARITY_CASES[group]
        run_parity()
        train_state = init_state(gpt2_124m_train())
        _, train_summary = run_phase("train", phase_train, train_state)
        run_phase("train_fp16", phase_train_fp16, train_state, train_summary)
        del train_state
        medium_state = init_state(gpt2_medium())
        run_phase("train_remat_grads", phase_train_remat_grads, medium_state)
        run_phase("train_medium", phase_train_medium, medium_state)
        del medium_state
        run_phase("train_large", phase_train_large, init_state(gpt2_large()))
        print(card, flush=True)
        return last_line()
    if sys.argv[1:] == ["--mp-only"]:
        # kernels A, B, D, E and the phases of one process a card
        for group in [g for g in PARITY_CASES if g not in DP_PARITY]:
            del PARITY_CASES[group]
        run_parity()
        train_state = init_state(gpt2_124m_train())
        run_phase("train_mp_grads", phase_train_mp_grads, train_state)
        run_phase("train_mp", phase_train_mp, train_state)
        run_phase("train_fused_mp", phase_train_fused_mp, train_state)
        print(card, flush=True)
        return last_line()
    if sys.argv[1:] == ["--monitor-only"]:
        # kernels A, B, D, E and the runtime monitor's phases
        for group in [g for g in PARITY_CASES if g not in DP_PARITY]:
            del PARITY_CASES[group]
        run_parity()
        train_state = init_state(gpt2_124m_train())
        run_phase("monitor", phase_monitor, train_state)
        run_phase("monitor_mp", phase_monitor_mp, train_state)
        print(card, flush=True)
        return last_line()
    if sys.argv[1:] == ["--zero3-only"]:
        # kernels A, B, D, E and the ZeRO-3 phases
        for group in [g for g in PARITY_CASES if g not in DP_PARITY]:
            del PARITY_CASES[group]
        run_parity()
        train_state = init_state(gpt2_124m_train())
        run_zero3_phases(train_state, {}, {})
        print(card, flush=True)
        return last_line()
    if sys.argv[1:] == ["--offload-only"]:
        # kernels A, B, D, E, train (for the offload rows' comparison) and
        # the offload tier's phases
        for group in [g for g in PARITY_CASES if g not in DP_PARITY]:
            del PARITY_CASES[group]
        run_parity()
        train_state = init_state(gpt2_124m_train())
        _, train_summary = run_phase("train", phase_train, train_state)
        run_offload_phases(train_state, train_summary, {})
        print(card, flush=True)
        return last_line()
    if sys.argv[1:] == ["--fused-only"]:
        # kernels A, B, D, E and the phases of the fused step and the
        # resilience block (train_large for train_fused_large's comparison)
        for group in [g for g in PARITY_CASES if g not in DP_PARITY]:
            del PARITY_CASES[group]
        run_parity()
        train_state = init_state(gpt2_124m_train())
        run_phase("train_fused_grads", phase_train_fused_grads, train_state)
        run_phase("train_fused_dp", phase_train_fused_dp, train_state)
        run_phase("train_fused", phase_train_fused, train_state)
        run_phase("train_fused_mp", phase_train_fused_mp, train_state)
        run_phase("resilience", phase_resilience, train_state)
        del train_state
        large_state = init_state(gpt2_large())
        _, large = run_phase("train_large", phase_train_large, large_state)
        run_phase("train_fused_large", phase_train_fused_large, large_state,
                  large)
        print(card, flush=True)
        return last_line()
    primary = run_parity()

    cfg = gpt2_124m()
    model = GPT2Model(replace(cfg, bf16=False))
    model.init_params(torch.Generator().manual_seed(0))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    del model
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                           generator=torch.Generator().manual_seed(1))
    bf16 = run_phase("serve_bf16", phase_serve_bf16, cfg, state, prompt)
    int8 = run_phase("serve_int8", phase_serve_int8, cfg, state, prompt,
                     bf16[1])
    served = {"serve_bf16": bf16, "serve_int8": int8}
    timing = run_phase("timing", phase_timing, prompt, served)
    run_phase("profile", phase_profile, prompt, served, timing)
    bf16_counts, int8_counts = bf16[2]["launches"], int8[2]["launches"]
    del bf16, int8, served, state

    train_state = init_state(gpt2_124m_train())
    run_phase("train_grads", phase_train_grads, train_state)
    train_counts, train_summary = run_phase("train", phase_train, train_state)
    path_counts = {"bf16": bf16_counts, "int8": int8_counts,
                   "train": train_counts}
    path_counts["train_fp16"] = run_phase("train_fp16", phase_train_fp16,
                                          train_state, train_summary)
    path_counts["checkpoint"] = run_phase("checkpoint", phase_checkpoint,
                                          train_state)
    run_phase("train_dp_grads", phase_train_dp_grads, train_state)
    path_counts["train_dp"] = run_phase("train_dp", phase_train_dp,
                                        train_state)
    path_counts["checkpoint_dp"] = run_phase("checkpoint_dp",
                                             phase_checkpoint_dp, train_state)
    run_phase("train_mp_grads", phase_train_mp_grads, train_state)
    path_counts["train_mp"] = run_phase("train_mp", phase_train_mp,
                                        train_state)
    run_phase("train_fused_grads", phase_train_fused_grads, train_state)
    run_phase("train_fused_dp", phase_train_fused_dp, train_state)
    # the fused paths' counters and the traced launches of their replays
    replays_traced = {}
    for path, fn in (("train_fused", phase_train_fused),
                     ("train_fused_mp", phase_train_fused_mp),
                     ("resilience", phase_resilience),
                     ("monitor", phase_monitor)):
        path_counts[path], replays_traced[path] = run_phase(path, fn,
                                                            train_state)
    path_counts["monitor_mp"] = run_phase("monitor_mp", phase_monitor_mp,
                                          train_state)
    run_zero3_phases(train_state, path_counts, replays_traced)
    run_offload_phases(train_state, train_summary, path_counts)
    del train_state

    run_phase("train_sparse_grads", phase_train_sparse_grads)
    long_state = init_state(gpt2_124m_long())
    path_counts["train_sparse"] = run_phase("train_sparse",
                                            phase_train_sparse, long_state)
    path_counts["train_longseq"] = run_phase("train_longseq",
                                             phase_train_longseq, long_state)
    del long_state

    medium_state = init_state(gpt2_medium())
    run_phase("train_remat_grads", phase_train_remat_grads, medium_state)
    path_counts["train_medium"] = run_phase("train_medium",
                                            phase_train_medium, medium_state)
    del medium_state
    large_state = init_state(gpt2_large())
    path_counts["train_large"], large = run_phase(
        "train_large", phase_train_large, large_state)
    path_counts["train_fused_large"], replays_traced["train_fused_large"] = \
        run_phase("train_fused_large", phase_train_fused_large, large_state,
                  large)
    del large_state

    path_counts["fcm"] = run_phase("fcm_ops", phase_fcm_ops)
    run_phase("fcm_timing", phase_fcm_timing)

    kernels = []
    for kern in KERNELS:
        res = primary[kern.name]
        by_path = {path: counts[kern.name]
                   for path, counts in path_counts.items()}
        kernels.append({
            "name": kern.name, "route": "cuda", "source": kern.source,
            "replaces": kern.replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "replay_launches_traced_by_path": {
                path: traced.get(kern.name, 0)
                for path, traced in replays_traced.items()},
            "case": res["case"],
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": res["library_ms"],
            "host_us": res["host_us"]})
    print(card, flush=True)
    emit({"kernels": kernels})
    last_line()


if __name__ == "__main__":
    main()
