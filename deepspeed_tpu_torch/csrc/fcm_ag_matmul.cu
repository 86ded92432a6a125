// Kernel I: one step of the fused dequant-all-gather-matmul.
//
// Replaces: deepspeed_tpu/ops/collective_matmul.py _ag_matmul_tpu, the
// single TPU kernel that computes x @ all_gather(w) (and the transposed dx
// form) in W steps: the quantized shard circulates a ring into two slots
// while the step's product runs, an fp32 accumulator is carried across the
// steps, the dequant happens per step, and the output is cast once.  On the
// GPU the ring is host code (ops/collective_matmul.py _ag_matmul_fused: a
// copy stream, two slots, events both ways) and this file is the step: the
// product of the slot that has arrived, accumulated into the caller-held
// fp32 accumulator, the last step writing the sum in the output's dtype
// instead; or, transposed, written into the output's column block
// src * kc.  Same numerics as the TPU kernel: fp32 product and carry, one
// cast.
//
// Bound on the H100: operations.  A forward step at GPT-2 124M's c_fc
// (m = 2048, kc = 192, n = 3072) does 2.4 GFLOP and moves the 25 MB
// accumulator in and out (about 47 operations per byte), above the fp32
// ridge of 20 at which the CUDA cores multiply; c_proj's steps (kc = 768,
// n = 768) reach 190 per byte.  What the design does about it: the shared
// core of tile_matmul.cuh; the first step does not read the accumulator and
// the last does not write it, so W steps move it 2 (W - 1) times and not
// 2 W; the transposed form keeps no accumulator at all, since its column
// blocks are disjoint.  Tensor cores are later work.

#include "tile_matmul.cuh"

using namespace ds_tile;

// acc [m, n] fp32: read when read_acc, written unless `out` is given; `out`
// [m, n] in out_dtype is written by the last step.
extern "C" int ds_fcm_ag_step(const void* x, int64_t ldx, int x_dtype, const void* w,
                              const void* scale, int mode, int w_dtype, int bs, void* acc,
                              void* out, int out_dtype, int read_acc, int m, int kc, int n,
                              void* stream) {
  if ((acc == nullptr && (read_acc || out == nullptr)) ||
      (out != nullptr && out_dtype != DS_DTYPE_FP32 && out_dtype != DS_DTYPE_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const WeightArgs wa{w, static_cast<const float*>(scale), mode, w_dtype, bs, kc, n};
  const StoreEpilogue ep{read_acc ? static_cast<const float*>(acc) : nullptr,
                         out != nullptr ? out : acc, n,
                         out != nullptr ? out_dtype : DS_DTYPE_FP32};
  return launch_weight_product_any<false>(x, ldx, x_dtype, wa, ep, m,
                                          static_cast<cudaStream_t>(stream));
}

// out points at the column block of dx [m, K] for this step's source;
// ld_out is dx's row pitch.
extern "C" int ds_fcm_ag_step_t(const void* g, int64_t ldg, int g_dtype, const void* w,
                                const void* scale, int mode, int w_dtype, int bs, void* out,
                                int64_t ld_out, int out_dtype, int m, int kc, int n,
                                void* stream) {
  if (out_dtype != DS_DTYPE_FP32 && out_dtype != DS_DTYPE_BF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const WeightArgs wa{w, static_cast<const float*>(scale), mode, w_dtype, bs, kc, n};
  const StoreEpilogue ep{nullptr, out, ld_out, out_dtype};
  return launch_weight_product_any<true>(g, ldg, g_dtype, wa, ep, m,
                                         static_cast<cudaStream_t>(stream));
}
