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
// Bound on the H100.  A forward step at GPT-2 124M's c_fc (m = 2048,
// kc = 192, n = 3072) does 2.4 GFLOP and moves the 25 MB fp32 accumulator
// in and out: at 3.35 TB/s that is 15 us, against 2.4 us for the products
// at the bf16 tensor-core peak, so the accumulator's bytes bound it.  The
// transposed step (g [2048, 3072] @ deq^T into a [2048, 192] block) does
// the same operations on ~14 MB, and the tensor cores bound it.
//
// Two routes, chosen by the dtype of x (or g):
//
// bf16, tensor cores (tile_mma.cuh: the payload staged as it lies and
//   dequantized in shared memory into hi / lo bf16 halves, so that the
//   fp32 dequant of the TPU kernel survives the bf16 products; mma.sync
//   from a three-stage cp.async ring).  The forward step's 64 x 128 output
//   tiles leave through shared memory as 16-byte vectors: the accumulator
//   is read (not on the first step) and written (not on the last) once
//   each, coalesced.  The transposed step's output is only kc = 192 wide,
//   so 64 x 64 tiles give 96 blocks for 132 SMs: the wrapper splits K
//   (= n) so that at least two blocks per SM run, the blocks write fp32
//   partials to a workspace the wrapper allocates, and a second pass sums
//   them in split order and casts once (deterministic; no atomics).
//
// fp32, CUDA cores (tile_matmul.cuh, the first design, kept as it was): a
//   tensor-core fp32 product would be TF32 and miss the fp32 parity.  The
//   first step does not read the accumulator and the last does not write
//   it, so W steps move it 2 (W - 1) times and not 2 W; the transposed form
//   keeps no accumulator at all, since its column blocks are disjoint.

#include "tile_mma.cuh"

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
  const float* acc_in = read_acc ? static_cast<const float*>(acc) : nullptr;
  void* dst = out != nullptr ? out : acc;
  const int dst_dtype = out != nullptr ? out_dtype : DS_DTYPE_FP32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == DS_DTYPE_BF16) {
    const int esize = dst_dtype == DS_DTYPE_BF16 ? 2 : 4;
    const bool vec = n % 4 == 0 && ds_tmma::aligned16(dst) &&
                     (acc_in == nullptr || ds_tmma::aligned16(acc_in)) && (n * esize) % 16 == 0;
    const ds_tmma::TileStore st{acc_in, dst, n, dst_dtype, vec};
    return ds_tmma::launch_weight_product_mma<false>(x, ldx, wa, st, m, nullptr, 1, s);
  }
  const StoreEpilogue ep{acc_in, dst, n, dst_dtype};
  return launch_weight_product_any<false>(x, ldx, x_dtype, wa, ep, m, s);
}

// out points at the column block of dx [m, K] for this step's source;
// ld_out is dx's row pitch.  bf16 g: K (= n) is split `splits` ways, the
// partials going to `work` [splits, m, kc] fp32 (null when splits is 1);
// fp32 g ignores both.
extern "C" int ds_fcm_ag_step_t(const void* g, int64_t ldg, int g_dtype, const void* w,
                                const void* scale, int mode, int w_dtype, int bs, void* out,
                                int64_t ld_out, int out_dtype, int m, int kc, int n,
                                void* work, int splits, void* stream) {
  if (out_dtype != DS_DTYPE_FP32 && out_dtype != DS_DTYPE_BF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const WeightArgs wa{w, static_cast<const float*>(scale), mode, w_dtype, bs, kc, n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_dtype == DS_DTYPE_BF16) {
    const int esize = out_dtype == DS_DTYPE_BF16 ? 2 : 4;
    const bool vec = kc % 4 == 0 && ds_tmma::aligned16(out) && (ld_out * esize) % 16 == 0;
    const ds_tmma::TileStore st{nullptr, out, ld_out, out_dtype, vec};
    return ds_tmma::launch_weight_product_mma<true>(g, ldg, wa, st, m,
                                                    static_cast<float*>(work), splits, s);
  }
  const StoreEpilogue ep{nullptr, out, ld_out, out_dtype};
  return launch_weight_product_any<true>(g, ldg, g_dtype, wa, ep, m, s);
}
