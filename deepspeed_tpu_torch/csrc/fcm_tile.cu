// Kernel H: one ring step's tile of the fused collective-matmul, fp32 out.
//
// Replaces: deepspeed_tpu/ops/collective_matmul.py _tile_call over its three
// tile kernels: _ag_mm_tile_kernel (x[m, kc] @ deq(q, s)[kc, n]),
// _ag_mm_tile_t_kernel (g[m, n] @ deq(q, s)^T) and _rs_mm_tile_kernel
// (a[b, kc]^T @ b[b, n]), with _dequant_tile inside the kernel.  Same
// numerics: operands widened to fp32, the payload dequantized by one fp32
// multiply with its block's scale, fp32 accumulation, a fresh fp32 partial
// out.  The per-tile route of fused_allgather_matmul and
// fused_matmul_reduce_scatter launches it once per hop (or destination)
// and combines the partials itself.
//
// Bound on the H100: operations.  At GPT-2 124M's c_fc tile (m = 2048,
// kc = 192, n = 3072) a launch does 2.4 GFLOP on 1.4 MB of operands and a
// 25 MB fp32 partial: about 90 operations per byte moved, under the ~295 of
// the bf16 tensor-core ridge only because of the partial, and far above the
// 20 of the fp32 ridge at which this kernel's CUDA-core product runs.  What
// the design does about it: the shared core of tile_matmul.cuh (64 x 64
// tiles, a 4 x 4 patch per thread, float4 reads of shared memory); the
// dequant costs one multiply per weight element on the way into shared
// memory and no device-memory traffic.  Tensor cores are later work.

#include "tile_matmul.cuh"

using namespace ds_tile;

extern "C" int ds_fcm_tile_ag(const void* x, int64_t ldx, int x_dtype, const void* w,
                              const void* scale, int mode, int w_dtype, int bs, void* out,
                              int m, int kc, int n, void* stream) {
  const WeightArgs wa{w, static_cast<const float*>(scale), mode, w_dtype, bs, kc, n};
  const StoreEpilogue ep{nullptr, out, n, DS_DTYPE_FP32};
  return launch_weight_product_any<false>(x, ldx, x_dtype, wa, ep, m,
                                          static_cast<cudaStream_t>(stream));
}

extern "C" int ds_fcm_tile_ag_t(const void* g, int64_t ldg, int g_dtype, const void* w,
                                const void* scale, int mode, int w_dtype, int bs, void* out,
                                int m, int kc, int n, void* stream) {
  const WeightArgs wa{w, static_cast<const float*>(scale), mode, w_dtype, bs, kc, n};
  const StoreEpilogue ep{nullptr, out, kc, DS_DTYPE_FP32};
  return launch_weight_product_any<true>(g, ldg, g_dtype, wa, ep, m,
                                         static_cast<cudaStream_t>(stream));
}

extern "C" int ds_fcm_tile_rs(const void* a, int64_t lda, int a_dtype, const void* b,
                              int64_t ldb, int b_dtype, void* out, int bdim, int kc, int n,
                              void* stream) {
  const StoreEpilogue ep{nullptr, out, n, DS_DTYPE_FP32};
  return launch_at_b_any<64, 64>(a, lda, a_dtype, b, ldb, b_dtype, ep, bdim, kc, n,
                                 static_cast<cudaStream_t>(stream));
}
