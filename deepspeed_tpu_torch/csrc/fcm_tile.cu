// Kernel H: one ring step's tile of the fused collective-matmul, fp32 out.
//
// Replaces: deepspeed_tpu/ops/collective_matmul.py _tile_call over its three
// tile kernels: _ag_mm_tile_kernel (x[m, kc] @ deq(q, s)[kc, n]),
// _ag_mm_tile_t_kernel (g[m, n] @ deq(q, s)^T) and _rs_mm_tile_kernel
// (a[b, kc]^T @ b[b, n]), with _dequant_tile inside the kernel.  Same
// function: the payload dequantized by one fp32 multiply with its block's
// scale, products summed in fp32, a fresh fp32 partial out.  The per-tile
// route of fused_allgather_matmul and fused_matmul_reduce_scatter launches
// it once per hop (or destination) and combines the partials itself.
//
// Bound on the H100.  At GPT-2 124M's c_fc tile (m = 2048, kc = 192,
// n = 3072) each launch does 2.4 GFLOP, 2.4 us at the 989 TFLOP/s bf16
// tensor-core peak.  The forward tile writes a 25 MB fp32 partial (7.9 us
// at 3.35 TB/s): the bytes bound it.  The transposed tile (g [2048, 3072]
// in, [2048, 192] out) and the producer tile (a [2048, 192] and
// b [2048, 3072] in, [192, 3072] out) move ~14 and ~16 MB, 4.4 and 4.7 us:
// the bytes bound them too, by less.
//
// Two routes, chosen by the left operands' dtype, as kernels I and J
// choose (ops/collective_matmul.py fcm_route):
//
// bf16 x or g, bf16 a and b: tensor cores, the cores of kernels I and J
//   (tile_mma.cuh).  ag and ag_t run wprod_mma_kernel: the payload is
//   staged as it lies through a three-stage cp.async ring and dequantized
//   in shared memory into bf16 hi + lo halves, so that the fp32 dequant
//   survives the bf16 products; mma.sync m16n8k16 into fp32 sums; the
//   64 x 128 forward tiles (768 blocks at c_fc) write the fp32 partial
//   through shared memory as 16-byte vectors, with no accumulator to read.
//   The transposed tile's output is only kc wide (96 tiles of 64 x 64 for
//   132 SMs), so the wrapper splits K (= n) over blocks (split_plan: 3
//   parts at c_fc) into an fp32 workspace it allocates, and
//   split_sum_kernel adds the parts in split order into the fresh [m, kc].
//   The producer tile runs at_b_mma_kernel, A[k][m] = a[k][m] read through
//   ldmatrix.trans, with K (= the rows of a and b) split the same way (4
//   parts at c_fc) and summed by split_sum_kernel; with one part the
//   kernel writes `out` itself.  Every launch repeats bitwise: the sums
//   take a fixed order, with no atomics.
//
// fp32 or mixed operands: CUDA cores (tile_matmul.cuh, 64 x 64 tiles, a
//   4 x 4 patch per thread): a tensor-core fp32 product would be TF32 and
//   miss the fp32 parity.

#include "tile_mma.cuh"

using namespace ds_tile;

namespace {

// The fp32 [M, N] partial `out` (row pitch N) as a tile_mma.cuh store.
ds_tmma::TileStore fresh_fp32(void* out, int N) {
  return ds_tmma::TileStore{nullptr, out, N, DS_DTYPE_FP32,
                            N % 4 == 0 && ds_tmma::aligned16(out)};
}

}  // namespace

extern "C" int ds_fcm_tile_ag(const void* x, int64_t ldx, int x_dtype, const void* w,
                              const void* scale, int mode, int w_dtype, int bs, void* out,
                              int m, int kc, int n, void* stream) {
  const WeightArgs wa{w, static_cast<const float*>(scale), mode, w_dtype, bs, kc, n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == DS_DTYPE_BF16)
    return ds_tmma::launch_weight_product_mma<false>(x, ldx, wa, fresh_fp32(out, n), m, nullptr,
                                                     1, s);
  const StoreEpilogue ep{nullptr, out, n, DS_DTYPE_FP32};
  return launch_weight_product_any<false>(x, ldx, x_dtype, wa, ep, m, s);
}

// bf16 g: K (= n) is split `splits` ways, the partials going to `work`
// [splits, m, kc] fp32 (null when splits is 1); fp32 g ignores both.
extern "C" int ds_fcm_tile_ag_t(const void* g, int64_t ldg, int g_dtype, const void* w,
                                const void* scale, int mode, int w_dtype, int bs, void* out,
                                int m, int kc, int n, void* work, int splits, void* stream) {
  const WeightArgs wa{w, static_cast<const float*>(scale), mode, w_dtype, bs, kc, n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_dtype == DS_DTYPE_BF16)
    return ds_tmma::launch_weight_product_mma<true>(g, ldg, wa, fresh_fp32(out, kc), m,
                                                    static_cast<float*>(work), splits, s);
  const StoreEpilogue ep{nullptr, out, kc, DS_DTYPE_FP32};
  return launch_weight_product_any<true>(g, ldg, g_dtype, wa, ep, m, s);
}

// bf16 a and b: the rows (bdim) are split `splits` ways, the partials going
// to `work` [splits, kc, n] fp32 (null when splits is 1: the kernel writes
// `out`); any other pair ignores both.
extern "C" int ds_fcm_tile_rs(const void* a, int64_t lda, int a_dtype, const void* b,
                              int64_t ldb, int b_dtype, void* out, int bdim, int kc, int n,
                              void* work, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_dtype == DS_DTYPE_BF16 && b_dtype == DS_DTYPE_BF16) {
    if (splits < 1 || (splits > 1 && work == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    float* dst = static_cast<float*>(splits > 1 ? work : out);
    int parts = 0;
    const int e = ds_tmma::launch_at_b_mma(a, lda, b, ldb, dst, kc, n, bdim, splits, &parts, s);
    if (e != 0 || dst == out) return e;
    const int64_t total = static_cast<int64_t>(kc) * n;
    const int blocks = static_cast<int>((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
    ds_tmma::split_sum_kernel<<<blocks, 256, 0, s>>>(dst, parts, kc, n, fresh_fp32(out, n));
    return static_cast<int>(cudaGetLastError());
  }
  const StoreEpilogue ep{nullptr, out, n, DS_DTYPE_FP32};
  return launch_at_b_any<64, 64>(a, lda, a_dtype, b, ldb, b_dtype, ep, bdim, kc, n, s);
}
