// Kernel D: LayerNorm backward over the last dimension.
//
// Replaces: deepspeed_tpu/ops/normalize.py layer_norm_bwd_pallas
// (_ln_bwd_kernel).  Same math: recompute mean and rstd in fp32 (two
// passes, as the forward), x_hat = (x - mean) * rstd, then
//   dx = (dy*g - mean(dy*g) - x_hat * mean(dy*g*x_hat)) * rstd  (x's dtype),
//   dgamma = sum over rows of dy * x_hat,  dbeta = sum over rows of dy (fp32).
//
// On the TPU the grid runs in order and accumulates dgamma / dbeta into one
// block.  Here blocks run in parallel, so the column sums take two passes
// with no atomics, in a fixed order, which keeps a training run bitwise
// repeatable: pass 1 gives each block 32 rows (4 per warp); a warp adds its
// rows' dy * x_hat and dy into its own shared-memory row, and the block
// adds its 8 warp rows in order into one row of an fp32 [blocks, hidden]
// workspace.  Pass 2 (one thread per column) adds the workspace rows in
// order.
//
// Bound on the H100: bytes.  It reads x and dy once and writes dx once
// (6 B/element in bf16, 12 in fp32), ~20 operations per element, far below
// the ~295 operations per byte at which the tensor cores would bound it;
// at [8192, 768] bf16 that is 37.7 MB, ~11 us.  One warp per row, as the
// forward: the row's statistics are warp-shuffle sums, and its x and dy
// (3 KB in bf16 at hidden 768) stay in L1 between the passes, so device
// memory sees each once.  The workspace adds 2 * blocks * hidden * 4 bytes
// (1.5 MB at the training shape) written once and read once.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
// ops/normalize.py LN_BWD_ROWS_PER_BLOCK sizes the workspaces with it
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const T* __restrict__ dy, T* __restrict__ dx,
              float* __restrict__ part_dg, float* __restrict__ part_db,
              int rows, int hidden, float eps) {
  extern __shared__ float smem[];  // [kWarps][hidden] dg, then db
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* wdg = smem + warp * hidden;
  float* wdb = smem + (kWarps + warp) * hidden;
  for (int i = lane; i < hidden; i += 32) {
    wdg[i] = 0.f;
    wdb[i] = 0.f;
  }
  const float inv_n = 1.f / hidden;

  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp + rr;
    if (row >= rows) break;  // uniform over the warp
    const T* xr = x + static_cast<size_t>(row) * hidden;
    const T* dyr = dy + static_cast<size_t>(row) * hidden;
    T* dxr = dx + static_cast<size_t>(row) * hidden;

    float sum = 0.f;
    for (int i = lane; i < hidden; i += 32) sum += ds_to_float(xr[i]);
    const float mean = ds_warp_sum(sum) * inv_n;
    float sq = 0.f;
    for (int i = lane; i < hidden; i += 32) {
      const float d = ds_to_float(xr[i]) - mean;
      sq += d * d;
    }
    const float rstd = rsqrtf(ds_warp_sum(sq) * inv_n + eps);

    float s1 = 0.f, s2 = 0.f;
    for (int i = lane; i < hidden; i += 32) {
      const float xhat = (ds_to_float(xr[i]) - mean) * rstd;
      const float d = ds_to_float(dyr[i]);
      const float dyg = d * gamma[i];
      s1 += dyg;
      s2 += dyg * xhat;
      wdg[i] += d * xhat;
      wdb[i] += d;
    }
    const float m1 = ds_warp_sum(s1) * inv_n;
    const float m2 = ds_warp_sum(s2) * inv_n;

    for (int i = lane; i < hidden; i += 32) {
      const float xhat = (ds_to_float(xr[i]) - mean) * rstd;
      const float dyg = ds_to_float(dyr[i]) * gamma[i];
      dxr[i] = ds_from_float<T>((dyg - m1 - xhat * m2) * rstd);
    }
  }
  __syncthreads();

  float* out_dg = part_dg + static_cast<size_t>(blockIdx.x) * hidden;
  float* out_db = part_db + static_cast<size_t>(blockIdx.x) * hidden;
  for (int i = threadIdx.x; i < hidden; i += kThreads) {
    float g = 0.f, bsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      g += smem[w * hidden + i];
      bsum += smem[(kWarps + w) * hidden + i];
    }
    out_dg[i] = g;
    out_db[i] = bsum;
  }
}

__global__ void __launch_bounds__(kThreads)
ln_bwd_reduce_kernel(const float* __restrict__ part_dg,
                     const float* __restrict__ part_db,
                     float* __restrict__ dgamma, float* __restrict__ dbeta,
                     int blocks, int hidden) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= hidden) return;
  float g = 0.f, bsum = 0.f;
  for (int blk = 0; blk < blocks; ++blk) {
    g += part_dg[static_cast<size_t>(blk) * hidden + col];
    bsum += part_db[static_cast<size_t>(blk) * hidden + col];
  }
  dgamma[col] = g;
  dbeta[col] = bsum;
}

template <typename T>
int launch(const void* x, const float* gamma, const void* dy, void* dx,
           float* part_dg, float* part_db, float* dgamma, float* dbeta,
           int rows, int hidden, float eps, cudaStream_t stream) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const size_t smem = static_cast<size_t>(2 * kWarps) * hidden * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ln_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_bwd_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), gamma, static_cast<const T*>(dy),
      static_cast<T*>(dx), part_dg, part_db, rows, hidden, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_bwd_reduce_kernel<<<(hidden + kThreads - 1) / kThreads, kThreads, 0,
                         stream>>>(part_dg, part_db, dgamma, dbeta, blocks,
                                   hidden);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ds_layer_norm_bwd(const void* x, const void* gamma,
                                 const void* dy, void* dx, void* part_dg,
                                 void* part_db, void* dgamma, void* dbeta,
                                 int rows, int hidden, float eps, int dtype,
                                 void* stream) {
  const float* g = static_cast<const float*>(gamma);
  float* pg = static_cast<float*>(part_dg);
  float* pb = static_cast<float*>(part_db);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DS_DTYPE_BF16) {
    return launch<__nv_bfloat16>(x, g, dy, dx, pg, pb, dg, db, rows, hidden,
                                 eps, s);
  }
  if (dtype == DS_DTYPE_FP32) {
    return launch<float>(x, g, dy, dx, pg, pb, dg, db, rows, hidden, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
