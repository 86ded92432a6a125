// Kernel A: LayerNorm forward over the last dimension, fp32 statistics.
//
// Replaces: deepspeed_tpu/ops/normalize.py layer_norm_pallas (_ln_kernel):
//   y = (x - mean) * rsqrt(var + eps) * gamma + beta, mean and var in fp32,
//   y cast to x's dtype.
//
// Bound on the H100: bytes.  It reads each x once and writes each y once
// (4 B/element in bf16, 8 in fp32) and does ~8 operations per element, far
// below the ~295 operations per byte at which the tensor cores would bound
// it.  Design: one warp per row, so the statistics are warp-shuffle sums
// with no shared memory and no block barrier; the row is small enough
// (hidden 768 = 1.5 KB in bf16) that its second and third reads come from
// L1, so device memory sees one read and one write.  Lanes walk the row
// with stride 32, which keeps every load and store coalesced.  Eight rows
// per 256-thread block.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, T* __restrict__ out, int rows,
              int hidden, float eps) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // uniform over the warp
  const T* xr = x + static_cast<size_t>(row) * hidden;
  T* yr = out + static_cast<size_t>(row) * hidden;

  float sum = 0.f;
  for (int i = lane; i < hidden; i += 32) sum += ds_to_float(xr[i]);
  const float mean = ds_warp_sum(sum) / hidden;

  float sq = 0.f;
  for (int i = lane; i < hidden; i += 32) {
    const float d = ds_to_float(xr[i]) - mean;
    sq += d * d;
  }
  const float rstd = rsqrtf(ds_warp_sum(sq) / hidden + eps);

  for (int i = lane; i < hidden; i += 32) {
    const float y = (ds_to_float(xr[i]) - mean) * rstd;
    yr[i] = ds_from_float<T>(y * gamma[i] + beta[i]);
  }
}

}  // namespace

extern "C" int ds_layer_norm_fwd(const void* x, const void* gamma,
                                 const void* beta, void* out, int rows,
                                 int hidden, float eps, int dtype,
                                 void* stream) {
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  if (dtype == DS_DTYPE_BF16) {
    ln_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), g, b,
        static_cast<__nv_bfloat16*>(out), rows, hidden, eps);
  } else if (dtype == DS_DTYPE_FP32) {
    ln_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), g, b, static_cast<float*>(out), rows,
        hidden, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
