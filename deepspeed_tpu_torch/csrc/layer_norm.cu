// Kernel A: LayerNorm forward over the last dimension, fp32 statistics.
//
// Replaces: deepspeed_tpu/ops/normalize.py layer_norm_pallas (_ln_kernel):
//   y = (x - mean) * rsqrt(var + eps) * gamma + beta, mean and var in fp32,
//   y cast to x's dtype.
//
// Bound on the H100: bytes.  It reads each x once and writes each y once
// (4 B/element in bf16, 8 in fp32) and does ~8 operations per element, far
// below the ~295 operations per byte at which the tensor cores would bound
// it.  At decode's 8 rows it is latency: one round trip to HBM and the
// row's two sums.
//
// Design (layer_norm_row.cuh): each row is read from HBM once into the
// registers of the threads that own it, in 16-byte packs, the next row's
// loads issued before this row's sums; the mean and the variance of the
// deviations come from the registers (two warp-shuffle sums, a fixed-order
// shared-memory step when a row spans several warps), and y is written in
// 16-byte packs.  Each thread loads its columns of gamma and beta once, in
// their own dtype (bf16 in training, fp32 in serving, fp16 in an fp16 run),
// widened to fp32 in registers as the Pallas kernel's astype(float32), so
// the wrapper launches no cast.  Few rows take one row a block: decode's 8 rows run on
// 8 SMs, prefill's 1024 on 256 blocks.

#include "layer_norm_row.cuh"

namespace {

using ds_ln::Lane;
using ds_ln::Pack;

template <typename T, typename P, int VEC, int PER>
__global__ void __launch_bounds__(ds_ln::kMaxRowThreads)
ln_fwd_kernel(const T* __restrict__ x, const P* __restrict__ gamma,
              const P* __restrict__ beta, T* __restrict__ out, int rows, int hidden, int tpr,
              int slots, int rps, float eps) {
  __shared__ float red[2][ds_ln::kMaxWarps * 2];
  const Lane l(tpr);
  Pack<P, VEC> gp[PER], bp[PER];
  ds_ln::load_params(gp, gamma, hidden, tpr, l.t);
  ds_ln::load_params(bp, beta, hidden, tpr, l.t);
  // rows first, first + slots, ...; the next row's x is loaded before this
  // row's sums, so a warp keeps two rows' loads in flight
  int row = blockIdx.x * slots * rps + l.slot;
  bool live = row < rows;
  Pack<T, VEC> xp[PER], xn[PER];
  ds_ln::load_row(xp, x + static_cast<size_t>(live ? row : 0) * hidden, hidden, tpr, l.t, live);
  for (int i = 0; i < rps; ++i) {
    const int next = row + slots;
    const bool next_live = i + 1 < rps && next < rows;
    if (i + 1 < rps)
      ds_ln::load_row(xn, x + static_cast<size_t>(next_live ? next : 0) * hidden, hidden, tpr,
                      l.t, next_live);
    float mean, rstd;
    ds_ln::row_stats(xp, hidden, tpr, l, eps, red[0], red[1], mean, rstd);
    ds_ln::pin(gp);
    ds_ln::pin(bp);
    if (live) {
      const size_t off = static_cast<size_t>(row) * hidden;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int c = (j * tpr + l.t) * VEC;
        if (c < hidden) {
          float y[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            y[e] = (xp[j].get(e) - mean) * rstd * gp[j].get(e) + bp[j].get(e);
          ds_ln::store_pack(out + off + c, y);
        }
      }
    }
    if (i + 1 < rps) {
#pragma unroll
      for (int j = 0; j < PER; ++j) xp[j] = xn[j];
    }
    row = next;
    live = next_live;
  }
}

// A row wider than kMaxRowThreads threads' registers: a block takes rows
// blockIdx.x * rps, ... one after another, each pass re-reading the row
// (its second and third reads come from L2).
template <typename T, typename P>
__global__ void __launch_bounds__(ds_ln::kStreamThreads)
ln_fwd_streamed_kernel(const T* __restrict__ x, const P* __restrict__ gamma,
                       const P* __restrict__ beta, T* __restrict__ out, int rows, int hidden,
                       int rps, float eps) {
  __shared__ float red[2][ds_ln::kMaxWarps * 2];
  const int tpr = blockDim.x;
  const Lane l(tpr);
  const float inv_n = 1.f / hidden;
  for (int i = 0; i < rps; ++i) {
    const int row = blockIdx.x * rps + i;
    if (row >= rows) break;  // the same row for the whole block
    const T* xr = x + static_cast<size_t>(row) * hidden;
    T* yr = out + static_cast<size_t>(row) * hidden;
    float s[1];
    ds_ln::streamed_sum(s, hidden, l, tpr, red[0],
                        [&](int c, float (&v)[1]) { v[0] += ds_to_float(xr[c]); });
    const float mean = s[0] * inv_n;
    ds_ln::streamed_sum(s, hidden, l, tpr, red[1], [&](int c, float (&v)[1]) {
      const float d = ds_to_float(xr[c]) - mean;
      v[0] += d * d;
    });
    const float rstd = rsqrtf(s[0] * inv_n + eps);
    for (int c = l.t; c < hidden; c += tpr) {
      const float y = (ds_to_float(xr[c]) - mean) * rstd;
      yr[c] = ds_from_float<T>(y * ds_to_float(gamma[c]) + ds_to_float(beta[c]));
    }
  }
}

template <typename T, typename P>
int launch_fwd(const ds_ln::Plan& p, const void* x, const void* gamma, const void* beta,
               void* out, int rows, int hidden, float eps, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const P* g = static_cast<const P*>(gamma);
  const P* b = static_cast<const P*>(beta);
  T* o = static_cast<T*>(out);
  return ds_ln::dispatch<T>(p, [&](auto vec, auto per) {
    constexpr int V = decltype(vec)::value, N = decltype(per)::value;
    if constexpr (N == 0) {
      ln_fwd_streamed_kernel<T, P><<<p.blocks, p.tpr, 0, s>>>(xt, g, b, o, rows, hidden,
                                                               p.rps, eps);
    } else {
      ln_fwd_kernel<T, P, V, N><<<p.blocks, p.slots * p.tpr, 0, s>>>(
          xt, g, b, o, rows, hidden, p.tpr, p.slots, p.rps, eps);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

// gamma and beta of dtype code `pdtype` (fp32, bf16 or fp16) beside x of T.
template <typename T>
int launch_fwd_params(int pdtype, const ds_ln::Plan& p, const void* x, const void* gamma,
                      const void* beta, void* out, int rows, int hidden, float eps,
                      cudaStream_t s) {
  switch (pdtype) {
    case DS_DTYPE_FP32:
      return launch_fwd<T, float>(p, x, gamma, beta, out, rows, hidden, eps, s);
    case DS_DTYPE_BF16:
      return launch_fwd<T, __nv_bfloat16>(p, x, gamma, beta, out, rows, hidden, eps, s);
    case DS_DTYPE_FP16:
      return launch_fwd<T, __half>(p, x, gamma, beta, out, rows, hidden, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The plan of kernel A (backward 0) or D (1) for x [rows, hidden] of dtype
// code `dtype`, into plan[6]: route, threads a row, packs a thread, slots,
// rows a slot, blocks (ops/normalize.py layer_norm_plan).  Launches nothing.
extern "C" int ds_layer_norm_plan(int rows, int hidden, int dtype, int aligned, int backward,
                                  int* plan) {
  const ds_ln::Plan p = ds_ln::plan(rows, hidden, dtype, aligned != 0, backward != 0);
  plan[0] = p.route;
  plan[1] = p.tpr;
  plan[2] = p.per;
  plan[3] = p.slots;
  plan[4] = p.rps;
  plan[5] = p.blocks;
  return 0;
}

// x [rows, hidden] and out in x's dtype (bf16 or fp32), gamma and beta
// [hidden] in theirs (fp32, bf16 or fp16); `launch` the wrapper's array
// (ds_ln::LaunchField), refused unless its plan is this launcher's.
extern "C" int ds_layer_norm_fwd(const void* x, const void* gamma, const void* beta, void* out,
                                 float eps, const int* launch, void* stream) {
  const bool aligned = ds_ln::aligned16(x) && ds_ln::aligned16(out) &&
                       ds_ln::aligned16(gamma) && ds_ln::aligned16(beta);
  ds_ln::Plan p;
  if (!ds_ln::launch_plan(launch, aligned, false, p))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = launch[ds_ln::kRows], hidden = launch[ds_ln::kHidden];
  const int dtype = launch[ds_ln::kDtype], pdtype = launch[ds_ln::kParamDtype];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DS_DTYPE_BF16)
    return launch_fwd_params<__nv_bfloat16>(pdtype, p, x, gamma, beta, out, rows, hidden, eps,
                                            s);
  if (dtype == DS_DTYPE_FP32)
    return launch_fwd_params<float>(pdtype, p, x, gamma, beta, out, rows, hidden, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
