// Kernel D: LayerNorm backward over the last dimension.
//
// Replaces: deepspeed_tpu/ops/normalize.py layer_norm_bwd_pallas
// (_ln_bwd_kernel).  Same math: recompute mean and rstd in fp32 (two
// passes, as the forward), x_hat = (x - mean) * rstd, then
//   dx = (dy*g - mean(dy*g) - x_hat * mean(dy*g*x_hat)) * rstd  (x's dtype),
//   dgamma = sum over rows of dy * x_hat,  dbeta = sum over rows of dy,
// summed in fp32 and rounded once into gamma's dtype (fp32, bf16, or fp16
// in an fp16 run: the JAX op's dgamma.astype(gamma.dtype)).
//
// Bound on the H100: bytes.  It reads x and dy once and writes dx once
// (6 B/element in bf16, 12 in fp32), ~20 operations per element, far below
// the ~295 operations per byte at which the tensor cores would bound it;
// at [8192, 768] bf16 that is 37.7 MB, ~11 us.
//
// Design (layer_norm_row.cuh): each row's x and dy are read from HBM once,
// in 16-byte packs, into the registers of the threads that own its
// columns; a row takes two register sums, (sum x, sum dy*g) and then,
// about the mean, (sum (x - mean)^2, sum dy*g*(x - mean)), whose second
// term times rstd is the reference's sum dy*g*x_hat.  gamma is loaded once
// per thread in its own dtype.  On the vector route a slot keeps the next
// two rows of x and dy in flight through a ring of shared memory filled by
// cp.async (each thread copies and reads back only its own packs, so no
// barrier guards it); the scalar route loads the next row into registers.
// At the train step's rows the ring ran twice as fast as holding the next
// row in registers, which spilled (a sweep on the H100; PERF.md §6).
//
// On the TPU the grid runs in order and accumulates dgamma / dbeta into one
// block; here blocks run in parallel, so the column sums take two
// launches, in a fixed order with no atomics, which keeps a training run
// bitwise repeatable:
// - ln_bwd_kernel: each thread adds dy * x_hat and dy for its own columns
//   over the rows it takes (a slot's `rps` rows), in registers; a block with
//   several slots adds them in slot order through shared memory, and each
//   block writes one row [dgamma | dbeta] of an fp32 workspace [chunks, 2,
//   hidden].  The row partition (chunks = blocks) depends on rows and
//   hidden only (ds_ln::plan), never on the SM count;
// - ln_bwd_cols_kernel: 8 columns of [dgamma | dbeta] a block (192 blocks
//   at hidden 768: more than one wave of the 132 SMs), its 32 thread groups
//   summing interleaved workspace rows, then the groups in a fixed tree;
//   each sum rounded once into gamma's dtype.  It is launched while
//   ln_bwd_kernel runs (programmatic dependent launch) and waits for it on
//   the device, which hides its launch under the first kernel's tail.
// No column sum lives in per-warp shared-memory rows, so every hidden size
// runs (the fault of the first design, which kept two fp32 rows per warp in
// shared memory and refused hidden > 3632).

#include "layer_norm_row.cuh"

namespace {

using ds_ln::Lane;
using ds_ln::Pack;

constexpr int kColsPerBlock = 8;
constexpr int kColGroups = 32;
// rows of x and dy a slot keeps in flight through shared memory (the vector
// route)
constexpr int kRingStages = 3;
constexpr int kMaxDevices = 64;

// One row of the backward from the thread's packs: dx written to dxr (null
// for a dead row), dy * x_hat and dy added into the thread's column sums.
template <typename T, typename P, int VEC, int PER>
__device__ __forceinline__ void bwd_row(Pack<T, VEC> (&xp)[PER], Pack<T, VEC> (&dp)[PER],
                                        Pack<P, VEC> (&gp)[PER], float (&dg)[PER][VEC],
                                        float (&db)[PER][VEC], T* dxr, int hidden, int tpr,
                                        const Lane& l, float eps, float* red0, float* red1) {
  const float inv_n = 1.f / hidden;
  // two sums a row: (sum x, sum dy*g), then, about the mean,
  // (sum (x - mean)^2, sum dy*g*(x - mean)); dy is 0 past hidden and on a
  // dead row, so only the squares need the column mask
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < PER; ++j) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      s[0] += xp[j].get(e);
      s[1] += dp[j].get(e) * gp[j].get(e);
    }
  }
  ds_ln::row_sum(s, red0, l);
  const float mean = s[0] * inv_n, m1 = s[1] * inv_n;
  ds_ln::pin(xp);
  ds_ln::pin(dp);
  ds_ln::pin(gp);
  float q[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const bool in = (j * tpr + l.t) * VEC < hidden;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float xc = xp[j].get(e) - mean;
      if (in) q[0] += xc * xc;
      q[1] += dp[j].get(e) * gp[j].get(e) * xc;
    }
  }
  ds_ln::row_sum(q, red1, l);
  const float rstd = rsqrtf(q[0] * inv_n + eps);
  const float m2 = q[1] * inv_n * rstd;
  ds_ln::pin(xp);
  ds_ln::pin(dp);
  ds_ln::pin(gp);
  // dx = (dy*g - m1 - x_hat * m2) * rstd = rstd * dy*g + (-m2 * rstd) *
  // x_hat - m1 * rstd: two multiply-adds
  const float k_xhat = -m2 * rstd, k_0 = -m1 * rstd;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = (j * tpr + l.t) * VEC;
    float v[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float xhat = (xp[j].get(e) - mean) * rstd;
      const float d = dp[j].get(e);
      dg[j][e] = fmaf(d, xhat, dg[j][e]);
      db[j][e] += d;
      v[e] = fmaf(rstd, d * gp[j].get(e), fmaf(k_xhat, xhat, k_0));
    }
    if (dxr != nullptr && c < hidden) ds_ln::store_pack(dxr + c, v);
  }
}

// STAGES == 0: the next row's x and dy are loaded into registers before
// this row's sums.  STAGES > 0 (the vector route): a ring of STAGES rows in
// shared memory, filled by cp.async STAGES - 1 rows ahead; each thread
// copies and reads back only its own packs, so no barrier guards the ring.
template <typename T, typename P, int VEC, int PER, int STAGES>
__global__ void __launch_bounds__(ds_ln::kMaxRowThreads)
ln_bwd_kernel(const T* __restrict__ x, const P* __restrict__ gamma, const T* __restrict__ dy,
              T* __restrict__ dx, float* __restrict__ ws, int rows, int hidden, int tpr,
              int slots, int rps, float eps) {
  // the ring, then (when slots > 1) the column sums [slots][hidden]
  extern __shared__ uint4 ln_smem[];
  __shared__ float red[2][ds_ln::kMaxWarps * 2];
  // the column-sum launch may start now; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const Lane l(tpr);
  Pack<P, VEC> gp[PER];
  ds_ln::load_params(gp, gamma, hidden, tpr, l.t);
  float dg[PER][VEC], db[PER][VEC];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) dg[j][e] = db[j][e] = 0.f;
  }
  // a slot's rows: first, first + slots, ...
  const int first = blockIdx.x * slots * rps + l.slot;
  if constexpr (STAGES == 0) {
    int row = first;
    bool live = row < rows;
    Pack<T, VEC> xp[PER], dp[PER], xn[PER], dn[PER];
    ds_ln::load_row(xp, x + static_cast<size_t>(live ? row : 0) * hidden, hidden, tpr, l.t,
                    live);
    ds_ln::load_row(dp, dy + static_cast<size_t>(live ? row : 0) * hidden, hidden, tpr, l.t,
                    live);
    for (int i = 0; i < rps; ++i) {
      const int next = row + slots;
      const bool next_live = i + 1 < rps && next < rows;
      if (i + 1 < rps) {
        const size_t noff = static_cast<size_t>(next_live ? next : 0) * hidden;
        ds_ln::load_row(xn, x + noff, hidden, tpr, l.t, next_live);
        ds_ln::load_row(dn, dy + noff, hidden, tpr, l.t, next_live);
      }
      bwd_row(xp, dp, gp, dg, db, live ? dx + static_cast<size_t>(row) * hidden : nullptr,
              hidden, tpr, l, eps, red[0], red[1]);
      if (i + 1 < rps) {
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          xp[j] = xn[j];
          dp[j] = dn[j];
        }
      }
      row = next;
      live = next_live;
    }
  } else {
    static_assert(VEC * sizeof(T) == 16, "the ring holds 16-byte packs");
    const int nthr = blockDim.x;
    // pack j of tensor k (x 0, dy 1) of stage st, for this thread
    auto slot = [&](int st, int k, int j) {
      return ln_smem + ((st * 2 + k) * PER + j) * nthr + threadIdx.x;
    };
    auto issue = [&](int i) {  // the slot's i-th row into stage i % STAGES
      const int row = first + i * slots;
      if (i < rps && row < rows) {
        const size_t off = static_cast<size_t>(row) * hidden;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const int c = (j * tpr + l.t) * VEC;
          const bool in = c < hidden;
          ds_ln::cp_async_16(slot(i % STAGES, 0, j), x + off + (in ? c : 0), in);
          ds_ln::cp_async_16(slot(i % STAGES, 1, j), dy + off + (in ? c : 0), in);
        }
      }
      ds_ln::cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) issue(i);
    for (int i = 0; i < rps; ++i) {
      issue(i + STAGES - 1);
      ds_ln::cp_async_wait<STAGES - 1>();
      const int row = first + i * slots;
      const bool live = row < rows;
      Pack<T, VEC> xp[PER], dp[PER];
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        if (live) {
          const uint4 u = *slot(i % STAGES, 0, j), w = *slot(i % STAGES, 1, j);
          xp[j].w[0] = u.x; xp[j].w[1] = u.y; xp[j].w[2] = u.z; xp[j].w[3] = u.w;
          dp[j].w[0] = w.x; dp[j].w[1] = w.y; dp[j].w[2] = w.z; dp[j].w[3] = w.w;
        } else {
          xp[j].zero();
          dp[j].zero();
        }
      }
      bwd_row(xp, dp, gp, dg, db, live ? dx + static_cast<size_t>(row) * hidden : nullptr,
              hidden, tpr, l, eps, red[0], red[1]);
    }
  }

  // the block's column sums, slots in order, into workspace row blockIdx.x
  float* wrow = ws + static_cast<size_t>(blockIdx.x) * 2 * hidden;
  if (slots == 1) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = (j * tpr + l.t) * VEC;
      if (c < hidden) {
        ds_ln::store_pack(wrow + c, dg[j]);
        ds_ln::store_pack(wrow + hidden + c, db[j]);
      }
    }
    return;
  }
  float* colsum = reinterpret_cast<float*>(ln_smem);
  if constexpr (STAGES > 0) __syncthreads();  // every thread is done with the ring
#pragma unroll
  for (int q = 0; q < 2; ++q) {  // dgamma, then dbeta through the same buffer
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = (j * tpr + l.t) * VEC;
      if (c < hidden) {
        if (q) ds_ln::store_pack(colsum + l.slot * hidden + c, db[j]);
        else ds_ln::store_pack(colsum + l.slot * hidden + c, dg[j]);
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < hidden; c += blockDim.x) {
      float sum = 0.f;
      for (int k = 0; k < slots; ++k) sum += colsum[k * hidden + c];
      wrow[q * hidden + c] = sum;
    }
    __syncthreads();
  }
}

// A row wider than kMaxRowThreads threads' registers: one row at a time a
// block, each pass re-reading it (from L2); thread t owns columns t, t +
// tpr, ... of the block's workspace row and adds each row into it in order.
template <typename T, typename P>
__global__ void __launch_bounds__(ds_ln::kStreamThreads)
ln_bwd_streamed_kernel(const T* __restrict__ x, const P* __restrict__ gamma,
                       const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ ws,
                       int rows, int hidden, int rps, float eps) {
  __shared__ float red[3][ds_ln::kMaxWarps * 2];
  const int tpr = blockDim.x;
  const Lane l(tpr);
  const float inv_n = 1.f / hidden;
  float* wg = ws + static_cast<size_t>(blockIdx.x) * 2 * hidden;
  float* wb = wg + hidden;
  for (int i = 0; i < rps; ++i) {
    const int row = blockIdx.x * rps + i;
    if (row >= rows) break;  // the same row for the whole block
    const T* xr = x + static_cast<size_t>(row) * hidden;
    const T* dyr = dy + static_cast<size_t>(row) * hidden;
    T* dxr = dx + static_cast<size_t>(row) * hidden;
    float s[1];
    ds_ln::streamed_sum(s, hidden, l, tpr, red[0],
                        [&](int c, float (&v)[1]) { v[0] += ds_to_float(xr[c]); });
    const float mean = s[0] * inv_n;
    ds_ln::streamed_sum(s, hidden, l, tpr, red[1], [&](int c, float (&v)[1]) {
      const float d = ds_to_float(xr[c]) - mean;
      v[0] += d * d;
    });
    const float rstd = rsqrtf(s[0] * inv_n + eps);
    float m[2];
    ds_ln::streamed_sum(m, hidden, l, tpr, red[2], [&](int c, float (&v)[2]) {
      const float xhat = (ds_to_float(xr[c]) - mean) * rstd;
      const float d = ds_to_float(dyr[c]);
      const float dyg = d * ds_to_float(gamma[c]);
      v[0] += dyg;
      v[1] += dyg * xhat;
      wg[c] = (i ? wg[c] : 0.f) + d * xhat;
      wb[c] = (i ? wb[c] : 0.f) + d;
    });
    const float m1 = m[0] * inv_n, m2 = m[1] * inv_n;
    for (int c = l.t; c < hidden; c += tpr) {
      const float xhat = (ds_to_float(xr[c]) - mean) * rstd;
      const float dyg = ds_to_float(dyr[c]) * ds_to_float(gamma[c]);
      dxr[c] = ds_from_float<T>((dyg - m1 - xhat * m2) * rstd);
    }
  }
}

// [dgamma | dbeta] = the workspace rows [chunks, 2 * hidden] summed in a
// fixed order, rounded once into P: kColsPerBlock columns a block, group g
// of kColGroups summing rows g, g + kColGroups, ..., then the groups in a
// fixed tree.
template <typename P>
__global__ void __launch_bounds__(kColsPerBlock * kColGroups)
ln_bwd_cols_kernel(const float* __restrict__ ws, P* __restrict__ dgamma, P* __restrict__ dbeta,
                   int chunks, int hidden) {
  __shared__ float part[kColGroups][kColsPerBlock];
  // launched early (programmatic dependent launch): wait here until
  // ln_bwd_kernel has finished and its workspace rows are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int tx = threadIdx.x % kColsPerBlock, grp = threadIdx.x / kColsPerBlock;
  const int col = blockIdx.x * kColsPerBlock + tx;
  const int width = 2 * hidden;
  float sum = 0.f;
  if (col < width) {
#pragma unroll 4
    for (int k = grp; k < chunks; k += kColGroups)
      sum += ws[static_cast<size_t>(k) * width + col];
  }
  part[grp][tx] = sum;
  __syncthreads();
  // the groups in a fixed tree: g += g + 16, then + 8, + 4, + 2, + 1
#pragma unroll
  for (int half = kColGroups / 2; half > 0; half /= 2) {
    if (grp < half) part[grp][tx] += part[grp + half][tx];
    __syncthreads();
  }
  if (grp == 0 && col < width) {
    if (col < hidden) dgamma[col] = ds_from_float<P>(part[0][tx]);
    else dbeta[col - hidden] = ds_from_float<P>(part[0][tx]);
  }
}

template <typename K>
int allow_smem(K kernel, size_t bytes, int (&allowed)[kMaxDevices]) {
  if (bytes == 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (static_cast<int>(bytes) > allowed[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[dev] = static_cast<int>(bytes);
  }
  return 0;
}

template <typename T, typename P, int STAGES>
int launch_bwd(const ds_ln::Plan& p, const void* x, const void* gamma, const void* dy, void* dx,
               float* ws, void* dgamma, void* dbeta, int rows, int hidden, float eps,
               cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const P* g = static_cast<const P*>(gamma);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  const int err = ds_ln::dispatch<T>(p, [&](auto vec, auto per) {
    constexpr int V = decltype(vec)::value, N = decltype(per)::value;
    if constexpr (N == 0) {
      ln_bwd_streamed_kernel<T, P><<<p.blocks, p.tpr, 0, s>>>(xt, g, dyt, dxt, ws, rows, hidden,
                                                               p.rps, eps);
    } else {
      constexpr int S = V * sizeof(T) == 16 ? STAGES : 0;
      const int threads = p.slots * p.tpr;
      const size_t ring = sizeof(uint4) * S * 2 * N * threads;
      const size_t sums = p.slots > 1 ? sizeof(float) * p.slots * hidden : 0;
      const size_t smem = ring > sums ? ring : sums;
      static int allowed[kMaxDevices] = {};
      const int e = allow_smem(ln_bwd_kernel<T, P, V, N, S>, smem, allowed);
      if (e != 0) return e;
      ln_bwd_kernel<T, P, V, N, S><<<p.blocks, threads, smem, s>>>(
          xt, g, dyt, dxt, ws, rows, hidden, p.tpr, p.slots, p.rps, eps);
    }
    return static_cast<int>(cudaGetLastError());
  });
  if (err != 0) return err;
  // the column sums, launched while ln_bwd_kernel runs (programmatic
  // dependent launch), so their launch latency hides under its tail
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ds_ln::ceil_div(2LL * hidden, kColsPerBlock));
  cfg.blockDim = dim3(kColsPerBlock * kColGroups);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, ln_bwd_cols_kernel<P>, ws, static_cast<P*>(dgamma),
                                           static_cast<P*>(dbeta), p.blocks, hidden);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// gamma of dtype code `pdtype` (fp32, bf16 or fp16) beside x and dy of T.
template <typename T>
int launch_bwd_params(int pdtype, const ds_ln::Plan& p, const void* x, const void* gamma,
                      const void* dy, void* dx, float* ws, void* dgamma, void* dbeta, int rows,
                      int hidden, float eps, cudaStream_t s) {
  switch (pdtype) {
    case DS_DTYPE_FP32:
      return launch_bwd<T, float, kRingStages>(p, x, gamma, dy, dx, ws, dgamma, dbeta, rows,
                                               hidden, eps, s);
    case DS_DTYPE_BF16:
      return launch_bwd<T, __nv_bfloat16, kRingStages>(p, x, gamma, dy, dx, ws, dgamma, dbeta,
                                                       rows, hidden, eps, s);
    case DS_DTYPE_FP16:
      return launch_bwd<T, __half, kRingStages>(p, x, gamma, dy, dx, ws, dgamma, dbeta, rows,
                                                hidden, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, dy, dx [rows, hidden] in x's dtype (bf16 or fp32); gamma [hidden], and
// dgamma, dbeta written in its dtype (fp32, bf16 or fp16); ws an fp32
// workspace [blocks, 2, hidden]; `launch` the wrapper's array
// (ds_ln::LaunchField), refused unless its plan is this launcher's.  Two
// launches.
extern "C" int ds_layer_norm_bwd(const void* x, const void* gamma, const void* dy, void* dx,
                                 void* ws, void* dgamma, void* dbeta, float eps,
                                 const int* launch, void* stream) {
  const bool aligned = ds_ln::aligned16(x) && ds_ln::aligned16(dy) && ds_ln::aligned16(dx) &&
                       ds_ln::aligned16(gamma) && ds_ln::aligned16(ws);
  ds_ln::Plan p;
  if (!ds_ln::launch_plan(launch, aligned, true, p))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = launch[ds_ln::kRows], hidden = launch[ds_ln::kHidden];
  const int dtype = launch[ds_ln::kDtype], pdtype = launch[ds_ln::kParamDtype];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (dtype == DS_DTYPE_BF16)
    return launch_bwd_params<__nv_bfloat16>(pdtype, p, x, gamma, dy, dx, w, dgamma, dbeta, rows,
                                            hidden, eps, s);
  if (dtype == DS_DTYPE_FP32)
    return launch_bwd_params<float>(pdtype, p, x, gamma, dy, dx, w, dgamma, dbeta, rows, hidden,
                                    eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
