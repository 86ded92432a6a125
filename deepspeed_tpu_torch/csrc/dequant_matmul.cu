// Kernel C: int8 dequant-matmul, out[M, N] = x[M, K] @ (qweight[K, N] *
// scale[k // (K / groups)]), fp32 accumulation, out in x's dtype.
//
// Replaces: deepspeed_tpu/ops/quant.py fused_dequant_matmul (_dq_kernel).
// Same numerics: each int8 weight is converted on chip, scaled by its
// row's fp32 group scale and rounded to x's dtype (as the TPU kernel feeds
// its MXU), then multiplied with fp32 accumulation.
//
// Bound on the H100: bytes at decode, where M is the batch (8): the weight
// is read once for 2*M operations per int8 byte, far below the ~295 at
// which the tensor cores would bound it.  At prefill (M = 1024, ~1,500
// operations per byte) the bf16 tensor cores bound it.  What the design
// does about the bytes: device memory sees only the int8 weight (1 byte
// per element, half of bf16), never a dequantized copy.  The launcher
// picks one of three kernels from the shape:
//
// - dq_gemv_kernel, M <= 8 (decode).  A block owns 128 output columns and
//   one slice of K; its 16 warps split the slice between them, and each
//   lane owns 4 adjacent columns, read as one 4-byte load per weight row,
//   so a warp reads 128 contiguous bytes of a row.  Sixteen rows are loaded
//   before any is used, to keep many loads in flight: at these sizes the
//   time is set by memory latency and by how many SMs take part, not by
//   the memory rate.  The K slices of one column block form a thread-block
//   cluster (up to 8 blocks on neighbouring SMs), so that a [3072, 768]
//   weight, which has only 6 column blocks, still runs on 48 SMs.  x is
//   staged in shared memory as fp32.  The warps' partial sums meet in
//   shared memory, and the cluster's blocks read each other's sums through
//   distributed shared memory; every sum is taken in a fixed order, so the
//   result does not depend on scheduling, and no workspace or second
//   launch is needed.
// - dq_mma_kernel, bf16 x with M > 8 (prefill).  64 x 64 output tiles,
//   four warps of 32 x 32, `mma.sync` m16n8k16 bf16 with fp32
//   accumulators, K in steps of 32.  The int8 tile is dequantized on its
//   way into shared memory (stored n-major, so each B fragment is one
//   32-bit load); the next step's tiles are loaded into registers while
//   the current one multiplies.  Needs K % 32 == 0, N % 16 == 0 and
//   16-byte aligned x and qweight.
// - dq_tiled_kernel, everything else (fp32 x at M > 8, odd shapes): the
//   plain tiled GEMM on the CUDA cores, one block per 64 x 64 output
//   tile, fp32 FMA, all edges masked.
//
// `wgmma`, TMA, and a split of K at prefill, are later work.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// --------------------------------------------------------------------- //
// decode: M <= 8
// --------------------------------------------------------------------- //
constexpr int kGemvWarps = 16;
constexpr int kGemvThreads = kGemvWarps * 32;
constexpr int kGemvCols = 128;         // 4 per lane
constexpr int kGemvMaxM = 8;
constexpr int kGemvChunk = 1024;       // rows of x staged in shared memory
constexpr int kGemvUnroll = 16;        // weight rows in flight per lane
constexpr int kGemvMaxSplit = 8;       // K slices per column block (cluster size)
constexpr int kGemvTargetBlocks = 132; // one per SM of an H100 SXM
constexpr int kGemvMinRows = 64;       // rows of K per slice, at least

constexpr size_t gemv_smem_bytes() {
  return static_cast<size_t>(kGemvChunk * kGemvMaxM +
                             kGemvWarps * kGemvMaxM * kGemvCols) *
         sizeof(float);
}

// K slices for an [K, N] weight: the smallest power of two that gives
// about one block per SM, at most the cluster limit, and no slice under
// kGemvMinRows rows.
int gemv_split(int K, int N) {
  const int col_blocks = (N + kGemvCols - 1) / kGemvCols;
  int split = 1;
  while (split < kGemvMaxSplit && col_blocks * split < kGemvTargetBlocks &&
         K / (2 * split) >= kGemvMinRows)
    split *= 2;
  return split;
}

template <typename T>
__global__ void __launch_bounds__(kGemvThreads)
dq_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ qw,
               const float* __restrict__ scale, T* __restrict__ out, int M,
               int K, int N, int rows_per_group) {
  constexpr int MT = kGemvMaxM;
  extern __shared__ float smem[];
  float* xs = smem;                       // [kGemvChunk][MT]
  float* part = xs + kGemvChunk * MT;     // [kGemvWarps][MT][kGemvCols]
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());  // == gridDim.y
  const int rank = static_cast<int>(cluster.block_rank());   // == blockIdx.y

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n = blockIdx.x * kGemvCols + lane * 4;  // N % 4 == 0: all 4 in or out
  const bool active = n < N;
  // this block's slice of K
  const int per = (K + split - 1) / split;
  const int kbeg = min(K, rank * per), kend = min(K, kbeg + per);

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kGemvChunk) {
    const int kc = min(kGemvChunk, kend - k0);
    __syncthreads();  // the previous chunk of x is consumed
    for (int idx = threadIdx.x; idx < kc * MT; idx += kGemvThreads) {
      const int kk = idx / MT, m = idx % MT;
      xs[idx] = m < M ? ds_to_float(x[static_cast<size_t>(m) * K + k0 + kk]) : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    for (int kb = warp; kb < kc; kb += kGemvWarps * kGemvUnroll) {
      char4 w[kGemvUnroll];
      float s[kGemvUnroll];
#pragma unroll
      for (int u = 0; u < kGemvUnroll; ++u) {
        const int kk = kb + u * kGemvWarps;
        if (kk < kc) {
          const int gk = k0 + kk;
          w[u] = *reinterpret_cast<const char4*>(qw + static_cast<size_t>(gk) * N + n);
          s[u] = scale[gk / rows_per_group];
        } else {
          w[u] = make_char4(0, 0, 0, 0);
          s[u] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kGemvUnroll; ++u) {
        const int kk = kb + u * kGemvWarps;
        if (kk >= kc) break;  // uniform over the warp
        float wv[4];
        wv[0] = ds_to_float(ds_from_float<T>(static_cast<float>(w[u].x) * s[u]));
        wv[1] = ds_to_float(ds_from_float<T>(static_cast<float>(w[u].y) * s[u]));
        wv[2] = ds_to_float(ds_from_float<T>(static_cast<float>(w[u].z) * s[u]));
        wv[3] = ds_to_float(ds_from_float<T>(static_cast<float>(w[u].w) * s[u]));
        const float* xr = xs + kk * MT;  // the same address in every lane
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = xr[m];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(xv, wv[c], acc[m][c]);
        }
      }
    }
  }

  // the block's sum over its warps, in warp order, into part[0]
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      part[(warp * MT + m) * kGemvCols + lane * 4 + c] = acc[m][c];
  __syncthreads();
  for (int idx = threadIdx.x; idx < MT * kGemvCols; idx += kGemvThreads) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kGemvWarps; ++w) sum += part[w * MT * kGemvCols + idx];
    part[idx] = sum;  // this thread alone reads and writes idx
  }
  // the cluster's sum over its K slices, in rank order; each block
  // finishes its share of the outputs
  cluster.sync();
  const int share = (MT * kGemvCols + split - 1) / split;
  for (int idx = rank * share + threadIdx.x;
       idx < min(MT * kGemvCols, (rank + 1) * share); idx += kGemvThreads) {
    const int m = idx / kGemvCols, gn = blockIdx.x * kGemvCols + idx % kGemvCols;
    if (m >= M || gn >= N) continue;
    float sum = 0.f;
    for (int r = 0; r < split; ++r) sum += cluster.map_shared_rank(part, r)[idx];
    out[static_cast<size_t>(m) * N + gn] = ds_from_float<T>(sum);
  }
  cluster.sync();  // no block leaves while another still reads its part
}

// --------------------------------------------------------------------- //
// prefill, bf16: mma.sync tensor cores
// --------------------------------------------------------------------- //
constexpr int kMmaBM = 64;
constexpr int kMmaBN = 64;
constexpr int kMmaBK = 32;
constexpr int kMmaThreads = 128;
constexpr int kMmaLd = kMmaBK + 8;  // row pitch in shared memory, bf16 elements

__device__ __forceinline__ uint32_t ld_b32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kMmaThreads)
dq_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ qw,
              const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
              int M, int K, int N, int rows_per_group) {
  __shared__ __align__(16) __nv_bfloat16 as[kMmaBM * kMmaLd];  // [m][k]
  __shared__ __align__(16) __nv_bfloat16 bs[kMmaBN * kMmaLd];  // [n][k]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int m0 = blockIdx.y * kMmaBM, n0 = blockIdx.x * kMmaBN;

  // global -> register staging: two 16-byte pieces of the x tile (8 bf16
  // each) and one 16-byte piece of the int8 tile (16 weights of one row)
  const int a_row0 = tid / 4, a_col = (tid % 4) * 8;  // rows a_row0, a_row0 + 32
  const int b_k = tid / 4, b_n = (tid % 4) * 16;
  uint4 a_reg[2];
  uint4 b_reg;
  float b_scale;

  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int gm = m0 + a_row0 + 32 * i;
      a_reg[i] = gm < M ? *reinterpret_cast<const uint4*>(
                              x + static_cast<size_t>(gm) * K + k0 + a_col)
                        : make_uint4(0, 0, 0, 0);
    }
    const int gk = k0 + b_k, gn = n0 + b_n;
    b_reg = gn < N ? *reinterpret_cast<const uint4*>(qw + static_cast<size_t>(gk) * N + gn)
                   : make_uint4(0, 0, 0, 0);
    b_scale = scale[gk / rows_per_group];
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  load_tiles(0);
  for (int k0 = 0; k0 < K; k0 += kMmaBK) {
    __syncthreads();  // the previous tiles are consumed
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint4*>(as + (a_row0 + 32 * i) * kMmaLd + a_col) = a_reg[i];
    const int8_t* q8 = reinterpret_cast<const int8_t*>(&b_reg);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      bs[(b_n + j) * kMmaLd + b_k] = __float2bfloat16(static_cast<float>(q8[j]) * b_scale);
    __syncthreads();
    if (k0 + kMmaBK < K) load_tiles(k0 + kMmaBK);  // in flight during the products

#pragma unroll
    for (int kk = 0; kk < kMmaBK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const __nv_bfloat16* p = as + (wm + 16 * i + gid) * kMmaLd + kk + 2 * tig;
        a[i][0] = ld_b32(p);
        a[i][1] = ld_b32(p + 8 * kMmaLd);
        a[i][2] = ld_b32(p + 8);
        a[i][3] = ld_b32(p + 8 * kMmaLd + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* p = bs + (wn + 8 * j + gid) * kMmaLd + kk + 2 * tig;
        const uint32_t b0 = ld_b32(p), b1 = ld_b32(p + 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_bf16_16816(acc[i][j], a[i], b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + wn + 8 * j + 2 * tig;  // N % 16 == 0: gn + 1 < N too
      if (gn >= N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gm = m0 + wm + 16 * i + gid + 8 * half;
        if (gm >= M) continue;
        __nv_bfloat162 v;
        v.x = __float2bfloat16(acc[i][j][2 * half]);
        v.y = __float2bfloat16(acc[i][j][2 * half + 1]);
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(gm) * N + gn) = v;
      }
    }
  }
}

// --------------------------------------------------------------------- //
// everything else: fp32 FMA tiles
// --------------------------------------------------------------------- //
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
dq_tiled_kernel(const T* __restrict__ x, const int8_t* __restrict__ qw,
                const float* __restrict__ scale, T* __restrict__ out, int M,
                int K, int N, int rows_per_group) {
  constexpr int TM = kBM / 16;  // output rows per thread: 4
  constexpr int TN = kBN / 16;  // output columns per thread: 4
  __shared__ float xs[kBK][kBM + 1];
  __shared__ float ws[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int idx = tid; idx < kBM * kBK; idx += kThreads) {
      const int mm = idx / kBK, kk = idx % kBK;
      const int gm = m0 + mm, gk = k0 + kk;
      xs[kk][mm] = (gm < M && gk < K)
                       ? ds_to_float(x[static_cast<size_t>(gm) * K + gk])
                       : 0.f;
    }
    for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
      const int kk = idx / kBN, nn = idx % kBN;
      const int gk = k0 + kk, gn = n0 + nn;
      float w = 0.f;
      if (gk < K && gn < N) {
        const float deq = static_cast<float>(qw[static_cast<size_t>(gk) * N + gn]) *
                          scale[gk / rows_per_group];
        w = ds_to_float(ds_from_float<T>(deq));
      }
      ws[kk][nn] = w;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], bw[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int c = 0; c < TN; ++c) bw[c] = ws[kk][tx + 16 * c];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[i][c] = fmaf(a[i], bw[c], acc[i][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int gn = n0 + tx + 16 * c;
      if (gn < N) out[static_cast<size_t>(gm) * N + gn] = ds_from_float<T>(acc[i][c]);
    }
  }
}

// --------------------------------------------------------------------- //
// launchers
// --------------------------------------------------------------------- //
template <typename T>
int launch_gemv(const void* x, const void* qw, const void* scale, void* out,
                int M, int K, int N, int rows_per_group, cudaStream_t stream) {
  const size_t smem = gemv_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      dq_gemv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int split = gemv_split(K, N);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = split;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kGemvCols - 1) / kGemvCols, split);
  cfg.blockDim = dim3(kGemvThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, dq_gemv_kernel<T>, static_cast<const T*>(x),
                           static_cast<const int8_t*>(qw),
                           static_cast<const float*>(scale),
                           static_cast<T*>(out), M, K, N, rows_per_group);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int launch_mma(const void* x, const void* qw, const void* scale, void* out,
               int M, int K, int N, int rows_per_group, cudaStream_t stream) {
  const dim3 grid((N + kMmaBN - 1) / kMmaBN, (M + kMmaBM - 1) / kMmaBM);
  dq_mma_kernel<<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(qw),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), M,
      K, N, rows_per_group);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tiled(const void* x, const void* qw, const void* scale, void* out,
                 int M, int K, int N, int rows_per_group, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  dq_tiled_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(qw),
      static_cast<const float*>(scale), static_cast<T*>(out), M, K, N,
      rows_per_group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Which kernel the launcher takes for this shape and dtype: 0 gemv, 1 mma,
// 2 tiled.  chip_smoke.py reports it beside each parity case.
extern "C" int ds_dequant_matmul_route(const void* x, const void* qweight,
                                       int M, int K, int N, int dtype) {
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t qa = reinterpret_cast<uintptr_t>(qweight);
  if (M <= kGemvMaxM && N % 4 == 0 && qa % 4 == 0) return 0;
  if (dtype == DS_DTYPE_BF16 && K % kMmaBK == 0 && N % 16 == 0 &&
      xa % 16 == 0 && qa % 16 == 0)
    return 1;
  return 2;
}

extern "C" int ds_dequant_matmul(const void* x, const void* qweight,
                                 const void* scale, void* out, int M, int K,
                                 int N, int groups, int dtype, void* stream) {
  if (groups <= 0 || K % groups != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != DS_DTYPE_BF16 && dtype != DS_DTYPE_FP32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rpg = K / groups;
  const bool bf16 = dtype == DS_DTYPE_BF16;
  switch (ds_dequant_matmul_route(x, qweight, M, K, N, dtype)) {
    case 0:
      return bf16 ? launch_gemv<__nv_bfloat16>(x, qweight, scale, out, M, K, N, rpg, s)
                  : launch_gemv<float>(x, qweight, scale, out, M, K, N, rpg, s);
    case 1:
      return launch_mma(x, qweight, scale, out, M, K, N, rpg, s);
    default:
      return bf16 ? launch_tiled<__nv_bfloat16>(x, qweight, scale, out, M, K, N, rpg, s)
                  : launch_tiled<float>(x, qweight, scale, out, M, K, N, rpg, s);
  }
}
