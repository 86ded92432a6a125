// One tiled fp32-FMA matrix product, C[M, N] = A[M, K] @ B[K, N], shared by
// the launchers of the fused collective-matmul kernels (fcm_tile.cu,
// fcm_ag_matmul.cu, fcm_matmul_rs.cu).  The operand loaders and the epilogue
// are template parameters:
//
// - the left operand `ALoad<T, Trans>`: a bf16 or fp32 matrix with a row
//   pitch (so a column block of a wider matrix is taken in place), read as
//   A[m, k] or, transposed, as A[k, m];
// - the right operand `WLoad<Mode, T, Trans>`: a [rows, cols] weight tile
//   that is native (bf16 / fp32), int8 with fp32 block scales, or int4
//   packed two per byte (low nibble first, sign extension (v ^ 8) - 8) with
//   the same scales; the dequant (one fp32 multiply) happens on the way
//   into shared memory, so device memory sees only the payload.  Read as
//   B[k, n] = w[k, n] or, transposed, as B[k, n] = w[n, k];
// - the epilogue: what becomes of the fp32 sums (a store, an accumulate, a
//   cast, or the quantizer of fcm_matmul_rs.cu).
//
// Every operand is widened to fp32 and multiplied with fmaf on the CUDA
// cores, as the TPU kernels multiply in fp32.  A block of 256 threads owns
// a BM x BN output tile, each thread a 4 x 4 patch read from shared memory
// as two float4 per step of K; tiles of K are 16 deep; all edges are
// masked.  Tensor cores are later work.
#pragma once

#include "common.cuh"

namespace ds_tile {

constexpr int kThreads = 256;
constexpr int kBK = 16;
constexpr int kPad = 4;  // keeps rows 16-byte aligned, spreads the banks

enum WeightMode { kNative = 0, kInt8 = 1, kInt4 = 2 };

template <typename T, bool Trans>
struct ALoad {
  const T* p;
  int64_t ld;  // pitch, in elements, of the matrix as it lies in memory
  // which index runs over neighbouring addresses
  static constexpr bool kInnerIsK = !Trans;
  __device__ __forceinline__ float operator()(int m, int k) const {
    return ds_to_float(Trans ? p[static_cast<int64_t>(k) * ld + m]
                             : p[static_cast<int64_t>(m) * ld + k]);
  }
};

template <int Mode, typename T, bool Trans>
struct WLoad {
  const void* w;       // [rows, cols] T, or int8 [rows, cols], or bytes [rows, cols / 2]
  const float* scale;  // [rows, cols / bs]; unused when native
  int cols;
  int bs;              // elements per scale block along a row
  static constexpr bool kInnerIsN = !Trans;
  __device__ __forceinline__ float at(int row, int col) const {
    if (Mode == kNative)
      return ds_to_float(static_cast<const T*>(w)[static_cast<int64_t>(row) * cols + col]);
    const int8_t* q = static_cast<const int8_t*>(w);
    const float s = scale[static_cast<int64_t>(row) * (cols / bs) + col / bs];
    int v;
    if (Mode == kInt8) {
      v = q[static_cast<int64_t>(row) * cols + col];
    } else {
      const int byte = q[static_cast<int64_t>(row) * (cols / 2) + col / 2];
      const int nibble = ((col & 1) ? (byte >> 4) : byte) & 0xF;
      v = (nibble ^ 8) - 8;
    }
    return __fmul_rn(static_cast<float>(v), s);
  }
  __device__ __forceinline__ float operator()(int k, int n) const {
    return Trans ? at(n, k) : at(k, n);
  }
};

// Shared memory of one block: the two operand tiles.  An epilogue may reuse
// it as scratch once the product is done.
template <int BM, int BN>
struct TileSmem {
  float a[kBK][BM + kPad];
  float b[kBK][BN + kPad];
};

template <int BM, int BN, class A, class B, class E>
__global__ void __launch_bounds__(kThreads)
tile_matmul_kernel(A a, B b, E ep, int M, int N, int K) {
  constexpr int TX = BN / 4;
  static_assert(TX * (BM / 4) == kThreads, "a 4 x 4 patch per thread");
  __shared__ __align__(16) TileSmem<BM, BN> sm;

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int idx = tid; idx < BM * kBK; idx += kThreads) {
      const int mm = A::kInnerIsK ? idx / kBK : idx % BM;
      const int kk = A::kInnerIsK ? idx % kBK : idx / BM;
      const int gm = m0 + mm, gk = k0 + kk;
      sm.a[kk][mm] = (gm < M && gk < K) ? a(gm, gk) : 0.f;
    }
    for (int idx = tid; idx < BN * kBK; idx += kThreads) {
      const int nn = B::kInnerIsN ? idx % BN : idx / kBK;
      const int kk = B::kInnerIsN ? idx / BN : idx % kBK;
      const int gn = n0 + nn, gk = k0 + kk;
      sm.b[kk][nn] = (gn < N && gk < K) ? b(gk, gn) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&sm.a[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&sm.b[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(ar[i], br[c], acc[i][c]);
    }
    __syncthreads();
  }
  ep.template run<BM, BN>(acc, m0, n0, ty, tx, M, N,
                          reinterpret_cast<float*>(&sm));
}

template <int BM, int BN, class A, class B, class E>
int launch_tile_matmul(A a, B b, E ep, int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  tile_matmul_kernel<BM, BN, A, B, E><<<grid, kThreads, 0, stream>>>(a, b, ep, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// Epilogue of kernels H and I: out[m, n] = sum (+ acc[m, n]), written as
// fp32 or bf16 with a row pitch (so a column block of a wider output is
// written in place).  `acc_in` is null where nothing is carried.
struct StoreEpilogue {
  const float* acc_in;  // [M, N] contiguous, or null
  void* out;
  int64_t ld_out;
  int out_dtype;
  template <int BM, int BN>
  __device__ __forceinline__ void run(const float (&acc)[4][4], int m0, int n0, int ty,
                                      int tx, int M, int N, float*) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gm = m0 + ty * 4 + i;
      if (gm >= M) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int gn = n0 + tx * 4 + c;
        if (gn >= N) continue;
        float v = acc[i][c];
        if (acc_in != nullptr) v = __fadd_rn(acc_in[static_cast<int64_t>(gm) * N + gn], v);
        const int64_t o = static_cast<int64_t>(gm) * ld_out + gn;
        if (out_dtype == DS_DTYPE_BF16)
          static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(v);
        else
          static_cast<float*>(out)[o] = v;
      }
    }
  }
};

// The weight tile of a ring step, as the Python wrappers describe it.
struct WeightArgs {
  const void* w;
  const float* scale;
  int mode;   // WeightMode
  int dtype;  // of a native tile
  int bs;
  int rows;   // kc
  int cols;   // n
};

inline bool weight_args_ok(const WeightArgs& w) {
  if (w.mode == kNative) return w.dtype == DS_DTYPE_FP32 || w.dtype == DS_DTYPE_BF16;
  if (w.mode != kInt8 && w.mode != kInt4) return false;
  if (w.scale == nullptr || w.bs <= 0 || w.cols % w.bs != 0) return false;
  return w.mode == kInt8 || (w.cols % 2 == 0 && w.bs % 2 == 0);
}

// x [M, K-of-the-product] @ the weight tile (or its transpose), 64 x 64
// output tiles, for every operand type and payload layout.
template <typename TA, bool TransW, class E>
int launch_weight_product(const void* x, int64_t ldx, const WeightArgs& w, E ep, int M,
                          cudaStream_t stream) {
  const ALoad<TA, false> a{static_cast<const TA*>(x), ldx};
  const int N = TransW ? w.rows : w.cols;
  const int K = TransW ? w.cols : w.rows;
  switch (w.mode) {
    case kInt8:
      return launch_tile_matmul<64, 64>(
          a, WLoad<kInt8, float, TransW>{w.w, w.scale, w.cols, w.bs}, ep, M, N, K, stream);
    case kInt4:
      return launch_tile_matmul<64, 64>(
          a, WLoad<kInt4, float, TransW>{w.w, w.scale, w.cols, w.bs}, ep, M, N, K, stream);
    default:
      if (w.dtype == DS_DTYPE_BF16)
        return launch_tile_matmul<64, 64>(
            a, WLoad<kNative, __nv_bfloat16, TransW>{w.w, nullptr, w.cols, w.cols}, ep, M, N,
            K, stream);
      return launch_tile_matmul<64, 64>(
          a, WLoad<kNative, float, TransW>{w.w, nullptr, w.cols, w.cols}, ep, M, N, K,
          stream);
  }
}

template <bool TransW, class E>
int launch_weight_product_any(const void* x, int64_t ldx, int x_dtype, const WeightArgs& w,
                              E ep, int M, cudaStream_t stream) {
  if (!weight_args_ok(w) || M <= 0 || w.rows <= 0 || w.cols <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == DS_DTYPE_BF16)
    return launch_weight_product<__nv_bfloat16, TransW>(x, ldx, w, ep, M, stream);
  if (x_dtype == DS_DTYPE_FP32)
    return launch_weight_product<float, TransW>(x, ldx, w, ep, M, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// a [Bdim, kc]^T @ b [Bdim, n] with any of the four operand type pairs.
template <int BM, int BN, class E>
int launch_at_b_any(const void* a, int64_t lda, int a_dtype, const void* b, int64_t ldb,
                    int b_dtype, E ep, int bdim, int kc, int n, cudaStream_t stream) {
  if (bdim <= 0 || kc <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool a16 = a_dtype == DS_DTYPE_BF16, b16 = b_dtype == DS_DTYPE_BF16;
  if ((!a16 && a_dtype != DS_DTYPE_FP32) || (!b16 && b_dtype != DS_DTYPE_FP32))
    return static_cast<int>(cudaErrorInvalidValue);
  const int cols = static_cast<int>(ldb);  // the pitch stands in for the row length
  if (a16 && b16)
    return launch_tile_matmul<BM, BN>(
        ALoad<__nv_bfloat16, true>{static_cast<const __nv_bfloat16*>(a), lda},
        WLoad<kNative, __nv_bfloat16, false>{b, nullptr, cols, cols}, ep, kc, n, bdim, stream);
  if (a16)
    return launch_tile_matmul<BM, BN>(
        ALoad<__nv_bfloat16, true>{static_cast<const __nv_bfloat16*>(a), lda},
        WLoad<kNative, float, false>{b, nullptr, cols, cols}, ep, kc, n, bdim, stream);
  if (b16)
    return launch_tile_matmul<BM, BN>(
        ALoad<float, true>{static_cast<const float*>(a), lda},
        WLoad<kNative, __nv_bfloat16, false>{b, nullptr, cols, cols}, ep, kc, n, bdim, stream);
  return launch_tile_matmul<BM, BN>(
      ALoad<float, true>{static_cast<const float*>(a), lda},
      WLoad<kNative, float, false>{b, nullptr, cols, cols}, ep, kc, n, bdim, stream);
}

}  // namespace ds_tile
