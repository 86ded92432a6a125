// Kernel J: the fused GEMM + qgZ reduce-scatter (int8), as two launches.
//
// Replaces: deepspeed_tpu/ops/collective_matmul.py _matmul_rs_tpu, the
// single TPU kernel that computes each output tile of dW = lhs^T @ rhs per
// DESTINATION, adds its error rows, quantizes it blockwise to int8 in the
// epilogue (scale = amax / 127, or 1 for an all-zero block; round half to
// even; clip), writes new_error = comp - q * scale, sends the tile to its
// owner, and at the end dequantizes the [W] source table and sums it in
// shard-index order.  On the GPU the sends are host code
// (ops/collective_matmul.py _matmul_rs_fused); this file holds
//
// - the producer, by operand types:
//   - bf16 a and b, tensor cores (tile_mma.cuh at_b_mma_kernel): A[m, k]
//     = a[k, m] and B[k, n] = b[k, n] both reach mma.sync through
//     ldmatrix.trans from a three-stage cp.async ring, in 64 x 128 output
//     tiles.  A [192, 3072] tile is only 72 of them, so the wrapper splits
//     K (= the rows of a and b) so that at least two blocks per SM run;
//     each block writes an fp32 partial to a workspace the wrapper
//     allocates, and a second pass, one warp per quantization block, sums
//     the partials in split order, adds the error rows and quantizes:
//     any bs, since a block of the flattened tile is contiguous there.
//     The launch repeats bitwise (no atomics);
//   - any other pair, CUDA cores: the a^T b product of tile_matmul.cuh
//     with the quantizer as its epilogue.  A block owns a 16-row x
//     256-column output tile, so that whole quantization blocks (bs <= 256
//     contiguous elements of a row; bs must divide both n and 256) lie
//     inside it: the compensated tile goes to shared memory, a warp takes
//     a row, finds each block's amax by shuffles and writes q, the scale
//     and the residual.  For other block sizes the product writes the
//     compensated tile to a workspace and ds_fcm_rs_quantize, one warp per
//     block, does the same from there.
//   On every route the quotient is a true division and the residual's
//   product and difference are rounded separately (__fmul_rn, __fsub_rn),
//   as the TPU kernel's are;
// - the collect: out = ((0 + q0 * s0) + q1 * s1) + ... over the W sources in
//   index order, each product and sum rounded separately.
//
// Bound on the H100: operations for the producer (at GPT-2 124M's c_fc
// tile, kc = 192, n = 3072 over 2048 rows: 2.4 GFLOP on ~15 MB, 2.4 us at
// the bf16 tensor-core peak against 4.5 us for the bytes, so in fact the
// bytes by a little on the tensor cores), bytes for the collect (W int8
// tiles and scales in, one fp32 tile out).  What the design does about
// them: the split partials stay in L2 mostly; the collect reads each byte
// once, four elements per thread where the block size allows.

#include "tile_mma.cuh"

using namespace ds_tile;

namespace {

constexpr int kBM = 16;
constexpr int kBN = 256;  // ops/collective_matmul.py RS_TILE_COLS
constexpr float kQmax = 127.f;

// q, scale and residual of one quantization block; `lane` strides over it.
__device__ __forceinline__ void quantize_block(const float* comp, int bs, int lane,
                                               int8_t* q, float* scale, float* nerr) {
  float amax = 0.f;
  for (int j = lane; j < bs; j += 32) amax = fmaxf(amax, fabsf(comp[j]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = amax > 0.f ? __fdiv_rn(amax, kQmax) : 1.f;
  for (int j = lane; j < bs; j += 32) {
    const float v = comp[j];
    const float qf = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -kQmax), kQmax);
    q[j] = static_cast<int8_t>(qf);
    if (nerr != nullptr) nerr[j] = __fsub_rn(v, __fmul_rn(qf, s));
  }
  if (lane == 0) *scale = s;
}

// The producer's epilogue.  fused: quantize here; otherwise store the
// compensated tile to `comp` for ds_fcm_rs_quantize.
struct QuantizeEpilogue {
  const float* err;  // [M, N] rows of the error buffer, or null
  int8_t* q;         // [M * N]
  float* scale;      // [M * N / bs]
  float* nerr;       // [M, N], or null
  float* comp;       // [M, N], or null
  int bs;
  int fused;
  template <int BM, int BN>
  __device__ __forceinline__ void run(const float (&acc)[4][4], int m0, int n0, int ty,
                                      int tx, int M, int N, float* smem) const {
    static_assert(BM * BN * sizeof(float) <= sizeof(TileSmem<BM, BN>),
                  "the compensated tile fits the operand tiles' shared memory");
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i, gm = m0 + row;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx * 4 + c, gn = n0 + col;
        float v = 0.f;
        if (gm < M && gn < N) {
          const int64_t o = static_cast<int64_t>(gm) * N + gn;
          v = acc[i][c];
          if (err != nullptr) v = __fadd_rn(v, err[o]);
          if (comp != nullptr) comp[o] = v;
        }
        if (fused) smem[row * BN + col] = v;
      }
    }
    if (!fused) return;
    __syncthreads();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int row = warp; row < BM; row += kThreads / 32) {
      const int gm = m0 + row;
      if (gm >= M) break;
      for (int col = 0; col < BN && n0 + col < N; col += bs) {
        const int64_t o = static_cast<int64_t>(gm) * N + n0 + col;
        quantize_block(smem + row * BN + col, bs, lane, q + o, scale + o / bs,
                       nerr != nullptr ? nerr + o : nullptr);
      }
    }
  }
};

__global__ void __launch_bounds__(kThreads)
quantize_blocks_kernel(const float* __restrict__ comp, int8_t* __restrict__ q,
                       float* __restrict__ scale, float* __restrict__ nerr, int64_t nb,
                       int bs) {
  const int lane = threadIdx.x % 32;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  for (int64_t blk = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
       blk < nb; blk += warps) {
    const int64_t o = blk * bs;
    quantize_block(comp + o, bs, lane, q + o, scale + blk,
                   nerr != nullptr ? nerr + o : nullptr);
  }
}

// The tensor-core producer's second pass, one warp per quantization block
// of the flattened [kc * n] tile: comp = ((p0 + p1) + ...) + err, written
// over partial 0 (and to comp_out when given), then quantized.
__global__ void __launch_bounds__(kThreads)
split_quantize_kernel(float* __restrict__ work, int splits, const float* __restrict__ err,
                      float* __restrict__ comp_out, int8_t* __restrict__ q,
                      float* __restrict__ scale, float* __restrict__ nerr, int64_t total,
                      int bs) {
  const int lane = threadIdx.x % 32;
  const int64_t nb = total / bs;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  for (int64_t blk = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
       blk < nb; blk += warps) {
    const int64_t o = blk * bs;
    for (int j = lane; j < bs; j += 32) {
      float v = work[o + j];
      for (int k = 1; k < splits; ++k) v = __fadd_rn(v, work[k * total + o + j]);
      if (err != nullptr) v = __fadd_rn(v, err[o + j]);
      work[o + j] = v;
      if (comp_out != nullptr) comp_out[o + j] = v;
    }
    // quantize_block reads back with the same lane stride: each lane its
    // own writes
    quantize_block(work + o, bs, lane, q + o, scale + blk, nerr != nullptr ? nerr + o : nullptr);
  }
}

// VEC elements per thread, all in one scale block (bs % VEC == 0).
template <int VEC>
__global__ void __launch_bounds__(kThreads)
collect_kernel(const int8_t* __restrict__ qtab, const float* __restrict__ stab,
               float* __restrict__ out, int world, int64_t total, int bs) {
  const int64_t nb = total / bs;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads * VEC;
  for (int64_t i = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * VEC;
       i < total; i += stride) {
    float sum[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) sum[v] = 0.f;
    for (int s = 0; s < world; ++s) {
      const int8_t* q = qtab + s * total + i;
      const float sc = stab[s * nb + i / bs];
      int8_t qv[4] = {q[0], 0, 0, 0};
      if (VEC == 4) {
        const char4 c = *reinterpret_cast<const char4*>(q);
        qv[0] = c.x, qv[1] = c.y, qv[2] = c.z, qv[3] = c.w;
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        sum[v] = __fadd_rn(sum[v], __fmul_rn(static_cast<float>(qv[v]), sc));
    }
    if (VEC == 4) {
      *reinterpret_cast<float4*>(out + i) = make_float4(sum[0], sum[1], sum[2], sum[3]);
    } else {
      out[i] = sum[0];
    }
  }
}

}  // namespace

// a [bdim, kc]^T (pitch lda) @ b [bdim, n] (pitch ldb) + err [kc, n] ->
// q [kc * n] int8, scale [kc * n / bs], nerr [kc, n] (or null), comp [kc, n]
// (or null; on the CUDA-core route required when not fused).  bf16 a and b
// take the tensor cores: bdim split `splits` ways into `work` [splits, kc,
// n] fp32, any bs, `fused` ignored; other pairs ignore work and splits.
extern "C" int ds_fcm_rs_producer(const void* a, int64_t lda, int a_dtype, const void* b,
                                  int64_t ldb, int b_dtype, const void* err, void* q,
                                  void* scale, void* nerr, void* comp, int bdim, int kc,
                                  int n, int bs, int fused, void* work, int splits,
                                  void* stream) {
  if (bs <= 0 || (static_cast<int64_t>(kc) * n) % bs != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_dtype == DS_DTYPE_BF16 && b_dtype == DS_DTYPE_BF16) {
    float* w = static_cast<float*>(work);
    int parts = 0;
    const int e = ds_tmma::launch_at_b_mma(a, lda, b, ldb, w, kc, n, bdim, splits, &parts, s);
    if (e != 0) return e;
    const int64_t total = static_cast<int64_t>(kc) * n;
    const int64_t blocks = (total / bs + kThreads / 32 - 1) / (kThreads / 32);
    const int grid = static_cast<int>(blocks < 65535 ? blocks : 65535);
    split_quantize_kernel<<<grid, kThreads, 0, s>>>(
        w, parts, static_cast<const float*>(err), static_cast<float*>(comp),
        static_cast<int8_t*>(q), static_cast<float*>(scale), static_cast<float*>(nerr), total,
        bs);
    return static_cast<int>(cudaGetLastError());
  }
  if (fused ? (n % bs != 0 || kBN % bs != 0) : comp == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const QuantizeEpilogue ep{static_cast<const float*>(err), static_cast<int8_t*>(q),
                            static_cast<float*>(scale), static_cast<float*>(nerr),
                            static_cast<float*>(comp), bs, fused};
  return launch_at_b_any<kBM, kBN>(a, lda, a_dtype, b, ldb, b_dtype, ep, bdim, kc, n, s);
}

extern "C" int ds_fcm_rs_quantize(const void* comp, void* q, void* scale, void* nerr,
                                  int64_t total, int bs, void* stream) {
  if (bs <= 0 || total <= 0 || total % bs != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nb = total / bs;
  const int64_t blocks = (nb + kThreads / 32 - 1) / (kThreads / 32);
  const int grid = static_cast<int>(blocks < 65535 ? blocks : 65535);
  quantize_blocks_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(comp), static_cast<int8_t*>(q), static_cast<float*>(scale),
      static_cast<float*>(nerr), nb, bs);
  return static_cast<int>(cudaGetLastError());
}

// qtab [world, total] int8, stab [world, total / bs] fp32 -> out [total] fp32.
extern "C" int ds_fcm_rs_collect(const void* qtab, const void* stab, void* out, int world,
                                 int64_t total, int bs, void* stream) {
  if (world <= 0 || bs <= 0 || total <= 0 || total % bs != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = bs % 4 == 0 && reinterpret_cast<uintptr_t>(qtab) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t per_block = static_cast<int64_t>(kThreads) * (vec ? 4 : 1);
  const int64_t blocks = (total + per_block - 1) / per_block;
  const int grid = static_cast<int>(blocks < 65535 ? blocks : 65535);
  if (vec)
    collect_kernel<4><<<grid, kThreads, 0, s>>>(static_cast<const int8_t*>(qtab),
                                                static_cast<const float*>(stab),
                                                static_cast<float*>(out), world, total, bs);
  else
    collect_kernel<1><<<grid, kThreads, 0, s>>>(static_cast<const int8_t*>(qtab),
                                                static_cast<const float*>(stab),
                                                static_cast<float*>(out), world, total, bs);
  return static_cast<int>(cudaGetLastError());
}
