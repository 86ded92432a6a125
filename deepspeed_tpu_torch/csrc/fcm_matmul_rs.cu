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
//   index order, each product and sum rounded separately (see
//   collect_kernel for its design).
//
// Bound on the H100: operations for the producer (at GPT-2 124M's c_fc
// tile, kc = 192, n = 3072 over 2048 rows: 2.4 GFLOP on ~15 MB, 2.4 us at
// the bf16 tensor-core peak against 4.5 us for the bytes, so in fact the
// bytes by a little on the tensor cores), bytes for the collect (W int8
// tiles and scales in, one fp32 tile out: ~4.7 MB, 1.42 us at W = 4 of
// that tile).  What the design does about them: the split partials stay
// in L2 mostly; the collect reads each byte once in whole lines, with
// every load of a chunk in flight before its first add.

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

// ---- the collect ---------------------------------------------------- //
// out[e] = ((0 + q0[e] * s0) + q1[e] * s1) + ... in source order, each
// product and sum rounded on its own (__fmul_rn, __fadd_rn: no FMA), as
// fcm_rs_collect_reference and the JAX op add.  A memory-bound stream:
// every byte is read once, so the design is about bytes in flight and
// whole-line accesses.
//
// - A thread takes a chunk of 4 consecutive elements (where bs % 4 == 0,
//   the q table lies on 4 bytes and out on 16; else 1): one 4-byte load a
//   source and one float4 store, so that a warp's loads read whole 128-byte
//   lines and its store writes 512 contiguous bytes.  A chunk lies in one
//   scale block: its scale index is one 32-bit division where the chunks
//   fit.  (A chunk of 16, one 16-byte load a source and four float4 stores
//   64 bytes apart across the lanes, measured slower on the H100, slower
//   even than the first design, which waited on each source in turn;
//   PERF.md has the numbers.)
// - Every load of a chunk is issued before its first add: W int8 loads,
//   then W scale loads, then the sums in source order.  W is a template
//   parameter for 1..kCollectMaxUnrolled (the launcher switches on it); a
//   larger world runs W = 0, which loads its sources in groups of
//   kCollectGroup.
// - 128 threads a block, one chunk a thread, up to kCollectBlocksPerSm
//   blocks an SM (eight waves at full occupancy), the grid striding beyond:
//   at [192, 3072] 147,456 chunks are 1152 blocks.
constexpr int kCollectThreads = 128;
constexpr int kCollectSms = 132;  // the H100 SXM's (ops/collective_matmul.py SM_COUNT)
constexpr int kCollectBlocksPerSm = 128;
constexpr int kCollectMaxUnrolled = 8;
constexpr int kCollectGroup = 4;

// VEC int8 values of one source
template <int VEC>
struct QChunk;

template <>
struct QChunk<4> {
  uint32_t w;
  __device__ __forceinline__ void load(const int8_t* p) {
    w = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  __device__ __forceinline__ float get(int j) const {
    return static_cast<float>(static_cast<int8_t>(w >> (8 * j)));
  }
};

template <>
struct QChunk<1> {
  int8_t w;
  __device__ __forceinline__ void load(const int8_t* p) { w = __ldg(p); }
  __device__ __forceinline__ float get(int) const { return static_cast<float>(w); }
};

template <int VEC>
__device__ __forceinline__ void add_source(float (&sum)[VEC], const QChunk<VEC>& q, float sc) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) sum[j] = __fadd_rn(sum[j], __fmul_rn(q.get(j), sc));
}

template <int VEC>
__device__ __forceinline__ void store_chunk(float* out, const float (&sum)[VEC]) {
  if constexpr (VEC == 1)
    out[0] = sum[0];
  else
    *reinterpret_cast<float4*>(out) = make_float4(sum[0], sum[1], sum[2], sum[3]);
}

// chunks of VEC elements; cpb = bs / VEC chunks a scale block; W sources
// unrolled (0: `world` sources in groups of kCollectGroup)
template <int VEC, int W>
__global__ void __launch_bounds__(kCollectThreads)
collect_kernel(const int8_t* __restrict__ qtab, const float* __restrict__ stab,
               float* __restrict__ out, int world, int64_t total, int64_t nb, int cpb,
               int64_t chunks) {
  const bool narrow = chunks <= 0xffffffffll;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kCollectThreads;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * kCollectThreads + threadIdx.x; c < chunks;
       c += stride) {
    const int8_t* q0 = qtab + c * VEC;
    const int64_t sb = narrow ? static_cast<int64_t>(static_cast<uint32_t>(c) /
                                                     static_cast<uint32_t>(cpb))
                              : c / cpb;
    float sum[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) sum[j] = 0.f;
    if constexpr (W > 0) {
      QChunk<VEC> q[W];
#pragma unroll
      for (int s = 0; s < W; ++s) q[s].load(q0 + s * total);
      float sc[W];
#pragma unroll
      for (int s = 0; s < W; ++s) sc[s] = __ldg(stab + s * nb + sb);
#pragma unroll
      for (int s = 0; s < W; ++s) add_source(sum, q[s], sc[s]);
    } else {
      for (int s0 = 0; s0 < world; s0 += kCollectGroup) {
        const int n = min(kCollectGroup, world - s0);
        QChunk<VEC> q[kCollectGroup];
        float sc[kCollectGroup];
#pragma unroll
        for (int s = 0; s < kCollectGroup; ++s)
          if (s < n) q[s].load(q0 + (s0 + s) * total);
#pragma unroll
        for (int s = 0; s < kCollectGroup; ++s)
          if (s < n) sc[s] = __ldg(stab + (s0 + s) * nb + sb);
#pragma unroll
        for (int s = 0; s < kCollectGroup; ++s)
          if (s < n) add_source(sum, q[s], sc[s]);
      }
    }
    store_chunk<VEC>(out + c * VEC, sum);
  }
}

struct CollectPlan {
  int width;     // elements a chunk: 4 or 1
  int threads;
  int blocks;
  int unrolled;  // W when the sources are unrolled, else 0
};

// The widest chunk the pointers allow: 4 when out lies on 16 bytes and
// the q table on 4, else 1 (ops/collective_matmul.py collect_alignment).
int collect_alignment(const void* qtab, const void* out) {
  return reinterpret_cast<uintptr_t>(out) % 16 == 0 && reinterpret_cast<uintptr_t>(qtab) % 4 == 0
             ? 4
             : 1;
}

// ops/collective_matmul.py collect_plan
CollectPlan collect_plan(int world, int64_t total, int bs, int alignment) {
  CollectPlan p;
  p.width = bs % 4 == 0 && alignment % 4 == 0 ? 4 : 1;
  p.threads = kCollectThreads;
  const int64_t blocks = (total / p.width + kCollectThreads - 1) / kCollectThreads;
  const int64_t cap = static_cast<int64_t>(kCollectSms) * kCollectBlocksPerSm;
  p.blocks = static_cast<int>(blocks < cap ? blocks : cap);
  p.unrolled = world <= kCollectMaxUnrolled ? world : 0;
  return p;
}

template <int VEC>
void launch_collect(const CollectPlan& p, const int8_t* qtab, const float* stab, float* out,
                    int world, int64_t total, int bs, cudaStream_t s) {
  const int64_t nb = total / bs, chunks = total / VEC;
  const int cpb = bs / VEC;
#define DS_COLLECT(W)                                                                     \
  collect_kernel<VEC, W><<<p.blocks, p.threads, 0, s>>>(qtab, stab, out, world, total, nb, \
                                                          cpb, chunks)
  switch (p.unrolled) {
    case 1: DS_COLLECT(1); break;
    case 2: DS_COLLECT(2); break;
    case 3: DS_COLLECT(3); break;
    case 4: DS_COLLECT(4); break;
    case 5: DS_COLLECT(5); break;
    case 6: DS_COLLECT(6); break;
    case 7: DS_COLLECT(7); break;
    case 8: DS_COLLECT(8); break;
    default: DS_COLLECT(0); break;
  }
#undef DS_COLLECT
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
  const CollectPlan p = collect_plan(world, total, bs, collect_alignment(qtab, out));
  const int8_t* q = static_cast<const int8_t*>(qtab);
  const float* sc = static_cast<const float*>(stab);
  float* o = static_cast<float*>(out);
  if (p.width == 4)
    launch_collect<4>(p, q, sc, o, world, total, bs, s);
  else
    launch_collect<1>(p, q, sc, o, world, total, bs, s);
  return static_cast<int>(cudaGetLastError());
}

// The collect's launch for these tables (plan: int32[4] out: elements a
// chunk, threads a block, blocks, unrolled sources or 0); launches nothing.
extern "C" int ds_fcm_rs_collect_plan(const void* qtab, const void* out, int world, int64_t total,
                                      int bs, int* plan) {
  if (world <= 0 || bs <= 0 || total <= 0 || total % bs != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const CollectPlan p = collect_plan(world, total, bs, collect_alignment(qtab, out));
  plan[0] = p.width;
  plan[1] = p.threads;
  plan[2] = p.blocks;
  plan[3] = p.unrolled;
  return 0;
}
