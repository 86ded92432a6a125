// Kernel B: flash-attention forward, q,k,v [B, H, S, D] -> out [B, H, S, D]
// and the per-row logsumexp [B, H, S] in fp32.
//
// Replaces: deepspeed_tpu/ops/flash_attention.py flash_attention_pallas
// (_fa_kernel), with its in-kernel probability dropout.  Same numerics:
// scores, running max, running sum and the output accumulator in fp32;
// masked scores take DEFAULT_MASK_VALUE; a row whose sum is 0 writes
// zeros; lse = m + log(l + 1e-37).  Dropout acts on the normalized P: the
// P.V input is masked and scaled by 256 / threshold while the running sum
// l adds the raw P (_fa_kernel :355-364), so out = dropout(softmax) @ V.
// The keep mask is a pure function of (seed, b, h, row, col)
// (dropout.cuh), which the backward kernels regenerate exactly; the seed
// is read from device memory, so drawing it needs no host round trip.
// Strides are arguments: q, k and v may be the [B, S, H, D] head views
// that a fused QKV projection produces; the output is written as
// [B, S, H, D].  Any Sq, Sk: rows and keys past the end are masked here.
//
// Head dims: any D up to 256 runs, on either route, the smallest
// instantiation (32, 64, 96, 128, 256) at or above it; the columns past
// the true D are zero-filled on load, so they add nothing to a product,
// and are never stored.  The tensor-core route takes D a multiple of 8
// (its 16-byte copies): the Python wrapper pads any other D with zero
// columns up to one, and passes the true D's 1 / sqrt(D).  A D above 256
// runs the wide kernels of attention_wide.cuh (bf16 on the tensor cores,
// fp32 on the CUDA cores): the output columns in chunks of 128 over the
// grid, each block computing its scores over the whole D from slices.
//
// Two routes, chosen by the operands' dtype:
//
// bf16, tensor cores (tc::flash_fwd_mma_kernel, D in {32, 64, 96, 128,
// 256}).
//   Bound on the H100: at the training shape ([8, 12, 1024, 64] causal)
//   the two products are 12.9 GFLOP against ~50 MB of q, k, v, out and
//   lse: 13 us at the 989 TFLOP/s bf16 peak, 15 us at 3.35 TB/s, so the
//   bytes bound it by a little and a kernel near either is fast.  What the
//   earlier CUDA-core design lost, and what this one does about it:
//   - the products: S = Q K^T and O += P V run on `mma.sync` m16n8k16
//     (bf16 in, fp32 sums) with the online softmax in registers.  One warp
//     owns 16 query rows, so a row's max and sum are reduced inside a quad
//     (two shuffles); Q is loaded once and kept in registers as A
//     fragments; P is rounded to bf16 for the P.V product (l is summed
//     from the fp32 P) and reaches it from registers (attention_mma.cuh
//     acc_to_a), with no shuffles and no shared memory;
//   - the loads: K and V tiles of 64 keys go through a ring of two stages
//     of `cp.async` 16-byte copies into swizzled bf16 tiles (ldmatrix reads
//     them without bank conflicts), so tile n + 1 is in flight while tile
//     n is multiplied; rows past S are zero-filled by the copy;
//   - the schedule: only tiles on or below the causal diagonal are loaded,
//     only the tile that crosses it is masked, and the grid walks the
//     q-tiles heaviest first (the tail is then light);
//   - dropout: the keep bits of each 64-key tile are drawn once per block
//     into shared memory (attention_mma.cuh draw_keep_bits), overlapped
//     with the tile's loads.
//   A block is 64 query rows (4 warps): 128 rows (8 warps) measured slower
//   at every shape tried on the H100 (PERF.md).  The per-tile work (the
//   two products and the softmax update) is attention_mma.cuh's
//   fwd_tile_step, which kernel F shares; the two differ only in the tiles
//   they walk.
//   D = 256: the 64 rows x 256 columns of O in fp32 and Q's fragments do
//   not fit a warp's registers beside the scores, so the block has two
//   groups of four warps (ds_mma::ColumnSplit): each warp reads Q from
//   shared memory at every k-slice, computes its 16 rows' scores over the
//   whole D, and accumulates its group's 128 columns of O
//   (fwd_tile_step_split): S = Q K^T runs twice, P V once.  Q, K and V
//   take 160 KB of shared memory, one block per SM.
//
// fp32, CUDA cores (fp32::flash_fwd_kernel, the first design, kept as it
// was).  A tensor-core fp32 product would be TF32, about three decimal
// digits, which breaks the 1e-4 fp32 parity the fp32 engine mode is held
// to; so fp32 operands multiply in fp32 on the CUDA cores (67 TFLOP/s
// peak, where the operations bound it).  One block per (q-tile of 64 rows,
// head, batch), 256 threads, 4 per query row: each thread holds 16 of its
// row's 64 scores and D/4 output columns; P.V fetches the other lanes'
// probabilities by shuffle; with causal masking the loop stops at the
// tile's last row.

#include "attention_mma.cuh"
#include "attention_wide.cuh"

namespace {

struct Strides {
  long long b, h, s;
};

// ===================================================================== //
// fp32: CUDA cores
// ===================================================================== //
namespace fp32 {

constexpr int kBM = 64;                // query rows per block
constexpr int kBN = 64;                // keys per k-tile
constexpr int kThreads = 256;
constexpr int kTPR = kThreads / kBM;   // threads per query row: 4
constexpr int kNS = kBN / kTPR;        // scores per thread per k-tile: 16

template <int D>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(kBM * (D + 1) + kBN * (D + 1) + kBN * D) *
         sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int H, int Sq, int Sk, Strides qs_,
                 Strides ks_, Strides vs_, Strides os_, float sm_scale, int dhead,
                 int causal, const int* __restrict__ seed_ptr,
                 int keep_threshold, float keep_scale) {
  constexpr int DP = D + 1;
  constexpr int DC = D / kTPR;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;             // [kBM][DP]
  float* ks = qs + kBM * DP;    // [kBN][DP]
  float* vs = ks + kBN * DP;    // [kBN][D]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int r = tid / kTPR;     // query row within the tile
  const int j = tid % kTPR;     // this thread's place in the row's group
  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qrow = q0 + r;
  const bool drop = keep_threshold < 256;
  const uint32_t seed = drop ? static_cast<uint32_t>(*seed_ptr) : 0u;
  const uint32_t bh = static_cast<uint32_t>(b * H + h);
  const uint32_t threshold = static_cast<uint32_t>(keep_threshold);

  const float* qb = q + b * qs_.b + h * qs_.h;
  const float* kb = k + b * ks_.b + h * ks_.h;
  const float* vb = v + b * vs_.b + h * vs_.h;

  for (int idx = tid; idx < kBM * D; idx += kThreads) {
    const int row = idx / D, col = idx % D;
    const int gq = q0 + row;
    qs[row * DP + col] = gq < Sq && col < dhead ? qb[gq * qs_.s + col] : 0.f;
  }

  float acc[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) acc[c] = 0.f;
  float m = DS_MASK_VALUE;
  float l = 0.f;

  // causal: keys past the tile's last row are masked for every row of it
  const int kend = causal ? min(Sk, q0 + kBM) : Sk;
  for (int n0 = 0; n0 < kend; n0 += kBN) {
    __syncthreads();  // Q is loaded / the previous K, V tiles are consumed
    for (int idx = tid; idx < kBN * D; idx += kThreads) {
      const int row = idx / D, col = idx % D;
      const int gk = n0 + row;
      const bool ok = gk < Sk && col < dhead;
      ks[row * DP + col] = ok ? kb[gk * ks_.s + col] : 0.f;
      vs[row * D + col] = ok ? vb[gk * vs_.s + col] : 0.f;
    }
    __syncthreads();

    // scores of keys n0 + j + 4*i for this thread's row
    float s[kNS];
#pragma unroll
    for (int i = 0; i < kNS; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qs[r * DP + d];
#pragma unroll
      for (int i = 0; i < kNS; ++i) s[i] = fmaf(qd, ks[(j + kTPR * i) * DP + d], s[i]);
    }

    float mt = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
      const int col = n0 + j + kTPR * i;
      float sv = s[i] * sm_scale;
      if (col >= Sk) {
        sv = -CUDART_INF_F;          // past the ragged edge: weight 0
      } else if (causal && col > qrow) {
        sv = DS_MASK_VALUE;
      }
      s[i] = sv;
      mt = fmaxf(mt, sv);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float lt = 0.f;
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
      s[i] = expf(s[i] - m_new);
      lt += s[i];
    }
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    l = l * alpha + lt;
    m = m_new;
    if (drop) {  // after l took the raw P: only the P.V input is dropped
      const uint4 bytes = ds_dropout_bytes(seed, bh, qrow, n0, j);
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        s[i] = ds_byte(bytes, i) < threshold ? s[i] * keep_scale : 0.f;
      }
    }

#pragma unroll
    for (int c = 0; c < DC; ++c) acc[c] *= alpha;
    const int base = lane & ~(kTPR - 1);
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
#pragma unroll
      for (int jj = 0; jj < kTPR; ++jj) {
        const float p = __shfl_sync(0xffffffffu, s[i], base | jj);
        const float* vrow = vs + (kTPR * i + jj) * D;
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[c] = fmaf(p, vrow[j + kTPR * c], acc[c]);
      }
    }
  }

  if (qrow < Sq) {
    const float denom = l == 0.f ? 1.f : l;
    float* orow = o + b * os_.b + h * os_.h + qrow * os_.s;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (j + kTPR * c < dhead) orow[j + kTPR * c] = acc[c] / denom;
    if (j == 0) {
      lse[(static_cast<size_t>(b) * H + h) * Sq + qrow] = m + logf(l + 1e-37f);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
           Strides os, float sm_scale, int dhead, int causal, const int* seed,
           int keep_threshold, float keep_scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBM - 1) / kBM, H, B);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, Sq, Sk,
      qs, ks, vs, os, sm_scale, dhead, causal, seed, keep_threshold, keep_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fp32

// ===================================================================== //
// bf16: tensor cores
// ===================================================================== //
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kBN = 64;       // keys per k-tile
constexpr int kBM = 64;       // query rows per block: 4 warps of 16 (per column group)

template <int D>
struct FwdLayout {
  static constexpr int kThreads = ds_mma::ColumnSplit<D>::kThreads;
  static constexpr int kQ = 0;                                   // [kBM][D]
  static constexpr int kK = kQ + ds_mma::tile_bytes<D>(kBM);     // [2][kBN][D]
  static constexpr int kV = kK + 2 * ds_mma::tile_bytes<D>(kBN); // [2][kBN][D]
  static constexpr int kBits = kV + 2 * ds_mma::tile_bytes<D>(kBN);  // [2][kBM] u64
  static constexpr int kBytes = kBits + 2 * kBM * 8;
};

// At D = 64 the registers are capped so that four blocks fit an SM (128
// registers, a few bytes spilled), which measured faster on the H100 than
// three blocks at the 159 the compiler picks.
template <int D>
__global__ void __launch_bounds__(FwdLayout<D>::kThreads, D == 64 ? 4 : 1)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int B, int H, int Sq, int Sk,
                     Strides qs_, Strides ks_, Strides vs_, Strides os_,
                     float sm_scale, int dhead, int causal, const int* __restrict__ seed_ptr,
                     int keep_threshold, float keep_scale) {
  using L = FwdLayout<D>;
  using Split = ds_mma::ColumnSplit<D>;
  constexpr int BM = kBM, NT = L::kThreads, DO = Split::DO;
  constexpr int kKV = ds_mma::tile_bytes<D>(kBN);
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t s_q = ds_mma::smem_u32(tc_smem + L::kQ);
  const uint32_t s_k = ds_mma::smem_u32(tc_smem + L::kK);
  const uint32_t s_v = ds_mma::smem_u32(tc_smem + L::kV);
  uint64_t* bits = reinterpret_cast<uint64_t*>(tc_smem + L::kBits);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_bh = B * H;
  const int bh = blockIdx.x % n_bh;
  // heaviest q-tiles first: under causal masking the last tiles see most keys
  const int q0 = ((Sq + BM - 1) / BM - 1 - static_cast<int>(blockIdx.x) / n_bh) * BM;
  const int b = bh / H, h = bh % H;
  const bool drop = keep_threshold < 256;
  const uint32_t seed = drop ? static_cast<uint32_t>(*seed_ptr) : 0u;
  const uint32_t threshold = static_cast<uint32_t>(keep_threshold);

  const bf16* qb = q + b * qs_.b + h * qs_.h;
  const bf16* kb = k + b * ks_.b + h * ks_.h;
  const bf16* vb = v + b * vs_.b + h * vs_.h;
  const int kend = causal ? min(Sk, q0 + BM) : Sk;
  const int n_tiles = (kend + kBN - 1) / kBN;

  ds_mma::load_tile_async<BM, D, NT>(s_q, qb, qs_.s, q0, Sq, tid, dhead);
  if (n_tiles > 0) {
    ds_mma::load_tile_async<kBN, D, NT>(s_k, kb, ks_.s, 0, Sk, tid, dhead);
    ds_mma::load_tile_async<kBN, D, NT>(s_v, vb, vs_.s, 0, Sk, tid, dhead);
  }
  ds_mma::cp_async_commit();
  if (drop && n_tiles > 0) {
    ds_mma::draw_keep_bits<BM, NT>(bits, seed, bh, q0, 0, threshold, tid);
  }

  const int w0 = (Split::kParts == 1 ? warp : warp & 3) * 16;  // the warp's first row
  const int col0 = Split::kParts == 1 ? 0 : (warp >> 2) * DO;   // ... and output column
  const int row0 = q0 + w0;      // the warp's first row in the sequence
  const int rows[2] = {row0 + (lane >> 2), row0 + (lane >> 2) + 8};
  float acc[DO / 8][4];
#pragma unroll
  for (int j = 0; j < DO / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {DS_MASK_VALUE, DS_MASK_VALUE};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  uint32_t qa[Split::kParts == 1 ? D / 16 : 1][4];

  ds_mma::cp_async_wait<0>();
  __syncthreads();
  if constexpr (Split::kParts == 1) ds_mma::load_a<D>(qa, s_q, w0, lane);

  for (int t = 0; t < n_tiles; ++t) {
    if (t > 0) {
      ds_mma::cp_async_wait<0>();  // tile t has landed
      __syncthreads();             // ... for every thread; tile t - 1 is consumed
    }
    const int st = t & 1;
    const int n0 = t * kBN;
    if (t + 1 < n_tiles) {  // tile t + 1 flies while tile t is multiplied
      ds_mma::load_tile_async<kBN, D, NT>(s_k + (st ^ 1) * kKV, kb, ks_.s, n0 + kBN, Sk, tid,
                                          dhead);
      ds_mma::load_tile_async<kBN, D, NT>(s_v + (st ^ 1) * kKV, vb, vs_.s, n0 + kBN, Sk, tid,
                                          dhead);
      ds_mma::cp_async_commit();
      if (drop) {
        ds_mma::draw_keep_bits<BM, NT>(bits + (st ^ 1) * BM, seed, bh, q0, n0 + kBN,
                                       threshold, tid);
      }
    }
    // causal: a warp whose rows all lie above this tile has nothing in it
    if (causal && n0 > row0 + 15) continue;
    const bool edge = n0 + kBN > Sk || (causal && n0 + kBN - 1 > row0);
    if constexpr (Split::kParts == 1) {
      ds_mma::fwd_tile_step<D, true>(acc, m, l, qa, s_k + st * kKV, s_v + st * kKV, n0, rows,
                                     Sk, causal, edge, sm_scale, drop,
                                     bits + st * BM + w0 + (lane >> 2), lane);
    } else {
      ds_mma::fwd_tile_step_split<D, DO, true>(acc, m, l, s_q, w0, s_k + st * kKV,
                                               s_v + st * kKV, n0, rows, Sk, causal, edge,
                                               sm_scale, drop, bits + st * BM + w0 + (lane >> 2),
                                               lane, col0);
    }
  }
  // the other group may still read these rows of Q for its last scores
  if constexpr (Split::kParts > 1) __syncthreads();

  // the row sums over the quad; out = acc * keep scale / l (0 where l is
  // 0), staged in the warp's own rows of the Q tile for 16-byte stores
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = ds_mma::quad_sum(l[r]);
    inv[r] = (drop ? keep_scale : 1.f) / (l[r] == 0.f ? 1.f : l[r]);
  }
  ds_mma::acc_to_tile<D, DO>(tc_smem + L::kQ, w0, acc, inv[0], inv[1], lane, col0);
  __syncwarp();
  ds_mma::tile_rows_to_global<D, DO>(o + b * os_.b + h * os_.h, os_.s, row0, Sq,
                                     tc_smem + L::kQ, w0, lane, dhead, col0);
  if (col0 == 0 && (lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] < Sq) {
        lse[static_cast<size_t>(bh) * Sq + rows[r]] = m[r] + logf(l[r] + 1e-37f);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
           Strides os, float sm_scale, int dhead, int causal, const int* seed,
           int keep_threshold, float keep_scale, cudaStream_t stream) {
  constexpr int smem = FwdLayout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>((Sq + kBM - 1) / kBM) * B * H;
  flash_fwd_mma_kernel<D><<<static_cast<unsigned>(blocks), FwdLayout<D>::kThreads, smem,
                            stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, B, H, Sq, Sk, qs,
      ks, vs, os, sm_scale, dhead, causal, seed, keep_threshold, keep_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

extern "C" int ds_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int Sq, int Sk, int D, int chunks, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, float sm_scale, int causal,
    const void* seed, int keep_threshold, float keep_scale, int dtype,
    void* stream) {
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const int* sd = static_cast<const int*>(seed);
#define DS_FWD(NS, ...)                                                       \
  return NS::launch<__VA_ARGS__>(q, k, v, o, l, B, H, Sq, Sk, qs, ks, vs, os, \
                                 sm_scale, D, causal, sd, keep_threshold,     \
                                 keep_scale, s)
  // any D up to 256 (bf16: a multiple of 8) runs the smallest instantiation
  // at or above it, its columns past D zero-filled on load and masked on
  // store; a larger D runs the wide kernel, `chunks` column chunks
  if (!ds_head_dim_plan_ok(D, chunks, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  if (D > DS_MAX_TILED_HEAD_DIM) {
    const ds_wide::DenseWalk walk{Sq, Sk, causal};
    const ds_wide::Dropout drop{sd, keep_threshold, keep_scale};
    if (dtype == DS_DTYPE_BF16)
      return ds_wide::tc::launch_fwd(q, k, v, o, l, B, H, D, qs, ks, vs, os, sm_scale, walk,
                                     drop, s);
    return ds_wide::launch_fwd<float>(q, k, v, o, l, B, H, D, qs, ks, vs, os, sm_scale, walk,
                                      drop, s);
  }
  if (dtype == DS_DTYPE_BF16) {
    if (D <= 32) DS_FWD(tc, 32);
    if (D <= 64) DS_FWD(tc, 64);
    if (D <= 96) DS_FWD(tc, 96);
    if (D <= 128) DS_FWD(tc, 128);
    DS_FWD(tc, 256);
  }
  if (D <= 32) DS_FWD(fp32, 32);
  if (D <= 64) DS_FWD(fp32, 64);
  if (D <= 96) DS_FWD(fp32, 96);
  if (D <= 128) DS_FWD(fp32, 128);
  DS_FWD(fp32, 256);
#undef DS_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

