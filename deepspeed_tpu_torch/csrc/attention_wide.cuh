// Head dims above 256 in kernels B, E, F and G (flash_attention_fwd.cu,
// flash_attention_bwd.cu, block_sparse_flash_fwd.cu,
// block_sparse_flash_bwd.cu): column chunks on the grid.
//
// The tiled kernels keep a tile's whole D in shared memory or registers,
// which stops at D = 256 (ds_mma::ColumnSplit).  The JAX kernels take any
// head dim, so a larger D runs here:
//
// - the grid gets a dimension over chunks of kChunk (128) output columns:
//   a block owns one q-tile (forward, dq) or k-tile (dk/dv) of 64 rows and
//   one chunk of its outputs' columns;
// - every block computes its tiles' scores over the WHOLE D: Q and K (and,
//   for dP = dO V^T, dO and V) stream through shared memory in slices of
//   kSlice columns, and each thread's 16 scores accumulate across the
//   slices; the score products so run ceil(D / 128) times, once per chunk;
// - then it multiplies by its own chunk only: P V_c for O, dS K_c for dq,
//   dS^T Q_c and P_drop^T dO_c for dk and dv, the chunk's rows staged in
//   shared memory over the (then dead) slices;
// - the row statistics are whole-D quantities: the forward's running max
//   and sum are the same in every chunk (chunk 0 writes lse), and E's and
//   G's delta = rowsum(dO * O) comes in from the wrapper over the whole D.
//
// Two routes, as the tiled kernels have: bf16 on the tensor cores
// (namespace tc below: `mma.sync` on swizzled slice tiles fed by
// `cp.async`), fp32 on the CUDA cores (a tensor-core fp32 product would be
// TF32).  The CUDA-core kernels read operands element by element and keep
// the D <= 128 CUDA-core kernels' thread layout: 256 threads, 4 per row, a
// thread holding the 16 columns n0 + j + 4 i of a 64-key tile, so one
// Philox call (dropout.cuh) gives it its keep bytes.  Every output has one
// block that owns it and sums in a fixed order: a launch repeats bitwise.
//
// The dense (B, E) and block-sparse (F, G) launches differ only in the
// tiles they walk (DenseWalk, SparseWalk).
#pragma once

#include "attention_mma.cuh"
#include "block_sparse_walk.cuh"
#include "common.cuh"
#include "dropout.cuh"

namespace ds_wide {

constexpr int kTile = 64;          // rows of a q-tile, keys of a k-tile
constexpr int kThreads = 256;
constexpr int kTPR = 4;            // threads per row
constexpr int kNS = kTile / kTPR;  // scores per thread per tile: 16
constexpr int kSlice = 32;         // columns of D staged per slice
constexpr int kSP = kSlice + 1;    // padded row of a slice
constexpr int kChunk = DS_WIDE_CHUNK;  // output columns per block
constexpr int kCC = kChunk / kTPR;     // output columns per thread: 32

struct HeadStrides {
  long long b, h, s;
};

// A launcher's own (batch, head, seq) strides (any type with b, h, s) as
// the wide kernels take them.
template <class S>
inline HeadStrides head_strides(const S& st) {
  return {st.b, st.h, st.s};
}

struct Dropout {
  const int* seed;
  int threshold;  // 256: no dropout
  float scale;
};

// The dense tiles of kernels B and E: the keys [0, Sk) of a q-tile (the
// causal diagonal's bound), the q-tiles [0, Sq) of a k-tile.
struct DenseWalk {
  int Sq, Sk, causal;
  template <class F>
  __device__ __forceinline__ void keys(int, int q0, F&& f) const {
    const int kend = causal ? min(Sk, q0 + kTile) : Sk;
    for (int n0 = 0; n0 < kend; n0 += kTile) f(n0);
  }
  template <class F>
  __device__ __forceinline__ void queries(int, int n0, F&& f) const {
    for (int m0 = causal ? n0 : 0; m0 < Sq; m0 += kTile) f(m0);
  }
};

// The live tiles of kernels F and G's layout (block_sparse_walk.cuh): a
// q-tile walks the 64-key tiles of its layout row's blocks (`lay`), a
// k-tile the 64-row tiles of its transposed row's blocks (`lay_t`); blocks
// wholly above the causal diagonal are skipped and the diagonal block is
// clipped to it.  Sq = Sk = S, a multiple of the block.
struct SparseWalk {
  ds_bsf::Layout lay, lay_t;
  int Sq, Sk, causal;
  template <class F>
  __device__ __forceinline__ void keys(int h, int q0, F&& f) const {
    const int qi = q0 / lay.block;
    const size_t off = (static_cast<size_t>(h) * (Sq / lay.block) + qi) * lay.max_deg;
    const int deg = ds_bsf::row_degree(lay.valid + off, lay.max_deg);
    for (int e = 0; e < deg; ++e) {
      const int kblk = lay.idx[off + e];
      if (causal && kblk > qi) continue;
      const int kb = kblk * lay.block;
      const int ke = causal ? min(kb + lay.block, q0 + kTile) : kb + lay.block;
      for (int n0 = kb; n0 < ke; n0 += kTile) f(n0);
    }
  }
  template <class F>
  __device__ __forceinline__ void queries(int h, int n0, F&& f) const {
    const int kblk = n0 / lay_t.block;
    const size_t off = (static_cast<size_t>(h) * (Sk / lay_t.block) + kblk) * lay_t.max_deg;
    const int deg = ds_bsf::row_degree(lay_t.valid + off, lay_t.max_deg);
    for (int e = 0; e < deg; ++e) {
      const int qblk = lay_t.idx[off + e];
      if (causal && kblk > qblk) continue;
      const int mb = causal ? max(qblk * lay_t.block, n0) : qblk * lay_t.block;
      for (int m0 = mb; m0 < qblk * lay_t.block + lay_t.block; m0 += kTile) f(m0);
    }
  }
};

// Rows [r0, r0 + kTile) x columns [c0, c0 + COLS) of one head's operand
// (row stride ss) as fp32 into a [kTile][LD] tile; zero past S and D.
template <int COLS, int LD, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, long long ss, int r0, int S,
                                          int c0, int D) {
  for (int idx = threadIdx.x; idx < kTile * COLS; idx += kThreads) {
    const int row = idx / COLS, col = idx % COLS;
    const int g = r0 + row, c = c0 + col;
    dst[row * LD + col] = g < S && c < D ? ds_to_float(src[g * ss + c]) : 0.f;
  }
}

// This thread's 16 scores s[i] = A[ra + r] . B[rb + j + 4 i] over the whole
// D, and with kTwo also s2[i] = A2[ra + r] . B2[rb + j + 4 i], the operands
// streamed through `sl` ([kTwo ? 4 : 2][kTile][kSP]) a slice at a time.  The
// first barrier also orders this call after the block's earlier use of
// `sl`'s memory.
template <bool kTwo, typename T>
__device__ __forceinline__ void slice_scores(float (&s)[kNS], float (&s2)[kNS], float* sl,
                                             const T* a, long long as, const T* b, long long bs,
                                             const T* a2, long long a2s, const T* b2,
                                             long long b2s, int ra, int Sa, int rb, int Sb,
                                             int D, int r, int j) {
  float* at = sl;
  float* bt = at + kTile * kSP;
  float* a2t = bt + kTile * kSP;
  float* b2t = a2t + kTile * kSP;
#pragma unroll
  for (int i = 0; i < kNS; ++i) s[i] = s2[i] = 0.f;
  for (int d0 = 0; d0 < D; d0 += kSlice) {
    __syncthreads();  // the previous slice (or the block's last use of sl) is consumed
    load_rows<kSlice, kSP>(at, a, as, ra, Sa, d0, D);
    load_rows<kSlice, kSP>(bt, b, bs, rb, Sb, d0, D);
    if (kTwo) {
      load_rows<kSlice, kSP>(a2t, a2, a2s, ra, Sa, d0, D);
      load_rows<kSlice, kSP>(b2t, b2, b2s, rb, Sb, d0, D);
    }
    __syncthreads();
#pragma unroll 4
    for (int d = 0; d < kSlice; ++d) {
      const float ad = at[r * kSP + d];
      const float a2d = kTwo ? a2t[r * kSP + d] : 0.f;
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        s[i] = fmaf(ad, bt[(j + kTPR * i) * kSP + d], s[i]);
        if (kTwo) s2[i] = fmaf(a2d, b2t[(j + kTPR * i) * kSP + d], s2[i]);
      }
    }
  }
}

__host__ __device__ inline int chunks(int D) { return (D + kChunk - 1) / kChunk; }

constexpr int kFwdSmem = (kTile * kChunk > 2 * kTile * kSP ? kTile * kChunk : 2 * kTile * kSP) * 4;
constexpr int kDqSmem = (kTile * kChunk > 4 * kTile * kSP ? kTile * kChunk : 4 * kTile * kSP) * 4;
constexpr int kPP = kTile + 1;  // padded row of the P_drop / dS tiles
constexpr int kDkdvRegion =
    2 * kTile * kChunk > 4 * kTile * kSP ? 2 * kTile * kChunk : 4 * kTile * kSP;
constexpr int kDkdvSmem = (kDkdvRegion + 2 * kTile * kPP + 2 * kTile) * 4;

// ------------------------------------------------------------------- //
// fp32, CUDA cores.  forward (B, F): out's chunk and, from chunk 0, lse
// ------------------------------------------------------------------- //
template <typename T, class Walk>
__global__ void __launch_bounds__(kThreads)
wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ o, float* __restrict__ lse, int H, int D, HeadStrides qs,
                HeadStrides ks, HeadStrides vs, HeadStrides os, float sm_scale, Walk walk,
                Dropout drop) {
  extern __shared__ float wide_smem[];
  float* sl = wide_smem;  // the score slices of Q and K
  float* vc = wide_smem;  // then V's chunk [kTile][kChunk]

  const int nch = chunks(D);
  const int q0 = static_cast<int>(blockIdx.x) / nch * kTile;
  const int c0 = static_cast<int>(blockIdx.x) % nch * kChunk;
  const int h = blockIdx.y, b = blockIdx.z;
  const int Sq = walk.Sq, Sk = walk.Sk, causal = walk.causal;
  const int tid = threadIdx.x, lane = tid % 32, r = tid / kTPR, j = tid % kTPR;
  const int qrow = q0 + r;
  const bool dropping = drop.threshold < 256;
  const uint32_t seed = dropping ? static_cast<uint32_t>(*drop.seed) : 0u;
  const uint32_t bh = static_cast<uint32_t>(b * H + h);
  const uint32_t threshold = static_cast<uint32_t>(drop.threshold);
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;

  float acc[kCC];
#pragma unroll
  for (int c = 0; c < kCC; ++c) acc[c] = 0.f;
  float m = DS_MASK_VALUE, l = 0.f;

  walk.keys(h, q0, [&](int n0) {
    float s[kNS], unused[kNS];
    slice_scores<false>(s, unused, sl, qb, qs.s, kb, ks.s, qb, qs.s, kb, ks.s, q0, Sq, n0,
                        Sk, D, r, j);
    float mt = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
      const int col = n0 + j + kTPR * i;
      float sv = s[i] * sm_scale;
      if (col >= Sk) {
        sv = -CUDART_INF_F;  // past the ragged edge: weight 0
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
    if (dropping) {  // after l took the raw P: only the P V input is dropped
      const uint4 bytes = ds_dropout_bytes(seed, bh, qrow, n0, j);
#pragma unroll
      for (int i = 0; i < kNS; ++i)
        s[i] = ds_byte(bytes, i) < threshold ? s[i] * drop.scale : 0.f;
    }
    __syncthreads();  // the slices are consumed: V's chunk goes over them
    load_rows<kChunk, kChunk>(vc, vb, vs.s, n0, Sk, c0, D);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kCC; ++c) acc[c] *= alpha;
    const int base = lane & ~(kTPR - 1);
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
#pragma unroll
      for (int jj = 0; jj < kTPR; ++jj) {
        const float p = __shfl_sync(0xffffffffu, s[i], base | jj);
        const float* vrow = vc + (kTPR * i + jj) * kChunk;
#pragma unroll
        for (int c = 0; c < kCC; ++c) acc[c] = fmaf(p, vrow[j + kTPR * c], acc[c]);
      }
    }
  });

  if (qrow < Sq) {
    const float denom = l == 0.f ? 1.f : l;
    T* orow = o + b * os.b + h * os.h + qrow * os.s;
#pragma unroll
    for (int c = 0; c < kCC; ++c) {
      const int col = c0 + j + kTPR * c;
      if (col < D) orow[col] = ds_from_float<T>(acc[c] / denom);
    }
    if (c0 == 0 && j == 0)
      lse[(static_cast<size_t>(b) * H + h) * Sq + qrow] = m + logf(l + 1e-37f);
  }
}

// The backward's elementwise step for this thread's row (qrow, whose lse
// and delta are given) against keys n0 + j + 4 i: s holds the scores and
// dp dO V^T on entry, P and dS = P (dP_drop - delta) scale on exit, and
// p_drop the dropped P.  A row whose forward saw no key (lse at the mask
// value: F's empty layout rows) has P = 0.
__device__ __forceinline__ void grads(float (&s)[kNS], float (&dp)[kNS], float (&p_drop)[kNS],
                                      int qrow, int n0, int j, float lse_r, float delta_r,
                                      float sm_scale, int Sq, int Sk, int causal, uint32_t seed,
                                      uint32_t bh, const Dropout& drop) {
  const bool dropping = drop.threshold < 256;
  uint4 bytes = make_uint4(0u, 0u, 0u, 0u);
  if (dropping) bytes = ds_dropout_bytes(seed, bh, qrow, n0, j);
  const uint32_t threshold = static_cast<uint32_t>(drop.threshold);
  const bool row_live = qrow < Sq && lse_r > 0.5f * DS_MASK_VALUE;
#pragma unroll
  for (int i = 0; i < kNS; ++i) {
    const int col = n0 + j + kTPR * i;
    const bool live = row_live && col < Sk && !(causal && col > qrow);
    const float p = live ? expf(s[i] * sm_scale - lse_r) : 0.f;
    float dpv = dp[i], pd = p;
    if (dropping) {
      const bool keep = ds_byte(bytes, i) < threshold;
      dpv = keep ? dpv * drop.scale : 0.f;
      pd = keep ? p * drop.scale : 0.f;
    }
    s[i] = p;
    p_drop[i] = pd;
    dp[i] = p * (dpv - delta_r) * sm_scale;
  }
}

// ------------------------------------------------------------------- //
// dq (E, G): one block per (q-tile, chunk), walking the q-tile's keys
// ------------------------------------------------------------------- //
template <typename T, class Walk>
__global__ void __launch_bounds__(kThreads)
wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dq, int H, int D,
               HeadStrides qs, HeadStrides ks, HeadStrides vs, HeadStrides dos,
               HeadStrides dqs, float sm_scale, Walk walk, Dropout drop) {
  extern __shared__ float wide_smem[];
  float* sl = wide_smem;  // the score slices of Q, K, dO and V
  float* kc = wide_smem;  // then K's chunk [kTile][kChunk]

  const int nch = chunks(D);
  const int q0 = static_cast<int>(blockIdx.x) / nch * kTile;
  const int c0 = static_cast<int>(blockIdx.x) % nch * kChunk;
  const int h = blockIdx.y, b = blockIdx.z;
  const int Sq = walk.Sq, Sk = walk.Sk, causal = walk.causal;
  const int tid = threadIdx.x, lane = tid % 32, r = tid / kTPR, j = tid % kTPR;
  const int qrow = q0 + r;
  const uint32_t seed = drop.threshold < 256 ? static_cast<uint32_t>(*drop.seed) : 0u;
  const uint32_t bh = static_cast<uint32_t>(b * H + h);
  const size_t stat = (static_cast<size_t>(b) * H + h) * Sq + qrow;
  const float lse_r = qrow < Sq ? lse[stat] : 0.f;
  const float delta_r = qrow < Sq ? delta[stat] : 0.f;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const T* dob = dout + b * dos.b + h * dos.h;

  float acc[kCC];
#pragma unroll
  for (int c = 0; c < kCC; ++c) acc[c] = 0.f;

  walk.keys(h, q0, [&](int n0) {
    float s[kNS], ds[kNS], pd[kNS];
    slice_scores<true>(s, ds, sl, qb, qs.s, kb, ks.s, dob, dos.s, vb, vs.s, q0, Sq, n0,
                       Sk, D, r, j);
    grads(s, ds, pd, qrow, n0, j, lse_r, delta_r, sm_scale, Sq, Sk, causal, seed,
          bh, drop);
    __syncthreads();  // the slices are consumed: K's chunk goes over them
    load_rows<kChunk, kChunk>(kc, kb, ks.s, n0, Sk, c0, D);
    __syncthreads();
    // dq[row] += sum_col dS[col] K_c[col]: the row's 64 dS values are
    // spread over its 4 threads; fetch the others' by shuffle
    const int base = lane & ~(kTPR - 1);
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
#pragma unroll
      for (int jj = 0; jj < kTPR; ++jj) {
        const float dsv = __shfl_sync(0xffffffffu, ds[i], base | jj);
        const float* krow = kc + (kTPR * i + jj) * kChunk;
#pragma unroll
        for (int c = 0; c < kCC; ++c) acc[c] = fmaf(dsv, krow[j + kTPR * c], acc[c]);
      }
    }
  });

  if (qrow < Sq) {
    T* dqrow = dq + b * dqs.b + h * dqs.h + qrow * dqs.s;
#pragma unroll
    for (int c = 0; c < kCC; ++c) {
      const int col = c0 + j + kTPR * c;
      if (col < D) dqrow[col] = ds_from_float<T>(acc[c]);
    }
  }
}

// ------------------------------------------------------------------- //
// dk / dv (E, G): one block per (k-tile, chunk), walking its q-tiles
// ------------------------------------------------------------------- //
template <typename T, class Walk>
__global__ void __launch_bounds__(kThreads)
wide_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int H,
                 int D, HeadStrides qs, HeadStrides ks, HeadStrides vs, HeadStrides dos,
                 HeadStrides dks, HeadStrides dvs, float sm_scale, Walk walk, Dropout drop) {
  extern __shared__ float wide_smem[];
  float* sl = wide_smem;                      // the score slices of Q, K, dO and V
  float* qc = wide_smem;                      // then Q's chunk [kTile][kChunk]
  float* dc = qc + kTile * kChunk;            // ... and dO's
  float* pds = wide_smem + kDkdvRegion;       // [kTile][kPP] dropped P
  float* dss = pds + kTile * kPP;             // [kTile][kPP] dS
  float* lse_s = dss + kTile * kPP;           // [kTile]
  float* delta_s = lse_s + kTile;             // [kTile]

  const int nch = chunks(D);
  const int n0 = static_cast<int>(blockIdx.x) / nch * kTile;
  const int c0 = static_cast<int>(blockIdx.x) % nch * kChunk;
  const int h = blockIdx.y, b = blockIdx.z;
  const int Sq = walk.Sq, Sk = walk.Sk, causal = walk.causal;
  const int tid = threadIdx.x, r = tid / kTPR, j = tid % kTPR;
  const uint32_t seed = drop.threshold < 256 ? static_cast<uint32_t>(*drop.seed) : 0u;
  const uint32_t bh = static_cast<uint32_t>(b * H + h);
  const size_t stat0 = (static_cast<size_t>(b) * H + h) * Sq;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const T* dob = dout + b * dos.b + h * dos.h;

  float dk_acc[kCC], dv_acc[kCC];
#pragma unroll
  for (int c = 0; c < kCC; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  walk.queries(h, n0, [&](int m0) {
    // (the last tile's elementwise step read these before its barriers)
    for (int i = tid; i < kTile; i += kThreads) {
      const bool ok = m0 + i < Sq;
      lse_s[i] = ok ? lse[stat0 + m0 + i] : 0.f;
      delta_s[i] = ok ? delta[stat0 + m0 + i] : 0.f;
    }
    // score phase: r is a query row of the tile
    float s[kNS], dp[kNS], pd[kNS];
    slice_scores<true>(s, dp, sl, qb, qs.s, kb, ks.s, dob, dos.s, vb, vs.s, m0, Sq, n0,
                       Sk, D, r, j);
    grads(s, dp, pd, m0 + r, n0, j, lse_s[r], delta_s[r], sm_scale, Sq, Sk,
          causal, seed, bh, drop);
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
      pds[r * kPP + j + kTPR * i] = pd[i];
      dss[r * kPP + j + kTPR * i] = dp[i];
    }
    __syncthreads();  // P_drop and dS are written; the slices are consumed
    load_rows<kChunk, kChunk>(qc, qb, qs.s, m0, Sq, c0, D);
    load_rows<kChunk, kChunk>(dc, dob, dos.s, m0, Sq, c0, D);
    __syncthreads();
    // sum phase: r is a key row; dv[r] += sum_m P_drop[m][r] dO_c[m],
    // dk[r] += sum_m dS[m][r] Q_c[m]
#pragma unroll 4
    for (int mm = 0; mm < kTile; ++mm) {
      const float pv = pds[mm * kPP + r];
      const float sv = dss[mm * kPP + r];
      const float* dorow = dc + mm * kChunk;
      const float* qrow = qc + mm * kChunk;
#pragma unroll
      for (int c = 0; c < kCC; ++c) {
        dv_acc[c] = fmaf(pv, dorow[j + kTPR * c], dv_acc[c]);
        dk_acc[c] = fmaf(sv, qrow[j + kTPR * c], dk_acc[c]);
      }
    }
  });

  const int krow = n0 + r;
  if (krow < Sk) {
    T* dkrow = dk + b * dks.b + h * dks.h + krow * dks.s;
    T* dvrow = dv + b * dvs.b + h * dvs.h + krow * dvs.s;
#pragma unroll
    for (int c = 0; c < kCC; ++c) {
      const int col = c0 + j + kTPR * c;
      if (col < D) {
        dkrow[col] = ds_from_float<T>(dk_acc[c]);
        dvrow[col] = ds_from_float<T>(dv_acc[c]);
      }
    }
  }
}

// ------------------------------------------------------------------- //
// launchers: grid (tiles x chunks, H, B), the chunk fastest so that the
// blocks of one tile, which stream the same score slices, run together
// ------------------------------------------------------------------- //
inline dim3 grid(int tiles, int D, int H, int B) {
  return dim3(static_cast<unsigned>(tiles * chunks(D)), H, B);
}

template <typename T, class Walk, class S>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
               int D, S qs, S ks, S vs, S os, float sm_scale, Walk walk, Dropout drop,
               cudaStream_t stream) {
  const int tiles = (walk.Sq + kTile - 1) / kTile;
  wide_fwd_kernel<T, Walk><<<grid(tiles, D, H, B), kThreads, kFwdSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, D, head_strides(qs), head_strides(ks), head_strides(vs),
      head_strides(os), sm_scale, walk, drop);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, class Walk, class S>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, int B, int H, int D, S qs, S ks, S vs, S dos, S dqs,
              float sm_scale, Walk walk, Dropout drop, cudaStream_t stream) {
  const int tiles = (walk.Sq + kTile - 1) / kTile;
  wide_dq_kernel<T, Walk><<<grid(tiles, D, H, B), kThreads, kDqSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), H, D, head_strides(qs),
      head_strides(ks), head_strides(vs), head_strides(dos), head_strides(dqs), sm_scale, walk,
      drop);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, class Walk, class S>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                const float* delta, void* dk, void* dv, int B, int H, int D, S qs, S ks, S vs,
                S dos, S dks, S dvs, float sm_scale, Walk walk, Dropout drop,
                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(wide_dkdv_kernel<T, Walk>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDkdvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (walk.Sk + kTile - 1) / kTile;
  wide_dkdv_kernel<T, Walk><<<grid(tiles, D, H, B), kThreads, kDkdvSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, D,
      head_strides(qs), head_strides(ks), head_strides(vs), head_strides(dos), head_strides(dks),
      head_strides(dvs), sm_scale, walk, drop);
  return static_cast<int>(cudaGetLastError());
}

// ===================================================================== //
// bf16: the same chunked steps on the tensor cores
// ===================================================================== //
// The tiled kernels' `mma.sync` pieces (attention_mma.cuh) on slices: Q
// and K (and dO and V) arrive in 64-column slices through `cp.async` into
// swizzled bf16 tiles, each warp's 16 x 64 score fragments accumulate over
// the slices in registers, and P (dS, P_drop) reaches the chunk's product
// from registers: P V_c, dS K_c (a warp's 16 rows, 4 warps), P_drop^T dO_c
// and dS^T Q_c (a warp's 16 keys; two groups of four warps, each owning
// 64 of the chunk's 128 columns and both computing the scores, as D = 256
// does).  D must be a multiple of 8 (the wrappers pad it).
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kSliceCols = 64;
constexpr int kSliceBytes = ds_mma::tile_bytes<kSliceCols>(kTile);  // [64][64]
constexpr int kChunkBytes = ds_mma::tile_bytes<kChunk>(kTile);      // [64][128]
constexpr int kRowThreads = 128;   // forward and dq: 4 warps of 16 rows
constexpr int kKeyThreads = 256;   // dk/dv: 2 groups of 4 warps of 16 keys
constexpr int kKeyCols = kChunk / 2;  // output columns of a dk/dv warp
constexpr int kFwdSmem = 2 * kSliceBytes + kChunkBytes + kTile * 8;
constexpr int kDqSmem = 4 * kSliceBytes + kChunkBytes + kTile * 8;
constexpr int kDkdvSmem = 4 * kSliceBytes + 2 * kChunkBytes + 2 * kTile * 4 + kTile * 8;

// s[16 x 64] += A[a_r0 .. a_r0 + 16) . B^T over one 64-column slice; A and
// B are slice tiles [64][64].
__device__ __forceinline__ void slice_abt(float (&s)[kTile / 8][4], uint32_t a_tile, int a_r0,
                                          uint32_t b_tile, int lane) {
#pragma unroll
  for (int ks = 0; ks < kSliceCols / 16; ++ks) {
    uint32_t a[4];
    ds_mma::ldsm_x4(a, ds_mma::frag_addr<kSliceCols>(a_tile, a_r0, 16 * ks, lane));
#pragma unroll
    for (int jp = 0; jp < kTile / 16; ++jp) {
      uint32_t b[4];
      ds_mma::ldsm_x4(b, ds_mma::frag_addr_nt<kSliceCols>(b_tile, 16 * jp, 16 * ks, lane));
      ds_mma::mma_16816(s[2 * jp], a, b[0], b[1]);
      ds_mma::mma_16816(s[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&s)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
}

// The scores of one tile over the whole D: for each 64-column slice, rows
// [ra, ra + 64) of A (and A2) and [rb, rb + 64) of B (and B2) into their
// slice tiles, then s += A B^T (and s2 += A2 B2^T) for the warp's 16 rows
// from w0 (unless `idle`).  NT threads; the first barrier also orders the
// call after the block's last use of the slice tiles, the last one before
// their next use.
template <int NT, bool kTwo>
__device__ __forceinline__ void slice_scores(float (&s)[kTile / 8][4], float (&s2)[kTile / 8][4],
                                             uint32_t at, uint32_t bt, uint32_t a2t, uint32_t b2t,
                                             const bf16* a, long long as, const bf16* b,
                                             long long bs, const bf16* a2, long long a2s,
                                             const bf16* b2, long long b2s, int ra, int Sa,
                                             int rb, int Sb, int D, int w0, bool idle, int tid,
                                             int lane) {
  zero(s);
  if (kTwo) zero(s2);
  for (int d0 = 0; d0 < D; d0 += kSliceCols) {
    __syncthreads();  // the slice tiles are free
    ds_mma::load_tile_async<kTile, kSliceCols, NT>(at, a + d0, as, ra, Sa, tid, D - d0);
    ds_mma::load_tile_async<kTile, kSliceCols, NT>(bt, b + d0, bs, rb, Sb, tid, D - d0);
    if (kTwo) {
      ds_mma::load_tile_async<kTile, kSliceCols, NT>(a2t, a2 + d0, a2s, ra, Sa, tid, D - d0);
      ds_mma::load_tile_async<kTile, kSliceCols, NT>(b2t, b2 + d0, b2s, rb, Sb, tid, D - d0);
    }
    ds_mma::cp_async_commit();
    ds_mma::cp_async_wait<0>();
    __syncthreads();
    if (!idle) {
      slice_abt(s, at, w0, bt, lane);
      if (kTwo) slice_abt(s2, a2t, w0, b2t, lane);
    }
  }
  __syncthreads();  // the slices are consumed
}

// forward (B, F): out's chunk [64 rows][128 columns] and, from chunk 0, lse
template <class Walk>
__global__ void __launch_bounds__(kRowThreads)
wide_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                    int H, int D, HeadStrides qs, HeadStrides ks, HeadStrides vs,
                    HeadStrides os, float sm_scale, Walk walk, Dropout drop) {
  extern __shared__ __align__(128) unsigned char wide_tc_smem[];
  const uint32_t s_q = ds_mma::smem_u32(wide_tc_smem);
  const uint32_t s_k = s_q + kSliceBytes;
  unsigned char* vc = wide_tc_smem + 2 * kSliceBytes;  // V's chunk, then out's
  const uint32_t s_v = ds_mma::smem_u32(vc);
  uint64_t* bits = reinterpret_cast<uint64_t*>(vc + kChunkBytes);

  const int nch = chunks(D);
  const int q0 = static_cast<int>(blockIdx.x) / nch * kTile;
  const int c0 = static_cast<int>(blockIdx.x) % nch * kChunk;
  const int h = blockIdx.y, b = blockIdx.z;
  const int Sq = walk.Sq, Sk = walk.Sk, causal = walk.causal;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int w0 = warp * 16, row0 = q0 + w0;
  const int rows[2] = {row0 + (lane >> 2), row0 + (lane >> 2) + 8};
  const bool dropping = drop.threshold < 256;
  const uint32_t seed = dropping ? static_cast<uint32_t>(*drop.seed) : 0u;
  const uint32_t bh = static_cast<uint32_t>(b * H + h);
  const uint32_t threshold = static_cast<uint32_t>(drop.threshold);
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const int cols = min(kChunk, D - c0);  // of this chunk

  float acc[kChunk / 8][4];
  zero(acc);
  float m[2] = {DS_MASK_VALUE, DS_MASK_VALUE};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  walk.keys(h, q0, [&](int n0) {
    // V's chunk and the tile's keep bits, in flight during the scores
    __syncthreads();  // the last tile's P V is done
    ds_mma::load_tile_async<kTile, kChunk, kRowThreads>(s_v, vb + c0, vs.s, n0, Sk, tid, cols);
    if (dropping)
      ds_mma::draw_keep_bits<kTile, kRowThreads>(bits, seed, bh, q0, n0, threshold, tid);
    const bool idle = causal && n0 > row0 + 15;  // the warp's rows all lie above the tile
    float s[kTile / 8][4], unused[kTile / 8][4];
    slice_scores<kRowThreads, false>(s, unused, s_q, s_k, 0, 0, qb, qs.s, kb, ks.s, qb, qs.s,
                                     kb, ks.s, q0, Sq, n0, Sk, D, w0, idle, tid, lane);
    if (idle) return;
    const bool edge = n0 + kTile > Sk || (causal && n0 + kTile - 1 > row0);
    ds_mma::fwd_softmax_pv<kChunk, kChunk, true>(acc, m, l, s, s_v, n0, rows, Sk, causal, edge,
                                                 sm_scale, dropping, bits + w0 + (lane >> 2),
                                                 lane, 0);
  });

  __syncthreads();  // every warp is done with V's chunk: out goes through it
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = ds_mma::quad_sum(l[r]);
    inv[r] = (dropping ? drop.scale : 1.f) / (l[r] == 0.f ? 1.f : l[r]);
  }
  ds_mma::acc_to_tile<kChunk>(vc, w0, acc, inv[0], inv[1], lane);
  __syncwarp();
  ds_mma::tile_rows_to_global<kChunk>(o + b * os.b + h * os.h + c0, os.s, row0, Sq, vc, w0, lane,
                                      cols);
  if (c0 == 0 && (lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (rows[r] < Sq)
        lse[(static_cast<size_t>(b) * H + h) * Sq + rows[r]] = m[r] + logf(l[r] + 1e-37f);
  }
}

// dq (E, G): dq's chunk of a q-tile, walking its keys
template <class Walk>
__global__ void __launch_bounds__(kRowThreads)
wide_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dq, int H, int D, HeadStrides qs, HeadStrides ks,
                   HeadStrides vs, HeadStrides dos, HeadStrides dqs, float sm_scale, Walk walk,
                   Dropout drop) {
  extern __shared__ __align__(128) unsigned char wide_tc_smem[];
  const uint32_t s_q = ds_mma::smem_u32(wide_tc_smem);
  const uint32_t s_k = s_q + kSliceBytes, s_do = s_k + kSliceBytes, s_v = s_do + kSliceBytes;
  unsigned char* kc = wide_tc_smem + 4 * kSliceBytes;  // K's chunk, then dq's
  const uint32_t s_kc = ds_mma::smem_u32(kc);
  uint64_t* bits = reinterpret_cast<uint64_t*>(kc + kChunkBytes);

  const int nch = chunks(D);
  const int q0 = static_cast<int>(blockIdx.x) / nch * kTile;
  const int c0 = static_cast<int>(blockIdx.x) % nch * kChunk;
  const int h = blockIdx.y, b = blockIdx.z;
  const int Sq = walk.Sq, Sk = walk.Sk, causal = walk.causal;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int w0 = warp * 16, row0 = q0 + w0;
  const int rows[2] = {row0 + (lane >> 2), row0 + (lane >> 2) + 8};
  const bool dropping = drop.threshold < 256;
  const uint32_t seed = dropping ? static_cast<uint32_t>(*drop.seed) : 0u;
  const uint32_t bh = static_cast<uint32_t>(b * H + h);
  const uint32_t threshold = static_cast<uint32_t>(drop.threshold);
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const bf16* dob = dout + b * dos.b + h * dos.h;
  const int cols = min(kChunk, D - c0);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = rows[r] < Sq;
    lse_r[r] = ok ? lse[static_cast<size_t>(bh) * Sq + rows[r]] : 0.f;
    delta_r[r] = ok ? delta[static_cast<size_t>(bh) * Sq + rows[r]] : 0.f;
  }
  // a row whose forward saw no key (F's empty layout rows): P = 0
  const bool live[2] = {lse_r[0] > 0.5f * DS_MASK_VALUE, lse_r[1] > 0.5f * DS_MASK_VALUE};

  float acc[kChunk / 8][4];
  zero(acc);
  walk.keys(h, q0, [&](int n0) {
    __syncthreads();  // the last tile's dS K_c is done
    ds_mma::load_tile_async<kTile, kChunk, kRowThreads>(s_kc, kb + c0, ks.s, n0, Sk, tid, cols);
    if (dropping)
      ds_mma::draw_keep_bits<kTile, kRowThreads>(bits, seed, bh, q0, n0, threshold, tid);
    const bool idle = causal && n0 > row0 + 15;
    float s[kTile / 8][4], dp[kTile / 8][4];
    slice_scores<kRowThreads, true>(s, dp, s_q, s_k, s_do, s_v, qb, qs.s, kb, ks.s, dob, dos.s,
                                    vb, vs.s, q0, Sq, n0, Sk, D, w0, idle, tid, lane);
    if (idle) return;
    const bool edge = n0 + kTile > Sk || (causal && n0 + kTile - 1 > row0);
    const uint32_t keep =
        dropping ? ds_mma::fragment_keep(bits[w0 + (lane >> 2)], bits[w0 + (lane >> 2) + 8], lane)
                 : 0u;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, ci = ds_mma::frag_col(lane, j, e);
        float pv = exp2f((s[j][e] * sm_scale - lse_r[r]) * ds_mma::kLog2e);
        if (!live[r] || (edge && (n0 + ci >= Sk || (causal && n0 + ci > rows[r])))) pv = 0.f;
        float dpv = dp[j][e];
        if (dropping) dpv = ds_mma::kept(keep, j, e) ? dpv * drop.scale : 0.f;
        s[j][e] = pv * (dpv - delta_r[r]) * sm_scale;  // dS
      }
    }
    uint32_t a[kTile / 16][4];
    ds_mma::acc_to_a<kTile>(a, s);
    ds_mma::warp_ab<kTile, kChunk>(acc, a, s_kc, 0, lane);
  });

  __syncthreads();  // every warp is done with K's chunk: dq goes through it
  ds_mma::acc_to_tile<kChunk>(kc, w0, acc, 1.f, 1.f, lane);
  __syncwarp();
  ds_mma::tile_rows_to_global<kChunk>(dq + b * dqs.b + h * dqs.h + c0, dqs.s, row0, Sq, kc, w0,
                                      lane, cols);
}

// dk / dv (E, G): the chunk of a k-tile's dk and dv, walking its q-tiles
template <class Walk>
__global__ void __launch_bounds__(kKeyThreads)
wide_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int D, HeadStrides qs,
                     HeadStrides ks, HeadStrides vs, HeadStrides dos, HeadStrides dks,
                     HeadStrides dvs, float sm_scale, Walk walk, Dropout drop) {
  extern __shared__ __align__(128) unsigned char wide_tc_smem[];
  const uint32_t s_k = ds_mma::smem_u32(wide_tc_smem);
  const uint32_t s_q = s_k + kSliceBytes, s_v = s_q + kSliceBytes, s_do = s_v + kSliceBytes;
  unsigned char* qc = wide_tc_smem + 4 * kSliceBytes;  // Q's chunk, then dk's
  unsigned char* dc = qc + kChunkBytes;                // dO's chunk, then dv's
  const uint32_t s_qc = ds_mma::smem_u32(qc), s_dc = ds_mma::smem_u32(dc);
  float* lse_s = reinterpret_cast<float*>(dc + kChunkBytes);
  float* delta_s = lse_s + kTile;
  uint64_t* bits = reinterpret_cast<uint64_t*>(delta_s + kTile);

  const int nch = chunks(D);
  const int n0 = static_cast<int>(blockIdx.x) / nch * kTile;
  const int c0 = static_cast<int>(blockIdx.x) % nch * kChunk;
  const int h = blockIdx.y, b = blockIdx.z;
  const int Sq = walk.Sq, Sk = walk.Sk, causal = walk.causal;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int w0 = (warp & 3) * 16, col0 = (warp >> 2) * kKeyCols, key0 = n0 + w0;
  const bool dropping = drop.threshold < 256;
  const uint32_t seed = dropping ? static_cast<uint32_t>(*drop.seed) : 0u;
  const uint32_t bh = static_cast<uint32_t>(b * H + h);
  const uint32_t threshold = static_cast<uint32_t>(drop.threshold);
  const float* lse_b = lse + static_cast<size_t>(bh) * Sq;
  const float* delta_b = delta + static_cast<size_t>(bh) * Sq;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const bf16* dob = dout + b * dos.b + h * dos.h;
  const int cols = min(kChunk, D - c0);

  float dk_acc[kKeyCols / 8][4], dv_acc[kKeyCols / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  walk.queries(h, n0, [&](int m0) {
    __syncthreads();  // the last tile's products are done
    ds_mma::load_tile_async<kTile, kChunk, kKeyThreads>(s_qc, qb + c0, qs.s, m0, Sq, tid, cols);
    ds_mma::load_tile_async<kTile, kChunk, kKeyThreads>(s_dc, dob + c0, dos.s, m0, Sq, tid, cols);
    ds_mma::load_stat_async<kTile, kKeyThreads>(ds_mma::smem_u32(lse_s), lse_b, m0, Sq, tid);
    ds_mma::load_stat_async<kTile, kKeyThreads>(ds_mma::smem_u32(delta_s), delta_b, m0, Sq, tid);
    if (dropping)
      ds_mma::draw_keep_bits<kTile, kKeyThreads>(bits, seed, bh, m0, n0, threshold, tid);
    const bool idle = causal && m0 + kTile - 1 < key0;  // every query precedes the warp's keys
    // accumulator rows are keys (w0 + frag_row), columns queries (frag_col)
    float p[kTile / 8][4], ds[kTile / 8][4];
    slice_scores<kKeyThreads, true>(p, ds, s_k, s_q, s_v, s_do, kb, ks.s, qb, qs.s, vb, vs.s,
                                    dob, dos.s, n0, Sk, m0, Sq, D, w0, idle, tid, lane);
    if (idle) return;
    const bool edge = m0 + kTile > Sq || n0 + kTile > Sk || (causal && m0 < key0 + 15);
    const uint32_t keep = dropping ? ds_mma::fragment_keep_t(bits, w0 + (lane >> 2), lane) : 0u;
    uint32_t a[kTile / 16][4];
    {
      float pd[kTile / 8][4];
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = ds_mma::frag_col(lane, j, e), ki = w0 + ds_mma::frag_row(lane, e);
          float pv = exp2f((p[j][e] * sm_scale - lse_s[qi]) * ds_mma::kLog2e);
          if (!(lse_s[qi] > 0.5f * DS_MASK_VALUE) ||
              (edge && (m0 + qi >= Sq || n0 + ki >= Sk || (causal && m0 + qi < n0 + ki))))
            pv = 0.f;
          p[j][e] = pv;
          pd[j][e] = dropping && !ds_mma::kept(keep, j, e) ? 0.f : pv;
        }
      }
      ds_mma::acc_to_a<kTile>(a, pd);
    }
    ds_mma::warp_ab<kTile, kChunk, kKeyCols>(dv_acc, a, s_dc, 0, lane, col0);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = ds_mma::frag_col(lane, j, e);
        float dpv = ds[j][e];
        if (dropping) dpv = ds_mma::kept(keep, j, e) ? dpv * drop.scale : 0.f;
        ds[j][e] = p[j][e] * (dpv - delta_s[qi]) * sm_scale;
      }
    }
    ds_mma::acc_to_a<kTile>(a, ds);
    ds_mma::warp_ab<kTile, kChunk, kKeyCols>(dk_acc, a, s_qc, 0, lane, col0);
  });

  __syncthreads();  // every warp is done with the chunks: dk and dv go through them
  const float dv_scale = dropping ? drop.scale : 1.f;
  ds_mma::acc_to_tile<kChunk, kKeyCols>(qc, w0, dk_acc, 1.f, 1.f, lane, col0);
  ds_mma::acc_to_tile<kChunk, kKeyCols>(dc, w0, dv_acc, dv_scale, dv_scale, lane, col0);
  __syncwarp();
  ds_mma::tile_rows_to_global<kChunk, kKeyCols>(dk + b * dks.b + h * dks.h + c0, dks.s, key0, Sk,
                                                qc, w0, lane, cols, col0);
  ds_mma::tile_rows_to_global<kChunk, kKeyCols>(dv + b * dvs.b + h * dvs.h + c0, dvs.s, key0, Sk,
                                                dc, w0, lane, cols, col0);
}

template <class F>
int set_smem(F kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <class Walk, class S>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
               int D, S qs, S ks, S vs, S os, float sm_scale, Walk walk, Dropout drop,
               cudaStream_t stream) {
  const int tiles = (walk.Sq + kTile - 1) / kTile;
  wide_fwd_mma_kernel<Walk><<<grid(tiles, D, H, B), kRowThreads, kFwdSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, H, D, head_strides(qs), head_strides(ks), head_strides(vs),
      head_strides(os), sm_scale, walk, drop);
  return static_cast<int>(cudaGetLastError());
}

template <class Walk, class S>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, int B, int H, int D, S qs, S ks, S vs, S dos, S dqs,
              float sm_scale, Walk walk, Dropout drop, cudaStream_t stream) {
  const int err = set_smem(wide_dq_mma_kernel<Walk>, kDqSmem);
  if (err != 0) return err;
  const int tiles = (walk.Sq + kTile - 1) / kTile;
  wide_dq_mma_kernel<Walk><<<grid(tiles, D, H, B), kRowThreads, kDqSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), H, D, head_strides(qs),
      head_strides(ks), head_strides(vs), head_strides(dos), head_strides(dqs), sm_scale, walk,
      drop);
  return static_cast<int>(cudaGetLastError());
}

template <class Walk, class S>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                const float* delta, void* dk, void* dv, int B, int H, int D, S qs, S ks, S vs,
                S dos, S dks, S dvs, float sm_scale, Walk walk, Dropout drop,
                cudaStream_t stream) {
  const int err = set_smem(wide_dkdv_mma_kernel<Walk>, kDkdvSmem);
  if (err != 0) return err;
  const int tiles = (walk.Sk + kTile - 1) / kTile;
  wide_dkdv_mma_kernel<Walk><<<grid(tiles, D, H, B), kKeyThreads, kDkdvSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      H, D, head_strides(qs), head_strides(ks), head_strides(vs), head_strides(dos),
      head_strides(dks), head_strides(dvs), sm_scale, walk, drop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace ds_wide
