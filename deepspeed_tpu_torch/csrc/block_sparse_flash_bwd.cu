// Kernel G: block-sparse flash-attention backward (FlashAttention-2 over a
// SparsityConfig layout), two launches:
//   dq:   one block per (q-tile of 64 rows, head, batch) walks the forward
//         gather indices (the k-blocks its layout row allows) and writes dq;
//   dkdv: one block per (k-tile of 64 keys, head, batch) walks the
//         transposed indices (the q-blocks whose rows allow its k-block)
//         and writes dk, dv.
// Neither needs atomics: each output tile has exactly one block that owns
// it, so the sums are taken in a fixed order and a step is repeatable
// bitwise.
//
// Replaces: deepspeed_tpu/ops/sparse_attention/block_sparse_flash.py
// block_sparse_flash_bwd (_bsf_dq_kernel, _bsf_dkdv_kernel).  Same math,
// from the forward's logsumexp and delta = rowsum(dO * O) (computed beside
// the launch, as the JAX package leaves it to XLA):
//   P  = exp(S * scale - lse), 0 above the causal diagonal;
//   dP = dO V^T;  dS = P * (dP - delta) * scale;
//   dV += P^T dO;  dK += dS^T Q;  dQ += dS K.
// A k-block wholly above the causal diagonal is skipped, as the TPU
// kernels' `live` test skips it.  A row whose forward saw no live block
// (out = 0, lse = DEFAULT_MASK_VALUE) never reaches exp(S - lse), which
// would overflow: every row of a q-block shares its layout row, so such a
// row's q-block has no live entry in either walk; the dq launch also
// treats a row whose lse is the mask value as empty (its lse taken as
// +inf, so P = 0).  Products accumulate in fp32 and are stored in the
// input dtype.  S is a multiple of the layout block, and the block of 64.
//
// Bound on the H100: at the long-context training shape ([2, 12, 8192, 64]
// bf16, causal BigBird with block 512, 49 full and 16 diagonal live blocks
// per head) dq does three [512, 512] x 64 products per live block
// (~138 GFLOP) and dk/dv four (~184 GFLOP), against ~100-150 MB of
// operands: operations bound both (~140 and ~186 us at the bf16
// tensor-core peak).
//
// Head dims above 256 run the wide kernels of attention_wide.cuh over the
// same layout walks (bf16 on the tensor cores, fp32 on the CUDA cores): the
// output columns in chunks of 128 over the grid.  Up to
// 256, any D runs, on either route, the smallest
// instantiation (32, 64, 96, 128, 256) at or above it; the columns past
// the true D are zero-filled on load, so they add nothing to a product,
// and are never stored.  The tensor-core route takes D a multiple of 8
// (its 16-byte copies): the Python wrapper pads any other D with zero
// columns up to one, and passes the true D's 1 / sqrt(D).  D = 256 splits
// the output columns over two groups of four warps on the tensor cores
// (ds_mma::ColumnSplit) and runs 32 x 32 tiles on the CUDA cores, as
// kernel E does.
//
// Two routes, chosen by the operands' dtype:
//
// bf16, tensor cores (tc::bsf_bwd_dq_mma_kernel and
// tc::bsf_bwd_dkdv_mma_kernel, D in {32, 64, 96, 128, 256}).  Kernel E's
// tensor-core kernels (`mma.sync` m16n8k16 from two `cp.async` stages of
// swizzled bf16 tiles, each warp 16 query rows in dq and 16 keys in dk/dv,
// P and dS fed to their next product from registers: nothing is staged in
// shared memory) with their per-tile work shared (ds_mma::bwd_dq_tile_step,
// ds_mma::bwd_dkdv_tile_step), walking the layout as kernel F does: one
// warp reads the layout row once into shared memory, and the block walks
// (live block, 64-wide sub-tile) as one flat sequence, the next sub-tile's
// copy in flight across block boundaries.  In dk/dv the walk runs over the
// q sub-tiles of the q-blocks that attend to the k-tile's block and, in the
// diagonal layout block, skips those wholly above the k-tile.  The dq grid
// runs the q-tiles in reverse order and the dk/dv grid the k-tiles in
// order, across all heads: the heavy tiles first (the last rows of a causal
// layout; the global block's column, which every q-block sees).
//
// fp32, CUDA cores (fp32::bsf_bwd_dq_kernel, fp32::bsf_bwd_dkdv_kernel, the
// first design, kept as it was).  A tensor-core fp32 product would be TF32
// and miss the fp32 parity.  Kernel E's fp32 tiles and thread layout (256
// threads; for the scores of a 64 x 64 tile, 4 threads share a query row
// and each holds 16 columns), walking the layout row's valid entries;
// dk/dv stages P and dS in shared memory and then gives each thread a key
// row to sum over the q rows; dq sums over the keys inside the 4-thread
// row group with shuffles.  Strides are arguments on both routes, so q, k,
// v, dO and the grads may be the head views of a fused [B, S, 3 * H * D]
// projection.

#include "attention_mma.cuh"
#include "attention_wide.cuh"
#include "block_sparse_walk.cuh"

namespace {

using ds_bsf::Layout;

struct Strides {
  long long b, h, s;
};


// ===================================================================== //
// fp32: CUDA cores
// ===================================================================== //
namespace fp32 {

constexpr int kTPR = 4;  // threads per row

// The tiles by head dim: 64 query rows and 64 keys, 256 threads; for
// D > 128, 32 and 32 with 128 threads, since four fp32 tiles of 64 rows
// (Q, dO, K, V: 263 KB at D = 256) would not fit the 227 KB of shared
// memory a block can have (a layout block is a multiple of 64, so of 32).
template <int D>
struct Tiles {
  static constexpr int kBM = D > 128 ? 32 : 64;  // query rows per tile
  static constexpr int kBN = kBM;                // keys per tile
  static constexpr int kThreads = kTPR * kBM;
  static constexpr int kNS = kBN / kTPR;         // scores per thread per tile
  static constexpr int kPP = kBN + 1;            // padded row of the P / dS tiles
};

// Load rows [r0, r0 + Tiles::kBM) of one head's [S, D] operand as fp32
// into a [kBM][DP] tile.
template <typename T, int D, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* src, Strides st,
                                          int r0, int dhead) {
  using TL = Tiles<D>;
  for (int idx = threadIdx.x; idx < TL::kBM * D; idx += TL::kThreads) {
    const int row = idx / D, col = idx % D;
    dst[row * DP + col] = col < dhead ? ds_to_float(src[(r0 + row) * st.s + col]) : 0.f;
  }
}

// The kNS scores and dP of this thread's row r against keys n0 + j + 4 i,
// turned into P (in s) and dS (in dp).
template <int D, int DP>
__device__ __forceinline__ void tile_grads(
    const float* qs, const float* dos, const float* ks, const float* vs,
    int r, int j, int qrow, int n0, float lse_r, float delta_r,
    float sm_scale, int causal, float* s, float* dp) {
  constexpr int kNS = Tiles<D>::kNS;
#pragma unroll
  for (int i = 0; i < kNS; ++i) {
    s[i] = 0.f;
    dp[i] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float qd = qs[r * DP + d];
    const float dod = dos[r * DP + d];
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
      s[i] = fmaf(qd, ks[(j + kTPR * i) * DP + d], s[i]);
      dp[i] = fmaf(dod, vs[(j + kTPR * i) * DP + d], dp[i]);
    }
  }
  // a row whose forward saw no live block has lse = DEFAULT_MASK_VALUE
  const bool row_live = lse_r > 0.5f * DS_MASK_VALUE;
#pragma unroll
  for (int i = 0; i < kNS; ++i) {
    const int col = n0 + j + kTPR * i;
    const bool live = row_live && !(causal && col > qrow);
    const float p = live ? expf(s[i] * sm_scale - lse_r) : 0.f;
    s[i] = p;
    dp[i] = p * (dp[i] - delta_r) * sm_scale;
  }
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  using TL = Tiles<D>;
  return static_cast<size_t>(4 * TL::kBM * (D + 1) + 2 * TL::kBM * TL::kPP + 2 * TL::kBM) *
         sizeof(float);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return static_cast<size_t>(4 * Tiles<D>::kBM * (D + 1)) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(Tiles<D>::kThreads)
bsf_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, Layout lay_t, int H, int S,
                    Strides qs_, Strides ks_, Strides vs_, Strides dos_,
                    Strides dks_, Strides dvs_, float sm_scale, int dhead, int causal) {
  using TL = Tiles<D>;
  constexpr int kBM = TL::kBM, kBN = TL::kBN, kThreads = TL::kThreads, kNS = TL::kNS,
                kPP = TL::kPP;
  constexpr int DP = D + 1;
  constexpr int DC = D / kTPR;
  extern __shared__ float smem[];
  float* ks = smem;              // [kBN][DP]
  float* vs = ks + kBN * DP;     // [kBN][DP]
  float* qs = vs + kBN * DP;     // [kBM][DP]
  float* dos = qs + kBM * DP;    // [kBM][DP]
  float* ps = dos + kBM * DP;    // [kBM][kPP] P
  float* dss = ps + kBM * kPP;   // [kBM][kPP] dS
  float* lse_s = dss + kBM * kPP;
  float* delta_s = lse_s + kBM;

  const int tid = threadIdx.x;
  const int r = tid / kTPR;  // score phase: query row; sum phase: key row
  const int j = tid % kTPR;
  // natural order: the heavy first columns (a global column is seen by
  // every q-block) start first
  const int n0 = blockIdx.y * kBN;
  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int nb = S / lay_t.block;
  const int kblk = n0 / lay_t.block;  // layout k-block of this tile
  const size_t stat0 = (static_cast<size_t>(b) * H + h) * S;
  const size_t row_off = (static_cast<size_t>(h) * nb + kblk) * lay_t.max_deg;
  const int* qidx = lay_t.idx + row_off;
  const int deg = ds_bsf::row_degree(lay_t.valid + row_off, lay_t.max_deg);

  load_tile<T, D, DP>(ks, k + b * ks_.b + h * ks_.h, ks_, n0, dhead);
  load_tile<T, D, DP>(vs, v + b * vs_.b + h * vs_.h, vs_, n0, dhead);

  float dk_acc[DC], dv_acc[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) {
    dk_acc[c] = 0.f;
    dv_acc[c] = 0.f;
  }

  const T* qb = q + b * qs_.b + h * qs_.h;
  const T* dob = dout + b * dos_.b + h * dos_.h;
  for (int e = 0; e < deg; ++e) {
    const int qblk = qidx[e];
    if (causal && kblk > qblk) continue;  // wholly above the diagonal
    // causal: q-tiles whose last row lies before this k-tile see none of it
    const int m_begin = causal ? max(qblk * lay_t.block, n0)
                               : qblk * lay_t.block;
    const int m_end = qblk * lay_t.block + lay_t.block;
    for (int m0 = m_begin; m0 < m_end; m0 += kBM) {
      __syncthreads();  // the previous tile's P / dS are consumed
      load_tile<T, D, DP>(qs, qb, qs_, m0, dhead);
      load_tile<T, D, DP>(dos, dob, dos_, m0, dhead);
      for (int i = tid; i < kBM; i += kThreads) {
        lse_s[i] = lse[stat0 + m0 + i];
        delta_s[i] = delta[stat0 + m0 + i];
      }
      __syncthreads();

      float s[kNS], dp[kNS];
      tile_grads<D, DP>(qs, dos, ks, vs, r, j, m0 + r, n0, lse_s[r],
                        delta_s[r], sm_scale, causal, s, dp);
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        ps[r * kPP + j + kTPR * i] = s[i];
        dss[r * kPP + j + kTPR * i] = dp[i];
      }
      __syncthreads();

      // key row r of the tile: dv[r] += sum_m P[m][r] dO[m],
      // dk[r] += sum_m dS[m][r] Q[m]
#pragma unroll 4
      for (int m = 0; m < kBM; ++m) {
        const float pv = ps[m * kPP + r];
        const float sv = dss[m * kPP + r];
        const float* dorow = dos + m * DP;
        const float* qrow = qs + m * DP;
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dv_acc[c] = fmaf(pv, dorow[j + kTPR * c], dv_acc[c]);
          dk_acc[c] = fmaf(sv, qrow[j + kTPR * c], dk_acc[c]);
        }
      }
    }
  }

  const int krow = n0 + r;
  T* dkrow = dk + b * dks_.b + h * dks_.h + krow * dks_.s;
  T* dvrow = dv + b * dvs_.b + h * dvs_.h + krow * dvs_.s;
#pragma unroll
  for (int c = 0; c < DC; ++c) {
    if (j + kTPR * c < dhead) dkrow[j + kTPR * c] = ds_from_float<T>(dk_acc[c]);
    if (j + kTPR * c < dhead) dvrow[j + kTPR * c] = ds_from_float<T>(dv_acc[c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Tiles<D>::kThreads)
bsf_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq,
                  Layout lay, int H, int S, Strides qs_, Strides ks_,
                  Strides vs_, Strides dos_, Strides dqs_, float sm_scale, int dhead,
                  int causal) {
  using TL = Tiles<D>;
  constexpr int kBM = TL::kBM, kBN = TL::kBN, kNS = TL::kNS;
  constexpr int DP = D + 1;
  constexpr int DC = D / kTPR;
  extern __shared__ float smem[];
  float* qs = smem;            // [kBM][DP]
  float* dos = qs + kBM * DP;  // [kBM][DP]
  float* ks = dos + kBM * DP;  // [kBN][DP]
  float* vs = ks + kBN * DP;   // [kBN][DP]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int r = tid / kTPR;
  const int j = tid % kTPR;
  // reverse order: the layout's heavy last rows start first (kernel F)
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;
  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int qrow = q0 + r;
  const int nb = S / lay.block;
  const int qblk = q0 / lay.block;
  const size_t stat = (static_cast<size_t>(b) * H + h) * S + qrow;
  const float lse_r = lse[stat];
  const float delta_r = delta[stat];
  const size_t row_off = (static_cast<size_t>(h) * nb + qblk) * lay.max_deg;
  const int* kidx = lay.idx + row_off;
  const int deg = ds_bsf::row_degree(lay.valid + row_off, lay.max_deg);

  load_tile<T, D, DP>(qs, q + b * qs_.b + h * qs_.h, qs_, q0, dhead);
  load_tile<T, D, DP>(dos, dout + b * dos_.b + h * dos_.h, dos_, q0, dhead);

  float acc[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) acc[c] = 0.f;

  const T* kb = k + b * ks_.b + h * ks_.h;
  const T* vb = v + b * vs_.b + h * vs_.h;
  for (int e = 0; e < deg; ++e) {
    const int kblk = kidx[e];
    if (causal && kblk > qblk) continue;  // wholly above the diagonal
    const int k_begin = kblk * lay.block;
    const int k_end = causal ? min(k_begin + lay.block, q0 + kBM)
                             : k_begin + lay.block;
    for (int n0 = k_begin; n0 < k_end; n0 += kBN) {
      __syncthreads();  // Q, dO loaded / the previous K, V consumed
      load_tile<T, D, DP>(ks, kb, ks_, n0, dhead);
      load_tile<T, D, DP>(vs, vb, vs_, n0, dhead);
      __syncthreads();

      float s[kNS], ds[kNS];
      tile_grads<D, DP>(qs, dos, ks, vs, r, j, qrow, n0, lse_r, delta_r,
                        sm_scale, causal, s, ds);

      // dq[row] += sum_col dS[col] K[col]: the row's 64 dS values are
      // spread over its 4 threads; fetch the others' by shuffle
      const int base = lane & ~(kTPR - 1);
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
#pragma unroll
        for (int jj = 0; jj < kTPR; ++jj) {
          const float dsv = __shfl_sync(0xffffffffu, ds[i], base | jj);
          const float* krow = ks + (kTPR * i + jj) * DP;
#pragma unroll
          for (int c = 0; c < DC; ++c) acc[c] = fmaf(dsv, krow[j + kTPR * c], acc[c]);
        }
      }
    }
  }

  T* dqrow = dq + b * dqs_.b + h * dqs_.h + qrow * dqs_.s;
#pragma unroll
  for (int c = 0; c < DC; ++c)
    if (j + kTPR * c < dhead) dqrow[j + kTPR * c] = ds_from_float<T>(acc[c]);
}

template <typename T, int D>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dk, void* dv,
                Layout lay_t, int B, int H, int S, Strides qs, Strides ks,
                Strides vs, Strides dos, Strides dks, Strides dvs,
                float sm_scale, int dhead, int causal, cudaStream_t stream) {
  const size_t smem = dkdv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      bsf_bwd_dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, S / Tiles<D>::kBN);
  bsf_bwd_dkdv_kernel<T, D><<<grid, Tiles<D>::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), lay_t, H, S, qs, ks, vs, dos,
      dks, dvs, sm_scale, dhead, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, Layout lay,
              int B, int H, int S, Strides qs, Strides ks, Strides vs,
              Strides dos, Strides dqs, float sm_scale, int dhead, int causal,
              cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      bsf_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, S / Tiles<D>::kBM);
  bsf_bwd_dq_kernel<T, D><<<grid, Tiles<D>::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), lay, H, S, qs, ks, vs, dos, dqs, sm_scale, dhead,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fp32

// ===================================================================== //
// bf16: tensor cores
// ===================================================================== //
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kBM = ds_bsf::kSub;  // query rows per tile
constexpr int kBN = ds_bsf::kSub;  // keys per tile
// four warps of 16 rows (dq) or 16 keys (dkdv) per column group
// (ds_mma::ColumnSplit: one group up to D = 128, two at D = 256)
template <int D>
constexpr int kThreads = ds_mma::ColumnSplit<D>::kThreads;

template <int D>
struct DqLayout {
  static constexpr int kQ = 0;                                        // [kBM][D]
  static constexpr int kDO = kQ + ds_mma::tile_bytes<D>(kBM);         // [kBM][D]
  static constexpr int kK = kDO + ds_mma::tile_bytes<D>(kBM);         // [2][kBN][D]
  static constexpr int kV = kK + 2 * ds_mma::tile_bytes<D>(kBN);      // [2][kBN][D]
  static constexpr int kLive = kV + 2 * ds_mma::tile_bytes<D>(kBN);   // [max_deg] int
  static int bytes(int max_deg) { return kLive + 4 * max_deg; }
};

// At D = 64 the registers of both launches are capped, dq's for four
// blocks an SM (128 registers), dk/dv's for three (168), each with ~100
// bytes spilled: on the H100 at the long-context shape 17% and 11% faster
// than the 194 and 230 the compiler picks (two blocks).
template <int D>
__global__ void __launch_bounds__(kThreads<D>, D == 64 ? 4 : 1)
bsf_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dq, Layout lay, int B, int H, int S, Strides qs_,
                      Strides ks_, Strides vs_, Strides dos_, Strides dqs_,
                      float sm_scale, int dhead,
                      int causal) {
  using L = DqLayout<D>;
  using Split = ds_mma::ColumnSplit<D>;
  constexpr int NT = kThreads<D>, DO = Split::DO;
  constexpr int kKV = ds_mma::tile_bytes<D>(kBN);
  extern __shared__ __align__(128) unsigned char tc_smem[];
  __shared__ int n_live;
  const uint32_t s_q = ds_mma::smem_u32(tc_smem + L::kQ);
  const uint32_t s_do = ds_mma::smem_u32(tc_smem + L::kDO);
  const uint32_t s_k = ds_mma::smem_u32(tc_smem + L::kK);
  const uint32_t s_v = ds_mma::smem_u32(tc_smem + L::kV);
  int* live = reinterpret_cast<int*>(tc_smem + L::kLive);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_bh = B * H;
  const int bh = blockIdx.x % n_bh;
  // heaviest q-tiles first: under causal masking the last rows see most blocks
  const int q0 = (S / kBM - 1 - static_cast<int>(blockIdx.x) / n_bh) * kBM;
  const int b = bh / H, h = bh % H;
  const int qi = q0 / lay.block;  // the layout q-block of this tile
  const bf16* kb = k + b * ks_.b + h * ks_.h;
  const bf16* vb = v + b * vs_.b + h * vs_.h;

  ds_mma::load_tile_async<kBM, D, NT>(s_q, q + b * qs_.b + h * qs_.h, qs_.s, q0, S, tid, dhead);
  ds_mma::load_tile_async<kBM, D, NT>(s_do, dout + b * dos_.b + h * dos_.h, dos_.s, q0, S, tid,
                                      dhead);
  if (warp == 0) {  // the row's live blocks, read once
    const size_t row = (static_cast<size_t>(h) * (S / lay.block) + qi) * lay.max_deg;
    const int n = ds_bsf::compact_live_blocks(live, lay.idx + row, lay.valid + row,
                                              lay.max_deg, 0, causal ? qi : INT_MAX, lane);
    if (lane == 0) n_live = n;
  }
  __syncthreads();
  ds_bsf::SubTileWalk walk(live, n_live, lay.block, 0, causal ? q0 + kBM : INT_MAX);
  int n0 = walk.pos;
  bool more = walk.valid();
  if (more) {
    ds_mma::load_tile_async<kBN, D, NT>(s_k, kb, ks_.s, n0, S, tid, dhead);
    ds_mma::load_tile_async<kBN, D, NT>(s_v, vb, vs_.s, n0, S, tid, dhead);
  }
  ds_mma::cp_async_commit();

  const int w0 = (Split::kParts == 1 ? warp : warp & 3) * 16;  // the warp's first row
  const int col0 = Split::kParts == 1 ? 0 : (warp >> 2) * DO;   // ... and output column
  const int row0 = q0 + w0;    // the warp's first row in the sequence
  const int rows[2] = {row0 + (lane >> 2), row0 + (lane >> 2) + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float x = lse[static_cast<size_t>(bh) * S + rows[r]];
    // a row with no live block (lse at the mask value) gets P = 0
    lse_r[r] = x > 0.5f * DS_MASK_VALUE ? x : CUDART_INF_F;
    delta_r[r] = delta[static_cast<size_t>(bh) * S + rows[r]];
  }
  float acc[DO / 8][4];
#pragma unroll
  for (int j = 0; j < DO / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; more; ++t) {
    ds_mma::cp_async_wait<0>();  // sub-tile t has landed
    __syncthreads();             // ... for every thread; sub-tile t - 1 is consumed
    const int st = t & 1;
    const int c0 = n0;  // this sub-tile's first key
    walk.next();
    more = walk.valid();
    n0 = walk.pos;
    if (more) {  // sub-tile t + 1, of this block or the next, flies meanwhile
      ds_mma::load_tile_async<kBN, D, NT>(s_k + (st ^ 1) * kKV, kb, ks_.s, n0, S, tid, dhead);
      ds_mma::load_tile_async<kBN, D, NT>(s_v + (st ^ 1) * kKV, vb, vs_.s, n0, S, tid, dhead);
      ds_mma::cp_async_commit();
    }
    // causal: a warp whose rows all lie above this sub-tile has nothing in it
    if (causal && c0 > row0 + 15) continue;
    const bool edge = causal && c0 + kBN - 1 > row0;
    ds_mma::bwd_dq_tile_step<D, DO, false>(acc, s_q, s_do, w0, s_k + st * kKV, s_v + st * kKV,
                                           c0, rows, lse_r, delta_r, S, causal, edge, sm_scale,
                                           false, nullptr, 1.f, lane, col0);
  }

  // dq through the warp's own rows of the Q tile, for 16-byte stores
  ds_mma::cp_async_wait<0>();
  __syncthreads();
  ds_mma::acc_to_tile<D, DO>(tc_smem + L::kQ, w0, acc, 1.f, 1.f, lane, col0);
  __syncwarp();
  ds_mma::tile_rows_to_global<D, DO>(dq + b * dqs_.b + h * dqs_.h, dqs_.s, row0, S,
                                     tc_smem + L::kQ, w0, lane, dhead, col0);
}

template <int D>
struct DkdvLayout {
  static constexpr int kK = 0;                                        // [kBN][D]
  static constexpr int kV = kK + ds_mma::tile_bytes<D>(kBN);          // [kBN][D]
  static constexpr int kQ = kV + ds_mma::tile_bytes<D>(kBN);          // [2][kBM][D]
  static constexpr int kDO = kQ + 2 * ds_mma::tile_bytes<D>(kBM);     // [2][kBM][D]
  static constexpr int kLse = kDO + 2 * ds_mma::tile_bytes<D>(kBM);   // [2][kBM] fp32
  static constexpr int kDelta = kLse + 2 * kBM * 4;                   // [2][kBM] fp32
  static constexpr int kLive = kDelta + 2 * kBM * 4;                  // [max_deg_t] int
  static int bytes(int max_deg) { return kLive + 4 * max_deg; }
};

template <int D>
__global__ void __launch_bounds__(kThreads<D>, D == 64 ? 3 : 1)
bsf_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, Layout lay_t, int B,
                        int H, int S, Strides qs_, Strides ks_, Strides vs_, Strides dos_,
                        Strides dks_, Strides dvs_, float sm_scale, int dhead, int causal) {
  using L = DkdvLayout<D>;
  using Split = ds_mma::ColumnSplit<D>;
  constexpr int NT = kThreads<D>, DO = Split::DO;
  constexpr int kTile = ds_mma::tile_bytes<D>(kBM);
  extern __shared__ __align__(128) unsigned char tc_smem[];
  __shared__ int n_live;
  const uint32_t s_k = ds_mma::smem_u32(tc_smem + L::kK);
  const uint32_t s_v = ds_mma::smem_u32(tc_smem + L::kV);
  const uint32_t s_q = ds_mma::smem_u32(tc_smem + L::kQ);
  const uint32_t s_do = ds_mma::smem_u32(tc_smem + L::kDO);
  const uint32_t s_lse = ds_mma::smem_u32(tc_smem + L::kLse);
  const uint32_t s_delta = ds_mma::smem_u32(tc_smem + L::kDelta);
  const float* lse_s = reinterpret_cast<const float*>(tc_smem + L::kLse);
  const float* delta_s = reinterpret_cast<const float*>(tc_smem + L::kDelta);
  int* live = reinterpret_cast<int*>(tc_smem + L::kLive);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_bh = B * H;
  const int bh = blockIdx.x % n_bh;
  // k-tiles in order: the first blocks' columns (the global block's, and
  // under causal masking the earliest) are seen by the most q-blocks
  const int n0 = static_cast<int>(blockIdx.x) / n_bh * kBN;
  const int b = bh / H, h = bh % H;
  const int kj = n0 / lay_t.block;  // the layout k-block of this tile
  const float* lse_b = lse + static_cast<size_t>(bh) * S;
  const float* delta_b = delta + static_cast<size_t>(bh) * S;
  const bf16* qb = q + b * qs_.b + h * qs_.h;
  const bf16* dob = dout + b * dos_.b + h * dos_.h;
  auto load_q_tile = [&](int stage, int m0) {
    ds_mma::load_tile_async<kBM, D, NT>(s_q + stage * kTile, qb, qs_.s, m0, S, tid, dhead);
    ds_mma::load_tile_async<kBM, D, NT>(s_do + stage * kTile, dob, dos_.s, m0, S, tid, dhead);
    ds_mma::load_stat_async<kBM, NT>(s_lse + stage * kBM * 4, lse_b, m0, S, tid);
    ds_mma::load_stat_async<kBM, NT>(s_delta + stage * kBM * 4, delta_b, m0, S, tid);
  };

  ds_mma::load_tile_async<kBN, D, NT>(s_k, k + b * ks_.b + h * ks_.h, ks_.s, n0, S, tid, dhead);
  ds_mma::load_tile_async<kBN, D, NT>(s_v, v + b * vs_.b + h * vs_.h, vs_.s, n0, S, tid, dhead);
  if (warp == 0) {  // the column's live q-blocks, read once
    const size_t row = (static_cast<size_t>(h) * (S / lay_t.block) + kj) * lay_t.max_deg;
    const int n = ds_bsf::compact_live_blocks(live, lay_t.idx + row, lay_t.valid + row,
                                              lay_t.max_deg, causal ? kj : 0, INT_MAX, lane);
    if (lane == 0) n_live = n;
  }
  __syncthreads();
  // causal: q sub-tiles whose last row lies before this k-tile see none of it
  ds_bsf::SubTileWalk walk(live, n_live, lay_t.block, causal ? n0 : 0, INT_MAX);
  int m0 = walk.pos;
  bool more = walk.valid();
  if (more) load_q_tile(0, m0);
  ds_mma::cp_async_commit();

  const int w0 = (Split::kParts == 1 ? warp : warp & 3) * 16;  // the warp's first key
  const int col0 = Split::kParts == 1 ? 0 : (warp >> 2) * DO;   // ... and output column
  const int key0 = n0 + w0;    // the warp's first key in the sequence
  float dk_acc[DO / 8][4], dv_acc[DO / 8][4];
#pragma unroll
  for (int j = 0; j < DO / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[j][e] = 0.f;
      dv_acc[j][e] = 0.f;
    }

  for (int t = 0; more; ++t) {
    ds_mma::cp_async_wait<0>();  // sub-tile t has landed
    __syncthreads();             // ... for every thread; sub-tile t - 1 is consumed
    const int st = t & 1;
    const int r0 = m0;  // this sub-tile's first query
    walk.next();
    more = walk.valid();
    m0 = walk.pos;
    if (more) {  // sub-tile t + 1, of this block or the next, flies meanwhile
      load_q_tile(st ^ 1, m0);
      ds_mma::cp_async_commit();
    }
    // causal: every query of the sub-tile lies before the warp's keys
    if (causal && r0 + kBM - 1 < key0) continue;
    const bool edge = causal && r0 < key0 + 15;
    ds_mma::bwd_dkdv_tile_step<D, DO, false>(dk_acc, dv_acc, s_k, s_v, w0, s_q + st * kTile,
                                             s_do + st * kTile, lse_s + st * kBM,
                                             delta_s + st * kBM, r0, n0, S, S, causal, edge,
                                             sm_scale, false, nullptr, 1.f, lane, col0);
  }

  // dk and dv through the warp's own rows of the K and V tiles, for
  // 16-byte stores
  ds_mma::cp_async_wait<0>();
  __syncthreads();
  ds_mma::acc_to_tile<D, DO>(tc_smem + L::kK, w0, dk_acc, 1.f, 1.f, lane, col0);
  ds_mma::acc_to_tile<D, DO>(tc_smem + L::kV, w0, dv_acc, 1.f, 1.f, lane, col0);
  __syncwarp();
  ds_mma::tile_rows_to_global<D, DO>(dk + b * dks_.b + h * dks_.h, dks_.s, key0, S,
                                     tc_smem + L::kK, w0, lane, dhead, col0);
  ds_mma::tile_rows_to_global<D, DO>(dv + b * dvs_.b + h * dvs_.h, dvs_.s, key0, S,
                                     tc_smem + L::kV, w0, lane, dhead, col0);
}

template <int D>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dk, void* dv,
                Layout lay_t, int B, int H, int S, Strides qs, Strides ks,
                Strides vs, Strides dos, Strides dks, Strides dvs,
                float sm_scale, int dhead, int causal, cudaStream_t stream) {
  const int smem = DkdvLayout<D>::bytes(lay_t.max_deg);
  cudaError_t err = cudaFuncSetAttribute(bsf_bwd_dkdv_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(S / kBN) * B * H;
  bsf_bwd_dkdv_mma_kernel<D><<<static_cast<unsigned>(blocks), kThreads<D>, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), lay_t, B, H, S, qs, ks, vs, dos, dks, dvs, sm_scale, dhead, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, Layout lay,
              int B, int H, int S, Strides qs, Strides ks, Strides vs,
              Strides dos, Strides dqs, float sm_scale, int dhead, int causal,
              cudaStream_t stream) {
  const int smem = DqLayout<D>::bytes(lay.max_deg);
  cudaError_t err = cudaFuncSetAttribute(bsf_bwd_dq_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(S / kBM) * B * H;
  bsf_bwd_dq_mma_kernel<D><<<static_cast<unsigned>(blocks), kThreads<D>, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), lay, B, H, S, qs, ks,
      vs, dos, dqs, sm_scale, dhead, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// S must be a multiple of block, and block of 64 (the wrapper checks both).
// Strides come as (batch, head, seq) triples in the order of the tensor
// arguments; idx_t / valid_t are the transposed gather indices.
extern "C" int ds_block_sparse_flash_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const void* idx_t, const void* valid_t, int B, int H, int S, int D,
    int chunks, int block, int max_deg_t, const long long* strides, float sm_scale,
    int causal, int dtype, void* stream) {
  if (block % ds_bsf::kSub != 0 || S % block != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{strides[0], strides[1], strides[2]},
      ks{strides[3], strides[4], strides[5]},
      vs{strides[6], strides[7], strides[8]},
      dos{strides[9], strides[10], strides[11]},
      dks{strides[12], strides[13], strides[14]},
      dvs{strides[15], strides[16], strides[17]};
  const Layout lay_t{static_cast<const int*>(idx_t),
                     static_cast<const int*>(valid_t), block, max_deg_t};
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DS_DKDV(NS, ...)                                                                        \
  return NS::launch_dkdv<__VA_ARGS__>(q, k, v, dout, l, dl, dk, dv, lay_t, B, H, S, qs, ks, vs, \
                                      dos, dks, dvs, sm_scale, D, causal, s)
  // any D up to 256 (bf16: a multiple of 8) runs the smallest instantiation
  // at or above it, its columns past D zero-filled on load and masked on
  // store; a larger D runs the wide kernel, `chunks` column chunks
  if (!ds_head_dim_plan_ok(D, chunks, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  if (D > DS_MAX_TILED_HEAD_DIM) {
    const ds_wide::SparseWalk walk{lay_t, lay_t, S, S, causal};
    const ds_wide::Dropout none{nullptr, 256, 1.f};
#define DS_WIDE_DKDV(F)                                                                     \
  return F(q, k, v, dout, l, dl, dk, dv, B, H, D, qs, ks, vs, dos, dks, dvs,                      \
                                 sm_scale, walk, none, s)
    if (dtype == DS_DTYPE_BF16) DS_WIDE_DKDV(ds_wide::tc::launch_dkdv);
    DS_WIDE_DKDV(ds_wide::launch_dkdv<float>);
#undef DS_WIDE_DKDV
  }
  if (dtype == DS_DTYPE_BF16) {
    if (D <= 32) DS_DKDV(tc, 32);
    if (D <= 64) DS_DKDV(tc, 64);
    if (D <= 96) DS_DKDV(tc, 96);
    if (D <= 128) DS_DKDV(tc, 128);
    DS_DKDV(tc, 256);
  }
  if (D <= 32) DS_DKDV(fp32, float, 32);
  if (D <= 64) DS_DKDV(fp32, float, 64);
  if (D <= 96) DS_DKDV(fp32, float, 96);
  if (D <= 128) DS_DKDV(fp32, float, 128);
  DS_DKDV(fp32, float, 256);
#undef DS_DKDV
}

extern "C" int ds_block_sparse_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const void* idx,
    const void* valid, int B, int H, int S, int D, int chunks, int block, int max_deg,
    const long long* strides, float sm_scale, int causal, int dtype,
    void* stream) {
  if (block % ds_bsf::kSub != 0 || S % block != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{strides[0], strides[1], strides[2]},
      ks{strides[3], strides[4], strides[5]},
      vs{strides[6], strides[7], strides[8]},
      dos{strides[9], strides[10], strides[11]},
      dqs{strides[12], strides[13], strides[14]};
  const Layout lay{static_cast<const int*>(idx),
                   static_cast<const int*>(valid), block, max_deg};
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DS_DQ(NS, ...)                                                                       \
  return NS::launch_dq<__VA_ARGS__>(q, k, v, dout, l, dl, dq, lay, B, H, S, qs, ks, vs, dos, \
                                    dqs, sm_scale, D, causal, s)
  // any D up to 256 (bf16: a multiple of 8) runs the smallest instantiation
  // at or above it, its columns past D zero-filled on load and masked on
  // store; a larger D runs the wide kernel, `chunks` column chunks
  if (!ds_head_dim_plan_ok(D, chunks, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  if (D > DS_MAX_TILED_HEAD_DIM) {
    const ds_wide::SparseWalk walk{lay, lay, S, S, causal};
    const ds_wide::Dropout none{nullptr, 256, 1.f};
#define DS_WIDE_DQ(F)                                                                       \
  return F(q, k, v, dout, l, dl, dq, B, H, D, qs, ks, vs, dos, dqs, sm_scale,                     \
                               walk, none, s)
    if (dtype == DS_DTYPE_BF16) DS_WIDE_DQ(ds_wide::tc::launch_dq);
    DS_WIDE_DQ(ds_wide::launch_dq<float>);
#undef DS_WIDE_DQ
  }
  if (dtype == DS_DTYPE_BF16) {
    if (D <= 32) DS_DQ(tc, 32);
    if (D <= 64) DS_DQ(tc, 64);
    if (D <= 96) DS_DQ(tc, 96);
    if (D <= 128) DS_DQ(tc, 128);
    DS_DQ(tc, 256);
  }
  if (D <= 32) DS_DQ(fp32, float, 32);
  if (D <= 64) DS_DQ(fp32, float, 64);
  if (D <= 96) DS_DQ(fp32, float, 96);
  if (D <= 128) DS_DQ(fp32, float, 128);
  DS_DQ(fp32, float, 256);
#undef DS_DQ
}
