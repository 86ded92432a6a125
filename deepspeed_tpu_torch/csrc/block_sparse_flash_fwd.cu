// Kernel F: block-sparse flash-attention forward over a SparsityConfig
// layout, q,k,v [B, H, S, D] -> out [B, H, S, D] and the per-row logsumexp
// [B, H, S] in fp32.
//
// Replaces: deepspeed_tpu/ops/sparse_attention/block_sparse_flash.py
// block_sparse_flash_fwd (_bsf_fwd_kernel).  Same function: the online
// softmax of each (head, q-block) runs over the k-blocks its layout row
// allows, gathered through idx; a k-block wholly above the causal diagonal
// contributes nothing (the TPU kernel's `live` test); masked scores take
// DEFAULT_MASK_VALUE; a row that sees no live block writes out = 0 and
// lse = DEFAULT_MASK_VALUE + log(1e-37), as the TPU kernel does.  S is a
// multiple of the layout block, and the block of 64 (the wrapper checks
// both).  Strides are arguments: q, k, v may be the head views of one
// fused QKV projection, and out is written in [B, S, H, D] order.
//
// Bound on the H100: at the long-context training shape ([2, 12, 8192, 64]
// bf16, causal BigBird with block 512) the live blocks are 49 full and 16
// diagonal ones per head, ~92 GFLOP against ~102 MB of q, k, v, out and
// lse: the bf16 tensor cores bound it at ~93 us, the memory at ~30 us.
//
// Head dims above 256 run the wide kernels of attention_wide.cuh over the
// same layout walk (bf16 on the tensor cores, fp32 on the CUDA cores): the
// output columns in chunks of 128 over the grid.  Up to 256, any D runs, on either
// route, the smallest
// instantiation (32, 64, 96, 128, 256) at or above it; the columns past
// the true D are zero-filled on load, so they add nothing to a product,
// and are never stored.  The tensor-core route takes D a multiple of 8
// (its 16-byte copies): the Python wrapper pads any other D with zero
// columns up to one, and passes the true D's 1 / sqrt(D).
//
// Two routes, chosen by the operands' dtype:
//
// bf16, tensor cores (tc::bsf_fwd_mma_kernel, D in {32, 64, 96, 128,
// 256}).
//   Kernel B's tensor-core design (attention_mma.cuh): 4 warps of 16 query
//   rows make a 64-row q-tile, 64-key sub-tiles arrive through two
//   `cp.async` stages of swizzled bf16 tiles, S = Q K^T and O += P V run on
//   `mma.sync` m16n8k16 with the online softmax in registers, P fed to the
//   second product from registers.  The per-tile work is B's own
//   (ds_mma::fwd_tile_step); what differs is the walk:
//   - one warp reads the layout row once, at the start, and keeps its live
//     k-blocks (valid, and on or below the diagonal under causal masking)
//     in shared memory (block_sparse_walk.cuh);
//   - the block then walks (live block, 64-key sub-tile of it) as one flat
//     sequence, so the copy of sub-tile t + 1 is in flight while t is
//     multiplied across block boundaries too, and the pipeline never
//     drains between blocks;
//   - inside the diagonal layout block the sub-tiles above the q-tile's
//     own diagonal are never loaded, and only the one on it is masked;
//   - the grid runs the q-tiles in reverse order across all heads, so the
//     heavy last rows of a causal layout start first and do not form the
//     launch's tail;
//   - D = 256 splits O's columns over two groups of four warps, Q read
//     from shared memory, as kernel B does (ds_mma::ColumnSplit).
//
// fp32, CUDA cores (fp32::bsf_fwd_kernel, the first design, kept as it
// was).  A tensor-core fp32 product would be TF32 and miss the fp32
// parity.  Each 64-row q-tile is one block of 256 threads, 4 per query row
// and 16 scores each (kernel B's fp32 layout), looping over its row's
// valid entries and each gathered block's 64-key sub-tiles; inside the
// diagonal layout block the sub-tiles above the q-tile's diagonal are
// skipped.

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

constexpr int kBM = 64;                // query rows per q-tile
constexpr int kBN = 64;                // keys per k-sub-tile
constexpr int kThreads = 256;
constexpr int kTPR = kThreads / kBM;   // threads per query row: 4
constexpr int kNS = kBN / kTPR;        // scores per thread per sub-tile: 16

template <int D>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(kBM * (D + 1) + kBN * (D + 1) + kBN * D) *
         sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bsf_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ lse, Layout lay, int H, int S,
               Strides qs_, Strides ks_, Strides vs_, Strides os_,
               float sm_scale, int dhead, int causal) {
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
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;
  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int qrow = q0 + r;
  const int nb = S / lay.block;
  const int qi = q0 / lay.block;  // layout q-block of this tile

  const T* qb = q + b * qs_.b + h * qs_.h;
  const T* kb = k + b * ks_.b + h * ks_.h;
  const T* vb = v + b * vs_.b + h * vs_.h;
  const size_t row_off = (static_cast<size_t>(h) * nb + qi) * lay.max_deg;
  const int* kidx = lay.idx + row_off;
  const int deg = ds_bsf::row_degree(lay.valid + row_off, lay.max_deg);

  for (int idx = tid; idx < kBM * D; idx += kThreads) {
    const int row = idx / D, col = idx % D;
    qs[row * DP + col] = col < dhead ? ds_to_float(qb[(q0 + row) * qs_.s + col]) : 0.f;
  }

  float acc[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) acc[c] = 0.f;
  float m = DS_MASK_VALUE;
  float l = 0.f;

  for (int e = 0; e < deg; ++e) {
    const int kblk = kidx[e];
    if (causal && kblk > qi) continue;  // wholly above the diagonal
    const int k_begin = kblk * lay.block;
    // causal: keys past the q-tile's last row are masked for all its rows
    const int k_end = causal ? min(k_begin + lay.block, q0 + kBM)
                             : k_begin + lay.block;
    for (int n0 = k_begin; n0 < k_end; n0 += kBN) {
      __syncthreads();  // Q is loaded / the previous K, V tiles are consumed
      for (int idx = tid; idx < kBN * D; idx += kThreads) {
        const int row = idx / D, col = idx % D;
        const bool ok = col < dhead;
        ks[row * DP + col] = ok ? ds_to_float(kb[(n0 + row) * ks_.s + col]) : 0.f;
        vs[row * D + col] = ok ? ds_to_float(vb[(n0 + row) * vs_.s + col]) : 0.f;
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
        if (causal && col > qrow) sv = DS_MASK_VALUE;
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
  }

  const float denom = l == 0.f ? 1.f : l;
  T* orow = o + b * os_.b + h * os_.h + qrow * os_.s;
#pragma unroll
  for (int c = 0; c < DC; ++c)
    if (j + kTPR * c < dhead) orow[j + kTPR * c] = ds_from_float<T>(acc[c] / denom);
  if (j == 0) {
    lse[(static_cast<size_t>(b) * H + h) * S + qrow] = m + logf(l + 1e-37f);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           Layout lay, int B, int H, int S, Strides qs, Strides ks,
           Strides vs, Strides os, float sm_scale, int dhead, int causal,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      bsf_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, S / kBM);
  bsf_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, lay, H, S, qs, ks,
      vs, os, sm_scale, dhead, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fp32

// ===================================================================== //
// bf16: tensor cores
// ===================================================================== //
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kBM = ds_bsf::kSub;  // query rows per q-tile
constexpr int kBN = ds_bsf::kSub;  // keys per sub-tile

template <int D>
struct FwdLayout {
  // four warps of 16 query rows per column group
  static constexpr int kThreads = ds_mma::ColumnSplit<D>::kThreads;
  static constexpr int kQ = 0;                                    // [kBM][D]
  static constexpr int kK = kQ + ds_mma::tile_bytes<D>(kBM);      // [2][kBN][D]
  static constexpr int kV = kK + 2 * ds_mma::tile_bytes<D>(kBN);  // [2][kBN][D]
  static constexpr int kLive = kV + 2 * ds_mma::tile_bytes<D>(kBN);  // [max_deg] int
  static int bytes(int max_deg) { return kLive + 4 * max_deg; }
};

// At D = 64 the registers are capped so that four blocks fit an SM (128
// registers, a few bytes spilled): 1.6% faster on the H100 at the
// long-context shape than three blocks at the 168 the compiler picks.
template <int D>
__global__ void __launch_bounds__(FwdLayout<D>::kThreads, D == 64 ? 4 : 1)
bsf_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                   Layout lay, int B, int H, int S, Strides qs_, Strides ks_, Strides vs_,
                   Strides os_, float sm_scale, int dhead, int causal) {
  using L = FwdLayout<D>;
  using Split = ds_mma::ColumnSplit<D>;
  constexpr int kThreads = L::kThreads, DO = Split::DO;
  constexpr int kKV = ds_mma::tile_bytes<D>(kBN);
  extern __shared__ __align__(128) unsigned char tc_smem[];
  __shared__ int n_live;
  const uint32_t s_q = ds_mma::smem_u32(tc_smem + L::kQ);
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

  const bf16* qb = q + b * qs_.b + h * qs_.h;
  const bf16* kb = k + b * ks_.b + h * ks_.h;
  const bf16* vb = v + b * vs_.b + h * vs_.h;
  ds_mma::load_tile_async<kBM, D, kThreads>(s_q, qb, qs_.s, q0, S, tid, dhead);

  if (warp == 0) {  // the row's live blocks, read once
    const size_t row = (static_cast<size_t>(h) * (S / lay.block) + qi) * lay.max_deg;
    const int n = ds_bsf::compact_live_blocks(live, lay.idx + row, lay.valid + row,
                                              lay.max_deg, 0, causal ? qi : INT_MAX, lane);
    if (lane == 0) n_live = n;
  }
  __syncthreads();
  // causal: keys past the q-tile's last row are masked for all its rows
  ds_bsf::SubTileWalk walk(live, n_live, lay.block, 0, causal ? q0 + kBM : INT_MAX);
  int n0 = walk.pos;
  bool more = walk.valid();
  if (more) {
    ds_mma::load_tile_async<kBN, D, kThreads>(s_k, kb, ks_.s, n0, S, tid, dhead);
    ds_mma::load_tile_async<kBN, D, kThreads>(s_v, vb, vs_.s, n0, S, tid, dhead);
  }
  ds_mma::cp_async_commit();

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

  for (int t = 0; more; ++t) {
    if (t > 0) {
      ds_mma::cp_async_wait<0>();  // sub-tile t has landed
      __syncthreads();             // ... for every thread; sub-tile t - 1 is consumed
    }
    const int st = t & 1;
    const int c0 = n0;  // this sub-tile's first key
    walk.next();
    more = walk.valid();
    n0 = walk.pos;
    if (more) {  // sub-tile t + 1, of this block or the next, flies meanwhile
      ds_mma::load_tile_async<kBN, D, kThreads>(s_k + (st ^ 1) * kKV, kb, ks_.s, n0, S, tid, dhead);
      ds_mma::load_tile_async<kBN, D, kThreads>(s_v + (st ^ 1) * kKV, vb, vs_.s, n0, S, tid, dhead);
      ds_mma::cp_async_commit();
    }
    // causal: a warp whose rows all lie above this sub-tile has nothing in it
    if (causal && c0 > row0 + 15) continue;
    const bool edge = causal && c0 + kBN - 1 > row0;
    if constexpr (Split::kParts == 1) {
      ds_mma::fwd_tile_step<D, false>(acc, m, l, qa, s_k + st * kKV, s_v + st * kKV, c0, rows, S,
                                      causal, edge, sm_scale, false, nullptr, lane);
    } else {
      ds_mma::fwd_tile_step_split<D, DO, false>(acc, m, l, s_q, w0, s_k + st * kKV,
                                                s_v + st * kKV, c0, rows, S, causal, edge,
                                                sm_scale, false, nullptr, lane, col0);
    }
  }
  // the other group may still read these rows of Q for its last scores
  if constexpr (Split::kParts > 1) __syncthreads();

  // the row sums over the quad; out = acc / l (0 where l is 0: a row with
  // no live block, whose lse is then the mask value's), staged in the
  // warp's own rows of the Q tile for 16-byte stores
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = ds_mma::quad_sum(l[r]);
    inv[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);
  }
  ds_mma::acc_to_tile<D, DO>(tc_smem + L::kQ, w0, acc, inv[0], inv[1], lane, col0);
  __syncwarp();
  ds_mma::tile_rows_to_global<D, DO>(o + b * os_.b + h * os_.h, os_.s, row0, S,
                                     tc_smem + L::kQ, w0, lane, dhead, col0);
  if (col0 == 0 && (lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse[static_cast<size_t>(bh) * S + rows[r]] = m[r] + logf(l[r] + 1e-37f);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           Layout lay, int B, int H, int S, Strides qs, Strides ks,
           Strides vs, Strides os, float sm_scale, int dhead, int causal,
           cudaStream_t stream) {
  const int smem = FwdLayout<D>::bytes(lay.max_deg);
  cudaError_t err = cudaFuncSetAttribute(
      bsf_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(S / kBM) * B * H;
  bsf_fwd_mma_kernel<D><<<static_cast<unsigned>(blocks), FwdLayout<D>::kThreads, smem,
                          stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, lay, B, H, S, qs, ks, vs, os, sm_scale, dhead, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// S must be a multiple of block, and block of 64 (the wrapper checks both).
// Strides come as (batch, head, seq) triples of q, k, v, out.
extern "C" int ds_block_sparse_flash_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* idx, const void* valid, int B, int H, int S, int D,
    int chunks, int block, int max_deg, const long long* strides, float sm_scale,
    int causal, int dtype, void* stream) {
  if (block % ds_bsf::kSub != 0 || S % block != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{strides[0], strides[1], strides[2]},
      ks{strides[3], strides[4], strides[5]},
      vs{strides[6], strides[7], strides[8]},
      os{strides[9], strides[10], strides[11]};
  const Layout lay{static_cast<const int*>(idx),
                   static_cast<const int*>(valid), block, max_deg};
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DS_BSF(NS, ...) \
  return NS::launch<__VA_ARGS__>(q, k, v, o, l, lay, B, H, S, qs, ks, vs, os, sm_scale, D, causal, \
                                 s)
  // any D up to 256 (bf16: a multiple of 8) runs the smallest instantiation
  // at or above it, its columns past D zero-filled on load and masked on
  // store; a larger D runs the wide kernel, `chunks` column chunks
  if (!ds_head_dim_plan_ok(D, chunks, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  if (D > DS_MAX_TILED_HEAD_DIM) {
    const ds_wide::SparseWalk walk{lay, lay, S, S, causal};
    const ds_wide::Dropout none{nullptr, 256, 1.f};
    if (dtype == DS_DTYPE_BF16)
      return ds_wide::tc::launch_fwd(q, k, v, o, l, B, H, D, qs, ks, vs, os, sm_scale, walk,
                                     none, s);
    return ds_wide::launch_fwd<float>(q, k, v, o, l, B, H, D, qs, ks, vs, os, sm_scale, walk,
                                      none, s);
  }
  if (dtype == DS_DTYPE_BF16) {
    if (D <= 32) DS_BSF(tc, 32);
    if (D <= 64) DS_BSF(tc, 64);
    if (D <= 96) DS_BSF(tc, 96);
    if (D <= 128) DS_BSF(tc, 128);
    DS_BSF(tc, 256);
  }
  if (D <= 32) DS_BSF(fp32, float, 32);
  if (D <= 64) DS_BSF(fp32, float, 64);
  if (D <= 96) DS_BSF(fp32, float, 96);
  if (D <= 128) DS_BSF(fp32, float, 128);
  DS_BSF(fp32, float, 256);
#undef DS_BSF
}
