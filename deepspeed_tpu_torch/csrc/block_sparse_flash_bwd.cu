// Kernel G: block-sparse flash-attention backward (FlashAttention-2 over a
// SparsityConfig layout), two launches:
//   dq:   one block per (q-tile of 64 rows, head, batch) walks the forward
//         gather indices (the k-blocks its layout row allows) and writes dq;
//   dkdv: one block per (k-tile of 64 keys, head, batch) walks the
//         transposed indices (the q-blocks whose rows allow its k-block)
//         and writes dk, dv.
// Neither needs atomics: each output tile has exactly one block that owns
// it, so the sums are taken in a fixed order and a step is repeatable.
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
// would overflow: its q-block has no live entry in either walk, and a row
// whose lse is the mask value is treated as empty besides.  Products
// accumulate in fp32 and are stored in the input dtype.
//
// Bound on the H100: at the long-context training shape ([2, 12, 8192, 64]
// bf16, causal BigBird with block 512, 49 full and 16 diagonal live blocks
// per head) dq does three [512, 512] x 64 products per live block
// (~138 GFLOP) and dk/dv four (~184 GFLOP), against ~100-150 MB of
// operands: operations bound both (~140 and ~186 us at the bf16
// tensor-core peak).  This first version multiplies in fp32 on the CUDA
// cores, as kernel E does; `mma.sync` / `wgmma` tiles are later work.
// What it keeps from FlashAttention-2 is the memory side: scores and
// probabilities never reach device memory, only live blocks are loaded.
//
// Design: kernel E's tiles and thread layout (256 threads; for the scores
// of a 64 x 64 tile, 4 threads share a query row and each holds 16
// columns), walking the layout as kernel F does: a block loops over the
// valid entries of its row (valid ones first in `valid`), cuts each 512-row
// layout block into 64-row / 64-key sub-tiles, and inside the diagonal
// layout block skips the sub-tiles above its own diagonal.  dkdv stages P
// and dS in shared memory and then gives each thread a key row (4 threads
// per row, D / 4 columns each) to sum over the q rows; dq sums over the
// keys inside the 4-thread row group with shuffles.  Strides are
// arguments, so q, k, v, dO and the grads may be the head views of a fused
// [B, S, 3 * H * D] projection.

#include "common.cuh"

namespace {

constexpr int kBM = 64;                // query rows per tile
constexpr int kBN = 64;                // keys per tile
constexpr int kThreads = 256;
constexpr int kTPR = kThreads / kBM;   // threads per row: 4
constexpr int kNS = kBN / kTPR;        // scores per thread per tile: 16
constexpr int kPP = kBN + 1;           // padded row of the P / dS tiles

struct Strides {
  long long b, h, s;
};

// The gather indices of layout_gather (forward or transposed):
// idx / valid [H, nb, max_deg] int32, each row's valid entries first.
struct Layout {
  const int* idx;
  const int* valid;
  int block;
  int max_deg;
};

__device__ __forceinline__ int row_degree(const int* valid, int max_deg) {
  int deg = 0;
  while (deg < max_deg && valid[deg] != 0) ++deg;
  return deg;
}

// Load rows [r0, r0 + kBM) of one head's [S, D] operand as fp32 into a
// [kBM][DP] tile.
template <typename T, int D, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* src, Strides st,
                                          int r0) {
  for (int idx = threadIdx.x; idx < kBM * D; idx += kThreads) {
    const int row = idx / D, col = idx % D;
    dst[row * DP + col] = ds_to_float(src[(r0 + row) * st.s + col]);
  }
}

// The 16 scores and dP of this thread's row r against keys n0 + j + 4 i,
// turned into P (in s) and dS (in dp).
template <int D, int DP>
__device__ __forceinline__ void tile_grads(
    const float* qs, const float* dos, const float* ks, const float* vs,
    int r, int j, int qrow, int n0, float lse_r, float delta_r,
    float sm_scale, int causal, float* s, float* dp) {
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
  return static_cast<size_t>(4 * kBM * (D + 1) + 2 * kBM * kPP + 2 * kBM) *
         sizeof(float);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return static_cast<size_t>(4 * kBM * (D + 1)) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bsf_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, Layout lay_t, int H, int S,
                    Strides qs_, Strides ks_, Strides vs_, Strides dos_,
                    Strides dks_, Strides dvs_, float sm_scale, int causal) {
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
  const int deg = row_degree(lay_t.valid + row_off, lay_t.max_deg);

  load_tile<T, D, DP>(ks, k + b * ks_.b + h * ks_.h, ks_, n0);
  load_tile<T, D, DP>(vs, v + b * vs_.b + h * vs_.h, vs_, n0);

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
      load_tile<T, D, DP>(qs, qb, qs_, m0);
      load_tile<T, D, DP>(dos, dob, dos_, m0);
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
    dkrow[j + kTPR * c] = ds_from_float<T>(dk_acc[c]);
    dvrow[j + kTPR * c] = ds_from_float<T>(dv_acc[c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bsf_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq,
                  Layout lay, int H, int S, Strides qs_, Strides ks_,
                  Strides vs_, Strides dos_, Strides dqs_, float sm_scale,
                  int causal) {
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
  const int deg = row_degree(lay.valid + row_off, lay.max_deg);

  load_tile<T, D, DP>(qs, q + b * qs_.b + h * qs_.h, qs_, q0);
  load_tile<T, D, DP>(dos, dout + b * dos_.b + h * dos_.h, dos_, q0);

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
      load_tile<T, D, DP>(ks, kb, ks_, n0);
      load_tile<T, D, DP>(vs, vb, vs_, n0);
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
  for (int c = 0; c < DC; ++c) dqrow[j + kTPR * c] = ds_from_float<T>(acc[c]);
}

template <typename T, int D>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dk, void* dv,
                Layout lay_t, int B, int H, int S, Strides qs, Strides ks,
                Strides vs, Strides dos, Strides dks, Strides dvs,
                float sm_scale, int causal, cudaStream_t stream) {
  const size_t smem = dkdv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      bsf_bwd_dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, S / kBN);
  bsf_bwd_dkdv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), lay_t, H, S, qs, ks, vs, dos,
      dks, dvs, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, Layout lay,
              int B, int H, int S, Strides qs, Strides ks, Strides vs,
              Strides dos, Strides dqs, float sm_scale, int causal,
              cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      bsf_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, S / kBM);
  bsf_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), lay, H, S, qs, ks, vs, dos, dqs, sm_scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// S must be a multiple of block, and block of 64 (the wrapper checks both).
// Strides come as (batch, head, seq) triples in the order of the tensor
// arguments; idx_t / valid_t are the transposed gather indices.
extern "C" int ds_block_sparse_flash_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const void* idx_t, const void* valid_t, int B, int H, int S, int D,
    int block, int max_deg_t, const long long* strides, float sm_scale,
    int causal, int dtype, void* stream) {
  if (block % kBN != 0 || S % block != 0) {
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
#define DS_DKDV(T, DIM)                                                   \
  return launch_dkdv<T, DIM>(q, k, v, dout, l, dl, dk, dv, lay_t, B, H, S, \
                             qs, ks, vs, dos, dks, dvs, sm_scale, causal, s)
  if (dtype == DS_DTYPE_BF16 && D == 64) DS_DKDV(__nv_bfloat16, 64);
  if (dtype == DS_DTYPE_BF16 && D == 128) DS_DKDV(__nv_bfloat16, 128);
  if (dtype == DS_DTYPE_FP32 && D == 64) DS_DKDV(float, 64);
  if (dtype == DS_DTYPE_FP32 && D == 128) DS_DKDV(float, 128);
#undef DS_DKDV
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int ds_block_sparse_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const void* idx,
    const void* valid, int B, int H, int S, int D, int block, int max_deg,
    const long long* strides, float sm_scale, int causal, int dtype,
    void* stream) {
  if (block % kBM != 0 || S % block != 0) {
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
#define DS_DQ(T, DIM)                                                     \
  return launch_dq<T, DIM>(q, k, v, dout, l, dl, dq, lay, B, H, S, qs, ks, \
                           vs, dos, dqs, sm_scale, causal, s)
  if (dtype == DS_DTYPE_BF16 && D == 64) DS_DQ(__nv_bfloat16, 64);
  if (dtype == DS_DTYPE_BF16 && D == 128) DS_DQ(__nv_bfloat16, 128);
  if (dtype == DS_DTYPE_FP32 && D == 64) DS_DQ(float, 64);
  if (dtype == DS_DTYPE_FP32 && D == 128) DS_DQ(float, 128);
#undef DS_DQ
  return static_cast<int>(cudaErrorInvalidValue);
}
