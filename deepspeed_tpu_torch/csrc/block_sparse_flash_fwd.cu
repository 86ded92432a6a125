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
// lse = DEFAULT_MASK_VALUE + log(1e-37), as the TPU kernel does.
//
// Bound on the H100: at the long-context training shape ([2, 12, 8192, 64]
// bf16, causal BigBird with block 512) the live blocks are 49 full and 16
// diagonal ones per head, ~92 GFLOP against ~102 MB of q, k, v, out and
// lse: the bf16 tensor cores bound it at ~93 us, the memory at ~30 us.  This
// first version multiplies in fp32 on the CUDA cores (67 TFLOP/s peak), as
// kernel B does, which is simple to get right; `mma.sync` / `wgmma` tiles
// are later work.  What it keeps is the memory side of flash attention:
// the scores never reach device memory, and only the live k-blocks are
// loaded.
//
// Design.  A 512-row layout block does not fit one thread block, so each
// layout q-block is cut into q-tiles of 64 rows (one thread block each,
// kernel B's tile and thread layout: 256 threads, 4 per query row, 16
// scores each) and each gathered k-block into k-sub-tiles of 64 keys.  The
// TPU grid walks max_deg steps for every q-block and masks the padding;
// here a block loops over its row's valid entries only (the valid ones
// come first in `valid`), so a row of degree 5 pays for 5 blocks, not the
// layout's maximum.  Inside the diagonal layout block, the k-sub-tiles
// above the q-tile's own diagonal are skipped, which halves the diagonal
// blocks' work.  The grid is (batch * head, q-tile) with the q-tiles in
// reverse order, so the blocks start tile by tile across all heads and the
// layout's heavy last rows (a causal global row sees every block) start
// first and do not form the launch's tail.  Strides are arguments, as in kernel B: q, k, v
// may be the head views of one fused QKV projection, and out is written in
// [B, S, H, D] order.

#include "common.cuh"

namespace {

constexpr int kBM = 64;                // query rows per q-tile
constexpr int kBN = 64;                // keys per k-sub-tile
constexpr int kThreads = 256;
constexpr int kTPR = kThreads / kBM;   // threads per query row: 4
constexpr int kNS = kBN / kTPR;        // scores per thread per sub-tile: 16

struct Strides {
  long long b, h, s;
};

// The gather indices of layout_gather: idx / valid [H, nb, max_deg] int32,
// each row's valid entries first.
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
               float sm_scale, int causal) {
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
  const int deg = row_degree(lay.valid + row_off, lay.max_deg);

  for (int idx = tid; idx < kBM * D; idx += kThreads) {
    const int row = idx / D, col = idx % D;
    qs[row * DP + col] = ds_to_float(qb[(q0 + row) * qs_.s + col]);
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
        ks[row * DP + col] = ds_to_float(kb[(n0 + row) * ks_.s + col]);
        vs[row * D + col] = ds_to_float(vb[(n0 + row) * vs_.s + col]);
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
  for (int c = 0; c < DC; ++c) orow[j + kTPR * c] = ds_from_float<T>(acc[c] / denom);
  if (j == 0) {
    lse[(static_cast<size_t>(b) * H + h) * S + qrow] = m + logf(l + 1e-37f);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           Layout lay, int B, int H, int S, Strides qs, Strides ks,
           Strides vs, Strides os, float sm_scale, int causal,
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
      vs, os, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// S must be a multiple of block, and block of 64 (the wrapper checks both).
// Strides come as (batch, head, seq) triples of q, k, v, out.
extern "C" int ds_block_sparse_flash_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* idx, const void* valid, int B, int H, int S, int D,
    int block, int max_deg, const long long* strides, float sm_scale,
    int causal, int dtype, void* stream) {
  if (block % kBM != 0 || S % block != 0) {
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
#define DS_BSF(T, DIM) \
  return launch<T, DIM>(q, k, v, o, l, lay, B, H, S, qs, ks, vs, os, sm_scale, causal, s)
  if (dtype == DS_DTYPE_BF16 && D == 64) DS_BSF(__nv_bfloat16, 64);
  if (dtype == DS_DTYPE_BF16 && D == 128) DS_BSF(__nv_bfloat16, 128);
  if (dtype == DS_DTYPE_FP32 && D == 64) DS_BSF(float, 64);
  if (dtype == DS_DTYPE_FP32 && D == 128) DS_BSF(float, 128);
#undef DS_BSF
  return static_cast<int>(cudaErrorInvalidValue);
}
