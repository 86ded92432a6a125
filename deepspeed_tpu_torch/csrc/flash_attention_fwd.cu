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
//
// Bound on the H100: at the serving shapes (S = 128..1024, D = 64, bf16,
// causal) the work is ~30-130 operations per byte moved, below the ~295 at
// which the bf16 tensor cores would bound it, so the least time is set by
// the bytes.  This first version multiplies in fp32 on the CUDA cores
// (67 TFLOP/s peak, ~20 operations per byte), out of shared memory, which
// is simple to get right; there the operations bound it.  `mma.sync` /
// `wgmma` tiles are the next step.  What the design keeps from flash
// attention is the memory side: q, k and v are each read once per q-tile
// and the [S, S] scores never reach device memory.
//
// Design: one block per (q-tile of 64 rows, head, batch); the TPU's
// sequential k-grid axis becomes a loop over k-tiles of 64 keys inside the
// block.  256 threads, 4 per query row: each thread holds 16 of its row's
// 64 scores in registers and D/4 of its output columns, and the row's max
// and sum are 4-lane shuffle reductions.  For P @ V the thread fetches the
// other lanes' probabilities by shuffle, so P never goes to shared memory.
// The Q and K tiles are padded to D+1 floats per row so that the 8 rows
// and 4 keys a warp reads at once fall in distinct banks.  With causal
// masking the loop stops at the tile's last row: tiles above the diagonal
// are never loaded.  Rows and keys past S are masked in the kernel, so any
// S runs (no block-multiple padding).  Strides are arguments: q, k and v
// may be the [B, S, H, D] views that a fused QKV projection produces, and
// the output may be written into one.

#include "common.cuh"
#include "dropout.cuh"

namespace {

constexpr int kBM = 64;                // query rows per block
constexpr int kBN = 64;                // keys per k-tile
constexpr int kThreads = 256;
constexpr int kTPR = kThreads / kBM;   // threads per query row: 4
constexpr int kNS = kBN / kTPR;        // scores per thread per k-tile: 16

struct Strides {
  long long b, h, s;
};

template <int D>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(kBM * (D + 1) + kBN * (D + 1) + kBN * D) *
         sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Sq, int Sk, Strides qs_,
                 Strides ks_, Strides vs_, Strides os_, float sm_scale,
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

  const T* qb = q + b * qs_.b + h * qs_.h;
  const T* kb = k + b * ks_.b + h * ks_.h;
  const T* vb = v + b * vs_.b + h * vs_.h;

  for (int idx = tid; idx < kBM * D; idx += kThreads) {
    const int row = idx / D, col = idx % D;
    const int gq = q0 + row;
    qs[row * DP + col] = gq < Sq ? ds_to_float(qb[gq * qs_.s + col]) : 0.f;
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
      const bool ok = gk < Sk;
      ks[row * DP + col] = ok ? ds_to_float(kb[gk * ks_.s + col]) : 0.f;
      vs[row * D + col] = ok ? ds_to_float(vb[gk * vs_.s + col]) : 0.f;
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
    T* orow = o + b * os_.b + h * os_.h + qrow * os_.s;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[j + kTPR * c] = ds_from_float<T>(acc[c] / denom);
    if (j == 0) {
      lse[(static_cast<size_t>(b) * H + h) * Sq + qrow] = m + logf(l + 1e-37f);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
           Strides os, float sm_scale, int causal, const int* seed,
           int keep_threshold, float keep_scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBM - 1) / kBM, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, Sq, Sk, qs, ks,
      vs, os, sm_scale, causal, seed, keep_threshold, keep_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int H, int Sq, int Sk, Strides qs, Strides ks,
             Strides vs, Strides os, float sm_scale, int causal,
             const int* seed, int keep_threshold, float keep_scale,
             cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, H, Sq, Sk, qs, ks, vs, os, sm_scale, causal, seed, keep_threshold, keep_scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, H, Sq, Sk, qs, ks, vs, os, sm_scale, causal, seed, keep_threshold, keep_scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int ds_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int Sq, int Sk, int D, long long q_sb, long long q_sh,
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
  if (dtype == DS_DTYPE_BF16) {
    return launch_d<__nv_bfloat16>(D, q, k, v, o, l, B, H, Sq, Sk, qs, ks, vs,
                                   os, sm_scale, causal, sd, keep_threshold,
                                   keep_scale, s);
  }
  if (dtype == DS_DTYPE_FP32) {
    return launch_d<float>(D, q, k, v, o, l, B, H, Sq, Sk, qs, ks, vs, os,
                           sm_scale, causal, sd, keep_threshold, keep_scale,
                           s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
