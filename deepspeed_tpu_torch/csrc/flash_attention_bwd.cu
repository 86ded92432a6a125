// Kernel E: flash-attention backward (FlashAttention-2), two launches:
//   dkdv: one block per (k-tile of 64 keys, head, batch) loops over the
//         q-tiles and writes dk, dv;
//   dq:   one block per (q-tile of 64 rows, head, batch) loops over the
//         k-tiles and writes dq.
// Neither needs atomics: each output tile has exactly one block that owns
// it, so the sums are taken in a fixed order and a step is repeatable.
//
// Replaces: deepspeed_tpu/ops/flash_attention.py flash_attention_bwd_pallas
// (_fa_bwd_dkdv_kernel, _fa_bwd_dq_kernel).  Same math, from the forward's
// logsumexp and delta = rowsum(dO * O) (computed beside the launch, as the
// JAX package leaves it to XLA):
//   P  = exp(S * scale - lse), 0 above the causal diagonal and past Sk;
//   dP = dO V^T, then dropped and scaled with the forward's own keep mask
//        (dropout.cuh regenerates it from (seed, b, h, row, col));
//   dV += P_drop^T dO;   dS = P * (dP - delta) * scale;
//   dK += dS^T Q;        dQ += dS K.
// Products accumulate in fp32 and are stored in the input dtype.
//
// Bound on the H100: at the training shape ([8, 12, 1024, 64] bf16 causal)
// the work is five [S, S] x D products per head, ~32 GFLOP, against ~100 MB
// of q, k, v, o, dO, dq, dk, dv: ~33 us at the bf16 tensor-core peak and
// ~30 us at the memory rate, so operations bound it.  This first version
// multiplies in fp32 on the CUDA cores out of shared memory (67 TFLOP/s
// peak), which is simple to get right; mma.sync / wgmma tiles are later
// work.  What it keeps from FlashAttention-2 is the memory side: the
// [S, S] scores and probabilities never reach device memory, and tiles
// fully above the causal diagonal are never loaded.
//
// Thread layout: 256 threads.  For the scores of a 64 x 64 tile, 4 threads
// share a query row and each holds the 16 columns n0 + j + 4 * i, the
// layout of kernel B, so one Philox call gives a thread its 16 keep bytes.
// dkdv stages P_drop and dS in shared memory and then gives each thread a
// key row (4 threads per row, D / 4 columns each) to sum over the q rows;
// dq sums over the keys inside the 4-thread row group with shuffles, as
// kernel B sums P.V.  Strides are arguments, so q, k, v, dO and the grads
// may be the head views of a fused [B, S, 3 * H * D] projection.

#include "common.cuh"
#include "dropout.cuh"

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

struct DropoutArgs {
  const int* seed;
  int threshold;  // 256: no dropout
  float scale;
};

// Load rows [r0, r0 + rows) of one head's [S, D] operand as fp32 into a
// [rows][DP] tile, zero past S.
template <typename T, int D, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* src, Strides st,
                                          int r0, int rows, int S) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int row = idx / D, col = idx % D;
    const int g = r0 + row;
    dst[row * DP + col] = g < S ? ds_to_float(src[g * st.s + col]) : 0.f;
  }
}

// The 16 scores and dP of this thread's row r against keys n0 + j + 4 i,
// turned into P (in s) and dS (in dp); p_drop gets the dropped P.
template <int D, int DP>
__device__ __forceinline__ void tile_grads(
    const float* qs, const float* dos, const float* ks, const float* vs,
    int r, int j, int qrow, int n0, int Sq, int Sk, float lse_r,
    float delta_r, float sm_scale, int causal, uint32_t seed, uint32_t bh,
    const DropoutArgs& drop, float* s, float* dp, float* p_drop) {
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
  const bool dropping = drop.threshold < 256;
  uint4 bytes = make_uint4(0u, 0u, 0u, 0u);
  if (dropping) bytes = ds_dropout_bytes(seed, bh, qrow, n0, j);
  const uint32_t threshold = static_cast<uint32_t>(drop.threshold);
#pragma unroll
  for (int i = 0; i < kNS; ++i) {
    const int col = n0 + j + kTPR * i;
    const bool live = qrow < Sq && col < Sk && !(causal && col > qrow);
    const float p = live ? expf(s[i] * sm_scale - lse_r) : 0.f;
    float dpv = dp[i];
    float pd = p;
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
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int Sq, int Sk, Strides qs_,
                      Strides ks_, Strides vs_, Strides dos_, Strides dks_,
                      Strides dvs_, float sm_scale, int causal,
                      DropoutArgs drop) {
  constexpr int DP = D + 1;
  constexpr int DC = D / kTPR;
  extern __shared__ float smem[];
  float* ks = smem;              // [kBN][DP]
  float* vs = ks + kBN * DP;     // [kBN][DP]
  float* qs = vs + kBN * DP;     // [kBM][DP]
  float* dos = qs + kBM * DP;    // [kBM][DP]
  float* pds = dos + kBM * DP;   // [kBM][kPP] dropped P
  float* dss = pds + kBM * kPP;  // [kBM][kPP] dS
  float* lse_s = dss + kBM * kPP;
  float* delta_s = lse_s + kBM;

  const int tid = threadIdx.x;
  const int r = tid / kTPR;  // score phase: query row; sum phase: key row
  const int j = tid % kTPR;
  const int n0 = blockIdx.x * kBN;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const uint32_t bh = static_cast<uint32_t>(b * H + h);
  const uint32_t seed =
      drop.threshold < 256 ? static_cast<uint32_t>(*drop.seed) : 0u;
  const size_t stat0 = (static_cast<size_t>(b) * H + h) * Sq;

  load_tile<T, D, DP>(ks, k + b * ks_.b + h * ks_.h, ks_, n0, kBN, Sk);
  load_tile<T, D, DP>(vs, v + b * vs_.b + h * vs_.h, vs_, n0, kBN, Sk);

  float dk_acc[DC], dv_acc[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) {
    dk_acc[c] = 0.f;
    dv_acc[c] = 0.f;
  }

  // causal: q-tiles whose last row lies before this k-tile see none of it
  const int m_start = causal ? (n0 / kBM) * kBM : 0;
  for (int m0 = m_start; m0 < Sq; m0 += kBM) {
    __syncthreads();  // the previous tile's P / dS are consumed
    load_tile<T, D, DP>(qs, q + b * qs_.b + h * qs_.h, qs_, m0, kBM, Sq);
    load_tile<T, D, DP>(dos, dout + b * dos_.b + h * dos_.h, dos_, m0, kBM,
                        Sq);
    for (int i = tid; i < kBM; i += kThreads) {
      const bool ok = m0 + i < Sq;
      lse_s[i] = ok ? lse[stat0 + m0 + i] : 0.f;
      delta_s[i] = ok ? delta[stat0 + m0 + i] : 0.f;
    }
    __syncthreads();

    float s[kNS], dp[kNS], pd[kNS];
    tile_grads<D, DP>(qs, dos, ks, vs, r, j, m0 + r, n0, Sq, Sk, lse_s[r],
                      delta_s[r], sm_scale, causal, seed, bh, drop, s, dp,
                      pd);
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
      pds[r * kPP + j + kTPR * i] = pd[i];
      dss[r * kPP + j + kTPR * i] = dp[i];
    }
    __syncthreads();

    // key row r of the tile: dv[r] += sum_m P_drop[m][r] dO[m],
    // dk[r] += sum_m dS[m][r] Q[m]
#pragma unroll 4
    for (int m = 0; m < kBM; ++m) {
      const float pv = pds[m * kPP + r];
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

  const int krow = n0 + r;
  if (krow < Sk) {
    T* dkrow = dk + b * dks_.b + h * dks_.h + krow * dks_.s;
    T* dvrow = dv + b * dvs_.b + h * dvs_.h + krow * dvs_.s;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dkrow[j + kTPR * c] = ds_from_float<T>(dk_acc[c]);
      dvrow[j + kTPR * c] = ds_from_float<T>(dv_acc[c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int Sq, int Sk, Strides qs_, Strides ks_,
                    Strides vs_, Strides dos_, Strides dqs_, float sm_scale,
                    int causal, DropoutArgs drop) {
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
  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qrow = q0 + r;
  const uint32_t bh = static_cast<uint32_t>(b * H + h);
  const uint32_t seed =
      drop.threshold < 256 ? static_cast<uint32_t>(*drop.seed) : 0u;
  const size_t stat = (static_cast<size_t>(b) * H + h) * Sq + qrow;
  const float lse_r = qrow < Sq ? lse[stat] : 0.f;
  const float delta_r = qrow < Sq ? delta[stat] : 0.f;

  load_tile<T, D, DP>(qs, q + b * qs_.b + h * qs_.h, qs_, q0, kBM, Sq);
  load_tile<T, D, DP>(dos, dout + b * dos_.b + h * dos_.h, dos_, q0, kBM, Sq);

  float acc[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) acc[c] = 0.f;

  const T* kb = k + b * ks_.b + h * ks_.h;
  const T* vb = v + b * vs_.b + h * vs_.h;
  const int kend = causal ? min(Sk, q0 + kBM) : Sk;
  for (int n0 = 0; n0 < kend; n0 += kBN) {
    __syncthreads();  // Q, dO loaded / the previous K, V consumed
    load_tile<T, D, DP>(ks, kb, ks_, n0, kBN, Sk);
    load_tile<T, D, DP>(vs, vb, vs_, n0, kBN, Sk);
    __syncthreads();

    float s[kNS], ds[kNS], pd[kNS];
    tile_grads<D, DP>(qs, dos, ks, vs, r, j, qrow, n0, Sq, Sk, lse_r,
                      delta_r, sm_scale, causal, seed, bh, drop, s, ds, pd);

    // dq[row] += sum_col dS[col] K[col]: the row's 64 dS values are spread
    // over its 4 threads; fetch the others' by shuffle
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

  if (qrow < Sq) {
    T* dqrow = dq + b * dqs_.b + h * dqs_.h + qrow * dqs_.s;
#pragma unroll
    for (int c = 0; c < DC; ++c) dqrow[j + kTPR * c] = ds_from_float<T>(acc[c]);
  }
}

template <typename T, int D>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dk, void* dv,
                int B, int H, int Sq, int Sk, Strides qs, Strides ks,
                Strides vs, Strides dos, Strides dks, Strides dvs,
                float sm_scale, int causal, DropoutArgs drop,
                cudaStream_t stream) {
  const size_t smem = dkdv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sk + kBN - 1) / kBN, H, B);
  flash_bwd_dkdv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), H, Sq, Sk, qs, ks, vs, dos,
      dks, dvs, sm_scale, causal, drop);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int H,
              int Sq, int Sk, Strides qs, Strides ks, Strides vs, Strides dos,
              Strides dqs, float sm_scale, int causal, DropoutArgs drop,
              cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBM - 1) / kBM, H, B);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), H, Sq, Sk, qs, ks, vs, dos, dqs, sm_scale, causal,
      drop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Strides come as (batch, head, seq) triples in the order of the tensor
// arguments.
extern "C" int ds_flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int Sq, int Sk, int D, const long long* strides, float sm_scale,
    int causal, const void* seed, int keep_threshold, float keep_scale,
    int dtype, void* stream) {
  const Strides qs{strides[0], strides[1], strides[2]},
      ks{strides[3], strides[4], strides[5]},
      vs{strides[6], strides[7], strides[8]},
      dos{strides[9], strides[10], strides[11]},
      dks{strides[12], strides[13], strides[14]},
      dvs{strides[15], strides[16], strides[17]};
  const DropoutArgs drop{static_cast<const int*>(seed), keep_threshold,
                         keep_scale};
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DS_DKDV(T, DIM)                                                     \
  return launch_dkdv<T, DIM>(q, k, v, dout, l, dl, dk, dv, B, H, Sq, Sk, qs, \
                             ks, vs, dos, dks, dvs, sm_scale, causal, drop,  \
                             s)
  if (dtype == DS_DTYPE_BF16 && D == 64) DS_DKDV(__nv_bfloat16, 64);
  if (dtype == DS_DTYPE_BF16 && D == 128) DS_DKDV(__nv_bfloat16, 128);
  if (dtype == DS_DTYPE_FP32 && D == 64) DS_DKDV(float, 64);
  if (dtype == DS_DTYPE_FP32 && D == 128) DS_DKDV(float, 128);
#undef DS_DKDV
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int ds_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int Sq,
    int Sk, int D, const long long* strides, float sm_scale, int causal,
    const void* seed, int keep_threshold, float keep_scale, int dtype,
    void* stream) {
  const Strides qs{strides[0], strides[1], strides[2]},
      ks{strides[3], strides[4], strides[5]},
      vs{strides[6], strides[7], strides[8]},
      dos{strides[9], strides[10], strides[11]},
      dqs{strides[12], strides[13], strides[14]};
  const DropoutArgs drop{static_cast<const int*>(seed), keep_threshold,
                         keep_scale};
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DS_DQ(T, DIM)                                                        \
  return launch_dq<T, DIM>(q, k, v, dout, l, dl, dq, B, H, Sq, Sk, qs, ks,   \
                           vs, dos, dqs, sm_scale, causal, drop, s)
  if (dtype == DS_DTYPE_BF16 && D == 64) DS_DQ(__nv_bfloat16, 64);
  if (dtype == DS_DTYPE_BF16 && D == 128) DS_DQ(__nv_bfloat16, 128);
  if (dtype == DS_DTYPE_FP32 && D == 64) DS_DQ(float, 64);
  if (dtype == DS_DTYPE_FP32 && D == 128) DS_DQ(float, 128);
#undef DS_DQ
  return static_cast<int>(cudaErrorInvalidValue);
}
