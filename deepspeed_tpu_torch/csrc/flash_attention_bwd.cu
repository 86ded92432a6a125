// Kernel E: flash-attention backward (FlashAttention-2), two launches:
//   dkdv: one block per (k-tile of 64 keys, head, batch) loops over the
//         q-tiles and writes dk, dv;
//   dq:   one block per (q-tile of 64 rows, head, batch) loops over the
//         k-tiles and writes dq.
// Neither needs atomics: each output tile has exactly one block that owns
// it, so the sums are taken in a fixed order and a step is repeatable
// bitwise.
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
// Products accumulate in fp32 and are stored in the input dtype.  Strides
// are arguments, so q, k, v, dO and the grads may be the head views of a
// fused [B, S, 3 * H * D] projection.
//
// Head dims above 256 run the wide kernels of attention_wide.cuh (bf16 on
// the tensor cores, fp32 on the CUDA cores): the output columns in chunks
// of 128 over the grid, each block computing S and dP over the whole D
// from slices.  Up to 256, any D runs, on either route, the
// smallest instantiation (32, 64, 96, 128, 256) at or above it; the columns past
// the true D are zero-filled on load, so they add nothing to a product,
// and are never stored.  The tensor-core route takes D a multiple of 8
// (its 16-byte copies): the Python wrapper pads any other D with zero
// columns up to one, and passes the true D's 1 / sqrt(D); the zero
// columns add nothing to S, dP, delta or the grads either.
//
// Two routes, chosen by the operands' dtype:
//
// bf16, tensor cores (tc::flash_bwd_dkdv_mma_kernel and
// tc::flash_bwd_dq_mma_kernel, D in {32, 64, 96, 128, 256}).
//   Bound on the H100: at the training shape ([8, 12, 1024, 64] causal)
//   the dk/dv launch does four [S, S] x D products per head (S^T, dP^T,
//   dV, dK: 25.8 GFLOP) and the dq launch three (S, dP, dQ: 19.4 GFLOP),
//   26 and 20 us at the 989 TFLOP/s bf16 peak, against ~7 and ~6 us for
//   their bytes: the operations bound both.  What the CUDA-core design
//   lost, and what this one does about it:
//   - every product runs on `mma.sync` m16n8k16 (bf16 in, fp32 sums) from
//     swizzled bf16 tiles that ldmatrix reads without bank conflicts;
//   - dk/dv: K and V stay in shared memory for the whole loop; each warp
//     owns 16 keys and computes S^T = K Q^T and dP^T = V dO^T, so that
//     P_drop^T and dS^T arrive in the accumulator layout and become, in
//     registers, the A operands of dV += P_drop^T dO and dK += dS^T Q:
//     no P or dS tile in shared memory and no shuffles (the first design
//     staged both in 100 KB of shared memory, two blocks per SM);
//   - dq: each warp owns 16 query rows, S = Q K^T and dP = dO V^T, dS in
//     registers, dQ += dS K;
//   - the loads: the streamed tiles (Q, dO, lse, delta over the q-tiles
//     for dk/dv; K, V over the k-tiles for dq) go through a ring of two
//     `cp.async` stages, one in flight while the other is multiplied;
//   - the schedule: tiles wholly above the causal diagonal are never
//     loaded; dk/dv starts each block at the diagonal; both grids walk the
//     heaviest tiles first; dropout's keep bits are drawn once per block
//     per tile into shared memory (attention_mma.cuh draw_keep_bits);
//   - the per-tile work of each launch is attention_mma.cuh's
//     bwd_dkdv_tile_step / bwd_dq_tile_step, which kernel G shares;
//   - D = 256: a warp's sums of 16 keys x 256 columns of dK and of dV
//     would take 256 registers alone, so the block has two groups of four
//     warps (ds_mma::ColumnSplit), each owning 128 columns of dK and dV
//     (or of dQ) and computing the whole-D S and dP of its 16 keys (rows)
//     from shared memory: those two products run twice, the output
//     products once.  K, V and two stages of Q and dO take 192 KB of
//     shared memory, one block per SM.
//
// fp32, CUDA cores (fp32::flash_bwd_dkdv_kernel, fp32::flash_bwd_dq_kernel,
// the first design, kept as it was).  A tensor-core fp32 product would be
// TF32, about three decimal digits, which breaks the 1e-4 fp32 parity the
// fp32 engine mode is held to; so fp32 operands multiply in fp32 on the
// CUDA cores out of shared memory (67 TFLOP/s peak).  256 threads; for
// the scores of a 64 x 64 tile, 4 threads share a query row and each holds
// the 16 columns n0 + j + 4 * i, so one Philox call gives a thread its 16
// keep bytes.  At D = 256 the tiles are 32 x 32 with 128 threads (Tiles),
// since four fp32 tiles of 64 rows would not fit shared memory; a thread
// then holds 8 columns, half of its Philox call's bytes.  dkdv stages P_drop and dS in shared memory and then gives
// each thread a key row (4 threads per row, D / 4 columns each) to sum
// over the q rows; dq sums over the keys inside the 4-thread row group
// with shuffles.

#include "attention_mma.cuh"
#include "attention_wide.cuh"

namespace {

struct Strides {
  long long b, h, s;
};

struct DropoutArgs {
  const int* seed;
  int threshold;  // 256: no dropout
  float scale;
};


// ===================================================================== //
// fp32: CUDA cores
// ===================================================================== //
namespace fp32 {

constexpr int kTPR = 4;  // threads per row

// The tiles by head dim: 64 query rows and 64 keys, 256 threads; for
// D > 128, 32 and 32 with 128 threads, since four fp32 tiles of 64 rows
// (Q, dO, K, V: 263 KB at D = 256) would not fit the 227 KB of shared
// memory a block can have.
template <int D>
struct Tiles {
  static constexpr int kBM = D > 128 ? 32 : 64;  // query rows per tile
  static constexpr int kBN = kBM;                // keys per tile
  static constexpr int kThreads = kTPR * kBM;
  static constexpr int kNS = kBN / kTPR;         // scores per thread per tile
  static constexpr int kPP = kBN + 1;            // padded row of the P / dS tiles
};

// Load rows [r0, r0 + rows) of one head's [S, D] operand as fp32 into a
// [rows][DP] tile, zero past S.
template <typename T, int D, int DP, int NT>
__device__ __forceinline__ void load_tile(float* dst, const T* src, Strides st,
                                          int r0, int rows, int S, int dhead) {
  for (int idx = threadIdx.x; idx < rows * D; idx += NT) {
    const int row = idx / D, col = idx % D;
    const int g = r0 + row;
    dst[row * DP + col] = g < S && col < dhead ? ds_to_float(src[g * st.s + col]) : 0.f;
  }
}

// The NS scores and dP of this thread's row r against keys n0 + j + 4 i,
// turned into P (in s) and dS (in dp); p_drop gets the dropped P.  A
// Philox call gives the keep bytes of 64 keys (dropout.cuh): a tile of 32
// keys takes the half its n0 falls in.
template <int D, int DP, int NS>
__device__ __forceinline__ void tile_grads(
    const float* qs, const float* dos, const float* ks, const float* vs,
    int r, int j, int qrow, int n0, int Sq, int Sk, float lse_r,
    float delta_r, float sm_scale, int causal, uint32_t seed, uint32_t bh,
    const DropoutArgs& drop, float* s, float* dp, float* p_drop) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    s[i] = 0.f;
    dp[i] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float qd = qs[r * DP + d];
    const float dod = dos[r * DP + d];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      s[i] = fmaf(qd, ks[(j + kTPR * i) * DP + d], s[i]);
      dp[i] = fmaf(dod, vs[(j + kTPR * i) * DP + d], dp[i]);
    }
  }
  const bool dropping = drop.threshold < 256;
  uint4 bytes = make_uint4(0u, 0u, 0u, 0u);
  if (dropping) bytes = ds_dropout_bytes(seed, bh, qrow, n0, j);
  const int byte0 = NS == 16 ? 0 : (n0 & 63) / kTPR;  // the call's first byte here
  const uint32_t threshold = static_cast<uint32_t>(drop.threshold);
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int col = n0 + j + kTPR * i;
    const bool live = qrow < Sq && col < Sk && !(causal && col > qrow);
    const float p = live ? expf(s[i] * sm_scale - lse_r) : 0.f;
    float dpv = dp[i];
    float pd = p;
    if (dropping) {
      const bool keep = ds_byte(bytes, byte0 + i) < threshold;
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
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int Sq, int Sk, Strides qs_,
                      Strides ks_, Strides vs_, Strides dos_, Strides dks_,
                      Strides dvs_, float sm_scale, int dhead, int causal,
                      DropoutArgs drop) {
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

  load_tile<T, D, DP, kThreads>(ks, k + b * ks_.b + h * ks_.h, ks_, n0, kBN, Sk, dhead);
  load_tile<T, D, DP, kThreads>(vs, v + b * vs_.b + h * vs_.h, vs_, n0, kBN, Sk, dhead);

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
    load_tile<T, D, DP, kThreads>(qs, q + b * qs_.b + h * qs_.h, qs_, m0, kBM, Sq, dhead);
    load_tile<T, D, DP, kThreads>(dos, dout + b * dos_.b + h * dos_.h, dos_, m0, kBM, Sq,
                                  dhead);
    for (int i = tid; i < kBM; i += kThreads) {
      const bool ok = m0 + i < Sq;
      lse_s[i] = ok ? lse[stat0 + m0 + i] : 0.f;
      delta_s[i] = ok ? delta[stat0 + m0 + i] : 0.f;
    }
    __syncthreads();

    float s[kNS], dp[kNS], pd[kNS];
    tile_grads<D, DP, kNS>(qs, dos, ks, vs, r, j, m0 + r, n0, Sq, Sk, lse_s[r],
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
      if (j + kTPR * c < dhead) dkrow[j + kTPR * c] = ds_from_float<T>(dk_acc[c]);
      if (j + kTPR * c < dhead) dvrow[j + kTPR * c] = ds_from_float<T>(dv_acc[c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Tiles<D>::kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int Sq, int Sk, Strides qs_, Strides ks_,
                    Strides vs_, Strides dos_, Strides dqs_, float sm_scale, int dhead,
                    int causal, DropoutArgs drop) {
  using TL = Tiles<D>;
  constexpr int kBM = TL::kBM, kBN = TL::kBN, kThreads = TL::kThreads, kNS = TL::kNS;
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

  load_tile<T, D, DP, kThreads>(qs, q + b * qs_.b + h * qs_.h, qs_, q0, kBM, Sq, dhead);
  load_tile<T, D, DP, kThreads>(dos, dout + b * dos_.b + h * dos_.h, dos_, q0, kBM, Sq, dhead);

  float acc[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) acc[c] = 0.f;

  const T* kb = k + b * ks_.b + h * ks_.h;
  const T* vb = v + b * vs_.b + h * vs_.h;
  const int kend = causal ? min(Sk, q0 + kBM) : Sk;
  for (int n0 = 0; n0 < kend; n0 += kBN) {
    __syncthreads();  // Q, dO loaded / the previous K, V consumed
    load_tile<T, D, DP, kThreads>(ks, kb, ks_, n0, kBN, Sk, dhead);
    load_tile<T, D, DP, kThreads>(vs, vb, vs_, n0, kBN, Sk, dhead);
    __syncthreads();

    float s[kNS], ds[kNS], pd[kNS];
    tile_grads<D, DP, kNS>(qs, dos, ks, vs, r, j, qrow, n0, Sq, Sk, lse_r,
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
    for (int c = 0; c < DC; ++c)
      if (j + kTPR * c < dhead) dqrow[j + kTPR * c] = ds_from_float<T>(acc[c]);
  }
}

template <typename T, int D>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dk, void* dv,
                int B, int H, int Sq, int Sk, Strides qs, Strides ks,
                Strides vs, Strides dos, Strides dks, Strides dvs,
                float sm_scale, int dhead, int causal, DropoutArgs drop,
                cudaStream_t stream) {
  const size_t smem = dkdv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sk + Tiles<D>::kBN - 1) / Tiles<D>::kBN, H, B);
  flash_bwd_dkdv_kernel<T, D><<<grid, Tiles<D>::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), H, Sq, Sk, qs, ks, vs, dos,
      dks, dvs, sm_scale, dhead, causal, drop);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int H,
              int Sq, int Sk, Strides qs, Strides ks, Strides vs, Strides dos,
              Strides dqs, float sm_scale, int dhead, int causal, DropoutArgs drop,
              cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + Tiles<D>::kBM - 1) / Tiles<D>::kBM, H, B);
  flash_bwd_dq_kernel<T, D><<<grid, Tiles<D>::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), H, Sq, Sk, qs, ks, vs, dos, dqs, sm_scale, dhead, causal,
      drop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fp32

// ===================================================================== //
// bf16: tensor cores
// ===================================================================== //
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kBM = 64;  // query rows per tile
constexpr int kBN = 64;  // keys per tile
// four warps of 16 rows (dq) or 16 keys (dkdv) per column group
// (ds_mma::ColumnSplit: one group up to D = 128, two at D = 256)
template <int D>
constexpr int kThreads = ds_mma::ColumnSplit<D>::kThreads;

template <int D>
struct DkdvLayout {
  static constexpr int kK = 0;                                       // [kBN][D]
  static constexpr int kV = kK + ds_mma::tile_bytes<D>(kBN);         // [kBN][D]
  static constexpr int kQ = kV + ds_mma::tile_bytes<D>(kBN);         // [2][kBM][D]
  static constexpr int kDO = kQ + 2 * ds_mma::tile_bytes<D>(kBM);    // [2][kBM][D]
  static constexpr int kLse = kDO + 2 * ds_mma::tile_bytes<D>(kBM);  // [2][kBM] fp32
  static constexpr int kDelta = kLse + 2 * kBM * 4;                  // [2][kBM] fp32
  static constexpr int kBits = kDelta + 2 * kBM * 4;                 // [2][kBM] u64
  static constexpr int kBytes = kBits + 2 * kBM * 8;
};

// At D = 64 the registers are capped so that three blocks fit an SM (168
// registers, a few bytes spilled): measured faster on the H100 than two
// blocks at the 255 the compiler picks.  The dq launch measured slower
// under a cap and has none.
template <int D>
__global__ void __launch_bounds__(kThreads<D>, D == 64 ? 3 : 1)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int H, int Sq,
                          int Sk, Strides qs_, Strides ks_, Strides vs_, Strides dos_,
                          Strides dks_, Strides dvs_, float sm_scale, int dhead, int causal,
                          DropoutArgs drop) {
  using L = DkdvLayout<D>;
  using Split = ds_mma::ColumnSplit<D>;
  constexpr int NT = kThreads<D>, DO = Split::DO;
  constexpr int kTile = ds_mma::tile_bytes<D>(kBM);
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t s_k = ds_mma::smem_u32(tc_smem + L::kK);
  const uint32_t s_v = ds_mma::smem_u32(tc_smem + L::kV);
  const uint32_t s_q = ds_mma::smem_u32(tc_smem + L::kQ);
  const uint32_t s_do = ds_mma::smem_u32(tc_smem + L::kDO);
  const uint32_t s_lse = ds_mma::smem_u32(tc_smem + L::kLse);
  const uint32_t s_delta = ds_mma::smem_u32(tc_smem + L::kDelta);
  const float* lse_s = reinterpret_cast<const float*>(tc_smem + L::kLse);
  const float* delta_s = reinterpret_cast<const float*>(tc_smem + L::kDelta);
  uint64_t* bits = reinterpret_cast<uint64_t*>(tc_smem + L::kBits);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_bh = B * H;
  const int bh = blockIdx.x % n_bh;
  // k-tile 0 first: under causal masking it sees the most q-tiles
  const int n0 = static_cast<int>(blockIdx.x) / n_bh * kBN;
  const int b = bh / H, h = bh % H;
  const bool dropping = drop.threshold < 256;
  const uint32_t seed = dropping ? static_cast<uint32_t>(*drop.seed) : 0u;
  const uint32_t threshold = static_cast<uint32_t>(drop.threshold);
  const float* lse_b = lse + static_cast<size_t>(bh) * Sq;
  const float* delta_b = delta + static_cast<size_t>(bh) * Sq;
  const bf16* qb = q + b * qs_.b + h * qs_.h;
  const bf16* dob = dout + b * dos_.b + h * dos_.h;

  // causal: q-tiles whose last row lies before this k-tile see none of it
  const int m_start = causal ? n0 / kBM * kBM : 0;
  const int n_tiles = m_start < Sq ? (Sq - m_start + kBM - 1) / kBM : 0;
  auto load_q_tile = [&](int stage, int m0) {
    ds_mma::load_tile_async<kBM, D, NT>(s_q + stage * kTile, qb, qs_.s, m0, Sq, tid, dhead);
    ds_mma::load_tile_async<kBM, D, NT>(s_do + stage * kTile, dob, dos_.s, m0, Sq, tid, dhead);
    ds_mma::load_stat_async<kBM, NT>(s_lse + stage * kBM * 4, lse_b, m0, Sq, tid);
    ds_mma::load_stat_async<kBM, NT>(s_delta + stage * kBM * 4, delta_b, m0, Sq, tid);
  };

  ds_mma::load_tile_async<kBN, D, NT>(s_k, k + b * ks_.b + h * ks_.h, ks_.s, n0, Sk, tid, dhead);
  ds_mma::load_tile_async<kBN, D, NT>(s_v, v + b * vs_.b + h * vs_.h, vs_.s, n0, Sk, tid, dhead);
  if (n_tiles > 0) load_q_tile(0, m_start);
  ds_mma::cp_async_commit();
  if (dropping && n_tiles > 0) {
    ds_mma::draw_keep_bits<kBM, NT>(bits, seed, bh, m_start, n0, threshold, tid);
  }

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

  for (int t = 0; t < n_tiles; ++t) {
    ds_mma::cp_async_wait<0>();  // tile t has landed
    __syncthreads();             // ... for every thread; tile t - 1 is consumed
    const int st = t & 1;
    const int m0 = m_start + t * kBM;
    if (t + 1 < n_tiles) {  // tile t + 1 flies while tile t is multiplied
      load_q_tile(st ^ 1, m0 + kBM);
      ds_mma::cp_async_commit();
      if (dropping) {
        ds_mma::draw_keep_bits<kBM, NT>(bits + (st ^ 1) * kBM, seed, bh, m0 + kBM, n0, threshold,
                                        tid);
      }
    }
    // causal: every query of the tile lies before the warp's keys
    if (causal && m0 + kBM - 1 < key0) continue;
    const bool edge = m0 + kBM > Sq || n0 + kBN > Sk || (causal && m0 < key0 + 15);
    ds_mma::bwd_dkdv_tile_step<D, DO, true>(dk_acc, dv_acc, s_k, s_v, w0, s_q + st * kTile,
                                            s_do + st * kTile, lse_s + st * kBM,
                                            delta_s + st * kBM, m0, n0, Sq, Sk, causal, edge,
                                            sm_scale, dropping, bits + st * kBM, drop.scale, lane,
                                            col0);
  }

  // dk and dv through the warp's own rows of the K and V tiles, for
  // 16-byte stores
  ds_mma::cp_async_wait<0>();
  __syncthreads();
  const float dv_scale = dropping ? drop.scale : 1.f;
  ds_mma::acc_to_tile<D, DO>(tc_smem + L::kK, w0, dk_acc, 1.f, 1.f, lane, col0);
  ds_mma::acc_to_tile<D, DO>(tc_smem + L::kV, w0, dv_acc, dv_scale, dv_scale, lane, col0);
  __syncwarp();
  ds_mma::tile_rows_to_global<D, DO>(dk + b * dks_.b + h * dks_.h, dks_.s, key0, Sk,
                                     tc_smem + L::kK, w0, lane, dhead, col0);
  ds_mma::tile_rows_to_global<D, DO>(dv + b * dvs_.b + h * dvs_.h, dvs_.s, key0, Sk,
                                     tc_smem + L::kV, w0, lane, dhead, col0);
}

template <int D>
struct DqLayout {
  static constexpr int kQ = 0;                                       // [kBM][D]
  static constexpr int kDO = kQ + ds_mma::tile_bytes<D>(kBM);        // [kBM][D]
  static constexpr int kK = kDO + ds_mma::tile_bytes<D>(kBM);        // [2][kBN][D]
  static constexpr int kV = kK + 2 * ds_mma::tile_bytes<D>(kBN);     // [2][kBN][D]
  static constexpr int kBits = kV + 2 * ds_mma::tile_bytes<D>(kBN);  // [2][kBM] u64
  static constexpr int kBytes = kBits + 2 * kBM * 8;
};

// At D = 64 the registers are capped so that three blocks fit an SM, as
// dk/dv's are: the run-time head dim's masks took the uncapped kernel from
// 167 registers to 174 and two blocks an SM, 27% slower on the H100.
template <int D>
__global__ void __launch_bounds__(kThreads<D>, D == 64 ? 3 : 1)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int B, int H, int Sq, int Sk, Strides qs_,
                        Strides ks_, Strides vs_, Strides dos_, Strides dqs_,
                        float sm_scale, int dhead,
                        int causal, DropoutArgs drop) {
  using L = DqLayout<D>;
  using Split = ds_mma::ColumnSplit<D>;
  constexpr int NT = kThreads<D>, DO = Split::DO;
  constexpr int kKV = ds_mma::tile_bytes<D>(kBN);
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t s_q = ds_mma::smem_u32(tc_smem + L::kQ);
  const uint32_t s_do = ds_mma::smem_u32(tc_smem + L::kDO);
  const uint32_t s_k = ds_mma::smem_u32(tc_smem + L::kK);
  const uint32_t s_v = ds_mma::smem_u32(tc_smem + L::kV);
  uint64_t* bits = reinterpret_cast<uint64_t*>(tc_smem + L::kBits);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_bh = B * H;
  const int bh = blockIdx.x % n_bh;
  // heaviest q-tiles first: under causal masking the last tiles see most keys
  const int q0 = ((Sq + kBM - 1) / kBM - 1 - static_cast<int>(blockIdx.x) / n_bh) * kBM;
  const int b = bh / H, h = bh % H;
  const bool dropping = drop.threshold < 256;
  const uint32_t seed = dropping ? static_cast<uint32_t>(*drop.seed) : 0u;
  const uint32_t threshold = static_cast<uint32_t>(drop.threshold);
  const bf16* kb = k + b * ks_.b + h * ks_.h;
  const bf16* vb = v + b * vs_.b + h * vs_.h;
  const int kend = causal ? min(Sk, q0 + kBM) : Sk;
  const int n_tiles = (kend + kBN - 1) / kBN;

  ds_mma::load_tile_async<kBM, D, NT>(s_q, q + b * qs_.b + h * qs_.h, qs_.s, q0, Sq, tid, dhead);
  ds_mma::load_tile_async<kBM, D, NT>(s_do, dout + b * dos_.b + h * dos_.h, dos_.s, q0, Sq, tid,
                                      dhead);
  if (n_tiles > 0) {
    ds_mma::load_tile_async<kBN, D, NT>(s_k, kb, ks_.s, 0, Sk, tid, dhead);
    ds_mma::load_tile_async<kBN, D, NT>(s_v, vb, vs_.s, 0, Sk, tid, dhead);
  }
  ds_mma::cp_async_commit();
  if (dropping && n_tiles > 0) {
    ds_mma::draw_keep_bits<kBM, NT>(bits, seed, bh, q0, 0, threshold, tid);
  }

  const int w0 = (Split::kParts == 1 ? warp : warp & 3) * 16;  // the warp's first row
  const int col0 = Split::kParts == 1 ? 0 : (warp >> 2) * DO;   // ... and output column
  const int row0 = q0 + w0;    // the warp's first row in the sequence
  const int rows[2] = {row0 + (lane >> 2), row0 + (lane >> 2) + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = rows[r] < Sq;
    lse_r[r] = ok ? lse[static_cast<size_t>(bh) * Sq + rows[r]] : 0.f;
    delta_r[r] = ok ? delta[static_cast<size_t>(bh) * Sq + rows[r]] : 0.f;
  }
  float acc[DO / 8][4];
#pragma unroll
  for (int j = 0; j < DO / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    ds_mma::cp_async_wait<0>();  // tile t has landed
    __syncthreads();             // ... for every thread; tile t - 1 is consumed
    const int st = t & 1;
    const int n0 = t * kBN;
    if (t + 1 < n_tiles) {  // tile t + 1 flies while tile t is multiplied
      ds_mma::load_tile_async<kBN, D, NT>(s_k + (st ^ 1) * kKV, kb, ks_.s, n0 + kBN, Sk, tid,
                                          dhead);
      ds_mma::load_tile_async<kBN, D, NT>(s_v + (st ^ 1) * kKV, vb, vs_.s, n0 + kBN, Sk, tid,
                                          dhead);
      ds_mma::cp_async_commit();
      if (dropping) {
        ds_mma::draw_keep_bits<kBM, NT>(bits + (st ^ 1) * kBM, seed, bh, q0, n0 + kBN,
                                        threshold, tid);
      }
    }
    // causal: a warp whose rows all lie above this tile has nothing in it
    if (causal && n0 > row0 + 15) continue;
    const bool edge = n0 + kBN > Sk || (causal && n0 + kBN - 1 > row0);
    ds_mma::bwd_dq_tile_step<D, DO, true>(acc, s_q, s_do, w0, s_k + st * kKV, s_v + st * kKV,
                                          n0, rows, lse_r, delta_r, Sk, causal, edge, sm_scale,
                                          dropping, bits + st * kBM + w0 + (lane >> 2),
                                          drop.scale, lane, col0);
  }

  // dq through the warp's own rows of the Q tile, for 16-byte stores
  ds_mma::cp_async_wait<0>();
  __syncthreads();
  ds_mma::acc_to_tile<D, DO>(tc_smem + L::kQ, w0, acc, 1.f, 1.f, lane, col0);
  __syncwarp();
  ds_mma::tile_rows_to_global<D, DO>(dq + b * dqs_.b + h * dqs_.h, dqs_.s, row0, Sq,
                                     tc_smem + L::kQ, w0, lane, dhead, col0);
}

template <int D>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dk, void* dv, int B, int H,
                int Sq, int Sk, Strides qs, Strides ks, Strides vs, Strides dos,
                Strides dks, Strides dvs, float sm_scale, int dhead, int causal, DropoutArgs drop,
                cudaStream_t stream) {
  constexpr int smem = DkdvLayout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>((Sk + kBN - 1) / kBN) * B * H;
  flash_bwd_dkdv_mma_kernel<D><<<static_cast<unsigned>(blocks), kThreads<D>, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), B, H, Sq, Sk, qs, ks, vs, dos, dks, dvs, sm_scale, dhead, causal,
      drop);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int H, int Sq, int Sk,
              Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs,
              float sm_scale, int dhead,
              int causal, DropoutArgs drop, cudaStream_t stream) {
  constexpr int smem = DqLayout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>((Sq + kBM - 1) / kBM) * B * H;
  flash_bwd_dq_mma_kernel<D><<<static_cast<unsigned>(blocks), kThreads<D>, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), B, H, Sq, Sk, qs,
      ks, vs, dos, dqs, sm_scale, dhead, causal, drop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// Strides come as (batch, head, seq) triples in the order of the tensor
// arguments.
extern "C" int ds_flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int Sq, int Sk, int D, int chunks, const long long* strides, float sm_scale,
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
#define DS_DKDV(NS, ...)                                                                   \
  return NS::launch_dkdv<__VA_ARGS__>(q, k, v, dout, l, dl, dk, dv, B, H, Sq, Sk, qs, ks, vs, \
                                      dos, dks, dvs, sm_scale, D, causal, drop, s)
  // any D up to 256 (bf16: a multiple of 8) runs the smallest instantiation
  // at or above it, its columns past D zero-filled on load and masked on
  // store; a larger D runs the wide kernel, `chunks` column chunks
  if (!ds_head_dim_plan_ok(D, chunks, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  if (D > DS_MAX_TILED_HEAD_DIM) {
    const ds_wide::DenseWalk walk{Sq, Sk, causal};
    const ds_wide::Dropout wd{drop.seed, drop.threshold, drop.scale};
#define DS_WIDE_DKDV(F)                                                                     \
  return F(q, k, v, dout, l, dl, dk, dv, B, H, D, qs, ks, vs, dos, dks, dvs,                      \
                                 sm_scale, walk, wd, s)
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

extern "C" int ds_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int Sq,
    int Sk, int D, int chunks, const long long* strides, float sm_scale, int causal,
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
#define DS_DQ(NS, ...)                                                                    \
  return NS::launch_dq<__VA_ARGS__>(q, k, v, dout, l, dl, dq, B, H, Sq, Sk, qs, ks, vs, dos, \
                                    dqs, sm_scale, D, causal, drop, s)
  // any D up to 256 (bf16: a multiple of 8) runs the smallest instantiation
  // at or above it, its columns past D zero-filled on load and masked on
  // store; a larger D runs the wide kernel, `chunks` column chunks
  if (!ds_head_dim_plan_ok(D, chunks, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  if (D > DS_MAX_TILED_HEAD_DIM) {
    const ds_wide::DenseWalk walk{Sq, Sk, causal};
    const ds_wide::Dropout wd{drop.seed, drop.threshold, drop.scale};
#define DS_WIDE_DQ(F)                                                                       \
  return F(q, k, v, dout, l, dl, dq, B, H, D, qs, ks, vs, dos, dqs, sm_scale,                     \
                               walk, wd, s)
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

