// Kernel C: int8 dequant-matmul, out[M, N] = x[M, K] @ (qweight[K, N] *
// scale[k // (K / groups)]), fp32 accumulation, out in x's dtype.
//
// Replaces: deepspeed_tpu/ops/quant.py fused_dequant_matmul (_dq_kernel).
// Same numerics: each int8 weight is converted on chip, scaled by its
// row's fp32 group scale and rounded to x's dtype (as the TPU kernel feeds
// its MXU), then multiplied with fp32 accumulation.  Every sum is taken in
// a fixed order with no atomics, so a launch repeats bitwise, and a call is
// one launch.
//
// Bound on the H100: bytes at decode, where M is the batch (8): the weight
// is read once for 2 M operations per int8 byte, far below the ~295 at
// which the tensor cores would bound it.  At prefill (M = 1024, ~1,500
// operations per byte) the bf16 tensor cores bound it.  Device memory sees
// only the int8 weight (1 byte per element, half of bf16), never a
// dequantized copy.  The launcher picks one of four kernels from the shape
// (ds_dequant_matmul_plan; ops/quant.py dequant_plan mirrors it):
//
// - dq_gemv_mma_kernel, bf16 x with M <= 8 (decode).  At these sizes the
//   time is memory latency, the number of SMs in play and the
//   instructions between a load and the sums, not the memory rate (GPT-2's
//   four weights are 0.6-2.4 MB, a few KB per SM).  So:
//   - the products run on the tensor cores with the operands swapped,
//     out^T[N, M] = W^T x^T: mma.sync m16n8k16 with the dequantized weight
//     as A (16 output columns) and x^T as B (n = 8 >= M).  A CUDA-core
//     design spends 8 FMAs a weight at M = 8 and measured slower than the
//     dense bf16 matmul; here a weight costs a byte permute, an add, a
//     multiply and half a pack;
//   - the fragment slots are assigned so that every operand comes straight
//     from the thread's own loads (see the kernel): 8 weights of a row in
//     one 8-byte load that skips L1 (the weight streams through once), x
//     in one 8-byte load; no shuffles and no shared memory feed the
//     products;
//   - every SM takes part: a block owns 64 columns and one of `split`
//     slices of K, its 8 (or 16) warps taking interleaved k-steps of 16;
//     the K slices of a column block form a thread-block cluster (up to
//     16, a non-portable size), split chosen so that the blocks reach 132
//     and a slice is at most 128 rows.  The choice is a sweep's on the
//     H100: 128-column blocks with 16-byte loads halve the
//     blocks, or need deeper slices, and measured slower at every GPT-2
//     shape; so did 16-column strips over the whole K (no cross-block sum,
//     but every block re-reads all of x);
//   - a row's scale: the group index of the thread's first row is one
//     division, later rows step it (rows only increase), never divide;
//   - the epilogue: the block sums its warps' fragments in shared memory
//     in warp order, and sends each group of four sums to the rank that
//     owns it with one 16-byte distributed-shared-memory store (stores
//     post without a round trip); after one cluster barrier each rank sums
//     its outputs over the ranks in rank order from its own shared memory.
//     A pull design (a cluster barrier, remote loads, a second barrier so
//     that no block left while read) measured slower.  The sum is a fixed
//     tree, so a launch repeats bitwise;
//   - on the host: static shared memory, the cluster-size attribute set
//     once per device, a launch one cudaLaunchKernelEx.
// - dq_gemv_kernel, M <= 8 otherwise (fp32 x; bf16 x off the 16-byte
//   boundary or with K % 16 != 0): the same cluster split on the CUDA
//   cores.  A thread owns 16 adjacent columns and reads 16 bytes of a row
//   at a time, kGemvRows rows in flight; x is staged once per block,
//   transposed to [k][MT] fp32, by 16-byte loads where x allows them, while
//   the first rows are in flight; the warp's k-lanes reduce-scatter their
//   MT x 16 sums by shuffles, each warp writes its [MT][W] partial, the
//   block sums its warps in warp order, and after a cluster barrier each
//   rank sums its share of the outputs over the ranks in rank order,
//   reading them through distributed shared memory (a second barrier keeps
//   every block alive while others read it); an int8 weight becomes fp32
//   by a byte permute and an add (exact), not the quarter-rate integer
//   conversion.
// - bf16 x with M > 8 (prefill): tile_mma.cuh's weight-product core,
//   which kernels H and I run: a 3-stage cp.async ring of x tiles and the
//   raw int8 payload with its scales, dequantized in shared memory into a
//   swizzled bf16 tile (hi = bf16(q * s), the one rounding C makes),
//   ldmatrix, mma.sync m16n8k16 with fp32 sums, the bf16 output stored
//   through the staging tile in 8-byte vectors.  Its own tiles (WprodCfg's
//   row-group shapes, chosen by a sweep on the H100): k-steps of 64, and
//   64 x 128 outputs (3 stages) where those blocks fill the card twice,
//   else 64 x 64 (4 stages); kernel I's 64 x 128 x 32 tile gives N = 768
//   only 96 blocks and K = 3072 96 k-steps in one block.  C's scale is one
//   per group of K / groups rows: the core's row-group modes stage
//   scale[k / rpg] per window row, with no per-call expansion of the
//   scales.  Needs x 16-byte aligned (the Python
//   wrapper copies one that is not, and counts it) and K % 8 == 0.
// - dq_tiled_kernel, everything else (fp32 x at M > 8, odd shapes): the
//   plain tiled GEMM on the CUDA cores, one block per 64 x 64 output
//   tile, fp32 FMA, all edges masked.

#include <cooperative_groups.h>

#include <algorithm>

#include "tile_mma.cuh"

namespace cg = cooperative_groups;

namespace {

// --------------------------------------------------------------------- //
// decode: M <= 8
// --------------------------------------------------------------------- //
constexpr int kGemvMaxM = 8;
constexpr int kGemvRows = 8;         // rows of 16 bytes a thread has in flight
constexpr int kGemvMaxThreads = 256;
constexpr int kGemvMaxSplit = 8;     // K slices per column block: a portable cluster
constexpr int kGemvSMs = 132;        // an H100 SXM
constexpr int kGemvXFloats = 4096;   // x staged per block: 16 KB

struct GemvPlan {
  int width;    // output columns per block: 32, 64 or 128
  int split;    // K slices per column block (the cluster)
  int rows;     // rows of K per slice, a multiple of 8
  int threads;  // (width / 16) column groups x KL k-lanes
};

// The widest column block whose blocks, with at most kGemvMaxSplit K
// slices, reach one per SM; the slices at least kGemvRows rows deep; as
// many k-lanes as give each thread one batch of rows, at most
// kGemvMaxThreads threads, a whole number of warps.
GemvPlan gemv_plan(int K, int N) {
  GemvPlan p{};
  for (p.width = 128;; p.width /= 2) {
    const int col_blocks = (N + p.width - 1) / p.width;
    p.split = std::min(kGemvMaxSplit, (kGemvSMs + col_blocks - 1) / col_blocks);
    p.split = std::max(1, std::min(p.split, (K + kGemvRows - 1) / kGemvRows));
    if (col_blocks * p.split >= kGemvSMs || p.width == 32) break;
  }
  p.rows = ((K + p.split - 1) / p.split + 7) / 8 * 8;
  const int groups = p.width / 16;
  const int lanes_per_warp = 32 / groups;
  int kl = std::min((p.rows + kGemvRows - 1) / kGemvRows, kGemvMaxThreads / groups);
  kl = (kl + lanes_per_warp - 1) / lanes_per_warp * lanes_per_warp;
  p.threads = kl * groups;
  return p;
}

// Byte i of a word of int8 weights whose bytes were XORed with 0x80 (b +
// 128, unsigned), as an exact fp32: 0x4B0000uu is 2^23 + uu, so one byte
// permute and one add replace the slower integer conversion.
__device__ __forceinline__ float int8_value(uint32_t biased, int i) {
  return __int_as_float(static_cast<int>(__byte_perm(biased, 0x4B000000u, 0x7440 + i))) -
         8388736.f;
}

// Two dequantized weights rounded to T (for bf16 the one rounding C
// makes), back in fp32.
template <typename T>
__device__ __forceinline__ float2 round_pair(float a, float b);
template <>
__device__ __forceinline__ float2 round_pair<float>(float a, float b) {
  return make_float2(a, b);
}
template <>
__device__ __forceinline__ float2 round_pair<__nv_bfloat16>(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

// v[0, L) of every lane: the k-lanes that differ in bit OFF (and above)
// swap halves and add, so that after the last step (OFF = 16) each lane
// holds the warp's sum of the L >> steps values from flat index `base` on.
template <int L, int OFF>
__device__ __forceinline__ void reduce_scatter(float* v, int lane, int& base) {
  if constexpr (OFF < 32) {
    constexpr int kHalf = L / 2;
    const bool upper = (lane & OFF) != 0;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const float send = upper ? v[i] : v[kHalf + i];
      const float keep = upper ? v[kHalf + i] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    if (upper) base += kHalf;
    reduce_scatter<kHalf, OFF * 2>(v, lane, base);
  }
}

// MT: M rounded up to 1, 2, 4 or 8; CG: column groups of 16 per block.
template <typename T, int MT, int CG>
__global__ void __launch_bounds__(kGemvMaxThreads)
dq_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ qw,
               const float* __restrict__ scale, T* __restrict__ out, int M, int K, int N,
               int rows_per_group, int rows_per_slice, int xvec) {
  constexpr int W = CG * 16;
  constexpr int NV = MT * 16;  // a thread's sums: MT rows x 16 columns
  constexpr int kChunk = kGemvXFloats / MT;  // rows of x staged at once
  extern __shared__ float smem[];
  float* xs = smem;                  // [kChunk][MT]
  float* part = smem + kGemvXFloats; // [warps][MT][W]
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());  // == gridDim.y
  const int rank = static_cast<int>(cluster.block_rank());   // == blockIdx.y

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lanes = blockDim.x / CG;  // KL
  const int grp = tid % CG, kl = tid / CG;
  const int n = blockIdx.x * W + grp * 16;
  const bool active = n < N;  // N % 16 == 0: all 16 in or out
  const int kbeg = min(K, rank * rows_per_slice), kend = min(K, kbeg + rows_per_slice);

  float acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = 0.f;

  uint4 w[kGemvRows];
  float s[kGemvRows];
  // the batch of rows r0, r0 + KL, ... (below `end`) into w and s
  auto fetch = [&](int r0, int end) {
    int g = r0 / rows_per_group, bound = (g + 1) * rows_per_group;
#pragma unroll
    for (int u = 0; u < kGemvRows; ++u) {
      const int r = r0 + u * lanes;
      const bool ok = active && r < end;
      w[u] = ok ? __ldg(reinterpret_cast<const uint4*>(qw + static_cast<size_t>(r) * N + n))
                : make_uint4(0u, 0u, 0u, 0u);
      while (r >= bound) {
        ++g;
        bound += rows_per_group;
      }
      s[u] = ok ? __ldg(scale + g) : 0.f;
    }
  };

  for (int k0 = kbeg; k0 < kend; k0 += kChunk) {
    const int kc = min(kChunk, kend - k0);
    int r0 = k0 + kl;
    fetch(r0, k0 + kc);  // in flight while x is staged
    if (k0 != kbeg) __syncthreads();  // the previous chunk of x is consumed
    if (xvec) {
      constexpr int E = 16 / sizeof(T);  // elements of a 16-byte vector
      const int nvec = kc / E;           // kc is a multiple of 8
      for (int idx = tid; idx < MT * nvec; idx += blockDim.x) {
        const int m = idx % MT, vv = idx / MT;
        float e[E];
        if (m < M) {
          const uint4 u =
              __ldg(reinterpret_cast<const uint4*>(x + static_cast<size_t>(m) * K + k0) + vv);
          const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
          for (int i = 0; i < E; ++i) e[i] = ds_to_float(t[i]);
        } else {
#pragma unroll
          for (int i = 0; i < E; ++i) e[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < E; ++i) xs[(vv * E + i) * MT + m] = e[i];
      }
    } else {
      for (int idx = tid; idx < MT * kc; idx += blockDim.x) {
        const int m = idx / kc, kk = idx % kc;
        xs[kk * MT + m] = m < M ? ds_to_float(x[static_cast<size_t>(m) * K + k0 + kk]) : 0.f;
      }
    }
    __syncthreads();
    while (true) {
#pragma unroll
      for (int u = 0; u < kGemvRows; ++u) {
        const int r = r0 + u * lanes;
        if (r >= k0 + kc) break;
        const uint32_t words[4] = {w[u].x ^ 0x80808080u, w[u].y ^ 0x80808080u,
                                   w[u].z ^ 0x80808080u, w[u].w ^ 0x80808080u};
        float wv[16];
#pragma unroll
        for (int c = 0; c < 16; c += 2) {
          const float a = int8_value(words[c / 4], c % 4);
          const float b = int8_value(words[c / 4], c % 4 + 1);
          const float2 rp = round_pair<T>(a * s[u], b * s[u]);
          wv[c] = rp.x;
          wv[c + 1] = rp.y;
        }
        const float* xr = xs + (r - k0) * MT;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = xr[m];
#pragma unroll
          for (int c = 0; c < 16; ++c) acc[m * 16 + c] = fmaf(xv, wv[c], acc[m * 16 + c]);
        }
      }
      r0 += kGemvRows * lanes;
      if (r0 >= k0 + kc) break;
      fetch(r0, k0 + kc);
    }
  }

  // the warp's k-lanes (lanes that differ in the bits from CG up) sum by
  // halves; then each warp's [MT][W] partial goes to shared memory
  int base = 0;
  reduce_scatter<NV, CG>(acc, lane, base);
  constexpr int kKept = NV * CG / 32;  // halved once per lane bit from CG to 16
#pragma unroll
  for (int i = 0; i < kKept; ++i) {
    const int f = base + i, m = f / 16, c = f % 16;
    part[(warp * MT + m) * W + grp * 16 + c] = acc[i];
  }
  // the block's sum over its warps, in warp order, into warp 0's slot;
  // each sum's loads are issued together
  constexpr int kMaxWarps = kGemvMaxThreads / 32;
  const int warps = blockDim.x / 32;
  __syncthreads();
  for (int idx = tid; idx < MT * W; idx += blockDim.x) {
    float v[kMaxWarps];
#pragma unroll
    for (int wp = 0; wp < kMaxWarps; ++wp) v[wp] = wp < warps ? part[wp * MT * W + idx] : 0.f;
    float sum = v[0];
#pragma unroll
    for (int wp = 1; wp < kMaxWarps; ++wp)
      if (wp < warps) sum += v[wp];
    part[idx] = sum;  // this thread alone reads and writes idx
  }
  // the cluster's sum over its K slices, in rank order, each rank's value
  // read through distributed shared memory, all issued together; each
  // block finishes its share of the outputs
  cluster.sync();
  const int share = (MT * W + split - 1) / split;
  for (int idx = rank * share + tid; idx < min(MT * W, (rank + 1) * share);
       idx += blockDim.x) {
    const int m = idx / W, col = idx % W, gn = blockIdx.x * W + col;
    if (m >= M || gn >= N) continue;
    float v[kGemvMaxSplit];
#pragma unroll
    for (int q = 0; q < kGemvMaxSplit; ++q)
      v[q] = q < split ? cluster.map_shared_rank(part, q)[idx] : 0.f;
    float sum = v[0];
#pragma unroll
    for (int q = 1; q < kGemvMaxSplit; ++q)
      if (q < split) sum += v[q];
    out[static_cast<size_t>(m) * N + gn] = ds_from_float<T>(sum);
  }
  cluster.sync();  // no block leaves while another still reads its part
}

// --------------------------------------------------------------------- //
// decode, bf16: the tensor cores, outT[N, M] = W^T x^T
// --------------------------------------------------------------------- //
constexpr int kGemvMmaCols = 64;      // output columns a block: 8 bytes a thread a row
constexpr int kGemvMmaMaxSplit = 16;  // a non-portable cluster
constexpr int kGemvMmaRows = 128;     // rows of K a block has in flight (8 k-steps of 16)
struct GemvMmaPlan {
  int split;  // K slices per column block (the cluster)
  int warps;  // a block's warps, which share its K slice
  int rows;   // rows of K per slice, a multiple of 16
};

// From a sweep on the H100: 64 columns a block; a K split that
// gives every SM a block and at most kGemvMmaRows rows a slice (at most
// 16, a non-portable cluster); 8 warps a block, 16 when a slice has more
// than 8 k-steps of 16.
GemvMmaPlan gemv_mma_plan(int K, int N) {
  GemvMmaPlan p{};
  const int col_blocks = (N + kGemvMmaCols - 1) / kGemvMmaCols;
  p.split = std::max((kGemvSMs + col_blocks - 1) / col_blocks,
                     (K + kGemvMmaRows - 1) / kGemvMmaRows);
  p.split = std::max(1, std::min({p.split, kGemvMmaMaxSplit, (K + 15) / 16}));
  p.rows = ((K + p.split - 1) / p.split + 15) / 16 * 16;
  p.warps = p.rows / 16 > 8 ? 16 : 8;
  return p;
}

// 8 bytes of the weight, which a launch reads once: not allocated in L1
// (measured faster than __ldg's L1 allocation on the H100).
__device__ __forceinline__ uint2 load_streaming(const int8_t* p) {
  uint2 v;
  asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "l"(p));
  return v;
}

// One mma.sync m16n8k16 computes 16 output columns x 8 rows of x over 16
// rows of K, with the weight as the A operand (rows = output columns) and
// x^T as B (columns = x's rows, M <= 8).  The fragment slots are assigned
// so that every operand comes straight from a thread's own loads: lane
// (g, t) = (lane / 4, lane % 4) loads rows k0 + 4t .. k0 + 4t + 3 of the
// weight at its 8 columns n0 + 8g .. (one 8-byte load a row) and x's row g
// at k0 + 4t .. + 3 (one 8-byte load); its A slots (k 2t, 2t+1, 2t+8,
// 2t+9) are those four rows and its A rows (g, g + 8) the columns
// n0 + 8g + 2j and + 2j + 1 of tile j; B's k slots follow the same rows,
// so the product is the true one.
template <int NW>
__global__ void __launch_bounds__(NW * 32)
dq_gemv_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ qw,
                   const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int M,
                   int K, int N, int rows_per_group, int rows_per_slice) {
  constexpr int kThreads = NW * 32;
  constexpr int kSteps = kGemvMmaRows / 16 / NW > 0 ? kGemvMmaRows / 16 / NW : 1;
  constexpr int W = kGemvMmaCols;
  constexpr int CB = W / 8;   // columns (bytes) of a thread's row load
  constexpr int NJ = CB / 2;  // mma tiles a k-step
  constexpr int kVals = NJ * 4 * 32;  // the block's sums: M <= 8 rows x W columns
  __shared__ __align__(16) float part[NW * kVals];
  // what the cluster's ranks push for this rank's outputs
  __shared__ __align__(16) float recv[kVals + 4 * kGemvMmaMaxSplit];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());  // == gridDim.y
  const int rank = static_cast<int>(cluster.block_rank());   // == blockIdx.y

  // a block writes into another's shared memory only once that block runs:
  // arrive now, wait before the first push (long after every block began)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n = blockIdx.x * W + g * CB;  // N % 16 == 0: all CB in or out
  const bool active = n < N;
  const int kbeg = min(K, rank * rows_per_slice), kend = min(K, kbeg + rows_per_slice);
  const __nv_bfloat16* xg = x + static_cast<size_t>(min(g, M - 1)) * K;

  float acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // the scale group of this thread's rows, which only increase
  int grp = (kbeg + warp * 16 + 4 * t) / rows_per_group;
  int bound = (grp + 1) * rows_per_group;
  for (int k0 = kbeg + warp * 16; k0 < kend; k0 += NW * 16 * kSteps) {
    uint2 w[kSteps][4];  // 8 weights a row
    uint2 xb[kSteps];
    float sc[kSteps][4];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int r0 = k0 + s * NW * 16 + 4 * t;
      const bool step = r0 < kend;  // kend - kbeg and K are multiples of 16
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        w[s][u] = active && step ? load_streaming(qw + static_cast<size_t>(r0 + u) * N + n)
                                 : make_uint2(0u, 0u);
        while (r0 + u >= bound) {
          ++grp;
          bound += rows_per_group;
        }
        sc[s][u] = step ? __ldg(scale + grp) : 0.f;
      }
      xb[s] = step && g < M ? __ldg(reinterpret_cast<const uint2*>(xg + r0)) : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        // columns 2j and 2j + 1 of the thread's CB, rows u = 0..3
        float v[4][2];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = 2 * j + c;
            v[u][c] = int8_value((col < 4 ? w[s][u].x : w[s][u].y) ^ 0x80808080u, col % 4) *
                      sc[s][u];
          }
        const uint32_t a[4] = {ds_mma::pack_bf16(v[0][0], v[1][0]),
                               ds_mma::pack_bf16(v[0][1], v[1][1]),
                               ds_mma::pack_bf16(v[2][0], v[3][0]),
                               ds_mma::pack_bf16(v[2][1], v[3][1])};
        ds_mma::mma_16816(acc[j], a, xb[s].x, xb[s].y);
      }
    }
  }

  // The block's sum over its warps in warp order, then the cluster's over
  // its K slices in rank order.  Value i = 4 (32 j + lane) + e is acc[j][e]
  // of that lane; each group of four has an owner rank, into whose shared
  // memory the block pushes it (one 16-byte distributed-shared-memory
  // store); after one cluster barrier each rank sums its own outputs over
  // the ranks from its own shared memory.
  const int share = ((kVals + split - 1) / split + 3) / 4 * 4;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    *reinterpret_cast<float4*>(part + warp * kVals + 4 * (32 * j + lane)) =
        make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int grp4 = tid; grp4 < kVals / 4; grp4 += kThreads) {
    const int i = 4 * grp4;
    float4 v = *reinterpret_cast<const float4*>(part + i);
#pragma unroll
    for (int wp = 1; wp < NW; ++wp) {
      const float4 o = *reinterpret_cast<const float4*>(part + wp * kVals + i);
      v = make_float4(v.x + o.x, v.y + o.y, v.z + o.z, v.w + o.w);
    }
    const int owner = i / share;
    *reinterpret_cast<float4*>(cluster.map_shared_rank(recv, owner) + rank * share +
                               (i - owner * share)) = v;
  }
  cluster.sync();
  for (int off = tid; off < share; off += kThreads) {
    const int i = rank * share + off;
    if (i >= kVals) break;
    const int e = i & 3, ln = (i >> 2) & 31, j = i >> 7;
    const int m = 2 * (ln & 3) + (e & 1);
    const int col = blockIdx.x * W + (ln >> 2) * CB + 2 * j + (e >> 1);
    if (m >= M || col >= N) continue;
    float v[kGemvMmaMaxSplit];
#pragma unroll
    for (int q = 0; q < kGemvMmaMaxSplit; ++q) v[q] = q < split ? recv[q * share + off] : 0.f;
    float sum = v[0];
#pragma unroll
    for (int q = 1; q < kGemvMmaMaxSplit; ++q)
      if (q < split) sum += v[q];
    out[static_cast<size_t>(m) * N + col] = __float2bfloat16(sum);
  }
}

// --------------------------------------------------------------------- //
// everything else: fp32 FMA tiles
// --------------------------------------------------------------------- //
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
dq_tiled_kernel(const T* __restrict__ x, const int8_t* __restrict__ qw,
                const float* __restrict__ scale, T* __restrict__ out, int M,
                int K, int N, int rows_per_group) {
  constexpr int TM = kBM / 16;  // output rows per thread: 4
  constexpr int TN = kBN / 16;  // output columns per thread: 4
  __shared__ float xs[kBK][kBM + 1];
  __shared__ float ws[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int idx = tid; idx < kBM * kBK; idx += kThreads) {
      const int mm = idx / kBK, kk = idx % kBK;
      const int gm = m0 + mm, gk = k0 + kk;
      xs[kk][mm] = (gm < M && gk < K)
                       ? ds_to_float(x[static_cast<size_t>(gm) * K + gk])
                       : 0.f;
    }
    for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
      const int kk = idx / kBN, nn = idx % kBN;
      const int gk = k0 + kk, gn = n0 + nn;
      float w = 0.f;
      if (gk < K && gn < N) {
        const float deq = static_cast<float>(qw[static_cast<size_t>(gk) * N + gn]) *
                          scale[gk / rows_per_group];
        w = ds_to_float(ds_from_float<T>(deq));
      }
      ws[kk][nn] = w;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], bw[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int c = 0; c < TN; ++c) bw[c] = ws[kk][tx + 16 * c];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[i][c] = fmaf(a[i], bw[c], acc[i][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int gn = n0 + tx + 16 * c;
      if (gn < N) out[static_cast<size_t>(gm) * N + gn] = ds_from_float<T>(acc[i][c]);
    }
  }
}

// --------------------------------------------------------------------- //
// launchers
// --------------------------------------------------------------------- //
template <typename T, int MT, int CG>
int launch_gemv_cfg(const void* x, const void* qw, const void* scale, void* out, int M, int K,
                    int N, int rows_per_group, const GemvPlan& p, cudaStream_t stream) {
  const int xvec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && (K * sizeof(T)) % 16 == 0;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.split;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + p.width - 1) / p.width, p.split);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = (kGemvXFloats + p.threads / 32 * MT * p.width) * sizeof(float);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, dq_gemv_kernel<T, MT, CG>, static_cast<const T*>(x), static_cast<const int8_t*>(qw),
      static_cast<const float*>(scale), static_cast<T*>(out), M, K, N, rows_per_group, p.rows,
      xvec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MT>
int launch_gemv_m(const void* x, const void* qw, const void* scale, void* out, int M, int K,
                  int N, int rpg, const GemvPlan& p, cudaStream_t stream) {
  switch (p.width) {
    case 128:
      return launch_gemv_cfg<T, MT, 8>(x, qw, scale, out, M, K, N, rpg, p, stream);
    case 64:
      return launch_gemv_cfg<T, MT, 4>(x, qw, scale, out, M, K, N, rpg, p, stream);
    default:
      return launch_gemv_cfg<T, MT, 2>(x, qw, scale, out, M, K, N, rpg, p, stream);
  }
}

template <typename T>
int launch_gemv(const void* x, const void* qw, const void* scale, void* out, int M, int K,
                int N, int rpg, cudaStream_t stream) {
  const GemvPlan p = gemv_plan(K, N);
  if (M <= 1) return launch_gemv_m<T, 1>(x, qw, scale, out, M, K, N, rpg, p, stream);
  if (M <= 2) return launch_gemv_m<T, 2>(x, qw, scale, out, M, K, N, rpg, p, stream);
  if (M <= 4) return launch_gemv_m<T, 4>(x, qw, scale, out, M, K, N, rpg, p, stream);
  return launch_gemv_m<T, 8>(x, qw, scale, out, M, K, N, rpg, p, stream);
}

template <int NW>
int launch_gemv_mma_cfg(const void* x, const void* qw, const void* scale, void* out, int M,
                        int K, int N, int rpg, const GemvMmaPlan& p, cudaStream_t stream) {
  if (p.split > 8) {  // a non-portable cluster: allowed once per device
    static unsigned allowed = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!(allowed >> dev & 1u)) {
      err = cudaFuncSetAttribute(dq_gemv_mma_kernel<NW>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return static_cast<int>(err);
      allowed |= 1u << dev;
    }
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.split;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kGemvMmaCols - 1) / kGemvMmaCols, p.split);
  cfg.blockDim = dim3(NW * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, dq_gemv_mma_kernel<NW>, static_cast<const __nv_bfloat16*>(x),
      static_cast<const int8_t*>(qw), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), M, K, N, rpg, p.rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int launch_gemv_mma(const void* x, const void* qw, const void* scale, void* out, int M, int K,
                    int N, int rpg, cudaStream_t stream) {
  const GemvMmaPlan p = gemv_mma_plan(K, N);
  if (p.warps == 8) return launch_gemv_mma_cfg<8>(x, qw, scale, out, M, K, N, rpg, p, stream);
  return launch_gemv_mma_cfg<16>(x, qw, scale, out, M, K, N, rpg, p, stream);
}

int launch_prefill(const void* x, const void* qw, const void* scale, void* out, int M, int K,
                   int N, int rpg, cudaStream_t stream) {
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  const ds_tmma::TileStore st{nullptr, out, N, DS_DTYPE_BF16, vec};
  return ds_tmma::launch_row_group_product(x, qw, static_cast<const float*>(scale), rpg, st, M,
                                           K, N, stream);
}

template <typename T>
int launch_tiled(const void* x, const void* qw, const void* scale, void* out,
                 int M, int K, int N, int rows_per_group, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  dq_tiled_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(qw),
      static_cast<const float*>(scale), static_cast<T*>(out), M, K, N,
      rows_per_group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Which kernel the launcher takes for this shape and dtype: 0 the CUDA-core
// GEMV, 1 the tensor-core prefill product, 2 tiled, 3 the tensor-core GEMV.
// chip_smoke.py reports it beside each parity case.
extern "C" int ds_dequant_matmul_route(const void* x, const void* qweight,
                                       int M, int K, int N, int dtype) {
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t qa = reinterpret_cast<uintptr_t>(qweight);
  const bool bf16 = dtype == DS_DTYPE_BF16;
  if (M <= kGemvMaxM && N % 16 == 0 && qa % 16 == 0)
    return bf16 && K % 16 == 0 && xa % 16 == 0 ? 3 : 0;
  if (bf16 && K % 8 == 0 && xa % 16 == 0) return 1;
  return 2;
}

// The launcher's whole plan, into plan[5]: route; for the gemv its column
// block width, K split (cluster size) and threads a block (0 otherwise);
// and the blocks the launch runs.  ops/quant.py dequant_plan mirrors it.
extern "C" int ds_dequant_matmul_plan(const void* x, const void* qweight, int M, int K, int N,
                                      int dtype, int* plan) {
  const int route = ds_dequant_matmul_route(x, qweight, M, K, N, dtype);
  plan[0] = route;
  plan[1] = plan[2] = plan[3] = 0;
  if (route == 0) {
    const GemvPlan p = gemv_plan(K, N);
    plan[1] = p.width;
    plan[2] = p.split;
    plan[3] = p.threads;
    plan[4] = (N + p.width - 1) / p.width * p.split;
  } else if (route == 3) {
    const GemvMmaPlan p = gemv_mma_plan(K, N);
    plan[1] = kGemvMmaCols;
    plan[2] = p.split;
    plan[3] = p.warps * 32;
    plan[4] = (N + kGemvMmaCols - 1) / kGemvMmaCols * p.split;
  } else if (route == 1) {
    const int bn = ds_tmma::row_groups_wide(M, N)
                       ? ds_tmma::WprodCfg<false, ds_tmma::kInt8RowGroupsWide>::BN
                       : ds_tmma::WprodCfg<false, ds_tmma::kInt8RowGroups>::BN;
    plan[1] = bn;
    plan[4] = (N + bn - 1) / bn * ((M + 63) / 64);
  } else {
    plan[4] = (N + kBN - 1) / kBN * ((M + kBM - 1) / kBM);
  }
  return 0;
}

extern "C" int ds_dequant_matmul(const void* x, const void* qweight,
                                 const void* scale, void* out, int M, int K,
                                 int N, int groups, int dtype, void* stream) {
  if (groups <= 0 || K % groups != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != DS_DTYPE_BF16 && dtype != DS_DTYPE_FP32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rpg = K / groups;
  const bool bf16 = dtype == DS_DTYPE_BF16;
  switch (ds_dequant_matmul_route(x, qweight, M, K, N, dtype)) {
    case 0:
      return bf16 ? launch_gemv<__nv_bfloat16>(x, qweight, scale, out, M, K, N, rpg, s)
                  : launch_gemv<float>(x, qweight, scale, out, M, K, N, rpg, s);
    case 1:
      return launch_prefill(x, qweight, scale, out, M, K, N, rpg, s);
    case 3:
      return launch_gemv_mma(x, qweight, scale, out, M, K, N, rpg, s);
    default:
      return bf16 ? launch_tiled<__nv_bfloat16>(x, qweight, scale, out, M, K, N, rpg, s)
                  : launch_tiled<float>(x, qweight, scale, out, M, K, N, rpg, s);
  }
}
