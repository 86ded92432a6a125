// Tensor-core core of the fused collective-matmul kernels I and J for bf16
// left operands (fcm_ag_matmul.cu, fcm_matmul_rs.cu); fp32 operands keep
// tile_matmul.cuh's CUDA-core core, since a tensor-core fp32 product would
// be TF32.  Built from attention_mma.cuh's pieces: `cp.async` copies into
// XOR-swizzled bf16 tiles, `ldmatrix` / `ldmatrix.trans`, and `mma.sync`
// m16n8k16 bf16 -> fp32.  Four warps per block (2 x 2), each a 32-row
// slice of the block's output tile.
//
// - The left operand (x, g, or J's a read transposed) is a bf16 matrix
//   with a row pitch, copied tile by tile through a ring of kStages
//   `cp.async` stages.  Its base and pitch must be multiples of 16 bytes
//   (the Python wrappers copy an operand that is not, and count the
//   copy); a ragged edge, rows or columns, is zero-filled by the copy's
//   source size, so nothing past it reaches a product.
// - The weight payload of kernel I is staged as it lies in device memory
//   (int8 [rows, cols], int4 packed two per byte low nibble first, or
//   native bf16 / fp32), with its fp32 block scales, in the same ring, and
//   dequantized in shared memory once the stage has landed: w = q * s in
//   fp32, as the TPU kernel does, then split into two bf16 halves,
//   hi = bf16(w) and lo = bf16(w - hi).  The block multiplies x . hi and
//   x . lo into the same fp32 sums, which keeps w to ~2^-17 of itself:
//   bf16 x bf16 products are exact in fp32, so the kernel computes the
//   TPU kernel's function up to the order of the sums.  A native bf16
//   tile is exact as it is and takes hi alone.  A payload whose base or
//   row is not a multiple of 16 bytes is staged by plain loads instead.
// - Kernel C's int8 weight (dequant_matmul.cu, prefill) is staged the
//   same way in its own mode, kInt8RowGroups: one fp32 scale per group of
//   `rpg` consecutive rows, scale[r / rpg], staged per window row; it runs
//   hi-only (kSplit false), as C rounds w = q * s to x's dtype once.
// - A block's sums leave through an fp32 staging tile in shared memory,
//   four columns per thread and step, so that reads and writes of device
//   memory are 16-byte vectors where the shapes allow.
#pragma once

#include "attention_mma.cuh"
#include "tile_matmul.cuh"

namespace ds_tmma {

using bf16 = __nv_bfloat16;
using ds_mma::smem_u32;
constexpr int kThreads = 128;  // four warps
constexpr int kStages = 3;     // cp.async ring depth
// int8 [rows, cols] with one fp32 scale per group of rpg rows (kernel C),
// beside ds_tile::WeightMode's kNative, kInt8, kInt4; the two modes differ
// only in their tile (WprodCfg): 64 x 64 outputs for narrow N, 64 x 128
// for wide
constexpr int kInt8RowGroups = 3;
constexpr int kInt8RowGroupsWide = 4;
__host__ __device__ constexpr bool row_groups(int mode) {
  return mode == kInt8RowGroups || mode == kInt8RowGroupsWide;
}

// 16 bytes from global to shared of which the first `bytes` (0..16) are
// read and the rest zero-filled; src must be a valid address even when
// bytes is 0.
__device__ __forceinline__ void cp_async_bytes(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

// Rows [r0, r0 + ROWS) x columns [c0, c0 + COLS) of a bf16 matrix with
// pitch `ld` into a swizzled [ROWS][COLS] tile; rows at or past R and
// columns at or past C are zero.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_bf16_tile(uint32_t tile, const bf16* p, int64_t ld, int r0,
                                               int R, int c0, int C, int tid) {
  constexpr int kChunks = COLS / 8;
  static_assert((ROWS * kChunks) % kThreads == 0, "whole rounds of copies");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / kChunks, c = idx % kChunks;
    const int gr = r0 + r, gc = c0 + c * 8;
    const int bytes = gr < R && gc < C ? min(8, C - gc) * 2 : 0;
    const bf16* src = bytes ? p + static_cast<int64_t>(gr) * ld + gc : p;
    cp_async_bytes(tile + ds_mma::tile_offset<COLS>(r, c * 8), src, bytes);
  }
}

// A ring payload as kernel I reads it: [rows, cols] row-major in layout
// Mode (ds_tile::WeightMode; TN the native element type), fp32 block
// scales [rows, nb] of bs columns each.
template <int Mode, typename TN>
struct Payload {
  static constexpr int kBits = Mode == ds_tile::kInt4                            ? 4
                               : Mode == ds_tile::kInt8 || row_groups(Mode)      ? 8
                                                                                  : 8 * sizeof(TN);
  const unsigned char* w;
  const float* scale;
  int rows, cols, bs, nb;
  int64_t row_bytes;
  int vec;  // base and row bytes are multiples of 16: cp.async copies
  int rpg;  // kInt8RowGroups: rows per scale group
};

// Stage the window rows [r0, r0 + ROWS) x columns [c0, c0 + COLS) of the
// payload into `raw` ([ROWS][COLS * kBits / 8] bytes) and its scales into
// `sc` ([ROWS][nsc], the nsc blocks from c0 / bs on; kInt8RowGroups: nsc is
// 1, the row's group scale); everything at or past row R or column C (and
// past the scale table) is zero.
template <int ROWS, int COLS, int Mode, typename TN>
__device__ __forceinline__ void load_payload(unsigned char* raw, float* sc, int nsc,
                                             const Payload<Mode, TN>& w, int r0, int R, int c0,
                                             int C, int tid) {
  constexpr int RB = COLS * Payload<Mode, TN>::kBits / 8;
  const int64_t cb0 = static_cast<int64_t>(c0) * Payload<Mode, TN>::kBits / 8;
  const int64_t cb_end = static_cast<int64_t>(C) * Payload<Mode, TN>::kBits / 8;
  if (w.vec) {
    constexpr int kChunks = RB / 16;
    static_assert((ROWS * kChunks) % kThreads == 0, "whole rounds of copies");
#pragma unroll
    for (int i = 0; i < ROWS * kChunks / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kChunks, c = idx % kChunks;
      const int gr = r0 + r;
      const int64_t gb = cb0 + c * 16;
      const int64_t left = gr < R ? cb_end - gb : 0;
      const int bytes = left > 0 ? static_cast<int>(left < 16 ? left : 16) : 0;
      const unsigned char* src = bytes ? w.w + gr * w.row_bytes + gb : w.w;
      cp_async_bytes(smem_u32(raw + r * RB + c * 16), src, bytes);
    }
  } else {
    for (int idx = tid; idx < ROWS * RB; idx += kThreads) {
      const int r = idx / RB, b = idx % RB;
      const int gr = r0 + r;
      const int64_t gb = cb0 + b;
      raw[idx] = gr < R && gb < cb_end ? w.w[gr * w.row_bytes + gb] : 0;
    }
  }
  if (row_groups(Mode)) {
    for (int r = tid; r < ROWS; r += kThreads) {
      const int gr = r0 + r;
      ds_mma::cp_async_4(smem_u32(sc + r), w.scale + (gr < R ? gr / w.rpg : 0), gr < R);
    }
  } else if (Mode != ds_tile::kNative) {
    const int b0 = c0 / w.bs;
    for (int idx = tid; idx < ROWS * nsc; idx += kThreads) {
      const int r = idx / nsc, j = idx % nsc;
      const int gr = r0 + r, gb = b0 + j;
      const bool ok = gr < R && gb < w.nb;
      const int64_t at = ok ? static_cast<int64_t>(gr) * w.nb + gb : 0;
      ds_mma::cp_async_4(smem_u32(sc + idx), w.scale + at, ok);
    }
  }
}

// The staged window as bf16 tiles [ROWS][COLS] (swizzled): hi = bf16(w)
// and, when kSplit, lo = bf16(w - hi), w = q * scale in fp32 (or the
// native value).  c0 is the window's first column, for the scale blocks.
template <int ROWS, int COLS, int Mode, typename TN, bool kSplit>
__device__ __forceinline__ void dequant_window(unsigned char* hi, unsigned char* lo,
                                               const unsigned char* raw, const float* sc, int nsc,
                                               int c0, int bs, int tid) {
  constexpr int kBits = Payload<Mode, TN>::kBits;
  constexpr int RB = COLS * kBits / 8;
  constexpr int kChunks = COLS / 8;
  static_assert((ROWS * kChunks) % kThreads == 0, "whole rounds of chunks");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / kChunks, c = idx % kChunks;
    const unsigned char* src = raw + r * RB + c * kBits;  // 8 elements: kBits bytes
    float w[8];
    if (Mode == ds_tile::kInt8 || row_groups(Mode)) {
      const uint2 u = *reinterpret_cast<const uint2*>(src);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t word = j < 4 ? u.x : u.y;
        w[j] = static_cast<float>(static_cast<int8_t>((word >> (8 * (j & 3))) & 0xFF));
      }
    } else if (Mode == ds_tile::kInt4) {
      const uint32_t u = *reinterpret_cast<const uint32_t*>(src);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int nib = static_cast<int>((u >> (4 * j)) & 0xF);
        w[j] = static_cast<float>((nib ^ 8) - 8);
      }
    } else if (sizeof(TN) == 2) {
      const uint4 u = *reinterpret_cast<const uint4*>(src);
      const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j] = __bfloat162float(e[j]);
    } else {
      const float4 u0 = *reinterpret_cast<const float4*>(src);
      const float4 u1 = *reinterpret_cast<const float4*>(src + 16);
      w[0] = u0.x, w[1] = u0.y, w[2] = u0.z, w[3] = u0.w;
      w[4] = u1.x, w[5] = u1.y, w[6] = u1.z, w[7] = u1.w;
    }
    if (row_groups(Mode)) {
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j] = __fmul_rn(w[j], sc[r]);
    } else if (Mode != ds_tile::kNative) {
      const int col = c0 + c * 8;
      int blk = col / bs - c0 / bs, rem = col % bs;
      const float* srow = sc + r * nsc;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        w[j] = __fmul_rn(w[j], srow[blk]);
        if (++rem == bs) rem = 0, ++blk;
      }
    }
    uint32_t h[4], l[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const __nv_bfloat162 hv = __floats2bfloat162_rn(w[2 * p], w[2 * p + 1]);
      h[p] = *reinterpret_cast<const uint32_t*>(&hv);
      if (kSplit) {
        const float2 hf = __bfloat1622float2(hv);
        l[p] = ds_mma::pack_bf16(__fsub_rn(w[2 * p], hf.x), __fsub_rn(w[2 * p + 1], hf.y));
      }
    }
    const uint32_t off = ds_mma::tile_offset<COLS>(r, c * 8);
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    if (kSplit) *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// One k-step of 16 for a warp's FM x FN fragments: acc += A . B (and
// + A . B_lo when kSplit).  A lies in its tile as [m][k] (kAT false, a
// tile of ACOLS = the block's k columns) or [k][m] (kAT true, ACOLS = the
// block's m columns); B as [k][n] (kBT false, BCOLS = n columns) or
// [n][k] (kBT true, BCOLS = k columns).
template <int FM, int FN, bool kAT, int ACOLS, bool kBT, int BCOLS, bool kSplit>
__device__ __forceinline__ void warp_mma(float (&acc)[FM][FN][4], uint32_t a_tile, int am0,
                                         uint32_t b_hi, uint32_t b_lo, int bn0, int k0,
                                         int lane) {
  uint32_t a[FM][4];
#pragma unroll
  for (int i = 0; i < FM; ++i) {
    if (kAT)
      ds_mma::ldsm_x4_trans(a[i], ds_mma::frag_addr_nt<ACOLS>(a_tile, k0, am0 + 16 * i, lane));
    else
      ds_mma::ldsm_x4(a[i], ds_mma::frag_addr<ACOLS>(a_tile, am0 + 16 * i, k0, lane));
  }
#pragma unroll
  for (int half = 0; half < (kSplit ? 2 : 1); ++half) {
    const uint32_t b_tile = half ? b_lo : b_hi;
#pragma unroll
    for (int jp = 0; jp < FN / 2; ++jp) {
      uint32_t b[4];
      if (kBT)
        ds_mma::ldsm_x4(b, ds_mma::frag_addr_nt<BCOLS>(b_tile, bn0 + 16 * jp, k0, lane));
      else
        ds_mma::ldsm_x4_trans(b, ds_mma::frag_addr<BCOLS>(b_tile, k0, bn0 + 16 * jp, lane));
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        ds_mma::mma_16816(acc[i][2 * jp], a[i], b[0], b[1]);
        ds_mma::mma_16816(acc[i][2 * jp + 1], a[i], b[2], b[3]);
      }
    }
  }
}

// The warp's fragments into the block's fp32 staging tile (row pitch LDS
// floats), at rows wm0.. and columns wn0...
template <int FM, int FN, int LDS>
__device__ __forceinline__ void acc_to_smem(float* st, const float (&acc)[FM][FN][4], int wm0,
                                            int wn0, int lane) {
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      const int r = wm0 + 16 * i + (lane >> 2), c = wn0 + 8 * j + 2 * (lane & 3);
      *reinterpret_cast<float2*>(st + r * LDS + c) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(st + (r + 8) * LDS + c) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
}

// Where a block's sums go: out[m, n] = (acc_in[m, n] +) sum, in out_dtype,
// row pitch ldo (acc_in has the same pitch).  vec: out, acc_in and the
// pitch allow 16-byte vectors (fp32) or 8-byte ones (bf16).
struct TileStore {
  const float* acc_in;
  void* out;
  int64_t ldo;
  int out_dtype;
  int vec;
};

__device__ __forceinline__ void store_one(const TileStore& s, int64_t o, float v) {
  if (s.acc_in != nullptr) v = __fadd_rn(s.acc_in[o], v);
  if (s.out_dtype == DS_DTYPE_BF16)
    static_cast<bf16*>(s.out)[o] = __float2bfloat16(v);
  else
    static_cast<float*>(s.out)[o] = v;
}

// The block's staged sums to device memory, four columns per thread and
// step.  The accumulator reads of kBatch steps are issued before their
// writes (out may be acc_in itself: each element is read and written by
// the same thread), so that they are in flight together.
template <int BM, int BN, int LDS>
__device__ __forceinline__ void store_tile(const float* st, const TileStore& s, int m0, int n0,
                                           int M, int N, int tid) {
  constexpr int kSteps = BM * BN / (kThreads * 4);
  constexpr int kBatch = 4;
  static_assert(kSteps % kBatch == 0, "whole batches");
#pragma unroll
  for (int i0 = 0; i0 < kSteps; i0 += kBatch) {
    float4 a[kBatch];
    bool fast[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int idx = (tid + (i0 + j) * kThreads) * 4;
      const int r = idx / BN, c = idx % BN;
      const int gm = m0 + r, gn = n0 + c;
      fast[j] = s.vec && gm < M && gn + 3 < N;
      a[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (fast[j] && s.acc_in != nullptr)
        a[j] = *reinterpret_cast<const float4*>(s.acc_in + static_cast<int64_t>(gm) * s.ldo + gn);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int idx = (tid + (i0 + j) * kThreads) * 4;
      const int r = idx / BN, c = idx % BN;
      const int gm = m0 + r, gn = n0 + c;
      if (gm >= M) continue;
      float4 v = *reinterpret_cast<const float4*>(st + r * LDS + c);
      const int64_t o = static_cast<int64_t>(gm) * s.ldo + gn;
      if (fast[j]) {
        if (s.acc_in != nullptr)
          v = make_float4(__fadd_rn(a[j].x, v.x), __fadd_rn(a[j].y, v.y), __fadd_rn(a[j].z, v.z),
                          __fadd_rn(a[j].w, v.w));
        if (s.out_dtype == DS_DTYPE_BF16) {
          *reinterpret_cast<uint2*>(static_cast<bf16*>(s.out) + o) =
              make_uint2(ds_mma::pack_bf16(v.x, v.y), ds_mma::pack_bf16(v.z, v.w));
        } else {
          *reinterpret_cast<float4*>(static_cast<float*>(s.out) + o) = v;
        }
      } else {
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (gn + k < N) store_one(s, o + k, e[k]);
      }
    }
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The split of K into `splits` parts, each a whole number of BK-deep
// steps: the depth of one part, and how many parts that makes.
inline int split_depth(int K, int splits, int bk) {
  const int per = (K + splits - 1) / splits;
  return (per + bk - 1) / bk * bk;
}

// ------------------------------------------------------------------ //
// kernel I: x [M, K] @ deq(w) (or its transpose) on the tensor cores
// ------------------------------------------------------------------ //
// Tile shapes.  Forward: 64 x 128 outputs, k-steps of 32, the payload
// window 32 rows of w x 128 columns.  Transposed: 64 x 64 outputs (dx's
// column block is only kc wide), k-steps of 64 along w's columns, the
// window 64 rows of w x 64 columns; K (= n) may be split across blocks.
// Kernel C's forward (K = 768 or 3072 in one block): k-steps of 64; for N
// = 768 (kInt8RowGroups) 64 x 64 outputs, so that M = 1024 still gives 192
// blocks, and a ring of 4 stages, as one block walks the whole K; for wide
// N (kInt8RowGroupsWide) 64 x 128 outputs and 3 stages.  A sweep on the
// H100 chose them: kernel I's 64 x 128 x 32 tile gives N = 768 only 96
// blocks and K = 3072 96 k-steps in one block.
template <bool kTrans, int Mode = ds_tile::kNative>
struct WprodCfg {
  static constexpr bool kC = row_groups(Mode);
  static constexpr int BM = 64;
  static constexpr int BN = kTrans || Mode == kInt8RowGroups ? 64 : 128;
  static constexpr int BK = kTrans || kC ? 64 : 32;
  static constexpr int kRing = Mode == kInt8RowGroups ? 4 : kStages;  // cp.async stages
  static constexpr int WROWS = kTrans ? BN : BK;  // the payload window
  static constexpr int WCOLS = kTrans ? BK : BN;
  static constexpr int FM = 2, FN = BN / 2 / 8;   // warps 2 x 2
  static constexpr int LDS = BN + 4;              // staging tile pitch, floats
};

struct WprodArgs {
  const bf16* x;
  int64_t ldx;
  const void* w;
  const float* scale;
  int wrows, wcols, bs, nb, nsc, wvec;
  int M, N, K, kdepth;  // kdepth: K per split (blockIdx.z)
  int rpg;              // kInt8RowGroups: rows of w per scale
  TileStore store;      // splits == 1
  float* work;          // [splits, M, N] partials, or null
};

template <int Mode, typename TN, bool kSplit, bool kTrans>
struct WprodSmem {
  using C = WprodCfg<kTrans, Mode>;
  static constexpr int kA = C::BM * C::BK * 2;
  static constexpr int kRaw = C::WROWS * C::WCOLS * Payload<Mode, TN>::kBits / 8;
  static constexpr int kHalf = C::WROWS * C::WCOLS * 2;
  static constexpr int kStaging = C::BM * C::LDS * 4;
  // a stage's scales, rounded up so that the tiles after them stay aligned
  __host__ __device__ static int scale_bytes(int nsc) {
    return Mode == ds_tile::kNative ? 0 : (C::WROWS * nsc * 4 + 127) / 128 * 128;
  }
  static int bytes(int nsc) {
    const int loop = C::kRing * (kA + kRaw + scale_bytes(nsc)) + (kSplit ? 2 : 1) * kHalf;
    return loop > kStaging ? loop : kStaging;
  }
};

template <int Mode, typename TN, bool kSplit, bool kTrans>
__global__ void __launch_bounds__(kThreads)
wprod_mma_kernel(WprodArgs p) {
  using C = WprodCfg<kTrans, Mode>;
  using L = WprodSmem<Mode, TN, kSplit, kTrans>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int sc_bytes = L::scale_bytes(p.nsc);
  unsigned char* a_s = smem;
  unsigned char* raw_s = a_s + C::kRing * L::kA;
  float* sc_s = reinterpret_cast<float*>(raw_s + C::kRing * L::kRaw);
  unsigned char* hi = raw_s + C::kRing * L::kRaw + C::kRing * sc_bytes;
  unsigned char* lo = hi + L::kHalf;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp >> 1) * 32, wn0 = (warp & 1) * (C::BN / 2);
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  const int kb = blockIdx.z * p.kdepth;
  const int ke = min(p.K, kb + p.kdepth);
  const int nk = (ke - kb + C::BK - 1) / C::BK;
  const Payload<Mode, TN> w{static_cast<const unsigned char*>(p.w), p.scale, p.wrows, p.wcols,
                            p.bs, p.nb,
                            static_cast<int64_t>(p.wcols) * Payload<Mode, TN>::kBits / 8, p.wvec,
                            p.rpg};
  const int nsc_stride = sc_bytes / 4;  // floats per stage

  auto issue = [&](int t, int slot) {
    const int k0 = kb + t * C::BK;
    load_bf16_tile<C::BM, C::BK>(smem_u32(a_s + slot * L::kA), p.x, p.ldx, m0, p.M, k0, ke, tid);
    if (kTrans)  // window: rows n0.. of w (dx's columns), columns k0.. (g's)
      load_payload<C::WROWS, C::WCOLS>(raw_s + slot * L::kRaw, sc_s + slot * nsc_stride, p.nsc,
                                       w, n0, p.wrows, k0, ke, tid);
    else         // window: rows k0.. of w, columns n0..
      load_payload<C::WROWS, C::WCOLS>(raw_s + slot * L::kRaw, sc_s + slot * nsc_stride, p.nsc,
                                       w, k0, ke, n0, p.wcols, tid);
  };

#pragma unroll
  for (int s = 0; s < C::kRing - 1; ++s) {
    if (s < nk) issue(s, s);
    ds_mma::cp_async_commit();
  }
  float acc[C::FM][C::FN][4];
#pragma unroll
  for (int i = 0; i < C::FM; ++i)
#pragma unroll
    for (int j = 0; j < C::FN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int t = 0; t < nk; ++t) {
    const int slot = t % C::kRing;
    ds_mma::cp_async_wait<C::kRing - 2>();  // stage t has landed
    __syncthreads();                       // ... for all; step t - 1's products are done
    dequant_window<C::WROWS, C::WCOLS, Mode, TN, kSplit>(
        hi, lo, raw_s + slot * L::kRaw, sc_s + slot * nsc_stride, p.nsc,
        kTrans ? kb + t * C::BK : n0, p.bs, tid);
    if (t + C::kRing - 1 < nk) issue(t + C::kRing - 1, (t + C::kRing - 1) % C::kRing);
    ds_mma::cp_async_commit();
    __syncthreads();  // hi / lo are written
    const uint32_t a_tile = smem_u32(a_s + slot * L::kA);
#pragma unroll
    for (int ks = 0; ks < C::BK; ks += 16)
      warp_mma<C::FM, C::FN, false, C::BK, kTrans, kTrans ? C::BK : C::BN, kSplit>(
          acc, a_tile, wm0, smem_u32(hi), smem_u32(lo), wn0, ks, lane);
  }

  ds_mma::cp_async_wait<0>();
  __syncthreads();  // the ring's shared memory becomes the staging tile
  float* st = reinterpret_cast<float*>(smem);
  acc_to_smem<C::FM, C::FN, C::LDS>(st, acc, wm0, wn0, lane);
  __syncthreads();
  if (p.work != nullptr) {
    const TileStore part{nullptr, p.work + static_cast<int64_t>(blockIdx.z) * p.M * p.N, p.N,
                         DS_DTYPE_FP32, p.N % 4 == 0};
    store_tile<C::BM, C::BN, C::LDS>(st, part, m0, n0, p.M, p.N, tid);
  } else {
    store_tile<C::BM, C::BN, C::LDS>(st, p.store, m0, n0, p.M, p.N, tid);
  }
}

// out[m, n] = cast(((work[0] + work[1]) + ...) + work[splits - 1]): the
// fixed-order sum of the split partials, one element per thread and step.
// (static: this header is compiled into more than one object)
static __global__ void __launch_bounds__(256)
split_sum_kernel(const float* __restrict__ work, int splits, int M, int N, TileStore s) {
  const int64_t total = static_cast<int64_t>(M) * N;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * 256) {
    float v = work[i];
    for (int k = 1; k < splits; ++k) v = __fadd_rn(v, work[k * total + i]);
    store_one(s, (i / N) * s.ldo + i % N, v);
  }
}

template <int Mode, typename TN, bool kSplit, bool kTrans>
int launch_wprod(WprodArgs p, int splits, cudaStream_t stream) {
  using C = WprodCfg<kTrans, Mode>;
  using L = WprodSmem<Mode, TN, kSplit, kTrans>;
  p.wvec = aligned16(p.w) &&
           (static_cast<int64_t>(p.wcols) * Payload<Mode, TN>::kBits / 8) % 16 == 0;
  // the scale blocks a window's columns can touch (those past the table
  // are staged as zeros, so a ragged window reads no stale scale)
  p.nsc = Mode == ds_tile::kNative ? 0 : row_groups(Mode) ? 1 : (C::WCOLS - 1) / p.bs + 2;
  p.kdepth = split_depth(p.K, splits, C::BK);
  const int gz = (p.K + p.kdepth - 1) / p.kdepth;
  if (gz > 1 && p.work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (gz == 1) p.work = nullptr;
  const int smem = L::bytes(p.nsc);
  cudaError_t err = cudaFuncSetAttribute(wprod_mma_kernel<Mode, TN, kSplit, kTrans>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.N + C::BN - 1) / C::BN, (p.M + C::BM - 1) / C::BM, gz);
  wprod_mma_kernel<Mode, TN, kSplit, kTrans><<<grid, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || gz == 1) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(p.M) * p.N;
  const int blocks = static_cast<int>((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  split_sum_kernel<<<blocks, 256, 0, stream>>>(p.work, gz, p.M, p.N, p.store);
  return static_cast<int>(cudaGetLastError());
}

// x [M, K-of-the-product] (bf16, pitch ldx) @ the weight tile (or its
// transpose) on the tensor cores, for every payload layout; the sums go
// to `store`, through `work` [splits, M, N] when K is split.
template <bool kTrans>
int launch_weight_product_mma(const void* x, int64_t ldx, const ds_tile::WeightArgs& w,
                              const TileStore& store, int M, float* work, int splits,
                              cudaStream_t stream) {
  if (!ds_tile::weight_args_ok(w) || M <= 0 || w.rows <= 0 || w.cols <= 0 || splits < 1 ||
      !aligned16(x) || (ldx * 2) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  WprodArgs p{};
  p.x = static_cast<const bf16*>(x);
  p.ldx = ldx;
  p.w = w.w;
  p.scale = w.scale;
  p.wrows = w.rows;
  p.wcols = w.cols;
  p.bs = w.mode == ds_tile::kNative ? 1 : w.bs;
  p.nb = w.mode == ds_tile::kNative ? 0 : w.cols / w.bs;
  p.M = M;
  p.N = kTrans ? w.rows : w.cols;
  p.K = kTrans ? w.cols : w.rows;
  p.store = store;
  p.work = work;
  switch (w.mode) {
    case ds_tile::kInt8:
      return launch_wprod<ds_tile::kInt8, float, true, kTrans>(p, splits, stream);
    case ds_tile::kInt4:
      return launch_wprod<ds_tile::kInt4, float, true, kTrans>(p, splits, stream);
    default:
      if (w.dtype == DS_DTYPE_BF16)
        return launch_wprod<ds_tile::kNative, bf16, false, kTrans>(p, splits, stream);
      return launch_wprod<ds_tile::kNative, float, true, kTrans>(p, splits, stream);
  }
}

// ------------------------------------------------------------------ //
// kernel J's product: a [K, M]^T @ b [K, N], both bf16, on the tensor cores
// ------------------------------------------------------------------ //
// 64 x 128 outputs, k-steps of 32; A's tile lies as a[k][m] and reaches
// the tensor cores through ldmatrix.trans, as B's [k][n] does.  K (the
// rows of a and b) is split across blocks; each block writes an fp32
// partial [M, N] to work[blockIdx.z].
struct AtbCfg {
  static constexpr int BM = 64, BN = 128, BK = 32;
  static constexpr int FM = 2, FN = 8;
  static constexpr int LDS = BN + 4;
  static constexpr int kA = BK * BM * 2, kB = BK * BN * 2;
  static constexpr int kLoop = kStages * (kA + kB);
  static constexpr int kStaging = BM * LDS * 4;
  static constexpr int kBytes = kLoop > kStaging ? kLoop : kStaging;
};

static __global__ void __launch_bounds__(kThreads)
at_b_mma_kernel(const bf16* __restrict__ a, int64_t lda, const bf16* __restrict__ b,
                int64_t ldb, float* __restrict__ work, int M, int N, int K, int kdepth) {
  using C = AtbCfg;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp >> 1) * 32, wn0 = (warp & 1) * 64;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  const int kb = blockIdx.z * kdepth;
  const int ke = min(K, kb + kdepth);
  const int nk = (ke - kb + C::BK - 1) / C::BK;
  auto a_tile = [&](int slot) { return smem_u32(smem + slot * (C::kA + C::kB)); };
  auto b_tile = [&](int slot) { return smem_u32(smem + slot * (C::kA + C::kB) + C::kA); };
  auto issue = [&](int t, int slot) {
    const int k0 = kb + t * C::BK;
    load_bf16_tile<C::BK, C::BM>(a_tile(slot), a, lda, k0, ke, m0, M, tid);
    load_bf16_tile<C::BK, C::BN>(b_tile(slot), b, ldb, k0, ke, n0, N, tid);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) issue(s, s);
    ds_mma::cp_async_commit();
  }
  float acc[C::FM][C::FN][4];
#pragma unroll
  for (int i = 0; i < C::FM; ++i)
#pragma unroll
    for (int j = 0; j < C::FN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  for (int t = 0; t < nk; ++t) {
    const int slot = t % kStages;
    ds_mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage t has landed; step t - 1's products are done
    if (t + kStages - 1 < nk) issue(t + kStages - 1, (t + kStages - 1) % kStages);
    ds_mma::cp_async_commit();
#pragma unroll
    for (int ks = 0; ks < C::BK; ks += 16)
      warp_mma<C::FM, C::FN, true, C::BM, false, C::BN, false>(acc, a_tile(slot), wm0,
                                                               b_tile(slot), 0u, wn0, ks, lane);
  }
  ds_mma::cp_async_wait<0>();
  __syncthreads();
  float* st = reinterpret_cast<float*>(smem);
  acc_to_smem<C::FM, C::FN, C::LDS>(st, acc, wm0, wn0, lane);
  __syncthreads();
  const TileStore part{nullptr, work + static_cast<int64_t>(blockIdx.z) * M * N, N,
                       DS_DTYPE_FP32, N % 4 == 0};
  store_tile<C::BM, C::BN, C::LDS>(st, part, m0, n0, M, N, tid);
}

// Enqueue the split partials of a^T b into work [splits, M, N]; returns
// the number of partials through `parts`.
inline int launch_at_b_mma(const void* a, int64_t lda, const void* b, int64_t ldb, float* work,
                           int M, int N, int K, int splits, int* parts, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits < 1 || work == nullptr || !aligned16(a) ||
      !aligned16(b) || (lda * 2) % 16 != 0 || (ldb * 2) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kdepth = split_depth(K, splits, AtbCfg::BK);
  const int gz = (K + kdepth - 1) / kdepth;
  if (gz > splits) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(at_b_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         AtbCfg::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + AtbCfg::BN - 1) / AtbCfg::BN, (M + AtbCfg::BM - 1) / AtbCfg::BM, gz);
  at_b_mma_kernel<<<grid, kThreads, AtbCfg::kBytes, stream>>>(
      static_cast<const bf16*>(a), lda, static_cast<const bf16*>(b), ldb, work, M, N, K, kdepth);
  *parts = gz;
  return static_cast<int>(cudaGetLastError());
}

// The wide tile for kernel C's prefill when its blocks fill the card
// twice over (2 x 132 SMs).
inline bool row_groups_wide(int M, int N) {
  return static_cast<int64_t>((N + 127) / 128) * ((M + 63) / 64) >= 264;
}

// Kernel C's prefill product: x [M, K] bf16 (row pitch K) @ (q [K, N] int8
// * scale[k / rpg]) rounded to bf16, fp32 sums, into `store` (bf16 out):
// the forward weight product in a row-group mode (by N: the wide tile
// when its 128-column blocks still give 2 blocks per SM), hi only, K
// unsplit.
inline int launch_row_group_product(const void* x, const void* q, const float* scale, int rpg,
                                    const TileStore& store, int M, int K, int N,
                                    cudaStream_t stream) {
  if (M <= 0 || K <= 0 || N <= 0 || rpg <= 0 || !aligned16(x) || (K * 2) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  WprodArgs p{};
  p.x = static_cast<const bf16*>(x);
  p.ldx = K;
  p.w = q;
  p.scale = scale;
  p.wrows = K;
  p.wcols = N;
  p.bs = N;
  p.nb = 1;
  p.rpg = rpg;
  p.M = M;
  p.N = N;
  p.K = K;
  p.store = store;
  if (row_groups_wide(M, N))
    return launch_wprod<kInt8RowGroupsWide, float, false, false>(p, 1, stream);
  return launch_wprod<kInt8RowGroups, float, false, false>(p, 1, stream);
}

}  // namespace ds_tmma
