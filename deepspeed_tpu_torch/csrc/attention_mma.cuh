// Tensor-core building blocks of the attention kernels: kernels B and E
// (flash_attention_fwd.cu, flash_attention_bwd.cu) and the block-sparse
// kernels F and G (block_sparse_flash_fwd.cu, block_sparse_flash_bwd.cu)
// include it for their bf16 route.  Everything here works on bf16 operands
// with fp32 sums, on sm_80 and later instructions that Hopper keeps
// (`cp.async`, `ldmatrix`, `mma.sync`); `wgmma` and TMA are not used.
//
// Pieces, in the order a kernel uses them:
//
// - `cp.async` 16-byte copies that read a tile's rows of one head at their
//   sequence stride (the fused-QKV head views have 128-byte rows at a 4608
//   byte pitch), with rows past the sequence zero-filled through the
//   src-size operand, so that no element-wise bounds checks are needed.
//   Every operand's base pointer and strides must be multiples of 16
//   bytes; the Python wrapper copies an operand that is not.  A head dim
//   below the tile's D (any multiple of 8) is zero-filled past its end, so
//   the zero columns add nothing to a product, and never stored.
// - A swizzled shared-memory layout of [rows][D] bf16 tiles, D in {32, 64,
//   96, 128, 256} (the instantiations; the true head dim may be smaller):
//   a row's 16-byte chunks are permuted inside groups of eight
//   (or, for a row's last four when D / 8 is not a multiple of eight,
//   inside that group of four), so that the eight rows one `ldmatrix` 8 x 8
//   matrix reads fall into eight different 16-byte bank groups (tile_offset).
// - `ldmatrix` loaders of A and B operands from such tiles, plain or
//   transposed, and `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`.
// - Warp-level products: S = A . tile^T (the scores, from rows of Q or K)
//   and O += P . tile (P from registers, times rows of V, dO, Q or K).
// - The conversion of fp32 accumulator fragments into bf16 A-operand
//   fragments, so that P and dS feed their next product from registers
//   (no trip through shared memory, no shuffles).
// - The fragment -> (row, col) map, and the dropout keep bits of a tile.
// - The per-tile steps of the forward (B, F), of the dq launch (E, G) and
//   of the dk/dv launch (E, G): one 64 x 64 tile's products and softmax
//   work for a warp's 16 rows.  The dense and block-sparse kernels differ
//   only in the tiles they walk.
// - The column split of D = 256 (ColumnSplit): a warp's fp32 sums of 16
//   rows x 256 columns (128 registers for O or dQ, 256 for dK and dV) do
//   not fit beside the scores, so from D = 256 on a block has two groups of
//   four warps.  Both groups compute a tile's scores over the whole D from
//   shared memory (Q too, which D <= 128 keeps in registers), and each
//   accumulates its own 128 output columns: the score products run twice,
//   the output products once.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16 inputs), with
// g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major), four 32-bit registers of two bf16 each:
//     a0 = (g, 2t..2t+1), a1 = (g+8, 2t..2t+1), a2 = (g, 2t+8..2t+9),
//     a3 = (g+8, 2t+8..2t+9)  (row, columns);
//   B (16 x 8, k x n), two registers: b0 = (k 2t..2t+1, n g),
//     b1 = (k 2t+8..2t+9, n g);
//   C (16 x 8, fp32), four floats: c0, c1 = (g, 2t..2t+1),
//     c2, c3 = (g+8, 2t..2t+1).
// So accumulator element e of n-tile j sits at row g + 8 (e / 2) and column
// 8 j + 2 t + e % 2 (frag_row / frag_col below), and the two n-tiles 2 i and
// 2 i + 1 of a row block are exactly the A operand of k-slice i of the next
// product: a0 = (c0, c1) of tile 2i, a1 = (c2, c3) of tile 2i, a2 and a3 the
// same of tile 2i+1 (acc_to_a).
#pragma once

#include "common.cuh"
#include "dropout.cuh"

namespace ds_mma {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTile = 64;  // rows or keys of the tiles one step multiplies

// ------------------------------------------------------------------ //
// cp.async
// ------------------------------------------------------------------ //
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, or 16 zero bytes when !valid (src is
// then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(n));
}

// 4 bytes (an fp32 row statistic), or zeros when !valid.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------------ //
// swizzled [rows][D] bf16 tiles
// ------------------------------------------------------------------ //
// Byte offset of element (row, col) in a tile, col a multiple of 8 plus
// an offset inside its 16-byte chunk.  Chunk c of row r lies at chunk
// c ^ (r % 8) of its group of eight; when D / 8 is not a multiple of eight
// (D = 32, and chunks 8..11 of D = 96) the row's last four chunks swizzle
// inside their group of four with (r / 2) % 4 instead, so no chunk leaves
// its row.  A row of 4 or 12 chunks starts at bank group 4 (r % 2), and
// with that the eight rows r0..r0 + 7 (r0 a multiple of 8) of one chunk
// column still land in eight different 16-byte bank groups in every case:
// ldmatrix reads them, and cp.async writes them, without bank conflicts.
template <int D>
__device__ __forceinline__ uint32_t tile_offset(int row, int col) {
  constexpr int kChunks = D / 8;
  constexpr int kGrouped = kChunks & ~7;  // chunks in whole groups of eight
  static_assert(D % 32 == 0 && D <= 256, "rows of 4 to 32 chunks, in fours");
  const int c = col >> 3;
  const int p = c < kGrouped ? (((c ^ row) & 7) | (c & ~7))
                             : (((c ^ (row >> 1)) & 3) | (c & ~3));
  return static_cast<uint32_t>(row * (D * 2) + p * 16 + (col & 7) * 2);
}

template <int D>
__host__ __device__ constexpr int tile_bytes(int rows) {
  return rows * D * 2;
}

// How a block of the per-tile steps splits its head dim: kParts groups of
// four warps, each owning DO of the D output columns (at column
// (warp / 4) * DO); every warp computes the whole-D scores of its 16 rows.
template <int D>
struct ColumnSplit {
  static constexpr int kParts = D > 128 ? 2 : 1;
  static constexpr int DO = D / kParts;
  static constexpr int kThreads = 128 * kParts;
  static_assert(DO <= 128, "a warp's sums hold at most 128 columns");
};

// Issue the copies of rows [r0, r0 + ROWS) of one head's [S, dhead] operand
// (row stride `ss` elements) into a tile of the instantiation's D >= dhead
// columns; rows past S, and the chunks at and past dhead (a multiple of 8),
// are zero-filled.  NT threads share the copies, neighbouring threads on
// neighbouring chunks.
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_tile_async(uint32_t tile, const __nv_bfloat16* src,
                                                long long ss, int r0, int S, int tid,
                                                int dhead) {
  constexpr int kChunks = D / 8;
  static_assert((ROWS * kChunks) % NT == 0, "whole rounds of copies");
  // when NT is a multiple of a row's chunks a thread copies the same chunk
  // column in every round, so its head-dim test is made once
  constexpr bool kFixedColumn = NT % kChunks == 0;
  const bool col_ok = !kFixedColumn || (tid % kChunks) * 8 < dhead;
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / NT; ++i) {
    const int idx = tid + i * NT;
    const int r = idx / kChunks, c = kFixedColumn ? tid % kChunks : idx % kChunks;
    const int g = r0 + r;
    // a chunk at or past dhead is not read (src-size 0), so its address,
    // inside the instantiation's row, needs no clamping
    const __nv_bfloat16* p = src + static_cast<long long>(g < S ? g : 0) * ss + c * 8;
    const bool ok = g < S && (kFixedColumn ? col_ok : c * 8 < dhead);
    cp_async_16(tile + tile_offset<D>(r, c * 8), p, ok);
  }
}

// Rows [r0, r0 + ROWS) of an fp32 row statistic (lse or delta) of one
// head into shared memory, zero past S.
template <int ROWS, int NT>
__device__ __forceinline__ void load_stat_async(uint32_t dst, const float* src, int r0, int S,
                                                int tid) {
  for (int r = tid; r < ROWS; r += NT) {
    const bool ok = r0 + r < S;
    cp_async_4(dst + r * 4, src + (ok ? r0 + r : 0), ok);
  }
}

// ------------------------------------------------------------------ //
// ldmatrix and mma.sync
// ------------------------------------------------------------------ //
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values as one bf16x2 register, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Lane `lane`'s address for ldmatrix.x4 of a 16 x 16 block at (r0, c0) of
// a tile: matrix i (lanes 8i..8i+7) is rows r0 + 8 (i % 2) + 0..7, columns
// c0 + 8 (i / 2).  Plain, it returns an A fragment (a0..a3).  Transposed
// (ldsm_x4_trans), for a product with the tile as its [k][n] B operand
// (k = the tile's rows r0..r0+15, n = its columns c0..c0+15), it returns
// (b0, b1) of n-tile c0 / 8 in registers 0, 1 and of n-tile c0 / 8 + 1 in
// registers 2, 3.
template <int D>
__device__ __forceinline__ uint32_t frag_addr(uint32_t tile, int r0, int c0, int lane) {
  return tile + tile_offset<D>(r0 + (lane & 15), c0 + ((lane >> 4) << 3));
}

// Lane `lane`'s address for ldmatrix.x4 (plain) of B operands for a
// product with the tile's TRANSPOSE (B[k][n] = tile[n][k], n = the tile's
// rows n0..n0+15, k = its columns c0..c0+15): matrix i is rows
// n0 + 8 (i / 2) + 0..7, columns c0 + 8 (i % 2); registers 0, 1 are
// (b0, b1) of n-tile n0 / 8 and registers 2, 3 of n-tile n0 / 8 + 1.
template <int D>
__device__ __forceinline__ uint32_t frag_addr_nt(uint32_t tile, int n0, int c0, int lane) {
  return tile + tile_offset<D>(n0 + (lane & 7) + ((lane >> 4) << 3),
                               c0 + (((lane >> 3) & 1) << 3));
}

// The A fragments of rows [r0, r0 + 16) x [0, D) of a tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], uint32_t tile, int r0,
                                       int lane) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) ldsm_x4(a[ks], frag_addr<D>(tile, r0, 16 * ks, lane));
}

// s[16 x N] = A[16 x D] . tile[n0 .. n0 + N)[0 .. D)^T, A given as
// fragments in registers (s is overwritten).
template <int D, int N>
__device__ __forceinline__ void warp_abt(float (&s)[N / 8][4], const uint32_t (&a)[D / 16][4],
                                         uint32_t tile, int n0, int lane) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
    for (int jp = 0; jp < N / 16; ++jp) {
      uint32_t b[4];
      ldsm_x4(b, frag_addr_nt<D>(tile, n0 + 16 * jp, 16 * ks, lane));
      mma_16816(s[2 * jp], a[ks], b[0], b[1]);
      mma_16816(s[2 * jp + 1], a[ks], b[2], b[3]);
    }
  }
}

// The same with A read from rows [a_r0, a_r0 + 16) of a tile, one k-slice
// at a time (fewer registers than holding all of A).
template <int D, int N>
__device__ __forceinline__ void warp_abt_smem(float (&s)[N / 8][4], uint32_t a_tile, int a_r0,
                                              uint32_t tile, int n0, int lane) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, frag_addr<D>(a_tile, a_r0, 16 * ks, lane));
#pragma unroll
    for (int jp = 0; jp < N / 16; ++jp) {
      uint32_t b[4];
      ldsm_x4(b, frag_addr_nt<D>(tile, n0 + 16 * jp, 16 * ks, lane));
      mma_16816(s[2 * jp], a, b[0], b[1]);
      mma_16816(s[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// o[16 x DO] += P[16 x K] . tile[k0 .. k0 + K)[c0 .. c0 + DO), P as A
// fragments (DO of the tile's D columns from column c0).
template <int K, int D, int DO = D>
__device__ __forceinline__ void warp_ab(float (&o)[DO / 8][4], const uint32_t (&p)[K / 16][4],
                                        uint32_t tile, int k0, int lane, int c0 = 0) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
#pragma unroll
    for (int dp = 0; dp < DO / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, frag_addr<D>(tile, k0 + 16 * kk, c0 + 16 * dp, lane));
      mma_16816(o[2 * dp], p[kk], b[0], b[1]);
      mma_16816(o[2 * dp + 1], p[kk], b[2], b[3]);
    }
  }
}

// fp32 accumulators [16 x N] -> bf16 A fragments of the next product.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[N / 16][4], const float (&c)[N / 8][4]) {
#pragma unroll
  for (int i = 0; i < N / 16; ++i) {
    a[i][0] = pack_bf16(c[2 * i][0], c[2 * i][1]);
    a[i][1] = pack_bf16(c[2 * i][2], c[2 * i][3]);
    a[i][2] = pack_bf16(c[2 * i + 1][0], c[2 * i + 1][1]);
    a[i][3] = pack_bf16(c[2 * i + 1][2], c[2 * i + 1][3]);
  }
}

// Row and column, inside the warp's 16 x N block, of accumulator element e
// of n-tile j.
__device__ __forceinline__ int frag_row(int lane, int e) { return (lane >> 2) + 8 * (e >> 1); }
__device__ __forceinline__ int frag_col(int lane, int j, int e) {
  return 8 * j + 2 * (lane & 3) + (e & 1);
}

// Sum (or max) of a row's values over the four threads of a quad, which
// together hold the row's accumulator columns.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Write the warp's accumulator rows [16 x DO] as bf16 into rows
// [r0, r0 + 16) x columns [c0, c0 + DO) of a tile (the warp's own block:
// no block barrier needed, only __syncwarp before it is read back).
template <int D, int DO = D>
__device__ __forceinline__ void acc_to_tile(unsigned char* tile, int r0,
                                            const float (&o)[DO / 8][4], float scale_lo,
                                            float scale_hi, int lane, int c0 = 0) {
#pragma unroll
  for (int j = 0; j < DO / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float sc = half ? scale_hi : scale_lo;
      const uint32_t off =
          tile_offset<D>(r0 + frag_row(lane, 2 * half), c0 + frag_col(lane, j, 0));
      *reinterpret_cast<uint32_t*>(tile + off) =
          pack_bf16(o[j][2 * half] * sc, o[j][2 * half + 1] * sc);
    }
  }
}

// Store rows [r0, r0 + 16) x columns [c0, c0 + DO) of a tile to global
// rows g0 + 0..15 (row stride `ss` elements), 16 bytes per thread and
// step; rows at or past S, and the chunks at and past dhead, are skipped.
template <int D, int DO = D>
__device__ __forceinline__ void tile_rows_to_global(__nv_bfloat16* dst, long long ss, int g0,
                                                    int S, const unsigned char* tile, int r0,
                                                    int lane, int dhead, int c0 = 0) {
  constexpr int kChunks = DO / 8;
#pragma unroll
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = c0 / 8 + i % kChunks;
    if (g0 + r < S && c * 8 < dhead) {
      *reinterpret_cast<uint4*>(dst + static_cast<long long>(g0 + r) * ss + c * 8) =
          *reinterpret_cast<const uint4*>(tile + tile_offset<D>(r0 + r, c * 8));
    }
  }
}

// ------------------------------------------------------------------ //
// dropout keep bits
// ------------------------------------------------------------------ //
// dropout.cuh fixes the mask: Philox keyed by (seed, b * H + h), counter
// (row, col / 64, col % 4, 0), byte i of the call (bits 8 (i % 4) of word
// i / 4) decides column 64 (col / 64) + 4 i + col % 4.
//
// Per fragment, a thread of the forward layout holds, for each of its rows
// g and g + 8, the columns 8 j + 2 t + {0, 1} (j = 0..7) of a 64-key tile:
// col % 4 = 2 (t % 2) + {0, 1} and i = 2 j + t / 2.  That is two Philox
// calls per row (counters col % 4 of {0, 1} for even t, {2, 3} for odd t),
// of whose 16 bytes it uses the 8 with i % 2 = t / 2: four calls for its 32
// scores, each call drawn twice in the warp (by t and t ^ 2).  In the
// transposed layout of the dk/dv launch (rows = keys, columns = queries) a
// thread holds 16 queries x 2 keys, and each call (one query) yields it 2
// useful bytes: 16 calls for 32 scores.
//
// So the kernels draw the keep decisions of a whole [ROWS x 64] score tile
// cooperatively instead, each (row, col % 4) call exactly once per block,
// into one 64-bit word per row (bit c = column c of the tile kept), and
// every thread reads its fragment's bits from shared memory: two calls per
// thread per 64 x 64 tile whatever the layout, 512 bytes of shared memory.
// The four calls of a row go to the four threads of a quad, which OR their
// 16 bits together by shuffles.  The words must be drawn a barrier before
// they are read.
//
// A call's word w holds bytes i = 4 w .. 4 w + 3, columns 4 i + l: its four
// keep flags (one per byte, from one SIMD compare) go to bits l, 4 + l,
// 8 + l, 12 + l of the 16 columns 16 w .. 16 w + 15.
__device__ __forceinline__ uint32_t keep_nibbles(uint32_t word, uint32_t threshold4) {
  const uint32_t x = __vsetltu4(word, threshold4);  // 0x01 in each byte kept
  const uint32_t y = x | (x >> 4);
  return (y & 0x11u) | ((y >> 8) & 0x1100u);        // byte b -> bit 4 b
}

template <int ROWS, int NT>
__device__ __forceinline__ void draw_keep_bits(uint64_t* bits, uint32_t seed, uint32_t bh,
                                               int row0, int n0, uint32_t threshold, int tid) {
  static_assert((ROWS * 4) % NT == 0 && NT % 32 == 0, "whole warps, whole rounds");
  const uint32_t threshold4 = threshold * 0x01010101u;  // threshold < 256 when dropping
#pragma unroll
  for (int it = 0; it < ROWS * 4 / NT; ++it) {
    const int item = tid + it * NT;
    const int r = item >> 2, l = item & 3;
    const uint4 w = ds_dropout_bytes(seed, bh, row0 + r, n0, l);
    // columns 0..31 and 32..63
    uint32_t lo = (keep_nibbles(w.x, threshold4) | (keep_nibbles(w.y, threshold4) << 16)) << l;
    uint32_t hi = (keep_nibbles(w.z, threshold4) | (keep_nibbles(w.w, threshold4) << 16)) << l;
    lo |= __shfl_xor_sync(0xffffffffu, lo, 1);
    lo |= __shfl_xor_sync(0xffffffffu, lo, 2);
    hi |= __shfl_xor_sync(0xffffffffu, hi, 1);
    hi |= __shfl_xor_sync(0xffffffffu, hi, 2);
    if (l == 0) bits[r] = (static_cast<uint64_t>(hi) << 32) | lo;
  }
}

// The keep bits of a thread's 32 accumulator elements of a row-major tile
// fragment (rows = the keep words' rows): bit 4 j + e is element e of
// n-tile j, column 8 j + 2 t + e % 2 of the word of row g + 8 (e / 2).
__device__ __forceinline__ uint32_t fragment_keep(uint64_t word_lo_row, uint64_t word_hi_row,
                                                  int lane) {
  const uint64_t w[2] = {word_lo_row >> (2 * (lane & 3)), word_hi_row >> (2 * (lane & 3))};
  uint32_t k = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      k |= static_cast<uint32_t>((w[e >> 1] >> (8 * j + (e & 1))) & 1u) << (4 * j + e);
  return k;
}

// The same for the transposed layout of the dk/dv launch: accumulator rows
// are the tile's columns (keys, `key` = w0 + g for e < 2, + 8 for e >= 2)
// and accumulator columns its rows (queries 8 j + 2 t + e % 2).
__device__ __forceinline__ uint32_t fragment_keep_t(const uint64_t* bits, int key, int lane) {
  const uint32_t* b32 = reinterpret_cast<const uint32_t*>(bits);
  const int half = key >> 5, sh = key & 31;  // keys key and key + 8 share a half
  uint32_t k = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const uint32_t w = b32[2 * (8 * j + 2 * (lane & 3) + c) + half] >> sh;
      k |= ((w & 1u) << (4 * j + c)) | (((w >> 8) & 1u) << (4 * j + 2 + c));
    }
  return k;
}

__device__ __forceinline__ bool kept(uint32_t fragment_bits, int j, int e) {
  return (fragment_bits >> (4 * j + e)) & 1u;
}

// ------------------------------------------------------------------ //
// the per-tile steps, shared by the dense and block-sparse kernels
// ------------------------------------------------------------------ //
// `edge` says whether the tile needs masking at all (it crosses the causal
// diagonal or the sequence's end); inside it, keys at or past Sk weigh 0
// and, under causal masking, keys after the row take DEFAULT_MASK_VALUE in
// the forward and give P = 0 in the backward.  kDropout: the kernel
// carries dropout (B and E; F and G have none, and compile it out), and
// `drop` says at run time whether this call drops; `keep_words` then points
// at the warp's keep words of this tile (the forward and dq layout: the
// words of the thread's rows g and g + 8; dk/dv: the tile's words, rows =
// queries).  A run-time flag and not a kernel per case: E's dq compiled
// for dropout alone took 206 registers against 167 and ran 19% slower on
// the H100 (PERF.md).

// Forward (kernels B and F), after S = Q K^T of the warp's 16 query rows
// against the 64 keys of a K / V tile pair (in s): the online softmax
// update of the row maxima m and of this thread's share of the row sums l,
// then acc = acc * alpha + P V[:, c0 .. c0 + DO), P rounded to bf16 from
// registers.  With dropout, l takes the raw P and only the P.V input is
// dropped (the keep scale multiplies the output once, with 1 / l).
template <int D, int DO, bool kDropout>
__device__ __forceinline__ void fwd_softmax_pv(float (&acc)[DO / 8][4], float (&m)[2],
                                               float (&l)[2], float (&s)[kTile / 8][4],
                                               uint32_t v_tile, int n0, const int (&rows)[2],
                                               int Sk, bool causal, bool edge, float sm_scale,
                                               bool drop, const uint64_t* keep_words, int lane,
                                               int c0) {
  constexpr int N = kTile;
  float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float sv = s[j][e] * sm_scale;
      if (edge) {
        const int col = n0 + frag_col(lane, j, e);
        if (col >= Sk) {
          sv = -CUDART_INF_F;  // past the ragged edge: weight 0
        } else if (causal && col > rows[e >> 1]) {
          sv = DS_MASK_VALUE;
        }
      }
      s[j][e] = sv;
      mt[e >> 1] = fmaxf(mt[e >> 1], sv);
    }
  }
  // exp(x - m) as exp2((x - m) log2 e), the difference first: a masked
  // score minus a masked max is 0, as in the plain twin's softmax
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mt[r]));
    alpha[r] = exp2f((m[r] - m_new) * kLog2e);
    m[r] = m_new;
  }
  float lt[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f((s[j][e] - m[e >> 1]) * kLog2e);
      lt[e >> 1] += p;
      s[j][e] = p;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + lt[r];
  if (kDropout && drop) {
    const uint32_t keep = fragment_keep(keep_words[0], keep_words[8], lane);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = kept(keep, j, e) ? s[j][e] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < DO / 8; ++j) {
    acc[j][0] *= alpha[0];
    acc[j][1] *= alpha[0];
    acc[j][2] *= alpha[1];
    acc[j][3] *= alpha[1];
  }
  uint32_t pa[N / 16][4];
  acc_to_a<N>(pa, s);
  warp_ab<N, D, DO>(acc, pa, v_tile, 0, lane, c0);
}

// The forward step with Q as A fragments in registers (qa; D <= 128).
template <int D, bool kDropout>
__device__ __forceinline__ void fwd_tile_step(float (&acc)[D / 8][4], float (&m)[2],
                                              float (&l)[2], const uint32_t (&qa)[D / 16][4],
                                              uint32_t k_tile, uint32_t v_tile, int n0,
                                              const int (&rows)[2], int Sk, bool causal,
                                              bool edge, float sm_scale, bool drop,
                                              const uint64_t* keep_words, int lane) {
  float s[kTile / 8][4];
  warp_abt<D, kTile>(s, qa, k_tile, 0, lane);
  fwd_softmax_pv<D, D, kDropout>(acc, m, l, s, v_tile, n0, rows, Sk, causal, edge, sm_scale,
                                 drop, keep_words, lane, 0);
}

// The forward step with Q read from rows [w0, w0 + 16) of its tile at each
// k-slice, for a warp that owns DO of the output columns (from c0): the
// column split of D = 256.
template <int D, int DO, bool kDropout>
__device__ __forceinline__ void fwd_tile_step_split(float (&acc)[DO / 8][4], float (&m)[2],
                                                    float (&l)[2], uint32_t q_tile, int w0,
                                                    uint32_t k_tile, uint32_t v_tile, int n0,
                                                    const int (&rows)[2], int Sk, bool causal,
                                                    bool edge, float sm_scale, bool drop,
                                                    const uint64_t* keep_words, int lane,
                                                    int c0) {
  float s[kTile / 8][4];
  warp_abt_smem<D, kTile>(s, q_tile, w0, k_tile, 0, lane);
  fwd_softmax_pv<D, DO, kDropout>(acc, m, l, s, v_tile, n0, rows, Sk, causal, edge, sm_scale,
                                  drop, keep_words, lane, c0);
}

// dq launch (kernels E and G): the warp's 16 query rows (rows w0.. of the
// Q and dO tiles) against a K / V tile pair: S = Q K^T and dP = dO V^T,
// P = exp(S scale - lse), dS = P (dP_drop - delta) scale,
// acc += dS K[:, c0 .. c0 + DO).
template <int D, int DO, bool kDropout>
__device__ __forceinline__ void bwd_dq_tile_step(float (&acc)[DO / 8][4], uint32_t q_tile,
                                                 uint32_t do_tile, int w0, uint32_t k_tile,
                                                 uint32_t v_tile, int n0, const int (&rows)[2],
                                                 const float (&lse_r)[2],
                                                 const float (&delta_r)[2], int Sk, bool causal,
                                                 bool edge, float sm_scale, bool drop,
                                                 const uint64_t* keep_words, float keep_scale,
                                                 int lane, int c0) {
  constexpr int N = kTile;
  const bool dropping = kDropout && drop;
  float s[N / 8][4], dp[N / 8][4];
  warp_abt_smem<D, N>(s, q_tile, w0, k_tile, 0, lane);
  warp_abt_smem<D, N>(dp, do_tile, w0, v_tile, 0, lane);
  const uint32_t keep = dropping ? fragment_keep(keep_words[0], keep_words[8], lane) : 0u;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, ci = frag_col(lane, j, e);
      float pv = exp2f((s[j][e] * sm_scale - lse_r[r]) * kLog2e);
      if (edge && (n0 + ci >= Sk || (causal && n0 + ci > rows[r]))) pv = 0.f;
      float dpv = dp[j][e];
      if (dropping) dpv = kept(keep, j, e) ? dpv * keep_scale : 0.f;
      s[j][e] = pv * (dpv - delta_r[r]) * sm_scale;  // dS
    }
  }
  uint32_t a[N / 16][4];
  acc_to_a<N>(a, s);
  warp_ab<N, D, DO>(acc, a, k_tile, 0, lane, c0);
}

// dk/dv launch (kernels E and G): the warp's 16 keys (rows w0.. of the K
// and V tiles, which stay in shared memory) against a tile of 64 queries
// (Q, dO and their lse / delta in shared memory; query m0 is the tile's
// row 0, key n0 the K tile's): S^T = K Q^T gives P^T, dv += P_drop^T dO;
// dP^T = V dO^T gives dS^T, dk += dS^T Q; P_drop^T and dS^T reach their
// products from registers; the warp accumulates the DO columns of dk and
// dv from c0.  The keep scale of dv is left to the caller.
template <int D, int DO, bool kDropout>
__device__ __forceinline__ void bwd_dkdv_tile_step(float (&dk)[DO / 8][4], float (&dv)[DO / 8][4],
                                                   uint32_t k_tile, uint32_t v_tile, int w0,
                                                   uint32_t q_tile, uint32_t do_tile,
                                                   const float* ls, const float* dl, int m0,
                                                   int n0, int Sq, int Sk, bool causal,
                                                   bool edge, float sm_scale, bool drop,
                                                   const uint64_t* keep_words, float keep_scale,
                                                   int lane, int c0) {
  constexpr int M = kTile;
  const bool dropping = kDropout && drop;
  const uint32_t keep = dropping ? fragment_keep_t(keep_words, w0 + (lane >> 2), lane) : 0u;
  // accumulator rows are keys (w0 + frag_row), columns queries (frag_col)
  float p[M / 8][4];
  warp_abt_smem<D, M>(p, k_tile, w0, q_tile, 0, lane);
  uint32_t a[M / 16][4];
  {
    float pd[M / 8][4];
#pragma unroll
    for (int j = 0; j < M / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = frag_col(lane, j, e), ki = w0 + frag_row(lane, e);
        float pv = exp2f((p[j][e] * sm_scale - ls[qi]) * kLog2e);
        if (edge && (m0 + qi >= Sq || n0 + ki >= Sk || (causal && m0 + qi < n0 + ki))) {
          pv = 0.f;
        }
        p[j][e] = pv;
        pd[j][e] = dropping && !kept(keep, j, e) ? 0.f : pv;
      }
    }
    acc_to_a<M>(a, pd);
  }
  warp_ab<M, D, DO>(dv, a, do_tile, 0, lane, c0);

  // dP^T -> dS^T = P (dP_drop - delta) scale -> dK += dS^T Q
  float ds[M / 8][4];
  warp_abt_smem<D, M>(ds, v_tile, w0, do_tile, 0, lane);
#pragma unroll
  for (int j = 0; j < M / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = frag_col(lane, j, e);
      float dpv = ds[j][e];
      if (dropping) dpv = kept(keep, j, e) ? dpv * keep_scale : 0.f;
      ds[j][e] = p[j][e] * (dpv - dl[qi]) * sm_scale;
    }
  }
  acc_to_a<M>(a, ds);
  warp_ab<M, D, DO>(dk, a, q_tile, 0, lane, c0);
}

}  // namespace ds_mma
