// The layout walk of the block-sparse kernels F and G
// (block_sparse_flash_fwd.cu, block_sparse_flash_bwd.cu): which 64-wide
// sub-tiles of the other operand a q-tile (forward, dq) or a k-tile (dk/dv)
// multiplies, read from the gather indices of layout_gather.
#pragma once

#include <climits>

#include "common.cuh"

namespace ds_bsf {

constexpr int kSub = 64;  // rows of a q-tile, keys of a k-tile, width of a sub-tile

// The gather indices of layout_gather (forward or transposed): idx / valid
// [H, nb, max_deg] int32, each row's valid entries first.
struct Layout {
  const int* idx;
  const int* valid;
  int block;
  int max_deg;
};

// The number of valid entries of a layout row (the CUDA-core kernels'
// walk).
__device__ __forceinline__ int row_degree(const int* valid, int max_deg) {
  int deg = 0;
  while (deg < max_deg && valid[deg] != 0) ++deg;
  return deg;
}

// One warp copies the live entries of a layout row into `out` (shared
// memory), in their order: valid, and lo <= block index <= hi (the causal
// bound of the walk).  Each lane reads one entry per round of 32, and a
// ballot places the live ones.  Returns their count to every lane.
__device__ __forceinline__ int compact_live_blocks(int* out, const int* idx, const int* valid,
                                                   int max_deg, int lo, int hi, int lane) {
  int n = 0;
  for (int base = 0; base < max_deg; base += 32) {
    const int e = base + lane;
    bool live = false;
    int blk = 0;
    if (e < max_deg) {
      blk = idx[e];
      live = valid[e] != 0 && blk >= lo && blk <= hi;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    if (live) out[n + __popc(ballot & ((1u << lane) - 1u))] = blk;
    n += __popc(ballot);
  }
  return n;
}

// The flat walk of a tile over the live sub-tiles of its layout row: every
// sub-tile of each live block in turn, clipped to [lo, hi) (the causal
// diagonal's bound; multiples of kSub, as blocks are).  Every live block
// holds at least one sub-tile inside the clip, so `pos` is always the start
// of a sub-tile to multiply while valid().  Every thread of a block keeps
// its own copy; they all step together.
struct SubTileWalk {
  const int* blocks;  // live block indices, shared memory
  int n_blocks, block, lo, hi;
  int e, pos, end;

  __device__ __forceinline__ SubTileWalk(const int* blocks_, int n_blocks_, int block_,
                                         int lo_, int hi_)
      : blocks(blocks_), n_blocks(n_blocks_), block(block_), lo(lo_), hi(hi_), e(0) {
    enter();
  }
  __device__ __forceinline__ void enter() {
    if (e < n_blocks) {
      const int begin = blocks[e] * block;
      pos = max(begin, lo);
      end = min(begin + block, hi);
    }
  }
  __device__ __forceinline__ bool valid() const { return e < n_blocks; }
  __device__ __forceinline__ void next() {
    pos += kSub;
    if (pos >= end) {
      ++e;
      enter();
    }
  }
};

}  // namespace ds_bsf
