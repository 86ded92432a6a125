// Shared helpers of the port's CUDA kernels: the dtype codes the Python
// wrappers pass (ops/op_builder.py DTYPE_*), bf16 and fp16 <-> fp32
// conversion through the __nv_bfloat16 and __half intrinsics only, and warp
// reductions.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math_constants.h>
#include <stdint.h>

#define DS_DTYPE_FP32 0
#define DS_DTYPE_BF16 1
// fp16 is a parameter dtype only: kernels A and D take an fp16 gamma and
// beta (an fp16 run rounds the parameters through fp16, the JAX engine's
// cast); every launcher refuses it for an activation
#define DS_DTYPE_FP16 2

// ops/flash_attention.py DEFAULT_MASK_VALUE: -0.7 * float32 max.  Finite,
// so a running max over masked scores never becomes -inf.
#define DS_MASK_VALUE (-0.7f * 3.4028234663852886e+38f)

// The head dims the attention launchers (kernels B, E, F, G) take: any
// D >= 1.  Up to 256 the tiled kernels run it, above 256 the wide kernels
// (attention_wide.cuh), their output columns in chunks of DS_WIDE_CHUNK
// over the grid.  On the bf16 (tensor-core) routes D must be a multiple of
// 8, the width of their 16-byte copies (the Python wrappers pad any other
// D with zero columns).  A launch passes the chunk count it planned
// (ops/flash_attention.py head_dim_plan), and one that differs from
// ds_head_dim_chunks is refused.
#define DS_MAX_TILED_HEAD_DIM 256
#define DS_WIDE_CHUNK 128

inline bool ds_head_dim_ok(int D, int dtype) {
  if (dtype != DS_DTYPE_BF16 && dtype != DS_DTYPE_FP32) return false;
  return D >= 1 && (dtype == DS_DTYPE_FP32 || D % 8 == 0);
}

inline int ds_head_dim_chunks(int D) {
  return D > DS_MAX_TILED_HEAD_DIM ? (D + DS_WIDE_CHUNK - 1) / DS_WIDE_CHUNK : 1;
}

inline bool ds_head_dim_plan_ok(int D, int chunks, int dtype) {
  return ds_head_dim_ok(D, dtype) && chunks == ds_head_dim_chunks(D);
}

__device__ __forceinline__ float ds_to_float(float v) { return v; }
__device__ __forceinline__ float ds_to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float ds_to_float(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T ds_from_float(float v);
template <>
__device__ __forceinline__ float ds_from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 ds_from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half ds_from_float<__half>(float v) {
  return __float2half_rn(v);
}

__device__ __forceinline__ float ds_warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
