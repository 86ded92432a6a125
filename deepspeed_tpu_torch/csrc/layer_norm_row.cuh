// The row-statistics core of kernels A (layer_norm.cu) and D
// (layer_norm_bwd.cu): how a launch cuts its rows over threads, how a
// thread holds its columns of a row in registers, and how a row's sums
// reach every one of its threads.
//
// A row of `hidden` elements is read from HBM once, into the registers of
// the `tpr` threads (whole warps) that own it: thread t holds `per` packs
// of VEC contiguous elements, pack j at columns (j * tpr + t) * VEC, so
// each pack index is one coalesced sweep of the row.  On the vector route
// a pack is one 16-byte load (VEC = 8 bf16 or 4 fp32); a row whose width
// is not a multiple of VEC, or whose tensors do not start on 16 bytes,
// takes the scalar route (VEC = 1, element loads).  A row too wide for the
// registers of kMaxRowThreads threads takes the streamed route: a block
// takes `rps` rows one after another, each pass re-reading the row (from
// L2).  The mean and then the
// variance of the deviations come from the registers, the reference's
// two-pass form at no extra memory cost.
//
// A block holds `slots` rows in flight (slots * tpr threads), and each
// slot takes `rps` rows one after another, the next row's loads issued
// before this row's sums.  Few rows take one row a block, so decode's 8
// rows run on 8 SMs and prefill's 1024 on 256 blocks; more rows fill
// kFwdBlocks (A) or kBwdBlocks (D) blocks and then lengthen each slot's
// run.  The plan is a function of (rows, hidden, dtype, alignment,
// direction) and constants, never of the device's SM count, so kernel D's
// fixed-order column sums repeat bitwise on any H100.  ops/normalize.py
// layer_norm_plan mirrors plan(); the launch passes the Python plan and
// the launchers refuse one that differs.
//
// The widths and counts come from a sweep of launch shapes on the H100
// (PERF.md §6): at hidden 768 bf16 a row sits in one warp (3 packs a
// thread), which beat 2 and 3 warps a row; A at the train step's 8192 rows
// runs 8 slots of 4 rows (256 blocks), ~8% faster than one row a slot; D
// runs 8 slots of 8 rows (128 blocks, 128 workspace rows), faster than 64,
// 256 or 512 blocks.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace ds_ln {

// routes (ops/normalize.py LN_ROUTES)
constexpr int kVector = 0;
constexpr int kScalar = 1;
constexpr int kStreamed = 2;

constexpr int kVectorCap = 4;       // 16-byte packs a thread a row: 1..4
constexpr int kScalarCap = 16;      // element packs a thread a row: 1, 2, 4, 8, 16
constexpr int kMaxRowThreads = 512; // a row in registers: at most 16 warps
constexpr int kSlotThreads = 256;   // a block's threads when its rows are narrower
constexpr int kStreamThreads = 1024;
// the blocks a launch spreads its rows over before a slot takes a second
// row: for A two per SM of an H100 SXM, for D one (fewer, fuller blocks:
// fewer workspace rows to sum); constants, never read from the device
constexpr int kFwdBlocks = 264;
constexpr int kBwdBlocks = 132;
constexpr int kMaxWarps = kStreamThreads / 32;

struct Plan {
  int route;
  int tpr;         // threads a row (whole warps)
  int per;         // packs a thread a row (0 on the streamed route)
  int slots;       // rows in flight in a block
  int rps;         // rows a slot takes, one after another
  int blocks;
};

inline int ceil_div(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}

inline int vec_width(int dtype) { return dtype == DS_DTYPE_BF16 ? 8 : 4; }

// The launch of kernel A (backward = false) or D for x [rows, hidden] of
// dtype `dtype`; `aligned`: every tensor the kernel reads or writes by
// rows (and gamma, beta) starts on 16 bytes.
inline Plan plan(int rows, int hidden, int dtype, bool aligned, bool backward) {
  Plan p{};
  const int vec = vec_width(dtype);
  int n, cap;
  if (aligned && hidden % vec == 0) {
    p.route = kVector;
    n = hidden / vec;
    cap = kVectorCap;
  } else {
    p.route = kScalar;
    n = hidden;
    cap = kScalarCap;
  }
  const int warps = ceil_div(n, 32LL * cap);
  if (warps * 32 > kMaxRowThreads) {
    p.route = kStreamed;
    p.tpr = kStreamThreads;
    p.per = 0;
  } else {
    p.tpr = warps * 32;
    p.per = ceil_div(n, p.tpr);
    if (p.route == kScalar) {
      int pow2 = 1;
      while (pow2 < p.per) pow2 *= 2;
      p.per = pow2;
    }
  }
  const int max_slots = p.tpr < kSlotThreads ? kSlotThreads / p.tpr : 1;
  const int spread = backward ? kBwdBlocks : kFwdBlocks;
  p.slots = rows < 1 ? 1 : ceil_div(rows, spread);
  if (p.slots > max_slots) p.slots = max_slots;
  p.rps = rows < 1 ? 1 : ceil_div(rows, 1LL * p.slots * spread);
  p.blocks = rows < 1 ? 0 : ceil_div(rows, 1LL * p.slots * p.rps);
  return p;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The int32 array a launch passes (ops/normalize.py _launch, one per shape
// on the host): the shape, the dtype codes of x and of gamma, and the plan
// the wrapper made, which the launchers hold to their own.
enum LaunchField { kRows, kHidden, kDtype, kParamDtype, kRoute, kThreadsPerRow, kRowsPerBlock,
                   kBlocks };

// The launch's plan, or false when its shape is empty or the wrapper's plan
// is not the one plan() makes for it.
inline bool launch_plan(const int* launch, bool aligned, bool backward, Plan& p) {
  if (launch[kRows] < 1 || launch[kHidden] < 1) return false;
  p = plan(launch[kRows], launch[kHidden], launch[kDtype], aligned, backward);
  return p.route == launch[kRoute] && p.tpr == launch[kThreadsPerRow] &&
         p.slots * p.rps == launch[kRowsPerBlock] && p.blocks == launch[kBlocks];
}

// Calls f(vec, per) with std::integral_constant arguments for the plan's
// instantiation: the vector route's 16-byte packs (per 1..4), the scalar
// route's (1, 2, 4, 8, 16), or (1, 0) for the streamed route.
template <typename T, typename F>
int dispatch(const Plan& p, F&& f) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  using std::integral_constant;
  if (p.route == kVector) {
    switch (p.per) {
      case 1: return f(integral_constant<int, V>(), integral_constant<int, 1>());
      case 2: return f(integral_constant<int, V>(), integral_constant<int, 2>());
      case 3: return f(integral_constant<int, V>(), integral_constant<int, 3>());
      case 4: return f(integral_constant<int, V>(), integral_constant<int, 4>());
    }
  } else if (p.route == kScalar) {
    switch (p.per) {
      case 1: return f(integral_constant<int, 1>(), integral_constant<int, 1>());
      case 2: return f(integral_constant<int, 1>(), integral_constant<int, 2>());
      case 4: return f(integral_constant<int, 1>(), integral_constant<int, 4>());
      case 8: return f(integral_constant<int, 1>(), integral_constant<int, 8>());
      case 16: return f(integral_constant<int, 1>(), integral_constant<int, 16>());
    }
  } else if (p.route == kStreamed) {
    return f(integral_constant<int, 1>(), integral_constant<int, 0>());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// N contiguous elements of T held in registers as raw 32-bit words (bf16
// and fp16 two a word), loaded in one access: 16 bytes (or 32 as two, 8,
// 4, 2).  x is bf16 or fp32; gamma and beta are also fp16 in an fp16 run.
template <typename T, int N>
struct Pack {
  static constexpr int kBytes = N * static_cast<int>(sizeof(T));
  static constexpr int kWords = kBytes < 4 ? 1 : kBytes / 4;
  uint32_t w[kWords];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0u;
  }

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kBytes >= 16) {
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + i);
        w[4 * i] = u.x;
        w[4 * i + 1] = u.y;
        w[4 * i + 2] = u.z;
        w[4 * i + 3] = u.w;
      }
    } else if constexpr (kBytes == 8) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = u.x;
      w[1] = u.y;
    } else if constexpr (kBytes == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
    }
  }

  // Keeps the compiler from holding the unpacked fp32 copies of the pack
  // from one pass over the row to the next: after pin() it must unpack the
  // raw words again (an instruction an element), so only the raw words (half
  // the registers in bf16) stay live between the row's sums.
  __device__ __forceinline__ void pin() {
#pragma unroll
    for (int i = 0; i < kWords; ++i) asm volatile("" : "+r"(w[i]));
  }

  // element i as fp32 (i a constant after unrolling)
  __device__ __forceinline__ float get(int i) const {
    if constexpr (std::is_same<T, float>::value) {
      return __uint_as_float(w[i]);
    } else if constexpr (std::is_same<T, __half>::value) {
      const unsigned int bits = i % 2 ? w[i / 2] >> 16 : w[i / 2] & 0xffffu;
      return __half2float(__ushort_as_half(static_cast<unsigned short>(bits)));
    } else {
      return __uint_as_float(i % 2 ? w[i / 2] & 0xffff0000u : w[i / 2] << 16);
    }
  }
};

// N fp32 values into N contiguous elements of T at p, one access (16 bytes
// for N * sizeof(T) == 16; N == 1 a scalar).
template <typename T, int N>
__device__ __forceinline__ void store_pack(T* p, const float (&v)[N]) {
  if constexpr (N == 1) {
    p[0] = ds_from_float<T>(v[0]);
  } else if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else {
    static_assert(N % 8 == 0, "bf16 packs are stored 16 bytes at a time");
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      uint32_t u[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        __nv_bfloat162 h = __floats2bfloat162_rn(v[8 * i + 2 * k], v[8 * i + 2 * k + 1]);
        u[k] = *reinterpret_cast<uint32_t*>(&h);
      }
      reinterpret_cast<uint4*>(p)[i] = make_uint4(u[0], u[1], u[2], u[3]);
    }
  }
}

// The thread's place in its block: which row slot, which thread of the row.
struct Lane {
  int slot, t, warp, lane, wpr;
  __device__ __forceinline__ explicit Lane(int tpr)
      : slot(threadIdx.x / tpr), t(threadIdx.x % tpr), warp((threadIdx.x % tpr) / 32),
        lane(threadIdx.x % 32), wpr(tpr / 32) {}
};

// Sums v over the threads of a row: a warp's lanes by xor shuffles (every
// lane ends with the same sum), then, when the row spans several warps, the
// warps' sums in warp order through red (slots * wpr * NV floats).  Every
// thread of the row gets the same value.  With several warps a row it is a
// block barrier, so every thread of the block makes the same calls; each
// call site of a row's loop passes its own `red`, which one barrier a call
// then keeps safe to reuse on the next row.
template <int NV>
__device__ __forceinline__ void row_sum(float (&v)[NV], float* red, const Lane& l) {
#pragma unroll
  for (int k = 0; k < NV; ++k) v[k] = ds_warp_sum(v[k]);
  if (l.wpr == 1) return;
  float* mine = red + l.slot * l.wpr * NV;
  if (l.lane == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) mine[l.warp * NV + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NV; ++k) v[k] = 0.f;
  for (int w = 0; w < l.wpr; ++w) {
#pragma unroll
    for (int k = 0; k < NV; ++k) v[k] += mine[w * NV + k];
  }
}

// A row's statistics from the thread's packs: mean, then the mean of the
// squared deviations over the columns < hidden, rstd = rsqrt(var + eps).
template <typename T, int VEC, int PER>
__device__ __forceinline__ void pin(Pack<T, VEC> (&p)[PER]) {
#pragma unroll
  for (int j = 0; j < PER; ++j) p[j].pin();
}

template <typename T, int VEC, int PER>
__device__ __forceinline__ void row_stats(Pack<T, VEC> (&xp)[PER], int hidden, int tpr,
                                          const Lane& l, float eps, float* red_mean,
                                          float* red_var, float& mean, float& rstd) {
  const float inv_n = 1.f / hidden;
  float s[1] = {0.f};
#pragma unroll
  for (int j = 0; j < PER; ++j) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) s[0] += xp[j].get(e);
  }
  row_sum(s, red_mean, l);
  mean = s[0] * inv_n;
  pin(xp);
  float q[1] = {0.f};
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    if ((j * tpr + l.t) * VEC < hidden) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = xp[j].get(e) - mean;
        q[0] += d * d;
      }
    }
  }
  row_sum(q, red_var, l);
  rstd = rsqrtf(q[0] * inv_n + eps);
  pin(xp);
}

// The thread's packs of gamma (or beta), in their own dtype; zero past hidden.
template <typename P, int VEC, int PER>
__device__ __forceinline__ void load_params(Pack<P, VEC> (&pp)[PER], const P* p, int hidden,
                                            int tpr, int t) {
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = (j * tpr + t) * VEC;
    if (c < hidden) pp[j].load(p + c);
    else pp[j].zero();
  }
}

// The thread's packs of row r of a [rows, hidden] tensor; zero past hidden
// and for a row past the end (live false).
template <typename T, int VEC, int PER>
__device__ __forceinline__ void load_row(Pack<T, VEC> (&xp)[PER], const T* base, int hidden,
                                         int tpr, int t, bool live) {
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = (j * tpr + t) * VEC;
    if (live && c < hidden) xp[j].load(base + c);
    else xp[j].zero();
  }
}

// cp.async: 16 bytes from global to shared, or 16 zero bytes when !valid
// (src is then not read, but must be a valid address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Sum over a streamed row's columns c = t, t + tpr, ... of f(c), then over
// the row (the streamed route: one row a block).
template <int NV, typename F>
__device__ __forceinline__ void streamed_sum(float (&v)[NV], int hidden, const Lane& l, int tpr,
                                             float* red, F&& f) {
#pragma unroll
  for (int k = 0; k < NV; ++k) v[k] = 0.f;
  for (int c = l.t; c < hidden; c += tpr) f(c, v);
  row_sum(v, red, l);
}

}  // namespace ds_ln
