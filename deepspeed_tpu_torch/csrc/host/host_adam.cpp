// Host-side Adam/AdamW for offloaded optimizer shards.
//
// The PyTorch port's copy of the JAX package's host Adam (csrc/adam/
// host_adam.cpp there), the counterpart of the reference's
// csrc/adam/cpu_adam.cpp (Adam_Optimizer::Step/Step_4/Step_8 with AVX
// intrinsics + OpenMP): the optimizer states of ZeRO-Offload live in host
// DRAM and are stepped here while the GPU runs the next forward.  Instead
// of hand-written intrinsics, the inner loops are written
// restrict-qualified and branch-free so g++ -O3 -march=native
// auto-vectorizes them (AVX-512 on x86, NEON on ARM) — same throughput
// class, no per-ISA code.  The update math is the JAX package's copy's,
// line for line, so both libraries give the same bits.
//
// Where the JAX copy spreads the loop over OpenMP threads, this one splits
// the span into equal contiguous chunks over std::threads (built with
// -pthread, no OpenMP runtime): the toolchain next to the GPU need not ship
// libgomp, and the process holds no second OpenMP runtime beside
// PyTorch's.  Each element's update is independent, so the split does not
// change a bit.
//
// C ABI (consumed via ctypes from deepspeed_tpu_torch/ops/adam/cpu_adam.py):
//   ds_adam_step        — fp32 params/m/v in place
//   ds_adam_step_bf16   — same + round-to-nearest-even bf16 copy-out of the
//                         updated params (the `adam_update_copy` analog:
//                         fused param+device-copy of cpu_adam.cpp:740)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline uint16_t fp32_to_bf16_rne(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, sizeof(bits));
  // NaN-safe round-to-nearest-even (matches XLA's fp32->bf16 cast).
  if ((bits & 0x7fffffffu) > 0x7f800000u) {
    return static_cast<uint16_t>((bits >> 16) | 0x0040u);
  }
  uint32_t rounding_bias = ((bits >> 16) & 1u) + 0x7fffu;
  return static_cast<uint16_t>((bits + rounding_bias) >> 16);
}

// One fused Adam/AdamW update over a contiguous span.
// adamw != 0: decoupled weight decay (AdamW); otherwise L2-into-grad (Adam),
// matching the reference's adamw_mode switch (cpu_adam.h:189).
template <bool kWriteBf16>
void adam_span(float* __restrict p, float* __restrict m, float* __restrict v,
               const float* __restrict g, int64_t n, float alpha, float beta1,
               float beta2, float eps, float weight_decay, float bias_corr1,
               float bias_corr2_sqrt, uint16_t* __restrict p_bf16) {
  const float step_size = alpha / bias_corr1;
  const float one_minus_b1 = 1.0f - beta1;
  const float one_minus_b2 = 1.0f - beta2;
  const float decay_factor =
      (weight_decay > 0.0f) ? (1.0f - alpha * weight_decay) : 1.0f;

  for (int64_t i = 0; i < n; ++i) {
    float grad = g[i];
    float param = p[i];
    float mi = beta1 * m[i] + one_minus_b1 * grad;
    float vi = beta2 * v[i] + one_minus_b2 * grad * grad;
    float denom = std::sqrt(vi) / bias_corr2_sqrt + eps;
    param = param * decay_factor - step_size * (mi / denom);
    m[i] = mi;
    v[i] = vi;
    p[i] = param;
    if (kWriteBf16) {
      p_bf16[i] = fp32_to_bf16_rne(param);
    }
  }
}

template <bool kWriteBf16>
void adam_l2_span(float* __restrict p, float* __restrict m,
                  float* __restrict v, const float* __restrict g, int64_t n,
                  float alpha, float beta1, float beta2, float eps,
                  float weight_decay, float bias_corr1, float bias_corr2_sqrt,
                  uint16_t* __restrict p_bf16) {
  const float step_size = alpha / bias_corr1;
  const float one_minus_b1 = 1.0f - beta1;
  const float one_minus_b2 = 1.0f - beta2;

  for (int64_t i = 0; i < n; ++i) {
    float param = p[i];
    float grad = g[i] + weight_decay * param;  // classic Adam L2
    float mi = beta1 * m[i] + one_minus_b1 * grad;
    float vi = beta2 * v[i] + one_minus_b2 * grad * grad;
    float denom = std::sqrt(vi) / bias_corr2_sqrt + eps;
    param = param - step_size * (mi / denom);
    m[i] = mi;
    v[i] = vi;
    p[i] = param;
    if (kWriteBf16) {
      p_bf16[i] = fp32_to_bf16_rne(param);
    }
  }
}

std::atomic<int> g_num_threads{0};  // 0: the hardware's count

int num_threads() {
  int n = g_num_threads.load();
  if (n <= 0) n = static_cast<int>(std::thread::hardware_concurrency());
  return n > 0 ? n : 1;
}

void span_update(float* p, float* m, float* v, const float* g, int64_t n,
                 float lr, float beta1, float beta2, float eps,
                 float weight_decay, int adamw_mode, float bias_corr1,
                 float bias_corr2_sqrt, uint16_t* p_bf16) {
  if (adamw_mode) {
    if (p_bf16) {
      adam_span<true>(p, m, v, g, n, lr, beta1, beta2, eps, weight_decay,
                      bias_corr1, bias_corr2_sqrt, p_bf16);
    } else {
      adam_span<false>(p, m, v, g, n, lr, beta1, beta2, eps, weight_decay,
                       bias_corr1, bias_corr2_sqrt, nullptr);
    }
  } else {
    if (p_bf16) {
      adam_l2_span<true>(p, m, v, g, n, lr, beta1, beta2, eps, weight_decay,
                         bias_corr1, bias_corr2_sqrt, p_bf16);
    } else {
      adam_l2_span<false>(p, m, v, g, n, lr, beta1, beta2, eps, weight_decay,
                          bias_corr1, bias_corr2_sqrt, nullptr);
    }
  }
}

// Chunks of at least this many elements a thread (a smaller span runs on
// the calling thread alone).
constexpr int64_t kMinChunk = 1 << 16;

void dispatch(float* p, float* m, float* v, const float* g, int64_t n,
              float lr, float beta1, float beta2, float eps,
              float weight_decay, int64_t step, int adamw_mode,
              uint16_t* p_bf16) {
  const float bias_corr1 =
      1.0f - std::pow(beta1, static_cast<float>(step));
  const float bias_corr2_sqrt =
      std::sqrt(1.0f - std::pow(beta2, static_cast<float>(step)));
  const int64_t threads = std::max<int64_t>(
      1, std::min<int64_t>(num_threads(), n / kMinChunk));
  // equal chunks, rounded up to 16 elements (whole vectors)
  const int64_t chunk = ((n + threads - 1) / threads + 15) / 16 * 16;
  auto run = [&](int64_t lo) {
    const int64_t len = std::min(chunk, n - lo);
    if (len <= 0) return;
    span_update(p + lo, m + lo, v + lo, g + lo, len, lr, beta1, beta2, eps,
                weight_decay, adamw_mode, bias_corr1, bias_corr2_sqrt,
                p_bf16 ? p_bf16 + lo : nullptr);
  };
  std::vector<std::thread> pool;
  for (int64_t t = 1; t < threads; ++t) pool.emplace_back(run, t * chunk);
  run(0);
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

void ds_adam_step(float* p, float* m, float* v, const float* g, int64_t n,
                  float lr, float beta1, float beta2, float eps,
                  float weight_decay, int64_t step, int adamw_mode) {
  dispatch(p, m, v, g, n, lr, beta1, beta2, eps, weight_decay, step,
           adamw_mode, nullptr);
}

void ds_adam_step_bf16(float* p, float* m, float* v, const float* g,
                       int64_t n, float lr, float beta1, float beta2,
                       float eps, float weight_decay, int64_t step,
                       int adamw_mode, uint16_t* p_bf16_out) {
  dispatch(p, m, v, g, n, lr, beta1, beta2, eps, weight_decay, step,
           adamw_mode, p_bf16_out);
}

int ds_adam_num_threads() { return num_threads(); }

// The number of threads an update uses (n <= 0: the hardware's count).
void ds_adam_set_num_threads(int n) { g_num_threads.store(n); }

}  // extern "C"
