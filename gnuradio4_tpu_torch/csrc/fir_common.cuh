// Direct-form FIR tile loop shared by fir_banded.cu and fir_demod.cu.
//
// A block stages the reversed taps and its span of the history-prefixed
// stream in shared memory once; each thread then keeps kFirOutPerThread
// outputs in registers, one f32 FMA chain each. Neighbouring threads own
// neighbouring outputs, so for decim 1 their shared loads hit neighbouring
// banks; the taps are a broadcast read.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gr4fir {

constexpr int kFirThreads = 256;
constexpr int kFirOutPerThread = 4;
constexpr size_t kSmemBudget = 48 * 1024;         // keep several blocks per SM
constexpr size_t kSmemMax = 227 * 1024;           // Hopper per-block limit

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ float2 zero<float2>() {
  return make_float2(0.f, 0.f);
}

// acc += h * x for every (tap, sample) type pair the FIR takes.
__device__ __forceinline__ void mac(float& acc, float h, float x) {
  acc = fmaf(h, x, acc);
}
__device__ __forceinline__ void mac(float2& acc, float h, float2 x) {
  acc.x = fmaf(h, x.x, acc.x);
  acc.y = fmaf(h, x.y, acc.y);
}
__device__ __forceinline__ void mac(float2& acc, float2 h, float x) {
  acc.x = fmaf(h.x, x, acc.x);
  acc.y = fmaf(h.y, x, acc.y);
}
__device__ __forceinline__ void mac(float2& acc, float2 h, float2 x) {
  acc.x = fmaf(h.x, x.x, acc.x);
  acc.x = fmaf(-h.y, x.y, acc.x);
  acc.y = fmaf(h.x, x.y, acc.y);
  acc.y = fmaf(h.y, x.x, acc.y);
}

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// s_h[j] = taps[K-1-j], so that y[m] = sum_j s_h[j] * xc[m*decim + j].
template <typename H>
__device__ __forceinline__ void stage_reversed_taps(H* s_h, const H* taps, int K) {
  for (int j = threadIdx.x; j < K; j += blockDim.x) s_h[j] = taps[K - 1 - j];
}

// s_x[j] = at(g0 + j) for j < span; `at` maps an index of the
// history-prefixed stream to its sample.
template <typename X, typename At>
__device__ __forceinline__ void stage_span(X* s_x, int span, int64_t g0, At at) {
  for (int j = threadIdx.x; j < span; j += blockDim.x) s_x[j] = at(g0 + j);
}

// Outputs j < n of the staged span: sum_i s_h[i] * s_x[j*decim + i], handed
// to store(j, value). Expects blockDim.x == kFirThreads.
template <typename X, typename H, typename Y, typename Store>
__device__ __forceinline__ void fir_direct(const X* s_x, const H* s_h, int K,
                                           int decim, int n, Store store) {
  for (int base = 0; base < n; base += kFirThreads * kFirOutPerThread) {
    Y acc[kFirOutPerThread];
    const X* px[kFirOutPerThread];
#pragma unroll
    for (int r = 0; r < kFirOutPerThread; ++r) {
      acc[r] = zero<Y>();
      // outputs past n compute on a valid row and are not stored
      const int o = min(base + int(threadIdx.x) + r * kFirThreads, n - 1);
      px[r] = s_x + o * decim;
    }
    for (int j = 0; j < K; ++j) {
      const H hj = s_h[j];
#pragma unroll
      for (int r = 0; r < kFirOutPerThread; ++r) mac(acc[r], hj, px[r][j]);
    }
#pragma unroll
    for (int r = 0; r < kFirOutPerThread; ++r) {
      const int o = base + int(threadIdx.x) + r * kFirThreads;
      if (o < n) store(o, acc[r]);
    }
  }
}

// Largest outputs-per-block (a power-of-two fraction of one pass of the
// block, at least 32) whose shared memory fits the budget.
template <typename SmemBytes>
inline int outputs_per_block(SmemBytes smem_bytes) {
  int opb = kFirThreads * kFirOutPerThread;
  while (opb > 32 && smem_bytes(opb) > kSmemBudget) opb /= 2;
  return opb;
}

}  // namespace gr4fir
