// The FIR kernels' shared pieces: the multiply-add for every (tap, sample)
// type pair (fir_banded.cu, fir_demod.cu), and fir_demod.cu's direct-form
// tile loop.
//
// The loop: a block stages the reversed taps and the samples of its outputs
// in shared memory; each thread then keeps kFirOutPerThread outputs in
// registers, one f32 FMA chain each. Neighbouring threads own neighbouring
// outputs, so for a window stride of 1 their shared loads hit neighbouring
// banks; the taps are a broadcast read.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gr4fir {

constexpr int kFirThreads = 256;
constexpr int kFirOutPerThread = 4;
constexpr size_t kSmemBudget = 48 * 1024;         // keep several blocks per SM

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

// Outputs j < n of the staged windows: sum_i s_h[i] * s_x[j*stride + i],
// handed to store(j, value). Output j's K-sample window starts at j*stride
// (the decimation, or the window length when windows are staged apart).
// Expects blockDim.x == kFirThreads.
template <typename X, typename H, typename Y, typename Store>
__device__ __forceinline__ void fir_direct(const X* s_x, const H* s_h, int K,
                                           int stride, int n, Store store) {
  for (int base = 0; base < n; base += kFirThreads * kFirOutPerThread) {
    Y acc[kFirOutPerThread];
    const X* px[kFirOutPerThread];
#pragma unroll
    for (int r = 0; r < kFirOutPerThread; ++r) {
      acc[r] = zero<Y>();
      // outputs past n compute on a valid row and are not stored
      const int o = min(base + int(threadIdx.x) + r * kFirThreads, n - 1);
      px[r] = s_x + o * stride;
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
// block, at least 1) whose shared memory fits the budget.
template <typename SmemBytes>
inline int outputs_per_block(SmemBytes smem_bytes) {
  int opb = kFirThreads * kFirOutPerThread;
  while (opb > 1 && smem_bytes(opb) > kSmemBudget) opb /= 2;
  return opb;
}

}  // namespace gr4fir
