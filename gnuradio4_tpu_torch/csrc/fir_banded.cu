// Decimating direct-form FIR for NVIDIA Hopper (sm_90a), bound through a plain
// C interface (ops/cuda_kernels.py loads it with ctypes).
//
// Replaces the two FIR kernels of gnuradio4_tpu/ops/pallas_kernels.py:
// fir_planar_pallas (planar re/im rails) and fir_ilv_pallas (interleaved f32
// view). torch stores complex64 interleaved, so one kernel reading float2 takes
// the place of both.
//
// What it computes, per channel c, over the history-prefixed stream
//   xc[j] = j < K-1 ? hist[c][j] : x[c][j-(K-1)]      (length T + K - 1)
//   y[c][m] = sum_k h[k] * xc[m*decim + K-1 - k]       for m < M = T / decim
// i.e. outputs on the decimated grid aligned to the first input sample, as
// gnuradio4_tpu/ops/fir.py fir_apply frames them.
//
// Design. The TPU kernels build a banded Toeplitz matrix so the FIR runs on a
// 128x128 matrix unit at about twice the multiply-adds. Here the FIR runs in
// direct form on the CUDA cores: each block stages its input span (its outputs'
// samples plus the K-1 halo) and the reversed taps in shared memory once, and
// each thread keeps kFirOutPerThread outputs in registers, one f32 FMA chain
// each (the tile loop of fir_common.cuh, shared with fir_demod.cu).
//
// What bounds it. At the chain's shapes (K = 127, complex stream x complex
// taps, decim 1) each output costs K complex MACs = 4K = 508 FMAs (~1 kflop)
// against 16 bytes of HBM traffic (one float2 read, one written), so the
// kernel is bound by FP32 issue and shared-memory load bandwidth, not by HBM:
// every MAC reads one float2 from shared memory. Register-blocking the input
// window (or a wgmma formulation) is the lever for later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fir_common.cuh"

namespace {

using namespace gr4fir;

// X: stream sample (float | float2), H: tap (float | float2),
// Y: output (float2 when either is complex, else float).
template <typename X, typename H, typename Y>
__global__ void __launch_bounds__(kFirThreads)
fir_banded_kernel(const X* __restrict__ x, const X* __restrict__ hist,
                  const H* __restrict__ taps, Y* __restrict__ y,
                  int64_t T, int K, int decim, int64_t M, int out_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  H* s_h = reinterpret_cast<H*>(smem);
  X* s_x = reinterpret_cast<X*>(smem + align16(size_t(K) * sizeof(H)));

  const int64_t c = blockIdx.y;
  const X* xrow = x + c * T;
  const X* hrow = hist + c * int64_t(K - 1);
  Y* yrow = y + c * M;

  const int64_t m0 = int64_t(blockIdx.x) * out_per_block;
  const int n_out = M - m0 < out_per_block ? int(M - m0) : out_per_block;
  const int span = (n_out - 1) * decim + K;

  stage_reversed_taps(s_h, taps, K);
  stage_span(s_x, span, m0 * decim, [&](int64_t g) {
    if (g < K - 1) return hrow[g];
    const int64_t t = g - (K - 1);
    return t < T ? xrow[t] : zero<X>();
  });
  __syncthreads();
  fir_direct<X, H, Y>(s_x, s_h, K, decim, n_out,
                      [&](int o, Y v) { yrow[m0 + o] = v; });
}

template <typename X, typename H, typename Y>
int launch(const void* x, const void* hist, const void* taps, void* y,
           int64_t channels, int64_t T, int K, int decim, cudaStream_t stream) {
  if (channels < 0 || T < 0 || K < 1 || decim < 1) return int(cudaErrorInvalidValue);
  const int64_t M = T / decim;
  if (M == 0 || channels == 0) return int(cudaSuccess);
  if (channels > 65535) return int(cudaErrorInvalidValue);
  auto smem_bytes = [&](int opb) {
    return align16(size_t(K) * sizeof(H)) + (size_t(opb - 1) * decim + K) * sizeof(X);
  };
  const int opb = outputs_per_block(smem_bytes);
  const size_t smem = smem_bytes(opb);
  if (smem > kSmemMax) return int(cudaErrorInvalidValue);
  auto kernel = fir_banded_kernel<X, H, Y>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  const dim3 grid(unsigned((M + opb - 1) / opb), unsigned(channels));
  kernel<<<grid, kFirThreads, smem, stream>>>(
      static_cast<const X*>(x), static_cast<const X*>(hist),
      static_cast<const H*>(taps), static_cast<Y*>(y), T, K, decim, M, opb);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: [channels, T], hist: [channels, K-1], taps: [K], y: [channels, T/decim];
// all contiguous on the device. Returns a cudaError_t (0 on success).
int gr4_fir_banded(const void* x, const void* hist, const void* taps, void* y,
                   int64_t channels, int64_t T, int K, int decim,
                   int x_complex, int taps_complex, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_complex && taps_complex)
    return launch<float2, float2, float2>(x, hist, taps, y, channels, T, K, decim, s);
  if (x_complex)
    return launch<float2, float, float2>(x, hist, taps, y, channels, T, K, decim, s);
  if (taps_complex)
    return launch<float, float2, float2>(x, hist, taps, y, channels, T, K, decim, s);
  return launch<float, float, float>(x, hist, taps, y, channels, T, K, decim, s);
}

const char* gr4_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
