// Fused decimating FIR + quadrature demodulator for NVIDIA Hopper (sm_90a),
// bound through a plain C interface (ops/cuda_kernels.py loads it with ctypes).
//
// Replaces fir_demod_planar_pallas / _fir_demod_planar_kernel of
// gnuradio4_tpu/ops/pallas_kernels.py (reached through ops/fir.py
// fir_quad_demod_fused).
//
// What it computes, per channel c, over the history-prefixed complex stream
// xc[c][0 .. T+K-1):
//   v[m]    = sum_k h[k] * xc[m*decim + K-1 - k]          (m < M = T / decim)
//   y[c][m] = gain * atan2(Im d, Re d),  d = v[m] * conj(v[m-1])
// with v[-1] = prev[c], the last FIR output of the previous chunk. Only y is
// written: the complex FIR output never goes to device memory.
//
// Design. Each block computes its tile of FIR outputs with the direct-form
// loop of fir_common.cuh (the same loop as fir_banded.cu) into shared memory,
// together with the one output just before the tile, computed from the staged
// halo (the TPU kernel instead recomputes it with a banded matvec of the
// previous program's last input row). Tile 0 takes the carried prev instead.
// The demod epilogue then reads neighbouring outputs from shared memory and
// writes one float per output. atan2f is CUDA's (the TPU kernel's polynomial
// exists only because Mosaic has no atan2).
//
// What bounds it. As for fir_banded: each output costs K complex-by-real (or
// complex) MACs against 8 bytes read and 4 written, so FP32 issue and the
// shared-memory load per MAC bound it, not HBM. Fusing saves the 8-byte
// complex write and re-read of the unfused FIR -> demod pair, and the demod's
// elementwise passes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fir_common.cuh"

namespace {

using namespace gr4fir;

template <typename H>
__global__ void __launch_bounds__(kFirThreads)
fir_demod_kernel(const float2* __restrict__ xc, const H* __restrict__ taps,
                 const float2* __restrict__ prev, float* __restrict__ y,
                 int64_t T, int K, int decim, int64_t M, int out_per_block,
                 float gain) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t m0 = int64_t(blockIdx.x) * out_per_block;
  const int n_out = M - m0 < out_per_block ? int(M - m0) : out_per_block;
  // outputs m0-1 .. m0+n_out-1: n_out + 1 of them
  const int span = n_out * decim + K;
  H* s_h = reinterpret_cast<H*>(smem);
  float2* s_x = reinterpret_cast<float2*>(smem + align16(size_t(K) * sizeof(H)));
  float2* s_v = reinterpret_cast<float2*>(
      smem + align16(size_t(K) * sizeof(H)) + align16(size_t(span) * sizeof(float2)));

  const int64_t c = blockIdx.y;
  const int64_t tc = T + K - 1;
  const float2* row = xc + c * tc;
  float* yrow = y + c * M;

  stage_reversed_taps(s_h, taps, K);
  // tile 0 stages from index -decim: its output -1 is never used
  stage_span(s_x, span, (m0 - 1) * decim, [&](int64_t g) {
    return (g >= 0 && g < tc) ? row[g] : zero<float2>();
  });
  __syncthreads();
  fir_direct<float2, H, float2>(s_x, s_h, K, decim, n_out + 1,
                                [&](int j, float2 v) { s_v[j] = v; });
  __syncthreads();

  for (int j = threadIdx.x; j < n_out; j += blockDim.x) {
    const float2 v = s_v[j + 1];
    const float2 p = (j == 0 && m0 == 0) ? prev[c] : s_v[j];
    const float re = v.x * p.x + v.y * p.y;
    const float im = v.y * p.x - v.x * p.y;
    yrow[m0 + j] = atan2f(im, re) * gain;
  }
}

template <typename H>
int launch(const void* xc, const void* taps, const void* prev, void* y,
           int64_t channels, int64_t T, int K, int decim, float gain,
           cudaStream_t stream) {
  if (channels < 0 || T < 0 || K < 1 || decim < 1) return int(cudaErrorInvalidValue);
  const int64_t M = T / decim;
  if (M == 0 || channels == 0) return int(cudaSuccess);
  if (channels > 65535) return int(cudaErrorInvalidValue);
  auto smem_bytes = [&](int opb) {
    const size_t span = size_t(opb) * decim + K;
    return align16(size_t(K) * sizeof(H)) + align16(span * sizeof(float2)) +
           size_t(opb + 1) * sizeof(float2);
  };
  // n_out + 1 outputs per block: one short of the loop's pass, so the extra
  // output does not cost a second pass
  const int opb = outputs_per_block(smem_bytes) - 1;
  const size_t smem = smem_bytes(opb);
  if (smem > kSmemMax) return int(cudaErrorInvalidValue);
  auto kernel = fir_demod_kernel<H>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  const dim3 grid(unsigned((M + opb - 1) / opb), unsigned(channels));
  kernel<<<grid, kFirThreads, smem, stream>>>(
      static_cast<const float2*>(xc), static_cast<const H*>(taps),
      static_cast<const float2*>(prev), static_cast<float*>(y), T, K, decim, M,
      opb, gain);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// xc: [channels, T+K-1] complex64, taps: [K] float32 or complex64,
// prev: [channels] complex64, y: [channels, T/decim] float32; all contiguous
// on the device. Returns a cudaError_t (0 on success).
int gr4_fir_demod(const void* xc, const void* taps, const void* prev, void* y,
                  int64_t channels, int64_t T, int K, int decim,
                  int taps_complex, float gain, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (taps_complex)
    return launch<float2>(xc, taps, prev, y, channels, T, K, decim, gain, s);
  return launch<float>(xc, taps, prev, y, channels, T, K, decim, gain, s);
}

}  // extern "C"
