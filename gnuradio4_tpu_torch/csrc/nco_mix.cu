// Integer-NCO complex mixer for NVIDIA Hopper (sm_90a), bound through a plain
// C interface (ops/cuda_kernels.py loads it with ctypes).
//
// Replaces gnuradio4_tpu/ops/pallas_kernels.py nco_mix_pallas / nco_mix_kernel:
//   y[c][n] = x[c][n] * exp(j * 2*pi * ((phase0 + n*dphi) mod 2^32) / 2^32)
// The phase wraps in native uint32; the angle is float(phase) * f32(2*pi) * 2^-32,
// the same f32 rounding of the phase as the JAX package's phase_to_frac, and the
// rotator is sincosf (full precision: the build does not use fast math).
//
// What bounds it. One float2 read and one written per sample (16 bytes) against
// one sincosf and a complex multiply, so HBM bandwidth bounds it at large T; the
// grid-stride loop keeps enough loads in flight to fill the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
nco_mix_kernel(const float2* __restrict__ x, float2* __restrict__ y,
               int64_t total, int64_t T, uint32_t phase0, uint32_t dphi) {
  const float kAngle = 6.28318530717958647692f * 2.3283064365386962890625e-10f;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const uint32_t n = uint32_t(i % T);
    const uint32_t ph = phase0 + n * dphi;  // mod 2^32
    float s, c;
    sincosf(float(ph) * kAngle, &s, &c);
    const float2 v = x[i];
    y[i] = make_float2(v.x * c - v.y * s, v.x * s + v.y * c);
  }
}

}  // namespace

extern "C" {

// x, y: [channels, T] complex64 (interleaved float2), contiguous on the device.
// Every channel starts at phase0. Returns a cudaError_t (0 on success).
int gr4_nco_mix(const void* x, void* y, int64_t total, int64_t T,
                uint32_t phase0, uint32_t dphi, void* stream) {
  if (total < 0 || T < 1 || T > int64_t(UINT32_MAX)) return int(cudaErrorInvalidValue);
  if (total == 0) return int(cudaSuccess);
  int64_t blocks = (total + kThreads - 1) / kThreads;
  const int64_t max_blocks = 132 * 16;  // a few waves of resident blocks per SM
  if (blocks > max_blocks) blocks = max_blocks;
  nco_mix_kernel<<<unsigned(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), total, T, phase0, dphi);
  return int(cudaGetLastError());
}

}  // extern "C"
