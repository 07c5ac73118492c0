// Fused decimating FIR + quadrature demodulator for NVIDIA Hopper (sm_90a),
// bound through a plain C interface (ops/cuda_kernels.py loads it with ctypes).
//
// Replaces fir_demod_planar_pallas / _fir_demod_planar_kernel of
// gnuradio4_tpu/ops/pallas_kernels.py (:244-410, pallas_call :391; reached
// through ops/fir.py fir_quad_demod_fused).
//
// What it computes, per channel c, over the history-prefixed complex stream
// xc[c][0 .. T+K-1):
//   v[m]    = sum_k h[k] * xc[m*decim + K-1 - k]          (m < M = T / decim)
//   y[c][m] = gain * atan2(Im d, Re d),  d = v[m] * conj(v[m-1])
// with v[-1] = prev[c], the last FIR output of the previous chunk. Only y is
// written: the complex FIR output never goes to device memory.
//
// What bounds it (one H100 SXM: 67 TFLOP/s FP32, 3.35 TB/s HBM; the FIR's
// MACs plus 6 FLOPs of the conjugate product per output, atan2 not counted,
// against the stream read once and 4 bytes written per output):
// - c64 x f32 taps, K 127, decim 1, T 2^22 (Path A's channel FIR): 2.16 GFLOP
//   against 50 MB, FP32 bound (0.032 ms);
// - c64 x c64 taps, K 127, decim 1, T 2^23: 8.57 GFLOP against 101 MB, FP32
//   bound (0.128 ms);
// - c64 x f32 taps, K 127, decim 4, T 2^22: 0.54 GFLOP against 37.7 MB, HBM
//   bound (0.011 ms).
// So at decim 1 the FIR's FMA rate is the limit, as in fir_banded.cu; the
// demod adds about 30 instructions per output against 254 (f32 taps) or
// 508 (complex taps) FMAs.
//
// Design. The FIR is fir_banded.cu's: the register-blocked polyphase tile
// loop of fir_common.cuh (TileLoop: min(decim, K) phase planes staged with
// 16-byte loads, a ring of kR samples in registers per thread, taps and
// planes in chunks when they do not fit, tiles of every channel in grid x),
// so it takes every shape fir_banded takes. The demod is the tile's
// epilogue, on the kR outputs v[m .. m+kR) each thread holds in registers:
// d for r >= 1 from registers, for r = 0 from the previous thread's last
// output through shared memory. Tiles overlap by one output: a tile after
// the first starts its FIR one output before its first demod output, so
// every v[m-1] it needs is its own (1 recomputed output in n = 7 * blockDim.x
// per tile); tile 0 of a channel takes prev[c]. The f32 outputs go through
// shared memory and leave coalesced. atan2f is CUDA's (the TPU kernel's
// polynomial exists only because Mosaic has no atan2). At decim 1 each v[m]
// is one FMA chain in tap order, as in the direct-form loop this replaced.
//
// What is left: fir_banded.cu's limits, since the FIR is its loop. With f32
// taps the shared-memory pipe runs nearly as hard as the FMA pipe (2*kR FMAs
// per float2 sample load); at decim 4 a block stages its planes, then
// computes, so HBM idles while the MACs run; staging is not overlapped with
// the MACs inside a block (cp.async double-buffering would do it).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fir_common.cuh"

namespace {

using namespace gr4fir;

// Asks for four blocks of 256 threads per SM. Both instantiations fit four
// without it (64 registers); with it ptxas schedules them in 63, which ran
// faster on an H100 at the three timed shapes.
template <typename H>
__global__ void __launch_bounds__(kMaxThreads, 4)
fir_demod_kernel(const float2* __restrict__ xc, const H* __restrict__ taps,
                 const float2* __restrict__ prev, float* __restrict__ y,
                 const Plan pl, float gain) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TileLoop<float2, H> loop(smem, pl, taps);
  // after the last stage: the tile's demod outputs, then each thread's last
  // FIR output (4n + 8n/kR bytes, inside the n float2 the planner reserves)
  float* s_y = reinterpret_cast<float*>(loop.s_x);
  float2* s_last = reinterpret_cast<float2*>(s_y + pl.n);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int64_t row = pl.T + pl.K - 1;

  const int64_t n_tiles = pl.channels * pl.tiles;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t c = tile / pl.tiles;
    // demod outputs [first, end); the FIR's from m0, one earlier after tile 0
    const int64_t first = (tile - c * pl.tiles) * (pl.n - 1);
    const int64_t end = pl.M - first < pl.n - 1 ? pl.M : first + pl.n - 1;
    const int64_t m0 = first > 0 ? first - 1 : 0;
    const float2* xrow = xc + c * row;
    float2 v[kR];
    loop.run(v, xrow + (pl.K - 1), xrow, m0);
    __syncthreads();
    s_last[tid] = v[kR - 1];
    __syncthreads();
    // v[m0 + tid*kR - 1]: the previous thread's last, or prev for v[-1]
    float2 p = tid > 0 ? s_last[tid - 1] : prev[c];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      // d = v[r]·conj(p), each part one FMA over a rounded product: the
      // contraction the direct-form kernel this replaced got from nvcc
      const float re = fmaf(v[r].y, p.y, __fmul_rn(v[r].x, p.x));
      const float im = fmaf(v[r].y, p.x, -__fmul_rn(v[r].x, p.y));
      s_y[tid * kR + r] = atan2f(im, re) * gain;
      p = v[r];
    }
    __syncthreads();
    float* yrow = y + c * pl.M;
    for (int64_t m = first + tid; m < end; m += nt) yrow[m] = s_y[m - m0];
  }
}

template <typename H>
int launch(const void* xc, const void* taps, const void* prev, void* y,
           int64_t channels, int64_t T, int K, int decim, float gain,
           cudaStream_t stream) {
  if (channels < 0 || T < 0 || K < 1 || decim < 1) return int(cudaErrorInvalidValue);
  if (T / decim == 0 || channels == 0) return int(cudaSuccess);
  const Launch L = plan<float2, H, float2>(channels, T, K, decim, 1);
  fir_demod_kernel<H><<<L.grid, L.threads, L.smem, stream>>>(
      static_cast<const float2*>(xc), static_cast<const H*>(taps),
      static_cast<const float2*>(prev), static_cast<float*>(y), L.pl, gain);
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
