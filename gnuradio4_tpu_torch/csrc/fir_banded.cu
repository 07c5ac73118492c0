// Decimating FIR for NVIDIA Hopper (sm_90a), bound through a plain C
// interface (ops/cuda_kernels.py loads it with ctypes).
//
// Replaces the two FIR kernels of gnuradio4_tpu/ops/pallas_kernels.py:
// fir_planar_pallas (:413-453, planar re/im rails) and fir_ilv_pallas
// (:167-205, interleaved f32 view). torch stores complex64 interleaved, so one
// kernel reading float2 takes the place of both.
//
// What it computes, per channel c, over the history-prefixed stream
//   xc[j] = j < K-1 ? hist[c][j] : x[c][j-(K-1)]      (length T + K - 1)
//   y[c][m] = sum_k h[k] * xc[m*decim + K-1 - k]       for m < M = T / decim.
//
// Design. The register-blocked polyphase tile loop of fir_common.cuh
// (TileLoop and its planner; its design notes are there), shared with
// fir_demod.cu. Each block walks its tiles; the epilogue here stores a
// tile's outputs through shared memory, so the block writes them coalesced.
// Overlap of staging with the MACs comes from several resident blocks per
// SM: the build's -Xptxas -v report gives 64 registers a thread for c64 x
// c64 (four blocks of 256 threads per SM), 73 to 93 for the others (three or
// two).
//
// What bounds it (one H100 SXM: 67 TFLOP/s FP32, 3.35 TB/s HBM; bounds count
// each input read once and each output written once):
// - c64 x c64 taps, K 127, decim 1, T 2^23: 8.52 GFLOP against 134 MB, FP32
//   bound (0.127 ms): 4*kR FMAs per sample load and per tap load.
// - c64 x f32 taps, K 127, decim 1 (the derotated chain, config 1): 4.26 GFLOP
//   per 2^23, FP32 bound (0.064 ms): 2*kR FMAs per sample load, so the
//   shared-memory pipe (two wavefronts per float2 load) runs close behind.
// - f32 x f32 taps, K 63, decim 8 (the chain's audio FIR) and K 127, decim 5
//   (Path A's): 37.7 MB and 20.1 MB against 0.13 and 0.21 GFLOP, HBM bound
//   (0.011 and 0.006 ms). There the instructions per sample (staging
//   scatter, ring prologue per plane) and one wave of blocks that stage and
//   then compute keep the kernel at a third to a half of the bound.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fir_common.cuh"

namespace {

using namespace gr4fir;

// The kernel's body: a grid-stride walk over the tiles of every channel.
template <typename X, typename H, typename Y>
__device__ __forceinline__ void banded_tiles(const X* __restrict__ x,
                                             const X* __restrict__ hist,
                                             const H* __restrict__ taps,
                                             Y* __restrict__ y, const Plan& pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TileLoop<X, H> loop(smem, pl, taps);
  Y* s_y = reinterpret_cast<Y*>(loop.s_x);      // after the last stage
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  const int64_t n_tiles = pl.channels * pl.tiles;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t c = tile / pl.tiles;
    const int64_t m0 = (tile - c * pl.tiles) * pl.n;
    const int n_out = int(pl.M - m0 < pl.n ? pl.M - m0 : pl.n);
    Y acc[kR];
    loop.run(acc, x + c * pl.T, hist + c * int64_t(pl.K - 1), m0);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kR; ++r) s_y[tid * kR + r] = acc[r];
    __syncthreads();
    Y* yrow = y + c * pl.M + m0;
    for (int o = tid; o < n_out; o += nt) yrow[o] = s_y[o];
  }
}

template <typename X, typename H, typename Y>
__global__ void __launch_bounds__(kMaxThreads)
fir_banded_kernel(const X* __restrict__ x, const X* __restrict__ hist,
                  const H* __restrict__ taps, Y* __restrict__ y, const Plan pl) {
  banded_tiles(x, hist, taps, y, pl);
}

// f32 x f32 (the audio FIRs, HBM bound) held to three blocks of 256 threads
// per SM (at most 85 registers). Left to itself, the compiler gives the
// shared loop 113 registers here (two blocks per SM), which ran slower on an
// H100 at the chain's and Path A's shapes; asking the same of the other
// three instantiations raises their registers instead.
__global__ void __launch_bounds__(kMaxThreads, 3)
fir_banded_real_kernel(const float* __restrict__ x, const float* __restrict__ hist,
                       const float* __restrict__ taps, float* __restrict__ y,
                       const Plan pl) {
  banded_tiles(x, hist, taps, y, pl);
}

template <typename X, typename H, typename Y>
auto kernel_of() { return fir_banded_kernel<X, H, Y>; }
template <>
auto kernel_of<float, float, float>() { return fir_banded_real_kernel; }

template <typename X, typename H, typename Y>
int launch(const void* x, const void* hist, const void* taps, void* y,
           int64_t channels, int64_t T, int K, int decim, cudaStream_t stream) {
  if (channels < 0 || T < 0 || K < 1 || decim < 1) return int(cudaErrorInvalidValue);
  if (T / decim == 0 || channels == 0) return int(cudaSuccess);
  const Launch L = plan<X, H, Y>(channels, T, K, decim, 0);
  const auto kernel = kernel_of<X, H, Y>();
  kernel<<<L.grid, L.threads, L.smem, stream>>>(
      static_cast<const X*>(x), static_cast<const X*>(hist),
      static_cast<const H*>(taps), static_cast<Y*>(y), L.pl);
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
