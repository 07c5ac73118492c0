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
// Phase groups (group_phases in fir_common.cuh decides; the
// fir_banded_grouped_* kernels below). A long decimating filter whose tile
// does not fit the staged loop's 48 KB runs as 8 warps that split the phases
// of one 224-output tile, each warp's partial sums added in the epilogue in
// warp order. At K 963 ÷40, c64 x c64 (fm_monitor's channel filter): 89,920 B
// of dynamic shared memory a block (10,240 B of resident tap slots, 40 planes
// of 249 samples), two blocks of 256 threads an SM (104 registers), a grid of
// the resident blocks walking 5,852 tiles; the opt-in above 48 KB (227 KB) is
// set, and the residency queried, once per process and device (and shape).
// gr4_fir_banded reports the path it took through its groups out-parameter.
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
// - c64 x c64 taps, K 963, decim 40, T 52,428,800 (fm_monitor): 10.10 GFLOP
//   against 419 MB, FP32 bound (0.151 ms) with HBM close behind (0.125 ms).
//   Phase groups: 0.366 ms on an H100 (41% of the bound; the staged loop's
//   plan took 24.9 ms). A block stages its tile (79 KB, a few rounds of
//   16-byte loads) and then computes it; the SM's second block overlaps the
//   two. Double-buffering the next tile with 8-byte cp.async copies at one
//   block an SM ran 0.488 ms.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "fir_common.cuh"

namespace {

using namespace gr4fir;

// The kernel's body: a grid-stride walk over the tiles of every channel.
// kGrouped: the phase-grouped loop (pl.G > 1), whose G partial sums of each
// output are added here, in group order, as the tile is stored.
template <bool kGrouped, typename X, typename H, typename Y>
__device__ __forceinline__ void banded_tiles(const X* __restrict__ x,
                                             const X* __restrict__ hist,
                                             const H* __restrict__ taps,
                                             Y* __restrict__ y, const Plan& pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TileLoop<X, H> loop(smem, pl, taps);
  Y* s_y = reinterpret_cast<Y*>(loop.s_x);      // after the last stage
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int g = kGrouped ? tid / pl.lanes : 0;
  const int lane = kGrouped ? tid - g * pl.lanes : tid;
  if constexpr (kGrouped) loop.stage_resident_taps();

  const int64_t n_tiles = pl.channels * pl.tiles;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t c = tile / pl.tiles;
    const int64_t m0 = (tile - c * pl.tiles) * pl.n;
    const int n_out = int(pl.M - m0 < pl.n ? pl.M - m0 : pl.n);
    Y acc[kR];
    if constexpr (kGrouped)
      loop.run_groups(acc, x + c * pl.T, hist + c * int64_t(pl.K - 1), m0, g, lane);
    else
      loop.run(acc, x + c * pl.T, hist + c * int64_t(pl.K - 1), m0);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kR; ++r) s_y[g * pl.n + lane * kR + r] = acc[r];
    __syncthreads();
    Y* yrow = y + c * pl.M + m0;
    for (int o = tid; o < n_out; o += nt) {
      Y v = s_y[o];
      if constexpr (kGrouped)
        for (int gi = 1; gi < pl.G; ++gi) v = add(v, s_y[gi * pl.n + o]);
      yrow[o] = v;
    }
  }
}

template <typename X, typename H, typename Y>
__global__ void __launch_bounds__(kMaxThreads)
fir_banded_kernel(const X* __restrict__ x, const X* __restrict__ hist,
                  const H* __restrict__ taps, Y* __restrict__ y, const Plan pl) {
  banded_tiles<false>(x, hist, taps, y, pl);
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
  banded_tiles<false>(x, hist, taps, y, pl);
}

// The phase-grouped loop (pl.G > 1): kernels of their own, so that the staged
// loop's kernels keep their names in a trace.
template <typename X, typename H, typename Y>
__global__ void __launch_bounds__(kMaxThreads)
fir_banded_grouped_kernel(const X* __restrict__ x, const X* __restrict__ hist,
                          const H* __restrict__ taps, Y* __restrict__ y, const Plan pl) {
  banded_tiles<true>(x, hist, taps, y, pl);
}

__global__ void __launch_bounds__(kMaxThreads, 3)
fir_banded_grouped_real_kernel(const float* __restrict__ x, const float* __restrict__ hist,
                               const float* __restrict__ taps, float* __restrict__ y,
                               const Plan pl) {
  banded_tiles<true>(x, hist, taps, y, pl);
}

template <typename X, typename H, typename Y, bool kGrouped>
auto kernel_of() {
  if constexpr (kGrouped) return fir_banded_grouped_kernel<X, H, Y>;
  else return fir_banded_kernel<X, H, Y>;
}
template <>
auto kernel_of<float, float, float, false>() { return fir_banded_real_kernel; }
template <>
auto kernel_of<float, float, float, true>() { return fir_banded_grouped_real_kernel; }

constexpr int kMaxDevices = 64;

// The phase-grouped kernel's grid on the current device: the blocks that stay
// resident (each stages its taps once), at most one a tile. Its dynamic shared
// memory limit is raised to kGroupBudget once per process and device, and the
// residency is queried once per device and (threads, shared memory): a memo
// of the last such shape serves the launches that repeat it.
template <typename X, typename H, typename Y>
int grouped_grid(Launch& L) {
  struct Memo {
    bool opted = false;
    int threads = 0;
    size_t smem = 0;
    int64_t resident = 0;
  };
  static std::mutex mu;
  static Memo memo[kMaxDevices];
  const auto kernel = kernel_of<X, H, Y, true>();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev < 0 || dev >= kMaxDevices) return int(cudaErrorInvalidDevice);
  std::lock_guard<std::mutex> lock(mu);
  Memo& m = memo[dev];
  if (!m.opted) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(kGroupBudget));
    if (err != cudaSuccess) return int(err);
    m.opted = true;
  }
  if (m.threads != L.threads || m.smem != L.smem) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return int(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, L.threads, L.smem);
    if (err != cudaSuccess) return int(err);
    m.threads = L.threads;
    m.smem = L.smem;
    m.resident = int64_t(per_sm > 0 ? per_sm : 1) * sms;
  }
  if (m.resident < L.grid) L.grid = unsigned(m.resident);
  return int(cudaSuccess);
}

// *groups (where not null): the phase groups of the launch (1: the staged
// loop; > 1: the phase-grouped loop), 0 where nothing was launched.
template <typename X, typename H, typename Y>
int launch(const void* x, const void* hist, const void* taps, void* y,
           int64_t channels, int64_t T, int K, int decim, cudaStream_t stream,
           int* groups) {
  if (groups) *groups = 0;
  if (channels < 0 || T < 0 || K < 1 || decim < 1) return int(cudaErrorInvalidValue);
  if (T / decim == 0 || channels == 0) return int(cudaSuccess);
  Launch L = plan<X, H, Y>(channels, T, K, decim, 0);
  const bool grouped = group_phases<X, H, Y>(L);
  if (grouped) {
    const int err = grouped_grid<X, H, Y>(L);
    if (err != int(cudaSuccess)) return err;
  }
  const auto kernel = grouped ? kernel_of<X, H, Y, true>() : kernel_of<X, H, Y, false>();
  kernel<<<L.grid, L.threads, L.smem, stream>>>(
      static_cast<const X*>(x), static_cast<const X*>(hist),
      static_cast<const H*>(taps), static_cast<Y*>(y), L.pl);
  const int err = int(cudaGetLastError());
  if (groups && err == int(cudaSuccess)) *groups = L.pl.G;
  return err;
}

}  // namespace

extern "C" {

// x: [channels, T], hist: [channels, K-1], taps: [K], y: [channels, T/decim];
// all contiguous on the device. Returns a cudaError_t (0 on success).
// groups (may be null): set to the phase groups the call launched with (1:
// the staged loop; > 1: the phase-grouped loop), 0 where it launched nothing.
int gr4_fir_banded(const void* x, const void* hist, const void* taps, void* y,
                   int64_t channels, int64_t T, int K, int decim,
                   int x_complex, int taps_complex, void* stream, int* groups) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_complex && taps_complex)
    return launch<float2, float2, float2>(x, hist, taps, y, channels, T, K, decim, s, groups);
  if (x_complex)
    return launch<float2, float, float2>(x, hist, taps, y, channels, T, K, decim, s, groups);
  if (taps_complex)
    return launch<float, float2, float2>(x, hist, taps, y, channels, T, K, decim, s, groups);
  return launch<float, float, float>(x, hist, taps, y, channels, T, K, decim, s, groups);
}

const char* gr4_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
