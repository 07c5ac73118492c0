// Decimating FIR for NVIDIA Hopper (sm_90a): a register-blocked polyphase tile
// loop, bound through a plain C interface (ops/cuda_kernels.py loads it with
// ctypes).
//
// Replaces the two FIR kernels of gnuradio4_tpu/ops/pallas_kernels.py:
// fir_planar_pallas (:413-453, planar re/im rails) and fir_ilv_pallas
// (:167-205, interleaved f32 view). torch stores complex64 interleaved, so one
// kernel reading float2 takes the place of both.
//
// What it computes, per channel c, over the history-prefixed stream
//   xc[j] = j < K-1 ? hist[c][j] : x[c][j-(K-1)]      (length T + K - 1)
//   y[c][m] = sum_k h[k] * xc[m*decim + K-1 - k]       for m < M = T / decim
// i.e. outputs on the decimated grid aligned to the first input sample, as
// gnuradio4_tpu/ops/fir.py fir_apply frames them. Full float32 FMAs on the
// CUDA cores; no tensor cores.
//
// Design.
// - Polyphase planes. With hr[j] = h[K-1-j] and j = q*decim + p,
//     y[m] = sum_p sum_q hr[q*decim + p] * plane_p[m + q],
//     plane_p[n] = xc[n*decim + p],
//   so each of the P = min(decim, K) phases is a decim-1 FIR of
//   Q_p = ceil((K-p)/decim) taps over its plane. Phases p >= K carry no taps
//   and are never read. A block stages its tile's planes (n outputs need
//   n + Q - 1 samples of each) and the reversed taps in shared memory: the
//   staged bytes scale with min(decim, K), not with decim.
// - Staging. When the stage holds every phase, its samples are one contiguous
//   run of xc, read with 16-byte loads (eight in flight per thread for f32
//   samples, four for c64) and scattered to the planes; otherwise (decim > K,
//   or planes split over stages) one sample per (plane, row).
// - Register blocking. Each thread owns kR consecutive outputs. It keeps a
//   ring of kR samples of the plane in registers: per tap it loads one sample
//   from shared memory and does kR MACs from registers, where the direct form
//   loaded one sample per MAC. kR is odd, so the 32 lanes' loads, kR words
//   apart, fall on 32 different banks (for float2, 16 different bank pairs
//   per half-warp). The taps are a warp-uniform broadcast: complex ones one
//   load per tap, real ones eight slots per two 16-byte loads.
// - Every shape. Taps or planes that do not fit the shared-memory budget are
//   staged in chunks, the accumulators staying in registers; the tile shrinks
//   first (32 threads at least). Tiles of every channel are flattened into
//   grid x and walked by a grid-stride loop, so any channel count runs.
// - Outputs go through shared memory, so the block writes them coalesced.
// - Overlap of staging with the MACs comes from several resident blocks per
//   SM: the build's -Xptxas -v report gives 64 registers a thread for c64 x
//   c64 (four blocks of 256 threads per SM), 73 to 93 for the others (three
//   or two).
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

constexpr int kR = 7;                 // outputs per thread (odd: see above)
constexpr int kMaxThreads = 256;
constexpr size_t kBudget = 48 * 1024;  // shared memory per block: several per SM
constexpr int kSlots = 8;             // tap slots per ring block: kR taps, padded
static_assert(kR <= kSlots, "a ring block's taps fill one block of slots");

struct Plan {
  int64_t T, M, channels, tiles;      // tiles per channel
  int K, decim;
  int P, Q;                           // phase planes, most taps of one plane
  int pc, qc;                         // planes and taps per stage
  int n;                              // outputs per tile: blockDim.x * kR
  int ls;                             // staged samples per plane: n + qc - 1
  int hs;                             // tap slots per plane: kSlots per kR taps
};

// floor(e / d) for e * d < 2^32 with m = magic(d): a staged index e < 2^16
// (shared memory) by d < 2^16 (the planes of one stage)
__host__ __device__ __forceinline__ unsigned magic(int d) {
  return d <= 1 ? 0u : unsigned(((uint64_t(1) << 32) + uint64_t(d) - 1) / uint64_t(d));
}
__device__ __forceinline__ int div_magic(int e, int d, unsigned m) {
  return d == 1 ? e : int(__umulhi(unsigned(e), m));
}

// Sample u of a 16-byte load (u is a compile-time constant after unrolling).
template <typename X> __device__ __forceinline__ X lane(const float4& v, int u);
template <> __device__ __forceinline__ float lane<float>(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}
template <> __device__ __forceinline__ float2 lane<float2>(const float4& v, int u) {
  return u == 0 ? make_float2(v.x, v.y) : make_float2(v.z, v.w);
}

// One ring block's taps. Complex taps are read one at a time (a broadcast
// load each), which keeps the complex kernels at 64 registers; real taps
// come in two 16-byte loads per block, which takes most tap loads off the
// shared-memory pipe for the real-tap kernels.
template <typename H> struct BlockTaps {
  const H* p;
  __device__ __forceinline__ void load(const H* s) { p = s; }
  __device__ __forceinline__ H operator[](int u) const { return p[u]; }
};
template <> struct BlockTaps<float> {
  float t[kSlots];
  __device__ __forceinline__ void load(const float* s) {
#pragma unroll
    for (int i = 0; i < kSlots / 4; ++i) {
      const float4 q = reinterpret_cast<const float4*>(s)[i];
      t[4 * i] = q.x; t[4 * i + 1] = q.y; t[4 * i + 2] = q.z; t[4 * i + 3] = q.w;
    }
  }
  __device__ __forceinline__ float operator[](int u) const { return t[u]; }
};

// acc[r] += sum_{j < qn} h[j] * sx[j + r], r < kR, with tap j in slot
// (j / kR) * kSlots + j % kR of sh. w[s % kR] holds sx[s]: the window slides
// through the ring with compile-time indices (u is a constant after
// unrolling).
template <typename X, typename H, typename Y>
__device__ __forceinline__ void plane_fir(Y (&acc)[kR], const X* sx, const H* sh,
                                          int qn) {
  X w[kR];
#pragma unroll
  for (int s = 0; s < kR - 1; ++s) w[s] = sx[s];
  int jb = 0;
  for (; jb + kR <= qn; jb += kR, sh += kSlots) {
    BlockTaps<H> t;
    t.load(sh);
#pragma unroll
    for (int u = 0; u < kR; ++u) {
      w[(u + kR - 1) % kR] = sx[jb + u + kR - 1];
#pragma unroll
      for (int r = 0; r < kR; ++r) mac(acc[r], t[u], w[(u + r) % kR]);
    }
  }
  if (jb < qn) {
    BlockTaps<H> t;
    t.load(sh);
#pragma unroll
    for (int u = 0; u < kR - 1; ++u) {
      if (jb + u < qn) {
        w[(u + kR - 1) % kR] = sx[jb + u + kR - 1];
#pragma unroll
        for (int r = 0; r < kR; ++r) mac(acc[r], t[u], w[(u + r) % kR]);
      }
    }
  }
}

template <typename X>
__device__ __forceinline__ float4 load16(const X* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// X: stream sample (float | float2), H: tap (float | float2),
// Y: output (float2 when either is complex, else float).
template <typename X, typename H, typename Y>
__global__ void __launch_bounds__(kMaxThreads)
fir_banded_kernel(const X* __restrict__ x, const X* __restrict__ hist,
                  const H* __restrict__ taps, Y* __restrict__ y, const Plan pl) {
  constexpr int kEpv = 16 / sizeof(X);          // samples per 16-byte load
  constexpr int kBatch = 32 / sizeof(X);        // 16-byte loads in flight per thread
  extern __shared__ __align__(16) unsigned char smem[];
  H* s_h = reinterpret_cast<H*>(smem);
  X* s_x = reinterpret_cast<X*>(smem + align16(size_t(pl.pc) * pl.hs * sizeof(H)));
  Y* s_y = reinterpret_cast<Y*>(s_x);           // after the last stage
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int K = pl.K, decim = pl.decim, ls = pl.ls, hs = pl.hs;
  const unsigned dmul = magic(decim);

  const int64_t n_tiles = pl.channels * pl.tiles;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t c = tile / pl.tiles;
    const int64_t m0 = (tile - c * pl.tiles) * pl.n;
    const int n_out = int(pl.M - m0 < pl.n ? pl.M - m0 : pl.n);
    const X* xrow = x + c * pl.T;
    const X* hrow = hist + c * int64_t(K - 1);
    auto at = [&](int64_t g) {
      if (g < K - 1) return hrow[g];
      const int64_t t = g - (K - 1);
      return t < pl.T ? xrow[t] : zero<X>();
    };

    Y acc[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) acc[r] = zero<Y>();

    for (int p0 = 0; p0 < pl.P; p0 += pl.pc) {
      const int np = pl.P - p0 < pl.pc ? pl.P - p0 : pl.pc;
      for (int q0 = 0; q0 < pl.Q; q0 += pl.qc) {
        __syncthreads();    // the last stage's (or tile's) readers are done
        // plane pi's tap q = hr[(q0+q)*decim + p0 + pi] in slot
        // pi*hs + (q / kR)*kSlots + q % kR; zero past the taps
        for (int e = tid; e < np * hs; e += nt) {
          const int pi = e / hs, slot = e - pi * hs;
          const int u = slot % kSlots, q = slot / kSlots * kR + u;
          const int64_t j = int64_t(q0 + q) * decim + p0 + pi;
          s_h[e] = (u < kR && q < pl.qc && j < K) ? taps[K - 1 - j] : zero<H>();
        }
        // s_x[pi*ls + i] = xc[(m0 + q0 + i)*decim + p0 + pi], i < ls
        const int64_t g0 = (m0 + q0) * decim + p0;
        if (np == decim) {
          // every phase: one contiguous run of ls*decim samples from g0
          const int cnt = ls * decim;
          auto put = [&](int e, X v) {
            const int i = div_magic(e, decim, dmul);
            s_x[(e - i * decim) * ls + i] = v;
          };
          const int nh = int(K - 1 - g0 < 0 ? 0 : (K - 1 - g0 < cnt ? K - 1 - g0 : cnt));
          for (int e = tid; e < nh; e += nt) put(e, hrow[g0 + e]);
          // x[t] for t in [t_lo, t_hi): 16-byte loads where x has samples
          const int64_t t_lo = g0 + nh - (K - 1), t_hi = g0 + cnt - (K - 1);
          const int64_t t_end = t_hi < pl.T ? t_hi : pl.T;
          if (t_lo < t_end) {
            const int a = int((reinterpret_cast<uintptr_t>(xrow) / sizeof(X)) % kEpv);
            const X* base = xrow - a;                  // 16-byte aligned
            const int64_t k_lo = (t_lo + a) / kEpv, k_hi = (t_end - 1 + a) / kEpv;
            for (int64_t k = k_lo + tid; k <= k_hi; k += int64_t(kBatch) * nt) {
              float4 v[kBatch];
#pragma unroll
              for (int b = 0; b < kBatch; ++b)
                if (k + b * nt <= k_hi) v[b] = load16(base + (k + b * nt) * kEpv);
#pragma unroll
              for (int b = 0; b < kBatch; ++b) {
                if (k + b * nt > k_hi) break;
#pragma unroll
                for (int u = 0; u < kEpv; ++u) {
                  const int64_t t = (k + b * nt) * kEpv + u - a;
                  if (t >= t_lo && t < t_end) put(int(t + (K - 1) - g0), lane<X>(v[b], u));
                }
              }
            }
          }
          const int e_zero = int((t_end > t_lo ? t_end : t_lo) + (K - 1) - g0);
          for (int e = e_zero + tid; e < cnt; e += nt) put(e, zero<X>());
        } else {
          // some phases: one sample per (row i, plane pi), planes innermost
          const unsigned pmul = magic(np);
          for (int e = tid; e < np * ls; e += nt) {
            const int i = div_magic(e, np, pmul), pi = e - i * np;
            s_x[pi * ls + i] = at(g0 + int64_t(i) * decim + pi);
          }
        }
        __syncthreads();
        for (int pi = 0; pi < np; ++pi) {
          const int qp = (K - (p0 + pi) + decim - 1) / decim;   // taps of the plane
          const int qn = qp - q0 < pl.qc ? qp - q0 : pl.qc;
          if (qn > 0) plane_fir(acc, s_x + pi * ls + tid * kR, s_h + pi * hs, qn);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kR; ++r) s_y[tid * kR + r] = acc[r];
    __syncthreads();
    Y* yrow = y + c * pl.M + m0;
    for (int o = tid; o < n_out; o += nt) yrow[o] = s_y[o];
  }
}

template <typename X, typename H, typename Y>
size_t smem_bytes(int nt, int pc, int qc) {
  const size_t n = size_t(nt) * kR;
  const size_t planes = size_t(pc) * (n + qc - 1) * sizeof(X);
  const size_t outs = n * sizeof(Y);
  const size_t slots = size_t(pc) * ((qc + kR - 1) / kR) * kSlots;
  return align16(slots * sizeof(H)) + (planes > outs ? planes : outs);
}

template <typename X, typename H, typename Y>
int launch(const void* x, const void* hist, const void* taps, void* y,
           int64_t channels, int64_t T, int K, int decim, cudaStream_t stream) {
  if (channels < 0 || T < 0 || K < 1 || decim < 1) return int(cudaErrorInvalidValue);
  const int64_t M = T / decim;
  if (M == 0 || channels == 0) return int(cudaSuccess);
  Plan pl = {};
  pl.T = T; pl.M = M; pl.channels = channels; pl.K = K; pl.decim = decim;
  pl.P = decim < K ? decim : K;
  pl.Q = (K + decim - 1) / decim;
  auto bytes = [&](int nt, int pc, int qc) { return smem_bytes<X, H, Y>(nt, pc, qc); };
  // tile: no more threads than outputs need, a power of two in [32, 256]
  int nt_max = 32;
  while (nt_max < kMaxThreads && int64_t(nt_max) * kR < M) nt_max *= 2;
  // whole planes and taps in one stage, shrinking the tile; else chunk the
  // taps at the largest tile; else one tap per plane and chunk the planes
  int nt = nt_max, pc = pl.P, qc = pl.Q;
  while (nt > 32 && bytes(nt, pc, qc) > kBudget) nt /= 2;
  if (bytes(nt, pc, qc) > kBudget) {
    nt = nt_max;
    while (qc > 1 && bytes(nt, pc, qc) > kBudget) qc = (qc + 1) / 2;
    if (bytes(nt, pc, qc) > kBudget) {
      nt = 32;
      while (pc > 1 && bytes(nt, pc, qc) > kBudget) pc = (pc + 1) / 2;
    }
  }
  pl.pc = pc; pl.qc = qc; pl.n = nt * kR; pl.ls = pl.n + qc - 1;
  pl.hs = (qc + kR - 1) / kR * kSlots;
  pl.tiles = (M + pl.n - 1) / pl.n;
  const size_t smem = bytes(nt, pc, qc);
  auto kernel = fir_banded_kernel<X, H, Y>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  const int64_t n_tiles = channels * pl.tiles;
  const unsigned grid = unsigned(n_tiles < 0x7fffffff ? n_tiles : 0x7fffffff);
  kernel<<<grid, nt, smem, stream>>>(
      static_cast<const X*>(x), static_cast<const X*>(hist),
      static_cast<const H*>(taps), static_cast<Y*>(y), pl);
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
