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
// loop of fir_common.cuh into shared memory, together with the one output just
// before the tile, computed from the staged halo (the TPU kernel instead
// recomputes it with a banded matvec of the previous program's last input
// row). Tile 0 takes the carried prev instead. The demod epilogue then reads
// neighbouring outputs from shared memory and writes one float per output.
// atan2f is CUDA's (the TPU kernel's polynomial exists only because Mosaic
// has no atan2).
//
// Every shape. When decim > K the block stages each output's K-sample window,
// K apart, in place of the whole span, so the staged bytes do not grow with
// decim. When the taps and one window do not fit the shared-memory budget,
// the reversed taps go in chunks: each chunk restages its taps and the
// matching windows, and adds its partial FIR outputs into the tile's outputs
// in shared memory; the demod epilogue runs after the last chunk. The tile
// shrinks down to one output before the taps are chunked. Tiles walk grid x
// and channels grid y, each by a grid-stride loop, so any channel count runs.
//
// What bounds it. Each output costs K complex-by-real (or complex) MACs
// against 8 bytes read and 4 written, so FP32 issue and the shared-memory
// load per MAC bound it, not HBM. Fusing saves the 8-byte complex write and
// re-read of the unfused FIR -> demod pair, and the demod's elementwise
// passes. The register-blocked polyphase loop of fir_banded.cu is its next
// redesign.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fir_common.cuh"

namespace {

using namespace gr4fir;

template <typename H>
__global__ void __launch_bounds__(kFirThreads)
fir_demod_kernel(const float2* __restrict__ xc, const H* __restrict__ taps,
                 const float2* __restrict__ prev, float* __restrict__ y,
                 int64_t T, int K, int decim, int64_t M, int64_t channels,
                 int out_per_block, int k_chunk, float gain) {
  extern __shared__ __align__(16) unsigned char smem[];
  // outputs m0-1 .. m0+n_out-1: n_out + 1 of them
  const int stride_max = decim < k_chunk ? decim : k_chunk;
  const size_t span_max = size_t(out_per_block) * stride_max + k_chunk;
  H* s_h = reinterpret_cast<H*>(smem);
  float2* s_x = reinterpret_cast<float2*>(smem + align16(size_t(k_chunk) * sizeof(H)));
  float2* s_v = reinterpret_cast<float2*>(
      smem + align16(size_t(k_chunk) * sizeof(H)) + align16(span_max * sizeof(float2)));
  const int64_t tc = T + K - 1;
  const int64_t n_tiles = (M + out_per_block - 1) / out_per_block;

  for (int64_t c = blockIdx.y; c < channels; c += gridDim.y) {
    const float2* row = xc + c * tc;
    float* yrow = y + c * M;
    for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int64_t m0 = tile * out_per_block;
      const int n_out = M - m0 < out_per_block ? int(M - m0) : out_per_block;
      for (int j0 = 0; j0 < K; j0 += k_chunk) {
        const int kc = K - j0 < k_chunk ? K - j0 : k_chunk;
        // output j's window of the chunk: xc[(m0-1+j)*decim + j0 + i], i < kc,
        // staged at s_x[j*stride + i]; overlapping windows are one span
        const int stride = decim < kc ? decim : kc;
        const int span = n_out * stride + kc;
        __syncthreads();    // the last chunk's (or tile's) readers are done
        for (int j = threadIdx.x; j < kc; j += blockDim.x) s_h[j] = taps[K - 1 - j0 - j];
        // tile 0 stages from index -decim: its output -1 is never used
        const int64_t g0 = (m0 - 1) * decim + j0;
        for (int e = threadIdx.x; e < span; e += blockDim.x) {
          int64_t g = g0 + e;
          if (stride != decim) {
            const int j = e / stride;
            g = g0 + int64_t(j) * decim + (e - j * stride);
          }
          s_x[e] = (g >= 0 && g < tc) ? row[g] : zero<float2>();
        }
        __syncthreads();
        if (j0 == 0)
          fir_direct<float2, H, float2>(s_x, s_h, kc, stride, n_out + 1,
                                        [&](int j, float2 v) { s_v[j] = v; });
        else
          fir_direct<float2, H, float2>(s_x, s_h, kc, stride, n_out + 1,
                                        [&](int j, float2 v) {
                                          s_v[j].x += v.x;
                                          s_v[j].y += v.y;
                                        });
      }
      __syncthreads();
      for (int j = threadIdx.x; j < n_out; j += blockDim.x) {
        const float2 v = s_v[j + 1];
        const float2 p = (j == 0 && m0 == 0) ? prev[c] : s_v[j];
        const float re = v.x * p.x + v.y * p.y;
        const float im = v.y * p.x - v.x * p.y;
        yrow[m0 + j] = atan2f(im, re) * gain;
      }
    }
  }
}

template <typename H>
int launch(const void* xc, const void* taps, const void* prev, void* y,
           int64_t channels, int64_t T, int K, int decim, float gain,
           cudaStream_t stream) {
  if (channels < 0 || T < 0 || K < 1 || decim < 1) return int(cudaErrorInvalidValue);
  const int64_t M = T / decim;
  if (M == 0 || channels == 0) return int(cudaSuccess);
  auto smem_bytes = [&](int opb, int kc) {
    const size_t span = size_t(opb) * (decim < kc ? decim : kc) + kc;
    return align16(size_t(kc) * sizeof(H)) + align16(span * sizeof(float2)) +
           size_t(opb + 1) * sizeof(float2);
  };
  // n_out + 1 outputs per block: one short of the loop's pass, so the extra
  // output does not cost a second pass
  auto with_extra = [](int opb) { return opb > 1 ? opb - 1 : 1; };
  int kc = K;
  int opb = with_extra(outputs_per_block([&](int o) { return smem_bytes(o, kc); }));
  if (smem_bytes(opb, kc) > kSmemBudget) {
    // the taps and one window do not fit: chunk the taps at 31 outputs
    opb = 31;
    while (kc > 1 && smem_bytes(opb, kc) > kSmemBudget) kc = (kc + 1) / 2;
  }
  const size_t smem = smem_bytes(opb, kc);
  auto kernel = fir_demod_kernel<H>;
  const int64_t n_tiles = (M + opb - 1) / opb;
  const dim3 grid(unsigned(n_tiles < 0x7fffffff ? n_tiles : 0x7fffffff),
                  unsigned(channels < 65535 ? channels : 65535));
  kernel<<<grid, kFirThreads, smem, stream>>>(
      static_cast<const float2*>(xc), static_cast<const H*>(taps),
      static_cast<const float2*>(prev), static_cast<float*>(y), T, K, decim, M,
      channels, opb, kc, gain);
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
