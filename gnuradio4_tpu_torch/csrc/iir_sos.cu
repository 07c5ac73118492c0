// Cascaded-biquad IIR (transposed direct form II) for NVIDIA Hopper (sm_90a),
// bound through a plain C interface (ops/cuda_kernels.py loads it with ctypes).
//
// Replaces iir_sos_pallas / _iir_sos_kernel of
// gnuradio4_tpu/ops/pallas_kernels.py (reached through IirFilter's "pallas"
// engine, and its "auto" engine on the card when the sections do not admit
// the parallel form).
//
// What it computes, per channel c and sample n, section by section
// (v = x[c][n] into section 0, each section's y into the next):
//   y  = b0*v + s0
//   s0 = b1*v - a1*y + s1
//   s1 = b2*v - a2*y
// with coefficients a0-normalised in float64 on the host and rounded to f32
// (the reference kernel's values and update order). y[c][n] is the last
// section's y; the state [C, S, 2] is read at the start and written at the end.
//
// Design. One thread per channel walks time, keeping its 2S state values in
// registers; the 5S coefficients arrive by value as a kernel parameter (the
// constant bank: a uniform broadcast read). A block serves up to 32 channels:
// warp 0 runs the recursion, one lane per channel, and warps 1-3 move
// data. x and y keep their [C, T] layout as stored (the TPU kernel transposes
// to [T, C] only because Mosaic cannot index lanes dynamically); the movers
// stage [32, kTile] tiles of x through shared memory with coalesced loads,
// double-buffered, so the next tile arrives and the last tile's y leaves
// while warp 0 filters the current one in place. Rows are padded to
// kTile + 1 floats, so the 32 lanes reading sample j of their rows hit 32
// different banks.
//
// What bounds it. The recursion is serial in time: per sample a lane issues
// ~5S FMAs (15 for S = 3), one shared load and one shared store, and its warp
// issues at most one instruction per cycle, with the sections' dependent FMAs
// to cover. At C = 16 the whole filter is one warp, bound by that serial
// chain and not by HBM (8 bytes per sample per channel). On an H100 SXM at
// 700 W, S = 3, T = 2^20: 17.5 ms at C = 1 (33 cycles per sample) and 27.6 ms
// at C = 16. Reading each channel's row straight from global memory, one lane
// per row, took 43.9 ms at C = 16: every warp load and store touched 16
// separate sectors. Eight warps instead of four moved C = 16 by 5% and made
// C = 1 17% slower. A chunked state-space scan across time (time-parallel
// blocks joined by their carried state) is the redesign for a later PR.
//
// Any number of sections. One launch unrolls a group of at most kMaxSections
// sections; gr4_iir_sos launches the groups in order, the first reading x and
// each later one filtering the previous group's y in place. That is the
// cascade's arithmetic in the cascade's order. In place is safe: the movers
// load tile t+1 and store tile t-1 in one iteration, each tile is loaded an
// iteration before its slot is stored, and each block owns its channels' rows.
// Each group reads and writes its own sections of the [C, S, 2] state.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSections = 16;
constexpr int kLanes = 32;                     // channels per block: warp 0
constexpr int kTile = 128;                     // samples per staged tile
constexpr int kStride = kTile + 1;             // padded row: conflict-free lanes
constexpr int kIirThreads = 128;               // warps 1..3 move data
constexpr int kMovers = kIirThreads - kLanes;
constexpr int kPerMover = (kLanes * kTile + kMovers - 1) / kMovers;

struct SosCoefs {
  float c[kMaxSections][5];   // b0, b1, b2, a1, a2 per section
};

template <int S>
__device__ __forceinline__ float cascade(float v, const SosCoefs& co,
                                         float (&s0)[S], float (&s1)[S]) {
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const float y = co.c[k][0] * v + s0[k];
    s0[k] = co.c[k][1] * v - co.c[k][3] * y + s1[k];
    s1[k] = co.c[k][2] * v - co.c[k][4] * y;
    v = y;
  }
  return v;
}

template <int S>
__global__ void __launch_bounds__(kIirThreads)
iir_sos_kernel(const float* x, float* y,   // may alias: groups after the first
               const float* __restrict__ s_in, float* __restrict__ s_out,
               int64_t C, int64_t T, int s_total, int k0, const SosCoefs co) {
  __shared__ float buf[2][kLanes * kStride];
  const int64_t c0 = int64_t(blockIdx.x) * kLanes;
  const int nch = int(C - c0 < kLanes ? C - c0 : kLanes);
  const int64_t n_tiles = (T + kTile - 1) / kTile;
  const bool filters = threadIdx.x < kLanes;
  const int lane = threadIdx.x;
  const int mover = threadIdx.x - kLanes;

  // movers: slot i = (channel i / kTile, sample i % kTile) of a tile, the
  // same slots for loads and stores, so each slot is read before it is
  // rewritten by the same thread
  auto tile_len = [&](int64_t t) {
    return int(T - t * kTile < kTile ? T - t * kTile : kTile);
  };
  auto load = [&](int64_t t, float* b) {
    const int64_t n0 = t * kTile;
    const int len = tile_len(t);
    float v[kPerMover];
#pragma unroll
    for (int r = 0; r < kPerMover; ++r) {
      const int i = mover + r * kMovers;
      const int c = i / kTile, j = i % kTile;
      v[r] = (c < nch && j < len) ? x[(c0 + c) * T + n0 + j] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kPerMover; ++r) {
      const int i = mover + r * kMovers;
      if (i < kLanes * kTile) b[(i / kTile) * kStride + i % kTile] = v[r];
    }
  };
  auto store = [&](int64_t t, const float* b) {
    const int64_t n0 = t * kTile;
    const int len = tile_len(t);
#pragma unroll
    for (int r = 0; r < kPerMover; ++r) {
      const int i = mover + r * kMovers;
      const int c = i / kTile, j = i % kTile;
      if (c < nch && j < len) y[(c0 + c) * T + n0 + j] = b[c * kStride + j];
    }
  };

  float s0[S], s1[S];
  if (filters && lane < nch) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      s0[k] = s_in[((c0 + lane) * s_total + k0 + k) * 2];
      s1[k] = s_in[((c0 + lane) * s_total + k0 + k) * 2 + 1];
    }
  }
  if (!filters && n_tiles > 0) load(0, buf[0]);
  __syncthreads();
  for (int64_t t = 0; t < n_tiles; ++t) {
    float* cur = buf[t & 1];
    float* other = buf[(t + 1) & 1];
    if (filters) {
      if (lane < nch) {
        float* row = cur + lane * kStride;
        const int len = tile_len(t);
        if (len == kTile) {
#pragma unroll 8
          for (int j = 0; j < kTile; ++j) row[j] = cascade<S>(row[j], co, s0, s1);
        } else {
          for (int j = 0; j < len; ++j) row[j] = cascade<S>(row[j], co, s0, s1);
        }
      }
    } else {
      if (t >= 1) store(t - 1, other);
      if (t + 1 < n_tiles) load(t + 1, other);
    }
    __syncthreads();
  }
  if (!filters && n_tiles > 0) store(n_tiles - 1, buf[(n_tiles - 1) & 1]);

  if (filters && lane < nch) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      s_out[((c0 + lane) * s_total + k0 + k) * 2] = s0[k];
      s_out[((c0 + lane) * s_total + k0 + k) * 2 + 1] = s1[k];
    }
  }
}

template <int S>
int launch(const float* x, float* y, const float* s_in, float* s_out,
           int64_t C, int64_t T, int s_total, int k0, const SosCoefs& co,
           cudaStream_t stream) {
  const unsigned blocks = unsigned((C + kLanes - 1) / kLanes);
  iir_sos_kernel<S><<<blocks, kIirThreads, 0, stream>>>(x, y, s_in, s_out, C, T,
                                                        s_total, k0, co);
  return int(cudaGetLastError());
}

// One group: sections k0 .. k0+n-1 of coefs, from x into y.
int launch_group(const float* x, float* y, const float* s_in, float* s_out,
                 const float* coefs, int64_t C, int64_t T, int s_total, int k0,
                 int n, cudaStream_t s) {
  SosCoefs co = {};
  for (int k = 0; k < n; ++k)
    for (int i = 0; i < 5; ++i) co.c[k][i] = coefs[(k0 + k) * 5 + i];
  switch (n) {
#define GR4_IIR_CASE(m) \
    case m: return launch<m>(x, y, s_in, s_out, C, T, s_total, k0, co, s);
    GR4_IIR_CASE(1) GR4_IIR_CASE(2) GR4_IIR_CASE(3) GR4_IIR_CASE(4)
    GR4_IIR_CASE(5) GR4_IIR_CASE(6) GR4_IIR_CASE(7) GR4_IIR_CASE(8)
    GR4_IIR_CASE(9) GR4_IIR_CASE(10) GR4_IIR_CASE(11) GR4_IIR_CASE(12)
    GR4_IIR_CASE(13) GR4_IIR_CASE(14) GR4_IIR_CASE(15) GR4_IIR_CASE(16)
#undef GR4_IIR_CASE
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Sections per launch: gr4_iir_sos launches ceil(S / this) kernels.
int gr4_iir_sos_group_size() { return kMaxSections; }

// x, y: [C, T] float32; s_in, s_out: [C, S, 2] float32, all contiguous on the
// device; coefs: HOST pointer to [S, 5] float32 (b0, b1, b2, a1, a2), copied
// into the launches' parameters. Any S >= 1. Returns a cudaError_t (0 on
// success).
int gr4_iir_sos(const void* x, void* y, const void* s_in, void* s_out,
                const float* coefs, int64_t C, int64_t T, int S, void* stream) {
  if (C < 0 || T < 0 || S < 1) return int(cudaErrorInvalidValue);
  if (C == 0) return int(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto yp = static_cast<float*>(y);
  const float* src = static_cast<const float*>(x);
  for (int k0 = 0; k0 < S; k0 += kMaxSections) {
    const int n = S - k0 < kMaxSections ? S - k0 : kMaxSections;
    const int err = launch_group(src, yp, static_cast<const float*>(s_in),
                                 static_cast<float*>(s_out), coefs, C, T, S, k0,
                                 n, s);
    if (err) return err;
    src = yp;
  }
  return int(cudaSuccess);
}

}  // extern "C"
