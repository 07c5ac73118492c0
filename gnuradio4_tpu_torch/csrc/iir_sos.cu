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
// Design: a chunked state-space scan across time. The recursion is serial in
// time, and one lane per channel walking all T samples left the card idle
// (one warp at C = 16: 0.15% of the HBM bound). But the cascade is linear:
// with s the 2S state values of a group of sections and A one zero-input
// sample, a chunk of L = kChunk samples entered in state s leaves in
// Phi*s + z, where Phi = A^L and z is the chunk's end state from the zero
// state. Per group of at most kMaxSections sections, three launches:
//   1. reduce: every (channel, chunk) runs the cascade from the zero state
//      (z_k in registers); the block's 128 chunks are scanned in shared
//      memory (Hillis-Steele with Phi^(2^j): W_i = Phi*W_(i-1) + z_i), and
//      it writes each chunk's local prefix P_i = W_(i-1) and its aggregate
//      W_127, the block's end state from the zero state;
//   2. carry: the blocks' entering states E_0 = state, E_(b+1) =
//      Phi^128*E_b + W_127(b), one block of kCarryThreads per channel: each
//      thread folds a run of G = 2^g aggregates by Horner's rule (thread 0
//      from the caller's state), a Hillis-Steele scan in shared memory joins
//      the runs with Phi^(128*G*2^j), and each thread walks its run again,
//      overwriting the aggregates with the entering states;
//   3. rerun: the block builds Phi^i*E_b for its chunks i by doubling (level
//      j: threads [2^j, 2^(j+1)) apply Phi^(2^j) to thread i - 2^j's), each
//      chunk enters in s_k = Phi^i*E_b + P_i, runs the cascade again and
//      writes y; the last chunk's end state is the new state.
// The host (ops/iir.py sos_chunk_powers) computes Phi^(2^j), j < kLevels, in
// float64 from the f32 coefficients and rounds them to f32; they arrive in a
// device buffer uploaded once per coefficient set, and every thread of a
// block reads the same matrix at once (a broadcast). The last chunk may be
// partial, and T < L is one chunk: its entering state is the caller's, and
// the rerun is the serial loop over the stream.
//
// Passes 1 and 3 give each thread one chunk, 128 chunks of one channel per
// block. x and y keep their [C, T] layout; the block stages [128, kSub] tiles
// (kSub samples of each of its chunks) through shared memory with coalesced
// loads, rows padded to kSub + 1 floats so that the lanes reading sample j of
// their rows hit different banks; pass 3 filters the tile in place and stores
// it. What bounds it: x is read twice and y written once (12 bytes per sample
// against the 8 of the bound), each pass issues ~5S FMAs per sample, and at
// C = 16, T = 2^20 there are 131072 chunk-threads to cover the sections'
// dependent FMAs. The scans add ~7*(2S)^2 FMAs per chunk to pass 1 and
// (2S)^2 to pass 3; the carry's work is 1/128 of that per block. (A first
// version scanned every chunk in the carry kernel, one block per channel,
// each thread walking 32 chunks at Path B's shape with the lanes' z reads
// 768 bytes apart; that serial, scattered walk dominated the kernel.)
//
// Rounding. Phi and z_k are exact in exact arithmetic, so the result is the
// serial loop's up to f32 rounding, which now differs: the chunk grid starts
// at each call's first sample, so a stream cut into two calls with the state
// carried agrees with one call within rounding, not bit for bit.
//
// Any number of sections: gr4_iir_sos runs the groups in order, the first
// reading x and each later one filtering the previous group's y in place.
// Pass 3 of a group writes y only after its pass 1 has read every sample
// (stream order), and each block of pass 3 stores only the samples it loaded.
// Each group reads and writes its own sections of the [C, S, 2] state.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSections = 16;
constexpr int kChunk = 128;                 // L: samples per chunk
constexpr int kSub = 32;                    // samples of each chunk per tile
constexpr int kPassThreads = 128;           // chunks per block in passes 1, 3
constexpr int kPassLog = 7;                 // log2(kPassThreads)
constexpr int kStride = kSub + 1;           // padded row: conflict-free lanes
constexpr int kCarryThreads = 256;          // runs per channel in the carry
constexpr int kCarryLog = 8;                // log2(kCarryThreads)
constexpr int kLevels = 40;                 // powers Phi^(2^j) per group

static_assert(kPassThreads % kSub == 0, "a warp loads one row segment");
static_assert(kChunk % kSub == 0, "whole tiles per chunk");
static_assert((1 << kPassLog) == kPassThreads, "pass threads");
static_assert((1 << kCarryLog) == kCarryThreads, "carry threads");
static_assert(2 * kMaxSections + 1 <= kStride, "a scan row fits a tile row");

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

// u = m * v (+ u when kAdd), m [N, N] row-major; every thread of the block
// reads the same m at once.
template <int N, bool kAdd>
__device__ __forceinline__ void matvec(const float* m, const float (&v)[N],
                                       float (&u)[N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    float acc = kAdd ? u[r] : 0.f;
#pragma unroll
    for (int q = 0; q < N; ++q) acc = fmaf(m[r * N + q], v[q], acc);
    u[r] = acc;
  }
}

// Where a thread of passes 1 and 3 works: block b serves chunks
// [(b % bpc) * 128, +128) of channel b / bpc, one chunk per thread.
struct ChunkSlot {
  int64_t c, block, chunk, first;   // channel, block of the channel, chunk,
  int len;                          // the block's first sample, chunk length
  __device__ ChunkSlot(int64_t T, int64_t K, int64_t bpc) {
    c = int64_t(blockIdx.x) / bpc;
    block = int64_t(blockIdx.x) % bpc;
    chunk = block * kPassThreads + threadIdx.x;
    first = block * kPassThreads * kChunk;
    const int64_t left = T - chunk * kChunk;
    len = chunk < K ? int(left < kChunk ? left : kChunk) : 0;
  }
};

// The cascade over this thread's chunk, kSub samples of every chunk of the
// block at a time, staged through `tile`; with kWrite, y gets the outputs.
// A tile has one row per thread, so kSub elements per thread: element
// i = threadIdx.x + r * kPassThreads is sample i % kSub of row i / kSub, and a
// warp moves 32 consecutive samples of one chunk.
template <int S, bool kWrite>
__device__ __forceinline__ void filter_chunk(
    const float* xc, float* yc, float* tile, const ChunkSlot& at, int64_t T,
    const SosCoefs& co, float (&s0)[S], float (&s1)[S]) {
  float* row = tile + threadIdx.x * kStride;
  for (int j0 = 0; j0 < kChunk; j0 += kSub) {
    __syncthreads();                    // the last tile is computed and stored
#pragma unroll
    for (int r = 0; r < kSub; ++r) {
      const int i = threadIdx.x + r * kPassThreads;
      const int64_t n = at.first + int64_t(i / kSub) * kChunk + j0 + i % kSub;
      tile[(i / kSub) * kStride + i % kSub] = n < T ? xc[n] : 0.f;
    }
    __syncthreads();
    const int m = at.len - j0;          // this chunk's samples in the tile
    if (m >= kSub) {
#pragma unroll 8
      for (int j = 0; j < kSub; ++j) {
        const float v = cascade<S>(row[j], co, s0, s1);
        if (kWrite) row[j] = v;
      }
    } else {
      for (int j = 0; j < m; ++j) {
        const float v = cascade<S>(row[j], co, s0, s1);
        if (kWrite) row[j] = v;
      }
    }
    if (kWrite) {
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kSub; ++r) {
        const int i = threadIdx.x + r * kPassThreads;
        const int64_t n = at.first + int64_t(i / kSub) * kChunk + j0 + i % kSub;
        if (n < T) yc[n] = tile[(i / kSub) * kStride + i % kSub];
      }
    }
  }
  __syncthreads();                      // the tile is free again
}

// Pass 1: prefix [C, K, 2S] gets each chunk's local prefix P_i, agg
// [C, bpc, 2S] each block's end state from the zero state.
template <int S>
__global__ void __launch_bounds__(kPassThreads)
iir_chunk_reduce(const float* x, float* __restrict__ prefix,
                 float* __restrict__ agg, const float* __restrict__ phi,
                 int64_t T, int64_t K, int64_t bpc, const SosCoefs co) {
  constexpr int N = 2 * S;
  constexpr int kW = N + 1;                 // odd row stride: conflict-free
  __shared__ float tile[kPassThreads * kStride];
  const ChunkSlot at(T, K, bpc);
  const int t = threadIdx.x;
  float s0[S] = {}, s1[S] = {};
  filter_chunk<S, false>(x + at.c * T, nullptr, tile, at, T, co, s0, s1);

  // inclusive scan over the block's chunks: W_i = Phi^d W_(i-d) + W_i
  float v[N];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    v[2 * k] = s0[k];
    v[2 * k + 1] = s1[k];
  }
  float* w = tile;
#pragma unroll
  for (int q = 0; q < N; ++q) w[t * kW + q] = v[q];
#pragma unroll 1
  for (int j = 0; j < kPassLog; ++j) {
    const int d = 1 << j;
    float prev[N];
    __syncthreads();                        // the last level's w written
    if (t >= d) {
#pragma unroll
      for (int q = 0; q < N; ++q) prev[q] = w[(t - d) * kW + q];
    }
    __syncthreads();                        // every read of w done
    if (t >= d) {
      matvec<N, true>(phi + j * N * N, prev, v);
#pragma unroll
      for (int q = 0; q < N; ++q) w[t * kW + q] = v[q];
    }
  }
  __syncthreads();
  if (at.len > 0) {
    float* p = prefix + (at.c * K + at.chunk) * N;
#pragma unroll
    for (int q = 0; q < N; ++q) p[q] = t == 0 ? 0.f : w[(t - 1) * kW + q];
  }
  if (t == kPassThreads - 1) {
    float* a = agg + (at.c * bpc + at.block) * N;
#pragma unroll
    for (int q = 0; q < N; ++q) a[q] = v[q];
  }
}

// Pass 2, one block per channel: agg holds each block's W_127 on entry and
// its entering state E_b on exit. phi: this group's kLevels matrices
// Phi^(2^j), each [2S, 2S]; a block of chunks spans Phi^128. Thread t folds
// blocks [t*G, (t+1)*G), G = 2^g >= ceil(bpc / kCarryThreads).
template <int S>
__global__ void __launch_bounds__(kCarryThreads)
iir_chunk_carry(float* agg, const float* __restrict__ s_in,
                const float* __restrict__ phi, int64_t bpc, int g, int s_total,
                int k0) {
  constexpr int N = 2 * S;
  constexpr int kW = N + 1;                 // odd row stride: conflict-free
  __shared__ float w[kCarryThreads * kW];
  __shared__ float m1[N * N];               // Phi^128
  const int64_t c = blockIdx.x;
  const int t = threadIdx.x;
  float* st = agg + c * bpc * N;
  const float* init = s_in + (c * s_total + k0) * 2;
  const int64_t G = int64_t(1) << g;
  const int64_t first = t * G;
  const int64_t runs = (bpc + G - 1) / G;   // runs that hold a block (<= 256)
  for (int i = t; i < N * N; i += kCarryThreads) m1[i] = phi[kPassLog * N * N + i];
  __syncthreads();

  // each run's end state: from the zero state, run 0 from the caller's
  float v[N];
#pragma unroll
  for (int q = 0; q < N; ++q) v[q] = t == 0 ? init[q] : 0.f;
  for (int64_t i = 0; i < G && first + i < bpc; ++i) {
    float u[N];
    const float* z = st + (first + i) * N;
#pragma unroll
    for (int q = 0; q < N; ++q) u[q] = z[q];
    matvec<N, true>(m1, v, u);
#pragma unroll
    for (int q = 0; q < N; ++q) v[q] = u[q];
  }
  // inclusive scan over the runs: w_t <- w_t + Phi^(128*G*d) w_(t-d)
#pragma unroll
  for (int q = 0; q < N; ++q) w[t * kW + q] = v[q];
  for (int j = 0; (int64_t(1) << j) < runs; ++j) {
    const int d = 1 << j;
    float prev[N];
    __syncthreads();                        // the last level's w written
    if (t >= d) {
#pragma unroll
      for (int q = 0; q < N; ++q) prev[q] = w[(t - d) * kW + q];
    }
    __syncthreads();                        // every read of w done
    if (t >= d) {
      matvec<N, true>(phi + int64_t(kPassLog + g + j) * N * N, prev, v);
#pragma unroll
      for (int q = 0; q < N; ++q) w[t * kW + q] = v[q];
    }
  }
  __syncthreads();
  if (first >= bpc) return;
  // each block's entering state: the run's from the scan, then Horner again
#pragma unroll
  for (int q = 0; q < N; ++q) v[q] = t == 0 ? init[q] : w[(t - 1) * kW + q];
  for (int64_t i = 0; i < G && first + i < bpc; ++i) {
    float u[N];
    float* z = st + (first + i) * N;
#pragma unroll
    for (int q = 0; q < N; ++q) {
      u[q] = z[q];
      z[q] = v[q];
    }
    matvec<N, true>(m1, v, u);
#pragma unroll
    for (int q = 0; q < N; ++q) v[q] = u[q];
  }
}

// Pass 3: each chunk from s_k = Phi^i E_b + P_i; y written, the last chunk's
// end state into s_out.
template <int S>
__global__ void __launch_bounds__(kPassThreads)
iir_chunk_rerun(const float* x, float* y,   // may alias: groups after the first
                const float* __restrict__ prefix, const float* __restrict__ agg,
                const float* __restrict__ phi, float* __restrict__ s_out,
                int64_t T, int64_t K, int64_t bpc, int s_total, int k0,
                const SosCoefs co) {
  constexpr int N = 2 * S;
  constexpr int kW = N + 1;
  __shared__ float tile[kPassThreads * kStride];
  const ChunkSlot at(T, K, bpc);
  const int t = threadIdx.x;
  // Phi^i E_b by doubling: level j gives rows [d, 2d) from rows [0, d)
  float* w = tile;
  if (t == 0) {
    const float* e = agg + (at.c * bpc + at.block) * N;
#pragma unroll
    for (int q = 0; q < N; ++q) w[q] = e[q];
  }
#pragma unroll 1
  for (int j = 0; j < kPassLog; ++j) {
    const int d = 1 << j;
    __syncthreads();                        // rows [0, d) written
    if (t >= d && t < 2 * d) {
      float prev[N], u[N];
#pragma unroll
      for (int q = 0; q < N; ++q) prev[q] = w[(t - d) * kW + q];
      matvec<N, false>(phi + j * N * N, prev, u);
#pragma unroll
      for (int q = 0; q < N; ++q) w[t * kW + q] = u[q];
    }
  }
  __syncthreads();
  float s0[S], s1[S];
  const float* p = prefix + (at.c * K + at.chunk) * N;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    s0[k] = at.len > 0 ? w[t * kW + 2 * k] + p[2 * k] : 0.f;
    s1[k] = at.len > 0 ? w[t * kW + 2 * k + 1] + p[2 * k + 1] : 0.f;
  }
  filter_chunk<S, true>(x + at.c * T, y + at.c * T, tile, at, T, co, s0, s1);
  if (at.len > 0 && at.chunk == K - 1) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      s_out[(at.c * s_total + k0 + k) * 2] = s0[k];
      s_out[(at.c * s_total + k0 + k) * 2 + 1] = s1[k];
    }
  }
}

constexpr int64_t kMaxGrid = 2147483647;

// Chunks and blocks of chunks per channel, and the carry's log2 G.
struct Grid {
  int64_t K, bpc;
  int g;
  explicit Grid(int64_t T) {
    K = (T + kChunk - 1) / kChunk;
    bpc = (K + kPassThreads - 1) / kPassThreads;
    g = 0;
    while ((int64_t(kCarryThreads) << g) < bpc) ++g;
  }
};

template <int S>
int launch(const float* x, float* y, const float* s_in, float* s_out,
           const float* phi, float* work, int64_t C, int64_t T, int s_total,
           int k0, const SosCoefs& co, cudaStream_t stream) {
  const Grid gr(T);
  if (kPassLog + gr.g + kCarryLog > kLevels || C > kMaxGrid
      || gr.bpc > kMaxGrid / C)
    return int(cudaErrorInvalidValue);
  float* prefix = work;
  float* agg = work + C * gr.K * (2 * S);
  const unsigned blocks = unsigned(C * gr.bpc);
  iir_chunk_reduce<S><<<blocks, kPassThreads, 0, stream>>>(
      x, prefix, agg, phi, T, gr.K, gr.bpc, co);
  int err = int(cudaGetLastError());
  if (err) return err;
  iir_chunk_carry<S><<<unsigned(C), kCarryThreads, 0, stream>>>(
      agg, s_in, phi, gr.bpc, gr.g, s_total, k0);
  err = int(cudaGetLastError());
  if (err) return err;
  iir_chunk_rerun<S><<<blocks, kPassThreads, 0, stream>>>(
      x, y, prefix, agg, phi, s_out, T, gr.K, gr.bpc, s_total, k0, co);
  return int(cudaGetLastError());
}

// One group: sections k0 .. k0+n-1 of coefs, from x into y.
int launch_group(const float* x, float* y, const float* s_in, float* s_out,
                 const float* coefs, const float* phi, float* work, int64_t C,
                 int64_t T, int s_total, int k0, int n, cudaStream_t s) {
  SosCoefs co = {};
  for (int k = 0; k < n; ++k)
    for (int i = 0; i < 5; ++i) co.c[k][i] = coefs[(k0 + k) * 5 + i];
  switch (n) {
#define GR4_IIR_CASE(m)                                                      \
    case m: return launch<m>(x, y, s_in, s_out, phi, work, C, T, s_total, k0, \
                             co, s);
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

// Sections per group, samples per chunk, powers of Phi per group, and kernel
// launches per group; the wrapper checks the first three against ops/iir.py.
int gr4_iir_sos_group_size() { return kMaxSections; }
int gr4_iir_sos_chunk() { return kChunk; }
int gr4_iir_sos_levels() { return kLevels; }
int gr4_iir_sos_launches_per_group() { return 3; }

// Floats of the work buffer gr4_iir_sos needs: per chunk and per block of
// chunks, one state vector of the widest group.
int64_t gr4_iir_sos_work_size(int64_t C, int64_t T, int S) {
  const Grid gr(T);
  return C * (gr.K + gr.bpc) * 2 * (S < kMaxSections ? S : kMaxSections);
}

// x, y: [C, T] float32; s_in, s_out: [C, S, 2] float32, all contiguous on the
// device; coefs: HOST pointer to [S, 5] float32 (b0, b1, b2, a1, a2), copied
// into the launches' parameters. phi: device float32, for each group in order
// kLevels matrices Phi^(2^j) of [2n, 2n] (n its sections), as ops/iir.py
// sos_chunk_powers gives them; work: device float32 scratch of
// gr4_iir_sos_work_size(C, T, S) floats. Any S >= 1. Returns a cudaError_t (0
// on success).
int gr4_iir_sos(const void* x, void* y, const void* s_in, void* s_out,
                const float* coefs, const void* phi, void* work, int64_t C,
                int64_t T, int S, void* stream) {
  if (C < 0 || T < 0 || S < 1) return int(cudaErrorInvalidValue);
  if (C == 0 || T == 0) return int(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto yp = static_cast<float*>(y);
  const float* src = static_cast<const float*>(x);
  const float* table = static_cast<const float*>(phi);
  for (int k0 = 0; k0 < S; k0 += kMaxSections) {
    const int n = S - k0 < kMaxSections ? S - k0 : kMaxSections;
    const int err = launch_group(src, yp, static_cast<const float*>(s_in),
                                 static_cast<float*>(s_out), coefs, table,
                                 static_cast<float*>(work), C, T, S, k0, n, s);
    if (err) return err;
    src = yp;
    table += int64_t(kLevels) * (2 * n) * (2 * n);
  }
  return int(cudaSuccess);
}

}  // extern "C"
