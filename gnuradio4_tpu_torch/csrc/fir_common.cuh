// The FIR kernels' shared pieces (fir_banded.cu, fir_demod.cu): the
// multiply-add for every (tap, sample) type pair, the register-blocked
// polyphase tile loop (TileLoop) and its launch planner (plan). Each kernel
// walks its tiles, runs the loop for a tile's FIR outputs in registers and
// then does its own epilogue: fir_banded stores them, fir_demod demodulates
// them.
//
// What the loop computes, per channel, over the history-prefixed stream
//   xc[j] = j < K-1 ? hist[j] : x[j-(K-1)]            (length T + K - 1)
//   v[m] = sum_k h[k] * xc[m*decim + K-1 - k]         for m < M = T / decim
// i.e. outputs on the decimated grid aligned to the first input sample, as
// gnuradio4_tpu/ops/fir.py fir_apply frames them. Full float32 FMAs on the
// CUDA cores; no tensor cores.
//
// Design.
// - Polyphase planes. With hr[j] = h[K-1-j] and j = q*decim + p,
//     v[m] = sum_p sum_q hr[q*decim + p] * plane_p[m + q],
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
//   from shared memory and does kR MACs from registers, where a direct form
//   loads one sample per MAC. kR is odd, so the 32 lanes' loads, kR words
//   apart, fall on 32 different banks (for float2, 16 different bank pairs
//   per half-warp). The taps are a warp-uniform broadcast: complex ones one
//   load per tap, real ones eight slots per two 16-byte loads.
// - Every shape. Taps or planes that do not fit the shared-memory budget are
//   staged in chunks, the accumulators staying in registers; the tile shrinks
//   first (32 threads at least). Tiles of every channel are flattened into
//   grid x and walked by a grid-stride loop, so any channel count runs.
// - Overlap of staging with the MACs comes from several resident blocks per
//   SM (48 KB of shared memory a block at most).
// - Phase groups (fir_banded only). Where the stage above cannot hold a whole
//   tile (it would chunk planes or taps, or shrink the tile to one warp), the
//   block is G groups of warps over the same n = lanes*kR outputs: group g
//   runs the ring over phases g, g+G, ... (at most 8 groups, so each takes
//   ceil(P/8) phases or one fewer). A tile's (n + Q - 1) rows of every plane
//   are staged once, with the 16-byte loads of the contiguous run (one
//   sample per (row, plane) where decim > K), into dynamic shared memory
//   above 48 KB (planes padded to an odd length, so the scatter's lanes fall
//   on distinct banks); the taps of every phase are staged once per block
//   and stay resident, the blocks staying resident and walking the tiles
//   (fir_banded.cu caps the grid). The G partial sums of an output are added through
//   shared memory in group order (no atomics: runs are deterministic).
//   Overlap of staging with the MACs comes from two resident blocks per SM.
//   G = 1 (every other shape) is the staged loop unchanged, bit for bit.
// - At decim 1 there is one plane holding every tap in order, so each output
//   is one FMA chain over k = K-1 .. 0: the order of a direct-form loop.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gr4fir {

constexpr int kR = 7;                 // outputs per thread (odd: see above)
constexpr int kMaxThreads = 256;
constexpr size_t kBudget = 48 * 1024;  // shared memory per block: several per SM
constexpr int kSlots = 8;             // tap slots per ring block: kR taps, padded
constexpr int kMaxGroups = 8;         // phase groups of a block at most
constexpr int kGroupBatch = 8;        // 16-byte loads in flight per thread (groups)
// dynamic shared memory of a phase-grouped block: at most Hopper's opt-in
// limit, and no more than half an SM's 228 KB (less the 1 KB the SM keeps per
// block) where the tile allows it, so that two blocks stay resident
constexpr size_t kGroupBudget = 227 * 1024;
constexpr size_t kGroupPairBudget = 228 * 1024 / 2 - 1024;
static_assert(kR <= kSlots, "a ring block's taps fill one block of slots");

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ float2 zero<float2>() {
  return make_float2(0.f, 0.f);
}

__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

// acc += h * x for every (tap, sample) type pair the FIR takes.
__device__ __forceinline__ void mac(float& acc, float h, float x) {
  acc = fmaf(h, x, acc);
}
__device__ __forceinline__ void mac(float2& acc, float h, float2 x) {
  acc.x = fmaf(h, x.x, acc.x);
  acc.y = fmaf(h, x.y, acc.y);
}
__device__ __forceinline__ void mac(float2& acc, float2 h, float x) {
  acc.x = fmaf(h.x, x, acc.x);
  acc.y = fmaf(h.y, x, acc.y);
}
__device__ __forceinline__ void mac(float2& acc, float2 h, float2 x) {
  acc.x = fmaf(h.x, x.x, acc.x);
  acc.x = fmaf(-h.y, x.y, acc.x);
  acc.y = fmaf(h.x, x.y, acc.y);
  acc.y = fmaf(h.y, x.x, acc.y);
}

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

struct Plan {
  int64_t T, M, channels, tiles;      // tiles per channel
  int K, decim;
  int P, Q;                           // phase planes, most taps of one plane
  int pc, qc;                         // planes and taps per stage
  int n;                              // outputs per tile: lanes * kR
  int ls;                             // staged samples per plane: n + qc - 1 (odd for G > 1)
  int hs;                             // tap slots per plane: kSlots per kR taps
  int G;                              // phase groups (1: the staged loop)
  int lanes;                          // threads per group: blockDim.x / G
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
// load each), which keeps the complex kernels' registers down; real taps
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

// The tile loop of one block. It is set up once per block, before the
// block's loop over tiles, so that what stays fixed over the tiles is
// computed once, as a kernel's own locals would be (per tile, the division in
// magic() is not hoisted: it sits behind a branch). s_h holds the tap slots,
// s_x the planes, which the caller's epilogue may reuse once the last stage
// is read.
// X: stream sample (float | float2), H: tap (float | float2).
template <typename X, typename H>
struct TileLoop {
  const Plan& pl;
  const H* __restrict__ taps;
  H* s_h;
  X* s_x;
  int tid, nt, K, decim, ls, hs;
  unsigned dmul;

  __device__ __forceinline__ TileLoop(unsigned char* smem, const Plan& plan,
                                      const H* __restrict__ h)
      : pl(plan), taps(h), s_h(reinterpret_cast<H*>(smem)),
        s_x(reinterpret_cast<X*>(smem + align16(size_t(plan.pc) * plan.hs * sizeof(H)))),
        tid(threadIdx.x), nt(blockDim.x), K(plan.K), decim(plan.decim), ls(plan.ls),
        hs(plan.hs), dmul(magic(plan.decim)) {}

  // One tile: acc[r] = v[m0 + tid*kR + r] of one channel, whose stream is
  // hrow[0 .. K-1) then xrow[0 .. T) (zero past its end). Every thread of the
  // block takes part; it starts with __syncthreads(), so the block's previous
  // readers of s_h and s_x are done, and ends with the last stage's planes
  // still being read (sync before reusing s_x).
  // Y: output (float2 when either is complex, else float).
  template <typename Y>
  __device__ __forceinline__ void run(Y (&acc)[kR], const X* xrow, const X* hrow,
                                      int64_t m0) const {
    constexpr int kEpv = 16 / sizeof(X);          // samples per 16-byte load
    constexpr int kBatch = 32 / sizeof(X);        // 16-byte loads in flight per thread
    auto at = [&](int64_t g) {
      if (g < K - 1) return hrow[g];
      const int64_t t = g - (K - 1);
      return t < pl.T ? xrow[t] : zero<X>();
    };

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
  }

  // Phase groups (pl.G > 1): once per block, before its first tile, the taps
  // of every phase, as run() stages them (they stay resident: no tile writes
  // s_h).
  __device__ __forceinline__ void stage_resident_taps() const {
    for (int e = tid; e < pl.P * hs; e += nt) {
      const int pi = e / hs, slot = e - pi * hs;
      const int u = slot % kSlots, q = slot / kSlots * kR + u;
      const int64_t j = int64_t(q) * decim + pi;
      s_h[e] = (u < kR && q < pl.Q && j < K) ? taps[K - 1 - j] : zero<H>();
    }
  }

  // One tile with phase groups: acc[r] = group g's share of v[m0 + j*kR + r]
  // for the thread's lane j of its group, the sum over phases g, g+G, ... The
  // tile's n + Q - 1 rows of every plane are staged once, by a copy of run()'s
  // staging (a longer run, kGroupBatch loads in flight): one helper shared by
  // both changed how ptxas allocates run()'s registers for f32 streams, and
  // the staged loop ran 33-40% slower on an H100 at f32 K 63 ÷8 and K 127 ÷5.
  // Starts and ends as run() does.
  template <typename Y>
  __device__ __forceinline__ void run_groups(Y (&acc)[kR], const X* xrow, const X* hrow,
                                             int64_t m0, int g, int j) const {
    constexpr int kEpv = 16 / sizeof(X);          // samples per 16-byte load
    const int rows = pl.n + pl.Q - 1;
    const int64_t g0 = m0 * decim;
#pragma unroll
    for (int r = 0; r < kR; ++r) acc[r] = zero<Y>();
    __syncthreads();        // the previous tile's readers of s_x are done
    if (pl.P == decim) {
      const int cnt = rows * decim;
      auto put = [&](int e, X v) {
        const int i = div_magic(e, decim, dmul);
        s_x[(e - i * decim) * ls + i] = v;
      };
      const int nh = int(K - 1 - g0 < 0 ? 0 : (K - 1 - g0 < cnt ? K - 1 - g0 : cnt));
      for (int e = tid; e < nh; e += nt) put(e, hrow[g0 + e]);
      const int64_t t_lo = g0 + nh - (K - 1), t_hi = g0 + cnt - (K - 1);
      const int64_t t_end = t_hi < pl.T ? t_hi : pl.T;
      if (t_lo < t_end) {
        const int a = int((reinterpret_cast<uintptr_t>(xrow) / sizeof(X)) % kEpv);
        const X* base = xrow - a;
        const int64_t k_lo = (t_lo + a) / kEpv, k_hi = (t_end - 1 + a) / kEpv;
        for (int64_t k = k_lo + tid; k <= k_hi; k += int64_t(kGroupBatch) * nt) {
          float4 v[kGroupBatch];
#pragma unroll
          for (int b = 0; b < kGroupBatch; ++b)
            if (k + b * nt <= k_hi) v[b] = load16(base + (k + b * nt) * kEpv);
#pragma unroll
          for (int b = 0; b < kGroupBatch; ++b) {
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
      // decim > K: the P phases of each row, one sample per (row, plane)
      const unsigned pmul = magic(pl.P);
      for (int e = tid; e < pl.P * rows; e += nt) {
        const int i = div_magic(e, pl.P, pmul), pi = e - i * pl.P;
        const int64_t gg = g0 + int64_t(i) * decim + pi;
        const int64_t t = gg - (K - 1);
        s_x[pi * ls + i] = gg < K - 1 ? hrow[gg] : t < pl.T ? xrow[t] : zero<X>();
      }
    }
    __syncthreads();
    for (int p = g; p < pl.P; p += pl.G) {
      const int qp = (K - p + decim - 1) / decim;
      plane_fir(acc, s_x + p * ls + j * kR, s_h + p * hs, qp);
    }
  }
};

template <typename X, typename H, typename Y>
size_t smem_bytes(int nt, int pc, int qc) {
  const size_t n = size_t(nt) * kR;
  const size_t planes = size_t(pc) * (n + qc - 1) * sizeof(X);
  const size_t outs = n * sizeof(Y);
  const size_t slots = size_t(pc) * ((qc + kR - 1) / kR) * kSlots;
  return align16(slots * sizeof(H)) + (planes > outs ? planes : outs);
}

// A tile loop's launch: its plan, block size, shared memory (at most kBudget
// for the staged loop, so no opt-in above 48 KB is needed; at most
// kGroupBudget with phase groups) and grid (one block a tile; with phase
// groups the launcher caps it at the blocks that stay resident).
struct Launch {
  Plan pl;
  int threads;
  size_t smem;
  unsigned grid;
};

// The launch of a TileLoop over `channels` rows of T samples, M = T / decim > 0
// outputs each; consecutive tiles of a row start `overlap` outputs before the
// previous tile's end (so pl.tiles = ceil(M / (n - overlap))).
template <typename X, typename H, typename Y>
Launch plan(int64_t channels, int64_t T, int K, int decim, int overlap) {
  Plan pl = {};
  pl.T = T; pl.M = T / decim; pl.channels = channels; pl.K = K; pl.decim = decim;
  pl.P = decim < K ? decim : K;
  pl.Q = (K + decim - 1) / decim;
  auto bytes = [&](int nt, int pc, int qc) { return smem_bytes<X, H, Y>(nt, pc, qc); };
  // tile: no more threads than outputs need, a power of two in [32, 256]
  int nt_max = 32;
  while (nt_max < kMaxThreads && int64_t(nt_max) * kR - overlap < pl.M) nt_max *= 2;
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
  pl.G = 1; pl.lanes = nt;
  const int step = pl.n - overlap;
  pl.tiles = (pl.M + step - 1) / step;
  const int64_t n_tiles = channels * pl.tiles;
  return {pl, nt, bytes(nt, pc, qc),
          unsigned(n_tiles < 0x7fffffff ? n_tiles : 0x7fffffff)};
}

// Phase groups (see the notes at the top) in place of L's staged loop, where
// that loop cannot hold a whole tile at its widest: it chunks planes or taps,
// or its tile shrank to one warp below what the outputs need. Rewrites L and
// returns true where the grouped tile fits kGroupBudget; else leaves L as it
// is. The one place that decides G (gr4_fir_banded reports it to its caller).
template <typename X, typename H, typename Y>
bool group_phases(Launch& L) {
  Plan& pl = L.pl;
  const bool whole = pl.pc == pl.P && pl.qc == pl.Q;
  const bool narrow = L.threads == 32 && int64_t(32) * kR < pl.M;
  if (pl.P < 2 || (whole && !narrow)) return false;
  const int per = (pl.P + kMaxGroups - 1) / kMaxGroups;   // phases per group at most
  const int G = (pl.P + per - 1) / per;
  const int hs = (pl.Q + kR - 1) / kR * kSlots;
  auto bytes = [&](int lanes) {
    const int n = lanes * kR;
    const size_t planes = size_t(pl.P) * ((n + pl.Q - 1) | 1) * sizeof(X);
    const size_t outs = size_t(G) * n * sizeof(Y);
    return align16(size_t(pl.P) * hs * sizeof(H)) + (planes > outs ? planes : outs);
  };
  // lanes: whole warps, no more than the outputs need, two blocks an SM
  int lanes = 32;
  while (2 * lanes * G <= kMaxThreads && int64_t(lanes) * kR < pl.M) lanes *= 2;
  while (lanes > 32 && bytes(lanes) > kGroupPairBudget) lanes /= 2;
  if (bytes(lanes) > kGroupBudget) return false;
  pl.G = G; pl.lanes = lanes; pl.pc = pl.P; pl.qc = pl.Q;
  pl.n = lanes * kR; pl.ls = (pl.n + pl.Q - 1) | 1; pl.hs = hs;
  pl.tiles = (pl.M + pl.n - 1) / pl.n;
  const int64_t n_tiles = pl.channels * pl.tiles;
  L.threads = G * lanes;
  L.smem = bytes(lanes);
  L.grid = unsigned(n_tiles < 0x7fffffff ? n_tiles : 0x7fffffff);
  return true;
}

}  // namespace gr4fir
