// First-order recurrence (one pole) in one launch, for NVIDIA Hopper
// (sm_90a), bound through a plain C interface (ops/cuda_kernels.py loads it
// with ctypes).
//
// Replaces no Pallas kernel: the JAX package runs the recurrence as XLA ops
// (gnuradio4_tpu/ops/iir.py one_pole_apply: a blocked Toeplitz matmul and a
// log-depth scan). In the port those ops cost ~105 torch calls and ~20
// kernels a call (ops/iir.py _one_pole_blocked, _one_pole_scan), which held
// FmDeemphasis's host step at ~2 ms and took 0.35 ms of the card at
// [100, 131072]. This kernel is their one-launch form on the card.
//
// What it computes, per channel c (rows of x: [C, T], float32 or complex64):
//   u[n] = p*u[n-1] + x[n],  u[-1] = s_in[c]
//   y[n] = gain_x*x[n] + gain_u*u[n],   s_out[c] = u[T-1]
// with the pole p host-constant (real or complex) and gain_x, gain_u real
// (ops/iir.py one_pole_ba_apply's K and A; 0 and 1 for one_pole_apply).
//
// What bounds it: 8 bytes a real sample (16 complex), read once and written
// once, against 2 (8) FLOPs: HBM bandwidth, 0.031 ms at [100, 131072] f32.
// A thread walking a whole channel would leave the card idle, so:
//   1. Tiles of kTile = kThreads*kStretch samples of one channel, one block
//      each, staged through shared memory with coalesced striped loads (rows
//      padded by one word in 32, so the lanes reading their stretches hit
//      different banks). Thread t runs its stretch of kStretch samples from
//      the zero state, in registers.
//   2. The block scans its threads' end states: a shuffle scan in each warp,
//      then warp 0 over the warps' totals, with the powers p^(kStretch*2^j)
//      and p^(32*kStretch*2^j). The host forms every power p^(2^j) in float64
//      from the f32 (c64) pole and rounds it (ops/cuda_kernels.py
//      one_pole_powers); any p^n is a product of them.
//   3. The state entering the tile comes from a single-pass decoupled
//      look-back (Merrill & Garland 2016): each tile publishes its zero-state
//      end state (aggregate) at once, and its inclusive end state when it has
//      its entering state; warp 0 of tile k reads 32 predecessors at a time,
//      sums p^(kTile*i) times their values up to the nearest inclusive one.
//      Tiles of one channel are consecutive block indices; blocks start in
//      index order, so a predecessor is always resident or done.
//   4. Each thread reruns its stretch from its exact entering state (the
//      sequential loop's arithmetic), writes y in place in shared memory with
//      the gain_x/gain_u epilogue, and the block stores the tile coalesced.
//      The thread holding sample T-1 writes s_out.
//
// The look-back's workspace ([header, slots], zeroed once by the wrapper and
// kept per stream) needs no clearing between launches: a slot's flag carries
// the launch's epoch, which the last block to finish advances. Two launches
// on one stream never overlap; a workspace is never shared across streams.
// An epoch repeats after 2^30 launches, and a flag could then be mistaken
// only if its slot was last written exactly 2^30 launches before.
//
// Rounding: exact algebra; only the f32 rounding order differs from the
// sequential loop (the rerun within a stretch is that loop).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpsLog = 3;
constexpr int kStretch = 16;                 // samples a thread
constexpr int kStretchLog = 4;
constexpr int kTile = kThreads * kStretch;   // samples a block
constexpr int kTileLog = 12;
constexpr int kLevels = 32;                  // host powers p^(2^j)
constexpr unsigned kAggregate = 1, kInclusive = 2;
constexpr unsigned kEpochMask = 0x3fffffffu;

static_assert((1 << kWarpsLog) == kWarps, "warps");
static_assert((1 << kStretchLog) == kStretch, "stretch");
static_assert((1 << kTileLog) == kTile, "tile");
static_assert(kTileLog + 5 < kLevels, "the look-back's window power");

struct Powers {
  float2 p[kLevels];   // p^(2^j)
};

// One tile's look-back slot: its flag, then its aggregate and inclusive end
// states. header[0] is the epoch, header[1] the blocks done this launch.
struct Slot {
  unsigned flag, pad[3];
  float2 agg, incl;
};
static_assert(sizeof(Slot) == 32, "one sector a slot");

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// a*b and a*b + c; real values keep .y at 0
template <bool kCx>
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  if constexpr (kCx) return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
  return make_float2(a.x * b.x, 0.f);
}

template <bool kCx>
__device__ __forceinline__ float2 cmad(float2 a, float2 b, float2 c) {
  if constexpr (kCx)
    return make_float2(fmaf(a.x, b.x, fmaf(-a.y, b.y, c.x)),
                       fmaf(a.x, b.y, fmaf(a.y, b.x, c.y)));
  return make_float2(fmaf(a.x, b.x, c.x), 0.f);
}

template <bool kCx>
__device__ __forceinline__ float2 shfl_up(float2 v, int d) {
  v.x = __shfl_up_sync(0xffffffffu, v.x, d);
  if constexpr (kCx) v.y = __shfl_up_sync(0xffffffffu, v.y, d);
  return v;
}

template <bool kCx>
__device__ __forceinline__ float2 warp_sum(float2 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    if constexpr (kCx) v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  return v;
}

// p^(n*2^base) from the table, n < 2^bits
template <bool kCx, int kBits>
__device__ __forceinline__ float2 power(const float2* pw, int base, unsigned n) {
  float2 r = make_float2(1.f, 0.f);
#pragma unroll
  for (int b = 0; b < kBits; ++b)
    if (n >> b & 1u) r = cmul<kCx>(r, pw[base + b]);
  return r;
}

// word w of the tile in padded shared memory
__device__ __forceinline__ int pad(int w) { return w + (w >> 5); }

// The state entering tile k > 0 of a channel whose tiles' slots start at
// `slots`: a decoupled look-back by one warp.
template <bool kCx>
__device__ float2 look_back(Slot* slots, int64_t k, unsigned tag,
                            const float2* pw, int lane) {
  const float2 lane_pow = power<kCx, 5>(pw, kTileLog, unsigned(lane));
  float2 acc = make_float2(0.f, 0.f), scale = make_float2(1.f, 0.f);
  for (int64_t base = k - 1;; base -= 32) {
    const int64_t q = base - lane;   // tile 0 is inclusive: the walk stops there
    unsigned f = tag | kInclusive;
    if (q >= 0) {
      do {
        f = load_acquire(&slots[q].flag);
      } while ((f & ~3u) != tag || (f & 3u) == 0);   // a zeroed slot has no status
    }
    const bool incl = q >= 0 && (f & 3u) == kInclusive;
    float2 v = make_float2(0.f, 0.f);
    if (q >= 0) v = incl ? __ldcg(&slots[q].incl) : __ldcg(&slots[q].agg);
    const unsigned stop = __ballot_sync(0xffffffffu, incl);
    const int last = stop ? __ffs(int(stop)) - 1 : 31;
    float2 term = lane <= last ? cmul<kCx>(lane_pow, v) : make_float2(0.f, 0.f);
    acc = cmad<kCx>(scale, warp_sum<kCx>(term), acc);
    if (stop) return acc;
    scale = cmul<kCx>(scale, pw[kTileLog + 5]);   // p^(32*kTile)
  }
}

template <bool kCx>
__global__ void __launch_bounds__(kThreads)
one_pole_kernel(const float* __restrict__ x, float* __restrict__ y,
                const float* __restrict__ s_in, float* __restrict__ s_out,
                unsigned* __restrict__ header, Slot* __restrict__ slots,
                int64_t T, int64_t K, const Powers pw_in, float gain_x,
                float gain_u) {
  constexpr int kWords = kCx ? 2 : 1;                   // floats a sample
  constexpr int kTileWords = kTile * kWords;
  __shared__ float tile[kTileWords + kTileWords / 32];
  __shared__ float2 pw[kLevels];
  __shared__ float2 warp_in[kWarps];   // entering each warp, zero-state tile
  __shared__ float2 warp_total[kWarps];
  __shared__ float2 tile_in;
  __shared__ unsigned epoch;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t c = int64_t(blockIdx.x) / K, k = int64_t(blockIdx.x) % K;
  const int64_t first = k * kTile;
  const int64_t left = T - first;
  const int words = int(left < kTile ? left : kTile) * kWords;
  const float* xt = x + (c * T + first) * kWords;
  float* yt = y + (c * T + first) * kWords;

#pragma unroll
  for (int j = 0; j < kLevels; ++j)
    if (t == j) pw[j] = pw_in.p[j];
  if (t == 0) epoch = *static_cast<volatile unsigned*>(header);
#pragma unroll
  for (int i = 0; i < kStretch * kWords; ++i) {
    const int w = t + i * kThreads;
    tile[pad(w)] = w < words ? xt[w] : 0.f;
  }
  __syncthreads();

  auto sample = [&](int s) {
    return make_float2(tile[pad(s * kWords)], kCx ? tile[pad(s * kWords + 1)] : 0.f);
  };
  const float2 p = pw[0];

  // 1. this thread's stretch from the zero state
  float2 u = make_float2(0.f, 0.f);
#pragma unroll
  for (int j = 0; j < kStretch; ++j) u = cmad<kCx>(p, u, sample(t * kStretch + j));

  // 2. inclusive scan of the stretches' end states in the warp, then of the
  // warps' totals
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const float2 o = shfl_up<kCx>(u, 1 << j);
    if (lane >= (1 << j)) u = cmad<kCx>(pw[kStretchLog + j], o, u);
  }
  float2 before = shfl_up<kCx>(u, 1);                 // exclusive in the warp
  if (lane == 0) before = make_float2(0.f, 0.f);
  if (lane == 31) warp_total[warp] = u;
  __syncthreads();

  if (warp == 0) {
    float2 v = lane < kWarps ? warp_total[lane] : make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < kWarpsLog; ++j) {
      const float2 o = shfl_up<kCx>(v, 1 << j);
      if (lane >= (1 << j)) v = cmad<kCx>(pw[kStretchLog + 5 + j], o, v);
    }
    const float2 e = shfl_up<kCx>(v, 1);
    if (lane < kWarps) warp_in[lane] = lane == 0 ? make_float2(0.f, 0.f) : e;
    float2 agg;
    agg.x = __shfl_sync(0xffffffffu, v.x, kWarps - 1);
    agg.y = __shfl_sync(0xffffffffu, v.y, kWarps - 1);

    // 3. the state entering the tile
    Slot* chan = slots + c * K;
    const unsigned tag = (epoch & kEpochMask) << 2;
    const bool successor = k + 1 < K;
    float2 enter;
    if (k == 0) {
      enter = make_float2(s_in[c * kWords], kCx ? s_in[c * kWords + 1] : 0.f);
    } else {
      if (lane == 0 && successor) {
        __stcg(&chan[k].agg, agg);
        store_release(&chan[k].flag, tag | kAggregate);
      }
      enter = look_back<kCx>(chan, k, tag, pw, lane);
    }
    if (lane == 0) {
      tile_in = enter;
      if (successor) {
        __stcg(&chan[k].incl, cmad<kCx>(pw[kTileLog], enter, agg));
        store_release(&chan[k].flag, tag | kInclusive);
      }
    }
  }
  __syncthreads();

  // 4. the state entering this thread, then its stretch again from it
  const float2 into_warp = cmad<kCx>(power<kCx, kWarpsLog>(pw, kStretchLog + 5, warp),
                                     tile_in, warp_in[warp]);
  u = cmad<kCx>(power<kCx, 5>(pw, kStretchLog, lane), into_warp, before);
  const int64_t last = T - 1 - first - int64_t(t) * kStretch;   // T-1's index here
#pragma unroll
  for (int j = 0; j < kStretch; ++j) {
    const int s = t * kStretch + j;
    const float2 xv = sample(s);
    u = cmad<kCx>(p, u, xv);
    float2 out = make_float2(gain_u * u.x, gain_u * u.y);
    if (gain_x != 0.f) {
      out.x = fmaf(gain_x, xv.x, out.x);
      out.y = fmaf(gain_x, xv.y, out.y);
    }
    tile[pad(s * kWords)] = out.x;
    if (kCx) tile[pad(s * kWords + 1)] = out.y;
    if (j == last) {
      s_out[c * kWords] = u.x;
      if (kCx) s_out[c * kWords + 1] = u.y;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kStretch * kWords; ++i) {
    const int w = t + i * kThreads;
    if (w < words) yt[w] = tile[pad(w)];
  }

  if (t == 0) {
    __threadfence();
    if (atomicAdd(&header[1], 1u) == gridDim.x - 1) {   // the last block done
      header[1] = 0;
      header[0] = epoch + 1;
    }
  }
}

}  // namespace

extern "C" {

// Threads a block, samples a thread and powers p^(2^j) the kernel reads; the
// wrapper checks them against ops/cuda_kernels.py.
int gr4_one_pole_threads() { return kThreads; }
int gr4_one_pole_stretch() { return kStretch; }
int gr4_one_pole_levels() { return kLevels; }

// Bytes of the workspace for `tiles` look-back slots: a 32-byte header, then
// one 32-byte slot a tile. The wrapper zeroes it once.
int64_t gr4_one_pole_work_size(int64_t tiles) { return (tiles + 1) * int64_t(sizeof(Slot)); }

// x, y: [C, T] float32 (cx 0) or complex64 (cx 1); s_in, s_out: [C] of the
// same type, all contiguous on the device. powers: HOST pointer to kLevels
// values p^(2^j) of the stream's type (float32, or complex64 as re, im),
// copied into the launch's parameters. work: a device workspace of
// gr4_one_pole_work_size(capacity) bytes, zeroed before its first use and
// used on this stream alone; capacity >= C * ceil(T / kTile). Returns a
// cudaError_t (0 on success).
int gr4_one_pole(const void* x, void* y, const void* s_in, void* s_out,
                 const float* powers, void* work, int64_t capacity, int64_t C,
                 int64_t T, int cx, float gain_x, float gain_u, void* stream) {
  if (C < 0 || T < 0) return int(cudaErrorInvalidValue);
  if (C == 0 || T == 0) return int(cudaSuccess);
  const int64_t K = (T + kTile - 1) / kTile;
  if (K > 2147483647 / C || C * K > capacity) return int(cudaErrorInvalidValue);
  Powers pw;
  for (int j = 0; j < kLevels; ++j)
    pw.p[j] = cx ? make_float2(powers[2 * j], powers[2 * j + 1])
                 : make_float2(powers[j], 0.f);
  auto header = static_cast<unsigned*>(work);
  auto slots = reinterpret_cast<Slot*>(static_cast<char*>(work) + sizeof(Slot));
  auto s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = unsigned(C * K);
  auto xs = static_cast<const float*>(x);
  auto ys = static_cast<float*>(y);
  auto si = static_cast<const float*>(s_in);
  auto so = static_cast<float*>(s_out);
  if (cx)
    one_pole_kernel<true><<<blocks, kThreads, 0, s>>>(xs, ys, si, so, header, slots,
                                                      T, K, pw, gain_x, gain_u);
  else
    one_pole_kernel<false><<<blocks, kThreads, 0, s>>>(xs, ys, si, so, header, slots,
                                                       T, K, pw, gain_x, gain_u);
  return int(cudaGetLastError());
}

}  // extern "C"
