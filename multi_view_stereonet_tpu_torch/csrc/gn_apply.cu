// GroupNorm with its statistics -> LeakyReLU(0.2) -> optional residual add, and its
// backward: every GroupNorm of the serving forward and of a training step (Hopper, sm_90a).
//
// Replaces the TPU kernel
//   multi_view_stereonet_tpu/ops/pallas/gn_apply.py, gn_apply_residual_fused
//   (_fused_call -> _kernel), with the statistics of models/s2d.py gn_s2d_stats,
// which the JAX entry computes before the call. Here both are one call:
//   out = leaky_relu((x - mean_g) * rstd_g * gamma_c + beta_c, 0.2) [+ res],
// mean_g and rstd_g = 1 / sqrt(var_g + eps) over each (sample, group) of x. The same
// function without the residual is the JAX models' leaky_relu(group_norm(...)) of the
// refiners' bn0 and the cost filter (models/refiners.py, models/cost_volume.py). The JAX
// package has no backward kernel (its _bwd takes the VJP of the XLA reference); the
// backward here replaces that recompute.
//
// x is (N, C, S), S the per-channel span (H * W, or D * H * W for the 3-D filter), so one
// (sample, group) row is a contiguous run of L = (C / G) * S values (2.46 M at 480x640,
// C = 32, G = 4) and one (sample, channel) span a run of S. What bounds it on this card:
// bytes (x and res read once, out written once), and at the small shapes the launch and
// the one exchange of statistics between blocks. PyTorch's own GroupNorm reduces each row
// in one block, so the level-0 refiner keeps 4 of 132 SMs busy.
//
// The forward is two launches over chunks of each (sample, group) row (gn_stats_kernel,
// gn_apply_kernel): a statistics pass, each block summing x (+ xbias) and x^2 of its chunk
// in f64 (E[x^2] - mu^2 over 2.46 M f32 values loses digits in f32) into one partial, then
// an apply pass in which each block reduces its row's partials in a fixed order (so every
// block, and every run, gets the same mean and rstd: no atomics), reads x again (from L2
// where it fits) and res once, and writes out once. Under autograd the apply also writes
// each row's f32 mean and rstd, the values it used, for the backward. A cooperative
// forward in the backward's layout below (x held in shared memory, one grid barrier) was
// built and measured on an H100 (PERF.md §6): it won only where x has 16 MiB or more, and
// a bf16 training step moved by less than its spread, so it was taken out.
//
// The backward (gn_bwd_kernel) is one cooperative launch of at most one 512-thread block
// per SM, sized to the call (the wrapper's ``plan``). What bounds it is bytes: x and dy
// read once, dx written once. A block holds at most HOLD_BYTES of x and dy in shared
// memory, 30 MB over the card, while the recipe's 480x640 calls hold 629 MB at f32. A
// call that fits is held whole ("resident"). One that does not goes either in one wave
// whose slices read their part beyond the buffer twice ("partial": every bf16 call, and
// f32 calls that read little twice), or in waves of whole (sample, group) rows, each held
// on chip between its two passes, so that every value leaves the card's memory once
// apart from the part of a wave beyond what the blocks hold (a share of L2, read again
// while L2 still has it). A wave's values are cut into equal contiguous slices, one a
// block, each holding the first ``held`` values of its slice of x and of dy, stored there
// by the 16-byte loads of its first pass (eight in flight a thread). Bulk copies (TMA)
// and cp.async of the next wave into the buffer, and an L2 prefetch of it, were measured
// slower than these loads on an H100 (PERF.md §6). A span of at most LANE_SPAN values
// goes to one thread, of at most WARP_SPAN to one warp (no block-wide sum a span); longer
// ones to the whole block. With x_hat = (x + xbias - mean) * rstd, z = x_hat * gamma +
// beta and g = dy * leaky'(z), in each wave:
//   1. per (sample, channel) span piece, f64 partials of sum g, sum g x_hat, sum x_hat;
//      one grid barrier;
//   2. per row a = mean(g gamma), b = mean(g gamma x_hat) from the partials in a fixed
//      order; dx = rstd (g gamma - a - x_hat b), rounded to x's type, from what is held
//      (the part not held, read again, first), stored evict-first (not read again here,
//      and L2 keeps x and dy for the second read); the row's owner writes (a, b). A
//      block then goes on to the next wave at once: no barrier between waves.
// After the last wave, one grid barrier and
//   3. per channel, in a fixed order over samples and pieces: dbeta = sum g,
//      dgamma = sum g x_hat, dxbias = sum over samples of rstd (gamma G - S a - b X) with
//      G and X the span's sums of g and x_hat (the sum of dx over the span).
// d res is dy itself (the wrapper returns it).
//
// x, res, out, dy and dx are f32 or bf16 (the storage type T; gamma, beta, the statistics
// and the parameter gradients stay f32). At bf16 the tail follows the Pallas kernel
// (gn_apply.py:37-52): the apply in f32, rounded to bf16; the sign test on the f32 value;
// LeakyReLU at bf16 (the slope rounded to bf16, the product rounded); the residual added
// at bf16 (a rounded sum). The backward at bf16 differentiates what plain autograd
// differentiates there: the sign test on the bf16 value, dy times the bf16 slope rounded
// to bf16. An optional per-channel f32 ``xbias`` (the bias of the conv that wrote x) is
// added to x in f32 before the statistics and the apply, so a bf16 conv's bias add costs
// no pass of its own and is not rounded before the GroupNorm (as the Pallas kernels add it
// in f32, and as XLA computes the JAX layers' bias add there).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "grid_sync.cuh"  // grid_barrier

namespace {

constexpr int THREADS = 256;  // the forward's blocks
constexpr int WARPS = THREADS / 32;
constexpr int COOP_THREADS = 512;  // the backward's blocks
constexpr int COOP_WARPS = COOP_THREADS / 32;
constexpr int64_t HOLD_BYTES = 224 * 1024;  // shared memory a block holds slices in
constexpr int64_t LANE_SPAN = 256;   // spans up to this many values go to one thread
constexpr int64_t WARP_SPAN = 2048;  // spans up to this many values go to one warp
constexpr int UNROLL = 8;            // vectors a thread loads before it uses any
constexpr int R_MAX = 128;           // rows a block tabulates at a time
constexpr int MAX_DEVICES = 64;
constexpr float SLOPE = 0.2f;
constexpr float SLOPE_BF16 = 0.2001953125f;  // 0.2 rounded to bf16

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Four consecutive elements (16 bytes of f32, 8 of bf16) as floats, and back.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// VEC consecutive elements of T: one 16-byte vector (VEC = 16 / sizeof(T)) held raw as a
// uint4 until it is used, or one element (VEC = 1).
template <int VEC, typename T>
struct Io {
  using Raw = std::conditional_t<VEC == 1, T, uint4>;
  static_assert(VEC == 1 || VEC * sizeof(T) == 16, "a vector is 16 bytes");
  __device__ static __forceinline__ Raw load(const T* p) {
    if constexpr (VEC == 1) return *p;
    else return *reinterpret_cast<const uint4*>(p);
  }
  // A last read: evict first from L2.
  __device__ static __forceinline__ Raw load_last(const T* p) {
    if constexpr (VEC == 1) return *p;
    else return __ldcs(reinterpret_cast<const uint4*>(p));
  }
  __device__ static __forceinline__ void unpack(const Raw& r, float (&v)[VEC]) {
    if constexpr (VEC == 1) {
      v[0] = to_float(r);
    } else if constexpr (sizeof(T) == sizeof(float)) {
      v[0] = __uint_as_float(r.x);
      v[1] = __uint_as_float(r.y);
      v[2] = __uint_as_float(r.z);
      v[3] = __uint_as_float(r.w);
    } else {
      const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
        v[2 * k] = f.x;
        v[2 * k + 1] = f.y;
      }
    }
  }
  // v rounded to T, as one Raw.
  __device__ static __forceinline__ Raw pack(const float (&v)[VEC]) {
    if constexpr (VEC == 1) {
      if constexpr (sizeof(T) == sizeof(float)) return v[0];
      else return __float2bfloat16_rn(v[0]);
    } else if constexpr (sizeof(T) == sizeof(float)) {
      return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                        __float_as_uint(v[3]));
    } else {
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
        w[k] = *reinterpret_cast<const uint32_t*>(&h);
      }
      return make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  __device__ static __forceinline__ void store(T* p, const float (&v)[VEC]) {
    *reinterpret_cast<Raw*>(p) = pack(v);
  }
  // A store not read again here: evict first from L2.
  __device__ static __forceinline__ void store_last(T* p, const float (&v)[VEC]) {
    if constexpr (VEC == 1) *p = pack(v);
    else __stcs(reinterpret_cast<uint4*>(p), pack(v));
  }
};

// n / d for 0 <= n < 2^31 by a multiply and a shift (d >= 1 fixed for a launch).
struct IntDiv {
  uint32_t d, m, s;
  __host__ __device__ IntDiv(uint32_t divisor = 1) : d(divisor), s(0) {
    while ((1u << s) < d && s < 31) ++s;
    m = (uint32_t)(((uint64_t)1 << 32) * (((uint64_t)1 << s) - d) / d + 1);
  }
  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return (__umulhi(n, m) + n) >> s;
  }
};

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The tail of one element at storage type T (``res`` tells whether r is a residual).
template <typename T>
__device__ __forceinline__ float tail(float v, float mu, float rs, float g, float b, float r,
                                      bool res) {
  const float y = (v - mu) * rs * g + b;
  if constexpr (sizeof(T) == sizeof(float)) {
    return (y >= 0.0f ? y : SLOPE * y) + r;
  } else {
    float o = round_bf16(y);
    if (!(y >= 0.0f)) o = round_bf16(SLOPE_BF16 * o);
    return res ? round_bf16(o + r) : o;
  }
}

// dy times LeakyReLU's derivative at z, as plain autograd takes it at T: at f32 the
// slope where z <= 0; at bf16 where the bf16 value of z is below 0, dy times the bf16
// slope rounded to bf16.
template <typename T>
__device__ __forceinline__ float dleaky(float z, float dy) {
  if constexpr (sizeof(T) == sizeof(float)) return z > 0.0f ? dy : dy * SLOPE;
  else return round_bf16(z) >= 0.0f ? dy : round_bf16(dy * SLOPE_BF16);
}

// ----------------------------------------------------------------------- the forward

// Chunk c of row r covers elements [c * chunk, min(L, (c + 1) * chunk)) of the row; chunk
// is a multiple of VEC, and rows start 16-byte aligned when VEC == 4.
template <int VEC, typename T>
__global__ void __launch_bounds__(THREADS)
gn_stats_kernel(const T* __restrict__ x, const float* __restrict__ xbias,
                double2* __restrict__ partials, int64_t L, int64_t chunk, int chunks, int64_t S,
                int C, int G) {
  __shared__ double red[2][WARPS];
  const int row = blockIdx.y;
  const int64_t begin = (int64_t)blockIdx.x * chunk;
  const int64_t end = begin + chunk < L ? begin + chunk : L;
  const T* xr = x + (int64_t)row * L;
  const int c0 = (row % G) * (C / G);
  double s = 0.0, ss = 0.0;
  for (int64_t i = begin + (int64_t)threadIdx.x * VEC; i < end; i += (int64_t)THREADS * VEC) {
    if constexpr (VEC == 4) {
      float4 v = load4(xr + i);
      if (xbias != nullptr) {
        const float xb = xbias[c0 + (int)(i / S)];
        v = make_float4(v.x + xb, v.y + xb, v.z + xb, v.w + xb);
      }
      const double a = v.x, b = v.y, c = v.z, d = v.w;
      s += (a + b) + (c + d);
      ss += (a * a + b * b) + (c * c + d * d);
    } else {
      float v = to_float(xr[i]);
      if (xbias != nullptr) v += xbias[c0 + (int)(i / S)];
      const double a = v;
      s += a;
      ss += a * a;
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    red[0][warp] = s;
    red[1][warp] = ss;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double S = 0.0, SS = 0.0;
    for (int w = 0; w < WARPS; ++w) {
      S += red[0][w];
      SS += red[1][w];
    }
    partials[(int64_t)row * chunks + blockIdx.x] = make_double2(S, SS);
  }
}

// res == nullptr: no residual; xbias == nullptr: none; stats == nullptr: not written.
template <int VEC, typename T>
__global__ void __launch_bounds__(THREADS)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ xbias,
                const T* __restrict__ res, const float* __restrict__ gamma,
                const float* __restrict__ beta,
                const double2* __restrict__ partials, T* __restrict__ out,
                float* __restrict__ stats, int64_t L, int64_t chunk, int chunks, int64_t S,
                int C, int G, float eps) {
  __shared__ float stat[2];
  const int row = blockIdx.y;
  if (threadIdx.x < 32) {
    double s = 0.0, ss = 0.0;
    for (int i = threadIdx.x; i < chunks; i += 32) {
      const double2 p = partials[(int64_t)row * chunks + i];
      s += p.x;
      ss += p.y;
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    if (threadIdx.x == 0) {
      const double mean = s / (double)L;
      const double var = fmax(ss / (double)L - mean * mean, 0.0);
      stat[0] = (float)mean;
      stat[1] = (float)(1.0 / sqrt(var + (double)eps));
      if (stats != nullptr && blockIdx.x == 0) {
        stats[2 * row] = stat[0];
        stats[2 * row + 1] = stat[1];
      }
    }
  }
  __syncthreads();
  const float mu = stat[0], rs = stat[1];
  const bool has_res = res != nullptr;
  const int c0 = (row % G) * (C / G);
  const int64_t base = (int64_t)row * L;
  const int64_t begin = (int64_t)blockIdx.x * chunk;
  const int64_t end = begin + chunk < L ? begin + chunk : L;
  for (int64_t i = begin + (int64_t)threadIdx.x * VEC; i < end; i += (int64_t)THREADS * VEC) {
    const int c = c0 + (int)(i / S);  // a float4 never straddles channels: S % 4 == 0
    const float g = gamma[c], b = beta[c];
    if constexpr (VEC == 4) {
      float4 v = load4(x + base + i);
      if (xbias != nullptr) {
        const float xb = xbias[c];
        v = make_float4(v.x + xb, v.y + xb, v.z + xb, v.w + xb);
      }
      const float4 r = has_res ? load4(res + base + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      store4(out + base + i,
             make_float4(tail<T>(v.x, mu, rs, g, b, r.x, has_res),
                         tail<T>(v.y, mu, rs, g, b, r.y, has_res),
                         tail<T>(v.z, mu, rs, g, b, r.z, has_res),
                         tail<T>(v.w, mu, rs, g, b, r.w, has_res)));
    } else {
      float v = to_float(x[base + i]);
      if (xbias != nullptr) v += xbias[c];
      store1(out + base + i, tail<T>(v, mu, rs, g, b,
                                  has_res ? to_float(res[base + i]) : 0.0f, has_res));
    }
  }
}

// ---------------------------------------------------------------------- the backward

// How the N * C * S values are cut. The N * G rows go into ``waves`` waves of whole rows,
// wave w the rows [w * rows / waves, (w + 1) * rows / waves) (R or R + 1 of them), and
// each wave's values [e0, e1) into one contiguous slice a block, of q = (e1 - e0) /
// blocks values rounded up to a multiple of 8 (qa for a wave of R rows, qb for one of
// R + 1; the last slices may be shorter, or empty). Block b holds the first ``held``
// values of its slice of x and of dy in shared memory. Span sg (sample sg / C, channel
// sg % C) covers [sg * S, (sg + 1) * S) and meets blocks (sg * S - e0) / q to
// ((sg + 1) * S - 1 - e0) / q of its wave, at most maxb of them; its piece in block b has
// partial slot sg * maxb + b - (sg * S - e0) / q. The host computes the two slices and
// their divisions, so that they stay in the launch's parameters and out of registers.
struct Geometry {
  int64_t E, S, L, held;  // L: values a row; held: values of x (and of dy) a block holds
  int64_t qa, qb;
  int C, G, rows, waves, maxb, R;
  IntDiv divS, divC, divCG, divQa, divQb;  // by S, C, C / G, qa and qb (below 2^31)
};

// One wave's values [e0, e1); ``big``: R + 1 rows (slices of qb, else qa).
struct Wave {
  int64_t e0, e1;
  bool big;
};

__host__ __device__ __forceinline__ int64_t slice(int64_t values, int blocks) {
  return ((values + blocks - 1) / blocks + 7) / 8 * 8;
}

__device__ __forceinline__ Wave wave(const Geometry& g, int w) {
  const int r0 = (int)((int64_t)w * g.rows / g.waves);
  const int r1 = (int)((int64_t)(w + 1) * g.rows / g.waves);
  return Wave{r0 * g.L, r1 * g.L, r1 - r0 > g.R};
}
__device__ __forceinline__ int64_t wave_q(const Geometry& g, const Wave& v) {
  return v.big ? g.qb : g.qa;
}

__device__ __forceinline__ int wave_of_row(const Geometry& g, int64_t r) {
  return (int)(((r + 1) * g.waves - 1) / g.rows);
}

__device__ __forceinline__ uint32_t block_of(const Geometry& g, const Wave& v, int64_t e) {
  return v.big ? g.divQb.div((uint32_t)(e - v.e0)) : g.divQa.div((uint32_t)(e - v.e0));
}
__device__ __forceinline__ int64_t first_block(const Geometry& g, const Wave& v, int64_t sg) {
  return block_of(g, v, sg * g.S);
}
__device__ __forceinline__ bool has_piece(const Geometry& g, const Wave& v, int64_t sg, int m) {
  return first_block(g, v, sg) + m <= block_of(g, v, (sg + 1) * g.S - 1);
}
__device__ __forceinline__ int64_t slot(const Geometry& g, const Wave& v, int64_t sg, int b) {
  return sg * g.maxb + (b - first_block(g, v, sg));
}

// The sums of K doubles over the block, in thread 0.
template <int K>
__device__ __forceinline__ void block_sum(double (&v)[K], double (*red)[COOP_WARPS]) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[k][warp] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      double s = 0.0;
      for (int w = 0; w < COOP_WARPS; ++w) s += red[k][w];
      v[k] = s;
    }
  }
  __syncthreads();
}

// How phase 1 takes the span pieces: a thread, a warp or the whole block a piece.
enum Mode { LANE = 0, WARP = 1, BLOCK = 2 };

__device__ __forceinline__ Mode piece_mode(const Geometry& g) {
  return g.S <= LANE_SPAN ? LANE : g.S <= WARP_SPAN ? WARP : BLOCK;
}

// Calls body(sg, lo, hi) for each span piece of [rlo, rhi) (offsets in the block's slice
// from s0) that this thread takes part in, in increasing order: the threads (LANE) or the
// warps (WARP) take the pieces in turn; every thread takes every piece (BLOCK).
template <typename Body>
__device__ __forceinline__ void for_pieces(const Geometry& g, int64_t s0, int64_t rlo,
                                           int64_t rhi, Mode mode, Body body) {
  if (rlo >= rhi) return;
  const int64_t sg0 = (s0 + rlo) / g.S, sg1 = (s0 + rhi - 1) / g.S;
  const int64_t step = mode == LANE ? COOP_THREADS : mode == WARP ? COOP_WARPS : 1;
  const int64_t first = mode == LANE ? threadIdx.x : mode == WARP ? (threadIdx.x >> 5) : 0;
  for (int64_t sg = sg0 + first; sg <= sg1; sg += step) {
    const int64_t lo = (sg * g.S > s0 + rlo ? sg * g.S : s0 + rlo) - s0;
    const int64_t hi = ((sg + 1) * g.S < s0 + rhi ? (sg + 1) * g.S : s0 + rhi) - s0;
    body(sg, lo, hi);
  }
}

// The K sums of a piece from every thread that took it, in the thread that writes them
// (LANE: itself; WARP: lane 0; BLOCK: thread 0); returns whether this thread writes.
template <int K>
__device__ __forceinline__ bool piece_sum(double (&v)[K], Mode mode,
                                          double (*red)[COOP_WARPS]) {
  if (mode == LANE) return true;
  if (mode == WARP) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
    return (threadIdx.x & 31) == 0;
  }
  block_sum<K>(v, red);
  return threadIdx.x == 0;
}

// (span, channel, row) of value e (< 2^31) of x.
__device__ __forceinline__ void locate(const Geometry& g, uint32_t e, uint32_t* c,
                                       uint32_t* r) {
  const uint32_t sg = g.divS.div(e);
  *c = sg - g.divC.div(sg) * (uint32_t)g.C;
  *r = g.divCG.div(sg);
}

template <typename T>
struct Bwd {
  const T* x;
  const float* xbias;  // or null
  const float* gamma;
  const float* beta;
  const float* stats;  // (N * G, 2): the forward's mean and rstd
  const T* dy;
  T* dx;
  float* dgamma;
  float* dbeta;
  float* dxbias;       // or null
  double2* partials;   // N * C * maxb * 2: (sum g, sum g x_hat), (sum x_hat, 0)
  double2* ab;         // (N * G): a and b of each row
  unsigned int* barrier;
  Geometry g;
};

// a and b of row r (mean of g gamma, of g gamma x_hat) from the partials of its spans in
// a fixed order; all lanes of the calling warp get them.
__device__ __forceinline__ double2 row_ab(const Geometry& g, const Wave& v,
                                          const double2* partials, const float* gamma,
                                          int64_t r) {
  const int cg = g.C / g.G, lane = threadIdx.x & 31;
  double A = 0.0, B = 0.0;
  for (int t = lane; t < cg * g.maxb; t += 32) {
    const int64_t sg = r * cg + t / g.maxb;
    if (has_piece(g, v, sg, t % g.maxb)) {
      const double2 p = __ldcg(partials + 2 * (sg * g.maxb + t % g.maxb));
      const double gm = gamma[sg % g.C];
      A += gm * p.x;
      B += gm * p.y;
    }
  }
  const double L = (double)g.L;
  return make_double2(warp_sum(A) / L, warp_sum(B) / L);
}

// Block b's slice of a wave: values [s0, s0 + n) of x, the first h held, rows r_first to
// r_last.
struct Slice {
  Wave v;
  int64_t s0, n, h, r_first, r_last;
};

// WAVES false: the one wave of the launch, its slicing constant (no state in registers).
template <bool WAVES>
__device__ __forceinline__ Slice slice_of(const Geometry& g, int w, int b) {
  Slice s;
  s.v = WAVES ? wave(g, w) : Wave{0, g.E, false};
  const int64_t q = wave_q(g, s.v);
  s.s0 = s.v.e0 + (int64_t)b * q;
  s.n = s.s0 >= s.v.e1 ? 0 : q < s.v.e1 - s.s0 ? q : s.v.e1 - s.s0;
  s.h = g.held < s.n ? g.held : s.n;
  s.r_first = s.s0 / g.L;
  s.r_last = s.n > 0 ? (s.s0 + s.n - 1) / g.L : s.r_first - 1;
  return s;
}

// The part of dx of [lo, hi) of slice s, its rows' (mean, rstd, a, b) in tab (row
// r_first + i at i): x and dy from the buffer below s.h, read again from x and dy (L2,
// evict first) above; dx stored evict-first.
template <int VEC, typename T>
__device__ __forceinline__ void dx_range(const Bwd<T>& a, const Slice& s, const float4* tab,
                                         const T* sx, const T* sdy, int64_t lo, int64_t hi) {
  using V = Io<VEC, T>;
  using Raw = typename V::Raw;
  constexpr int64_t STRIDE = (int64_t)COOP_THREADS * VEC;
  const Geometry& g = a.g;
  const T* const gx = a.x + s.s0;
  const T* const gdy = a.dy + s.s0;
  for (int64_t i0 = lo + (int64_t)threadIdx.x * VEC; i0 < hi; i0 += UNROLL * STRIDE) {
    Raw xr[UNROLL], dr[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t i = i0 + u * STRIDE;
      if (i < hi) {
        xr[u] = i < s.h ? V::load(sx + i) : V::load_last(gx + i);
        dr[u] = i < s.h ? V::load(sdy + i) : V::load_last(gdy + i);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t i = i0 + u * STRIDE;
      if (i < hi) {
        uint32_t c, r;
        locate(g, (uint32_t)(s.s0 + i), &c, &r);
        const float4 st = tab[r - s.r_first];
        const float gm = __ldg(a.gamma + c), bt = __ldg(a.beta + c);
        const float xb = a.xbias != nullptr ? __ldg(a.xbias + c) : 0.0f;
        float xv[VEC], d[VEC], o[VEC];
        V::unpack(xr[u], xv);
        V::unpack(dr[u], d);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xh = (xv[e] + xb - st.x) * st.y;
          const float gg = dleaky<T>(xh * gm + bt, d[e]) * gm;
          o[e] = st.y * ((gg - st.z) - xh * st.w);
        }
        V::store_last(a.dx + s.s0 + i, o);
      }
    }
  }
}

// The rows of slice s: (mean, rstd, a, b) into tab (a warp a row), a and b from the
// partials of the row's spans in a fixed order; the owner of a row (the block its first
// value is in) writes its (a, b).
template <typename T>
__device__ __forceinline__ void row_table(const Bwd<T>& a, const Slice& s, float4* tab) {
  const int lane = threadIdx.x & 31;
  for (int64_t r = s.r_first + (threadIdx.x >> 5); r <= s.r_last; r += COOP_WARPS) {
    const double2 ab = row_ab(a.g, s.v, a.partials, a.gamma, r);
    if (lane == 0) {
      tab[r - s.r_first] = make_float4(a.stats[2 * r], a.stats[2 * r + 1], (float)ab.x,
                                       (float)ab.y);
      if (r * a.g.L >= s.s0) a.ab[r] = ab;
    }
  }
}

// The backward, wave by wave: pass 1 of a wave reads each block's slice of x and dy
// (16-byte loads, eight in flight a thread), stores its first ``held`` values in the
// block's buffer in shared memory and writes the f64 partials of its span pieces; one
// grid barrier; pass 2 writes dx of the wave from what is held (the rest read again). A
// block goes on to the next wave as soon as its own pass 2 is done: its buffer is its
// own, and the next wave's rows are not this wave's. After the last wave, one grid
// barrier more, then pass 3. WAVES false: a launch of one wave, compiled without the
// loop's state.
template <int VEC, typename T, bool WAVES>
__global__ void __launch_bounds__(COOP_THREADS, 1) gn_bwd_kernel(const Bwd<T> a) {
  using V = Io<VEC, T>;
  using Raw = typename V::Raw;
  constexpr int64_t STRIDE = (int64_t)COOP_THREADS * VEC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ double red[3][COOP_WARPS];
  __shared__ float4 rtab[R_MAX];  // a window's rows' mean, rstd, a and b
  const Geometry& g = a.g;
  T* const sx = reinterpret_cast<T*>(smem_raw);
  T* const sdy = sx + g.held;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Mode mode = piece_mode(g);
  const int cg = g.C / g.G;
  for (int w = 0; w < (WAVES ? g.waves : 1); ++w) {
    const Slice s = slice_of<WAVES>(g, w, b);
    const int64_t s0 = s.s0, n = s.n, h = s.h, r_first = s.r_first, r_last = s.r_last;
    __syncthreads();  // the last wave's pass 2 is done with rtab and the buffer
    for (int64_t r = r_first + tid; r <= r_last && r < r_first + R_MAX; r += COOP_THREADS)
      rtab[r - r_first] = make_float4(a.stats[2 * r], a.stats[2 * r + 1], 0.0f, 0.0f);
    __syncthreads();
    const T* const gx = a.x + s0;
    const T* const gdy = a.dy + s0;

    // 1. f64 sums of g, g x_hat and x_hat over each span piece.
    for_pieces(g, s0, 0, n, mode, [&](int64_t sg, int64_t lo, int64_t hi) {
      const int64_t r = sg / cg;
      const int c = (int)(sg % g.C);
      const float mu = r - r_first < R_MAX ? rtab[r - r_first].x : a.stats[2 * r];
      const float rs = r - r_first < R_MAX ? rtab[r - r_first].y : a.stats[2 * r + 1];
      const float gm = a.gamma[c], bt = a.beta[c];
      const float xb = a.xbias != nullptr ? a.xbias[c] : 0.0f;
      const int64_t stride = mode == LANE ? VEC : mode == WARP ? 32 * VEC : STRIDE;
      double sums[3] = {0.0, 0.0, 0.0};
      for (int64_t i0 = lo + (mode == LANE ? 0 : (int64_t)(mode == WARP ? lane : tid) * VEC);
           i0 < hi; i0 += UNROLL * stride) {
        Raw xr[UNROLL], dr[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int64_t i = i0 + u * stride;
          if (i < hi) {
            xr[u] = V::load(gx + i);
            dr[u] = V::load(gdy + i);
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int64_t i = i0 + u * stride;
          if (i < hi) {
            if (i < h) {  // held for the second pass
              *reinterpret_cast<Raw*>(sx + i) = xr[u];
              *reinterpret_cast<Raw*>(sdy + i) = dr[u];
            }
            float xv[VEC], d[VEC];
            V::unpack(xr[u], xv);
            V::unpack(dr[u], d);
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              const float xh = (xv[e] + xb - mu) * rs;
              const float gv = dleaky<T>(xh * gm + bt, d[e]);
              sums[0] += (double)gv;
              sums[1] += (double)gv * (double)xh;
              sums[2] += (double)xh;
            }
          }
        }
      }
      if (piece_sum<3>(sums, mode, red)) {
        double2* p = a.partials + 2 * slot(g, s.v, sg, b);
        p[0] = make_double2(sums[0], sums[1]);
        p[1] = make_double2(sums[2], 0.0);
      }
    });
    grid_barrier(a.barrier);

    // 2. dx, R_MAX rows at a time: the rows' (a, b) into rtab (a warp a row), then
    // every value of the rows in the slice, the re-read part first (the most recently
    // read), then the held part; the owner of a row (the block its first value is in)
    // writes its (a, b).
    for (int64_t w0 = r_first; w0 <= r_last; w0 += R_MAX) {
      const int64_t w1 = w0 + R_MAX < r_last + 1 ? w0 + R_MAX : r_last + 1;
      Slice win = s;  // the window's rows, as dx_range reads them
      win.r_first = w0;
      win.r_last = w1 - 1;
      __syncthreads();
      row_table(a, win, rtab);
      __syncthreads();
      const int64_t lo = (w0 * g.L > s0 ? w0 * g.L : s0) - s0;
      const int64_t hi = (w1 * g.L < s0 + n ? w1 * g.L : s0 + n) - s0;
      dx_range<VEC>(a, win, rtab, sx, sdy, lo > h ? lo : h, hi);
      dx_range<VEC>(a, win, rtab, sx, sdy, lo, hi < h ? hi : h);
    }
  }
  grid_barrier(a.barrier);

  // 3. dbeta, dgamma and dxbias of channel c, by warp (c / P) % COOP_WARPS of block c % P,
  // over (sample, piece) in a fixed order.
  const int P = gridDim.x;
  const int64_t N = g.E / ((int64_t)g.C * g.S);
  for (int c = b + P * warp; c < g.C; c += P * COOP_WARPS) {
    const double gm = a.gamma[c];
    double db = 0.0, dg = 0.0, dxb = 0.0;
    int wc = -1;
    Wave v;
    for (int64_t t = lane; t < N * g.maxb; t += 32) {
      const int64_t sg = (t / g.maxb) * g.C + c;
      const int m = (int)(t % g.maxb);
      const int64_t r = sg / cg;
      const int wr = WAVES ? wave_of_row(g, r) : 0;
      if (wr != wc) {
        v = WAVES ? wave(g, wr) : Wave{0, g.E, false};
        wc = wr;
      }
      if (has_piece(g, v, sg, m)) {
        const double2 p0 = __ldcg(a.partials + 2 * (sg * g.maxb + m));
        const double2 p1 = __ldcg(a.partials + 2 * (sg * g.maxb + m) + 1);
        const double2 ab = __ldcg(a.ab + r);
        const double rs = a.stats[2 * r + 1];
        db += p0.x;
        dg += p0.y;
        dxb += rs * (gm * p0.x - ab.y * p1.x);
        if (m == 0) dxb -= rs * (double)g.S * ab.x;
      }
    }
    db = warp_sum(db);
    dg = warp_sum(dg);
    dxb = warp_sum(dxb);
    if (lane == 0) {
      a.dbeta[c] = (float)db;
      a.dgamma[c] = (float)dg;
      if (a.dxbias != nullptr) a.dxbias[c] = (float)dxb;
    }
  }
}

// ----------------------------------------------------------------------- launchers

// The cooperative launch of ``kernel`` over ``blocks`` blocks with ``smem`` bytes of
// dynamic shared memory. A grid the card cannot hold at once is refused
// (cudaErrorCooperativeLaunchTooLarge); the refused launch's error is cleared.
// ``ready`` (one flag a device, the caller's for this kernel) records that the kernel may
// take HOLD_BYTES of dynamic shared memory on the device.
template <typename Args>
int coop_launch(void (*kernel)(const Args), bool* ready, const Args& a, int blocks,
                size_t smem, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)HOLD_BYTES);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  void* args[] = {const_cast<Args*>(&a)};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(COOP_THREADS),
                                    args, smem, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// The geometry of a backward launch, or false for one the kernel does not take: fewer
// than 2^31 values, 1 to N * G waves, ``held`` (values a tensor) a multiple of 8 within
// HOLD_BYTES for x and dy, and ``slots`` partials enough.
bool geometry(Geometry* g, int N, int C, int G, int64_t S, int blocks, int waves,
              int64_t held, int64_t slots, size_t elem) {
  if (N <= 0 || S <= 0 || C <= 0 || G <= 0 || C % G || blocks < 1 || waves < 1 ||
      waves > N * G || held < 0 || held % 8 || held * (int64_t)elem * 2 > HOLD_BYTES)
    return false;
  g->E = (int64_t)N * C * S;
  g->S = S;
  g->L = (int64_t)(C / G) * S;
  g->held = held;
  g->C = C;
  g->G = G;
  g->rows = N * G;
  g->waves = waves;
  if (g->E >= ((int64_t)1 << 31)) return false;
  g->R = g->rows / waves;
  g->qa = slice(g->R * g->L, blocks);
  g->qb = slice((g->R + 1) * g->L, blocks);
  g->maxb = (int)((S + g->qa - 1) / g->qa + 1);
  if (slots < (int64_t)N * C * g->maxb) return false;
  g->divS = IntDiv((uint32_t)S);
  g->divC = IntDiv((uint32_t)C);
  g->divCG = IntDiv((uint32_t)(C / G));
  g->divQa = IntDiv((uint32_t)g->qa);
  g->divQb = IntDiv((uint32_t)g->qb);
  return true;
}

template <typename T>
int backward(const T* x, const float* xbias, const float* gamma, const float* beta,
             const float* stats, const T* dy, T* dx, float* dgamma, float* dbeta,
             float* dxbias, double* partials, double* ab, unsigned int* barrier, int N, int C,
             int G, int64_t S, int blocks, int waves, int64_t held, int64_t slots,
             int vec, cudaStream_t stream) {
  if (N == 0 || S == 0) return 0;
  Bwd<T> a{x, xbias, gamma, beta, stats, dy, dx, dgamma, dbeta, dxbias,
           reinterpret_cast<double2*>(partials), reinterpret_cast<double2*>(ab), barrier, {}};
  if (!geometry(&a.g, N, C, G, S, blocks, waves, held, slots, sizeof(T)))
    return (int)cudaErrorInvalidValue;
  static bool ready[4][MAX_DEVICES] = {};
  constexpr int VEC = 16 / sizeof(T);
  const size_t smem = 2 * (size_t)held * sizeof(T);
  const bool vector = vec == VEC;
  if (waves > 1)
    return vector ? coop_launch(gn_bwd_kernel<VEC, T, true>, ready[0], a, blocks, smem, stream)
                  : coop_launch(gn_bwd_kernel<1, T, true>, ready[1], a, blocks, smem, stream);
  return vector ? coop_launch(gn_bwd_kernel<VEC, T, false>, ready[2], a, blocks, smem, stream)
                : coop_launch(gn_bwd_kernel<1, T, false>, ready[3], a, blocks, smem, stream);
}

template <int VEC, typename T>
int forward_vec(const T* x, const float* xbias, const T* res, const float* gamma,
                const float* beta, T* out, float* stats, double2* partials, int rows,
                int64_t L, int64_t chunk, int chunks, int64_t S, int C, int G, float eps,
                cudaStream_t stream) {
  const dim3 grid(chunks, rows);
  gn_stats_kernel<VEC, T><<<grid, THREADS, 0, stream>>>(x, xbias, partials, L, chunk, chunks,
                                                        S, C, G);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_apply_kernel<VEC, T><<<grid, THREADS, 0, stream>>>(x, xbias, res, gamma, beta, partials,
                                                        out, stats, L, chunk, chunks, S, C, G,
                                                        eps);
  return (int)cudaGetLastError();
}

template <typename T>
int forward(const T* x, const float* xbias, const T* res, const float* gamma,
            const float* beta, T* out, float* stats, double* partials, int N, int C, int G,
            int64_t S, int64_t chunk, int chunks, int vec, float eps, cudaStream_t stream) {
  if (N == 0 || S == 0) return 0;
  const int rows = N * G;
  const int64_t L = (int64_t)(C / G) * S;
  double2* p = reinterpret_cast<double2*>(partials);
  if (vec == 4)
    return forward_vec<4>(x, xbias, res, gamma, beta, out, stats, p, rows, L, chunk, chunks, S,
                          C, G, eps, stream);
  return forward_vec<1>(x, xbias, res, gamma, beta, out, stats, p, rows, L, chunk, chunks, S,
                        C, G, eps, stream);
}

}  // namespace

// The forward. x, out (N, C, S) contiguous, res the same or null (no residual); gamma,
// beta (C,); xbias (C,) f32 or null; stats (N * G, 2) f32 or null (not written). Each
// (sample, group) row of L = (C / G) * S values is cut into ``chunks`` chunks of ``chunk``
// values (a multiple of 4 when vec == 4); partials (N * G, chunks) of (sum, sum of
// squares) f64 scratch. vec == 4 needs S % 4 == 0 and x, res and out aligned to 4
// elements; vec == 1 takes one value at a time. Returns a cudaError_t code.
extern "C" int mvs_gn_act_f32(const float* x, const float* xbias, const float* res,
                              const float* gamma, const float* beta, float* out, float* stats,
                              double* partials, int N, int C, int G, int64_t S, int64_t chunk,
                              int chunks, int vec, float eps, cudaStream_t stream) {
  return forward(x, xbias, res, gamma, beta, out, stats, partials, N, C, G, S, chunk, chunks,
                 vec, eps, stream);
}

// The same with x, res and out bf16.
extern "C" int mvs_gn_act_bf16(const __nv_bfloat16* x, const float* xbias,
                               const __nv_bfloat16* res, const float* gamma, const float* beta,
                               __nv_bfloat16* out, float* stats, double* partials, int N, int C,
                               int G, int64_t S, int64_t chunk, int chunks, int vec, float eps,
                               cudaStream_t stream) {
  return forward(x, xbias, res, gamma, beta, out, stats, partials, N, C, G, S, chunk, chunks,
                 vec, eps, stream);
}

// The backward. x, dy, dx (N, C, S) contiguous, of one type; gamma, beta (C,); xbias (C,)
// f32 or null; stats: the forward's (N * G, 2) mean and rstd; dgamma, dbeta (C,) f32;
// dxbias (C,) f32, or null with xbias null. The N * G (sample, group) rows go in ``waves``
// waves of whole rows (wave w: rows [w * N * G / waves, (w + 1) * N * G / waves)), each
// wave's values cut into ``blocks`` slices of q values (the wave's values over blocks,
// rounded up to a multiple of 8; the last slices may be shorter or empty), each block
// holding the first ``held`` (a multiple of 8) of its slice of x and of dy in shared
// memory (2 * held values). partials: ``slots`` pairs of pairs of f64 scratch, at least
// N * C * (ceil(S / q) + 1) for the least q of a wave; ab: (N * G) pairs of f64 scratch.
// barrier: a uint32 that no launch on another stream uses at the same time, 0 before its
// first launch (a launch leaves it ready for the next). vec == 16 / sizeof(T) (one 16-byte
// vector) needs S % vec == 0 and x, dy and dx 16-byte aligned; any other vec takes one
// value at a time.
// Returns a cudaError_t code: cudaErrorInvalidValue for a geometry it does not take,
// cudaErrorCooperativeLaunchTooLarge for more blocks than the card holds at once (a
// refused launch's error is cleared, so none is left pending).
extern "C" int mvs_gn_act_bwd_f32(const float* x, const float* xbias, const float* gamma,
                                  const float* beta, const float* stats, const float* dy,
                                  float* dx, float* dgamma, float* dbeta, float* dxbias,
                                  double* partials, double* ab, unsigned int* barrier, int N,
                                  int C, int G, int64_t S, int blocks, int waves, int64_t held,
                                  int64_t slots, int vec, cudaStream_t stream) {
  return backward(x, xbias, gamma, beta, stats, dy, dx, dgamma, dbeta, dxbias, partials, ab,
                  barrier, N, C, G, S, blocks, waves, held, slots, vec, stream);
}

extern "C" int mvs_gn_act_bwd_bf16(const __nv_bfloat16* x, const float* xbias,
                                   const float* gamma, const float* beta, const float* stats,
                                   const __nv_bfloat16* dy, __nv_bfloat16* dx, float* dgamma,
                                   float* dbeta, float* dxbias, double* partials, double* ab,
                                   unsigned int* barrier, int N, int C, int G, int64_t S,
                                   int blocks, int waves, int64_t held, int64_t slots, int vec,
                                   cudaStream_t stream) {
  return backward(x, xbias, gamma, beta, stats, dy, dx, dgamma, dbeta, dxbias, partials, ab,
                  barrier, N, C, G, S, blocks, waves, held, slots, vec, stream);
}
