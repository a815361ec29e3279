// Fused incremental feature chain (Hopper, sm_90a): one thread-block cluster per sample.
//
// Replaces the TPU kernel
//   multi_view_stereonet_tpu/ops/pallas/incremental_chain.py, incremental_chain_fused
//   (_chain_fwd_impl -> _run_chain -> _chain_kernel),
// whose semantics are _incremental_scan (multi_view_stereonet_tpu/models/mvsnet.py:218-234).
// For each sample n and hypothesis step d = 0 .. D-2:
//   1. grid from H_inc[n, d] as ops/warp.py homography_grid: H [x, y, 1], divide by z,
//      normalize x' = 2 (u + 0.5) / w - 1;
//   2. invalid = |g| > 1 before the clamp;
//   3. bilinear, border-clamped sample of the carry (hypothesis d's features), invalid
//      samples zeroed -> warped;
//   4-5. conv0 3x3 over [image(3), warped(32)] + b0, GroupNorm(4, eps 1e-5, one-pass
//      E[x^2] - mu^2 clamped >= 0), LeakyReLU(0.2) -> h;
//   6. resblock: h + LeakyReLU(GN(conv(h) + br));
//   7. conv_final + bf -> delta; features(d + 1) = warped + delta.
// All convs use zero "same" padding. out[n, 0] = feats0; out[n, d + 1] is step d's result
// and the next step's carry.
//
// What bounds it on this card: the multiply-adds, ~34 M a step at 30 x 40 x 32 (three 3x3
// convs), eleven steps in sequence, each stage needing the one before it complete over
// the whole map (GroupNorm statistics, conv halos): latency and the rate of a few SMs,
// not bytes. The first design ran a sample on one SM with f32 FMAs.
//
// Design: a thread-block cluster runs one sample: 16 blocks (the non-portable size), or 8
// where that needs fewer waves of clusters (chosen at launch from the resident-cluster
// count); block r owns rows [r*R, r*R + R) of the map. Each block keeps the three conv
// weight sets (115 KB) in shared memory for the whole chain and works through its rows in
// tiles (at most 64 columns and 768 positions with the one-pixel halo), so any h x w
// runs. A step is three stages, each "stage a tile of the input into shared memory, then
// convolve it":
//   A. the tile (halo included) is warped straight from the carry, so no exchange is
//      needed before conv0; conv0 -> raw h (global scratch) and GroupNorm partial sums;
//   B. the tile is GN0 + LeakyReLU of raw h; resblock conv -> raw r and partial sums;
//   C. the tile is h + LeakyReLU(GNr(raw r)); conv_final -> out[n, d + 1] = warped + delta.
// Each stage ends in a cluster barrier (release/acquire at cluster scope): three a step.
// Before the barrier each block writes its GroupNorm partial sums (f64) into every
// block's shared memory (distributed shared memory stores); after it, each block sums
// them in rank order from its own shared memory, so the statistics are the same in every
// block and from run to run. Stage buffers and the carry live in global scratch that stays
// in L2 and is read with ld.global.cg (the warp reads the carry at arbitrary positions of
// the map); a thread issues its loads for several staging items before it uses any.
//
// The convolutions run on the tensor cores (mma.sync, TF32 in, f32 accumulate) in
// 3xTF32: each f32 operand is split into a TF32 high part and a low part and three
// products are summed, which keeps f32's accuracy (plain TF32 does not hold the chain's
// bar). 12 warps; a warp computes 16 pixels x 16 output channels (two GroupNorm groups)
// at a time. The tile holds 36 floats a position (conv0: warped 0..31, image 32..34, zero
// 35; conv0's weights are reordered to match), and the weights are XOR-swizzled by row,
// so the A and B fragment loads fall on distinct banks.
//
// The storage type T of feats0, the image guidance, the carry and the output is f32 or
// bf16 (scratch, sums and statistics stay f32). At bf16 the kernel follows the Pallas
// kernel's rounding points (incremental_chain.py:82-174): the warp blends the bf16 carry in
// f32 and rounds once; conv + bias, the GroupNorm statistics and LeakyReLU are f32 and the
// result is rounded (h, and the resblock's branch before the residual sum, itself rounded);
// the step's output is warped + delta in f32, rounded. The convs take bf16 operands (the
// weights rounded as they are loaded) on the tensor cores' native bf16 mma.sync
// (m16n8k16, f32 accumulate), one product where 3xTF32 takes three. The staged tile and
// the weights keep their f32 layout in shared memory, holding bf16 values.
//
// At f32 storage a second variant (TF32, the 1xTF32 entry) takes one product a k-step,
// a_hi b_hi: each conv operand rounded to TF32 as split rounds it, the products summed in
// f32. It is the forward's "tf32" precision (matmul_precision "high"), the cuDNN convs'
// TF32 counterpart; everything but the convs' operands stays f32.
//
// Under autograd the forward keeps each step's raw h and raw r in slots of their own and
// each GroupNorm's mean and rstd (keep_raw, keep_stats); the backward kernel
// (chain_bwd_kernel, below) reads them. It has no TPU kernel to replace: the JAX package
// takes the backward as the VJP of the XLA scan.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "clip_grad.cuh"  // clip_grad
#include "wgrad.cuh"      // the backward's weight-gradient pass

namespace cg = cooperative_groups;

namespace {

constexpr int C = 32;          // feature channels
constexpr int CIMG = 3;        // guidance image channels
constexpr int C0 = CIMG + C;   // conv0 input channels
constexpr int CS = 36;         // floats a tile position (and conv0's padded input rows)
constexpr int GROUPS = 4;
constexpr int GSIZE = C / GROUPS;
constexpr int THREADS = 384;
constexpr int NWARPS = THREADS / 32;
constexpr int TILE_POS = 768;  // tile positions, halo included
constexpr int MAX_TILE_W = 64;
constexpr int MAX_CLUSTER = 16;
constexpr int BATCH = 4;       // tile-staging items a thread loads before it uses any
constexpr float EPS = 1e-5f;
constexpr float SLOPE = 0.2f;
static_assert(NWARPS % 2 == 0, "each warp keeps one pair of output-channel groups");

// Shared memory, in this order: every block's partial sums (2 slots x MAX_CLUSTER ranks x
// GROUPS x {sum, sumsq}, f64), conv weights, bias and GroupNorm vectors, statistics,
// per-warp partials, tile.
constexpr int PART_DOUBLES = 2 * MAX_CLUSTER * GROUPS * 2;
constexpr int W0_FLOATS = 9 * CS * C;
constexpr int WR_FLOATS = 9 * C * C;
constexpr int VEC_FLOATS = 7 * C;
constexpr int STAT_FLOATS = 2 * 2 * GROUPS;
constexpr int RED_FLOATS = NWARPS * GROUPS * 2;
constexpr int TILE_OFFSET = 2 * PART_DOUBLES + W0_FLOATS + 2 * WR_FLOATS + VEC_FLOATS +
                            STAT_FLOATS + RED_FLOATS;  // floats
static_assert(TILE_OFFSET % 4 == 0, "the tile is read as float4");
constexpr size_t SMEM_BYTES = sizeof(float) * (TILE_OFFSET + TILE_POS * CS);
static_assert(SMEM_BYTES <= 232448, "more than a block's shared memory");

__device__ __forceinline__ float leaky(float v) { return v >= 0.0f ? v : SLOPE * v; }

__device__ __forceinline__ float4 ldcg4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

// Storage type T: f32 or bf16. rnd<T> rounds a value to what T holds; load4 / ldcg4 read
// four consecutive elements as floats.
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (sizeof(T) == sizeof(float)) return v;
  else return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ float4 rnd4(float4 v) {
  return make_float4(rnd<T>(v.x), rnd<T>(v.y), rnd<T>(v.z), rnd<T>(v.w));
}

__device__ __forceinline__ float4 bf16x4(uint2 u) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 ldcg4(const __nv_bfloat16* p) {
  return bf16x4(__ldcg(reinterpret_cast<const uint2*>(p)));
}

__device__ __forceinline__ float ldg1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg1(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Two bf16-valued floats as the bf16x2 register of an mma fragment, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a b, m16n8k16, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32: x = hi + lo, hi = x rounded to TF32 (10 mantissa bits, round half away from
// zero, done on the integer bits: the conversion instruction has a fraction of the ALU
// rate), lo = x - hi exactly; the tensor core reads lo to TF32 by dropping its low 13
// bits. A product is a_hi b_hi + a_hi b_lo + a_lo b_hi; what is dropped (a_lo b_lo, and lo
// past 11 bits) is ~2^-21 of it.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b, m16n8k8 and m16n8k4, TF32 in, f32 accumulate.
__device__ __forceinline__ void mma_k8(float (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_k4(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  asm(
      "mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// Weight (row, oc) of a tap's rows x 32 block: oc XOR-swizzled by the row so that a B
// fragment's 32 lanes (rows t, t+4 of a k-step, oc g) read 32 distinct banks.
__device__ __forceinline__ int wslot(int row, int oc) { return row * C + (oc ^ ((row & 3) << 3)); }

// 3x3 conv over a staged tile on the tensor cores: (th + 2) x (tw + 2) positions of CS
// floats, ROWS input channels used (32, or 36 for conv0: four k8 steps and one k4);
// weights [tap][ROWS][C], swizzled (wslot). As a GEMM: pixels x (tap, ci) times (tap, ci)
// x oc. A warp takes 16 pixels x 16 output channels (two GroupNorm groups, fixed for the
// warp) at a time, in 3xTF32, in 1xTF32 (TF32: the hi parts alone), or (BF16) in bf16 m16n8k16 steps: lane (gq, tq) of a step
// over channels k .. k + 15 holds channels k + 4 tq .. k + 4 tq + 3 of its two pixels
// and of its output channel's weights (the fragments' k order, the same for A and B).
// Calls epi(ty, tx, g, c, v0, v1) for output channels 8g + c, 8g + c + 1 of each of the
// tile's th x tw pixels.
template <int ROWS, bool BF16, bool TF32, typename Epi>
__device__ __forceinline__ void conv_tile(const float* tile, const float* wt, int th, int tw,
                                          Epi&& epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int npair = warp & 1;  // output-channel groups 2 npair, 2 npair + 1
  const int tp = th * tw, tpw = tw + 2;
  for (int mt = warp >> 1; mt * 16 < tp; mt += NWARPS / 2) {
    const int pa = mt * 16 + gq, pb = pa + 8;
    const int qa = pa < tp ? pa : 0, qb = pb < tp ? pb : 0;
    const float* ra = tile + ((qa / tw) * tpw + qa % tw) * CS + tq;
    const float* rb = tile + ((qb / tw) * tpw + qb % tw) * CS + tq;
    float acc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[j][k] = 0.0f;
#pragma unroll 1
    for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int toff = (kh * tpw + kw) * CS;
        const float* wk = wt + (kh * 3 + kw) * ROWS * C;
        if constexpr (BF16) {
          // ROWS is 32, or 36 for conv0, whose last step holds rows 32..35 in lane tq = 0.
#pragma unroll
          for (int k = 0; k < ROWS; k += 16) {
            const int c0 = k + 4 * tq;
            const bool on = c0 < ROWS;
            const float* xa = ra - tq + toff + c0;
            const float* xb = rb - tq + toff + c0;
            uint32_t a[4] = {0u, 0u, 0u, 0u};
            if (on) {
              a[0] = pack_bf16(xa[0], xa[1]);
              a[1] = pack_bf16(xb[0], xb[1]);
              a[2] = pack_bf16(xa[2], xa[3]);
              a[3] = pack_bf16(xb[2], xb[3]);
            }
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int n = 16 * npair + 8 * j + gq;
              uint32_t b[2] = {0u, 0u};
              if (on) {
                b[0] = pack_bf16(wk[wslot(c0, n)], wk[wslot(c0 + 1, n)]);
                b[1] = pack_bf16(wk[wslot(c0 + 2, n)], wk[wslot(c0 + 3, n)]);
              }
              mma_bf16(acc[j], a, b);
            }
          }
        } else {
#pragma unroll
          for (int s8 = 0; s8 < C / 8; ++s8) {
            uint32_t ah[4], al[4];
            split(ra[toff + 8 * s8], ah[0], al[0]);
            split(rb[toff + 8 * s8], ah[1], al[1]);
            split(ra[toff + 8 * s8 + 4], ah[2], al[2]);
            split(rb[toff + 8 * s8 + 4], ah[3], al[3]);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int n = 16 * npair + 8 * j + gq;
              uint32_t bh[2], bl[2];
              split(wk[wslot(8 * s8 + tq, n)], bh[0], bl[0]);
              split(wk[wslot(8 * s8 + tq + 4, n)], bh[1], bl[1]);
              if constexpr (!TF32) {
                mma_k8(acc[j], al, bh);
                mma_k8(acc[j], ah, bl);
              }
              mma_k8(acc[j], ah, bh);
            }
          }
          if constexpr (ROWS > C) {  // conv0's image rows 32..34 and the zero row 35
            uint32_t ah[2], al[2];
            split(ra[toff + C], ah[0], al[0]);
            split(rb[toff + C], ah[1], al[1]);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              uint32_t bh, bl;
              split(wk[wslot(C + tq, 16 * npair + 8 * j + gq)], bh, bl);
              if constexpr (!TF32) {
                mma_k4(acc[j], al, bh);
                mma_k4(acc[j], ah, bl);
              }
              mma_k4(acc[j], ah, bh);
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (pa < tp) epi(pa / tw, pa % tw, 2 * npair + j, 2 * tq, acc[j][0], acc[j][1]);
      if (pb < tp) epi(pb / tw, pb % tw, 2 * npair + j, 2 * tq, acc[j][2], acc[j][3]);
    }
  }
}

// The block's tiles: rows [r0, r1) of a map w wide, in tiles of at most tr x tc pixels.
template <typename F>
__device__ __forceinline__ void for_each_tile(int r0, int r1, int w, int tr, int tc, F&& f) {
  for (int y0 = r0; y0 < r1; y0 += tr)
    for (int x0 = 0; x0 < w; x0 += tc) f(y0, x0, min(tr, r1 - y0), min(tc, w - x0));
}

// Where map pixel (x, y) samples the carry under H: the four taps' pixel offsets and the
// bilinear weights; ok is false where the sample is invalid (it is then zero).
struct Tap {
  int p00, p01, p10, p11;
  float wx, wy;
  bool ok;
};

__device__ __forceinline__ Tap warp_tap(const float (&Hr)[9], int x, int y, int h, int wd) {
  Tap t;
  const float px = (float)x, py = (float)y;
  const float X = Hr[0] * px + Hr[1] * py + Hr[2];
  const float Y = Hr[3] * px + Hr[4] * py + Hr[5];
  const float Z = Hr[6] * px + Hr[7] * py + Hr[8];
  const float gx = 2.0f * (X / Z + 0.5f) / (float)wd - 1.0f;
  const float gy = 2.0f * (Y / Z + 0.5f) / (float)h - 1.0f;
  t.ok = !(fabsf(gx) > 1.0f || fabsf(gy) > 1.0f);
  const float ix = fminf(fmaxf(((gx + 1.0f) * wd - 1.0f) * 0.5f, 0.0f), (float)(wd - 1));
  const float iy = fminf(fmaxf(((gy + 1.0f) * h - 1.0f) * 0.5f, 0.0f), (float)(h - 1));
  const float x0f = floorf(ix);
  const float y0f = floorf(iy);
  t.wx = ix - x0f;
  t.wy = iy - y0f;
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  const int x1 = min(x0 + 1, wd - 1);
  const int y1 = min(y0 + 1, h - 1);
  t.p00 = y0 * wd + x0;
  t.p01 = y0 * wd + x1;
  t.p10 = y1 * wd + x0;
  t.p11 = y1 * wd + x1;
  return t;
}

__device__ __forceinline__ float4 blend(float4 a, float4 b, float4 c, float4 e, float wx,
                                        float wy) {
  float4 r;
  r.x = (a.x * (1.0f - wx) + b.x * wx) * (1.0f - wy) + (c.x * (1.0f - wx) + e.x * wx) * wy;
  r.y = (a.y * (1.0f - wx) + b.y * wx) * (1.0f - wy) + (c.y * (1.0f - wx) + e.y * wx) * wy;
  r.z = (a.z * (1.0f - wx) + b.z * wx) * (1.0f - wy) + (c.z * (1.0f - wx) + e.z * wx) * wy;
  r.w = (a.w * (1.0f - wx) + b.w * wx) * (1.0f - wy) + (c.w * (1.0f - wx) + e.w * wx) * wy;
  return r;
}

// leaky((v - mean) * rstd * gamma + beta) on channels 4j .. 4j+3 (group j / 2).
__device__ __forceinline__ float4 gn_leaky4(float4 v, const float* stat, const float* gamma,
                                            const float* beta, int j) {
  const float mu = stat[j / 2], rs = stat[GROUPS + j / 2];
  const float* ga = gamma + 4 * j;
  const float* be = beta + 4 * j;
  return make_float4(leaky((v.x - mu) * rs * ga[0] + be[0]),
                     leaky((v.y - mu) * rs * ga[1] + be[1]),
                     leaky((v.z - mu) * rs * ga[2] + be[2]),
                     leaky((v.w - mu) * rs * ga[3] + be[3]));
}

// A tile of (th + 2) x (tw + 2) positions (one-pixel halo; zero outside the map) from
// NL global scratch maps: tile[pos][4j..4j+3] = make(the maps' channels 4j..4j+3, j);
// the tile's own pixels (the halo left out) also go to the map keep where it is given.
// A thread loads BATCH items (position, quad) before it uses any.
template <int NL, typename Make>
__device__ __forceinline__ void stage_tile(const float* const (&src)[NL], float* tile, int y0,
                                           int x0, int th, int tw, int h, int wd,
                                           Make&& make, float* keep = nullptr) {
  const int tpw = tw + 2, items = (th + 2) * tpw * 8;
  for (int base = threadIdx.x; base < items; base += BATCH * THREADS) {
    float4 v[BATCH][NL];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = base + u * THREADS;
      const int pos = i / 8, j = i % 8;
      const int y = y0 - 1 + pos / tpw, x = x0 - 1 + pos % tpw;
      const bool inside = i < items && y >= 0 && y < h && x >= 0 && x < wd;
#pragma unroll
      for (int k = 0; k < NL; ++k)
        v[u][k] = inside ? ldcg4(src[k] + (y * wd + x) * C + 4 * j)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = base + u * THREADS;
      if (i >= items) break;
      const int pos = i / 8, j = i % 8;
      const int ty = pos / tpw, tx = pos % tpw;
      const int y = y0 - 1 + ty, x = x0 - 1 + tx;
      const bool inside = y >= 0 && y < h && x >= 0 && x < wd;
      const float4 made = inside ? make(v[u], j) : make_float4(0.f, 0.f, 0.f, 0.f);
      reinterpret_cast<float4*>(tile + pos * CS)[j] = made;
      if (keep != nullptr && ty >= 1 && ty <= th && tx >= 1 && tx <= tw)
        reinterpret_cast<float4*>(keep + (y * wd + x) * C)[j] = made;
    }
  }
}

// The block's partial sums (a warp holds two groups, 2 (warp & 1) + j), written into slot
// [rank][g] of every block's shared memory (distributed shared memory stores, made
// visible by the cluster barrier that follows). Every thread calls it.
__device__ __forceinline__ void push_partials(cg::cluster_group& cluster, float (&s)[2],
                                              float (&ss)[2], float* red, double* slot) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
      ss[j] += __shfl_xor_sync(0xffffffffu, ss[j], off);
    }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      red[(warp * GROUPS + 2 * (warp & 1) + j) * 2] = s[j];
      red[(warp * GROUPS + 2 * (warp & 1) + j) * 2 + 1] = ss[j];
    }
  }
  __syncthreads();
  const int cs = cluster.num_blocks();  // <= MAX_CLUSTER: the card runs no larger
  if ((int)threadIdx.x < cs * GROUPS) {
    const int dest = threadIdx.x / GROUPS, g = threadIdx.x % GROUPS;
    double a = 0.0, b = 0.0;
    for (int k = g / 2; k < NWARPS; k += 2) {
      a += red[(k * GROUPS + g) * 2];
      b += red[(k * GROUPS + g) * 2 + 1];
    }
    double* remote = cluster.map_shared_rank(slot, dest) +
                     (cluster.block_rank() * GROUPS + g) * 2;
    remote[0] = a;
    remote[1] = b;
  }
}

// After the cluster barrier: the ranks' partial sums, in rank order -> mean, rstd.
__device__ __forceinline__ void cluster_stats(int cs, const double* slot, float* stat,
                                              int npix) {
  if (threadIdx.x < GROUPS) {
    const int g = threadIdx.x;
    double a = 0.0, b = 0.0;
    for (int r = 0; r < cs; ++r) {
      a += slot[(r * GROUPS + g) * 2];
      b += slot[(r * GROUPS + g) * 2 + 1];
    }
    const double n = (double)npix * GSIZE;
    const double mu = a / n;
    const double var = fmax(b / n - mu * mu, 0.0);
    stat[g] = (float)mu;
    stat[GROUPS + g] = (float)(1.0 / sqrt(var + (double)EPS));
  }
  __syncthreads();
}

// Stage A's tile: (th + 2) x (tw + 2) positions of conv0's input, the carry warped by H
// (channels 0..31, zero where invalid or outside the map) and the image (32..34), rounded
// to the storage type as the forward rounds them. Own pixels' warped values also go to
// ``warped`` where it is not null. Items (position, quad j): j < 8 warp channels
// 4j..4j+3, j = 8 the image; a thread computes BATCH items' taps and issues all their
// loads before blending.
template <typename T>
__device__ __forceinline__ void stage_warp_tile(float* tile, const T* carry, const T* img,
                                                const float (&Hr)[9], int y0, int x0, int th,
                                                int tw, int h, int wd, float* warped) {
  const int tid = threadIdx.x;
  const int tpw = tw + 2;
  const int items = (th + 2) * tpw * 9;
  for (int base = tid; base < items; base += BATCH * THREADS) {
    float4 a[BATCH], b[BATCH], c[BATCH], e[BATCH];
    float wx[BATCH], wy[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = base + u * THREADS;
      const int pos = i / 9, j = i % 9;
      const int y = y0 - 1 + pos / tpw, x = x0 - 1 + pos % tpw;
      a[u] = b[u] = c[u] = e[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      wx[u] = wy[u] = 0.0f;
      if (i < items && y >= 0 && y < h && x >= 0 && x < wd) {
        if (j == 8) {
          const T* im = img + (y * wd + x) * CIMG;
          a[u] = make_float4(ldg1(im), ldg1(im + 1), ldg1(im + 2), 0.0f);
        } else {
          const Tap t = warp_tap(Hr, x, y, h, wd);
          if (t.ok) {
            a[u] = ldcg4(carry + t.p00 * C + 4 * j);
            b[u] = ldcg4(carry + t.p01 * C + 4 * j);
            c[u] = ldcg4(carry + t.p10 * C + 4 * j);
            e[u] = ldcg4(carry + t.p11 * C + 4 * j);
            wx[u] = t.wx;
            wy[u] = t.wy;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = base + u * THREADS;
      if (i >= items) break;
      const int pos = i / 9, j = i % 9;
      const int ty = pos / tpw, tx = pos % tpw;
      const int y = y0 - 1 + ty, x = x0 - 1 + tx;
      // The image item passes a[u] through; invalid or outside samples blend to 0. The
      // blend is rounded once to the storage type.
      const float4 v = j == 8 ? a[u] : rnd4<T>(blend(a[u], b[u], c[u], e[u], wx[u], wy[u]));
      reinterpret_cast<float4*>(tile + pos * CS)[j] = v;
      if (warped != nullptr && j < 8 && ty >= 1 && ty <= th && tx >= 1 && tx <= tw)
        reinterpret_cast<float4*>(warped + (y * wd + x) * C)[j] = v;
    }
  }
}

template <typename T, bool TF32>
__global__ void __launch_bounds__(THREADS, 1)
chain_kernel(const T* __restrict__ feats0, const T* __restrict__ image,
             const float* __restrict__ H_inc, const float* __restrict__ w0_g,
             const float* __restrict__ wr_g, const float* __restrict__ wf_g,
             const float* __restrict__ vec_g, T* out, float* scratch, float* keep_raw,
             float* keep_stats, int Dm1, int h, int wd, int rows_per_block, int tile_rows,
             int tile_cols) {
  constexpr bool BF16 = sizeof(T) == 2;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  double* part = reinterpret_cast<double*>(smem4);  // [2][MAX_CLUSTER][GROUPS][2]
  float* w0 = reinterpret_cast<float*>(part + PART_DOUBLES);
  float* wr = w0 + W0_FLOATS;
  float* wf = wr + WR_FLOATS;
  float* vec = wf + WR_FLOATS;
  float* stat0 = vec + VEC_FLOATS;  // mean[4], rstd[4] of conv0's GroupNorm
  float* statr = stat0 + 2 * GROUPS;  // the resblock's
  float* red = statr + 2 * GROUPS;
  float* tile = reinterpret_cast<float*>(smem4) + TILE_OFFSET;
  const float* b0 = vec;
  const float* g0 = vec + C;
  const float* be0 = vec + 2 * C;
  const float* br = vec + 3 * C;
  const float* gr = vec + 4 * C;
  const float* ber = vec + 5 * C;
  const float* bf = vec + 6 * C;

  const int cs = cluster.num_blocks();
  const int n = blockIdx.x / cs;
  const int tid = threadIdx.x;
  const int P = h * wd;
  const int D = Dm1 + 1;
  const int r0 = min(h, (int)cluster.block_rank() * rows_per_block);
  const int r1 = min(h, r0 + rows_per_block);

  // conv0's rows reordered to the tile's channels: warped 0..31, image 32..34, zero 35.
  // Four consecutive output channels stay together under the swizzle (wslot).
#pragma unroll 4
  for (int i = tid; i < W0_FLOATS / 4; i += THREADS) {
    const int oc = 4 * (i % (C / 4)), row = (i / (C / 4)) % CS, tap = i / (C / 4 * CS);
    const int ci = row < C ? row + CIMG : (row < C0 ? row - C : -1);
    *reinterpret_cast<float4*>(w0 + tap * CS * C + wslot(row, oc)) =
        ci < 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
               : rnd4<T>(__ldg(reinterpret_cast<const float4*>(w0_g + (tap * C0 + ci) * C +
                                                               oc)));
  }
#pragma unroll 4
  for (int i = tid; i < WR_FLOATS / 4; i += THREADS) {
    const int oc = 4 * (i % (C / 4)), row = i / (C / 4);  // row = tap * C + ci
    const int at = (row / C) * C * C + wslot(row % C, oc);
    *reinterpret_cast<float4*>(wr + at) =
        rnd4<T>(__ldg(reinterpret_cast<const float4*>(wr_g) + i));
    *reinterpret_cast<float4*>(wf + at) =
        rnd4<T>(__ldg(reinterpret_cast<const float4*>(wf_g) + i));
  }
  for (int i = tid; i < VEC_FLOATS; i += THREADS) vec[i] = vec_g[i];

  T* out_n = out + (int64_t)n * D * P * C;
  const T* f0 = feats0 + (int64_t)n * P * C;
  constexpr int PX16 = C * (int)sizeof(T) / 16;  // 16-byte units a pixel
  for (int i = r0 * wd * PX16 + tid; i < r1 * wd * PX16; i += THREADS)
    reinterpret_cast<uint4*>(out_n)[i] = reinterpret_cast<const uint4*>(f0)[i];
  float* warped = scratch + (int64_t)n * 3 * P * C;

  for (int d = 0; d < Dm1; ++d) {
    // Under autograd (keep_raw) every step's raw h and raw r stay for the backward.
    float* raw_h = keep_raw != nullptr ? keep_raw + ((int64_t)n * Dm1 + d) * 2 * P * C
                                       : warped + P * C;
    float* raw_r = raw_h + P * C;
    float* kept = keep_stats != nullptr && cluster.block_rank() == 0
                      ? keep_stats + ((int64_t)n * Dm1 + d) * 2 * 2 * GROUPS
                      : nullptr;
    const T* carry = d == 0 ? f0 : out_n + (int64_t)d * P * C;
    T* next = out_n + (int64_t)(d + 1) * P * C;
    const T* img = image + ((int64_t)n * Dm1 + d) * P * CIMG;
    const float* Hm = H_inc + ((int64_t)n * Dm1 + d) * 9;
    float Hr[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) Hr[k] = Hm[k];

    // A. warp + image -> tile; conv0 + b0 -> raw h; partial sums.
    float s[2] = {0.0f, 0.0f}, ss[2] = {0.0f, 0.0f};
    for_each_tile(r0, r1, wd, tile_rows, tile_cols, [&](int y0, int x0, int th, int tw) {
      __syncthreads();
      stage_warp_tile(tile, carry, img, Hr, y0, x0, th, tw, h, wd, warped);
      __syncthreads();
      conv_tile<CS, BF16, TF32>(tile, w0, th, tw, [&](int ty, int tx, int g, int c, float v0, float v1) {
        const int oc = GSIZE * g + c;
        const float o0 = v0 + b0[oc], o1 = v1 + b0[oc + 1];
        s[g & 1] += o0 + o1;
        ss[g & 1] += o0 * o0 + o1 * o1;
        *reinterpret_cast<float2*>(raw_h + ((y0 + ty) * wd + x0 + tx) * C + oc) =
            make_float2(o0, o1);
      });
    });
    push_partials(cluster, s, ss, red, part);
    cluster.sync();
    cluster_stats(cs, part, stat0, P);
    if (kept != nullptr && tid < 2 * GROUPS) kept[tid] = stat0[tid];

    // B. h = LeakyReLU(GN0(raw h)) -> tile; resblock conv + br -> raw r; partial sums.
    s[0] = s[1] = ss[0] = ss[1] = 0.0f;
    for_each_tile(r0, r1, wd, tile_rows, tile_cols, [&](int y0, int x0, int th, int tw) {
      const float* src[1] = {raw_h};
      __syncthreads();
      stage_tile(src, tile, y0, x0, th, tw, h, wd, [&](const float4 (&v)[1], int j) {
        return rnd4<T>(gn_leaky4(v[0], stat0, g0, be0, j));
      });
      __syncthreads();
      conv_tile<C, BF16, TF32>(tile, wr, th, tw, [&](int ty, int tx, int g, int c, float v0, float v1) {
        const int oc = GSIZE * g + c;
        const float o0 = v0 + br[oc], o1 = v1 + br[oc + 1];
        s[g & 1] += o0 + o1;
        ss[g & 1] += o0 * o0 + o1 * o1;
        *reinterpret_cast<float2*>(raw_r + ((y0 + ty) * wd + x0 + tx) * C + oc) =
            make_float2(o0, o1);
      });
    });
    push_partials(cluster, s, ss, red, part + MAX_CLUSTER * GROUPS * 2);
    cluster.sync();
    cluster_stats(cs, part + MAX_CLUSTER * GROUPS * 2, statr, P);
    if (kept != nullptr && tid < 2 * GROUPS) kept[2 * GROUPS + tid] = statr[tid];

    // C. h + LeakyReLU(GNr(raw r)) -> tile; conv_final + bf -> next = warped + delta.
    for_each_tile(r0, r1, wd, tile_rows, tile_cols, [&](int y0, int x0, int th, int tw) {
      const float* src[2] = {raw_h, raw_r};
      __syncthreads();
      stage_tile(src, tile, y0, x0, th, tw, h, wd, [&](const float4 (&v)[2], int j) {
        const float4 hv = rnd4<T>(gn_leaky4(v[0], stat0, g0, be0, j));
        const float4 rv = rnd4<T>(gn_leaky4(v[1], statr, gr, ber, j));
        return rnd4<T>(make_float4(hv.x + rv.x, hv.y + rv.y, hv.z + rv.z, hv.w + rv.w));
      });
      __syncthreads();
      conv_tile<C, BF16, TF32>(tile, wf, th, tw, [&](int ty, int tx, int g, int c, float v0, float v1) {
        const int oc = GSIZE * g + c;
        const int off = ((y0 + ty) * wd + x0 + tx) * C + oc;
        const float2 a = __ldcg(reinterpret_cast<const float2*>(warped + off));
        store2(next + off, a.x + (v0 + bf[oc]), a.y + (v1 + bf[oc + 1]));
      });
    });
    // next is complete over the map for the next step's warp; no block leaves while
    // another may still read its partial sums.
    cluster.sync();
  }
}

// ---------------------------------------------------------------------------------------
// The backward: the VJP of _incremental_scan (multi_view_stereonet_tpu/models/
// mvsnet.py:218-234) that the JAX _chain_bwd (ops/pallas/incremental_chain.py:357-368)
// takes, in place of its recompute. It reads what the forward kept under autograd: the
// chain out (every step's carry), each step's raw h and raw r and its GroupNorms' mean and
// rstd. Two launches. Only the input gradients and the GroupNorm backward's sums are
// sequential; the weight and bias gradients, half the multiply-adds, depend on nothing
// after them and go to one pass over the whole card (wgrad.cuh).
//
// 1. chain_bwd_kernel, the sequential part: one thread-block cluster per sample, as the
// forward; steps d = D-2 .. 0, the gradient of each step's carry (out[n, d + 1]) kept in a
// map of its own (gcarry), the only thing carried between steps. A step is three stages
// that mirror the forward's C, B, A, each staging a tile of a gradient and running the
// conv's dgrad (conv_tile over the gradient tile with the weights flipped and transposed):
//   C'. conv_final: gres = dgrad of the carry's gradient g;
//   B'. the resblock: gr = GNr + LeakyReLU's backward of gres, kept; ghn = gres + dgrad(gr);
//   A'. conv0: ga = GN0 + LeakyReLU's backward of ghn, kept; the warped channels' gradient
//       g + dgrad(ga), zero where the sample is invalid, goes through the warp's transpose
//       into the gradient of the step's carry (f32 atomics, in an order that changes from
//       run to run), which starts as the output's gradient at that hypothesis; and where
//       asked, the image channels' gradient and H's (the carry read at the four taps).
// Each GroupNorm backward needs two sums a channel over the map, of gz = g leaky'(z) and of
// gz x_hat: each block pushes its partial sums into every block's shared memory, and after
// the cluster barrier each sums them in rank order, so they are the same in every block
// and from run to run; the GroupNorms' (d gamma, d beta) accumulate in shared memory and
// each block writes them to a slot of its own at the end.
// 2. chain_wgrad_kernel, the weight-gradient pass (wgrad.cuh): the three convs' weight and
// bias gradients over every (sample, step) plane, G the kept maps (ga, gr, the carry's
// gradient), X made on load as the forward made it: conv0's [the carry warped by H_inc
// from out, the image], the resblock's h = LeakyReLU(GN0(raw h)), conv_final's h +
// LeakyReLU(GNr(raw r)), from the kept raw maps and statistics; then every element summed
// over its blocks' slots, and (d gamma, d beta) over the sequential part's, in block order.
// The convs round their operands as the forward's do: 3xTF32, 1xTF32 (TF32), or bf16 at
// bf16 storage (the dgrads on bf16 mma.sync, the weight gradients' bf16-rounded operands
// on TF32 mma.sync, where a bf16 value is exact). Everything else is f32; the map sums of
// the GroupNorm backward f64 across ranks, the bias sums f64.
//
// What bounds the sequential part: ~34 M MACs of dgrad a step at 30 x 40 x 32, in sequence,
// in the forward's latency-bound shape.

constexpr int TILE_POS_B = 720;  // the backward tile's positions, halo included
constexpr int KW0 = 9 * C0 * C;  // the parameter gradients: conv0's taps [tap][ci][co],
constexpr int KWR = 9 * C * C;   // the resblock's and conv_final's, then the seven vectors
constexpr int KP = KW0 + 2 * KWR + 7 * C;
constexpr int GN_GRADS = 4 * C;  // a block's (d gamma, d beta) of GN0, then of GNr
// Shared memory of the backward, in this order: every block's per-channel partial sums (2
// slots x MAX_CLUSTER ranks x C x {sum gz, sum gz x_hat}, f32), the three dgrad weight sets
// (flipped, transposed, swizzled), conv0's image rows, the vectors, the step's statistics
// and GroupNorm sums, per-warp partials, the vector gradients, the tile.
constexpr int BPART_FLOATS = 2 * MAX_CLUSTER * C * 2;
constexpr int WT_FLOATS = 9 * C * C;
constexpr int WIMG_FLOATS = 9 * CIMG * C;
constexpr int BRED_FLOATS = NWARPS * C * 2;
constexpr int BTILE_OFFSET = BPART_FLOATS + 3 * WT_FLOATS + WIMG_FLOATS + VEC_FLOATS +
                             4 * 2 * GROUPS + BRED_FLOATS + VEC_FLOATS;  // floats
static_assert(BTILE_OFFSET % 4 == 0, "the tile is read as float4");
constexpr size_t BWD_SMEM_BYTES = sizeof(float) * (BTILE_OFFSET + TILE_POS_B * CS);
static_assert(BWD_SMEM_BYTES <= 232448, "more than a block's shared memory");

// An f32 operand rounded as the variant's convs round it (for the f32 multiply-adds).
template <bool BF16, bool TF32>
__device__ __forceinline__ float op_round(float x) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(x));
  else if constexpr (TF32) return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
  else return x;
}

// LeakyReLU's derivative at the f32 GroupNorm value z, as the plain version's autograd
// takes it: F.leaky_relu's at f32 (0.2 at 0), the JAX-style where on z rounded at bf16.
template <typename T>
__device__ __forceinline__ float leaky_slope(float z) {
  if constexpr (sizeof(T) == sizeof(float)) return z > 0.0f ? 1.0f : SLOPE;
  else return rnd<T>(z) >= 0.0f ? 1.0f : SLOPE;
}

// GroupNorm + LeakyReLU's backward on channels 4j..4j+3 (group j / 2): the raw value's
// gradient rstd (gz gamma - a - x_hat b), gz = g leaky'(z), from the output's gradient g
// and the raw value x; a, b the group's sums over the map (gsum: a[4], b[4], over n).
template <typename T>
__device__ __forceinline__ float4 gn_bwd4(float4 g, float4 x, const float* stat,
                                          const float* gamma, const float* beta,
                                          const float* gsum, int j) {
  const int q = j / 2;
  const float mu = stat[q], rs = stat[GROUPS + q], a = gsum[q], b = gsum[GROUPS + q];
  const float* ga = gamma + 4 * j;
  const float* be = beta + 4 * j;
  auto one = [&](float gv, float xv, int k) {
    const float xh = (xv - mu) * rs;
    const float gz = gv * leaky_slope<T>(xh * ga[k] + be[k]);
    return rs * (gz * ga[k] - a - xh * b);
  };
  return make_float4(one(g.x, x.x, 0), one(g.y, x.y, 1), one(g.z, x.z, 2), one(g.w, x.w, 3));
}

// One element's terms of the GroupNorm backward's sums: gz and gz x_hat, channel oc of
// group g, g_out the output's gradient, x the raw value.
template <typename T>
__device__ __forceinline__ void channel_terms(float g_out, float x, const float* stat,
                                              const float* gamma, const float* beta, int g,
                                              int oc, float& s1, float& s2) {
  const float xh = (x - stat[g]) * stat[GROUPS + g];
  const float gz = g_out * leaky_slope<T>(xh * gamma[oc] + beta[oc]);
  s1 += gz;
  s2 += gz * xh;
}

// The block's per-channel sums (a thread holds channels 8 (2 (warp & 1) + j) + 2 tq + k of
// the conv epilogue), written into slot [rank][ch] of every block's shared memory
// (distributed shared memory stores, made visible by the cluster barrier that follows), and
// added to the block's own GroupNorm parameter gradients (dgamma += sum gz x_hat, dbeta +=
// sum gz). Every thread calls it.
__device__ __forceinline__ void push_channel_partials(cg::cluster_group& cluster,
                                                      float (&s1)[2][2], float (&s2)[2][2],
                                                      float* red, float* slot, float* dgamma,
                                                      float* dbeta) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {  // over the lanes' pixel rows gq
        s1[j][k] += __shfl_xor_sync(0xffffffffu, s1[j][k], off);
        s2[j][k] += __shfl_xor_sync(0xffffffffu, s2[j][k], off);
      }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int ch = 8 * (2 * (warp & 1) + j) + 2 * lane + k;
        red[(warp * C + ch) * 2] = s1[j][k];
        red[(warp * C + ch) * 2 + 1] = s2[j][k];
      }
  }
  __syncthreads();
  const int cs = cluster.num_blocks(), rank = cluster.block_rank();
  for (int i = threadIdx.x; i < cs * C; i += THREADS) {
    const int dest = i / C, ch = i % C;
    float a = 0.0f, b = 0.0f;
    for (int k = ch / 16; k < NWARPS; k += 2) {  // the warps that hold channel ch, in order
      a += red[(k * C + ch) * 2];
      b += red[(k * C + ch) * 2 + 1];
    }
    float* remote = cluster.map_shared_rank(slot, dest) + (rank * C + ch) * 2;
    remote[0] = a;
    remote[1] = b;
    if (dest == 0) {
      dgamma[ch] += b;
      dbeta[ch] += a;
    }
  }
}

// After the cluster barrier: each group's a = sum_c gamma_c sum(gz) and b = sum_c gamma_c
// sum(gz x_hat) over the map, the ranks' partials in rank order, in f64; over n.
__device__ __forceinline__ void cluster_group_sums(int cs, const float* slot,
                                                   const float* gamma, float* gsum, int npix) {
  if (threadIdx.x < GROUPS) {
    const int g = threadIdx.x;
    double a = 0.0, b = 0.0;
    for (int c = g * GSIZE; c < (g + 1) * GSIZE; ++c) {
      double s1 = 0.0, s2 = 0.0;
      for (int r = 0; r < cs; ++r) {
        s1 += slot[(r * C + c) * 2];
        s2 += slot[(r * C + c) * 2 + 1];
      }
      a += (double)gamma[c] * s1;
      b += (double)gamma[c] * s2;
    }
    const double n = (double)npix * GSIZE;
    gsum[g] = (float)(a / n);
    gsum[GROUPS + g] = (float)(b / n);
  }
  __syncthreads();
}

// conv0's gradient in the image channels at the tile's own pixels, into dimg (P, 3): the
// sum over taps and output channels of the gradient tile (the tap flipped) times conv0's
// image rows wimg [tap][k][co], the operands rounded as the variant's convs round them.
template <bool BF16, bool TF32>
__device__ __forceinline__ void image_dgrad(const float* G, const float* wimg, int y0, int x0,
                                            int th, int tw, int wd, float* dimg) {
  const int tpw = tw + 2, items = th * tw * CIMG;
  for (int i = threadIdx.x; i < items; i += THREADS) {
    const int p = i / CIMG, k = i % CIMG, py = p / tw, px = p % tw;
    float s = 0.0f;
    for (int kh = 0; kh < 3; ++kh)
      for (int kw = 0; kw < 3; ++kw) {
        const float* gp = G + ((py + 2 - kh) * tpw + px + 2 - kw) * CS;
        const float* wp = wimg + ((kh * 3 + kw) * CIMG + k) * C;
#pragma unroll 8
        for (int co = 0; co < C; ++co)
          s = fmaf(op_round<BF16, TF32>(gp[co]), op_round<BF16, TF32>(wp[co]), s);
      }
    dimg[((y0 + py) * wd + x0 + px) * CIMG + k] = s;
  }
}

// H's gradient from one output pixel (x, y): gwx, gwy the gradient of its blend weights
// (over the channels this call holds), through the border clip, the unnormalization and
// the division by Z into hacc [row][x, y, 1], as homography_grid's plain backward.
__device__ __forceinline__ void h_grad(const float (&Hr)[9], int x, int y, int h, int wd,
                                       float gwx, float gwy, float (&hacc)[9]) {
  const float px = (float)x, py = (float)y;
  const float X = Hr[0] * px + Hr[1] * py + Hr[2];
  const float Y = Hr[3] * px + Hr[4] * py + Hr[5];
  const float Z = Hr[6] * px + Hr[7] * py + Hr[8];
  const float gx = 2.0f * (X / Z + 0.5f) / (float)wd - 1.0f;
  const float gy = 2.0f * (Y / Z + 0.5f) / (float)h - 1.0f;
  const float dgx = clip_grad(gwx, ((gx + 1.0f) * wd - 1.0f) * 0.5f, (float)(wd - 1)) * 0.5f * wd;
  const float dgy = clip_grad(gwy, ((gy + 1.0f) * h - 1.0f) * 0.5f, (float)(h - 1)) * 0.5f * h;
  const float du = dgx * (2.0f / wd), dv = dgy * (2.0f / h);
  const float dX = du / Z, dY = dv / Z, dZ = -(du * X + dv * Y) / (Z * Z);
  hacc[0] += dX * px;
  hacc[1] += dX * py;
  hacc[2] += dX;
  hacc[3] += dY * px;
  hacc[4] += dY * py;
  hacc[5] += dY;
  hacc[6] += dZ * px;
  hacc[7] += dZ * py;
  hacc[8] += dZ;
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return __ldcg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T, bool TF32>
__global__ void __launch_bounds__(THREADS, 1)
chain_bwd_kernel(const T* __restrict__ image, const float* __restrict__ H_inc,
                 const float* __restrict__ w0_g, const float* __restrict__ wr_g,
                 const float* __restrict__ wf_g, const float* __restrict__ vec_g,
                 const T* __restrict__ out, const float* __restrict__ raw,
                 const float* __restrict__ stats, const T* __restrict__ grad, float* dfeats0,
                 float* dimage, float* dH, float* gmaps, float* gcarry, float* gnpart,
                 float* scratch, int Dm1, int h, int wd, int rows_per_block, int tile_rows,
                 int tile_cols) {
  constexpr bool BF16 = sizeof(T) == 2;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* part = reinterpret_cast<float*>(smem4);  // [2][MAX_CLUSTER][C][2]
  float* wfT = part + BPART_FLOATS;  // [tap][co][ci], swizzled: the dgrads' weights
  float* wrT = wfT + WT_FLOATS;
  float* w0T = wrT + WT_FLOATS;  // conv0's warped channels
  float* wimg = w0T + WT_FLOATS;  // conv0's image rows [tap][k][co]
  float* vec = wimg + WIMG_FLOATS;
  float* stat0 = vec + VEC_FLOATS;  // mean[4], rstd[4] of the step's GN0, then GNr's
  float* statr = stat0 + 2 * GROUPS;
  float* gsum0 = statr + 2 * GROUPS;  // a[4], b[4] of GN0's backward, then GNr's
  float* gsumr = gsum0 + 2 * GROUPS;
  float* red = gsumr + 2 * GROUPS;
  float* vacc = red + BRED_FLOATS;  // [7][C]: the GroupNorms' (d gamma, d beta), vec's order
  float* gt = reinterpret_cast<float*>(smem4) + BTILE_OFFSET;  // the gradient tile
  const float* g0 = vec + C;
  const float* be0 = vec + 2 * C;
  const float* gr = vec + 4 * C;
  const float* ber = vec + 5 * C;

  const int cs = cluster.num_blocks();
  const int rank = cluster.block_rank();
  const int n = blockIdx.x / cs;
  const int tid = threadIdx.x;
  const int P = h * wd;
  const int D = Dm1 + 1;
  const int r0 = min(h, rank * rows_per_block);
  const int r1 = min(h, r0 + rows_per_block);

  // The dgrads' weights: wT[t][co][ci] = W[8 - t][ci][co] (the transpose, taps flipped).
  for (int i = tid; i < WT_FLOATS; i += THREADS) {
    const int t = i / (C * C), co = (i / C) % C, ci = i % C;
    const int at = t * C * C + wslot(co, ci);
    wfT[at] = rnd<T>(__ldg(wf_g + ((8 - t) * C + ci) * C + co));
    wrT[at] = rnd<T>(__ldg(wr_g + ((8 - t) * C + ci) * C + co));
    w0T[at] = rnd<T>(__ldg(w0_g + ((8 - t) * C0 + CIMG + ci) * C + co));
  }
  for (int i = tid; i < WIMG_FLOATS; i += THREADS) {
    const int t = i / (CIMG * C), k = (i / C) % CIMG, co = i % C;
    wimg[i] = __ldg(w0_g + (t * C0 + k) * C + co);
  }
  for (int i = tid; i < VEC_FLOATS; i += THREADS) {
    vec[i] = vec_g[i];
    vacc[i] = 0.0f;
  }

  float* gres = scratch + (int64_t)n * 2 * P * C;
  float* ghn = gres + P * C;
  float* gc_n = gcarry + (int64_t)n * D * P * C;  // the gradient of out[n, k] at slot k
  const T* out_n = out + (int64_t)n * D * P * C;
  const T* grad_n = grad + (int64_t)n * D * P * C;
  for (int i = r0 * wd * C + tid; i < r1 * wd * C; i += THREADS)
    gc_n[(int64_t)Dm1 * P * C + i] = ldg1(grad_n + (int64_t)Dm1 * P * C + i);
  cluster.sync();

  for (int d = Dm1 - 1; d >= 0; --d) {
    const float* cur = gc_n + (int64_t)(d + 1) * P * C;  // the gradient of out[n, d + 1]
    float* nxt = gc_n + (int64_t)d * P * C;  // of out[n, d]: its own gradient, then the warp's
    const T* carry = out_n + (int64_t)d * P * C;
    const float* Hm = H_inc + ((int64_t)n * Dm1 + d) * 9;
    float Hr[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) Hr[k] = Hm[k];
    const float* raw_h = raw + ((int64_t)n * Dm1 + d) * 2 * P * C;
    const float* raw_r = raw_h + P * C;
    float* ga_keep = gmaps + ((int64_t)n * Dm1 + d) * 2 * P * C;
    float* gr_keep = ga_keep + P * C;
    if (tid < 4 * GROUPS) stat0[tid] = stats[((int64_t)n * Dm1 + d) * 4 * GROUPS + tid];
    for (int i = r0 * wd * C + tid; i < r1 * wd * C; i += THREADS)
      nxt[i] = ldg1(grad_n + (int64_t)d * P * C + i);

    // C'. conv_final: gres = dgrad(g); GNr's channel sums.
    float s1[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}}, s2[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
    for_each_tile(r0, r1, wd, tile_rows, tile_cols, [&](int y0, int x0, int th, int tw) {
      const float* gsrc[1] = {cur};
      __syncthreads();
      stage_tile(gsrc, gt, y0, x0, th, tw, h, wd,
                 [&](const float4 (&v)[1], int) { return v[0]; });
      __syncthreads();
      conv_tile<C, BF16, TF32>(gt, wfT, th, tw, [&](int ty, int tx, int g, int c, float v0, float v1) {
        const int oc = GSIZE * g + c;
        const int off = ((y0 + ty) * wd + x0 + tx) * C + oc;
        *reinterpret_cast<float2*>(gres + off) = make_float2(v0, v1);
        const float2 x = __ldcg(reinterpret_cast<const float2*>(raw_r + off));
        channel_terms<T>(v0, x.x, statr, gr, ber, g, oc, s1[g & 1][0], s2[g & 1][0]);
        channel_terms<T>(v1, x.y, statr, gr, ber, g, oc + 1, s1[g & 1][1], s2[g & 1][1]);
      });
    });
    push_channel_partials(cluster, s1, s2, red, part + MAX_CLUSTER * C * 2, vacc + 4 * C,
                          vacc + 5 * C);
    cluster.sync();
    cluster_group_sums(cs, part + MAX_CLUSTER * C * 2, gr, gsumr, P);

    // B'. the resblock: gr = GNr's backward of gres -> tile, kept; ghn = gres + dgrad(gr);
    // GN0's channel sums.
    s1[0][0] = s1[0][1] = s1[1][0] = s1[1][1] = 0.0f;
    s2[0][0] = s2[0][1] = s2[1][0] = s2[1][1] = 0.0f;
    for_each_tile(r0, r1, wd, tile_rows, tile_cols, [&](int y0, int x0, int th, int tw) {
      const float* gsrc[2] = {gres, raw_r};
      __syncthreads();
      stage_tile(gsrc, gt, y0, x0, th, tw, h, wd, [&](const float4 (&v)[2], int j) {
        return gn_bwd4<T>(v[0], v[1], statr, gr, ber, gsumr, j);
      }, gr_keep);
      __syncthreads();
      conv_tile<C, BF16, TF32>(gt, wrT, th, tw, [&](int ty, int tx, int g, int c, float v0, float v1) {
        const int oc = GSIZE * g + c;
        const int off = ((y0 + ty) * wd + x0 + tx) * C + oc;
        const float2 r = __ldcg(reinterpret_cast<const float2*>(gres + off));
        const float a0 = v0 + r.x, a1 = v1 + r.y;
        *reinterpret_cast<float2*>(ghn + off) = make_float2(a0, a1);
        const float2 x = __ldcg(reinterpret_cast<const float2*>(raw_h + off));
        channel_terms<T>(a0, x.x, stat0, g0, be0, g, oc, s1[g & 1][0], s2[g & 1][0]);
        channel_terms<T>(a1, x.y, stat0, g0, be0, g, oc + 1, s1[g & 1][1], s2[g & 1][1]);
      });
    });
    push_channel_partials(cluster, s1, s2, red, part, vacc + C, vacc + 2 * C);
    cluster.sync();
    cluster_group_sums(cs, part, g0, gsum0, P);

    // A'. conv0: ga = GN0's backward of ghn -> tile, kept; the warped channels' gradient
    // g + dgrad(ga) through the warp's transpose into nxt; the image's and H's gradients
    // where asked.
    float hacc[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for_each_tile(r0, r1, wd, tile_rows, tile_cols, [&](int y0, int x0, int th, int tw) {
      const float* gsrc[2] = {ghn, raw_h};
      __syncthreads();
      stage_tile(gsrc, gt, y0, x0, th, tw, h, wd, [&](const float4 (&v)[2], int j) {
        return gn_bwd4<T>(v[0], v[1], stat0, g0, be0, gsum0, j);
      }, ga_keep);
      __syncthreads();
      conv_tile<C, BF16, TF32>(gt, w0T, th, tw, [&](int ty, int tx, int g, int c, float v0, float v1) {
        const int oc = GSIZE * g + c;
        const int y = y0 + ty, x = x0 + tx;
        const Tap t = warp_tap(Hr, x, y, h, wd);
        if (!t.ok) return;  // a zeroed sample passes no gradient
        const float2 r = __ldcg(reinterpret_cast<const float2*>(cur + (y * wd + x) * C + oc));
        const float gw0 = r.x + v0, gw1 = r.y + v1;
        const float t0 = gw0 * (1.0f - t.wy), b0v = gw0 * t.wy;
        const float t1 = gw1 * (1.0f - t.wy), b1v = gw1 * t.wy;
        atomicAdd(nxt + t.p00 * C + oc, t0 * (1.0f - t.wx));
        atomicAdd(nxt + t.p00 * C + oc + 1, t1 * (1.0f - t.wx));
        atomicAdd(nxt + t.p01 * C + oc, t0 * t.wx);
        atomicAdd(nxt + t.p01 * C + oc + 1, t1 * t.wx);
        atomicAdd(nxt + t.p10 * C + oc, b0v * (1.0f - t.wx));
        atomicAdd(nxt + t.p10 * C + oc + 1, b1v * (1.0f - t.wx));
        atomicAdd(nxt + t.p11 * C + oc, b0v * t.wx);
        atomicAdd(nxt + t.p11 * C + oc + 1, b1v * t.wx);
        if (dH != nullptr) {
          const float2 a = ld2(carry + t.p00 * C + oc), b = ld2(carry + t.p01 * C + oc);
          const float2 cc = ld2(carry + t.p10 * C + oc), e = ld2(carry + t.p11 * C + oc);
          const float gwx = t0 * (b.x - a.x) + b0v * (e.x - cc.x) + (t1 * (b.y - a.y) +
                            b1v * (e.y - cc.y));
          const float top0 = a.x * (1.0f - t.wx) + b.x * t.wx;
          const float bot0 = cc.x * (1.0f - t.wx) + e.x * t.wx;
          const float top1 = a.y * (1.0f - t.wx) + b.y * t.wx;
          const float bot1 = cc.y * (1.0f - t.wx) + e.y * t.wx;
          h_grad(Hr, x, y, h, wd, gwx, gw0 * (bot0 - top0) + gw1 * (bot1 - top1), hacc);
        }
      });
      if (dimage != nullptr)
        image_dgrad<BF16, TF32>(gt, wimg, y0, x0, th, tw, wd,
                                dimage + ((int64_t)n * Dm1 + d) * P * CIMG);
    });
    if (dH != nullptr) {
#pragma unroll
      for (int k = 0; k < 9; ++k)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          hacc[k] += __shfl_xor_sync(0xffffffffu, hacc[k], off);
      if ((tid & 31) == 0)
        for (int k = 0; k < 9; ++k) red[(tid >> 5) * 9 + k] = hacc[k];
      __syncthreads();
      if (tid < 9) {
        float v = 0.0f;
        for (int w = 0; w < NWARPS; ++w) v += red[w * 9 + tid];
        dH[(((int64_t)n * Dm1 + d) * cs + rank) * 9 + tid] = v;
      }
    }
    // nxt is complete for the step before; no block leaves while another may still read
    // its partial sums.
    cluster.sync();
  }

  for (int i = r0 * wd * C + tid; i < r1 * wd * C; i += THREADS)
    dfeats0[(int64_t)n * P * C + i] = __ldcg(gc_n + i);
  __syncthreads();
  for (int i = tid; i < 2 * C; i += THREADS) {  // GN0's (d gamma, d beta), then GNr's
    gnpart[(int64_t)blockIdx.x * GN_GRADS + i] = vacc[C + i];
    gnpart[(int64_t)blockIdx.x * GN_GRADS + 2 * C + i] = vacc[4 * C + i];
  }
}

// The weight-gradient pass's resident blocks an SM: two, so that one's staging of X (made
// on load, not copied) overlaps the other's products (one ran slower,
// scripts/refiner_variants.py's lever).
constexpr int WGRAD_MIN_BLOCKS = 2;

// The weight-gradient pass's arguments (wgrad.cuh): what X is made from, the kept G maps,
// the sequential part's (d gamma, d beta) slots, and the blocks given to each conv.
struct WgradArgs {
  const void* image;      // (N, D-1, P, 3), of the storage type
  const float* H_inc;     // (N, D-1, 9)
  const void* out;        // (N, D, P, 32), of the storage type: the carries
  const float* raw;       // (N, D-1, 2, P, 32): raw h, raw r
  const float* stats;     // (N, D-1, 2, 2, 4)
  const float* vec;       // (7, 32)
  const float* gmaps;     // (N, D-1, 2, P, 32): ga, gr
  const float* gcarry;    // (N, D, P, 32): the gradient of out[n, k]
  const float* gnpart;    // (gn_blocks, 4, 32)
  float* partial;         // (gridDim.x, wgrad::SLOT_FLOATS): each block's sums
  float* dparams;         // (KP): conv0's taps (9, 35, 32), the resblock's and conv_final's
                          // (9, 32, 32), the vectors (7, 32)
  unsigned int* barrier;
  int N, Dm1, h, w, P, spp, gn_blocks;  // spp: stages a (sample, step) plane
  int start[4];  // conv c's blocks (0: conv0, 1: the resblock's, 2: conv_final)
};

// Conv c's stage item (plane item / spp = n (D-1) + d, pixels p0 = (item % spp) KB ..) into
// the pass's tiles, zero outside the map: G, the kept map, by asynchronous copies
// (chain_wgrad_issue); X made on load as the forward made it once those have landed
// (chain_wgrad_finish, the plane's H and statistics to pl first; one item a thread at a
// time, which keeps the pass's two blocks an SM within their registers).
__device__ void chain_wgrad_issue(const WgradArgs& a, int c, int item, float* gs) {
  const int plane = item / a.spp, p0 = (item - plane * a.spp) * wgrad::KB;
  const int n = plane / a.Dm1, d = plane - n * a.Dm1;
  const int64_t PC = (int64_t)a.P * C;
  const float* g = c == 2 ? a.gcarry + ((int64_t)n * (a.Dm1 + 1) + d + 1) * PC
                          : a.gmaps + ((int64_t)plane * 2 + c) * PC;
  for (int i = threadIdx.x; i < wgrad::KB * 8; i += wgrad::THREADS) {
    const int j = i & 7, p = i >> 3;
    const bool in = p0 + p < a.P;
    wgrad::cp_async16(gs + p * wgrad::GS + 4 * j, in ? g + (int64_t)(p0 + p) * C + 4 * j : g, in);
  }
}

template <typename T>
__device__ void chain_wgrad_finish(const WgradArgs& a, int c, int item, float* xs,
                                   const float* vec, float* pl) {
  const int plane = item / a.spp, p0 = (item - plane * a.spp) * wgrad::KB;
  const int n = plane / a.Dm1, d = plane - n * a.Dm1, L = wgrad::KB + 2;
  const int64_t PC = (int64_t)a.P * C;
  const float* raw_h = a.raw + (int64_t)plane * 2 * PC;
  const float* raw_r = raw_h + PC;
  float* Hs = pl;           // H of the plane
  float* stat0 = pl + 12;   // mean[4], rstd[4] of GN0, then GNr's
  float* statr = stat0 + 2 * GROUPS;
  if (threadIdx.x < 9) Hs[threadIdx.x] = __ldg(a.H_inc + (int64_t)plane * 9 + threadIdx.x);
  else if (threadIdx.x >= 32 && threadIdx.x < 32 + 4 * GROUPS)
    stat0[threadIdx.x - 32] = __ldg(a.stats + (int64_t)plane * 4 * GROUPS + threadIdx.x - 32);
  __syncthreads();
  if (c == 0) {  // [the carry warped by H, the image, 0]: items (kh, e, quad j < 9)
    const T* carry = static_cast<const T*>(a.out) + ((int64_t)n * (a.Dm1 + 1) + d) * PC;
    const T* img = static_cast<const T*>(a.image) + (int64_t)plane * a.P * CIMG;
    const float (&Hr)[9] = *reinterpret_cast<const float(*)[9]>(Hs);
    for (int i = threadIdx.x; i < 3 * L * 9; i += wgrad::THREADS) {
      const int j = i % 9, e = (i / 9) % L, kh = i / (9 * L);
      const int q = p0 - 1 + e + (kh - 1) * a.w;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q >= 0 && q < a.P) {
        if (j == 8) {
          const T* im = img + (int64_t)q * CIMG;
          v = make_float4(ldg1(im), ldg1(im + 1), ldg1(im + 2), 0.0f);
        } else {
          const Tap t = warp_tap(Hr, q % a.w, q / a.w, a.h, a.w);
          if (t.ok)
            v = rnd4<T>(blend(ldcg4(carry + (int64_t)t.p00 * C + 4 * j),
                              ldcg4(carry + (int64_t)t.p01 * C + 4 * j),
                              ldcg4(carry + (int64_t)t.p10 * C + 4 * j),
                              ldcg4(carry + (int64_t)t.p11 * C + 4 * j), t.wx, t.wy));
        }
      }
      *reinterpret_cast<float4*>(xs + (kh * wgrad::RUN + e) * wgrad::XS + 4 * j) = v;
    }
  } else {  // the resblock's input h, or conv_final's h + the resblock's branch
    for (int i = threadIdx.x; i < 3 * L * 8; i += wgrad::THREADS) {
      const int j = i & 7, e = (i >> 3) % L, kh = (i >> 3) / L;
      const int q = p0 - 1 + e + (kh - 1) * a.w;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q >= 0 && q < a.P) {
        v = rnd4<T>(gn_leaky4(wgrad::ldcg4(raw_h + (int64_t)q * C + 4 * j), stat0, vec + C,
                              vec + 2 * C, j));
        if (c == 2) {
          const float4 r = rnd4<T>(gn_leaky4(wgrad::ldcg4(raw_r + (int64_t)q * C + 4 * j),
                                             statr, vec + 4 * C, vec + 5 * C, j));
          v = rnd4<T>(make_float4(v.x + r.x, v.y + r.y, v.z + r.z, v.w + r.w));
        }
      }
      *reinterpret_cast<float4*>(xs + (kh * wgrad::RUN + e) * wgrad::XS + 4 * j) = v;
    }
  }
}

// The parameter gradients in KP's layout: each element of conv c summed over its blocks'
// slots (wgrad::conv_wgrad's layout; conv0's staged rows are [warped 0..31, image 32..34]
// where its taps' rows are [image 0..2, warped 3..34]) in block order; each GroupNorm's
// (d gamma, d beta) over the sequential part's slots, in block order.
__device__ void chain_reduce(const WgradArgs& a) {
  constexpr int SLOT = wgrad::SLOT_FLOATS;
  for (int e = blockIdx.x * wgrad::THREADS + threadIdx.x; e < KP;
       e += gridDim.x * wgrad::THREADS) {
    int c, off;
    if (e < KW0) {
      const int ci = (e / C) % C0;
      c = 0;
      off = ((e / (C0 * C)) * 48 + (ci < CIMG ? C + ci : ci - CIMG)) * C + e % C;
    } else if (e < KW0 + 2 * KWR) {
      c = 1 + (e - KW0) / KWR;
      off = (e - KW0) % KWR;
    } else {
      const int row = (e - KW0 - 2 * KWR) / C, ch = e % C;
      if (row == 0 || row == 3 || row == 6) {  // a conv's bias
        c = row / 3;
        off = 9 * (c == 0 ? 48 : 32) * C + ch;
      } else {  // GN0's d gamma, d beta (rows 1, 2), GNr's (4, 5)
        const int k = row < 3 ? row - 1 : row - 2;
        float s = 0.0f;
        for (int b = 0; b < a.gn_blocks; ++b)
          s += __ldcg(a.gnpart + (int64_t)b * GN_GRADS + k * C + ch);
        a.dparams[e] = s;
        continue;
      }
    }
    a.dparams[e] = wgrad::sum_slots(a.partial + (int64_t)a.start[c] * SLOT + off,
                                    a.start[c + 1] - a.start[c], SLOT);
  }
}

template <typename T, bool TF32>
__global__ void __launch_bounds__(wgrad::THREADS, WGRAD_MIN_BLOCKS)
chain_wgrad_kernel(WgradArgs a) {
  constexpr bool BF16 = sizeof(T) == 2;
  extern __shared__ float4 smem4[];
  double* dsum = reinterpret_cast<double*>(smem4);
  float* tiles = reinterpret_cast<float*>(dsum + wgrad::THREADS);
  float* glo = tiles + 2 * wgrad::TILE_FLOATS;
  float* vec = glo + wgrad::G_FLOATS;
  float* pl = vec + VEC_FLOATS;
  for (int i = threadIdx.x; i < VEC_FLOATS; i += wgrad::THREADS) vec[i] = __ldg(a.vec + i);
  int c = 0;
  while ((int)blockIdx.x >= a.start[c + 1]) ++c;
  const int k = blockIdx.x - a.start[c], nb = a.start[c + 1] - a.start[c];
  const int items = a.N * a.Dm1 * a.spp;
  const int begin = (int)((int64_t)items * k / nb), end = (int)((int64_t)items * (k + 1) / nb);
  float* slot = a.partial + (int64_t)blockIdx.x * wgrad::SLOT_FLOATS;
  auto issue = [&](int item, float*, float* g) { chain_wgrad_issue(a, c, item, g); };
  auto finish = [&](int item, float* x, float*) {
    chain_wgrad_finish<T>(a, c, item, x, vec, pl);
    return true;
  };
  if (c == 0)
    wgrad::conv_wgrad<3, 4, BF16, TF32>(begin, end, a.spp, 1, CS, C, a.w, tiles, glo, dsum,
                                        slot, issue, finish);
  else
    wgrad::conv_wgrad<2, 4, BF16, TF32>(begin, end, a.spp, 1, C, C, a.w, tiles, glo, dsum,
                                        slot, issue, finish);
  grid_barrier(a.barrier);  // the blocks' slots are written
  chain_reduce(a);
}
// The pass's shared memory: wgrad.cuh's, then the vectors and a plane's H and statistics.
constexpr size_t WGRAD_SMEM_BYTES = wgrad::SMEM_BYTES + sizeof(float) * (VEC_FLOATS + 32);

struct Plan {
  int rows_per_block, tile_rows, tile_cols;
};

// Rows a block and tile rows and columns for a cluster of ``cluster`` blocks over an h x w
// map, a tile holding at most tile_pos positions with its halo.
Plan plan_for(int cluster, int h, int w, int tile_pos) {
  Plan p;
  p.rows_per_block = (h + cluster - 1) / cluster;
  p.tile_cols = w < MAX_TILE_W ? w : MAX_TILE_W;
  const int rows_fit = tile_pos / (p.tile_cols + 2) - 2;
  p.tile_rows = p.rows_per_block < rows_fit ? p.rows_per_block : rows_fit;
  return p;
}

cudaLaunchConfig_t launch_config(int blocks, int cluster, size_t smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

constexpr int MAX_DEVICES = 64;
constexpr int CANDIDATES[2] = {16, 8};

// Sets the attributes of the kernel for storage type T (and variant TF32) and reads how
// many clusters of 16 and of 8 blocks the current device holds at once (once a device
// and kernel).
template <typename T, bool TF32>
int resident_clusters(int (&active)[2]) {
  static int cache[MAX_DEVICES][2];  // resident clusters of each candidate size, +1 (0: unknown)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < MAX_DEVICES && cache[dev][0] > 0) {
    active[0] = cache[dev][0] - 1;
    active[1] = cache[dev][1] - 1;
    return 0;
  }
  err = cudaFuncSetAttribute(chain_kernel<T, TF32>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(chain_kernel<T, TF32>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  for (int k = 0; k < 2; ++k) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = launch_config(CANDIDATES[k], CANDIDATES[k], SMEM_BYTES, 0, &attr);
    err = cudaOccupancyMaxActiveClusters(&active[k], chain_kernel<T, TF32>, &cfg);
    if (err != cudaSuccess) {
      cudaGetLastError();
      active[k] = 0;  // this size does not run here; the other may
    }
  }
  if (dev < MAX_DEVICES) {
    cache[dev][0] = active[0] + 1;
    cache[dev][1] = active[1] + 1;
  }
  return 0;
}

// The cluster size for N samples of an h x w map: the fewest waves of clusters times
// warp rounds a stage (plus one for the stage's fixed cost), ties to the larger cluster.
template <typename T, bool TF32>
int choose_cluster(int N, int h, int w, int* cluster) {
  int active[2];
  const int err = resident_clusters<T, TF32>(active);
  if (err != 0) return err;
  long best_cost = -1;
  *cluster = 0;
  for (int k = 0; k < 2; ++k) {
    if (active[k] <= 0) continue;
    const Plan p = plan_for(CANDIDATES[k], h, w, TILE_POS);
    const long waves = (N + active[k] - 1) / active[k];
    const long units = GROUPS * (((long)p.rows_per_block * w + 31) / 32);
    const long cost = waves * ((units + NWARPS - 1) / NWARPS + 1);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      *cluster = CANDIDATES[k];
    }
  }
  return *cluster > 0 ? 0 : (int)cudaErrorLaunchOutOfResources;
}

template <typename T, bool TF32>
int launch(const T* feats0, const T* image, const float* H_inc, const float* w0,
           const float* wr, const float* wf, const float* vec, T* out, float* scratch,
           float* keep_raw, float* keep_stats, int N, int Dm1, int h, int w, int cluster,
           cudaStream_t stream) {
  if (N == 0) return 0;
  int active[2];
  int err = resident_clusters<T, TF32>(active);  // also sets the kernel's attributes
  if (err != 0) return err;
  if (cluster <= 0) {
    err = choose_cluster<T, TF32>(N, h, w, &cluster);
    if (err != 0) return err;
  }
  const Plan p = plan_for(cluster, h, w, TILE_POS);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(N * cluster, cluster, SMEM_BYTES, stream, &attr);
  cudaError_t status = cudaLaunchKernelEx(&cfg, chain_kernel<T, TF32>, feats0, image, H_inc,
                                          w0, wr, wf, vec, out, scratch, keep_raw, keep_stats,
                                          Dm1, h, w, p.rows_per_block, p.tile_rows,
                                          p.tile_cols);
  if (status != cudaSuccess) {
    cudaGetLastError();
    return (int)status;
  }
  return (int)cudaGetLastError();
}

// Sets the backward kernel's attributes on the current device, once a device.
template <typename T, bool TF32>
int backward_attributes() {
  static bool done[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < MAX_DEVICES && done[dev]) return 0;
  err = cudaFuncSetAttribute(chain_bwd_kernel<T, TF32>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BWD_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(chain_bwd_kernel<T, TF32>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  if (dev < MAX_DEVICES) done[dev] = true;
  return 0;
}

template <typename T, bool TF32>
int launch_bwd(const T* image, const float* H_inc, const float* w0, const float* wr,
               const float* wf, const float* vec, const T* out, const float* raw,
               const float* stats, const T* grad, float* dfeats0, float* dimage, float* dH,
               float* gmaps, float* gcarry, float* gnpart, float* scratch, int N, int Dm1,
               int h, int w, int cluster, cudaStream_t stream) {
  if (N == 0) return 0;
  if (cluster <= 0 || cluster > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  int err = backward_attributes<T, TF32>();
  if (err != 0) return err;
  const Plan p = plan_for(cluster, h, w, TILE_POS_B);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(N * cluster, cluster, BWD_SMEM_BYTES, stream, &attr);
  cudaError_t status = cudaLaunchKernelEx(&cfg, chain_bwd_kernel<T, TF32>, image, H_inc, w0, wr,
                                          wf, vec, out, raw, stats, grad, dfeats0, dimage, dH,
                                          gmaps, gcarry, gnpart, scratch, Dm1, h, w,
                                          p.rows_per_block, p.tile_rows, p.tile_cols);
  if (status != cudaSuccess) {
    cudaGetLastError();
    return (int)status;
  }
  return (int)cudaGetLastError();
}

template <typename T, bool TF32>
int launch_wgrad(const T* image, const float* H_inc, const float* vec, const T* out,
                 const float* raw, const float* stats, const float* gmaps,
                 const float* gcarry, const float* gnpart, int gn_blocks, float* dparams,
                 float* partial, long long partial_floats, unsigned int* barrier, int N,
                 int Dm1, int h, int w, cudaStream_t stream) {
  static int max_blocks[64] = {0};
  if (N == 0 || Dm1 == 0) return 0;
  if (gn_blocks < 1) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  int err = resident_blocks(chain_wgrad_kernel<T, TF32>, wgrad::THREADS, WGRAD_SMEM_BYTES,
                            max_blocks, &blocks);
  if (err != 0) return err;
  if (partial_floats / wgrad::SLOT_FLOATS < blocks)
    blocks = (int)(partial_floats / wgrad::SLOT_FLOATS);
  if (blocks < 3) return (int)cudaErrorInvalidValue;
  WgradArgs a;
  a.image = image;
  a.H_inc = H_inc;
  a.out = out;
  a.raw = raw;
  a.stats = stats;
  a.vec = vec;
  a.gmaps = gmaps;
  a.gcarry = gcarry;
  a.gnpart = gnpart;
  a.partial = partial;
  a.dparams = dparams;
  a.barrier = barrier;
  a.N = N;
  a.Dm1 = Dm1;
  a.h = h;
  a.w = w;
  a.P = h * w;
  a.spp = (a.P + wgrad::KB - 1) / wgrad::KB;
  a.gn_blocks = gn_blocks;
  // The blocks in proportion to each conv's products and the cost of making its X: conv0's
  // three row tiles and its gathers from four taps, then a GroupNorm on load, or two.
  const double weight[3] = {3 * 4 * 2.0, 2 * 4 * 1.2, 2 * 4 * 1.4};
  wgrad::split_blocks(blocks, 3, weight, a.start);
  void* args[] = {&a};
  cudaError_t status = cudaLaunchCooperativeKernel((const void*)chain_wgrad_kernel<T, TF32>,
                                                   dim3(blocks), dim3(wgrad::THREADS), args,
                                                   WGRAD_SMEM_BYTES, stream);
  if (status != cudaSuccess) {
    cudaGetLastError();
    return (int)status;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The cluster size a launch of the f32 kernel for N samples of an h x w map takes, into
// *cluster. Returns a CUDA error code (0 on success).
extern "C" int mvs_incremental_chain_cluster(int N, int h, int w, int* cluster) {
  return choose_cluster<float, false>(N, h, w, cluster);
}

// feats0 (N, P, 32), image (N, D-1, P, 3), H_inc (N, D-1, 9): f32, contiguous, P = h*w;
// feats0, out and scratch 16-byte aligned.
// w0 (9, 35, 32), wr (9, 32, 32), wf (9, 32, 32): tap-major [kh*3+kw][ci][oc].
// vec (7, 32): b0, gn0 scale, gn0 bias, res conv bias, res gn scale, res gn bias, bf.
// out (N, D, P, 32); scratch (N, 3, P, 32). keep_raw (N, D-1, 2, P, 32) and keep_stats
// (N, D-1, 2, 2, 4), f32, or both null: under autograd, each step's raw h and raw r, and
// each GroupNorm's mean and rstd per group, kept for the backward. cluster: blocks a
// sample, 0 to choose.
// Returns the CUDA error of the launch (0 on success); a refused launch leaves no error.
extern "C" int mvs_incremental_chain_f32(const float* feats0, const float* image,
                                         const float* H_inc, const float* w0,
                                         const float* wr, const float* wf,
                                         const float* vec, float* out, float* scratch,
                                         float* keep_raw, float* keep_stats, int N, int Dm1,
                                         int h, int w, int cluster, cudaStream_t stream) {
  return launch<float, false>(feats0, image, H_inc, w0, wr, wf, vec, out, scratch, keep_raw,
                              keep_stats, N, Dm1, h, w, cluster, stream);
}

// The same in 1xTF32: each conv operand rounded to TF32, one product a k-step.
extern "C" int mvs_incremental_chain_tf32(const float* feats0, const float* image,
                                          const float* H_inc, const float* w0,
                                          const float* wr, const float* wf,
                                          const float* vec, float* out, float* scratch,
                                          float* keep_raw, float* keep_stats, int N, int Dm1,
                                          int h, int w, int cluster, cudaStream_t stream) {
  return launch<float, true>(feats0, image, H_inc, w0, wr, wf, vec, out, scratch, keep_raw,
                             keep_stats, N, Dm1, h, w, cluster, stream);
}

// The same with feats0, image and out bf16 (H_inc, the weights, vec and scratch f32).
extern "C" int mvs_incremental_chain_bf16(const __nv_bfloat16* feats0,
                                          const __nv_bfloat16* image, const float* H_inc,
                                          const float* w0, const float* wr, const float* wf,
                                          const float* vec, __nv_bfloat16* out,
                                          float* scratch, float* keep_raw, float* keep_stats,
                                          int N, int Dm1, int h, int w, int cluster,
                                          cudaStream_t stream) {
  return launch<__nv_bfloat16, false>(feats0, image, H_inc, w0, wr, wf, vec, out, scratch,
                                      keep_raw, keep_stats, N, Dm1, h, w, cluster, stream);
}

// The backward, two launches, both on the stream of the forward's tensors. The sequential
// part: image (N, D-1, P, 3), out (N, D, P, 32) and grad (N, D, P, 32) at the storage type
// (f32 here); H_inc and the weights as the forward takes them; raw (N, D-1, 2, P, 32) and
// stats (N, D-1, 2, 2, 4) as the forward kept them. Writes dfeats0 (N, P, 32), dimage (N,
// D-1, P, 3) where not null, dH (N, D-1, cluster, 9) each block's sums where not null, and
// for the pass gmaps (N, D-1, 2, P, 32) each step's conv0 and resblock output gradients,
// gcarry (N, D, P, 32) the gradient of each out[n, k], gnpart (N * cluster, 4, 32) each
// block's (d gamma, d beta) of GN0 and of GNr. scratch (N, 2, P, 32) f32. cluster: the
// blocks a sample (1 .. 16), as the forward took. Returns the CUDA error of the launch (0 on
// success).
#define MVS_CHAIN_BWD(NAME, T, TF32)                                                        \
  extern "C" int NAME(const T* image, const float* H_inc, const float* w0, const float* wr, \
                      const float* wf, const float* vec, const T* out, const float* raw,   \
                      const float* stats, const T* grad, float* dfeats0, float* dimage,    \
                      float* dH, float* gmaps, float* gcarry, float* gnpart,               \
                      float* scratch, int N, int Dm1, int h, int w, int cluster,           \
                      cudaStream_t stream) {                                               \
    return launch_bwd<T, TF32>(image, H_inc, w0, wr, wf, vec, out, raw, stats, grad,       \
                               dfeats0, dimage, dH, gmaps, gcarry, gnpart, scratch, N, Dm1, \
                               h, w, cluster, stream);                                     \
  }
MVS_CHAIN_BWD(mvs_incremental_chain_bwd_f32, float, false)
MVS_CHAIN_BWD(mvs_incremental_chain_bwd_tf32, float, true)
MVS_CHAIN_BWD(mvs_incremental_chain_bwd_bf16, __nv_bfloat16, false)

// The weight-gradient pass, after the sequential part on the same stream: from image, H_inc,
// vec, out, raw and stats as the sequential part took them and its gmaps, gcarry and
// gnpart (its gn_blocks blocks), writes dparams (KP f32): conv0's taps (9, 35, 32), the
// resblock's and conv_final's (9, 32, 32), then the vectors (7, 32) in vec's order.
// partial: partial_floats f32, a slot of wgrad::SLOT_FLOATS a block (the grid takes at most
// as many blocks as it holds slots, and as are resident). barrier: the cooperative
// launches' counter of the stream (grid_sync.cuh). Returns the CUDA error of the launch.
#define MVS_CHAIN_WGRAD(NAME, T, TF32)                                                      \
  extern "C" int NAME(const T* image, const float* H_inc, const float* vec, const T* out,  \
                      const float* raw, const float* stats, const float* gmaps,            \
                      const float* gcarry, const float* gnpart, int gn_blocks,             \
                      float* dparams, float* partial, long long partial_floats,            \
                      unsigned int* barrier, int N, int Dm1, int h, int w,                 \
                      cudaStream_t stream) {                                               \
    return launch_wgrad<T, TF32>(image, H_inc, vec, out, raw, stats, gmaps, gcarry, gnpart, \
                                 gn_blocks, dparams, partial, partial_floats, barrier, N,  \
                                 Dm1, h, w, stream);                                       \
  }
MVS_CHAIN_WGRAD(mvs_incremental_chain_wgrad_f32, float, false)
MVS_CHAIN_WGRAD(mvs_incremental_chain_wgrad_tf32, float, true)
MVS_CHAIN_WGRAD(mvs_incremental_chain_wgrad_bf16, __nv_bfloat16, false)
