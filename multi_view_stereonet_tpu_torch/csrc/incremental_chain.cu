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

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// NL global scratch maps: tile[pos][4j..4j+3] = make(the maps' channels 4j..4j+3, j).
// A thread loads BATCH items (position, quad) before it uses any.
template <int NL, typename Make>
__device__ __forceinline__ void stage_tile(const float* const (&src)[NL], float* tile, int y0,
                                           int x0, int th, int tw, int h, int wd,
                                           Make&& make) {
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
      const int y = y0 - 1 + pos / tpw, x = x0 - 1 + pos % tpw;
      const bool inside = y >= 0 && y < h && x >= 0 && x < wd;
      reinterpret_cast<float4*>(tile + pos * CS)[j] =
          inside ? make(v[u], j) : make_float4(0.f, 0.f, 0.f, 0.f);
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

template <typename T, bool TF32>
__global__ void __launch_bounds__(THREADS, 1)
chain_kernel(const T* __restrict__ feats0, const T* __restrict__ image,
             const float* __restrict__ H_inc, const float* __restrict__ w0_g,
             const float* __restrict__ wr_g, const float* __restrict__ wf_g,
             const float* __restrict__ vec_g, T* out, float* scratch, int Dm1, int h,
             int wd, int rows_per_block, int tile_rows, int tile_cols) {
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
  float* raw_h = warped + P * C;
  float* raw_r = raw_h + P * C;

  for (int d = 0; d < Dm1; ++d) {
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
      const int tpw = tw + 2;
      __syncthreads();
      // Items (position, quad j): j < 8 warp channels 4j..4j+3, j = 8 the image; a
      // thread computes BATCH items' taps and issues all their loads before blending.
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
          if (j < 8 && ty >= 1 && ty <= th && tx >= 1 && tx <= tw)  // own pixel: kept for C
            reinterpret_cast<float4*>(warped + (y * wd + x) * C)[j] = v;
        }
      }
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

struct Plan {
  int rows_per_block, tile_rows, tile_cols;
};

Plan plan_for(int cluster, int h, int w) {
  Plan p;
  p.rows_per_block = (h + cluster - 1) / cluster;
  p.tile_cols = w < MAX_TILE_W ? w : MAX_TILE_W;
  const int rows_fit = TILE_POS / (p.tile_cols + 2) - 2;
  p.tile_rows = p.rows_per_block < rows_fit ? p.rows_per_block : rows_fit;
  return p;
}

cudaLaunchConfig_t launch_config(int blocks, int cluster, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
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
    cudaLaunchConfig_t cfg = launch_config(CANDIDATES[k], CANDIDATES[k], 0, &attr);
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
    const Plan p = plan_for(CANDIDATES[k], h, w);
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
           const float* wr, const float* wf, const float* vec, T* out, float* scratch, int N,
           int Dm1, int h, int w, int cluster, cudaStream_t stream) {
  if (N == 0) return 0;
  int active[2];
  int err = resident_clusters<T, TF32>(active);  // also sets the kernel's attributes
  if (err != 0) return err;
  if (cluster <= 0) {
    err = choose_cluster<T, TF32>(N, h, w, &cluster);
    if (err != 0) return err;
  }
  const Plan p = plan_for(cluster, h, w);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(N * cluster, cluster, stream, &attr);
  cudaError_t status = cudaLaunchKernelEx(&cfg, chain_kernel<T, TF32>, feats0, image, H_inc,
                                          w0, wr, wf, vec, out, scratch, Dm1, h, w,
                                          p.rows_per_block, p.tile_rows, p.tile_cols);
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
// out (N, D, P, 32); scratch (N, 3, P, 32). cluster: blocks a sample, 0 to choose.
// Returns the CUDA error of the launch (0 on success); a refused launch leaves no error.
extern "C" int mvs_incremental_chain_f32(const float* feats0, const float* image,
                                         const float* H_inc, const float* w0,
                                         const float* wr, const float* wf,
                                         const float* vec, float* out, float* scratch,
                                         int N, int Dm1, int h, int w, int cluster,
                                         cudaStream_t stream) {
  return launch<float, false>(feats0, image, H_inc, w0, wr, wf, vec, out, scratch, N, Dm1, h,
                              w, cluster, stream);
}

// The same in 1xTF32: each conv operand rounded to TF32, one product a k-step.
extern "C" int mvs_incremental_chain_tf32(const float* feats0, const float* image,
                                          const float* H_inc, const float* w0,
                                          const float* wr, const float* wf,
                                          const float* vec, float* out, float* scratch,
                                          int N, int Dm1, int h, int w, int cluster,
                                          cudaStream_t stream) {
  return launch<float, true>(feats0, image, H_inc, w0, wr, wf, vec, out, scratch, N, Dm1, h,
                             w, cluster, stream);
}

// The same with feats0, image and out bf16 (H_inc, the weights, vec and scratch f32).
extern "C" int mvs_incremental_chain_bf16(const __nv_bfloat16* feats0,
                                          const __nv_bfloat16* image, const float* H_inc,
                                          const float* w0, const float* wr, const float* wf,
                                          const float* vec, __nv_bfloat16* out,
                                          float* scratch, int N, int Dm1, int h, int w,
                                          int cluster, cudaStream_t stream) {
  return launch<__nv_bfloat16, false>(feats0, image, H_inc, w0, wr, wf, vec, out, scratch, N,
                                      Dm1, h, w, cluster, stream);
}
