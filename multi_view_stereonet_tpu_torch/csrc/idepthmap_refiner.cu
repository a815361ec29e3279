// The whole IDepthmapRefiner of a small pyramid level as one kernel (Hopper, sm_90a).
//
// Replaces the TPU kernel
//   multi_view_stereonet_tpu/ops/pallas/refiner_kernel.py, idepthmap_refiner_fused
//   (_fused_impl -> _refiner_kernel),
// whose semantics are models/refiners.py idepthmap_refiner. For each sample:
//   h_0 = LeakyReLU(GN_0(conv0([guidance, idepth]) + b0))                (Cg + 1 -> 32)
//   h_k = h_{k-1} + LeakyReLU(GN_k(conv_k(h_{k-1}, dilation d_k) + b_k)), k = 1..6 (32 -> 32)
//   out = ReLU(idepth + conv_final(h_6) + bf)                             (32 -> 1)
// All convs are 3x3 with zero padding of width dilation; GroupNorm has 4 groups of 8
// channels, eps 1e-5, statistics over the h x w valid outputs only. The TPU kernel's
// padded s2d grid and border mask are the same rule: here a tap outside the map reads 0.
//
// What bounds it on this card: not bytes or multiply-adds at the peak rates (a few
// microseconds of either at 60 x 80) but the chain of dependent stages. Every GroupNorm
// needs its whole map's statistics before any pixel of the next conv can start, so the
// refiner is eight stages, each ending in a grid-wide exchange and each a small conv
// (38 M multiply-adds at 60 x 80) that fills at most one block on each SM: a stage's time
// is the barrier, two L2 round trips (statistics, staging) and the tensor-core rate of
// mma.sync on one SM for its share of 3xTF32 products.
//
// Design: the pixels of all samples are cut into m-tiles of 16 consecutive pixels (row
// major, a sample's last tile padded). A cooperative grid of at most one 384-thread block
// per SM takes the m-tiles in equal contiguous ranges, so even a 30 x 40 map spreads over
// 75 SMs. A stage handles a block's range in passes of up to 3 m-tiles:
//   1. statistics: the block reduces the previous layer's f64 partial sums of each sample
//      it touches, over the sample's m-tiles in a fixed order (the same mean and rstd in
//      every block and every run; no atomics);
//   2. staging: for each kernel row and m-tile, the 16 + 2d consecutive map positions its
//      taps read go into shared memory once, 36 floats a position. For the resblocks and
//      the final conv the staged input is computed on load from the previous layer's raw
//      conv output T and h: h_{k-1} = h_{k-2} + LeakyReLU(GN(T_{k-1})) (apply on load), so
//      there is no separate apply stage and no second barrier a layer; the positions of the
//      block's own pixels are also written back as h_{k-1} for the next residual;
//   3. conv on the tensor cores (mma.sync m16n8k8, TF32 in, f32 accumulate) in 3xTF32:
//      each operand is split on its integer bits into a TF32 high part and the rest, and
//      three products are summed, which keeps f32's accuracy. The weights come split
//      already. A warp computes 16 pixels x 32 output channels over a share of the taps;
//      then one warp a group sums the shares of its 8 channels in a fixed order;
//   4. epilogue: raw T_k = conv + b_k for the block's own pixels, and one (sum, sum of
//      squares) f64 partial per (m-tile, group); the final conv writes the output.
// One grid barrier a GroupNorm: 7 a launch. h and T are double-buffered in global scratch
// (N x h x w x 32 f32 each, L2-resident), so a neighbour's halo read of layer k - 1 never
// races a write of layer k; what one block reads of another's writes is loaded with
// __ldcg, from L2. The wrapper packs the weights once into the shared-memory image the
// conv reads ((hi, lo) pairs, tap-major, output channels XOR-swizzled by row so that B
// fragment loads fall on distinct banks); a layer's copy into one of two shared-memory
// buffers is one bulk copy by the tensor memory accelerator, issued while the layer before
// runs its convs.
//
// The guidance, and so the activations, are f32 or bf16 (the storage type T; the idepth
// map, the output, T_k, the statistics and all sums stay f32). At bf16 the kernel follows
// the Pallas kernel's rounding points (refiner_kernel.py:95-116,165-224): the staged
// input is [guidance, idepth rounded to bf16]; conv + bias and the GroupNorm statistics
// are f32; h_0 = bf16(LeakyReLU(GN_0)), h_k = bf16(h_{k-1} + bf16(LeakyReLU(GN_k))); the
// final conv's delta stays f32 and is added to the f32 idepth. The convs take bf16
// operands on the tensor cores' native bf16 mma.sync (m16n8k16, f32 accumulate), one
// product where 3xTF32 takes three; the wrapper packs the weights rounded to bf16 (as
// (w, 0) pairs in the same image). Tile and weights keep their f32 layout in shared
// memory, holding bf16 values.
//
// At f32 guidance a second variant (TF32, the 1xTF32 entry) takes one product a k-step,
// a_hi b_hi: each conv operand rounded to TF32 as split rounds it, the products summed in
// f32; the wrapper packs its weights as (hi, 0) pairs. It is the forward's "tf32"
// precision (matmul_precision "high"), the cuDNN convs' TF32 counterpart; everything but
// the convs' operands stays f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_sync.cuh"  // grid_barrier

namespace {

constexpr int C = 32;               // hidden channels
constexpr int GROUPS = 4;
constexpr int GSIZE = C / GROUPS;   // 8 channels a group: one n8 tile of the mma
constexpr int THREADS = 384;
constexpr int NWARPS = THREADS / 32;
constexpr int MTILE = 16;           // pixels an m-tile
constexpr int MT_MAX = 3;           // m-tiles a pass
constexpr int MAX_DIL = 8;          // the largest dilation the tile holds
constexpr int SEG = MTILE + 2 * MAX_DIL;  // staged positions a (kernel row, m-tile)
constexpr int CS = 36;              // floats a staged position (conv0: up to 36 channels)
constexpr int MAX_CIN0 = 36;
constexpr int NRES = 6;
constexpr int NGN = NRES + 1;       // GroupNorm layers: conv0's and the resblocks'
constexpr int LAYERS = NRES + 2;    // conv0, res0..5, conv_final: one stage each
constexpr int WF_COLS = 8;          // the final conv's one output channel, padded to n8
constexpr int W0_FLOATS = 2 * 9 * MAX_CIN0 * C;  // (hi, lo) pairs: conv0's, the largest
constexpr int WR_FLOATS = 2 * 9 * C * C;         // a resblock's (and the final conv's)
constexpr int VEC_FLOATS = 3 * C * NGN + 1;
constexpr int VEC_PAD = (VEC_FLOATS + 3) / 4 * 4;
constexpr int STAT_BATCH = 8;       // partial sums a thread loads before it adds any
constexpr int MAX_DEVICES = 64;
constexpr float EPS = 1e-5f;
constexpr float SLOPE = 0.2f;
static_assert(THREADS >= 8 * SEG && THREADS >= MAX_CIN0 / 4 * (MTILE + 2),
              "one thread a (run position, channel quad) pair");
static_assert(NWARPS / MT_MAX >= GROUPS, "a pass has a warp for each group of each m-tile");

// Shared memory, in this order: the weight buffers' two mbarriers, f64 statistics
// scratch, the weight buffers of the even layers (conv0's size) and of the odd ones, the
// staged tile [3][MT_MAX][SEG][CS], a zero row, the tap-share sums [NWARPS][16][32], the
// bias/GroupNorm vector, the pass's statistics [MT_MAX][mean 4, rstd 4] and one sample's.
constexpr int DRED_DOUBLES = NWARPS * GROUPS * 2;
constexpr int TILE_FLOATS = 3 * MT_MAX * SEG * CS;
constexpr int ZERO_FLOATS = CS + 4;
constexpr int RED_FLOATS = NWARPS * 16 * 32;
constexpr size_t SMEM_BYTES = sizeof(uint64_t) * 2 + sizeof(double) * DRED_DOUBLES +
                              sizeof(float) * (W0_FLOATS + WR_FLOATS + TILE_FLOATS +
                                               ZERO_FLOATS + RED_FLOATS + VEC_PAD +
                                               MT_MAX * 8 + 8);
static_assert(SMEM_BYTES <= 232448, "more than a block's shared memory");

struct Args {
  const void* guidance;   // (N, cg, h, w), of the storage type
  const float* idepth;    // (N, h, w)
  const float* wpack;     // w0 (9, cin_pad, 32, 2), wr (6, 9, 32, 32, 2), wf (9, 32, 8, 2), vec
  float* out;             // (N, h, w)
  float* hbuf;            // (2, N * P, 32)
  float* tbuf;            // (2, N * P, 32)
  double2* partials;      // (NGN, M, 4)
  unsigned int* barrier;
  int cg, cin_pad, h, w, P, tps, M, mpb;  // tps: m-tiles a sample; mpb: m-tiles a block
  double inv_count;                        // 1 / (P * 8): a group's values in a sample
  int dil[NRES];
};

__device__ __forceinline__ float leaky(float v) { return v >= 0.0f ? v : SLOPE * v; }

__device__ __forceinline__ float4 ldcg4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

// Storage type T: f32 or bf16. rnd<T> rounds a value to what T holds.
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (sizeof(T) == sizeof(float)) return v;
  else return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float ldg1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg1(const __nv_bfloat16* p) { return __bfloat162float(*p); }

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The weight buffers' copies are bulk copies by the tensor memory accelerator, each
// completing on an mbarrier in shared memory: one thread issues a layer's copy with one
// instruction, and every thread waits on the barrier's phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after generic reads
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(phase) : "memory");
  } while (!done);
}

// Layer l's packed weights, (hi, lo) pairs: conv0 (9 x cin_pad x 32), res l-1 (9 x 32 x
// 32), final (9 x 32 x 8); l = LAYERS is the vector of biases and GroupNorm parameters.
__device__ __forceinline__ const float* layer_weights(const Args& a, int l, int* count) {
  const int w0 = 2 * 9 * a.cin_pad * C;
  if (l == 0) {
    *count = w0;
    return a.wpack;
  }
  if (l <= NRES) {
    *count = WR_FLOATS;
    return a.wpack + w0 + (l - 1) * WR_FLOATS;
  }
  *count = l == LAYERS - 1 ? 2 * 9 * C * WF_COLS : VEC_FLOATS;
  return a.wpack + w0 + NRES * WR_FLOATS + (l == LAYERS - 1 ? 0 : 2 * 9 * C * WF_COLS);
}

// Issue the copy of layer l's weights into dst (one thread).
__device__ __forceinline__ void fetch_weights(const Args& a, int l, float* dst, uint64_t* bar) {
  int count;
  const float* src = layer_weights(a, l, &count);
  bulk_copy(dst, src, count * (uint32_t)sizeof(float), bar);
}

// Mean and rstd of each group of GroupNorm layer l for sample n -> tmp[0..3], tmp[4..7],
// from the partial sums of the sample's m-tiles in a fixed order. Every thread calls it.
__device__ void sample_stats(const Args& a, int l, int n, double* dred, float* tmp) {
  const double2* part = a.partials + ((int64_t)l * a.M + (int64_t)n * a.tps) * GROUPS;
  const int count = a.tps * GROUPS;
  double s = 0.0, ss = 0.0;
  for (int e0 = 0; e0 < count; e0 += STAT_BATCH * THREADS) {  // thread t: group t % 4
    double2 v[STAT_BATCH];
#pragma unroll
    for (int k = 0; k < STAT_BATCH; ++k) {
      const int e = e0 + threadIdx.x + k * THREADS;
      v[k] = e < count ? __ldcg(part + e) : make_double2(0.0, 0.0);
    }
#pragma unroll
    for (int k = 0; k < STAT_BATCH; ++k) {
      s += v[k].x;
      ss += v[k].y;
    }
  }
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane < GROUPS) {
    dred[(warp * GROUPS + lane) * 2] = s;
    dred[(warp * GROUPS + lane) * 2 + 1] = ss;
  }
  __syncthreads();
  if (threadIdx.x < GROUPS) {
    double S = 0.0, SS = 0.0;
    for (int k = 0; k < NWARPS; ++k) {
      S += dred[(k * GROUPS + threadIdx.x) * 2];
      SS += dred[(k * GROUPS + threadIdx.x) * 2 + 1];
    }
    const double mean = S * a.inv_count;
    const double var = fmax(SS * a.inv_count - mean * mean, 0.0);
    tmp[threadIdx.x] = (float)mean;
    tmp[GROUPS + threadIdx.x] = rsqrtf((float)(var + (double)EPS));
  }
  __syncthreads();
}

// The statistics of every m-tile slot of a pass (tiles m .. m + mt - 1) -> stat[slot][8].
// cur_n and reg carry the last sample's statistics from pass to pass.
__device__ __forceinline__ void pass_stats(const Args& a, int l, int m, int mt, double* dred,
                                           float* tmp, float* stat, int& cur_n, float& reg) {
  for (int i = 0; i < mt; ++i) {
    const int n = (m + i) / a.tps;
    if (n != cur_n) {
      sample_stats(a, l, n, dred, tmp);
      cur_n = n;
      if (threadIdx.x < 8) reg = tmp[threadIdx.x];
    }
    if (threadIdx.x < 8) stat[i * 8 + threadIdx.x] = reg;
  }
}

// The staged tile. For kernel row kh (dy = (kh - 1) d) and m-tile slot i of the pass, the
// taps of the m-tile's 16 pixels read 16 + 2d consecutive positions of the sample's
// row-major map, from first + dy w - d on: tile[kh][i][e] holds position e of that run
// (zero outside the map). A tap whose column falls off its row reads the zero row instead
// (conv_pass), so each position is staged once for the three taps of a kernel row.
template <typename F>
__device__ __forceinline__ F* tile_row(F* tile, int kh, int slot, int e) {
  return tile + ((kh * MT_MAX + slot) * SEG + e) * CS;
}

// For m-tile mm: its sample (*n), and the map position of run position 0 of kernel row
// 1 (its first pixel less d; kernel row kh adds (kh - 1) d w). It may lie outside the map.
__device__ __forceinline__ int run_start(const Args& a, int mm, int d, int* n) {
  *n = mm / a.tps;
  return (mm - *n * a.tps) * MTILE - d;
}

// Stage 0's tile: [guidance, idepth, 0 ...], cin_pad floats a position, the idepth
// rounded to T. Thread t < 18 quads owns run position t % 18 and channel quad t / 18 (a
// warp reads consecutive floats of a channel plane) in every kernel row and m-tile of the
// pass, and loads them all before it stores any.
template <typename T>
__device__ void stage_input(const Args& a, int m, int mt, float* tile) {
  const int L = MTILE + 2;
  const int e = threadIdx.x % L, j = threadIdx.x / L;
  if (j >= a.cin_pad / 4) return;
  float v[MT_MAX][3][4];
#pragma unroll
  for (int slot = 0; slot < MT_MAX; ++slot) {
    const bool on = slot < mt;
    int n = 0, q1 = 0;
    if (on) q1 = run_start(a, m + slot, 1, &n) + e;
    const T* guide[4];
    const float* idep[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = 4 * j + k;
      guide[k] = c < a.cg ? static_cast<const T*>(a.guidance) + ((int64_t)n * a.cg + c) * a.P
                          : nullptr;
      idep[k] = c == a.cg ? a.idepth + (int64_t)n * a.P : nullptr;
    }
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const int q = q1 + (kh - 1) * a.w;
      const bool in = on && q >= 0 && q < a.P;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[slot][kh][k] = !in      ? 0.0f
                         : guide[k] ? ldg1(guide[k] + q)
                         : idep[k]  ? rnd<T>(__ldg(idep[k] + q))
                                    : 0.0f;
    }
  }
#pragma unroll
  for (int slot = 0; slot < MT_MAX; ++slot) {
    if (slot >= mt) break;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh)
      reinterpret_cast<float4*>(tile_row(tile, kh, slot, e))[j] =
          make_float4(v[slot][kh][0], v[slot][kh][1], v[slot][kh][2], v[slot][kh][3]);
  }
}

// A resblock's or the final conv's pass up to its conv: the statistics of layer l for the
// pass's samples (into stat) and the tile, h_l = [h_{l-1} +] LeakyReLU(GN_l(T_l)) at each
// staged position (apply on load). The positions of the block's own pixels (kernel row 1,
// e in [d, d + 16)) are also written to hcur when it is given. Thread t < 8 (16 + 2d)
// owns run position e = t / 8 and channel quad j = t % 8 (a position's 128 bytes from 8
// lanes) in every kernel row and m-tile of the pass; it issues all its loads before the
// statistics are reduced, so that the two L2 round trips overlap. At bf16 the branch and
// the sum are each rounded. Every thread calls it.
template <bool RESIDUAL, typename T>
__device__ void stage_h(const Args& a, int l, int m, int mt, int d, float* tile, double* dred,
                        float* tmp, float* stat, int& cur_n, float& reg, const float* gamma,
                        const float* beta, const float* hprev, const float* tprev, float* hcur) {
  const int j = threadIdx.x & 7, e = threadIdx.x >> 3;
  const bool active = e < MTILE + 2 * d;
  float4 tv[MT_MAX][3], hv[MT_MAX][3];
  int64_t off[MT_MAX][3];
#pragma unroll
  for (int slot = 0; slot < MT_MAX; ++slot) {
    const bool on = active && slot < mt;
    int n = 0, q1 = 0;
    if (on) q1 = run_start(a, m + slot, d, &n) + e;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const int q = q1 + (kh - 1) * d * a.w;
      off[slot][kh] = on && q >= 0 && q < a.P ? ((int64_t)n * a.P + q) * C + 4 * j : -1;
      tv[slot][kh] = hv[slot][kh] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (off[slot][kh] >= 0) {
        tv[slot][kh] = ldcg4(tprev + off[slot][kh]);
        if (RESIDUAL) hv[slot][kh] = ldcg4(hprev + off[slot][kh]);
      }
    }
  }
  pass_stats(a, l, m, mt, dred, tmp, stat, cur_n, reg);
  __syncthreads();
  if (!active) return;
  const float4 ga = *reinterpret_cast<const float4*>(gamma + 4 * j);
  const float4 be = *reinterpret_cast<const float4*>(beta + 4 * j);
#pragma unroll
  for (int slot = 0; slot < MT_MAX; ++slot) {
    if (slot >= mt) break;
    const float mu = stat[slot * 8 + j / 2], rs = stat[slot * 8 + GROUPS + j / 2];
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (off[slot][kh] >= 0) {
        const float4 t = tv[slot][kh], h = hv[slot][kh];
        v = make_float4(rnd<T>(h.x + rnd<T>(leaky((t.x - mu) * rs * ga.x + be.x))),
                        rnd<T>(h.y + rnd<T>(leaky((t.y - mu) * rs * ga.y + be.y))),
                        rnd<T>(h.z + rnd<T>(leaky((t.z - mu) * rs * ga.z + be.z))),
                        rnd<T>(h.w + rnd<T>(leaky((t.w - mu) * rs * ga.w + be.w))));
        if (hcur != nullptr && kh == 1 && e >= d && e < d + MTILE)
          *reinterpret_cast<float4*>(hcur + off[slot][kh]) = v;
      }
      reinterpret_cast<float4*>(tile_row(tile, kh, slot, e))[j] = v;
    }
  }
}

// 3xTF32: x = hi + lo, hi = x rounded to TF32 (10 mantissa bits, round half away from
// zero, done on the integer bits: the conversion instruction has a fraction of the ALU
// rate), lo = x - hi exactly; the tensor core reads lo to TF32 by dropping its low 13
// bits. A product is a_hi b_hi + a_hi b_lo + a_lo b_hi; what is dropped (a_lo b_lo, and lo
// past 11 bits) is ~2^-21 of it. The wrapper splits the weights the same way.
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

// The (hi, lo) pair of weight (row, oc) of a tap's rows x LDW block, in pairs. The output
// channel is XOR-swizzled by the row so that the 16 lanes of a half-warp (rows t of a
// k-step, columns g) read 16 distinct 8-byte bank pairs.
template <int LDW>
__device__ __forceinline__ float2 wpair(const float* wk, int row, int oc) {
  const int col = LDW == C ? oc ^ ((row & 3) << 2) : oc ^ (((row >> 1) & 1) << 2);
  return reinterpret_cast<const float2*>(wk)[row * LDW + col];
}

// The conv of one pass on the tensor cores: the pass's mt m-tiles x NJ n8 tiles (output
// channels 0 .. 8 NJ - 1), ROWS input channels a tap (0: `rows`, a multiple of 4, at run
// time), dilation d. A warp takes one m-tile slot and a share of the taps (tap part,
// part + ks, ...). The shares go through `red`; warp part j of a slot then sums n8 tile
// j's shares in a fixed order and runs epi(slot, j, sums). Every thread calls it. BF16:
// bf16 m16n8k16 steps, lane (gq, tq) of the step over channels k .. k + 15 holding
// channels k + 4 tq .. k + 4 tq + 3 of A and B (the fragments' k order; lanes past
// `rows` hold zeros), from the hi halves of the (w, 0) weight pairs. Otherwise in 3xTF32,
// or in 1xTF32 (TF32): the one product a_hi b_hi, from the hi halves of (hi, 0) pairs.
template <int ROWS, int NJ, int LDW, bool BF16, bool TF32, typename Epi>
__device__ __forceinline__ void conv_pass(const Args& a, const float* tile, const float* zrow,
                                          const float* wt, int rows_rt, int m, int mt, int d,
                                          float* red, Epi&& epi) {
  const int rows = ROWS > 0 ? ROWS : rows_rt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int ks = min(9, NWARPS / mt);
  const bool busy = warp < mt * ks;
  const int slot = warp / ks, part = warp % ks;
  float acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.0f;
  if (busy) {
    // The columns of this lane's two pixels (gq and gq + 8 of the m-tile).
    const int mm = m + slot, n = mm / a.tps;
    const int pa = (mm - n * a.tps) * MTILE + gq;
    const int xa = pa % a.w, xb = (pa + 8) % a.w;
#pragma unroll 1
    for (int tap = part; tap < 9; tap += ks) {
      const int kh = tap / 3, dx = (tap % 3 - 1) * d;
      const float* row = tile_row(tile, kh, slot, d + dx + gq) + tq;
      const float* ta = xa + dx >= 0 && xa + dx < a.w ? row : zrow + tq;
      const float* tb = xb + dx >= 0 && xb + dx < a.w ? row + 8 * CS : zrow + tq;
      const float* wk = wt + 2 * tap * rows * LDW;
      if constexpr (BF16) {
        for (int k = 0; k < rows; k += 16) {
          const int c0 = k + 4 * tq;
          const bool on = c0 < rows;
          const float* sa = ta - tq + c0;
          const float* sb = tb - tq + c0;
          uint32_t av[4] = {0u, 0u, 0u, 0u};
          if (on) {
            av[0] = pack_bf16(sa[0], sa[1]);
            av[1] = pack_bf16(sb[0], sb[1]);
            av[2] = pack_bf16(sa[2], sa[3]);
            av[3] = pack_bf16(sb[2], sb[3]);
          }
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            uint32_t bv[2] = {0u, 0u};
            if (on) {
              const int oc = 8 * j + gq;
              bv[0] = pack_bf16(wpair<LDW>(wk, c0, oc).x, wpair<LDW>(wk, c0 + 1, oc).x);
              bv[1] = pack_bf16(wpair<LDW>(wk, c0 + 2, oc).x, wpair<LDW>(wk, c0 + 3, oc).x);
            }
            mma_bf16(acc[j], av, bv);
          }
        }
      } else {
        int k = 0;
#pragma unroll
        for (; k + 8 <= rows; k += 8) {
          uint32_t ah[4], al[4];
          split(ta[k], ah[0], al[0]);
          split(tb[k], ah[1], al[1]);
          split(ta[k + 4], ah[2], al[2]);
          split(tb[k + 4], ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float2 b0 = wpair<LDW>(wk, k + tq, 8 * j + gq);
            const float2 b1 = wpair<LDW>(wk, k + tq + 4, 8 * j + gq);
            const uint32_t bh[2] = {__float_as_uint(b0.x), __float_as_uint(b1.x)};
            const uint32_t bl[2] = {__float_as_uint(b0.y), __float_as_uint(b1.y)};
            if constexpr (!TF32) {
              mma_k8(acc[j], al, bh);
              mma_k8(acc[j], ah, bl);
            }
            mma_k8(acc[j], ah, bh);
          }
        }
        if (k < rows) {  // conv0's last four channels
          uint32_t ah[2], al[2];
          split(ta[k], ah[0], al[0]);
          split(tb[k], ah[1], al[1]);
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float2 b = wpair<LDW>(wk, k + tq, 8 * j + gq);
            if constexpr (!TF32) {
              mma_k4(acc[j], al, __float_as_uint(b.x));
              mma_k4(acc[j], ah, __float_as_uint(b.y));
            }
            mma_k4(acc[j], ah, __float_as_uint(b.x));
          }
        }
      }
    }
  }
  if (busy)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) red[((warp * NJ + j) * 4 + k) * 32 + lane] = acc[j][k];
  __syncthreads();
  if (busy && part < NJ) {
    float share[9][4];  // ks <= 9: every share is loaded before any is added
#pragma unroll
    for (int q = 0; q < 9; ++q)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        share[q][k] = q < ks ? red[(((slot * ks + q) * NJ + part) * 4 + k) * 32 + lane] : 0.0f;
    float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int q = 0; q < 9; ++q)
#pragma unroll
      for (int k = 0; k < 4; ++k) sum[k] += share[q][k];
    epi(slot, part, sum);
  }
}

template <typename T, bool TF32>
__global__ void __launch_bounds__(THREADS, 1) refiner_kernel(Args a) {
  constexpr bool BF16 = sizeof(T) == 2;
  extern __shared__ float4 smem4[];
  uint64_t* wbar = reinterpret_cast<uint64_t*>(smem4);  // the weight buffers' mbarriers
  double* dred = reinterpret_cast<double*>(wbar + 2);
  float* const even = reinterpret_cast<float*>(dred + DRED_DOUBLES);  // layers 0, 2, 4, 6
  float* const odd = even + W0_FLOATS;                                 // layers 1, 3, 5, 7
  float* tile = odd + WR_FLOATS;
  float* zrow = tile + TILE_FLOATS;
  float* red = zrow + ZERO_FLOATS;
  float* vec = red + RED_FLOATS;  // layer l: bias vec[96 l], gamma vec[96 l + 32], beta + 64
  float* stat = vec + VEC_PAD;
  float* tmp = stat + MT_MAX * 8;
  const int tid = threadIdx.x, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int m_begin = blockIdx.x * a.mpb;
  const int m_end = min(a.M, m_begin + a.mpb);
  const int64_t NPC = (int64_t)a.M / a.tps * a.P * C;  // one h or T buffer

  int count;
  const float* vec_g = layer_weights(a, LAYERS, &count);
  for (int i = tid; i < count; i += THREADS) vec[i] = __ldg(vec_g + i);
  for (int i = tid; i < ZERO_FLOATS; i += THREADS) zrow[i] = 0.0f;
  if (tid == 0) {
    mbar_init(&wbar[0]);
    mbar_init(&wbar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fetch_weights(a, 0, even, &wbar[0]);
  }

  for (int s = 0; s < LAYERS; ++s) {
    // Layer s sits in buffer s % 2, its (s / 2)-th use; once this stage's first tile is
    // staged, layer s + 1 is copied into the other buffer while this stage's convs run.
    auto weights_ready = [&](int m) {
      if (tid == 0 && m == m_begin && s + 1 < LAYERS)
        fetch_weights(a, s + 1, (s + 1) & 1 ? odd : even, &wbar[(s + 1) & 1]);
      __syncthreads();
      mbar_wait(&wbar[s & 1], (s >> 1) & 1);
    };
    const float* wt = s & 1 ? odd : even;
    const float* bias = vec + 3 * C * s;
    float* tcur = a.tbuf + (s & 1) * NPC;
    int cur_n = -1;
    float reg = 0.0f;

    // conv + bias -> T_s for group g of the pass's own pixels, and its (m-tile, group)
    // partial sums, summed over the warp in a fixed order.
    auto epi_gn = [&](int m, int slot, int g, float (&v)[4]) {
      const int mm = m + slot, n = mm / a.tps;
      const int pa = (mm - n * a.tps) * MTILE + gq, pb = pa + 8;
      const int oc = GSIZE * g + 2 * tq;
      const float b0 = bias[oc], b1 = bias[oc + 1];
      double s1 = 0.0, s2 = 0.0;
      if (pa < a.P) {
        const float v0 = v[0] + b0, v1 = v[1] + b1;
        *reinterpret_cast<float2*>(tcur + ((int64_t)n * a.P + pa) * C + oc) = make_float2(v0, v1);
        s1 += (double)v0 + (double)v1;
        s2 += (double)v0 * v0 + (double)v1 * v1;
      }
      if (pb < a.P) {
        const float v0 = v[2] + b0, v1 = v[3] + b1;
        *reinterpret_cast<float2*>(tcur + ((int64_t)n * a.P + pb) * C + oc) = make_float2(v0, v1);
        s1 += (double)v0 + (double)v1;
        s2 += (double)v0 * v0 + (double)v1 * v1;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
      }
      if (lane == 0) a.partials[((int64_t)s * a.M + mm) * GROUPS + g] = make_double2(s1, s2);
    };

    for (int m = m_begin; m < m_end; m += MT_MAX) {
      const int mt = min(MT_MAX, m_end - m);
      __syncthreads();  // the last pass's tile and sums are read
      if (s == 0) {
        stage_input<T>(a, m, mt, tile);
        weights_ready(m);
        conv_pass<0, GROUPS, C, BF16, TF32>(
            a, tile, zrow, wt, a.cin_pad, m, mt, 1, red,
            [&](int slot, int g, float (&v)[4]) { epi_gn(m, slot, g, v); });
        continue;
      }
      // Stages 1..7: the tile is h_{s-1}, applied on load from T_{s-1} (and h_{s-2}).
      const int l = s - 1;
      const float* gamma = vec + 3 * C * l + C;
      const float* beta = gamma + C;
      const float* tprev = a.tbuf + (l & 1) * NPC;
      float* hcur = s < LAYERS - 1 ? a.hbuf + (l & 1) * NPC : nullptr;
      const int d = s < LAYERS - 1 ? a.dil[s - 1] : 1;
      if (s == 1)
        stage_h<false, T>(a, l, m, mt, d, tile, dred, tmp, stat, cur_n, reg, gamma, beta,
                          nullptr, tprev, hcur);
      else
        stage_h<true, T>(a, l, m, mt, d, tile, dred, tmp, stat, cur_n, reg, gamma, beta,
                         a.hbuf + ((l - 1) & 1) * NPC, tprev, hcur);
      weights_ready(m);
      if (s < LAYERS - 1) {
        conv_pass<C, GROUPS, C, BF16, TF32>(
            a, tile, zrow, wt, C, m, mt, d, red,
            [&](int slot, int g, float (&v)[4]) { epi_gn(m, slot, g, v); });
      } else {  // out = ReLU(idepth + conv_final(h_6) + bf): column 0 of the n8 tile
        const float bf = vec[3 * C * NGN];
        conv_pass<C, 1, WF_COLS, BF16, TF32>(a, tile, zrow, wt, C, m, mt, 1, red,
                                             [&](int slot, int, float (&v)[4]) {
          if (tq != 0) return;
          const int mm = m + slot, n = mm / a.tps;
          const int pa = (mm - n * a.tps) * MTILE + gq, pb = pa + 8;
          if (pa < a.P) {
            const int64_t i = (int64_t)n * a.P + pa;
            a.out[i] = fmaxf(a.idepth[i] + (v[0] + bf), 0.0f);
          }
          if (pb < a.P) {
            const int64_t i = (int64_t)n * a.P + pb;
            a.out[i] = fmaxf(a.idepth[i] + (v[2] + bf), 0.0f);
          }
        });
      }
    }
    if (s < LAYERS - 1) grid_barrier(a.barrier);
  }
}

// Floats of scratch a launch for N samples of an h x w map needs: h and T, double-
// buffered, then the f64 (sum, sum of squares) partials of every GroupNorm layer.
long long needed_scratch(int N, int h, int w) {
  const long long P = (long long)h * w, M = (long long)N * ((P + MTILE - 1) / MTILE);
  return 4LL * N * P * C + 4LL * NGN * M * GROUPS;
}

template <typename T, bool TF32>
int launch(const T* guidance, const float* idepth, const float* wpack, float* out,
           float* scratch, long long scratch_floats, unsigned int* barrier, int N, int cg,
           int h, int w, const int* dil, cudaStream_t stream) {
  static int max_blocks[MAX_DEVICES] = {0};  // resident blocks of this instantiation
  if (N == 0 || h == 0 || w == 0) return 0;
  if (cg < 0 || cg + 1 > MAX_CIN0 || scratch_floats < needed_scratch(N, h, w))
    return (int)cudaErrorInvalidValue;
  Args a;
  for (int k = 0; k < NRES; ++k) {
    if (dil[k] < 1 || dil[k] > MAX_DIL) return (int)cudaErrorInvalidValue;
    a.dil[k] = dil[k];
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (max_blocks[dev] == 0) {
    err = cudaFuncSetAttribute(refiner_kernel<T, TF32>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, refiner_kernel<T, TF32>,
                                                        THREADS, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm * sms == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
    max_blocks[dev] = per_sm * sms;
  }
  a.guidance = guidance;
  a.idepth = idepth;
  a.wpack = wpack;
  a.out = out;
  a.barrier = barrier;
  a.cg = cg;
  a.cin_pad = (cg + 1 + 3) / 4 * 4;
  a.h = h;
  a.w = w;
  a.P = h * w;
  a.inv_count = 1.0 / ((double)a.P * GSIZE);
  a.tps = (a.P + MTILE - 1) / MTILE;
  a.M = N * a.tps;
  a.mpb = (a.M + max_blocks[dev] - 1) / max_blocks[dev];
  const int64_t npc = (int64_t)N * a.P * C;
  a.hbuf = scratch;
  a.tbuf = scratch + 2 * npc;
  a.partials = reinterpret_cast<double2*>(scratch + 4 * npc);
  const int grid = (a.M + a.mpb - 1) / a.mpb;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)refiner_kernel<T, TF32>, dim3(grid),
                                    dim3(THREADS), args, SMEM_BYTES, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// guidance (N, cg, h, w), idepth (N, h, w): f32, contiguous, cg + 1 <= 36.
// wpack (f32, 16-byte aligned): each weight w as a (hi, lo) pair (see split) in
// [tap][ci][oc] order with oc swizzled as wpair reads it: w0 (9, cin_pad, 32) with
// cin_pad = cg + 1 rounded up to 4, zero rows past cg; wr (6, 9, 32, 32); wf (9, 32, 8),
// column 0 the final conv; then 7 x (conv bias, GN gamma, GN beta) x 32 for conv0 and
// res0..5, then bf (673 floats).
// out (N, h, w); scratch: scratch_floats f32, 16-byte aligned, at least needed_scratch.
// barrier: one uint32 that no launch on another stream uses, 0 before its first launch
// (a launch leaves it ready for the next). dil: the six resblock dilations (host array),
// 1 to 8. Returns a cudaError_t code: cudaErrorInvalidValue for an argument it does not
// take, cudaErrorCooperativeLaunchTooLarge if the grid cannot be resident.
extern "C" int mvs_idepthmap_refiner_f32(const float* guidance, const float* idepth,
                                         const float* wpack, float* out, float* scratch,
                                         long long scratch_floats, unsigned int* barrier,
                                         int N, int cg, int h, int w, const int* dil,
                                         cudaStream_t stream) {
  return launch<float, false>(guidance, idepth, wpack, out, scratch, scratch_floats, barrier,
                              N, cg, h, w, dil, stream);
}

// The same in 1xTF32; wpack holds each weight as (w rounded to TF32, 0).
extern "C" int mvs_idepthmap_refiner_tf32(const float* guidance, const float* idepth,
                                          const float* wpack, float* out, float* scratch,
                                          long long scratch_floats, unsigned int* barrier,
                                          int N, int cg, int h, int w, const int* dil,
                                          cudaStream_t stream) {
  return launch<float, true>(guidance, idepth, wpack, out, scratch, scratch_floats, barrier,
                             N, cg, h, w, dil, stream);
}

// The same with bf16 guidance; wpack holds each weight as (w rounded to bf16, 0).
extern "C" int mvs_idepthmap_refiner_bf16(const __nv_bfloat16* guidance, const float* idepth,
                                          const float* wpack, float* out, float* scratch,
                                          long long scratch_floats, unsigned int* barrier,
                                          int N, int cg, int h, int w, const int* dil,
                                          cudaStream_t stream) {
  return launch<__nv_bfloat16, false>(guidance, idepth, wpack, out, scratch, scratch_floats,
                                      barrier, N, cg, h, w, dil, stream);
}
