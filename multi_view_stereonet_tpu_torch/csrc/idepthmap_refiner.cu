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
// __ldcg, from L2. Under autograd the caller gives seven slots of each instead (every T_l
// and h_l, h_6 included, kept) and a buffer for each GroupNorm's mean and rstd, which the
// block holding a sample's first m-tile writes: what the backward (refiner_bwd_kernel,
// below) reads. The wrapper packs the weights once into the shared-memory image the
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

#include <algorithm>

#include "grid_sync.cuh"  // grid_barrier, resident_blocks
#include "wgrad.cuh"      // the backward's weight-gradient pass

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
  float* hbuf;            // (slots, N * P, 32): h_l in slot l % slots
  float* tbuf;            // (slots, N * P, 32): T_l in slot l % slots
  float* keep_stats;      // (NGN, N, 2, 4) mean and rstd of each GroupNorm, or null
  double2* partials;      // (NGN, M, 4)
  unsigned int* barrier;
  int cg, cin_pad, h, w, P, tps, M, mpb;  // tps: m-tiles a sample; mpb: m-tiles a block
  int slots;                               // 2 (double-buffered), or NGN (kept for the backward)
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
// from the partial sums of the sample's m-tiles in a fixed order (RAW: the two sums over
// the group's values, each divided by their count, instead). Every thread calls it.
template <bool RAW = false>
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
    if (RAW) {
      tmp[threadIdx.x] = (float)mean;
      tmp[GROUPS + threadIdx.x] = (float)(SS * a.inv_count);
    } else {
      const double var = fmax(SS * a.inv_count - mean * mean, 0.0);
      tmp[threadIdx.x] = (float)mean;
      tmp[GROUPS + threadIdx.x] = rsqrtf((float)(var + (double)EPS));
    }
  }
  __syncthreads();
}

// The statistics of every m-tile slot of a pass (tiles m .. m + mt - 1) -> stat[slot][8].
// cur_n and reg carry the last sample's statistics from pass to pass. Where they are kept
// (keep_stats), the block that holds a sample's first m-tile writes them.
__device__ __forceinline__ void pass_stats(const Args& a, int l, int m, int mt, double* dred,
                                           float* tmp, float* stat, int& cur_n, float& reg) {
  for (int i = 0; i < mt; ++i) {
    const int n = (m + i) / a.tps;
    if (n != cur_n) {
      sample_stats(a, l, n, dred, tmp);
      cur_n = n;
      if (threadIdx.x < 8) reg = tmp[threadIdx.x];
    }
    if (threadIdx.x < 8) {
      stat[i * 8 + threadIdx.x] = reg;
      if (a.keep_stats != nullptr && (m + i) % a.tps == 0)
        a.keep_stats[((int64_t)l * (a.M / a.tps) + n) * 8 + threadIdx.x] = reg;
    }
  }
}

// The staged tile. For kernel row kh (dy = (kh - 1) d) and m-tile slot i of the pass, the
// taps of the m-tile's 16 pixels read 16 + 2d consecutive positions of the sample's
// row-major map, from first + dy w - d on: tile[kh][i][e] holds position e of that run
// (zero outside the map). A tap whose column falls off its row reads the zero row instead
// (conv_pass), so each position is staged once for the three taps of a kernel row.
template <int MT = MT_MAX, typename F>
__device__ __forceinline__ F* tile_row(F* tile, int kh, int slot, int e) {
  return tile + ((kh * MT + slot) * SEG + e) * CS;
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
// time), dilation d, the tile holding MT m-tile slots. A warp takes one m-tile slot and a
// share of the taps (tap part, part + ks, ...). The shares go through `red`; warp part j
// of a slot (and j + ks, ...) then sums n8 tile j's shares in a fixed order and runs
// epi(slot, j, sums). TRANS (the
// backward's input gradients): the product's weight (k, n) is the layer's weight (n, k) of
// the flipped tap 8 - tap, its pack read as it is (wrows rows a tap, LDW columns), zero
// for n >= wrows: the transposed conv of the gradient tile. Every thread calls it. BF16:
// bf16 m16n8k16 steps, lane (gq, tq) of the step over channels k .. k + 15 holding
// channels k + 4 tq .. k + 4 tq + 3 of A and B (the fragments' k order; lanes past
// `rows` hold zeros), from the hi halves of the (w, 0) weight pairs. Otherwise in 3xTF32,
// or in 1xTF32 (TF32): the one product a_hi b_hi, from the hi halves of (hi, 0) pairs.
template <int ROWS, int NJ, int LDW, bool BF16, bool TF32, bool TRANS, int MT = MT_MAX,
          typename Epi>
__device__ __forceinline__ void conv_pass(const Args& a, const float* tile, const float* zrow,
                                          const float* wt, int rows_rt, int m, int mt, int d,
                                          float* red, int wrows, Epi&& epi) {
  const int rows = ROWS > 0 ? ROWS : rows_rt;
  auto wb = [&](const float* wk, int k, int nn) -> float2 {  // the (hi, lo) pair B(k, nn)
    if constexpr (TRANS) return nn < wrows ? wpair<LDW>(wk, nn, k) : make_float2(0.f, 0.f);
    else return wpair<LDW>(wk, k, nn);
  };
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
      const float* row = tile_row<MT>(tile, kh, slot, d + dx + gq) + tq;
      const float* ta = xa + dx >= 0 && xa + dx < a.w ? row : zrow + tq;
      const float* tb = xb + dx >= 0 && xb + dx < a.w ? row + 8 * CS : zrow + tq;
      const float* wk = TRANS ? wt + 2 * (8 - tap) * wrows * LDW : wt + 2 * tap * rows * LDW;
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
              bv[0] = pack_bf16(wb(wk, c0, oc).x, wb(wk, c0 + 1, oc).x);
              bv[1] = pack_bf16(wb(wk, c0 + 2, oc).x, wb(wk, c0 + 3, oc).x);
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
            const float2 b0 = wb(wk, k + tq, 8 * j + gq);
            const float2 b1 = wb(wk, k + tq + 4, 8 * j + gq);
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
            const float2 b = wb(wk, k + tq, 8 * j + gq);
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
  if (busy) {
    for (int j = part; j < NJ; j += ks) {
      float share[9][4];  // ks <= 9: every share is loaded before any is added
#pragma unroll
      for (int q = 0; q < 9; ++q)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          share[q][k] = q < ks ? red[(((slot * ks + q) * NJ + j) * 4 + k) * 32 + lane] : 0.0f;
      float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int q = 0; q < 9; ++q)
#pragma unroll
        for (int k = 0; k < 4; ++k) sum[k] += share[q][k];
      epi(slot, j, sum);
    }
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
    float* tcur = a.tbuf + (s % a.slots) * NPC;
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
        conv_pass<0, GROUPS, C, BF16, TF32, false>(
            a, tile, zrow, wt, a.cin_pad, m, mt, 1, red, 0,
            [&](int slot, int g, float (&v)[4]) { epi_gn(m, slot, g, v); });
        continue;
      }
      // Stages 1..7: the tile is h_{s-1}, applied on load from T_{s-1} (and h_{s-2}).
      const int l = s - 1;
      const float* gamma = vec + 3 * C * l + C;
      const float* beta = gamma + C;
      const float* tprev = a.tbuf + (l % a.slots) * NPC;
      // h_l; the final conv's input h_6 only where it is kept.
      float* hcur = s < LAYERS - 1 || a.slots == NGN ? a.hbuf + (l % a.slots) * NPC : nullptr;
      const int d = s < LAYERS - 1 ? a.dil[s - 1] : 1;
      if (s == 1)
        stage_h<false, T>(a, l, m, mt, d, tile, dred, tmp, stat, cur_n, reg, gamma, beta,
                          nullptr, tprev, hcur);
      else
        stage_h<true, T>(a, l, m, mt, d, tile, dred, tmp, stat, cur_n, reg, gamma, beta,
                         a.hbuf + ((l - 1) % a.slots) * NPC, tprev, hcur);
      weights_ready(m);
      if (s < LAYERS - 1) {
        conv_pass<C, GROUPS, C, BF16, TF32, false>(
            a, tile, zrow, wt, C, m, mt, d, red, 0,
            [&](int slot, int g, float (&v)[4]) { epi_gn(m, slot, g, v); });
      } else {  // out = ReLU(idepth + conv_final(h_6) + bf): column 0 of the n8 tile
        const float bf = vec[3 * C * NGN];
        conv_pass<C, 1, WF_COLS, BF16, TF32, false>(a, tile, zrow, wt, C, m, mt, 1, red, 0,
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

// ---- The backward ----------------------------------------------------------------------
//
// The gradient of out = ReLU(idepth + conv_final(h_6) + bf) in the guidance, the idepth
// map and every parameter, from what the forward kept under autograd (T_0 .. T_6, h_0 ..
// h_6, each GroupNorm's mean and rstd) and the output's gradient. It has no TPU kernel to
// replace: the JAX package takes it as the VJP of idepthmap_refiner_s2d (refiner_kernel.py
// _fused_bwd). Per sample, with gout = grad ReLU'(out):
//   d idepth = gout + conv0's input gradient in the idepth channel;
//   dh_6 = conv_final^T(gout); then for l = 6 .. 0: dz = dh_l LeakyReLU'(z_l), dT_l =
//   rstd (dz gamma - a - x_hat b) with a, b the group means of dz gamma and dz gamma x_hat,
//   dh_{l-1} = dh_l + conv_l^T(dT_l) (l >= 1), d[guidance, idepth] = conv0^T(dT_0);
//   each conv's weight gradient sum_p X(p + tap) dT(p) and bias gradient sum_p dT(p),
//   each GroupNorm's d gamma = sum dz x_hat and d beta = sum dz.
// Two launches. Only the input gradients and the GroupNorm backward's sums are sequential;
// the weight and bias gradients, half the multiply-adds, depend on nothing after them and
// go to one pass over the whole card (wgrad.cuh).
//
// 1. refiner_bwd_kernel, the sequential part. What bounds it: what bounds the forward, the
// chain of dependent stages (each GroupNorm's backward needs its group sums over the whole
// map). The forward's grid and m-tiles, walked in reverse: eight stages, stage s the
// backward of layer s (7: the final conv), a grid barrier after each but the last. A stage
// takes the block's m-tiles in passes of up to MT_B = 6 (the forward's MT_MAX is 3: the
// input tile X that left for the pass freed the shared memory of a tile twice the size,
// and each pass's fixed latency is paid half as often). A pass stages the gradient tile G
// with the forward's geometry (stage 7: gout in channel 0;
// else dT_s, applied on load from dh_s, the kept T_s, the statistics and the group sums,
// which the block reduces in f64 in a fixed order from the previous stage's per-(m-tile,
// group) partials) and writes its own pixels' G to a kept map (gout, or dT_s) for the
// pass. Then conv_pass over G with the layer's packed weights read transposed and
// tap-flipped (TRANS), on the tensor cores in the variant's arithmetic; its epilogue adds
// the residual dh_s, writes dh_{s-1} and the (sum dz, sum dz x_hat) partials of GroupNorm
// s - 1 (or, at stage 0, the guidance's and idepth's gradients), and the block sums its
// (d gamma, d beta) in f64, written to a slot of the block's own at the end. One weight
// buffer, refilled by one bulk copy at the start of each stage while its first pass stages
// G.
// 2. refiner_wgrad_kernel, the weight-gradient pass (wgrad.cuh): the eight convs' weight
// and bias gradients, X the kept h_{l-1} (conv0: [guidance, idepth rounded] made on load),
// G the kept maps; then every element summed over its blocks' slots, and (d gamma, d beta)
// over the sequential part's, in block order. No float atomics: every run gives the same
// bits.
// Rounding as the forward: the operands of every product are rounded as the variant's
// convs round them (3xTF32: split, three products; 1xTF32: TF32; bf16: bf16), every sum
// and every elementwise term is f32, the group sums and the bias sums f64; the gradient
// passes straight through each rounding of the forward, LeakyReLU's slope taken as plain
// autograd takes it.

constexpr int MT_B = 6;    // m-tiles a pass of the sequential part (the forward's: MT_MAX)
constexpr int NJ_IN = 5;   // conv0's input gradient: cin_pad <= 36 channels, five n8 tiles
constexpr int BRED_FLOATS = NWARPS * NJ_IN * 4 * 32;
constexpr int CHAN_DOUBLES = MT_B * C * 2;
constexpr int GN_GRADS = NGN * 2 * C;  // a block's (d gamma, d beta) of each GroupNorm
constexpr int BWD_DOUBLES = DRED_DOUBLES + GN_GRADS + CHAN_DOUBLES;
constexpr int BTILE_FLOATS = 3 * MT_B * SEG * CS;
constexpr size_t BWD_SMEM_BYTES =
    sizeof(uint64_t) * 2 + sizeof(double) * BWD_DOUBLES +
    sizeof(float) * (W0_FLOATS + BTILE_FLOATS + ZERO_FLOATS + BRED_FLOATS + VEC_PAD +
                     MT_B * 16 + 8);
static_assert(THREADS >= 3 * MT_B * (MTILE + 2), "stage_gout: a thread a staged position");
static_assert(BWD_SMEM_BYTES <= 232448, "more than a block's shared memory");
static_assert((sizeof(uint64_t) * 2 + sizeof(double) * BWD_DOUBLES) % 16 == 0,
              "the weight buffer and the tile are 16-byte aligned");

// Where layer l's weight gradient starts in the parameter gradients (l = LAYERS: the
// vector's): conv0's taps (9, cin_pad, 32), the resblocks' (6, 9, 32, 32), the final
// conv's (9, 32), then the vector (VEC_FLOATS) in vec's order.
__host__ __device__ inline int grad_offset(int cin_pad, int l) {
  const int w0 = 9 * cin_pad * C;
  if (l == 0) return 0;
  if (l <= NRES) return w0 + (l - 1) * 9 * C * C;
  return w0 + NRES * 9 * C * C + (l == LAYERS ? 9 * C : 0);
}

struct BwdArgs : Args {  // Args as the forward's: hbuf and tbuf hold the kept h and T
  const float* grad;     // (N, h, w): the output's gradient
  const float* stats;    // (NGN, N, 2, 4): the kept mean and rstd of each GroupNorm
  float* dguid;          // (N, cg, h, w) or null
  float* didepth;        // (N, h, w)
  float* dh;             // (2, N * P, 32): dh_l in slot l & 1
  float* gkeep;          // (NGN, N * P, 32): dT_l, kept for the weight-gradient pass
  float* gout;           // (N * P): gout, kept for the pass
  double* gnpart;        // (gridDim.x, NGN, 2, 32): each block's (d gamma, d beta)
};

// LeakyReLU's derivative at the f32 GroupNorm value z, as the plain version's autograd
// takes it: F.leaky_relu's at f32 (0.2 at 0), the JAX-style where on z rounded at bf16.
template <typename T>
__device__ __forceinline__ float leaky_slope(float z) {
  if constexpr (sizeof(T) == sizeof(float)) return z > 0.0f ? 1.0f : SLOPE;
  else return rnd<T>(z) >= 0.0f ? 1.0f : SLOPE;
}

// Stage 7's gradient tile: gout = ReLU'(out) grad at each staged position (dilation 1) in
// channel 0, channels 1..7 zero; the block's own pixels also get d idepth = gout (stage 0
// adds conv0's part) and are kept in a.gout. Thread t < 3 MT_B 18 owns (kernel row, slot,
// run position).
__device__ void stage_gout(const BwdArgs& a, int m, int mt, float* tile) {
  const int L = MTILE + 2, t = threadIdx.x;
  if (t >= 3 * MT_B * L) return;
  const int e = t % L, slot = (t / L) % MT_B, kh = t / (L * MT_B);
  if (slot >= mt) return;
  int n;
  const int q = run_start(a, m + slot, 1, &n) + e + (kh - 1) * a.w;
  float gv = 0.0f;
  if (q >= 0 && q < a.P) {
    const int64_t i = (int64_t)n * a.P + q;
    gv = __ldg(a.out + i) > 0.0f ? __ldg(a.grad + i) : 0.0f;
    if (kh == 1 && e >= 1 && e < 1 + MTILE) a.didepth[i] = a.gout[i] = gv;
  }
  float4* row = reinterpret_cast<float4*>(tile_row<MT_B>(tile, kh, slot, e));
  row[0] = make_float4(gv, 0.0f, 0.0f, 0.0f);
  row[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// The (mean, rstd) of GroupNorm l and the (a, b) of its backward for every slot of a pass
// -> stat[slot][8], gsum[slot][8]; a and b reduced from the partials of the sample's
// m-tiles in a fixed order (sample_stats<true>). Every thread calls it.
__device__ __forceinline__ void bwd_pass_stats(const BwdArgs& a, int l, int m, int mt,
                                               double* dred, float* tmp, float* stat,
                                               float* gsum, int& cur_n, float& reg) {
  for (int i = 0; i < mt; ++i) {
    const int n = (m + i) / a.tps;
    if (n != cur_n) {
      sample_stats<true>(a, l, n, dred, tmp);
      cur_n = n;
      if (threadIdx.x < 8) reg = tmp[threadIdx.x];
    }
    if (threadIdx.x < 8) {
      gsum[i * 8 + threadIdx.x] = reg;
      stat[i * 8 + threadIdx.x] =
          __ldg(a.stats + ((int64_t)l * (a.M / a.tps) + n) * 8 + threadIdx.x);
    }
  }
}

// Stage s's gradient tile (s <= 6, its conv at dilation d): dT_s = rstd (dz gamma - a -
// x_hat b), dz = dh_s LeakyReLU'(z), at each staged position (zero outside the map), from
// dh_s, the kept T_s and the pass's stat and gsum; the pass's own pixels' dT_s also go to
// gkeep. The threads form groups of 8 (16 + 2d), as many as THREADS holds: thread (e, j)
// of group g owns run position e and channel quad j of slots g, g + groups, ...; it
// issues the loads of three of its slots before it uses any.
template <typename T>
__device__ void stage_dt(const Args& a, int m, int mt, int d, float* tile, const float* stat,
                         const float* gsum, const float* gamma, const float* beta,
                         const float* dh, const float* tl, float* gkeep) {
  constexpr int CHUNK = 3;
  const int L = MTILE + 2 * d, groups = THREADS / (8 * L), g = threadIdx.x / (8 * L);
  if (g >= groups) return;
  const int j = threadIdx.x & 7, e = (threadIdx.x % (8 * L)) >> 3;
  const float* ga = gamma + 4 * j;
  const float* be = beta + 4 * j;
  const int q = j / 2;
  for (int first = g; first < mt; first += CHUNK * groups) {
    int64_t off[CHUNK][3];
    float4 gv[CHUNK][3], tv[CHUNK][3];
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      const int slot = first + k * groups;
      int n = 0, q1 = 0;
      if (slot < mt) q1 = run_start(a, m + slot, d, &n) + e;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        const int p = q1 + (kh - 1) * d * a.w;
        off[k][kh] = slot < mt && p >= 0 && p < a.P ? ((int64_t)n * a.P + p) * C + 4 * j : -1;
        gv[k][kh] = tv[k][kh] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (off[k][kh] >= 0) {
          gv[k][kh] = ldcg4(dh + off[k][kh]);
          tv[k][kh] = ldcg4(tl + off[k][kh]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      const int slot = first + k * groups;
      if (slot >= mt) break;
      const float mu = stat[slot * 8 + q], rs = stat[slot * 8 + GROUPS + q];
      const float A = gsum[slot * 8 + q], B = gsum[slot * 8 + GROUPS + q];
      auto one = [&](float gr, float t, int c) {
        const float xh = (t - mu) * rs;
        const float dz = gr * leaky_slope<T>(xh * ga[c] + be[c]);
        return rs * (dz * ga[c] - A - xh * B);
      };
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (off[k][kh] >= 0) {
          const float4 gr = gv[k][kh], t = tv[k][kh];
          v = make_float4(one(gr.x, t.x, 0), one(gr.y, t.y, 1), one(gr.z, t.z, 2),
                          one(gr.w, t.w, 3));
          if (kh == 1 && e >= d && e < d + MTILE)
            *reinterpret_cast<float4*>(gkeep + off[k][kh]) = v;
        }
        reinterpret_cast<float4*>(tile_row<MT_B>(tile, kh, slot, e))[j] = v;
      }
    }
  }
}

template <typename T, bool TF32>
__global__ void __launch_bounds__(THREADS, 1) refiner_bwd_kernel(BwdArgs a) {
  constexpr bool BF16 = sizeof(T) == 2;
  extern __shared__ float4 smem4[];
  uint64_t* wbar = reinterpret_cast<uint64_t*>(smem4);  // the weight buffer's mbarrier
  double* dred = reinterpret_cast<double*>(wbar + 2);
  double* gacc = dred + DRED_DOUBLES;  // the block's (d gamma, d beta) [layer][2][C]
  double* chan = gacc + GN_GRADS;      // a pass's [slot][channel][sum dz, sum dz x_hat]
  float* wbuf = reinterpret_cast<float*>(chan + CHAN_DOUBLES);
  float* gtile = wbuf + W0_FLOATS;
  float* zrow = gtile + BTILE_FLOATS;
  float* red = zrow + ZERO_FLOATS;
  float* vec = red + BRED_FLOATS;
  float* stat = vec + VEC_PAD;   // [slot][mean 4, rstd 4]
  float* gsum = stat + MT_B * 8;  // [slot][a 4, b 4]
  float* tmp = gsum + MT_B * 8;
  const int tid = threadIdx.x, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int m_begin = blockIdx.x * a.mpb;
  const int m_end = min(a.M, m_begin + a.mpb);
  const int N = a.M / a.tps;
  const int64_t NPC = (int64_t)N * a.P * C;  // one map

  int count;
  const float* vec_g = layer_weights(a, LAYERS, &count);
  for (int i = tid; i < count; i += THREADS) vec[i] = __ldg(vec_g + i);
  for (int i = tid; i < GN_GRADS; i += THREADS) gacc[i] = 0.0;
  for (int i = tid; i < ZERO_FLOATS; i += THREADS) zrow[i] = 0.0f;
  if (tid == 0) {
    mbar_init(&wbar[0]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  for (int s = LAYERS - 1; s >= 0; --s) {
    // Every thread is past the last stage's convs (its grid barrier): refill the buffer.
    if (tid == 0) fetch_weights(a, s, wbuf, &wbar[0]);
    const bool last = s == LAYERS - 1;
    const int d = s == 0 || last ? 1 : a.dil[s - 1];
    const int l = max(s - 1, 0);  // the GroupNorm this stage's epilogue serves (s >= 1)
    const float* dh_s = a.dh + (s & 1) * NPC;
    float* dh_l = a.dh + (l & 1) * NPC;
    const float* gamma_l = vec + 3 * C * l + C;
    const float* beta_l = gamma_l + C;
    int cur_n = -1;
    float reg = 0.0f;

    // Stages 7 .. 1: dh_{s-1} = [dh_s +] the input gradient, for the block's own pixels, and
    // GroupNorm s - 1's partials: per channel (sum dz, sum dz x_hat) of the m-tile into
    // chan, per group (sum gamma dz, sum gamma dz x_hat) into the partials.
    auto epi_dh = [&](int m, int slot, int j, float (&v)[4]) {
      const int mm = m + slot, n = mm / a.tps;
      const int pa = (mm - n * a.tps) * MTILE + gq;
      const int oc = GSIZE * j + 2 * tq;
      const float* st = a.stats + ((int64_t)l * N + n) * 8;
      const float mu = __ldg(st + j), rs = __ldg(st + GROUPS + j);
      const float g0 = gamma_l[oc], g1 = gamma_l[oc + 1];
      const float b0 = beta_l[oc], b1 = beta_l[oc + 1];
      double s1[2] = {0.0, 0.0}, s2[2] = {0.0, 0.0};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = pa + 8 * r;
        if (p >= a.P) continue;
        const int64_t off = ((int64_t)n * a.P + p) * C + oc;
        float d0 = v[2 * r], d1 = v[2 * r + 1];
        if (!last) {  // the residual's gradient
          const float2 res = __ldcg(reinterpret_cast<const float2*>(dh_s + off));
          d0 = res.x + d0;
          d1 = res.y + d1;
        }
        *reinterpret_cast<float2*>(dh_l + off) = make_float2(d0, d1);
        const float2 t = __ldcg(reinterpret_cast<const float2*>(a.tbuf + l * NPC + off));
        const float x0 = (t.x - mu) * rs, x1 = (t.y - mu) * rs;
        const float z0 = d0 * leaky_slope<T>(x0 * g0 + b0);
        const float z1 = d1 * leaky_slope<T>(x1 * g1 + b1);
        s1[0] += (double)z0;
        s1[1] += (double)z1;
        s2[0] += (double)(z0 * x0);
        s2[1] += (double)(z1 * x1);
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          s1[k] += __shfl_xor_sync(0xffffffffu, s1[k], off);
          s2[k] += __shfl_xor_sync(0xffffffffu, s2[k], off);
        }
      if (gq == 0)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          chan[(slot * C + oc + k) * 2] = s1[k];
          chan[(slot * C + oc + k) * 2 + 1] = s2[k];
        }
      double A = (double)g0 * s1[0] + (double)g1 * s1[1];
      double B = (double)g0 * s2[0] + (double)g1 * s2[1];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        A += __shfl_xor_sync(0xffffffffu, A, off);
        B += __shfl_xor_sync(0xffffffffu, B, off);
      }
      if (lane == 0) a.partials[((int64_t)l * a.M + mm) * GROUPS + j] = make_double2(A, B);
    };
    // Stage 0: the guidance's and the idepth map's gradients.
    auto epi_in = [&](int m, int slot, int j, float (&v)[4]) {
      const int mm = m + slot, n = mm / a.tps;
      const int pa = (mm - n * a.tps) * MTILE + gq;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = pa + 8 * r;
        if (p >= a.P) continue;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int c = GSIZE * j + 2 * tq + k;
          if (c < a.cg) {
            if (a.dguid != nullptr) a.dguid[((int64_t)n * a.cg + c) * a.P + p] = v[2 * r + k];
          } else if (c == a.cg) {
            a.didepth[(int64_t)n * a.P + p] += v[2 * r + k];
          }
        }
      }
    };

    // The block's m-tiles in the fewest passes of at most MT_B, as even as they go.
    for (int m = m_begin, mt; m < m_end; m += mt) {
      const int left = m_end - m, passes = (left + MT_B - 1) / MT_B;
      mt = (left + passes - 1) / passes;
      __syncthreads();  // the last pass's tile and sums are read
      if (last) {
        stage_gout(a, m, mt, gtile);
      } else {
        bwd_pass_stats(a, s, m, mt, dred, tmp, stat, gsum, cur_n, reg);
        __syncthreads();
        stage_dt<T>(a, m, mt, d, gtile, stat, gsum, vec + 3 * C * s + C, vec + 3 * C * s + 2 * C,
                    dh_s, a.tbuf + s * NPC, a.gkeep + s * NPC);
      }
      __syncthreads();
      mbar_wait(&wbar[0], (LAYERS - 1 - s) & 1);
      if (last)
        conv_pass<WF_COLS, GROUPS, WF_COLS, BF16, TF32, true, MT_B>(
            a, gtile, zrow, wbuf, WF_COLS, m, mt, 1, red, C,
            [&](int slot, int j, float (&v)[4]) { epi_dh(m, slot, j, v); });
      else if (s > 0)
        conv_pass<C, GROUPS, C, BF16, TF32, true, MT_B>(
            a, gtile, zrow, wbuf, C, m, mt, d, red, C,
            [&](int slot, int j, float (&v)[4]) { epi_dh(m, slot, j, v); });
      else
        conv_pass<C, NJ_IN, C, BF16, TF32, true, MT_B>(
            a, gtile, zrow, wbuf, C, m, mt, 1, red, a.cin_pad,
            [&](int slot, int j, float (&v)[4]) { epi_in(m, slot, j, v); });
      if (s > 0) {
        __syncthreads();  // chan is written
        if (tid < C)
          for (int slot = 0; slot < mt; ++slot) {
            gacc[2 * C * l + tid] += chan[(slot * C + tid) * 2 + 1];  // gamma
            gacc[2 * C * l + C + tid] += chan[(slot * C + tid) * 2];  // beta
          }
      }
    }
    if (s > 0) grid_barrier(a.barrier);
  }
  __syncthreads();
  for (int i = tid; i < GN_GRADS; i += THREADS)
    a.gnpart[(int64_t)blockIdx.x * GN_GRADS + i] = gacc[i];
}

// The weight-gradient pass's resident blocks an SM: one (at 98-113 registers; two cap them
// at 96 and ran slower, scripts/refiner_variants.py's lever).
constexpr int WGRAD_MIN_BLOCKS = 1;

// The weight-gradient pass's arguments (wgrad.cuh): the eight convs' X and G, the
// sequential part's (d gamma, d beta) slots, and the blocks given to each layer.
struct WgradArgs {
  const void* guidance;   // (N, cg, h, w), of the storage type
  const float* idepth;    // (N, h, w)
  const float* hbuf;      // (NGN, N * P, 32): the kept h_l
  const float* gkeep;     // (NGN, N * P, 32): dT_l
  const float* gout;      // (N * P)
  const double* gnpart;   // (gn_blocks, NGN, 2, 32)
  float* partial;         // (gridDim.x, wgrad::SLOT_FLOATS): each block's sums
  float* dparams;         // (kp): the parameter gradients, grad_offset's layout
  unsigned int* barrier;
  int N, cg, cin_pad, h, w, P, spp, gn_blocks, kp;  // spp: stages a sample
  int dil[NRES];
  int start[LAYERS + 1];  // layer l's blocks: start[l] .. start[l + 1] - 1
};

// Layer l's stage item (sample item / spp, pixels p0 = (item % spp) KB ..) into the pass's
// tiles, zero outside the map: X, the three kernel rows' runs of h_{l-1}, and G, dT_l (l
// <= 6) or gout in column 0 (the final conv), by asynchronous copies (wgrad_issue); conv0's
// X, [guidance, idepth rounded to T, 0 ...], made on load from the NCHW guidance once the
// copies have landed (wgrad_finish: scalar items, a warp on consecutive positions of one
// channel, BATCH loads issued before any store).
__device__ void wgrad_issue(const WgradArgs& a, int l, int d, int item, float* xs, float* gs) {
  constexpr int NT_ = wgrad::THREADS;
  const int n = item / a.spp, p0 = (item - n * a.spp) * wgrad::KB;
  const int L = wgrad::KB + 2 * d;
  const int64_t plane = (int64_t)n * a.P;
  const int64_t NPC = (int64_t)a.N * a.P * C;
  if (l > 0) {
    const float* src = a.hbuf + (l - 1) * NPC;
    for (int i = threadIdx.x; i < 3 * L * 8; i += NT_) {
      const int j = i & 7, e = (i >> 3) % L, kh = (i >> 3) / L;
      const int q = p0 - d + e + (kh - 1) * d * a.w;
      const bool in = q >= 0 && q < a.P;
      wgrad::cp_async16(xs + (kh * wgrad::RUN + e) * wgrad::XS + 4 * j,
                        in ? src + (plane + q) * C + 4 * j : src, in);
    }
  }
  if (l < LAYERS - 1) {
    const float* src = a.gkeep + l * NPC;
    for (int i = threadIdx.x; i < wgrad::KB * 8; i += NT_) {
      const int j = i & 7, p = i >> 3;
      const bool in = p0 + p < a.P;
      wgrad::cp_async16(gs + p * wgrad::GS + 4 * j, in ? src + (plane + p0 + p) * C + 4 * j : src,
                        in);
    }
  } else {
    for (int p = threadIdx.x; p < wgrad::KB; p += NT_) {
      const bool in = p0 + p < a.P;
      wgrad::cp_async4(gs + p * wgrad::GS, in ? a.gout + plane + p0 + p : a.gout, in);
    }
  }
}

template <typename T>
__device__ bool wgrad_finish(const WgradArgs& a, int l, int item, float* xs) {
  if (l != 0) return false;
  constexpr int BATCH = 4, NT_ = wgrad::THREADS, d = 1;
  const int n = item / a.spp, p0 = (item - n * a.spp) * wgrad::KB;
  const int L = wgrad::KB + 2 * d;
  const int64_t plane = (int64_t)n * a.P;
  const T* guid = static_cast<const T*>(a.guidance) + (int64_t)n * a.cg * a.P;
  const int items = 3 * a.cin_pad * L;
  for (int base = threadIdx.x; base < items; base += BATCH * NT_) {
    float v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = base + u * NT_, e = i % L, c = (i / L) % a.cin_pad, kh = i / (L * a.cin_pad);
      const int q = p0 - d + e + (kh - 1) * d * a.w;
      v[u] = 0.0f;
      if (i < items && q >= 0 && q < a.P)
        v[u] = c < a.cg ? ldg1(guid + (int64_t)c * a.P + q)
               : c == a.cg ? rnd<T>(__ldg(a.idepth + plane + q)) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = base + u * NT_, e = i % L, c = (i / L) % a.cin_pad, kh = i / (L * a.cin_pad);
      if (i < items) xs[(kh * wgrad::RUN + e) * wgrad::XS + c] = v[u];
    }
  }
  return true;
}

// The parameter gradients in grad_offset's layout: each element of layer l summed over
// its blocks' slots (wgrad::conv_wgrad's layout) in block order; each GroupNorm's (d
// gamma, d beta) over the sequential part's slots, in block order.
__device__ void reduce_partials(const WgradArgs& a) {
  constexpr int SLOT = wgrad::SLOT_FLOATS;
  const int w0 = 9 * a.cin_pad * C, wr = NRES * 9 * C * C, vec0 = grad_offset(a.cin_pad, LAYERS);
  for (int e = blockIdx.x * wgrad::THREADS + threadIdx.x; e < a.kp;
       e += gridDim.x * wgrad::THREADS) {
    int l, off;
    if (e < w0) {  // conv0: rows of three m16 tiles, 32 columns
      l = 0;
      off = ((e / (a.cin_pad * C)) * 48 + (e / C) % a.cin_pad) * C + e % C;
    } else if (e < w0 + wr) {
      const int f = (e - w0) % (9 * C * C);
      l = 1 + (e - w0) / (9 * C * C);
      off = f;  // (tap 32 + ci) 32 + co
    } else if (e < vec0) {  // the final conv: one column of eight
      l = LAYERS - 1;
      off = (e - w0 - wr) * 8;
    } else {
      const int v = e - vec0, layer = v / (3 * C), kind = (v % (3 * C)) / C, c = v % C;
      if (v == 3 * C * NGN) {  // the final conv's bias
        l = LAYERS - 1;
        off = 9 * 32 * 8;
      } else if (kind == 0) {  // a conv's bias
        l = layer;
        off = 9 * (l == 0 ? 48 : 32) * C + c;
      } else {  // d gamma (kind 1) or d beta (kind 2)
        double s = 0.0;
        for (int b = 0; b < a.gn_blocks; ++b)
          s += __ldcg(a.gnpart + ((int64_t)b * NGN + layer) * 2 * C + (kind - 1) * C + c);
        a.dparams[e] = (float)s;
        continue;
      }
    }
    a.dparams[e] = wgrad::sum_slots(a.partial + (int64_t)a.start[l] * SLOT + off,
                                    a.start[l + 1] - a.start[l], SLOT);
  }
}

template <typename T, bool TF32>
__global__ void __launch_bounds__(wgrad::THREADS, WGRAD_MIN_BLOCKS)
refiner_wgrad_kernel(WgradArgs a) {
  constexpr bool BF16 = sizeof(T) == 2;
  extern __shared__ float4 smem4[];
  double* dsum = reinterpret_cast<double*>(smem4);
  float* tiles = reinterpret_cast<float*>(dsum + wgrad::THREADS);
  float* glo = tiles + 2 * wgrad::TILE_FLOATS;
  int l = 0;
  while ((int)blockIdx.x >= a.start[l + 1]) ++l;
  const int k = blockIdx.x - a.start[l], nb = a.start[l + 1] - a.start[l];
  const int items = a.N * a.spp;
  const int begin = (int)((int64_t)items * k / nb), end = (int)((int64_t)items * (k + 1) / nb);
  const int d = l == 0 || l == LAYERS - 1 ? 1 : a.dil[l - 1];
  float* slot = a.partial + (int64_t)blockIdx.x * wgrad::SLOT_FLOATS;
  auto issue = [&](int item, float* x, float* g) { wgrad_issue(a, l, d, item, x, g); };
  auto finish = [&](int item, float* x, float*) { return wgrad_finish<T>(a, l, item, x); };
  if (l == 0)
    wgrad::conv_wgrad<3, 4, BF16, TF32>(begin, end, a.spp, d, a.cin_pad, C, a.w, tiles, glo,
                                        dsum, slot, issue, finish);
  else if (l < LAYERS - 1)
    wgrad::conv_wgrad<2, 4, BF16, TF32>(begin, end, a.spp, d, C, C, a.w, tiles, glo, dsum,
                                        slot, issue, finish);
  else
    wgrad::conv_wgrad<2, 1, BF16, TF32>(begin, end, a.spp, d, C, 1, a.w, tiles, glo, dsum,
                                        slot, issue, finish);
  grid_barrier(a.barrier);  // the blocks' slots are written
  reduce_partials(a);
}

// ---- Launches ---------------------------------------------------------------------------

// Floats of scratch a forward launch for N samples of an h x w map needs: h and T, double-
// buffered (none where they are kept), then the f64 (sum, sum of squares) partials of every
// GroupNorm layer. The backward takes the same: dh double-buffered, then the partials.
long long needed_scratch(int N, int h, int w, bool maps) {
  const long long P = (long long)h * w, M = (long long)N * ((P + MTILE - 1) / MTILE);
  return (maps ? 4LL * N * P * C : 0LL) + 4LL * NGN * M * GROUPS;
}

// Args for N samples of an h x w map and the blocks the grid may take; the grid size.
int fill_args(Args& a, const void* guidance, const float* idepth, const float* wpack,
              unsigned int* barrier, int N, int cg, int h, int w, const int* dil,
              int max_blocks) {
  for (int k = 0; k < NRES; ++k) {
    if (dil[k] < 1 || dil[k] > MAX_DIL) return -1;
    a.dil[k] = dil[k];
  }
  a.guidance = guidance;
  a.idepth = idepth;
  a.wpack = wpack;
  a.barrier = barrier;
  a.keep_stats = nullptr;
  a.cg = cg;
  a.cin_pad = (cg + 1 + 3) / 4 * 4;
  a.h = h;
  a.w = w;
  a.P = h * w;
  a.inv_count = 1.0 / ((double)a.P * GSIZE);
  a.tps = (a.P + MTILE - 1) / MTILE;
  a.M = N * a.tps;
  a.mpb = (a.M + max_blocks - 1) / max_blocks;
  return (a.M + a.mpb - 1) / a.mpb;
}

template <typename T, bool TF32>
int launch(const T* guidance, const float* idepth, const float* wpack, float* out,
           float* scratch, long long scratch_floats, float* keep_t, float* keep_h,
           float* keep_stats, unsigned int* barrier, int N, int cg, int h, int w,
           const int* dil, cudaStream_t stream) {
  static int max_blocks[MAX_DEVICES] = {0};  // resident blocks of this instantiation
  if (N == 0 || h == 0 || w == 0) return 0;
  const bool keep = keep_t != nullptr;
  if (cg < 0 || cg + 1 > MAX_CIN0 || scratch_floats < needed_scratch(N, h, w, !keep) ||
      keep != (keep_h != nullptr) || keep != (keep_stats != nullptr))
    return (int)cudaErrorInvalidValue;
  int blocks = 0;
  int err = resident_blocks(refiner_kernel<T, TF32>, THREADS, SMEM_BYTES, max_blocks, &blocks);
  if (err != 0) return err;
  Args a;
  const int grid = fill_args(a, guidance, idepth, wpack, barrier, N, cg, h, w, dil, blocks);
  if (grid < 0) return (int)cudaErrorInvalidValue;
  const int64_t npc = (int64_t)N * a.P * C;
  a.out = out;
  a.slots = keep ? NGN : 2;
  a.hbuf = keep ? keep_h : scratch;
  a.tbuf = keep ? keep_t : scratch + 2 * npc;
  a.keep_stats = keep_stats;
  a.partials = reinterpret_cast<double2*>(keep ? scratch : scratch + 4 * npc);
  void* args[] = {&a};
  cudaError_t status = cudaLaunchCooperativeKernel((const void*)refiner_kernel<T, TF32>,
                                                   dim3(grid), dim3(THREADS), args, SMEM_BYTES,
                                                   stream);
  if (status != cudaSuccess) {
    cudaGetLastError();
    return (int)status;
  }
  return (int)cudaGetLastError();
}

template <typename T, bool TF32>
int launch_bwd(const T* guidance, const float* idepth, const float* wpack, const float* out,
               const float* keep_t, const float* keep_h, const float* keep_stats,
               const float* grad, float* dguid, float* didepth, float* gkeep, float* gout,
               double* gnpart, long long gnpart_doubles, int* blocks_used, float* scratch,
               long long scratch_floats, unsigned int* barrier, int N, int cg, int h, int w,
               const int* dil, cudaStream_t stream) {
  static int max_blocks[MAX_DEVICES] = {0};
  *blocks_used = 0;
  if (N == 0 || h == 0 || w == 0) return 0;
  if (cg < 0 || cg + 1 > MAX_CIN0 || scratch_floats < needed_scratch(N, h, w, false) +
                                                          2LL * N * h * w * C)
    return (int)cudaErrorInvalidValue;
  int blocks = 0;
  int err =
      resident_blocks(refiner_bwd_kernel<T, TF32>, THREADS, BWD_SMEM_BYTES, max_blocks, &blocks);
  if (err != 0) return err;
  BwdArgs a;
  const int grid = fill_args(a, guidance, idepth, wpack, barrier, N, cg, h, w, dil, blocks);
  if (grid < 0 || gnpart_doubles < (long long)grid * GN_GRADS) return (int)cudaErrorInvalidValue;
  const int64_t npc = (int64_t)N * a.P * C;
  a.out = const_cast<float*>(out);
  a.slots = NGN;
  a.hbuf = const_cast<float*>(keep_h);
  a.tbuf = const_cast<float*>(keep_t);
  a.grad = grad;
  a.stats = keep_stats;
  a.dguid = dguid;
  a.didepth = didepth;
  a.dh = scratch;
  a.partials = reinterpret_cast<double2*>(scratch + 2 * npc);
  a.gkeep = gkeep;
  a.gout = gout;
  a.gnpart = gnpart;
  void* args[] = {&a};
  cudaError_t status = cudaLaunchCooperativeKernel((const void*)refiner_bwd_kernel<T, TF32>,
                                                   dim3(grid), dim3(THREADS), args,
                                                   BWD_SMEM_BYTES, stream);
  if (status != cudaSuccess) {
    cudaGetLastError();
    return (int)status;
  }
  *blocks_used = grid;
  return (int)cudaGetLastError();
}

template <typename T, bool TF32>
int launch_wgrad(const T* guidance, const float* idepth, const float* keep_h,
                 const float* gkeep, const float* gout, const double* gnpart, int gn_blocks,
                 float* dparams, float* partial, long long partial_floats,
                 unsigned int* barrier, int N, int cg, int h, int w, const int* dil,
                 cudaStream_t stream) {
  static int max_blocks[MAX_DEVICES] = {0};
  if (N == 0 || h == 0 || w == 0) return 0;
  if (cg < 0 || cg + 1 > MAX_CIN0 || gn_blocks < 1) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  int err = resident_blocks(refiner_wgrad_kernel<T, TF32>, wgrad::THREADS, wgrad::SMEM_BYTES,
                            max_blocks, &blocks);
  if (err != 0) return err;
  blocks = (int)std::min<long long>(blocks, partial_floats / wgrad::SLOT_FLOATS);
  if (blocks < LAYERS) return (int)cudaErrorInvalidValue;
  WgradArgs a;
  for (int k = 0; k < NRES; ++k) {
    if (dil[k] < 1 || dil[k] > MAX_DIL) return (int)cudaErrorInvalidValue;
    a.dil[k] = dil[k];
  }
  a.guidance = guidance;
  a.idepth = idepth;
  a.hbuf = keep_h;
  a.gkeep = gkeep;
  a.gout = gout;
  a.gnpart = gnpart;
  a.partial = partial;
  a.dparams = dparams;
  a.barrier = barrier;
  a.N = N;
  a.cg = cg;
  a.cin_pad = (cg + 1 + 3) / 4 * 4;
  a.h = h;
  a.w = w;
  a.P = h * w;
  a.spp = (a.P + wgrad::KB - 1) / wgrad::KB;
  a.gn_blocks = gn_blocks;
  a.kp = grad_offset(a.cin_pad, LAYERS) + VEC_FLOATS;
  // The blocks in proportion to each layer's products (conv0's scalar staging counted half
  // again), the final conv's one column of eight a quarter of a resblock's.
  double weight[LAYERS];
  for (int l = 0; l < LAYERS; ++l) weight[l] = l == 0 ? 1.5 * 3 * 4 : l < LAYERS - 1 ? 2 * 4 : 2;
  wgrad::split_blocks(blocks, LAYERS, weight, a.start);
  void* args[] = {&a};
  cudaError_t status = cudaLaunchCooperativeKernel((const void*)refiner_wgrad_kernel<T, TF32>,
                                                   dim3(blocks), dim3(wgrad::THREADS), args,
                                                   wgrad::SMEM_BYTES, stream);
  if (status != cudaSuccess) {
    cudaGetLastError();
    return (int)status;
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
// keep_t, keep_h (7, N, h, w, 32) and keep_stats (7, N, 2, 4), f32, or all three null:
// under autograd, each GroupNorm layer's raw conv output T_l, its h_l, and its mean and
// rstd per group, kept for the backward (the scratch then holds no maps).
// barrier: one uint32 that no launch on another stream uses, 0 before its first launch
// (a launch leaves it ready for the next). dil: the six resblock dilations (host array),
// 1 to 8. Returns a cudaError_t code: cudaErrorInvalidValue for an argument it does not
// take, cudaErrorCooperativeLaunchTooLarge if the grid cannot be resident.
extern "C" int mvs_idepthmap_refiner_f32(const float* guidance, const float* idepth,
                                         const float* wpack, float* out, float* scratch,
                                         long long scratch_floats, float* keep_t,
                                         float* keep_h, float* keep_stats,
                                         unsigned int* barrier, int N, int cg, int h, int w,
                                         const int* dil, cudaStream_t stream) {
  return launch<float, false>(guidance, idepth, wpack, out, scratch, scratch_floats, keep_t,
                              keep_h, keep_stats, barrier, N, cg, h, w, dil, stream);
}

// The same in 1xTF32; wpack holds each weight as (w rounded to TF32, 0).
extern "C" int mvs_idepthmap_refiner_tf32(const float* guidance, const float* idepth,
                                          const float* wpack, float* out, float* scratch,
                                          long long scratch_floats, float* keep_t,
                                          float* keep_h, float* keep_stats,
                                          unsigned int* barrier, int N, int cg, int h, int w,
                                          const int* dil, cudaStream_t stream) {
  return launch<float, true>(guidance, idepth, wpack, out, scratch, scratch_floats, keep_t,
                             keep_h, keep_stats, barrier, N, cg, h, w, dil, stream);
}

// The same with bf16 guidance; wpack holds each weight as (w rounded to bf16, 0).
extern "C" int mvs_idepthmap_refiner_bf16(const __nv_bfloat16* guidance, const float* idepth,
                                          const float* wpack, float* out, float* scratch,
                                          long long scratch_floats, float* keep_t,
                                          float* keep_h, float* keep_stats,
                                          unsigned int* barrier, int N, int cg, int h, int w,
                                          const int* dil, cudaStream_t stream) {
  return launch<__nv_bfloat16, false>(guidance, idepth, wpack, out, scratch, scratch_floats,
                                      keep_t, keep_h, keep_stats, barrier, N, cg, h, w, dil,
                                      stream);
}

// The backward of the variant's forward, two launches. The sequential part: from the
// forward's inputs (guidance, idepth, the same wpack), its output out and what it kept
// (keep_t, keep_h, keep_stats), and the output's gradient grad (N, h, w) f32, writes
// dguid (N, cg, h, w) f32 where not null, didepth (N, h, w) f32, and for the pass gkeep
// (7, N, h, w, 32) f32, each GroupNorm layer's dT_l, gout (N, h, w) f32 and gnpart:
// gnpart_doubles f64, each block's (d gamma, d beta) (7, 2, 32), its grid's blocks into
// *blocks (at most one a multiprocessor); scratch: scratch_floats f32, 16-byte aligned, at
// least two maps (N, h, w, 32) and needed_scratch's partials. Same barrier, dil and returns
// as the forward.
#define MVS_REFINER_BWD(NAME, T, TF32)                                                      \
  extern "C" int NAME(const T* guidance, const float* idepth, const float* wpack,          \
                      const float* out, const float* keep_t, const float* keep_h,          \
                      const float* keep_stats, const float* grad, float* dguid,            \
                      float* didepth, float* gkeep, float* gout, double* gnpart,           \
                      long long gnpart_doubles, int* blocks, float* scratch,               \
                      long long scratch_floats, unsigned int* barrier, int N, int cg,      \
                      int h, int w, const int* dil, cudaStream_t stream) {                 \
    return launch_bwd<T, TF32>(guidance, idepth, wpack, out, keep_t, keep_h, keep_stats,   \
                               grad, dguid, didepth, gkeep, gout, gnpart, gnpart_doubles,  \
                               blocks, scratch, scratch_floats, barrier, N, cg, h, w, dil, \
                               stream);                                                    \
  }
MVS_REFINER_BWD(mvs_idepthmap_refiner_bwd_f32, float, false)
MVS_REFINER_BWD(mvs_idepthmap_refiner_bwd_tf32, float, true)
MVS_REFINER_BWD(mvs_idepthmap_refiner_bwd_bf16, __nv_bfloat16, false)

// The weight-gradient pass, after the sequential part on the same stream: from the
// forward's guidance and idepth, its kept keep_h, and the sequential part's gkeep, gout and
// gnpart (its gn_blocks blocks), writes dparams: the parameter gradients in the pack's
// order, conv0's taps (9, cin_pad, 32), the resblocks' (6, 9, 32, 32), the final conv's (9,
// 32), then the vector (673) in its order. partial: partial_floats f32, a slot of
// wgrad::SLOT_FLOATS a block (the grid takes at most as many blocks as it holds slots, and
// as are resident). Same barrier, dil and returns as the forward.
#define MVS_REFINER_WGRAD(NAME, T, TF32)                                                    \
  extern "C" int NAME(const T* guidance, const float* idepth, const float* keep_h,         \
                      const float* gkeep, const float* gout, const double* gnpart,         \
                      int gn_blocks, float* dparams, float* partial,                       \
                      long long partial_floats, unsigned int* barrier, int N, int cg,      \
                      int h, int w, const int* dil, cudaStream_t stream) {                 \
    return launch_wgrad<T, TF32>(guidance, idepth, keep_h, gkeep, gout, gnpart, gn_blocks, \
                                 dparams, partial, partial_floats, barrier, N, cg, h, w,   \
                                 dil, stream);                                             \
  }
MVS_REFINER_WGRAD(mvs_idepthmap_refiner_wgrad_f32, float, false)
MVS_REFINER_WGRAD(mvs_idepthmap_refiner_wgrad_tf32, float, true)
MVS_REFINER_WGRAD(mvs_idepthmap_refiner_wgrad_bf16, __nv_bfloat16, false)
