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
// part + ks, ...). The shares go through `red`; warp part j of a slot (and j + ks, ...)
// then sums n8 tile j's shares in a fixed order and runs epi(slot, j, sums). TRANS (the
// backward's input gradients): the product's weight (k, n) is the layer's weight (n, k) of
// the flipped tap 8 - tap, its pack read as it is (wrows rows a tap, LDW columns), zero
// for n >= wrows: the transposed conv of the gradient tile. Every thread calls it. BF16:
// bf16 m16n8k16 steps, lane (gq, tq) of the step over channels k .. k + 15 holding
// channels k + 4 tq .. k + 4 tq + 3 of A and B (the fragments' k order; lanes past
// `rows` hold zeros), from the hi halves of the (w, 0) weight pairs. Otherwise in 3xTF32,
// or in 1xTF32 (TF32): the one product a_hi b_hi, from the hi halves of (hi, 0) pairs.
template <int ROWS, int NJ, int LDW, bool BF16, bool TF32, bool TRANS, typename Epi>
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
      const float* row = tile_row(tile, kh, slot, d + dx + gq) + tq;
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
// refiner_bwd_kernel: the gradient of out = ReLU(idepth + conv_final(h_6) + bf) in the
// guidance, the idepth map and every parameter, from what the forward kept under autograd
// (T_0 .. T_6, h_0 .. h_6, each GroupNorm's mean and rstd) and the output's gradient. It
// has no TPU kernel to replace: the JAX package takes it as the VJP of
// idepthmap_refiner_s2d (refiner_kernel.py _fused_bwd). Per sample, with gout =
// grad ReLU'(out):
//   d idepth = gout + conv0's input gradient in the idepth channel;
//   dh_6 = conv_final^T(gout); then for l = 6 .. 0: dz = dh_l LeakyReLU'(z_l), dT_l =
//   rstd (dz gamma - a - x_hat b) with a, b the group means of dz gamma and dz gamma x_hat,
//   dh_{l-1} = dh_l + conv_l^T(dT_l) (l >= 1), d[guidance, idepth] = conv0^T(dT_0);
//   each conv's weight gradient sum_p X(p + tap) dT(p) and bias gradient sum_p dT(p),
//   each GroupNorm's d gamma = sum dz x_hat and d beta = sum dz.
// What bounds it: what bounds the forward, the chain of dependent stages (each
// GroupNorm's backward needs its group sums over the whole map), with twice the forward's
// multiply-adds (an input and a weight gradient a conv) and a cross-block sum of the
// weight gradients at the end.
//
// Design: the forward's grid, m-tiles and passes, walked in reverse: eight stages, stage s
// the backward of layer s (7: the final conv), one grid barrier after each. A pass stages
// two tiles with the forward's geometry: the gradient tile G (stage 7: gout in channel 0;
// else dT_s, applied on load from dh_s, the kept T_s, the statistics and the group sums,
// which the block reduces in f64 in a fixed order from the previous stage's per-(m-tile,
// group) partials) and the input tile X (h_{s-1}, or [guidance, idepth] at stage 0, as
// the forward staged it). Then
//   1. input gradient: conv_pass over G with the layer's packed weights read transposed
//      and tap-flipped (TRANS), on the tensor cores in the variant's arithmetic; its
//      epilogue adds the residual dh_s, writes dh_{s-1} and the (sum dz, sum dz x_hat)
//      partials of GroupNorm s - 1 (or, at stage 0, the guidance's and idepth's gradients);
//   2. weight gradient: X^T G over the pass's own pixels on the tensor cores (m16n8k8,
//      rows (tap, input channel), k the pixels), accumulated in registers over the
//      stage's passes, then written to the block's own slot of `partial`;
//   3. the bias, gamma and beta gradients, summed per block in f64 in a fixed order.
// After the last stage the blocks' slots are summed in block order into dparams. No float
// atomics: every run gives the same bits. One weight buffer, refilled by one bulk copy at
// the start of each stage (a second tile takes the forward's second buffer's place).
// Rounding as the forward: the operands of every product are rounded as the variant's
// convs round them (3xTF32: split, three products; 1xTF32: TF32; bf16: bf16), every sum
// and every elementwise term is f32, the group sums f64; the gradient passes straight
// through each rounding of the forward, LeakyReLU's slope taken as plain autograd takes it.

constexpr int NJ_IN = 5;   // conv0's input gradient: cin_pad <= 36 channels, five n8 tiles
constexpr int WQ = 9;      // (row tile, n8 tile) pairs of a weight gradient a warp holds
constexpr int BRED_FLOATS = NWARPS * NJ_IN * 4 * 32;
constexpr int CHAN_DOUBLES = MT_MAX * C * 2;
constexpr int BWD_DOUBLES = DRED_DOUBLES + VEC_PAD + CHAN_DOUBLES;
constexpr size_t BWD_SMEM_BYTES =
    sizeof(uint64_t) * 2 + sizeof(double) * BWD_DOUBLES +
    sizeof(float) * (W0_FLOATS + 2 * TILE_FLOATS + ZERO_FLOATS + BRED_FLOATS + VEC_PAD +
                     MT_MAX * 16 + 8);
static_assert(BWD_SMEM_BYTES <= 232448, "more than a block's shared memory");
static_assert((sizeof(uint64_t) * 2 + sizeof(double) * BWD_DOUBLES) % 16 == 0,
              "the weight buffer and the tiles are 16-byte aligned");

// Where layer l's weight gradient starts in a block's slot of the parameter gradients
// (l = LAYERS: the vector's): conv0's taps (9, cin_pad, 32), the resblocks' (6, 9, 32,
// 32), the final conv's (9, 32), then the vector (VEC_FLOATS) in vec's order.
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
  float* partial;        // (gridDim.x, kp): each block's parameter gradients
  float* dparams;        // (kp): their sum over the blocks
  int kp;
};

// LeakyReLU's derivative at the f32 GroupNorm value z, as the plain version's autograd
// takes it: F.leaky_relu's at f32 (0.2 at 0), the JAX-style where on z rounded at bf16.
template <typename T>
__device__ __forceinline__ float leaky_slope(float z) {
  if constexpr (sizeof(T) == sizeof(float)) return z > 0.0f ? 1.0f : SLOPE;
  else return rnd<T>(z) >= 0.0f ? 1.0f : SLOPE;
}

// An operand as the TF32 mma's hi and lo parts: 3xTF32 splits it; 1xTF32 takes the hi
// part; at bf16 it is rounded to bf16 first, which TF32 holds exactly.
template <bool BF16>
__device__ __forceinline__ void split_op(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (BF16) x = rnd<__nv_bfloat16>(x);
  split(x, hi, lo);
}

// Stage 7's gradient tile: gout = ReLU'(out) grad at each staged position (dilation 1) in
// channel 0, channels 1..7 zero; the block's own pixels also get d idepth = gout (stage 0
// adds conv0's part). Thread t < 162 owns (kernel row, slot, run position).
__device__ void stage_gout(const BwdArgs& a, int m, int mt, float* tile) {
  const int L = MTILE + 2, t = threadIdx.x;
  if (t >= 3 * MT_MAX * L) return;
  const int e = t % L, slot = (t / L) % MT_MAX, kh = t / (L * MT_MAX);
  if (slot >= mt) return;
  int n;
  const int q = run_start(a, m + slot, 1, &n) + e + (kh - 1) * a.w;
  float gv = 0.0f;
  if (q >= 0 && q < a.P) {
    const int64_t i = (int64_t)n * a.P + q;
    gv = __ldg(a.out + i) > 0.0f ? __ldg(a.grad + i) : 0.0f;
    if (kh == 1 && e >= 1 && e < 1 + MTILE) a.didepth[i] = gv;
  }
  float4* row = reinterpret_cast<float4*>(tile_row(tile, kh, slot, e));
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

// Map offsets of the staged positions of thread (e, j) (stage_h's mapping): -1 outside
// the map or past the pass.
__device__ __forceinline__ void staged_offsets(const Args& a, int m, int mt, int d, int e,
                                               int j, int64_t (&off)[MT_MAX][3]) {
#pragma unroll
  for (int slot = 0; slot < MT_MAX; ++slot) {
    int n = 0, q1 = 0;
    if (slot < mt) q1 = run_start(a, m + slot, d, &n) + e;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const int q = q1 + (kh - 1) * d * a.w;
      off[slot][kh] = slot < mt && q >= 0 && q < a.P ? ((int64_t)n * a.P + q) * C + 4 * j : -1;
    }
  }
}

// Stage s's gradient tile (s <= 6, its conv at dilation d): dT_s = rstd (dz gamma - a -
// x_hat b), dz = dh_s LeakyReLU'(z), at each staged position (zero outside the map), from
// dh_s, the kept T_s and the pass's stat and gsum. Thread t < 8 (16 + 2d) owns run
// position t / 8 and channel quad t % 8.
template <typename T>
__device__ void stage_dt(const Args& a, int m, int mt, int d, float* tile, const float* stat,
                         const float* gsum, const float* gamma, const float* beta,
                         const float* dh, const float* tl) {
  const int j = threadIdx.x & 7, e = threadIdx.x >> 3;
  if (e >= MTILE + 2 * d) return;
  int64_t off[MT_MAX][3];
  staged_offsets(a, m, mt, d, e, j, off);
  float4 gv[MT_MAX][3], tv[MT_MAX][3];
#pragma unroll
  for (int slot = 0; slot < MT_MAX; ++slot)
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      gv[slot][kh] = tv[slot][kh] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (off[slot][kh] >= 0) {
        gv[slot][kh] = ldcg4(dh + off[slot][kh]);
        tv[slot][kh] = ldcg4(tl + off[slot][kh]);
      }
    }
  const float* ga = gamma + 4 * j;
  const float* be = beta + 4 * j;
  const int q = j / 2;
#pragma unroll
  for (int slot = 0; slot < MT_MAX; ++slot) {
    if (slot >= mt) break;
    const float mu = stat[slot * 8 + q], rs = stat[slot * 8 + GROUPS + q];
    const float A = gsum[slot * 8 + q], B = gsum[slot * 8 + GROUPS + q];
    auto one = [&](float g, float t, int k) {
      const float xh = (t - mu) * rs;
      const float dz = g * leaky_slope<T>(xh * ga[k] + be[k]);
      return rs * (dz * ga[k] - A - xh * B);
    };
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (off[slot][kh] >= 0) {
        const float4 g = gv[slot][kh], t = tv[slot][kh];
        v = make_float4(one(g.x, t.x, 0), one(g.y, t.y, 1), one(g.z, t.z, 2), one(g.w, t.w, 3));
      }
      reinterpret_cast<float4*>(tile_row(tile, kh, slot, e))[j] = v;
    }
  }
}

// The staged tile of a kept map src (h_{s-1}) at dilation d, as stage_h stages it.
__device__ void stage_copy(const Args& a, int m, int mt, int d, float* tile, const float* src) {
  const int j = threadIdx.x & 7, e = threadIdx.x >> 3;
  if (e >= MTILE + 2 * d) return;
  int64_t off[MT_MAX][3];
  staged_offsets(a, m, mt, d, e, j, off);
  float4 v[MT_MAX][3];
#pragma unroll
  for (int slot = 0; slot < MT_MAX; ++slot)
#pragma unroll
    for (int kh = 0; kh < 3; ++kh)
      v[slot][kh] = off[slot][kh] >= 0 ? ldcg4(src + off[slot][kh])
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int slot = 0; slot < MT_MAX; ++slot) {
    if (slot >= mt) break;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh)
      reinterpret_cast<float4*>(tile_row(tile, kh, slot, e))[j] = v[slot][kh];
  }
}

// The weight gradient of one pass on the tensor cores: for each (row tile, n8 tile) pair
// the warp holds (pairs warp, warp + 12, ...; a row tile is 16 input channels of one tap,
// rows channels a tap, nt n8 tiles of output channels), acc += X(p + tap)^T G(p) over the
// pass's own pixels p, eight a k-step (lanes tq: pixels tq and tq + 4 of a half m-tile); a
// tap whose column falls off its row reads the zero row, as the conv does.
template <bool BF16, bool TF32>
__device__ __forceinline__ void wgrad_pass(const Args& a, const float* xt, const float* gt,
                                           const float* zrow, int rows, int nt, int m, int mt,
                                           int d, float (&acc)[WQ][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int cb = (rows + 15) >> 4, npairs = 9 * cb * nt;
  for (int slot = 0; slot < mt; ++slot) {
    const int mm = m + slot, n = mm / a.tps;
    const int p0 = (mm - n * a.tps) * MTILE;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ia = 8 * half + tq, ib = ia + 4;
      const int xa = (p0 + ia) % a.w, xb = (p0 + ib) % a.w;
      const float* ga = tile_row(gt, 1, slot, d + ia);
      const float* gb = tile_row(gt, 1, slot, d + ib);
#pragma unroll
      for (int q = 0; q < WQ; ++q) {
        const int pair = warp + q * NWARPS;
        if (pair >= npairs) break;
        const int rt = pair / nt, j = pair - rt * nt;
        const int tap = rt / cb, c0 = (rt - tap * cb) * 16;
        const int kh = tap / 3, dx = (tap % 3 - 1) * d;
        const float* ra = xa + dx >= 0 && xa + dx < a.w ? tile_row(xt, kh, slot, d + dx + ia) : zrow;
        const float* rb = xb + dx >= 0 && xb + dx < a.w ? tile_row(xt, kh, slot, d + dx + ib) : zrow;
        const int ci0 = c0 + gq, ci1 = ci0 + 8;
        uint32_t ah[4], al[4], bh[2], bl[2];
        split_op<BF16>(ci0 < rows ? ra[ci0] : 0.0f, ah[0], al[0]);
        split_op<BF16>(ci1 < rows ? ra[ci1] : 0.0f, ah[1], al[1]);
        split_op<BF16>(ci0 < rows ? rb[ci0] : 0.0f, ah[2], al[2]);
        split_op<BF16>(ci1 < rows ? rb[ci1] : 0.0f, ah[3], al[3]);
        split_op<BF16>(ga[8 * j + gq], bh[0], bl[0]);
        split_op<BF16>(gb[8 * j + gq], bh[1], bl[1]);
        if constexpr (!TF32 && !BF16) {
          mma_k8(acc[q], al, bh);
          mma_k8(acc[q], ah, bl);
        }
        mma_k8(acc[q], ah, bh);
      }
    }
  }
}

// wgrad_pass's accumulators into the block's slot dw of layer (tap, ci, co) at (tap rows +
// ci) ncols + co; every element is written once.
__device__ __forceinline__ void flush_wgrad(float* dw, const float (&acc)[WQ][4], int rows,
                                            int nt, int ncols) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int cb = (rows + 15) >> 4, npairs = 9 * cb * nt;
#pragma unroll
  for (int q = 0; q < WQ; ++q) {
    const int pair = warp + q * NWARPS;
    if (pair >= npairs) break;
    const int rt = pair / nt, j = pair - rt * nt;
    const int tap = rt / cb, c0 = (rt - tap * cb) * 16;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int ci = c0 + gq + 8 * r;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int co = 8 * j + 2 * tq + k;
        if (ci < rows && co < ncols) dw[(tap * rows + ci) * ncols + co] = acc[q][2 * r + k];
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
  double* vacc = dred + DRED_DOUBLES;  // the block's bias, gamma and beta gradients (vec's order)
  double* chan = vacc + VEC_PAD;       // a pass's [slot][channel][sum dz, sum dz x_hat]
  float* wbuf = reinterpret_cast<float*>(chan + CHAN_DOUBLES);
  float* gtile = wbuf + W0_FLOATS;
  float* xtile = gtile + TILE_FLOATS;
  float* zrow = xtile + TILE_FLOATS;
  float* red = zrow + ZERO_FLOATS;
  float* vec = red + BRED_FLOATS;
  float* stat = vec + VEC_PAD;   // [slot][mean 4, rstd 4]
  float* gsum = stat + MT_MAX * 8;  // [slot][a 4, b 4]
  float* tmp = gsum + MT_MAX * 8;
  const int tid = threadIdx.x, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int m_begin = blockIdx.x * a.mpb;
  const int m_end = min(a.M, m_begin + a.mpb);
  const int N = a.M / a.tps;
  const int64_t NPC = (int64_t)N * a.P * C;  // one map
  float* part = a.partial + (int64_t)blockIdx.x * a.kp;

  int count;
  const float* vec_g = layer_weights(a, LAYERS, &count);
  for (int i = tid; i < count; i += THREADS) vec[i] = __ldg(vec_g + i);
  for (int i = tid; i < VEC_PAD; i += THREADS) vacc[i] = 0.0;
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
    const int rows = s == 0 ? a.cin_pad : C;  // input channels a tap
    const int l = max(s - 1, 0);  // the GroupNorm this stage's epilogue serves (s >= 1)
    const float* dh_s = a.dh + (s & 1) * NPC;
    float* dh_l = a.dh + (l & 1) * NPC;
    const float* gamma_l = vec + 3 * C * l + C;
    const float* beta_l = gamma_l + C;
    float wacc[WQ][4];
#pragma unroll
    for (int q = 0; q < WQ; ++q)
#pragma unroll
      for (int k = 0; k < 4; ++k) wacc[q][k] = 0.0f;
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

    for (int m = m_begin; m < m_end; m += MT_MAX) {
      const int mt = min(MT_MAX, m_end - m);
      __syncthreads();  // the last pass's tiles and sums are read
      if (last) {
        stage_gout(a, m, mt, gtile);
      } else {
        bwd_pass_stats(a, s, m, mt, dred, tmp, stat, gsum, cur_n, reg);
        __syncthreads();
        stage_dt<T>(a, m, mt, d, gtile, stat, gsum, vec + 3 * C * s + C, vec + 3 * C * s + 2 * C,
                    dh_s, a.tbuf + s * NPC);
      }
      if (s == 0)
        stage_input<T>(a, m, mt, xtile);
      else
        stage_copy(a, m, mt, d, xtile, a.hbuf + l * NPC);
      __syncthreads();
      mbar_wait(&wbar[0], (LAYERS - 1 - s) & 1);
      if (last)
        conv_pass<WF_COLS, GROUPS, WF_COLS, BF16, TF32, true>(
            a, gtile, zrow, wbuf, WF_COLS, m, mt, 1, red, C,
            [&](int slot, int j, float (&v)[4]) { epi_dh(m, slot, j, v); });
      else if (s > 0)
        conv_pass<C, GROUPS, C, BF16, TF32, true>(
            a, gtile, zrow, wbuf, C, m, mt, d, red, C,
            [&](int slot, int j, float (&v)[4]) { epi_dh(m, slot, j, v); });
      else
        conv_pass<C, NJ_IN, C, BF16, TF32, true>(
            a, gtile, zrow, wbuf, C, m, mt, 1, red, a.cin_pad,
            [&](int slot, int j, float (&v)[4]) { epi_in(m, slot, j, v); });
      wgrad_pass<BF16, TF32>(a, xtile, gtile, zrow, rows, last ? 1 : GROUPS, m, mt, d, wacc);
      // The conv bias's gradient: the gradient tile summed over the pass's own pixels.
      if (tid < (last ? 1 : C)) {
        double sum = 0.0;
        for (int slot = 0; slot < mt; ++slot)
          for (int i = 0; i < MTILE; ++i) sum += (double)tile_row(gtile, 1, slot, d + i)[tid];
        vacc[(last ? 3 * C * NGN : 3 * C * s) + tid] += sum;
      }
      if (s > 0) {
        __syncthreads();  // chan is written
        if (tid < C)
          for (int slot = 0; slot < mt; ++slot) {
            vacc[3 * C * l + C + tid] += chan[(slot * C + tid) * 2 + 1];  // gamma
            vacc[3 * C * l + 2 * C + tid] += chan[(slot * C + tid) * 2];  // beta
          }
      }
    }
    flush_wgrad(part + grad_offset(a.cin_pad, s), wacc, rows, last ? 1 : GROUPS, last ? 1 : C);
    if (s > 0) grid_barrier(a.barrier);
  }
  for (int i = tid; i < VEC_FLOATS; i += THREADS)
    part[grad_offset(a.cin_pad, LAYERS) + i] = (float)vacc[i];
  grid_barrier(a.barrier);
  // The parameter gradients: the blocks' slots summed in block order.
  for (int e = blockIdx.x * THREADS + tid; e < a.kp; e += gridDim.x * THREADS) {
    float sum = 0.0f;
    for (int b = 0; b < (int)gridDim.x; ++b) sum += __ldcg(a.partial + (int64_t)b * a.kp + e);
    a.dparams[e] = sum;
  }
}

// ---- Launches ---------------------------------------------------------------------------

// Floats of scratch a forward launch for N samples of an h x w map needs: h and T, double-
// buffered (none where they are kept), then the f64 (sum, sum of squares) partials of every
// GroupNorm layer. The backward takes the same: dh double-buffered, then the partials.
long long needed_scratch(int N, int h, int w, bool maps) {
  const long long P = (long long)h * w, M = (long long)N * ((P + MTILE - 1) / MTILE);
  return (maps ? 4LL * N * P * C : 0LL) + 4LL * NGN * M * GROUPS;
}

// The blocks a cooperative launch of `kernel` (one a SM at most) may take on the current
// device, with its shared memory set; cached by the caller's `cache`, one entry a device.
template <typename K>
int resident_blocks(K kernel, size_t smem, int (&cache)[MAX_DEVICES], int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm * sms == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
    cache[dev] = per_sm * sms;
  }
  *blocks = cache[dev];
  return 0;
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
  int err = resident_blocks(refiner_kernel<T, TF32>, SMEM_BYTES, max_blocks, &blocks);
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
               const float* grad, float* dguid, float* didepth, float* dparams, float* partial,
               long long partial_floats, float* scratch, long long scratch_floats,
               unsigned int* barrier, int N, int cg, int h, int w, const int* dil,
               cudaStream_t stream) {
  static int max_blocks[MAX_DEVICES] = {0};
  if (N == 0 || h == 0 || w == 0) return 0;
  if (cg < 0 || cg + 1 > MAX_CIN0 || scratch_floats < needed_scratch(N, h, w, false) +
                                                          2LL * N * h * w * C)
    return (int)cudaErrorInvalidValue;
  int blocks = 0;
  int err = resident_blocks(refiner_bwd_kernel<T, TF32>, BWD_SMEM_BYTES, max_blocks, &blocks);
  if (err != 0) return err;
  BwdArgs a;
  const int grid = fill_args(a, guidance, idepth, wpack, barrier, N, cg, h, w, dil, blocks);
  if (grid < 0) return (int)cudaErrorInvalidValue;
  a.kp = grad_offset(a.cin_pad, LAYERS) + VEC_FLOATS;
  if (partial_floats < (long long)grid * a.kp) return (int)cudaErrorInvalidValue;
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
  a.partial = partial;
  a.dparams = dparams;
  void* args[] = {&a};
  cudaError_t status = cudaLaunchCooperativeKernel((const void*)refiner_bwd_kernel<T, TF32>,
                                                   dim3(grid), dim3(THREADS), args,
                                                   BWD_SMEM_BYTES, stream);
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

// The backward of the variant's forward, from its inputs (guidance, idepth, the same
// wpack), its output out and what it kept (keep_t, keep_h, keep_stats), and the output's
// gradient grad (N, h, w) f32. Writes dguid (N, cg, h, w) f32 where not null, didepth
// (N, h, w) f32 and dparams: the parameter gradients in the pack's order, conv0's taps
// (9, cin_pad, 32), the resblocks' (6, 9, 32, 32), the final conv's (9, 32), then the
// vector (673) in its order; partial: partial_floats f32, one slot of dparams' size a block
// (at most one block a multiprocessor); scratch: scratch_floats f32, 16-byte aligned, at
// least two maps (N, h, w, 32) and needed_scratch's partials. Same barrier, dil and returns
// as the forward.
#define MVS_REFINER_BWD(NAME, T, TF32)                                                      \
  extern "C" int NAME(const T* guidance, const float* idepth, const float* wpack,          \
                      const float* out, const float* keep_t, const float* keep_h,          \
                      const float* keep_stats, const float* grad, float* dguid,            \
                      float* didepth, float* dparams, float* partial,                      \
                      long long partial_floats, float* scratch, long long scratch_floats,  \
                      unsigned int* barrier, int N, int cg, int h, int w, const int* dil,  \
                      cudaStream_t stream) {                                               \
    return launch_bwd<T, TF32>(guidance, idepth, wpack, out, keep_t, keep_h, keep_stats,   \
                               grad, dguid, didepth, dparams, partial, partial_floats,     \
                               scratch, scratch_floats, barrier, N, cg, h, w, dil, stream); \
  }
MVS_REFINER_BWD(mvs_idepthmap_refiner_bwd_f32, float, false)
MVS_REFINER_BWD(mvs_idepthmap_refiner_bwd_tf32, float, true)
MVS_REFINER_BWD(mvs_idepthmap_refiner_bwd_bf16, __nv_bfloat16, false)
