// The weight-gradient pass of the backward kernels of K2 (incremental_chain.cu) and K3
// (idepthmap_refiner.cu), Hopper (sm_90a).
//
// Replaces no TPU kernel: it is half of the backward that the JAX package takes as the
// VJP of its scan (K2) and of idepthmap_refiner_s2d (K3). Each backward runs as two
// launches. The sequential part (a cluster a sample for K2, a cooperative grid for K3)
// walks the chain of dependent stages and keeps each conv's output gradient G in a map;
// this pass then computes every conv's weight gradient dW[tap][ci][co] = sum over the
// pixels p of X(p + tap's offset)[ci] G(p)[co], X the conv's input, and its bias gradient
// sum_p G(p)[co], over every step or layer at once. The products do not depend on one
// another, so they leave the latency-bound chain for one all-SM pass.
//
// What bounds it: the tensor-core rate (K3 at (8, 35, 60, 80): 2.6 G multiply-adds, three
// TF32 products each in 3xTF32) and the reads of X and G (each once, the three kernel rows
// of X from L2).
//
// Design: a cooperative grid of one or two 288-thread blocks an SM (the kernel's
// WGRAD_MIN_BLOCKS). The pixels of a conv are cut into stages of KB = 64 consecutive
// pixels of one plane (a sample, or a sample's hypothesis step), and each conv's stages
// into equal contiguous runs, one a block, the blocks given to the convs in proportion to
// their products. A stage stages G (KB x the output channels) and X as three runs, one a
// kernel row, of the KB + 2d consecutive map positions its taps read (zero outside the
// map), 40 floats a position so that the fragment loads fall on distinct banks, into one
// of two shared-memory buffers: a ring fed by asynchronous copies (cp.async, zero-filled
// outside the map) one stage ahead of the products, so that the next stage's loads fly
// while this one's mma.sync run. What a copy cannot make (K2's X, made on load from raw
// maps and a warp; K3's conv0 input, from the NCHW guidance) the caller stages once the
// stage's copies have landed; two resident blocks overlap it with the other's products.
// G is then split (or rounded) once for all nine warps, its channels permuted so that a
// lane's four n8 tiles come in one 16-byte load. Warp t computes tap t: rows (input
// channel) x columns (output channel) over the stage's pixels on mma.sync m16n8k8 (TF32
// in, f32 accumulate), a tap whose column falls off its row reading 0, its accumulators in
// registers over the block's run. Each operand is rounded as the variant's convs round it:
// 3xTF32 splits it into a TF32 high part and the rest (three products), 1xTF32 takes the
// high part, bf16 rounds it to bf16 (exact in TF32, one product). The bias sums add the
// unrounded G in f64. Each block writes its sums to a slot of its own; after one grid
// barrier the grid sums every element's slots in block order: no float atomics, the same
// bits from run to run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_sync.cuh"  // grid_barrier

namespace wgrad {

constexpr int THREADS = 288;             // nine warps: warp t takes tap t
constexpr int NWARPS = THREADS / 32;
constexpr int KB = 64;                   // pixels a stage
constexpr int MAX_DIL = 8;
constexpr int RUN = KB + 2 * MAX_DIL;    // staged positions a kernel row
constexpr int XS = 40;                   // floats a staged X position (36 channels used)
constexpr int GS = 40;                   // floats a staged G position (32 used)
constexpr int X_FLOATS = 3 * RUN * XS;
constexpr int G_FLOATS = KB * GS;
constexpr int TILE_FLOATS = X_FLOATS + G_FLOATS;  // one buffer of the ring
constexpr int MAX_ROWS = 48;             // rows a tap: three m16 tiles (36 channels)
constexpr int SLOT_FLOATS = 9 * MAX_ROWS * 32 + 32;  // a block's sums: weights, then bias
// The bias sums' scratch, the ring's two buffers, then the low parts of the stage's G.
constexpr size_t SMEM_BYTES =
    sizeof(double) * THREADS + sizeof(float) * (2 * TILE_FLOATS + G_FLOATS);
constexpr int GVALS = (KB * 32 + THREADS - 1) / THREADS;  // G values a thread splits
static_assert(THREADS == 9 * 32, "a warp a tap");

__device__ __forceinline__ float4 ldcg4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

// d += a b, m16n8k8, TF32 in, f32 accumulate.
__device__ __forceinline__ void mma_k8(float (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An operand as the TF32 mma's (hi, lo): hi is x rounded to TF32 on its integer bits (10
// mantissa bits, half away from zero), lo = x - hi exactly; at bf16 x is rounded to bf16
// first, which TF32 holds exactly (lo = 0).
template <bool BF16>
__device__ __forceinline__ void split_op(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (BF16) x = __bfloat162float(__float2bfloat16_rn(x));
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// 16 bytes (4: cp_async4) from global src to shared dst by the copy engine, no registers
// held; zeros where !valid (src is then not read). A group of copies is committed with
// cp_async_commit, and cp_async_wait<k> waits until at most k groups are in flight.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}

// One conv's share of a block: stage items [begin, end) (item i: plane i / spp, pixels
// (i % spp) KB ..), dilation d, `rows` staged input channels (at most 16 MT), gc output
// channels (at most 8 NT; 1: K3's final conv). The tiles of an item: xs [kh][e][XS], e the
// run position of kernel row kh, map position p0 - d + e + (kh - 1) d w; gs [i][GS] for
// pixel p0 + i (0 past the map). Two buffers of tiles at `tiles` (TILE_FLOATS each) form a
// ring: issue(item, xs, gs) starts the asynchronous copies of an item's tiles (cp_async16,
// cp_async4), one item ahead of the products, and finish(item, xs, gs), called once the
// copies have landed, makes on load what a copy cannot (every thread calls both; finish
// returns whether it wrote the tiles). Then G is split once for every warp: its high parts
// in place, its low parts (3xTF32) to glo, each position's channels permuted (channel c to
// slot 4 (c % 8) + c / 8) so that a lane's four n8 tiles come in one 16-byte load. Writes
// the block's sums into slot: [tap][row][col] (16 MT rows, 8 NT columns), then the gc bias
// sums at 9 * 16 MT * 8 NT. Every thread calls it.
template <int MT, int NT, bool BF16, bool TF32, typename Issue, typename Finish>
__device__ void conv_wgrad(int begin, int end, int spp, int d, int rows, int gc, int w,
                           float* tiles, float* glo, double* dsum, float* slot, Issue&& issue,
                           Finish&& finish) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int kh = warp / 3, dx = (warp % 3 - 1) * d;
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.0f;
  double bacc = 0.0;  // the bias sum of column lane over pixels warp, warp + 9, ...
  if (begin < end) issue(begin, tiles, tiles + X_FLOATS);
  cp_async_commit();
  for (int item = begin, buf = 0; item < end; ++item, buf ^= 1) {
    float* xs = tiles + buf * TILE_FLOATS;
    float* gs = xs + X_FLOATS;
    if (item + 1 < end) {
      float* next = tiles + (buf ^ 1) * TILE_FLOATS;
      issue(item + 1, next, next + X_FLOATS);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this item's copies have landed (the next item's may fly)
    __syncthreads();
    if (finish(item, xs, gs)) __syncthreads();
    for (int i = warp; i < KB; i += NWARPS) bacc += (double)gs[i * GS + lane];
    float gv[GVALS];
#pragma unroll
    for (int k = 0; k < GVALS; ++k) {
      const int i = tid + k * THREADS;
      gv[k] = i < KB * 32 && (i & 31) < gc ? gs[(i >> 5) * GS + (i & 31)] : 0.0f;
    }
    __syncthreads();  // G read whole before it is rewritten
#pragma unroll
    for (int k = 0; k < GVALS; ++k) {
      const int i = tid + k * THREADS, c = i & 31, at = (i >> 5) * GS + 4 * (c & 7) + (c >> 3);
      if (i < KB * 32) {
        uint32_t hi, lo;
        split_op<BF16>(gv[k], hi, lo);
        gs[at] = __uint_as_float(hi);
        if constexpr (!TF32 && !BF16) glo[at] = __uint_as_float(lo);
      }
    }
    __syncthreads();
    // The columns of this lane's pixels p0 + tq and p0 + tq + 4, stepped by 8 a k-step.
    int xa = ((item % spp) * KB + tq) % w, xb = xa + 4;
    while (xb >= w) xb -= w;
    const float* xrow = xs + kh * RUN * XS;
#pragma unroll 1
    for (int s8 = 0; s8 < KB / 8; ++s8) {
      const int ia = 8 * s8 + tq, ib = ia + 4;
      const bool va = xa + dx >= 0 && xa + dx < w, vb = xb + dx >= 0 && xb + dx < w;
      const float* ra = xrow + (d + dx + ia) * XS;
      const float* rb = xrow + (d + dx + ib) * XS;
      uint32_t bh[NT][2], bl[NT][2];
      {  // output channels 8 j + gq, j = 0 .. 3, of pixels ia and ib
        const uint4 ha = *reinterpret_cast<const uint4*>(gs + ia * GS + 4 * gq);
        const uint4 hb = *reinterpret_cast<const uint4*>(gs + ib * GS + 4 * gq);
        const uint32_t h0[4] = {ha.x, ha.y, ha.z, ha.w}, h1[4] = {hb.x, hb.y, hb.z, hb.w};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          bh[j][0] = h0[j];
          bh[j][1] = h1[j];
        }
        if constexpr (!TF32 && !BF16) {
          const uint4 la = *reinterpret_cast<const uint4*>(glo + ia * GS + 4 * gq);
          const uint4 lb = *reinterpret_cast<const uint4*>(glo + ib * GS + 4 * gq);
          const uint32_t l0[4] = {la.x, la.y, la.z, la.w}, l1[4] = {lb.x, lb.y, lb.z, lb.w};
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            bl[j][0] = l0[j];
            bl[j][1] = l1[j];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int c0 = 16 * i + gq, c1 = c0 + 8;
        uint32_t ah[4], al[4];
        split_op<BF16>(va && c0 < rows ? ra[c0] : 0.0f, ah[0], al[0]);
        split_op<BF16>(va && c1 < rows ? ra[c1] : 0.0f, ah[1], al[1]);
        split_op<BF16>(vb && c0 < rows ? rb[c0] : 0.0f, ah[2], al[2]);
        split_op<BF16>(vb && c1 < rows ? rb[c1] : 0.0f, ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if constexpr (!TF32 && !BF16) {
            mma_k8(acc[i][j], al, bh[j]);
            mma_k8(acc[i][j], ah, bl[j]);
          }
          mma_k8(acc[i][j], ah, bh[j]);
        }
      }
      xa += 8;
      xb += 8;
      while (xa >= w) xa -= w;
      while (xb >= w) xb -= w;
    }
    __syncthreads();  // this buffer is read before the ring refills it
  }
  cp_async_wait<0>();
  constexpr int R = 16 * MT, NC = 8 * NT;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float* o = slot + (warp * R + 16 * i + gq + 8 * r) * NC + 8 * j + 2 * tq;
        o[0] = acc[i][j][2 * r];
        o[1] = acc[i][j][2 * r + 1];
      }
  dsum[tid] = bacc;
  __syncthreads();
  if (tid < gc) {  // the nine warps' sums of column tid, in warp order
    double s = 0.0;
    for (int k = 0; k < NWARPS; ++k) s += dsum[k * 32 + tid];
    slot[9 * R * NC + tid] = (float)s;
  }
}

// The sum over nb consecutive slots (stride floats apart) of the element at src, in
// slot order.
__device__ __forceinline__ float sum_slots(const float* src, int nb, int64_t stride) {
  float s = 0.0f;
  for (int b = 0; b < nb; ++b) s += __ldcg(src + (int64_t)b * stride);
  return s;
}

// Blocks given to each of `convs` convs in proportion to its weight (at least one each),
// in order: start[c] .. start[c + 1] - 1 are conv c's; start[convs] = blocks.
inline void split_blocks(int blocks, int convs, const double* weight, int* start) {
  double total = 0.0;
  for (int c = 0; c < convs; ++c) total += weight[c];
  int given = 0;
  start[0] = 0;
  for (int c = 0; c < convs; ++c) {
    const int left = blocks - given - (convs - 1 - c);  // one at least for each after
    int nb = c == convs - 1 ? left : (int)(blocks * weight[c] / total);
    nb = nb < 1 ? 1 : (nb > left ? left : nb);
    given += nb;
    start[c + 1] = given;
  }
}

}  // namespace wgrad
