// The whole IDepthmapRefiner of a small pyramid level as one kernel (Hopper, sm_90a).
//
// Replaces the TPU kernel
//   multi_view_stereonet_tpu/ops/pallas/refiner_kernel.py, idepthmap_refiner_fused
//   (_fused_impl -> _refiner_kernel),
// whose semantics are models/refiners.py idepthmap_refiner. For each sample:
//   h   = LeakyReLU(GN0(conv0([guidance, idepth]) + b0))               (Cg + 1 -> 32)
//   h   = h + LeakyReLU(GN_k(conv_k(h, dilation d_k) + b_k)), k = 0..5  (32 -> 32)
//   out = ReLU(idepth + conv_final(h) + bf)                             (32 -> 1)
// All convs are 3x3 with zero padding of width dilation; GroupNorm has 4 groups of 8
// channels, eps 1e-5, statistics over the h x w valid outputs only. The TPU kernel's
// padded s2d grid and border mask are the same rule: here a tap outside the map reads 0.
//
// What bounds it on this card: fp32 FMA throughput spread over enough SMs, and the
// whole-map dependence of each GroupNorm. A 32 -> 32 conv at 60 x 80 is 44 M multiply-adds
// per sample, ~0.27 G for the refiner; one block per sample (the TPU's grid over samples,
// and K2's design) would leave 131 SMs idle and run slower than the plain path. So each
// sample is cut into tiles of 64 pixels, one tile per block at a time (a grid-stride loop
// over (sample, tile) units), and the stages are separated by a grid-wide barrier:
//   conv stage:  load the layer's weights (<= 41.5 KB, [tap][ci][oc]) into shared memory;
//                each thread computes 8 output channels (one GroupNorm group) of one pixel,
//                reading the input through L1/L2 as float4s, writes the raw conv output T
//                and one (sum, sum of squares) f64 partial per (unit, group);  barrier;
//   apply stage: each block reduces its sample's partials in a fixed order (the same
//                mean and rstd in every block and every run; no atomics), then updates its
//                own pixels h = [h +] LeakyReLU(GN(T)) in place;  barrier.
// h and T (N x h x w x 32 f32 each, 614 KB a sample at 60 x 80) live in global scratch and
// stay in the 50 MB L2. What one block reads of another's writes (h at the conv taps, the
// partials) is loaded with __ldcg, from L2, never from a stale L1 line. The launch is
// cooperative (cudaLaunchCooperativeKernel), so all blocks are resident and the
// hand-rolled barrier below cannot deadlock; the grid is sized once per device from the
// occupancy calculator.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 32;                 // hidden channels
constexpr int GROUPS = 4;
constexpr int GSIZE = C / GROUPS;     // 8 channels per group, one thread's outputs
constexpr int TILE = 64;              // pixels per unit
constexpr int THREADS = TILE * GROUPS;
constexpr int WARPS = THREADS / 32;
constexpr int NRES = 6;
constexpr int MAX_CIN0 = 36;          // conv0 input channels: 35 guidance + idepth
constexpr int SMEM_BYTES = 9 * MAX_CIN0 * C * (int)sizeof(float);
constexpr int MAX_DEVICES = 64;
constexpr float EPS = 1e-5f;
constexpr float SLOPE = 0.2f;

struct Args {
  const float* guidance;  // (N, cin0 - 1, h, w)
  const float* idepth;    // (N, h, w)
  const float* w0;        // (9, cin0, 32)
  const float* wr;        // (6, 9, 32, 32)
  const float* wf;        // (9, 32)
  const float* vec;       // 7 x (bias, gamma, beta) x 32, then bf
  float* out;             // (N, h, w)
  float* hbuf;            // (N, h * w, 32)
  float* tbuf;            // (N, h * w, 32)
  double2* partials;      // (N * units_per_sample, 4)
  unsigned int* barrier;  // one counter, 0 at launch
  int n, cin0, h, w, units_per_sample;
  int dil[NRES];
};

__device__ __forceinline__ float leaky(float v) { return v >= 0.0f ? v : SLOPE * v; }

// All blocks of the grid arrive before any leaves. Block 0 adds 2^31 - (nblocks - 1) and
// every other block 1, so the top bit of the counter flips exactly when the last block
// arrives, and the counter is ready for the next barrier without a reset. The fences make
// every write before the barrier visible to every read after it.
__device__ __forceinline__ void grid_barrier(unsigned int* counter) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned int old = atomicAdd(counter, add);
    while (((old ^ *(volatile unsigned int*)counter) & 0x80000000u) == 0) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ void load_weights(float* dst, const float* __restrict__ src,
                                             int count) {
  __syncthreads();
  for (int i = threadIdx.x; i < count; i += THREADS) dst[i] = src[i];
  __syncthreads();
}

// acc[j] += v * wrow[j], j = 0..7; wrow is 32-byte aligned in shared memory.
__device__ __forceinline__ void fma8(float v, const float* wrow, float (&acc)[GSIZE]) {
  const float4 a = reinterpret_cast<const float4*>(wrow)[0];
  const float4 b = reinterpret_cast<const float4*>(wrow)[1];
  acc[0] = fmaf(v, a.x, acc[0]);
  acc[1] = fmaf(v, a.y, acc[1]);
  acc[2] = fmaf(v, a.z, acc[2]);
  acc[3] = fmaf(v, a.w, acc[3]);
  acc[4] = fmaf(v, b.x, acc[4]);
  acc[5] = fmaf(v, b.y, acc[5]);
  acc[6] = fmaf(v, b.z, acc[6]);
  acc[7] = fmaf(v, b.w, acc[7]);
}

// The (sum, sum of squares) of each group over the block's 64 pixels -> dst[0..3].
// Thread t holds group t % 4; lanes of one group differ in bits 2..4.
__device__ __forceinline__ void block_partials(double s, double ss, double2* dst) {
  __shared__ double red[WARPS][GROUPS][2];
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  if (lane < GROUPS) {
    red[warp][lane][0] = s;
    red[warp][lane][1] = ss;
  }
  __syncthreads();
  if (threadIdx.x < GROUPS) {
    double S = 0.0, SS = 0.0;
    for (int w = 0; w < WARPS; ++w) {
      S += red[w][threadIdx.x][0];
      SS += red[w][threadIdx.x][1];
    }
    dst[threadIdx.x] = make_double2(S, SS);
  }
  __syncthreads();
}

// Conv stage: T = conv(input) + bias for every unit, with its GroupNorm partials. Layer 0
// reads [guidance, idepth] (NCHW planes); the resblocks read h (pixel-major, 32 channels).
template <bool FIRST>
__device__ void conv_stage(const Args& a, const float* wsm, const float* bias, int dil) {
  const int P = a.h * a.w;
  const int units = a.n * a.units_per_sample;
  const int g = threadIdx.x % GROUPS;
  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int n = unit / a.units_per_sample;
    const int p = (unit % a.units_per_sample) * TILE + threadIdx.x / GROUPS;
    double s = 0.0, ss = 0.0;
    if (p < P) {
      const int y = p / a.w, x = p % a.w;
      float acc[GSIZE];
#pragma unroll
      for (int j = 0; j < GSIZE; ++j) acc[j] = 0.0f;
      for (int kh = 0; kh < 3; ++kh) {
        const int yy = y + (kh - 1) * dil;
        if (yy < 0 || yy >= a.h) continue;
        for (int kw = 0; kw < 3; ++kw) {
          const int xx = x + (kw - 1) * dil;
          if (xx < 0 || xx >= a.w) continue;
          const int q = yy * a.w + xx;
          const int tap = kh * 3 + kw;
          if constexpr (FIRST) {
            const int cg = a.cin0 - 1;
            const float* wt = wsm + tap * a.cin0 * C + g * GSIZE;
            const float* src = a.guidance + (int64_t)n * cg * P + q;
            for (int ci = 0; ci < cg; ++ci) fma8(src[(int64_t)ci * P], wt + ci * C, acc);
            fma8(a.idepth[(int64_t)n * P + q], wt + cg * C, acc);
          } else {
            const float4* src = reinterpret_cast<const float4*>(a.hbuf + ((int64_t)n * P + q) * C);
            const float* wt = wsm + tap * C * C + g * GSIZE;
#pragma unroll
            for (int c4 = 0; c4 < C / 4; ++c4) {
              const float4 v = __ldcg(src + c4);
              fma8(v.x, wt + (4 * c4 + 0) * C, acc);
              fma8(v.y, wt + (4 * c4 + 1) * C, acc);
              fma8(v.z, wt + (4 * c4 + 2) * C, acc);
              fma8(v.w, wt + (4 * c4 + 3) * C, acc);
            }
          }
        }
      }
      float* dst = a.tbuf + ((int64_t)n * P + p) * C + g * GSIZE;
#pragma unroll
      for (int j = 0; j < GSIZE; ++j) {
        const float v = acc[j] + bias[g * GSIZE + j];
        acc[j] = v;
        s += (double)v;
        ss += (double)v * (double)v;
      }
      reinterpret_cast<float4*>(dst)[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
    block_partials(s, ss, a.partials + (int64_t)unit * GROUPS);
  }
}

// Apply stage: h = [h +] LeakyReLU((T - mean) * rstd * gamma + beta) for every unit.
template <bool RESIDUAL>
__device__ void apply_stage(const Args& a, const float* __restrict__ gamma,
                            const float* __restrict__ beta) {
  __shared__ float stat[GROUPS][2];
  const int P = a.h * a.w;
  const int units = a.n * a.units_per_sample;
  const int g = threadIdx.x % GROUPS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int n = unit / a.units_per_sample;
    if (warp < GROUPS) {
      const double2* part = a.partials + (int64_t)n * a.units_per_sample * GROUPS + warp;
      double S = 0.0, SS = 0.0;
      for (int t = lane; t < a.units_per_sample; t += 32) {
        const double2 v = __ldcg(part + (int64_t)t * GROUPS);
        S += v.x;
        SS += v.y;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        S += __shfl_xor_sync(0xffffffffu, S, off);
        SS += __shfl_xor_sync(0xffffffffu, SS, off);
      }
      if (lane == 0) {
        const double cnt = (double)P * GSIZE;
        const double mean = S / cnt;
        const double var = fmax(SS / cnt - mean * mean, 0.0);
        stat[warp][0] = (float)mean;
        stat[warp][1] = (float)(1.0 / sqrt(var + (double)EPS));
      }
    }
    __syncthreads();
    const int p = (unit % a.units_per_sample) * TILE + threadIdx.x / GROUPS;
    if (p < P) {
      const float mu = stat[g][0], rs = stat[g][1];
      const int64_t off = ((int64_t)n * P + p) * C + g * GSIZE;
      float4* hp = reinterpret_cast<float4*>(a.hbuf + off);
      const float4* tp = reinterpret_cast<const float4*>(a.tbuf + off);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float4 t = tp[k];
        const int c = g * GSIZE + 4 * k;
        float4 v = make_float4(leaky((t.x - mu) * rs * gamma[c + 0] + beta[c + 0]),
                               leaky((t.y - mu) * rs * gamma[c + 1] + beta[c + 1]),
                               leaky((t.z - mu) * rs * gamma[c + 2] + beta[c + 2]),
                               leaky((t.w - mu) * rs * gamma[c + 3] + beta[c + 3]));
        if constexpr (RESIDUAL) {
          const float4 r = hp[k];
          v = make_float4(r.x + v.x, r.y + v.y, r.z + v.z, r.w + v.w);
        }
        hp[k] = v;
      }
    }
    __syncthreads();
  }
}

// out = ReLU(idepth + conv_final(h) + bf): the 4 threads of a pixel take 8 input channels
// each and are summed in a fixed order.
__device__ void final_stage(const Args& a, const float* wsm, float bf) {
  const int P = a.h * a.w;
  const int units = a.n * a.units_per_sample;
  const int g = threadIdx.x % GROUPS;
  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int n = unit / a.units_per_sample;
    const int p = (unit % a.units_per_sample) * TILE + threadIdx.x / GROUPS;
    float acc = 0.0f;
    if (p < P) {
      const int y = p / a.w, x = p % a.w;
      for (int kh = 0; kh < 3; ++kh) {
        const int yy = y + kh - 1;
        if (yy < 0 || yy >= a.h) continue;
        for (int kw = 0; kw < 3; ++kw) {
          const int xx = x + kw - 1;
          if (xx < 0 || xx >= a.w) continue;
          const float4* src = reinterpret_cast<const float4*>(
              a.hbuf + ((int64_t)n * P + yy * a.w + xx) * C + g * GSIZE);
          const float* wt = wsm + (kh * 3 + kw) * C + g * GSIZE;
          const float4 u = __ldcg(src), v = __ldcg(src + 1);
          acc = fmaf(u.x, wt[0], acc);
          acc = fmaf(u.y, wt[1], acc);
          acc = fmaf(u.z, wt[2], acc);
          acc = fmaf(u.w, wt[3], acc);
          acc = fmaf(v.x, wt[4], acc);
          acc = fmaf(v.y, wt[5], acc);
          acc = fmaf(v.z, wt[6], acc);
          acc = fmaf(v.w, wt[7], acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (p < P && g == 0) {
      const int64_t i = (int64_t)n * P + p;
      a.out[i] = fmaxf(a.idepth[i] + (acc + bf), 0.0f);
    }
  }
}

__global__ void __launch_bounds__(THREADS) refiner_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* wsm = reinterpret_cast<float*>(smem4);
  const float* vec = a.vec;  // layer l: bias vec[96 l], gamma vec[96 l + 32], beta + 64

  load_weights(wsm, a.w0, 9 * a.cin0 * C);
  conv_stage<true>(a, wsm, vec, 1);
  grid_barrier(a.barrier);
  apply_stage<false>(a, vec + C, vec + 2 * C);
  grid_barrier(a.barrier);
  for (int k = 0; k < NRES; ++k) {
    const float* v = vec + 3 * C * (k + 1);
    load_weights(wsm, a.wr + (int64_t)k * 9 * C * C, 9 * C * C);
    conv_stage<false>(a, wsm, v, a.dil[k]);
    grid_barrier(a.barrier);
    apply_stage<true>(a, v + C, v + 2 * C);
    grid_barrier(a.barrier);
  }
  load_weights(wsm, a.wf, 9 * C);
  final_stage(a, wsm, vec[3 * C * (NRES + 1)]);
}

int max_blocks[MAX_DEVICES] = {0};

}  // namespace

// guidance (N, cin0 - 1, h, w), idepth (N, h, w): f32, contiguous, cin0 <= 36.
// w0 (9, cin0, 32), wr (6, 9, 32, 32), wf (9, 32): tap-major [kh*3+kw][ci][oc].
// vec: 7 x (conv bias, GN gamma, GN beta) x 32 for conv0 and res0..5, then bf (673 floats).
// out (N, h, w); scratch (2, N, h*w, 32) f32; partials (units, 4) of (sum, sum of squares)
// f64, where units must be N * ceil(h*w / 64); barrier: one uint32, zero. dil: the six
// resblock dilations (host array). Returns a cudaError_t code:
// cudaErrorCooperativeLaunchTooLarge if the grid cannot be resident.
extern "C" int mvs_idepthmap_refiner_f32(const float* guidance, const float* idepth,
                                         const float* w0, const float* wr, const float* wf,
                                         const float* vec, float* out, float* scratch,
                                         double* partials, int units,
                                         unsigned int* barrier, int N, int cin0, int h,
                                         int w, const int* dil, cudaStream_t stream) {
  if (N == 0 || h == 0 || w == 0) return 0;
  const int P = h * w;
  if (cin0 < 1 || cin0 > MAX_CIN0 || units != N * ((P + TILE - 1) / TILE))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (max_blocks[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, refiner_kernel, THREADS,
                                                        SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    max_blocks[dev] = per_sm * sms;
  }
  Args a;
  a.guidance = guidance;
  a.idepth = idepth;
  a.w0 = w0;
  a.wr = wr;
  a.wf = wf;
  a.vec = vec;
  a.out = out;
  a.hbuf = scratch;
  a.tbuf = scratch + (int64_t)N * P * C;
  a.partials = reinterpret_cast<double2*>(partials);
  a.barrier = barrier;
  a.n = N;
  a.cin0 = cin0;
  a.h = h;
  a.w = w;
  a.units_per_sample = (P + TILE - 1) / TILE;
  for (int k = 0; k < NRES; ++k) a.dil[k] = dil[k];
  const int grid = units < max_blocks[dev] ? units : max_blocks[dev];
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)refiner_kernel, dim3(grid), dim3(THREADS),
                                    args, SMEM_BYTES, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
