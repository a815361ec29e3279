// Fused incremental feature chain (Hopper, sm_90a).
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
// What bounds it on this card: latency and fp32 throughput of one SM per sample. The map is
// 30 x 40 x 32 at the eval shape; a step is ~35 M multiply-adds (three 3x3 convs), and
// every stage needs the previous one complete over the whole map (GroupNorm statistics,
// conv halos). As a loop of PyTorch ops each step is ~20 tiny launches; here one block per
// sample runs all D-1 steps, stages separated by __syncthreads(), so the chain costs one
// launch instead of a launch storm. The sequential hypothesis axis, which on the TPU was
// a sequential grid axis with the carry in VMEM, is a loop inside the block.
//
// Design: one thread per pixel (two passes at 1200 pixels), 32 output channels in
// registers. The three conv weight sets (9 x 35 x 32 + 2 x 9 x 32 x 32 floats, 114 KB)
// live in dynamic shared memory for the whole chain and are read as broadcast float4s;
// the carry and the two stage buffers (3 x 153.6 KB per sample) live in global scratch
// that stays resident in L2, read through L1. With N = B*V <= 5 blocks most SMs idle;
// splitting a sample over a thread-block cluster is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 32;          // feature channels
constexpr int CIMG = 3;        // guidance image channels
constexpr int C0 = CIMG + C;   // conv0 input channels
constexpr int GROUPS = 4;
constexpr int GSIZE = C / GROUPS;
constexpr int MAX_THREADS = 640;
constexpr float EPS = 1e-5f;
constexpr float SLOPE = 0.2f;

__device__ __forceinline__ float leaky(float v) { return v >= 0.0f ? v : SLOPE * v; }

__device__ __forceinline__ void fma_row(float v, const float* w, float (&acc)[C]) {
#pragma unroll
  for (int j = 0; j < C / 4; ++j) {
    const float4 ww = reinterpret_cast<const float4*>(w)[j];
    acc[4 * j + 0] = fmaf(v, ww.x, acc[4 * j + 0]);
    acc[4 * j + 1] = fmaf(v, ww.y, acc[4 * j + 1]);
    acc[4 * j + 2] = fmaf(v, ww.z, acc[4 * j + 2]);
    acc[4 * j + 3] = fmaf(v, ww.w, acc[4 * j + 3]);
  }
}

// acc[oc] += sum over 3x3 taps and CIN channels of in[q, ci] * w[tap, ci_base + ci, oc],
// for the pixel (y, x); taps outside the map read zero. ``in`` holds CIN channels per
// pixel; w is tap-major with cin_total rows of C weights per tap.
template <int CIN>
__device__ __forceinline__ void conv3x3(const float* in, const float* w, int cin_total,
                                        int ci_base, int y, int x, int h, int wd,
                                        float (&acc)[C]) {
#pragma unroll 1
  for (int kh = 0; kh < 3; ++kh) {
    const int yy = y + kh - 1;
    if (yy < 0 || yy >= h) continue;
#pragma unroll 1
    for (int kw = 0; kw < 3; ++kw) {
      const int xx = x + kw - 1;
      if (xx < 0 || xx >= wd) continue;
      const float* src = in + (yy * wd + xx) * CIN;
      const float* wt = w + ((kh * 3 + kw) * cin_total + ci_base) * C;
      if constexpr (CIN % 4 == 0) {
#pragma unroll
        for (int c4 = 0; c4 < CIN / 4; ++c4) {
          const float4 v = reinterpret_cast<const float4*>(src)[c4];
          fma_row(v.x, wt + (4 * c4 + 0) * C, acc);
          fma_row(v.y, wt + (4 * c4 + 1) * C, acc);
          fma_row(v.z, wt + (4 * c4 + 2) * C, acc);
          fma_row(v.w, wt + (4 * c4 + 3) * C, acc);
        }
      } else {
#pragma unroll
        for (int c = 0; c < CIN; ++c) fma_row(src[c], wt + c * C, acc);
      }
    }
  }
}

// Sum the per-thread group moments over the block; writes mean and rstd per group
// into stat[0..3] and stat[4..7]. Every thread of the block must call it.
__device__ __forceinline__ void group_stats(float (&s)[GROUPS], float (&ss)[GROUPS],
                                            float* red, float* stat, int npix) {
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
      ss[g] += __shfl_xor_sync(0xffffffffu, ss[g], off);
    }
  }
  const int warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      red[warp * 2 * GROUPS + g] = s[g];
      red[warp * 2 * GROUPS + GROUPS + g] = ss[g];
    }
  }
  __syncthreads();
  if (threadIdx.x < GROUPS) {
    const int g = threadIdx.x;
    float sum = 0.0f, sumsq = 0.0f;
    for (int i = 0; i < nwarps; ++i) {
      sum += red[i * 2 * GROUPS + g];
      sumsq += red[i * 2 * GROUPS + GROUPS + g];
    }
    const float n = (float)npix * GSIZE;
    const float mu = sum / n;
    const float var = fmaxf(sumsq / n - mu * mu, 0.0f);
    stat[g] = mu;
    stat[GROUPS + g] = 1.0f / sqrtf(var + EPS);
  }
  __syncthreads();
}

__device__ __forceinline__ void add_moments(const float (&acc)[C], float (&s)[GROUPS],
                                            float (&ss)[GROUPS]) {
#pragma unroll
  for (int oc = 0; oc < C; ++oc) {
    s[oc / GSIZE] += acc[oc];
    ss[oc / GSIZE] += acc[oc] * acc[oc];
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
chain_kernel(const float* __restrict__ feats0, const float* __restrict__ image,
             const float* __restrict__ H_inc, const float* __restrict__ w0_g,
             const float* __restrict__ wr_g, const float* __restrict__ wf_g,
             const float* __restrict__ vec_g, float* out, float* scratch, int Dm1,
             int h, int wd) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* w0 = smem;                    // 9 * C0 * C
  float* wr = w0 + 9 * C0 * C;         // 9 * C * C
  float* wf = wr + 9 * C * C;          // 9 * C * C
  float* vec = wf + 9 * C * C;         // b0, g0, be0, br, gr, ber, bf: 7 * C
  float* red = vec + 7 * C;            // per-warp partial moments
  float* stat = red + (MAX_THREADS / 32) * 2 * GROUPS;  // mean[4], rstd[4]
  const float* b0 = vec;
  const float* g0 = vec + C;
  const float* be0 = vec + 2 * C;
  const float* br = vec + 3 * C;
  const float* gr = vec + 4 * C;
  const float* ber = vec + 5 * C;
  const float* bf = vec + 6 * C;

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int P = h * wd;
  const int D = Dm1 + 1;

  for (int i = tid; i < 9 * C0 * C; i += T) w0[i] = w0_g[i];
  for (int i = tid; i < 9 * C * C; i += T) wr[i] = wr_g[i];
  for (int i = tid; i < 9 * C * C; i += T) wf[i] = wf_g[i];
  for (int i = tid; i < 7 * C; i += T) vec[i] = vec_g[i];

  float* out_n = out + (int64_t)n * D * P * C;
  float* warped = scratch + (int64_t)n * 3 * P * C;
  float* bufA = warped + P * C;
  float* bufB = bufA + P * C;
  const float* f0 = feats0 + (int64_t)n * P * C;
  for (int i = tid; i < P * C; i += T) out_n[i] = f0[i];
  __syncthreads();

  for (int d = 0; d < Dm1; ++d) {
    const float* carry = out_n + (int64_t)d * P * C;
    float* next = out_n + (int64_t)(d + 1) * P * C;
    const float* img = image + ((int64_t)n * Dm1 + d) * P * CIMG;
    const float* Hm = H_inc + ((int64_t)n * Dm1 + d) * 9;
    float Hr[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) Hr[k] = Hm[k];

    // 1-3. warp the carry by H_inc, zero the invalid samples.
    for (int p = tid; p < P; p += T) {
      const float px = (float)(p % wd);
      const float py = (float)(p / wd);
      const float X = Hr[0] * px + Hr[1] * py + Hr[2];
      const float Y = Hr[3] * px + Hr[4] * py + Hr[5];
      const float Z = Hr[6] * px + Hr[7] * py + Hr[8];
      const float gx = 2.0f * (X / Z + 0.5f) / (float)wd - 1.0f;
      const float gy = 2.0f * (Y / Z + 0.5f) / (float)h - 1.0f;
      const bool inv = fabsf(gx) > 1.0f || fabsf(gy) > 1.0f;
      float4* dst = reinterpret_cast<float4*>(warped + p * C);
      if (inv) {
#pragma unroll
        for (int j = 0; j < C / 4; ++j) dst[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        continue;
      }
      const float ix = fminf(fmaxf(((gx + 1.0f) * wd - 1.0f) * 0.5f, 0.0f), (float)(wd - 1));
      const float iy = fminf(fmaxf(((gy + 1.0f) * h - 1.0f) * 0.5f, 0.0f), (float)(h - 1));
      const float x0f = floorf(ix);
      const float y0f = floorf(iy);
      const float wx = ix - x0f;
      const float wy = iy - y0f;
      const int x0 = (int)x0f;
      const int y0 = (int)y0f;
      const int x1 = min(x0 + 1, wd - 1);
      const int y1 = min(y0 + 1, h - 1);
      const float4* p00 = reinterpret_cast<const float4*>(carry + (y0 * wd + x0) * C);
      const float4* p01 = reinterpret_cast<const float4*>(carry + (y0 * wd + x1) * C);
      const float4* p10 = reinterpret_cast<const float4*>(carry + (y1 * wd + x0) * C);
      const float4* p11 = reinterpret_cast<const float4*>(carry + (y1 * wd + x1) * C);
#pragma unroll
      for (int j = 0; j < C / 4; ++j) {
        const float4 a = p00[j], b = p01[j], c = p10[j], e = p11[j];
        float4 r;
        r.x = (a.x * (1.0f - wx) + b.x * wx) * (1.0f - wy) + (c.x * (1.0f - wx) + e.x * wx) * wy;
        r.y = (a.y * (1.0f - wx) + b.y * wx) * (1.0f - wy) + (c.y * (1.0f - wx) + e.y * wx) * wy;
        r.z = (a.z * (1.0f - wx) + b.z * wx) * (1.0f - wy) + (c.z * (1.0f - wx) + e.z * wx) * wy;
        r.w = (a.w * (1.0f - wx) + b.w * wx) * (1.0f - wy) + (c.w * (1.0f - wx) + e.w * wx) * wy;
        dst[j] = r;
      }
    }
    __syncthreads();

    // 4-5. conv0 over [image, warped] + b0 -> GN -> LeakyReLU, into bufA.
    {
      float s[GROUPS] = {0.f, 0.f, 0.f, 0.f}, ss[GROUPS] = {0.f, 0.f, 0.f, 0.f};
      for (int p = tid; p < P; p += T) {
        float acc[C];
#pragma unroll
        for (int oc = 0; oc < C; ++oc) acc[oc] = 0.0f;
        const int y = p / wd, x = p % wd;
        conv3x3<CIMG>(img, w0, C0, 0, y, x, h, wd, acc);
        conv3x3<C>(warped, w0, C0, CIMG, y, x, h, wd, acc);
#pragma unroll
        for (int oc = 0; oc < C; ++oc) acc[oc] += b0[oc];
        add_moments(acc, s, ss);
        float4* dst = reinterpret_cast<float4*>(bufA + p * C);
#pragma unroll
        for (int j = 0; j < C / 4; ++j)
          dst[j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
      }
      group_stats(s, ss, red, stat, P);
      for (int i = tid; i < P * C; i += T) {
        const int oc = i % C, g = oc / GSIZE;
        bufA[i] = leaky((bufA[i] - stat[g]) * stat[GROUPS + g] * g0[oc] + be0[oc]);
      }
      __syncthreads();
    }

    // 6. resblock: bufB = h + LeakyReLU(GN(conv(h) + br)), h in bufA.
    {
      float s[GROUPS] = {0.f, 0.f, 0.f, 0.f}, ss[GROUPS] = {0.f, 0.f, 0.f, 0.f};
      for (int p = tid; p < P; p += T) {
        float acc[C];
#pragma unroll
        for (int oc = 0; oc < C; ++oc) acc[oc] = 0.0f;
        conv3x3<C>(bufA, wr, C, 0, p / wd, p % wd, h, wd, acc);
#pragma unroll
        for (int oc = 0; oc < C; ++oc) acc[oc] += br[oc];
        add_moments(acc, s, ss);
        float4* dst = reinterpret_cast<float4*>(bufB + p * C);
#pragma unroll
        for (int j = 0; j < C / 4; ++j)
          dst[j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
      }
      group_stats(s, ss, red, stat, P);
      for (int i = tid; i < P * C; i += T) {
        const int oc = i % C, g = oc / GSIZE;
        bufB[i] = bufA[i] + leaky((bufB[i] - stat[g]) * stat[GROUPS + g] * gr[oc] + ber[oc]);
      }
      __syncthreads();
    }

    // 7. conv_final + bf -> delta; next = warped + delta.
    for (int p = tid; p < P; p += T) {
      float acc[C];
#pragma unroll
      for (int oc = 0; oc < C; ++oc) acc[oc] = 0.0f;
      conv3x3<C>(bufB, wf, C, 0, p / wd, p % wd, h, wd, acc);
      const float4* wp = reinterpret_cast<const float4*>(warped + p * C);
      float4* dst = reinterpret_cast<float4*>(next + p * C);
#pragma unroll
      for (int j = 0; j < C / 4; ++j) {
        const float4 a = wp[j];
        dst[j] = make_float4(a.x + (acc[4 * j] + bf[4 * j]),
                             a.y + (acc[4 * j + 1] + bf[4 * j + 1]),
                             a.z + (acc[4 * j + 2] + bf[4 * j + 2]),
                             a.w + (acc[4 * j + 3] + bf[4 * j + 3]));
      }
    }
    __syncthreads();
  }
}

}  // namespace

// feats0 (N, P, 32), image (N, D-1, P, 3), H_inc (N, D-1, 9): f32, contiguous, P = h*w.
// w0 (9, 35, 32), wr (9, 32, 32), wf (9, 32, 32): tap-major [kh*3+kw][ci][oc].
// vec (7, 32): b0, gn0 scale, gn0 bias, res conv bias, res gn scale, res gn bias, bf.
// out (N, D, P, 32); scratch (N, 3, P, 32). Returns cudaGetLastError().
extern "C" int mvs_incremental_chain_f32(const float* feats0, const float* image,
                                         const float* H_inc, const float* w0,
                                         const float* wr, const float* wf,
                                         const float* vec, float* out, float* scratch,
                                         int N, int Dm1, int h, int w, cudaStream_t stream) {
  if (N == 0) return 0;
  const int P = h * w;
  const int passes = (P + MAX_THREADS - 1) / MAX_THREADS;
  int threads = (P + passes - 1) / passes;
  threads = ((threads + 31) / 32) * 32;
  const size_t smem = sizeof(float) * (9 * C0 * C + 2 * 9 * C * C + 7 * C +
                                       (MAX_THREADS / 32) * 2 * GROUPS + 2 * GROUPS);
  cudaError_t err = cudaFuncSetAttribute(chain_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  chain_kernel<<<N, threads, smem, stream>>>(feats0, image, H_inc, w0, wr, wf, vec, out,
                                             scratch, Dm1, h, w);
  return (int)cudaGetLastError();
}
