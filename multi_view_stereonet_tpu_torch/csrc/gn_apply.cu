// GroupNorm with its statistics, LeakyReLU(0.2) and the residual add: the resblock tail
// (Hopper, sm_90a).
//
// Replaces the TPU kernel
//   multi_view_stereonet_tpu/ops/pallas/gn_apply.py, gn_apply_residual_fused
//   (_fused_call -> _kernel), with the statistics of models/s2d.py gn_s2d_stats,
// which the JAX entry computes before the call. Here both are one call:
//   out = leaky_relu((x - mean_g) * rstd_g * gamma_c + beta_c, 0.2) + res,
// mean_g and rstd_g = 1 / sqrt(var_g + eps) over each (sample, group) of x.
//
// What bounds it on this card: bytes, and on PyTorch's own GroupNorm the number of
// blocks. In NCHW one (sample, group) row is a contiguous span of (C / G) * H * W floats
// (2.46 M at 480x640, C = 32, G = 4); PyTorch reduces each row in one block, so the
// level-0 refiner keeps 4 of 132 SMs busy. Here each row is cut into chunks and the
// statistics pass runs one block per chunk, so the whole card reads x once:
//   1. stats:  each block sums x and x^2 of its chunk in f64 (E[x^2] - mu^2 over 2.46 M
//              f32 values loses digits in f32) and writes one (sum, sum of squares)
//              partial;
//   2. apply:  each block reduces its row's partials in a fixed order (so every block of
//              a row, and every run, gets the same mean and rstd: no atomics), then reads
//              x and res once as float4s and writes out once.
// The TPU version tiled rows of an s2d layout for the 128-lane VPU; none of that is needed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float SLOPE = 0.2f;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Chunk c of row r covers elements [c * chunk, min(L, (c + 1) * chunk)) of the row; chunk
// is a multiple of VEC, and rows start 16-byte aligned when VEC == 4.
template <int VEC>
__global__ void __launch_bounds__(THREADS)
gn_stats_kernel(const float* __restrict__ x, double2* __restrict__ partials, int64_t L,
                int64_t chunk, int chunks) {
  __shared__ double red[2][WARPS];
  const int row = blockIdx.y;
  const int64_t begin = (int64_t)blockIdx.x * chunk;
  const int64_t end = begin + chunk < L ? begin + chunk : L;
  const float* xr = x + (int64_t)row * L;
  double s = 0.0, ss = 0.0;
  for (int64_t i = begin + (int64_t)threadIdx.x * VEC; i < end; i += (int64_t)THREADS * VEC) {
    if constexpr (VEC == 4) {
      const float4 v = *reinterpret_cast<const float4*>(xr + i);
      const double a = v.x, b = v.y, c = v.z, d = v.w;
      s += (a + b) + (c + d);
      ss += (a * a + b * b) + (c * c + d * d);
    } else {
      const double a = xr[i];
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

__device__ __forceinline__ float tail(float v, float mu, float rs, float g, float b, float r) {
  const float y = (v - mu) * rs * g + b;
  return (y >= 0.0f ? y : SLOPE * y) + r;
}

template <int VEC>
__global__ void __launch_bounds__(THREADS)
gn_apply_kernel(const float* __restrict__ x, const float* __restrict__ res,
                const float* __restrict__ gamma, const float* __restrict__ beta,
                const double2* __restrict__ partials, float* __restrict__ out, int64_t L,
                int64_t chunk, int chunks, int64_t HW, int C, int G, float eps) {
  __shared__ float stat[2];
  const int row = blockIdx.y;
  if (threadIdx.x < 32) {
    double S = 0.0, SS = 0.0;
    for (int i = threadIdx.x; i < chunks; i += 32) {
      const double2 p = partials[(int64_t)row * chunks + i];
      S += p.x;
      SS += p.y;
    }
    S = warp_sum(S);
    SS = warp_sum(SS);
    if (threadIdx.x == 0) {
      const double mean = S / (double)L;
      const double var = fmax(SS / (double)L - mean * mean, 0.0);
      stat[0] = (float)mean;
      stat[1] = (float)(1.0 / sqrt(var + (double)eps));
    }
  }
  __syncthreads();
  const float mu = stat[0], rs = stat[1];
  const int c0 = (row % G) * (C / G);
  const int64_t base = (int64_t)row * L;
  const int64_t begin = (int64_t)blockIdx.x * chunk;
  const int64_t end = begin + chunk < L ? begin + chunk : L;
  for (int64_t i = begin + (int64_t)threadIdx.x * VEC; i < end; i += (int64_t)THREADS * VEC) {
    const int c = c0 + (int)(i / HW);  // a float4 never straddles channels: HW % 4 == 0
    const float g = gamma[c], b = beta[c];
    if constexpr (VEC == 4) {
      const float4 v = *reinterpret_cast<const float4*>(x + base + i);
      const float4 r = *reinterpret_cast<const float4*>(res + base + i);
      *reinterpret_cast<float4*>(out + base + i) =
          make_float4(tail(v.x, mu, rs, g, b, r.x), tail(v.y, mu, rs, g, b, r.y),
                      tail(v.z, mu, rs, g, b, r.z), tail(v.w, mu, rs, g, b, r.w));
    } else {
      out[base + i] = tail(x[base + i], mu, rs, g, b, res[base + i]);
    }
  }
}

template <int VEC>
int launch(const float* x, const float* res, const float* gamma, const float* beta,
           float* out, double2* partials, int rows, int64_t L, int64_t chunk, int chunks,
           int64_t HW, int C, int G, float eps, cudaStream_t stream) {
  const dim3 grid(chunks, rows);
  gn_stats_kernel<VEC><<<grid, THREADS, 0, stream>>>(x, partials, L, chunk, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_apply_kernel<VEC><<<grid, THREADS, 0, stream>>>(x, res, gamma, beta, partials, out, L,
                                                     chunk, chunks, HW, C, G, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, res, out (N, C, HW) f32 contiguous; gamma, beta (C,); partials (N * G, chunks) of
// (sum, sum of squares) f64 scratch. Each (sample, group) row of L = (C / G) * HW floats
// is cut into ``chunks`` chunks of ``chunk`` elements (a multiple of 4 when vec == 4).
// vec == 4 needs HW % 4 == 0 and 16-byte aligned x, res and out. Returns cudaGetLastError().
extern "C" int mvs_gn_apply_residual_f32(const float* x, const float* res, const float* gamma,
                                         const float* beta, float* out, double* partials,
                                         int N, int C, int G, int64_t HW, int64_t chunk,
                                         int chunks, int vec, float eps,
                                         cudaStream_t stream) {
  if (N == 0 || HW == 0) return 0;
  const int rows = N * G;
  const int64_t L = (int64_t)(C / G) * HW;
  double2* p = reinterpret_cast<double2*>(partials);
  if (vec == 4)
    return launch<4>(x, res, gamma, beta, out, p, rows, L, chunk, chunks, HW, C, G, eps,
                     stream);
  return launch<1>(x, res, gamma, beta, out, p, rows, L, chunk, chunks, HW, C, G, eps,
                   stream);
}
