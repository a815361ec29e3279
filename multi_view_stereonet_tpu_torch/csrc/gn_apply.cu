// GroupNorm with its statistics -> LeakyReLU(0.2) -> optional residual add: every
// GroupNorm of the serving forward (Hopper, sm_90a).
//
// Replaces the TPU kernel
//   multi_view_stereonet_tpu/ops/pallas/gn_apply.py, gn_apply_residual_fused
//   (_fused_call -> _kernel), with the statistics of models/s2d.py gn_s2d_stats,
// which the JAX entry computes before the call. Here both are one call:
//   out = leaky_relu((x - mean_g) * rstd_g * gamma_c + beta_c, 0.2) [+ res],
// mean_g and rstd_g = 1 / sqrt(var_g + eps) over each (sample, group) of x. The same
// function without the residual is the JAX models' leaky_relu(group_norm(...)) of the
// refiners' bn0 and the cost filter (models/refiners.py, models/cost_volume.py).
//
// x is (N, C, S), S the per-channel span (H * W, or D * H * W for the 3-D filter), so one
// (sample, group) row is a contiguous run of L = (C / G) * S floats (2.46 M at 480x640,
// C = 32, G = 4). What bounds it on this card: bytes, and on PyTorch's own GroupNorm the
// number of blocks: PyTorch reduces each row in one block, so the level-0 refiner keeps 4
// of 132 SMs busy. Here each row is cut into chunks and the statistics pass runs one
// block per chunk, so the whole card reads x once:
//   1. stats:  each block sums x and x^2 of its chunk in f64 (E[x^2] - mu^2 over 2.46 M
//              f32 values loses digits in f32) and writes one (sum, sum of squares)
//              partial;
//   2. apply:  each block reduces its row's partials in a fixed order (so every block of
//              a row, and every run, gets the same mean and rstd: no atomics), then reads
//              x (from L2 at the forward's sizes) and res once as float4s and writes out
//              once.
// The TPU version tiled rows of an s2d layout for the 128-lane VPU; none of that is needed.
//
// x, res and out are f32 or bf16 (the storage type T; gamma, beta and the statistics stay
// f32). At bf16 the tail follows the Pallas kernel (gn_apply.py:37-52): the apply in f32,
// rounded to bf16; the sign test on the f32 value; LeakyReLU at bf16 (the slope rounded
// to bf16, the product rounded); the residual added at bf16 (a rounded sum). The
// statistics pass reads bf16 and sums in f64 as the f32 pass does. A bf16 call moves half
// the bytes. An optional per-channel f32 ``xbias`` (the bias of the conv that wrote x) is
// added to x in f32 before the statistics and the apply, so a bf16 conv's bias add costs no
// pass of its own and is not rounded before the GroupNorm (as the Pallas kernels add it in
// f32, and as XLA computes the JAX layers' bias add there).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
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

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

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

// res == nullptr: no residual; xbias == nullptr: none.
template <int VEC, typename T>
__global__ void __launch_bounds__(THREADS)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ xbias,
                const T* __restrict__ res, const float* __restrict__ gamma,
                const float* __restrict__ beta,
                const double2* __restrict__ partials, T* __restrict__ out, int64_t L,
                int64_t chunk, int chunks, int64_t S, int C, int G, float eps) {
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

template <int VEC, typename T>
int launch_vec(const T* x, const float* xbias, const T* res, const float* gamma,
               const float* beta, T* out, double2* partials, int rows, int64_t L,
               int64_t chunk, int chunks, int64_t S, int C, int G, float eps,
               cudaStream_t stream) {
  const dim3 grid(chunks, rows);
  gn_stats_kernel<VEC, T><<<grid, THREADS, 0, stream>>>(x, xbias, partials, L, chunk, chunks,
                                                        S, C, G);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_apply_kernel<VEC, T><<<grid, THREADS, 0, stream>>>(x, xbias, res, gamma, beta, partials,
                                                        out, L, chunk, chunks, S, C, G, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* x, const float* xbias, const T* res, const float* gamma,
           const float* beta, T* out, double* partials, int N, int C, int G, int64_t S,
           int64_t chunk, int chunks, int vec, float eps, cudaStream_t stream) {
  if (N == 0 || S == 0) return 0;
  const int rows = N * G;
  const int64_t L = (int64_t)(C / G) * S;
  double2* p = reinterpret_cast<double2*>(partials);
  if (vec == 4)
    return launch_vec<4>(x, xbias, res, gamma, beta, out, p, rows, L, chunk, chunks, S, C, G,
                         eps, stream);
  return launch_vec<1>(x, xbias, res, gamma, beta, out, p, rows, L, chunk, chunks, S, C, G,
                       eps, stream);
}

}  // namespace

// x, out (N, C, S) f32 contiguous, res the same or null (no residual); gamma, beta (C,);
// xbias (C,) f32 or null;
// partials (N * G, chunks) of (sum, sum of squares) f64 scratch. Each (sample, group) row
// of L = (C / G) * S elements is cut into ``chunks`` chunks of ``chunk`` elements (a
// multiple of 4 when vec == 4). vec == 4 needs S % 4 == 0 and x, res and out aligned to
// four elements. Returns the launches' cudaError_t (0 on success; a refused launch's
// error is cleared, so none is left pending).
extern "C" int mvs_gn_act_f32(const float* x, const float* xbias, const float* res,
                              const float* gamma, const float* beta, float* out,
                              double* partials, int N, int C, int G, int64_t S, int64_t chunk,
                              int chunks, int vec, float eps, cudaStream_t stream) {
  return launch(x, xbias, res, gamma, beta, out, partials, N, C, G, S, chunk, chunks, vec, eps,
                stream);
}

// The same with x, res and out bf16.
extern "C" int mvs_gn_act_bf16(const __nv_bfloat16* x, const float* xbias,
                               const __nv_bfloat16* res, const float* gamma, const float* beta,
                               __nv_bfloat16* out, double* partials, int N, int C, int G,
                               int64_t S, int64_t chunk, int chunks, int vec, float eps,
                               cudaStream_t stream) {
  return launch(x, xbias, res, gamma, beta, out, partials, N, C, G, S, chunk, chunks, vec, eps,
                stream);
}
