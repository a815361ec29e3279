// Bilinear grid sample for the homography and plane-sweep warps (Hopper, sm_90a).
//
// Replaces the TPU band-warp kernel:
//   multi_view_stereonet_tpu/ops/pallas/warp_kernel.py, homography_warp_pallas
//   (_pallas_grid_sample -> _resample_value -> _pallas_resample / _warp_kernel).
//
// Semantics are torch grid_sample(mode=bilinear, padding_mode=border,
// align_corners=False) as multi_view_stereonet_tpu/ops/warp.py:26-79 writes it:
//   ix = ((gx + 1) * W - 1) / 2, clamped to [0, W-1] BEFORE the floor;
//   x1 = min(x0 + 1, W - 1); top = v00 (1-wx) + v01 wx, bot likewise,
//   out = top (1-wy) + bot wy; invalid = |gx| > 1 or |gy| > 1 (pre-clamp);
//   a NaN coordinate gives NaN in every channel (valid, unless the other one is out).
//
// What bounds it on this card: bytes, and at the serving shapes latency. Each output
// sample reads its grid point, then four source pixels, and writes C floats and a
// flag: two dependent trips to memory. The TPU kernel's band DMA, one-hot matmul and
// lane rotations exist only because TPU gathers are slow; Hopper gathers directly, one
// thread per output sample. The source images (480x640x3 f32, 3.7 MB, and the level-4
// image of the plane sweep) stay in the 50 MB L2, so the tap reads hit L2. The first
// design (a 64-bit division per thread for the batch index, a runtime loop over C)
// lost to F.grid_sample on the device at the plane sweep; this one takes the batch
// index from blockIdx.y, and for C = 3 (both warps of the serving path) issues all
// twelve tap reads before any arithmetic.
//
// The output is f32 or bf16 (the JAX warp's out_dtype, warp_kernel.py:224-273): the
// interpolation is f32 either way and the bf16 output is the f32 one rounded once to
// nearest even, so it is the f32 kernel's output rounded, bit for bit.
//
// The backward (grid_sample_bwd_kernel, below) has no TPU kernel to replace: the JAX
// package takes it as the VJP of the XLA gather.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "clip_grad.cuh"  // clip_grad

namespace {

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// CC: the channel count when it is known at compile time (3), else 0 (runtime C).
// T: the output's storage type.
template <int CC, typename T>
__global__ void __launch_bounds__(256)
grid_sample_kernel(const float* __restrict__ image, const float* __restrict__ grid,
                   T* __restrict__ out, bool* __restrict__ invalid, int H, int W,
                   int C_rt, int64_t M, int zero_invalid) {
  const int64_t m = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const int C = CC > 0 ? CC : C_rt;
  const int64_t i = (int64_t)blockIdx.y * M + m;

  const float gx = __ldg(grid + 2 * i);
  const float gy = __ldg(grid + 2 * i + 1);
  const bool inv = fabsf(gx) > 1.0f || fabsf(gy) > 1.0f;

  const float ux = ((gx + 1.0f) * W - 1.0f) * 0.5f;
  const float uy = ((gy + 1.0f) * H - 1.0f) * 0.5f;
  T* o = out + i * C;
  if (isnan(ux) || isnan(uy)) {
    // fmaxf would clamp a NaN coordinate to 0 and sample pixel (0, 0); the plain
    // version's clamp, and the XLA gather it follows, carry the NaN into every channel.
    // The flag stays as computed above (|NaN| > 1 is false), as theirs does.
    for (int k = 0; k < C; ++k)
      store(o + k, zero_invalid && inv ? 0.0f : __int_as_float(0x7fc00000));
    invalid[i] = inv;
    return;
  }
  const float ix = fminf(fmaxf(ux, 0.0f), (float)(W - 1));
  const float iy = fminf(fmaxf(uy, 0.0f), (float)(H - 1));
  const float x0f = floorf(ix);
  const float y0f = floorf(iy);
  const float wx = ix - x0f;
  const float wy = iy - y0f;
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  const int x1 = min(x0 + 1, W - 1);
  const int y1 = min(y0 + 1, H - 1);

  const float* img = image + (int64_t)blockIdx.y * H * W * C;
  const float* p00 = img + ((int64_t)y0 * W + x0) * C;
  const float* p01 = img + ((int64_t)y0 * W + x1) * C;
  const float* p10 = img + ((int64_t)y1 * W + x0) * C;
  const float* p11 = img + ((int64_t)y1 * W + x1) * C;
  const bool zero = zero_invalid && inv;
  if constexpr (CC > 0) {
    float a[CC], b[CC], c[CC], e[CC];
#pragma unroll
    for (int k = 0; k < CC; ++k) {
      a[k] = __ldg(p00 + k);
      b[k] = __ldg(p01 + k);
      c[k] = __ldg(p10 + k);
      e[k] = __ldg(p11 + k);
    }
#pragma unroll
    for (int k = 0; k < CC; ++k) {
      const float top = a[k] * (1.0f - wx) + b[k] * wx;
      const float bot = c[k] * (1.0f - wx) + e[k] * wx;
      store(o + k, zero ? 0.0f : top * (1.0f - wy) + bot * wy);
    }
  } else {
    for (int k = 0; k < C; ++k) {
      const float top = p00[k] * (1.0f - wx) + p01[k] * wx;
      const float bot = p10[k] * (1.0f - wx) + p11[k] * wx;
      store(o + k, zero ? 0.0f : top * (1.0f - wy) + bot * wy);
    }
  }
  invalid[i] = inv;
}

template <typename T>
int launch(const float* image, const float* grid, T* out, bool* invalid, int B, int H, int W,
           int C, int64_t M, int zero_invalid, cudaStream_t stream) {
  if ((int64_t)B * M == 0) return 0;
  const int threads = 256;
  const dim3 blocks((unsigned)((M + threads - 1) / threads), (unsigned)B);
  if (C == 3)
    grid_sample_kernel<3, T><<<blocks, threads, 0, stream>>>(image, grid, out, invalid, H, W,
                                                             C, M, zero_invalid);
  else
    grid_sample_kernel<0, T><<<blocks, threads, 0, stream>>>(image, grid, out, invalid, H, W,
                                                             C, M, zero_invalid);
  return (int)cudaGetLastError();
}

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// One tap's contribution to the image gradient, skipped where it is exactly zero: a tap
// of zero weight (the far tap of a sample clamped to the border, where every sample
// outside the image lands, or x1 = x0) or a zero output gradient. Adding a zero to a sum
// that starts at +0 changes nothing, and a NaN or an infinity is still added.
__device__ __forceinline__ void add_tap(float* p, float v) {
  if (v != 0.0f) atomicAdd(p, v);
}

// The backward's blocks: BWD_THREADS threads, a sample each (two or four a thread measured
// slower, PERF.md §6).
constexpr int BWD_THREADS = 256;

// One output sample of the backward: its taps and weights, recomputed from its grid point
// as the forward computes them.
struct Sample {
  int x0, y0, x1, y1;
  float wx, wy, ux, uy;
  bool on;       // a sample of the map (the last block's tail is not)
  bool zero;     // zeroed by zero_invalid: passes no gradient
  bool scatter;  // adds its taps to the image gradient
  bool clamped;  // scatters, with a number for each coordinate, clamped to the border
};

__device__ __forceinline__ Sample sample_at(const float* grid, int64_t i, bool on, int H, int W,
                                            bool want_image, int zero_invalid) {
  Sample t;
  t.on = on;
  const float2 p = on ? __ldg(reinterpret_cast<const float2*>(grid) + i) : make_float2(0.f, 0.f);
  const bool inv = fabsf(p.x) > 1.0f || fabsf(p.y) > 1.0f;
  t.zero = zero_invalid && inv;
  t.ux = ((p.x + 1.0f) * W - 1.0f) * 0.5f;
  t.uy = ((p.y + 1.0f) * H - 1.0f) * 0.5f;
  // The clip carries a NaN coordinate through (fmaxf alone would make it 0); its taps
  // are pixel (0, 0) and its neighbours, as the plain version's index clamp gives.
  const float ix = isnan(t.ux) ? t.ux : fminf(fmaxf(t.ux, 0.0f), (float)(W - 1));
  const float iy = isnan(t.uy) ? t.uy : fminf(fmaxf(t.uy, 0.0f), (float)(H - 1));
  const float x0f = floorf(ix);
  const float y0f = floorf(iy);
  t.wx = ix - x0f;
  t.wy = iy - y0f;
  t.x0 = isnan(x0f) ? 0 : (int)x0f;
  t.y0 = isnan(y0f) ? 0 : (int)y0f;
  t.x1 = min(t.x0 + 1, W - 1);
  t.y1 = min(t.y0 + 1, H - 1);
  const bool nan = isnan(t.wx) || isnan(t.wy);
  t.scatter = on && want_image && !(t.zero && !nan);
  t.clamped = t.scatter && !nan && inv;
  return t;
}

// The backward of grid_sample_kernel (the VJP of the JAX grid_sample, ops/warp.py:31-79,
// that _pallas_grid_sample_bwd takes, warp_kernel.py:396-404): one thread per output
// sample, in the map's order; blockIdx.y is the sample of the batch. Each thread reads its
// grid point (8 bytes) and its C output gradients (f32 or bf16, widened) and recomputes
// the weights; then:
// - the grid gradient: sum_c of g times the blend's derivative in wx and wy, through the
//   border clip (clip_grad) and the unnormalization, written as 8 bytes a sample;
// - the image gradient, where it is wanted: each nonzero tap one f32 atomic to device
//   memory (red.global.add; the gradient was zeroed on the stream first, cudaMemsetAsync
//   in the entry). A sample clamped to the border puts its taps on the border's pixels,
//   where the losses' grids pile up thousands of them (a quarter of their samples lie
//   outside the image): the clamped samples of a warp with the same taps are found by
//   __match_any_sync and summed by the group's first lane, which adds the sums once.
// A sample zeroed by zero_invalid passes no gradient: its taps are skipped unless a NaN
// weight would make them NaN, as the plain version's products do. dimage or dgrid may be
// null (not wanted); the image's taps are read only for the grid gradient, and a call
// without dimage (the reconstruction loss: its images are data) stops after the grid
// gradient. The runtime-C path (CC = 0) adds every tap on its own.
//
// What bounds it: bytes (each sample's grid point and gradient read, its grid gradient
// written, the image read and its gradient written once). The images (3.7-29.5 MB) stay
// in the 50 MB L2, where the tap reads hit and the atomics resolve.
template <int CC, typename G>
__global__ void __launch_bounds__(BWD_THREADS)
grid_sample_bwd_kernel(const float* __restrict__ image, const float* __restrict__ grid,
                       const G* __restrict__ grad, float* __restrict__ dimage,
                       float* __restrict__ dgrid, int H, int W, int C_rt, int64_t M,
                       int zero_invalid) {
  const int C = CC > 0 ? CC : C_rt;
  const int lane = threadIdx.x & 31;
  const int64_t m = (int64_t)blockIdx.x * BWD_THREADS + threadIdx.x;
  const int64_t i = (int64_t)blockIdx.y * M + m;  // the thread's sample
  const int64_t base = (int64_t)blockIdx.y * H * W;  // the sample's image, in pixels
  const Sample u = sample_at(grid, i, m < M, H, W, dimage != nullptr, zero_invalid);
  auto pix = [&](int y, int x) { return (base + (int64_t)y * W + x) * C; };

  if constexpr (CC == 0) {
    if (!u.on) return;
    const G* gp = grad + i * C;
    float gwx = 0.0f, gwy = 0.0f;
    for (int k = 0; k < C; ++k) {
      const float g = u.zero ? 0.0f : load(gp + k);
      const float gt = g * (1.0f - u.wy), gb = g * u.wy;
      if (dgrid != nullptr) {
        const float a = __ldg(image + pix(u.y0, u.x0) + k);
        const float b = __ldg(image + pix(u.y0, u.x1) + k);
        const float c = __ldg(image + pix(u.y1, u.x0) + k);
        const float e = __ldg(image + pix(u.y1, u.x1) + k);
        const float top = a * (1.0f - u.wx) + b * u.wx;
        const float bot = c * (1.0f - u.wx) + e * u.wx;
        gwx += gt * (b - a) + gb * (e - c);
        gwy += g * (bot - top);
      }
      if (u.scatter) {
        add_tap(dimage + pix(u.y0, u.x0) + k, gt * (1.0f - u.wx));
        add_tap(dimage + pix(u.y0, u.x1) + k, gt * u.wx);
        add_tap(dimage + pix(u.y1, u.x0) + k, gb * (1.0f - u.wx));
        add_tap(dimage + pix(u.y1, u.x1) + k, gb * u.wx);
      }
    }
    if (dgrid != nullptr)
      reinterpret_cast<float2*>(dgrid)[i] =
          make_float2(clip_grad(gwx, u.ux, (float)(W - 1)) * 0.5f * W,
                      clip_grad(gwy, u.uy, (float)(H - 1)) * 0.5f * H);
  } else {
    float g[CC];
#pragma unroll
    for (int k = 0; k < CC; ++k) g[k] = (!u.on || u.zero) ? 0.0f : load(grad + i * CC + k);

    if (dgrid != nullptr && u.on) {
      const int64_t q00 = pix(u.y0, u.x0), q01 = pix(u.y0, u.x1);
      const int64_t q10 = pix(u.y1, u.x0), q11 = pix(u.y1, u.x1);
      float a[CC], b[CC], c[CC], e[CC];
#pragma unroll
      for (int k = 0; k < CC; ++k) {
        a[k] = __ldg(image + q00 + k);
        b[k] = __ldg(image + q01 + k);
        c[k] = __ldg(image + q10 + k);
        e[k] = __ldg(image + q11 + k);
      }
      float gwx = 0.0f, gwy = 0.0f;
#pragma unroll
      for (int k = 0; k < CC; ++k) {
        const float top = a[k] * (1.0f - u.wx) + b[k] * u.wx;
        const float bot = c[k] * (1.0f - u.wx) + e[k] * u.wx;
        gwx += g[k] * (1.0f - u.wy) * (b[k] - a[k]) + g[k] * u.wy * (e[k] - c[k]);
        gwy += g[k] * (bot - top);
      }
      reinterpret_cast<float2*>(dgrid)[i] =
          make_float2(clip_grad(gwx, u.ux, (float)(W - 1)) * 0.5f * W,
                      clip_grad(gwy, u.uy, (float)(H - 1)) * 0.5f * H);
    }
    if (dimage == nullptr) return;  // the whole grid: no warp sums

    float v[4][CC];  // the sample's four taps' contributions
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int k = 0; k < CC; ++k)
        v[q][k] = g[k] * (q & 2 ? u.wy : 1.0f - u.wy) * (q & 1 ? u.wx : 1.0f - u.wx);
    // The warp's clamped samples with the same first tap (so the same taps): the group's
    // first lane adds their sums, the others nothing.
    __shared__ float agg[BWD_THREADS][4 * CC + 1];  // a lane's taps, for its group's first
    unsigned group = 1u << lane;  // the lanes whose contributions this lane adds
    if (__any_sync(0xffffffffu, u.clamped)) {
      const unsigned peers =
          __match_any_sync(0xffffffffu, u.clamped ? u.y0 * W + u.x0 : -1 - lane);
      if (u.clamped && __popc(peers) > 1) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int k = 0; k < CC; ++k) agg[threadIdx.x][q * CC + k] = v[q][k];
        group = lane == __ffs(peers) - 1 ? peers : 0u;
      }
      __syncwarp();
      for (unsigned rest = group & ~(1u << lane); rest != 0u; rest &= rest - 1u) {
        const float* other = agg[(threadIdx.x & ~31u) + __ffs(rest) - 1];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int k = 0; k < CC; ++k) v[q][k] += other[q * CC + k];
      }
    }
    if (u.scatter && group != 0u) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int64_t p = pix(q & 2 ? u.y1 : u.y0, q & 1 ? u.x1 : u.x0);
#pragma unroll
        for (int k = 0; k < CC; ++k) add_tap(dimage + p + k, v[q][k]);
      }
    }
  }
}

template <typename G>
int launch_bwd(const float* image, const float* grid, const G* grad, float* dimage,
               float* dgrid, int B, int H, int W, int C, int64_t M, int zero_invalid,
               cudaStream_t stream) {
  if (dimage == nullptr && dgrid == nullptr) return 0;
  if (dimage != nullptr) {
    const cudaError_t err = cudaMemsetAsync(
        dimage, 0, (size_t)B * H * W * C * sizeof(float), stream);
    if (err != cudaSuccess) return (int)err;
  }
  if ((int64_t)B * M == 0) return 0;
  const dim3 blocks((unsigned)((M + BWD_THREADS - 1) / BWD_THREADS), (unsigned)B);
#define MVS_BWD(CC_)                                                                        \
  grid_sample_bwd_kernel<CC_, G><<<blocks, BWD_THREADS, 0, stream>>>(                       \
      image, grid, grad, dimage, dgrid, H, W, C, M, zero_invalid)
  if (C == 3)
    MVS_BWD(3);
  else if (C == 1)
    MVS_BWD(1);
  else
    MVS_BWD(0);
#undef MVS_BWD
  return (int)cudaGetLastError();
}

}  // namespace

// image (B, H, W, C) f32, grid (B, M, 2) f32 -> out (B, M, C) f32 (or bf16, below),
// invalid (B, M) bool. All contiguous; B <= 65535. Returns cudaGetLastError().
extern "C" int mvs_grid_sample_f32(const float* image, const float* grid, float* out,
                                   bool* invalid, int B, int H, int W, int C, int64_t M,
                                   int zero_invalid, cudaStream_t stream) {
  return launch(image, grid, out, invalid, B, H, W, C, M, zero_invalid, stream);
}

extern "C" int mvs_grid_sample_bf16(const float* image, const float* grid, __nv_bfloat16* out,
                                    bool* invalid, int B, int H, int W, int C, int64_t M,
                                    int zero_invalid, cudaStream_t stream) {
  return launch(image, grid, out, invalid, B, H, W, C, M, zero_invalid, stream);
}

// The backward: image (B, H, W, C) f32, grid (B, M, 2) f32, grad (B, M, C) f32 (or bf16,
// below) -> dimage (B, H, W, C) f32, zeroed here on the stream, and dgrid (B, M, 2) f32;
// either may be null. grid and dgrid 8-byte aligned. Returns the first CUDA error.
extern "C" int mvs_grid_sample_bwd_f32(const float* image, const float* grid, const float* grad,
                                       float* dimage, float* dgrid, int B, int H, int W, int C,
                                       int64_t M, int zero_invalid, cudaStream_t stream) {
  return launch_bwd(image, grid, grad, dimage, dgrid, B, H, W, C, M, zero_invalid, stream);
}

extern "C" int mvs_grid_sample_bwd_bf16(const float* image, const float* grid,
                                        const __nv_bfloat16* grad, float* dimage, float* dgrid,
                                        int B, int H, int W, int C, int64_t M, int zero_invalid,
                                        cudaStream_t stream) {
  return launch_bwd(image, grid, grad, dimage, dgrid, B, H, W, C, M, zero_invalid, stream);
}
