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
//   out = top (1-wy) + bot wy; invalid = |gx| > 1 or |gy| > 1 (pre-clamp).
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// CC: the channel count when it is known at compile time (3), else 0 (runtime C).
template <int CC>
__global__ void __launch_bounds__(256)
grid_sample_kernel(const float* __restrict__ image, const float* __restrict__ grid,
                   float* __restrict__ out, bool* __restrict__ invalid, int H, int W,
                   int C_rt, int64_t M, int zero_invalid) {
  const int64_t m = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const int C = CC > 0 ? CC : C_rt;
  const int64_t i = (int64_t)blockIdx.y * M + m;

  const float gx = __ldg(grid + 2 * i);
  const float gy = __ldg(grid + 2 * i + 1);
  const bool inv = fabsf(gx) > 1.0f || fabsf(gy) > 1.0f;

  const float ix = fminf(fmaxf(((gx + 1.0f) * W - 1.0f) * 0.5f, 0.0f), (float)(W - 1));
  const float iy = fminf(fmaxf(((gy + 1.0f) * H - 1.0f) * 0.5f, 0.0f), (float)(H - 1));
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
  float* o = out + i * C;
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
      o[k] = zero ? 0.0f : top * (1.0f - wy) + bot * wy;
    }
  } else {
    for (int k = 0; k < C; ++k) {
      const float top = p00[k] * (1.0f - wx) + p01[k] * wx;
      const float bot = p10[k] * (1.0f - wx) + p11[k] * wx;
      o[k] = zero ? 0.0f : top * (1.0f - wy) + bot * wy;
    }
  }
  invalid[i] = inv;
}

}  // namespace

// image (B, H, W, C) f32, grid (B, M, 2) f32 -> out (B, M, C) f32,
// invalid (B, M) bool. All contiguous; B <= 65535. Returns cudaGetLastError().
extern "C" int mvs_grid_sample_f32(const float* image, const float* grid, float* out,
                                   bool* invalid, int B, int H, int W, int C, int64_t M,
                                   int zero_invalid, cudaStream_t stream) {
  if ((int64_t)B * M == 0) return 0;
  const int threads = 256;
  const dim3 blocks((unsigned)((M + threads - 1) / threads), (unsigned)B);
  if (C == 3)
    grid_sample_kernel<3><<<blocks, threads, 0, stream>>>(image, grid, out, invalid, H, W,
                                                          C, M, zero_invalid);
  else
    grid_sample_kernel<0><<<blocks, threads, 0, stream>>>(image, grid, out, invalid, H, W,
                                                          C, M, zero_invalid);
  return (int)cudaGetLastError();
}
