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
// What bounds it on this card: bytes. Each output sample reads four source
// pixels and writes C floats; there are ~4 flops per byte. The TPU kernel's
// band DMA, one-hot matmul and lane rotations exist only because TPU gathers
// are slow. Hopper gathers directly: one thread per output sample, looping
// over the C channels. The source image of the main path (480x640x3 f32,
// 3.7 MB) and the level-4 image of the plane sweep stay in the 50 MB L2, so
// the scattered tap reads hit L2 and the kernel runs near the rate of its
// coalesced grid reads and output writes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void grid_sample_kernel(const float* __restrict__ image,
                                   const float* __restrict__ grid,
                                   float* __restrict__ out,
                                   bool* __restrict__ invalid,
                                   int H, int W, int C, int64_t M, int64_t total,
                                   int zero_invalid) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t b = i / M;

  const float gx = grid[2 * i];
  const float gy = grid[2 * i + 1];
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

  const float* img = image + b * H * W * C;
  const float* p00 = img + ((int64_t)y0 * W + x0) * C;
  const float* p01 = img + ((int64_t)y0 * W + x1) * C;
  const float* p10 = img + ((int64_t)y1 * W + x0) * C;
  const float* p11 = img + ((int64_t)y1 * W + x1) * C;
  float* o = out + i * C;
  const bool zero = zero_invalid && inv;
  for (int c = 0; c < C; ++c) {
    const float top = p00[c] * (1.0f - wx) + p01[c] * wx;
    const float bot = p10[c] * (1.0f - wx) + p11[c] * wx;
    o[c] = zero ? 0.0f : top * (1.0f - wy) + bot * wy;
  }
  invalid[i] = inv;
}

}  // namespace

// image (B, H, W, C) f32, grid (B, M, 2) f32 -> out (B, M, C) f32,
// invalid (B, M) bool. All contiguous. Returns cudaGetLastError().
extern "C" int mvs_grid_sample_f32(const float* image, const float* grid, float* out,
                                   bool* invalid, int B, int H, int W, int C, int64_t M,
                                   int zero_invalid, cudaStream_t stream) {
  const int64_t total = (int64_t)B * M;
  if (total == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  grid_sample_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      image, grid, out, invalid, H, W, C, M, total, zero_invalid);
  return (int)cudaGetLastError();
}
