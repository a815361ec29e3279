// The border clip's gradient of the bilinear warp (warp.cu, incremental_chain.cu), Hopper
// (sm_90a).
#pragma once

#include <cuda_runtime.h>

// The gradient of the clip to [0, hi] (a maximum, then a minimum, as jnp.clip computes it)
// given its output's: half at a tie, none past a bound, all of it for NaN. The same rule
// as autograd's through torch.maximum and torch.minimum (the plain version's _clip).
__device__ __forceinline__ float clip_grad(float g, float u, float hi) {
  const float m = isnan(u) ? u : fmaxf(u, 0.0f);
  if (m > hi) return 0.0f;
  if (m == hi) g = g * 0.5f;
  if (u < 0.0f) return 0.0f;
  return u == 0.0f ? g * 0.5f : g;
}
