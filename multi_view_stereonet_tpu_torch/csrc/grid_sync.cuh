// The grid barrier of the cooperative kernels (idepthmap_refiner.cu, gn_apply.cu), Hopper
// (sm_90a).
#pragma once

#include <cuda_runtime.h>

// All blocks of the grid arrive before any leaves. Block 0 adds 2^31 - (nblocks - 1) and
// every other block 1, so the top bit of the counter flips exactly when the last block
// arrives; each barrier adds 2^31 in all, so the low 31 bits stay 0 and the counter is
// ready for the next barrier, and the next launch, whichever way its top bit stands. The
// add releases and the polling load acquires at GPU scope, after the block's own barrier:
// every write before the barrier is visible to every read after it. Kernels of one stream
// may share one counter (each launch leaves it ready); launches on two streams at once
// may not.
__device__ __forceinline__ void grid_barrier(unsigned int* counter) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    unsigned int old, now;
    asm volatile("atom.add.release.gpu.u32 %0, [%1], %2;\n"
                 : "=r"(old) : "l"(counter), "r"(add) : "memory");
    do {
      asm volatile("ld.acquire.gpu.u32 %0, [%1];\n" : "=r"(now) : "l"(counter) : "memory");
    } while (((old ^ now) & 0x80000000u) == 0);
  }
  __syncthreads();
}
