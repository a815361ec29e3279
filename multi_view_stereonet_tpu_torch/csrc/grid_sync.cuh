// The grid barrier of the cooperative kernels (idepthmap_refiner.cu, gn_apply.cu, and the
// weight-gradient passes of wgrad.cuh), and their grid size, Hopper (sm_90a).
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

// The blocks a cooperative launch of `kernel` (`threads` a block, `smem` bytes of dynamic
// shared memory, its attribute set here) may take on the current device: as many as are
// resident at once. Cached by the caller's `cache`, one entry a device (64 at most).
// Returns a cudaError_t code.
template <typename K>
int resident_blocks(K kernel, int threads, size_t smem, int (&cache)[64], int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm * sms == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
    cache[dev] = per_sm * sms;
  }
  *blocks = cache[dev];
  return 0;
}
