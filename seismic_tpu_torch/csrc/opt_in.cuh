// Dynamic shared memory past 48 KB: a launch needs its kernel's opt-in,
// once per device (the scorers' rings, the term tables of long rows).
#pragma once

#include <cuda_runtime.h>

constexpr int kMaxDevices = 64;
// dynamic shared memory a block may opt into on an H100 (227 KB)
constexpr int kMaxSmemBytes = 232448;

// Opt `kernel` in to `smem` bytes of dynamic shared memory, once per
// device; `done` remembers the devices already opted in, so a caller
// opts in at the most it will ever launch with. Returns the error.
template <typename F>
cudaError_t opt_in_smem(F kernel, int smem, bool (&done)[kMaxDevices]) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return e;
}
