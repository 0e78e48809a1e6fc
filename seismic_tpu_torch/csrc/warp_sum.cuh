// Warp-wide sums of N per-lane partial values (N a power of two <= 32),
// shared by the grouped scorers.
#pragma once

#include <cuda_runtime.h>

// Sum each of the lane's N partial values over the warp. Step s (offset
// 16 >> s) halves the values a lane carries: lanes with that offset bit set
// keep the upper half and add their partner's upper half, the others the
// lower; once one value is left, plain shuffles finish the sum. Afterwards
// lane l holds the total of value l / (32 / N). The steps are unrolled at
// compile time (if constexpr), so every acc index is a constant and acc
// stays in registers.
template <typename T, int N, int kStep = 0>
__device__ __forceinline__ T warp_transpose_sum(T (&acc)[N], int lane) {
  constexpr int o = 16 >> kStep;
  if constexpr ((N >> kStep) > 1) {
    constexpr int half = N >> (kStep + 1);
    const bool hi = lane & o;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const T send = hi ? acc[j] : acc[j + half];
      const T keep = hi ? acc[j + half] : acc[j];
      acc[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
    return warp_transpose_sum<T, N, kStep + 1>(acc, lane);
  } else {
#pragma unroll
    for (int p = o; p >= 1; p >>= 1) {
      acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], p);
    }
    return acc[0];
  }
}
