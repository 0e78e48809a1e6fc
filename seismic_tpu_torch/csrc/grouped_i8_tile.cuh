// One work item of the grouped int8 scorers: a group's kM int8 query rows
// against kRows u8 tile rows, shared by the slot-major (grouped_scorer.cu)
// and the item-major (grouped_scorer_item.cu) kernel, which differ only in
// where they store the block.
//
//   s_out[m * kRows + r] = (float)(sum_v q[m, v] * u8[row0 + r, v])
//                          * tile_scale[row0 + r]
//
// The dot is exact int32. Each lane keeps its slice of the kM query rows in
// registers, read straight from device memory (lane l holds bytes
// [c*256 + 8l, +8) of every row, c < V/256; 2*kM*V/256 registers). Warps
// walk the item's rows, one row per warp at a time, two in flight: each
// lane loads 8 bytes per 256-byte chunk (coalesced), recentres the u8 codes
// to int8 with one XOR (u8 - 128) and accumulates kM dot products with
// __dp4a; the 128 * sum(q) correction is folded into the start value. A
// transposing butterfly (warp_sum.cuh) reduces the kM lane partials. The
// block is 256 threads; the function ends with __syncthreads().
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "warp_sum.cuh"

constexpr int kI8Threads = 256;
constexpr int kI8Chunk = 256;  // bytes of a row one warp covers per load

template <int kM, int kRows, int NC>  // NC = V / 256 chunks per row
__device__ __forceinline__ void score_item_i8(
    const uint8_t* __restrict__ tiles,     // [rows, V]
    const float* __restrict__ tile_scale,  // [rows]
    const int8_t* __restrict__ qg,         // [kM, V], the group's queries
    int64_t row0, float* s_out) {          // shared [kM * kRows]
  constexpr int V = NC * kI8Chunk;
  constexpr int kWarps = kI8Threads / 32;
  constexpr int kSpread = 32 / kM;  // lanes that end up holding one query
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // lane slice of every query row in registers, and the 128 * sum(q)
  // start value of each of the lane's kM partial dots
  int qr[kM][NC][2];
  int bias[kM];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    int qs = 0;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int2 v2 = *reinterpret_cast<const int2*>(
          qg + m * V + c * kI8Chunk + lane * 8);
      qr[m][c][0] = v2.x;
      qr[m][c][1] = v2.y;
      qs = __dp4a(v2.x, 0x01010101, qs);
      qs = __dp4a(v2.y, 0x01010101, qs);
    }
    bias[m] = 128 * qs;
  }

#pragma unroll 2
  for (int r = warp; r < kRows; r += kWarps) {
    const uint8_t* trow = tiles + (row0 + r) * V;
    int2 t[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      t[c] = *reinterpret_cast<const int2*>(trow + c * kI8Chunk + lane * 8);
    }
    int acc[kM];
#pragma unroll
    for (int m = 0; m < kM; ++m) acc[m] = bias[m];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      // u8 - 128 as int8, four lanes at a time
      const int t0 = t[c].x ^ 0x80808080;
      const int t1 = t[c].y ^ 0x80808080;
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        acc[m] = __dp4a(qr[m][c][0], t0, acc[m]);
        acc[m] = __dp4a(qr[m][c][1], t1, acc[m]);
      }
    }
    const int dot = warp_transpose_sum<int, kM>(acc, lane);
    if (lane % kSpread == 0) {
      s_out[(lane / kSpread) * kRows + r] =
          static_cast<float>(dot) * tile_scale[row0 + r];
    }
  }
  __syncthreads();
}
