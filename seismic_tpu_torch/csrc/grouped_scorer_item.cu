// Item-major grouped int8 doc-tile scorer (one work item = one group x one
// super-tile of csub 128-row subtiles).
//
// Replaces: seismic_tpu/ops/pallas_grouped.py::_score_grouped_i8_item (the
// pallas_call at :411), which _score_grouped_i8 takes when unroll > 1: the
// scorer of the bench headline path (kernel_unroll 8, csub 2, M 8 or 16).
//
// For each work item w < W_cap, with g = work_g[w], ROWS = csub * 128 and
// tile rows R0 = work_region[w] * ROWS .. R0 + ROWS - 1:
//   out[w, m, r] = (float)(sum_v q[g, m, v] * u8[R0 + r, v])
//                  * tile_scale[R0 + r]
// for the group's M query slots. The dot is exact int32; the per-pair scale
// is applied later, in the regroup (search/grouped.py), in the same order
// as the JAX program: (f32(dot) * tile_scale) * pair_scale. The output is
// item-major [W_cap, M, ROWS]: a group's items are consecutive in the work
// list, and the caller regroups them by the per-group item prefix sum.
// Every item is written, padding items included (they point at the
// all-zero region), so the output holds no uninitialised memory.
//
// The TPU kernel's unroll U (U items per grid step, to amortise Mosaic's
// per-step cost) has no counterpart here: blocks are scheduled by the
// hardware, so one block per item is the whole design, and U only survives
// as the caller's W_cap % U == 0 contract.
//
// Design: one 256-thread block per work item. Each lane keeps its slice of
// the group's M query rows in registers, read straight from device memory
// (lane l holds bytes [c*256 + 8l, +8) of every row, c < V/256; 2*M*V/256
// registers, 64 at M=16, V=512). Warps walk the item's ROWS rows, one row
// per warp at a time, two in flight: each lane loads 8 bytes per 256-byte
// chunk (coalesced), recentres the u8 codes to int8 with one XOR (u8 - 128)
// and accumulates M dot products with __dp4a; the 128 * sum(q) correction
// is folded into the start value. A transposing butterfly of M - 1 shuffles
// plus log2(32/M) plain ones reduces the M lane partials, leaving the dot of
// query m in lanes m * 32/M ... The [M, ROWS] f32 block (16 KB at M=16,
// csub=2) is staged in shared memory and written with 16-byte stores.
//
// Bound on an H100: the tile bytes (ROWS*V per distinct super-tile, read
// once) over the 3.35 TB/s memory rate; the 2*M*ROWS*V int8 operations per
// item are far below the tensor-core rate. The design streams each tile
// once per item and keeps the queries in registers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSub = 128;     // rows per subtile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;   // bytes of a row one warp covers per load

// Sum each of the lane's kM partial dots over the warp. Step s (offset
// 16 >> s) halves the values a lane carries: lanes with that offset bit set
// keep the upper half and add their partner's upper half, the others the
// lower; once one value is left, plain shuffles finish the sum. Afterwards
// lane l holds the dot of query l / (32 / kM). The steps are unrolled at
// compile time (if constexpr), so every acc index is a constant and acc
// stays in registers.
template <int kM, int kStep = 0>
__device__ __forceinline__ int warp_transpose_sum(int (&acc)[kM], int lane) {
  constexpr int o = 16 >> kStep;
  if constexpr ((kM >> kStep) > 1) {
    constexpr int half = kM >> (kStep + 1);
    const bool hi = lane & o;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const int send = hi ? acc[j] : acc[j + half];
      const int keep = hi ? acc[j + half] : acc[j];
      acc[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
    return warp_transpose_sum<kM, kStep + 1>(acc, lane);
  } else {
#pragma unroll
    for (int p = o; p >= 1; p >>= 1) {
      acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], p);
    }
    return acc[0];
  }
}

template <int kM, int kRows, int NC>  // NC = V / 256 chunks per row
__global__ void __launch_bounds__(kThreads)
score_item_kernel(const uint8_t* __restrict__ tiles,     // [rows, V]
                  const float* __restrict__ tile_scale,  // [rows]
                  const int8_t* __restrict__ q,          // [G_cap, kM, V]
                  const int* __restrict__ work_region,   // [W_cap]
                  const int* __restrict__ work_g,        // [W_cap]
                  float* __restrict__ out) {             // [W_cap, kM, kRows]
  constexpr int V = NC * kChunk;
  constexpr int kSpread = 32 / kM;  // lanes that end up holding one query
  __shared__ __align__(16) float s_out[kM * kRows];

  const int w = blockIdx.x;
  const int g = work_g[w];
  const int64_t row0 = static_cast<int64_t>(work_region[w]) * kRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // lane slice of every query row in registers, and the 128 * sum(q)
  // start value of each of the lane's kM partial dots
  const int8_t* qg = q + static_cast<int64_t>(g) * kM * V;
  int qr[kM][NC][2];
  int bias[kM];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    int qs = 0;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int2 v2 = *reinterpret_cast<const int2*>(
          qg + m * V + c * kChunk + lane * 8);
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
      t[c] = *reinterpret_cast<const int2*>(trow + c * kChunk + lane * 8);
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
    const int dot = warp_transpose_sum<kM>(acc, lane);
    if (lane % kSpread == 0) {
      s_out[(lane / kSpread) * kRows + r] =
          static_cast<float>(dot) * tile_scale[row0 + r];
    }
  }
  __syncthreads();

  // the item's [kM, kRows] block is contiguous in the output
  float4* ob = reinterpret_cast<float4*>(
      out + static_cast<int64_t>(w) * kM * kRows);
  const float4* so = reinterpret_cast<const float4*>(s_out);
  for (int i = tid; i < kM * kRows / 4; i += kThreads) ob[i] = so[i];
}

template <int kM, int kRows>
int launch(const uint8_t* tiles, const float* tile_scale, const int8_t* q,
           const int* work_region, const int* work_g, int W_cap, int V,
           float* out, cudaStream_t stream) {
  switch (V) {
    case 256:
      score_item_kernel<kM, kRows, 1><<<W_cap, kThreads, 0, stream>>>(
          tiles, tile_scale, q, work_region, work_g, out);
      return 0;
    case 512:
      score_item_kernel<kM, kRows, 2><<<W_cap, kThreads, 0, stream>>>(
          tiles, tile_scale, q, work_region, work_g, out);
      return 0;
    case 1024:
      score_item_kernel<kM, kRows, 4><<<W_cap, kThreads, 0, stream>>>(
          tiles, tile_scale, q, work_region, work_g, out);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// M must be 8 or 16, csub 1 or 2, V 256, 512 or 1024.
int seismic_score_grouped_i8_item(const uint8_t* tiles,
                                  const float* tile_scale, const int8_t* q,
                                  const int* work_region, const int* work_g,
                                  int W_cap, int V, int M, int csub,
                                  float* out, cudaStream_t stream) {
  if (W_cap > 0) {
    int rc;
    if (M == 8 && csub == 1) {
      rc = launch<8, kSub>(tiles, tile_scale, q, work_region, work_g, W_cap,
                           V, out, stream);
    } else if (M == 8 && csub == 2) {
      rc = launch<8, 2 * kSub>(tiles, tile_scale, q, work_region, work_g,
                               W_cap, V, out, stream);
    } else if (M == 16 && csub == 1) {
      rc = launch<16, kSub>(tiles, tile_scale, q, work_region, work_g, W_cap,
                            V, out, stream);
    } else if (M == 16 && csub == 2) {
      rc = launch<16, 2 * kSub>(tiles, tile_scale, q, work_region, work_g,
                                W_cap, V, out, stream);
    } else {
      rc = static_cast<int>(cudaErrorInvalidValue);
    }
    if (rc != 0) return rc;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
