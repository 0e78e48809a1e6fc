// Grouped int8 doc-tile scorer (one work item = one group x one subtile).
//
// Replaces: seismic_tpu/ops/pallas_grouped.py::_score_grouped_i8 with
// unroll = 1 (the pallas_call at :318), the scorer of the API's grouped
// route.
//
// For each work item w, with g = work_g[w], s = work_s[w] and tile rows
// R0 = work_region[w] * 128 .. R0 + 127:
//   out[g, m, s*128 + r] = (float)(sum_v q[g, m, v] * u8[R0 + r, v])
//                          * tile_scale[R0 + r]
// for the group's M = 8 query slots. The dot is exact int32; the per-pair
// scale is applied later, in the regroup (search/grouped.py), in the same
// order as the JAX program: (f32(dot) * tile_scale) * pair_scale.
// Output blocks that no work item covers are left as they are (the caller
// masks them by list length, as on the TPU).
//
// Design: one 256-thread block per work item. The block stages the
// group's [8, V] int8 queries in shared memory; each warp copies its lane
// slice into registers (lane l holds bytes [c*256 + 8l, +8) of every
// query row, c < V/256). Warps then walk the tile's 128 rows, one row at a
// time: each lane loads 8 bytes per 256-byte chunk (coalesced), recentres
// the u8 codes to int8 with one XOR (u8 - 128), and accumulates 8 dot
// products with __dp4a; the 128 * sum(q) correction is folded into the
// start value. A transposing butterfly of 9 shuffles reduces the 8 lane
// partials, leaving the dot of query m in lane 4m. The [8, 128] f32 result
// is staged in shared memory and written with coalesced 16-byte stores.
//
// Bound on an H100: the tile bytes (128*V per item, read once) over the
// 3.35 TB/s memory rate; the 2*8*128*V int8 operations per item are far
// below the tensor-core rate. The design streams each tile exactly once
// and keeps the queries in registers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kM = 8;         // query slots per group
constexpr int kRows = 128;    // tile rows per work item (csub = 1)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;   // bytes of a row one warp covers per load

__device__ __forceinline__ int dp4a(int a, int b, int c) {
  return __dp4a(a, b, c);
}

template <int NC>  // NC = V / 256 chunks per row
__global__ void __launch_bounds__(kThreads)
score_grouped_i8_kernel(const uint8_t* __restrict__ tiles,   // [rows, V]
                        const float* __restrict__ tile_scale,  // [rows]
                        const int8_t* __restrict__ q,         // [G_cap, 8, V]
                        const int* __restrict__ work_region,  // [W_cap]
                        const int* __restrict__ work_g,
                        const int* __restrict__ work_s,
                        int ll_max,
                        float* __restrict__ out) {            // [G_cap, 8, ll_max]
  constexpr int V = NC * kChunk;
  __shared__ __align__(16) int8_t s_q[kM * V];
  __shared__ __align__(16) float s_out[kM * kRows];

  const int w = blockIdx.x;
  const int g = work_g[w];
  const int s = work_s[w];
  const int64_t row0 = static_cast<int64_t>(work_region[w]) * kRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // stage the group's queries: kM*V bytes as 16-byte words
  {
    const int4* src = reinterpret_cast<const int4*>(
        q + static_cast<int64_t>(g) * kM * V);
    int4* dst = reinterpret_cast<int4*>(s_q);
    for (int i = tid; i < kM * V / 16; i += kThreads) dst[i] = src[i];
  }
  __syncthreads();

  // lane slice of every query row in registers, and the 128 * sum(q)
  // start value of each of the lane's 8 partial dots
  int qr[kM][NC][2];
  int bias[kM];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    int qs = 0;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int2 v2 = *reinterpret_cast<const int2*>(
          s_q + m * V + c * kChunk + lane * 8);
      qr[m][c][0] = v2.x;
      qr[m][c][1] = v2.y;
      qs = dp4a(v2.x, 0x01010101, qs);
      qs = dp4a(v2.y, 0x01010101, qs);
    }
    bias[m] = 128 * qs;
  }

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
        acc[m] = dp4a(qr[m][c][0], t0, acc[m]);
        acc[m] = dp4a(qr[m][c][1], t1, acc[m]);
      }
    }
    // transposing butterfly: 8 values over 32 lanes in 4 + 2 + 1 + 2
    // shuffles; afterwards lane l holds the dot of query (l >> 2) & 7
    {
      const bool hi = lane & 16;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int send = hi ? acc[j] : acc[j + 4];
        const int keep = hi ? acc[j + 4] : acc[j];
        acc[j] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
      }
    }
    {
      const bool hi = lane & 8;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int send = hi ? acc[j] : acc[j + 2];
        const int keep = hi ? acc[j + 2] : acc[j];
        acc[j] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
      }
    }
    {
      const bool hi = lane & 4;
      const int send = hi ? acc[0] : acc[1];
      const int keep = hi ? acc[1] : acc[0];
      acc[0] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
    }
    acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], 2);
    acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], 1);
    if ((lane & 3) == 0) {
      const int m = lane >> 2;
      s_out[m * kRows + r] =
          static_cast<float>(acc[0]) * tile_scale[row0 + r];
    }
  }
  __syncthreads();

  // [8, 128] block -> out[g, m, s*128 : s*128 + 128], 16-byte stores
  float* ob = out + static_cast<int64_t>(g) * kM * ll_max +
              static_cast<int64_t>(s) * kRows;
  for (int i = tid; i < kM * kRows / 4; i += kThreads) {
    const int m = i / (kRows / 4);
    const int c4 = i % (kRows / 4);
    reinterpret_cast<float4*>(ob + static_cast<int64_t>(m) * ll_max)[c4] =
        reinterpret_cast<const float4*>(s_out + m * kRows)[c4];
  }
}

template <int NC>
void launch(const uint8_t* tiles, const float* tile_scale, const int8_t* q,
            const int* work_region, const int* work_g, const int* work_s,
            int W_cap, int ll_max, float* out, cudaStream_t stream) {
  score_grouped_i8_kernel<NC><<<W_cap, kThreads, 0, stream>>>(
      tiles, tile_scale, q, work_region, work_g, work_s, ll_max, out);
}

}  // namespace

extern "C" {

// V must be 256, 512, 1024 or 2048; M = 8; ll_max a multiple of 128.
int seismic_score_grouped_i8(const uint8_t* tiles, const float* tile_scale,
                             const int8_t* q, const int* work_region,
                             const int* work_g, const int* work_s, int W_cap,
                             int V, int ll_max, float* out,
                             cudaStream_t stream) {
  if (W_cap > 0) {
    switch (V) {
      case 256:
        launch<1>(tiles, tile_scale, q, work_region, work_g, work_s, W_cap,
                  ll_max, out, stream);
        break;
      case 512:
        launch<2>(tiles, tile_scale, q, work_region, work_g, work_s, W_cap,
                  ll_max, out, stream);
        break;
      case 1024:
        launch<4>(tiles, tile_scale, q, work_region, work_g, work_s, W_cap,
                  ll_max, out, stream);
        break;
      case 2048:
        launch<8>(tiles, tile_scale, q, work_region, work_g, work_s, W_cap,
                  ll_max, out, stream);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
