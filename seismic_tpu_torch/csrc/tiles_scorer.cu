// Per-(query, list) pair doc-tile scorer of the engine path.
//
// Replaces: seismic_tpu/ops/pallas_tiles.py::score_tiles_pallas (the
// pallas_call at :88), the fused scorer behind
// seismic_tpu/search/engine.py::_tiles_search.
//
// For pair p whose list's region starts at subtile s_p = region_start[p]
// (128-row units of the aligned tile layout) and row r < ll_pad:
//   out[p, r] = tile_scale[s_p*128 + r]
//               * sum_v f32(u8 tiles[s_p*128 + r, v]) * qloc[p, v]
// The 128-row subtiles that start at or past pair_len[p], the list's
// length, are not read and their outputs are 0; the TPU kernel streams all
// ll_pad rows, and its caller masks the rows past the length as this
// one's does.
//
// Design: one 256-thread block per (pair, 128-row subtile). Every lane
// keeps its 16-column groups of qloc[p] in registers (V / 32 floats), so
// the only traffic in the row loop is the tile itself: a warp reads one
// row as 16-byte loads on neighbouring addresses (512 bytes a load), four
// rows in flight, accumulates in f32 and reduces each row over the warp
// with shuffles. The TPU kernel's (pair-group, subtile, pair-in-group)
// grid, its 8-pair padding and the [*, 8, 128] replicated scale were
// Mosaic block rules and are not carried over.
//
// Bound on an H100: bytes. Each pair streams its list's real subtiles
// (128 * V bytes each) at 3.35 TB/s; the 2 * rows * V f32 operations are
// an order of magnitude under the CUDA cores' rate. Pairs of one batch
// that share a list find its tiles in the L2 cache.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSub = 128;                      // rows per subtile
constexpr int kRowsPerWarp = kSub / kWarps;    // 16
constexpr int kRowsInFlight = 4;
constexpr int kChunk = 32 * 16;                // columns one warp load covers

__device__ __forceinline__ float dot16(const uint4 w, const float* q) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float t = static_cast<float>((words[i] >> (8 * j)) & 0xffu);
      acc = fmaf(t, q[4 * i + j], acc);
    }
  }
  return acc;
}

// NCH: 512-column chunks per row (V <= NCH * 512, V % 16 == 0)
template <int NCH>
__global__ void __launch_bounds__(kThreads)
score_tiles_kernel(const uint8_t* __restrict__ tiles,      // [rows, V]
                   const float* __restrict__ tile_scale,   // [rows]
                   const int* __restrict__ region_start,   // [P] subtiles
                   const int* __restrict__ pair_len,       // [P]
                   const float* __restrict__ qloc,         // [P, V]
                   int V, int n_sub,
                   float* __restrict__ out) {              // [P, n_sub*128]
  const int64_t blk = blockIdx.x;
  const int p = static_cast<int>(blk / n_sub);
  const int s = static_cast<int>(blk % n_sub);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* orow = out + blk * kSub;
  if (s * kSub >= pair_len[p]) {
    if (tid < kSub) orow[tid] = 0.0f;
    return;
  }

  float q[NCH][16];
  const float* qrow = qloc + static_cast<int64_t>(p) * V;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int col = c * kChunk + lane * 16;
    if (col < V) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(qrow + col)
                               + i);
        q[c][4 * i + 0] = f.x;
        q[c][4 * i + 1] = f.y;
        q[c][4 * i + 2] = f.z;
        q[c][4 * i + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) q[c][i] = 0.0f;
    }
  }

  const int64_t row0 = (static_cast<int64_t>(region_start[p]) + s) * kSub;
#pragma unroll 1
  for (int i = 0; i < kRowsPerWarp; i += kRowsInFlight) {
    const int r0 = warp * kRowsPerWarp + i;
    uint4 w[kRowsInFlight][NCH];
#pragma unroll
    for (int j = 0; j < kRowsInFlight; ++j) {
      const uint8_t* trow = tiles + (row0 + r0 + j) * V;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int col = c * kChunk + lane * 16;
        w[j][c] = col < V
                      ? __ldg(reinterpret_cast<const uint4*>(trow + col))
                      : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    float acc[kRowsInFlight];
#pragma unroll
    for (int j = 0; j < kRowsInFlight; ++j) {
      float a = 0.0f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) a += dot16(w[j][c], q[c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
      }
      acc[j] = a;
    }
    if (lane < kRowsInFlight) {
      float a = acc[0];
#pragma unroll
      for (int j = 1; j < kRowsInFlight; ++j) {
        if (lane == j) a = acc[j];
      }
      orow[r0 + lane] = __fmul_rn(a, tile_scale[row0 + r0 + lane]);
    }
  }
}

}  // namespace

extern "C" {

int seismic_score_tiles_max_v() { return 4 * kChunk; }

// tiles u8 [rows, V]; tile_scale f32 [rows]; region_start int32 [P];
// pair_len int32 [P]; qloc f32 [P, V]; out f32 [P, n_sub * 128].
// Returns cudaGetLastError(), or -1 for a V the kernel does not take.
int seismic_score_tiles(const uint8_t* tiles, const float* tile_scale,
                        const int* region_start, const int* pair_len,
                        const float* qloc, int P, int V, int n_sub,
                        float* out, cudaStream_t stream) {
  if (V <= 0 || V % 16 != 0 || V > 4 * kChunk) return -1;
  if (P > 0 && n_sub > 0) {
    const int64_t blocks = static_cast<int64_t>(P) * n_sub;
    if (blocks > 0x7fffffffLL) return -1;
    const unsigned grid = static_cast<unsigned>(blocks);
    if (V <= kChunk) {
      score_tiles_kernel<1><<<grid, kThreads, 0, stream>>>(
          tiles, tile_scale, region_start, pair_len, qloc, V, n_sub, out);
    } else if (V <= 2 * kChunk) {
      score_tiles_kernel<2><<<grid, kThreads, 0, stream>>>(
          tiles, tile_scale, region_start, pair_len, qloc, V, n_sub, out);
    } else {
      score_tiles_kernel<4><<<grid, kThreads, 0, stream>>>(
          tiles, tile_scale, region_start, pair_len, qloc, V, n_sub, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
