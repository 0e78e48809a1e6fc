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
// all-zero region), so the output holds no uninitialised memory. With
// pack_idx the block goes through the packed epilogue (pack_epilogue.cuh)
// and lands in out[w, m, c], c < STEP = ROWS / pack_window, as int32, its
// row index counted from work_s[w] * ROWS.
//
// The TPU kernel's unroll U (U items per grid step, to amortise Mosaic's
// per-step cost) has no counterpart here: blocks are scheduled by the
// hardware, so one block per item is the whole design, and U only survives
// as the caller's W_cap % U == 0 contract.
//
// Bound on an H100: the tile bytes (ROWS * V per distinct super-tile, read
// once; 128 KB an item at csub 2, V 512) over the 3.35 TB/s memory rate,
// plus the f32 output. The 2 * M * ROWS * V int8 operations of an item are
// what the int8 tensor cores are for: at the headline plan they take 0.1 ms
// at 1,979 TOP/s, where the former __dp4a form needed at least 1.67 ms of
// CUDA-core issue, above the byte bound.
//
// Design: one 256-thread block per work item runs score_item_mma
// (grouped_i8_mma.cuh): each warp streams its 16 or 32 rows in 64-byte
// k-slices through a 4-stage cp.async ring (bank-conflict-free 64-byte
// pitch) and multiplies them on the tensor cores (mma.sync m16n8k32, u8 x
// s8 -> s32) against the group's queries, staged once in shared memory;
// three blocks fit on an SM at csub 2, V 512, so one block's epilogue
// overlaps the others' loads. The [M, ROWS] f32 block is staged in the
// freed rings and written with 16-byte stores, or through store_packed
// (K5, a compile-time variant).

#include <cstdint>
#include <cuda_runtime.h>

#include "grouped_i8_mma.cuh"
#include "pack_epilogue.cuh"

namespace {

constexpr int kSub = 128;  // rows per subtile

// kPack: the packed epilogue, a compile-time choice so that the plain
// store's kernel carries none of its code
template <int kM, int kRows, int V, bool kPack>
__global__ void __launch_bounds__(kMmaThreads, 2)
score_item_kernel(const uint8_t* __restrict__ tiles,     // [rows, V]
                  const float* __restrict__ tile_scale,  // [rows]
                  const int8_t* __restrict__ q,          // [G_cap, kM, V]
                  const int* __restrict__ work_region,   // [W_cap]
                  const int* __restrict__ work_g,        // [W_cap]
                  const int* __restrict__ work_s,        // [W_cap] or null
                  int idx_mask, int pack_window,
                  void* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t smem[];
  float* s_out = reinterpret_cast<float*>(smem);

  const int w = blockIdx.x;
  const int col0 = kPack ? work_s[w] * kRows : 0;  // read before the dots
  score_item_mma<kM, kRows, V>(
      tiles, tile_scale, q + static_cast<int64_t>(work_g[w]) * kM * V,
      static_cast<int64_t>(work_region[w]) * kRows, smem, s_out);

  // the item's block is contiguous in the output
  if constexpr (kPack) {  // packed int32 [W_cap, kM, kRows / pack_window]
    const int step = kRows / pack_window;
    store_packed<kM, kRows>(
        s_out, static_cast<int*>(out) + static_cast<int64_t>(w) * kM * step,
        step, col0, idx_mask, pack_window, threadIdx.x, kMmaThreads);
  } else {  // f32 [W_cap, kM, kRows]
    store_scores<kM, kRows>(
        s_out, static_cast<float*>(out) + static_cast<int64_t>(w) * kM * kRows,
        kRows, threadIdx.x, kMmaThreads);
  }
}

template <int kM, int kRows, int V, bool kPack>
int launch_one(const uint8_t* tiles, const float* tile_scale, const int8_t* q,
               const int* work_region, const int* work_g, const int* work_s,
               int W_cap, int idx_mask, int pack_window, void* out,
               cudaStream_t stream) {
  static bool opted_in[kMaxDevices];
  constexpr int smem = mma_item_smem<kM, kRows, V>();
  const cudaError_t e = opt_in_smem(score_item_kernel<kM, kRows, V, kPack>,
                                    smem, opted_in);
  if (e != cudaSuccess) return static_cast<int>(e);
  score_item_kernel<kM, kRows, V, kPack><<<W_cap, kMmaThreads, smem, stream>>>(
      tiles, tile_scale, q, work_region, work_g, work_s, idx_mask,
      pack_window, out);
  return 0;
}

template <int kM, int kRows, int V>
int launch_v(const uint8_t* tiles, const float* tile_scale, const int8_t* q,
             const int* work_region, const int* work_g, const int* work_s,
             int W_cap, int idx_mask, int pack_window, void* out,
             cudaStream_t stream) {
  if (pack_window > 0) {
    return launch_one<kM, kRows, V, true>(tiles, tile_scale, q, work_region,
                                          work_g, work_s, W_cap, idx_mask,
                                          pack_window, out, stream);
  }
  return launch_one<kM, kRows, V, false>(tiles, tile_scale, q, work_region,
                                         work_g, work_s, W_cap, idx_mask,
                                         pack_window, out, stream);
}

template <int kM, int kRows>
int launch(const uint8_t* tiles, const float* tile_scale, const int8_t* q,
           const int* work_region, const int* work_g, const int* work_s,
           int W_cap, int V, int idx_mask, int pack_window, void* out,
           cudaStream_t stream) {
  switch (V) {
    case 256:
      return launch_v<kM, kRows, 256>(tiles, tile_scale, q, work_region,
                                      work_g, work_s, W_cap, idx_mask,
                                      pack_window, out, stream);
    case 512:
      return launch_v<kM, kRows, 512>(tiles, tile_scale, q, work_region,
                                      work_g, work_s, W_cap, idx_mask,
                                      pack_window, out, stream);
    case 1024:
      return launch_v<kM, kRows, 1024>(tiles, tile_scale, q, work_region,
                                       work_g, work_s, W_cap, idx_mask,
                                       pack_window, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// M must be 8 or 16, csub 1 or 2, V 256, 512 or 1024. pack_window 0 writes
// f32 [W_cap, M, csub*128]; pack_window >= 1 writes the packed int32
// [W_cap, M, csub*128 / pack_window] with idx_mask = 2^idx_bits - 1 and
// needs work_s.
int seismic_score_grouped_i8_item(const uint8_t* tiles,
                                  const float* tile_scale, const int8_t* q,
                                  const int* work_region, const int* work_g,
                                  const int* work_s, int W_cap, int V, int M,
                                  int csub, int idx_mask, int pack_window,
                                  void* out, cudaStream_t stream) {
  if (W_cap > 0) {
    int rc;
    if (M == 8 && csub == 1) {
      rc = launch<8, kSub>(tiles, tile_scale, q, work_region, work_g, work_s,
                           W_cap, V, idx_mask, pack_window, out, stream);
    } else if (M == 8 && csub == 2) {
      rc = launch<8, 2 * kSub>(tiles, tile_scale, q, work_region, work_g,
                               work_s, W_cap, V, idx_mask, pack_window, out,
                               stream);
    } else if (M == 16 && csub == 1) {
      rc = launch<16, kSub>(tiles, tile_scale, q, work_region, work_g, work_s,
                            W_cap, V, idx_mask, pack_window, out, stream);
    } else if (M == 16 && csub == 2) {
      rc = launch<16, 2 * kSub>(tiles, tile_scale, q, work_region, work_g,
                                work_s, W_cap, V, idx_mask, pack_window, out,
                                stream);
    } else {
      rc = static_cast<int>(cudaErrorInvalidValue);
    }
    if (rc != 0) return rc;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
