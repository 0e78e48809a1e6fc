// Slot-major grouped int8 doc-tile scorer (one work item = one group x one
// super-tile of csub 128-row subtiles).
//
// Replaces: seismic_tpu/ops/pallas_grouped.py::_score_grouped_i8 with
// unroll = 1 (the pallas_call at :318), the scorer of the API's grouped
// route, with its packed epilogue (pack_epilogue.cuh) when pack_idx is set.
//
// For each work item w, with g = work_g[w], s = work_s[w], ROWS = csub * 128
// and tile rows R0 = work_region[w] * ROWS .. R0 + ROWS - 1:
//   out[g, m, s*ROWS + r] = (float)(sum_v q[g, m, v] * u8[R0 + r, v])
//                           * tile_scale[R0 + r]
// for the group's M query slots (M % 8 == 0, csub >= 1, as JAX's kernel
// asks). The dot is exact int32; the per-pair scale is applied later, in
// the regroup (search/grouped.py), in the same order as the JAX program:
// (f32(dot) * tile_scale) * pair_scale.
// With pack_idx the block goes through the packed epilogue instead and
// lands in out[g, m, s*STEP + c], STEP = ROWS / pack_window, as int32.
// Output blocks that no work item covers are left as they are (the caller
// masks them by list length, as on the TPU).
//
// Design: one 256-thread block per work item runs score_item_mma
// (grouped_i8_mma.cuh: each warp streams its rows in 64-byte k-slices
// through a cp.async ring and multiplies them on the int8 tensor cores,
// mma.sync m16n8k32 u8 x s8, against the group's queries staged in shared
// memory) into a [M, ROWS] f32 block in shared memory and stores it with
// 16-byte stores, or through store_packed. V is any multiple of 128, as
// on the TPU: one instance takes V at run time and the launch sizes the
// query staging to one V chunk (M * V bytes up to the cap that 227 KB of
// shared memory leaves beside the rings, seismic_score_grouped_i8_max_v;
// past it the block walks V in chunks). M past 32 runs in chunks of slots
// along the grid and csub past 4 in parts of each item
// (grouped_i8_mma.cuh).
//
// Bound on an H100: the tile bytes (ROWS*V per distinct super-tile, read
// once) over the 3.35 TB/s memory rate; the 2*M*ROWS*V int8 operations per
// item are far below the tensor-core rate.

#include <cstdint>
#include <cuda_runtime.h>

#include "grouped_i8_mma.cuh"
#include "pack_epilogue.cuh"

namespace {

// kPack: the packed epilogue, a compile-time choice so that the plain
// store's kernel carries none of its code. The block scores the slots
// [m0, m0 + kM) of its item's group, m0 = m_base + blockIdx.y * kM, of M,
// over rows [r0, r0 + kRows) of the item's R rows (one part of them when
// R > kRows: a launch a part).
template <int kM, int kRows, bool kPack>
__global__ void __launch_bounds__(
    kMmaThreads, (MmaMinBlocks<kM, kRows, MmaU8S8>::value))
score_grouped_i8_kernel(const uint8_t* __restrict__ tiles,    // [rows, V]
                        const float* __restrict__ tile_scale,  // [rows]
                        const int8_t* __restrict__ q,          // [G_cap, M, V]
                        const int* __restrict__ work_region,   // [W_cap]
                        const int* __restrict__ work_g,
                        const int* __restrict__ work_s,
                        int V, int M, int m_base, int R, int r0, int ll_max,
                        int idx_mask, int pack_window,
                        void* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t smem[];
  float* s_out = reinterpret_cast<float*>(smem);

  const int w = blockIdx.x;
  const int g = work_g[w];
  const int s = work_s[w];
  const int m0 = m_base + blockIdx.y * kM;
  score_item_mma<kM, kRows>(
      tiles, tile_scale, q + (static_cast<int64_t>(g) * M + m0) * V, V,
      static_cast<int64_t>(work_region[w]) * R + r0, smem, s_out);

  const int64_t slot0 = static_cast<int64_t>(g) * M + m0;
  if constexpr (kPack) {  // packed int32 [G_cap, M, ll_max / pack_window]
    const int64_t stride = ll_max / pack_window;
    int* dst = static_cast<int*>(out) + slot0 * stride +
               static_cast<int64_t>(s) * (R / pack_window);
    if (R == kRows) {
      store_packed<kM, kRows>(s_out, dst, stride, s * R, idx_mask,
                              pack_window, threadIdx.x, kMmaThreads);
    } else {
      store_packed_part<kM, kRows>(s_out, dst, stride, s * R, r0,
                                   R / pack_window, idx_mask, threadIdx.x,
                                   kMmaThreads);
    }
  } else {  // f32 [G_cap, M, ll_max]
    store_scores<kM, kRows>(
        s_out,
        static_cast<float*>(out) + slot0 * ll_max +
            static_cast<int64_t>(s) * R + r0,
        ll_max, threadIdx.x, kMmaThreads);
  }
}

// one launch a part of the item's R rows, in stream order (the packed
// epilogue's running max reads the parts before it)
template <int kM, int kRows, bool kPack>
int launch_one(const uint8_t* tiles, const float* tile_scale, const int8_t* q,
               const int* work_region, const int* work_g, const int* work_s,
               int W_cap, int V, int M, int m_base, int n_y, int R,
               int ll_max, int idx_mask, int pack_window, void* out,
               cudaStream_t stream) {
  static bool opted_in[kMaxDevices];
  constexpr int kQBytes = MmaU8S8::kParts;  // bytes a query value
  auto kernel = score_grouped_i8_kernel<kM, kRows, kPack>;
  const cudaError_t e = opt_in_smem(
      kernel,
      mma_ring_smem(kM, kRows, mma_max_v(kM, kRows, kQBytes), kQBytes),
      opted_in);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem = mma_launch_smem(kM, kRows, V, kQBytes);
  for (int r0 = 0; r0 < R; r0 += kRows) {
    kernel<<<dim3(W_cap, n_y), kMmaThreads, smem, stream>>>(
        tiles, tile_scale, q, work_region, work_g, work_s, V, M, m_base, R,
        r0, ll_max, idx_mask, pack_window, out);
  }
  return 0;
}

template <int kM, int kRows>
int launch(const uint8_t* tiles, const float* tile_scale, const int8_t* q,
           const int* work_region, const int* work_g, const int* work_s,
           int W_cap, int V, int M, int m_base, int n_y, int R, int ll_max,
           int idx_mask, int pack_window, void* out, cudaStream_t stream) {
  return pack_window > 0
             ? launch_one<kM, kRows, true>(
                   tiles, tile_scale, q, work_region, work_g, work_s, W_cap,
                   V, M, m_base, n_y, R, ll_max, idx_mask, pack_window, out,
                   stream)
             : launch_one<kM, kRows, false>(
                   tiles, tile_scale, q, work_region, work_g, work_s, W_cap,
                   V, M, m_base, n_y, R, ll_max, idx_mask, pack_window, out,
                   stream);
}

}  // namespace

extern "C" {

// The widest V one chunk holds at M query slots and csub: the warps'
// rings plus the [min(M, 32), V] int8 queries of the instance that serves
// them within 227 KB of shared memory, V a multiple of 128 (a wider V is
// walked in chunks); 0 for a shape past JAX's rule.
int seismic_score_grouped_i8_max_v(int M, int csub) {
  return mma_chunk_v(M, csub, MmaU8S8::kParts);
}

// M % 8 == 0; csub >= 1; V % 128 == 0; ll_max a multiple of csub * 128.
// pack_window 0 writes f32 [G_cap, M, ll_max]; pack_window >= 1 writes
// the packed int32 [G_cap, M, ll_max / pack_window] with idx_mask =
// 2^idx_bits - 1.
int seismic_score_grouped_i8(const uint8_t* tiles, const float* tile_scale,
                             const int8_t* q, const int* work_region,
                             const int* work_g, const int* work_s, int W_cap,
                             int V, int M, int csub, int ll_max,
                             int idx_mask, int pack_window, void* out,
                             cudaStream_t stream) {
  if (W_cap > 0) {
    if (!mma_shape_ok(M, csub, V)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int cc = chunk_csub(csub);
    const int rc = for_m_chunks(M, [&](int km, int m_base, int n_y) {
      return dispatch_shape(km, cc, [&](auto m, auto rows) {
        return launch<decltype(m)::value, decltype(rows)::value>(
            tiles, tile_scale, q, work_region, work_g, work_s, W_cap, V, M,
            m_base, n_y, csub * kSubRows, ll_max, idx_mask, pack_window,
            out, stream);
      });
    });
    if (rc != 0) return rc;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
