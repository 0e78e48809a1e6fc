// Slot-major grouped doc-tile scorer with bf16 or f32 query operands (one
// work item = one group x one super-tile of csub 128-row subtiles).
//
// Replaces: seismic_tpu/ops/pallas_grouped.py::score_grouped_pallas with
// compute_dtype "bf16" / "f32" (the pallas_call at :168; bodies
// kernel_centered :109 and kernel_fixup :93), the scorer of the
// GroupedParams defaults and of the on-device correctness gate, with its
// packed epilogue (pack_epilogue.cuh) when pack_idx is set.
//
// For each work item w, with g = work_g[w], s = work_s[w], ROWS = csub * 128
// and tile rows R0 = work_region[w] * ROWS .. R0 + ROWS - 1:
//   centred (qsum given):
//     out[g, m, s*ROWS + r] = (sum_v qc[g, m, v] * (u8[R0 + r, v] - 128)
//                              + qsum[g, m]) * tile_scale[R0 + r]
//   fixup (no qsum):
//     out[g, m, s*ROWS + r] = (sum_v qc[g, m, v] * u8[R0 + r, v])
//                             * tile_scale[R0 + r]
// where qc is the f32 query projection, rounded to bf16 (nearest even) in
// bf16 mode and kept as it is in f32 mode. The caller sums qsum =
// 128 * sum_v q from the unrounded f32 projection, as the JAX program does,
// so the centred form is not q . u8 in bf16 mode. With pack_idx the block
// goes through the packed epilogue instead and lands in
// out[g, m, s*STEP + c], STEP = ROWS / pack_window, as int32. Output blocks
// that no work item covers are left as they are.
//
// Bound on an H100: the tile bytes (ROWS * V per distinct super-tile, read
// once) plus the f32 queries and the output over the 3.35 TB/s memory
// rate. The 2 * M * ROWS * V operations of an item are what the bf16
// tensor cores are for (989 TFLOP/s; three times as many in f32 mode): on
// the CUDA cores' f32 FMAs (67 TFLOP/s) they and the byte conversions
// cost more than the bytes.
//
// Design: one 256-thread block per work item runs score_item_ring
// (grouped_i8_mma.cuh, the tile body of K4 and K2) with the bf16 policy:
// each warp streams its 16 x csub rows, 128 bytes of each a stage, through
// a 2-stage cp.async ring and multiplies them on the bf16 tensor cores
// (mma.sync m16n8k16, f32 accumulators) against the group's queries,
// staged once a block as bf16 in the rings' k order. Tile bytes are
// converted to bf16 in registers, once per byte and block (u8 - 128 in the
// centred form, u8 in the fixup form: integers below 256, exact). In f32
// mode the queries are staged as three bf16 terms whose sum is q exactly,
// and each A fragment meets all three: every product is exact in f32 and
// only the order of the f32 sum differs from the plain version. The
// epilogue adds qsum (__fadd_rn), scales (__fmul_rn) and stores the
// [M, ROWS] block from the freed rings with 16-byte stores, or through
// store_packed (K5, a compile-time variant). V is any multiple of 128:
// past the cap that 227 KB of shared memory leaves beside the rings
// (seismic_score_grouped_f_max_v; the f32 mode's three terms take 6 bytes
// a query value) the block walks V in chunks, its f32 sums carried
// across them in the same slice order. M past 32 runs in chunks of slots
// along the grid and csub past 4 in parts of each item
// (grouped_i8_mma.cuh).

#include <cstdint>
#include <cuda_runtime.h>

#include "grouped_i8_mma.cuh"
#include "pack_epilogue.cuh"

namespace {

constexpr float kTwo23 = 8388608.0f;

// kTerms: 1 in bf16 mode, 3 in f32 mode. kPack: the packed epilogue. Both
// compile-time, so that each kernel carries only its own code. The block
// scores the slots [m0, m0 + kM) of M, m0 = m_base + blockIdx.y * kM,
// over rows [r0, r0 + kRows) of the item's R rows (one part of them when
// R > kRows: a launch a part).
template <int kM, int kRows, int kTerms, bool kPack>
__global__ void __launch_bounds__(
    kMmaThreads, (MmaMinBlocks<kM, kRows, MmaBf16<kTerms>>::value))
score_grouped_f_kernel(const uint8_t* __restrict__ tiles,     // [rows, V]
                       const float* __restrict__ tile_scale,  // [rows]
                       const float* __restrict__ q,           // [G_cap, M, V]
                       const float* __restrict__ qsum,  // [G_cap, M] or null
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
  const int64_t slot0 = static_cast<int64_t>(g) * M + m0;
  const bool centred = qsum != nullptr;
  const MmaBf16<kTerms> op{centred ? kTwo23 + 128.0f : kTwo23};
  score_item_ring<kM, kRows>(
      op, tiles, tile_scale, q + slot0 * V, centred ? qsum + slot0 : nullptr,
      V, static_cast<int64_t>(work_region[w]) * R + r0, smem, s_out);

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

template <int kM, int kRows, int kTerms, bool kPack>
int launch_one(const uint8_t* tiles, const float* tile_scale, const float* q,
               const float* qsum, const int* work_region, const int* work_g,
               const int* work_s, int W_cap, int V, int M, int m_base,
               int n_y, int R, int ll_max, int idx_mask,
               int pack_window, void* out, cudaStream_t stream) {
  static bool opted_in[kMaxDevices];
  constexpr int kQBytes = MmaBf16<kTerms>::kParts;  // bytes a query value
  auto kernel = score_grouped_f_kernel<kM, kRows, kTerms, kPack>;
  // the opt-in is for the widest V chunk, so one call per device covers
  // every V
  const cudaError_t e = opt_in_smem(
      kernel,
      mma_ring_smem(kM, kRows, mma_max_v(kM, kRows, kQBytes), kQBytes),
      opted_in);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem = mma_launch_smem(kM, kRows, V, kQBytes);
  // one launch a part of the item's R rows, in stream order (the packed
  // epilogue's running max reads the parts before it)
  for (int r0 = 0; r0 < R; r0 += kRows) {
    kernel<<<dim3(W_cap, n_y), kMmaThreads, smem, stream>>>(
        tiles, tile_scale, q, qsum, work_region, work_g, work_s, V, M,
        m_base, R, r0, ll_max, idx_mask, pack_window, out);
  }
  return 0;
}

template <int kM, int kRows, int kTerms>
int launch_terms(const uint8_t* tiles, const float* tile_scale,
                 const float* q, const float* qsum, const int* work_region,
                 const int* work_g, const int* work_s, int W_cap, int V,
                 int M, int m_base, int n_y, int R, int ll_max,
                 int idx_mask, int pack_window, void* out,
                 cudaStream_t stream) {
  return pack_window > 0
             ? launch_one<kM, kRows, kTerms, true>(
                   tiles, tile_scale, q, qsum, work_region, work_g, work_s,
                   W_cap, V, M, m_base, n_y, R, ll_max, idx_mask,
                   pack_window, out, stream)
             : launch_one<kM, kRows, kTerms, false>(
                   tiles, tile_scale, q, qsum, work_region, work_g, work_s,
                   W_cap, V, M, m_base, n_y, R, ll_max, idx_mask,
                   pack_window, out, stream);
}

template <int kM, int kRows>
int launch(const uint8_t* tiles, const float* tile_scale, const float* q,
           const float* qsum, const int* work_region, const int* work_g,
           const int* work_s, int W_cap, int V, int M, int m_base, int n_y,
           int R, int ll_max, int round_bf16, int idx_mask,
           int pack_window, void* out, cudaStream_t stream) {
  return round_bf16
             ? launch_terms<kM, kRows, 1>(tiles, tile_scale, q, qsum,
                                          work_region, work_g, work_s, W_cap,
                                          V, M, m_base, n_y, R, ll_max,
                                          idx_mask, pack_window, out, stream)
             : launch_terms<kM, kRows, 3>(tiles, tile_scale, q, qsum,
                                          work_region, work_g, work_s, W_cap,
                                          V, M, m_base, n_y, R, ll_max,
                                          idx_mask, pack_window, out, stream);
}

}  // namespace

extern "C" {

// The widest V one chunk holds at M query slots and csub: the warps'
// rings plus the [min(M, 32), V] queries (bf16, or three bf16 terms in
// f32 mode) of the instance that serves them within 227 KB of shared
// memory, V a multiple of 128 (a wider V is walked in chunks); 0 for a
// shape past JAX's rule.
int seismic_score_grouped_f_max_v(int M, int csub, int round_bf16) {
  // 2 * terms: MmaBf16<terms>::kParts, bytes a query value
  return mma_chunk_v(M, csub, round_bf16 ? 2 : 6);
}

// M % 8 == 0; csub >= 1; V % 128 == 0; ll_max a multiple of csub * 128;
// qsum f32 [G_cap, M] or null (the fixup form). round_bf16 != 0 rounds
// the queries to bf16, 0 splits them into three bf16 terms (f32 mode).
// pack_window 0 writes f32 [G_cap, M, ll_max]; pack_window >= 1 writes
// the packed int32 [G_cap, M, ll_max / pack_window] with idx_mask =
// 2^idx_bits - 1.
int seismic_score_grouped_f(const uint8_t* tiles, const float* tile_scale,
                            const float* q, const float* qsum,
                            const int* work_region, const int* work_g,
                            const int* work_s, int W_cap, int V, int M,
                            int csub, int ll_max, int round_bf16,
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
            tiles, tile_scale, q, qsum, work_region, work_g, work_s, W_cap,
            V, M, m_base, n_y, csub * kSubRows, ll_max, round_bf16,
            idx_mask, pack_window, out, stream);
      });
    });
    if (rc != 0) return rc;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
