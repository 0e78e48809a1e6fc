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
// so the centred form is not q . u8 in bf16 mode. Products and sums are f32
// FMAs on the CUDA cores (never TF32): a bf16 value times an integer below
// 256 is exact in f32, so only the order of the f32 sum differs from the
// TPU's. With pack_idx the block goes through the packed epilogue instead
// and lands in out[g, m, s*STEP + c], STEP = ROWS / pack_window, as int32.
// Output blocks that no work item covers are left as they are.
//
// Design: one 256-thread block per work item. The block stages the group's
// [M, V] queries in shared memory as f32 (rounded there in bf16 mode). A
// warp scores 32/M tile rows at a time: per 256-byte chunk each lane loads
// two 4-byte words of every row (bytes [4l, +4) and [128 + 4l, +4): both
// coalesced) and converts them once, then reads each query's matching 8
// values from shared memory (two conflict-free 16-byte loads) and reuses
// them for all its rows. The 32 lane partials (rows x queries) are reduced
// by one transposing butterfly of 31 shuffles (warp_sum.cuh), which leaves
// value l in lane l. The [M, ROWS] block is staged in shared memory and
// stored with 16-byte stores, or through store_packed.
//
// Bound on an H100: the tile bytes (ROWS*V per distinct super-tile, read
// once) plus the f32 queries and the output over the 3.35 TB/s memory
// rate; the 2*M*ROWS*V operations per item sit below the tensor cores'
// bf16 rate, but this first version spends them on the CUDA cores, whose
// f32 rate (67 TFLOP/s) is what it runs against.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "pack_epilogue.cuh"
#include "warp_sum.cuh"

namespace {

constexpr int kSub = 128;  // rows per subtile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;  // bytes of a row one warp covers per step

__device__ __forceinline__ void unpack4(uint32_t w, float off, float* t) {
  t[0] = static_cast<float>(w & 0xffu) - off;
  t[1] = static_cast<float>((w >> 8) & 0xffu) - off;
  t[2] = static_cast<float>((w >> 16) & 0xffu) - off;
  t[3] = static_cast<float>(w >> 24) - off;
}

// kPack: the packed epilogue, a compile-time choice so that the plain
// store's kernel carries none of its code
template <int kM, int kRows, bool kPack>
__global__ void __launch_bounds__(kThreads)
score_grouped_f_kernel(const uint8_t* __restrict__ tiles,     // [rows, V]
                       const float* __restrict__ tile_scale,  // [rows]
                       const float* __restrict__ q,           // [G_cap, kM, V]
                       const float* __restrict__ qsum,  // [G_cap, kM] or null
                       const int* __restrict__ work_region,   // [W_cap]
                       const int* __restrict__ work_g,
                       const int* __restrict__ work_s,
                       int V, int ll_max, int round_bf16, int idx_mask,
                       int pack_window, void* __restrict__ out) {
  constexpr int kRpw = 32 / kM;  // tile rows a warp scores at a time
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;             // [kM, V]
  float* s_out = smem + kM * V;  // [kM, kRows]

  const int w = blockIdx.x;
  const int g = work_g[w];
  const int s = work_s[w];
  const int64_t row0 = static_cast<int64_t>(work_region[w]) * kRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool centred = qsum != nullptr;

  {
    const float4* src = reinterpret_cast<const float4*>(
        q + static_cast<int64_t>(g) * kM * V);
    float4* dst = reinterpret_cast<float4*>(s_q);
    for (int i = tid; i < kM * V / 4; i += kThreads) {
      float4 x = src[i];
      if (round_bf16) {
        x.x = __bfloat162float(__float2bfloat16_rn(x.x));
        x.y = __bfloat162float(__float2bfloat16_rn(x.y));
        x.z = __bfloat162float(__float2bfloat16_rn(x.z));
        x.w = __bfloat162float(__float2bfloat16_rn(x.w));
      }
      dst[i] = x;
    }
  }
  __syncthreads();

  const float off = centred ? 128.0f : 0.0f;
  const float qs = centred ? qsum[static_cast<int64_t>(g) * kM + lane % kM]
                           : 0.0f;
  const int n_chunks = V / kChunk;
  for (int r0 = warp * kRpw; r0 < kRows; r0 += kWarps * kRpw) {
    float acc[32];  // [kRpw, kM]
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    const uint8_t* trow = tiles + (row0 + r0) * V;
    for (int c = 0; c < n_chunks; ++c) {
      float t[kRpw][8];
#pragma unroll
      for (int rr = 0; rr < kRpw; ++rr) {
        const uint32_t* p = reinterpret_cast<const uint32_t*>(
            trow + static_cast<int64_t>(rr) * V + c * kChunk);
        unpack4(p[lane], off, t[rr]);
        unpack4(p[32 + lane], off, t[rr] + 4);
      }
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const float* qrow = s_q + m * V + c * kChunk;
        const float4 qa = reinterpret_cast<const float4*>(qrow)[lane];
        const float4 qb = reinterpret_cast<const float4*>(qrow + 128)[lane];
#pragma unroll
        for (int rr = 0; rr < kRpw; ++rr) {
          float a = acc[rr * kM + m];
          a = fmaf(qa.x, t[rr][0], a);
          a = fmaf(qa.y, t[rr][1], a);
          a = fmaf(qa.z, t[rr][2], a);
          a = fmaf(qa.w, t[rr][3], a);
          a = fmaf(qb.x, t[rr][4], a);
          a = fmaf(qb.y, t[rr][5], a);
          a = fmaf(qb.z, t[rr][6], a);
          a = fmaf(qb.w, t[rr][7], a);
          acc[rr * kM + m] = a;
        }
      }
    }
    // lane l ends with the total of acc[l]: row r0 + l / kM, query l % kM
    const float dot = warp_transpose_sum<float, 32>(acc, lane);
    const int r = r0 + lane / kM;
    const float v = centred ? __fadd_rn(dot, qs) : dot;
    s_out[(lane % kM) * kRows + r] = __fmul_rn(v, tile_scale[row0 + r]);
  }
  __syncthreads();

  if constexpr (kPack) {  // packed int32 [G_cap, kM, ll_max / pack_window]
    const int64_t stride = ll_max / pack_window;
    store_packed<kM, kRows>(
        s_out,
        static_cast<int*>(out) + static_cast<int64_t>(g) * kM * stride +
            static_cast<int64_t>(s) * (kRows / pack_window),
        stride, s * kRows, idx_mask, pack_window, tid, kThreads);
  } else {  // f32 [G_cap, kM, ll_max]
    store_scores<kM, kRows>(
        s_out,
        static_cast<float*>(out) + static_cast<int64_t>(g) * kM * ll_max +
            static_cast<int64_t>(s) * kRows,
        ll_max, tid, kThreads);
  }
}

template <int kM, int kRows, bool kPack>
int launch_packed(const uint8_t* tiles, const float* tile_scale,
                  const float* q, const float* qsum, const int* work_region,
                  const int* work_g, const int* work_s, int W_cap, int V,
                  int ll_max, int round_bf16, int idx_mask, int pack_window,
                  void* out, cudaStream_t stream) {
  const int smem = (kM * V + kM * kRows) * static_cast<int>(sizeof(float));
  auto kernel = score_grouped_f_kernel<kM, kRows, kPack>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<W_cap, kThreads, smem, stream>>>(
      tiles, tile_scale, q, qsum, work_region, work_g, work_s, V, ll_max,
      round_bf16, idx_mask, pack_window, out);
  return 0;
}

template <int kM, int kRows>
int launch(const uint8_t* tiles, const float* tile_scale, const float* q,
           const float* qsum, const int* work_region, const int* work_g,
           const int* work_s, int W_cap, int V, int ll_max, int round_bf16,
           int idx_mask, int pack_window, void* out, cudaStream_t stream) {
  return pack_window > 0
             ? launch_packed<kM, kRows, true>(
                   tiles, tile_scale, q, qsum, work_region, work_g, work_s,
                   W_cap, V, ll_max, round_bf16, idx_mask, pack_window, out,
                   stream)
             : launch_packed<kM, kRows, false>(
                   tiles, tile_scale, q, qsum, work_region, work_g, work_s,
                   W_cap, V, ll_max, round_bf16, idx_mask, pack_window, out,
                   stream);
}

}  // namespace

extern "C" {

// the widest V at M query slots: [M, V] f32 queries plus the [M, 256]
// output block within 227 KB of shared memory, V a multiple of 256
int seismic_score_grouped_f_max_v(int M) {
  const int v = (227 * 1024 / 4 - M * 2 * kSub) / M;
  return v / kChunk * kChunk;
}

// M 8 or 16; csub 1 or 2; V a multiple of 256 up to the cap above; ll_max a
// multiple of csub * 128; qsum f32 [G_cap, M] or null (the fixup form).
// round_bf16 != 0 rounds the queries to bf16. pack_window 0 writes f32
// [G_cap, M, ll_max]; pack_window >= 1 writes the packed int32
// [G_cap, M, ll_max / pack_window] with idx_mask = 2^idx_bits - 1.
int seismic_score_grouped_f(const uint8_t* tiles, const float* tile_scale,
                            const float* q, const float* qsum,
                            const int* work_region, const int* work_g,
                            const int* work_s, int W_cap, int V, int M,
                            int csub, int ll_max, int round_bf16,
                            int idx_mask, int pack_window, void* out,
                            cudaStream_t stream) {
  if (W_cap > 0) {
    int rc;
    if (V % kChunk != 0 || V > seismic_score_grouped_f_max_v(M)) {
      rc = static_cast<int>(cudaErrorInvalidValue);
    } else if (M == 8 && csub == 1) {
      rc = launch<8, kSub>(tiles, tile_scale, q, qsum, work_region, work_g,
                           work_s, W_cap, V, ll_max, round_bf16, idx_mask,
                           pack_window, out, stream);
    } else if (M == 8 && csub == 2) {
      rc = launch<8, 2 * kSub>(tiles, tile_scale, q, qsum, work_region,
                               work_g, work_s, W_cap, V, ll_max, round_bf16,
                               idx_mask, pack_window, out, stream);
    } else if (M == 16 && csub == 1) {
      rc = launch<16, kSub>(tiles, tile_scale, q, qsum, work_region, work_g,
                            work_s, W_cap, V, ll_max, round_bf16, idx_mask,
                            pack_window, out, stream);
    } else if (M == 16 && csub == 2) {
      rc = launch<16, 2 * kSub>(tiles, tile_scale, q, qsum, work_region,
                                work_g, work_s, W_cap, V, ll_max, round_bf16,
                                idx_mask, pack_window, out, stream);
    } else {
      rc = static_cast<int>(cudaErrorInvalidValue);
    }
    if (rc != 0) return rc;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
