// Exact candidate rescoring from fused forward-index rows, gather fused.
//
// Replaces: seismic_tpu/ops/pallas_rescore.py::score_docs_rowmajor_pallas
// (the pallas_call at :62) together with the forward-row gather and f32
// decode that its wrapper rescore_exact ran in XLA before it
// (pallas_rescore.py:119-159, the fwd_fused branch).
//
// For each query b and candidate r, with d = clamp(doc_ids[b, r], 0,
// n_docs - 1), comps = fwd[d, :W] and vals = f32 bits of fwd[d, W:]:
//   score[b, r] = sum_w val_w * sum_i qv[b, i] * [comps_w == qc[b, i]]
// where val_w = 0 at padding slots (comps_w == PAD_COMPONENT). The inner
// sum runs in term order from 0.0f, as pallas_rescore.py:54-56 adds it.
//
// Bound on an H100: bytes, the real entries (4-byte id, 4-byte value) of
// the candidates' forward rows at 3.35 TB/s. A compare of every entry with
// every query term (R * nnz * n_terms compare-adds, 8-10x the byte time
// at chip_smoke's shapes) is above that bound; a lookup does one probe an
// entry.
//
// Design: one 256-thread block per query. Warp 0 stages the query's real
// terms by ballot compaction (qloc_common.cuh), and the block enters them
// into K1's shared-memory hash table (term_table.cuh), which holds each
// id's values summed in term order: one lookup then gives an entry's
// inner sum bit for bit. A warp takes one candidate row at a time and
// reads its ids in chunks of 64 (8 bytes a lane): the first two chunks at
// once, then one chunk at a time while the last one was full. A row's
// padding sits at its end, so a chunk with a PAD id ends the row (found
// by ballot), and an all-PAD row costs one chunk. A lane looks its ids up
// (the first probes of all of them issued together; the warp walks on
// only where some probe hit another id) and reads the value bits of its 2
// entries only where one of them hits, so a value sector that no query
// term touches is never read. The loads overlap: a row's doc id is read
// one row ahead, its first chunks before the previous row's sum reduces,
// and the warp's first row while the block builds its table. Rows are
// gathers of ~1 KB at random places, so the design buys loads in flight
// with warps: 8 blocks (64 warps) an SM, where warps holding 4 rows each
// fit 3 and ran slower on the H100 (PERF.md §6). The row's sum reduces
// over the warp in 5 shuffles. The [B*R, 2W] gathered copy of the TPU
// version never exists.
//
// The lean u8 form (rescore_u8_kernel, entry point seismic_rescore_u8):
// the same computation over a document's int16 ids (-1 padded), its u8
// codes and its f32 (min, step), val_w = code_w * step + min, read by the
// JAX package as the i16 twin plus the codes decoded per document
// (pallas_rescore.py:147-159, search/engine.py:114-131). It reads 3W + 8
// bytes a candidate row where the fused form reads 8W. The same block
// shape, staging and table; a warp takes one row at a time in chunks of
// 128 ids (4 a lane: one 8-byte load of ids and, only where one of them
// hits a query term, one 4-byte load of codes, when W % 4 == 0; single
// loads otherwise), ends the row at the first chunk holding a -1 id, and
// decodes with the rounding of two separate f32 ops (no contraction into
// an FMA) before it multiplies by the looked-up sum.

#include <cstdint>
#include <cuda_runtime.h>

#include "qloc_common.cuh"
#include "term_table.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;  // ids a warp reads at once, 2 a lane
constexpr int kPad = kQlocPad;

// the words of p at columns w and w + 1 (w even, w < W; `fill` past W):
// one 8-byte load when W is even (p + w is then 8-byte aligned), else two
__device__ __forceinline__ int2 load2(const int* p, int w, int W, int fill) {
  if ((W & 1) == 0) return __ldg(reinterpret_cast<const int2*>(p + w));
  return make_int2(__ldg(p + w), w + 1 < W ? __ldg(p + w + 1) : fill);
}

// the ids of chunk `ch` of row `row` into c[0..1] (PAD past W)
__device__ __forceinline__ void load_ids(const int* row, int ch, int W,
                                         int* c) {
  const int w = ch * kChunk + 2 * (threadIdx.x & 31);
  const int2 x = w < W ? load2(row, w, W, kPad) : make_int2(kPad, kPad);
  c[0] = x.x;
  c[1] = x.y;
}

// Start a row: the fused row of doc d (clamped) and the ids of its first
// two chunks in c.
__device__ __forceinline__ const int* start_row(const int* fwd, int d,
                                                int n_docs, int W,
                                                int (&c)[4]) {
  d = d < 0 ? 0 : (d > n_docs - 1 ? n_docs - 1 : d);
  const int* row = fwd + static_cast<int64_t>(d) * (2 * W);
  load_ids(row, 0, W, c);
  load_ids(row, 1, W, c + 2);
  return row;
}

__global__ void __launch_bounds__(kThreads, 8)
rescore_fused_kernel(const int* __restrict__ fwd,      // [n_docs, 2W]
                     const int* __restrict__ doc_ids,  // [B, R]
                     const int* __restrict__ qc,       // [B, SC]
                     const float* __restrict__ qv,     // [B, SC]
                     int n_docs, int W, int R, int SC,
                     float* __restrict__ out) {        // [B, R]
  __shared__ int s_qc[kQlocMaxTerms];
  __shared__ float s_qv[kQlocMaxTerms];
  __shared__ int2 s_tab[kTermSlots];  // (term id, f32 value bits)
  __shared__ int s_n;
  __shared__ int s_dup;

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int* ids_b = doc_ids + static_cast<int64_t>(b) * R;

  // the warp's first row is in flight while the block builds the table
  int r = threadIdx.x >> 5;
  int c[4] = {kPad, kPad, kPad, kPad};  // [chunk][2] ids
  const int* row = r < R ? start_row(fwd, __ldg(ids_b + r), n_docs, W, c)
                         : fwd;
  term_table_clear(s_tab, &s_dup);
  stage_terms(qc, qv, b, SC, s_qc, s_qv, &s_n);
  __syncthreads();
  term_table_build(s_tab, s_qc, s_qv, s_n, &s_dup);

  for (; r < R; r += kWarps) {
    const int d_next = r + kWarps < R ? __ldg(ids_b + r + kWarps) : 0;
    float part = 0.0f;
    int c0 = 0;
    int step = 2;  // chunks in c this round
    while (true) {
      float a[4];
      term_find_n(s_tab, c, a);
      // the value bits where a term hits, both loads issued before a use
      int2 v[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int w = (c0 + k) * kChunk + 2 * lane;
        v[k] = a[2 * k] != 0.0f || a[2 * k + 1] != 0.0f
                   ? load2(row + W, w, W, 0)
                   : make_int2(0, 0);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        part += __fmul_rn(__int_as_float(v[k].x), a[2 * k]);
        part += __fmul_rn(__int_as_float(v[k].y), a[2 * k + 1]);
      }
      // the row goes on only while the last chunk it read held no padding
      const int k = step - 1;
      const bool full = __ballot_sync(0xffffffffu, c[2 * k] == kPad ||
                                                       c[2 * k + 1] ==
                                                           kPad) == 0u;
      c0 += step;
      if (!full || c0 * kChunk >= W) break;
      load_ids(row, c0, W, c);
      c[2] = c[3] = kPad;
      step = 1;
    }
    // the next row's first chunks start loading before this sum reduces
    if (r + kWarps < R) row = start_row(fwd, d_next, n_docs, W, c);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      part += __shfl_xor_sync(0xffffffffu, part, off);
    }
    if (lane == 0) out[static_cast<int64_t>(b) * R + r] = part;
  }
}

constexpr int kChunkU8 = 128;  // ids a warp reads at once, 4 a lane

// The 4 ids at columns w..w+3 of an int16 row (kPad for -1 and past W).
template <bool kVec>
__device__ __forceinline__ void load_ids16(const int16_t* row, int w, int W,
                                           int (&c)[4]) {
  if (kVec && w < W) {
    const int2 x = __ldg(reinterpret_cast<const int2*>(row + w));
    const int h[4] = {static_cast<int>(static_cast<int16_t>(x.x)),
                      x.x >> 16,
                      static_cast<int>(static_cast<int16_t>(x.y)),
                      x.y >> 16};
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = h[j] < 0 ? kPad : h[j];
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int v = w + j < W ? static_cast<int>(__ldg(row + w + j)) : -1;
    c[j] = v < 0 ? kPad : v;
  }
}

// The 4 u8 codes at columns w..w+3 of a row (0 past W).
template <bool kVec>
__device__ __forceinline__ void load_codes(const uint8_t* row, int w, int W,
                                           float (&x)[4]) {
  if (kVec) {
    const unsigned v = __ldg(reinterpret_cast<const unsigned*>(row + w));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[j] = static_cast<float>((v >> (8 * j)) & 255u);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[j] = w + j < W ? static_cast<float>(__ldg(row + w + j)) : 0.0f;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 8)
rescore_u8_kernel(const int16_t* __restrict__ comps,  // [n_docs, W]
                  const uint8_t* __restrict__ codes,  // [n_docs, W]
                  const float* __restrict__ vmin,     // [n_docs]
                  const float* __restrict__ vstep,    // [n_docs]
                  const int* __restrict__ doc_ids,    // [B, R]
                  const int* __restrict__ qc,         // [B, SC]
                  const float* __restrict__ qv,       // [B, SC]
                  int n_docs, int W, int R, int SC,
                  float* __restrict__ out) {          // [B, R]
  __shared__ int s_qc[kQlocMaxTerms];
  __shared__ float s_qv[kQlocMaxTerms];
  __shared__ int2 s_tab[kTermSlots];
  __shared__ int s_n;
  __shared__ int s_dup;

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int* ids_b = doc_ids + static_cast<int64_t>(b) * R;

  term_table_clear(s_tab, &s_dup);
  stage_terms(qc, qv, b, SC, s_qc, s_qv, &s_n);
  __syncthreads();
  term_table_build(s_tab, s_qc, s_qv, s_n, &s_dup);

  int r = threadIdx.x >> 5;
  int d = r < R ? __ldg(ids_b + r) : 0;
  for (; r < R; r += kWarps) {
    d = d < 0 ? 0 : (d > n_docs - 1 ? n_docs - 1 : d);
    const int16_t* crow = comps + static_cast<int64_t>(d) * W;
    const uint8_t* vrow = codes + static_cast<int64_t>(d) * W;
    const float mn = __ldg(vmin + d);
    const float st = __ldg(vstep + d);
    // the next row's doc id is in flight while this row is scored
    d = r + kWarps < R ? __ldg(ids_b + r + kWarps) : 0;
    float part = 0.0f;
    for (int w0 = 0; w0 < W; w0 += kChunkU8) {
      const int w = w0 + 4 * lane;
      int c[4];
      load_ids16<kVec>(crow, w, W, c);
      float a[4];
      term_find_n(s_tab, c, a);
      if (a[0] != 0.0f || a[1] != 0.0f || a[2] != 0.0f || a[3] != 0.0f) {
        float x[4];
        load_codes<kVec>(vrow, w, W, x);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          part += __fmul_rn(__fadd_rn(__fmul_rn(x[j], st), mn), a[j]);
        }
      }
      // the row goes on only while this chunk held no padding
      const bool pad = c[0] == kPad || c[1] == kPad || c[2] == kPad ||
                       c[3] == kPad;
      if (__ballot_sync(0xffffffffu, pad) != 0u) break;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      part += __shfl_xor_sync(0xffffffffu, part, off);
    }
    if (lane == 0) out[static_cast<int64_t>(b) * R + r] = part;
  }
}

}  // namespace

extern "C" {

int seismic_rescore_max_terms() { return kQlocMaxTerms; }

int seismic_rescore_fused(const int* fwd, const int* doc_ids, const int* qc,
                          const float* qv, int B, int R, int SC, int n_docs,
                          int W, float* out, cudaStream_t stream) {
  if (B > 0 && R > 0) {
    rescore_fused_kernel<<<B, kThreads, 0, stream>>>(fwd, doc_ids, qc, qv,
                                                     n_docs, W, R, SC, out);
  }
  return static_cast<int>(cudaGetLastError());
}

int seismic_rescore_u8(const int16_t* comps, const uint8_t* codes,
                       const float* vmin, const float* vstep,
                       const int* doc_ids, const int* qc, const float* qv,
                       int B, int R, int SC, int n_docs, int W, float* out,
                       cudaStream_t stream) {
  if (B > 0 && R > 0) {
    // one 8-byte load of ids and one 4-byte load of codes a lane when
    // every row and chunk start is aligned for them
    const bool vec = W % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(comps) % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(codes) % 4 == 0;
    if (vec) {
      rescore_u8_kernel<true><<<B, kThreads, 0, stream>>>(
          comps, codes, vmin, vstep, doc_ids, qc, qv, n_docs, W, R, SC, out);
    } else {
      rescore_u8_kernel<false><<<B, kThreads, 0, stream>>>(
          comps, codes, vmin, vstep, doc_ids, qc, qv, n_docs, W, R, SC, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
