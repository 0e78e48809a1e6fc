// Per-pair query projection onto list vocabularies, fused with the per-pair
// int8 quantize; three entry points over one kernel.
//
// Replaces: seismic_tpu/ops/pallas_qloc.py::project_qloc_pallas (the
// pallas_call at :56), with the XLA quantize that follows it in
// seismic_tpu/search/grouped.py:763-771 (seismic_qloc_quantize) or without
// it, for the bf16/f32 scorer (seismic_qloc_f32, grouped.py:772-773); and
// seismic_tpu/ops/pallas_qloc.py::project_qloc_rowmajor (the pallas_call at
// :127), the row-major projection with its in-kernel quantize
// (seismic_qloc_rowmajor: every pair brings its own vocab row and its own
// term row).
//
// Computes, for every (query, list) pair p,
//   qloc[p, v] = sum_i qv[t(p), i] * [vocab[l(p), v] == qc[t(p), i]]
//   scale[p]   = max(max_v |qloc[p, v]|, 1e-20) * f32(1 / 127)
//   q_i8[p, v] = round_half_even(qloc[p, v] / scale[p])
// with l(p) = pair_list[p], t(p) = p / QC for the first two entry points
// and l(p) = t(p) = p for the row-major one. The sum runs in term order
// from 0.0f, as the compare loop of the plain version adds it; a term id
// that appears more than once in a row sums its values in that order, and
// adding the 0.0f of a non-matching term changes no partial sum. So the
// int8 result equals the JAX chain bit for bit.
//
// Bound on an H100: the bytes, each distinct vocab row once, the terms,
// the int8 [P, V] output and the scales (~0.05 ms at B=16384, P=229,376,
// V=512). A compare of every slot with every term (P * V * n_terms
// compare-adds, 0.136 ms of f32 operations there) is above that bound;
// a lookup does V per pair.
//
// Design: one block per query row of terms, serving that row's QC
// consecutive pairs (one warp for QC = 1, the row-major entry point). Warp
// 0 stages the row's real terms in shared memory by ballot compaction
// (qloc_common.cuh); every distinct term id then enters a 512-slot
// open-addressed hash table in shared memory (term_table.cuh, which the
// fused rescore, rescore.cu, shares; 8-byte entries of an int32
// key, PAD the empty key, which no staged term and no int16 code equals,
// and the f32 sum of the id's values in term order), one atomicCAS a
// term; only a row with a repeated id takes a second pass, in which the
// first of its terms sums the id's values in order. A warp per pair reads
// its V codes as 16-byte chunks of 8 (V % 8 == 0, as the TPU kernel asks),
// looks each up once (the first probes of a chunk's 8 codes issued
// together; about one 8-byte shared load a code at a load factor <= 1/8
// for 64 terms), keeps up to 1024 values in registers while it reduces
// the amax with shuffles, then quantizes and stores 8 codes a store.
// Wider rows look their remaining chunks up twice.

#include <cstdint>
#include <cuda_runtime.h>

#include "qloc_common.cuh"
#include "term_table.cuh"

namespace {

constexpr int kMaxWarps = kQlocThreads / 32;
constexpr int kHeld = 4;  // chunks of 8 codes whose values a lane keeps

// The values of the 8 int16 codes of a 16-byte chunk: each code's term's
// summed value, or 0.0f when no term has it. A table entry is (key, value
// bits), one 8-byte shared load a probe; the first probes of all 8 codes
// are issued together, and a collision walks on (rare at a load factor
// <= 1/2).
__device__ __forceinline__ void lookup8(const int2* s_tab, int4 chunk,
                                        float (&x)[8]) {
  const int w[4] = {chunk.x, chunk.y, chunk.z, chunk.w};
  int c[8], h[8];
  int2 e[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    // code j: the low (j even) or high half of word j / 2, sign-extended
    c[j] = (j & 1) ? (w[j >> 1] >> 16)
                   : static_cast<int>(static_cast<int16_t>(w[j >> 1]));
    h[j] = term_slot(c[j]);
    e[j] = s_tab[h[j]];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    while (e[j].x != c[j] && e[j].x != kTermEmpty) {
      h[j] = term_next(h[j]);
      e[j] = s_tab[h[j]];
    }
    x[j] = e[j].x == c[j] ? __int_as_float(e[j].y) : 0.0f;
  }
}

__device__ __forceinline__ float amax8(const float (&x)[8], float m) {
#pragma unroll
  for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(x[j]));
  return m;
}

// chunk c's 8 outputs: f32 in two 16-byte stores when frow is given, else
// the int8 codes in one 8-byte store
__device__ __forceinline__ void store8(const float (&x)[8], float sc,
                                      int8_t* orow, float* frow, int c) {
  if (frow != nullptr) {
    float4* f = reinterpret_cast<float4*>(frow) + 2 * c;
    f[0] = make_float4(x[0], x[1], x[2], x[3]);
    f[1] = make_float4(x[4], x[5], x[6], x[7]);
    return;
  }
  unsigned u[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    u[j >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(
                     quantize(x[j], sc))) << (8 * (j & 3));
  }
  reinterpret_cast<uint2*>(orow)[c] = make_uint2(u[0], u[1]);
}

__global__ void __launch_bounds__(kQlocThreads)
qloc_kernel(const int16_t* __restrict__ vocab,  // [n_lists, V] or [P, V]
            const int* __restrict__ pair_list,  // [P], or null: row p
            const int* __restrict__ qc,         // [B, SC] or [P, SC]
            const float* __restrict__ qv,       // same shape as qc
            int V, int SC, int QC,              // QC 1: one term row a pair
            int8_t* __restrict__ out,           // [P, V]
            float* __restrict__ scale,          // [P]
            float* __restrict__ out_f32) {      // [P, V], or null: quantize
  __shared__ int s_qc[kQlocMaxTerms];
  __shared__ float s_qv[kQlocMaxTerms];
  __shared__ int2 s_tab[kTermSlots];  // (term id, f32 value bits)
  __shared__ int s_n;
  __shared__ int s_dup;  // some id repeats in the row

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  term_table_clear(s_tab, &s_dup);
  stage_terms(qc, qv, b, SC, s_qc, s_qv, &s_n);
  __syncthreads();
  term_table_build(s_tab, s_qc, s_qv, s_n, &s_dup);

  // a warp per pair; lane l holds the values of chunks l + 32 i (i <
  // kHeld) of 8 codes in registers from the lookup to the store, and looks
  // up any chunk past them (V > 1024) again for the store
  const int lane = tid & 31;
  const int nch = V / 8;
  for (int j = tid >> 5; j < QC; j += blockDim.x >> 5) {
    const int64_t p = static_cast<int64_t>(b) * QC + j;
    const int64_t vr = pair_list != nullptr ? pair_list[p] : p;
    const int4* vrow = reinterpret_cast<const int4*>(vocab + vr * V);
    int8_t* orow = out_f32 == nullptr ? out + p * V : nullptr;
    float* frow = out_f32 == nullptr ? nullptr : out_f32 + p * V;
    int4 held[kHeld];
#pragma unroll
    for (int i = 0; i < kHeld; ++i) {
      const int c = lane + 32 * i;
      held[i] = c < nch ? vrow[c] : make_int4(0, 0, 0, 0);
    }
    float xs[kHeld][8];
    float amax = 0.0f;
#pragma unroll
    for (int i = 0; i < kHeld; ++i) {
      if (lane + 32 * i < nch) {
        lookup8(s_tab, held[i], xs[i]);
        amax = amax8(xs[i], amax);
        if (frow != nullptr) store8(xs[i], 0.0f, orow, frow, lane + 32 * i);
      }
    }
    for (int c = lane + 32 * kHeld; c < nch; c += 32) {
      float x[8];
      lookup8(s_tab, vrow[c], x);
      amax = amax8(x, amax);
      if (frow != nullptr) store8(x, 0.0f, orow, frow, c);
    }
    if (frow != nullptr) continue;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    }
    const float sc = quant_scale(amax);
    if (lane == 0) scale[p] = sc;
#pragma unroll
    for (int i = 0; i < kHeld; ++i) {
      if (lane + 32 * i < nch) store8(xs[i], sc, orow, frow, lane + 32 * i);
    }
    for (int c = lane + 32 * kHeld; c < nch; c += 32) {
      float x[8];
      lookup8(s_tab, vrow[c], x);
      store8(x, sc, orow, frow, c);
    }
  }
}

int launch(const int16_t* vocab, const int* pair_list, const int* qc,
           const float* qv, int P, int V, int SC, int QC, int8_t* out,
           float* scale, float* out_f32, cudaStream_t stream) {
  if (V % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (P > 0) {
    // QC pairs on as few rounds of at most 8 warps as they need
    const int rounds = (QC + kMaxWarps - 1) / kMaxWarps;
    const int warps = (QC + rounds - 1) / rounds;
    qloc_kernel<<<P / QC, warps * 32, 0, stream>>>(
        vocab, pair_list, qc, qv, V, SC, QC, out, scale, out_f32);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// the cap of the block-held projection epilogue (qloc_common.cuh) that
// qloc_residue.cu keeps; this file's kernel takes any V % 8 == 0
int seismic_qloc_max_v() { return kQlocThreads * kQlocMaxSlotsPerThread; }
int seismic_qloc_max_terms() { return kQlocMaxTerms; }

// vocab int16 [n_lists, V] (-1 padded); qc / qv [B, SC], P = B * QC
int seismic_qloc_quantize(const int16_t* vocab, const int* pair_list,
                          const int* qc, const float* qv, int P, int V,
                          int SC, int QC, int8_t* out, float* scale,
                          cudaStream_t stream) {
  return launch(vocab, pair_list, qc, qv, P, V, SC, QC, out, scale, nullptr,
                stream);
}

// the same projection, unquantized: out f32 [P, V]
int seismic_qloc_f32(const int16_t* vocab, const int* pair_list,
                     const int* qc, const float* qv, int P, int V, int SC,
                     int QC, float* out, cudaStream_t stream) {
  return launch(vocab, pair_list, qc, qv, P, V, SC, QC, nullptr, nullptr,
                out, stream);
}

// row-major: vocab_rows int16 [P, V], qc / qv [P, SC], one row each a pair
int seismic_qloc_rowmajor(const int16_t* vocab_rows, const int* qc,
                          const float* qv, int P, int V, int SC, int8_t* out,
                          float* scale, cudaStream_t stream) {
  return launch(vocab_rows, nullptr, qc, qv, P, V, SC, 1, out, scale,
                nullptr, stream);
}

}  // extern "C"
