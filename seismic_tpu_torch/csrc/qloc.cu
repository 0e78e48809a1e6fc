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
// and l(p) = t(p) = p for the row-major one. A vocab slot matches at most
// one term, so the f32 sum is exact and the int8 result equals the JAX
// chain bit for bit.
//
// Design: one thread block per pair. The block reads its vocab row straight
// from the table it is given (the [P, V] gather and the transposes of the
// lane-major TPU version were Mosaic lane-layout rules; this kernel always
// was row-major), stages the query's real terms in shared memory,
// compare-accumulates each slot, reduces the amax over V, and writes int8
// [P, V] and scale [P], or the f32 projection.
//
// Bound on an H100: the compare loop, P*V*n_terms compare-adds on the
// CUDA cores (no tensor-core form), above the bytes it moves (~P*V*3, or
// ~P*V*7 row-major and with the f32 output). The design keeps the terms in
// shared memory (broadcast reads) and the projection in registers; nothing
// of it touches device memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "qloc_common.cuh"

namespace {

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
  __shared__ int s_n;
  __shared__ float s_red[kQlocThreads / 32];

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  stage_terms(qc, qv, p / QC, SC, s_qc, s_qv, &s_n);
  __syncthreads();
  const int n_terms = s_n;
  const int64_t vr = pair_list != nullptr ? pair_list[p] : p;
  const int16_t* vrow = vocab + vr * V;

  float acc[kQlocMaxSlotsPerThread];
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < kQlocMaxSlotsPerThread; ++j) {
    const int v = tid + j * kQlocThreads;
    float a = 0.0f;
    if (v < V) {
      const int c = static_cast<int>(vrow[v]);
      for (int i = 0; i < n_terms; ++i) {
        a += (c == s_qc[i]) ? s_qv[i] : 0.0f;
      }
    }
    acc[j] = a;
    amax = fmaxf(amax, fabsf(a));
  }
  store_projection(acc, amax, V, s_red, out, scale, out_f32, p);
}

int launch(const int16_t* vocab, const int* pair_list, const int* qc,
           const float* qv, int P, int V, int SC, int QC, int8_t* out,
           float* scale, float* out_f32, cudaStream_t stream) {
  if (P > 0) {
    qloc_kernel<<<P, kQlocThreads, 0, stream>>>(vocab, pair_list, qc, qv, V,
                                                SC, QC, out, scale, out_f32);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

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
