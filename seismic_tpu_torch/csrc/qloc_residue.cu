// Residue-bucketed per-pair query projection onto residue-ordered list
// vocabularies, with the per-pair int8 quantize or the f32 output.
//
// Replaces: seismic_tpu/ops/pallas_qloc.py::project_qloc_residue (the
// pallas_call at :210), plus the XLA quantize that follows it in
// seismic_tpu/search/grouped.py:763-771 when the scorer is int8.
//
// The index was uploaded with vocab_residue = R: every list's vocabulary is
// laid out as R groups of VRS slots (group r holds the list's terms with
// term % R == r) and a spill region of V - R * VRS slots
// (ops/tiles_prep.py::residue_layout). For pair p of query b = p / QC over
// list l = pair_list[p]:
//   v <  R*VRS: qloc[p, v] = sum_{i < scb} qvb[b, r*scb + i]
//                            * [vocab[l, v] == qcb[b, r*scb + i]], r = v / VRS
//   v >= R*VRS: qloc[p, v] = sum_{i < SC} qv[b, i] * [vocab[l, v] == qc[b, i]]
// where (qcb, qvb) are the query's terms bucketed by residue, scb slots a
// bucket, -2 padded (search/grouped.py::_residue_buckets), and (qc, qv) its
// plain top terms. A group slot is compared with scb terms instead of all
// of them; a term a full bucket dropped still matches in the spill slots
// and nowhere else. Bucket padding is -2, vocab padding -1, query padding
// PAD_COMPONENT: none matches another. A slot matches at most one term, so
// the f32 sum is exact; the quantize is qloc.cu's, bit for bit.
//
// Design: one thread block per pair, as qloc.cu: the block stages the
// query's R*scb bucket slots and its real plain terms in shared memory,
// each thread compare-accumulates its slots against its group's bucket (or
// the plain terms, in the spill region), then the shared epilogue
// (qloc_common.cuh) reduces the amax and writes int8 + scale or f32.
//
// Bound on an H100: P * (R*VRS*scb + spill*n_terms) compare-adds on the
// CUDA cores, above the ~P*V*3 bytes it moves.

#include <cstdint>
#include <cuda_runtime.h>

#include "qloc_common.cuh"

namespace {

constexpr int kMaxBucketSlots = 1024;  // R * scb

__global__ void __launch_bounds__(kQlocThreads)
qloc_residue_kernel(const int16_t* __restrict__ vocab,  // [n_lists, V]
                    const int* __restrict__ pair_list,  // [P]
                    const int* __restrict__ qcb,        // [B, R * scb]
                    const float* __restrict__ qvb,      // [B, R * scb]
                    const int* __restrict__ qc,         // [B, SC]
                    const float* __restrict__ qv,       // [B, SC]
                    int V, int SC, int QC, int R, int scb, int VRS,
                    int8_t* __restrict__ out,           // [P, V]
                    float* __restrict__ scale,          // [P]
                    float* __restrict__ out_f32) {      // [P, V] or null
  __shared__ int s_qc[kQlocMaxTerms];
  __shared__ float s_qv[kQlocMaxTerms];
  __shared__ int s_bc[kMaxBucketSlots];
  __shared__ float s_bv[kMaxBucketSlots];
  __shared__ int s_n;
  __shared__ float s_red[kQlocThreads / 32];

  const int p = blockIdx.x;
  const int64_t b = p / QC;
  const int tid = threadIdx.x;
  stage_terms(qc, qv, b, SC, s_qc, s_qv, &s_n);
  for (int i = tid; i < R * scb; i += kQlocThreads) {
    s_bc[i] = qcb[b * R * scb + i];
    s_bv[i] = qvb[b * R * scb + i];
  }
  __syncthreads();
  const int n_terms = s_n;
  const int16_t* vrow = vocab + static_cast<int64_t>(pair_list[p]) * V;

  float acc[kQlocMaxSlotsPerThread];
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < kQlocMaxSlotsPerThread; ++j) {
    const int v = tid + j * kQlocThreads;
    float a = 0.0f;
    if (v < R * VRS) {
      const int c = static_cast<int>(vrow[v]);
      const int* bc = s_bc + (v / VRS) * scb;
      const float* bv = s_bv + (v / VRS) * scb;
      for (int i = 0; i < scb; ++i) {
        a += (c == bc[i]) ? bv[i] : 0.0f;
      }
    } else if (v < V) {
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

}  // namespace

extern "C" {

int seismic_qloc_residue_max_bucket_slots() { return kMaxBucketSlots; }

// out_f32 null: int8 out [P, V] + scale [P]; else the f32 projection.
// V <= 4096, SC <= 256, R * scb <= 1024, R * VRS <= V.
int seismic_qloc_residue(const int16_t* vocab, const int* pair_list,
                         const int* qcb, const float* qvb, const int* qc,
                         const float* qv, int P, int V, int SC, int QC,
                         int R, int scb, int VRS, int8_t* out, float* scale,
                         float* out_f32, cudaStream_t stream) {
  if (P > 0) {
    qloc_residue_kernel<<<P, kQlocThreads, 0, stream>>>(
        vocab, pair_list, qcb, qvb, qc, qv, V, SC, QC, R, scb, VRS, out,
        scale, out_f32);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
