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
// where val_w = 0 at padding slots (comps_w == PAD_COMPONENT).
//
// Design: one 256-thread block per query; the query's real terms (PAD ids
// dropped) sit in shared memory and each warp scores one candidate row at
// a time: lanes read the row's component ids and value bits straight from
// the [n_docs, 2W] table (coalesced 128-byte segments), compare each id
// against the terms, and a warp sum reduces over W. Rows are sorted by
// component id with the padding at the end, so lanes holding padding skip
// the compare loop. The [B*R, 2W] gathered copy of the TPU version never
// exists.
//
// Bound on an H100: the real entries of the gathered forward rows (8 bytes
// per id/value pair of each distinct candidate) over the 3.35 TB/s memory
// rate; the row gather is likely the cost, as on the TPU.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTerms = 256;
constexpr int kPad = 0x7fffffff;  // PAD_COMPONENT

__global__ void __launch_bounds__(kThreads)
rescore_fused_kernel(const int* __restrict__ fwd,      // [n_docs, 2W]
                     const int* __restrict__ doc_ids,  // [B, R]
                     const int* __restrict__ qc,       // [B, SC]
                     const float* __restrict__ qv,     // [B, SC]
                     int n_docs, int W, int R, int SC,
                     float* __restrict__ out) {        // [B, R]
  __shared__ int s_qc[kMaxTerms];
  __shared__ float s_qv[kMaxTerms];
  __shared__ int s_n;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) {
    int n = 0;
    for (int i = 0; i < SC; ++i) {
      const int c = qc[static_cast<int64_t>(b) * SC + i];
      if (c != kPad) {
        s_qc[n] = c;
        s_qv[n] = qv[static_cast<int64_t>(b) * SC + i];
        ++n;
      }
    }
    s_n = n;
  }
  __syncthreads();
  const int n_terms = s_n;

  for (int r = warp; r < R; r += kWarps) {
    int d = doc_ids[static_cast<int64_t>(b) * R + r];
    d = d < 0 ? 0 : (d > n_docs - 1 ? n_docs - 1 : d);
    const int* row = fwd + static_cast<int64_t>(d) * (2 * W);
    float part = 0.0f;
    for (int w = lane; w < W; w += 32) {
      const int c = row[w];
      if (c == kPad) continue;
      float a = 0.0f;
      for (int i = 0; i < n_terms; ++i) {
        a += (c == s_qc[i]) ? s_qv[i] : 0.0f;
      }
      part += __fmul_rn(__int_as_float(row[W + w]), a);
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

int seismic_rescore_max_terms() { return kMaxTerms; }

int seismic_rescore_fused(const int* fwd, const int* doc_ids, const int* qc,
                          const float* qv, int B, int R, int SC, int n_docs,
                          int W, float* out, cudaStream_t stream) {
  if (B > 0 && R > 0) {
    rescore_fused_kernel<<<B, kThreads, 0, stream>>>(fwd, doc_ids, qc, qv,
                                                     n_docs, W, R, SC, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
