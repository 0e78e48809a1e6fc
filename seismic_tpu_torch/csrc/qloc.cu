// Per-pair query projection onto list vocabularies, fused with the per-pair
// int8 quantize.
//
// Replaces: seismic_tpu/ops/pallas_qloc.py::project_qloc_pallas (the
// pallas_call at :56) plus the XLA quantize that follows it in
// seismic_tpu/search/grouped.py:763-771.
//
// Computes, for every (query, list) pair p with query b = p / QC:
//   qloc[p, v] = sum_i qv[b, i] * [vocab[pair_list[p], v] == qc[b, i]]
//   scale[p]   = max(max_v |qloc[p, v]|, 1e-20) * f32(1 / 127)
//   q_i8[p, v] = round_half_even(qloc[p, v] / scale[p])
// A vocab slot matches at most one term, so the f32 sum is exact and the
// int8 result equals the JAX chain bit for bit.
//
// Design: one thread block per pair. The block reads its list's vocab row
// straight from the [n_lists, V] table (the [P, V] gather and the two
// transposes of the TPU version were Mosaic lane-layout rules), stages the
// query's real terms (PAD ids dropped: they can never match, since the
// vocab pads with -1) in shared memory, compare-accumulates each slot,
// reduces the amax over V, and writes int8 [P, V] and scale [P].
//
// Bound on an H100: the compare loop, P*V*n_terms compare-adds on the
// CUDA cores (no tensor-core form), above the ~P*V*3 bytes it moves.
// The design keeps the terms in shared memory (broadcast reads) and the
// projection in registers; nothing of it touches device memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTerms = 256;
constexpr int kMaxSlotsPerThread = 16;  // V <= 4096
constexpr int kPad = 0x7fffffff;        // PAD_COMPONENT

__global__ void __launch_bounds__(kThreads)
qloc_quantize_kernel(const int16_t* __restrict__ vocab,  // [n_lists, V]
                     const int* __restrict__ pair_list,  // [P]
                     const int* __restrict__ qc,         // [B, SC]
                     const float* __restrict__ qv,       // [B, SC]
                     int V, int SC, int QC,
                     int8_t* __restrict__ out,           // [P, V]
                     float* __restrict__ scale) {        // [P]
  __shared__ int s_qc[kMaxTerms];
  __shared__ float s_qv[kMaxTerms];
  __shared__ int s_n;
  __shared__ float s_red[kThreads / 32];

  const int p = blockIdx.x;
  const int b = p / QC;
  const int tid = threadIdx.x;
  if (tid == 0) {
    // order-preserving compaction of the real terms (SC <= 256: cheap)
    int n = 0;
    for (int i = 0; i < SC; ++i) {
      const int c = qc[(int64_t)b * SC + i];
      if (c != kPad) {
        s_qc[n] = c;
        s_qv[n] = qv[(int64_t)b * SC + i];
        ++n;
      }
    }
    s_n = n;
  }
  __syncthreads();
  const int n_terms = s_n;
  const int16_t* vrow = vocab + (int64_t)pair_list[p] * V;

  float acc[kMaxSlotsPerThread];
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxSlotsPerThread; ++j) {
    const int v = tid + j * kThreads;
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

  // block max of |qloc| over the V slots
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  if ((tid & 31) == 0) s_red[tid >> 5] = amax;
  __syncthreads();
  if (tid < 32) {
    float m = tid < kThreads / 32 ? s_red[tid] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    if (tid == 0) s_red[0] = m;
  }
  __syncthreads();
  // the same f32 ops as the XLA chain: its `/ 127.0` by a constant is
  // folded into a multiply by the f32 reciprocal; the per-slot division
  // by the scale stays an IEEE division (no fast-math)
  const float sc = __fmul_rn(fmaxf(s_red[0], 1e-20f), 1.0f / 127.0f);
  int8_t* orow = out + (int64_t)p * V;
#pragma unroll
  for (int j = 0; j < kMaxSlotsPerThread; ++j) {
    const int v = tid + j * kThreads;
    if (v < V) {
      orow[v] = static_cast<int8_t>(__float2int_rn(__fdiv_rn(acc[j], sc)));
    }
  }
  if (tid == 0) scale[p] = sc;
}

}  // namespace

extern "C" {

int seismic_qloc_max_v() { return kThreads * kMaxSlotsPerThread; }
int seismic_qloc_max_terms() { return kMaxTerms; }

// vocab int16 [n_lists, V] (-1 padded)
int seismic_qloc_quantize(const int16_t* vocab, const int* pair_list,
                          const int* qc, const float* qv, int P, int V,
                          int SC, int QC, int8_t* out, float* scale,
                          cudaStream_t stream) {
  if (P > 0) {
    qloc_quantize_kernel<<<P, kThreads, 0, stream>>>(vocab, pair_list, qc,
                                                     qv, V, SC, QC, out,
                                                     scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
