// What the query-projection kernels (qloc.cu: K1, K8, K9) and the fused
// rescore (rescore.cu, K3) share: the staging of a query row's terms in
// shared memory and the per-pair quantize.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "opt_in.cuh"

constexpr int kQlocThreads = 256;
constexpr int kQlocPad = 0x7fffffff;        // PAD_COMPONENT

// Order-keeping compaction, by the one warp that calls it, with one ballot
// per 32 entries, of the entries i < n of row `row` of (ids, vals) whose
// key key_of(i, id) is not kQlocPad: their keys and values land in s_key /
// s_val in entry order. Returns their count in every lane.
template <class KeyOf>
__device__ __forceinline__ int stage_row(const int* __restrict__ ids,
                                         const float* __restrict__ vals,
                                         int64_t row, int n, KeyOf key_of,
                                         int* s_key, float* s_val) {
  const int lane = threadIdx.x & 31;
  int cnt = 0;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    const int key = i < n ? key_of(i, ids[row * n + i]) : kQlocPad;
    const bool real = key != kQlocPad;
    const unsigned mask = __ballot_sync(0xffffffffu, real);
    if (real) {
      const int pos = cnt + __popc(mask & ((1u << lane) - 1u));
      s_key[pos] = key;
      s_val[pos] = vals[row * n + i];
    }
    cnt += __popc(mask);
  }
  return cnt;
}

// Query row `row`'s real terms (PAD ids dropped: they can never match,
// since the vocab pads with -1), staged by warp 0, their count in *s_n;
// the other warps return at once (the caller synchronises).
__device__ __forceinline__ void stage_terms(const int* __restrict__ qc,
                                            const float* __restrict__ qv,
                                            int64_t row, int SC, int* s_qc,
                                            float* s_qv, int* s_n) {
  if (threadIdx.x >= 32) return;
  const int n = stage_row(qc, qv, row, SC, [](int, int c) { return c; },
                          s_qc, s_qv);
  if (threadIdx.x == 0) *s_n = n;
}

// The per-pair quantize, the same f32 ops as the XLA chain and as the
// row-major Pallas body: their `/ 127.0` by a constant is folded into a
// multiply by the f32 reciprocal; the per-slot division by the scale stays
// an IEEE division (no fast-math).
__device__ __forceinline__ float quant_scale(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-20f), 1.0f / 127.0f);
}

__device__ __forceinline__ int8_t quantize(float x, float sc) {
  return static_cast<int8_t>(__float2int_rn(__fdiv_rn(x, sc)));
}
