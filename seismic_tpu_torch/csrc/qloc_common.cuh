// What the query-projection kernels (qloc.cu, qloc_residue.cu) share: the
// staging of a query's terms, the quantize's constants, and (for
// qloc_residue.cu) the block-wide amax and per-pair int8 quantize of a
// projection a block holds in registers (thread tid owns slots tid + j *
// 256).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

constexpr int kQlocThreads = 256;
constexpr int kQlocMaxTerms = 256;
constexpr int kQlocMaxSlotsPerThread = 16;  // V <= 4096 (K9)
constexpr int kQlocPad = 0x7fffffff;        // PAD_COMPONENT

// Order-keeping compaction of query row `row`'s real terms (PAD ids
// dropped: they can never match, since the vocab pads with -1) into shared
// memory, by warp 0 with one ballot per 32 terms; the other warps return
// at once (the caller synchronises). Returns the count in *s_n.
__device__ __forceinline__ void stage_terms(const int* __restrict__ qc,
                                            const float* __restrict__ qv,
                                            int64_t row, int SC, int* s_qc,
                                            float* s_qv, int* s_n) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int n = 0;
  for (int i0 = 0; i0 < SC; i0 += 32) {
    const int i = i0 + lane;
    const int c = i < SC ? qc[row * SC + i] : kQlocPad;
    const bool real = c != kQlocPad;
    const unsigned mask = __ballot_sync(0xffffffffu, real);
    if (real) {
      const int pos = n + __popc(mask & ((1u << lane) - 1u));
      s_qc[pos] = c;
      s_qv[pos] = qv[row * SC + i];
    }
    n += __popc(mask);
  }
  if (lane == 0) *s_n = n;
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

// Store the pair's projection acc (thread tid owns slots tid + j * 256):
// as f32 when out_f32 is given, else quantized,
//   scale = max(max_v |acc|, 1e-20) * f32(1 / 127)
//   q_i8[v] = round_half_even(acc[v] / scale)
// (quant_scale, quantize). s_red: shared float[8].
__device__ __forceinline__ void store_projection(
    const float (&acc)[kQlocMaxSlotsPerThread], float amax, int V,
    float* s_red, int8_t* __restrict__ out_i8, float* __restrict__ scale,
    float* __restrict__ out_f32, int64_t p) {
  const int tid = threadIdx.x;
  if (out_f32 != nullptr) {
    float* orow = out_f32 + p * V;
#pragma unroll
    for (int j = 0; j < kQlocMaxSlotsPerThread; ++j) {
      const int v = tid + j * kQlocThreads;
      if (v < V) orow[v] = acc[j];
    }
    return;
  }
  // block max of |qloc| over the V slots
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  if ((tid & 31) == 0) s_red[tid >> 5] = amax;
  __syncthreads();
  if (tid < 32) {
    float m = tid < kQlocThreads / 32 ? s_red[tid] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    if (tid == 0) s_red[0] = m;
  }
  __syncthreads();
  const float sc = quant_scale(s_red[0]);
  int8_t* orow = out_i8 + p * V;
#pragma unroll
  for (int j = 0; j < kQlocMaxSlotsPerThread; ++j) {
    const int v = tid + j * kQlocThreads;
    if (v < V) {
      orow[v] = quantize(acc[j], sc);
    }
  }
  if (tid == 0) scale[p] = sc;
}
