// The term lookup shared by the projection (qloc.cu, K1 and K8) and the
// fused rescore (rescore.cu, K3): a 512-slot open-addressed hash table in
// shared memory of one query row's real terms, built once a block.
//
// An entry is 8 bytes, (int32 term id, f32 value bits); PAD_COMPONENT is
// the empty key. The staged terms never hold PAD (stage_terms drops it),
// and term_find_n answers a PAD id with 0.0f without probing (an empty
// slot's key is PAD too, so a probe would "find" it). The table holds
// each id's values summed in term order from 0.0f, as a compare loop over
// the terms adds them: 0.0f + v for an id that appears once (which turns
// -0.0 into +0.0, as that loop does); a row with a repeated id takes a
// second pass in which the first of its terms sums them in order. So a
// lookup gives the loop's sum bit for bit.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "qloc_common.cuh"

constexpr int kTermSlots = 512;  // >= 2 * kQlocMaxTerms: load factor <= 1/2
constexpr int kTermEmpty = kQlocPad;

__device__ __forceinline__ int term_slot(int c) {
  return static_cast<int>((static_cast<unsigned>(c) * 2654435761u) >> 23);
}

__device__ __forceinline__ int term_next(int h) {
  return (h + 1) & (kTermSlots - 1);
}

// Every slot empty and *s_dup = 0; the caller synchronises before
// term_table_build.
__device__ __forceinline__ void term_table_clear(int2* s_tab, int* s_dup) {
  for (int i = threadIdx.x; i < kTermSlots; i += blockDim.x) {
    s_tab[i] = make_int2(kTermEmpty, 0);
  }
  if (threadIdx.x == 0) *s_dup = 0;
}

// Enter the n staged terms (s_qc / s_qv, in term order), one atomicCAS a
// term; returns after the block's last __syncthreads, the table complete.
__device__ __forceinline__ void term_table_build(int2* s_tab,
                                                 const int* s_qc,
                                                 const float* s_qv, int n,
                                                 int* s_dup) {
  const int tid = threadIdx.x;
  // every term enters with 0.0f + its value (the compare loop's sum of one
  // match); a term whose id is there already flags a repeat
  for (int i = tid; i < n; i += blockDim.x) {
    const int c = s_qc[i];
    int h = term_slot(c);
    while (true) {
      const int prev = atomicCAS(&s_tab[h].x, kTermEmpty, c);
      if (prev == kTermEmpty) {
        s_tab[h].y = __float_as_int(__fadd_rn(0.0f, s_qv[i]));
        break;
      }
      if (prev == c) {
        *s_dup = 1;
        break;
      }
      h = term_next(h);
    }
  }
  __syncthreads();
  if (*s_dup) {
    // a repeated id: the first of its terms writes the f32 sum of their
    // values in term order
    for (int i = tid; i < n; i += blockDim.x) {
      const int c = s_qc[i];
      bool first = true;
      for (int j = 0; j < i && first; ++j) first = s_qc[j] != c;
      if (!first) continue;
      float sum = 0.0f;
      for (int j = i; j < n; ++j) {
        if (s_qc[j] == c) sum += s_qv[j];
      }
      int h = term_slot(c);
      while (s_tab[h].x != c) h = term_next(h);
      s_tab[h].y = __float_as_int(sum);
    }
    __syncthreads();
  }
}

// The summed values of N ids (0.0f for an id no term has): the first
// probes of all N are issued together; only when some lane's probe hit
// another id (rare at a load factor <= 1/2) does the warp walk on. PAD ids
// give 0.0f without a probe.
template <int N>
__device__ __forceinline__ void term_find_n(const int2* s_tab,
                                            const int (&c)[N],
                                            float (&a)[N]) {
  int h[N];
  int2 e[N];
  bool walk = false;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    h[j] = term_slot(c[j]);
    e[j] = c[j] != kTermEmpty ? s_tab[h[j]] : make_int2(kTermEmpty, 0);
    walk = walk || (e[j].x != c[j] && e[j].x != kTermEmpty);
  }
  if (__any_sync(__activemask(), walk)) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      while (e[j].x != c[j] && e[j].x != kTermEmpty) {
        h[j] = term_next(h[j]);
        e[j] = s_tab[h[j]];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    a[j] = e[j].x == c[j] ? __int_as_float(e[j].y) : 0.0f;
  }
}
