// The term lookup shared by the projection (qloc.cu: K1, K8, K9) and the
// fused rescore (rescore.cu, K3): an open-addressed hash table in shared
// memory of one query row's real terms, built once a block. The row's
// plain terms take a 512-slot table (kTermBits); K9's table of its plain
// terms and bucket entries (up to 1280 keys) takes 2^bits slots, sized by
// its caller for a load factor <= 5/16.
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

constexpr int kTermBits = 9;
constexpr int kTermSlots = 1 << kTermBits;  // >= 2 * kQlocMaxTerms
constexpr int kTermEmpty = kQlocPad;

__device__ __forceinline__ int term_slot(int c, int bits = kTermBits) {
  return static_cast<int>((static_cast<unsigned>(c) * 2654435761u) >>
                          (32 - bits));
}

__device__ __forceinline__ int term_next(int h, int bits = kTermBits) {
  return (h + 1) & ((1 << bits) - 1);
}

// Every slot empty (with value bits 0, so a probe that ends on an empty
// slot reads 0.0f) and *s_dup = 0; the caller synchronises before
// term_table_build.
__device__ __forceinline__ void term_table_clear(int2* s_tab, int* s_dup,
                                                 int bits = kTermBits) {
  for (int i = threadIdx.x; i < (1 << bits); i += blockDim.x) {
    s_tab[i] = make_int2(kTermEmpty, 0);
  }
  if (threadIdx.x == 0) *s_dup = 0;
}

// Enter the n staged terms (s_qc / s_qv, in term order), one atomicCAS a
// term; returns after the block's last __syncthreads, the table complete.
__device__ __forceinline__ void term_table_build(int2* s_tab,
                                                 const int* s_qc,
                                                 const float* s_qv, int n,
                                                 int* s_dup,
                                                 int bits = kTermBits) {
  const int tid = threadIdx.x;
  // every term enters with 0.0f + its value (the compare loop's sum of one
  // match); a term whose id is there already flags a repeat
  for (int i = tid; i < n; i += blockDim.x) {
    const int c = s_qc[i];
    int h = term_slot(c, bits);
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
      h = term_next(h, bits);
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
      int h = term_slot(c, bits);
      while (s_tab[h].x != c) h = term_next(h, bits);
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

// The 8 int16 codes of a 16-byte chunk of a vocab row, sign-extended:
// code j is the low (j even) or high half of word j / 2.
__device__ __forceinline__ void decode8(int4 chunk, int (&c)[8]) {
  const int w[4] = {chunk.x, chunk.y, chunk.z, chunk.w};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = (j & 1) ? (w[j >> 1] >> 16)
                   : static_cast<int>(static_cast<int16_t>(w[j >> 1]));
  }
}

// The summed values of 8 keys (0.0f for a key the table lacks; a
// kTermEmpty key ends on an empty slot, whose value bits are 0). A probe
// is one 8-byte shared load; the first probes of all 8 are issued
// together, and a collision walks on (rare at a load factor <= 1/2).
__device__ __forceinline__ void lookup8(const int2* s_tab, const int (&c)[8],
                                        float (&x)[8], int bits = kTermBits) {
  int h[8];
  int2 e[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    h[j] = term_slot(c[j], bits);
    e[j] = s_tab[h[j]];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    while (e[j].x != c[j] && e[j].x != kTermEmpty) {
      h[j] = term_next(h[j], bits);
      e[j] = s_tab[h[j]];
    }
    x[j] = e[j].x == c[j] ? __int_as_float(e[j].y) : 0.0f;
  }
}
