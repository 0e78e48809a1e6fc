// The term lookup shared by the projection (qloc.cu: K1, K8, K9) and the
// fused rescore (rescore.cu, K3): an open-addressed hash table in shared
// memory of one query row's real terms, built once a block. Up to 256
// terms K1 / K8 and K3 keep a static 512-slot table (kTermSlots); past
// them K1 / K8 and K3 size it at run time, in dynamic shared memory
// (2^term_bits(n) slots, a load factor <= 1/2), and K9's table of its
// plain terms and bucket entries takes 2^bits slots, sized by its caller.
// A row of more terms than a table takes is looked up term by term
// instead: term_walk goes over the row's terms in device memory, in term
// order, and sums the values of the id it looks for from 0.0f, which is
// what a table entry holds (below), so both give the same bits.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "qloc_common.cuh"

constexpr int kTermBits = 9;  // the static table, 512 slots
constexpr int kTermSlots = 1 << kTermBits;
constexpr int kTermStaticTerms = 256;  // the terms it takes (load <= 1/2)
constexpr int kTermMaxBits = 14;  // the largest, 16384 slots (128 KB)
// the most terms a table takes, at a load factor <= 1/2
constexpr int kTableMaxTerms = 1 << (kTermMaxBits - 1);
constexpr int kTermEmpty = kQlocPad;

// The bits of the table of n terms: the least 2^bits >= 2n, from
// kTermBits (n <= kTableMaxTerms).
__host__ __device__ inline int term_bits(int n) {
  int bits = kTermBits;
  while ((1 << bits) < 2 * n) ++bits;
  return bits;
}

// Bytes of dynamic shared memory for a row of n terms: the table of
// (int32 id, f32 value bits) entries, then the n staged ids and values;
// 0 past kTableMaxTerms, where the row is walked instead.
__host__ __device__ inline int term_smem(int n) {
  return n > kTableMaxTerms ? 0 : (8 << term_bits(n)) + 8 * n;
}
// the most term_smem gives (192 KB)
constexpr int kTermMaxSmem = (8 << kTermMaxBits) + 8 * kTableMaxTerms;

// The values of id c among the row's n terms (qc / qv in device memory,
// PAD padded) summed in term order from 0.0f, 0.0f for none (a PAD id
// too): what a table holds for c.
__device__ __forceinline__ float term_walk(const int* __restrict__ qc,
                                           const float* __restrict__ qv,
                                           int n, int c) {
  float s = 0.0f;
  if (c == kTermEmpty) return s;
  for (int i = 0; i < n; ++i) {
    if (__ldg(qc + i) == c) s = __fadd_rn(s, __ldg(qv + i));
  }
  return s;
}

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
                                            float (&a)[N],
                                            int bits = kTermBits) {
  int h[N];
  int2 e[N];
  bool walk = false;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    h[j] = term_slot(c[j], bits);
    e[j] = c[j] != kTermEmpty ? s_tab[h[j]] : make_int2(kTermEmpty, 0);
    walk = walk || (e[j].x != c[j] && e[j].x != kTermEmpty);
  }
  if (__any_sync(__activemask(), walk)) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      while (e[j].x != c[j] && e[j].x != kTermEmpty) {
        h[j] = term_next(h[j], bits);
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
