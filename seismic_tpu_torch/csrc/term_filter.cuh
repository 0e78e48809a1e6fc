// A membership filter in front of the term table (term_table.cuh), for
// K3's u8 form (rescore.cu::rescore_u8_kernel): a bitmap over every
// uint16, with the bits of a query row's staged terms (int16 ids, 0 ..
// 32767) set and every other bit clear, so a -1 (padding) id read as
// 65535 tests a clear bit with no sign check. A forward entry costs one
// 4-byte shared load and a rotate; only the entries whose bit is set
// (about 3% on the block-pool route) look their summed value up
// in the table, and since the bit says the id is there, that probe never
// ends on an empty slot.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "term_table.cuh"

constexpr int kFilterIds = 1 << 15;               // int16 ids 0 .. 32767
// words over every uint16: a -1 id (65535) tests a bit never set
constexpr int kFilterWords = (1 << 16) / 32;      // 2048 words, 8 KB

// Every bit clear; the caller synchronises before term_filter_build.
__device__ __forceinline__ void term_filter_clear(unsigned* s_bits) {
  for (int i = threadIdx.x; i < kFilterWords; i += blockDim.x) s_bits[i] = 0u;
}

// Set the bits of the n staged terms (one atomicOr a term; a term outside
// the int16 range matches no entry and sets nothing). No barrier: the
// caller synchronises before the first test (term_table_build's barrier
// does, when it runs after this).
__device__ __forceinline__ void term_filter_build(unsigned* s_bits,
                                                  const int* s_qc, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int c = s_qc[i];
    if (static_cast<unsigned>(c) < static_cast<unsigned>(kFilterIds)) {
      atomicOr(&s_bits[c >> 5], 1u << (c & 31));
    }
  }
}

// Bits 0 and 1: whether the low and the high uint16 of w (two ids, as a
// 16-byte load of int16 holds them) are staged terms; 0 for a -1 id. The
// low id's word is (w >> 5) mod 2048, its bit w mod 32; the high id's
// w >> 21 and (w >> 16) mod 32: the rotate takes its shift mod 32, so no
// id is masked out of its word first.
__device__ __forceinline__ unsigned term_filter_pair(const unsigned* s_bits,
                                                     unsigned w) {
  const unsigned lo = s_bits[(w >> 5) & (kFilterWords - 1)];
  const unsigned hi = s_bits[w >> 21];
  return (__funnelshift_r(lo, lo, w) & 1u) |
         ((__funnelshift_r(hi, hi, w >> 16) & 1u) << 1);
}

// The summed value of id c, which the table holds (its filter bit is
// set): the walk ends on c, never on an empty slot.
__device__ __forceinline__ float term_find_present(const int2* s_tab, int c) {
  int h = term_slot(c);
  int2 e = s_tab[h];
  while (e.x != c) {
    h = term_next(h);
    e = s_tab[h];
  }
  return __int_as_float(e.y);
}
