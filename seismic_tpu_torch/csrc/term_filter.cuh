// A membership filter in front of the term table (term_table.cuh), for
// K3's lean and half-width forms (rescore.cu::rescore_lean_kernel): a
// bitmap over every uint16. For int16 ids (0 .. 32767) the bits of a
// query row's staged terms are set and every other bit is clear, so a -1
// (padding) id read as 65535 tests a clear bit with no sign check, and a
// set bit proves the id is a term: the probe after it
// (term_find_present) never ends on an empty slot. For int32 ids (the
// wide forms, dim > 32766) each term sets the bit of its low 16 bits
// (kHashed): a set bit then says only that some term shares those bits,
// so the probe (term_find_or_zero) may end on an empty slot and give 0.
// A forward entry costs one 4-byte shared load and a rotate; only the
// entries whose bit is set (about 3% on the block-pool route) probe the
// table.
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

// Set the bits of the n terms of qc (the staged ones, or a row in device
// memory; one atomicOr a term): an int16 term's own bit (a term outside
// the int16 range matches no entry and sets nothing), or with kHashed the
// bit of its low 16 bits; a PAD term sets none. No barrier: the caller
// synchronises before the first test (term_table_build's barrier does,
// when it runs after this).
template <bool kHashed>
__device__ __forceinline__ void term_filter_build(unsigned* s_bits,
                                                  const int* qc, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int c = qc[i];
    if (kHashed ? c != kTermEmpty
                : static_cast<unsigned>(c) <
                      static_cast<unsigned>(kFilterIds)) {
      atomicOr(&s_bits[(c >> 5) & (kFilterWords - 1)], 1u << (c & 31));
    }
  }
}

// The bit of int32 id c's low 16 bits (kHashed filters): 1 when some term
// shares them.
__device__ __forceinline__ unsigned term_filter_one(const unsigned* s_bits,
                                                    unsigned c) {
  const unsigned w = s_bits[(c >> 5) & (kFilterWords - 1)];
  return __funnelshift_r(w, w, c) & 1u;
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
__device__ __forceinline__ float term_find_present(const int2* s_tab, int c,
                                                   int bits = kTermBits) {
  int h = term_slot(c, bits);
  int2 e = s_tab[h];
  while (e.x != c) {
    h = term_next(h, bits);
    e = s_tab[h];
  }
  return __int_as_float(e.y);
}

// The summed value of id c, or 0.0f where no term has it (the walk ends on
// an empty slot, whose value bits are 0; a PAD id finds the empty key).
__device__ __forceinline__ float term_find_or_zero(const int2* s_tab,
                                                   int c,
                                                   int bits = kTermBits) {
  int h = term_slot(c, bits);
  int2 e = s_tab[h];
  while (e.x != c && e.x != kTermEmpty) {
    h = term_next(h, bits);
    e = s_tab[h];
  }
  return e.x == c ? __int_as_float(e.y) : 0.0f;
}
