// Packed-index epilogue of the grouped scorers (K5), and their plain store.
//
// Replaces: seismic_tpu/ops/pallas_grouped.py::_make_pack (:204) and
// ::_window_max (:189), the epilogue that score_grouped_pallas,
// _score_grouped_i8 and _score_grouped_i8_item run on their [M, ROWS] score
// block when pack_idx is set (the "window" and "stride" candidate pools).
//
// A scorer leaves one work item's scaled f32 scores in shared memory,
// s_out[m * kRows + r]. store_packed then computes, for every query slot m
// and output column c < STEP = kRows / rk,
//   packed(r) = (bits(s_out[m, r]) & ~mask) | (col0 + r)
//   dst[m * row_stride + c] = max_{u < rk} packed(u * STEP + c)   (signed)
// with mask = 2^idx_bits - 1 (idx_bits from the group's row capacity, given
// by the caller) and col0 = work_s * kRows, the item's first row inside its
// group (an item walked in parts: store_packed_part, below). The integer
// max picks the window's best score (to 2^-(23-idx_bits)
// relative) together with its row; it never crosses a work item, so cells
// nothing wrote conflate only with cells nothing wrote.
//
// Bound on an H100: none of its own; it runs on data already in shared
// memory and shrinks the scorer's output rk-fold. Integer work on exact
// bit patterns: equal to the plain version bit for bit whenever the scores
// are.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ int pack_score(float s, int col, int mask) {
  return (__float_as_int(s) & ~mask) | col;
}

// [kM, kRows] f32 block -> dst[m * row_stride + r], 16-byte stores
// (row_stride and dst 16-byte aligned).
template <int kM, int kRows>
__device__ __forceinline__ void store_scores(const float* s_out, float* dst,
                                             int64_t row_stride, int tid,
                                             int n_threads) {
  for (int i = tid; i < kM * kRows / 4; i += n_threads) {
    const int m = i / (kRows / 4);
    const int c4 = i % (kRows / 4);
    reinterpret_cast<float4*>(dst + m * row_stride)[c4] =
        reinterpret_cast<const float4*>(s_out + m * kRows)[c4];
  }
}

// pack + window max over rk slices of STEP = kRows / rk rows (see above)
template <int kM, int kRows>
__device__ __forceinline__ void store_packed(const float* s_out, int* dst,
                                             int64_t row_stride, int col0,
                                             int mask, int rk, int tid,
                                             int n_threads) {
  const int step = kRows / rk;
  for (int i = tid; i < kM * step; i += n_threads) {
    const int m = i / step;
    const int c = i % step;
    const float* row = s_out + m * kRows;
    int best = pack_score(row[c], col0 + c, mask);
    for (int u = 1; u < rk; ++u) {
      const int r = u * step + c;
      best = max(best, pack_score(row[r], col0 + r, mask));
    }
    dst[m * row_stride + c] = best;
  }
}

// The same for one part of an item walked in parts (csub past 4): s_out
// holds the item's rows [r0, r0 + kRows), and every window column c <
// step (= item rows / rk) takes the max of the part's rows that land on
// it, r = c + u * step. The part that holds row c (u = 0) is the first to
// touch column c and writes it; a later part maxes into what the earlier
// ones wrote. Each cell is read and written by one thread, the same in
// every part, so the running max needs no barrier; an integer max of the
// same packed values in another order, so equal to the plain version's.
template <int kM, int kRows>
__device__ __forceinline__ void store_packed_part(const float* s_out,
                                                  int* dst,
                                                  int64_t row_stride,
                                                  int col0, int r0, int step,
                                                  int mask, int tid,
                                                  int n_threads) {
  for (int i = tid; i < kM * step; i += n_threads) {
    const int m = i / step;
    const int c = i % step;
    const int u0 = c >= r0 ? 0 : (r0 - c + step - 1) / step;
    int r = c + u0 * step;
    if (r >= r0 + kRows) continue;
    const float* row = s_out + m * kRows;
    int best = pack_score(row[r - r0], col0 + r, mask);
    for (r += step; r < r0 + kRows; r += step) {
      best = max(best, pack_score(row[r - r0], col0 + r, mask));
    }
    int* d = dst + m * row_stride + c;
    *d = u0 == 0 ? best : max(*d, best);
  }
}
