// Native host planner for the grouped (list-major) search path.
//
// A copy of seismic_tpu/native/planner.cpp (the C++ form of
// search/planner.py::plan_grouped_numpy): selects each query's top-`QC`
// terms, groups the batch's (query, list) pairs by posting list into
// M-slot groups (counting sort over list ids), and emits the
// per-super-tile work list in one pass over the batch.
//
// Semantics match the NumPy planner except the order of a query's top-QC
// terms (np.argpartition's internal order is unspecified); group
// composition can therefore differ while remaining plan-invariant
// (every valid pair maps to exactly one slot of a group whose list it
// selected; work items cover each group's super-tiles exactly once).
// Search results are identical either way - every pair is scored over its
// full list regardless of slot assignment.
//
// Built at first use by seismic_tpu_torch/native/__init__.py into the
// package's git-ignored _build/ directory.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

using i32 = int32_t;
using i64 = int64_t;

namespace {
constexpr i32 kSub = 128;
}

extern "C" {

// Fills caller-allocated buffers; returns 0 on success, negative on
// capacity overflow. n_out[0] = G (real groups), n_out[1] = W (real work
// items). Caller pre-fills padding defaults for group_*/slot_*/work_*
// beyond the returned counts.
int seismic_plan_grouped(
    const i32* q_comps, const float* q_vals,  // [B, Q] row-major
    i32 B, i32 Q, i32 QC, i32 M, i32 csub,
    const i32* list_region_start, const i32* list_len,
    const i32* list_post_start, i32 n_lists,
    i32 G_max, i64 W_max,
    i32* group_list, i32* group_region, i32* group_nrows,
    i32* slot_b,                     // [G_max * M]
    i32* work_region, i32* work_g, i32* work_s,  // [W_max]
    i32* pair_slot, i32* pair_pstart, i32* pair_valid,  // [B * QC]
    i32* pair_list, i32* pair_len, i32* slot_pair,      // [G_max * M]
    i32* n_out) {
  const i32 P_cap = B * QC;
  // ---- 1. per-query top-QC selection + valid-pair collection ----
  std::vector<i32> pb(P_cap), pq(P_cap), pl(P_cap);
  std::vector<i32> count(n_lists + 1, 0);
  i32 P = 0;
  std::vector<i32> idx(Q);
  for (i32 b = 0; b < B; ++b) {
    const i32* qc_row = q_comps + (i64)b * Q;
    const float* qv_row = q_vals + (i64)b * Q;
    i32 nsel = Q;
    for (i32 i = 0; i < Q; ++i) idx[i] = i;
    if (QC < Q) {
      std::nth_element(idx.begin(), idx.begin() + (QC - 1), idx.end(),
                       [&](i32 a, i32 c) { return qv_row[a] > qv_row[c]; });
      nsel = QC;
    }
    for (i32 s = 0; s < nsel; ++s) {
      const i32 pos = idx[s];
      const i32 lid = qc_row[pos];
      const float v = qv_row[pos];
      if (v <= 0.0f || lid < 0 || lid >= n_lists) continue;
      if (list_len[lid] <= 0) continue;
      pb[P] = b;
      pq[P] = s;  // slot index within the QC selection
      pl[P] = lid;
      ++count[lid];
      ++P;
    }
  }

  // ---- 2. counting sort by list id (stable: keeps b-major order) ----
  std::vector<i32> start(n_lists + 1, 0);
  for (i32 l = 0; l < n_lists; ++l) start[l + 1] = start[l] + count[l];
  std::vector<i32> sb(P), sq(P), sl(P);
  {
    std::vector<i32> cur(start.begin(), start.end() - 1);
    for (i32 p = 0; p < P; ++p) {
      const i32 l = pl[p];
      const i32 dst = cur[l]++;
      sb[dst] = pb[p];
      sq[dst] = pq[p];
      sl[dst] = l;
    }
  }

  // ---- 3. segment walk: M-slot groups + work items ----
  i32 G = 0;
  i64 W = 0;
  for (i32 p = 0; p < P;) {
    const i32 l = sl[p];
    i32 e = p;
    while (e < P && sl[e] == l) ++e;
    const i32 nrows = list_len[l];
    const i32 nsub = nrows > 0 ? (nrows + kSub - 1) / kSub : 1;
    const i32 nsup = (nsub + csub - 1) / csub;
    const i32 region_sup = list_region_start[l] / csub;
    for (i32 s = p; s < e; s += M) {
      if (G >= G_max) return -1;
      const i32 g = G++;
      group_list[g] = l;
      group_region[g] = list_region_start[l];
      group_nrows[g] = nrows;
      const i32 occ = std::min(M, e - s);
      for (i32 m = 0; m < occ; ++m) {
        const i32 b = sb[s + m];
        const i32 q = sq[s + m];
        slot_b[(i64)g * M + m] = b;
        const i32 pidx = b * QC + q;
        const i32 slot = g * M + m;
        pair_slot[pidx] = slot;
        pair_pstart[pidx] = list_post_start[l];
        pair_valid[pidx] = 1;
        pair_list[pidx] = l;
        pair_len[pidx] = nrows;
        slot_pair[slot] = (i64)b * QC + q;
      }
      if (W + nsup > W_max) return -2;
      for (i32 s2 = 0; s2 < nsup; ++s2) {
        work_region[W] = region_sup + s2;
        work_g[W] = g;
        work_s[W] = s2;
        ++W;
      }
    }
    p = e;
  }

  // invalid pairs dump to slot G * M (the padding group's first slot)
  const i32 dump = G * M;
  for (i32 p = 0; p < P_cap; ++p) {
    if (!pair_valid[p]) pair_slot[p] = dump;
  }

  n_out[0] = G;
  n_out[1] = (i32)W;
  return 0;
}

}  // extern "C"
