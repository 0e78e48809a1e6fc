"""Host-side query planner for the grouped (list-major) search path.

A copy of `seismic_tpu/search/planner.py`: the planner groups the
batch's (query, list) pairs BY LIST into M-slot groups, so the grouped
scorer streams each list's doc tiles once per group, and it emits an
exact per-super-tile work list. `plan_grouped` dispatches to the C++
counting-sort planner (`native/planner.cpp`, the default) or to the NumPy
reference `plan_grouped_numpy`; unlike the JAX package it never falls
back from one to the other silently.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..data.sparse import PAD_COMPONENT
from ..ops.tiles_prep import (
    SUB,
    ll_pad_for,
    packed_region_layout,
    tile_region_starts,
)
from ..types import _list_weights


def _round_up(x: int, m: int) -> int:
    return ((max(x, 1) + m - 1) // m) * m


@dataclass
class PlannerContext:
    """Host metadata the planner needs (derived once per index)."""

    list_region_start: np.ndarray  # int32 [n_lists] subtile units
    list_len: np.ndarray  # int32 [n_lists]
    list_post_start: np.ndarray  # int32 [n_lists] packed posting offset
    n_lists: int
    n_docs: int
    zero_region: int  # SUPER-tile index of an all-zero tile region
    # subtiles per work item (must match the DeviceIndex aligned layout)
    csub: int = 1
    # per-list max posting value (weighted-cut selection); None if the
    # index has no doc tiles
    list_weight: object = None

    @staticmethod
    def from_arrays(arrays, region_start=None, csub: int = 1):
        """Build from IndexArrays (+ the aligned-layout region starts that
        `prepare_pallas_tiles` computes).

        Bin-packed views (arrays.pack_bins) get the same EFFECTIVE list
        geometry the DeviceIndex serves — list_len := row_off + len,
        list_post_start := start - row_off — so the planners (NumPy, C++
        and the device-derived plan) emit packed-correct plans
        unchanged."""
        packed = arrays.pack_bins
        row_off = None
        if packed:
            region_start, row_off, n_sub_total = packed_region_layout(
                arrays.list_len, csub)
        else:
            if region_start is None:
                region_start = tile_region_starts(arrays, csub)
            list_len = arrays.list_len.astype(np.int64)
            n_tiles = np.maximum(1, -(-list_len // SUB))
            if csub > 1:
                n_tiles = csub * (-(-n_tiles // csub))
            n_sub_total = int(
                region_start[-1] + n_tiles[-1]
                if len(region_start)
                else 0
            )
        # pallas_align_doc_tiles pads ll_pad rows of zeros at the tail; the
        # last super-tile of the buffer is guaranteed zero.
        total_sub = (
            n_sub_total + ll_pad_for(arrays.max_list_len, csub) // SUB
        )
        zero_region = total_sub // csub - 1
        lw = None
        if arrays.doc_tile_scale is not None:
            lw = _list_weights(
                np.asarray(arrays.doc_tile_scale),
                np.asarray(arrays.list_post_start),
                np.asarray(arrays.list_len),
            )
        ll = np.asarray(arrays.list_len, np.int32)
        ps = np.asarray(arrays.list_post_start, np.int32)
        if row_off is not None:
            ll = ll + row_off
            ps = ps - row_off
        return PlannerContext(
            list_region_start=np.asarray(region_start, np.int32),
            list_len=ll,
            list_post_start=ps,
            n_lists=arrays.n_lists,
            n_docs=arrays.n_docs,
            zero_region=int(zero_region),
            csub=csub,
            list_weight=lw,
        )


@dataclass
class GroupedPlan:
    """Fixed-capacity host arrays describing one batch's grouped work.

    Group g = up to M (query, list) pairs sharing one posting list.
    Work item w = one (group, subtile) pair: the exact set of [SUB, V]
    tile DMAs the kernel performs (no padding waste).
    """

    M: int
    G: int  # real groups
    W: int  # real work items
    group_list: np.ndarray  # int32 [G_cap] list id (0 for padding)
    group_region: np.ndarray  # int32 [G_cap] subtile start
    group_nrows: np.ndarray  # int32 [G_cap] real posting rows (0 = pad)
    slot_b: np.ndarray  # int32 [G_cap, M] query index, B = invalid
    work_region: np.ndarray  # int32 [W_cap] subtile address
    work_g: np.ndarray  # int32 [W_cap] destination group
    work_s: np.ndarray  # int32 [W_cap] subtile slot within group
    pair_slot: np.ndarray  # int32 [B, QC] global slot (g*M + m)
    pair_pstart: np.ndarray  # int32 [B, QC] packed posting start
    pair_valid: np.ndarray  # bool [B, QC]
    pair_list: np.ndarray  # int32 [B, QC] selected list per pair (0 = pad)
    pair_len: np.ndarray  # int32 [B, QC] posting rows of the pair's list
    slot_pair: np.ndarray  # int32 [G_cap * M] inverse map: slot -> b*QC+qc

    @property
    def G_cap(self) -> int:
        return len(self.group_region)

    @property
    def W_cap(self) -> int:
        return len(self.work_region)

    def shape_key(self):
        """Static shape signature (drives jit specialization)."""
        B, QC = self.pair_slot.shape
        return (self.M, self.G_cap, self.W_cap, B, QC)


def plan_grouped(
    q_comps: np.ndarray,
    q_vals: np.ndarray,
    ctx: PlannerContext,
    query_cut: int,
    M: int = 8,
    native: bool = True,
) -> GroupedPlan:
    """Select each query's top-`query_cut` lists and group the resulting
    (query, list) pairs by list into M-slot groups: the C++ planner with
    `native=True` (raises RuntimeError when its library cannot be built),
    the NumPy planner with `native=False`."""
    if native:
        from ..native import plan_grouped_native

        return plan_grouped_native(q_comps, q_vals, ctx, query_cut, M=M)
    return plan_grouped_numpy(q_comps, q_vals, ctx, query_cut, M=M)


def plan_grouped_numpy(
    q_comps: np.ndarray,  # int32 [B, Q] PAD_COMPONENT padded
    q_vals: np.ndarray,  # f32 [B, Q]
    ctx: PlannerContext,
    query_cut: int,
    M: int = 8,
    g_round: int = 512,
    w_round: int = 2048,
) -> GroupedPlan:
    """NumPy reference planner: the reference's per-query term selection
    (inverted_index.rs:187-190) + per-term list scan redesigned as a
    batch-global, list-major schedule.
    """
    q_comps = np.asarray(q_comps)
    q_vals = np.asarray(q_vals)
    B, Q = q_comps.shape
    QC = min(query_cut, Q)

    # --- per-query top-QC term selection (k_largest_by equivalent) ---
    if QC < Q:
        top_pos = np.argpartition(-q_vals, QC - 1, axis=1)[:, :QC]
    else:
        top_pos = np.broadcast_to(np.arange(Q), (B, Q)).copy()
    lids = np.take_along_axis(q_comps, top_pos, axis=1)  # [B, QC]
    vals = np.take_along_axis(q_vals, top_pos, axis=1)
    valid = (
        (vals > 0)
        & (lids != PAD_COMPONENT)
        & (lids >= 0)
        & (lids < ctx.n_lists)
    )
    # empty lists produce zero scores; skip their pairs entirely
    valid &= ctx.list_len[np.where(valid, lids, 0)] > 0

    bb, qq = np.nonzero(valid)
    flat_l = lids[bb, qq].astype(np.int64)
    order = np.lexsort((bb, flat_l))
    sl = flat_l[order]
    sb = bb[order].astype(np.int32)
    sq = qq[order].astype(np.int32)
    P = sl.size

    if P == 0:
        G, W = 0, 0
        g_of_pair = np.zeros(0, np.int64)
        m_of_pair = np.zeros(0, np.int64)
        group_list_real = np.zeros(0, np.int64)
    else:
        new_seg = np.empty(P, bool)
        new_seg[0] = True
        np.not_equal(sl[1:], sl[:-1], out=new_seg[1:])
        seg_start = np.flatnonzero(new_seg)
        seg_id = np.cumsum(new_seg) - 1
        rank = np.arange(P) - seg_start[seg_id]
        gflag = (rank % M) == 0
        g_of_pair = np.cumsum(gflag) - 1
        m_of_pair = rank % M
        G = int(g_of_pair[-1]) + 1
        group_list_real = sl[gflag]

    G_cap = _round_up(G + 1, g_round)  # >= 1 padding group (the dump target)
    group_list = np.zeros(G_cap, np.int32)
    group_region = np.full(G_cap, ctx.zero_region, np.int32)
    group_nrows = np.zeros(G_cap, np.int32)
    slot_b = np.full((G_cap, M), B, np.int32)
    if G:
        group_list[:G] = group_list_real
        group_region[:G] = ctx.list_region_start[group_list_real]
        group_nrows[:G] = ctx.list_len[group_list_real]
        slot_b[g_of_pair, m_of_pair] = sb

    # --- work items: one per (group, super-tile of csub subtiles) ---
    csub = ctx.csub
    if G:
        nsub_g = np.maximum(
            1, -(-group_nrows[:G].astype(np.int64) // SUB)
        )
        nsup_g = -(-nsub_g // csub)
        W = int(nsup_g.sum())
    else:
        nsup_g = np.zeros(0, np.int64)
        W = 0
    W_cap = _round_up(W, w_round)
    work_g = np.full(W_cap, G, np.int32)  # padding -> dump group G
    work_s = np.zeros(W_cap, np.int32)
    work_region = np.full(W_cap, ctx.zero_region, np.int32)
    if W:
        wg = np.repeat(np.arange(G, dtype=np.int64), nsup_g)
        wstart = np.zeros(G, np.int64)
        np.cumsum(nsup_g[:-1], out=wstart[1:])
        ws = np.arange(W) - wstart[wg]
        work_g[:W] = wg
        work_s[:W] = ws
        # group_region is csub-aligned in subtile units by construction
        work_region[:W] = group_region[wg] // csub + ws

    # --- pair lookup tables (regroup kernel output to query order) ---
    dump_slot = G * M
    pair_slot = np.full((B, QC), dump_slot, np.int32)
    pair_pstart = np.zeros((B, QC), np.int32)
    pair_valid = np.zeros((B, QC), bool)
    pair_list = np.zeros((B, QC), np.int32)
    pair_len = np.zeros((B, QC), np.int32)
    slot_pair = np.zeros(G_cap * M, np.int32)
    if P:
        slot_index = (g_of_pair * M + m_of_pair).astype(np.int32)
        pair_slot[sb, sq] = slot_index
        pair_pstart[sb, sq] = ctx.list_post_start[sl]
        pair_valid[sb, sq] = True
        pair_list[sb, sq] = sl
        pair_len[sb, sq] = ctx.list_len[sl]
        slot_pair[slot_index] = sb.astype(np.int64) * QC + sq

    return GroupedPlan(
        M=M,
        G=G,
        W=W,
        group_list=group_list,
        group_region=group_region,
        group_nrows=group_nrows,
        slot_b=slot_b,
        work_region=work_region,
        work_g=work_g,
        work_s=work_s,
        pair_slot=pair_slot,
        pair_pstart=pair_pstart,
        pair_valid=pair_valid,
        pair_list=pair_list,
        pair_len=pair_len,
        slot_pair=slot_pair,
    )
