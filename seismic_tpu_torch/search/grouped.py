"""Grouped batch search: the list-major route.

Pipeline (planner -> device program), as in
`seismic_tpu/search/grouped.py`:

  plan   1. top-`query_cut` terms per query (or, with the weighted list
            cut, the top by value * the list's max posting value); (query,
            list) pairs grouped by list into M-slot groups, exact
            per-super-tile work list: on the host (search/planner.py, the
            C++ or NumPy planner) or derived on the device from the
            queries (`derive_plan_device`, torch sorts, scans and
            scatters), with the host supplying only the static capacities
            (`plan_caps`)
  device 2. per-pair query projection onto each list's local vocabulary:
            K1 (ops/qloc.py; quantized to int8 per pair for the i8 scorer,
            f32 for the bf16/f32 one), K8 (ops/qloc_rowmajor.py,
            qloc_mode "rowmajor"), K9 (ops/qloc_residue.py, an index
            uploaded with vocab_residue), or a plain lookup (qloc_mode
            "einsum"); on hashed tiles (an index uploaded with
            tile_hash=V) ONE projection row per query instead: K1 over the
            one vocab row arange(V), the query terms hashed to comp mod V
         3. slot expansion: each group's M projections side by side
         4. grouped scorer: each list's u8 doc tiles read once per group
            and scored for all M member queries: int8, slot-major
            (kernel_unroll 1: ops/grouped_scorer.py, K2) or work-item-major
            (kernel_unroll > 1: ops/grouped_scorer_item.py, K4, then
            `_item_regroup`); bf16 / f32, slot-major
            (ops/grouped_scorer_f.py, K6). For the "window" and "stride"
            pools the scorers pack each score with its row and take a
            window max in their epilogue (ops/pack_epilogue.py, K5).
            stream_frac < 1 (an index uploaded with super_summaries): only
            the top stream_frac of the work items, ranked by the group's
            projections . the super-tile's upper bounds, are scored, and
            the rows of the others are masked
         5. regroup to query order in the pool dtype (f32 or bf16), per-pair
            scale, length masks (on bin-packed views also the rows before
            each list's row offset, its bin-mates'), candidate pool:
            "exact" / "approx" (exact top-`pool` of the wall), "hier" and
            "slot" (top-t per pair, then a merge), "seg" (two-level segment
            pool), "window" and "stride" (packed pools)
         6. rescore > 0: exact rescore of the top `rescore` candidates from
            the forward rows (ops/rescore.py, K3), with the id dedup before
            it ("pre") or after it ("post"); rescore == 0: the overflow
            correction of the pool (or of its top `ovf_pool` unique
            candidates) and the id dedup; final top-k
            block_expand > 0 (an index uploaded from the blocks-as-rows
            view, `ops/tiles_prep.py::block_pool_arrays`): the pool holds
            block ids; each expands through block_start / block_len into
            up to block_expand member postings, all exact-rescored (K3),
            then a pre-rank, the id dedup and the top-k
         7. n_knn > 0: kNN refinement of the top-k (K3 on the neighbours)
         8. return_margin (rescore > 0): a third output, per-query
            pool-truncation diagnostics [B, 5] that the two-pass driver
            (search/twopass.py) turns into its margin

Two entry points: `search_grouped` (host plan) and
`search_grouped_derive` (device-derived plan; the bench headline path of
the JAX package, `bench.py:604-669`). Served: compute_dtype "i8", "bf16",
"f32"; qloc_mode "pallas", "rowmajor" (i8, no vocab_residue), "einsum";
an index uploaded with vocab_residue (qloc_mode "pallas" or "einsum");
hashed tiles; kernel_unroll 1, or > 1 with "i8" and pool_mode "exact",
"approx", "hier", "seg" or "stride"; every pool_mode; pool_select "exact"
and "approx" (every selection here is exact, as `approx_max_k` is on JAX's
CPU backend); pool_dtype "f32", "bf16"; dedup_mode "pre", "post"; rescore
> 0 and the overflow tail (rescore == 0); kNN refinement (n_knn > 0 with
a graph on the index: after the rescore tail, `knn_rounds` rounds of K3
over the neighbours of the top `knn_top` results, `_knn_refine_grouped`;
after the overflow tail, the engine's round); block_expand (the
block-pool lean path) on dense, hashed and bin-packed block views;
stream_frac < 1; return_margin; the weighted list cut; stop_after. What
the JAX package refuses raises ValueError: the streaming budget without
super summaries, with kernel_unroll > 1, with the window / stride pools
or on a bin-packed view; those pools on a bin-packed view; return_margin
with block_expand or without the rescore. The glue between the kernels
(top-k, sorts, scans, gathers, masks, the streaming budget's priorities)
is plain torch, and none of it reads a device value back to the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..data.sparse import PAD_COMPONENT
from ..ops import pack_epilogue
from ..ops.grouped_scorer import score_grouped_i8
from ..ops.grouped_scorer_f import score_grouped_f
from ..ops.grouped_scorer_item import score_grouped_i8_item
from ..ops.qloc import (
    project_qloc_f32,
    project_qloc_quantize,
    quantize_plain,
)
from ..ops.qloc_residue import project_qloc_residue
from ..ops.qloc_rowmajor import project_qloc_rowmajor
from ..ops.rescore import rescore_exact
from ..device import full_f32
from ..ops.tiles_prep import SUB, ll_pad_for
from ..types import DeviceIndex
from .engine import (
    SearchParams,
    _dedup_by_id,
    _knn_refine,
    _lookup,
    _query_terms,
    _sort_by_id_then_score,
    _top_k,
    densify_query_batch,
)
from .planner import GroupedPlan, PlannerContext, plan_grouped


@dataclass(frozen=True)
class GroupedParams:
    """Parameters of the grouped search program (the field names and
    defaults of `seismic_tpu.search.grouped.GroupedParams`; see its
    comments for every knob)."""

    k: int = 10
    score_cut: int = 64
    qloc_cut: int = 0
    pool: int = 128
    use_ovf: bool = True
    n_knn: int = 0
    knn_rounds: int = 1
    knn_top: int = 0
    compute_dtype: str = "bf16"
    ovf_pool: int = 64
    rescore: int = 0
    stream_frac: float = 1.0
    qloc_mode: str = "pallas"
    residue_scb: int = 16
    pool_mode: str = "approx"
    pool_recall: float = 0.98
    pool_per_pair: int = 12
    pool_seg_width: int = 32
    pool_window: int = 8
    pool_stride: int = 8
    pool_select: str = "exact"
    pool_dtype: str = "f32"
    dedup_mode: str = "pre"
    kernel_unroll: int = 1
    block_expand: int = 0
    rescore_chunk: int = 0
    stop_after: str = ""
    return_margin: bool = False


_STOPS = ("", "qloc", "expand", "kernel", "regroup", "pool", "prerank")
_POOL_MODES = ("exact", "approx", "hier", "slot", "seg", "window", "stride")


def _check_supported(params: GroupedParams, index=None) -> None:
    """Raise ValueError for values and combinations the JAX package
    refuses too; with `index`, also for those it refuses on that index
    (the streaming budget without super summaries or on a bin-packed
    view, the window / stride pools on a bin-packed view)."""
    i8 = params.compute_dtype == "i8"
    pack_idx = params.pool_mode in ("window", "stride")
    stream = params.stream_frac < 1.0
    invalid = [
        (params.compute_dtype not in ("i8", "bf16", "f32"),
         f"compute_dtype={params.compute_dtype!r}"),
        (params.qloc_mode not in ("pallas", "rowmajor", "einsum"),
         f"qloc_mode={params.qloc_mode!r}"),
        (params.pool_mode not in _POOL_MODES,
         f"pool_mode={params.pool_mode!r}"),
        (params.pool_select not in ("exact", "approx"),
         f"pool_select={params.pool_select!r}"),
        (params.pool_dtype not in ("f32", "bf16"),
         f"pool_dtype={params.pool_dtype!r}"),
        (params.dedup_mode not in ("pre", "post"),
         f"dedup_mode={params.dedup_mode!r}"),
        (params.stop_after not in _STOPS,
         f"stop_after={params.stop_after!r}"),
        (params.kernel_unroll < 1, f"kernel_unroll={params.kernel_unroll}"),
        (params.kernel_unroll > 1 and not i8,
         "kernel_unroll > 1 is i8-only"),
        (params.kernel_unroll > 1 and params.pool_mode in ("slot", "window"),
         f"kernel_unroll > 1 with pool_mode={params.pool_mode!r}"),
        (params.qloc_mode == "rowmajor" and not i8,
         "rowmajor qloc is i8-only"),
        (params.return_margin and params.block_expand > 0,
         "return_margin is only implemented on the rescore path, not with "
         "block_expand"),
        (params.return_margin and params.block_expand <= 0
         and params.rescore <= 0,
         "return_margin requires rescore > 0 (the margin's bias estimate "
         "needs the exact-vs-approx rescore gap)"),
        (stream and params.kernel_unroll > 1,
         "kernel_unroll with stream_frac < 1 is unsupported"),
        (stream and pack_idx,
         f"pool_mode={params.pool_mode!r} with stream_frac < 1 is "
         "unsupported"),
    ]
    if index is not None:
        packed = index.list_row_off is not None
        invalid += [
            (stream and index.super_summary is None,
             "stream_frac < 1 needs to_device(super_summaries=True)"),
            (packed and pack_idx,
             "pool_mode 'window'/'stride' folds bin-mates' rows in the "
             "scorer; unsupported with bin-packed (pack_bins) views"),
            (packed and stream,
             "stream_frac < 1 is unsupported with bin-packed views"),
        ]
    for bad, what in invalid:
        if bad:
            raise ValueError(f"grouped search: {what}")


# plan fields, in the packed order of the JAX package (grouped.py:204-219)
_PLAN_FIELDS = (
    "group_list", "group_region", "group_nrows", "slot_b", "work_region",
    "work_g", "work_s", "pair_slot", "pair_pstart", "pair_valid",
    "pair_list", "pair_len", "slot_pair",
)


@dataclass
class DevicePlan:
    """Device mirror of a GroupedPlan: its int32 fields as tensors
    (pair_valid is bool). A host plan arrives in ONE host->device copy
    (`put`: views of one packed buffer); `derive_plan_device` builds one on
    the device. G and W are the real group and work-item counts: ints for
    a host plan, 0-dim device tensors for a derived one (reading them is a
    host sync; the search never does)."""

    group_list: torch.Tensor  # [G_cap]
    group_region: torch.Tensor  # [G_cap]
    group_nrows: torch.Tensor  # [G_cap]
    slot_b: torch.Tensor  # [G_cap, M]
    work_region: torch.Tensor  # [W_cap]
    work_g: torch.Tensor  # [W_cap]
    work_s: torch.Tensor  # [W_cap]
    pair_slot: torch.Tensor  # [B, QC]
    pair_pstart: torch.Tensor  # [B, QC]
    pair_valid: torch.Tensor  # bool [B, QC]
    pair_list: torch.Tensor  # [B, QC]
    pair_len: torch.Tensor  # [B, QC]
    slot_pair: torch.Tensor  # [G_cap * M]
    M: int = 8
    G: int | torch.Tensor | None = None
    W: int | torch.Tensor | None = None

    @staticmethod
    def put(plan: GroupedPlan, device) -> "DevicePlan":
        parts = [np.ascontiguousarray(getattr(plan, f), dtype=np.int32)
                 for f in _PLAN_FIELDS]
        packed = torch.from_numpy(
            np.concatenate([p.reshape(-1) for p in parts])).to(device)
        views = torch.split(packed, [p.size for p in parts])
        fields = {f: v.view(p.shape)
                  for f, v, p in zip(_PLAN_FIELDS, views, parts)}
        fields["pair_valid"] = fields["pair_valid"].bool()
        return DevicePlan(**fields, M=plan.M, G=plan.G, W=plan.W)


def _scatter_drop(n: int, fill, idx, src):
    """`jnp.full(n, fill).at[idx].set(src, mode="drop")`: indices outside
    [0, n) go to one extra dump slot, which is cut off."""
    idx = idx.long()
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    buf = torch.full((n + 1,), fill, dtype=src.dtype, device=src.device)
    return buf.scatter_(0, idx, src)[:n]


def _weighted_terms(index: DeviceIndex, q_comps, q_vals, QC: int):
    """(list ids int32 [B, QC], their values f32 [B, QC]) of each query's
    top-QC terms ranked by value * list_weight[term] (0 for a term that
    names no list), padding valued 0."""
    if index.list_weight is None:
        raise ValueError("the weighted list cut needs list weights (an "
                         "index uploaded with doc tiles)")
    n_lists = index.list_len.shape[0]
    valid = q_comps != int(PAD_COMPONENT)
    qv = torch.where(valid, q_vals, 0.0)
    if QC == q_comps.shape[1]:
        return q_comps, qv
    okc = valid & (q_comps >= 0) & (q_comps < n_lists)
    w = torch.where(
        okc, index.list_weight[q_comps.clamp(0, n_lists - 1).long()], 0.0)
    _, top_p = _top_k(qv * w, QC)
    return torch.gather(q_comps, 1, top_p), torch.gather(qv, 1, top_p)


def derive_plan_device(
    index: DeviceIndex,
    q_comps,  # int32 [B, Q] PAD_COMPONENT padded
    q_vals,  # f32 [B, Q]
    query_cut: int,
    M: int,
    G_cap: int,
    W_cap: int,
    zero_region: int,  # SUPER-tile units (PlannerContext.zero_region)
    weighted: bool = False,
) -> DevicePlan:
    """Build the grouped plan ON THE DEVICE from the queries (sorts, scans,
    scatters; `seismic_tpu/search/grouped.py::derive_plan_device`): the
    host only supplies the static capacities (G_cap, W_cap, from
    `plan_caps`). With `weighted`, each query's lists are its top-QC
    terms by value * the list's max posting value (`list_weight`), as
    `plan_caps(weighted=True)` selects them. Group composition equals the
    host planner's whenever both pick the same top-QC lists. Nothing is
    read back to the host."""
    B, Q = q_comps.shape
    QC = min(query_cut, Q)
    P = B * QC
    csub = index.tile_csub
    n_lists = index.list_len.shape[0]
    dev = q_comps.device

    if weighted:
        lids, top_v = _weighted_terms(index, q_comps, q_vals, QC)
    else:
        lids, top_v, _ = _query_terms(q_comps, q_vals, QC)
    safe_l = lids.clamp(0, n_lists - 1)
    llen = index.list_len[safe_l.long()]
    valid = ((top_v > 0) & (lids >= 0) & (lids < n_lists)
             & (llen > 0)).reshape(P)
    keys = torch.where(valid, safe_l.reshape(P), n_lists).to(torch.int32)
    # stable: pairs of one list stay in (query, qc-slot) order
    sl, sp = torch.sort(keys, stable=True)
    sp = sp.to(torch.int32)
    valid_s = sl < n_lists

    idx = torch.arange(P, dtype=torch.int32, device=dev)
    new_seg = torch.ones(P, dtype=torch.bool, device=dev)
    new_seg[1:] = sl[1:] != sl[:-1]
    seg_start = torch.cummax(torch.where(new_seg, idx, 0), 0).values
    rank = idx - seg_start
    m_of = rank % M
    gflag = valid_s & (m_of == 0)
    g_of = torch.cumsum(gflag, 0, dtype=torch.int32) - 1
    G = gflag.sum(dtype=torch.int32)

    dump_slot = G_cap * M - 1  # a padding group's slot; masked downstream
    slot = g_of * M + m_of
    scat_g = torch.where(gflag, g_of, G_cap)  # dropped for non-leads
    scat_s = torch.where(valid_s, slot, G_cap * M)  # invalid pairs dropped
    safe_sl = sl.clamp(max=n_lists - 1).long()
    sl_len = index.list_len[safe_sl]
    sl_pstart = index.list_post_start[safe_sl]

    group_list = _scatter_drop(G_cap, 0, scat_g, sl)
    group_nrows = _scatter_drop(G_cap, 0, scat_g, sl_len)
    group_region = _scatter_drop(G_cap, 0, scat_g,
                                 index.list_region_start[safe_sl])
    slot_b = _scatter_drop(G_cap * M, B, scat_s, sp // QC).reshape(G_cap, M)
    slot_pair = _scatter_drop(G_cap * M, 0, scat_s, sp)
    # pair tables, indexed by the original (b, qc-slot) flat position
    scat_p = torch.where(valid_s, sp, P)
    pair_slot = _scatter_drop(P, dump_slot, scat_p, slot)
    pair_pstart = _scatter_drop(P, 0, scat_p, sl_pstart)
    pair_valid = _scatter_drop(P, False, scat_p, torch.ones_like(valid_s))
    pair_list = _scatter_drop(P, 0, scat_p, sl)
    pair_len = _scatter_drop(P, 0, scat_p, sl_len)

    # work list: one item per (group, super-tile); item -> group by a
    # binary search over the cumulative super-tile counts
    gidx = torch.arange(G_cap, dtype=torch.int32, device=dev)
    nsub = torch.clamp(-(-group_nrows // SUB), min=1)
    nsup = torch.where(gidx < G, -(-nsub // csub), 0).to(torch.int32)
    S0 = torch.zeros(G_cap + 1, dtype=torch.int32, device=dev)
    S0[1:] = torch.cumsum(nsup, 0, dtype=torch.int32)
    W = S0[-1]
    w = torch.arange(W_cap, dtype=torch.int32, device=dev)
    g_w = torch.searchsorted(S0[1:], w, right=True).to(torch.int32)
    g_w = g_w.clamp(max=G_cap - 1)
    s_w = w - S0[g_w.long()]
    valid_w = w < W
    region_w = group_region[g_w.long()] // csub + s_w
    return DevicePlan(
        group_list=group_list,
        group_region=group_region,
        group_nrows=group_nrows,
        slot_b=slot_b,
        work_region=torch.where(valid_w, region_w, zero_region),
        work_g=torch.where(valid_w, g_w, G.clamp(max=G_cap - 1)),
        work_s=torch.where(valid_w, s_w, 0),
        pair_slot=pair_slot.reshape(B, QC),
        pair_pstart=pair_pstart.reshape(B, QC),
        pair_valid=pair_valid.reshape(B, QC),
        pair_list=pair_list.reshape(B, QC),
        pair_len=pair_len.reshape(B, QC),
        slot_pair=slot_pair,
        M=M, G=G, W=W,
    )


def _item_regroup(scores_item, plan: DevicePlan, csub: int, NSUP: int):
    """Regroup a work-item-major scorer output [W_cap, M, STEP] to pair
    order [B*QC, NSUP*STEP]: a group's items are consecutive in the work
    list, so pair (g, m) reads rows (w0[g] + s) * M + m, where w0 is the
    per-group item prefix sum (recomputed from group_nrows, identical to
    the planners' layout). Columns past a pair's real item count read a
    NEIGHBOUR group's rows (clipped at the end); they are always masked
    downstream because their posting offset s * STEP >= nsup * STEP >=
    pair_len."""
    W_cap, M, STEP = scores_item.shape
    nrows = plan.group_nrows
    nsub = torch.clamp(-(-nrows // SUB), min=1)
    nsup = torch.where(nrows > 0, -(-nsub // csub), 0).long()
    w0 = torch.cumsum(nsup, 0) - nsup  # exclusive prefix sum
    slot = plan.pair_slot.reshape(-1).long()  # [P]
    g_p = torch.div(slot, M, rounding_mode="floor")
    m_p = slot % M
    rows = ((w0[g_p][:, None]
             + torch.arange(NSUP, device=slot.device)[None, :]) * M
            + m_p[:, None])  # [P, NSUP]
    rows = rows.clamp(0, W_cap * M - 1)
    out = scores_item.reshape(W_cap * M, STEP)[rows]  # [P, NSUP, STEP]
    return out.reshape(slot.shape[0], NSUP * STEP)


def _residue_buckets(top_c, top_v, R: int, scb: int):
    """Per-query residue-bucketed term tables for the bucketed projection
    kernel (K9): terms are grouped by `term % R` into R buckets of `scb`
    slots, keeping value order (top_c / top_v arrive value-sorted and the
    sort is stable), so bucket overflow drops only the smallest values.
    Returns (qcb int32 [B, R*scb] with -2 padding, qvb f32 [B, R*scb])."""
    B, sc = top_c.shape
    dev = top_c.device
    valid = (top_c != int(PAD_COMPONENT)) & (top_c >= 0)
    r_key = torch.where(valid, top_c % R, R).to(torch.int32)
    pos = torch.arange(sc, dtype=torch.int32, device=dev).expand(B, sc)
    # JAX's two-key sort (residue, position): a stable sort by residue
    order = torch.sort(r_key, dim=1, stable=True).indices
    rk_s = torch.gather(r_key, 1, order)
    c_s = torch.gather(top_c.to(torch.int32), 1, order)
    v_s = torch.gather(top_v, 1, order)
    new_grp = torch.ones((B, sc), dtype=torch.bool, device=dev)
    new_grp[:, 1:] = rk_s[:, 1:] != rk_s[:, :-1]
    seg_start = torch.cummax(torch.where(new_grp, pos, 0), dim=1).values
    rank = pos - seg_start
    dump = R * scb  # one extra column takes what does not fit; cut off
    dst = torch.where((rank < scb) & (rk_s < R), rk_s * scb + rank,
                      dump).long()
    qcb = torch.full((B, dump + 1), -2, dtype=torch.int32,
                     device=dev).scatter_(1, dst, c_s)[:, :dump]
    qvb = torch.zeros((B, dump + 1), dtype=torch.float32,
                      device=dev).scatter_(1, dst, v_s)[:, :dump]
    return qcb.contiguous(), qvb.contiguous()


def _ovf_correction(index: DeviceIndex, qd_top, top_scores, safe_post):
    """Re-rank a candidate pool with each occurrence's out-of-vocab
    overflow entries: adds back the dot mass the local-vocab tile
    truncates. qd_top: the dense copy of the queries' top terms."""
    qmatch = _lookup(qd_top, index.tile_ovf_comps[safe_post])
    ov = index.tile_ovf_vals[safe_post].to(torch.float32)
    correction = (qmatch * ov).sum(dim=-1)
    return torch.where(torch.isfinite(top_scores), top_scores + correction,
                       top_scores)


@dataclass
class _Stopped:
    """The output of the stage `stop_after` names."""

    out: torch.Tensor


def _grouped_impl(index: DeviceIndex, plan: DevicePlan, q_comps, q_vals,
                  params: GroupedParams):
    """The device program of the grouped route; returns (scores f32 [B, k],
    ids int64 [B, k], -1 where no result), with `return_margin` also the
    diagnostics f32 [B, 5] (`_margin_diag`), or with `stop_after` the
    named stage's output twice, as the JAX program does."""
    pooled = _grouped_pool(index, plan, q_comps, q_vals, params)
    if isinstance(pooled, _Stopped):
        return pooled.out, pooled.out
    if params.stop_after == "pool":
        return pooled[3], pooled[4]
    return _grouped_tail(index, params, q_comps, q_vals, *pooled)


def _project(index: DeviceIndex, plan: DevicePlan, top_c, top_v, scq: int,
             params: GroupedParams):
    """Per-pair projections on the compact [P] pair grid: (q_i8 int8 [P, V],
    pair_scale f32 [P]) for the i8 scorer, (qloc f32 [P, V], None)
    otherwise. On hashed tiles one row per QUERY ([B, V]; the i8 scale
    broadcast to the [P] pair grid)."""
    QC = plan.pair_list.shape[1]
    i8 = params.compute_dtype == "i8"
    pair_list = plan.pair_list.reshape(-1)
    tc = top_c[:, :scq].contiguous()
    tv = top_v[:, :scq].contiguous()
    if index.tile_hash:
        return _project_hashed(index.tile_hash, tc, tv, QC, i8)
    # int16 vocab up to dim 32766, int32 past it (the JAX package's
    # vocab16 / list_vocab choice, grouped.py:669-672, 705-710): K1 and
    # K8 take either
    vocab = index.vocab
    R = index.vocab_residue
    if params.qloc_mode == "rowmajor":
        if R:
            raise ValueError("rowmajor qloc and vocab_residue are exclusive")
        # the kernel's contract (K8): every pair brings its vocab row and
        # its term row
        return project_qloc_rowmajor(
            vocab[pair_list.long()],
            tc.repeat_interleave(QC, dim=0), tv.repeat_interleave(QC, dim=0))
    if params.qloc_mode == "einsum":
        # JAX's `_qloc_compare`; a slot matches at most one term, so the
        # one-hot sum is a lookup in the dense copy of the top terms
        qd = densify_query_batch(tc, tv, index.dim)
        qloc = _lookup(qd, vocab[plan.pair_list.long()]).reshape(
            pair_list.shape[0], -1)
        return quantize_plain(qloc) if i8 else (qloc, None)
    if R:
        qcb, qvb = _residue_buckets(tc, tv, R, params.residue_scb)
        out = project_qloc_residue(vocab, pair_list, qcb, qvb, tc,
                                   tv, QC, R, params.residue_scb, quantize=i8)
        return out if i8 else (out, None)
    if i8:
        return project_qloc_quantize(vocab, pair_list, tc, tv, QC)
    return project_qloc_f32(vocab, pair_list, tc, tv, QC), None


def hashed_qloc_operands(V: int, tc, tv):
    """K1's operands of the hashed projection (`seismic_tpu/search/
    grouped.py:614-640`): one shared vocab row arange(V) (int16), a zero
    pair list of length B (QC = 1) and the query terms hashed to comp mod
    V, padding kept. tc int32 / tv f32 [B, SC]."""
    dev = tc.device
    pad = int(PAD_COMPONENT)
    qch = torch.where(tc == pad, pad, tc % V).to(torch.int32).contiguous()
    return (torch.arange(V, dtype=torch.int16, device=dev).reshape(1, V),
            torch.zeros(tc.shape[0], dtype=torch.int32, device=dev), qch,
            tv.contiguous(), 1)


def _project_hashed(V: int, tc, tv, QC: int, i8: bool):
    """The hashed projection, one row per query: K1 on
    `hashed_qloc_operands`. Returns (q_i8 int8 [B, V], the per-query
    scale repeated to the [B * QC] pair grid) or (qloc f32 [B, V],
    None)."""
    ops = hashed_qloc_operands(V, tc, tv)
    if not i8:
        return project_qloc_f32(*ops), None
    q_i8, scale = project_qloc_quantize(*ops)
    return q_i8, scale.repeat_interleave(QC)


def _candidates(index: DeviceIndex, plan: DevicePlan, top_scores, sel,
                LLMAX: int):
    """Pool positions `sel` (qc slot * LLMAX + row) to (f32 scores, doc
    ids with n_docs where empty, clipped posting index)."""
    top_scores = top_scores.to(torch.float32)
    qc_slot = torch.div(sel, LLMAX, rounding_mode="floor")
    off = sel % LLMAX
    post_sel = torch.gather(plan.pair_pstart, 1, qc_slot) + off
    safe_post = post_sel.clamp(0, index.postings.shape[0] - 1)
    cand_ids = index.postings[safe_post]
    cand_ids = torch.where(torch.isfinite(top_scores), cand_ids,
                           index.n_docs)
    return top_scores, cand_ids, safe_post


def _grouped_pool(index: DeviceIndex, plan: DevicePlan, q_comps, q_vals,
                  params: GroupedParams):
    """The grouped program up to its candidate pool: `_grouped_tail`'s
    arguments after (index, params), or a `_Stopped` stage output."""
    _check_supported(params, index)
    if index.doc_tiles_aligned is None:
        raise ValueError("the grouped route needs an index built with doc "
                         "tiles (layout.summary_vocab_cap > 0)")
    B = q_comps.shape[0]
    G_cap, M = plan.slot_b.shape
    V = index.doc_tiles_aligned.shape[1]
    k = params.k
    csub = index.tile_csub
    LLMAX = ll_pad_for(index.max_list_len, csub)
    dev = q_comps.device
    stop = params.stop_after

    top_c, top_v, sc = _query_terms(q_comps, q_vals, params.score_cut)
    QC = plan.pair_list.shape[1]
    P = B * QC

    # ---- per-pair projections (K1 / K8 / K9), expanded to slot order ----
    scq = min(params.qloc_cut, sc) if params.qloc_cut > 0 else sc
    qloc_pairs, pair_scale = _project(index, plan, top_c, top_v, scq, params)
    if stop == "qloc":
        return _Stopped(qloc_pairs)
    slot_src = plan.slot_pair.long()
    if index.tile_hash:
        slot_src = torch.div(slot_src, QC, rounding_mode="floor")  # query
    qloc = qloc_pairs[slot_src].reshape(G_cap, M, V)
    qsum = None
    if pair_scale is None:
        # 128 * sum_v qloc for the centred-tile form, from the f32 qloc
        qsum = (128.0 * qloc_pairs.sum(dim=-1))[slot_src].reshape(G_cap, M)
    if stop == "expand":
        return _Stopped(qloc)

    # ---- the streaming budget: the top stream_frac of the work items ----
    work_region, work_g, work_s = plan.work_region, plan.work_g, plan.work_s
    NSUP = LLMAX // (csub * SUB)
    streamed = None
    if params.stream_frac < 1.0:
        work_region, work_g, work_s, streamed = _stream_budget(
            index, plan, qloc, pair_scale, params.stream_frac, NSUP)

    # ---- grouped tile scoring (K2 / K4 / K6), K5 epilogue when packed ----
    pack_idx = params.pool_mode in ("window", "stride")
    rk = 1
    if params.pool_mode == "stride":
        # the kernel's share of the stride max: slices 128 rows apart
        rk = max(1, min(params.pool_stride, csub))
    pack_window = rk if pack_idx else 0
    item_major = params.kernel_unroll > 1
    tiles, tscale = index.doc_tiles_aligned, index.tile_scale
    if item_major:
        W_cap = plan.work_region.shape[0]
        if W_cap % params.kernel_unroll:
            raise ValueError(f"W_cap={W_cap} is not a multiple of "
                             f"kernel_unroll={params.kernel_unroll}")
        scores = score_grouped_i8_item(
            tiles, tscale, qloc, work_region, work_g, csub, work_s, LLMAX,
            pack_window)  # [W_cap, M, csub*128 / rk]
    elif pair_scale is not None:
        scores = score_grouped_i8(
            tiles, tscale, qloc, work_region, work_g, work_s, LLMAX, csub,
            pack_window)  # [G_cap, M, LLMAX / rk], unmasked
    else:
        scores = score_grouped_f(
            tiles, tscale, qloc, qsum, work_region, work_g, work_s, LLMAX,
            csub, params.compute_dtype, pack_window)
    if stop == "kernel":
        return _Stopped(scores)
    pslot = plan.pair_slot.reshape(P).long()
    # bin-packed views: rows [0, row_off) of a pair's window are its
    # bin-mates', scored against the wrong projection (plan.pair_len and
    # group_nrows are already the effective row_off + len)
    roff_pair = roff_group = None
    if index.list_row_off is not None:
        nl = index.list_row_off.shape[0]
        roff_pair = index.list_row_off[plan.pair_list.clamp(0, nl - 1).long()]
        roff_group = index.list_row_off[
            plan.group_list.clamp(0, nl - 1).long()]
    pool = min(params.pool if params.pool > 0 else 8 * k, QC * LLMAX)

    def done(top_scores, sel, pool):
        return (top_c, top_v, sc,
                *_candidates(index, plan, top_scores, sel, LLMAX), pool)

    if pack_idx:
        # ---- packed pools: each packed value carries its row offset ----
        imask = pack_epilogue.idx_mask(LLMAX)
        plen = plan.pair_len[:, :, None]
        if params.pool_mode == "stride":
            # regroup first (reads only real pairs' rows), then the rest of
            # the stride max pair-major: rows >= 32 apart within one work
            # item. Cells nothing wrote conflate only with cells of the
            # same item, masked below by the item's start row.
            ROWS = csub * SUB
            step_k = ROWS // rk
            Wk = LLMAX // rk
            if item_major:
                pw = _item_regroup(scores, plan, csub, NSUP)
            else:
                pw = scores.reshape(G_cap * M, Wk)[pslot]
            pw = pw.reshape(B, QC, Wk)
            rx = max(1, min(params.pool_stride // rk, step_k // 32))
            if rx > 1:
                S = Wk // step_k
                pw = pw.reshape(B, QC, S, rx, step_k // rx).amax(dim=3)
                pw = pw.reshape(B, QC, S * (step_k // rx))
            NW = Wk // rx
            s_row = torch.div(
                torch.arange(NW, dtype=torch.int32, device=dev),
                step_k // rx, rounding_mode="floor") * ROWS
            val, off = pack_epilogue.unpack(pw, LLMAX)
            ok = plan.pair_valid[:, :, None] & (s_row < plen) & (off < plen)
        else:
            WP = params.pool_window
            if LLMAX % WP:
                raise ValueError(f"pool_window={WP} does not divide the "
                                 f"row capacity {LLMAX}")
            NW = LLMAX // WP
            # lax.reduce_window starts from -2^31 + 1
            wmax = scores.reshape(G_cap, M, NW, WP).amax(dim=-1).clamp(
                min=-(2 ** 31) + 1)
            # windows past a group's rows hold whatever memory held
            win_real = (torch.arange(NW, dtype=torch.int32, device=dev)
                        * WP)[None, :] < plan.group_nrows[:, None]
            neg_inf_bits = int(np.float32(-np.inf).view(np.int32))
            wmax = torch.where(win_real[:, None, :], wmax, neg_inf_bits)
            pw = wmax.reshape(G_cap * M, NW)[pslot].reshape(B, QC, NW)
            val, off = pack_epilogue.unpack(pw, LLMAX)
            ok = plan.pair_valid[:, :, None] & (off < plen)
        if pair_scale is not None:
            val = val * pair_scale.reshape(B, QC, 1)
        val = torch.where(ok, val, -torch.inf)
        if stop == "regroup":
            return _Stopped(val)
        gsel = (torch.arange(QC, dtype=torch.int32, device=dev)[None, :, None]
                * LLMAX + off).reshape(B, QC * NW).long()
        pool = min(pool, QC * NW)
        top_scores, p1 = _top_k(val.reshape(B, QC * NW), pool)
        return done(top_scores, torch.gather(gsel, 1, p1), pool)

    rows = torch.arange(LLMAX, dtype=torch.int32, device=dev)
    if params.pool_mode == "slot":
        # ---- pool on the scorer's slot grid, then regroup [P, t] ----
        t = min(params.pool_per_pair, LLMAX)
        rows_ok_slot = rows[None, :] < plan.group_nrows[:, None]
        if roff_group is not None:
            rows_ok_slot &= rows[None, :] >= roff_group[:, None]
        if streamed is not None:
            rows_ok_slot &= streamed.repeat_interleave(csub * SUB, dim=-1)
        m3 = rows_ok_slot[:, None, :] & (plan.slot_b < B)[:, :, None]
        sl = torch.where(m3, scores, -torch.inf).reshape(G_cap * M, LLMAX)
        v1, i1 = _top_k(sl, t)
        v1p = v1[pslot].reshape(B, QC, t)
        i1p = i1[pslot].reshape(B, QC, t)
        if pair_scale is not None:
            v1p = v1p * pair_scale.reshape(B, QC, 1)
        v1p = torch.where(plan.pair_valid[..., None], v1p, -torch.inf)
        if stop == "regroup":
            return _Stopped(v1p)
        gsel = (torch.arange(QC, device=dev)[None, :, None] * LLMAX
                + i1p).reshape(B, QC * t)
        pool = min(pool, QC * t)
        top_scores, p1 = _top_k(v1p.reshape(B, QC * t), pool)
        return done(top_scores, torch.gather(gsel, 1, p1), pool)

    # ---- regroup to query order in the pool dtype, scale, mask ----
    pdt = torch.bfloat16 if params.pool_dtype == "bf16" else torch.float32
    if item_major:
        pv = _item_regroup(scores.to(pdt), plan, csub, NSUP)
    else:
        pv = scores.to(pdt).reshape(G_cap * M, LLMAX)[pslot]
    pv = pv.reshape(B, QC, LLMAX)
    if pair_scale is not None:
        # one f32 product rounded to the pool dtype, as XLA does in bf16
        pv = pv * pair_scale.reshape(B, QC, 1).to(pdt)
    rows_ok = (rows[None, None, :] < plan.pair_len[..., None]) & (
        plan.pair_valid[..., None])
    if roff_pair is not None:
        rows_ok &= rows[None, None, :] >= roff_pair[..., None]
    if streamed is not None:
        # rows of the super-tiles the budget skipped were never written
        pair_group = torch.div(plan.pair_slot, M, rounding_mode="floor")
        st = streamed[pair_group.clamp(max=G_cap - 1).long()]  # [B, QC, NS]
        rows_ok &= st.repeat_interleave(csub * SUB, dim=-1)
    pv = torch.where(rows_ok, pv, -torch.inf).reshape(B, QC * LLMAX)
    if stop == "regroup":
        return _Stopped(pv)

    # ---- candidate pool (exact selection; the narrow stages keep
    # lax.top_k's tie order, which the bf16 wall is full of) ----
    segw = params.pool_seg_width
    if params.pool_mode == "hier":
        # stage 1: top-t per (query, list) row; stage 2: exact merge
        t = min(params.pool_per_pair, LLMAX)
        v1, i1 = _top_k(pv.reshape(P, LLMAX), t)
        gsel = (torch.arange(QC, device=dev)[None, :, None] * LLMAX
                + i1.reshape(B, QC, t)).reshape(B, QC * t)
        pool = min(pool, QC * t)
        top_scores, p1 = _top_k(v1.reshape(B, QC * t), pool)
        sel = torch.gather(gsel, 1, p1)
    elif params.pool_mode == "seg" and pool * segw < QC * LLMAX:
        # two-level segment pool: the top-`pool` segments by max hold the
        # top-`pool` rows. Past that width the JAX program falls through
        # to the whole-wall selection, and so does this one.
        if (QC * LLMAX) % segw:
            raise ValueError(f"pool_seg_width={segw} does not divide "
                             f"{QC * LLMAX}")
        seg_max = pv.reshape(B, (QC * LLMAX) // segw, segw).amax(dim=-1)
        _, seg_sel = _top_k(seg_max, pool)
        row_idx = (seg_sel[:, :, None] * segw
                   + torch.arange(segw, device=dev)).reshape(B, pool * segw)
        top_scores, p1 = _top_k(torch.gather(pv, 1, row_idx), pool)
        sel = torch.gather(row_idx, 1, p1)
    else:
        top_scores, sel = torch.topk(pv, pool, dim=1)
    return done(top_scores, sel, pool)


def _stream_budget(index: DeviceIndex, plan: DevicePlan, qloc, pair_scale,
                   frac: float, NSUP: int):
    """The streaming budget (`seismic_tpu/search/grouped.py:813-846`):
    work item w's priority is max over its group's slots m of qloc[g_w, m]
    . super_summary[region_w] (bf16 operands, f32 sums; the i8 slots
    re-scaled by their pair's scale) times the super-tile's scale; the
    top max(128, round(frac * W_cap)) items (ties to the lower index, as
    `lax.top_k`) are kept in work-list order. Padding items point at the
    all-zero region, priority 0. Returns (work_region, work_g, work_s of
    the kept items, streamed bool [G_cap, NSUP]: the super-tiles
    scored)."""
    G_cap, M, _ = qloc.shape
    W_cap = plan.work_region.shape[0]
    region = plan.work_region.long()
    wg = plan.work_g.long()
    ub = index.super_summary[region].to(torch.bfloat16).float()  # [W, V]
    qg = qloc[wg].to(torch.bfloat16).float()  # [W, M, V]
    # bf16 products are exact in f32; TF32 off keeps them so on the card
    with full_f32():
        pr_wm = torch.bmm(qg, ub[:, :, None])[..., 0]  # [W_cap, M]
    del qg, ub
    if pair_scale is not None:
        # i8 slots are in per-pair quantized units: re-apply each slot's
        # scale so priorities compare across the pairs of a group
        slot_scale = pair_scale[plan.slot_pair.long()].reshape(G_cap, M)
        pr_wm = pr_wm * slot_scale[wg]
    pr = pr_wm.amax(dim=1) * index.super_scale[region]
    Wb = min(max(128, int(round(frac * W_cap))), W_cap)
    keep = torch.sort(_top_k(pr, Wb)[1]).values  # group-major order
    work_region = plan.work_region[keep]
    work_g = plan.work_g[keep]
    work_s = plan.work_s[keep]
    # lax's mode="drop": a slot past NSUP goes to a dump column, cut off
    streamed = torch.zeros((G_cap, NSUP + 1), dtype=torch.bool,
                           device=qloc.device)
    streamed[work_g.long(), work_s.clamp(max=NSUP).long()] = True
    return work_region, work_g, work_s, streamed[:, :NSUP]


def _dedup_with_payload(scores, ids, payload, n_docs: int):
    """`_dedup_by_id` carrying an int payload column through the sort."""
    finite = torch.isfinite(scores)
    ids = torch.where(finite, ids.to(torch.int32), n_docs)
    neg = torch.where(finite, -scores, torch.inf)
    order = _sort_by_id_then_score(ids, neg)
    ids_s = torch.gather(ids, -1, order)
    scores_s = -torch.gather(neg, -1, order)
    pay_s = torch.gather(payload.to(torch.int32), -1, order)
    dup = torch.zeros_like(ids_s, dtype=torch.bool)
    dup[..., 1:] = ids_s[..., 1:] == ids_s[..., :-1]
    invalid = ids_s >= n_docs
    scores_s = torch.where(dup | invalid, -torch.inf, scores_s)
    return scores_s, ids_s, pay_s


def _knn_refine_grouped(index: DeviceIndex, params: GroupedParams, top_c,
                        top_v, sc: int, top_scores, top_ids):
    """kNN refinement on the rescore kernel (`seismic_tpu/search/grouped.py
    ::_knn_refine_grouped`, the reference Knn::refine): each round gathers
    the neighbours of the top `knn_top` results (all k when 0), scores
    them exactly with K3, dedups them against the current top-k and takes
    the top-k again. Invalid neighbours (-1 in the graph, or of a result
    at -inf) take id n_docs and score -inf."""
    B, k = top_ids.shape
    n_docs = index.n_docs
    n_knn = min(params.n_knn, index.knn.shape[1])
    # top_scores is sorted descending, so the top-m slice is a prefix
    m = k if params.knn_top <= 0 else min(params.knn_top, k)
    top_ids = top_ids.to(torch.int32)
    for _ in range(max(1, params.knn_rounds)):
        safe_top = top_ids[:, :m].clamp(0, n_docs - 1).long()
        neigh = index.knn[safe_top][..., :n_knn].reshape(B, m * n_knn)
        neigh_valid = (torch.isfinite(top_scores[:, :m])[:, :, None]
                       .expand(B, m, n_knn).reshape(B, m * n_knn)
                       & (neigh >= 0))
        nscores = rescore_exact(index, torch.where(neigh_valid, neigh, 0),
                                top_c, top_v, sc)
        nscores = torch.where(neigh_valid, nscores, -torch.inf)
        neigh = torch.where(neigh_valid, neigh, n_docs)
        all_scores, all_ids = _dedup_by_id(
            torch.cat([top_scores, nscores], dim=1),
            torch.cat([top_ids, neigh], dim=1), n_docs)
        top_scores, pos = _top_k(all_scores, k)
        top_ids = torch.gather(all_ids, 1, pos)
    return top_scores, top_ids


def _block_expand_tail(index: DeviceIndex, params: GroupedParams, top_c,
                       top_v, sc: int, blk_scores, blk_sel):
    """The block-pool tail (`seismic_tpu/search/grouped.py::
    _block_expand_tail`, the reference's evaluate_posting_block: every
    member of a pooled block gets a full sparse dot). Pooled block ids
    `blk_sel` [B, P] (`safe_post` of the blocks-as-rows view) expand into
    E = block_expand slots each, slot j of block b holding
    postings[block_start[b] + j]; slots past block_len[b], and every slot
    of a block with a non-finite pool score, hold n_docs and score -inf.
    Every member is exact-rescored with K3, the top dd = min(P * E,
    max(8k, 128)) pre-ranked (duplicates carry equal exact scores, so the
    top-k survives the cut), deduped by id and cut to the top-k, then
    refined when n_knn > 0."""
    k = params.k
    n_docs = index.n_docs
    B, P = blk_sel.shape
    E = params.block_expand
    blk = blk_sel.clamp(0, index.block_start.shape[0] - 1).long()
    bs = index.block_start[blk]  # [B, P]
    bl = index.block_len[blk]
    j = torch.arange(E, dtype=torch.int32, device=blk_sel.device)
    valid = (j < bl[:, :, None]) & torch.isfinite(blk_scores)[:, :, None]
    pidx = (bs[:, :, None] + j).clamp(0, index.postings.shape[0] - 1)
    ids = torch.where(valid, index.postings[pidx.long()],
                      n_docs).reshape(B, P * E)
    # the padding slots (id n_docs) score -inf, their rows never read
    exact = rescore_exact(index, ids, top_c, top_v, sc,
                          chunk_r=params.rescore_chunk,
                          skip_out_of_range=True)
    dd = min(ids.shape[1], max(8 * k, 128))
    t2, pos2 = _top_k(exact, dd)
    ids2 = torch.gather(ids, 1, pos2)
    dscores, dids = _dedup_by_id(t2, ids2, n_docs)
    out_scores, opos = _top_k(dscores, k)
    out_ids = torch.gather(dids, 1, opos)
    if params.n_knn > 0 and index.knn is not None:
        out_scores, out_ids = _knn_refine_grouped(
            index, params, top_c, top_v, sc, out_scores, out_ids)
    out_ids = torch.where(torch.isfinite(out_scores), out_ids.long(), -1)
    return out_scores, out_ids


def _grouped_tail(index, params, q_comps, q_vals, top_c, top_v, sc,
                  top_scores, cand_ids, safe_post, pool):
    """Post-pool tail. block_expand > 0: `_block_expand_tail`.
    rescore > 0: exact-rescore `rescore` candidates (K3)
    and take the final top-k; dedup_mode "pre" sort-dedups the pool first
    and rescores the top unique candidates, "post" rescores the raw top of
    the pool (it arrives sorted) and dedups on the exact scores.
    rescore == 0: the overflow correction (of the whole pool, or after the
    dedup of its top `ovf_pool` unique candidates) and the id dedup. Then
    kNN refinement when n_knn > 0 and the index carries a graph: on K3
    after the rescore tail, the engine's round (exact scores of the full
    queries from forward-row gathers) after the overflow tail."""
    k = params.k
    n_docs = index.n_docs
    if params.block_expand > 0:
        # blocks-as-rows view: the pooled rows are block ids; the
        # candidate ids gathered from them mean nothing and are dropped
        return _block_expand_tail(index, params, top_c, top_v, sc,
                                  top_scores, safe_post)
    if params.rescore > 0:
        rp = min(params.rescore, pool)
        if params.dedup_mode == "post":
            t2 = top_scores[:, :rp]
            ids2 = cand_ids[:, :rp]
        else:
            dscores, dids, _ = _dedup_with_payload(top_scores, cand_ids,
                                                   safe_post, n_docs)
            t2, pos2 = torch.topk(dscores, rp, dim=1)
            ids2 = torch.gather(dids, 1, pos2)
        if params.stop_after == "prerank":
            return t2, ids2
        approx2 = t2
        exact = rescore_exact(index, ids2, top_c, top_v, sc,
                              chunk_r=params.rescore_chunk)
        t2 = torch.where(torch.isfinite(t2), exact, -torch.inf)
        if params.dedup_mode == "post":
            t2, ids2 = _dedup_by_id(t2, ids2, n_docs)
    else:
        use_ovf = params.use_ovf and index.tile_ovf_comps is not None
        qd_top = (densify_query_batch(top_c, top_v, index.dim)
                  if use_ovf else None)
        if use_ovf and 0 < params.ovf_pool < pool:
            # dedup first, then correct only the top unique candidates
            dscores, dids, dpost = _dedup_with_payload(
                top_scores, cand_ids, safe_post, n_docs)
            t2, pos2 = torch.topk(dscores, params.ovf_pool, dim=1)
            ids2 = torch.gather(dids, 1, pos2)
            post2 = torch.gather(dpost, 1, pos2).long()
            t2 = _ovf_correction(index, qd_top, t2, post2)
        else:
            if use_ovf:
                top_scores = _ovf_correction(index, qd_top, top_scores,
                                             safe_post)
            t2, ids2 = _dedup_by_id(top_scores, cand_ids, n_docs)
    out_scores, opos = torch.topk(t2, k, dim=1)
    out_ids = torch.gather(ids2, 1, opos)
    if params.n_knn > 0 and index.knn is not None:
        if params.rescore > 0:
            out_scores, out_ids = _knn_refine_grouped(
                index, params, top_c, top_v, sc, out_scores, out_ids)
        else:
            qd = densify_query_batch(q_comps, q_vals, index.dim)
            out_scores, out_ids = _knn_refine(
                index, SearchParams(k=k, n_knn=params.n_knn), qd,
                out_scores, out_ids)
    out_ids = torch.where(torch.isfinite(out_scores), out_ids.long(), -1)
    if params.return_margin:
        return out_scores, out_ids, _margin_diag(approx2, exact, top_scores,
                                                 out_scores[:, k - 1])
    return out_scores, out_ids


def _margin_diag(approx2, exact, top_scores, kth):
    """Per-query pool-truncation diagnostics f32 [B, 5] (`seismic_tpu/
    search/grouped.py:1243-1270`): a doc the pool missed has an approx
    score under the pool bottom, and an exact one at most the bottom plus
    this query's approx -> exact gap. Columns: 0 the kth exact score, 1
    the pool bottom (-inf when the pool was not filled), 2 the mean and 3
    the max exact - approx gap over the rescored set, 4 the score range
    of the pool's bottom quarter."""
    finite2 = torch.isfinite(approx2) & torch.isfinite(exact)
    cnt = finite2.sum(dim=1).clamp(min=1)
    gap = torch.where(finite2, exact - approx2, 0.0)
    bias_mean = gap.sum(dim=1) / cnt
    bias_max = torch.where(finite2, gap, -torch.inf).amax(dim=1)
    pool_bottom = top_scores[:, -1]
    q4range = top_scores[:, (3 * top_scores.shape[1]) // 4] - pool_bottom
    return torch.stack([kth, pool_bottom, bias_mean, bias_max, q4range],
                       dim=1)


def _to_numpy(t):
    t = t.float() if t.dtype == torch.bfloat16 else t
    return t.cpu().numpy()


def search_grouped(
    index: DeviceIndex,
    ctx: PlannerContext,
    q_comps: np.ndarray,
    q_vals: np.ndarray,
    params: GroupedParams,
    query_cut: int = 10,
    M: int = 8,
):
    """Convenience wrapper: plan on the host (the C++ planner), execute on
    the index's device, numpy out (with `stop_after`, the named stage's
    output twice; with `return_margin`, the diagnostics third)."""
    _check_supported(params, index)
    dev = index.device
    plan = plan_grouped(q_comps, q_vals, ctx, query_cut, M=M)
    dplan = DevicePlan.put(plan, dev)
    out = _grouped_impl(
        index, dplan,
        torch.from_numpy(np.ascontiguousarray(q_comps, np.int32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(q_vals, np.float32)).to(dev),
        params,
    )
    return tuple(_to_numpy(t) for t in out)


def search_grouped_derive(index: DeviceIndex, q_comps, q_vals,
                          params: GroupedParams, query_cut: int, M: int,
                          G_cap: int, W_cap: int, zero_region: int,
                          weighted: bool = False):
    """One device program: the plan derived on the device from the queries
    (`derive_plan_device`, with the weighted list cut when `weighted`),
    then the grouped search (the JAX package's `search_grouped_derive_jit`).
    q_comps int32 / q_vals f32 [B, Q] are tensors on the index's device;
    (G_cap, W_cap) come from `plan_caps` (with the same `weighted`).
    Returns (scores f32 [B, k], ids int64 [B, k]) on the device, and the
    diagnostics f32 [B, 5] with `return_margin`, without a host sync."""
    _check_supported(params, index)
    dev = index.device
    if not (torch.is_tensor(q_comps) and torch.is_tensor(q_vals)
            and q_comps.device == dev and q_vals.device == dev):
        raise ValueError("q_comps / q_vals must be tensors on the index's "
                         f"device ({dev})")
    plan = derive_plan_device(index, q_comps, q_vals, query_cut, M, G_cap,
                              W_cap, zero_region, weighted=weighted)
    return _grouped_impl(index, plan, q_comps, q_vals, params)


def plan_caps(q_comps, q_vals, ctx: PlannerContext, query_cut: int,
              M: int = 8, weighted: bool = False):
    """Host-side (G_cap, W_cap) for the device-derived plan: exact G and W
    from the C++ planner, rounded to the planner's buckets. With
    `weighted`, the values are scaled by the list weights first, so the
    planner's top-QC is the weighted selection of `derive_plan_device`
    (validity, v > 0, is kept: the weights are >= 0)."""
    if weighted:
        if ctx.list_weight is None:
            raise ValueError("weighted caps need ctx.list_weight")
        q_comps = np.asarray(q_comps)
        w = np.where((q_comps >= 0) & (q_comps < ctx.n_lists),
                     ctx.list_weight[np.clip(q_comps, 0, ctx.n_lists - 1)],
                     0.0)
        q_vals = np.asarray(q_vals) * w
    p = plan_grouped(q_comps, q_vals, ctx, query_cut, M=M)
    return p.G_cap, p.W_cap
