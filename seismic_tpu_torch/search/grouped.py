"""Grouped batch search: the list-major route.

Pipeline (planner -> device program), as in
`seismic_tpu/search/grouped.py`:

  plan   1. top-`query_cut` terms per query; (query, list) pairs grouped by
            list into M-slot groups, exact per-super-tile work list: on
            the host (search/planner.py, the C++ or NumPy planner) or
            derived on the device from the queries (`derive_plan_device`,
            torch sorts, scans and scatters), with the host supplying only
            the static capacities (`plan_caps`)
  device 2. per-pair query projection onto each list's local vocabulary,
            quantized to int8 per pair (ops/qloc.py, kernel K1)
         3. slot expansion: each group's M projections side by side
         4. grouped int8 scorer: each list's u8 doc tiles read once per
            group and scored for all M member queries, slot-major
            (kernel_unroll 1: ops/grouped_scorer.py, kernel K2) or
            work-item-major (kernel_unroll > 1: ops/grouped_scorer_item.py,
            kernel K4, then `_item_regroup`)
         5. regroup to query order in the pool dtype (f32 or bf16), per-pair
            scale, length masks, candidate pool (exact top-`pool`, or
            "hier": exact top-t per pair, then an exact merge)
         6. exact rescore of the top `rescore` candidates from the forward
            rows (ops/rescore.py, kernel K3), with the id dedup before it
            ("pre") or after it ("post"), final top-k

Two entry points: `search_grouped` (host plan) and
`search_grouped_derive` (device-derived plan; the bench headline path of
the JAX package, `bench.py:604-669`). Served modes: compute_dtype "i8",
qloc_mode "pallas", any kernel_unroll, pool_mode "exact" or "hier",
pool_dtype "f32" or "bf16", dedup_mode "pre" or "post", rescore > 0,
stream_frac 1. Every other mode raises NotImplementedError naming the
ROADMAP.md item that brings it. The glue between the kernels (top-k,
sorts, scans, gathers, masks) is plain torch, and none of it reads a
device value back to the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..data.sparse import PAD_COMPONENT
from ..ops.grouped_scorer import score_grouped_i8
from ..ops.grouped_scorer_item import score_grouped_i8_item
from ..ops.qloc import project_qloc_quantize
from ..ops.rescore import rescore_exact
from ..ops.tiles_prep import SUB, ll_pad_for
from ..types import DeviceIndex
from .engine import (
    _dedup_by_id,
    _query_terms,
    _sort_by_id_then_score,
    _top_k,
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


_R2A = "ROADMAP.md, modules to port, item 2"


def _check_supported(params: GroupedParams) -> None:
    """Raise for every mode this package does not serve, naming the
    ROADMAP item that brings it."""
    unsupported = [
        (params.compute_dtype != "i8",
         f"compute_dtype={params.compute_dtype!r} (bf16/f32 scorer: "
         "ROADMAP.md kernel queue, score_grouped_pallas bf16/f32)"),
        (params.qloc_mode != "pallas",
         f"qloc_mode={params.qloc_mode!r} ({_R2A}e)"),
        (params.pool_mode not in ("exact", "hier"),
         f"pool_mode={params.pool_mode!r} ({_R2A}e)"),
        (params.pool_dtype not in ("f32", "bf16"),
         f"pool_dtype={params.pool_dtype!r} ({_R2A}e)"),
        (params.dedup_mode not in ("pre", "post"),
         f"dedup_mode={params.dedup_mode!r} ({_R2A}e)"),
        (params.rescore <= 0,
         f"rescore={params.rescore}: the overflow re-rank tail ({_R2A}e)"),
        (params.stream_frac < 1.0,
         f"stream_frac={params.stream_frac} ({_R2A}e)"),
        (params.block_expand > 0,
         f"block_expand={params.block_expand} ({_R2A}c)"),
        (params.n_knn > 0, f"n_knn={params.n_knn} ({_R2A}d)"),
        (bool(params.stop_after),
         f"stop_after={params.stop_after!r} ({_R2A}e)"),
        (params.return_margin, f"return_margin ({_R2A}e)"),
    ]
    for bad, what in unsupported:
        if bad:
            raise NotImplementedError(f"grouped search: {what}")


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


def derive_plan_device(
    index: DeviceIndex,
    q_comps,  # int32 [B, Q] PAD_COMPONENT padded
    q_vals,  # f32 [B, Q]
    query_cut: int,
    M: int,
    G_cap: int,
    W_cap: int,
    zero_region: int,  # SUPER-tile units (PlannerContext.zero_region)
) -> DevicePlan:
    """Build the grouped plan ON THE DEVICE from the queries (sorts, scans,
    scatters; `seismic_tpu/search/grouped.py::derive_plan_device` without
    the weighted cut): the host only supplies the static capacities
    (G_cap, W_cap, from `plan_caps`). Group composition equals the host
    planner's whenever both pick the same top-QC lists. Nothing is read
    back to the host."""
    B, Q = q_comps.shape
    QC = min(query_cut, Q)
    P = B * QC
    csub = index.tile_csub
    n_lists = index.list_len.shape[0]
    dev = q_comps.device

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


def _grouped_impl(index: DeviceIndex, plan: DevicePlan, q_comps, q_vals,
                  params: GroupedParams):
    """The device program of the grouped route; returns (scores f32 [B, k],
    ids int64 [B, k], -1 where no result)."""
    return _grouped_tail(index, params,
                         *_grouped_pool(index, plan, q_comps, q_vals, params))


def _grouped_pool(index: DeviceIndex, plan: DevicePlan, q_comps, q_vals,
                  params: GroupedParams):
    """The grouped program up to its candidate pool: `_grouped_tail`'s
    arguments after (index, params)."""
    _check_supported(params)
    if index.doc_tiles_aligned is None:
        raise ValueError("the grouped route needs an index built with doc "
                         "tiles (layout.summary_vocab_cap > 0)")
    B = q_comps.shape[0]
    G_cap, M = plan.slot_b.shape
    V = index.vocab16.shape[1]
    k = params.k
    csub = index.tile_csub
    LLMAX = ll_pad_for(index.max_list_len, csub)

    top_c, top_v, sc = _query_terms(q_comps, q_vals, params.score_cut)
    QC = plan.pair_list.shape[1]
    P = B * QC

    # ---- per-pair int8 projections (K1), expanded to slot order ----
    scq = min(params.qloc_cut, sc) if params.qloc_cut > 0 else sc
    q_i8, pair_scale = project_qloc_quantize(
        index.vocab16, plan.pair_list.reshape(P),
        top_c[:, :scq].contiguous(), top_v[:, :scq].contiguous(), QC)
    qloc = q_i8[plan.slot_pair.long()].reshape(G_cap, M, V)

    # ---- grouped tile scoring (K4 item-major, or K2 slot-major), then
    # the regroup to query order in the pool dtype ----
    pdt = torch.bfloat16 if params.pool_dtype == "bf16" else torch.float32
    U = params.kernel_unroll
    if U > 1:
        W_cap = plan.work_region.shape[0]
        if W_cap % U:
            raise ValueError(f"W_cap={W_cap} is not a multiple of "
                             f"kernel_unroll={U}")
        scores = score_grouped_i8_item(
            index.doc_tiles_aligned, index.tile_scale, qloc,
            plan.work_region, plan.work_g, csub)  # [W_cap, M, csub*128]
        pv = _item_regroup(scores.to(pdt), plan, csub,
                           LLMAX // (csub * SUB))
    else:
        if csub != 1:
            raise NotImplementedError(
                "kernel_unroll=1 with tile_csub > 1: K2 scores 128-row "
                "items only; use kernel_unroll > 1 (ROADMAP.md, modules "
                "to port, item 2e)")
        scores = score_grouped_i8(
            index.doc_tiles_aligned, index.tile_scale, qloc,
            plan.work_region, plan.work_g, plan.work_s,
            LLMAX)  # [G_cap, M, LLMAX], unmasked
        pv = scores.to(pdt).reshape(G_cap * M, LLMAX)[
            plan.pair_slot.reshape(P).long()]
    # one f32 product rounded to the pool dtype, as XLA does in bf16
    pv = pv.reshape(B, QC, LLMAX) * pair_scale.reshape(B, QC, 1).to(pdt)
    rows = torch.arange(LLMAX, dtype=torch.int32, device=pv.device)
    rows_ok = (rows[None, None, :] < plan.pair_len[..., None]) & (
        plan.pair_valid[..., None])
    pv = torch.where(rows_ok, pv, -torch.inf)

    # ---- candidate pool (exact selection; the hier stages keep lax.top_k's
    # tie order, which the bf16 wall is full of) ----
    pool = min(params.pool if params.pool > 0 else 8 * k, QC * LLMAX)
    if params.pool_mode == "hier":
        # stage 1: top-t per (query, list) row; stage 2: exact merge
        t = min(params.pool_per_pair, LLMAX)
        v1, i1 = _top_k(pv.reshape(P, LLMAX), t)
        gsel = (torch.arange(QC, device=pv.device)[None, :, None] * LLMAX
                + i1.reshape(B, QC, t)).reshape(B, QC * t)
        pool = min(pool, QC * t)
        top_scores, p1 = _top_k(v1.reshape(B, QC * t), pool)
        sel = torch.gather(gsel, 1, p1)
    else:
        top_scores, sel = torch.topk(pv.reshape(B, QC * LLMAX), pool, dim=1)
    # the tail runs in f32; only the wall the pool selected over was pdt
    top_scores = top_scores.to(torch.float32)
    qc_slot = torch.div(sel, LLMAX, rounding_mode="floor")
    off = sel % LLMAX
    post_sel = torch.gather(plan.pair_pstart, 1, qc_slot) + off
    safe_post = post_sel.clamp(0, index.postings.shape[0] - 1)
    cand_ids = index.postings[safe_post]
    cand_ids = torch.where(torch.isfinite(top_scores), cand_ids,
                           index.n_docs)
    return top_c, top_v, sc, top_scores, cand_ids, safe_post, pool


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


def _grouped_tail(index, params, top_c, top_v, sc, top_scores, cand_ids,
                  safe_post, pool):
    """Post-pool tail: exact-rescore `rescore` candidates (K3) and take the
    final top-k. dedup_mode "pre" sort-dedups the pool first and rescores
    the top unique candidates; "post" rescores the raw top of the pool
    (it arrives sorted) and dedups on the exact scores."""
    k = params.k
    rp = min(params.rescore, pool)
    if params.dedup_mode == "post":
        t2 = top_scores[:, :rp]
        ids2 = cand_ids[:, :rp]
        exact = rescore_exact(index, ids2, top_c, top_v, sc,
                              chunk_r=params.rescore_chunk)
        t2 = torch.where(torch.isfinite(t2), exact, -torch.inf)
        t2, ids2 = _dedup_by_id(t2, ids2, index.n_docs)
    else:
        dscores, dids, _ = _dedup_with_payload(top_scores, cand_ids,
                                               safe_post, index.n_docs)
        t2, pos2 = torch.topk(dscores, rp, dim=1)
        ids2 = torch.gather(dids, 1, pos2)
        exact = rescore_exact(index, ids2, top_c, top_v, sc,
                              chunk_r=params.rescore_chunk)
        t2 = torch.where(torch.isfinite(t2), exact, -torch.inf)
    out_scores, opos = torch.topk(t2, k, dim=1)
    out_ids = torch.gather(ids2, 1, opos).long()
    out_ids = torch.where(torch.isfinite(out_scores), out_ids, -1)
    return out_scores, out_ids


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
    the index's device, numpy out."""
    _check_supported(params)
    dev = index.device
    plan = plan_grouped(q_comps, q_vals, ctx, query_cut, M=M)
    dplan = DevicePlan.put(plan, dev)
    scores, ids = _grouped_impl(
        index, dplan,
        torch.from_numpy(np.ascontiguousarray(q_comps, np.int32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(q_vals, np.float32)).to(dev),
        params,
    )
    return scores.cpu().numpy(), ids.cpu().numpy()


def search_grouped_derive(index: DeviceIndex, q_comps, q_vals,
                          params: GroupedParams, query_cut: int, M: int,
                          G_cap: int, W_cap: int, zero_region: int,
                          weighted: bool = False):
    """One device program: the plan derived on the device from the queries
    (`derive_plan_device`), then the grouped search (the JAX package's
    `search_grouped_derive_jit`). q_comps int32 / q_vals f32 [B, Q] are
    tensors on the index's device; (G_cap, W_cap) come from `plan_caps`.
    Returns (scores f32 [B, k], ids int64 [B, k]) on the device, without
    a host sync."""
    if weighted:
        raise NotImplementedError(
            "weighted=True: the weighted list cut (ROADMAP.md, modules to "
            "port, item 2e)")
    _check_supported(params)
    dev = index.device
    if not (torch.is_tensor(q_comps) and torch.is_tensor(q_vals)
            and q_comps.device == dev and q_vals.device == dev):
        raise ValueError("q_comps / q_vals must be tensors on the index's "
                         f"device ({dev})")
    plan = derive_plan_device(index, q_comps, q_vals, query_cut, M, G_cap,
                              W_cap, zero_region)
    return _grouped_impl(index, plan, q_comps, q_vals, params)


def plan_caps(q_comps, q_vals, ctx: PlannerContext, query_cut: int,
              M: int = 8, weighted: bool = False):
    """Host-side (G_cap, W_cap) for the device-derived plan: exact G and W
    from the C++ planner, rounded to the planner's buckets."""
    if weighted:
        raise NotImplementedError(
            "weighted=True: the weighted list cut (ROADMAP.md, modules to "
            "port, item 2e)")
    p = plan_grouped(q_comps, q_vals, ctx, query_cut, M=M)
    return p.G_cap, p.W_cap
