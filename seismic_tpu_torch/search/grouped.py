"""Grouped batch search: the list-major route of the API.

Pipeline (host planner -> device program), as in
`seismic_tpu/search/grouped.py`:

  host   1. top-`query_cut` terms per query; (query, list) pairs grouped by
            list into M-slot groups, exact per-subtile work list
            (search/planner.py)
  device 2. per-pair query projection onto each list's local vocabulary,
            quantized to int8 per pair (ops/qloc.py, kernel K1)
         3. slot expansion: each group's M projections side by side
         4. grouped int8 scorer: each list's u8 doc tiles read once per
            group and scored for all M member queries (ops/grouped_scorer.py,
            kernel K2)
         5. regroup to query order, per-pair scale, length masks, exact
            top-`pool`
         6. dedup, exact rescore of the top `rescore` candidates from the
            forward rows (ops/rescore.py, kernel K3), final top-k

This slice serves exactly the `GroupedParams` of the API's grouped route
(`seismic_tpu/api.py:391-396`): compute_dtype "i8", qloc_mode "pallas",
kernel_unroll 1, pool_mode "exact", pool_dtype "f32", dedup_mode "pre",
rescore > 0, stream_frac 1. Every other mode raises NotImplementedError
naming the ROADMAP.md item that brings it. The glue between the kernels
(top-k, sorts, gathers, masks) is plain torch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..data.sparse import PAD_COMPONENT
from ..ops.grouped_scorer import score_grouped_i8
from ..ops.qloc import project_qloc_quantize
from ..ops.rescore import rescore_exact
from ..ops.tiles_prep import ll_pad_for
from ..types import DeviceIndex
from .engine import _sort_by_id_then_score
from .planner import GroupedPlan, PlannerContext, plan_grouped_numpy


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
    """Raise for every mode this slice does not serve, naming the ROADMAP
    item that brings it."""
    unsupported = [
        (params.compute_dtype != "i8",
         f"compute_dtype={params.compute_dtype!r} (bf16/f32 scorer: "
         "ROADMAP.md kernel queue, score_grouped_pallas bf16/f32)"),
        (params.qloc_mode != "pallas",
         f"qloc_mode={params.qloc_mode!r} ({_R2A}e)"),
        (params.kernel_unroll != 1,
         f"kernel_unroll={params.kernel_unroll} ({_R2A}b)"),
        (params.pool_mode != "exact",
         f"pool_mode={params.pool_mode!r} ({_R2A}b and 2e)"),
        (params.pool_dtype != "f32",
         f"pool_dtype={params.pool_dtype!r} ({_R2A}b)"),
        (params.dedup_mode != "pre",
         f"dedup_mode={params.dedup_mode!r} ({_R2A}b)"),
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
    """Device mirror of a GroupedPlan: its int32 fields as tensors,
    uploaded in ONE host->device copy (views of one packed buffer);
    pair_valid is bool."""

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
        return DevicePlan(**fields, M=plan.M)


def _top_k(x, k: int):
    """`lax.top_k` semantics: descending, ties keep the lower index."""
    s = torch.sort(x, dim=-1, descending=True, stable=True)
    return s.values[..., :k], s.indices[..., :k]


def _grouped_impl(index: DeviceIndex, plan: DevicePlan, q_comps, q_vals,
                  params: GroupedParams):
    """The device program of the grouped route; returns (scores f32 [B, k],
    ids int64 [B, k], -1 where no result)."""
    _check_supported(params)
    B, Q = q_comps.shape
    G_cap, M = plan.slot_b.shape
    V = index.vocab16.shape[1]
    k = params.k
    LLMAX = ll_pad_for(index.max_list_len, index.tile_csub)
    neg_inf = torch.tensor(-torch.inf, device=q_vals.device)

    valid_q = q_comps != int(PAD_COMPONENT)
    qv = torch.where(valid_q, q_vals, 0.0)
    sc = min(params.score_cut, Q)
    if sc < Q:
        top_v, top_p = _top_k(qv, sc)
        top_c = torch.gather(q_comps, 1, top_p)  # [B, sc]
    else:
        top_v, top_c = qv, q_comps
    QC = plan.pair_list.shape[1]
    P = B * QC

    # ---- per-pair int8 projections (K1), expanded to slot order ----
    scq = min(params.qloc_cut, sc) if params.qloc_cut > 0 else sc
    q_i8, pair_scale = project_qloc_quantize(
        index.vocab16, plan.pair_list.reshape(P),
        top_c[:, :scq].contiguous(), top_v[:, :scq].contiguous(), QC)
    qloc = q_i8[plan.slot_pair.long()].reshape(G_cap, M, V)

    # ---- grouped tile scoring (K2) ----
    scores = score_grouped_i8(
        index.doc_tiles_aligned, index.tile_scale, qloc, plan.work_region,
        plan.work_g, plan.work_s, LLMAX)  # [G_cap, M, LLMAX], unmasked

    # ---- regroup to query order, per-pair scale, masks, exact pool ----
    pool = min(params.pool if params.pool > 0 else 8 * k, QC * LLMAX)
    pv = scores.reshape(G_cap * M, LLMAX)[
        plan.pair_slot.reshape(P).long()].reshape(B, QC, LLMAX)
    pv = pv * pair_scale.reshape(B, QC, 1)
    rows = torch.arange(LLMAX, dtype=torch.int32, device=pv.device)
    rows_ok = (rows[None, None, :] < plan.pair_len[..., None]) & (
        plan.pair_valid[..., None])
    pv = torch.where(rows_ok, pv, neg_inf).reshape(B, QC * LLMAX)
    top_scores, sel = torch.topk(pv, pool, dim=1)
    qc_slot = torch.div(sel, LLMAX, rounding_mode="floor")
    off = sel % LLMAX
    post_sel = torch.gather(plan.pair_pstart, 1, qc_slot) + off
    safe_post = post_sel.clamp(0, index.postings.shape[0] - 1)
    cand_ids = index.postings[safe_post]
    cand_ids = torch.where(torch.isfinite(top_scores), cand_ids,
                           index.n_docs)
    return _grouped_tail(index, params, top_c, top_v, sc, top_scores,
                         cand_ids, safe_post, pool)


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
    """Post-pool tail (rescore > 0, dedup_mode "pre"): sort-dedup the pool,
    exact-rescore the top `rescore` unique candidates (K3), final top-k."""
    k = params.k
    rp = min(params.rescore, pool)
    dscores, dids, _ = _dedup_with_payload(top_scores, cand_ids, safe_post,
                                           index.n_docs)
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
    """Convenience wrapper: plan on host, execute on the index's device,
    numpy out."""
    _check_supported(params)
    dev = index.device
    plan = plan_grouped_numpy(q_comps, q_vals, ctx, query_cut, M=M)
    dplan = DevicePlan.put(plan, dev)
    scores, ids = _grouped_impl(
        index, dplan,
        torch.from_numpy(np.ascontiguousarray(q_comps, np.int32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(q_vals, np.float32)).to(dev),
        params,
    )
    return scores.cpu().numpy(), ids.cpu().numpy()
