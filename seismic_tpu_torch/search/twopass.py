"""Two-pass adaptive pooled search (a port of `seismic_tpu/search/
twopass.py`).

The reference's sequential heap threshold adapts the WORK per query: a
block is skipped exactly when its summary bound cannot beat the current
kth score (src/posting_list.rs:130,169), so easy queries stop early and
hard ones keep digging. A batched program pays one fixed pool depth for
every query instead. The recast is two device programs with a host
compaction between them (no data-dependent control flow inside either):

  pass 1  a cheap fixed program over the full batch, returning the
          per-query pool-truncation diagnostics
          (`GroupedParams.return_margin`)
  host    flag the queries whose margin (kth exact score minus the
          bias-corrected pool bottom) is under eps + eps_rel * kth, and
          compact them into one fixed-size batch
  pass 2  a deep fixed program over the compacted batch; its results
          replace the flagged rows

Both programs run on the port's `plan_caps` + `search_grouped_derive`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..types import DeviceIndex
from .grouped import GroupedParams, plan_caps, search_grouped_derive
from .planner import PlannerContext


@dataclass(frozen=True)
class TwoPassParams:
    """Configuration of the adaptive two-pass driver (the fields and
    defaults of `seismic_tpu.search.twopass.TwoPassParams`)."""

    pass1: GroupedParams
    pass2: GroupedParams
    query_cut1: int = 14
    query_cut2: int = 20
    # flag a query when margin < eps + eps_rel * max(kth, 0)
    eps: float = 0.0
    eps_rel: float = 0.05
    # "bias_mean": kth - (pool_bottom + mean gap); "bias_max": kth -
    # (pool_bottom + max gap), the conservative bound
    flag_mode: str = "bias_mean"
    # pass-2 batch capacity as a share of the pass-1 batch (a static
    # shape; past it the lowest-margin queries are kept)
    b2_frac: float = 0.125
    b2_min: int = 128
    M: int = 8

    def __post_init__(self):
        if self.pass1.rescore <= 0:
            raise ValueError("pass1 must use the exact-rescore tail "
                             "(rescore > 0) to produce a margin")
        if self.pass1.k != self.pass2.k:
            raise ValueError("pass1.k != pass2.k")


def margin_from_diag(diag: np.ndarray, flag_mode: str) -> np.ndarray:
    """Per-query flag margin from the diagnostics of `return_margin`
    (columns: kth, pool_bottom, gap_mean, gap_max, bottom-quarter range).
    An unfilled pool (bottom = -inf) truncated nothing: margin = +inf."""
    kth, bottom = diag[:, 0], diag[:, 1]
    if flag_mode == "bias_mean":
        m = kth - (bottom + diag[:, 2])
    elif flag_mode == "bias_max":
        m = kth - (bottom + diag[:, 3])
    else:
        raise ValueError(f"unknown flag_mode {flag_mode!r}")
    return np.where(np.isfinite(bottom), m, np.inf)


def search_batch_twopass(
    index: DeviceIndex,
    ctx: PlannerContext,
    q_comps: np.ndarray,  # [B, Q] int32, PAD_COMPONENT padded
    q_vals: np.ndarray,  # [B, Q] f32
    tp: TwoPassParams,
    knn_index: DeviceIndex | None = None,
):
    """Adaptive batch search on the index's device; numpy in, returns
    (scores, ids, stats) as numpy. `knn_index` optionally supplies a
    graph-carrying index for pass 2 only (pass 1 stays graph-free)."""
    B = q_comps.shape[0]
    dev = index.device
    p1 = dataclasses.replace(tp.pass1, return_margin=True)

    def run(ix, qc, qv, params, query_cut):
        gc, wc = plan_caps(qc, qv, ctx, query_cut, M=tp.M)
        out = search_grouped_derive(
            ix, torch.from_numpy(np.ascontiguousarray(qc, np.int32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(qv, np.float32)).to(dev),
            params, query_cut, tp.M, gc, wc, ctx.zero_region)
        return [t.cpu().numpy() for t in out]

    s1, i1, diag = run(index, q_comps, q_vals, p1, tp.query_cut1)
    margin = margin_from_diag(diag, tp.flag_mode)

    kth = s1[:, tp.pass1.k - 1]
    flagged = np.nonzero(
        margin < tp.eps + tp.eps_rel * np.maximum(kth, 0.0))[0]
    B2 = min(B, max(tp.b2_min, int(round(tp.b2_frac * B))))
    if len(flagged) > B2:
        # cap overflow: keep the lowest-margin (most at-risk) queries
        flagged = flagged[np.argsort(margin[flagged])[:B2]]
    stats = {"flagged": int(len(flagged)), "b2": B2,
             "flag_frac": round(len(flagged) / max(B, 1), 4),
             "flagged_idx": flagged, "margin": margin}
    if len(flagged) == 0:
        return s1, i1, stats

    # compact into the fixed-size pass-2 batch (pad rows re-run query 0;
    # their results are dropped)
    sel = np.zeros(B2, np.int64)
    sel[: len(flagged)] = flagged
    ix2 = knn_index if (knn_index is not None
                        and tp.pass2.n_knn > 0) else index
    s2, i2 = run(ix2, q_comps[sel], q_vals[sel], tp.pass2, tp.query_cut2)
    out_s, out_i = s1.copy(), i1.copy()
    out_s[flagged] = s2[: len(flagged)]
    out_i[flagged] = i2[: len(flagged)]
    return out_s, out_i, stats
