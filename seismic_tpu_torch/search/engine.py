"""The batched engine search program.

Counterpart of `seismic_tpu/search/engine.py`: the fixed-shape pipeline
behind `heap_factor > 0`, block budgets and kNN refinement, as eager
PyTorch around the hand-written kernels:

  1. top-`query_cut` query terms         -> stable top-k
  2. selected lists' block windows       -> index arithmetic
  3. block ranking                       -> dense-summary u8 product
                                            ("dense"), u8 CSR summary
                                            dequant + dense-query lookup
                                            ("summary") or int8 block
                                            sketches . the query sketch
                                            ("sketch")
  4. heap_factor pruning + block budget  -> masked top-k
  5. candidate doc windows               -> posting gathers
  6. coarse candidate ranking            -> int8 doc sketches . the
                                            query sketch, top
                                            `cand_budget` (optional)
  7. exact scoring                       -> forward-row gather + lookup
                                            ("gather") or the rescore
                                            kernel ("rescore")
  8. dedup + final top-k                 -> sort-by-id mask
  9. optional k-NN refinement            -> neighbour gather + one round

`doc_mode="tiles"` scores every posting of the selected lists with the
per-pair tile scorer (`ops/tiles_scorer.py`) and prunes blocks through
each posting's local block index. The sketch products of steps 3 and 6
are XLA einsums outside any Pallas kernel in the JAX program, and
batched products (`torch.bmm`) here; the query sketch is
`ops/sketch.py::sketch_padded_queries`.

Where the JAX program leans on XLA fusing a one-hot compare (its
`_qloc_compare`, the overflow correction), this one looks the same
values up in a densified copy of the query's top terms: a `[B, QC, V,
SC]` compare tensor would not fit the card at serving batch sizes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..data.sparse import PAD_COMPONENT
from ..ops.rescore import decode_fwd_rows, fwd_width, rescore_exact
from ..ops.sketch import sketch_padded_queries
from ..ops.tiles_prep import ll_pad_for
from ..ops.tiles_scorer import score_tiles
from ..types import DeviceIndex

# elements a chunked gather may hold at once (its f32 copy is 4 bytes each)
_GATHER_ELEMS = 1 << 28


@dataclass(frozen=True)
class SearchParams:
    """Search parameters (the fields of the JAX package's SearchParams)."""

    k: int = 10
    query_cut: int = 10
    # Blocks fully evaluated per query; 0 = all selected blocks.
    block_budget: int = 48
    # Candidates exactly scored after coarse sketch ranking; 0 = all.
    cand_budget: int = 0
    # "dense" ranks blocks with the per-list local-vocab u8 product;
    # "summary" uses the u8 CSR summaries; "sketch" the experimental
    # CountSketch ranker.
    block_mode: str = "dense"
    # "gather": gather forward rows, score against the dense query;
    # "tiles": score the list-aligned dense doc tiles per (query, list)
    # pair; "rescore": every candidate of the surviving blocks goes
    # through the fused rescore kernel.
    doc_mode: str = "gather"
    # In tiles mode: score every posting of the selected lists.
    full_lists: bool = True
    # Number of top query terms participating in the scoring stages.
    score_cut: int = 64
    n_knn: int = 0
    # Accepted for API parity; block evaluation order does not depend on
    # the data in the batched design.
    first_sorted: bool = False
    # Pool size of the dedup stage in tiles / rescore mode; 0 = 8 * k.
    dedup_pool: int = 0
    # Accepted and ignored: the port has one tile scorer.
    use_pallas: bool = False


def _check_supported(params: SearchParams) -> None:
    if params.block_mode not in ("dense", "summary", "sketch"):
        raise ValueError(f"unknown block_mode: {params.block_mode}")
    if params.doc_mode not in ("tiles", "gather", "rescore"):
        raise ValueError(f"unknown doc_mode: {params.doc_mode}")


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def _top_k(x, k: int):
    """`lax.top_k` semantics: descending, the lower index wins among equal
    values (the bf16 pool wall is full of ties). A stable sort: on the
    card it sorts each row in place for rows of at most 4096 values (every
    selection of the grouped route) and synchronises with the host past
    that width (harness/topk_probe.py), as the engine path's `[B, QC *
    ll_pad]` pool selection does."""
    s = torch.sort(x, dim=-1, descending=True, stable=True)
    return s.values[..., :k], s.indices[..., :k]


def _query_terms(q_comps, q_vals, score_cut: int):
    """Each query's top `score_cut` terms by value, padding valued 0:
    (top_c int32 [B, sc], top_v f32 [B, sc], sc)."""
    Q = q_comps.shape[1]
    qv = torch.where(q_comps != int(PAD_COMPONENT), q_vals, 0.0)
    sc = min(score_cut, Q)
    if sc == Q:
        return q_comps, qv, sc
    top_v, top_p = _top_k(qv, sc)
    return torch.gather(q_comps, 1, top_p), top_v, sc


def densify_query_batch(q_comps, q_vals, dim: int):
    """[B, Q] padded queries -> [B, dim + 1] dense; slot `dim` stays 0 so
    clipped PAD_COMPONENT lookups read 0."""
    B = q_comps.shape[0]
    qd = torch.zeros((B, dim + 1), dtype=torch.float32,
                     device=q_comps.device)
    comps = q_comps.clamp(0, dim).long()
    # Out-of-vocabulary components (>= dim) must not leak into the zero
    # slot that padded lookups read.
    vals = torch.where(q_comps >= dim, 0.0, q_vals.to(torch.float32))
    return qd.scatter_add_(1, comps, vals)


def _lookup(qd, comps):
    """qd [B, dim + 1] read at comps [B, ...]: PAD_COMPONENT and the
    int16 twins' -1 padding go to the zero slot."""
    dim = qd.shape[-1] - 1
    idx = comps.reshape(comps.shape[0], -1).long()
    idx = torch.where(idx < 0, dim, idx.clamp(max=dim))
    return torch.gather(qd, 1, idx).reshape(comps.shape)


def _decode_fwd_vals(tiles_vals, tiles_comps):
    """Gathered forward values as f32, 0 at padding. `tiles_comps` may
    be the int32 comps (PAD_COMPONENT padded) or a validity mask (bool).
    u8 codes arrive decoded (`ops/rescore.py::decode_lean_rows`)."""
    if tiles_comps.dtype == torch.bool:
        mask = tiles_comps
    else:
        mask = tiles_comps != int(PAD_COMPONENT)
    vals = tiles_vals.to(torch.float32)
    return torch.where(mask, vals, torch.zeros((), dtype=torch.float32,
                                                device=vals.device))


def _sort_by_id_then_score(ids, neg):
    """Permutation sorting rows by (id ascending, neg ascending): the
    two-key `lax.sort` of the JAX package, as two stable sorts."""
    o1 = torch.sort(neg, dim=-1, stable=True).indices
    ids1 = torch.gather(ids, -1, o1)
    o2 = torch.sort(ids1, dim=-1, stable=True).indices
    return torch.gather(o1, -1, o2)


def _dedup_by_id(scores, ids, n_docs: int):
    """Sort candidates by (id, score desc), mask duplicates keeping each
    id's best score. Returns (scores, ids), dups at -inf."""
    finite = torch.isfinite(scores)
    ids = torch.where(finite, ids.to(torch.int32), n_docs)
    neg = torch.where(finite, -scores, torch.inf)
    order = _sort_by_id_then_score(ids, neg)
    ids_sorted = torch.gather(ids, -1, order)
    scores_sorted = -torch.gather(neg, -1, order)
    dup = torch.zeros_like(ids_sorted, dtype=torch.bool)
    dup[..., 1:] = ids_sorted[..., 1:] == ids_sorted[..., :-1]
    invalid = ids_sorted >= n_docs
    scores_sorted = torch.where(dup | invalid, -torch.inf, scores_sorted)
    return scores_sorted, ids_sorted


def _dense_top_terms(q_comps, q_vals, score_cut: int, dim: int):
    """[B, dim + 1] dense copy of each query's top-`score_cut` terms."""
    top_c, top_v, _ = _query_terms(q_comps, q_vals, score_cut)
    return densify_query_batch(top_c, top_v, dim)


def _exact_scores(index: DeviceIndex, qd, doc_ids):
    """Exact dot products of `doc_ids` [B, N] against the dense queries:
    forward-row gathers (either form) + a dense-query lookup, f32
    accumulate, in sequential column chunks that bound the gathered
    `[B, chunk, W]` ids and values."""
    B, N = doc_ids.shape
    chunk = max(1, _GATHER_ELEMS // max(B * 2 * fwd_width(index), 1))
    if N <= chunk:
        return _exact_scores_block(index, qd, doc_ids)
    return torch.cat([
        _exact_scores_block(index, qd, doc_ids[:, c0:c0 + chunk])
        for c0 in range(0, N, chunk)
    ], dim=1)


def _exact_scores_block(index: DeviceIndex, qd, doc_ids):
    comps, vals = decode_fwd_rows(index, doc_ids)  # [B, N, W]
    return (vals * _lookup(qd, comps)).sum(dim=-1)


def _dense_block_scores(index: DeviceIndex, lbs, qloc, MB: int):
    """Scores of the `MB` blocks from block `lbs[b, l]` on: dense-summary
    u8 rows [MB, V] . qloc[b, l] times the block scale -> [B, QC, MB]
    (pairs in chunks, to bound the gathered rows)."""
    B, QC, V = qloc.shape
    P = B * QC
    starts = lbs.reshape(P).long()
    qv = qloc.reshape(P, V, 1)
    steps = torch.arange(MB, device=qloc.device)
    last = index.dense_summary.shape[0] - 1
    out = torch.empty((P, MB), dtype=torch.float32, device=qloc.device)
    step = max(1, _GATHER_ELEMS // (MB * V))
    for p0 in range(0, P, step):
        idx = (starts[p0:p0 + step, None] + steps).clamp(max=last)
        tile = index.dense_summary[idx].to(torch.float32)  # [p, MB, V]
        out[p0:p0 + step] = (torch.bmm(tile, qv[p0:p0 + step])[..., 0]
                             * index.dense_scale[idx])
    return out.reshape(B, QC, MB)


def _summary_block_scores(index: DeviceIndex, qd, block_ids):
    """u8 CSR summaries of `block_ids` [B, N], dequantized, against the
    dense queries -> [B, N] (columns in chunks)."""
    B, N = block_ids.shape
    S = index.summary_comps.shape[1]
    step = max(1, _GATHER_ELEMS // max(B * S, 1))
    parts = []
    for c0 in range(0, N, step):
        ids = block_ids[:, c0:c0 + step].long()
        s_comps = index.summary_comps[ids]  # [B, n, S]
        deq = (index.summary_codes[ids].to(torch.float32)
               * index.summary_quant[ids][..., None]
               + index.summary_min[ids][..., None])
        deq = torch.where(s_comps != int(PAD_COMPONENT), deq, 0.0)
        parts.append((deq * _lookup(qd, s_comps)).sum(dim=-1))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _sketch_scores(codes, scale, ids, q_sk):
    """int8 sketches `codes[ids]` [B, N, ds] . the query sketches q_sk
    [B, ds], times `scale[ids]` -> [B, N]; the JAX program's einsum, as
    batched products over query chunks that bound the gathered f32 rows."""
    B, N = ids.shape
    ds = codes.shape[1]
    step = max(1, _GATHER_ELEMS // max(N * ds, 1))
    out = torch.empty((B, N), dtype=torch.float32, device=ids.device)
    for b0 in range(0, B, step):
        idx = ids[b0:b0 + step].long()
        rows = codes[idx].to(torch.float32)  # [b, N, ds]
        out[b0:b0 + step] = (torch.bmm(rows, q_sk[b0:b0 + step, :, None])
                             [..., 0] * scale[idx])
    return out


def _heap_threshold(theta, heap_factor: float):
    """heap_factor * theta, guarded: with fewer than k finite block
    scores theta is -inf and the product would be NaN at heap_factor 0."""
    return torch.where(torch.isfinite(theta), heap_factor * theta,
                       -torch.inf)


def _select_lists(index: DeviceIndex, q_comps, q_vals, query_cut: int):
    """Step 1: each query's top-`query_cut` terms name its posting lists.
    Returns (q_vals with padding zeroed, safe_lists int32 [B, QC] with 0
    at unselected slots, sel_valid bool [B, QC])."""
    valid_q = q_comps != int(PAD_COMPONENT)
    q_vals = torch.where(valid_q, q_vals, 0.0)
    _, top_pos = _top_k(q_vals, min(query_cut, q_comps.shape[1]))
    list_ids = torch.gather(q_comps, 1, top_pos)  # [B, QC]
    sel_valid = torch.gather(valid_q, 1, top_pos) & (
        list_ids < index.list_block_start.shape[0])
    return q_vals, torch.where(sel_valid, list_ids, 0).to(torch.int32), \
        sel_valid


def _tiles_scorer_inputs(index: DeviceIndex, q_comps, q_vals, safe_lists,
                         score_cut: int):
    """What the tile scorer reads for the pairs of `safe_lists` [B, QC]:
    (the dense copy of the queries' top terms [B, dim + 1], qloc f32
    [B, QC, V], region_start int32 [B, QC], list length int32 [B, QC])."""
    lists = safe_lists.long()
    qd_top = _dense_top_terms(q_comps, q_vals, score_cut, index.dim)
    # The JAX `_qloc_compare`: qloc[b, l, v] = sum_i qv_i * [vocab[b, l, v]
    # == qc_i]. A list's vocab entries are distinct and so are a query's
    # terms, so at most one term matches a slot and the lookup is that sum.
    qloc = _lookup(qd_top, index.vocab[lists])
    return (qd_top, qloc, index.list_region_start[lists].contiguous(),
            index.list_len[lists].contiguous())


# ---------------------------------------------------------------------------
# Tiles-mode search: contiguous tile streaming per (query, list) pair
# ---------------------------------------------------------------------------


def _tiles_search(index: DeviceIndex, params: SearchParams, q_comps, q_vals,
                  safe_lists, sel_valid, heap_factor: float):
    """Score the selected lists' dense doc tiles with the tile scorer.

    Every posting occurrence carries a dense u8 row over the list's local
    vocabulary, so candidate scoring is `[list_len, V] . qloc` per pair.
    With `full_lists=False` the dense summaries prune whole blocks first
    (heap_factor semantics); with `full_lists=True` every posting of the
    selected lists is scored."""
    if index.doc_tiles_aligned is None:
        raise ValueError("doc_mode='tiles' needs an index built with doc "
                         "tiles")
    if index.tile_csub != 1:
        raise ValueError(
            "the engine tiles path requires a tile_csub=1 aligned layout; "
            "csub>1 uploads serve the grouped path only")
    B, QC = safe_lists.shape
    dev = safe_lists.device
    n_docs = index.n_docs
    LL = ll_pad_for(index.max_list_len)
    MB = max(index.max_blocks_per_list, 1)
    k = params.k
    lists = safe_lists.long()

    qd_top, qloc, region_start, lln = _tiles_scorer_inputs(
        index, q_comps, q_vals, safe_lists, params.score_cut)
    lps = index.list_post_start[lists]  # [B, QC]
    scores = score_tiles(
        index.doc_tiles_aligned, index.tile_scale,
        region_start.reshape(B * QC), qloc.reshape(B * QC, -1),
        lln.reshape(B * QC), LL,
    ).reshape(B, QC, LL)
    offs = torch.arange(LL, dtype=torch.int32, device=dev)
    pos_mask = (offs < lln[..., None]) & sel_valid[..., None]

    if not params.full_lists:
        # Block-level pruning: rank blocks by their dense summaries, apply
        # the heap_factor skip, and mask postings of skipped blocks via
        # the per-posting local block index.
        lbs = index.list_block_start[lists]
        lnb = index.list_n_blocks[lists]
        bscores = _dense_block_scores(index, lbs, qloc, MB)
        steps = torch.arange(MB, dtype=torch.int32, device=dev)
        bvalid = (steps < lnb[..., None]) & sel_valid[..., None]
        bscores = torch.where(bvalid, bscores, -torch.inf)
        BE = min(params.block_budget if params.block_budget > 0
                 else QC * MB, QC * MB)
        tbs, _ = _top_k(bscores.reshape(B, QC * MB), BE)
        thr = _heap_threshold(tbs[:, min(k, BE) - 1], heap_factor)
        cutoff = torch.minimum(thr, tbs[:, BE - 1])  # budget + heap factor
        keep_block = bscores >= cutoff[:, None, None]  # [B, QC, MB]
        # each posting's local block id, read element by element
        pidx = (lps[..., None] + offs).clamp(
            0, index.posting_block_local.shape[0] - 1).long()
        pblock = index.posting_block_local[pidx]  # [B, QC, LL]
        keep_post = torch.gather(keep_block, -1,
                                 pblock.clamp(0, MB - 1).long())
        pos_mask = pos_mask & keep_post

    flat = torch.where(pos_mask, scores, -torch.inf).reshape(B, QC * LL)
    pool = params.dedup_pool if params.dedup_pool > 0 else max(8 * k, 64)
    pool = min(pool, QC * LL)
    top_scores, pos = _top_k(flat, pool)  # [B, pool]
    post_idx = torch.gather(lps, 1, pos // LL) + (pos % LL).to(torch.int32)
    safe_post = post_idx.clamp(max=index.postings.shape[0] - 1).long()
    fin = torch.isfinite(top_scores)
    cand_ids = torch.where(fin, index.postings[safe_post], n_docs)

    if index.tile_ovf_comps is not None and params.score_cut > 0:
        # Re-rank the pool with each occurrence's out-of-vocab overflow
        # entries: adds back the dot mass the local-vocab tile truncates.
        qmatch = _lookup(qd_top, index.tile_ovf_comps[safe_post])
        ov = index.tile_ovf_vals[safe_post].to(torch.float32)
        correction = (qmatch * ov).sum(dim=-1)
        top_scores = torch.where(fin, top_scores + correction, top_scores)

    dscores, dids = _dedup_by_id(top_scores, cand_ids, n_docs)
    out_scores, opos = _top_k(dscores, k)
    out_ids = torch.gather(dids, 1, opos)
    if params.n_knn > 0 and index.knn is not None:
        qd = densify_query_batch(q_comps, q_vals, index.dim)
        out_scores, out_ids = _knn_refine(index, params, qd, out_scores,
                                          out_ids)
    return out_scores, torch.where(torch.isfinite(out_scores), out_ids, -1)


def _knn_refine(index: DeviceIndex, params: SearchParams, qd, top_scores,
                top_ids):
    """One neighbour-expansion round: the neighbours of the current top-k
    are exact-scored and merged in."""
    B, k = top_ids.shape
    n_docs = index.n_docs
    n_knn = min(params.n_knn, index.knn.shape[1])
    safe_top = top_ids.clamp(0, n_docs - 1).long()
    neigh = index.knn[safe_top][..., :n_knn].reshape(B, k * n_knn)
    neigh_valid = (torch.isfinite(top_scores)[:, :, None]
                   .expand(B, k, n_knn).reshape(B, k * n_knn)
                   & (neigh >= 0))
    neigh = torch.where(neigh_valid, neigh, n_docs)
    nscores = _exact_scores(index, qd, neigh.clamp(max=n_docs - 1))
    nscores = torch.where(neigh_valid, nscores, -torch.inf)
    all_scores = torch.cat([top_scores, nscores], dim=1)
    all_ids = torch.cat([top_ids.to(torch.int32), neigh], dim=1)
    all_scores, all_ids = _dedup_by_id(all_scores, all_ids, n_docs)
    out_scores, pos = _top_k(all_scores, k)
    return out_scores, torch.gather(all_ids, 1, pos)


# ---------------------------------------------------------------------------
# The search program
# ---------------------------------------------------------------------------


def _search_impl(index: DeviceIndex, q_comps, q_vals, heap_factor: float,
                 params: SearchParams, sketch_dim: int = 128,
                 sketch_seed: int = 42):
    """q_comps int32 [B, Q] (PAD_COMPONENT padded, sorted per row), q_vals
    f32 [B, Q] on the index's device; `heap_factor` a float already
    rounded to f32; the sketch width and seed those of the index's build
    (`TpuLayout.sketch_dim` / `sketch_seed`). Returns (scores f32 [B, k],
    ids int32 [B, k], -1 where no result)."""
    _check_supported(params)
    B = q_comps.shape[0]
    dev = q_comps.device
    n_docs = index.n_docs
    MB = max(index.max_blocks_per_list, 1)
    Lmax = max(index.max_block_len, 1)
    sentinel_block = index.block_start.shape[0] - 1
    k = params.k

    # ---- 1. select top-query_cut terms ----
    q_vals, safe_lists, sel_valid = _select_lists(index, q_comps, q_vals,
                                                  params.query_cut)
    QC = safe_lists.shape[1]

    if params.doc_mode == "tiles":
        if index.tile_hash:
            raise ValueError(
                "doc_mode='tiles' reads per-list-vocab tiles; this index "
                "was uploaded with HASHED tiles (tile_hash set) — use the "
                "grouped path (search_grouped*), which hashes the query")
        return _tiles_search(index, params, q_comps, q_vals, safe_lists,
                             sel_valid, heap_factor)

    qd = densify_query_batch(q_comps, q_vals, index.dim)
    lists = safe_lists.long()

    # ---- 2. block windows of the selected lists ----
    lbs = index.list_block_start[lists]  # [B, QC]
    lnb = index.list_n_blocks[lists]
    steps = torch.arange(MB, dtype=torch.int32, device=dev)
    bmask = (steps < lnb[..., None]) & sel_valid[..., None]
    block_ids = torch.where(bmask, lbs[..., None] + steps, sentinel_block)
    block_ids = block_ids.reshape(B, QC * MB)
    bmask = bmask.reshape(B, QC * MB)

    # ---- 3. block ranking ----
    q_sk = None
    if params.block_mode == "dense":
        if index.dense_summary is None:
            raise ValueError("block_mode='dense' needs an index built with "
                             "dense summaries (summary_vocab_cap > 0)")
        qloc = _lookup(qd, index.vocab[lists])  # [B, QC, V]
        block_scores = _dense_block_scores(index, lbs, qloc, MB).reshape(
            B, QC * MB)
    elif params.block_mode == "sketch":
        if index.block_sketch is None:
            raise ValueError("block_mode='sketch' needs an index built "
                             "with sketches (sketch_dim > 0)")
        q_sk = sketch_padded_queries(q_comps, q_vals, sketch_dim,
                                     sketch_seed)
        block_scores = _sketch_scores(index.block_sketch,
                                      index.block_sketch_scale, block_ids,
                                      q_sk)
    else:
        if index.summary_comps is None:
            raise ValueError("block_mode='summary' needs an index built "
                             "with the u8 CSR summaries")
        block_scores = _summary_block_scores(index, qd, block_ids)
    block_scores = torch.where(bmask, block_scores, -torch.inf)

    # ---- 4. block budget + heap_factor mask ----
    BE = min(params.block_budget if params.block_budget > 0 else QC * MB,
             QC * MB)
    top_block_scores, top_block_pos = _top_k(block_scores, BE)
    sel_blocks = torch.gather(block_ids, 1, top_block_pos)
    thr = _heap_threshold(top_block_scores[:, min(k, BE) - 1], heap_factor)
    eval_mask = torch.isfinite(top_block_scores) & (
        top_block_scores >= thr[:, None])
    sel_blocks = torch.where(eval_mask, sel_blocks, sentinel_block).long()

    # ---- 5. candidate doc windows ----
    starts = index.block_start[sel_blocks]  # [B, BE]
    lens = index.block_len[sel_blocks]
    offs = torch.arange(Lmax, dtype=torch.int32, device=dev)
    pidx = (starts[..., None] + offs).clamp(
        max=index.postings.shape[0] - 1).long()
    cmask = (offs < lens[..., None]) & eval_mask[..., None]
    NC = BE * Lmax
    cand_ids = torch.where(cmask, index.postings[pidx], n_docs).reshape(B, NC)
    cmask = cmask.reshape(B, NC)
    safe_cand = cand_ids.clamp(max=n_docs - 1)

    if params.doc_mode == "rescore":
        top_c, top_v, sc = _query_terms(q_comps, q_vals, params.score_cut)
        # candidate columns in chunks of 512: one kernel launch each
        scores = rescore_exact(index, safe_cand, top_c, top_v, sc,
                               chunk_r=512)
        scores = torch.where(cmask, scores, -torch.inf)
        # pool, then dedup on the small pool only: a doc can occur once
        # per selected list, so the pool must be well above k
        pool = min(params.dedup_pool if params.dedup_pool > 0
                   else max(8 * k, 64), NC)
        scores, ppos = _top_k(scores, pool)
        cand_ids = torch.gather(cand_ids, 1, ppos)
    else:
        # ---- 6. coarse candidate ranking (sketch) ----
        NE = min(params.cand_budget if params.cand_budget > 0 else NC, NC)
        if NE < NC:
            if index.doc_sketch is None:
                raise ValueError("cand_budget > 0 needs an index built "
                                 "with sketches (sketch_dim > 0)")
            if q_sk is None:
                q_sk = sketch_padded_queries(q_comps, q_vals, sketch_dim,
                                             sketch_seed)
            coarse = _sketch_scores(index.doc_sketch,
                                    index.doc_sketch_scale, safe_cand, q_sk)
            coarse = torch.where(cmask, coarse, -torch.inf)
            _, keep = _top_k(coarse, NE)
            cand_ids = torch.gather(cand_ids, 1, keep)
            cmask = torch.gather(cmask, 1, keep)
            safe_cand = cand_ids.clamp(max=n_docs - 1)
        # ---- 7. exact scoring ----
        scores = _exact_scores(index, qd, safe_cand)
        scores = torch.where(cmask, scores, -torch.inf)

    # ---- 8. dedup (visited set) + top-k ----
    scores, sids = _dedup_by_id(scores, cand_ids, n_docs)
    top_scores, pos = _top_k(scores, k)
    top_ids = torch.gather(sids, 1, pos)

    # ---- 9. k-NN refinement ----
    if params.n_knn > 0 and index.knn is not None:
        top_scores, top_ids = _knn_refine(index, params, qd, top_scores,
                                          top_ids)
    return top_scores, torch.where(torch.isfinite(top_scores), top_ids, -1)


def search_batch(index: DeviceIndex, q_comps, q_vals, params: SearchParams,
                 heap_factor: float = 0.7, sketch_dim: int = 128,
                 sketch_seed: int = 42):
    """NumPy in, NumPy out, on the index's device: q_comps int32 /
    q_vals f32 [B, Q] padded queries -> (scores f32 [B, k], ids int64
    [B, k], -1 where no result). `heap_factor` is rounded to f32 before
    it multiplies the block-score threshold, as the JAX program's traced
    f32 scalar is. `sketch_dim` / `sketch_seed` are those the index's
    sketches were built with (`block_mode="sketch"`, `cand_budget`)."""
    dev = index.device
    scores, ids = _search_impl(
        index,
        torch.from_numpy(np.ascontiguousarray(q_comps, np.int32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(q_vals, np.float32)).to(dev),
        float(np.float32(heap_factor)),
        params, sketch_dim, sketch_seed,
    )
    return scores.cpu().numpy(), ids.to(torch.int64).cpu().numpy()
