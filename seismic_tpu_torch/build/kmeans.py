"""Randomized k-means clustering of posting lists into geometric blocks.

Re-implements the reference's three clustering variants
(reference: src/utils.rs:106-520) with vectorized NumPy set operations
instead of per-doc loops: all three reduce to a *sparse join* between the
docs' entries and the centroids' entries on the component axis, accumulated
with `np.bincount` into a dense [n_docs, n_centroids] score matrix.

Semantics preserved from the reference:
- centroids are `n_centroids` random docs of the list (deterministic seed);
- clusters of size <= min_cluster_size are dissolved and their docs
  reassigned among the surviving centroids;
- the result is (centroid_doc_id, doc_id) pairs sorted lexicographically,
  so blocks are ordered by centroid doc id and docs sorted within a block.

Deliberate divergences (documented): ties in argmax go to the
first-encountered centroid; the plain-exact variant also excludes dissolved
centroids during reassignment (the reference quirkily does not,
utils.rs:414-453).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..config import (
    RandomKmeans,
    RandomKmeansInvertedIndex,
    RandomKmeansInvertedIndexApprox,
)
from ..data.sparse import CsrDataset

NEG_INF = np.float32(-np.inf)

_GOLD = np.uint64(0x9E3779B97F4A7C15)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64) + _GOLD
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def select_centroid_positions(seed: int, list_id: int, n: int, m: int):
    """Deterministic pseudo-random choice of m positions out of n: the m
    smallest splitmix64 hashes, ascending. Bit-identical to the native
    build core (native/build_core.cpp) so both pipelines pick the same
    centroids."""
    i = np.arange(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        list_key = _GOLD * np.uint64(list_id + 1)  # intentional wraparound
    key = np.uint64(seed) ^ list_key ^ i
    h = _splitmix64(key)
    pos = np.argsort(h, kind="stable")[:m]
    return np.sort(pos)


def _doc_entries(dataset: CsrDataset, doc_ids: np.ndarray):
    """Flat (local_doc_idx, comp, value) entries for the given docs
    (fully vectorized gather of CSR row ranges)."""
    doc_ids = np.asarray(doc_ids, dtype=np.int64)
    lo = dataset.offsets[doc_ids]
    counts = dataset.offsets[doc_ids + 1] - lo
    flat, local = _expand_ranges(lo, counts)
    comps = dataset.components[flat].astype(np.int64)
    vals = dataset.values[flat].astype(np.float32)
    return local, comps, vals


def _top_per_row(local, comps, vals, cut: int):
    """Restrict flat entries to each row's `cut` largest values
    (reference doc_cut restriction, utils.rs:125-127)."""
    order = np.lexsort((-vals, local))
    local, comps, vals = local[order], comps[order], vals[order]
    # rank within each row
    counts = np.bincount(local, minlength=(local.max() + 1) if len(local) else 0)
    starts = np.zeros(len(counts), dtype=np.int64)
    if len(counts) > 1:
        np.cumsum(counts[:-1], out=starts[1:])
    rank = np.arange(len(local), dtype=np.int64) - starts[local]
    keep = rank < cut
    return local[keep], comps[keep], vals[keep]


def _expand_ranges(lo: np.ndarray, counts: np.ndarray):
    """Flatten [lo_i, lo_i + counts_i) ranges; returns (flat_idx, owner)."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    owner = np.repeat(np.arange(len(lo), dtype=np.int64), counts)
    before = np.zeros(len(lo), dtype=np.int64)
    np.cumsum(counts[:-1], out=before[1:])
    flat = np.arange(total, dtype=np.int64) - before[owner] + lo[owner]
    return flat, owner


def _join_scores(
    d_local, d_comps, d_vals, c_comps_sorted, c_cent, c_vals, n: int, m: int
) -> np.ndarray:
    """Dense [n, m] score matrix: sum over shared components of
    doc_value * centroid_value (a CSR x CSC sparse matmul via join)."""
    lo = np.searchsorted(c_comps_sorted, d_comps, side="left")
    hi = np.searchsorted(c_comps_sorted, d_comps, side="right")
    flat, owner = _expand_ranges(lo, hi - lo)
    if len(flat) == 0:
        return np.zeros((n, m), dtype=np.float32)
    contrib = d_vals[owner].astype(np.float64) * c_vals[flat]
    key = d_local[owner] * m + c_cent[flat]
    scores = np.bincount(key, weights=contrib, minlength=n * m)
    return scores.reshape(n, m).astype(np.float32)


def _centroid_entries(dataset: CsrDataset, centroid_doc_ids: np.ndarray):
    """Centroid inverted index: entries sorted by component
    (reference: utils.rs:171-178)."""
    local, comps, vals = _doc_entries(dataset, centroid_doc_ids)
    order = np.argsort(comps, kind="stable")
    return comps[order], local[order], vals[order].astype(np.float64)


def _dissolve_and_reassign(
    scores: np.ndarray,
    assign: np.ndarray,
    min_cluster_size: int,
) -> np.ndarray:
    """Dissolve clusters of size <= min_cluster_size; reassign their docs to
    the best surviving centroid (reference: utils.rs:189-236)."""
    m = scores.shape[1]
    sizes = np.bincount(assign, minlength=m)
    removed = sizes <= min_cluster_size
    # Docs in removed clusters AND docs assigned to nothing real.
    if not removed.any() or removed.all():
        if removed.all():
            # Everything dissolved: fall back to centroid 0 for everyone
            # (mirrors the unwrap_or fallback, utils.rs:139).
            return np.zeros_like(assign)
        return assign
    affected = removed[assign]
    masked = scores[affected].copy()
    masked[:, removed] = NEG_INF
    assign = assign.copy()
    assign[affected] = np.argmax(masked, axis=1)
    return assign


def _assignments_to_blocks(
    doc_ids: np.ndarray, assign: np.ndarray, centroid_doc_ids: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Sort (centroid_doc_id, doc_id) pairs and emit block offsets
    (reference: posting_list.rs:279-299)."""
    cdoc = centroid_doc_ids[assign]
    order = np.lexsort((doc_ids, cdoc))
    ordered_docs = doc_ids[order]
    ordered_cdoc = cdoc[order]
    # Block boundaries where the centroid changes.
    change = np.nonzero(np.diff(ordered_cdoc))[0] + 1
    offsets = np.concatenate(
        [[0], change, [len(ordered_docs)]]
    ).astype(np.int64)
    return ordered_docs, offsets


def kmeans_blocking(
    dataset: CsrDataset,
    doc_ids: np.ndarray,
    centroid_fraction: float,
    min_cluster_size: int,
    algorithm,
    seed: int,
    list_id: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Cluster one posting list. Returns (reordered_doc_ids, block_offsets).

    Deterministic given (seed, list_id), preserving the reference's
    reproducible-build property (fixed seeds at utils.rs:163,327,466).
    """
    n = len(doc_ids)
    if n == 0:
        return doc_ids, np.zeros(1, dtype=np.int64)
    n_centroids = max(1, int(centroid_fraction * n))
    if n_centroids > 65535:
        raise ValueError(
            "number of centroids cannot exceed 65535; decrease centroid_fraction"
        )
    pos = select_centroid_positions(seed, list_id, n, n_centroids)
    centroid_doc_ids = np.asarray(doc_ids)[pos]

    d_local, d_comps, d_vals = _doc_entries(dataset, doc_ids)
    c_comps, c_cent, c_vals = _centroid_entries(dataset, centroid_doc_ids)
    m = n_centroids

    if isinstance(algorithm, RandomKmeansInvertedIndexApprox):
        # Approximate scores through the centroid inverted index, docs
        # restricted to their top doc_cut components (utils.rs:106-144).
        rl, rc, rv = _top_per_row(d_local, d_comps, d_vals, algorithm.doc_cut)
        scores = _join_scores(rl, rc, rv, c_comps, c_cent, c_vals, n, m)
        assign = np.argmax(scores, axis=1)
    elif isinstance(algorithm, RandomKmeansInvertedIndex):
        # Exact dots, restricted to centroids reachable through a pruned
        # centroid inverted index over the doc's top doc_cut components
        # (utils.rs:239-306,316-364).
        pruned_size = max(5, int(len(doc_ids) * algorithm.pruning_factor))
        pc, pcent, pvals = _prune_centroid_index(
            c_comps, c_cent, c_vals, pruned_size
        )
        rl, rc, rv = _top_per_row(d_local, d_comps, d_vals, algorithm.doc_cut)
        reach = _join_scores(
            rl, rc, np.ones_like(rv), pc, pcent, np.ones_like(pvals), n, m
        )
        exact = _join_scores(d_local, d_comps, d_vals, c_comps, c_cent, c_vals, n, m)
        scores = np.where(reach > 0, exact, NEG_INF)
        assign = _argmax_positive(scores, fallback=0)
        assign = _self_assign(doc_ids, centroid_doc_ids, assign)
    elif isinstance(algorithm, RandomKmeans):
        # Exact dots against every centroid (utils.rs:414-520).
        scores = _join_scores(d_local, d_comps, d_vals, c_comps, c_cent, c_vals, n, m)
        assign = _argmax_positive(scores, fallback=0)
        assign = _self_assign(doc_ids, centroid_doc_ids, assign)
        # `scores` is reused below for reassignment.
    else:
        raise TypeError(f"unknown clustering algorithm: {algorithm!r}")

    if isinstance(algorithm, RandomKmeansInvertedIndexApprox):
        assign = _dissolve_and_reassign(scores, assign, min_cluster_size)
    else:
        assign = _dissolve_and_reassign(scores, assign, min_cluster_size)
        assign = _self_assign(doc_ids, centroid_doc_ids, assign, only_if_kept=True)

    return _assignments_to_blocks(doc_ids, assign, centroid_doc_ids)


def _prune_centroid_index(c_comps, c_cent, c_vals, pruned_size: int):
    """Keep each component's `pruned_size` largest centroid entries
    (reference: utils.rs:334-355)."""
    order = np.lexsort((-c_vals, c_comps))
    cc, ct, cv = c_comps[order], c_cent[order], c_vals[order]
    if len(cc) == 0:
        return cc, ct, cv
    uniq, starts = np.unique(cc, return_index=True)
    start_of = np.zeros(len(cc), dtype=np.int64)
    start_of[starts] = starts
    start_of = np.maximum.accumulate(start_of)
    rank = np.arange(len(cc), dtype=np.int64) - start_of
    keep = rank < pruned_size
    return cc[keep], ct[keep], cv[keep]


def _argmax_positive(scores: np.ndarray, fallback: int) -> np.ndarray:
    """argmax requiring a strictly positive score, else `fallback`
    (max_dot starts at 0.0 in the reference, utils.rs:284,435)."""
    assign = np.argmax(scores, axis=1)
    best = scores[np.arange(len(scores)), assign]
    return np.where(best > 0, assign, fallback)


def _self_assign(
    doc_ids: np.ndarray,
    centroid_doc_ids: np.ndarray,
    assign: np.ndarray,
    only_if_kept: bool = False,
) -> np.ndarray:
    """Docs that are themselves centroids stay in their own cluster
    (reference: utils.rs:259-262,426-429)."""
    order = np.argsort(centroid_doc_ids, kind="stable")
    sorted_cents = centroid_doc_ids[order]
    pos = np.searchsorted(sorted_cents, doc_ids)
    pos_clipped = np.minimum(pos, len(sorted_cents) - 1)
    is_centroid = sorted_cents[pos_clipped] == doc_ids
    target = order[pos_clipped]
    if only_if_kept:
        kept_mask = np.zeros(len(centroid_doc_ids), dtype=bool)
        kept_mask[np.unique(assign)] = True
        is_centroid = is_centroid & kept_mask[target]
    return np.where(is_centroid, target, assign)
