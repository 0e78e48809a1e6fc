"""Static index pruning — the main memory/recall knob.

Vectorized NumPy re-implementations of the reference strategies
(reference: src/inverted_index.rs:293-389). Instead of per-list heaps we
sort the global (component, value, doc) entry table once and slice it, which
is equivalent and vastly faster in NumPy.

All strategies return a "posting table": arrays (list_id, doc_id, value)
sorted by list_id, plus per-list offsets — the flat analogue of the
reference's `Vec<Vec<(value, doc_id)>>`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import (
    CoiThresholdPruning,
    FixedSizePruning,
    GlobalThresholdPruning,
)
from ..data.sparse import CsrDataset


@dataclass
class PostingTable:
    """Pruned postings grouped by list (component) id."""

    offsets: np.ndarray  # int64 [n_lists + 1]
    doc_ids: np.ndarray  # int64 [total]
    values: np.ndarray  # float32 [total]
    n_lists: int

    def list_slice(self, list_id: int):
        s, e = int(self.offsets[list_id]), int(self.offsets[list_id + 1])
        return self.doc_ids[s:e], self.values[s:e]

    def list_lengths(self) -> np.ndarray:
        return np.diff(self.offsets)


def _entry_table(dataset: CsrDataset):
    """All (component, doc, value) entries of the dataset, flat."""
    lengths = dataset.row_lengths()
    docs = np.repeat(np.arange(len(dataset), dtype=np.int64), lengths)
    return dataset.components.astype(np.int64), docs, dataset.values.astype(
        np.float32
    )


def _group_by_list(
    comps: np.ndarray, docs: np.ndarray, vals: np.ndarray, n_lists: int
) -> PostingTable:
    order = np.argsort(comps, kind="stable")
    comps, docs, vals = comps[order], docs[order], vals[order]
    counts = np.bincount(comps, minlength=n_lists)
    offsets = np.zeros(n_lists + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return PostingTable(offsets, docs, vals, n_lists)


def fixed_pruning(dataset: CsrDataset, n_postings: int) -> PostingTable:
    """Top-`n_postings` highest-value postings per list
    (reference: inverted_index.rs:293-329)."""
    comps, docs, vals = _entry_table(dataset)
    # Sort by (component asc, value desc) and keep the first n per component.
    order = np.lexsort((-vals, comps))
    comps, docs, vals = comps[order], docs[order], vals[order]
    counts = np.bincount(comps, minlength=dataset.dim)
    starts = np.zeros(dataset.dim, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:]) if dataset.dim > 1 else None
    rank_in_list = np.arange(len(comps), dtype=np.int64) - starts[comps]
    keep = rank_in_list < n_postings
    return _group_by_list(comps[keep], docs[keep], vals[keep], dataset.dim)


def global_threshold_pruning(
    dataset: CsrDataset, n_postings: int, max_fraction: float
) -> PostingTable:
    """Globally largest `dim * n_postings` entries, per-list cap
    `n_postings * max_fraction` (reference: inverted_index.rs:354-389).

    The reference iterates entries in dataset order through a global heap and
    then appends in heap-pop order; we reproduce the same *set* semantics:
    take the `tot` globally largest entries (ties broken toward earlier
    dataset entries, matching k_largest stability), then cap each list at
    `n_postings * max_fraction` keeping that list's largest entries.
    """
    comps, docs, vals = _entry_table(dataset)
    tot = min(dataset.dim * n_postings, len(vals))
    if tot < len(vals):
        # Global top-`tot` by value (stable: earlier entries win ties).
        order = np.argsort(-vals, kind="stable")[:tot]
        comps, docs, vals = comps[order], docs[order], vals[order]
    cap = int(n_postings * max_fraction)
    # Cap per list by value rank.
    order = np.lexsort((-vals, comps))
    comps, docs, vals = comps[order], docs[order], vals[order]
    counts = np.bincount(comps, minlength=dataset.dim)
    starts = np.zeros(dataset.dim, dtype=np.int64)
    if dataset.dim > 1:
        np.cumsum(counts[:-1], out=starts[1:])
    rank_in_list = np.arange(len(comps), dtype=np.int64) - starts[comps]
    keep = rank_in_list < cap
    return _group_by_list(comps[keep], docs[keep], vals[keep], dataset.dim)


def coi_pruning(
    dataset: CsrDataset, alpha: float, max_n_postings: int
) -> PostingTable:
    """Per-list fractional pruning: keep `min(max, alpha * len + 1)` largest
    postings of each list (reference: inverted_index.rs:333-351; declared but
    unreachable in the reference build — implemented here for completeness).
    """
    comps, docs, vals = _entry_table(dataset)
    order = np.lexsort((-vals, comps))
    comps, docs, vals = comps[order], docs[order], vals[order]
    counts = np.bincount(comps, minlength=dataset.dim)
    starts = np.zeros(dataset.dim, dtype=np.int64)
    if dataset.dim > 1:
        np.cumsum(counts[:-1], out=starts[1:])
    rank_in_list = np.arange(len(comps), dtype=np.int64) - starts[comps]
    per_list_cap = np.minimum(
        max_n_postings, (counts * alpha).astype(np.int64) + 1
    )
    keep = rank_in_list < per_list_cap[comps]
    return _group_by_list(comps[keep], docs[keep], vals[keep], dataset.dim)


def prune(dataset: CsrDataset, strategy) -> PostingTable:
    if isinstance(strategy, FixedSizePruning):
        return fixed_pruning(dataset, strategy.n_postings)
    if isinstance(strategy, GlobalThresholdPruning):
        return global_threshold_pruning(
            dataset, strategy.n_postings, strategy.max_fraction
        )
    if isinstance(strategy, CoiThresholdPruning):
        return coi_pruning(dataset, strategy.alpha, strategy.n_postings)
    raise TypeError(f"unknown pruning strategy: {strategy!r}")
