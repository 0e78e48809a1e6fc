"""Helpers of the JAX engine path that the grouped route shares.

Only `_decode_fwd_vals` (the f32 fused-row case) and `_dedup_by_id` of
`seismic_tpu/search/engine.py` so far; the engine path itself
(`_search_impl`) is a later slice (ROADMAP.md, modules to port, item 5).
"""

from __future__ import annotations

import torch

from ..data.sparse import PAD_COMPONENT


def _decode_fwd_vals(tiles_vals, tiles_comps):
    """Decode gathered f32 forward values: 0 at padding. `tiles_comps` may
    be the int32 comps (PAD_COMPONENT padded) or a validity mask (bool).
    The u8-compressed variant (per-doc min/step) is not served yet."""
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
