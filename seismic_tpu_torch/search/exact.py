"""Exact (brute-force) maximum-inner-product search: the ground truth of
recall and the search behind `SeismicDataset`.

Counterpart of `seismic_tpu/search/exact.py` (the reference `FlatIndex`,
src/inverted_index_wrapper.rs:721-742). The collection goes to the device
as sparse CSR matrices of `chunk` documents each; each is multiplied
against a dense block of queries (`torch.sparse.mm`), and the queries go
in blocks, so the dense block ([dim, block] f32) stays small at any batch
size. Ties go to the smaller document id: the full sort is stable, and the
streaming merge sorts on (score desc, id asc) as the JAX merge does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.sparse import CsrDataset
from ..device import resolve_device

# queries a dense block holds: [dim, 2048] f32 is 250 MB at dim 30522
_QUERY_BLOCK = 2048


def densify_queries(
    q_comps: np.ndarray, q_vals: np.ndarray, dim: int
) -> np.ndarray:
    """Padded query batch [B, Q] -> dense [B, dim] float32 (host)."""
    B = q_comps.shape[0]
    out = np.zeros((B, dim), dtype=np.float32)
    valid = (q_comps >= 0) & (q_comps < dim)
    rows = np.broadcast_to(np.arange(B)[:, None], q_comps.shape)[valid]
    out[rows, q_comps[valid]] = q_vals[valid]
    return out


def _doc_chunks(dataset: CsrDataset, chunk: int, dev):
    """The collection as CSR matrices of `chunk` rows each, on `dev`:
    [(first doc id, its [rows, dim] sparse tensor)]."""
    offsets = torch.from_numpy(np.asarray(dataset.offsets, np.int64))
    comps = torch.from_numpy(np.asarray(dataset.components, np.int64)).to(dev)
    vals = torch.from_numpy(np.asarray(dataset.values, np.float32)).to(dev)
    n = len(dataset)
    out = []
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        s, e = int(offsets[start]), int(offsets[end])
        crow = (offsets[start:end + 1] - s).to(dev)
        out.append((start, torch.sparse_csr_tensor(
            crow, comps[s:e], vals[s:e], size=(end - start, dataset.dim),
            check_invariants=False)))
    return out


def _query_blocks(q_comps, q_vals, dim: int, dev):
    """Yield (first row, dense [dim, block] f32 queries on `dev`), one
    block at a time (each freed before the next is made)."""
    B = q_comps.shape[0]
    for q0 in range(0, B, _QUERY_BLOCK):
        qd = densify_queries(q_comps[q0:q0 + _QUERY_BLOCK],
                             q_vals[q0:q0 + _QUERY_BLOCK], dim)
        yield q0, torch.from_numpy(np.ascontiguousarray(qd.T)).to(dev)


def _merge_topk(run_s, run_i, chunk_s, start: int, k: int):
    """Merge a chunk's scores [b, C] into the running top-k with the same
    (score desc, id asc) tie-breaking as the full sort."""
    C = chunk_s.shape[1]
    cs, ci = torch.sort(chunk_s, dim=1, descending=True, stable=True)
    cs, ci = cs[:, :min(k, C)], ci[:, :min(k, C)] + start
    s_cat = torch.cat([run_s, cs], dim=1)
    i_cat = torch.cat([run_i, ci], dim=1)
    neg = torch.where(torch.isfinite(s_cat), -s_cat, torch.inf)
    # ascending (neg score, id): a stable sort by id, then by neg score
    o1 = torch.sort(i_cat, dim=1, stable=True).indices
    o2 = torch.sort(torch.gather(neg, 1, o1), dim=1, stable=True).indices
    order = torch.gather(o1, 1, o2)[:, :k]
    return -torch.gather(neg, 1, order), torch.gather(i_cat, 1, order)


def exact_search(
    dataset: CsrDataset,
    q_comps: np.ndarray,
    q_vals: np.ndarray,
    k: int,
    chunk: int = 4096,
    stream: bool | None = None,
    device=None,
):
    """Exact top-k by dot product on `device` (None: the card). Returns
    (scores f32 [B, k], doc_ids int64 [B, k]), NumPy.

    Ties are broken by the smaller document id. With `stream`
    (auto-enabled when the full [B, n_docs] score matrix would exceed
    ~4 GB) each document chunk's scores are merged into a running top-k
    instead of sorting whole score rows; the results are identical.
    """
    dev = resolve_device(device)
    B = q_comps.shape[0]
    n = len(dataset)
    if stream is None:
        stream = B * n * 4 > 4e9
    k_eff = min(k, n)
    top_s = np.full((B, k), -np.inf, np.float32)
    top_i = np.full((B, k), -1, np.int64)
    docs = _doc_chunks(dataset, chunk, dev)
    for q0, qd in _query_blocks(q_comps, q_vals, dataset.dim, dev):
        b = qd.shape[1]
        if stream:
            s = torch.full((b, k_eff), -torch.inf, device=dev)
            i = torch.full((b, k_eff), n, dtype=torch.int64, device=dev)
            for start, d in docs:
                s, i = _merge_topk(s, i, torch.sparse.mm(d, qd).t(), start,
                                   k_eff)
            i = torch.where(torch.isfinite(s), i, -1)
        else:
            scores = torch.cat([torch.sparse.mm(d, qd) for _, d in docs])
            s, i = torch.sort(scores.t(), dim=1, descending=True,
                              stable=True)
            s, i = s[:, :k_eff], i[:, :k_eff]
            del scores
        top_s[q0:q0 + b, :k_eff] = s.cpu().numpy()
        top_i[q0:q0 + b, :k_eff] = i.cpu().numpy()
        del qd
    return top_s, top_i


def exact_search_numpy(
    dataset: CsrDataset, q_comps: np.ndarray, q_vals: np.ndarray, k: int
):
    """Pure-NumPy oracle used by unit tests (independent of torch)."""
    dim = dataset.dim
    q_dense = densify_queries(q_comps, q_vals, dim)
    n = len(dataset)
    scores = np.zeros((q_comps.shape[0], n), dtype=np.float32)
    for d in range(n):
        comps, vals = dataset.get(d)
        scores[:, d] = q_dense[:, comps] @ vals.astype(np.float32)
    k_eff = min(k, n)
    idx = np.argsort(-scores, axis=1, kind="stable")[:, :k_eff]
    top = np.take_along_axis(scores, idx, axis=1)
    return top, idx.astype(np.int64)
