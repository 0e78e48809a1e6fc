"""k-NN graph construction, persistence and truncation.

Counterpart of `seismic_tpu/search/knn.py` (the reference `Knn`,
src/inverted_index.rs:430-593): the graph is built by self-searching
every document through the engine path (`search/engine.py::search_batch`)
with the reference constants (k = nknn + 1, query_cut = 10, heap_factor =
0.7) and dropping the document itself. The documents' own padded forward
rows are the query batches, each batch padded to one shape.

The graph is a dense [n_docs, nknn] int32 array, -1 padded. Its file is
the JAX package's: `np.savez` of `neighbours` and a JSON `__meta__`, at
`<path>.knn.seismic_tpu`, so a graph saved by either package loads in the
other.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..data.sparse import PAD_COMPONENT
from ..types import KNN_SUFFIX, DeviceIndex, IndexArrays
from .engine import SearchParams, search_batch

KNN_QUERY_CUT = 10
KNN_HEAP_FACTOR = 0.7


def build_knn(
    arrays: IndexArrays,
    device_index: DeviceIndex,
    nknn: int,
    batch_size: int = 256,
    block_budget: int = 64,
    cand_budget: int = 0,
) -> np.ndarray:
    """Self-search every document on `device_index`; returns [n_docs,
    nknn] int32 (-1 padded)."""
    n_docs = arrays.n_docs
    params = self_search_params(arrays, nknn, block_budget, cand_budget)
    out = np.full((n_docs, nknn), -1, dtype=np.int32)
    fwd_comps = arrays.fwd_comps
    for start in range(0, n_docs, batch_size):
        end = min(start + batch_size, n_docs)
        b = end - start
        q_comps = fwd_comps[start:end]
        q_vals = _decode_host_vals(arrays, start, end)
        if b < batch_size:  # keep a single batch shape
            padw = batch_size - b
            q_comps = np.pad(
                q_comps, ((0, padw), (0, 0)), constant_values=PAD_COMPONENT
            )
            q_vals = np.pad(q_vals, ((0, padw), (0, 0)))
        _, ids = search_batch(device_index, q_comps, q_vals, params,
                              heap_factor=KNN_HEAP_FACTOR)
        out[start:end] = drop_self(ids[:b], np.arange(start, end), nknn)
    return out


def self_search_params(arrays: IndexArrays, nknn: int,
                       block_budget: int = 64,
                       cand_budget: int = 0) -> SearchParams:
    """The engine parameters of the graph's self-search: k = nknn + 1, the
    dense block ranking where the index has it, every posting of the
    selected lists in tiles mode."""
    use_tiles = arrays.doc_tiles is not None
    return SearchParams(
        k=nknn + 1,
        query_cut=KNN_QUERY_CUT,
        block_budget=block_budget,
        cand_budget=cand_budget,
        block_mode="dense" if arrays.dense_summary is not None else "summary",
        doc_mode="tiles" if use_tiles else "gather",
        full_lists=use_tiles,
        n_knn=0,
    )


def drop_self(ids: np.ndarray, docs: np.ndarray, nknn: int) -> np.ndarray:
    """Each row's valid ids other than its own doc, in order, the first
    `nknn` of them, -1 after: the per-document loop of the JAX package
    (`[d for d in ids[i] if d >= 0 and d != doc][:nknn]`) as one pass."""
    keep = (ids >= 0) & (ids != docs[:, None])
    # a stable sort on "dropped" moves the kept ids to the front in order
    order = np.argsort(~keep, axis=1, kind="stable")[:, :nknn]
    picked = np.take_along_axis(ids, order, axis=1)
    kept = np.take_along_axis(keep, order, axis=1)
    return np.where(kept, picked, -1).astype(np.int32)


def _decode_host_vals(arrays: IndexArrays, start: int, end: int) -> np.ndarray:
    vals = arrays.fwd_vals[start:end].astype(np.float32)
    if arrays.fwd_val_min is not None:
        vals = (
            vals * arrays.fwd_val_step[start:end, None]
            + arrays.fwd_val_min[start:end, None]
        )
        vals = np.where(
            arrays.fwd_comps[start:end] != PAD_COMPONENT, vals, 0.0
        )
    return vals


def save_knn(knn: np.ndarray, path: str) -> str:
    """Persist to `<path>.knn.seismic_tpu` (reference: .knn.seismic,
    inverted_index.rs:542-548)."""
    if not path.endswith(KNN_SUFFIX):
        path = path + KNN_SUFFIX
    meta = {"n_vecs": int(knn.shape[0]), "dim": int(knn.shape[1])}
    np.savez(
        path,
        neighbours=knn,
        __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
    )
    if os.path.exists(path + ".npz"):
        os.replace(path + ".npz", path)
    return path


def load_knn(path: str, nknn: int | None = None) -> np.ndarray:
    """Load a graph, optionally truncating each row to the first `nknn`
    neighbours (reference: new_from_serialized, inverted_index.rs:502-540)."""
    if not path.endswith(KNN_SUFFIX) and os.path.exists(path + KNN_SUFFIX):
        path = path + KNN_SUFFIX
    with np.load(path, allow_pickle=False) as z:
        knn = z["neighbours"]
    if nknn is not None:
        if nknn > knn.shape[1]:
            raise ValueError(
                f"requested nknn={nknn} exceeds the {knn.shape[1]} neighbors "
                "stored in the file"
            )
        knn = knn[:, :nknn].copy()
    return knn
