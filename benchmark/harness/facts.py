"""What a kernel count reads about one distinct batch: the cell's inputs
(the queries, the query settings), the index's list lengths and tile
width, the documents' lengths, and, after the window, the reference's
exact top documents of each query. Nothing here is the plan or a launch
shape the program derived."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BatchFacts:
    q_offsets: np.ndarray  # int64 [B + 1]
    q_comps: np.ndarray  # int32
    q_vals: np.ndarray  # f32
    settings: dict  # the query settings (k, query_cut, score_cut, ...)
    list_len: np.ndarray  # int64 [n_lists]: each posting list's length
    tile_v: int  # columns of a doc tile row
    doc_nnz: np.ndarray  # int64 [n_docs]: each document's nonzeros
    ref_ids: np.ndarray = None  # int64 [B, r]: exact top-r documents

    @property
    def batch(self) -> int:
        return len(self.q_offsets) - 1

    def selected_lists(self, query_cut: int) -> np.ndarray:
        """int64 [pairs]: each query's top-`query_cut` terms by value
        whose posting list is not empty, query by query."""
        out = []
        n_lists = len(self.list_len)
        for b in range(self.batch):
            s, e = int(self.q_offsets[b]), int(self.q_offsets[b + 1])
            c, v = self.q_comps[s:e], self.q_vals[s:e]
            top = c[np.argsort(-v, kind="stable")[:query_cut]]
            top = top[top < n_lists]
            out.append(top[self.list_len[top] > 0])
        return (np.concatenate(out).astype(np.int64) if out
                else np.zeros(0, np.int64))
