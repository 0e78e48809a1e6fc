"""Exact top-k by sparse inner product, in plain PyTorch.

The documents are a CSR matrix [n_docs, dim] whose values are first
rounded to the precision the configuration states for the index's
values (f32, f16, ...) and then held as f32; a block of f32 queries is a dense f32 matrix
[dim, block]. One sparse-dense product gives every document's exact score
for the block, from which come the top-k of each query and the exact
score of any (query, document) pair an answer names. TF32 is off, so the
products are full f32.

`LOWER` names the control's precision: the same search with the
documents' values rounded to the next precision down (bf16 below f32, fp8 e4m3 below f16),
the step a later change might be tempted to take.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

_DTYPES = {
    "f64": torch.float64, "f32": torch.float32, "f16": torch.float16,
    "bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn,
}
# the nearest precision below each stated one
LOWER = {"f64": "f32", "f32": "bf16", "f16": "fp8", "bf16": "fp8"}


def rounded(values, precision: str, device) -> torch.Tensor:
    """`values` rounded to `precision`, held as f32 on `device`."""
    t = torch.as_tensor(np.asarray(values, np.float32), device=device)
    return t.to(_DTYPES[precision]).to(torch.float32)


class Exact:
    """Exact search over the documents `docs` = (offsets, comps, vals)."""

    def __init__(self, docs, dim: int, precision: str, device,
                 block: int = 2048):
        offsets, comps, vals = docs
        self.dim, self.device, self.block = dim, device, block
        self.precision = precision
        self.n_docs = len(offsets) - 1
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "Sparse CSR tensor support")
            self.matrix = torch.sparse_csr_tensor(
                torch.as_tensor(np.asarray(offsets, np.int64), device=device),
                torch.as_tensor(np.asarray(comps, np.int64), device=device),
                rounded(vals, precision, device),
                size=(self.n_docs, dim), check_invariants=True)

    def search(self, queries, k: int, pairs=None):
        """Top-k of every query of `queries` = (offsets, comps, vals), and
        the exact score of each (query index, doc id) of `pairs`.

        Returns (ids int64 [Q, k], scores f32 [Q, k], pair scores f32
        [len(pairs)] or None). The queries' values stay f32: the
        configuration states the precision of the index's values."""
        q_off, q_comps, q_vals = (np.asarray(a) for a in queries)
        Q = len(q_off) - 1
        ids = np.empty((Q, k), np.int64)
        top = np.empty((Q, k), np.float32)
        pq = pd = None
        pair_scores = None
        if pairs is not None:
            pq, pd = (np.asarray(a, np.int64) for a in pairs)
            pair_scores = np.full(len(pq), np.nan, np.float32)
            order = np.argsort(pq, kind="stable")
            pq_sorted = pq[order]
        qv_all = torch.as_tensor(np.asarray(q_vals, np.float32),
                                 device=self.device)
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            for q0 in range(0, Q, self.block):
                q1 = min(q0 + self.block, Q)
                s0, s1 = int(q_off[q0]), int(q_off[q1])
                rows = torch.as_tensor(
                    np.repeat(np.arange(q1 - q0), np.diff(q_off[q0:q1 + 1])),
                    device=self.device)
                cols = torch.as_tensor(q_comps[s0:s1].astype(np.int64),
                                       device=self.device)
                dense = torch.zeros((self.dim, q1 - q0), dtype=torch.float32,
                                    device=self.device)
                dense.index_put_((cols, rows), qv_all[s0:s1], accumulate=True)
                scores = torch.sparse.mm(self.matrix, dense)  # [n_docs, b]
                v, i = torch.topk(scores, k, dim=0)
                ids[q0:q1] = i.t().cpu().numpy()
                top[q0:q1] = v.t().cpu().numpy()
                if pairs is not None:
                    a = np.searchsorted(pq_sorted, q0)
                    b = np.searchsorted(pq_sorted, q1)
                    sel = order[a:b]
                    if len(sel):
                        d = torch.as_tensor(pd[sel], device=self.device)
                        qq = torch.as_tensor(pq[sel] - q0, device=self.device)
                        ok = (d >= 0) & (d < self.n_docs)
                        got = scores[d.clamp(0, self.n_docs - 1), qq]
                        got = torch.where(ok, got, float("nan"))
                        pair_scores[sel] = got.cpu().numpy()
                del scores, dense
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
        return ids, top, pair_scores
