"""FlatTermIndex: exact brute-force search over term columns.

Counterpart of `seismic_tpu/search/flat.py`, with the same arrays and file
format: the collection is stored TRANSPOSED as a dense u8 matrix `[dim +
1, n_docs]` (one row a vocabulary term, row `dim` zeros, a per-document
scale), and a query is answered by reading its term rows and
accumulating `sum_i qv_i * D[qc_i, :]` in f32, then a top-k. Exact up to
u8 quantization (~0.4% relative). Memory is `dim * n_docs` bytes, so it
serves small and medium collections; it doubles as a ground truth for
recall. No Pallas kernel is involved: the search is torch gathers and
multiply-adds on the device, in chunks of documents.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..data.sparse import PAD_COMPONENT, CsrDataset
from ..device import resolve_device

FLAT_SUFFIX = ".flat.seismic_tpu"

# f32 scores a chunk of the search may hold ([B, chunk] at once)
_CHUNK_ELEMS = 1 << 27


@dataclass
class FlatTermIndex:
    columns: np.ndarray  # uint8 [dim + 1, n_docs]; row `dim` is zeros
    doc_scale: np.ndarray  # f32 [n_docs]
    dim: int
    n_docs: int

    def __post_init__(self):
        self._device = {}  # torch.device -> (columns, doc_scale) tensors

    # ------------------------------------------------------------- build
    @staticmethod
    def build(dataset: CsrDataset) -> "FlatTermIndex":
        n, dim = len(dataset), dataset.dim
        docs = np.repeat(np.arange(n, dtype=np.int64), dataset.row_lengths())
        vals = dataset.values.astype(np.float32)
        # per-document max -> u8 scale
        mx = np.zeros(n, np.float32)
        np.maximum.at(mx, docs, vals)
        scale = np.where(mx > 0, mx / 255.0, 1.0).astype(np.float32)
        codes = np.clip(np.rint(vals / scale[docs]), 0, 255).astype(np.uint8)
        cols = np.zeros((dim + 1, n), dtype=np.uint8)
        cols[dataset.components.astype(np.int64), docs] = codes
        return FlatTermIndex(
            columns=cols,
            doc_scale=np.where(mx > 0, scale, 0.0).astype(np.float32),
            dim=dim, n_docs=n)

    # ------------------------------------------------------------ search
    def device_arrays(self, device=None):
        """(columns uint8, doc_scale f32) on `device` (None: "cuda"),
        uploaded on first use."""
        dev = resolve_device(device)
        if dev not in self._device:
            self._device[dev] = (torch.from_numpy(self.columns).to(dev),
                                 torch.from_numpy(self.doc_scale).to(dev))
        return self._device[dev]

    def search_batch(self, q_comps: np.ndarray, q_vals: np.ndarray, k: int,
                     device=None):
        """Exact top-k on `device` (None: "cuda"); NumPy in, NumPy out.
        q_comps / q_vals are padded [B, Q] arrays (PAD_COMPONENT / 0).
        Returns (scores f32 [B, k], -inf where no result; ids int64
        [B, k], -1 there); ties go to the smaller id, as `lax.top_k`."""
        cols, dscale = self.device_arrays(device)
        dev = cols.device
        qc = torch.from_numpy(np.ascontiguousarray(q_comps, np.int32)).to(dev)
        qv = torch.from_numpy(np.ascontiguousarray(q_vals, np.float32)).to(
            dev)
        scores, ids = flat_search(cols, dscale, qc, qv, k, self.dim)
        return scores.cpu().numpy(), ids.cpu().numpy()

    # --------------------------------------------------------- save/load
    def save(self, path: str) -> str:
        if not path.endswith(FLAT_SUFFIX):
            path = path + FLAT_SUFFIX
        meta = {"dim": self.dim, "n_docs": self.n_docs}
        np.savez(path, columns=self.columns, doc_scale=self.doc_scale,
                 __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8))
        if os.path.exists(path + ".npz"):
            os.replace(path + ".npz", path)
        return path

    @staticmethod
    def load(path: str) -> "FlatTermIndex":
        if not path.endswith(FLAT_SUFFIX) and os.path.exists(
                path + FLAT_SUFFIX):
            path = path + FLAT_SUFFIX
        with np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            return FlatTermIndex(columns=z["columns"],
                                 doc_scale=z["doc_scale"], dim=meta["dim"],
                                 n_docs=meta["n_docs"])


def flat_search(cols, dscale, q_comps, q_vals, k: int, dim: int):
    """The search on device tensors: cols uint8 [dim + 1, n_docs], dscale
    f32 [n_docs], q_comps int32 / q_vals f32 [B, Q]. Each chunk of
    documents accumulates `acc + qv_i * D[qc_i, chunk]` term by term in
    f32 (the JAX scan's order), then scales; the top-k keeps `lax.top_k`'s
    order (a stable descending sort). Returns (scores f32 [B, k], ids
    int64 [B, k]), -inf / -1 where the score is not positive."""
    B, Q = q_comps.shape
    n_docs = cols.shape[1]
    safe = q_comps.clamp(max=dim).long()  # PAD -> the zero row
    qv = torch.where(q_comps == int(PAD_COMPONENT), 0.0, q_vals)
    k_eff = min(k, n_docs)
    chunk = max(k_eff, _CHUNK_ELEMS // max(B, 1))
    best_s = best_i = None
    for c0 in range(0, n_docs, chunk):
        acc = torch.zeros((B, min(chunk, n_docs - c0)), dtype=torch.float32,
                          device=cols.device)
        for i in range(Q):
            rows = cols[safe[:, i], c0:c0 + chunk]  # [B, chunk] u8
            acc = acc + qv[:, i:i + 1] * rows.to(torch.float32)
        acc = acc * dscale[None, c0:c0 + chunk]
        s = torch.sort(acc, dim=1, descending=True, stable=True)
        top_s = s.values[:, :k_eff]
        top_i = s.indices[:, :k_eff] + c0
        if best_s is not None:
            # earlier chunks first: the stable sort keeps the smaller id
            # ahead among equal scores
            top_s = torch.cat([best_s, top_s], dim=1)
            top_i = torch.cat([best_i, top_i], dim=1)
            s = torch.sort(top_s, dim=1, descending=True, stable=True)
            top_s = s.values[:, :k_eff]
            top_i = torch.gather(top_i, 1, s.indices[:, :k_eff])
        best_s, best_i = top_s, top_i
    if k_eff < k:
        pad = (0, k - k_eff)
        best_s = torch.nn.functional.pad(best_s, pad, value=0.0)
        best_i = torch.nn.functional.pad(best_i, pad, value=-1)
    pos = best_s > 0
    return (torch.where(pos, best_s, -torch.inf),
            torch.where(pos, best_i, -1).to(torch.int64))
