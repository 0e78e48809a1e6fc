"""Host-side CSR sparse dataset.

TPU-native replacement for the `vectorium` SparseDataset family the reference
builds on (see use sites in reference src/inverted_index.rs:7-15 and
src/index_traits.rs). Storage is the classic CSR triple
(offsets, components, values) in NumPy, with per-document components kept
sorted — exactly the invariant the reference enforces on ingestion
(src/inverted_index_wrapper.rs:465) and on queries
(src/inverted_index.rs:171-175).

The device-side view is a padded fixed-width tile `[n_docs, width]` produced
by :meth:`CsrDataset.padded_tiles`, which is what the search kernels consume.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np

# Sentinel component id used in padded tiles. Scoring paths treat it as
# "matches nothing": it is >= any real component id and query tables are
# extended with a zero slot for it.
PAD_COMPONENT = np.int32(2**31 - 1)


def _as_f32(values) -> np.ndarray:
    return np.asarray(values, dtype=np.float32)


@dataclass
class CsrDataset:
    """Immutable CSR sparse dataset (components sorted within each row)."""

    offsets: np.ndarray  # int64 [n_docs + 1]
    components: np.ndarray  # int32 [nnz]
    values: np.ndarray  # float32/float16 [nnz]
    dim: int  # input dimensionality (max component id + 1 or larger)

    # ----------------------------------------------------------- accessors
    def __len__(self) -> int:
        return len(self.offsets) - 1

    @property
    def nnz(self) -> int:
        return int(self.offsets[-1])

    @property
    def input_dim(self) -> int:
        return self.dim

    def row_lengths(self) -> np.ndarray:
        return np.diff(self.offsets).astype(np.int64)

    def get(self, doc_id: int) -> Tuple[np.ndarray, np.ndarray]:
        s, e = int(self.offsets[doc_id]), int(self.offsets[doc_id + 1])
        return self.components[s:e], self.values[s:e]

    def iter_rows(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for i in range(len(self)):
            yield self.get(i)

    # ------------------------------------------------------- constructors
    @staticmethod
    def from_rows(
        rows: Iterable[Tuple[Sequence[int], Sequence[float]]],
        dim: Optional[int] = None,
        value_dtype=np.float32,
    ) -> "CsrDataset":
        """Build from an iterable of (components, values) pairs.

        Components are sorted per row; duplicate components within a row are
        not allowed (matching the reference JSONL semantics).
        """
        comps_list, vals_list, lengths = [], [], [0]
        max_comp = -1
        for comps, vals in rows:
            c = np.asarray(comps, dtype=np.int64)
            v = _as_f32(vals)
            if len(c) != len(v):
                raise ValueError("components/values length mismatch")
            if len(c):
                order = np.argsort(c, kind="stable")
                c, v = c[order], v[order]
                if np.any(c[1:] == c[:-1]):
                    raise ValueError("duplicate components within a document")
                max_comp = max(max_comp, int(c[-1]))
            comps_list.append(c.astype(np.int32))
            vals_list.append(v.astype(value_dtype))
            lengths.append(lengths[-1] + len(c))
        offsets = np.asarray(lengths, dtype=np.int64)
        components = (
            np.concatenate(comps_list) if comps_list else np.zeros(0, np.int32)
        )
        values = (
            np.concatenate(vals_list) if vals_list else np.zeros(0, value_dtype)
        )
        if dim is None:
            dim = max_comp + 1
        elif max_comp >= dim:
            raise ValueError(f"component id {max_comp} >= dim {dim}")
        return CsrDataset(offsets, components, values, int(dim))

    @staticmethod
    def from_arrays(
        offsets: np.ndarray,
        components: np.ndarray,
        values: np.ndarray,
        dim: Optional[int] = None,
        sort_rows: bool = False,
    ) -> "CsrDataset":
        offsets = np.asarray(offsets, dtype=np.int64)
        components = np.asarray(components, dtype=np.int32)
        values = np.asarray(values)
        if sort_rows:
            components = components.copy()
            values = values.copy()
            for i in range(len(offsets) - 1):
                s, e = int(offsets[i]), int(offsets[i + 1])
                order = np.argsort(components[s:e], kind="stable")
                components[s:e] = components[s:e][order]
                values[s:e] = values[s:e][order]
        if dim is None:
            dim = int(components.max()) + 1 if len(components) else 0
        return CsrDataset(offsets, components, values, int(dim))

    # -------------------------------------------------------- conversions
    def astype(self, value_dtype) -> "CsrDataset":
        """Re-encode values in another dtype (the reference's dataset
        conversion, src/inverted_index.rs:237-284, minus offset remapping —
        our offsets are dtype-independent so posting lists stay valid)."""
        return CsrDataset(
            self.offsets, self.components, self.values.astype(value_dtype), self.dim
        )

    def to_dense(self) -> np.ndarray:
        out = np.zeros((len(self), self.dim), dtype=np.float32)
        doc_idx = np.repeat(
            np.arange(len(self), dtype=np.int64), self.row_lengths()
        )
        out[doc_idx, self.components.astype(np.int64)] = self.values.astype(
            np.float32
        )
        return out

    def padded_tiles(
        self, width: int, keep: str = "largest"
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Return `[n_docs, width]` (components int32, values float32) tiles.

        Rows longer than `width` keep their `width` largest-value components
        (keep="largest") or their first `width` (keep="head"). Padding slots
        hold PAD_COMPONENT / 0.0. Component order within each row stays
        sorted ascending.
        """
        n = len(self)
        comps = np.full((n, width), PAD_COMPONENT, dtype=np.int32)
        vals = np.zeros((n, width), dtype=np.float32)
        lengths = self.row_lengths()
        for i in range(n):
            s = int(self.offsets[i])
            l = int(lengths[i])
            c = self.components[s : s + l]
            v = self.values[s : s + l].astype(np.float32)
            if l > width:
                if keep == "largest":
                    top = np.argpartition(v, l - width)[l - width :]
                    top.sort()
                    c, v = c[top], v[top]
                else:
                    c, v = c[:width], v[:width]
                l = width
            comps[i, :l] = c
            vals[i, :l] = v
        return comps, vals

    # ----------------------------------------------------------- utility
    def subset(self, doc_ids: np.ndarray) -> "CsrDataset":
        doc_ids = np.asarray(doc_ids, dtype=np.int64)
        lengths = self.row_lengths()[doc_ids]
        new_offsets = np.zeros(len(doc_ids) + 1, dtype=np.int64)
        np.cumsum(lengths, out=new_offsets[1:])
        comps = np.empty(int(new_offsets[-1]), dtype=np.int32)
        vals = np.empty(int(new_offsets[-1]), dtype=self.values.dtype)
        for j, d in enumerate(doc_ids):
            s, e = int(self.offsets[d]), int(self.offsets[d + 1])
            comps[new_offsets[j] : new_offsets[j + 1]] = self.components[s:e]
            vals[new_offsets[j] : new_offsets[j + 1]] = self.values[s:e]
        return CsrDataset(new_offsets, comps, vals, self.dim)

    def space_usage_bytes(self) -> int:
        return (
            self.offsets.nbytes + self.components.nbytes + self.values.nbytes
        )


class GrowableCsrDataset:
    """Append-only dataset used for ingestion and the `SeismicDataset` API
    (reference: SparseDatasetGrowable use in inverted_index_wrapper.rs:599-758).
    """

    def __init__(self, dim: int = 0, value_dtype=np.float32):
        self._rows: list[tuple[np.ndarray, np.ndarray]] = []
        self._dim = dim
        self._nnz = 0
        self._value_dtype = value_dtype

    def __len__(self) -> int:
        return len(self._rows)

    @property
    def dim(self) -> int:
        return self._dim

    @property
    def nnz(self) -> int:
        return self._nnz

    def push(self, components, values) -> None:
        c = np.asarray(components, dtype=np.int64)
        v = _as_f32(values)
        if len(c):
            order = np.argsort(c, kind="stable")
            c, v = c[order], v[order]
            if np.any(c[1:] == c[:-1]):
                raise ValueError("duplicate components within a document")
            self._dim = max(self._dim, int(c[-1]) + 1)
        self._rows.append((c.astype(np.int32), v.astype(self._value_dtype)))
        self._nnz += len(c)

    def get(self, doc_id: int) -> Tuple[np.ndarray, np.ndarray]:
        return self._rows[doc_id]

    def freeze(self) -> CsrDataset:
        return CsrDataset.from_rows(
            self._rows, dim=self._dim, value_dtype=self._value_dtype
        )


def pad_queries(
    q_comps_list, q_vals_list, q_pad: int = 128
) -> tuple[np.ndarray, np.ndarray]:
    """Pack ragged queries into [B, q_pad] padded arrays (components sorted;
    longer queries keep their q_pad largest values)."""
    B = len(q_comps_list)
    comps = np.full((B, q_pad), PAD_COMPONENT, dtype=np.int32)
    vals = np.zeros((B, q_pad), dtype=np.float32)
    for i, (c, v) in enumerate(zip(q_comps_list, q_vals_list)):
        c = np.asarray(c, dtype=np.int64)
        v = np.asarray(v, dtype=np.float32)
        if len(c) > q_pad:
            top = np.argpartition(-v, q_pad)[:q_pad]
            c, v = c[top], v[top]
        order = np.argsort(c, kind="stable")
        c, v = c[order], v[order]
        comps[i, : len(c)] = c
        vals[i, : len(c)] = v
    return comps, vals
