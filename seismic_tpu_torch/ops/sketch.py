"""Signed CountSketch of sparse vectors: the host (NumPy) half.

The index builder sketches every block summary and document into a fixed
`sketch_dim`-wide dense space with a deterministic signed hash
(`seismic_tpu/ops/sketch.py` keeps the traceable half that sketches
queries inside the JAX search program; the engine path that consumes it
is a later slice of this package). Dot products are preserved in
expectation: E[<sk(q), sk(x)>] = <q, x>.
"""

from __future__ import annotations

import numpy as np


def _splitmix32_np(x: np.ndarray, seed: int) -> np.ndarray:
    x = x.astype(np.uint32) + np.uint32((seed * 0x9E3779B9) & 0xFFFFFFFF)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x85EBCA6B)
    x = (x ^ (x >> np.uint32(13))) * np.uint32(0xC2B2AE35)
    x = x ^ (x >> np.uint32(16))
    return x


def sketch_slots_np(components: np.ndarray, sketch_dim: int, seed: int):
    """(slot, sign) for each component id, NumPy version."""
    h = _splitmix32_np(np.asarray(components), seed)
    slot = (h % np.uint32(sketch_dim)).astype(np.int32)
    sign = np.where((h >> np.uint32(31)) & np.uint32(1), -1.0, 1.0).astype(
        np.float32
    )
    return slot, sign


def sketch_csr_np(
    offsets: np.ndarray,
    components: np.ndarray,
    values: np.ndarray,
    sketch_dim: int,
    seed: int,
) -> np.ndarray:
    """Sketch every CSR row -> [n_rows, sketch_dim] float32 (build time)."""
    n = len(offsets) - 1
    slot, sign = sketch_slots_np(components, sketch_dim, seed)
    row = np.repeat(np.arange(n, dtype=np.int64), np.diff(offsets))
    out = np.zeros((n, sketch_dim), dtype=np.float32)
    np.add.at(out, (row, slot.astype(np.int64)), sign * values.astype(np.float32))
    return out


def quantize_sketch_int8(sketches: np.ndarray):
    """Symmetric per-row int8 quantization -> (codes int8, scale f32[n])."""
    absmax = np.abs(sketches).max(axis=1)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    codes = np.clip(
        np.rint(sketches / scale[:, None]), -127, 127
    ).astype(np.int8)
    return codes, scale
