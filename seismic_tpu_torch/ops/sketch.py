"""Signed CountSketch of sparse vectors.

The index builder sketches every block summary and document into a fixed
`sketch_dim`-wide dense space with a deterministic signed hash (the NumPy
half); the engine sketches its queries on the device with the same hash
(the torch half, `sketch_slots_torch` / `sketch_padded_queries`, the
counterparts of `seismic_tpu/ops/sketch.py:34-108`), for
`block_mode="sketch"` and `cand_budget > 0`. Dot products are preserved
in expectation: E[<sk(q), sk(x)>] = <q, x>. A test pins the two hashes
equal bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def _splitmix32_np(x: np.ndarray, seed: int) -> np.ndarray:
    x = x.astype(np.uint32) + np.uint32((seed * 0x9E3779B9) & 0xFFFFFFFF)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x85EBCA6B)
    x = (x ^ (x >> np.uint32(13))) * np.uint32(0xC2B2AE35)
    x = x ^ (x >> np.uint32(16))
    return x


def _mul32(x, c: int):
    """(x * c) mod 2^32 for int64 x in [0, 2^32): the product taken in
    16-bit halves, so no int64 intermediate overflows."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _splitmix32_torch(x, seed: int):
    """`_splitmix32_np` on a torch integer tensor: uint32 arithmetic held
    in int64 and masked to 32 bits after every add and multiply."""
    x = ((x.to(torch.int64) & _M32)
         + ((seed * 0x9E3779B9) & _M32)) & _M32
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    return x ^ (x >> 16)


def sketch_slots_torch(components, sketch_dim: int, seed: int):
    """(slot int64, sign f32) for each component id, on the ids' device;
    equal to `sketch_slots_np`."""
    h = _splitmix32_torch(components, seed)
    slot = h % sketch_dim
    sign = torch.where(((h >> 31) & 1) == 1, -1.0, 1.0)
    return slot, sign.to(torch.float32)


def sketch_padded_queries(q_comps, q_vals, sketch_dim: int, seed: int):
    """Sketch a padded query batch: q_comps int32 / q_vals f32 [B, Q], 0
    at padding -> [B, sketch_dim] f32. The JAX package sums one-hot rows
    in a product; `scatter_add_` sums the same terms into their slots in
    another order (agreement to f32 rounding, 1e-6 relative)."""
    slot, sign = sketch_slots_torch(q_comps, sketch_dim, seed)
    out = torch.zeros((q_comps.shape[0], sketch_dim), dtype=torch.float32,
                      device=q_comps.device)
    return out.scatter_add_(1, slot, sign * q_vals.to(torch.float32))


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
