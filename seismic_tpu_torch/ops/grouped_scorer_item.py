"""Item-major grouped int8 doc-tile scorer (K4).

Counterpart of `seismic_tpu/ops/pallas_grouped.py::_score_grouped_i8_item`
(`_score_grouped_i8` with unroll > 1), in `csrc/grouped_scorer_item.cu`.
For each work item w, with g = work_g[w], ROWS = csub * 128 and tile rows
R0 = work_region[w] * ROWS:

    out[w, m, r] = f32(sum_v q[g, m, v] * u8[R0 + r, v]) * tile_scale[R0 + r]

The int32 dot is exact; the per-pair scale is applied in the regroup
(`search/grouped.py::_item_regroup`). Every item is written, padding items
included. `score_grouped_i8_item` launches the kernel for CUDA tensors and
uses the plain PyTorch version, `score_grouped_i8_item_plain`, for CPU
ones.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .grouped_scorer import grouped_dots_plain
from .tiles_prep import SUB

M_SLOTS = (8, 16)  # query slots per group the kernel serves
CSUBS = (1, 2)  # subtiles per work item the kernel serves
# kernel launches since the count was last set to 0
launches = 0
_handle = None


def score_grouped_i8_item_plain(tiles, tile_scale, q, work_region, work_g,
                                csub: int):
    """Plain PyTorch version (same products, same f32 multiply order)."""
    rows_per_item = csub * SUB
    dots = grouped_dots_plain(tiles, q, work_region, work_g,
                              rows_per_item=rows_per_item)  # [W, M, ROWS]
    rows = (work_region.long()[:, None] * rows_per_item
            + torch.arange(rows_per_item, device=tiles.device))
    return dots.to(torch.float32) * tile_scale[rows][:, None, :]


def _lib():
    global _handle
    if _handle is None:
        lib = _cuda.load("grouped_scorer_item")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.seismic_score_grouped_i8_item.argtypes = [
            p, p, p, p, p, i, i, i, i, p, p]
        lib.seismic_score_grouped_i8_item.restype = ctypes.c_int
        _handle = lib
    return _handle


def score_grouped_i8_item(tiles, tile_scale, q, work_region, work_g,
                          csub: int):
    """tiles uint8 [rows, V]; tile_scale f32 [rows]; q int8 [G_cap, M, V];
    work_region / work_g int32 [W_cap] (super-tile of csub * 128 rows,
    source group). Returns f32 [W_cap, M, csub * 128], item-major."""
    global launches
    req = _cuda.require
    req(tiles.dim() == 2 and tiles.dtype == torch.uint8,
        "tiles must be uint8 [rows, V]")
    req(tile_scale.shape == tiles.shape[:1]
        and tile_scale.dtype == torch.float32,
        "tile_scale must be f32 [rows]")
    req(q.dim() == 3 and q.dtype == torch.int8
        and q.shape[2] == tiles.shape[1], "q must be int8 [G_cap, M, V]")
    for t in (work_region, work_g):
        req(t.dim() == 1 and t.dtype == torch.int32
            and t.shape == work_region.shape,
            "work_region/work_g must be int32 [W_cap]")
    req(tiles.shape[0] % (csub * SUB) == 0,
        "tile rows must be a multiple of csub * 128")
    dev = tiles.device
    req(all(t.device == dev for t in (tile_scale, q, work_region, work_g)),
        "all operands must be on one device")
    if dev.type == "cpu":
        return score_grouped_i8_item_plain(tiles, tile_scale, q, work_region,
                                           work_g, csub)
    req(dev.type == "cuda", f"unsupported device {dev}")
    req(all(t.is_contiguous()
            for t in (tiles, tile_scale, q, work_region, work_g)),
        "operands must be contiguous")
    M, V = q.shape[1], tiles.shape[1]
    req(M in M_SLOTS, f"groups must have {M_SLOTS} slots, not {M}")
    req(csub in CSUBS, f"csub={csub} is not one of {CSUBS}")
    req(V in (256, 512, 1024), f"V={V} is not 256/512/1024")
    W_cap = work_region.shape[0]
    out = torch.empty((W_cap, M, csub * SUB), dtype=torch.float32,
                      device=dev)
    p = _cuda.ptr
    rc = _lib().seismic_score_grouped_i8_item(
        p(tiles), p(tile_scale), p(q), p(work_region), p(work_g), W_cap, V,
        M, csub, p(out), ctypes.c_void_p(_cuda.stream_handle(dev)))
    _cuda.check(rc, "score_grouped_i8_item")
    launches += 1
    return out
