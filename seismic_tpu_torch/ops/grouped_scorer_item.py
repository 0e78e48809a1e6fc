"""Item-major grouped int8 doc-tile scorer (K4).

Counterpart of `seismic_tpu/ops/pallas_grouped.py::_score_grouped_i8_item`
(`_score_grouped_i8` with unroll > 1), in `csrc/grouped_scorer_item.cu`.
For each work item w, with g = work_g[w], ROWS = csub * 128 and tile rows
R0 = work_region[w] * ROWS:

    out[w, m, r] = f32(sum_v q[g, m, v] * u8[R0 + r, v]) * tile_scale[R0 + r]

The int32 dot is exact; the per-pair scale is applied in the regroup
(`search/grouped.py::_item_regroup`). Every item is written, padding items
included. With `pack_window` >= 1 the block goes through the packed
epilogue (K5, `ops/pack_epilogue.py`), its rows counted from `work_s[w] *
ROWS`, and the output is int32 `[W_cap, M, ROWS // pack_window]`.
`score_grouped_i8_item` launches the kernel for CUDA tensors and uses the
plain PyTorch version, `score_grouped_i8_item_plain`, for CPU ones.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda, pack_epilogue
from .grouped_scorer import (
    check_shape,
    grouped_dots_plain,
    item_scores_plain,
)
from .tiles_prep import SUB

# kernel launches since the count was last set to 0
launches = 0
_handle = None


def score_grouped_i8_item_plain(tiles, tile_scale, q, work_region, work_g,
                                csub: int, work_s=None, ll_max: int = 0,
                                pack_window: int = 0):
    """Plain PyTorch version (same products, same f32 multiply order)."""
    vals = item_scores_plain(tiles, tile_scale, q, work_region, work_g, csub)
    if pack_window:
        vals = pack_epilogue.pack_window_plain(
            vals, work_s * (csub * SUB), ll_max, pack_window)
    return vals


def _lib():
    global _handle
    if _handle is None:
        lib = _cuda.load("grouped_scorer_item")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.seismic_score_grouped_i8_item.argtypes = [
            p, p, p, p, p, p, i, i, i, i, i, i, p, p]
        lib.seismic_score_grouped_i8_item.restype = ctypes.c_int
        lib.seismic_score_grouped_i8_item_max_v.argtypes = [i, i]
        lib.seismic_score_grouped_i8_item_max_v.restype = ctypes.c_int
        _handle = lib
    return _handle


def max_v(M: int, csub: int) -> int:
    """The widest V one chunk of the kernel holds at M query slots and
    csub (the library's `seismic_score_grouped_i8_item_max_v`); a wider V
    is walked in chunks."""
    return _lib().seismic_score_grouped_i8_item_max_v(M, csub)


def score_grouped_i8_item(tiles, tile_scale, q, work_region, work_g,
                          csub: int, work_s=None, ll_max: int = 0,
                          pack_window: int = 0):
    """tiles uint8 [rows, V]; tile_scale f32 [rows]; q int8 [G_cap, M, V];
    work_region / work_g int32 [W_cap] (super-tile of csub * 128 rows,
    source group). Returns f32 [W_cap, M, csub * 128], item-major; or, with
    pack_window >= 1 (then work_s int32 [W_cap], the item's super-tile slot
    in its group, and ll_max, the group's row capacity, are needed), int32
    [W_cap, M, csub * 128 // pack_window]."""
    global launches
    req = _cuda.require
    req(tiles.dim() == 2 and tiles.dtype == torch.uint8,
        "tiles must be uint8 [rows, V]")
    req(tile_scale.shape == tiles.shape[:1]
        and tile_scale.dtype == torch.float32,
        "tile_scale must be f32 [rows]")
    req(q.dim() == 3 and q.dtype == torch.int8
        and q.shape[2] == tiles.shape[1], "q must be int8 [G_cap, M, V]")
    works = (work_region, work_g) + ((work_s,) if pack_window else ())
    for t in works:
        req(t is not None and t.dim() == 1 and t.dtype == torch.int32
            and t.shape == work_region.shape,
            "work_region/work_g/work_s must be int32 [W_cap]")
    rows = csub * SUB
    req(tiles.shape[0] % rows == 0,
        "tile rows must be a multiple of csub * 128")
    step = pack_epilogue.check_pack_window(pack_window, rows)
    req(not pack_window or (ll_max > 0 and ll_max % rows == 0),
        "packed output needs ll_max, a multiple of csub * 128")
    dev = tiles.device
    req(all(t.device == dev for t in (tile_scale, q) + works),
        "all operands must be on one device")
    if dev.type == "cpu":
        return score_grouped_i8_item_plain(tiles, tile_scale, q, work_region,
                                           work_g, csub, work_s, ll_max,
                                           pack_window)
    req(dev.type == "cuda", f"unsupported device {dev}")
    req(all(t.is_contiguous() for t in (tiles, tile_scale, q) + works),
        "operands must be contiguous")
    M, V = q.shape[1], tiles.shape[1]
    check_shape(M, csub, V, "score_grouped_i8_item")
    W_cap = work_region.shape[0]
    out = torch.empty((W_cap, M, step),
                      dtype=torch.int32 if pack_window else torch.float32,
                      device=dev)
    p = _cuda.ptr
    rc = _lib().seismic_score_grouped_i8_item(
        p(tiles), p(tile_scale), p(q), p(work_region), p(work_g),
        p(work_s) if pack_window else None, W_cap, V, M, csub,
        pack_epilogue.idx_mask(ll_max) if pack_window else 0, pack_window,
        p(out), ctypes.c_void_p(_cuda.stream_handle(dev)))
    _cuda.check(rc, "score_grouped_i8_item")
    launches += 1
    if pack_window:
        pack_epilogue.count_launch()
    return out
