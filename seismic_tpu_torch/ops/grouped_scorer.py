"""Slot-major grouped int8 doc-tile scorer (K2).

Counterpart of `seismic_tpu/ops/pallas_grouped.py::_score_grouped_i8`
with unroll = 1 (`csrc/grouped_scorer.cu`). For each work item w, with
g = work_g[w], s = work_s[w], ROWS = csub * 128 and tile rows
R0 = work_region[w] * ROWS:

    out[g, m, s*ROWS + r] = f32(sum_v q[g, m, v] * u8[R0 + r, v])
                            * tile_scale[R0 + r]

The int32 dot is exact; the per-pair scale is applied in the regroup.
With `pack_window` >= 1 the block goes through the packed epilogue (K5,
`ops/pack_epilogue.py`) and the output is int32 `[G_cap, M, ll_max //
pack_window]`. Output blocks no work item covers are left uninitialized
(the caller masks them). `score_grouped_i8` launches the kernel for CUDA
tensors and uses the plain PyTorch version, `score_grouped_i8_plain`, for
CPU ones.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda, pack_epilogue
from .tiles_prep import SUB

# The shape rule of the three grouped scorers (K2, K4, K6), JAX's
# (`pallas_grouped.py:76`): M query slots a group a multiple of 8, V a
# multiple of 128, any csub >= 1 with ll_max % (csub * 128) == 0. The
# kernels' instances hold up to 32 slots, 4 subtiles and the V their
# shared memory leaves (`max_v`); wider shapes run as chunks of them
# (`csrc/grouped_i8_mma.cuh`).
V_ALIGN = 128
# kernel launches since the count was last set to 0
launches = 0
_handle = None


def max_v(M: int, csub: int) -> int:
    """The widest V one chunk of the kernel holds at M query slots and
    csub (the library's `seismic_score_grouped_i8_max_v`; builds it if
    needed); a wider V is walked in chunks."""
    return _lib().seismic_score_grouped_i8_max_v(M, csub)


def check_shape(M: int, csub: int, V: int, what: str) -> None:
    """Raise ValueError unless (M, csub, V) keeps JAX's rule: M % 8 == 0,
    csub >= 1, V % 128 == 0, as `score_grouped_pallas` asserts."""
    _cuda.require(
        M % 8 == 0 and M >= 0 and csub >= 1 and V % V_ALIGN == 0,
        f"{what}: M={M}, csub={csub}, V={V} breaks the kernels' rule (JAX's):"
        f" M a multiple of 8, csub >= 1, V a multiple of {V_ALIGN}")


def grouped_dots_plain(tiles, q, work_region, work_g, chunk: int = 256,
                       rows_per_item: int = SUB):
    """Exact int dots [W, M, rows_per_item] (int64) of every work item
    (tile rows work_region[w] * rows_per_item onwards), computed in
    float64 (exact: |dot| < 2^53) in chunks of `chunk` items."""
    W = work_region.shape[0]
    M = q.shape[1]
    R = rows_per_item
    dev = tiles.device
    offs = torch.arange(R, device=dev)
    out = torch.empty((W, M, R), dtype=torch.int64, device=dev)
    for w0 in range(0, W, chunk):
        w1 = min(W, w0 + chunk)
        rows = work_region[w0:w1].long()[:, None] * R + offs  # [n, R]
        t = tiles[rows].to(torch.float64)  # [n, SUB, V]
        qq = q[work_g[w0:w1].long()].to(torch.float64)  # [n, M, V]
        out[w0:w1] = torch.bmm(qq, t.transpose(1, 2)).round().to(torch.int64)
    return out


def item_scores_plain(tiles, tile_scale, q, work_region, work_g, csub: int):
    """f32 [W, M, csub * 128]: every work item's scaled scores (the same
    products and the same f32 multiply order as the kernels)."""
    rows_per_item = csub * SUB
    dots = grouped_dots_plain(tiles, q, work_region, work_g,
                              rows_per_item=rows_per_item)
    rows = (work_region.long()[:, None] * rows_per_item
            + torch.arange(rows_per_item, device=tiles.device))
    return dots.to(torch.float32) * tile_scale[rows][:, None, :]


def score_grouped_i8_plain(tiles, tile_scale, q, work_region, work_g,
                           work_s, ll_max: int, csub: int = 1,
                           pack_window: int = 0):
    """Plain PyTorch version (same products, same f32 multiply order)."""
    vals = item_scores_plain(tiles, tile_scale, q, work_region, work_g, csub)
    return pack_epilogue.slot_major_plain(vals, work_g, work_s, q.shape[0],
                                          ll_max, pack_window)


def _lib():
    global _handle
    if _handle is None:
        lib = _cuda.load("grouped_scorer")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.seismic_score_grouped_i8.argtypes = [
            p, p, p, p, p, p, i, i, i, i, i, i, i, p, p]
        lib.seismic_score_grouped_i8.restype = ctypes.c_int
        lib.seismic_score_grouped_i8_max_v.argtypes = [i, i]
        lib.seismic_score_grouped_i8_max_v.restype = ctypes.c_int
        _handle = lib
    return _handle


def score_grouped_i8(tiles, tile_scale, q, work_region, work_g, work_s,
                     ll_max: int, csub: int = 1, pack_window: int = 0):
    """tiles uint8 [rows, V]; tile_scale f32 [rows]; q int8 [G_cap, M, V];
    work_region / work_g / work_s int32 [W_cap] (super-tile of csub * 128
    rows, destination group, super-tile slot). Returns f32 [G_cap, M,
    ll_max], or with pack_window >= 1 int32 [G_cap, M, ll_max //
    pack_window]."""
    global launches
    req = _cuda.require
    req(tiles.dim() == 2 and tiles.dtype == torch.uint8,
        "tiles must be uint8 [rows, V]")
    req(tile_scale.shape == tiles.shape[:1]
        and tile_scale.dtype == torch.float32,
        "tile_scale must be f32 [rows]")
    req(q.dim() == 3 and q.dtype == torch.int8
        and q.shape[2] == tiles.shape[1], "q must be int8 [G_cap, M, V]")
    for t in (work_region, work_g, work_s):
        req(t.dim() == 1 and t.dtype == torch.int32
            and t.shape == work_region.shape,
            "work_region/work_g/work_s must be int32 [W_cap]")
    rows = csub * SUB
    req(ll_max % rows == 0, "ll_max must be a multiple of csub * 128")
    req(tiles.shape[0] % rows == 0,
        "tile rows must be a multiple of csub * 128")
    pack_epilogue.check_pack_window(pack_window, rows)
    dev = tiles.device
    req(all(t.device == dev
            for t in (tile_scale, q, work_region, work_g, work_s)),
        "all operands must be on one device")
    if dev.type == "cpu":
        return score_grouped_i8_plain(tiles, tile_scale, q, work_region,
                                      work_g, work_s, ll_max, csub,
                                      pack_window)
    req(dev.type == "cuda", f"unsupported device {dev}")
    req(all(t.is_contiguous()
            for t in (tiles, tile_scale, q, work_region, work_g, work_s)),
        "operands must be contiguous")
    G_cap, M, V = q.shape
    check_shape(M, csub, V, "score_grouped_i8")
    out = torch.empty(
        (G_cap, M, ll_max // pack_window if pack_window else ll_max),
        dtype=torch.int32 if pack_window else torch.float32, device=dev)
    p = _cuda.ptr
    rc = _lib().seismic_score_grouped_i8(
        p(tiles), p(tile_scale), p(q), p(work_region), p(work_g),
        p(work_s), work_region.shape[0], V, M, csub, ll_max,
        pack_epilogue.idx_mask(ll_max), pack_window, p(out),
        ctypes.c_void_p(_cuda.stream_handle(dev)))
    _cuda.check(rc, "score_grouped_i8")
    launches += 1
    if pack_window:
        pack_epilogue.count_launch()
    return out
