"""Per-(query, list) pair doc-tile scorer of the engine path (K7).

Counterpart of `seismic_tpu/ops/pallas_tiles.py::score_tiles_pallas`
(`csrc/tiles_scorer.cu`). For pair p whose list's region starts at subtile
s_p = region_start[p] (128-row units of the aligned layout) and row
r < ll_pad:

    out[p, r] = tile_scale[s_p*128 + r]
                * sum_v f32(tiles[s_p*128 + r, v]) * qloc[p, v]

for the rows of the 128-row subtiles that hold some of the list's
pair_len[p] rows, and 0 for the subtiles past them, which are not read
(the TPU kernel streams all `ll_pad` rows of every pair; its caller masks
the rows past the length, as this one's does). It reads the port's flat
`[rows]` scale and takes any number of pairs (the TPU kernel's
`[*, 8, 128]` scale blocks and its 8-pair groups were Mosaic rules), and
any V, as JAX's kernel asserts no width: rows that are not 16-byte
aligned load without cp.async.
`score_tiles` launches the kernel for CUDA tensors and uses the plain
PyTorch version, `score_tiles_plain`, for CPU tensors. On the card it
first groups the pairs by list (`group_pairs_by_region`), so that the
kernel reads and converts each subtile once for all the pairs of a group.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _cuda
from .tiles_prep import SUB

# kernel launches since the count was last set to 0
launches = 0
_handle = None
# u8 tile elements the plain version gathers at once (its f32 copy is 4x)
_PLAIN_ELEMS = 1 << 28
# pairs a group holds at most (the kernel's kM): the engine cell's 57,344
# pairs fall on 17,717 lists, 3.2 a list, half of the lists with one pair;
# 16 cuts the long runs (list 0 holds every unselected slot) into fewer
# groups than 8 does (18,702 against 20,329) and so fewer subtile reads
GROUP_PAIRS = 16


class PairGroups(NamedTuple):
    """Pairs grouped by list: group g (g < count[0]) holds the pairs
    `order[first[g]:first[g + 1]]`, at most M, all with the region start
    `region[first[g]]`, in their input order; `first` is P from
    `first[count[0]]` on."""

    order: torch.Tensor   # int64 [P], the pairs stably sorted by region
    region: torch.Tensor  # int32 [P], their region starts in that order
    first: torch.Tensor   # int64 [P + 1]
    count: torch.Tensor   # int64 [1]


def group_pairs_by_region(region_start, M: int = GROUP_PAIRS):
    """Group the pairs of `region_start` int32 [P] (P > 0) into runs of at
    most M pairs of one list, on the tensors' device and without a host
    synchronisation: a stable sort by region_start, cut at every change of
    region and every M pairs of a run. A group spans the subtiles up to
    the largest pair_len of its pairs, and each pair keeps its own (the
    kernel reads both from pair_len). Few operations, since on the card
    each is a launch from the host."""
    P = region_start.numel()
    rs, order = torch.sort(region_start, stable=True)
    idx = torch.arange(P, device=rs.device)
    # a group starts where a pair's place in its run is a multiple of M
    starts = (idx - torch.searchsorted(rs, rs)) % M == 0
    rank = torch.cumsum(starts, 0)  # 1 + the pair's group
    # every group's first place lands at its number; the rest at P + 1
    first = torch.full((P + 2,), P, dtype=torch.int64,
                       device=rs.device).index_put_(
        (torch.where(starts, rank - 1, P + 1),), idx)
    return PairGroups(order, rs, first[:P + 1], rank[-1:])


def score_tiles_plain(tiles, tile_scale, region_start, qloc, pair_len,
                      ll_pad: int):
    """Plain PyTorch version: per 128-row subtile, gather the pairs' tile
    rows, one f32 batched product, the row scale, and 0 on the subtiles
    past `pair_len` (pairs in chunks, to bound the gathered copy)."""
    P, V = qloc.shape
    out = torch.zeros((P, ll_pad), dtype=torch.float32, device=qloc.device)
    rows = torch.arange(SUB, device=qloc.device)
    step = max(1, _PLAIN_ELEMS // (SUB * V))
    for s in range(ll_pad // SUB):
        for p0 in range(0, P, step):
            sl = slice(p0, p0 + step)
            idx = (region_start[sl].long()[:, None] + s) * SUB + rows
            t = tiles[idx].to(torch.float32)  # [p, SUB, V]
            sc = torch.bmm(t, qloc[sl, :, None])[..., 0] * tile_scale[idx]
            out[sl, s * SUB:(s + 1) * SUB] = torch.where(
                (pair_len[sl] > s * SUB)[:, None], sc, 0.0)
    return out


def _lib():
    global _handle
    if _handle is None:
        lib = _cuda.load("tiles_scorer")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.seismic_score_tiles.argtypes = [p, p, p, p, p, p, p, p, p, i, i,
                                            i, p, p]
        lib.seismic_score_tiles.restype = ctypes.c_int
        lib.seismic_score_tiles_group_pairs.restype = ctypes.c_int
        _handle = lib
    return _handle


def score_tiles(tiles, tile_scale, region_start, qloc, pair_len,
                ll_pad: int):
    """tiles uint8 [rows, V] and tile_scale f32 [rows], the aligned layout
    (every region readable `ll_pad` rows deep); region_start int32 [P] in
    128-row subtiles; qloc f32 [P, V]; pair_len int32 [P], each pair's
    list length; `ll_pad` a multiple of 128. Returns f32 [P, ll_pad], not
    masked to the lists' lengths.

    The 128-row subtiles that start at or past `pair_len[p]` are not read
    and score 0, in the kernel and in the plain version alike; the rows
    past the length inside the last subtile are scored like any other
    (`pair_len = ll_pad` scores every row). The caller masks every row
    past the length."""
    global launches
    req = _cuda.require
    req(tiles.dim() == 2 and tiles.dtype == torch.uint8,
        "tiles must be uint8 [rows, V]")
    req(tile_scale.dtype == torch.float32
        and tile_scale.shape == tiles.shape[:1],
        "tile_scale must be f32 [rows]")
    req(region_start.dim() == 1 and region_start.dtype == torch.int32,
        "region_start must be int32 [P]")
    req(qloc.dim() == 2 and qloc.dtype == torch.float32
        and qloc.shape == (region_start.shape[0], tiles.shape[1]),
        "qloc must be f32 [P, V]")
    req(pair_len.dtype == torch.int32
        and pair_len.shape == region_start.shape,
        "pair_len must be int32 [P]")
    req(ll_pad > 0 and ll_pad % SUB == 0,
        f"ll_pad={ll_pad} must be a positive multiple of {SUB}")
    operands = (tiles, tile_scale, region_start, qloc, pair_len)
    dev = tiles.device
    req(all(t.device == dev for t in operands),
        "all operands must be on one device")
    if dev.type == "cpu":
        return score_tiles_plain(*operands, ll_pad)
    req(dev.type == "cuda", f"unsupported device {dev}")
    req(all(t.is_contiguous() for t in operands),
        "operands must be contiguous")
    lib = _lib()
    P, V = qloc.shape
    out = torch.zeros((P, ll_pad), dtype=torch.float32, device=dev)
    if P == 0 or V == 0:  # no pairs, or sums over no column: all 0
        return out
    g = group_pairs_by_region(region_start,
                              lib.seismic_score_tiles_group_pairs())
    next_group = torch.zeros(1, dtype=torch.int32, device=dev)
    p = _cuda.ptr
    rc = lib.seismic_score_tiles(
        p(tiles), p(tile_scale), p(qloc), p(pair_len), *(p(t) for t in g),
        p(next_group), P, V, ll_pad // SUB, p(out),
        ctypes.c_void_p(_cuda.stream_handle(dev)))
    _cuda.check(rc, "score_tiles")
    launches += 1
    return out
