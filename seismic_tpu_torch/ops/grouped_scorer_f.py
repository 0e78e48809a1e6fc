"""Slot-major grouped doc-tile scorer with bf16 or f32 query operands (K6).

Counterpart of `seismic_tpu/ops/pallas_grouped.py::score_grouped_pallas`
with `compute_dtype` "bf16" or "f32" (`csrc/grouped_scorer_f.cu`). For each
work item w, with g = work_g[w], s = work_s[w], ROWS = csub * 128 and tile
rows R0 = work_region[w] * ROWS, and qc = the f32 projection q rounded to
bf16 (nearest even) in bf16 mode, q itself in f32 mode:

    centred (qsum given, as the search program always does):
        out[g, m, s*ROWS + r] = (sum_v qc[g, m, v] * (u8[R0 + r, v] - 128)
                                 + qsum[g, m]) * tile_scale[R0 + r]
    fixup (qsum None):
        out[g, m, s*ROWS + r] = (sum_v qc[g, m, v] * u8[R0 + r, v])
                                * tile_scale[R0 + r]

Products and sums are f32 (a bf16 value times an integer below 256 is exact
in f32). The kernel multiplies on the bf16 tensor cores: in bf16 mode the
rounded queries, in f32 mode the three bf16 terms of `split_bf16x3`, whose
sum is q exactly, so in both only the order of the f32 sum differs from the
plain version. The caller computes `qsum = 128 * sum_v q` from the UNROUNDED
projection, so the centred form differs from `qc . u8` in bf16 mode, as in
the JAX program. With `pack_window` >= 1 the block goes through the packed
epilogue (K5, `ops/pack_epilogue.py`). Output blocks no work item covers are
left uninitialized. `score_grouped_f` launches the kernel for CUDA tensors
and uses the plain PyTorch version, `score_grouped_f_plain`, for CPU ones.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda, grouped_scorer, pack_epilogue
from .tiles_prep import SUB

COMPUTE_DTYPES = ("bf16", "f32")
# kernel launches since the count was last set to 0
launches = 0
_handle = None


def item_scores_f_plain(tiles, tile_scale, q, qsum, work_region, work_g,
                        csub: int, compute_dtype: str, chunk: int = 256):
    """f32 [W, M, csub * 128]: every work item's scaled scores, by an f32
    matrix product of the (bf16-rounded) queries with the recentred tile
    rows, in chunks of `chunk` items."""
    W = work_region.shape[0]
    M = q.shape[1]
    R = csub * SUB
    dev = tiles.device
    offs = torch.arange(R, device=dev)
    off = 128.0 if qsum is not None else 0.0
    out = torch.empty((W, M, R), dtype=torch.float32, device=dev)
    for w0 in range(0, W, chunk):
        w1 = min(W, w0 + chunk)
        g = work_g[w0:w1].long()
        rows = work_region[w0:w1].long()[:, None] * R + offs  # [n, R]
        t = tiles[rows].to(torch.float32) - off  # [n, R, V]
        qq = q[g]  # [n, M, V]
        if compute_dtype == "bf16":
            qq = qq.to(torch.bfloat16).to(torch.float32)
        s = torch.bmm(qq, t.transpose(1, 2))
        if qsum is not None:
            s = s + qsum[g][:, :, None]
        out[w0:w1] = s * tile_scale[rows][:, None, :]
    return out


def split_bf16x3(q):
    """(hi, mid, lo), bf16 tensors of q's shape: hi = bf16(q), mid =
    bf16(q - hi), lo = bf16(q - hi - mid), each rounded to nearest even,
    the remainders exact in f32; hi + mid + lo == q for f32 q in bf16's
    range. The query operand of the kernel's f32 mode (the tests hold it
    to that; the plain version multiplies q itself)."""
    hi = q.to(torch.bfloat16)
    r = q - hi.to(torch.float32)
    mid = r.to(torch.bfloat16)
    lo = (r - mid.to(torch.float32)).to(torch.bfloat16)
    return hi, mid, lo


def score_grouped_f_plain(tiles, tile_scale, q, qsum, work_region, work_g,
                          work_s, ll_max: int, csub: int = 1,
                          compute_dtype: str = "bf16", pack_window: int = 0):
    """Plain PyTorch version (same operands and roundings; the order of the
    f32 sum differs)."""
    vals = item_scores_f_plain(tiles, tile_scale, q, qsum, work_region,
                               work_g, csub, compute_dtype)
    return pack_epilogue.slot_major_plain(vals, work_g, work_s, q.shape[0],
                                          ll_max, pack_window)


def _lib():
    global _handle
    if _handle is None:
        lib = _cuda.load("grouped_scorer_f")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.seismic_score_grouped_f.argtypes = [
            p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p, p]
        lib.seismic_score_grouped_f.restype = ctypes.c_int
        lib.seismic_score_grouped_f_max_v.argtypes = [i, i, i]
        lib.seismic_score_grouped_f_max_v.restype = ctypes.c_int
        _handle = lib
    return _handle


def max_v(M: int, csub: int, compute_dtype: str) -> int:
    """The widest V one chunk of the kernel holds (its shared memory
    holds the warps' rings and the group's bf16 queries, three terms of
    them in f32 mode); a wider V is walked in chunks. Builds the kernel
    library if needed."""
    return _lib().seismic_score_grouped_f_max_v(
        M, csub, int(compute_dtype == "bf16"))


def score_grouped_f(tiles, tile_scale, q, qsum, work_region, work_g, work_s,
                    ll_max: int, csub: int = 1, compute_dtype: str = "bf16",
                    pack_window: int = 0):
    """tiles uint8 [rows, V]; tile_scale f32 [rows]; q f32 [G_cap, M, V];
    qsum f32 [G_cap, M] (128 * sum_v q) or None; work_region / work_g /
    work_s int32 [W_cap]. Returns f32 [G_cap, M, ll_max], or with
    pack_window >= 1 int32 [G_cap, M, ll_max // pack_window]."""
    global launches
    req = _cuda.require
    req(compute_dtype in COMPUTE_DTYPES,
        f"compute_dtype={compute_dtype!r} is not one of {COMPUTE_DTYPES}")
    req(tiles.dim() == 2 and tiles.dtype == torch.uint8,
        "tiles must be uint8 [rows, V]")
    req(tile_scale.shape == tiles.shape[:1]
        and tile_scale.dtype == torch.float32,
        "tile_scale must be f32 [rows]")
    req(q.dim() == 3 and q.dtype == torch.float32
        and q.shape[2] == tiles.shape[1], "q must be f32 [G_cap, M, V]")
    req(qsum is None or (qsum.shape == q.shape[:2]
                         and qsum.dtype == torch.float32),
        "qsum must be f32 [G_cap, M]")
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
    operands = (tile_scale, q, work_region, work_g, work_s) + (
        () if qsum is None else (qsum,))
    req(all(t.device == dev for t in operands),
        "all operands must be on one device")
    if dev.type == "cpu":
        return score_grouped_f_plain(tiles, tile_scale, q, qsum, work_region,
                                     work_g, work_s, ll_max, csub,
                                     compute_dtype, pack_window)
    req(dev.type == "cuda", f"unsupported device {dev}")
    req(tiles.is_contiguous() and all(t.is_contiguous() for t in operands),
        "operands must be contiguous")
    G_cap, M, V = q.shape
    grouped_scorer.check_shape(M, csub, V, "score_grouped_f")
    out = torch.empty(
        (G_cap, M, ll_max // pack_window if pack_window else ll_max),
        dtype=torch.int32 if pack_window else torch.float32, device=dev)
    p = _cuda.ptr
    rc = _lib().seismic_score_grouped_f(
        p(tiles), p(tile_scale), p(q), None if qsum is None else p(qsum),
        p(work_region), p(work_g), p(work_s), work_region.shape[0], V, M,
        csub, ll_max, int(compute_dtype == "bf16"),
        pack_epilogue.idx_mask(ll_max), pack_window, p(out),
        ctypes.c_void_p(_cuda.stream_handle(dev)))
    _cuda.check(rc, "score_grouped_f")
    launches += 1
    if pack_window:
        pack_epilogue.count_launch()
    return out
