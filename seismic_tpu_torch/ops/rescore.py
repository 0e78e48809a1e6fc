"""Exact candidate rescoring from forward-index rows (K3).

Counterpart of `seismic_tpu/ops/pallas_rescore.py::
score_docs_rowmajor_pallas` and its wrapper `rescore_exact`, with the
forward-row gather and decode fused into the kernel
(`csrc/rescore.cu`). For query b and candidate r, over the fused
`[n_docs, 2W]` int32 forward rows (component ids | f32 value bits) of
doc d = clamp(doc_ids[b, r], 0, n_docs - 1):

    score[b, r] = sum_w val[d, w] * sum_i qv[b, i] * [comp[d, w] == qc[b, i]]

`score_docs_rowmajor` launches the kernel, a lookup of each entry in a
shared-memory hash table of the query's terms, for CUDA tensors and uses
the plain PyTorch version, `score_docs_rowmajor_plain`, for CPU ones.

The lean u8 form of the forward rows (`SeismicIndexDotVByte`: int16 ids
`[n_docs, W]` with -1 padding, u8 codes `[n_docs, W]` and each document's
f32 min and step) has a second entry point on the same table,
`score_docs_rowmajor_u8` (its plain version `score_docs_rowmajor_u8_plain`),
with val[d, w] = code[d, w] * step[d] + min[d] and 0 where the id is -1:
what the JAX package scores from the i16 twin and the decoded codes
(`pallas_rescore.py:147-159`, `search/engine.py:114-131`). It reads 3W + 8
bytes a candidate row where the fused form reads 8W. `rescore_exact`
dispatches on the index's form. Ids outside [0, n_docs) clamp, as in the
JAX package; with `skip_out_of_range` (the block-pool tail, which masks
those slots) they score -inf and the u8 kernel never reads their rows.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

# kernel launches since the count was last set to 0: the fused form's and
# the u8 form's
launches = 0
launches_u8 = 0
_handle = None


def decode_fused_rows(fwd_fused, doc_ids):
    """Gather and decode fused forward rows: (comps int32 [..., W], vals
    f32 [..., W], 0 at padding) — the fwd_fused branch of the JAX
    `rescore_exact` (pallas_rescore.py:133-146)."""
    from ..search.engine import _decode_fwd_vals

    fused = fwd_fused[doc_ids.long()]
    W = fused.shape[-1] // 2
    comps = fused[..., :W]
    vals = _decode_fwd_vals(fused[..., W:].view(torch.float32), comps)
    return comps, vals


def decode_u8_rows(comps16, codes, vmin, vstep, doc_ids):
    """Gather and decode lean u8 forward rows: (comps int32 [..., W], -1
    at padding; vals f32 [..., W], code * step + min, 0 at padding) — the
    fwd_comps16 branch of the JAX `rescore_exact` with its
    `_decode_fwd_vals` (`seismic_tpu/search/engine.py:114-131`)."""
    from ..search.engine import _decode_fwd_vals

    d = doc_ids.long()
    comps = comps16[d].to(torch.int32)
    vals = (codes[d].to(torch.float32) * vstep[d][..., None]
            + vmin[d][..., None])
    return comps, _decode_fwd_vals(vals, comps >= 0)


def fwd_width(index) -> int:
    """W, the entries of a forward row, in whichever form `index` holds
    the rows."""
    if index.fwd_fused is not None:
        return index.fwd_fused.shape[1] // 2
    return index.fwd_comps16.shape[1]


def decode_fwd_rows(index, doc_ids):
    """(comps int32, vals f32) of the forward rows of `doc_ids` in
    whichever form `index` holds them; padding ids are PAD_COMPONENT
    (fused) or -1 (u8), padding values 0."""
    if index.fwd_fused is not None:
        return decode_fused_rows(index.fwd_fused, doc_ids)
    return decode_u8_rows(index.fwd_comps16, index.fwd_vals,
                          index.fwd_val_min, index.fwd_val_step, doc_ids)


def _compare_sum(comps, vals, qc, qv):
    """sum_w vals * sum_i qv[i] * [comps == qc[i]], the terms added in
    order from 0.0 as the Pallas body adds them."""
    acc = torch.zeros(comps.shape, dtype=torch.float32, device=comps.device)
    zero = torch.zeros((), dtype=torch.float32, device=comps.device)
    for i in range(qc.shape[1]):
        acc = acc + torch.where(comps == qc[:, None, i:i + 1],
                                qv[:, None, i:i + 1], zero)
    return (vals * acc).sum(dim=-1)


def score_docs_rowmajor_plain(fwd_fused, doc_ids, qc, qv, n_docs: int):
    """Plain PyTorch version: gather + decode, then the term-by-term
    compare-accumulate and the reduction over W."""
    safe = doc_ids.clamp(0, n_docs - 1)
    comps, vals = decode_fused_rows(fwd_fused, safe)  # [B, R, W]
    return _compare_sum(comps, vals, qc, qv)


def score_docs_rowmajor_u8_plain(comps16, codes, vmin, vstep, doc_ids, qc,
                                 qv, n_docs: int,
                                 skip_out_of_range: bool = False):
    """Plain PyTorch version of the u8 form: gather + decode, then the
    compare loop, as the fused form's; with `skip_out_of_range`, ids
    outside [0, n_docs) score -inf instead of clamping."""
    safe = doc_ids.clamp(0, n_docs - 1)
    comps, vals = decode_u8_rows(comps16, codes, vmin, vstep, safe)
    out = _compare_sum(comps, vals, qc, qv)
    if skip_out_of_range:
        out = torch.where(in_range(doc_ids, n_docs), out, -torch.inf)
    return out


def in_range(doc_ids, n_docs: int):
    """Where doc_ids lie in [0, n_docs)."""
    return (doc_ids >= 0) & (doc_ids < n_docs)


def _lib():
    global _handle
    if _handle is None:
        lib = _cuda.load("rescore")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.seismic_rescore_fused.argtypes = [p, p, p, p, i, i, i, i, i, p, p]
        lib.seismic_rescore_fused.restype = ctypes.c_int
        lib.seismic_rescore_u8.argtypes = [p, p, p, p, p, p, p, i, i, i, i,
                                           i, i, p, p]
        lib.seismic_rescore_u8.restype = ctypes.c_int
        lib.seismic_rescore_max_terms.restype = ctypes.c_int
        _handle = lib
    return _handle


def score_docs_rowmajor(fwd_fused, doc_ids, qc, qv, n_docs: int):
    """fwd_fused int32 [n_docs, 2W], each row's padding at its end (as
    the index builds it: the kernel stops reading a row at its first
    PAD id); doc_ids int32 [B, R]; qc int32 / qv f32 [B, SC]
    (PAD_COMPONENT / 0 padded). Returns exact f32 [B, R]."""
    global launches
    req = _cuda.require
    req(fwd_fused.dim() == 2 and fwd_fused.dtype == torch.int32
        and fwd_fused.shape[1] % 2 == 0, "fwd_fused must be int32 [n, 2W]")
    req(fwd_fused.shape[0] == n_docs, "fwd_fused must have n_docs rows")
    req(doc_ids.dim() == 2 and doc_ids.dtype == torch.int32,
        "doc_ids must be int32 [B, R]")
    req(qc.dim() == 2 and qc.dtype == torch.int32
        and qc.shape[0] == doc_ids.shape[0], "qc must be int32 [B, SC]")
    req(qv.shape == qc.shape and qv.dtype == torch.float32,
        "qv must be f32 of qc's shape")
    dev = fwd_fused.device
    req(all(t.device == dev for t in (doc_ids, qc, qv)),
        "all operands must be on one device")
    if dev.type == "cpu":
        return score_docs_rowmajor_plain(fwd_fused, doc_ids, qc, qv, n_docs)
    req(dev.type == "cuda", f"unsupported device {dev}")
    req(all(t.is_contiguous() for t in (fwd_fused, doc_ids, qc, qv)),
        "operands must be contiguous")
    lib = _lib()
    B, R = doc_ids.shape
    SC = qc.shape[1]
    req(SC <= lib.seismic_rescore_max_terms(), f"{SC} terms exceed the cap")
    out = torch.empty((B, R), dtype=torch.float32, device=dev)
    p = _cuda.ptr
    rc = lib.seismic_rescore_fused(
        p(fwd_fused), p(doc_ids), p(qc), p(qv), B, R, SC, n_docs,
        fwd_fused.shape[1] // 2, p(out),
        ctypes.c_void_p(_cuda.stream_handle(dev)))
    _cuda.check(rc, "rescore_fused")
    launches += 1
    return out


def score_docs_rowmajor_u8(comps16, codes, vmin, vstep, doc_ids, qc, qv,
                           n_docs: int, skip_out_of_range: bool = False):
    """The u8 form: comps16 int16 [n_docs, W] (-1 padded at each row's
    end: the kernel stops reading a row at its first -1), codes uint8
    [n_docs, W], vmin / vstep f32 [n_docs]; doc_ids int32 [B, R]; qc
    int32 / qv f32 [B, SC] (PAD_COMPONENT / 0 padded). Returns exact f32
    [B, R]. Ids outside [0, n_docs) clamp, or with `skip_out_of_range`
    score -inf, their rows never read."""
    global launches_u8
    req = _cuda.require
    req(comps16.dim() == 2 and comps16.dtype == torch.int16,
        "comps16 must be int16 [n_docs, W]")
    req(codes.dtype == torch.uint8 and codes.shape == comps16.shape,
        "codes must be uint8 of comps16's shape")
    req(comps16.shape[0] == n_docs, "comps16 must have n_docs rows")
    req(all(t.dtype == torch.float32 and t.shape == (n_docs,)
            for t in (vmin, vstep)), "vmin / vstep must be f32 [n_docs]")
    req(doc_ids.dim() == 2 and doc_ids.dtype == torch.int32,
        "doc_ids must be int32 [B, R]")
    req(qc.dim() == 2 and qc.dtype == torch.int32
        and qc.shape[0] == doc_ids.shape[0], "qc must be int32 [B, SC]")
    req(qv.shape == qc.shape and qv.dtype == torch.float32,
        "qv must be f32 of qc's shape")
    ops = (comps16, codes, vmin, vstep, doc_ids, qc, qv)
    dev = comps16.device
    req(all(t.device == dev for t in ops),
        "all operands must be on one device")
    if dev.type == "cpu":
        return score_docs_rowmajor_u8_plain(*ops, n_docs, skip_out_of_range)
    req(dev.type == "cuda", f"unsupported device {dev}")
    req(all(t.is_contiguous() for t in ops), "operands must be contiguous")
    lib = _lib()
    B, R = doc_ids.shape
    SC = qc.shape[1]
    req(SC <= lib.seismic_rescore_max_terms(), f"{SC} terms exceed the cap")
    out = torch.empty((B, R), dtype=torch.float32, device=dev)
    p = _cuda.ptr
    rc = lib.seismic_rescore_u8(
        *(p(t) for t in ops), B, R, SC, n_docs, comps16.shape[1],
        int(skip_out_of_range), p(out),
        ctypes.c_void_p(_cuda.stream_handle(dev)))
    _cuda.check(rc, "rescore_u8")
    launches_u8 += 1
    return out


def _score_rows(index, ids, qc, qv, skip_out_of_range=False):
    """Exact scores of `ids` from the index's forward rows, by its form
    (out-of-range ids clamp, or score -inf with `skip_out_of_range`)."""
    if index.fwd_fused is not None:
        out = score_docs_rowmajor(index.fwd_fused, ids, qc, qv, index.n_docs)
        if skip_out_of_range:
            out = torch.where(in_range(ids, index.n_docs), out, -torch.inf)
        return out
    return score_docs_rowmajor_u8(
        index.fwd_comps16, index.fwd_vals, index.fwd_val_min,
        index.fwd_val_step, ids, qc, qv, index.n_docs,
        skip_out_of_range=skip_out_of_range)


def rescore_exact(index, doc_ids, top_c, top_v, sc: int, chunk_r: int = 0,
                  skip_out_of_range: bool = False):
    """Exact scores of `doc_ids` [B, R] against each row's query terms
    (top_c/top_v [B, >= sc]), from the fused forward rows or the lean u8
    form, whichever the index holds. `chunk_r > 0` scores R in sequential
    column chunks of that width (bounds live temporaries; one launch
    each). Ids outside [0, n_docs) clamp, as in the JAX package, or with
    `skip_out_of_range` score -inf (the u8 kernel then never reads their
    rows)."""
    R = doc_ids.shape[1]
    qc = top_c[:, :sc].to(torch.int32).contiguous()
    qv = top_v[:, :sc].to(torch.float32).contiguous()
    ids = doc_ids.to(torch.int32)
    if 0 < chunk_r < R:
        return torch.cat([
            _score_rows(index, ids[:, c0:c0 + chunk_r].contiguous(), qc, qv,
                        skip_out_of_range)
            for c0 in range(0, R, chunk_r)
        ], dim=1)
    return _score_rows(index, ids.contiguous(), qc, qv, skip_out_of_range)
