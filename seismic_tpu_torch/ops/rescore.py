"""Exact candidate rescoring from forward-index rows (K3).

Counterpart of `seismic_tpu/ops/pallas_rescore.py::
score_docs_rowmajor_pallas` and its wrapper `rescore_exact`, with the
forward-row gather and decode fused into the kernel
(`csrc/rescore.cu`). For query b and candidate r, over the forward row
of doc d = clamp(doc_ids[b, r], 0, n_docs - 1):

    score[b, r] = sum_w val[d, w] * sum_i qv[b, i] * [comp[d, w] == qc[b, i]]

Each form of the rows the JAX package's `rescore_exact` reads
(`pallas_rescore.py:100-175`) has an entry point on one shared-memory
hash table of the query's terms, and a plain PyTorch version that the
wrapper uses for CPU tensors:

- `score_docs_rowmajor` (`..._plain`): the fused rows `[n_docs, 2W]`
  int32, component ids | f32 value bits;
- `score_docs_rowmajor_fused16` (`..._plain`): the half-width fused rows
  `[n_docs, W]` int32 of `to_device(fwd_f16=True)`, id = word >> 16
  (arithmetic, -1 at padding), value = the f16 bits of the low half;
- `score_docs_rowmajor_lean` (`..._plain`): the lean form, ids int16
  (-1 padded) or int32 (PAD_COMPONENT padded, past dim 32766), codes u8
  or u16 (held as int16 bits) and each document's f32 min and step,
  val[d, w] = code[d, w] * step[d] + min[d], 0 at padding: what the JAX
  package scores from the i16 twin or the int32 ids and the decoded codes
  (`pallas_rescore.py:147-159`, `search/engine.py:114-131`). At int16 ids
  and u8 codes it reads 3W + 8 bytes a candidate row where the fused
  form reads 8W.

`rescore_exact` dispatches on the index's form. Ids outside [0, n_docs)
clamp, as in the JAX package; with `skip_out_of_range` (the block-pool
tail, which masks those slots) they score -inf and the half-width and
lean kernels never read their rows.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from ..data.sparse import PAD_COMPONENT

_PAD = int(PAD_COMPONENT)

# kernel launches since the count was last set to 0, one count a form:
# the fused rows, the half-width fused rows, and the lean form with int16
# ids and u8 codes, int16 ids and u16 codes, int32 ids (u8 or u16 codes)
launches = 0
launches_f16 = 0
launches_u8 = 0
launches_u16 = 0
launches_i32 = 0
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


def decode_fused16_rows(fwd_fused16, doc_ids):
    """Gather and decode half-width fused rows: (comps int32 [..., W], -1
    at padding; vals f32 [..., W], 0 at padding) — the fwd_fused16 branch
    of the JAX engine's `_exact_scores_block` (`seismic_tpu/search/
    engine.py:190-203`): id = word >> 16, value = f16 bits of the low
    half."""
    from ..search.engine import _decode_fwd_vals

    words = fwd_fused16[doc_ids.long()]
    comps = words >> 16
    vals = (words & 0xFFFF).to(torch.int16).view(torch.float16)
    return comps, _decode_fwd_vals(vals, comps >= 0)


def decode_lean_rows(comps, codes, vmin, vstep, doc_ids):
    """Gather and decode lean forward rows: (comps int32 [..., W], -1 or
    PAD_COMPONENT at padding as the ids hold it; vals f32 [..., W], code
    * step + min, 0 at padding) — the lean branch of the JAX
    `rescore_exact` with its `_decode_fwd_vals`
    (`seismic_tpu/search/engine.py:114-131`). `codes` is uint8, or int16
    holding u16 codes."""
    from ..search.engine import _decode_fwd_vals

    d = doc_ids.long()
    c = comps[d].to(torch.int32)
    x = codes[d].to(torch.int32)
    if codes.dtype == torch.int16:
        x = x & 0xFFFF
    vals = x.to(torch.float32) * vstep[d][..., None] + vmin[d][..., None]
    return c, _decode_fwd_vals(vals, (c >= 0) & (c != _PAD))


def lean_ids(index):
    """The lean form's ids: int16 up to dim 32766, int32 past it."""
    return (index.fwd_comps16 if index.fwd_comps16 is not None
            else index.fwd_comps)


def fwd_width(index) -> int:
    """W, the entries of a forward row, in whichever form `index` holds
    the rows."""
    if index.fwd_fused is not None:
        return index.fwd_fused.shape[1] // 2
    if index.fwd_fused16 is not None:
        return index.fwd_fused16.shape[1]
    return lean_ids(index).shape[1]


def decode_fwd_rows(index, doc_ids):
    """(comps int32, vals f32) of the forward rows of `doc_ids` in
    whichever form `index` holds them; padding ids are PAD_COMPONENT or
    -1, padding values 0."""
    if index.fwd_fused is not None:
        return decode_fused_rows(index.fwd_fused, doc_ids)
    if index.fwd_fused16 is not None:
        return decode_fused16_rows(index.fwd_fused16, doc_ids)
    return decode_lean_rows(lean_ids(index), index.fwd_vals,
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


def _skip(out, doc_ids, n_docs: int, skip_out_of_range: bool):
    if skip_out_of_range:
        out = torch.where(in_range(doc_ids, n_docs), out, -torch.inf)
    return out


def score_docs_rowmajor_plain(fwd_fused, doc_ids, qc, qv, n_docs: int):
    """Plain PyTorch version: gather + decode, then the term-by-term
    compare-accumulate and the reduction over W."""
    safe = doc_ids.clamp(0, n_docs - 1)
    comps, vals = decode_fused_rows(fwd_fused, safe)  # [B, R, W]
    return _compare_sum(comps, vals, qc, qv)


def score_docs_rowmajor_fused16_plain(fwd_fused16, doc_ids, qc, qv,
                                     n_docs: int,
                                     skip_out_of_range: bool = False):
    """Plain PyTorch version of the half-width fused form: gather +
    decode (f16 to f32 is exact), then the compare loop."""
    safe = doc_ids.clamp(0, n_docs - 1)
    comps, vals = decode_fused16_rows(fwd_fused16, safe)
    return _skip(_compare_sum(comps, vals, qc, qv), doc_ids, n_docs,
                 skip_out_of_range)


def score_docs_rowmajor_lean_plain(comps, codes, vmin, vstep, doc_ids, qc,
                                   qv, n_docs: int,
                                   skip_out_of_range: bool = False):
    """Plain PyTorch version of the lean form: gather + decode, then the
    compare loop, as the fused form's; with `skip_out_of_range`, ids
    outside [0, n_docs) score -inf instead of clamping."""
    safe = doc_ids.clamp(0, n_docs - 1)
    c, vals = decode_lean_rows(comps, codes, vmin, vstep, safe)
    return _skip(_compare_sum(c, vals, qc, qv), doc_ids, n_docs,
                 skip_out_of_range)


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
        lib.seismic_rescore_fused16.argtypes = [p, p, p, p, i, i, i, i, i,
                                                i, p, p]
        lib.seismic_rescore_fused16.restype = ctypes.c_int
        lib.seismic_rescore_lean.argtypes = [p, i, p, i, p, p, p, p, p, i, i,
                                             i, i, i, i, p, p]
        lib.seismic_rescore_lean.restype = ctypes.c_int
        _handle = lib
    return _handle


def _check_query(doc_ids, qc, qv):
    req = _cuda.require
    req(doc_ids.dim() == 2 and doc_ids.dtype == torch.int32,
        "doc_ids must be int32 [B, R]")
    req(qc.dim() == 2 and qc.dtype == torch.int32
        and qc.shape[0] == doc_ids.shape[0], "qc must be int32 [B, SC]")
    req(qv.shape == qc.shape and qv.dtype == torch.float32,
        "qv must be f32 of qc's shape")


def _cuda_lib(ops):
    """The loaded library, after the checks only the kernel needs."""
    req = _cuda.require
    req(ops[0].device.type == "cuda", f"unsupported device {ops[0].device}")
    req(all(t.is_contiguous() for t in ops), "operands must be contiguous")
    return _lib()


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
    _check_query(doc_ids, qc, qv)
    ops = (fwd_fused, doc_ids, qc, qv)
    dev = fwd_fused.device
    req(all(t.device == dev for t in ops),
        "all operands must be on one device")
    if dev.type == "cpu":
        return score_docs_rowmajor_plain(*ops, n_docs)
    lib = _cuda_lib(ops)
    B, R = doc_ids.shape
    out = torch.empty((B, R), dtype=torch.float32, device=dev)
    p = _cuda.ptr
    rc = lib.seismic_rescore_fused(
        *(p(t) for t in ops), B, R, qc.shape[1], n_docs,
        fwd_fused.shape[1] // 2, p(out),
        ctypes.c_void_p(_cuda.stream_handle(dev)))
    _cuda.check(rc, "rescore_fused")
    launches += 1
    return out


def score_docs_rowmajor_fused16(fwd_fused16, doc_ids, qc, qv, n_docs: int,
                                skip_out_of_range: bool = False):
    """The half-width fused form: fwd_fused16 int32 [n_docs, W] (id int16
    << 16 | f16 value bits, the padding -1 / +0.0 at each row's end: the
    kernel stops reading a row at its first -1); the other operands and
    the contract of `score_docs_rowmajor_lean`."""
    global launches_f16
    req = _cuda.require
    req(fwd_fused16.dim() == 2 and fwd_fused16.dtype == torch.int32
        and fwd_fused16.shape[0] == n_docs,
        "fwd_fused16 must be int32 [n_docs, W]")
    _check_query(doc_ids, qc, qv)
    ops = (fwd_fused16, doc_ids, qc, qv)
    dev = fwd_fused16.device
    req(all(t.device == dev for t in ops),
        "all operands must be on one device")
    if dev.type == "cpu":
        return score_docs_rowmajor_fused16_plain(*ops, n_docs,
                                                 skip_out_of_range)
    lib = _cuda_lib(ops)
    B, R = doc_ids.shape
    out = torch.empty((B, R), dtype=torch.float32, device=dev)
    p = _cuda.ptr
    rc = lib.seismic_rescore_fused16(
        *(p(t) for t in ops), B, R, qc.shape[1], n_docs,
        fwd_fused16.shape[1], int(skip_out_of_range), p(out),
        ctypes.c_void_p(_cuda.stream_handle(dev)))
    _cuda.check(rc, "rescore_fused16")
    launches_f16 += 1
    return out


def score_docs_rowmajor_lean(comps, codes, vmin, vstep, doc_ids, qc, qv,
                             n_docs: int, skip_out_of_range: bool = False):
    """The lean form: comps int16 [n_docs, W] (-1 padded) or int32
    (PAD_COMPONENT padded), the padding at each row's end (the kernel
    stops reading a row at its first padding id); codes [n_docs, W]
    uint8, or int16 holding u16 codes; vmin / vstep f32 [n_docs]; doc_ids
    int32 [B, R]; qc int32 / qv f32 [B, SC] (PAD_COMPONENT / 0 padded).
    Returns exact f32 [B, R]. Ids outside [0, n_docs) clamp, or with
    `skip_out_of_range` score -inf, their rows never read."""
    global launches_u8, launches_u16, launches_i32
    req = _cuda.require
    req(comps.dim() == 2 and comps.dtype in (torch.int16, torch.int32),
        "comps must be int16 or int32 [n_docs, W]")
    req(codes.dtype in (torch.uint8, torch.int16)
        and codes.shape == comps.shape,
        "codes must be uint8 (u8) or int16 (u16 bits) of comps' shape")
    req(comps.shape[0] == n_docs, "comps must have n_docs rows")
    req(all(t.dtype == torch.float32 and t.shape == (n_docs,)
            for t in (vmin, vstep)), "vmin / vstep must be f32 [n_docs]")
    _check_query(doc_ids, qc, qv)
    ops = (comps, codes, vmin, vstep, doc_ids, qc, qv)
    dev = comps.device
    req(all(t.device == dev for t in ops),
        "all operands must be on one device")
    if dev.type == "cpu":
        return score_docs_rowmajor_lean_plain(*ops, n_docs,
                                              skip_out_of_range)
    lib = _cuda_lib(ops)
    B, R = doc_ids.shape
    out = torch.empty((B, R), dtype=torch.float32, device=dev)
    p = _cuda.ptr
    rc = lib.seismic_rescore_lean(
        p(comps), comps.element_size(), p(codes), codes.element_size(),
        *(p(t) for t in ops[2:]), B, R, qc.shape[1], n_docs,
        comps.shape[1], int(skip_out_of_range), p(out),
        ctypes.c_void_p(_cuda.stream_handle(dev)))
    _cuda.check(rc, "rescore_lean")
    if comps.dtype == torch.int32:
        launches_i32 += 1
    elif codes.dtype == torch.uint8:
        launches_u8 += 1
    else:
        launches_u16 += 1
    return out


def _score_rows(index, ids, qc, qv, skip_out_of_range=False):
    """Exact scores of `ids` from the index's forward rows, by its form
    (out-of-range ids clamp, or score -inf with `skip_out_of_range`)."""
    if index.fwd_fused is not None:
        out = score_docs_rowmajor(index.fwd_fused, ids, qc, qv, index.n_docs)
        return _skip(out, ids, index.n_docs, skip_out_of_range)
    if index.fwd_fused16 is not None:
        return score_docs_rowmajor_fused16(
            index.fwd_fused16, ids, qc, qv, index.n_docs,
            skip_out_of_range=skip_out_of_range)
    return score_docs_rowmajor_lean(
        lean_ids(index), index.fwd_vals, index.fwd_val_min,
        index.fwd_val_step, ids, qc, qv, index.n_docs,
        skip_out_of_range=skip_out_of_range)


def rescore_exact(index, doc_ids, top_c, top_v, sc: int, chunk_r: int = 0,
                  skip_out_of_range: bool = False):
    """Exact scores of `doc_ids` [B, R] against each row's query terms
    (top_c/top_v [B, >= sc]), from the forward rows in whichever form
    the index holds them. `chunk_r > 0` scores R in sequential column
    chunks of that width (bounds live temporaries; one launch each). Ids
    outside [0, n_docs) clamp, as in the JAX package, or with
    `skip_out_of_range` score -inf (the half-width and lean kernels then
    never read their rows)."""
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
