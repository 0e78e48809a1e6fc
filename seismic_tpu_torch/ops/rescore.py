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
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

# kernel launches since the count was last set to 0
launches = 0
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


def score_docs_rowmajor_plain(fwd_fused, doc_ids, qc, qv, n_docs: int):
    """Plain PyTorch version: gather + decode, then the term-by-term
    compare-accumulate and the reduction over W."""
    safe = doc_ids.clamp(0, n_docs - 1)
    comps, vals = decode_fused_rows(fwd_fused, safe)  # [B, R, W]
    acc = torch.zeros(comps.shape, dtype=torch.float32, device=comps.device)
    zero = torch.zeros((), dtype=torch.float32, device=comps.device)
    for i in range(qc.shape[1]):
        acc = acc + torch.where(comps == qc[:, None, i:i + 1],
                                qv[:, None, i:i + 1], zero)
    return (vals * acc).sum(dim=-1)


def _lib():
    global _handle
    if _handle is None:
        lib = _cuda.load("rescore")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.seismic_rescore_fused.argtypes = [p, p, p, p, i, i, i, i, i, p, p]
        lib.seismic_rescore_fused.restype = ctypes.c_int
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


def rescore_exact(index, doc_ids, top_c, top_v, sc: int, chunk_r: int = 0):
    """Exact scores of `doc_ids` [B, R] against each row's query terms
    (top_c/top_v [B, >= sc]). `chunk_r > 0` scores R in sequential column
    chunks of that width (bounds live temporaries; one launch each)."""
    B, R = doc_ids.shape
    n_docs = index.n_docs
    qc = top_c[:, :sc].to(torch.int32).contiguous()
    qv = top_v[:, :sc].to(torch.float32).contiguous()
    ids = doc_ids.to(torch.int32)
    if 0 < chunk_r < R:
        return torch.cat([
            score_docs_rowmajor(index.fwd_fused,
                                ids[:, c0:c0 + chunk_r].contiguous(), qc, qv,
                                n_docs)
            for c0 in range(0, R, chunk_r)
        ], dim=1)
    return score_docs_rowmajor(index.fwd_fused, ids.contiguous(), qc, qv,
                               n_docs)
