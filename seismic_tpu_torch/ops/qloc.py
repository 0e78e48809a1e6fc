"""Per-pair query projection onto list vocabularies + int8 quantize (K1).

Counterpart of `seismic_tpu/ops/pallas_qloc.py::project_qloc_pallas` and
the per-pair quantize after it (`seismic_tpu/search/grouped.py:763-771`),
fused into one CUDA kernel (`csrc/qloc.cu`). For pair p of query
b = p // QC over list l = pair_list[p]:

    qloc[p, v] = sum_i qv[b, i] * [vocab[l, v] == qc[b, i]]
    scale[p]   = max(max_v |qloc[p, v]|, 1e-20) * f32(1/127)
    q_i8[p, v] = round_half_even(qloc[p, v] / scale[p])

`project_qloc_f32` is the same kernel without the quantize: it returns the
f32 projection the bf16/f32 scorer (K6) reads
(`seismic_tpu/search/grouped.py:772-773`). Both launch the kernel for CUDA
tensors and use the plain PyTorch versions, `project_qloc_quantize_plain`
and `project_qloc_plain`, for CPU tensors. The vocabulary is int16 (-1
padded) up to dim 32766 or int32 (PAD_COMPONENT padded) past it, as the
JAX package reads `vocab16` or `list_vocab` (`grouped.py:705-710`); the
kernel is one template on the code type, counted apart (`launches_i32`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _cuda

# kernel launches since the count was last set to 0: on an int16
# vocabulary, and on an int32 one
launches = 0
launches_i32 = 0
# XLA folds the JAX program's `/ 127.0` into a multiply by the f32
# reciprocal (its algebraic simplifier rewrites division by a constant);
# the port does the same multiply to stay bit-exact with it
INV_127 = float(np.float32(1.0) / np.float32(127.0))


def project_qloc_plain(vocab, pair_list, qc, qv, QC: int):
    """Plain PyTorch version of the f32 projection [P, V]: the same f32 sum
    (term by term, as the TPU kernel's unrolled loop)."""
    rows = vocab[pair_list.long()].to(torch.int32)  # [P, V]
    b = torch.div(torch.arange(rows.shape[0], device=rows.device), QC,
                  rounding_mode="floor")
    qcp = qc[b]  # [P, SC]
    qvp = qv[b]
    acc = torch.zeros(rows.shape, dtype=torch.float32, device=rows.device)
    zero = torch.zeros((), dtype=torch.float32, device=rows.device)
    for i in range(qc.shape[1]):
        acc = acc + torch.where(rows == qcp[:, i:i + 1], qvp[:, i:i + 1],
                                zero)
    return acc


def quantize_plain(acc):
    """Per-row symmetric int8 quantize of a projection f32 [P, V]:
    (q_i8 int8 [P, V], scale f32 [P])."""
    amax = acc.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp(amax, min=1e-20) * INV_127  # [P, 1]
    q_i8 = torch.round(acc / scale).to(torch.int8)
    return q_i8, scale[:, 0]


def project_qloc_quantize_plain(vocab, pair_list, qc, qv, QC: int):
    """Plain PyTorch version: the same f32 sum and the same quantize."""
    return quantize_plain(project_qloc_plain(vocab, pair_list, qc, qv, QC))


_handle = None


def _lib():
    global _handle
    if _handle is None:
        lib = _cuda.load("qloc")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.seismic_qloc_quantize.argtypes = [p, i, p, p, p, i, i, i, i, p,
                                              p, p]
        lib.seismic_qloc_quantize.restype = ctypes.c_int
        lib.seismic_qloc_f32.argtypes = [p, i, p, p, p, i, i, i, i, p, p]
        lib.seismic_qloc_f32.restype = ctypes.c_int
        lib.seismic_qloc_rowmajor.argtypes = [p, i, p, p, i, i, i, p, p, p]
        lib.seismic_qloc_rowmajor.restype = ctypes.c_int
        lib.seismic_qloc_residue.argtypes = [  # K9 (ops/qloc_residue.py)
            p, i, p, p, p, p, p, i, i, i, i, i, i, i, p, p, p, p]
        lib.seismic_qloc_residue.restype = ctypes.c_int
        _handle = lib
    return _handle


def check_vocab(vocab, what: str = "vocab"):
    _cuda.require(vocab.dim() == 2
                  and vocab.dtype in (torch.int16, torch.int32),
                  f"{what} must be int16 or int32 [n, V]")


def count_launch(vocab):
    """Add one to the count of the vocabulary's width."""
    global launches, launches_i32
    if vocab.dtype == torch.int32:
        launches_i32 += 1
    else:
        launches += 1


def _check(vocab, pair_list, qc, qv, QC: int):
    req = _cuda.require
    check_vocab(vocab)
    req(pair_list.dim() == 1 and pair_list.dtype == torch.int32,
        "pair_list must be int32 [P]")
    req(qc.dim() == 2 and qc.dtype == torch.int32, "qc must be int32 [B, SC]")
    req(qv.shape == qc.shape and qv.dtype == torch.float32,
        "qv must be f32 of qc's shape")
    req(pair_list.shape[0] == qc.shape[0] * QC, "P must equal B * QC")
    req(all(t.device == vocab.device for t in (pair_list, qc, qv)),
        "all operands must be on one device")


def _check_cuda(vocab, pair_list, qc, qv):
    """The loaded library, after the checks only the kernel needs."""
    req = _cuda.require
    req(vocab.device.type == "cuda", f"unsupported device {vocab.device}")
    req(all(t.is_contiguous() for t in (vocab, pair_list, qc, qv)),
        "operands must be contiguous")
    lib = _lib()
    req(vocab.shape[1] % 8 == 0, f"V={vocab.shape[1]} is not a multiple of 8")
    return lib


def project_qloc_quantize(vocab, pair_list, qc, qv, QC: int):
    """vocab int16 [n_lists, V] (-1 padded) or int32 (PAD_COMPONENT
    padded); pair_list int32 [P]; qc int32 / qv f32 [B, SC] the queries'
    top terms (PAD_COMPONENT / 0 padded), P == B * QC. Returns (q_i8 int8
    [P, V], scale f32 [P])."""
    _check(vocab, pair_list, qc, qv, QC)
    dev = vocab.device
    if dev.type == "cpu":
        return project_qloc_quantize_plain(vocab, pair_list, qc, qv, QC)
    lib = _check_cuda(vocab, pair_list, qc, qv)
    P, V = pair_list.shape[0], vocab.shape[1]
    out = torch.empty((P, V), dtype=torch.int8, device=dev)
    scale = torch.empty(P, dtype=torch.float32, device=dev)
    p = _cuda.ptr
    rc = lib.seismic_qloc_quantize(
        p(vocab), vocab.element_size(), p(pair_list), p(qc), p(qv), P, V,
        qc.shape[1], QC, p(out), p(scale),
        ctypes.c_void_p(_cuda.stream_handle(dev)))
    _cuda.check(rc, "qloc_quantize")
    count_launch(vocab)
    return out, scale


def project_qloc_f32(vocab, pair_list, qc, qv, QC: int):
    """The operands of `project_qloc_quantize`; returns the unquantized
    projection f32 [P, V]."""
    _check(vocab, pair_list, qc, qv, QC)
    dev = vocab.device
    if dev.type == "cpu":
        return project_qloc_plain(vocab, pair_list, qc, qv, QC)
    lib = _check_cuda(vocab, pair_list, qc, qv)
    P, V = pair_list.shape[0], vocab.shape[1]
    out = torch.empty((P, V), dtype=torch.float32, device=dev)
    p = _cuda.ptr
    rc = lib.seismic_qloc_f32(
        p(vocab), vocab.element_size(), p(pair_list), p(qc), p(qv), P, V,
        qc.shape[1], QC, p(out), ctypes.c_void_p(_cuda.stream_handle(dev)))
    _cuda.check(rc, "qloc_f32")
    count_launch(vocab)
    return out
