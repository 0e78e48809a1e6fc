"""Residue-bucketed per-pair query projection (K9).

Counterpart of `seismic_tpu/ops/pallas_qloc.py::project_qloc_residue` (and
of the per-pair quantize after it, `seismic_tpu/search/grouped.py:763-771`,
when the scorer is int8), the entry point `seismic_qloc_residue` of
`csrc/qloc.cu`. The index was uploaded with `vocab_residue=R`: every list's
vocabulary is R groups of VRS slots (group r holds the list's terms with
term % R == r) plus a spill region (`ops/tiles_prep.py::residue_layout`).
For pair p of query b = p // QC over list l = pair_list[p]:

    v <  R*VRS: qloc[p, v] = sum_{i<scb} qvb[b, r*scb+i]
                             * [vocab[l, v] == qcb[b, r*scb+i]],  r = v // VRS
    v >= R*VRS: qloc[p, v] = sum_i qv[b, i] * [vocab[l, v] == qc[b, i]]

(qcb, qvb) being the query's terms bucketed by residue, -2 padded
(`search/grouped.py::_residue_buckets`). `project_qloc_residue` returns the
f32 projection, or with `quantize=True` (q_i8, scale) as K1 does; it
launches the kernel for CUDA tensors and uses the plain PyTorch version,
`project_qloc_residue_plain`, for CPU tensors.

The kernel is K1's term lookup (one block a query row, a warp a pair, a
lookup a code) over one hash table of two kinds of key: the row's real
bucket entries, each keyed by its id and its bucket, serve the group
slots, and its plain terms, keyed by their id and R, the spill slots. So a
slot costs one lookup instead of a compare with every term of its bucket,
and the sums are the plain version's bit for bit. Operands it takes: V %
8 == 0, any number of plain terms, any R and scb (past what its largest
table holds, a row's terms and buckets are walked in order in device
memory, with the same sums); bucket ids below 0 are padding.

The vocabulary is int16 up to dim 32766 and int32 past it (both -1
padded after the residue permutation), as JAX's kernel takes either
(`pallas_qloc.py:153`). The int32 instance keys its table by the (id,
bucket) pair itself, in 16-byte entries, so every id up to 2^31 - 2 is
exact; it is counted apart (`launches_i32`).
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .qloc import _lib, quantize_plain
from .tiles_prep import residue_layout

# kernel launches since the count was last set to 0: on an int16
# vocabulary, and on an int32 one
launches = 0
launches_i32 = 0


def project_qloc_residue_plain(vocab, pair_list, qcb, qvb, qc, qv, QC: int,
                               R: int, scb: int, quantize: bool = False):
    """Plain PyTorch version: the same f32 sums, term by term in the TPU
    kernel's order, and the same quantize."""
    rows = vocab[pair_list.long()].to(torch.int32)  # [P, V]
    P, V = rows.shape
    VRS, _ = residue_layout(V, R)
    dev = rows.device
    b = torch.div(torch.arange(P, device=dev), QC, rounding_mode="floor")
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    # group slots: slot v of group r against bucket r's scb slots
    grp = rows[:, :R * VRS].reshape(P, R, VRS)
    bc = qcb[b].reshape(P, R, scb)
    bv = qvb[b].reshape(P, R, scb)
    acc_g = torch.zeros(grp.shape, dtype=torch.float32, device=dev)
    for i in range(scb):
        acc_g = acc_g + torch.where(grp == bc[:, :, i:i + 1],
                                    bv[:, :, i:i + 1], zero)
    # spill slots against every plain term
    sp = rows[:, R * VRS:]
    qcp, qvp = qc[b], qv[b]
    acc_s = torch.zeros(sp.shape, dtype=torch.float32, device=dev)
    for i in range(qc.shape[1]):
        acc_s = acc_s + torch.where(sp == qcp[:, i:i + 1], qvp[:, i:i + 1],
                                    zero)
    acc = torch.cat([acc_g.reshape(P, R * VRS), acc_s], dim=1)
    return quantize_plain(acc) if quantize else acc


def project_qloc_residue(vocab, pair_list, qcb, qvb, qc, qv, QC: int, R: int,
                         scb: int, quantize: bool = False):
    """vocab int16 or int32 [n_lists, V] residue-ordered (-1 padded);
    pair_list int32
    [P]; qcb int32 / qvb f32 [B, R * scb] the bucketed terms (-2 / 0
    padded); qc int32 / qv f32 [B, SC] the plain top terms (PAD_COMPONENT /
    0 padded); P == B * QC. Returns f32 [P, V], or (q_i8 int8 [P, V], scale
    f32 [P]) with quantize."""
    global launches, launches_i32
    req = _cuda.require
    req(vocab.dim() == 2 and vocab.dtype in (torch.int16, torch.int32),
        "vocab must be int16 or int32 [n_lists, V]")
    req(pair_list.dim() == 1 and pair_list.dtype == torch.int32,
        "pair_list must be int32 [P]")
    req(qc.dim() == 2 and qc.dtype == torch.int32, "qc must be int32 [B, SC]")
    req(qv.shape == qc.shape and qv.dtype == torch.float32,
        "qv must be f32 of qc's shape")
    req(qcb.shape == (qc.shape[0], R * scb) and qcb.dtype == torch.int32,
        "qcb must be int32 [B, R * scb]")
    req(qvb.shape == qcb.shape and qvb.dtype == torch.float32,
        "qvb must be f32 of qcb's shape")
    req(pair_list.shape[0] == qc.shape[0] * QC, "P must equal B * QC")
    V = vocab.shape[1]
    req(R > 0 and V % 8 == 0, "needs R > 0 and V a multiple of 8")
    VRS, _ = residue_layout(V, R)
    dev = vocab.device
    req(all(t.device == dev for t in (pair_list, qcb, qvb, qc, qv)),
        "all operands must be on one device")
    if dev.type == "cpu":
        return project_qloc_residue_plain(vocab, pair_list, qcb, qvb, qc, qv,
                                          QC, R, scb, quantize)
    req(dev.type == "cuda", f"unsupported device {dev}")
    req(all(t.is_contiguous() for t in (vocab, pair_list, qcb, qvb, qc, qv)),
        "operands must be contiguous")
    lib = _lib()
    P, SC = pair_list.shape[0], qc.shape[1]
    p = _cuda.ptr
    q_i8 = scale = out_f32 = None
    if quantize:
        q_i8 = torch.empty((P, V), dtype=torch.int8, device=dev)
        scale = torch.empty(P, dtype=torch.float32, device=dev)
    else:
        out_f32 = torch.empty((P, V), dtype=torch.float32, device=dev)
    rc = lib.seismic_qloc_residue(
        p(vocab), vocab.element_size(), p(pair_list), p(qcb), p(qvb), p(qc),
        p(qv), P, V, SC, QC,
        R, scb, VRS, p(q_i8) if quantize else None,
        p(scale) if quantize else None, None if quantize else p(out_f32),
        ctypes.c_void_p(_cuda.stream_handle(dev)))
    _cuda.check(rc, "qloc_residue")
    if vocab.dtype == torch.int32:
        launches_i32 += 1
    else:
        launches += 1
    return (q_i8, scale) if quantize else out_f32
