"""Row-major per-pair query projection + int8 quantize (K8).

Counterpart of `seismic_tpu/ops/pallas_qloc.py::project_qloc_rowmajor`: an
entry point of `csrc/qloc.cu`, whose kernel always was row-major, that takes
every pair's own vocab row and its own term row, as the Pallas kernel does.
For pair p:

    qloc[p, v] = sum_i qv[p, i] * [vocab_rows[p, v] == qc[p, i]]
    scale[p]   = max(max_v |qloc[p, v]|, 1e-20) * f32(1/127)
    q_i8[p, v] = round_half_even(qloc[p, v] / scale[p])

The Pallas body writes `/ 127.0`; XLA folds it into the multiply by the f32
reciprocal there too (interpret mode; tests/test_torch_qloc_modes.py holds
both outputs bit for bit). The scale comes back as `[P]`, not the TPU's
lane-replicated `[P, 128]`, and P needs no padding to a block of pairs.
`project_qloc_rowmajor` launches the kernel for CUDA tensors and uses the
plain PyTorch version, `project_qloc_rowmajor_plain`, for CPU tensors. The
rows are int16 (-1 padded) or, past dim 32766, int32 (PAD_COMPONENT
padded), as `grouped.py:669-672` gathers them; the two widths are counted
apart (`launches_i32`).
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .qloc import _lib, check_vocab, quantize_plain

# kernel launches since the count was last set to 0: on int16 rows, on
# int32 rows
launches = 0
launches_i32 = 0


def project_qloc_rowmajor_plain(vocab_rows, qc, qv):
    """Plain PyTorch version: the same f32 sum (term by term, as the TPU
    kernel's unrolled loop) and the same quantize."""
    rows = vocab_rows.to(torch.int32)
    acc = torch.zeros(rows.shape, dtype=torch.float32, device=rows.device)
    zero = torch.zeros((), dtype=torch.float32, device=rows.device)
    for i in range(qc.shape[1]):
        acc = acc + torch.where(rows == qc[:, i:i + 1], qv[:, i:i + 1], zero)
    return quantize_plain(acc)


def project_qloc_rowmajor(vocab_rows, qc, qv):
    """vocab_rows int16 [P, V] (-1 padded) or int32 (PAD_COMPONENT
    padded); qc int32 / qv f32 [P, SC] each pair's query terms
    (PAD_COMPONENT / 0 padded). Returns (q_i8 int8 [P, V], scale f32
    [P])."""
    global launches, launches_i32
    req = _cuda.require
    check_vocab(vocab_rows, "vocab_rows")
    req(qc.dim() == 2 and qc.dtype == torch.int32
        and qc.shape[0] == vocab_rows.shape[0], "qc must be int32 [P, SC]")
    req(qv.shape == qc.shape and qv.dtype == torch.float32,
        "qv must be f32 of qc's shape")
    dev = vocab_rows.device
    req(qc.device == dev and qv.device == dev,
        "all operands must be on one device")
    if dev.type == "cpu":
        return project_qloc_rowmajor_plain(vocab_rows, qc, qv)
    req(dev.type == "cuda", f"unsupported device {dev}")
    req(all(t.is_contiguous() for t in (vocab_rows, qc, qv)),
        "operands must be contiguous")
    lib = _lib()
    P, V = vocab_rows.shape
    SC = qc.shape[1]
    req(V % 8 == 0, f"V={V} is not a multiple of 8")
    out = torch.empty((P, V), dtype=torch.int8, device=dev)
    scale = torch.empty(P, dtype=torch.float32, device=dev)
    p = _cuda.ptr
    rc = lib.seismic_qloc_rowmajor(
        p(vocab_rows), vocab_rows.element_size(), p(qc), p(qv), P, V, SC,
        p(out), p(scale), ctypes.c_void_p(_cuda.stream_handle(dev)))
    _cuda.check(rc, "qloc_rowmajor")
    if vocab_rows.dtype == torch.int32:
        launches_i32 += 1
    else:
        launches += 1
    return out, scale
