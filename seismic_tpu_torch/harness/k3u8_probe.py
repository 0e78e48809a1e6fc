"""K3's u8 form measured inside, on the operands of one of its calls.

`inside(a)` takes the positional operands of a `score_docs_rowmajor_lean`
call (chip_smoke.py's phase 9 keeps those of one block-pool route batch)
and holds the kernel against its plain version in both contracts (ids
clamped; out-of-range ids skipped, as the block-pool tail calls it). It
reports the kernel's time in both, with every id pointing at one
document (the rows L1-resident: lookups and issue, no memory traffic),
the share of each query's in-range slots that repeat a document already
in that query's row, and the bounds of both contracts. Runs on the card
only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import rescore
from .device_probe import PEAK_BYTES, PEAK_F32, bound


def event_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median device time of `fn` in ms (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bounds(a, skip: bool) -> dict:
    """K3-u8's bounds on a = (comps16, codes, vmin, vstep, ids, qc, qv,
    n_docs), over the slots whose rows the call reads (with `skip`, the
    in-range ones; else every slot, clamped). `bound_ms`: the bytes the
    function must move (each distinct row's real entries, 2-byte id and
    1-byte code, each run rounded up to 32-byte sectors, and its 8-byte
    (min, step); the ids, the query terms and the output) against one
    lookup and one multiply-add a real entry of every read row, and the
    decode's multiply and add an entry whose id hits one of the query's
    terms, at the f32 rate; `bound_as_scheduled_ms`: the bytes with every
    read row's entries read once (no reuse across the L2)."""
    from ..data.sparse import PAD_COMPONENT

    comps16, ids, qc, n_docs = a[0], a[4], a[5], a[7]
    read = (rescore.in_range(ids, n_docs) if skip
            else torch.ones_like(ids, dtype=torch.bool))
    safe = ids.long().clamp(0, n_docs - 1)
    doc_nnz = (comps16 >= 0).sum(-1)  # [n_docs]

    def row_bytes(nnz):
        return int((((nnz * 2 + 31) // 32 + (nnz + 31) // 32) * 32 + 8)
                   .sum().item())

    # entries of every read row whose id is one of its query's real terms
    # (searched in the query's sorted terms, 64 queries at a time)
    q_sorted = qc.sort(1).values.contiguous()
    hits = 0
    for b0 in range(0, ids.shape[0], 64):
        rows = comps16[safe[b0:b0 + 64]].to(torch.int32)  # [b, R, W]
        rows = torch.where(read[b0:b0 + 64, :, None], rows, -1)
        flat = rows.reshape(rows.shape[0], -1).contiguous()
        q = q_sorted[b0:b0 + 64]
        at = torch.searchsorted(q, flat).clamp_max(q.shape[1] - 1)
        found = q.gather(1, at)
        hits += int(((found == flat) & (flat >= 0)
                     & (found != int(PAD_COMPONENT))).sum().item())
        del rows, flat, at, found
    row_nnz = doc_nnz[safe] * read  # [B, R]
    other = ids.numel() * 4 + qc.numel() * 8 + ids.numel() * 4
    nbytes = row_bytes(doc_nnz[torch.unique(safe[read])]) + other
    sched = row_bytes(row_nnz[read]) + other
    real = int(row_nnz.sum().item())
    b, bb = bound(nbytes, 2.0 * real + 2.0 * hits, PEAK_F32)
    return dict(bound_ms=b, bound_by=bb,
                bound_as_scheduled_ms=sched / PEAK_BYTES * 1e3,
                bytes=nbytes, bytes_as_scheduled=sched,
                rows_read=int(read.sum().item()), real_entries=real,
                hit_entries=hits)


def repeat_share(ids, n_docs: int) -> dict:
    """Of each query's in-range slots, the share that repeat a document
    already in that query's row: mean, min and max over the queries, and
    over all slots."""
    real = rescore.in_range(ids, n_docs)
    s = torch.where(real, ids, n_docs).sort(1).values
    dup = torch.zeros_like(real)
    dup[:, 1:] = (s[:, 1:] == s[:, :-1]) & (s[:, 1:] < n_docs)
    n_real = real.sum(1)
    share = dup.sum(1) / n_real.clamp_min(1)
    return dict(mean=float(share.mean().item()),
                min=float(share.min().item()), max=float(share.max().item()),
                all_slots=float(dup.sum().item() / max(1, n_real.sum())))


def one_doc_ids(a):
    """ids [B, R] all pointing at one document, the in-range candidate
    whose row length is the median of the batch's in-range slots."""
    comps16, ids, n_docs = a[0], a[4], a[7]
    real = rescore.in_range(ids, n_docs)
    cand = ids[real].long()
    nnz = (comps16[cand] >= 0).sum(-1)
    d = cand[nnz.argsort()[len(cand) // 2]]
    return torch.full_like(ids, int(d.item())), int(nnz.median().item())


def hold(k, p, what: str) -> dict:
    """Fail unless the kernel's k equals the plain p: -inf at the same
    places, 1e-5 relative elsewhere and exactly 0 where p is 0."""
    if not torch.equal(torch.isneginf(k), torch.isneginf(p)):
        raise AssertionError(f"K3-u8 ({what}): -inf at other places")
    fin = torch.isfinite(p)
    err = (k[fin] - p[fin]).abs()
    nz = p[fin] != 0
    rel = float((err[nz] / p[fin][nz].abs()).max().item()) if nz.any() \
        else 0.0
    zero = float(err[~nz].max().item()) if (~nz).any() else 0.0
    if not (rel <= 1e-5 and zero == 0.0):
        raise AssertionError(f"K3-u8 ({what}) disagrees with its plain "
                             f"version: max relative error {rel}, {zero} "
                             "where the plain score is 0")
    return dict(max_abs_err=float(err.max().item()) if err.numel() else 0.0,
                max_rel_err=rel, nonzero_scores=int(nz.sum().item()))


def plain(a, skip: bool):
    """The plain version in slices of 256 queries (bounding [rows, R, W])."""
    B = a[4].shape[0]
    return torch.cat([rescore.score_docs_rowmajor_lean_plain(
        *a[:4], a[4][r0:r0 + 256], a[5][r0:r0 + 256], a[6][r0:r0 + 256],
        a[7], skip_out_of_range=skip) for r0 in range(0, B, 256)])


def inside(a, reps: int = 10) -> dict:
    """The readings inside K3-u8 on a = its positional operands (module
    docstring). Kernel launches here count like any other: a caller that
    zeroes the launch counts does so after this."""
    kern = rescore.score_docs_rowmajor_lean
    rec = {"skip": bounds(a, True), "clamped": bounds(a, False)}
    for what, skip in (("skip", True), ("clamped", False)):
        k, p = kern(*a, skip_out_of_range=skip), plain(a, skip)
        torch.cuda.synchronize()
        rec[what].update(hold(k, p, what))
        del k, p
    one, one_nnz = one_doc_ids(a)
    a1 = a[:4] + (one,) + a[5:]
    rec.update(
        ms_skip=event_ms(lambda: kern(*a, skip_out_of_range=True), reps),
        ms_clamped=event_ms(lambda: kern(*a), reps),
        ms_one_doc=event_ms(lambda: kern(*a1, skip_out_of_range=True), reps),
        one_doc_nnz=one_nnz, repeat_share=repeat_share(a[4], a[7]),
        in_range_slots=int(rescore.in_range(a[4], a[7]).sum().item()),
        B=int(a[4].shape[0]), R=int(a[4].shape[1]),
        W=int(a[0].shape[1]), terms=int(a[5].shape[1]))
    return rec
