#!/usr/bin/env python3
"""Chip smoke test of seismic_tpu_torch, the PyTorch / CUDA port, on one
NVIDIA card.

    python3 chip_smoke.py [--n-docs N]

`--n-docs` below 100,000 is a rehearsal at a cut corpus; the run says so
on its output. The batch (4096 queries) and the 5 timed batches are
fixed. The full record goes to `chiprun_out/chip_smoke.json`.

Phases (any failure exits non-zero, and no result line is printed):

1. build the hand-written CUDA kernels from `seismic_tpu_torch/csrc`
   (one nvcc per source, all started together);
2. hold each kernel against its plain PyTorch version at the main path's
   shapes (K1 qloc + quantize: bit-exact; K2 grouped i8 scorer: exact
   int dots, 1e-6 relative; K3 fused rescore: 1e-5 relative), and time
   it beside its bound, its plain version and one library call;
3. drive the main path through the user's entry points:
   `SeismicIndexRaw.build_from_csr` on a 100K-doc synthetic SPLADE-like
   collection at dim 30522 with V=1024 local vocabularies, then
   `batch_search` of 4096 distinct queries (k=10, query_cut=14,
   heap_factor=0), with the kernel launch counts set to 0 just before and
   read just after; check the results (shapes, finite scores, exact
   rescored scores, recall@10 >= 0.9 on 256 queries against a brute-force
   sparse x dense product on the card).

The line before the last is the kernels' JSON record; the last line is
`{"ok": true, "device": {...}}`. Without CUDA, or without the package
beside this script, it exits non-zero and prints no result.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, int8 tensor-core
# ops/s, f32 CUDA-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_INT8 = 1979e12
PEAK_F32 = 67e12

K, QUERY_CUT, V_CAP, DIM = 10, 14, 1024, 30522
N_DOCS, BATCH, REPS = 100_000, 4096, 5
OUT_DIR = os.path.join(ROOT, "chiprun_out")


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def bound(nbytes: float, nops: float, op_peak: float):
    """(bound_ms, bound_by): the larger of the bytes and the ops times."""
    tb, to = nbytes / PEAK_BYTES, nops / op_peak
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median device time of `fn` in ms (CUDA events around each call)."""
    import torch

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


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        fail(f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def breakdown(index, qcomps, qvals, dev) -> dict:
    """Where one batch's time goes: the API's host stages on the host
    clock (each device stage ends in a synchronize), and the device
    program's kernels by name from a torch.profiler window. Informational:
    a profiler that records no device time leaves "not measured"."""
    import torch

    from seismic_tpu_torch.api import DEFAULT_QUERY_PAD, route_params
    from seismic_tpu_torch.data.sparse import pad_queries
    from seismic_tpu_torch.search.grouped import DevicePlan, _grouped_impl
    from seismic_tpu_torch.search.planner import plan_grouped_numpy

    dindex = index.device_index()
    params = route_params(K)
    t = [time.perf_counter()]
    q_comps, q_vals = pad_queries(qcomps, qvals, DEFAULT_QUERY_PAD)
    t.append(time.perf_counter())
    plan = plan_grouped_numpy(q_comps, q_vals, index._grouped_ctx(),
                              QUERY_CUT)
    t.append(time.perf_counter())
    args = (dindex, DevicePlan.put(plan, dev),
            torch.from_numpy(q_comps).to(dev),
            torch.from_numpy(q_vals).to(dev), params)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    scores, ids = _grouped_impl(*args)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    scores, ids = scores.cpu().numpy(), ids.cpu().numpy()
    t.append(time.perf_counter())
    out = {name: (t[i + 1] - t[i]) * 1e3 for i, name in enumerate(
        ("pad_queries_ms", "plan_ms", "upload_ms", "device_program_ms",
         "download_ms"))}
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _grouped_impl(*args)
            torch.cuda.synchronize()
        kern = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0) or 0
            if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
                kern[e.key[:80]] = kern.get(e.key[:80], 0.0) + us / 1e3
        busy = sum(kern.values())
        if busy <= 0:
            raise RuntimeError("the profiler recorded no device time")
        out["device_busy_ms"] = busy
        out["device_idle_share"] = max(
            0.0, 1.0 - busy / out["device_program_ms"])
        out["kernels_ms"] = dict(sorted(kern.items(), key=lambda kv: -kv[1])
                                 [:12])
    except Exception as e:  # noqa: BLE001 - informational only
        out["profile"] = f"not measured: {e}"
    return out


def synth_queries_distinct(n: int):
    """`n` distinct queries: fresh seed per 1024 (seeds 11, 12, ...)."""
    from seismic_tpu_torch.harness.synth import synth_queries

    comps, vals = [], []
    seed = 11
    while len(comps) < n:
        c, v = synth_queries(min(1024, n - len(comps)), dim=DIM, seed=seed)
        comps += c
        vals += v
        seed += 1
    return comps, vals


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-docs", type=int, default=N_DOCS,
                    help="cut the corpus for a rehearsal (default 100000)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    try:
        import seismic_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"seismic_tpu_torch is not importable beside this script: {e}")
    from seismic_tpu_torch import (
        Configuration,
        GlobalThresholdPruning,
        SeismicIndexRaw,
        TpuLayout,
    )
    from seismic_tpu_torch.data.sparse import PAD_COMPONENT, pad_queries
    from seismic_tpu_torch.harness.synth import synth_dataset
    from seismic_tpu_torch.ops import _cuda, grouped_scorer, qloc, rescore
    from seismic_tpu_torch.ops.tiles_prep import SUB, ll_pad_for
    from seismic_tpu_torch.search.grouped import DevicePlan, _top_k
    from seismic_tpu_torch.search.planner import plan_grouped_numpy

    t_start = time.time()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    record = {"card": card, "device": torch.cuda.get_device_name(0)}
    log(f"card: {card}  torch {torch.__version__} cuda {torch.version.cuda}")
    if args.n_docs < N_DOCS:
        log(f"REHEARSAL: n_docs {args.n_docs} < {N_DOCS}, the cell's corpus "
            "is cut")

    # ---------------- phase 1: build the kernels ----------------
    try:
        build_s = _cuda.build(force=True)
    except Exception as e:  # noqa: BLE001 - reported, then fail
        fail(f"kernel build: {e}")
    record["kernel_build_s"] = build_s
    log(f"phase 1: built {len(_cuda.KERNELS)} kernels in {build_s:.2f} s")
    for name, rep in _cuda.ptxas_report.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # ---------------- set-up of the main path (host build) ----------------
    t0 = time.time()
    ds = synth_dataset(args.n_docs, dim=DIM, seed=7)
    synth_s = time.time() - t0
    cfg = Configuration(
        pruning=GlobalThresholdPruning(n_postings=200, max_fraction=2.0),
        layout=TpuLayout(max_block_len=32, summary_vocab_cap=V_CAP,
                         max_doc_nnz=256, tile_overflow=64),
    )
    t0 = time.time()
    index = SeismicIndexRaw.build_from_csr(ds, cfg)
    build_index_s = time.time() - t0
    t0 = time.time()
    dindex = index.device_index()
    upload_s = time.time() - t0
    device_bytes = dindex.nbytes()
    log(f"setup: synth {synth_s:.1f} s, index build {build_index_s:.1f} s, "
        f"upload {upload_s:.1f} s, n_docs {ds.offsets.shape[0] - 1}, "
        f"nnz {ds.nnz}, device index bytes {device_bytes}")
    record.update(n_docs=len(ds), synth_s=synth_s,
                  index_build_s=build_index_s, upload_s=upload_s,
                  device_index_bytes=device_bytes)
    qcomps, qvals = synth_queries_distinct(BATCH)
    q_comps, q_vals = pad_queries(qcomps, qvals, 128)

    # ---------------- phase 2: kernels against plain versions -------------
    arrays = index.arrays
    plan = plan_grouped_numpy(q_comps, q_vals, index._grouped_ctx(),
                              QUERY_CUT)
    dplan = DevicePlan.put(plan, dev)
    B, QC = plan.pair_slot.shape
    P = B * QC
    qct = torch.from_numpy(q_comps).to(dev)
    qvt = torch.where(qct != int(PAD_COMPONENT),
                      torch.from_numpy(q_vals).to(dev), 0.0)
    top_v, top_p = _top_k(qvt, 64)
    top_c = torch.gather(qct, 1, top_p).contiguous()
    top_v = top_v.contiguous()
    n_terms = (top_c != int(PAD_COMPONENT)).sum(1)  # [B] real terms
    kernels = []
    reps = 20

    # K1: qloc + quantize
    pair_list = dplan.pair_list.reshape(P).contiguous()
    a1 = (dindex.vocab16, pair_list, top_c, top_v, QC)
    k_i8, k_sc = qloc.project_qloc_quantize(*a1)
    p_i8, p_sc = qloc.project_qloc_quantize_plain(*a1)
    torch.cuda.synchronize()
    if not (torch.equal(k_i8, p_i8) and torch.equal(k_sc, p_sc)):
        fail(f"K1 disagrees: {(k_i8 != p_i8).sum().item()} i8 and "
             f"{(k_sc != p_sc).sum().item()} scale mismatches")
    V = dindex.vocab16.shape[1]
    n_lists_used = torch.unique(pair_list).numel()
    by1 = (n_lists_used * V * 2 + P * 4 + top_c.numel() * 8 + P * V + P * 4)
    ops1 = 2.0 * V * float(n_terms.repeat_interleave(QC).sum().item())
    b1, bb1 = bound(by1, ops1, PEAK_F32)
    kernels.append(dict(
        name="qloc_quantize", route="cuda",
        source="seismic_tpu_torch/csrc/qloc.cu",
        replaces="seismic_tpu/ops/pallas_qloc.py:25",
        max_abs_err=float((k_i8.int() - p_i8.int()).abs().max().item()),
        ms=time_ms(lambda: qloc.project_qloc_quantize(*a1), reps),
        plain_ms=time_ms(lambda: qloc.project_qloc_quantize_plain(*a1), 3),
        bound_ms=b1, bound_by=bb1, library_ms=None,
    ))

    # K2: grouped i8 scorer, fed the main path's own projections
    LLMAX = ll_pad_for(arrays.max_list_len, 1)
    G_cap, M = plan.slot_b.shape
    q8 = k_i8[dplan.slot_pair.long()].reshape(G_cap, M, V).contiguous()
    a2 = (dindex.doc_tiles_aligned, dindex.tile_scale, q8,
          dplan.work_region, dplan.work_g, dplan.work_s, LLMAX)
    k_out = grouped_scorer.score_grouped_i8(*a2)
    p_out = grouped_scorer.score_grouped_i8_plain(*a2)
    Wr = plan.W
    wg = dplan.work_g[:Wr].long()
    ws = dplan.work_s[:Wr].long()
    kb = k_out.view(G_cap, M, LLMAX // SUB, SUB)[wg, :, ws, :]
    pb = p_out.view(G_cap, M, LLMAX // SUB, SUB)[wg, :, ws, :]
    rel2 = ((kb - pb).abs() / pb.abs().clamp_min(1e-30)).max().item()
    if not rel2 <= 1e-6:
        fail(f"K2 disagrees: max relative error {rel2}")
    ones = torch.ones_like(dindex.tile_scale)
    a2u = (dindex.doc_tiles_aligned, ones) + a2[2:]
    kd = grouped_scorer.score_grouped_i8(*a2u).view(
        G_cap, M, LLMAX // SUB, SUB)[wg, :, ws, :]
    pd = grouped_scorer.grouped_dots_plain(
        dindex.doc_tiles_aligned, q8, dplan.work_region[:Wr],
        dplan.work_g[:Wr]).to(torch.float32)
    if not torch.equal(kd, pd):
        fail("K2 int dots disagree with the plain version")
    n_regions = torch.unique(dplan.work_region[:Wr]).numel()
    by2 = (n_regions * SUB * (V + 4) + plan.G * M * V + Wr * 12
           + Wr * M * SUB * 4)
    ops2 = 2.0 * Wr * M * SUB * V
    b2, bb2 = bound(by2, ops2, PEAK_INT8)
    # library yardstick: one int8 tensor-core product with the same
    # operation count over the same gathered tile rows (one [V, 8] query
    # block for all items: not the same function; timed, never used)
    lib_ms = None
    try:
        rows = (dplan.work_region[:Wr].long()[:, None] * SUB
                + torch.arange(SUB, device=dev)).reshape(-1)
        A = dindex.doc_tiles_aligned[rows].view(torch.int8)
        Bq = q8[0].t()  # [V, 8], column-major
        torch._int_mm(A, Bq)
        lib_ms = time_ms(lambda: torch._int_mm(A, Bq), reps)
        del A
    except Exception as e:  # noqa: BLE001 - the yardstick is optional
        log(f"  torch._int_mm yardstick unavailable: {e}")
    kernels.append(dict(
        name="score_grouped_i8", route="cuda",
        source="seismic_tpu_torch/csrc/grouped_scorer.cu",
        replaces="seismic_tpu/ops/pallas_grouped.py:231",
        max_abs_err=float((kb - pb).abs().max().item()),
        ms=time_ms(lambda: grouped_scorer.score_grouped_i8(*a2), reps),
        plain_ms=time_ms(lambda: grouped_scorer.score_grouped_i8_plain(*a2),
                         3),
        bound_ms=b2, bound_by=bb2, library_ms=lib_ms,
    ))
    del k_out, p_out, kd, pd

    # K3: fused rescore over random candidates of the real index
    R = 48
    g3 = torch.Generator(device=dev).manual_seed(3)
    ids = torch.randint(0, arrays.n_docs, (B, R), generator=g3,
                        device=dev, dtype=torch.int32)
    a3 = (dindex.fwd_fused, ids, top_c, top_v, arrays.n_docs)
    k3 = rescore.score_docs_rowmajor(*a3)
    p3 = rescore.score_docs_rowmajor_plain(*a3)
    rel3 = ((k3 - p3).abs() / p3.abs().clamp_min(1e-30)).max().item()
    if not rel3 <= 1e-5:
        fail(f"K3 disagrees: max relative error {rel3}")
    W2 = dindex.fwd_fused.shape[1]
    uniq = torch.unique(ids).long()
    # bytes the function must move: each distinct row's real entries (4-byte
    # id + 4-byte value, each run rounded up to 32-byte sectors), the ids,
    # the query terms and the output
    uniq_nnz = (dindex.fwd_fused[uniq, : W2 // 2]
                != int(PAD_COMPONENT)).sum(-1)
    by3 = 2 * int(((uniq_nnz * 4 + 31) // 32 * 32).sum().item()) \
        + ids.numel() * 4 + top_c.numel() * 8 + ids.numel() * 4
    row_nnz = (dindex.fwd_fused[ids.long(), : W2 // 2]
               != int(PAD_COMPONENT)).sum(-1)  # [B, R]
    ops3 = float((row_nnz * (2 * n_terms[:, None] + 2)).sum().item())
    b3, bb3 = bound(by3, ops3, PEAK_F32)
    kernels.append(dict(
        name="rescore_fused", route="cuda",
        source="seismic_tpu_torch/csrc/rescore.cu",
        replaces="seismic_tpu/ops/pallas_rescore.py:30",
        max_abs_err=float((k3 - p3).abs().max().item()),
        ms=time_ms(lambda: rescore.score_docs_rowmajor(*a3), reps),
        plain_ms=time_ms(lambda: rescore.score_docs_rowmajor_plain(*a3), 3),
        bound_ms=b3, bound_by=bb3, library_ms=None,
    ))
    for kr in kernels:
        log(f"phase 2: {kr['name']}: ok, max_abs_err {kr['max_abs_err']:.3g}"
            f", {kr['ms']:.4f} ms (bound {kr['bound_ms']:.4f} ms by "
            f"{kr['bound_by']}, plain {kr['plain_ms']:.3f} ms, library "
            f"{kr['library_ms']})")
    del k_i8, p_i8, q8, k3, p3
    torch.cuda.empty_cache()

    # ---------------- phase 3: the main path ----------------
    def run():
        t = time.time()
        res = index.batch_search(qcomps, qvals, k=K, query_cut=QUERY_CUT,
                                 heap_factor=0.0)
        return res, time.time() - t

    run()  # warm-up (allocator, first launches)
    mods = (qloc, grouped_scorer, rescore)
    for m in mods:
        m.launches = 0
    lat, res = [], None
    for _ in range(REPS):
        res, dt = run()
        lat.append(dt)
    counts = [m.launches for m in mods]
    for kr, c in zip(kernels, counts):
        kr["launches"] = c
    if min(counts) <= 0:
        fail(f"a kernel of the main path never launched: {counts}")
    p50 = float(np.median(lat))
    qps = BATCH * REPS / sum(lat)  # all queries over the whole window
    log(f"phase 3: {REPS} warm batches of {BATCH}: p50 "
        f"{p50 * 1e3:.2f} ms, QPS {qps:.1f}, launches qloc/scorer/rescore "
        f"{counts}")

    # results: shape, finite, sorted, exact rescored scores
    if len(res) != BATCH:
        fail(f"{len(res)} result rows for {BATCH} queries")
    fwd_c, fwd_v = arrays.fwd_comps, arrays.fwd_vals.astype(np.float32)
    for b, row in enumerate(res):
        if len(row) != K:
            fail(f"query {b}: {len(row)} results, expected {K}")
        sc = np.array([s for s, _ in row])
        if not (np.isfinite(sc).all() and (np.diff(sc) <= 0).all()):
            fail(f"query {b}: scores not finite and descending")
        if b < 8:
            qd = dict(zip(qcomps[b].tolist(), qvals[b].tolist()))
            for s, d in row:
                ref = sum(float(v) * qd.get(int(c), 0.0)
                          for c, v in zip(fwd_c[d], fwd_v[d])
                          if c != PAD_COMPONENT)
                if abs(s - ref) > 1e-4 * abs(ref):
                    fail(f"query {b} doc {d}: score {s} != exact {ref}")

    # recall@10 on the first 256 queries against a brute-force product
    nq = 256
    docs = torch.sparse_csr_tensor(
        torch.from_numpy(ds.offsets), torch.from_numpy(
            ds.components.astype(np.int64)),
        torch.from_numpy(ds.values.astype(np.float32)),
        size=(len(ds), DIM)).to(dev)
    qd = torch.zeros((DIM, nq), dtype=torch.float32)
    for b in range(nq):
        qd[torch.from_numpy(qcomps[b].astype(np.int64)), b] = \
            torch.from_numpy(qvals[b].astype(np.float32))
    exact = torch.sparse.mm(docs, qd.to(dev))  # [n_docs, nq]
    gt = torch.topk(exact, K, dim=0).indices.t().cpu().numpy()
    hits = sum(len(set(gt[b].tolist()) & {d for _, d in res[b]})
               for b in range(nq))
    recall = hits / (K * nq)
    log(f"phase 3: recall@10 {recall:.4f} on {nq} queries")
    if recall < 0.9:
        fail(f"recall@10 {recall:.4f} < 0.9")

    record["breakdown"] = breakdown(index, qcomps, qvals, dev)
    log(f"breakdown of one batch: {json.dumps(record['breakdown'])}")

    total_s = time.time() - t_start
    record.update(
        qps=qps, p50_ms=p50 * 1e3, batch=BATCH, reps=REPS,
        rehearsal=args.n_docs < N_DOCS,
        latencies_s=lat, recall_at_10=recall, recall_queries=nq,
        peak_device_bytes=torch.cuda.max_memory_allocated(),
        plan={"G": plan.G, "W": plan.W, "G_cap": plan.G_cap,
              "W_cap": plan.W_cap, "P": P, "LLMAX": LLMAX},
        kernels=kernels, total_s=total_s,
    )
    try:
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
            json.dump(record, f, indent=1)
    except OSError as e:
        log(f"(record not written: {e})")
    log(f"total {total_s:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
