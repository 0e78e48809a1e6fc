#!/usr/bin/env python3
"""Chip smoke test of seismic_tpu_torch, the PyTorch / CUDA port, on one
NVIDIA card.

    python3 chip_smoke.py [--n-docs N]

`--n-docs` below 100,000 is a rehearsal at a cut corpus; the run says so
on its output. Batches and repetitions are fixed. The full record goes to
`chiprun_out/chip_smoke.json`.

Phases (any failure exits non-zero, and no result line is printed):

1. build the hand-written CUDA kernels from `seismic_tpu_torch/csrc`
   (one nvcc per source, all started together);
2. hold K1-K3 against their plain PyTorch versions at the API path's
   shapes (K1 qloc + quantize: bit-exact; K2 grouped i8 scorer: exact
   int dots, 1e-6 relative; K3 fused rescore: 1e-5 relative), and time
   each beside its bound, its plain version and one library call;
3. drive the API path through the user's entry points:
   `SeismicIndexRaw.build_from_csr` on a 100K-doc synthetic SPLADE-like
   collection at dim 30522 with V=1024 local vocabularies, then
   `batch_search` of 4096 distinct queries (k=10, query_cut=14,
   heap_factor=0), with the kernel launch counts set to 0 just before and
   read just after; check the results (shapes, finite scores, exact
   rescored scores, recall@10 >= 0.9 on 256 queries against a brute-force
   sparse x dense product on the card);
4. drive the JAX repo's bench headline path (bench.py:514-669): the same
   corpus built with f32 values, narrowed to V=512 and uploaded with
   csub 2; 16,384 distinct queries padded to 64 terms. The derived plan
   must equal the C++ host plan on every batch (and both searches agree);
   at B=4096/M=8 and B=16384/M=16, on the path's own inputs, K1 must equal
   its plain version bit for bit, K4 exactly in its int dots and to 1e-6
   relative, and K3 (on the pool's candidates) to 1e-5 relative, each
   timed beside its bound; then QPS at B=4096/M=8 (`plan_caps` +
   `search_grouped_derive` per batch, 5 x 4 batches, one synchronise) and
   at B=16384/M=16 (5 calls), with the launch counts set to 0 before and
   read after (K1, K4, K3 > 0, K2 = 0); p50 of a synchronised B=4096
   call; one call under `torch.cuda.set_sync_debug_mode("error")`;
   recall@10 >= 0.95 over all 16,384 queries and every score exact; a
   torch.profiler breakdown of one B=16384 call.

The line before the last is the kernels' JSON record; the last line is
`{"ok": true, "device": {...}}`. Without CUDA, or without the package
beside this script, it exits non-zero and prints no result.
"""

import argparse
import gc
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


_GC = {"ms": 0.0, "start": None}


def _gc_callback(phase, info):
    if phase == "start":
        _GC["start"] = time.perf_counter()
    elif _GC["start"] is not None:
        _GC["ms"] += (time.perf_counter() - _GC["start"]) * 1e3
        _GC["start"] = None


def gc_ms() -> float:
    """Host ms spent in Python's garbage collector since main() began
    (each host-clock window below reports its share)."""
    return _GC["ms"]


def device_allocs() -> int:
    """Device allocations the caching allocator has made (cudaMalloc
    calls) since the run began."""
    import torch

    return int(torch.cuda.memory_stats().get("num_device_alloc", -1))


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


def check_k1(a1, tag: str, reps: int = 20):
    """Hold K1 (qloc + quantize) bit-exact against its plain version on
    a1 = (vocab16, pair_list, top_c, top_v, QC) and time both beside its
    bound; returns (record, K1's int8 projections)."""
    import torch

    from seismic_tpu_torch.data.sparse import PAD_COMPONENT
    from seismic_tpu_torch.ops import qloc

    vocab16, pair_list, top_c, _, QC = a1
    k_i8, k_sc = qloc.project_qloc_quantize(*a1)
    p_i8, p_sc = qloc.project_qloc_quantize_plain(*a1)
    if not (torch.equal(k_i8, p_i8) and torch.equal(k_sc, p_sc)):
        fail(f"K1 ({tag}) disagrees: {(k_i8 != p_i8).sum().item()} i8 and "
             f"{(k_sc != p_sc).sum().item()} scale mismatches")
    P, V = pair_list.numel(), vocab16.shape[1]
    n_terms = (top_c != int(PAD_COMPONENT)).sum(1)  # [B] real terms
    nbytes = (torch.unique(pair_list).numel() * V * 2 + P * 4
              + top_c.numel() * 8 + P * V + P * 4)
    nops = 2.0 * V * QC * float(n_terms.sum().item())
    b, bb = bound(nbytes, nops, PEAK_F32)
    rec = dict(
        max_abs_err=float((k_i8.int() - p_i8.int()).abs().max().item()),
        ms=time_ms(lambda: qloc.project_qloc_quantize(*a1), reps),
        plain_ms=time_ms(lambda: qloc.project_qloc_quantize_plain(*a1), 3),
        bound_ms=b, bound_by=bb, library_ms=None, P=P, V=V)
    del p_i8, p_sc
    return rec, k_i8


def check_k3(a3, tag: str, reps: int = 20) -> dict:
    """Hold K3 (fused rescore) against its plain version at 1e-5 relative
    on a3 = (fwd_fused, ids, qc, qv, n_docs) and time both beside its
    bound."""
    import torch

    from seismic_tpu_torch.data.sparse import PAD_COMPONENT
    from seismic_tpu_torch.ops import rescore

    fwd_fused, ids, qc = a3[:3]
    k3 = rescore.score_docs_rowmajor(*a3)
    p3 = rescore.score_docs_rowmajor_plain(*a3)
    rel = ((k3 - p3).abs() / p3.abs().clamp_min(1e-30)).max().item()
    if not rel <= 1e-5:
        fail(f"K3 ({tag}) disagrees: max relative error {rel}")
    W2 = fwd_fused.shape[1]
    safe = ids.long().clamp(0, fwd_fused.shape[0] - 1)
    n_terms = (qc != int(PAD_COMPONENT)).sum(1)  # [B] real terms
    # bytes the function must move: each distinct row's real entries (4-byte
    # id + 4-byte value, each run rounded up to 32-byte sectors), the ids,
    # the query terms and the output
    uniq_nnz = (fwd_fused[torch.unique(safe), : W2 // 2]
                != int(PAD_COMPONENT)).sum(-1)
    nbytes = (2 * int(((uniq_nnz * 4 + 31) // 32 * 32).sum().item())
              + ids.numel() * 4 + qc.numel() * 8 + ids.numel() * 4)
    row_nnz = (fwd_fused[safe, : W2 // 2]
               != int(PAD_COMPONENT)).sum(-1)  # [B, R]
    nops = float((row_nnz * (2 * n_terms[:, None] + 2)).sum().item())
    b, bb = bound(nbytes, nops, PEAK_F32)
    return dict(
        max_abs_err=float((k3 - p3).abs().max().item()), max_rel_err=rel,
        ms=time_ms(lambda: rescore.score_docs_rowmajor(*a3), reps),
        plain_ms=time_ms(lambda: rescore.score_docs_rowmajor_plain(*a3), 3),
        bound_ms=b, bound_by=bb, library_ms=None, B=ids.shape[0],
        R=ids.shape[1])


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
    g0 = gc_ms()
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
    # the device program's own host-side costs: enqueue time, garbage
    # collections and fresh device allocations (cudaMalloc) inside it
    g_prog, n_alloc = gc_ms(), device_allocs()
    t.append(time.perf_counter())
    scores, ids = _grouped_impl(*args)
    t_enq = time.perf_counter()
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    prog = dict(enqueue_ms=(t_enq - t[3]) * 1e3, gc_ms=gc_ms() - g_prog,
                cuda_mallocs=device_allocs() - n_alloc)
    scores, ids = scores.cpu().numpy(), ids.cpu().numpy()
    t.append(time.perf_counter())
    out = {name: (t[i + 1] - t[i]) * 1e3 for i, name in enumerate(
        ("pad_queries_ms", "plan_ms", "upload_ms", "device_program_ms",
         "download_ms"))}
    out.update(gc_ms=gc_ms() - g0, device_program=prog)
    try:
        busy, kern = profile_device(lambda: _grouped_impl(*args))
        out.update(device_busy_ms=busy, kernels_ms=kern,
                   device_idle_share=max(
                       0.0, 1.0 - busy / out["device_program_ms"]))
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


# the bench headline path (bench.py:45-55, 73, 85, 514-536, 604-669) at
# BENCH_r05's rung qc14 / pool96 / r64
V0, CSUB, N_QUERIES, BIG_M = 512, 2, 16384, 16


def headline_params():
    from seismic_tpu_torch.search.grouped import GroupedParams

    return GroupedParams(k=K, score_cut=64, pool=96, rescore=64,
                         compute_dtype="i8", pool_mode="hier",
                         pool_per_pair=16, kernel_unroll=8,
                         pool_dtype="bf16", dedup_mode="post",
                         pool_recall=0.98)


def padded_queries(n: int):
    """`n` distinct queries padded to 64 terms per 1024 (bench.py:249-267:
    seeds 11, 12, ...)."""
    from seismic_tpu_torch.data.sparse import pad_queries
    from seismic_tpu_torch.harness.synth import synth_queries

    parts = []
    for i, c0 in enumerate(range(0, n, 1024)):
        c, v = synth_queries(min(1024, n - c0), dim=DIM, seed=11 + i)
        parts.append(pad_queries(c, v, 64))
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


def profile_device(fn):
    """(device busy ms, {kernel: ms}) of one call of `fn` from a
    torch.profiler window; raises when the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            kern[e.key[:80]] = kern.get(e.key[:80], 0.0) + us / 1e3
    busy = sum(kern.values())
    if busy <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return busy, dict(sorted(kern.items(), key=lambda kv: -kv[1])[:12])


def align_pair_order(host, derived):
    """The host plan with its pair tables moved to the derived plan's
    top-QC column order (the C++ planner's nth_element and the device's
    top-k order a query's lists differently; groups, slots and work items
    do not depend on it), so the two plans can be compared field by field
    and searched with bit-identical inputs."""
    import dataclasses

    B, QC = host.pair_list.shape
    big = np.iinfo(np.int32).max
    oh = np.argsort(np.where(host.pair_valid, host.pair_list, big), 1,
                    kind="stable")
    od = np.argsort(np.where(derived["pair_valid"], derived["pair_list"],
                             big), 1, kind="stable")
    rows = np.arange(B)[:, None]
    moved = {}
    for f in ("pair_slot", "pair_pstart", "pair_valid", "pair_list",
              "pair_len"):
        a = getattr(host, f)
        out = np.empty_like(a)
        out[rows, od] = a[rows, oh]
        moved[f] = out
    qmap = np.empty((B, QC), np.int64)
    qmap[rows, oh] = od
    sp = host.slot_pair.copy()
    real = host.slot_b.reshape(-1) < B
    b_of = sp[real] // QC
    sp[real] = b_of * QC + qmap[b_of, sp[real] % QC]
    moved["slot_pair"] = sp
    return dataclasses.replace(host, **moved)


def headline_path(ds, dev, record, kernels) -> dict:
    """Phase 4: the bench headline path through `plan_caps` and
    `search_grouped_derive`; returns K4's record and adds the path's
    launch counts to every kernel's record."""
    import torch

    from seismic_tpu_torch import Configuration, GlobalThresholdPruning
    from seismic_tpu_torch import TpuLayout
    from seismic_tpu_torch.build.builder import build_index
    from seismic_tpu_torch.data.sparse import PAD_COMPONENT
    from seismic_tpu_torch.ops import (
        grouped_scorer,
        grouped_scorer_item,
        qloc,
        rescore,
    )
    from seismic_tpu_torch.ops.tiles_prep import SUB, narrow_vocab
    from seismic_tpu_torch.search.grouped import (
        DevicePlan,
        _grouped_impl,
        _grouped_pool,
        _PLAN_FIELDS,
        _query_terms,
        derive_plan_device,
        plan_caps,
        search_grouped_derive,
    )
    from seismic_tpu_torch.search.planner import PlannerContext, plan_grouped

    rec = record.setdefault("headline", {})
    params = headline_params()
    ROWS = CSUB * SUB

    # ---- set-up: f32 build, narrowed to V0, uploaded with csub 2 ----
    cfg = Configuration(
        pruning=GlobalThresholdPruning(n_postings=200, max_fraction=2.0),
        layout=TpuLayout(max_block_len=32, summary_vocab_cap=V_CAP,
                         max_doc_nnz=256, tile_overflow=64),
    )
    t0 = time.time()
    arrays = build_index(ds, cfg, value_dtype="f32")
    t1 = time.time()
    arrays = narrow_vocab(arrays, V0)
    t2 = time.time()
    dindex = arrays.to_device(dev, tile_csub=CSUB)
    ctx = PlannerContext.from_arrays(arrays, csub=CSUB)
    t3 = time.time()
    del arrays
    gc.collect()
    q_comps, q_vals = padded_queries(N_QUERIES)
    nb = N_QUERIES // BATCH
    qcn = [q_comps[b * BATCH:(b + 1) * BATCH] for b in range(nb)]
    qvn = [q_vals[b * BATCH:(b + 1) * BATCH] for b in range(nb)]
    qcd = [torch.from_numpy(a).to(dev) for a in qcn]
    qvd = [torch.from_numpy(a).to(dev) for a in qvn]
    qcB = torch.from_numpy(q_comps).to(dev)
    qvB = torch.from_numpy(q_vals).to(dev)
    rec.update(index_build_s=t1 - t0, narrow_s=t2 - t1, upload_s=t3 - t2,
               device_index_bytes=dindex.nbytes(), V0=V0, csub=CSUB,
               queries=N_QUERIES)
    log(f"phase 4 setup: f32 index build {t1 - t0:.1f} s, narrow_vocab("
        f"{V0}) {t2 - t1:.1f} s, upload csub {CSUB} {t3 - t2:.1f} s, device "
        f"index bytes {rec['device_index_bytes']}")

    # ---- the derived plan against the host plan, every batch ----
    batches = [(qcn[b], qvn[b], qcd[b], qvd[b], 8) for b in range(nb)]
    batches.append((q_comps, q_vals, qcB, qvB, BIG_M))
    plans = []
    for i, (qc_np, qv_np, qc_t, qv_t, M) in enumerate(batches):
        host = plan_grouped(qc_np, qv_np, ctx, QUERY_CUT, M=M)
        dp = derive_plan_device(dindex, qc_t, qv_t, QUERY_CUT, M,
                                host.G_cap, host.W_cap, ctx.zero_region)
        G, W = int(dp.G), int(dp.W)
        if (G, W) != (host.G, host.W):
            fail(f"batch {i}: derived plan G, W = {G}, {W} but the host "
                 f"plan has {host.G}, {host.W} (a top-QC tie broken "
                 "differently)")
        if not (G < host.G_cap and W <= host.W_cap):
            fail(f"batch {i}: G, W = {G}, {W} past the caps "
                 f"{host.G_cap}, {host.W_cap}")
        d = {f: getattr(dp, f).cpu().numpy() for f in _PLAN_FIELDS}
        hal = align_pair_order(host, d)
        for f in _PLAN_FIELDS:
            a, b = getattr(hal, f), d[f]
            if f == "pair_slot":  # the dump slot of invalid pairs differs
                a, b = a[hal.pair_valid], b[d["pair_valid"]]
            if not np.array_equal(a, b):
                fail(f"batch {i}: derived plan field {f} differs from the "
                     "host plan's")
        plans.append((host, hal, dp))
        log(f"phase 4 plan {i} (B={len(qc_np)}, M={M}): derived == host, "
            f"G {G} <= {host.G_cap}, W {W} <= {host.W_cap}")
    rec["plans"] = [{"B": len(b[0]), "M": b[4], "G": p[0].G, "W": p[0].W,
                     "G_cap": p[0].G_cap, "W_cap": p[0].W_cap}
                    for b, p in zip(batches, plans)]
    # the same search through both plans: identical inputs to every stage
    for i in (0, nb):
        host, hal, dp = plans[i]
        qc_t, qv_t, M = batches[i][2], batches[i][3], batches[i][4]
        s_h, i_h = _grouped_impl(dindex, DevicePlan.put(hal, dev), qc_t,
                                 qv_t, params)
        s_d, i_d = search_grouped_derive(dindex, qc_t, qv_t, params,
                                         QUERY_CUT, M, host.G_cap,
                                         host.W_cap, ctx.zero_region)
        same = (torch.sort(i_h, 1).values == torch.sort(i_d, 1).values).all()
        fin = torch.isfinite(s_h)
        rel = ((s_h - s_d).abs()[fin]
               / s_h.abs()[fin].clamp_min(1e-30)).max().item()
        if not (bool(same) and torch.equal(fin, torch.isfinite(s_d))
                and rel <= 1e-5):
            fail(f"plan {i}: host-plan and derived-plan searches disagree "
                 f"(equal id sets {bool(same)}, score rel err {rel})")
        log(f"phase 4 plan {i}: host-plan search == derived-plan search "
            f"(id sets equal, max rel err {rel:.3g})")

    # ---- K1, K4 and K3 against their plain versions on the path's own
    # inputs: the derived plan's pairs and work list, the group queries
    # from K1, and the pool's real candidates (rescore = 64) ----
    at_headline = ({}, {})  # K1's and K3's records at the headline shapes

    def k4_inputs(i, tag):
        """K4's operands for plan i, as _grouped_impl builds them, after
        holding K1 (which makes its group queries) against its plain
        version."""
        qc_t, qv_t = batches[i][2], batches[i][3]
        dp = plans[i][2]
        top_c, top_v, sc = _query_terms(qc_t, qv_t, params.score_cut)
        rec1, q_i8 = check_k1(
            (dindex.vocab16, dp.pair_list.reshape(-1).contiguous(),
             top_c[:, :sc].contiguous(), top_v[:, :sc].contiguous(),
             dp.pair_list.shape[1]), f"headline {tag}")
        at_headline[0][tag] = rec1
        G_cap, M = dp.slot_b.shape
        q8 = q_i8[dp.slot_pair.long()].reshape(G_cap, M, V0).contiguous()
        return (dindex.doc_tiles_aligned, dindex.tile_scale, q8,
                dp.work_region, dp.work_g, CSUB)

    def check_k3_headline(i, tag):
        qc_t, qv_t = batches[i][2], batches[i][3]
        top_c, top_v, sc, _, cand_ids = _grouped_pool(
            dindex, plans[i][2], qc_t, qv_t, params)[:5]
        rp = params.rescore
        rec3 = check_k3((dindex.fwd_fused,
                         cand_ids[:, :rp].to(torch.int32).contiguous(),
                         top_c[:, :sc].contiguous(),
                         top_v[:, :sc].contiguous(), dindex.n_docs),
                        f"headline {tag}")
        at_headline[1][tag] = rec3
        for name, r in (("K1 qloc_quantize", at_headline[0][tag]),
                        ("K3 rescore_fused", rec3)):
            log(f"phase 4: {name} ({tag}): ok, max_abs_err "
                f"{r['max_abs_err']:.3g}, {r['ms']:.4f} ms (bound "
                f"{r['bound_ms']:.4f} ms by {r['bound_by']}, plain "
                f"{r['plain_ms']:.3f} ms)")

    k4 = {}
    for i, tag in ((0, "b4096_m8"), (nb, "b16384_m16")):
        a4 = k4_inputs(i, tag)
        W = plans[i][0].W
        k_out = grouped_scorer_item.score_grouped_i8_item(*a4)
        p_out = grouped_scorer_item.score_grouped_i8_item_plain(*a4)
        rel = ((k_out - p_out).abs() / p_out.abs().clamp_min(1e-30)).max()
        rel = rel.item()
        if not rel <= 1e-6:
            fail(f"K4 ({tag}) disagrees: max relative error {rel}")
        a4u = (a4[0], torch.ones_like(a4[1])) + a4[2:]
        kd = grouped_scorer_item.score_grouped_i8_item(*a4u)
        pd = grouped_scorer_item.grouped_dots_plain(
            a4[0], a4[2], a4[3], a4[4], rows_per_item=ROWS).to(torch.float32)
        if not torch.equal(kd, pd):
            fail(f"K4 ({tag}) int dots disagree with the plain version")
        M = a4[2].shape[1]
        n_regions = torch.unique(a4[3][:W]).numel()
        G = plans[i][0].G
        by4 = (n_regions * ROWS * (V0 + 4) + G * M * V0 + W * 8
               + W * M * ROWS * 4)
        ops4 = 2.0 * W * M * ROWS * V0
        b4, bb4 = bound(by4, ops4, PEAK_INT8)
        # library yardstick: one int8 tensor-core product with the same
        # operation count over the same gathered tile rows (one [V, M]
        # query block for all items: not the same function; never used)
        lib_ms = None
        try:
            rows = (a4[3][:W].long()[:, None] * ROWS
                    + torch.arange(ROWS, device=dev)).reshape(-1)
            A = a4[0][rows].view(torch.int8)
            Bq = a4[2][0].t()  # [V, M], column-major
            torch._int_mm(A, Bq)
            lib_ms = time_ms(lambda: torch._int_mm(A, Bq), 20)
            del A
        except Exception as e:  # noqa: BLE001 - the yardstick is optional
            log(f"  torch._int_mm yardstick unavailable: {e}")
        k4[tag] = dict(
            max_abs_err=float((k_out - p_out).abs().max().item()),
            max_rel_err=rel,
            ms=time_ms(lambda: grouped_scorer_item.score_grouped_i8_item(
                *a4), 20),
            plain_ms=time_ms(
                lambda: grouped_scorer_item.score_grouped_i8_item_plain(*a4),
                3),
            bound_ms=b4, bound_by=bb4, library_ms=lib_ms, W=W, G=G,
            W_cap=int(a4[3].shape[0]), M=M, distinct_super_tiles=n_regions,
            bytes=by4, ops=ops4)
        log(f"phase 4: K4 score_grouped_i8_item ({tag}): ok, max rel err "
            f"{rel:.3g}, {k4[tag]['ms']:.4f} ms (bound {b4:.4f} ms by "
            f"{bb4}, plain {k4[tag]['plain_ms']:.3f} ms, library {lib_ms})")
        del k_out, p_out, kd, pd, a4, a4u
        check_k3_headline(i, tag)
        torch.cuda.empty_cache()
    for kr, recs in zip((kernels[0], kernels[2]), at_headline):
        kr["at_headline"] = recs

    # ---- timed window: QPS as bench.py times it ----
    def once(b):
        gc_, wc_ = plan_caps(qcn[b], qvn[b], ctx, QUERY_CUT, M=8)
        return search_grouped_derive(dindex, qcd[b], qvd[b], params,
                                     QUERY_CUT, 8, gc_, wc_,
                                     ctx.zero_region)

    gcB, wcB = plan_caps(q_comps, q_vals, ctx, QUERY_CUT, M=BIG_M)

    def once_big():
        return search_grouped_derive(dindex, qcB, qvB, params, QUERY_CUT,
                                     BIG_M, gcB, wcB, ctx.zero_region)

    for b in range(nb):  # warm-up (allocator, first launches)
        once(b)
    once_big()
    torch.cuda.synchronize()
    mods = (qloc, grouped_scorer, grouped_scorer_item, rescore)
    for m in mods:
        m.launches = 0
    g0 = gc_ms()
    t0 = time.perf_counter()
    outs = [None] * nb
    for _ in range(REPS):
        for b in range(nb):
            outs[b] = once(b)
    torch.cuda.synchronize()
    el4 = time.perf_counter() - t0
    g1 = gc_ms()
    t0 = time.perf_counter()
    for _ in range(REPS):
        out_big = once_big()
    torch.cuda.synchronize()
    el16 = time.perf_counter() - t0
    gc_qps = {"b4096_ms": g1 - g0, "b16384_ms": gc_ms() - g1}
    counts = dict(zip(("qloc", "score_grouped_i8", "score_grouped_i8_item",
                       "rescore"), (m.launches for m in mods)))
    qps4 = REPS * nb * BATCH / el4
    qps16 = REPS * N_QUERIES / el16
    log(f"phase 4: QPS(B={BATCH}, M=8) {qps4:.1f} over {REPS} x {nb} "
        f"batches ({el4:.3f} s, plan_caps included); QPS(B={N_QUERIES}, "
        f"M={BIG_M}) {qps16:.1f} over {REPS} calls ({el16:.3f} s); launches "
        f"{counts}; gc {json.dumps(gc_qps)}")
    if min(counts["qloc"], counts["score_grouped_i8_item"],
           counts["rescore"]) <= 0 or counts["score_grouped_i8"] != 0:
        fail(f"headline path launches {counts}: K1, K4 and K3 must launch "
             "and K2 must not")
    for kr, name in zip(kernels, ("qloc", "score_grouped_i8", "rescore")):
        kr["launches_headline"] = counts[name]
    lat = []
    for _ in range(10):
        t0 = time.perf_counter()
        once(0)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    p50 = float(np.median(lat))
    log(f"phase 4: p50 of a synchronised B={BATCH} call {p50 * 1e3:.2f} ms")

    # ---- no host syncs from the query tensors to the result tensors ----
    torch.cuda.set_sync_debug_mode("error")
    try:
        once_big()
    except RuntimeError as e:
        fail(f"search_grouped_derive synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("phase 4: one B=16384 search_grouped_derive ran under "
        "set_sync_debug_mode('error')")

    # ---- results: shapes, finite, exact scores, recall@10 ----
    s4 = torch.cat([o[0] for o in outs])
    i4 = torch.cat([o[1] for o in outs])
    s16, i16 = out_big
    for s_, i_ in ((s4, i4), (s16, i16)):
        if s_.shape != (N_QUERIES, K) or not torch.isfinite(s_).all():
            fail("headline results are not finite [16384, 10]")
        if not (s_[:, 1:] <= s_[:, :-1]).all():
            fail("headline scores are not descending")
    docs = torch.sparse_csr_tensor(
        torch.from_numpy(ds.offsets), torch.from_numpy(
            ds.components.astype(np.int64)),
        torch.from_numpy(ds.values.astype(np.float32)),
        size=(len(ds), DIM)).to(dev)
    gt = []
    worst = 0.0
    for c0 in range(0, N_QUERIES, 2048):
        qc_t, qv_t = qcB[c0:c0 + 2048], qvB[c0:c0 + 2048]
        n = qc_t.shape[0]
        ok = qc_t != int(PAD_COMPONENT)
        col = torch.arange(n, device=dev)[:, None].expand_as(qc_t)
        qd = torch.zeros((DIM, n), dtype=torch.float32, device=dev)
        qd[qc_t[ok].long(), col[ok]] = qv_t[ok]
        exact = torch.sparse.mm(docs, qd)  # [n_docs, n]
        gt.append(torch.topk(exact, K, dim=0).indices.t())
        # every returned score is the exact dot of its doc
        ex = exact.t().gather(1, i4[c0:c0 + n])
        worst = max(worst, ((s4[c0:c0 + n] - ex).abs()
                            / ex.abs().clamp_min(1e-30)).max().item())
        del exact, qd
    if not worst <= 1e-4:
        fail(f"headline scores differ from exact dots by {worst} relative")
    gt = torch.cat(gt).cpu().numpy()

    def recall(ids):
        ids = ids.cpu().numpy()
        return sum(len(set(g.tolist()) & set(r.tolist()))
                   for g, r in zip(gt, ids)) / (K * len(gt))

    rec4, rec16 = recall(i4), recall(i16)
    log(f"phase 4: recall@10 {rec4:.4f} (B={BATCH} batches) and {rec16:.4f} "
        f"(B={N_QUERIES}) on {N_QUERIES} queries; protocol target 0.97; "
        f"scores exact to {worst:.3g}")
    if rec4 < 0.95 or rec16 < 0.95:
        fail(f"headline recall@10 {rec4:.4f} / {rec16:.4f} < 0.95")
    del docs

    # ---- where one B=16384 call's time goes ----
    t0 = time.perf_counter()
    plan_caps(q_comps, q_vals, ctx, QUERY_CUT, M=BIG_M)
    caps16_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    plan_caps(qcn[0], qvn[0], ctx, QUERY_CUT, M=8)
    caps4_ms = (time.perf_counter() - t0) * 1e3
    # the host returns from the call long before the device finishes when
    # nothing in it waits for the device (the sync debug mode above is a
    # prototype that may miss some synchronising operations)
    g0, n_alloc = gc_ms(), device_allocs()
    t0 = time.perf_counter()
    once_big()
    t_enq = time.perf_counter()
    torch.cuda.synchronize()
    prog_ms = (time.perf_counter() - t0) * 1e3
    brk = {"plan_caps_b4096_ms": caps4_ms, "plan_caps_b16384_ms": caps16_ms,
           "device_program_b16384_ms": prog_ms,
           "host_enqueue_b16384_ms": (t_enq - t0) * 1e3,
           "gc_ms": gc_ms() - g0,
           "cuda_mallocs": device_allocs() - n_alloc}
    try:
        busy, kern = profile_device(once_big)
        brk.update(device_busy_ms=busy,
                   device_idle_share=max(0.0, 1.0 - busy / prog_ms),
                   kernels_ms=kern)
        # the device's share of one B=4096 batch (its caps computed first)
        gc0, wc0 = plan_caps(qcn[0], qvn[0], ctx, QUERY_CUT, M=8)
        brk["device_busy_b4096_ms"] = profile_device(
            lambda: search_grouped_derive(dindex, qcd[0], qvd[0], params,
                                          QUERY_CUT, 8, gc0, wc0,
                                          ctx.zero_region))[0]
    except Exception as e:  # noqa: BLE001 - informational only
        brk["profile"] = f"not measured: {e}"
    log(f"phase 4 breakdown of one B={N_QUERIES} call: {json.dumps(brk)}")

    rec.update(qps_b4096_m8=qps4, qps_b16384_m16=qps16, p50_b4096_ms=p50 * 1e3,
               latencies_b4096_s=lat, recall_at_10_b4096=rec4,
               recall_at_10_b16384=rec16, max_rel_score_err=worst,
               launches=counts, k4=k4, breakdown=brk, gc_qps_windows=gc_qps,
               peak_device_bytes=torch.cuda.max_memory_allocated())
    main4 = k4["b4096_m8"]
    return dict(
        name="score_grouped_i8_item", route="cuda",
        source="seismic_tpu_torch/csrc/grouped_scorer_item.cu",
        replaces="seismic_tpu/ops/pallas_grouped.py:326",
        launches=counts["score_grouped_i8_item"],
        launches_headline=counts["score_grouped_i8_item"],
        max_abs_err=main4["max_abs_err"], ms=main4["ms"],
        plain_ms=main4["plain_ms"], bound_ms=main4["bound_ms"],
        bound_by=main4["bound_by"], library_ms=main4["library_ms"],
        at_b16384_m16={k: k4["b16384_m16"][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
    )


def api_path(ds, dev, record) -> list:
    """Phases 2 and 3 on the API's grouped route (K1-K3); returns the
    kernels' records. Everything it builds is freed when it returns."""
    import torch

    from seismic_tpu_torch import (
        Configuration,
        GlobalThresholdPruning,
        SeismicIndexRaw,
        TpuLayout,
    )
    from seismic_tpu_torch.data.sparse import PAD_COMPONENT, pad_queries
    from seismic_tpu_torch.ops import grouped_scorer, qloc, rescore
    from seismic_tpu_torch.ops.tiles_prep import SUB, ll_pad_for
    from seismic_tpu_torch.search.grouped import DevicePlan, _top_k
    from seismic_tpu_torch.search.planner import plan_grouped_numpy

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
    log(f"setup: index build {build_index_s:.1f} s, upload {upload_s:.1f} "
        f"s, n_docs {ds.offsets.shape[0] - 1}, nnz {ds.nnz}, device index "
        f"bytes {device_bytes}")
    record.update(index_build_s=build_index_s, upload_s=upload_s,
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
    kernels = []
    reps = 20

    # K1: qloc + quantize
    pair_list = dplan.pair_list.reshape(P).contiguous()
    k1, k_i8 = check_k1((dindex.vocab16, pair_list, top_c, top_v, QC), "API")
    V = k1["V"]
    kernels.append(dict(
        name="qloc_quantize", route="cuda",
        source="seismic_tpu_torch/csrc/qloc.cu",
        replaces="seismic_tpu/ops/pallas_qloc.py:25", **k1))

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
    k3 = check_k3((dindex.fwd_fused, ids, top_c, top_v, arrays.n_docs),
                  "API", reps)
    kernels.append(dict(
        name="rescore_fused", route="cuda",
        source="seismic_tpu_torch/csrc/rescore.cu",
        replaces="seismic_tpu/ops/pallas_rescore.py:30", **k3))
    for kr in kernels:
        log(f"phase 2: {kr['name']}: ok, max_abs_err {kr['max_abs_err']:.3g}"
            f", {kr['ms']:.4f} ms (bound {kr['bound_ms']:.4f} ms by "
            f"{kr['bound_by']}, plain {kr['plain_ms']:.3f} ms, library "
            f"{kr['library_ms']})")
    del k_i8, q8
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
    g0 = gc_ms()
    for _ in range(REPS):
        res, dt = run()
        lat.append(dt)
    gc3 = gc_ms() - g0
    counts = [m.launches for m in mods]
    for kr, c in zip(kernels, counts):
        kr["launches"] = c
    if min(counts) <= 0:
        fail(f"a kernel of the main path never launched: {counts}")
    p50 = float(np.median(lat))
    qps = BATCH * REPS / sum(lat)  # all queries over the whole window
    log(f"phase 3: {REPS} warm batches of {BATCH}: p50 "
        f"{p50 * 1e3:.2f} ms, QPS {qps:.1f}, launches qloc/scorer/rescore "
        f"{counts}, gc {gc3:.2f} ms")

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

    record.update(
        qps=qps, p50_ms=p50 * 1e3, batch=BATCH, reps=REPS, gc_ms=gc3,
        latencies_s=lat, recall_at_10=recall, recall_queries=nq,
        peak_device_bytes=torch.cuda.max_memory_allocated(),
        plan={"G": plan.G, "W": plan.W, "G_cap": plan.G_cap,
              "W_cap": plan.W_cap, "P": P, "LLMAX": LLMAX},
    )
    return kernels


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
    from seismic_tpu_torch.harness.synth import synth_dataset
    from seismic_tpu_torch.ops import _cuda

    t_start = time.time()
    gc.callbacks.append(_gc_callback)
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

    # ---------------- set-up of the main paths (host build) ----------------
    t0 = time.time()
    ds = synth_dataset(args.n_docs, dim=DIM, seed=7)
    synth_s = time.time() - t0
    log(f"setup: synth {synth_s:.1f} s")
    record.update(n_docs=len(ds), synth_s=synth_s,
                  rehearsal=args.n_docs < N_DOCS)

    # ---------------- phases 2 and 3: the API route ----------------
    kernels = api_path(ds, dev, record)
    gc.collect()
    torch.cuda.empty_cache()

    # ---------------- phase 4: the bench headline path ----------------
    torch.cuda.reset_peak_memory_stats()
    kernels.append(headline_path(ds, dev, record, kernels))

    total_s = time.time() - t_start
    record.update(kernels=kernels, total_s=total_s)
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
