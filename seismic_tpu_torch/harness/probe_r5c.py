"""Round-5 probe C: the 1M-document rungs (the bar: recall@10 >= 0.97 at
>= 20K QPS), each rung's recall@10, ms a batch and QPS.

The port of `seismic_tpu/harness/probe_r5c.py`, rung for rung: the 1M
recipe's environment defaults (1M docs, 2048 queries, batch 2048,
n_postings 400, tile_overflow 0), the width argument (1024 reads the
index dir, any other W its `_nw{W}` dir), and the families

  lever   the QPS levers stacked on the i8 knn8 recipe (approx pool
          512, rescore 256, qc 16): pool_dtype bf16, knn_top 4, dedup
          "post", pool_recall 0.9
  deep    rescore depth and qc on top of the levers
  bar     the adaptive family: the best measured rung's neighbourhood
  stage   the stage budget (`stop_after` at six stages)
  b4k     4096 distinct queries a batch (the stream continues the
          cached one: its first 2048 must equal it), recall on those 2048
  lean16  the half-width forward rows (`R5C_FWD16=1`: `to_device(
          fwd_f16=True)`, K3's f16 form), rescore_chunk 128
  b4kf    b4k on the half-width rows, M 8 and 16

at B 2048, M 8 (`plan_caps` on the host, `search_grouped_derive` on the
card: K1, K4, K3, K3 again for the graph's round). The cache
(`rebuild_r3_cache.py 1m`) holds the index, the ground truth and the
knn16 graph; the aligned layout comes from `ops/tiles_prep.py::
load_or_build_aligned`. Labels already in the record are skipped (their
rows answer the bar family). The record goes to the section
`rungs_r5_bar` of `chiprun_out/scale_bench.json` (`--record`), never to
the repo root's `SCALE_BENCH.json`.

    python -m seismic_tpu_torch.harness.probe_r5c [width] [family ...] \\
        [--cache-dir DIR] [--record PATH] [--device DEV]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np

from . import protocol
from .protocol import launches_since, log, recall_at_k
from ..ops.tiles_prep import load_or_build_aligned
from ..search.grouped import GroupedParams, plan_caps, search_grouped_derive
from ..search.knn import load_knn
from ..search.planner import PlannerContext
from ..types import KNN_SUFFIX, IndexArrays

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
RECORD = os.path.join(ROOT, "chiprun_out", "scale_bench.json")
SECTION = "rungs_r5_bar"
FAMILIES = ("lever", "deep", "bar", "stage", "b4k", "lean16", "b4kf")
DEFAULTS = {"BENCH_N_DOCS": "1000000", "BENCH_N_QUERIES": "2048",
            "BENCH_BATCH": "2048", "BENCH_N_POSTINGS": "400",
            "BENCH_TILE_OVERFLOW": "0"}
BAR_RECALL = 0.97
BAR_QPS = 20000.0
B, M = 2048, 8
STAGES = ("qloc", "expand", "kernel", "regroup", "pool", "prerank")
# the fields of the index the 1M route never reads
UNREAD = ("tile_ovf_comps", "tile_ovf_vals", "summary_comps",
          "summary_codes", "dense_summary", "dense_scale", "block_sketch",
          "block_sketch_scale", "doc_sketch", "doc_sketch_scale")
NOTE = ("round-5 1M bar rungs (probe_r5c, the port on the card): "
        "pool_mode=approx, knn_top + dedup_mode=post and pool_dtype=bf16 "
        "as QPS levers, rescore depth and qc for recall. Bar: "
        "recall>=0.97 at >=20K QPS")


def main(argv=None) -> dict:
    """Returns {"rows": the rungs run now, "record": the record's path,
    "device_bytes": the index's bytes on the card (the graph in)}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("args", nargs="*",
                    help=f"[width] then any of {' '.join(FAMILIES)} "
                    "(default: 1024 lever deep)")
    ap.add_argument("--cache-dir", default=protocol.CACHE)
    ap.add_argument("--record", default=RECORD)
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' runs the plain versions")
    ns = ap.parse_args(argv)
    args = list(ns.args)
    W = int(args.pop(0)) if args and args[0].isdigit() else 1024
    bad = set(args) - set(FAMILIES)
    if bad:
        ap.error(f"unknown families {sorted(bad)}")
    fams = set(args) or {"lever", "deep"}

    import torch

    from ..device import resolve_device

    dev = resolve_device(ns.device)
    p = protocol.from_env(defaults=DEFAULTS, cache=ns.cache_dir)
    base = p.index_base
    log(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}")
    q_comps, q_vals = protocol.get_queries(p.n_queries, p.dim)
    with np.load(p.gt_path(len(q_comps))) as z:
        gt_ids = z["ids"]
    knn_path = base + ".knn16"
    graph = (load_knn(knn_path) if os.path.exists(knn_path + KNN_SUFFIX)
             else None)
    log(f"knn graph: {'loaded' if graph is not None else 'MISSING'}")

    path = base + ".dir" if W == 1024 else base + f"_nw{W}.dir"
    t0 = time.time()
    arrays = IndexArrays.load_dir(path)
    for f in UNREAD:
        setattr(arrays, f, None)
    # R5C_FWD16=1: the half-width forward rows (comp int16 | f16 value a
    # 32-bit word), K3's f16 form
    fwd16 = os.environ.get("R5C_FWD16", "0") == "1"
    aligned = load_or_build_aligned(arrays, path, p.csub)
    index = arrays.to_device(dev, tile_csub=p.csub, fwd_f16=fwd16,
                             aligned=aligned)
    ctx = PlannerContext.from_arrays(arrays, csub=p.csub)
    hbm = index.nbytes()
    if graph is not None:
        index = protocol.with_knn(index, graph)
        hbm += int(graph.nbytes)
    protocol.sync(dev)
    log(f"[W={W}] load+to_device+ctx: {time.time()-t0:.1f}s "
        f"HBM={hbm/1e9:.2f}GB")

    qn, vn = q_comps[:B], q_vals[:B]
    nq = len(qn)  # B, or fewer on a cut stream: the rates count these
    qd = torch.from_numpy(np.ascontiguousarray(qn, np.int32)).to(dev)
    vd = torch.from_numpy(np.ascontiguousarray(vn, np.float32)).to(dev)
    gt = gt_ids[:B]
    record = protocol.read_record(ns.record)
    rows = record.get(SECTION, {}).get("rungs", [])
    done = {r.get("label") for r in rows}
    meta = {"W": W, "batch": B, "M": M, "device_bytes": hbm,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else str(dev))}
    if fwd16:
        meta["device_bytes_fwd16"] = hbm
    caps = {}
    run_now = []

    def write(row):
        rows.append(row)
        run_now.append(row)
        art = protocol.read_record(ns.record)
        art[SECTION] = {"note": NOTE, **meta, "rungs": rows}
        protocol.write_record(ns.record, art)

    def timed(fn, reps):
        out = fn()
        protocol.sync(dev)
        t0 = time.time()
        for _ in range(reps):
            out = fn()
        protocol.sync(dev)
        return out, (time.time() - t0) / reps

    def run(gp, qcut, label, reps=4, stage=False):
        if label in done:
            log(f"{label}: skipped (already measured)")
            prior = next(r for r in rows if r.get("label") == label)
            ms = prior.get("ms_per_batch")
            rec = prior.get("recall_at_10")
            return ((ms / 1e3) if isinstance(ms, (int, float)) else None,
                    rec if isinstance(rec, float) else None)
        if qcut not in caps:
            caps[qcut] = plan_caps(qn, vn, ctx, qcut, M=M)
        gc, wc = caps[qcut]
        before = protocol.kernel_launches()

        def call(g=gp):
            return search_grouped_derive(index, qd, vd, g, qcut, M, gc, wc,
                                         ctx.zero_region)

        out, dt = timed(call, reps)
        launched = launches_since(before)
        rec = recall_at_k(out[1].cpu().numpy(), gt)
        log(f"{label}: {dt*1e3:7.2f} ms  recall@10={rec:.4f} "
            f"QPS={nq/dt:,.0f}")
        row = {"label": label, "W": W, "query_cut": qcut,
               "pool": gp.pool, "rescore": gp.rescore,
               "compute_dtype": gp.compute_dtype,
               "pool_dtype": gp.pool_dtype, "n_knn": gp.n_knn,
               "knn_top": gp.knn_top, "dedup_mode": gp.dedup_mode,
               "fwd_f16": fwd16, "rescore_chunk": gp.rescore_chunk,
               "ms_per_batch": round(dt * 1e3, 2),
               "qps": round(nq / dt, 1), "recall_at_10": round(rec, 4),
               "launches": launched}
        if stage:
            budget = {}
            for st in STAGES:
                gs = dataclasses.replace(gp, stop_after=st)
                try:
                    _, bt = timed(lambda: call(gs), 3)
                    budget[st] = round(bt * 1e3, 2)
                except Exception as e:  # noqa: BLE001 - the rung's note
                    budget[st] = f"err {type(e).__name__}"
            row["stage_ms_cum"] = budget
            log(f"  stage budget (cumulative): {budget}")
        write(row)
        return dt, rec

    def safe(gp, qcut, label, **kw):
        try:
            return run(gp, qcut, label, **kw)
        except Exception as e:  # noqa: BLE001 - one rung's failure, logged
            log(f"{label}: FAILED {type(e).__name__}: {e}")
            return None, None

    rep = dataclasses.replace
    # the i8 knn8 recipe: approx pool 512, rescore 256
    base = GroupedParams(k=10, score_cut=64, pool=512, rescore=256,
                         compute_dtype="i8", pool_mode="approx",
                         pool_per_pair=0, kernel_unroll=8, n_knn=8)

    if "stage" in fams:
        safe(base, 16, "i8_knn8_qc16_p512r256_stage", stage=True)

    if "lever" in fams:
        safe(rep(base, pool_dtype="bf16"), 16, "i8_knn8_pdt_qc16_p512r256")
        safe(rep(base, pool_dtype="bf16", knn_top=4), 16,
             "i8_knn8top4_pdt_qc16_p512r256")
        safe(rep(base, pool_dtype="bf16", knn_top=4, dedup_mode="post"), 16,
             "i8_knn8top4_pdt_ddpost_qc16_p512r256")
        safe(rep(base, pool_dtype="bf16", knn_top=4, dedup_mode="post",
                 pool_recall=0.9), 16,
             "i8_knn8top4_pdt_ddpost_pr90_qc16_p512r256")

    lev = rep(base, pool_dtype="bf16", knn_top=4, dedup_mode="post")
    if "deep" in fams:
        safe(rep(lev, rescore=384), 16,
             "i8_knn8top4_pdt_ddpost_qc16_p512r384")
        safe(rep(lev, pool=768, rescore=384), 16,
             "i8_knn8top4_pdt_ddpost_qc16_p768r384")
        safe(lev, 20, "i8_knn8top4_pdt_ddpost_qc20_p512r256")

    if "bar" in fams:
        # the highest-recall measured recipe's cheapest neighbourhood
        best = max((r for r in rows
                    if isinstance(r.get("recall_at_10"), float)),
                   key=lambda r: r["recall_at_10"], default=None)
        if best and best["recall_at_10"] >= BAR_RECALL:
            safe(rep(lev, pool=max(256, best["pool"] // 2),
                     rescore=best["rescore"]), best["query_cut"],
                 f"bar_halfpool_qc{best['query_cut']}")
        else:
            safe(rep(lev, pool=768, rescore=512), 20,
                 "i8_knn8top4_pdt_ddpost_qc20_p768r512")
            safe(rep(lev, n_knn=16, knn_top=4, rescore=384), 16,
                 "i8_knn16top4_pdt_ddpost_qc16_p512r384")

    if "lean16" in fams:
        if not fwd16:
            raise ValueError("run family lean16 with R5C_FWD16=1")
        safe(lev, 20, "f16_knn8top4_pdt_ddpost_qc20_p512r256")
        safe(rep(lev, rescore=384, rescore_chunk=128), 16,
             "f16_knn8top4_pdt_ddpost_qc16_p512r384c128")
        safe(rep(lev, rescore=384, rescore_chunk=128), 20,
             "f16_knn8top4_pdt_ddpost_qc20_p512r384c128")
        safe(rep(lev, n_knn=16, rescore=384, rescore_chunk=128), 16,
             "f16_knn16top4_pdt_ddpost_qc16_p512r384c128")

    if fams & {"b4k", "b4kf"}:
        # 4096 distinct queries a batch: the stream continues the cached
        # one, so its first 2048 have the ground truth
        q4, v4 = protocol.get_queries(4096, p.dim)
        if not np.array_equal(q4[:2048], qn):
            raise AssertionError("query stream mismatch")
        q4d = torch.from_numpy(np.ascontiguousarray(q4, np.int32)).to(dev)
        v4d = torch.from_numpy(np.ascontiguousarray(v4, np.float32)).to(dev)

        def run4k(gp, qcut, label, reps=4, M4=M):
            if label in done:
                log(f"{label}: skipped (already measured)")
                return
            gc, wc = plan_caps(q4, v4, ctx, qcut, M=M4)
            before = protocol.kernel_launches()
            out, dt = timed(lambda: search_grouped_derive(
                index, q4d, v4d, gp, qcut, M4, gc, wc, ctx.zero_region),
                reps)
            rec = recall_at_k(out[1].cpu().numpy()[:2048], gt)
            log(f"{label}: {dt*1e3:7.2f} ms  recall@10={rec:.4f} "
                f"QPS={len(q4)/dt:,.0f}")
            write({"label": label, "W": W, "batch": len(q4), "M": M4,
                   "query_cut": qcut, "pool": gp.pool,
                   "rescore": gp.rescore, "n_knn": gp.n_knn,
                   "knn_top": gp.knn_top, "dedup_mode": gp.dedup_mode,
                   "fwd_f16": fwd16, "rescore_chunk": gp.rescore_chunk,
                   "ms_per_batch": round(dt * 1e3, 2),
                   "qps": round(len(q4) / dt, 1),
                   "recall_at_10": round(rec, 4),
                   "launches": launches_since(before)})

        def safe4k(gp, qcut, lbl, m4=M):
            try:
                run4k(gp, qcut, lbl, M4=m4)
            except Exception as e:  # noqa: BLE001 - one rung, logged
                log(f"{lbl}: FAILED {type(e).__name__}: {e}")

        if "b4k" in fams:
            for gp, qcut, lbl in (
                (lev, 20, "b4k_knn8top4_pdt_ddpost_qc20_p512r256"),
                (lev, 16, "b4k_knn8top4_pdt_ddpost_qc16_p512r256"),
                (rep(lev, pool=256, rescore=256), 20,
                 "b4k_knn8top4_pdt_ddpost_qc20_p256r256"),
            ):
                safe4k(gp, qcut, lbl)

        if "b4kf" in fams:
            if not fwd16:
                raise ValueError("run family b4kf with R5C_FWD16=1")
            levc = rep(lev, rescore_chunk=128)
            for gp, qcut, lbl, m4 in (
                (levc, 20, "b4kf_knn8top4_pdt_ddpost_qc20_p512r256", 8),
                (levc, 20, "b4kf_m16_knn8top4_pdt_ddpost_qc20_p512r256",
                 16),
                (rep(levc, rescore=384), 16,
                 "b4kf_m16_knn8top4_pdt_ddpost_qc16_p512r384c128", 16),
                (rep(levc, rescore=384), 20,
                 "b4kf_m16_knn8top4_pdt_ddpost_qc20_p512r384c128", 16),
            ):
                safe4k(gp, qcut, lbl, m4)

    best = max((r for r in rows if isinstance(r.get("recall_at_10"),
                                              float)),
               key=lambda r: (r["recall_at_10"] >= BAR_RECALL, r["qps"]),
               default=None)
    if best:
        log(f"best rung: {best['label']} recall={best['recall_at_10']} "
            f"QPS={best['qps']:,.0f} (bar: >={BAR_RECALL} at "
            f">={BAR_QPS:,.0f})")
    log(f"wrote {ns.record} {SECTION}")
    return {"rows": run_now, "record": ns.record, "device_bytes": hbm}


if __name__ == "__main__":
    main()
