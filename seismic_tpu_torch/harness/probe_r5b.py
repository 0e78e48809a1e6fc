"""Round-5 probe B: the headline path's throughput levers at the 100K
bench point, every rung's recall@10, ms a batch and QPS.

The port of `seismic_tpu/harness/probe_r5b.py`, rung for rung: the same
families, labels, `GroupedParams`, query cuts, M, csub and batch. At the
headline shapes (100K documents, the v1024 f32 index narrowed to V 512,
`tile_csub=2`, B 16384, M 16; `plan_caps` on the host, then
`search_grouped_derive` on the card):

  grid   base (hier pool, qc 13, pool 96 / rescore 64; with the stage
         budget: `stop_after` at each of six stages), the stride pool
         (exact and approx selection: K4 + K5), rowmajor qloc (K8),
         score_cut 48, dedup "post"
  grid2  ddpost at qc 14, stride 4 / 2, stride 4 with ddpost
  pdt    pool_dtype bf16 (with the stage budget), with ddpost, pool_recall
  seg    the two-level segment pool, widths 32 / 128, approx selection
  m32    M 32 plan groups (K4 at M 32)
  knn    knn16 refinement of the top 4 / 2 / all heap entries (K3 twice)
  2pass  the adaptive two-pass driver (`search_batch_twopass`)
  b1     one query a call, M 8, 200 calls a rung (`b1_exact_ddpost_u1`:
         kernel_unroll 1, K2)
  csub4  a `tile_csub=4` upload: the base rung and the stride pool (K4
         and K5 at csub 4)

The index comes from the cache (`rebuild_r3_cache.py` makes it): the
`_nw512` dir when it is there, else the v1024 dir narrowed here; its
aligned layout from `ops/tiles_prep.py::load_or_build_aligned` (beside
the dir), the knn16 graph when cached. Labels already in the record are
skipped. Every rung's row also holds the kernels it launched (the
wrappers' counts before and after). All families run in one process
(JAX's ran one a process, for its chip's 16 GB). The record goes to
`chiprun_out/bench_stage_r5.json` (`--record`), never to the repo root.

    python -m seismic_tpu_torch.harness.probe_r5b [family ...] \\
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
from ..ops.tiles_prep import load_or_build_aligned, narrow_vocab
from ..search.grouped import GroupedParams, plan_caps, search_grouped_derive
from ..search.knn import load_knn
from ..search.planner import PlannerContext
from ..search.twopass import TwoPassParams, search_batch_twopass
from ..types import KNN_SUFFIX, IndexArrays

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
RECORD = os.path.join(ROOT, "chiprun_out", "bench_stage_r5.json")
FAMILIES = ("grid", "grid2", "knn", "2pass", "b1", "csub4", "pdt", "m32",
            "seg")
# the headline bench config: 100K docs, narrowed V 512 topv tiles
DEFAULTS = {"BENCH_N_DOCS": "100000", "BENCH_N_QUERIES": "16384"}
B, M = 16384, 16
REPS = 4  # timed calls a rung, after one warm call
STAGES = ("qloc", "expand", "kernel", "regroup", "pool", "prerank")
NOTE = ("round-5 headline throughput grid (probe_r5b, the port on the "
        "card): pool-mode / qloc-mode / score-cut / knn_top / csub levers "
        "at B=16384 M=16, 100K docs, narrowed V=512 tiles")
# the fields of the index the headline route never reads
UNREAD = ("dense_summary", "dense_scale", "block_sketch",
          "block_sketch_scale", "doc_sketch", "doc_sketch_scale")


def base_params() -> GroupedParams:
    """The round-4 headline recipe (qc 13, pool 96 / rescore 64)."""
    return GroupedParams(k=10, score_cut=64, pool=96, rescore=64,
                         compute_dtype="i8", pool_mode="hier",
                         pool_per_pair=16, kernel_unroll=8)


def load_arrays(p):
    """(arrays, arrays_dir, knn graph or None): the narrowed index from
    its cached dir (arrays_dir, which keys the aligned cache) or narrowed
    here (arrays_dir None), the fields the route never reads dropped."""
    base = p.index_base
    nw = base + f"_nw{p.narrow_v}.dir"
    if os.path.isdir(nw):
        arrays, arrays_dir = IndexArrays.load_dir(nw), nw
    else:
        arrays = narrow_vocab(IndexArrays.load_dir(base + ".dir"),
                              p.narrow_v)
        arrays_dir = None
    for f in UNREAD:
        setattr(arrays, f, None)
    knn_path = base + ".knn16"
    graph = (load_knn(knn_path) if os.path.exists(knn_path + KNN_SUFFIX)
             else None)
    return arrays, arrays_dir, graph


def main(argv=None) -> dict:
    """Returns {"rows": the rungs run now (as written to the record),
    "ids": {label: the last call's top-10 ids}, "record": the record's
    path}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("families", nargs="*",
                    help=f"any of {' '.join(FAMILIES)} (default: all)")
    ap.add_argument("--cache-dir", default=protocol.CACHE)
    ap.add_argument("--record", default=RECORD)
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    bad = set(args.families) - set(FAMILIES)
    if bad:
        ap.error(f"unknown families {sorted(bad)}")
    fams = set(args.families) or set(FAMILIES)

    import torch

    from ..device import resolve_device

    dev = resolve_device(args.device)
    p = protocol.from_env(defaults=DEFAULTS, cache=args.cache_dir)
    log(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}")
    q_comps, q_vals = protocol.get_queries(p.n_queries, p.dim)
    with np.load(p.gt_path(len(q_comps))) as z:
        gt_ids = z["ids"]
    t0 = time.time()
    arrays, arrays_dir, graph = load_arrays(p)
    log(f"arrays loaded: {time.time()-t0:.1f}s  knn="
        f"{'yes' if graph is not None else 'no'}")

    qn, vn = q_comps[:B], q_vals[:B]
    nq = len(qn)  # B, or fewer on a cut stream: the rates count these
    qd = torch.from_numpy(np.ascontiguousarray(qn, np.int32)).to(dev)
    vd = torch.from_numpy(np.ascontiguousarray(vn, np.float32)).to(dev)
    gt = gt_ids[:B]
    record = protocol.read_record(args.record)
    rows = record.get("rungs", [])
    done = {r.get("label") for r in rows}
    meta = {"B": B, "M": M, "narrow_v": p.narrow_v,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else str(dev))}
    run_now, ids = [], {}

    def write(row, out_ids):
        rows.append(row)
        run_now.append(row)
        ids[row["label"]] = out_ids
        protocol.write_record(args.record, {"note": NOTE, **meta,
                                            "rungs": rows})

    def skipped(label):
        if label in done:
            log(f"{label}: skipped (already measured)")
            return True
        return False

    def timed(fn, reps):
        out = fn()
        protocol.sync(dev)
        t0 = time.time()
        for _ in range(reps):
            out = fn()
        protocol.sync(dev)
        return out, (time.time() - t0) / reps

    def make_run(index, ctx, csub, m=M):
        caps = {}

        def run(gp, qcut, reps=REPS, label="", stage=False):
            if skipped(label):
                return None, None
            if qcut not in caps:
                caps[qcut] = plan_caps(qn, vn, ctx, qcut, M=m)
            gc, wc = caps[qcut]
            before = protocol.kernel_launches()

            def call(g=gp):
                return search_grouped_derive(index, qd, vd, g, qcut, m, gc,
                                             wc, ctx.zero_region)

            out, dt = timed(call, reps)
            launched = launches_since(before)
            out_ids = out[1].cpu().numpy()
            rec = recall_at_k(out_ids, gt)
            log(f"{label}: {dt*1e3:7.2f} ms  recall@10={rec:.4f} "
                f"QPS={nq/dt:,.0f}")
            row = {"label": label, "csub": csub}
            if m != M:
                row["M"] = m
            row.update(ms_per_batch=round(dt * 1e3, 2),
                       qps=round(nq / dt, 1), recall_at_10=round(rec, 4),
                       launches=launched)
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
            write(row, out_ids)
            return dt, rec

        return run

    def try_run(run, gp, qcut, label, what):
        try:
            run(gp, qcut, label=label)
        except Exception as e:  # noqa: BLE001 - one rung's failure, logged
            log(f"{what}: FAILED {type(e).__name__}: {e}")

    t0 = time.time()
    # the aligned layout from its disk cache beside the narrowed dir
    aligned = (load_or_build_aligned(arrays, arrays_dir, 2)
               if arrays_dir is not None else None)
    index = arrays.to_device(dev, tile_csub=2, aligned=aligned)
    ctx = PlannerContext.from_arrays(arrays, csub=2)
    if graph is not None:
        index = protocol.with_knn(index, graph)
    protocol.sync(dev)
    log(f"to_device(csub=2): {time.time()-t0:.1f}s")
    run = make_run(index, ctx, 2)
    gp_base = base_params()
    rep = dataclasses.replace

    if "grid" in fams:
        run(gp_base, 13, label="base_hier_qc13_p96r64", stage=True)
        for sel in ("exact", "approx"):
            gp = rep(gp_base, pool_mode="stride", pool_per_pair=0,
                     pool_stride=8, pool_select=sel)
            try_run(run, gp, 13, f"stride8_{sel}_qc13_p96r64",
                    f"stride/{sel}")
        try_run(run, rep(gp_base, qloc_mode="rowmajor"), 13,
                "rowmajor_qloc_qc13_p96r64", "rowmajor")
        run(rep(gp_base, score_cut=48), 13, label="sc48_qc13_p96r64")
        run(rep(gp_base, dedup_mode="post"), 13, label="ddpost_qc13_p96r64")

    if "grid2" in fams:
        run(rep(gp_base, dedup_mode="post"), 14, label="ddpost_qc14_p96r64")
        for stride in (4, 2):
            gp = rep(gp_base, pool_mode="stride", pool_per_pair=0,
                     pool_stride=stride, pool_select="exact")
            try_run(run, gp, 13, f"stride{stride}_exact_qc13_p96r64",
                    f"stride{stride}")
        gp = rep(gp_base, pool_mode="stride", pool_per_pair=0,
                 pool_stride=4, pool_select="exact", dedup_mode="post")
        try_run(run, gp, 14, "stride4_ddpost_qc14_p96r64", "stride4_ddpost")

    if "pdt" in fams:
        run(rep(gp_base, pool_dtype="bf16"), 13,
            label="pdt_hier_qc13_p96r64", stage=True)
        gp = rep(gp_base, pool_dtype="bf16", dedup_mode="post")
        run(gp, 13, label="pdt_ddpost_qc13_p96r64")
        run(gp, 14, label="pdt_ddpost_qc14_p96r64")
        run(rep(gp_base, pool_dtype="bf16", dedup_mode="post",
                pool_recall=0.9), 14, label="pdt_ddpost_pr90_qc14_p96r64")

    if "seg" in fams:
        for segw in (32, 128):
            gp = rep(gp_base, pool_mode="seg", pool_seg_width=segw,
                     pool_dtype="bf16", dedup_mode="post")
            run(gp, 13, label=f"seg{segw}_pdt_ddpost_qc13_p96r64",
                stage=(segw == 32))
        run(rep(gp_base, pool_mode="seg", pool_seg_width=32,
                pool_select="approx", pool_dtype="bf16", dedup_mode="post"),
            13, label="seg32a_pdt_ddpost_qc13_p96r64")
        run(rep(gp_base, pool_mode="seg", pool_seg_width=32,
                pool_dtype="bf16", dedup_mode="post"), 14,
            label="seg32_pdt_ddpost_qc14_p96r64")
        run(rep(gp_base, pool_mode="seg", pool_seg_width=32,
                pool_dtype="bf16"), 13, label="seg32_pdt_qc13_p96r64")

    if "m32" in fams:
        # M 32 plan groups (K4 at M 32): do 32-slot groups fill?
        run32 = make_run(index, ctx, 2, m=32)
        run32(gp_base, 13, label="m32_hier_qc13_p96r64")
        run32(rep(gp_base, pool_dtype="bf16", dedup_mode="post"), 13,
              label="m32_pdt_ddpost_qc13_p96r64")

    if "knn" in fams and graph is not None:
        # the cheap knn_top rungs first, the full refinement last
        for qc, ktop in ((12, 4), (12, 2), (13, 4)):
            try_run(run, rep(gp_base, n_knn=16, knn_top=ktop), qc,
                    f"knn16top{ktop}_qc{qc}_p96r64",
                    f"knn16top{ktop}_qc{qc}")
        for qc, ktop in ((12, 2), (12, 4)):
            try_run(run, rep(gp_base, n_knn=16, knn_top=ktop,
                             dedup_mode="post"), qc,
                    f"knn16top{ktop}_ddpost_qc{qc}_p96r64",
                    f"knn16top{ktop}_ddpost_qc{qc}")
        for qc, ktop in ((12, 0),):
            try_run(run, rep(gp_base, n_knn=16, knn_top=ktop), qc,
                    f"knn16top{ktop}_qc{qc}_p96r64",
                    f"knn16top{ktop}_qc{qc}")

    if "2pass" in fams:
        # cheap pass 1, a deep pass 2 on the flagged few %
        p2_deep = rep(gp_base, pool=256, rescore=128)
        for qc1, pool1, r1_, eps in ((12, 48, 32, 0.05), (12, 48, 32, 0.1),
                                     (12, 64, 48, 0.05), (13, 64, 48, 0.05)):
            tp = TwoPassParams(pass1=rep(gp_base, pool=pool1, rescore=r1_),
                               pass2=p2_deep, query_cut1=qc1, query_cut2=16,
                               eps=0.0, eps_rel=eps, b2_frac=0.125,
                               b2_min=256, M=M)
            lbl = f"2pass_qc{qc1}_p{pool1}r{r1_}_eps{eps}"
            if skipped(lbl):
                continue
            try:
                before = protocol.kernel_launches()
                (s, i, st), dt = timed(
                    lambda t=tp: search_batch_twopass(index, ctx, qn, vn, t),
                    3)
                rec = recall_at_k(i, gt)
                log(f"{lbl}: {dt*1e3:7.2f} ms  recall@10={rec:.4f} "
                    f"QPS={nq/dt:,.0f} flagged={st['flagged']}")
                write({"label": lbl, "csub": 2,
                       "ms_per_batch": round(dt * 1e3, 2),
                       "qps": round(nq / dt, 1),
                       "recall_at_10": round(rec, 4),
                       "flagged": st["flagged"],
                       "launches": launches_since(before)}, i)
            except Exception as e:  # noqa: BLE001 - one rung, logged
                log(f"2pass qc{qc1}/eps{eps}: FAILED "
                    f"{type(e).__name__}: {e}")

    def run_b1(gp, qcut, label, reps=200):
        # one query a call, M 8: whole-program variants
        lbl = f"b1_{label}"
        if skipped(lbl):
            return
        q1, v1 = qn[:1], vn[:1]
        gc, wc = plan_caps(q1, v1, ctx, qcut, M=8)
        before = protocol.kernel_launches()
        out, dt = timed(lambda: search_grouped_derive(
            index, qd[:1], vd[:1], gp, qcut, 8, gc, wc, ctx.zero_region),
            reps)
        log(f"b1 {label}: {dt*1e3:.3f} ms/call (pipelined)")
        write({"label": lbl, "csub": 2, "ms_per_call": round(dt * 1e3, 3),
               "launches": launches_since(before)}, out[1].cpu().numpy())

    if "b1" in fams:
        run_b1(gp_base, 13, "base_hier")
        run_b1(rep(gp_base, pool_mode="exact", pool_per_pair=0), 13,
               "exactpool")
        run_b1(rep(gp_base, pool_mode="exact", pool_per_pair=0,
                   dedup_mode="post", kernel_unroll=1), 13,
               "exact_ddpost_u1")
        run_b1(rep(gp_base, pool_mode="exact", pool_per_pair=0,
                   dedup_mode="post", pool=48, rescore=32), 13,
               "exact_ddpost_p48r32")
        run_b1(rep(gp_base, pool_mode="seg", pool_seg_width=32,
                   pool_dtype="bf16", dedup_mode="post"), 13,
               "seg32_pdt_ddpost")

    if "csub4" in fams:
        # a csub-4 upload: items of 512 rows (K4 and K5 at csub 4)
        del index, run
        protocol.sync(dev)
        try:
            t0 = time.time()
            index4 = arrays.to_device(dev, tile_csub=4)
            ctx4 = PlannerContext.from_arrays(arrays, csub=4)
            protocol.sync(dev)
            log(f"to_device(csub=4): {time.time()-t0:.1f}s")
            run4 = make_run(index4, ctx4, 4)
            run4(gp_base, 13, label="csub4_hier_qc13_p96r64")
            run4(rep(gp_base, pool_mode="stride", pool_per_pair=0,
                     pool_stride=8), 13, label="csub4_stride8_qc13_p96r64")
        except Exception as e:  # noqa: BLE001 - the family's failure, logged
            log(f"csub4: FAILED {type(e).__name__}: {e}")
    log(f"wrote {args.record}")
    return {"rows": run_now, "ids": ids, "record": args.record}


if __name__ == "__main__":
    main()
