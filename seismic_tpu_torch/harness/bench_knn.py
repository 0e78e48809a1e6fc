"""k-NN refinement bench: build an index's k-NN graph, then time the
grouped route with `n_knn` refinement over a ladder of (query_cut, n_knn)
rungs.

The port of `seismic_tpu/harness/bench_knn.py`. The graph is built once
by batched self-search (`search/knn.py::build_knn`, the engine's K7 on
the card) and saved to `--knn-path` (default: beside the index, `.knn<N>`
in place of its suffix); a graph already there is loaded instead.
Refinement re-scores each top-k hit's neighbours in one more round of K3
(reference parity: Knn::new, inverted_index.rs:448-500, builds with
k=nknn+1, qc=10, hf=0.7; Knn::refine, 551-593). The ladder's queries are
`--query-file` (the inner binary format) with recall@10 against
`--groundtruth` (a run file, as `harness/export_synth.py` writes it), or
else 1024 synthetic queries (seed 11) without recall; `--reps 0` builds
or loads the graph only. Device time comes from one
`torch.cuda.synchronize()` after `--reps` calls.

    python -m seismic_tpu_torch.harness.bench_knn --index INDEX \\
        [--nknn 16] [--knn-path PATH] [--query-file queries.bin \\
        --groundtruth groundtruth.tsv] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

LADDER = [(11, 0), (11, 4), (11, 8), (11, 16), (8, 8), (14, 8), (16, 0),
          (20, 0)]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def recall_at_k(ids, gt_ids, k=10):
    hits = tot = 0
    for r, g in zip(ids, gt_ids):
        rs = {int(x) for x in r[:k] if x >= 0}
        gs = {int(x) for x in g[:k] if x >= 0}
        hits += len(rs & gs)
        tot += len(gs)
    return hits / max(tot, 1)


def default_knn_path(index_path: str, nknn: int) -> str:
    from ..types import INDEX_SUFFIX

    base = index_path.rstrip("/")
    for suffix in (INDEX_SUFFIX, ".dir"):
        base = base.removesuffix(suffix)
    return f"{base}.knn{nknn}"


def gt_ids_of(path: str, n_queries: int, k: int = 10) -> np.ndarray:
    """[n_queries, k] int64 doc ids (-1 padded) from a run file."""
    from .evaluate import read_run_tsv

    run = read_run_tsv(path)
    out = np.full((n_queries, k), -1, np.int64)
    for q in range(n_queries):
        docs = [int(d) for d, _ in run.get(str(q), [])[:k]]
        out[q, :len(docs)] = docs
    return out


def graph_for(arrays, index, nknn: int, knn_path: str, batch_size: int):
    """(graph, seconds to build it or None when loaded): the graph at
    `knn_path`, or built on `index` and saved there."""
    from ..search import knn as knn_mod
    from ..types import KNN_SUFFIX

    if os.path.exists(knn_path + KNN_SUFFIX):
        graph = knn_mod.load_knn(knn_path)
        log(f"knn graph loaded ({graph.shape})")
        return graph, None
    t0 = time.time()
    graph = knn_mod.build_knn(arrays, index, nknn, batch_size=batch_size)
    if index.device.type == "cuda":
        import torch

        torch.cuda.synchronize(index.device)
    build_s = time.time() - t0
    log(f"knn build ({nknn} neighbors): {build_s:.1f}s")
    knn_mod.save_knn(graph, knn_path)
    return graph, build_s


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--index", required=True,
                    help="an index saved by the build CLI (or a .dir)")
    ap.add_argument("--nknn", type=int, default=16)
    ap.add_argument("--knn-path", default=None)
    ap.add_argument("--query-file", default=None)
    ap.add_argument("--groundtruth", default=None)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--knn-batch", type=int, default=1024,
                    help="documents a self-search batch of the graph holds")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    import torch

    from ..data.io import read_seismic_format
    from ..data.sparse import pad_queries
    from ..device import resolve_device
    from ..search.grouped import DevicePlan, GroupedParams, _grouped_impl
    from ..search.planner import PlannerContext, plan_grouped
    from ..types import IndexArrays
    from .synth import synth_queries

    dev = resolve_device(args.device)
    log(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}")
    arrays = IndexArrays.load(args.index)
    knn_path = args.knn_path or default_knn_path(args.index, args.nknn)
    t0 = time.time()
    index = arrays.to_device(dev)
    ctx = PlannerContext.from_arrays(arrays)
    log(f"to_device: {time.time()-t0:.1f}s")
    graph, build_s = graph_for(arrays, index, args.nknn, knn_path,
                               args.knn_batch)
    arrays.knn = graph
    # attach the graph to the uploaded index (no second upload)
    index = dataclasses.replace(
        index, knn=torch.from_numpy(np.ascontiguousarray(graph, np.int32))
        .to(dev))
    result = {"knn_path": knn_path, "graph_shape": list(graph.shape),
              "build_s": build_s, "rungs": []}
    if args.reps <= 0:
        return result

    if args.query_file:
        qs = read_seismic_format(args.query_file)
        n = min(args.batch, len(qs))
        qc_l = [qs.get(i)[0] for i in range(n)]
        qv_l = [qs.get(i)[1] for i in range(n)]
    else:
        qc_l, qv_l = synth_queries(args.batch, dim=arrays.dim, seed=11)
    q_comps, q_vals = pad_queries(qc_l, qv_l, 64)
    gt = (gt_ids_of(args.groundtruth, len(qc_l)) if args.groundtruth
          else None)
    qd = torch.from_numpy(q_comps).to(dev)
    vd = torch.from_numpy(q_vals).to(dev)
    B = len(qc_l)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for qc, n_knn in LADDER:
        if n_knn > args.nknn:
            continue
        gp = GroupedParams(k=10, score_cut=64, pool=128, rescore=48,
                           compute_dtype="i8", n_knn=n_knn)
        dp = DevicePlan.put(plan_grouped(q_comps, q_vals, ctx, qc, M=8), dev)
        out = _grouped_impl(index, dp, qd, vd, gp)
        r = recall_at_k(out[1].cpu().numpy(), gt) if gt is not None else None
        t0 = time.time()
        for _ in range(args.reps):
            out = _grouped_impl(index, dp, qd, vd, gp)
        sync()
        dt = (time.time() - t0) / args.reps
        rung = {"query_cut": qc, "n_knn": n_knn, "ms_per_batch": dt * 1e3,
                "qps": B / dt, "recall_at_10": r}
        result["rungs"].append(rung)
        print(f"qc={qc:2d} n_knn={n_knn:2d}: {dt*1e3:7.2f} ms/batch -> "
              f"{B/dt:6.0f} QPS  recall@10="
              f"{'n/a' if r is None else f'{r:.4f}'}", flush=True)
    return result


if __name__ == "__main__":
    main()
