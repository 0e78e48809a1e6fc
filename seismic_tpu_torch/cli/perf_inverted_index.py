"""CLI: timed query benchmark over a serialized index.

The port of `seismic_tpu/cli/perf_inverted_index.py` (reference:
src/bin/perf_inverted_index.rs:20-83 for the flag surface, 184-236 for the
protocol): load the index and the binary queries, run timed loops, report
microseconds per query and space usage, and write a TSV run file
`query_id\\tdoc_id\\trank\\tscore`. The same flags, plus `--device` (the
card by default; `--device cpu` runs the plain versions of the kernels).

On the card, exhaustive-list requests (`--heap-factor <= 0` or
`--full-lists`, tiles doc mode) take the grouped route, as the JAX CLI
takes it on the TPU: the C++ host planner, then the grouped program
(K1's projection, K2 at csub 2, K3's rescore; `--n-knn` adds K3's
refinement round). Everything else, and every request on the CPU, takes
the engine path. Every batch is enqueued before one
`torch.cuda.synchronize()` ends the timed window; `--batch-size`
controls the batch (1 reproduces per-query latency measurement).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Query benchmark")
    p.add_argument("--index-file", required=True)
    p.add_argument("--query-file", required=True,
                   help="queries in the seismic inner binary format")
    p.add_argument("--output-path", default=None, help="TSV run file")
    p.add_argument("-k", type=int, default=10)
    p.add_argument("--query-cut", type=int, default=10)
    p.add_argument("--heap-factor", type=float, default=0.7)
    p.add_argument("--n-knn", type=int, default=0)
    p.add_argument("--knn-path", default=None,
                   help="k-NN graph file (.knn.seismic_tpu) for --n-knn")
    p.add_argument("--first-sorted", action="store_true")
    p.add_argument("--n-queries", type=int, default=10000)
    p.add_argument("--n-runs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--block-budget", type=int, default=0)
    p.add_argument("--cand-budget", type=int, default=0)
    p.add_argument("--block-mode", default=None,
                   choices=[None, "dense", "summary", "sketch"])
    p.add_argument("--doc-mode", default=None,
                   choices=[None, "tiles", "gather"])
    p.add_argument("--full-lists", action="store_true", default=None)
    p.add_argument("--num-threads", type=int, default=0,
                   help="accepted for parity; ignored")
    p.add_argument("--device", default=None,
                   help="the card by default; 'cpu' runs the plain versions")
    return p


def grouped_params(k: int, n_knn: int):
    """The grouped route's parameters (the JAX CLI's)."""
    from ..search.grouped import GroupedParams

    return GroupedParams(
        k=k, score_cut=64, pool=max(8 * k, 64), rescore=max(48, 2 * k),
        compute_dtype="i8", pool_mode="approx", n_knn=n_knn,
    )


def takes_grouped_route(dev, arrays, args) -> bool:
    """The grouped (list-major) route serves exhaustive-scan requests
    (heap-factor <= 0 or --full-lists, tiles doc mode) on the card: the
    JAX CLI's rule on the TPU."""
    return (
        dev.type == "cuda"
        and arrays.doc_tiles is not None
        and (args.heap_factor <= 0.0 or bool(args.full_lists))
        and (args.doc_mode in (None, "tiles"))
    )


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    import torch

    from ..data.io import read_seismic_format
    from ..data.sparse import PAD_COMPONENT, pad_queries
    from ..device import resolve_device
    from ..search.engine import SearchParams, _search_impl
    from ..types import IndexArrays

    dev = resolve_device(args.device)
    t0 = time.time()
    arrays = IndexArrays.load(args.index_file)
    if args.knn_path:
        from ..search import knn as knn_mod

        arrays.knn = knn_mod.load_knn(args.knn_path)
    grouped_ok = takes_grouped_route(dev, arrays, args)
    index = arrays.to_device(dev, tile_csub=2 if grouped_ok else 1)
    print(f"Index loaded in {time.time()-t0:.1f} secs")

    qs = read_seismic_format(args.query_file)
    n_queries = min(args.n_queries, len(qs))
    comp_lists = [qs.get(i)[0] for i in range(n_queries)]
    val_lists = [qs.get(i)[1].astype(np.float32) for i in range(n_queries)]
    q_comps, q_vals = pad_queries(comp_lists, val_lists, 128)

    layout = arrays.config.layout if arrays.config else None
    mode = args.block_mode or (
        "dense" if arrays.dense_summary is not None else "summary"
    )
    doc_mode = args.doc_mode or (
        "tiles" if arrays.doc_tiles is not None else "gather"
    )
    full_lists = (
        args.full_lists if args.full_lists is not None
        else args.block_budget == 0
    )
    params = SearchParams(
        k=args.k,
        query_cut=args.query_cut,
        block_budget=args.block_budget,
        cand_budget=args.cand_budget,
        block_mode=mode,
        doc_mode=doc_mode,
        full_lists=full_lists,
        n_knn=args.n_knn,
        first_sorted=args.first_sorted,
    )
    B = args.batch_size
    n_batches = -(-n_queries // B)
    pad_total = n_batches * B
    if pad_total > n_queries:
        q_comps = np.pad(q_comps, ((0, pad_total - n_queries), (0, 0)),
                         constant_values=PAD_COMPONENT)
        q_vals = np.pad(q_vals, ((0, pad_total - n_queries), (0, 0)))
    qc_dev = [torch.from_numpy(q_comps[i * B:(i + 1) * B]).to(dev)
              for i in range(n_batches)]
    qv_dev = [torch.from_numpy(q_vals[i * B:(i + 1) * B]).to(dev)
              for i in range(n_batches)]
    hf = float(np.float32(args.heap_factor))
    sd = layout.sketch_dim if layout else 128
    ss = layout.sketch_seed if layout else 42

    if grouped_ok:
        from ..search.grouped import DevicePlan, _grouped_impl
        from ..search.planner import PlannerContext, plan_grouped

        ctx = PlannerContext.from_arrays(arrays, csub=2)
        gp = grouped_params(args.k, args.n_knn)

        def run_batch(b):
            plan = plan_grouped(
                q_comps[b * B:(b + 1) * B], q_vals[b * B:(b + 1) * B],
                ctx, args.query_cut,
            )
            return _grouped_impl(index, DevicePlan.put(plan, dev),
                                 qc_dev[b], qv_dev[b], gp)
    else:
        def run_batch(b):
            return _search_impl(index, qc_dev[b], qv_dev[b], hf, params,
                                sd, ss)

    def _sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # warmup
    run_batch(0)
    _sync()

    results = [None] * n_batches
    t0 = time.time()
    for _ in range(args.n_runs):
        for b in range(n_batches):
            results[b] = run_batch(b)
        _sync()
    elapsed = time.time() - t0
    us_per_query = elapsed / (args.n_runs * n_queries) * 1e6
    print(f"Time {us_per_query:.2f} microsecs per query")
    print(f"Time {us_per_query:.2f} microsecs per query", file=sys.stderr)

    arrays.print_space_usage_byte()

    if args.output_path:
        with open(args.output_path, "w") as f:
            for b in range(n_batches):
                scores, ids = (x.cpu().numpy() for x in results[b])
                for row in range(scores.shape[0]):
                    qid = b * B + row
                    if qid >= n_queries:
                        break
                    rank = 0
                    for s, d in zip(scores[row], ids[row]):
                        if d < 0 or not np.isfinite(s):
                            continue
                        f.write(f"{qid}\t{d}\t{rank}\t{s:.6f}\n")
                        rank += 1
                    if rank < args.k:
                        print(f"FAIL! query {qid}: only {rank} results")
        print(f"Run file written to {args.output_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
