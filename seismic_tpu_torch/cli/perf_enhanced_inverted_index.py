"""CLI: query benchmark via the SeismicIndex wrapper with JSONL queries
(string tokens); the port of `seismic_tpu/cli/
perf_enhanced_inverted_index.py` (reference: src/bin/
perf_enhanced_inverted_index.rs:70-159). The same flags, plus `--device`
(the card by default; `--device cpu` runs the plain versions). The run
file holds the string doc ids.

    python -m seismic_tpu_torch.cli.perf_enhanced_inverted_index \\
        --index-file my_index --query-file queries.jsonl --output-path run.tsv
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="JSONL query benchmark")
    p.add_argument("--index-file", required=True)
    p.add_argument("--query-file", required=True, help=".jsonl queries")
    p.add_argument("--output-path", default=None)
    p.add_argument("-k", type=int, default=10)
    p.add_argument("--query-cut", type=int, default=10)
    p.add_argument("--heap-factor", type=float, default=0.7)
    p.add_argument("--n-knn", type=int, default=0)
    p.add_argument("--first-sorted", action="store_true")
    p.add_argument("--n-runs", type=int, default=1)
    p.add_argument("--device", default=None,
                   help="the card by default; 'cpu' runs the plain versions")
    args = p.parse_args(argv)

    from ..api import SeismicIndex
    from ..data.io import read_jsonl_queries

    t0 = time.time()
    index = SeismicIndex.load(args.index_file, device=args.device)
    print(f"Index loaded in {time.time()-t0:.1f} secs")

    queries = read_jsonl_queries(args.query_file)
    qids = np.asarray([q[0] for q in queries], dtype="U30")
    qcomps = [np.asarray(list(v.keys()), dtype="U30") for _, v in queries]
    qvals = [np.asarray(list(v.values()), dtype=np.float32)
             for _, v in queries]

    results = None
    t0 = time.time()
    for _ in range(args.n_runs):
        results = index.batch_search(
            qids, qcomps, qvals,
            k=args.k, query_cut=args.query_cut,
            heap_factor=args.heap_factor,
            n_knn=args.n_knn, sorted=args.first_sorted,
        )
    elapsed = time.time() - t0
    print(
        f"Time {elapsed / (args.n_runs * len(queries)) * 1e6:.2f} "
        "microsecs per query"
    )
    index.print_space_usage_byte()

    if args.output_path:
        with open(args.output_path, "w") as f:
            for rows in results:
                for rank, (qid, score, doc) in enumerate(rows):
                    f.write(f"{qid}\t{doc}\t{rank}\t{score:.6f}\n")
        print(f"Run file written to {args.output_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
