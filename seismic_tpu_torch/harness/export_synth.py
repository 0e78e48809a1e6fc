"""Export the synthetic collection to the seismic inner binary format, so
the shipped experiment TOMLs (`experiments/best_configs_synth/`,
`experiments/grid_synth/`) run through `harness/run_experiments.py`.

The port of `seismic_tpu/harness/export_synth.py`: the same collection
(`synth_dataset(100_000, dim=30522, seed=7)`; 2048 queries, the first 1024
from seed 11 and the rest from seed 12) and byte-equal `.bin` files.
Writes into `experiments/data_synth/` (listed in .gitignore; ~170 MB) or
`--out`:

  documents.bin, queries.bin      seismic inner format
                                  (reference: scripts/convert_json_to_inner_format.py:10-27)
  doc_ids.npy, queries_ids.npy    string id arrays
  groundtruth.tsv                 exact top-10 per query (query_id, doc_id,
                                  rank, score), the run_experiments GT format

The ground truth comes from `search/exact.py::exact_search` on `--device`
(the card by default). The synthetic documents are cached in the port's
own cache (`.bench_cache/torch/`, listed in .gitignore; `--cache-dir`),
made on first use. `--n-docs`, `--dim` and `--n-queries` cut the
collection for a rehearsal.

    python -m seismic_tpu_torch.harness.export_synth [--out DIR]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
CACHE = os.path.join(ROOT, ".bench_cache", "torch")

N_DOCS = 100_000
DIM = 30522
N_QUERIES = 2048
SEED_DOCS, SEED_QUERIES = 7, (11, 12)  # the second seed past query 1024
K = 10


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def get_dataset(n_docs: int, dim: int, cache_dir: str | None):
    """`synth_dataset(n_docs, dim, seed=7)`, read from / written to
    `cache_dir` when one is given."""
    from ..data.sparse import CsrDataset
    from .synth import synth_dataset

    path = (os.path.join(cache_dir, f"docs_{n_docs}_{dim}.npz")
            if cache_dir else None)
    if path and os.path.exists(path):
        with np.load(path) as z:
            return CsrDataset(z["offsets"], z["components"], z["values"], dim)
    t = time.time()
    ds = synth_dataset(n_docs, dim=dim, seed=SEED_DOCS)
    log(f"synth dataset: {time.time()-t:.0f}s")
    if path:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez(path, offsets=ds.offsets, components=ds.components,
                 values=ds.values)
    return ds


def export_queries(n_queries: int, dim: int):
    """The collection's queries as ragged (comps, vals) lists."""
    from .synth import synth_queries

    first = min(n_queries, 1024)
    qc, qv = synth_queries(first, dim=dim, seed=SEED_QUERIES[0])
    if n_queries > first:
        qc2, qv2 = synth_queries(n_queries - first, dim=dim,
                                 seed=SEED_QUERIES[1])
        qc, qv = qc + qc2, qv + qv2
    return qc, qv


def export(ds, out: str, n_queries: int = N_QUERIES, device=None,
           gt_chunk: int = 2048) -> dict:
    """Write `ds` and the queries to `out` (the files above); returns
    {"queries": (q_comps, q_vals) padded to 64, "gt_scores", "gt_ids",
    "write_s", "gt_s"}."""
    from ..data.io import write_seismic_format
    from ..data.sparse import CsrDataset, pad_queries
    from ..search.exact import exact_search

    os.makedirs(out, exist_ok=True)
    q_comps_l, q_vals_l = export_queries(n_queries, ds.dim)
    q_offsets = np.zeros(len(q_comps_l) + 1, np.int64)
    np.cumsum([len(c) for c in q_comps_l], out=q_offsets[1:])
    qds = CsrDataset(
        q_offsets,
        np.concatenate(q_comps_l).astype(np.int32),
        np.concatenate(q_vals_l).astype(np.float32),
        ds.dim,
    )
    t = time.time()
    write_seismic_format(ds, os.path.join(out, "documents.bin"))
    write_seismic_format(qds, os.path.join(out, "queries.bin"))
    np.save(os.path.join(out, "doc_ids.npy"),
            np.array([str(i) for i in range(len(ds))], dtype="U30"))
    np.save(os.path.join(out, "queries_ids.npy"),
            np.array([str(i) for i in range(len(q_comps_l))], dtype="U30"))
    write_s = time.time() - t
    log(f"binary data written: {write_s:.1f}s")

    q_comps, q_vals = pad_queries(q_comps_l, q_vals_l, 64)
    t = time.time()
    gt_scores, gt_ids = exact_search(ds, q_comps, q_vals, k=K,
                                     chunk=gt_chunk, device=device)
    gt_s = time.time() - t
    log(f"exact GT: {gt_s:.1f}s")
    with open(os.path.join(out, "groundtruth.tsv"), "w") as f:
        for qi, row in enumerate(gt_ids):
            for rank, did in enumerate(row):
                if did < 0:
                    continue
                f.write(f"{qi}\t{did}\t{rank + 1}\t"
                        f"{float(gt_scores[qi][rank]):.6f}\n")
    log(f"export complete -> {out}")
    return {"queries": (q_comps, q_vals), "gt_scores": gt_scores,
            "gt_ids": gt_ids, "write_s": write_s, "gt_s": gt_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "experiments",
                                                  "data_synth"))
    ap.add_argument("--n-docs", type=int, default=N_DOCS)
    ap.add_argument("--dim", type=int, default=DIM)
    ap.add_argument("--n-queries", type=int, default=N_QUERIES)
    ap.add_argument("--cache-dir", default=CACHE,
                    help="where the synthetic documents are cached ('' for "
                    "none)")
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' runs the ground truth "
                    "on the CPU")
    args = ap.parse_args(argv)
    ds = get_dataset(args.n_docs, args.dim, args.cache_dir or None)
    export(ds, args.out, args.n_queries, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
