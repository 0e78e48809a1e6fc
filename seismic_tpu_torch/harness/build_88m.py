"""Build the 8.8M-doc scale collection and its memory-lean index.

The port of `seismic_tpu/harness/build_88m.py`. The reference shows
accuracy@10 = 0.99 on the 8.8M-doc MS MARCO collection with per-list
n_postings 3000-4000 (reference docs/Guidelines.md:41-67,
experiments/best_configs/msmarco-v2 configs). This script builds the
synthetic equivalent for the block-pool configuration:

- `synth_dataset_fast` of 8.8M docs at dim 30522 (seed 88);
- the index with NO per-posting doc tiles (`store_doc_tiles=False`) and
  u8 forward values (the DotVByte-equivalent), dense block summaries at
  V 512, no sketches: the device state of the block-pool search is the
  forward rows, the postings, the block geometry and the [n_blocks, V]
  block rows (`ops/tiles_prep.py::block_pool_arrays`), which fits one
  card at 8.8M docs where per-posting tiles (~50-90 GB) would not;
- 2048 synthetic queries (seeds 881, 882), padded to 64 terms (their
  ground truth is `search/exact.py` on the card, computed apart).

Each stage writes its output to `--cache-dir` (`.bench_cache/torch/`,
listed in .gitignore) and is skipped when that output exists, so a rerun
resumes after the last completed stage. Host only: no stage runs on a
device.

    python -m seismic_tpu_torch.harness.build_88m [n_postings] \\
        [--n-docs N] [--cache-dir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from .export_synth import CACHE

N_DOCS = 8_800_000
DIM = 30522
N_QUERIES = 2048
N_POSTINGS = 3500


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def lean_config(n_postings: int):
    from ..config import Configuration, GlobalThresholdPruning, TpuLayout

    return Configuration(
        pruning=GlobalThresholdPruning(n_postings=n_postings,
                                       max_fraction=2.0),
        layout=TpuLayout(
            max_block_len=32,
            max_summary_nnz=128,
            # dense summaries on (dense block rows pool at exact-summary
            # quality; hashed rows lose 3-7 points); no doc tiles,
            # overflow or sketches: the block-pool path reads the dense
            # summaries and the forward rows only
            summary_vocab_cap=512,
            tile_overflow=0,
            sketch_dim=0,
            max_doc_nnz=192,
        ),
    )


def get_dataset(n_docs: int, dim: int, cache_dir: str):
    from ..data.sparse import CsrDataset
    from .synth import synth_dataset_fast

    path = os.path.join(cache_dir, f"docs88_{n_docs}_{dim}.npz")
    if os.path.exists(path):
        t = time.time()
        with np.load(path) as z:
            ds = CsrDataset(z["offsets"], z["components"], z["values"], dim)
        log(f"dataset loaded: {time.time()-t:.0f}s nnz={ds.nnz:,}")
        return ds
    t = time.time()
    ds = synth_dataset_fast(n_docs, dim=dim, seed=88, progress=True)
    log(f"synth_fast: {time.time()-t:.0f}s nnz={ds.nnz:,}")
    np.savez(path, offsets=ds.offsets, components=ds.components,
             values=ds.values)
    return ds


def build(n_docs: int = N_DOCS, dim: int = DIM,
          n_postings: int = N_POSTINGS, cache_dir: str = CACHE,
          n_queries: int = N_QUERIES) -> dict:
    """Runs the stages not yet done; returns {"index_dir", "queries",
    "built": the stages run now}."""
    os.makedirs(cache_dir, exist_ok=True)
    t_all = time.time()
    base = os.path.join(cache_dir, f"index88_{n_docs}_{dim}_{n_postings}")
    dirpath = base + ".dir"
    built = []
    if os.path.isdir(dirpath):
        log(f"index already built: {dirpath}")
    else:
        from ..build.builder import build_index

        ds = get_dataset(n_docs, dim, cache_dir)
        t = time.time()
        arrays = build_index(
            ds, lean_config(n_postings), value_dtype="u8",
            store_summaries=True, store_sketches=False,
            store_doc_tiles=False, progress=True,
        )
        build_secs = time.time() - t
        log(f"index build: {build_secs:.0f}s")
        arrays.save_dir(dirpath)
        with open(base + ".buildtime.json", "w") as f:
            json.dump({"build_secs": build_secs,
                       "n_postings": n_postings}, f)
        built.append("index")

    # queries (distinct seeds per 1024)
    qpath = os.path.join(cache_dir, f"queries88_{dim}_{n_queries}.npz")
    if not os.path.exists(qpath):
        from ..data.sparse import pad_queries
        from .synth import synth_queries

        parts = []
        seed = 881
        remaining = n_queries
        while remaining > 0:
            n = min(1024, remaining)
            qc1, qv1 = synth_queries(n, dim=dim, seed=seed)
            parts.append(pad_queries(qc1, qv1, 64))
            remaining -= n
            seed += 1
        np.savez(qpath,
                 q_comps=np.concatenate([p[0] for p in parts]),
                 q_vals=np.concatenate([p[1] for p in parts]))
        log(f"queries saved: {qpath}")
        built.append("queries")
    log(f"total: {time.time()-t_all:.0f}s")
    return {"index_dir": dirpath, "queries": qpath, "built": built}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_postings", nargs="?", type=int, default=N_POSTINGS)
    ap.add_argument("--n-docs", type=int, default=N_DOCS)
    ap.add_argument("--dim", type=int, default=DIM)
    ap.add_argument("--n-queries", type=int, default=N_QUERIES)
    ap.add_argument("--cache-dir", default=CACHE)
    args = ap.parse_args(argv)
    return build(args.n_docs, args.dim, args.n_postings, args.cache_dir,
                 args.n_queries)


if __name__ == "__main__":
    main()
