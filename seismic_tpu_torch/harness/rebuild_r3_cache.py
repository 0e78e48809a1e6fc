"""Rebuild the cache files the probe drivers read.

The port of `seismic_tpu/harness/rebuild_r3_cache.py`. Each file keeps
the JAX package's name, under the port's cache (`.bench_cache/torch/`,
`--cache-dir`), and is made only when it is missing, so a second run
builds nothing:

  100k scale: docs_100000_30522.npz, index_100000_30522_200_v1024_o64.dir
      (the native build core), the 16384-query ground truth (exact search
      on the card), its 1024-query subset (bench_knn's file: its queries,
      seed 11, are the first 1024 of the protocol's stream), the
      narrowed `_nw512` and `_nw768` dirs, and the knn16 graph (the
      engine's self-search on a csub-1 upload, K7).
  1m scale:   the same at BENCH_N_DOCS=1000000 / n_postings 400 /
      tile_overflow 0 with 2048 queries (the 1M recipe), `_nw512` only.

R3_CACHE_CPU_ONLY=1 skips the two stages on the card (the ground truth
and the graph). `--device cpu` runs them with the plain versions;
`--n-docs` cuts the collection for a rehearsal.

    python -m seismic_tpu_torch.harness.rebuild_r3_cache [100k|1m] \\
        [--cache-dir DIR] [--device DEV] [--n-docs N]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from . import protocol
from .protocol import log

# the 1M recipe (JAX: rebuild_r3_cache.py:29-35, set over the environment)
SCALES = {
    "100k": {},
    "1m": {"BENCH_N_DOCS": "1000000", "BENCH_N_QUERIES": "2048",
           "BENCH_BATCH": "2048", "BENCH_N_POSTINGS": "400",
           "BENCH_TILE_OVERFLOW": "0"},
}
NARROW = {"100k": (512, 768), "1m": (512,)}
NKNN = 16


def main(argv=None) -> dict:
    """Returns {"built": the files made now, "base": the index's path
    without its suffix, "protocol": the settings}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scale", nargs="?", default="100k", choices=SCALES)
    ap.add_argument("--cache-dir", default=protocol.CACHE)
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' runs the plain "
                    "versions")
    ap.add_argument("--n-docs", type=int, default=None,
                    help="cut the collection for a rehearsal (the file "
                    "names say the count)")
    args = ap.parse_args(argv)
    cpu_only = os.environ.get("R3_CACHE_CPU_ONLY") == "1"
    overrides = dict(SCALES[args.scale])
    if args.n_docs is not None:
        overrides["BENCH_N_DOCS"] = str(args.n_docs)
    p = protocol.from_env(overrides=overrides, cache=args.cache_dir)
    if not cpu_only:  # the card stages' device, asked for before any build
        from ..device import resolve_device

        resolve_device(args.device)
    log(f"=== rebuild_r3_cache scale={args.scale} cpu_only={cpu_only} ===")
    built = []

    def made(path, what):
        if not os.path.exists(path):
            built.append(what)

    made(os.path.join(p.cache, f"docs_{p.n_docs}_{p.dim}.npz"), "docs")
    made(p.index_base + ".dir", "index")
    ds = protocol.get_dataset(p)
    arrays, base = protocol.get_index(ds, p)
    q_comps, q_vals = protocol.get_queries(p.n_queries, p.dim)
    gt_big = p.gt_path(len(q_comps))
    if not cpu_only:
        made(gt_big, "gt")
        protocol.get_ground_truth(ds, q_comps, q_vals, p, args.device)
    gt_small = p.gt_path(1024)
    if not os.path.exists(gt_small) and os.path.exists(gt_big):
        with np.load(gt_big) as z:
            np.savez(gt_small, ids=z["ids"][:1024])
        built.append("gt1024")
        log(f"wrote {gt_small} (subset of the {len(q_comps)}-query GT)")
    del ds

    # narrowed dirs of the v{V_CAP} build (the hashed-tile dir JAX's
    # version dropped is not made either)
    from ..ops.tiles_prep import narrow_vocab

    for W in NARROW[args.scale]:
        ndir = base + f"_nw{W}.dir"
        if not os.path.isdir(ndir):
            t0 = time.time()
            narrow_vocab(arrays, W).save_dir(ndir)
            built.append(f"nw{W}")
            log(f"narrow_vocab V0={W} + save: {time.time()-t0:.1f}s -> {ndir}")

    from ..types import KNN_SUFFIX

    knn_path = base + f".knn{NKNN}"
    if not cpu_only and not os.path.exists(knn_path + KNN_SUFFIX):
        from ..search import knn as knn_mod

        t0 = time.time()
        # the engine's self-search reads the csub-1 layout
        index = arrays.to_device(args.device)
        graph = knn_mod.build_knn(arrays, index, NKNN, batch_size=1024)
        knn_mod.save_knn(graph, knn_path)
        del index
        built.append(f"knn{NKNN}")
        log(f"knn{NKNN} build + save: {time.time()-t0:.0f}s -> {knn_path}")
    log(f"=== rebuild_r3_cache scale={args.scale}: done, built {built} ===")
    return {"built": built, "base": base, "protocol": p}


if __name__ == "__main__":
    main()
