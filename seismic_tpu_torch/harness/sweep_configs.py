"""Query-parameter sweep over the cached bench index, in the grid-search
layout that `harness/best_configs.py` reads.

The port of `seismic_tpu/harness/sweep_configs.py`: the same 12
combinations (query-cut 8-20 without the graph, 10-16 with `n-knn` 8 when
the index's knn16 graph is cached beside it), the same `INDEXING` dict
(the bench index's build, in build CLI terms) and the same directory
names (the first 16 hex digits of the sha1 of each combination's JSON),
each holding `combo.json` and `report.tsv` (accuracy, us_per_query,
total_bytes). The queries are the collection's 2048 (1024 of seed 11,
1024 of seed 12, padded to 64 terms), the ground truth `--gt`.

Each combination runs the API's grouped route: `plan_grouped` on the
host, `DevicePlan.put`, then the grouped program with i8, the approx pool
of 64 and a rescore of 48 at csub 2 (K1, K2 and K3; K3 twice a batch
with `n-knn` 8), re-planned every repetition as the JAX sweep times it.
The grid goes to `chiprun_out/grid_synth/` unless `--grid-root` says
otherwise: `experiments/grid_synth/` holds the JAX package's record.

    python -m seismic_tpu_torch.harness.sweep_configs [--device DEV]
    python -m seismic_tpu_torch.harness.best_configs \\
        --grid-root chiprun_out/grid_synth \\
        --base-toml experiments/best_configs_synth/base.toml \\
        --recalls 0.95,0.96,0.97,0.98 --output-dir OUT
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import time

import numpy as np

from . import protocol
from .protocol import CACHE, log, recall_at_k

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")

INDEXING = {
    # bench index build parameters, in build_inverted_index CLI terms
    "n-postings": 200,
    "max-fraction": 2.0,
    "max-block-len": 32,
    "summary-vocab-cap": 1024,
    "max-doc-nnz": 256,
    "value-type": "f32",
}
QUERY_CUTS = (8, 10, 11, 12, 14, 16, 20)
KNN_QUERY_CUTS = (10, 11, 12, 14, 16)
KNN = 8
CSUB = 2


def combos(with_knn: bool):
    """(query_cut, n_knn) of every combination, in the sweep's order."""
    out = [(qc, 0) for qc in QUERY_CUTS]
    if with_knn:
        out += [(qc, KNN) for qc in KNN_QUERY_CUTS]
    return out


def combo_of(qc: int, n_knn: int, batch: int) -> dict:
    return {
        "indexing": dict(INDEXING),
        "query": {
            "query-cut": qc,
            "heap-factor": 0.0,
            "n-knn": n_knn,
            "batch-size": batch,
            "full-lists": True,
        },
    }


def combo_dir(combo: dict) -> str:
    """The combination's directory name: the first 16 hex digits of the
    sha1 of its JSON with sorted keys."""
    return hashlib.sha1(
        json.dumps(combo, sort_keys=True).encode()).hexdigest()[:16]


def main(argv=None) -> list:
    """Returns one row a combination: its directory, query cut, n_knn,
    recall@10, us/query and QPS."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--index", default=os.path.join(
        CACHE, "index_100000_30522_200_v1024_o64.dir"))
    ap.add_argument("--gt", default=os.path.join(
        CACHE, "gt_100000_30522_2048.npz"))
    ap.add_argument("--grid-root", default=os.path.join(
        ROOT, "chiprun_out", "grid_synth"))
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    import torch

    from ..data.sparse import pad_queries
    from ..device import resolve_device
    from ..search.grouped import DevicePlan, GroupedParams, _grouped_impl
    from ..search.knn import load_knn
    from ..search.planner import PlannerContext, plan_grouped
    from ..types import KNN_SUFFIX, IndexArrays
    from .synth import synth_queries

    dev = resolve_device(args.device)
    log(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}")
    arrays = IndexArrays.load(args.index)
    space_total = arrays.space_usage_report()["total"]
    t0 = time.time()
    index = arrays.to_device(dev, tile_csub=CSUB)
    ctx = PlannerContext.from_arrays(arrays, csub=CSUB)
    log(f"to_device: {time.time()-t0:.0f}s")

    knn_path = args.index.rstrip("/").replace(".dir", ".knn16")
    index_knn = (protocol.with_knn(index, load_knn(knn_path))
                 if os.path.exists(knn_path + KNN_SUFFIX) else None)

    qc1, qv1 = synth_queries(1024, dim=arrays.dim, seed=11)
    q_comps, q_vals = pad_queries(qc1, qv1, 64)
    qc2, qv2 = synth_queries(1024, dim=arrays.dim, seed=12)
    e_comps, e_vals = pad_queries(qc2, qv2, 64)
    q_comps = np.concatenate([q_comps, e_comps])
    q_vals = np.concatenate([q_vals, e_vals])
    gt = np.load(args.gt)["ids"]

    B = min(args.batch, len(q_comps))
    qb, vb = q_comps[:B], q_vals[:B]
    qd = torch.from_numpy(qb).to(dev)
    vd = torch.from_numpy(vb).to(dev)

    os.makedirs(args.grid_root, exist_ok=True)
    rows = []
    for qc, n_knn in combos(index_knn is not None):
        ix = index_knn if n_knn > 0 else index
        gp = GroupedParams(k=10, score_cut=64, pool=64, rescore=48,
                           compute_dtype="i8", pool_mode="approx",
                           n_knn=n_knn)
        dp = DevicePlan.put(plan_grouped(qb, vb, ctx, qc, M=8), dev)
        out = _grouped_impl(ix, dp, qd, vd, gp)
        rec = recall_at_k(out[1].cpu().numpy(), gt[:B])
        # e2e timing: re-plan every repetition (planning overlaps the
        # device's work)
        t0 = time.time()
        for _ in range(args.reps):
            dp = DevicePlan.put(plan_grouped(qb, vb, ctx, qc, M=8), dev)
            out = _grouped_impl(ix, dp, qd, vd, gp)
        protocol.sync(dev)
        dt = (time.time() - t0) / args.reps
        us_per_query = dt * 1e6 / B
        combo = combo_of(qc, n_knn, B)
        d = os.path.join(args.grid_root, combo_dir(combo))
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "combo.json"), "w") as f:
            json.dump({"combo": combo}, f, indent=1)
        with open(os.path.join(d, "report.tsv"), "w") as f:
            f.write("accuracy\tus_per_query\ttotal_bytes\n")
            f.write(f"{rec:.4f}\t{us_per_query:.2f}\t{space_total}\n")
        rows.append({"dir": os.path.basename(d), "query_cut": qc,
                     "n_knn": n_knn, "recall_at_10": rec,
                     "us_per_query": us_per_query, "qps": B / dt})
        print(f"qc={qc:2d} n_knn={n_knn:2d}: {us_per_query:7.2f} us/q "
              f"({B/dt:6.0f} QPS) recall={rec:.4f}", flush=True)
    return rows


if __name__ == "__main__":
    main()
