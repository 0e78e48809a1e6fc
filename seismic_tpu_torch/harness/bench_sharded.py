"""Sharded-index scaling bench (the port of `seismic_tpu/harness/
bench_sharded.py`): one synthetic collection searched as 1, 2 and 4
document shards over the visible cards, with the build and query time,
recall@10 against exact search, each shard's postings, and a save / load
round trip at 4 shards. Where there are fewer cards than shards, a card
holds several shards (the mesh repeats it, in turn), and the artifact
says so: those shards run one after another on that card.

    python -m seismic_tpu_torch.harness.bench_sharded [--n-docs 20000]
        [--grouped] [--out chiprun_out/sharded_bench.json] [--device cpu]

`--grouped` adds the grouped route's rungs (the headline recipe, i8 with
the hier pool and the item-major scorer, on doc tiles; and the
blocks-as-rows view with `block_expand`), each held against one index
over the whole collection with the same recipe (top-10 agreement). The
JSON goes to `--out`; a copy of the numbers is printed as the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")


def _card() -> str:
    """The card's name and power limit as nvidia-smi prints them, or
    "not measured" where it cannot be read."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except OSError:
        return "not measured"
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        "not measured"


def _mesh_devices(n: int, device) -> tuple:
    """n mesh entries over the visible cards (entry i on card i % count),
    or n entries of the CPU; and whether a device repeats."""
    import torch

    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * n, n > 1
    count = torch.cuda.device_count()
    return ([torch.device("cuda", i % count) for i in range(n)],
            n > count)


def _recall(ids, gt_ids) -> float:
    hits = tot = 0
    for r, g in zip(ids, gt_ids):
        rs = {int(x) for x in r[:10] if x >= 0}
        gs = {int(x) for x in g[:10] if x >= 0}
        hits += len(rs & gs)
        tot += len(gs)
    return hits / max(tot, 1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-docs", type=int, default=20000)
    ap.add_argument("--dim", type=int, default=30522)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--qc", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "sharded_bench.json"))
    ap.add_argument("--grouped", action="store_true",
                    help="add the grouped route's rungs (tiles, block)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the cards)")
    args = ap.parse_args(argv)

    import torch

    from ..config import Configuration, GlobalThresholdPruning, TpuLayout
    from ..data.sparse import pad_queries
    from ..parallel.mesh import make_mesh
    from ..parallel.sharded import ShardedIndex
    from ..search.engine import SearchParams
    from ..search.exact import exact_search
    from .synth import synth_dataset, synth_queries

    t0 = time.time()
    ds = synth_dataset(args.n_docs, dim=args.dim, seed=7)
    qc_l, qv_l = synth_queries(args.batch, dim=args.dim, seed=11)
    q_comps, q_vals = pad_queries(qc_l, qv_l, 64)
    data_s = time.time() - t0
    first = _mesh_devices(1, args.device)[0][0]
    t0 = time.time()
    _, gt_ids = exact_search(ds, q_comps, q_vals, k=10, device=first)
    gt_s = time.time() - t0
    print(f"data {data_s:.1f} s, ground truth {gt_s:.1f} s",
          file=sys.stderr)
    cfg = Configuration(
        pruning=GlobalThresholdPruning(n_postings=200, max_fraction=2.0),
        layout=TpuLayout(max_block_len=32, summary_vocab_cap=512,
                         max_doc_nnz=256, tile_overflow=32))
    params = SearchParams(k=10, query_cut=args.qc, block_budget=0,
                          block_mode="dense", doc_mode="tiles",
                          full_lists=True, score_cut=64, dedup_pool=128)

    def mesh_of(n_data, n_docs):
        devs, repeated = _mesh_devices(n_data * n_docs, args.device)
        return make_mesh(n_docs, n_data, devices=devs), repeated

    def postings(sharded):
        return [int(s.list_len.sum()) for s in sharded.host_shards]

    scaling = []
    for n_shards in (1, 2, 4):
        mesh, repeated = mesh_of(1, n_shards)
        t0 = time.time()
        sharded = ShardedIndex.build(ds, mesh, cfg)
        build_s = time.time() - t0
        t0 = time.time()
        _, ids = sharded.search_batch(q_comps, q_vals, params,
                                      heap_factor=0.0)
        first_s = time.time() - t0
        t0 = time.time()
        for _ in range(args.reps):
            _, ids = sharded.search_batch(q_comps, q_vals, params,
                                          heap_factor=0.0)
        query_s = (time.time() - t0) / args.reps
        row = dict(n_shards=n_shards, devices=[str(d) for d in
                                               mesh.grid[0]],
                   device_repeated=repeated, build_s=build_s,
                   first_call_s=first_s, query_ms_per_batch=query_s * 1e3,
                   recall_at_10=_recall(ids, gt_ids),
                   postings_per_shard=postings(sharded),
                   device_bytes_per_shard=sharded.nbytes())
        print(row, file=sys.stderr)
        scaling.append(row)
        del sharded

    # save / load at 4 shards: the same results
    mesh, _ = mesh_of(1, 4)
    sharded = ShardedIndex.build(ds, mesh, cfg)
    s0, i0 = sharded.search_batch(q_comps, q_vals, params, heap_factor=0.0)
    tmp = tempfile.mkdtemp(prefix="sharded_bench")
    try:
        t0 = time.time()
        sharded.save(os.path.join(tmp, "index"))
        save_s = time.time() - t0
        del sharded
        t0 = time.time()
        loaded = ShardedIndex.load(os.path.join(tmp, "index"), mesh)
        load_s = time.time() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    s1, i1 = loaded.search_batch(q_comps, q_vals, params, heap_factor=0.0)
    del loaded
    lifecycle = dict(save_s=save_s, load_s=load_s,
                     roundtrip_identical=bool(np.array_equal(i0, i1)
                                              and np.array_equal(s0, s1)))

    grouped = []
    if args.grouped:
        grouped = _grouped_rungs(ds, cfg, q_comps, q_vals, gt_ids, args,
                                 mesh_of, postings)
    artifact = dict(
        card=_card() if first.type == "cuda" else "cpu",
        device_count=(torch.cuda.device_count() if first.type == "cuda"
                      else 0),
        n_docs=args.n_docs, dim=args.dim, batch=args.batch,
        query_cut=args.qc, data_s=data_s, ground_truth_s=gt_s,
        note=("shards on a repeated device run one after another on it; "
              "times are host wall clock around synchronised calls"),
        scaling=scaling, lifecycle=lifecycle, grouped=grouped)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(json.dumps(artifact))
    if not lifecycle["roundtrip_identical"]:
        sys.exit("save / load changed the results")
    return artifact


def _grouped_rungs(ds, cfg, q_comps, q_vals, gt_ids, args, mesh_of,
                   postings):
    """The grouped rungs: mesh 1x2, 2x2 and 1x4 on doc tiles, 2x2 on the
    block view, each beside one whole-collection index of its recipe."""
    import torch

    from ..build.builder import build_index
    from ..ops.tiles_prep import block_pool_arrays
    from ..parallel.sharded import ShardedIndex
    from ..search.grouped import GroupedParams, plan_caps, search_grouped_derive
    from ..search.planner import PlannerContext

    E = int(cfg.layout.max_block_len)
    gp_tiles = GroupedParams(k=10, score_cut=64, pool=96, rescore=64,
                             compute_dtype="i8", pool_mode="hier",
                             pool_per_pair=16, kernel_unroll=8)
    gp_block = GroupedParams(k=10, score_cut=64, pool=32, block_expand=E,
                             compute_dtype="i8", pool_mode="hier",
                             pool_per_pair=8, kernel_unroll=8)
    refs = {}

    def single_ref(tile_block, dev):
        if tile_block in refs:
            return refs[tile_block]
        arrays = build_index(ds, cfg)
        if tile_block:
            arrays = block_pool_arrays(arrays, cfg.layout.summary_vocab_cap,
                                       order_members=True, mode="dense")
        ix = arrays.to_device(dev)
        ctx = PlannerContext.from_arrays(arrays)
        gc_, wc_ = plan_caps(q_comps, q_vals, ctx, args.qc, M=8)
        _, ids = search_grouped_derive(
            ix, torch.from_numpy(q_comps).to(dev),
            torch.from_numpy(q_vals).to(dev),
            gp_block if tile_block else gp_tiles, args.qc, 8, gc_, wc_,
            ctx.zero_region)
        refs[tile_block] = ids.cpu().numpy()
        return refs[tile_block]

    rows = []
    for label, n_data, n_docs, tile_block in (
            ("tiles d1xs2", 1, 2, 0), ("tiles d2xs2", 2, 2, 0),
            ("block d2xs2", 2, 2, 512), ("tiles d1xs4", 1, 4, 0)):
        mesh, repeated = mesh_of(n_data, n_docs)
        t0 = time.time()
        sharded = ShardedIndex.build(ds, mesh, cfg, pallas_tiles=True,
                                     tile_block=tile_block)
        build_s = time.time() - t0
        gp = gp_block if tile_block else gp_tiles
        t0 = time.time()
        _, ids = sharded.search_batch_grouped(q_comps, q_vals, gp,
                                              query_cut=args.qc)
        query_s = time.time() - t0
        ref = single_ref(tile_block, mesh.grid[0][0])
        agree = float(np.mean([
            len({int(x) for x in a[:10] if x >= 0}
                & {int(x) for x in b[:10] if x >= 0}) / 10.0
            for a, b in zip(ids, ref)]))
        row = dict(rung=label, mesh=mesh.shape, device_repeated=repeated,
                   build_s=build_s, first_call_s=query_s,
                   recall_at_10=_recall(ids, gt_ids),
                   single_index_recall_at_10=_recall(ref, gt_ids),
                   merge_agreement_at_10=agree,
                   postings_per_shard=postings(sharded))
        print(row, file=sys.stderr)
        rows.append(row)
        del sharded
    return rows


if __name__ == "__main__":
    main()
