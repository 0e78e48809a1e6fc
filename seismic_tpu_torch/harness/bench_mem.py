"""Memory-parity bench: the lean end of the speed-for-memory trade.

The port of `seismic_tpu/harness/bench_mem.py`. The tiles fast path keeps
a dense local-vocabulary row per posting occurrence (~24x the forward
index at the cells' layout); this bench measures an index with NO doc
tiles, sized ~2x the forward index like the reference's compressed
configurations (reference README.md:110-115; mem_budget_* best_configs):

- the forward index stored as u8 codes (the DotVByte-equivalent per-doc
  scalar quantization), uploaded in the lean form;
- default (rescore) mode: block ranking on the dense per-list u8
  summaries (V=512), every surviving block's candidates exact-scored by
  K3's u8 form (the engine's `doc_mode="rescore"`), a ladder of
  (query_cut, block_budget) rungs;
- `--block`: the block-summary grouped route (the block-pool path of
  `SeismicIndexDotVByte`): the index narrowed to `--block-v` columns
  (`narrow_vocab`), the dense block view bin-packed (`block_pool_arrays(
  order_members=True, pack_bins=True)`; hashed when the build kept no
  dense summaries), `plan_caps` + `search_grouped_derive` with the hier
  pool and `block_expand` (K1, K2, K3-u8), a ladder of (query_cut, pool)
  rungs.

The collection is `synth_dataset(100_000, dim=30522, seed=7)` (cached as
`harness/export_synth.py` caches it; the built indexes beside it in
`.bench_cache/torch/`), the queries 1024 synthetic ones (seed 11; filler
from seed 12 past 1024), the ground truth `search/exact.py` on the same
device. The record (space report, device bytes, each rung's QPS, ms a
batch and recall@10, the device's name) goes to `--out`
(`chiprun_out/mem_bench.json`), one section a mode, merged into what the
file holds; never to the repo's `MEM_BENCH.json`, the JAX package's
record. `--n-docs` / `--dim` / `--max-rungs` cut it for a rehearsal.

    python -m seismic_tpu_torch.harness.bench_mem [--block] [--build-only]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


from .export_synth import CACHE, ROOT, get_dataset

N_DOCS = 100_000
DIM = 30522
OUT = os.path.join(ROOT, "chiprun_out", "mem_bench.json")
RESCORE_RUNGS = [(10, 48), (10, 96), (12, 96), (14, 128), (16, 160)]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def mem_config(block: bool):
    from ..config import Configuration, GlobalThresholdPruning, TpuLayout

    extra = dict(sketch_dim=0, max_summary_nnz=128) if block else {}
    return Configuration(
        pruning=GlobalThresholdPruning(n_postings=200, max_fraction=2.0),
        layout=TpuLayout(max_block_len=32, summary_vocab_cap=512,
                         max_doc_nnz=256, tile_overflow=0, **extra),
    )


def get_index(ds, block: bool, cache_dir: str | None):
    """The lean u8 index (no doc tiles): without block summaries for the
    rescore mode, with them (dense, V 512) and without sketches for
    `--block`; loaded from / saved to `cache_dir`."""
    from ..build.builder import build_index
    from ..types import IndexArrays

    name = f"memindex_{len(ds)}_{ds.dim}_200_{'blkd' if block else 'v512'}"
    path = os.path.join(cache_dir, name + ".dir") if cache_dir else None
    if path and os.path.isdir(path):
        t = time.time()
        arrays = IndexArrays.load_dir(path)
        log(f"mem index loaded: {time.time()-t:.1f}s")
        return arrays
    t = time.time()
    kw = (dict(store_sketches=False) if block
          else dict(store_summaries=False))
    arrays = build_index(ds, mem_config(block), value_dtype="u8",
                         store_doc_tiles=False, progress=True, **kw)
    log(f"mem index build: {time.time()-t:.0f}s")
    if path:
        os.makedirs(cache_dir, exist_ok=True)
        arrays.save_dir(path)
    return arrays


def recall_at_k(ids, gt_ids, k=10):
    hits = tot = 0
    for r, g in zip(ids, gt_ids):
        rs = {int(x) for x in r[:k] if x >= 0}
        gs = {int(x) for x in g[:k] if x >= 0}
        hits += len(rs & gs)
        tot += len(gs)
    return hits / max(tot, 1)


def queries_and_gt(ds, B: int, dev):
    """Padded queries [max(B, 1024), 64] (1024 from seed 11, filler from
    seed 12) and the exact top-10 ids of the first 1024."""
    from ..data.sparse import pad_queries
    from ..search.exact import exact_search
    from .synth import synth_queries

    qc_l, qv_l = synth_queries(1024, dim=ds.dim, seed=11)
    if B > 1024:
        fc, fv = synth_queries(B - 1024, dim=ds.dim, seed=12)
        qc_l, qv_l = qc_l + fc, qv_l + fv
    q_comps, q_vals = pad_queries(qc_l, qv_l, 64)
    _, gt = exact_search(ds, q_comps[:1024], q_vals[:1024], k=10,
                         device=dev)
    return q_comps, q_vals, gt


def write_record(path: str, section: str, artifact: dict) -> dict:
    """Merge `artifact` into the JSON record at `path` under `section`."""
    merged = {}
    if os.path.exists(path):
        with open(path) as f:
            merged = json.load(f)
    merged[section] = artifact
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(merged, f, indent=1)
    return merged


def _timed(fn, reps: int, dev):
    """(ms a call over `reps` calls ended by one synchronise, the output)."""
    import torch

    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3 / reps, out


def run_rescore(args, ds, dev, device_name: str) -> dict:
    import torch

    from ..search.engine import SearchParams, _search_impl

    arrays = get_index(ds, False, args.cache_dir)
    space = arrays.space_usage_report()
    fwd = space["forward_index"]
    ratio = space["total"] / max(fwd, 1)
    log(f"space: total={space['total']/1e6:.1f}MB forward={fwd/1e6:.1f}MB "
        f"ratio={ratio:.2f}x")
    if args.build_only:
        return {"space": space, "ratio_vs_forward": ratio}
    t0 = time.time()
    index = arrays.to_device(dev)
    log(f"to_device: {time.time()-t0:.1f}s")
    q_comps, q_vals, gt = queries_and_gt(ds, args.batch, dev)
    B = args.batch
    qd = torch.from_numpy(q_comps[:B]).to(dev)
    vd = torch.from_numpy(q_vals[:B]).to(dev)
    rows = []
    for qc, bb in RESCORE_RUNGS[:args.max_rungs or None]:
        params = SearchParams(k=10, query_cut=qc, block_budget=bb,
                              block_mode="dense", doc_mode="rescore",
                              dedup_pool=128)
        ms, out = _timed(lambda: _search_impl(index, qd, vd, 0.0, params),
                         args.reps, dev)
        rows.append({"query_cut": qc, "block_budget": bb, "cand_budget": 0,
                     "qps": B / ms * 1e3, "ms_per_batch": ms,
                     "recall_at_10": recall_at_k(out[1].cpu().numpy(), gt)})
        log(str(rows[-1]))
    return {
        "device": device_name,
        "space": space,
        "device_bytes": index.nbytes(),
        "ratio_vs_forward": ratio,
        "n_docs": len(ds), "dim": ds.dim, "batch": B,
        "note": (
            "no-doc-tiles u8-forward index (DotVByte-equivalent), uploaded "
            "in the lean form; block ranking on dense u8 summaries, every "
            "surviving block's candidates exact-scored by K3's u8 form "
            "(doc_mode=rescore)"
        ),
        "rungs": rows,
    }


def run_block(args, ds, dev, device_name: str) -> dict:
    import torch

    from ..ops.tiles_prep import block_pool_arrays, narrow_vocab
    from ..search.grouped import (
        GroupedParams,
        plan_caps,
        search_grouped_derive,
    )
    from ..search.planner import PlannerContext

    arrays = get_index(ds, True, args.cache_dir)
    space = arrays.space_usage_report()
    V = args.block_v
    t0 = time.time()
    if arrays.dense_summary is not None:
        if V < arrays.dense_summary.shape[1]:
            arrays = narrow_vocab(arrays, V)
        bv = block_pool_arrays(arrays, V, order_members=True, mode="dense",
                               pack_bins=True)
        tile_hash = 0
    else:
        bv = block_pool_arrays(arrays, V, order_members=True, mode="hash",
                               pack_bins=True)
        tile_hash = V
    log(f"block view V={V} (hash={bool(tile_hash)}): {time.time()-t0:.1f}s "
        f"rows={bv.doc_tiles.shape[0]:,}")
    # the grouped route reads neither the CSR nor the dense summaries
    bv = dataclasses.replace(bv, summary_comps=None, summary_codes=None,
                             dense_summary=None, dense_scale=None)
    E = int(arrays.max_block_len)
    t0 = time.time()
    # csub 1 with bin-packed regions: one 128-row bin per pair
    index = bv.to_device(dev, tile_csub=1, tile_hash=tile_hash)
    ctx = PlannerContext.from_arrays(bv, csub=1)
    log(f"to_device: {time.time()-t0:.1f}s")
    dev_b = index.nbytes()
    fwd_f32 = len(ds) * 256 * 8  # f32 forward at this layout (comps+vals)
    log(f"device bytes: {dev_b/1e6:.1f}MB "
        f"({dev_b/fwd_f32:.2f}x the f32 forward index)")
    B = args.batch
    q_comps, q_vals, gt = queries_and_gt(ds, B, dev)
    qd = torch.from_numpy(q_comps[:B]).to(dev)
    vd = torch.from_numpy(q_vals[:B]).to(dev)
    base = GroupedParams(k=10, score_cut=64, pool=32, block_expand=E,
                         compute_dtype="i8", pool_mode="hier",
                         pool_per_pair=8, kernel_unroll=8)
    ladder = []
    for qcut in (10, 12, 14, 16):
        ladder += [(qcut, p, ppp, e) for p, ppp, e in
                   [(16, 4, E), (32, 8, E), (48, 12, E), (64, 16, E),
                    (32, 8, 16)]]
        if qcut in (10, 12):
            # the deep pools at the cheap query cuts (recall is pool-bound
            # on this path)
            ladder += [(qcut, p, ppp, E) for p, ppp in
                       [(96, 24), (128, 32), (192, 48)]]
    rows = []
    for qcut, pool, ppp, Ee in ladder[:args.max_rungs or None]:
        gp = dataclasses.replace(base, pool=pool, pool_per_pair=ppp,
                                 block_expand=Ee)
        gc, wc = plan_caps(q_comps[:B], q_vals[:B], ctx, qcut, M=8)
        ms, out = _timed(lambda: search_grouped_derive(
            index, qd, vd, gp, qcut, 8, gc, wc, ctx.zero_region),
            args.reps, dev)
        rows.append({"query_cut": qcut, "pool": pool, "E": Ee,
                     "qps": B / ms * 1e3, "ms_per_batch": ms,
                     "recall_at_10": recall_at_k(
                         out[1].cpu().numpy()[:1024], gt)})
        log(str(rows[-1]))
    return {
        "device": device_name,
        "space": space,
        "device_bytes": dev_b,
        "ratio_vs_f32_forward": dev_b / fwd_f32,
        "tile_mode": "block", "V": V, "batch": B,
        "n_docs": len(ds), "dim": ds.dim,
        "note": (
            "block-summary grouped route: u8 forward (DotVByte-equivalent) "
            "in the lean upload + dense (or hashed) [n_blocks, V] block "
            "rows, bin-packed; pooled blocks expand into their members, "
            "all exact-rescored by K3's u8 form (block_expand). No "
            "per-posting tile replication. The SeismicIndexDotVByte "
            "serving path."
        ),
        "rungs": rows,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--build-only", action="store_true")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--block", action="store_true",
                    help="block-summary grouped rung (fast AND lean)")
    ap.add_argument("--block-v", type=int, default=512)
    ap.add_argument("--n-docs", type=int, default=N_DOCS)
    ap.add_argument("--dim", type=int, default=DIM)
    ap.add_argument("--max-rungs", type=int, default=0,
                    help="run only the ladder's first N rungs (0: all)")
    ap.add_argument("--cache-dir", default=CACHE,
                    help="where the collection and indexes are cached ('' "
                    "for none)")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    args.cache_dir = args.cache_dir or None

    import torch

    from ..device import resolve_device

    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"device: {name}")
    ds = get_dataset(args.n_docs, args.dim, args.cache_dir)
    if args.block:
        artifact = run_block(args, ds, dev, name)
        section = "block_mode"
    else:
        artifact = run_rescore(args, ds, dev, name)
        section = "rescore_mode"
    if not args.build_only:
        write_record(args.out, section, artifact)
    print(json.dumps(artifact))
    return artifact


if __name__ == "__main__":
    main()
