"""Round-3 probe J: the 8.8M-document single-card rung on the block-pool
route, recall@10, QPS and device bytes a rung.

The port of `seismic_tpu/harness/probe_r3j.py`. Per-posting doc tiles do
not fit one card at 8.8M documents; the block-summary configuration does:
the lean forward rows (int16 ids, u8 values), the postings and block
geometry, and one [n_blocks, V] row per block. Stages, each cached under
`build_88m`'s cache (`.bench_cache/torch/`, `--cache-dir`; its file
names: `docs88_*`, `index88_*`, `queries88_*`):

  1. the ground truth of the 2048 queries, from the streaming exact
     search (`search/exact.py::exact_search(stream=True)`: a running
     top-k over document chunks, no [B, n_docs] score matrix), saved as
     `gt88_*.npz`;
  2. the block view at V (argv, default 512): the dense block summaries
     narrowed to V, or the hashed rows when the build kept no dense
     summaries, members ordered by value, bin-packed
     (`ops/tiles_prep.py::block_pool_arrays`), saved as
     `<index>.blockview_v{V}.dir` beside a `.tile_hash` file that keys it
     on the source directory's mtime (a rebuilt index invalidates it);
     uploaded lean at csub 1 with `tile_hash`;
  3. the ladder at B 2048, M 8: qc 10 / 14 x pool 64-512 (hier, a
     quarter of the pool a pair), `block_expand` E (the view's block
     length) and `rescore_chunk` 1024: K1, K2, K3's u8 form.

`B88_N_DOCS` (default 8.8M) and `B88_N_POSTINGS` (default 3500, or the
second argv value) pick the build. The record goes to
`chiprun_out/scale88_bench.json` (`--record`), never to the repo root's
`SCALE88_BENCH.json`.

    python -m seismic_tpu_torch.harness.probe_r3j [V] [n_postings] \\
        [--cache-dir DIR] [--record PATH] [--device DEV]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np

from . import protocol
from .build_88m import CACHE, DIM
from .protocol import launches_since, log, recall_at_k
from ..ops.tiles_prep import block_pool_arrays, narrow_vocab
from ..search.grouped import GroupedParams, plan_caps, search_grouped_derive
from ..search.planner import PlannerContext
from ..types import IndexArrays

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
RECORD = os.path.join(ROOT, "chiprun_out", "scale88_bench.json")
B, M = 2048, 8
REPS = 5  # timed calls a rung, after one warm call
# (qc, pool, pool_per_pair) of every rung: pool depth first at qc 10 and
# 14 (recall is pool-bound at this scale)
LADDER = tuple((qc, pool, ppp) for qc in (10, 14) for pool, ppp in (
    (64, 16), (128, 32), (256, 64), (512, 128)))
# the fields the block route never reads, dropped from the view
UNREAD = ("tile_ovf_comps", "tile_ovf_vals", "summary_comps",
          "summary_codes", "dense_summary", "dense_scale", "block_sketch",
          "block_sketch_scale", "doc_sketch", "doc_sketch_scale")
NOTE = ("8.8M-doc single-card rung (probe_r3j, the port on the card): "
        "bin-packed block-summary pooling + block_expand exact rescore; "
        "per-posting tiles do not fit one card at this scale. Reference "
        "bar: accuracy@10 0.99 on 8.8M MS MARCO (reference "
        "docs/Guidelines.md:41-67).")


def get_gt(q_comps, q_vals, n_docs: int, cache: str, device=None):
    """The streaming exact search's top-10 ids, cached."""
    path = os.path.join(cache, f"gt88_{n_docs}_{DIM}_{len(q_comps)}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return z["ids"]
    from ..data.sparse import CsrDataset
    from ..search.exact import exact_search

    t = time.time()
    with np.load(os.path.join(cache, f"docs88_{n_docs}_{DIM}.npz")) as z:
        ds = CsrDataset(z["offsets"], z["components"], z["values"], DIM)
    log(f"dataset loaded: {time.time()-t:.0f}s")
    t = time.time()
    _, ids = exact_search(ds, q_comps, q_vals, k=10, chunk=16384,
                          stream=True, device=device)
    log(f"streaming exact GT: {time.time()-t:.0f}s")
    np.savez(path, ids=ids)
    return ids


def block_view(base: str, V: int):
    """(view, tile_hash, built): the cached block view of `base + ".dir"`
    at V when its key (the source directory's mtime) matches, else one
    derived now and cached."""
    t0 = time.time()
    bvdir = base + f".blockview_v{V}.dir"
    hpath = bvdir + ".tile_hash"
    src_fp = str(int(os.path.getmtime(base + ".dir")))
    lines = []
    if os.path.isdir(bvdir) and os.path.exists(hpath):
        with open(hpath) as f:
            lines = f.read().split()
        if len(lines) >= 2 and lines[1] == src_fp:
            bv = IndexArrays.load_dir(bvdir)
            bv.pack_bins = True  # an in-memory flag, not saved
            log(f"block view mmap-loaded from cache: {time.time()-t0:.0f}s "
                f"rows={bv.doc_tiles.shape[0]:,}")
            return bv, int(lines[0]), False
        log(f"block view cache STALE (fp {lines[1:]} != {src_fp}); "
            "rebuilding")
    arrays = IndexArrays.load_dir(base + ".dir")
    log(f"index mmap-loaded: {time.time()-t0:.0f}s")
    t0 = time.time()
    tile_hash = 0
    if arrays.dense_summary is not None:
        # dense block rows pool at exact-summary quality
        if V < arrays.dense_summary.shape[1]:
            arrays = narrow_vocab(arrays, V)
        bv = block_pool_arrays(arrays, V, order_members=True, mode="dense",
                               pack_bins=True)
    else:
        bv = block_pool_arrays(arrays, V, order_members=True, mode="hash",
                               pack_bins=True)
        tile_hash = V
    log(f"block view V={V} (hash={bool(tile_hash)}): "
        f"{time.time()-t0:.0f}s rows={bv.doc_tiles.shape[0]:,}")
    for f in UNREAD:
        setattr(bv, f, None)
    t0 = time.time()
    bv.save_dir(bvdir)
    with open(hpath, "w") as f:
        f.write(f"{tile_hash} {src_fp}")
    log(f"block view cached: {time.time()-t0:.0f}s")
    return bv, tile_hash, True


def main(argv=None) -> dict:
    """Returns {"rows", "record", "device_bytes", "view_built": whether
    the block view was derived now}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("V", nargs="?", type=int, default=512)
    ap.add_argument("n_postings", nargs="?", type=int, default=None)
    ap.add_argument("--cache-dir", default=CACHE)
    ap.add_argument("--record", default=RECORD)
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    n_docs = int(os.environ.get("B88_N_DOCS", 8_800_000))
    n_postings = (args.n_postings if args.n_postings is not None
                  else int(os.environ.get("B88_N_POSTINGS", 3500)))
    V = args.V

    import torch

    from ..device import resolve_device

    dev = resolve_device(args.device)
    log(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}")
    with np.load(os.path.join(args.cache_dir,
                              f"queries88_{DIM}_2048.npz")) as qz:
        q_comps, q_vals = qz["q_comps"], qz["q_vals"]
    gt_ids = get_gt(q_comps, q_vals, n_docs, args.cache_dir, args.device)

    base = os.path.join(args.cache_dir, f"index88_{n_docs}_{DIM}_{n_postings}")
    bv, tile_hash, built = block_view(base, V)
    E = int(bv.max_block_len)

    t0 = time.time()
    # csub 1 on the bin-packed regions, the lean forward rows
    index = bv.to_device(dev, tile_csub=1, tile_hash=tile_hash)
    ctx = PlannerContext.from_arrays(bv, csub=1)
    protocol.sync(dev)
    dev_b = index.nbytes()
    log(f"to_device(8.8M block V={V})+ctx: {time.time()-t0:.0f}s "
        f"device={dev_b/1e9:.2f}GB")

    qn, vn = q_comps[:B], q_vals[:B]
    nq = len(qn)  # B, or fewer on a cut stream: the rates count these
    qd = torch.from_numpy(np.ascontiguousarray(qn, np.int32)).to(dev)
    vd = torch.from_numpy(np.ascontiguousarray(vn, np.float32)).to(dev)

    def run(gp, qcut, reps=REPS):
        gc, wc = plan_caps(qn, vn, ctx, qcut, M=M)
        out = search_grouped_derive(index, qd, vd, gp, qcut, M, gc, wc,
                                    ctx.zero_region)
        protocol.sync(dev)
        t0 = time.time()
        for _ in range(reps):
            out = search_grouped_derive(index, qd, vd, gp, qcut, M, gc, wc,
                                        ctx.zero_region)
        protocol.sync(dev)
        dt = (time.time() - t0) / reps
        return dt, recall_at_k(out[1].cpu().numpy(), gt_ids[:B])

    # rescore_chunk bounds the block_expand tail's forward-row gathers
    basep = GroupedParams(k=10, score_cut=64, pool=32, block_expand=E,
                          compute_dtype="i8", pool_mode="hier",
                          pool_per_pair=8, kernel_unroll=8,
                          rescore_chunk=1024)
    results = []
    meta = {"n_docs": n_docs, "dim": DIM, "n_postings": n_postings,
            "tile_mode": "block", "V": V, "batch": B, "device_bytes": dev_b,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else str(dev)),
            "note": NOTE}

    def flush():
        # after every rung: a cut run still leaves the rungs run
        protocol.write_record(args.record, {**meta, "rungs": results})

    for qcut, pool, ppp in LADDER:
        gp = dataclasses.replace(basep, pool=pool, pool_per_pair=ppp)
        try:
            before = protocol.kernel_launches()
            dt, rec = run(gp, qcut)
            log(f"e2e 8.8M block V{V} qc{qcut} p{pool}xE{E}: "
                f"{dt*1e3:8.2f} ms  recall@10={rec:.4f} QPS={nq/dt:,.0f}")
            results.append({
                "qc": qcut, "pool": pool, "E": E,
                "recall_at_10": round(rec, 4), "qps": round(nq / dt, 1),
                "ms_per_batch": round(dt * 1e3, 2),
                "launches": launches_since(before),
            })
            flush()
        except Exception as e:  # noqa: BLE001 - one rung's failure, logged
            log(f"qc{qcut}/p{pool}: FAILED {type(e).__name__}: {e}")
    flush()
    log(f"wrote {args.record}")
    return {"rows": results, "record": args.record, "device_bytes": dev_b,
            "view_built": built}


if __name__ == "__main__":
    main()
