"""The multi-device dry run: one sharded search of each production
configuration over a mesh of `n_devices` entries (the port of the dry-run
stages of the JAX repo's `__graft_entry__.py:54-305`).

    python -m seismic_tpu_torch.harness.dryrun [--n-devices 4] [--device cpu]

Stages, in order (each prints JAX's `dryrun_multichip ... ok` line):

- `engine`: 256 docs at dim 1024, the engine route in tiles mode at
  heap_factor 0.8 on a (data, docs) mesh;
- `88m-recipe`: the 8.8M-doc recipe's code path, cut to 512 docs at dim
  512 and split raggedly (shard s takes a 1 + s/2 share): u8 values, no
  doc tiles, no sketches, the lean forward upload, dense block tiles as
  wide as the vocabulary (`tile_block`) at csub 2, the `block_expand`
  tail with a hier pool; its line carries each shard's postings and
  their balance;
- `grouped`: 192 docs at dim 512, the grouped route (f32 scorer, exact
  pool) with the batch split over "data";
- `block`: the same collection on the blocks-as-rows view (`tile_block`,
  i8, exact pool, `block_expand`).

The mesh repeats `device` (the card by default) `n_devices` times, so one
card runs every shard. Nothing is compiled, so the stages share one
process. On the card the local vocabularies and block rows of the last
three stages are 256 wide where JAX's are 128: the port's grouped scorers
(K2, K6) take widths in multiples of 256 (`csrc/grouped_scorer.cu`,
`csrc/grouped_scorer_f.cu`); on the CPU the stages keep JAX's 128.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

STAGES = ("engine", "88m-recipe", "grouped", "block")


def _tiny_setup(n_docs=512, dim=2048, seed=0, vocab_cap=256, n_queries=32):
    from ..config import Configuration, TpuLayout
    from ..data.sparse import pad_queries
    from .synth import synth_dataset, synth_queries

    ds = synth_dataset(n_docs, dim=dim, mean_nnz=48, std_nnz=12, max_nnz=96,
                       seed=seed)
    cfg = Configuration(layout=TpuLayout(
        max_block_len=32, summary_vocab_cap=vocab_cap, max_doc_nnz=128))
    qc, qv = synth_queries(n_queries, dim=dim, mean_nnz=24, std_nnz=6,
                           max_nnz=48, seed=seed + 1)
    q_comps, q_vals = pad_queries(qc, qv, 64)
    return ds, cfg, q_comps, q_vals


def _narrow_v(device) -> int:
    """JAX's 128 on the CPU; on the card 256, the narrowest width the
    port's grouped scorers take."""
    return 256 if device.type == "cuda" else 128


def _stage(name: str, n_devices: int, device) -> str:
    from ..build.builder import build_index
    from ..parallel.mesh import make_mesh
    from ..parallel.sharded import ShardedIndex
    from ..search.engine import SearchParams
    from ..search.grouped import GroupedParams

    if name == "88m-recipe":
        return _recipe_88m(n_devices, device)
    if name == "engine":
        ds, cfg, q_comps, q_vals = _tiny_setup(n_docs=256, dim=1024)
    else:
        ds, cfg, q_comps, q_vals = _tiny_setup(
            n_docs=192, dim=512, vocab_cap=_narrow_v(device), n_queries=16)
    n_data = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = make_mesh(n_docs_shards=n_devices // n_data, n_data=n_data,
                     devices=[device] * n_devices)
    n_shards = mesh.shape["docs"]
    bounds = np.linspace(0, len(ds), n_shards + 1).astype(np.int64)
    shards = [build_index(ds.subset(np.arange(int(bounds[s]),
                                              int(bounds[s + 1]))), cfg)
              for s in range(n_shards)]
    offsets = [int(b) for b in bounds[:-1]]
    B = q_comps.shape[0]
    if name == "engine":
        sharded = ShardedIndex.from_shards(shards, offsets, mesh, len(ds),
                                           cfg)
        params = SearchParams(k=10, query_cut=8, block_budget=16,
                              doc_mode="tiles", full_lists=True)
        s_, i_ = sharded.search_batch(q_comps, q_vals, params,
                                      heap_factor=0.8)
        if s_.shape != (B, 10) or not (i_ < 256).all():
            raise AssertionError(f"engine stage: {s_.shape}")
        tag = ""
    elif name == "grouped":
        sharded = ShardedIndex.from_shards(shards, offsets, mesh, len(ds),
                                           cfg, pallas_tiles=True)
        gp = GroupedParams(k=10, score_cut=64, pool=32, rescore=16,
                           compute_dtype="f32", pool_mode="exact")
        s_, i_ = sharded.search_batch_grouped(q_comps, q_vals, gp,
                                              query_cut=6)
        tag = " grouped"
    elif name == "block":
        sharded = ShardedIndex.from_shards(shards, offsets, mesh, len(ds),
                                           cfg, pallas_tiles=True,
                                           tile_block=_narrow_v(device))
        gp = GroupedParams(k=10, score_cut=64, pool=16,
                           block_expand=int(cfg.layout.max_block_len),
                           compute_dtype="i8", pool_mode="exact")
        s_, i_ = sharded.search_batch_grouped(q_comps, q_vals, gp,
                                              query_cut=6)
        tag = " block"
    else:
        raise ValueError(f"unknown dryrun stage {name!r}")
    if s_.shape != (B, 10) or not (i_ < len(ds)).all():
        raise AssertionError(f"{name} stage: {s_.shape}")
    return (f"dryrun_multichip{tag} ok: mesh={mesh.shape} "
            f"results={s_.shape}, finite={np.isfinite(s_).mean():.2f}")


def _recipe_88m(n_devices: int, device) -> str:
    from ..build.builder import build_index
    from ..config import Configuration, TpuLayout
    from ..data.sparse import pad_queries
    from ..parallel.mesh import make_mesh
    from ..parallel.sharded import ShardedIndex
    from ..search.grouped import GroupedParams
    from .synth import synth_dataset, synth_queries

    n_docs, dim, V = 512, 512, _narrow_v(device)
    ds = synth_dataset(n_docs, dim=dim, mean_nnz=48, std_nnz=12, max_nnz=96,
                       seed=42)
    cfg = Configuration(layout=TpuLayout(
        max_block_len=32, max_summary_nnz=64, summary_vocab_cap=V,
        tile_overflow=0, sketch_dim=0, max_doc_nnz=128))
    qc, qv = synth_queries(16, dim=dim, mean_nnz=24, std_nnz=6, max_nnz=48,
                           seed=43)
    q_comps, q_vals = pad_queries(qc, qv, 64)
    mesh = make_mesh(n_docs_shards=n_devices, n_data=1,
                     devices=[device] * n_devices)
    n_shards = mesh.shape["docs"]
    # a ragged split: shard s takes a 1 + s/2 share
    w = 1.0 + np.arange(n_shards) / 2.0
    bounds = np.round(np.concatenate([[0.0], np.cumsum(w)]) / w.sum()
                      * n_docs).astype(np.int64)
    shards = [build_index(
        ds.subset(np.arange(int(bounds[s]), int(bounds[s + 1]))), cfg,
        value_dtype="u8", store_doc_tiles=False, store_sketches=False,
        store_summaries=True) for s in range(n_shards)]
    postings = [int(np.sum(np.asarray(s.list_len))) for s in shards]
    sharded = ShardedIndex.from_shards(
        shards, [int(b) for b in bounds[:-1]], mesh, n_docs, cfg,
        pallas_tiles=True, tile_csub=2, tile_block=V)
    if sharded.device_index[0][0].fwd_fused is not None:
        raise AssertionError("88m-recipe: the upload is not lean")
    gp = GroupedParams(k=10, score_cut=64, pool=16,
                       block_expand=int(cfg.layout.max_block_len),
                       compute_dtype="i8", pool_mode="hier",
                       pool_per_pair=8)
    s_, i_ = sharded.search_batch_grouped(q_comps, q_vals, gp, query_cut=8)
    if s_.shape != (q_comps.shape[0], 10) or not (i_ < n_docs).all():
        raise AssertionError(f"88m-recipe stage: {s_.shape}")
    bal = max(postings) / max(1.0, float(np.mean(postings)))
    return (f"dryrun_multichip 88m-recipe ok: mesh={mesh.shape} "
            f"ragged docs={np.diff(bounds).tolist()} postings={postings} "
            f"balance_max_over_mean={bal:.2f} results={s_.shape}, "
            f"finite={np.isfinite(s_).mean():.2f}")


def dryrun_multichip(n_devices: int, device=None) -> list:
    """Run the four stages on meshes of `n_devices` entries of `device`
    (None: the card; raises without CUDA); prints and returns their `ok`
    lines. A failed stage raises."""
    from ..device import resolve_device

    dev = resolve_device(device)
    t0 = time.time()
    lines = []
    for name in STAGES:
        t_st = time.time()
        line = _stage(name, n_devices, dev)
        print(line, flush=True)
        print(f"dryrun_multichip {name} stage_s={time.time() - t_st:.1f}",
              flush=True)
        lines.append(line)
    print(f"dryrun_multichip done: {len(lines)}/{len(STAGES)} stages in "
          f"{time.time() - t0:.0f}s", flush=True)
    return lines


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-devices", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="the device the mesh repeats (default: the card)")
    args = ap.parse_args()
    dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main()
