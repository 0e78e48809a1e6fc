"""Per-stage latency profile of the engine's search program.

The port of `seismic_tpu/harness/profile_stages.py`. JAX's version times
each stage as its own jit in plain `jnp`; this one runs the port's own
stages, the functions of `search/engine.py` in the order `_search_impl`
calls them, each timed on its own with CUDA events on the card (a
warm-up call, then `--reps` calls between two events; the host clock on
the CPU), so the profile shows what the real program pays, kernels
included:

- the block form (`profile`, the engine's rescore doc mode): list
  selection and the dense query; dense block ranking (the list
  vocabularies' lookup and the u8 block-summary products); the block
  budget and heap-factor cut; the candidate windows; the coarse sketch
  ranking of every candidate (timed only, as JAX's profile times it);
  exact scoring by K3's fused rescore (`ops/rescore.py::rescore_exact`,
  512-column chunks); the pool, dedup and top-k;
- the tiles form (`profile_tiles`, `--tiles`: the engine's tiles doc
  mode over whole lists): list selection; the projection of each pair's
  query onto its list's vocabulary (a lookup into the dense top terms:
  the engine's tiles path calls no kernel there; K1 projects on the
  grouped route); the tile scorer K7 (`ops/tiles_scorer.py`, pairs
  grouped by list); the pool; the overflow rescore of the pool; dedup
  and top-k.

Each form ends by holding its final top-k against `search/engine.py::
_search_impl` on the same index and queries with the same parameters
(ids and scores equal: `matches_search_batch`).

    python -m seismic_tpu_torch.harness.profile_stages --index INDEX \\
        [--batch 256] [--tiles | --both] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def _timeit(fn, *args, reps: int = 5):
    """(ms per call, the last call's output): one warm-up call, then
    `reps` calls between two CUDA events (the host clock on the CPU)."""
    import torch

    out = fn(*args)
    cuda = torch.cuda.is_available() and _device_of(out).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    if cuda:
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps, out
    return (time.perf_counter() - t0) * 1e3 / reps, out


def _device_of(out):
    import torch

    if torch.is_tensor(out):
        return out.device
    for x in out:
        if torch.is_tensor(x):
            return x.device
    return torch.device("cpu")


def _matches(index, q_comps, q_vals, heap_factor, params, final) -> bool:
    from ..search.engine import _search_impl

    s_ref, i_ref = _search_impl(index, q_comps, q_vals, heap_factor, params)
    s, i = final
    return bool((i.to(i_ref.dtype) == i_ref).all()
                and (s == s_ref).all())


def profile(index, q_comps, q_vals, query_cut=20, block_budget=256,
            heap_factor=0.4, k=10, reps=5):
    """{stage: ms per batch, "_meta": shapes, "matches_search_batch"} of
    the engine's rescore doc mode on `index` (a DeviceIndex with dense
    block summaries) for q_comps / q_vals [B, Q] tensors on its device."""
    import torch

    from ..ops.rescore import rescore_exact
    from ..search import engine as E

    B = q_comps.shape[0]
    dev = q_comps.device
    n_docs = index.n_docs
    MB = max(index.max_blocks_per_list, 1)
    Lmax = max(index.max_block_len, 1)
    sentinel_block = index.block_start.shape[0] - 1
    hf = float(np.float32(heap_factor))
    params = E.SearchParams(k=k, query_cut=query_cut,
                            block_budget=block_budget, block_mode="dense",
                            doc_mode="rescore")
    res = {}

    def stage_prep(q_comps, q_vals):
        qv, safe_lists, sel_valid = E._select_lists(index, q_comps, q_vals,
                                                    query_cut)
        return qv, safe_lists, sel_valid, E.densify_query_batch(
            q_comps, qv, index.dim)

    res["1_prep_select_densify"], (qv, safe_lists, sel_valid, qd) = _timeit(
        stage_prep, q_comps, q_vals, reps=reps)
    QC = safe_lists.shape[1]

    def stage_blocks(qd, safe_lists, sel_valid):
        lists = safe_lists.long()
        lbs = index.list_block_start[lists]
        lnb = index.list_n_blocks[lists]
        steps = torch.arange(MB, dtype=torch.int32, device=dev)
        bmask = (steps < lnb[..., None]) & sel_valid[..., None]
        block_ids = torch.where(bmask, lbs[..., None] + steps,
                                sentinel_block).reshape(B, QC * MB)
        qloc = E._lookup(qd, index.vocab[lists])
        scores = E._dense_block_scores(index, lbs, qloc, MB).reshape(
            B, QC * MB)
        return (torch.where(bmask.reshape(B, QC * MB), scores, -torch.inf),
                block_ids)

    res["2_block_ranking_dense"], (block_scores, block_ids) = _timeit(
        stage_blocks, qd, safe_lists, sel_valid, reps=reps)
    BE = min(block_budget if block_budget > 0 else QC * MB, QC * MB)

    def stage_select(block_scores, block_ids):
        tbs, tbp = E._top_k(block_scores, BE)
        sel = torch.gather(block_ids, 1, tbp)
        thr = E._heap_threshold(tbs[:, min(k, BE) - 1], hf)
        eval_mask = torch.isfinite(tbs) & (tbs >= thr[:, None])
        return torch.where(eval_mask, sel, sentinel_block).long(), eval_mask

    res["3_block_topk_select"], (sel_blocks, eval_mask) = _timeit(
        stage_select, block_scores, block_ids, reps=reps)

    def stage_windows(sel_blocks, eval_mask):
        starts = index.block_start[sel_blocks]
        lens = index.block_len[sel_blocks]
        offs = torch.arange(Lmax, dtype=torch.int32, device=dev)
        pidx = (starts[..., None] + offs).clamp(
            max=index.postings.shape[0] - 1).long()
        cmask = (offs < lens[..., None]) & eval_mask[..., None]
        cand = torch.where(cmask, index.postings[pidx], n_docs)
        return cand.reshape(B, BE * Lmax), cmask.reshape(B, BE * Lmax)

    res["4_candidate_windows"], (cand_ids, cmask) = _timeit(
        stage_windows, sel_blocks, eval_mask, reps=reps)
    NC = BE * Lmax
    safe_cand = cand_ids.clamp(max=n_docs - 1)

    if index.doc_sketch is not None:
        from ..ops.sketch import sketch_padded_queries

        def stage_coarse(safe_cand, cmask):
            q_sk = sketch_padded_queries(q_comps, q_vals, 128, 42)
            coarse = E._sketch_scores(index.doc_sketch,
                                      index.doc_sketch_scale, safe_cand,
                                      q_sk)
            return torch.where(cmask, coarse, -torch.inf)

        res["5_coarse_sketch_all_cands"], _ = _timeit(
            stage_coarse, safe_cand, cmask, reps=reps)

    def stage_exact(safe_cand, cmask):
        top_c, top_v, sc = E._query_terms(q_comps, qv, params.score_cut)
        scores = rescore_exact(index, safe_cand, top_c, top_v, sc,
                               chunk_r=512)
        return torch.where(cmask, scores, -torch.inf)

    res["6_exact_scoring_k3"], scores = _timeit(stage_exact, safe_cand,
                                                cmask, reps=reps)
    pool = min(max(8 * k, 64), NC)

    def stage_final(scores, cand_ids):
        ps, ppos = E._top_k(scores, pool)
        s, ids = E._dedup_by_id(ps, torch.gather(cand_ids, 1, ppos), n_docs)
        ts, pos = E._top_k(s, k)
        tid = torch.gather(ids, 1, pos)
        return ts, torch.where(torch.isfinite(ts), tid, -1)

    res["7_pool_dedup_topk"], final = _timeit(stage_final, scores, cand_ids,
                                              reps=reps)
    res["_meta"] = dict(B=B, QC=QC, MB=MB, BE=BE, Lmax=Lmax, NC=NC,
                        dim=index.dim)
    res["matches_search_batch"] = _matches(index, q_comps, q_vals, hf,
                                           params, final)
    return res


def profile_tiles(index, q_comps, q_vals, query_cut=10, score_cut=64, k=10,
                  reps=5):
    """The same for the engine's tiles doc mode over whole lists (an
    upload with doc tiles at tile_csub 1)."""
    import torch

    from ..ops.tiles_prep import ll_pad_for
    from ..ops.tiles_scorer import score_tiles
    from ..search import engine as E

    B = q_comps.shape[0]
    n_docs = index.n_docs
    LL = ll_pad_for(index.max_list_len)
    params = E.SearchParams(k=k, query_cut=query_cut, block_mode="dense",
                            doc_mode="tiles", full_lists=True,
                            score_cut=score_cut)
    res = {}

    def s1(q_comps, q_vals):
        return E._select_lists(index, q_comps, q_vals, query_cut)

    res["1_term_select"], (qv, safe_lists, sel_valid) = _timeit(
        s1, q_comps, q_vals, reps=reps)
    QC = safe_lists.shape[1]

    def s2(qv, safe_lists):
        return E._tiles_scorer_inputs(index, q_comps, qv, safe_lists,
                                      score_cut)

    res["2_qloc_lookup"], (qd_top, qloc, region_start, lln) = _timeit(
        s2, qv, safe_lists, reps=reps)

    def s3(qloc, region_start, lln):
        return score_tiles(index.doc_tiles_aligned, index.tile_scale,
                           region_start.reshape(B * QC),
                           qloc.reshape(B * QC, -1), lln.reshape(B * QC),
                           LL).reshape(B, QC, LL)

    res["3_tile_scorer_k7"], scores = _timeit(s3, qloc, region_start, lln,
                                              reps=reps)
    lps = index.list_post_start[safe_lists.long()]
    pool = min(max(8 * k, 64), QC * LL)

    def s4(scores):
        offs = torch.arange(LL, dtype=torch.int32, device=scores.device)
        mask = (offs < lln[..., None]) & sel_valid[..., None]
        flat = torch.where(mask, scores, -torch.inf).reshape(B, QC * LL)
        ts, pos = E._top_k(flat, pool)
        pidx = torch.gather(lps, 1, pos // LL) + (pos % LL).to(torch.int32)
        safe_post = pidx.clamp(max=index.postings.shape[0] - 1).long()
        ids = torch.where(torch.isfinite(ts), index.postings[safe_post],
                          n_docs)
        return ts, ids, safe_post

    res["4_pool_topk_ids"], (ts, ids, safe_post) = _timeit(s4, scores,
                                                           reps=reps)

    def s5(ts, safe_post):
        if index.tile_ovf_comps is None or score_cut <= 0:
            return ts
        qmatch = E._lookup(qd_top, index.tile_ovf_comps[safe_post])
        ov = index.tile_ovf_vals[safe_post].to(torch.float32)
        return torch.where(torch.isfinite(ts),
                           ts + (qmatch * ov).sum(dim=-1), ts)

    res["5_overflow_rescore"], ts = _timeit(s5, ts, safe_post, reps=reps)

    def s6(ts, ids):
        s, d = E._dedup_by_id(ts, ids, n_docs)
        fs, fp = E._top_k(s, k)
        fid = torch.gather(d, 1, fp)
        return fs, torch.where(torch.isfinite(fs), fid, -1)

    res["6_dedup_topk"], final = _timeit(s6, ts, ids, reps=reps)
    res["_meta"] = dict(B=B, QC=QC, V=int(index.doc_tiles_aligned.shape[1]),
                        LL=LL, pool=pool)
    res["matches_search_batch"] = _matches(index, q_comps, q_vals, 0.0,
                                           params, final)
    return res


def report(res: dict) -> None:
    meta = res["_meta"]
    print("meta:", meta)
    total = 0.0
    for name in sorted(res):
        if name.startswith("_") or name == "matches_search_batch":
            continue
        ms = res[name]
        print(f"{name:32s} {ms:9.3f} ms/batch "
              f"{ms / meta['B'] * 1e3:9.2f} us/query")
        total += ms
    print(f"{'TOTAL':32s} {total:9.3f} ms/batch "
          f"{total / meta['B'] * 1e3:9.2f} us/query")
    print(f"final top-k equals the engine program's: "
          f"{res['matches_search_batch']}")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--index", required=True)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--query-cut", type=int, default=20)
    p.add_argument("--block-budget", type=int, default=256)
    p.add_argument("--dim", type=int, default=None,
                   help="the queries' dimension (default: the index's)")
    p.add_argument("--reps", type=int, default=5)
    form = p.add_mutually_exclusive_group()
    form.add_argument("--tiles", action="store_true",
                      help="profile the tiles search mode")
    form.add_argument("--both", action="store_true",
                      help="profile both forms on one upload")
    p.add_argument("--device", default=None,
                   help="the card by default; 'cpu' runs the plain versions")
    args = p.parse_args(argv)

    import torch

    from ..data.sparse import pad_queries
    from ..types import IndexArrays
    from .synth import synth_queries

    arrays = IndexArrays.load(args.index)
    index = arrays.to_device(args.device)
    dev = index.device
    qc, qv = synth_queries(args.batch, dim=args.dim or arrays.dim, seed=11)
    q_comps, q_vals = (torch.from_numpy(x).to(dev)
                       for x in pad_queries(qc, qv, 64))
    out = {"device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu")}
    print(f"device: {out['device']}")
    if not args.tiles:
        out["blocks"] = profile(index, q_comps, q_vals, args.query_cut,
                                args.block_budget, reps=args.reps)
        report(out["blocks"])
    if args.tiles or args.both:
        out["tiles"] = profile_tiles(index, q_comps, q_vals, args.query_cut,
                                     reps=args.reps)
        report(out["tiles"])
    return out


if __name__ == "__main__":
    main()
