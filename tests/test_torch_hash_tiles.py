"""seismic_tpu_torch's hashed doc tiles and streaming budget against the
JAX package, on the CPU, on one synthetic index (the fixture of
tests/test_hash_tiles.py: numpy data from a seed) carried across with
`from_jax_arrays`:

- the host layouts bit-equal to JAX's NumPy: `hash_retile` (the NumPy
  copy and the torch version), the hashed block rows, the super-tile
  summaries;
- the hashed projection's int8 codes and scales (one row per query, K1's
  plain version over the vocab row arange(V)) bit-equal to the JAX
  program's, read at its "expand" stage on the same host plan;
- hashed grouped search in i8 and bf16 against JAX's (interpret mode):
  equal id sets, scores to 1e-5 relative;
- `stream_frac` 0.5 on an upload with super summaries against JAX's, the
  same; no returned id outside the scored super-tiles' postings;
- the engine's dense block ranking on a hashed upload (the list
  vocabulary kept, as JAX keeps `list_vocab`) against JAX's engine:
  id sets on >= 98% of queries, scores to 1e-3 (the repo's gate);
- the refusals the JAX package makes too."""

import dataclasses

import numpy as np
import pytest
import torch

from seismic_tpu_torch import from_jax_arrays
from seismic_tpu_torch.data.sparse import pad_queries
from seismic_tpu_torch.ops import tiles_prep
from seismic_tpu_torch.search import engine as tengine
from seismic_tpu_torch.search import grouped as tgrouped
from seismic_tpu_torch.search.planner import PlannerContext
from tests.conftest import make_random_dataset, make_random_queries

K, QC, HV = 10, 10, 256
CPU = torch.device("cpu")


def _port(ja):
    return from_jax_arrays({f.name: getattr(ja, f.name)
                            for f in dataclasses.fields(ja)})


@pytest.fixture(scope="module")
def setup():
    """The index of tests/test_hash_tiles.py (f16 values, V=256 tiles)
    and a u8 DotVByte build of the same data (CSR summaries, no dense
    ones), each with its port copy, and 16 queries padded to 64 terms."""
    pytest.importorskip("jax")
    from seismic_tpu import Configuration, TpuLayout
    from seismic_tpu.build.builder import build_index

    ds = make_random_dataset(np.random.default_rng(11), n_docs=400, dim=600,
                             min_nnz=15, max_nnz=50, seed=47)
    ja = build_index(ds, Configuration(layout=TpuLayout(
        max_block_len=16, summary_vocab_cap=256)))
    ju8 = build_index(ds, Configuration(layout=TpuLayout(
        max_block_len=16, summary_vocab_cap=0)), value_dtype="u8",
        store_doc_tiles=False)
    qc, qv = make_random_queries(np.random.default_rng(3), n_queries=16,
                                 dim=600, min_nnz=8, max_nnz=30)
    q_comps, q_vals = pad_queries(qc, qv, 64)
    return ja, _port(ja), ju8, _port(ju8), q_comps, q_vals


@pytest.fixture(scope="module")
def hashed(setup):
    """Both packages' hash_retile'd arrays at V=256."""
    from seismic_tpu.ops.pallas_tiles import hash_retile as j_hash

    ja, ta = setup[:2]
    return j_hash(ja, HV), tiles_prep.hash_retile(ta, HV)


@pytest.mark.parametrize("which", ["numpy", "torch", "u8_values"])
def test_hash_retile_bit_equal(setup, hashed, which):
    """`hash_retile` (NumPy) and `hash_retile_torch` give JAX's tiles and
    scales bit for bit, on f16 values and on u8 codes with a per-doc
    min / step (no doc tiles: the tail rows are added)."""
    from seismic_tpu.ops.pallas_tiles import hash_retile as j_hash

    ja, ta, ju8, tu8 = setup[:4]
    jh, th = hashed
    if which == "torch":
        th = tiles_prep.hash_retile_torch(ta, HV, device="cpu", chunk=97)
    elif which == "u8_values":
        jh = j_hash(ju8, 128)
        th = tiles_prep.hash_retile_torch(tu8, 128, device="cpu")
        np.testing.assert_array_equal(
            tiles_prep.hash_retile(tu8, 128).doc_tiles, th.doc_tiles)
    np.testing.assert_array_equal(th.doc_tiles, jh.doc_tiles)
    np.testing.assert_array_equal(th.doc_tile_scale.view(np.int32),
                                  jh.doc_tile_scale.view(np.int32))
    assert th.doc_tiles.dtype == np.uint8


def test_hashed_block_rows_bit_equal(setup):
    """`block_pool_arrays(mode="hash")` equals JAX's view array for array
    (the collision-summed mod-V rows of the u8 CSR summaries)."""
    from seismic_tpu.ops.pallas_tiles import block_pool_arrays as j_view

    ju8, tu8 = setup[2:4]
    jv = j_view(ju8, 128, order_members=True, mode="hash")
    tv = tiles_prep.block_pool_arrays(tu8, 128, order_members=True,
                                      mode="hash")
    assert tv.doc_tiles.shape == (ju8.summary_comps.shape[0], 128)
    for f in dataclasses.fields(jv):
        a, b = getattr(tv, f.name), getattr(jv, f.name)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f.name)
        elif f.name != "config":
            assert a == b, f.name


@pytest.mark.parametrize("csub", [1, 2])
def test_super_tile_summaries_bit_equal(setup, csub):
    """The upload's super-tile bounds equal JAX's `super_tile_summaries`
    of its own aligned layout."""
    ja, ta = setup[:2]
    jd = ja.to_device(pallas_tiles=True, tile_csub=csub,
                      super_summaries=True)
    td = ta.to_device(CPU, tile_csub=csub, super_summaries=True)
    np.testing.assert_array_equal(td.super_summary.numpy(),
                                  np.asarray(jd.super_summary))
    np.testing.assert_array_equal(td.super_scale.numpy(),
                                  np.asarray(jd.super_scale))
    assert td.super_summary.shape[0] * csub * 128 == \
        td.doc_tiles_aligned.shape[0]


def _hash_params(dt, **kw):
    return dict(dict(k=K, score_cut=64, pool=64, rescore=32,
                     compute_dtype=dt, pool_mode="exact"), **kw)


def _assert_same(s_t, i_t, s_j, i_j, rtol=1e-5):
    for a, b in zip(i_t, i_j):
        assert set(map(int, a[a >= 0])) == set(map(int, b[b >= 0]))
    fin = np.isfinite(s_j)
    assert (np.isfinite(s_t) == fin).all()
    np.testing.assert_allclose(np.sort(s_t, 1), np.sort(s_j, 1), rtol=rtol)


def test_hashed_projection_bit_equal(setup, hashed):
    """The hashed projection's int8 codes (expanded to the slot grid) and
    scales equal the JAX program's on the same host plan: K1's plain
    version over the one vocab row arange(V), the query terms hashed to
    comp mod V (repeated ids summed in term order), scale max / 127 as
    XLA's reciprocal multiply."""
    from seismic_tpu.search.grouped import GroupedParams as JParams
    from seismic_tpu.search.grouped import search_grouped as j_search
    from seismic_tpu.search.planner import PlannerContext as JCtx

    q_comps, q_vals = setup[4:]
    jh, th = hashed
    kw = _hash_params("i8", stop_after="expand")
    jq, _ = j_search(jh.to_device(pallas_tiles=True, tile_hash=HV),
                     JCtx.from_arrays(jh), q_comps, q_vals, JParams(**kw),
                     query_cut=QC)
    tdev = th.to_device(CPU, tile_hash=HV)
    # the list vocabulary goes up on a hashed upload too, as JAX's
    # list_vocab does (int16 here, its -1 for PAD)
    lv = np.asarray(th.list_vocab)
    assert tdev.tile_hash == HV
    np.testing.assert_array_equal(
        tdev.vocab16.numpy(), np.where(lv == 2 ** 31 - 1, -1, lv))
    tq, _ = tgrouped.search_grouped(tdev, PlannerContext.from_arrays(th),
                                    q_comps, q_vals,
                                    tgrouped.GroupedParams(**kw),
                                    query_cut=QC)
    np.testing.assert_array_equal(tq, np.asarray(jq))
    # the per-query scale, broadcast to the pair grid, and the hashed
    # term rows hold repeated ids
    qc_t = torch.from_numpy(q_comps)
    qv_t = torch.from_numpy(q_vals)
    top_c, top_v, _ = tengine._query_terms(qc_t, qv_t, 64)
    ops = tgrouped.hashed_qloc_operands(HV, top_c, top_v)
    rows = ops[2][ops[2] != 2 ** 31 - 1].reshape(-1)
    assert len(torch.unique(rows)) < len(rows)
    q_i8, scale = tgrouped._project_hashed(HV, top_c, top_v, QC, True)
    assert q_i8.shape == (len(q_comps), HV)
    np.testing.assert_array_equal(scale.reshape(-1, QC)[:, 0].numpy(),
                                  scale.reshape(-1, QC)[:, -1].numpy())


@pytest.mark.parametrize("dt", ["i8", "bf16"])
def test_hashed_search_matches_jax(setup, hashed, dt):
    """Hashed grouped search (one projection row per query) against JAX's
    in interpret mode: equal id sets, scores to 1e-5 relative; the engine
    path refuses the hashed upload's tiles mode as JAX's does."""
    from seismic_tpu.search.grouped import GroupedParams as JParams
    from seismic_tpu.search.grouped import search_grouped as j_search
    from seismic_tpu.search.planner import PlannerContext as JCtx

    q_comps, q_vals = setup[4:]
    jh, th = hashed
    kw = _hash_params(dt)
    s_j, i_j = j_search(jh.to_device(pallas_tiles=True, tile_hash=HV),
                        JCtx.from_arrays(jh), q_comps, q_vals,
                        JParams(**kw), query_cut=QC)
    tdev = th.to_device(CPU, tile_hash=HV)
    s_t, i_t = tgrouped.search_grouped(
        tdev, PlannerContext.from_arrays(th), q_comps, q_vals,
        tgrouped.GroupedParams(**kw), query_cut=QC)
    _assert_same(s_t, i_t, np.asarray(s_j), np.asarray(i_j))
    if dt == "i8":
        with pytest.raises(ValueError, match="HASHED tiles"):
            tengine.search_batch(tdev, q_comps, q_vals, tengine.SearchParams(
                k=K, query_cut=QC, doc_mode="tiles", block_mode="summary"))


@pytest.mark.parametrize("doc_mode", ["gather", "rescore"])
def test_engine_dense_ranking_on_hashed_upload_matches_jax(setup, hashed,
                                                           doc_mode):
    """The engine's dense block ranking (`block_mode="dense"`,
    heap_factor 0.8) on a `tile_hash` upload against JAX's engine on its
    own hashed upload: the list vocabulary and the dense summaries are
    the unhashed ones in both, so the results equal the unhashed
    upload's too. Id sets on >= 98% of queries, scores to 1e-3 relative
    (bench.py:355-360)."""
    from seismic_tpu import SearchParams as JParams
    from seismic_tpu.search.engine import search_batch as j_search

    q_comps, q_vals = setup[4:]
    jh, th = hashed
    kw = dict(k=K, query_cut=QC, block_mode="dense", doc_mode=doc_mode,
              block_budget=0)
    jdev = jh.to_device(pallas_tiles=True, tile_hash=HV)
    assert jdev.list_vocab is not None
    s_j, i_j = j_search(jdev, q_comps, q_vals, JParams(use_pallas=True, **kw),
                        heap_factor=0.8)
    tdev = th.to_device(CPU, tile_hash=HV)
    s_t, i_t = tengine.search_batch(tdev, q_comps, q_vals,
                                    tengine.SearchParams(**kw),
                                    heap_factor=0.8)
    s_j, i_j = np.asarray(s_j), np.asarray(i_j)
    same = np.mean([set(a[a >= 0]) == set(b[b >= 0])
                    for a, b in zip(i_t, i_j)])
    assert same >= 0.98, same
    fin = np.isfinite(s_j)
    assert (np.isfinite(s_t) == fin).all() and fin.mean() > 0.9
    rel = np.abs(s_t[fin] - s_j[fin]) / np.maximum(np.abs(s_j[fin]), 1e-6)
    assert rel.max() < 1e-3, rel.max()
    # the hashed tiles do not enter the dense ranking: the unhashed
    # upload returns the same ids
    _, i_u = tengine.search_batch(setup[1].to_device(CPU), q_comps, q_vals,
                                  tengine.SearchParams(**kw),
                                  heap_factor=0.8)
    np.testing.assert_array_equal(i_u, i_t)


@pytest.mark.parametrize("pool_mode,frac", [
    ("exact", 0.5), ("exact", 0.0625), ("slot", 0.0625)])
def test_stream_frac_matches_jax(setup, pool_mode, frac):
    """The streaming budget (i8, slot-major scorer) against JAX's on an
    upload with super summaries: equal id sets and scores; every returned
    id is a posting of a kept work item's rows. At 0.5 the budget of
    max(128, round(0.5 * W_cap)) items holds the whole work list here
    (W_cap is a bucket far above W at 16 queries); at 0.0625 it is 128
    items of 144 and skips real ones."""
    from seismic_tpu.search.grouped import GroupedParams as JParams
    from seismic_tpu.search.grouped import search_grouped as j_search
    from seismic_tpu.search.planner import PlannerContext as JCtx

    ja, ta, _, _, q_comps, q_vals = setup
    kw = _hash_params("i8", stream_frac=frac, pool_mode=pool_mode,
                      pool_per_pair=8)
    s_j, i_j = j_search(ja.to_device(pallas_tiles=True,
                                     super_summaries=True),
                        JCtx.from_arrays(ja), q_comps, q_vals,
                        JParams(**kw), query_cut=QC)
    tdev = ta.to_device(CPU, super_summaries=True)
    params = tgrouped.GroupedParams(**kw)
    s_t, i_t = tgrouped.search_grouped(tdev, PlannerContext.from_arrays(ta),
                                       q_comps, q_vals, params, query_cut=QC)
    _assert_same(s_t, i_t, np.asarray(s_j), np.asarray(i_j))
    # the kept work items, recomputed on the host plan: every returned id
    # is a posting of one of their rows
    from seismic_tpu_torch.ops.tiles_prep import ll_pad_for
    from seismic_tpu_torch.search.planner import plan_grouped

    ctx = PlannerContext.from_arrays(ta)
    dp = tgrouped.DevicePlan.put(plan_grouped(q_comps, q_vals, ctx, QC),
                                 CPU)
    qc_t, qv_t = torch.from_numpy(q_comps), torch.from_numpy(q_vals)
    top_c, top_v, _ = tengine._query_terms(qc_t, qv_t, 64)
    q8, scale = tgrouped._project(tdev, dp, top_c, top_v, 64, params)
    G_cap, M = dp.slot_b.shape
    qloc = q8[dp.slot_pair.long()].reshape(G_cap, M, -1)
    nsup = ll_pad_for(ta.max_list_len) // 128
    region = tgrouped._stream_budget(tdev, dp, qloc, scale, frac, nsup)[0]
    W_cap = dp.work_region.shape[0]
    assert len(region) == min(W_cap, max(128, round(frac * W_cap)))
    assert (len(region) < dp.W) == (frac < 0.5)
    kept = set((region.long()[:, None] * 128
                + torch.arange(128)).reshape(-1).tolist())
    docs = {int(ta.postings[ps + j])
            for rs, ps, ln in zip(ctx.list_region_start * 128,
                                  ctx.list_post_start, ctx.list_len)
            for j in range(int(ln)) if int(rs) + j in kept}
    assert set(i_t[i_t >= 0].tolist()) <= docs


@pytest.mark.parametrize("change,index_kw", [
    ({"stream_frac": 0.5}, {}),
    ({"stream_frac": 0.5, "kernel_unroll": 2}, {"super_summaries": True}),
    ({"stream_frac": 0.5, "pool_mode": "window"}, {"super_summaries": True}),
])
def test_stream_frac_refusals(setup, change, index_kw):
    """What JAX refuses about the streaming budget raises ValueError:
    no super summaries, kernel_unroll > 1, a packed pool."""
    ta, q_comps, q_vals = setup[1], setup[4], setup[5]
    params = tgrouped.GroupedParams(**_hash_params("i8", **change))
    with pytest.raises(ValueError, match="grouped search"):
        tgrouped.search_grouped(ta.to_device(CPU, **index_kw),
                                PlannerContext.from_arrays(ta), q_comps,
                                q_vals, params, query_cut=QC)
