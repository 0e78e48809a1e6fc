"""seismic_tpu_torch's bin-packed block views and the block route's recall
against the JAX package, on the CPU (numpy data from a seed):

- a bin-packed dense block view (`block_pool_arrays(pack_bins=True)`, the
  fixture of tests/test_block_pool.py) uploads with JAX's effective
  geometry (row offsets, row_off + len, start - row_off) and planner
  context, and an aligned layout under half the unpacked one;
- the block route (block_expand) on the packed view equals the port's
  unpacked view (ids exactly, scores to 1e-5, as
  tests/test_block_pool.py:292-312 demands) and JAX's packed run (id
  sets, scores to 1e-5), at csub 1 and 2;
- the refusals on packed views that JAX makes too;
- both packages' dense block routes (`SeismicIndexDotVByte`, JAX's with
  `SEISMIC_BLOCK_POOL=force`) on a cut of the chip smoke's phase 9
  layout and corpus: the same per-query id sets and the same recall@10
  against exact search."""

import dataclasses

import numpy as np
import pytest
import torch

import seismic_tpu_torch as port
from seismic_tpu_torch import from_jax_arrays
from seismic_tpu_torch.data.sparse import pad_queries
from seismic_tpu_torch.ops import tiles_prep
from seismic_tpu_torch.search import grouped as tgrouped
from seismic_tpu_torch.search.planner import PlannerContext
from tests.conftest import make_random_dataset, make_random_queries

K, QC = 10, 10
CPU = torch.device("cpu")


def _port(ja):
    return from_jax_arrays({f.name: getattr(ja, f.name)
                            for f in dataclasses.fields(ja)})


@pytest.fixture(scope="module")
def setup():
    """tests/test_block_pool.py's index (f16 values, V=256) with the port
    copy, both packages' dense block views packed and unpacked, and 16
    queries padded to 64 terms."""
    pytest.importorskip("jax")
    from seismic_tpu import Configuration, TpuLayout
    from seismic_tpu.build.builder import build_index
    from seismic_tpu.ops.pallas_tiles import block_pool_arrays as j_view

    ds = make_random_dataset(np.random.default_rng(11), n_docs=400, dim=600,
                             min_nnz=15, max_nnz=50, seed=47)
    ja = build_index(ds, Configuration(layout=TpuLayout(
        max_block_len=16, summary_vocab_cap=256)))
    ta = _port(ja)
    views = {}
    for packed in (False, True):
        views[packed] = (
            j_view(ja, 256, order_members=True, pack_bins=packed),
            tiles_prep.block_pool_arrays(ta, 256, order_members=True,
                                         pack_bins=packed))
    qc, qv = make_random_queries(np.random.default_rng(3), n_queries=16,
                                 dim=600, min_nnz=8, max_nnz=30)
    q_comps, q_vals = pad_queries(qc, qv, 64)
    return ja, ta, views, q_comps, q_vals


@pytest.mark.parametrize("csub", [1, 2])
def test_packed_upload_geometry_matches_jax(setup, csub):
    _, _, views, _, _ = setup
    (jv, tv), (_, tu) = views[True], views[False]
    assert tv.pack_bins and not tu.pack_bins
    jd = jv.to_device(pallas_tiles=True, tile_csub=csub)
    td = tv.to_device(CPU, tile_csub=csub)
    tud = tu.to_device(CPU, tile_csub=csub)
    for f in ("list_row_off", "list_len", "list_post_start",
              "list_region_start", "list_weight"):
        np.testing.assert_array_equal(getattr(td, f).numpy(),
                                      np.asarray(getattr(jd, f)), err_msg=f)
    np.testing.assert_array_equal(td.doc_tiles_aligned.numpy(),
                                  np.asarray(jd.doc_tiles_aligned).view(
                                      np.uint8))
    assert td.doc_tiles_aligned.shape[0] < tud.doc_tiles_aligned.shape[0] / 2
    assert tud.list_row_off is None
    np.testing.assert_array_equal(
        td.list_len.numpy() - td.list_row_off.numpy(), tv.list_len)
    from seismic_tpu.search.planner import PlannerContext as JCtx

    jc, tc = JCtx.from_arrays(jv, csub=csub), PlannerContext.from_arrays(
        tv, csub=csub)
    for f in dataclasses.fields(jc):
        a, b = getattr(tc, f.name), getattr(jc, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("csub,pool_mode", [(1, "hier"), (2, "exact"),
                                            (1, "slot")])
def test_packed_matches_unpacked_and_jax(setup, csub, pool_mode):
    from seismic_tpu.search.grouped import GroupedParams as JParams
    from seismic_tpu.search.grouped import search_grouped as j_search
    from seismic_tpu.search.planner import PlannerContext as JCtx

    ja, _, views, q_comps, q_vals = setup
    kw = dict(k=K, score_cut=64, pool=48, block_expand=int(ja.max_block_len),
              compute_dtype="i8", pool_mode=pool_mode, pool_per_pair=8)
    out = {}
    for packed in (False, True):
        tv = views[packed][1]
        out[packed] = tgrouped.search_grouped(
            tv.to_device(CPU, tile_csub=csub),
            PlannerContext.from_arrays(tv, csub=csub), q_comps, q_vals,
            tgrouped.GroupedParams(**kw), query_cut=QC)
    (s_u, i_u), (s_p, i_p) = out[False], out[True]
    np.testing.assert_array_equal(i_p, i_u)
    np.testing.assert_allclose(s_p, s_u, rtol=1e-5, atol=1e-5)
    jv = views[True][0]
    s_j, i_j = j_search(jv.to_device(pallas_tiles=True, tile_csub=csub),
                        JCtx.from_arrays(jv, csub=csub), q_comps, q_vals,
                        JParams(**kw), query_cut=QC)
    s_j, i_j = np.asarray(s_j), np.asarray(i_j)
    for a, b in zip(i_p, i_j):
        assert set(a[a >= 0].tolist()) == set(b[b >= 0].tolist())
    np.testing.assert_allclose(np.sort(s_p, 1), np.sort(s_j, 1), rtol=1e-5)


@pytest.mark.parametrize("change,index_kw", [
    ({"pool_mode": "window"}, {}), ({"pool_mode": "stride"}, {}),
    ({"stream_frac": 0.5}, {}), ({}, {"super_summaries": True})])
def test_packed_refusals(setup, change, index_kw):
    """The window / stride pools fold bin-mates' rows in the scorer and
    super-tile bounds would mix them: refused on packed views as JAX
    refuses them."""
    _, _, views, q_comps, q_vals = setup
    tv = views[True][1]
    with pytest.raises(ValueError, match="bin-packed|super_summaries"):
        index = tv.to_device(CPU, **index_kw)
        params = tgrouped.GroupedParams(**dict(dict(
            k=K, pool=48, block_expand=16, compute_dtype="i8",
            pool_mode="hier"), **change))
        tgrouped.search_grouped(index, PlannerContext.from_arrays(tv),
                                q_comps, q_vals, params, query_cut=QC)


def test_block_route_recall_matches_jax(monkeypatch):
    """The dense block route of both packages' `SeismicIndexDotVByte` on a
    cut of the chip smoke's phase 9 layout (blocks of up to 32, V = 512,
    u8 values, n_postings 200, block_expand = max_block_len, k = 10,
    query_cut 14, heap_factor 0.7) over the synthetic SPLADE-like corpus
    cut to 2000 documents and a 1024-term vocabulary (one aligned region
    a list: at the corpus's 30522 terms JAX's interpret mode takes
    minutes): per-query id sets equal on >= 98% of 32 queries, and
    recall@10 against exact search equal within 0.01."""
    pytest.importorskip("jax")
    import seismic_tpu as jax_pkg
    from seismic_tpu.build.builder import build_index as j_build
    from seismic_tpu.search.exact import exact_search_numpy
    from seismic_tpu_torch.harness.synth import synth_dataset, synth_queries

    ds = synth_dataset(2000, dim=1024, seed=0)
    qc, qv = synth_queries(32, dim=1024, seed=11)
    layout = dict(max_block_len=32, summary_vocab_cap=512, max_doc_nnz=256,
                  tile_overflow=64)
    ja = j_build(ds, jax_pkg.Configuration(
        pruning=jax_pkg.GlobalThresholdPruning(n_postings=200,
                                               max_fraction=2.0),
        layout=jax_pkg.TpuLayout(**layout)), value_dtype="u8",
        store_doc_tiles=False)
    monkeypatch.setenv("SEISMIC_BLOCK_POOL", "force")
    s_j, i_j = jax_pkg.SeismicIndexDotVByte(ja)._raw_batch_search(
        qc, qv, K, 14, 0.7, 0, True)
    tix = port.SeismicIndexDotVByte(_port(ja), device="cpu")
    s_t, i_t = tix._raw_batch_search(qc, qv, K, 14, 0.7, 0)
    assert tix.block_device_index()[2] == 32
    q_comps, q_vals = pad_queries(qc, qv, 128)
    _, gt = exact_search_numpy(ds, q_comps, q_vals, k=K)

    def recall(ids):
        return np.mean([len(set(r[r >= 0].tolist()) & set(g.tolist())) / K
                        for r, g in zip(np.asarray(ids), gt)])

    i_j = np.where(np.isfinite(s_j), i_j, -1)
    same = np.mean([set(a[a >= 0].tolist()) == set(b[b >= 0].tolist())
                    for a, b in zip(i_t, i_j)])
    assert same >= 0.98, same
    assert abs(recall(i_t) - recall(i_j)) <= 0.01, (recall(i_t),
                                                    recall(i_j))
