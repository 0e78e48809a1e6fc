"""seismic_tpu_torch's block-pool lean path and `SeismicIndexDotVByte`
against the JAX package, all on the CPU, on one synthetic u8 index
(numpy data from a seed; the API cases read a JSONL written to
`tmp_path`).

- the blocks-as-rows view (`ops/tiles_prep.py::block_pool_arrays`, dense
  mode, with `order_block_members`), at the built width and narrowed,
  equals JAX's array for array, exactly;
- K3's u8 form (its plain version here) equals JAX's `rescore_exact` on
  the JAX package's lean upload (interpret mode), chunked and not, to
  1e-5 relative;
- `search_grouped` with `block_expand` against JAX's: top-k id sets on
  >= 98% of queries, scores to 1e-5 relative;
- `SeismicIndexDotVByte` on the block-pool route against JAX's class with
  `SEISMIC_BLOCK_POOL=force` (the JAX package's own test hook), and on
  the engine path (a block budget) against JAX's engine, the same gate;
- the hashed block rows, the bin-packed view (and its aligned layout)
  and the hashed upload of an index without dense summaries equal to
  JAX's, and `SeismicIndexDotVByte` built without dense summaries on the
  hashed block route against JAX's class;
- the lean upload, the engine's exact scores on it, `build_knn` refused,
  and u16 codes scored as JAX's `rescore_exact` scores them."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import seismic_tpu_torch as port
from seismic_tpu_torch import (
    Configuration,
    CsrDataset,
    TpuLayout,
    from_jax_arrays,
)
from seismic_tpu_torch.build.builder import build_index
from seismic_tpu_torch.data.sparse import PAD_COMPONENT, pad_queries
from seismic_tpu_torch.ops import rescore as trescore
from seismic_tpu_torch.ops import tiles_prep
from seismic_tpu_torch.search import engine as tengine
from seismic_tpu_torch.search import grouped as tgrouped
from seismic_tpu_torch.search import knn as tknn
from seismic_tpu_torch.search.planner import PlannerContext
from tests.conftest import make_random_dataset, make_random_queries

K, QC, NKNN = 10, 6, 8
DIM = 600
LAYOUT = dict(max_block_len=16, summary_vocab_cap=256, tile_overflow=16)


def _port_arrays(ja):
    return from_jax_arrays({f.name: getattr(ja, f.name)
                            for f in dataclasses.fields(ja)})


def _graph(n_docs: int) -> np.ndarray:
    """A seeded neighbour table [n_docs, NKNN] with -1 at some rows' ends
    and no document its own neighbour."""
    rng = np.random.default_rng(9)
    g = rng.integers(0, n_docs - 1, size=(n_docs, NKNN)).astype(np.int32)
    g += (g >= np.arange(n_docs)[:, None])
    g[::5, NKNN - 2:] = -1
    return g


@pytest.fixture(scope="module")
def setup():
    """One CSR set built with u8 values and no doc tiles by the JAX
    builder (the DotVByte build), its port copy, and 16 queries."""
    pytest.importorskip("jax")
    from seismic_tpu import Configuration as JConfiguration
    from seismic_tpu import TpuLayout as JLayout
    from seismic_tpu.build.builder import build_index as j_build

    ds = make_random_dataset(np.random.default_rng(0), n_docs=400, dim=DIM,
                             min_nnz=15, max_nnz=50, seed=42)
    ja = j_build(ds, JConfiguration(layout=JLayout(**LAYOUT)),
                 value_dtype="u8", store_doc_tiles=False)
    qc, qv = make_random_queries(np.random.default_rng(1), n_queries=16,
                                 dim=DIM, min_nnz=8, max_nnz=30)
    return ds, ja, _port_arrays(ja), qc, qv


def test_port_build_equals_jax(setup):
    """The port's DotVByte build (u8 values, no doc tiles) gives the JAX
    build's arrays."""
    ds, ja, ta, _, _ = setup
    assert ja.fwd_val_min is not None and ja.doc_tiles is None
    mine = build_index(CsrDataset(ds.offsets, ds.components, ds.values,
                                  ds.dim),
                       Configuration(layout=TpuLayout(**LAYOUT)),
                       value_dtype="u8", store_doc_tiles=False)
    for f in dataclasses.fields(ta):
        a, b = getattr(ta, f.name), getattr(mine, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a, err_msg=f.name)


@pytest.mark.parametrize("width", [256, 128])
def test_block_view_matches_jax(setup, width):
    """order_block_members and the dense block view (narrowed first when
    the width is under the built one) equal JAX's array for array."""
    from seismic_tpu.ops.pallas_tiles import block_pool_arrays as j_view
    from seismic_tpu.ops.pallas_tiles import narrow_vocab as j_narrow
    from seismic_tpu.ops.pallas_tiles import order_block_members as j_order

    _, ja, ta, _, _ = setup
    if width < LAYOUT["summary_vocab_cap"]:
        ja, ta = j_narrow(ja, width), tiles_prep.narrow_vocab(ta, width)
    np.testing.assert_array_equal(
        tiles_prep.order_block_members(ta).postings,
        np.asarray(j_order(ja).postings))
    jv = j_view(ja, width, order_members=True, mode="dense")
    tv = tiles_prep.block_pool_arrays(ta, width, order_members=True,
                                      mode="dense")
    assert not np.array_equal(tv.postings, ta.postings)  # members moved
    for f in dataclasses.fields(jv):
        a, b = getattr(tv, f.name), getattr(jv, f.name)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f.name)
        elif f.name != "config":
            assert a == b, f.name
    assert tv.max_list_len == ta.max_blocks_per_list
    np.testing.assert_array_equal(tv.doc_tiles, ta.dense_summary)


def test_lean_upload(setup):
    """u8 values upload in the lean form: int16 ids (-1 at padding), the
    u8 codes, per-doc f32 min and step; no fused rows and no int32 ids."""
    _, _, ta, _, _ = setup
    dev = ta.to_device("cpu")
    assert dev.fwd_fused is None
    assert dev.fwd_comps16.dtype == torch.int16
    np.testing.assert_array_equal(
        dev.fwd_comps16.numpy(),
        np.where(ta.fwd_comps == PAD_COMPONENT, -1, ta.fwd_comps))
    assert dev.fwd_vals.dtype == torch.uint8
    np.testing.assert_array_equal(dev.fwd_vals.numpy(), ta.fwd_vals)
    np.testing.assert_array_equal(dev.fwd_val_min.numpy(), ta.fwd_val_min)
    np.testing.assert_array_equal(dev.fwd_val_step.numpy(), ta.fwd_val_step)
    W = ta.fwd_comps.shape[1]
    for f in dataclasses.fields(dev):
        t = getattr(dev, f.name)
        if torch.is_tensor(t) and t.dim() == 2 and t.shape[0] == ta.n_docs:
            assert t.dtype != torch.int32 or t.shape[1] != W, f.name
    full = dataclasses.replace(ta, fwd_vals=ta.fwd_vals.astype(np.float32),
                               fwd_val_min=None, fwd_val_step=None)
    assert full.to_device("cpu").fwd_comps16 is None


def test_engine_exact_scores_on_u8_rows(setup):
    """The engine's exact scores on the lean form are the dots of the
    decoded u8 rows (code * step + min) with the dense queries."""
    _, _, ta, qc, qv = setup
    dev = ta.to_device("cpu")
    q_comps, q_vals = pad_queries(qc, qv, 64)
    qd = tengine.densify_query_batch(torch.from_numpy(q_comps),
                                     torch.from_numpy(q_vals), ta.dim)
    ids = torch.from_numpy(np.random.default_rng(4).integers(
        0, ta.n_docs, size=(len(qc), 40)).astype(np.int32))
    got = tengine._exact_scores(dev, qd, ids).numpy()
    vals = (ta.fwd_vals.astype(np.float32) * ta.fwd_val_step[:, None]
            + ta.fwd_val_min[:, None])
    real = ta.fwd_comps != PAD_COMPONENT
    for b in range(len(qc)):
        q = dict(zip(qc[b].tolist(), qv[b].tolist()))
        for r, d in enumerate(ids[b].tolist()):
            want = sum(float(v) * q.get(int(c), 0.0) for c, v, m in zip(
                ta.fwd_comps[d], vals[d], real[d]) if m)
            assert abs(got[b, r] - want) <= 1e-5 * max(abs(want), 1e-6)


@pytest.mark.parametrize("chunk", [0, 24])
def test_rescore_u8_matches_jax(setup, chunk):
    """K3's u8 form (plain version) against JAX's `rescore_exact` on the
    JAX package's lean upload of the block view (i16 twin + u8 codes,
    the Pallas kernel in interpret mode), with out-of-range ids clamped."""
    from seismic_tpu.ops.pallas_rescore import rescore_exact as j_rescore
    from seismic_tpu.ops.pallas_tiles import block_pool_arrays as j_view

    _, ja, ta, qc, qv = setup
    jdev = j_view(ja, 256, mode="dense").to_device(pallas_tiles=True,
                                                   lean_fwd=True)
    assert jdev.fwd_comps is None and jdev.fwd_comps16 is not None
    q_comps, q_vals = pad_queries(qc, qv, 64)
    top_c, top_v, sc = tengine._query_terms(torch.from_numpy(q_comps),
                                            torch.from_numpy(q_vals), 32)
    ids = np.random.default_rng(6).integers(
        -2, ta.n_docs + 3, size=(len(qc), 56)).astype(np.int32)
    want = np.asarray(j_rescore(jdev, ids, top_c.numpy(), top_v.numpy(), sc,
                                interpret=True, chunk_r=chunk))
    tdev = ta.to_device("cpu")
    got = trescore.rescore_exact(tdev, torch.from_numpy(ids), top_c, top_v,
                                 sc, chunk_r=chunk).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert (want > 0).mean() > 0.5  # most rows meet some query term


def _assert_gate(s_t, i_t, s_j, i_j, rtol=1e-5):
    i_j = np.where(np.isfinite(s_j), i_j, -1)
    ids_match = np.mean([set(a[a >= 0].tolist()) == set(b[b >= 0].tolist())
                         for a, b in zip(i_t, i_j)])
    assert ids_match >= 0.98, ids_match
    fin = np.isfinite(s_j)
    assert (np.isfinite(s_t) == fin).all()
    np.testing.assert_allclose(np.sort(s_t, 1), np.sort(s_j, 1), rtol=rtol)


@pytest.mark.parametrize("case", ["hier", "exact_chunked_knn"])
def test_search_grouped_block_expand_matches_jax(setup, case):
    """`search_grouped` on the block view with block_expand (the API's
    hier pool; an exact pool with a chunked rescore and kNN refinement)
    against JAX's in interpret mode."""
    from seismic_tpu.ops.pallas_tiles import block_pool_arrays as j_view
    from seismic_tpu.search.grouped import GroupedParams as JParams
    from seismic_tpu.search.grouped import search_grouped as j_search
    from seismic_tpu.search.planner import PlannerContext as JCtx

    _, ja, ta, qc, qv = setup
    E = int(ja.max_block_len)
    kw = dict(k=K, score_cut=64, pool=48, block_expand=E,
              compute_dtype="i8", pool_mode="hier", pool_per_pair=12)
    if case != "hier":
        kw.update(pool_mode="exact", rescore_chunk=100, n_knn=NKNN)
        g = _graph(ja.n_docs)
        ja, ta = (dataclasses.replace(ja, knn=g),
                  dataclasses.replace(ta, knn=g))
    q_comps, q_vals = pad_queries(qc, qv, 64)
    jv = j_view(ja, 256, order_members=True, mode="dense")
    s_j, i_j = j_search(jv.to_device(pallas_tiles=True, lean_fwd=True),
                        JCtx.from_arrays(jv), q_comps, q_vals, JParams(**kw),
                        query_cut=QC, M=8)
    tv = tiles_prep.block_pool_arrays(ta, 256, order_members=True)
    s_t, i_t = tgrouped.search_grouped(
        tv.to_device("cpu"), PlannerContext.from_arrays(tv), q_comps,
        q_vals, tgrouped.GroupedParams(**kw), query_cut=QC, M=8)
    _assert_gate(s_t, i_t, s_j, i_j)


def _write_jsonl(ds, path):
    with open(path, "w") as f:
        for i in range(len(ds)):
            lo, hi = ds.offsets[i], ds.offsets[i + 1]
            f.write(json.dumps({"id": f"d{i}", "content": f"doc {i}",
                                "vector": {f"t{c}": float(v) for c, v in zip(
                                    ds.components[lo:hi],
                                    ds.values[lo:hi])}}) + "\n")


def _as_arrays(results):
    s = np.full((len(results), K), -np.inf, np.float32)
    i = np.full((len(results), K), -1, np.int64)
    for r, row in enumerate(results):
        for j, (_, score, doc) in enumerate(row):
            s[r, j], i[r, j] = score, int(doc[1:])
    return s, i


def test_dotvbyte_api_matches_jax(setup, tmp_path, monkeypatch):
    """`SeismicIndexDotVByte` from a JSONL: the block-pool route (its view
    narrowed to 128 columns, as the class narrows its 1024-wide builds
    to 512), with and without n_knn on a graph read by `load_knn`,
    against JAX's class on its block route, and a block-budget request on
    the engine path (K3's u8 form) against JAX's engine; every score the
    exact dot of the document's decoded u8 row; the lean upload."""
    import seismic_tpu as jax_pkg

    ds, _, _, qc, qv = setup
    path = str(tmp_path / "docs.jsonl")
    _write_jsonl(ds, path)

    class JNarrow(jax_pkg.SeismicIndexDotVByte):
        _block_V = 128

    class TNarrow(port.SeismicIndexDotVByte):
        _block_V = 128

    kw = dict(n_postings=100, max_fraction=1.5)
    j_index = JNarrow.build(path, layout=jax_pkg.TpuLayout(**LAYOUT), **kw)
    t_index = TNarrow.build(path, layout=TpuLayout(**LAYOUT), device="cpu",
                            **kw)
    assert t_index._token_to_id == j_index._token_to_id
    graph = str(tmp_path / "graph")
    tknn.save_knn(_graph(len(ds)), graph)
    tq = [np.array([f"t{c}" for c in q], dtype="U30") for q in qc]
    qids = np.array([f"q{i}" for i in range(len(qc))], dtype="U30")
    monkeypatch.setenv("SEISMIC_BLOCK_POOL", "force")
    calls = []
    expand = tgrouped._block_expand_tail

    def recording(*a, **kw):
        calls.append(1)
        return expand(*a, **kw)

    monkeypatch.setattr(tgrouped, "_block_expand_tail", recording)
    for n_knn in (0, NKNN):
        if n_knn:
            for index in (j_index, t_index):
                index.load_knn(graph)
        j_res = j_index.batch_search(qids, tq, qv, k=K, query_cut=QC,
                                     heap_factor=0.7, n_knn=n_knn)
        t_res = t_index.batch_search(qids, tq, qv, k=K, query_cut=QC,
                                     heap_factor=0.7, n_knn=n_knn)
        _assert_gate(*_as_arrays(t_res), *_as_arrays(j_res))
    assert calls == [1, 1]
    bindex = t_index.block_device_index()[0]
    assert bindex.vocab16.shape[1] == 128 and bindex.fwd_fused is None
    assert bindex.knn is not None
    monkeypatch.delenv("SEISMIC_BLOCK_POOL")
    j_res = j_index.batch_search(qids, tq, qv, k=K, query_cut=QC,
                                 heap_factor=0.7, block_budget=64)
    t_res = t_index.batch_search(qids, tq, qv, k=K, query_cut=QC,
                                 heap_factor=0.7, block_budget=64)
    assert calls == [1, 1]
    s_t, i_t = _as_arrays(t_res)
    _assert_gate(s_t, i_t, *_as_arrays(j_res))
    dev = t_index.device_index()
    assert dev.fwd_fused is None and dev.doc_tiles_aligned is None
    a = t_index.arrays
    vals = (a.fwd_vals.astype(np.float32) * a.fwd_val_step[:, None]
            + a.fwd_val_min[:, None])
    tmap = t_index._token_to_id
    for c, v, srow, irow in zip(qc, qv, s_t, i_t):
        q = {tmap[f"t{x}"]: y for x, y in zip(c.tolist(), v.tolist())
             if f"t{x}" in tmap}
        for s, d in zip(srow, irow):
            exact = sum(float(x) * q.get(int(t), 0.0)
                        for t, x in zip(a.fwd_comps[d], vals[d])
                        if t != PAD_COMPONENT)
            assert abs(s - exact) <= 1e-5 * abs(exact), (s, exact)


def test_dotvbyte_refuses_build_knn(setup):
    _, _, ta, _, _ = setup
    index = port.SeismicIndexDotVByte(ta, device="cpu")
    with pytest.raises(NotImplementedError, match="load_knn"):
        index.build_knn(4)
    assert port.SeismicIndexDotVByte._component_cap == 1 << 16


@pytest.mark.parametrize("case", ["hash", "pack_bins", "no_dense",
                                  "u16_codes"])
def test_unported_parts_raise(setup, case):
    """The hashed block rows, the bin-packed view and an index without
    dense summaries (which the API route serves on the hashed view) equal
    the JAX package's: the views array for array, the packed aligned
    layout with its row offsets, the hashed block upload; u16 codes
    beside a per-doc min / step are scored as JAX's rescore scores
    them."""
    from seismic_tpu.ops.pallas_tiles import block_pool_arrays as j_view
    from seismic_tpu.ops_pallas_prep import prepare_pallas_tiles as j_prep

    _, ja, ta, qc, qv = setup
    if case == "u16_codes":
        # u16 codes (the convert pass) upload in the lean form and K3's
        # plain version scores them as JAX's rescore_exact does on its
        # lean upload of the block view (interpret mode), 1e-5 relative
        from seismic_tpu.build.convert import convert_index as j_convert
        from seismic_tpu.ops.pallas_rescore import rescore_exact as j_rescore
        from seismic_tpu.ops.pallas_tiles import block_pool_arrays as j_view

        from seismic_tpu_torch.build.convert import convert_index

        j16, t16 = j_convert(ja, "u16"), convert_index(ta, "u16")
        jdev = j_view(j16, 256, mode="dense").to_device(pallas_tiles=True,
                                                        lean_fwd=True)
        tdev = tiles_prep.block_pool_arrays(t16, 256, mode="dense").to_device(
            "cpu")
        assert tdev.fwd_vals.dtype == torch.int16  # the u16 codes' bits
        assert tdev.fwd_comps16 is not None and tdev.fwd_fused is None
        q_comps, q_vals = pad_queries(qc, qv, 64)
        top_c, top_v, sc = tengine._query_terms(
            torch.from_numpy(q_comps), torch.from_numpy(q_vals), 32)
        ids = np.random.default_rng(7).integers(
            -2, ta.n_docs + 3, size=(len(qc), 40)).astype(np.int32)
        want = np.asarray(j_rescore(jdev, ids, top_c.numpy(), top_v.numpy(),
                                    sc, interpret=True))
        got = trescore.rescore_exact(tdev, torch.from_numpy(ids), top_c,
                                     top_v, sc).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        assert (want > 0).mean() > 0.5
        return
    if case == "no_dense":
        import seismic_tpu as jax_pkg

        jix = jax_pkg.SeismicIndexDotVByte(
            dataclasses.replace(ja, dense_summary=None))
        jix._block_V = 128
        tix = port.SeismicIndexDotVByte(
            dataclasses.replace(ta, dense_summary=None), device="cpu")
        tix._block_V = 128
        jd = jix._block_device_index()
        td, tctx, E = tix.block_device_index()
        assert td.tile_hash == jd.tile_hash == 128
        # the list vocabulary goes up on the hashed view as JAX's
        # list_vocab does (int16 here, -1 for PAD)
        assert (td.vocab is None) == (jd.list_vocab is None)
        if td.vocab is not None:
            jl = np.asarray(jd.list_vocab)
            np.testing.assert_array_equal(
                td.vocab.numpy(), np.where(jl == 2 ** 31 - 1, -1, jl))
        assert E == ja.max_block_len
        np.testing.assert_array_equal(
            td.doc_tiles_aligned.numpy(),
            np.asarray(jd.doc_tiles_aligned).view(np.uint8))
        np.testing.assert_array_equal(tctx.list_len, jix._block_ctx.list_len)
        return
    kw = (dict(V=128, mode="hash") if case == "hash"
          else dict(V=256, pack_bins=True))
    jv = j_view(ja, order_members=True, **kw)
    tv = tiles_prep.block_pool_arrays(ta, order_members=True, **kw)
    for f in dataclasses.fields(jv):
        a, b = getattr(tv, f.name), getattr(jv, f.name)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f.name)
        elif f.name != "config":
            assert a == b, f.name
    j_tiles, j_scale, j_region, j_off = j_prep(jv, 2)
    t_tiles, t_scale, t_region, t_off = tiles_prep.prepare_pallas_tiles(tv,
                                                                        2)
    np.testing.assert_array_equal(t_tiles, j_tiles.view(np.uint8))
    np.testing.assert_array_equal(t_scale, j_scale[:, 0, :].reshape(-1))
    np.testing.assert_array_equal(t_region, j_region)
    assert (t_off is None) == (j_off is None) == (case == "hash")
    if t_off is not None:
        np.testing.assert_array_equal(t_off, j_off)


def test_dotvbyte_hashed_api_matches_jax(setup, tmp_path, monkeypatch):
    """`SeismicIndexDotVByte` built with `summary_vocab_cap=0` (no dense
    summaries: the block route runs on the hashed view of the CSR
    summaries, one projection row per query) from a JSONL against JAX's
    class on its block route (`SEISMIC_BLOCK_POOL=force`): the same gate
    as the dense route, every score the exact dot of the decoded u8
    row. The build keeps a one-column placeholder of dense summaries,
    which JAX's API takes for dense rows and fails on (`assert V % 128
    == 0`), so JAX's class gets the same arrays without it, which it
    serves on its hashed view."""
    import seismic_tpu as jax_pkg

    ds, _, _, qc, qv = setup
    path = str(tmp_path / "docs.jsonl")
    _write_jsonl(ds, path)

    class JNarrow(jax_pkg.SeismicIndexDotVByte):
        _block_V = 128

    class TNarrow(port.SeismicIndexDotVByte):
        _block_V = 128

    layout = dict(LAYOUT, summary_vocab_cap=0)
    kw = dict(n_postings=100, max_fraction=1.5)
    j_index = JNarrow.build(path, layout=jax_pkg.TpuLayout(**layout), **kw)
    t_index = TNarrow.build(path, layout=TpuLayout(**layout), device="cpu",
                            **kw)
    assert t_index.arrays.dense_summary.shape[1] == 1  # the placeholder
    j_index = JNarrow(dataclasses.replace(j_index.arrays, dense_summary=None),
                      j_index._doc_ids, j_index._token_to_id,
                      j_index._contents)
    tq = [np.array([f"t{c}" for c in q], dtype="U30") for q in qc]
    qids = np.array([f"q{i}" for i in range(len(qc))], dtype="U30")
    monkeypatch.setenv("SEISMIC_BLOCK_POOL", "force")
    j_res = j_index.batch_search(qids, tq, qv, k=K, query_cut=QC,
                                 heap_factor=0.7)
    t_res = t_index.batch_search(qids, tq, qv, k=K, query_cut=QC,
                                 heap_factor=0.7)
    s_t, i_t = _as_arrays(t_res)
    _assert_gate(s_t, i_t, *_as_arrays(j_res))
    bindex = t_index.block_device_index()[0]
    assert bindex.tile_hash == 128 and bindex.fwd_fused is None
    a = t_index.arrays
    vals = (a.fwd_vals.astype(np.float32) * a.fwd_val_step[:, None]
            + a.fwd_val_min[:, None])
    tmap = t_index._token_to_id
    for c, v, srow, irow in zip(qc, qv, s_t, i_t):
        q = {tmap[f"t{x}"]: y for x, y in zip(c.tolist(), v.tolist())
             if f"t{x}" in tmap}
        for sc_, d in zip(srow, irow):
            if d < 0:
                continue
            exact = sum(float(x) * q.get(int(t), 0.0)
                        for t, x in zip(a.fwd_comps[d], vals[d])
                        if t != PAD_COMPONENT)
            assert abs(sc_ - exact) <= 1e-5 * abs(exact), (sc_, exact)
