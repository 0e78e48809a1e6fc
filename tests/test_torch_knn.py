"""seismic_tpu_torch k-NN graphs and kNN refinement against the JAX
package, all on the CPU, on one synthetic index (numpy, from a seed).

- `search/knn.py::build_knn` (through `SeismicIndexRaw.build_from_csr`
  with `config.knn`) against the JAX API's graph: equal arrays expected,
  equal id sets required on >= 98% of rows; the graph does not depend on
  the batch size; the graph files of either package load in the other.
- refinement on the grouped route (`_knn_refine_grouped` after the
  rescore tail, the engine's round after the overflow tail) against JAX's
  `search_grouped` in interpret mode: top-k id sets on >= 98% of queries,
  scores to 1e-5 relative;
- the API sends an `n_knn` request to the grouped route, and its result
  equals the JAX API's on its accelerator route (the same gate), every
  score the exact dot."""

import dataclasses

import numpy as np
import pytest

from seismic_tpu_torch import (
    Configuration,
    CsrDataset,
    KnnConfig,
    SeismicIndexRaw,
    TpuLayout,
    from_jax_arrays,
)
from seismic_tpu_torch.data.sparse import pad_queries
from seismic_tpu_torch.search import engine as tengine
from seismic_tpu_torch.search import grouped as tgrouped
from seismic_tpu_torch.search import knn as tknn
from seismic_tpu_torch.search.planner import PlannerContext
from tests.conftest import make_random_dataset, make_random_queries

K, QC, NKNN = 10, 4, 8
LAYOUT = dict(max_block_len=16, summary_vocab_cap=256, tile_overflow=16)


@pytest.fixture(scope="module")
def setup():
    """One CSR set built by both packages' `build_from_csr` with an
    8-neighbour graph, and 16 queries."""
    pytest.importorskip("jax")
    from seismic_tpu import Configuration as JConfiguration
    from seismic_tpu import KnnConfig as JKnn
    from seismic_tpu import SeismicIndexRaw as JRaw
    from seismic_tpu import TpuLayout as JLayout

    ds = make_random_dataset(np.random.default_rng(0), n_docs=400, dim=600,
                             min_nnz=15, max_nnz=50, seed=42)
    j_index = JRaw.build_from_csr(ds, JConfiguration(
        knn=JKnn(nknn=NKNN), layout=JLayout(**LAYOUT)))
    t_index = SeismicIndexRaw.build_from_csr(
        CsrDataset(ds.offsets, ds.components, ds.values, ds.dim),
        Configuration(knn=KnnConfig(nknn=NKNN), layout=TpuLayout(**LAYOUT)),
        device="cpu")
    qc, qv = make_random_queries(np.random.default_rng(1), n_queries=16,
                                 dim=600, min_nnz=8, max_nnz=30)
    return ds, j_index, t_index, qc, qv


def test_build_knn_matches_jax(setup):
    """The port's graph equals the JAX package's: the same self-searches
    on the same index. Found: equal arrays, every row."""
    _, j_index, t_index, _, _ = setup
    jg, tg = j_index.arrays.knn, t_index.arrays.knn
    assert tg.dtype == np.int32 and tg.shape == jg.shape == (400, NKNN)
    assert t_index.knn_len == NKNN
    same_sets = np.mean([set(a[a >= 0]) == set(b[b >= 0])
                         for a, b in zip(tg, jg)])
    assert same_sets >= 0.98, same_sets
    np.testing.assert_array_equal(tg, jg)
    rows = np.arange(400)[:, None]
    assert not (tg == rows).any()  # a document is not its own neighbour


def test_graph_does_not_depend_on_batch_size(setup):
    _, _, t_index, _, _ = setup
    arrays = t_index.arrays
    dev = t_index.device_index()
    g64 = tknn.build_knn(arrays, dev, NKNN, batch_size=64)
    g400 = tknn.build_knn(arrays, dev, NKNN, batch_size=400)
    np.testing.assert_array_equal(g64, g400)
    np.testing.assert_array_equal(g64, arrays.knn)


def test_drop_self_matches_the_loop():
    """The NumPy pass that drops each document from its own results equals
    the JAX package's per-document loop, with -1 and the document itself
    anywhere in the row."""
    rng = np.random.default_rng(5)
    ids = rng.integers(-1, 40, size=(64, 9))
    docs = np.arange(64) % 40
    ids[::3, 2] = docs[::3]
    ids[::5, 0] = docs[::5]
    ids[::7, 4:] = -1
    got = tknn.drop_self(ids, docs, 8)
    for i, doc in enumerate(docs):
        neigh = [int(d) for d in ids[i] if d >= 0 and d != doc][:8]
        want = np.full(8, -1, np.int32)
        want[:len(neigh)] = neigh
        np.testing.assert_array_equal(got[i], want)
    assert got.dtype == np.int32


def test_graph_files_cross_load(setup, tmp_path):
    """A graph saved by either package loads in the other, whole and
    truncated; asking for more neighbours than stored raises in both."""
    from seismic_tpu.search import knn as jknn

    _, j_index, _, _, _ = setup
    g = j_index.arrays.knn
    for save, load, name in ((tknn.save_knn, jknn.load_knn, "port"),
                             (jknn.save_knn, tknn.load_knn, "jax")):
        p = save(g, str(tmp_path / name))
        assert p.endswith(".knn.seismic_tpu")
        np.testing.assert_array_equal(load(str(tmp_path / name)), g)
        np.testing.assert_array_equal(load(p, 3), g[:, :3])
        with pytest.raises(ValueError, match="exceeds"):
            load(p, NKNN + 1)


def test_api_graph_methods(setup, tmp_path):
    """save_knn / load_knn on the API, `config.knn.knn_path` with
    truncation, and a graph loaded after the first upload reaching the
    device copy."""
    ds, _, t_index, _, _ = setup
    path = t_index.save_knn(str(tmp_path / "g"))
    layout = TpuLayout(**LAYOUT)
    tds = CsrDataset(ds.offsets, ds.components, ds.values, ds.dim)
    loaded = SeismicIndexRaw.build_from_csr(
        tds, Configuration(knn=KnnConfig(nknn=4, knn_path=path),
                           layout=layout), device="cpu")
    np.testing.assert_array_equal(loaded.arrays.knn,
                                  t_index.arrays.knn[:, :4])
    plain = SeismicIndexRaw(dataclasses.replace(t_index.arrays, knn=None),
                            device="cpu")
    assert plain.device_index().knn is None and plain.knn_len == 0
    with pytest.raises(ValueError, match="no k-NN graph"):
        plain.save_knn(str(tmp_path / "none"))
    plain.load_knn(path)
    np.testing.assert_array_equal(plain.device_index().knn.numpy(),
                                  t_index.arrays.knn)


def _api_params(GroupedParams, **kw):
    base = dict(k=K, score_cut=64, pool=80, compute_dtype="i8", rescore=48,
                pool_mode="exact")
    return GroupedParams(**{**base, **kw})


def _assert_gate(s_t, i_t, s_j, i_j, rtol):
    i_j = np.where(np.isfinite(s_j), i_j, -1)
    ids_match = np.mean([set(a[a >= 0].tolist()) == set(b[b >= 0].tolist())
                         for a, b in zip(i_t, i_j)])
    assert ids_match >= 0.98, ids_match
    fin = np.isfinite(s_j)
    assert (np.isfinite(s_t) == fin).all()
    np.testing.assert_allclose(np.sort(s_t, 1), np.sort(s_j, 1), rtol=rtol)


@pytest.mark.parametrize("tail,rounds,top", [
    ("rescore", 1, 0), ("rescore", 2, 3), ("overflow", 1, 0),
])
def test_grouped_refinement_matches_jax(setup, tail, rounds, top):
    """The grouped route with n_knn = 8 against JAX's `search_grouped` in
    interpret mode; refinement changes the result."""
    from seismic_tpu.search.grouped import GroupedParams as JParams
    from seismic_tpu.search.grouped import search_grouped as j_search
    from seismic_tpu.search.planner import PlannerContext as JCtx

    _, j_index, t_index, qc, qv = setup
    kw = dict(n_knn=NKNN, knn_rounds=rounds, knn_top=top)
    if tail == "overflow":
        kw.update(rescore=0)
    q_comps, q_vals = pad_queries(qc, qv, 128)
    ja = j_index.arrays
    s_j, i_j = j_search(ja.to_device(pallas_tiles=True), JCtx.from_arrays(ja),
                        q_comps, q_vals, _api_params(JParams, **kw),
                        query_cut=QC, M=8)
    ta = from_jax_arrays({f.name: getattr(ja, f.name)
                          for f in dataclasses.fields(ja)})
    dev, ctx = ta.to_device("cpu"), PlannerContext.from_arrays(ta)
    params = _api_params(tgrouped.GroupedParams, **kw)
    s_t, i_t = tgrouped.search_grouped(dev, ctx, q_comps, q_vals, params,
                                       query_cut=QC, M=8)
    _assert_gate(s_t, i_t, s_j, i_j, rtol=1e-5)
    s_0, i_0 = tgrouped.search_grouped(
        dev, ctx, q_comps, q_vals, dataclasses.replace(params, n_knn=0),
        query_cut=QC, M=8)
    assert (i_0 != i_t).any()
    # refinement only adds candidates: no query's k-th score falls
    assert (s_t[:, -1] >= s_0[:, -1]).all()


def test_api_knn_takes_the_grouped_route(setup, monkeypatch):
    """`batch_search(heap_factor=0, n_knn=8)` runs on the grouped route
    with its refinement round, never the engine path, and equals the JAX
    API on its accelerator route (the JAX API routes on the TPU backend;
    here it is set to the route it takes there, interpret mode); every
    score is the exact dot of the document's forward row."""
    _, j_index, t_index, qc, qv = setup
    ja = j_index.arrays
    j_index._device = ja.to_device(pallas_tiles=True)
    j_index._use_pallas = True
    j_res = j_index.batch_search(qc, qv, k=K, query_cut=QC, heap_factor=0.0,
                                 n_knn=NKNN)

    calls = []
    refine = tgrouped._knn_refine_grouped

    def recording(*a, **kw):
        calls.append(1)
        return refine(*a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("an n_knn request took the engine path")

    monkeypatch.setattr(tgrouped, "_knn_refine_grouped", recording)
    monkeypatch.setattr(tengine, "search_batch", refuse)
    t_res = t_index.batch_search(qc, qv, k=K, query_cut=QC, heap_factor=0.0,
                                 n_knn=NKNN)
    assert calls == [1]

    def arrays(results):
        s = np.full((len(results), K), -np.inf, np.float32)
        i = np.full((len(results), K), -1, np.int64)
        for r, row in enumerate(results):
            for j, (score, doc) in enumerate(row):
                s[r, j], i[r, j] = score, doc
        return s, i

    _assert_gate(*arrays(t_res), *arrays(j_res), rtol=1e-5)
    fc, fv = ja.fwd_comps, ja.fwd_vals.astype(np.float32)
    for c, v, row in zip(qc, qv, t_res):
        q = dict(zip(c.tolist(), v.tolist()))
        for s, d in row:
            exact = sum(float(x) * q.get(int(t), 0.0)
                        for t, x in zip(fc[d], fv[d]))
            assert abs(s - exact) <= 1e-5 * abs(exact), (s, exact)
