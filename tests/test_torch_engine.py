"""seismic_tpu_torch engine path (`search/engine.py`) against the JAX
package's `search_batch` on one index carried across with
`from_jax_arrays`, the same padded queries (numpy, from a seed) through
both, all on the CPU.

Tolerances:
- tiles mode against the JAX program on `to_device(pallas_tiles=True)`
  with `use_pallas=True` (its Pallas scorer in interpret mode): ids equal
  position by position, scores to 1e-5 relative (the tile dot products
  are summed in another order; everything after them is selection);
- gather / rescore modes and the API: the JAX repo's own gate
  (bench.py:355-360), top-k id sets equal on >= 98% of queries and scores
  to 1e-3 relative;
- helper functions (`densify_query_batch`, the `_lookup` projection): exact, a
  slot receives at most one term."""

import dataclasses

import numpy as np
import pytest
import torch

from seismic_tpu_torch import SeismicIndexRaw, from_jax_arrays
from seismic_tpu_torch.data.sparse import CsrDataset, pad_queries
from seismic_tpu_torch.search import engine as tengine
from seismic_tpu_torch.search.engine import SearchParams, search_batch
from tests.conftest import make_random_dataset, make_random_queries

K, QC, NKNN = 10, 8, 8


def _carry(ja):
    return from_jax_arrays({f.name: getattr(ja, f.name)
                            for f in dataclasses.fields(ja)})


@pytest.fixture(scope="module")
def setup():
    """The fixture of tests/test_tiles.py, built with and without the
    per-posting overflow entries; the overflow build carries a k-NN graph
    made by the JAX package's `build_knn`."""
    pytest.importorskip("jax")
    from seismic_tpu import Configuration, TpuLayout
    from seismic_tpu.build.builder import build_index
    from seismic_tpu.search.knn import build_knn

    ds = make_random_dataset(np.random.default_rng(0), n_docs=400, dim=600,
                             min_nnz=15, max_nnz=50, seed=42)
    built = {}
    for ovf in (0, 16):
        cfg = Configuration(layout=TpuLayout(
            max_block_len=16, summary_vocab_cap=256, tile_overflow=ovf))
        ja = build_index(ds, cfg)
        if ovf:
            ja.knn = build_knn(ja, ja.to_device(), NKNN, batch_size=128)
        built[ovf] = (ja, ja.to_device(pallas_tiles=True), _carry(ja))
    qc, qv = make_random_queries(np.random.default_rng(1), n_queries=16,
                                 dim=600, min_nnz=8, max_nnz=30)
    q_comps, q_vals = pad_queries(qc, qv, 64)
    return ds, built, qc, qv, q_comps, q_vals


@pytest.fixture(scope="module")
def device_index(setup):
    return {ovf: b[2].to_device("cpu") for ovf, b in setup[1].items()}


def _jax_search(jdev, q_comps, q_vals, heap_factor, **kw):
    from seismic_tpu import SearchParams as JParams
    from seismic_tpu.search.engine import search_batch as j_search

    return j_search(jdev, q_comps, q_vals, JParams(use_pallas=True, **kw),
                    heap_factor=heap_factor)


def _assert_gate(s_t, i_t, s_j, i_j):
    ids_match = np.mean([
        set(map(int, a[a >= 0])) == set(map(int, b[b >= 0]))
        for a, b in zip(i_t, i_j)
    ])
    assert ids_match >= 0.98, ids_match
    fin = np.isfinite(s_j)
    assert (np.isfinite(s_t) == fin).all()
    srel = np.max(np.abs(s_t[fin] - s_j[fin])
                  / np.maximum(np.abs(s_j[fin]), 1e-6))
    assert srel < 1e-3, srel


def test_device_index_carries_engine_fields(setup, device_index):
    """`from_jax_arrays` carries the graph and the overflow entries, and
    `to_device` uploads every array the engine reads; what a build left
    out stays None."""
    _, built, *_ = setup
    ja, _, ta = built[16]
    np.testing.assert_array_equal(ta.knn, ja.knn)
    np.testing.assert_array_equal(ta.tile_ovf_comps, ja.tile_ovf_comps)
    np.testing.assert_array_equal(ta.tile_ovf_vals, ja.tile_ovf_vals)
    dev = device_index[16]
    for f in ("block_start", "block_len", "list_block_start",
              "list_n_blocks", "dense_summary", "dense_scale",
              "summary_comps", "summary_codes", "summary_min",
              "summary_quant", "posting_block_local", "tile_ovf_comps",
              "tile_ovf_vals", "knn"):
        np.testing.assert_array_equal(getattr(dev, f).numpy(),
                                      np.asarray(getattr(ja, f)), err_msg=f)
    assert dev.knn.dtype == torch.int32 and dev.knn.shape == (400, NKNN)
    assert (dev.max_blocks_per_list, dev.max_block_len) == (
        ja.max_blocks_per_list, ja.max_block_len)
    plain = device_index[0]
    assert plain.knn is None and plain.tile_ovf_comps is None
    assert plain.tile_ovf_vals is None


def test_query_helpers_match_jax(setup):
    """densify_query_batch and the `_lookup` projection against the JAX
    densify_query_batch and _qloc_compare, with out-of-vocabulary and
    padded components."""
    import jax.numpy as jnp
    from seismic_tpu.search import engine as jengine

    _, built, _, _, q_comps, q_vals = setup
    ja = built[0][0]
    dim = ja.dim
    q_comps = q_comps.copy()
    q_comps[0, 0] = dim + 5  # a query-only token
    qd_j = np.asarray(jengine.densify_query_batch(
        jnp.asarray(q_comps), jnp.asarray(q_vals), dim))
    qd_t = tengine.densify_query_batch(
        torch.from_numpy(q_comps), torch.from_numpy(q_vals), dim)
    np.testing.assert_array_equal(qd_t.numpy(), qd_j)
    assert (qd_t[:, dim] == 0).all()
    lists = np.random.default_rng(2).integers(
        0, ja.n_lists, size=(len(q_comps), QC))
    vocab = np.asarray(ja.list_vocab)[lists].astype(np.int32)
    for sc in (4, 64):
        j = np.asarray(jengine._qloc_compare(
            jnp.asarray(vocab), jnp.asarray(q_comps), jnp.asarray(q_vals),
            sc))
        t = tengine._lookup(
            tengine._dense_top_terms(
                torch.from_numpy(q_comps), torch.from_numpy(q_vals), sc,
                dim), torch.from_numpy(vocab))
        np.testing.assert_array_equal(t.numpy(), j)
    assert (j != 0).any()


@pytest.mark.parametrize("ovf", [0, 16])
@pytest.mark.parametrize("block_budget", [8, 64, 0])
@pytest.mark.parametrize("heap_factor", [0.0, 0.7, 0.9])
@pytest.mark.parametrize("full_lists", [True, False])
def test_tiles_mode_matches_jax(setup, device_index, full_lists,
                                heap_factor, block_budget, ovf):
    _, built, _, _, q_comps, q_vals = setup
    kw = dict(k=K, query_cut=QC, doc_mode="tiles", full_lists=full_lists,
              block_budget=block_budget)
    s_j, i_j = _jax_search(built[ovf][1], q_comps, q_vals, heap_factor, **kw)
    s_t, i_t = search_batch(device_index[ovf], q_comps, q_vals,
                            SearchParams(**kw), heap_factor=heap_factor)
    assert i_t.dtype == np.int64 and s_t.shape == (len(q_comps), K)
    np.testing.assert_array_equal(i_t, i_j)
    fin = np.isfinite(s_j)
    assert fin.any() and (np.isfinite(s_t) == fin).all()
    np.testing.assert_allclose(s_t[fin], s_j[fin], rtol=1e-5, atol=0)


def test_block_pruning_changes_the_result(setup, device_index):
    """The block-pruned mode is not the full scan in disguise: a tight
    budget at a high heap_factor drops candidates the full scan keeps."""
    _, _, _, _, q_comps, q_vals = setup
    kw = dict(k=K, query_cut=QC, doc_mode="tiles")
    _, full = search_batch(device_index[0], q_comps, q_vals,
                           SearchParams(full_lists=True, **kw))
    _, hard = search_batch(device_index[0], q_comps, q_vals,
                           SearchParams(full_lists=False, block_budget=8,
                                        **kw), heap_factor=1.0)
    assert (full != hard).any()
    _, loose = search_batch(device_index[0], q_comps, q_vals,
                            SearchParams(full_lists=False, block_budget=0,
                                         **kw), heap_factor=0.0)
    np.testing.assert_array_equal(loose, full)


@pytest.mark.parametrize("block_mode", ["dense", "summary"])
@pytest.mark.parametrize("doc_mode", ["gather", "rescore"])
def test_gather_and_rescore_modes_match_jax(setup, device_index, doc_mode,
                                            block_mode):
    from seismic_tpu_torch.ops import rescore

    _, built, _, _, q_comps, q_vals = setup
    kw = dict(k=K, query_cut=QC, doc_mode=doc_mode, block_mode=block_mode,
              block_budget=24)
    s_j, i_j = _jax_search(built[16][1], q_comps, q_vals, 0.7, **kw)
    before = rescore.launches
    s_t, i_t = search_batch(device_index[16], q_comps, q_vals,
                            SearchParams(**kw), heap_factor=0.7)
    assert rescore.launches == before  # CPU tensors: the plain version
    _assert_gate(s_t, i_t, s_j, i_j)


@pytest.mark.parametrize("doc_mode", ["tiles", "gather", "rescore"])
def test_knn_refinement_matches_jax(setup, device_index, doc_mode):
    """n_knn = 8 over a graph built by the JAX package's `build_knn` and
    carried by `from_jax_arrays`; refinement changes the result."""
    _, built, _, _, q_comps, q_vals = setup
    kw = dict(k=K, query_cut=4, doc_mode=doc_mode, full_lists=False,
              block_budget=8)
    s_j, i_j = _jax_search(built[16][1], q_comps, q_vals, 0.9, n_knn=NKNN,
                           **kw)
    s_t, i_t = search_batch(device_index[16], q_comps, q_vals,
                            SearchParams(n_knn=NKNN, **kw), heap_factor=0.9)
    _assert_gate(s_t, i_t, s_j, i_j)
    _, i_0 = search_batch(device_index[16], q_comps, q_vals,
                          SearchParams(**kw), heap_factor=0.9)
    assert (i_0 != i_t).any()


def _as_arrays(results, k):
    s = np.full((len(results), k), -np.inf, np.float32)
    i = np.full((len(results), k), -1, np.int64)
    for r, row in enumerate(results):
        for j, (score, doc) in enumerate(row):
            s[r, j], i[r, j] = score, doc
    return s, i


@pytest.fixture(scope="module")
def api_pair(setup):
    """The two packages' SeismicIndexRaw, each built by its own
    `build_from_csr` from one synthetic CSR set."""
    from seismic_tpu import Configuration as JConfiguration
    from seismic_tpu import SeismicIndexRaw as JRaw
    from seismic_tpu import TpuLayout as JLayout
    from seismic_tpu_torch import Configuration, TpuLayout

    ds = setup[0]
    layout = dict(max_block_len=16, summary_vocab_cap=256, tile_overflow=16)
    j_index = JRaw.build_from_csr(ds, JConfiguration(layout=JLayout(**layout)))
    t_index = SeismicIndexRaw.build_from_csr(
        CsrDataset(ds.offsets, ds.components, ds.values, ds.dim),
        Configuration(layout=TpuLayout(**layout)), device="cpu")
    return j_index, t_index


@pytest.mark.parametrize("request_kw", [
    {},  # the default arguments: heap_factor 0.7, tiles mode, block-pruned
    {"heap_factor": 0.9, "block_budget": 16},
    {"heap_factor": 0.0, "block_budget": 32},
    {"heap_factor": 0.8, "block_mode": "summary"},
    {"heap_factor": 0.5, "block_budget": 0},
], ids=["defaults", "budget", "hf0_budget", "summary", "no_budget"])
def test_api_matches_jax(setup, api_pair, request_kw):
    _, _, qc, qv, _, _ = setup
    j_index, t_index = api_pair
    j_res = j_index.batch_search(qc, qv, k=K, query_cut=QC, **request_kw)
    t_res = t_index.batch_search(qc, qv, k=K, query_cut=QC, **request_kw)
    assert len(t_res) == len(qc) and all(len(r) == K for r in t_res)
    _assert_gate(*_as_arrays(t_res, K), *_as_arrays(j_res, K))
    # the single-query entry point agrees with the batch
    one = t_index.search(qc[3], qv[3], K, QC,
                         request_kw.get("heap_factor", 0.7),
                         block_budget=request_kw.get("block_budget"),
                         block_mode=request_kw.get("block_mode"))
    assert {d for _, d in one} == {d for _, d in t_res[3]}


@pytest.mark.parametrize("doc_mode", ["gather", "rescore"])
def test_api_raw_search_routes_doc_modes(setup, api_pair, doc_mode):
    """`_raw_batch_search` takes the JAX signature: doc_mode and
    full_lists reach the engine path."""
    _, _, qc, qv, _, _ = setup
    j_index, t_index = api_pair
    args = (qc, qv, K, QC, 0.7, 0, True)
    kw = dict(block_budget=24, doc_mode=doc_mode)
    s_j, i_j = j_index._raw_batch_search(*args, **kw)
    s_t, i_t = t_index._raw_batch_search(*args, **kw)
    _assert_gate(s_t, i_t, s_j, i_j)


def test_api_knn_needs_a_graph(setup, api_pair):
    _, built, qc, qv, _, _ = setup
    _, t_index = api_pair
    with pytest.raises(ValueError, match="k-NN graph"):
        t_index.batch_search(qc, qv, k=K, n_knn=4)
    # with a graph (carried from the JAX build) the request is served
    ja, jdev, ta = built[16]
    with_graph = SeismicIndexRaw(ta, device="cpu")
    res = with_graph.batch_search(qc, qv, k=K, query_cut=QC, n_knn=NKNN)
    q_comps, q_vals = pad_queries(qc, qv, 128)
    s_j, i_j = _jax_search(
        jdev, q_comps, q_vals, 0.7, k=K, query_cut=QC, doc_mode="tiles",
        full_lists=False, block_budget=max(4 * K, 64), n_knn=NKNN)
    _assert_gate(*_as_arrays(res, K), s_j, i_j)


@pytest.mark.parametrize("case", ["sketch", "cand_budget", "u8_forward"])
def test_unported_parts_raise(setup, device_index, case):
    """What earlier slices refused is served and equals the JAX program:
    `block_mode="sketch"` (int8 block sketches . the query sketch; the
    sketches of the NumPy build path, `summary_block_sketches`) and
    `cand_budget=32` (the doc-sketch pre-rank) on the gather doc mode,
    and u8 forward values past dim 32766 (the lean upload with int32 ids
    beside the codes, the index's dim raised to 40000) on the gather and
    rescore doc modes; the repo's gate (id sets on >= 98% of queries,
    scores to 1e-3 relative)."""
    _, built, _, _, q_comps, q_vals = setup
    ja, jdev, ta = built[0]
    kw = dict(k=K, query_cut=QC, block_budget=24)
    if case == "sketch":
        # the native build keeps no block sketches: both sides take those
        # of the NumPy build path, made from the index's CSR summaries
        from seismic_tpu_torch.build.builder import summary_block_sketches

        sk = dict(zip(("block_sketch", "block_sketch_scale"),
                      summary_block_sketches(ta, 128, 42)))
        cases = [(dataclasses.replace(ta, **sk).to_device("cpu"),
                  dataclasses.replace(ja, **sk).to_device(pallas_tiles=True),
                  dict(block_mode="sketch", **kw))]
    elif case == "cand_budget":
        cases = [(device_index[0], jdev, dict(cand_budget=32, **kw))]
    else:
        from seismic_tpu.build.convert import convert_index as j_convert

        from seismic_tpu_torch.build.convert import convert_index

        ja8 = dataclasses.replace(j_convert(ja, "u8"), dim=40000)
        t8 = dataclasses.replace(convert_index(ta, "u8"),
                                 dim=40000).to_device("cpu")
        assert t8.fwd_comps.dtype == torch.int32 and t8.fwd_comps16 is None
        assert t8.list_vocab.dtype == torch.int32 and t8.vocab16 is None
        j8 = ja8.to_device(pallas_tiles=True)
        cases = [(t8, j8, dict(doc_mode=m, **kw))
                 for m in ("gather", "rescore")]
    for tdev, jd, params in cases:
        s_t, i_t = search_batch(tdev, q_comps, q_vals, SearchParams(**params),
                                heap_factor=0.7)
        s_j, i_j = _jax_search(jd, q_comps, q_vals, 0.7, **params)
        s_j, i_j = np.asarray(s_j), np.asarray(i_j)
        _assert_gate(s_t, i_t, s_j, i_j)
        assert np.isfinite(s_t).any()
        if case != "u8_forward":
            # the same ranking, exact scores summed in another order
            fin = np.isfinite(s_j)
            np.testing.assert_allclose(s_t[fin], s_j[fin], rtol=1e-5)


def test_tiles_mode_needs_csub_1(setup):
    _, built, _, _, q_comps, q_vals = setup
    index = built[0][2].to_device("cpu", tile_csub=2)
    with pytest.raises(ValueError, match="tile_csub=1"):
        search_batch(index, q_comps, q_vals, SearchParams(doc_mode="tiles"))
