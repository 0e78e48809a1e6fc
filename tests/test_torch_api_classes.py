"""seismic_tpu_torch's API classes, exact search and data I/O against the
JAX package, all on the CPU, at small sizes (numpy data from a seed,
collections written to `tmp_path`).

- `search/exact.py`: ids equal to the JAX `exact_search` and scores to
  1e-6 relative, on both branches (full sort and streaming merge); ties
  go to the smaller doc id; `exact_search_numpy` equals JAX's.
- `data/io.py`: the readers give JAX's arrays, token maps, ids and
  contents; `.bin` files are byte-equal.
- `SeismicIndex` from JSONL: the same `IndexArrays` as the JAX build,
  results formatted as JAX's (the JAX repo's gate: top-k id sets on >= 98%
  of queries, scores to 1e-3 relative; here every set is equal), stored
  text, save / load across the packages, the caps of the LV classes.
- `SeismicIndexRaw` from `.bin` files, queries from a `.bin` path.
- `SeismicDataset` results equal JAX's."""

import dataclasses
import gzip
import json
import tarfile

import numpy as np
import pytest

import seismic_tpu_torch as port
from seismic_tpu_torch.data import io as tio
from seismic_tpu_torch.data.sparse import CsrDataset, pad_queries
from seismic_tpu_torch.search import exact as texact
from tests.conftest import make_random_dataset, make_random_queries

K = 10
LAYOUT = dict(max_block_len=16, summary_vocab_cap=256, tile_overflow=16)


def _port_csr(ds):
    return CsrDataset(ds.offsets, ds.components, ds.values, ds.dim)


@pytest.fixture(scope="module")
def corpus():
    ds = make_random_dataset(np.random.default_rng(0), n_docs=300, dim=500,
                             min_nnz=10, max_nnz=40, seed=11)
    qc, qv = make_random_queries(np.random.default_rng(2), n_queries=24,
                                 dim=500)
    return ds, qc, qv


@pytest.mark.parametrize("stream", [False, True])
def test_exact_search_matches_jax(corpus, stream):
    pytest.importorskip("jax")
    from seismic_tpu.search.exact import exact_search as j_exact

    ds, qc, qv = corpus
    q_comps, q_vals = pad_queries(qc, qv, 64)
    s_j, i_j = j_exact(ds, q_comps, q_vals, K, chunk=64, stream=stream)
    s_t, i_t = texact.exact_search(_port_csr(ds), q_comps, q_vals, K,
                                   chunk=64, stream=stream, device="cpu")
    assert s_t.dtype == np.float32 and i_t.dtype == np.int64
    np.testing.assert_array_equal(i_t, np.asarray(i_j))
    np.testing.assert_allclose(s_t, np.asarray(s_j), rtol=1e-6)


def test_exact_search_ties_and_oracle():
    """Identical documents tie: both branches and the NumPy oracle return
    the smaller id first; k past the collection pads with -1 / -inf as the
    JAX function does; the oracle equals JAX's."""
    pytest.importorskip("jax")
    from seismic_tpu.search.exact import exact_search as j_exact
    from seismic_tpu.search.exact import exact_search_numpy as j_numpy

    rows = [(np.array([1, 4]), np.array([1.0, 2.0], np.float32)),
            (np.array([0, 3]), np.array([0.5, 0.5], np.float32))] * 5
    rows.append((np.array([4]), np.array([2.0], np.float32)))
    ds = CsrDataset.from_rows(rows, dim=6)
    q_comps = np.array([[1, 4, 2 ** 31 - 1], [0, 3, 5]], np.int32)
    q_vals = np.array([[1.0, 1.0, 0.0], [2.0, 2.0, 1.0]], np.float32)
    s_o, i_o = texact.exact_search_numpy(ds, q_comps, q_vals, 4)
    np.testing.assert_array_equal(i_o, [[0, 2, 4, 6], [1, 3, 5, 7]])
    for k in (4, 14):
        want = j_exact(ds, q_comps, q_vals, k, chunk=3)
        for stream in (False, True):
            s, i = texact.exact_search(ds, q_comps, q_vals, k, chunk=3,
                                       stream=stream, device="cpu")
            np.testing.assert_array_equal(i[:, :4], i_o)
            np.testing.assert_array_equal(i, np.asarray(want[1]))
            np.testing.assert_array_equal(s, np.asarray(want[0]))
    for a, b in zip((s_o, i_o), j_numpy(ds, q_comps, q_vals, 4)):
        np.testing.assert_array_equal(a, b)


def _write_jsonl(ds, path, with_content=True):
    """The collection as JSONL: ids d<i>, tokens t<c>, some contents."""
    with open(path, "w") as f:
        for i, (c, v) in enumerate(ds.iter_rows()):
            rec = {"id": f"d{i}", "vector": {
                f"t{int(a)}": float(b) for a, b in zip(c, v)}}
            if with_content and i % 3:
                rec["content"] = f"text of d{i}"
            f.write(json.dumps(rec) + "\n")


def test_io_matches_jax(corpus, tmp_path):
    """JSONL (plain, .gz, tar.gz), queries, `.bin` and token maps through
    both packages' readers and writers."""
    pytest.importorskip("jax")
    from seismic_tpu.data import io as jio

    ds = corpus[0]
    src = str(tmp_path / "docs.jsonl")
    _write_jsonl(ds, src)
    with open(src, "rb") as f, gzip.open(str(tmp_path / "docs.jsonl.gz"),
                                         "wb") as g:
        g.write(f.read())
    with tarfile.open(str(tmp_path / "docs.tar.gz"), "w:gz") as tar:
        tar.add(src, arcname="docs.jsonl")
    tmap = {f"t{c}": c for c in range(ds.dim)}
    for name in ("docs.jsonl", "docs.jsonl.gz", "docs.tar.gz"):
        path = str(tmp_path / name)
        for kw in ({}, {"token_to_id": tmap}, {"load_content": False}):
            t = tio.read_jsonl_dataset(path, **kw)
            j = jio.read_jsonl_dataset(path, **kw)
            for f in ("offsets", "components", "values"):
                np.testing.assert_array_equal(getattr(t[0], f),
                                              getattr(j[0], f))
            assert t[0].dim == j[0].dim
            np.testing.assert_array_equal(t[1], j[1])
            assert t[1].dtype == j[1].dtype
            assert list(t[2].items()) == list(j[2].items())
            assert t[3] == j[3]
    # with the identity map the CSR is the collection itself
    csr = tio.read_jsonl_dataset(src, token_to_id=tmap)[0]
    for f in ("offsets", "components", "values"):
        np.testing.assert_array_equal(getattr(csr, f), getattr(ds, f))
    for read in (tio.read_jsonl_dataset, jio.read_jsonl_dataset):
        with pytest.raises(ValueError, match="LV"):
            read(src, max_vocab=10)
    assert tio.read_jsonl_queries(src) == jio.read_jsonl_queries(src)
    with pytest.raises(ValueError, match="unsupported"):
        tio.iter_documents(str(tmp_path / "docs.txt"))
    # the .bin format: byte-equal files, equal arrays either way
    tio.write_seismic_format(_port_csr(ds), str(tmp_path / "t.bin"))
    jio.write_seismic_format(ds, str(tmp_path / "j.bin"))
    with open(tmp_path / "t.bin", "rb") as a, open(tmp_path / "j.bin",
                                                   "rb") as b:
        assert a.read() == b.read()
    for read in (tio.read_seismic_format, jio.read_seismic_format):
        back = read(str(tmp_path / "t.bin"))
        for f in ("offsets", "components", "values"):
            np.testing.assert_array_equal(getattr(back, f), getattr(ds, f))
    tio.save_token_map(tmap, str(tmp_path / "t.json"))
    assert jio.load_token_map(str(tmp_path / "t.json")) == tmap
    jio.save_token_map(tmap, str(tmp_path / "j.json"))
    assert tio.load_token_map(str(tmp_path / "j.json")) == tmap


def _assert_same_arrays(ja, ta):
    """Every field the two packages' IndexArrays share is equal."""
    names = ({f.name for f in dataclasses.fields(ja)}
             & {f.name for f in dataclasses.fields(ta)})
    for name in sorted(names):
        a, b = getattr(ja, name), getattr(ta, name)
        if name == "config":
            assert a.to_dict() == b.to_dict()
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(np.asarray(b), a, err_msg=name)
        else:
            assert a == b, name


def _token_queries(qc, qv):
    """The integer queries as token strings, one unknown token each."""
    comps = [np.array([f"t{c}" for c in row] + ["unseen"], dtype="U30")
             for row in qc]
    vals = [np.append(v, np.float32(5.0)) for v in qv]
    return comps, vals


@pytest.fixture(scope="module")
def index_pair(corpus, tmp_path_factory):
    """`SeismicIndex.build` of one JSONL file by both packages."""
    pytest.importorskip("jax")
    import seismic_tpu as jax_pkg

    path = str(tmp_path_factory.mktemp("jsonl") / "docs.jsonl")
    _write_jsonl(corpus[0], path)
    kw = dict(n_postings=100, max_fraction=2.0)
    j_index = jax_pkg.SeismicIndex.build(
        path, layout=jax_pkg.TpuLayout(**LAYOUT), **kw)
    t_index = port.SeismicIndex.build(
        path, layout=port.TpuLayout(**LAYOUT), device="cpu", **kw)
    return j_index, t_index


def test_seismic_index_matches_jax(corpus, index_pair):
    _, qc, qv = corpus
    j_index, t_index = index_pair
    _assert_same_arrays(j_index.arrays, t_index.arrays)
    assert t_index._token_to_id == j_index._token_to_id
    np.testing.assert_array_equal(t_index._doc_ids, j_index._doc_ids)
    assert (t_index.len, t_index.dim, t_index.nnz, t_index.knn_len) == (
        j_index.len, j_index.dim, j_index.nnz, j_index.knn_len)
    tc, tv = _token_queries(qc, qv)
    qids = np.array([f"q{i}" for i in range(len(qc))], dtype="U30")
    j_res = j_index.batch_search(qids, tc, tv, k=K, query_cut=8,
                                 heap_factor=0.7)
    t_res = t_index.batch_search(qids, tc, tv, k=K, query_cut=8,
                                 heap_factor=0.7)
    assert len(t_res) == len(qc)
    for t_row, j_row in zip(t_res, j_res):
        assert [r[0] for r in t_row] == [r[0] for r in j_row]
        assert {r[2] for r in t_row} == {r[2] for r in j_row}
        np.testing.assert_allclose(sorted(r[1] for r in t_row),
                                   sorted(r[1] for r in j_row), rtol=1e-3)
        assert all(isinstance(r[2], str) and r[2][0] == "d" for r in t_row)
    one = t_index.search("q3", tc[3], tv[3], K, 8, 0.7)
    assert one == t_res[3]
    # the doc's own tokens find it first (the grouped route)
    comps, vals = t_index.get(7)
    inv = {v: k for k, v in t_index._token_to_id.items()}
    best = t_index.search("self", [inv[int(c)] for c in comps], vals, 3, 30,
                          0.0)
    assert best[0][2] == "d7"
    assert t_index.get_doc_text(1) == "text of d1"
    assert t_index.get_doc_text(0) is None
    assert t_index.get_doc_ids_in_postings(0) == \
        j_index.get_doc_ids_in_postings(0)


def test_seismic_index_save_load_across_packages(index_pair, corpus,
                                                 tmp_path):
    """An index saved by either package loads in the other with its doc
    ids, token map and contents; the side files hold the same JSON."""
    import seismic_tpu as jax_pkg

    j_index, t_index = index_pair
    tp = t_index.save(str(tmp_path / "port"))
    jp = j_index.save(str(tmp_path / "jax"))
    with open(tp + ".meta.json") as a, open(jp + ".meta.json") as b:
        assert json.load(a) == json.load(b)
    for loaded, want in ((jax_pkg.SeismicIndex.load(tp), t_index),
                         (port.SeismicIndex.load(jp, device="cpu"),
                          j_index)):
        _assert_same_arrays(want.arrays, loaded.arrays)
        np.testing.assert_array_equal(loaded._doc_ids, want._doc_ids)
        assert loaded._token_to_id == want._token_to_id
        assert loaded._contents == want._contents
    back = port.SeismicIndex.load(tp, device="cpu")
    _, qc, qv = corpus
    tc, tv = _token_queries(qc[:4], qv[:4])
    ids = np.array(["a", "b", "c", "d"])
    assert back.batch_search(ids, tc, tv, K, 8, 0.7) == \
        t_index.batch_search(ids, tc, tv, K, 8, 0.7)


def test_lv_caps_and_seismic_string(tmp_path):
    assert port.get_seismic_string() == "U30"
    assert port.SeismicDataset._component_cap == 1 << 16
    assert port.SeismicIndex._component_cap == 1 << 16
    assert port.SeismicIndexRaw._component_cap == 1 << 16
    for cls in (port.SeismicDatasetLV, port.SeismicIndexLV,
                port.SeismicIndexRawLV):
        assert cls._component_cap == (1 << 31) - 1
    assert port.SeismicIndexDotVByte._component_cap == 1 << 16

    class Tiny(port.SeismicIndex):
        _component_cap = 50

    path = str(tmp_path / "big.jsonl")
    with open(path, "w") as f:
        for d in range(8):
            vec = {f"tok{d}_{i}": 1.0 for i in range(10)}
            f.write(json.dumps({"id": d, "vector": vec}) + "\n")
    with pytest.raises(ValueError, match="LV"):
        Tiny.build(path, n_postings=10, device="cpu")

    class TinyData(port.SeismicDataset):
        _component_cap = 3

    d = TinyData(device="cpu")
    d.add_document("a", ["x", "y", "z"], [1.0, 2.0, 3.0])
    with pytest.raises(ValueError, match="LV"):
        d.add_document("b", ["w"], [1.0])


def test_raw_index_from_bin_files(corpus, tmp_path):
    """`SeismicIndexRaw.build` from a `.bin` collection equals the JAX
    build; `batch_search` from a queries `.bin` path equals the same
    queries passed as lists, and the doc itself is its own best match."""
    pytest.importorskip("jax")
    import seismic_tpu as jax_pkg

    ds = corpus[0]
    doc_path = str(tmp_path / "documents.bin")
    tio.write_seismic_format(_port_csr(ds), doc_path)
    kw = dict(n_postings=100, max_fraction=2.0)
    t_index = port.SeismicIndexRaw.build(
        doc_path, layout=port.TpuLayout(**LAYOUT), device="cpu", **kw)
    j_index = jax_pkg.SeismicIndexRaw.build(
        doc_path, layout=jax_pkg.TpuLayout(**LAYOUT), **kw)
    _assert_same_arrays(j_index.arrays, t_index.arrays)
    q_path = str(tmp_path / "queries.bin")
    tio.write_seismic_format(_port_csr(ds).subset(np.arange(6)), q_path)
    from_path = t_index.batch_search(q_path, k=3, query_cut=30,
                                     heap_factor=0.0)
    lists = [_port_csr(ds).get(i) for i in range(6)]
    from_lists = t_index.batch_search([c for c, _ in lists],
                                      [v for _, v in lists], k=3,
                                      query_cut=30, heap_factor=0.0)
    assert from_path == from_lists
    assert [row[0][1] for row in from_path] == list(range(6))

    class Tiny(port.SeismicIndexRaw):
        _component_cap = 100

    with pytest.raises(ValueError, match="LV"):
        Tiny.build(doc_path, device="cpu")


def test_seismic_dataset_matches_jax(corpus):
    """`SeismicDataset`: the same token ids, exact results and stored text
    as JAX's; `SeismicIndex.build_from_dataset` builds JAX's arrays."""
    pytest.importorskip("jax")
    import seismic_tpu as jax_pkg

    ds, qc, qv = corpus
    t_data, j_data = port.SeismicDataset(device="cpu"), jax_pkg.SeismicDataset()
    for i, (c, v) in enumerate(ds.iter_rows()):
        toks = [f"t{int(x)}" for x in c[::-1]]  # first-seen order matters
        content = f"text {i}" if i % 2 else None
        for d in (t_data, j_data):
            d.add_document(f"d{i}", toks, v[::-1].tolist(), content)
    assert t_data._token_to_id == j_data._token_to_id
    assert (t_data.len, t_data.dim, t_data.nnz) == (
        j_data.len, j_data.dim, j_data.nnz)
    assert t_data.get_doc_text(3) == "text 3"
    tc, tv = _token_queries(qc, qv)
    qids = np.arange(len(qc)).astype(str)
    t_res = t_data.batch_search(qids, tc, tv, K)
    j_res = j_data.batch_search(qids, tc, tv, K)
    for t_row, j_row in zip(t_res, j_res):
        assert [(q, d) for q, _, d in t_row] == [(q, d) for q, _, d in j_row]
        np.testing.assert_allclose([s for _, s, _ in t_row],
                                   [s for _, s, _ in j_row], rtol=1e-6)
    one = t_data.search("x", tc[5], tv[5], K)
    assert [d for _, _, d in one] == [d for _, _, d in t_res[5]]
    np.testing.assert_allclose([s for _, s, _ in one],
                               [s for _, s, _ in t_res[5]], rtol=1e-6)
    kw = dict(n_postings=100, max_fraction=2.0)
    t_idx = port.SeismicIndex.build_from_dataset(
        t_data, layout=port.TpuLayout(**LAYOUT), device="cpu", **kw)
    j_idx = jax_pkg.SeismicIndex.build_from_dataset(
        j_data, layout=jax_pkg.TpuLayout(**LAYOUT), **kw)
    _assert_same_arrays(j_idx.arrays, t_idx.arrays)
    assert t_idx.get_doc_text(3) == "text 3"


def test_exact_search_on_the_card_by_default(corpus):
    """`device=None` means the card: without CUDA exact search raises
    instead of running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    ds, qc, qv = corpus
    q_comps, q_vals = pad_queries(qc, qv, 64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        texact.exact_search(_port_csr(ds), q_comps, q_vals, K)
