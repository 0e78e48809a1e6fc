"""seismic_tpu_torch's forward-row and vocabulary forms, the sketch hash,
`convert`, large vocabularies and `FlatTermIndex`, against the JAX
package on the CPU, on numpy data from a seed.

- the torch sketch hash equals the NumPy hash bit for bit, and
  `sketch_padded_queries` equals JAX's to 1e-6 (a scatter-add where JAX
  sums one-hot rows: the same f32 terms in another order);
- K3's plain version on the half-width fused rows (`to_device(fwd_f16=
  True)`), on u16 codes and on int32 ids beside u8 / u16 codes (dim
  40000) equals JAX's `rescore_exact` on the JAX package's own uploads
  (interpret mode) to 1e-5 relative;
- K1's and K8's plain versions on an int32 vocabulary (PAD_COMPONENT
  padded, ids past 32767) equal `project_qloc_pallas` /
  `project_qloc_rowmajor` in interpret mode bit for bit, and K9's on a
  residue-ordered int32 vocabulary `project_qloc_residue`; the dim-40000
  index uploaded with `vocab_residue=8` gives JAX's K9 codes and results;
- `convert` equals `seismic_tpu/build/convert.py` array for array;
- a `SeismicIndexRawLV` at dim 40000, built from CSR, equals the JAX API
  on the grouped and the engine routes, before and after `convert("u8")`
  (the repo's gate: id sets on >= 98% of queries, scores to 1e-3
  relative);
- `FlatTermIndex`: the same arrays and results as JAX's (ids equal,
  scores to 1e-6 relative), its files read across the packages.
"""

import dataclasses

import numpy as np
import pytest
import torch

import seismic_tpu_torch as port
from seismic_tpu_torch import from_jax_arrays
from seismic_tpu_torch.build.convert import convert_index
from seismic_tpu_torch.data.sparse import PAD_COMPONENT, CsrDataset, pad_queries
from seismic_tpu_torch.ops import qloc, qloc_rowmajor, rescore
from seismic_tpu_torch.ops.sketch import (
    sketch_padded_queries,
    sketch_slots_np,
    sketch_slots_torch,
)
from seismic_tpu_torch.search import engine as tengine
from seismic_tpu_torch.search.flat import FlatTermIndex
from tests.conftest import make_random_dataset, make_random_queries

K, QC = 10, 8
WIDE = 40000
LAYOUT = dict(max_block_len=16, summary_vocab_cap=128, tile_overflow=16)
# ids past the int16 twins, and its edges
EDGE_IDS = np.array([0, 1, 32766, 32767, 32768, 39998, 39999], np.int64)


def _carry(ja):
    return from_jax_arrays({f.name: getattr(ja, f.name)
                            for f in dataclasses.fields(ja)})


def _pool_rows(rng, n, pool, lo, hi):
    rows = []
    for _ in range(n):
        comps = np.sort(rng.choice(pool, int(rng.integers(lo, hi + 1)),
                                   replace=False))
        rows.append((comps, rng.gamma(2.0, 1.0, len(comps)).astype(
            np.float32) + 0.01))
    return rows


@pytest.fixture(scope="module")
def narrow():
    """The engine tests' collection (dim 600) built with f32 values by the
    JAX builder, its port copy and 16 queries."""
    pytest.importorskip("jax")
    from seismic_tpu import Configuration, TpuLayout
    from seismic_tpu.build.builder import build_index

    ds = make_random_dataset(np.random.default_rng(0), n_docs=300, dim=600,
                             min_nnz=15, max_nnz=50, seed=42)
    ja = build_index(ds, Configuration(layout=TpuLayout(**LAYOUT)),
                     value_dtype="f32")
    qc, qv = make_random_queries(np.random.default_rng(1), n_queries=16,
                                 dim=600, min_nnz=8, max_nnz=30)
    return ds, ja, _carry(ja), qc, qv


@pytest.fixture(scope="module")
def wide():
    """A dim-40000 collection whose terms come from a pool of 600 ids
    spread over the vocabulary (the edge ids included), built with f32
    values by the JAX builder; its port copy and 16 queries on the same
    pool."""
    pytest.importorskip("jax")
    from seismic_tpu import Configuration, TpuLayout
    from seismic_tpu.build.builder import build_index
    from seismic_tpu.data.sparse import CsrDataset as JCsr

    rng = np.random.default_rng(5)
    pool = np.unique(np.concatenate([
        EDGE_IDS, rng.choice(WIDE, 593, replace=False)]))
    ds = JCsr.from_rows(_pool_rows(rng, 300, pool, 15, 50), dim=WIDE)
    ja = build_index(ds, Configuration(layout=TpuLayout(**LAYOUT)),
                     value_dtype="f32")
    q = _pool_rows(rng, 16, pool, 8, 30)
    return ds, ja, _carry(ja), [c for c, _ in q], [v for _, v in q]


# ---------------------------------------------------------------- sketch
@pytest.mark.parametrize("seed", [0, 42, 2 ** 33 + 5])
def test_sketch_hash_equals_numpy(seed):
    ids = np.random.default_rng(seed % 97).integers(
        -2 ** 31, 2 ** 31 - 1, 50000).astype(np.int32)
    ids[:5] = [PAD_COMPONENT, -1, 0, 2 ** 31 - 2, 32768]
    for sd in (128, 100):
        s_n, g_n = sketch_slots_np(ids, sd, seed)
        s_t, g_t = sketch_slots_torch(torch.from_numpy(ids), sd, seed)
        np.testing.assert_array_equal(s_t.numpy(), s_n)
        np.testing.assert_array_equal(g_t.numpy(), g_n)


def test_sketch_padded_queries_match_jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from seismic_tpu.ops.sketch import sketch_padded_queries as j_sketch

    qc, qv = make_random_queries(np.random.default_rng(3), n_queries=24,
                                 dim=WIDE)
    q_comps, q_vals = pad_queries(qc, qv, 64)
    want = np.asarray(j_sketch(jnp.asarray(q_comps), jnp.asarray(q_vals),
                               128, 42))
    got = sketch_padded_queries(torch.from_numpy(q_comps),
                                torch.from_numpy(q_vals), 128, 42).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (want != 0).any()


# ------------------------------------------------------------- K3 forms
def _form_pair(narrow, wide, form):
    """(JAX device index, port device index, n_docs, queries) of `form`."""
    from seismic_tpu.build.convert import convert_index as j_convert

    _, ja, ta, qc, qv = wide if form.startswith("wide") else narrow
    codes = {"u16": "u16", "wide_u8": "u8", "wide_u16": "u16"}.get(form)
    if codes:
        ja, ta = j_convert(ja, codes), convert_index(ta, codes)
    f16 = form == "fused16"
    jdev = ja.to_device(pallas_tiles=True, fwd_f16=f16, lean_fwd=True)
    tdev = ta.to_device("cpu", fwd_f16=f16)
    return jdev, tdev, ta.n_docs, qc, qv


@pytest.mark.parametrize("form", ["fused16", "u16", "wide_u8", "wide_u16",
                                  "wide_fused"])
def test_rescore_forms_match_jax(narrow, wide, form):
    """K3's plain version on each form of the rows against JAX's
    `rescore_exact` on the JAX package's upload of that form (Pallas in
    interpret mode), ids out of range clamped; and with
    `skip_out_of_range` -inf exactly there."""
    from seismic_tpu.ops.pallas_rescore import rescore_exact as j_rescore

    jdev, tdev, n, qc, qv = _form_pair(narrow, wide, form)
    present = {f for f in ("fwd_fused", "fwd_fused16", "fwd_comps16",
                           "fwd_comps") if getattr(tdev, f) is not None}
    assert present == {"fused16": {"fwd_fused16"}, "u16": {"fwd_comps16"},
                       "wide_u8": {"fwd_comps"}, "wide_u16": {"fwd_comps"},
                       "wide_fused": {"fwd_fused"}}[form]
    if form == "fused16":  # the JAX package's half-width words
        np.testing.assert_array_equal(tdev.fwd_fused16.numpy(),
                                      np.asarray(jdev.fwd_fused16))
    if form in ("u16", "wide_u16"):
        assert tdev.fwd_vals.dtype == torch.int16  # the u16 codes' bits
        np.testing.assert_array_equal(
            tdev.fwd_vals.numpy().view(np.uint16), np.asarray(jdev.fwd_vals))
    q_comps, q_vals = pad_queries(qc, qv, 64)
    top_c, top_v, sc = tengine._query_terms(torch.from_numpy(q_comps),
                                            torch.from_numpy(q_vals), 32)
    ids = np.random.default_rng(6).integers(
        -2, n + 3, size=(len(qc), 48)).astype(np.int32)
    want = np.asarray(j_rescore(jdev, ids, top_c.numpy(), top_v.numpy(), sc,
                                interpret=True))
    got = rescore.rescore_exact(tdev, torch.from_numpy(ids), top_c, top_v,
                                sc).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert (want > 0).mean() > 0.3
    skipped = rescore.rescore_exact(tdev, torch.from_numpy(ids), top_c,
                                    top_v, sc, skip_out_of_range=True)
    inside = (ids >= 0) & (ids < n)
    assert np.isneginf(skipped.numpy()[~inside]).all()
    np.testing.assert_array_equal(skipped.numpy()[inside], got[inside])


# -------------------------------------------------------- K1 / K8 int32
def test_k1_k8_int32_vocab_match_pallas():
    """K1 (f32 and quantized) and K8 on int32 vocab rows (PAD_COMPONENT
    padded, ids 32767 .. 2^31 - 2 among them, a term repeated in a query
    row) against the Pallas kernels in interpret mode, bit for bit."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from seismic_tpu.ops.pallas_qloc import (
        project_qloc_pallas,
        project_qloc_rowmajor,
    )

    rng = np.random.default_rng(11)
    B, QCP, V, SC, n_lists = 16, 8, 128, 24, 40
    pool = np.unique(np.concatenate([
        EDGE_IDS, [2 ** 31 - 2, 250001],
        rng.choice(300000, 400, replace=False)]))
    vocab = np.full((n_lists, V), PAD_COMPONENT, np.int32)
    for li in range(n_lists):
        m = rng.integers(V // 4, V + 1)
        vocab[li, :m] = np.sort(rng.choice(pool, m, replace=False))
    vocab[0, :len(pool[:V])] = pool[:V]  # one list holds the edge ids
    qc = np.full((B, SC), PAD_COMPONENT, np.int32)
    qv = np.zeros((B, SC), np.float32)
    for b in range(B):
        m = rng.integers(SC // 2, SC + 1)
        qc[b, :m] = rng.choice(pool, m, replace=False)
        qv[b, :m] = -np.sort(-rng.random(m).astype(np.float32) * 3)
    qc[0, 1] = qc[0, 0]  # a repeated id sums its values in term order
    pair_list = rng.integers(0, n_lists, B * QCP).astype(np.int32)
    pair_list[:QCP] = 0
    P = B * QCP
    P_cap = -(-P // 128) * 128
    qcT = np.pad(np.repeat(qc, QCP, axis=0).T, ((0, 0), (0, P_cap - P)),
                 constant_values=PAD_COMPONENT)
    qvT = np.pad(np.repeat(qv, QCP, axis=0).T, ((0, 0), (0, P_cap - P)))
    vocabT = np.pad(vocab[pair_list].T, ((0, 0), (0, P_cap - P)))
    j_f32 = np.asarray(project_qloc_pallas(
        jnp.asarray(vocabT), jnp.asarray(qcT), jnp.asarray(qvT), SC,
        interpret=True)).T[:P]
    args = [torch.from_numpy(a) for a in (vocab, pair_list, qc, qv)]
    before = (qloc.launches, qloc.launches_i32)
    t_f32 = qloc.project_qloc_f32(*args, QCP).numpy()
    np.testing.assert_array_equal(t_f32, j_f32)
    assert (t_f32 != 0).mean() > 0.01
    rows = vocab[pair_list]
    qcP, qvP = np.repeat(qc, QCP, axis=0), np.repeat(qv, QCP, axis=0)
    j_i8, j_sc = project_qloc_rowmajor(
        jnp.asarray(rows), jnp.asarray(qcP), jnp.asarray(qvP), SC,
        interpret=True)
    t_i8, t_sc = qloc_rowmajor.project_qloc_rowmajor(
        torch.from_numpy(rows), torch.from_numpy(qcP), torch.from_numpy(qvP))
    np.testing.assert_array_equal(t_i8.numpy(), np.asarray(j_i8))
    np.testing.assert_array_equal(t_sc.numpy(), np.asarray(j_sc)[:, 0])
    k1_i8, k1_sc = qloc.project_qloc_quantize(*args, QCP)
    assert torch.equal(k1_i8, t_i8) and torch.equal(k1_sc, t_sc)
    # CPU tensors: the plain versions, no launch counted
    assert (qloc.launches, qloc.launches_i32) == before


# --------------------------------------------------------------- convert
@pytest.mark.parametrize("dtype", ["f32", "f16", "bf16", "u8", "u16",
                                   "fixedu8", "fixedu16"])
def test_convert_matches_jax(narrow, dtype):
    from seismic_tpu.build.convert import convert_index as j_convert

    _, ja, ta, _, _ = narrow
    for src in (None, "u8"):  # from the f32 build, and from u8 codes
        j0 = ja if src is None else j_convert(ja, src)
        t0 = ta if src is None else convert_index(ta, src)
        jc, tc = j_convert(j0, dtype), convert_index(t0, dtype)
        for f in ("fwd_vals", "fwd_val_min", "fwd_val_step"):
            a, b = getattr(tc, f), getattr(jc, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert a.dtype == b.dtype, f
                np.testing.assert_array_equal(
                    np.asarray(a, np.float32), np.asarray(b, np.float32),
                    err_msg=f)
        assert tc.postings is ta.postings  # the rest is shared
    with pytest.raises(ValueError, match="value_dtype"):
        convert_index(ta, "u4")


def test_api_convert_reuploads(narrow):
    """`convert` returns the index and drops its device copy: the next
    search uploads the lean form (u8 codes, int16 ids), and its results
    equal the JAX API's after the same conversion (the repo's gate)."""
    import seismic_tpu as jax_pkg

    _, ja, ta, qc, qv = narrow
    t_index = port.SeismicIndexRaw(ta, device="cpu")
    before = t_index.device_index()
    assert before.fwd_fused is not None
    assert t_index.convert("fixedu8") is t_index
    after = t_index.device_index()
    assert after is not before and after.fwd_fused is None
    assert after.fwd_vals.dtype == torch.uint8
    j_index = jax_pkg.SeismicIndexRaw(ja).convert("fixedu8")
    got = t_index.batch_search(qc, qv, k=K, query_cut=QC, heap_factor=0.7)
    want = j_index.batch_search(qc, qv, k=K, query_cut=QC, heap_factor=0.7)
    _assert_results_gate(got, want)


def _assert_results_gate(got, want):
    same = np.mean([{d for _, d in a} == {d for _, d in b}
                    for a, b in zip(got, want)])
    assert same >= 0.98, same
    for a, b in zip(got, want):
        np.testing.assert_allclose(sorted(s for s, _ in a),
                                   sorted(s for s, _ in b), rtol=1e-3)
    assert sum(len(r) for r in got) > 0


# ------------------------------------------------- large vocabulary, API
@pytest.fixture(scope="module")
def wide_api(wide):
    """The dim-40000 collection through both packages' LV classes."""
    import seismic_tpu as jax_pkg

    ds, _, _, qc, qv = wide
    j_index = jax_pkg.SeismicIndexRawLV.build_from_csr(
        ds, jax_pkg.Configuration(layout=jax_pkg.TpuLayout(**LAYOUT)))
    t_index = port.SeismicIndexRawLV.build_from_csr(
        CsrDataset(ds.offsets, ds.components, ds.values, ds.dim),
        port.Configuration(layout=port.TpuLayout(**LAYOUT)), device="cpu")
    return j_index, t_index, qc, qv


@pytest.mark.parametrize("case", ["grouped", "engine", "grouped_u8",
                                  "engine_u8"])
def test_lv_wide_index_matches_jax(wide_api, case):
    """`SeismicIndexRawLV` at dim 40000: the build equals JAX's, the
    upload holds the int32 vocabulary and ids, and `batch_search` on the
    grouped route (heap_factor 0: K1 on the int32 vocabulary, K3) equals
    JAX's grouped program and on the engine path (0.7) the JAX API's,
    also after `convert("u8")` (K3 on int32 ids beside u8 codes)."""
    j_index, t_index, qc, qv = wide_api
    ja, ta = j_index.arrays, t_index.arrays
    for f in ("fwd_comps", "postings", "list_vocab", "doc_tiles",
              "summary_comps"):
        np.testing.assert_array_equal(getattr(ta, f), getattr(ja, f),
                                      err_msg=f)
    if case.endswith("u8"):
        import seismic_tpu as jax_pkg

        j_index = jax_pkg.SeismicIndexRawLV(ja).convert("u8")
        t_index = port.SeismicIndexRawLV(ta, device="cpu").convert("u8")
    dev = t_index.device_index()
    assert dev.vocab16 is None and dev.list_vocab.dtype == torch.int32
    assert (dev.fwd_comps is not None) == case.endswith("u8")
    if case.startswith("engine"):
        got = t_index.batch_search(qc, qv, k=K, query_cut=QC,
                                   heap_factor=0.7)
        want = j_index.batch_search(qc, qv, k=K, query_cut=QC,
                                    heap_factor=0.7)
        _assert_results_gate(got, want)
        return
    if case == "grouped_u8":
        # JAX's grouped program takes ~2 min in interpret mode at this
        # dim, so it runs once (the f32 case). Here: every score is JAX's
        # `rescore_exact` of its id on JAX's lean upload, and the ids are
        # the route's on the f32 decode of the same codes (the doc tiles,
        # so the pool, are unchanged by the conversion)
        from seismic_tpu.ops.pallas_rescore import rescore_exact as j_rescore

        got = t_index.batch_search(qc, qv, k=K, query_cut=QC,
                                   heap_factor=0.0)
        dec = port.SeismicIndexRawLV(convert_index(t_index.arrays, "f32"),
                                     device="cpu")
        want = dec.batch_search(qc, qv, k=K, query_cut=QC, heap_factor=0.0)
        assert [[d for _, d in r] for r in got] == [
            [d for _, d in r] for r in want]
        q_comps, q_vals = pad_queries(qc, qv, 128)
        top_c, top_v, sc = tengine._query_terms(
            torch.from_numpy(q_comps), torch.from_numpy(q_vals), 64)
        ids = np.full((len(qc), K), -1, np.int32)
        for r, row in enumerate(got):
            ids[r, :len(row)] = [d for _, d in row]
        ex = np.asarray(j_rescore(j_index.arrays.to_device(pallas_tiles=True),
                                  ids, top_c.numpy(), top_v.numpy(), sc,
                                  interpret=True))
        for r, row in enumerate(got):
            np.testing.assert_allclose([x for x, _ in row],
                                       ex[r, :len(row)], rtol=1e-5)
        return
    # the grouped route: the JAX API takes it on its accelerator only, so
    # the reference is JAX's `search_grouped` on its own upload (int32
    # `list_vocab`, Pallas in interpret mode) with the route's parameters
    from seismic_tpu.search.grouped import GroupedParams, search_grouped
    from seismic_tpu.search.planner import PlannerContext as JCtx

    from seismic_tpu_torch.api import route_params

    got = t_index.batch_search(qc, qv, k=K, query_cut=QC, heap_factor=0.0)
    q_comps, q_vals = pad_queries(qc, qv, 128)  # the API's query padding
    jarr = j_index.arrays
    jdev = jarr.to_device(pallas_tiles=True)
    assert jdev.vocab16 is None and jdev.list_vocab is not None
    rp = route_params(K)
    s_j, i_j = search_grouped(
        jdev, JCtx.from_arrays(jarr), q_comps, q_vals,
        GroupedParams(**{f.name: getattr(rp, f.name)
                         for f in dataclasses.fields(rp)}),
        query_cut=QC, M=8)
    s_j, i_j = np.asarray(s_j), np.asarray(i_j)
    want = [[(float(a), int(b)) for a, b in zip(sr, ir)
             if b >= 0 and np.isfinite(a)] for sr, ir in zip(s_j, i_j)]
    _assert_results_gate(got, want)


# ------------------------------------------------- K9 on int32 vocabularies
def _residue_order(vocab, R):
    """Each list's real ids (>= 0, not PAD) into R residue groups of VRS
    slots and the spill, -1 padded: the layout `residue_permute_arrays`
    gives an int32 vocabulary (importance order kept by row order)."""
    from seismic_tpu_torch.ops.tiles_prep import residue_layout

    V = vocab.shape[1]
    VRS, spill = residue_layout(V, R)
    out = np.full_like(vocab, -1)
    for li, row in enumerate(vocab):
        real = row[(row >= 0) & (row != PAD_COMPONENT)]
        rest = []
        for r in range(R):
            mine = real[real % R == r]
            out[li, r * VRS:r * VRS + len(mine[:VRS])] = mine[:VRS]
            rest += mine[VRS:].tolist()
        out[li, R * VRS:R * VRS + len(rest[:spill])] = rest[:spill]
    return out


@pytest.mark.parametrize("scb", [4, 16])
def test_k9_int32_vocab_matches_pallas(scb):
    """K9's plain version (f32 and quantized) on residue-ordered int32
    rows holding EDGE_IDS, 2^31 - 2 and ids past 2^20, against
    `project_qloc_residue` in interpret mode on the same rows, bit for
    bit; a query repeats an id; scb 4 overflows buckets."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from seismic_tpu.ops.pallas_qloc import project_qloc_residue as j_k9
    from seismic_tpu.search.grouped import _residue_buckets as j_buckets

    from seismic_tpu_torch.ops import qloc_residue
    from seismic_tpu_torch.search.grouped import _residue_buckets

    R, V, B, QCP, SC, n_lists = 8, 128, 16, 8, 40, 30
    rng = np.random.default_rng(scb)
    pool = np.unique(np.concatenate([
        EDGE_IDS, [2 ** 31 - 2, 2 ** 31 - 9, (1 << 20) + 3],
        rng.choice(np.arange(1 << 20, 1 << 30), 300, replace=False),
        rng.choice(1 << 20, 200, replace=False)]))
    vocab = np.full((n_lists, V), PAD_COMPONENT, np.int32)
    for li in range(n_lists):
        m = rng.integers(V // 4, V + 1)
        vocab[li, :m] = rng.choice(pool, m, replace=False)
    vocab[0, :12] = pool[-12:]  # the top ids in list 0
    vocab[1, :len(EDGE_IDS)] = EDGE_IDS
    vocab = _residue_order(vocab, R)
    qc = np.full((B, SC), PAD_COMPONENT, np.int32)
    qv = np.zeros((B, SC), np.float32)
    for b in range(B):
        m = rng.integers(SC // 2, SC + 1)
        qc[b, :m] = rng.choice(pool, m, replace=False)
        qv[b, :m] = -np.sort(-rng.random(m).astype(np.float32) * 3)
    qc[0, :3] = [2 ** 31 - 2, (1 << 20) + 3, 32768]
    qc[1, 1] = qc[1, 0]  # a repeated id sums its values in term order
    pair_list = rng.integers(0, n_lists, B * QCP).astype(np.int32)
    pair_list[:QCP] = np.arange(QCP) % 2
    j_qcb, j_qvb = j_buckets(jnp.asarray(qc), jnp.asarray(qv), R, scb)
    t_qcb, t_qvb = _residue_buckets(torch.from_numpy(qc),
                                    torch.from_numpy(qv), R, scb)
    np.testing.assert_array_equal(t_qcb.numpy(), np.asarray(j_qcb))
    np.testing.assert_array_equal(t_qvb.numpy(), np.asarray(j_qvb))
    P = B * QCP
    P_cap = -(-P // 128) * 128

    def lane(a, fill):
        return np.pad(np.repeat(a, QCP, axis=0).T, ((0, 0), (0, P_cap - P)),
                      constant_values=fill)

    j_out = np.asarray(j_k9(
        jnp.asarray(np.pad(vocab[pair_list].T, ((0, 0), (0, P_cap - P)),
                           constant_values=-1)),
        jnp.asarray(lane(np.asarray(j_qcb), -2)),
        jnp.asarray(lane(np.asarray(j_qvb), 0.0)), jnp.asarray(lane(qc, -2)),
        jnp.asarray(lane(qv, 0.0)), R, scb, SC, interpret=True)).T[:P]
    args = [torch.from_numpy(a) for a in (vocab, pair_list)] + [
        t_qcb, t_qvb, torch.from_numpy(qc), torch.from_numpy(qv)]
    before = (qloc_residue.launches, qloc_residue.launches_i32)
    t_out = qloc_residue.project_qloc_residue(*args, QCP, R, scb)
    np.testing.assert_array_equal(t_out.numpy(), j_out)
    assert (j_out[:QCP] != 0).any() and (j_out != 0).mean() > 0.01
    q_i8, q_sc = qloc_residue.project_qloc_residue(*args, QCP, R, scb,
                                                   quantize=True)
    e_i8, e_sc = qloc.quantize_plain(torch.from_numpy(j_out.copy()))
    assert torch.equal(q_i8, e_i8) and torch.equal(q_sc, e_sc)
    # CPU tensors: the plain version, no launch counted
    assert (qloc_residue.launches, qloc_residue.launches_i32) == before


@pytest.fixture(scope="module")
def wide_residue(wide):
    """The dim-40000 index uploaded with vocab_residue=8 by both packages,
    with its planner contexts."""
    from seismic_tpu.search.planner import PlannerContext as JCtx

    from seismic_tpu_torch.search.planner import PlannerContext

    _, ja, ta, qc, qv = wide
    return (ja.to_device(pallas_tiles=True, vocab_residue=8),
            JCtx.from_arrays(ja), ta.to_device("cpu", vocab_residue=8),
            PlannerContext.from_arrays(ta), qc, qv)


@pytest.mark.parametrize("stage", ["qloc", "full"])
def test_wide_residue_grouped_matches_jax(wide, wide_residue, stage):
    """`to_device(vocab_residue=8)` past dim 32766: the permuted int32
    vocabulary equals JAX's, and JAX's grouped program on its own residue
    upload gives the port's K9 projections bit for bit ("qloc", f32). A
    whole i8 batch on the residue upload ("full") meets the repo's gate
    against the port's batch on the plain upload, which
    `test_lv_wide_index_matches_jax[grouped]` holds against JAX's (JAX's
    grouped scorer in interpret mode takes ~110 s at this dim, whatever
    the batch, so it runs once, there)."""
    from seismic_tpu.ops.pallas_tiles import residue_permute_arrays as jperm
    from seismic_tpu.search.grouped import GroupedParams, search_grouped

    from seismic_tpu_torch.ops import qloc_residue
    from seismic_tpu_torch.ops.tiles_prep import residue_permute_arrays
    from seismic_tpu_torch.search import grouped as tgrouped
    from seismic_tpu_torch.search.planner import PlannerContext

    _, ja, ta, _, _ = wide
    jdev, jctx, tdev, tctx, qc, qv = wide_residue
    assert tdev.vocab16 is None and tdev.list_vocab.dtype == torch.int32
    assert tdev.vocab_residue == 8 == jdev.vocab_residue
    assert (tdev.list_vocab.numpy() == np.asarray(jdev.list_vocab)).all()
    q_comps, q_vals = pad_queries(qc, qv, 64)
    kw = dict(k=K, score_cut=64, pool=64, rescore=32, pool_mode="exact")
    if stage == "qloc":
        np.testing.assert_array_equal(
            residue_permute_arrays(ta, 8).list_vocab,
            np.asarray(jperm(ja, 8).list_vocab))
        kw.update(compute_dtype="f32", stop_after="qloc")
        s_j, _ = search_grouped(jdev, jctx, q_comps, q_vals,
                                GroupedParams(**kw), query_cut=QC)
        s_t, _ = tgrouped.search_grouped(tdev, tctx, q_comps, q_vals,
                                         tgrouped.GroupedParams(**kw),
                                         query_cut=QC)
        # JAX's f32 projection is lane-major [V, P_cap], the port's [P, V]
        np.testing.assert_array_equal(s_t, np.asarray(s_j).T[:s_t.shape[0]])
        assert (s_t != 0).any()
        return
    gp = tgrouped.GroupedParams(compute_dtype="i8", **kw)
    before = (qloc_residue.launches, qloc_residue.launches_i32)
    out = [tgrouped.search_grouped(d, c, q_comps, q_vals, gp, query_cut=QC)
           for d, c in ((tdev, tctx), (ta.to_device("cpu"),
                                       PlannerContext.from_arrays(ta)))]
    assert (qloc_residue.launches, qloc_residue.launches_i32) == before
    got, want = ([[(float(a), int(b)) for a, b in zip(sr, ir) if b >= 0]
                  for sr, ir in zip(*o)] for o in out)
    _assert_results_gate(got, want)


# ------------------------------------------------------- FlatTermIndex
def test_flat_index_matches_jax(narrow):
    from seismic_tpu.search.flat import FlatTermIndex as JFlat

    ds, _, _, qc, qv = narrow
    jf = JFlat.build(ds)
    tf = FlatTermIndex.build(CsrDataset(ds.offsets, ds.components,
                                        ds.values, ds.dim))
    np.testing.assert_array_equal(tf.columns, jf.columns)
    np.testing.assert_array_equal(tf.doc_scale, jf.doc_scale)
    q_comps, q_vals = pad_queries(qc, qv, 64)
    q_comps[0, 0] = ds.dim + 3  # a query-only token reads the zero row
    s_j, i_j = jf.search_batch(q_comps, q_vals, K)
    s_t, i_t = tf.search_batch(q_comps, q_vals, K, device="cpu")
    assert s_t.dtype == np.float32 and i_t.dtype == np.int64
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_allclose(s_t, s_j, rtol=1e-6)
    # in chunks of documents: the same results
    from seismic_tpu_torch.search import flat as tflat

    cols, dscale = tf.device_arrays("cpu")
    old = tflat._CHUNK_ELEMS
    try:
        tflat._CHUNK_ELEMS = 16 * 37  # 37 documents a chunk
        s_c, i_c = tflat.flat_search(cols, dscale, torch.from_numpy(q_comps),
                                     torch.from_numpy(q_vals), K, ds.dim)
    finally:
        tflat._CHUNK_ELEMS = old
    np.testing.assert_array_equal(i_c.numpy(), i_j)
    np.testing.assert_array_equal(s_c.numpy(), s_t)


def test_flat_files_across_packages(narrow, tmp_path):
    from seismic_tpu.search.flat import FlatTermIndex as JFlat

    ds = narrow[0]
    tf = FlatTermIndex.build(CsrDataset(ds.offsets, ds.components,
                                        ds.values, ds.dim))
    p = tf.save(str(tmp_path / "port"))
    assert p.endswith(".flat.seismic_tpu")
    back = JFlat.load(str(tmp_path / "port"))
    np.testing.assert_array_equal(back.columns, tf.columns)
    assert (back.dim, back.n_docs) == (tf.dim, tf.n_docs)
    JFlat.build(ds).save(str(tmp_path / "jax"))
    mine = FlatTermIndex.load(str(tmp_path / "jax"))
    np.testing.assert_array_equal(mine.doc_scale, tf.doc_scale)
    np.testing.assert_array_equal(mine.columns, tf.columns)


# ------------------------------------------------------------- synth
@pytest.mark.parametrize("dim", [3000, 250002])
def test_synth_dataset_equals_jax(dim):
    """The port's `synth_dataset` (the Zipf background drawn through one
    cached CDF) gives the JAX package's collection array for array, at a
    small and at a large vocabulary."""
    pytest.importorskip("jax")
    from seismic_tpu.harness.synth import synth_dataset as j_synth

    from seismic_tpu_torch.harness.synth import synth_dataset

    kw = dict(dim=dim, seed=7, n_topics=64)
    a, b = synth_dataset(300, **kw), j_synth(300, **kw)
    for f in ("offsets", "components", "values"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
