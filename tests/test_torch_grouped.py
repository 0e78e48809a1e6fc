"""seismic_tpu_torch grouped route end to end: `SeismicIndexRaw.batch_search
(..., heap_factor=0.0, device="cpu")` against the JAX package's
`search_grouped` with the API's GroupedParams (seismic_tpu/api.py:391-396),
on one index carried across with `from_jax_arrays`. The bar is the JAX
repo's own gate (bench.py:355-360): top-k id sets agree on >= 98% of
queries and scores to < 1e-3 relative. Sets, not order: ties fall
differently."""

import dataclasses

import numpy as np
import pytest
import torch

from seismic_tpu_torch import SeismicIndexRaw, from_jax_arrays
from seismic_tpu_torch.data.sparse import CsrDataset, pad_queries
from seismic_tpu_torch.search import grouped as tgrouped
from seismic_tpu_torch.search.engine import _dedup_by_id
from seismic_tpu_torch.search.planner import (
    PlannerContext,
    plan_grouped_numpy,
)
from tests.conftest import make_random_dataset, make_random_queries

K, QC = 10, 10


def _api_params(GroupedParams, k):
    # the API route's fixed parameters (seismic_tpu/api.py:391-396; the
    # engine's dedup_pool defaults to 0)
    return GroupedParams(k=k, score_cut=64, pool=max(0, 8 * k, 64),
                         compute_dtype="i8", rescore=max(48, 2 * k),
                         pool_mode="exact")


@pytest.fixture(scope="module")
def setup():
    pytest.importorskip("jax")
    from seismic_tpu import Configuration, TpuLayout
    from seismic_tpu.build.builder import build_index

    ds = make_random_dataset(np.random.default_rng(0), n_docs=400, dim=600,
                             min_nnz=15, max_nnz=50, seed=42)
    cfg = Configuration(layout=TpuLayout(max_block_len=16,
                                         summary_vocab_cap=256,
                                         tile_overflow=16))
    ja = build_index(ds, cfg, value_dtype="f16")
    ta = from_jax_arrays({f.name: getattr(ja, f.name)
                          for f in dataclasses.fields(ja)})
    qc, qv = make_random_queries(np.random.default_rng(1), n_queries=16,
                                 dim=600, min_nnz=8, max_nnz=30)
    return ds, ja, ta, qc, qv


@pytest.fixture(scope="module")
def jax_result(setup):
    from seismic_tpu.search.engine import pad_queries as j_pad
    from seismic_tpu.search.grouped import GroupedParams, search_grouped
    from seismic_tpu.search.planner import PlannerContext as JCtx

    _, ja, _, qc, qv = setup
    q_comps, q_vals = j_pad(qc, qv, 128)  # the API's query padding
    return search_grouped(
        ja.to_device(pallas_tiles=True), JCtx.from_arrays(ja), q_comps,
        q_vals, _api_params(GroupedParams, K), query_cut=QC, M=8)


def _as_arrays(results, k):
    s = np.full((len(results), k), -np.inf, np.float32)
    i = np.full((len(results), k), -1, np.int64)
    for r, row in enumerate(results):
        for j, (score, doc) in enumerate(row):
            s[r, j], i[r, j] = score, doc
    return s, i


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


def test_api_batch_search_matches_jax(setup, jax_result):
    _, _, ta, qc, qv = setup
    index = SeismicIndexRaw(ta)
    res = index.batch_search(qc, qv, k=K, query_cut=QC, heap_factor=0.0,
                             device="cpu")
    s_t, i_t = _as_arrays(res, K)
    s_j, i_j = jax_result
    _assert_gate(s_t, i_t, s_j, np.where(np.isfinite(s_j), i_j, -1))
    # single-query entry point agrees with the batch
    one = index.search(qc[3], qv[3], k=K, query_cut=QC, heap_factor=0.0,
                       device="cpu")
    assert {d for _, d in one} == {d for _, d in res[3]}


def test_api_route_plans_with_cpp_planner(setup, jax_result, monkeypatch):
    """The route plans as the reference's does (seismic_tpu/api.py:397):
    `plan_grouped` with the C++ planner, never the NumPy one; its results
    equal JAX's `search_grouped`, which plans with the C++ planner too."""
    from seismic_tpu_torch.search import planner

    calls = []
    cpp = planner.plan_grouped

    def recording(*a, **kw):
        calls.append(kw.get("native"))
        return cpp(*a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("the API route planned with NumPy")

    monkeypatch.setattr(planner, "plan_grouped", recording)
    monkeypatch.setattr(planner, "plan_grouped_numpy", refuse)
    _, _, ta, qc, qv = setup
    res = SeismicIndexRaw(ta).batch_search(qc, qv, k=K, query_cut=QC,
                                           heap_factor=0.0, device="cpu")
    assert calls == [True]
    s_t, i_t = _as_arrays(res, K)
    s_j, i_j = jax_result
    fin = np.isfinite(s_j)
    assert (np.isfinite(s_t) == fin).all()
    for a, b in zip(i_t, np.where(fin, i_j, -1)):
        assert set(a[a >= 0].tolist()) == set(b[b >= 0].tolist())
    np.testing.assert_allclose(np.sort(s_t, 1), np.sort(s_j, 1), rtol=1e-5)


def test_search_grouped_matches_jax(setup, jax_result):
    """The module-level entry (plan on host, run on the index's device)."""
    _, _, ta, qc, qv = setup
    q_comps, q_vals = pad_queries(qc, qv, 128)
    s_t, i_t = tgrouped.search_grouped(
        ta.to_device("cpu"), PlannerContext.from_arrays(ta), q_comps, q_vals,
        _api_params(tgrouped.GroupedParams, K), query_cut=QC, M=8)
    s_j, i_j = jax_result
    _assert_gate(s_t, i_t, s_j, np.where(np.isfinite(s_j), i_j, -1))


def test_build_from_csr_recall(setup):
    """The port's own build + search finds the exact top-10 (numpy brute
    force) as well as the exhaustive-list route can."""
    ds, _, _, qc, qv = setup
    tds = CsrDataset(ds.offsets, ds.components, ds.values, ds.dim)
    from seismic_tpu_torch import Configuration, TpuLayout

    index = SeismicIndexRaw.build_from_csr(
        tds, Configuration(layout=TpuLayout(max_block_len=16,
                                            summary_vocab_cap=256,
                                            tile_overflow=16)),
        device="cpu")
    res = index.batch_search(qc, qv, k=K, query_cut=QC, heap_factor=0.0)
    # the index keeps f16 forward values (SeismicIndexRaw's value dtype)
    dense = ds.to_dense().astype(np.float16).astype(np.float32)
    hits = 0
    for c, v, row in zip(qc, qv, res):
        exact = dense[:, c] @ v
        gt = set(np.argsort(-exact, kind="stable")[:K].tolist())
        hits += len(gt & {d for _, d in row})
        # returned scores are exact dots with the stored f16 values
        for score, d in row:
            assert score == pytest.approx(float(exact[d]), rel=1e-5)
    assert hits / (K * len(qc)) >= 0.9


def test_dedup_matches_jax():
    """`_dedup_by_id` and `_dedup_with_payload` against the JAX versions on
    pools with duplicates, ties and -inf entries."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from seismic_tpu.search.engine import _dedup_by_id as j_dedup
    from seismic_tpu.search.grouped import _dedup_with_payload as j_dedup_p

    rng = np.random.default_rng(9)
    scores = rng.integers(0, 6, size=(6, 40)).astype(np.float32)
    scores[rng.random(scores.shape) < 0.2] = -np.inf
    ids = rng.integers(0, 12, size=(6, 40)).astype(np.int32)
    pay = rng.integers(0, 100, size=(6, 40)).astype(np.int32)
    s_j, i_j = (np.asarray(a) for a in j_dedup(jnp.asarray(scores),
                                               jnp.asarray(ids), 12))
    s_t, i_t = _dedup_by_id(torch.from_numpy(scores), torch.from_numpy(ids),
                            12)
    np.testing.assert_array_equal(s_t.numpy(), s_j)
    np.testing.assert_array_equal(i_t.numpy(), i_j)
    s_j, i_j, _ = (np.asarray(a) for a in j_dedup_p(
        jnp.asarray(scores), jnp.asarray(ids), jnp.asarray(pay), 12))
    s_t, i_t, _ = tgrouped._dedup_with_payload(
        torch.from_numpy(scores), torch.from_numpy(ids),
        torch.from_numpy(pay), 12)
    np.testing.assert_array_equal(s_t.numpy(), s_j)
    np.testing.assert_array_equal(i_t.numpy(), i_j)


def test_device_plan_put_keeps_every_field(setup):
    _, _, ta, qc, qv = setup
    q_comps, q_vals = pad_queries(qc, qv, 128)
    plan = plan_grouped_numpy(q_comps, q_vals,
                              PlannerContext.from_arrays(ta), QC)
    dp = tgrouped.DevicePlan.put(plan, torch.device("cpu"))
    for f in tgrouped._PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(dp, f).numpy(),
                                      getattr(plan, f))
    assert dp.pair_valid.dtype == torch.bool and dp.M == plan.M


@pytest.mark.parametrize("change", [
    {"compute_dtype": "f16"}, {"qloc_mode": "lane"},
    {"pool_mode": "strided"}, {"pool_select": "sorted"},
    {"compute_dtype": "bf16", "kernel_unroll": 2},
    {"pool_mode": "window", "kernel_unroll": 2}, {"stop_after": "tail"},
    {"stream_frac": 0.5}, {"block_expand": 8, "return_margin": True},
    {"pool_mode": "slot", "kernel_unroll": 2},
    {"compute_dtype": "bf16", "qloc_mode": "rowmajor"},
    {"return_margin": True, "rescore": 0},
])
def test_other_modes_raise(change):
    """Values and combinations the JAX package refuses raise ValueError:
    among them the streaming budget on an index without super summaries,
    and return_margin with block_expand or without the rescore."""
    import types

    base = _api_params(tgrouped.GroupedParams, K)
    params = dataclasses.replace(base, **change)
    no_super = types.SimpleNamespace(super_summary=None, list_row_off=None)
    with pytest.raises(ValueError, match="grouped search"):
        tgrouped._check_supported(params, no_super)


def test_engine_path_requests_raise(setup):
    """Requests off the grouped route are served by the engine path,
    `cand_budget` and `block_mode="sketch"` included: those two equal the
    JAX API's results (the repo's gate: id sets on >= 98% of queries,
    scores to 1e-3 relative)."""
    import seismic_tpu as jax_pkg

    from seismic_tpu_torch.build.builder import summary_block_sketches

    _, ja, ta, qc, qv = setup
    # block sketches as the NumPy build path makes them (the native core
    # keeps none), on both sides
    sk = dict(zip(("block_sketch", "block_sketch_scale"),
                  summary_block_sketches(ta, 128, 42)))
    ja, ta = dataclasses.replace(ja, **sk), dataclasses.replace(ta, **sk)
    index = SeismicIndexRaw(ta)
    for kw in ({"heap_factor": 0.7}, {"heap_factor": 0.0, "block_budget": 8}):
        res = index.batch_search(qc, qv, k=K, device="cpu", **kw)
        assert len(res) == len(qc) and all(len(r) == K for r in res)
    j_index = jax_pkg.SeismicIndexRaw(ja)
    for kw in ({"cand_budget": 32}, {"block_mode": "sketch"}):
        got = index.batch_search(qc, qv, k=K, heap_factor=0.7, device="cpu",
                                 **kw)
        want = j_index.batch_search(qc, qv, k=K, heap_factor=0.7, **kw)
        same = np.mean([{d for _, d in a} == {d for _, d in b}
                        for a, b in zip(got, want)])
        assert same >= 0.98, (kw, same)
        for a, b in zip(got, want):
            np.testing.assert_allclose(sorted(s for s, _ in a),
                                       sorted(s for s, _ in b), rtol=1e-3)
