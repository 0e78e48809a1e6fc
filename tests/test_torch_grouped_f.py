"""seismic_tpu_torch K6 (the bf16 / f32 grouped scorer), the overflow tail
and `stop_after`, against the JAX package on the same inputs made with
numpy from a seed:

- K6's plain version against `score_grouped_pallas(compute_dtype="bf16" /
  "f32")` run in interpret mode, centred (`qsum` given) and fixup (`qsum`
  None), M 8 and 16, csub 1 and 2. The order of the f32 sum differs, so
  the bar is 1e-5 of the larger of the score and the centring term it
  cancels against (`|qsum| * scale`; 1e-5 relative in the fixup form);
- `search_grouped` of the port against JAX's for the on-device gate's
  configuration (`f32`, `exact`, `ovf_pool=0`), a default-constructed
  `GroupedParams` (`bf16`, `approx`, `ovf_pool=64`), the third overflow
  branch (`use_ovf=False`) and `qloc_mode="einsum"`, under the repo's gate
  (bench.py:355-360): top-k id sets equal on >= 98% of queries, scores
  < 1e-3 relative;
- one configuration stage by stage through `stop_after`."""

import dataclasses

import numpy as np
import pytest
import torch

from seismic_tpu_torch import from_jax_arrays
from seismic_tpu_torch.data.sparse import pad_queries
from seismic_tpu_torch.ops import grouped_scorer_f
from seismic_tpu_torch.ops.tiles_prep import SUB
from seismic_tpu_torch.search import grouped as tgrouped
from seismic_tpu_torch.search.planner import PlannerContext, plan_grouped
from tests.conftest import make_random_dataset, make_random_queries

K, QC = 10, 10


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
    ja = build_index(ds, cfg)
    ta = from_jax_arrays({f.name: getattr(ja, f.name)
                          for f in dataclasses.fields(ja)})
    qc, qv = make_random_queries(np.random.default_rng(1), n_queries=16,
                                 dim=600, min_nnz=8, max_nnz=30)
    q_comps, q_vals = pad_queries(qc, qv, 64)
    return ja, ta, q_comps, q_vals


@pytest.fixture(scope="module")
def indexes(setup):
    """{csub: (JAX device index, JAX ctx, port index, port ctx)}."""
    from seismic_tpu.search.planner import PlannerContext as JCtx

    ja, ta = setup[:2]
    return {c: (ja.to_device(pallas_tiles=True, tile_csub=c),
                JCtx.from_arrays(ja, csub=c),
                ta.to_device("cpu", tile_csub=c),
                PlannerContext.from_arrays(ta, csub=c)) for c in (1, 2)}


def work_items(ta, q_comps, q_vals, csub, M, n_real=10, n_pad=2):
    """A few real work items of a host plan (spread over the list) plus
    padding items (the zero region, the dump group)."""
    ctx = PlannerContext.from_arrays(ta, csub=csub)
    plan = plan_grouped(q_comps, q_vals, ctx, QC, M=M)
    sel = np.concatenate([np.linspace(0, plan.W - 1, n_real).astype(int),
                          np.arange(plan.W, plan.W + n_pad)])
    return plan, plan.work_region[sel], plan.work_g[sel], plan.work_s[sel]


def covered(out, wg, ws, step):
    """The output blocks the work items wrote: [W, M, step]."""
    return np.stack([out[g, :, s * step:(s + 1) * step]
                     for g, s in zip(wg, ws)])


@pytest.mark.parametrize("M,csub", [(8, 1), (8, 2), (16, 1), (16, 2)])
@pytest.mark.parametrize("centred", [True, False])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_k6_plain_matches_pallas(setup, dtype, centred, M, csub):
    import jax.numpy as jnp
    from seismic_tpu.ops.pallas_grouped import score_grouped_pallas
    from seismic_tpu.ops_pallas_prep import ll_pad_for, prepare_pallas_tiles

    ja, ta, q_comps, q_vals = setup
    plan, wr, wg, ws = work_items(ta, q_comps, q_vals, csub, M)
    tiles_i8, scale3d, _, _ = prepare_pallas_tiles(ja, csub)
    V, R = tiles_i8.shape[1], csub * SUB
    rng = np.random.default_rng(3 + M + csub)
    # projections as the search makes them: few positive entries per row
    q = (rng.random((plan.G_cap, M, V)) * 3
         * (rng.random((plan.G_cap, M, V)) < 0.1)).astype(np.float32)
    qsum = (128.0 * q.sum(-1)).astype(np.float32)  # [G_cap, M]
    ll_max = ll_pad_for(ja.max_list_len, csub)
    j_out = np.asarray(score_grouped_pallas(
        jnp.asarray(tiles_i8), jnp.asarray(scale3d), jnp.asarray(q),
        jnp.asarray(wr), jnp.asarray(wg), jnp.asarray(ws), ll_max,
        interpret=True, compute_dtype=dtype, csub=csub,
        qsum=(jnp.broadcast_to(jnp.asarray(qsum)[..., None],
                               (plan.G_cap, M, R)) if centred else None)))
    scale = np.ascontiguousarray(scale3d[:, 0, :]).reshape(-1)
    before = grouped_scorer_f.launches
    t_out = grouped_scorer_f.score_grouped_f(
        torch.from_numpy(tiles_i8.view(np.uint8)), torch.from_numpy(scale),
        torch.from_numpy(q), torch.from_numpy(qsum) if centred else None,
        torch.from_numpy(wr), torch.from_numpy(wg), torch.from_numpy(ws),
        ll_max, csub, dtype).numpy()
    assert grouped_scorer_f.launches == before  # CPU: the plain version
    assert t_out.shape == j_out.shape == (plan.G_cap, M, ll_max)
    a, b = covered(t_out, wg, ws, R), covered(j_out, wg, ws, R)
    mag = np.abs(b)
    if centred:
        rows = wr[:, None] * R + np.arange(R)
        mag = np.maximum(mag, np.abs(qsum[wg])[:, :, None]
                         * scale[rows][:, None, :])
    assert (np.abs(a - b) <= 1e-5 * mag).all()
    assert (b[:-2] != 0).any()
    if dtype == "bf16":
        # the bf16 rounding of q is really there: f32 operands differ
        f = grouped_scorer_f.score_grouped_f(
            torch.from_numpy(tiles_i8.view(np.uint8)),
            torch.from_numpy(scale), torch.from_numpy(q),
            torch.from_numpy(qsum) if centred else None,
            torch.from_numpy(wr), torch.from_numpy(wg),
            torch.from_numpy(ws), ll_max, csub, "f32").numpy()
        assert np.abs(covered(f, wg, ws, R) - a).max() > 1e-4 * np.abs(a).max()


def test_k6_wrapper_checks_its_operands():
    i32 = torch.zeros(4, dtype=torch.int32)
    tiles = torch.zeros((256, 256), dtype=torch.uint8)
    q = torch.zeros((1, 8, 256))
    with pytest.raises(ValueError, match="compute_dtype"):
        grouped_scorer_f.score_grouped_f(tiles, torch.zeros(256), q, None,
                                         i32, i32, i32, 256, 1, "i8")
    with pytest.raises(ValueError, match="qsum"):
        grouped_scorer_f.score_grouped_f(tiles, torch.zeros(256), q,
                                         torch.zeros((1, 8, 128)), i32, i32,
                                         i32, 256, 1, "f32")
    with pytest.raises(ValueError, match="q must be f32"):
        grouped_scorer_f.score_grouped_f(tiles, torch.zeros(256),
                                         q.to(torch.int8), None, i32, i32,
                                         i32, 256, 1, "f32")


def assert_gate(s_t, i_t, s_j, i_j):
    i_j = np.where(np.isfinite(s_j), i_j, -1)
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
    assert fin.mean() > 0.9


def both(indexes, setup, csub, M=8, **kw):
    """(port scores, port ids, JAX scores, JAX ids) of one search_grouped
    with GroupedParams(**kw) on both packages."""
    from seismic_tpu.search.grouped import GroupedParams as JParams
    from seismic_tpu.search.grouped import search_grouped as j_search

    jdev, jctx, tdev, tctx = indexes[csub]
    q_comps, q_vals = setup[2:]
    s_j, i_j = j_search(jdev, jctx, q_comps, q_vals, JParams(**kw),
                        query_cut=QC, M=M)
    s_t, i_t = tgrouped.search_grouped(tdev, tctx, q_comps, q_vals,
                                       tgrouped.GroupedParams(**kw),
                                       query_cut=QC, M=M)
    return s_t, i_t, np.asarray(s_j), np.asarray(i_j)


@pytest.mark.parametrize("name,csub,M,kw", [
    # the on-device correctness gate's configuration (bench.py:303-367)
    ("gate", 2, 8, dict(k=K, score_cut=64, pool=128, compute_dtype="f32",
                        ovf_pool=0, pool_mode="exact")),
    # a default-constructed GroupedParams: bf16, approx, ovf_pool 64
    ("defaults", 1, 8, dict()),
    ("defaults_m16", 2, 16, dict()),
    ("no_ovf", 1, 8, dict(k=K, use_ovf=False, compute_dtype="f32")),
    ("einsum_f32", 1, 8, dict(k=K, qloc_mode="einsum",
                              compute_dtype="f32")),
    ("einsum_i8", 1, 8, dict(k=K, qloc_mode="einsum", compute_dtype="i8",
                             rescore=32, pool_mode="exact")),
    ("bf16_rescore", 2, 8, dict(k=K, pool=64, rescore=32,
                                pool_mode="hier")),
])
def test_search_grouped_matches_jax(setup, indexes, name, csub, M, kw):
    assert_gate(*both(indexes, setup, csub, M, **kw))


def test_stop_after_stages_match_jax(setup, indexes):
    """Every `stop_after` stage of one configuration (f32 scorer, exact
    pool, rescore) against the JAX program's, each returned twice."""
    kw = dict(k=K, score_cut=64, pool=64, rescore=32, compute_dtype="f32",
              pool_mode="exact")
    q_comps, q_vals = setup[2:]
    csub = 2
    tdev, tctx = indexes[csub][2:]
    plan = plan_grouped(q_comps, q_vals, tctx, QC, M=8)
    B, P = len(q_comps), len(q_comps) * QC
    out = {}
    for stage in ("qloc", "expand", "kernel", "regroup", "pool", "prerank"):
        a_t, b_t, a_j, b_j = both(indexes, setup, csub, stop_after=stage,
                                  **kw)
        if stage not in ("pool", "prerank"):  # (scores, ids) there
            np.testing.assert_array_equal(a_t, b_t)
            np.testing.assert_array_equal(a_j, b_j)
        out[stage] = (a_t, b_t, a_j, b_j)
    # qloc: JAX's is lane-major [V, P_cap]; the port's row-major [P, V]
    np.testing.assert_array_equal(out["qloc"][0], out["qloc"][2].T[:P])
    np.testing.assert_array_equal(out["expand"][0], out["expand"][2])
    R = csub * SUB
    wg, ws = plan.work_g[:plan.W], plan.work_s[:plan.W]
    a, b = (covered(out["kernel"][i], wg, ws, R) for i in (0, 2))
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * np.abs(b).max())
    a, b = out["regroup"][0], out["regroup"][2]
    assert a.shape == b.shape and a.shape[0] == B
    assert (np.isfinite(a) == np.isfinite(b)).all()
    fin = np.isfinite(b)
    np.testing.assert_allclose(a[fin], b[fin], rtol=1e-4,
                               atol=1e-5 * np.abs(b[fin]).max())
    for stage in ("pool", "prerank"):
        s_t, i_t, s_j, i_j = out[stage]
        fin = np.isfinite(s_j)
        assert (np.isfinite(s_t) == fin).all()
        np.testing.assert_allclose(np.sort(s_t, 1)[np.sort(fin, 1)],
                                   np.sort(s_j, 1)[np.sort(fin, 1)],
                                   rtol=1e-3)
        same = np.mean([set(x[f].tolist()) == set(y[f].tolist())
                        for x, y, f in zip(i_t, i_j, fin)])
        assert same >= 0.9, (stage, same)
