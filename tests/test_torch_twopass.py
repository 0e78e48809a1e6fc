"""seismic_tpu_torch's pool-truncation margin, weighted list cut and
two-pass driver against the JAX package, on the CPU, on the index of
tests/test_twopass.py (numpy data from a seed) carried across with
`from_jax_arrays`:

- `return_margin`: scores, ids and the diagnostics [B, 5] against JAX's
  `search_grouped_derive_jit` (interpret mode) to 1e-5, and the refusals
  (no rescore, block_expand) JAX makes too;
- the weighted list cut: `plan_caps(weighted=True)` equal to JAX's, the
  derived plan equal to JAX's field for field and selecting the host
  caps' lists, and `search_grouped_derive(weighted=True)` against JAX's;
- `search_batch_twopass` against JAX's with every query flagged, none,
  and some: the same flags and the same results; all flagged equals the
  deep pass alone, none equals pass 1."""

import dataclasses

import numpy as np
import pytest
import torch

from seismic_tpu_torch import from_jax_arrays
from seismic_tpu_torch.data.sparse import pad_queries
from seismic_tpu_torch.search import grouped as tgrouped
from seismic_tpu_torch.search import twopass as ttwopass
from seismic_tpu_torch.search.planner import PlannerContext, plan_grouped
from tests.conftest import make_random_dataset, make_random_queries

K = 10
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup():
    pytest.importorskip("jax")
    from seismic_tpu import Configuration, TpuLayout
    from seismic_tpu.build.builder import build_index
    from seismic_tpu.search.planner import PlannerContext as JCtx

    ds = make_random_dataset(np.random.default_rng(0), n_docs=400, dim=600,
                             min_nnz=15, max_nnz=50, seed=42)
    ja = build_index(ds, Configuration(layout=TpuLayout(
        max_block_len=16, summary_vocab_cap=256, tile_overflow=16)))
    ta = from_jax_arrays({f.name: getattr(ja, f.name)
                          for f in dataclasses.fields(ja)})
    qc, qv = make_random_queries(np.random.default_rng(1), n_queries=16,
                                 dim=600, min_nnz=8, max_nnz=30)
    q_comps, q_vals = pad_queries(qc, qv, 64)
    return (ja.to_device(pallas_tiles=True), JCtx.from_arrays(ja),
            ta.to_device(CPU), PlannerContext.from_arrays(ta), q_comps,
            q_vals)


def _params(GroupedParams, cheap_pool=16, deep_pool=128, **kw):
    # tests/test_twopass.py::_params
    p1 = GroupedParams(k=K, score_cut=64, pool=cheap_pool,
                       rescore=cheap_pool, pool_mode="exact", **kw)
    p2 = GroupedParams(k=K, score_cut=64, pool=deep_pool,
                       rescore=min(64, deep_pool), pool_mode="exact", **kw)
    return p1, p2


def _jax_derive(setup, params, qcut, weighted=False):
    import jax.numpy as jnp
    from seismic_tpu.search.grouped import plan_caps as j_caps
    from seismic_tpu.search.grouped import search_grouped_derive_jit

    jdev, jctx, _, _, q_comps, q_vals = setup
    gc, wc = j_caps(q_comps, q_vals, jctx, qcut, M=8, weighted=weighted)
    out = search_grouped_derive_jit(
        jdev, jnp.asarray(q_comps, jnp.int32),
        jnp.asarray(q_vals, jnp.float32), params, qcut, 8, gc, wc,
        jctx.zero_region, weighted=weighted)
    return [np.asarray(o) for o in out]


def _port_derive(setup, params, qcut, weighted=False):
    _, _, tdev, ctx, q_comps, q_vals = setup
    gc, wc = tgrouped.plan_caps(q_comps, q_vals, ctx, qcut, M=8,
                                weighted=weighted)
    out = tgrouped.search_grouped_derive(
        tdev, torch.from_numpy(q_comps), torch.from_numpy(q_vals), params,
        qcut, 8, gc, wc, ctx.zero_region, weighted=weighted)
    return [o.numpy() for o in out]


def _assert_same(s_t, i_t, s_j, i_j):
    for a, b in zip(i_t, i_j):
        assert set(map(int, a[a >= 0])) == set(map(int, b[b >= 0]))
    fin = np.isfinite(s_j)
    assert (np.isfinite(s_t) == fin).all()
    np.testing.assert_allclose(np.sort(s_t, 1), np.sort(s_j, 1), rtol=1e-5)


@pytest.mark.parametrize("dt", ["bf16", "i8"])
def test_return_margin_matches_jax(setup, dt):
    """return_margin's third output: the kth exact score, the pool bottom,
    the mean and max exact - approx gap and the bottom-quarter range,
    against JAX's to 1e-5 (relative, and absolute on the gaps)."""
    from seismic_tpu.search.grouped import GroupedParams as JParams

    kw = dict(k=K, score_cut=64, pool=16, rescore=16, pool_mode="exact",
              compute_dtype=dt, return_margin=True)
    s_j, i_j, d_j = _jax_derive(setup, JParams(**kw), 6)
    s_t, i_t, d_t = _port_derive(setup, tgrouped.GroupedParams(**kw), 6)
    _assert_same(s_t, i_t, s_j, np.where(np.isfinite(s_j), i_j, -1))
    assert d_t.shape == (len(s_t), 5) and d_t.dtype == np.float32
    np.testing.assert_array_equal(d_t[:, 0], s_t[:, K - 1])
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=1e-5)
    assert np.isfinite(d_t[:, 1]).all()  # the pool of 16 is filled


@pytest.mark.parametrize("change", [{"rescore": 0},
                                    {"block_expand": 8, "rescore": 16}])
def test_return_margin_refusals(change):
    params = tgrouped.GroupedParams(return_margin=True, **change)
    with pytest.raises(ValueError, match="return_margin"):
        tgrouped._check_supported(params)


def test_weighted_caps_and_plan_match_jax(setup):
    """The weighted cut: plan_caps equal to JAX's (and not to the
    unweighted caps' lists), the derived plan equal to JAX's field for
    field, its lists those of the host planner on the weighted values."""
    import jax.numpy as jnp
    from seismic_tpu.search.grouped import derive_plan_device as j_derive
    from seismic_tpu.search.grouped import plan_caps as j_caps

    jdev, jctx, tdev, ctx, q_comps, q_vals = setup
    qcut = 6
    caps = tgrouped.plan_caps(q_comps, q_vals, ctx, qcut, weighted=True)
    assert caps == j_caps(q_comps, q_vals, jctx, qcut, weighted=True)
    G_cap, W_cap = caps
    dp = tgrouped.derive_plan_device(
        tdev, torch.from_numpy(q_comps), torch.from_numpy(q_vals), qcut, 8,
        G_cap, W_cap, ctx.zero_region, weighted=True)
    jv = j_derive(jdev, jnp.asarray(q_comps, jnp.int32),
                  jnp.asarray(q_vals, jnp.float32), qcut, 8, G_cap, W_cap,
                  jctx.zero_region, weighted=True)
    for f in tgrouped._PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(dp, f).numpy(),
                                      np.asarray(getattr(jv, f)), err_msg=f)
    w = np.where(q_comps < ctx.n_lists,
                 ctx.list_weight[np.clip(q_comps, 0, ctx.n_lists - 1)], 0.0)
    host = plan_grouped(q_comps, q_vals * w, ctx, qcut)
    plain = plan_grouped(q_comps, q_vals, ctx, qcut)
    assert (int(dp.G), int(dp.W)) == (host.G, host.W)
    changed = 0
    for b in range(len(q_comps)):
        lists = sorted(dp.pair_list[b].numpy()[dp.pair_valid[b].numpy()])
        assert lists == sorted(host.pair_list[b][host.pair_valid[b]])
        changed += lists != sorted(plain.pair_list[b][plain.pair_valid[b]])
    assert changed > 0  # the weights move some query's selection


def test_weighted_search_matches_jax(setup):
    from seismic_tpu.search.grouped import GroupedParams as JParams

    kw = dict(k=K, score_cut=64, pool=64, rescore=32, pool_mode="hier",
              compute_dtype="i8", kernel_unroll=2)
    s_j, i_j = _jax_derive(setup, JParams(**kw), 6, weighted=True)
    s_t, i_t = _port_derive(setup, tgrouped.GroupedParams(**kw), 6,
                            weighted=True)
    _assert_same(s_t, i_t, s_j, np.where(np.isfinite(s_j), i_j, -1))


@pytest.mark.parametrize("case", ["all", "none", "some"])
def test_twopass_matches_jax(setup, case):
    """search_batch_twopass against JAX's: the same flags (within the
    pass-2 cap), the same rows; all flagged equals the deep pass alone
    and none flagged equals pass 1 (tests/test_twopass.py's contracts)."""
    from seismic_tpu.search.grouped import GroupedParams as JParams
    from seismic_tpu.search.twopass import TwoPassParams as JTP
    from seismic_tpu.search.twopass import search_batch_twopass as j_tp

    jdev, jctx, tdev, ctx, q_comps, q_vals = setup
    tp_kw = dict(query_cut1=6, query_cut2=10, b2_min=16, b2_frac=1.0,
                 **{"all": dict(eps=np.inf, eps_rel=0.0),
                    "none": dict(eps=-np.inf, eps_rel=0.0),
                    "some": dict(eps=0.0, eps_rel=0.05)}[case])
    s_j, i_j, st_j = j_tp(jdev, jctx, q_comps, q_vals,
                          JTP(*_params(JParams), **tp_kw))
    tp = ttwopass.TwoPassParams(*_params(tgrouped.GroupedParams), **tp_kw)
    s_t, i_t, st_t = ttwopass.search_batch_twopass(tdev, ctx, q_comps,
                                                   q_vals, tp)
    np.testing.assert_array_equal(st_t["flagged_idx"], st_j["flagged_idx"])
    np.testing.assert_allclose(st_t["margin"], st_j["margin"], rtol=1e-5,
                               atol=1e-5)
    _assert_same(s_t, i_t, np.asarray(s_j),
                 np.where(np.isfinite(s_j), i_j, -1))
    if case == "some":
        assert 0 < st_t["flagged"] < len(q_comps)
        return
    pass_ = tp.pass2 if case == "all" else dataclasses.replace(
        tp.pass1, return_margin=True)
    alone = _port_derive(setup, pass_, 10 if case == "all" else 6)
    assert st_t["flagged"] == (len(q_comps) if case == "all" else 0)
    np.testing.assert_array_equal(i_t, alone[1])
    np.testing.assert_array_equal(s_t, alone[0])
    with pytest.raises(ValueError, match="rescore"):
        ttwopass.TwoPassParams(dataclasses.replace(tp.pass1, rescore=0),
                               tp.pass2)
