"""seismic_tpu_torch on the JAX package's bench headline path
(`bench.py:514-536, 604-669`): `plan_caps` on the host, then
`search_grouped_derive` (device-derived plan, K4 item-major scorer with
kernel_unroll 8, csub 2, hier pool, bf16 score wall, post-dedup), against
the JAX package on one index carried across with `from_jax_arrays` and
narrowed by each package's own `narrow_vocab`, on queries made with numpy
from a seed:

- the copied C++ planner gives plans identical to JAX's
  `plan_grouped_native`, and `plan_caps` the same caps;
- `derive_plan_device` gives JAX's derived plan field for field, at M 8
  and 16, and the host plan's groups and work items;
- `search_grouped_derive` against `search_grouped_derive_jit` at M 8 and
  16 (the JAX kernels in interpret mode): the repo's own gate
  (bench.py:355-360), >= 98% of queries with equal top-k id sets and
  scores < 1e-3 relative;
- `search_grouped` with a host plan gives the same results with the
  item-major scorer as with the slot-major one, at csub 1 and 2
  (tests/test_grouped.py:418-441)."""

import dataclasses

import numpy as np
import pytest
import torch

from seismic_tpu_torch import from_jax_arrays
from seismic_tpu_torch import native as tnative
from seismic_tpu_torch.data.sparse import pad_queries
from seismic_tpu_torch.ops.tiles_prep import narrow_vocab
from seismic_tpu_torch.search import grouped as tgrouped
from seismic_tpu_torch.search.planner import PlannerContext, plan_grouped
from tests.conftest import make_random_dataset, make_random_queries

K, QC, V0, CSUB = 10, 14, 128, 2
CPU = torch.device("cpu")


def _headline(GroupedParams):
    # bench.py:528-536 at BENCH_r05's rung qc14 / pool96 / r64
    return GroupedParams(k=K, score_cut=64, pool=96, rescore=64,
                         compute_dtype="i8", pool_mode="hier",
                         pool_per_pair=16, kernel_unroll=8,
                         pool_dtype="bf16", dedup_mode="post",
                         pool_recall=0.98)


@pytest.fixture(scope="module")
def setup():
    pytest.importorskip("jax")
    from seismic_tpu import Configuration, TpuLayout
    from seismic_tpu.build.builder import build_index
    from seismic_tpu.ops.pallas_tiles import narrow_vocab as j_narrow
    from seismic_tpu.search.planner import PlannerContext as JCtx

    ds = make_random_dataset(np.random.default_rng(0), n_docs=400, dim=600,
                             min_nnz=15, max_nnz=50, seed=42)
    cfg = Configuration(layout=TpuLayout(max_block_len=16,
                                         summary_vocab_cap=256,
                                         tile_overflow=16))
    full = build_index(ds, cfg, value_dtype="f32")
    ta = narrow_vocab(from_jax_arrays(
        {f.name: getattr(full, f.name) for f in dataclasses.fields(full)}),
        V0)
    ja = j_narrow(full, V0)
    qc, qv = make_random_queries(np.random.default_rng(1), n_queries=64,
                                 dim=600, min_nnz=8, max_nnz=30)
    q_comps, q_vals = pad_queries(qc, qv, 64)  # the bench's query padding
    return (ja, ta, JCtx.from_arrays(ja, csub=CSUB),
            PlannerContext.from_arrays(ta, csub=CSUB), q_comps, q_vals)


@pytest.fixture(scope="module")
def jax_index(setup):
    return setup[0].to_device(pallas_tiles=True, tile_csub=CSUB)


@pytest.fixture(scope="module")
def port_index(setup):
    return setup[1].to_device(CPU, tile_csub=CSUB)


@pytest.mark.parametrize("M", [8, 16])
def test_native_planner_and_caps_match_jax(setup, M):
    from seismic_tpu.native import plan_grouped_native as j_native
    from seismic_tpu.search.grouped import plan_caps as j_caps

    _, _, jctx, ctx, q_comps, q_vals = setup
    jp = j_native(q_comps, q_vals, jctx, QC, M=M)
    assert jp is not None
    tp = plan_grouped(q_comps, q_vals, ctx, QC, M=M)
    assert (tp.G, tp.W, tp.M) == (jp.G, jp.W, jp.M)
    for f in tgrouped._PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f),
                                      err_msg=f)
    assert tgrouped.plan_caps(q_comps, q_vals, ctx, QC, M=M) == j_caps(
        q_comps, q_vals, jctx, QC, M=M) == (tp.G_cap, tp.W_cap)
    # native=False asks for the NumPy planner: the same groups and items
    npp = plan_grouped(q_comps, q_vals, ctx, QC, M=M, native=False)
    assert (npp.G, npp.W, npp.G_cap, npp.W_cap) == (tp.G, tp.W, tp.G_cap,
                                                    tp.W_cap)


def test_planner_raises_when_it_cannot_be_built(setup, monkeypatch):
    """No silent fallback to NumPy: a planner library that cannot be built
    is an error."""
    _, _, _, ctx, q_comps, q_vals = setup

    def broken(name, src):
        raise RuntimeError("cannot build planner.cpp")

    monkeypatch.setattr(tnative, "_planner_lib", None)
    monkeypatch.setattr(tnative, "build_host_lib", broken)
    with pytest.raises(RuntimeError, match="cannot build"):
        plan_grouped(q_comps, q_vals, ctx, QC)


def test_host_library_name_keys_source_flags_and_cpu(monkeypatch):
    """A build of another source, other flags or another CPU never gets
    the name of this host's build."""
    src = tnative._PLANNER_SRC
    base = tnative.lib_path("p", src, ("-O3",))
    assert tnative.lib_path("p", src, ("-O3",)) == base
    assert tnative.lib_path("p", src, ("-O3", "-march=native")) != base
    assert tnative.lib_path("p", tnative._SRC, ("-O3",)) != base
    monkeypatch.setattr(tnative, "_host_cpu", lambda: "another CPU")
    assert tnative.lib_path("p", src, ("-O3",)) != base


def _jax_derived(jax_index, q_comps, q_vals, M, G_cap, W_cap, zero_region):
    import jax.numpy as jnp
    from seismic_tpu.search.grouped import derive_plan_device

    v = derive_plan_device(jax_index, jnp.asarray(q_comps, jnp.int32),
                           jnp.asarray(q_vals, jnp.float32), QC, M, G_cap,
                           W_cap, zero_region)
    return {f: np.asarray(getattr(v, f)) for f in tgrouped._PLAN_FIELDS}


@pytest.mark.parametrize("M", [8, 16])
def test_derive_plan_matches_jax_and_host(setup, jax_index, port_index, M):
    _, _, jctx, ctx, q_comps, q_vals = setup
    host = plan_grouped(q_comps, q_vals, ctx, QC, M=M)
    G_cap, W_cap = host.G_cap, host.W_cap
    dp = tgrouped.derive_plan_device(
        port_index, torch.from_numpy(q_comps), torch.from_numpy(q_vals), QC,
        M, G_cap, W_cap, ctx.zero_region)
    jd = _jax_derived(jax_index, q_comps, q_vals, M, G_cap, W_cap,
                      jctx.zero_region)
    for f in tgrouped._PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(dp, f).numpy(), jd[f],
                                      err_msg=f)
    # against the host plan: the same groups and work items (the pair
    # tables' qc columns follow each planner's own top-QC order)
    G, W = int(dp.G), int(dp.W)
    assert (G, W) == (host.G, host.W) and G > 0
    assert (host.slot_b[:G] < len(q_comps)).sum() > G  # groups share lists
    for f in ("group_list", "group_region", "group_nrows", "work_region",
              "work_g", "work_s"):
        np.testing.assert_array_equal(getattr(dp, f).numpy(),
                                      getattr(host, f), err_msg=f)
    for b in range(len(q_comps)):
        ok_d, ok_h = dp.pair_valid[b].numpy(), host.pair_valid[b]
        assert sorted(dp.pair_list[b].numpy()[ok_d]) == sorted(
            host.pair_list[b][ok_h])


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


@pytest.mark.parametrize("M", [8, 16])
def test_search_grouped_derive_matches_jax(setup, jax_index, port_index, M):
    import jax.numpy as jnp
    from seismic_tpu.search.grouped import GroupedParams as JParams
    from seismic_tpu.search.grouped import search_grouped_derive_jit

    _, _, jctx, ctx, q_comps, q_vals = setup
    G_cap, W_cap = tgrouped.plan_caps(q_comps, q_vals, ctx, QC, M=M)
    s_j, i_j = search_grouped_derive_jit(
        jax_index, jnp.asarray(q_comps, jnp.int32),
        jnp.asarray(q_vals, jnp.float32), _headline(JParams), QC, M, G_cap,
        W_cap, jctx.zero_region)
    s_j, i_j = np.asarray(s_j), np.asarray(i_j)
    s_t, i_t = tgrouped.search_grouped_derive(
        port_index, torch.from_numpy(q_comps), torch.from_numpy(q_vals),
        _headline(tgrouped.GroupedParams), QC, M, G_cap, W_cap,
        ctx.zero_region)
    assert s_t.dtype == torch.float32 and s_t.shape == (len(q_comps), K)
    _assert_gate(s_t.numpy(), i_t.numpy(), s_j,
                 np.where(np.isfinite(s_j), i_j, -1))
    assert (i_t.numpy() >= 0).mean() > 0.9


@pytest.mark.parametrize("pool_mode", ["exact", "hier"])
@pytest.mark.parametrize("unroll", [2, 8])
def test_item_major_equals_slot_major(setup, pool_mode, unroll):
    """kernel_unroll > 1 (K4 + `_item_regroup`) gives exactly the results
    of kernel_unroll 1 (K2) with a host plan, at csub 1 (K2's item)."""
    _, ta, _, _, q_comps, q_vals = setup
    index = ta.to_device(CPU, tile_csub=1)
    ctx1 = PlannerContext.from_arrays(ta, csub=1)
    base = dataclasses.replace(_headline(tgrouped.GroupedParams),
                               pool_mode=pool_mode, kernel_unroll=1)
    s_b, i_b = tgrouped.search_grouped(index, ctx1, q_comps, q_vals, base,
                                       query_cut=QC)
    s_u, i_u = tgrouped.search_grouped(
        index, ctx1, q_comps, q_vals,
        dataclasses.replace(base, kernel_unroll=unroll), query_cut=QC)
    np.testing.assert_array_equal(i_u, i_b)
    np.testing.assert_allclose(s_u, s_b, rtol=1e-6)


def test_slot_major_refuses_csub2(setup, port_index):
    """The slot-major scorer (K2) no longer refuses csub 2: it gives the
    item-major scorer's results there. The weighted list cut's caps equal
    the JAX package's."""
    from seismic_tpu.search.grouped import plan_caps as j_caps

    _, _, jctx, ctx, q_comps, q_vals = setup
    item = _headline(tgrouped.GroupedParams)
    s_i, i_i = tgrouped.search_grouped(port_index, ctx, q_comps, q_vals,
                                       item, query_cut=QC)
    s_s, i_s = tgrouped.search_grouped(
        port_index, ctx, q_comps, q_vals,
        dataclasses.replace(item, kernel_unroll=1), query_cut=QC)
    np.testing.assert_array_equal(i_s, i_i)
    np.testing.assert_allclose(s_s, s_i, rtol=1e-6)
    assert (tgrouped.plan_caps(q_comps, q_vals, ctx, QC, weighted=True)
            == j_caps(q_comps, q_vals, jctx, QC, weighted=True))


def test_top_k_tie_order():
    """`_top_k` is `lax.top_k` (descending, lower index first among
    ties) on a bf16 wall full of ties and -inf, and on f32."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    x = rng.integers(-3, 4, size=(6, 300)).astype(np.float32) / 4
    x[rng.random(x.shape) < 0.3] = -np.inf
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        v, i = tgrouped._top_k(torch.from_numpy(x).to(dt), 40)
        jv, ji = jax.lax.top_k(jnp.asarray(x, jdt), 40)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.float().numpy(),
                                      np.asarray(jv, np.float32))


def test_scatter_drop_is_mode_drop():
    import jax.numpy as jnp

    idx = np.array([3, 9, -1, 0, 7, 12], np.int32)
    src = np.arange(6, dtype=np.int32) + 10
    j = jnp.full(8, -5, jnp.int32).at[idx].set(src, mode="drop")
    t = tgrouped._scatter_drop(8, -5, torch.from_numpy(idx),
                               torch.from_numpy(src))
    # JAX drops negative indices too under mode="drop"
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_derive_rejects_host_arrays(port_index, setup):
    _, _, _, ctx, q_comps, q_vals = setup
    with pytest.raises(ValueError, match="tensors"):
        tgrouped.search_grouped_derive(
            port_index, q_comps, q_vals, _headline(tgrouped.GroupedParams),
            QC, 8, 512, 2048, ctx.zero_region)
