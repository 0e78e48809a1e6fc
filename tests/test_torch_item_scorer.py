"""seismic_tpu_torch K4 (the item-major grouped int8 scorer) and the tile
layout of the bench headline path, against the JAX package on the same
inputs made with numpy from a seed:

- K4's plain version against `_score_grouped_i8(..., unroll=2 and 8)` run
  in interpret mode, for csub 1 and 2 and M 8 and 16: equal f32 on every
  row (the int dot is exact and the f32 products are the same);
- `_item_regroup` against the JAX one: equal;
- `narrow_vocab`: every field equal; `to_device(tile_csub=2)`: tiles,
  flat row scale and region starts equal to `prepare_pallas_tiles(.., 2)`
  and the planner context's zero region equal;
- the wrapper's CPU contract, and on a machine with an NVIDIA card only,
  the CUDA kernel against its plain version."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from seismic_tpu_torch import from_jax_arrays
from seismic_tpu_torch.data.sparse import pad_queries
from seismic_tpu_torch.ops import grouped_scorer_item
from seismic_tpu_torch.ops.tiles_prep import SUB, narrow_vocab
from seismic_tpu_torch.search.grouped import DevicePlan, _item_regroup
from seismic_tpu_torch.search.planner import PlannerContext, plan_grouped
from tests.conftest import make_random_dataset, make_random_queries

V0, QC = 128, 14


@pytest.fixture(scope="module")
def setup():
    pytest.importorskip("jax")
    from seismic_tpu import Configuration, TpuLayout
    from seismic_tpu.build.builder import build_index
    from seismic_tpu.ops.pallas_tiles import narrow_vocab as j_narrow

    ds = make_random_dataset(np.random.default_rng(0), n_docs=400, dim=600,
                             min_nnz=15, max_nnz=50, seed=42)
    cfg = Configuration(layout=TpuLayout(max_block_len=16,
                                         summary_vocab_cap=256,
                                         tile_overflow=16))
    ja = build_index(ds, cfg, value_dtype="f32")
    ta = from_jax_arrays({f.name: getattr(ja, f.name)
                          for f in dataclasses.fields(ja)})
    qc, qv = make_random_queries(np.random.default_rng(1), n_queries=32,
                                 dim=600, min_nnz=8, max_nnz=30)
    q_comps, q_vals = pad_queries(qc, qv, 64)
    return ja, ta, j_narrow(ja, V0), narrow_vocab(ta, V0), q_comps, q_vals


def test_narrow_vocab_matches_jax(setup):
    _, _, jn, tn, _, _ = setup
    for f in dataclasses.fields(jn):
        a, b = getattr(jn, f.name), getattr(tn, f.name)
        if f.name == "config":
            assert a.to_dict() == b.to_dict()
        elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                          err_msg=f.name)
            assert np.asarray(b).dtype == np.asarray(a).dtype, f.name
        else:
            assert a == b, f.name
    assert tn.doc_tiles.shape[1] == V0
    assert tn.config.layout.summary_vocab_cap == V0


@pytest.mark.parametrize("csub", [1, 2])
def test_to_device_csub_matches_jax_layout(setup, csub):
    from seismic_tpu.ops_pallas_prep import prepare_pallas_tiles
    from seismic_tpu.search.planner import PlannerContext as JCtx

    _, _, jn, tn, _, _ = setup
    tiles_i8, scale3d, region_start, _ = prepare_pallas_tiles(jn, csub)
    dev = tn.to_device("cpu", tile_csub=csub)
    assert dev.tile_csub == csub
    np.testing.assert_array_equal(dev.doc_tiles_aligned.numpy(),
                                  tiles_i8.view(np.uint8))
    np.testing.assert_array_equal(
        dev.tile_scale.numpy(), np.ascontiguousarray(
            scale3d[:, 0, :]).reshape(-1))
    np.testing.assert_array_equal(dev.list_region_start.numpy(),
                                  region_start)
    ctx, jctx = (PlannerContext.from_arrays(tn, csub=csub),
                 JCtx.from_arrays(jn, csub=csub))
    assert ctx.zero_region == jctx.zero_region
    np.testing.assert_array_equal(ctx.list_region_start,
                                  jctx.list_region_start)


def _work_items(tn, q_comps, q_vals, csub, M, n_real=12, n_pad=4):
    """A few real work items of a host plan (spread over the list) plus
    padding items (the zero region, the dump group)."""
    ctx = PlannerContext.from_arrays(tn, csub=csub)
    plan = plan_grouped(q_comps, q_vals, ctx, QC, M=M)
    pick = np.linspace(0, plan.W - 1, n_real).astype(int)
    pad = np.arange(plan.W, plan.W + n_pad)
    sel = np.concatenate([pick, pad])
    return plan, plan.work_region[sel], plan.work_g[sel]


@pytest.mark.parametrize("csub", [1, 2])
@pytest.mark.parametrize("M", [8, 16])
def test_k4_item_scorer_matches_jax(setup, csub, M):
    import jax.numpy as jnp
    from seismic_tpu.ops.pallas_grouped import _score_grouped_i8
    from seismic_tpu.ops_pallas_prep import ll_pad_for, prepare_pallas_tiles

    _, _, jn, tn, q_comps, q_vals = setup
    plan, wr, wg = _work_items(tn, q_comps, q_vals, csub, M)
    tiles_i8, scale3d, _, _ = prepare_pallas_tiles(jn, csub)
    V = tiles_i8.shape[1]
    rng = np.random.default_rng(11 + M + csub)
    q = rng.integers(-127, 128, size=(plan.G_cap, M, V)).astype(np.int8)
    ll_max = ll_pad_for(jn.max_list_len, csub)
    tiles = torch.from_numpy(tiles_i8.view(np.uint8))
    scale = torch.from_numpy(np.ascontiguousarray(
        scale3d[:, 0, :]).reshape(-1))
    before = grouped_scorer_item.launches
    t_out = grouped_scorer_item.score_grouped_i8_item(
        tiles, scale, torch.from_numpy(q), torch.from_numpy(wr),
        torch.from_numpy(wg), csub).numpy()
    assert grouped_scorer_item.launches == before  # CPU: the plain version
    assert t_out.shape == (len(wr), M, csub * SUB)
    for U in (2, 8):
        j_out = np.asarray(_score_grouped_i8(
            jnp.asarray(tiles_i8), jnp.asarray(scale3d), jnp.asarray(q),
            jnp.asarray(wr), jnp.asarray(wg), jnp.zeros_like(wr), ll_max,
            interpret=True, csub=csub, unroll=U))
        np.testing.assert_array_equal(t_out, j_out, err_msg=f"unroll {U}")
    # exact int dots against a numpy int64 product, padding items are 0
    dots = grouped_scorer_item.grouped_dots_plain(
        tiles, torch.from_numpy(q), torch.from_numpy(wr),
        torch.from_numpy(wg), rows_per_item=csub * SUB).numpy()
    R = csub * SUB
    for i in range(len(wr)):
        t = tiles_i8.view(np.uint8)[wr[i] * R:(wr[i] + 1) * R]
        ref = q[wg[i]].astype(np.int64) @ t.astype(np.int64).T
        np.testing.assert_array_equal(dots[i], ref)
    assert (t_out[-4:] == 0).all() and (t_out[:-4] != 0).any()


@pytest.mark.parametrize("csub", [1, 2])
def test_item_regroup_matches_jax(setup, csub):
    import jax.numpy as jnp
    from seismic_tpu.ops_pallas_prep import ll_pad_for
    from seismic_tpu.search.grouped import _item_regroup as j_regroup

    _, _, _, tn, q_comps, q_vals = setup
    M = 8
    ctx = PlannerContext.from_arrays(tn, csub=csub)
    plan = plan_grouped(q_comps, q_vals, ctx, QC, M=M)
    STEP = csub * SUB
    NSUP = ll_pad_for(tn.max_list_len, csub) // STEP
    scores = np.random.default_rng(5).standard_normal(
        (plan.W_cap, M, STEP)).astype(np.float32)
    t_out = _item_regroup(torch.from_numpy(scores),
                          DevicePlan.put(plan, torch.device("cpu")), csub,
                          NSUP).numpy()
    jplan = types.SimpleNamespace(
        group_nrows=jnp.asarray(plan.group_nrows),
        pair_slot=jnp.asarray(plan.pair_slot))
    j_out = np.asarray(j_regroup(jnp.asarray(scores), jplan, csub, NSUP))
    np.testing.assert_array_equal(t_out, j_out)


def test_k4_wrapper_checks_its_operands():
    """Wrong dtypes or shapes are refused before any launch."""
    i32 = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        grouped_scorer_item.score_grouped_i8_item(
            torch.zeros((256, 256), dtype=torch.int8), torch.zeros(256),
            torch.zeros((1, 8, 256), dtype=torch.int8), i32, i32, 1)
    with pytest.raises(ValueError):  # rows not a multiple of csub * 128
        grouped_scorer_item.score_grouped_i8_item(
            torch.zeros((128, 256), dtype=torch.uint8), torch.zeros(128),
            torch.zeros((1, 8, 256), dtype=torch.int8), i32, i32, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("csub", [1, 2])
@pytest.mark.parametrize("M", [8, 16])
def test_cuda_k4_matches_plain(setup, csub, M):
    """On the card: the CUDA kernel against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    _, ta, _, _, q_comps, q_vals = setup  # V = 256, a width K4 serves
    dev = torch.device("cuda")
    index = ta.to_device(dev, tile_csub=csub)
    plan, wr, wg = _work_items(ta, q_comps, q_vals, csub, M)
    V = index.doc_tiles_aligned.shape[1]
    q = torch.from_numpy(np.random.default_rng(7).integers(
        -127, 128, size=(plan.G_cap, M, V)).astype(np.int8)).to(dev)
    args = (index.doc_tiles_aligned, index.tile_scale, q,
            torch.from_numpy(wr).to(dev), torch.from_numpy(wg).to(dev), csub)
    torch.testing.assert_close(
        grouped_scorer_item.score_grouped_i8_item(*args),
        grouped_scorer_item.score_grouped_i8_item_plain(*args),
        rtol=1e-6, atol=0)
