"""seismic_tpu_torch K5 (the packed-index epilogue of the grouped scorers)
and the pools that are glue, against the JAX package on the same inputs
made with numpy from a seed:

- the plain versions of K2, K4 and K6 with packed output against
  `score_grouped_pallas(..., pack_idx=True)` run in interpret mode, with
  `pack_window` 1 and 2 and `unroll` 1 and 2: bit-equal on the int8
  scorers (the i32 dot, its f32 convert and the one f32 multiply are exact
  and ordered, the rest is integer work); on the bf16 scorer the unpacked
  score to K6's tolerance and the row wherever the window's winner leads
  by more than it;
- `search_grouped` of the port against JAX's for `pool_mode` "window",
  "stride" (slot-major and item-major scorer, csub 1 and 2, exact and
  approx selection), "slot" and "seg", under the repo's gate
  (bench.py:355-360): top-k id sets equal on >= 98% of queries, scores
  < 1e-3 relative; the seg pool equals the exact pool."""

import dataclasses

import numpy as np
import pytest
import torch

from seismic_tpu_torch.ops import (
    grouped_scorer,
    grouped_scorer_f,
    grouped_scorer_item,
    pack_epilogue,
)
from seismic_tpu_torch.ops.tiles_prep import SUB
from seismic_tpu_torch.search import grouped as tgrouped
from tests.test_torch_grouped_f import (  # noqa: F401 - fixtures
    K,
    assert_gate,
    both,
    covered,
    indexes,
    setup,
    work_items,
)


def _pallas_inputs(setup, csub, M):
    from seismic_tpu.ops_pallas_prep import ll_pad_for, prepare_pallas_tiles

    ja, ta, q_comps, q_vals = setup
    plan, wr, wg, ws = work_items(ta, q_comps, q_vals, csub, M)
    tiles_i8, scale3d, _, _ = prepare_pallas_tiles(ja, csub)
    scale = np.ascontiguousarray(scale3d[:, 0, :]).reshape(-1)
    return (plan, wr, wg, ws, tiles_i8, scale3d, scale,
            ll_pad_for(ja.max_list_len, csub))


@pytest.mark.parametrize("M,csub,pack_window,unroll", [
    (8, 1, 1, 1), (8, 2, 1, 1), (8, 2, 2, 1), (16, 2, 2, 1),
    (8, 1, 1, 2), (8, 2, 2, 2), (16, 2, 1, 2), (16, 2, 2, 2),
])
def test_k5_on_i8_scorers_is_bit_equal_to_pallas(setup, M, csub, pack_window,
                                                 unroll):
    import jax.numpy as jnp
    from seismic_tpu.ops.pallas_grouped import score_grouped_pallas

    plan, wr, wg, ws, tiles_i8, scale3d, scale, ll_max = _pallas_inputs(
        setup, csub, M)
    V = tiles_i8.shape[1]
    q = np.random.default_rng(5 + M + csub).integers(
        -127, 128, size=(plan.G_cap, M, V)).astype(np.int8)
    j_out = np.asarray(score_grouped_pallas(
        jnp.asarray(tiles_i8), jnp.asarray(scale3d), jnp.asarray(q),
        jnp.asarray(wr), jnp.asarray(wg), jnp.asarray(ws), ll_max,
        interpret=True, compute_dtype="i8", csub=csub, pack_idx=True,
        pack_window=pack_window, unroll=unroll))
    t = [torch.from_numpy(a) for a in (tiles_i8.view(np.uint8), scale, q,
                                       wr, wg, ws)]
    step = csub * SUB // pack_window
    before = pack_epilogue.launches
    if unroll > 1:
        t_out = grouped_scorer_item.score_grouped_i8_item(
            t[0], t[1], t[2], t[3], t[4], csub, t[5], ll_max,
            pack_window).numpy()
        assert t_out.shape == j_out.shape == (len(wr), M, step)
        np.testing.assert_array_equal(t_out, j_out)
    else:
        t_out = grouped_scorer.score_grouped_i8(
            *t, ll_max, csub, pack_window).numpy()
        assert t_out.shape == j_out.shape == (plan.G_cap, M,
                                              ll_max // pack_window)
        np.testing.assert_array_equal(covered(t_out, wg, ws, step),
                                      covered(j_out, wg, ws, step))
    assert t_out.dtype == np.int32
    assert pack_epilogue.launches == before  # CPU: the plain version
    # what the packed values say: the window's best unpacked score and its
    # row inside the group
    if unroll == 1:
        plain = grouped_scorer.score_grouped_i8(*t, ll_max, csub).numpy()
        val, off = pack_epilogue.unpack(torch.from_numpy(
            covered(t_out, wg, ws, step)), ll_max)
        rows = covered(plain, wg, ws, csub * SUB).reshape(
            len(wr), M, pack_window, step)
        best = rows.max(axis=2)
        mask = pack_epilogue.idx_mask(ll_max)
        cleared = (best.view(np.int32) & ~mask).view(np.float32)
        np.testing.assert_array_equal(val.numpy()[:-2], cleared[:-2])
        assert (off.numpy() // (csub * SUB) == ws[:, None, None]).all()


@pytest.mark.parametrize("csub,pack_window", [(1, 1), (2, 2)])
def test_k5_on_bf16_scorer_matches_pallas(setup, csub, pack_window):
    import jax.numpy as jnp
    from seismic_tpu.ops.pallas_grouped import score_grouped_pallas

    M = 8
    plan, wr, wg, ws, tiles_i8, scale3d, scale, ll_max = _pallas_inputs(
        setup, csub, M)
    V, R = tiles_i8.shape[1], csub * SUB
    rng = np.random.default_rng(17 + csub)
    q = (rng.random((plan.G_cap, M, V)) * 3
         * (rng.random((plan.G_cap, M, V)) < 0.1)).astype(np.float32)
    qsum = (128.0 * q.sum(-1)).astype(np.float32)
    j_out = np.asarray(score_grouped_pallas(
        jnp.asarray(tiles_i8), jnp.asarray(scale3d), jnp.asarray(q),
        jnp.asarray(wr), jnp.asarray(wg), jnp.asarray(ws), ll_max,
        interpret=True, compute_dtype="bf16", csub=csub, pack_idx=True,
        pack_window=pack_window,
        qsum=jnp.broadcast_to(jnp.asarray(qsum)[..., None],
                              (plan.G_cap, M, R))))
    t_out = grouped_scorer_f.score_grouped_f(
        torch.from_numpy(tiles_i8.view(np.uint8)), torch.from_numpy(scale),
        torch.from_numpy(q), torch.from_numpy(qsum), torch.from_numpy(wr),
        torch.from_numpy(wg), torch.from_numpy(ws), ll_max, csub, "bf16",
        pack_window)
    step = R // pack_window
    tv, to = pack_epilogue.unpack(torch.from_numpy(
        covered(t_out.numpy(), wg, ws, step)), ll_max)
    jv, jo = pack_epilogue.unpack(torch.from_numpy(
        covered(j_out, wg, ws, step)), ll_max)
    tv, to, jv, jo = (x.numpy() for x in (tv, to, jv, jo))
    rows = wr[:, None] * R + np.arange(R)
    # K6's tolerance, plus the index bits the pack clears
    tol = (1e-5 * np.abs(qsum[wg])[:, :, None]
           * scale[rows].reshape(len(wr), 1, pack_window, step).max(2)
           + np.abs(jv) * (2.0 ** (pack_epilogue.idx_bits(ll_max) - 23)
                           + 1e-5))
    assert (np.abs(tv - jv) <= tol).all()
    # where one row leads its window clearly, both name that row
    clear = np.abs(tv - jv) == 0
    assert clear.mean() > 0.5 and (to[clear] == jo[clear]).mean() > 0.99


POOL = dict(k=K, score_cut=64, pool=128, rescore=48)


@pytest.mark.parametrize("name,csub,M,kw", [
    ("window_bf16", 1, 8, dict(POOL, pool_mode="window")),
    ("window_i8_csub2", 2, 8, dict(POOL, pool_mode="window",
                                   compute_dtype="i8", pool_window=4)),
    ("stride_i8", 1, 8, dict(POOL, pool_mode="stride", compute_dtype="i8")),
    ("stride_i8_csub2_rk2", 2, 8, dict(POOL, pool_mode="stride",
                                       compute_dtype="i8", pool_stride=8)),
    ("stride_i8_item_csub2", 2, 16, dict(POOL, pool_mode="stride",
                                         compute_dtype="i8",
                                         kernel_unroll=2,
                                         pool_select="approx")),
    ("stride_f32_csub2", 2, 8, dict(POOL, pool_mode="stride",
                                    compute_dtype="f32", pool_stride=4)),
    ("slot_bf16", 1, 8, dict(POOL, pool_mode="slot")),
    ("slot_i8_csub2", 2, 8, dict(POOL, pool_mode="slot",
                                 compute_dtype="i8")),
    ("seg_i8", 1, 8, dict(POOL, pool=32, pool_mode="seg",
                          compute_dtype="i8", pool_seg_width=16)),
    ("seg_falls_through", 1, 8, dict(POOL, pool_mode="seg",
                                     compute_dtype="i8",
                                     pool_seg_width=128)),
    ("approx_i8_unroll2", 2, 8, dict(POOL, pool_mode="approx",
                                     compute_dtype="i8", kernel_unroll=2)),
    ("stride_no_rescore", 2, 8, dict(k=K, pool=128, pool_mode="stride",
                                     compute_dtype="i8")),
])
def test_pool_modes_match_jax(setup, indexes, name, csub, M, kw):
    assert_gate(*both(indexes, setup, csub, M, **kw))


def test_seg_pool_equals_exact_pool(setup, indexes):
    """The two-level segment pool returns the exact pool's results, ids
    position by position (tests/test_grouped.py:492-510)."""
    _, _, tdev, tctx = indexes[1]
    q_comps, q_vals = setup[2:]
    base = tgrouped.GroupedParams(k=K, score_cut=64, pool=32, rescore=32,
                                  compute_dtype="i8", pool_mode="exact")
    s_e, i_e = tgrouped.search_grouped(tdev, tctx, q_comps, q_vals, base)
    for segw in (16, 32):
        s_s, i_s = tgrouped.search_grouped(
            tdev, tctx, q_comps, q_vals,
            dataclasses.replace(base, pool_mode="seg", pool_seg_width=segw))
        np.testing.assert_array_equal(i_s, i_e)
        np.testing.assert_allclose(s_s, s_e, rtol=1e-6)


def test_check_pack_window():
    assert pack_epilogue.check_pack_window(0, 256) == 256
    assert pack_epilogue.check_pack_window(2, 256) == 128
    with pytest.raises(ValueError, match="128-multiple"):
        pack_epilogue.check_pack_window(2, 128)
    assert pack_epilogue.idx_bits(512) == 9 and pack_epilogue.idx_bits(1) == 1
