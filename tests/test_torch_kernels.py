"""seismic_tpu_torch kernels K1-K3: each plain PyTorch version against the
JAX package's Pallas kernel run in interpret mode (as the JAX package runs
it off the TPU), on the same inputs made with numpy from a seed; the
wrappers' CPU contract; and, on a machine with an NVIDIA card only, each
CUDA kernel against its plain version.

Tolerances: K1 is exact (a vocab slot matches at most one term, so the f32
sums are exact, and the quantize is the same f32 ops); K2's int dots are
exact and its f32 output is held to rtol 1e-6; K3 to rtol 1e-5 (the sum
over the row is taken in another order)."""

import dataclasses

import numpy as np
import pytest
import torch

from seismic_tpu_torch import from_jax_arrays
from seismic_tpu_torch.data.sparse import PAD_COMPONENT, pad_queries
from seismic_tpu_torch.ops import grouped_scorer, qloc, rescore
from seismic_tpu_torch.ops.tiles_prep import SUB, ll_pad_for
from seismic_tpu_torch.search.grouped import _top_k
from seismic_tpu_torch.search.planner import (
    PlannerContext,
    plan_grouped_numpy,
)
from tests.conftest import make_random_dataset, make_random_queries

QC, SC, M = 10, 64, 8


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
    q_comps, q_vals = pad_queries(qc, qv, 128)
    plan = plan_grouped_numpy(q_comps, q_vals,
                              PlannerContext.from_arrays(ta), QC)
    qvt = torch.from_numpy(np.where(q_comps != PAD_COMPONENT, q_vals, 0.0))
    top_v, top_p = _top_k(qvt, SC)
    top_c = torch.gather(torch.from_numpy(q_comps), 1, top_p)
    return ja, ta, plan, top_c.contiguous(), top_v.contiguous()


def _jax_qloc_i8(vocab16, pair_list, top_c, top_v):
    """The JAX route's projection + quantize (grouped.py:742-771)."""
    import jax
    import jax.numpy as jnp
    from seismic_tpu.ops.pallas_qloc import LANES, project_qloc_pallas

    B = top_c.shape[0]
    P = B * QC
    P_cap = -(-P // LANES) * LANES

    @jax.jit
    def run(vocab16, pair_list, top_c, top_v):
        vocabT = vocab16[pair_list].T
        qcT = jnp.broadcast_to(top_c[:, None, :], (B, QC, SC)).reshape(
            P, SC).T
        qvT = jnp.broadcast_to(top_v[:, None, :], (B, QC, SC)).reshape(
            P, SC).T
        vocabT = jnp.pad(vocabT, ((0, 0), (0, P_cap - P)))
        qcT = jnp.pad(qcT, ((0, 0), (0, P_cap - P)),
                      constant_values=PAD_COMPONENT)
        qvT = jnp.pad(qvT, ((0, 0), (0, P_cap - P)))
        qlocT = project_qloc_pallas(vocabT, qcT, qvT, SC, interpret=True)
        amaxT = jnp.max(jnp.abs(qlocT), axis=0, keepdims=True)
        qscaleT = jnp.maximum(amaxT, 1e-20) / 127.0
        q_i8 = jnp.round(qlocT / qscaleT).astype(jnp.int8).T[:P]
        return q_i8, qscaleT[0, :P]

    out = run(jnp.asarray(vocab16), jnp.asarray(pair_list),
              jnp.asarray(top_c), jnp.asarray(top_v))
    return np.asarray(out[0]), np.asarray(out[1])


def test_k1_qloc_quantize_matches_jax(setup):
    ja, ta, plan, top_c, top_v = setup
    vocab16 = ta.list_vocab.astype(np.int16)  # -1 padded (dim < 32767)
    pair_list = plan.pair_list.reshape(-1).astype(np.int32)
    j_i8, j_scale = _jax_qloc_i8(vocab16, pair_list, top_c.numpy(),
                                 top_v.numpy())
    before = qloc.launches
    t_i8, t_scale = qloc.project_qloc_quantize(
        torch.from_numpy(vocab16), torch.from_numpy(pair_list), top_c,
        top_v, QC)
    assert qloc.launches == before  # CPU tensors: the plain version
    assert t_i8.dtype == torch.int8 and t_i8.shape == j_i8.shape
    np.testing.assert_array_equal(t_i8.numpy(), j_i8)
    np.testing.assert_array_equal(t_scale.numpy(), j_scale)
    assert (j_i8 != 0).any()  # the projection is not trivially empty


def test_k2_grouped_i8_matches_jax(setup):
    import jax.numpy as jnp
    from seismic_tpu.ops.pallas_grouped import _score_grouped_i8
    from seismic_tpu.ops_pallas_prep import prepare_pallas_tiles

    ja, ta, plan, _, _ = setup
    tiles_i8, scale3d, _, _ = prepare_pallas_tiles(ja, 1)
    V = tiles_i8.shape[1]
    ll_max = ll_pad_for(ja.max_list_len, 1)
    rng = np.random.default_rng(7)
    q = rng.integers(-127, 128, size=(plan.G_cap, M, V)).astype(np.int8)
    # the real work items plus a few padding items (the dump group)
    nw = plan.W + 4
    wr, wg, ws = (plan.work_region[:nw], plan.work_g[:nw],
                  plan.work_s[:nw])
    j_out = np.asarray(_score_grouped_i8(
        jnp.asarray(tiles_i8), jnp.asarray(scale3d), jnp.asarray(q),
        jnp.asarray(wr), jnp.asarray(wg), jnp.asarray(ws), ll_max,
        interpret=True))
    tiles = torch.from_numpy(tiles_i8.view(np.uint8))
    scale = torch.from_numpy(np.ascontiguousarray(
        scale3d[:, 0, :]).reshape(-1))
    args = (tiles, scale, torch.from_numpy(q), torch.from_numpy(wr),
            torch.from_numpy(wg), torch.from_numpy(ws))
    before = grouped_scorer.launches
    t_out = grouped_scorer.score_grouped_i8(*args, ll_max).numpy()
    assert grouped_scorer.launches == before
    # exact int32 dots against a numpy int64 product
    dots = grouped_scorer.grouped_dots_plain(
        tiles, torch.from_numpy(q), args[3], args[4]).numpy()
    for w in range(0, plan.W, max(1, plan.W // 16)):
        t = tiles_i8.view(np.uint8)[wr[w] * SUB:(wr[w] + 1) * SUB]
        ref = q[wg[w]].astype(np.int64) @ t.astype(np.int64).T
        np.testing.assert_array_equal(dots[w], ref)
    # f32 output on every block a real work item covers
    for w in range(plan.W):
        g, s = wg[w], ws[w]
        blk = (slice(g, g + 1), slice(None), slice(s * SUB, (s + 1) * SUB))
        np.testing.assert_allclose(t_out[blk], j_out[blk], rtol=1e-6,
                                   atol=0)


def test_k3_rescore_matches_jax(setup):
    import jax.numpy as jnp
    from seismic_tpu.ops.pallas_rescore import score_docs_rowmajor_pallas

    ja, ta, _, top_c, top_v = setup
    index = ta.to_device("cpu")
    B, R = top_c.shape[0], 48
    rng = np.random.default_rng(3)
    ids = rng.integers(0, ta.n_docs, size=(B, R)).astype(np.int32)
    ids[0, :3] = [ta.n_docs, -1, ta.n_docs - 1]  # clamped like the JAX path
    fused = index.fwd_fused.numpy()
    W = fused.shape[1] // 2
    rows = fused[np.clip(ids, 0, ta.n_docs - 1)]
    comps = rows[..., :W]
    vals = np.where(comps != PAD_COMPONENT,
                    rows[..., W:].view(np.float32), 0.0).astype(np.float32)
    j_out = np.asarray(score_docs_rowmajor_pallas(
        jnp.asarray(comps), jnp.asarray(vals),
        jnp.asarray(top_c.numpy().reshape(-1)),
        jnp.asarray(top_v.numpy().reshape(-1)), SC, interpret=True))
    before = rescore.launches
    t_out = rescore.score_docs_rowmajor(
        index.fwd_fused, torch.from_numpy(ids), top_c, top_v,
        ta.n_docs).numpy()
    assert rescore.launches == before
    assert (j_out > 0).mean() > 0.5
    np.testing.assert_allclose(t_out, j_out, rtol=1e-5, atol=0)
    # rescore_exact: the same scores whole and in column chunks
    ids_t = torch.from_numpy(ids)
    whole = rescore.rescore_exact(index, ids_t, top_c, top_v, SC)
    np.testing.assert_allclose(whole.numpy(), j_out, rtol=1e-5, atol=0)
    assert torch.equal(whole, rescore.rescore_exact(
        index, ids_t, top_c, top_v, SC, chunk_r=20))


@pytest.mark.parametrize("kernel", ["qloc", "grouped_scorer", "rescore"])
def test_wrappers_check_their_operands(kernel):
    """Wrong dtypes or shapes are refused before any launch."""
    i32 = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        if kernel == "qloc":
            qloc.project_qloc_quantize(
                torch.zeros((3, 256), dtype=torch.int64), i32,
                torch.zeros((2, 8), dtype=torch.int32),
                torch.zeros((2, 8)), 2)
        elif kernel == "grouped_scorer":
            grouped_scorer.score_grouped_i8(
                torch.zeros((256, 256), dtype=torch.int8),
                torch.zeros(256), torch.zeros((1, 8, 256), dtype=torch.int8),
                i32, i32, i32, 128)
        else:
            rescore.score_docs_rowmajor(
                torch.zeros((5, 8), dtype=torch.int32),
                torch.zeros((2, 3), dtype=torch.int64),
                torch.zeros((2, 8), dtype=torch.int32),
                torch.zeros((2, 8)), 5)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["qloc", "grouped_scorer", "rescore"])
def test_cuda_kernel_matches_plain(setup, kernel):
    """On the card: each CUDA kernel against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    ja, ta, plan, top_c, top_v = setup
    dev = torch.device("cuda")
    index = ta.to_device(dev)
    if kernel == "qloc":
        pl = torch.from_numpy(plan.pair_list.reshape(-1)).to(dev)
        args = (index.vocab16, pl, top_c.to(dev), top_v.to(dev), QC)
        k_i8, k_s = qloc.project_qloc_quantize(*args)
        p_i8, p_s = qloc.project_qloc_quantize_plain(*args)
        assert torch.equal(k_i8, p_i8) and torch.equal(k_s, p_s)
    elif kernel == "grouped_scorer":
        rng = np.random.default_rng(7)
        V = index.doc_tiles_aligned.shape[1]
        q = torch.from_numpy(rng.integers(
            -127, 128, size=(plan.G_cap, M, V)).astype(np.int8)).to(dev)
        work = [torch.from_numpy(a).to(dev) for a in
                (plan.work_region, plan.work_g, plan.work_s)]
        ll_max = ll_pad_for(ta.max_list_len, 1)
        args = (index.doc_tiles_aligned, index.tile_scale, q, *work, ll_max)
        k_out = grouped_scorer.score_grouped_i8(*args)
        p_out = grouped_scorer.score_grouped_i8_plain(*args)
        for w in range(plan.W):
            g, s = int(plan.work_g[w]), int(plan.work_s[w])
            blk = k_out[g, :, s * SUB:(s + 1) * SUB]
            torch.testing.assert_close(
                blk, p_out[g, :, s * SUB:(s + 1) * SUB], rtol=1e-6, atol=0)
    else:
        rng = np.random.default_rng(3)
        ids = torch.from_numpy(rng.integers(
            0, ta.n_docs, size=(top_c.shape[0], 48)).astype(np.int32)).to(dev)
        args = (index.fwd_fused, ids, top_c.to(dev), top_v.to(dev),
                ta.n_docs)
        torch.testing.assert_close(
            rescore.score_docs_rowmajor(*args),
            rescore.score_docs_rowmajor_plain(*args), rtol=1e-5, atol=0)
