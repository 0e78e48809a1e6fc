"""The plain versions at the shapes past the kernels' former caps, against
the JAX package on the CPU (its Pallas kernels in interpret mode, as its
own tests run them), on inputs made with numpy from a seed. The kernels
serve these shapes as chunks of their instances; on the card
`tests/test_torch_caps_cuda.py` holds each kernel to these plain
versions.

- The grouped scorers past 32 query slots and 4 subtiles an item: K2's
  and K4's plain versions (int8, unroll 1 and 8) against JAX's
  `score_grouped_pallas` at M 48 / 64 and csub 5 / 8, unpacked (1e-6
  relative, the int dots exact) and packed at pack_window csub and 2
  (bit-equal); K6's (bf16 and f32, centred) at M 64, csub 8 and at M 32,
  csub 2, V 1024 (past the f32 mode's one-chunk width, 768) to 1e-5 of
  the larger of score and centring term.
- K1 (f32 and quantized), K8, K9 and K3 at 320 padded query terms (past
  the former 256): bit-equal to JAX's chains, K3 to 1e-5 relative.
- One headline search (`plan_caps` + `search_grouped_derive`, K4 at M 64)
  against JAX's `search_grouped_derive_jit` at a cut: the repo's gate.
"""

import dataclasses

import numpy as np
import pytest
import torch

from seismic_tpu_torch.data.sparse import PAD_COMPONENT
from seismic_tpu_torch.ops import (
    grouped_scorer,
    grouped_scorer_f,
    grouped_scorer_item,
    qloc,
    qloc_residue,
    qloc_rowmajor,
    rescore,
)
from seismic_tpu_torch.ops.tiles_prep import SUB, residue_layout

PAD = int(PAD_COMPONENT)
N_REGIONS, W_REAL, W_PAD, G_CAP = 4, 6, 2, 3


@pytest.fixture(autouse=True)
def one_thread():
    """Each test on one torch thread: the plain versions' many small
    operations slow down sharply when six test workers each run a thread
    a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(M, csub, V, seed):
    """Tiles (region 0 all zero, the padding items'), scales, int8
    queries, f32 projections and their qsum; W_REAL real items over
    regions 1.. then W_PAD padding items on region 0."""
    rng = np.random.default_rng(seed)
    rows = csub * SUB
    tiles = rng.integers(0, 256, size=(N_REGIONS * rows, V), dtype=np.uint8)
    tiles[rng.random(tiles.shape) < 0.3] = 0
    tiles[:rows] = 0
    scale = rng.uniform(1e-3, 2.0, N_REGIONS * rows).astype(np.float32)
    q8 = rng.integers(-127, 128, size=(G_CAP, M, V)).astype(np.int8)
    qf = (rng.random((G_CAP, M, V)) * 3
          * (rng.random((G_CAP, M, V)) < 0.1)).astype(np.float32)
    qsum = (128.0 * qf.sum(-1)).astype(np.float32)
    wr = np.concatenate([rng.integers(1, N_REGIONS, W_REAL),
                         np.zeros(W_PAD)]).astype(np.int32)
    wg = np.concatenate([np.sort(rng.integers(0, G_CAP, W_REAL)),
                         np.zeros(W_PAD)]).astype(np.int32)
    ws = np.zeros_like(wg)
    for g in range(G_CAP):
        mine = np.flatnonzero(wg[:W_REAL] == g)
        ws[mine] = np.arange(len(mine))
    ll_max = rows * (int(ws.max()) + 1)
    return dict(tiles=tiles, scale=scale, q8=q8, qf=qf, qsum=qsum, wr=wr,
                wg=wg, ws=ws, ll_max=ll_max)


def _t(o, k):
    return torch.from_numpy(o[k])


def _blocks(out, o, step):
    out = out if torch.is_tensor(out) else torch.from_numpy(np.array(out))
    return torch.stack([out[int(g), :, int(s) * step:(int(s) + 1) * step]
                        for g, s in zip(o["wg"][:W_REAL], o["ws"][:W_REAL])])


def _jax_scale3d(scale, csub):
    n_super = scale.shape[0] // (csub * SUB)
    return np.broadcast_to(scale.reshape(n_super, 1, csub * SUB),
                           (n_super, 8, csub * SUB))


@pytest.mark.parametrize("M,csub,pw", [(48, 1, 0), (64, 2, 0), (64, 2, 2),
                                       (40, 5, 5), (8, 8, 8), (16, 8, 2)])
def test_int8_plain_matches_jax_past_the_caps(M, csub, pw):
    """K2's plain version == JAX's int8 kernel (unroll 1) on every block a
    real item covers, K4's == JAX's item-major kernel (unroll 8) on every
    item: unpacked 1e-6 relative, packed bit-equal."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from seismic_tpu.ops.pallas_grouped import score_grouped_pallas

    V = 128
    o = _operands(M, csub, V, seed=10 * M + csub + pw)
    jargs = (jnp.asarray(o["tiles"].view(np.int8)),
             jnp.asarray(_jax_scale3d(o["scale"], csub)),
             jnp.asarray(o["q8"]))
    kw = dict(interpret=True, compute_dtype="i8", csub=csub,
              pack_idx=bool(pw), pack_window=max(pw, 1))
    wr, wg, ws = (o[k] for k in ("wr", "wg", "ws"))
    j1 = np.asarray(score_grouped_pallas(
        *jargs, jnp.asarray(wr[:W_REAL]), jnp.asarray(wg[:W_REAL]),
        jnp.asarray(ws[:W_REAL]), o["ll_max"], **kw))
    t1 = grouped_scorer.score_grouped_i8(
        _t(o, "tiles"), _t(o, "scale"), _t(o, "q8"),
        _t(o, "wr")[:W_REAL], _t(o, "wg")[:W_REAL], _t(o, "ws")[:W_REAL],
        o["ll_max"], csub, pw)
    step = csub * SUB // max(pw, 1)
    a, b = _blocks(t1, o, step), _blocks(j1, o, step)
    j8 = np.asarray(score_grouped_pallas(
        *jargs, jnp.asarray(wr), jnp.asarray(wg), jnp.asarray(ws),
        o["ll_max"], unroll=8, **kw))
    t8 = grouped_scorer_item.score_grouped_i8_item(
        _t(o, "tiles"), _t(o, "scale"), _t(o, "q8"), _t(o, "wr"),
        _t(o, "wg"), csub, _t(o, "ws") if pw else None, o["ll_max"], pw)
    assert tuple(t8.shape) == j8.shape == (W_REAL + W_PAD, M, step)
    if pw:
        assert torch.equal(a, b)
        np.testing.assert_array_equal(t8.numpy(), j8)
        return
    torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    np.testing.assert_allclose(t8.numpy(), j8, rtol=1e-6, atol=0)
    assert b.abs().max() > 0 and not t8[W_REAL:].any()


@pytest.mark.parametrize("dt,M,csub,V", [("f32", 32, 2, 1024),
                                         ("bf16", 64, 2, 128),
                                         ("bf16", 16, 8, 128)])
def test_k6_plain_matches_jax_past_the_caps(dt, M, csub, V):
    """K6's plain version, centred, == JAX's kernel in interpret mode to
    1e-5 of the larger of score and centring term."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from seismic_tpu.ops.pallas_grouped import score_grouped_pallas

    o = _operands(M, csub, V, seed=300 + M + csub + V)
    wr, wg, ws = (o[k][:W_REAL] for k in ("wr", "wg", "ws"))
    R = csub * SUB
    qsum_l = np.broadcast_to(o["qsum"][:, :, None], (G_CAP, M, R))
    j = np.asarray(score_grouped_pallas(
        jnp.asarray(o["tiles"].view(np.int8)),
        jnp.asarray(_jax_scale3d(o["scale"], csub)), jnp.asarray(o["qf"]),
        jnp.asarray(wr), jnp.asarray(wg), jnp.asarray(ws), o["ll_max"],
        interpret=True, compute_dtype=dt, qsum=jnp.asarray(qsum_l),
        csub=csub))
    out = grouped_scorer_f.score_grouped_f(
        _t(o, "tiles"), _t(o, "scale"), _t(o, "qf"), _t(o, "qsum"),
        _t(o, "wr")[:W_REAL], _t(o, "wg")[:W_REAL], _t(o, "ws")[:W_REAL],
        o["ll_max"], csub, dt)
    p, k = _blocks(j, o, R), _blocks(out, o, R)
    rows = wr[:, None] * R + np.arange(R)
    mag = torch.from_numpy(np.abs(o["qsum"][wg])[:, :, None]
                           * o["scale"][rows][:, None, :])
    assert ((k - p).abs() <= 1e-5 * torch.maximum(mag, p.abs())).all()
    assert p.abs().max() > 0


# ---- K1, K8, K9 and K3 at 320 padded terms ----

SC, QCP, V_Q, N_LISTS = 320, 2, 128, 5


def _term_operands(seed):
    """vocab int16 [N_LISTS, V_Q] (-1 padded), pair_list [B * QCP], and
    B rows of SC terms (a repeated id, PAD between terms, PAD carrying
    0), sorted by |value| as the route's top terms are."""
    rng = np.random.default_rng(seed)
    B = 3
    pool = rng.choice(np.arange(1, 3000), 2000, replace=False)
    vocab = np.full((N_LISTS, V_Q), -1, np.int16)
    for li in range(N_LISTS):
        m = int(rng.integers(V_Q // 2, V_Q + 1))
        vocab[li, :m] = np.sort(rng.choice(pool[:600], m, replace=False))
    qc = np.full((B, SC), PAD, np.int32)
    qv = np.zeros((B, SC), np.float32)
    for b in range(B):
        t = rng.choice(pool, SC - 4, replace=False)
        qc[b, :SC - 4] = t
        qv[b, :SC - 4] = rng.uniform(-3.0, 3.0, SC - 4)
        qc[b, SC - 4] = t[5]  # a repeat
        qv[b, SC - 4] = 0.25
    qc[:, 7::61] = PAD
    qv[qc == PAD] = 0.0
    order = np.argsort(-np.abs(qv), axis=1, kind="stable")
    qc = np.take_along_axis(qc, order, 1)
    qv = np.take_along_axis(qv, order, 1)
    pair_list = rng.integers(0, N_LISTS, B * QCP).astype(np.int32)
    return vocab, pair_list, qc, qv


@pytest.mark.parametrize("kernel", ["k1", "k8", "k9", "k3"])
def test_term_kernels_plain_match_jax_at_320_terms(kernel):
    """K1's plain version (f32 and quantized) and K8's == JAX's lane- and
    row-major projections with the route's quantize, K9's == JAX's
    residue projection (R 8, buckets of 48), bit for bit; K3's == JAX's
    `score_docs_rowmajor_pallas` to 1e-5 relative; all at 320 padded
    terms, past the 256 the kernels once took."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from seismic_tpu.ops.pallas_qloc import (
        LANES,
        ROWP,
        project_qloc_pallas,
        project_qloc_residue,
        project_qloc_rowmajor,
    )
    from seismic_tpu.ops.pallas_rescore import score_docs_rowmajor_pallas

    vocab, pair_list, qc, qv = _term_operands(SC + len(kernel))
    B = qc.shape[0]
    P = B * QCP
    t = [torch.from_numpy(x) for x in (vocab, pair_list, qc, qv)]
    qcP, qvP = np.repeat(qc, QCP, 0), np.repeat(qv, QCP, 0)
    rows = vocab[pair_list]
    P_cap = -(-P // LANES) * LANES

    def lanes(x, fill):
        return jnp.pad(jnp.asarray(x).T, ((0, 0), (0, P_cap - P)),
                       constant_values=fill)

    if kernel == "k1":
        jq = np.asarray(project_qloc_pallas(
            lanes(rows, -1), lanes(qcP, PAD), lanes(qvP, 0.0), SC,
            interpret=True)).T[:P]
        np.testing.assert_array_equal(
            qloc.project_qloc_f32(*t, QCP).numpy(), jq)
        amax = np.max(np.abs(jq), axis=1, keepdims=True)
        scale = np.maximum(amax, np.float32(1e-20)) * np.float32(1 / 127)
        q8, sc = qloc.project_qloc_quantize(*t, QCP)
        np.testing.assert_array_equal(
            q8.numpy(), np.round(jq / scale).astype(np.int8))
        np.testing.assert_array_equal(sc.numpy(), scale[:, 0])
        assert (jq != 0).any()
    elif kernel == "k8":
        R_cap = -(-P // ROWP) * ROWP
        jq8, jsc = project_qloc_rowmajor(
            jnp.pad(jnp.asarray(rows), ((0, R_cap - P), (0, 0)),
                    constant_values=-1),
            jnp.pad(jnp.asarray(qcP), ((0, R_cap - P), (0, 0)),
                    constant_values=PAD),
            jnp.pad(jnp.asarray(qvP), ((0, R_cap - P), (0, 0))), SC,
            interpret=True)
        k8, s8 = qloc_rowmajor.project_qloc_rowmajor(
            torch.from_numpy(np.ascontiguousarray(rows)),
            torch.from_numpy(qcP), torch.from_numpy(qvP))
        np.testing.assert_array_equal(k8.numpy(), np.asarray(jq8)[:P])
        np.testing.assert_array_equal(s8.numpy(), np.asarray(jsc)[:P, 0])
    elif kernel == "k9":
        from seismic_tpu_torch.search.grouped import _residue_buckets

        R, scb = 8, 48
        VRS, spill = residue_layout(V_Q, R)
        res = np.full_like(vocab, -1)
        for li, row in enumerate(vocab):
            real = row[row >= 0]
            rest = []
            for r in range(R):
                mine = real[real % R == r]
                res[li, r * VRS:r * VRS + len(mine[:VRS])] = mine[:VRS]
                rest += mine[VRS:].tolist()
            res[li, R * VRS:R * VRS + len(rest[:spill])] = rest[:spill]
        qcb, qvb = _residue_buckets(t[2], t[3], R, scb)
        j9 = np.asarray(project_qloc_residue(
            lanes(res[pair_list], -1),
            lanes(np.repeat(qcb.numpy(), QCP, 0), -2),
            lanes(np.repeat(qvb.numpy(), QCP, 0), 0.0), lanes(qcP, PAD),
            lanes(qvP, 0.0), R, scb, SC, interpret=True)).T[:P]
        k9 = qloc_residue.project_qloc_residue(
            torch.from_numpy(res), t[1], qcb, qvb, t[2], t[3], QCP, R, scb)
        np.testing.assert_array_equal(k9.numpy(), j9)
        assert (j9 != 0).any()
    else:
        rng = np.random.default_rng(5)
        n_docs, W, R_ = 12, 128, 8
        comps = np.full((n_docs, W), PAD, np.int32)
        for d in range(n_docs):
            m = int(rng.integers(1, W + 1))
            comps[d, :m] = np.sort(rng.choice(
                np.concatenate([qc[0, :40], np.arange(3000, 3400)]), m,
                replace=False))
        vals = np.where(comps != PAD, rng.uniform(0.1, 2.0, comps.shape),
                        0.0).astype(np.float32)
        doc = rng.integers(0, n_docs, (B, R_)).astype(np.int32)
        jd = np.asarray(score_docs_rowmajor_pallas(
            jnp.asarray(comps[doc]), jnp.asarray(vals[doc]),
            jnp.asarray(qc.reshape(-1)), jnp.asarray(qv.reshape(-1)), SC,
            interpret=True))
        fused = torch.from_numpy(np.concatenate(
            [comps, vals.view(np.int32)], axis=1))
        k3 = rescore.score_docs_rowmajor(fused, torch.from_numpy(doc), t[2],
                                         t[3], n_docs)
        np.testing.assert_allclose(k3.numpy(), jd, rtol=1e-5, atol=1e-6)
        assert (jd != 0).any()


def test_headline_search_at_m64_matches_jax():
    """One headline search (`plan_caps` + `search_grouped_derive`: K1, K4
    at M 64 in two chunks of 32 slots, the hier pool, K3) against JAX's
    `search_grouped_derive_jit` at a cut: >= 98% of queries with equal
    top-10 id sets, scores < 1e-3 relative (bench.py:355-360)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from seismic_tpu import Configuration, TpuLayout
    from seismic_tpu.build.builder import build_index
    from seismic_tpu.ops.pallas_tiles import narrow_vocab as j_narrow
    from seismic_tpu.search.grouped import GroupedParams as JParams
    from seismic_tpu.search.grouped import search_grouped_derive_jit
    from seismic_tpu.search.planner import PlannerContext as JCtx

    from seismic_tpu_torch import from_jax_arrays
    from seismic_tpu_torch.data.sparse import pad_queries
    from seismic_tpu_torch.ops.tiles_prep import narrow_vocab
    from seismic_tpu_torch.search import grouped as tgrouped
    from seismic_tpu_torch.search.planner import PlannerContext
    from tests.conftest import make_random_dataset, make_random_queries

    K, QC, V0, CSUB, M = 10, 13, 128, 2, 64
    ds = make_random_dataset(np.random.default_rng(2), n_docs=300, dim=400,
                             min_nnz=15, max_nnz=40, seed=43)
    cfg = Configuration(layout=TpuLayout(max_block_len=16,
                                         summary_vocab_cap=256,
                                         tile_overflow=16))
    full = build_index(ds, cfg, value_dtype="f32")
    ta = narrow_vocab(from_jax_arrays(
        {f.name: getattr(full, f.name) for f in dataclasses.fields(full)}),
        V0)
    ja = j_narrow(full, V0)
    qc, qv = make_random_queries(np.random.default_rng(4), n_queries=40,
                                 dim=400, min_nnz=8, max_nnz=30)
    q_comps, q_vals = pad_queries(qc, qv, 64)
    ctx = PlannerContext.from_arrays(ta, csub=CSUB)
    jctx = JCtx.from_arrays(ja, csub=CSUB)
    G_cap, W_cap = tgrouped.plan_caps(q_comps, q_vals, ctx, QC, M=M)

    def params(cls):  # bench.py's headline recipe
        return cls(k=K, score_cut=64, pool=96, rescore=64,
                   compute_dtype="i8", pool_mode="hier", pool_per_pair=16,
                   kernel_unroll=8)

    s_j, i_j = search_grouped_derive_jit(
        ja.to_device(pallas_tiles=True, tile_csub=CSUB),
        jnp.asarray(q_comps, jnp.int32), jnp.asarray(q_vals, jnp.float32),
        params(JParams), QC, M, G_cap, W_cap, jctx.zero_region)
    s_j, i_j = np.asarray(s_j), np.asarray(i_j)
    i_j = np.where(np.isfinite(s_j), i_j, -1)
    s_t, i_t = tgrouped.search_grouped_derive(
        ta.to_device("cpu", tile_csub=CSUB), torch.from_numpy(q_comps),
        torch.from_numpy(q_vals), params(tgrouped.GroupedParams), QC, M,
        G_cap, W_cap, ctx.zero_region)
    s_t, i_t = s_t.numpy(), i_t.numpy()
    ids_match = np.mean([
        set(map(int, a[a >= 0])) == set(map(int, b[b >= 0]))
        for a, b in zip(i_t, i_j)])
    assert ids_match >= 0.98, ids_match
    fin = np.isfinite(s_j)
    assert (np.isfinite(s_t) == fin).all() and fin.mean() > 0.9
    srel = np.max(np.abs(s_t[fin] - s_j[fin])
                  / np.maximum(np.abs(s_j[fin]), 1e-6))
    assert srel < 1e-3, srel
