"""seismic_tpu_torch's projection modes (K1's f32 output, K8 row-major, K9
residue-bucketed) and the residue layout, against the JAX package on the
same inputs made with numpy from a seed:

- the plain versions against `project_qloc_pallas`,
  `project_qloc_rowmajor` and `project_qloc_residue` run in interpret
  mode: bit-equal (a vocab slot matches at most one term, so the f32 sum
  has one nonzero addend), K8's int8 codes and scales included: the
  interpret-mode body folds its `/ 127.0` into the reciprocal multiply as
  XLA does outside a kernel;
- `residue_layout`, `residue_permute_arrays` (vocabulary, doc tiles and
  dense summaries) and `_residue_buckets` equal to JAX's exactly;
- `search_grouped` of the port against JAX's for `qloc_mode="rowmajor"`
  and for an index uploaded with `vocab_residue=8` (i8 and f32 scorer,
  bucket capacities 16 and 64, item-major scorer), under the repo's gate
  (bench.py:355-360)."""

import dataclasses

import numpy as np
import pytest
import torch

from seismic_tpu_torch import from_jax_arrays
from seismic_tpu_torch.data.sparse import PAD_COMPONENT
from seismic_tpu_torch.ops import qloc, qloc_residue, qloc_rowmajor
from seismic_tpu_torch.ops.tiles_prep import (
    residue_layout,
    residue_permute_arrays,
)
from seismic_tpu_torch.search import grouped as tgrouped
from seismic_tpu_torch.search.planner import PlannerContext
from tests.test_torch_grouped_f import (  # noqa: F401 - fixtures
    K,
    QC,
    assert_gate,
    both,
    indexes,
    setup,
)

R = 8


def _pairs(rng, B, n_lists, dim, V, SC, qc_pairs):
    """Random list vocabularies (int16, -1 padded), queries' top terms
    (value-sorted, PAD padded) and pairs."""
    vocab = np.full((n_lists, V), -1, np.int16)
    for li in range(n_lists):
        n = rng.integers(V // 4, V + 1)
        vocab[li, :n] = np.sort(rng.choice(dim, n, replace=False))
    qc = np.full((B, SC), PAD_COMPONENT, np.int32)
    qv = np.zeros((B, SC), np.float32)
    for b in range(B):
        n = rng.integers(SC // 2, SC + 1)
        qc[b, :n] = rng.choice(dim, n, replace=False)
        qv[b, :n] = -np.sort(-rng.random(n).astype(np.float32) * 3)
    pair_list = rng.integers(0, n_lists, B * qc_pairs).astype(np.int32)
    return vocab, qc, qv, pair_list


def _lane_major(qc, qv, QCP, fill):
    """[B, S] per-query terms -> the lane-major [S, P_cap] operands of the
    TPU kernels (pairs padded to 128 lanes)."""
    P = qc.shape[0] * QCP
    P_cap = -(-P // 128) * 128
    out = []
    for a, f in ((qc, fill), (qv, 0.0)):
        t = np.repeat(a, QCP, axis=0).T
        out.append(np.pad(t, ((0, 0), (0, P_cap - P)), constant_values=f))
    return out


@pytest.mark.parametrize("V,SC", [(128, 16), (256, 40)])
def test_k1_f32_and_k8_plain_match_pallas(V, SC):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from seismic_tpu.ops.pallas_qloc import (
        ROWP,
        project_qloc_pallas,
        project_qloc_rowmajor,
    )

    rng = np.random.default_rng(V)
    B, QCP = 24, 8
    vocab, qc, qv, pair_list = _pairs(rng, B, 50, 2048, V, SC, QCP)
    P = B * QCP
    assert P % ROWP == 0 and SC % 8 == 0
    # K1 without the quantize against the lane-major kernel
    qcT, qvT = _lane_major(qc, qv, QCP, PAD_COMPONENT)
    vocabT = np.pad(vocab[pair_list].T, ((0, 0), (0, qcT.shape[1] - P)))
    j_f32 = np.asarray(project_qloc_pallas(
        jnp.asarray(vocabT), jnp.asarray(qcT), jnp.asarray(qvT), SC,
        interpret=True)).T[:P]
    args = [torch.from_numpy(a) for a in (vocab, pair_list, qc, qv)]
    before = qloc.launches
    t_f32 = qloc.project_qloc_f32(*args, QCP).numpy()
    np.testing.assert_array_equal(t_f32, j_f32)
    assert (t_f32 != 0).any()
    # K8 against the row-major kernel: codes and scales bit for bit
    rows = vocab[pair_list]
    qcP, qvP = np.repeat(qc, QCP, axis=0), np.repeat(qv, QCP, axis=0)
    j_i8, j_sc = project_qloc_rowmajor(
        jnp.asarray(rows), jnp.asarray(qcP), jnp.asarray(qvP), SC,
        interpret=True)
    t_i8, t_sc = qloc_rowmajor.project_qloc_rowmajor(
        torch.from_numpy(rows), torch.from_numpy(qcP), torch.from_numpy(qvP))
    assert qloc.launches == before and qloc_rowmajor.launches == 0
    np.testing.assert_array_equal(t_i8.numpy(), np.asarray(j_i8))
    np.testing.assert_array_equal(t_sc.numpy(), np.asarray(j_sc)[:, 0])
    # and K1's own codes on the same pairs
    k1_i8, k1_sc = qloc.project_qloc_quantize(*args, QCP)
    assert torch.equal(k1_i8, t_i8) and torch.equal(k1_sc, t_sc)


@pytest.mark.parametrize("V,scb", [(128, 4), (256, 16), (512, 16)])
def test_k9_plain_and_buckets_match_pallas(V, scb):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from seismic_tpu.ops.pallas_qloc import project_qloc_residue
    from seismic_tpu.ops.pallas_tiles import residue_layout as j_layout
    from seismic_tpu.search.grouped import _residue_buckets as j_buckets

    assert residue_layout(V, R) == j_layout(V, R)
    rng = np.random.default_rng(V + scb)
    B, QCP, SC = 16, 8, 40
    vocab, qc, qv, pair_list = _pairs(rng, B, 40, 1024, V, SC, QCP)
    # residue-order each list's vocabulary as the upload does
    VRS, spill = residue_layout(V, R)
    ordered = np.full_like(vocab, -1)
    for li, row in enumerate(vocab):
        real = row[row >= 0]
        rest = []
        for r in range(R):
            mine = real[real % R == r]
            ordered[li, r * VRS:r * VRS + len(mine[:VRS])] = mine[:VRS]
            rest += mine[VRS:].tolist()
        ordered[li, R * VRS:R * VRS + len(rest[:spill])] = rest[:spill]
    j_qcb, j_qvb = j_buckets(jnp.asarray(qc), jnp.asarray(qv), R, scb)
    t_qcb, t_qvb = tgrouped._residue_buckets(
        torch.from_numpy(qc), torch.from_numpy(qv), R, scb)
    np.testing.assert_array_equal(t_qcb.numpy(), np.asarray(j_qcb))
    np.testing.assert_array_equal(t_qvb.numpy(), np.asarray(j_qvb))
    # small buckets overflow: the dropped terms live on in the plain list
    if scb == 4:
        assert (np.asarray(j_qcb) >= 0).sum() < (qc != PAD_COMPONENT).sum()
    P = B * QCP
    qcbT, qvbT = _lane_major(np.asarray(j_qcb), np.asarray(j_qvb), QCP, -2)
    qcT, qvT = _lane_major(qc, qv, QCP, -2)
    vocabT = np.pad(ordered[pair_list].T, ((0, 0), (0, qcT.shape[1] - P)))
    j_out = np.asarray(project_qloc_residue(
        jnp.asarray(vocabT), jnp.asarray(qcbT), jnp.asarray(qvbT),
        jnp.asarray(qcT), jnp.asarray(qvT), R, scb, SC,
        interpret=True)).T[:P]
    args = [torch.from_numpy(a) for a in (ordered, pair_list)] + [
        t_qcb, t_qvb, torch.from_numpy(qc), torch.from_numpy(qv)]
    t_out = qloc_residue.project_qloc_residue(*args, QCP, R, scb)
    assert qloc_residue.launches == 0  # CPU: the plain version
    np.testing.assert_array_equal(t_out.numpy(), j_out)
    assert (j_out != 0).any()
    # a term its bucket dropped matches in the spill slots only
    full = qloc.project_qloc_f32(args[0], args[1], args[4], args[5],
                                 QCP).numpy()
    lost = (full != 0) & (j_out == 0)
    assert not lost[:, R * VRS:].any()
    if scb == 4:
        assert lost[:, :R * VRS].any()
    # the quantized output is K1's quantize of the same projection
    q_i8, q_sc = qloc_residue.project_qloc_residue(*args, QCP, R, scb,
                                                   quantize=True)
    e_i8, e_sc = qloc.quantize_plain(t_out)
    assert torch.equal(q_i8, e_i8) and torch.equal(q_sc, e_sc)


def test_residue_permute_arrays_matches_jax(setup):
    from seismic_tpu.ops.pallas_tiles import (
        residue_permute_arrays as j_permute,
    )

    ja, ta = setup[:2]
    jp = j_permute(ja, R)
    tp = residue_permute_arrays(ta, R)
    assert tp.vocab_residue == R == jp.vocab_residue
    assert ta.vocab_residue == 0  # a copy: the source index is untouched
    for f in ("list_vocab", "doc_tiles", "dense_summary"):
        a, b = np.asarray(getattr(jp, f)), np.asarray(getattr(tp, f))
        np.testing.assert_array_equal(b, a, err_msg=f)
        assert a.dtype == b.dtype
        assert not np.array_equal(b, np.asarray(getattr(ta, f))), f
    # a residue-permuted JAX index carried across equals the port's own
    carried = from_jax_arrays(dict(
        {f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)},
        vocab_residue=jp.vocab_residue))
    assert carried.vocab_residue == R
    dev_c = carried.to_device("cpu", vocab_residue=R)  # no second permute
    dev_t = ta.to_device("cpu", vocab_residue=R)
    assert dev_t.vocab_residue == dev_c.vocab_residue == R
    for f in ("vocab16", "doc_tiles_aligned", "tile_scale", "dense_summary"):
        assert torch.equal(getattr(dev_c, f), getattr(dev_t, f)), f
    # group r of every list holds only terms of residue r
    VRS, _ = residue_layout(tp.list_vocab.shape[1], R)
    grp = tp.list_vocab[:, :R * VRS].reshape(-1, R, VRS)
    ok = (grp < 0) | (grp % R == np.arange(R)[None, :, None])
    assert ok.all()


@pytest.fixture(scope="module")
def residue_indexes(setup):
    from seismic_tpu.search.planner import PlannerContext as JCtx

    ja, ta = setup[:2]
    return {1: (ja.to_device(pallas_tiles=True, vocab_residue=R),
                JCtx.from_arrays(ja),
                ta.to_device("cpu", vocab_residue=R),
                PlannerContext.from_arrays(ta))}


BASE = dict(k=K, score_cut=64, pool=64, rescore=32, compute_dtype="i8",
            pool_mode="exact")


@pytest.mark.parametrize("name,kw", [
    ("rowmajor", dict(BASE, qloc_mode="rowmajor")),
    ("rowmajor_hier_item", dict(BASE, qloc_mode="rowmajor", rescore=48,
                                pool_mode="hier", pool_per_pair=16,
                                kernel_unroll=2)),
])
def test_rowmajor_matches_jax(setup, indexes, name, kw):
    s_t, i_t, s_j, i_j = both(indexes, setup, 1, **kw)
    assert_gate(s_t, i_t, s_j, i_j)
    # and the lane-major route of the port itself: the same results
    s_l, i_l = tgrouped.search_grouped(
        indexes[1][2], indexes[1][3], setup[2], setup[3],
        tgrouped.GroupedParams(**dict(kw, qloc_mode="pallas")), query_cut=QC)
    np.testing.assert_array_equal(i_t, i_l)
    np.testing.assert_array_equal(s_t, s_l)


@pytest.mark.parametrize("name,kw", [
    ("scb16", dict(BASE, residue_scb=16)),
    ("scb64", dict(BASE, residue_scb=64)),
    ("scb16_item", dict(BASE, residue_scb=16, kernel_unroll=2)),
    ("f32_ovf", dict(k=K, compute_dtype="f32", residue_scb=16)),
])
def test_vocab_residue_matches_jax(setup, residue_indexes, name, kw):
    assert_gate(*both(residue_indexes, setup, 1, **kw))


def test_rowmajor_refuses_residue(setup, residue_indexes):
    _, _, tdev, tctx = residue_indexes[1]
    with pytest.raises(ValueError, match="exclusive"):
        tgrouped.search_grouped(
            tdev, tctx, setup[2], setup[3],
            tgrouped.GroupedParams(**dict(BASE, qloc_mode="rowmajor")),
            query_cut=QC)
