"""K7 scored once per list group and K3 as a term lookup: the cases their
designs have to get right.

On the CPU: `group_pairs_by_region`, the grouping that K7's wrapper runs
on the card before its launch, on a run of pairs longer than a group,
lists with one pair, every pair on list 0 (where the engine puts its
unselected slots), a mixed batch and one whose pairs on a list differ in
length; and K3's plain version against the JAX package's Pallas kernel
(interpret mode, as the JAX package runs it off the TPU) on edge rows made
with numpy from a seed: a repeated query id, a -0.0 value, a real term
valued 0, an all-PAD forward row, a query with no real term, rows that
end at and across the kernel's 64-id chunks, and out-of-range ids that
clamp. Tolerance 1e-5 relative (the sum over the row is taken in another
order; all products but the -0.0 one are positive).

On a machine with an NVIDIA card only (`cuda` marker; the card is looked
for inside each test): the K7 kernel against its plain version on those
groupings at V {256, 512, 1024} (one with more groups than the card runs
blocks, one with an empty list, one whose pairs on a list differ in
length), with the pairs' own lengths and with every
row scored (1e-5 relative; u8 codes times non-negative projections); the
K3 kernel against its plain version on the edge rows at W 256, 96 (rows
cut) and 75 (odd: 4-byte loads). K3's u8 form (int16 ids, u8 codes,
per-doc min and step) takes the same rows: its plain version against the
JAX kernel on the rows decoded as the JAX package decodes them, and on
the card its kernel against its plain version at W 256, 96, 94 and 75
(the last two single loads). K1's cases after its term table moved to
`csrc/term_table.cuh` are in `tests/test_torch_k1_k4_redesign.py`. This
file imports neither JAX nor the test configuration at module level, so on
the card it also runs alone:

    python -m pytest --noconftest -q -m cuda tests/test_torch_k3_k7_redesign.py
"""

import numpy as np
import pytest
import torch

from seismic_tpu_torch.data.sparse import PAD_COMPONENT
from seismic_tpu_torch.ops import rescore, tiles_scorer
from seismic_tpu_torch.ops.tiles_prep import SUB

PAD = int(PAD_COMPONENT)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


# ---- K7: pairs and their grouping ----
LL_PAD = 4 * SUB  # four subtiles a pair, as at the engine cell
N_REGIONS = 12    # lists, each readable LL_PAD rows deep
GROUPINGS = ("run_longer_than_m", "one_pair_lists", "all_on_list_0",
             "mixed", "ragged_lengths", "many_groups")


def _pairs(case):
    """region_start int32 [P] (subtiles; list l starts at 4 l) and pair_len
    int32 [P] of one grouping case, pairs in no particular order."""
    rng = np.random.default_rng(GROUPINGS.index(case) + 40)
    list_len = rng.integers(1, LL_PAD + 1, size=N_REGIONS)
    list_len[1] = LL_PAD  # a list that fills all four subtiles
    list_len[2] = 0       # an empty list: its groups have no subtile
    if case == "run_longer_than_m":
        lists = np.concatenate([np.full(40, 3), rng.integers(0, 12, 10)])
    elif case == "one_pair_lists":
        lists = np.arange(N_REGIONS)
    elif case == "all_on_list_0":
        lists = np.zeros(37, np.int64)
    elif case == "many_groups":  # more groups than the card runs blocks
        lists = rng.integers(0, 12, 20_000)
    else:  # mixed lists, one run of 13 pairs (a group of 9-16)
        lists = np.concatenate([rng.integers(0, 12, 47), np.full(13, 5)])
    lists = rng.permutation(lists)
    pair_len = list_len[lists]
    if case == "ragged_lengths":
        pair_len = rng.integers(1, LL_PAD + 1, size=lists.size)
    return ((4 * lists).astype(np.int32), pair_len.astype(np.int32))


@pytest.mark.parametrize("case", GROUPINGS)
def test_group_pairs_by_region(case):
    """Every pair in exactly one group; a group holds at most M pairs, all
    of one region, in their input order; a run is cut only every M pairs;
    count is the number of groups, and `first` is P past the last."""
    M = tiles_scorer.GROUP_PAIRS
    rs_np, _ = _pairs(case)
    P = rs_np.size
    g = tiles_scorer.group_pairs_by_region(torch.from_numpy(rs_np), M)
    assert g.order.dtype == g.first.dtype == g.count.dtype == torch.int64
    assert g.region.dtype == torch.int32
    order, region, first = (t.numpy() for t in g[:3])
    n = int(g.count.item())
    assert first.shape == (P + 1,) and order.shape == region.shape == (P,)
    assert np.array_equal(np.sort(order), np.arange(P))
    np.testing.assert_array_equal(region, rs_np[order])
    assert first[0] == 0 and (first[n:] == P).all()
    sizes = np.diff(first[:n + 1])
    assert (sizes >= 1).all() and (sizes <= M).all()
    runs = np.unique(rs_np, return_counts=True)[1]
    assert n == int(np.ceil(runs / M).sum())
    for gi in range(n):
        members = order[first[gi]:first[gi + 1]]
        assert (rs_np[members] == rs_np[members[0]]).all()
        assert (np.diff(members) > 0).all()  # stable
        if gi > 0 and region[first[gi - 1]] == region[first[gi]]:
            assert sizes[gi - 1] == M  # cut only where the group is full
    if case == "all_on_list_0":
        assert sizes.tolist() == [16, 16, 5]


def _k7_operands(case, V, dev):
    rs_np, len_np = _pairs(case)
    rng = np.random.default_rng(V)
    rows = (4 * N_REGIONS + 4) * SUB
    tiles = rng.integers(0, 256, size=(rows, V)).astype(np.uint8)
    scale = rng.uniform(0.5, 2.0, rows).astype(np.float32)
    qloc = (rng.gamma(2.0, 1.0, size=(rs_np.size, V))
            * (rng.random((rs_np.size, V)) < 0.1)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in
                 (tiles, scale, rs_np, qloc, len_np))


@pytest.mark.cuda
@pytest.mark.parametrize("V", [256, 512, 1024])
@pytest.mark.parametrize("case", GROUPINGS)
def test_cuda_k7_matches_plain(case, V):
    dev = _card()
    args = _k7_operands(case, V, dev)
    all_rows = args[:4] + (torch.full_like(args[4], LL_PAD),)
    for a in (args, all_rows):
        before = tiles_scorer.launches
        k = tiles_scorer.score_tiles(*a, LL_PAD)
        assert tiles_scorer.launches == before + 1
        torch.cuda.synchronize()
        torch.testing.assert_close(
            k, tiles_scorer.score_tiles_plain(*a, LL_PAD), rtol=1e-5,
            atol=0)


# ---- K3: edge rows ----
N_DOCS, W3, R3 = 10, 256, 16
# real entries of each forward row: doc 1 all PAD; docs 2-5 end at the
# kernel's 64-id chunk boundaries; doc 7 holds one entry
ROW_NNZ = (150, 0, 64, 128, 192, 256, 37, 1, 129, 200)
K3_CASES = ("repeated_id", "no_real_term", "mixed", "no_match")
REPEAT, ZERO_TERM, NEG_ZERO = 17, 23, 29  # ids every doc of >= 64 holds


def _k3_operands(W=W3):
    """fwd_fused int32 [N_DOCS, 2W], doc_ids int32 [B, R3] (out-of-range
    ids among them) and qc int32 / qv f32 [B, 48], one query a K3_CASES
    entry."""
    rng = np.random.default_rng(21)
    comps = np.full((N_DOCS, W), PAD, np.int32)
    vals = np.zeros((N_DOCS, W), np.float32)
    pool = np.setdiff1d(np.arange(1, 600), [REPEAT, ZERO_TERM, NEG_ZERO])
    for d, nnz in enumerate(ROW_NNZ):
        nnz = min(nnz, W)
        if nnz == 0:
            continue
        ids = rng.choice(pool, size=nnz, replace=False)
        if nnz >= 64:
            ids[:3] = [REPEAT, ZERO_TERM, NEG_ZERO]
        ids = np.sort(ids)
        comps[d, :nnz] = ids
        vals[d, :nnz] = rng.uniform(0.05, 2.0, nnz)
        vals[d, :nnz][ids == NEG_ZERO] = -0.0
    fused = np.concatenate([comps, vals.view(np.int32)], axis=1)
    B, SC = len(K3_CASES), 48
    qc = np.full((B, SC), PAD, np.int32)
    qv = np.zeros((B, SC), np.float32)
    terms = rng.choice(pool[:300], size=30, replace=False)
    # a repeated id (three values whose f32 sum rounds), a real term
    # valued 0 and the id whose value is -0.0, among other terms
    qc[0, :35] = np.concatenate(
        [[REPEAT, ZERO_TERM], terms[:15], [REPEAT, NEG_ZERO], terms[15:],
         [REPEAT]])
    qv[0, :35] = rng.uniform(0.01, 3.0, 35)
    qv[0, [0, 17, 34]] = np.float32([0.7, 1e-7, 2.3])
    qv[0, 1] = 0.0
    # row 1 all PAD; row 2 terms with PAD between them; row 3 ids no doc
    # holds
    qc[2, ::2] = np.concatenate([[REPEAT, NEG_ZERO], terms])[:24]
    qv[2, ::2] = rng.uniform(0.1, 1.0, 24)
    qc[3, :10] = np.arange(5000, 5010)
    qv[3, :10] = 1.0
    ids = rng.integers(0, N_DOCS, size=(B, R3)).astype(np.int32)
    ids[:, :N_DOCS] = np.arange(N_DOCS)
    ids[:, N_DOCS:N_DOCS + 2] = [-5, N_DOCS + 3]  # clamped
    return fused, ids, qc, qv


@pytest.fixture(scope="module")
def jax_k3():
    """The JAX kernel's scores of the edge rows (pallas_rescore.py:30 on
    the clamped, gathered and decoded rows, as its rescore_exact feeds
    it)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from seismic_tpu.ops.pallas_rescore import score_docs_rowmajor_pallas

    fused, ids, qc, qv = _k3_operands()
    rows = fused[np.clip(ids, 0, N_DOCS - 1)]
    comps = rows[..., :W3]
    vals = np.where(comps != PAD, rows[..., W3:].view(np.float32),
                    0.0).astype(np.float32)
    return np.asarray(score_docs_rowmajor_pallas(
        jnp.asarray(comps), jnp.asarray(vals), jnp.asarray(qc.reshape(-1)),
        jnp.asarray(qv.reshape(-1)), qc.shape[1], interpret=True))


@pytest.mark.parametrize("case", K3_CASES)
def test_k3_plain_matches_jax_on_edge_rows(jax_k3, case):
    fused, ids, qc, qv = _k3_operands()
    b = K3_CASES.index(case)
    before = rescore.launches
    out = rescore.score_docs_rowmajor(
        *(torch.from_numpy(a) for a in (fused, ids, qc, qv)), N_DOCS).numpy()
    assert rescore.launches == before  # CPU tensors: the plain version
    np.testing.assert_allclose(out[b], jax_k3[b], rtol=1e-5, atol=0)
    nnz = np.array(ROW_NNZ)[np.clip(ids[b], 0, N_DOCS - 1)]
    assert (out[b][nnz == 0] == 0).all()  # the all-PAD row
    if case in ("no_real_term", "no_match"):
        assert (out[b] == 0).all()
    else:  # every row of >= 64 entries holds the repeated id
        assert (out[b][nnz >= 64] > 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("W", [W3, 96, 75])
def test_cuda_k3_matches_plain_on_edge_rows(W):
    dev = _card()
    args = tuple(torch.from_numpy(a).to(dev) for a in _k3_operands(W))
    before = rescore.launches
    k = rescore.score_docs_rowmajor(*args, N_DOCS)
    assert rescore.launches == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(
        k, rescore.score_docs_rowmajor_plain(*args, N_DOCS), rtol=1e-5,
        atol=0)


def _k3_u8_operands(W=W3):
    """The edge rows in the lean u8 form: comps16 int16 [N_DOCS, W] (-1
    padded), codes uint8, vmin / vstep f32 [N_DOCS], and K3's doc_ids, qc
    and qv."""
    fused, ids, qc, qv = _k3_operands(W)
    comps = fused[:, :W]
    rng = np.random.default_rng(22)
    comps16 = np.where(comps == PAD, -1, comps).astype(np.int16)
    codes = np.where(comps == PAD, 0,
                     rng.integers(0, 256, comps.shape)).astype(np.uint8)
    vmin = rng.uniform(0.0, 0.2, N_DOCS).astype(np.float32)
    vstep = rng.uniform(0.001, 0.02, N_DOCS).astype(np.float32)
    return comps16, codes, vmin, vstep, ids, qc, qv


@pytest.fixture(scope="module")
def jax_k3_u8():
    """The JAX kernel's scores of the u8 edge rows: the i16 twin and the
    codes decoded per document, as its rescore_exact feeds them from a
    lean upload (pallas_rescore.py:147-159)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from seismic_tpu.ops.pallas_rescore import score_docs_rowmajor_pallas

    comps16, codes, vmin, vstep, ids, qc, qv = _k3_u8_operands()
    d = np.clip(ids, 0, N_DOCS - 1)
    c = comps16[d]
    vals = jnp.where(jnp.asarray(c) >= 0,
                     jnp.asarray(codes[d]).astype(jnp.float32)
                     * jnp.asarray(vstep[d])[..., None]
                     + jnp.asarray(vmin[d])[..., None], 0.0)
    return np.asarray(score_docs_rowmajor_pallas(
        jnp.asarray(c), vals, jnp.asarray(qc.reshape(-1)),
        jnp.asarray(qv.reshape(-1)), qc.shape[1], interpret=True))


@pytest.mark.parametrize("case", K3_CASES)
def test_k3_u8_plain_matches_jax_on_edge_rows(jax_k3_u8, case):
    args = _k3_u8_operands()
    b = K3_CASES.index(case)
    before = rescore.launches_u8
    out = rescore.score_docs_rowmajor_lean(
        *(torch.from_numpy(a) for a in args), N_DOCS).numpy()
    assert rescore.launches_u8 == before  # CPU tensors: the plain version
    np.testing.assert_allclose(out[b], jax_k3_u8[b], rtol=1e-5, atol=0)
    nnz = np.array(ROW_NNZ)[np.clip(args[4][b], 0, N_DOCS - 1)]
    assert (out[b][nnz == 0] == 0).all()  # the all-PAD row
    if case in ("no_real_term", "no_match"):
        assert (out[b] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("W", [W3, 96, 94, 75])
def test_cuda_k3_u8_matches_plain_on_edge_rows(W):
    dev = _card()
    args = tuple(torch.from_numpy(a).to(dev) for a in _k3_u8_operands(W))
    before = rescore.launches_u8
    k = rescore.score_docs_rowmajor_lean(*args, N_DOCS)
    assert rescore.launches_u8 == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(
        k, rescore.score_docs_rowmajor_lean_plain(*args, N_DOCS), rtol=1e-5,
        atol=0)
