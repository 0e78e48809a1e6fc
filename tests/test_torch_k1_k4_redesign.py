"""K1 as a term lookup and K4 (with K2, which shares its tile body) on the
int8 tensor cores: the cases their designs have to get right.

On the CPU, against the JAX package (Pallas kernels in interpret mode, as
the JAX package runs them off the TPU), on inputs made with numpy from a
seed: K1's plain version (the projection, its quantize and the f32 output)
and K8's plain version against the JAX chains on a query row with a
repeated term id, an all-PAD row and a row whose terms match no slot; all
bit-equal.

On a machine with an NVIDIA card only (`cuda` marker; the card is looked
for inside each test): K1's three entry points against their plain
versions on the same rows (`torch.equal`), and K4 and K2 against their
plain versions over M {8, 16} x csub {1, 2} x V {256, 512, 1024}, unpacked
(int dots exact with unit scales, scaled output to 1e-6 relative) and
packed with pack_window = csub (bit-equal), with padding work items on the all-zero region. This
file imports neither JAX nor the test configuration at module level, so on
the card it also runs alone:

    python -m pytest --noconftest -q -m cuda tests/test_torch_k1_k4_redesign.py
"""

import numpy as np
import pytest
import torch

from seismic_tpu_torch.data.sparse import PAD_COMPONENT
from seismic_tpu_torch.ops import (
    grouped_scorer,
    grouped_scorer_item,
    qloc,
    qloc_rowmajor,
)
from seismic_tpu_torch.ops.tiles_prep import SUB

# ---- K1 / K8: the edge rows ----
N_LISTS, VK, SC, QC = 6, 128, 16, 2
ROW_CASES = ("repeated_id", "all_pad", "no_match")
REPEAT = 37  # the id a row repeats; in every list's vocabulary


def _edge_operands():
    """vocab int16 [N_LISTS, VK] (-1 padded), pair_list int32 [B * QC],
    qc int32 / qv f32 [B, SC], one query row per ROW_CASES entry."""
    rng = np.random.default_rng(11)
    vocab = np.full((N_LISTS, VK), -1, np.int16)
    for lst in range(N_LISTS):
        n = int(rng.integers(VK // 2, VK + 1))
        ids = rng.choice(np.setdiff1d(np.arange(1, 400), [REPEAT]),
                         size=n - 1, replace=False)
        vocab[lst, :n] = np.sort(np.append(ids, REPEAT)).astype(np.int16)
    B = len(ROW_CASES)
    qc = np.full((B, SC), PAD_COMPONENT, np.int32)
    qv = np.zeros((B, SC), np.float32)
    # a repeated id at three positions with values whose f32 sum rounds,
    # among other terms that match
    others = rng.choice(np.setdiff1d(vocab[0][vocab[0] >= 0], [REPEAT]),
                        size=9, replace=False)
    qc[0, :12] = np.insert(others, [0, 4, 9], REPEAT)
    qv[0, :12] = rng.uniform(0.01, 3.0, 12).astype(np.float32)
    qv[0, [0, 5, 11]] = np.float32([0.7, 1e-7, 2.3])
    # row 1 all PAD; row 2 real ids that no vocabulary holds
    qc[2, :10] = np.arange(1000, 1010)
    qv[2, :10] = rng.uniform(0.1, 1.0, 10).astype(np.float32)
    pair_list = rng.integers(0, N_LISTS, size=B * QC).astype(np.int32)
    pair_list[0] = 0  # the list whose ids row 0 draws
    return vocab, pair_list, qc, qv


def _as_torch(*arrays, dev="cpu"):
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


@pytest.fixture(scope="module")
def jax_chains():
    """The JAX repo's projection chains on the edge rows: the lane-major
    projection with the route's quantize (grouped.py:742-771) and the
    row-major kernel (pallas_qloc.py:77)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from seismic_tpu.ops.pallas_qloc import (
        LANES,
        ROWP,
        project_qloc_pallas,
        project_qloc_rowmajor,
    )

    vocab, pair_list, qc, qv = _edge_operands()
    B = qc.shape[0]
    P = B * QC
    P_cap = -(-P // LANES) * LANES

    @jax.jit
    def lane_major(vocab16, pair_list, qc, qv):
        vocabT = jnp.pad(vocab16[pair_list].T, ((0, 0), (0, P_cap - P)))
        qcT = jnp.pad(jnp.repeat(qc, QC, axis=0).T, ((0, 0), (0, P_cap - P)),
                      constant_values=PAD_COMPONENT)
        qvT = jnp.pad(jnp.repeat(qv, QC, axis=0).T, ((0, 0), (0, P_cap - P)))
        qlocT = project_qloc_pallas(vocabT, qcT, qvT, SC, interpret=True)
        amaxT = jnp.max(jnp.abs(qlocT), axis=0, keepdims=True)
        qscaleT = jnp.maximum(amaxT, 1e-20) / 127.0
        q_i8 = jnp.round(qlocT / qscaleT).astype(jnp.int8).T[:P]
        return qlocT.T[:P], q_i8, qscaleT[0, :P]

    R_cap = -(-P // ROWP) * ROWP

    @jax.jit
    def row_major(vocab16, pair_list, qc, qv):
        rows = jnp.pad(vocab16[pair_list], ((0, R_cap - P), (0, 0)),
                       constant_values=-1)
        qcp = jnp.pad(jnp.repeat(qc, QC, axis=0), ((0, R_cap - P), (0, 0)),
                      constant_values=PAD_COMPONENT)
        qvp = jnp.pad(jnp.repeat(qv, QC, axis=0), ((0, R_cap - P), (0, 0)))
        q_i8, scale = project_qloc_rowmajor(rows, qcp, qvp, SC,
                                            interpret=True)
        return q_i8[:P], scale[:P, 0]

    args = tuple(jnp.asarray(a) for a in (vocab, pair_list, qc, qv))
    return ([np.asarray(x) for x in lane_major(*args)],
            [np.asarray(x) for x in row_major(*args)])


@pytest.mark.parametrize("case", ROW_CASES)
def test_k1_plain_matches_jax_on_edge_rows(jax_chains, case):
    """The f32 projection, its int8 codes and scales: bit-equal to the JAX
    chain on the row's pairs."""
    (j_f32, j_i8, j_sc), _ = jax_chains
    args = _as_torch(*_edge_operands()) + (QC,)
    t_f32 = qloc.project_qloc_f32(*args)
    t_i8, t_sc = qloc.project_qloc_quantize(*args)
    rows = slice(ROW_CASES.index(case) * QC, (ROW_CASES.index(case) + 1) * QC)
    np.testing.assert_array_equal(t_f32.numpy()[rows], j_f32[rows])
    np.testing.assert_array_equal(t_i8.numpy()[rows], j_i8[rows])
    np.testing.assert_array_equal(t_sc.numpy()[rows], j_sc[rows])
    if case == "repeated_id":
        vocab, pair_list, qc, qv = _edge_operands()
        # the repeated id's slot holds the f32 sum in term order
        want = np.float32(0)
        for i in np.flatnonzero(qc[0] == REPEAT):
            want = np.float32(want + qv[0, i])
        slot = np.flatnonzero(vocab[pair_list[0]] == REPEAT)[0]
        assert t_f32[0, slot].item() == want
        assert (t_i8.numpy()[rows] != 0).sum() > 10
    else:
        assert not t_f32[rows].any() and not t_i8[rows].any()


@pytest.mark.parametrize("case", ROW_CASES)
def test_k8_plain_matches_jax_on_edge_rows(jax_chains, case):
    """The row-major projection (every pair its own rows): bit-equal to the
    JAX row-major kernel and to K1's codes."""
    _, (j_i8, j_sc) = jax_chains
    vocab, pair_list, qc, qv = _edge_operands()
    r_i8, r_sc = qloc_rowmajor.project_qloc_rowmajor(*_as_torch(
        vocab[pair_list], np.repeat(qc, QC, 0), np.repeat(qv, QC, 0)))
    k_i8, k_sc = qloc.project_qloc_quantize(*_as_torch(
        vocab, pair_list, qc, qv), QC)
    rows = slice(ROW_CASES.index(case) * QC, (ROW_CASES.index(case) + 1) * QC)
    np.testing.assert_array_equal(r_i8.numpy()[rows], j_i8[rows])
    np.testing.assert_array_equal(r_sc.numpy()[rows], j_sc[rows])
    assert torch.equal(r_i8[rows], k_i8[rows])
    assert torch.equal(r_sc[rows], k_sc[rows])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["quantize", "f32", "rowmajor"])
def test_cuda_k1_matches_plain_on_edge_rows(entry):
    """On the card: each of K1's entry points equals its plain version."""
    dev = _card()
    vocab, pair_list, qc, qv = _edge_operands()
    if entry == "rowmajor":
        args = _as_torch(vocab[pair_list], np.repeat(qc, QC, 0),
                         np.repeat(qv, QC, 0), dev=dev)
        got = qloc_rowmajor.project_qloc_rowmajor(*args)
        want = qloc_rowmajor.project_qloc_rowmajor_plain(*args)
    else:
        args = _as_torch(vocab, pair_list, qc, qv, dev=dev) + (QC,)
        if entry == "f32":
            got = (qloc.project_qloc_f32(*args),)
            want = (qloc.project_qloc_plain(*args),)
        else:
            got = qloc.project_qloc_quantize(*args)
            want = qloc.project_qloc_quantize_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---- K4 / K2: every variant, padding items included ----
N_REGIONS, W_REAL, W_PAD, G_CAP = 9, 21, 11, 7


def _scorer_operands(M, csub, V, dev):
    """Tiles whose region 0 is all zero (the padding items' region), random
    u8 codes elsewhere, random scales and queries; W_REAL real items over
    regions 1.. and W_PAD padding items on region 0, group 0, slot 0."""
    rng = np.random.default_rng(1000 * M + 10 * csub + V // 256)
    rows = csub * SUB
    tiles = rng.integers(0, 256, size=(N_REGIONS * rows, V), dtype=np.uint8)
    tiles[:rows] = 0
    scale = rng.uniform(1e-3, 2.0, N_REGIONS * rows).astype(np.float32)
    q = rng.integers(-127, 128, size=(G_CAP, M, V)).astype(np.int8)
    wr = np.concatenate([rng.integers(1, N_REGIONS, W_REAL),
                         np.zeros(W_PAD)]).astype(np.int32)
    wg = np.concatenate([np.sort(rng.integers(0, G_CAP, W_REAL)),
                         np.zeros(W_PAD)]).astype(np.int32)
    ws = np.zeros_like(wg)  # each real item's slot inside its group
    for g in range(G_CAP):
        mine = np.flatnonzero(wg[:W_REAL] == g)
        ws[mine] = np.arange(len(mine))
    ll_max = rows * (int(ws.max()) + 1)
    return _as_torch(tiles, scale, q, wr, wg, ws, dev=dev) + (ll_max,)


VARIANTS = [(M, csub, V) for M in (8, 16) for csub in (1, 2)
            for V in (256, 512, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("M,csub,V", VARIANTS)
def test_cuda_k4_matches_plain(M, csub, V, packed):
    """On the card: K4 == its plain version (int dots exact, scaled 1e-6
    relative; packed bit-equal), every item written."""
    dev = _card()
    tiles, scale, q, wr, wg, ws, ll_max = _scorer_operands(M, csub, V, dev)
    if packed:
        args = (tiles, scale, q, wr, wg, csub, ws, ll_max, csub)
        got = grouped_scorer_item.score_grouped_i8_item(*args)
        want = grouped_scorer_item.score_grouped_i8_item_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        return
    args = (tiles, scale, q, wr, wg, csub)
    got = grouped_scorer_item.score_grouped_i8_item(*args)
    want = grouped_scorer_item.score_grouped_i8_item_plain(*args)
    ones = (tiles, torch.ones_like(scale)) + args[2:]
    dots = grouped_scorer_item.score_grouped_i8_item(*ones)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    assert torch.equal(dots, grouped_scorer_item.grouped_dots_plain(
        tiles, q, wr, wg, rows_per_item=csub * SUB).to(torch.float32))
    assert not got[W_REAL:].any()  # padding items: the zero region
    assert got[:W_REAL].any()


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("M,csub,V", VARIANTS)
def test_cuda_k2_matches_plain(M, csub, V, packed):
    """On the card: K2 (the slot-major store of the same tile body) ==
    its plain version on every block a real item covers."""
    dev = _card()
    tiles, scale, q, wr, wg, ws, ll_max = _scorer_operands(M, csub, V, dev)
    # K2's work list holds the real items only (its padding items would
    # overwrite group 0's first block)
    args = (tiles, scale, q, wr[:W_REAL], wg[:W_REAL], ws[:W_REAL], ll_max,
            csub, csub if packed else 0)
    got = grouped_scorer.score_grouped_i8(*args)
    want = grouped_scorer.score_grouped_i8_plain(*args)
    torch.cuda.synchronize()
    step = SUB if packed else csub * SUB
    for w in range(W_REAL):
        g, s = int(wg[w]), int(ws[w])
        blk = (slice(g, g + 1), slice(None), slice(s * step, (s + 1) * step))
        if packed:
            assert torch.equal(got[blk], want[blk])
        else:
            torch.testing.assert_close(got[blk], want[blk], rtol=1e-6,
                                       atol=0)
