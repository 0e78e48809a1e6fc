"""The kernels at the shapes past their former caps, on the card: every
shape the JAX package's kernels take.

- K2, K4 (with K5) and K6 past 32 query slots (chunks of slots along the
  grid), past 4 subtiles an item (parts of it a launch each, K5's window
  max across them) and past the V one chunk of shared memory holds (the
  queries staged a chunk at a time inside the block): M 40 / 64, csub 5 /
  8, V up to
  4096, int8 slot- and item-major, packed and unpacked, K6 in bf16 and
  f32, centred and fix-up, each against its plain version (int dots
  exact, scaled 1e-6 relative, packed bit-equal; K6 1e-5 of the larger of
  score and centring term). JAX's rule is the wrappers': M % 8 != 0 and
  V % 128 != 0 are refused before a launch, as JAX's kernel refuses them.
- K1, K8 and K9 (bit-exact) and K3 in every form (1e-5 relative) at 320
  and 1024 padded terms and at 9000: in a term table sized at run time,
  past the largest table (8192 terms) the terms walked in device memory.
- K7 at V 4096 and at widths that are not multiples of 16 (1000, 100),
  1e-5 relative.

On the CPU every case skips (CUDA kernels have no CPU mode); the card is
looked for inside each test. The file imports no JAX, so on the card it
runs alone:

    python -m pytest --noconftest -q -m cuda tests/test_torch_caps_cuda.py
"""

import numpy as np
import pytest
import torch

from seismic_tpu_torch.data.sparse import PAD_COMPONENT
from seismic_tpu_torch.ops import (
    grouped_scorer,
    grouped_scorer_f,
    grouped_scorer_item,
    pack_epilogue,
    qloc,
    qloc_residue,
    qloc_rowmajor,
    rescore,
    tiles_scorer,
)
from seismic_tpu_torch.ops.tiles_prep import SUB, residue_layout
from seismic_tpu_torch.search.grouped import _residue_buckets

PAD = int(PAD_COMPONENT)
N_REGIONS, W_REAL, W_PAD, G_CAP = 5, 6, 2, 4
# (M, csub, V): past 32 slots, past 4 subtiles, past the int8 chunk at
# M 32 / csub 4 (3072) and at csub 8 (its parts of 4)
INT8_CASES = [(40, 1, 512), (64, 2, 1024), (40, 5, 512), (64, 8, 4096),
              (32, 4, 3200), (8, 5, 256), (16, 8, 512)]
# (dtype, M, csub, V): f32 at M 32 / csub 2 past its 768 chunk, bf16 at
# M 16 / csub 4 past its 3072, and the new M and csub
K6_CASES = [("f32", 32, 2, 1024), ("bf16", 16, 4, 4096), ("bf16", 40, 5, 512),
            ("f32", 64, 8, 1024), ("bf16", 64, 8, 2048), ("f32", 8, 5, 896)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _chunk_cap(M, csub, q_bytes):
    """The widest V one chunk holds: the rings of the instance that serves
    (M, csub) (min(M, 32) slots, the largest divisor of csub up to 4) and
    its [min(M, 32), V] queries in 227 KB."""
    part = max(c for c in (1, 2, 3, 4) if csub % c == 0)
    free = 232448 - 4 * 64 * part * SUB
    return free // (min(M, 32) * q_bytes) // 128 * 128


def _operands(M, csub, V, seed, dev):
    """Tiles (region 0 all zero, the padding items'; 30% of the other
    codes 0), scales, int8 queries, f32 projections and their qsum; W_REAL
    real work items then W_PAD padding items on region 0, group 0."""
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
    o = dict(tiles=tiles, scale=scale, q8=q8, qf=qf, qsum=qsum, wr=wr,
             wg=wg, ws=ws)
    o = {k: torch.from_numpy(v).to(dev) for k, v in o.items()}
    o["ll_max"] = rows * (int(ws.max()) + 1)
    o["np"] = dict(scale=scale, qsum=qsum, wr=wr, wg=wg, ws=ws)
    return o


def _blocks(out, o, step):
    """[W_REAL, M, step]: the slot-major output blocks the real items
    wrote."""
    wg, ws = o["np"]["wg"], o["np"]["ws"]
    return torch.stack([out[int(g), :, int(s) * step:(int(s) + 1) * step]
                        for g, s in zip(wg[:W_REAL], ws[:W_REAL])])


def _pack_windows(csub):
    """Unpacked, packed at pack_window csub and, where csub allows, at a
    window that puts a part's rows on several output columns (2)."""
    return sorted({0, csub} | ({2} if csub % 2 == 0 else set()))


@pytest.mark.cuda
@pytest.mark.parametrize("M,csub,V", INT8_CASES)
def test_cuda_k4_k2_past_the_caps(M, csub, V):
    """K4 (item-major) and K2 (slot-major) at a shape past a former cap ==
    their plain versions: int dots exact with unit scales, scaled 1e-6
    relative, padding items 0; packed (K5) bit-equal at every window."""
    dev = _card()
    o = _operands(M, csub, V, seed=1000 * M + 10 * csub + V, dev=dev)
    assert (M > 32 or csub > 4
            or V > grouped_scorer_item.max_v(M, csub)
            == _chunk_cap(M, csub, 1))
    R = csub * SUB
    before = (grouped_scorer_item.launches, grouped_scorer.launches,
              pack_epilogue.launches)
    item = (o["tiles"], o["scale"], o["q8"], o["wr"], o["wg"], csub)
    got = grouped_scorer_item.score_grouped_i8_item(*item)
    dots = grouped_scorer_item.score_grouped_i8_item(
        o["tiles"], torch.ones_like(o["scale"]), *item[2:])
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, grouped_scorer_item.score_grouped_i8_item_plain(*item),
        rtol=1e-6, atol=0)
    assert torch.equal(dots, grouped_scorer.grouped_dots_plain(
        o["tiles"], o["q8"], o["wr"], o["wg"], rows_per_item=R).to(
            torch.float32))
    assert not got[W_REAL:].any() and got[:W_REAL].any()
    real = (o["wr"][:W_REAL], o["wg"][:W_REAL], o["ws"][:W_REAL])
    n_packed = 0
    for pw in _pack_windows(csub):
        if pw:
            n_packed += 2
            args = item + (o["ws"], o["ll_max"], pw)
            assert torch.equal(
                grouped_scorer_item.score_grouped_i8_item(*args),
                grouped_scorer_item.score_grouped_i8_item_plain(*args))
        slot = (o["tiles"], o["scale"], o["q8"], *real, o["ll_max"], csub,
                pw)
        k2 = grouped_scorer.score_grouped_i8(*slot)
        p2 = grouped_scorer.score_grouped_i8_plain(*slot)
        step = R // pw if pw else R
        a, b = _blocks(k2, o, step), _blocks(p2, o, step)
        if pw:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
            assert b.abs().max() > 0
    n_pw = len(_pack_windows(csub))
    assert (grouped_scorer_item.launches, grouped_scorer.launches,
            pack_epilogue.launches) == (before[0] + 2 + n_pw - 1,
                                        before[1] + n_pw,
                                        before[2] + n_packed)


@pytest.mark.cuda
@pytest.mark.parametrize("centred", [True, False])
@pytest.mark.parametrize("dt,M,csub,V", K6_CASES)
def test_cuda_k6_past_the_caps(dt, M, csub, V, centred):
    """K6 at a shape past a former cap == its plain version to 1e-5 of the
    larger of score and centring term; packed: the values to that plus
    the index bits' rounding, the rows on >= 99.9% of the equal values."""
    dev = _card()
    qb = 2 if dt == "bf16" else 6
    assert (M > 32 or csub > 4
            or V > grouped_scorer_f.max_v(M, csub, dt)
            == _chunk_cap(M, csub, qb))
    o = _operands(M, csub, V, seed=2000 * M + 10 * csub + V + centred,
                  dev=dev)
    R = csub * SUB
    n = o["np"]
    rows = n["wr"][:W_REAL, None] * R + np.arange(R)
    mag = (np.abs(n["qsum"][n["wg"][:W_REAL]])[:, :, None]
           * n["scale"][rows][:, None, :] if centred
           else np.zeros((W_REAL, M, R), np.float32))
    mag = torch.from_numpy(mag).to(dev).float()
    before = grouped_scorer_f.launches
    for pw in _pack_windows(csub):
        args = (o["tiles"], o["scale"], o["qf"],
                o["qsum"] if centred else None, o["wr"][:W_REAL],
                o["wg"][:W_REAL], o["ws"][:W_REAL], o["ll_max"], csub, dt,
                pw)
        got = grouped_scorer_f.score_grouped_f(*args)
        want = grouped_scorer_f.score_grouped_f_plain(*args)
        torch.cuda.synchronize()
        step = R // pw if pw else R
        k, p = _blocks(got, o, step), _blocks(want, o, step)
        if not pw:
            assert ((k - p).abs() <= 1e-5 * torch.maximum(mag, p.abs())).all()
            assert p.abs().max() > 0
            continue
        (kv, ko), (pv, po) = (pack_epilogue.unpack(x, o["ll_max"])
                              for x in (k, p))
        mag_w = mag.reshape(W_REAL, M, pw, step).amax(2)
        tol = 1e-5 * mag_w + pv.abs() * (
            2.0 ** (pack_epilogue.idx_bits(o["ll_max"]) - 23) + 1e-5)
        assert ((kv - pv).abs() <= tol).all()
        same = kv == pv
        assert same.float().mean().item() > 0.5
        assert (ko[same] == po[same]).float().mean().item() >= 0.999
    assert grouped_scorer_f.launches == before + len(_pack_windows(csub))


@pytest.mark.cuda
@pytest.mark.parametrize("M,csub,V", [(12, 1, 128), (40, 5, 192),
                                      (64, 8, 1000), (20, 2, 256)])
def test_cuda_scorers_refuse_what_jax_refuses(M, csub, V):
    """M % 8 != 0 or V % 128 != 0 (what `score_grouped_pallas` asserts
    against) is refused by all three wrappers before a launch, naming the
    rule; the same shape with M and V on the rule runs."""
    dev = _card()
    counts = (grouped_scorer.launches, grouped_scorer_item.launches,
              grouped_scorer_f.launches)
    o = _operands(M, csub, V, seed=M + V, dev=dev)
    real = (o["wr"][:W_REAL], o["wg"][:W_REAL], o["ws"][:W_REAL])
    calls = [
        lambda: grouped_scorer.score_grouped_i8(
            o["tiles"], o["scale"], o["q8"], *real, o["ll_max"], csub),
        lambda: grouped_scorer_item.score_grouped_i8_item(
            o["tiles"], o["scale"], o["q8"], o["wr"], o["wg"], csub),
        lambda: grouped_scorer_f.score_grouped_f(
            o["tiles"], o["scale"], o["qf"], o["qsum"], *real, o["ll_max"],
            csub, "bf16")]
    for call in calls:
        with pytest.raises(ValueError, match="M a multiple of 8, csub >= 1, "
                                             "V a multiple of 128"):
            call()
    assert (grouped_scorer.launches, grouped_scorer_item.launches,
            grouped_scorer_f.launches) == counts
    M2, V2 = M // 8 * 8 or 8, V // 128 * 128
    o2 = _operands(M2, csub, V2, seed=M2 + V2, dev=dev)
    item = (o2["tiles"], o2["scale"], o2["q8"], o2["wr"], o2["wg"], csub)
    torch.testing.assert_close(
        grouped_scorer_item.score_grouped_i8_item(*item),
        grouped_scorer_item.score_grouped_i8_item_plain(*item), rtol=1e-6,
        atol=0)


# ---- K1, K8, K9 and K3 past 256 terms ----

TERMS = [320, 1024, 9000]


def _terms(rng, B, SC, pool, lo=-3.0):
    """qc int32 / qv f32 [B, SC]: distinct ids from pool, values in [lo,
    3), a repeated id and PAD between terms in every row (PAD carries
    0)."""
    qc = np.full((B, SC), PAD, np.int32)
    qv = np.zeros((B, SC), np.float32)
    for b in range(B):
        m = min(SC - 3, len(pool))
        t = rng.choice(pool, m, replace=False)
        qc[b, :m] = t
        qv[b, :m] = rng.uniform(lo, 3.0, m)
        qc[b, m] = t[1]  # a repeat
        qv[b, m] = 0.5
    qc[:, 2::97] = PAD
    qv[qc == PAD] = 0.0
    return qc, qv


def _vocab(rng, n_lists, V, pool, wide):
    """Vocab rows of distinct ids from pool, padded (-1 int16 / PAD
    int32) at each row's end."""
    vocab = np.full((n_lists, V), PAD if wide else -1,
                    np.int32 if wide else np.int16)
    for li in range(n_lists):
        m = int(rng.integers(V // 2, V + 1))
        vocab[li, :m] = np.sort(rng.choice(pool, m, replace=False))
    return vocab


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("SC", TERMS)
def test_cuda_k1_k8_k9_many_terms(SC, wide):
    """K1 (quantized and f32), K8 and K9 (quantized and f32, R 8, scb
    SC / 8) at SC padded terms == their plain versions bit for bit."""
    dev = _card()
    rng = np.random.default_rng(SC + wide)
    hi = 2 ** 31 - 2 if wide else 32767
    pool = rng.choice(np.arange(0, min(hi, 1 << 22)), 12000, replace=False)
    B, QCP, V, n_lists = 4, 4, 512, 12
    qc, qv = _terms(rng, B, SC, pool)
    vocab = _vocab(rng, n_lists, V, np.concatenate(
        [qc[0, :200], pool[-3000:]]), wide)
    pair_list = rng.integers(0, n_lists, B * QCP).astype(np.int32)
    a = [torch.from_numpy(x).to(dev) for x in (vocab, pair_list, qc, qv)]
    k_i8, k_sc = qloc.project_qloc_quantize(*a, QCP)
    k_f32 = qloc.project_qloc_f32(*a, QCP)
    rows = a[0][a[1].long()].contiguous()
    qcP = a[2].repeat_interleave(QCP, 0).contiguous()
    qvP = a[3].repeat_interleave(QCP, 0).contiguous()
    k8_i8, k8_sc = qloc_rowmajor.project_qloc_rowmajor(rows, qcP, qvP)
    torch.cuda.synchronize()
    p_i8, p_sc = qloc.project_qloc_quantize_plain(*a, QCP)
    assert torch.equal(k_f32, qloc.project_qloc_plain(*a, QCP))
    assert torch.equal(k_i8, p_i8) and torch.equal(k_sc, p_sc)
    assert torch.equal(k8_i8, p_i8) and torch.equal(k8_sc, p_sc)
    assert (k_f32 != 0).any()
    # K9 on the residue layout of the same rows
    R, scb = 8, max(SC // 8, 4)
    VRS, spill = residue_layout(V, R)
    res = np.full_like(vocab, -1)
    for li, row in enumerate(vocab):
        real = row[(row >= 0) & (row != PAD)]
        rest = []
        for r in range(R):
            mine = real[real % R == r]
            res[li, r * VRS:r * VRS + len(mine[:VRS])] = mine[:VRS]
            rest += mine[VRS:].tolist()
        res[li, R * VRS:R * VRS + len(rest[:spill])] = rest[:spill]
    order = np.argsort(-np.abs(qv), axis=1, kind="stable")
    qcs = torch.from_numpy(np.take_along_axis(qc, order, 1)).to(dev)
    qvs = torch.from_numpy(np.take_along_axis(qv, order, 1)).to(dev)
    qcb, qvb = _residue_buckets(qcs, qvs, R, scb)
    ops = (torch.from_numpy(res).to(dev), a[1], qcb, qvb, qcs, qvs, QCP, R,
           scb)
    k9 = qloc_residue.project_qloc_residue(*ops)
    k9_i8, k9_sc = qloc_residue.project_qloc_residue(*ops, quantize=True)
    torch.cuda.synchronize()
    assert torch.equal(k9, qloc_residue.project_qloc_residue_plain(*ops))
    p9_i8, p9_sc = qloc_residue.project_qloc_residue_plain(*ops,
                                                           quantize=True)
    assert torch.equal(k9_i8, p9_i8) and torch.equal(k9_sc, p9_sc)
    assert (k9 != 0).any()


K3_FORMS = ("fused", "fused16", "u8", "u16", "wide_u8", "wide_u16")


@pytest.mark.cuda
@pytest.mark.parametrize("form", K3_FORMS)
@pytest.mark.parametrize("SC", TERMS)
def test_cuda_k3_forms_many_terms(SC, form):
    """K3 in every form at SC padded terms == its plain version to 1e-5
    relative (exactly 0 where the plain score is 0), ids clamped. The
    query values are positive, as the route's are (a sum of mixed signs
    cancels, and its order then moves the low bits past any relative
    tolerance)."""
    dev = _card()
    rng = np.random.default_rng(7 * SC + K3_FORMS.index(form))
    wide = form.startswith("wide") or form == "fused"
    n_docs, W, B, R = 40, 256, 3, 48
    hi = 2 ** 31 - 2 if wide else 32767
    pool = rng.choice(np.arange(0, min(hi, 1 << 22)), 12000, replace=False)
    qc, qv = _terms(rng, B, SC, pool, lo=0.01)
    ids = _vocab(rng, n_docs, W, np.concatenate(
        [qc[0, :300], pool[-4000:]]), wide)
    real = (ids >= 0) & (ids != PAD)
    doc = rng.integers(-3, n_docs + 3, (B, R)).astype(np.int32)
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    qct, qvt, doct = t(qc), t(qv), t(doc)
    vals = np.where(real, rng.uniform(0.0, 4.0, ids.shape), 0.0)
    if form == "fused":
        fused = np.concatenate([ids, vals.astype(np.float32).view(np.int32)],
                               axis=1)
        fn, plain, rows = (rescore.score_docs_rowmajor,
                           rescore.score_docs_rowmajor_plain, (t(fused),))
        kw = {}
    elif form == "fused16":
        v16 = vals.astype(np.float16)
        words = ((ids.astype(np.int32) << 16)
                 | v16.view(np.uint16).astype(np.int32))
        fn, plain, rows = (rescore.score_docs_rowmajor_fused16,
                           rescore.score_docs_rowmajor_fused16_plain,
                           (t(words),))
        kw = dict(skip_out_of_range=False)
    else:
        top = 255 if form.endswith("u8") else 65535
        codes = np.where(real, rng.integers(0, top + 1, ids.shape), 0)
        codes = (codes.astype(np.uint8) if top == 255
                 else codes.astype(np.uint16).view(np.int16))
        vmin = rng.uniform(0.0, 0.2, n_docs).astype(np.float32)
        vstep = rng.uniform(0.001, 0.02, n_docs).astype(np.float32)
        fn, plain = (rescore.score_docs_rowmajor_lean,
                     rescore.score_docs_rowmajor_lean_plain)
        rows = (t(ids), t(codes), t(vmin), t(vstep))
        kw = dict(skip_out_of_range=False)
    k = fn(*rows, doct, qct, qvt, n_docs, **kw)
    torch.cuda.synchronize()
    p = plain(*rows, doct, qct, qvt, n_docs, **kw)
    torch.testing.assert_close(k, p, rtol=1e-5, atol=0)
    assert (k[p == 0] == 0).all() and (p != 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("V", [4096, 1000, 100])
def test_cuda_k7_any_width(V):
    """K7 at V 4096 (past its former cap of 2048) and at widths that are
    not multiples of 16 (rows off 16-byte alignment: plain loads) == its
    plain version to 1e-5 relative, subtiles past a pair's length 0."""
    dev = _card()
    rng = np.random.default_rng(V)
    n_lists, P, ll_pad = 9, 70, 3 * SUB
    lens = rng.integers(1, ll_pad + 1, n_lists)
    lens[0] = ll_pad
    region = np.zeros(n_lists, np.int64)
    np.cumsum(-(-lens[:-1] // SUB), out=region[1:])
    rows = int(region[-1] * SUB + ll_pad)
    tiles = rng.integers(0, 256, (rows, V), dtype=np.uint8)
    scale = rng.uniform(1e-3, 1.0, rows).astype(np.float32)
    lists = rng.integers(0, n_lists, P)
    qloc_ = (rng.random((P, V)) * (rng.random((P, V)) < 0.2)).astype(
        np.float32)
    t = [torch.from_numpy(x).to(dev) for x in (
        tiles, scale, region[lists].astype(np.int32), qloc_,
        lens[lists].astype(np.int32))]
    before = tiles_scorer.launches
    k = tiles_scorer.score_tiles(*t, ll_pad)
    torch.cuda.synchronize()
    assert tiles_scorer.launches == before + 1
    p = tiles_scorer.score_tiles_plain(*t, ll_pad)
    torch.testing.assert_close(k, p, rtol=1e-5, atol=1e-6)
    assert p.abs().max() > 0
