"""K3's half-width, u16 and int32-id forms and K1 / K8 on an int32
vocabulary: the kernels against their plain versions, on edge rows.

On the CPU (plain versions only): each form's scores against a float64
NumPy product of the decoded rows and the query's summed terms (1e-5
relative), on the same operands the card cases use: rows of 0 .. W
entries, ids 0, 32767, 32768 and 2^31 - 2 (int32 forms), u16 codes past
32767, f16 values down to subnormals, queries with repeated ids, PAD
between terms and ids that share a row id's low 16 bits (the int32
forms' filter), doc ids on both sides of [0, n_docs).

On a machine with an NVIDIA card only (`cuda` marker, the card looked
for inside each test): each K3 form against its plain version at W 256
(16- / 32-byte loads), 96, 75 (single loads) and 300 (two spans), ids
clamped and skipped (1e-5 relative, exactly 0 where the plain score is
0, -inf at the same slots); K1 (quantized and f32) and K8 on int32 rows
at V 128 / 512 / 1032 bit for bit; K9 on residue-ordered int32 rows (ids
to 2^31 - 2, past 2^20, repeated in a query, buckets that overflow) at V
128 / 512 / 1032, R 4 / 8, scb 4 / 16, and at 256 terms and 1024 bucket
slots (the table of 4096 pairs, past 48 KB of shared memory), quantized
and f32, bit for bit. This file imports no JAX, so on the card it runs
alone:

    python -m pytest --noconftest -q -m cuda tests/test_torch_forms_cuda.py
"""

import numpy as np
import pytest
import torch

from seismic_tpu_torch.data.sparse import PAD_COMPONENT
from seismic_tpu_torch.ops import qloc, qloc_residue, qloc_rowmajor, rescore
from seismic_tpu_torch.ops.tiles_prep import residue_layout
from seismic_tpu_torch.search.grouped import _residue_buckets

PAD = int(PAD_COMPONENT)
N_DOCS = 24
FORMS = ("fused16", "u16", "wide_u8", "wide_u16")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _rows(W, wide, rng):
    """ids [N_DOCS, W] sorted with the padding at each row's end (-1 int16
    or PAD int32), rows of every length class up to W, the edge ids in
    the rows that hold two or more."""
    lengths = [0, 1, 7, 8, 9, 13, 83, W // 2, W - 1, W, 255, 256, 257, 300]
    lengths = [min(n, W) for n in lengths] + [
        int(x) for x in rng.integers(0, W + 1, N_DOCS - len(lengths))]
    hi = 2 ** 31 - 2 if wide else 32767
    pool = rng.choice(np.arange(1, min(hi, 1 << 20)), 2048, replace=False)
    common = pool[:96]
    edges = [0, 32767, 32768, hi] if wide else [0, 32767]
    out = np.full((N_DOCS, W), PAD if wide else -1,
                  np.int32 if wide else np.int16)
    for d, n in enumerate(lengths):
        ids = np.concatenate([rng.choice(common, min(n, 48), replace=False),
                              rng.choice(pool[96:], n, replace=False)])[:n]
        if n >= len(edges):
            ids[:len(edges)] = edges
        out[d, :n] = np.sort(ids)
    return out, common


def _operands(form, W):
    """The K3 operands of `form` (as the wrapper takes them, NumPy) and
    doc ids int32 [B, 40], qc int32 / qv f32 [B, 64]."""
    rng = np.random.default_rng(1000 * FORMS.index(form) + W)
    wide = form.startswith("wide")
    ids, common = _rows(W, wide, rng)
    real = (ids >= 0) & (ids != PAD)
    B, R, SC = 6, 40, 64
    doc = rng.integers(-4, N_DOCS + 4, (B, R)).astype(np.int32)
    doc[:, :N_DOCS] = np.arange(N_DOCS)
    qc = np.full((B, SC), PAD, np.int32)
    qv = np.zeros((B, SC), np.float32)
    for b in range(B - 1):
        t = rng.choice(common, 40, replace=False)
        extra = [0, 32767, 32768, 65535, 131071, t[0] + 65536]
        if wide:
            extra.append(2 ** 31 - 2)
        t = np.concatenate([extra, t, [t[0], t[1]]])
        qc[b, :len(t)] = t
        qv[b, :len(t)] = rng.uniform(0.01, 3.0, len(t))
    qc[B - 1, ::3] = common[:22]  # PAD between terms
    qv[B - 1, ::3] = 1.0
    if form == "fused16":
        vals = rng.uniform(0.0, 4.0, ids.shape).astype(np.float16)
        vals[:, 1::7] = np.float16(3e-7)  # subnormal
        vals[~real] = np.float16(0.0)
        words = ((ids.astype(np.int32) << 16)
                 | vals.view(np.uint16).astype(np.int32))
        return (words,), doc, qc, qv
    top = 255 if form.endswith("u8") else 65535
    codes = np.where(real, rng.integers(0, top + 1, ids.shape), 0)
    codes = (codes.astype(np.uint8) if top == 255
             else codes.astype(np.uint16).view(np.int16))
    vmin = rng.uniform(0.0, 0.2, N_DOCS).astype(np.float32)
    vstep = (rng.uniform(0.001, 0.02, N_DOCS) * 255 / top).astype(np.float32)
    return (ids, codes, vmin, vstep), doc, qc, qv


def _call(form, rows, doc, qc, qv, plain, skip):
    if form == "fused16":
        fn = (rescore.score_docs_rowmajor_fused16_plain if plain
              else rescore.score_docs_rowmajor_fused16)
    else:
        fn = (rescore.score_docs_rowmajor_lean_plain if plain
              else rescore.score_docs_rowmajor_lean)
    return fn(*rows, doc, qc, qv, N_DOCS, skip_out_of_range=skip)


def _reference(form, rows, doc, qc, qv):
    """float64: clamp the doc, decode its row, sum each id's query
    values."""
    if form == "fused16":
        w = rows[0]
        ids = (w >> 16).astype(np.int64)
        vals = (w & 0xFFFF).astype(np.uint16).view(np.float16).astype(
            np.float64)
    else:
        ids = rows[0].astype(np.int64)
        c = rows[1].view(np.uint16) if rows[1].dtype == np.int16 else rows[1]
        vals = (c.astype(np.float32) * rows[3][:, None]
                + rows[2][:, None]).astype(np.float64)
    vals = np.where((ids >= 0) & (ids != PAD), vals, 0.0)
    out = np.zeros(doc.shape)
    for b in range(doc.shape[0]):
        q = {}
        for c_, v_ in zip(qc[b], qv[b]):
            if c_ != PAD:
                q[int(c_)] = q.get(int(c_), 0.0) + float(v_)
        for r, d in enumerate(np.clip(doc[b], 0, N_DOCS - 1)):
            out[b, r] = sum(v * q.get(int(i), 0.0)
                            for i, v in zip(ids[d], vals[d]))
    return out


@pytest.mark.parametrize("form", FORMS)
def test_plain_forms_match_f64(form):
    """The plain versions on the card cases' operands against float64;
    the operands reach the edges they are meant to."""
    rows, doc, qc, qv = _operands(form, 300)
    args = [torch.from_numpy(a) for a in (*rows, doc, qc, qv)]
    n = len(rows)
    before = (rescore.launches_f16, rescore.launches_u16,
              rescore.launches_i32)
    got = _call(form, args[:n], *args[n:], plain=False, skip=False)
    # CPU tensors: the plain version, no launch counted
    assert before == (rescore.launches_f16, rescore.launches_u16,
                      rescore.launches_i32)
    want = _reference(form, rows, doc, qc, qv)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert (want > 0).mean() > 0.5
    ids = (rows[0] >> 16) if form == "fused16" else rows[0]
    nnz = ((ids >= 0) & (ids != PAD)).sum(1)
    assert {0, 13, 257, 300} <= set(nnz.tolist())
    if form.startswith("wide"):
        assert (ids == 32768).any() and (ids == 2 ** 31 - 2).any()


def _cuda_rows(form, W, dev):
    rows, doc, qc, qv = _operands(form, W)
    t = [torch.from_numpy(a).to(dev) for a in (*rows, doc, qc, qv)]
    return t[:len(rows)], t[len(rows):]


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("W", [256, 96, 75, 300])
@pytest.mark.parametrize("skip", [False, True])
def test_cuda_k3_forms_match_plain(form, W, skip):
    dev = _card()
    rows, q = _cuda_rows(form, W, dev)
    count = {"fused16": "launches_f16", "u16": "launches_u16"}.get(
        form, "launches_i32")
    before = getattr(rescore, count)
    k = _call(form, rows, *q, plain=False, skip=skip)
    assert getattr(rescore, count) == before + 1
    torch.cuda.synchronize()
    p = _call(form, rows, *q, plain=True, skip=skip)
    assert torch.equal(torch.isneginf(k), torch.isneginf(p))
    fin = torch.isfinite(p)
    torch.testing.assert_close(k[fin], p[fin], rtol=1e-5, atol=0)
    assert (k[p == 0] == 0).all()


def _vocab_operands(V):
    """int32 vocab rows (PAD padded at each row's end, the edge ids in
    list 0), a pair list and query terms with repeats and PAD between."""
    rng = np.random.default_rng(V)
    B, QCP, SC, n_lists = 12, 8, 64, 30
    pool = np.unique(np.concatenate([
        [0, 1, 32766, 32767, 32768, 65535, 2 ** 31 - 2],
        rng.choice(1 << 24, 3000, replace=False)]))
    vocab = np.full((n_lists, V), PAD, np.int32)
    for li in range(n_lists):
        m = int(rng.integers(0, V + 1)) if li else V
        vocab[li, :m] = np.sort(rng.choice(pool, m, replace=False))
    vocab[0, :7] = pool[:7]
    qc = np.full((B, SC), PAD, np.int32)
    qv = np.zeros((B, SC), np.float32)
    for b in range(B):
        m = int(rng.integers(SC // 2, SC - 4))
        t = rng.choice(pool, m, replace=False)
        t[:3] = [0, 32768, 2 ** 31 - 2]
        qc[b, :m] = t
        qv[b, :m] = rng.uniform(-3.0, 3.0, m)
        qc[b, m:m + 2] = t[3:5]  # repeated ids
        qv[b, m:m + 2] = 0.5
    qc[B - 1, ::2] = PAD
    qv[qc == PAD] = 0.0  # as the route's top terms: PAD carries 0
    pair_list = rng.integers(0, n_lists, B * QCP).astype(np.int32)
    pair_list[:QCP] = 0
    return vocab, pair_list, qc, qv, QCP


@pytest.mark.cuda
@pytest.mark.parametrize("V", [128, 512, 1032])
def test_cuda_k1_k8_int32_vocab_match_plain(V):
    dev = _card()
    vocab, pair_list, qc, qv, QCP = _vocab_operands(V)
    a = [torch.from_numpy(x).to(dev) for x in (vocab, pair_list, qc, qv)]
    before = (qloc.launches, qloc.launches_i32, qloc_rowmajor.launches_i32)
    k_i8, k_sc = qloc.project_qloc_quantize(*a, QCP)
    k_f32 = qloc.project_qloc_f32(*a, QCP)
    rows = a[0][a[1].long()].contiguous()
    qcP = a[2].repeat_interleave(QCP, 0).contiguous()
    qvP = a[3].repeat_interleave(QCP, 0).contiguous()
    k8_i8, k8_sc = qloc_rowmajor.project_qloc_rowmajor(rows, qcP, qvP)
    torch.cuda.synchronize()
    assert (qloc.launches, qloc.launches_i32,
            qloc_rowmajor.launches_i32) == (before[0], before[1] + 2,
                                            before[2] + 1)
    p_i8, p_sc = qloc.project_qloc_quantize_plain(*a, QCP)
    assert torch.equal(k_f32, qloc.project_qloc_plain(*a, QCP))
    assert torch.equal(k_i8, p_i8) and torch.equal(k_sc, p_sc)
    assert torch.equal(k8_i8, p_i8) and torch.equal(k8_sc, p_sc)
    assert (k_f32 != 0).any()


def _residue_rows(vocab, R):
    """int32 vocab rows (PAD padded) in the residue-R layout of the upload:
    R groups of VRS slots and the spill, -1 padded."""
    VRS, spill = residue_layout(vocab.shape[1], R)
    out = np.full_like(vocab, -1)
    for li, row in enumerate(vocab):
        real = row[(row >= 0) & (row != PAD)]
        rest = []
        for r in range(R):
            mine = real[real % R == r]
            out[li, r * VRS:r * VRS + len(mine[:VRS])] = mine[:VRS]
            rest += mine[VRS:].tolist()
        out[li, R * VRS:R * VRS + len(rest[:spill])] = rest[:spill]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("V,R,scb,SC", [
    (128, 4, 4, 64), (512, 8, 16, 64), (1032, 8, 16, 64), (512, 4, 16, 64),
    (1032, 8, 128, 256)])
def test_cuda_k9_int32_vocab_match_plain(V, R, scb, SC):
    dev = _card()
    vocab, pair_list, qc, qv, QCP = _vocab_operands(V)
    if SC > qc.shape[1]:  # every term slot real: the most keys a row has
        rng = np.random.default_rng(SC)
        wide = rng.choice(np.arange(1 << 20, 2 ** 31 - 2), SC - qc.shape[1],
                          replace=False).astype(np.int32)
        qc = np.concatenate([qc, np.tile(wide, (qc.shape[0], 1))], axis=1)
        qv = np.concatenate([qv, np.full((qv.shape[0], len(wide)), 0.25,
                                         np.float32)], axis=1)
    order = np.argsort(-np.abs(qv), axis=1, kind="stable")
    qc = np.take_along_axis(qc, order, 1)
    qv = np.take_along_axis(qv, order, 1)
    vocab = _residue_rows(vocab, R)
    a = [torch.from_numpy(x).to(dev) for x in (vocab, pair_list, qc, qv)]
    qcb, qvb = _residue_buckets(a[2], a[3], R, scb)
    ops = (a[0], a[1], qcb, qvb, a[2], a[3], QCP, R, scb)
    before = (qloc_residue.launches, qloc_residue.launches_i32)
    k_f32 = qloc_residue.project_qloc_residue(*ops)
    k_i8, k_sc = qloc_residue.project_qloc_residue(*ops, quantize=True)
    torch.cuda.synchronize()
    assert (qloc_residue.launches, qloc_residue.launches_i32) == (
        before[0], before[1] + 2)
    p_f32 = qloc_residue.project_qloc_residue_plain(*ops)
    p_i8, p_sc = qloc_residue.project_qloc_residue_plain(*ops,
                                                         quantize=True)
    assert torch.equal(k_f32, p_f32)
    assert torch.equal(k_i8, p_i8) and torch.equal(k_sc, p_sc)
    assert (k_f32 != 0).any()
