"""K3's u8 form redesigned: the skip of out-of-range ids, the membership
filter in front of the term table, and the lane-to-entry mapping of one
round trip a row.

On the CPU:
- the plain version with `skip_out_of_range=True` against the JAX
  package's `rescore_exact` on its lean upload (interpret mode): equal to
  1e-5 relative where the ids are in range, -inf elsewhere (JAX clamps
  them; the port's block-pool tail masks those slots, as JAX's does);
- a NumPy emulation of the filter (`csrc/term_filter.cuh`): a bitmap over
  every uint16 built from staged terms with repeated ids, PAD, id 0, id
  32767 and ids past the int16 range, tested two ids a word as the kernel
  tests them, equal to set membership for every id and -1;
- a NumPy emulation of the kernel's mapping (`csrc/rescore.cu`: spans of
  256 entries, 8 a lane packed as int16 pairs in 4 words, a longer row
  going on while its last span held no -1): every real entry counted
  once, no padding entry, at W 5, 75, 94, 256, 300, 512 and 600, on rows
  ending inside a lane's 8 ids, at span ends, and all -1;
- every row slot at the row counts of the kernel's schedule (1, 7, 8,
  40, 257 and 1280 slots, about 40% of them the tail's padding id) through
  the wrapper against NumPy's float64: the clamped row's score, or -inf
  out of range under the skip;
- the block-pool tail asks for the skip, and its results are the clamped
  scores' where the slot is real.

On a machine with an NVIDIA card only (`cuda` marker, the card looked for
inside each test): the kernel against its plain version in both contracts
(clamped and skipped) on rows of every length up to W, at W 256 (16-byte
loads), 96, 94, 75, 5 (single loads), 300 and 512 (more than one span),
1e-5 relative and exactly 0 where the plain score is 0; and at the row
counts above, with their padding slots. This file imports
no JAX at module level, so on the card it also runs alone:

    python -m pytest --noconftest -q -m cuda tests/test_torch_k3u8_redesign.py
"""

import numpy as np
import pytest
import torch

from seismic_tpu_torch.data.sparse import PAD_COMPONENT
from seismic_tpu_torch.ops import rescore

PAD = int(PAD_COMPONENT)
SPAN, LANES, PER_LANE = 256, 32, 8  # rescore.cu: kSpanU8, a warp, a lane
FILTER_IDS = 1 << 15                # term_filter.cuh: kFilterIds
FILTER_WORDS = (1 << 16) // 32      # term_filter.cuh: kFilterWords


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


# ---- the plain version with the skip, against JAX ----
def test_plain_skip_matches_jax_rescore_exact():
    """As `test_torch_block_pool.py::test_rescore_u8_matches_jax` builds
    it (a u8 build with no doc tiles, the JAX lean upload of its block
    view), with ids on both sides of [0, n_docs)."""
    pytest.importorskip("jax")
    from seismic_tpu import Configuration as JConfiguration
    from seismic_tpu import TpuLayout as JLayout
    from seismic_tpu.build.builder import build_index as j_build
    from seismic_tpu.ops.pallas_rescore import rescore_exact as j_rescore
    from seismic_tpu.ops.pallas_tiles import block_pool_arrays as j_view

    import dataclasses

    from seismic_tpu_torch import from_jax_arrays
    from seismic_tpu_torch.data.sparse import pad_queries
    from seismic_tpu_torch.search import engine as tengine
    from tests.conftest import make_random_dataset, make_random_queries

    ds = make_random_dataset(np.random.default_rng(0), n_docs=160, dim=400,
                             min_nnz=15, max_nnz=50, seed=43)
    ja = j_build(ds, JConfiguration(layout=JLayout(
        max_block_len=16, summary_vocab_cap=256, tile_overflow=16)),
        value_dtype="u8", store_doc_tiles=False)
    ta = from_jax_arrays({f.name: getattr(ja, f.name)
                          for f in dataclasses.fields(ja)})
    qc, qv = make_random_queries(np.random.default_rng(1), n_queries=8,
                                 dim=400, min_nnz=8, max_nnz=30)
    jdev = j_view(ja, 256, mode="dense").to_device(pallas_tiles=True,
                                                   lean_fwd=True)
    assert jdev.fwd_comps16 is not None
    q_comps, q_vals = pad_queries(qc, qv, 64)
    top_c, top_v, sc = tengine._query_terms(torch.from_numpy(q_comps),
                                            torch.from_numpy(q_vals), 32)
    n = ta.n_docs
    ids = np.random.default_rng(6).integers(
        -3, n + 4, size=(len(qc), 48)).astype(np.int32)
    ids[:, :2] = [-1, n]  # every row holds both kinds
    want = np.asarray(j_rescore(jdev, ids, top_c.numpy(), top_v.numpy(), sc,
                                interpret=True))
    tdev = ta.to_device("cpu")
    real = (ids >= 0) & (ids < n)
    for chunk in (0, 20):
        got = rescore.rescore_exact(tdev, torch.from_numpy(ids), top_c,
                                    top_v, sc, chunk_r=chunk,
                                    skip_out_of_range=True).numpy()
        assert (got[~real] == -np.inf).all()
        np.testing.assert_allclose(got[real], want[real], rtol=1e-5,
                                   atol=1e-6)
    assert (want[real] > 0).mean() > 0.5  # most rows meet some query term


# ---- the membership filter ----
def _stage(qc_row):
    """stage_terms: the row's terms in order, PAD dropped."""
    return [int(c) for c in qc_row if int(c) != PAD]


def _filter_words(staged):
    """term_filter_build: bit c % 32 of word c / 32 for each staged term
    in [0, FILTER_IDS), over words covering every uint16; uint32 [2048]."""
    words = np.zeros(FILTER_WORDS, np.uint32)
    for c in staged:
        if 0 <= c < FILTER_IDS:
            words[c >> 5] |= np.uint32(1) << np.uint32(c & 31)
    return words


def _rotr(x, s):
    s = (s & 31).astype(np.uint64)
    x = x.astype(np.uint64)
    return ((x >> s) | (x << ((32 - s) % 32))) & 0xffffffff


def _filter_pair(words, w):
    """term_filter_pair: for uint32 words w holding two uint16 ids, bit 0
    from the low id's word (w >> 5) mod 2048 rotated right by w, bit 1
    from the high id's word w >> 21 rotated right by w >> 16."""
    w = np.asarray(w, np.int64)
    lo = _rotr(words[(w >> 5) & (FILTER_WORDS - 1)], w) & 1
    hi = _rotr(words[w >> 21], w >> 16) & 1
    return (lo | (hi << 1)).astype(np.int64)


@pytest.mark.parametrize("case", ["edges", "random_full", "empty"])
def test_filter_equals_set_membership(case):
    """Every uint16 (an int16 id, or -1 read as 65535), as the low and as
    the high id of a word, tests its bit: set exactly for the staged
    terms in [0, 32768)."""
    rng = np.random.default_rng(31)
    if case == "edges":
        terms = [0, 32767, 5, 5, 31, 32, 1023, 1024, PAD, 0, 40000, 32768,
                 65535, 32767, 12345, PAD, 5]
    elif case == "random_full":  # the staging cap, with repeats
        terms = rng.integers(0, FILTER_IDS, 200).tolist()
        terms += terms[:56]
    else:
        terms = [PAD] * 8
    staged = _stage(np.asarray(terms, np.int64))
    words = _filter_words(staged)
    every = np.arange(1 << 16)
    want = np.isin(every, [c for c in staged if c < FILTER_IDS])
    other = rng.permutation(every)  # the word's other id
    got = _filter_pair(words, every | (other << 16))
    np.testing.assert_array_equal(got & 1 == 1, want)
    np.testing.assert_array_equal(got >> 1 == 1, want[other])
    got = _filter_pair(words, other | (every << 16))
    np.testing.assert_array_equal(got >> 1 == 1, want)
    assert not want[FILTER_IDS:].any()


# ---- the lane-to-entry mapping ----
def _pack(h):
    """8 int16 ids -> 4 uint32 words, id 2k in the low half of word k (as
    a 16-byte load of int16 reads them, and as the single-load variant
    packs them)."""
    return [(int(h[2 * k]) & 0xffff) | ((int(h[2 * k + 1]) & 0xffff) << 16)
            for k in range(4)]


def _part_id(words, j):
    """part_id: id j as uint16, picked by selects on bits 1 and 2 of j and
    shifted by 16 (j % 2)."""
    lo = words[1] if j & 2 else words[0]
    hi = words[3] if j & 2 else words[2]
    return ((hi if j & 4 else lo) >> ((j & 1) << 4)) & 0xffff


def _part_has_pad(words):
    """part_has_pad: a sign bit set in any half of the 4 words."""
    acc = 0
    for w in words:
        acc |= w
    return (acc & 0x80008000) != 0


def _visits(row, W):
    """The entries (column, id) that the kernel scores of one row: span
    w0 = 0, 256, ...; lane l takes columns w0 + 8 l .. w0 + 8 l + 7 (-1
    past W); an id is scored where its filter bit can be set (a real id,
    < 32768; -1 reads 65535); the next span is read only while no lane's
    8 ids held a -1."""
    out = []
    for w0 in range(0, W, SPAN):
        pad = False
        for lane in range(LANES):
            w = w0 + PER_LANE * lane
            h = [int(row[w + j]) if w + j < W else -1
                 for j in range(PER_LANE)]
            words = _pack(h)
            for j in range(PER_LANE):
                u = _part_id(words, j)
                assert u == h[j] & 0xffff
                if u < FILTER_IDS:
                    out.append((w + j, u))
            pad |= _part_has_pad(words)
        if pad:
            break
    return out


@pytest.mark.parametrize("W", [5, 75, 94, 256, 300, 512, 600])
def test_lane_mapping_counts_every_real_entry_once(W):
    rng = np.random.default_rng(W)
    lengths = sorted(n for n in {0, 1, 7, 8, 9, 13, 83, W // 2, W - 1, W,
                                 255, 256, 257, 264, 511, 512, 513}
                     if n <= W)
    for nnz in lengths:
        row = np.full(W, -1, np.int16)
        ids = rng.choice(FILTER_IDS, size=nnz, replace=False)
        ids[:min(nnz, 2)] = [0, 32767][:min(nnz, 2)]
        row[:nnz] = ids
        seen = _visits(row, W)
        cols = [w for w, _ in seen]
        assert sorted(cols) == list(range(nnz)), (W, nnz)
        assert len(set(cols)) == len(cols)
        assert [c for _, c in sorted(seen)] == row[:nnz].tolist()


# ---- every row slot, at the row counts of the kernel's schedule ----
ROW_COUNTS = [1, 7, 8, 40, 257, 1280]  # one warp's slots, a block's, more


def _slot_ids(R, B):
    """doc ids int32 [B, R]: out-of-range ids on both sides, 40% of the
    slots the block-pool tail's padding id N_DOCS, every document in the
    even queries' rows (as far as R reaches) and a padding slot last in
    the odd ones."""
    rng = np.random.default_rng(R)
    ids = rng.integers(-4, N_DOCS + 4, (B, R)).astype(np.int32)
    ids[rng.random((B, R)) < 0.4] = N_DOCS
    n = min(R, N_DOCS)
    ids[::2, :n] = np.arange(n)
    ids[1::2, -1] = N_DOCS
    return ids


def _numpy_scores(comps16, codes, vmin, vstep, ids, qc, qv, skip):
    """The function in float64 from NumPy: each slot's clamped row up to
    its first -1, the decode as two rounded f32 operations, each entry
    weighted by the query's values at its id; -inf where the id is out of
    range under the skip."""
    per_doc = np.zeros((qc.shape[0], N_DOCS))  # [B, n_docs]
    for d in range(N_DOCS):
        row = comps16[d]
        n = int(np.argmin(row >= 0)) if (row < 0).any() else len(row)
        val = (codes[d, :n].astype(np.float32) * vstep[d] + vmin[d])
        hit = row[:n, None, None] == qc[None]  # [n, B, terms]
        w = (hit * qv[None].astype(np.float64)).sum(-1)  # [n, B]
        per_doc[:, d] = val.astype(np.float64) @ w
    out = np.take_along_axis(per_doc, np.clip(ids, 0, N_DOCS - 1), 1)
    if skip:
        out[(ids < 0) | (ids >= N_DOCS)] = -np.inf
    return out


@pytest.mark.parametrize("R", ROW_COUNTS)
@pytest.mark.parametrize("skip", [False, True])
def test_row_schedule_writes_every_slot_once(R, skip):
    """At each row count, every slot of the wrapper's output (CPU tensors:
    the plain version) holds its own score: the clamped row's, or -inf for
    an out-of-range id under the skip; 1e-5 relative to NumPy's float64
    and exactly 0 where that is 0."""
    comps16, codes, vmin, vstep, _, qc, qv = _operands(256)
    ids = _slot_ids(R, qc.shape[0])
    got = rescore.score_docs_rowmajor_lean(
        *(torch.from_numpy(x) for x in (comps16, codes, vmin, vstep, ids,
                                        qc, qv)),
        N_DOCS, skip_out_of_range=skip).numpy()
    want = _numpy_scores(comps16, codes, vmin, vstep, ids, qc, qv, skip)
    assert got.shape == (qc.shape[0], R)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    real = (ids >= 0) & (ids < N_DOCS)
    assert np.isneginf(got).sum() == (0 if not skip else (~real).sum())
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=0)
    assert (got[want == 0] == 0).all()


# ---- the block-pool tail asks for the skip ----
def test_block_expand_tail_skips_padding_slots(monkeypatch):
    """`_block_expand_tail` calls `rescore_exact` with the skip; its
    scores there are the clamped ones where the slot is real and -inf at
    the padding slots (id n_docs)."""
    from seismic_tpu_torch import Configuration, CsrDataset, TpuLayout
    from seismic_tpu_torch.build.builder import build_index
    from seismic_tpu_torch.data.sparse import pad_queries
    from seismic_tpu_torch.ops import tiles_prep
    from seismic_tpu_torch.search import grouped
    from seismic_tpu_torch.search.planner import PlannerContext

    rng = np.random.default_rng(5)
    nnz = rng.integers(10, 40, 120)
    offsets = np.concatenate([[0], np.cumsum(nnz)]).astype(np.int64)
    comps = np.concatenate([np.sort(rng.choice(300, n, replace=False))
                            for n in nnz]).astype(np.int32)
    vals = (rng.gamma(2.0, 1.0, len(comps)) + 0.01).astype(np.float32)
    arrays = build_index(CsrDataset(offsets, comps, vals, 300),
                         Configuration(layout=TpuLayout(
                             max_block_len=8, summary_vocab_cap=128,
                             tile_overflow=16)),
                         value_dtype="u8", store_doc_tiles=False)
    view = tiles_prep.block_pool_arrays(arrays, 128, order_members=True)
    dev = view.to_device("cpu")
    calls = []
    real = grouped.rescore_exact

    def spy(index, ids, *a, **kw):
        out = real(index, ids, *a, **kw)
        clamped = real(index, ids, *a, **{**kw, "skip_out_of_range": False})
        calls.append((ids.clone(), out, clamped, kw))
        return out

    monkeypatch.setattr(grouped, "rescore_exact", spy)
    qc = [np.sort(rng.choice(300, 12, replace=False)) for _ in range(6)]
    qv = [(rng.gamma(2.0, 1.0, 12) + 0.01).astype(np.float32) for _ in qc]
    q_comps, q_vals = pad_queries(qc, qv, 32)
    grouped.search_grouped(
        dev, PlannerContext.from_arrays(view), q_comps, q_vals,
        grouped.GroupedParams(k=5, score_cut=32, pool=16, block_expand=8,
                              compute_dtype="i8", pool_mode="hier",
                              pool_per_pair=4),
        query_cut=6, M=8)
    assert len(calls) == 1
    ids, out, clamped, kw = calls[0]
    assert kw.get("skip_out_of_range") is True
    pad = ids >= dev.n_docs
    assert pad.any() and (~pad).any()
    assert torch.isneginf(out[pad]).all()
    assert torch.equal(out[~pad], clamped[~pad])


# ---- on the card: the kernel in both contracts ----
N_DOCS = 24


def _operands(W):
    """comps16 int16 [N_DOCS, W] (-1 padded; rows of 0, 1, 7, 8, 13, ...
    up to W entries, ids 0 and 32767 among them), u8 codes, f32 min /
    step, doc_ids int32 [B, 40] with ids on both sides of [0, N_DOCS),
    and qc int32 / qv f32 [B, 64] with repeated ids, PAD, 0, 32767 and an
    id past the int16 range."""
    rng = np.random.default_rng(100 + W)
    lengths = [0, 1, 7, 8, 9, 13, 83, W // 2, W - 1, W, 255, 256, 257,
               264, 300, 511]
    lengths = [min(n, W) for n in lengths] + [
        int(x) for x in rng.integers(0, W + 1, N_DOCS - len(lengths))]
    comps16 = np.full((N_DOCS, W), -1, np.int16)
    pool = rng.choice(np.arange(1, FILTER_IDS - 1), size=2048,
                      replace=False)
    common = pool[:96]  # ids the queries and the rows share
    for d, nnz in enumerate(lengths):
        ids = np.concatenate([rng.choice(common, min(nnz, 48),
                                         replace=False),
                              rng.choice(pool[96:], nnz, replace=False)])
        ids = ids[:nnz]
        if nnz >= 2:
            ids[:2] = [0, 32767]
        comps16[d, :nnz] = np.sort(ids)
    codes = np.where(comps16 >= 0, rng.integers(0, 256, comps16.shape),
                     0).astype(np.uint8)
    vmin = rng.uniform(0.0, 0.2, N_DOCS).astype(np.float32)
    vstep = rng.uniform(0.001, 0.02, N_DOCS).astype(np.float32)
    B, R, SC = 6, 40, 64
    ids = rng.integers(-4, N_DOCS + 4, (B, R)).astype(np.int32)
    ids[:, :N_DOCS] = np.arange(N_DOCS)
    qc = np.full((B, SC), PAD, np.int32)
    qv = np.zeros((B, SC), np.float32)
    for b in range(B - 1):
        t = rng.choice(common, 40, replace=False)
        t = np.concatenate([[0, 32767, t[0], 40000], t, [t[0], t[1]]])
        qc[b, :len(t)] = t
        qv[b, :len(t)] = rng.uniform(0.01, 3.0, len(t))
    qc[B - 1, ::3] = common[:22]  # PAD between terms
    qv[B - 1, ::3] = 1.0
    return comps16, codes, vmin, vstep, ids, qc, qv


def test_operands_hit_the_edges():
    """The card cases' operands reach what they are meant to: rows that
    end inside a lane's 8 ids and past a span, queries that hit."""
    comps16, codes, vmin, vstep, ids, qc, qv = _operands(300)
    nnz = (comps16 >= 0).sum(1)
    assert {0, 13, 257, 300} <= set(nnz.tolist())
    args = tuple(torch.from_numpy(a) for a in
                 (comps16, codes, vmin, vstep, ids, qc, qv))
    before = rescore.launches_u8
    clamped = rescore.score_docs_rowmajor_lean(*args, N_DOCS)
    skipped = rescore.score_docs_rowmajor_lean(*args, N_DOCS,
                                               skip_out_of_range=True)
    assert rescore.launches_u8 == before  # CPU tensors: the plain version
    real = (ids >= 0) & (ids < N_DOCS)
    assert torch.isneginf(skipped[torch.from_numpy(~real)]).all()
    assert torch.equal(skipped[torch.from_numpy(real)],
                       clamped[torch.from_numpy(real)])
    assert (clamped > 0).float().mean() > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("W", [256, 96, 94, 75, 5, 300, 512])
@pytest.mark.parametrize("skip", [False, True])
def test_cuda_k3_u8_matches_plain(W, skip):
    dev = _card()
    args = tuple(torch.from_numpy(a).to(dev) for a in _operands(W))
    before = rescore.launches_u8
    k = rescore.score_docs_rowmajor_lean(*args, N_DOCS,
                                         skip_out_of_range=skip)
    assert rescore.launches_u8 == before + 1
    torch.cuda.synchronize()
    p = rescore.score_docs_rowmajor_lean_plain(*args, N_DOCS,
                                               skip_out_of_range=skip)
    assert torch.equal(torch.isneginf(k), torch.isneginf(p))
    fin = torch.isfinite(p)
    torch.testing.assert_close(k[fin], p[fin], rtol=1e-5, atol=0)
    assert (k[p == 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("R", ROW_COUNTS)
@pytest.mark.parametrize("skip", [False, True])
def test_cuda_k3_u8_row_counts_match_plain(R, skip):
    """The kernel's row schedule at the row counts above: every slot
    equal to the plain version's, out-of-range ids and padding slots
    among them."""
    dev = _card()
    comps16, codes, vmin, vstep, _, qc, qv = _operands(256)
    ids = _slot_ids(R, qc.shape[0])
    args = tuple(torch.from_numpy(a).to(dev) for a in
                 (comps16, codes, vmin, vstep, ids, qc, qv))
    k = rescore.score_docs_rowmajor_lean(*args, N_DOCS,
                                         skip_out_of_range=skip)
    torch.cuda.synchronize()
    p = rescore.score_docs_rowmajor_lean_plain(*args, N_DOCS,
                                               skip_out_of_range=skip)
    assert torch.equal(torch.isneginf(k), torch.isneginf(p))
    fin = torch.isfinite(p)
    torch.testing.assert_close(k[fin], p[fin], rtol=1e-5, atol=0)
    assert (k[p == 0] == 0).all()
