"""K9 as K1's term lookup with bucket keys, and K17 on the bf16 tensor
cores: the cases their designs have to get right.

On the CPU, on inputs made with numpy from a seed:
- the two residue invariants that let the bucket keys stand for R
  compare loops: every code in group r of a `residue_permute_arrays`
  vocabulary has code % R == r, and every real entry of bucket r of
  `_residue_buckets` has id % R == r (R 4 and 8, a synthetic index);
- a one-dictionary emulation of the new K9 (the row's plain terms keyed
  by (id, R), its bucket entries by (id, bucket), each key's values
  summed in f32 in entry order from 0.0) equals
  `project_qloc_residue_plain` bit for bit on a repeated id within a
  bucket, an overflowing bucket, an all-PAD row and a no-match row;
- every int8 value round-trips through bf16, and K17's conversion (the
  sign-flipped byte in the mantissa of 2^23, less 2^23 + 128) gives it;
- K17's arithmetic (exact products of the int8 tile and the three bf16
  terms of q, f32 sums over each 32-deep k-slice, one rounded add a slice,
  the 8 warps' partial tiles added in order) stays within 1e-6 of
  sum_k |tile * q| of the f64 product, on the probe's inputs and on edge
  tiles of +-127 / -128, and within it of the JAX `int8_cast_matmul`
  probe run in interpret mode.

On a machine with an NVIDIA card only (`cuda` marker; the card is looked
for inside each test): K9 == its plain version bit for bit, quantized and
f32, over V 256 / 512 / 1024 / 4104, R 4 / 8, scb 8 / 16 on those edge
rows; K17 within its tolerance at the probe's shape, on the edge tiles
and at ragged shapes, K = 0 included. This file imports neither JAX nor
the test configuration at module level, so on the card it also runs
alone:

    python -m pytest --noconftest -q -m cuda tests/test_torch_k9_k17_redesign.py
"""

import numpy as np
import pytest
import torch

from seismic_tpu_torch.data.sparse import PAD_COMPONENT
from seismic_tpu_torch.harness import device_probe as tdp
from seismic_tpu_torch.ops import grouped_scorer_f, qloc_residue
from seismic_tpu_torch.ops import probe_kernels as pk
from seismic_tpu_torch.ops.tiles_prep import (
    residue_layout,
    residue_permute_arrays,
)
from seismic_tpu_torch.search.grouped import _residue_buckets

EDGE_ROWS = ("repeat_in_bucket", "overflow", "all_pad", "no_match")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


# ---- K9: the residue layout and the table ----


@pytest.mark.parametrize("R", [4, 8])
def test_residue_invariants(R):
    """Group r of a permuted vocabulary holds only codes c % R == r, and
    bucket r of the query buckets only ids c % R == r."""
    from seismic_tpu_torch import Configuration
    from seismic_tpu_torch.build.builder import build_index
    from seismic_tpu_torch.config import TpuLayout
    from seismic_tpu_torch.harness.synth import synth_dataset

    ds = synth_dataset(600, dim=3000, mean_nnz=40.0, std_nnz=10.0,
                       min_nnz=16, max_nnz=64, n_topics=64, seed=3)
    arrays = build_index(ds, Configuration(layout=TpuLayout(
        max_block_len=16, summary_vocab_cap=256, tile_overflow=16)),
        value_dtype="f16")
    vocab = np.asarray(residue_permute_arrays(arrays, R).list_vocab)
    V = vocab.shape[1]
    VRS, _ = residue_layout(V, R)
    groups = vocab[:, :R * VRS].reshape(-1, R, VRS).astype(np.int64)
    real = groups >= 0
    assert real.sum() > 0.5 * real.size  # the groups are mostly full
    res = np.broadcast_to(np.arange(R)[None, :, None], groups.shape)
    assert ((groups % R == res) | ~real).all()
    assert (groups[~real] == -1).all()
    # the queries' buckets
    rng = np.random.default_rng(R)
    B, SC, scb = 64, 64, 6  # 64 terms overflow some bucket of 6
    qc = np.full((B, SC), PAD_COMPONENT, np.int32)
    qv = np.zeros((B, SC), np.float32)
    for b in range(B):
        n = rng.integers(1, SC + 1)
        qc[b, :n] = rng.choice(3000, n, replace=False)
        qv[b, :n] = -np.sort(-rng.random(n).astype(np.float32))
    qcb, _ = _residue_buckets(torch.from_numpy(qc), torch.from_numpy(qv), R,
                              scb)
    qcb = qcb.numpy().reshape(B, R, scb).astype(np.int64)
    kept = qcb >= 0
    assert ((qcb % R == np.arange(R)[None, :, None]) | ~kept).all()
    assert (qcb[~kept] == -2).all()
    assert kept.sum() < (qc != PAD_COMPONENT).sum()  # some bucket overflowed


def _edge_operands(V, R, scb, seed, n_lists=12, QC=3):
    """Residue-ordered list vocabularies and four query rows, one per edge
    case: a term twice (the same id in one bucket twice, its values summed
    in order, one of them -0.0), more terms of one residue than a bucket
    holds (taken from the row's own lists' group 1, so the dropped ones
    meet their group slots), no real term, and terms no list holds.
    Returns the operands of `project_qloc_residue`."""
    rng = np.random.default_rng(seed)
    dim = max(4000, 2 * V)
    VRS, spill = residue_layout(V, R)
    vocab = np.full((n_lists, V), -1, np.int16)
    for li in range(n_lists):
        terms = rng.choice(dim, rng.integers(V // 2, V + 1), replace=False)
        rest = []
        for r in range(R):
            mine = terms[terms % R == r]
            vocab[li, r * VRS:r * VRS + len(mine[:VRS])] = mine[:VRS]
            rest += mine[VRS:].tolist()
        vocab[li, R * VRS:R * VRS + len(rest[:spill])] = rest[:spill]
    pair_list = rng.integers(0, n_lists, len(EDGE_ROWS) * QC).astype(
        np.int32)

    def held_by(row, group=None):
        v = vocab[pair_list[row * QC:(row + 1) * QC]]
        if group is not None:
            v = v[:, group * VRS:(group + 1) * VRS]
        return np.unique(v[v >= 0]).astype(np.int64)

    SC = 3 * scb
    qc = np.full((len(EDGE_ROWS), SC), PAD_COMPONENT, np.int32)
    qv = np.zeros(qc.shape, np.float32)
    # repeat_in_bucket: terms of the row's lists, the second one twice,
    # and an id of the same residue that no code equals
    t = rng.choice(held_by(0), SC - 2, replace=False)
    qc[0] = np.concatenate([t[:2], t[1:2], t[2:], [t[1] + R * dim]])
    qv[0] = rng.normal(size=SC).astype(np.float32)
    qv[0, 1] = -0.0
    # overflow: 2 * scb terms of the row's lists' group 1, then others
    qc[1, :2 * scb] = rng.choice(held_by(1, group=1), 2 * scb,
                                 replace=False)
    others = held_by(1)
    qc[1, 2 * scb:] = rng.choice(others[others % R != 1], scb,
                                 replace=False)
    qv[1] = -np.sort(-rng.random(SC).astype(np.float32) * 3)
    # all_pad stays PAD; no_match: ids no list holds
    qc[3] = rng.choice(np.arange(dim, 2 * dim), SC, replace=False)
    qv[3] = rng.random(SC).astype(np.float32)
    qcb, qvb = _residue_buckets(torch.from_numpy(qc), torch.from_numpy(qv),
                                R, scb)
    return (torch.from_numpy(vocab), torch.from_numpy(pair_list), qcb, qvb,
            torch.from_numpy(qc), torch.from_numpy(qv), QC, R, scb)


def _one_table(vocab, pair_list, qcb, qvb, qc, qv, QC, R, scb):
    """The new K9 with one dictionary: key(id, t) = id * 2048 + t -> the
    values of its entries summed in f32 in entry order from 0.0f, with t =
    R for the row's plain terms (ids outside int16 left out) and t = r for
    the entries of bucket r (ids < 0 left out); a group slot of group r
    looks up key(code, r), a spill slot key(code, R), and a missing key
    gives 0.0f."""
    vocab, pair_list = vocab.numpy(), pair_list.numpy()
    qcb, qvb, qc, qv = (x.numpy() for x in (qcb, qvb, qc, qv))
    P, V = len(pair_list), vocab.shape[1]
    VRS, _ = residue_layout(V, R)

    def key(c, t):
        return int(c) * 2048 + t

    out = np.zeros((P, V), np.float32)
    for b in range(qc.shape[0]):
        table = {}
        entries = [(key(c, R), v) for c, v in zip(qc[b], qv[b])
                   if -32768 <= c <= 32767]
        entries += [(key(c, i // scb), v)
                    for i, (c, v) in enumerate(zip(qcb[b], qvb[b]))
                    if 0 <= c <= 32767]
        assert len(entries) <= qc.shape[1] + R * scb
        for k, v in entries:
            table[k] = np.float32(table.get(k, np.float32(0)) + v)
        for p in range(b * QC, (b + 1) * QC):
            row = vocab[pair_list[p]]
            for v in range(V):
                tag = v // VRS if v < R * VRS else R
                out[p, v] = table.get(key(row[v], tag), 0.0)
    return torch.from_numpy(out)


@pytest.mark.parametrize("R,scb", [(4, 8), (8, 16)])
def test_one_table_emulation_equals_plain(R, scb):
    """One table of the plain and the bucket keys gives the plain version's
    projection bit for bit, -0.0 and the quantize included."""
    ops = _edge_operands(256, R, scb, seed=10 * R + scb)
    want = qloc_residue.project_qloc_residue_plain(*ops)
    got = _one_table(*ops)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # every edge row does what it is there for
    QC = ops[6]
    VRS, _ = residue_layout(256, R)
    rows = {name: want[i * QC:(i + 1) * QC] for i, name in
            enumerate(EDGE_ROWS)}
    assert (rows["repeat_in_bucket"] != 0).any()
    assert not rows["all_pad"].any() and not rows["no_match"].any()
    # a term its full bucket dropped gives 0 in its group slots
    qcb1 = set(ops[2][1].tolist())
    dropped = [c for c in ops[4][1].tolist() if c not in qcb1]
    assert len(dropped) == scb
    vrows = ops[0][ops[1][QC:2 * QC].long()]
    group_hit = torch.isin(vrows[:, :R * VRS], torch.tensor(dropped))
    assert group_hit.any()
    assert not rows["overflow"][:, :R * VRS][group_hit].any()
    assert rows["overflow"][:, :R * VRS][~group_hit].any()
    q_i8, scale = qloc_residue.project_qloc_residue_plain(*ops,
                                                          quantize=True)
    e_i8, e_sc = qloc_residue.quantize_plain(got)
    assert torch.equal(q_i8, e_i8) and torch.equal(scale, e_sc)


# ---- K17: the conversion and the arithmetic ----


def test_int8_exact_in_bf16_and_flip_conversion():
    x = np.arange(-128, 128, dtype=np.int8)
    t = torch.from_numpy(x)
    assert torch.equal(t.to(torch.bfloat16).to(torch.int8), t)
    # the kernel's conversion: (2^23 + (x ^ 0x80)) - (2^23 + 128) in f32,
    # whose upper 16 bits are bf16(x)
    u = x.view(np.uint8) ^ np.uint8(0x80)
    f = (np.uint32(0x4B000000) | u.astype(np.uint32)).view(np.float32)
    y = (f - np.float32(8388736.0)).astype(np.float32)
    np.testing.assert_array_equal(y, x.astype(np.float32))
    assert not (y.view(np.uint32) & 0xFFFF).any()
    hi = (y.view(np.uint32) >> 16).astype(np.uint16)
    np.testing.assert_array_equal(
        hi, t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16))


def _k17_emulated(tile, q):
    """K17's arithmetic on the CPU: a warp w of 8 takes the 64-column
    slices w, w + 8, ...; each 32-deep half of a slice (lane t's columns
    t * 16 + 8 h .. + 7) sums the exact products of its columns with the
    three bf16 terms of q in f32, lo first, in a fresh sum, added to the
    warp's partial with one rounded add; the partials add in warp order."""
    M, K = tile.shape
    terms = [x.double().numpy() for x in
             grouped_scorer_f.split_bf16x3(torch.from_numpy(q))]
    t64 = tile.astype(np.float64)
    warps = np.zeros((8, M, q.shape[1]), np.float32)
    for k0 in range(0, K, 64):
        w = (k0 // 64) % 8
        for h in range(2):
            cols = [k0 + t * 16 + 8 * h + j for t in range(4) for j in
                    range(8) if k0 + t * 16 + 8 * h + j < K]
            frag = np.zeros((M, q.shape[1]), np.float32)
            for term in terms[::-1]:
                for k in cols:  # each product exact in f32
                    prod = (t64[:, k:k + 1] * term[k:k + 1, :]).astype(
                        np.float32)
                    frag = frag + prod
            warps[w] = warps[w] + frag
    out = warps[0]
    for w in range(1, 8):
        out = out + warps[w]
    return out


def _edge_tile(M, K, seed):
    """Rows of +127, of -128, alternating, and random among the two."""
    rng = np.random.default_rng(seed)
    tile = np.empty((M, K), np.int8)
    tile[0::4] = 127
    tile[1::4] = -128
    tile[2::4] = np.where(np.arange(K) % 2 == 0, 127, -128)
    tile[3::4] = rng.choice(np.array([127, -128], np.int8),
                            size=tile[3::4].shape)
    return tile


def _k17_case(case):
    a = tdp.int8_cast_matmul_inputs()
    tile, q = a["tile"], a["q"]
    if case == "edge":
        tile = _edge_tile(*tile.shape, seed=17)
    elif case == "edge_q_positive":  # no cancellation in any sum
        tile, q = _edge_tile(*tile.shape, seed=18), np.abs(q)
    return tile, q


def _within_tol(out, tile, q):
    t64, q64 = tile.astype(np.float64), q.astype(np.float64)
    err = np.abs(np.asarray(out, np.float64) - t64 @ q64)
    tol = 1e-6 * (np.abs(t64) @ np.abs(q64))
    return float((err / np.maximum(tol, 1e-300)).max()), bool(
        (err <= tol).all())


@pytest.mark.parametrize("case", ["probe", "edge", "edge_q_positive"])
def test_k17_emulated_arithmetic_within_tolerance(case):
    tile, q = _k17_case(case)
    emu = _k17_emulated(tile, q)
    share, ok = _within_tol(emu, tile, q)
    assert ok, share
    # the CPU wrapper (the plain version) too
    got = pk.i8_matmul(torch.from_numpy(tile), torch.from_numpy(q))
    assert _within_tol(got.numpy(), tile, q)[1]


def test_k17_emulated_matches_jax_probe(monkeypatch):
    """The emulated arithmetic against the JAX `int8_cast_matmul` probe,
    its Pallas kernel run in interpret mode, on the probe's own draws."""
    pytest.importorskip("jax")
    import jax
    import jax.experimental.pallas as jpl

    from seismic_tpu.harness import device_probe as jdp

    calls, kept = [], []  # pallas_calls made; operands and output, once
    orig = jpl.pallas_call

    def recorder(kernel, *args, **kwargs):
        f = orig(kernel, *args, **dict(kwargs, interpret=True))
        calls.append(kernel)

        def call(*ops):
            out = f(*ops)
            jax.debug.callback(lambda *v: kept or kept.append(
                [np.array(x) for x in v]), *ops, out)
            return out

        return call

    monkeypatch.setattr(jpl, "pallas_call", recorder)
    monkeypatch.setattr(jdp, "timeit", lambda f, *a, reps=5: (
        jdp._sync(f(*a)), 1.0)[1])
    jdp.int8_cast_matmul()
    jax.effects_barrier()
    assert len(calls) == 1 and kept, "the JAX probe's kernel never ran"
    j_tile, j_q, j_out = kept[0]
    tile, q = _k17_case("probe")
    np.testing.assert_array_equal(j_tile, tile)
    np.testing.assert_array_equal(j_q, q)
    assert _within_tol(j_out, tile, q)[1]
    emu = _k17_emulated(tile, q)
    absum = np.abs(tile.astype(np.float64)) @ np.abs(q.astype(np.float64))
    assert (np.abs(emu.astype(np.float64) - j_out) <= 1e-6 * absum).all()


# ---- on the card ----


@pytest.mark.cuda
@pytest.mark.parametrize("V", [256, 512, 1024, 4104])
@pytest.mark.parametrize("R,scb", [(4, 8), (4, 16), (8, 8), (8, 16)])
def test_cuda_k9_matches_plain(V, R, scb):
    """On the card: K9 == its plain version bit for bit on the edge rows,
    quantized and f32 (V 4104 is past the former design's 4096 cap)."""
    dev = _card()
    ops = _edge_operands(V, R, scb, seed=V + 10 * R + scb)
    t = [x.to(dev) if isinstance(x, torch.Tensor) else x for x in ops]
    before = qloc_residue.launches
    got = qloc_residue.project_qloc_residue(*t)
    got_i8, got_sc = qloc_residue.project_qloc_residue(*t, quantize=True)
    torch.cuda.synchronize()
    assert qloc_residue.launches == before + 2
    want = qloc_residue.project_qloc_residue_plain(*t)
    want_i8, want_sc = qloc_residue.project_qloc_residue_plain(
        *t, quantize=True)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got_i8, want_i8) and torch.equal(got_sc, want_sc)
    assert (want != 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["probe", "edge", "edge_q_positive",
                                   (1, 1, 1), (100, 300, 40), (513, 7, 129),
                                   (33, 0, 17)])
def test_cuda_k17_within_tolerance(shape):
    """On the card: K17 within 1e-6 of sum_k |tile * q| of the f64 product
    at the probe's shape, on the edge tiles and at ragged shapes."""
    dev = _card()
    if isinstance(shape, str):
        tile, q = _k17_case(shape)
    else:
        M, K, N = shape
        rng = np.random.default_rng(M + K + N)
        tile = rng.integers(-128, 128, size=(M, K), dtype=np.int8)
        q = rng.normal(size=(K, N)).astype(np.float32)
    before = pk.launches["i8_matmul"]
    got = pk.i8_matmul(torch.from_numpy(tile).to(dev),
                       torch.from_numpy(q).to(dev))
    torch.cuda.synchronize()
    assert pk.launches["i8_matmul"] == before + 1
    assert got.shape == (tile.shape[0], q.shape[1])
    out = got.cpu().numpy()
    if tile.shape[1] == 0:
        assert not out.any()
        return
    share, ok = _within_tol(out, tile, q)
    assert ok, share
