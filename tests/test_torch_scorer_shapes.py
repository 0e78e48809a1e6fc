"""The grouped scorers (K2, K4 and its packed epilogue K5, K6) at every
shape JAX's kernel takes up to M 32 query slots and csub 4 subtiles a
work item (`seismic_tpu/ops/pallas_grouped.py:76` asks only M % 8 == 0
and ll_max % (csub * 128) == 0).

On the CPU: the plain versions against JAX's `score_grouped_pallas` in
interpret mode at (M, csub) = (32, 2), (16, 4), (24, 3) and (32, 4) on a
few work items at V 128: the int8 scorer with unroll 1 (K2, slot-major)
and 8 (K4, item-major), unpacked and packed, int dots exact and 1e-6
relative; K6 bf16 centred to 1e-5 of the larger of score and centring
term. One headline search (`search_grouped_derive`, K4, hier pool) at M
32 on a csub-4 upload against JAX's `search_grouped_derive_jit` at a cut.
The wrappers' shape rule (every M % 8 == 0 to 32, csub 1 to 4) and its
refusal naming the caps.

On a machine with an NVIDIA card only (`cuda` marker; the card is looked
for inside each test): every new (M, csub) instance of K4, K2 (unpacked
and packed at pack_window csub) and K6 (bf16 / f32, centred, unpacked
and packed) against its plain version at V 128, V 512 and its cap, the
cap the widest multiple of 128 whose rings and queries fit in 227 KB, and
one step past each cap refused before a launch. The file imports JAX only
inside the CPU parity tests, so on the card it runs alone:

    python -m pytest --noconftest -q -m cuda tests/test_torch_scorer_shapes.py
"""

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

N_REGIONS, W_REAL, W_PAD, G_CAP = 6, 6, 2, 4
# the shapes the JAX parity cases take: past the former M 8 / 16 and
# csub 1 / 2 in M, in csub, in both, and at a middle M
JAX_SHAPES = [(32, 2), (16, 4), (24, 3), (32, 4)]
# every (M, csub) pair the kernels took no instance of before
NEW_PAIRS = [(M, c) for M in (8, 16, 24, 32) for c in (1, 2, 3, 4)
             if not (M in (8, 16) and c in (1, 2))]


@pytest.fixture(autouse=True)
def one_thread():
    """Each test on one torch thread: the plain versions' many small
    operations slow down sharply when six test workers each run a thread
    a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smem_cap(M, csub, q_bytes):
    """The widest multiple of 128 whose warps' rings (4 stages of 64 bytes
    of each of csub * 128 rows) and [M, V] queries (q_bytes a value: 1
    int8, 2 a bf16 term, 6 three of them) fit in 227 KB."""
    free = 232448 - 4 * 64 * csub * SUB
    return free // (M * q_bytes) // 128 * 128


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _operands(M, csub, V, seed, n_regions=N_REGIONS):
    """Tiles (region 0 all zero, the padding items' region; 30% of the
    other codes 0), scales, int8 queries, f32 projections and their qsum;
    W_REAL real work items over regions 1.. then W_PAD padding items on
    region 0, group 0, slot 0."""
    rng = np.random.default_rng(seed)
    rows = csub * SUB
    tiles = rng.integers(0, 256, size=(n_regions * rows, V), dtype=np.uint8)
    tiles[rng.random(tiles.shape) < 0.3] = 0
    tiles[:rows] = 0
    scale = rng.uniform(1e-3, 2.0, n_regions * rows).astype(np.float32)
    q8 = rng.integers(-127, 128, size=(G_CAP, M, V)).astype(np.int8)
    qf = (rng.random((G_CAP, M, V)) * 3
          * (rng.random((G_CAP, M, V)) < 0.1)).astype(np.float32)
    qsum = (128.0 * qf.sum(-1)).astype(np.float32)
    wr = np.concatenate([rng.integers(1, n_regions, W_REAL),
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


def _on(o, dev):
    return {k: torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray)
            else v for k, v in o.items()}


def _blocks(out, wg, ws, step):
    """[W_REAL, M, step]: the output blocks the real items wrote."""
    out = out if torch.is_tensor(out) else torch.from_numpy(np.array(out))
    return torch.stack([out[int(g), :, int(s) * step:(int(s) + 1) * step]
                        for g, s in zip(wg[:W_REAL], ws[:W_REAL])])


def _k6_mag(o, csub):
    """[W_REAL, M, ROWS]: the centring term |qsum| * scale of each real
    item's rows, the scale of K6's tolerance beside the score."""
    R = csub * SUB
    wr, wg = o["wr"][:W_REAL], o["wg"][:W_REAL]
    rows = wr[:, None] * R + np.arange(R)
    return np.abs(o["qsum"][wg])[:, :, None] * o["scale"][rows][:, None, :]


def _k6_tol(o, csub, p):
    """K6's tolerance on [W_REAL, M, ROWS] blocks: 1e-5 of the larger of
    the score and the centring term."""
    return 1e-5 * torch.maximum(
        torch.from_numpy(_k6_mag(o, csub)).to(p.device).float(), p.abs())


# ---- on the CPU ----


@pytest.mark.parametrize("M,csub", [(8, 1), (16, 2), (24, 3), (32, 4),
                                    (8, 4), (32, 1)])
def test_shape_rule_takes_every_m8_to_32_and_csub_to_4(M, csub):
    """check_shape takes every M % 8 == 0 up to 32 and csub 1-4, and
    refuses one step past either cap (and an M off the rule), naming the
    caps; the wrappers refuse before reaching a kernel."""
    grouped_scorer.check_shape(M, csub, "scorer")
    for bad_m, bad_c in ((M + 4, csub), (40, csub), (M, 5), (M, 0)):
        with pytest.raises(ValueError, match="up to 32, csub from 1 to 4"):
            grouped_scorer.check_shape(bad_m, bad_c, "scorer")
    assert (grouped_scorer.MAX_M, grouped_scorer.MAX_CSUB) == (32, 4)
    # a cap of each new shape is above the probes' V 512 in int8 and bf16
    assert _smem_cap(M, csub, 1) >= 512 and _smem_cap(M, csub, 2) >= 512


def _jax_scale3d(scale, csub):
    n_super = scale.shape[0] // (csub * SUB)
    return np.broadcast_to(scale.reshape(n_super, 1, csub * SUB),
                           (n_super, 8, csub * SUB))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("M,csub", JAX_SHAPES)
def test_int8_plain_matches_jax_interpret(M, csub, packed):
    """K2's plain version == JAX's int8 kernel (unroll 1) on every block a
    real item covers, and K4's == JAX's item-major kernel (unroll 8) on
    every item, padding items included: unpacked 1e-6 relative (int dots
    exact, checked against an int64 product), packed (pack_window csub,
    the stride pool's) bit-equal."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from seismic_tpu.ops.pallas_grouped import score_grouped_pallas

    V = 128
    o = _operands(M, csub, V, seed=100 * M + csub + 7 * packed)
    pw = csub if packed else 0
    jargs = (jnp.asarray(o["tiles"].view(np.int8)),
             jnp.asarray(_jax_scale3d(o["scale"], csub)),
             jnp.asarray(o["q8"]))
    t = _on(o, "cpu")
    wr, wg, ws = o["wr"], o["wg"], o["ws"]
    # unroll 1: slot-major over the real items
    j1 = np.asarray(score_grouped_pallas(
        *jargs, jnp.asarray(wr[:W_REAL]), jnp.asarray(wg[:W_REAL]),
        jnp.asarray(ws[:W_REAL]), o["ll_max"], interpret=True,
        compute_dtype="i8", csub=csub, pack_idx=packed,
        pack_window=max(pw, 1)))
    t1 = grouped_scorer.score_grouped_i8(
        t["tiles"], t["scale"], t["q8"], t["wr"][:W_REAL], t["wg"][:W_REAL],
        t["ws"][:W_REAL], o["ll_max"], csub, pw)
    step = csub * SUB // max(pw, 1)
    a, b = _blocks(t1, wg, ws, step), _blocks(j1, wg, ws, step)
    # unroll 8: item-major over all W_REAL + W_PAD = 8 items
    j8 = np.asarray(score_grouped_pallas(
        *jargs, jnp.asarray(wr), jnp.asarray(wg), jnp.asarray(ws),
        o["ll_max"], interpret=True, compute_dtype="i8", csub=csub,
        pack_idx=packed, pack_window=max(pw, 1), unroll=8))
    t8 = grouped_scorer_item.score_grouped_i8_item(
        t["tiles"], t["scale"], t["q8"], t["wr"], t["wg"], csub,
        t["ws"] if packed else None, o["ll_max"], pw)
    assert tuple(t8.shape) == j8.shape == (W_REAL + W_PAD, M, step)
    if packed:
        assert torch.equal(a, b)
        np.testing.assert_array_equal(t8.numpy(), j8)
        return
    torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    np.testing.assert_allclose(t8.numpy(), j8, rtol=1e-6, atol=0)
    assert not t8[W_REAL:].any() and b.abs().max() > 0
    dots = grouped_scorer.grouped_dots_plain(
        t["tiles"], t["q8"], t["wr"], t["wg"], rows_per_item=csub * SUB)
    R = csub * SUB
    for i in range(W_REAL):
        ref = (o["q8"][wg[i]].astype(np.int64)
               @ o["tiles"][wr[i] * R:(wr[i] + 1) * R].astype(np.int64).T)
        np.testing.assert_array_equal(dots[i].numpy(), ref)


@pytest.mark.parametrize("M,csub", JAX_SHAPES)
def test_k6_bf16_plain_matches_jax_interpret(M, csub):
    """K6's plain version in bf16, centred, == JAX's bf16 kernel in
    interpret mode to 1e-5 of the larger of score and centring term."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from seismic_tpu.ops.pallas_grouped import score_grouped_pallas

    V = 128
    o = _operands(M, csub, V, seed=300 + 10 * M + csub)
    wr, wg, ws = (o[k][:W_REAL] for k in ("wr", "wg", "ws"))
    qsum_l = np.broadcast_to(o["qsum"][:, :, None], (G_CAP, M, csub * SUB))
    j = np.asarray(score_grouped_pallas(
        jnp.asarray(o["tiles"].view(np.int8)),
        jnp.asarray(_jax_scale3d(o["scale"], csub)), jnp.asarray(o["qf"]),
        jnp.asarray(wr), jnp.asarray(wg), jnp.asarray(ws), o["ll_max"],
        interpret=True, compute_dtype="bf16", qsum=jnp.asarray(qsum_l),
        csub=csub))
    t = _on(o, "cpu")
    out = grouped_scorer_f.score_grouped_f(
        t["tiles"], t["scale"], t["qf"], t["qsum"], t["wr"][:W_REAL],
        t["wg"][:W_REAL], t["ws"][:W_REAL], o["ll_max"], csub, "bf16")
    R = csub * SUB
    p = _blocks(j, wg, ws, R)
    k = _blocks(out, wg, ws, R)
    assert ((k - p).abs() <= _k6_tol(o, csub, p)).all()
    assert p.abs().max() > 0


def test_headline_search_at_m32_on_csub4_matches_jax():
    """One headline search (`plan_caps` + `search_grouped_derive`: K1, K4
    at M 32 on a csub-4 upload, the hier pool, K3) against JAX's
    `search_grouped_derive_jit` (its kernels in interpret mode) at a cut:
    >= 98% of queries with equal top-10 id sets, scores < 1e-3 relative
    (the repo's gate, bench.py:355-360)."""
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

    K, QC, V0, CSUB, M = 10, 13, 128, 4, 32
    ds = make_random_dataset(np.random.default_rng(0), n_docs=300, dim=400,
                             min_nnz=15, max_nnz=40, seed=42)
    cfg = Configuration(layout=TpuLayout(max_block_len=16,
                                         summary_vocab_cap=256,
                                         tile_overflow=16))
    full = build_index(ds, cfg, value_dtype="f32")
    ta = narrow_vocab(from_jax_arrays(
        {f.name: getattr(full, f.name) for f in dataclasses.fields(full)}),
        V0)
    ja = j_narrow(full, V0)
    qc, qv = make_random_queries(np.random.default_rng(1), n_queries=40,
                                 dim=400, min_nnz=8, max_nnz=30)
    q_comps, q_vals = pad_queries(qc, qv, 64)
    ctx = PlannerContext.from_arrays(ta, csub=CSUB)
    jctx = JCtx.from_arrays(ja, csub=CSUB)
    G_cap, W_cap = tgrouped.plan_caps(q_comps, q_vals, ctx, QC, M=M)

    def params(cls):  # probe_r5b's m32 rung (bench.py's headline recipe)
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


# ---- on the card ----


def _widths(cap):
    return sorted({128, 512, cap})


INT8_CASES = [(M, c, V) for M, c in NEW_PAIRS
              for V in _widths(_smem_cap(M, c, 1))]


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("M,csub,V", INT8_CASES)
def test_cuda_k4_new_shapes(M, csub, V, packed):
    """On the card: K4 at a new (M, csub) == its plain version at V 128,
    512 and its cap (int dots exact with unit scales, scaled 1e-6
    relative, padding items zero; packed at pack_window csub, K5,
    bit-equal)."""
    dev = _card()
    assert grouped_scorer_item.max_v(M, csub) == _smem_cap(M, csub, 1)
    o = _operands(M, csub, V, seed=1000 * M + 10 * csub + V)
    t = _on(o, dev)
    base = (t["tiles"], t["scale"], t["q8"], t["wr"], t["wg"], csub)
    before = grouped_scorer_item.launches
    if packed:
        args = base + (t["ws"], o["ll_max"], csub)
        got = grouped_scorer_item.score_grouped_i8_item(*args)
        want = grouped_scorer_item.score_grouped_i8_item_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert grouped_scorer_item.launches == before + 1
        return
    got = grouped_scorer_item.score_grouped_i8_item(*base)
    want = grouped_scorer_item.score_grouped_i8_item_plain(*base)
    dots = grouped_scorer_item.score_grouped_i8_item(
        t["tiles"], torch.ones_like(t["scale"]), *base[2:])
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    assert torch.equal(dots, grouped_scorer.grouped_dots_plain(
        t["tiles"], t["q8"], t["wr"], t["wg"],
        rows_per_item=csub * SUB).to(torch.float32))
    assert not got[W_REAL:].any() and got[:W_REAL].any()
    assert grouped_scorer_item.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("M,csub,V", INT8_CASES)
def test_cuda_k2_new_shapes(M, csub, V, packed):
    """On the card: K2 at a new (M, csub) == its plain version at V 128,
    512 and its cap on every block a real item covers (1e-6 relative;
    packed at pack_window csub, bit-equal)."""
    dev = _card()
    assert grouped_scorer.max_v(M, csub) == _smem_cap(M, csub, 1)
    o = _operands(M, csub, V, seed=1000 * M + 10 * csub + V + 1)
    t = _on(o, dev)
    args = (t["tiles"], t["scale"], t["q8"], t["wr"][:W_REAL],
            t["wg"][:W_REAL], t["ws"][:W_REAL], o["ll_max"], csub,
            csub if packed else 0)
    got = grouped_scorer.score_grouped_i8(*args)
    want = grouped_scorer.score_grouped_i8_plain(*args)
    torch.cuda.synchronize()
    step = SUB if packed else csub * SUB
    a, b = (_blocks(x, o["wg"], o["ws"], step) for x in (got, want))
    if packed:
        assert torch.equal(a, b)
    else:
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
        assert b.abs().max() > 0


K6_CASES = [(dt, M, c, pw, V) for dt, qb in (("bf16", 2), ("f32", 6))
            for M, c in NEW_PAIRS for pw in (0, c)
            for V in _widths(_smem_cap(M, c, qb))]


@pytest.mark.cuda
@pytest.mark.parametrize("dt,M,csub,pack_window,V", K6_CASES)
def test_cuda_k6_new_shapes(dt, M, csub, pack_window, V):
    """On the card: K6 (centred) at a new (M, csub) == its plain version at
    V 128, 512 and its cap to 1e-5 of the larger of score and centring
    term (packed: the values to that plus the index bits' rounding, the
    rows on >= 99.9% of the equal values)."""
    dev = _card()
    assert grouped_scorer_f.max_v(M, csub, dt) == _smem_cap(
        M, csub, 2 if dt == "bf16" else 6)
    o = _operands(M, csub, V, seed=2000 * M + 10 * csub + V)
    t = _on(o, dev)
    args = (t["tiles"], t["scale"], t["qf"], t["qsum"], t["wr"][:W_REAL],
            t["wg"][:W_REAL], t["ws"][:W_REAL], o["ll_max"], csub, dt,
            pack_window)
    before = grouped_scorer_f.launches
    got = grouped_scorer_f.score_grouped_f(*args)
    want = grouped_scorer_f.score_grouped_f_plain(*args)
    torch.cuda.synchronize()
    assert grouped_scorer_f.launches == before + 1
    R = csub * SUB
    step = R // pack_window if pack_window else R
    k, p = (_blocks(x, o["wg"], o["ws"], step) for x in (got, want))
    if not pack_window:
        assert ((k - p).abs() <= _k6_tol(o, csub, p)).all()
        assert p.abs().max() > 0
        return
    mag = _k6_mag(o, csub)
    (kv, ko), (pv, po) = (pack_epilogue.unpack(x, o["ll_max"])
                          for x in (k, p))
    mag_w = torch.from_numpy(
        mag.reshape(W_REAL, M, pack_window, step).max(2)).to(dev).float()
    tol = 1e-5 * mag_w + pv.abs() * (
        2.0 ** (pack_epilogue.idx_bits(o["ll_max"]) - 23) + 1e-5)
    assert ((kv - pv).abs() <= tol).all()
    same = kv == pv
    assert same.float().mean().item() > 0.5
    assert (ko[same] == po[same]).float().mean().item() >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("M,csub", NEW_PAIRS)
def test_cuda_refuses_one_step_past_each_cap(M, csub):
    """On the card: one multiple of 128 past each library's cap at a new
    (M, csub), and a shape past M 32 or csub 4, are refused before a
    launch, naming the cap."""
    dev = _card()
    caps = {"i8": grouped_scorer.max_v(M, csub),
            "item": grouped_scorer_item.max_v(M, csub),
            "bf16": grouped_scorer_f.max_v(M, csub, "bf16"),
            "f32": grouped_scorer_f.max_v(M, csub, "f32")}
    counts = (grouped_scorer.launches, grouped_scorer_item.launches,
              grouped_scorer_f.launches)
    for key, cap in caps.items():
        o = _on(_operands(M, csub, cap + 128, seed=cap, n_regions=2), dev)
        w = (o["wr"][:W_REAL], o["wg"][:W_REAL], o["ws"][:W_REAL])
        with pytest.raises(ValueError, match=f"cap {cap}"):
            if key == "i8":
                grouped_scorer.score_grouped_i8(
                    o["tiles"], o["scale"], o["q8"], *w, o["ll_max"], csub)
            elif key == "item":
                grouped_scorer_item.score_grouped_i8_item(
                    o["tiles"], o["scale"], o["q8"], w[0], w[1], csub)
            else:
                grouped_scorer_f.score_grouped_f(
                    o["tiles"], o["scale"], o["qf"], o["qsum"], *w,
                    o["ll_max"], csub, key)
    # past the shapes: the libraries report no cap there, the wrappers
    # refuse before asking
    assert grouped_scorer.max_v(M + 8, csub) == (
        0 if M == 32 else _smem_cap(M + 8, csub, 1))
    assert grouped_scorer_item.max_v(M, 5) == 0
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="up to 32, csub from 1 to 4"):
        grouped_scorer_item.score_grouped_i8_item(
            torch.zeros((5 * SUB, 128), dtype=torch.uint8, device=dev),
            torch.ones(5 * SUB, device=dev),
            torch.zeros((1, M, 128), dtype=torch.int8, device=dev), one, one,
            5)
    assert (grouped_scorer.launches, grouped_scorer_item.launches,
            grouped_scorer_f.launches) == counts
