"""Tile widths 128 and 384 on the grouped scorers (K2, K4, K6): every
multiple of 128 up to each kernel's shared-memory cap, as JAX's kernel
takes (`seismic_tpu/ops/pallas_grouped.py:76`, `V % 128 == 0`).

On the CPU: the wrappers' width check (`ops/grouped_scorer.py::
check_width`) accepts exactly JAX's rule up to the cap and names the cap
when it refuses; JAX's kernel refuses the same widths below the cap; K2's
plain version equals JAX's int8 kernel (interpret mode) at V 384.

On a machine with an NVIDIA card only (`cuda` marker; the card is looked
for inside each test): K4 and K2 at V 128, 384, 2048 (M 8) and each
library's cap over M {8, 16} x csub {1, 2}, unpacked (int dots exact with
unit scales, scaled output 1e-6 relative) and packed (bit-equal); K6 at V
128, 384 and 2048 (M 8) in bf16 / f32 x centred / fixup x M x csub x
pack_window {0, csub} to its tolerance (1e-5 of the larger of score and
centring term; its caps are in `test_torch_k6_k10_redesign.py`); each
library's cap the widest multiple of 128 whose rings and queries fit in
227 KB; a width off the rule or past the cap refused on the card.
The file imports JAX only inside the CPU parity test, so on the card it
runs alone:

    python -m pytest --noconftest -q -m cuda tests/test_torch_v128_cuda.py
"""

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

N_REGIONS, W_REAL, W_PAD, G_CAP = 9, 21, 11, 7
NEW_WIDTHS = (128, 384)
# (M, csub, bytes a query value) of each scorer's caps
CAP_CASES = [(M, csub, qb) for M in (8, 16) for csub in (1, 2)
             for qb in (1, 2, 6)]


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


def _operands(M, csub, V, seed):
    """Tiles (region 0 all zero, the padding items' region; 30% of the
    other codes 0), scales, int8 queries, f32 projections and their qsum;
    W_REAL real work items over regions 1.. then W_PAD padding items on
    region 0, group 0, slot 0."""
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


def _on(o, dev):
    return {k: torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray)
            else v for k, v in o.items()}


def _blocks(out, wg, ws, step):
    """[W_REAL, M, step]: the output blocks the real items wrote."""
    return torch.stack([out[int(g), :, int(s) * step:(int(s) + 1) * step]
                        for g, s in zip(wg[:W_REAL], ws[:W_REAL])])


# ---- on the CPU ----


@pytest.mark.parametrize("M,csub,qb", CAP_CASES)
def test_width_check_is_jax_rule_up_to_the_cap(M, csub, qb):
    """check_width accepts V iff V % 128 == 0 and 128 <= V <= cap at each
    scorer's cap (the rings' and queries' fit in 227 KB of shared memory,
    which the libraries compute; held on the card below)."""
    cap = _smem_cap(M, csub, qb)
    assert cap % 128 == 0 and cap >= 1024
    for V in (64, 128, 192, 256, 384, 640, 1000, 1024, cap - 64, cap,
              cap + 128):
        ok = V % 128 == 0 and 128 <= V <= cap
        if ok:
            grouped_scorer.check_width(V, cap, "scorer")
        else:
            with pytest.raises(ValueError, match=f"cap {cap}"):
                grouped_scorer.check_width(V, cap, "scorer")


def test_k2_plain_matches_jax_at_v384():
    """K2's plain version == JAX's int8 kernel in interpret mode at V 384
    (1e-6 relative on every block a real item covers); JAX's kernel
    refuses V 192, as the port's width check does."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from seismic_tpu.ops.pallas_grouped import score_grouped_pallas

    M, csub, V = 8, 1, 384
    o = _operands(M, csub, V, seed=384)
    wr, wg, ws = (o[k][:W_REAL] for k in ("wr", "wg", "ws"))
    n_sub = o["tiles"].shape[0] // SUB
    scale3d = np.broadcast_to(o["scale"].reshape(n_sub, 1, SUB),
                              (n_sub, 8, SUB))
    j_out = np.asarray(score_grouped_pallas(
        jnp.asarray(o["tiles"].view(np.int8)), jnp.asarray(scale3d),
        jnp.asarray(o["q8"]), jnp.asarray(wr), jnp.asarray(wg),
        jnp.asarray(ws), o["ll_max"], interpret=True, compute_dtype="i8",
        csub=csub))
    t = _on(o, "cpu")
    t_out = grouped_scorer.score_grouped_i8(
        t["tiles"], t["scale"], t["q8"], t["wr"][:W_REAL], t["wg"][:W_REAL],
        t["ws"][:W_REAL], o["ll_max"], csub)
    a = _blocks(t_out, wg, ws, SUB)
    b = _blocks(torch.from_numpy(np.array(j_out)), wg, ws, SUB)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    assert b.abs().max() > 0
    with pytest.raises(AssertionError):
        score_grouped_pallas(
            jnp.zeros((SUB, 192), jnp.int8), jnp.zeros((1, 8, SUB)),
            jnp.zeros((1, M, 192), jnp.int8), jnp.zeros(1, jnp.int32),
            jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.int32), SUB,
            interpret=True, compute_dtype="i8")
    with pytest.raises(ValueError, match="not a multiple of 128"):
        grouped_scorer.check_width(192, _smem_cap(M, csub, 1), "K2")


# ---- on the card ----

# the new widths, 2048 (M 8 had an instance of it before), and the cap
INT8_CASES = [(M, csub, V) for M in (8, 16) for csub in (1, 2)
              for V in NEW_WIDTHS + ((2048,) if M == 8 else ()) + ("cap",)]


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("M,csub,V", INT8_CASES)
def test_cuda_k4_new_widths(M, csub, V, packed):
    """On the card: K4 == its plain version at V 128 / 384 / 2048 and its
    cap (int dots exact, scaled 1e-6 relative; packed bit-equal), padding
    items zero."""
    dev = _card()
    if V == "cap":
        V = grouped_scorer_item.max_v(M, csub)
    o = _operands(M, csub, V, seed=1000 * M + 10 * csub + V)
    t = _on(o, dev)
    base = (t["tiles"], t["scale"], t["q8"], t["wr"], t["wg"], csub)
    if packed:
        args = base + (t["ws"], o["ll_max"], csub)
        got = grouped_scorer_item.score_grouped_i8_item(*args)
        want = grouped_scorer_item.score_grouped_i8_item_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
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


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("M,csub,V", INT8_CASES)
def test_cuda_k2_new_widths(M, csub, V, packed):
    """On the card: K2 == its plain version at V 128 / 384 / 2048 and its
    cap on every block a real item covers (1e-6 relative; packed
    bit-equal)."""
    dev = _card()
    if V == "cap":
        V = grouped_scorer.max_v(M, csub)
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


K6_CASES = [(dt, centred, M, csub, pw, V)
            for dt in ("bf16", "f32") for centred in (True, False)
            for M in (8, 16) for csub in (1, 2) for pw in sorted({0, csub})
            for V in NEW_WIDTHS + ((2048,) if M == 8 else ())]


@pytest.mark.cuda
@pytest.mark.parametrize("dt,centred,M,csub,pack_window,V", K6_CASES)
def test_cuda_k6_new_widths(dt, centred, M, csub, pack_window, V):
    """On the card: K6 == its plain version at V 128 / 384 / 2048 to 1e-5
    of the larger of score and centring term (packed: the unpacked values
    to that plus the index bits' rounding, row indices on >= 99.9% of the
    equal values)."""
    dev = _card()
    o = _operands(M, csub, V, seed=2000 * M + 10 * csub + V)
    t = _on(o, dev)
    args = (t["tiles"], t["scale"], t["qf"], t["qsum"] if centred else None,
            t["wr"][:W_REAL], t["wg"][:W_REAL], t["ws"][:W_REAL],
            o["ll_max"], csub, dt, pack_window)
    before = grouped_scorer_f.launches
    got = grouped_scorer_f.score_grouped_f(*args)
    want = grouped_scorer_f.score_grouped_f_plain(*args)
    torch.cuda.synchronize()
    assert grouped_scorer_f.launches == before + 1
    R = csub * SUB
    step = R // pack_window if pack_window else R
    k, p = (_blocks(x, o["wg"], o["ws"], step) for x in (got, want))
    wr, wg = o["wr"][:W_REAL], o["wg"][:W_REAL]
    rows = wr[:, None] * R + np.arange(R)
    mag = (np.abs(o["qsum"][wg])[:, :, None] * o["scale"][rows][:, None, :]
           if centred else np.zeros((W_REAL, M, R)))
    if not pack_window:
        tol = 1e-5 * torch.maximum(torch.from_numpy(mag).to(dev).float(),
                                   p.abs())
        assert ((k - p).abs() <= tol).all()
        assert p.abs().max() > 0
        return
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
@pytest.mark.parametrize("M,csub", [(8, 1), (8, 2), (16, 1), (16, 2)])
def test_cuda_caps_fill_shared_memory(M, csub):
    """On the card: each library's cap is the widest multiple of 128 whose
    rings and queries fit in 227 KB, and a width off the rule or past the
    cap is refused before a launch."""
    dev = _card()
    assert grouped_scorer.max_v(M, csub) == _smem_cap(M, csub, 1)
    assert grouped_scorer_item.max_v(M, csub) == _smem_cap(M, csub, 1)
    for dt, qb in (("bf16", 2), ("f32", 6)):
        assert grouped_scorer_f.max_v(M, csub, dt) == _smem_cap(M, csub, qb)
    cap = grouped_scorer.max_v(M, csub)
    for V in (192, cap + 128):
        o = _on(_operands(M, csub, V, seed=V), dev)
        before = grouped_scorer_item.launches
        with pytest.raises(ValueError, match="not a multiple of 128"):
            grouped_scorer_item.score_grouped_i8_item(
                o["tiles"], o["scale"], o["q8"], o["wr"], o["wg"], csub)
        assert grouped_scorer_item.launches == before
