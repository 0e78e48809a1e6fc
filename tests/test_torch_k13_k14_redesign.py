"""K13 and K14 as one round of loads each: the cases their designs have
to get right.

K13 (`u8_matvec_kernel` of `csrc/device_probe.cu`) gives a warp a row:
lane l takes the columns 16 l .. 16 l + 15 of each 512-column pass, adds
their 16 products in column order with fmaf, pass after pass, and the
warp's xor tree sums the lanes before lane 0 multiplies by scale[m].
K14 (`take_along_axis_kernel`) gives a warp a row, 4 rows a block, and
lane l the 4 columns c + l, c + 32 + l, c + 64 + l, c + 96 + l of each
128-column step c, with no division.

On the CPU, on inputs made with numpy from a seed:
- a NumPy emulation of K13's arithmetic (each fmaf rounding once,
  modelled exactly) stays within 1e-6 * sum_k |tile * q| * |scale| of an
  f64 product, on the JAX probe's inputs (seed 0, [512, 512]) and on
  shapes with K % 16 != 0, with M not a multiple of 4 warps and with rows
  wider than a pass; its lanes and passes cover each column of a row
  exactly once; it holds against the JAX `u8_tile_matmul` probe run in
  interpret mode;
- an emulation of K14's thread-to-(m, c) mapping covers every element
  exactly once, for C % 4 == 0 and != 0, with one column step and
  several, and row counts that fill the last block or not, and its
  output (indices < 0 and >= R giving 0) equals the plain
  version, `np.take_along_axis` and the JAX `take_along_axis_sublane`
  probe bit for bit.

On a machine with an NVIDIA card only (`cuda` marker; the card is looked
for inside each test): each kernel against its plain version at those
shapes (K14 bit for bit, K13 within its tolerance and equal to the
emulation bit for bit), one launch counted a call, and each C entry
point on an operand 4 bytes off a 16-byte boundary (K13's 4-byte
variant). This file imports neither JAX
nor the test configuration at module level, so on the card it also runs
alone:

    python -m pytest --noconftest -q -m cuda tests/test_torch_k13_k14_redesign.py
"""

import ctypes
from fractions import Fraction

import numpy as np
import pytest
import torch

from seismic_tpu_torch.harness import device_probe as tdp
from seismic_tpu_torch.ops import _cuda
from seismic_tpu_torch.ops import probe_kernels as pk

MV_PASS = 32 * 16  # K13: columns of a row a pass (32 lanes x 16)
TA_WARPS, TA_COLS = 4, 4 * 32  # K14: rows a block, columns a warp step


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _run_jax_probe(monkeypatch, name):
    """(operands, output) of the one pallas_call of JAX probe `name`, run
    in interpret mode."""
    pytest.importorskip("jax")
    import jax
    import jax.experimental.pallas as jpl

    from seismic_tpu.harness import device_probe as jdp

    calls, kept = [], []
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
    getattr(jdp, name)()
    jax.effects_barrier()
    assert len(calls) == 1 and kept, "the JAX probe's kernel never ran"
    return kept[0][:-1], kept[0][-1]


# ---- K13: the order of summation ----

K13_SHAPES = {  # (M, K): the probe's, K % 16 != 0, M % 4 != 0, wide rows
    "probe": (512, 512), "k100_m37": (37, 100), "k524_m9": (9, 524),
    "k1040_m6": (6, 1040), "k4_m1": (1, 4)}


def _k13_case(name):
    if name == "probe":
        a = tdp.u8_tile_matmul_inputs()
        return a["tile"], a["q"], a["scale"]
    M, K = K13_SHAPES[name]
    rng = np.random.default_rng(list(K13_SHAPES).index(name))
    tile = rng.integers(0, 256, size=(M, K), dtype=np.uint8)
    q = rng.normal(size=(K, 1)).astype(np.float32)
    scale = rng.normal(size=(M, 1)).astype(np.float32)
    return tile, q, scale


def _k13_columns(K):
    """[passes, 32 lanes, 16]: the column lane l adds j-th in pass p
    (16 l + j + 512 p), in the kernel's order."""
    passes = max(-(-K // MV_PASS), 1)
    return (np.arange(passes)[:, None, None] * MV_PASS
            + 16 * np.arange(32)[None, :, None] + np.arange(16))


def _fmaf(a, b, c):
    """fmaf(a, b, c) for f32 arrays whose product a * b is exact in f64
    (a u8 times an f32 is): a * b + c rounded once to f32. The f64 sum s
    and its error e (TwoSum: s + e == a * b + c) give it; rounding s to
    f32 is right unless s lies exactly halfway between two f32 values
    with e != 0, where e decides."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    s = p + c64
    bv = s - p
    e = (p - (s - bv)) + (c64 - bv)
    r = s.astype(np.float32)
    r64 = r.astype(np.float64)
    toward = np.where(s > r64, np.inf, -np.inf).astype(np.float32)
    o = np.nextafter(r, toward)  # r's other neighbour of s
    mid = (s != r64) & (s == (r64 + o.astype(np.float64)) / 2) & (e != 0)
    return np.where(mid, np.where(e > 0, np.maximum(r, o),
                                  np.minimum(r, o)), r).astype(np.float32)


def _k13_emulated(tile, q, scale):
    """The kernel's arithmetic, bit for bit: each lane's fmaf over its
    columns in order, columns past K left out; then the warp's butterfly
    sum (v += shfl_xor(v, off), off 16 .. 1) in f32; then one f32
    multiply by scale."""
    M, K = tile.shape
    t, qv = tile.astype(np.float32), q[:, 0]
    lanes = np.arange(32)
    part = np.zeros((M, 32), np.float32)
    for cols in _k13_columns(K):  # a pass
        for j in range(16):
            k = cols[:, j]
            ok = k < K
            kc = np.minimum(k, K - 1)
            fma = _fmaf(t[:, kc], np.broadcast_to(qv[kc], (M, 32)), part)
            part = np.where(ok[None, :], fma, part)
    for off in (16, 8, 4, 2, 1):
        part = part + part[:, lanes ^ off]  # f32 + f32: rounded to f32
    return (part[:, :1] * scale).astype(np.float32)


def _k13_ref(tile, q, scale):
    """(f64 product, tolerance 1e-6 * sum_k |tile * q| * |scale|)."""
    t64, q64 = tile.astype(np.float64), q.astype(np.float64)
    s64 = scale.astype(np.float64)
    return (t64 @ q64) * s64, 1e-6 * (t64 @ np.abs(q64)) * np.abs(s64)


def _within(out, want, tol):
    err = np.abs(np.asarray(out, np.float64) - want)
    return bool((err <= tol).all())


def _f32_of(v: Fraction):
    """v rounded to the nearest f32, ties to even."""
    f = np.float32(float(v))
    near = (f, np.nextafter(f, np.float32(np.inf)),
            np.nextafter(f, np.float32(-np.inf)))
    return min(near, key=lambda x: (abs(Fraction(float(x)) - v),
                                    int(np.array(x).view(np.int32)) & 1))


def test_k13_fmaf_model_rounds_once():
    """The emulated fmaf rounds a * b + c once. 65 * 16519105 * 2^-54 is
    2^-24 + 2^-54: added to 1 in f64 it rounds to 1 + 2^-24, halfway
    between two f32 values, where rounding twice goes to even (1) and
    rounding once goes up (1 + 2^-23). Also on random draws against exact
    rational arithmetic."""
    a = np.array([65, 65], np.float32)
    b = np.array([16519105 * 2.0 ** -54, -16519105 * 2.0 ** -54],
                 np.float32)
    c = np.array([1.0, -1.0], np.float32)
    want = np.array([1 + 2.0 ** -23, -1 - 2.0 ** -23], np.float32)
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (twice == c).all()  # the double rounding the model avoids
    np.testing.assert_array_equal(_fmaf(a, b, c), want)
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, 400).astype(np.float32)
    b = (rng.normal(size=400) * 2.0 ** rng.integers(-30, 4, 400)).astype(
        np.float32)
    c = rng.normal(size=400).astype(np.float32)
    got = _fmaf(a, b, c)
    for i in range(400):
        v = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(
            float(c[i]))
        assert got[i] == _f32_of(v)


@pytest.mark.parametrize("K", [4, 100, 512, 524, 1040])
def test_k13_lanes_cover_each_column_once(K):
    cols = _k13_columns(K).ravel()
    inside = cols[cols < K]
    assert np.array_equal(np.sort(inside), np.arange(K))
    # K % 4 == 0: a lane's columns inside the row are whole groups of 4
    grouped = _k13_columns(K).reshape(-1, 4) < K
    assert (grouped.all(1) | ~grouped.any(1)).all()
    # 4 warps a block, a warp a row: every row once, rows past M idle
    for M in (1, 37, 512):
        blocks = -(-M // 4)
        rows = (np.arange(blocks)[:, None] * 4 + np.arange(4)).ravel()
        assert np.array_equal(rows[rows < M], np.arange(M))


@pytest.mark.parametrize("case", list(K13_SHAPES))
def test_k13_emulated_order_within_tolerance(case):
    tile, q, scale = _k13_case(case)
    assert tile.shape == K13_SHAPES[case] and tile.shape[1] % 4 == 0
    ref, tol = _k13_ref(tile, q, scale)
    emu = _k13_emulated(tile, q, scale)
    assert emu.shape == ref.shape and _within(emu, ref, tol)
    # the CPU wrapper runs the plain version, within the same tolerance
    got = pk.u8_matvec(*(torch.from_numpy(x) for x in (tile, q, scale)))
    assert _within(got.numpy(), ref, tol)
    assert _within(emu, got.numpy().astype(np.float64), 2 * tol)


def test_k13_emulated_matches_jax_probe(monkeypatch):
    """The emulation against the JAX `u8_tile_matmul` probe, its Pallas
    kernel in interpret mode, on the probe's own draws (seed 0)."""
    (j_tile, j_q, j_scale), j_out = _run_jax_probe(monkeypatch,
                                                   "u8_tile_matmul")
    tile, q, scale = _k13_case("probe")
    for mine, theirs in ((tile, j_tile), (q, j_q), (scale, j_scale)):
        np.testing.assert_array_equal(mine, theirs)
    ref, tol = _k13_ref(tile, q, scale)
    assert _within(j_out, ref, tol)
    assert _within(_k13_emulated(tile, q, scale), j_out.astype(np.float64),
                   2 * tol)


# ---- K14: the thread-to-(m, c) mapping ----

K14_SHAPES = {  # (R, C, M): the probe's, C % 4 != 0, wide rows, M % 4 != 0
    "probe": (256, 128, 512), "c130": (40, 130, 9), "c3": (7, 3, 5),
    "c1000": (16, 1000, 6), "c1": (3, 1, 2)}


def _k14_case(name):
    """(table f32 [R, C], idx int32 [M, C]); outside the probe some
    indices are < 0 or >= R."""
    if name == "probe":
        a = tdp.take_along_axis_sublane_inputs()
        return a["table"], a["idx"]
    R, C, M = K14_SHAPES[name]
    rng = np.random.default_rng(100 + list(K14_SHAPES).index(name))
    table = rng.normal(size=(R, C)).astype(np.float32)
    idx = rng.integers(-3, R + 3, size=(M, C), dtype=np.int32)
    idx[0, 0], idx[-1, -1] = -(2 ** 31), R  # the extremes outside
    return table, idx


def _k14_elements(M, C):
    """Flat indices m * C + c of the elements the launch's threads write,
    one entry per write: ceil(M / 4) blocks of 128 threads; thread t of
    block x takes row 4 x + t // 32 (none past M) and the columns c, c +
    32, c + 64, c + 96 inside the row, c = t % 32, then c += 128 while
    c < C."""
    x, t = np.meshgrid(np.arange(-(-M // TA_WARPS)),
                       np.arange(32 * TA_WARPS), indexing="ij")
    m = (x * TA_WARPS + t // 32).ravel()
    c = (t % 32).ravel()
    live = m < M
    m, c = m[live], c[live]
    out = []
    while (c < C).any():
        for k in range(4):
            ok = c + 32 * k < C
            out.append(m[ok] * C + c[ok] + 32 * k)
        c = c + TA_COLS
    return np.concatenate(out) if out else np.zeros(0, np.int64)


def _k14_emulated(table, idx):
    R, C = table.shape
    M = idx.shape[0]
    out = np.full(M * C, np.nan, np.float32)
    e = _k14_elements(M, C)
    j, c = idx.ravel()[e], e % C
    ok = (j >= 0) & (j < R)
    out[e] = np.where(ok, table[np.clip(j, 0, R - 1), c], np.float32(0.0))
    return out.reshape(M, C)


def _k14_expect(table, idx):
    R = table.shape[0]
    ok = (idx >= 0) & (idx < R)
    got = np.take_along_axis(table, np.clip(idx, 0, R - 1), axis=0)
    return np.where(ok, got, np.float32(0.0))


@pytest.mark.parametrize("rows", ["case", 1, 7])
@pytest.mark.parametrize("case", list(K14_SHAPES))
def test_k14_mapping_covers_each_element_once(case, rows):
    R, C, M = K14_SHAPES[case]
    M = M if rows == "case" else rows
    writes = np.bincount(_k14_elements(M, C), minlength=M * C)
    assert writes.shape == (M * C,) and (writes == 1).all()


@pytest.mark.parametrize("case", list(K14_SHAPES))
def test_k14_emulated_equals_plain(case):
    table, idx = _k14_case(case)
    emu = _k14_emulated(table, idx)
    expect = _k14_expect(table, idx)
    np.testing.assert_array_equal(emu.view(np.int32), expect.view(np.int32))
    got = pk.take_along_axis(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  expect.view(np.int32))
    R = table.shape[0]
    outside = (idx < 0) | (idx >= R)
    if case == "probe":
        assert not outside.any()
    else:
        assert (idx < 0).any() and (idx >= R).any()
        assert not got.numpy()[outside].any()


def test_k14_emulated_matches_jax_probe(monkeypatch):
    """The emulation against the JAX `take_along_axis_sublane` probe, its
    Pallas kernel in interpret mode, bit for bit."""
    (j_table, j_idx), j_out = _run_jax_probe(monkeypatch,
                                             "take_along_axis_sublane")
    table, idx = _k14_case("probe")
    np.testing.assert_array_equal(j_table, table)
    np.testing.assert_array_equal(j_idx, idx)
    np.testing.assert_array_equal(
        _k14_emulated(table, idx).view(np.int32), j_out.view(np.int32))


# ---- on the card ----


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K13_SHAPES))
def test_cuda_k13_matches_plain(case):
    """On the card: K13 within its tolerance of the f64 product and of
    its plain version, and equal to the emulation bit for bit; one
    launch counted."""
    dev = _card()
    tile, q, scale = _k13_case(case)
    t = [torch.from_numpy(x).to(dev) for x in (tile, q, scale)]
    before = pk.launches["u8_matvec"]
    got = pk.u8_matvec(*t)
    plain = pk.u8_matvec_plain(*t)
    torch.cuda.synchronize()
    assert pk.launches["u8_matvec"] == before + 1
    assert got.shape == (tile.shape[0], 1)
    ref, tol = _k13_ref(tile, q, scale)
    got = got.cpu().numpy()
    assert _within(got, ref, tol)
    assert _within(got, plain.cpu().numpy().astype(np.float64), 2 * tol)
    np.testing.assert_array_equal(
        got.view(np.int32), _k13_emulated(tile, q, scale).view(np.int32))


@pytest.mark.cuda
def test_cuda_k13_unaligned_q_takes_the_4_byte_variant():
    """K % 16 == 0 but q 4 bytes off a 16-byte boundary: the C entry point
    launches the 4-byte variant, whose sums are the same."""
    dev = _card()
    tile, q, scale = _k13_case("probe")
    t = [torch.from_numpy(x).to(dev) for x in (tile, q, scale)]
    q_store = torch.zeros(q.size + 1, dtype=torch.float32, device=dev)
    q_off = q_store[1:]
    q_off.copy_(t[1].view(-1))
    assert q_off.data_ptr() % 16 == 4
    M, K = tile.shape
    out = torch.empty((M, 1), dtype=torch.float32, device=dev)
    p = _cuda.ptr
    rc = pk._lib().seismic_probe_u8_matvec(
        p(t[0]), p(q_off), p(t[2]), M, K, p(out),
        ctypes.c_void_p(_cuda.stream_handle(dev)))
    torch.cuda.synchronize()
    assert rc == 0
    vec = pk.u8_matvec(*t)
    assert torch.equal(out, vec)  # the same order of summation


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K14_SHAPES))
def test_cuda_k14_matches_plain(case):
    """On the card: K14 equals its plain version and the expectation bit
    for bit, indices outside the table giving 0; one launch counted."""
    dev = _card()
    table, idx = _k14_case(case)
    t, i = torch.from_numpy(table).to(dev), torch.from_numpy(idx).to(dev)
    before = pk.launches["take_along_axis"]
    got = pk.take_along_axis(t, i)
    plain = pk.take_along_axis_plain(t, i)
    torch.cuda.synchronize()
    assert pk.launches["take_along_axis"] == before + 1
    assert torch.equal(got, plain)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.int32),
                                  _k14_expect(table, idx).view(np.int32))


@pytest.mark.cuda
def test_cuda_k14_unaligned_idx():
    """idx 4 bytes off a 16-byte boundary (the wrapper sends only 16-byte
    aligned operands; the kernel reads idx 4 bytes at a time): the same
    result, bit for bit."""
    dev = _card()
    table, idx = _k14_case("c1000")
    t = torch.from_numpy(table).to(dev)
    store = torch.zeros(idx.size + 1, dtype=torch.int32, device=dev)
    i_off = store[1:]
    i_off.copy_(torch.from_numpy(idx).view(-1))
    assert i_off.data_ptr() % 16 == 4
    M, C = idx.shape
    out = torch.empty((M, C), dtype=torch.float32, device=dev)
    p = _cuda.ptr
    rc = pk._lib().seismic_probe_take_along_axis(
        p(t), table.shape[0], C, p(i_off), M * C, p(out),
        ctypes.c_void_p(_cuda.stream_handle(dev)))
    torch.cuda.synchronize()
    assert rc == 0
    np.testing.assert_array_equal(out.cpu().numpy().view(np.int32),
                                  _k14_expect(table, idx).view(np.int32))
