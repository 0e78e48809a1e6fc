"""K6 on the bf16 tensor cores and K10 read through the caches: the cases
their designs have to get right.

On the CPU, on inputs made with numpy from a seed:
- `split_bf16x3`, the query operand of K6's f32 mode (three bf16 terms),
  sums back to q exactly (in f64) over the modes cell's projection values
  (sums of 1-3 query weights drawn as `synth_dataset` draws them, 0.03 to
  ~30) and over 1e-6 .. 1e6;
- the product the f32 mode computes from it (each term times the integer
  codes, u8 - 128 centred or u8 in the fixup form, summed in f32, plus qsum,
  times the tile scale) stays within K6's tolerance of an f64 product and
  of the JAX package's `score_grouped_pallas(compute_dtype="f32")` in
  interpret mode: 1e-5 of the larger of the score and the centring term
  |qsum * scale| (1e-5 relative in the fixup form);
- `table_take` on CPU tensors takes a table larger than the 58,112 entries
  the former shared-memory design could hold, out-of-range indices giving 0.

On a machine with an NVIDIA card only (`cuda` marker; the card is looked
for inside each test): K6 against its plain version for bf16 / f32 x
centred / fixup x M {8, 16} x csub {1, 2} x pack_window {0, 1, 2 where
csub 2} at V 256, 512, 1024 and the kernel's widest V (`max_v`), to the
same tolerance (packed: the unpacked score to it plus the index bits the
pack clears, the row wherever both name the same score); K10 against its
plain version bit for bit for n = 0, n not a multiple of 4, an idx view
that is not 16-byte aligned and a table over 58,112 entries. This file
imports neither JAX nor the test configuration at module level, so on the
card it also runs alone:

    python -m pytest --noconftest -q -m cuda tests/test_torch_k6_k10_redesign.py
"""

import numpy as np
import pytest
import torch

from seismic_tpu_torch.ops import grouped_scorer_f, pack_epilogue
from seismic_tpu_torch.ops import probe_kernels as pk
from seismic_tpu_torch.ops.tiles_prep import SUB

OLD_TAKE_MAX = 232448 // 4  # entries the former K10 staged at most


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _projections(rng, shape, density=0.1):
    """f32 values like K1's projections: mostly 0, else the sum of 1-3
    query weights drawn as synth_dataset draws them."""
    w = np.zeros(shape, np.float32)
    for _ in range(3):
        w += ((rng.random(shape) < 0.5)
              * (rng.gamma(2.0, 0.7, size=shape) + 0.03)).astype(np.float32)
    return (w * (rng.random(shape) < density)).astype(np.float32)


# ---- K6's three-term split ----


@pytest.mark.parametrize("values", ["modes_cell", "log_uniform"])
def test_split_bf16x3_reconstructs_q(values):
    rng = np.random.default_rng(5)
    if values == "modes_cell":
        q = _projections(rng, (4096,), density=1.0)
        q = q[q > 0]
    else:
        q = (10.0 ** rng.uniform(-6, 6, 4096)
             * rng.choice([-1.0, 1.0], 4096)).astype(np.float32)
    qt = torch.from_numpy(q)
    hi, mid, lo = grouped_scorer_f.split_bf16x3(qt)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, qt.to(torch.bfloat16))
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, qt.double())
    # each term is at most half an ulp of bf16 of the one before
    assert (mid.double().abs() <= hi.double().abs() * 2.0 ** -8).all()
    assert (lo.double().abs() <= mid.double().abs() * 2.0 ** -8).all()
    assert (mid != 0).float().mean() > 0.5  # the split is really needed


# ---- the product K6's f32 mode emulates ----
N_REGIONS, W_REAL, G_CAP = 7, 12, 5


def _f32_operands(M, csub, V, seed):
    """Tiles (30% of the codes 0, region 0 all 0), scales, projections,
    qsum = 128 * sum_v q, and W_REAL real work items."""
    rng = np.random.default_rng(seed)
    rows = csub * SUB
    tiles = rng.integers(0, 256, size=(N_REGIONS * rows, V), dtype=np.uint8)
    tiles[rng.random(tiles.shape) < 0.3] = 0
    tiles[:rows] = 0
    scale = rng.uniform(1e-3, 2.0, N_REGIONS * rows).astype(np.float32)
    q = _projections(rng, (G_CAP, M, V))
    q[0, 0, :8] = np.float32([1e-5, 3e-4, 7e-3, 0.11, 2.5, 9.75, 17.3, 29.9])
    qsum = (128.0 * q.sum(-1)).astype(np.float32)
    wr = rng.integers(1, N_REGIONS, W_REAL).astype(np.int32)
    wg = np.sort(rng.integers(0, G_CAP, W_REAL)).astype(np.int32)
    ws = np.zeros_like(wg)
    for g in range(G_CAP):
        mine = np.flatnonzero(wg == g)
        ws[mine] = np.arange(len(mine))
    ll_max = rows * (int(ws.max()) + 1)
    return tiles, scale, q, qsum, wr, wg, ws, ll_max


def _emulated_f32_mode(tiles, scale, q, qsum, wr, wg, csub, centred):
    """[W, M, ROWS]: each bf16 term of q times the codes (u8 - 128 or u8),
    summed in f32, term by term, then + qsum and x scale, as the kernel's
    f32 mode does (the order of its f32 sum aside)."""
    rows = wr[:, None] * csub * SUB + np.arange(csub * SUB)
    a = torch.from_numpy(tiles[rows]).to(torch.float32)  # [W, R, V]
    if centred:
        a = a - 128.0
    qg = torch.from_numpy(q[wg])  # [W, M, V]
    s = torch.zeros((len(wr), q.shape[1], rows.shape[1]), dtype=torch.float32)
    for term in grouped_scorer_f.split_bf16x3(qg):
        s = s + torch.bmm(term.to(torch.float32), a.transpose(1, 2))
    if centred:
        s = s + torch.from_numpy(qsum[wg])[:, :, None]
    return (s * torch.from_numpy(scale[rows])[:, None, :]).numpy()


def _k6_tol(ref, qsum, scale, wr, wg, csub, centred):
    """K6's tolerance for each [W, M, ROWS] score."""
    mag = np.abs(ref).astype(np.float64)
    if centred:
        rows = wr[:, None] * csub * SUB + np.arange(csub * SUB)
        mag = np.maximum(mag, np.abs(qsum[wg])[:, :, None]
                         * scale[rows][:, None, :])
    return 1e-5 * mag


@pytest.mark.parametrize("csub", [1, 2])
@pytest.mark.parametrize("centred", [True, False])
def test_split_product_within_tolerance_of_f64_and_jax(centred, csub):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from seismic_tpu.ops.pallas_grouped import score_grouped_pallas

    M, V = 8, 256
    R = csub * SUB
    tiles, scale, q, qsum, wr, wg, ws, ll_max = _f32_operands(
        M, csub, V, seed=30 + csub)
    got = _emulated_f32_mode(tiles, scale, q, qsum, wr, wg, csub, centred)

    rows = wr[:, None] * R + np.arange(R)
    a = tiles[rows].astype(np.float64) - (128.0 if centred else 0.0)
    exact = np.einsum("wmv,wrv->wmr", q[wg].astype(np.float64), a)
    if centred:
        exact += qsum[wg].astype(np.float64)[:, :, None]
    exact *= scale[rows].astype(np.float64)[:, None, :]
    tol = _k6_tol(exact, qsum, scale, wr, wg, csub, centred)
    assert (np.abs(got - exact) <= tol).all()

    scale3d = np.ascontiguousarray(np.broadcast_to(
        scale.reshape(N_REGIONS, 1, R), (N_REGIONS, 8, R)))
    j_out = np.asarray(score_grouped_pallas(
        jnp.asarray(tiles.view(np.int8)), jnp.asarray(scale3d),
        jnp.asarray(q), jnp.asarray(wr), jnp.asarray(wg), jnp.asarray(ws),
        ll_max, interpret=True, compute_dtype="f32", csub=csub,
        qsum=(jnp.broadcast_to(jnp.asarray(qsum)[..., None], (G_CAP, M, R))
              if centred else None)))
    j = np.stack([j_out[g, :, s * R:(s + 1) * R] for g, s in zip(wg, ws)])
    tol = _k6_tol(j, qsum, scale, wr, wg, csub, centred)
    assert (np.abs(got - j) <= tol).all()
    assert np.abs(j).max() > 0


# ---- K10 on the CPU: no cap on the table ----


def test_table_take_cpu_beyond_former_cap():
    rng = np.random.default_rng(8)
    n = OLD_TAKE_MAX + 4099
    table = rng.normal(size=n).astype(np.float32)
    idx = rng.integers(0, n, size=(37, 11)).astype(np.int32)
    idx[0, :6] = [-1, n, n + 5, -(2 ** 31), 2 ** 31 - 1, n - 1]
    before = pk.launches["table_take"]
    got = pk.table_take(torch.from_numpy(table), torch.from_numpy(idx))
    assert pk.launches["table_take"] == before  # CPU: the plain version
    ok = (idx >= 0) & (idx < n)
    want = np.where(ok, table[np.clip(idx, 0, n - 1)], 0.0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 5].item() == table[n - 1]


# ---- on the card ----


def _k6_cases():
    cases = []
    for dt in ("bf16", "f32"):
        for centred in (True, False):
            for M in (8, 16):
                for csub in (1, 2):
                    for pw in (0, 1, 2):
                        if pw <= csub:
                            for V in (256, 512, 1024, "max"):
                                cases.append((dt, centred, M, csub, pw, V))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("dt,centred,M,csub,pack_window,V", _k6_cases())
def test_cuda_k6_matches_plain(dt, centred, M, csub, pack_window, V):
    """On the card: K6 == its plain version to its tolerance on every
    block a real work item covers."""
    dev = _card()
    if V == "max":
        V = grouped_scorer_f.max_v(M, csub, dt)
        assert V >= 1024
    tiles, scale, q, qsum, wr, wg, ws, ll_max = _f32_operands(
        M, csub, V, seed=1000 * M + 10 * csub + V // 256)
    t = [torch.from_numpy(x).to(dev) for x in (tiles, scale, q, qsum, wr,
                                              wg, ws)]
    args = (t[0], t[1], t[2], t[3] if centred else None, t[4], t[5], t[6],
            ll_max, csub, dt, pack_window)
    before = grouped_scorer_f.launches
    got = grouped_scorer_f.score_grouped_f(*args)
    want = grouped_scorer_f.score_grouped_f_plain(*args)
    torch.cuda.synchronize()
    assert grouped_scorer_f.launches == before + 1
    R = csub * SUB
    step = R // pack_window if pack_window else R
    k, p = (torch.stack([out[g, :, s * step:(s + 1) * step]
                         for g, s in zip(wg, ws)]) for out in (got, want))
    rows = wr[:, None] * R + np.arange(R)
    mag = (np.abs(qsum[wg])[:, :, None] * scale[rows][:, None, :]
           if centred else np.zeros((W_REAL, M, R)))
    if not pack_window:
        tol = 1e-5 * torch.maximum(torch.from_numpy(mag).to(dev).float(),
                                   p.abs())
        assert ((k - p).abs() <= tol).all()
        assert p.abs().max() > 0
        return
    (kv, ko), (pv, po) = (pack_epilogue.unpack(x, ll_max) for x in (k, p))
    mag_w = torch.from_numpy(
        mag.reshape(W_REAL, M, pack_window, step).max(2)).to(dev).float()
    tol = (1e-5 * mag_w + pv.abs() * (
        2.0 ** (pack_epilogue.idx_bits(ll_max) - 23) + 1e-5))
    assert ((kv - pv).abs() <= tol).all()
    same = kv == pv
    assert same.float().mean().item() > 0.5
    assert (ko[same] == po[same]).float().mean().item() >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["empty", "n_mod_4", "unaligned_view",
                                  "beyond_former_cap", "probe_shape"])
def test_cuda_k10_matches_plain(case):
    """On the card: K10 == its plain version bit for bit, out-of-range
    indices giving 0."""
    dev = _card()
    rng = np.random.default_rng(["empty", "n_mod_4", "unaligned_view",
                                 "beyond_former_cap",
                                 "probe_shape"].index(case))
    n = {"beyond_former_cap": OLD_TAKE_MAX * 3 + 1}.get(case, 30720)
    table = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
    size = {"empty": 0, "n_mod_4": 4097, "unaligned_view": 8195}.get(
        case, 64 * 128)
    idx_np = rng.integers(-3, n + 3, size=size + 1).astype(np.int32)
    idx = torch.from_numpy(idx_np).to(dev)
    if case == "unaligned_view":
        idx = idx[1:]  # 4 bytes past a 16-byte boundary
        assert idx.data_ptr() % 16 == 4 and idx.is_contiguous()
    else:
        idx = idx[:size]
    if case == "probe_shape":
        idx = idx.view(64, 128)
    before = pk.launches["table_take"]
    got = pk.table_take(table, idx)
    want = pk.table_take_plain(table, idx)
    torch.cuda.synchronize()
    assert pk.launches["table_take"] == before + 1
    assert got.shape == idx.shape and torch.equal(got, want)
    if size:
        assert (got[(idx < 0) | (idx >= n)] == 0).all()
