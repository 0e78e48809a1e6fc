"""K11 and K15, one kernel: the cases its design has to get right.

K11 (`row_gather`) and K15 (`flat_row_gather`) launch one kernel,
`row_gather_kernel` of `csrc/device_probe.cu`: blocks of 8 warps, a warp
a row (row r in warp r % 8 of block r // 8), lane l reading the 16-byte
columns l, l + 32, ... of row idx[r] and storing each to row r of the
output; rows outside the table (K11: j < 0 or j >= n; K15: j < 0 or
j * W + W > n) read nothing and are stored as 0; byte offsets are 64-bit.
A ring of bulk copies through shared memory and a register design with a
few rows a warp were measured against it on the card and did not beat it
(PERF.md, `harness/row_gather_probe.py`).

On the CPU, on inputs made with numpy from a seed:
- an emulation of that mapping (rows -> blocks -> warps -> lanes ->
  16-byte columns), its block size and launch read from the source,
  writes every output element exactly once and equals `row_gather_plain`
  / `flat_row_gather_plain` bit for bit, at six (W, R) pairs that take
  each W of 4, 12, 256, 260, 1028 and 4096 (one pass of a warp, a partial
  pass, many passes) and each R of 1, 31, 133, 1001, 4096 and 4097 (a
  last block partly full) once, with ids -1, n, the int32 extremes and,
  for K15, the last row that fits in the flat table and the first that
  does not;
- every load's and store's byte offset is a multiple of 16; offsets past
  2^31 (a nominal 4 GB table and a 2 GB output, addresses only) are
  computed exactly.

On a machine with an NVIDIA card only (`cuda` marker; the card is looked
for inside each test): each entry point against its plain version bit for
bit at every W with every R of those (W 1028 and 4096 at R up to 1001), one launch counted a call; a 4.4 GB table read at
byte offsets past 2^32; an operand off a 16-byte boundary refused. This
file imports neither JAX nor the test configuration at module level, so
on the card it also runs alone:

    python -m pytest --noconftest -q -m cuda tests/test_torch_k11_k15_redesign.py
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from seismic_tpu_torch.ops import probe_kernels as pk

SRC = (Path(pk.__file__).resolve().parents[1] / "csrc"
       / "device_probe.cu").read_text()
INT32_EXTREMES = (-(2 ** 31), 2 ** 31 - 1)

# (W, R) on the card: every small width at every R, the wide rows at fewer
CASES = ([(w, r) for w in (4, 12, 256, 260)
          for r in (1, 31, 133, 4096, 4097)]
         + [(w, r) for w in (1028, 4096) for r in (1, 31, 133, 1001)])
# on the CPU: each W and each R of those once
CPU_CASES = [(4, 4097), (12, 31), (256, 4096), (260, 133), (1028, 1),
             (4096, 1001)]


# rows a block: kThreads / 32 of the source (test_launch_geometry)
WARPS = int(re.search(r"constexpr int kThreads = (\d+);", SRC)[1]) // 32


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _case(W, R, flat):
    """(table f32 words, n: rows [K11] or elements [K15], idx int32 [R]).
    The table holds 37 rows (K15: and half a row more); idx is random over
    [-2, rows + 2) with the edge ids first."""
    rng = np.random.default_rng(W * 100_003 + R * 7 + flat)
    rows = 37
    extra = W // 2 if flat else 0
    table = rng.normal(size=rows * W + extra).astype(np.float32)
    n = rows * W + extra if flat else rows
    idx = rng.integers(-2, rows + 2, size=R).astype(np.int32)
    edge = [-1, rows, *INT32_EXTREMES, rows - 1, 0]
    idx[:min(R, len(edge))] = edge[:R]
    return table, n, idx


def _valid(idx, n, W, flat):
    j = idx.astype(np.int64)
    return (j >= 0) & ((j * W + W <= n) if flat else (j < n))


def _accesses(R, W, idx, valid, rows=None):
    """Every 16-byte store of the launch (of `rows` only, where given),
    with its load: int64 arrays block, thread, row, col (the float4
    column), src (byte offset of the load, -1 for a row outside the
    table) and dst (of the store)."""
    W4 = W // 4
    passes = -(-W4 // 32)
    rows = np.arange(R, dtype=np.int64) if rows is None else rows
    row = np.repeat(rows, 32 * passes)
    lane = np.tile(np.repeat(np.arange(32, dtype=np.int64), passes),
                   rows.size)
    col = lane + 32 * np.tile(np.arange(passes, dtype=np.int64),
                              32 * rows.size)
    live = col < W4
    row, lane, col = row[live], lane[live], col[live]
    j = idx[row].astype(np.int64)
    return dict(block=row // WARPS, thread=(row % WARPS) * 32 + lane,
                row=row, col=col,
                src=np.where(valid[row], j * 4 * W + 16 * col, -1),
                dst=row * 4 * W + 16 * col)


def _emulate(table, n, idx, W, flat):
    """(output f32 [R, W], stores of each output float4)."""
    R = idx.size
    a = _accesses(R, W, idx, _valid(idx, n, W, flat))
    assert (a["thread"] < 32 * WARPS).all()
    assert (a["block"] < -(-R // WARPS)).all()
    for key in ("src", "dst"):
        assert (a[key][a[key] >= 0] % 16 == 0).all(), key
    out = np.full((R * W // 4, 4), np.nan, np.float32)
    t4 = table[:table.size // 4 * 4].reshape(-1, 4)
    ok = a["src"] >= 0
    out[a["dst"] // 16] = np.where(ok[:, None],
                                   t4[np.where(ok, a["src"] // 16, 0)], 0.0)
    stores = np.bincount(a["dst"] // 16, minlength=R * W // 4)
    return out.reshape(R, W), stores


def _plain(table, n, idx, W, flat):
    if flat:
        return pk.flat_row_gather_plain(torch.from_numpy(table),
                                        torch.from_numpy(idx), W).numpy()
    return pk.row_gather_plain(torch.from_numpy(table.reshape(n, W)),
                               torch.from_numpy(idx)).numpy()


@pytest.mark.parametrize("flat", [False, True], ids=["k11", "k15"])
@pytest.mark.parametrize("W,R", CPU_CASES)
def test_emulated_mapping_equals_plain(W, R, flat):
    table, n, idx = _case(W, R, flat)
    out, stores = _emulate(table, n, idx, W, flat)
    assert (stores == 1).all()  # every output float4 stored exactly once
    plain = _plain(table, n, idx, W, flat)
    np.testing.assert_array_equal(out.view(np.int32), plain.view(np.int32))
    valid = _valid(idx, n, W, flat)
    if R >= 6:  # the edge ids: -1, one past, the int32 extremes outside
        assert not valid[:4].any() and valid[4:6].all()
        assert not out[~valid].any()
    if flat and R >= 5:  # the last row that fits; the next is partial
        assert idx[4] == (n - W) // W
        assert not _valid(idx[4:5] + 1, n, W, True).any()


def test_launch_geometry():
    """The emulation's geometry is the source's: both entry points launch
    row_gather_kernel over blocks of kWarps = kThreads / 32 rows."""
    assert "constexpr int kWarps = kThreads / 32;" in SRC
    launches = re.findall(r"row_gather_kernel<(true|false)><<<([^>]*)>>>", SRC)
    assert sorted(f for f, _ in launches) == ["false", "true"]
    for _, grid in launches:
        assert grid.replace(" ", "") == "blocks_for(R,kWarps),kThreads,0,stream"
    assert re.search(r"blocks_for\(int64_t n, int per_block\) \{\s*"
                     r"return static_cast<int>\(\(n \+ per_block - 1\) / "
                     r"per_block\);", SRC)


@pytest.mark.parametrize("flat", [False, True], ids=["k11", "k15"])
def test_offsets_past_2_31(flat):
    """Addresses only, with a nominal table: rows past 2 GB, and an output
    past 2 GB, computed exactly in 64 bits."""
    W, R = 256, 4096
    rows = 2 ** 22  # a nominal 4 GB table
    n = rows * W if flat else rows
    rng = np.random.default_rng(5)
    idx = rng.integers(rows - 2 ** 20, rows, size=R).astype(np.int32)
    idx[0] = rows - 1
    a = _accesses(R, W, idx, _valid(idx, n, W, flat))
    assert (a["src"] % 16 == 0).all() and a["src"].min() >= 2 ** 31
    assert a["src"].max() == (rows - 1) * 4 * W + 4 * W - 16
    R = 2 ** 21 + 5  # the last rows of a 2 GB output and more
    idx = np.zeros(R, np.int32)
    last = np.arange(R - 3, R, dtype=np.int64)
    a = _accesses(R, W, idx, np.ones(R, bool), last)
    assert (a["dst"] % 16 == 0).all() and a["dst"].min() >= 2 ** 31
    assert a["dst"].max() == R * 4 * W - 16
    assert (a["block"] == last[:, None].repeat(64, 1).ravel() // WARPS).all()


# ---- on the card ----


@pytest.mark.cuda
@pytest.mark.parametrize("flat", [False, True], ids=["k11", "k15"])
@pytest.mark.parametrize("W,R", CASES)
def test_cuda_gather_matches_plain(W, R, flat):
    """On the card: each entry point equal to its plain version and to the
    emulation bit for bit, out-of-range rows 0, one launch counted a
    call."""
    dev = _card()
    table, n, idx = _case(W, R, flat)
    t = torch.from_numpy(table).to(dev)
    i = torch.from_numpy(idx).to(dev)
    name = "flat_row_gather" if flat else "row_gather"
    before = pk.launches[name]
    if flat:
        got = pk.flat_row_gather(t, i, W)
        plain = pk.flat_row_gather_plain(t, i, W)
    else:
        t = t.view(n, W)
        got = pk.row_gather(t, i)
        plain = pk.row_gather_plain(t, i)
    torch.cuda.synchronize()
    assert pk.launches[name] == before + 1
    assert torch.equal(got, plain)
    np.testing.assert_array_equal(
        got.cpu().numpy().view(np.int32),
        _emulate(table, n, idx, W, flat)[0].view(np.int32))


@pytest.mark.cuda
def test_cuda_gather_past_4gb():
    """A [4.3M, 256] f32 table (4.4 GB): rows at byte offsets past 2^32,
    both entry points equal to the plain version."""
    dev = _card()
    rows, W = 4_300_000, 256
    g = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn((rows, W), generator=g, device=dev)
    idx = torch.randint(rows - 50_000, rows, (4096,), generator=g,
                        device=dev, dtype=torch.int32)
    idx[0], idx[1], idx[2] = rows - 1, rows, -1
    assert int(idx.max()) * W * 4 > 2 ** 32
    got = pk.row_gather(table, idx)
    flat = pk.flat_row_gather(table.view(-1), idx, W)
    plain = pk.row_gather_plain(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, plain) and torch.equal(flat, plain)
    assert not got[1:3].any()
    del table, got, flat, plain
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_cuda_unaligned_table_refused():
    """The wrappers refuse a table off a 16-byte boundary (the kernel's
    16-byte loads need it) rather than launch."""
    dev = _card()
    store = torch.zeros(8 * 8 + 1, device=dev)
    off = store[1:]
    assert off.data_ptr() % 16 == 4
    idx = torch.arange(4, dtype=torch.int32, device=dev)
    before = dict(pk.launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        pk.row_gather(off.view(8, 8), idx)
    with pytest.raises(ValueError, match="16-byte aligned"):
        pk.flat_row_gather(off, idx, 8)
    assert pk.launches == before
