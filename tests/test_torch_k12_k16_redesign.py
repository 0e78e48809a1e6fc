"""K12 and K16 as one term-lookup kernel: the cases its design has to get
right.

The kernel (`compare_lookup_kernel` of `csrc/device_probe.cu`) builds an
open-addressed hash table of the query's terms in shared memory
(`csrc/term_table.cuh`) and looks each element up once. On the CPU, on
inputs made with numpy from a seed, a NumPy emulation of that table
(the same hash, linear probing, repeated ids summed in term order from
0.0f, terms equal to the empty key 0x7fffffff kept out of the table and
summed into one scalar that such elements read) gives a qmatch bit-equal
to the compare loop's term-order sum, and its row output (each lane's
elements in the kernel's order, then the warp's butterfly sum) within
1e-5 * sum_w |vals * qmatch| + 1e-6 of an f64 reference and of both plain
versions. The cases: the probe's inputs, repeated ids, every term one id,
the ids 0x7fffffff, -2^31, negatives and 0 in comps and in the terms, Q 1
and 1024, W 256 / 255 / 75 / 600 (a row wider than one pass), T 1.

On a machine with an NVIDIA card only (`cuda` marker; the card is looked
for inside each test): each entry point against its plain version and
the emulation on every case, one launch counted per call, and Q = 1025
refused by both wrappers and both C entry points. This file imports
neither JAX nor the test configuration at module level, so on the card it
also runs alone:

    python -m pytest --noconftest -q -m cuda tests/test_torch_k12_k16_redesign.py
"""

import ctypes

import numpy as np
import pytest
import torch

from seismic_tpu_torch.harness import device_probe as tdp
from seismic_tpu_torch.ops import _cuda
from seismic_tpu_torch.ops import probe_kernels as pk

EMPTY = 0x7FFFFFFF  # kTermEmpty, the table's empty key
INT_MIN = -(2 ** 31)
PASS = 256  # elements of a row a pass (32 lanes x 8)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


# ---- the kernel's table, emulated ----


def _bits(Q):
    """compare_bits: 2^bits >= 16 Q slots, from 1024 up to 4096."""
    bits = 10
    while (1 << bits) < 16 * Q and bits < 12:
        bits += 1
    return bits


def _slot(c, bits):
    """term_slot: the id's 32 bits times 2654435761, the top `bits`."""
    return (((int(c) & 0xFFFFFFFF) * 2654435761) & 0xFFFFFFFF) >> (32 - bits)


class _Table:
    """The kernel's table of the terms (qc, qv) in term order: the terms
    other than EMPTY entered with linear probing, a repeated id's values
    summed in term order from 0.0f into its first slot; the values of the
    terms equal to EMPTY summed in term order into `empty`."""

    def __init__(self, qc, qv):
        self.bits = _bits(len(qc))
        n = 1 << self.bits
        self.keys = np.full(n, EMPTY, np.int64)
        self.vals = np.zeros(n, np.float32)
        self.empty = np.float32(0.0)
        self.max_probes = 0
        sums = {}
        for c, v in zip(qc.tolist(), qv):
            if c == EMPTY:
                self.empty = np.float32(self.empty + v)
                continue
            sums[c] = np.float32(sums.get(c, np.float32(0.0)) + v)
            h = _slot(c, self.bits)
            while self.keys[h] not in (EMPTY, c):
                h = (h + 1) & (n - 1)
            self.keys[h] = c
        for c, s in sums.items():
            self.vals[self._find(c)] = s
        self.n_keys = len(sums)

    def _find(self, c):
        h, probes = _slot(c, self.bits), 1
        while self.keys[h] != c and self.keys[h] != EMPTY:
            h = (h + 1) & (len(self.keys) - 1)
            probes += 1
        self.max_probes = max(self.max_probes, probes)
        return h

    def lookup(self, c):
        """qd[c]: the empty scalar for EMPTY, 0.0f for an id no term has."""
        if c == EMPTY:
            return self.empty
        h = self._find(c)
        return self.vals[h] if self.keys[h] == c else np.float32(0.0)

    def qmatch(self, comps):
        ids, inv = np.unique(comps, return_inverse=True)
        qd = np.array([self.lookup(c) for c in ids.tolist()], np.float32)
        return qd[inv.reshape(comps.shape)]


def _emulated_rows(vals, qm):
    """The kernel's row sums: lane l adds vals * qmatch (fmaf, modelled as
    an f64 multiply-add rounded to f32) over its elements in order, those
    at w0 + 4 (l + 32 h) + j (h < 2, j < 4) of each 256-element pass w0
    where W % 4 == 0 (16-byte loads), at w0 + l + 32 k (k < 8) otherwise;
    then the warp's butterfly sum (v += shfl_xor(v, off), off 16 .. 1)."""
    T, W = vals.shape
    lanes = np.arange(32)
    if W % 4 == 0:
        order = [4 * (lanes + 32 * h) + j for h in range(2) for j in range(4)]
    else:
        order = [lanes + 32 * k for k in range(8)]
    part = np.zeros((T, 32), np.float32)
    for w0 in range(0, W, PASS):
        for offs in order:
            w = w0 + offs
            ok = w < W
            wc = np.minimum(w, W - 1)
            fma = (vals[:, wc].astype(np.float64) * qm[:, wc]
                   + part).astype(np.float32)
            part = np.where(ok[None, :], fma, part)
    for off in (16, 8, 4, 2, 1):
        part = (part + part[:, lanes ^ off]).astype(np.float32)
    return part[:, 0]


# ---- the cases ----

CASES = ("probe", "repeated_id", "all_same_id", "edge_ids", "q1", "q1024",
         "w255", "w75", "w600", "t1")


def _draw(rng, T, W, Q, n_ids):
    comps = rng.integers(0, n_ids, size=(T, W), dtype=np.int32)
    vals = rng.normal(size=(T, W)).astype(np.float32)
    qc = rng.integers(0, n_ids, size=Q, dtype=np.int32)
    qv = rng.normal(size=Q).astype(np.float32)
    return comps, vals, qc, qv


def _case(name):
    """(comps [T, W] int32, vals f32, qc [Q] int32, qv [Q] f32)."""
    if name == "probe":
        a = tdp.compare_intersect_kernel_inputs()
        return a["comps"], a["vals"], a["qc"], a["qv"]
    rng = np.random.default_rng(CASES.index(name))
    if name == "repeated_id":  # an id three times, another twice, a -0.0
        comps, vals, qc, qv = _draw(rng, 64, 256, 64, 300)
        qc[[10, 20]] = qc[3]
        qc[6] = qc[5]
        qv[5] = -0.0
    elif name == "all_same_id":
        comps, vals, qc, qv = _draw(rng, 32, 256, 64, 40)
        qc[:] = 17
    elif name == "edge_ids":  # in comps and in the terms, some repeated
        ids = np.array([EMPTY, INT_MIN, -1, -5, 0, 1, 12345, -12345,
                        INT_MIN + 1, EMPTY - 1], np.int32)
        comps = rng.choice(ids, size=(48, 256)).astype(np.int32)
        vals = rng.normal(size=comps.shape).astype(np.float32)
        qc = np.array([EMPTY, INT_MIN, -1, 0, EMPTY, 12345, INT_MIN, -5,
                       EMPTY - 1, 7, -12345, 0], np.int32)
        qv = rng.normal(size=qc.shape).astype(np.float32)
    elif name == "q1":
        comps, vals, qc, qv = _draw(rng, 64, 256, 1, 8)
    elif name == "q1024":  # some ids repeat among 1024 draws of 20,000
        comps, vals, qc, qv = _draw(rng, 16, 256, 1024, 20_000)
    elif name == "w255":
        comps, vals, qc, qv = _draw(rng, 33, 255, 64, 500)
    elif name == "w75":
        comps, vals, qc, qv = _draw(rng, 20, 75, 64, 200)
    elif name == "w600":  # three passes, the last one short
        comps, vals, qc, qv = _draw(rng, 9, 600, 64, 500)
    else:  # t1
        comps, vals, qc, qv = _draw(rng, 1, 256, 64, 500)
    return comps, vals, qc, qv


def _term_order_qmatch(comps, qc, qv):
    """The compare loop's qmatch: the terms' values added in term order
    from 0.0f (f32), as `compare_term_loop_plain` adds them."""
    qm = torch.zeros(comps.shape, dtype=torch.float32)
    c = torch.from_numpy(comps)
    for i in range(len(qc)):
        qm = qm + torch.where(c == int(qc[i]), torch.tensor(qv[i]), 0.0)
    return qm.numpy()


def _ref_and_tol(comps, vals, qc, qv):
    """(f64 row sums, per-row tolerance 1e-5 * sum_w |vals * qmatch| +
    1e-6), qmatch summed in f64."""
    q64 = {}
    for c, v in zip(qc.tolist(), qv.astype(np.float64)):
        q64[c] = q64.get(c, 0.0) + v
    ids, inv = np.unique(comps, return_inverse=True)
    qm = np.array([q64.get(c, 0.0) for c in ids.tolist()])[
        inv.reshape(comps.shape)]
    prod = vals.astype(np.float64) * qm
    return prod.sum(-1), 1e-5 * np.abs(prod).sum(-1) + 1e-6


def _within(out, want, tol):
    err = np.abs(np.asarray(out, np.float64).ravel() - want)
    return bool((err <= tol).all()), float((err / tol).max())


@pytest.mark.parametrize("case", CASES)
def test_emulated_lookup_equals_compare_loop(case):
    comps, vals, qc, qv = _case(case)
    table = _Table(qc, qv)
    # the table as the kernel sizes it: a load <= 1/4 in 1024-4096 slots
    assert 1024 <= len(table.keys) <= 4096
    assert table.n_keys * 4 <= len(table.keys)
    qm = table.qmatch(comps)
    want_qm = _term_order_qmatch(comps, qc, qv)
    np.testing.assert_array_equal(qm.view(np.int32), want_qm.view(np.int32))
    rows = _emulated_rows(vals, qm)
    ref, tol = _ref_and_tol(comps, vals, qc, qv)
    assert _within(rows, ref, tol)[0]
    # both plain versions (the CPU wrappers run them) within the tolerance
    t = [torch.from_numpy(x) for x in (comps, vals, qc, qv)]
    plain_i = pk.compare_intersect_plain(*t)
    plain_l = pk.compare_term_loop_plain(t[0], t[1], t[2][None], t[3][None])
    assert torch.equal(pk.compare_intersect(*t), plain_i)
    assert torch.equal(pk.compare_term_loop(t[0], t[1], t[2][None],
                                            t[3][None]), plain_l)
    for plain in (plain_i, plain_l):
        assert _within(plain.numpy(), ref, tol)[0]
        assert _within(rows, plain.numpy().ravel().astype(np.float64),
                       2 * tol)[0]
    # each case does what it is there for
    if case == "repeated_id":
        assert (qc == qc[3]).sum() >= 3 and (qc == qc[5]).sum() >= 2
        assert table.n_keys < len(qc) and (qm != 0).any()
    elif case == "all_same_id":
        assert table.n_keys == 1 and (comps == 17).any()
    elif case == "edge_ids":
        assert table.empty != 0 and (comps == EMPTY).any()
        assert table.lookup(INT_MIN) == np.float32(
            np.float32(0.0) + qv[1] + qv[6])
    elif case == "q1024":
        assert table.n_keys < 1024 and len(table.keys) == 4096


def test_device_probe_library_holds_the_term_table():
    """The probe library's name carries term_table.cuh's hash (a change
    of the header rebuilds K12 / K16)."""
    with open(f"{_cuda.CSRC}/term_table.cuh", "rb") as f:
        header = f.read()
    assert header in _cuda.source_with_headers(_cuda._src("device_probe"))


# ---- on the card ----

ENTRIES = {"compare_intersect": "seismic_probe_compare_intersect",
           "compare_term_loop": "seismic_probe_compare_term_loop"}


def _run(entry, t):
    if entry == "compare_intersect":
        return (pk.compare_intersect(*t), pk.compare_intersect_plain(*t))
    row = (t[0], t[1], t[2][None], t[3][None])
    return pk.compare_term_loop(*row), pk.compare_term_loop_plain(*row)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("entry", list(ENTRIES))
def test_cuda_compare_matches_plain(entry, case):
    """On the card: each entry point within the tolerance of its plain
    version, of the f64 reference and of the emulated row sums, one
    launch counted a call."""
    dev = _card()
    comps, vals, qc, qv = _case(case)
    t = [torch.from_numpy(x).to(dev) for x in (comps, vals, qc, qv)]
    before = pk.launches[entry]
    got, plain = _run(entry, t)
    torch.cuda.synchronize()
    assert pk.launches[entry] == before + 1
    assert got.shape == (comps.shape[0], 1)
    ref, tol = _ref_and_tol(comps, vals, qc, qv)
    got, plain = got.cpu().numpy(), plain.cpu().numpy()
    assert _within(got, ref, tol)[0]
    assert _within(got, plain.ravel().astype(np.float64), 2 * tol)[0]
    rows = _emulated_rows(vals, _Table(qc, qv).qmatch(comps))
    assert _within(got, rows.astype(np.float64), 2 * tol)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("entry", list(ENTRIES))
def test_cuda_compare_refuses_more_than_the_cap(entry):
    """Q = 1025 raises on both wrappers (no launch) and the C entry
    points return cudaErrorInvalidValue; Q = 1024 runs."""
    dev = _card()
    rng = np.random.default_rng(1025)
    comps, vals, qc, qv = _draw(rng, 8, 64, pk.MAX_TERMS + 1, 3000)
    t = [torch.from_numpy(x).to(dev) for x in (comps, vals, qc, qv)]
    before = pk.launches[entry]
    with pytest.raises(ValueError):
        _run(entry, t)
    assert pk.launches[entry] == before
    out = torch.empty((8, 1), dtype=torch.float32, device=dev)
    p = _cuda.ptr
    rc = getattr(pk._lib(), ENTRIES[entry])(
        p(t[0]), p(t[1]), p(t[2]), p(t[3]), 8, 64, pk.MAX_TERMS + 1, p(out),
        ctypes.c_void_p(_cuda.stream_handle(dev)))
    assert rc == 1  # cudaErrorInvalidValue
    t[2], t[3] = t[2][:pk.MAX_TERMS], t[3][:pk.MAX_TERMS]
    got, _ = _run(entry, t)
    torch.cuda.synchronize()
    assert pk.launches[entry] == before + 1
    ref, tol = _ref_and_tol(comps, vals, qc[:pk.MAX_TERMS],
                            qv[:pk.MAX_TERMS])
    assert _within(got.cpu().numpy(), ref, tol)[0]
