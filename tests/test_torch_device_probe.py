"""The device probe's kernels (K10-K18) against the JAX probes.

Each of the nine Pallas probes of `seismic_tpu/harness/device_probe.py`
runs here on the CPU with `pallas_call` in interpret mode, under a recorder
that keeps the operands and the output of its one call (the JAX `probe`
wrapper swallows exceptions, so the tests assert that the call happened).
The port's inputs must equal those operands bit for bit, and the port's
plain versions (the wrappers on CPU tensors) must match the recorded
output: gathers bit-exact; compare scores within 1e-5 * sum_w |vals *
qmatch| + 1e-6 per row; products within 1e-6 * sum_k |a * b| (times
|scale| for K13) of an f64 product, both outputs.
"""

import hashlib

import jax
import jax.experimental.pallas as jpl
import numpy as np
import pytest
import torch

from seismic_tpu.harness import device_probe as jdp
from seismic_tpu_torch.harness import device_probe as tdp
from seismic_tpu_torch.ops import probe_kernels as pk

# operands larger than this are kept as digests (the 1 GB tables)
_KEEP_BYTES = 1 << 26
# the small generation-3 sizes the pipelined-blocks probe runs at here
_SMALL = dict(B=8, QC=4, NB=3200)


def _digest(a):
    a = np.ascontiguousarray(a)
    return (a.shape, a.dtype.str,
            hashlib.blake2b(a.view(np.uint8).ravel()).hexdigest())


def _kept(a):
    a = np.asarray(a)
    return _digest(a) if a.nbytes > _KEEP_BYTES else np.array(a)


@pytest.fixture
def recorded(monkeypatch):
    """Patch `pallas_call` to run in interpret mode and record each call's
    operands and output; patch the JAX probe's `timeit` to one call."""
    calls = []
    orig = jpl.pallas_call

    def recorder(kernel, *args, **kwargs):
        f = orig(kernel, *args, **dict(kwargs, interpret=True))
        entry = {}
        calls.append(entry)

        def call(*ops):
            out = f(*ops)

            def keep(*vals):
                if "out" not in entry:
                    entry["ops"] = [_kept(v) for v in vals[:-1]]
                    entry["out"] = np.array(vals[-1])

            jax.debug.callback(keep, *ops, out)
            return out

        return call

    def one_call(f, *args, reps=5):
        jdp._sync(f(*args))
        return 1.0

    monkeypatch.setattr(jpl, "pallas_call", recorder)
    monkeypatch.setattr(jdp, "timeit", one_call)
    for k, v in _SMALL.items():
        monkeypatch.setattr(jdp, f"_{k}", v)
    return calls


def _run_jax(name, calls):
    getattr(jdp, name)()
    jax.effects_barrier()
    assert len(calls) == 1, f"{name}: {len(calls)} pallas_calls recorded"
    assert "out" in calls[0], f"{name}: the kernel never ran"
    return calls[0]


def _port_inputs(name):
    if name == "pallas_pipelined_blocks":
        return tdp.pallas_pipelined_blocks_inputs(**_SMALL)
    return getattr(tdp, f"{name}_inputs")()


def _gather_out(name, t):
    if name == "vmem_table_take":
        return pk.table_take(t["table"], t["idx"])
    if name == "row_dma_gather":
        return pk.row_gather(t["hbm"], t["idx"])
    if name == "take_along_axis_sublane":
        return pk.take_along_axis(t["table"], t["idx"])
    return pk.flat_row_gather(t["hbm"], t["idx"], 256)


def _compare_tol(a):
    qc, qv = a["qc"].ravel(), a["qv"].ravel().astype(np.float64)
    qd = np.zeros(int(max(a["comps"].max(), qc.max())) + 1)
    np.add.at(qd, qc, qv)
    return 1e-5 * np.abs(a["vals"] * qd[a["comps"]]).sum(-1) + 1e-6


def _product_ref(name, a):
    """(f64 product, sum_k |a * b|) of the product probes."""
    if name == "u8_tile_matmul":
        t, q = a["tile"].astype(np.float64), a["q"].astype(np.float64)
        s = a["scale"].astype(np.float64)
        return (t @ q) * s, (np.abs(t) @ np.abs(q)) * np.abs(s)
    if name == "int8_cast_matmul":
        t, q = a["tile"].astype(np.float64), a["q"].astype(np.float64)
        return t @ q, np.abs(t) @ np.abs(q)
    rows = a["tile_idx"][:, None] * tdp._MB + np.arange(tdp._MB)
    tiles = a["dense"][rows].astype(np.float64)
    q = a["qloc"].astype(np.float64)[:, :, None]
    return (np.matmul(tiles, q)[:, :, 0],
            np.matmul(np.abs(tiles), np.abs(q))[:, :, 0])


def _product_out(name, t):
    if name == "u8_tile_matmul":
        return pk.u8_matvec(t["tile"], t["q"], t["scale"])
    if name == "int8_cast_matmul":
        return pk.i8_matmul(t["tile"], t["q"])
    return pk.tile_matvec(t["dense"], t["tile_idx"], t["qloc"], tdp._MB)


PROBES = ["vmem_table_take", "row_dma_gather", "compare_intersect_kernel",
          "u8_tile_matmul", "take_along_axis_sublane", "flat_row_dma",
          "compare_term_loop", "int8_cast_matmul", "pallas_pipelined_blocks"]


@pytest.mark.parametrize("name", PROBES)
def test_probe_matches_jax(recorded, name):
    """The JAX kernel ran once in interpret mode; the port's inputs equal
    its operands bit for bit; the port's plain version matches its
    output; the port's probe passes its own checks on those inputs."""
    rec = _run_jax(name, recorded)
    a = _port_inputs(name)
    assert len(rec["ops"]) == len(a)
    for got, want in zip(rec["ops"], a.values(), strict=True):
        if isinstance(got, tuple):
            assert got == _digest(want)
        else:
            assert got.dtype == want.dtype and np.array_equal(got, want)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    before = dict(pk.launches)
    jout = rec["out"]
    if name in ("compare_intersect_kernel", "compare_term_loop"):
        fn = (pk.compare_intersect if name == "compare_intersect_kernel"
              else pk.compare_term_loop)
        out = fn(t["comps"], t["vals"], t["qc"], t["qv"]).numpy()
        assert out.shape == jout.shape == (a["comps"].shape[0], 1)
        err = np.abs(out.astype(np.float64) - jout)[:, 0]
        assert (err <= _compare_tol(a)).all(), err.max()
    elif name in ("u8_tile_matmul", "int8_cast_matmul",
                  "pallas_pipelined_blocks"):
        out = _product_out(name, t).numpy().astype(np.float64)
        assert out.shape == jout.shape
        ref, absum = _product_ref(name, a)
        tol = 1e-6 * absum
        assert (np.abs(out - ref) <= tol).all()
        assert (np.abs(jout - ref) <= tol).all()
        assert (np.abs(out - jout) <= 2 * tol).all()
    else:
        out = _gather_out(name, t).numpy()
        assert out.dtype == jout.dtype and np.array_equal(out, jout)
    assert pk.launches == before  # CPU tensors: the plain version ran
    cpu = tdp.resolve_device("cpu")
    port = getattr(tdp, name)(cpu, 1, inputs=a)
    assert port["ok"] and port["max_abs_err"] == 0.0
    assert port["device_ms"] is None and port["device"] == "cpu"
    assert port["library_device_ms"] is None


@pytest.mark.parametrize("name", ["xla_slice_matmul", "xla_compare_qloc"])
def test_plain_probes_match_jax(name):
    """The two probes with no Pallas kernel: the torch expression equals
    the JAX probe's on the same inputs (small sizes)."""
    import jax.numpy as jnp

    if name == "xla_slice_matmul":
        a = tdp.xla_slice_matmul_inputs(**_SMALL)
        dense, lbs, qloc = (torch.from_numpy(v) for v in a.values())
        out = tdp.slice_matmul(dense, lbs, qloc)

        def one(s, q):
            tile = jax.lax.dynamic_slice(jnp.asarray(a["dense"]), (s, 0),
                                         (tdp._MB, tdp._V))
            return jnp.dot(tile.astype(jnp.float32), q,
                           preferred_element_type=jnp.float32)

        want = np.asarray(jax.vmap(jax.vmap(one))(a["lbs"], a["qloc"]))
        # f32 sums in two orders: 1e-6 * sum_v |tile * qloc| (tiles >= 0)
        tol = 1e-6 * tdp.slice_matmul(dense, lbs, qloc.abs()).numpy()
        assert (np.abs(out.numpy() - want) <= tol).all()
    else:
        a = tdp.xla_compare_qloc_inputs(B=8, QC=4)
        out = tdp.compare_qloc(*(torch.from_numpy(v) for v in a.values()))
        eq = a["vocab"][..., None] == a["qc"][:, None, None, :]
        want = jnp.sum(jnp.where(eq, a["qv"][:, None, None, :], 0.0), -1)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    rec = getattr(tdp, name)(tdp.resolve_device("cpu"), 1, inputs=a)
    assert rec["ok"]


def test_cpu_runs_plain_and_default_device_is_the_card(monkeypatch):
    """`device="cpu"` runs the plain versions; the default device is the
    card and raises without CUDA; `main` exits non-zero when a probe
    raises or misses its check, and the other probes still run."""
    records, failures = tdp.run("cpu", only="take", reps=1)
    assert failures == [] and [r["name"] for r in records] == [
        "table_take", "take_along_axis"]
    assert tdp.main(["--device", "cpu", "--only", "vmem"]) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdp.run(only="vmem", reps=1)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdp.main(["--only", "vmem"])

    def broken(table, idx):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(pk, "table_take", broken)
    records, failures = tdp.run("cpu", only="take", reps=1)
    assert failures == ["vmem_table_take"]
    assert [r["name"] for r in records] == ["take_along_axis"]
    assert tdp.main(["--device", "cpu", "--only", "vmem"]) == 1
    monkeypatch.setattr(pk, "table_take",
                        lambda table, idx: pk.table_take_plain(table, idx)
                        + 1.0)
    assert tdp.main(["--device", "cpu", "--only", "vmem"]) == 1


def test_wrappers_check_operands_and_zero_outside_rows():
    """Wrong dtypes or shapes are refused before any launch; an index
    outside its table gives 0 in every gather."""
    i32 = torch.tensor([0, 2, -1, 7], dtype=torch.int32)
    with pytest.raises(ValueError):
        pk.table_take(torch.zeros(4, dtype=torch.float64), i32)
    with pytest.raises(ValueError):
        pk.row_gather(torch.zeros((4, 6)), i32)  # width not a multiple of 4
    with pytest.raises(ValueError):
        pk.compare_intersect(torch.zeros((2, 3), dtype=torch.int32),
                             torch.zeros((2, 3)), i32[None], torch.zeros(1, 4))
    with pytest.raises(ValueError):
        pk.u8_matvec(torch.zeros((4, 4), dtype=torch.int8), torch.zeros(4, 1),
                     torch.zeros(4, 1))
    with pytest.raises(ValueError):
        pk.tile_matvec(torch.zeros((8, 4), dtype=torch.int8),
                       torch.zeros(2, dtype=torch.int32), torch.zeros(3, 4), 4)
    table = torch.arange(1.0, 6.0)
    assert pk.table_take(table, i32).tolist() == [1.0, 3.0, 0.0, 0.0]
    rows = torch.arange(1.0, 21.0).view(5, 4)
    got = pk.row_gather(rows, i32)
    assert torch.equal(got[:2], rows[[0, 2]]) and not got[2:].any()
    got = pk.flat_row_gather(rows.reshape(-1), i32, 4)
    assert torch.equal(got[:2], rows[[0, 2]]) and not got[2:].any()
    idx = torch.tensor([[0, 4], [5, -1]], dtype=torch.int32)
    assert pk.take_along_axis(rows, idx[:, :2].repeat(1, 2)).tolist() == [
        [1.0, 18.0, 3.0, 20.0], [0.0, 0.0, 0.0, 0.0]]
    dense = torch.ones((8, 4), dtype=torch.int8)
    got = pk.tile_matvec(dense, torch.tensor([1, 2], dtype=torch.int32),
                         torch.ones(2, 4), 4)
    assert got.tolist() == [[4.0] * 4, [0.0] * 4]


@pytest.mark.cuda
@pytest.mark.parametrize("name", PROBES)
def test_cuda_kernel_matches_plain(name):
    """On the card: each kernel against its plain version and the probe's
    numpy expectation, at the JAX probe's sizes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    before = dict(pk.launches)
    with tdp.full_f32():
        rec = getattr(tdp, name)(dev, 2)
    assert rec["ok"], rec
    launched = {k: pk.launches[k] - before[k] for k in pk.NAMES}
    assert launched == {k: sum(rec["calls"].values()) if k == rec["name"]
                        else 0 for k in pk.NAMES}
