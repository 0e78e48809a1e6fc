"""Device probe of the card: the JAX tool's probes
(`seismic_tpu/harness/device_probe.py`) on an NVIDIA GPU.

Each probe builds its inputs with the JAX probe's numpy draws (same seed,
same order, same sizes), runs its hand-written CUDA kernel (K10-K18 of
PERF.md's table, `ops/probe_kernels.py`, `csrc/device_probe.cu`), holds the
result against the kernel's plain PyTorch version and against the probe's
numpy expectation, times the kernel, the plain version and the nearest
single PyTorch call (the mean over `reps` back-to-back calls between one
pair of CUDA events, which on the card is mostly the host's cost of a
call), times the kernel and the library call on the card alone (calls
queued behind a kernel that holds the stream, with L2 warm, flushed by a
write and flushed by a read),
prints the JAX probe's quantities and returns a record. `xla_slice_matmul` and `xla_compare_qloc` call no Pallas kernel in
the JAX tool; here they are plain torch ops, timed the same way.

Tolerances: the gathers (K10, K11, K14, K15) are bit-exact; the compare
scores (K12, K16) within 1e-5 * sum_w |vals * qmatch| + 1e-6 per row; the
products (K13, K17, K18) within 1e-6 * sum_k |a * b| per output (times
|scale| for K13) of an f64 product. The JAX `u8_tile_matmul` probe's
`rtol=1e-4` check is not used: with the default `atol` it fails on a right
result whose output is a small difference of terms reaching 11,325.

Usage: python -m seismic_tpu_torch.harness.device_probe [--only NAME]
           [--device cuda|cpu] [-v]

Runs on the card unless `--device cpu` is given; runs every probe even
when one fails, and exits non-zero if any probe failed or any check
missed.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
import traceback

import numpy as np
import torch

from ..device import full_f32, resolve_device
from ..ops import probe_kernels as pk

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 CUDA-core and
# dense bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
SOURCE = "seismic_tpu_torch/csrc/device_probe.cu"
JAX_PROBE = "seismic_tpu/harness/device_probe.py"
PROBES = []
COLD_ROUNDS = 3  # pairs of windows behind each L2-flushed device time

# the JAX tool's generation-3 sizes (device_probe.py:447-448)
_B, _QC, _MB, _V = 256, 10, 32, 512
_NB = 200_000


def probe(fn):
    PROBES.append(fn)
    return fn


def mean_ms(fn, dev, reps: int) -> float:
    """Mean ms of one of `reps` back-to-back calls of `fn` after one
    warm-up call: CUDA events around the whole run on the card, the host
    clock on the CPU."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def device_ms(fn, dev, n: int = 50, evict=None, rounds=None):
    """Device ms per call of `fn`, without the host's cost of launching:
    `n` calls are queued behind a kernel that holds the stream for 20 ms,
    so they run back to back on the card, between one pair of CUDA events
    (raises if the host took longer to queue them). With `evict` (a pass
    over more than the 50 MB L2 cache, `flush_passes`), each call follows
    the pass, so it finds its operands in device memory; the time of the
    passes alone is subtracted: the median over `rounds` (COLD_ROUNDS by
    default) pairs of windows taken in turns (a pass takes many times as
    long as a short kernel, so one pair can be off by more than the
    kernel takes). None on the CPU."""
    if dev.type != "cuda":
        return None
    hold_ns = 20_000_000

    def window(calls):
        torch.cuda.synchronize(dev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        pk.spin(dev, hold_ns)
        t0 = time.perf_counter()
        a.record()
        for _ in range(n):
            calls()
        b.record()
        queued_ns = (time.perf_counter() - t0) * 1e9
        b.synchronize()
        if queued_ns > 0.9 * hold_ns:
            raise RuntimeError(f"queueing {n} calls took {queued_ns:.0f} ns")
        return a.elapsed_time(b) / n

    fn()
    if evict is None:
        return window(fn)
    evict()  # its first launch outside the window (lazy loading)

    def flushed():
        evict()
        fn()

    return statistics.median(window(flushed) - window(evict)
                             for _ in range(rounds or COLD_ROUNDS))


def flush_passes(dev, nbytes: int = 1 << 28):
    """{"cold": overwrite, "cold_read": read}: two passes over an
    `nbytes` tensor (256 MB, five times the L2) that empty the L2 before
    a flushed reading of `device_ms`. The overwrite (`zero_`) leaves the
    L2 full of dirty lines, which the next call writes back as it brings
    its own in; the read (`torch.sum` into a preallocated scalar) leaves
    clean lines."""
    flush = torch.empty(nbytes // 4, dtype=torch.float32, device=dev)
    total = torch.empty((), dtype=torch.float32, device=dev)

    def read():
        torch.sum(flush, 0, out=total)

    return {"cold": flush.zero_, "cold_read": read}


DEVICE_KEYS = ("device_ms", "device_cold_ms", "device_cold_read_ms",
               "library_device_ms", "library_device_cold_ms",
               "library_device_cold_read_ms")


def below_floor(rec, floor_ms: float) -> dict:
    """The device times of `rec` under `floor_ms`, an empty kernel's
    device time from the same run: readings that no call can take."""
    return {k: rec[k] for k in DEVICE_KEYS
            if rec.get(k) is not None and rec[k] < floor_ms}


def launch_floor_us(dev, reps: int = 1000):
    """(µs a call, device µs a call) of an empty kernel launched through
    the probe library: the first measured as the kernels' `ms`, the second
    as their `device_ms`."""
    def empty():
        pk.empty_launch(dev)

    return (mean_ms(empty, dev, reps) * 1e3,
            device_ms(empty, dev) * 1e3)


def bound(nbytes: float, nops: float, op_peak: float = PEAK_F32):
    """(bound_ms, bound_by): the larger of the bytes at the memory rate and
    the operations at the rate of their route (`op_peak`: the f32
    CUDA-core rate unless a kernel runs on the tensor cores)."""
    tb, to = nbytes / PEAK_BYTES, nops / op_peak
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _host(x):
    return x.detach().cpu().numpy()


def _kernel_record(probe_name, kernel, line, dev, reps, ok, err, run, plain,
                   library, nbytes, nops, op_peak=PEAK_F32, **extra):
    """The record of a kernel probe: times of the kernel, its plain version
    and the library call (`library` = (description, fn) or (reason, None)),
    each the mean of back-to-back calls; the device time per call of the
    kernel (`device_ms`, its operands left in L2 by the call before;
    `device_cold_ms`, L2 flushed by a write before each call, so the call
    also writes dirty lines back; `device_cold_read_ms`, L2 flushed by a
    read, its lines clean) and of the library call (`library_device_ms`,
    `library_device_cold_ms`, `library_device_cold_read_ms`); the bound;
    the calls made to the kernel's wrapper. `nops` counts the operations
    of the kernel's route, at `op_peak`."""
    b, bb = bound(nbytes, nops, op_peak)
    lib_name, lib_fn = library
    n_dev = 50
    passes = (flush_passes(dev) if dev.type == "cuda"
              else dict.fromkeys(("cold", "cold_read")))
    rec = dict(
        name=kernel, probe=probe_name, route="cuda", source=SOURCE,
        replaces=f"{JAX_PROBE}:{line}", ok=bool(ok), max_abs_err=float(err),
        ms=mean_ms(run, dev, reps), plain_ms=mean_ms(plain, dev, reps),
        bound_ms=b, bound_by=bb,
        library_ms=None if lib_fn is None else mean_ms(lib_fn, dev, reps),
        library=lib_name, bytes=float(nbytes), ops=float(nops),
        calls={"check": 1, "timing": reps + 1,
               "device": n_dev + 1 + 2 * (1 + COLD_ROUNDS * n_dev)},
        device=str(dev))
    for key, evict in (("", None), *passes.items()):
        suffix = f"_{key}" if key else ""
        rec[f"device{suffix}_ms"] = device_ms(run, dev, n_dev, evict)
        rec[f"library_device{suffix}_ms"] = (
            None if lib_fn is None else device_ms(lib_fn, dev, n_dev, evict))
    rec.update(extra)
    return rec


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max().item())


# ---------------------------------------------------------------------------
# Generation 1
# ---------------------------------------------------------------------------


def vmem_table_take_inputs():
    rng = np.random.default_rng(0)
    dim = 30720
    table = rng.normal(size=dim).astype(np.float32)
    idx = rng.integers(0, dim, size=(64, 128), dtype=np.int32)
    return {"table": table, "idx": idx}


@probe
def vmem_table_take(dev, reps, inputs=None):
    """K10: element gather from a table read through the L1 / L2 caches."""
    a = inputs or vmem_table_take_inputs()
    table, idx = _t(a["table"], dev), _t(a["idx"], dev)
    out = pk.table_take(table, idx)
    plain = pk.table_take_plain(table, idx)
    ok = (torch.equal(out, plain)
          and np.array_equal(_host(out), a["table"][a["idx"]]))
    idx_l = idx.long()
    n = idx.numel()
    rec = _kernel_record(
        "vmem_table_take", "table_take", 69, dev, reps, ok,
        _max_err(out, plain), lambda: pk.table_take(table, idx),
        lambda: pk.table_take_plain(table, idx),
        ("table[idx] (int64 idx cast outside the timing)",
         lambda: table[idx_l]),
        nbytes=table.numel() * 4 + n * 8, nops=0, tolerance="bit-exact")
    t = rec["ms"] * 1e-3
    rec["ns_per_elem"] = t / n * 1e9
    print(f"[vmem_table_take] ok={ok} {t*1e6:.1f} us for {n} elems "
          f"({rec['ns_per_elem']:.1f} ns/elem)")
    return rec


def row_dma_gather_inputs():
    rng = np.random.default_rng(0)
    n_docs, w, n_rows = 1_000_000, 256, 4096
    hbm = rng.normal(size=(n_docs, w)).astype(np.float32)
    idx = rng.integers(0, n_docs, size=n_rows, dtype=np.int32)
    return {"idx": idx, "hbm": hbm}


def _row_gather_bytes(idx, w):
    return torch.unique(idx).numel() * w * 4 + idx.numel() * (4 + w * 4)


@probe
def row_dma_gather(dev, reps, inputs=None):
    """K11: gather 4096 random 1 KB rows of a 1 GB table."""
    a = inputs or row_dma_gather_inputs()
    idx, hbm = _t(a["idx"], dev), _t(a["hbm"], dev)
    out = pk.row_gather(hbm, idx)
    plain = pk.row_gather_plain(hbm, idx)
    ok = (torch.equal(out, plain)
          and np.array_equal(_host(out), a["hbm"][a["idx"]]))
    n_rows, w = out.shape
    rec = _kernel_record(
        "row_dma_gather", "row_gather", 105, dev, reps, ok,
        _max_err(out, plain), lambda: pk.row_gather(hbm, idx),
        lambda: pk.row_gather_plain(hbm, idx),
        ("torch.index_select(hbm, 0, idx)",
         lambda: torch.index_select(hbm, 0, idx)),
        nbytes=_row_gather_bytes(idx, w), nops=0, tolerance="bit-exact")
    t = rec["ms"] * 1e-3
    rec.update(ns_per_row=t / n_rows * 1e9, gb_s=n_rows * w * 4 / t / 1e9)
    print(f"[row_dma_gather] ok={ok} {t*1e3:.3f} ms for {n_rows} 1KB rows "
          f"({rec['ns_per_row']:.0f} ns/row, {rec['gb_s']:.1f} GB/s)")
    return rec


def _compare_check(a, out, plain, qc, qv):
    """(ok, max |out - plain|): out and plain against each other and
    against the JAX probe's f32 numpy expectation, each within 1e-5 *
    sum_w |vals * qmatch| + 1e-6 per row."""
    comps, vals = a["comps"], a["vals"]
    n_ids = int(max(comps.max(), qc.max())) + 1
    qd = np.zeros(n_ids, np.float32)
    np.add.at(qd, qc, qv)
    expect = (vals * qd[comps]).sum(-1)
    qd64 = np.zeros(n_ids, np.float64)
    np.add.at(qd64, qc, qv.astype(np.float64))
    tol = 1e-5 * np.abs(vals.astype(np.float64) * qd64[comps]).sum(-1) + 1e-6
    o, p = _host(out).ravel(), _host(plain).ravel()
    ok = all(bool((np.abs(x.astype(np.float64) - y) <= tol).all())
             for x, y in ((o, p), (o, expect), (p, expect)))
    return ok, float(np.abs(o.astype(np.float64) - p).max())


def compare_intersect_kernel_inputs():
    rng = np.random.default_rng(0)
    T, W, Q = 1024, 256, 64
    comps = rng.integers(0, 3000, size=(T, W), dtype=np.int32)
    vals = rng.normal(size=(T, W)).astype(np.float32)
    qc = rng.integers(0, 3000, size=Q, dtype=np.int32)
    qv = rng.normal(size=Q).astype(np.float32)
    return {"comps": comps, "vals": vals, "qc": qc, "qv": qv}


_COMPARE_LIBRARY = ("none: no single PyTorch call compares elements with a "
                    "term list and sums the matches", None)


def _compare_counts(T, W, Q):
    """The bytes and operations of K12 / K16 (a lookup and an FMA of 2
    operations an element: 3 T W), and the former compare loop's count
    beside them (`compare_ops`, `compare_bound_ms`: 2 Q + 2 an element)."""
    compare_ops = 2.0 * T * W * Q + 2.0 * T * W
    return dict(nbytes=T * W * 8 + Q * 8 + T * 4, nops=3.0 * T * W,
                compare_ops=compare_ops,
                compare_bound_ms=compare_ops / PEAK_F32 * 1e3)


@probe
def compare_intersect_kernel(dev, reps, inputs=None):
    """K12: score [T, W] doc tiles against a [Q]-term query by equality."""
    a = inputs or compare_intersect_kernel_inputs()
    args = tuple(_t(a[k], dev) for k in ("comps", "vals", "qc", "qv"))
    out = pk.compare_intersect(*args)
    plain = pk.compare_intersect_plain(*args)
    ok, err = _compare_check(a, out, plain, a["qc"], a["qv"])
    (T, W), Q = a["comps"].shape, a["qc"].size
    rec = _kernel_record(
        "compare_intersect_kernel", "compare_intersect", 170, dev, reps, ok,
        err, lambda: pk.compare_intersect(*args),
        lambda: pk.compare_intersect_plain(*args), _COMPARE_LIBRARY,
        **_compare_counts(T, W, Q),
        tolerance="1e-5 * sum_w |vals * qmatch| + 1e-6 per row")
    t = rec["ms"] * 1e-3
    rec["tops_s"] = T * W * Q / t / 1e12
    print(f"[compare_intersect_kernel] ok={ok} {t*1e6:.1f} us "
          f"({rec['tops_s']:.2f} Tops/s of compare-equivalents)")
    return rec


def _product_check(out, plain, ref, absum):
    """(ok, max |out - plain|): out and plain each within 1e-6 * absum of
    the f64 product `ref`."""
    o, p = _host(out).astype(np.float64), _host(plain).astype(np.float64)
    tol = 1e-6 * absum
    ok = bool((np.abs(o - ref) <= tol).all() and (np.abs(p - ref) <= tol).all())
    return ok, float(np.abs(o - p).max())


def u8_tile_matmul_inputs():
    rng = np.random.default_rng(0)
    M, K = 512, 512
    tile = rng.integers(0, 255, size=(M, K), dtype=np.uint8)
    q = rng.normal(size=(K, 1)).astype(np.float32)
    scale = rng.normal(size=(M, 1)).astype(np.float32)
    return {"tile": tile, "q": q, "scale": scale}


@probe
def u8_tile_matmul(dev, reps, inputs=None):
    """K13: dense u8 tile mat-vec with fused scale."""
    a = inputs or u8_tile_matmul_inputs()
    tile, q, scale = (_t(a[k], dev) for k in ("tile", "q", "scale"))
    out = pk.u8_matvec(tile, q, scale)
    plain = pk.u8_matvec_plain(tile, q, scale)
    t64 = a["tile"].astype(np.float64)
    ref = (t64 @ a["q"].astype(np.float64)) * a["scale"]
    absum = (t64 @ np.abs(a["q"].astype(np.float64))) * np.abs(a["scale"])
    ok, err = _product_check(out, plain, ref, absum)
    M, K = a["tile"].shape
    tile_f = tile.to(torch.float32)
    rec = _kernel_record(
        "u8_tile_matmul", "u8_matvec", 212, dev, reps, ok, err,
        lambda: pk.u8_matvec(tile, q, scale),
        lambda: pk.u8_matvec_plain(tile, q, scale),
        ("torch.matmul(tile_f32, q) (tile cast outside the timing, scale "
         "left out)", lambda: torch.matmul(tile_f, q)),
        nbytes=M * K + K * 4 + M * 8, nops=2.0 * M * K + M,
        tolerance="1e-6 * sum_k |tile * q| * |scale| of the f64 product")
    print(f"[u8_tile_matmul] ok={ok} {rec['ms']*1e3:.1f} us")
    return rec


# ---------------------------------------------------------------------------
# Generation 2
# ---------------------------------------------------------------------------


def take_along_axis_sublane_inputs():
    rng = np.random.default_rng(0)
    R, C, M = 256, 128, 512
    table = rng.normal(size=(R, C)).astype(np.float32)
    idx = rng.integers(0, R, size=(M, C), dtype=np.int32)
    return {"table": table, "idx": idx}


@probe
def take_along_axis_sublane(dev, reps, inputs=None):
    """K14: per-column row gather, out[m, c] = table[idx[m, c], c]."""
    a = inputs or take_along_axis_sublane_inputs()
    table, idx = _t(a["table"], dev), _t(a["idx"], dev)
    out = pk.take_along_axis(table, idx)
    plain = pk.take_along_axis_plain(table, idx)
    expect = np.take_along_axis(a["table"], a["idx"], axis=0)
    ok = torch.equal(out, plain) and np.array_equal(_host(out), expect)
    idx_l = idx.long()
    n = idx.numel()
    rec = _kernel_record(
        "take_along_axis_sublane", "take_along_axis", 256, dev, reps, ok,
        _max_err(out, plain), lambda: pk.take_along_axis(table, idx),
        lambda: pk.take_along_axis_plain(table, idx),
        ("torch.gather(table, 0, idx) (int64 idx cast outside the timing)",
         lambda: torch.gather(table, 0, idx_l)),
        nbytes=table.numel() * 4 + n * 8, nops=0, tolerance="bit-exact")
    t = rec["ms"] * 1e-3
    rec["ns_per_elem"] = t / n * 1e9
    print(f"[take_along_axis_sublane] ok={ok} {t*1e6:.1f} us for {n} elems "
          f"({rec['ns_per_elem']:.2f} ns/elem)")
    return rec


def flat_row_dma_inputs():
    rng = np.random.default_rng(0)
    n_docs, w, n_rows = 1_000_000, 256, 4096
    hbm = rng.normal(size=(n_docs, w)).astype(np.float32).reshape(-1)
    idx = rng.integers(0, n_docs, size=n_rows, dtype=np.int32)
    return {"idx": idx, "hbm": hbm}


@probe
def flat_row_dma(dev, reps, inputs=None):
    """K15: 1 KB rows at offsets idx * 256 of a flat 1 GB table."""
    a = inputs or flat_row_dma_inputs()
    w = 256
    idx, flat = _t(a["idx"], dev), _t(a["hbm"], dev)
    out = pk.flat_row_gather(flat, idx, w)
    plain = pk.flat_row_gather_plain(flat, idx, w)
    expect = a["hbm"].reshape(-1, w)[a["idx"]]
    ok = torch.equal(out, plain) and np.array_equal(_host(out), expect)
    rows2d = flat.view(-1, w)
    n_rows = idx.numel()
    rec = _kernel_record(
        "flat_row_dma", "flat_row_gather", 289, dev, reps, ok,
        _max_err(out, plain), lambda: pk.flat_row_gather(flat, idx, w),
        lambda: pk.flat_row_gather_plain(flat, idx, w),
        ("torch.index_select(hbm.view(-1, 256), 0, idx)",
         lambda: torch.index_select(rows2d, 0, idx)),
        nbytes=_row_gather_bytes(idx, w), nops=0, tolerance="bit-exact")
    t = rec["ms"] * 1e-3
    rec.update(ns_per_row=t / n_rows * 1e9, gb_s=n_rows * w * 4 / t / 1e9)
    print(f"[flat_row_dma] ok={ok} {t*1e3:.3f} ms for {n_rows} 1KB rows "
          f"({rec['ns_per_row']:.0f} ns/row, {rec['gb_s']:.1f} GB/s)")
    return rec


def compare_term_loop_inputs():
    rng = np.random.default_rng(0)
    T, W, Q = 1024, 256, 64
    comps = rng.integers(0, 3000, size=(T, W), dtype=np.int32)
    vals = rng.normal(size=(T, W)).astype(np.float32)
    qc = rng.integers(0, 3000, size=(1, Q), dtype=np.int32)
    qv = rng.normal(size=(1, Q)).astype(np.float32)
    return {"comps": comps, "vals": vals, "qc": qc, "qv": qv}


@probe
def compare_term_loop(dev, reps, inputs=None):
    """K16: compare-intersection with the loop over the terms outside."""
    a = inputs or compare_term_loop_inputs()
    args = tuple(_t(a[k], dev) for k in ("comps", "vals", "qc", "qv"))
    out = pk.compare_term_loop(*args)
    plain = pk.compare_term_loop_plain(*args)
    ok, err = _compare_check(a, out, plain, a["qc"].ravel(), a["qv"].ravel())
    (T, W), Q = a["comps"].shape, a["qc"].size
    rec = _kernel_record(
        "compare_term_loop", "compare_term_loop", 358, dev, reps, ok, err,
        lambda: pk.compare_term_loop(*args),
        lambda: pk.compare_term_loop_plain(*args), _COMPARE_LIBRARY,
        **_compare_counts(T, W, Q),
        tolerance="1e-5 * sum_w |vals * qmatch| + 1e-6 per row")
    t = rec["ms"] * 1e-3
    rec.update(tcmp_s=T * W * Q / t / 1e12, mdocs_s=T / t / 1e6)
    print(f"[compare_term_loop] ok={ok} {t*1e6:.1f} us "
          f"({rec['tcmp_s']:.2f} Tcmp/s of compare-equivalents, "
          f"{rec['mdocs_s']:.1f} Mdocs/s/query)")
    return rec


def int8_cast_matmul_inputs():
    rng = np.random.default_rng(0)
    M, K = 512, 512
    tile = rng.integers(-127, 127, size=(M, K), dtype=np.int8)
    q = rng.normal(size=(K, 128)).astype(np.float32)
    return {"tile": tile, "q": q}


@probe
def int8_cast_matmul(dev, reps, inputs=None):
    """K17: int8 tile cast to f32 and multiplied, [512, 512] @ [512, 128]."""
    a = inputs or int8_cast_matmul_inputs()
    tile, q = _t(a["tile"], dev), _t(a["q"], dev)
    out = pk.i8_matmul(tile, q)
    plain = pk.i8_matmul_plain(tile, q)
    t64, q64 = a["tile"].astype(np.float64), a["q"].astype(np.float64)
    ref, absum = t64 @ q64, np.abs(t64) @ np.abs(q64)
    ok, err = _product_check(out, plain, ref, absum)
    (M, K), N = a["tile"].shape, a["q"].shape[1]
    tile_f = tile.to(torch.float32)
    f32_ops = 2.0 * M * K * N
    rec = _kernel_record(
        "int8_cast_matmul", "i8_matmul", 411, dev, reps, ok, err,
        lambda: pk.i8_matmul(tile, q), lambda: pk.i8_matmul_plain(tile, q),
        ("torch.matmul(tile_f32, q) (tile cast outside the timing)",
         lambda: torch.matmul(tile_f, q)),
        # three bf16 products on the tensor cores (q split into 3 terms)
        nbytes=M * K + K * N * 4 + M * N * 4, nops=3 * f32_ops,
        op_peak=PEAK_BF16, tolerance="1e-6 * sum_k |tile * q| of the f64 "
        "product",
        f32_ops_bound_ms=bound(0, f32_ops)[0],
        tolerance_share=float(
            (np.abs(_host(out).astype(np.float64) - ref)
             / (1e-6 * absum)).max()))
    print(f"[int8_cast_matmul] ok={ok} {rec['ms']*1e3:.1f} us, error "
          f"{rec['tolerance_share']:.3f} of the tolerance")
    return rec


# ---------------------------------------------------------------------------
# Generation 3: the streaming-dense search design's primitives
# ---------------------------------------------------------------------------


def xla_slice_matmul_inputs(B=None, QC=None, NB=None):
    B, QC, NB = B or _B, QC or _QC, NB or _NB
    rng = np.random.default_rng(0)
    dense = rng.integers(0, 127, size=(NB, _V), dtype=np.int8)
    lbs = rng.integers(0, NB - _MB, size=(B, QC), dtype=np.int32)
    qloc = rng.normal(size=(B, QC, _V)).astype(np.float32)
    return {"dense": dense, "lbs": lbs, "qloc": qloc}


def slice_matmul(dense, lbs, qloc):
    """out[b, c] = f32(dense[lbs[b, c] : + MB]) @ qloc[b, c]: the JAX
    probe's vmap of dynamic_slice + dot, as one gather and one einsum."""
    rows = lbs.long()[..., None] + torch.arange(_MB, device=dense.device)
    return torch.einsum("bcmv,bcv->bcm", dense[rows].to(torch.float32), qloc)


@probe
def xla_slice_matmul(dev, reps, inputs=None):
    """Gathered [32, 512] slices and a tiny product, as plain torch ops
    (the JAX probe's non-Pallas tile scorer; no kernel)."""
    a = inputs or xla_slice_matmul_inputs()
    dense, lbs, qloc = (_t(a[k], dev) for k in ("dense", "lbs", "qloc"))
    out = slice_matmul(dense, lbs, qloc)
    ok = (tuple(out.shape) == (*a["lbs"].shape, _MB)
          and bool(torch.isfinite(out).all()))
    t = mean_ms(lambda: slice_matmul(dense, lbs, qloc), dev, reps) * 1e-3
    n_slices = a["lbs"].size
    rec = dict(probe="xla_slice_matmul", ok=ok, ms=t * 1e3,
               us_per_slice=t / n_slices * 1e6,
               gb_s=n_slices * _MB * _V / t / 1e9, device=str(dev))
    print(f"[xla_slice_matmul] ok={ok} {t*1e3:.3f} ms for {n_slices} "
          f"[{_MB},{_V}]i8 slices+matmul ({rec['us_per_slice']:.2f} "
          f"us/slice, {rec['gb_s']:.2f} GB/s)")
    return rec


def xla_compare_qloc_inputs(B=None, QC=None):
    B, QC = B or _B, QC or _QC
    rng = np.random.default_rng(0)
    vocab = rng.integers(0, 30522, size=(B, QC, _V), dtype=np.int32)
    qc = rng.integers(0, 30522, size=(B, 64), dtype=np.int32)
    qv = rng.normal(size=(B, 64)).astype(np.float32)
    return {"vocab": vocab, "qc": qc, "qv": qv}


def compare_qloc(vocab, qc, qv):
    """qloc[b, c, v] = sum_i qv[b, i] * [vocab[b, c, v] == qc[b, i]]: the
    JAX probe's broadcast compare."""
    eq = vocab[..., None] == qc[:, None, None, :]
    return torch.where(eq, qv[:, None, None, :], 0.0).sum(-1)


@probe
def xla_compare_qloc(dev, reps, inputs=None):
    """Compare-based query projection, as plain torch ops (no kernel)."""
    a = inputs or xla_compare_qloc_inputs()
    vocab, qc, qv = (_t(a[k], dev) for k in ("vocab", "qc", "qv"))
    out = compare_qloc(vocab, qc, qv)
    ok = (out.shape == vocab.shape and bool(torch.isfinite(out).all()))
    t = mean_ms(lambda: compare_qloc(vocab, qc, qv), dev, reps) * 1e-3
    ops = vocab.numel() * qc.shape[1]
    rec = dict(probe="xla_compare_qloc", ok=ok, ms=t * 1e3,
               tcmp_s=ops / t / 1e12, device=str(dev))
    print(f"[xla_compare_qloc] ok={ok} {t*1e3:.3f} ms "
          f"({rec['tcmp_s']:.3f} Tcmp/s) for qloc [B,QC,V]")
    return rec


def pallas_pipelined_blocks_inputs(B=None, QC=None, NB=None):
    B, QC, NB = B or _B, QC or _QC, NB or _NB
    rng = np.random.default_rng(0)
    n_tiles = NB // _MB
    dense = rng.integers(0, 127, size=(n_tiles * _MB, _V), dtype=np.int8)
    tile_idx = rng.integers(0, n_tiles, size=(B * QC,), dtype=np.int32)
    qloc = rng.normal(size=(B * QC, _V)).astype(np.float32)
    return {"tile_idx": tile_idx, "dense": dense, "qloc": qloc}


@probe
def pallas_pipelined_blocks(dev, reps, inputs=None):
    """K18: the data-dependent tile stream, one [32, 512] int8 tile per
    step times that step's query row (every row checked)."""
    a = inputs or pallas_pipelined_blocks_inputs()
    tidx, dense, qloc = (_t(a[k], dev) for k in ("tile_idx", "dense", "qloc"))
    out = pk.tile_matvec(dense, tidx, qloc, _MB)
    plain = pk.tile_matvec_plain(dense, tidx, qloc, _MB)
    rows = a["tile_idx"][:, None] * _MB + np.arange(_MB)
    tiles64 = a["dense"][rows].astype(np.float64)  # [NS, MB, V]
    q64 = a["qloc"].astype(np.float64)[:, :, None]
    ref = np.matmul(tiles64, q64)[:, :, 0]
    absum = np.matmul(np.abs(tiles64), np.abs(q64))[:, :, 0]
    del tiles64
    ok, err = _product_check(out, plain, ref, absum)
    tiles_f = dense.view(-1, _MB, _V)[tidx.long()].to(torch.float32)
    qcol = qloc[:, :, None]
    n_slices = tidx.numel()
    distinct = torch.unique(tidx).numel()
    rec = _kernel_record(
        "pallas_pipelined_blocks", "tile_matvec", 512, dev, reps, ok, err,
        lambda: pk.tile_matvec(dense, tidx, qloc, _MB),
        lambda: pk.tile_matvec_plain(dense, tidx, qloc, _MB),
        ("torch.bmm(tiles_f32, qloc) over tiles gathered and cast outside "
         "the timing", lambda: torch.bmm(tiles_f, qcol)),
        nbytes=distinct * _MB * _V + n_slices * (4 + _V * 4 + _MB * 4),
        nops=2.0 * n_slices * _MB * _V,
        tolerance="1e-6 * sum_v |tile * qloc| of the f64 product, all rows")
    del tiles_f
    t = rec["ms"] * 1e-3
    rec.update(us_per_tile=t / n_slices * 1e6,
               gb_s=n_slices * _MB * _V / t / 1e9)
    print(f"[pallas_pipelined_blocks] ok={ok} {t*1e3:.3f} ms for "
          f"{n_slices} tiles ({rec['us_per_tile']:.3f} us/tile, "
          f"{rec['gb_s']:.2f} GB/s)")
    return rec


def run(device=None, only=None, reps: int = 200, verbose: bool = False):
    """Run every probe whose name contains `only` (all by default) on
    `device` (the card by default). Returns (records, failures): a probe
    that raised or whose check missed is a failure, and the others still
    run."""
    dev = resolve_device(device)
    records, failures = [], []
    with full_f32():
        for fn in PROBES:
            if only and only not in fn.__name__:
                continue
            try:
                rec = fn(dev, reps)
            except Exception as e:  # noqa: BLE001 - reported, run goes on
                print(f"[{fn.__name__}] FAILED: {type(e).__name__}: "
                      f"{str(e)[:400]}")
                if verbose:
                    traceback.print_exc()
                failures.append(fn.__name__)
                continue
            records.append(rec)
            if not rec["ok"]:
                failures.append(fn.__name__)
            if rec.get("device_ms") is not None:
                print(f"  {rec['name']}: {rec['device_ms'] * 1e3:.2f} us on "
                      f"the card, {rec['device_cold_ms'] * 1e3:.2f} with L2 "
                      f"flushed by a write, "
                      f"{rec['device_cold_read_ms'] * 1e3:.2f} by a read; "
                      f"bound {rec['bound_ms'] * 1e3:.3f} us by "
                      f"{rec['bound_by']}; plain {rec['plain_ms'] * 1e3:.2f} "
                      f"us, library {rec['library']}: {rec['library_ms']} "
                      f"ms a call, on the card {rec['library_device_ms']} / "
                      f"{rec['library_device_cold_ms']} / "
                      f"{rec['library_device_cold_read_ms']} ms")
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return records, failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help="substring filter on probe names")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("-v", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device: {name}")
    dev_us = None
    if dev.type == "cuda":
        host_us, dev_us = launch_floor_us(dev)
        print(f"launch floor: {host_us:.2f} us a call, {dev_us:.2f} us on "
              "the card")
    records, failures = run(dev, args.only, verbose=args.v)
    for rec in records if dev_us is not None else ():
        low = below_floor(rec, dev_us * 1e-3)
        if low:
            print(f"[{rec['probe']}] device times under the launch floor: "
                  f"{low}")
            failures.append(rec["probe"])
    if failures:
        print(f"FAILED: {', '.join(failures)}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
