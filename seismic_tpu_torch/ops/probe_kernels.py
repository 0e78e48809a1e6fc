"""The device probe's nine kernels (K10-K18): wrappers and plain versions.

Counterparts of the nine `pallas_call`s of `seismic_tpu/harness/
device_probe.py`, written for the H100 in `csrc/device_probe.cu`:

    table_take         out[i] = table[idx[i]]                  (K10, :86)
    row_gather         out[r] = hbm[idx[r]]                    (K11, :151)
    compare_intersect  out[t] = sum_w vals[t, w] * qmatch[t, w]  (K12, :188)
    u8_matvec          out = (f32(tile) @ q) * scale           (K13, :230)
    take_along_axis    out[m, c] = table[idx[m, c], c]         (K14, :270)
    flat_row_gather    out[r] = flat[idx[r] * W : + W]         (K15, :338)
    compare_term_loop  as compare_intersect, terms outer       (K16, :382)
    i8_matmul          out = f32(tile) @ q                     (K17, :426)
    tile_matvec        out[i] = f32(dense[tidx[i] * MB : + MB]) @ qloc[i]
                                                               (K18, :554)

with qmatch[t, w] = sum_q qv[q] * [comps[t, w] == qc[q]] (on the card K12
and K16 are one kernel that looks each element up in a table of the
terms). An index outside its table reads nothing and gives 0 (a row of
zeros), in the kernels and in the plain versions alike. Each wrapper
checks its operands, runs its plain version (`<name>_plain`) for tensors
on the CPU, and launches its kernel for CUDA tensors, adding one to
`launches[<name>]`; a kernel that fails to build or launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

NAMES = ("table_take", "row_gather", "compare_intersect", "u8_matvec",
         "take_along_axis", "flat_row_gather", "compare_term_loop",
         "i8_matmul", "tile_matvec")
# kernel launches since the counts were last set to 0, one per wrapper
launches = dict.fromkeys(NAMES, 0)
_handle = None
# the limits of csrc/device_probe.cu: K12 and K16 (one kernel) take at
# most kMaxTerms terms, on both entry points; K18 stages at most 48 KB / 4
# floats of qloc (the dynamic shared memory a block gets without opting in)
MAX_TERMS = 1024
MAX_STAGE = 48 * 1024 // 4


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _in_range(idx, n: int):
    """(idx clamped into [0, n) as int64, mask of the indices inside)."""
    return idx.long().clamp(0, max(n - 1, 0)), (idx >= 0) & (idx < n)


def table_take_plain(table, idx):
    j, ok = _in_range(idx, table.shape[0])
    return torch.where(ok, table[j], 0.0)


def row_gather_plain(hbm, idx):
    j, ok = _in_range(idx, hbm.shape[0])
    return torch.where(ok[:, None], hbm[j], 0.0)


def flat_row_gather_plain(flat, idx, width: int):
    j, ok = _in_range(idx, flat.shape[0] // width)
    off = j[:, None] * width + torch.arange(width, device=flat.device)
    return torch.where(ok[:, None], flat[off], 0.0)


def compare_intersect_plain(comps, vals, qc, qv):
    """The TPU body's broadcast form: [T, W, Q] compares, summed over Q,
    then over W. qc / qv are [Q]."""
    eq = comps[:, :, None] == qc[None, None, :]
    qmatch = torch.where(eq, qv, 0.0).sum(-1)
    return (vals * qmatch).sum(-1, keepdim=True)


def compare_term_loop_plain(comps, vals, qc, qv):
    """The TPU body's loop over the terms. qc / qv are [1, Q]."""
    qmatch = torch.zeros(comps.shape, dtype=torch.float32,
                         device=comps.device)
    for i in range(qc.shape[1]):
        qmatch = qmatch + torch.where(comps == qc[0, i], qv[0, i], 0.0)
    return (vals * qmatch).sum(-1, keepdim=True)


def u8_matvec_plain(tile, q, scale):
    return (tile.to(torch.float32) @ q) * scale


def take_along_axis_plain(table, idx):
    j, ok = _in_range(idx, table.shape[0])
    return torch.where(ok, torch.gather(table, 0, j), 0.0)


def i8_matmul_plain(tile, q):
    return tile.to(torch.float32) @ q


def tile_matvec_plain(dense, tidx, qloc, rows: int):
    n_tiles = dense.shape[0] // rows
    t, ok = _in_range(tidx, n_tiles)
    tiles = dense[:n_tiles * rows].view(n_tiles, rows, -1)[t]
    out = torch.bmm(tiles.to(torch.float32), qloc[:, :, None])[:, :, 0]
    return torch.where(ok[:, None], out, 0.0)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _lib():
    global _handle
    if _handle is None:
        lib = _cuda.load("device_probe")
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        sigs = {
            "seismic_probe_empty": [p],
            "seismic_probe_spin": [ctypes.c_uint64, p],
            "seismic_probe_table_take": [p, i, p, i, p, p],
            "seismic_probe_row_gather": [p, i64, p, i, i, p, p],
            "seismic_probe_flat_row_gather": [p, i64, p, i, i, p, p],
            "seismic_probe_compare_intersect": [p, p, p, p, i, i, i, p, p],
            "seismic_probe_compare_term_loop": [p, p, p, p, i, i, i, p, p],
            "seismic_probe_u8_matvec": [p, p, p, i, i, p, p],
            "seismic_probe_take_along_axis": [p, i, i, p, i64, p, p],
            "seismic_probe_i8_matmul": [p, p, i, i, i, p, p],
            "seismic_probe_tile_matvec": [p, i, p, p, i, i, i, p, p],
        }
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _handle = lib
    return _handle


def _on_card(name: str, tensors, aligned: bool = True) -> bool:
    """False for CPU operands (the plain version runs); True for CUDA
    operands, after checking they share one card, are contiguous and,
    with `aligned`, 16-byte aligned (the kernels' vector loads)."""
    req = _cuda.require
    dev = tensors[0].device
    req(all(t.device == dev for t in tensors),
        f"{name}: all operands must be on one device")
    if dev.type == "cpu":
        return False
    req(dev.type == "cuda", f"{name}: unsupported device {dev}")
    req(all(t.is_contiguous() for t in tensors),
        f"{name}: operands must be contiguous")
    req(not aligned or all(t.data_ptr() % 16 == 0 for t in tensors),
        f"{name}: operands must be 16-byte aligned")
    return True


def _launch(name: str, fn, *args, device) -> None:
    rc = fn(*args, ctypes.c_void_p(_cuda.stream_handle(device)))
    _cuda.check(rc, name)
    launches[name] += 1


def empty_launch(device) -> None:
    """Launch the empty kernel once: the launch floor of these wrappers
    (not counted)."""
    rc = _lib().seismic_probe_empty(
        ctypes.c_void_p(_cuda.stream_handle(device)))
    _cuda.check(rc, "empty")


def spin(device, ns: int) -> None:
    """Hold the current stream for `ns` ns of the card's clock (one
    thread; not counted)."""
    rc = _lib().seismic_probe_spin(
        ns, ctypes.c_void_p(_cuda.stream_handle(device)))
    _cuda.check(rc, "spin")


def table_take(table, idx):
    """table f32 [n]; idx int32 [...]. Returns f32 of idx's shape. On the
    card each lookup reads the table through the L1 / L2 caches (nothing
    is staged, so the table is bounded only by int indexing), 4 lookups a
    thread from one 16-byte load of idx where idx is 16-byte aligned,
    scalar loads where it is not."""
    req = _cuda.require
    req(table.dim() == 1 and table.dtype == torch.float32
        and 0 < table.shape[0] < 2 ** 31,
        "table must be f32 [n], 0 < n < 2^31")
    req(idx.dtype == torch.int32, "idx must be int32")
    if not _on_card("table_take", (table, idx), aligned=False):
        return table_take_plain(table, idx)
    req(idx.numel() < 2 ** 31, "too many indices")
    out = torch.empty(idx.shape, dtype=torch.float32, device=table.device)
    p = _cuda.ptr
    _launch("table_take", _lib().seismic_probe_table_take, p(table),
            table.shape[0], p(idx), idx.numel(), p(out), device=table.device)
    return out


def _gather_checks(src, idx, width: int):
    req = _cuda.require
    req(src.dtype == torch.float32, "the table must be f32")
    req(idx.dim() == 1 and idx.dtype == torch.int32, "idx must be int32 [R]")
    req(width > 0 and width % 4 == 0, "row width must be a multiple of 4")


def row_gather(hbm, idx):
    """hbm f32 [n, W] (W % 4 == 0); idx int32 [R]. Returns f32 [R, W]."""
    _cuda.require(hbm.dim() == 2 and hbm.shape[0] > 0,
                  "hbm must be f32 [n, W], n > 0")
    _gather_checks(hbm, idx, hbm.shape[1])
    if not _on_card("row_gather", (hbm, idx)):
        return row_gather_plain(hbm, idx)
    R, W = idx.shape[0], hbm.shape[1]
    out = torch.empty((R, W), dtype=torch.float32, device=hbm.device)
    p = _cuda.ptr
    _launch("row_gather", _lib().seismic_probe_row_gather, p(hbm),
            hbm.shape[0], p(idx), R, W, p(out), device=hbm.device)
    return out


def flat_row_gather(flat, idx, width: int):
    """flat f32 [n]; idx int32 [R]. Returns f32 [R, width], row r read at
    flat offset idx[r] * width (width % 4 == 0)."""
    _cuda.require(flat.dim() == 1 and flat.shape[0] >= width,
                  "flat must be f32 [n], n >= width")
    _gather_checks(flat, idx, width)
    if not _on_card("flat_row_gather", (flat, idx)):
        return flat_row_gather_plain(flat, idx, width)
    R = idx.shape[0]
    out = torch.empty((R, width), dtype=torch.float32, device=flat.device)
    p = _cuda.ptr
    _launch("flat_row_gather", _lib().seismic_probe_flat_row_gather, p(flat),
            flat.shape[0], p(idx), R, width, p(out), device=flat.device)
    return out


def _compare_checks(comps, vals, qc, qv, row: bool):
    """Operands of K12 (qc, qv [Q]) or, with `row`, of K16 ([1, Q])."""
    req = _cuda.require
    req(comps.dim() == 2 and comps.dtype == torch.int32,
        "comps must be int32 [T, W]")
    req(vals.shape == comps.shape and vals.dtype == torch.float32,
        "vals must be f32 of comps' shape")
    q_ok = (qc.dim() == 2 and qc.shape[0] == 1) if row else qc.dim() == 1
    req(q_ok and qc.dtype == torch.int32,
        f"qc must be int32 {'[1, Q]' if row else '[Q]'}")
    req(qv.shape == qc.shape and qv.dtype == torch.float32,
        "qv must be f32 of qc's shape")


def _compare(name, entry, comps, vals, qc, qv):
    _cuda.require(qc.shape[-1] <= MAX_TERMS,
                  f"{qc.shape[-1]} terms exceed the kernel's cap {MAX_TERMS}")
    T, W = comps.shape
    out = torch.empty((T, 1), dtype=torch.float32, device=comps.device)
    p = _cuda.ptr
    _launch(name, getattr(_lib(), entry), p(comps), p(vals), p(qc), p(qv),
            T, W, qc.shape[-1], p(out), device=comps.device)
    return out


def compare_intersect(comps, vals, qc, qv):
    """comps int32 / vals f32 [T, W]; qc int32 / qv f32 [Q]. Returns f32
    [T, 1]. The plain version is the TPU body's broadcast form; the kernel
    (K12 and K16's one kernel, Q <= MAX_TERMS on the card) looks each
    element up in a shared-memory hash table of the terms, their values
    summed by id in term order."""
    _compare_checks(comps, vals, qc, qv, row=False)
    if not _on_card("compare_intersect", (comps, vals, qc, qv)):
        return compare_intersect_plain(comps, vals, qc, qv)
    return _compare("compare_intersect", "seismic_probe_compare_intersect",
                    comps, vals, qc, qv)


def compare_term_loop(comps, vals, qc, qv):
    """comps int32 / vals f32 [T, W]; qc int32 / qv f32 [1, Q]. Returns f32
    [T, 1]. The plain version is the TPU body's loop over the terms; the
    kernel is compare_intersect's (Q <= MAX_TERMS on the card: more
    raise)."""
    _compare_checks(comps, vals, qc, qv, row=True)
    if not _on_card("compare_term_loop", (comps, vals, qc, qv)):
        return compare_term_loop_plain(comps, vals, qc, qv)
    return _compare("compare_term_loop", "seismic_probe_compare_term_loop",
                    comps, vals, qc, qv)


def u8_matvec(tile, q, scale):
    """tile u8 [M, K] (K % 4 == 0); q f32 [K, 1]; scale f32 [M, 1].
    Returns f32 [M, 1] = (f32(tile) @ q) * scale. On the card a warp
    takes a row in one round of loads (16 bytes of the row and 16 values
    of q a lane, 16-byte loads where K % 16 == 0), any K, 4 rows a
    block; its sum order (16 products a lane, then the warp's xor tree)
    keeps it within 1e-6 * sum_k |tile * q| * |scale| of an f64
    product."""
    req = _cuda.require
    req(tile.dim() == 2 and tile.dtype == torch.uint8, "tile must be u8")
    M, K = tile.shape
    req(K % 4 == 0, "K must be a multiple of 4")
    req(q.shape == (K, 1) and q.dtype == torch.float32, "q must be f32 [K, 1]")
    req(scale.shape == (M, 1) and scale.dtype == torch.float32,
        "scale must be f32 [M, 1]")
    if not _on_card("u8_matvec", (tile, q, scale)):
        return u8_matvec_plain(tile, q, scale)
    out = torch.empty((M, 1), dtype=torch.float32, device=tile.device)
    p = _cuda.ptr
    _launch("u8_matvec", _lib().seismic_probe_u8_matvec, p(tile), p(q),
            p(scale), M, K, p(out), device=tile.device)
    return out


def take_along_axis(table, idx):
    """table f32 [R, C]; idx int32 [M, C]. Returns f32 [M, C] with
    out[m, c] = table[idx[m, c], c]. On the card a warp takes a row and
    a lane 4 of its columns, 32 apart, reading the table through L1 /
    L2."""
    req = _cuda.require
    req(table.dim() == 2 and table.dtype == torch.float32
        and table.shape[0] > 0, "table must be f32 [R, C], R > 0")
    req(idx.dim() == 2 and idx.dtype == torch.int32
        and idx.shape[1] == table.shape[1], "idx must be int32 [M, C]")
    if not _on_card("take_along_axis", (table, idx)):
        return take_along_axis_plain(table, idx)
    R, C = table.shape
    out = torch.empty(idx.shape, dtype=torch.float32, device=table.device)
    p = _cuda.ptr
    _launch("take_along_axis", _lib().seismic_probe_take_along_axis,
            p(table), R, C, p(idx), idx.numel(), p(out), device=table.device)
    return out


def i8_matmul(tile, q):
    """tile int8 [M, K]; q f32 [K, N], any M, K, N >= 0. Returns f32 [M, N]
    = f32(tile) @ q. The kernel runs on the bf16 tensor cores: the int8
    values are exact in bf16 and q is split into three bf16 terms that sum
    to it exactly, so every product is exact and only the f32 sums round
    (within 1e-6 * sum_k |tile * q| of an f64 product); a block computes a
    32 x 16 tile, its 8 warps splitting K, so [512, 512] @ [512, 128]
    spreads over 128 blocks."""
    req = _cuda.require
    req(tile.dim() == 2 and tile.dtype == torch.int8, "tile must be int8")
    req(q.dim() == 2 and q.dtype == torch.float32
        and q.shape[0] == tile.shape[1], "q must be f32 [K, N]")
    if not _on_card("i8_matmul", (tile, q), aligned=False):
        return i8_matmul_plain(tile, q)
    (M, K), N = tile.shape, q.shape[1]
    req(N <= 65535 * 16, f"N={N} exceeds the kernel's grid")
    out = torch.empty((M, N), dtype=torch.float32, device=tile.device)
    p = _cuda.ptr
    _launch("i8_matmul", _lib().seismic_probe_i8_matmul, p(tile), p(q), M,
            K, N, p(out), device=tile.device)
    return out


def tile_matvec(dense, tidx, qloc, rows: int):
    """dense int8 [n_tiles * rows, V] (V % 4 == 0); tidx int32 [NS]; qloc
    f32 [NS, V]. Returns f32 [NS, rows] with out[i] = f32(tile tidx[i]) @
    qloc[i], tile t being dense rows [t * rows, (t + 1) * rows)."""
    req = _cuda.require
    req(dense.dim() == 2 and dense.dtype == torch.int8
        and dense.shape[0] >= rows > 0, "dense must be int8 [n, V], n >= rows")
    V = dense.shape[1]
    req(V % 4 == 0, "V must be a multiple of 4")
    req(tidx.dim() == 1 and tidx.dtype == torch.int32, "tidx must be int32")
    req(qloc.shape == (tidx.shape[0], V) and qloc.dtype == torch.float32,
        "qloc must be f32 [NS, V]")
    if not _on_card("tile_matvec", (dense, tidx, qloc)):
        return tile_matvec_plain(dense, tidx, qloc, rows)
    req(V <= MAX_STAGE, f"V={V} exceeds the stage cap")
    NS = tidx.shape[0]
    out = torch.empty((NS, rows), dtype=torch.float32, device=dense.device)
    p = _cuda.ptr
    _launch("tile_matvec", _lib().seismic_probe_tile_matvec, p(dense),
            dense.shape[0] // rows, p(tidx), p(qloc), NS, rows, V, p(out),
            device=dense.device)
    return out
