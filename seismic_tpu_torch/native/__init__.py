"""ctypes bindings for the native (C++) host code: the index-build core
(`build_core.cpp`) and the grouped-search planner (`planner.cpp`).

Each shared library is compiled at first use with g++ into the package's
git-ignored build directory (`seismic_tpu_torch/_build/`), never beside
the source. Its file name carries a hash of the source, the compiler
flags and the host CPU (model and feature flags), so a build directory
copied from another machine, or left from an older source, is never
loaded: a library built with `-march=native` runs only where it was
built. If the build core cannot be built, the index build falls back to
the pure-NumPy pipeline in seismic_tpu_torch/build (same semantics; see
build_core.cpp header). The planner has no silent fallback:
`plan_grouped_native` raises when its library cannot be built, and
`search/planner.py::plan_grouped(..., native=False)` asks for NumPy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "build_core.cpp")
_PLANNER_SRC = os.path.join(_DIR, "planner.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
# flag sets tried in order: the host's own instruction set, then portable
_FLAG_SETS = (("-O3", "-march=native"), ("-O3",))
_COMMON_FLAGS = ("-std=c++17", "-shared", "-fPIC", "-pthread")
_lock = threading.Lock()
_lib = None
_lib_failed = False
_planner_lib = None


def _host_cpu() -> str:
    """The host CPU's model and feature flags (what -march=native reads)."""
    try:
        with open("/proc/cpuinfo") as f:
            return "".join(
                line for line in f
                if line.startswith(("model name", "flags"))
            )
    except OSError:
        return platform.machine() + platform.processor()


def lib_path(name: str, src: str, flags) -> str:
    """Build-directory path of library `name` compiled from `src` with
    `flags` on this host."""
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update("\0".join(flags).encode())
    h.update(_host_cpu().encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_host_lib(name: str, src: str) -> str:
    """Path of the g++ build of `src` for this host, compiled if no build
    with the same key exists. Raises RuntimeError with the compiler's
    output when no flag set compiles."""
    flag_sets = [(*f, *_COMMON_FLAGS) for f in _FLAG_SETS]
    for flags in flag_sets:
        path = lib_path(name, src, flags)
        if os.path.exists(path):
            return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    errors = []
    for flags in flag_sets:
        path = lib_path(name, src, flags)
        # compile to a private name, then rename: a concurrent loader
        # never opens a half-written library
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            r = subprocess.run(["g++", *flags, "-o", tmp, src],
                               capture_output=True, text=True)
        except OSError as e:
            errors.append(f"g++ {' '.join(flags)}: {e}")
            continue
        if r.returncode == 0:
            os.replace(tmp, path)
            return path
        errors.append(f"g++ {' '.join(flags)}:\n{r.stderr}")
    raise RuntimeError(f"cannot build {os.path.basename(src)}:\n"
                       + "\n".join(errors))


def get_lib():
    """Load (building if necessary) the native library, or None."""
    global _lib, _lib_failed
    if _lib is not None:
        return _lib
    if _lib_failed:
        return None
    with _lock:
        if _lib is not None:
            return _lib
        try:
            path = build_host_lib("seismic_build", _SRC)
        except RuntimeError:
            _lib_failed = True
            return None
        lib = ctypes.CDLL(path)
        i64 = ctypes.c_int64
        i32 = ctypes.c_int32
        u64 = ctypes.c_uint64
        f32 = ctypes.c_float
        p = ctypes.c_void_p
        lib.seismic_build.restype = p
        lib.seismic_build.argtypes = [
            p, p, p, i64, i64,  # dataset
            p, p, i64,  # posting table
            f32, i32, i32, i32, f32, i32, i32, i32, u64, i32, i32, i32, i32,
        ]
        lib.seismic_get_sizes.restype = None
        lib.seismic_get_sizes.argtypes = [p, p, p, p]
        lib.seismic_copy_out.restype = None
        lib.seismic_copy_out.argtypes = [p] + [p] * 19
        lib.seismic_free.restype = None
        lib.seismic_free.argtypes = [p]
        _lib = lib
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def native_build_lists(
    ds_offsets: np.ndarray,
    ds_comps: np.ndarray,
    ds_vals: np.ndarray,
    dim: int,
    pt_offsets: np.ndarray,
    pt_docs: np.ndarray,
    *,
    centroid_fraction: float,
    min_cluster_size: int,
    doc_cut: int,
    max_block_len: int,
    summary_energy: float,
    n_summary_components: int,  # -1 => energy-preserving
    max_summary_nnz: int,
    v_cap: int,
    seed: int,
    fixed_block_size: int = 0,
    build_tiles: bool = True,
    overflow: int = 0,
    n_threads: int = 0,
):
    """Run the native per-list build; returns a dict of flat arrays
    (same layout the NumPy pipeline produces). None if the lib is missing."""
    lib = get_lib()
    if lib is None:
        return None
    ds_offsets = np.ascontiguousarray(ds_offsets, dtype=np.int64)
    ds_comps = np.ascontiguousarray(ds_comps, dtype=np.int32)
    ds_vals = np.ascontiguousarray(ds_vals, dtype=np.float32)
    pt_offsets = np.ascontiguousarray(pt_offsets, dtype=np.int64)
    pt_docs = np.ascontiguousarray(pt_docs, dtype=np.int64)
    n_docs = len(ds_offsets) - 1
    n_lists = len(pt_offsets) - 1

    handle = lib.seismic_build(
        _ptr(ds_offsets), _ptr(ds_comps), _ptr(ds_vals),
        ctypes.c_int64(n_docs), ctypes.c_int64(dim),
        _ptr(pt_offsets), _ptr(pt_docs), ctypes.c_int64(n_lists),
        ctypes.c_float(centroid_fraction),
        ctypes.c_int32(min_cluster_size),
        ctypes.c_int32(doc_cut),
        ctypes.c_int32(max_block_len),
        ctypes.c_float(summary_energy),
        ctypes.c_int32(n_summary_components),
        ctypes.c_int32(max_summary_nnz),
        ctypes.c_int32(v_cap),
        ctypes.c_uint64(seed),
        ctypes.c_int32(fixed_block_size),
        ctypes.c_int32(1 if build_tiles else 0),
        ctypes.c_int32(overflow),
        ctypes.c_int32(n_threads),
    )
    try:
        tp = ctypes.c_int64()
        tb = ctypes.c_int64()
        ts = ctypes.c_int64()
        lib.seismic_get_sizes(
            handle, ctypes.byref(tp), ctypes.byref(tb), ctypes.byref(ts)
        )
        total_postings, total_blocks, total_sum = tp.value, tb.value, ts.value

        out = {
            "postings": np.empty(total_postings, np.int32),
            "posting_block_local": np.empty(total_postings, np.int32),
            "block_len": np.empty(total_blocks, np.int32),
            "list_n_blocks": np.empty(n_lists, np.int32),
            "list_len": np.empty(n_lists, np.int32),
            "summary_comps": np.empty(total_sum, np.int32),
            "summary_codes": np.empty(total_sum, np.uint8),
            "summary_len": np.empty(total_blocks, np.int64),
            "summary_min": np.empty(total_blocks, np.float32),
            "summary_quant": np.empty(total_blocks, np.float32),
            "list_vocab": np.empty((n_lists, v_cap), np.int32),
            "dense_summary": np.empty((total_blocks, v_cap), np.uint8),
            "dense_scale": np.empty(total_blocks, np.float32),
            "vocab_rank": np.empty((n_lists, v_cap), np.int16),
            "vocab_csum": np.empty((n_lists, 6), np.float32),
        }
        if build_tiles:
            out["doc_tiles"] = np.empty((total_postings, v_cap), np.uint8)
            out["doc_tile_scale"] = np.empty(total_postings, np.float32)
            o = max(overflow, 0)
            out["ovf_comps"] = np.empty((total_postings, o), np.int32)
            out["ovf_vals"] = np.empty((total_postings, o), np.float16)
        else:
            out["doc_tiles"] = np.empty((0, v_cap), np.uint8)
            out["doc_tile_scale"] = np.empty(0, np.float32)
            out["ovf_comps"] = np.empty((0, 0), np.int32)
            out["ovf_vals"] = np.empty((0, 0), np.float16)
        lib.seismic_copy_out(
            handle,
            _ptr(out["postings"]),
            _ptr(out["posting_block_local"]),
            _ptr(out["block_len"]),
            _ptr(out["list_n_blocks"]),
            _ptr(out["list_len"]),
            _ptr(out["summary_comps"]),
            _ptr(out["summary_codes"]),
            _ptr(out["summary_len"]),
            _ptr(out["summary_min"]),
            _ptr(out["summary_quant"]),
            _ptr(out["list_vocab"]),
            _ptr(out["dense_summary"]),
            _ptr(out["dense_scale"]),
            _ptr(out["doc_tiles"]),
            _ptr(out["doc_tile_scale"]),
            _ptr(out["ovf_comps"]),
            _ptr(out["ovf_vals"]),
            _ptr(out["vocab_rank"]),
            _ptr(out["vocab_csum"]),
        )
        return out
    finally:
        lib.seismic_free(handle)


# ---------------------------------------------------------------------------
# Native host planner (planner.cpp), a library of its own
# ---------------------------------------------------------------------------


def get_planner_lib():
    """Load the planner library, building it if needed; raises
    RuntimeError when it cannot be built."""
    global _planner_lib
    if _planner_lib is not None:
        return _planner_lib
    with _lock:
        if _planner_lib is None:
            lib = ctypes.CDLL(build_host_lib("seismic_planner", _PLANNER_SRC))
            lib.seismic_plan_grouped.restype = ctypes.c_int
            _planner_lib = lib
        return _planner_lib


def plan_grouped_native(q_comps, q_vals, ctx, query_cut: int, M: int = 8):
    """Native counting-sort planner (`seismic_tpu/native/__init__.py::
    plan_grouped_native`); returns a GroupedPlan. Group composition may
    differ from the NumPy planner (top-QC tie order), but all plan
    invariants hold and search results are identical."""
    lib = get_planner_lib()
    from ..search.planner import GroupedPlan, _round_up

    q_comps = np.ascontiguousarray(q_comps, np.int32)
    q_vals = np.ascontiguousarray(q_vals, np.float32)
    B, Q = q_comps.shape
    QC = min(query_cut, Q)
    csub = ctx.csub
    P_cap = B * QC
    G_max = P_cap + 1
    # worst case: every pair a singleton group of a max-length list
    max_nsup = max(
        1,
        -(-int(np.max(ctx.list_len, initial=1)) // (128 * csub)),
    )
    W_max = int(P_cap) * max_nsup + 1

    group_list = np.zeros(G_max, np.int32)
    group_region = np.zeros(G_max, np.int32)
    group_nrows = np.zeros(G_max, np.int32)
    slot_b = np.full(G_max * M, B, np.int32)  # pad slots read B
    work_region = np.empty(W_max, np.int32)
    work_g = np.empty(W_max, np.int32)
    work_s = np.empty(W_max, np.int32)
    pair_slot = np.zeros(P_cap, np.int32)
    pair_pstart = np.zeros(P_cap, np.int32)
    pair_valid = np.zeros(P_cap, np.int32)
    pair_list = np.zeros(P_cap, np.int32)
    pair_len = np.zeros(P_cap, np.int32)
    slot_pair = np.zeros(G_max * M, np.int32)
    n_out = np.zeros(2, np.int32)

    rc = lib.seismic_plan_grouped(
        _ptr(q_comps), _ptr(q_vals),
        ctypes.c_int(B), ctypes.c_int(Q), ctypes.c_int(QC),
        ctypes.c_int(M), ctypes.c_int(csub),
        _ptr(np.ascontiguousarray(ctx.list_region_start, np.int32)),
        _ptr(np.ascontiguousarray(ctx.list_len, np.int32)),
        _ptr(np.ascontiguousarray(ctx.list_post_start, np.int32)),
        ctypes.c_int(ctx.n_lists),
        ctypes.c_int(G_max), ctypes.c_longlong(W_max),
        _ptr(group_list), _ptr(group_region), _ptr(group_nrows),
        _ptr(slot_b), _ptr(work_region), _ptr(work_g), _ptr(work_s),
        _ptr(pair_slot), _ptr(pair_pstart), _ptr(pair_valid),
        _ptr(pair_list), _ptr(pair_len), _ptr(slot_pair),
        _ptr(n_out),
    )
    if rc != 0:
        raise RuntimeError(f"native planner: capacity overflow (rc={rc})")
    G, W = int(n_out[0]), int(n_out[1])
    G_cap = _round_up(G + 1, 512)
    W_cap = _round_up(W, 2048)

    def cap1(a, n, cap, fill):
        out = np.full(cap, fill, a.dtype)
        out[:n] = a[:n]
        return out

    sb2 = np.full((G_cap, M), B, np.int32)
    sb2[:G] = slot_b[: G * M].reshape(G, M)
    sp = np.zeros(G_cap * M, np.int32)
    sp[: G * M] = slot_pair[: G * M]
    return GroupedPlan(
        M=M, G=G, W=W,
        group_list=cap1(group_list, G, G_cap, 0),
        group_region=cap1(group_region, G, G_cap, 0),
        group_nrows=cap1(group_nrows, G, G_cap, 0),
        slot_b=sb2,
        work_region=cap1(work_region, W, W_cap, ctx.zero_region),
        work_g=cap1(work_g, W, W_cap, G),
        work_s=cap1(work_s, W, W_cap, 0),
        pair_slot=pair_slot.reshape(B, QC),
        pair_pstart=pair_pstart.reshape(B, QC),
        pair_valid=pair_valid.reshape(B, QC).astype(bool),
        pair_list=pair_list.reshape(B, QC),
        pair_len=pair_len.reshape(B, QC),
        slot_pair=sp,
    )
