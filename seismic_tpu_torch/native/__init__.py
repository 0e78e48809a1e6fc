"""ctypes bindings for the native (C++) index-build core.

The shared library is compiled on first use with g++ into the package's
git-ignored build directory (`seismic_tpu_torch/_build/`), never beside
the source; if the toolchain is unavailable the caller falls back to the
pure-NumPy pipeline in seismic_tpu_torch/build (same semantics; see
build_core.cpp header). The grouped-search planner stays in NumPy in this
package (search/planner.py::plan_grouped_numpy).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "build_core.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_LIB = os.path.join(BUILD_DIR, "libseismic_build.so")
_lock = threading.Lock()
_lib = None
_lib_failed = False


def ensure_built() -> Optional[str]:
    """Compile the shared library if needed; returns its path or None."""
    global _lib_failed
    if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= os.path.getmtime(
        _SRC
    ):
        return _LIB
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a private name, then rename: a concurrent loader never
    # opens a half-written library
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    for flags in (["-O3", "-march=native"], ["-O3"]):
        try:
            subprocess.check_call(
                ["g++", *flags, "-std=c++17", "-shared", "-fPIC",
                 "-o", tmp, _SRC, "-pthread"],
                stderr=subprocess.DEVNULL,
            )
            os.replace(tmp, _LIB)
            return _LIB
        except Exception:
            continue
    _lib_failed = True
    return None


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
        path = ensure_built()
        if path is None:
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
