"""Build and load the hand-written CUDA kernels (`seismic_tpu_torch/csrc`).

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into its own
shared library with a plain C interface, `seismic_tpu_torch/_build/
lib<name>-<hash>.so`, at first use (or all at once, in parallel, by
`build()`), and loaded with ctypes. The hash is of the source, of every
`csrc/*.cuh` header it includes (headers of headers too) and of the
compiler flags, so a library left from an older source or header is never
loaded, whatever the files' times say. Every C entry point launches on the stream it is
given and returns `cudaGetLastError()`; `check()` raises on a non-zero
code. Nothing here runs at import time: the CPU tests import every module
of the package on a machine without `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
KERNELS = ("qloc", "grouped_scorer", "grouped_scorer_item", "rescore",
           "tiles_scorer", "grouped_scorer_f", "device_probe")
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict = {}
# ptxas resource report (registers, shared memory, spills) of each build
ptxas_report: dict = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def _src(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def lib_name(name: str, source: bytes, flags) -> str:
    """File name of kernel library `name` built from `source` with
    `flags`: it carries a hash of both."""
    h = hashlib.sha256(source)
    h.update("\0".join(flags).encode())
    return f"lib{name}-{h.hexdigest()[:16]}.so"


def source_with_headers(path: str, _seen=None) -> bytes:
    """The bytes of source `path` followed by those of every header it
    includes with `#include "..."` (resolved beside it, each once, in
    order of first inclusion): what a kernel library's name hashes."""
    seen = set() if _seen is None else _seen
    seen.add(os.path.abspath(path))
    with open(path, "rb") as f:
        text = f.read()
    parts = [text]
    for inc in _INCLUDE.findall(text):
        hdr = os.path.abspath(os.path.join(os.path.dirname(path),
                                           inc.decode()))
        if hdr not in seen:
            parts.append(source_with_headers(hdr, seen))
    return b"\0".join(parts)


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, lib_name(
        name, source_with_headers(_src(name)), NVCC_FLAGS))


def build(names=KERNELS, force: bool = False) -> float:
    """Compile the named kernels, one `nvcc` process per source, all
    started together. Returns the wall seconds; raises with the compiler
    output when any build fails."""
    t0 = time.time()
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        path = lib_path(name)
        if not force and os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        procs[name] = (tmp, path, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, _src(name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    errors = []
    for name, (tmp, path, proc) in procs.items():
        out, _ = proc.communicate()
        ptxas_report[name] = out
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed:\n{out}")
            continue
        # rename into place: a concurrent loader never opens a partial file
        os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.time() - t0


def ptxas_lines(report: str, needle: str) -> dict:
    """{kernel instance: its `-Xptxas -v` lines (spills, registers, shared
    memory)} of the entry functions in `report` (a build's compiler
    output) whose mangled names hold `needle`."""
    out, fn = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            fn = fn if needle in fn else None
            if fn:
                out[fn] = []
        elif fn and ("registers" in line or "spill" in line):
            out[fn].append(line.split(":", 1)[-1].strip())
    return out


def load(name: str):
    """The ctypes handle of kernel library `name`, built if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            build((name,))
            _libs[name] = ctypes.CDLL(lib_path(name))
        return _libs[name]


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {rc}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
