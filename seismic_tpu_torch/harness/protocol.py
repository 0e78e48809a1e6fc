"""The benchmark protocol that the probe drivers share.

The port's own copy of what the JAX package's probes import from the
repo's `bench.py` (its constants and environment variables, `bench.py:
43-60, 73`; `get_dataset`, `get_index`, `get_queries`,
`get_ground_truth`, `recall_at_k` and `log`, `bench.py:170-291`), and
nothing of its ladder, result line or gate. The collection is
`synth_dataset(N_DOCS, dim=30522, seed=7)`, the index
`GlobalThresholdPruning(N_POSTINGS, 2.0)` with `TpuLayout(32, V_CAP, 256,
TILE_OVERFLOW)` and f32 values, the queries distinct (a fresh seed every
1024, from 11) padded to 64 terms, the ground truth the exact top-10.

bench.py reads its environment once, when it is imported, and the JAX
probes set it first (or mutate its globals: `probe_r5c.py:324`). Here the
settings are a value, `Protocol`, made by `from_env` when a driver's
`main` runs, so drivers called one after another in one process do not
see each other's settings; `get_queries` takes its count as an argument.
Files keep bench.py's names, under the port's cache
(`.bench_cache/torch/`, listed in .gitignore) or the driver's
`--cache-dir`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import sys
import time

import numpy as np

from .export_synth import CACHE
from .export_synth import get_dataset as _synth_dataset

# the protocol's fields and the environment variables that set them
# (bench.py:43-60, 73); DIM, K and TARGET_RECALL are fixed there
ENV = {
    "n_docs": "BENCH_N_DOCS",
    "n_queries": "BENCH_N_QUERIES",
    "batch": "BENCH_BATCH",
    "n_postings": "BENCH_N_POSTINGS",
    "v_cap": "BENCH_V_CAP",
    "tile_overflow": "BENCH_TILE_OVERFLOW",
    "csub": "BENCH_CSUB",
    "narrow_v": "BENCH_NARROW_V",
}


@dataclasses.dataclass(frozen=True)
class Protocol:
    n_docs: int = 100_000
    dim: int = 30522
    n_queries: int = 16384
    k: int = 10
    batch: int = 4096
    target_recall: float = 0.97
    n_postings: int = 200
    v_cap: int = 1024
    tile_overflow: int = 64
    csub: int = 2
    narrow_v: int = 512
    cache: str = CACHE

    @property
    def index_base(self) -> str:
        """The index's path without its suffix (bench.py:205-207)."""
        return os.path.join(
            self.cache, f"index_{self.n_docs}_{self.dim}_{self.n_postings}"
            f"_v{self.v_cap}_o{self.tile_overflow}")

    def gt_path(self, n_queries: int) -> str:
        return os.path.join(self.cache,
                            f"gt_{self.n_docs}_{self.dim}_{n_queries}.npz")


def from_env(defaults: dict | None = None, overrides: dict | None = None,
             cache: str = CACHE, environ=None) -> Protocol:
    """The protocol as bench.py reads it when a driver has run
    `os.environ.setdefault(name, value)` for each of `defaults` and
    `os.environ[name] = value` for each of `overrides` (both keyed by the
    variable's name): an override wins, then the environment, then the
    default, then bench.py's own value."""
    env = os.environ if environ is None else environ
    kw = {}
    for field, var in ENV.items():
        val = (overrides or {}).get(var, env.get(var, (defaults or {}).get(
            var)))
        if val is not None:
            kw[field] = int(val)
    return Protocol(cache=cache, **kw)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def get_dataset(p: Protocol):
    """`synth_dataset(p.n_docs, p.dim, seed=7)`, cached as
    `docs_{n_docs}_{dim}.npz` (bench.py:170-188)."""
    return _synth_dataset(p.n_docs, p.dim, p.cache)


def index_config(p: Protocol):
    from ..config import Configuration, GlobalThresholdPruning, TpuLayout

    return Configuration(
        pruning=GlobalThresholdPruning(n_postings=p.n_postings,
                                       max_fraction=2.0),
        layout=TpuLayout(max_block_len=32, summary_vocab_cap=p.v_cap,
                         max_doc_nnz=256, tile_overflow=p.tile_overflow),
    )


def get_index(ds, p: Protocol):
    """(arrays, base): the f32 index, memory-mapped from `base + ".dir"`
    when it is there, else built, saved there with its build time beside
    it (bench.py:191-239)."""
    from ..build.builder import build_index
    from ..types import IndexArrays

    base = p.index_base
    dirpath = base + ".dir"
    if os.path.isdir(dirpath):
        t = time.time()
        arrays = IndexArrays.load_dir(dirpath)
        log(f"index mmap-loaded from cache: {time.time()-t:.2f}s")
        return arrays, base
    t = time.time()
    with contextlib.redirect_stdout(sys.stderr):
        arrays = build_index(ds, index_config(p), value_dtype="f32",
                             progress=True)
    build_secs = time.time() - t
    log(f"index build: {build_secs:.1f}s")
    os.makedirs(p.cache, exist_ok=True)
    arrays.save_dir(dirpath)
    with open(base + ".buildtime.json", "w") as f:
        json.dump({"build_secs": build_secs}, f)
    return arrays, base


def get_queries(n_queries: int, dim: int):
    """`n_queries` distinct queries (a fresh seed every 1024, from 11),
    padded to 64 terms (bench.py:242-261); copies of a stream made once a
    process (16,384 take seconds of host time)."""
    q_comps, q_vals = _query_stream(n_queries, dim)
    return q_comps.copy(), q_vals.copy()


@functools.lru_cache(maxsize=4)
def _query_stream(n_queries: int, dim: int):
    from ..data.sparse import pad_queries
    from .synth import synth_queries

    parts = []
    remaining = n_queries
    seed = 11
    while remaining > 0:
        n = min(1024, remaining)
        qc1, qv1 = synth_queries(n, dim=dim, seed=seed)
        parts.append(pad_queries(qc1, qv1, 64))
        remaining -= n
        seed += 1
    return (np.concatenate([q[0] for q in parts]),
            np.concatenate([q[1] for q in parts]))


def get_ground_truth(ds, q_comps, q_vals, p: Protocol, device=None):
    """The exact top-k ids of the queries on `device` (None: the card),
    cached as `gt_{n_docs}_{dim}_{n_queries}.npz` (bench.py:264-276)."""
    path = p.gt_path(len(q_comps))
    if os.path.exists(path):
        with np.load(path) as z:
            return z["ids"]
    from ..search.exact import exact_search

    t = time.time()
    _, ids = exact_search(ds, q_comps, q_vals, k=p.k, chunk=2048,
                          device=device)
    log(f"exact ground truth: {time.time()-t:.1f}s")
    os.makedirs(p.cache, exist_ok=True)
    np.savez(path, ids=ids)
    return ids


def recall_at_k(ids, gt_ids, k: int = 10) -> float:
    """Share of the ground truth's top-k ids found (bench.py:279-286)."""
    hits = tot = 0
    for r, g in zip(ids, gt_ids):
        rs = {int(x) for x in r[:k] if x >= 0}
        gs = {int(x) for x in g[:k] if x >= 0}
        hits += len(rs & gs)
        tot += len(gs)
    return hits / max(tot, 1)


# the launch counts of the kernels a grouped search can reach: (wrapper
# module under ops/, its count), by the names chip_smoke.py gives them
COUNTS = {
    "qloc": ("qloc", "launches"),
    "score_grouped_i8": ("grouped_scorer", "launches"),
    "rescore": ("rescore", "launches"),
    "score_grouped_i8_item": ("grouped_scorer_item", "launches"),
    "score_tiles": ("tiles_scorer", "launches"),
    "pack_epilogue": ("pack_epilogue", "launches"),
    "score_grouped_f": ("grouped_scorer_f", "launches"),
    "qloc_rowmajor": ("qloc_rowmajor", "launches"),
    "qloc_residue": ("qloc_residue", "launches"),
    "rescore_u8": ("rescore", "launches_u8"),
    "rescore_f16": ("rescore", "launches_f16"),
}


def kernel_launches() -> dict:
    """{kernel: its wrapper's launch count now} (host integers: reading
    them waits for nothing on the device)."""
    import importlib

    out = {}
    for name, (mod, attr) in COUNTS.items():
        out[name] = getattr(importlib.import_module(
            f"{__package__.rsplit('.', 1)[0]}.ops.{mod}"), attr)
    return out


def launches_since(before: dict) -> dict:
    """The kernels launched since `before` (a `kernel_launches()`), with
    their counts; the others left out."""
    now = kernel_launches()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def with_knn(index, graph):
    """`index` with the [n_docs, nknn] graph on its device (no second
    upload)."""
    import torch

    return dataclasses.replace(index, knn=torch.from_numpy(
        np.ascontiguousarray(graph, np.int32)).to(index.device))


def read_record(path: str) -> dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def write_record(path: str, art: dict) -> None:
    """Write `art` as JSON to `path` through a temporary file renamed into
    place, so a cut run leaves the previous record whole."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(art, f, indent=1)
    os.replace(tmp, path)
