"""Finding things by name.

`BENCHMARK.json` sits beside the benchmark's folder. Everything that
belongs to one cell, configuration, traffic mix, entry, per-layer metric
or kernel count is a file of its own under the benchmark's folder, found
by the name the manifest gives:

    workloads/<cell>.json      configuration, traffic, chips, why, limits
    configs/<config>.json      corpus, index build, query settings, entry
    traffic/<traffic>.json     clients, batch, query pool, overrides
    entries/<entry>.py         builds the system under test, serves a batch
    metrics/<metric>.py        reads one per-layer metric from a run
    counts/<kernel>.py         a kernel's least bytes and operations

So a later cell, configuration, traffic mix or metric is new files and
new manifest entries, and no edit of a file that is here.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def check_name(name: str) -> str:
    """`name` if it is a manifest name (letters, digits, `_`, `.`, `-`;
    at most 64), else ValueError: a name becomes a file name."""
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"not a manifest name: {name!r}")
    return name


def _json(kind: str, name: str, root: str) -> dict:
    path = os.path.join(root, kind, check_name(name) + ".json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} file {path}")
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_cell(name: str, bench: dict, bench_dir: str = BENCH_DIR) -> dict:
    """The cell's file, held to its manifest entry (configuration,
    traffic and chips must agree)."""
    entry = [w for w in bench["workloads"] if w["name"] == name]
    if len(entry) != 1:
        raise KeyError(f"cell {name!r} is not in BENCHMARK.json")
    cell = _json("workloads", name, bench_dir)
    for key in ("config", "traffic", "chips"):
        if cell.get(key) != entry[0][key]:
            raise ValueError(f"cell {name}: {key} {cell.get(key)!r} in its "
                             f"file, {entry[0][key]!r} in BENCHMARK.json")
    return dict(cell, name=name)


def load_config(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return dict(_json("configs", name, bench_dir), name=name)


def load_traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return dict(_json("traffic", name, bench_dir), name=name)


def _module(kind: str, name: str, bench_dir: str):
    path = os.path.join(bench_dir, kind, check_name(name) + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} module {path}")
    mod_name = f"_bench_{kind}_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_entry(name: str, bench_dir: str = BENCH_DIR):
    return _module("entries", name, bench_dir)


def load_metric(name: str, bench_dir: str = BENCH_DIR):
    return _module("metrics", name, bench_dir)


def load_count(kernel: str, bench_dir: str = BENCH_DIR):
    return _module("counts", kernel, bench_dir)


def cell_metrics(bench: dict, cell: str):
    """(end-to-end metrics, per-layer metrics) that `cell` reports: those
    without a `workloads` list and those whose list names it."""
    def mine(m):
        return "workloads" not in m or cell in m["workloads"]

    return ([m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)])
