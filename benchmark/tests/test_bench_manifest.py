"""BENCHMARK.json against its format rules, and every name in it
found as a file."""

import json
import os
import re

import pytest

from bench_testutil import BENCH, CELLS, ROOT, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return manifest.benchmark(ROOT)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert bench["paths"] == ["benchmark"]
    assert 1 <= len(bench["command"]) <= 32
    for word in bench["command"]:
        assert TEXT.match(word) and not word.startswith("/") and ".." not in word
    assert os.path.isfile(os.path.join(ROOT, bench["command"][1]))


def test_run_seconds_fits_the_check(bench):
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells: 2 + 14 a cell runs, 60 s each beyond the
    # window, 2 x 90 s a cell to compile, 1200 s spare, in 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_texts(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"])
        assert TEXT.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(("config", c["name"]))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
        names.append(("cell", w["name"]))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(("metric", m["name"]))
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer_metrics(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert TEXT.match(m["layer"]) and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline_pct"):
            assert m["unit"] == "%"


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e, per_layer = manifest.cell_metrics(bench, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert per_layer
        for m in per_layer:
            assert m["moves"] in names


def test_every_name_is_a_file(bench):
    for c in bench["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg = manifest.load_config(c["name"])
        assert cfg["reduced"] == c["reduced"]
        assert os.path.isfile(os.path.join(BENCH, "entries",
                                           cfg["entry"] + ".py"))
        manifest.load_entry(cfg["entry"])
    for w in bench["workloads"]:
        cell = manifest.load_cell(w["name"], bench)
        manifest.load_config(cell["config"])
        manifest.load_traffic(cell["traffic"])
        assert cell["why"] == w["why"]
        assert cell["limits"]
    for m in bench["per_layer"]:
        assert callable(manifest.load_metric(m["name"]).read)
    for kernel in ("k3", "k4", "k7"):
        mod = manifest.load_count(kernel)
        assert mod.KERNEL and mod.ARITH and callable(mod.count)
    assert set(CELLS) == {w["name"] for w in bench["workloads"]}


def test_cells_take_one_chip_and_every_config_is_used(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    assert all(w["chips"] == 1 for w in bench["workloads"])


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, dirs, files in os.walk(BENCH):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", ".cache")]
        for f in files + dirs:
            assert re.match(r"^[A-Za-z0-9_.\-]+$", f), f


def test_manifest_refuses_a_path_for_a_name():
    with pytest.raises(ValueError):
        manifest.check_name("../BENCHMARK")
    with pytest.raises(ValueError):
        manifest.check_name("a b")
    json.dumps(manifest.check_name("device_busy_ms.grouped"))
