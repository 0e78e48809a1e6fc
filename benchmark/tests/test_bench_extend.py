"""A later cell, traffic mix and per-layer metric are new files and new
manifest entries only: in a copy of the benchmark, add them, run the new
cell, and see the new metric read while no file that was there changed."""

import hashlib
import json
import os
import shutil

from bench_testutil import BENCH, fake_profiler, run_tiny


def _digests(root):
    out = {}
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", ".cache")]
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_dummy_cell_and_metric_from_files_alone(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    bench_dir = root / "benchmark"
    shutil.copytree(BENCH, bench_dir, ignore=shutil.ignore_patterns(
        "__pycache__", ".cache"))
    shutil.copy(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json"), root)
    before = _digests(bench_dir)

    # new files: a traffic mix, a cell, a metric reader
    (bench_dir / "traffic" / "closed1-b16.json").write_text(json.dumps(
        {"clients": 1, "batch": 16, "pool_batches": 2, "keep_share": 1.0,
         "search": {"query_cut": 8}}))
    (bench_dir / "workloads" / "dummy-b16.json").write_text(json.dumps(
        {"config": "msmarco-synth-headline", "traffic": "closed1-b16",
         "chips": 1, "why": "a test's cell",
         "limits": {"score_over": 1e-4, "bad_rows": 0}}))
    (bench_dir / "metrics" / "dummy_batches.py").write_text(
        "def read(run):\n    return float(run.batches)\n")
    # new manifest entries, appended
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench["workloads"].append({
        "name": "dummy-b16", "config": "msmarco-synth-headline",
        "traffic": "closed1-b16", "chips": 1, "why": "a test's cell"})
    bench["per_layer"].append({
        "name": "dummy_batches", "unit": "batches", "better": "higher",
        "source": "host_clock", "layer": "device", "moves": "qps",
        "workloads": ["dummy-b16"]})
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)

    after = _digests(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before

    fake_profiler(monkeypatch)
    rec = run_tiny("dummy-b16", traced=True, bench_dir=str(bench_dir))
    assert rec["correct"], rec["checks"]
    assert rec["metrics"]["dummy_batches"]["value"] >= 1
    assert rec["metrics"]["dummy_batches"]["unit"] == "batches"
    # the cell's own traffic took effect: one client, batches of 16
    assert rec["attempted"] % 16 == 0
