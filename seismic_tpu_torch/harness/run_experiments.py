"""TOML-driven build -> query -> evaluate experiment pipeline.

The port of `seismic_tpu/harness/run_experiments.py` (reference:
scripts/run_experiments.py), with the same TOML schema: a file with
[settings]/[folder]/[filename]/[indexing_parameters]/[query.*] sections
drives an index build, one timed query run per [query.X] subsection,
accuracy@k against exact ground truth, an optional metric against qrels,
and a report.tsv. Build and query run in-process through
`cli/build_inverted_index.py` and `cli/perf_inverted_index.py`; the
perf CLI's "microsecs per query" and "Total:" lines are read from its
captured output, and git context is recorded in the report directory.

Indexes go to `<folder.experiment>/indexes/`, named by their build
parameters (`index_filename`): a later experiment (or grid combination)
with the same [indexing_parameters] reuses the saved index instead of
building it again. `--device` (the card by default; `cpu` runs the plain
versions) goes to both CLIs.

TOML schema (docs/TomlInstructions.md in the reference):

  [settings]        k, metric ("RR@10"), exp-name, delete-index, ...
  [folder]          data (dir with documents.bin/queries.bin/...),
                    experiment (output root)
  [filename]        dataset, queries, groundtruth (TSV), qrels (optional)
  [indexing_parameters]   n-postings, centroid-fraction, summary-energy, ...
  [query.NAME]      query-cut, heap-factor, n-knn, batch-size, ...

    python -m seismic_tpu_torch.harness.run_experiments \\
        --exp experiments/best_configs_synth/recall_97.toml [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

try:
    import tomllib
except ImportError:  # pragma: no cover
    import tomli as tomllib  # type: ignore

REPORT_COLUMNS = [
    "name", "us_per_query", "accuracy", "metric", "metric_name",
    "total_bytes", "build_secs",
]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def git_info(repo_dir: str) -> dict:
    """Record branch + commit per experiment
    (reference: run_experiments.py:28-54); None outside a git checkout."""
    def run(cmd):
        try:
            return subprocess.check_output(
                cmd, cwd=repo_dir, text=True, stderr=subprocess.DEVNULL
            ).strip()
        except Exception:
            return None

    return {
        "branch": run(["git", "rev-parse", "--abbrev-ref", "HEAD"]),
        "commit": run(["git", "rev-parse", "HEAD"]),
    }


def index_filename(params: dict) -> str:
    """Encode build params in the index filename
    (reference: run_experiments.py:111-123)."""
    parts = []
    for key in sorted(params):
        val = str(params[key]).replace("/", "_")
        parts.append(f"{key.replace('-', '')[:8]}_{val}")
    name = ".".join(parts)
    return name[:180]


def _flags(params: dict) -> list:
    """`--key value` for each TOML key (`--key` alone for a true bool)."""
    argv = []
    for key, val in params.items():
        flag = "--" + key.replace("_", "-")
        if isinstance(val, bool):
            if val:
                argv.append(flag)
        else:
            argv += [flag, str(val)]
    return argv


def _device_flag(device) -> list:
    return [] if device is None else ["--device", str(device)]


def build_base_index(config: dict, index_dir: str,
                     device=None) -> tuple[str, float]:
    """(the saved index's path, build seconds; 0.0 when an index of the
    same parameters is already in `index_dir`)."""
    folder = config["folder"]
    filename = config.get("filename", {})
    ip = dict(config.get("indexing_parameters", {}))
    dataset_file = os.path.join(folder["data"],
                                filename.get("dataset", "documents.bin"))
    os.makedirs(index_dir, exist_ok=True)
    out = os.path.join(index_dir, index_filename(ip) or "index")
    full = out + ".index.seismic_tpu"
    if os.path.exists(full):
        log(f"index exists, reusing: {full}")
        return full, 0.0

    argv = ["--input-file", dataset_file, "--output-file", out]
    argv += _flags(ip) + _device_flag(device)
    from ..cli.build_inverted_index import main as build_main

    t0 = time.time()
    rc = build_main(argv)
    if rc:
        raise RuntimeError(f"index build failed with code {rc}")
    return full, time.time() - t0


def query_execution(
    config: dict, index_file: str, qname: str, qparams: dict, exp_dir: str,
    device=None,
) -> dict:
    folder = config["folder"]
    filename = config.get("filename", {})
    settings = config.get("settings", {})
    query_file = os.path.join(
        folder["data"], filename.get("queries", "queries.bin")
    )
    run_path = os.path.join(exp_dir, f"run_{qname}.tsv")
    argv = [
        "--index-file", index_file,
        "--query-file", query_file,
        "--output-path", run_path,
        "-k", str(settings.get("k", 10)),
    ]
    argv += _flags(qparams) + _device_flag(device)

    from ..cli.perf_inverted_index import main as perf_main

    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = perf_main(argv)
    if rc:
        raise RuntimeError(f"perf run failed with code {rc}")
    out = buf.getvalue()
    log(out)
    us = None
    total_bytes = None
    for line in out.splitlines():
        if "microsecs per query" in line and us is None:
            us = float(line.split()[1])
        if line.strip().startswith("Total:"):
            total_bytes = int(line.split()[1])
    return {
        "name": qname,
        "run_path": run_path,
        "us_per_query": us,
        "total_bytes": total_bytes,
        "wall_secs": time.time() - t0,
    }


def evaluate_run(config: dict, run_path: str) -> dict:
    from .evaluate import (
        accuracy_at_k,
        compute_metric,
        read_qrels,
        read_run_tsv,
    )

    folder = config["folder"]
    filename = config.get("filename", {})
    settings = config.get("settings", {})
    k = int(settings.get("k", 10))
    out = {}
    run = read_run_tsv(run_path)
    gt_name = filename.get("groundtruth")
    if gt_name:
        gt = read_run_tsv(os.path.join(folder["data"], gt_name))
        out["accuracy"] = accuracy_at_k(run, gt, k)
    qrels_name = filename.get("qrels")
    if qrels_name:
        qrels = read_qrels(os.path.join(folder["data"], qrels_name))
        # arbitrary ir_measures-style metric string from the TOML
        # (reference: run_experiments.py:242-284)
        metric_name = settings.get("metric", f"RR@{k}")
        out["metric"] = compute_metric(run, qrels, metric_name)
        out["metric_name"] = metric_name
    return out


def write_report(path: str, rows: list) -> None:
    with open(path, "w") as f:
        f.write("\t".join(REPORT_COLUMNS) + "\n")
        for r in rows:
            f.write("\t".join(str(r.get(c, "")) for c in REPORT_COLUMNS)
                    + "\n")


def run_experiment(toml_path: str, device=None) -> str:
    with open(toml_path, "rb") as f:
        config = tomllib.load(f)
    settings = config.get("settings", {})
    exp_root = config["folder"].get("experiment", "experiments_out")
    name = settings.get("exp-name", settings.get("exp_name", "exp"))
    exp_dir = os.path.join(exp_root, f"{name}_{int(time.time())}")
    os.makedirs(exp_dir, exist_ok=True)
    with open(os.path.join(exp_dir, "experiment.toml.json"), "w") as f:
        json.dump(config, f, indent=2, default=str)
    with open(os.path.join(exp_dir, "git.json"), "w") as f:
        json.dump(git_info(os.path.dirname(os.path.abspath(toml_path))), f)

    index_file, build_secs = build_base_index(
        config, os.path.join(exp_root, "indexes"), device)

    rows = []
    for qname, qparams in config.get("query", {}).items():
        res = query_execution(config, index_file, qname, qparams, exp_dir,
                              device)
        res.update(evaluate_run(config, res["run_path"]))
        res["build_secs"] = build_secs
        rows.append(res)
        log(f"[{qname}] {res}")

    report = os.path.join(exp_dir, "report.tsv")
    write_report(report, rows)
    log(f"report written to {report}")

    if settings.get("delete-index", False):
        os.remove(index_file)  # reference: run_experiments.py:559-561
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="TOML experiment runner")
    p.add_argument("--exp", required=True, help="experiment TOML file")
    p.add_argument("--device", default=None,
                   help="the card by default; 'cpu' runs the plain versions")
    args = p.parse_args(argv)
    run_experiment(args.exp, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
