"""Grid search over indexing x query parameters, resumable.

The port of `seismic_tpu/harness/run_grid_search.py` (reference:
scripts/run_grid_search.py): the TOML's [indexing_parameters] /
[querying_parameters] sections hold LISTS of values; every cartesian
combination becomes one experiment under `<folder.experiment>/grid_<exp-
name>/<combo hash>/` (combo.json, report.tsv, the run file).
`combo_hash`, `expand_grid` and `completed_combos` are the JAX package's,
so a grid that one package started the other resumes: a combination
whose directory holds combo.json and report.tsv is skipped (reference:
run_grid_search.py:20-62). Indexes go to `<grid root>/indexes/`, named by
their build parameters, so the combinations of one indexing combination
share one build. `--device` goes to both CLIs.

    python -m seismic_tpu_torch.harness.run_grid_search --exp grid.toml
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import os
import sys
import time

try:
    import tomllib
except ImportError:  # pragma: no cover
    import tomli as tomllib  # type: ignore

from .run_experiments import (
    build_base_index,
    evaluate_run,
    log,
    query_execution,
    write_report,
)


def combo_hash(params: dict) -> str:
    """Stable hash of one parameter combination
    (reference: run_grid_search.py:20-23)."""
    blob = json.dumps(params, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def expand_grid(section: dict) -> list[dict]:
    """Cartesian product of {param: [values...]} (scalars allowed)."""
    keys = sorted(section)
    value_lists = [
        v if isinstance(v, list) else [v] for v in (section[k] for k in keys)
    ]
    return [dict(zip(keys, combo)) for combo in itertools.product(*value_lists)]


def completed_combos(root: str) -> set[str]:
    """Scan prior runs for finished combinations (resume support)."""
    done = set()
    if not os.path.isdir(root):
        return done
    for d in os.listdir(root):
        marker = os.path.join(root, d, "combo.json")
        report = os.path.join(root, d, "report.tsv")
        if os.path.exists(marker) and os.path.exists(report):
            with open(marker) as f:
                done.add(json.load(f)["hash"])
    return done


def run_grid(toml_path: str, device=None) -> dict:
    """Runs every combination not yet complete; returns {"done": combos
    run now, "skipped": combos found complete}."""
    with open(toml_path, "rb") as f:
        config = tomllib.load(f)
    exp_root = config["folder"].get("experiment", "experiments_out")
    settings = config.get("settings", {})
    name = settings.get("exp-name", "grid")
    root = os.path.join(exp_root, f"grid_{name}")
    os.makedirs(root, exist_ok=True)

    index_grid = expand_grid(config.get("indexing_parameters", {}))
    query_grid = expand_grid(config.get("querying_parameters", {}))
    done = completed_combos(root)
    log(
        f"grid: {len(index_grid)} indexing x {len(query_grid)} query "
        f"combos; {len(done)} already complete"
    )

    counts = {"done": 0, "skipped": 0}
    for iparams in index_grid:
        for qparams in query_grid:
            combo = {"indexing": iparams, "query": qparams}
            h = combo_hash(combo)
            if h in done:
                log(f"skip completed combo {h}")
                counts["skipped"] += 1
                continue
            exp_dir = os.path.join(root, h)
            os.makedirs(exp_dir, exist_ok=True)
            sub_config = dict(config)
            sub_config["indexing_parameters"] = iparams
            t0 = time.time()
            index_file, build_secs = build_base_index(
                sub_config, os.path.join(root, "indexes"), device)
            res = query_execution(sub_config, index_file, "q", qparams,
                                  exp_dir, device)
            res.update(evaluate_run(sub_config, res["run_path"]))
            res["build_secs"] = build_secs
            write_report(os.path.join(exp_dir, "report.tsv"), [res])
            with open(os.path.join(exp_dir, "combo.json"), "w") as f:
                json.dump({"hash": h, "combo": combo}, f, indent=2)
            log(f"combo {h} done in {time.time()-t0:.1f}s: {res}")
            counts["done"] += 1
    return counts


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Resumable grid search")
    p.add_argument("--exp", required=True)
    p.add_argument("--device", default=None,
                   help="the card by default; 'cpu' runs the plain versions")
    args = p.parse_args(argv)
    run_grid(args.exp, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
