"""Aggregate grid-search reports and emit fastest-config-per-recall-level
experiment TOMLs.

This package's own copy of `seismic_tpu/harness/best_configs.py` (pure
Python; the same selections and TOML text from the same grid root), the
counterpart of the reference notebooks (reference:
scripts/Notebooks/ExtractResutsGridSearch.ipynb and
DumpBestConfiguration.ipynb, described in docs/TomlInstructions.md:
263-273): scan a grid root, collect (accuracy, us_per_query, params)
triples, and for each requested recall level pick the fastest combination
meeting it.

    python -m seismic_tpu_torch.harness.best_configs --grid-root ROOT \
        --base-toml grid.toml --output-dir best/
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


def collect_grid_results(root: str) -> List[dict]:
    out = []
    for d in sorted(os.listdir(root)):
        combo_path = os.path.join(root, d, "combo.json")
        report_path = os.path.join(root, d, "report.tsv")
        if not (os.path.exists(combo_path) and os.path.exists(report_path)):
            continue
        with open(combo_path) as f:
            combo = json.load(f)["combo"]
        with open(report_path) as f:
            header = f.readline().rstrip("\n").split("\t")
            row = f.readline().rstrip("\n").split("\t")
        rec = dict(zip(header, row))
        out.append(
            {
                "hash": d,
                "indexing": combo["indexing"],
                "query": combo["query"],
                "accuracy": float(rec["accuracy"]) if rec.get("accuracy")
                else None,
                "us_per_query": float(rec["us_per_query"])
                if rec.get("us_per_query")
                else None,
                "total_bytes": int(rec["total_bytes"])
                if rec.get("total_bytes")
                else None,
            }
        )
    return out


def best_config_for_recall(
    results: List[dict],
    recall: float,
    mem_budget_bytes: Optional[int] = None,
) -> Optional[dict]:
    """Fastest combination meeting the recall level (and memory budget)
    — mirrors the best_configs/recall_XX.toml selection."""
    ok = [
        r
        for r in results
        if r["accuracy"] is not None
        and r["accuracy"] >= recall
        and r["us_per_query"] is not None
        and (
            mem_budget_bytes is None
            or (r["total_bytes"] or 0) <= mem_budget_bytes
        )
    ]
    if not ok:
        return None
    return min(ok, key=lambda r: r["us_per_query"])


def dump_best_config_toml(best: dict, base_config: dict, path: str) -> None:
    """Write a runnable experiment TOML for the winning combination."""
    lines = ["[settings]"]
    for k, v in base_config.get("settings", {}).items():
        lines.append(_toml_kv(k, v))
    lines.append("")
    lines.append("[folder]")
    for k, v in base_config.get("folder", {}).items():
        lines.append(_toml_kv(k, v))
    lines.append("")
    if base_config.get("filename"):
        lines.append("[filename]")
        for k, v in base_config["filename"].items():
            lines.append(_toml_kv(k, v))
        lines.append("")
    lines.append("[indexing_parameters]")
    for k, v in best["indexing"].items():
        lines.append(_toml_kv(k, v))
    lines.append("")
    lines.append("[query.best]")
    for k, v in best["query"].items():
        lines.append(_toml_kv(k, v))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _toml_kv(k, v) -> str:
    if isinstance(v, bool):
        return f"{k} = {'true' if v else 'false'}"
    if isinstance(v, (int, float)):
        return f"{k} = {v}"
    return f'{k} = "{v}"'


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Extract best configs per recall level from a grid root"
    )
    p.add_argument("--grid-root", required=True)
    p.add_argument("--base-toml", required=True,
                   help="grid TOML (for settings/folder sections)")
    p.add_argument("--recalls", default="0.90,0.95,0.97,0.99")
    p.add_argument("--mem-budget-bytes", type=int, default=None)
    p.add_argument("--output-dir", required=True)
    args = p.parse_args(argv)

    try:
        import tomllib
    except ImportError:  # pragma: no cover
        import tomli as tomllib  # type: ignore

    with open(args.base_toml, "rb") as f:
        base = tomllib.load(f)
    results = collect_grid_results(args.grid_root)
    os.makedirs(args.output_dir, exist_ok=True)
    for r in (float(x) for x in args.recalls.split(",")):
        best = best_config_for_recall(results, r, args.mem_budget_bytes)
        if best is None:
            print(f"recall {r}: no combination qualifies", file=sys.stderr)
            continue
        out = os.path.join(
            args.output_dir, f"recall_{int(round(r * 100))}.toml"
        )
        dump_best_config_toml(best, base, out)
        print(
            f"recall {r}: {best['us_per_query']:.1f} us/query -> {out}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
