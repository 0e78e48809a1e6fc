"""Nothing the benchmark runs loads JAX or the JAX package, and nothing it
holds reads the JAX package's records. Top-level module names are
compared whole: `seismic_tpu_torch` is the port, `seismic_tpu` the JAX
package."""

import ast
import glob
import json
import os
import re
import subprocess
import sys

from bench_testutil import BENCH, ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "seismic_tpu")
IMPORT = re.compile(r"^\s*(?:import|from)\s+([A-Za-z_]\w*)", re.M)
RECORDS = re.compile(r"bench\.py|\.bench_cache|chiprun_out|BENCH_\w*\.json|"
                     r"MULTICHIP_\w*\.json|\w+_BENCH\.json")


def _sources(pattern):
    return [p for p in glob.glob(os.path.join(BENCH, "**", pattern),
                                 recursive=True)
            if os.sep + "tests" + os.sep not in p]


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources("*.py"):
        with open(path) as f:
            tops = set(IMPORT.findall(f.read()))
        assert not tops & set(FORBIDDEN), (path, tops & set(FORBIDDEN))


def _code_strings(path):
    """The string constants of a Python file that are not docstrings."""
    with open(path) as f:
        tree = ast.parse(f.read())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
            and n.body and isinstance(n.body[0], ast.Expr)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def _data_strings(obj, skip=("source", "why", "deployment", "note",
                             "why_reduced")):
    if isinstance(obj, dict):
        return [s for k, v in obj.items() if k not in skip
                for s in _data_strings(v)]
    if isinstance(obj, list):
        return [s for v in obj for s in _data_strings(v)]
    return [obj] if isinstance(obj, str) else []


def test_no_file_reads_the_jax_packages_records():
    for path in _sources("*.py"):
        for s in _code_strings(path):
            assert not RECORDS.search(s), (path, s)
    for path in _sources("*.json"):
        with open(path) as f:
            for s in _data_strings(json.load(f)):
                assert not RECORDS.search(s), (path, s)


def test_a_run_loads_no_jax():
    """Every benchmark module imported and both cells driven on the CPU
    in a fresh interpreter; then no forbidden top-level module."""
    script = f"""
import glob, importlib.util, os, sys
sys.path[:0] = [{ROOT!r}, {BENCH!r}, {os.path.join(BENCH, 'tests')!r}]
import run
from harness import manifest
for kind in ("entries", "metrics", "counts"):
    for p in glob.glob(os.path.join({BENCH!r}, kind, "*.py")):
        manifest._module(kind, os.path.basename(p)[:-3], {BENCH!r})
for p in glob.glob(os.path.join({BENCH!r}, "harness", "*.py")):
    importlib.import_module("harness." + os.path.basename(p)[:-3])
import reference.exact
from bench_testutil import CELLS, run_tiny
for cell in CELLS:
    rec = run_tiny(cell)
    assert rec["correct"], (cell, rec["checks"])
print("FOUND", run.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout, out.stdout[-2000:]


def test_forbidden_names_compare_whole():
    import run

    assert run.forbidden_modules(["seismic_tpu_torch.api", "numpy",
                                  "jaxtyping", "harness.trace"]) == []
    assert run.forbidden_modules(["seismic_tpu.api", "jax._src.core",
                                  "flax"]) == ["flax", "jax", "seismic_tpu"]
