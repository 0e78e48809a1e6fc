"""The benchmark of seismic_tpu_torch, the PyTorch / CUDA port, on NVIDIA
H100 cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of BENCHMARK.json: it makes the cell's corpus and queries
from the seed, builds and uploads the index through the cell's entry,
warms every batch it will send, serves closed-loop clients for `--seconds`
seconds, checks the answers against the plain reference and prints one
JSON line last on standard output: the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics read from a device trace of the window.
It fails, and prints no result, without enough CUDA cards, and when JAX or
the JAX package was loaded into the process.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
# fixed cache directories inside the checkout, so that only a cell's
# first run there builds or compiles anything
os.environ["TRITON_CACHE_DIR"] = os.path.join(BENCH_DIR, ".cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BENCH_DIR, ".cache",
                                                  "torch_extensions")
FORBIDDEN = ("jax", "jaxlib", "flax", "seismic_tpu")


def forbidden_modules(names=None) -> list:
    """Loaded modules (or `names`) whose top-level name is JAX's, Flax's
    or the JAX package's, compared whole (`seismic_tpu_torch` is not
    `seismic_tpu`)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, BENCH_DIR)
    sys.path.insert(0, os.path.dirname(BENCH_DIR))
    from harness import manifest, runner

    bench = manifest.benchmark()
    cell = manifest.load_cell(args.workload, bench)
    config = manifest.load_config(cell["config"])
    traffic = manifest.load_traffic(cell["traffic"])
    e2e, per_layer = manifest.cell_metrics(bench, args.workload)

    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA card; the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: {cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    cell["_e2e"] = [m["name"] for m in e2e]
    runner.log(f"benchmark: {cell['name']} seed {args.seed} seconds "
               f"{args.seconds} trace {args.trace} on "
               f"{torch.cuda.get_device_name(0)}")
    if args.trace:
        runner.log("benchmark: " + runner.power_limit())
    record = runner.run_cell(cell, config, traffic, per_layer, args.seed,
                             args.seconds, bool(args.trace),
                             torch.device("cuda", 0), T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    runner.log("benchmark: run " + json.dumps(record["run"]))
    for name, c in record["checks"].items():
        runner.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
