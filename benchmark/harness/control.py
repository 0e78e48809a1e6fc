"""The control of `correct`: the reference put in the program's place,
computed in the precision below the one the configuration states (bf16
below f32 values, fp8 e4m3 below f16), and held to the cell's limits. It
has to come out not correct. It answers every query of a run's pool once
(as many as a run compares, or more), with no window.

    python3 benchmark/harness/control.py --workload <cell> --seeds 1,2,3

prints, for each seed, the numbers a run compares beside the cell's
limits, and exits non-zero where any seed's control comes out correct.
The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from harness import check, manifest, synth  # noqa: E402
else:
    from . import check, manifest, synth


def control_numbers(config: dict, traffic: dict, seed: int, device) -> dict:
    """The numbers of the control's answers on seed `seed`'s pool."""
    from reference.exact import LOWER, Exact

    k = int(config["search"]["k"])
    n_pool = int(traffic["batch"]) * int(traffic["pool_batches"])
    docs, queries = synth.corpus_and_queries(config["corpus"],
                                             config["queries"], n_pool, seed)
    dim = int(config["corpus"]["dim"])
    stated = config["index"]["value_dtype"]
    low = Exact(docs, dim, LOWER[stated], device)
    ids, top, _ = low.search(queries, k)
    del low
    answers = [(np.arange(n_pool), top, ids)]
    exact = Exact(docs, dim, stated, device)
    ref_ids, ref_top, pair = exact.search(queries, k, check.pairs(answers))
    return check.numbers(answers, ref_ids, ref_top, pair,
                         len(docs[0]) - 1, k)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, manifest.ROOT)
    sys.path.insert(0, manifest.BENCH_DIR)
    import torch

    bench = manifest.benchmark()
    cell = manifest.load_cell(args.workload, bench)
    config = manifest.load_config(cell["config"])
    traffic = manifest.load_traffic(cell["traffic"])
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    any_correct = False
    for seed in (int(s) for s in args.seeds.split(",")):
        nums = control_numbers(config, traffic, seed, dev)
        ok, rows = check.verdict(nums, cell["limits"])
        any_correct |= ok
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": ok, "numbers": nums,
                          "limits": cell["limits"]}), flush=True)
    return 1 if any_correct else 0


if __name__ == "__main__":
    sys.exit(main())
