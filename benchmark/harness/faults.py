"""Faults planted in the timed path's candidate selection, the readings
that the upper end of `recall_miss`'s limit is set from. Each fault
leaves the answers valid (ids in the collection, exact scores where the
program rescores) and names other documents than the sound path:

- `lists_half`: the planner and the program take half of each query's
  lists (`query_cut` halved), as a planner that drops lists would;
- `k4_zero`: the grouped program's candidate scorer (K4,
  `score_grouped_i8_item`) returns zeros, so its pool is arbitrary;
- `k7_zero`: the engine's tile scorer (K7, `score_tiles`) returns zeros.

    python3 benchmark/harness/faults.py --workload <cell> --seeds 1,2,3

builds the cell's entry once a seed, answers every pool query once
through the sound path and through each fault the entry's program can
have, and prints each one's compared numbers beside the cell's limits.
It exits non-zero where a fault comes out correct. The benchmark's own
runs never run it.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import sys

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from harness import check, manifest, runner, synth, window  # noqa: E402
else:
    from . import check, manifest, runner, synth, window

# the port's function that each zeroing fault replaces, by program
_ZERO = {
    "k4_zero": ("grouped", "seismic_tpu_torch.search.grouped",
                "score_grouped_i8_item"),
    "k7_zero": ("engine", "seismic_tpu_torch.search.engine", "score_tiles"),
}


def names(program: str) -> list:
    """The faults a program's entry can have."""
    return ["lists_half"] + [f for f, (p, _, _) in _ZERO.items()
                             if p == program]


@contextlib.contextmanager
def planted(fault: str, entry):
    """`entry` with `fault` planted for the block's duration."""
    if fault == "lists_half":
        kw = getattr(entry, "search_kw", None)
        if kw is not None:
            old = kw["query_cut"]
            kw["query_cut"] = max(old // 2, 1)
            try:
                yield entry
            finally:
                kw["query_cut"] = old
        else:
            old = entry.query_cut
            entry.query_cut = max(old // 2, 1)
            try:
                yield entry
            finally:
                entry.query_cut = old
        return
    _, module, attr = _ZERO[fault]
    mod = importlib.import_module(module)
    orig = getattr(mod, attr)

    def zeroed(*args, **kwargs):
        import torch

        return torch.zeros_like(orig(*args, **kwargs))

    setattr(mod, attr, zeroed)
    try:
        yield entry
    finally:
        setattr(mod, attr, orig)


def readings(cell: dict, config: dict, traffic: dict, seed: int, device,
             bench_dir: str = manifest.BENCH_DIR) -> dict:
    """{"sound" or fault: compared numbers} on seed `seed`'s pool."""
    from reference.exact import Exact

    settings = runner.settings_of(config, traffic)
    k = int(settings["k"])
    B = int(traffic["batch"])
    n_batches = int(traffic["pool_batches"])
    n_pool = B * n_batches
    docs, queries = synth.corpus_and_queries(config["corpus"],
                                             config["queries"], n_pool, seed)
    entry_mod = manifest.load_entry(config["entry"], bench_dir)
    entry = entry_mod.build(config, docs, settings, device,
                            lambda name: contextlib.nullcontext())
    payload = entry.prepare(*runner._pool_lists(queries, B))
    state = entry.client()
    span = lambda name: contextlib.nullcontext()  # noqa: E731

    def answer():
        out = []
        for b in range(n_batches):
            raw = entry.search(state, window.batch_at(payload, b * B, B),
                               span)
            out.append((window.rows_of(b * B, B, n_pool),
                        *entry.answers(raw)))
        return out

    variants = {"sound": answer()}
    for fault in names(entry_mod.PROGRAM):
        with planted(fault, entry):
            variants[fault] = answer()
    entry.close()
    del entry, state, payload
    ref = Exact(docs, int(config["corpus"]["dim"]),
                config["index"]["value_dtype"], device)
    everything = [a for answers in variants.values() for a in answers]
    ref_ids, ref_top, pair = ref.search(queries, k, check.pairs(everything))
    out, off = {}, 0
    for name, answers in variants.items():
        n = sum(ids.size for _, _, ids in answers)
        out[name] = check.numbers(answers, ref_ids, ref_top,
                                  pair[off:off + n], len(docs[0]) - 1, k)
        off += n
    return out


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
    any_fault_correct = False
    for seed in (int(s) for s in args.seeds.split(",")):
        for name, nums in readings(cell, config, traffic, seed, dev).items():
            ok, _ = check.verdict(nums, cell["limits"])
            if name != "sound":
                any_fault_correct |= ok
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "path": name, "correct": ok, "numbers": nums,
                              "limits": cell["limits"]}), flush=True)
    return 1 if any_fault_correct else 0


if __name__ == "__main__":
    sys.exit(main())
