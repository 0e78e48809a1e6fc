"""K11 / K15's row gather on the card: in turns with its rivals, and what
its flushed time is made of.

`readings(dev)` draws the device probe's operands once
(`device_probe.row_dma_gather_inputs`: a 1M x 256 f32 table, 4096 random
rows, seed 0), holds the kernel through both entry points against its
plain version bit for bit, and takes device times a call
(`device_probe.device_ms`, ROUNDS = 9 window pairs behind each flushed
reading) with L2 warm, flushed by a write and flushed by a read. Each kind
of reading is taken for every contender in turns, forward then backward:
K11 (`row_gather`), K15 (`flat_row_gather` on the flat view of the same
table), `torch.index_select` and the empty kernel. Then, for K11 and
`index_select`, the diagnostics, each in the three readings:

- span: 4096 distinct rows drawn from one 8 MB span of the table: the
  same bytes over 4 pages of 2 MB, not over most of 1 GB of them, so the
  difference from the probe's rows is address translation;
- sorted: the probe's rows sorted by index (the order of DRAM pages);
- rows: R = 1024, 4096 and 16,384 (the probe's first 1024, the probe's,
  the probe's and 12,288 more drawn with seed 1), and the line through
  them: its intercept is the chain of round trips a call waits for, its
  slope the cost of a row.

Launches through the wrappers count (`probe_kernels.launches`): a caller
that zeroes the counts does so after this. Runs on the card only.

Usage: python -m seismic_tpu_torch.harness.row_gather_probe [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

from ..device import full_f32
from ..ops import _cuda
from ..ops import probe_kernels as pk
from . import device_probe as dp

ROUNDS = 9  # window pairs behind each flushed reading here
KERNEL = "row_gather_kernel"  # K11 / K15's kernel in the ptxas report
SPAN_ROWS = 8192  # one 8 MB span of 1 KB rows
SWEEP = (1024, 4096, 16384)
READINGS = ("warm", "write", "read")


def hold(calls: dict, hbm, idx) -> dict:
    """{name: max abs error} of each gather in `calls` against the plain
    version; raises unless every one is bit-exact."""
    want = pk.row_gather_plain(hbm, idx)
    errs = {}
    for name, fn in calls.items():
        got = fn()
        torch.cuda.synchronize()
        errs[name] = float((got - want).abs().max().item())
        if not torch.equal(got, want):
            raise AssertionError(f"row gather {name} disagrees with its "
                                 f"plain version: max error {errs[name]}")
    return errs


def in_turns(calls: dict, dev, rounds: int = ROUNDS) -> dict:
    """{name: {reading: [us forward, us backward]}}: each reading taken
    for every call in `calls`, in order and then in reverse, over
    `rounds` window pairs."""
    passes = dp.flush_passes(dev)
    evicts = dict(zip(READINGS, (None, passes["cold"], passes["cold_read"])))
    rec = {name: {k: [] for k in READINGS} for name in calls}
    order = list(calls)
    for kind, evict in evicts.items():
        for name in order + order[::-1]:
            rec[name][kind].append(
                dp.device_ms(calls[name], dev, 50, evict, rounds) * 1e3)
    return rec


def bound_us(idx, width: int) -> float:
    return dp.bound(dp._row_gather_bytes(idx, width), 0)[0] * 1e3


def operands(dev):
    """(hbm [1M, 256] on the card, {case: idx on the card}): the probe's
    table and rows, and the diagnostics' row sets."""
    a = dp.row_dma_gather_inputs()
    hbm = dp._t(a["hbm"], dev)
    idx = a["idx"]
    n = a["hbm"].shape[0]
    del a
    rng = np.random.default_rng(1)
    base = (n // 2) // 2048 * 2048  # a 2 MB-aligned span in the middle
    span = base + rng.choice(SPAN_ROWS, idx.size, replace=False)
    more = rng.integers(0, n, size=SWEEP[-1] - idx.size, dtype=np.int32)
    cases = {"probe": idx, "span": span.astype(np.int32),
             "sorted": np.sort(idx),
             f"rows_{SWEEP[0]}": idx[:SWEEP[0]],
             f"rows_{SWEEP[-1]}": np.concatenate([idx, more])}
    return hbm, {k: dp._t(v, dev) for k, v in cases.items()}


def fit(rows, us) -> dict:
    """Least-squares line us = intercept + slope * rows."""
    slope, icpt = np.polyfit(np.asarray(rows, float), np.asarray(us, float),
                             1)
    return dict(intercept_us=float(icpt), slope_ns_per_row=float(slope * 1e3))


def readings(dev, rounds: int = ROUNDS) -> dict:
    """The record of the module docstring, each flushed reading behind
    `rounds` window pairs."""
    hbm, cases = operands(dev)
    idx = cases["probe"]
    W = hbm.shape[1]
    flat = hbm.view(-1)
    calls = {"K11": lambda: pk.row_gather(hbm, idx),
             "K15": lambda: pk.flat_row_gather(flat, idx, W)}
    errs = hold(calls, hbm, idx)
    calls.update(index_select=lambda: torch.index_select(hbm, 0, idx),
                 empty=lambda: pk.empty_launch(dev))
    rec = dict(rounds=rounds, max_abs_err=errs,
               bound_us=bound_us(idx, W), turns=in_turns(calls, dev, rounds))
    diag = {}
    for case, rows in cases.items():
        if case != "probe":
            hold({"K11": lambda: pk.row_gather(hbm, rows)}, hbm, rows)
        diag[case] = dict(
            R=rows.numel(), bound_us=bound_us(rows, W),
            distinct=int(torch.unique(rows).numel()),
            **in_turns({"K11": lambda: pk.row_gather(hbm, rows),
                        "index_select":
                            lambda: torch.index_select(hbm, 0, rows)},
                       dev, rounds))
    rec["diagnostics"] = diag
    sweep = [f"rows_{SWEEP[0]}", "probe", f"rows_{SWEEP[-1]}"]
    rec["line"] = {
        who: {kind: fit(SWEEP, [np.mean(diag[c][who][kind]) for c in sweep])
              for kind in READINGS}
        for who in ("K11", "index_select")}
    del hbm, cases
    torch.cuda.empty_cache()
    return rec


def lines(rec) -> list:
    """The record as printable lines, us a call."""
    def three(r):
        return ", ".join(f"{k} " + " / ".join(f"{v:.3f}" for v in r[k])
                         for k in READINGS)

    out = [f"bound {rec['bound_us']:.3f} us; {rec['rounds']} window pairs a "
           "flushed reading; forward / backward turn, us a call"]
    out += [f"{name}: {three(r)}" for name, r in rec["turns"].items()]
    for case, d in rec["diagnostics"].items():
        out += [f"{case} (R {d['R']}, {d['distinct']} distinct rows, bound "
                f"{d['bound_us']:.3f} us) {who}: {three(d[who])}"
                for who in ("K11", "index_select")]
    for who, per in rec["line"].items():
        out.append(f"{who} over R {SWEEP}: " + ", ".join(
            f"{k} {v['intercept_us']:.3f} us + {v['slope_ns_per_row']:.4f} "
            "ns a row" for k, v in per.items()))
    return out


def card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "?"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "row_gather_probe.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA card")
        return 2
    dev = torch.device("cuda")
    print(f"card: {card()}")
    _cuda.build(("device_probe",), force=True)
    report = _cuda.ptxas_report["device_probe"]
    print(f"ptxas: {_cuda.ptxas_lines(report, KERNEL)}")
    with full_f32():
        try:
            rec = readings(dev)
        except AssertionError as e:
            print(f"FAILED: {e}")
            return 1
    rec["card"] = card()
    for ln in lines(rec):
        print(ln)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
