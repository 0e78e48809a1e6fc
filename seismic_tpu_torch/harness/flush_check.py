"""What the pass before a call does to the device probe's flushed times.

`device_probe` times a kernel with the L2 emptied before each call by a
pass over a 256 MB tensor: an overwrite (`zero_`, which leaves dirty
lines) or a read (`torch.sum`, clean lines). This script times K10, K11,
K13, K14 and K17 and their library calls, at the JAX probes' sizes, after
each of these passes (`device_probe.device_ms`, the median of
COLD_ROUNDS window pairs, the passes' own time subtracted):

- warm: no pass;
- write: `zero_` of 256 MB; write+empty: the same, then an empty kernel;
- read: `torch.sum` of 256 MB into a scalar; read+empty: the same, then
  an empty kernel; read+write1MB: the same, then `zero_` of 1 MB;
- read1GB: `torch.sum` of 1 GB.

Each reading is printed as it is taken; the whole table, `--repeat`
times over, is written as JSON to `--out`. `--rounds` sets the window
pairs of each flushed reading (device_probe's COLD_ROUNDS by default).
Needs an NVIDIA card.

Usage: python -m seismic_tpu_torch.harness.flush_check [--repeat N]
           [--rounds N] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..device import full_f32
from ..ops import probe_kernels as pk
from . import device_probe as dp


def cases(dev):
    """{kernel: (its wrapper's call, its library call)} on the probes'
    inputs, every operand on the card and every cast done here."""
    t = dp._t
    a = dp.vmem_table_take_inputs()
    table, idx = t(a["table"], dev), t(a["idx"], dev)
    idx_l = idx.long()
    a = dp.row_dma_gather_inputs()
    hbm, rows = t(a["hbm"], dev), t(a["idx"], dev)
    a = dp.u8_tile_matmul_inputs()
    tile, q, scale = (t(a[k], dev) for k in ("tile", "q", "scale"))
    tile_f = tile.to(torch.float32)
    a = dp.take_along_axis_sublane_inputs()
    ttab, tidx = t(a["table"], dev), t(a["idx"], dev)
    tidx_l = tidx.long()
    a = dp.int8_cast_matmul_inputs()
    i8, q8 = t(a["tile"], dev), t(a["q"], dev)
    i8_f = i8.to(torch.float32)
    return {
        "table_take": (lambda: pk.table_take(table, idx),
                       lambda: table[idx_l]),
        "row_gather": (lambda: pk.row_gather(hbm, rows),
                       lambda: torch.index_select(hbm, 0, rows)),
        "u8_matvec": (lambda: pk.u8_matvec(tile, q, scale),
                      lambda: torch.matmul(tile_f, q)),
        "take_along_axis": (lambda: pk.take_along_axis(ttab, tidx),
                            lambda: torch.gather(ttab, 0, tidx_l)),
        "i8_matmul": (lambda: pk.i8_matmul(i8, q8),
                      lambda: torch.matmul(i8_f, q8)),
    }


def passes(dev):
    """{name: the pass run before each call, None for warm}."""
    std = dp.flush_passes(dev)
    big = dp.flush_passes(dev, 1 << 30)["cold_read"]
    small = torch.empty(1 << 18, dtype=torch.float32, device=dev)

    def then(first, second):
        def both():
            first()
            second()
        return both

    def empty():
        pk.empty_launch(dev)

    return {"warm": None, "write": std["cold"],
            "write+empty": then(std["cold"], empty),
            "read": std["cold_read"],
            "read+empty": then(std["cold_read"], empty),
            "read+write1MB": then(std["cold_read"], small.zero_),
            "read1GB": big}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=dp.COLD_ROUNDS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dp.COLD_ROUNDS = args.rounds
    if not torch.cuda.is_available():
        print("needs an NVIDIA card")
        return 2
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(dev)}; {args.rounds} window "
          "pairs a flushed reading")
    table = []
    with full_f32():
        calls, evicts = cases(dev), passes(dev)
        floor_us = dp.device_ms(lambda: pk.empty_launch(dev), dev) * 1e3
        print(f"empty kernel: {floor_us:.2f} us on the card")
        for rep in range(args.repeat):
            for name, (kernel, library) in calls.items():
                for pname, evict in evicts.items():
                    row = dict(rep=rep, kernel=name, pass_=pname,
                               kernel_us=dp.device_ms(kernel, dev, 50,
                                                      evict) * 1e3,
                               library_us=dp.device_ms(library, dev, 50,
                                                       evict) * 1e3)
                    table.append(row)
                    print(f"{rep} {name:16s} {pname:14s} kernel "
                          f"{row['kernel_us']:6.2f} us, library "
                          f"{row['library_us']:6.2f} us")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(empty_us=floor_us, rounds=args.rounds,
                           readings=table), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
