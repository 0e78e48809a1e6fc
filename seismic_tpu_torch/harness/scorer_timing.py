"""Device time of the int8 grouped scorers (K2 slot-major, K4 item-major)
at the shapes of the port's cells, on synthetic operands made from a seed.

    python -m seismic_tpu_torch.harness.scorer_timing [--reps 50] [--out PATH]

Shapes (work items, distinct super-tiles, groups as chip_smoke read them
on the 100K-doc cells, NVIDIA H100 80GB HBM3): the API cell's K2 (M 8,
csub 1, V 1024), the headline cell's K4 at B=4096 / M=8 and B=16384 /
M=16 (csub 2, V 512), and both scorers at V 384 and 128 (csub 2, M 8).
Each kernel is timed as the mean of `--reps` back-to-back launches
between two CUDA events, after a warm-up; the L2 cache holds no tile
rows the next launch reads beyond what the previous left (tile pools of
several GB). The wrappers take the same arguments in every checkout whose
K2 / K4 run on the tensor cores, so the script times any such checkout's
kernels when run from its root (an earlier one unpacked with `git
archive`, for timings in turns); the JSON record names the card. It is
the yardstick of K4's one fixed-width instance (M 16 at V 512, beside
the run-time-V instance). Card only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np

# (tag, scorer, M, csub, V, work items, distinct super-tiles, groups)
SHAPES = (
    ("api_k2", "k2", 8, 1, 1024, 40_000, 30_000, 20_000),
    ("headline_k4_b4096", "k4", 8, 2, 512, 26_594, 21_443, 20_292),
    ("headline_k4_b16384", "k4", 16, 2, 512, 45_179, 32_004, 34_751),
    ("modes_k2_csub2", "k2", 8, 2, 512, 26_594, 21_443, 20_292),
    ("k4_v384", "k4", 8, 2, 384, 26_594, 21_443, 20_292),
    ("k2_v384", "k2", 8, 2, 384, 26_594, 21_443, 20_292),
    ("k4_v128", "k4", 8, 2, 128, 26_594, 21_443, 20_292),
    ("k2_v128", "k2", 8, 2, 128, 26_594, 21_443, 20_292),
)


def operands(M, csub, V, W, regions, G, seed, dev):
    """Tiles of `regions` super-tiles of csub * 128 rows, their scales,
    int8 queries for G groups, and W work items over the regions, each
    group's items consecutive with slots 0, 1, ..."""
    import torch

    rng = np.random.default_rng(seed)
    rows = csub * 128
    g = torch.Generator(device=dev).manual_seed(seed)
    tiles = torch.randint(0, 256, (regions * rows, V), dtype=torch.uint8,
                          generator=g, device=dev)
    scale = torch.rand(regions * rows, generator=g, device=dev) + 1e-3
    q = torch.randint(-127, 128, (G, M, V), dtype=torch.int8, generator=g,
                      device=dev)
    wr = rng.permutation(np.resize(np.arange(regions), W)).astype(np.int32)
    wg = np.sort(rng.integers(0, G, W)).astype(np.int32)
    ws = (np.arange(W) - np.searchsorted(wg, wg)).astype(np.int32)
    ll_max = rows * (int(ws.max()) + 1)
    t = [torch.from_numpy(a).to(dev) for a in (wr, wg, ws)]
    return tiles, scale, q, t[0], t[1], t[2], ll_max


def time_ms(fn, reps: int) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from ..device import resolve_device
    from ..ops import grouped_scorer, grouped_scorer_item

    dev = resolve_device(None)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    out = {"card": card, "device": torch.cuda.get_device_name(dev),
           "reps": args.reps, "ms": {}}
    for i, (tag, which, M, csub, V, W, regions, G) in enumerate(SHAPES):
        tiles, scale, q, wr, wg, ws, ll_max = operands(
            M, csub, V, W, regions, G, seed=i, dev=dev)
        if which == "k2":
            def fn():
                return grouped_scorer.score_grouped_i8(
                    tiles, scale, q, wr, wg, ws, ll_max, csub)
        else:
            def fn():
                return grouped_scorer_item.score_grouped_i8_item(
                    tiles, scale, q, wr, wg, csub)
        try:
            out["ms"][tag] = time_ms(fn, args.reps)
        except ValueError as e:  # a width this checkout's scorer refuses
            out["ms"][tag] = f"refused: {e}"
        print(f"{tag}: {out['ms'][tag]}", file=sys.stderr, flush=True)
        del tiles, scale, q, wr, wg, ws
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
