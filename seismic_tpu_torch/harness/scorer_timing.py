"""Device time of the int8 grouped scorers (K2 slot-major, K4 item-major),
and of the term lookups (K1, K3) and the engine's tile scorer (K7), at the
shapes of the port's cells, on synthetic operands made from a seed.

    python -m seismic_tpu_torch.harness.scorer_timing [--reps 50] [--out PATH]

Shapes (work items, distinct super-tiles, groups as chip_smoke read them
on the 100K-doc cells, NVIDIA H100 80GB HBM3): the API cell's K2 (M 8,
csub 1, V 1024), the headline cell's K4 at B=4096 / M=8 and B=16384 /
M=16 (csub 2, V 512), and both scorers at V 384 and 128 (csub 2, M 8);
K1 at the API cell (4096 queries of 128 padded terms, 64 real, 14 lists
each, V 1024 over 30,522 lists) and the headline's B=16384 (64 terms, V
512), K3's fused form on [4096, 48] candidates of 100,000 rows of 256
slots (150 real) against 64 terms, and past its static table against
320 and 1024 terms (each beside its bound: the distinct rows' real
entries in 32-byte sectors, the candidate ids, the terms and the output
over 3.35 TB/s), K7 on 57,344 pairs over 17,717 lists (V 1024, 512 rows,
5% of each projection nonzero).
Each kernel is timed as the mean of `--reps` back-to-back launches
between two CUDA events, after a warm-up; the L2 cache holds no tile
rows the next launch reads beyond what the previous left (tile pools of
several GB). The wrappers take the same arguments in every checkout whose
K2 / K4 run on the tensor cores, so the script times any such checkout's
kernels when run from its root (an earlier one unpacked with `git
archive`, for timings in turns); the JSON record names the card. It is
the yardstick of K4's one fixed-width instance (M 16 at V 512, beside
the run-time-V instance), and of a change to K1's, K3's or K7's code
paths that must leave the cells' times as they were. Card only.
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


def k3_bound_ms(fused, doc, qc) -> float:
    """K3's byte bound on an H100 (3.35 TB/s; its lookups' f32 operations
    take less): each distinct candidate row's real entries (4-byte id,
    4-byte value, each run in 32-byte sectors), the candidate ids, the
    query terms and the output, each moved once."""
    import torch

    W = fused.shape[1] // 2
    real = (fused[torch.unique(doc.long()), :W] != 2 ** 31 - 1).sum(-1)
    rows = 2 * int(((real * 4 + 31) // 32 * 32).sum().item())
    return (rows + doc.numel() * 8 + qc.numel() * 8) / 3.35e12 * 1e3


def term_calls(dev):
    """({tag: a call of K1, K3 or K7 on operands made on `dev` from a
    seed} at the cells' shapes (the module docstring), {tag: K3's bound
    ms})."""
    import torch

    from ..ops import qloc, rescore, tiles_scorer

    g = torch.Generator(device=dev).manual_seed(0)
    pad = 2 ** 31 - 1

    def ints(hi, shape, dtype=torch.int32):
        return torch.randint(0, hi, shape, generator=g, device=dev).to(dtype)

    def terms(B, SCP, real):
        qc, qv = ints(30522, (B, SCP)), torch.rand((B, SCP), generator=g,
                                                   device=dev)
        qc[:, real:], qv[:, real:] = pad, 0.0
        return qc, qv

    QC, n_lists = 14, 30522
    vocab = ints(n_lists, (n_lists, 1024), torch.int16)
    qc, qv = terms(4096, 128, 64)
    pl = ints(n_lists, (4096 * QC,))
    vocab5 = vocab[:, :512].contiguous()
    qcB, qvB = terms(16384, 64, 64)
    plB = ints(n_lists, (16384 * QC,))
    n_docs, W = 100_000, 256
    ids = torch.sort(ints(n_lists, (n_docs, W)), dim=1).values
    vals = torch.rand((n_docs, W), generator=g, device=dev)
    ids[:, 150:], vals[:, 150:] = pad, 0.0
    fused = torch.cat([ids, vals.view(torch.int32)], 1).contiguous()
    doc = ints(n_docs, (4096, 48))
    q64c, q64v = qc[:, :64].contiguous(), qv[:, :64].contiguous()
    many = {n: terms(4096, n, n) for n in (320, 1024)}
    P, LL, nl = 57_344, 512, 17_717
    lens = ints(LL, (nl,)) + 1
    n_sub = (lens + 127) // 128
    region = (torch.cumsum(n_sub, 0) - n_sub).to(torch.int32)
    rows = int(n_sub.sum()) * 128 + LL
    tiles = torch.randint(0, 256, (rows, 1024), dtype=torch.uint8,
                          generator=g, device=dev)
    tscale = torch.rand(rows, generator=g, device=dev)
    lst = ints(nl, (P,), torch.int64)
    ql = (torch.rand((P, 1024), generator=g, device=dev)
          * (torch.rand((P, 1024), generator=g, device=dev) < 0.05))
    a7 = (tiles, tscale, region[lst].contiguous(), ql.contiguous(),
          lens[lst].contiguous(), LL)
    calls = {
        "api_k1": lambda: qloc.project_qloc_quantize(vocab, pl, qc, qv, QC),
        "headline_k1_b16384": lambda: qloc.project_qloc_quantize(
            vocab5, plB, qcB, qvB, QC),
        "api_k3": lambda: rescore.score_docs_rowmajor(fused, doc, q64c,
                                                      q64v, n_docs),
        "engine_k7": lambda: tiles_scorer.score_tiles(*a7),
    }
    bounds = {"api_k3": k3_bound_ms(fused, doc, q64c)}
    for n, (c, v) in many.items():
        calls[f"k3_t{n}"] = (lambda c=c, v=v: rescore.score_docs_rowmajor(
            fused, doc, c, v, n_docs))
        bounds[f"k3_t{n}"] = k3_bound_ms(fused, doc, c)
    return calls, bounds


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
    calls, out["bound_ms"] = term_calls(dev)
    for tag, fn in calls.items():
        try:
            out["ms"][tag] = time_ms(fn, args.reps)
        except ValueError as e:  # a row this checkout's kernel refuses
            out["ms"][tag] = f"refused: {e}"
        print(f"{tag}: {out['ms'][tag]}", file=sys.stderr, flush=True)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
