"""Host and device cost of the top-k idioms of the grouped program, on one
CUDA card.

    python -m seismic_tpu_torch.harness.topk_probe [--out FILE]

For each selection the grouped program makes (the API route's exact pool
and score cut, the derived plan's top-QC cut, the hier pool's two bf16
stages), it times each idiom that can give `lax.top_k`'s order or is its
nearest library call:

- `sort`: a stable descending sort, then the first k (what
  `search/engine.py::_top_k` does);
- `topk`: `torch.topk` on the values (no defined tie order);
- `key_i64`: `torch.topk` over int64 keys (f32 bits above the column);
- `key_i32`: `torch.topk` over int32 keys (bf16 bits above the column).

Per idiom: the host time until the call returns (`enqueue_ms`), the host
time of the call plus a synchronize (`wall_ms`), CUDA-event device time
(`device_ms`), medians over the repetitions; the number of synchronising
operations `torch.cuda.set_sync_debug_mode("warn")` reports in one call;
and the host operators that took the most self CPU time in a
torch.profiler window. Prints one JSON object and writes it to `--out`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
import warnings

import numpy as np
import torch


def _key_topk(x, k: int, wide: bool):
    n = x.shape[-1]
    if wide:
        bits = x.view(torch.int32).to(torch.int64)
        shift, flip = 32, 0x7FFFFFFF
    else:
        bits = x.view(torch.int16).to(torch.int32)
        shift, flip = 16, 0x7FFF
    ordered = torch.where(bits < 0, bits ^ flip, bits)
    col = torch.arange(n, dtype=bits.dtype, device=x.device)
    key = ordered * (1 << shift) + ((1 << shift) - 1 - col)
    idx = torch.topk(key, k, dim=-1).indices
    return torch.gather(x, -1, idx), idx


def _sort_topk(x, k: int):
    s = torch.sort(x, dim=-1, descending=True, stable=True)
    return s.values[..., :k], s.indices[..., :k]


IDIOMS = {
    "sort": _sort_topk,
    "topk": lambda x, k: torch.topk(x, k, dim=-1),
    "key_i64": lambda x, k: _key_topk(x, k, True),
    "key_i32": lambda x, k: _key_topk(x, k, False),
}

# (name, rows, width, k, dtype, idioms): the grouped program's selections
# at the API cell (B=4096, QC=14, LLMAX=512, pool 80, score_cut 64 of 128)
# and the headline cell (B=16384, QC=14 of 64, hier t=16 then pool 96)
CASES = (
    ("api_exact_pool", 4096, 14 * 512, 80, torch.float32,
     ("sort", "topk", "key_i64")),
    ("api_score_cut", 4096, 128, 64, torch.float32,
     ("sort", "topk", "key_i64")),
    ("derive_qc_cut", 16384, 64, 14, torch.float32,
     ("sort", "topk", "key_i64")),
    ("hier_stage1", 16384 * 14, 512, 16, torch.bfloat16,
     ("sort", "topk", "key_i32")),
    ("hier_stage2", 16384, 14 * 16, 96, torch.bfloat16,
     ("sort", "topk", "key_i32")),
)


def _wall(fn, reps: int):
    enq, wall, dev = [], [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        enq.append((t1 - t0) * 1e3)
        wall.append((t2 - t0) * 1e3)
        dev.append(a.elapsed_time(b))
    return (float(np.median(enq)), float(np.median(wall)),
            float(np.median(dev)))


def _syncs(fn) -> int:
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def _host_ops(fn, top: int = 4) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {e.key[:60]: e.self_cpu_time_total / 1e3 for e in ops[:top]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/topk_probe.json")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("topk_probe: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"card": card, "torch": torch.__version__, "cases": {}}
    for name, rows, width, k, dt, idioms in CASES:
        # a pool wall: quantised scores (many ties) with a third masked
        x = torch.randint(-64, 64, (rows, width), generator=gen,
                          device="cuda").to(torch.float32) / 8
        x = torch.where(torch.rand(rows, width, generator=gen,
                                   device="cuda") < 0.3, -torch.inf, x)
        x = x.to(dt)
        ref = IDIOMS["sort"](x, k)[1]
        case = {"shape": [rows, width], "k": k, "dtype": str(dt)}
        for idiom in idioms:
            fn = IDIOMS[idiom]
            idx = fn(x, k)[1]
            enq, wall, dev = _wall(lambda: fn(x, k), args.reps)
            case[idiom] = dict(
                enqueue_ms=enq, wall_ms=wall, device_ms=dev,
                syncs=_syncs(lambda: fn(x, k)),
                lax_order=bool(torch.equal(idx, ref)),
                host_ops_ms=_host_ops(lambda: fn(x, k)))
        out["cases"][name] = case
        del x
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
