"""What the benchmark's CPU tests share: the paths, a cell cut to a size a
test run holds, and a stand-in for the card's profiler."""

from __future__ import annotations

import os
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import manifest, runner, trace  # noqa: E402

CELLS = ("headline-b16384", "api-engine-b4096")
TINY_CORPUS = dict(n_docs=1500, dim=2048, n_topics=128)


def tiny(cell_name: str, bench_dir: str = BENCH):
    """(cell, config, traffic, per-layer metrics) of `cell_name` with its
    corpus, tile vocabulary and batches cut to a CPU test's size."""
    bench = manifest.benchmark(os.path.dirname(bench_dir))
    cell = manifest.load_cell(cell_name, bench, bench_dir)
    config = manifest.load_config(cell["config"], bench_dir)
    traffic = manifest.load_traffic(cell["traffic"], bench_dir)
    config["corpus"].update(TINY_CORPUS)
    config["index"]["layout"].update(summary_vocab_cap=256)
    if "narrow_v" in config["index"]:
        config["index"]["narrow_v"] = 128
    traffic.update(batch=32, pool_batches=3)
    e2e, per_layer = manifest.cell_metrics(bench, cell_name)
    cell["_e2e"] = [m["name"] for m in e2e]
    return cell, config, traffic, per_layer


def run_tiny(cell_name: str, seed: int = 20260, traced: bool = False,
             bench_dir: str = BENCH, entry_hook=None, seconds: float = 0.6,
             device: str = "cpu"):
    cell, config, traffic, per_layer = tiny(cell_name, bench_dir)
    return runner.run_cell(cell, config, traffic, per_layer, seed, seconds,
                           traced, device, time.perf_counter(), bench_dir,
                           entry_hook=entry_hook)


def fake_profiler(monkeypatch):
    """Stand in for the card's profiler: the trace of a window is one
    kernel of each of K3, K4 and K7 and a PyTorch sort, each 10 us."""
    def stop(prof, w0, w1, own):
        names = ("void score_item_kernel<16, 2>(int)",
                 "void rescore_fused_kernel<false>(int)",
                 "void score_tiles_kernel<4>(int)",
                 "void at::native::sort<1>(float)")
        ops = [(n, w0 + 20000 * i, w0 + 20000 * i + 10000)
               for i, n in enumerate(names)]
        return trace.Trace(ops, w0, w1, own)

    monkeypatch.setattr(trace, "start", lambda: object())
    monkeypatch.setattr(trace, "stop", stop)
