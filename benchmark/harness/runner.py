"""One run of one cell: set-up, warm-up, the measured window, the check
against the reference, the metrics. `run.py` is its command line; the
tests call `run_cell` on the CPU with the kernels' plain versions."""

from __future__ import annotations

import gc
import json
import statistics
import sys
import time

import numpy as np

from . import check, facts as facts_mod, launches, manifest, synth, trace
from . import view as view_mod
from . import window


# served batches, drawn from the seed, whose kernel counts stand for the
# window's batches (the counts' mean times the batches served)
FACT_BATCHES = 8


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def settings_of(config: dict, traffic: dict) -> dict:
    """The query settings: the configuration's, with the traffic mix's
    overrides (a nested dict is updated key by key)."""
    out = json.loads(json.dumps(config["search"]))
    for key, val in traffic.get("search", {}).items():
        if isinstance(val, dict):
            out.setdefault(key, {}).update(val)
        else:
            out[key] = val
    return out


def p95(values):
    """The 95th percentile (inclusive method) of `values`."""
    return statistics.quantiles(values, n=20, method="inclusive")[-1]


def _pool_lists(q, batch: int):
    """The pool's queries as (comps, vals) lists of arrays, wrapped (the
    first `batch - 1` queries again at the end)."""
    off, comps, vals = q
    n = len(off) - 1
    c = [comps[off[i]:off[i + 1]] for i in range(n)]
    v = [vals[off[i]:off[i + 1]] for i in range(n)]
    return window.wrapped(c, batch), window.wrapped(v, batch)


def _rows_csr(q, rows):
    """CSR (offsets, comps, vals) of the pool queries `rows`."""
    off, comps, vals = q
    lens = np.diff(off)[rows]
    idx = np.concatenate([np.arange(off[r], off[r + 1]) for r in rows])
    return (np.concatenate([[0], np.cumsum(lens)]).astype(np.int64),
            comps[idx], vals[idx])


def _span_ms(spans, batches: int) -> dict:
    """Mean ms a served batch spent in each client span of the window."""
    out = {}
    for name, c, s, e in spans:
        if c >= 0:
            out[name] = out.get(name, 0.0) + (e - s) / 1e6
    return {n: t / max(batches, 1) for n, t in out.items()}


def run_cell(cell: dict, config: dict, traffic: dict, per_layer, seed: int,
             seconds: float, traced: bool, device, t_process: float,
             bench_dir: str = manifest.BENCH_DIR, entry_hook=None) -> dict:
    """Run `cell` once; returns the result record (`correct`, `attempted`,
    `failed`, `metrics`, `device`, ...). `t_process` is the perf-counter
    second at which the process started. `entry_hook(entry)` may wrap the
    built entry (the tests break the timed path with it)."""
    import torch

    spans = window.Spans()
    setup = {}

    def step(name):
        class _Step:
            def __enter__(self):
                self.t = time.perf_counter()

            def __exit__(self, *exc):
                dt = time.perf_counter() - self.t
                setup[name] = setup.get(name, 0.0) + dt
                log(f"benchmark: {name} {dt:.2f} s")
        return _Step()

    settings = settings_of(config, traffic)
    k = int(settings["k"])
    B = int(traffic["batch"])
    n_batches = int(traffic["pool_batches"])
    n_pool = B * n_batches
    clients = int(traffic["clients"])
    with step("synth"):
        docs, queries = synth.corpus_and_queries(
            config["corpus"], config["queries"], n_pool, seed)
    entry_mod = manifest.load_entry(config["entry"], bench_dir)
    entry = entry_mod.build(config, docs, settings, device, step)
    index_bytes = (int(torch.cuda.memory_allocated(device))
                   if torch.device(device).type == "cuda" else 0)
    if entry_hook is not None:
        entry = entry_hook(entry)
    with step("prepare"):
        payload = entry.prepare(*_pool_lists(queries, B))
    with step("warm"):
        states = window.warm(entry, payload, B, n_batches, clients, seed,
                             spans)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    own = trace.own_kernels() if traced else None
    prof = trace.start() if traced else None
    before = launches.read()
    w0, w1, served = window.run(entry, payload, B, n_pool, clients, seconds,
                                float(traffic["keep_share"]), seed, spans,
                                states)
    setup_s = w0 / 1e9 - t_process
    launched = launches.since(before)
    tr = None
    if prof is not None:
        off = spans.wall_offset_ns
        tr = trace.stop(prof, w0 + off, w1 + off, own)
    peak = (int(torch.cuda.max_memory_allocated(device))
            if torch.device(device).type == "cuda" else 0)
    window_s = (w1 - w0) / 1e9
    failed_batches = [s for s in served if s.error]
    done = [s for s in served if not s.error]
    kept = [s for s in done if s.raw is not None]
    answers = []
    for s in kept:
        sc, ids = entry.answers(s.raw)
        answers.append((window.rows_of(s.start, B, n_pool), sc, ids))
        s.raw = None
    tail_list_len, tile_v = entry.list_len, entry.tile_v
    entry.close()
    del entry, states, payload
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    # ---- the reference, after the window, with the program's state freed
    from reference.exact import Exact

    t_ref = time.perf_counter()
    n_docs = len(docs[0]) - 1
    depth = k
    if traced:
        depth = max(k, int(settings.get("grouped", {}).get("rescore", 0)))
    ref = Exact(docs, int(config["corpus"]["dim"]),
                config["index"]["value_dtype"], device)
    pq, pd = check.pairs(answers) if answers else (None, None)
    ref_ids, ref_top, pair_scores = ref.search(
        queries, depth, None if pq is None else (pq, pd))
    del ref
    nums = (check.numbers(answers, ref_ids, ref_top, pair_scores, n_docs, k)
            if answers else dict.fromkeys(
                ("score_over", "score_under", "bad_rows", "recall_miss",
                 "recall"),
                float("nan"), queries=0))
    ref_s = time.perf_counter() - t_ref
    ok, rows = check.verdict(nums, cell["limits"])
    correct = bool(ok and not failed_batches and answers)

    lat_ms = [(s.t1 - s.t0) / 1e6 for s in done]
    queries_done = B * len(done)
    e2e = {
        "qps": (queries_done / window_s, "queries/s"),
        "batch_p95_ms": (p95(lat_ms) if len(lat_ms) > 1 else float("nan"),
                         "ms"),
        "recall_at_10": (nums["recall"], "ratio"),
        "setup_s": (setup_s, "s"),
    }
    record = {
        "correct": correct,
        "attempted": B * len(served),
        "failed": B * len(failed_batches),
    }
    win_spans = [x for x in spans.items if x[1] >= 0 and w0 <= x[2]]
    extra = {"batches": len(served), "kept_batches": len(kept),
             "window_s": window_s, "reference_s": ref_s,
             "setup_steps": setup, "index_device_bytes": index_bytes,
             "span_ms": _span_ms(win_spans, len(done)),
             "batch_ms_median": (statistics.median(lat_ms) if lat_ms
                                 else None),
             "launches_per_batch": {n: c / max(len(served), 1)
                                    for n, c in launched.items()},
             "recall_queries": nums["queries"],
             "numbers": nums}
    if failed_batches:
        extra["first_error"] = failed_batches[0].error[-2000:]
    device_rec = {"platform": "gpu" if torch.device(device).type == "cuda"
                  else torch.device(device).type,
                  "kind": (torch.cuda.get_device_name(device)
                           if torch.device(device).type == "cuda" else "cpu"),
                  "count": int(cell["chips"]),
                  "memory_peak_bytes": peak}
    if not traced:
        record["metrics"] = {name: {"value": v, "unit": u}
                             for name, (v, u) in e2e.items()
                             if name in cell["_e2e"]}
    else:
        device_rec.update(busy_s=tr.busy_s, window_s=tr.window_s)
        pick = np.random.default_rng([seed, 61]).permutation(len(done))
        facts = []
        for i in pick[:FACT_BATCHES]:
            qrows = window.rows_of(done[i].start, B, n_pool)
            facts.append(facts_mod.BatchFacts(
                *_rows_csr(queries, qrows), settings, tail_list_len, tile_v,
                np.diff(docs[0]), ref_ids[qrows]))
        rv = view_mod.RunView(
            entry_mod.PROGRAM, win_spans, done, window_s, tr, setup,
            extra["launches_per_batch"], facts, bench_dir)
        metrics = {}
        for m in per_layer:
            v = manifest.load_metric(m["name"], bench_dir).read(rv)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        record["metrics"] = metrics
        record["breakdown"] = {
            "device_ops": tr.top_ops(10),
            "idle_gaps": tr.idle_by_host(
                [(n, c, s + spans.wall_offset_ns, e + spans.wall_offset_ns)
                 for n, c, s, e in win_spans], 10),
        }
        extra["roofline"] = rv.notes
    record["device"] = device_rec
    record["run"] = extra
    record["e2e_seen"] = {n: v for n, (v, _) in e2e.items()}
    record["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in rows}
    return record


def power_limit() -> str:
    """The card's name and power limit as `nvidia-smi` reads them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return "power limit: " + out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"power limit: not read ({e})"
