"""Closed-loop clients and the measured window.

Each client is a thread that sends its next batch once its previous one
has come back (a closed loop: callers that each wait for a reply). The
query pool holds `pool_batches` x `batch` distinct queries; a batch is
`batch` consecutive pool queries from a start row, wrapping at the
pool's end. Every start row of the pool is a batch of its own, so the
window serves no batch twice: each client takes its share of one
permutation of the start rows drawn from the seed (the aligned starts,
0, batch, 2 batch, ..., are the warm-up's and left out). A batch's time
runs from the client's call into the entry to the top-k on the host.
Clients start together; none starts a batch once `seconds` have passed,
and the window closes when the last batch has come back, so the rate
takes all the work and all the time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import traceback

import numpy as np


class Spans:
    """Host spans (name, client, start ns, end ns) on the perf counter.
    `wall_offset_ns` maps them onto the wall clock of the profiler's
    trace. Appends from several threads are safe (a list append holds
    the interpreter lock)."""

    def __init__(self):
        self.items = []
        self.wall_offset_ns = time.time_ns() - time.perf_counter_ns()

    @contextlib.contextmanager
    def span(self, name: str, client: int = -1):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.items.append((name, client, t0, time.perf_counter_ns()))

    def bound(self, client: int):
        return lambda name: self.span(name, client)


@dataclasses.dataclass
class Served:
    client: int
    start: int  # the batch's first row in the query pool
    t0: int  # perf counter ns: the call into the entry
    t1: int  # perf counter ns: the top-k on the host
    raw: object = None  # the answer, where it is kept for the check
    error: str = ""


def wrapped(rows: list, batch: int) -> list:
    """The pool's rows followed by its first `batch - 1` rows again, so
    the batch at any start row is one slice."""
    return list(rows) + list(rows[:batch - 1])


def batch_at(payload, start: int, batch: int):
    """The batch at pool row `start` of a prepared, wrapped pool: the same
    slice of each of the payload's row sequences (a view of an array)."""
    return tuple(x[start:start + batch] for x in payload)


def rows_of(start: int, batch: int, n_pool: int) -> np.ndarray:
    """int64 [batch]: the pool rows of the batch at `start`."""
    return (start + np.arange(batch)) % n_pool


def client_starts(n_pool: int, batch: int, clients: int, seed: int):
    """Each client's start rows: its share of one permutation of the
    pool's unaligned start rows, drawn from the seed."""
    perm = np.random.default_rng([seed, 31]).permutation(n_pool)
    perm = perm[perm % batch != 0]
    return [perm[c::clients].tolist() for c in range(clients)]


def aligned_orders(n_batches: int, batch: int, clients: int, seed: int):
    """The warm-up's aligned start rows in a cyclic order drawn from the
    seed, each client starting at its own offset."""
    perm = np.random.default_rng([seed, 37]).permutation(n_batches) * batch
    return [np.roll(perm, -(c * n_batches) // clients).tolist()
            for c in range(clients)]


def run(entry, payload, batch: int, n_pool: int, clients: int,
        seconds: float, keep_share: float, seed: int, spans: Spans,
        states=None):
    """Serve batches of `payload` (the prepared, wrapped pool) from
    `clients` threads for `seconds`. Returns (t_start ns, t_end ns,
    [Served]). An answer is kept for the check where it holds a pool row
    its client has not answered yet in the window, and otherwise with
    probability `keep_share`, drawn from the seed."""
    states = states or [entry.client() for _ in range(clients)]
    starts = client_starts(n_pool, batch, clients, seed)
    served = [[] for _ in range(clients)]
    go = threading.Event()
    clock = {}

    def loop(c):
        rng = np.random.default_rng([seed, 53, c])
        answered = np.zeros(n_pool, bool)
        span = spans.bound(c)
        mine = starts[c]
        go.wait()
        stop = clock["stop"]
        j = 0
        while time.perf_counter_ns() < stop:
            start = mine[j % len(mine)]
            j += 1
            rows = rows_of(start, batch, n_pool)
            keep = rng.random() < keep_share or not answered[rows].all()
            answered[rows] = True
            work = batch_at(payload, start, batch)
            t0 = time.perf_counter_ns()
            try:
                raw = entry.search(states[c], work, span)
            except Exception:  # noqa: BLE001 - a failed batch is counted
                served[c].append(Served(c, start, t0,
                                        time.perf_counter_ns(),
                                        error=traceback.format_exc()))
                return
            t1 = time.perf_counter_ns()
            served[c].append(Served(c, start, t0, t1, raw if keep else None))

    threads = [threading.Thread(target=loop, args=(c,), daemon=True)
               for c in range(clients)]
    for t in threads:
        t.start()
    clock["start"] = time.perf_counter_ns()
    clock["stop"] = clock["start"] + int(seconds * 1e9)
    go.set()
    for t in threads:
        t.join()
    out = [s for per in served for s in per]
    t_end = max((s.t1 for s in out), default=clock["start"])
    return clock["start"], t_end, out


def warm(entry, payload, batch: int, n_batches: int, clients: int,
         seed: int, spans: Spans):
    """The pool's aligned batches once on one client, then every client
    through all of them at once: every shape and the allocator's
    concurrent working set are met before the window. Returns the
    clients' states."""
    states = [entry.client() for _ in range(clients)]
    for b in range(n_batches):
        entry.search(states[0], batch_at(payload, b * batch, batch),
                     spans.bound(-1))
    errors = []

    def loop(c, order):
        try:
            for start in order:
                entry.search(states[c], batch_at(payload, start, batch),
                             spans.bound(-1))
        except Exception:  # noqa: BLE001 - raised below
            errors.append(traceback.format_exc())

    threads = [threading.Thread(target=loop, args=(c, o), daemon=True)
               for c, o in enumerate(aligned_orders(n_batches, batch,
                                                    clients, seed))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("warm-up failed:\n" + errors[0])
    return states
