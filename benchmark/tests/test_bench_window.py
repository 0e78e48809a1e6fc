"""The window's traffic: every batch is `batch` consecutive pool queries
from a start row of its own, so no batch is served twice and a cache
keyed by a batch's content never hits."""

import time

import numpy as np

import bench_testutil  # noqa: F401 - puts the benchmark on the path
from harness import window


def test_wrapped_batches_are_slices():
    pool = list(range(10))
    ext = window.wrapped(pool, 4)
    assert ext == pool + [0, 1, 2]
    for start in range(10):
        (got,) = window.batch_at((ext,), start, 4)
        assert got == window.rows_of(start, 4, 10).tolist()
    arr = np.arange(len(ext) * 3).reshape(len(ext), 3)
    (view,) = window.batch_at((arr,), 8, 4)
    assert np.shares_memory(view, arr) and view.flags.c_contiguous


def test_client_starts_are_distinct_and_unaligned():
    starts = window.client_starts(96, 32, 3, 2**31 + 7)
    flat = [s for per in starts for s in per]
    assert len(flat) == len(set(flat)) == 96 - 3
    assert all(s % 32 for s in flat)
    assert starts == window.client_starts(96, 32, 3, 2**31 + 7)
    assert starts != window.client_starts(96, 32, 3, 2**31 + 8)


class CachingEntry:
    """An entry that keeps every batch's answer by the batch's content
    and counts the hits."""

    def __init__(self):
        self.seen, self.hits = set(), 0

    def client(self):
        return None

    def search(self, _state, batch, span):
        time.sleep(0.001)
        key = tuple(batch[0])
        self.hits += key in self.seen
        self.seen.add(key)
        return key


def test_a_batch_cache_never_hits_in_the_window():
    n_pool, batch = 64, 8
    payload = (window.wrapped(list(range(n_pool)), batch),)
    entry = CachingEntry()
    spans = window.Spans()
    window.warm(entry, payload, batch, n_pool // batch, 2, 5, spans)
    entry.hits = 0
    _, _, served = window.run(entry, payload, batch, n_pool, 2, 0.01, 0.0,
                              5, spans)
    assert 0 < len(served) <= n_pool - n_pool // batch
    assert entry.hits == 0
    assert len({s.start for s in served}) == len(served)
    assert all(s.raw is None or s.raw == tuple(
        window.rows_of(s.start, batch, n_pool)) for s in served)
