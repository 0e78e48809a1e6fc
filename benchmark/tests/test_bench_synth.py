"""The generator: the same seed gives the same corpus and queries, another
seed others, seeds past 32 bits work, and it draws what the port's own
generator draws."""

import numpy as np

from bench_testutil import manifest  # noqa: F401 - sets the paths
from harness import synth

CORPUS = dict(n_docs=400, dim=1024, mean_nnz=60.0, std_nnz=15.0, min_nnz=8,
              max_nnz=128, alpha=0.85, n_topics=64)
QUERIES = dict(mean_nnz=12.0, std_nnz=4.0, min_nnz=3, max_nnz=24)


def _same(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def test_deterministic_per_seed():
    seed = 2**33 + 12345
    d1, q1 = synth.corpus_and_queries(CORPUS, QUERIES, 50, seed)
    d2, q2 = synth.corpus_and_queries(CORPUS, QUERIES, 50, seed)
    assert _same(d1, d2) and _same(q1, q2)
    d3, q3 = synth.corpus_and_queries(CORPUS, QUERIES, 50, seed + 1)
    assert not _same(d1, d3) and not _same(q1, q3)


def test_rows_sorted_distinct_and_in_range():
    (off, comps, vals), (qoff, qc, qv) = synth.corpus_and_queries(
        CORPUS, QUERIES, 50, 7)
    assert off[0] == 0 and off[-1] == len(comps) and len(off) == 401
    for o, c, v, hi in ((off, comps, vals, 128), (qoff, qc, qv, 24)):
        lens = np.diff(o)
        assert lens.min() >= 1 and lens.max() <= hi
        for r in range(len(o) - 1):
            row = c[o[r]:o[r + 1]]
            assert (np.diff(row) > 0).all()
        assert (c >= 0).all() and (c < CORPUS["dim"]).all()
        assert (v > 0).all() and v.dtype == np.float32


def test_equals_the_ports_generator():
    from seismic_tpu_torch.harness.synth import synth_dataset_fast

    ds = synth_dataset_fast(600, dim=2048, seed=77, topic_seed=9,
                            n_topics=128)
    model = synth.topic_model(2048, 128, 0.85, 9)
    off, comps, vals = synth.synth_csr(600, model, 150.0, 30.0, 16, 256,
                                       [77, 104729], 128)
    assert np.array_equal(ds.offsets, off)
    assert np.array_equal(ds.components, comps)
    assert np.array_equal(ds.values, vals)
