"""The plain reference against a brute-force NumPy product."""

import numpy as np
import pytest
import torch

from bench_testutil import manifest  # noqa: F401 - sets the paths
from harness import synth
from reference.exact import LOWER, Exact, rounded

CORPUS = dict(n_docs=500, dim=700, mean_nnz=40.0, std_nnz=10.0, min_nnz=5,
              max_nnz=80, alpha=0.85, n_topics=32)
QUERIES = dict(mean_nnz=10.0, std_nnz=3.0, min_nnz=3, max_nnz=20)


def _dense(csr, n, dim, dtype=np.float64):
    off, comps, vals = csr
    out = np.zeros((n, dim), dtype)
    for r in range(n):
        out[r, comps[off[r]:off[r + 1]]] = vals[off[r]:off[r + 1]]
    return out


@pytest.mark.parametrize("precision", ["f32", "f16", "bf16"])
def test_top10_and_pair_scores_match_brute_force(precision):
    docs, queries = synth.corpus_and_queries(CORPUS, QUERIES, 70, 31337)
    dvals = rounded(docs[2], precision, "cpu").numpy()
    D = _dense((docs[0], docs[1], dvals), 500, 700)
    Q = _dense(queries, 70, 700)
    S = Q @ D.T
    pq = np.array([0, 5, 69, 69])
    pd = np.array([3, 499, 0, 17])
    ids, top, pair = Exact(docs, 700, precision, "cpu", block=16).search(
        queries, 10, (pq, pd))
    want = np.sort(S, axis=1)[:, ::-1][:, :10]
    assert np.allclose(top, want, rtol=1e-5, atol=1e-6)
    # ids: the scores they name are the top-10 scores (ties either way)
    assert np.allclose(np.take_along_axis(S, ids, 1), want, rtol=1e-5,
                       atol=1e-6)
    assert np.allclose(pair, S[pq, pd], rtol=1e-5, atol=1e-6)


def test_lower_precisions_round():
    v = np.array([1.0 + 2**-12, 3.3, 0.07], np.float32)
    assert LOWER["f32"] == "bf16" and LOWER["f16"] == "fp8"
    assert not torch.equal(rounded(v, "bf16", "cpu"), torch.from_numpy(v))
    f8 = rounded(v, "fp8", "cpu")
    assert (f8 - torch.from_numpy(v)).abs().max() > 1e-3
