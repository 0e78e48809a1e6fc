"""The kernels' least bytes and operations on shapes worked by hand."""

import numpy as np

from bench_testutil import manifest
from harness import peaks
from harness.facts import BatchFacts

PAD = 2**31 - 1


def _facts(ref_ids=None):
    # two queries; list lengths by term id: 0 -> 0, 1 -> 10, 2 -> 20,
    # 3 -> 30; query 0 = terms {1: 0.9, 2: 0.5, 3: 0.1}, query 1 = {2: 0.7,
    # 0: 0.6}
    return BatchFacts(
        q_offsets=np.array([0, 3, 5]),
        q_comps=np.array([1, 2, 3, 0, 2], np.int32),
        q_vals=np.array([0.9, 0.5, 0.1, 0.6, 0.7], np.float32),
        settings={"query_cut": 2, "grouped": {"rescore": 2, "score_cut": 64}},
        list_len=np.array([0, 10, 20, 30]),
        tile_v=128,
        doc_nnz=np.array([5, 6, 7, 8]),
        ref_ids=ref_ids)


def test_selected_lists():
    # query 0 keeps its top 2 terms (1, 2); query 1 its top 2 (2, 0), and
    # list 0 is empty
    assert _facts().selected_lists(2).tolist() == [1, 2, 2]


def test_k4():
    nbytes, ops = manifest.load_count("k4").count(_facts())
    # lists 1, 2 once: 30 rows of 128 u8 + a 4-byte scale; 3 pairs of a
    # 128-byte query row; 10 + 20 + 20 = 50 scores of 4 bytes
    assert nbytes == 30 * 132 + 3 * 128 + 50 * 4
    assert ops == 2 * 128 * 50


def test_k7():
    nbytes, ops = manifest.load_count("k7").count(_facts())
    assert nbytes == 30 * 132 + 3 * 128 * 4 + 50 * 4
    assert ops == 2 * 128 * 50


def test_k3():
    ref = np.array([[0, 2, 1], [2, 3, 0]])
    nbytes, ops = manifest.load_count("k3").count(_facts(ref))
    # top-2 candidates: {0, 2} and {2, 3}: distinct docs 0, 2, 3 read once
    # (5 + 7 + 8 nonzeros of 8 bytes); 3 + 2 query terms of 8 bytes; 4
    # candidates' id and score
    assert nbytes == (5 + 7 + 8) * 8 + 5 * 8 + 4 * 8
    assert ops == 2 * (5 + 7 + 7 + 8)


def test_least_seconds_picks_the_bound():
    t, by = peaks.least_seconds(3.35e12, 1.0, "int8")
    assert by == "bytes" and abs(t - 1.0) < 1e-12
    t, by = peaks.least_seconds(1.0, 2 * 67e12, "f32")
    assert by == "ops" and abs(t - 2.0) < 1e-12
