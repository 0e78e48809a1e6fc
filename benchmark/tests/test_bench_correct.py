"""`correct` comes out true on a sound run, and false with the timed path
broken underneath (every fault a retrieval cell can have on one card, and
a candidate scorer zeroed inside the program) and for the control, the
reference in a lower precision put in the program's place."""

import contextlib

import numpy as np
import pytest

from bench_testutil import CELLS, TINY_CORPUS, run_tiny, tiny
from harness import check, control, faults


class Broken:
    """An entry whose `search` is broken in one way."""

    def __init__(self, entry, fault):
        self._entry, self._fault, self._last = entry, fault, None

    def __getattr__(self, name):
        return getattr(self._entry, name)

    def search(self, state, batch, span):
        if self._fault == "half":
            # half of the batch left out: the first half searched, its
            # answers standing in for the rest
            h = len(batch[0]) // 2
            raw = self._entry.search(state, tuple(x[:h] for x in batch),
                                     span)
            if isinstance(raw, tuple):
                return tuple(np.concatenate([x, x]) for x in raw)
            return raw + raw
        raw = self._entry.search(state, batch, span)
        if self._fault == "unchanged":
            # the answer of the previous call: state left as it was
            out, self._last = (self._last if self._last is not None
                               else raw), raw
            return out
        if self._fault == "altered":
            # one answer altered where it is produced
            if isinstance(raw, tuple):
                scores, ids = (np.array(x) for x in raw)
                ids[0, 0] = (ids[0, 0] + 1) % TINY_CORPUS["n_docs"]
                return scores, ids
            s, d = raw[0][0]
            raw[0][0] = (s, (d + 1) % TINY_CORPUS["n_docs"])
            return raw
        raise ValueError(self._fault)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    rec = run_tiny(cell)
    assert rec["correct"], rec["checks"]
    assert rec["failed"] == 0 and rec["attempted"] > 0
    assert list(rec)[-1] == "checks"


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_path_is_not_correct(cell, fault):
    rec = run_tiny(cell, entry_hook=lambda e: Broken(e, fault))
    assert not rec["correct"], (fault, rec["checks"])


@pytest.mark.parametrize("cell,fault", [("headline-b16384", "k4_zero"),
                                        ("api-engine-b4096", "k7_zero")])
def test_zeroed_candidate_scorer_is_not_correct(cell, fault):
    # valid ids with exact scores, but not the best documents: only
    # `recall_miss` sees it
    with contextlib.ExitStack() as stack:
        rec = run_tiny(cell, entry_hook=lambda e: stack.enter_context(
            faults.planted(fault, e)))
    assert not rec["correct"], rec["checks"]
    assert rec["checks"]["bad_rows"]["value"] == 0
    assert (rec["checks"]["recall_miss"]["value"]
            > rec["checks"]["recall_miss"]["limit"])


def test_fault_names():
    assert faults.names("grouped") == ["lists_half", "k4_zero"]
    assert faults.names("engine") == ["lists_half", "k7_zero"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    c, config, traffic, _ = tiny(cell)
    nums = control.control_numbers(config, traffic, 4242, "cpu")
    ok, rows = check.verdict(nums, c["limits"])
    assert not ok, rows


def test_bad_rows():
    ids = np.array([[3, 2, 1], [3, 3, 1], [3, -1, 1], [3, 2, 9]])
    scores = np.array([[3.0, 2, 1], [3, 2, 1], [3, 2, 1], [1, 2, 3]],
                      np.float32)
    assert check.bad_rows(scores, ids, 5, 3).tolist() == [False, True, True,
                                                          True]


def test_recall_miss():
    ref_ids = np.array([[0, 1], [2, 3]])
    ref_top = np.ones((2, 2), np.float32)
    answers = [(np.array([0, 1]), np.ones((2, 2), np.float32),
                np.array([[1, 0], [2, 4]]))]
    nums = check.numbers(answers, ref_ids, ref_top, np.ones(4), 5, 2)
    assert nums["recall"] == 0.75 and nums["recall_miss"] == 0.25


def test_verdict():
    ok, rows = check.verdict({"a": 0.5, "b": 0.0}, {"a": 1, "b": 0})
    assert ok and rows == [("a", 0.5, 1.0), ("b", 0.0, 0.0)]
    assert not check.verdict({"a": float("nan")}, {"a": 1})[0]
