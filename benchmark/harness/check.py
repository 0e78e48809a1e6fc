"""The comparison that decides `correct`.

The answers are what the timed path returned: for each kept batch, the
scores and ids of its top-k on the host. The reference (`reference/
exact.py`) gives each query's exact top-k and the exact score of every
(query, doc) an answer names. The numbers, each compared where its
cell's file gives it a limit:

- `score_over`: the widest amount by which a returned score lies above
  the exact score of the returned document, as a share of that query's
  best exact score. A wrong id, another query's answer or a stale one
  claims a score its document does not have; a lower precision than the
  configuration states rounds scores up as well as down.
- `score_under`: the same, below the exact score. The grouped program
  rescores exactly, so its scores lie on both sides within rounding; the
  engine returns tile scores that leave out the mass outside a list's
  tile vocabulary, so it reads far below by design and is not compared.
- `bad_rows`: answers with an id outside the collection, an id twice, a
  score that is not finite or not in descending order, or fewer than k
  results. Exact: its limit is 0.
- `recall_miss`: 1 - `recall`, the mean share of each query's exact
  top-k that its answer leaves out, over the distinct queries of the
  kept answers (each query's first answer). The scores above judge the
  documents an answer names; this judges which documents it names: a
  fault in candidate selection (the planner's lists, the projection, the
  scorers, the pool) returns valid documents with exact scores, but
  not the best ones. `recall` is also the end-to-end metric
  `recall_at_10`.
"""

from __future__ import annotations

import numpy as np


def bad_rows(scores, ids, n_docs: int, k: int) -> np.ndarray:
    """bool [B]: the rows that are no valid top-k."""
    valid = (ids >= 0) & (ids < n_docs)
    srt = np.sort(np.where(valid, ids, -1 - np.arange(k)), axis=1)
    dup = (srt[:, 1:] == srt[:, :-1]).any(axis=1)
    finite = np.where(valid, np.isfinite(scores), True).all(axis=1)
    desc = (np.diff(np.where(valid, scores, -np.inf), axis=1) <= 0).all(
        axis=1)
    return ~valid.all(axis=1) | dup | ~finite | ~desc


def numbers(answers, ref_ids, ref_top, pair_scores, n_docs: int,
            k: int) -> dict:
    """The compared numbers of `answers` [(batch's query indices [B],
    scores [B, k], ids [B, k])], given the reference's top ids and scores
    of every pool query and `pair_scores`, the exact score of each
    answer's (query, id) in the order `pairs(answers)` lists them; also
    `recall` and `queries`, the distinct queries it is the mean over."""
    over = under = 0.0
    bad = 0
    first = {}
    off = 0
    for qidx, scores, ids in answers:
        n = ids.size
        ex = pair_scores[off:off + n].reshape(ids.shape)
        off += n
        rows_bad = bad_rows(scores, ids, n_docs, k)
        bad += int(rows_bad.sum())
        ok = (ids >= 0) & (ids < n_docs) & ~rows_bad[:, None]
        best = np.maximum(ref_top[qidx, 0], np.finfo(np.float32).tiny)
        d = (scores.astype(np.float64) - ex) / best[:, None]
        if ok.any():
            over = max(over, float(np.max(np.where(ok, d, 0.0))))
            under = max(under, float(np.max(np.where(ok, -d, 0.0))))
        for r, q in enumerate(qidx):
            first.setdefault(int(q), ids[r])
    hits = [len(set(ref_ids[q, :k].tolist()) & set(a.tolist()))
            for q, a in first.items()]
    recall = float(np.sum(hits)) / (k * max(len(hits), 1))
    return {"score_over": over, "score_under": under, "bad_rows": float(bad),
            "recall_miss": 1.0 - recall if hits else float("nan"),
            "recall": recall, "queries": len(hits)}


def pairs(answers):
    """(query index, doc id) of every answer's result, flattened."""
    q = np.concatenate([np.repeat(qi, ids.shape[1])
                        for qi, _, ids in answers])
    d = np.concatenate([ids.reshape(-1) for _, _, ids in answers])
    return q, d


def verdict(values: dict, limits: dict):
    """(correct, [(name, value, limit)]): every limited number at or under
    its limit."""
    rows = [(name, values[name], float(limit))
            for name, limit in sorted(limits.items())]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
