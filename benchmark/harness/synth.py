"""Synthetic SPLADE-like sparse collections and queries, made from a seed.

A copy of the port's generator (`seismic_tpu_torch/harness/synth.py`:
`_zipf_probs`, `_topic_model` and the vectorised `synth_dataset_fast`),
kept here so that no change to the program can move the benchmark's
inputs. The collection is shaped like SPLADE output on MS MARCO passages:
a 30,522-term vocabulary, Zipfian term popularity over a shuffled id
space, latent topics that give terms their co-occurrence, about 150
nonzeros per document and 15-60 per query, positive gamma-distributed
impacts. Documents and queries of one seed share one topic model.

Every draw comes from `np.random.default_rng` seeded with the run's seed
and a tag, so one seed gives the same collection and queries on every
machine; seeds past 32 bits are fine.
"""

from __future__ import annotations

import numpy as np

TOPIC_NNZ = 384  # terms a topic holds (the port's fixed topic width)


def zipf_probs(dim: int, alpha: float, rng: np.random.Generator):
    """Zipf popularity by rank, mapped to component ids by a shuffle."""
    ranks = np.arange(1, dim + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    p /= p.sum()
    perm = rng.permutation(dim)
    return p[np.argsort(perm)]


def topic_model(dim: int, n_topics: int, alpha: float, seed: int):
    """(term probabilities, topic terms int32 [n_topics, TOPIC_NNZ], topic
    weights f32 [n_topics, TOPIC_NNZ]): each topic draws its terms from
    the Zipf popularity without replacement."""
    rng = np.random.default_rng([seed, 7919])
    probs = zipf_probs(dim, alpha, rng)
    topic_comps = np.empty((n_topics, TOPIC_NNZ), dtype=np.int32)
    topic_w = np.empty((n_topics, TOPIC_NNZ), dtype=np.float32)
    for t in range(n_topics):
        c = rng.choice(dim, size=TOPIC_NNZ, replace=False, p=probs)
        topic_comps[t] = np.sort(c)
        topic_w[t] = (rng.gamma(2.0, 0.7, size=TOPIC_NNZ) + 0.05).astype(
            np.float32)
    return probs, topic_comps, topic_w


def synth_csr(n: int, model, mean_nnz: float, std_nnz: float, min_nnz: int,
              max_nnz: int, seed, n_topics: int, topic_frac: float = 0.6,
              topics_per_doc: int = 2):
    """(offsets int64 [n + 1], components int32, values f32) of `n` rows,
    components sorted and distinct within each row: about `topic_frac` of
    a row's terms come from `topics_per_doc` latent topics (scaled
    affinities times noise), the rest from the Zipf background."""
    rng = np.random.default_rng(seed)
    probs, topic_comps, topic_w = model
    cum = np.cumsum(probs)
    cum[-1] = 1.0
    lengths = np.clip(rng.normal(mean_nnz, std_nnz, size=n).astype(np.int64),
                      min_nnz, max_nnz)
    n_top = (lengths * topic_frac).astype(np.int64)
    per = np.maximum(1, n_top // topics_per_doc)
    # per-(row, topic) term count: equal shares, the remainder on the last
    kt = np.repeat(per, topics_per_doc).reshape(n, topics_per_doc)
    kt[:, -1] = n_top - per * (topics_per_doc - 1)
    kt = np.maximum(kt, 0)
    row_topics = rng.integers(0, n_topics, size=(n, topics_per_doc))
    # topic slots without replacement per (row, topic): the first kt of a
    # random permutation, by an argsort of uniforms
    ktmax = int(kt.max()) if n else 0
    n2 = n * topics_per_doc
    slots = np.argsort(rng.random((n2, TOPIC_NNZ), dtype=np.float32),
                       axis=1)[:, :ktmax].astype(np.int32)
    keep2 = np.arange(ktmax, dtype=np.int32)[None, :] < kt.reshape(n2)[:, None]
    t_flat = row_topics.reshape(n2)
    tc = topic_comps[t_flat[:, None], slots]
    tv = topic_w[t_flat[:, None], slots] * (
        0.6 + 0.8 * rng.random((n2, ktmax), dtype=np.float32))
    trow = np.broadcast_to(
        np.arange(n, dtype=np.int64).repeat(topics_per_doc)[:, None],
        (n2, ktmax))
    m2 = keep2.ravel()
    tc, tv, trow = tc.ravel()[m2], tv.ravel()[m2], trow.ravel()[m2]
    # Zipf background, with replacement (duplicates collapse below)
    kb = lengths - n_top
    tot_b = int(kb.sum())
    bc = np.searchsorted(cum, rng.random(tot_b), side="right").astype(
        np.int32)
    bv = (rng.gamma(2.0, 0.5, size=tot_b) + 0.03).astype(np.float32)
    brow = np.repeat(np.arange(n, dtype=np.int64), kb)
    dim = len(probs)
    key = (np.concatenate([trow, brow]) * dim
           + np.concatenate([tc, bc]).astype(np.int64))
    vals = np.concatenate([tv, bv]).astype(np.float32)
    # one entry per (row, component), the largest value, sorted by row
    # then component (what the port's generator keeps, by one sort of
    # the packed key in place of a three-key lexsort)
    order = np.argsort(key)
    key, vals = key[order], vals[order]
    starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    vals = np.maximum.reduceat(vals, starts)
    key = key[starts]
    row, comps = np.divmod(key, dim)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(row, minlength=n), out=offsets[1:])
    return offsets, comps.astype(np.int32), vals


def corpus_and_queries(corpus: dict, queries: dict, n_queries: int,
                       seed: int):
    """The collection `corpus` describes and `n_queries` queries shaped as
    `queries` describes, both from `seed`: ((offsets, comps, vals) of the
    documents, (offsets, comps, vals) of the queries)."""
    dim = int(corpus["dim"])
    n_topics = int(corpus["n_topics"])
    model = topic_model(dim, n_topics, float(corpus["alpha"]), seed)
    docs = synth_csr(int(corpus["n_docs"]), model, corpus["mean_nnz"],
                     corpus["std_nnz"], corpus["min_nnz"], corpus["max_nnz"],
                     [seed, 104729], n_topics)
    qs = synth_csr(n_queries, model, queries["mean_nnz"], queries["std_nnz"],
                   queries["min_nnz"], queries["max_nnz"], [seed, 1299709],
                   n_topics)
    return docs, qs
