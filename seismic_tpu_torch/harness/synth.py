"""Synthetic SPLADE-like sparse collections for benchmarks and tests.

The environment has no network access, so MS MARCO itself is unavailable;
benchmarks run on synthetic collections shaped like SPLADE-v3 output on
MS MARCO passages (SURVEY.md §6): vocab ~30522, Zipfian component
popularity, ~120-190 nonzeros per document, ~15-60 per query, positive
gamma-distributed impact scores. Deterministic given the seed.
"""

from __future__ import annotations

import functools

import numpy as np

from ..data.sparse import CsrDataset

MSMARCO_VOCAB = 30522


def _zipf_probs(dim: int, alpha: float, rng: np.random.Generator):
    """Zipf-ish component popularity with a shuffled rank->id map so popular
    components are spread over the id space (like a real wordpiece vocab)."""
    ranks = np.arange(1, dim + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    p /= p.sum()
    perm = rng.permutation(dim)
    return p[np.argsort(perm)]  # probability per component id


@functools.lru_cache(maxsize=2)
def _topic_model(dim: int, n_topics: int, topic_nnz: int, alpha: float,
                 seed: int):
    """Latent topics: each topic is a set of components with affinities.
    Gives the synthetic data the co-occurrence structure of real text
    (SPLADE expansions cluster by topic), unlike i.i.d. Zipf sampling.
    A collection and its queries share one model, so the last two are
    kept (read-only: the callers index them and write nothing back)."""
    rng = np.random.default_rng([seed, 7919])
    probs = _zipf_probs(dim, alpha, rng)
    topic_comps = np.empty((n_topics, topic_nnz), dtype=np.int32)
    topic_w = np.empty((n_topics, topic_nnz), dtype=np.float32)
    for t in range(n_topics):
        c = rng.choice(dim, size=topic_nnz, replace=False, p=probs)
        topic_comps[t] = np.sort(c)
        topic_w[t] = (rng.gamma(2.0, 0.7, size=topic_nnz) + 0.05).astype(
            np.float32
        )
    return probs, topic_comps, topic_w


def synth_dataset(
    n_docs: int,
    dim: int = MSMARCO_VOCAB,
    mean_nnz: float = 150.0,
    std_nnz: float = 30.0,
    min_nnz: int = 16,
    max_nnz: int = 256,
    alpha: float = 0.85,
    seed: int = 0,
    n_topics: int = 4096,
    topic_frac: float = 0.6,
    topics_per_doc: int = 2,
    topic_seed: int = 0,
) -> CsrDataset:
    """Topic-mixture SPLADE-like collection: each doc draws ~topic_frac of
    its mass from `topics_per_doc` latent topics (scaled affinities + noise)
    and the rest from the global Zipf background."""
    rng = np.random.default_rng(seed)
    # fixed so documents and queries share one topic model regardless of
    # their length parameters
    topic_nnz = 384
    probs, topic_comps, topic_w = _topic_model(
        dim, n_topics, topic_nnz, alpha, topic_seed
    )
    lengths = np.clip(
        rng.normal(mean_nnz, std_nnz, size=n_docs).astype(np.int64),
        min_nnz,
        max_nnz,
    )
    doc_topics = rng.integers(0, n_topics, size=(n_docs, topics_per_doc))
    n_top = (lengths * topic_frac).astype(np.int64)
    # `rng.choice(dim, size=kb, p=probs)` is this inverse-CDF lookup of
    # kb uniforms; the CDF is made once instead of once a document (an
    # O(dim) pass each, the cost that grows with the vocabulary)
    cdf = probs.cumsum()
    cdf /= cdf[-1]

    comp_chunks, val_chunks, row_chunks = [], [], []
    # topic part: vectorized per doc via random slots of the topic
    for start in range(0, n_docs, 8192):
        end = min(start + 8192, n_docs)
        for d in range(start, end):
            kt_total = int(n_top[d])
            per = max(1, kt_total // topics_per_doc)
            for ti in range(topics_per_doc):
                t = doc_topics[d, ti]
                kt = per if ti < topics_per_doc - 1 else (
                    kt_total - per * (topics_per_doc - 1)
                )
                if kt <= 0:
                    continue
                slots = rng.choice(topic_nnz, size=kt, replace=False)
                comp_chunks.append(topic_comps[t, slots])
                val_chunks.append(
                    topic_w[t, slots]
                    * (0.6 + 0.8 * rng.random(kt).astype(np.float32))
                )
            kb = int(lengths[d] - kt_total)
            comp_chunks.append(cdf.searchsorted(
                rng.random(kb), side="right").astype(np.int32))
            val_chunks.append(
                (rng.gamma(2.0, 0.5, size=kb) + 0.03).astype(np.float32)
            )
            row_chunks.append(np.full(kt_total + kb, d, dtype=np.int64))
    comps = np.concatenate(comp_chunks)
    vals = np.concatenate(val_chunks)
    row = np.concatenate(row_chunks)
    # sort within rows, dedupe (keep max value)
    order = np.lexsort((-vals, comps, row))
    comps, vals, row = comps[order], vals[order], row[order]
    keep = np.ones(len(comps), dtype=bool)
    keep[1:] = (comps[1:] != comps[:-1]) | (row[1:] != row[:-1])
    comps, vals, row = comps[keep], vals[keep], row[keep]
    order = np.lexsort((comps, row))
    comps, vals, row = comps[order], vals[order], row[order]
    new_lengths = np.bincount(row, minlength=n_docs)
    offsets = np.zeros(n_docs + 1, dtype=np.int64)
    np.cumsum(new_lengths, out=offsets[1:])
    return CsrDataset(offsets, comps, vals, dim)


def synth_dataset_fast(
    n_docs: int,
    dim: int = MSMARCO_VOCAB,
    mean_nnz: float = 150.0,
    std_nnz: float = 30.0,
    min_nnz: int = 16,
    max_nnz: int = 256,
    alpha: float = 0.85,
    seed: int = 0,
    n_topics: int = 4096,
    topic_frac: float = 0.6,
    topics_per_doc: int = 2,
    topic_seed: int = 0,
    chunk: int = 262144,
    progress: bool = False,
) -> CsrDataset:
    """Vectorized topic-mixture generator for multi-million-doc rungs.

    Same distribution family as `synth_dataset` (shared `_topic_model`,
    Zipf background, gamma impacts) but fully vectorized per chunk:
    ~40x faster than the per-doc loop (the 8.8M-doc scale rung would
    otherwise take >4 h on this 1-core host). Draws differ from
    `synth_dataset` at equal seed — use one generator per cached
    collection. Deterministic given (seed, topic_seed, chunk)."""
    rng = np.random.default_rng([seed, 104729])
    topic_nnz = 384
    probs, topic_comps, topic_w = _topic_model(
        dim, n_topics, topic_nnz, alpha, topic_seed
    )
    cum = np.cumsum(probs)
    cum[-1] = 1.0
    comp_out, val_out, len_out = [], [], []
    for start in range(0, n_docs, chunk):
        n = min(chunk, n_docs - start)
        lengths = np.clip(
            rng.normal(mean_nnz, std_nnz, size=n).astype(np.int64),
            min_nnz, max_nnz,
        )
        n_top = (lengths * topic_frac).astype(np.int64)
        per = np.maximum(1, n_top // topics_per_doc)
        # per-(doc, topic) term count: equal shares, remainder on the last
        kt = np.repeat(per, topics_per_doc).reshape(n, topics_per_doc)
        kt[:, -1] = n_top - per * (topics_per_doc - 1)
        kt = np.maximum(kt, 0)
        doc_topics = rng.integers(0, n_topics, size=(n, topics_per_doc))
        # topic slots WITHOUT replacement per (doc, topic): first-kt of a
        # random permutation via argsort of uniforms
        ktmax = int(kt.max()) if n else 0
        N2 = n * topics_per_doc
        slots = np.argsort(
            rng.random((N2, topic_nnz), dtype=np.float32), axis=1
        )[:, :ktmax].astype(np.int32)
        keep2 = (
            np.arange(ktmax, dtype=np.int32)[None, :]
            < kt.reshape(N2)[:, None]
        )
        t_flat = doc_topics.reshape(N2)
        tc = topic_comps[t_flat[:, None], slots]
        tv = topic_w[t_flat[:, None], slots] * (
            0.6 + 0.8 * rng.random((N2, ktmax), dtype=np.float32)
        )
        trow = np.broadcast_to(
            (np.arange(n, dtype=np.int64) + start).repeat(topics_per_doc)[
                :, None
            ],
            (N2, ktmax),
        )
        m2 = keep2.ravel()
        tc, tv, trow = tc.ravel()[m2], tv.ravel()[m2], trow.ravel()[m2]
        # Zipf background: i.i.d. WITH replacement (duplicates collapse in
        # the dedupe below, as cross-part duplicates always did)
        kb = lengths - n_top
        tot_b = int(kb.sum())
        bc = np.searchsorted(
            cum, rng.random(tot_b), side="right"
        ).astype(np.int32)
        bv = (rng.gamma(2.0, 0.5, size=tot_b) + 0.03).astype(np.float32)
        brow = np.repeat(np.arange(n, dtype=np.int64) + start, kb)
        comps = np.concatenate([tc, bc])
        vals = np.concatenate([tv, bv])
        row = np.concatenate([trow, brow])
        order = np.lexsort((-vals, comps, row))
        comps, vals, row = comps[order], vals[order], row[order]
        keep = np.ones(len(comps), dtype=bool)
        keep[1:] = (comps[1:] != comps[:-1]) | (row[1:] != row[:-1])
        comps, vals, row = comps[keep], vals[keep], row[keep]
        order = np.lexsort((comps, row))
        comp_out.append(comps[order])
        val_out.append(vals[order])
        len_out.append(np.bincount(row - start, minlength=n))
        if progress:
            print(f"synth_fast: {start + n:,}/{n_docs:,} docs",
                  flush=True)
    comps = np.concatenate(comp_out)
    vals = np.concatenate(val_out)
    new_lengths = np.concatenate(len_out)
    offsets = np.zeros(n_docs + 1, dtype=np.int64)
    np.cumsum(new_lengths, out=offsets[1:])
    return CsrDataset(offsets, comps, vals, dim)


def synth_queries(
    n_queries: int,
    dim: int = MSMARCO_VOCAB,
    mean_nnz: float = 40.0,
    std_nnz: float = 12.0,
    min_nnz: int = 5,
    max_nnz: int = 64,
    alpha: float = 0.85,
    seed: int = 1,
):
    ds = synth_dataset(
        n_queries,
        dim=dim,
        mean_nnz=mean_nnz,
        std_nnz=std_nnz,
        min_nnz=min_nnz,
        max_nnz=max_nnz,
        alpha=alpha,
        seed=seed,
    )
    comps = [ds.get(i)[0] for i in range(n_queries)]
    vals = [ds.get(i)[1] for i in range(n_queries)]
    return comps, vals
