"""Quality metrics: accuracy@k vs exact ground truth and MRR@k vs qrels.

This package's own copy of `seismic_tpu/harness/evaluate.py` (pure
Python; the same metrics on the same runs), which replaced the
reference's recall script and ir_measures usage (reference:
scripts/recall.py:17-34, scripts/run_experiments.py:242-309) with
self-contained implementations; if `ir_measures` happens to be
importable, `compute_metric` can defer to it for other metric strings.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple


def read_run_tsv(path: str) -> Dict[str, List[Tuple[str, float]]]:
    """Run file rows: query_id \t doc_id \t rank \t score."""
    run = defaultdict(list)
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 4:
                continue
            qid, doc, rank, score = parts[0], parts[1], int(parts[2]), float(
                parts[3]
            )
            run[qid].append((rank, doc, score))
    return {
        q: [(d, s) for _, d, s in sorted(rows)] for q, rows in run.items()
    }


def accuracy_at_k(
    run: Dict[str, List[Tuple[str, float]]],
    gt: Dict[str, List[Tuple[str, float]]],
    k: int = 10,
) -> float:
    """Fraction of exact top-k docs retrieved (the reference's recall /
    accuracy@10, scripts/recall.py)."""
    hits = tot = 0
    for qid, gt_rows in gt.items():
        g = {d for d, _ in gt_rows[:k]}
        r = {d for d, _ in run.get(qid, [])[:k]}
        hits += len(g & r)
        tot += len(g)
    return hits / max(tot, 1)


def read_qrels(path: str) -> Dict[str, Dict[str, int]]:
    """TREC qrels: query_id [iteration] doc_id relevance."""
    qrels: Dict[str, Dict[str, int]] = defaultdict(dict)
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 4:
                qid, _, doc, rel = parts
            elif len(parts) == 3:
                qid, doc, rel = parts
            else:
                continue
            qrels[qid][doc] = int(rel)
    return qrels


def mrr_at_k(
    run: Dict[str, List[Tuple[str, float]]],
    qrels: Dict[str, Dict[str, int]],
    k: int = 10,
    min_rel: int = 1,
) -> float:
    """Mean reciprocal rank at k over queries present in the qrels
    (RR@10 in the reference experiments, run_experiments.py:242-284)."""
    total = 0.0
    n = 0
    for qid, rels in qrels.items():
        n += 1
        for rank, (doc, _) in enumerate(run.get(qid, [])[:k], start=1):
            if rels.get(doc, 0) >= min_rel:
                total += 1.0 / rank
                break
    return total / max(n, 1)


def compute_metric(
    run: Dict[str, List[Tuple[str, float]]],
    qrels: Dict[str, Dict[str, int]],
    metric: str,
    min_rel: int = 1,
) -> float:
    """Evaluate an ir_measures-style metric string against qrels
    (reference: scripts/run_experiments.py:242-284, which calls
    `ir_measures.parse_measure(metric)` on the TOML's `metric` value).

    Natively implemented: RR@k / MRR@k, Recall@k / R@k, Precision@k /
    P@k, Success@k, nDCG@k / NDCG@k, AP@k / MAP@k, Accuracy@k (per-query
    means over the qrels' queries). Anything else defers to the real
    `ir_measures` package when importable, else raises ValueError."""
    import math

    name, _, kpart = metric.partition("@")
    name = name.strip().lower()
    k = int(kpart) if kpart.strip() else 10

    def per_query(fn):
        vals = [fn(rels, [d for d, _ in run.get(qid, [])[:k]])
                for qid, rels in qrels.items()]
        return sum(vals) / max(len(vals), 1)

    def n_rel(rels):
        return sum(1 for r in rels.values() if r >= min_rel)

    if name in ("rr", "mrr"):
        return mrr_at_k(run, qrels, k, min_rel)
    if name in ("recall", "r"):
        return per_query(
            lambda rels, docs: sum(
                1 for d in docs if rels.get(d, 0) >= min_rel
            ) / max(n_rel(rels), 1)
        )
    if name in ("precision", "p"):
        return per_query(
            lambda rels, docs: sum(
                1 for d in docs if rels.get(d, 0) >= min_rel
            ) / k
        )
    if name == "success":
        return per_query(
            lambda rels, docs: float(
                any(rels.get(d, 0) >= min_rel for d in docs)
            )
        )
    if name == "ndcg":
        def ndcg(rels, docs):
            dcg = sum(
                (2 ** rels.get(d, 0) - 1) / math.log2(i + 2)
                for i, d in enumerate(docs)
            )
            ideal = sorted(rels.values(), reverse=True)[:k]
            idcg = sum(
                (2 ** r - 1) / math.log2(i + 2)
                for i, r in enumerate(ideal)
            )
            return dcg / idcg if idcg > 0 else 0.0

        return per_query(ndcg)
    if name in ("ap", "map"):
        def ap(rels, docs):
            hits = 0
            total = 0.0
            for i, d in enumerate(docs, start=1):
                if rels.get(d, 0) >= min_rel:
                    hits += 1
                    total += hits / i
            return total / max(min(n_rel(rels), k), 1)

        return per_query(ap)
    if name == "accuracy":
        # exact-top-k containment (micro-averaged), the reference's
        # accuracy@k where qrels hold the exact search results
        gt = {q: sorted(r.items(), key=lambda t: -t[1]) for q, r in
              qrels.items()}
        return accuracy_at_k(run, gt, k)
    try:
        import ir_measures
    except ImportError:
        raise ValueError(
            f"unsupported metric {metric!r} and ir_measures is not "
            f"installed"
        ) from None
    measure = ir_measures.parse_measure(metric)
    flat_qrels = [
        ir_measures.Qrel(qid, doc, rel)
        for qid, rels in qrels.items()
        for doc, rel in rels.items()
    ]
    flat_run = [
        ir_measures.ScoredDoc(qid, doc, score)
        for qid, rows in run.items()
        for doc, score in rows
    ]
    return ir_measures.calc_aggregate([measure], flat_qrels, flat_run)[
        measure
    ]


def results_to_run(results) -> Dict[str, List[Tuple[str, float]]]:
    """Convert batch_search output [[(qid, score, doc), ...], ...]."""
    run: Dict[str, List[Tuple[str, float]]] = {}
    for rows in results:
        if not rows:
            continue
        qid = rows[0][0]
        run[qid] = [(doc, score) for _, score, doc in rows]
    return run
