"""The window pool on the bf16 scorer reads recall@10 0.9035 on the card,
5-8 points under the other modes of chip_smoke's phase 6: is that the
port's or the reference mode's? Both packages run phase 6's window-bf16
configuration on one index of the modes cell's layout, at a cut size, and
their recall@10 against exact search must agree.

The index: `harness/synth.py`'s SPLADE-like collection cut to 4,000
documents over an 800-id vocabulary (the aligned tile layout gives every
list a subtile, and the JAX program's time in interpret mode grows with
the lists, so the card's 30,522 ids would not fit a CPU test), built
by the JAX package with phase 4's configuration (GlobalThresholdPruning
(200, 2.0), max_block_len 32, summary_vocab_cap 1024, max_doc_nnz 256,
tile_overflow 64) and f32 values, carried across with `from_jax_arrays`,
narrowed to V=512 by each package's own `narrow_vocab` and uploaded with
csub 2. 256 synthetic queries padded to 64 terms, `query_cut=14`, M=8 and
`GroupedParams(k=10, score_cut=64, pool=96, rescore=64,
pool_mode="window")`, bf16 by default, as `chip_smoke.py`'s phase 6 runs
it; JAX's Pallas kernels in interpret mode. The bar: the port's recall@10
within 0.005 of JAX's, and top-10 id sets equal on >= 98% of queries."""

import dataclasses

import numpy as np
import pytest
import torch

from seismic_tpu_torch import from_jax_arrays
from seismic_tpu_torch.data.sparse import pad_queries
from seismic_tpu_torch.harness.synth import synth_dataset, synth_queries
from seismic_tpu_torch.ops.tiles_prep import narrow_vocab
from seismic_tpu_torch.search import grouped as tgrouped
from seismic_tpu_torch.search.planner import PlannerContext

K, QC, M, V0, CSUB = 10, 14, 8, 512, 2
N_DOCS, DIM, N_QUERIES = 4000, 800, 256
WINDOW = dict(k=K, score_cut=64, pool=96, rescore=64, pool_mode="window")


def _exact_top_k(ds, q_comps, q_vals):
    """Brute-force top-K doc ids of each padded query row."""
    import scipy.sparse as sp

    docs = sp.csr_matrix((ds.values, ds.components, ds.offsets),
                         shape=(len(ds), DIM))
    real = q_comps < DIM
    rows = np.repeat(np.arange(len(q_comps)), real.sum(1))
    q = sp.csr_matrix((q_vals[real], (rows, q_comps[real])),
                      shape=(len(q_comps), DIM))
    scores = (q @ docs.T).toarray()
    return np.argsort(-scores, axis=1, kind="stable")[:, :K]


def _recall(ids, truth):
    return float(np.mean([len(set(a[a >= 0].tolist()) & set(b.tolist()))
                          for a, b in zip(ids, truth)]) / K)


def test_window_bf16_recall_matches_jax():
    pytest.importorskip("jax")
    from seismic_tpu import (
        Configuration,
        GlobalThresholdPruning,
        TpuLayout,
    )
    from seismic_tpu.build.builder import build_index
    from seismic_tpu.ops.pallas_tiles import narrow_vocab as j_narrow
    from seismic_tpu.search.grouped import GroupedParams as JParams
    from seismic_tpu.search.grouped import search_grouped as j_search
    from seismic_tpu.search.planner import PlannerContext as JCtx

    ds = synth_dataset(N_DOCS, dim=DIM, seed=7)
    cfg = Configuration(
        pruning=GlobalThresholdPruning(n_postings=200, max_fraction=2.0),
        layout=TpuLayout(max_block_len=32, summary_vocab_cap=1024,
                         max_doc_nnz=256, tile_overflow=64))
    full = build_index(ds, cfg, value_dtype="f32")
    ja = j_narrow(full, V0)
    ta = narrow_vocab(from_jax_arrays(
        {f.name: getattr(full, f.name) for f in dataclasses.fields(full)}),
        V0)
    qc, qv = synth_queries(N_QUERIES, dim=DIM, seed=11)
    q_comps, q_vals = pad_queries(qc, qv, 64)

    s_j, i_j = j_search(ja.to_device(pallas_tiles=True, tile_csub=CSUB),
                        JCtx.from_arrays(ja, csub=CSUB), q_comps, q_vals,
                        JParams(**WINDOW), query_cut=QC, M=M)
    s_t, i_t = tgrouped.search_grouped(
        ta.to_device(torch.device("cpu"), tile_csub=CSUB),
        PlannerContext.from_arrays(ta, csub=CSUB), q_comps, q_vals,
        tgrouped.GroupedParams(**WINDOW), query_cut=QC, M=M)
    i_j = np.where(np.isfinite(np.asarray(s_j)), np.asarray(i_j), -1)
    i_t = np.where(np.isfinite(s_t), i_t, -1)

    truth = _exact_top_k(ds, q_comps, q_vals)
    r_jax, r_port = _recall(i_j, truth), _recall(i_t, truth)
    same = np.mean([set(a.tolist()) == set(b.tolist())
                    for a, b in zip(i_t, i_j)])
    # beside it, for the record: the port's exact pool on the same index
    s_x, i_x = tgrouped.search_grouped(
        ta.to_device(torch.device("cpu"), tile_csub=CSUB),
        PlannerContext.from_arrays(ta, csub=CSUB), q_comps, q_vals,
        tgrouped.GroupedParams(**dict(WINDOW, pool_mode="exact")),
        query_cut=QC, M=M)
    r_exact = _recall(np.where(np.isfinite(s_x), i_x, -1), truth)
    print(f"window bf16 recall@10: port {r_port:.4f}, JAX {r_jax:.4f}, "
          f"id sets equal on {same:.4f}; exact pool {r_exact:.4f}")
    assert abs(r_port - r_jax) <= 0.005, (r_port, r_jax)
    assert same >= 0.98, same
    assert r_jax > 0.5  # a real search, not an empty one
