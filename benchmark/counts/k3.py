"""K3, the fused rescore (`seismic_tpu_torch/ops/rescore.py`, the
`rescore_fused_kernel`): each query's `rescore` candidates scored exactly
from their forward rows (component id and f32 value a nonzero) against
the query's top `score_cut` terms.

Least work, each input byte once: the forward rows of the distinct
documents among the queries' exact top-`rescore` (8 bytes a nonzero;
the documents an ideal pool hands the kernel, taken from the reference,
not from the program's pool), each query's terms (8 bytes a term), each
candidate's int32 id and f32 score; a multiply-add a candidate's
nonzero on the CUDA cores."""

import numpy as np

KERNEL = "rescore_fused_kernel"
ARITH = "f32"


def count(facts):
    r = int(facts.settings["grouped"]["rescore"])
    cand = facts.ref_ids[:, :r]
    nnz = facts.doc_nnz
    rows = np.unique(cand[cand >= 0])
    terms = np.minimum(np.diff(facts.q_offsets),
                       int(facts.settings["grouped"].get("score_cut", 64)))
    nbytes = (float(nnz[rows].sum()) * 8 + float(terms.sum()) * 8
              + cand.size * 8)
    ops = 2.0 * float(nnz[cand[cand >= 0]].sum())
    return nbytes, ops
