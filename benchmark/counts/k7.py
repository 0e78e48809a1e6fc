"""K7, the engine's tile scorer (`seismic_tpu_torch/ops/
tiles_scorer.py`): every posting of every (query, list) pair the queries
select, its u8 tile row times the pair's f32 query row over the list's
tile vocabulary.

Least work, each input byte once: the selected lists' u8 tile rows and
f32 row scales (each distinct list once), each pair's f32 query row of V
values, each pair's f32 score a posting; 2 V operations a (pair,
posting), f32 on the CUDA cores."""

import numpy as np

KERNEL = "score_tiles_kernel"
ARITH = "f32"


def count(facts):
    lists = facts.selected_lists(int(facts.settings["query_cut"]))
    V = facts.tile_v
    ll = facts.list_len
    distinct = np.unique(lists)
    pair_rows = float(ll[lists].sum())
    nbytes = (float(ll[distinct].sum()) * (V + 4) + len(lists) * V * 4
              + pair_rows * 4)
    return nbytes, 2.0 * V * pair_rows
