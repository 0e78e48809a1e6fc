"""K4, the item-major int8 scorer (`seismic_tpu_torch/ops/
grouped_scorer_item.py`): every posting of every (query, list) pair the
queries select, scored against the pair's int8 projection of the query
over the list's tile vocabulary.

Least work, each input byte once: the selected lists' u8 tile rows and
their f32 row scales (each distinct list once), each pair's int8 query
row of V bytes, each pair's f32 score a posting written once; 2 V
operations a (pair, posting) on the int8 tensor cores."""

import numpy as np

KERNEL = "score_item_kernel"
ARITH = "int8"


def count(facts):
    lists = facts.selected_lists(int(facts.settings["query_cut"]))
    V = facts.tile_v
    ll = facts.list_len
    distinct = np.unique(lists)
    tile_bytes = float(ll[distinct].sum()) * (V + 4)
    pair_rows = float(ll[lists].sum())
    nbytes = tile_bytes + len(lists) * V + pair_rows * 4
    return nbytes, 2.0 * V * pair_rows
