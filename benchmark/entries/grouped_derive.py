"""Entry `grouped_derive`: the port's headline program, as its probe
drivers (`seismic_tpu_torch/harness/probe_r5b.py`) and `bench.py`'s
protocol call it.

Set-up builds the index on the host (`build_index`, the configuration's
value type), narrows its tile vocabulary (`narrow_vocab`) and uploads it
with the configuration's `tile_csub`. Each client holds a
`PlannerContext` of its own. A batch, on the client's thread: `plan_caps`
(the C++ planner on the host), the padded queries' copy to the card,
`search_grouped_derive` (the plan derived on the card, projection K1, the
item-major scorer K4, the pool, rescore K3, dedup, top-k) and the top-k's
copy back to the host.
"""

from __future__ import annotations

import numpy as np

PROGRAM = "grouped"


def _csr(docs, dim):
    from seismic_tpu_torch.data.sparse import CsrDataset

    offsets, comps, vals = docs
    return CsrDataset(offsets, comps, vals, dim)


def build_config(index: dict):
    from seismic_tpu_torch.config import (
        Configuration,
        GlobalThresholdPruning,
        TpuLayout,
    )

    return Configuration(
        pruning=GlobalThresholdPruning(**index["pruning"]),
        layout=TpuLayout(**index["layout"]),
    )


class Entry:
    def __init__(self, config: dict, docs, settings: dict, device, span):
        from seismic_tpu_torch.build.builder import build_index
        from seismic_tpu_torch.ops.tiles_prep import narrow_vocab
        from seismic_tpu_torch.search.grouped import GroupedParams

        index = config["index"]
        self.device = device
        self.k = int(settings["k"])
        self.query_cut = int(settings["query_cut"])
        self.M = int(settings["M"])
        self.pad = int(config["queries"]["pad"])
        self.csub = int(index["tile_csub"])
        self.params = GroupedParams(k=self.k, **settings["grouped"])
        with span("build"):
            arrays = build_index(_csr(docs, config["corpus"]["dim"]),
                                 build_config(index),
                                 value_dtype=index["value_dtype"])
        if index.get("narrow_v"):
            with span("narrow"):
                arrays = narrow_vocab(arrays, int(index["narrow_v"]))
        with span("upload"):
            self.index = arrays.to_device(device, tile_csub=self.csub)
            sync(device)
        self.arrays = arrays
        # what the kernel counts read: each list's length, the tile width
        self.list_len = np.asarray(arrays.list_len, np.int64)
        self.tile_v = int(arrays.doc_tiles.shape[1])

    def prepare(self, comps, vals):
        """The client's batch as the headline program takes it: padded
        int32 / f32 [B, pad] arrays on the host."""
        from seismic_tpu_torch.data.sparse import pad_queries

        return pad_queries(comps, vals, self.pad)

    def client(self):
        from seismic_tpu_torch.search.planner import PlannerContext

        return PlannerContext.from_arrays(self.arrays, csub=self.csub)

    def search(self, ctx, batch, span):
        import torch

        from seismic_tpu_torch.search.grouped import (
            plan_caps,
            search_grouped_derive,
        )

        q_comps, q_vals = batch
        with span("plan_caps"):
            g_cap, w_cap = plan_caps(q_comps, q_vals, ctx, self.query_cut,
                                     M=self.M)
        with span("enqueue"):
            qc = torch.from_numpy(q_comps).to(self.device)
            qv = torch.from_numpy(q_vals).to(self.device)
            scores, ids = search_grouped_derive(
                self.index, qc, qv, self.params, self.query_cut, self.M,
                g_cap, w_cap, ctx.zero_region)
        with span("wait"):
            return scores.cpu().numpy(), ids.cpu().numpy()

    @staticmethod
    def answers(raw):
        scores, ids = raw
        return (np.asarray(scores, np.float32),
                np.where(ids >= 0, ids, -1).astype(np.int64))

    def close(self):
        self.index = None
        self.arrays = None


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build(config, docs, settings, device, span):
    return Entry(config, docs, settings, device, span)

