"""Entry `api_batch_search`: the port's user API as a library user calls
it, `SeismicIndexRaw.build_from_csr` and then `batch_search` with lists
of query components and values, results as lists of (score, doc id).

With `heap_factor > 0` and no budget a request takes the engine route
(`search/engine.py::_search_impl` in tiles mode): dense block ranking, the
tile scorer K7, the heap-factor block mask, the pool and dedup. All
clients share one index; each calls `batch_search` from its own thread.
"""

from __future__ import annotations

import numpy as np

PROGRAM = "engine"


class Entry:
    def __init__(self, config: dict, docs, settings: dict, device, span):
        from seismic_tpu_torch import SeismicIndexRaw
        from seismic_tpu_torch.config import (
            Configuration,
            GlobalThresholdPruning,
            TpuLayout,
        )
        from seismic_tpu_torch.data.sparse import CsrDataset

        index = config["index"]
        if index["value_dtype"] != SeismicIndexRaw._value_dtype:
            raise ValueError(
                f"SeismicIndexRaw stores {SeismicIndexRaw._value_dtype} "
                f"values, the configuration states {index['value_dtype']}")
        self.device = device
        self.k = int(settings["k"])
        self.search_kw = dict(k=self.k, query_cut=int(settings["query_cut"]),
                              heap_factor=float(settings["heap_factor"]))
        for opt in ("n_knn", "block_budget"):
            if settings.get(opt) is not None:
                self.search_kw[opt] = settings[opt]
        offsets, comps, vals = docs
        cfg = Configuration(
            pruning=GlobalThresholdPruning(**index["pruning"]),
            layout=TpuLayout(**index["layout"]))
        with span("build"):
            self.index = SeismicIndexRaw.build_from_csr(
                CsrDataset(offsets, comps, vals, config["corpus"]["dim"]),
                cfg, device=device)
        with span("upload"):
            self.index.device_index()
            sync(device)
        arrays = self.index.arrays
        self.list_len = np.asarray(arrays.list_len, np.int64)
        self.tile_v = int(arrays.doc_tiles.shape[1])

    def prepare(self, comps, vals):
        """The batch as a user hands it over: one int array of component
        ids and one f32 array of values a query."""
        return ([np.asarray(c, np.int64) for c in comps],
                [np.asarray(v, np.float32) for v in vals])

    def client(self):
        return None

    def search(self, _state, batch, span):
        comps, vals = batch
        with span("batch_search"):
            return self.index.batch_search(comps, vals, **self.search_kw)

    def answers(self, raw):
        """[(score, id)] rows -> (scores f32 [B, k], ids int64 [B, k]),
        -inf / -1 where a row holds fewer than k results."""
        B = len(raw)
        scores = np.full((B, self.k), -np.inf, np.float32)
        ids = np.full((B, self.k), -1, np.int64)
        for b, row in enumerate(raw):
            n = min(len(row), self.k)
            if n:
                scores[b, :n] = [s for s, _ in row[:n]]
                ids[b, :n] = [d for _, d in row[:n]]
        return scores, ids

    def close(self):
        self.index = None


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build(config, docs, settings, device, span):
    return Entry(config, docs, settings, device, span)
