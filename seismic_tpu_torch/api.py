"""User-facing API: `SeismicIndexRaw` on the grouped and engine routes.

The counterpart of `seismic_tpu.api.SeismicIndexRaw` (integer component
ids, no metadata), routed as `seismic_tpu/api.py:356-419` routes on the
accelerator. A tiles-mode request that asks for exhaustive lists
(`heap_factor <= 0` or `full_lists`) and sets no block/candidate budget
takes the grouped (list-major) route with the fixed `GroupedParams` of
the JAX API (`seismic_tpu/api.py:391-396`). Every other request
(`heap_factor > 0`, a block budget, another doc or block mode) takes the
engine path (`search/engine.py::search_batch`); kNN refinement runs there
when the index carries a graph.

Entry points take `device=None`, which means the card ("cuda"); when CUDA
is absent they raise unless the caller asked for the CPU (`device="cpu"`,
as the tests do), where the kernels' plain PyTorch versions run.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import Configuration
from .data.sparse import PAD_COMPONENT, CsrDataset, pad_queries
from .device import resolve_device
from .types import INDEX_SUFFIX, IndexArrays

# Default query padding (queries longer than this keep their largest values).
DEFAULT_QUERY_PAD = 128


def _bucket_batch(n: int) -> int:
    """Round batch sizes to powers of two (bounded set of batch shapes)."""
    b = 1
    while b < n:
        b *= 2
    return b


def route_params(k: int, score_cut: int = 64):
    """GroupedParams of the grouped route, the JAX API's tuned operating
    point: int8 scorer + exact rescore of the top pool + exact pool
    select; pool and rescore set scale with k (max(8k, 64) as the engine
    path; rescore >= 2k keeps the final top-k valid)."""
    from .search.grouped import GroupedParams

    return GroupedParams(
        k=k, score_cut=score_cut, pool=max(8 * k, 64), compute_dtype="i8",
        rescore=max(48, 2 * k), pool_mode="exact",
    )


class SeismicIndexRaw:
    """Raw index (reference: impl_seismic_index_raw!, src/pylib/mod.rs)."""

    _value_dtype = "f16"

    def __init__(self, arrays: IndexArrays, device=None):
        self._arrays = arrays
        self._device_arg = device
        self._device_index = {}  # torch.device -> DeviceIndex
        self._planner_ctx = None
        self._query_pad = DEFAULT_QUERY_PAD

    # ------------------------------------------------------------- build
    @classmethod
    def build_from_csr(cls, dataset: CsrDataset,
                       config: Optional[Configuration] = None,
                       progress: bool = False, device=None):
        """Build the index on the host (NumPy + the native build core); the
        device copy is made at the first search on `device`."""
        from .build.builder import build_index

        config = config or Configuration()
        if config.knn.nknn > 0 or config.knn.knn_path:
            raise NotImplementedError(
                "building or loading a k-NN graph: ROADMAP.md, modules to "
                "port, item 7")
        arrays = build_index(
            dataset, config, value_dtype=cls._value_dtype, progress=progress,
        )
        return cls(arrays, device=device)

    # --------------------------------------------------------- accessors
    @property
    def arrays(self) -> IndexArrays:
        return self._arrays

    @property
    def dim(self) -> int:
        return self._arrays.dim

    def __len__(self) -> int:
        return self._arrays.n_docs

    def device_index(self, device=None):
        """The DeviceIndex on `device` (None: the index's own device),
        uploaded on first use."""
        dev = resolve_device(device if device is not None
                             else self._device_arg)
        if dev not in self._device_index:
            self._device_index[dev] = self._arrays.to_device(dev)
        return self._device_index[dev]

    def _grouped_ctx(self):
        if self._planner_ctx is None:
            from .search.planner import PlannerContext

            self._planner_ctx = PlannerContext.from_arrays(self._arrays)
        return self._planner_ctx

    # ------------------------------------------------------------ search
    def _search_params(
        self,
        k: int,
        query_cut: int,
        n_knn: int,
        first_sorted: bool,
        block_budget: Optional[int],
        cand_budget: Optional[int],
        block_mode: Optional[str],
        doc_mode: Optional[str] = None,
        full_lists: bool = False,
        score_cut: int = 64,
    ):
        """The engine path's parameters with the JAX API's defaults
        (`seismic_tpu/api.py:221-266`)."""
        from .search.engine import SearchParams

        a = self._arrays
        if block_mode is None:
            if a.dense_summary is not None:
                block_mode = "dense"
            elif a.summary_comps is not None:
                block_mode = "summary"
            else:
                block_mode = "sketch"
        if doc_mode is None:
            doc_mode = "tiles" if a.doc_tiles is not None else "gather"
        return SearchParams(
            k=k,
            query_cut=query_cut,
            block_budget=(max(4 * k, 64) if block_budget is None
                          else block_budget),
            cand_budget=0 if cand_budget is None else cand_budget,
            block_mode=block_mode,
            doc_mode=doc_mode,
            full_lists=full_lists,
            score_cut=score_cut,
            n_knn=n_knn,
            first_sorted=first_sorted,
        )

    def _raw_batch_search(
        self,
        comp_lists: Sequence[np.ndarray],
        val_lists: Sequence[np.ndarray],
        k: int,
        query_cut: int,
        heap_factor: float,
        n_knn: int,
        first_sorted: bool = True,
        block_budget: Optional[int] = None,
        cand_budget: Optional[int] = None,
        block_mode: Optional[str] = None,
        doc_mode: Optional[str] = None,
        full_lists: bool = False,
        score_cut: int = 64,
        device=None,
    ):
        if n_knn > 0 and self._arrays.knn is None:
            raise ValueError(
                "n_knn > 0 but the index has no k-NN graph (carry one in "
                "with from_jax_arrays or IndexArrays.knn)")
        B = len(comp_lists)
        if B == 0:
            return np.zeros((0, k), np.float32), np.zeros((0, k), np.int64)
        q_comps, q_vals = pad_queries(comp_lists, val_lists, self._query_pad)
        bb = _bucket_batch(B)
        if bb > B:
            q_comps = np.pad(
                q_comps, ((0, bb - B), (0, 0)), constant_values=PAD_COMPONENT
            )
            q_vals = np.pad(q_vals, ((0, bb - B), (0, 0)))
        params = self._search_params(
            k, query_cut, n_knn, first_sorted, block_budget, cand_budget,
            block_mode, doc_mode, full_lists, score_cut,
        )
        index = self.device_index(device)
        # The grouped (list-major) route realizes the exhaustive scan of
        # the selected lists, so it serves full_lists and heap_factor <= 0
        # requests; block/cand budgets are honored only by the engine
        # path, so a request that sets them goes there. kNN refinement on
        # the grouped route is not ported (ROADMAP.md, modules to port,
        # item 2d): such a request takes the engine path as well.
        if (
            params.doc_mode == "tiles"
            and (full_lists or heap_factor <= 0.0)
            and block_budget is None
            and cand_budget is None
            and n_knn == 0
        ):
            from .search.grouped import DevicePlan, _grouped_impl
            from .search.planner import plan_grouped

            dev = index.device
            # the C++ planner, as the reference's route; raises when its
            # library cannot be built
            plan = plan_grouped(q_comps, q_vals, self._grouped_ctx(),
                                query_cut, native=True)
            scores, ids = _grouped_impl(
                index,
                DevicePlan.put(plan, dev),
                torch.from_numpy(q_comps).to(dev),
                torch.from_numpy(q_vals).to(dev),
                route_params(k, score_cut),
            )
            return scores.cpu().numpy()[:B], ids.cpu().numpy()[:B]
        from .search.engine import search_batch

        scores, ids = search_batch(index, q_comps, q_vals, params,
                                   heap_factor=heap_factor)
        return scores[:B], ids[:B]

    def search(
        self,
        query_components: np.ndarray,
        query_values: np.ndarray,
        k: int,
        query_cut: int,
        heap_factor: float,
        n_knn: int = 0,
        sorted: bool = True,
        block_budget: Optional[int] = None,
        cand_budget: Optional[int] = None,
        block_mode: Optional[str] = None,
        device=None,
    ) -> List[Tuple[float, int]]:
        """-> [(score, internal_doc_id)] (reference: mod.rs:1033-1076)."""
        c = np.asarray(query_components, dtype=np.int64)
        v = np.asarray(query_values, dtype=np.float32)
        scores, ids = self._raw_batch_search(
            [c], [v], k, query_cut, heap_factor, n_knn, sorted,
            block_budget, cand_budget, block_mode, device=device,
        )
        return [
            (float(s), int(d))
            for s, d in zip(scores[0], ids[0])
            if d >= 0 and np.isfinite(s)
        ]

    def batch_search(
        self,
        query_components: Sequence[np.ndarray],
        query_values: Sequence[np.ndarray],
        k: int = 10,
        query_cut: int = 10,
        heap_factor: float = 0.7,
        sorted: bool = True,
        n_knn: int = 0,
        num_threads: int = 0,
        block_budget: Optional[int] = None,
        cand_budget: Optional[int] = None,
        block_mode: Optional[str] = None,
        device=None,
    ) -> List[List[Tuple[float, int]]]:
        """Batched queries (reference: mod.rs:1098-1146) from explicit
        component/value lists; reading a queries `.bin` path arrives with
        the data I/O module (ROADMAP.md, modules to port, item 4)."""
        if isinstance(query_components, str):
            raise NotImplementedError(
                "queries from a .bin path: ROADMAP.md, modules to port, "
                "item 4")
        scores, ids = self._raw_batch_search(
            [np.asarray(c) for c in query_components],
            [np.asarray(v) for v in query_values],
            k, query_cut, heap_factor, n_knn, sorted, block_budget,
            cand_budget, block_mode, device=device,
        )
        return [
            [
                (float(s), int(d))
                for s, d in zip(srow, irow)
                if d >= 0 and np.isfinite(s)
            ]
            for srow, irow in zip(scores, ids)
        ]

    # ------------------------------------------------------------ save/load
    def save(self, path: str) -> str:
        return self._arrays.save(path)

    @classmethod
    def load(cls, path: str, device=None) -> "SeismicIndexRaw":
        return cls(IndexArrays.load(path), device=device)


__all__ = ["SeismicIndexRaw", "DEFAULT_QUERY_PAD", "INDEX_SUFFIX"]
