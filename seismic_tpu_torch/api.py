"""User-facing API classes, the counterparts of `seismic_tpu.api`'s:

- SeismicIndex / SeismicIndexLV        string tokens, string doc ids,
                                       stored text (JSONL / tar.gz input)
- SeismicIndexRaw / SeismicIndexRawLV  integer component ids, no metadata
                                       (CSR or `.bin` input)
- SeismicIndexDotVByte                 u8 forward values, no doc tiles,
                                       the block-pool lean path
- SeismicDataset / SeismicDatasetLV    growable dataset + exact search
- get_seismic_string()                 numpy dtype for token arrays ("U30")

The u16 / u32 split is an API-level vocabulary-capacity check; the `*LV`
classes lift the 65,536-token cap.

Every index class routes as `seismic_tpu/api.py:300-419` routes on the
accelerator. `SeismicIndexDotVByte` sends a request that sets no budget
and no block or doc mode to the block-pool route (`block_device_index`:
the blocks-as-rows view of its dense block summaries, narrowed to 512
columns, or without them the hashed view of its CSR summaries, 512
columns wide; its members ordered by value, with the lean u8 forward rows;
the C++ planner; `block_pool_params`): on every device, the card taking
the TPU's part. A tiles-mode request that asks for exhaustive lists
(`heap_factor <= 0` or `full_lists`) and sets no block/candidate budget
takes the grouped (list-major) route with the fixed `GroupedParams` of
the JAX API (`route_params`, kNN refinement included). Every other request
(`heap_factor > 0`, a block budget, another doc or block mode) takes the
engine path (`search/engine.py::search_batch`).

Entry points take `device=None`, which means the card ("cuda"); when CUDA
is absent they raise unless the caller asked for the CPU (`device="cpu"`,
as the tests do), where the kernels' plain PyTorch versions run.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import Configuration, TpuLayout, default_build_config
from .data import io as data_io
from .data.sparse import (
    PAD_COMPONENT,
    CsrDataset,
    GrowableCsrDataset,
    pad_queries,
)
from .device import resolve_device
from .search import knn as knn_mod
from .types import INDEX_SUFFIX, IndexArrays

SEISMIC_STRING = "U30"


def get_seismic_string() -> str:
    """NumPy dtype for token-string arrays (reference: src/pylib/mod.rs:41-44)."""
    return SEISMIC_STRING


_U16_CAP = 1 << 16
# component ids are int32 everywhere and PAD_COMPONENT (2^31 - 1) is the
# padding sentinel, so the LV capacity is 2^31 - 1 ids
_U32_CAP = (1 << 31) - 1

# Default query padding (queries longer than this keep their largest values).
DEFAULT_QUERY_PAD = 128


def _bucket_batch(n: int) -> int:
    """Round batch sizes to powers of two (bounded set of batch shapes)."""
    b = 1
    while b < n:
        b *= 2
    return b


def route_params(k: int, score_cut: int = 64, n_knn: int = 0):
    """GroupedParams of the grouped route, the JAX API's tuned operating
    point (`seismic_tpu/api.py:391-396`): int8 scorer + exact rescore of
    the top pool + exact pool select; pool and rescore set scale with k
    (max(8k, 64) as the engine path; rescore >= 2k keeps the final top-k
    valid); `n_knn` > 0 refines the top-k over the index's graph."""
    from .search.grouped import GroupedParams

    return GroupedParams(
        k=k, score_cut=score_cut, pool=max(8 * k, 64), n_knn=n_knn,
        compute_dtype="i8", rescore=max(48, 2 * k), pool_mode="exact",
    )


def block_pool_params(k: int, E: int, score_cut: int = 64, n_knn: int = 0):
    """GroupedParams of the block-pool route (`seismic_tpu/api.py:
    330-335`): int8 scorer over the block rows, a hier pool of
    max(4k, 32) blocks, each expanded into up to `E` (the index's
    max_block_len) members, all exact-rescored; `n_knn` > 0 refines."""
    from .search.grouped import GroupedParams

    pool = max(4 * k, 32)
    return GroupedParams(
        k=k, score_cut=score_cut, pool=pool, block_expand=E, n_knn=n_knn,
        compute_dtype="i8", pool_mode="hier",
        pool_per_pair=max(4, pool // 4),
    )


def _result_pairs(scores, ids) -> List[Tuple[float, int]]:
    return [(float(s), int(d)) for s, d in zip(scores, ids)
            if d >= 0 and np.isfinite(s)]


class _IndexBase:
    """What every index class shares (reference: SeismicIndex<S>,
    src/inverted_index_wrapper.rs:94-596): the host arrays, their device
    copies, the routes, the k-NN graph and save / load."""

    _component_cap = _U32_CAP
    _value_dtype = "f16"
    # the build's doc tiles and the engine's default doc mode; the
    # DotVByte class keeps no tiles and rescores
    _store_doc_tiles = True
    _default_doc_mode: Optional[str] = None
    # the block-pool route and the width its view is narrowed to
    _use_block_pool = False
    _block_V = 512

    def __init__(
        self,
        arrays: IndexArrays,
        doc_ids: Optional[np.ndarray] = None,
        token_to_id: Optional[dict] = None,
        contents: Optional[list] = None,
        device=None,
    ):
        self._arrays = arrays
        self._doc_ids = doc_ids
        self._token_to_id = token_to_id
        self._contents = contents
        self._device_arg = device
        self._device_index = {}  # torch.device -> DeviceIndex
        # torch.device -> (DeviceIndex of the block view, its
        # PlannerContext, block_expand)
        self._block_index = {}
        self._planner_ctx = None
        self._query_pad = DEFAULT_QUERY_PAD

    @classmethod
    def _build(cls, dataset: CsrDataset, config: Configuration,
               progress: bool = False, device=None, **meta):
        """Build the index on the host (NumPy + the native build core), then
        load or build its k-NN graph as `config.knn` asks; the device copy
        is made at the first search on `device`."""
        from .build.builder import build_index

        arrays = build_index(
            dataset, config, value_dtype=cls._value_dtype,
            store_doc_tiles=cls._store_doc_tiles, progress=progress,
        )
        index = cls(arrays, device=device, **meta)
        if config.knn.knn_path:
            index.load_knn(config.knn.knn_path, config.knn.nknn or None)
        elif config.knn.nknn > 0:
            index.build_knn(config.knn.nknn)
        return index

    # --------------------------------------------------------- accessors
    @property
    def arrays(self) -> IndexArrays:
        return self._arrays

    @property
    def dim(self) -> int:
        return self._arrays.dim

    @property
    def len(self) -> int:
        return self._arrays.n_docs

    def __len__(self) -> int:
        return self._arrays.n_docs

    @property
    def nnz(self) -> int:
        """Dataset nnz (reference: src/pylib/mod.rs:110-113): the source
        dataset's count recorded at build time, else the forward rows'
        entries."""
        if self._arrays.dataset_nnz:
            return int(self._arrays.dataset_nnz)
        return int(np.count_nonzero(self._arrays.fwd_comps != PAD_COMPONENT))

    @property
    def knn_len(self) -> int:
        return self._arrays.nknn

    @property
    def is_empty(self) -> bool:
        return self.len == 0

    def get(self, doc_id: int):
        """(components, values) of one document (reference:
        src/pylib/mod.rs:157-165)."""
        comps = self._arrays.fwd_comps[doc_id]
        mask = comps != PAD_COMPONENT
        vals = self._arrays.fwd_vals[doc_id].astype(np.float32)
        if self._arrays.fwd_val_min is not None:
            vals = (vals * self._arrays.fwd_val_step[doc_id]
                    + self._arrays.fwd_val_min[doc_id])
        return comps[mask].copy(), vals[mask].copy()

    def get_doc_ids_in_postings(self, list_id: int) -> List[int]:
        """Doc ids stored in one posting list (reference:
        inverted_index.rs:89-100)."""
        a = self._arrays
        if not (0 <= list_id < a.n_lists):
            raise ValueError(f"Invalid list_id: {list_id}")
        s = int(a.list_block_start[list_id])
        n = int(a.list_n_blocks[list_id])
        out: List[int] = []
        for b in range(s, s + n):
            st, ln = int(a.block_start[b]), int(a.block_len[b])
            out.extend(int(d) for d in a.postings[st: st + ln])
        return out

    def print_space_usage_byte(self) -> int:
        return self._arrays.print_space_usage_byte()

    # ------------------------------------------------------------ device
    def device_index(self, device=None):
        """The DeviceIndex on `device` (None: the index's own device),
        uploaded on first use."""
        dev = resolve_device(device if device is not None
                             else self._device_arg)
        if dev not in self._device_index:
            self._device_index[dev] = self._arrays.to_device(dev)
        return self._device_index[dev]

    def block_device_index(self, device=None):
        """(DeviceIndex, PlannerContext, block_expand) of the block-pool
        route on `device`, made on first use (`seismic_tpu/api.py:
        120-150`): the dense block summaries narrowed to `_block_V`
        columns when they are wider, the blocks-as-rows view with each
        block's members ordered by value, uploaded in the lean forward
        form when the values are u8; without dense summaries (a build with
        `summary_vocab_cap=0`) the hashed view of the u8 CSR summaries,
        `_block_V` columns wide, uploaded with `tile_hash`. It is a second
        device index: the engine's copy (`device_index`) keeps the
        unordered postings. block_expand is the index's max_block_len."""
        from .ops.tiles_prep import block_pool_arrays, narrow_vocab
        from .search.planner import PlannerContext

        dev = resolve_device(device if device is not None
                             else self._device_arg)
        if dev not in self._block_index:
            arrays = self._arrays
            tile_hash = 0
            layout = getattr(arrays.config, "layout", None)
            if (arrays.dense_summary is None
                    or getattr(layout, "summary_vocab_cap", 1) == 0):
                # no dense summaries: a build with summary_vocab_cap=0
                # keeps a one-column placeholder, which the JAX API takes
                # for dense rows (and fails on); it gets the hashed view
                tile_hash = self._block_V
                bv = block_pool_arrays(arrays, tile_hash,
                                       order_members=True, mode="hash")
            else:
                width = int(arrays.dense_summary.shape[1])
                if self._block_V < width and arrays.vocab_rank is not None:
                    arrays = narrow_vocab(arrays, self._block_V)
                    width = self._block_V
                bv = block_pool_arrays(arrays, width, order_members=True,
                                       mode="dense")
            self._block_index[dev] = (bv.to_device(dev, tile_hash=tile_hash),
                                      PlannerContext.from_arrays(bv),
                                      int(self._arrays.max_block_len))
        return self._block_index[dev]

    def _invalidate_device(self):
        """Drop the device copies (and the planner context): the next
        search uploads the arrays as they are now, graph included."""
        self._device_index = {}
        self._block_index = {}
        self._planner_ctx = None

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
            doc_mode = self._default_doc_mode or (
                "tiles" if a.doc_tiles is not None else "gather")
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
                "n_knn > 0 but the index has no k-NN graph; call build_knn "
                "or load_knn first")
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
        # The block-pool route: the pool ranks the blocks' dense summaries,
        # pooled blocks expand into their members, every member is
        # exact-rescored from the forward rows. Taken for any heap_factor
        # (the finite block pool does the threshold's work); a budget or a
        # block or doc mode goes to the engine path.
        if (
            self._use_block_pool
            and self._arrays.summary_comps is not None
            and block_budget is None
            and cand_budget is None
            and block_mode is None
            and doc_mode is None
        ):
            from .search.grouped import DevicePlan, _grouped_impl
            from .search.planner import plan_grouped

            bindex, bctx, E = self.block_device_index(device)
            dev = bindex.device
            plan = plan_grouped(q_comps, q_vals, bctx, query_cut,
                                native=True)
            scores, ids = _grouped_impl(
                bindex,
                DevicePlan.put(plan, dev),
                torch.from_numpy(q_comps).to(dev),
                torch.from_numpy(q_vals).to(dev),
                block_pool_params(k, E, score_cut, n_knn),
            )
            return scores.cpu().numpy()[:B], ids.cpu().numpy()[:B]
        params = self._search_params(
            k, query_cut, n_knn, first_sorted, block_budget, cand_budget,
            block_mode, doc_mode, full_lists, score_cut,
        )
        index = self.device_index(device)
        # The grouped (list-major) route realizes the exhaustive scan of
        # the selected lists, so it serves full_lists and heap_factor <= 0
        # requests; block/cand budgets are honored only by the engine
        # path, so a request that sets them goes there.
        if (
            params.doc_mode == "tiles"
            and (full_lists or heap_factor <= 0.0)
            and block_budget is None
            and cand_budget is None
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
                route_params(k, score_cut, n_knn),
            )
            return scores.cpu().numpy()[:B], ids.cpu().numpy()[:B]
        from .search.engine import search_batch

        layout = getattr(self._arrays.config, "layout", None) or TpuLayout()
        scores, ids = search_batch(index, q_comps, q_vals, params,
                                   heap_factor=heap_factor,
                                   sketch_dim=layout.sketch_dim,
                                   sketch_seed=layout.sketch_seed)
        return scores[:B], ids[:B]

    # ------------------------------------------------------------- knn
    def build_knn(self, nknn: int, batch_size: int = 256,
                  device=None) -> None:
        """Build the k-NN graph by batched self-search (reference: Knn::new,
        inverted_index.rs:448-500) on `device`; later searches carry it."""
        graph = knn_mod.build_knn(self._arrays, self.device_index(device),
                                  nknn, batch_size=batch_size)
        self._arrays.knn = graph
        self._invalidate_device()

    def save_knn(self, path: str) -> str:
        if self._arrays.knn is None:
            raise ValueError("index has no k-NN graph")
        return knn_mod.save_knn(self._arrays.knn, path)

    def load_knn(self, path: str, nknn: Optional[int] = None) -> None:
        self._arrays.knn = knn_mod.load_knn(path, nknn)
        self._invalidate_device()

    def convert(self, value_dtype: str) -> "_IndexBase":
        """Re-encode the built forward rows' values in `value_dtype`
        ("f32" / "f16" / "bf16" / "u8" / "u16", the fixedu8 / fixedu16
        names accepted) without re-running the build
        (`build/convert.py`); the device copies are dropped, so the next
        search uploads the new form (u8 / u16: the lean form). Returns
        self."""
        from .build.convert import convert_index

        self._arrays = convert_index(self._arrays, value_dtype)
        self._invalidate_device()
        return self

    # ---------------------------------------------------------- save/load
    def save(self, path: str) -> str:
        """The index file, plus `<file>.meta.json` with the doc ids, token
        map and contents when the index has any (the JAX API's files)."""
        p = self._arrays.save(path)
        side = {
            "doc_ids": None if self._doc_ids is None
            else [str(x) for x in self._doc_ids],
            "token_to_id": self._token_to_id,
            "contents": self._contents,
        }
        if any(v is not None for v in side.values()):
            with open(p + ".meta.json", "w") as f:
                json.dump(side, f)
        return p

    @classmethod
    def load(cls, path: str, device=None):
        arrays = IndexArrays.load(path)
        p = path if path.endswith(INDEX_SUFFIX) else path + INDEX_SUFFIX
        doc_ids = token_to_id = contents = None
        meta_path = p + ".meta.json"
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                side = json.load(f)
            if side.get("doc_ids") is not None:
                doc_ids = np.asarray(side["doc_ids"], dtype=SEISMIC_STRING)
            token_to_id = side.get("token_to_id")
            contents = side.get("contents")
        return cls(arrays, doc_ids, token_to_id, contents, device=device)


def _encode_tokens(token_to_id: dict, query_components, query_values):
    """String tokens -> (int64 ids, f32 values); unknown tokens dropped."""
    comps, vals = [], []
    for tok, v in zip(query_components, query_values):
        tid = token_to_id.get(str(tok))
        if tid is not None:
            comps.append(tid)
            vals.append(float(v))
    return np.asarray(comps, dtype=np.int64), np.asarray(vals, np.float32)


class SeismicIndex(_IndexBase):
    """String tokens in, string doc ids out, optional stored document text
    (reference: src/pylib/mod.rs:46-661)."""

    _component_cap = _U16_CAP

    @classmethod
    def build(
        cls,
        input_path: str,
        n_postings: int = 3500,
        centroid_fraction: float = 0.1,
        min_cluster_size: int = 2,
        summary_energy: float = 0.4,
        max_fraction: float = 1.5,
        doc_cut: int = 15,
        nknn: int = 0,
        knn_path: Optional[str] = None,
        batched_indexing: Optional[int] = None,  # accepted, ignored (parity)
        input_token_to_id_map: Optional[dict] = None,
        load_content: bool = True,
        num_threads: int = 0,  # accepted, ignored (parity)
        layout: Optional[TpuLayout] = None,
        progress: bool = False,
        device=None,
    ) -> "SeismicIndex":
        """Build from a JSONL / tar.gz collection (reference:
        src/pylib/mod.rs:356-406)."""
        dataset, doc_ids, token_to_id, contents = data_io.read_jsonl_dataset(
            input_path,
            token_to_id=input_token_to_id_map,
            load_content=load_content,
            max_vocab=cls._component_cap,
        )
        config = default_build_config(
            n_postings=n_postings, centroid_fraction=centroid_fraction,
            min_cluster_size=min_cluster_size, summary_energy=summary_energy,
            max_fraction=max_fraction, doc_cut=doc_cut, nknn=nknn,
            knn_path=knn_path, layout=layout,
        )
        return cls._build(
            dataset, config, progress, device, doc_ids=doc_ids,
            token_to_id=token_to_id,
            contents=contents if load_content else None,
        )

    @classmethod
    def build_from_dataset(
        cls,
        dataset: "SeismicDataset",
        n_postings: int = 3500,
        centroid_fraction: float = 0.1,
        min_cluster_size: int = 2,
        summary_energy: float = 0.4,
        max_fraction: float = 1.5,
        doc_cut: int = 15,
        nknn: int = 0,
        knn_path: Optional[str] = None,
        batched_indexing: Optional[int] = None,
        num_threads: int = 0,
        layout: Optional[TpuLayout] = None,
        progress: bool = False,
        device=None,
    ) -> "SeismicIndex":
        """Index a growable SeismicDataset (reference:
        src/pylib/mod.rs:408-468, wrapper.rs:368-394)."""
        config = default_build_config(
            n_postings=n_postings, centroid_fraction=centroid_fraction,
            min_cluster_size=min_cluster_size, summary_energy=summary_energy,
            max_fraction=max_fraction, doc_cut=doc_cut, nknn=nknn,
            knn_path=knn_path, layout=layout,
        )
        return cls._build(
            dataset._dataset(), config, progress, device,
            doc_ids=np.asarray(dataset._doc_ids, dtype=SEISMIC_STRING),
            token_to_id=dict(dataset._token_to_id),
            contents=list(dataset._contents),
        )

    def _encode_query(self, query_components, query_values):
        return _encode_tokens(self._token_to_id or {}, query_components,
                              query_values)

    def search(
        self,
        query_id: str,
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
    ) -> List[Tuple[str, float, str]]:
        """One query -> [(query_id, score, doc_id)] (reference:
        src/pylib/mod.rs:490-533)."""
        c, v = self._encode_query(query_components, query_values)
        scores, ids = self._raw_batch_search(
            [c], [v], k, query_cut, heap_factor, n_knn, sorted,
            block_budget, cand_budget, block_mode, device=device,
        )
        return self._format_results(query_id, scores[0], ids[0])

    def batch_search(
        self,
        queries_ids: np.ndarray,
        query_components: Sequence[np.ndarray],
        query_values: Sequence[np.ndarray],
        k: int,
        query_cut: int,
        heap_factor: float,
        sorted: bool = True,
        n_knn: int = 0,
        num_threads: int = 0,
        block_budget: Optional[int] = None,
        cand_budget: Optional[int] = None,
        block_mode: Optional[str] = None,
        device=None,
    ) -> List[List[Tuple[str, float, str]]]:
        """Batched queries (reference: src/pylib/mod.rs:572-655)."""
        encoded = [self._encode_query(c, v)
                   for c, v in zip(query_components, query_values)]
        scores, ids = self._raw_batch_search(
            [e[0] for e in encoded], [e[1] for e in encoded],
            k, query_cut, heap_factor, n_knn, sorted,
            block_budget, cand_budget, block_mode, device=device,
        )
        return [self._format_results(str(qid), s, i)
                for qid, s, i in zip(queries_ids, scores, ids)]

    def _format_results(self, query_id: str, scores, ids):
        return [
            (query_id, s, str(self._doc_ids[d]) if self._doc_ids is not None
             else str(d))
            for s, d in _result_pairs(scores, ids)
        ]

    def get_doc_text(self, doc_id: int) -> Optional[str]:
        """Stored document text (reference: wrapper.rs:288-293)."""
        if self._contents is None:
            return None
        return self._contents[doc_id]


class SeismicIndexLV(SeismicIndex):
    """Large-vocabulary (> 65,535 tokens) variant."""

    _component_cap = _U32_CAP


class SeismicIndexRaw(_IndexBase):
    """Raw index: integer component ids, no metadata (reference:
    impl_seismic_index_raw!, src/pylib/mod.rs:663-1151)."""

    _component_cap = _U16_CAP

    @classmethod
    def build(
        cls,
        input_file: str,
        n_postings: int = 3500,
        centroid_fraction: float = 0.1,
        min_cluster_size: int = 2,
        summary_energy: float = 0.4,
        max_fraction: float = 1.5,
        doc_cut: int = 15,
        nknn: int = 0,
        knn_path: Optional[str] = None,
        batched_indexing: Optional[int] = None,
        num_threads: int = 0,
        layout: Optional[TpuLayout] = None,
        progress: bool = False,
        device=None,
    ) -> "SeismicIndexRaw":
        """Build from the seismic inner binary format (reference:
        src/pylib/mod.rs:956-1012)."""
        dataset = data_io.read_seismic_format(input_file)
        if dataset.dim > cls._component_cap:
            raise ValueError(
                f"component ids exceed the {cls._component_cap} capacity; "
                "use the LV variant"
            )
        config = default_build_config(
            n_postings=n_postings, centroid_fraction=centroid_fraction,
            min_cluster_size=min_cluster_size, summary_energy=summary_energy,
            max_fraction=max_fraction, doc_cut=doc_cut, nknn=nknn,
            knn_path=knn_path, layout=layout,
        )
        return cls.build_from_csr(dataset, config, progress, device)

    @classmethod
    def build_from_csr(cls, dataset: CsrDataset,
                       config: Optional[Configuration] = None,
                       progress: bool = False, device=None):
        """Build from a CsrDataset; `config.knn` loads (`knn_path`) or
        builds (`nknn`) the k-NN graph."""
        return cls._build(dataset, config or Configuration(), progress,
                          device)

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
        return _result_pairs(scores[0], ids[0])

    def batch_search(
        self,
        query_path_or_components,
        query_values: Optional[Sequence[np.ndarray]] = None,
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
        """Batched queries (reference: mod.rs:1098-1146) from a queries
        `.bin` path or explicit component/value lists."""
        if isinstance(query_path_or_components, str):
            qs = data_io.read_seismic_format(query_path_or_components)
            comp_lists = [qs.get(i)[0] for i in range(len(qs))]
            val_lists = [qs.get(i)[1].astype(np.float32)
                         for i in range(len(qs))]
        else:
            comp_lists = [np.asarray(c) for c in query_path_or_components]
            val_lists = [np.asarray(v) for v in query_values]
        scores, ids = self._raw_batch_search(
            comp_lists, val_lists, k, query_cut, heap_factor, n_knn, sorted,
            block_budget, cand_budget, block_mode, device=device,
        )
        return [_result_pairs(s, i) for s, i in zip(scores, ids)]


class SeismicIndexRawLV(SeismicIndexRaw):
    _component_cap = _U32_CAP


class SeismicIndexDotVByte(SeismicIndex):
    """The memory-lean variant (reference: src/pylib/dotvbyte.rs:32-426):
    u8 forward values with a per-document (min, step), no replicated doc
    tiles, and searches on the block-pool route (dense block summaries,
    or hashed CSR summaries in a build without them, pool blocks; their
    members are exact-rescored from the u8 forward rows by K3's u8 form);
    other requests take the engine path in its
    rescore doc mode on the same forward rows."""

    _component_cap = _U16_CAP
    _value_dtype = "u8"
    _store_doc_tiles = False
    _default_doc_mode = "rescore"
    _use_block_pool = True

    def build_knn(self, nknn: int, batch_size: int = 256,
                  device=None) -> None:
        # as the reference, which builds no graph on compressed datasets
        # (dotvbyte.rs:101-112)
        raise NotImplementedError(
            "SeismicIndexDotVByte does not support build_knn; build the "
            "graph on an uncompressed index and load it with load_knn")


class SeismicDataset:
    """In-memory accumulation + brute-force exact search on `device`, the
    ground truth of recall (reference: wrapper.rs:599-758, FlatIndex)."""

    _component_cap = _U16_CAP

    def __init__(self, device=None):
        self._growable = GrowableCsrDataset()
        self._doc_ids: List[str] = []
        self._token_to_id: dict = {}
        self._contents: List[Optional[str]] = []
        self._frozen: Optional[CsrDataset] = None
        self._device = device

    @property
    def dim(self) -> int:
        return self._growable.dim

    @property
    def len(self) -> int:
        return len(self._growable)

    def __len__(self) -> int:
        return len(self._growable)

    @property
    def nnz(self) -> int:
        return self._growable.nnz

    def add_document(
        self,
        doc_id: str,
        tokens: Sequence[str],
        values: Sequence[float],
        content: Optional[str] = None,
    ) -> None:
        """(reference: dataset.rs:66-85; incremental token-id assignment)"""
        comps = []
        for tok in tokens:
            tok = str(tok)
            tid = self._token_to_id.get(tok)
            if tid is None:
                tid = len(self._token_to_id)
                if tid >= self._component_cap:
                    raise ValueError(
                        "vocabulary exceeded the component type capacity; "
                        "use the LV variant"
                    )
                self._token_to_id[tok] = tid
            comps.append(tid)
        self._growable.push(comps, values)
        self._doc_ids.append(str(doc_id))
        self._contents.append(content)
        self._frozen = None

    def get_doc_text(self, doc_id: int) -> Optional[str]:
        return self._contents[doc_id]

    def _dataset(self) -> CsrDataset:
        if self._frozen is None:
            self._frozen = self._growable.freeze()
        return self._frozen

    def search(
        self,
        query_id: str,
        query_components: np.ndarray,
        query_values: np.ndarray,
        k: int,
    ) -> List[Tuple[str, float, str]]:
        """Exact search (reference: dataset.rs:104-127)."""
        return self.batch_search(
            np.asarray([query_id]), [query_components], [query_values], k
        )[0]

    def batch_search(
        self,
        queries_ids: np.ndarray,
        query_components: Sequence[np.ndarray],
        query_values: Sequence[np.ndarray],
        k: int,
        num_threads: int = 0,
    ) -> List[List[Tuple[str, float, str]]]:
        from .search.exact import exact_search

        encoded = [_encode_tokens(self._token_to_id, c, v)
                   for c, v in zip(query_components, query_values)]
        q_comps, q_vals = pad_queries(
            [e[0] for e in encoded],
            [e[1] for e in encoded],
            max(DEFAULT_QUERY_PAD, max((len(e[0]) for e in encoded),
                                       default=1)),
        )
        scores, ids = exact_search(self._dataset(), q_comps, q_vals, k,
                                   device=self._device)
        return [
            [(str(qid), s, self._doc_ids[d]) for s, d in _result_pairs(
                srow, irow)]
            for qid, srow, irow in zip(queries_ids, scores, ids)
        ]


class SeismicDatasetLV(SeismicDataset):
    _component_cap = _U32_CAP


__all__ = [
    "SeismicIndex",
    "SeismicIndexLV",
    "SeismicIndexRaw",
    "SeismicIndexRawLV",
    "SeismicIndexDotVByte",
    "SeismicDataset",
    "SeismicDatasetLV",
    "get_seismic_string",
    "route_params",
    "block_pool_params",
    "DEFAULT_QUERY_PAD",
    "INDEX_SUFFIX",
]
