"""Document-sharded search (counterpart of `seismic_tpu/parallel/sharded.py`).

The documents are split into contiguous shards, each shard is built as an
index of its own, and a query batch is answered by the ordinary search
program on every shard followed by a merge of the shards' top-k by (score
descending, global id ascending), so the result does not depend on the
number of shards except through each shard's own pruning.

Where the JAX package stacks the shards into one SPMD program
(`shard_map` over a "docs" mesh axis, `all_gather` in the program),
`ShardedIndex` keeps one `DeviceIndex` per shard on each device of its
column of the mesh (`parallel/mesh.py`; an entry that repeats a device
holds its shards side by side there) and runs the search program once per
shard on that shard's device. Every shard's work is enqueued before any
result is read back, so cards work side by side. Each shard's ids are
shifted by its first document's global id (-1 stays -1), the `[S, B, k]`
results are gathered onto the row's first device and merged
(`merge_topk_across_docs`). On a mesh that spans processes
(`make_mesh_global`), each process searches its own shards, and an
`all_gather` over the process group (the list form, which gloo has)
brings every shard's results to every process before the same merge.

The host arrays are padded to common shapes (`pad_shards_to_common_shapes`)
as in the JAX package, so both packages search, save and load the same
per-shard arrays; with `pallas_tiles` the shards' aligned tile layouts are
padded to common rows and uploaded through `to_device(aligned=...)`, and a
planner context is kept per shard for the grouped route. JAX's
`_repack_plan` (its `sharded.py:551-585`) pads every cell's plan to common
capacities so that one SPMD program serves all cells; here each cell runs
its own program on its own plan, so it has no counterpart.
"""

from __future__ import annotations

import contextlib
import json
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from ..config import Configuration
from ..data.sparse import PAD_COMPONENT, CsrDataset
from ..types import IndexArrays
from .mesh import Mesh

# the sort key of an empty slot (-1): after every global id
_EMPTY_KEY = 2 ** 63 - 1


# ---------------------------------------------------------------------------
# Host-side shard construction
# ---------------------------------------------------------------------------


def _pad_rows(a: np.ndarray, n: int, fill) -> np.ndarray:
    if a.shape[0] == n:
        return a
    pad = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad, constant_values=fill)


def _pad_cols(a: np.ndarray, n: int, fill) -> np.ndarray:
    if a.shape[1] == n:
        return a
    pad = [(0, 0), (0, n - a.shape[1])] + [(0, 0)] * (a.ndim - 2)
    return np.pad(a, pad, constant_values=fill)


def _opt_rows(a, n: int, fill):
    return None if a is None else _pad_rows(a, n, fill)


def pad_shards_to_common_shapes(shards: List[IndexArrays]) -> List[IndexArrays]:
    """Pad every shard's arrays to the shapes of the largest (the JAX
    package's padding, kept so that both packages hold the same per-shard
    arrays): forward rows to the most documents and the widest row,
    postings and posting-indexed arrays with a `max_list_len` tail so any
    list's window can be read at any of its offsets, blocks to the most
    blocks plus one list's worth and a sentinel, the k-NN graph to the
    widest."""
    n_docs = max(s.fwd_comps.shape[0] for s in shards)
    width = max(s.fwd_comps.shape[1] for s in shards)
    mb = max(s.max_blocks_per_list for s in shards)
    mll = max(s.max_list_len for s in shards)
    n_post = max(s.postings.shape[0] for s in shards) + mll
    n_pbl = max(
        (s.posting_block_local.shape[0] for s in shards
         if s.posting_block_local is not None),
        default=0,
    ) + mll
    nbp = max(max(s.block_start.shape[0] for s in shards),
              max(int(s.list_n_blocks.sum()) for s in shards) + mb + 1)
    n_tile = max(
        (s.doc_tiles.shape[0] for s in shards if s.doc_tiles is not None),
        default=0,
    ) + mll
    nknn = max(s.nknn for s in shards)
    out = []
    for s in shards:
        knn = None
        if s.knn is not None or nknn:
            knn = _pad_rows(s.knn if s.knn is not None
                            else np.full((s.n_docs, nknn), -1, np.int32),
                            n_docs, -1)
        out.append(IndexArrays(
            fwd_comps=_pad_cols(_pad_rows(s.fwd_comps, n_docs,
                                          PAD_COMPONENT), width,
                                PAD_COMPONENT),
            fwd_vals=_pad_cols(_pad_rows(s.fwd_vals, n_docs, 0), width, 0),
            fwd_val_min=_opt_rows(s.fwd_val_min, n_docs, 0),
            fwd_val_step=_opt_rows(s.fwd_val_step, n_docs, 0),
            postings=_pad_rows(s.postings, n_post, 0),
            block_start=_pad_rows(s.block_start, nbp, 0),
            block_len=_pad_rows(s.block_len, nbp, 0),
            list_block_start=s.list_block_start,
            list_n_blocks=s.list_n_blocks,
            summary_comps=_opt_rows(s.summary_comps, nbp, PAD_COMPONENT),
            summary_codes=_opt_rows(s.summary_codes, nbp, 0),
            summary_min=_pad_rows(s.summary_min, nbp, 0),
            summary_quant=_pad_rows(s.summary_quant, nbp, 0),
            list_vocab=s.list_vocab,
            vocab_rank=s.vocab_rank,
            vocab_csum=s.vocab_csum,
            dense_summary=_opt_rows(s.dense_summary, nbp, 0),
            dense_scale=_opt_rows(s.dense_scale, nbp, 0),
            doc_tiles=_opt_rows(s.doc_tiles, n_tile, 0),
            doc_tile_scale=_opt_rows(s.doc_tile_scale, n_tile, 0),
            tile_ovf_comps=_opt_rows(s.tile_ovf_comps, n_tile, -1),
            tile_ovf_vals=_opt_rows(s.tile_ovf_vals, n_tile, 0),
            list_post_start=s.list_post_start,
            list_len=s.list_len,
            posting_block_local=_opt_rows(s.posting_block_local, n_pbl, 0),
            block_sketch=_opt_rows(s.block_sketch, nbp, 0),
            block_sketch_scale=_opt_rows(s.block_sketch_scale, nbp, 0),
            doc_sketch=_opt_rows(s.doc_sketch, n_docs, 0),
            doc_sketch_scale=_opt_rows(s.doc_sketch_scale, n_docs, 0),
            knn=knn,
            dim=s.dim,
            n_docs=n_docs,
            max_blocks_per_list=mb,
            max_block_len=s.max_block_len,
            max_list_len=mll,
            config=s.config,
        ))
    return out


def _on(device):
    """The CUDA device context of `device` (the kernels launch on the
    current device), or nothing for the CPU."""
    import torch

    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _global_ids(ids, offset: int):
    """A shard's ids shifted by its first document's global id, int64;
    -1 stays -1."""
    import torch

    ids = ids.to(torch.int64)
    return torch.where(ids >= 0, ids + offset, -1)


def merge_topk_across_docs(scores, gids):
    """Merge the shards' top-k: scores f32 / gids int [S, B, k] (-1 where
    empty) -> (scores f32 [B, k], gids int64 [B, k]), sorted by score
    descending, then by global id ascending with -1 after every id (the
    order of JAX's two-key sort, `sharded.py:622-638`): a stable sort by
    id, then a stable sort by score."""
    import torch

    S, B, k = scores.shape
    flat_s = scores.permute(1, 0, 2).reshape(B, S * k)
    flat_i = gids.to(torch.int64).permute(1, 0, 2).reshape(B, S * k)
    key = torch.where(flat_i >= 0, flat_i, _EMPTY_KEY)
    by_id = torch.sort(key, dim=1, stable=True).indices
    flat_s = torch.gather(flat_s, 1, by_id)
    flat_i = torch.gather(flat_i, 1, by_id)
    order = torch.sort(flat_s, dim=1, descending=True,
                       stable=True).indices[:, :k]
    return torch.gather(flat_s, 1, order), torch.gather(flat_i, 1, order)


def _gather_cells(results: dict, mesh: Mesh, B: int, k: int) -> dict:
    """Every (data row, shard) cell's results on this process, from the
    processes that own them: each process fills its own cells of a
    [D, S, B, k] pair (the rest -inf / -1), one `all_gather` (the list
    form) brings every process's pair, and each cell is read from its
    owner's. On the card for NCCL, on the CPU for gloo."""
    import torch
    import torch.distributed as dist

    D, S = mesh.shape["data"], mesh.shape["docs"]
    if dist.get_backend() == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device("cpu")
    full_s = torch.full((D, S, B, k), -torch.inf, dtype=torch.float32,
                        device=dev)
    full_i = torch.full((D, S, B, k), -1, dtype=torch.int64, device=dev)
    for (d, s), (sc, gi) in results.items():
        full_s[d, s] = sc.to(dev)
        full_i[d, s] = gi.to(dev)
    world = dist.get_world_size()
    all_s = [torch.empty_like(full_s) for _ in range(world)]
    all_i = [torch.empty_like(full_i) for _ in range(world)]
    dist.all_gather(all_s, full_s)
    dist.all_gather(all_i, full_i)
    return {(d, s): (all_s[mesh.ranks[d][s]][d, s],
                     all_i[mesh.ranks[d][s]][d, s])
            for d in range(D) for s in range(S)}


@dataclass
class ShardedIndex:
    """The shards of a document-sharded index: `device_index[d][s]` is
    shard s's `DeviceIndex` on mesh entry (d, s) (one upload per distinct
    device; None for an entry of another process), `doc_offsets[s]` the
    global id of shard s's first document."""

    device_index: list
    doc_offsets: List[int]
    mesh: Mesh
    n_shards: int
    total_docs: int
    config: Optional[Configuration] = None
    # the padded host arrays of the shards (what save() writes)
    host_shards: Optional[List[IndexArrays]] = field(default=None,
                                                     repr=False)
    # per-shard planner contexts of the grouped route (pallas_tiles only)
    planner_ctxs: Optional[list] = field(default=None, repr=False)

    @staticmethod
    def build(
        dataset: CsrDataset,
        mesh: Mesh,
        config: Optional[Configuration] = None,
        value_dtype: str = "f32",
        progress: bool = False,
        n_workers: int = 0,
        pallas_tiles: bool = False,
        tile_csub: int = 1,
        tile_hash: int = 0,
        tile_block: int = 0,
        **build_kw,
    ) -> "ShardedIndex":
        """Split the collection into `mesh.shape["docs"]` contiguous shards
        (`np.linspace` bounds), build one index per shard (`build_kw` goes
        to `build_index`, e.g. `store_doc_tiles=False`), then
        `from_shards`. `n_workers` > 1 builds the shards in a thread pool
        (the native build releases the GIL); 0 takes one worker per shard,
        at most `os.cpu_count()`."""
        from ..build.builder import build_index

        config = config or Configuration()
        n_shards = mesh.shape["docs"]
        n = len(dataset)
        bounds = np.linspace(0, n, n_shards + 1).astype(np.int64)

        def build_one(s):
            sub = dataset.subset(np.arange(int(bounds[s]),
                                           int(bounds[s + 1])))
            return build_index(sub, config, value_dtype=value_dtype,
                               progress=progress, **build_kw)

        if n_workers == 0:
            n_workers = min(n_shards, os.cpu_count() or 1)
        if n_workers > 1:
            with ThreadPoolExecutor(max_workers=n_workers) as ex:
                shards = list(ex.map(build_one, range(n_shards)))
        else:
            shards = [build_one(s) for s in range(n_shards)]
        return ShardedIndex.from_shards(
            shards, [int(b) for b in bounds[:-1]], mesh, n, config,
            pallas_tiles=pallas_tiles, tile_csub=tile_csub,
            tile_hash=tile_hash, tile_block=tile_block)

    @staticmethod
    def from_shards(
        shards: List[IndexArrays],
        doc_offsets: Sequence[int],
        mesh: Mesh,
        total_docs: int,
        config: Optional[Configuration] = None,
        pallas_tiles: bool = False,
        tile_csub: int = 1,
        tile_hash: int = 0,
        tile_block: int = 0,
    ) -> "ShardedIndex":
        """Pad the shards to common shapes and upload each to its mesh
        column's devices. `tile_block=V` (with `pallas_tiles`) takes each
        shard's blocks-as-rows view (`block_pool_arrays`, members ordered
        by value): dense rows when every shard kept dense summaries
        (narrowed to V first when wider), hashed rows (uploaded with
        `tile_hash=V`) otherwise; searches then pass
        `GroupedParams(block_expand=...)`. `tile_hash=V` (with
        `pallas_tiles`) retiles every shard with hashed tiles. The lean
        forward form is the upload's own choice for u8 / u16 values."""
        from ..ops.tiles_prep import (
            block_pool_arrays,
            hash_retile,
            narrow_vocab,
            prepare_pallas_tiles,
        )

        if len(shards) != mesh.shape["docs"]:
            raise ValueError(f"{len(shards)} shards for a mesh of "
                             f"{mesh.shape['docs']} docs shards")
        shards = pad_shards_to_common_shapes(shards)
        if tile_block:
            if not pallas_tiles:
                raise ValueError("tile_block requires pallas_tiles")
            if tile_hash:
                raise ValueError("tile_block and tile_hash are exclusive")
            if all(s.dense_summary is not None for s in shards):
                width = int(shards[0].dense_summary.shape[1])
                if tile_block < width:
                    shards = [narrow_vocab(s, tile_block) for s in shards]
                    width = tile_block
                if width != tile_block:
                    raise ValueError(
                        f"tile_block {tile_block} must be <= the build's "
                        f"summary_vocab_cap ({width}) for dense block tiles")
                shards = [block_pool_arrays(s, tile_block, order_members=True,
                                            mode="dense") for s in shards]
            else:
                shards = [block_pool_arrays(s, tile_block, order_members=True,
                                            mode="hash") for s in shards]
                tile_hash = tile_block  # hashed rows, the hashed query
        elif tile_hash:
            if not pallas_tiles:
                raise ValueError("tile_hash requires pallas_tiles")
            shards = [hash_retile(s, tile_hash) for s in shards]
        aligned = [None] * len(shards)
        if pallas_tiles:
            # each shard's aligned layout, padded to common rows: the rows
            # appended are zero, past every shard's own zero region, so
            # each shard's plans stay valid
            aligned = [prepare_pallas_tiles(s, tile_csub) for s in shards]
            rows = max(a[0].shape[0] for a in aligned)
            aligned = [(_pad_rows(t, rows, 0), _pad_rows(sc, rows, 0), rg, ro)
                       for (t, sc, rg, ro) in aligned]
        csub = tile_csub if pallas_tiles else 1
        uploads = {}
        grid = []
        for d, row in enumerate(mesh.grid):
            out = []
            for s, dev in enumerate(row):
                if not mesh.is_local(d, s):
                    out.append(None)
                    continue
                key = (str(dev), s)
                if key not in uploads:
                    uploads[key] = shards[s].to_device(
                        dev, tile_csub=csub, tile_hash=tile_hash,
                        aligned=aligned[s])
                out.append(uploads[key])
            grid.append(out)
        ctxs = None
        if pallas_tiles:
            from ..search.planner import PlannerContext

            ctxs = [PlannerContext.from_arrays(s, region_start=a[2],
                                               csub=tile_csub)
                    for s, a in zip(shards, aligned)]
        return ShardedIndex(
            device_index=grid,
            doc_offsets=[int(o) for o in doc_offsets],
            mesh=mesh,
            n_shards=len(shards),
            total_docs=total_docs,
            config=config,
            host_shards=shards,
            planner_ctxs=ctxs,
        )

    def nbytes(self) -> List[int]:
        """Bytes on the device of each shard's first upload."""
        return [next(row[s] for row in self.device_index
                     if row[s] is not None).nbytes()
                for s in range(self.n_shards)]

    # ------------------------------------------------------------ save/load
    def save(self, path: str) -> str:
        """`<path>/shard{i}.index.seismic_tpu` (`IndexArrays.save`) for
        each shard and `<path>/sharded.json`, the JAX package's layout."""
        os.makedirs(path, exist_ok=True)
        for i, s in enumerate(self.host_shards):
            s.save(os.path.join(path, f"shard{i}"))
        manifest = {
            "n_shards": self.n_shards,
            "total_docs": self.total_docs,
            "doc_offsets": self.doc_offsets,
            "config": self.config.to_dict() if self.config else None,
        }
        with open(os.path.join(path, "sharded.json"), "w") as f:
            json.dump(manifest, f)
        return path

    @staticmethod
    def load(path: str, mesh: Mesh, pallas_tiles: bool = False,
             tile_csub: int = 1) -> "ShardedIndex":
        """Load a saved sharded index onto `mesh`, whose "docs" axis must
        equal the saved shard count (ValueError otherwise)."""
        with open(os.path.join(path, "sharded.json")) as f:
            manifest = json.load(f)
        n_shards = manifest["n_shards"]
        if mesh.shape["docs"] != n_shards:
            raise ValueError(
                f"saved index has {n_shards} shards but mesh 'docs' axis "
                f"is {mesh.shape['docs']}")
        shards = [IndexArrays.load(os.path.join(path, f"shard{i}"))
                  for i in range(n_shards)]
        config = (Configuration.from_dict(manifest["config"])
                  if manifest["config"] else None)
        return ShardedIndex.from_shards(
            shards, manifest["doc_offsets"], mesh, manifest["total_docs"],
            config, pallas_tiles=pallas_tiles, tile_csub=tile_csub)

    # ------------------------------------------------------------- search
    def _run(self, q_comps, q_vals, search_cell):
        """Copy each data slice of the batch to its cells' devices, then
        enqueue `search_cell(d, s, index, qc, qv)` -> (scores, ids) for
        every local cell, then merge each row's shards; numpy out."""
        import torch

        D, S = self.mesh.shape["data"], self.n_shards
        B_total = q_comps.shape[0]
        if B_total % D:
            raise ValueError(f"batch {B_total} does not divide the 'data' "
                             f"axis {D}")
        B = B_total // D
        q_comps = np.ascontiguousarray(q_comps, np.int32)
        q_vals = np.ascontiguousarray(q_vals, np.float32)
        cells = [(d, s, index) for d, row in enumerate(self.device_index)
                 for s, index in enumerate(row) if index is not None]
        # every copy to the devices first (a copy from pageable memory
        # waits for its stream), then every cell's program
        queries, results = {}, {}
        for d, _, index in cells:
            dev = index.device
            if (d, dev) not in queries:
                with _on(dev):
                    queries[(d, dev)] = tuple(
                        torch.from_numpy(a[d * B:(d + 1) * B]).to(dev)
                        for a in (q_comps, q_vals))
        for d, s, index in cells:
            with _on(index.device):
                sc, ids = search_cell(d, s, index,
                                      *queries[(d, index.device)])
                results[(d, s)] = (sc, _global_ids(ids, self.doc_offsets[s]))
        k = next(iter(results.values()))[0].shape[1]
        if self.mesh.spans_processes:
            results = _gather_cells(results, self.mesh, B, k)
        out_s, out_i = [], []
        for d in range(D):
            dev0 = results[(d, 0)][0].device
            ms, mi = merge_topk_across_docs(
                torch.stack([results[(d, s)][0].to(dev0) for s in range(S)]),
                torch.stack([results[(d, s)][1].to(dev0) for s in range(S)]))
            out_s.append(ms.cpu().numpy())
            out_i.append(mi.cpu().numpy())
        return np.concatenate(out_s), np.concatenate(out_i)

    def search_batch(self, q_comps: np.ndarray, q_vals: np.ndarray, params,
                     heap_factor: float = 0.7):
        """The engine route (`search/engine.py::_search_impl`) on every
        shard, merged: numpy in (padded queries), numpy out (scores f32
        [B, k], global ids int64 [B, k], -1 where no result). The batch
        must divide the "data" axis."""
        from ..search.engine import _search_impl

        layout = self.config.layout if self.config else None
        sk_dim = layout.sketch_dim if layout else 128
        sk_seed = layout.sketch_seed if layout else 42
        hf = float(np.float32(heap_factor))
        return self._run(q_comps, q_vals, lambda d, s, index, qc, qv:
                         _search_impl(index, qc, qv, hf, params, sk_dim,
                                      sk_seed))

    def search_batch_grouped(self, q_comps: np.ndarray, q_vals: np.ndarray,
                             gp, query_cut: int = 10, M: int = 8,
                             plan_workers: int = 0):
        """The grouped route: one host plan per (data slice, docs shard)
        cell (each shard has its own lists), made in a thread pool of
        `plan_workers` (0: one per cell, at most `os.cpu_count()`; the C++
        planner releases the GIL), then `_grouped_impl` on each shard's
        device and the merge. Needs an index made with `pallas_tiles`."""
        from ..search.grouped import DevicePlan, _check_supported, _grouped_impl
        from ..search.planner import plan_grouped

        if self.planner_ctxs is None:
            raise ValueError(
                "grouped sharded search needs a pallas_tiles=True index "
                "(build/load/from_shards with pallas_tiles=True)")
        if gp.stop_after or gp.return_margin:
            raise ValueError("sharded grouped search returns (scores, ids): "
                             "no stop_after, no return_margin")
        D = self.mesh.shape["data"]
        if q_comps.shape[0] % D:
            raise ValueError(f"batch {q_comps.shape[0]} does not divide the "
                             f"'data' axis {D}")
        B = q_comps.shape[0] // D
        cells = [(d, s) for d, row in enumerate(self.device_index)
                 for s, index in enumerate(row) if index is not None]
        for d, s in cells:
            _check_supported(gp, self.device_index[d][s])

        def plan_cell(cell):
            d, s = cell
            return plan_grouped(q_comps[d * B:(d + 1) * B],
                                q_vals[d * B:(d + 1) * B],
                                self.planner_ctxs[s], query_cut, M=M)

        if plan_workers == 0:
            plan_workers = min(len(cells), os.cpu_count() or 1)
        if plan_workers > 1 and len(cells) > 1:
            with ThreadPoolExecutor(max_workers=plan_workers) as ex:
                plans = dict(zip(cells, ex.map(plan_cell, cells)))
        else:
            plans = {c: plan_cell(c) for c in cells}

        dplans = {}
        for d, s in cells:
            dev = self.device_index[d][s].device
            with _on(dev):
                dplans[(d, s)] = DevicePlan.put(plans[(d, s)], dev)

        def search_cell(d, s, index, qc, qv):
            return _grouped_impl(index, dplans[(d, s)], qc, qv, gp)

        return self._run(q_comps, q_vals, search_cell)

    # ------------------------------------------------------------- knn
    def build_knn(self, nknn: int, batch_size: int = 256) -> None:
        """Each shard's k-NN graph by a self-search of its own documents
        on its first upload (neighbourhoods stay within a shard, as the
        per-node graphs of a document-partitioned deployment), padded to
        the shards' common rows and set on every upload of the shard."""
        import torch

        from ..search import knn as knn_mod

        n_docs = max(s.fwd_comps.shape[0] for s in self.host_shards)
        for s, shard in enumerate(self.host_shards):
            ups = {id(row[s]): row[s] for row in self.device_index
                   if row[s] is not None}
            if not ups:
                raise ValueError("build_knn needs every shard on this "
                                 "process")
            first = next(iter(ups.values()))
            with _on(first.device):
                graph = knn_mod.build_knn(shard, first, nknn,
                                          batch_size=batch_size)
            shard.knn = _pad_rows(graph, n_docs, -1)
            for index in ups.values():
                index.knn = torch.from_numpy(shard.knn).to(index.device)
