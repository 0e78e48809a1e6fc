"""The index representation: host (NumPy) arrays and their device tensors.

`IndexArrays` is a copy of the NumPy half of `seismic_tpu/types.py` (same
fields, same on-disk formats), so both packages read and write one index.
`IndexArrays.to_device` uploads what the search routes read as torch
tensors (`DeviceIndex`):

- the list-aligned doc tiles, u8 `[rows, V]`, with one f32 scale per row
  (the TPU layout's int8 view and 8x-replicated scale blocks were Mosaic
  constraints and are not carried over);
- the per-list local vocabularies: `vocab16`, int16 with -1 padding, up
  to dim 32766, and past it `list_vocab`, int32 with PAD_COMPONENT
  padding (the JAX `DeviceIndex`'s two fields; hashed tiles keep them
  too, for the engine's dense block ranking), each list's max posting
  value (`list_weight`, the
  weighted list cut) and, on request, per-super-tile upper bounds of the
  tiles (`super_summary`, the streaming budget);
- the forward rows read by the exact rescore, in one of three forms: the
  fused rows `fwd_fused` `[n_docs, 2W]` int32 (component ids | f32 value
  bits); with `fwd_f16=True` and dim <= 32766 the half-width fused rows
  `fwd_fused16` `[n_docs, W]` int32 (id int16 << 16 | f16 value bits, -1
  / +0.0 at padding); or, for an index with u8 / u16 codes (`fwd_val_min`
  set: the lean form), the ids (`fwd_comps16` int16 -1 padded up to dim
  32766, `fwd_comps` int32 PAD_COMPONENT padded past it), the codes
  `fwd_vals` (uint8, or the u16 codes' bits as int16: torch's uint16
  has no gather on the card) and each document's f32 `fwd_val_min` /
  `fwd_val_step` (value = code * step + min);
- the posting array and the list geometry (effective, with each list's
  row offset `list_row_off`, on bin-packed views);
- what the engine path reads on top of those, each `None` when the build
  left it out: the block geometry, the dense and the u8 CSR block
  summaries, each posting's block index within its list, the per-posting
  overflow entries, the int8 block and document sketches and the k-NN
  graph.
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .config import Configuration
from .data.sparse import PAD_COMPONENT

INDEX_SUFFIX = ".index.seismic_tpu"
KNN_SUFFIX = ".knn.seismic_tpu"

# Version for the on-disk format.
FORMAT_VERSION = 1


@dataclass
class IndexArrays:
    """Host (NumPy) mirror of the device index. `to_device()` uploads."""

    # --- forward index tiles ---
    fwd_comps: np.ndarray  # int32 [n_docs, W], PAD_COMPONENT padded, sorted
    fwd_vals: np.ndarray  # f32/f16/bf16 [n_docs, W] (or u8 codes, see scale)
    # u8 value compression (DotVByte-equivalent, SURVEY §2.3): when set,
    # true value = fwd_vals * fwd_val_step[doc] + fwd_val_min[doc].
    fwd_val_min: Optional[np.ndarray] = None  # f32 [n_docs]
    fwd_val_step: Optional[np.ndarray] = None  # f32 [n_docs]

    # --- posting lists / blocks ---
    postings: np.ndarray = None  # int32 [total_postings_pad] doc ids
    block_start: np.ndarray = None  # int32 [n_blocks_pad] into postings
    block_len: np.ndarray = None  # int32 [n_blocks_pad] (<= max_block_len)
    list_block_start: np.ndarray = None  # int32 [n_lists] into blocks
    list_n_blocks: np.ndarray = None  # int32 [n_lists]

    # --- block summaries: exact u8-quantized CSR tiles ---
    summary_comps: np.ndarray = None  # int32 [n_blocks_pad, S] PAD padded
    summary_codes: np.ndarray = None  # uint8 [n_blocks_pad, S]
    summary_min: np.ndarray = None  # f32 [n_blocks_pad]
    summary_quant: np.ndarray = None  # f32 [n_blocks_pad]

    # --- block summaries: per-list local-vocab dense u8 matrix (the MXU
    # block-ranking fast path; no reference equivalent — replaces the
    # sparse-merge of quantized_summary.rs:64-160 with a matmul) ---
    list_vocab: Optional[np.ndarray] = None  # int32 [n_lists, V] PAD padded
    dense_summary: Optional[np.ndarray] = None  # uint8 [n_blocks_pad, V]
    dense_scale: Optional[np.ndarray] = None  # f32 [n_blocks_pad]

    # --- replicated block-aligned dense doc tiles (streaming doc scorer;
    # no reference equivalent — trades memory for contiguous access so doc
    # scoring is dynamic-slice + MXU instead of random row gathers) ---
    doc_tiles: Optional[np.ndarray] = None  # uint8 [total_postings_pad, V]
    doc_tile_scale: Optional[np.ndarray] = None  # f32 [total_postings_pad]
    list_post_start: Optional[np.ndarray] = None  # int32 [n_lists]
    list_len: Optional[np.ndarray] = None  # int32 [n_lists]
    # local (within-list) block index of each posting occurrence
    posting_block_local: Optional[np.ndarray] = None  # int32 [total_postings_pad]
    # per-posting out-of-vocab overflow entries (top-O components of the doc
    # that fall outside the list vocab; recovers the dot-product mass the
    # dense tile truncates)
    tile_ovf_comps: Optional[np.ndarray] = None  # int32 [total_postings_pad, O]
    tile_ovf_vals: Optional[np.ndarray] = None  # f16 [total_postings_pad, O]
    # local-vocab importance metadata (consumed by
    # ops/pallas_tiles.py::narrow_vocab to derive narrower-width tile
    # sets without rebuilding): vocab_rank[l, j] = importance rank of
    # list_vocab[l, j] within its list (0 = largest summed doc value;
    # 32767 = PAD); vocab_csum[l, i] = coverage of the list's total term
    # mass by its top-GRID[i] terms (grid: build.builder.VOCAB_CSUM_GRID)
    vocab_rank: Optional[np.ndarray] = None  # int16 [n_lists, V]
    vocab_csum: Optional[np.ndarray] = None  # f32 [n_lists, len(grid)]

    # --- block summaries: int8 sketch (experimental ranking mode) ---
    block_sketch: Optional[np.ndarray] = None  # int8 [n_blocks_pad, ds]
    block_sketch_scale: Optional[np.ndarray] = None  # f32 [n_blocks_pad]

    # --- per-document sketches (coarse candidate scoring) ---
    doc_sketch: Optional[np.ndarray] = None  # int8 [n_docs, ds]
    doc_sketch_scale: Optional[np.ndarray] = None  # f32 [n_docs]

    # --- optional k-NN graph ---
    knn: Optional[np.ndarray] = None  # int32 [n_docs, nknn]

    # --- metadata ---
    dim: int = 0
    n_docs: int = 0
    max_blocks_per_list: int = 0
    max_block_len: int = 0
    max_list_len: int = 0
    # nnz of the SOURCE dataset (before any max_doc_nnz truncation of the
    # padded forward tiles); 0 = unknown (pre-v2 index files)
    dataset_nnz: int = 0
    # bin-pack tiny list regions in the aligned device layout
    # (ops/pallas_tiles.py::packed_region_layout) — set on block views,
    # whose ~12-row lists would otherwise pad to csub*128 rows each.
    # In-memory only (views are rebuilt from the base index, not saved).
    pack_bins: bool = False
    # > 0: list_vocab (and the doc_tiles / dense_summary columns) are in
    # the residue-R order of ops/tiles_prep.py::residue_permute_arrays.
    # In-memory only: the on-disk index stays residue-free.
    vocab_residue: int = 0
    config: Optional[Configuration] = None

    # ------------------------------------------------------------------
    @property
    def n_lists(self) -> int:
        return len(self.list_block_start)

    @property
    def nknn(self) -> int:
        return 0 if self.knn is None else self.knn.shape[1]

    def space_usage_report(self) -> dict:
        """Per-structure byte accounting, mirroring the reference SpaceUsage
        breakdown (reference: src/inverted_index.rs:102-149)."""

        def nb(a):
            return 0 if a is None else int(a.nbytes)

        forward = (
            nb(self.fwd_comps)
            + nb(self.fwd_vals)
            + nb(self.fwd_val_min)
            + nb(self.fwd_val_step)
        )
        postings = nb(self.postings) + nb(self.block_start) + nb(self.block_len)
        offsets = nb(self.list_block_start) + nb(self.list_n_blocks)
        summaries = (
            nb(self.summary_comps)
            + nb(self.summary_codes)
            + nb(self.summary_min)
            + nb(self.summary_quant)
            + nb(self.list_vocab)
            + nb(self.dense_summary)
            + nb(self.dense_scale)
            + nb(self.block_sketch)
            + nb(self.block_sketch_scale)
            + nb(self.vocab_rank)
            + nb(self.vocab_csum)
        )
        doc_tiles = (
            nb(self.doc_tiles)
            + nb(self.doc_tile_scale)
            + nb(self.list_post_start)
            + nb(self.list_len)
            + nb(self.posting_block_local)
            + nb(self.tile_ovf_comps)
            + nb(self.tile_ovf_vals)
        )
        sketches = nb(self.doc_sketch) + nb(self.doc_sketch_scale)
        knn = nb(self.knn)
        total = (
            forward + postings + offsets + summaries + sketches + knn
            + doc_tiles
        )
        return {
            "forward_index": forward,
            "packed_postings": postings,
            "block_offsets": offsets,
            "summaries": summaries,
            "doc_tiles": doc_tiles,
            "doc_sketches": sketches,
            "knn": knn,
            "total": total,
        }

    def print_space_usage_byte(self) -> int:
        rep = self.space_usage_report()
        print("Space Usage:")
        print(f"\tForward Index: {rep['forward_index']} Bytes")
        plt = rep["packed_postings"] + rep["block_offsets"] + rep["summaries"]
        print(f"\tPosting Lists: {plt} Bytes")
        print(f"\t  packed_postings: {rep['packed_postings']} Bytes")
        print(f"\t  block_offsets: {rep['block_offsets']} Bytes")
        print(f"\t  summaries: {rep['summaries']} Bytes")
        print(f"\tDoc tiles: {rep['doc_tiles']} Bytes")
        print(f"\tDoc sketches: {rep['doc_sketches']} Bytes")
        print(f"\tKnn: {rep['knn']} Bytes")
        print(f"\tTotal: {rep['total']} Bytes")
        return rep["total"]

    # ------------------------------------------------------------- save/load
    _ARRAY_FIELDS = (
        "fwd_comps",
        "fwd_vals",
        "fwd_val_min",
        "fwd_val_step",
        "postings",
        "block_start",
        "block_len",
        "list_block_start",
        "list_n_blocks",
        "summary_comps",
        "summary_codes",
        "summary_min",
        "summary_quant",
        "list_vocab",
        "dense_summary",
        "dense_scale",
        "doc_tiles",
        "doc_tile_scale",
        "list_post_start",
        "list_len",
        "posting_block_local",
        "tile_ovf_comps",
        "tile_ovf_vals",
        "vocab_rank",
        "vocab_csum",
        "block_sketch",
        "block_sketch_scale",
        "doc_sketch",
        "doc_sketch_scale",
        "knn",
    )

    def save(self, path: str) -> str:
        """Persist to `<path>.index.seismic_tpu` (npz + embedded metadata).

        Preserves the reference's "build once, query many" workflow
        (reference: IndexSerializer, src/inverted_index.rs:54-59).
        """
        if not path.endswith(INDEX_SUFFIX):
            path = path + INDEX_SUFFIX
        arrays = {}
        for f in self._ARRAY_FIELDS:
            a = getattr(self, f)
            if a is not None:
                arrays[f] = self._to_savable(a)
        arrays["__meta__"] = np.frombuffer(
            json.dumps(self._meta_dict()).encode("utf-8"), dtype=np.uint8
        )
        np.savez(path, **arrays)
        # np.savez appends .npz; normalize to the exact requested path.
        if os.path.exists(path + ".npz"):
            os.replace(path + ".npz", path)
        return path

    @staticmethod
    def _to_savable(a: np.ndarray) -> np.ndarray:
        # np.savez cannot store bfloat16; round-trip through float32.
        if a.dtype.name == "bfloat16":
            return np.asarray(a, dtype=np.float32)
        return a

    def _meta_dict(self) -> dict:
        return {
            "version": FORMAT_VERSION,
            "dim": self.dim,
            "n_docs": self.n_docs,
            "max_blocks_per_list": self.max_blocks_per_list,
            "max_block_len": self.max_block_len,
            "max_list_len": self.max_list_len,
            "dataset_nnz": self.dataset_nnz,
            "config": self.config.to_dict() if self.config else None,
        }

    @staticmethod
    def _from_meta(meta: dict, kwargs: dict) -> "IndexArrays":
        cfg = (
            Configuration.from_dict(meta["config"]) if meta["config"] else None
        )
        return IndexArrays(
            dim=meta["dim"],
            n_docs=meta["n_docs"],
            max_blocks_per_list=meta["max_blocks_per_list"],
            max_block_len=meta["max_block_len"],
            max_list_len=meta.get("max_list_len", 0),
            dataset_nnz=meta.get("dataset_nnz", 0),
            config=cfg,
            **kwargs,
        )

    def save_dir(self, path: str) -> str:
        """Persist as a DIRECTORY of raw .npy files + meta.json. Unlike the
        single-file npz (which streams through the zip layer on load),
        this form memory-maps on load — multi-GB indexes open in
        milliseconds and pages fault in on demand (the HBM upload then
        reads them once, sequentially).

        Writes into `<path>.tmp` then renames, so an interrupted save
        (watchdog/OOM kill mid-np.save) never leaves a half-written
        directory that load_dir would try to open."""
        import shutil

        tmp = path.rstrip("/") + ".tmp"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        for f in self._ARRAY_FIELDS:
            a = getattr(self, f)
            if a is not None:
                np.save(os.path.join(tmp, f + ".npy"), self._to_savable(a))
        with open(os.path.join(tmp, "meta.json"), "w") as fp:
            json.dump(self._meta_dict(), fp)
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
        return path

    @staticmethod
    def load_dir(path: str, mmap: bool = True) -> "IndexArrays":
        with open(os.path.join(path, "meta.json")) as fp:
            meta = json.load(fp)
        kwargs = {}
        for f in IndexArrays._ARRAY_FIELDS:
            p = os.path.join(path, f + ".npy")
            kwargs[f] = (
                np.load(p, mmap_mode="r" if mmap else None)
                if os.path.exists(p)
                else None
            )
        return IndexArrays._from_meta(meta, kwargs)

    @staticmethod
    def load(path: str) -> "IndexArrays":
        if os.path.isdir(path):
            return IndexArrays.load_dir(path)
        if not path.endswith(INDEX_SUFFIX) and os.path.exists(path + INDEX_SUFFIX):
            path = path + INDEX_SUFFIX
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
            kwargs = {}
            for f in IndexArrays._ARRAY_FIELDS:
                kwargs[f] = z[f] if f in z.files else None
        return IndexArrays._from_meta(meta, kwargs)

    # ------------------------------------------------------------- device
    def to_device(self, device=None, tile_csub: int = 1,
                  vocab_residue: int = 0, tile_hash: int = 0,
                  super_summaries: bool = False,
                  fwd_f16: bool = False, aligned=None) -> "DeviceIndex":
        """Upload what the search routes read to `device` (None means
        "cuda"; raises when CUDA is absent rather than falling back to the
        CPU). Builds the list-aligned tile layout on the host when the
        index has doc tiles; `tile_csub` subtiles of 128 rows make one
        work item (every list's region padded to a multiple of them), as
        in the JAX package. `vocab_residue=R` first reorders every list's
        vocabulary and tile columns into R residue groups for the bucketed
        projection kernel (upload time only). `tile_hash=V` marks tiles
        that `ops/tiles_prep.py::hash_retile` (or a hashed block view)
        made V wide: the grouped route then projects once per query
        (it keys on `tile_hash`), and the list vocabulary still goes up,
        as the JAX package keeps `list_vocab`, for the engine's dense
        block ranking. `super_summaries` adds the per-super-tile
        upper bounds of the streaming budget (`super_summary` /
        `super_scale`, computed on the device from the uploaded layout);
        refused on bin-packed views, whose bins mix lists. A bin-packed
        view (`pack_bins`) is served with its EFFECTIVE geometry, as in
        the JAX package: `list_row_off` holds each list's row offset in
        its bin, `list_len` is row_off + len and `list_post_start` is
        start - row_off, so every planner works on it unchanged.
        `fwd_f16=True` uploads the half-width fused rows (`fwd_fused16`)
        in place of `fwd_fused` where the JAX package does: values not
        in the lean form and dim <= 32766 (elsewhere it is ignored, as
        there). Past dim 32766 the vocabularies and the lean form's ids
        go up as int32 (`list_vocab`, `fwd_comps`). `aligned` is a tile
        layout made beforehand, `(tiles u8, tile_scale f32, region_start,
        row_off or None)` as `ops/tiles_prep.py::prepare_pallas_tiles`
        (or the on-disk cache, `load_or_build_aligned`) returns it, for
        this index at this `tile_csub`: it is uploaded in place of the
        layout built on the host (the JAX package's `_aligned`), and may
        hold zero rows past every list's region (the sharded path pads
        the shards' layouts to common rows). Fields the build left out
        stay `None`."""
        import torch

        from .ops.tiles_prep import (
            prepare_pallas_tiles,
            residue_permute_arrays,
            super_tile_summaries,
        )
        from .device import resolve_device

        wide = self.dim > 32766
        if vocab_residue and self.vocab_residue == 0:
            return residue_permute_arrays(self, vocab_residue).to_device(
                device, tile_csub, tile_hash=tile_hash,
                super_summaries=super_summaries, fwd_f16=fwd_f16,
                aligned=aligned)
        dev = resolve_device(device)
        if tile_csub < 1:
            raise ValueError(f"tile_csub={tile_csub} must be >= 1")
        if (self.fwd_val_min is not None and np.asarray(self.fwd_vals).dtype
                not in (np.uint8, np.uint16)):
            raise ValueError(
                f"{np.asarray(self.fwd_vals).dtype} forward codes beside "
                "fwd_val_min: the lean form holds u8 or u16 codes")
        if tile_hash and (self.doc_tiles is None
                          or self.doc_tiles.shape[1] != tile_hash):
            raise ValueError("tile_hash requires hash_retile'd doc tiles of "
                             "that width")
        if super_summaries and (self.doc_tiles is None or self.pack_bins):
            raise ValueError(
                "super_summaries=True needs doc tiles, and is unsupported on "
                "bin-packed (pack_bins) views: super-tile bounds would mix "
                "bin-mates' rows")

        def put(a, dtype=None):
            if a is None:
                return None
            a = np.ascontiguousarray(a if dtype is None else
                                     np.asarray(a, dtype=dtype))
            if not a.flags.writeable:
                # a memory-mapped cache file: copied, never shared
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", UserWarning)
                    return torch.from_numpy(a).to(dev, copy=True)
            return torch.from_numpy(a).to(dev)

        tiles_u8 = tile_scale = region_start = row_off = None
        if aligned is not None:
            tiles_u8, tile_scale, region_start = aligned[:3]
            row_off = aligned[3] if len(aligned) > 3 else None
            if (np.asarray(tiles_u8).dtype != np.uint8
                    or tiles_u8.shape[0] != tile_scale.shape[0]
                    or len(region_start) != self.n_lists):
                raise ValueError(
                    "aligned must be (tiles u8 [rows, V], tile_scale "
                    "[rows], region_start [n_lists], row_off) of this "
                    "index")
        elif self.doc_tiles is not None:
            tiles_u8, tile_scale, region_start, row_off = (
                prepare_pallas_tiles(self, tile_csub))
        vocab = {"vocab16": None}
        if self.list_vocab is not None:
            # hashed tiles too: the grouped route never reads it there,
            # the engine's dense block ranking does
            lv = np.asarray(self.list_vocab)
            if wide:
                vocab["list_vocab"] = put(lv, np.int32)
            else:
                vocab["vocab16"] = put(np.where(lv == PAD_COMPONENT, -1, lv),
                                       np.int16)
        fc = np.asarray(self.fwd_comps, dtype=np.int32)
        fwd = {}
        if self.fwd_val_min is None:
            fv = np.asarray(self.fwd_vals, dtype=np.float32)
            if fwd_f16 and not wide:
                fwd["fwd_fused16"] = put(fused16_rows(fc, fv))
            else:
                fwd["fwd_fused"] = put(
                    np.concatenate([fc, fv.view(np.int32)], axis=1))
        else:
            # the lean form (the JAX package's to_device with
            # lean_fwd=True): int16 ids up to dim 32766, int32 past it;
            # u8 codes, or the u16 codes' bits as int16; per-doc (min,
            # step)
            codes = np.asarray(self.fwd_vals)
            if wide:
                fwd["fwd_comps"] = put(fc)
            else:
                fwd["fwd_comps16"] = put(
                    np.where(fc == PAD_COMPONENT, -1, fc), np.int16)
            fwd.update(
                fwd_vals=put(codes.view(np.int16)
                             if codes.dtype == np.uint16 else codes),
                fwd_val_min=put(self.fwd_val_min, np.float32),
                fwd_val_step=put(self.fwd_val_step, np.float32))
        list_weight = None
        if (self.doc_tile_scale is not None
                and self.list_post_start is not None):
            # per-list max posting value (code 255 * row scale): the
            # weighted list cut ranks lists by value * list_weight
            list_weight = _list_weights(np.asarray(self.doc_tile_scale),
                                        np.asarray(self.list_post_start),
                                        np.asarray(self.list_len))
        ll = np.asarray(self.list_len, np.int32)
        ps = np.asarray(self.list_post_start, np.int32)
        if row_off is not None:
            ll, ps = row_off + ll, ps - row_off
        tiles_t, scale_t = put(tiles_u8), put(tile_scale)
        sup = sup_scale = None
        if super_summaries:
            sup, sup_scale = super_tile_summaries(tiles_t, scale_t,
                                                  tile_csub)
        return DeviceIndex(
            doc_tiles_aligned=tiles_t,
            tile_scale=scale_t,
            list_region_start=put(region_start, np.int32),
            **vocab,
            **fwd,
            postings=put(self.postings, np.int32),
            list_post_start=put(ps),
            list_len=put(ll),
            list_row_off=put(row_off),
            list_weight=put(list_weight),
            super_summary=sup,
            super_scale=sup_scale,
            block_start=put(self.block_start, np.int32),
            block_len=put(self.block_len, np.int32),
            list_block_start=put(self.list_block_start, np.int32),
            list_n_blocks=put(self.list_n_blocks, np.int32),
            dense_summary=put(self.dense_summary),
            dense_scale=put(self.dense_scale, np.float32),
            summary_comps=put(self.summary_comps, np.int32),
            summary_codes=put(self.summary_codes),
            summary_min=put(self.summary_min, np.float32),
            summary_quant=put(self.summary_quant, np.float32),
            posting_block_local=put(self.posting_block_local, np.int32),
            tile_ovf_comps=put(self.tile_ovf_comps),
            tile_ovf_vals=put(self.tile_ovf_vals),
            block_sketch=put(self.block_sketch),
            block_sketch_scale=put(self.block_sketch_scale, np.float32),
            doc_sketch=put(self.doc_sketch),
            doc_sketch_scale=put(self.doc_sketch_scale, np.float32),
            knn=put(self.knn, np.int32),
            dim=self.dim,
            n_docs=self.n_docs,
            max_blocks_per_list=self.max_blocks_per_list,
            max_block_len=self.max_block_len,
            max_list_len=self.max_list_len,
            tile_csub=tile_csub,
            vocab_residue=self.vocab_residue,
            tile_hash=tile_hash,
        )


@dataclass
class DeviceIndex:
    """Device tensors of the search routes (see module docstring); a
    field is `None` when the index was built without it."""

    doc_tiles_aligned: object  # uint8 [n_sub_total * 128, V]
    tile_scale: object  # f32 [n_sub_total * 128] dequant scale per row
    # int32 [n_lists] subtile start of each list (a multiple of tile_csub)
    list_region_start: object
    # int16 [n_lists, V] (-1 padded) up to dim 32766; None past it
    vocab16: object
    postings: object  # int32 [total_postings_pad] doc ids
    # int32 [n_lists]; EFFECTIVE on bin-packed views (start - row_off,
    # row_off + len)
    list_post_start: object
    list_len: object
    # int32 [n_lists] row offset of each list in its bin (bin-packed
    # views only; the grouped route masks the rows before it)
    list_row_off: object = None
    # f32 [n_lists] max posting value of each list (the weighted cut)
    list_weight: object = None
    # u8 [n_super, V] / f32 [n_super] per-super-tile upper bounds
    # (to_device(super_summaries=True), the streaming budget)
    super_summary: object = None
    super_scale: object = None
    # int32 [n_lists, V] (PAD_COMPONENT padded) past dim 32766, in place
    # of vocab16
    list_vocab: object = None
    # --- the forward rows: one form (the other fields None) ---
    fwd_fused: object = None  # int32 [n_docs, 2W]: comps | f32 value bits
    # int32 [n_docs, W]: (id int16 << 16) | f16 value bits, -1 / +0.0 pad
    fwd_fused16: object = None
    # the lean form: ids int16 [n_docs, W] (-1 padded) up to dim 32766,
    # else int32 (PAD_COMPONENT padded) in fwd_comps
    fwd_comps16: object = None
    fwd_comps: object = None
    # codes [n_docs, W]: uint8, or u16 codes held as int16 bits
    fwd_vals: object = None
    fwd_val_min: object = None  # f32 [n_docs]
    fwd_val_step: object = None  # f32 [n_docs]
    # --- read by the engine path only ---
    block_start: object = None  # int32 [n_blocks_pad] into postings
    block_len: object = None  # int32 [n_blocks_pad]
    list_block_start: object = None  # int32 [n_lists] into blocks
    list_n_blocks: object = None  # int32 [n_lists]
    dense_summary: object = None  # uint8 [n_blocks_pad, V]
    dense_scale: object = None  # f32 [n_blocks_pad]
    summary_comps: object = None  # int32 [n_blocks_pad, S] PAD padded
    summary_codes: object = None  # uint8 [n_blocks_pad, S]
    summary_min: object = None  # f32 [n_blocks_pad]
    summary_quant: object = None  # f32 [n_blocks_pad]
    posting_block_local: object = None  # int32 [total_postings_pad+]
    # int16 (-1 padded) or int32 (PAD_COMPONENT padded) [postings_pad, O]
    tile_ovf_comps: object = None
    tile_ovf_vals: object = None  # f16 [postings_pad, O]
    # int8 CountSketches (ops/sketch.py) and their f32 scales:
    # block_mode="sketch" and cand_budget > 0
    block_sketch: object = None  # int8 [n_blocks_pad, ds]
    block_sketch_scale: object = None  # f32 [n_blocks_pad]
    doc_sketch: object = None  # int8 [n_docs, ds]
    doc_sketch_scale: object = None  # f32 [n_docs]
    knn: object = None  # int32 [n_docs, nknn]
    dim: int = 0
    n_docs: int = 0
    max_blocks_per_list: int = 0
    max_block_len: int = 0
    max_list_len: int = 0
    tile_csub: int = 1
    # > 0: vocab16 and the tile columns are residue-R ordered
    vocab_residue: int = 0
    # > 0: the tiles are hashed, column = component mod tile_hash
    tile_hash: int = 0

    @property
    def device(self):
        return self.postings.device

    @property
    def vocab(self):
        """The list vocabularies in whichever width they were uploaded
        (`vocab16` or `list_vocab`), hashed tiles included."""
        return self.vocab16 if self.vocab16 is not None else self.list_vocab


    def nbytes(self) -> int:
        """Bytes of every tensor this index holds on its device."""
        return sum(
            int(t.numel() * t.element_size())
            for t in (getattr(self, f.name) for f in dataclasses.fields(self))
            if hasattr(t, "element_size")
        )


def fused16_rows(fwd_comps, fwd_vals) -> np.ndarray:
    """The JAX package's half-width fused rows (`seismic_tpu/types.py:
    417-438`) of forward rows with ids <= 32766: int32 [n_docs, W], one
    word a slot, (id int16 << 16) | the f16 bits of the value; padding
    -1 / +0.0."""
    fc = np.asarray(fwd_comps)
    comp16 = np.where(fc == PAD_COMPONENT, -1, fc).astype(np.int16)
    val16 = np.asarray(fwd_vals, dtype=np.float32).astype(np.float16)
    val16[comp16 < 0] = np.float16(0.0)
    return ((comp16.astype(np.int32) << 16)
            | val16.view(np.uint16).astype(np.int32))


def _list_weights(doc_tile_scale, list_post_start, list_len):
    """f32 [n_lists]: max posting value per list (code 255 * row scale).
    The packed tile layout stores non-empty lists contiguously, so one
    np.maximum.reduceat over their starts covers each list's rows (the
    final segment extends into the zero tail, which cannot raise a max)."""
    n_lists = len(list_post_start)
    w = np.zeros(n_lists, np.float32)
    starts = list_post_start.astype(np.int64)
    nz_idx = np.flatnonzero(list_len > 0)
    if len(nz_idx):
        red = np.maximum.reduceat(doc_tile_scale, starts[nz_idx])
        w[nz_idx] = red * 255.0
    return w


def from_jax_arrays(arrays_dict: dict) -> IndexArrays:
    """Carry an index built by the JAX package across: takes the fields of
    a `seismic_tpu` `IndexArrays` as a dict (NumPy arrays and ints, e.g.
    `{f.name: getattr(a, f.name) for f in dataclasses.fields(a)}` or
    `dataclasses.asdict(a)`) and returns this package's `IndexArrays`
    over the same arrays. The configuration may arrive as a dict or as
    an object with `to_dict()`."""
    names = {f.name for f in dataclasses.fields(IndexArrays)}
    kwargs = {k: v for k, v in arrays_dict.items() if k in names}
    cfg = kwargs.get("config")
    if cfg is not None and not isinstance(cfg, Configuration):
        kwargs["config"] = Configuration.from_dict(
            cfg if isinstance(cfg, dict) else cfg.to_dict()
        )
    for k, v in kwargs.items():
        if k != "config" and v is not None and not np.isscalar(v):
            kwargs[k] = np.asarray(v)
    return IndexArrays(**kwargs)


__all__ = [
    "IndexArrays",
    "DeviceIndex",
    "PAD_COMPONENT",
    "INDEX_SUFFIX",
    "KNN_SUFFIX",
    "from_jax_arrays",
]
