"""Index construction: prune -> block -> summarize -> assemble device tiles.

The TPU-native analogue of `InvertedIndexBase::build`
(reference: src/inverted_index.rs:603-686) and `PostingList::build`
(reference: src/posting_list.rs:375-451). Differences by design:

- blocks are capped at `layout.max_block_len`; oversized k-means clusters
  are split into consecutive sub-blocks (each gets its own summary), so the
  search program can treat "evaluate a block" as one fixed-width gather;
- every block additionally gets an int8 CountSketch row so block ranking can
  run as a dense matmul (see ops/sketch.py);
- the result is one flat set of padded arrays (types.IndexArrays), not
  per-list heap objects.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

from ..config import (
    Configuration,
    EnergyPreservingSummarization,
    FixedSizeBlocking,
    FixedSizeSummarization,
    RandomKmeansBlocking,
    RandomKmeansInvertedIndexApprox,
)
from ..data.sparse import PAD_COMPONENT, CsrDataset
from ..ops.sketch import quantize_sketch_int8, sketch_csr_np
from ..types import IndexArrays
from .kmeans import kmeans_blocking
from .pruning import prune
from .summaries import block_summaries, dequantize_u8, quantize_u8

# Fixed V grid for per-list vocabulary-coverage metadata (vocab_csum):
# coverage at these candidate local-vocab widths informs narrow_vocab
# (derive a narrower tile set from a built index without rebuilding).
VOCAB_CSUM_GRID = (128, 256, 512, 1024, 2048, 4096)


def _fixed_size_blocking(n: int, block_size: int) -> np.ndarray:
    """Fixed-size block offsets. The reference lets the final block absorb
    the remainder (posting_list.rs:217-225); we also fix its degenerate
    `n < block_size` case (which produced zero blocks) to one block."""
    n_blocks = max(1, n // block_size)
    offsets = np.arange(n_blocks, dtype=np.int64) * block_size
    return np.concatenate([offsets, [n]])


def _split_blocks(
    ordered: np.ndarray, offsets: np.ndarray, max_len: int
) -> np.ndarray:
    """Split any block longer than max_len into consecutive chunks."""
    out = [0]
    for i in range(len(offsets) - 1):
        s, e = int(offsets[i]), int(offsets[i + 1])
        pos = s
        while e - pos > max_len:
            pos += max_len
            out.append(pos)
        if e > pos or (e == pos and e != out[-1]):
            out.append(e)
    return np.asarray(sorted(set(out)), dtype=np.int64)


def build_index(
    dataset: CsrDataset,
    config: Optional[Configuration] = None,
    value_dtype: str = "f32",
    store_summaries: bool = True,
    store_sketches: bool = True,
    store_doc_tiles: bool = True,
    native: bool = True,
    num_threads: int = 0,
    progress: bool = False,
) -> IndexArrays:
    """Build the full index from a CSR dataset.

    `value_dtype` in {"f32", "f16", "bf16", "u16", "u8"} selects the forward-index
    value encoding ("u8" is the DotVByte-equivalent compressed variant,
    reference: src/pylib/dotvbyte.rs).

    With `native=True` (default) the per-list pipeline runs in the C++
    build core (seismic_tpu_torch/native), threaded over lists — the counterpart
    of the reference's Rust core + rayon fan-out. It covers the default
    strategies (random-kmeans-approx / fixed-size blocking, energy /
    fixed summarization); other combinations, or a missing toolchain,
    fall back to the pure-NumPy pipeline automatically.
    """
    config = config or Configuration()
    layout = config.layout
    t0 = time.time()

    table = prune(dataset, config.pruning)
    if progress:
        lens = table.list_lengths()
        print(
            f"Distributing and pruning postings: {time.time() - t0:.1f} secs"
        )
        print(f"Number of posting lists: {table.n_lists}")
        print(f"Avg posting list length: {lens.mean():.2f}")

    if native and _native_supported(config):
        arrays = _build_native(
            dataset, config, table, value_dtype, store_summaries,
            store_sketches, store_doc_tiles, num_threads, progress,
        )
        if arrays is not None:
            return arrays
        if progress:
            print("native build core unavailable; using NumPy pipeline")

    t1 = time.time()
    n_lists = table.n_lists
    max_block_len = layout.max_block_len

    postings_parts: List[np.ndarray] = []
    block_start: List[int] = []
    block_len: List[int] = []
    list_block_start = np.zeros(n_lists, dtype=np.int32)
    list_n_blocks = np.zeros(n_lists, dtype=np.int32)
    summaries_per_block: List[Tuple[np.ndarray, np.ndarray, float, float]] = []

    pos = 0  # running position in the flat posting array
    for list_id in range(n_lists):
        doc_ids, _values = table.list_slice(list_id)
        list_block_start[list_id] = len(block_start)
        if len(doc_ids) == 0:
            list_n_blocks[list_id] = 0
            continue
        blocking = config.blocking
        if isinstance(blocking, FixedSizeBlocking):
            ordered = doc_ids.copy()
            offsets = _fixed_size_blocking(len(doc_ids), blocking.block_size)
        elif isinstance(blocking, RandomKmeansBlocking):
            ordered, offsets = kmeans_blocking(
                dataset,
                doc_ids,
                blocking.centroid_fraction,
                blocking.min_cluster_size,
                blocking.clustering_algorithm,
                seed=config.seed,
                list_id=list_id,
            )
        else:
            raise TypeError(f"unknown blocking strategy: {blocking!r}")

        offsets = _split_blocks(ordered, offsets, max_block_len)
        summaries = block_summaries(
            dataset,
            ordered,
            offsets,
            config.summarization,
            layout.rounded_summary_nnz(),
        )
        assert len(summaries) == len(offsets) - 1
        summaries_per_block.extend(summaries)

        postings_parts.append(ordered.astype(np.int32))
        for i in range(len(offsets) - 1):
            block_start.append(pos + int(offsets[i]))
            block_len.append(int(offsets[i + 1] - offsets[i]))
        list_n_blocks[list_id] = len(offsets) - 1
        pos += len(ordered)

    n_blocks = len(block_start)
    max_blocks_per_list = int(list_n_blocks.max()) if n_lists else 0
    # Pad block-indexed arrays with `max_blocks_per_list + 1` empty rows so
    # the search program can dynamic-slice [max_blocks, ...] windows starting
    # at any real list without clamping; the last row doubles as the masked
    # sentinel block.
    pad_rows = max_blocks_per_list + 1
    nbp = n_blocks + pad_rows

    postings = (
        np.concatenate(postings_parts)
        if postings_parts
        else np.zeros(0, np.int32)
    )
    postings = np.concatenate(
        [postings, np.zeros(max_block_len, dtype=np.int32)]
    )
    block_start_arr = np.zeros(nbp, dtype=np.int32)
    block_start_arr[:n_blocks] = block_start
    block_len_arr = np.zeros(nbp, dtype=np.int32)
    block_len_arr[:n_blocks] = block_len

    # --- padded summary tiles (exact path) --------------------------------
    s_pad = layout.rounded_summary_nnz()
    summary_comps = summary_codes = None
    summary_min = np.zeros(nbp, dtype=np.float32)
    summary_quant = np.zeros(nbp, dtype=np.float32)
    if store_summaries:
        summary_comps = np.full((nbp, s_pad), PAD_COMPONENT, dtype=np.int32)
        summary_codes = np.zeros((nbp, s_pad), dtype=np.uint8)
    for i, (cc, codes, mn, quant) in enumerate(summaries_per_block):
        summary_min[i] = mn
        summary_quant[i] = quant
        if store_summaries and len(cc):
            summary_comps[i, : len(cc)] = cc
            summary_codes[i, : len(cc)] = codes

    # --- per-list posting ranges (doc-tile addressing) --------------------
    list_len = np.zeros(n_lists, dtype=np.int32)
    posting_block_local = np.zeros(len(postings), dtype=np.int32)
    for list_id in range(n_lists):
        s = int(list_block_start[list_id])
        n = int(list_n_blocks[list_id])
        list_len[list_id] = int(block_len_arr[s : s + n].sum())
        for j in range(n):
            bs, bl = int(block_start_arr[s + j]), int(block_len_arr[s + j])
            posting_block_local[bs : bs + bl] = j
    list_post_start = np.zeros(n_lists, dtype=np.int32)
    if n_lists > 1:
        np.cumsum(list_len[:-1], out=list_post_start[1:])
    max_list_len = int(list_len.max()) if n_lists else 0

    # --- per-list local-vocab dense summaries + doc tiles (MXU fast path) -
    list_vocab = dense_summary = dense_scale = None
    doc_tiles = doc_tile_scale = ovf_comps = ovf_vals = None
    vocab_rank = vocab_csum = None
    if layout.summary_vocab_cap > 0:
        (
            list_vocab,
            dense_summary,
            dense_scale,
            doc_tiles,
            doc_tile_scale,
            ovf_comps,
            ovf_vals,
            vocab_rank,
            vocab_csum,
        ) = _build_dense_structures(
            dataset,
            summaries_per_block,
            postings,
            list_post_start,
            list_len,
            list_block_start,
            list_n_blocks,
            nbp,
            layout.summary_vocab_cap,
            max_list_len,
            store_doc_tiles=store_doc_tiles,
            overflow=layout.tile_overflow,
        )

    # --- block sketches (experimental ranking mode) -----------------------
    block_sketch = block_sketch_scale = None
    if store_sketches and layout.sketch_dim > 0:
        flat_comps, flat_vals, offs = _summary_csr(summaries_per_block)
        sk = sketch_csr_np(
            offs, flat_comps, flat_vals, layout.sketch_dim, layout.sketch_seed
        )
        sk = np.concatenate(
            [sk, np.zeros((pad_rows, layout.sketch_dim), np.float32)], axis=0
        )
        block_sketch, block_sketch_scale = quantize_sketch_int8(sk)

    if progress:
        print(f"Building summaries: {time.time() - t1:.1f} secs")

    # --- forward index tiles ---------------------------------------------
    max_nnz = int(dataset.row_lengths().max()) if len(dataset) else 1
    if layout.max_doc_nnz > 0:
        width = layout.rounded_doc_nnz()
    else:
        width = max(layout.lane, _round_up(max_nnz, layout.lane))
    fwd_comps, fwd_vals_f32 = dataset.padded_tiles(width)
    fwd_vals, fwd_val_min, fwd_val_step = _encode_values(
        fwd_vals_f32, fwd_comps, value_dtype
    )

    list_vocab2, ovf_comps2 = _shrink_comp_arrays(
        list_vocab, ovf_comps, dataset.dim
    )

    # --- doc sketches -------------------------------------------------------
    doc_sketch = doc_sketch_scale = None
    if store_sketches and layout.sketch_dim > 0:
        dsk = sketch_csr_np(
            dataset.offsets,
            dataset.components,
            dataset.values.astype(np.float32),
            layout.sketch_dim,
            layout.sketch_seed,
        )
        doc_sketch, doc_sketch_scale = quantize_sketch_int8(dsk)

    return IndexArrays(
        fwd_comps=fwd_comps,
        fwd_vals=fwd_vals,
        fwd_val_min=fwd_val_min,
        fwd_val_step=fwd_val_step,
        postings=postings,
        block_start=block_start_arr,
        block_len=block_len_arr,
        list_block_start=list_block_start,
        list_n_blocks=list_n_blocks,
        summary_comps=summary_comps,
        summary_codes=summary_codes,
        summary_min=summary_min,
        summary_quant=summary_quant,
        list_vocab=list_vocab2,
        dense_summary=dense_summary,
        dense_scale=dense_scale,
        doc_tiles=doc_tiles,
        doc_tile_scale=doc_tile_scale,
        tile_ovf_comps=ovf_comps2,
        tile_ovf_vals=ovf_vals,
        vocab_rank=vocab_rank,
        vocab_csum=vocab_csum,
        list_post_start=list_post_start,
        list_len=list_len,
        posting_block_local=np.concatenate(
            [posting_block_local,
             np.zeros(max_list_len + 256, dtype=np.int32)]
        ),
        block_sketch=block_sketch,
        block_sketch_scale=block_sketch_scale,
        doc_sketch=doc_sketch,
        doc_sketch_scale=doc_sketch_scale,
        knn=None,
        dim=dataset.dim,
        n_docs=len(dataset),
        max_blocks_per_list=max_blocks_per_list,
        max_block_len=max_block_len,
        max_list_len=max_list_len,
        dataset_nnz=int(dataset.nnz),
        config=config,
    )


def _native_supported(config: Configuration) -> bool:
    b = config.blocking
    if isinstance(b, FixedSizeBlocking):
        blocking_ok = True
    elif isinstance(b, RandomKmeansBlocking):
        blocking_ok = isinstance(
            b.clustering_algorithm, RandomKmeansInvertedIndexApprox
        )
    else:
        blocking_ok = False
    summ_ok = isinstance(
        config.summarization,
        (EnergyPreservingSummarization, FixedSizeSummarization),
    )
    return blocking_ok and summ_ok


def _shrink_comp_arrays(list_vocab, ovf_comps, dim):
    """Store vocab/overflow component ids as int16 when the vocabulary
    fits (halves the bytes of the hottest per-query gathers). -1 is the
    no-match sentinel either way."""
    if list_vocab is not None:
        list_vocab = np.where(
            list_vocab == PAD_COMPONENT, -1, list_vocab
        )
        list_vocab = list_vocab.astype(
            np.int16 if dim < 32768 else np.int32
        )
    if ovf_comps is not None:
        ovf_comps = np.where(ovf_comps == PAD_COMPONENT, -1, ovf_comps)
        ovf_comps = ovf_comps.astype(
            np.int16 if dim < 32768 else np.int32
        )
    return list_vocab, ovf_comps


def _build_native(
    dataset: CsrDataset,
    config: Configuration,
    table,
    value_dtype: str,
    store_summaries: bool,
    store_sketches: bool,
    store_doc_tiles: bool,
    num_threads: int,
    progress: bool,
):
    """Run the per-list pipeline in the C++ core and assemble IndexArrays."""
    from ..native import native_build_lists

    layout = config.layout
    b = config.blocking
    s = config.summarization
    t1 = time.time()
    res = native_build_lists(
        dataset.offsets,
        dataset.components,
        dataset.values.astype(np.float32),
        dataset.dim,
        table.offsets,
        table.doc_ids,
        centroid_fraction=(
            b.centroid_fraction if isinstance(b, RandomKmeansBlocking) else 0.1
        ),
        min_cluster_size=(
            b.min_cluster_size if isinstance(b, RandomKmeansBlocking) else 2
        ),
        doc_cut=(
            b.clustering_algorithm.doc_cut
            if isinstance(b, RandomKmeansBlocking)
            else 15
        ),
        max_block_len=layout.max_block_len,
        summary_energy=(
            s.summary_energy
            if isinstance(s, EnergyPreservingSummarization)
            else 0.0
        ),
        n_summary_components=(
            s.n_components if isinstance(s, FixedSizeSummarization) else -1
        ),
        max_summary_nnz=layout.rounded_summary_nnz(),
        v_cap=layout.summary_vocab_cap if layout.summary_vocab_cap > 0 else 1,
        seed=config.seed,
        fixed_block_size=(
            b.block_size if isinstance(b, FixedSizeBlocking) else 0
        ),
        build_tiles=store_doc_tiles and layout.summary_vocab_cap > 0,
        overflow=layout.tile_overflow,
        n_threads=num_threads,
    )
    if res is None:
        return None
    if progress:
        print(f"Building summaries (native): {time.time() - t1:.1f} secs")

    n_lists = table.n_lists
    max_block_len = layout.max_block_len
    n_blocks = len(res["block_len"])
    list_n_blocks = res["list_n_blocks"]
    max_blocks_per_list = int(list_n_blocks.max()) if n_lists else 0
    pad_rows = max_blocks_per_list + 1
    nbp = n_blocks + pad_rows
    list_len = res["list_len"]
    max_list_len = int(list_len.max()) if n_lists else 0

    list_block_start = np.zeros(n_lists, dtype=np.int32)
    np.cumsum(list_n_blocks[:-1], out=list_block_start[1:])
    list_post_start = np.zeros(n_lists, dtype=np.int32)
    np.cumsum(list_len[:-1], out=list_post_start[1:])

    block_start_arr = np.zeros(nbp, dtype=np.int32)
    block_len_arr = np.zeros(nbp, dtype=np.int32)
    block_len_arr[:n_blocks] = res["block_len"]
    np.cumsum(res["block_len"][:-1], out=block_start_arr[1:n_blocks])

    postings = np.concatenate(
        [res["postings"], np.zeros(max_block_len, dtype=np.int32)]
    )
    posting_block_local = np.concatenate(
        [
            res["posting_block_local"],
            np.zeros(max_block_len + max_list_len + 256, dtype=np.int32),
        ]
    )

    # padded summary tiles
    s_pad = layout.rounded_summary_nnz()
    summary_comps = summary_codes = None
    summary_min = np.zeros(nbp, dtype=np.float32)
    summary_quant = np.zeros(nbp, dtype=np.float32)
    summary_min[:n_blocks] = res["summary_min"]
    summary_quant[:n_blocks] = res["summary_quant"]
    if store_summaries:
        summary_comps = np.full((nbp, s_pad), PAD_COMPONENT, dtype=np.int32)
        summary_codes = np.zeros((nbp, s_pad), dtype=np.uint8)
        slen = res["summary_len"]
        soff = np.zeros(n_blocks + 1, dtype=np.int64)
        np.cumsum(slen, out=soff[1:])
        # vectorized ragged scatter into the padded tiles
        rows = np.repeat(np.arange(n_blocks, dtype=np.int64), slen)
        cols = np.arange(int(soff[-1]), dtype=np.int64) - np.repeat(
            soff[:-1], slen
        )
        summary_comps[rows, cols] = res["summary_comps"]
        summary_codes[rows, cols] = res["summary_codes"]

    # dense structures
    dense_summary = np.zeros((nbp, res["dense_summary"].shape[1]), np.uint8)
    dense_summary[:n_blocks] = res["dense_summary"]
    dense_scale = np.zeros(nbp, dtype=np.float32)
    dense_scale[:n_blocks] = res["dense_scale"]
    v_cap = res["list_vocab"].shape[1]
    doc_tiles = doc_tile_scale = ovf_comps = ovf_vals = None
    if store_doc_tiles and len(res["doc_tiles"]):
        pad = max_block_len + max_list_len
        doc_tiles = np.concatenate(
            [res["doc_tiles"], np.zeros((pad, v_cap), np.uint8)]
        )
        doc_tile_scale = np.concatenate(
            [res["doc_tile_scale"], np.zeros(pad, np.float32)]
        )
        if layout.tile_overflow > 0:
            o = layout.tile_overflow
            ovf_comps = np.concatenate(
                [res["ovf_comps"],
                 np.full((pad, o), PAD_COMPONENT, np.int32)]
            )
            ovf_vals = np.concatenate(
                [res["ovf_vals"], np.zeros((pad, o), np.float16)]
            )

    # forward tiles / sketches (shared with the NumPy path)
    max_nnz = int(dataset.row_lengths().max()) if len(dataset) else 1
    if layout.max_doc_nnz > 0:
        width = layout.rounded_doc_nnz()
    else:
        width = max(layout.lane, _round_up(max_nnz, layout.lane))
    fwd_comps, fwd_vals_f32 = dataset.padded_tiles(width)
    fwd_vals, fwd_val_min, fwd_val_step = _encode_values(
        fwd_vals_f32, fwd_comps, value_dtype
    )
    doc_sketch = doc_sketch_scale = None
    block_sketch = block_sketch_scale = None
    if store_sketches and layout.sketch_dim > 0:
        dsk = sketch_csr_np(
            dataset.offsets,
            dataset.components,
            dataset.values.astype(np.float32),
            layout.sketch_dim,
            layout.sketch_seed,
        )
        doc_sketch, doc_sketch_scale = quantize_sketch_int8(dsk)

    list_vocab_s, ovf_comps_s = _shrink_comp_arrays(
        res["list_vocab"], ovf_comps, dataset.dim
    )
    return IndexArrays(
        fwd_comps=fwd_comps,
        fwd_vals=fwd_vals,
        fwd_val_min=fwd_val_min,
        fwd_val_step=fwd_val_step,
        postings=postings,
        block_start=block_start_arr,
        block_len=block_len_arr,
        list_block_start=list_block_start,
        list_n_blocks=list_n_blocks,
        summary_comps=summary_comps,
        summary_codes=summary_codes,
        summary_min=summary_min,
        summary_quant=summary_quant,
        list_vocab=list_vocab_s,
        dense_summary=dense_summary,
        dense_scale=dense_scale,
        doc_tiles=doc_tiles,
        doc_tile_scale=doc_tile_scale,
        tile_ovf_comps=ovf_comps_s,
        tile_ovf_vals=ovf_vals,
        vocab_rank=res.get("vocab_rank"),
        vocab_csum=res.get("vocab_csum"),
        list_post_start=list_post_start,
        list_len=list_len,
        posting_block_local=posting_block_local,
        block_sketch=block_sketch,
        block_sketch_scale=block_sketch_scale,
        doc_sketch=doc_sketch,
        doc_sketch_scale=doc_sketch_scale,
        knn=None,
        dim=dataset.dim,
        n_docs=len(dataset),
        max_blocks_per_list=max_blocks_per_list,
        max_block_len=max_block_len,
        max_list_len=max_list_len,
        dataset_nnz=int(dataset.nnz),
        config=config,
    )


def _quantize_rows_u8(rows: np.ndarray):
    """Per-row u8 quantization with zero preserved exactly:
    dequant = code * scale, scale = rowmax / 255."""
    mx = rows.max(axis=1)
    scale = np.where(mx > 0, mx / 255.0, 1.0).astype(np.float32)
    codes = np.clip(np.rint(rows / scale[:, None]), 0, 255).astype(np.uint8)
    scale = np.where(mx > 0, scale, 0.0).astype(np.float32)
    return codes, scale


def _build_dense_structures(
    dataset: CsrDataset,
    summaries_per_block,
    postings: np.ndarray,
    list_post_start: np.ndarray,
    list_len: np.ndarray,
    list_block_start: np.ndarray,
    list_n_blocks: np.ndarray,
    nbp: int,
    v_cap: int,
    max_list_len: int,
    store_doc_tiles: bool = True,
    overflow: int = 0,
):
    """Per-list local-vocab dense structures for the MXU fast paths.

    For each list: the local vocabulary is the top-`v_cap` components of the
    component-wise max over the list's documents. Two dense u8 matrices are
    built over it:

    - `dense_summary` [n_blocks_pad, V]: one row per block summary
      (block ranking = [MB, V] @ [V] matmul);
    - `doc_tiles` [total_postings_pad, V]: one row per posting occurrence,
      stored in posting order so a whole list (or block) of candidate
      documents is one contiguous dynamic slice (doc scoring =
      [L, V] @ [V] matmul). This replicates document values per occurrence
      deliberately: contiguous streaming beats random row gathers on TPU.

    Rows are u8-quantized per row with dequant = code * scale.
    """
    from .kmeans import _doc_entries

    n_lists = len(list_post_start)
    list_vocab = np.full((n_lists, v_cap), PAD_COMPONENT, dtype=np.int32)
    dense_summary = np.zeros((nbp, v_cap), dtype=np.uint8)
    dense_scale = np.zeros(nbp, dtype=np.float32)
    doc_tiles = doc_tile_scale = None
    ovf_comps = ovf_vals = None
    # local-vocab importance metadata: vocab_rank[l, j] = importance
    # rank (0 = highest summed doc value) of list_vocab[l, j];
    # vocab_csum[l, i] = fraction of the list's total term mass covered
    # by its top-VOCAB_CSUM_GRID[i] terms. Both tiny; always emitted so
    # narrow_vocab can derive narrower tile sets without a rebuild.
    vocab_rank = np.full((n_lists, v_cap), np.int16(32767), dtype=np.int16)
    vocab_csum = np.zeros((n_lists, len(VOCAB_CSUM_GRID)), dtype=np.float32)
    if store_doc_tiles:
        n_post_pad = len(postings) + max_list_len
        doc_tiles = np.zeros((n_post_pad, v_cap), dtype=np.uint8)
        doc_tile_scale = np.zeros(n_post_pad, dtype=np.float32)
        if overflow > 0:
            ovf_comps = np.full(
                (n_post_pad, overflow), PAD_COMPONENT, dtype=np.int32
            )
            ovf_vals = np.zeros((n_post_pad, overflow), dtype=np.float16)

    for list_id in range(n_lists):
        ln = int(list_len[list_id])
        if ln == 0:
            continue
        ps = int(list_post_start[list_id])
        doc_ids = postings[ps : ps + ln].astype(np.int64)
        local, comps, vals = _doc_entries(dataset, doc_ids)

        # ---- local vocab: top-v_cap by summed doc value (components
        # shared by many of the list's docs rank first; on topically
        # clustered data this covers far more of the dot mass than max) ----
        order = np.argsort(comps, kind="stable")
        c_s, v_s = comps[order], vals[order]
        first = np.ones(len(c_s), dtype=bool)
        first[1:] = c_s[1:] != c_s[:-1]
        uniq_c = c_s[first]
        group = np.cumsum(first) - 1
        sums = np.bincount(group, weights=v_s.astype(np.float64))
        if len(uniq_c) > v_cap:
            top = np.argpartition(-sums, v_cap)[:v_cap]
            kept_u = uniq_c[top]
            kept_sums = sums[top]
        else:
            kept_u = uniq_c
            kept_sums = sums
        sort_pos = np.argsort(kept_u)
        kept = kept_u[sort_pos]
        list_vocab[list_id, : len(kept)] = kept
        # narrowing metadata: importance rank per kept column + coverage of
        # the list's total term mass at the fixed V grid
        imp_order = np.argsort(-kept_sums[sort_pos], kind="stable")
        rank = np.empty(len(kept), dtype=np.int16)
        rank[imp_order] = np.arange(len(kept), dtype=np.int16)
        vocab_rank[list_id, : len(kept)] = rank
        total_mass = float(sums.sum())
        if total_mass > 0:
            desc = np.sort(sums)[::-1]
            cum = np.cumsum(desc)
            for i, gv in enumerate(VOCAB_CSUM_GRID):
                vocab_csum[list_id, i] = float(
                    cum[min(gv, len(cum)) - 1] / total_mass
                )

        # ---- doc tiles: scatter each occurrence onto the local vocab ----
        if store_doc_tiles:
            pos = np.searchsorted(kept, comps)
            pos_c = np.minimum(pos, len(kept) - 1)
            hit = kept[pos_c] == comps
            rows = np.zeros((ln, v_cap), dtype=np.float32)
            rows[local[hit], pos_c[hit]] = vals[hit]
            codes, scale = _quantize_rows_u8(rows)
            doc_tiles[ps : ps + ln] = codes
            doc_tile_scale[ps : ps + ln] = scale
            if overflow > 0 and (~hit).any():
                # top-`overflow` out-of-vocab entries per occurrence
                ml, mc, mv = local[~hit], comps[~hit], vals[~hit]
                order = np.lexsort((-mv, ml))
                ml, mc, mv = ml[order], mc[order], mv[order]
                first = np.ones(len(ml), dtype=bool)
                first[1:] = ml[1:] != ml[:-1]
                starts = np.zeros(len(ml), dtype=np.int64)
                starts[first] = np.arange(len(ml), dtype=np.int64)[first]
                starts = np.maximum.accumulate(starts)
                rank = np.arange(len(ml), dtype=np.int64) - starts
                keep_m = rank < overflow
                ovf_comps[ps + ml[keep_m], rank[keep_m]] = mc[keep_m]
                ovf_vals[ps + ml[keep_m], rank[keep_m]] = mv[keep_m].astype(
                    np.float16
                )

        # ---- dense summary rows over the same vocab ----
        s = int(list_block_start[list_id])
        n = int(list_n_blocks[list_id])
        blocks = summaries_per_block[s : s + n]
        srows = np.zeros((n, v_cap), dtype=np.float32)
        for j, (cc, codes_j, mn, quant) in enumerate(blocks):
            svals = dequantize_u8(codes_j, mn, quant)
            p = np.searchsorted(kept, cc)
            p_c = np.minimum(p, len(kept) - 1)
            h = kept[p_c] == cc
            srows[j, p_c[h]] = svals[h]
        codes, scale = _quantize_rows_u8(srows)
        dense_summary[s : s + n] = codes
        dense_scale[s : s + n] = scale

    return (list_vocab, dense_summary, dense_scale, doc_tiles,
            doc_tile_scale, ovf_comps, ovf_vals, vocab_rank, vocab_csum)


def _summary_csr(summaries):
    """Flatten per-block summaries into CSR arrays of dequantized values."""
    comps, vals, lengths = [], [], [0]
    for cc, codes, mn, quant in summaries:
        comps.append(cc.astype(np.int32))
        vals.append(dequantize_u8(codes, mn, quant))
        lengths.append(lengths[-1] + len(cc))
    flat_comps = np.concatenate(comps) if comps else np.zeros(0, np.int32)
    flat_vals = np.concatenate(vals) if vals else np.zeros(0, np.float32)
    return flat_comps, flat_vals, np.asarray(lengths, dtype=np.int64)


def summary_block_sketches(arrays, sketch_dim: int, seed: int):
    """(block_sketch int8 [n_blocks_pad, sketch_dim], block_sketch_scale
    f32) from the index's own u8 CSR block summaries: what the NumPy build
    path computes (`_summary_csr` of the dequantized summaries, sketched,
    then quantized; the padding rows zero), for an index whose build kept
    no block sketches (the native core keeps none)."""
    comps = np.asarray(arrays.summary_comps)
    mask = comps != PAD_COMPONENT
    vals = (np.asarray(arrays.summary_codes).astype(np.float32)
            * np.asarray(arrays.summary_quant, np.float32)[:, None]
            + np.asarray(arrays.summary_min, np.float32)[:, None])
    offs = np.concatenate([[0], np.cumsum(mask.sum(axis=1))]).astype(
        np.int64)
    sk = sketch_csr_np(offs, comps[mask], vals[mask], sketch_dim, seed)
    return quantize_sketch_int8(sk)


def _encode_values(vals_f32: np.ndarray, comps: np.ndarray, value_dtype: str):
    """Encode forward-index values in the requested storage dtype."""
    if value_dtype == "f32":
        return vals_f32, None, None
    if value_dtype == "f16":
        return vals_f32.astype(np.float16), None, None
    if value_dtype == "bf16":
        import ml_dtypes

        return vals_f32.astype(ml_dtypes.bfloat16), None, None
    if value_dtype in ("u8", "u16"):
        # Per-document scalar quantization over the real (non-pad) entries
        # (u8: DotVByte-equivalent, reference src/pylib/dotvbyte.rs;
        # u16: the CLI's fixedu16 value type, reference
        # src/bin/build_inverted_index.rs:58-66). Vectorized over docs.
        levels = 255.0 if value_dtype == "u8" else 65535.0
        out_dt = np.uint8 if value_dtype == "u8" else np.uint16
        n, w = vals_f32.shape
        mask = comps != PAD_COMPONENT
        big = np.where(mask, vals_f32, np.inf)
        small = np.where(mask, vals_f32, -np.inf)
        has = mask.any(axis=1)
        mins = np.where(has, big.min(axis=1), 0.0).astype(np.float32)
        maxs = np.where(has, small.max(axis=1), 0.0).astype(np.float32)
        steps = ((maxs - mins) / levels).astype(np.float32)
        # degenerate all-equal rows: code 0, dequant == min (matches
        # quantize_u8 / the reference's NaN-as-u8 == 0 behavior)
        safe_step = np.where(steps > 0.0, steps, 1.0)
        codes = np.rint((vals_f32 - mins[:, None]) / safe_step[:, None])
        codes = np.clip(codes, 0, levels).astype(out_dt)
        codes = np.where(mask & (steps[:, None] > 0.0), codes, 0)
        steps = np.where(steps > 0.0, steps, 0.0)
        return codes, mins, steps
    raise ValueError(f"unknown value_dtype: {value_dtype}")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
