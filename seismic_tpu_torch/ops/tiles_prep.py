"""Host-side preparation of the list-aligned doc-tile layout.

NumPy helpers the grouped scorer's layout needs (counterparts of
`seismic_tpu/ops_pallas_prep.py` and `seismic_tpu/ops/pallas_tiles.py::
tile_region_starts / pallas_align_doc_tiles`): every posting list's tile
rows start at a multiple of SUB rows, so one work item of the grouped
scorer reads one contiguous `[csub*SUB, V]` block, and a zero tail of
`ll_pad` rows lets any region be read `ll_pad` rows deep. The tiles stay
u8 and the per-row scale stays a flat `[rows]` vector (the TPU layout's
int8 view and `[n_super, 8, 128]` scale blocks were Mosaic constraints).
`narrow_vocab` (a copy of `seismic_tpu/ops/pallas_tiles.py::narrow_vocab`)
derives a narrower-vocabulary index from a built one.
"""

from __future__ import annotations

import numpy as np

SUB = 128  # rows per subtile (one scorer work item when csub == 1)


def ll_pad_for(max_list_len: int, csub: int = 1) -> int:
    unit = SUB * csub
    return ((max(max_list_len, 1) + unit - 1) // unit) * unit


def tile_region_starts(arrays, csub: int = 1) -> np.ndarray:
    """Subtile (SUB-row unit) start of each list's region in the aligned
    tile layout. With csub > 1 every list's region is padded to a multiple
    of csub subtiles. Pure metadata — does NOT materialize the tiles."""
    _check_unpacked(arrays)
    list_len = arrays.list_len.astype(np.int64)
    n_tiles_per_list = np.maximum(1, -(-list_len // SUB))
    if csub > 1:
        n_tiles_per_list = csub * (-(-n_tiles_per_list // csub))
    region_start = np.zeros(len(list_len), dtype=np.int64)
    np.cumsum(n_tiles_per_list[:-1], out=region_start[1:])
    return region_start


def pallas_align_doc_tiles(arrays, ll_pad: int, csub: int = 1):
    """Re-pack `doc_tiles`/`doc_tile_scale` so every list's region starts at
    a multiple of SUB rows (csub*SUB rows when csub > 1); the tail is
    padded by `ll_pad` rows so any region can stream `ll_pad` rows without
    bounds checks.

    Returns (tiles uint8 [n_sub_total*SUB, V], scale f32 [n_sub_total*SUB],
    region_start_subtiles int32 [n_lists]). Host-side, one-off per index
    (vectorized: one fancy-index row copy)."""
    assert ll_pad % (csub * SUB) == 0
    _check_unpacked(arrays)
    list_len = arrays.list_len.astype(np.int64)
    n_tiles_per_list = np.maximum(1, -(-list_len // SUB))
    if csub > 1:
        n_tiles_per_list = csub * (-(-n_tiles_per_list // csub))
    region_start = tile_region_starts(arrays, csub)
    n_sub_body = int(n_tiles_per_list.sum())
    dst_base = region_start * SUB
    n_sub_total = n_sub_body + ll_pad // SUB
    total_rows = n_sub_total * SUB
    V = arrays.doc_tiles.shape[1]
    tiles = np.zeros((total_rows, V), dtype=np.uint8)
    scale = np.zeros(total_rows, dtype=np.float32)
    total = int(list_len.sum())
    if total:
        # flat (src, dst) row indices for every real posting row
        starts = np.zeros(len(list_len), dtype=np.int64)
        np.cumsum(list_len[:-1], out=starts[1:])
        intra = np.arange(total, dtype=np.int64) - np.repeat(starts, list_len)
        src_idx = np.repeat(
            arrays.list_post_start.astype(np.int64), list_len
        ) + intra
        dst_idx = np.repeat(dst_base, list_len) + intra
        tiles[dst_idx] = arrays.doc_tiles[src_idx]
        scale[dst_idx] = arrays.doc_tile_scale[src_idx]
    return tiles, scale, region_start.astype(np.int32)


def prepare_pallas_tiles(arrays, csub: int = 1):
    return pallas_align_doc_tiles(
        arrays, ll_pad_for(arrays.max_list_len, csub), csub
    )


def _check_unpacked(arrays):
    if getattr(arrays, "pack_bins", False):
        raise NotImplementedError(
            "bin-packed block views arrive with the block-pool lean path "
            "(ROADMAP.md, modules to port, item 2c)"
        )


def narrow_vocab(arrays, V0: int, chunk: int = 262144):
    """Derive a NARROWER-tile-vocab index from a built one without
    rebuilding (a copy of `seismic_tpu/ops/pallas_tiles.py::narrow_vocab`):
    per list, keep only the V0 most important vocab columns (by the
    vocab_rank of build/builder.py, 0 = largest summed doc value) and subset
    doc_tiles / dense_summary / list_vocab / vocab_rank to those columns.

    u8 codes and per-row scales are untouched: dropping columns never
    changes the remaining codes. Per-posting overflow arrays are kept as
    built. The row subsets run in chunks of `chunk` rows, so the only
    large new array is the narrowed tile set itself.

    Returns a new IndexArrays sharing every unaffected field."""
    import dataclasses as _dc

    from ..data.sparse import PAD_COMPONENT

    lv = np.asarray(arrays.list_vocab)
    vr = np.asarray(arrays.vocab_rank)
    n_lists, V = lv.shape
    assert V0 < V and V0 % 128 == 0, (V0, V)
    assert vr is not None and vr.shape == lv.shape
    # stable sort brings kept columns (rank < V0) first, in their
    # original (component-sorted) column order
    drop = vr >= V0
    colsel = np.argsort(drop, axis=1, kind="stable")[:, :V0]
    valid = np.take_along_axis(~drop, colsel, axis=1)
    new_lv = np.where(valid, np.take_along_axis(lv, colsel, axis=1),
                      lv.dtype.type(-1) if lv.dtype == np.int16
                      else lv.dtype.type(PAD_COMPONENT))
    new_vr = np.where(valid, np.take_along_axis(vr, colsel, axis=1),
                      np.int16(32767))

    ll = np.asarray(arrays.list_len, np.int64)
    lps = np.asarray(arrays.list_post_start, np.int64)

    def subset_rows(mat, row_list_id):
        out = np.zeros((mat.shape[0], V0), dtype=mat.dtype)
        for s in range(0, mat.shape[0], chunk):
            e = min(mat.shape[0], s + chunk)
            out[s:e] = np.take_along_axis(
                mat[s:e], colsel[row_list_id[s:e]], axis=1
            )
        return out

    new_tiles = None
    if arrays.doc_tiles is not None:
        total = int((lps + ll).max()) if len(lps) else 0
        row_list = np.zeros(arrays.doc_tiles.shape[0], np.int64)
        nz = ll > 0
        order = np.argsort(lps[nz], kind="stable")
        lid = np.repeat(np.arange(n_lists, dtype=np.int64)[nz][order],
                        ll[nz][order])
        row_list[:total] = lid
        new_tiles = subset_rows(np.asarray(arrays.doc_tiles), row_list)

    new_ds = None
    if arrays.dense_summary is not None:
        lnb = np.asarray(arrays.list_n_blocks, np.int64)
        lbs = np.asarray(arrays.list_block_start, np.int64)
        blk_list = np.zeros(arrays.dense_summary.shape[0], np.int64)
        for li in range(n_lists):
            if lnb[li]:
                blk_list[lbs[li]: lbs[li] + lnb[li]] = li
        new_ds = subset_rows(np.asarray(arrays.dense_summary), blk_list)

    cfg = arrays.config
    if cfg is not None and getattr(cfg, "layout", None) is not None:
        cfg = _dc.replace(cfg, layout=_dc.replace(
            cfg.layout, summary_vocab_cap=V0))
    return _dc.replace(
        arrays, list_vocab=new_lv, vocab_rank=new_vr,
        doc_tiles=new_tiles if new_tiles is not None else arrays.doc_tiles,
        dense_summary=new_ds if new_ds is not None else arrays.dense_summary,
        config=cfg,
    )
