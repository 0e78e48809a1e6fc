"""Host-side preparation of the list-aligned doc-tile layout.

NumPy helpers the grouped scorer's layout needs (counterparts of
`seismic_tpu/ops_pallas_prep.py` and `seismic_tpu/ops/pallas_tiles.py::
tile_region_starts / pallas_align_doc_tiles`): every posting list's tile
rows start at a multiple of SUB rows, so one work item of the grouped
scorer reads one contiguous `[csub*SUB, V]` block, and a zero tail of
`ll_pad` rows lets any region be read `ll_pad` rows deep. The tiles stay
u8 and the per-row scale stays a flat `[rows]` vector (the TPU layout's
int8 view and `[n_super, 8, 128]` scale blocks were Mosaic constraints).
Bin-packed views (`pack_bins`, set by `block_pool_arrays`) pack their
short lists next-fit into shared `csub*SUB`-row bins
(`packed_region_layout`), and the aligned layout then also returns each
list's row offset inside its bin. `load_or_build_aligned` caches the
aligned layout on disk beside a saved index, in the JAX package's format.
`narrow_vocab` (a copy of `seismic_tpu/ops/pallas_tiles.py::narrow_vocab`)
derives a narrower-vocabulary index from a built one; `block_pool_arrays`
and `order_block_members` (copies of the functions of those names there,
dense and hashed modes) take the blocks-as-rows view of the block-pool
lean path; `hash_retile` (a copy) replaces the doc tiles by hashed ones
(column = component mod V, collisions summed), and `hash_retile_torch`
computes the same tiles bit for bit with torch on a device;
`super_tile_summaries` bounds each super-tile of an uploaded aligned
layout for the streaming budget; `residue_layout` and
`residue_permute_arrays` (copies of the functions of those names there)
reorder every list's vocabulary into residue groups for the bucketed
projection kernel (ops/qloc_residue.py).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from dataclasses import replace as dataclasses_replace

import numpy as np

from ..data.sparse import PAD_COMPONENT

SUB = 128  # rows per subtile (one scorer work item when csub == 1)


def ll_pad_for(max_list_len: int, csub: int = 1) -> int:
    unit = SUB * csub
    return ((max(max_list_len, 1) + unit - 1) // unit) * unit


def tile_region_starts(arrays, csub: int = 1) -> np.ndarray:
    """Subtile (SUB-row unit) start of each list's region in the aligned
    tile layout. With csub > 1 every list's region is padded to a multiple
    of csub subtiles; bin-packed views take `packed_region_layout`'s
    starts. Pure metadata — does NOT materialize the tiles."""
    if arrays.pack_bins:
        return packed_region_layout(arrays.list_len, csub)[0]
    list_len = arrays.list_len.astype(np.int64)
    n_tiles_per_list = np.maximum(1, -(-list_len // SUB))
    if csub > 1:
        n_tiles_per_list = csub * (-(-n_tiles_per_list // csub))
    region_start = np.zeros(len(list_len), dtype=np.int64)
    np.cumsum(n_tiles_per_list[:-1], out=region_start[1:])
    return region_start


def packed_region_layout(list_len, csub: int = 1):
    """Bin-packed aligned layout (a copy of `seismic_tpu/ops/
    pallas_tiles.py::packed_region_layout`) for views whose lists are tiny
    next to the csub*SUB-row region grain (the block view: about a dozen
    block rows a list against 128-256-row regions).

    Lists are packed NEXT-FIT in id order into csub*SUB-row bins: a list
    that does not fit the open bin's remainder starts a new bin; a list
    longer than one bin gets an exclusive multi-super-tile region
    (row_off 0), exactly like the unpacked layout. Each list therefore
    spans rows [row_off, row_off + len) of ONE work item's window (or an
    exclusive region), and the scorer's per-pair output carries
    bin-mates' rows, which the grouped route's lower-bound masks drop.

    Returns (region_start int64 [n_lists] in SUBTILE units, csub-aligned;
    row_off int32 [n_lists] rows within the region; n_sub_total subtiles
    in the packed body)."""
    ll = np.asarray(list_len, np.int64)
    n = len(ll)
    cap = csub * SUB
    region_start = np.zeros(n, np.int64)
    row_off = np.zeros(n, np.int32)
    cur_bin = 0  # super-tile index of the open bin
    cur_fill = cap  # rows used in the open bin (cap => none open)
    next_sup = 0  # next free super-tile index
    for li in range(n):
        ln = int(ll[li])
        if ln == 0:
            continue  # empty list: region 0 / row_off 0, never planned
        if ln > cap:
            # exclusive region (multi super-tile), standard alignment
            nsup = -(-(-(-ln // SUB)) // csub)
            region_start[li] = next_sup * csub
            next_sup += nsup
            cur_fill = cap  # bins never straddle an exclusive region
            continue
        if ln > cap - cur_fill:
            cur_bin = next_sup
            next_sup += 1
            cur_fill = 0
        region_start[li] = cur_bin * csub
        row_off[li] = cur_fill
        cur_fill += ln
    return region_start, row_off, next_sup * csub


def pallas_align_doc_tiles(arrays, ll_pad: int, csub: int = 1):
    """Re-pack `doc_tiles`/`doc_tile_scale` so every list's region starts at
    a multiple of SUB rows (csub*SUB rows when csub > 1); the tail is
    padded by `ll_pad` rows so any region can stream `ll_pad` rows without
    bounds checks.

    Returns (tiles uint8 [n_sub_total*SUB, V], scale f32 [n_sub_total*SUB],
    region_start_subtiles int32 [n_lists], row_off int32 [n_lists] or
    None). row_off is set only for bin-packed views (`pack_bins`,
    `packed_region_layout`): each list's rows then start at
    region_start*SUB + row_off. Host-side, one-off per index (vectorized:
    one fancy-index row copy)."""
    assert ll_pad % (csub * SUB) == 0
    list_len = arrays.list_len.astype(np.int64)
    row_off = None
    if arrays.pack_bins:
        region_start, row_off, n_sub_body = packed_region_layout(
            list_len, csub)
        dst_base = region_start * SUB + row_off
    else:
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
    return (tiles, scale, region_start.astype(np.int32),
            None if row_off is None else row_off.astype(np.int32))


def prepare_pallas_tiles(arrays, csub: int = 1):
    return pallas_align_doc_tiles(
        arrays, ll_pad_for(arrays.max_list_len, csub), csub
    )


def _dir_fingerprint(index_dir: str) -> int:
    """Newest mtime (in microseconds) over the files of an index saved as a
    directory (`IndexArrays.save_dir`): a rewrite of any file moves it,
    where the directory's own mtime moves only when an entry is added or
    removed."""
    return int(max(
        os.path.getmtime(os.path.join(index_dir, f))
        for f in os.listdir(index_dir)
    ) * 1e6)


# the aligned-tile cache's array files, in the order of the tuple
_CACHE_FILES = ("tiles.npy", "scale3d.npy", "region_start.npy",
                "row_off.npy")


def load_or_build_aligned(arrays, index_dir: str, csub: int = 1):
    """`prepare_pallas_tiles`, cached on disk next to the index directory
    (the counterpart of `seismic_tpu/ops_pallas_prep.py::
    load_or_build_aligned`, in its on-disk format, so either package
    reads the other's cache).

    The cache is the directory `<index>.aligned_c{csub}.dir` beside
    `index_dir` (a trailing `.dir` is dropped first): `tiles.npy` (the
    aligned tiles as int8, JAX's view of the u8 bytes), `scale3d.npy`
    (each row's scale in JAX's [n_super, 8, csub*128] blocks: the flat
    `tile_scale` repeated 8 times), `region_start.npy`, `row_off.npy` for
    bin-packed views, and `meta.json`, whose key is the source
    directory's newest mtime, csub, the tile pool's rows and V, and
    `pack_bins`: a rebuilt or rewritten index misses.

    A hit memory-maps the files and returns (tiles u8 [rows, V], the
    flat tile_scale f32 [rows], region_start int32, row_off int32 or
    None), the tuple `IndexArrays.to_device(aligned=...)` uploads; a miss
    builds the layout, writes it and returns the built arrays. The write
    goes to a temporary directory beside the cache, and each file is then
    renamed into place, `meta.json` last (and an old `meta.json` removed
    first): a reader never maps a half-written file, and a write cut off
    midway leaves no `meta.json` that would match."""
    d = index_dir.rstrip("/")
    if d.endswith(".dir"):
        d = d[:-4]
    d += f".aligned_c{csub}.dir"
    meta_p = os.path.join(d, "meta.json")
    fp = {
        "src_fp": _dir_fingerprint(index_dir),
        "csub": int(csub),
        "rows": int(arrays.doc_tiles.shape[0]),
        "v": int(arrays.doc_tiles.shape[1]),
        "pack_bins": bool(arrays.pack_bins),
    }
    names = _CACHE_FILES
    if os.path.exists(meta_p):
        with open(meta_p) as f:
            meta = json.load(f)
        if meta.get("fp") == fp:
            tiles = np.load(os.path.join(d, names[0]), mmap_mode="r")
            scale3d = np.load(os.path.join(d, names[1]), mmap_mode="r")
            region_start = np.load(os.path.join(d, names[2]))
            ro_p = os.path.join(d, names[3])
            row_off = np.load(ro_p) if os.path.exists(ro_p) else None
            return (tiles.view(np.uint8), scale3d[:, 0, :].reshape(-1),
                    region_start, row_off)
    tiles, scale, region_start, row_off = prepare_pallas_tiles(arrays, csub)
    lanes = csub * SUB
    scale3d = np.repeat(scale.reshape(-1, 1, lanes), 8, axis=1)
    parent = os.path.dirname(os.path.abspath(d))
    os.makedirs(d, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=os.path.basename(d) + ".tmp", dir=parent)
    try:
        for name, a in zip(names, (tiles.view(np.int8), scale3d,
                                   region_start, row_off)):
            if a is not None:
                np.save(os.path.join(tmp, name), a)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"fp": fp}, f)
        if os.path.exists(meta_p):
            os.remove(meta_p)
        for name in names:
            src = os.path.join(tmp, name)
            if os.path.exists(src):
                os.replace(src, os.path.join(d, name))
            elif os.path.exists(os.path.join(d, name)):
                os.remove(os.path.join(d, name))
        os.replace(os.path.join(tmp, "meta.json"), meta_p)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return tiles, scale, region_start, row_off


def super_tile_summaries(tiles, tile_scale, csub: int):
    """Per-super-tile component-wise UPPER BOUNDS of an aligned layout (a
    torch copy of `seismic_tpu/ops/pallas_tiles.py::super_tile_summaries`,
    on the tensors' device): ub[s, v] = max_r code[r, v] * scale[r] over
    the super-tile's csub * 128 rows, re-quantized to u8 with a
    per-super-tile scale, rounding up. The streaming budget ranks work
    items by query . ub. Every step is one IEEE f32 operation (a product,
    a max, a true division, a ceiling), so the codes are the NumPy
    version's bit for bit on any device.

    tiles uint8 [rows, V] and tile_scale f32 [rows] with rows a multiple
    of csub * 128. Returns (codes uint8 [n_super, V], scale f32
    [n_super])."""
    import torch

    total_rows, V = tiles.shape
    lanes = csub * SUB
    n_super = total_rows // lanes
    codes = torch.zeros((n_super, V), dtype=torch.uint8, device=tiles.device)
    scales = torch.zeros(n_super, dtype=torch.float32, device=tiles.device)
    chunk = max(1, (1 << 26) // (lanes * V))  # ~64 MB f32 working set
    for s0 in range(0, n_super, chunk):
        s1 = min(s0 + chunk, n_super)
        t = (tiles[s0 * lanes: s1 * lanes].to(torch.float32)
             * tile_scale[s0 * lanes: s1 * lanes, None])
        ub = t.reshape(s1 - s0, lanes, V).amax(dim=1)  # [chunk, V]
        sc = _div255(torch.clamp(ub.amax(dim=1), min=1e-20))
        codes[s0:s1] = torch.ceil(ub / sc[:, None]).clamp(0, 255).to(
            torch.uint8)
        scales[s0:s1] = sc
    return codes, scales


def _div255(x):
    """x / 255 rounded as one IEEE f32 division, on any device: the divisor
    is a tensor because CUDA turns a division by a Python scalar into a
    product with its reciprocal, which rounds differently from NumPy's
    division."""
    import torch

    return x / torch.full_like(x, 255.0)


def _hashed_doc_values(arrays):
    """(values f32 [n_docs, W] with 0 at padding, comps [n_docs, W], the
    mask of real entries) of the forward rows, decoded as `seismic_tpu/ops/pallas_tiles.py::hash_retile` decodes
    them (u8 codes: code * step + min, one f32 product and one f32 sum)."""
    fc = np.asarray(arrays.fwd_comps)
    mask = fc != PAD_COMPONENT
    vals = np.asarray(arrays.fwd_vals).astype(np.float32)
    if arrays.fwd_val_step is not None:
        vals = (vals * np.asarray(arrays.fwd_val_step)[:, None]
                + np.asarray(arrays.fwd_val_min)[:, None])
    return np.where(mask, vals, 0.0).astype(np.float32), fc, mask


def _hash_rows(arrays):
    """(number of real posting rows, rows of the new tile array): the
    tiles keep the old row count, or (no doc tiles) room for the block
    and list tails."""
    lps = np.asarray(arrays.list_post_start, np.int64)
    ll = np.asarray(arrays.list_len, np.int64)
    total = int((lps + ll).max()) if len(lps) else 0
    if arrays.doc_tiles is not None:
        return total, arrays.doc_tiles.shape[0]
    return total, total + arrays.max_block_len + arrays.max_list_len


def hash_docs(arrays, V: int, chunk: int = 65536) -> np.ndarray:
    """f32 [n_docs, V]: each document's values summed by column comp mod
    V, in f64 (`np.bincount`), then rounded to f32 — the hashed document
    matrix of `hash_retile`."""
    vals, fc, mask = _hashed_doc_values(arrays)
    n_docs, W = fc.shape
    cols = np.where(mask, fc % V, 0).astype(np.int64)
    H = np.zeros((n_docs, V), np.float32)
    for s in range(0, n_docs, chunk):
        e = min(n_docs, s + chunk)
        r = np.repeat(np.arange(e - s, dtype=np.int64), W)
        flat = r * V + cols[s:e].reshape(-1)
        H[s:e] = np.bincount(
            flat, weights=vals[s:e].reshape(-1), minlength=(e - s) * V
        ).reshape(e - s, V)
    return H


def hash_quantize_rows(rows: np.ndarray):
    """u8 codes and f32 scale of hashed rows f32 [n, V]: scale = max(row
    max, 1e-20) / 255 (0 for an all-zero row), codes rounded half to
    even."""
    mx = rows.max(axis=1)
    sc = np.maximum(mx, 1e-20) / 255.0
    return (np.round(rows / sc[:, None]).astype(np.uint8),
            np.where(mx > 0, sc, 0.0).astype(np.float32))


def hash_retile(arrays, V: int, chunk: int = 65536):
    """Replace the per-list truncated-vocab doc tiles with HASHED tiles (a
    copy of `seismic_tpu/ops/pallas_tiles.py::hash_retile`, the plain
    reference of `hash_retile_torch`): column b of a posting row holds
    the SUM of that doc's values whose component id hashes to b (comp mod
    V), u8-quantized per row. Hashing drops no term: collisions only add
    mass (the values are non-negative), so hashed pool scores are upper
    bounds that the exact rescore corrects, and the query projection
    becomes one row per QUERY (the hash is list-independent).

    Returns a new IndexArrays with doc_tiles / doc_tile_scale replaced
    (every other field shared). Upload it with `to_device(tile_hash=V)`
    so the grouped route hashes the query instead of projecting it per
    pair."""
    assert V % 128 == 0, "hashed tile width must be lane-aligned"
    H = hash_docs(arrays, V, chunk)
    total, n_rows = _hash_rows(arrays)
    posts = np.asarray(arrays.postings)
    tiles = np.zeros((n_rows, V), np.uint8)
    scale = np.zeros(n_rows, np.float32)
    for s in range(0, total, chunk):
        e = min(total, s + chunk)
        tiles[s:e], scale[s:e] = hash_quantize_rows(H[posts[s:e]])
    return dataclasses_replace(arrays, doc_tiles=tiles, doc_tile_scale=scale)


def hash_retile_torch(arrays, V: int, device=None, chunk: int = 65536):
    """`hash_retile` computed with torch on `device` (None: the card), bit
    for bit: the values decode with the same f32 product and sum, the
    per-column sums accumulate in f64 (`index_add_`: a sum of f32 values
    whose exponents span less than 29 bits is exact in f64, so its order
    does not matter) before the f32 rounding, and the scale and the codes
    are the same f32 division and the same round half to even. Returns
    the IndexArrays `hash_retile` returns (NumPy tiles on the host)."""
    import torch

    from ..device import resolve_device

    assert V % 128 == 0, "hashed tile width must be lane-aligned"
    dev = resolve_device(device)
    vals, fc, mask = _hashed_doc_values(arrays)
    n_docs, W = fc.shape
    cols = torch.from_numpy(np.where(mask, fc % V, 0).astype(np.int64)).to(
        dev)
    vals_t = torch.from_numpy(vals).to(dev)
    H = torch.empty((n_docs, V), dtype=torch.float32, device=dev)
    for s in range(0, n_docs, chunk):
        e = min(n_docs, s + chunk)
        flat = (torch.arange(e - s, device=dev)[:, None] * V
                + cols[s:e]).reshape(-1)
        acc = torch.zeros((e - s) * V, dtype=torch.float64, device=dev)
        acc.index_add_(0, flat, vals_t[s:e].reshape(-1).to(torch.float64))
        H[s:e] = acc.reshape(e - s, V).to(torch.float32)
    del cols, vals_t
    total, n_rows = _hash_rows(arrays)
    posts = torch.from_numpy(np.asarray(arrays.postings, np.int64)).to(dev)
    tiles = torch.zeros((n_rows, V), dtype=torch.uint8, device=dev)
    scale = torch.zeros(n_rows, dtype=torch.float32, device=dev)
    for s in range(0, total, chunk):
        e = min(total, s + chunk)
        rows = H[posts[s:e]]
        mx = rows.amax(dim=1)
        sc = _div255(torch.clamp(mx, min=1e-20))
        tiles[s:e] = torch.round(rows / sc[:, None]).to(torch.uint8)
        scale[s:e] = torch.where(mx > 0, sc, 0.0)
    return dataclasses_replace(arrays, doc_tiles=tiles.cpu().numpy(),
                               doc_tile_scale=scale.cpu().numpy())


def order_block_members(arrays, chunk: int = 1 << 21):
    """Reorder the postings WITHIN each block by the member's posting value
    (the doc's forward value for the block's list term, decoded when the
    values are u8 codes), descending, stably (a copy of
    `seismic_tpu/ops/pallas_tiles.py::order_block_members`). Block geometry
    is unchanged, so a truncated expansion (block_expand < max_block_len)
    drops each block's least valuable members. Returns a new IndexArrays
    with a permuted copy of `postings`, every other field shared."""
    lps = np.asarray(arrays.list_post_start, np.int64)
    ll = np.asarray(arrays.list_len, np.int64)
    posts = np.asarray(arrays.postings)
    bs = np.asarray(arrays.block_start, np.int64)
    bl = np.asarray(arrays.block_len, np.int64)
    total = int((lps + ll).max()) if len(lps) else 0

    # list id of every packed posting row: non-empty lists are packed
    # contiguously, in ascending-start order
    nz = ll > 0
    order = np.argsort(lps[nz], kind="stable")
    lid_packed = np.repeat(
        np.arange(len(ll), dtype=np.int64)[nz][order], ll[nz][order])
    assert len(lid_packed) == total

    fc = np.asarray(arrays.fwd_comps)
    fv = np.asarray(arrays.fwd_vals)
    has_step = arrays.fwd_val_step is not None
    val = np.zeros(total, np.float32)
    for s in range(0, total, chunk):
        e = min(total, s + chunk)
        d = posts[s:e].astype(np.int64)
        m = fc[d] == lid_packed[s:e, None]
        v = np.where(m, fv[d].astype(np.float32), 0.0).max(axis=1)
        if has_step:
            v = np.where(
                m.any(axis=1),
                v * np.asarray(arrays.fwd_val_step, np.float32)[d]
                + np.asarray(arrays.fwd_val_min, np.float32)[d],
                0.0)
        val[s:e] = v

    # block id of every packed posting row: blocks are contiguous in
    # packed order and cover [0, total)
    real = bl > 0
    blk_of = np.repeat(np.arange(len(bs), dtype=np.int64)[real], bl[real])
    assert len(blk_of) == total, (len(blk_of), total)
    # stable sort by (block, -value): members move only within their block
    perm = np.lexsort((-val, blk_of))
    new_posts = posts.copy()
    new_posts[:total] = posts[perm]
    return dataclasses_replace(arrays, postings=new_posts)


def block_pool_arrays(arrays, V: int, order_members: bool = False,
                      mode: str = "dense", pack_bins: bool = False):
    """The blocks-as-rows VIEW of the index for the grouped scorer (a copy
    of `seismic_tpu/ops/pallas_tiles.py::block_pool_arrays`): block
    summary rows replace the per-posting doc tiles, and the list geometry
    counts blocks:

      doc_tiles / doc_tile_scale -> the block rows and their scales
      list_post_start            -> list_block_start
      list_len                   -> list_n_blocks
      max_list_len               -> max_blocks_per_list

    mode="dense": the rows are the builder's dense block summaries (exact
    u8 values over each list's vocabulary, width V: `narrow_vocab` first
    for a narrower V), scored through the per-pair projection. mode=
    "hash": the u8 CSR summaries decoded (min + code * quant), summed by
    column comp mod V in f64 (`np.bincount`), rounded to f32 and
    re-quantized per row (max / 255, round half to even); upload it with
    `to_device(tile_hash=V)`, which projects once per query.

    postings, block_start and block_len stay the real ones: the pool
    emits block ids and `GroupedParams.block_expand` expands them into
    member postings. `order_members` first orders each block's postings
    by value (`order_block_members`). `pack_bins` marks the view for the
    bin-packed aligned layout (`packed_region_layout`: lists of a few
    block rows share csub*128-row bins instead of padding one each); the
    grouped route then refuses the window / stride pools and the
    streaming budget on it, as the JAX package does."""
    if mode not in ("dense", "hash"):
        raise ValueError(f"block_pool_arrays: unknown mode {mode!r}")
    if order_members:
        arrays = order_block_members(arrays)
    assert V % 128 == 0
    if mode == "dense":
        assert arrays.dense_summary is not None and (
            arrays.dense_summary.shape[1] == V
        ), ("mode='dense' uses the built dense_summary; narrow_vocab() "
            "first for a narrower V", V,
            None if arrays.dense_summary is None
            else arrays.dense_summary.shape)
        return _dc_replace_block_view(
            arrays, np.asarray(arrays.dense_summary),
            np.asarray(arrays.dense_scale, np.float32), pack_bins)
    sc_comps = np.asarray(arrays.summary_comps)
    sc_codes = np.asarray(arrays.summary_codes)
    s_min = np.asarray(arrays.summary_min, np.float32)
    s_quant = np.asarray(arrays.summary_quant, np.float32)
    nbp, S = sc_comps.shape
    tiles = np.zeros((nbp, V), np.uint8)
    scale = np.zeros(nbp, np.float32)
    chunk = 262144  # blocks a bincount: a [chunk * V] f64 working set
    for s in range(0, nbp, chunk):
        e = min(nbp, s + chunk)
        cc = sc_comps[s:e]
        mask = cc != PAD_COMPONENT
        vv = np.where(mask, s_min[s:e, None]
                      + sc_codes[s:e].astype(np.float32) * s_quant[s:e, None],
                      0.0)
        cols = np.where(mask, cc % V, 0).astype(np.int64)
        r = np.repeat(np.arange(e - s, dtype=np.int64), S)
        H = np.bincount(r * V + cols.reshape(-1), weights=vv.reshape(-1),
                        minlength=(e - s) * V).reshape(e - s, V).astype(
                            np.float32)
        tiles[s:e], scale[s:e] = hash_quantize_rows(H)
    return _dc_replace_block_view(arrays, tiles, scale, pack_bins)


def _dc_replace_block_view(arrays, tiles, scale, pack_bins: bool):
    return dataclasses_replace(
        arrays,
        doc_tiles=tiles,
        doc_tile_scale=scale,
        list_post_start=np.asarray(arrays.list_block_start, np.int32),
        list_len=np.asarray(arrays.list_n_blocks, np.int32),
        max_list_len=int(arrays.max_blocks_per_list),
        pack_bins=pack_bins,
    )


def narrow_vocab(arrays, V0: int, chunk: int = 262144):
    """Derive a NARROWER-tile-vocab index from a built one without
    rebuilding (a copy of `seismic_tpu/ops/pallas_tiles.py::narrow_vocab`):
    per list, keep only the V0 most important vocab columns (by the
    vocab_rank of build/builder.py, 0 = largest summed doc value) and subset
    doc_tiles / dense_summary / list_vocab / vocab_rank to those columns.

    u8 codes and per-row scales are untouched: dropping columns never
    changes the remaining codes. Per-posting overflow arrays are kept as
    built. The row subsets run a list at a time (and in chunks of `chunk`
    rows for rows no list owns), so the only large new array is the
    narrowed tile set itself.

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

    def subset_rows(mat, starts, lens):
        """Rows [starts[l], + lens[l]) of each list l keep its colsel
        columns; every other row is read as list 0's, as JAX's row-to-list
        map leaves it. A list's rows are one contiguous block, so each
        list is one column gather (no [rows, V0] index array)."""
        out = np.empty((mat.shape[0], V0), dtype=mat.dtype)
        owned = np.zeros(mat.shape[0], bool)
        for li in np.flatnonzero(lens):
            s, e = int(starts[li]), int(starts[li] + lens[li])
            out[s:e] = mat[s:e][:, colsel[li]]
            owned[s:e] = True
        rest = np.flatnonzero(~owned)
        for c0 in range(0, len(rest), chunk):
            r = rest[c0:c0 + chunk]
            out[r] = mat[r][:, colsel[0]]
        return out

    new_tiles = None
    if arrays.doc_tiles is not None:
        new_tiles = subset_rows(np.asarray(arrays.doc_tiles), lps, ll)

    new_ds = None
    if arrays.dense_summary is not None:
        new_ds = subset_rows(np.asarray(arrays.dense_summary),
                             np.asarray(arrays.list_block_start, np.int64),
                             np.asarray(arrays.list_n_blocks, np.int64))

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


def residue_layout(V: int, R: int):
    """Static column layout of a residue-R-ordered local vocabulary:
    R groups of VRS slots (residue groups) + one SPILL region holding
    each list's per-group overflow (compared against ALL query terms in
    the kernel, so overflow costs compares, not recall). VRS is the
    largest multiple of 8 with spill >= V/8 (the TPU's sublane alignment,
    kept so that both packages lay an index out alike).
    Returns (VRS, spill)."""
    assert V % 8 == 0
    vrs = ((V - V // 8) // R) // 8 * 8
    return vrs, V - R * vrs


def _permute_list_columns(rows, starts, lens, src_of_dst):
    """Rows [n, V] whose run [starts[l], starts[l] + lens[l]) belongs to
    list l, each list's columns reordered: column j of the result is
    column src_of_dst[l, j] of the source, or 0 where that is V. One
    slice of rows a list (the lists' runs do not overlap)."""
    V = rows.shape[1]
    out = np.zeros_like(rows)
    for li in np.flatnonzero(np.asarray(lens) > 0):
        r0, r1 = int(starts[li]), int(starts[li]) + int(lens[li])
        src = src_of_dst[li]
        keep = src < V
        out[r0:r1, keep] = rows[r0:r1][:, src[keep]]
    return out


def residue_permute_arrays(arrays, R: int = 8):
    """Reorder every list's local vocabulary (and the matching doc-tile /
    dense-summary columns) into R STATIC residue groups of VRS slots plus
    a spill region (residue_layout): group r holds the list's terms with
    `term % R == r` in their original (importance) order; each group's
    overflow goes to the spill region (importance-ordered across groups),
    and only spill overflow drops terms (to the out-of-vocab path, like
    vocab-width truncation; rare: term ids are uncorrelated with
    `id % R`, so groups are near-uniform).

    The residue-bucketed projection kernel (ops/qloc_residue.py) then
    compares each residue-group slot against only the query terms of ITS
    residue, and only the spill slots against the full term list.

    Returns a shallow copy of `arrays` with new list_vocab / doc_tiles /
    dense_summary buffers and `vocab_residue = R`."""
    import dataclasses as _dc

    from ..data.sparse import PAD_COMPONENT

    lv = np.asarray(arrays.list_vocab)
    n_lists, V = lv.shape
    assert V % R == 0, (V, R)
    VRS, SPILL = residue_layout(V, R)
    valid = (lv >= 0) & (lv != PAD_COMPONENT)
    # narrow keys (R <= 1024, slots < 2V) so the stable sorts below run as
    # radix sorts; the values are those of wider ones
    key_dt = np.int16 if 2 * V < 2 ** 15 else np.int32
    res = np.where(valid, lv % R, R).astype(np.int16)
    perm_src = np.argsort(res, axis=1, kind="stable").astype(key_dt)
    rs = np.take_along_axis(res, perm_src, axis=1).astype(np.int32)
    col = np.broadcast_to(np.arange(V, dtype=key_dt), (n_lists, V))
    new_grp = np.empty((n_lists, V), bool)
    new_grp[:, 0] = True
    np.not_equal(rs[:, 1:], rs[:, :-1], out=new_grp[:, 1:])
    seg_start = np.maximum.accumulate(np.where(new_grp, col, 0), axis=1)
    rank = col - seg_start
    in_group = (rank < VRS) & (rs < R)
    spilled = (rank >= VRS) & (rs < R)
    # spill slots in importance order (perm_src = original importance col)
    spill_key = np.where(spilled, perm_src, V + col)
    spill_rank = np.empty((n_lists, V), np.int32)
    np.put_along_axis(
        spill_rank, np.argsort(spill_key, axis=1, kind="stable"),
        col, axis=1,
    )
    dst = np.where(
        in_group,
        rs * VRS + rank,
        np.where(
            spilled & (spill_rank < SPILL),
            R * VRS + spill_rank,
            V,  # dropped
        ),
    )

    # new vocab + per-list source-column map (V -> zero column)
    new_vocab = np.full((n_lists, V + 1), -1, lv.dtype)
    np.put_along_axis(
        new_vocab, dst, np.take_along_axis(lv, perm_src, axis=1), axis=1
    )
    new_vocab = new_vocab[:, :V]
    src_of_dst = np.full((n_lists, V + 1), V, np.int32)
    np.put_along_axis(src_of_dst, dst, perm_src, axis=1)
    src_of_dst = src_of_dst[:, :V]

    new_tiles = _permute_list_columns(
        np.asarray(arrays.doc_tiles), np.asarray(arrays.list_post_start),
        np.asarray(arrays.list_len), src_of_dst)
    new_dsum = arrays.dense_summary
    if new_dsum is not None:
        new_dsum = _permute_list_columns(
            np.asarray(arrays.dense_summary),
            np.asarray(arrays.list_block_start),
            np.asarray(arrays.list_n_blocks), src_of_dst)

    return _dc.replace(arrays, list_vocab=new_vocab, doc_tiles=new_tiles,
                       dense_summary=new_dsum, vocab_residue=R)
