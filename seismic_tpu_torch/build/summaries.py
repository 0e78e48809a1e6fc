"""Block summarization and u8 quantization.

Re-implements the reference's per-block summary construction
(reference: src/posting_list.rs:302-368) and the scalar quantizer
(reference: src/utils.rs:68-90) as vectorized NumPy group-by operations over
all blocks of a posting list at once.

A block's summary is the component-wise max over its documents
(an upper-bound-ish sketch of the block), truncated by the summarization
strategy, then 8-bit quantized with per-summary (min, quant) parameters:
``code = round((v - min) / quant)``, ``dequant = code * quant + min``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..config import EnergyPreservingSummarization, FixedSizeSummarization
from ..data.sparse import CsrDataset
from .kmeans import _doc_entries


def block_summaries(
    dataset: CsrDataset,
    ordered_doc_ids: np.ndarray,
    block_offsets: np.ndarray,
    strategy,
    max_summary_nnz: int,
) -> List[Tuple[np.ndarray, np.ndarray, float, float]]:
    """Summaries for every block of one posting list.

    Returns a list of (components int32 sorted, codes uint8, min, quant),
    one per block. `max_summary_nnz` is the TPU tile cap: summaries larger
    than it keep their largest-value components (layout knob; the strategies
    themselves match the reference semantics).
    """
    n_blocks = len(block_offsets) - 1
    if n_blocks == 0 or len(ordered_doc_ids) == 0:
        return []

    local, comps, vals = _doc_entries(dataset, ordered_doc_ids)
    block_of = (
        np.searchsorted(block_offsets, local, side="right") - 1
    ).astype(np.int64)

    # --- component-wise max within each block (posting_list.rs:310-321) ---
    order = np.lexsort((-vals, comps, block_of))
    b, c, v = block_of[order], comps[order], vals[order]
    key_change = np.ones(len(b), dtype=bool)
    key_change[1:] = (b[1:] != b[:-1]) | (c[1:] != c[:-1])
    b, c, v = b[key_change], c[key_change], v[key_change]

    # --- per-block value-descending order + exclusive prefix sums ---
    order = np.lexsort((-v, b))
    b, c, v = b[order], c[order], v[order]
    blk_counts = np.bincount(b, minlength=n_blocks)
    blk_starts = np.zeros(n_blocks, dtype=np.int64)
    if n_blocks > 1:
        np.cumsum(blk_counts[:-1], out=blk_starts[1:])
    idx = np.arange(len(b), dtype=np.int64)
    rank = idx - blk_starts[b]

    if isinstance(strategy, EnergyPreservingSummarization):
        # Keep while the exclusive prefix mass is below
        # total * summary_energy, inclusive of the crossing element
        # (take_while_inclusive, posting_list.rs:358-365).
        csum = np.cumsum(v.astype(np.float64))
        blk_csum_before = np.zeros(n_blocks, dtype=np.float64)
        ends = blk_starts + blk_counts
        blk_total = np.where(
            blk_counts > 0, csum[np.maximum(ends - 1, 0)], 0.0
        ) - np.where(blk_starts > 0, csum[blk_starts - 1], 0.0)
        excl = csum - v.astype(np.float64)
        excl -= np.where(blk_starts[b] > 0, csum[blk_starts[b] - 1], 0.0)
        until = blk_total * float(strategy.summary_energy)
        keep = excl < until[b]
    elif isinstance(strategy, FixedSizeSummarization):
        keep = rank < strategy.n_components
    else:
        raise TypeError(f"unknown summarization strategy: {strategy!r}")

    keep &= rank < max_summary_nnz
    b, c, v = b[keep], c[keep], v[keep]

    # --- emit per-block (sorted by component) + quantize ---
    order = np.lexsort((c, b))
    b, c, v = b[order], c[order], v[order]
    out: List[Tuple[np.ndarray, np.ndarray, float, float]] = []
    counts = np.bincount(b, minlength=n_blocks)
    starts = np.zeros(n_blocks, dtype=np.int64)
    if n_blocks > 1:
        np.cumsum(counts[:-1], out=starts[1:])
    for blk in range(n_blocks):
        s, e = int(starts[blk]), int(starts[blk] + counts[blk])
        cc = c[s:e].astype(np.int32)
        vv = v[s:e].astype(np.float32)
        mn, quant, codes = quantize_u8(vv)
        out.append((cc, codes, mn, quant))
    return out


def quantize_u8(values: np.ndarray) -> Tuple[float, float, np.ndarray]:
    """Uniform 8-bit scalar quantization (reference: src/utils.rs:68-90).

    quant = (max - min) / 255; code = round((v - min) / quant).
    Degenerate all-equal ranges quantize to code 0 (dequant == min), which
    matches the reference's NaN-as-u8 == 0 behavior.
    """
    if len(values) == 0:
        return 0.0, 0.0, np.zeros(0, dtype=np.uint8)
    mn = float(values.min())
    mx = float(values.max())
    quant = (mx - mn) / 255.0
    if quant <= 0.0:
        return mn, 0.0, np.zeros(len(values), dtype=np.uint8)
    codes = np.rint((values - mn) / quant)
    codes = np.clip(codes, 0, 255).astype(np.uint8)
    return mn, quant, codes


def dequantize_u8(
    codes: np.ndarray, mn: float, quant: float
) -> np.ndarray:
    return codes.astype(np.float32) * np.float32(quant) + np.float32(mn)
