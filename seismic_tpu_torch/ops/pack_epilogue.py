"""Packed-index epilogue of the grouped scorers (K5).

Counterpart of `seismic_tpu/ops/pallas_grouped.py::_make_pack` and
`::_window_max` (with `::_check_pack_window`), in `csrc/pack_epilogue.cuh`:
the epilogue the three grouped scorers (K2 `grouped_scorer`, K4
`grouped_scorer_item`, K6 `grouped_scorer_f`) run on a work item's
`[M, ROWS]` score block when they are asked for packed output (the
"window" and "stride" candidate pools). For the item's row r (its first row
inside its group being col0 = work_s * ROWS):

    packed[m, r] = (bits(f32 score[m, r]) & ~mask) | (col0 + r)
    out[m, c]    = max over u < pack_window of packed[m, u * STEP + c]

with `mask = 2**idx_bits(ll_max) - 1`, `STEP = ROWS // pack_window` and a
signed int32 max. The device code has no launch of its own: it runs inside
the scorers' kernels, and each scorer counts one launch here whenever it
launches with packed output. `pack_window_plain` is the plain PyTorch
version the scorers' plain versions use.
"""

from __future__ import annotations

import torch

from .tiles_prep import SUB

# scorer launches with the packed epilogue since the count was last set to 0
launches = 0


def count_launch() -> None:
    global launches
    launches += 1


def idx_bits(ll_max: int) -> int:
    """Low bits of a packed value that hold the row index: from the group's
    row capacity `ll_max`, not from the item's rows."""
    return max(1, (ll_max - 1).bit_length())


def idx_mask(ll_max: int) -> int:
    return (1 << idx_bits(ll_max)) - 1


def check_pack_window(pack_window: int, rows: int) -> int:
    """Validate `pack_window` (0 = unpacked) against an item of `rows` rows
    and return the item's output width STEP."""
    if pack_window <= 1:
        return rows
    step = rows // pack_window
    if step * pack_window != rows or step % SUB:
        raise ValueError(
            f"pack_window {pack_window} needs csub*128 ({rows}) divisible "
            "into 128-multiple slices")
    return step


def pack_window_plain(scores, col0, ll_max: int, pack_window: int):
    """Plain PyTorch version. scores f32 [W, M, ROWS]; col0 int [W], each
    item's first row inside its group. Returns int32 [W, M, ROWS //
    pack_window]."""
    W, M, rows = scores.shape
    step = check_pack_window(pack_window, rows)
    bits = scores.contiguous().view(torch.int32)
    col = (torch.arange(rows, dtype=torch.int32, device=scores.device)
           + col0.to(torch.int32)[:, None, None])
    packed = (bits & ~idx_mask(ll_max)) | col
    return packed.reshape(W, M, rows // step, step).amax(dim=2)


def unpack(packed, ll_max: int):
    """(score f32 with the index bits cleared, row index int32) of packed
    values."""
    mask = idx_mask(ll_max)
    return (packed & ~mask).view(torch.float32), packed & mask


def slot_major_plain(vals, work_g, work_s, G_cap: int, ll_max: int,
                     pack_window: int):
    """Scatter per-item blocks `vals` f32 [W, M, ROWS] to the slot-major
    output of K2 and K6: f32 [G_cap, M, ll_max], or with `pack_window` >= 1
    the packed int32 [G_cap, M, ll_max // pack_window]. Blocks no item
    covers stay uninitialised, as the kernels leave them."""
    W, M, rows = vals.shape
    if pack_window:
        vals = pack_window_plain(vals, work_s * rows, ll_max, pack_window)
    out = torch.empty((G_cap, M, ll_max // rows, vals.shape[-1]),
                      dtype=vals.dtype, device=vals.device)
    out[work_g.long(), :, work_s.long(), :] = vals
    return out.reshape(G_cap, M, -1)
