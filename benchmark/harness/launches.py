"""The program's kernel launch counters, read as the port's own probe
protocol reads them (`seismic_tpu_torch/harness/protocol.py::
kernel_launches`): each wrapper module under `ops/` counts its launches in
a module integer. Reading them waits for nothing on the device."""

from __future__ import annotations

import importlib

# kernel -> (wrapper module under seismic_tpu_torch.ops, its counter)
COUNTERS = {
    "qloc": ("qloc", "launches"),
    "score_grouped_i8": ("grouped_scorer", "launches"),
    "rescore": ("rescore", "launches"),
    "score_grouped_i8_item": ("grouped_scorer_item", "launches"),
    "score_tiles": ("tiles_scorer", "launches"),
    "pack_epilogue": ("pack_epilogue", "launches"),
    "score_grouped_f": ("grouped_scorer_f", "launches"),
    "qloc_rowmajor": ("qloc_rowmajor", "launches"),
    "qloc_residue": ("qloc_residue", "launches"),
    "rescore_u8": ("rescore", "launches_u8"),
    "rescore_f16": ("rescore", "launches_f16"),
}


def read() -> dict:
    out = {}
    for name, (mod, attr) in COUNTERS.items():
        m = importlib.import_module(f"seismic_tpu_torch.ops.{mod}")
        out[name] = getattr(m, attr, 0)
    return out


def since(before: dict) -> dict:
    now = read()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}
