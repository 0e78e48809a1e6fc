"""Built-index forward-value dtype conversion.

Counterpart of `seismic_tpu/build/convert.py`: a built index converts
between value storage types without re-running the pruning and
clustering pipeline (the reference's `ConvertFrom`; its fixedu8 builds are
f32 builds followed by this pass). Only the forward rows' values change:
the posting structures, block summaries and doc tiles were quantized on
their own at build time and carry over. The forward rows are a padded
`[n_docs, W]` pair, so the conversion is two vectorized NumPy passes:
decode to f32, re-encode.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..data.sparse import PAD_COMPONENT
from ..types import IndexArrays

#: storage dtypes `convert_index` accepts (the reference's f32 / f16 /
#: bf16 / fixedu8 / fixedu16; the `fixed*` names are accepted too)
VALUE_DTYPES = ("f32", "f16", "bf16", "u8", "u16")
_ALIASES = {"fixedu8": "u8", "fixedu16": "u16"}


def decode_forward_values(arrays: IndexArrays) -> np.ndarray:
    """The forward rows' values as f32 [n_docs, W] (0 at padding)."""
    vals = np.asarray(arrays.fwd_vals)
    mask = arrays.fwd_comps != PAD_COMPONENT
    if arrays.fwd_val_min is not None:
        f = (vals.astype(np.float32) * arrays.fwd_val_step[:, None]
             + arrays.fwd_val_min[:, None])
        return np.where(mask, f, 0.0).astype(np.float32)
    return np.where(mask, vals.astype(np.float32), 0.0)


def convert_index(arrays: IndexArrays, value_dtype: str) -> IndexArrays:
    """A new IndexArrays with the forward values re-encoded in
    `value_dtype`; every other array is shared. The u8 / u16 targets
    recompute each document's (min, step) from the decoded values, so a
    chain of conversions carries one quantization error."""
    from .builder import _encode_values

    value_dtype = _ALIASES.get(value_dtype, value_dtype)
    if value_dtype not in VALUE_DTYPES:
        raise ValueError(
            f"unknown value_dtype {value_dtype!r}; expected one of "
            f"{VALUE_DTYPES + tuple(_ALIASES)}")
    vals, mins, steps = _encode_values(decode_forward_values(arrays),
                                       arrays.fwd_comps, value_dtype)
    return dataclasses.replace(arrays, fwd_vals=vals, fwd_val_min=mins,
                               fwd_val_step=steps)
