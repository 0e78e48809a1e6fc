"""seismic_tpu_torch: the PyTorch / CUDA (H100) port of seismic_tpu.

A package of its own beside `seismic_tpu` (the JAX reference, which it
never imports). It serves two paths of the grouped (list-major) search:
the grouped route of `SeismicIndexRaw` (`build_from_csr` then
`batch_search` with `heap_factor <= 0`), and the JAX package's bench
headline path (`search.grouped.plan_caps` on the host, then
`search.grouped.search_grouped_derive`, with the plan derived on the
device). Its four kernels are written by hand in CUDA C++ for sm_90a
(`csrc/`), each beside its plain PyTorch version.
"""

from .api import SeismicIndexRaw
from .config import (
    Configuration,
    GlobalThresholdPruning,
    KnnConfig,
    TpuLayout,
)
from .data.sparse import PAD_COMPONENT, CsrDataset, pad_queries
from .types import IndexArrays, from_jax_arrays

__all__ = [
    "SeismicIndexRaw",
    "Configuration",
    "GlobalThresholdPruning",
    "KnnConfig",
    "TpuLayout",
    "CsrDataset",
    "PAD_COMPONENT",
    "pad_queries",
    "IndexArrays",
    "from_jax_arrays",
]
