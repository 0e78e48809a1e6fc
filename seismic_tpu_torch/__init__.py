"""seismic_tpu_torch: the PyTorch / CUDA (H100) port of seismic_tpu.

A package of its own beside `seismic_tpu` (the JAX reference, which it
never imports). It serves `SeismicIndexRaw` (`build_from_csr`, then
`search` / `batch_search`) on the grouped (list-major) route for
exhaustive-list requests and on the engine path (`search.engine`) for
everything else (`heap_factor > 0`, block budgets, kNN refinement), and
the JAX package's bench headline path (`search.grouped.plan_caps` on the
host, then `search.grouped.search_grouped_derive`, with the plan derived
on the device). Its eighteen kernels (K1-K18; K5 is an epilogue compiled
into K2, K4 and K6) are written by hand in CUDA C++ for sm_90a (`csrc/`),
each beside its plain PyTorch version.
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
