"""seismic_tpu_torch: the PyTorch / CUDA (H100) port of seismic_tpu.

A package of its own beside `seismic_tpu` (the JAX reference, which it
never imports). It serves the JAX package's API classes:
`SeismicIndex` / `SeismicIndexLV` (JSONL or tar.gz collections with
string tokens, string doc ids and stored text), `SeismicIndexRaw` /
`SeismicIndexRawLV` (CSR or `.bin` input), each with its k-NN graph
(`build_knn`, `load_knn`, `n_knn` refinement), `SeismicIndexDotVByte`
(u8 forward values, no doc tiles, the block-pool lean route; graphs by
`load_knn` only) and `SeismicDataset` / `SeismicDatasetLV` (exact
search, `search.exact`). Searches take the grouped (list-major) route
for exhaustive-list requests, the block-pool route for the DotVByte
class, and the engine path (`search.engine`) for everything else
(`heap_factor > 0`, block budgets). It also serves the JAX package's
bench headline path (`search.grouped.plan_caps` on the host, then
`search.grouped.search_grouped_derive`, with the plan derived on the
device). Its eighteen kernels (K1-K18; K5 is an epilogue compiled into
K2, K4 and K6), and K3's second form over u8 forward rows, are written by
hand in CUDA C++ for sm_90a (`csrc/`), each beside its plain PyTorch
version.
"""

from .api import (
    SeismicDataset,
    SeismicDatasetLV,
    SeismicIndex,
    SeismicIndexDotVByte,
    SeismicIndexLV,
    SeismicIndexRaw,
    SeismicIndexRawLV,
    get_seismic_string,
)
from .config import (
    Configuration,
    GlobalThresholdPruning,
    KnnConfig,
    TpuLayout,
)
from .data.sparse import PAD_COMPONENT, CsrDataset, pad_queries
from .types import IndexArrays, from_jax_arrays

__all__ = [
    "SeismicIndex",
    "SeismicIndexLV",
    "SeismicIndexRaw",
    "SeismicIndexRawLV",
    "SeismicIndexDotVByte",
    "SeismicDataset",
    "SeismicDatasetLV",
    "get_seismic_string",
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
