"""Build- and query-time configuration for the TPU-native Seismic engine.

Mirrors the capability surface of the reference configuration system
(reference: src/configurations.rs:16-129) while adding TPU-specific layout
knobs (tile widths, sketch dims, block caps) that the padded-tensor design
needs. Query-time knobs (k, query_cut, heap_factor, n_knn, first_sorted)
stay plain `search()` arguments, as in the reference.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional


# ---------------------------------------------------------------------------
# Pruning strategies (reference: src/configurations.rs:47-68)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FixedSizePruning:
    """Keep the top-`n_postings` highest-value postings of every list."""

    n_postings: int = 3500
    kind: str = field(default="fixed_size", init=False)


@dataclass(frozen=True)
class GlobalThresholdPruning:
    """Keep the globally largest `dim * n_postings` (doc, component, value)
    entries, capping each list at `n_postings * max_fraction` postings.

    This is the reference default (GlobalThreshold{3500, 1.5}).
    """

    n_postings: int = 3500
    max_fraction: float = 1.5
    kind: str = field(default="global_threshold", init=False)


@dataclass(frozen=True)
class CoiThresholdPruning:
    """Keep a per-list fraction `alpha` of postings (capped at `n_postings`).

    Declared but unreachable in the reference build (todo!() at
    src/inverted_index.rs:621-627); we implement it for completeness.
    """

    alpha: float = 0.5
    n_postings: int = 3500
    kind: str = field(default="coi_threshold", init=False)


# ---------------------------------------------------------------------------
# Clustering algorithms (reference: src/configurations.rs:107-117)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RandomKmeans:
    """Exact dot products between every doc and every centroid."""

    kind: str = field(default="random_kmeans", init=False)


@dataclass(frozen=True)
class RandomKmeansInvertedIndex:
    """Exact dots, restricted to centroids reachable through a pruned
    centroid inverted index over the doc's top `doc_cut` components."""

    pruning_factor: float = 0.1
    doc_cut: int = 15
    kind: str = field(default="random_kmeans_ii", init=False)


@dataclass(frozen=True)
class RandomKmeansInvertedIndexApprox:
    """Approximate dots accumulated through the centroid inverted index over
    the doc's top `doc_cut` components. Reference default (doc_cut=15)."""

    doc_cut: int = 15
    kind: str = field(default="random_kmeans_ii_approx", init=False)


# ---------------------------------------------------------------------------
# Blocking strategies (reference: src/configurations.rs:71-90)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FixedSizeBlocking:
    block_size: int = 10
    kind: str = field(default="fixed_size", init=False)


@dataclass(frozen=True)
class RandomKmeansBlocking:
    """Cluster each posting list into `centroid_fraction * len` blocks with
    randomized k-means; clusters of size <= min_cluster_size are dissolved
    and reassigned. Reference default (0.1 / 2 / approx)."""

    centroid_fraction: float = 0.1
    min_cluster_size: int = 2
    clustering_algorithm: object = field(
        default_factory=RandomKmeansInvertedIndexApprox
    )
    kind: str = field(default="random_kmeans", init=False)


# ---------------------------------------------------------------------------
# Summarization strategies (reference: src/configurations.rs:93-104)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FixedSizeSummarization:
    n_components: int = 128
    kind: str = field(default="fixed_size", init=False)


@dataclass(frozen=True)
class EnergyPreservingSummarization:
    """Keep the largest max-pooled components until `summary_energy` of the
    total mass is covered. Reference default (0.4)."""

    summary_energy: float = 0.4
    kind: str = field(default="energy_preserving", init=False)


@dataclass(frozen=True)
class KnnConfig:
    """Optional k-NN graph configuration (reference: configurations.rs:120-129)."""

    nknn: int = 0
    knn_path: Optional[str] = None


# ---------------------------------------------------------------------------
# TPU layout knobs (new in this build; no reference equivalent)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TpuLayout:
    """Static-shape layout parameters for the padded device tensors.

    These control padding/tiling only; they never change *which* results a
    search can return, only how much device work and memory the static
    program uses.
    """

    # Max nonzeros kept per document in the forward-index tile. Documents
    # with more nonzeros keep their largest-value components. 0 = auto
    # (cover the longest document exactly).
    max_doc_nnz: int = 0
    # Hard cap on posting-block length; larger k-means clusters are split.
    max_block_len: int = 64
    # Max nonzeros kept per block summary (after summarization strategy).
    max_summary_nnz: int = 128
    # Per-list local vocabulary width for the dense summary matrix (the MXU
    # block-ranking fast path). Lists whose summaries span more components
    # keep the top `summary_vocab_cap` by max value. 0 disables the dense
    # layout.
    summary_vocab_cap: int = 512
    # Out-of-vocab overflow entries stored per posting occurrence in the
    # doc-tile fast path (0 disables; recovers dot mass the local vocab
    # truncates).
    tile_overflow: int = 16
    # REMOVED knob (round 3): hashed collision-summed doc tiles. The
    # device grid measured recall collapse to 0.55-0.67 at bench scale
    # (docs/Roadmap.md round-3 session 2, probes r3g/l/m: CountSketch
    # collision noise swamps SPLADE dot margins), so the public routing
    # was deleted; any nonzero value fails loudly in __post_init__
    # rather than silently serving collapsed recall. The field survives
    # only so old serialized configs deserialize into a clear error.
    tile_hash_v: int = 0
    # CountSketch width for block/doc sketches (0 disables sketches).
    sketch_dim: int = 128
    # Seed for the deterministic CountSketch hash.
    sketch_seed: int = 42
    # Round tile shapes up to multiples of this (TPU lane width).
    lane: int = 128

    def __post_init__(self):
        if self.tile_hash_v:
            raise ValueError(
                "TpuLayout.tile_hash_v was removed: hashed doc tiles "
                "measured recall@10 of 0.55-0.67 at bench scale on "
                "device (round-3 probes r3g/l/m; docs/Roadmap.md) — "
                "collision noise swamps SPLADE dot margins. Use the "
                "default truncated local-vocab tiles (tile_hash_v=0) "
                "or the block-summary lean mode instead."
            )

    def rounded_doc_nnz(self) -> int:
        return _round_up(self.max_doc_nnz, self.lane)

    def rounded_summary_nnz(self) -> int:
        return _round_up(self.max_summary_nnz, self.lane)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Top-level configuration (reference: src/configurations.rs:16-43)
# ---------------------------------------------------------------------------

_KIND_REGISTRY = {
    "pruning": {
        "fixed_size": FixedSizePruning,
        "global_threshold": GlobalThresholdPruning,
        "coi_threshold": CoiThresholdPruning,
    },
    "blocking": {
        "fixed_size": FixedSizeBlocking,
        "random_kmeans": RandomKmeansBlocking,
    },
    "summarization": {
        "fixed_size": FixedSizeSummarization,
        "energy_preserving": EnergyPreservingSummarization,
    },
    "clustering": {
        "random_kmeans": RandomKmeans,
        "random_kmeans_ii": RandomKmeansInvertedIndex,
        "random_kmeans_ii_approx": RandomKmeansInvertedIndexApprox,
    },
}


@dataclass(frozen=True)
class Configuration:
    pruning: object = field(default_factory=GlobalThresholdPruning)
    blocking: object = field(default_factory=RandomKmeansBlocking)
    summarization: object = field(default_factory=EnergyPreservingSummarization)
    knn: KnnConfig = field(default_factory=KnnConfig)
    layout: TpuLayout = field(default_factory=TpuLayout)
    # Global seed controlling centroid selection; the reference pins its
    # k-means seeds (utils.rs:163,327,466) so builds are deterministic —
    # we preserve that property.
    seed: int = 1142

    # -- builder-style helpers mirroring Configuration::{pruning_strategy,...}
    def with_pruning(self, p) -> "Configuration":
        return dataclasses.replace(self, pruning=p)

    def with_blocking(self, b) -> "Configuration":
        return dataclasses.replace(self, blocking=b)

    def with_summarization(self, s) -> "Configuration":
        return dataclasses.replace(self, summarization=s)

    def with_knn(self, k: KnnConfig) -> "Configuration":
        return dataclasses.replace(self, knn=k)

    def with_layout(self, l: TpuLayout) -> "Configuration":
        return dataclasses.replace(self, layout=l)

    # -- serialization (embedded in saved indexes, like the serde config) --
    def to_dict(self) -> dict:
        def enc(obj):
            d = dataclasses.asdict(obj)
            return d

        return {
            "pruning": enc(self.pruning),
            "blocking": enc(self.blocking),
            "summarization": enc(self.summarization),
            "knn": dataclasses.asdict(self.knn),
            "layout": dataclasses.asdict(self.layout),
            "seed": self.seed,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @staticmethod
    def from_dict(d: dict) -> "Configuration":
        def dec(section: str, dd: dict):
            dd = dict(dd)
            kind = dd.pop("kind")
            cls = _KIND_REGISTRY[section][kind]
            if "clustering_algorithm" in dd:
                dd["clustering_algorithm"] = dec(
                    "clustering", dd["clustering_algorithm"]
                )
            return cls(**dd)

        return Configuration(
            pruning=dec("pruning", d["pruning"]),
            blocking=dec("blocking", d["blocking"]),
            summarization=dec("summarization", d["summarization"]),
            knn=KnnConfig(**d["knn"]),
            layout=TpuLayout(**d["layout"]),
            seed=d.get("seed", 1142),
        )

    @staticmethod
    def from_json(s: str) -> "Configuration":
        return Configuration.from_dict(json.loads(s))


def default_build_config(
    n_postings: int = 3500,
    centroid_fraction: float = 0.1,
    min_cluster_size: int = 2,
    summary_energy: float = 0.4,
    max_fraction: float = 1.5,
    doc_cut: int = 15,
    nknn: int = 0,
    knn_path: Optional[str] = None,
    layout: Optional[TpuLayout] = None,
) -> Configuration:
    """The curated kwargs subset the Python API exposes.

    Hardwires GlobalThreshold + RandomKmeans + EnergyPreserving + Approx
    clustering, exactly like the reference binding (src/pylib/mod.rs:356-369).
    """
    return Configuration(
        pruning=GlobalThresholdPruning(n_postings=n_postings, max_fraction=max_fraction),
        blocking=RandomKmeansBlocking(
            centroid_fraction=centroid_fraction,
            min_cluster_size=min_cluster_size,
            clustering_algorithm=RandomKmeansInvertedIndexApprox(doc_cut=doc_cut),
        ),
        summarization=EnergyPreservingSummarization(summary_energy=summary_energy),
        knn=KnnConfig(nknn=nknn, knn_path=knn_path),
        layout=layout if layout is not None else TpuLayout(),
    )
