"""CLI: build and serialize an index from the seismic inner binary format.

The port of `seismic_tpu/cli/build_inverted_index.py`: the same flags and
choices, the same configuration and the same saved arrays
(`<output-file>.index.seismic_tpu`), plus `--device` for the k-NN graph's
self-search (`--knn N` without `--knn-path`; the card by default). The
build itself runs on the host (reference: src/bin/build_inverted_index.rs:
47-129 for the flag surface).

    python -m seismic_tpu_torch.cli.build_inverted_index \\
        --input-file documents.bin --output-file my_index [build knobs]
"""

from __future__ import annotations

import argparse
import sys
import time


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Build a seismic_tpu_torch inverted index from binary "
        "data"
    )
    p.add_argument("--input-file", required=True,
                   help="dataset in the seismic inner binary format")
    p.add_argument("--output-file", required=True,
                   help="output path (suffix .index.seismic_tpu is added)")
    # pruning
    p.add_argument("--pruning-strategy", default="global-threshold",
                   choices=["fixed-size", "global-threshold", "coi-threshold"])
    p.add_argument("--n-postings", type=int, default=3500)
    p.add_argument("--max-fraction", type=float, default=1.5)
    p.add_argument("--alpha", type=float, default=0.5,
                   help="per-list fraction for coi-threshold pruning")
    # blocking
    p.add_argument("--blocking-strategy", default="random-kmeans",
                   choices=["fixed-size", "random-kmeans"])
    p.add_argument("--block-size", type=int, default=10,
                   help="block size for fixed-size blocking")
    p.add_argument("--centroid-fraction", type=float, default=0.1)
    p.add_argument("--min-cluster-size", type=int, default=2)
    p.add_argument("--clustering-algorithm",
                   default="random-kmeans-inverted-index-approx",
                   choices=["random-kmeans",
                            "random-kmeans-inverted-index",
                            "random-kmeans-inverted-index-approx"])
    p.add_argument("--kmeans-pruning-factor", type=float, default=0.1)
    p.add_argument("--kmeans-doc-cut", type=int, default=15)
    # summarization
    p.add_argument("--summarization-strategy", default="energy-preserving",
                   choices=["fixed-size", "energy-preserving"])
    p.add_argument("--summary-energy", type=float, default=0.4)
    p.add_argument("--n-summary-components", type=int, default=128)
    # knn
    p.add_argument("--knn", type=int, default=0, dest="nknn")
    p.add_argument("--knn-path", default=None)
    # types
    p.add_argument("--component-type", default="u16", choices=["u16", "u32"])
    p.add_argument("--value-type", default="f16",
                   choices=["f32", "f16", "bf16", "fixedu16", "fixedu8",
                            "dotvbyte"])
    # layout
    p.add_argument("--max-block-len", type=int, default=64)
    p.add_argument("--max-doc-nnz", type=int, default=0)
    p.add_argument("--summary-nnz", type=int, default=128)
    p.add_argument("--summary-vocab-cap", type=int, default=512)
    p.add_argument("--batched-indexing", type=int, default=None,
                   help="accepted for parity; ignored")
    p.add_argument("--num-threads", type=int, default=0,
                   help="accepted for parity; the build is parallel")
    p.add_argument("--device", default=None,
                   help="device of the k-NN graph's self-search (default: "
                   "the card; 'cpu' runs the plain versions)")
    return p


def config_from_args(args):
    from ..config import (
        CoiThresholdPruning,
        Configuration,
        EnergyPreservingSummarization,
        FixedSizeBlocking,
        FixedSizePruning,
        FixedSizeSummarization,
        GlobalThresholdPruning,
        KnnConfig,
        RandomKmeans,
        RandomKmeansBlocking,
        RandomKmeansInvertedIndex,
        RandomKmeansInvertedIndexApprox,
        TpuLayout,
    )

    pruning = {
        "fixed-size": lambda: FixedSizePruning(n_postings=args.n_postings),
        "global-threshold": lambda: GlobalThresholdPruning(
            n_postings=args.n_postings, max_fraction=args.max_fraction
        ),
        "coi-threshold": lambda: CoiThresholdPruning(
            alpha=args.alpha, n_postings=args.n_postings
        ),
    }[args.pruning_strategy]()
    clustering = {
        "random-kmeans": lambda: RandomKmeans(),
        "random-kmeans-inverted-index": lambda: RandomKmeansInvertedIndex(
            pruning_factor=args.kmeans_pruning_factor,
            doc_cut=args.kmeans_doc_cut,
        ),
        "random-kmeans-inverted-index-approx":
            lambda: RandomKmeansInvertedIndexApprox(
                doc_cut=args.kmeans_doc_cut
            ),
    }[args.clustering_algorithm]()
    blocking = {
        "fixed-size": lambda: FixedSizeBlocking(block_size=args.block_size),
        "random-kmeans": lambda: RandomKmeansBlocking(
            centroid_fraction=args.centroid_fraction,
            min_cluster_size=args.min_cluster_size,
            clustering_algorithm=clustering,
        ),
    }[args.blocking_strategy]()
    summarization = {
        "fixed-size": lambda: FixedSizeSummarization(
            n_components=args.n_summary_components
        ),
        "energy-preserving": lambda: EnergyPreservingSummarization(
            summary_energy=args.summary_energy
        ),
    }[args.summarization_strategy]()
    layout = TpuLayout(
        max_doc_nnz=args.max_doc_nnz,
        max_block_len=args.max_block_len,
        max_summary_nnz=args.summary_nnz,
        summary_vocab_cap=args.summary_vocab_cap,
    )
    return Configuration(
        pruning=pruning,
        blocking=blocking,
        summarization=summarization,
        knn=KnnConfig(nknn=args.nknn, knn_path=args.knn_path),
        layout=layout,
    )


VALUE_DTYPES = {
    "f32": "f32",
    "f16": "f16",
    "bf16": "bf16",
    "fixedu16": "u16",
    "fixedu8": "u8",
    "dotvbyte": "u8",
}


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    from ..build.builder import build_index
    from ..data.io import read_seismic_format
    from ..search.knn import build_knn, load_knn

    t0 = time.time()
    dataset = read_seismic_format(args.input_file)
    cap = 1 << 16 if args.component_type == "u16" else 1 << 32
    if dataset.dim > cap:
        print(
            f"error: dataset dim {dataset.dim} exceeds --component-type "
            f"{args.component_type}; use u32",
            file=sys.stderr,
        )
        return 2
    print(f"Read {len(dataset)} vectors (dim {dataset.dim}) "
          f"in {time.time()-t0:.1f} secs")

    config = config_from_args(args)
    t1 = time.time()
    arrays = build_index(
        dataset, config, value_dtype=VALUE_DTYPES[args.value_type],
        progress=True,
    )
    print(f"Time to build {time.time()-t1:.0f} secs")

    if args.knn_path:
        arrays.knn = load_knn(args.knn_path, args.nknn or None)
    elif args.nknn > 0:
        arrays.knn = build_knn(arrays, arrays.to_device(args.device),
                               args.nknn)

    path = arrays.save(args.output_file)
    print(f"Saving ... {path}")
    arrays.print_space_usage_byte()
    return 0


if __name__ == "__main__":
    sys.exit(main())
