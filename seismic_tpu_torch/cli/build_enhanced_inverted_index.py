"""CLI: build an index from JSONL via the SeismicIndex wrapper (the port
of `seismic_tpu/cli/build_enhanced_inverted_index.py`; reference:
src/bin/build_enhanced_inverted_index.rs:158-191). The same flags, plus
`--device` for the k-NN graph's self-search (`--knn N` without
`--knn-path`; the card by default).

    python -m seismic_tpu_torch.cli.build_enhanced_inverted_index \\
        --input-file docs.jsonl --output-file my_index [knobs]
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Build a seismic_tpu_torch index from a JSONL collection"
    )
    p.add_argument("--input-file", required=True, help=".jsonl or .tar.gz")
    p.add_argument("--output-file", required=True)
    p.add_argument("--n-postings", type=int, default=3500)
    p.add_argument("--max-fraction", type=float, default=1.5)
    p.add_argument("--centroid-fraction", type=float, default=0.1)
    p.add_argument("--min-cluster-size", type=int, default=2)
    p.add_argument("--summary-energy", type=float, default=0.4)
    p.add_argument("--doc-cut", type=int, default=15)
    p.add_argument("--knn", type=int, default=0, dest="nknn")
    p.add_argument("--knn-path", default=None)
    p.add_argument("--component-type", default="u16", choices=["u16", "u32"])
    p.add_argument("--no-content", action="store_true")
    p.add_argument("--device", default=None,
                   help="the card by default; 'cpu' runs the plain versions")
    args = p.parse_args(argv)

    from ..api import SeismicIndex, SeismicIndexLV

    cls = SeismicIndexLV if args.component_type == "u32" else SeismicIndex
    t0 = time.time()
    index = cls.build(
        args.input_file,
        n_postings=args.n_postings,
        max_fraction=args.max_fraction,
        centroid_fraction=args.centroid_fraction,
        min_cluster_size=args.min_cluster_size,
        summary_energy=args.summary_energy,
        doc_cut=args.doc_cut,
        nknn=args.nknn,
        knn_path=args.knn_path,
        load_content=not args.no_content,
        progress=True,
        device=args.device,
    )
    print(f"Time to build {time.time()-t0:.0f} secs")
    path = index.save(args.output_file)
    print(f"Saving ... {path}")
    index.print_space_usage_byte()
    return 0


if __name__ == "__main__":
    sys.exit(main())
