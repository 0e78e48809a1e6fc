"""CLI: convert a JSONL (or tar.gz) collection to the seismic inner binary
format + side files (doc_ids.npy, queries_ids.npy, token_to_id_mapping.json).

The port of `seismic_tpu/cli/convert_json_to_inner_format.py`, with the
same flags and byte-equal outputs (reference:
scripts/convert_json_to_inner_format.py:10-27 binary layout, 84-203
readers, 331-349 outputs). Token ids are assigned by sorted token order
over the union of document and query vocabularies. Host only: no device
runs.

    python -m seismic_tpu_torch.cli.convert_json_to_inner_format \\
        --document-path docs.jsonl [--query-path queries.jsonl] \\
        --output-dir out/
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Convert JSONL collections to the seismic binary format"
    )
    p.add_argument("--document-path", required=True)
    p.add_argument("--query-path", default=None)
    p.add_argument("--output-dir", required=True)
    args = p.parse_args(argv)

    from ..data.io import iter_documents, save_token_map, write_seismic_format
    from ..data.sparse import CsrDataset

    os.makedirs(args.output_dir, exist_ok=True)

    # pass 1: sorted global token map over docs (+ queries)
    paths = [args.document_path] + ([args.query_path] if args.query_path
                                    else [])
    vocab = set()
    for path in paths:
        for rec in iter_documents(path):
            vocab.update(rec["vector"].keys())
    token_to_id = {tok: i for i, tok in enumerate(sorted(vocab))}
    print(f"vocabulary size: {len(token_to_id)}")

    def encode(path):
        rows, ids = [], []
        for rec in iter_documents(path):
            ids.append(str(rec["id"]))
            vec = rec["vector"]
            rows.append(([token_to_id[t] for t in vec], list(vec.values())))
        return CsrDataset.from_rows(rows, dim=len(token_to_id)), ids

    for path, bin_name, ids_name, what in (
            (args.document_path, "documents.bin", "doc_ids.npy",
             "documents"),
            (args.query_path, "queries.bin", "queries_ids.npy", "queries")):
        if path is None:
            continue
        data, ids = encode(path)
        write_seismic_format(data, os.path.join(args.output_dir, bin_name))
        np.save(os.path.join(args.output_dir, ids_name),
                np.asarray(ids, dtype="U30"))
        print(f"wrote {len(data)} {what}")

    save_token_map(
        token_to_id,
        os.path.join(args.output_dir, "token_to_id_mapping.json"),
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
