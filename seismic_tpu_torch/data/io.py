"""Ingestion and serialization I/O: this package's own copy of
`seismic_tpu/data/io.py` (NumPy only), whose readers give the same arrays
and whose writers give byte-equal files.

Covers the reference's three on-disk interchange formats so data prepared
for Rust Seismic works here unchanged:

- JSONL documents/queries: ``{"id": ..., "content": ...?, "vector": {token: score}}``
  (reference: src/json_utils.rs:10-78, docs/RunExperiments.md:29-34)
- ``.tar.gz`` of a JSONL file (reference: inverted_index_wrapper.rs:573-596)
- the *seismic inner binary format*: u32-LE count; per vector u32-LE length,
  ``len`` x u32-LE sorted component ids, ``len`` x f32-LE values
  (reference: scripts/convert_json_to_inner_format.py:10-27 and
  `read_seismic_format` use in src/bin/build_inverted_index.rs:232-233)
"""

from __future__ import annotations

import gzip
import io as _io
import json
import struct
import tarfile
from typing import Callable, Iterator, Optional

import numpy as np

from .sparse import CsrDataset, GrowableCsrDataset


# ---------------------------------------------------------------------------
# JSONL / tar.gz streaming
# ---------------------------------------------------------------------------


def iter_jsonl(path_or_file) -> Iterator[dict]:
    """Stream records from a .jsonl / .jsonl.gz path or an open text file."""
    if hasattr(path_or_file, "read"):
        for line in path_or_file:
            line = line.strip()
            if line:
                yield json.loads(line)
        return
    path = str(path_or_file)
    opener: Callable = gzip.open if path.endswith(".gz") and not _is_targz(path) else open
    with opener(path, "rt") as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def _is_targz(path: str) -> bool:
    return path.endswith(".tar.gz") or path.endswith(".tgz")


def iter_tar_jsonl(path: str) -> Iterator[dict]:
    """Stream records from the first .jsonl member of a tar.gz archive."""
    with tarfile.open(path, "r:gz") as tar:
        for member in tar:
            if member.isfile() and member.name.endswith(".jsonl"):
                f = tar.extractfile(member)
                assert f is not None
                for line in _io.TextIOWrapper(f, encoding="utf-8"):
                    line = line.strip()
                    if line:
                        yield json.loads(line)
                return
    raise FileNotFoundError(f"no .jsonl member found in {path}")


def iter_documents(path: str) -> Iterator[dict]:
    """Dispatch on extension like SeismicIndex::from_file
    (reference: inverted_index_wrapper.rs:526-552)."""
    if _is_targz(path):
        return iter_tar_jsonl(path)
    if path.endswith(".jsonl") or path.endswith(".jsonl.gz"):
        return iter_jsonl(path)
    raise ValueError(f"unsupported input extension: {path}")


# ---------------------------------------------------------------------------
# Two-pass JSONL ingestion with a string-token vocabulary
# (reference: build_token_map + process_data, inverted_index_wrapper.rs:398-480)
# ---------------------------------------------------------------------------


def read_jsonl_dataset(
    path: str,
    token_to_id: Optional[dict] = None,
    load_content: bool = True,
    max_vocab: Optional[int] = None,
):
    """Returns (CsrDataset, doc_ids, token_to_id, contents).

    Pass 1 builds the token map (unless one is provided); pass 2 encodes every
    document, sorting components per doc. ``max_vocab`` mirrors the vocab
    overflow assert (wrapper.rs:414-419) for the u16-component API class.
    """
    build_map = token_to_id is None
    if build_map:
        token_to_id = {}
        for rec in iter_documents(path):
            for tok in rec["vector"].keys():
                if tok not in token_to_id:
                    token_to_id[tok] = len(token_to_id)
    if max_vocab is not None and len(token_to_id) > max_vocab:
        raise ValueError(
            f"vocabulary size {len(token_to_id)} exceeds the component type "
            f"capacity {max_vocab}; use the LV (large-vocabulary) variant"
        )

    doc_ids: list[str] = []
    contents: list[Optional[str]] = []
    growable = GrowableCsrDataset(dim=len(token_to_id))
    for rec in iter_documents(path):
        doc_ids.append(str(rec["id"]))
        contents.append(rec.get("content") if load_content else None)
        vec = rec["vector"]
        comps, vals = [], []
        for tok, score in vec.items():
            tid = token_to_id.get(tok)
            if tid is not None:
                comps.append(tid)
                vals.append(score)
        growable.push(comps, vals)
    dataset = growable.freeze()
    if dataset.dim < len(token_to_id):
        dataset = CsrDataset(
            dataset.offsets, dataset.components, dataset.values, len(token_to_id)
        )
    return dataset, np.asarray(doc_ids, dtype="U30"), token_to_id, contents


def read_jsonl_queries(path: str) -> list[tuple[str, dict]]:
    """Returns [(query_id, {token: value})] (reference: json_utils.rs:63-78)."""
    out = []
    for rec in iter_documents(path):
        out.append((str(rec["id"]), rec["vector"]))
    return out


# ---------------------------------------------------------------------------
# Seismic inner binary format
# ---------------------------------------------------------------------------


def read_seismic_format(path: str, dim: Optional[int] = None) -> CsrDataset:
    """Read the reference's binary dataset format into a CsrDataset."""
    with open(path, "rb") as f:
        data = f.read()
    n = struct.unpack_from("<I", data, 0)[0]
    pos = 4
    offsets = np.zeros(n + 1, dtype=np.int64)
    comp_chunks, val_chunks = [], []
    for i in range(n):
        (length,) = struct.unpack_from("<I", data, pos)
        pos += 4
        comps = np.frombuffer(data, dtype="<u4", count=length, offset=pos)
        pos += 4 * length
        vals = np.frombuffer(data, dtype="<f4", count=length, offset=pos)
        pos += 4 * length
        comp_chunks.append(comps.astype(np.int32))
        val_chunks.append(vals.astype(np.float32))
        offsets[i + 1] = offsets[i] + length
    components = (
        np.concatenate(comp_chunks) if comp_chunks else np.zeros(0, np.int32)
    )
    values = np.concatenate(val_chunks) if val_chunks else np.zeros(0, np.float32)
    if dim is None:
        dim = int(components.max()) + 1 if len(components) else 0
    return CsrDataset(offsets, components, values, int(dim))


def write_seismic_format(dataset: CsrDataset, path: str) -> None:
    """Write a CsrDataset in the reference's binary dataset format."""
    with open(path, "wb") as f:
        f.write(struct.pack("<I", len(dataset)))
        for comps, vals in dataset.iter_rows():
            f.write(struct.pack("<I", len(comps)))
            f.write(comps.astype("<u4").tobytes())
            f.write(vals.astype("<f4").tobytes())


# ---------------------------------------------------------------------------
# Token map persistence (token_to_id_mapping.json interop)
# ---------------------------------------------------------------------------


def save_token_map(token_to_id: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(token_to_id, f)


def load_token_map(path: str) -> dict:
    with open(path) as f:
        return {str(k): int(v) for k, v in json.load(f).items()}
