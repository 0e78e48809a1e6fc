"""The port's command-line entry points (`seismic_tpu_torch/cli/`) against
the JAX package's (`seismic_tpu/cli/`) on the CPU.

Inputs: a synthetic JSONL collection of 300 documents and 24 queries over
2048 string tokens, made with numpy from a seed and written to a
temporary directory. Each test runs both packages' `main(argv)` (the
port's with `--device cpu`) on the same files:

- `convert_json_to_inner_format`: every output file byte-identical;
- `build_inverted_index.config_from_args`: equal configurations for each
  choice of pruning, blocking, clustering, summarization and value type;
- the build CLI: the saved index's arrays and metadata equal;
- an index saved by JAX's build CLI serves the port's perf CLI, with the
  run file of the port's own index;
- the perf CLI on the engine route (the route both take off their
  accelerators), full lists and a block budget: run files agree with
  JAX's (top-k id sets on >= 98% of queries, shared ids' scores to 1e-3
  relative, ROADMAP's bar);
- the enhanced build / perf CLIs (`SeismicIndex` on JSONL): run files
  (string ids) agree with JAX's to the same bar.
"""

import filecmp
import json
import os

import numpy as np
import pytest

DIM, N_DOCS, N_QUERIES = 2048, 300, 24
BUILD_FLAGS = ["--n-postings", "100", "--max-block-len", "16",
               "--summary-vocab-cap", "256", "--max-doc-nnz", "64"]
CONVERTED = ("documents.bin", "queries.bin", "doc_ids.npy",
             "queries_ids.npy", "token_to_id_mapping.json")


def _jsonl(path, n, lo, hi, prefix, rng):
    with open(path, "w") as f:
        for i in range(n):
            nnz = int(rng.integers(lo, hi))
            comps = rng.choice(DIM, nnz, replace=False)
            vals = rng.gamma(2.0, 1.0, nnz).astype(np.float32) + 0.01
            f.write(json.dumps({
                "id": f"{prefix}{i}", "content": f"text of {prefix}{i}",
                "vector": {f"t{int(c)}": float(v)
                           for c, v in zip(comps, vals)}}) + "\n")


@pytest.fixture(scope="module")
def collection(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_jsonl")
    rng = np.random.default_rng(19)
    _jsonl(d / "docs.jsonl", N_DOCS, 16, 80, "d", rng)
    _jsonl(d / "queries.jsonl", N_QUERIES, 6, 24, "q", rng)
    return d


@pytest.fixture(scope="module")
def converted(collection, tmp_path_factory):
    """{package: the directory its converter wrote}."""
    from seismic_tpu.cli.convert_json_to_inner_format import main as j_conv
    from seismic_tpu_torch.cli.convert_json_to_inner_format import (
        main as t_conv,
    )

    out = {}
    for name, conv in (("jax", j_conv), ("torch", t_conv)):
        d = tmp_path_factory.mktemp(f"bin_{name}")
        assert conv(["--document-path", str(collection / "docs.jsonl"),
                     "--query-path", str(collection / "queries.jsonl"),
                     "--output-dir", str(d)]) == 0
        out[name] = d
    return out


@pytest.fixture(scope="module")
def built(converted, tmp_path_factory):
    """{package: the index path its build CLI saved} from one .bin file."""
    from seismic_tpu.cli.build_inverted_index import main as j_build
    from seismic_tpu_torch.cli.build_inverted_index import main as t_build

    docs = str(converted["torch"] / "documents.bin")
    d = tmp_path_factory.mktemp("cli_idx")
    out = {}
    for name, build, extra in (("jax", j_build, []),
                               ("torch", t_build, ["--device", "cpu"])):
        path = str(d / f"idx_{name}")
        assert build(["--input-file", docs, "--output-file", path]
                     + BUILD_FLAGS + extra) == 0
        out[name] = path + ".index.seismic_tpu"
    return out


def _run_file(path):
    """{query id: [(doc, score)] in rank order}."""
    run = {}
    for line in open(path):
        q, d, r, s = line.rstrip("\n").split("\t")
        run.setdefault(q, []).append((int(r), d, float(s)))
    return {q: [(d, s) for _, d, s in sorted(v)] for q, v in run.items()}


def _assert_runs_agree(a, b):
    """ROADMAP's bar: top-k id sets equal on >= 98% of queries, the scores
    of ids both hold equal to 1e-3 relative."""
    assert set(a) == set(b) and len(a) >= N_QUERIES
    same = 0
    for q in a:
        da, db = dict(a[q]), dict(b[q])
        same += set(da) == set(db)
        for d in set(da) & set(db):
            assert abs(da[d] - db[d]) <= 1e-3 * max(abs(db[d]), 1e-6), (q, d)
    assert same / len(a) >= 0.98


@pytest.mark.parametrize("name", CONVERTED)
def test_convert_outputs_byte_identical(converted, name):
    a, b = converted["jax"] / name, converted["torch"] / name
    assert a.exists() and b.exists()
    assert filecmp.cmp(a, b, shallow=False)


CONFIG_CASES = (
    [["--pruning-strategy", s] for s in
     ("fixed-size", "global-threshold", "coi-threshold")]
    + [["--blocking-strategy", s] for s in ("fixed-size", "random-kmeans")]
    + [["--clustering-algorithm", s] for s in
       ("random-kmeans", "random-kmeans-inverted-index",
        "random-kmeans-inverted-index-approx")]
    + [["--summarization-strategy", s] for s in
       ("fixed-size", "energy-preserving")]
    + [["--value-type", s] for s in
       ("f32", "f16", "bf16", "fixedu16", "fixedu8", "dotvbyte")]
)


@pytest.mark.parametrize("flags", CONFIG_CASES,
                         ids=["-".join(c) for c in CONFIG_CASES])
def test_config_from_args_matches_jax(flags):
    from seismic_tpu.cli import build_inverted_index as j
    from seismic_tpu_torch.cli import build_inverted_index as t

    argv = ["--input-file", "x.bin", "--output-file", "x", "--n-postings",
            "77", "--alpha", "0.3", "--block-size", "12",
            "--kmeans-doc-cut", "9", "--n-summary-components", "33",
            "--knn", "5", "--summary-vocab-cap", "384"] + flags
    ja, ta = j.build_arg_parser().parse_args(argv), \
        t.build_arg_parser().parse_args(argv)
    assert t.config_from_args(ta).to_dict() == \
        j.config_from_args(ja).to_dict()
    assert t.VALUE_DTYPES[ta.value_type] == j.VALUE_DTYPES[ja.value_type]


def test_build_cli_saves_jax_arrays(built):
    with np.load(built["jax"]) as zj, np.load(built["torch"]) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for f in zj.files:
            np.testing.assert_array_equal(zt[f], zj[f], err_msg=f)


def _perf(main, index, queries, run, extra):
    assert main(["--index-file", index, "--query-file", queries,
                 "--output-path", str(run), "-k", "10", "--batch-size",
                 "8", "--query-cut", "8"] + extra) == 0
    return _run_file(run)


def test_jax_index_serves_port_perf_cli(built, converted, tmp_path):
    from seismic_tpu_torch.cli.perf_inverted_index import main as t_perf

    queries = str(converted["torch"] / "queries.bin")
    runs = [_perf(t_perf, built[name], queries, tmp_path / f"{name}.tsv",
                  ["--device", "cpu", "--heap-factor", "0.0"])
            for name in ("jax", "torch")]
    assert runs[0] == runs[1] and len(runs[0]) == N_QUERIES


@pytest.mark.parametrize("flags", [[], ["--block-budget", "16"]],
                         ids=["full_lists", "block_budget"])
def test_perf_cli_engine_route_matches_jax(built, converted, tmp_path,
                                           flags):
    from seismic_tpu.cli.perf_inverted_index import main as j_perf
    from seismic_tpu_torch.cli.perf_inverted_index import main as t_perf

    queries = str(converted["torch"] / "queries.bin")
    j_run = _perf(j_perf, built["jax"], queries, tmp_path / "j.tsv", flags)
    t_run = _perf(t_perf, built["torch"], queries, tmp_path / "t.tsv",
                  flags + ["--device", "cpu"])
    _assert_runs_agree(t_run, j_run)


def test_enhanced_clis_match_jax(collection, tmp_path):
    from seismic_tpu.cli import build_enhanced_inverted_index as jb
    from seismic_tpu.cli import perf_enhanced_inverted_index as jp
    from seismic_tpu_torch.cli import build_enhanced_inverted_index as tb
    from seismic_tpu_torch.cli import perf_enhanced_inverted_index as tp

    runs = {}
    for name, b, p, extra in (("jax", jb, jp, []),
                              ("torch", tb, tp, ["--device", "cpu"])):
        idx = str(tmp_path / f"enh_{name}")
        assert b.main(["--input-file", str(collection / "docs.jsonl"),
                       "--output-file", idx, "--n-postings", "100"]
                      + extra) == 0
        run = tmp_path / f"enh_{name}.tsv"
        assert p.main(["--index-file", idx, "--query-file",
                       str(collection / "queries.jsonl"), "--output-path",
                       str(run), "-k", "10", "--query-cut", "8"]
                      + extra) == 0
        runs[name] = _run_file(run)
    assert all(d.startswith("d") for v in runs["torch"].values()
               for d, _ in v)
    _assert_runs_agree(runs["torch"], runs["jax"])
    assert os.path.exists(str(tmp_path / "enh_torch") + ".index.seismic_tpu")
