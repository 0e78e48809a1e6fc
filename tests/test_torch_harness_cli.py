"""The port's experiment harness (`seismic_tpu_torch/harness/`: evaluate,
best_configs, run_experiments, run_grid_search, export_synth, bench_knn,
bench_mem, profile_stages, build_88m) on the CPU, against the JAX
package's where it has a counterpart that runs here.

- `evaluate`'s metrics equal JAX's on the same seeded runs and qrels;
- `best_configs` over the committed `experiments/grid_synth/` with
  `experiments/best_configs_synth/base.toml` writes the same TOML files,
  byte for byte, as JAX's;
- `combo_hash` / `expand_grid` equal JAX's, and JAX's `completed_combos`
  reads a grid root the port wrote;
- `export_synth` at a cut size (300 documents at dim 2048, 1025
  queries, the last from the second seed): the `.bin` and id files
  byte-identical to JAX's export of the same cut, the ground-truth ids equal up to ties (scores 1e-5 relative);
- `run_experiments` on a tiny TOML over that export writes a report.tsv
  whose accuracy equals `evaluate` on its run file; a second experiment
  with the same [indexing_parameters] reuses the saved index;
- a second `run_grid_search` builds and queries nothing;
- `bench_knn`, `bench_mem` (both modes), `profile_stages` (both forms,
  final top-k equal to the engine program's) and `build_88m` (a second
  run builds nothing) run at cut sizes with `--device cpu`.
"""

import filecmp
import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_DOCS, DIM, N_Q = 300, 2048, 1025
EXPORTED = ("documents.bin", "queries.bin", "doc_ids.npy",
            "queries_ids.npy")


# ---- evaluate ----


def _runs_and_qrels():
    rng = np.random.default_rng(23)
    run, gt, qrels = {}, {}, {}
    for q in range(40):
        docs = [str(d) for d in rng.choice(200, 15, replace=False)]
        run[str(q)] = [(d, float(15 - i)) for i, d in enumerate(docs)]
        g = list(rng.choice(docs[:12], 6, replace=False)) + [
            str(d) for d in rng.choice(range(200, 260), 4, replace=False)]
        gt[str(q)] = [(d, float(10 - i)) for i, d in enumerate(g)]
        qrels[str(q)] = {d: int(rng.integers(0, 3)) for d in
                         rng.choice(docs + ["x1", "x2"], 5, replace=False)}
    return run, gt, qrels


@pytest.mark.parametrize("metric", ["RR@10", "MRR@5", "Recall@10", "R@5",
                                    "P@5", "Success@10", "nDCG@10",
                                    "AP@10", "Accuracy@10"])
def test_evaluate_metrics_match_jax(metric):
    from seismic_tpu.harness import evaluate as j
    from seismic_tpu_torch.harness import evaluate as t

    run, gt, qrels = _runs_and_qrels()
    assert t.compute_metric(run, qrels, metric) == \
        j.compute_metric(run, qrels, metric)
    assert t.accuracy_at_k(run, gt, 10) == j.accuracy_at_k(run, gt, 10)
    assert t.mrr_at_k(run, qrels, 10) == j.mrr_at_k(run, qrels, 10)


def test_evaluate_readers_match_jax(tmp_path):
    from seismic_tpu.harness import evaluate as j
    from seismic_tpu_torch.harness import evaluate as t

    run, _, qrels = _runs_and_qrels()
    rp, qp = tmp_path / "run.tsv", tmp_path / "qrels.txt"
    with open(rp, "w") as f:
        for q, rows in run.items():
            for r, (d, s) in enumerate(rows):
                f.write(f"{q}\t{d}\t{r}\t{s:.6f}\n")
    with open(qp, "w") as f:
        for q, rels in qrels.items():
            for d, r in rels.items():
                f.write(f"{q} 0 {d} {r}\n")
    assert t.read_run_tsv(str(rp)) == j.read_run_tsv(str(rp))
    assert t.read_qrels(str(qp)) == j.read_qrels(str(qp))
    results = [[(q, s, d) for d, s in rows] for q, rows in run.items()]
    assert t.results_to_run(results) == j.results_to_run(results)


# ---- best configs, grid helpers ----


@pytest.mark.parametrize("extra", [[], ["--recalls", "0.9,0.968,0.975",
                                        "--mem-budget-bytes", "9000000000"]],
                         ids=["default", "budget"])
def test_best_configs_match_jax(tmp_path, extra):
    from seismic_tpu.harness.best_configs import main as j_main
    from seismic_tpu_torch.harness.best_configs import main as t_main

    argv = ["--grid-root", os.path.join(REPO, "experiments", "grid_synth"),
            "--base-toml", os.path.join(REPO, "experiments",
                                        "best_configs_synth", "base.toml")]
    for name, main in (("jax", j_main), ("torch", t_main)):
        assert main(argv + extra + ["--output-dir",
                                    str(tmp_path / name)]) == 0
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files and files == sorted(os.listdir(tmp_path / "torch"))
    for f in files:
        assert filecmp.cmp(tmp_path / "jax" / f, tmp_path / "torch" / f,
                           shallow=False), f


@pytest.mark.parametrize("section", [
    {"n-postings": [100, 200], "summary-energy": 0.4,
     "value-type": ["f32", "f16"]},
    {"query-cut": [10, 11, 14], "heap-factor": 0.0, "full-lists": True},
    {},
])
def test_grid_helpers_match_jax(section):
    from seismic_tpu.harness import run_grid_search as j
    from seismic_tpu_torch.harness import run_grid_search as t

    assert t.expand_grid(section) == j.expand_grid(section)
    for combo in t.expand_grid(section):
        c = {"indexing": combo, "query": {"k": 10}}
        assert t.combo_hash(c) == j.combo_hash(c)


# ---- the export and what runs on it ----


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """{package: the directory its export_synth wrote} at the cut size."""
    import seismic_tpu.harness.export_synth as jx
    from seismic_tpu_torch.harness.export_synth import main as t_main

    d = tmp_path_factory.mktemp("export")
    assert t_main(["--out", str(d / "torch"), "--n-docs", str(N_DOCS),
                   "--dim", str(DIM), "--n-queries", str(N_Q),
                   "--cache-dir", "", "--device", "cpu"]) == 0
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jx, "N_DOCS", N_DOCS)
        mp.setattr(jx, "DIM", DIM)
        mp.setattr(jx, "N_QUERIES", N_Q)
        mp.setattr(jx, "CACHE", str(d / "no_cache"))
        mp.setattr(sys, "argv", ["export_synth", "--out", str(d / "jax")])
        jx.main()
    finally:
        mp.undo()
    return {"jax": d / "jax", "torch": d / "torch"}


@pytest.mark.parametrize("name", EXPORTED)
def test_export_synth_files_match_jax(exported, name):
    assert filecmp.cmp(exported["jax"] / name, exported["torch"] / name,
                       shallow=False)


def test_export_synth_groundtruth_matches_jax(exported):
    from seismic_tpu_torch.harness.evaluate import read_run_tsv

    j_gt = read_run_tsv(str(exported["jax"] / "groundtruth.tsv"))
    t_gt = read_run_tsv(str(exported["torch"] / "groundtruth.tsv"))
    assert set(j_gt) == set(t_gt) and len(t_gt) == N_Q
    for q in j_gt:
        (jd, js), (td, ts) = (list(zip(*x[q])) for x in (j_gt, t_gt))
        np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-6)
        # ids equal up to ties: a differing id sits where the scores tie
        js, ts = np.asarray(js), np.asarray(ts)
        for r in np.flatnonzero(np.asarray(jd) != np.asarray(td)):
            assert np.isclose(js[r], js, rtol=1e-6).sum() > 1, (q, r)


TOML = """[settings]
k = 10
exp-name = "tiny"

[folder]
data = "{data}"
experiment = "{exp}"

[filename]
dataset = "documents.bin"
queries = "queries.bin"
groundtruth = "groundtruth.tsv"

[indexing_parameters]
n-postings = 100
max-block-len = 16
summary-vocab-cap = 256
max-doc-nnz = 64
value-type = "f32"

[query.hf07]
query-cut = 10
heap-factor = 0.7
batch-size = 512

[query.budget]
query-cut = 8
block-budget = 16
batch-size = 512
"""

GRID = """[settings]
k = 10
exp-name = "g"

[folder]
data = "{data}"
experiment = "{exp}"

[filename]
dataset = "documents.bin"
queries = "queries.bin"
groundtruth = "groundtruth.tsv"

[indexing_parameters]
n-postings = [100]
max-block-len = 16
summary-vocab-cap = 256
max-doc-nnz = 64

[querying_parameters]
query-cut = [6, 10]
batch-size = 512
"""


@pytest.fixture(scope="module")
def experiment(exported, tmp_path_factory):
    """The report path of run_experiments on the tiny TOML, and the exp
    root."""
    from seismic_tpu_torch.harness.run_experiments import run_experiment

    d = tmp_path_factory.mktemp("exp")
    toml = d / "tiny.toml"
    toml.write_text(TOML.format(data=exported["torch"], exp=d / "out"))
    return run_experiment(str(toml), device="cpu"), d


def test_run_experiments_report_matches_evaluate(experiment, exported):
    from seismic_tpu_torch.harness.evaluate import (
        accuracy_at_k,
        read_run_tsv,
    )

    report, _ = experiment
    rows = [line.rstrip("\n").split("\t") for line in open(report)]
    head, body = rows[0], rows[1:]
    assert [r[0] for r in body] == ["hf07", "budget"]
    gt = read_run_tsv(str(exported["torch"] / "groundtruth.tsv"))
    for r in body:
        rec = dict(zip(head, r))
        run = read_run_tsv(os.path.join(os.path.dirname(report),
                                        f"run_{rec['name']}.tsv"))
        assert len(run) == N_Q
        assert float(rec["accuracy"]) == accuracy_at_k(run, gt, 10)
        assert float(rec["accuracy"]) > 0.5
        assert float(rec["us_per_query"]) > 0
        assert int(rec["total_bytes"]) > 0


def test_run_experiments_reuses_the_index(experiment, tmp_path):
    """A second experiment with the same indexing parameters builds
    nothing (build_secs 0.0 in its report)."""
    from seismic_tpu_torch.harness.run_experiments import run_experiment

    report, d = experiment
    toml = d / "again.toml"
    toml.write_text((d / "tiny.toml").read_text().replace('"tiny"',
                                                          '"again"'))
    again = run_experiment(str(toml), device="cpu")
    rows = [line.rstrip("\n").split("\t") for line in open(again)]
    col = rows[0].index("build_secs")
    assert [r[col] for r in rows[1:]] == ["0.0", "0.0"]
    assert float(open(report).readlines()[1].split("\t")[col]) > 0
    assert len(os.listdir(d / "out" / "indexes")) == 1


def test_grid_search_resumes_without_work(exported, tmp_path):
    from seismic_tpu.harness.run_grid_search import (
        completed_combos as j_completed,
    )
    from seismic_tpu_torch.harness.run_grid_search import (
        completed_combos,
        run_grid,
    )

    toml = tmp_path / "grid.toml"
    toml.write_text(GRID.format(data=exported["torch"], exp=tmp_path))
    assert run_grid(str(toml), device="cpu") == {"done": 2, "skipped": 0}
    root = str(tmp_path / "grid_g")
    assert len(completed_combos(root)) == 2
    assert j_completed(root) == completed_combos(root)
    assert run_grid(str(toml), device="cpu") == {"done": 0, "skipped": 2}


def test_bench_knn_at_cut_size(experiment, exported, tmp_path):
    from seismic_tpu_torch.harness.bench_knn import main

    _, d = experiment
    (index,) = [os.path.join(d / "out" / "indexes", f)
                for f in os.listdir(d / "out" / "indexes")]
    argv = ["--index", index, "--nknn", "4", "--knn-path",
            str(tmp_path / "g4"), "--query-file",
            str(exported["torch"] / "queries.bin"), "--groundtruth",
            str(exported["torch"] / "groundtruth.tsv"), "--batch", "64",
            "--reps", "1", "--device", "cpu"]
    res = main(argv)
    assert res["graph_shape"] == [N_DOCS, 4] and res["build_s"] is not None
    assert [(r["query_cut"], r["n_knn"]) for r in res["rungs"]] == [
        (11, 0), (11, 4), (16, 0), (20, 0)]
    assert all(0.5 < r["recall_at_10"] <= 1.0 for r in res["rungs"])
    again = main(argv[:-4] + ["--reps", "0", "--device", "cpu"])
    assert again["build_s"] is None and again["rungs"] == []


def test_profile_stages_at_cut_size(experiment):
    from seismic_tpu_torch.harness.profile_stages import main

    _, d = experiment
    (index,) = [os.path.join(d / "out" / "indexes", f)
                for f in os.listdir(d / "out" / "indexes")]
    res = main(["--index", index, "--batch", "32", "--reps", "1",
                "--query-cut", "10", "--block-budget", "32", "--both",
                "--device", "cpu"])
    for form, n in (("blocks", 7), ("tiles", 6)):
        r = res[form]
        assert r["matches_search_batch"] is True, form
        stages = [k for k in r if k[0].isdigit()]
        assert len(stages) == n and all(r[k] >= 0 for k in stages)


@pytest.mark.parametrize("block", [False, True], ids=["rescore", "block"])
def test_bench_mem_at_cut_size(tmp_path, block):
    from seismic_tpu_torch.harness.bench_mem import main

    out = tmp_path / "mem.json"
    jax_record = os.path.join(REPO, "MEM_BENCH.json")
    before = os.path.getmtime(jax_record)
    argv = ["--n-docs", str(N_DOCS), "--dim", str(DIM), "--batch", "16",
            "--reps", "1", "--max-rungs", "2", "--cache-dir",
            str(tmp_path / "cache"), "--out", str(out), "--device", "cpu"]
    if block:
        argv += ["--block", "--block-v", "128"]
    art = main(argv)
    rec = json.load(open(out))
    section = "block_mode" if block else "rescore_mode"
    assert rec[section]["rungs"] == art["rungs"] and len(art["rungs"]) == 2
    assert all(0.3 < r["recall_at_10"] <= 1.0 for r in art["rungs"])
    assert art["device"] == "cpu" and art["device_bytes"] > 0
    assert os.path.getmtime(jax_record) == before


def test_build_88m_stages_resume(tmp_path):
    from seismic_tpu_torch.harness.build_88m import main
    from seismic_tpu_torch.types import IndexArrays

    argv = ["50", "--n-docs", str(N_DOCS), "--dim", str(DIM),
            "--n-queries", "64", "--cache-dir", str(tmp_path)]
    first = main(argv)
    assert first["built"] == ["index", "queries"]
    arrays = IndexArrays.load_dir(first["index_dir"])
    assert arrays.n_docs == N_DOCS and arrays.doc_tiles is None
    assert np.asarray(arrays.fwd_vals).dtype == np.uint8
    assert arrays.dense_summary.shape[1] == 512
    with np.load(first["queries"]) as z:
        assert z["q_comps"].shape == (64, 64)
    assert main(argv)["built"] == []
