"""The probe drivers of `seismic_tpu_torch/harness/` (protocol,
rebuild_r3_cache, sweep_configs, probe_r5b, probe_r5c, probe_r3j and the
queue script) against the JAX package's and the repo's `bench.py`:

- `protocol.py`'s helpers equal bench.py's at a cut (bench imported with
  its 3300 s watchdog cancelled and its CACHE in `tmp_path`): the same
  collection, index, query stream across a seed boundary, ground truth,
  recall and file names;
- rung tables: each JAX driver's `main` and the port's run under a
  recorder that stubs the data loading, the upload, `plan_caps` and the
  search (the JAX module's ROOT / CACHE in `tmp_path`, so no committed
  record is rewritten): the sequence of search calls (GroupedParams,
  query cut, M, csub, B; two-pass parameters) and of rows written
  (label, csub, M) is the same for every family of r5b and r5c and for
  r3j's ladder;
- rebuild_r3_cache at a cut (CPU only) writes JAX's file names with
  arrays equal to JAX's `synth_dataset` and `narrow_vocab`, and a second
  run builds nothing;
- the drivers run with `--device cpu` at a cut: r5b's M 32 and csub 4
  families (K4's new shapes, K5 at csub 4 in the stride rung), a cut
  sweep whose grid `best_configs` reads, r3j on `build_88m`'s cut cache
  (a touched source directory invalidates its block view); the sweep's
  12 directory names equal the committed `experiments/grid_synth/`;
- the queue script passes `bash -n`, its stage table covers JAX's, it
  invokes only `seismic_tpu_torch` modules, and it logs the `bench`
  stage (no port yet) and an unknown one as FAILED;
- every driver refuses to run without CUDA when no device is given.
"""

import dataclasses
import faulthandler
import importlib
import json
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from seismic_tpu_torch.harness import (
    best_configs,
    build_88m,
    probe_r3j,
    probe_r5b,
    probe_r5c,
    protocol,
    rebuild_r3_cache,
    sweep_configs,
)
from seismic_tpu_torch.search.exact import exact_search

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUEUE = os.path.join(ROOT, "seismic_tpu_torch", "harness", "run_r5_queue.sh")
JAX_QUEUE = os.path.join(ROOT, "seismic_tpu", "harness",
                         "run_r5_tpu_queue.sh")
DIM = 30522


@pytest.fixture(autouse=True)
def one_thread():
    """Each test on one torch thread: the plain versions' many small
    operations slow down sharply when six test workers each run a thread
    a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_module(name, argv, monkeypatch):
    """seismic_tpu.harness.<name>, (re)imported with `argv` as sys.argv
    (probe_r3j and rebuild_r3_cache read it at import), its watchdog
    cancelled."""
    pytest.importorskip("jax")
    monkeypatch.setattr(sys, "argv", argv)
    # the JAX modules set the protocol's variables at import: restore them
    # after the test
    for var in (*protocol.ENV.values(), "BENCH_BATCH"):
        monkeypatch.setenv(var, os.environ.get(var, ""))
        if not os.environ[var]:
            monkeypatch.delenv(var)
    mod = importlib.reload(importlib.import_module(
        f"seismic_tpu.harness.{name}"))
    faulthandler.cancel_dump_traceback_later()
    return mod


def _bench(monkeypatch, cache, **consts):
    """The repo's bench.py with its watchdog cancelled, its CACHE at
    `cache`, no compile cache and the given constants."""
    pytest.importorskip("jax")
    import bench

    faulthandler.cancel_dump_traceback_later()
    monkeypatch.setattr(bench, "CACHE", str(cache))
    monkeypatch.setattr(bench, "enable_compile_cache", lambda: None)
    for k, v in consts.items():
        monkeypatch.setattr(bench, k, v)
    return bench


# ---- protocol.py against bench.py ----


def test_protocol_matches_bench(tmp_path, monkeypatch):
    """get_dataset / get_index / get_queries / get_ground_truth /
    recall_at_k equal bench.py's at a cut (300 docs over 400 terms, 1100
    queries across the seed boundary), and both caches hold the same file
    names."""
    bench = _bench(monkeypatch, tmp_path / "jax", N_DOCS=300,
                   N_QUERIES=1100, DIM=DIM_CUT)
    from seismic_tpu.types import IndexArrays as JArrays

    p = protocol.Protocol(n_docs=300, n_queries=1100, dim=DIM_CUT,
                          cache=str(tmp_path / "torch"))
    os.makedirs(p.cache)
    ds_j, ds_t = bench.get_dataset(), protocol.get_dataset(p)
    for f in ("offsets", "components", "values"):
        np.testing.assert_array_equal(getattr(ds_t, f), getattr(ds_j, f))
    (a_j, base_j), (a_t, base_t) = bench.get_index(ds_j), protocol.get_index(
        ds_t, p)
    assert os.path.basename(base_j) == os.path.basename(base_t)
    for f in dataclasses.fields(JArrays):
        x, y = getattr(a_j, f.name), getattr(a_t, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(np.asarray(y), x, err_msg=f.name)
    q_j = bench.get_queries(bench.DIM)
    q_t = protocol.get_queries(1100, DIM_CUT)
    for x, y in zip(q_j, q_t):
        np.testing.assert_array_equal(y, x)
    qc, qv = q_t[0][:64], q_t[1][:64]
    gt_j = bench.get_ground_truth(ds_j, qc, qv)
    gt_t = protocol.get_ground_truth(ds_t, qc, qv, p, device="cpu")
    np.testing.assert_array_equal(gt_t, gt_j)
    rng = np.random.default_rng(3)
    ids = np.where(rng.random(gt_t.shape) < 0.3, -1,
                   rng.integers(0, 300, gt_t.shape))
    assert protocol.recall_at_k(ids, gt_t) == bench.recall_at_k(ids, gt_j)
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(
        os.listdir(p.cache))


def test_protocol_reads_the_environment_as_bench_does():
    """An override wins, then the environment, then the driver's default,
    then bench.py's value; DIM, K and the target stay fixed."""
    env = {"BENCH_N_DOCS": "5000", "BENCH_N_QUERIES": "64"}
    p = protocol.from_env(defaults={"BENCH_N_DOCS": "1000000",
                                    "BENCH_N_POSTINGS": "400"},
                          overrides={"BENCH_N_QUERIES": "2048"},
                          environ=env, cache="/x")
    assert (p.n_docs, p.n_queries, p.n_postings, p.v_cap, p.dim, p.k,
            p.target_recall) == (5000, 2048, 400, 1024, 30522, 10, 0.97)
    assert p.index_base == "/x/index_5000_30522_400_v1024_o64"
    assert p.gt_path(16) == "/x/gt_5000_30522_16.npz"
    assert protocol.from_env(environ={}).csub == 2


# ---- rung tables under a recorder ----


class Recorder:
    """Stubs of the search entry points; the distinct consecutive calls
    in order."""

    def __init__(self, out):
        self.events = []
        self.out = out  # (B, csub) -> the stub's outputs

    def add(self, ev):
        if not self.events or self.events[-1] != ev:
            self.events.append(ev)

    def search(self, index, qd, vd, gp, qcut, M, gc, wc, zero_region):
        B = int(qd.shape[0])
        self.add(("search", tuple(sorted(dataclasses.asdict(gp).items())),
                  qcut, M, index.csub, B))
        return self.out(B)

    def twopass(self, index, ctx, qn, vn, tp, *a, **k):
        B = len(qn)
        self.add(("twopass", json.dumps(dataclasses.asdict(tp),
                                        sort_keys=True), index.csub, B))
        s, i = self.out(B)
        return np.asarray(s), np.asarray(i), {"flagged": 0}


class _Bytes(int):
    """A byte count read both as JAX's leaf attribute and as the port's
    `nbytes()`."""

    def __call__(self):
        return int(self)


@dataclasses.dataclass
class StubIndex:
    csub: int
    doc_tiles_aligned: object = None
    knn: object = None
    device: str = "cpu"
    nbytes = _Bytes(0)


class StubArrays:
    """Loaded index arrays: any attribute may be set; the upload returns
    a StubIndex of its csub."""

    def __init__(self):
        self.max_block_len = 32
        self.doc_tiles = np.zeros((4, 8), np.uint8)
        self.dense_summary = None

    def to_device(self, *a, **kw):
        return StubIndex(csub=kw.get("tile_csub", 1),
                         doc_tiles_aligned=np.zeros(1, np.float32))


class StubCtx:
    @staticmethod
    def from_arrays(arrays, csub=1, **kw):
        return types.SimpleNamespace(zero_region=0, csub=csub)


def _queries(n):
    """n stub queries; the first rows do not depend on n."""
    comps = (np.arange(n * 64) * 7919 % DIM).astype(np.int32)
    return comps.reshape(n, 64), np.ones((n, 64), np.float32)


def _rows(path, section=None):
    with open(path) as f:
        art = json.load(f)
    if section:
        art = art[section]
    return [(r.get("label"), r.get("csub"), r.get("M"), r.get("batch"),
             r.get("qc"), r.get("pool")) for r in art["rungs"]]


def _jax_stubs(monkeypatch, rec, bench):
    import seismic_tpu.ops_pallas_prep as jprep
    import seismic_tpu.search.grouped as jg
    import seismic_tpu.search.knn as jknn
    import seismic_tpu.search.planner as jplan
    import seismic_tpu.search.twopass as jtp
    import seismic_tpu.types as jtypes

    monkeypatch.setattr(jg, "search_grouped_derive_jit", rec.search)
    monkeypatch.setattr(jg, "plan_caps", lambda *a, **k: (8, 16))
    monkeypatch.setattr(jtp, "search_batch_twopass", rec.twopass)
    monkeypatch.setattr(jplan, "PlannerContext", StubCtx)
    monkeypatch.setattr(jprep, "load_or_build_aligned", lambda *a: None)
    monkeypatch.setattr(jknn, "load_knn",
                        lambda *a, **k: np.zeros((4, 16), np.int32))
    monkeypatch.setattr(jtypes.IndexArrays, "load_dir",
                        staticmethod(lambda *a, **k: StubArrays()))
    monkeypatch.setattr(bench, "_sync", lambda out: out)
    monkeypatch.setattr(bench, "get_queries",
                        lambda dim: _queries(bench.N_QUERIES))


def _port_stubs(monkeypatch, rec, mod):
    monkeypatch.setattr(mod, "search_grouped_derive", rec.search)
    monkeypatch.setattr(mod, "plan_caps", lambda *a, **k: (8, 16))
    monkeypatch.setattr(mod, "PlannerContext", StubCtx)
    if hasattr(mod, "search_batch_twopass"):
        monkeypatch.setattr(mod, "search_batch_twopass", rec.twopass)
    if hasattr(mod, "load_or_build_aligned"):
        monkeypatch.setattr(mod, "load_or_build_aligned", lambda *a: None)
    if hasattr(mod, "load_knn"):
        monkeypatch.setattr(mod, "load_knn",
                            lambda *a, **k: np.zeros((4, 16), np.int32))
    monkeypatch.setattr(mod, "IndexArrays", types.SimpleNamespace(
        load_dir=lambda *a, **k: StubArrays()))
    monkeypatch.setattr(protocol, "get_queries",
                        lambda n, dim: _queries(n))


def _touch(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, ids=np.zeros((1, 10), np.int64))


def _outs(kind):
    def out(B):
        if kind == "np":
            return np.zeros((B, 10), np.float32), np.zeros((B, 10), np.int64)
        return torch.zeros(B, 10), torch.zeros(B, 10, dtype=torch.int64)
    return out


@pytest.mark.parametrize("family", probe_r5b.FAMILIES)
def test_r5b_rung_table_matches_jax(family, tmp_path, monkeypatch):
    """Every search call (params, qc, M, csub, B) and every row (label,
    csub, M) of the family, in order, equal JAX's probe_r5b's; a second
    run skips every label already recorded."""
    jmod = _jax_module("probe_r5b", ["probe_r5b", family], monkeypatch)
    bench = _bench(monkeypatch, tmp_path / "jax", N_DOCS=100000,
                   N_QUERIES=16384, N_POSTINGS=200, V_CAP=1024,
                   TILE_OVERFLOW=64, NARROW_V=512)
    jrec = Recorder(_outs("np"))
    _jax_stubs(monkeypatch, jrec, bench)
    monkeypatch.setattr(jmod, "ROOT", str(tmp_path))
    jbase = os.path.join(bench.CACHE, "index_100000_30522_200_v1024_o64")
    os.makedirs(jbase + "_nw512.dir")
    _touch(os.path.join(bench.CACHE, "gt_100000_30522_16384.npz"))
    open(jbase + ".knn16.knn.seismic_tpu", "w").close()
    jmod.main()
    faulthandler.cancel_dump_traceback_later()

    trec = Recorder(_outs("torch"))
    _port_stubs(monkeypatch, trec, probe_r5b)
    monkeypatch.setattr(probe_r5b, "load_arrays", lambda p: (
        StubArrays(), "dir", np.zeros((4, 16), np.int32)))
    for var in protocol.ENV.values():
        monkeypatch.delenv(var, raising=False)
    cache = tmp_path / "torch"
    _touch(str(cache / "gt_100000_30522_16384.npz"))
    rec = str(tmp_path / "r5b.json")
    args = [family, "--cache-dir", str(cache), "--record", rec, "--device",
            "cpu"]
    probe_r5b.main(args)
    assert trec.events == jrec.events and trec.events
    jrows = (_rows(tmp_path / "BENCH_STAGE_r5.json")
             if os.path.exists(tmp_path / "BENCH_STAGE_r5.json") else [])
    trows = _rows(rec) if os.path.exists(rec) else []
    assert trows == jrows
    # a second run skips every label already in the record
    n_events = len(trec.events)
    assert probe_r5b.main(args)["rows"] == [] and (
        len(trec.events) <= n_events + 1)
    assert _rows(rec) == trows


@pytest.mark.parametrize("family", probe_r5c.FAMILIES)
def test_r5c_rung_table_matches_jax(family, tmp_path, monkeypatch):
    """The same for every family of probe_r5c at width 1024 (lean16 and
    b4kf with R5C_FWD16=1)."""
    if family in ("lean16", "b4kf"):
        monkeypatch.setenv("R5C_FWD16", "1")
    jmod = _jax_module("probe_r5c", ["probe_r5c", "1024", family],
                       monkeypatch)
    bench = _bench(monkeypatch, tmp_path / "jax", N_DOCS=1000000,
                   N_QUERIES=2048, N_POSTINGS=400, V_CAP=1024,
                   TILE_OVERFLOW=0, CSUB=2)
    jrec = Recorder(_outs("np"))
    _jax_stubs(monkeypatch, jrec, bench)
    monkeypatch.setattr(jmod, "ROOT", str(tmp_path))
    jbase = os.path.join(bench.CACHE, "index_1000000_30522_400_v1024_o0")
    _touch(os.path.join(bench.CACHE, "gt_1000000_30522_2048.npz"))
    open(jbase + ".knn16.knn.seismic_tpu", "w").close()
    jmod.main()
    faulthandler.cancel_dump_traceback_later()

    trec = Recorder(_outs("torch"))
    _port_stubs(monkeypatch, trec, probe_r5c)
    for var in protocol.ENV.values():
        monkeypatch.delenv(var, raising=False)
    cache = tmp_path / "torch"
    tbase = str(cache / "index_1000000_30522_400_v1024_o0")
    _touch(str(cache / "gt_1000000_30522_2048.npz"))
    open(tbase + ".knn16.knn.seismic_tpu", "w").close()
    rec = str(tmp_path / "r5c.json")
    probe_r5c.main(["1024", family, "--cache-dir", str(cache), "--record",
                    rec, "--device", "cpu"])
    assert trec.events == jrec.events and trec.events
    assert _rows(rec, "rungs_r5_bar") == _rows(
        tmp_path / "SCALE_BENCH.json", "rungs_r5_bar")


def test_r3j_rung_table_matches_jax(tmp_path, monkeypatch):
    """probe_r3j's ladder (qc 10 / 14 x pool 64-512, block_expand E,
    rescore_chunk 1024) on a cached block view equals JAX's."""
    monkeypatch.delenv("B88_N_DOCS", raising=False)
    monkeypatch.delenv("B88_N_POSTINGS", raising=False)
    jmod = _jax_module("probe_r3j", ["probe_r3j", "512"], monkeypatch)
    bench = _bench(monkeypatch, tmp_path / "jax")
    jrec = Recorder(_outs("np"))
    _jax_stubs(monkeypatch, jrec, bench)
    trec = Recorder(_outs("torch"))
    _port_stubs(monkeypatch, trec, probe_r3j)
    for cache, mod in ((tmp_path / "jax", jmod), (tmp_path / "torch", None)):
        base = str(cache / "index88_8800000_30522_3500")
        os.makedirs(base + ".dir")
        os.makedirs(base + ".blockview_v512.dir")
        with open(base + ".blockview_v512.dir.tile_hash", "w") as f:
            f.write(f"0 {int(os.path.getmtime(base + '.dir'))}")
        np.savez(str(cache / "queries88_30522_2048.npz"),
                 q_comps=_queries(2048)[0], q_vals=_queries(2048)[1])
        _touch(str(cache / "gt88_8800000_30522_2048.npz"))
    monkeypatch.setattr(jmod, "CACHE", str(tmp_path / "jax"))
    monkeypatch.setattr(jmod, "ROOT", str(tmp_path))
    jmod.main()
    rec = str(tmp_path / "r3j.json")
    probe_r3j.main(["512", "--cache-dir", str(tmp_path / "torch"),
                    "--record", rec, "--device", "cpu"])
    assert trec.events == jrec.events and len(trec.events) == 8
    assert _rows(rec) == _rows(tmp_path / "SCALE88_BENCH.json")


# ---- the drivers at a cut, on the CPU ----

# the cut: 300 documents and 8 queries over a 400-term vocabulary (at
# 30522 terms every list's 256-row region makes a 4 GB aligned layout)
N_CUT, Q_CUT, DIM_CUT = 300, 8, 400


def _cut_dim(mp):
    """protocol.from_env at the cut's vocabulary, for the drivers."""
    orig = protocol.from_env
    mp.setattr(protocol, "from_env", lambda *a, **k: dataclasses.replace(
        orig(*a, **k), dim=DIM_CUT))


@pytest.fixture(scope="module")
def cut_cache(tmp_path_factory):
    """rebuild_r3_cache's 100k stages at the cut, CPU only (built twice),
    then the ground truth of the cut's queries on the CPU."""
    d = str(tmp_path_factory.mktemp("cache"))
    with pytest.MonkeyPatch.context() as mp:
        _cut_dim(mp)
        mp.setenv("R3_CACHE_CPU_ONLY", "1")
        mp.setenv("BENCH_N_QUERIES", str(Q_CUT))
        args = ["100k", "--n-docs", str(N_CUT), "--cache-dir", d,
                "--device", "cpu"]
        first = rebuild_r3_cache.main(args)
        second = rebuild_r3_cache.main(args)
    p = first["protocol"]
    ds = protocol.get_dataset(p)
    qc, qv = protocol.get_queries(Q_CUT, p.dim)
    protocol.get_ground_truth(ds, qc, qv, p, device="cpu")
    return d, first, second


def test_rebuild_cache_matches_jax_and_builds_once(cut_cache, tmp_path,
                                                   monkeypatch):
    """At the cut, CPU only: the port's files have JAX's names, its
    documents equal JAX's `synth_dataset` and its narrowed dirs JAX's
    `narrow_vocab` of JAX's build; a second run builds nothing."""
    d, first, second = cut_cache
    assert first["built"] == ["docs", "index", "nw512", "nw768"]
    assert second["built"] == []
    monkeypatch.setenv("R3_CACHE_CPU_ONLY", "1")
    jmod = _jax_module("rebuild_r3_cache", ["rebuild_r3_cache", "100k"],
                       monkeypatch)
    bench = _bench(monkeypatch, tmp_path, N_DOCS=N_CUT, N_QUERIES=Q_CUT,
                   DIM=DIM_CUT)
    jmod.main()
    faulthandler.cancel_dump_traceback_later()
    from seismic_tpu.types import IndexArrays as JArrays

    from seismic_tpu_torch.types import IndexArrays

    gt = f"gt_{N_CUT}_{DIM_CUT}_{Q_CUT}.npz"  # written by the fixture
    assert sorted(os.listdir(tmp_path)) == sorted(
        n for n in os.listdir(d) if n != gt and ".aligned_c" not in n)
    docs = f"docs_{N_CUT}_{DIM_CUT}.npz"
    with np.load(os.path.join(d, docs)) as a, \
            np.load(os.path.join(bench.CACHE, docs)) as b:
        for f in ("offsets", "components", "values"):
            np.testing.assert_array_equal(a[f], b[f])
    for W in (512, 768):
        name = f"index_{N_CUT}_{DIM_CUT}_200_v1024_o64_nw{W}.dir"
        ja = JArrays.load_dir(os.path.join(bench.CACHE, name))
        ta = IndexArrays.load_dir(os.path.join(d, name))
        for f in dataclasses.fields(JArrays):
            x = getattr(ja, f.name)
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(np.asarray(getattr(ta, f.name)),
                                              x, err_msg=f"{W} {f.name}")


def test_r5b_new_shapes_run_on_cpu(cut_cache, tmp_path, monkeypatch):
    """probe_r5b's m32 and csub4 families with --device cpu at the cut
    (tiles narrowed to 128 in the driver): every rung written at M 32 and
    csub 4 with its recall, no kernel counted (the wrappers took their
    plain versions)."""
    d, _, _ = cut_cache
    _cut_dim(monkeypatch)
    monkeypatch.setenv("BENCH_N_DOCS", str(N_CUT))
    monkeypatch.setenv("BENCH_N_QUERIES", str(Q_CUT))
    # tiles 128 wide (narrowed here from the v1024 dir: no _nw128 dir)
    monkeypatch.setenv("BENCH_NARROW_V", "128")
    monkeypatch.setattr(probe_r5b, "REPS", 1)
    rec = str(tmp_path / "r5b.json")
    args = ["m32", "csub4", "--cache-dir", d, "--record", rec,
            "--device", "cpu"]
    out = probe_r5b.main(args)
    labels = [r["label"] for r in out["rows"]]
    assert labels == ["m32_hier_qc13_p96r64", "m32_pdt_ddpost_qc13_p96r64",
                      "csub4_hier_qc13_p96r64", "csub4_stride8_qc13_p96r64"]
    for r in out["rows"]:
        assert 0.5 < r["recall_at_10"] <= 1.0, r
        # the wrappers took the plain versions on the CPU: no kernel count
        assert r["launches"] == {}, r
    assert out["rows"][0]["M"] == 32 and out["rows"][2]["csub"] == 4


def test_sweep_names_and_cut_sweep_feed_best_configs(cut_cache, tmp_path,
                                                    monkeypatch):
    """The 12 directory names at batch 2048 equal the committed grid's;
    a cut sweep on the CPU (the narrowed index, 4 queries, two query cuts,
    no graph) writes one directory a combination that best_configs turns
    into TOMLs."""
    names = {sweep_configs.combo_dir(sweep_configs.combo_of(qc, nk, 2048))
             for qc, nk in sweep_configs.combos(True)}
    assert len(sweep_configs.combos(True)) == 12 and len(
        sweep_configs.combos(False)) == 7
    assert names == set(os.listdir(os.path.join(ROOT, "experiments",
                                                "grid_synth")))
    monkeypatch.setattr(sweep_configs, "QUERY_CUTS", (8, 14))
    d, first, _ = cut_cache
    p = first["protocol"]
    # the sweep's queries are 1024 of seed 11, then seed 12: its first 4
    # are those of the protocol's 1024-query stream
    qc, qv = protocol.get_queries(1024, p.dim)
    _, ids = exact_search(protocol.get_dataset(p), qc[:4], qv[:4], k=10,
                          device="cpu")
    gt = str(tmp_path / "gt.npz")
    np.savez(gt, ids=ids)
    grid = str(tmp_path / "grid")
    rows = sweep_configs.main([
        "--index", p.index_base + "_nw512.dir", "--gt", gt,
        "--grid-root", grid, "--batch", "4", "--reps", "1",
        "--device", "cpu"])
    assert [(r["query_cut"], r["n_knn"]) for r in rows] == \
        sweep_configs.combos(False)
    assert sorted(os.listdir(grid)) == sorted(r["dir"] for r in rows)
    assert all(0.5 < r["recall_at_10"] <= 1.0 for r in rows)
    out = str(tmp_path / "best")
    assert best_configs.main([
        "--grid-root", grid, "--base-toml",
        os.path.join(ROOT, "experiments", "best_configs_synth", "base.toml"),
        "--recalls", "0.5", "--output-dir", out]) == 0
    assert any(f.endswith(".toml") for f in os.listdir(out))


def test_r3j_on_cut_cache_and_stale_view(tmp_path, monkeypatch):
    """probe_r3j with --device cpu on build_88m's cut cache: the streaming
    ground truth, the block view (built, then read back), two rungs with
    recall; touching the source directory invalidates the view."""
    cache = str(tmp_path)
    build_88m.build(n_docs=N_CUT, dim=DIM_CUT, n_postings=3500,
                    cache_dir=cache)
    # the first Q_CUT queries under the file name the probe reads
    qpath = os.path.join(cache, f"queries88_{DIM_CUT}_2048.npz")
    with np.load(qpath) as z:
        q = {k: z[k][:Q_CUT] for k in ("q_comps", "q_vals")}
    np.savez(qpath, **q)
    monkeypatch.setenv("B88_N_DOCS", str(N_CUT))
    monkeypatch.setattr(probe_r3j, "DIM", DIM_CUT)
    monkeypatch.setattr(probe_r3j, "B", 2)
    monkeypatch.setattr(probe_r3j, "REPS", 1)
    # two rungs of the ladder (the whole ladder is held to JAX's above)
    monkeypatch.setattr(probe_r3j, "LADDER", ((10, 64, 16), (14, 128, 32)))
    rec = str(tmp_path / "r3j.json")
    out = probe_r3j.main(["512", "--cache-dir", cache, "--record", rec,
                          "--device", "cpu"])
    assert out["view_built"] and len(out["rows"]) == 2
    assert all(0.3 < r["recall_at_10"] <= 1.0 for r in out["rows"])
    assert os.path.exists(os.path.join(cache,
                                       f"gt88_{N_CUT}_{DIM_CUT}_{Q_CUT}.npz"))
    base = os.path.join(cache, f"index88_{N_CUT}_{DIM_CUT}_3500")
    assert probe_r3j.block_view(base, 512)[2] is False
    t = os.path.getmtime(base + ".dir") + 5
    os.utime(base + ".dir", (t, t))
    assert probe_r3j.block_view(base, 512)[2] is True


# ---- the queue ----


def _stages(path):
    """The stage names of a queue script's case table."""
    text = open(path).read()
    body = text[text.index("for s in"):]
    return set(re.findall(r"^\s+([a-z0-9_]+)\)", body, re.M))


def test_queue_script_covers_jax_and_calls_only_the_port(tmp_path):
    """`bash -n` passes; every JAX stage has a port stage; every python
    module invoked is under seismic_tpu_torch; `bench` and an unknown
    stage are logged FAILED with the reason."""
    subprocess.run(["bash", "-n", QUEUE], check=True)
    assert _stages(JAX_QUEUE) <= _stages(QUEUE)
    text = open(QUEUE).read()
    assert "seismic_tpu.harness" not in text.replace(
        "seismic_tpu_torch.harness", "")
    assert not re.search(r"python3? +bench\.py|python3? +-m +(?!\"?"
                         r"seismic_tpu_torch)", text)
    env = dict(os.environ, DEVICE="cpu", LOGDIR=str(tmp_path), TMPDIR=str(
        tmp_path))
    r = subprocess.run(["bash", QUEUE, "bench", "nosuch"], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    log = open(tmp_path / "queue.log").read()
    assert "stage bench: FAILED (the headline benchmark" in log
    assert "stage nosuch: FAILED (unknown stage)" in log
    assert "queue complete" in log


def test_drivers_need_cuda_without_a_device(tmp_path, monkeypatch):
    """With no --device, every driver asks for the card and raises
    without CUDA (before reading any cache)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for mod, args in ((probe_r5b, ["m32"]), (probe_r5c, ["lever"]),
                      (probe_r3j, []), (sweep_configs, [])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main(args + (["--cache-dir", str(tmp_path)]
                             if mod is not sweep_configs else []))
