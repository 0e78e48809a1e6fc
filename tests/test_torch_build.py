"""seismic_tpu_torch host side: the index build, the aligned tile layout,
the planner and the on-disk formats against the JAX package, and the
port's import isolation (no JAX, nothing of seismic_tpu)."""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from seismic_tpu_torch import (
    Configuration as TConfiguration,
    CsrDataset as TCsrDataset,
    IndexArrays as TIndexArrays,
    from_jax_arrays,
)
from seismic_tpu_torch.build.builder import build_index as t_build_index
from seismic_tpu_torch.data.sparse import pad_queries as t_pad_queries
from seismic_tpu_torch.device import resolve_device
from seismic_tpu_torch.ops.tiles_prep import prepare_pallas_tiles
from seismic_tpu_torch.search.planner import (
    PlannerContext as TPlannerContext,
    plan_grouped_numpy as t_plan_grouped,
)
from tests.conftest import make_random_dataset, make_random_queries

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "seismic_tpu_torch")


def _jax_config():
    from seismic_tpu import Configuration, TpuLayout

    return Configuration(layout=TpuLayout(max_block_len=16,
                                          summary_vocab_cap=256,
                                          tile_overflow=16))


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(0)
    return make_random_dataset(rng, n_docs=400, dim=600, min_nnz=15,
                               max_nnz=50, seed=42)


def _port_dataset(ds):
    return TCsrDataset(ds.offsets, ds.components, ds.values, ds.dim)


def _assert_arrays_equal(ja, ta):
    for f in dataclasses.fields(ja):
        a, b = getattr(ja, f.name), getattr(ta, f.name)
        if f.name == "config":
            assert (a is None) == (b is None)
            if a is not None:
                assert a.to_dict() == b.to_dict()
        elif isinstance(a, np.ndarray):
            assert isinstance(b, np.ndarray), f.name
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert np.array_equal(a, b), f.name
        else:
            assert a == b, (f.name, a, b)


@pytest.mark.parametrize("value_dtype,native", [("f16", True),
                                                ("f32", False)])
def test_build_matches_jax(dataset, value_dtype, native):
    """The port's build_index gives the JAX build's arrays, field by field,
    exactly (native C++ core and NumPy pipeline)."""
    pytest.importorskip("jax")
    from seismic_tpu.build.builder import build_index

    cfg = _jax_config()
    ja = build_index(dataset, cfg, value_dtype=value_dtype, native=native)
    ta = t_build_index(_port_dataset(dataset),
                       TConfiguration.from_dict(cfg.to_dict()),
                       value_dtype=value_dtype, native=native)
    _assert_arrays_equal(ja, ta)


@pytest.fixture(scope="module")
def built(dataset):
    pytest.importorskip("jax")
    from seismic_tpu.build.builder import build_index

    ja = build_index(dataset, _jax_config(), value_dtype="f16")
    ta = from_jax_arrays({f.name: getattr(ja, f.name)
                          for f in dataclasses.fields(ja)})
    return ja, ta


def test_from_jax_arrays_carries_every_field(built):
    ja, ta = built
    _assert_arrays_equal(ja, ta)
    # the dataclasses.asdict form (config as a dict) works too
    _assert_arrays_equal(ja, from_jax_arrays(dataclasses.asdict(ja)))


def test_aligned_tiles_match_jax(built):
    from seismic_tpu.ops_pallas_prep import prepare_pallas_tiles as j_prep

    ja, ta = built
    tiles_i8, scale3d, region_j, row_off = j_prep(ja, 1)
    tiles, scale, region, t_row_off = prepare_pallas_tiles(ta, 1)
    assert row_off is None and t_row_off is None
    assert tiles.dtype == np.uint8
    assert np.array_equal(tiles, tiles_i8.view(np.uint8))
    # the TPU's [n_sub, 8, 128] replicated scale is one row per tile row
    assert np.array_equal(scale, scale3d[:, 0, :].reshape(-1))
    assert np.array_equal(region, region_j)


def test_planner_matches_jax(built):
    from seismic_tpu.search.planner import (
        PlannerContext,
        plan_grouped_numpy,
    )

    ja, ta = built
    qc, qv = make_random_queries(np.random.default_rng(1), n_queries=16,
                                 dim=600, min_nnz=8, max_nnz=30)
    q_comps, q_vals = t_pad_queries(qc, qv, 64)
    jctx = PlannerContext.from_arrays(ja)
    tctx = TPlannerContext.from_arrays(ta)
    for f in dataclasses.fields(jctx):
        a, b = getattr(jctx, f.name), getattr(tctx, f.name)
        assert np.array_equal(np.asarray(a), np.asarray(b)), f.name
    jp = plan_grouped_numpy(q_comps, q_vals, jctx, 10, M=8)
    tp = t_plan_grouped(q_comps, q_vals, tctx, 10, M=8)
    for f in dataclasses.fields(jp):
        assert np.array_equal(np.asarray(getattr(jp, f.name)),
                              np.asarray(getattr(tp, f.name))), f.name


def test_save_load_roundtrip(built, tmp_path):
    """`save`/`load` (npz) and `save_dir`/`load_dir` (mmap) keep every
    field, and the JAX package reads what the port writes."""
    from seismic_tpu.types import IndexArrays as JIndexArrays

    ja, ta = built
    p = ta.save(str(tmp_path / "idx"))
    _assert_arrays_equal(ja, TIndexArrays.load(p))
    _assert_arrays_equal(ja, JIndexArrays.load(p))
    d = ta.save_dir(str(tmp_path / "idx.dir"))
    _assert_arrays_equal(ja, TIndexArrays.load_dir(d, mmap=False))


def test_pad_queries_matches_jax():
    pytest.importorskip("jax")
    from seismic_tpu.search.engine import pad_queries

    qc, qv = make_random_queries(np.random.default_rng(5), n_queries=9,
                                 dim=300, min_nnz=3, max_nnz=40)
    for pad in (16, 64):
        a = pad_queries(qc, qv, pad)
        b = t_pad_queries(qc, qv, pad)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def _port_sources():
    """(module name, source path) of every module of the port."""
    out = []
    root_dir = os.path.dirname(PKG)
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                path = os.path.join(root, f)
                mod = os.path.relpath(path, root_dir)[:-3].replace(os.sep, ".")
                out.append((mod.removesuffix(".__init__"), path))
    return sorted(out)


def test_port_imports_no_jax_and_no_seismic_tpu():
    """Every module of the port, imported in a fresh interpreter, loads
    neither jax nor any module of seismic_tpu; and no source names them
    in an import statement."""
    sources = _port_sources()
    mods = [m for m, _ in sources]
    for m in ("api", "data.io", "search.exact", "search.knn",
              "build.convert", "search.flat", "ops.sketch",
              "parallel.mesh", "parallel.sharded", "harness.dryrun",
              "harness.bench_sharded"):
        assert f"seismic_tpu_torch.{m}" in mods, m
    for mod, path in sources:
        with open(path) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "seismic_tpu"), (mod, n)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'seismic_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=os.path.dirname(PKG), env=env)
    assert r.returncode == 0, r.stdout + r.stderr


def test_default_device_is_the_card():
    """device=None means cuda; without CUDA it raises instead of falling
    back to the CPU. The CPU is used only when asked for."""
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(None)
