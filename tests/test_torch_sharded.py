"""Document-sharded search (`seismic_tpu_torch/parallel`) against the JAX
package's `seismic_tpu/parallel` on the CPU: the collection of
`tests/test_sharded.py` (320 docs, dim 500, 8 queries), the port's meshes
of `devices=["cpu"] * n` beside JAX's meshes over the 8 virtual devices.

- `pad_shards_to_common_shapes` equals JAX's array for array;
- the engine route (heap_factor 0, and 0.8 in tiles mode), the grouped
  route on a 1x4 and a 2x2 mesh and the block route (`tile_block`) meet
  the repo's gate against JAX's `ShardedIndex` (id sets on >= 98% of the
  queries, scores to 1e-3 relative);
- `merge_topk_across_docs` equals a NumPy lexsort on ties, -1 slots and
  -inf scores;
- 2 and 4 shards agree; save / load round-trips, across the packages
  too; a wrong shard count raises; a threaded build equals a sequential
  one; `build_knn` builds each shard's graph and refinement keeps recall;
- two processes of a gloo group: the cross-process merge against the
  NumPy oracle, and a search over a mesh that spans them equal to one
  process's;
- `harness/dryrun.py` on the CPU: all four stages.
"""

import dataclasses
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from seismic_tpu_torch import Configuration, TpuLayout
from seismic_tpu_torch.data.sparse import CsrDataset, pad_queries
from seismic_tpu_torch.parallel.mesh import make_mesh
from seismic_tpu_torch.parallel.sharded import (
    ShardedIndex,
    merge_topk_across_docs,
    pad_shards_to_common_shapes,
)
from seismic_tpu_torch.search.engine import SearchParams
from seismic_tpu_torch.search.exact import exact_search_numpy
from seismic_tpu_torch.search.grouped import GroupedParams
from tests.conftest import make_random_dataset, make_random_queries

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUT = dict(max_block_len=16, summary_vocab_cap=256, max_doc_nnz=64)
ENGINE = (dict(k=10, query_cut=10, block_budget=0), 0.0), (
    dict(k=10, query_cut=10, doc_mode="tiles", full_lists=True), 0.8)
GROUPED = dict(k=10, score_cut=64, pool=64, rescore=32, compute_dtype="f32",
               pool_mode="exact")
BLOCK = dict(k=10, score_cut=64, pool=16, block_expand=16,
             compute_dtype="i8", pool_mode="exact")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    ds = make_random_dataset(rng, n_docs=320, dim=500, min_nnz=12,
                             max_nnz=40, seed=123)
    qc, qv = make_random_queries(np.random.default_rng(2), n_queries=8,
                                 dim=500)
    q_comps, q_vals = pad_queries(qc, qv, 64)
    port_ds = CsrDataset(ds.offsets, ds.components, ds.values, ds.dim)
    cfg = Configuration(layout=TpuLayout(**LAYOUT))
    return ds, port_ds, cfg, q_comps, q_vals


def _cpu_mesh(n_docs, n_data=1):
    return make_mesh(n_docs, n_data, devices=["cpu"] * (n_docs * n_data))


@pytest.fixture(scope="module")
def both(setup):
    """{name: (JAX ShardedIndex, the port's)}: mesh 1x4 and 2x2 with the
    aligned layouts, and 1x4 on the block view (tile_block=128); each
    built once."""
    pytest.importorskip("jax")
    from seismic_tpu import Configuration as JConfig, TpuLayout as JLayout
    from seismic_tpu.parallel.mesh import make_mesh as jmesh
    from seismic_tpu.parallel.sharded import ShardedIndex as JSharded

    ds, pds, cfg, _, _ = setup
    jcfg = JConfig(layout=JLayout(**LAYOUT))
    out = {}
    for name, (n_data, n_docs, tb) in {"1x4": (1, 4, 0), "2x2": (2, 2, 0),
                                       "block": (1, 4, 128)}.items():
        out[name] = (
            JSharded.build(ds, jmesh(n_docs_shards=n_docs, n_data=n_data),
                           jcfg, pallas_tiles=True, tile_block=tb),
            ShardedIndex.build(pds, _cpu_mesh(n_docs, n_data), cfg,
                               pallas_tiles=True, tile_block=tb))
    return out


def _gate(s_t, i_t, s_j, i_j):
    """id sets equal on >= 98% of the queries, scores to 1e-3 relative."""
    same = np.mean([set(a[a >= 0].tolist()) == set(b[b >= 0].tolist())
                    for a, b in zip(i_t, np.asarray(i_j))])
    assert same >= 0.98, same
    s_j = np.asarray(s_j)
    fin = np.isfinite(s_j)
    assert (np.isfinite(s_t) == fin).all()
    np.testing.assert_allclose(np.sort(s_t, axis=1)[fin],
                               np.sort(s_j, axis=1)[fin], rtol=1e-3)
    assert (i_t >= 0).any()


def test_pad_shards_matches_jax(setup):
    from seismic_tpu.build.builder import build_index
    from seismic_tpu.parallel.sharded import (
        pad_shards_to_common_shapes as jpad,
    )

    from seismic_tpu_torch import from_jax_arrays

    ds, _, _, _, _ = setup
    from seismic_tpu import Configuration as JConfig, TpuLayout as JLayout

    bounds = np.linspace(0, len(ds), 4).astype(np.int64)
    jshards = [build_index(ds.subset(np.arange(bounds[s], bounds[s + 1])),
                           JConfig(layout=JLayout(**LAYOUT)))
               for s in range(3)]
    jshards[1].knn = np.zeros((jshards[1].n_docs, 3), np.int32)
    carried = [from_jax_arrays({f.name: getattr(a, f.name)
                                for f in dataclasses.fields(a)})
               for a in jshards]
    got, want = pad_shards_to_common_shapes(carried), jpad(jshards)
    for g, w in zip(got, want):
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name, None), getattr(w, f.name)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=f.name)
                assert a.dtype == b.dtype, f.name
            elif f.name != "config":
                assert a == b, f.name


@pytest.mark.parametrize("case", ["engine", "grouped_1x4", "grouped_2x2",
                                  "block"])
def test_sharded_routes_match_jax(setup, both, case):
    from seismic_tpu.search.engine import SearchParams as JParams
    from seismic_tpu.search.grouped import GroupedParams as JGrouped

    _, _, _, q_comps, q_vals = setup
    if case == "engine":
        jix, tix = both["1x4"]
        for kw, hf in ENGINE:
            _gate(*tix.search_batch(q_comps, q_vals, SearchParams(**kw), hf),
                  *jix.search_batch(q_comps, q_vals, JParams(**kw), hf))
        return
    kw = BLOCK if case == "block" else GROUPED
    jix, tix = both[case.split("_")[-1]]
    _gate(*tix.search_batch_grouped(q_comps, q_vals, GroupedParams(**kw),
                                    query_cut=8),
          *jix.search_batch_grouped(q_comps, q_vals, JGrouped(**kw),
                                    query_cut=8))


def test_merge_equals_lexsort():
    """Ties across shards go to the smaller global id, -1 slots after
    every id, -inf scores last."""
    rng = np.random.default_rng(7)
    S, B, K = 5, 16, 6
    scores = rng.integers(0, 4, (S, B, K)).astype(np.float32) / 2
    gids = rng.choice(10000, (S, B, K)).astype(np.int64)
    empty = rng.random((S, B, K)) < 0.2
    gids[empty] = -1
    scores[empty] = -np.inf
    scores[0, 0, :3] = -np.inf  # -inf with a real id
    ms, mi = merge_topk_across_docs(torch.from_numpy(scores),
                                    torch.from_numpy(gids))
    flat_s = scores.transpose(1, 0, 2).reshape(B, S * K)
    flat_i = gids.transpose(1, 0, 2).reshape(B, S * K)
    key = np.where(flat_i >= 0, flat_i, 2 ** 62)
    for b in range(B):
        order = np.lexsort((key[b], -flat_s[b]))[:K]
        np.testing.assert_array_equal(ms[b].numpy(), flat_s[b][order])
        np.testing.assert_array_equal(mi[b].numpy(), flat_i[b][order])
    assert mi.dtype == torch.int64


def test_two_and_four_shards_agree(setup, both):
    """As `test_sharded.py:50-63`: the merge's tie order keeps 2- and
    4-shard results alike, and with full budgets they cover the exact
    top-10."""
    _, pds, cfg, q_comps, q_vals = setup
    params = SearchParams(k=10, query_cut=10, block_budget=0)
    s2, i2 = ShardedIndex.build(pds, _cpu_mesh(2), cfg).search_batch(
        q_comps, q_vals, params, heap_factor=0.0)
    s4, i4 = both["1x4"][1].search_batch(q_comps, q_vals, params,
                                         heap_factor=0.0)
    np.testing.assert_allclose(s2, s4, atol=1e-4)
    assert (i2 == i4).mean() > 0.95
    _, gt = exact_search_numpy(pds, q_comps, q_vals, k=10)
    hits = sum(len(set(r[r >= 0].tolist()) & set(g[g >= 0].tolist()))
               for r, g in zip(i4, gt))
    assert hits / gt.size >= 0.95


def test_save_load_across_packages(setup, both, tmp_path):
    """The port's save loads back to the same results; the port loads
    JAX's saved index to its own results, and JAX loads the port's to
    JAX's arrays and results."""
    from seismic_tpu.parallel.sharded import ShardedIndex as JSharded
    from seismic_tpu.search.engine import SearchParams as JParams

    _, _, _, q_comps, q_vals = setup
    jix, tix = both["1x4"]
    kw, hf = ENGINE[0]
    want = tix.search_batch(q_comps, q_vals, SearchParams(**kw), hf)
    tix.save(str(tmp_path / "port"))
    jix.save(str(tmp_path / "jax"))
    for src in ("port", "jax"):
        loaded = ShardedIndex.load(str(tmp_path / src), tix.mesh,
                                   pallas_tiles=True)
        assert (loaded.n_shards, loaded.total_docs) == (4, 320)
        assert loaded.doc_offsets == tix.doc_offsets
        got = loaded.search_batch(q_comps, q_vals, SearchParams(**kw), hf)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
    # a load pads the shards again (each load adds a max_list_len tail),
    # so JAX's load of the port's files is held to its load of its own
    j_port, j_own = (JSharded.load(str(tmp_path / src), jix.mesh,
                                   pallas_tiles=True)
                     for src in ("port", "jax"))
    for a, b in zip(j_port.host_shards, j_own.host_shards):
        for f in ("fwd_comps", "fwd_vals", "postings", "doc_tiles",
                  "list_vocab", "block_start", "dense_summary"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    s_j, i_j = j_port.search_batch(q_comps, q_vals, JParams(**kw), hf)
    s_o, i_o = j_own.search_batch(q_comps, q_vals, JParams(**kw), hf)
    np.testing.assert_array_equal(np.asarray(i_j), np.asarray(i_o))
    _gate(*want, s_j, i_j)


def test_load_wrong_mesh_raises(setup, tmp_path):
    _, pds, cfg, _, _ = setup
    ShardedIndex.build(pds, _cpu_mesh(2), cfg).save(str(tmp_path / "ix"))
    with pytest.raises(ValueError, match="shards"):
        ShardedIndex.load(str(tmp_path / "ix"), _cpu_mesh(4))


def test_threaded_build_matches_sequential(setup):
    _, pds, cfg, q_comps, q_vals = setup
    params = SearchParams(k=10, query_cut=10, block_budget=0)
    out = [ShardedIndex.build(pds, _cpu_mesh(2), cfg, n_workers=w)
           .search_batch(q_comps, q_vals, params, heap_factor=0.0)
           for w in (1, 2)]
    np.testing.assert_array_equal(out[0][1], out[1][1])
    np.testing.assert_array_equal(out[0][0], out[1][0])


def test_build_knn_within_shards(setup):
    """Each shard's graph points inside its shard, is set on every upload
    of the shard (mesh 2x2: two rows), and refined search keeps recall."""
    _, pds, cfg, q_comps, q_vals = setup
    ix = ShardedIndex.build(pds, _cpu_mesh(2, 2), cfg, pallas_tiles=True)
    gp = GroupedParams(**GROUPED)
    _, i0 = ix.search_batch_grouped(q_comps, q_vals, gp, query_cut=8)
    ix.build_knn(nknn=4, batch_size=64)
    bounds = ix.doc_offsets + [ix.total_docs]
    for s, shard in enumerate(ix.host_shards):
        n = bounds[s + 1] - bounds[s]
        g = shard.knn[:n]
        assert ((g >= -1) & (g < n)).all() and (g >= 0).any()
        for row in ix.device_index:
            assert torch.equal(row[s].knn, torch.from_numpy(shard.knn))
    _, i1 = ix.search_batch_grouped(
        q_comps, q_vals, GroupedParams(**dict(GROUPED, n_knn=4)),
        query_cut=8)
    _, gt = exact_search_numpy(pds, q_comps, q_vals, k=10)

    def recall(ids):
        return sum(len(set(r[r >= 0].tolist()) & set(g[g >= 0].tolist()))
                   for r, g in zip(ids, gt)) / gt.size

    assert recall(i1) >= recall(i0) - 1e-9


_WORKER = r'''
import sys
pid, port, root = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, root)
import numpy as np
import torch
import torch.distributed as dist

from seismic_tpu_torch import Configuration, TpuLayout
from seismic_tpu_torch.data.sparse import CsrDataset, pad_queries
from seismic_tpu_torch.harness.synth import synth_dataset, synth_queries
from seismic_tpu_torch.parallel.mesh import (
    init_distributed, make_mesh, make_mesh_global)
from seismic_tpu_torch.parallel.sharded import (
    ShardedIndex, _gather_cells, merge_topk_across_docs)
from seismic_tpu_torch.search.engine import SearchParams

assert init_distributed(f"localhost:{port}", 2, pid, device="cpu")
assert dist.get_backend() == "gloo"
mesh = make_mesh_global(n_docs_shards=4, devices=["cpu", "cpu"])
assert mesh.ranks == ((0, 0, 1, 1),), mesh.ranks
S, B, K = 4, 8, 5
def shard(s):
    base = (s * 131.0) % 17.0
    sc = (base + np.arange(B, dtype=np.float32)[:, None] * 0.5
          + np.arange(K, dtype=np.float32)[None, ::-1])
    gi = s * 1000 + np.arange(B)[:, None] * 10 + np.arange(K)[None, :]
    return sc.astype(np.float32), gi.astype(np.int64)
mine = {(0, s): tuple(torch.from_numpy(a) for a in shard(s))
        for s in range(S) if mesh.is_local(0, s)}
assert len(mine) == 2
cells = _gather_cells(mine, mesh, B, K)
ms, mi = merge_topk_across_docs(
    torch.stack([cells[(0, s)][0] for s in range(S)]),
    torch.stack([cells[(0, s)][1] for s in range(S)]))
flat_s = np.stack([shard(s)[0] for s in range(S)]).transpose(1, 0, 2).reshape(B, -1)
flat_i = np.stack([shard(s)[1] for s in range(S)]).transpose(1, 0, 2).reshape(B, -1)
for b in range(B):
    order = np.lexsort((flat_i[b], -flat_s[b]))[:K]
    assert np.array_equal(ms[b].numpy(), flat_s[b][order]), b
    assert np.array_equal(mi[b].numpy(), flat_i[b][order]), b
# a search over the two processes' shards equals one process's
ds = synth_dataset(400, dim=800, mean_nnz=30, std_nnz=8, max_nnz=60, seed=3)
qc, qv = synth_queries(8, dim=800, mean_nnz=12, std_nnz=4, max_nnz=24, seed=4)
q_comps, q_vals = pad_queries(qc, qv, 32)
cfg = Configuration(layout=TpuLayout(max_block_len=16, summary_vocab_cap=128))
params = SearchParams(k=10, query_cut=8, block_budget=0)
spread = ShardedIndex.build(ds, mesh, cfg)
assert sum(x is not None for x in spread.device_index[0]) == 2
s1, i1 = spread.search_batch(q_comps, q_vals, params, heap_factor=0.0)
local = ShardedIndex.build(ds, make_mesh(4, devices=["cpu"] * 4), cfg)
s0, i0 = local.search_batch(q_comps, q_vals, params, heap_factor=0.0)
assert np.array_equal(i0, i1) and np.array_equal(s0, s1)
assert (i1 >= 0).all()
dist.destroy_process_group()
print(f"proc {pid}: cross-process merge ok")
'''


def test_two_process_gloo_merge(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(textwrap.dedent(_WORKER))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(pid), str(port), ROOT],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert "cross-process merge ok" in out


def test_dryrun_stages_on_cpu(capsys):
    from seismic_tpu_torch.harness.dryrun import STAGES, dryrun_multichip

    lines = dryrun_multichip(4, device="cpu")
    assert len(lines) == len(STAGES) == 4
    assert all(" ok: " in ln for ln in lines)
    assert "88m-recipe ok" in lines[1] and "balance_max_over_mean" in lines[1]
    assert "done: 4/4 stages" in capsys.readouterr().out
