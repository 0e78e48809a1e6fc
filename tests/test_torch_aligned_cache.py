"""The aligned-tile cache (`ops/tiles_prep.py::load_or_build_aligned`) and
the upload of a layout made beforehand (`IndexArrays.to_device(aligned=
...)`), against the JAX package on the CPU, on a small index from a seed:

- each package's cache reads what the other's wrote (the same directory
  name, files and key), and a hit maps the files;
- a newer file in the index directory rebuilds the cache;
- a write cut off after `tiles.npy` leaves nothing that a later call
  maps, and the call after it builds a whole cache;
- `to_device(aligned=...)` of the layout, of the cached layout and of the
  layout padded with zero rows gives the plain upload's tensors.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from seismic_tpu_torch.ops import tiles_prep
from seismic_tpu_torch.ops.tiles_prep import (
    block_pool_arrays,
    load_or_build_aligned,
    prepare_pallas_tiles,
)
from seismic_tpu_torch.types import IndexArrays
from tests.conftest import make_random_dataset

LAYOUT = dict(max_block_len=16, summary_vocab_cap=128, tile_overflow=8)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A 300-doc index built by the JAX builder and saved as a directory,
    loaded back by the port."""
    pytest.importorskip("jax")
    from seismic_tpu import Configuration, TpuLayout
    from seismic_tpu.build.builder import build_index

    ds = make_random_dataset(np.random.default_rng(0), n_docs=300, dim=600,
                             min_nnz=15, max_nnz=50, seed=42)
    ja = build_index(ds, Configuration(layout=TpuLayout(**LAYOUT)))
    path = str(tmp_path_factory.mktemp("idx") / "index.dir")
    ja.save_dir(path)
    return path, ja, IndexArrays.load_dir(path)


def _cache_dir(path, csub):
    return path[:-4] + f".aligned_c{csub}.dir"


def _same_layout(got, want):
    tiles, scale, region, row_off = got
    np.testing.assert_array_equal(np.asarray(tiles), want[0])
    np.testing.assert_array_equal(np.asarray(scale), want[1])
    np.testing.assert_array_equal(np.asarray(region), want[2])
    if want[3] is None:
        assert row_off is None
    else:
        np.testing.assert_array_equal(row_off, want[3])


@pytest.mark.parametrize("csub,packed", [(1, False), (2, False), (2, True)])
def test_cache_read_across_packages(saved, tmp_path, csub, packed):
    """JAX writes, the port maps it; the port writes, JAX maps it."""
    import shutil

    from seismic_tpu.ops.pallas_tiles import block_pool_arrays as jblock
    from seismic_tpu.ops_pallas_prep import (
        load_or_build_aligned as j_cache,
    )
    from seismic_tpu.ops_pallas_prep import prepare_pallas_tiles as j_prep

    src, ja, ta = saved
    path = str(tmp_path / "index.dir")
    shutil.copytree(src, path)
    if packed:  # a bin-packed block view: row_off is cached too
        ja = jblock(ja, 128, mode="dense", pack_bins=True)
        ta = block_pool_arrays(ta, 128, mode="dense", pack_bins=True)
    want = prepare_pallas_tiles(ta, csub)
    j_want = j_prep(ja, csub)
    # JAX writes, the port reads (a hit: memory-mapped)
    j_cache(ja, path, csub)
    got = load_or_build_aligned(ta, path, csub)
    assert isinstance(got[0].base, np.memmap) or isinstance(got[0], np.memmap)
    _same_layout(got, want)
    # the port writes, JAX reads
    shutil.rmtree(_cache_dir(path, csub))
    _same_layout(load_or_build_aligned(ta, path, csub), want)
    j_got = j_cache(ja, path, csub)
    assert isinstance(j_got[0], np.memmap)
    for a, b in zip(j_got[:3], j_want[:3]):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert (j_got[3] is None) == (j_want[3] is None) == (not packed)
    assert sorted(os.listdir(_cache_dir(path, csub))) == sorted(
        ["meta.json", "region_start.npy", "scale3d.npy", "tiles.npy"]
        + (["row_off.npy"] if packed else []))


def test_newer_index_file_rebuilds(saved, tmp_path, monkeypatch):
    import shutil

    src, _, ta = saved
    path = str(tmp_path / "index.dir")
    shutil.copytree(src, path)
    load_or_build_aligned(ta, path, 1)
    builds = []
    real = tiles_prep.prepare_pallas_tiles
    monkeypatch.setattr(tiles_prep, "prepare_pallas_tiles",
                        lambda *a: builds.append(1) or real(*a))
    load_or_build_aligned(ta, path, 1)
    assert builds == []  # a hit
    f = os.path.join(path, os.listdir(path)[0])
    t = os.path.getmtime(f) + 10.0
    os.utime(f, (t, t))
    got = load_or_build_aligned(ta, path, 1)
    assert builds == [1]  # the key moved: rebuilt
    _same_layout(got, prepare_pallas_tiles(ta, 1))
    load_or_build_aligned(ta, path, 1)
    assert builds == [1]


def test_cut_write_leaves_nothing_mapped(saved, tmp_path, monkeypatch):
    """A write that breaks off after `tiles.npy`: the cache directory holds
    no file of it and no `meta.json`, the temporary directory is gone,
    and the next call builds and writes a whole cache."""
    import shutil

    src, _, ta = saved
    path = str(tmp_path / "index.dir")
    shutil.copytree(src, path)
    real_save = np.save
    calls = []

    def cut(file, a, *args, **kw):
        calls.append(os.path.basename(str(file)))
        if len(calls) > 1:
            raise OSError("disk full")
        return real_save(file, a, *args, **kw)

    monkeypatch.setattr(tiles_prep.np, "save", cut)
    with pytest.raises(OSError, match="disk full"):
        load_or_build_aligned(ta, path, 1)
    monkeypatch.setattr(tiles_prep.np, "save", real_save)
    assert calls[0] == "tiles.npy"
    d = _cache_dir(path, 1)
    assert os.listdir(d) == []
    assert [n for n in os.listdir(tmp_path) if ".tmp" in n] == []
    got = load_or_build_aligned(ta, path, 1)
    _same_layout(got, prepare_pallas_tiles(ta, 1))
    assert "meta.json" in os.listdir(d)
    _same_layout(load_or_build_aligned(ta, path, 1),
                 prepare_pallas_tiles(ta, 1))


def _tensors(dev_index):
    return {f.name: getattr(dev_index, f.name)
            for f in dataclasses.fields(dev_index)}


@pytest.mark.parametrize("csub", [1, 2])
def test_upload_of_aligned_equals_plain_upload(saved, tmp_path, csub):
    import shutil

    src, _, ta = saved
    path = str(tmp_path / "index.dir")
    shutil.copytree(src, path)
    plain = _tensors(ta.to_device("cpu", tile_csub=csub))
    load_or_build_aligned(ta, path, csub)
    layout = prepare_pallas_tiles(ta, csub)
    tiles, scale, region, row_off = layout
    extra = 3 * 128 * csub
    padded = (np.concatenate([tiles, np.zeros((extra, tiles.shape[1]),
                                              np.uint8)]),
              np.concatenate([scale, np.zeros(extra, np.float32)]),
              region, row_off)
    for name, lay in (("built", layout),
                      ("cached", load_or_build_aligned(ta, path, csub)),
                      ("padded", padded)):
        got = _tensors(ta.to_device("cpu", tile_csub=csub, aligned=lay))
        assert got.keys() == plain.keys()
        for f, want in plain.items():
            g = got[f]
            if f in ("doc_tiles_aligned", "tile_scale") and name == "padded":
                assert not g[want.shape[0]:].any(), (name, f)
                g = g[:want.shape[0]]
            if torch.is_tensor(want):
                assert torch.equal(g, want), (name, f)
            else:
                assert g == want, (name, f)
    with pytest.raises(ValueError, match="aligned"):
        ta.to_device("cpu", aligned=(tiles.view(np.int8), scale, region))
