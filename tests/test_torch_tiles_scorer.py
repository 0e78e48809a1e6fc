"""seismic_tpu_torch K7, the per-pair doc-tile scorer: the plain PyTorch
version against the JAX package's Pallas kernel run in interpret mode (as
the JAX package runs it off the TPU) on the same inputs made with numpy
from a seed; the wrapper's CPU contract; the naming of the kernel
libraries; and, on a machine with an NVIDIA card only, the CUDA kernel
against its plain version.

Tolerance: 1e-6 relative on the rows inside each list (u8 codes times
non-negative f32 projections, up to 256 terms, summed in another order);
the rows past a list's length are the caller's to mask and are compared
only where both versions define them."""

import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch

from seismic_tpu_torch import from_jax_arrays
from seismic_tpu_torch.ops import _cuda, tiles_scorer
from seismic_tpu_torch.ops.tiles_prep import SUB, ll_pad_for
from tests.conftest import make_random_dataset

N_PAIRS = 24  # a multiple of the TPU kernel's 8-pair group


@pytest.fixture(scope="module")
def setup():
    """The fixture of tests/test_tiles.py with longer lists (several
    128-row subtiles in the longest), random pairs and projections."""
    pytest.importorskip("jax")
    from seismic_tpu import Configuration, TpuLayout
    from seismic_tpu.build.builder import build_index

    ds = make_random_dataset(np.random.default_rng(0), n_docs=400, dim=60,
                             min_nnz=15, max_nnz=30, seed=42)
    cfg = Configuration(layout=TpuLayout(max_block_len=16,
                                         summary_vocab_cap=256))
    ja = build_index(ds, cfg)
    ta = from_jax_arrays({f.name: getattr(ja, f.name)
                          for f in dataclasses.fields(ja)})
    rng = np.random.default_rng(5)
    lists = rng.integers(0, ta.n_lists, size=N_PAIRS).astype(np.int32)
    lists[0] = int(np.argmax(ta.list_len))  # the longest list
    lists[1] = int(np.argmin(ta.list_len))
    V = ta.doc_tiles.shape[1]
    qloc = (rng.gamma(2.0, 1.0, size=(N_PAIRS, V))
            * (rng.random((N_PAIRS, V)) < 0.2)).astype(np.float32)
    return ja, ta, lists, qloc


def _port_args(ta, lists, qloc):
    index = ta.to_device("cpu")
    rs = index.list_region_start[torch.from_numpy(lists).long()]
    return (index.doc_tiles_aligned, index.tile_scale, rs.contiguous(),
            torch.from_numpy(qloc)), index.list_len[
                torch.from_numpy(lists).long()].contiguous()


def test_k7_score_tiles_matches_jax(setup):
    import jax.numpy as jnp
    from seismic_tpu.ops.pallas_tiles import score_tiles_pallas
    from seismic_tpu.ops_pallas_prep import prepare_pallas_tiles

    ja, ta, lists, qloc = setup
    ll_pad = ll_pad_for(ja.max_list_len)
    assert ll_pad >= 2 * SUB  # more than one subtile per pair
    tiles_i8, scale3d, region_start = prepare_pallas_tiles(ja, 1)[:3]
    j_out = np.asarray(score_tiles_pallas(
        jnp.asarray(tiles_i8), jnp.asarray(scale3d),
        jnp.asarray(region_start[lists].astype(np.int32)),
        jnp.asarray(qloc), ll_pad, interpret=True))
    args, pair_len = _port_args(ta, lists, qloc)
    before = tiles_scorer.launches
    t_all = tiles_scorer.score_tiles(
        *args, torch.full_like(pair_len, ll_pad), ll_pad).numpy()
    t_len = tiles_scorer.score_tiles(*args, pair_len, ll_pad).numpy()
    assert tiles_scorer.launches == before  # CPU tensors: the plain version
    assert t_all.shape == j_out.shape == (N_PAIRS, ll_pad)
    # pair_len = ll_pad: every row, as the TPU kernel scores them
    np.testing.assert_allclose(t_all, j_out, rtol=1e-6, atol=0)
    # the lists' lengths: the rows inside each list agree, the subtiles
    # past the list are 0, the rest of the last subtile is scored as before
    for p, n in enumerate(pair_len.tolist()):
        np.testing.assert_allclose(t_len[p, :n], j_out[p, :n], rtol=1e-6,
                                   atol=0)
        done = -(-n // SUB) * SUB
        np.testing.assert_array_equal(t_len[p, :done], t_all[p, :done])
        assert (t_len[p, done:] == 0).all()
    inside = np.arange(ll_pad) < pair_len.numpy()[:, None]
    assert (j_out[inside] > 0).mean() > 0.5  # not trivially empty


@pytest.mark.parametrize("fault", ["tiles_dtype", "scale_shape",
                                   "region_dtype", "qloc_shape", "ll_pad",
                                   "pair_len_shape"])
def test_score_tiles_checks_its_operands(fault):
    """Wrong dtypes or shapes are refused before any launch."""
    tiles = torch.zeros((256, 32), dtype=torch.uint8)
    scale = torch.zeros(256)
    rs = torch.zeros(3, dtype=torch.int32)
    qloc = torch.zeros((3, 32))
    kw = {"ll_pad": 128, "pair_len": torch.zeros(3, dtype=torch.int32)}
    if fault == "tiles_dtype":
        tiles = tiles.to(torch.int8)
    elif fault == "scale_shape":
        scale = scale[:100]
    elif fault == "region_dtype":
        rs = rs.long()
    elif fault == "qloc_shape":
        qloc = qloc[:, :16]
    elif fault == "ll_pad":
        kw["ll_pad"] = 100
    else:
        kw["pair_len"] = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        tiles_scorer.score_tiles(tiles, scale, rs, qloc, **kw)


def test_kernel_library_named_by_source_and_flags():
    """A kernel library's file name changes with its source and with the
    compiler flags, and with nothing else (not with file times)."""
    base = _cuda.lib_name("k", b"__global__ void f() {}", ["-O3"])
    assert base == _cuda.lib_name("k", b"__global__ void f() {}", ["-O3"])
    assert base.startswith("libk-") and base.endswith(".so")
    assert base != _cuda.lib_name("k", b"__global__ void g() {}", ["-O3"])
    assert base != _cuda.lib_name("k", b"__global__ void f() {}", ["-O2"])
    assert base != _cuda.lib_name("j", b"__global__ void f() {}", ["-O3"])
    # every kernel of the package has a source, and a path that carries
    # the hash of that source and of the csrc headers it includes
    for name in _cuda.KERNELS:
        hashed = _cuda.source_with_headers(_cuda._src(name))
        with open(_cuda._src(name), "rb") as f:
            assert hashed.startswith(f.read())
        want = _cuda.lib_name(name, hashed, _cuda.NVCC_FLAGS)
        assert _cuda.lib_path(name).endswith(want)
    # a shared header enters the name of every library that includes it
    def header(name):
        with open(os.path.join(_cuda.CSRC, name), "rb") as f:
            return f.read()

    pack, mma = (header(h) for h in (
        "pack_epilogue.cuh", "grouped_i8_mma.cuh"))
    for name in ("grouped_scorer", "grouped_scorer_item", "grouped_scorer_f"):
        hashed = _cuda.source_with_headers(_cuda._src(name))
        assert pack in hashed, name
        assert mma in hashed, name
    assert mma in _cuda.source_with_headers(_cuda._src("tiles_scorer"))
    assert pack not in _cuda.source_with_headers(_cuda._src("rescore"))
    assert "tiles_scorer" in _cuda.KERNELS
    # K9 is a variant of K1's kernel, in K1's library with its term table;
    # K17 (the probe library) takes the tile body's bf16 mma
    assert "qloc_residue" not in _cuda.KERNELS
    assert header("term_table.cuh") in _cuda.source_with_headers(
        _cuda._src("qloc"))
    assert mma in _cuda.source_with_headers(_cuda._src("device_probe"))
    # headers of headers too, each once
    with tempfile.TemporaryDirectory() as d:
        for fname, text in (("k.cu", b'#include "a.cuh"\n#include "b.cuh"\n'),
                            ("a.cuh", b'#include "b.cuh"\nint a;\n'),
                            ("b.cuh", b"int b;\n")):
            with open(os.path.join(d, fname), "wb") as f:
                f.write(text)
        hashed = _cuda.source_with_headers(os.path.join(d, "k.cu"))
        assert hashed.count(b"int a;") == 1 and hashed.count(b"int b;") == 1


@pytest.mark.cuda
def test_cuda_score_tiles_matches_plain(setup):
    """On the card: the CUDA kernel against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    ja, ta, lists, qloc = setup
    dev = torch.device("cuda")
    args, pair_len = _port_args(ta, lists, qloc)
    args = tuple(a.to(dev) for a in args)
    ll_pad = ll_pad_for(ta.max_list_len)
    for pl in (torch.full_like(pair_len, ll_pad), pair_len):
        torch.testing.assert_close(
            tiles_scorer.score_tiles(*args, pl.to(dev), ll_pad),
            tiles_scorer.score_tiles_plain(*args, pl.to(dev), ll_pad),
            rtol=1e-5, atol=0)
