"""The microbench's torch expressions against the JAX expressions of
`seismic_tpu/harness/microbench.py`, on the same numpy inputs at small
sizes; and one small run of the whole microbench on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seismic_tpu_torch.harness import microbench as mb

DIM = 700


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return dict(
        table=rng.normal(size=(300, 16)).astype(np.float32),
        rows=rng.integers(0, 300, size=50, dtype=np.int32),
        qd=rng.normal(size=DIM).astype(np.float32),
        eidx=rng.integers(0, DIM, size=200, dtype=np.int32),
        qd_b=rng.normal(size=(6, DIM)).astype(np.float32),
        idx_b=rng.integers(0, DIM, size=(6, 40), dtype=np.int32),
        # few ids, so that compares match and queries repeat ids
        comps=rng.integers(0, 40, size=(3, 10, 16), dtype=np.int32),
        qc=rng.integers(0, 40, size=(3, 12), dtype=np.int32),
        qv=rng.normal(size=(3, 12)).astype(np.float32),
        postings=rng.integers(0, 10_000, size=500, dtype=np.int32),
        # the last starts run off the end: dynamic_slice clamps them
        starts=np.append(rng.integers(0, 400, size=14),
                         [490, 499]).astype(np.int32).reshape(4, 4),
        qcm=rng.integers(0, 30, size=(5, 24), dtype=np.int32),
        qvl=rng.normal(size=(5, 24)).astype(np.float32),
        big=rng.normal(size=(3, 20, 16)).astype(np.float32),
    )


def _t(a):
    return torch.from_numpy(a)


def test_gathers_match_jax(inputs):
    a = inputs
    np.testing.assert_array_equal(
        mb.row_gather(_t(a["table"]), _t(a["rows"])).numpy(),
        np.asarray(jnp.asarray(a["table"])[a["rows"]]))
    np.testing.assert_array_equal(
        mb.elem_gather(_t(a["qd"]), _t(a["eidx"])).numpy(),
        np.asarray(jnp.asarray(a["qd"])[a["eidx"]]))
    want = jax.vmap(lambda qr, ir: jnp.take(qr, ir, axis=0))(a["qd_b"],
                                                             a["idx_b"])
    np.testing.assert_array_equal(
        mb.batched_gather(_t(a["qd_b"]), _t(a["idx_b"])).numpy(),
        np.asarray(want))


def test_windows_match_jax(inputs):
    a = inputs
    p = jnp.asarray(a["postings"])
    want = jax.vmap(jax.vmap(
        lambda st: jax.lax.dynamic_slice(p, (st,), (32,))))(a["starts"])
    got = mb.windows(_t(a["postings"]), _t(a["starts"]), 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_compare_score_matches_jax(inputs):
    a = inputs
    eq = a["comps"][..., None] == a["qc"][:, None, None, :]
    want = jnp.sum(jnp.sum(eq.astype(jnp.float32)
                           * a["qv"][:, None, None, :], -1), -1)
    got = mb.compare_score(_t(a["comps"]), _t(a["qc"]), _t(a["qv"]))
    assert (got != 0).any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_densify_matches_jax(inputs):
    a = inputs
    rows = jnp.broadcast_to(jnp.arange(5)[:, None], a["qcm"].shape)
    want = jnp.zeros((5, DIM), jnp.float32).at[rows, a["qcm"]].add(a["qvl"])
    got = mb.scatter_densify(_t(a["qcm"]), _t(a["qvl"]), DIM)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    oh = jax.nn.one_hot(a["qcm"], DIM, dtype=jnp.float32)
    want = jnp.einsum("bq,bqd->bd", a["qvl"], oh)
    got = mb.onehot_densify(_t(a["qcm"]), _t(a["qvl"]), DIM)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        mb.stream_reduce(_t(a["big"])).numpy(),
        np.asarray(jnp.sum(a["big"], axis=(1, 2))), rtol=1e-5, atol=1e-5)


def test_microbench_runs_small_on_the_cpu():
    res = mb.run("cpu", reps=1, n_docs=1000, n_rows=64, dim=DIM,
                 n_elems=256, batch=4, per_row=32, comps_shape=(2, 8, 16),
                 n_terms=8, n_postings=1000, starts_shape=(4, 4), width=32,
                 mat=32, stream_shape=(2, 8, 16))
    assert res["device"] == "cpu"
    times = [v for k, v in res.items() if k.endswith("_ms")]
    assert len(times) == 12 and all(np.isfinite(times))
