"""Microbenchmarks of the access patterns the engine is built from, on the
card: the JAX tool's list (`seismic_tpu/harness/microbench.py`) in torch.

Random row gathers at three widths, element gathers from a table (one
table, and one table per row), compare-intersection scoring, batched
dynamic-slice windows, scatter-add and one-hot densification, f32 and bf16
4K matrix products and a 512 MB streaming reduce. Each is timed with CUDA
events around every call, as the median of `reps` calls after a warm-up.
The sizes default to the JAX tool's and are arguments, so the expressions
can be run small. The data is drawn on the device from a seeded
`torch.Generator`.

Usage: python -m seismic_tpu_torch.harness.microbench [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import torch

from ..device import full_f32, resolve_device


# ---- the expressions, one per JAX lambda ----


def row_gather(table, idx):
    return table[idx]


def elem_gather(qd, idx):
    return qd[idx]


def batched_gather(qd_b, idx_b):
    """out[b, i] = qd_b[b, idx_b[b, i]] (the JAX tool's vmap of take)."""
    return torch.gather(qd_b, 1, idx_b.long())


def compare_score(comps, qc, qv):
    """score[b, c] = sum_w sum_q [comps[b, c, w] == qc[b, q]] * qv[b, q]."""
    eq = comps[..., None] == qc[:, None, None, :]
    return (eq.to(torch.float32) * qv[:, None, None, :]).sum(-1).sum(-1)


def windows(postings, starts, width: int = 32):
    """out[..., i] = postings[s + i] for each start s, clamped into range
    as `lax.dynamic_slice` clamps."""
    s = starts.long().clamp(0, postings.shape[0] - width)
    return postings[s[..., None] + torch.arange(width, device=s.device)]


def scatter_densify(qcm, qvl, dim: int):
    """qd[b, qcm[b, i]] += qvl[b, i] into a zero [B, dim] table."""
    qd = torch.zeros((qcm.shape[0], dim), dtype=torch.float32,
                     device=qcm.device)
    rows = torch.arange(qcm.shape[0], device=qcm.device)[:, None]
    return qd.index_put_((rows.expand_as(qcm), qcm.long()), qvl,
                         accumulate=True)


def onehot_densify(qcm, qvl, dim: int):
    """The same table as `scatter_densify`, as a one-hot product."""
    oh = torch.nn.functional.one_hot(qcm.long(), dim).to(torch.float32)
    return torch.einsum("bq,bqd->bd", qvl, oh)


def stream_reduce(big):
    return big.sum(dim=(1, 2))


# ---- timing ----


def median_ms(fn, dev, reps: int) -> float:
    """Median ms of `reps` calls after one warm-up: CUDA events around each
    call on the card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run(device=None, reps: int = 10, n_docs: int = 1_000_000,
        n_rows: int = 262_144, dim: int = 30523, n_elems: int = 1_048_576,
        batch: int = 256, per_row: int = 4096, comps_shape=(64, 1024, 256),
        n_terms: int = 64, n_postings: int = 16_777_216,
        starts_shape=(256, 256), width: int = 32, mat: int = 4096,
        stream_shape=(512, 1024, 256)) -> dict:
    """Time every pattern at the given sizes (the JAX tool's by default) on
    `device` (the card by default); print one line each and return the
    numbers."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    res = {"device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu")}

    def ints(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=dtype)

    def normal(shape):
        return torch.randn(shape, generator=g, device=dev)

    def timed(key, fn):
        res[key] = median_ms(fn, dev, reps)
        return res[key]

    with full_f32():
        # ---- random row gathers ----
        idx = ints(0, n_docs, (n_rows,))
        for name, tab in (("f32x256", normal((n_docs, 256))),
                          ("i32x256", ints(0, dim - 1, (n_docs, 256))),
                          ("i8x128", ints(-127, 127, (n_docs, 128),
                                          torch.int8))):
            t = timed(f"row_gather_{name}_ms", lambda: row_gather(tab, idx))
            nbytes = n_rows * tab.shape[1] * tab.element_size()
            res[f"row_gather_{name}_ns_per_row"] = t * 1e6 / n_rows
            res[f"row_gather_{name}_gb_s"] = nbytes / t / 1e6
            print(f"row_gather {name} n={n_rows}: {t:8.3f} ms "
                  f"{nbytes / t / 1e6:7.2f} GB/s {t * 1e6 / n_rows:7.2f} "
                  "ns/row")
            del tab

        # ---- element gathers: one table, one table per row ----
        qd = normal((dim,))
        eidx = ints(0, dim, (n_elems,))
        t = timed("elem_gather_ms", lambda: elem_gather(qd, eidx))
        res["elem_gather_ns_per_elem"] = t * 1e6 / n_elems
        print(f"elem_gather [{dim}]f32 n={n_elems}: {t:8.3f} ms "
              f"{t * 1e6 / n_elems:7.3f} ns/elem")
        qd_b = normal((batch, dim))
        idx_b = ints(0, dim, (batch, per_row), torch.int64)
        t = timed("batched_gather_ms", lambda: batched_gather(qd_b, idx_b))
        n = batch * per_row
        res["batched_gather_ns_per_elem"] = t * 1e6 / n
        print(f"batched_gather [{batch},{dim}] n={n}: {t:8.3f} ms "
              f"{t * 1e6 / n:7.3f} ns/elem")
        del qd, eidx, qd_b, idx_b

        # ---- compare-intersection scoring ----
        comps = ints(0, dim - 1, comps_shape)
        qc = ints(0, dim - 1, (comps_shape[0], n_terms))
        qv = normal((comps_shape[0], n_terms))
        t = timed("compare_score_ms", lambda: compare_score(comps, qc, qv))
        ops = comps.numel() * n_terms
        res["compare_score_tops_s"] = ops / t / 1e9
        print(f"compare_intersect {tuple(comps_shape)}x{n_terms}: {t:8.3f} "
              f"ms {ops / t / 1e9:6.3f} Tops/s")
        del comps, qc, qv

        # ---- batched dynamic slices (candidate windows) ----
        postings = ints(0, n_docs, (n_postings,))
        starts = ints(0, n_postings - 64, starts_shape)
        t = timed("windows_ms", lambda: windows(postings, starts, width))
        n = starts.numel()
        res["windows_ns_per_slice"] = t * 1e6 / n
        print(f"dyn_slice_windows {width}xi32 n={n}: {t:8.3f} ms "
              f"{t * 1e6 / n:7.2f} ns/slice")
        del postings, starts

        # ---- densify the query table: scatter-add, one-hot product ----
        qcm = ints(0, dim - 1, (batch, n_terms))
        qvl = normal((batch, n_terms))
        t = timed("scatter_densify_ms",
                  lambda: scatter_densify(qcm, qvl, dim))
        print(f"scatter_densify [{batch},{dim}]: {t:8.3f} ms")
        t = timed("onehot_densify_ms", lambda: onehot_densify(qcm, qvl, dim))
        print(f"onehot_densify [{batch},{dim}]: {t:8.3f} ms")
        del qcm, qvl

        # ---- matrix products: f32 (no TF32) and bf16 ----
        a, b = normal((mat, mat)), normal((mat, mat))
        flops = 2.0 * mat ** 3
        t = timed("matmul_f32_ms", lambda: a @ b)
        res["matmul_f32_tflop_s"] = flops / t / 1e9
        print(f"matmul f32 {mat}^3: {t:8.3f} ms {flops / t / 1e9:6.1f} "
              "TFLOP/s")
        ab, bb = a.to(torch.bfloat16), b.to(torch.bfloat16)
        t = timed("matmul_bf16_ms", lambda: ab @ bb)
        res["matmul_bf16_tflop_s"] = flops / t / 1e9
        print(f"matmul bf16 {mat}^3: {t:8.3f} ms {flops / t / 1e9:6.1f} "
              "TFLOP/s")
        del a, b, ab, bb

        # ---- streaming read ----
        big = normal(stream_shape)
        t = timed("stream_reduce_ms", lambda: stream_reduce(big))
        nbytes = big.numel() * 4
        res["stream_reduce_gb_s"] = nbytes / t / 1e6
        print(f"stream_reduce {nbytes / 2**20:.0f}MB: {t:8.3f} ms "
              f"{nbytes / t / 1e6:7.1f} GB/s")
        del big
    if dev.type == "cuda":
        res["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    res = run(args.device)
    print(f"device: {res['device']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
