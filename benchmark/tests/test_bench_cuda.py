"""On the card: a traced run of each cell at a test's size reads the
device trace (busy time, the program's kernels, their rooflines under
100%) and comes out correct. Skips where there is no card."""

import pytest

from bench_testutil import CELLS, run_tiny

ROOFLINES = {"headline-b16384": ("k4_roofline_pct", "k3_roofline_pct"),
             "api-engine-b4096": ("k7_roofline_pct",)}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    rec = run_tiny(cell, traced=True, device="cuda", seconds=2.0)
    assert rec["correct"], rec["checks"]
    dev = rec["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert dev["memory_peak_bytes"] > 0
    m = rec["metrics"]
    for name in ROOFLINES[cell]:
        assert 0 < m[name]["value"] <= 100, (name, m[name])
    assert 0 <= m["device_idle_pct"]["value"] < 100
    assert rec["breakdown"]["device_ops"]
