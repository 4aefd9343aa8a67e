"""The ordinal cutpoint kernel's count against values worked out by hand,
and its two metrics on traces made by hand: read where its launches are,
nothing where the kernel never ran (a program without it)."""

import numpy as np

from benchmark.counts.ordinal_kernel import ordinal_kernel_bound
from benchmark.metrics import ordinal_kernel_launches_per_sweep as launches_metric
from benchmark.metrics import ordinal_kernel_roofline as roofline_metric
from benchmark.trace import WINDOW_MARK, summarize


def test_ordinal_kernel_bound_by_hand():
    # K=2, n=3, m=2, C=5; item 0 has 3 observed sites, item 1 has 2
    rounds = np.array([[1, 2], [64, 3]])
    capped = np.array([[False, False], [True, False]])
    b = ordinal_kernel_bound(2, 3, 2, 5, np.array([3, 2]), rounds, capped)
    # site evaluations: (1+1)*3 + (1+2)*2 + (1+64)*3 + (1+3)*2 = 215, 20 operations each
    assert b["site_evals"] == 215 and b["ops"] == 20 * 215
    # bytes: 4 * (K n m + n m + lanes (2 (C-1) + 2) + shrinks + K + lanes (C-1))
    #      = 4 * (12 + 6 + 4 * 10 + 67 + 2 + 4 * 4)
    assert b["bytes"] == 4 * (12 + 6 + 40 + 67 + 2 + 16)
    assert b["bound_s"] == max(b["bytes"] / 3.35e12, b["ops"] / 67e12)


def _run(kernel_names):
    """A run of 2 traced sweeps whose device ran ``kernel_names``, one 1 ms
    launch each, and the reference's proposal counts at K = 2, m = 2."""
    ms = 1_000_000
    events = [(WINDOW_MARK, False, 0, 100 * ms), ("aten::add", True, 0, ms)]
    events += [(name, True, (2 + 2 * i) * ms, ms) for i, name in enumerate(kernel_names)]
    rounds = (np.array([[3, 4], [5, 6]]), np.zeros((2, 2), dtype=bool))
    return {"trace": summarize(events, 2), "traced": (2, 0.1), "verdict": {"rounds": rounds},
            "y_ref": np.array([[1, 5], [0, 3], [2, 2]]), "C_ref": 5}


def test_metrics_read_the_kernels_launches():
    name = "void (anonymous namespace)::ordinal_cut_tile_kernel<256, 1024, 8, 8>(...)"
    run = _run([name, name])
    assert launches_metric.read(run) == 1.0
    bound = ordinal_kernel_bound(2, 3, 2, 5, np.array([2, 3]), *run["verdict"]["rounds"])
    assert abs(roofline_metric.read(run) - 100.0 * bound["bound_s"] / 1e-3) < 1e-9


def test_metrics_read_nothing_without_the_kernel():
    run = _run(["void (anonymous namespace)::ess_regs_kernel<32, 4, 16>(...)"])
    assert launches_metric.read(run) is None
    assert roofline_metric.read(run) is None
    assert launches_metric.read(dict(run, trace=None)) is None
