"""A traced run of the harness on the CPU at a tiny size: the profiler turns
the program's span recorder on for the traced sweeps, each of the seven
block readers finds a finite positive number, and the recorder holds one
``sweep`` root for every traced sweep."""

import math

import pytest

from benchmark import harness
from benchmark.cells import load_module
from gpirt_tpu_torch.utils.profiling import clear_spans, span_totals

READERS = ("draws", "theta", "z", "fstar", "beta", "cutpoints", "ll")


@pytest.mark.parametrize("workload", ["senate116-k64", "sdo-k64"])
def test_traced_run_reads_every_block(workload, tiny):
    clear_spans()
    try:
        run = harness.run_cell(tiny(workload), 2 ** 31 + 23, 1.0, True, "cpu")
        assert span_totals()["sweep"].count == run["traced"][0] > 0
        for block in READERS:
            value = load_module("metrics", f"{block}_stream_ms").read(run)
            assert value is not None and math.isfinite(value) and value > 0, block
    finally:
        clear_spans()
