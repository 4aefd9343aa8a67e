"""On the card: the control (the reference in the program's place, in
float32 with TF32 products) and each fault the reference plants in the
program's draws (``PLANTED``) break a limit of each cell's configuration,
and the program judged alongside does not. At a test run's size: the
cells' data, grid, anneal and burn-in (the limits hold for chains that
have reached the posterior), 16 chains, three seeds.

    python -m pytest benchmark/tests -m gpu
"""

import pytest

from benchmark import harness
from benchmark.cells import load_cell, load_module

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ("senate116-k64", "sdo-k64"))
def test_control_is_not_correct(workload, cuda):
    cell = load_cell(workload)
    cell = cell._replace(traffic=dict(cell.traffic, chains=16))
    planted = load_module("reference", cell.config["reference"]).PLANTED
    for seed in SEEDS:
        run = harness.run_cell(cell, seed, 2.0, False, cuda, control=True, faults=planted)
        verdict = run["verdict"]
        assert verdict["failed"] == 0 and verdict["judged"] >= 1, (seed, verdict["per_sweep"],
                                                                    cell.limits)
        for name, nums in dict(verdict["faults"], control=verdict["control"]).items():
            assert any(nums[k] > lim for k, lim in cell.limits.items()), (seed, name, nums)
