"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
root of the checkout, on the CPU; those marked ``gpu`` run on the card
(``python -m pytest benchmark/tests -m gpu``) and skip without one."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def tiny():
    return _tiny


def _tiny(workload: str, **config):
    """``workload``'s cell cut to a CPU test's size: 20 respondents, the
    first items, a 101-point grid, 4 chains, chunks of 5 sweeps, a short
    anneal and burn-in."""
    from benchmark.cells import load_cell

    cell = load_cell(workload)
    cfg = dict(cell.config, rows=20, cols=30 if cell.config["dataset"] == "senate116" else 16,
               program=dict(cell.config["program"], grid_size=101), burn=4,
               smc_steps=8 if cell.config["smc_steps"] else 0)
    cfg.update(config)
    return cell._replace(config=cfg, traffic=dict(cell.traffic, chains=4, chunk_sweeps=5))
