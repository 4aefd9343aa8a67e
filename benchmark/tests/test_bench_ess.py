"""The copied ESS arithmetic is the program's, and the within-chain median
sums chains as bench.py does."""

import numpy as np
import torch

from benchmark.diagnostics import pooled_ess, within_chain_ess_median
from gpirt_tpu_torch.utils.diagnostics import effective_sample_size_device


def test_pooled_ess_is_the_programs():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 120, 9, generator=g).cumsum(1) * 0.1 + torch.randn(4, 120, 9, generator=g)
    assert torch.equal(pooled_ess(x), effective_sample_size_device(x))
    assert torch.equal(pooled_ess(x, False), effective_sample_size_device(x, False))


def test_mixing_orders_the_reading():
    """Independent draws read at least their count (at the estimator's
    clamp); a random walk of the same length reads a few."""
    g = torch.Generator().manual_seed(1)
    white = torch.randn(4, 1000, 5, generator=g)
    assert torch.all(pooled_ess(white, align_signs=False) >= 4000)
    walk = pooled_ess(white.cumsum(1), align_signs=False)
    assert torch.all(walk < 50)


def test_within_chain_median_sums_chains():
    x = torch.randn(3, 200, 7, generator=torch.Generator().manual_seed(2))
    per = torch.stack([effective_sample_size_device(x[k:k + 1]) for k in range(3)])
    assert within_chain_ess_median(x) == float(per.sum(0).median())
    assert np.isfinite(within_chain_ess_median(x))
