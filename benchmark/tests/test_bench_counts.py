"""The operation and byte counts against values worked out by hand."""

import numpy as np
import pytest

from benchmark.counts.conjugate_grid import sweep_flops
from benchmark.counts.threshold_kernel import kernel_bound


def test_sweep_flops_by_hand():
    # K=1, n=2, m=3, C=2, N=4, b=5:
    # table 2*4*6*2 + 4*3*(4+6) + 2*4*3*3 + 5*2*4 = 96 + 120 + 72 + 40 = 328
    # z 14*2*3 = 84
    # f* 4*2*5*3 + 2*2*25 + 125/3 + 2*25*3 + 2*4*5*3 + 2*4*3
    #    = 120 + 100 + 41.667 + 150 + 120 + 24 = 555.667
    # beta 2*2*9 + 2*2*3*3 + 3*45 = 36 + 36 + 135 = 207
    # cut 2*2*3*(2 + 3) = 60; ll 2*3*8 = 48
    assert sweep_flops(1, 2, 3, 2, 4, b=5) == pytest.approx(328 + 84 + 555 + 2 / 3 + 207 + 60 + 48)
    assert sweep_flops(8, 2, 3, 2, 4, b=5) == pytest.approx(8 * sweep_flops(1, 2, 3, 2, 4, b=5))


def test_sweep_flops_main_products():
    """At senate116-k64 the theta table's product and f*'s push-through are
    ~94% of the count."""
    K, n, m, C, N = 64, 100, 418, 2, 1001
    two = 2 * K * N * m * C * n + 2 * K * N * 35 * m
    assert 0.9 < two / sweep_flops(K, n, m, C, N) < 1.0


def test_kernel_bound_by_hand():
    # K=2, n=3, m=2; item 0 has 3 observed sites, item 1 has 2
    rounds = np.array([[1, 2], [64, 3]])
    capped = np.array([[False, False], [True, False]])
    b = kernel_bound(2, 3, 2, np.array([3, 2]), rounds, capped)
    # site evaluations: (1+1)*3 + (1+2)*2 + (1+64)*3 + (1+3)*2 = 6 + 6 + 195 + 8 = 215
    assert b["site_evals"] == 215 and b["ops"] == 20 * 215
    # bytes: 4 * (K n m + n m + 5 lanes + shrinks + K) = 4 * (12 + 6 + 20 + (0+1+64+2) + 2)
    assert b["bytes"] == 4 * (12 + 6 + 20 + 67 + 2)
    assert b["bound_s"] == max(b["bytes"] / 3.35e12, b["ops"] / 67e12)
