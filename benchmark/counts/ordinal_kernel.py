"""The least time the card could take for one launch of the ordinal cutpoint
slice kernel (``csrc/ordinal_threshold_ess.cu`` of the program): each input
read once (g, y, each lane's deltas, prior draw, slice level and angle, of
the shrink table the values a shrink uses, the scale as a (K,) vector), the
output deltas written once, and every observed site evaluated once per
likelihood at :data:`OPS_PER_SITE` operations, the binary kernel's figure.
A site of the ordinal kernel takes up to two CDFs (two erfs) and a log where
the binary site takes one erf and a log, so 20 operations is a floor: the
share of this bound never overstates the kernel."""

from __future__ import annotations

import numpy as np

from benchmark.counts.peaks import FP32_FLOP_PER_S, HBM_BYTES_PER_S
from benchmark.counts.threshold_kernel import OPS_PER_SITE


def ordinal_kernel_bound(K: int, n: int, m: int, C: int, n_obs: np.ndarray,
                         rounds: np.ndarray, capped: np.ndarray) -> dict:
    """``n_obs`` (m,) observed sites an item; ``rounds`` (K, m) proposals a
    lane up to its accept (the cap for a lane at the cap); ``capped`` (K,
    m) the lanes at the cap. Returns bytes, operations, the bound in
    seconds and what bounds it."""
    site_evals = int(((1 + rounds) * n_obs[None, :]).sum())
    shrinks = int(np.where(capped, rounds, rounds - 1).sum())
    lanes = K * m
    # g, y; d, nu, logu, eps0 a lane; the shrinks; c; the output deltas
    nbytes = 4 * (K * n * m + n * m + lanes * (2 * (C - 1) + 2) + shrinks + K
                  + lanes * (C - 1))
    ops = OPS_PER_SITE * site_evals
    mem_s, op_s = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    return {"bytes": nbytes, "ops": ops, "site_evals": site_evals,
            "bound_s": max(mem_s, op_s), "bound_by": "bytes" if mem_s >= op_s else "operations"}
