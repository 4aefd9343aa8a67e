"""The least time the card could take for one launch of the binary cutpoint
slice kernel (``csrc/threshold_ess.cu`` of the program), copied from
``chip_smoke.kernel_bound``: each input read once (of the shrink table,
the values a shrink uses; the scale as a (K,) vector), the output written
once, and every observed site evaluated once per likelihood, at 20
operations an evaluation (2 for the argument, 3 around erf, ~8 in erf's
polynomial, ~6 in log's, 1 to accumulate)."""

from __future__ import annotations

import numpy as np

from benchmark.counts.peaks import FP32_FLOP_PER_S, HBM_BYTES_PER_S

OPS_PER_SITE = 20


def kernel_bound(K: int, n: int, m: int, n_obs: np.ndarray, rounds: np.ndarray,
                 capped: np.ndarray) -> dict:
    """``n_obs`` (m,) observed sites an item; ``rounds`` (K, m) proposals a
    lane up to its accept (the cap for a lane at the cap); ``capped`` (K,
    m) the lanes at the cap. Returns bytes, operations, the bound in
    seconds and what bounds it."""
    site_evals = int(((1 + rounds) * n_obs[None, :]).sum())
    shrinks = int(np.where(capped, rounds, rounds - 1).sum())
    lanes = K * m
    nbytes = 4 * (K * n * m + n * m + 5 * lanes + shrinks + K)
    ops = OPS_PER_SITE * site_evals
    mem_s, op_s = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    return {"bytes": nbytes, "ops": ops, "site_evals": site_evals,
            "bound_s": max(mem_s, op_s), "bound_by": "bytes" if mem_s >= op_s else "operations"}
