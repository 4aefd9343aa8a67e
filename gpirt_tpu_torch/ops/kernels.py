"""Host float64 covariance (Gram) kernels for setup-time factorizations.

Numpy twins of ``gpirt_tpu/ops/kernels.py``'s ``icc_gram_np`` and
``time_gram_np`` (reference: src/covariance-function.cpp:3-44). The port's
sweep never evaluates a kernel: every Gram it needs is a gather from the
grid eigenbasis built once by ``make_constants``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["icc_gram_np", "time_gram_np"]


def icc_gram_np(x1, x2, beta_prior_sds):
    """k(a, b) = exp(-0.5 (a-b)^2) + a sd1^2 b + sd0^2 + (a sd2 b)^2.

    ``x1`` (..., n), ``x2`` (..., m) -> (..., n, m) in float64.
    """
    a = np.asarray(x1, np.float64)[..., :, None]
    b = np.asarray(x2, np.float64)[..., None, :]
    sds = np.asarray(beta_prior_sds, np.float64)
    d = a - b
    return (
        np.exp(-0.5 * d * d)
        + a * (sds[1] ** 2) * b
        + sds[0] ** 2
        + np.square(a * sds[2] * b)
    )


def time_gram_np(t1, t2, os, ls, theta_prior_sds, kernel="Matern"):
    """Matern-5/2 or RBF Gram over time points plus linear/constant terms.

    Matern: os^2 (1 + sqrt5 d/ls + 5 d^2/(3 ls^2)) exp(-sqrt5 d/ls)
    RBF:    os^2 exp(-d^2 / ls^2)   (no 1/2 factor, matching the reference)
    """
    a = np.asarray(t1, np.float64)[..., :, None]
    b = np.asarray(t2, np.float64)[..., None, :]
    sds = np.asarray(theta_prior_sds, np.float64)
    d = np.abs(a - b)
    if kernel == "Matern":
        s5 = np.sqrt(5.0)
        core = (os * os) * (1.0 + s5 * d / ls + 5.0 * d * d / (3.0 * ls * ls)) * np.exp(
            -s5 * d / ls
        )
    elif kernel == "RBF":
        core = (os * os) * np.exp(-d * d / (ls * ls))
    else:
        raise ValueError(f"unknown time kernel {kernel!r}; expected 'Matern' or 'RBF'")
    return core + a * (sds[1] ** 2) * b + sds[0] ** 2
