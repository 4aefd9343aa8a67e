"""Item response function (IRF) probability curves, on the host in numpy
and scipy: a copy of ``gpirt_tpu/utils/irf.py``.

The reference's documentation promises an "IRFs" return element — "one
column per item ... 1001 rows. The first row has the probabilities of a 1
response for a theta value of -5.0, ..." (R/gpirtMCMC.R:51-56) — but its code
never computes it (the sampler returns raw fstar draws only; doc/code
mismatch). This module provides that capability: turn stored fstar and
cutpoint draws into posterior response-probability curves over the theta*
grid.
"""

from __future__ import annotations

import numpy as np
from scipy import special as _sps

__all__ = ["irf_probabilities", "posterior_irf"]


def _phi(z):
    return 0.5 * (1.0 + _sps.erf(z / np.sqrt(2.0)))


def irf_probabilities(fstar: np.ndarray, thresholds: np.ndarray) -> np.ndarray:
    """Category probabilities P(y = c | theta*) for one draw.

    Args:
      fstar: (N, m) latent IRF values on the grid (mean-inclusive, as stored).
      thresholds: (m, C+1) cutpoints with +-inf endpoints.

    Returns:
      (N, m, C) probabilities; ``[..., c-1]`` is P(y = c).
    """
    fstar = np.asarray(fstar, np.float64)
    thresholds = np.asarray(thresholds, np.float64)
    z = thresholds[None, :, :] - fstar[:, :, None]  # (N, m, C+1)
    cdf = _phi(z)
    return cdf[..., 1:] - cdf[..., :-1]


def posterior_irf(samples: dict, horizon: int = 0) -> np.ndarray:
    """Posterior-mean IRF curves from a chain dict with stored fstar.

    Args:
      samples: a chain dict from ``gpirt_mcmc(..., store_fstar=True)``:
        uses "fstar" (S, N, m, H) and "threshold" (S, m, C+1, H).
      horizon: which session's IRFs.

    Returns:
      (N, m, C) posterior-mean probabilities. For binary models
      ``out[..., 1]`` is the reference-documented "probability of a 1
      (yea) response" curve.
    """
    fs = np.asarray(samples["fstar"])[..., horizon]  # (S, N, m)
    thr = np.asarray(samples["threshold"])[..., horizon]  # (S, m, C+1)
    S = fs.shape[0]
    acc = None
    for s in range(S):
        p = irf_probabilities(fs[s], thr[s])
        acc = p if acc is None else acc + p
    return acc / S
