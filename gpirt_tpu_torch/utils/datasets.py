"""Bundled datasets: senate116 roll calls and the SDO survey (the ``.npz``
archives under ``data/``).

Counterpart of ``gpirt_tpu/utils/datasets.py`` for the port's paths: only
the vendored ``.npz`` branches of :func:`load_senate116` and
:func:`load_sdo`, the vignette spread into a response matrix, and the two
simulators, :func:`simulate_2pl` and :func:`simulate_dynamic`.

senate116 cast codes (R/senate116.R:10-12): 1 = Yea, 6 = Nay, 7 = Present,
9 = abstention.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from gpirt_tpu_torch.utils.response import (
    DEFAULT_VOTE_CODES,
    ResponseMatrix,
    response_matrix,
)

__all__ = [
    "load_senate116",
    "load_sdo",
    "senate116_response_matrix",
    "simulate_2pl",
    "simulate_dynamic",
]

_LOCAL_DATA = os.path.join(os.path.dirname(__file__), "..", "..", "data")


def load_senate116(path: Optional[str] = None) -> Dict[str, np.ndarray]:
    """The tidy 42,800-row Senate 116 session-1 roll-call frame.

    Columns: rollnumber, icpsr, cast_code. ``path`` names an ``.npz``
    archive; the default is the one bundled under ``data/``.
    """
    npz = path or os.path.join(_LOCAL_DATA, "senate116.npz")
    if not npz.endswith(".npz"):
        raise NotImplementedError(
            f"only .npz archives are read by the port (got {npz!r})")
    with np.load(npz) as z:
        return {
            "rollnumber": z["rollnumber"].astype(np.int64),
            "icpsr": z["icpsr"].astype(np.int64),
            "cast_code": z["cast_code"].astype(np.int64),
        }


def load_sdo(path: Optional[str] = None, with_names: bool = False):
    """The SDO ordinal survey: (1500, 16) float with codes 1..5, NaN
    missing; with ``with_names`` also the list of item (column) names.
    ``path`` names an ``.npz`` archive with "responses" and "item_names"
    arrays; the default is the one bundled under ``data/``."""
    npz = path or os.path.join(_LOCAL_DATA, "SDO.npz")
    if not npz.endswith(".npz"):
        raise NotImplementedError(
            f"only .npz archives are read by the port (got {npz!r})")
    with np.load(npz) as z:
        mat = z["responses"].astype(np.float64)
        names = [str(s) for s in z["item_names"]]
    return (mat, names) if with_names else mat


def senate116_response_matrix(
    verbose: bool = False,
) -> Tuple[ResponseMatrix, np.ndarray, np.ndarray]:
    """Spread the tidy frame into an (n_senators, n_rollcalls) matrix and
    recode it, replicating the vignette workflow
    (vignettes/gpirt-vignette.Rmd:131-151).

    Returns (response_matrix, icpsr_row_ids, rollnumber_col_ids).
    """
    df = load_senate116()
    senators = np.unique(df["icpsr"])
    rolls = np.unique(df["rollnumber"])
    sen_ix = {v: i for i, v in enumerate(senators)}
    roll_ix = {v: j for j, v in enumerate(rolls)}
    raw = np.full((senators.size, rolls.size), np.nan)
    for rn, ic, cc in zip(df["rollnumber"], df["icpsr"], df["cast_code"]):
        raw[sen_ix[ic], roll_ix[rn]] = cc
    rm = response_matrix(raw, DEFAULT_VOTE_CODES, verbose=verbose)
    return rm, senators, rolls


def simulate_2pl(
    seed: int, n: int = 100, m: int = 20, missing: float = 0.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Binary 2PL responses (the reference roxygen example, R/gpirtMCMC.R:59-96).

    Returns (theta_true (n,), responses (n, m) in {0.0, 1.0, NaN}).
    """
    rng = np.random.default_rng(seed)
    theta = np.linspace(-3, 3, n)
    alpha = np.linspace(-2, 2, m)
    disc = rng.uniform(0.5, 3.0, m)
    p = 1 / (1 + np.exp(-(alpha[None] + disc[None] * theta[:, None])))
    y = (rng.random((n, m)) < p).astype(np.float64)
    if missing:
        y[rng.random((n, m)) < missing] = np.nan
    return theta, y


def simulate_dynamic(
    seed: int,
    n: int = 50,
    m: int = 10,
    horizon: int = 4,
    drift: float = 0.25,
    missing: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Binary responses with a slowly drifting latent trait over sessions:
    a random walk of step sd ``drift`` from an even spread on [-2.5, 2.5].

    Returns (theta_true (n, H), responses (n, m, H) in {0.0, 1.0, NaN}).
    """
    rng = np.random.default_rng(seed)
    theta0 = np.linspace(-2.5, 2.5, n)
    steps = drift * rng.standard_normal((n, horizon - 1)) if horizon > 1 else np.zeros((n, 0))
    theta = np.concatenate([theta0[:, None], theta0[:, None] + np.cumsum(steps, 1)], axis=1)
    alpha = np.linspace(-1.5, 1.5, m)
    disc = rng.uniform(0.8, 2.5, m)
    p = 1 / (1 + np.exp(-(alpha[None, :, None] + disc[None, :, None] * theta[:, None, :])))
    y = (rng.random((n, m, horizon)) < p).astype(np.float64)
    if missing:
        y[rng.random(y.shape) < missing] = np.nan
    return theta, y
