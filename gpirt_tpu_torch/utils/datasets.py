"""Bundled datasets: senate116 roll calls and the SDO ordinal survey.

Counterpart of ``gpirt_tpu/utils/datasets.py``, with its search order:
the vendored ``.npz`` archives under ``data/`` first, then an ``.rda``
file read by the port's pure-Python RData reader (``utils/rdata.py``),
then, for senate116, the two Voteview CSVs (``S116_votes.csv``,
``S116_rollcalls.csv``) rebuilt as data-raw/senate116.R does. Besides
``data/``, the ``.rda`` files and CSVs are looked for in a checkout of the
reference R package at ``reference/`` in this repository (its ``data/``
and ``data-raw/``). Also the vignette spread into a response matrix, and
the two simulators, :func:`simulate_2pl` and :func:`simulate_dynamic`.

As in the JAX package, an existing ``data/senate116.npz`` or
``data/SDO.npz`` is read before an ``.rda`` path given as ``path``.

senate116 cast codes (R/senate116.R:10-12): 1 = Yea, 6 = Nay, 7 = Present,
9 = abstention.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Optional, Tuple

import numpy as np

from gpirt_tpu_torch.utils.rdata import R_NA_INT, load_rda
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

_ROOT = os.path.join(os.path.dirname(__file__), "..", "..")
_LOCAL_DATA = os.path.join(_ROOT, "data")
_REFERENCE_DATA = os.path.join(_ROOT, "reference", "data")
_REFERENCE_RAW = os.path.join(_ROOT, "reference", "data-raw")


def _find(*candidates) -> Optional[str]:
    for c in candidates:
        if c and os.path.exists(c):
            return c
    return None


def load_senate116(path: Optional[str] = None) -> Dict[str, np.ndarray]:
    """The tidy 42,800-row Senate 116 session-1 roll-call frame.

    Columns: rollnumber, icpsr, cast_code. ``path`` names an ``.npz``
    archive or an ``.rda`` file holding the ``senate116`` data.frame; without
    one (or when ``data/senate116.npz`` exists) the bundled archive is read.
    The CSV rebuild keeps session-1 roll calls only, as data-raw/senate116.R.
    """
    npz = _find(
        path if path and path.endswith(".npz") else None,
        os.path.join(_LOCAL_DATA, "senate116.npz"),
    )
    if npz:
        with np.load(npz) as z:
            return {
                "rollnumber": z["rollnumber"].astype(np.int64),
                "icpsr": z["icpsr"].astype(np.int64),
                "cast_code": z["cast_code"].astype(np.int64),
            }

    rda = _find(
        path if path and path.endswith(".rda") else None,
        os.path.join(_LOCAL_DATA, "senate116.rda"),
        os.path.join(_REFERENCE_DATA, "senate116.rda"),
    )
    if rda:
        df = load_rda(rda)["senate116"].to_python()
        return {k: np.asarray(df[k]).astype(np.int64)
                for k in ("rollnumber", "icpsr", "cast_code")}

    votes_csv = _find(
        os.path.join(_LOCAL_DATA, "S116_votes.csv"),
        os.path.join(_REFERENCE_RAW, "S116_votes.csv"),
    )
    rolls_csv = _find(
        os.path.join(_LOCAL_DATA, "S116_rollcalls.csv"),
        os.path.join(_REFERENCE_RAW, "S116_rollcalls.csv"),
    )
    if not (votes_csv and rolls_csv):
        raise FileNotFoundError("senate116 data not found (.rda or raw CSVs)")

    session1 = set()
    with open(rolls_csv, newline="") as fh:
        for row in csv.DictReader(fh):
            if row["session"] == "1":
                session1.add(int(row["rollnumber"]))
    roll, icpsr, cast = [], [], []
    with open(votes_csv, newline="") as fh:
        for row in csv.DictReader(fh):
            rn = int(row["rollnumber"])
            if rn in session1:
                roll.append(rn)
                icpsr.append(int(row["icpsr"]))
                cast.append(int(row["cast_code"]))
    return {
        "rollnumber": np.asarray(roll, np.int64),
        "icpsr": np.asarray(icpsr, np.int64),
        "cast_code": np.asarray(cast, np.int64),
    }


def load_sdo(path: Optional[str] = None, with_names: bool = False):
    """The SDO ordinal survey: (1500, 16) float with codes 1..5, NaN
    missing; with ``with_names`` also the list of item (column) names.
    ``path`` names an ``.npz`` archive with "responses" and "item_names"
    arrays, or an ``.rda`` file holding the ``SDO`` data.frame (R's
    ``NA_integer_`` read as NaN); without one (or when ``data/SDO.npz``
    exists) the bundled archive is read."""
    npz = _find(
        path if path and path.endswith(".npz") else None,
        os.path.join(_LOCAL_DATA, "SDO.npz"),
    )
    if npz:
        with np.load(npz) as z:
            mat = z["responses"].astype(np.float64)
            names = [str(s) for s in z["item_names"]]
        return (mat, names) if with_names else mat

    rda = _find(
        path,
        os.path.join(_LOCAL_DATA, "SDO.rda"),
        os.path.join(_REFERENCE_DATA, "SDO.rda"),
    )
    if not rda:
        raise FileNotFoundError("SDO data not found (data/SDO.npz or SDO.rda)")
    df = load_rda(rda)["SDO"].to_python()
    cols, names = [], []
    for name, v in df.items():
        arr = np.asarray(v, dtype=np.float64)
        cols.append(np.where(arr == float(R_NA_INT), np.nan, arr))
        names.append(str(name))
    mat = np.column_stack(cols)
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
