"""Bundled datasets: senate116 roll calls and the SDO survey (the ``.npz``
archives under ``data/``).

Counterpart of ``gpirt_tpu/utils/datasets.py`` for the port's paths: only
the vendored ``.npz`` branches of :func:`load_senate116` and
:func:`load_sdo`, and the vignette spread into a response matrix.

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

__all__ = ["load_senate116", "load_sdo", "senate116_response_matrix"]

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


def load_sdo(path: Optional[str] = None) -> np.ndarray:
    """The SDO ordinal survey: (1500, 16) float with codes 1..5, NaN
    missing. ``path`` names an ``.npz`` archive with a "responses" array;
    the default is the one bundled under ``data/``."""
    npz = path or os.path.join(_LOCAL_DATA, "SDO.npz")
    if not npz.endswith(".npz"):
        raise NotImplementedError(
            f"only .npz archives are read by the port (got {npz!r})")
    with np.load(npz) as z:
        return z["responses"].astype(np.float64)


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
