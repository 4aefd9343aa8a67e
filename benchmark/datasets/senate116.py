"""The 116th US Senate's first-session roll calls (Voteview), read with
numpy alone from the frozen copy ``data/senate116.npz``, so that the data a
cell runs on cannot change with the program."""

import os

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")

# Voteview cast codes (R/gpirtMCMC.R:100-101): 1-3 yea, 4-6 nay, the rest missing
YEA = (1, 2, 3)
NAY = (4, 5, 6)


def raw() -> np.ndarray:
    """The roll calls spread into a (senators, roll calls) matrix of cast
    codes, NaN where a senator has no record; rows by icpsr and columns by
    roll number, both ascending."""
    with np.load(os.path.join(DATA, "senate116.npz")) as z:
        roll, icpsr, cast = (z[k].astype(np.int64) for k in ("rollnumber", "icpsr",
                                                                "cast_code"))
    senators, rows = np.unique(icpsr, return_inverse=True)
    rolls, cols = np.unique(roll, return_inverse=True)
    out = np.full((senators.size, rolls.size), np.nan)
    out[rows, cols] = cast
    return out


def categories(raw: np.ndarray):
    """Cast codes -> nay 1, yea 2, missing 0, with every item whose observed
    votes all agree dropped (an item with no vote stays). Returns the
    categories and the raw columns kept."""
    y = np.where(np.isin(raw, YEA), 2, np.where(np.isin(raw, NAY), 1, 0))
    keep = [j for j in range(y.shape[1]) if np.unique(y[:, j][y[:, j] > 0]).size != 1]
    return y[:, keep].astype(np.int32), keep
