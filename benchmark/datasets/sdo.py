"""The Social Dominance Orientation survey (1500 respondents, 16 items,
codes 1..5), read with numpy alone from the frozen copy ``data/SDO.npz``."""

import os

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def raw() -> np.ndarray:
    """(1500, 16) codes 1..5, NaN missing."""
    with np.load(os.path.join(DATA, "SDO.npz")) as z:
        return z["responses"].astype(np.float64)


def categories(raw: np.ndarray):
    """Codes 1..C as they are, NaN -> 0; every column kept."""
    codes = np.unique(raw[~np.isnan(raw)])
    if not np.array_equal(codes, np.arange(1, codes.size + 1)):
        raise ValueError(f"ordinal codes must be 1..C, got {codes}")
    return np.where(np.isnan(raw), 0, raw).astype(np.int32), list(range(raw.shape[1]))
