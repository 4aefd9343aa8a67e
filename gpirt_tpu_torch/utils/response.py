"""Response-matrix ingestion: recoding, unanimity filtering, validation.

Reimplements the reference's response_matrix S3 class semantics
(R/response_matrix.R:51-127):
  * recode raw responses to yea=+1 / nay=-1 / missing=NA via code lists;
  * unknown codes are treated as missing, with a message;
  * unanimous items are dropped, with a message;
  * is_/as_ coercion helpers.

Plus the internal sampler-facing encoding: the sampler consumes int32 categories
1..C with 0 = missing. The reference's raw {-1,+1} binary coding would index
out of bounds in its own ordinal likelihood (SURVEY.md section 7.3 quirk 1),
so binary data is recoded internally to {1, 2}.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ResponseMatrix",
    "response_matrix",
    "is_response_matrix",
    "as_response_matrix",
    "encode_categories",
    "DEFAULT_VOTE_CODES",
]

# Voteview-style default codes (R/gpirtMCMC.R:100-101):
# 1-3 => yea, 4-6 => nay, 0/7-9/NA => missing.
DEFAULT_VOTE_CODES: Dict[str, list] = {
    "yea": [1, 2, 3],
    "nay": [4, 5, 6],
    "missing": [0, 7, 8, 9, None],
}


def _message(msg: str):
    print(msg, file=sys.stderr)


def _listify(x) -> list:
    if x is None:
        return [None]
    if isinstance(x, (list, tuple, np.ndarray, range)):
        return list(x)
    return [x]


class ResponseMatrix(np.ndarray):
    """An (n, m) float array with values in {-1.0, +1.0, NaN}.

    Subclassing ndarray mirrors the reference's S3 "class on a matrix"
    pattern while keeping numpy semantics. Row/column labels are preserved
    through recoding like the reference's dimnames (R/response_matrix.R:65-69)
    as ``row_names`` / ``col_names`` (None when the input carried none).
    """

    def __new__(cls, data, row_names=None, col_names=None):
        arr = np.asarray(data, dtype=np.float64).view(cls)
        arr.row_names = list(row_names) if row_names is not None else None
        arr.col_names = list(col_names) if col_names is not None else None
        return arr

    def __array_finalize__(self, obj):
        if obj is None:
            return
        self.row_names = getattr(obj, "row_names", None)
        self.col_names = getattr(obj, "col_names", None)


def _extract_dimnames(data):
    """Row/column labels from dataframe-likes (pandas) or column dicts."""
    if isinstance(data, dict):
        return None, list(data.keys())
    idx = getattr(data, "index", None)
    cols = getattr(data, "columns", None)
    if idx is not None and cols is not None:  # pandas DataFrame duck-type
        return list(idx), list(cols)
    return None, None


def response_matrix(
    data,
    response_codes: Optional[Dict[str, Sequence]] = None,
    *,
    drop_unanimous: bool = True,
    verbose: bool = True,
) -> ResponseMatrix:
    """Recode a raw response matrix/dataframe-dict to {-1, +1, NaN}.

    Args:
      data: 2-D array-like, or a dict of equal-length columns (dataframe-ish).
        Lists that are not column dicts are rejected, matching the reference
        (R/response_matrix.R:56-59).
      response_codes: dict with "yea" / "nay" / "missing" code lists.
      drop_unanimous: drop items with a single unique observed value
        (with a message), matching R/response_matrix.R:87-95.
    """
    if response_codes is None:
        response_codes = DEFAULT_VOTE_CODES
    row_names, col_names = _extract_dimnames(data)
    if isinstance(data, dict):
        cols = list(data.values())
        arr = np.column_stack([np.asarray(c, dtype=object) for c in cols])
    elif isinstance(data, (list, tuple)) and data and isinstance(data[0], dict):
        raise TypeError(
            "Conversion from lists to ResponseMatrix objects is unsupported."
        )
    else:
        arr = np.asarray(data, dtype=object)
    if row_names is None:
        row_names = getattr(data, "row_names", None)
    if col_names is None:
        col_names = getattr(data, "col_names", None)
    if arr.ndim != 2:
        raise ValueError(f"expected a 2-D response matrix, got shape {arr.shape}")

    yea = set(map(_norm_code, _listify(response_codes.get("yea"))))
    nay = set(map(_norm_code, _listify(response_codes.get("nay"))))
    missing = set(map(_norm_code, _listify(response_codes.get("missing"))))

    known = yea | nay | missing
    flat = [_norm_code(v) for v in arr.ravel()]
    unknown = sorted({v for v in flat if v not in known}, key=str)
    if unknown:
        missing = missing | set(unknown)
        if verbose:
            _message(
                "Responses with value "
                + ", ".join(map(str, unknown))
                + " were not given a response code and will be treated as missing."
            )

    out = np.full(arr.shape, np.nan, dtype=np.float64)
    flat_out = out.ravel()
    for k, v in enumerate(flat):
        if v in yea:
            flat_out[k] = 1.0
        elif v in nay:
            flat_out[k] = -1.0
        # else stays NaN (missing or unknown)

    if drop_unanimous:
        keep = []
        dropped = []
        for j in range(out.shape[1]):
            col = out[:, j]
            uniq = np.unique(col[~np.isnan(col)])
            if uniq.size == 1:
                dropped.append(j + 1)  # 1-based, like the R message
            else:
                keep.append(j)
        if dropped and verbose:
            plural = "s" if len(dropped) > 1 else ""
            verb = "were" if len(dropped) > 1 else "was"
            _message(
                f"Item{plural} " + ", ".join(map(str, dropped)) +
                f" {verb} discarded as unanimous."
            )
        out = out[:, keep]
        if col_names is not None:
            col_names = [col_names[j] for j in keep]

    return ResponseMatrix(out, row_names=row_names, col_names=col_names)


def _norm_code(v):
    """Normalize a code for set membership (NaN/None -> None; ints as ints)."""
    if v is None:
        return None
    if isinstance(v, float):
        if np.isnan(v):
            return None
        if v.is_integer():
            return int(v)
        return v
    if isinstance(v, (np.floating,)):
        return _norm_code(float(v))
    if isinstance(v, (np.integer,)):
        return int(v)
    return v


def is_response_matrix(x) -> bool:
    """Class + shape + value-domain check (R/response_matrix.R:109-115)."""
    if not isinstance(x, ResponseMatrix):
        return False
    if x.ndim != 2:
        return False
    vals = np.asarray(x, dtype=np.float64)
    ok = np.isnan(vals) | (vals == 1.0) | (vals == -1.0)
    return bool(np.all(ok))


def as_response_matrix(x, response_codes=None, **kw) -> ResponseMatrix:
    """Idempotent coercion (R/response_matrix.R:119-127)."""
    if is_response_matrix(x):
        return x
    return response_matrix(x, response_codes, **kw)


def recode_cube(
    data, response_codes: Optional[Dict[str, Sequence]] = None, *, verbose: bool = True
) -> np.ndarray:
    """Vote-code recoding for (n, m, H) response cubes -> {-1, +1, NaN}.

    The unanimity filter is per-item across *all* horizons (dropping an item
    in one session but not another would misalign the cube; the reference
    only defines the 2-D case, R/response_matrix.R:87-95).
    """
    if response_codes is None:
        response_codes = DEFAULT_VOTE_CODES
    arr = np.asarray(data, dtype=object)
    if arr.ndim != 3:
        raise ValueError(f"recode_cube expects (n, m, H); got {arr.shape}")
    n, m, H = arr.shape
    flat = response_matrix(
        arr.transpose(0, 2, 1).reshape(n * H, m),
        response_codes,
        drop_unanimous=False,
        verbose=verbose,
    )
    out = np.asarray(flat, np.float64).reshape(n, H, m).transpose(0, 2, 1)
    keep = []
    dropped = []
    for j in range(m):
        col = out[:, j, :]
        uniq = np.unique(col[~np.isnan(col)])
        if uniq.size == 1:
            dropped.append(j + 1)  # 1-based, like the R message
        else:
            keep.append(j)
    if dropped and verbose:
        plural = "s" if len(dropped) > 1 else ""
        verb = "were" if len(dropped) > 1 else "was"
        _message(
            f"Item{plural} " + ", ".join(map(str, dropped)) +
            f" {verb} discarded as unanimous."
        )
    return out[:, keep, :]


def encode_categories(data: np.ndarray) -> Tuple[np.ndarray, int, np.ndarray]:
    """Raw responses -> int32 categories in 1..C, 0 = missing.

    * A ResponseMatrix ({-1, +1, NaN}) maps to {1, 2, 0}.
    * Ordinal data (vote_codes=None in the reference API) must already be
      coded 1..C with NaN for missing (doc R/gpirtMCMC.R:20); we validate and
      pass through, deriving C from the distinct observed values
      (R/gpirtMCMC.R:137-147).

    Accepts (n, m) or (n, m, H); returns (H, n, m) int32, C, and the sorted
    unique category values.
    """
    arr = np.asarray(data, dtype=np.float64)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3:
        raise ValueError(f"expected (n, m) or (n, m, H) data, got {arr.shape}")
    obs = arr[~np.isnan(arr)]
    uniq = np.unique(obs)
    if uniq.size == 0:
        raise ValueError("no observed responses")
    if set(uniq.tolist()) <= {-1.0, 1.0}:
        C = 2
        coded = np.where(np.isnan(arr), 0, np.where(arr > 0, 2, 1))
    else:
        if not np.allclose(uniq, np.round(uniq)):
            raise ValueError(
                "ordinal responses must be integer category codes 1..C "
                f"(got values {uniq[:10]})"
            )
        C = int(uniq.size)
        contiguous = uniq.min() == 1 and uniq.max() == C
        if contiguous:
            coded = np.where(np.isnan(arr), 0, arr).astype(np.int64)
        else:
            # The reference derives C from the number of distinct values
            # (R/gpirtMCMC.R:146) but indexes cutpoints by the raw code —
            # out-of-bounds for non-contiguous codes. We remap codes to their
            # ranks 1..C instead (documented deliberate divergence).
            _message(
                f"Ordinal codes {uniq.tolist()} are not contiguous 1..C; "
                "remapping to rank order."
            )
            rank = {v: i + 1 for i, v in enumerate(uniq.tolist())}
            coded = np.zeros(arr.shape, dtype=np.int64)
            for v, r in rank.items():
                coded[arr == v] = r
    y = np.transpose(coded.astype(np.int32), (2, 0, 1))  # (H, n, m)
    return y, C, uniq
