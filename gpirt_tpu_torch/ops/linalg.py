"""Dense linear-algebra helpers: closed-form 3x3 factors and triangular solves.

Counterpart of ``gpirt_tpu/ops/linalg.py`` for the slice. ``chol3`` and
``tri3_solve`` keep the JAX package's closed form: the beta block factors
one 3x3 matrix per (chain, horizon, item), and the scalar recurrence is a
few elementwise passes over that batch.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["host_cholesky_f64", "chol3", "tri3_solve", "tri_solve"]


def host_cholesky_f64(gram: np.ndarray, jitter: float, dtype=np.float32) -> np.ndarray:
    """One-time host float64 Cholesky of ``gram + jitter I``, cast to ``dtype``."""
    gram = np.asarray(gram, np.float64)
    n = gram.shape[-1]
    L = np.linalg.cholesky(gram + jitter * np.eye(n))
    return L.astype(dtype)


def chol3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form lower Cholesky of batched SPD 3x3 matrices (..., 3, 3)."""
    a = torch.sqrt(M[..., 0, 0])
    b = M[..., 1, 0] / a
    c = M[..., 2, 0] / a
    d = torch.sqrt(M[..., 1, 1] - b * b)
    e = (M[..., 2, 1] - c * b) / d
    f = torch.sqrt(M[..., 2, 2] - c * c - e * e)
    z = torch.zeros_like(a)
    return torch.stack([
        torch.stack([a, z, z], -1),
        torch.stack([b, d, z], -1),
        torch.stack([c, e, f], -1),
    ], -2)


def tri3_solve(L: torch.Tensor, b: torch.Tensor, *, trans: bool = False) -> torch.Tensor:
    """Solve L x = b (or L^T x = b) for lower-triangular 3x3 ``L``.

    L: (..., 3, 3); b: (..., 3, k).
    """
    l00 = L[..., 0, 0, None]
    l10 = L[..., 1, 0, None]
    l11 = L[..., 1, 1, None]
    l20 = L[..., 2, 0, None]
    l21 = L[..., 2, 1, None]
    l22 = L[..., 2, 2, None]
    b0, b1, b2 = b[..., 0, :], b[..., 1, :], b[..., 2, :]
    if not trans:
        x0 = b0 / l00
        x1 = (b1 - l10 * x0) / l11
        x2 = (b2 - l20 * x0 - l21 * x1) / l22
    else:
        x2 = b2 / l22
        x1 = (b1 - l21 * x2) / l11
        x0 = (b0 - l10 * x1 - l20 * x2) / l00
    return torch.stack([x0, x1, x2], dim=-2)


def tri_solve(L: torch.Tensor, b: torch.Tensor, *, trans: bool = False) -> torch.Tensor:
    """Solve ``L x = b`` (or ``L^T x = b`` when ``trans``), lower-triangular
    ``L``, batched over leading axes."""
    if trans:
        return torch.linalg.solve_triangular(L.mT, b, upper=True)
    return torch.linalg.solve_triangular(L, b, upper=False)
