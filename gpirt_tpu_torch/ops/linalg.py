"""Dense linear-algebra helpers: jittered Cholesky factors, closed-form 3x3
factors and triangular solves, and a lane-wise call run a fixed number of
lanes at a time.

Counterpart of ``gpirt_tpu/ops/linalg.py``. ``chol3`` and ``tri3_solve``
keep the JAX package's closed form: the beta block factors one 3x3 matrix
per (chain, horizon, item), and the scalar recurrence is a few elementwise
passes over that batch. A failed factorization gives NaN, as
``jnp.linalg.cholesky`` does, and never a host sync to find out.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "host_cholesky_f64",
    "cholesky",
    "chol_with_jitter",
    "double_solve",
    "chol3",
    "tri3_solve",
    "spd3_solve",
    "tri_solve",
    "LANE_CHUNK",
    "lane_chunked",
]

# The lanes (chains) a batch-dependent library call sees at once
# (:func:`lane_chunked`): the main path's batch, so that a run of 64 chains
# makes each such call once, as it is. A lane-wise call's shape is fixed by
# the chunk, not by the batch.
LANE_CHUNK = 64


def host_cholesky_f64(gram: np.ndarray, jitter: float, dtype=np.float32) -> np.ndarray:
    """One-time host float64 Cholesky of ``gram + jitter I``, cast to ``dtype``."""
    gram = np.asarray(gram, np.float64)
    n = gram.shape[-1]
    L = np.linalg.cholesky(gram + jitter * np.eye(n))
    return L.astype(dtype)


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor over the trailing (n, n) axes; a matrix whose
    factorization fails gives all NaN. ``torch.linalg.cholesky`` would
    raise instead, and on the card it syncs with the host to check."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def chol_with_jitter(gram: torch.Tensor, jitter: float, *,
                     normalized: bool = False) -> torch.Tensor:
    """Lower Cholesky of ``gram + jitter I`` over the trailing (n, n) axes.

    ``normalized`` is the float32 stability mode: factor the correlation
    form, K = D^{1/2} C D^{1/2} with unit-diagonal C, as
    D^{1/2} chol(C + jitter I). The ICC Gram's diagonal spans ~4 orders of
    magnitude (its quadratic term grows as theta^4), and normalizing bounds
    the rounding error by ~n eps32 whatever the kernel's scale; the nugget
    becomes relative, jitter k(theta_i, theta_i) a point
    (``gpirt_tpu/ops/linalg.py:28``).
    """
    eye = torch.eye(gram.shape[-1], dtype=gram.dtype, device=gram.device)
    if not normalized:
        return cholesky(gram + jitter * eye)
    d = torch.sqrt(torch.diagonal(gram, dim1=-2, dim2=-1))  # (..., n)
    inv = 1.0 / d
    C = gram * (inv.unsqueeze(-1) * inv.unsqueeze(-2))
    return d.unsqueeze(-1) * cholesky(C + jitter * eye)


def double_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(L L^T)^{-1} b`` by two triangular solves (reference double_solve)."""
    return tri_solve(L, tri_solve(L, b), trans=True)


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


def spd3_solve(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """M^{-1} b for a batch of SPD 3x3 matrices: :func:`chol3` and two
    :func:`tri3_solve` substitutions. M (..., 3, 3), b (..., 3, k)."""
    L = chol3(M)
    return tri3_solve(L, tri3_solve(L, b), trans=True)


def tri_solve(L: torch.Tensor, b: torch.Tensor, *, trans: bool = False) -> torch.Tensor:
    """Solve ``L x = b`` (or ``L^T x = b`` when ``trans``), lower-triangular
    ``L``, batched over leading axes."""
    if trans:
        return torch.linalg.solve_triangular(L.mT, b, upper=True)
    return torch.linalg.solve_triangular(L, b, upper=False)


def lane_chunked(fn, *args: torch.Tensor) -> torch.Tensor:
    """``fn(*args)``, computed :data:`LANE_CHUNK` lanes at a time: the
    leading axis of every argument is the lane axis, and ``fn`` must treat
    the lanes apart. The last chunk is padded with copies of its last lane,
    so the library sees one shape whatever the number of lanes, and a
    lane's result does not depend on how many lanes are batched with it.
    The rule: a lane-wise call's shape is fixed by the chunk, not by the
    batch. On the card the library's plan otherwise follows the batch and
    rounds a lane otherwise: cuBLAS picks its batched GEMM and its batched
    triangular solve by the batch count, and torch's reductions split a sum
    by the number of outputs. The sweep runs through here beta's last
    product (``models/gibbs.py``, ``draw_beta_conjugate``), the sums over
    the sites of the ordinal Newton cutpoint update and of the grid f*
    ESS's likelihood, the GP theta draw's sessions product, and the affine
    moves' solves against A = K_SE + T I (``models/affine.py``,
    ``_a_solve``); on the CPU the padding changes nothing.
    :data:`LANE_CHUNK` lanes are one call, as they are."""
    chunk = LANE_CHUNK
    K = args[0].shape[0]
    if K == chunk:
        return fn(*args)
    parts = []
    for lo in range(0, K, chunk):
        hi = min(lo + chunk, K)
        if hi - lo == chunk:
            part = [a[lo:hi] for a in args]
        else:
            idx = torch.arange(lo, lo + chunk, device=args[0].device).clamp_(max=K - 1)
            part = [a[idx] for a in args]
        parts.append(fn(*part)[:hi - lo])
    return parts[0] if len(parts) == 1 else torch.cat(parts)
