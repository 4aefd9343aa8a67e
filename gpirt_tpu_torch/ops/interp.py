"""One-dimensional linear interpolation with ``jnp.interp``'s semantics.

Counterpart of ``jax.numpy.interp`` (``jax/_src/numpy/lax_numpy.py::_interp``)
as the JAX package's constant_IRF f* | f draw calls it
(``gpirt_tpu/models/gibbs.py:380``): snapped theta gives many tied abscissae,
so which tied ordinate is read must be JAX's. The segment of x is
``i = clip(searchsorted(xp, x, side="right"), 1, len(xp) - 1)``; a segment of
width at most ``spacing(eps)`` reads ``fp[i-1]``; left of ``xp[0]`` reads
``fp[0]`` and right of ``xp[-1]`` reads ``fp[-1]``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["interp"]


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Interpolate every column of ``fp`` at ``x``, batched.

    Args:
      x: ``(..., P)`` points.
      xp: ``(..., M)`` sorted abscissae, or ``(M,)`` shared by the batch.
      fp: ``(..., M, c)`` ordinates, one column per function.

    Returns:
      ``(..., P, c)``.
    """
    M = xp.shape[-1]
    xp = xp.expand(x.shape[:-1] + (M,)).contiguous()
    fp = fp.expand(x.shape[:-1] + fp.shape[-2:])
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, M - 1)
    x_hi, x_lo = torch.take_along_dim(xp, i, -1), torch.take_along_dim(xp, i - 1, -1)
    f_hi = torch.take_along_dim(fp, i.unsqueeze(-1), -2)
    f_lo = torch.take_along_dim(fp, (i - 1).unsqueeze(-1), -2)
    dx = (x_hi - x_lo).unsqueeze(-1)
    delta = (x - x_lo).unsqueeze(-1)
    eps = float(np.spacing(torch.finfo(x.dtype).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, f_lo, f_lo + (delta / torch.where(dx0, 1.0, dx)) * (f_hi - f_lo))
    f = torch.where((x < xp[..., :1]).unsqueeze(-1), fp[..., :1, :], f)
    return torch.where((x > xp[..., -1:]).unsqueeze(-1), fp[..., -1:, :], f)
