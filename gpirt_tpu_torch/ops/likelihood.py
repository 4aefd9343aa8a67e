"""Ordinal-probit likelihood and cutpoint transforms on dense masked tensors.

Model (reference: src/log-likelihood.cpp:19-33):
  P(y = c | g) = Phi(t_c - g) - Phi(t_{c-1} - g),  g = f + mu,
with per-item cutpoints t_0 = -inf < t_1 < ... < t_C = +inf and a floor of
1e-6 inside the log. Responses are int32 categories 1..C, 0 = missing.
Counterpart of ``gpirt_tpu/ops/likelihood.py``.
"""

from __future__ import annotations

import torch

__all__ = [
    "LL_FLOOR",
    "category_logprobs",
    "ordinal_ll_terms",
    "ordinal_ll",
    "cutpoint_bounds",
    "ll_terms_from_bounds",
    "delta_to_threshold",
    "threshold_to_delta",
]

LL_FLOOR = 1e-6
_INV_SQRT2 = 0.7071067811865476


def _norm_cdf(z: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(z * _INV_SQRT2))


def cutpoint_bounds(y: torch.Tensor, thresholds: torch.Tensor):
    """Each observation's cutpoint interval (t_{y-1}, t_y).

    Args:
      y: ``(..., n, m)`` int categories 1..C, 0 = missing.
      thresholds: ``(..., m, C+1)`` with +-inf endpoints, broadcastable
        against y's batch axes.

    Returns ``(z_lo, z_hi, mask)``: two ``(..., n, m)`` tensors and the
    observed mask. Infinite endpoints come back clamped to +-1e30.
    """
    t_clip = torch.clamp(thresholds, -1e30, 1e30)
    Cp1 = thresholds.shape[-1]
    ysafe = torch.clamp(y.long(), min=1)
    lead = torch.broadcast_shapes(t_clip.shape[:-2], y.shape[:-2])
    n, m = y.shape[-2:]
    t_b = t_clip.unsqueeze(-3).expand(lead + (n, m, Cp1))
    y_b = ysafe.expand(lead + (n, m)).unsqueeze(-1)
    z_hi = torch.gather(t_b, -1, y_b)[..., 0]
    z_lo = torch.gather(t_b, -1, y_b - 1)[..., 0]
    return z_lo, z_hi, y > 0


def category_logprobs(g, thresholds, C: int, c) -> torch.Tensor:
    """log P(y = c | g) for every category: (..., m) g -> (..., m, C); one
    Phi per interior cutpoint, at the scale ``c`` (1/sqrt(2), times
    1/sqrt(T) when tempered): a float, or a (K,) tensor of one a chain."""
    z = thresholds[..., 1:C] - g.unsqueeze(-1)
    if torch.is_tensor(c):
        c = c.reshape((-1,) + (1,) * (z.ndim - 1))
    cdf = 0.5 * (1.0 + torch.erf(z * c))
    zero = torch.zeros(cdf.shape[:-1] + (1,), dtype=g.dtype, device=g.device)
    cdf = torch.cat([zero, cdf, zero + 1.0], dim=-1)
    p = cdf[..., 1:] - cdf[..., :-1]
    return torch.log(p + 1e-6)


def ll_terms_from_bounds(g, z_lo, z_hi, mask, inv_s=None) -> torch.Tensor:
    """``log(Phi((z_hi - g) s) - Phi((z_lo - g) s) + 1e-6)``, 0 where masked;
    ``inv_s = 1/sqrt(T)`` tempers."""
    if inv_s is None:
        p = _norm_cdf(z_hi - g) - _norm_cdf(z_lo - g)
    else:
        p = _norm_cdf((z_hi - g) * inv_s) - _norm_cdf((z_lo - g) * inv_s)
    terms = torch.log(p + LL_FLOOR)
    return torch.where(mask, terms, torch.zeros((), dtype=g.dtype, device=g.device))


def ordinal_ll_terms(g, y, thresholds, inv_s=None) -> torch.Tensor:
    """Per-response log-likelihood terms, 0 where missing.

    Args:
      g: ``(..., n, m)`` latent values ``f + mu``.
      y: ``(..., n, m)`` int categories 1..C, 0 = missing.
      thresholds: ``(..., m, C+1)`` cutpoints with -inf / +inf endpoints.
      inv_s: optional tempering scale 1/sqrt(T).
    """
    if thresholds.shape[-1] == 3:
        # binary fast path: one Phi per cell at the single interior cutpoint
        t1 = thresholds[..., 1]
        z = t1.unsqueeze(-2) - g
        phi = _norm_cdf(z if inv_s is None else z * inv_s)
        p = torch.where(y == 1, phi, 1.0 - phi)
        terms = torch.log(p + LL_FLOOR)
        return torch.where(y > 0, terms,
                           torch.zeros((), dtype=g.dtype, device=g.device))
    z_lo, z_hi, mask = cutpoint_bounds(y, thresholds)
    return ll_terms_from_bounds(g, z_lo, z_hi, mask, inv_s=inv_s)


def ordinal_ll(g: torch.Tensor, y: torch.Tensor, thresholds: torch.Tensor,
               axis=None) -> torch.Tensor:
    """The masked ordinal-probit log-likelihood, :func:`ordinal_ll_terms`
    summed over ``axis`` (None: every axis), the reference's
    ``ll_bar_sparse`` over the observed cells (src/log-likelihood.cpp:50-64)."""
    terms = ordinal_ll_terms(g, y, thresholds)
    return terms.sum() if axis is None else terms.sum(dim=axis)


def delta_to_threshold(deltas: torch.Tensor) -> torch.Tensor:
    """Unconstrained deltas (..., C-1) -> monotone cutpoints (..., C+1):
    t_0 = -inf, t_1 = delta_0, t_{c+1} = t_c + exp(delta_c), t_C = +inf
    (reference: src/log-likelihood.cpp:66-77)."""
    first = deltas[..., :1]
    if deltas.shape[-1] > 1:
        inner = first + torch.cumsum(torch.exp(deltas[..., 1:]), dim=-1)
        finite = torch.cat([first, inner], dim=-1)
    else:
        finite = first
    neg = torch.full_like(first, float("-inf"))
    pos = torch.full_like(first, float("inf"))
    return torch.cat([neg, finite, pos], dim=-1)


def threshold_to_delta(thresholds: torch.Tensor) -> torch.Tensor:
    """Monotone cutpoints (..., C+1) -> unconstrained deltas (..., C-1):
    delta_0 = t_1, delta_c = log(t_{c+1} - t_c)
    (reference: src/log-likelihood.cpp:79-88)."""
    finite = thresholds[..., 1:-1]
    first = finite[..., :1]
    if finite.shape[-1] > 1:
        gaps = torch.log(finite[..., 1:] - finite[..., :-1])
        return torch.cat([first, gaps], dim=-1)
    return first
