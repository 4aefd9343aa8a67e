"""The collective affine theta moves of the conjugate sweep, and the dense
Woodbury factorisation of B = K(theta) + T I they stand on.

Counterpart of ``gpirt_tpu/models/gibbs.py:886-1052`` and ``:1110-1561``
without the respondent-sharded (low-rank) forms. Under the Albert-Chib
augmentation z = f(theta) + mu(theta) + eps, integrating f over its GP
prior gives each item's latents z_.j ~ N(mu_j(theta), K_theta + T I): the
z-marginal, which the moves target with f* collapsed out.

The ICC kernel splits exactly as K = K_SE + Psi Psi^T (Psi the rank-3
polynomial part), so B = A + Psi Psi^T with A = K_SE + T I, whose
condition is at most n + 1 for any theta: every solve is one Cholesky of A
and a 3 x 3 capacitance C3 = I3 + Psi^T A^{-1} Psi, each with one
refinement step.

The moves (``affine_theta_moves``), on all respondents of a chain at once:
  shift:    a windowed Gibbs draw over the compensated-shift orbit
            (theta + k steps, T_k beta), which leaves A and the residual
            z - mu exactly invariant, so one factorisation serves every
            offset (``shift_orbit_gibbs``);
  dilation: idx' = round(cen + a (idx - cen)), log a ~ N(0, sd^2), beta
            unchanged, corrected by the exact interval probability of the
            rounded map (``_dilation_interval_logq``); ``affine_rounds`` MH
            rounds.
Every decision is a (K,) tensor, one a chain: no host sync. Accept ratios
are formed from elementwise differences of the Woodbury parts, since their
totals are ~1e5 while a move changes them by O(1).

``counts`` holds the calls of ``affine_theta_moves`` and, as device
tensors summed over chains (read once, after a run, so no sync a sweep),
the orbit draws accepted, those that moved their chain, and the
dilations accepted. Set its entries to 0 to count a run.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gpirt_tpu_torch.models.config import GPIRTConfig, GPIRTConstants
from gpirt_tpu_torch.models.gibbs import (
    AffineDraws,
    _gumbel_argmax,
    _per_chain,
    compute_mu,
    theta_from_indices,
)
from gpirt_tpu_torch.ops.linalg import chol3, cholesky, tri3_solve, tri_solve

__all__ = [
    "WoodburyB",
    "woodbury_factors",
    "woodbury_solve",
    "woodbury_quad_parts",
    "shift_orbit_gibbs",
    "affine_theta_moves",
    "counts",
]

counts = {"calls": 0, "orbit_accepted": 0, "orbit_moved": 0, "dilations_accepted": 0}


class WoodburyB(NamedTuple):
    """Factors of B = K(theta) + T I = A + Psi Psi^T, A = K_SE + T I:
    B^{-1} = A^{-1} - A^{-1} Psi C3^{-1} Psi^T A^{-1}, logdet B = logdet A +
    logdet C3. Leading axes (K, H)."""

    La: torch.Tensor  # (..., n, n) chol(A)
    A: torch.Tensor  # (..., n, n) kept for the refinement residuals
    Psi: torch.Tensor  # (..., n, 3)
    AinvPsi: torch.Tensor  # (..., n, 3) refined A^{-1} Psi
    C3: torch.Tensor  # (..., 3, 3) I3 + Psi^T A^{-1} Psi
    Lc3: torch.Tensor  # (..., 3, 3) chol(C3)
    logdet: torch.Tensor  # (...) logdet B


def _a_solve(La, A, r):
    """A^{-1} r by two triangular solves and one refinement step."""
    x = tri_solve(La, tri_solve(La, r), trans=True)
    res = r - A @ x
    return x + tri_solve(La, tri_solve(La, res), trans=True)


def _c3_solve(Lc3, C3, u):
    """C3^{-1} u for batched 3 x 3 C3 by the closed-form substitutions,
    with one refinement step."""
    v = tri3_solve(Lc3, tri3_solve(Lc3, u), trans=True)
    res = u - C3 @ v
    return v + tri3_solve(Lc3, tri3_solve(Lc3, res), trans=True)


def _se_gram(theta_idx, consts: GPIRTConstants, temp) -> torch.Tensor:
    """A = K_SE(theta, theta) + T I: theta_idx (K, H, n) -> (K, H, n, n);
    ``temp`` None (T = 1), a float, or a (K,) tensor of one a chain."""
    A = consts.grid_gram_se[theta_idx.unsqueeze(-1), theta_idx.unsqueeze(-2)]
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    t = 1.0 if temp is None else _per_chain(temp, A.ndim)
    return A + t * eye


def woodbury_factors(theta_idx, consts: GPIRTConstants, temp=None) -> WoodburyB:
    """Factors of B = K(theta) + T I for theta_idx (K, H, n)."""
    A = _se_gram(theta_idx, consts, temp)
    La = cholesky(A)
    Psi = consts.Psi_grid[theta_idx]  # (K, H, n, 3)
    AinvPsi = _a_solve(La, A, Psi)
    C3 = torch.eye(3, dtype=A.dtype, device=A.device) + Psi.mT @ AinvPsi
    Lc3 = chol3(C3)
    logdet = 2.0 * (torch.log(torch.diagonal(La, dim1=-2, dim2=-1)).sum(dim=-1)
                    + torch.log(torch.diagonal(Lc3, dim1=-2, dim2=-1)).sum(dim=-1))
    return WoodburyB(La=La, A=A, Psi=Psi, AinvPsi=AinvPsi, C3=C3, Lc3=Lc3, logdet=logdet)


def woodbury_solve(wb: WoodburyB, r: torch.Tensor) -> torch.Tensor:
    """B^{-1} r for r (..., n, m)."""
    x = _a_solve(wb.La, wb.A, r)
    v = _c3_solve(wb.Lc3, wb.C3, wb.Psi.mT @ x)
    return x - wb.AinvPsi @ v


def woodbury_quad_parts(wb: WoodburyB, r: torch.Tensor):
    """(p, q) with r^T B^{-1} r = sum(p) - sum(q), kept elementwise so that
    an accept ratio differences two states entry by entry: p = r * A^{-1} r
    (..., n, m), q = u * C3^{-1} u (..., 3, m) with u = Psi^T A^{-1} r."""
    x = _a_solve(wb.La, wb.A, r)
    u = wb.Psi.mT @ x
    return r * x, u * _c3_solve(wb.Lc3, wb.C3, u)


def _theta_logprior_total(theta, consts: GPIRTConstants, config: GPIRTConfig):
    """The log-prior of whole theta configurations (..., H, n) -> (...),
    the prior the grid theta draw targets: CST each respondent once with
    variance 1 + sds^2 (src/draw-theta.cpp:158), RDM each (session,
    respondent), GP the time GP with precision Lambda_time."""
    var = 1.0 + torch.square(consts.theta_prior_sds[0])  # (n,)
    regime = config.theta_regime
    if regime == "CST":
        return -0.5 * (torch.square(theta[..., 0, :]) / var).sum(dim=-1)
    if regime == "RDM":
        return -0.5 * (torch.square(theta) / var).sum(dim=(-2, -1))
    return -0.5 * torch.einsum("...hi,hg,...gi->...", theta, consts.Lambda_time, theta)


def _z_marginal_parts(theta_idx, z, beta, consts: GPIRTConstants, config: GPIRTConfig,
                      temp=None):
    """Pieces of log p(theta) + log p(z | theta, beta), f* marginalised:
    (p, q, small), the quadratic form -0.5 (sum p - sum q) and small =
    -0.5 m logdet B + log p(theta) (K,). theta_idx (K, H, n), z (K, H, n, m),
    beta (K, H, 3, m); ``temp`` as the sweep's."""
    m = z.shape[-1]
    theta = theta_from_indices(theta_idx, consts)
    wb = woodbury_factors(theta_idx, consts, temp)
    p, q = woodbury_quad_parts(wb, z - compute_mu(theta, beta))
    small = -0.5 * m * wb.logdet.sum(dim=-1) + _theta_logprior_total(theta, consts, config)
    return p, q, small


def _z_marginal_delta(parts_new, parts_old) -> torch.Tensor:
    """log-posterior difference new - old (K,) from the elementwise
    differences of two :func:`_z_marginal_parts`."""
    p_n, q_n, s_n = parts_new
    p_o, q_o, s_o = parts_old
    dp = (p_n - p_o).sum(dim=(-3, -2, -1))
    dq = (q_n - q_o).sum(dim=(-3, -2, -1))
    return -0.5 * (dp - dq) + (s_n - s_o)


def _dilation_interval_logq(d, dp, sd: float) -> torch.Tensor:
    """log q(idx -> idx') (K,) of the dilation proposal idx' = round(cen +
    a d), d and dp the centred indices (K, H, n): the factors a = e^l, l ~
    N(0, sd^2), that map every d_i to dp_i form the intersection of the
    sites' intervals, an exact Gaussian-CDF difference in log a. A site at
    the centre is unconstrained if it stays there and unreachable
    otherwise (log q = -inf)."""
    safe_d = torch.where(d == 0, 1.0, d)
    lo_pos = (dp - 0.5) / safe_d
    hi_pos = (dp + 0.5) / safe_d
    lo = torch.where(d > 0, lo_pos, hi_pos)
    hi = torch.where(d > 0, hi_pos, lo_pos)
    reachable = (d != 0) | (dp == 0)
    lo = torch.where(d == 0, 1e-30, lo)
    hi = torch.where(d == 0, 1e30, hi)
    hi = torch.where(reachable, hi, -1.0)  # an empty interval: -inf
    a_lo = torch.clamp(lo.amax(dim=(-2, -1)), 1e-30, 1e30)
    a_hi = torch.clamp(hi.amin(dim=(-2, -1)), 1e-30, 1e30)
    lp_hi = torch.special.log_ndtr(torch.log(a_hi) / sd)
    lp_lo = torch.special.log_ndtr(torch.log(a_lo) / sd)
    diff = torch.where(lp_hi > lp_lo, -torch.expm1(lp_lo - lp_hi), 0.0)
    logq = lp_hi + torch.log(torch.clamp(diff, min=1e-30))
    return torch.where(a_hi > a_lo, logq, -math.inf)


def _beta_shift_map(beta, delta) -> torch.Tensor:
    """T_delta(beta), the coefficients with mu_{beta'}(theta + delta) =
    mu_beta(theta): beta (..., 3, m), delta broadcasting over (..., 1)."""
    b0, b1, b2 = beta[..., 0, :], beta[..., 1, :], beta[..., 2, :]
    return torch.stack(torch.broadcast_tensors(
        b0 - b1 * delta + b2 * delta * delta, b1 - 2.0 * b2 * delta, b2), dim=-2)


def _beta_logprior_delta(beta_new, beta_old, consts: GPIRTConstants) -> torch.Tensor:
    """log p(beta') - log p(beta) (K,) under the N(0, sds^2 + 1e-6) prior
    of the sampler (src/draw-beta.cpp:16), elementwise then summed."""
    var = torch.square(consts.beta_prior_sds) + 1e-6
    return -0.5 * ((torch.square(beta_new) - torch.square(beta_old)) / var).sum(
        dim=(-3, -2, -1))


def shift_orbit_gibbs(theta_idx, z, beta, consts: GPIRTConstants, config: GPIRTConfig,
                      u_pick, u_acc, temp=None):
    """The windowed Gibbs draw of each chain's collective location
    (``gpirt_tpu/models/gibbs.py:1324``). log pi is evaluated on the J =
    4W + 1 offsets -2W..2W of the orbit (theta + k, T_k beta), W =
    affine_shift_max, from one Cholesky of A and per offset rank-3 solves;
    an offset is picked by Gumbel-max over the centred window -W..W and
    accepted by the window-normaliser ratio Z(centre) / Z(picked window).
    Offsets that leave the grid have log pi = -inf.

    theta_idx (K, H, n), z (K, H, n, m), beta (K, H, 3, m); u_pick
    (K, 2W+1) and u_acc (K,) uniforms. Returns (theta_idx, beta).
    """
    N, W = config.grid_size, config.affine_shift_max
    H, n, m = z.shape[-3:]
    step = 10.0 / (N - 1)
    offs = torch.arange(-2 * W, 2 * W + 1, device=z.device)  # (J,)
    J = offs.numel()
    r = z - compute_mu(theta_from_indices(theta_idx, consts), beta)
    idx_j = theta_idx.unsqueeze(0) + offs.reshape(-1, 1, 1, 1)  # (J, K, H, n)
    valid = (idx_j.amin(dim=(-2, -1)) >= 0) & (idx_j.amax(dim=(-2, -1)) <= N - 1)
    idx_jc = torch.clamp(idx_j, 0, N - 1)

    A = _se_gram(theta_idx, consts, temp)  # orbit-invariant
    La = cholesky(A)
    Psi_j = consts.Psi_grid[idx_jc]  # (J, K, H, n, 3)
    K = theta_idx.shape[0]
    Pfl = Psi_j.permute(1, 2, 3, 0, 4).reshape(K, H, n, J * 3)
    sol = _a_solve(La, A, torch.cat([r, Pfl], dim=-1))  # A^{-1} r and A^{-1} Psi_j
    x = sol[..., :m]
    AinvP = sol[..., m:].reshape(K, H, n, J, 3).permute(3, 0, 1, 2, 4)  # (J, K, H, n, 3)
    u = Psi_j.mT @ x  # (J, K, H, 3, m)
    C3 = torch.eye(3, dtype=z.dtype, device=z.device) + Psi_j.mT @ AinvP
    Lc3 = chol3(C3)
    q = (u * _c3_solve(Lc3, C3, u)).sum(dim=(-3, -2, -1))  # (J, K)
    # logdet B_j = logdet A (orbit-invariant, drops) + logdet C3_j
    ld = 2.0 * torch.log(torch.diagonal(Lc3, dim1=-2, dim2=-1)).sum(dim=(-2, -1))

    thp = _theta_logprior_total(consts.grid[idx_jc], consts, config)  # (J, K)
    delta_j = offs.to(z.dtype) * step
    beta_j = _beta_shift_map(beta, delta_j.reshape(-1, 1, 1, 1))  # (J, K, H, 3, m)
    var_b = torch.square(consts.beta_prior_sds) + 1e-6
    bp = -0.5 * (torch.square(beta_j) / var_b).sum(dim=(-3, -2, -1))
    # log pi relative over the orbit (sum p is invariant and drops)
    logp = torch.where(valid, 0.5 * q - 0.5 * m * ld + thp + bp, -math.inf).mT  # (K, J)

    center = logp[:, W:3 * W + 1]  # offsets -W..W
    pick = _gumbel_argmax(u_pick, center, dim=-1)  # (K,) in 0..2W
    windows = logp.unfold(-1, 2 * W + 1, 1)  # (K, 2W+1, 2W+1): window of each pick
    rev = torch.take_along_dim(windows, pick.reshape(-1, 1, 1), dim=1).squeeze(1)
    acc = torch.log(u_acc) < torch.logsumexp(center, -1) - torch.logsumexp(rev, -1)
    o_star = torch.where(acc, pick - W, 0)
    counts["orbit_accepted"] = counts["orbit_accepted"] + acc.sum()
    counts["orbit_moved"] = counts["orbit_moved"] + (o_star != 0).sum()
    beta_new = torch.take_along_dim(beta_j, (o_star + 2 * W).reshape(1, -1, 1, 1, 1),
                                    dim=0).squeeze(0)
    return torch.clamp(theta_idx + o_star.reshape(-1, 1, 1), 0, N - 1), beta_new


def affine_theta_moves(theta_idx, z, beta, consts: GPIRTConstants, config: GPIRTConfig,
                       draws: AffineDraws, temp=None):
    """The collective shift and dilation MH moves on (theta, beta) against
    the z-marginal (``gpirt_tpu/models/gibbs.py:1456``): the orbit draw when
    affine_shift_max > 0, then affine_rounds dilation rounds, each accepted
    per chain when it stays on the grid, its ratio is finite and above the
    round's log uniform. Returns (theta_idx, beta)."""
    counts["calls"] += 1
    if config.affine_shift_max > 0:
        theta_idx, beta = shift_orbit_gibbs(theta_idx, z, beta, consts, config,
                                            draws.u_pick, draws.u_acc, temp)
    if config.affine_rounds == 0:
        return theta_idx, beta
    N, sd, dt = config.grid_size, config.affine_dilate_sd, z.dtype
    cen = (N - 1) / 2.0
    parts = _z_marginal_parts(theta_idx, z, beta, consts, config, temp)
    idx = theta_idx
    for ell, u in zip(draws.ell, draws.u_dil):
        a = torch.exp(ell * sd).reshape(-1, 1, 1)
        d = idx.to(dt) - cen
        idx_d = torch.round(cen + a * d).long()  # half to even, as jnp.round
        ok = (idx_d.amin(dim=(-2, -1)) >= 0) & (idx_d.amax(dim=(-2, -1)) <= N - 1)
        idx_d = torch.clamp(idx_d, 0, N - 1)
        dp = idx_d.to(dt) - cen
        parts_d = _z_marginal_parts(idx_d, z, beta, consts, config, temp)
        ratio = (_z_marginal_delta(parts_d, parts)
                 + _dilation_interval_logq(dp, d, sd) - _dilation_interval_logq(d, dp, sd))
        acc = ok & torch.isfinite(ratio) & (torch.log(u) < ratio)
        counts["dilations_accepted"] = counts["dilations_accepted"] + acc.sum()
        idx = torch.where(acc.reshape(-1, 1, 1), idx_d, idx)
        parts = tuple(torch.where(acc.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)
                      for new, old in zip(parts_d, parts))
    return idx, beta

