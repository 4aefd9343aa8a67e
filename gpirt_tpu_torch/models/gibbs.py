"""The GP-IRT Gibbs sweep on a batch of K chains: the conjugate path.

Counterpart of the conjugate branch of ``gpirt_tpu/models/gibbs.py``. Chains
are a written-out leading K axis. Every block is a pure function of the
state and of its random draws, passed in as tensors; :func:`sweep_draws`
makes one sweep's draws from a ``torch.Generator`` and :func:`gibbs_sweep`
applies the blocks in the order of src/gpirtMCMC.cpp:261-331:

  theta | f*  ->  z | theta, f*  ->  f* | z  ->  beta | z, f  ->  t | f, mu
  ->  ll.

The cutpoint block runs through the hand-written CUDA kernel on the card
(``ops/threshold_ess.py``), tempered and untempered alike.

Layouts put the chain axis first, then the horizon:
  theta_idx (K, H, n) int64, f (K, H, n, m), beta (K, H, 3, m),
  thresholds (K, H, m, C+1), fstar (K, H, N, m); responses y (H, n, m).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from gpirt_tpu_torch.models.config import (
    GPIRTConfig,
    GPIRTConstants,
    THETA_HI,
    THETA_LO,
)
from gpirt_tpu_torch.ops.likelihood import delta_to_threshold, ordinal_ll_terms
from gpirt_tpu_torch.ops.linalg import chol3, tri3_solve, tri_solve
from gpirt_tpu_torch.ops.threshold_ess import binary_threshold_ess

__all__ = [
    "GPIRTState",
    "InitDraws",
    "SweepDraws",
    "snap_indices",
    "theta_from_indices",
    "compute_mu",
    "compute_mu_star",
    "theta_site_basis",
    "init_draws",
    "init_state",
    "sweep_draws",
    "draw_z_truncnorm",
    "draw_fstar_conjugate",
    "draw_beta_conjugate",
    "draw_threshold",
    "gibbs_sweep",
]

_SQRT2 = 1.4142135623730951
_INV_SQRT2 = 0.7071067811865476
_TWO_PI = 6.283185307179586


class GPIRTState(NamedTuple):
    """Markov chain state of K chains (layouts in the module docstring)."""

    theta_idx: torch.Tensor
    f: torch.Tensor
    beta: torch.Tensor
    thresholds: torch.Tensor
    fstar: torch.Tensor


class InitDraws(NamedTuple):
    z_beta: torch.Tensor  # (K, H, 3, m) standard normal
    z_fstar: torch.Tensor  # (K, H, N, m) standard normal


class SweepDraws(NamedTuple):
    """One sweep's random numbers for K chains."""

    u_theta: torch.Tensor  # (K, n, N) uniform [0, 1): Gumbel noise of the theta draw
    u_z: torch.Tensor  # (K, H, n, m) uniform: truncated-normal inverse CDF
    z_q: torch.Tensor  # (K, H, q, m) normal: f* prior, SE eigenbasis part
    z_p: torch.Tensor  # (K, H, 3, m) normal: f* prior, polynomial part
    z_n: torch.Tensor  # (K, H, N, m) normal: f* prior, grid nugget
    eps_f: torch.Tensor  # (K, H, n, m) normal: f* observation noise
    zeta: torch.Tensor  # (K, H, m, 3) normal: beta draw
    nu_t: torch.Tensor  # (K, H, m) normal: cutpoint ESS prior draw
    logu_t: torch.Tensor  # (K, H, m) log uniform: cutpoint slice level
    eps0_t: torch.Tensor  # (K, H, m) uniform [0, 2 pi): initial angle
    rs_t: torch.Tensor  # (R, K, H, m) uniform: bracket shrink per round


# ---------------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------------


def snap_indices(theta: torch.Tensor, config: GPIRTConfig) -> torch.Tensor:
    """Continuous theta -> nearest grid index (reference round((t+5)/0.01))."""
    idx = torch.round((theta - THETA_LO) / config.grid_step).long()
    return torch.clamp(idx, 0, config.grid_size - 1)


def theta_from_indices(idx: torch.Tensor, consts: GPIRTConstants) -> torch.Tensor:
    return consts.grid[idx]


def build_X(theta: torch.Tensor) -> torch.Tensor:
    """(..., n) -> (..., n, 3) design [1, theta, theta^2]."""
    return torch.stack([torch.ones_like(theta), theta, theta * theta], dim=-1)


def compute_mu(theta: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """mu = X(theta) @ beta: (..., H, n), (..., H, 3, m) -> (..., H, n, m)."""
    return build_X(theta) @ beta


def compute_mu_star(consts: GPIRTConstants, beta: torch.Tensor) -> torch.Tensor:
    """mu* = Xstar @ beta: (N, 3), (..., H, 3, m) -> (..., H, N, m)."""
    return consts.Xstar @ beta


def theta_site_basis(theta_idx: torch.Tensor, consts: GPIRTConstants) -> torch.Tensor:
    """Rows of [U_se, Psi_grid] at the snapped indices: (..., n) -> (..., n, q+3);
    U U^T = K(theta, theta) to the eigenbasis truncation."""
    return torch.cat([consts.U_se[theta_idx], consts.Psi_grid[theta_idx]], dim=-1)


def _rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a (..., N, m) at grid rows idx (..., n) -> (..., n, m)."""
    return torch.take_along_dim(a, idx.unsqueeze(-1), dim=-2)


def _temp_scales(temp):
    """(sqrt_T, 1/sqrt_T), or (None, None) untempered."""
    if temp is None:
        return None, None
    s = math.sqrt(float(temp))
    return s, 1.0 / s


# ---------------------------------------------------------------------------
# random draws
# ---------------------------------------------------------------------------


def init_draws(gen: torch.Generator, K: int, consts: GPIRTConstants,
               config: GPIRTConfig) -> InitDraws:
    dev, dt = consts.grid.device, config.tdtype
    H, m, N = config.horizon, config.m, config.grid_size
    return InitDraws(
        z_beta=torch.randn((K, H, 3, m), generator=gen, device=dev, dtype=dt),
        z_fstar=torch.randn((K, H, N, m), generator=gen, device=dev, dtype=dt),
    )


def sweep_draws(gen: torch.Generator, K: int, consts: GPIRTConstants,
                config: GPIRTConfig) -> SweepDraws:
    dev, dt = consts.grid.device, config.tdtype
    H, n, m, N = config.horizon, config.n, config.m, config.grid_size
    q = consts.U_se.shape[1]

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev, dtype=dt)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dt)

    return SweepDraws(
        u_theta=rand(K, n, N),
        u_z=rand(K, H, n, m),
        z_q=randn(K, H, q, m),
        z_p=randn(K, H, 3, m),
        z_n=randn(K, H, N, m),
        eps_f=randn(K, H, n, m),
        zeta=randn(K, H, m, 3),
        nu_t=randn(K, H, m),
        logu_t=torch.log(rand(K, H, m)),
        eps0_t=rand(K, H, m) * _TWO_PI,
        rs_t=rand(config.ess_max_rounds, K, H, m),
    )


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def init_state(theta_init: torch.Tensor, thresholds_init: torch.Tensor,
               consts: GPIRTConstants, config: GPIRTConfig,
               draws: InitDraws) -> GPIRTState:
    """Prior draws of beta and f* on the grid (src/gpirtMCMC.cpp:148-227);
    f is f* at the snapped theta_init.

    theta_init (K, H, n) or (H, n); thresholds_init (H, m, C+1).
    """
    K, H, _, m = draws.z_beta.shape
    dt = config.tdtype
    theta_idx = snap_indices(theta_init.to(dt), config)
    theta_idx = theta_idx.expand(K, H, config.n).contiguous()
    beta = consts.beta_prior_means + draws.z_beta * consts.beta_prior_sds
    fstar = consts.L_grid @ draws.z_fstar
    thresholds = thresholds_init.to(dt).expand((K,) + tuple(thresholds_init.shape))
    return GPIRTState(
        theta_idx=theta_idx,
        f=_rows(fstar, theta_idx),
        beta=beta,
        thresholds=thresholds.contiguous(),
        fstar=fstar,
    )


def _category_logprobs(g, thresholds, C: int, inv_s=None) -> torch.Tensor:
    """log P(y = c | g) for every category: (..., m) g -> (..., m, C);
    one Phi per interior cutpoint."""
    z = thresholds[..., 1:C] - g.unsqueeze(-1)
    c = _INV_SQRT2 if inv_s is None else _INV_SQRT2 * inv_s
    cdf = 0.5 * (1.0 + torch.erf(z * c))
    zero = torch.zeros(cdf.shape[:-1] + (1,), dtype=g.dtype, device=g.device)
    cdf = torch.cat([zero, cdf, zero + 1.0], dim=-1)
    p = cdf[..., 1:] - cdf[..., :-1]
    return torch.log(p + 1e-6)


def _theta_ll_table(fstar, mu_star, y, thresholds, C: int, inv_s=None):
    """Per-respondent log-likelihood at every grid point: (K, H, N, n).

    logprobs (K, H, N, m, C) contracted over (item, category) with the
    one-hot of y — one (N, m C) x (m C, n) product per chain; missing
    responses have an all-zero one-hot row.
    """
    gstar = fstar + mu_star  # (K, H, N, m)
    logp = _category_logprobs(gstar, thresholds.unsqueeze(-3), C, inv_s)
    K, H, N, m, _ = logp.shape
    cats = torch.arange(1, C + 1, device=y.device)
    onehot = (y.unsqueeze(-1) == cats).to(gstar.dtype)  # (H, n, m, C)
    return logp.reshape(K, H, N, m * C) @ onehot.reshape(H, -1, m * C).mT


def _gumbel_argmax(u: torch.Tensor, logits: torch.Tensor, dim: int) -> torch.Tensor:
    """Categorical draw by Gumbel-max from uniforms u in [0, 1); argmax
    takes the first index on ties."""
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=dim)


def _draw_theta_grid(state: GPIRTState, mu_star, y, consts: GPIRTConstants,
                     config: GPIRTConfig, u_theta, temp=None) -> torch.Tensor:
    """Exact grid draw of theta (CST regime: one theta per respondent)."""
    K, H, n = state.theta_idx.shape
    _, inv_s = _temp_scales(temp)
    table = _theta_ll_table(state.fstar, mu_star, y, state.thresholds,
                            config.C, inv_s)  # (K, H, N, n)
    var = 1.0 + torch.square(consts.theta_prior_sds[0])  # (n,)
    logprior = -0.5 * torch.square(consts.grid)[None, :] / var[:, None]  # (n, N)
    logits = table.sum(dim=1).mT + logprior  # (K, n, N)
    idx = _gumbel_argmax(u_theta, logits, dim=-1)  # (K, n)
    return idx.unsqueeze(1).expand(K, H, n)


def draw_z_truncnorm(g, y, thresholds, u, temp=None) -> torch.Tensor:
    """Albert-Chib latents, binary data: z ~ N(g, T) truncated to the
    observed category's side of t_1, unconstrained where missing.

    Inverse CDF: z = g + sqrt(2 T) erfinv(2p - 1), p between the Phi's of
    the bounds. Infinite cutpoints are clamped to +-1e30 first, and a
    far-tail interval (width < 1e-6 in probability) falls back to the
    nearest bound.
    """
    if thresholds.shape[-1] != 3:
        raise NotImplementedError("draw_z_truncnorm is ported for binary data only")
    big = 1e30
    sqrt_t, inv_s = _temp_scales(temp)
    c = _INV_SQRT2 if inv_s is None else _INV_SQRT2 * inv_s
    t1 = torch.clamp(thresholds, -big, big)[..., 1].unsqueeze(-2)  # (K, H, 1, m)
    cdf_b = 0.5 * (1.0 + torch.erf((t1 - g) * c))
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    cdf_lo = torch.where(y == 2, cdf_b, zero)
    cdf_hi = torch.where(y == 1, cdf_b, zero + 1.0)
    z_lo = torch.where(y == 2, t1, zero - big)
    z_hi = torch.where(y == 1, t1, zero + big)
    eps = 1e-6
    p = torch.clamp(cdf_lo + u * (cdf_hi - cdf_lo), eps, 1.0 - eps)
    q = _SQRT2 * torch.erfinv(2.0 * p - 1.0)
    z = g + (q if sqrt_t is None else sqrt_t * q)
    tail = (cdf_hi - cdf_lo) < eps
    fallback = torch.clamp(g, torch.where(z_lo > -1e29, z_lo, g),
                           torch.where(z_hi < 1e29, z_hi, g))
    return torch.where(tail, fallback, z)


def draw_fstar_conjugate(state: GPIRTState, z_resid, config: GPIRTConfig,
                         consts: GPIRTConstants, z_q, z_p, z_n, eps,
                         temp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact Gaussian draw of f* | z (pathwise, push-through form).

    f* = u* + K_{*theta} (K_theta + T I)^{-1} (z - mu - u - eps'), with the
    prior draw u* = U_grid z_c + sqrt(jitter) z_n factored through the grid
    basis U_grid = [U_se, Psi]. The smoother runs in the rank-(q+3) basis:
    U^T (U U^T + T I)^{-1} = (U^T U + T I)^{-1} U^T, one equilibrated
    (q+3)-square Cholesky with one refinement step.

    z_resid: (K, H, n, m) z - mu. Returns (fstar (K, H, N, m), f (K, H, n, m)).
    """
    idx = state.theta_idx
    sqrt_t, _ = _temp_scales(temp)
    zc = torch.cat([z_q, z_p], dim=-2)  # (K, H, q+3, m)
    sj = math.sqrt(config.jitter)
    U_theta = theta_site_basis(idx, consts)  # (K, H, n, q+3)
    u_theta = U_theta @ zc + sj * _rows(z_n, idx)
    if sqrt_t is not None:
        eps = eps * sqrt_t  # tempered observation noise sd sqrt(T)
    t = 1.0 if temp is None else float(temp)

    g_k = U_theta.mT @ (z_resid - u_theta - eps)  # (K, H, k, m)
    k_dim = U_theta.shape[-1]
    eye = torch.eye(k_dim, dtype=z_resid.dtype, device=z_resid.device)
    C = t * eye + U_theta.mT @ U_theta  # (K, H, k, k)
    inv_sc = 1.0 / torch.sqrt(torch.diagonal(C, dim1=-2, dim2=-1))
    Lc = torch.linalg.cholesky(C * (inv_sc.unsqueeze(-1) * inv_sc.unsqueeze(-2)))

    def c_solve(rhs):  # C^{-1} rhs, equilibrated
        w = tri_solve(Lc, rhs * inv_sc.unsqueeze(-1))
        return tri_solve(Lc, w, trans=True) * inv_sc.unsqueeze(-1)

    ua = c_solve(g_k)
    ua = ua + c_solve(g_k - C @ ua)
    U_grid = torch.cat([consts.U_se, consts.Psi_grid], dim=-1)  # (N, q+3)
    fstar = U_grid @ (zc + ua) + sj * z_n
    return fstar, _rows(fstar, idx)


def draw_beta_conjugate(theta, z_minus_f, consts: GPIRTConstants,
                        config: GPIRTConfig, zeta, temp=None) -> torch.Tensor:
    """Exact Gaussian draw of beta | z, f per (chain, horizon, item).

    The regression runs in the standardized basis [1, u, u^2], u = (theta -
    c)/s, so the 3x3 Gram is O(n)-conditioned at any location and scale;
    the draw maps back through the analytic inverse of the change of basis.
    theta (K, H, n), z_minus_f (K, H, n, m), zeta (K, H, m, 3) -> (K, H, 3, m).
    """
    c = theta.mean(dim=-1)
    s = theta.std(dim=-1, correction=0) + 1e-3  # population sd, as jnp.std
    u = (theta - c.unsqueeze(-1)) / s.unsqueeze(-1)
    Xt = build_X(u)  # (K, H, n, 3)
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    Minv = torch.stack([
        torch.stack([one, -c / s, (c * c) / (s * s)], -1),
        torch.stack([zero, 1.0 / s, -2 * c / (s * s)], -1),
        torch.stack([zero, zero, 1.0 / (s * s)], -1),
    ], -2)  # (K, H, 3, 3)
    XtX = Xt.mT @ Xt  # (K, H, 3, 3)
    Xtz = Xt.mT @ z_minus_f  # (K, H, 3, m)
    if temp is not None:
        inv_t = 1.0 / float(temp)  # noise variance T
        XtX = XtX * inv_t
        Xtz = Xtz * inv_t
    d_inv = 1.0 / (torch.square(consts.beta_prior_sds) + 1e-6)  # (3, m)
    pp = torch.einsum("khpq,pm,khpr->khmqr", Minv, d_inv, Minv)  # (K, H, m, 3, 3)
    prec = XtX.unsqueeze(2) + pp
    inv_sc = 1.0 / torch.sqrt(torch.diagonal(prec, dim1=-2, dim2=-1))  # (K, H, m, 3)
    Lc = chol3(prec * (inv_sc.unsqueeze(-1) * inv_sc.unsqueeze(-2)))
    rhs = Xtz.mT * inv_sc  # (K, H, m, 3)
    w = tri3_solve(Lc, rhs.unsqueeze(-1))
    mean = tri3_solve(Lc, w, trans=True)[..., 0] * inv_sc
    samp = tri3_solve(Lc, zeta.unsqueeze(-1), trans=True)[..., 0] * inv_sc
    beta = (Minv.unsqueeze(2) @ (mean + samp).unsqueeze(-1))[..., 0]  # (K, H, m, 3)
    return beta.mT


def draw_threshold(thresholds, f, mu, y, config: GPIRTConfig, nu, logu, eps0,
                   rs, temp=None) -> torch.Tensor:
    """y-marginal ESS redraw of the binary interior cutpoint t_1 (identity
    prior in delta space, src/draw_threshold.cpp), one lane per (chain,
    horizon, item), through the binary cutpoint ESS kernel.

    thresholds (K, H, m, 3); nu, logu, eps0 (K, H, m); rs (R, K, H, m).
    """
    if thresholds.shape[-1] != 3:
        raise NotImplementedError("draw_threshold is ported for binary data only")
    _, inv_s = _temp_scales(temp)
    c = _INV_SQRT2 if inv_s is None else _INV_SQRT2 * inv_s
    t_new = binary_threshold_ess(
        (f + mu).contiguous(), y, thresholds[..., 1].contiguous(), nu, logu,
        eps0, rs, c)
    return delta_to_threshold(t_new.unsqueeze(-1))


def gibbs_sweep(state: GPIRTState, draws: SweepDraws, y: torch.Tensor,
                consts: GPIRTConstants, config: GPIRTConfig,
                temp: Optional[float] = None) -> Tuple[GPIRTState, torch.Tensor]:
    """One conjugate Gibbs sweep of K chains. Returns (state, ll (K,)).

    ``temp`` (None = 1) tempers the observation noise to sd sqrt(T); the
    returned ll is each chain's own tempered log-likelihood.
    """
    _, inv_s = _temp_scales(temp)
    mu_star = compute_mu_star(consts, state.beta)
    theta_idx = _draw_theta_grid(state, mu_star, y, consts, config,
                                 draws.u_theta, temp)
    state = state._replace(theta_idx=theta_idx, f=_rows(state.fstar, theta_idx))
    theta = theta_from_indices(theta_idx, consts)
    mu = compute_mu(theta, state.beta)
    z = draw_z_truncnorm(state.f + mu, y, state.thresholds, draws.u_z, temp)
    fstar, f = draw_fstar_conjugate(state, z - mu, config, consts, draws.z_q,
                                    draws.z_p, draws.z_n, draws.eps_f, temp)
    beta = draw_beta_conjugate(theta, z - f, consts, config, draws.zeta, temp)
    mu = compute_mu(theta, beta)
    thresholds = draw_threshold(state.thresholds, f, mu, y, config, draws.nu_t,
                                draws.logu_t, draws.eps0_t, draws.rs_t, temp)
    state = GPIRTState(theta_idx=theta_idx, f=f, beta=beta,
                       thresholds=thresholds, fstar=fstar)
    ll = ordinal_ll_terms(f + mu, y, thresholds, inv_s).sum(dim=(-3, -2, -1))
    return state, ll
