"""Generative sampling: prior draws and ordinal response simulation.

Counterpart of ``gpirt_tpu/models/generate.py`` for K chains, the chain
(or lane) axis first. The reference has no simulation utilities (its
roxygen example hand-rolls a 2PL simulator, R/gpirtMCMC.R:59-80). These
serve posterior-predictive checks and the Geweke joint-distribution test
of the sampler.

The generative model, in the extended-space form the Gibbs sampler
targets (see gibbs.py): theta_i on the theta* grid with the discretized
N(mean, sd^2) prior, f* ~ GP(0, K_grid + jitter I) per item on the grid,
beta ~ N(0, diag(sds^2 + 1e-6)) (the sampler's effective zero-mean ESS
prior, src/draw-beta.cpp:16), cutpoints from delta ~ N(0, I), and
y_ij | theta, f*, beta, t ~ ordinal-probit(f*(theta_i) + mu(theta_i)).

As the sweep's blocks do, each function takes its random numbers as
tensors, and a ``*_draws(gen, ...)`` helper makes them from a
``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gpirt_tpu_torch.models.config import GPIRTConfig, GPIRTConstants
from gpirt_tpu_torch.models.gibbs import (
    GPIRTState,
    _gumbel_argmax,
    _irf_sessions,
    _per_chain,
    _rows,
    _samplers,
    _share,
    compute_mu,
    snap_indices,
    theta_from_indices,
)
from gpirt_tpu_torch.ops.likelihood import delta_to_threshold

__all__ = [
    "PriorDraws",
    "prior_draws",
    "sample_prior_state",
    "response_draws",
    "sample_responses",
    "posterior_predictive",
]

_INV_SQRT2 = 0.7071067811865476
# the GP regime's exact prior draw enumerates grid^H session paths
_GP_PATHS_MAX = 300_000


class PriorDraws(NamedTuple):
    """:func:`sample_prior_state`'s random numbers for K chains; Hs is 1
    under constant_IRF (one IRF a chain), else H."""

    u_theta: torch.Tensor  # uniform: theta's Gumbel-max, (K, n, N) in CST,
    # (K, H, n, N) in RDM, (K, n, N^H) over the session paths in GP
    z_fstar: torch.Tensor  # (K, Hs, N, m) normal: f* before L_grid
    z_beta: torch.Tensor  # (K, Hs, 3, m) normal: beta before its prior sds
    delta: torch.Tensor  # (K, Hs, m, C-1) normal: the cutpoints' deltas


def _gp_paths(config: GPIRTConfig) -> int:
    N, H = config.grid_size, config.horizon
    if N ** H > _GP_PATHS_MAX:
        raise NotImplementedError(
            f"GP-regime prior enumeration needs grid_size^horizon <= 3e5 "
            f"(got {N}^{H}); use a coarser test grid"
        )
    return N ** H


def prior_draws(gen: torch.Generator, K: int, consts: GPIRTConstants,
                config: GPIRTConfig) -> PriorDraws:
    """The prior state's draws for K chains, from ``gen``."""
    rand, randn = _samplers(gen, consts, config)
    H, n, m, N, C = config.horizon, config.n, config.m, config.grid_size, config.C
    Hs = _irf_sessions(config)
    regime = config.theta_regime
    if regime == "CST":
        u_theta = rand(K, n, N)
    elif regime == "RDM":
        u_theta = rand(K, H, n, N)
    else:
        u_theta = rand(K, n, _gp_paths(config))
    return PriorDraws(u_theta=u_theta, z_fstar=randn(K, Hs, N, m),
                      z_beta=randn(K, Hs, 3, m), delta=randn(K, Hs, m, C - 1))


def _sample_theta_prior(u: torch.Tensor, consts: GPIRTConstants,
                        config: GPIRTConfig) -> torch.Tensor:
    """Exact draw of theta_idx (K, H, n) from the sampler's grid prior.

    CST: one theta per respondent shared across sessions, grid-discretized
    N(0, 1 + sd_i^2) (reference src/draw-theta.cpp:158). RDM: independent
    per (session, respondent). GP: the grid-Gibbs theta update's
    conditionals derive from the lattice restriction of the time-GP
    Gaussian with precision Lambda_time, so the matching prior is the
    discrete MRF p(theta) ∝ exp(-theta' Lambda theta / 2) on grid^H,
    sampled exactly by enumerating all grid^H session paths per respondent
    (tractable at test sizes; guarded).
    """
    K = u.shape[0]
    H, n, N = config.horizon, config.n, config.grid_size
    grid = consts.grid
    regime = config.theta_regime
    if regime != "GP":
        var = 1.0 + torch.square(consts.theta_prior_sds[0])  # (n,)
        logprior = -0.5 * torch.square(grid)[None, :] / var[:, None]  # (n, N)
        if regime == "RDM":
            return _gumbel_argmax(u, logprior, dim=-1)  # (K, H, n)
        return _gumbel_argmax(u, logprior, dim=-1).unsqueeze(1).expand(K, H, n)
    _gp_paths(config)
    combos = torch.stack(torch.meshgrid(*([grid] * H), indexing="ij"),
                         dim=-1).reshape(-1, H)  # (N^H, H), axis 0 slowest
    # Lambda_time is built with zeroed prior sds (reference cache quirk,
    # src/cholesky-cache.cpp:31), so the logits are shared by the respondents
    logits = -0.5 * torch.einsum("sh,hg,sg->s", combos, consts.Lambda_time, combos)
    pick = _gumbel_argmax(u, logits, dim=-1)  # (K, n)
    strides = N ** torch.arange(H - 1, -1, -1, device=u.device)
    return ((pick.unsqueeze(-1) // strides) % N).mT  # (K, H, n)


def sample_prior_state(consts: GPIRTConstants, config: GPIRTConfig,
                       draws: PriorDraws) -> GPIRTState:
    """(theta_idx, f*, beta, thresholds) of K chains from the sampler's
    prior, f their f* rows at theta (``gpirt_tpu/models/generate.py:82``).

    Covers the three theta regimes and constant_IRF (one grid function, beta
    and cutpoint vector a chain shared across sessions, reference
    src/gpirtMCMC.cpp:164-202 and src/draw_threshold.cpp:181-204). f* is
    drawn on the grid through the grid Cholesky.
    """
    H = config.horizon
    theta_idx = _sample_theta_prior(draws.u_theta, consts, config)
    sd_b = torch.sqrt(torch.square(consts.beta_prior_sds) + 1e-6)  # (3, m)
    fstar = _share(consts.L_grid @ draws.z_fstar, H)
    beta = _share(draws.z_beta * sd_b, H)
    thresholds = _share(delta_to_threshold(draws.delta), H)
    return GPIRTState(theta_idx=theta_idx, f=_rows(fstar, theta_idx), beta=beta,
                      thresholds=thresholds, fstar=fstar)


def response_draws(gen: torch.Generator, K: int, consts: GPIRTConstants,
                   config: GPIRTConfig) -> torch.Tensor:
    """(K, H, n, m) uniforms from ``gen``: :func:`sample_responses`' (K
    chains) or :func:`posterior_predictive`'s (K stored draws)."""
    rand, _ = _samplers(gen, consts, config)
    return rand(K, config.horizon, config.n, config.m)


def sample_responses(state: GPIRTState, consts: GPIRTConstants, config: GPIRTConfig,
                     u: torch.Tensor, mask: Optional[torch.Tensor] = None,
                     temp=None) -> torch.Tensor:
    """y | state from the ordinal-probit model: (K, H, n, m) int32, 1..C
    (``gpirt_tpu/models/generate.py:128``).

    Inverse transform over the cutpoints: y = 1 + #{c : u > Phi(t_c - g)},
    ``u`` (K, H, n, m) uniform. ``mask`` (bool, (H, n, m)) marks observed
    cells; the others get 0. ``temp`` (a float, or a (K,) tensor of one a
    chain) samples the tempered observation model (noise sd sqrt(T), see
    parallel/tempering.py), as the tempered Geweke oracle needs.
    """
    C = config.C
    theta = theta_from_indices(state.theta_idx, consts)
    g = state.f + compute_mu(theta, state.beta)  # (K, H, n, m)
    t_int = state.thresholds[..., 1:C]  # (K, H, m, C-1)
    z = t_int.unsqueeze(2) - g.unsqueeze(-1)  # (K, H, n, m, C-1)
    c = _INV_SQRT2
    if temp is not None:
        T = torch.as_tensor(temp, dtype=g.dtype, device=g.device)
        c = _per_chain(c / torch.sqrt(T), 5)
    cdf = 0.5 * (1.0 + torch.erf(z * c))
    y = 1 + (u.unsqueeze(-1) > cdf).sum(dim=-1).to(torch.int32)
    if mask is not None:
        y = torch.where(mask, y, torch.zeros_like(y))
    return y


def posterior_predictive(draws: dict, consts: GPIRTConstants, config: GPIRTConfig,
                         u: torch.Tensor, mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Replicate response cubes from stored posterior draws, one a draw
    (``gpirt_tpu/models/generate.py:161``).

    ``draws`` are one chain's stored draws in the internal layout, the draw
    axis leading (``run_chains(..., store_f=True)``'s output at one chain):
    f (S, H, n, m), theta (S, H, n), beta (S, H, 3, m), threshold
    (S, H, m, C+1); ``u`` (S, H, n, m) uniforms (:func:`response_draws`).
    Returns (S, H, n, m) int32 replicates.
    """
    state = GPIRTState(theta_idx=snap_indices(draws["theta"], config), f=draws["f"],
                       beta=draws["beta"], thresholds=draws["threshold"], fstar=None)
    return sample_responses(state, consts, config, u, mask)
