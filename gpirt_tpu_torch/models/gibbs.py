"""The GP-IRT Gibbs sweep on a batch of K chains: the conjugate path, the
grid-native ESS on f* and the reference's two-stage pipeline.

Counterpart of ``gpirt_tpu/models/gibbs.py`` without its sharded forms.
Chains are a written-out leading K axis. Every block is a pure function of
the state and of its random draws, passed in as tensors; :func:`sweep_draws`
makes one sweep's draws from a ``torch.Generator`` and :func:`gibbs_sweep`
applies the blocks of ``config.resolved_f_method``.

The conjugate sweep (Albert-Chib latents z; the block order of
src/gpirtMCMC.cpp:261-331 with theta first):

  theta | f*  ->  z | theta, f*  [->  (theta, beta) by the collective affine
  moves against the z-marginal, models/affine.py]  ->  f* | z  ->
  beta | z, f  ->  t | f, mu (or t | z, the collapsed draw)  [->  the
  (t, beta0) shift]  ->  ll.

The grid sweep (``f_method="grid"``): one ESS move of each item's whole
grid function f*, its likelihood gathered at the snapped theta, in place
of draw_f + draw_fstar:

  f* | theta, beta, t (ESS)  ->  theta | f*  ->  beta | f, theta (ESS)
  ->  t | f, mu  ->  ll.

The two-stage sweep (``f_method="two_stage"``, src/gpirtMCMC.cpp:261-331
as the reference runs it):

  f | theta, beta, t (ESS)  ->  f* | f (Matheron or posterior Cholesky)
  ->  theta | f*  ->  f := f*(theta)  ->  beta | f, theta (ESS)
  ->  t | f, mu  ->  ll.

``config.mix_subsweeps`` repeats the latent pass (the bracketed part of
each order above: theta to f* on the conjugate path, f* and theta on the
grid and two-stage ones), each pass with its own draws, which then carry
a leading pass axis. theta is drawn on the grid exactly, or by the
reference code's ESS and snap (``theta_method="ess"``).

The cutpoint block is the y-marginal update of the reference: an ESS in
the delta parametrization (the binary one through the hand-written CUDA
kernel on the card, ``ops/threshold_ess.py``; the ordinal one through
``ops/ess.py``), or Newton-proposal MH on the same conditional
(``threshold_method="newton"``); on the conjugate path also the exact draw
given z (``"collapsed"``) or the two in turn (``"interleave"``, the ESS on
sweeps whose ``iteration`` is a multiple of ``threshold_ess_every``). The
ESS of theta, f, f* and beta run through ``ops/ess.py``.

Layouts put the chain axis first, then the horizon:
  theta_idx (K, H, n) int64, f (K, H, n, m), beta (K, H, 3, m),
  thresholds (K, H, m, C+1), fstar (K, H, N, m); responses y (H, n, m).
Every block but the theta draw treats the sessions as independent; the
theta draw couples them as ``config.theta_regime`` says.

Under ``constant_IRF`` one item response function serves every session:
f* and the cutpoints are one value a chain, shared by the sessions (f* an
``expand`` view over H), beta stays one a session as in JAX. Each block
that draws them (f, f*, the cutpoints) runs as the H = 1 block on one
session of H n stacked sites, the reference's stacked (n H) GP
(src/draw-f.cpp:84-138, src/draw-fstar.cpp:58-125,
src/draw_threshold.cpp:181-204), and its draws have a session axis of 1.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import torch

from gpirt_tpu_torch.models.config import (
    GPIRTConfig,
    GPIRTConstants,
    THETA_HI,
    THETA_LO,
)
from gpirt_tpu_torch.ops.ess import ess_update
from gpirt_tpu_torch.ops.interp import interp
from gpirt_tpu_torch.ops.kernels import icc_gram
from gpirt_tpu_torch.ops.likelihood import (
    cutpoint_bounds,
    delta_to_threshold,
    ll_terms_from_bounds,
    ordinal_ll_terms,
    threshold_to_delta,
)
from gpirt_tpu_torch.ops.linalg import chol3, chol_with_jitter, tri3_solve, tri_solve
from gpirt_tpu_torch.ops.threshold_ess import binary_threshold_ess

__all__ = [
    "GPIRTState",
    "InitDraws",
    "ESSDraws",
    "NewtonDraws",
    "CollapsedDraws",
    "ThetaESSDraws",
    "AffineDraws",
    "SweepDraws",
    "ESSLoopDraws",
    "draws_to",
    "FDraws",
    "FStarDraws",
    "BetaDraws",
    "TwoStageInitDraws",
    "TwoStageDraws",
    "GridDraws",
    "snap_indices",
    "theta_from_indices",
    "compute_mu",
    "compute_mu_star",
    "stored_fstar",
    "theta_site_basis",
    "gather_theta_gram",
    "theta_chol",
    "theta_prior_perturbation",
    "init_draws",
    "init_state",
    "sweep_draws",
    "f_draws",
    "fstar_draws",
    "draw_z_truncnorm",
    "draw_fstar_conjugate",
    "draw_beta_conjugate",
    "draw_f",
    "draw_fstar",
    "draw_fstar_direct",
    "draw_beta",
    "draw_threshold",
    "draw_threshold_collapsed",
    "draw_threshold_shift",
    "draw_theta",
    "gibbs_sweep",
]

_SQRT2 = 1.4142135623730951
_INV_SQRT2 = 0.7071067811865476
_TWO_PI = 6.283185307179586
_INV_SQRT2PI = 0.3989422804014327


class GPIRTState(NamedTuple):
    """Markov chain state of K chains (layouts in the module docstring)."""

    theta_idx: torch.Tensor
    f: torch.Tensor
    beta: torch.Tensor
    thresholds: torch.Tensor
    fstar: torch.Tensor


class InitDraws(NamedTuple):
    """H is 1 under constant_IRF: one beta and one f* a chain, shared."""

    z_beta: torch.Tensor  # (K, H, 3, m) standard normal
    z_fstar: torch.Tensor  # (K, H, N, m) standard normal


# A draws tuple names in _ROUND_FIELDS the fields whose leading axis is a
# round or try axis (the lanes follow it), and in _PASS_FIELDS those that
# carry a leading pass axis under mix_subsweeps > 1; parallel/smc.py joins
# campaigns' draws along the lane axis these give.


class ESSDraws(NamedTuple):
    """The cutpoint ESS's random numbers, also those of the collapsed
    draw's ESS at C > 2; under constant_IRF the session axis H is 1 (one
    cutpoint vector a chain)."""

    nu: torch.Tensor  # (K, H, m, C-1) normal: prior draw
    logu: torch.Tensor  # (K, H, m) log uniform: slice level
    eps0: torch.Tensor  # (K, H, m) uniform [0, 2 pi): initial angle
    rs: torch.Tensor  # (R, K, H, m) uniform: bracket shrink per round
    _ROUND_FIELDS = ("rs",)


class NewtonDraws(NamedTuple):
    """Newton-proposal MH's random numbers, one row per try; H is 1 under
    constant_IRF."""

    z: torch.Tensor  # (tries, K, H, m, C-1) normal: proposal
    logu: torch.Tensor  # (tries, K, H, m) log uniform: accept
    _ROUND_FIELDS = ("z", "logu")


class CollapsedDraws(NamedTuple):
    """The collapsed binary cutpoint draw's inverse-CDF uniform (C = 2;
    at C > 2 the collapsed draw is an ESS and takes :class:`ESSDraws`)."""

    u: torch.Tensor  # (K, H, m) uniform; H is 1 under constant_IRF


class ESSLoopDraws(NamedTuple):
    """:func:`ess_update`'s own uniforms for a batch of lanes ``*B``."""

    logu: torch.Tensor  # (*B) log uniform: slice level
    eps0: torch.Tensor  # (*B) uniform [0, 2 pi): initial angle
    rs: torch.Tensor  # (R, *B) uniform: bracket shrink per round
    _ROUND_FIELDS = ("rs",)


class ThetaESSDraws(NamedTuple):
    """The theta ESS's random numbers (``theta_method="ess"``): one lane a
    respondent, (K, n), in the CST and GP regimes, one a (respondent,
    session), (K, n, H), in RDM."""

    z: torch.Tensor  # normal: the prior draw before its scale, (K, n, 1) in
    # CST, (K, n, H) in RDM and GP
    logu: torch.Tensor  # (*lanes) log uniform: slice level
    eps0: torch.Tensor  # (*lanes) uniform [0, 2 pi): initial angle
    rs: torch.Tensor  # (R, *lanes) uniform: bracket shrink per round
    _ROUND_FIELDS = ("rs",)


class AffineDraws(NamedTuple):
    """The collective affine moves' random numbers (models/affine.py): the
    shift orbit's, None when affine_shift_max is 0, and the dilation
    rounds', None when affine_rounds is 0."""

    u_pick: Optional[torch.Tensor]  # (K, 2W+1) uniform: Gumbel noise of the pick
    u_acc: Optional[torch.Tensor]  # (K,) uniform: its window-normaliser accept
    ell: Optional[torch.Tensor]  # (rounds, K) normal: log dilation before its sd
    u_dil: Optional[torch.Tensor]  # (rounds, K) uniform: the dilations' accepts
    _ROUND_FIELDS = ("ell", "u_dil")


def _map_draws(fn, draws):
    """``draws`` with ``fn`` applied to every tensor of its nested tuples;
    a None field stays None."""
    if draws is None or torch.is_tensor(draws):
        return draws if draws is None else fn(draws)
    return type(draws)(*(_map_draws(fn, a) for a in draws))


def draws_to(draws, device):
    """A (nested) tuple of draws with every tensor moved to ``device``."""
    return _map_draws(lambda a: a.to(device), draws)


def _stack_passes(per_pass):
    """The draws of ``mix_subsweeps`` passes as one, a leading pass axis on
    every tensor; one pass as it is."""
    first = per_pass[0]
    if len(per_pass) == 1 or first is None:
        return first
    if torch.is_tensor(first):
        return torch.stack(per_pass)
    return type(first)(*(_stack_passes([p[i] for p in per_pass])
                         for i in range(len(first))))


def _passes(draws, S: int):
    """One sweep's draws as the S passes' draws, each pass with its own
    fields of ``_PASS_FIELDS``."""
    if S == 1:
        return [draws]
    return [draws._replace(**{f: _map_draws(lambda a: a[s], getattr(draws, f))
                              for f in draws._PASS_FIELDS}) for s in range(S)]


class SweepDraws(NamedTuple):
    """One conjugate sweep's random numbers for K chains; ``cut`` holds
    those of the configured cutpoint update. Under constant_IRF the f*
    prior's H is 1 (one draw gathered at every session's sites). The
    fields of a latent pass (``_PASS_FIELDS``) carry a leading pass axis
    under mix_subsweeps > 1; ``affine`` and ``shift`` are None unless the
    config asks for those moves."""

    u_theta: Union[torch.Tensor, ThetaESSDraws]  # the theta draw's: uniform
    # [0, 1) Gumbel noise, (K, n, N) in the CST regime, (K, H, n, N) in RDM
    # and GP; or the ESS's numbers
    u_z: torch.Tensor  # (K, H, n, m) uniform: truncated-normal inverse CDF
    z_q: torch.Tensor  # (K, H, q, m) normal: f* prior, SE eigenbasis part
    z_p: torch.Tensor  # (K, H, 3, m) normal: f* prior, polynomial part
    z_n: torch.Tensor  # (K, H, N, m) normal: f* prior, grid nugget
    eps_f: torch.Tensor  # (K, H, n, m) normal: f* observation noise
    zeta: torch.Tensor  # (K, H, m, 3) normal: beta draw
    cut: Union[ESSDraws, NewtonDraws, CollapsedDraws]
    affine: Optional[AffineDraws] = None
    shift: Optional[torch.Tensor] = None  # (K, H, m) normal: the (t, beta0) shift
    _PASS_FIELDS = ("u_theta", "u_z", "z_q", "z_p", "z_n", "eps_f", "affine")

    def to(self, device) -> "SweepDraws":
        return draws_to(self, device)


class FDraws(NamedTuple):
    """draw_f's random numbers: its prior perturbation and its ESS. Under
    constant_IRF H is 1 and the sites are the H n stacked ones."""

    z_u: torch.Tensor  # (K, H, q+3, m) normal: eigenbasis part
    z_site: torch.Tensor  # (K, H, n, m) normal: site nugget
    ess: ESSLoopDraws  # lanes (K, H, m)


class FStarDraws(NamedTuple):
    """draw_fstar's normals. Matheron's rule, the constant_IRF draw (H = 1
    there) and the grid ESS take all three as the parts of their grid
    prior draw; "chol" takes z_n alone, the posterior factor's normal."""

    z_q: torch.Tensor  # (K, H, q, m) SE eigenbasis part
    z_p: torch.Tensor  # (K, H, 3, m) polynomial part
    z_n: torch.Tensor  # (K, H, N, m) grid nugget


class BetaDraws(NamedTuple):
    """draw_beta's random numbers."""

    z: torch.Tensor  # (K, H, m, 3) normal: prior draw before the prior sds
    ess: ESSLoopDraws  # lanes (K, H, m)


class TwoStageInitDraws(NamedTuple):
    """H is 1 under constant_IRF: one beta and one f a chain, shared."""

    z_beta: torch.Tensor  # (K, H, 3, m) standard normal
    z_u: torch.Tensor  # (K, H, q+3, m) normal: f's prior draw, eigenbasis part
    z_site: torch.Tensor  # (K, H, n, m) normal: its site nugget
    fstar: FStarDraws  # the initial f* | f draw


class TwoStageDraws(NamedTuple):
    """One two-stage sweep's random numbers for K chains; the passes'
    fields as in :class:`SweepDraws`."""

    f: FDraws
    fstar: FStarDraws
    u_theta: Union[torch.Tensor, ThetaESSDraws]  # as SweepDraws.u_theta
    beta: BetaDraws
    cut: Union[ESSDraws, NewtonDraws]
    shift: Optional[torch.Tensor] = None  # (K, H, m) normal: the (t, beta0) shift
    _PASS_FIELDS = ("fstar", "u_theta")

    def to(self, device) -> "TwoStageDraws":
        return draws_to(self, device)


class GridDraws(NamedTuple):
    """One grid sweep's random numbers for K chains; the f* ESS has lanes
    (K, H, m), H 1 under constant_IRF; the passes' fields as in
    :class:`SweepDraws`."""

    fstar: FStarDraws  # the ESS's grid prior draw of f*
    ess: ESSLoopDraws  # its slice level, initial angle and shrinks
    u_theta: Union[torch.Tensor, ThetaESSDraws]  # as SweepDraws.u_theta
    beta: BetaDraws
    cut: Union[ESSDraws, NewtonDraws]
    shift: Optional[torch.Tensor] = None  # (K, H, m) normal: the (t, beta0) shift
    _PASS_FIELDS = ("fstar", "ess", "u_theta")

    def to(self, device) -> "GridDraws":
        return draws_to(self, device)


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


def stored_fstar(fstar, beta, consts: GPIRTConstants, config: GPIRTConfig) -> torch.Tensor:
    """f* as it is stored and returned, with the parametric mean mu* added;
    under constant_IRF every session takes session 0's mu*, as the JAX
    package does (``gpirt_tpu/parallel/chains.py:295``,
    src/draw-fstar.cpp:115-124). fstar (..., H, N, m), beta (..., H, 3, m)."""
    ms = compute_mu_star(consts, beta)
    if config.constant_IRF:
        ms = ms[..., :1, :, :].expand(ms.shape)
    return fstar + ms


def theta_site_basis(theta_idx: torch.Tensor, consts: GPIRTConstants) -> torch.Tensor:
    """Rows of [U_se, Psi_grid] at the snapped indices: (..., n) -> (..., n, q+3);
    U U^T = K(theta, theta) to the eigenbasis truncation."""
    return torch.cat([consts.U_se[theta_idx], consts.Psi_grid[theta_idx]], dim=-1)


def _rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a (..., N, m) at grid rows idx (..., n) -> (..., n, m)."""
    return torch.take_along_dim(a, idx.unsqueeze(-1), dim=-2)


def _temp_scales(temp):
    """(sqrt_T, 1/sqrt_T): (None, None) untempered, Python floats for one
    temperature, (K,) tensors for a temperature a chain."""
    if temp is None:
        return None, None
    if torch.is_tensor(temp):
        s = torch.sqrt(temp)
        return s, 1.0 / s
    s = math.sqrt(float(temp))
    return s, 1.0 / s


def _per_chain(v, ndim: int):
    """A (K,) per-chain scale shaped to broadcast over a (K, ...) tensor of
    ``ndim`` axes; a float or None as it is."""
    if torch.is_tensor(v):
        return v.reshape((-1,) + (1,) * (ndim - 1))
    return v


def _stack_sessions(a: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The sessions (``dim``) and respondents (``dim + 1``) of ``a`` as one
    session of H n stacked sites, in [h n + i] order: (.., H, n, ...) ->
    (.., 1, H n, ...)."""
    return a.flatten(dim, dim + 1).unsqueeze(dim)


def _share(a: torch.Tensor, H: int) -> torch.Tensor:
    """One value a chain shared by H sessions: (K, 1, ...) -> (K, H, ...),
    a view."""
    return a.expand((a.shape[0], H) + tuple(a.shape[2:]))


def _irf_sessions(config: GPIRTConfig) -> int:
    """The session axis of what belongs to the IRF (f*, f's ESS lanes, the
    cutpoints) and of its draws: 1 under constant_IRF, else H."""
    return 1 if config.constant_IRF else config.horizon


def _onehot(y, C: int, dtype) -> torch.Tensor:
    """(H, n, m) categories 1..C -> (H, n, m, C); a missing cell is all 0."""
    return (y.unsqueeze(-1) == torch.arange(1, C + 1, device=y.device)).to(dtype)


# ---------------------------------------------------------------------------
# random draws
# ---------------------------------------------------------------------------


def _samplers(gen: torch.Generator, consts: GPIRTConstants, config: GPIRTConfig):
    """(rand, randn): uniform [0, 1) and standard normal tensors of a shape,
    from ``gen`` on the constants' device in the config's dtype."""
    dev, dt = consts.grid.device, config.tdtype

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev, dtype=dt)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dt)

    return rand, randn


def _ess_loop_draws(rand, lanes, rounds: int) -> ESSLoopDraws:
    return ESSLoopDraws(logu=torch.log(rand(*lanes)), eps0=rand(*lanes) * _TWO_PI,
                        rs=rand(rounds, *lanes))


def _theta_uniforms(rand, K: int, config: GPIRTConfig) -> torch.Tensor:
    n, N = config.n, config.grid_size
    return rand(K, n, N) if config.theta_regime == "CST" else rand(K, config.horizon, n, N)


def f_draws(gen: torch.Generator, K: int, consts: GPIRTConstants,
            config: GPIRTConfig) -> FDraws:
    """draw_f's draws for K lanes (chains, or stored draws in recovery)."""
    rand, randn = _samplers(gen, consts, config)
    H, n, m = config.horizon, config.n, config.m
    k = consts.U_se.shape[1] + 3
    if config.constant_IRF:  # one session of H n stacked sites
        H, n = 1, H * n
    return FDraws(z_u=randn(K, H, k, m), z_site=randn(K, H, n, m),
                  ess=_ess_loop_draws(rand, (K, H, m), config.ess_max_rounds))


def fstar_draws(gen: torch.Generator, K: int, consts: GPIRTConstants,
                config: GPIRTConfig) -> FStarDraws:
    """draw_fstar's (or the grid ESS's) normals for K lanes."""
    _, randn = _samplers(gen, consts, config)
    H, m, N = _irf_sessions(config), config.m, config.grid_size
    return FStarDraws(z_q=randn(K, H, consts.U_se.shape[1], m), z_p=randn(K, H, 3, m),
                      z_n=randn(K, H, N, m))


def init_draws(gen: torch.Generator, K: int, consts: GPIRTConstants,
               config: GPIRTConfig) -> Union[InitDraws, TwoStageInitDraws]:
    """The initial state's draws for ``config.resolved_f_method``."""
    rand, randn = _samplers(gen, consts, config)
    H, n, m, N = _irf_sessions(config), config.n, config.m, config.grid_size
    z_beta = randn(K, H, 3, m)
    if config.resolved_f_method == "two_stage":
        k = consts.U_se.shape[1] + 3
        return TwoStageInitDraws(z_beta=z_beta, z_u=randn(K, H, k, m),
                                 z_site=randn(K, H, n, m),
                                 fstar=fstar_draws(gen, K, consts, config))
    return InitDraws(z_beta=z_beta, z_fstar=randn(K, H, N, m))


def _theta_draws(rand, randn, K: int, config: GPIRTConfig):
    """The theta update's numbers: the grid draw's Gumbel uniforms, or the
    ESS's (:class:`ThetaESSDraws`) under ``theta_method="ess"``."""
    if config.theta_method == "grid":
        return _theta_uniforms(rand, K, config)
    n, H = config.n, config.horizon
    regime = config.theta_regime
    lanes = (K, n, H) if regime == "RDM" else (K, n)
    z = randn(K, n, 1 if regime == "CST" else H)
    return ThetaESSDraws(z, *_ess_loop_draws(rand, lanes, config.ess_max_rounds))


def _cut_method(config: GPIRTConfig, iteration: int) -> str:
    """The cutpoint update sweep ``iteration`` runs: "interleave" is the
    y-marginal ESS when iteration % threshold_ess_every == 0 and the
    collapsed draw otherwise."""
    method = config.resolved_threshold_method
    if method == "interleave":
        return "ess" if iteration % config.threshold_ess_every == 0 else "collapsed"
    return method


def _cut_draws(rand, randn, K: int, config: GPIRTConfig,
               iteration: int) -> Union[ESSDraws, NewtonDraws, CollapsedDraws]:
    H, m, d = _irf_sessions(config), config.m, config.C - 1
    method = _cut_method(config, iteration)
    if method == "newton":
        tries = config.threshold_mh_tries
        return NewtonDraws(z=randn(tries, K, H, m, d), logu=torch.log(rand(tries, K, H, m)))
    if method == "collapsed" and config.C == 2:
        return CollapsedDraws(u=rand(K, H, m))
    return ESSDraws(
        nu=randn(K, H, m, d),
        logu=torch.log(rand(K, H, m)),
        eps0=rand(K, H, m) * _TWO_PI,
        rs=rand(config.ess_max_rounds, K, H, m),
    )


def _affine_draws(rand, randn, K: int, config: GPIRTConfig) -> Optional[AffineDraws]:
    if not config.affine:
        return None
    W, R = config.affine_shift_max, config.affine_rounds
    return AffineDraws(u_pick=rand(K, 2 * W + 1) if W else None,
                       u_acc=rand(K) if W else None,
                       ell=randn(R, K) if R else None,
                       u_dil=rand(R, K) if R else None)


def sweep_draws(gen: torch.Generator, K: int, consts: GPIRTConstants,
                config: GPIRTConfig,
                iteration: int = 0) -> Union[SweepDraws, GridDraws, TwoStageDraws]:
    """One sweep's draws for ``config.resolved_f_method``: the latent
    passes' first, pass by pass, then the rest. ``iteration`` is the sweep's
    index, which picks the cutpoint update under "interleave". A field the
    config does not ask for is not drawn."""
    rand, randn = _samplers(gen, consts, config)
    H, n, m, N = config.horizon, config.n, config.m, config.grid_size
    Hi, R, S = _irf_sessions(config), config.ess_max_rounds, config.mix_subsweeps
    method = config.resolved_f_method

    def passes(one):
        per_pass = [one() for _ in range(S)]
        return {k: _stack_passes([p[k] for p in per_pass]) for k in per_pass[0]}

    def tail():
        out = dict(cut=_cut_draws(rand, randn, K, config, iteration))
        if config.threshold_shift and not config.constant_IRF:
            out["shift"] = randn(K, H, m)
        return out

    def beta():
        return BetaDraws(z=randn(K, H, m, 3), ess=_ess_loop_draws(rand, (K, H, m), R))

    if method == "two_stage":
        f = f_draws(gen, K, consts, config)
        latent = passes(lambda: dict(fstar=fstar_draws(gen, K, consts, config),
                                     u_theta=_theta_draws(rand, randn, K, config)))
        return TwoStageDraws(f=f, **latent, beta=beta(), **tail())
    if method == "grid":
        latent = passes(lambda: dict(fstar=fstar_draws(gen, K, consts, config),
                                     ess=_ess_loop_draws(rand, (K, Hi, m), R),
                                     u_theta=_theta_draws(rand, randn, K, config)))
        return GridDraws(**latent, beta=beta(), **tail())
    latent = passes(lambda: dict(
        u_theta=_theta_draws(rand, randn, K, config),
        u_z=rand(K, H, n, m),
        z_q=randn(K, Hi, consts.U_se.shape[1], m),
        z_p=randn(K, Hi, 3, m),
        z_n=randn(K, Hi, N, m),
        eps_f=randn(K, H, n, m),
        affine=_affine_draws(rand, randn, K, config),
    ))
    return SweepDraws(**latent, zeta=randn(K, H, m, 3), **tail())


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def gather_theta_gram(theta_idx: torch.Tensor, consts: GPIRTConstants) -> torch.Tensor:
    """K(theta, theta) gathered from the grid Gram: (..., n) -> (..., n, n)."""
    return consts.grid_gram[theta_idx.unsqueeze(-1), theta_idx.unsqueeze(-2)]


def theta_chol(theta_idx: torch.Tensor, consts: GPIRTConstants,
               config: GPIRTConfig) -> torch.Tensor:
    """Cholesky of the gathered theta Gram plus ``config.device_jitter``,
    in correlation form in float32: (..., n) -> (..., n, n)."""
    return chol_with_jitter(gather_theta_gram(theta_idx, consts), config.device_jitter,
                            normalized=config.chol_normalized)


def theta_prior_perturbation(theta_idx, consts: GPIRTConstants, config: GPIRTConfig,
                             z_u, z_site) -> torch.Tensor:
    """An N(0, K(theta, theta) + device_jitter I) draw at the snapped sites
    through the gathered eigenbasis, with no (n, n) factorization
    (``gpirt_tpu/models/gibbs.py:287``; the reference factors K_theta for
    it, src/draw-f.cpp:59-66).

    theta_idx (..., n); z_u (..., q+3, m), z_site (..., n, m) normal ->
    (..., n, m).
    """
    U = theta_site_basis(theta_idx, consts)
    return U @ z_u + math.sqrt(config.device_jitter) * z_site


def init_state(theta_init: torch.Tensor, thresholds_init: torch.Tensor,
               consts: GPIRTConstants, config: GPIRTConfig,
               draws: Union[InitDraws, TwoStageInitDraws]) -> GPIRTState:
    """Prior draws of beta, and of f* on the grid (f its rows at the
    snapped theta_init) for the conjugate and grid samplers, or of f at the
    sites followed by one f* | f draw for the two-stage one
    (src/gpirtMCMC.cpp:148-227; ``gpirt_tpu/models/gibbs.py:2500``). Under
    constant_IRF beta and f* (two-stage: f, from session 0's sites) are one
    draw a chain copied to every session.

    theta_init (K, H, n) or (H, n); thresholds_init (H, m, C+1).
    """
    K, m = draws.z_beta.shape[0], draws.z_beta.shape[-1]
    H, dt = config.horizon, config.tdtype
    theta_idx = snap_indices(theta_init.to(dt), config)
    theta_idx = theta_idx.expand(K, H, config.n).contiguous()
    beta = consts.beta_prior_means + draws.z_beta * consts.beta_prior_sds
    if config.resolved_f_method == "two_stage":
        idx = theta_idx[:, :1] if config.constant_IRF else theta_idx
        f = theta_prior_perturbation(idx, consts, config, draws.z_u, draws.z_site)
        f = _share(f, H)
        fstar = draw_fstar(f, theta_idx, consts, config, draws.fstar)
    else:
        fstar = _share(consts.L_grid @ draws.z_fstar, H)
        f = _rows(fstar, theta_idx)
    thresholds = thresholds_init.to(dt).expand((K,) + tuple(thresholds_init.shape))
    return GPIRTState(
        theta_idx=theta_idx,
        f=f,
        beta=_share(beta, H).contiguous(),
        thresholds=thresholds.contiguous(),
        fstar=fstar,
    )


def _category_logprobs(g, thresholds, C: int, inv_s=None) -> torch.Tensor:
    """log P(y = c | g) for every category: (..., m) g -> (..., m, C);
    one Phi per interior cutpoint."""
    z = thresholds[..., 1:C] - g.unsqueeze(-1)
    c = _INV_SQRT2 if inv_s is None else _INV_SQRT2 * _per_chain(inv_s, z.ndim)
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
    onehot = _onehot(y, C, gstar.dtype)  # (H, n, m, C)
    return logp.reshape(K, H, N, m * C) @ onehot.reshape(H, -1, m * C).mT


def _gumbel_argmax(u: torch.Tensor, logits: torch.Tensor, dim: int) -> torch.Tensor:
    """Categorical draw by Gumbel-max from uniforms u in [0, 1); argmax
    takes the first index on ties."""
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=dim)


def _draw_theta_grid(state: GPIRTState, mu_star, y, consts: GPIRTConstants,
                     config: GPIRTConfig, u_theta, temp=None) -> torch.Tensor:
    """Exact grid draw of theta in the configured regime
    (``gpirt_tpu/models/gibbs.py:1681``): the ll table plus a Gaussian log
    prior on the grid, one Gumbel-max per draw.

    CST: one draw a respondent from the table summed over sessions, copied
    to every session; u_theta (K, n, N). RDM: one draw a (session,
    respondent); u_theta (K, H, n, N). GP: a sequential Gibbs pass over the
    sessions, session h's prior the time GP's conditional given the other
    sessions, those before h already redrawn; u_theta (K, H, n, N).
    """
    K, H, n = state.theta_idx.shape
    _, inv_s = _temp_scales(temp)
    table = _theta_ll_table(state.fstar, mu_star, y, state.thresholds,
                            config.C, inv_s)  # (K, H, N, n)
    grid = consts.grid
    regime = config.theta_regime
    if regime != "GP":
        var = 1.0 + torch.square(consts.theta_prior_sds[0])  # (n,)
        logprior = -0.5 * torch.square(grid)[None, :] / var[:, None]  # (n, N)
        if regime == "RDM":
            return _gumbel_argmax(u_theta, table.mT + logprior, dim=-1)  # (K, H, n)
        logits = table.sum(dim=1).mT + logprior  # (K, n, N)
        idx = _gumbel_argmax(u_theta, logits, dim=-1)  # (K, n)
        return idx.unsqueeze(1).expand(K, H, n)

    lam = consts.Lambda_time  # (H, H)
    theta = theta_from_indices(state.theta_idx, consts)  # (K, H, n)
    idxs = []
    for h in range(H):
        lam_hh = lam[h, h]
        cross = torch.einsum("g,kgn->kn", lam[h], theta) - lam_hh * theta[:, h]
        mean = -cross / lam_hh  # (K, n)
        logprior = -0.5 * torch.square(grid - mean.unsqueeze(-1)) / (1.0 / lam_hh)
        idx = _gumbel_argmax(u_theta[:, h], table[:, h].mT + logprior, dim=-1)
        theta[:, h] = grid[idx]  # session h+1 conditions on the new value
        idxs.append(idx)
    return torch.stack(idxs, dim=1)


def _table_lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (K, H, N, n) at idx (K, H, n) -> (K, H, n), table[k, h, idx, i]."""
    return torch.take_along_dim(table, idx.unsqueeze(-2), dim=-2).squeeze(-2)


def draw_theta(state: GPIRTState, mu_star, y, consts: GPIRTConstants,
               config: GPIRTConfig, u_theta, temp=None) -> torch.Tensor:
    """theta_idx (K, H, n) by ``config.theta_method``
    (``gpirt_tpu/models/gibbs.py:1644``): the exact grid draw, or the
    reference code's ESS and snap, which has no tempered form."""
    if config.theta_method == "grid":
        return _draw_theta_grid(state, mu_star, y, consts, config, u_theta, temp)
    if temp is not None:
        raise NotImplementedError("tempering needs theta_method='grid'")
    return _draw_theta_ess(state, mu_star, y, consts, config, u_theta)


def _draw_theta_ess(state: GPIRTState, mu_star, y, consts: GPIRTConstants,
                    config: GPIRTConfig, draws: ThetaESSDraws) -> torch.Tensor:
    """The reference code's theta update (src/draw-theta.cpp:26-84,
    165-168; ``gpirt_tpu/models/gibbs.py:1741``): an ESS whose proposals are
    clamped to [-5, 5] and whose likelihood reads the ll table at the
    snapped proposal, then the snap. CST: one lane a respondent, prior sd
    sqrt(1 + sds^2), the table summed over sessions; RDM: one lane a
    (respondent, session); GP: one lane of the H sessions a respondent,
    its prior the time GP's factor L_time."""
    K, H, n = state.theta_idx.shape
    table = _theta_ll_table(state.fstar, mu_star, y, state.thresholds, config.C)
    theta = theta_from_indices(state.theta_idx, consts)  # (K, H, n)
    loop = (draws.logu, draws.eps0, draws.rs)

    def clamp(v):
        return torch.clamp(v, THETA_LO, THETA_HI)

    def ll_nH(theta_nH):  # (K, n, H) -> (K, n)
        return _table_lookup(table, snap_indices(theta_nH, config).mT).sum(dim=1)

    regime = config.theta_regime
    sd = torch.sqrt(1.0 + torch.square(consts.theta_prior_sds[0])).unsqueeze(-1)
    if regime == "CST":
        x_new = ess_update(theta[:, 0].unsqueeze(-1), draws.z * sd,
                           lambda xt: ll_nH(xt.expand(K, n, H)), *loop, transform=clamp)
        return snap_indices(x_new[..., 0], config).unsqueeze(1).expand(K, H, n)
    if regime == "RDM":
        def loglik(xt):  # (K, n, H, 1) -> (K, n, H)
            return _table_lookup(table, snap_indices(xt[..., 0], config).mT).mT

        x_new = ess_update(theta.mT.unsqueeze(-1), (draws.z * sd).unsqueeze(-1), loglik,
                           *loop, transform=clamp)
        return snap_indices(x_new[..., 0].mT, config)
    x_new = ess_update(theta.mT, draws.z @ consts.L_time.mT, ll_nH, *loop,
                       transform=clamp)
    return snap_indices(x_new.mT, config)


def draw_z_truncnorm(g, y, thresholds, u, temp=None) -> torch.Tensor:
    """Albert-Chib latents: z ~ N(g, T) truncated to the observed category's
    cutpoint interval (t_{y-1}, t_y), unconstrained where missing.

    Inverse CDF: z = g + sqrt(2 T) erfinv(2p - 1), p between the Phi's of
    the bounds. Infinite cutpoints are clamped to +-1e30 first, and a
    far-tail interval (width < 1e-6 in probability) falls back to the
    nearest bound. Binary data has one finite bound a cell, t_1; ordinal
    data gathers both bounds per cell (the JAX package's one-hot
    contractions select the same values exactly).
    """
    big = 1e30
    sqrt_t, inv_s = _temp_scales(temp)
    sqrt_t, inv_s = _per_chain(sqrt_t, g.ndim), _per_chain(inv_s, g.ndim)
    c = _INV_SQRT2 if inv_s is None else _INV_SQRT2 * inv_s
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    if thresholds.shape[-1] == 3:
        t1 = torch.clamp(thresholds, -big, big)[..., 1].unsqueeze(-2)  # (K, H, 1, m)
        cdf_b = 0.5 * (1.0 + torch.erf((t1 - g) * c))
        cdf_lo = torch.where(y == 2, cdf_b, zero)
        cdf_hi = torch.where(y == 1, cdf_b, zero + 1.0)
        z_lo = torch.where(y == 2, t1, zero - big)
        z_hi = torch.where(y == 1, t1, zero + big)
    else:
        z_lo, z_hi, mask = cutpoint_bounds(y, thresholds)  # (K, H, n, m)
        cdf_lo = torch.where(mask, 0.5 * (1.0 + torch.erf((z_lo - g) * c)), zero)
        cdf_hi = torch.where(mask, 0.5 * (1.0 + torch.erf((z_hi - g) * c)), zero + 1.0)
    eps = 1e-6
    p = torch.clamp(cdf_lo + u * (cdf_hi - cdf_lo), eps, 1.0 - eps)
    q = _SQRT2 * torch.erfinv(2.0 * p - 1.0)
    z = g + (q if sqrt_t is None else sqrt_t * q)
    tail = (cdf_hi - cdf_lo) < eps
    fallback = torch.clamp(g, torch.where(z_lo > -1e29, z_lo, g),
                           torch.where(z_hi < 1e29, z_hi, g))
    return torch.where(tail, fallback, z)


def _pathwise_fstar(U_theta, resid, diag: float, zc, z_n, consts: GPIRTConstants,
                    config: GPIRTConfig) -> torch.Tensor:
    """f* = u* + K_{*theta} (K_theta + diag I)^{-1} resid on the grid, where
    resid is the target at the sites minus the prior draw u* there, and u*
    = U_grid zc + sqrt(jitter) z_n is factored through the grid basis
    U_grid = [U_se, Psi] (U_theta its rows at the sites, (..., n, q+3)).
    The smoother runs in that rank-(q+3) basis: U^T (U U^T + diag I)^{-1} =
    (U^T U + diag I)^{-1} U^T, one equilibrated (q+3)-square Cholesky with
    one refinement step. Returns f* (..., N, m)."""
    g_k = U_theta.mT @ resid  # (..., k, m)
    k_dim = U_theta.shape[-1]
    eye = torch.eye(k_dim, dtype=resid.dtype, device=resid.device)
    C = diag * eye + U_theta.mT @ U_theta  # (..., k, k)
    inv_sc = 1.0 / torch.sqrt(torch.diagonal(C, dim1=-2, dim2=-1))
    Lc = torch.linalg.cholesky(C * (inv_sc.unsqueeze(-1) * inv_sc.unsqueeze(-2)))

    def c_solve(rhs):  # C^{-1} rhs, equilibrated
        w = tri_solve(Lc, rhs * inv_sc.unsqueeze(-1))
        return tri_solve(Lc, w, trans=True) * inv_sc.unsqueeze(-1)

    ua = c_solve(g_k)
    ua = ua + c_solve(g_k - C @ ua)
    U_grid = torch.cat([consts.U_se, consts.Psi_grid], dim=-1)  # (N, q+3)
    return U_grid @ (zc + ua) + math.sqrt(config.jitter) * z_n


def draw_fstar_conjugate(state: GPIRTState, z_resid, config: GPIRTConfig,
                         consts: GPIRTConstants, z_q, z_p, z_n, eps,
                         temp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact Gaussian draw of f* | z (pathwise, push-through form):
    f* = u* + K_{*theta} (K_theta + T I)^{-1} (z - mu - u - eps'), with the
    prior draw u* = U_grid z_c + sqrt(jitter) z_n (:func:`_pathwise_fstar`).

    Under constant_IRF the regression is the stacked (H n)-site GP on one
    shared grid function (``_fstar_conjugate_pooled``,
    ``gpirt_tpu/models/gibbs.py:590``): z_q, z_p, z_n have H = 1, every
    session's sites gather from that one draw, and the capacitance pools
    the basis Gram over the sessions, C = T I + sum_h U_h^T U_h.

    z_resid, eps: (K, H, n, m), z_resid = z - mu. ``temp`` is None, a float,
    or a (K,) tensor. Returns (fstar (K, H, N, m), f (K, H, n, m)).
    """
    idx = state.theta_idx
    if config.constant_IRF:
        idx, z_resid, eps = (_stack_sessions(a) for a in (idx, z_resid, eps))
    sqrt_t, _ = _temp_scales(temp)
    zc = torch.cat([z_q, z_p], dim=-2)  # (K, H, q+3, m)
    U_theta = theta_site_basis(idx, consts)  # (K, H, n, q+3)
    u_theta = U_theta @ zc + math.sqrt(config.jitter) * _rows(z_n, idx)
    if sqrt_t is not None:
        eps = eps * _per_chain(sqrt_t, eps.ndim)  # tempered observation noise sd sqrt(T)
    t = 1.0 if temp is None else _per_chain(temp, 4) if torch.is_tensor(temp) else float(temp)
    fstar = _pathwise_fstar(U_theta, z_resid - u_theta - eps, t, zc, z_n, consts, config)
    fstar = _share(fstar, config.horizon)
    return fstar, _rows(fstar, state.theta_idx)


def _fstar_matheron(f, theta_idx, consts: GPIRTConstants, config: GPIRTConfig,
                    z_q, z_p, z_n) -> torch.Tensor:
    """The zero-mean GP conditional f* | f on the grid by Matheron's rule,
    f the noise-free values at the sites up to ``device_jitter``
    (``gpirt_tpu/models/gibbs.py:304``): the push-through of
    :func:`_pathwise_fstar` with diag = device_jitter."""
    zc = torch.cat([z_q, z_p], dim=-2)
    U = theta_site_basis(theta_idx, consts)
    u_theta = U @ zc + math.sqrt(config.jitter) * _rows(z_n, theta_idx)
    return _pathwise_fstar(U, f - u_theta, config.device_jitter, zc, z_n, consts, config)


def _fstar_chol(f, theta_idx, L, consts: GPIRTConstants, config: GPIRTConfig,
                z) -> torch.Tensor:
    """The reference's posterior Cholesky draw of f* | f (src/draw-fstar.cpp:20-57;
    ``gpirt_tpu/models/gibbs.py:367``), zero-mean: mean V^T L^{-1} f and
    covariance K** - V^T V with V = L^{-1} K_{theta *}, L the theta Gram's
    factor, z (..., N, m) normal. The posterior factor takes the raw model
    nugget; where float32 cannot factor it, f* is NaN, as in JAX."""
    kstar = consts.grid_gram[theta_idx]  # (..., n, N)
    V = tri_solve(L, kstar)
    L_post = chol_with_jitter(consts.grid_gram - V.mT @ V, config.jitter)
    return V.mT @ tri_solve(L, f) + L_post @ z


def _grid_prior(consts: GPIRTConstants, config: GPIRTConfig, z_q, z_p, z_n) -> torch.Tensor:
    """A GP prior draw on the grid through the rank-(q+3) eigenbasis,
    U_se z_q + Psi z_p + sqrt(jitter) z_n (``grid_prior_draw``,
    ``gpirt_tpu/models/gibbs.py:252``): (..., q, m), (..., 3, m),
    (..., N, m) -> (..., N, m)."""
    return consts.U_se @ z_q + consts.Psi_grid @ z_p + math.sqrt(config.jitter) * z_n


def _fstar_constant_irf(f, theta_idx, consts: GPIRTConstants, config: GPIRTConfig,
                        z_q, z_p, z_n) -> torch.Tensor:
    """The constant_IRF f* | f draw (``gpirt_tpu/models/gibbs.py:380``;
    src/draw-fstar.cpp:58-125, Matheron-ized): the stacked f of all H n
    sites interpolated onto ``config.n_inducing`` points spread over
    [min theta, max theta], and one shared grid prior draw conditioned on
    those values. f (K, H, n, m), theta_idx (K, H, n); z_q, z_p, z_n with
    H = 1. Returns f* (K, H, N, m), one function a chain shared (a view).

    Where every theta is equal the inducing points coincide and their Gram
    is singular: f* is NaN in float32, in JAX too.
    """
    H, p = f.shape[1], config.n_inducing
    theta_all = _stack_sessions(theta_from_indices(theta_idx, consts))  # (K, 1, H n)
    lo = theta_all.amin(dim=-1, keepdim=True)
    hi = theta_all.amax(dim=-1, keepdim=True)
    inducing = lo + (hi - lo) * torch.arange(p, dtype=f.dtype, device=f.device) / (p - 1)
    order = torch.argsort(theta_all, dim=-1, stable=True)  # jnp.argsort is stable
    f_ind = interp(inducing, torch.take_along_dim(theta_all, order, -1),
                   torch.take_along_dim(_stack_sessions(f), order.unsqueeze(-1), -2))
    sds = consts.beta_prior_sds[:, 0]
    L_ind = chol_with_jitter(icc_gram(inducing, inducing, sds), config.device_jitter,
                             normalized=config.chol_normalized)  # (K, 1, p, p)
    ustar = _grid_prior(consts, config, z_q, z_p, z_n)  # (K, 1, N, m)
    V = tri_solve(L_ind, icc_gram(inducing, consts.grid, sds))  # (K, 1, p, N)
    w = tri_solve(L_ind, f_ind - interp(inducing, consts.grid, ustar))  # (K, 1, p, m)
    return _share(ustar + V.mT @ w, H)


def draw_fstar(f, theta_idx, consts: GPIRTConstants, config: GPIRTConfig,
               draws: FStarDraws) -> torch.Tensor:
    """Zero-mean draw of f* | f on the grid: the constant_IRF draw, or by
    ``config.fstar_method`` (``gpirt_tpu/models/gibbs.py:416``); mu* is
    added where f* is used or stored. f (..., n, m), theta_idx (..., n) ->
    (..., N, m)."""
    if config.constant_IRF:
        return _fstar_constant_irf(f, theta_idx, consts, config, *draws)
    if config.fstar_method == "matheron":
        return _fstar_matheron(f, theta_idx, consts, config, *draws)
    return _fstar_chol(f, theta_idx, theta_chol(theta_idx, consts, config), consts,
                       config, draws.z_n)


def draw_f(f, theta_idx, thresholds, mu, y, consts: GPIRTConstants,
           config: GPIRTConfig, draws: FDraws) -> torch.Tensor:
    """ESS redraw of f, one lane per (chain, horizon, item) over the n
    sites, prior N(0, K(theta, theta) + device_jitter I) drawn by
    :func:`theta_prior_perturbation` (``gpirt_tpu/models/gibbs.py:159``).
    Under constant_IRF one lane per (chain, item) over the H n stacked
    sites, with session 0's cutpoints (``:194-212``).

    f, mu (K, H, n, m); theta_idx (K, H, n); thresholds (K, H, m, C+1).
    """
    shape = f.shape
    if config.constant_IRF:
        f, theta_idx, mu = (_stack_sessions(a) for a in (f, theta_idx, mu))
        y, thresholds = _stack_sessions(y, 0), thresholds[:, :1]
    nu = theta_prior_perturbation(theta_idx, consts, config, draws.z_u, draws.z_site)
    z_lo, z_hi, mask = cutpoint_bounds(y, thresholds)  # hoisted out of the rounds

    def loglik(xt):  # (K, H, m, n) -> (K, H, m)
        return ll_terms_from_bounds(xt.mT + mu, z_lo, z_hi, mask).sum(dim=-2)

    return ess_update(f.mT, nu.mT, loglik, *draws.ess).mT.contiguous().view(shape)


def draw_fstar_direct(state: GPIRTState, mu, y, consts: GPIRTConstants,
                      config: GPIRTConfig, draws: FStarDraws,
                      ess: ESSLoopDraws) -> Tuple[torch.Tensor, torch.Tensor]:
    """The grid-native latent update (``gpirt_tpu/models/gibbs.py:435``):
    one ESS move of each item's whole grid function f*, one lane per
    (chain, horizon, item) over the N grid points, its prior the grid
    prior draw of ``draws`` and its likelihood the f* rows at the snapped
    theta. Under constant_IRF one lane per (chain, item), the likelihood
    summed over all H n sites.

    mu (K, H, n, m). Returns (fstar (K, H, N, m), f (K, H, n, m)).
    """
    idx, fstar, thresholds = state.theta_idx, state.fstar, state.thresholds
    if config.constant_IRF:
        idx, mu = _stack_sessions(idx), _stack_sessions(mu)
        fstar, thresholds, y = fstar[:, :1], thresholds[:, :1], _stack_sessions(y, 0)
    nu = _grid_prior(consts, config, *draws)  # (K, H, N, m)
    z_lo, z_hi, mask = cutpoint_bounds(y, thresholds)

    def loglik(xt):  # (K, H, m, N) -> (K, H, m)
        return ll_terms_from_bounds(_rows(xt.mT, idx) + mu, z_lo, z_hi, mask).sum(dim=-2)

    fstar = ess_update(fstar.mT, nu.mT, loglik, *ess).mT.contiguous()
    fstar = _share(fstar, config.horizon)
    return fstar, _rows(fstar, state.theta_idx)


def draw_beta(beta, theta, f, thresholds, y, consts: GPIRTConstants,
              config: GPIRTConfig, draws: BetaDraws) -> torch.Tensor:
    """ESS redraw of the 3 mean coefficients per (chain, horizon, item)
    (``gpirt_tpu/models/gibbs.py:1800``). The prior is N(0, diag(sds^2 +
    1e-6)): the reference's ESS rotates beta around the origin whatever
    beta_prior_means says (src/draw-beta.cpp:16). An item with no
    observation in a session keeps its beta (src/draw-beta.cpp:97-99).

    beta (K, H, 3, m); theta (K, H, n); f (K, H, n, m) -> (K, H, 3, m).
    """
    X = build_X(theta)  # (K, H, n, 3)
    sd = torch.sqrt(torch.square(consts.beta_prior_sds) + 1e-6)  # (3, m)
    z_lo, z_hi, mask = cutpoint_bounds(y, thresholds)

    def loglik(xt):  # (K, H, m, 3) -> (K, H, m)
        return ll_terms_from_bounds(f + X @ xt.mT, z_lo, z_hi, mask).sum(dim=-2)

    x = beta.mT
    x_new = ess_update(x, draws.z * sd.mT, loglik, *draws.ess)
    has_obs = (y > 0).any(dim=-2)  # (H, m)
    return torch.where(has_obs.unsqueeze(-1), x_new, x).mT.contiguous()


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
    if temp is not None:  # noise variance T
        inv_t = 1.0 / (_per_chain(temp, XtX.ndim) if torch.is_tensor(temp) else float(temp))
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
    """y-marginal ESS redraw of the cutpoints in the delta parametrization,
    identity prior (src/draw_threshold.cpp), one lane per (chain, horizon,
    item).

    Binary data goes through the binary cutpoint ESS kernel, on every
    binary ESS update of every path (the JAX package keeps its Pallas
    kernel opt-in, and off under constant_IRF and tempering,
    ``gpirt_tpu/models/gibbs.py:2299-2301``). Ordinal data goes through
    :func:`ess_update`, its loglik the category log-probs summed against
    the one-hot of y. The pooled constant_IRF update
    (:func:`_draw_cutpoints`) calls this with one session of H n stacked
    sites: g (K, 1, H n, m), y (1, H n, m), one t_1 a (chain, item), which
    is the JAX package's ``_binary_ll(t1, pool_horizons=True)``.

    thresholds (K, H, m, C+1); nu (K, H, m, C-1), or (K, H, m) when
    binary; logu, eps0 (K, H, m); rs (R, K, H, m). ``temp`` is None, a
    float, or a (K,) tensor of one temperature a chain.
    """
    C = thresholds.shape[-1] - 1
    _, inv_s = _temp_scales(temp)
    g = f + mu
    if C == 2:
        c = _INV_SQRT2 if inv_s is None else _INV_SQRT2 * inv_s
        t1 = thresholds[..., 1].contiguous()
        t_new = binary_threshold_ess(g.contiguous(), y, t1, nu.reshape(t1.shape),
                                     logu, eps0, rs, c)
        return delta_to_threshold(t_new.unsqueeze(-1))
    onehot = _onehot(y, C, g.dtype)  # (H, n, m, C)

    def loglik(d):  # (K, H, m, C-1) -> (K, H, m)
        thr = delta_to_threshold(d)
        logp = _category_logprobs(g, thr.unsqueeze(-3), C, inv_s)  # (K, H, n, m, C)
        return (logp * onehot).sum(dim=(-3, -1))

    d_new = ess_update(threshold_to_delta(thresholds), nu, loglik, logu, eps0, rs)
    return delta_to_threshold(d_new)


def draw_threshold_collapsed(thresholds, z, y, config: GPIRTConfig,
                             cut: Union[CollapsedDraws, ESSDraws]) -> torch.Tensor:
    """The cutpoints given the Albert-Chib latents z
    (``gpirt_tpu/models/gibbs.py:2389``): given z the ordinal likelihood is
    the box lo_c = max{z : y = c} <= t_c < hi_c = min{z : y = c + 1}, so the
    conditional is the delta prior N(0, I) restricted to the box, which
    holds the current cutpoints. C = 2: the exact inverse-CDF draw of t_1 ~
    N(0, 1) in its box, clamped into it (a far-tail CDF may land outside);
    C > 2: an ESS on delta against the box indicator. It does not involve
    the temperature. Under constant_IRF one box pools every session.

    thresholds (K, H, m, C+1); z (K, H, n, m); ``cut`` has H = 1 under
    constant_IRF.
    """
    H, C = thresholds.shape[1], config.C
    big = 1e30
    cats = torch.arange(1, C, device=y.device)
    yb, zb = y.unsqueeze(-1), z.unsqueeze(-1)
    lo = torch.where(yb == cats, zb, -big).amax(dim=-3)  # (K, H, m, C-1)
    hi = torch.where(yb == cats + 1, zb, big).amin(dim=-3)
    if config.constant_IRF:
        lo, hi = lo.amax(dim=1, keepdim=True), hi.amin(dim=1, keepdim=True)
        thresholds = thresholds[:, :1]
    if C == 2:
        cdf_lo = 0.5 * (1.0 + torch.erf(lo * _INV_SQRT2))
        cdf_hi = 0.5 * (1.0 + torch.erf(hi * _INV_SQRT2))
        p = torch.clamp(cdf_lo + cut.u.unsqueeze(-1) * (cdf_hi - cdf_lo), 1e-6, 1.0 - 1e-6)
        thr = delta_to_threshold(torch.clamp(torch.special.ndtri(p), lo, hi))
    else:
        zero = torch.zeros((), dtype=z.dtype, device=z.device)

        def loglik(d):  # (K, H, m, C-1) -> (K, H, m)
            t_int = delta_to_threshold(d)[..., 1:C]
            return torch.where(((t_int >= lo) & (t_int < hi)).all(dim=-1), zero, -math.inf)

        thr = delta_to_threshold(ess_update(threshold_to_delta(thresholds), cut.nu, loglik,
                                            cut.logu, cut.eps0, cut.rs))
    return _share(thr, H).contiguous()


def draw_threshold_shift(thresholds, beta, consts: GPIRTConstants, z):
    """The exact Gibbs draw along the likelihood-null direction t_jc +=
    delta_j for every interior cutpoint and beta0_j += delta_j
    (``gpirt_tpu/models/gibbs.py:2186``): its conditional is the priors on
    the line, N(0, 1) on t_1 times N(0, sds0^2 + 1e-6) on beta0, a 1-D
    Gaussian an item. thresholds (K, H, m, C+1), beta (K, H, 3, m), z
    (K, H, m) normal. Returns (thresholds, beta, delta (K, H, m))."""
    b0 = beta[..., 0, :]
    s0sq = torch.square(consts.beta_prior_sds[0]) + 1e-6  # (m,)
    prec = 1.0 + 1.0 / s0sq
    mean = -(thresholds[..., 1] + b0 / s0sq) / prec
    delta = mean + z / torch.sqrt(prec)
    interior = torch.zeros(thresholds.shape[-1], dtype=torch.bool, device=z.device)
    interior[1:-1] = True
    thr = torch.where(interior, thresholds + delta.unsqueeze(-1), thresholds)
    beta = torch.cat([(b0 + delta).unsqueeze(-2), beta[..., 1:, :]], dim=-2)
    return thr, beta, delta


def _draw_threshold_binary_newton(thresholds, g, y, z, logu, inv_s=None):
    """Newton-proposal independence MH on the binary cutpoint t_1, the
    conditional of the binary ESS (prior N(0, 1), likelihood the sum of
    log(Phi(s (t_1 - g)) + 1e-6) over observed cells).

    Each try proposes N(t + clip(Newton step, +-3), -1.1^2 / psi'') from
    the current point's (psi, psi', psi''), evaluates the proposal's own
    stats for the reverse move, and accepts by the exact proposal-aware
    ratio (``gpirt_tpu/models/gibbs.py:1842``).

    thresholds (K, H, m, 3); g (K, H, n, m); z (tries, K, H, m, 1) normal;
    logu (tries, K, H, m).
    """
    obs = y > 0
    sgn = torch.where(y == 1, 1.0, -1.0).to(g.dtype) * obs  # (H, n, m)
    cscale = 1.0 if inv_s is None else inv_s
    cs_site, cs_lane = _per_chain(cscale, 4), _per_chain(cscale, 3)

    def stats(t1):  # (K, H, m) -> psi, proposal mean, proposal variance
        u = sgn * (t1.unsqueeze(-2) - g) * cs_site  # (K, H, n, m)
        phi_cdf = 0.5 * (1.0 + torch.erf(u * _INV_SQRT2)) + 1e-6
        r = _INV_SQRT2PI * torch.exp(-0.5 * u * u) / phi_cdf
        psi = -0.5 * t1 * t1 + (torch.log(phi_cdf) * obs).sum(dim=-2)
        dpsi = -t1 + cs_lane * (sgn * r).sum(dim=-2)
        d2psi = -1.0 + cs_lane * cs_lane * ((r * (-u - r)) * obs).sum(dim=-2)
        d2psi = torch.clamp(d2psi, max=-1.0)  # concave up to the 1e-6 floors
        return psi, t1 + torch.clamp(-dpsi / d2psi, -3.0, 3.0), -1.21 / d2psi

    def log_q(x, mean, var):
        return -0.5 * (torch.log(var) + torch.square(x - mean) / var)

    t1 = thresholds[..., 1]
    cur = stats(t1)
    for k in range(z.shape[0]):
        psi0, mean0, var0 = cur
        prop = mean0 + torch.sqrt(var0) * z[k, ..., 0]
        psi1, mean1, var1 = stats(prop)
        log_a = psi1 - psi0 + log_q(t1, mean1, var1) - log_q(prop, mean0, var0)
        acc = logu[k] < log_a
        t1 = torch.where(acc, prop, t1)
        cur = tuple(torch.where(acc, new, old)
                    for new, old in zip((psi1, mean1, var1), cur))
    return delta_to_threshold(t1.unsqueeze(-1))


def _draw_threshold_newton_ordinal(thresholds, g, y, z, logu, inv_s=None):
    """Newton-proposal independence MH on each lane's ordinal cutpoint
    vector, in delta space, with the conditional of the ordinal ESS (prior
    N(0, I) on delta, likelihood the sum of log(P(y | t) + 1e-6)).

    Per pass and lane: psi, the exact cutpoint-space gradient and the
    tridiagonal cutpoint Hessian (a cell touches only its category's two
    bounds), carried to delta space through the Jacobian of
    delta_to_threshold plus its curvature term. The proposal is N(d +
    clip(Newton step, +-3), 1.1^2 A^{-1}), A = -Hessian made positive
    definite by a Gershgorin diagonal ridge; the reverse stats come from
    the proposal's pass, so the acceptance ratio is exact
    (``gpirt_tpu/models/gibbs.py:1927``).

    thresholds (K, H, m, C+1); g (K, H, n, m); z (tries, K, H, m, C-1)
    normal; logu (tries, K, H, m).
    """
    C = thresholds.shape[-1] - 1
    q = C - 1
    dt, dev = g.dtype, g.device
    cscale = 1.0 if inv_s is None else inv_s
    cs_site, cs_lane = _per_chain(cscale, 5), _per_chain(cscale, 4)
    eta = 1.1
    obs = y > 0
    onehot = _onehot(y, C, dt)  # (H, n, m, C)
    up = onehot[..., :q]  # the cell's upper bound is interior cutpoint c
    lo = onehot[..., 1:]  # the cell's lower bound is interior cutpoint c
    sgn_b = up - lo
    eye = torch.eye(q, dtype=dt, device=dev)
    tri = torch.tril(torch.ones(q, q, dtype=dt, device=dev))  # tri[c, j] = c >= j
    first = torch.arange(q, device=dev) == 0

    def stats(d):  # (K, H, m, q) -> psi, proposal mean, chol(A), logdet(A)
        t_int = delta_to_threshold(d)[..., 1:C]
        u = (t_int.unsqueeze(-3) - g.unsqueeze(-1)) * cs_site  # (K, H, n, m, q)
        cdf = 0.5 * (1.0 + torch.erf(u * _INV_SQRT2))
        pdf = _INV_SQRT2PI * torch.exp(-0.5 * u * u)
        zero = torch.zeros(cdf.shape[:-1] + (1,), dtype=dt, device=dev)
        cdf_full = torch.cat([zero, cdf, zero + 1.0], dim=-1)
        p_cell = ((cdf_full[..., 1:] - cdf_full[..., :-1]) * onehot).sum(-1) + 1e-6
        pc = p_cell.unsqueeze(-1)
        ll_sum = (torch.log(p_cell) * obs).sum(dim=-2)  # (K, H, m)
        grad_t = (sgn_b * pdf / pc).sum(dim=-3) * cs_lane  # (K, H, m, q)
        # pdf'(u) = -u pdf; (up - lo)^2 = up + lo, the two being disjoint
        diag_c = (-u * pdf * sgn_b - pdf * pdf * (up + lo) / pc) / pc
        Ht = torch.diag_embed(diag_c.sum(dim=-3) * cs_lane * cs_lane)
        if q > 1:
            # cells with y = c+1 have lower bound c and upper bound c+1
            off_c = pdf[..., :-1] * pdf[..., 1:] * lo[..., :-1] / (pc ** 2)
            off_t = off_c.sum(dim=-3) * cs_lane * cs_lane
            Ht = Ht + torch.diag_embed(off_t, 1) + torch.diag_embed(off_t, -1)
        # t_c = d_1 + sum_{2<=j<=c} exp(d_j): J[c, j] = 1 (j = 1), exp(d_j)
        # (2 <= j <= c), 0 (j > c)
        col = torch.where(first, 1.0, torch.exp(d))
        J = tri * col.unsqueeze(-2)
        grad_d = (J * grad_t.unsqueeze(-1)).sum(dim=-2)
        tail = torch.flip(torch.cumsum(torch.flip(grad_t, [-1]), -1), [-1])
        curv = torch.where(first, 0.0, col * tail)  # d^2 t_c / d d_j^2 terms
        Hd = J.mT @ Ht @ J + torch.diag_embed(curv)
        psi = -0.5 * (d * d).sum(dim=-1) + ll_sum
        A = eye - Hd  # -(H_lik + H_prior)
        diag_a = torch.diagonal(A, dim1=-2, dim2=-1)
        offsum = A.abs().sum(dim=-1) - diag_a.abs()
        tau = torch.clamp((offsum - diag_a + 1.0).amax(dim=-1), min=0.0)
        L, _ = torch.linalg.cholesky_ex(A + tau[..., None, None] * eye)
        rhs = (grad_d - d).unsqueeze(-1)
        step = tri_solve(L, tri_solve(L, rhs), trans=True)[..., 0]
        mean = d + torch.clamp(step, -3.0, 3.0)
        logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(dim=-1)
        return psi, mean, L, logdet

    def log_q(x, mean, L, logdet):  # N(mean, eta^2 A^{-1})
        r = (L.mT @ (x - mean).unsqueeze(-1))[..., 0]
        return 0.5 * logdet - q * math.log(eta) - 0.5 * (r * r).sum(dim=-1) / (eta * eta)

    d_cur = threshold_to_delta(thresholds)
    cur = stats(d_cur)
    for k in range(z.shape[0]):
        psi0, mean0, L0, ld0 = cur
        prop = mean0 + eta * tri_solve(L0, z[k].unsqueeze(-1), trans=True)[..., 0]
        psi1, mean1, L1, ld1 = stats(prop)
        log_a = (psi1 - psi0 + log_q(d_cur, mean1, L1, ld1)
                 - log_q(prop, mean0, L0, ld0))
        acc = logu[k] < log_a
        accq = acc.unsqueeze(-1)
        d_cur = torch.where(accq, prop, d_cur)
        cur = (torch.where(acc, psi1, psi0), torch.where(accq, mean1, mean0),
               torch.where(accq.unsqueeze(-1), L1, L0), torch.where(acc, ld1, ld0))
    return delta_to_threshold(d_cur)


def _draw_cutpoints(thresholds, f, mu, y, config: GPIRTConfig, cut, temp=None):
    """The configured cutpoint update: Newton-proposal MH, or the y-marginal
    ESS of :func:`draw_threshold`. Under constant_IRF one cutpoint vector a
    chain, its likelihood summed over every session's sites
    (``gpirt_tpu/models/gibbs.py:2288-2296``, ``:2362-2374``, and the pooled
    Newton ``:1862``, ``:1963``): the update of one session of H n stacked
    sites from session 0's cutpoints, shared back to the H sessions; ``cut``
    has H = 1."""
    H = thresholds.shape[1]
    if config.constant_IRF:
        thresholds, y = thresholds[:, :1], _stack_sessions(y, 0)
        f, mu = _stack_sessions(f), _stack_sessions(mu)
    if config.resolved_threshold_method == "newton":
        newton = (_draw_threshold_binary_newton if config.C == 2
                  else _draw_threshold_newton_ordinal)
        thresholds = newton(thresholds, f + mu, y, *cut, _temp_scales(temp)[1])
    else:
        thresholds = draw_threshold(thresholds, f, mu, y, config, *cut, temp)
    return _share(thresholds, H).contiguous()


def gibbs_sweep(state: GPIRTState, draws: Union[SweepDraws, GridDraws, TwoStageDraws],
                y: torch.Tensor, consts: GPIRTConstants, config: GPIRTConfig,
                temp: Optional[float] = None,
                iteration: int = 0) -> Tuple[GPIRTState, torch.Tensor]:
    """One Gibbs sweep of K chains by ``config.resolved_f_method`` (block
    orders in the module docstring). Returns (state, ll (K,)).

    ``temp`` (None = 1) tempers the observation noise to sd sqrt(T), on the
    conjugate path only (as in JAX): one float for every chain, or a (K,)
    tensor of one temperature a chain (parallel tempering's lanes; as
    ``jax.vmap(gibbs_sweep)`` over the temperatures). The returned ll is
    each chain's own tempered log-likelihood. ``iteration``, the sweep's
    index (a host int), picks the cutpoint update under "interleave" and
    must be the one ``draws`` were made for.
    """
    method = config.resolved_f_method
    if method != "conjugate":
        if temp is not None:
            raise NotImplementedError(
                "tempering is implemented for f_method='conjugate' only")
        sweep = _two_stage_sweep if method == "two_stage" else _grid_sweep
        return sweep(state, draws, y, consts, config)
    _, inv_s = _temp_scales(temp)
    mu_star = compute_mu_star(consts, state.beta)
    for d in _passes(draws, config.mix_subsweeps):
        theta_idx = draw_theta(state, mu_star, y, consts, config, d.u_theta, temp)
        state = state._replace(theta_idx=theta_idx, f=_rows(state.fstar, theta_idx))
        theta = theta_from_indices(theta_idx, consts)
        mu = compute_mu(theta, state.beta)
        z = draw_z_truncnorm(state.f + mu, y, state.thresholds, d.u_z, temp)
        if config.affine:  # against the z-marginal, before f* is redrawn
            # imported here: models.affine imports this module's helpers
            from gpirt_tpu_torch.models.affine import affine_theta_moves

            theta_idx, beta = affine_theta_moves(theta_idx, z, state.beta, consts, config,
                                                 d.affine, temp)
            state = state._replace(theta_idx=theta_idx, beta=beta)
            theta = theta_from_indices(theta_idx, consts)
            mu = compute_mu(theta, beta)
        fstar, f = draw_fstar_conjugate(state, z - mu, config, consts, d.z_q, d.z_p,
                                        d.z_n, d.eps_f, temp)
        state = state._replace(fstar=fstar, f=f)
    beta = draw_beta_conjugate(theta, z - f, consts, config, draws.zeta, temp)
    mu = compute_mu(theta, beta)
    if _cut_method(config, iteration) == "collapsed":
        thresholds = draw_threshold_collapsed(state.thresholds, z, y, config, draws.cut)
    else:
        thresholds = _draw_cutpoints(state.thresholds, f, mu, y, config, draws.cut, temp)
    thresholds, beta, mu = _shift(thresholds, beta, mu, consts, config, draws.shift)
    state = GPIRTState(theta_idx=theta_idx, f=f, beta=beta,
                       thresholds=thresholds, fstar=fstar)
    ll = ordinal_ll_terms(f + mu, y, thresholds,
                          _per_chain(inv_s, 4)).sum(dim=(-3, -2, -1))
    return state, ll


def _shift(thresholds, beta, mu, consts: GPIRTConstants, config: GPIRTConfig, z):
    """The (t, beta0) shift after the cutpoint update when the config asks
    for it (skipped under constant_IRF, as in JAX), mu moved with beta0:
    (thresholds, beta, mu)."""
    if not config.threshold_shift or config.constant_IRF:
        return thresholds, beta, mu
    thresholds, beta, delta = draw_threshold_shift(thresholds, beta, consts, z)
    return thresholds, beta, mu + delta.unsqueeze(-2)


def _two_stage_sweep(state: GPIRTState, draws: TwoStageDraws, y, consts: GPIRTConstants,
                     config: GPIRTConfig) -> Tuple[GPIRTState, torch.Tensor]:
    """The reference pipeline (``gpirt_tpu/models/gibbs.py:2768-2808``): f
    by ESS at the current theta, then a pass of f* | f and theta | f* (f
    read from f* at the new theta) per mix_subsweeps, then
    :func:`_ess_sweep_tail`."""
    mu_star = compute_mu_star(consts, state.beta)  # theta's table: the old beta
    theta = theta_from_indices(state.theta_idx, consts)
    mu = compute_mu(theta, state.beta)
    f = draw_f(state.f, state.theta_idx, state.thresholds, mu, y, consts, config,
               draws.f)
    state = state._replace(f=f)
    for d in _passes(draws, config.mix_subsweeps):
        fstar = draw_fstar(state.f, state.theta_idx, consts, config, d.fstar)
        state = state._replace(fstar=fstar)
        theta_idx = draw_theta(state, mu_star, y, consts, config, d.u_theta)
        state = state._replace(theta_idx=theta_idx, f=_rows(fstar, theta_idx))
    return _ess_sweep_tail(state, y, consts, config, draws)


def _grid_sweep(state: GPIRTState, draws: GridDraws, y, consts: GPIRTConstants,
                config: GPIRTConfig) -> Tuple[GPIRTState, torch.Tensor]:
    """The grid-native sweep (``gpirt_tpu/models/gibbs.py:2753-2767``): a
    pass per mix_subsweeps of f* by ESS at the current theta
    (:func:`draw_fstar_direct`) and theta | f* on the grid, then
    :func:`_ess_sweep_tail`."""
    mu_star = compute_mu_star(consts, state.beta)  # theta's table: the old beta
    for d in _passes(draws, config.mix_subsweeps):
        theta = theta_from_indices(state.theta_idx, consts)
        mu = compute_mu(theta, state.beta)
        fstar, f = draw_fstar_direct(state, mu, y, consts, config, d.fstar, d.ess)
        state = state._replace(f=f, fstar=fstar)
        theta_idx = draw_theta(state, mu_star, y, consts, config, d.u_theta)
        state = state._replace(theta_idx=theta_idx, f=_rows(fstar, theta_idx))
    return _ess_sweep_tail(state, y, consts, config, draws)


def _ess_sweep_tail(state: GPIRTState, y, consts: GPIRTConstants, config: GPIRTConfig,
                    draws: Union[GridDraws, TwoStageDraws]) -> Tuple[GPIRTState, torch.Tensor]:
    """The blocks after the latent passes of the grid and two-stage sweeps
    (``gpirt_tpu/models/gibbs.py:2785-2808``): beta by ESS at f = f*(theta),
    the cutpoints, the shift, the ll."""
    theta = theta_from_indices(state.theta_idx, consts)
    f = state.f
    beta = draw_beta(state.beta, theta, f, state.thresholds, y, consts, config,
                     draws.beta)
    mu = compute_mu(theta, beta)
    thresholds = _draw_cutpoints(state.thresholds, f, mu, y, config, draws.cut)
    thresholds, beta, mu = _shift(thresholds, beta, mu, consts, config, draws.shift)
    state = state._replace(beta=beta, thresholds=thresholds)
    ll = ordinal_ll_terms(f + mu, y, thresholds).sum(dim=(-3, -2, -1))
    return state, ll
