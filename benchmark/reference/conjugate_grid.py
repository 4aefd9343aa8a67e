"""Plain reference of the program's conjugate Gibbs sweep on the theta grid
(``f_method="conjugate"``, ``theta_method="grid"``, the y-marginal
cutpoint ESS, one session, one latent pass, no affine moves and no
shift): one session, theta drawn exactly on its grid, Albert-Chib latents
z, f* drawn given z through the grid eigenbasis, beta given z and f, the
cutpoints by the y-marginal elliptical slice update, and the
log-likelihood trace; with the order in which the program draws the
sweep's random numbers, and what the check compares.

It imports torch and numpy alone, works out every constant again from the
configuration (the theta grid, its squared-exponential eigenbasis, the
priors), and runs in any floating type: float64 for the check that decides
``correct``, float32 with TF32 products for its control. Each block is
written as the model defines it, one chain block of at most
``CHAIN_BLOCK`` chains at a time (the chains are independent).

Block by block (the sampler's order, models/gibbs.py of the program):

  theta | f*, beta, t  : Gumbel-max over the grid of the summed
                         log-likelihood table plus the N(0, 1) log prior
  z | theta, f, beta, t: inverse-CDF draw of the truncated normal
  f* | z               : f* = u* + U (U_t^T U_t + I)^-1 U_t^T (z - mu - u_t - e),
                         u* = U [z_q; z_p] + sqrt(jitter) z_n, U = [U_se, Psi]
  beta | z - f         : the Gaussian regression in the standardized
                         basis [1, u, u^2], u = (theta - c) / s
  t | f, mu            : ESS of t_1 (binary) or of the deltas (ordinal)
  ll                   : the summed ordinal-probit log-likelihood

The numbers the check compares, each the widest over the chains:

  theta_gap   how far below the reference's best perturbed logit the
              program's grid index lies (0 where they agree; a near-tie
              reads at rounding level)
  beta_gap    |beta - beta_ref| / (1 + |beta_ref|), the widest
  beta_gap_median   the same, its median over chains, items and
              coefficients
  cut_gap     the cutpoint slice update's log-likelihood margin where the
              program's cutpoints part from the reference's (0 where they
              agree, :func:`ess`)
  ll_gap      |ll - ll_ref| / |ll_ref| of the sweep's log-likelihood trace
  ll_gap_median   the same, its median over chains
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

LO, HI = -5.0, 5.0
FLOOR = 1e-6  # inside every log-probability
TWO_PI = 6.283185307179586
SQRT2 = math.sqrt(2.0)
EIGEN_RANK = 32  # columns of the squared-exponential eigenbasis
CHAIN_BLOCK = 64


NUMBERS = ("theta_gap", "beta_gap", "beta_gap_median", "cut_gap", "ll_gap", "ll_gap_median")
STATE = ("theta_idx", "beta", "thresholds", "fstar")  # the program's state a sweep starts from

# the program's settings this sweep is the reference of (GPIRTConfig's
# fields and properties, read by name)
SETTINGS = {"horizon": 1, "resolved_f_method": "conjugate", "theta_method": "grid",
            "resolved_threshold_method": "ess", "mix_subsweeps": 1, "affine_rounds": 0,
            "affine_shift_max": 0, "threshold_shift": False, "constant_IRF": False,
            "mean_degree": 2}


def follows(config) -> None:
    """Raise ValueError unless the program's configuration runs this sweep."""
    other = {k: getattr(config, k) for k, v in SETTINGS.items() if getattr(config, k) != v}
    if other:
        raise ValueError(f"the reference conjugate_grid does not follow {other}")


def snapshot(state) -> Dict[str, torch.Tensor]:
    """The program's state a sweep starts from, session 0, on the host."""
    return {n: getattr(state, n)[:, 0].cpu() for n in STATE}


def draws(gen: torch.Generator, model: dict, K: int, n: int, m: int, C: int,
          dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """One sweep's numbers for K chains from ``gen``, advancing it as the
    program's draw advances it (``models/gibbs.py``'s ``sweep_draws``: one
    session, theta on the grid, the conjugate f*, one latent pass, the
    cutpoint ESS; every tensor in the working type on the generator's
    device): u_theta (K, n, N), u_z (K, n, m), z_q (K, q, m), z_p (K, 3,
    m), z_n (K, N, m), eps_f (K, n, m), zeta (K, m, 3), nu (K, m, C-1),
    logu, eps0 (K, m), rs (rounds, K, m).

    This order is part of what the benchmark holds the program to: a
    program that draws its numbers otherwise cannot be followed, and its
    runs read as not correct."""
    dev, N, q = gen.device, model["grid_size"], EIGEN_RANK

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev, dtype=dtype)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    d = {"u_theta": rand(K, n, N),
         "u_z": rand(K, 1, n, m)[:, 0],
         "z_q": randn(K, 1, q, m)[:, 0],
         "z_p": randn(K, 1, 3, m)[:, 0],
         "z_n": randn(K, 1, N, m)[:, 0],
         "eps_f": randn(K, 1, n, m)[:, 0],
         "zeta": randn(K, 1, m, 3)[:, 0],
         "nu": randn(K, 1, m, C - 1)[:, 0]}
    d["logu"] = torch.log(rand(K, 1, m))[:, 0]
    d["eps0"] = (rand(K, 1, m) * TWO_PI)[:, 0]
    d["rs"] = rand(model["ess_max_rounds"], K, 1, m)[:, :, 0]
    return d


class Constants(NamedTuple):
    grid: torch.Tensor  # (N,)
    Xstar: torch.Tensor  # (N, 3) [1, g, g^2]
    U_grid: torch.Tensor  # (N, q + 3) [U_se, Psi]
    beta_sds: torch.Tensor  # (3, m)
    jitter: float


def constants(model: dict, m: int, device, dtype) -> Constants:
    """The grid and its bases from the configuration, in float64 on the
    host, then in ``dtype`` on ``device``: K(a, b) = exp(-(a - b)^2 / 2) +
    Psi(a) Psi(b)^T with Psi = [1, t, t^2] sd0 of the beta prior, the
    squared-exponential part by its leading eigenvectors."""
    N = model["grid_size"]
    grid = np.linspace(LO, HI, N)
    sds = np.full((3, m), float(model["beta_prior_sd"]))
    Xstar = np.stack([np.ones(N), grid, grid ** 2], axis=1)
    d = grid[:, None] - grid[None, :]
    ew, ev = np.linalg.eigh(np.exp(-0.5 * d * d))
    q = min(EIGEN_RANK, N)
    ew, ev = ew[::-1][:q], ev[:, ::-1][:, :q]
    U_se = ev * np.sqrt(np.maximum(ew, 0.0))[None, :]
    U_grid = np.concatenate([U_se, Xstar * sds[:, 0][None, :]], axis=1)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return Constants(t(grid), t(Xstar), t(U_grid), t(sds), float(model["jitter"]))


def phi(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(x / SQRT2))


def category_logprobs(g: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """log(P(y = c | g) + 1e-6) for c = 1..C: g (..., m), thr (..., m, C+1)
    -> (..., m, C)."""
    cdf = phi(thr[..., 1:-1] - g.unsqueeze(-1))
    pad = torch.zeros(cdf.shape[:-1] + (1,), dtype=g.dtype, device=g.device)
    cdf = torch.cat([pad, cdf, pad + 1.0], dim=-1)
    return torch.log(cdf[..., 1:] - cdf[..., :-1] + FLOOR)


def onehot(y: torch.Tensor, C: int, dtype) -> torch.Tensor:
    """(n, m) categories, 0 missing -> (n, m, C); a missing cell all 0."""
    return (y.unsqueeze(-1) == torch.arange(1, C + 1, device=y.device)).to(dtype)


def rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a (K, N, m) at grid rows idx (K, n) -> (K, n, m)."""
    return torch.take_along_dim(a, idx.unsqueeze(-1), dim=-2)


def design(theta: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.ones_like(theta), theta, theta * theta], dim=-1)


def draw_theta(fstar, beta, thr, oh, u, k: Constants):
    """Grid indices (K, n): argmax over the grid of the table, the log prior
    and Gumbel noise -log(-log u); also those perturbed logits (K, n, N)."""
    K, N, m = fstar.shape
    gstar = fstar + k.Xstar @ beta  # (K, N, m)
    logp = category_logprobs(gstar, thr.unsqueeze(1))  # (K, N, m, C)
    n = oh.shape[0]
    table = logp.reshape(K, N, -1) @ oh.reshape(n, -1).T  # (K, N, n)
    logits = table.mT - 0.5 * torch.square(k.grid) - torch.log(-torch.log(u))  # prior N(0, 1)
    return torch.argmax(logits, dim=-1), logits


def draw_z(g, y, thr, u) -> torch.Tensor:
    """z ~ N(g, 1) truncated to (t_{y-1}, t_y), free where y is missing;
    probability clamped to [1e-6, 1 - 1e-6], and an interval under 1e-6 of
    mass takes g clamped into it."""
    K, n, m = g.shape
    obs = (y > 0).unsqueeze(0)
    yc = y.clamp(min=1).long().unsqueeze(0).unsqueeze(-1).expand(K, n, m, 1)
    t = thr.unsqueeze(1).expand(K, n, m, thr.shape[-1])
    inf = torch.full_like(g, math.inf)
    hi = torch.where(obs, torch.gather(t, -1, yc)[..., 0], inf)
    lo = torch.where(obs, torch.gather(t, -1, yc - 1)[..., 0], -inf)
    c_lo, c_hi = phi(lo - g), phi(hi - g)
    p = torch.clamp(c_lo + u * (c_hi - c_lo), FLOOR, 1.0 - FLOOR)
    z = g + SQRT2 * torch.erfinv(2.0 * p - 1.0)
    inside = torch.clamp(g, torch.where(torch.isfinite(lo), lo, g),
                         torch.where(torch.isfinite(hi), hi, g))
    return torch.where(c_hi - c_lo < FLOOR, inside, z)


def draw_fstar(theta_idx, resid_z, d, k: Constants):
    """f* (K, N, m) given the latents, and f (K, n, m) its rows at theta:
    resid_z is z - mu."""
    zc = torch.cat([d["z_q"], d["z_p"]], dim=-2)  # (K, q+3, m)
    U = k.U_grid[theta_idx]  # (K, n, q+3)
    sj = math.sqrt(k.jitter)
    u_sites = U @ zc + sj * rows(d["z_n"], theta_idx)
    resid = resid_z - u_sites - d["eps_f"]
    eye = torch.eye(U.shape[-1], dtype=U.dtype, device=U.device)
    a = torch.linalg.solve(U.mT @ U + eye, U.mT @ resid)
    fstar = k.U_grid @ (zc + a) + sj * d["z_n"]
    return fstar, rows(fstar, theta_idx)


def draw_beta(theta, z_minus_f, zeta, k: Constants) -> torch.Tensor:
    """beta (K, 3, m): prior N(0, sd^2) on each coefficient, noise variance
    1, drawn in the basis [1, u, u^2], u = (theta - c) / s, c the mean and s
    the population sd of theta plus 1e-3, and mapped back."""
    c = theta.mean(dim=-1)
    s = theta.std(dim=-1, correction=0) + 1e-3
    X = design((theta - c.unsqueeze(-1)) / s.unsqueeze(-1))  # (K, n, 3)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    Minv = torch.stack([torch.stack([one, -c / s, c * c / (s * s)], -1),
                        torch.stack([zero, 1.0 / s, -2.0 * c / (s * s)], -1),
                        torch.stack([zero, zero, 1.0 / (s * s)], -1)], -2)  # beta = Minv gamma
    d_inv = 1.0 / (torch.square(k.beta_sds) + 1e-6)  # (3, m)
    prior = torch.einsum("kpq,pm,kpr->kmqr", Minv, d_inv, Minv)
    prec = (X.mT @ X).unsqueeze(1) + prior  # (K, m, 3, 3)
    L = torch.linalg.cholesky(prec)
    mean = torch.cholesky_solve((X.mT @ z_minus_f).mT.unsqueeze(-1), L)
    samp = torch.linalg.solve_triangular(L.mT, zeta.unsqueeze(-1), upper=True)
    return (Minv.unsqueeze(1) @ (mean + samp))[..., 0].mT


def ess(x, nu, loglik, logu, eps0, rs, target=None):
    """One elliptical slice update of every lane (Murray, Adams and MacKay
    2010), all lanes in lockstep, each frozen at its accept; a lane still
    shrinking after the R rounds of ``rs`` keeps x. x, nu (..., d); logu,
    eps0 (...); rs (R, ...). Returns (x_new, proposals to the accept per
    lane (R at the cap), the mask of lanes at the cap, margins).

    ``target`` (..., d), another implementation's x_new from the same
    numbers, gives each lane's margin: 0 where it took the same proposal;
    else, at the first round where the two part, how far this update's
    log-likelihood lay from the slice level there (the other took a
    proposal this one rejected, or rejected the one this one took). A
    rounding-level margin is a near-tie; inf where the target is none of
    this lane's proposals and this lane never accepted."""
    log_y = loglik(x) + logu
    eps, eps_min = eps0, eps0 - TWO_PI
    eps_max = torch.full_like(eps0, TWO_PI)
    out = x
    rounds = torch.full(logu.shape, rs.shape[0], dtype=torch.int64, device=x.device)
    active = torch.ones_like(logu, dtype=torch.bool)
    margin = torch.full_like(logu, math.inf)
    open_ = torch.ones_like(active)  # lanes whose margin is still to find

    def near(a):  # target is proposal a, to rounding
        return ((target - a).abs() <= 1e-4 * (1.0 + a.abs())).all(dim=-1)

    for r in range(rs.shape[0]):
        if not bool(active.any()):
            break
        prop = x * torch.cos(eps).unsqueeze(-1) + nu * torch.sin(eps).unsqueeze(-1)
        slack = loglik(prop) - log_y
        accept = active & (slack > 0)
        if target is not None:
            same = near(prop)
            took_other = open_ & active & ~accept & same  # taken there, rejected here
            margin = torch.where(took_other, -slack, margin)
            agree = open_ & accept & same
            margin = torch.where(agree, torch.zeros_like(margin), margin)
            left = open_ & accept & ~same  # rejected there, taken here
            margin = torch.where(left, slack, margin)
            open_ = open_ & ~(took_other | accept)
        out = torch.where(accept.unsqueeze(-1), prop, out)
        rounds = torch.where(accept, r + 1, rounds)
        still = active & ~accept
        eps_min = torch.where(still & (eps < 0), eps, eps_min)
        eps_max = torch.where(still & (eps >= 0), eps, eps_max)
        eps = torch.where(still, eps_min + rs[r] * (eps_max - eps_min), eps)
        active = still
    if target is not None:  # capped here, kept x: agreeing if the target did
        margin = torch.where(open_ & near(x), torch.zeros_like(margin), margin)
    return out, rounds, active, margin


def to_thresholds(d: torch.Tensor) -> torch.Tensor:
    """Deltas (..., C-1) -> cutpoints (..., C+1): t_1 = d_0, t_{c+1} = t_c +
    exp(d_c), t_0 = -inf, t_C = inf."""
    finite = d[..., :1]
    if d.shape[-1] > 1:
        finite = torch.cat([finite, finite + torch.cumsum(torch.exp(d[..., 1:]), -1)], -1)
    inf = torch.full_like(d[..., :1], math.inf)
    return torch.cat([-inf, finite, inf], dim=-1)


def to_deltas(thr: torch.Tensor) -> torch.Tensor:
    t = thr[..., 1:-1]
    return torch.cat([t[..., :1], torch.log(t[..., 1:] - t[..., :-1])], dim=-1)


def draw_cutpoints(thr, g, y, oh, d, target=None):
    """The y-marginal ESS of each (chain, item) lane's cutpoints, identity
    prior on the deltas. Binary: t_1 alone, its site term log(Phi(s (t_1 -
    g)) + 1e-6), s = 1 for y = 1 and -1 for y = 2. Returns (thr (K, m,
    C+1), rounds (K, m), capped (K, m), margins (K, m) against the
    ``target`` cutpoints, :func:`ess`)."""
    C = thr.shape[-1] - 1
    if C == 2:
        obs = (y > 0).to(g.dtype)
        sgn = torch.where(y == 1, 1.0, -1.0).to(g.dtype) * obs

        def loglik(t):  # (K, m, 1) -> (K, m)
            return (torch.log(phi(sgn * (t.mT - g)) + FLOOR) * obs).sum(dim=-2)
    else:
        def loglik(delta):  # (K, m, C-1) -> (K, m)
            logp = category_logprobs(g, to_thresholds(delta).unsqueeze(1))  # (K, n, m, C)
            return (logp * oh).sum(dim=(-3, -1))
    new, rounds, capped, margin = ess(to_deltas(thr), d["nu"], loglik, d["logu"], d["eps0"],
                                      d["rs"], None if target is None else to_deltas(target))
    return to_thresholds(new), rounds, capped, margin


def loglik_total(g, y, thr) -> torch.Tensor:
    """(K,) summed log(P(y | g) + 1e-6) over the observed cells."""
    logp = category_logprobs(g, thr.unsqueeze(1))  # (K, n, m, C)
    yc = (y.clamp(min=1).long() - 1).unsqueeze(0).unsqueeze(-1).expand(g.shape + (1,))
    terms = torch.gather(logp, -1, yc)[..., 0]
    return torch.where((y > 0).unsqueeze(0), terms, torch.zeros_like(terms)).sum(dim=(-2, -1))


class Output(NamedTuple):
    theta_idx: torch.Tensor  # (K, n)
    beta: torch.Tensor  # (K, 3, m)
    thresholds: torch.Tensor  # (K, m, C+1)
    ll: torch.Tensor  # (K,)
    rounds: torch.Tensor  # (K, m) cutpoint ESS proposals a lane
    capped: torch.Tensor  # (K, m)
    theta_gap: torch.Tensor  # (K, n) perturbed logit below the best at the given theta
    cut_gap: torch.Tensor  # (K, m) slice margin where the given cutpoints part


def sweep_block(state: Dict[str, torch.Tensor], d: Dict[str, torch.Tensor], y, oh,
                k: Constants, given: Optional[Dict[str, torch.Tensor]] = None):
    """One sweep of a block of chains. ``state``: theta_idx (K, n), beta
    (K, 3, m), thresholds (K, m, C+1), fstar (K, N, m); ``d`` the sweep's
    numbers. ``given`` holds an implementation's theta_idx, beta and
    thresholds of this sweep: each block after a draw then takes those in
    place of its own draw, so that one near-tie in a discrete choice does
    not carry into the blocks after it. Returns (Output, next state), the
    next state built from the values the later blocks took."""
    theta_own, logits = draw_theta(state["fstar"], state["beta"], state["thresholds"], oh,
                                   d["u_theta"], k)
    theta_idx = theta_own if given is None else given["theta_idx"]
    theta_gap = logits.amax(-1) - torch.take_along_dim(logits, theta_idx.unsqueeze(-1),
                                                       -1)[..., 0]
    del logits
    theta = k.grid[theta_idx]
    X = design(theta)
    mu = X @ state["beta"]
    z = draw_z(rows(state["fstar"], theta_idx) + mu, y, state["thresholds"], d["u_z"])
    fstar, f = draw_fstar(theta_idx, z - mu, d, k)
    beta_own = draw_beta(theta, z - f, d["zeta"], k)
    beta = beta_own if given is None else given["beta"]
    g = f + X @ beta
    thr_own, rounds, capped, cut_gap = draw_cutpoints(
        state["thresholds"], g, y, oh, d, None if given is None else given["thresholds"])
    thr = thr_own if given is None else given["thresholds"]
    ll = loglik_total(g, y, thr)
    nxt = {"theta_idx": theta_idx, "beta": beta, "thresholds": thr, "fstar": fstar}
    return Output(theta_own, beta_own, thr_own, ll, rounds, capped, theta_gap, cut_gap), nxt


def sweep(state, d, y, C: int, k: Constants, given=None):
    """:func:`sweep_block` over blocks of at most ``CHAIN_BLOCK`` chains;
    tensors on k's device and in its type (theta_idx int64)."""
    K = state["theta_idx"].shape[0]
    oh = onehot(y, C, k.grid.dtype)
    outs, nxts = [], []
    for lo in range(0, K, CHAIN_BLOCK):
        sl = slice(lo, min(lo + CHAIN_BLOCK, K))
        def part(src):  # the block's chains, in k's type; the shrink table's rounds lead
            if src is None:
                return None
            out = {n: v[:, sl] if n == "rs" else v[sl] for n, v in src.items()}
            return {n: v.to(k.grid.dtype) if v.is_floating_point() else v
                    for n, v in out.items()}

        o, nx = sweep_block(part(state), part(d), y, oh, k, part(given))
        outs.append(o)
        nxts.append(nx)
    out = Output(*(torch.cat(list(a)) for a in zip(*outs)))
    return out, {n: torch.cat([nx[n] for nx in nxts]) for n in nxts[0]}


def given_of(rec: Dict[str, np.ndarray], model: dict) -> Dict[str, torch.Tensor]:
    """The program's draws of one sweep as the host received them (its
    record: theta (K, 1, n), beta (K, 1, 3, m), threshold (K, 1, m, C+1),
    ll (K,)), theta as grid indices."""
    step = (HI - LO) / (model["grid_size"] - 1)
    return {"theta_idx": torch.as_tensor(np.rint((rec["theta"][:, 0] - LO) / step)).long(),
            "beta": torch.as_tensor(rec["beta"][:, 0]),
            "thresholds": torch.as_tensor(rec["threshold"][:, 0]),
            "ll": torch.as_tensor(rec["ll"])}


def as_given(out: Output) -> Dict[str, torch.Tensor]:
    """A sweep's own draws (the control's) in :func:`given_of`'s form."""
    return {"theta_idx": out.theta_idx.cpu(), "beta": out.beta.cpu(),
            "thresholds": out.thresholds.cpu(), "ll": out.ll.cpu()}


def numbers(out: Output, given: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The compared numbers of a sweep: the reference's ``out``, run with
    ``given`` taken in its later blocks, against ``given``."""
    beta, ll = given["beta"].to(out.beta), given["ll"].to(out.ll)
    rel = (beta - out.beta).abs() / (1.0 + out.beta.abs())
    rel_ll = (ll - out.ll).abs() / out.ll.abs()
    return {"theta_gap": float(out.theta_gap.max()),
            "beta_gap": float(rel.max()), "beta_gap_median": float(rel.median()),
            "cut_gap": float(out.cut_gap.max()),
            "ll_gap": float(rel_ll.max()), "ll_gap_median": float(rel_ll.median())}


def _shift_theta(given):
    """Chain 0's theta one grid point up (down at the top)."""
    idx = given["theta_idx"].clone()
    idx[0] = torch.where(idx[0] < idx.max(), idx[0] + 1, idx[0] - 1)
    return dict(given, theta_idx=idx)


def _shift_cutpoints(given):
    """Chain 0's finite cutpoints 0.01 up."""
    thr = given["thresholds"].clone()
    thr[0, :, 1:-1] += 0.01
    return dict(given, thresholds=thr)


def _scale_ll(given):
    """Chain 0's log-likelihood 1e-3 of itself off."""
    ll = given["ll"].clone()
    ll[0] *= 1.0 + 1e-3
    return dict(given, ll=ll)


# answers altered where they are produced, planted in the program's draws
# as the host received them: each has to break a limit
PLANTED = {"theta_shift": _shift_theta, "cutpoint_shift": _shift_cutpoints,
           "ll_scaled": _scale_ll}
