"""SMC annealed initialization on one device, for one campaign of K chains
or a batch of B independent campaigns.

Counterpart of ``gpirt_tpu/parallel/smc.py::anneal_init`` and
``anneal_init_batched`` without a mesh: each K-chain ensemble starts hot
(observation noise sd sqrt(T_max)), runs a warm prologue of tempered
sweeps at T_max, then anneals down a geometric ladder to T = 1. Each step
reweights the lanes by the tempered-likelihood ratio, resamples
systematically when the weight ESS drops below ``ess_threshold * K``, and
mutates with one tempered Gibbs sweep (Del Moral, Doucet & Jasra 2006). A
final systematic resample returns an equally weighted ensemble at T = 1.

B campaigns advance as the B K lanes of one sweep at the step's shared
temperature; the weights, their ESS and the resampling stay campaign-local,
and each campaign's resample decision is taken on the device, so a step
never waits for the host. Campaign b draws every number from its own
generator, in the order a solo run draws them, so it equals a solo
``anneal_init`` fed the same draws.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from gpirt_tpu_torch.models.config import GPIRTConfig, GPIRTConstants
from gpirt_tpu_torch.models.gibbs import (
    GPIRTState,
    compute_mu,
    gibbs_sweep,
    init_draws,
    init_state,
    sweep_draws,
    theta_from_indices,
)
from gpirt_tpu_torch.ops.likelihood import ordinal_ll_terms

__all__ = ["anneal_init", "anneal_init_batched", "annealing_schedule", "WARM_STEPS"]

WARM_STEPS = 8


def annealing_schedule(n_steps: int, max_temp: float) -> np.ndarray:
    """Geometric T_max -> 1 over n_steps (first entry T_max, last 1.0)."""
    if n_steps < 2:
        return np.ones(max(n_steps, 1))
    return max_temp ** (1.0 - np.arange(n_steps) / (n_steps - 1))


def _lane_ll(states: GPIRTState, t, y, consts: GPIRTConstants):
    """Each lane's tempered log-likelihood: (K,). ``t`` is one temperature
    for every lane, or a (K,) tensor of one a lane."""
    theta = theta_from_indices(states.theta_idx, consts)
    g = states.f + compute_mu(theta, states.beta)
    if torch.is_tensor(t):
        inv_s = (1.0 / torch.sqrt(t)).reshape(-1, 1, 1, 1)
    else:
        inv_s = 1.0 / math.sqrt(t)
    return ordinal_ll_terms(g, y, states.thresholds, inv_s).sum(dim=(-3, -2, -1))


def _systematic_src(w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Source lane of each of the K resampled lanes of every campaign
    (searchsorted side left): w (B, K) weights, u (B,) uniforms -> (B, K)."""
    K = w.shape[-1]
    pos = (torch.arange(K, dtype=w.dtype, device=w.device) + u.unsqueeze(-1)) / K
    return torch.clamp(torch.searchsorted(torch.cumsum(w, -1), pos), 0, K - 1)


def _take(states: GPIRTState, idx: torch.Tensor) -> GPIRTState:
    return GPIRTState(*(a[idx] for a in states))


def _lane_axis(draws, field: str, passes: int = 1) -> int:
    """The axes before the lanes in a field of a draws tuple: a round or try
    axis (its ``_ROUND_FIELDS``), after the pass axis of a latent pass's
    field (its ``_PASS_FIELDS``) when there are several passes."""
    return (int(passes > 1 and field in getattr(draws, "_PASS_FIELDS", ()))
            + int(field in getattr(draws, "_ROUND_FIELDS", ())))


def _cat_lanes(per_campaign, passes: int = 1, lead: int = 0):
    """Draw tuples of B campaigns joined along each field's lane axis,
    campaign-major; ``passes`` is the config's mix_subsweeps and ``lead``
    the axes an enclosing field puts before the tuple's. A field that is
    None stays None."""
    first = per_campaign[0]
    if len(per_campaign) == 1:
        return first
    out = []
    for i, (name, f) in enumerate(zip(first._fields, first)):
        parts = [d[i] for d in per_campaign]
        axis = lead + _lane_axis(first, name, passes)
        if f is None:
            out.append(None)
        elif isinstance(f, tuple):
            out.append(_cat_lanes(parts, passes, axis))
        else:
            out.append(torch.cat(parts, dim=axis))
    return type(first)(*out)


def _weights(logw, gens, K, dev, dt):
    """Each campaign's normalized weights (B, K), their ESS (B,), and the
    (B, K) source lanes of a systematic resample, from one uniform a
    campaign drawn from its generator."""
    w = torch.exp(logw - torch.logsumexp(logw, -1, keepdim=True))
    ess_w = 1.0 / torch.sum(w * w, -1)
    u = torch.stack([torch.rand((), generator=g, device=dev, dtype=dt) for g in gens])
    offset = torch.arange(0, len(gens) * K, K, device=dev).unsqueeze(-1)
    src = _systematic_src(w, u) + offset
    return w, ess_w, src


def anneal_init_batched(
    gens: Sequence[torch.Generator],
    y: torch.Tensor,
    theta_init: torch.Tensor,
    thresholds_init: torch.Tensor,
    consts: GPIRTConstants,
    config: GPIRTConfig,
    *,
    n_steps: int = 128,
    max_temp: float = 64.0,
    sweeps_per_step: int = 1,
    ess_threshold: float = 0.5,
):
    """Anneal B independent K-chain campaigns from T = max_temp to T = 1 as
    the B K lanes of one sweep. Returns (states, info).

    ``gens`` holds one generator a campaign: campaign b's init, resample
    uniforms and sweep draws come from ``gens[b]``. ``theta_init`` (K, H, n)
    fixes K and is shared by the campaigns. Every ``states`` field has a
    leading (B, K); ``info`` holds the weight-ESS trace of the annealing
    steps (B, n_steps - 1), the resample counts (B,) (the final resample
    included) and the final weight ESS (B,), as numpy.
    """
    if config.resolved_f_method != "conjugate":
        raise NotImplementedError("anneal_init needs f_method='conjugate'")
    B, K = len(gens), theta_init.shape[0]
    dt, dev = config.tdtype, consts.grid.device
    # the ladder in the working precision, as the JAX package holds it
    temps = [float(t) for t in
             torch.as_tensor(annealing_schedule(n_steps, max_temp), dtype=dt)]
    states = init_state(theta_init.repeat(B, 1, 1), thresholds_init, consts, config,
                        _cat_lanes([init_draws(g, K, consts, config) for g in gens]))
    lanes = torch.arange(B * K, device=dev).reshape(B, K)
    logw = torch.zeros(B, K, dtype=dt, device=dev)
    # the JAX package's step ids, each step's sweeps' iteration: the warm
    # prologue's n_steps + 1.., then the annealing steps' 1..n_steps - 1
    ids = list(range(n_steps + 1, n_steps + 1 + WARM_STEPS)) + list(range(1, n_steps))
    steps = [(temps[0], temps[0])] * WARM_STEPS + list(zip(temps[:-1], temps[1:]))
    ess_trace, resampled = [], []
    for i, (t_prev, t_new) in zip(ids, steps):
        if t_new != t_prev:  # the warm prologue's ratio is exactly 0
            logw = logw + (_lane_ll(states, t_new, y, consts)
                           - _lane_ll(states, t_prev, y, consts)).reshape(B, K)
        _, ess_w, src = _weights(logw, gens, K, dev, dt)
        do = ess_w < ess_threshold * K  # (B,), decided on the device
        states = _take(states, torch.where(do.unsqueeze(-1), src, lanes).reshape(-1))
        logw = torch.where(do.unsqueeze(-1), torch.zeros_like(logw), logw)
        ess_trace.append(ess_w)
        resampled.append(do)
        for _ in range(sweeps_per_step):
            draws = _cat_lanes([sweep_draws(g, K, consts, config, i) for g in gens],
                               config.mix_subsweeps)
            states, _ = gibbs_sweep(states, draws, y, consts, config, t_new, i)
    w, _, src = _weights(logw, gens, K, dev, dt)
    states = _take(states, src.reshape(-1))
    w_final = w.cpu().double().numpy()
    info = {
        "weight_ess": torch.stack(ess_trace)[WARM_STEPS:].T.cpu().double().numpy(),
        "n_resamples": torch.stack(resampled)[WARM_STEPS:].sum(0).cpu().numpy() + 1,
        "final_weight_ess": 1.0 / np.sum(w_final * w_final, axis=-1),
    }
    return GPIRTState(*(a.reshape((B, K) + a.shape[1:]) for a in states)), info


def anneal_init(
    gen: torch.Generator,
    y: torch.Tensor,
    theta_init: torch.Tensor,
    thresholds_init: torch.Tensor,
    consts: GPIRTConstants,
    config: GPIRTConfig,
    *,
    n_steps: int = 128,
    max_temp: float = 64.0,
    sweeps_per_step: int = 1,
    ess_threshold: float = 0.5,
):
    """Anneal K chains from T = max_temp to T = 1. Returns (states, info).

    ``theta_init`` is (K, H, n) and fixes K. The run makes WARM_STEPS +
    n_steps - 1 steps of ``sweeps_per_step`` tempered sweeps each, all
    draws from ``gen``: one campaign of :func:`anneal_init_batched`.
    ``info`` holds the annealing steps' weight-ESS trace, the resample
    count (the final resample included) and the final weight ESS.
    """
    states, info = anneal_init_batched(
        [gen], y, theta_init, thresholds_init, consts, config, n_steps=n_steps,
        max_temp=max_temp, sweeps_per_step=sweeps_per_step,
        ess_threshold=ess_threshold)
    return GPIRTState(*(a[0] for a in states)), {
        "weight_ess": info["weight_ess"][0],
        "n_resamples": int(info["n_resamples"][0]),
        "final_weight_ess": float(info["final_weight_ess"][0]),
    }
