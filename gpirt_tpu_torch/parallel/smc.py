"""SMC annealed initialization on one device.

Counterpart of ``gpirt_tpu/parallel/smc.py::anneal_init`` without a mesh:
the K-chain ensemble starts hot (observation noise sd sqrt(T_max)), runs a
warm prologue of tempered sweeps at T_max, then anneals down a geometric
ladder to T = 1. Each step reweights the lanes by the tempered-likelihood
ratio, resamples systematically when the weight ESS drops below
``ess_threshold * K``, and mutates with one tempered Gibbs sweep (Del Moral,
Doucet & Jasra 2006). A final systematic resample returns an equally
weighted ensemble at T = 1.
"""

from __future__ import annotations

import math

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

__all__ = ["anneal_init", "annealing_schedule", "WARM_STEPS"]

WARM_STEPS = 8


def annealing_schedule(n_steps: int, max_temp: float) -> np.ndarray:
    """Geometric T_max -> 1 over n_steps (first entry T_max, last 1.0)."""
    if n_steps < 2:
        return np.ones(max(n_steps, 1))
    return max_temp ** (1.0 - np.arange(n_steps) / (n_steps - 1))


def _lane_ll(states: GPIRTState, t: float, y, consts: GPIRTConstants):
    """Each lane's tempered log-likelihood at temperature t: (K,)."""
    theta = theta_from_indices(states.theta_idx, consts)
    g = states.f + compute_mu(theta, states.beta)
    return ordinal_ll_terms(g, y, states.thresholds,
                            1.0 / math.sqrt(t)).sum(dim=(-3, -2, -1))


def _systematic_src(w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Source lane of each of the K resampled lanes (searchsorted side left)."""
    K = w.shape[0]
    pos = (torch.arange(K, dtype=w.dtype, device=w.device) + u) / K
    return torch.clamp(torch.searchsorted(torch.cumsum(w, 0), pos), 0, K - 1)


def _take(states: GPIRTState, idx: torch.Tensor) -> GPIRTState:
    return GPIRTState(*(a[idx] for a in states))


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
    n_steps - 1 steps of ``sweeps_per_step`` tempered sweeps each. ``info``
    holds the annealing steps' weight-ESS trace, the resample count (the
    final resample included) and the final weight ESS.
    """
    if config.resolved_f_method != "conjugate":
        raise NotImplementedError("anneal_init needs f_method='conjugate'")
    K = theta_init.shape[0]
    dt, dev = config.tdtype, consts.grid.device
    # the ladder in the working precision, as the JAX package holds it
    temps = [float(t) for t in
             torch.as_tensor(annealing_schedule(n_steps, max_temp), dtype=dt)]
    states = init_state(theta_init, thresholds_init, consts, config,
                        init_draws(gen, K, consts, config))
    logw = torch.zeros(K, dtype=dt, device=dev)
    steps = [(temps[0], temps[0])] * WARM_STEPS + list(zip(temps[:-1], temps[1:]))
    ess_trace, resampled = [], []
    for t_prev, t_new in steps:
        if t_new != t_prev:  # the warm prologue's ratio is exactly 0
            logw = logw + _lane_ll(states, t_new, y, consts) \
                - _lane_ll(states, t_prev, y, consts)
        w = torch.exp(logw - torch.logsumexp(logw, 0))
        ess_w = float(1.0 / torch.sum(w * w))
        u = torch.rand((), generator=gen, device=dev, dtype=dt)
        do = ess_w < ess_threshold * K
        if do:
            states = _take(states, _systematic_src(w, u))
            logw = torch.zeros_like(logw)
        ess_trace.append(ess_w)
        resampled.append(do)
        for _ in range(sweeps_per_step):
            states, _ = gibbs_sweep(states, sweep_draws(gen, K, consts, config),
                                    y, consts, config, temp=t_new)
    w = torch.exp(logw - torch.logsumexp(logw, 0))
    u = torch.rand((), generator=gen, device=dev, dtype=dt)
    states = _take(states, _systematic_src(w, u))
    w_final = w.cpu().double().numpy()
    info = {
        "weight_ess": np.asarray(ess_trace[WARM_STEPS:]),
        "n_resamples": int(sum(resampled[WARM_STEPS:])) + 1,
        "final_weight_ess": float(1.0 / np.sum(w_final * w_final)),
    }
    return states, info
