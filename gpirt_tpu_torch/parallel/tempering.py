"""Parallel tempering of the chain ensemble on one device.

Counterpart of ``gpirt_tpu/parallel/tempering.py`` without a mesh. Each of G
cold chains is backed by L - 1 hot lanes on a geometric temperature ladder
up to ``max_temp``; the G L lanes, group-major, advance in lockstep as the
chain axis of one sweep, lane l of every group at temperature temps[l] for
the whole run (states swap, temperatures do not). The tempering family is
observation noise sd sqrt(T), which keeps every conjugate block exactly
Gaussian, so a sweep is ``gibbs_sweep`` with a (G L,) tensor of
temperatures, and the cutpoint kernel takes one scale a lane's chain.

After each sweep (every ``swap_every`` sweeps) adjacent rungs of each
group propose to swap states, even pairs on even phases and odd pairs on
odd ones, accepted with probability
    min(1, exp(l_Ta(S_b) + l_Tb(S_a) - l_Ta(S_a) - l_Tb(S_b)))
in the tempered data log-likelihoods l_T (the priors do not depend on T).
The stored draws are the cold lanes (l = 0 of each group).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gpirt_tpu_torch.models.config import GPIRTConfig, GPIRTConstants
from gpirt_tpu_torch.models.gibbs import (
    GPIRTState,
    gibbs_sweep,
    init_draws,
    init_state,
    stored_fstar,
    sweep_draws,
    theta_from_indices,
)
from gpirt_tpu_torch.models.sampler import sample_schedule
from gpirt_tpu_torch.parallel.smc import _lane_ll, _take

__all__ = ["temperature_ladder", "run_tempered_chains"]


def temperature_ladder(n_temps: int, max_temp: float) -> np.ndarray:
    """Geometric ladder 1 = T_0 < ... < T_{L-1} = max_temp."""
    if n_temps < 2:
        return np.ones(max(n_temps, 1))
    return max_temp ** (np.arange(n_temps) / (n_temps - 1))


def _swap(states: GPIRTState, ll_own, temps, u, phase: int, L: int, y,
          consts: GPIRTConstants):
    """One even/odd adjacent-pair swap phase (parity = phase % 2) over the
    G L lanes (``gpirt_tpu/parallel/tempering.py:96``).

    ``ll_own`` (K,) is each lane's data ll at its own temperature, of the
    current state; ``u`` (K,) the phase's uniforms, pair (a, a + 1) taking
    u[a]. Returns (states after the swap, their own-temperature ll, the
    accepted pairs marked at their lower lane)."""
    K = ll_own.shape[0]
    lane = torch.arange(K, device=ll_own.device)
    l = lane % L
    partner_l = l + 1 - 2 * ((l - phase % 2) % 2)
    valid = (partner_l >= 0) & (partner_l < L)
    partner = torch.where(valid, lane + (partner_l - l), lane)
    ll_cross = _lane_ll(states, temps[partner], y, consts)  # l_{T_partner}(S_lane)
    delta = (ll_cross + ll_cross[partner]) - (ll_own + ll_own[partner])
    accept = valid & (torch.log(u[torch.minimum(lane, partner)]) < delta)
    swapped = _take(states, torch.where(accept, partner, lane))
    # lane k now holds S_partner(k), whose ll at T_k is ll_cross[partner(k)]
    ll_post = torch.where(accept, ll_cross[partner], ll_own)
    return swapped, ll_post, accept & (partner > lane)


def _tempered_sweep(states: GPIRTState, draws, u, i: int, temps, swap_every: int,
                    L: int, y, consts: GPIRTConstants, config: GPIRTConfig):
    """One lockstep tempered sweep of every lane, sweep ``i`` (its
    iteration), then its swap phase when ``i % swap_every == 0`` (``u`` its
    uniforms, None otherwise). Returns (states, ll (K,), accepted pairs (K,))."""
    states, ll = gibbs_sweep(states, draws, y, consts, config, temps, i)
    if u is None:
        return states, ll, torch.zeros_like(ll, dtype=torch.bool)
    return _swap(states, ll, temps, u, i // swap_every, L, y, consts)


def _cold_record(states: GPIRTState, ll, L: int, consts: GPIRTConstants,
                 config: GPIRTConfig, store_f: bool,
                 store_fstar: bool) -> Dict[str, torch.Tensor]:
    """The cold lanes' (l = 0) record of one draw: (G, ...) each; f* as
    :func:`stored_fstar` stores it (``gpirt_tpu/parallel/tempering.py:193``)."""
    cold = GPIRTState(*(a[::L] for a in states))
    out = {
        "theta": theta_from_indices(cold.theta_idx, consts),
        "beta": cold.beta,
        "threshold": cold.thresholds,
        "ll": ll[::L],
    }
    if store_f:
        out["f"] = cold.f
    if store_fstar:
        out["fstar"] = stored_fstar(cold.fstar, cold.beta, consts, config)
    return out


def run_tempered_chains(
    gen: torch.Generator,
    y: torch.Tensor,
    theta_init: torch.Tensor,
    thresholds_init: torch.Tensor,
    consts: GPIRTConstants,
    config: GPIRTConfig,
    *,
    sample_iterations: int,
    burn_iterations: int,
    thin: int = 1,
    n_temps: int = 4,
    max_temp: float = 32.0,
    swap_every: int = 1,
    store_f: bool = False,
    store_fstar: bool = False,
) -> Dict[str, torch.Tensor]:
    """A tempered ensemble run; returns the cold chains' draws in
    :func:`~gpirt_tpu_torch.models.sampler.run_chains`'s layout, (G, S, ...)
    on the device, plus "swap_rate" (L - 1,), the mean acceptance of the
    adjacent swaps by rung.

    ``theta_init`` (G, H, n) fixes the G groups; each group's L lanes start
    from its init. All randomness comes from ``gen``: the lanes' init, each
    sweep's draws, and each swap phase's (G L,) uniforms. With
    ``n_temps = 1`` no swap is proposed and the run draws what
    ``run_chains`` draws. A draw is recorded as ``run_chains`` records it;
    after the last one no further sweep runs.
    """
    if config.resolved_f_method != "conjugate":
        raise NotImplementedError("parallel tempering needs f_method='conjugate'")
    G, L = theta_init.shape[0], int(n_temps)
    K = G * L
    dt, dev = config.tdtype, consts.grid.device
    temps = torch.as_tensor(np.tile(temperature_ladder(L, max_temp), G), dtype=dt,
                            device=dev)
    sched = sample_schedule(sample_iterations, burn_iterations, thin)
    states = init_state(theta_init.repeat_interleave(L, dim=0), thresholds_init,
                        consts, config, init_draws(gen, K, consts, config))
    accepted = torch.zeros(K, dtype=torch.int64, device=dev)
    sweeps = 0

    def sweep(states):
        nonlocal accepted, sweeps
        draws = sweep_draws(gen, K, consts, config, sweeps)
        u = None
        if L > 1 and swap_every > 0 and sweeps % swap_every == 0:
            u = torch.rand(K, generator=gen, device=dev, dtype=dt)
        states, ll, acc = _tempered_sweep(states, draws, u, sweeps, temps, swap_every,
                                          L, y, consts, config)
        accepted = accepted + acc
        sweeps += 1
        return states, ll

    for _ in range(sched.pre_iterations):
        states, _ = sweep(states)
    S = sched.n_samples
    records: Dict[str, torch.Tensor] = {}
    for s in range(S):
        states, ll = sweep(states)
        for k, v in _cold_record(states, ll, L, consts, config, store_f,
                                         store_fstar).items():
            if k not in records:
                records[k] = torch.empty((S,) + tuple(v.shape), dtype=v.dtype, device=dev)
            records[k][s] = v
        if s < S - 1:
            for _ in range(thin - 1):
                states, _ = sweep(states)
    out = {k: v.transpose(0, 1) for k, v in records.items()}
    # rung l's pair is proposed on every phase of parity l % 2: half the phases
    per_lane = accepted.reshape(G, L).double().mean(dim=0).cpu().numpy()
    n_phases = max(sweeps // max(swap_every, 1), 1)
    rung = per_lane[: max(L - 1, 1)] / max(n_phases / 2.0, 1.0)
    out["swap_rate"] = torch.as_tensor(np.clip(rung, 0.0, 1.0), device=dev)
    return out
