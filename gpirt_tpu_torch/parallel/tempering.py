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
    sweep_draws,
)
from gpirt_tpu_torch.models.sampler import (
    Carry,
    SampleSchedule,
    advance,
    draw_record,
    run_length,
    sample_schedule,
)
from gpirt_tpu_torch.parallel.smc import _lane_ll, _take

__all__ = [
    "temperature_ladder",
    "lane_temperatures",
    "tempered_lanes",
    "advance_tempered",
    "swap_rate",
    "run_tempered_chains",
]


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


def lane_temperatures(G: int, n_temps: int, max_temp: float,
                      consts: GPIRTConstants, config: GPIRTConfig) -> torch.Tensor:
    """(G L,) temperatures, group-major: lane l of every group at the
    ladder's temps[l]."""
    return torch.as_tensor(np.tile(temperature_ladder(int(n_temps), max_temp), G),
                           dtype=config.tdtype, device=consts.grid.device)


def tempered_lanes(gen: torch.Generator, theta_init: torch.Tensor,
                   thresholds_init: torch.Tensor, consts: GPIRTConstants,
                   config: GPIRTConfig, n_temps: int) -> GPIRTState:
    """The G L lanes' initial states, each group's L lanes from its init
    (``theta_init`` (G, H, n)), their draws from ``gen``."""
    if config.resolved_f_method != "conjugate":
        raise NotImplementedError("parallel tempering needs f_method='conjugate'")
    K = theta_init.shape[0] * int(n_temps)
    return init_state(theta_init.repeat_interleave(int(n_temps), dim=0), thresholds_init,
                      consts, config, init_draws(gen, K, consts, config))


def advance_tempered(gen: torch.Generator, carry: Carry, accepted: torch.Tensor,
                     y: torch.Tensor, consts: GPIRTConstants, config: GPIRTConfig,
                     temps: torch.Tensor, n_temps: int, swap_every: int,
                     sched: SampleSchedule, start: int, stop: int, *,
                     store_f: bool = False, store_fstar: bool = False):
    """The tempered sweeps ``[start, stop)`` of the G L lanes in ``carry``
    (:func:`~gpirt_tpu_torch.models.sampler.advance`): sweep ``it`` draws
    its numbers, then its swap phase's (G L,) uniforms when ``it %
    swap_every == 0``, from ``gen``. ``accepted`` (G L,) int64 tallies the
    accepted swaps at each pair's lower lane. Returns (accepted, the cold
    lanes' stored draws {name: (G, s, ...)})."""
    K, L = accepted.shape[0], int(n_temps)
    dt = config.tdtype

    def sweep(states, it):
        nonlocal accepted
        draws = sweep_draws(gen, K, consts, config, it)
        u = None
        if L > 1 and swap_every > 0 and it % swap_every == 0:
            u = torch.rand(K, generator=gen, device=accepted.device, dtype=dt)
        states, ll, a = _tempered_sweep(states, draws, u, it, temps, swap_every, L, y,
                                        consts, config)
        accepted = accepted + a
        return states, ll

    def record(states, ll):
        cold = GPIRTState(*(a[::L] for a in states))
        return draw_record(cold, ll[::L], consts, config, store_f, store_fstar)

    out = advance(sweep, record, carry, sched, start, stop)
    return accepted, out


def swap_rate(accepted, n_temps: int, sweeps: int, swap_every: int) -> np.ndarray:
    """(L - 1,) mean acceptance of the adjacent swaps by rung from the
    (G L,) tally after ``sweeps`` sweeps: rung l's pair is proposed on every
    phase of parity l % 2, half the phases."""
    L = int(n_temps)
    acc = np.asarray(accepted, np.float64)
    per_lane = acc.reshape(-1, L).mean(axis=0)
    n_phases = max(sweeps // max(swap_every, 1), 1)
    rung = per_lane[: max(L - 1, 1)] / max(n_phases / 2.0, 1.0)
    return np.clip(rung, 0.0, 1.0)


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
    carry = Carry(tempered_lanes(gen, theta_init, thresholds_init, consts, config,
                                 n_temps))
    temps = lane_temperatures(theta_init.shape[0], n_temps, max_temp, consts, config)
    sched = sample_schedule(sample_iterations, burn_iterations, thin)
    sweeps = run_length(sched, trailing=False)
    accepted = torch.zeros(temps.shape[0], dtype=torch.int64, device=temps.device)
    accepted, out = advance_tempered(gen, carry, accepted, y, consts, config, temps,
                                     n_temps, swap_every, sched, 0, sweeps,
                                     store_f=store_f, store_fstar=store_fstar)
    out["swap_rate"] = torch.as_tensor(
        swap_rate(accepted.cpu().numpy(), n_temps, sweeps, swap_every),
        device=temps.device)
    return out
