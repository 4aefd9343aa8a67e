"""Parallel tempering of the chain ensemble, on one device or over a mesh
of chains, items and respondents.

Counterpart of ``gpirt_tpu/parallel/tempering.py``. Each of G cold chains
is backed by L - 1 hot lanes on a geometric temperature ladder up to
``max_temp``; the G L lanes, group-major, advance in lockstep as the chain
axis of one sweep, lane l of every group at temperature temps[l] for the
whole run (states swap, temperatures do not). The tempering family is
observation noise sd sqrt(T), which keeps every conjugate block exactly
Gaussian, so a sweep is ``gibbs_sweep`` with a (G L,) tensor of
temperatures, and the cutpoint kernel takes one scale a lane's chain.

After each sweep (every ``swap_every`` sweeps) adjacent rungs of each
group propose to swap states, even pairs on even phases and odd pairs on
odd ones, accepted with probability
    min(1, exp(l_Ta(S_b) + l_Tb(S_a) - l_Ta(S_a) - l_Tb(S_b)))
in the tempered data log-likelihoods l_T (the priors do not depend on T).
The stored draws are the cold lanes (l = 0 of each group).

On a mesh (``gpirt_tpu/parallel/tempering.py:73-147``, ``:371-592``) the
lanes shard over the "chains" axis by whole groups (G must divide over the
chain shards: swaps are group-local), and the items and respondents over
their axes as ``run_chains`` shards them (``parallel/items.py``,
``parallel/respondents.py``, the sweep draws by their rules). A swap
phase's cross-temperature ll is summed over the item and the respondent
shards (an ``all_reduce`` over each model axis present), so every model
shard of a group takes the same swaps; its uniforms follow the chain
mesh's rule: every rank draws all G L lanes' from the replicated generator
and keeps its chain block's, so a chain mesh is the unsharded run lane for
lane. The draws and the swap tally are gathered at the end, the same on
every rank.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from gpirt_tpu_torch.models.config import GPIRTConfig, GPIRTConstants
from gpirt_tpu_torch.models.gibbs import (
    GPIRTState,
    ShardGenerators,
    _all_sum,
    gibbs_sweep,
    sweep_draws,
)
from gpirt_tpu_torch.models.sampler import (
    Carry,
    SampleSchedule,
    advance,
    chain_start,
    draw_record,
    run_length,
    sample_schedule,
)
from gpirt_tpu_torch.parallel.chains import (
    Shards,
    check_replicated,
    gather_chains,
    gather_draws,
    shards_of,
)
from gpirt_tpu_torch.parallel.smc import _lane_ll, _take, lane_block

__all__ = [
    "temperature_ladder",
    "lane_temperatures",
    "TemperedStart",
    "tempered_start",
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
          consts: GPIRTConstants, groups=()):
    """One even/odd adjacent-pair swap phase (parity = phase % 2) over the
    lanes (``gpirt_tpu/parallel/tempering.py:96``), whole groups of L.

    ``ll_own`` (K,) is each lane's data ll at its own temperature, of the
    current state; ``u`` (K,) the phase's uniforms, pair (a, a + 1) taking
    u[a]. ``groups`` are the process groups of the model axes (items,
    respondents) that the states' blocks shard: the cross-temperature ll
    is summed over each, so that every model shard takes the same swaps.
    Returns (states after the swap, their own-temperature ll, the accepted
    pairs marked at their lower lane)."""
    K = ll_own.shape[0]
    lane = torch.arange(K, device=ll_own.device)
    l = lane % L
    partner_l = l + 1 - 2 * ((l - phase % 2) % 2)
    valid = (partner_l >= 0) & (partner_l < L)
    partner = torch.where(valid, lane + (partner_l - l), lane)
    ll_cross = _lane_ll(states, temps[partner], y, consts)  # l_{T_partner}(S_lane)
    for group in groups:
        _all_sum(ll_cross, group)
    delta = (ll_cross + ll_cross[partner]) - (ll_own + ll_own[partner])
    accept = valid & (torch.log(u[torch.minimum(lane, partner)]) < delta)
    swapped = _take(states, torch.where(accept, partner, lane))
    # lane k now holds S_partner(k), whose ll at T_k is ll_cross[partner(k)]
    ll_post = torch.where(accept, ll_cross[partner], ll_own)
    return swapped, ll_post, accept & (partner > lane)


def lane_temperatures(G: int, n_temps: int, max_temp: float,
                      consts: GPIRTConstants, config: GPIRTConfig) -> torch.Tensor:
    """(G L,) temperatures, group-major: lane l of every group at the
    ladder's temps[l]."""
    return torch.as_tensor(np.tile(temperature_ladder(int(n_temps), max_temp), G),
                           dtype=config.tdtype, device=consts.grid.device)


class TemperedStart(NamedTuple):
    """A rank's part of a tempered run (:func:`tempered_start`): its place
    (None without a mesh), its shard generators, its block's y, constants
    and config, its lanes of the G L, their temperatures, and ``fresh()``,
    its block of the lanes' initial states."""

    shards: Optional[Shards]
    shard_gens: Optional[ShardGenerators]
    y: torch.Tensor
    consts: GPIRTConstants
    config: GPIRTConfig
    lanes: slice
    temps: torch.Tensor
    fresh: object


def tempered_start(gen: torch.Generator, theta_init: torch.Tensor,
                   thresholds_init: torch.Tensor, y: torch.Tensor, consts: GPIRTConstants,
                   config: GPIRTConfig, n_temps: int, max_temp: float, mesh=None,
                   item_axis: Optional[str] = None, respondent_axis: Optional[str] = None,
                   shard_gens: Optional[ShardGenerators] = None) -> TemperedStart:
    """This rank's :class:`TemperedStart` of the G = len(theta_init)
    groups of ``n_temps`` lanes, each group's lanes from its init
    (``theta_init`` (G, H, n)), their init numbers drawn for all G L lanes
    as ``models.sampler.chain_start`` draws a run's. Raises as JAX does for
    a sampler other than the conjugate one, for ESS theta (it has no
    tempered form) and, on a mesh, when the groups do not divide over the
    chain shards (``gpirt_tpu/parallel/tempering.py:402-409``)."""
    if config.resolved_f_method != "conjugate":
        raise NotImplementedError("parallel tempering needs f_method='conjugate'")
    if config.theta_method != "grid":
        raise NotImplementedError("tempering needs theta_method='grid'")
    G, L = theta_init.shape[0], int(n_temps)
    if mesh is not None:
        n_chain = shards_of(mesh, item_axis, respondent_axis).n_chain
        if G % n_chain:
            raise ValueError(f"{G} tempered groups do not divide over {n_chain} chain "
                             "shards (swaps are group-local, so the lanes shard by whole "
                             "groups)")
    shards, shard_gens, y, consts_l, config, fresh = chain_start(
        gen, theta_init.repeat_interleave(L, dim=0), thresholds_init, y, consts, config,
        mesh, item_axis, respondent_axis, shard_gens)
    lanes = slice(0, G * L) if shards is None else shards.chains(G * L)
    temps = lane_temperatures(G, L, max_temp, consts, config)[lanes]
    return TemperedStart(shards, shard_gens, y, consts_l, config, lanes, temps, fresh)


def advance_tempered(gen: torch.Generator, carry: Carry, accepted: torch.Tensor,
                     start_: TemperedStart, n_temps: int, swap_every: int,
                     sched: SampleSchedule, start: int, stop: int, *,
                     store_f: bool = False, store_fstar: bool = False):
    """The tempered sweeps ``[start, stop)`` of this rank's lanes in
    ``carry`` (:func:`~gpirt_tpu_torch.models.sampler.advance`), on
    ``start_``'s block (:func:`tempered_start`): sweep ``it`` draws the
    numbers of all G L lanes (the shard-local ones from its shard
    generators), then its swap phase's (G L,) uniforms when ``it %
    swap_every == 0``, from ``gen``, and keeps its lanes'. ``accepted``
    (this rank's lanes,) int64 tallies the accepted swaps at each pair's
    lower lane. Returns (accepted, the cold lanes' stored draws {name:
    (G, s, ...)}, whole on every rank)."""
    L = int(n_temps)
    shards, y, consts, config, lanes, temps = (start_.shards, start_.y, start_.consts,
                                              start_.config, start_.lanes, start_.temps)
    K = lanes.stop if shards is None else lanes.stop - lanes.start
    K_all = K if shards is None else K * shards.n_chain
    groups = () if shards is None else tuple(
        g for g in (shards.item_group, shards.resp_group) if g is not None)

    def sweep(states, it):
        nonlocal accepted
        draws = sweep_draws(gen, K_all, consts, config, it, start_.shard_gens)
        if shards is not None:
            draws = lane_block(draws, lanes, config.mix_subsweeps)
        u = None
        if L > 1 and swap_every > 0 and it % swap_every == 0:
            u = torch.rand(K_all, generator=gen, device=accepted.device,
                           dtype=config.tdtype)[lanes]
        states, ll = gibbs_sweep(states, draws, y, consts, config, temps, it,
                                 *((None, None) if shards is None else
                                   (shards.item_group, shards.resp_group)))
        if u is not None:
            states, ll, a = _swap(states, ll, temps, u, it // swap_every, L, y, consts,
                                  groups)
            accepted = accepted + a
        return states, ll

    def record(states, ll):
        cold = GPIRTState(*(a[::L] for a in states))
        return draw_record(cold, ll[::L], consts, config, store_f, store_fstar)

    out = advance(sweep, record, carry, sched, start, stop)
    if shards is None:
        return accepted, out
    check_replicated(carry.state, shards)
    return accepted, gather_draws(out, shards)


def gather_tally(accepted: torch.Tensor, start_: TemperedStart) -> torch.Tensor:
    """The (G L,) swap tally from each rank's lanes' (the chain group's),
    the same on every rank."""
    return accepted if start_.shards is None else gather_chains(accepted, start_.shards)


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
    mesh=None,
    item_axis: Optional[str] = None,
    respondent_axis: Optional[str] = None,
    shard_gens: Optional[ShardGenerators] = None,
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

    With a ``mesh`` (every rank calls this with the whole inputs) the
    groups shard over its "chains" axis, the items over ``item_axis`` and
    the respondents over ``respondent_axis`` (module docstring), their
    shard-local numbers from ``shard_gens`` (by default
    ``parallel.respondents.shard_generators`` of ``gen``'s seed); the draws
    and swap_rate come back whole on every rank, and on a chain mesh equal
    the unsharded run's.
    """
    st = tempered_start(gen, theta_init, thresholds_init, y, consts, config, n_temps,
                        max_temp, mesh, item_axis, respondent_axis, shard_gens)
    carry = Carry(st.fresh())
    sched = sample_schedule(sample_iterations, burn_iterations, thin)
    sweeps = run_length(sched, trailing=False)
    accepted = torch.zeros(st.temps.shape[0], dtype=torch.int64, device=st.temps.device)
    accepted, out = advance_tempered(gen, carry, accepted, st, n_temps, swap_every, sched,
                                     0, sweeps, store_f=store_f, store_fstar=store_fstar)
    out["swap_rate"] = torch.as_tensor(
        swap_rate(gather_tally(accepted, st).cpu().numpy(), n_temps, sweeps, swap_every),
        device=st.temps.device)
    return out
