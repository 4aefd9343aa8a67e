"""SMC annealed initialization for one campaign of K chains, on one device
or over a mesh of chains, items and respondents, or for a batch of B
independent campaigns, on one device or over a campaign axis.

Counterpart of ``gpirt_tpu/parallel/smc.py::anneal_init`` and
``anneal_init_batched``: each K-chain ensemble starts hot
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

On a mesh (``gpirt_tpu/parallel/smc.py:65-349``) each rank mutates its
block of the lanes (its chains, its items, its respondents); the
reweight's per-lane ll is summed over the item shards and the respondent
shards, the log-weights are gathered over the chain shards, so that every
rank computes the same weights, ESS and source lanes from the replicated
generator's uniform, and a resample gathers the lane states over the chain
shards (the per-item and per-respondent leaves stay sharded: a resample
moves whole chains, and every rank keeps its block of each) and keeps this
rank's lanes. Mutation draws follow ``parallel/items.py``'s and
``parallel/respondents.py``'s rules.

Over a campaign axis (``parallel.chains.CAMPAIGN_AXIS``,
``gpirt_tpu/parallel/smc.py:388-499``) each rank anneals its block of B / P
whole campaigns from those campaigns' own generators, with no collective
until the end, where the info rows are gathered in campaign order: each
campaign is the one the unsharded batch anneals.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from gpirt_tpu_torch.models.config import GPIRTConfig, GPIRTConstants
from gpirt_tpu_torch.models.gibbs import (
    GPIRTState,
    ShardGenerators,
    _all_sum,
    compute_mu,
    gibbs_sweep,
    init_draws,
    init_state,
    sweep_draws,
    theta_from_indices,
)
from gpirt_tpu_torch.ops.likelihood import ordinal_ll_terms
from gpirt_tpu_torch.parallel.chains import Shards, gather_chains, shards_of
from gpirt_tpu_torch.parallel.respondents import shard_generators, shard_inputs

__all__ = ["anneal_init", "anneal_init_batched", "annealing_schedule", "lane_block",
           "WARM_STEPS"]

WARM_STEPS = 8


def annealing_schedule(n_steps: int, max_temp: float) -> np.ndarray:
    """Geometric T_max -> 1 over n_steps (first entry T_max, last 1.0)."""
    if n_steps < 2:
        return np.ones(max(n_steps, 1))
    return max_temp ** (1.0 - np.arange(n_steps) / (n_steps - 1))


def _lane_ll(states: GPIRTState, t, y, consts: GPIRTConstants):
    """Each lane's tempered log-likelihood over its items: (K,). ``t`` is
    one temperature for every lane, or a (K,) tensor of one a lane."""
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


def _resample(states: GPIRTState, src: torch.Tensor, shards: Shards,
              lanes: slice) -> GPIRTState:
    """The lanes ``lanes`` of the resampled ensemble, lane j a copy of
    source lane src[j] (src over all lanes). Over a chain mesh the distinct
    source lanes are gathered over the chain shards first, each from the
    rank that holds it (one all_reduce of a zero-filled buffer a field; a
    resample at a collapsed weight ESS has few distinct sources)."""
    if shards.chain_group is None:
        return _take(states, src[lanes])
    sources, where = torch.unique(src, return_inverse=True)
    mine = shards.chains(src.numel())
    held = (sources >= mine.start) & (sources < mine.stop)
    out = []
    for a in states:
        buf = a.new_zeros((sources.numel(),) + tuple(a.shape[1:]))
        buf[held] = a[sources[held] - mine.start]
        dist.all_reduce(buf, group=shards.chain_group)
        out.append(buf[where[lanes]])
    return GPIRTState(*out)


def _lane_axis(draws, field: str, passes: int = 1) -> int:
    """The axes before the lanes in a field of a draws tuple: a round or try
    axis (its ``_ROUND_FIELDS``), after the pass axis of a latent pass's
    field (its ``_PASS_FIELDS``) when there are several passes."""
    return (int(passes > 1 and field in getattr(draws, "_PASS_FIELDS", ()))
            + int(field in getattr(draws, "_ROUND_FIELDS", ())))


def lane_block(draws, lanes: slice, passes: int = 1, lead: int = 0):
    """A draws tuple cut to the lanes ``lanes`` along each field's lane
    axis; ``passes`` and ``lead`` as in :func:`_cat_lanes`. A rank on a
    chain mesh keeps its chains' block of numbers drawn for all."""
    out = []
    for name, f in zip(draws._fields, draws):
        axis = lead + _lane_axis(draws, name, passes)
        if f is None:
            out.append(None)
        elif isinstance(f, tuple):
            out.append(lane_block(f, lanes, passes, axis))
        else:
            out.append(f.narrow(axis, lanes.start, lanes.stop - lanes.start))
    return type(draws)(*out)


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
    shards: Optional[Shards] = None,
    shard_gens: Optional[ShardGenerators] = None,
):
    """Anneal B independent K-chain campaigns from T = max_temp to T = 1 as
    the B K lanes of one sweep. Returns (states, info).

    ``gens`` holds one generator a campaign: campaign b's init, resample
    uniforms and sweep draws come from ``gens[b]``. ``theta_init`` (K, H, n)
    fixes K and is shared by the campaigns. Every ``states`` field has a
    leading (B, K); ``info`` holds the weight-ESS trace of the annealing
    steps (B, n_steps - 1), the resample counts (B,) (the final resample
    included) and the final weight ESS (B,), as numpy.

    ``shards`` is this rank's place on a mesh. For one campaign it may
    shard chains, items and respondents (:func:`anneal_init`): ``states``
    then holds this rank's block of the lanes, and ``shard_gens`` are its
    shard-local generators. For a batch (every rank calls this with all B
    generators) its chain axis is a campaign axis
    (``parallel.chains.campaign_shards``) of P ranks, each of which anneals
    its B / P whole campaigns: ``states`` then holds them, (B / P, K, ...),
    and ``info`` every campaign's rows in campaign order, the same on every
    rank. B must divide over P (``ValueError``, as JAX,
    ``gpirt_tpu/parallel/smc.py:479-486``), and a batch shards over no
    model axis (``ValueError``).
    """

    if config.resolved_f_method != "conjugate":
        raise NotImplementedError("anneal_init needs f_method='conjugate'")
    shards, camp = Shards() if shards is None else shards, Shards()
    if len(gens) > 1:  # a batch: whole campaigns over the chain (campaign) axis
        if shards.n_item > 1 or shards.n_resp > 1:
            raise ValueError("a batch of campaigns shards over a campaign axis alone, "
                             "not over items or respondents")
        if len(gens) % shards.n_chain:
            raise ValueError(f"{len(gens)} campaigns do not divide over {shards.n_chain} "
                             "campaign-axis devices")
        camp, shards = shards, Shards()
        gens = list(gens)[camp.chains(len(gens))]
    B, K = len(gens), theta_init.shape[0]
    dt, dev = config.tdtype, consts.grid.device
    # this rank's lanes, items, respondents, and their responses, constants
    # and config
    own = shards.chains(K) if B == 1 else slice(0, B * K)
    resp = shards.respondents(config.n)
    y, thresholds_init, consts, config = shard_inputs(y, thresholds_init, consts, config,
                                                      shards)
    # the ladder in the working precision, as the JAX package holds it
    temps = [float(t) for t in
             torch.as_tensor(annealing_schedule(n_steps, max_temp), dtype=dt)]
    item_gen = None if shard_gens is None else shard_gens.item
    init = _cat_lanes([init_draws(g if item_gen is None else item_gen, K, consts, config)
                       for g in gens])
    states = init_state(theta_init.repeat(B, 1, 1)[own][..., resp], thresholds_init, consts,
                        config, lane_block(init, own))
    lanes = torch.arange(B * K, device=dev).reshape(B, K)
    logw = torch.zeros(B, K, dtype=dt, device=dev)
    # the JAX package's step ids, each step's sweeps' iteration: the warm
    # prologue's n_steps + 1.., then the annealing steps' 1..n_steps - 1
    ids = list(range(n_steps + 1, n_steps + 1 + WARM_STEPS)) + list(range(1, n_steps))
    steps = [(temps[0], temps[0])] * WARM_STEPS + list(zip(temps[:-1], temps[1:]))
    ess_trace, resampled = [], []
    for i, (t_prev, t_new) in zip(ids, steps):
        if t_new != t_prev:  # the warm prologue's ratio is exactly 0
            ll = torch.stack([_lane_ll(states, t_new, y, consts),
                              _lane_ll(states, t_prev, y, consts)])
            for group in (shards.item_group, shards.resp_group):
                _all_sum(ll, group)
            logw = logw + gather_chains(ll[0] - ll[1], shards).reshape(B, K)
        _, ess_w, src = _weights(logw, gens, K, dev, dt)
        do = ess_w < ess_threshold * K  # (B,), decided on the device
        sel = torch.where(do.unsqueeze(-1), src, lanes).reshape(-1)
        # on one device no step waits for the host; over chain shards every
        # rank reads the same decision and gathers only to resample
        if shards.chain_group is None or bool(do.any()):
            states = _resample(states, sel, shards, own)
        logw = torch.where(do.unsqueeze(-1), torch.zeros_like(logw), logw)
        ess_trace.append(ess_w)
        resampled.append(do)
        for _ in range(sweeps_per_step):
            draws = _cat_lanes([sweep_draws(g, K, consts, config, i, shard_gens)
                                for g in gens], config.mix_subsweeps)
            states, _ = gibbs_sweep(states, lane_block(draws, own, config.mix_subsweeps),
                                    y, consts, config, t_new, i, shards.item_group,
                                    shards.resp_group)
    w, _, src = _weights(logw, gens, K, dev, dt)
    states = _resample(states, src.reshape(-1), shards, own)
    # each campaign's rows, gathered over the campaign axis in campaign order
    rows = [gather_chains(t.contiguous(), camp) for t in (
        torch.stack(ess_trace)[WARM_STEPS:].T, torch.stack(resampled)[WARM_STEPS:].sum(0),
        w)]
    w_final = rows[2].cpu().double().numpy()
    info = {
        "weight_ess": rows[0].cpu().double().numpy(),
        "n_resamples": rows[1].cpu().numpy() + 1,
        "final_weight_ess": 1.0 / np.sum(w_final * w_final, axis=-1),
    }
    return GPIRTState(*(a.reshape((B, -1) + a.shape[1:]) for a in states)), info


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
    mesh=None,
    item_axis: Optional[str] = None,
    respondent_axis: Optional[str] = None,
    shard_gens: Optional[ShardGenerators] = None,
):
    """Anneal K chains from T = max_temp to T = 1. Returns (states, info).

    ``theta_init`` is (K, H, n) and fixes K. The run makes WARM_STEPS +
    n_steps - 1 steps of ``sweeps_per_step`` tempered sweeps each, all
    draws from ``gen``: one campaign of :func:`anneal_init_batched`.
    ``info`` holds the annealing steps' weight-ESS trace, the resample
    count (the final resample included) and the final weight ESS.

    With a ``mesh`` (every rank calls it with the whole inputs) the chains
    shard over its "chains" axis, with ``item_axis`` the items and with
    ``respondent_axis`` the respondents over those axes, whose shard-local
    numbers come from ``shard_gens`` (by default
    ``parallel.respondents.shard_generators`` of ``gen``'s seed); ``states``
    is then this rank's block (``parallel.chains.lane_state_block``) and
    ``info`` the same on every rank.
    """
    shards = shards_of(mesh, item_axis, respondent_axis)
    if shard_gens is None:
        shard_gens = shard_generators(gen.initial_seed(), shards, gen.device)
    states, info = anneal_init_batched(
        [gen], y, theta_init, thresholds_init, consts, config, n_steps=n_steps,
        max_temp=max_temp, sweeps_per_step=sweeps_per_step,
        ess_threshold=ess_threshold, shards=shards, shard_gens=shard_gens)
    return GPIRTState(*(a[0] for a in states)), {
        "weight_ess": info["weight_ess"][0],
        "n_resamples": int(info["n_resamples"][0]),
        "final_weight_ess": float(info["final_weight_ess"][0]),
    }
