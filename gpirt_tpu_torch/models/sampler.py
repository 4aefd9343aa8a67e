"""The MCMC loop: burn-in, thinning and storage for K chains in lockstep.

Counterpart of ``gpirt_tpu/models/sampler.py::run_chain`` and
``gpirt_tpu/parallel/chains.py::run_chains``: the chain axis is the sweep's
batch axis and a Python loop takes the place of ``lax.scan``. Over a
``DeviceMesh`` (``parallel/chains.py``) each rank runs its block of the
chains, of the items under an item axis (``parallel/items.py``) and of the
respondents under a respondent axis (``parallel/respondents.py``); the
replicated generator draws the numbers of all chains and the rank keeps
its block's, so a chain's draws do not depend on the chain layout.
A draw is recorded at absolute iteration ``iter`` iff ``iter >= burn`` and
``iter % THIN == 0`` (src/gpirtMCMC.cpp:334).

The loop is resumable: :func:`advance` runs the absolute iterations
``[start, stop)`` and records the stored ones among them, so a run cut into
chunks (``utils/checkpoint.py``) draws what one uninterrupted run draws.
The sweep's absolute iteration goes on across chunks; the interleaved
cutpoint update reads it. The state it advances sits in a :class:`Carry`,
which it updates sweep by sweep, so that no caller keeps the state a run
or chunk started from alive beside the current one.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from gpirt_tpu_torch._spans import span
from gpirt_tpu_torch.models.config import GPIRTConfig, GPIRTConstants
from gpirt_tpu_torch.models.gibbs import (
    GPIRTState,
    ShardGenerators,
    gibbs_sweep,
    init_draws,
    init_state,
    stored_fstar,
    sweep_draws,
    theta_from_indices,
)
from gpirt_tpu_torch.parallel.chains import check_replicated, gather_draws, shards_of
from gpirt_tpu_torch.parallel.respondents import shard_generators, shard_inputs
from gpirt_tpu_torch.parallel.smc import lane_block

__all__ = [
    "Carry",
    "run_chains",
    "run_chain",
    "advance",
    "advance_chains",
    "chain_start",
    "draw_record",
    "run_length",
    "sample_schedule",
    "SampleSchedule",
    "memory_estimate_mb",
]


class Carry:
    """The chain state that :func:`advance` moves on, held so that the
    state a run starts from is freed after its first sweep (at the
    synthetic configuration a state is 1.5 GB on the device)."""

    __slots__ = ("state",)

    def __init__(self, state):
        self.state = state


class SampleSchedule(NamedTuple):
    pre_iterations: int  # unrecorded sweeps before the first stored draw
    n_samples: int  # stored draws
    thin: int


def sample_schedule(sample_iterations: int, burn_iterations: int, thin: int) -> SampleSchedule:
    """Translate (sample, burn, THIN) into loop lengths.

    Stored absolute iterations are {iter : iter >= burn, iter % THIN == 0}.
    The first stored iteration is ``burn + r`` with ``r = (-burn) % THIN``;
    subsequent ones are THIN apart.
    """
    total = sample_iterations + burn_iterations
    r = (-burn_iterations) % thin
    first = burn_iterations + r
    if first >= total:
        return SampleSchedule(pre_iterations=total, n_samples=0, thin=thin)
    n_samples = (total - 1 - first) // thin + 1
    return SampleSchedule(pre_iterations=first, n_samples=n_samples, thin=thin)


def run_length(sched: SampleSchedule, trailing: bool = True) -> int:
    """The sweeps a run of ``sched`` takes: through the ``thin - 1`` sweeps
    after the last stored draw (``run_chains``), or up to that draw only
    (``trailing=False``, the tempered run)."""
    if sched.n_samples == 0:
        return sched.pre_iterations
    last = sched.pre_iterations + (sched.n_samples - 1) * sched.thin
    return last + (sched.thin if trailing else 1)


def memory_estimate_mb(
    n: int, m: int, horizon: int, C: int, n_samples: int, grid_size: int,
    store_f: bool, store_fstar: bool, bytes_per_el: int = 8,
) -> Dict[str, float]:
    """Reference memory-estimate model (src/gpirtMCMC.cpp:47-58)."""
    mb = 1024.0 * 1024.0
    est = {
        "theta": n_samples * n * horizon * bytes_per_el / mb,
        "beta": n_samples * 3 * m * horizon * bytes_per_el / mb,
        "f": n_samples * n * m * horizon * bytes_per_el / mb,
        "fstar": n_samples * grid_size * m * horizon * bytes_per_el / mb,
        "threshold": n_samples * m * (C + 1) * horizon * bytes_per_el / mb,
    }
    total = est["theta"] + est["beta"] + est["threshold"]
    if store_f:
        total += est["f"]
    if store_fstar:
        total += est["fstar"]
    est["total"] = total
    return est


def draw_record(state: GPIRTState, ll: torch.Tensor, consts: GPIRTConstants,
                config: GPIRTConfig, store_f: bool,
                store_fstar: bool) -> Dict[str, torch.Tensor]:
    """One stored draw of K chains: theta (K, H, n), beta, threshold, ll
    (K,), and f and f* (f* with its parametric mean, :func:`stored_fstar`)
    when asked for."""
    out = {
        "theta": theta_from_indices(state.theta_idx, consts),
        "beta": state.beta,
        "threshold": state.thresholds,
        "ll": ll,
    }
    if store_f:
        out["f"] = state.f
    if store_fstar:
        out["fstar"] = stored_fstar(state.fstar, state.beta, consts, config)
    return out


def advance(sweep: Callable[[object, int], Tuple[object, torch.Tensor]],
            record: Callable[[object, torch.Tensor], Dict[str, torch.Tensor]],
            carry: Carry, sched: SampleSchedule, start: int,
            stop: int) -> Dict[str, torch.Tensor]:
    """Run the absolute iterations ``[start, stop)`` on ``carry.state``:
    ``sweep(state, it)`` returns (state, ll), and ``record(state, ll)`` the
    draw of a stored iteration (``iter >= first``, ``(iter - first) % thin
    == 0``, one of ``sched``'s ``n_samples``). Returns the stored draws of
    the range, chain axis first: {name: (K, s, ...)} ({} when none fell in
    it)."""
    first, S, thin = sched
    lo = min(S, max(0, -(-(start - first) // thin)))
    hi = min(S, max(0, -(-(stop - first) // thin)))
    out: Dict[str, torch.Tensor] = {}
    for it in range(start, stop):
        carry.state, ll = sweep(carry.state, it)
        s, r = divmod(it - first, thin)
        if it < first or r or s >= S:
            continue
        for k, v in record(carry.state, ll).items():
            if k not in out:
                out[k] = torch.empty((hi - lo,) + tuple(v.shape), dtype=v.dtype,
                                     device=v.device)
            out[k][s - lo] = v
    return {k: v.transpose(0, 1) for k, v in out.items()}


def advance_chains(gen: torch.Generator, carry: Carry, y: torch.Tensor,
                   consts: GPIRTConstants, config: GPIRTConfig, sched: SampleSchedule,
                   start: int, stop: int, *, store_f: bool = False,
                   store_fstar: bool = False, shards=None,
                   shard_gens: Optional[ShardGenerators] = None) -> Dict[str, torch.Tensor]:
    """:func:`advance` with ``gibbs_sweep``: sweep ``it`` draws its numbers
    from ``gen`` and passes ``it`` as its iteration.

    ``shards`` (``parallel.chains.Shards``, :func:`chain_start`'s) places
    this rank on a mesh: ``carry`` then holds its block of the chains,
    items and respondents, y, ``consts`` and ``config`` are its block's,
    the numbers of all chains are drawn (the shard-local ones from
    ``shard_gens``) and its chains' kept. At the end the replicated fields
    are checked alike over the model axes (theta over the item shards;
    beta, the cutpoints and f* over the respondent shards: the canary of
    ``gpirt_tpu/models/gibbs.py:873-883``) and the stored draws come back
    whole, the same on every rank."""
    K = carry.state.theta_idx.shape[0]
    groups = (None, None) if shards is None else (shards.item_group, shards.resp_group)
    if shards is not None:
        K *= shards.n_chain
        own = shards.chains(K)

    def sweep(state, it):
        with span("sweep", it):
            with span("sweep.draws"):
                draws = sweep_draws(gen, K, consts, config, it, shard_gens)
                if shards is not None:
                    draws = lane_block(draws, own, config.mix_subsweeps)
            return gibbs_sweep(state, draws, y, consts, config, None, it, *groups)

    def record(state, ll):
        return draw_record(state, ll, consts, config, store_f, store_fstar)

    out = advance(sweep, record, carry, sched, start, stop)
    if shards is None:
        return out
    check_replicated(carry.state, shards)
    return gather_draws(out, shards)


def chain_start(gen: torch.Generator, theta_init: torch.Tensor, thresholds_init,
                y: torch.Tensor, consts: GPIRTConstants, config: GPIRTConfig, mesh=None,
                item_axis: Optional[str] = None, respondent_axis: Optional[str] = None,
                shard_gens: Optional[ShardGenerators] = None):
    """(shards, shard generators, y, constants and config, and a
    ``fresh()`` that makes the prior init) of this rank: without a ``mesh``
    no shards and the inputs as they are; on one its place, its block's
    inputs and its block of the prior init, whose numbers are drawn for all
    chains, item-local as the sweeps' are (``shard_gens``, by default
    ``parallel.respondents.shard_generators`` of ``gen``'s seed)."""
    K = theta_init.shape[0]
    if mesh is None:
        return None, shard_gens, y, consts, config, lambda: init_state(
            theta_init, thresholds_init, consts, config, init_draws(gen, K, consts, config))
    shards = shards_of(mesh, item_axis, respondent_axis)
    if shard_gens is None:
        shard_gens = shard_generators(gen.initial_seed(), shards, gen.device)
    own = shards.chains(K)
    resp = shards.respondents(config.n)
    y_l, thr_l, consts_l, config_l = shard_inputs(y, thresholds_init, consts, config, shards)
    init_gen = gen if shard_gens is None or shard_gens.item is None else shard_gens.item

    def fresh():
        draws = init_draws(init_gen, K, consts_l, config_l)
        return init_state(theta_init[own][..., resp], thr_l, consts_l, config_l,
                          lane_block(draws, own))

    return shards, shard_gens, y_l, consts_l, config_l, fresh


def run_chains(
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
    initial_states: Optional[GPIRTState] = None,
    store_f: bool = False,
    store_fstar: bool = False,
    mesh=None,
    item_axis: Optional[str] = None,
    respondent_axis: Optional[str] = None,
    shard_gens: Optional[ShardGenerators] = None,
) -> Dict[str, torch.Tensor]:
    """Run K chains; returns draws with a leading chain axis, on the device.

    ``theta_init`` is (K, H, n) and fixes K; ``initial_states`` (e.g. an
    SMC-annealed ensemble) skips the prior init. All randomness comes from
    ``gen``.

    With a ``mesh`` (a ``DeviceMesh``; every rank calls this with the whole
    inputs) the chains shard over its "chains" axis, with ``item_axis`` the
    items over that axis (``parallel/items.py``) and with
    ``respondent_axis`` the respondents (``parallel/respondents.py``), their
    shard-local numbers from ``shard_gens`` (:func:`chain_start`);
    ``initial_states`` is then this rank's block. The draws come back
    whole on every rank; without a model axis they are the unsharded
    run's, chain for chain.

    Returns "theta" (K, S, H, n), "beta" (K, S, H, 3, m),
    "threshold" (K, S, H, m, C+1) and "ll" (K, S); with ``store_f`` also
    "f" (K, S, H, n, m), and with ``store_fstar`` "fstar" (K, S, H, N, m),
    f* with the parametric mean mu* added (``gpirt_tpu/parallel/chains.py:284``;
    session 0's mu* under constant_IRF, :func:`stored_fstar`).
    """
    sched = sample_schedule(sample_iterations, burn_iterations, thin)
    shards, shard_gens, y, consts, config, fresh = chain_start(
        gen, theta_init, thresholds_init, y, consts, config, mesh, item_axis, respondent_axis,
        shard_gens)
    carry = Carry(fresh() if initial_states is None else initial_states)
    out = advance_chains(gen, carry, y, consts, config, sched, 0, run_length(sched),
                         store_f=store_f, store_fstar=store_fstar, shards=shards,
                         shard_gens=shard_gens)
    if sched.n_samples == 0:  # the layout of an empty run
        beta = carry.state.beta
        rec = draw_record(carry.state, beta.new_zeros(beta.shape[0]), consts, config,
                          store_f, store_fstar)
        out = {k: v.new_empty((v.shape[0], 0) + tuple(v.shape[1:])) for k, v in rec.items()}
        if shards is not None:
            out = gather_draws(out, shards)
    return out


def run_chain(gen: torch.Generator, y: torch.Tensor, theta_init: torch.Tensor,
              thresholds_init: torch.Tensor, consts: GPIRTConstants,
              config: GPIRTConfig, sample_iterations: int, burn_iterations: int,
              thin: int = 1, store_f: bool = False, store_fstar: bool = False,
              initial_state: Optional[GPIRTState] = None) -> Dict[str, torch.Tensor]:
    """One chain (``gpirt_tpu/models/sampler.py:78``): :func:`run_chains`
    with K = 1 and its outputs squeezed. ``theta_init`` is (H, n);
    ``initial_state``, when given, has a chain axis of 1.

    Returns "theta" (S, H, n), "beta" (S, H, 3, m), "threshold"
    (S, H, m, C+1), "ll" (S,), and "f" (S, H, n, m) and "fstar"
    (S, H, N, m) when asked for.
    """
    out = run_chains(gen, y, theta_init.unsqueeze(0), thresholds_init, consts, config,
                     sample_iterations=sample_iterations,
                     burn_iterations=burn_iterations, thin=thin,
                     initial_states=initial_state, store_f=store_f,
                     store_fstar=store_fstar)
    return {k: v[0] for k, v in out.items()}
