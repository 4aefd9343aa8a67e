"""The MCMC loop: burn-in, thinning and storage for K chains in lockstep.

Counterpart of ``gpirt_tpu/models/sampler.py::run_chain`` and
``gpirt_tpu/parallel/chains.py::run_chains`` on one device: the chain axis
is the sweep's batch axis and a Python loop takes the place of ``lax.scan``.
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

__all__ = [
    "Carry",
    "run_chains",
    "run_chain",
    "advance",
    "advance_chains",
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
                   store_fstar: bool = False) -> Dict[str, torch.Tensor]:
    """:func:`advance` with ``gibbs_sweep``: sweep ``it`` draws its numbers
    from ``gen`` and passes ``it`` as its iteration."""
    K = carry.state.theta_idx.shape[0]

    def sweep(state, it):
        return gibbs_sweep(state, sweep_draws(gen, K, consts, config, it), y, consts,
                           config, None, it)

    def record(state, ll):
        return draw_record(state, ll, consts, config, store_f, store_fstar)

    return advance(sweep, record, carry, sched, start, stop)


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
) -> Dict[str, torch.Tensor]:
    """Run K chains; returns draws with a leading chain axis, on the device.

    ``theta_init`` is (K, H, n) and fixes K; ``initial_states`` (e.g. an
    SMC-annealed ensemble) skips the prior init. All randomness comes from
    ``gen``.

    Returns "theta" (K, S, H, n), "beta" (K, S, H, 3, m),
    "threshold" (K, S, H, m, C+1) and "ll" (K, S); with ``store_f`` also
    "f" (K, S, H, n, m), and with ``store_fstar`` "fstar" (K, S, H, N, m),
    f* with the parametric mean mu* added (``gpirt_tpu/parallel/chains.py:284``;
    session 0's mu* under constant_IRF, :func:`stored_fstar`).
    """
    sched = sample_schedule(sample_iterations, burn_iterations, thin)
    K = theta_init.shape[0]
    if initial_states is None:
        carry = Carry(init_state(theta_init, thresholds_init, consts, config,
                                 init_draws(gen, K, consts, config)))
    else:
        carry = Carry(initial_states)
    out = advance_chains(gen, carry, y, consts, config, sched, 0, run_length(sched),
                         store_f=store_f, store_fstar=store_fstar)
    if sched.n_samples == 0:  # the layout of an empty run
        rec = draw_record(carry.state, carry.state.beta.new_zeros(K), consts, config,
                          store_f, store_fstar)
        out = {k: v.new_empty((K, 0) + tuple(v.shape[1:])) for k, v in rec.items()}
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
