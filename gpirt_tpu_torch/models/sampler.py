"""The MCMC loop: burn-in, thinning and storage for K chains in lockstep.

Counterpart of ``gpirt_tpu/models/sampler.py::run_chain`` and
``gpirt_tpu/parallel/chains.py::run_chains`` on one device: the chain axis
is the sweep's batch axis and a Python loop takes the place of ``lax.scan``.
A draw is recorded at absolute iteration ``iter`` iff ``iter >= burn`` and
``iter % THIN == 0`` (src/gpirtMCMC.cpp:334).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

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

__all__ = ["run_chains", "sample_schedule", "SampleSchedule"]


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
    K, H, n = theta_init.shape
    if initial_states is None:
        state = init_state(theta_init, thresholds_init, consts, config,
                           init_draws(gen, K, consts, config))
    else:
        state = initial_states

    it = 0

    def sweep(state):  # absolute sweep ``it``, the interleave's iteration
        nonlocal it
        out = gibbs_sweep(state, sweep_draws(gen, K, consts, config, it), y,
                          consts, config, None, it)
        it += 1
        return out

    for _ in range(sched.pre_iterations):
        state, _ = sweep(state)

    S = sched.n_samples
    dt, dev = config.tdtype, consts.grid.device
    out = {
        "theta": torch.empty((S,) + tuple(state.theta_idx.shape), dtype=dt, device=dev),
        "beta": torch.empty((S,) + tuple(state.beta.shape), dtype=dt, device=dev),
        "threshold": torch.empty((S,) + tuple(state.thresholds.shape), dtype=dt,
                                 device=dev),
        "ll": torch.empty((S, K), dtype=dt, device=dev),
    }
    if store_f:
        out["f"] = torch.empty((S,) + tuple(state.f.shape), dtype=dt, device=dev)
    if store_fstar:
        out["fstar"] = torch.empty((S,) + tuple(state.fstar.shape), dtype=dt,
                                   device=dev)
    for s in range(S):
        state, ll = sweep(state)  # the recorded sweep
        out["theta"][s] = theta_from_indices(state.theta_idx, consts)
        out["beta"][s] = state.beta
        out["threshold"][s] = state.thresholds
        out["ll"][s] = ll
        if store_f:
            out["f"][s] = state.f
        if store_fstar:
            out["fstar"][s] = stored_fstar(state.fstar, state.beta, consts, config)
        for _ in range(thin - 1):
            state, _ = sweep(state)
    return {k: v.transpose(0, 1) for k, v in out.items()}
