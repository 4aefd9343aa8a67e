"""Batched elliptical slice sampling (Murray, Adams & MacKay 2010).

Counterpart of ``gpirt_tpu/ops/ess.py::ess_update``: every lane runs the
bracket-shrink loop in lockstep, accepted lanes freeze, and a lane still
active at the round cap keeps its state (an identity move, still a valid
MCMC step). The uniforms are inputs, so the result is a function of the
draws alone: a lane's accept/shrink sequence depends only on its own
numbers and likelihood, never on when the loop stops.

The loop stops after the first round that leaves no lane active. Testing
that on the card is one device-to-host sync a round. The function's
``calls``, ``rounds`` and ``syncs`` attributes count the updates, the rounds
run and the syncs made.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = ["ess_update"]

_TWO_PI = 6.283185307179586


def ess_update(
    x: torch.Tensor,
    nu: torch.Tensor,
    loglik_fn: Callable[[torch.Tensor], torch.Tensor],
    logu: torch.Tensor,
    eps0: torch.Tensor,
    rs: torch.Tensor,
    transform: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    active_only: bool = False,
) -> torch.Tensor:
    """One ESS update of a batch of lanes.

    Args:
      x: ``(*B, d)`` current state per lane.
      nu: ``(*B, d)`` prior draw per lane.
      loglik_fn: ``(*B, d) -> (*B,)``, the per-lane log-likelihood.
      logu: ``(*B,)`` log of the slice uniform.
      eps0: ``(*B,)`` initial angle in [0, 2 pi).
      rs: ``(R, *B)`` shrink uniforms, one row per round; R is the cap.
      transform: a map applied to every proposal before its likelihood and
        before it is kept (the theta update's clamp to [-5, 5],
        src/draw-theta.cpp:61); the current state is taken as it is.
      active_only: ``loglik_fn`` takes a second argument, the ``(*B,)`` mask
        of the lanes still active in the round (None for the slice level's
        call, every lane), and may leave the other lanes' values unset: the
        update reads them nowhere.

    Returns:
      ``(*B, d)`` new state.
    """
    if tuple(rs.shape[1:]) != tuple(x.shape[:-1]) or rs.shape[0] < 1:
        raise ValueError(f"rs must be (R, *B) = (R, {tuple(x.shape[:-1])}), "
                         f"got {tuple(rs.shape)}")
    ess_update.calls += 1
    log_y = (loglik_fn(x, None) if active_only else loglik_fn(x)) + logu
    eps = eps0
    eps_min = eps - _TWO_PI
    eps_max = torch.full_like(eps, _TWO_PI)
    x_out = x
    active = torch.ones_like(logu, dtype=torch.bool)
    for r in range(rs.shape[0]):
        if r > 0 and not _any_active(active):
            break
        ess_update.rounds += 1
        prop = x * torch.cos(eps).unsqueeze(-1) + nu * torch.sin(eps).unsqueeze(-1)
        if transform is not None:
            prop = transform(prop)
        accept = (loglik_fn(prop, active) if active_only else loglik_fn(prop)) > log_y
        x_out = torch.where((active & accept).unsqueeze(-1), prop, x_out)
        still = active & ~accept
        eps_min = torch.where(still & (eps < 0), eps, eps_min)
        eps_max = torch.where(still & (eps >= 0), eps, eps_max)
        eps = torch.where(still, eps_min + rs[r] * (eps_max - eps_min), eps)
        active = still
    return x_out


def _any_active(active: torch.Tensor) -> bool:
    """Whether a lane is still active: one device-to-host sync on the card."""
    ess_update.syncs += 1
    return bool(active.any())


ess_update.calls = 0
ess_update.rounds = 0
ess_update.syncs = 0
