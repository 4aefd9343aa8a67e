"""Campaign-replicated posterior estimation: R independent SMC campaigns on
one device or over a campaign axis.

Counterpart of ``gpirt_tpu/campaigns.py``. The
GP-IRT posterior under wide IRF priors is multi-basin, so one run's
ensemble, however many chains, is one draw of where the basins fall. The
campaign estimator runs R independent campaigns (each an SMC annealed
initialization and a short sampling run) and charges the across-campaign
variance of the campaign means: its square root over sqrt(R) is the
standard error of the grand mean.

All R campaigns anneal as the R K lanes of one batched anneal
(``parallel/smc.anneal_init_batched``; campaign r draws from its own
generator, seeded SEED + r K as the JAX package seeds campaign r's chain
keys) and sample as one ``run_chains`` over the R K lanes. The estimator
and the per-campaign pooled ESS run on the device; only (R, P)-sized
summaries come back to the host.

Over a campaign mesh (``parallel.chains.CAMPAIGN_AXIS``,
``gpirt_tpu/campaigns.py:106-129``) each rank anneals its R / P campaigns,
and the sampling run's R K lanes shard over the axis by the chain mesh's
rule: every rank draws all lanes' numbers from the one generator seeded
SEED + R K and keeps its campaigns' block. The draws come back whole on
every rank, and the estimator runs on them there. Each rank's work is what
:func:`_campaign_draws` computes for its place alone, and the result is
the unsharded call's bit for bit: no lane's draws depend on how many lanes
are batched with it (``ops.linalg.lane_chunked``), and the estimator reads
the draws in one memory layout.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from gpirt_tpu_torch.api import (
    _as_cube,
    _beta_priors,
    _cached_constants,
    _coerce_thresholds,
    _device,
    _strip_h,
    _sync,
    default_thresholds,
    full_fp32_matmuls,
)
from gpirt_tpu_torch.models.config import THETA_HI, THETA_LO, GPIRTConfig
from gpirt_tpu_torch.models.gibbs import GPIRTState
from gpirt_tpu_torch.models.sampler import run_chains
from gpirt_tpu_torch.parallel.chains import Shards, campaign_shards
from gpirt_tpu_torch.parallel.distributed import broadcast_constants
from gpirt_tpu_torch.parallel.smc import anneal_init_batched
from gpirt_tpu_torch.utils.diagnostics import effective_sample_size_device
from gpirt_tpu_torch.utils.response import (
    DEFAULT_VOTE_CODES,
    as_response_matrix,
    encode_categories,
    recode_cube,
)

__all__ = ["gpirt_campaigns", "campaign_schedule"]


def campaign_schedule(C: int = 2) -> Dict[str, Any]:
    """The per-campaign schedule of the JAX package's pooled-frontier study
    (``gpirt_tpu/campaigns.py:47``): 64 chains, SMC 160 steps from T = 64,
    burn 25, 100 draws; Newton cutpoints for binary data."""
    return {
        "n_chains": 64,
        "sample_iterations": 100,
        "burn_iterations": 25,
        "smc_steps": 160,
        "smc_max_temp": 64.0,
        "threshold_method": "newton" if C == 2 else "ess",
    }


def _campaign_estimator(theta: torch.Tensor, R: int, K: int, S: int, P: int):
    """The campaign estimator on the draws' device: theta (R K, S, P) draws,
    each sign-aligned against one global centered reference (campaign 0's
    chain 0's first draw), reduced to (campaign means (R, P), the pooled
    posterior variance (P,))."""
    x = theta.reshape(R, K, S, P)
    ref = x[0, 0, 0] - x[0, 0, 0].mean()
    cent = x - x.mean(dim=3, keepdim=True)
    proj = torch.einsum("rksp,p->rks", cent, ref)
    xa = x * torch.where(proj < 0, -1.0, 1.0).unsqueeze(-1)
    campaign_means = xa.mean(dim=(1, 2))
    post_var = xa.reshape(R * K * S, P).var(dim=0, correction=1)
    return campaign_means, post_var


def gpirt_campaigns(
    data,
    n_campaigns: int = 8,
    *,
    n_chains: Optional[int] = None,
    sample_iterations: Optional[int] = None,
    burn_iterations: Optional[int] = None,
    smc_steps: Optional[int] = None,
    smc_max_temp: Optional[float] = None,
    threshold_method: Optional[str] = None,
    SEED: int = 1,
    vote_codes=...,
    beta_prior_means: Optional[np.ndarray] = None,
    beta_prior_sds: Optional[np.ndarray] = None,
    theta_prior_means: Optional[np.ndarray] = None,
    theta_prior_sds: Optional[np.ndarray] = None,
    theta_os: float = 1.0,
    theta_ls: float = 10.0,
    KERNEL: str = "Matern",
    thresholds: Optional[np.ndarray] = None,
    dtype: str = "float32",
    grid_size: int = 1001,
    jitter: Optional[float] = None,
    store_draws: bool = True,
    verbose: bool = True,
    device="cuda",
    mesh=None,
    chunk_iterations: int = 250,
) -> Dict[str, Any]:
    """Posterior estimation by R = ``n_campaigns`` independent SMC campaigns.

    Each campaign runs ``campaign_schedule(C)`` (any field overridden by
    the keyword of its name); campaign r's annealing draws come from a
    generator seeded SEED + r K, the sampling run's from one seeded
    SEED + R K. Every chain of every campaign starts from the same K
    permutations of linspace(-2, 2, n), drawn with numpy seeded SEED. Data
    handling is ``gpirt_mcmc``'s (vote-code recoding, priors, qnorm
    cutpoints). The run is on the CUDA card unless ``device`` says
    otherwise; without a card it raises. ``mesh``, a ``DeviceMesh`` with a
    ``"campaigns"`` axis (``parallel.chains.make_campaign_mesh``; every rank
    calls this with the same arguments), shards the campaigns over it
    (``n_campaigns`` must divide over its size, else ``ValueError``); every
    rank returns the unsharded call's dict, and prints only on rank 0.
    ``chunk_iterations`` (at least 1) is JAX's argument
    (``gpirt_tpu/campaigns.py:287``), which bounds its sampling run's device
    executions; eager PyTorch has none to bound and no progress to report,
    so the run here is one, and the draws do not depend on it.

    Returns a dict:
      theta_mean (n, H) the sign-aligned grand posterior mean;
      theta_se (n, H) its campaign-replicated standard error,
        sqrt(var over campaigns of the campaign means / R);
      campaign_means (R, n, H);
      ess_campaign (n, H) the implied ESS of the grand mean, posterior
        variance / theta_se^2, and ess_campaign_median its median;
      pooled_ess_per_campaign (R,) each campaign's median pooled ESS;
      final_weight_ess (R,), n_resamples (R,) of the anneal;
      walls {"smc_sec", "sampling_sec", "total_sec"}; schedule, the resolved
        schedule with n_campaigns;
      draws (with ``store_draws``): theta (R, K, S, n, H), ll (R, K, S),
        threshold (R, K, S, m, C+1, H), beta (R, K, S, 3, m, H);
      respondents / items, the labels when the data carried them.
    """
    if chunk_iterations < 1:
        raise ValueError(f"chunk_iterations must be >= 1, got {chunk_iterations}")
    prob = _problem(
        data, n_campaigns, n_chains=n_chains, sample_iterations=sample_iterations,
        burn_iterations=burn_iterations, smc_steps=smc_steps, smc_max_temp=smc_max_temp,
        threshold_method=threshold_method, SEED=SEED, vote_codes=vote_codes,
        beta_prior_means=beta_prior_means, beta_prior_sds=beta_prior_sds,
        theta_prior_means=theta_prior_means, theta_prior_sds=theta_prior_sds,
        theta_os=theta_os, theta_ls=theta_ls, KERNEL=KERNEL, thresholds=thresholds,
        dtype=dtype, grid_size=grid_size, jitter=jitter, device=device, mesh=mesh,
        verbose=verbose and (mesh is None or dist.get_rank() == 0))
    t0 = time.perf_counter()
    info, draws, walls = _campaign_draws(
        prob, None if mesh is None else campaign_shards(mesh))
    return _campaign_result(prob, info, draws, walls, t0, store_draws)


class _Problem(NamedTuple):
    """What every campaign of a call runs on (:func:`_problem`): the
    responses (H, n, m), the K chains' inits (K, H, n), the cutpoints, the
    constants and config, the schedule, R, SEED, the labels and whether to
    print."""

    y: torch.Tensor
    theta_init: torch.Tensor
    thresholds: torch.Tensor
    consts: Any
    config: GPIRTConfig
    sched: Dict[str, Any]
    R: int
    seed: int
    row_names: Any
    col_names: Any
    verbose: bool


def _problem(data, n_campaigns: int = 8, *, n_chains=None, sample_iterations=None,
             burn_iterations=None, smc_steps=None, smc_max_temp=None, threshold_method=None,
             SEED: int = 1, vote_codes=..., beta_prior_means=None, beta_prior_sds=None,
             theta_prior_means=None, theta_prior_sds=None, theta_os: float = 1.0,
             theta_ls: float = 10.0, KERNEL: str = "Matern", thresholds=None,
             dtype: str = "float32", grid_size: int = 1001, jitter=None, device="cuda",
             mesh=None, verbose: bool = False) -> _Problem:
    """:func:`gpirt_campaigns`' data handling, schedule, constants (built
    on rank 0 of a ``mesh`` and broadcast) and inits, on ``device``; its
    arguments and defaults are that function's."""
    device = _device(device, "gpirt_campaigns")
    full_fp32_matmuls()
    if vote_codes is ...:
        vote_codes = DEFAULT_VOTE_CODES
    if vote_codes is not None:
        data = _strip_h(data)
        if np.asarray(data).ndim == 3:
            data = recode_cube(data, vote_codes, verbose=verbose)
        else:
            data = as_response_matrix(data, vote_codes, verbose=verbose)
    row_names = getattr(data, "row_names", None)
    col_names = getattr(data, "col_names", None)

    y, C, _ = encode_categories(_as_cube(data))  # (H, n, m)
    H, n, m = y.shape

    sched = campaign_schedule(C)
    for key, val in (("n_chains", n_chains), ("sample_iterations", sample_iterations),
                     ("burn_iterations", burn_iterations), ("smc_steps", smc_steps)):
        if val is not None:
            sched[key] = int(val)
    if smc_max_temp is not None:
        sched["smc_max_temp"] = float(smc_max_temp)
    if threshold_method is not None:
        sched["threshold_method"] = threshold_method
    K, R = sched["n_chains"], int(n_campaigns)
    if R < 2:
        raise ValueError(
            "n_campaigns must be >= 2: the campaign-replicated standard "
            "error is the across-campaign variance, undefined for one "
            "campaign (for a single run use gpirt_mcmc)")

    beta_prior_means, beta_prior_sds = _beta_priors(beta_prior_means, beta_prior_sds, m)
    theta_prior_means = np.broadcast_to(np.asarray(
        np.zeros((2, n)) if theta_prior_means is None else theta_prior_means,
        np.float64), (2, n))
    theta_prior_sds = np.broadcast_to(np.asarray(
        np.zeros((2, n)) if theta_prior_sds is None else theta_prior_sds,
        np.float64), (2, n))
    config = GPIRTConfig(
        n=n, m=m, horizon=H, C=C, grid_size=grid_size, theta_os=float(theta_os),
        theta_ls=float(theta_ls), kernel=KERNEL, dtype=dtype,
        threshold_method=sched["threshold_method"],
        jitter=jitter if jitter is not None else (1e-6 if dtype == "float64" else 1e-5))
    if mesh is None or dist.get_rank() == 0:
        consts = _cached_constants(config, device, beta_prior_means, beta_prior_sds,
                                   theta_prior_means, theta_prior_sds)
    if mesh is not None:  # built once, the same bits on every rank
        consts = broadcast_constants(consts if dist.get_rank() == 0 else None, device,
                                     config.tdtype)
    thr = (default_thresholds(C, m, H) if thresholds is None else
           _coerce_thresholds(np.asarray(thresholds, np.float64), m, C, H))

    # overdispersed per-chain inits, shared by the campaigns: campaigns differ
    # only in their draws
    rng = np.random.default_rng(SEED)
    theta_init = np.clip(np.stack([
        np.broadcast_to(rng.permutation(np.linspace(-2, 2, n))[None], (H, n))
        for _ in range(K)]), THETA_LO, THETA_HI)

    def tensor(a, dt=config.tdtype):
        return torch.as_tensor(np.array(a, order="C"), dtype=dt, device=device)

    return _Problem(tensor(y, torch.int32), tensor(theta_init), tensor(thr), consts, config,
                    sched, R, int(SEED), row_names, col_names, verbose)


def _campaign_draws(prob: _Problem, shards: Optional[Shards] = None):
    """Anneal the campaigns, then sample them as one ``run_chains`` over
    their R K lanes, campaign-major. ``shards`` (a campaign axis's place,
    ``parallel.chains.campaign_shards``) runs this rank's campaigns and
    gathers their info rows and draws in campaign order; without its
    process group it runs and returns only its campaigns', as that rank
    computes them. Returns (info, draws, {"smc_sec", "sampling_sec"})."""
    sched, R, K = prob.sched, prob.R, prob.theta_init.shape[0]
    device = prob.y.device

    def generator(seed):
        return torch.Generator(device=device).manual_seed(seed)

    t0 = time.perf_counter()
    states, info = anneal_init_batched(
        [generator(prob.seed + r * K) for r in range(R)], prob.y, prob.theta_init,
        prob.thresholds, prob.consts, prob.config, n_steps=sched["smc_steps"],
        max_temp=sched["smc_max_temp"], shards=shards)
    _sync(device)
    smc_sec = time.perf_counter() - t0
    if prob.verbose:
        we = info["final_weight_ess"]
        print(f"[gpirt] {R} campaigns annealed ({sched['smc_steps']} steps from "
              f"T={sched['smc_max_temp']:g}): {smc_sec:.2f}s, final weight-ESS "
              f"min/med {we.min():.1f}/{np.median(we):.1f}/{K}", file=sys.stderr)

    # sampling: the campaigns are independent lanes, campaign-major, this
    # rank's campaigns' block of them on a campaign axis
    t1 = time.perf_counter()
    draws = run_chains(
        generator(prob.seed + R * K), prob.y, prob.theta_init.repeat(R, 1, 1),
        prob.thresholds, prob.consts, prob.config,
        sample_iterations=sched["sample_iterations"],
        burn_iterations=sched["burn_iterations"],
        initial_states=GPIRTState(*(a.reshape((-1,) + a.shape[2:]) for a in states)),
        mesh=shards)
    _sync(device)
    return info, draws, {"smc_sec": smc_sec, "sampling_sec": time.perf_counter() - t1}


def _campaign_result(prob: _Problem, info, draws, walls, t0: float,
                     store_draws: bool) -> Dict[str, Any]:
    """:func:`gpirt_campaigns`' dict from every campaign's anneal ``info``
    and sampling ``draws`` (R K lanes), the estimator on the draws'
    device; ``t0`` is the anneal's start on the host's clock."""
    sched, R, K = prob.sched, prob.R, prob.theta_init.shape[0]
    H, n, m = prob.y.shape
    C = prob.config.C
    S = draws["theta"].shape[1]
    P = H * n
    # one memory layout whatever assembled the draws (one run's transposed
    # records, or the campaign axis's gathered blocks): the estimator's
    # reductions follow the layout, and a card rounds each order otherwise
    theta_dev = draws["theta"].reshape(R * K, S, P).contiguous()
    cm_d, pv_d = _campaign_estimator(theta_dev, R, K, S, P)
    pooled_d = effective_sample_size_device(theta_dev.reshape(R, K, S, P))
    campaign_means = cm_d.cpu().double().numpy().reshape(R, H, n)
    post_var = pv_d.cpu().double().numpy().reshape(H, n)
    pooled = np.median(pooled_d.cpu().numpy(), axis=1)  # (R,)

    grand_mean = campaign_means.mean(axis=0)  # (H, n)
    # campaigns are iid replicates of the whole estimator: var / R
    se = np.sqrt(campaign_means.var(axis=0, ddof=1) / R)
    # implied ESS of the grand mean: var(estimate) = posterior var / ESS
    ess_campaign = post_var / np.maximum(se * se, 1e-300)
    ess_med = float(np.median(ess_campaign))
    total_sec = time.perf_counter() - t0
    if prob.verbose:
        print(f"[gpirt] campaign estimator: {R} x ({sched['smc_steps']} smc + "
              f"{sched['burn_iterations']}+{S} sweeps x {K} chains), sampling "
              f"{walls['sampling_sec']:.2f}s; implied campaign ESS median {ess_med:.1f}, "
              f"theta SE median {np.median(se):.4f} (single-run pooled basis "
              f"would claim {np.median(pooled):.0f}/campaign)", file=sys.stderr)

    out: Dict[str, Any] = {
        "theta_mean": np.moveaxis(grand_mean, 0, -1),  # (n, H)
        "theta_se": np.moveaxis(se, 0, -1),
        "campaign_means": np.moveaxis(campaign_means, 1, -1),  # (R, n, H)
        "ess_campaign": np.moveaxis(ess_campaign, 0, -1),
        "ess_campaign_median": ess_med,
        "pooled_ess_per_campaign": pooled,
        "final_weight_ess": np.asarray(info["final_weight_ess"]),
        "n_resamples": np.asarray(info["n_resamples"]),
        "walls": dict(walls, total_sec=total_sec),
        "schedule": dict(sched, n_campaigns=R),
    }
    if store_draws:  # raw (unaligned) draws
        host = {k: v.cpu().numpy() for k, v in draws.items()}
        out["draws"] = {
            "theta": np.moveaxis(host["theta"].reshape(R, K, S, H, n), 3, -1),
            "ll": host["ll"].reshape(R, K, S),
            "threshold": np.moveaxis(host["threshold"].reshape(R, K, S, H, m, C + 1), 3, -1),
            "beta": np.moveaxis(host["beta"].reshape(R, K, S, H, 3, m), 3, -1),
        }
    if prob.row_names is not None:
        out["respondents"] = list(prob.row_names)
    if prob.col_names is not None:
        out["items"] = list(prob.col_names)
    return out
