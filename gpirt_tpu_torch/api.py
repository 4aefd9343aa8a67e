"""Public user API: ``gpirt_mcmc``, ``recover_fstar`` and
``recover_fstar_batch`` on the port's slice.

Counterpart of ``gpirt_tpu/api.py`` for binary and ordinal data, one
session or an (n, m, H) cube of sessions, on one device: vote-code
recoding, prior and cutpoint defaults, the time-GP settings, one item
response function a session or one shared by all (``constant_IRF``), the
conjugate, grid or two-stage sampler, K chains in lockstep, an optional SMC annealed
initialization or parallel tempering, optional f / f* storage, the
reference output layout (``gpirt_tpu/api.py:606``), an end-of-run
convergence summary, checkpoints that resume a run bit for bit, and f*
recovered from stored f draws, on one device or with the chains, the
items and the respondents spread over the ranks of a ``torch.distributed``
``DeviceMesh``. The host constants are built once per configuration,
priors and device. ``prng_impl``, JAX's choice of key implementation,
has no meaning for a ``torch.Generator`` and raises ``NotImplementedError``.
"""

from __future__ import annotations

import statistics
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from gpirt_tpu_torch.models.config import (
    THETA_HI,
    THETA_LO,
    GPIRTConfig,
    GPIRTConstants,
    make_constants,
)
from gpirt_tpu_torch.models.gibbs import (
    compute_mu,
    draw_f,
    draw_fstar,
    f_draws,
    fstar_draws,
    snap_indices,
    stored_fstar,
)
from gpirt_tpu_torch.models.sampler import memory_estimate_mb, sample_schedule
from gpirt_tpu_torch.parallel.chains import shards_of
from gpirt_tpu_torch.parallel.distributed import broadcast_constants
from gpirt_tpu_torch.parallel.items import check_item_config
from gpirt_tpu_torch.parallel.respondents import check_respondent_config, shard_generators
from gpirt_tpu_torch.parallel.smc import anneal_init
from gpirt_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    run_chains_checkpointed,
    run_tempered_chains_checkpointed,
)
from gpirt_tpu_torch.utils.diagnostics import align_theta_signs, basin_clusters, summarize
from gpirt_tpu_torch.utils.response import (
    DEFAULT_VOTE_CODES,
    as_response_matrix,
    encode_categories,
    recode_cube,
)

__all__ = [
    "gpirt_mcmc",
    "recover_fstar",
    "recover_fstar_batch",
    "default_thresholds",
    "full_fp32_matmuls",
]

# Host constants (the float64 grid Gram, its Cholesky and the SE
# eigendecomposition: about a minute at a 10001-point grid) are kept across
# calls with the same configuration, priors and device.
_CONSTS_CACHE: Dict[tuple, GPIRTConstants] = {}
_CONSTS_CACHE_MAX = 8


def full_fp32_matmuls() -> None:
    """Run float32 products in full float32, never TF32: the reference's
    contractions all use Precision.HIGHEST (gibbs.py:1622-1626 and others),
    since reduced-precision products measurably biased the theta table and
    the truncation bounds."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def default_thresholds(C: int, m: int, horizon: int) -> np.ndarray:
    """Equal-prior-mass cutpoints at qnorm(i/C) (R/gpirtMCMC.R:137-155):
    (H, m, C+1) with -inf/+inf endpoints."""
    thr = np.zeros((horizon, m, C + 1))
    thr[..., 0] = -np.inf
    thr[..., C] = np.inf
    for i in range(1, C):
        thr[..., i] = statistics.NormalDist().inv_cdf(i / C)
    return thr


def _coerce_thresholds(thr: np.ndarray, m: int, C: int, H: int) -> np.ndarray:
    """Accept (C+1,), (m, C+1), or (m, C+1, H) and return (H, m, C+1)."""
    if thr.ndim == 1:
        out = np.broadcast_to(thr, (H, m, thr.size))
    elif thr.ndim == 2:
        out = np.broadcast_to(thr[None], (H,) + thr.shape)
    elif thr.ndim == 3:
        out = np.ascontiguousarray(np.moveaxis(thr, 2, 0))
    else:
        raise ValueError(f"bad thresholds shape {thr.shape}")
    if out.shape != (H, m, C + 1):
        raise ValueError(f"thresholds shape {thr.shape} incompatible with "
                         f"(m={m}, C+1={C + 1}, H={H})")
    return out


def _to_reference_layout(draws: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Internal (S, H, ...) layouts -> trailing-horizon reference layouts:
    theta (S, n, H), beta (S, 3, m, H), threshold (S, m, C+1, H),
    f (S, n, m, H), fstar (S, N, m, H), ll (S,)."""
    out: Dict[str, np.ndarray] = {}
    for k, a in draws.items():
        if k == "theta":
            out[k] = np.moveaxis(a, 1, 2)
        elif k in ("beta", "threshold", "f", "fstar"):
            out[k] = np.moveaxis(a, 1, 3)
        else:
            out[k] = a
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device(device, caller: str) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{caller} runs on a CUDA device, and torch.cuda.is_available() "
            "is false; pass device='cpu' to run on the CPU")
    return device


def _cached_constants(config: GPIRTConfig, device: torch.device, beta_prior_means,
                      beta_prior_sds, theta_prior_means,
                      theta_prior_sds) -> GPIRTConstants:
    """:func:`make_constants`, built once per configuration, priors and
    device (``gpirt_tpu/api.py:51``)."""
    priors = (beta_prior_means, beta_prior_sds, theta_prior_means, theta_prior_sds)
    key = (config, str(device)) + tuple(
        np.ascontiguousarray(a, np.float64).tobytes() for a in priors)
    if key not in _CONSTS_CACHE:
        if len(_CONSTS_CACHE) >= _CONSTS_CACHE_MAX:
            _CONSTS_CACHE.pop(next(iter(_CONSTS_CACHE)))
        _CONSTS_CACHE[key] = make_constants(config, *priors, device=device)
    return _CONSTS_CACHE[key]


def _beta_priors(beta_prior_means, beta_prior_sds, m: int):
    """The beta prior means and sds as (3, m) float64, N(0, 3^2) by default."""
    if beta_prior_means is None:
        beta_prior_means = np.zeros((3, m))
    if beta_prior_sds is None:
        beta_prior_sds = np.full((3, m), 3.0)
    return (np.broadcast_to(np.asarray(beta_prior_means, np.float64), (3, m)),
            np.broadcast_to(np.asarray(beta_prior_sds, np.float64), (3, m)))


def gpirt_mcmc(
    data,
    sample_iterations: int,
    burn_iterations: int,
    THIN: int = 1,
    CHAIN: int = 1,
    vote_codes: Optional[Dict[str, Sequence]] = DEFAULT_VOTE_CODES,
    beta_prior_means: Optional[np.ndarray] = None,
    beta_prior_sds: Optional[np.ndarray] = None,
    theta_prior_means: Optional[np.ndarray] = None,
    theta_prior_sds: Optional[np.ndarray] = None,
    theta_os: float = 1.0,
    theta_ls: float = 10.0,
    KERNEL: str = "Matern",
    theta_init: Optional[np.ndarray] = None,
    thresholds: Optional[np.ndarray] = None,
    SEED: int = 1,
    constant_IRF: int = 0,
    store_f: bool = False,
    store_fstar: bool = False,
    *,
    threshold_method: str = "auto",
    threshold_ess_every: int = 4,
    threshold_mh_tries: int = 2,
    theta_method: str = "grid",
    mix_subsweeps: int = 1,
    f_method: str = "auto",
    fstar_method: str = "matheron",
    grid_size: int = 1001,
    jitter: Optional[float] = None,
    mesh: Optional[DeviceMesh] = None,
    item_axis: Optional[str] = None,
    respondent_axis: Optional[str] = None,
    n_temps: int = 1,
    max_temp: float = 4.0,
    swap_every: int = 1,
    smc_steps: int = 0,
    smc_max_temp: float = 64.0,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 200,
    chunk_iterations: int = 250,
    dtype: str = "float32",
    device="cuda",
    verbose: bool = True,
    **unsupported,
) -> List[Dict[str, np.ndarray]]:
    """Posterior samples for the GP-IRT model; one dict per chain.

    Argument semantics follow ``gpirt_tpu.api.gpirt_mcmc``: ``data`` is
    (n, m) or an (n, m, H) cube of H sessions; ``vote_codes`` recodes raw
    votes (None: data already coded 1..C, NaN missing, which is how ordinal
    data comes in; a cube is recoded as a whole, an item unanimous over all
    sessions dropped), default priors are beta N(0, 3^2) and theta prior
    means/sds of zero, cutpoints start at ``thresholds`` ((C+1,), (m, C+1)
    or (m, C+1, H)) or else at qnorm(i/C). ``theta_os``, ``theta_ls`` and
    ``KERNEL`` ("Matern" or "RBF") set the time GP over sessions, and
    ``theta_ls`` picks the theta regime (``GPIRTConfig.theta_regime``).
    Chain c's theta init is drawn from numpy's generator seeded SEED + c;
    a given ``theta_init`` of shape (n,) or (n, 1) is copied across
    sessions, one of shape (n, H) is taken as it is, and every chain starts
    from it.
    ``threshold_method`` is "auto" / "ess" (the y-marginal delta ESS),
    "newton" (``threshold_mh_tries`` Newton-proposal MH tries on the same
    conditional), or, on the conjugate path, "collapsed" (the exact draw
    given the Albert-Chib latents) or "interleave" (the ESS every
    ``threshold_ess_every``-th sweep, collapsed otherwise).
    ``theta_method`` is "grid" (the exact grid draw) or "ess" (the
    reference code's ESS and snap; not with ``smc_steps`` or ``n_temps``,
    which temper). ``mix_subsweeps`` repeats each sweep's latent pass. A
    nonzero ``constant_IRF`` shares one item response
    function (f* and the cutpoints) across the sessions. ``f_method`` is
    "auto" (Albert-Chib, or "grid" under ``constant_IRF``), "conjugate",
    "grid" (one ESS on each item's grid function f*) or "two_stage" (the
    reference's ESS on f, then f* | f by ``fstar_method``, "matheron" or
    "chol"); ``grid_size`` is the theta grid's N; ``jitter`` the model
    nugget (1e-6 in float64 and 1e-5 in float32 by default). The
    (cutpoint, intercept) shift and the affine moves are ``GPIRTConfig``
    fields only, run through ``run_chains``, as in the JAX package. All sampler
    randomness comes from one ``torch.Generator`` on ``device`` seeded with
    SEED. ``smc_steps > 0`` prepends the SMC annealed initialization from
    ``smc_max_temp`` (conjugate only). ``n_temps > 1`` runs each chain as a
    parallel-tempering group of ``n_temps`` lanes on a geometric ladder up
    to ``max_temp``, with adjacent swaps every ``swap_every`` sweeps
    (conjugate only, not with ``smc_steps``); the draws are the cold lanes'.
    ``checkpoint_path`` saves the run to ``f"{checkpoint_path}.npz"`` every
    ``checkpoint_every`` sweeps (``utils/checkpoint.py``) and resumes it
    from there when the file exists: the SMC initialization then does not
    run again, and the result is bit for bit the uninterrupted call's on
    the same device type, card and torch build. Without a checkpoint a
    verbose run advances ``chunk_iterations`` sweeps at a time (JAX's
    default, 250) and prints its progress line at each chunk's end, as JAX
    does; the draws do not depend on it.
    ``mesh``, a ``torch.distributed`` ``DeviceMesh`` (every rank calls
    ``gpirt_mcmc`` with the same arguments), spreads the chains over its
    "chains" axis; ``item_axis`` names a mesh axis that also shards the
    items (``parallel/items.py``; conjugate sampler, m divisible by its
    size), e.g. ``make_item_mesh(2)``, and
    ``respondent_axis`` one that shards the respondents
    (``parallel/respondents.py``; conjugate sampler, n divisible by its
    size), e.g. ``make_respondent_mesh(2)``, alone or beside the other two.
    On a chain mesh the draws are the unsharded run's chain for chain;
    under a model axis the shard-local draws come from each shard's own
    stream. Every rank returns the same chain dicts, and prints only on
    rank 0. Tempering (``n_temps``) runs on any of these meshes, each
    group's ``n_temps`` lanes on one chain shard (``CHAIN`` must divide
    over the chain shards; ``parallel/tempering.py``).
    ``verbose`` prints the reference's memory table, the recode's
    messages, the SMC line, the checkpointed run's progress and the
    end-of-run convergence summary (theta ESS, R-hat, basins) to stderr.
    The run is on the CUDA card unless ``device`` says otherwise (on a
    mesh, the rank's card); without a card it raises.

    Each dict holds theta (S, n, H), beta (S, 3, m, H), threshold
    (S, m, C+1, H) and ll (S,); f (S, n, m, H) with ``store_f`` and fstar
    (S, N, m, H), f* plus its parametric mean (session 0's under
    ``constant_IRF``), with ``store_fstar``;
    "swap_rate" (n_temps - 1,) under tempering; "respondents" / "items"
    when the data carried labels; and "seconds", this call's wall time of
    the SMC and sampling phases (device work included), with the
    checkpoints' saves ("checkpoint", part of "sampling") when
    checkpointed.
    """
    if unsupported:
        raise NotImplementedError(
            "gpirt_mcmc arguments not ported to gpirt_tpu_torch yet: "
            + ", ".join(sorted(unsupported)))
    if n_temps > 1 and smc_steps > 0:
        raise ValueError(
            "smc_steps and n_temps > 1 are mutually exclusive (SMC annealing "
            "and fixed-ladder tempering are alternative basin strategies)")
    if chunk_iterations < 1:
        raise ValueError(f"chunk_iterations must be >= 1, got {chunk_iterations}")
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, got "
                        f"{type(mesh).__name__}")
    axes = () if mesh is None else (mesh.mesh_dim_names or ())
    if item_axis is not None and item_axis not in axes:
        raise ValueError(f"item_axis={item_axis!r} needs a mesh with that axis name "
                         "(e.g. parallel.items.make_item_mesh)")
    if respondent_axis is not None and respondent_axis not in axes:
        raise ValueError(f"respondent_axis={respondent_axis!r} needs a mesh with that axis "
                         "name (e.g. parallel.respondents.make_respondent_mesh)")
    device = _device(device, "gpirt_mcmc")
    full_fp32_matmuls()
    shards = shards_of(mesh, item_axis, respondent_axis)
    # a verbose call advances in chunks to print its progress; every rank of
    # a mesh chunks alike (a chunk ends in collectives), printing on rank 0
    chunks = chunk_iterations if verbose else None
    verbose = verbose and (mesh is None or dist.get_rank() == 0)

    if vote_codes is not None:
        data = _strip_h(data)
        if np.asarray(data).ndim == 3:
            data = recode_cube(data, vote_codes, verbose=verbose)
        else:
            data = as_response_matrix(data, vote_codes, verbose=verbose)
    row_names = getattr(data, "row_names", None)
    col_names = getattr(data, "col_names", None)

    cube = np.asarray(data, dtype=np.float64)
    if cube.ndim == 2:
        cube = cube[:, :, None]
    y, C, _ = encode_categories(cube)  # (H, n, m)
    H, n, m = y.shape

    beta_prior_means, beta_prior_sds = _beta_priors(beta_prior_means, beta_prior_sds, m)
    if theta_prior_means is None:
        theta_prior_means = np.zeros((2, n))
    if theta_prior_sds is None:
        theta_prior_sds = np.zeros((2, n))
    theta_prior_means = np.broadcast_to(np.asarray(theta_prior_means, np.float64), (2, n))
    theta_prior_sds = np.broadcast_to(np.asarray(theta_prior_sds, np.float64), (2, n))

    config = GPIRTConfig(n=n, m=m, horizon=H, C=C, grid_size=grid_size, dtype=dtype,
                         theta_os=float(theta_os), theta_ls=float(theta_ls),
                         kernel=KERNEL, constant_IRF=bool(constant_IRF),
                         jitter=jitter if jitter is not None else (
                             1e-6 if dtype == "float64" else 1e-5),
                         threshold_method=threshold_method,
                         threshold_ess_every=threshold_ess_every,
                         threshold_mh_tries=threshold_mh_tries,
                         theta_method=theta_method, mix_subsweeps=mix_subsweeps,
                         f_method=f_method, fstar_method=fstar_method)
    check_item_config(config, shards)
    check_respondent_config(config, shards)
    shards.items(m), shards.respondents(n), shards.chains(CHAIN)  # each must divide
    if mesh is None or dist.get_rank() == 0:
        consts = _cached_constants(config, device, beta_prior_means, beta_prior_sds,
                                   theta_prior_means, theta_prior_sds)
    if mesh is not None:  # built once, the same bits on every rank
        consts = broadcast_constants(consts if dist.get_rank() == 0 else None, device,
                                     config.tdtype)
    if verbose:
        _print_memory_estimate(n, m, H, C, sample_schedule(
            sample_iterations, burn_iterations, THIN).n_samples, sample_iterations,
            grid_size, store_f, store_fstar)

    # per-chain theta inits ~ N(prior mean, prior sd), copied across sessions
    inits = []
    for chain in range(CHAIN):
        if theta_init is None:
            rng = np.random.default_rng(SEED + chain)
            t0 = theta_prior_means[0] + theta_prior_sds[0] * rng.standard_normal(n)
            th = np.broadcast_to(t0[None, :], (H, n))
        else:
            ti = np.asarray(theta_init, np.float64)
            th = (ti[:, None] if ti.ndim == 1 else ti).T  # (H or 1, n)
            th = np.broadcast_to(th, (H, n))
        inits.append(np.clip(th, THETA_LO, THETA_HI))

    def tensor(a, dt=config.tdtype):
        return torch.as_tensor(np.array(a, order="C"), dtype=dt, device=device)

    yt = tensor(y, torch.int32)
    th_inits = tensor(np.stack(inits))  # (CHAIN, H, n)
    if thresholds is None:
        thr_init = tensor(default_thresholds(C, m, H))
    else:
        thr_init = tensor(_coerce_thresholds(np.asarray(thresholds, np.float64),
                                             m, C, H))
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    # a shard's own streams for its shard-local numbers (parallel/items.py,
    # parallel/respondents.py)
    sharding = dict(mesh=mesh, item_axis=item_axis, respondent_axis=respondent_axis,
                    shard_gens=shard_generators(SEED, shards, device))

    mgr = None if checkpoint_path is None else CheckpointManager(f"{checkpoint_path}.npz")
    t0 = time.perf_counter()
    states = None
    if smc_steps > 0 and (mgr is None or not mgr.exists()):  # a resume does not anneal
        states, info = anneal_init(gen, yt, th_inits, thr_init, consts, config,
                                   n_steps=smc_steps, max_temp=smc_max_temp, **sharding)
        if verbose:
            print(f"[gpirt] SMC init: {smc_steps} steps from T={smc_max_temp}, "
                  f"{info['n_resamples']} resamples, final weight-ESS "
                  f"{info['final_weight_ess']:.1f}/{CHAIN}", file=sys.stderr)
    _sync(device)
    t1 = time.perf_counter()
    run = dict(sample_iterations=sample_iterations, burn_iterations=burn_iterations,
               thin=THIN, store_f=store_f, store_fstar=store_fstar)
    # without a manager the drivers run as run_chains / run_tempered_chains
    run.update(manager=mgr, checkpoint_every=checkpoint_every, chunk_iterations=chunks,
               on_progress=_print_progress if verbose else None)
    if n_temps > 1:
        host = run_tempered_chains_checkpointed(
            gen, yt, th_inits, thr_init, consts, config, n_temps=n_temps,
            max_temp=max_temp, swap_every=swap_every, **run, **sharding)
    else:
        host = run_chains_checkpointed(gen, yt, th_inits, thr_init, consts, config,
                                       initial_states=states, **run, **sharding)
    t2 = time.perf_counter()
    swap_rate = host.pop("swap_rate", None)
    seconds = {"smc": t1 - t0, "sampling": t2 - t1}
    if mgr is not None:
        seconds["checkpoint"] = mgr.seconds
    out = []
    for c in range(CHAIN):
        d = _to_reference_layout({k: v[c] for k, v in host.items()})
        if swap_rate is not None:
            d["swap_rate"] = swap_rate
        if row_names is not None:
            d["respondents"] = list(row_names)
        if col_names is not None:
            d["items"] = list(col_names)
        d["seconds"] = dict(seconds)
        out.append(d)
    if verbose and CHAIN > 1 and out[0]["theta"].shape[0] >= 8:
        _print_convergence_summary(out)
    return out


def _print_progress(done: int, total: int) -> None:
    print(f"[gpirt] {done}/{total} iterations ({100.0 * done / total:.0f}%)",
          file=sys.stderr)


def _print_memory_estimate(n, m, H, C, n_samples, sample_iterations, grid_size,
                           store_f, store_fstar) -> None:
    """The reference's memory table on stderr, in ``gpirt_tpu/api.py:626``'s
    words (src/gpirtMCMC.cpp:60-82)."""
    est = memory_estimate_mb(n, m, H, C, n_samples, grid_size, store_f, store_fstar)
    e = sys.stderr
    print("\n=== MEMORY ESTIMATE ===", file=e)
    print(f"Samples to store: {n_samples} (thinned from {sample_iterations})", file=e)
    print(f"Theta samples:     {est['theta']:.3f} MB", file=e)
    print(f"Beta samples:      {est['beta']:.3f} MB", file=e)
    print(f"F samples:         {est['f']:.3f} MB "
          f"({'ENABLED' if store_f else 'DISABLED - will skip'})", file=e)
    print(f"Fstar samples:     {est['fstar']:.3f} MB "
          f"({'ENABLED' if store_fstar else 'DISABLED - will skip'})", file=e)
    print(f"Threshold samples: {est['threshold']:.3f} MB", file=e)
    print(f"TOTAL ESTIMATED:   {est['total']:.3f} MB ({est['total']/1024:.3f} GB)", file=e)
    if est["total"] > 10000:
        print("\nWARNING: Estimated memory usage exceeds 10 GB!", file=e)
        print("Consider: (1) Increase THIN parameter, (2) Reduce sample_iterations",
              file=e)
        print("          (3) Set store_f=False, (4) Set store_fstar=False\n", file=e)
    print("========================\n", file=e)


def _print_convergence_summary(chains) -> None:
    """The end-of-run convergence report on stderr (``gpirt_tpu/api.py:648``):
    theta ESS, tail ESS, split and rank-normalized R-hat of the
    sign-aligned draws of session 0, and the chains' posterior basins. It
    never breaks a finished run."""
    e = sys.stderr
    try:
        theta = np.stack([np.asarray(d["theta"])[:, :, 0] for d in chains])
        aligned = align_theta_signs(theta.reshape(-1, theta.shape[-1])).reshape(theta.shape)
        s = summarize(aligned)
        b = basin_clusters(aligned)
        print(f"[gpirt] theta ESS min/median {s['ess_min']:.0f}/"
              f"{s['ess_median']:.0f}, tail-ESS min {s['ess_tail_min']:.0f}, "
              f"split R-hat max {s['rhat_max']:.2f} "
              f"(rank-normalized {s['rhat_rank_max']:.2f})", file=e)
        if b["n_clusters"] > 1:
            print(f"[gpirt] chains occupy {b['n_clusters']} posterior basins "
                  f"(sizes {b['sizes']}, between-basin corr max "
                  f"{b['between_corr_max']:.2f}): high R-hat reflects multi-basin "
                  "structure, not (only) slow mixing; pooled estimates weight "
                  "basins by chain placement. SMC init (smc_steps=...) weights "
                  "basins correctly.", file=e)
    except Exception as exc:  # diagnostics must never break a finished run
        print(f"[gpirt] convergence summary skipped: {exc!r}", file=e)


def _strip_h(data):
    """An (n, m, 1) array as (n, m), so a one-session array takes the
    response-matrix recode; anything else as it is."""
    arr = np.asarray(data)
    if arr.ndim == 3 and arr.shape[2] == 1:
        return arr[:, :, 0]
    return data


def _as_cube(data) -> np.ndarray:
    """(n, m) or (n, m, H) float responses, NaN missing."""
    arr = np.asarray(data, dtype=np.float64)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3:
        raise ValueError(f"data must be (n, m) or (n, m, H); got {arr.shape}")
    return arr


def _recover_one(f, theta, beta, thresholds, y, consts: GPIRTConstants,
                 config: GPIRTConfig, f_rand, fstar_rand) -> torch.Tensor:
    """One seeded draw_f + draw_fstar pass a lane (the reference's
    recover_fstar core, src/recover_fstar.cpp:80-93;
    ``gpirt_tpu/api.py:782``), the lanes the leading axis: f (S, H, n, m),
    theta (S, H, n) as stored, beta (S, H, 3, m), thresholds (S, H, m, C+1);
    f_rand and fstar_rand the two blocks' draws for the S lanes.

    ``config.mean_degree == 1`` zeroes the quadratic coefficient, the
    reference's linear mean; the parametric mean takes the stored theta,
    f* the snapped one. Returns f* + mu* (S, H, N, m), session 0's mu*
    under constant_IRF (``gpirt_tpu/api.py:805-808``).
    """
    theta_idx = snap_indices(theta, config)
    if config.mean_degree == 1:
        beta = beta.clone()
        beta[..., 2, :] = 0.0
    mu = compute_mu(theta, beta)
    f_new = draw_f(f, theta_idx, thresholds, mu, y, consts, config, f_rand)
    fstar = draw_fstar(f_new, theta_idx, consts, config, fstar_rand)
    return stored_fstar(fstar, beta, consts, config)


def _recover(seed: int, y: np.ndarray, C: int, f, theta, beta, thresholds,
             beta_prior_means, beta_prior_sds, constant_IRF, dtype: str,
             grid_size: int, mean_degree: int, device) -> Dict[str, Any]:
    """f* of S stored draws in one batched pass on ``device``: y (H, n, m)
    categories, f (S, H, n, m), theta (S, H, n), beta (S, H, p, m) with
    p >= mean_degree + 1 rows, thresholds (S, H, m, C+1). Returns
    {"fstar": (S, H, N, m) numpy, "seconds": {"constants", "recovery"}}."""
    device = _device(device, "recover_fstar")
    full_fp32_matmuls()
    H, n, m = y.shape
    p = mean_degree + 1
    beta_mean = np.zeros(beta.shape[:2] + (3, m))
    beta_mean[:, :, :p] = beta[:, :, :p]
    beta_prior_means, beta_prior_sds = _beta_priors(beta_prior_means, beta_prior_sds, m)
    config = GPIRTConfig(n=n, m=m, horizon=H, C=C, grid_size=grid_size,
                         constant_IRF=bool(constant_IRF), dtype=dtype,
                         jitter=1e-6 if dtype == "float64" else 1e-5,
                         mean_degree=mean_degree)
    t0 = time.perf_counter()
    consts = _cached_constants(config, device, beta_prior_means, beta_prior_sds,
                               np.zeros((2, n)), np.zeros((2, n)))
    _sync(device)
    t1 = time.perf_counter()

    def tensor(a):
        return torch.as_tensor(np.array(a, order="C"), dtype=config.tdtype, device=device)

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    S = f.shape[0]
    fstar = _recover_one(
        tensor(f), tensor(theta), tensor(beta_mean), tensor(thresholds),
        torch.as_tensor(y, dtype=torch.int32, device=device), consts, config,
        f_draws(gen, S, consts, config), fstar_draws(gen, S, consts, config))
    out = fstar.cpu().numpy()
    t2 = time.perf_counter()
    return {"fstar": out, "seconds": {"constants": t1 - t0, "recovery": t2 - t1}}


def recover_fstar(
    seed: int,
    f: np.ndarray,
    data,
    theta: np.ndarray,
    beta: np.ndarray,
    thresholds: np.ndarray,
    beta_prior_means: Optional[np.ndarray] = None,
    beta_prior_sds: Optional[np.ndarray] = None,
    constant_IRF: int = 0,
    *,
    dtype: str = "float32",
    grid_size: int = 1001,
    mean_degree: int = 1,
    device="cuda",
) -> Dict[str, Any]:
    """f* of one stored f draw, redrawn under ``seed`` without f* having
    been stored during sampling (src/recover_fstar.cpp:8-94;
    ``gpirt_tpu/api.py:682``): one ESS draw of f, then f* | f.

    The reference uses a linear parametric mean here though its sampler's
    is quadratic; ``mean_degree=1`` reproduces that, 2 does not. A nonzero
    ``constant_IRF`` redraws the one shared f* from the stacked sites
    (inducing points, ``gpirt_tpu/models/gibbs.py:380``) and adds session
    0's mean to every session.

    Args:
      f: (n, m) or (n, m, H) stored latent draw.
      data: responses coded as the sampler saw them (ordinal 1..C or a
        response matrix, NaN missing); only the missing pattern matters.
      theta: (n,) or (n, H); beta: (p, m) or (p, m, H), p >= mean_degree + 1;
      thresholds: (C+1,), (m, C+1) or (m, C+1, H).

    Randomness comes from a ``torch.Generator`` on ``device`` seeded with
    ``seed``. The run is on the CUDA card unless ``device`` says otherwise;
    without a card it raises. Returns {"fstar": (N, m, H), "seconds":
    {"constants": host constants (0 when cached), "recovery": the rest}}.
    """
    y, C, _ = encode_categories(_as_cube(data))
    H, _, m = y.shape
    fa = np.asarray(f, np.float64)
    fa = fa[:, :, None] if fa.ndim == 2 else fa
    ta = np.asarray(theta, np.float64)
    ta = ta[:, None] if ta.ndim == 1 else ta
    ba = np.asarray(beta, np.float64)
    ba = ba[:, :, None] if ba.ndim == 2 else ba
    thr = _coerce_thresholds(np.asarray(thresholds, np.float64), m, C, H)
    out = _recover(seed, y, C, np.moveaxis(fa, 2, 0)[None], ta.T[None],
                   np.moveaxis(ba, 2, 0)[None], thr[None], beta_prior_means,
                   beta_prior_sds, constant_IRF, dtype, grid_size, mean_degree, device)
    return {"fstar": np.moveaxis(out["fstar"][0], 0, 2), "seconds": out["seconds"]}


def recover_fstar_batch(
    seed: int,
    samples: Dict[str, np.ndarray],
    data,
    beta_prior_means: Optional[np.ndarray] = None,
    beta_prior_sds: Optional[np.ndarray] = None,
    constant_IRF: int = 0,
    *,
    dtype: str = "float32",
    grid_size: int = 1001,
    mean_degree: int = 1,
    device="cuda",
) -> np.ndarray:
    """f* of every stored draw of one chain in one batched pass, the draw
    axis the lane axis (``gpirt_tpu/api.py:812``).

    Args:
      samples: a chain dict of ``gpirt_mcmc(..., store_f=True)``: "f"
        (S, n, m, H), "theta" (S, n, H), "beta" (S, 3, m, H) and
        "threshold" (S, m, C+1, H).
      data: responses coded as the sampler saw them.

    Draw s takes its numbers from one ``torch.Generator`` on ``device``
    seeded with ``seed``, as the s-th lane of the batch. Returns
    (S, N, m, H) f* draws, the parametric mean included.
    """
    y, C, _ = encode_categories(_as_cube(data))
    out = _recover(seed, y, C,
                   np.moveaxis(np.asarray(samples["f"], np.float64), 3, 1),
                   np.swapaxes(np.asarray(samples["theta"], np.float64), 1, 2),
                   np.moveaxis(np.asarray(samples["beta"], np.float64), 3, 1),
                   np.moveaxis(np.asarray(samples["threshold"], np.float64), 3, 1),
                   beta_prior_means, beta_prior_sds, constant_IRF, dtype, grid_size,
                   mean_degree, device)
    return np.moveaxis(out["fstar"], 1, 3)
