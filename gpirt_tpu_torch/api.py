"""Public user API: ``gpirt_mcmc`` on the port's slice.

Counterpart of ``gpirt_tpu/api.py::gpirt_mcmc`` for binary, single-session
data on one device: vote-code recoding, prior and cutpoint defaults, K
chains in lockstep, an optional SMC annealed initialization, and the
reference output layout (``gpirt_tpu/api.py:606``). Arguments the port does
not cover yet raise ``NotImplementedError``.
"""

from __future__ import annotations

import statistics
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from gpirt_tpu_torch.models.config import (
    THETA_HI,
    THETA_LO,
    GPIRTConfig,
    make_constants,
)
from gpirt_tpu_torch.models.sampler import run_chains
from gpirt_tpu_torch.parallel.smc import anneal_init
from gpirt_tpu_torch.utils.response import (
    DEFAULT_VOTE_CODES,
    as_response_matrix,
    encode_categories,
)

__all__ = ["gpirt_mcmc", "default_thresholds", "full_fp32_matmuls"]


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


def _to_reference_layout(draws: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Internal (S, H, ...) layouts -> trailing-horizon reference layouts:
    theta (S, n, H), beta (S, 3, m, H), threshold (S, m, C+1, H), ll (S,)."""
    out: Dict[str, np.ndarray] = {}
    for k, a in draws.items():
        if k == "theta":
            out[k] = np.moveaxis(a, 1, 2)
        elif k in ("beta", "threshold"):
            out[k] = np.moveaxis(a, 1, 3)
        else:
            out[k] = a
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
    theta_init: Optional[np.ndarray] = None,
    SEED: int = 1,
    *,
    smc_steps: int = 0,
    smc_max_temp: float = 64.0,
    dtype: str = "float32",
    device,
    **unsupported,
) -> List[Dict[str, np.ndarray]]:
    """Posterior samples for the binary GP-IRT model; one dict per chain.

    Argument semantics follow ``gpirt_tpu.api.gpirt_mcmc``: ``vote_codes``
    recodes raw votes (None: data already coded), default priors are beta
    N(0, 3^2) and theta prior means/sds of zero, and chain c's theta init
    is drawn from numpy's generator seeded SEED + c. All sampler randomness
    comes from one ``torch.Generator`` on ``device`` seeded with SEED.
    ``smc_steps > 0`` prepends the SMC annealed initialization from
    ``smc_max_temp``.

    Each dict holds theta (S, n, H), beta (S, 3, m, H), threshold
    (S, m, C+1, H) and ll (S,); "respondents" / "items" when the data
    carried labels; and "seconds", the wall time of the SMC and sampling
    phases (device work included).
    """
    if unsupported:
        raise NotImplementedError(
            "gpirt_mcmc arguments not ported to gpirt_tpu_torch yet: "
            + ", ".join(sorted(unsupported)))
    device = torch.device(device)
    full_fp32_matmuls()

    if vote_codes is not None:
        arr = np.asarray(data)
        if arr.ndim == 3 and arr.shape[2] == 1:
            data = arr[:, :, 0]
        if np.asarray(data).ndim != 2:
            raise NotImplementedError("multi-session data is not ported yet")
        data = as_response_matrix(data, vote_codes)
    row_names = getattr(data, "row_names", None)
    col_names = getattr(data, "col_names", None)

    cube = np.asarray(data, dtype=np.float64)
    if cube.ndim == 2:
        cube = cube[:, :, None]
    y, C, _ = encode_categories(cube)  # (H, n, m)
    H, n, m = y.shape

    if beta_prior_means is None:
        beta_prior_means = np.zeros((3, m))
    if beta_prior_sds is None:
        beta_prior_sds = np.full((3, m), 3.0)
    if theta_prior_means is None:
        theta_prior_means = np.zeros((2, n))
    if theta_prior_sds is None:
        theta_prior_sds = np.zeros((2, n))
    beta_prior_means = np.broadcast_to(np.asarray(beta_prior_means, np.float64), (3, m))
    beta_prior_sds = np.broadcast_to(np.asarray(beta_prior_sds, np.float64), (3, m))
    theta_prior_means = np.broadcast_to(np.asarray(theta_prior_means, np.float64), (2, n))
    theta_prior_sds = np.broadcast_to(np.asarray(theta_prior_sds, np.float64), (2, n))

    config = GPIRTConfig(n=n, m=m, horizon=H, C=C, dtype=dtype,
                         jitter=1e-6 if dtype == "float64" else 1e-5)
    consts = make_constants(config, beta_prior_means, beta_prior_sds,
                            theta_prior_means, theta_prior_sds, device=device)

    # per-chain theta inits ~ N(prior mean, prior sd), copied across sessions
    inits = []
    for chain in range(CHAIN):
        if theta_init is None:
            rng = np.random.default_rng(SEED + chain)
            t0 = theta_prior_means[0] + theta_prior_sds[0] * rng.standard_normal(n)
            th = np.broadcast_to(t0[None, :], (H, n))
        else:
            ti = np.asarray(theta_init, np.float64)
            th = (ti[:, None] if ti.ndim == 1 else ti).T
        inits.append(np.clip(th, THETA_LO, THETA_HI))

    def tensor(a, dt=config.tdtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)

    yt = tensor(y, torch.int32)
    th_inits = tensor(np.stack(inits))  # (CHAIN, H, n)
    thr_init = tensor(default_thresholds(C, m, H))
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)

    t0 = time.perf_counter()
    states = None
    if smc_steps > 0:
        states, info = anneal_init(gen, yt, th_inits, thr_init, consts, config,
                                   n_steps=smc_steps, max_temp=smc_max_temp)
        print(f"[gpirt] SMC init: {smc_steps} steps from T={smc_max_temp}, "
              f"{info['n_resamples']} resamples, final weight-ESS "
              f"{info['final_weight_ess']:.1f}/{CHAIN}", file=sys.stderr)
    _sync(device)
    t1 = time.perf_counter()
    draws = run_chains(gen, yt, th_inits, thr_init, consts, config,
                       sample_iterations=sample_iterations,
                       burn_iterations=burn_iterations, thin=THIN,
                       initial_states=states)
    _sync(device)
    t2 = time.perf_counter()
    host = {k: v.cpu().numpy() for k, v in draws.items()}
    out = []
    for c in range(CHAIN):
        d = _to_reference_layout({k: v[c] for k, v in host.items()})
        if row_names is not None:
            d["respondents"] = list(row_names)
        if col_names is not None:
            d["items"] = list(col_names)
        d["seconds"] = {"smc": t1 - t0, "sampling": t2 - t1}
        out.append(d)
    return out
