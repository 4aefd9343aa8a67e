"""Static configuration and precomputed constants for the port's sampler.

Counterpart of ``gpirt_tpu/models/config.py`` on one device: binary or
ordinal data (any C >= 2) over any number of sessions in the three theta
regimes, one item response function a session or one shared by every
session (``constant_IRF``), the Albert-Chib conjugate latent sampler, the
grid-native ESS on f*, and the reference's two-stage pipeline (ESS on f,
then f* | f by Matheron's rule or a posterior Cholesky), theta by the exact
grid draw or the reference code's ESS and snap, repeated latent passes
(``mix_subsweeps``), the cutpoints by the y-marginal ESS, Newton-proposal
MH, the collapsed draw given z or the interleave of the two, the
(cutpoints, intercept) shift, and the collective affine theta moves.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gpirt_tpu_torch.ops.kernels import icc_gram_np, time_gram_np
from gpirt_tpu_torch.ops.linalg import host_cholesky_f64

__all__ = ["GPIRTConfig", "GPIRTConstants", "make_constants", "THETA_LO", "THETA_HI"]

THETA_LO = -5.0
THETA_HI = 5.0

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class GPIRTConfig:
    """Static configuration (mirrors the reference sampler's arguments,
    src/gpirtMCMC.cpp:24-38)."""

    n: int  # respondents
    m: int  # items
    horizon: int = 1  # sessions
    C: int = 2  # ordinal categories
    grid_size: int = 1001  # theta* grid resolution on [-5, 5]
    theta_os: float = 1.0  # time-GP output scale
    theta_ls: float = 10.0  # time-GP length scale: picks the theta regime
    kernel: str = "Matern"  # time kernel: "Matern" or "RBF"
    constant_IRF: bool = False  # one IRF (f*, cutpoints) shared by all sessions
    n_inducing: int = 100  # inducing points of the two-stage constant_IRF f*
    jitter: float = 1e-6  # model nugget
    dtype: str = "float32"
    ess_max_rounds: int = 64  # ESS round cap
    theta_method: str = "grid"  # "grid" (exact grid draw) or "ess" (the
    # reference code's ESS and snap, src/draw-theta.cpp:26-84)
    mix_subsweeps: int = 1  # latent passes a sweep (JAX's extra passes)
    threshold_method: str = "auto"  # "auto" / "ess" (y-marginal delta ESS),
    # "newton" (Newton-proposal independence MH, same conditional),
    # "collapsed" (exact draw given the latents z; conjugate only) or
    # "interleave" (the ESS every threshold_ess_every-th sweep, collapsed
    # otherwise; conjugate only)
    threshold_ess_every: int = 4  # interleave period k
    threshold_mh_tries: int = 2  # MH tries per sweep under "newton"
    threshold_shift: bool = False  # exact Gibbs draw along the (cutpoints,
    # beta0) likelihood-null direction each sweep; skipped under constant_IRF
    affine_rounds: int = 0  # dilation MH rounds a sweep (conjugate only)
    affine_shift_max: int = 0  # half-window W of the shift-orbit draw
    # (conjugate only); 0 turns it off
    affine_dilate_sd: float = 0.02  # sd of the log dilation factor
    f_method: str = "auto"  # "auto", "conjugate" (Albert-Chib), "grid"
    # (one ESS on each item's grid function f*) or "two_stage" (the
    # reference's draw_f + draw_fstar pipeline)
    fstar_method: str = "matheron"  # two-stage f* | f: "matheron" (pathwise,
    # rank-(q+3) eigenbasis) or "chol" (the reference's posterior Cholesky)
    mean_degree: int = 2  # quadratic parametric mean (recover_fstar uses 1)

    def __post_init__(self):
        if min(self.n, self.m, self.horizon) < 1:
            raise ValueError(
                f"n, m, horizon must be >= 1 (got {self.n}, {self.m}, {self.horizon})")
        if self.C < 2:
            raise ValueError(f"need at least 2 ordinal categories, got C={self.C}")
        if self.grid_size < 2:
            raise ValueError(f"grid_size must be >= 2, got {self.grid_size}")
        if self.mix_subsweeps < 1:
            raise ValueError(
                f"mix_subsweeps must be >= 1, got {self.mix_subsweeps} "
                "(each sweep needs at least one latent/trait pass)")
        if self.ess_max_rounds < 1:
            raise ValueError(f"ess_max_rounds must be >= 1, got {self.ess_max_rounds}")
        if self.affine_rounds < 0:
            raise ValueError(f"affine_rounds must be >= 0, got {self.affine_rounds}")
        if self.affine_shift_max < 0:
            raise ValueError(f"affine_shift_max must be >= 0, got {self.affine_shift_max}")
        if self.affine_rounds > 0 and self.affine_dilate_sd <= 0:
            raise ValueError("dilation rounds need affine_dilate_sd > 0")
        if self.theta_method not in ("grid", "ess"):
            raise ValueError(
                f"theta_method must be 'grid' or 'ess', got {self.theta_method!r}")
        if self.threshold_mh_tries < 1:
            raise ValueError(
                f"threshold_mh_tries must be >= 1, got {self.threshold_mh_tries}")
        if self.dtype not in _DTYPES:
            raise ValueError(f"unsupported dtype {self.dtype!r}")
        if self.fstar_method not in ("matheron", "chol"):
            raise ValueError(
                f"fstar_method must be 'matheron' or 'chol', got {self.fstar_method!r}")
        if self.f_method not in ("auto", "grid", "two_stage", "conjugate"):
            raise ValueError("f_method must be 'auto', 'grid', 'two_stage' or "
                             f"'conjugate', got {self.f_method!r}")
        if self.threshold_method not in ("auto", "ess", "collapsed", "interleave",
                                         "newton"):
            raise ValueError(
                "threshold_method must be 'auto', 'ess', 'collapsed', "
                f"'interleave' or 'newton', got {self.threshold_method!r}")
        if (self.threshold_method in ("collapsed", "interleave")
                and self.resolved_f_method != "conjugate"):
            raise ValueError(
                f"threshold_method={self.threshold_method!r} needs the "
                "Albert-Chib latents (f_method='conjugate')")
        if self.threshold_ess_every < 1:
            raise ValueError(
                f"threshold_ess_every must be >= 1, got {self.threshold_ess_every}")
        if self.n_inducing < 2:
            raise ValueError(f"n_inducing must be >= 2, got {self.n_inducing}")

    @property
    def tdtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def resolved_f_method(self) -> str:
        """"auto" is the conjugate sampler, and the grid-native ESS on f*
        under constant_IRF, as in the JAX package
        (``gpirt_tpu/models/config.py:219``)."""
        if self.f_method != "auto":
            return self.f_method
        return "grid" if self.constant_IRF else "conjugate"

    @property
    def resolved_threshold_method(self) -> str:
        """As the JAX package resolves it
        (``gpirt_tpu/models/config.py:239``): "newton" on any f-method;
        off the conjugate path, which has no Albert-Chib latents, the
        y-marginal ESS; on it "auto" is the ESS and "collapsed" and
        "interleave" are themselves."""
        if self.threshold_method == "newton":
            return "newton"
        if self.resolved_f_method != "conjugate" or self.threshold_method == "auto":
            return "ess"
        return self.threshold_method

    @property
    def affine(self) -> bool:
        """Whether the conjugate sweep runs the collective affine moves."""
        return self.affine_rounds > 0 or self.affine_shift_max > 0

    @property
    def chol_normalized(self) -> bool:
        """Correlation-form theta-Gram Cholesky (the float32 stability mode)."""
        return self.dtype == "float32"

    @property
    def device_jitter(self) -> float:
        """Nugget of the theta-Gram factorizations and prior perturbations:
        the model nugget in float64; in float32 a correlation-scale nugget
        with an n-aware floor, max(jitter, 1e-4, 4 eps32 n), since the
        normalized Cholesky's rounding error grows as n eps32
        (``gpirt_tpu/models/config.py:282``)."""
        if self.dtype != "float32":
            return self.jitter
        return max(self.jitter, 1e-4, 4 * 1.19e-7 * self.n)

    @property
    def theta_regime(self) -> str:
        """The reference's three length-scale regimes
        (src/draw-theta.cpp:112-236; ``gpirt_tpu/models/config.py:296``):

        "CST": ls >= 3 horizon, one theta a respondent shared by all sessions;
        "RDM": ls <= 0.1, an independent theta a session;
        "GP":  otherwise, a GP prior over sessions.
        One session is CST.
        """
        if self.horizon == 1 or self.theta_ls >= 3 * self.horizon:
            return "CST"
        if self.theta_ls <= 0.1:
            return "RDM"
        return "GP"

    @property
    def grid_step(self) -> float:
        return (THETA_HI - THETA_LO) / (self.grid_size - 1)


@dataclasses.dataclass
class GPIRTConstants:
    """Per-run device constants, precomputed once on the host in float64.

    theta is snapped to the grid after every draw, so every Gram the sweep
    needs is a gather from the grid eigenbasis [U_se, Psi_grid].
    """

    grid: torch.Tensor  # (N,) theta* grid
    grid_gram: torch.Tensor  # (N, N) ICC Gram over the grid (no jitter)
    grid_gram_se: torch.Tensor  # (N, N) its squared-exponential part alone
    Psi_grid: torch.Tensor  # (N, 3) [sd0, sd1 t, sd2 t^2]: K = K_SE + Psi Psi^T
    U_se: torch.Tensor  # (N, q) eigenbasis factor, K_SE ~= U_se U_se^T
    L_grid: torch.Tensor  # (N, N) chol(grid Gram + jitter I), f64-computed
    Xstar: torch.Tensor  # (N, 3) [1, theta*, theta*^2]
    beta_prior_means: torch.Tensor  # (3, m)
    beta_prior_sds: torch.Tensor  # (3, m)
    theta_prior_means: torch.Tensor  # (2, n)
    theta_prior_sds: torch.Tensor  # (2, n)
    L_time: Optional[torch.Tensor] = None  # (H, H) time-GP chol, GP regime only
    Lambda_time: Optional[torch.Tensor] = None  # (H, H) its precision, GP only


def make_constants(
    config: GPIRTConfig,
    beta_prior_means: np.ndarray,
    beta_prior_sds: np.ndarray,
    theta_prior_means: np.ndarray,
    theta_prior_sds: np.ndarray,
    *,
    device,
) -> GPIRTConstants:
    """Host float64 grid Gram, Cholesky and SE eigendecomposition, and in the
    GP regime the time-GP factor and precision, moved to ``device`` in the
    config's dtype (``gpirt_tpu/models/config.py:349``)."""
    dt = config.tdtype
    N = config.grid_size
    grid64 = np.linspace(THETA_LO, THETA_HI, N)
    sds_col0 = np.asarray(beta_prior_sds, np.float64)[:, 0]
    gram64 = icc_gram_np(grid64, grid64, sds_col0)
    L_grid = host_cholesky_f64(gram64, config.jitter, dtype=np.float64)

    Xstar = np.stack([np.ones(N), grid64, grid64**2], axis=1)
    # exact rank-3 split of the ICC kernel: K = K_SE + Psi Psi^T
    d = grid64[:, None] - grid64[None, :]
    gram_se64 = np.exp(-0.5 * d * d)
    Psi = Xstar * sds_col0[None, :]
    # the SE grid Gram has numerical rank ~26; q = 32 truncates at ~1e-10
    q = min(32, N)
    ew, ev = np.linalg.eigh(gram_se64)
    ew, ev = ew[::-1][:q], ev[:, ::-1][:, :q]
    U_se64 = ev * np.sqrt(np.maximum(ew, 0.0))[None, :]

    def t(a):
        return torch.as_tensor(np.array(a, np.float64), dtype=dt, device=device)

    L_time = Lambda_time = None
    if config.theta_regime == "GP":
        # The reference builds the time Gram with zeroed prior sds
        # (src/cholesky-cache.cpp:31), so one (H, H) factor serves every
        # respondent. Both are inverted here in float64, never on the device.
        H = config.horizon
        ts = np.arange(H, dtype=np.float64)
        Vt = time_gram_np(ts, ts, config.theta_os, config.theta_ls, np.zeros(2),
                          config.kernel)
        L_time = t(host_cholesky_f64(Vt, config.jitter, dtype=np.float64))
        Lambda_time = t(np.linalg.inv(Vt + config.jitter * np.eye(H)))

    return GPIRTConstants(
        grid=t(grid64),
        grid_gram=t(gram64),
        grid_gram_se=t(gram_se64),
        Psi_grid=t(Psi),
        U_se=t(U_se64),
        L_grid=t(L_grid),
        Xstar=t(Xstar),
        beta_prior_means=t(beta_prior_means),
        beta_prior_sds=t(beta_prior_sds),
        theta_prior_means=t(theta_prior_means),
        theta_prior_sds=t(theta_prior_sds),
        L_time=L_time,
        Lambda_time=Lambda_time,
    )
