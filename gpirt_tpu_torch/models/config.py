"""Static configuration and precomputed constants for the port's sampler.

Counterpart of ``gpirt_tpu/models/config.py``, restricted to what the port
runs: binary data (C = 2), one session (H = 1), the Albert-Chib conjugate
latent sampler, the exact grid draw of theta and the y-marginal cutpoint
ESS. A configuration outside that raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpirt_tpu_torch.ops.kernels import icc_gram_np
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
    constant_IRF: bool = False
    jitter: float = 1e-6  # model nugget
    dtype: str = "float32"
    ess_max_rounds: int = 64  # cutpoint ESS round cap
    theta_method: str = "grid"
    threshold_method: str = "auto"
    f_method: str = "auto"

    def __post_init__(self):
        if min(self.n, self.m, self.horizon) < 1:
            raise ValueError(
                f"n, m, horizon must be >= 1 (got {self.n}, {self.m}, {self.horizon})")
        if self.C < 2:
            raise ValueError(f"need at least 2 ordinal categories, got C={self.C}")
        if self.grid_size < 2:
            raise ValueError(f"grid_size must be >= 2, got {self.grid_size}")
        if self.ess_max_rounds < 1:
            raise ValueError(f"ess_max_rounds must be >= 1, got {self.ess_max_rounds}")
        if self.dtype not in _DTYPES:
            raise ValueError(f"unsupported dtype {self.dtype!r}")
        outside = []
        if self.C != 2:
            outside.append(f"C={self.C} (ordinal data)")
        if self.horizon != 1:
            outside.append(f"horizon={self.horizon} (multi-session data)")
        if self.constant_IRF:
            outside.append("constant_IRF")
        if self.f_method not in ("auto", "conjugate"):
            outside.append(f"f_method={self.f_method!r}")
        if self.threshold_method not in ("auto", "ess"):
            outside.append(f"threshold_method={self.threshold_method!r}")
        if self.theta_method != "grid":
            outside.append(f"theta_method={self.theta_method!r}")
        if outside:
            raise NotImplementedError(
                "not ported to gpirt_tpu_torch yet: " + ", ".join(outside))

    @property
    def tdtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

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
    Psi_grid: torch.Tensor  # (N, 3) [sd0, sd1 t, sd2 t^2]: K = K_SE + Psi Psi^T
    U_se: torch.Tensor  # (N, q) eigenbasis factor, K_SE ~= U_se U_se^T
    L_grid: torch.Tensor  # (N, N) chol(grid Gram + jitter I), f64-computed
    Xstar: torch.Tensor  # (N, 3) [1, theta*, theta*^2]
    beta_prior_means: torch.Tensor  # (3, m)
    beta_prior_sds: torch.Tensor  # (3, m)
    theta_prior_means: torch.Tensor  # (2, n)
    theta_prior_sds: torch.Tensor  # (2, n)


def make_constants(
    config: GPIRTConfig,
    beta_prior_means: np.ndarray,
    beta_prior_sds: np.ndarray,
    theta_prior_means: np.ndarray,
    theta_prior_sds: np.ndarray,
    *,
    device,
) -> GPIRTConstants:
    """Host float64 grid Gram, Cholesky and SE eigendecomposition, moved to
    ``device`` in the config's dtype (``gpirt_tpu/models/config.py:349``)."""
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

    return GPIRTConstants(
        grid=t(grid64),
        Psi_grid=t(Psi),
        U_se=t(U_se64),
        L_grid=t(L_grid),
        Xstar=t(Xstar),
        beta_prior_means=t(beta_prior_means),
        beta_prior_sds=t(beta_prior_sds),
        theta_prior_means=t(theta_prior_means),
        theta_prior_sds=t(theta_prior_sds),
    )
