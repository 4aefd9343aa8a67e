"""Likelihood, linear algebra, kernels and the cutpoint ESS kernel wrapper.

The names ``gpirt_tpu/ops/__init__.py`` exports, from the port's modules."""

from gpirt_tpu_torch.ops.ess import ess_update
from gpirt_tpu_torch.ops.kernels import add_jitter, icc_gram, time_gram
from gpirt_tpu_torch.ops.likelihood import (
    LL_FLOOR,
    delta_to_threshold,
    ordinal_ll,
    ordinal_ll_terms,
    threshold_to_delta,
)
from gpirt_tpu_torch.ops.linalg import (
    chol_with_jitter,
    double_solve,
    host_cholesky_f64,
    tri_solve,
)

__all__ = [
    "icc_gram",
    "time_gram",
    "add_jitter",
    "LL_FLOOR",
    "ordinal_ll",
    "ordinal_ll_terms",
    "delta_to_threshold",
    "threshold_to_delta",
    "ess_update",
    "chol_with_jitter",
    "tri_solve",
    "double_solve",
    "host_cholesky_f64",
]
