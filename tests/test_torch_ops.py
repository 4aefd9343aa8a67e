"""The port's ops, constants and data modules against the JAX package,
float64 on random inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpirt_tpu.models.config import GPIRTConfig as JConfig
from gpirt_tpu.models.config import make_constants as j_make_constants
from gpirt_tpu.ops import kernels as jk
from gpirt_tpu.ops import likelihood as jl
from gpirt_tpu.ops import linalg as jla
from gpirt_tpu.utils import datasets as jd
from gpirt_tpu.utils import response as jr
from gpirt_tpu_torch.models.config import GPIRTConfig, make_constants
from gpirt_tpu_torch.ops import kernels as tk
from gpirt_tpu_torch.ops import likelihood as tl
from gpirt_tpu_torch.ops import linalg as tla
from gpirt_tpu_torch.utils import datasets as td
from gpirt_tpu_torch.utils import response as tr


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _close(got, want, rtol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=rtol)


def test_make_constants_matches():
    n, m, N = 7, 5, 61
    rng = np.random.default_rng(0)
    priors = dict(beta_prior_means=rng.standard_normal((3, m)),
                  beta_prior_sds=rng.uniform(0.5, 3.0, (3, m)),
                  theta_prior_means=np.zeros((2, n)),
                  theta_prior_sds=rng.uniform(0, 1, (2, n)))
    want = j_make_constants(JConfig(n=n, m=m, grid_size=N, dtype="float64",
                                    jitter=1e-5), **priors)
    got = make_constants(GPIRTConfig(n=n, m=m, grid_size=N, dtype="float64",
                                     jitter=1e-5), **priors, device="cpu")
    for name in ("grid", "Psi_grid", "L_grid", "Xstar", "beta_prior_means",
                 "beta_prior_sds", "theta_prior_means", "theta_prior_sds"):
        _close(getattr(got, name), getattr(want, name))
    # eigenvectors are unique up to sign: compare the Gram they factor
    U, Uj = getattr(got, "U_se").numpy(), np.asarray(want.U_se)
    _close(U @ U.T, Uj @ Uj.T, 1e-10)
    assert got.L_grid.dtype == torch.float64


def _ordinal_case(C, seed=1):
    rng = np.random.default_rng(seed)
    K, H, n, m = 2, 1, 6, 4
    g = rng.standard_normal((K, H, n, m)) * 2
    y = rng.integers(0, C + 1, (H, n, m)).astype(np.int32)
    d = rng.standard_normal((K, H, m, C - 1)) * 0.5
    thr = np.asarray(jl.delta_to_threshold(jnp.asarray(d)))
    return g, y, thr


@pytest.mark.parametrize("C", [2, 3, 5])
@pytest.mark.parametrize("temp", [None, 9.0])
def test_ordinal_ll_terms_matches(C, temp):
    g, y, thr = _ordinal_case(C)
    inv_s = None if temp is None else 1.0 / np.sqrt(temp)
    want = jl.ordinal_ll_terms(jnp.asarray(g), jnp.asarray(y), jnp.asarray(thr),
                               inv_s)
    got = tl.ordinal_ll_terms(_t(g), _t(y, torch.int32), _t(thr), inv_s)
    _close(got, want)


def test_cutpoint_bounds_matches():
    g, y, thr = _ordinal_case(4)
    want = jl.cutpoint_bounds(jnp.asarray(y), jnp.asarray(thr))
    got = tl.cutpoint_bounds(_t(y, torch.int32), _t(thr))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("C", [2, 3, 6])
def test_delta_threshold_transforms_match(C):
    rng = np.random.default_rng(C)
    d = rng.standard_normal((3, 4, C - 1))
    thr = tl.delta_to_threshold(_t(d))
    _close(thr, jl.delta_to_threshold(jnp.asarray(d)))
    _close(tl.threshold_to_delta(thr), jl.threshold_to_delta(jnp.asarray(thr.numpy())))
    _close(tl.threshold_to_delta(thr), d, 1e-12)


def _spd3(seed, batch=(4, 5)):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal(batch + (3, 3))
    return A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(3)


@pytest.mark.parametrize("trans", [False, True])
def test_chol3_tri3_solve_match(trans):
    M = _spd3(0)
    b = np.random.default_rng(1).standard_normal((4, 5, 3, 2))
    L = tla.chol3(_t(M))
    _close(L, jla.chol3(jnp.asarray(M)))
    _close(L @ L.mT, M, 1e-12)
    _close(tla.tri3_solve(L, _t(b), trans=trans),
           jla.tri3_solve(jnp.asarray(L.numpy()), jnp.asarray(b), trans=trans))


@pytest.mark.parametrize("trans", [False, True])
def test_tri_solve_matches(trans):
    rng = np.random.default_rng(2)
    A = rng.standard_normal((3, 6, 6))
    L = np.linalg.cholesky(A @ np.swapaxes(A, -1, -2) + 6 * np.eye(6))
    b = rng.standard_normal((3, 6, 4))
    _close(tla.tri_solve(_t(L), _t(b), trans=trans),
           jla.tri_solve(jnp.asarray(L), jnp.asarray(b), trans=trans), 1e-11)


def test_host_kernels_match():
    rng = np.random.default_rng(3)
    x1, x2 = rng.standard_normal(7), rng.standard_normal(5)
    sds = np.array([1.5, 0.7, 0.3])
    np.testing.assert_array_equal(tk.icc_gram_np(x1, x2, sds),
                                  jk.icc_gram_np(x1, x2, sds))
    ts = np.arange(4.0)
    for kern in ("Matern", "RBF"):
        np.testing.assert_array_equal(
            tk.time_gram_np(ts, ts, 1.0, 2.0, np.array([0.1, 0.2]), kern),
            jk.time_gram_np(ts, ts, 1.0, 2.0, np.array([0.1, 0.2]), kern))
    L = tla.host_cholesky_f64(jk.icc_gram_np(x1, x1, sds), 1e-6)
    np.testing.assert_array_equal(L, jla.host_cholesky_f64(
        jk.icc_gram_np(x1, x1, sds), 1e-6))


def test_senate116_response_matrix_matches():
    rm, sen, rolls = td.senate116_response_matrix()
    rm_j, sen_j, rolls_j = jd.senate116_response_matrix()
    np.testing.assert_array_equal(np.asarray(rm), np.asarray(rm_j))
    np.testing.assert_array_equal(sen, sen_j)
    np.testing.assert_array_equal(rolls, rolls_j)
    y, C, _ = tr.encode_categories(np.asarray(rm))
    y_j, C_j, _ = jr.encode_categories(np.asarray(rm_j))
    np.testing.assert_array_equal(y, y_j)
    assert C == C_j == 2 and y.shape == (1, 100, 418)
