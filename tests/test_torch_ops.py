"""The port's ops, constants and data modules against the JAX package,
float64 on random inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a process)
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


def test_exported_helpers_match():
    """JAX's five public helpers the port lacked, in JAX's argument order:
    time_gram (both kernels), add_jitter, ordinal_ll (whole and over an
    axis), spd3_solve, and total_loglik of one chain's state and of two, against the
    JAX package in float64 on the same numpy inputs, within 1e-12; the
    port's names exported where JAX exports them."""
    import gpirt_tpu.ops as j_ops
    import gpirt_tpu_torch.ops as t_ops
    from gpirt_tpu.models import gibbs as jg
    from gpirt_tpu_torch.models import gibbs as tg

    assert t_ops.__all__ == j_ops.__all__
    rng = np.random.default_rng(3)
    t1, t2, sds = rng.uniform(0, 9, 6), rng.uniform(0, 9, 4), rng.uniform(0.1, 1.0, 2)
    for kernel in ("Matern", "RBF"):
        _close(tk.time_gram(_t(t1), _t(t2), 1.3, 2.5, _t(sds), kernel),
               jk.time_gram(jnp.asarray(t1), jnp.asarray(t2), 1.3, 2.5, jnp.asarray(sds),
                            kernel))
    gram = rng.standard_normal((2, 5, 5))
    _close(tk.add_jitter(_t(gram), 1e-3), jk.add_jitter(jnp.asarray(gram), 1e-3))

    C, n, m = 4, 9, 5
    g = rng.standard_normal((2, n, m))
    y = rng.integers(0, C + 1, (2, n, m)).astype(np.int32)
    thr = np.sort(rng.standard_normal((2, m, C - 1)), -1)
    thr = np.concatenate([np.full((2, m, 1), -np.inf), thr, np.full((2, m, 1), np.inf)], -1)
    for axis in (None, (1, 2)):
        _close(tl.ordinal_ll(_t(g), _t(y, torch.int32), _t(thr), axis),
               jl.ordinal_ll(jnp.asarray(g), jnp.asarray(y), jnp.asarray(thr), axis))

    A = rng.standard_normal((7, 3, 3))
    M = A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(3)
    b = rng.standard_normal((7, 3, 2))
    _close(tla.spd3_solve(_t(M), _t(b)), jla.spd3_solve(jnp.asarray(M), jnp.asarray(b)))

    N, H = 21, 2
    priors = dict(beta_prior_means=np.zeros((3, m)), beta_prior_sds=np.full((3, m), 3.0),
                  theta_prior_means=np.zeros((2, n)), theta_prior_sds=np.zeros((2, n)))
    consts = make_constants(GPIRTConfig(n=n, m=m, horizon=H, C=C, grid_size=N,
                                        dtype="float64"), **priors, device="cpu")
    idx = rng.integers(0, N, (H, n))
    state = dict(theta_idx=idx, f=rng.standard_normal((H, n, m)),
                 beta=rng.standard_normal((H, 3, m)), thresholds=thr,
                 fstar=rng.standard_normal((H, N, m)))
    t_state = tg.GPIRTState(**{k: _t(v, torch.int64 if k == "theta_idx" else torch.float64)
                               for k, v in state.items()})
    j_state = jg.GPIRTState(**{k: jnp.asarray(v) for k, v in state.items()})
    j_consts = j_make_constants(JConfig(n=n, m=m, horizon=H, C=C, grid_size=N,
                                        dtype="float64"), **priors)
    want = jg.total_loglik(j_state, jnp.asarray(y), j_consts)
    _close(tg.total_loglik(t_state, _t(y, torch.int32), consts), want)
    # a batched state (JAX's takes one chain's) sums over its chains too,
    # one scalar as jnp.sum gives
    batched = tg.GPIRTState(*(torch.stack([a, a]) for a in t_state))
    _close(tg.total_loglik(batched, _t(y, torch.int32), consts), 2 * want)
