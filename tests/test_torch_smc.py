"""The port's chain loop, SMC initialization and diagnostics against the JAX
package, plus one short anneal -> run_chains pass on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a process)
from gpirt_tpu.models.sampler import sample_schedule as j_sample_schedule
from gpirt_tpu.ops.likelihood import ordinal_ll_terms as j_ordinal_ll_terms
from gpirt_tpu.parallel.smc import annealing_schedule as j_annealing_schedule
from gpirt_tpu.utils import diagnostics as jdiag
from gpirt_tpu_torch.api import default_thresholds
from gpirt_tpu_torch.models.config import GPIRTConfig, make_constants
from gpirt_tpu_torch.models.gibbs import GPIRTState
from gpirt_tpu_torch.models.sampler import run_chains, sample_schedule
from gpirt_tpu_torch.ops.threshold_ess import binary_threshold_ess
from gpirt_tpu_torch.parallel import smc
from gpirt_tpu_torch.utils import diagnostics as tdiag


@pytest.mark.parametrize("args", [(500, 100, 1), (10, 3, 4), (7, 0, 3), (2, 9, 5)])
def test_sample_schedule_matches(args):
    assert tuple(sample_schedule(*args)) == tuple(j_sample_schedule(*args))


@pytest.mark.parametrize("n_steps", [1, 2, 320])
def test_annealing_schedule_matches(n_steps):
    np.testing.assert_array_equal(smc.annealing_schedule(n_steps, 64.0),
                                  j_annealing_schedule(n_steps, 64.0))


def test_lane_ll_matches():
    """The SMC reweight's per-lane tempered ll, against the JAX package's
    ll terms at inv_s = 1/sqrt(T) summed per lane (smc.py:137-147)."""
    rng = np.random.default_rng(0)
    K, H, n, m, N = 3, 1, 6, 5, 21
    cfg = GPIRTConfig(n=n, m=m, grid_size=N, dtype="float64")
    consts = make_constants(cfg, np.zeros((3, m)), np.full((3, m), 2.0),
                            np.zeros((2, n)), np.zeros((2, n)), device="cpu")
    idx = rng.integers(0, N, (K, H, n))
    f = rng.standard_normal((K, H, n, m))
    beta = rng.standard_normal((K, H, 3, m))
    thr = np.broadcast_to(np.array([-np.inf, 0.3, np.inf]), (K, H, m, 3))
    y = rng.integers(0, 3, (H, n, m)).astype(np.int32)
    st = GPIRTState(torch.as_tensor(idx), torch.as_tensor(f), torch.as_tensor(beta),
                    torch.as_tensor(thr.copy()), torch.zeros(K, H, N, m,
                                                             dtype=torch.float64))
    got = smc._lane_ll(st, 5.0, torch.as_tensor(y), consts)
    theta = consts.grid.numpy()[idx]
    g = f + np.einsum("khnp,khpm->khnm",
                      np.stack([np.ones_like(theta), theta, theta ** 2], -1), beta)
    want = [float(jnp.sum(j_ordinal_ll_terms(jnp.asarray(g[k]), jnp.asarray(y),
                                             jnp.asarray(thr[k]),
                                             1.0 / jnp.sqrt(5.0))))
            for k in range(K)]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


def test_systematic_src_matches():
    rng = np.random.default_rng(1)
    K = 16
    w = rng.random(K) ** 4
    w /= w.sum()
    for u in (0.0, 0.37, 0.999):
        pos = (jnp.arange(K, dtype=jnp.float64) + u) / K
        want = np.clip(np.asarray(jnp.searchsorted(jnp.cumsum(jnp.asarray(w)), pos)),
                       0, K - 1)
        got = smc._systematic_src(torch.as_tensor(w), torch.tensor(u, dtype=torch.float64))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("K", [1, 3])
def test_ess_device_matches(K):
    rng = np.random.default_rng(2)
    S, P = 60, 5
    x = np.cumsum(rng.standard_normal((K, S, P)), axis=1) * 0.1 \
        + rng.standard_normal((K, S, P))
    got = tdiag.effective_sample_size_device(torch.as_tensor(x))
    want = jdiag.effective_sample_size_device(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    np.testing.assert_allclose(tdiag.effective_sample_size(x),
                               jdiag.effective_sample_size(x), rtol=1e-12)
    np.testing.assert_array_equal(tdiag.align_theta_signs(x[0]),
                                  jdiag.align_theta_signs(x[0]))


def test_anneal_then_run_chains_on_cpu():
    """SMC init -> sampling: finite ll, ordered cutpoints that moved, draw
    shapes; the cutpoint block took the plain version (no launches)."""
    K, n, m, N = 4, 10, 7, 41
    rng = np.random.default_rng(3)
    theta = np.linspace(-1.5, 1.5, n)
    p = 1 / (1 + np.exp(-np.outer(theta, rng.standard_normal(m) * 2)))
    y = np.where(rng.random((n, m)) < p, 2, 1).astype(np.int32)[None]
    y[0, 0, :2] = 0
    cfg = GPIRTConfig(n=n, m=m, grid_size=N, dtype="float64", jitter=1e-6)
    consts = make_constants(cfg, np.zeros((3, m)), np.full((3, m), 3.0),
                            np.zeros((2, n)), np.zeros((2, n)), device="cpu")
    gen = torch.Generator().manual_seed(0)
    theta_init = torch.as_tensor(rng.uniform(-1, 1, (K, 1, n)))
    thr = torch.as_tensor(default_thresholds(2, m, 1))
    yt = torch.as_tensor(y)
    launches = binary_threshold_ess.launches
    states, info = smc.anneal_init(gen, yt, theta_init, thr, consts, cfg,
                                   n_steps=6, max_temp=16.0)
    assert info["weight_ess"].shape == (5,)
    assert 1 <= info["n_resamples"] and 1.0 <= info["final_weight_ess"] <= K
    draws = run_chains(gen, yt, theta_init, thr, consts, cfg,
                       sample_iterations=5, burn_iterations=2, thin=2,
                       initial_states=states)
    S = sample_schedule(5, 2, 2).n_samples
    assert draws["theta"].shape == (K, S, 1, n)
    assert draws["beta"].shape == (K, S, 1, 3, m)
    assert draws["threshold"].shape == (K, S, 1, m, 3)
    assert torch.isfinite(draws["ll"]).all()
    t = draws["threshold"]
    assert (t[..., 0] == -np.inf).all() and (t[..., 2] == np.inf).all()
    assert torch.isfinite(t[..., 1]).all() and (t[..., 1] != 0.0).all()
    assert binary_threshold_ess.launches == launches
