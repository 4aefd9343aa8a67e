"""The port's convergence diagnostics against the JAX package's, on draws
made by numpy from a seed: split and rank-normalized R-hat, tail ESS, the
rank normal scores, basin clusters and their summary to rtol 1e-12; the
device ESS with a campaign axis against ``jax.vmap`` of the JAX twin; and
gpirt_mcmc's end-of-run convergence summary."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a process)
from gpirt_tpu.utils import diagnostics as jdiag
from gpirt_tpu_torch import gpirt_mcmc
from gpirt_tpu_torch import api
from gpirt_tpu_torch.utils import diagnostics as tdiag


def _draws(K=4, S=60, P=7, seed=0):
    """(K, S, P) autocorrelated draws: chains that disagree a little in
    location and scale, one heavy-tailed column."""
    rng = np.random.default_rng(seed)
    x = np.zeros((K, S, P))
    e = rng.standard_normal((K, S, P))
    for s in range(1, S):
        x[:, s] = 0.6 * x[:, s - 1] + e[:, s]
    x += rng.standard_normal((K, 1, P)) * 0.5
    x *= 1.0 + 0.3 * rng.random((K, 1, P))
    x[..., -1] = rng.standard_t(2, (K, S))
    return x


@pytest.mark.parametrize("shape", [(4, 60, 7), (1, 31, 3), (6, 9, 5)])
def test_rhat_and_ess_match(shape):
    x = _draws(*shape)
    for name in ("split_rhat", "rank_normalized_rhat", "tail_ess",
                 "effective_sample_size"):
        np.testing.assert_allclose(getattr(tdiag, name)(x), getattr(jdiag, name)(x),
                                   rtol=1e-12, err_msg=name)
    np.testing.assert_allclose(tdiag._rank_normalize(x), jdiag._rank_normalize(x),
                               rtol=1e-12)


def test_summarize_matches():
    x = _draws()
    got, want = tdiag.summarize(x), jdiag.summarize(x)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)


@pytest.mark.parametrize("kind", ["draws", "means"])
def test_basin_clusters_match(kind):
    """Two basins of chains (one reflected), from (K, S, n) draws or (K, n)
    chain means."""
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal(12), rng.standard_normal(12)
    centers = np.stack([a, a, -a, b, b + 0.05, a + 0.02])
    x = centers[:, None, :] + 0.1 * rng.standard_normal((6, 40, 12))
    arg = x if kind == "draws" else x.mean(axis=1)
    got, want = tdiag.basin_clusters(arg), jdiag.basin_clusters(arg)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert got["n_clusters"] == want["n_clusters"] == 2
    assert got["sizes"] == want["sizes"]
    for k in ("within_corr_min", "between_corr_max"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12)


@pytest.mark.parametrize("S", [3, 40])
def test_device_ess_with_a_campaign_axis_matches_vmap(S):
    """(R, K, S, P): each campaign aligned against its own chain 0, as
    jax.vmap(effective_sample_size_device); float32 on both sides (rtol
    1e-4, as the (K, S, P) case in tests/test_torch_smc.py)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 4, S, 6)).astype(np.float32)
    x[1, 2] *= -1.0  # a reflected chain
    got = tdiag.effective_sample_size_device(torch.as_tensor(x))
    want = jax.vmap(jdiag.effective_sample_size_device)(jnp.asarray(x))
    assert got.shape == (3, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    for r in range(3):
        np.testing.assert_allclose(
            got[r].numpy(), tdiag.effective_sample_size_device(torch.as_tensor(x[r])).numpy(),
            rtol=1e-6)
    with pytest.raises(ValueError, match="draws must be"):
        tdiag.effective_sample_size_device(torch.zeros(4, 5))


def _votes(n=10, m=6, seed=0):
    rng = np.random.default_rng(seed)
    p = 1 / (1 + np.exp(-np.outer(np.linspace(-2, 2, n), rng.standard_normal(m) * 2)))
    return np.where(rng.random((n, m)) < p, 1.0, 6.0)


def test_gpirt_mcmc_prints_the_convergence_summary(capsys):
    """verbose (the default) prints JAX's summary after a run of more than
    one chain and at least 8 draws, and nothing of it with verbose=False."""
    kw = dict(CHAIN=3, dtype="float64", device="cpu", grid_size=101)
    gpirt_mcmc(_votes(), 8, 2, **kw)
    assert "split R-hat max" in capsys.readouterr().err
    gpirt_mcmc(_votes(), 8, 2, verbose=False, **kw)
    assert capsys.readouterr().err == ""


def test_convergence_summary_never_breaks_a_run(capsys):
    api._print_convergence_summary([{"theta": np.zeros((8, 3))}])  # no session axis
    assert "convergence summary skipped" in capsys.readouterr().err
