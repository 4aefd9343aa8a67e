"""The port's campaign estimator against the JAX package: the schedule, the
estimator on the device (rtol 1e-12 in float64), the batched anneal (each
campaign equals a solo anneal_init fed the same draws, rtol 1e-12 in
float64), and gpirt_campaigns end to end on the CPU, as
tests/test_campaigns.py holds the JAX one."""

import numpy as np
import pytest
import torch

from gpirt_tpu.campaigns import _campaign_estimator as j_campaign_estimator
from gpirt_tpu.campaigns import campaign_schedule as j_campaign_schedule
from gpirt_tpu_torch import campaign_schedule, gpirt_campaigns
from gpirt_tpu_torch.api import default_thresholds
from gpirt_tpu_torch.campaigns import _campaign_estimator
from gpirt_tpu_torch.models.config import GPIRTConfig, make_constants
from gpirt_tpu_torch.parallel import smc


@pytest.mark.parametrize("C", [2, 3, 5])
def test_campaign_schedule_matches(C):
    assert campaign_schedule(C) == j_campaign_schedule(C)


def test_campaign_estimator_matches():
    """Campaign means and pooled posterior variance of sign-aligned draws,
    some draws reflected."""
    R, K, S, P = 3, 4, 5, 9
    rng = np.random.default_rng(0)
    theta = rng.standard_normal((R * K, S, P)) + np.linspace(-2, 2, P)
    theta[rng.random((R * K, S)) < 0.3] *= -1.0
    cm, pv = _campaign_estimator(torch.as_tensor(theta), R, K, S, P)
    jcm, jpv = j_campaign_estimator(theta, R, K, S, P)
    np.testing.assert_allclose(cm.numpy(), np.asarray(jcm), rtol=1e-12)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jpv), rtol=1e-12)


def _anneal_setup(C, n=10, m=6, N=101, seed=0):
    """tests/test_campaigns.py's data in the port's float64 setup."""
    method = "newton" if C == 2 else "ess"
    cfg = GPIRTConfig(n=n, m=m, C=C, grid_size=N, dtype="float64", threshold_method=method)
    consts = make_constants(cfg, np.zeros((3, m)), np.full((3, m), 1.5), np.zeros((2, n)),
                            np.zeros((2, n)), device="cpu")
    rng = np.random.default_rng(seed)
    theta = np.linspace(-1.5, 1.5, n)
    p = 1 / (1 + np.exp(-np.outer(theta, rng.standard_normal(m))))
    u = rng.random((n, m))
    y = np.ones((1, n, m), np.int32)
    y[0][u < p] = 2
    if C > 2:
        y[0][u < p * 0.3] = 3
    return cfg, consts, torch.as_tensor(y), torch.as_tensor(default_thresholds(C, m, 1))


@pytest.mark.parametrize("C", [2, 3])
def test_batched_anneal_equals_solo_per_campaign(C):
    """Campaign b of anneal_init_batched against a solo anneal_init whose
    generator is seeded as campaign b's: the states to rtol 1e-12 (theta
    exactly), the weight-ESS trace to 1e-12, the same resample counts;
    info in the JAX package's shapes."""
    cfg, consts, y, thr = _anneal_setup(C)
    B, K, steps = 3, 4, 12
    ti = torch.as_tensor(np.random.default_rng(1).uniform(-1, 1, (K, 1, cfg.n)))
    kw = dict(n_steps=steps, max_temp=16.0)
    seeds = [11 + b * K for b in range(B)]
    states, info = smc.anneal_init_batched(
        [torch.Generator().manual_seed(s) for s in seeds], y, ti, thr, consts, cfg, **kw)
    assert states.theta_idx.shape == (B, K, 1, cfg.n)
    assert info["weight_ess"].shape == (B, steps - 1)
    assert info["n_resamples"].shape == (B,) and info["final_weight_ess"].shape == (B,)
    for b, seed in enumerate(seeds):
        solo, solo_info = smc.anneal_init(torch.Generator().manual_seed(seed), y, ti, thr,
                                          consts, cfg, **kw)
        assert torch.equal(states.theta_idx[b], solo.theta_idx)
        for name in ("f", "beta", "thresholds", "fstar"):
            np.testing.assert_allclose(getattr(states, name)[b].numpy(),
                                       getattr(solo, name).numpy(), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(info["weight_ess"][b], solo_info["weight_ess"],
                                   rtol=1e-12)
        assert info["n_resamples"][b] == solo_info["n_resamples"]
        np.testing.assert_allclose(info["final_weight_ess"][b],
                                   solo_info["final_weight_ess"], rtol=1e-12)
    assert (info["n_resamples"] >= 2).all()  # the run resampled before the end
    assert not torch.equal(states.theta_idx[0], states.theta_idx[1])


def _binary_data(n=12, m=8, seed=0):
    """Voteview-coded roll calls (tests/test_campaigns.py): 1 = yea, 6 =
    nay, 9 = missing, no unanimous item."""
    rng = np.random.default_rng(seed)
    theta = np.linspace(-2, 2, n)
    p = 1 / (1 + np.exp(-np.outer(theta, rng.standard_normal(m))))
    data = np.where(rng.random((n, m)) < p, 1.0, 6.0)
    data[rng.random((n, m)) < 0.1] = 9.0
    data[0] = 6.0
    data[-1] = 1.0
    return data


_KW = dict(n_chains=4, sample_iterations=6, burn_iterations=2, smc_steps=10,
           smc_max_temp=8.0, dtype="float64", grid_size=101, verbose=False, device="cpu")


def test_end_to_end_shapes_and_estimator():
    data = _binary_data()
    R, K, S = 3, 4, 6
    out = gpirt_campaigns(data, n_campaigns=R, SEED=7, **_KW)
    n, m = data.shape
    assert out["theta_mean"].shape == (n, 1) and out["theta_se"].shape == (n, 1)
    assert out["campaign_means"].shape == (R, n, 1)
    assert out["ess_campaign"].shape == (n, 1)
    assert np.all(np.isfinite(out["theta_mean"])) and np.all(out["theta_se"] >= 0)
    assert np.isfinite(out["ess_campaign_median"])
    assert out["pooled_ess_per_campaign"].shape == (R,)
    assert out["final_weight_ess"].shape == (R,) and out["n_resamples"].shape == (R,)
    assert out["draws"]["theta"].shape == (R, K, S, n, 1)
    assert out["draws"]["ll"].shape == (R, K, S)
    assert out["draws"]["threshold"].shape == (R, K, S, m, 3, 1)
    assert out["draws"]["beta"].shape == (R, K, S, 3, m, 1)
    cm = out["campaign_means"]
    np.testing.assert_allclose(out["theta_se"], np.sqrt(cm.var(axis=0, ddof=1) / R),
                               rtol=1e-12)
    np.testing.assert_allclose(out["theta_mean"], cm.mean(axis=0), rtol=1e-12)
    assert out["schedule"]["threshold_method"] == "newton"
    assert out["schedule"]["n_campaigns"] == R
    assert set(out["walls"]) == {"smc_sec", "sampling_sec", "total_sec"}


def test_campaigns_are_seed_reproducible():
    data = _binary_data()
    kw = dict(_KW, n_campaigns=2, store_draws=False)
    a = gpirt_campaigns(data, SEED=3, **kw)
    b = gpirt_campaigns(data, SEED=3, **kw)
    c = gpirt_campaigns(data, SEED=4, **kw)
    np.testing.assert_array_equal(a["campaign_means"], b["campaign_means"])
    assert not np.array_equal(a["campaign_means"], c["campaign_means"])
    assert "draws" not in a


def test_rejects_a_single_campaign():
    with pytest.raises(ValueError, match="n_campaigns"):
        gpirt_campaigns(_binary_data(), n_campaigns=1, **_KW)


def test_defaults_to_the_card_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gpirt_campaigns(_binary_data(), n_campaigns=2)
