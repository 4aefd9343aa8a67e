"""The port's sampler utilities against the JAX package: the reference's
memory estimate and its verbose table, the IRF curves, the generative
draws (the prior state in the CST, RDM and GP regimes and under
constant_IRF, the responses with and without a temperature and a mask,
the posterior predictive), and the block timing's keys.

Float64 on the CPU. The generative functions take their random numbers as
tensors; these are JAX's own, replayed from its key splits
(``gpirt_tpu/models/generate.py``), so the two must agree to rounding:
rtol 1e-12, integers exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a process)
from gpirt_tpu import api as japi
from gpirt_tpu.models import gibbs as jg
from gpirt_tpu.models import generate as jgen
from gpirt_tpu.models.config import GPIRTConfig as JConfig
from gpirt_tpu.models.config import make_constants as j_make_constants
from gpirt_tpu.models.sampler import memory_estimate_mb as j_memory_estimate_mb
from gpirt_tpu.utils import irf as jirf
from gpirt_tpu_torch import api, gpirt_mcmc
from gpirt_tpu_torch.convert import constants_from_numpy
from gpirt_tpu_torch.models import gibbs as tg
from gpirt_tpu_torch.models import generate
from gpirt_tpu_torch.models.config import GPIRTConfig, make_constants
from gpirt_tpu_torch.models.sampler import memory_estimate_mb
from gpirt_tpu_torch.utils import irf
from gpirt_tpu_torch.utils.datasets import simulate_2pl
from gpirt_tpu_torch.utils.profiling import profile_sweep

_F64 = jnp.float64
RTOL = 1e-12
n, m, N, H = 6, 4, 21, 3
# theta_ls by regime at H = 3 sessions (GPIRTConfig.theta_regime)
LS = {"CST": 10.0, "RDM": 0.05, "GP": 2.0}
# gpirt_tpu/utils/profiling.py:102-141
JAX_PROFILE_KEYS = ["full_sweep", "draw_f", "draw_fstar", "draw_theta", "draw_beta",
                    "draw_threshold"]


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


@pytest.mark.parametrize("args", [
    (100, 418, 1, 2, 500, 1001, False, False),
    (1500, 16, 1, 5, 500, 1001, True, True),
    (150, 60, 10, 2, 300, 1001, True, False),
    (5000, 1000, 1, 2, 2000, 1001, False, True),
])
def test_memory_estimate_and_its_table_match(args, capsys):
    assert memory_estimate_mb(*args) == j_memory_estimate_mb(*args)
    assert memory_estimate_mb(*args, bytes_per_el=4) == j_memory_estimate_mb(
        *args, bytes_per_el=4)
    n_, m_, H_, C_, S_, N_, store_f, store_fstar = args
    table_args = (n_, m_, H_, C_, S_, 2 * S_, N_, store_f, store_fstar)
    japi._print_memory_estimate(*table_args)
    want = capsys.readouterr()
    api._print_memory_estimate(*table_args)
    got = capsys.readouterr()
    assert got.err == want.err and got.out == want.out == ""
    assert ("WARNING" in got.err) == (memory_estimate_mb(*args)["total"] > 10000)


def test_verbose_gpirt_mcmc_prints_the_table(capsys):
    _, raw = simulate_2pl(3, n=8, m=5)
    gpirt_mcmc(raw, 3, 2, THIN=2, vote_codes={"yea": 1, "nay": 0, "missing": None},
               dtype="float64", grid_size=101, device="cpu", verbose=True)
    err = capsys.readouterr().err
    japi._print_memory_estimate(8, 5, 1, 2, 2, 3, 101, False, False)
    assert capsys.readouterr().err in err


def _ordered_thresholds(rng, shape, C):
    inner = np.sort(rng.standard_normal(shape + (C - 1,)), axis=-1)
    lo = np.full(shape + (1,), -np.inf)
    return np.concatenate([lo, inner, -lo], axis=-1)


@pytest.mark.parametrize("C", [2, 5])
def test_irf_matches(C):
    rng = np.random.default_rng(C)
    fstar = 2.0 * rng.standard_normal((N, m))
    thr = _ordered_thresholds(rng, (m,), C)
    p = irf.irf_probabilities(fstar, thr)
    np.testing.assert_allclose(p, jirf.irf_probabilities(fstar, thr), rtol=RTOL)
    np.testing.assert_allclose(p.sum(axis=-1), 1.0, rtol=RTOL)
    samples = {"fstar": rng.standard_normal((7, N, m, 2)),
               "threshold": np.moveaxis(_ordered_thresholds(rng, (7, 2, m), C), 1, 3)}
    for h in (0, 1):
        np.testing.assert_allclose(irf.posterior_irf(samples, h),
                                   jirf.posterior_irf(samples, h), rtol=RTOL)


def test_posterior_irf_of_a_port_chain():
    _, raw = simulate_2pl(5, n=8, m=5)
    d = gpirt_mcmc(raw, 4, 2, vote_codes={"yea": 1, "nay": 0, "missing": None},
                   store_fstar=True, dtype="float64", grid_size=101, device="cpu",
                   verbose=False)[0]
    p = irf.posterior_irf(d)
    assert p.shape == (101, 5, 2)
    np.testing.assert_allclose(p, jirf.posterior_irf(d), rtol=RTOL)
    np.testing.assert_allclose(p.sum(axis=-1), 1.0, rtol=RTOL)


_SETUPS = {}


def _setup(regime, constant_IRF=False, C=3):
    """JAX's and the port's configs and (equal) constants, nonzero theta
    prior sds."""
    key = (regime, constant_IRF, C)
    if key not in _SETUPS:
        kw = dict(n=n, m=m, horizon=H, C=C, grid_size=N, dtype="float64",
                  theta_ls=LS[regime], constant_IRF=constant_IRF)
        rng = np.random.default_rng(2)
        jconsts = j_make_constants(
            JConfig(**kw), beta_prior_means=np.zeros((3, m)),
            beta_prior_sds=rng.uniform(0.5, 2.0, (3, m)),
            theta_prior_means=np.zeros((2, n)),
            theta_prior_sds=rng.uniform(0.2, 1.0, (2, n)))
        _SETUPS[key] = (JConfig(**kw), jconsts, GPIRTConfig(**kw),
                        constants_from_numpy(jconsts, device="cpu", dtype=torch.float64))
    return _SETUPS[key]


def _jax_prior_draws(key, jcfg):
    """sample_prior_state's numbers as JAX draws them from ``key``
    (gpirt_tpu/models/generate.py:95, :33-79)."""
    k_t, k_f, k_b, k_d = jax.random.split(key, 4)
    regime, Hs = jcfg.theta_regime, (1 if jcfg.constant_IRF else H)
    shape = {"CST": (n, N), "RDM": (H, n, N), "GP": (n, N ** H)}[regime]
    u = jg._uniform2d(k_t, shape, _F64)
    z_f = jax.random.normal(k_f, (Hs, N, m) if Hs > 1 else (N, m), _F64)
    z_b = jax.random.normal(k_b, (Hs, 3, m), _F64)
    delta = jax.random.normal(k_d, (Hs, m, jcfg.C - 1), _F64)
    return [np.asarray(a) for a in (u, z_f.reshape(Hs, N, m), z_b, delta)]


def _prior_states(jcfg, jconsts, cfg, consts, seeds):
    """JAX's prior state for each key, and the port's for the same numbers
    with one chain a key."""
    keys = [jax.random.key(s) for s in seeds]
    want = [jgen.sample_prior_state(k, jconsts, jcfg) for k in keys]
    per = [_jax_prior_draws(k, jcfg) for k in keys]
    draws = generate.PriorDraws(*(_t(np.stack(a)) for a in zip(*per)))
    return want, generate.sample_prior_state(consts, cfg, draws)


@pytest.mark.parametrize("regime, constant_IRF", [
    ("CST", False), ("RDM", False), ("GP", False), ("CST", True), ("GP", True)])
def test_sample_prior_state_matches(regime, constant_IRF):
    jcfg, jconsts, cfg, consts = _setup(regime, constant_IRF)
    assert cfg.theta_regime == regime
    want, got = _prior_states(jcfg, jconsts, cfg, consts, (11, 12))
    for k, w in enumerate(want):
        np.testing.assert_array_equal(got.theta_idx[k].numpy(), np.asarray(w.theta_idx))
        for name in ("f", "beta", "thresholds", "fstar"):
            np.testing.assert_allclose(getattr(got, name)[k].numpy(),
                                       np.asarray(getattr(w, name)), rtol=RTOL,
                                       err_msg=name)
    if constant_IRF:
        assert torch.equal(got.fstar[:, 0], got.fstar[:, -1])
    assert len({tuple(map(int, w.theta_idx.ravel())) for w in want}) == 2


def test_prior_draws_shapes():
    for regime, shape in (("CST", (2, n, N)), ("RDM", (2, H, n, N)), ("GP", (2, n, N ** H))):
        _, _, cfg, consts = _setup(regime, constant_IRF=regime == "CST")
        d = generate.prior_draws(torch.Generator().manual_seed(0), 2, consts, cfg)
        Hs = 1 if regime == "CST" else H
        assert d.u_theta.shape == shape
        assert d.z_fstar.shape == (2, Hs, N, m) and d.z_beta.shape == (2, Hs, 3, m)
        assert d.delta.shape == (2, Hs, m, cfg.C - 1)
    big = GPIRTConfig(n=n, m=m, horizon=H, grid_size=101, theta_ls=2.0)
    with pytest.raises(NotImplementedError, match="grid_size"):
        generate.prior_draws(torch.Generator(), 1, consts, big)


@pytest.mark.parametrize("temp", [None, 4.0, "per chain"])
@pytest.mark.parametrize("masked", [False, True])
def test_sample_responses_matches(temp, masked):
    jcfg, jconsts, cfg, consts = _setup("RDM")
    want_states, state = _prior_states(jcfg, jconsts, cfg, consts, (21, 22))
    temps = [1.5, 6.0] if temp == "per chain" else [temp, temp]
    mask = np.random.default_rng(3).random((H, n, m)) > 0.2 if masked else None
    keys = [jax.random.key(s) for s in (31, 32)]
    want = [jgen.sample_responses(k, s, jconsts, jcfg,
                                  None if mask is None else jnp.asarray(mask), t)
            for k, s, t in zip(keys, want_states, temps)]
    u = _t(np.stack([jax.random.uniform(k, (H, n, m), _F64) for k in keys]))
    t_arg = torch.tensor(temps, dtype=torch.float64) if temp == "per chain" else temp
    got = generate.sample_responses(state, consts, cfg, u,
                                    None if mask is None else torch.as_tensor(mask),
                                    t_arg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.stack([np.asarray(w) for w in want]))
    assert set(np.unique(got.numpy())) <= set(range(cfg.C + 1))


def test_posterior_predictive_matches():
    jcfg, jconsts, cfg, consts = _setup("GP")
    want_states, _ = _prior_states(jcfg, jconsts, cfg, consts, (41, 42, 43))
    draws = {"theta": np.stack([np.asarray(jg.theta_from_indices(s.theta_idx, jconsts))
                                for s in want_states]),
             "f": np.stack([np.asarray(s.f) for s in want_states]),
             "beta": np.stack([np.asarray(s.beta) for s in want_states]),
             "threshold": np.stack([np.asarray(s.thresholds) for s in want_states])}
    mask = np.random.default_rng(4).random((H, n, m)) > 0.3
    key = jax.random.key(51)
    want = jgen.posterior_predictive(key, {k: jnp.asarray(v) for k, v in draws.items()},
                                     jconsts, jcfg, jnp.asarray(mask))
    u = _t(np.stack([jax.random.uniform(k, (H, n, m), _F64)
                     for k in jax.random.split(key, 3)]))
    got = generate.posterior_predictive({k: _t(v) for k, v in draws.items()}, consts,
                                        cfg, u, torch.as_tensor(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    u2 = generate.response_draws(torch.Generator().manual_seed(0), 3, consts, cfg)
    assert u2.shape == (3, H, n, m) and u2.dtype == torch.float64


@pytest.mark.parametrize("f_method", ["conjugate", "two_stage", "grid"])
def test_profile_sweep_on_the_cpu(f_method):
    _, raw = simulate_2pl(0, n=8, m=5)
    y = torch.as_tensor(np.where(np.isnan(raw), 0, raw + 1).astype(np.int32)[None])
    cfg = GPIRTConfig(n=8, m=5, grid_size=41, dtype="float64", f_method=f_method)
    consts = make_constants(cfg, np.zeros((3, 5)), np.full((3, 5), 3.0),
                            np.zeros((2, 8)), np.zeros((2, 8)), device="cpu")
    gen = torch.Generator().manual_seed(0)
    ti = torch.as_tensor(np.random.default_rng(0).uniform(-2, 2, (2, 1, 8)))
    thr = torch.as_tensor(api.default_thresholds(2, 5, 1))
    state = tg.init_state(ti, thr, consts, cfg, tg.init_draws(gen, 2, consts, cfg))
    out = profile_sweep(state, tg.sweep_draws(gen, 2, consts, cfg), y, consts, cfg, reps=2)
    assert list(out) == JAX_PROFILE_KEYS
    assert all(np.isfinite(v) and v > 0 for v in out.values()), out
