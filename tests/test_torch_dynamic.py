"""The port's multi-session path (H > 1) against the JAX package: the
time-GP constants, the theta draw in the CST, RDM and GP regimes, f* at
H > 1, whole sweeps, a replayed ``anneal_init``, ``gpirt_mcmc`` on cubes
and the simulators (the time-GP constants' conversion is in
tests/test_torch_api.py).

As in tests/test_torch_gibbs.py, both packages compute in float64 on the
CPU from the same constants and state, the random draws made in JAX from
its own keys and handed to the port's pure blocks. The theta draw's
uniforms by regime: CST ``_uniform2d(key, (n, N))``; RDM
``_uniform2d(key, (H, n, N))``; GP ``_uniform2d(split(key, H)[h], (n, N))``
for session h. At H > 1 the JAX f* block solves ``alpha = B^-1 rhs`` by
``lowrank_bsolve``; the port keeps its push-through, the same f*.
Tolerances: theta indices exactly, the rest rtol 1e-10 a block and 1e-8
after three sweeps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a process)
from gpirt_tpu.models import gibbs as jg
from gpirt_tpu.models.config import GPIRTConfig as JConfig
from gpirt_tpu.models.config import make_constants as j_make_constants
from gpirt_tpu.parallel.smc import anneal_init as j_anneal_init
from gpirt_tpu.utils import datasets as j_datasets
from gpirt_tpu.utils.response import recode_cube as j_recode_cube
from gpirt_tpu_torch import gpirt_mcmc
from gpirt_tpu_torch.api import default_thresholds
from gpirt_tpu_torch.convert import constants_from_numpy, state_from_numpy
from gpirt_tpu_torch.models import gibbs as tg
from gpirt_tpu_torch.models.config import GPIRTConfig, make_constants
from gpirt_tpu_torch.ops import linalg
from gpirt_tpu_torch.ops.likelihood import delta_to_threshold, threshold_to_delta
from gpirt_tpu_torch.parallel import smc
from gpirt_tpu_torch.utils import datasets

K, H, n, m, N = 2, 3, 12, 9, 101
_TWO_PI = 6.283185307179586
_F64 = jnp.float64
RTOL = 1e-10
LS = {"CST": 10.0, "RDM": 0.05, "GP": 2.0}  # theta_ls of each regime at H = 3
VOTES = {"yea": 1, "nay": 0, "missing": None}


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=rtol)


def _y(C, seed=0):
    """(H, n, m) responses 1..C with ~15% masked cells; the trait drifts
    over sessions, so the sessions' tables differ."""
    rng = np.random.default_rng(seed)
    theta = np.linspace(-1.5, 1.5, n)[None] + 0.4 * rng.standard_normal((H, n))
    latent = (theta[..., None] * rng.standard_normal(m) * 1.5
              + rng.standard_normal((H, n, m)))
    cuts = np.quantile(latent, np.arange(1, C) / C)
    y = (np.digitize(latent, cuts) + 1).astype(np.int32)
    y[rng.random((H, n, m)) < 0.15] = 0
    return y


def _setup(regime, C=2, method="ess"):
    ls = LS[regime]
    jcfg = JConfig(n=n, m=m, horizon=H, C=C, grid_size=N, dtype="float64",
                   f_method="conjugate", threshold_method=method,
                   threshold_ess_twophase=False, theta_ls=ls)
    cfg = GPIRTConfig(n=n, m=m, horizon=H, C=C, grid_size=N, dtype="float64",
                      threshold_method=method, theta_ls=ls)
    assert cfg.theta_regime == jcfg.theta_regime == regime
    jconsts = j_make_constants(
        jcfg, beta_prior_means=np.zeros((3, m)),
        beta_prior_sds=np.full((3, m), 1.5),
        theta_prior_means=np.zeros((2, n)),
        theta_prior_sds=np.full((2, n), 0.5))
    y = _y(C)
    rng = np.random.default_rng(1)
    theta_init = rng.uniform(-2, 2, (K, H, n))
    thr_init = default_thresholds(C, m, H)
    keys = jax.random.split(jax.random.key(7), K)
    jstate = jax.vmap(lambda k, t: jg.init_state(
        k, t, jnp.asarray(thr_init), jnp.asarray(y), jconsts, jcfg))(
        keys, jnp.asarray(theta_init))
    # cutpoints off qnorm(i/C), each lane differently
    d = _t(rng.standard_normal((K, H, m, C - 1)) * 0.3)
    thr = delta_to_threshold(threshold_to_delta(_t(jstate.thresholds)) + d)
    jstate = jstate._replace(thresholds=jnp.asarray(thr.numpy()))
    return dict(jcfg=jcfg, cfg=cfg, jconsts=jconsts, y=y, yt=torch.as_tensor(y),
                consts=constants_from_numpy(jconsts, device="cpu",
                                            dtype=torch.float64),
                keys=keys, jstate=jstate,
                state=state_from_numpy(jstate, device="cpu", dtype=torch.float64),
                thr_init=thr_init)


_SETUPS = {}


def setup_for(regime, C=2, method="ess"):
    if (regime, C, method) not in _SETUPS:
        _SETUPS[(regime, C, method)] = _setup(regime, C, method)
    return _SETUPS[(regime, C, method)]


def _theta_uniforms(key, regime):
    if regime == "CST":
        return np.asarray(jg._uniform2d(key, (n, N), _F64))
    if regime == "RDM":
        return np.asarray(jg._uniform2d(key, (H, n, N), _F64))
    return np.stack([np.asarray(jg._uniform2d(k, (n, N), _F64))
                     for k in jax.random.split(key, H)])


def _fstar_draws(key, q):
    k_u, k_e = jax.random.split(key)
    k_q, k_p, k_n = jax.random.split(k_u, 3)
    return [np.asarray(a) for a in (
        jg._normal2d(k_q, (H, q, m), _F64), jg._normal2d(k_p, (H, 3, m), _F64),
        jg._normal2d(k_n, (H, N, m), _F64), jg._normal2d(k_e, (H, n, m), _F64))]


def _ess_draws(key, d, rounds=64):
    k_nu, k_ess = jax.random.split(key)
    nu = jax.random.normal(k_nu, (H, m, d), _F64)
    k_u, k_eps, k_loop = jax.random.split(k_ess, 3)
    logu = jnp.log(jax.random.uniform(k_u, (H, m), dtype=_F64))
    eps0 = jax.random.uniform(k_eps, (H, m), dtype=_F64, maxval=_TWO_PI)
    rs, k = [], k_loop
    for _ in range(rounds):
        k, k_r = jax.random.split(k)
        rs.append(jax.random.uniform(k_r, (H, m), dtype=_F64))
    return [np.asarray(a) for a in (nu, logu, eps0, jnp.stack(rs))]


def _newton_draws(key, d, tries=2):
    zs, lus = [], []
    for k in range(tries):
        k_z, k_u, key = jax.random.split(jax.random.fold_in(key, k), 3)
        zs.append(np.asarray(jax.random.normal(k_z, (H, m, d), _F64)))
        lus.append(np.log(np.asarray(jax.random.uniform(k_u, (H, m), _F64))))
    return np.stack(zs), np.stack(lus)


def _sweep_draws(key, q, regime, C, method):
    """One gibbs_sweep's draws, replayed from its key as the JAX conjugate
    branch consumes them (mix_subsweeps = 1)."""
    k_f, _, k_th, k_b, k_t = jax.random.split(key, 5)
    latent = [_theta_uniforms(jax.random.fold_in(k_th, 0), regime),
              np.asarray(jg._uniform2d(jax.random.fold_in(k_f, 0), (H, n, m), _F64)),
              *_fstar_draws(jax.random.fold_in(k_f, 2), q),
              np.asarray(jax.random.normal(k_b, (H, m, 3), _F64))]
    if method == "newton":
        return latent, _newton_draws(k_t, C - 1)
    return latent, _ess_draws(k_t, C - 1)


def _port_draws(per_lane, method):
    """Per-chain replayed draws -> SweepDraws with the port's layouts (the
    chain axis first; the round or try axis before it)."""
    latent = [_t(np.stack(a)) for a in zip(*[p[0] for p in per_lane])]
    cut = list(zip(*[p[1] for p in per_lane]))
    if method == "newton":
        return tg.SweepDraws(*latent, tg.NewtonDraws(_t(np.stack(cut[0], 1)),
                                                     _t(np.stack(cut[1], 1))))
    return tg.SweepDraws(*latent, tg.ESSDraws(
        _t(np.stack(cut[0])), _t(np.stack(cut[1])), _t(np.stack(cut[2])),
        _t(np.stack(cut[3], 1))))


def _chain_state(jstate, k):
    return jax.tree_util.tree_map(lambda a: a[k], jstate)


# ---------------------------------------------------------------------------
# configuration and constants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("regime, kernel", [
    ("GP", "Matern"), ("GP", "RBF"), ("CST", "Matern"), ("RDM", "Matern")])
def test_make_constants_time_gp(regime, kernel):
    """L_time and Lambda_time as the JAX package builds them in the GP
    regime (zeroed prior sds, float64 on the host), None in CST and RDM;
    the regime itself agrees with the JAX package's over (H, ls)."""
    for horizon in (1, 2, 3, 10):
        for ls in (0.05, 0.1, 0.2, 2.0, 5.999, 6.0, 10.0, 30.0):
            assert (GPIRTConfig(n=4, m=3, horizon=horizon, theta_ls=ls).theta_regime
                    == JConfig(n=4, m=3, horizon=horizon, theta_ls=ls).theta_regime)
    kw = dict(n=n, m=m, horizon=H, grid_size=N, dtype="float64",
              theta_os=1.3, theta_ls=LS[regime], kernel=kernel)
    priors = (np.zeros((3, m)), np.full((3, m), 2.0), np.zeros((2, n)),
              np.full((2, n), 0.7))
    want = j_make_constants(JConfig(**kw), *priors)
    got = make_constants(GPIRTConfig(**kw), *priors, device="cpu")
    for name in ("L_time", "Lambda_time"):
        if regime == "GP":
            _close(getattr(got, name), getattr(want, name), 1e-12)
        else:
            assert getattr(got, name) is None and getattr(want, name) is None
    if regime == "GP":
        lam, L = got.Lambda_time, got.L_time
        np.testing.assert_allclose((lam @ L @ L.mT).numpy(), np.eye(H), atol=1e-8)


@pytest.mark.parametrize("regime", ["CST", "RDM", "GP"])
def test_sweep_draws_theta_noise_layout(regime):
    """u_theta is (K, n, N) in CST, so one session's stream is unchanged,
    and (K, H, n, N) in RDM and GP; the other draws keep their layouts."""
    s = setup_for(regime)
    d = tg.sweep_draws(torch.Generator().manual_seed(0), K, s["consts"], s["cfg"])
    lead = (K, n, N) if regime == "CST" else (K, H, n, N)
    assert d.u_theta.shape == lead
    assert d.u_z.shape == (K, H, n, m) and d.cut.rs.shape == (64, K, H, m)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("temp", [None, 4.0])
@pytest.mark.parametrize("regime", ["CST", "RDM", "GP"])
def test_theta_block_matches(regime, temp):
    """theta indices exactly equal in each regime (same Gumbel uniforms);
    CST shares one draw over the sessions, RDM and GP do not."""
    s = setup_for(regime)
    jstate, jconsts, jcfg = s["jstate"], s["jconsts"], s["jcfg"]
    y = jnp.asarray(s["y"])
    keys = jax.random.split(jax.random.key(21), K)
    want = np.stack([np.asarray(jg._draw_theta_grid(
        keys[k], _chain_state(jstate, k),
        jg.compute_mu_star(jconsts, jstate.beta[k]), y, jconsts, jcfg, temp))
        for k in range(K)])
    u = _t(np.stack([_theta_uniforms(key, regime) for key in keys]))
    st = s["state"]
    got = tg._draw_theta_grid(st, tg.compute_mu_star(s["consts"], st.beta),
                              s["yt"], s["consts"], s["cfg"], u, temp)
    np.testing.assert_array_equal(got.numpy(), want)
    same = (got == got[:, :1]).all()
    assert bool(same) == (regime == "CST")


@pytest.mark.parametrize("temp", [None, 4.0])
def test_fstar_block_matches_lowrank_bsolve(temp):
    """The port's push-through f* at H = 3 against the JAX package's H > 1
    branch, alpha = B^-1 rhs by lowrank_bsolve."""
    s = setup_for("GP")
    jstate, jconsts, jcfg = s["jstate"], s["jconsts"], s["jcfg"]
    z_resid = np.random.default_rng(6).standard_normal((K, H, n, m))
    keys = jax.random.split(jax.random.key(23), K)
    want = [np.stack([np.asarray(jg.draw_fstar_conjugate(
        keys[k], _chain_state(jstate, k), jnp.asarray(z_resid[k]), jcfg,
        jconsts, temp)[i]) for k in range(K)]) for i in range(2)]
    q = jconsts.U_se.shape[1]
    z_q, z_p, z_n, eps = (_t(np.stack(a)) for a in
                          zip(*[_fstar_draws(key, q) for key in keys]))
    fstar, f = tg.draw_fstar_conjugate(s["state"], _t(z_resid), s["cfg"],
                                       s["consts"], z_q, z_p, z_n, eps, temp)
    _close(fstar, want[0])
    _close(f, want[1])


# ---------------------------------------------------------------------------
# whole sweeps and the SMC initialization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("C, method", [(2, "ess"), (3, "ess"), (3, "newton")])
@pytest.mark.parametrize("regime", ["RDM", "GP"])
def test_three_sweeps_match(regime, C, method):
    """Three whole sweeps at H = 3, state by state and ll by ll: theta
    exactly, the rest to 1e-8."""
    s = setup_for(regime, C, method)
    jcfg, jconsts = s["jcfg"], s["jconsts"]
    y = jnp.asarray(s["y"])
    sweep = jax.jit(jax.vmap(lambda st, k: jg.gibbs_sweep(st, k, y, jconsts, jcfg)))
    jstate, state = s["jstate"], s["state"]
    q = jconsts.U_se.shape[1]
    for it in range(3):
        keys = jax.vmap(lambda k: jax.random.fold_in(k, it))(s["keys"])
        jstate, jll = sweep(jstate, keys)
        draws = _port_draws([_sweep_draws(keys[k], q, regime, C, method)
                             for k in range(K)], method)
        state, ll = tg.gibbs_sweep(state, draws, s["yt"], s["consts"], s["cfg"])
        np.testing.assert_array_equal(state.theta_idx.numpy(),
                                      np.asarray(jstate.theta_idx))
        for name in ("f", "beta", "thresholds", "fstar"):
            _close(getattr(state, name), getattr(jstate, name), 1e-8)
        _close(ll, jll)
    assert not bool((state.theta_idx == state.theta_idx[:, :1]).all())


def test_anneal_init_matches_gp(monkeypatch):
    """anneal_init at H = 3 in the GP regime against the JAX anneal_init
    given the same draws (its init keys, each step's resample uniform and
    tempered sweep keys replayed): the annealed states match (theta
    exactly, the rest to 1e-8), as do the weight-ESS trace and the
    resample count."""
    Ka, steps, t_max = 4, 4, 8.0
    s = setup_for("GP")
    jcfg, jconsts = s["jcfg"], s["jconsts"]
    keys = jax.random.split(jax.random.key(31), Ka)
    theta_init = np.random.default_rng(4).uniform(-1, 1, (Ka, H, n))
    want, jinfo = j_anneal_init(keys, jnp.asarray(s["y"]), theta_init,
                                s["thr_init"], jconsts, jcfg, n_steps=steps,
                                max_temp=t_max)

    lane = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    k_init, k_run, k_res = lane[:, 0], lane[:, 1], lane[0, 2]
    z_beta, z_fstar = [], []
    for k in k_init:
        k_beta, k_f, _ = jax.random.split(k, 3)
        z_beta.append(np.asarray(jax.random.normal(k_beta, (H, 3, m), _F64)))
        z_fstar.append(np.asarray(jax.random.normal(k_f, (H, N, m), _F64)))
    ids = list(range(steps + 1, steps + 1 + smc.WARM_STEPS)) + list(range(1, steps))
    us = [jax.random.uniform(jax.random.fold_in(k_res, i), (), _F64)
          for i in ids + [steps + 1]]
    q = jconsts.U_se.shape[1]
    sweeps = [_port_draws([_sweep_draws(
        jax.random.fold_in(jax.random.fold_in(k_run[c], i), 0), q, "GP", 2, "ess")
        for c in range(Ka)], "ess") for i in ids]
    real_rand = torch.rand

    def resample_u(*a, **kw):
        if a and a[0] == ():
            return _t(us.pop(0))
        return real_rand(*a, **kw)

    monkeypatch.setattr(smc, "init_draws", lambda *a: tg.InitDraws(
        _t(np.stack(z_beta)), _t(np.stack(z_fstar))))
    monkeypatch.setattr(smc, "sweep_draws", lambda *a: sweeps.pop(0))
    monkeypatch.setattr(torch, "rand", resample_u)
    got, info = smc.anneal_init(torch.Generator(), s["yt"], _t(theta_init),
                                _t(s["thr_init"]), s["consts"], s["cfg"],
                                n_steps=steps, max_temp=t_max)
    assert not sweeps and not us
    np.testing.assert_array_equal(got.theta_idx.numpy(), np.asarray(want.theta_idx))
    for name in ("f", "beta", "thresholds", "fstar"):
        _close(getattr(got, name), getattr(want, name), 1e-8)
    _close(info["weight_ess"], jinfo["weight_ess"], 1e-8)
    assert info["n_resamples"] == jinfo["n_resamples"]


# ---------------------------------------------------------------------------
# gpirt_mcmc on cubes and the simulators
# ---------------------------------------------------------------------------


def _cube():
    """simulate_dynamic's cube with item 0 unanimous over every session
    (dropped) and item 1 unanimous in session 0 only (kept)."""
    _, cube = datasets.simulate_dynamic(0, n=10, m=5, horizon=3)
    cube[:, 0, :] = 1.0
    cube[:, 1, 0] = 0.0
    cube[0, 2, 1] = np.nan
    return cube


@pytest.mark.parametrize("regime", ["CST", "RDM", "GP"])
def test_gpirt_mcmc_cube(regime):
    """(n, m, H) cubes in each regime: reference layouts, finite ll, theta
    shared by the sessions only under CST, m after the unanimity drop as
    the JAX package's recode_cube gives it; a theta_init of (n,) or (n, 1)
    is copied across sessions, the run the same as from its (n, H) tile."""
    cube = _cube()
    m_want = j_recode_cube(cube, VOTES, verbose=False).shape[1]
    assert m_want == 4
    kw = dict(sample_iterations=3, burn_iterations=1, CHAIN=2, vote_codes=VOTES,
              theta_ls=LS[regime], dtype="float64", device="cpu")
    ti = np.linspace(-1, 1, 10)
    runs = [gpirt_mcmc(cube, theta_init=t, **kw)
            for t in (ti, ti[:, None], np.tile(ti[:, None], (1, 3)))]
    for d in runs[0]:
        assert d["theta"].shape == (3, 10, 3)
        assert d["beta"].shape == (3, 3, m_want, 3)
        assert d["threshold"].shape == (3, m_want, 3, 3)
        assert np.isfinite(d["ll"]).all() and np.isfinite(d["theta"]).all()
        shared = (d["theta"] == d["theta"][..., :1]).all()
        assert shared == (regime == "CST")
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            for k in ("theta", "beta", "threshold", "ll"):
                np.testing.assert_array_equal(a[k], b[k])
    out = gpirt_mcmc(cube, vote_codes=None, **{k: v for k, v in kw.items()
                                               if k != "vote_codes"})
    assert out[0]["beta"].shape == (3, 3, 5, 3)  # no recoding: nothing dropped


@pytest.mark.parametrize("missing", [0.0, 0.1])
def test_simulators_match(missing):
    for seed in (0, 3):
        for got, want in ((datasets.simulate_dynamic(seed, n=15, m=7, horizon=4,
                                                      missing=missing),
                           j_datasets.simulate_dynamic(seed, n=15, m=7, horizon=4,
                                                       missing=missing)),
                          (datasets.simulate_2pl(seed, n=20, m=6, missing=missing),
                           j_datasets.simulate_2pl(seed, n=20, m=6, missing=missing))):
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("temp", [None, 4.0])
def test_gp_theta_block_matches_in_lane_chunks(temp, chunk, monkeypatch):
    """The GP theta draw's sessions product runs LANE_CHUNK lanes at a time
    (``ops.linalg.lane_chunked``): with the chunk at 1 lane (two chunks)
    and at 3 (one chunk padded from 2 lanes) the block still equals JAX's."""
    monkeypatch.setattr(linalg, "LANE_CHUNK", chunk)
    test_theta_block_matches("GP", temp)
