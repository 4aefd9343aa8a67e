"""The port's ordinal (C > 2) path and the Newton cutpoint updates against
the JAX package.

As in tests/test_torch_gibbs.py, both packages compute in float64 on the
CPU from the same constants and state, the random draws made in JAX from
the reference's own key splits and handed to the port's pure blocks:

  * draw_threshold (ESS): ``k_nu, k_ess = split(key)``; ess_update then
    takes ``k_u, k_eps, k_loop = split(k_ess, 3)`` and one
    ``key, k_r = split(key)`` a round; eps0 is ``uniform(maxval=2 pi)``;
  * Newton: try k takes ``k_z, k_u, key = split(fold_in(key, k), 3)``.

y has masked cells. Tolerances: rtol 1e-10 a block, 1e-8 after three
sweeps, theta indices exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpirt_tpu.api import _coerce_thresholds as j_coerce_thresholds
from gpirt_tpu.api import default_thresholds as j_default_thresholds
from gpirt_tpu.models import gibbs as jg
from gpirt_tpu.models.config import GPIRTConfig as JConfig
from gpirt_tpu.models.config import make_constants as j_make_constants
from gpirt_tpu.ops.ess import ess_update as j_ess_update
from gpirt_tpu.ops.likelihood import ordinal_ll_terms as j_ordinal_ll_terms
from gpirt_tpu.parallel.smc import anneal_init as j_anneal_init
from gpirt_tpu.utils.datasets import load_sdo as j_load_sdo
from gpirt_tpu_torch import gpirt_mcmc
from gpirt_tpu_torch.api import _coerce_thresholds, default_thresholds
from gpirt_tpu_torch.convert import constants_from_numpy, state_from_numpy
from gpirt_tpu_torch.models import gibbs as tg
from gpirt_tpu_torch.models.config import GPIRTConfig
from gpirt_tpu_torch.ops import ess
from gpirt_tpu_torch.ops.ess import ess_update
from gpirt_tpu_torch.ops.likelihood import delta_to_threshold, threshold_to_delta
from gpirt_tpu_torch.ops.threshold_ess import binary_threshold_ess
from gpirt_tpu_torch.parallel import smc
from gpirt_tpu_torch.utils.datasets import load_sdo
from test_torch_gibbs import (
    H,
    K,
    N,
    _close,
    _fstar_draws,
    _per_chain,
    _t,
    m,
    n,
)

_TWO_PI = 6.283185307179586
_F64 = jnp.float64


def _ordinal_y(C, seed=0):
    """Ordinal responses 1..C with ~15% masked cells, every category used."""
    rng = np.random.default_rng(seed)
    theta = np.linspace(-1.5, 1.5, n)
    latent = np.outer(theta, rng.standard_normal(m) * 1.5) + rng.standard_normal((n, m))
    cuts = np.quantile(latent, np.arange(1, C) / C)
    y = (np.digitize(latent, cuts) + 1).astype(np.int32)
    y[rng.random((n, m)) < 0.15] = 0
    return y[None]


def _setup(C, method="ess"):
    jcfg = JConfig(n=n, m=m, horizon=H, C=C, grid_size=N, dtype="float64",
                   f_method="conjugate", threshold_method=method,
                   threshold_ess_twophase=False)
    cfg = GPIRTConfig(n=n, m=m, horizon=H, C=C, grid_size=N, dtype="float64",
                      threshold_method=method)
    jconsts = j_make_constants(
        jcfg, beta_prior_means=np.zeros((3, m)),
        beta_prior_sds=np.full((3, m), 1.5),
        theta_prior_means=np.zeros((2, n)),
        theta_prior_sds=np.full((2, n), 0.5))
    y = _ordinal_y(C)
    rng = np.random.default_rng(1)
    theta_init = rng.uniform(-2, 2, (K, H, n))
    thr_init = default_thresholds(C, m, H)
    keys = jax.random.split(jax.random.key(7), K)
    jstate = jax.vmap(lambda k, t: jg.init_state(
        k, t, jnp.asarray(thr_init), jnp.asarray(y), jconsts, jcfg))(
        keys, jnp.asarray(theta_init))
    # move the cutpoints off qnorm(i/C), each lane differently
    d = _t(rng.standard_normal((K, H, m, C - 1)) * 0.3)
    thr = delta_to_threshold(threshold_to_delta(_t(jstate.thresholds)) + d)
    jstate = jstate._replace(thresholds=jnp.asarray(thr.numpy()))
    return dict(jcfg=jcfg, cfg=cfg, jconsts=jconsts, y=y, yt=torch.as_tensor(y),
                consts=constants_from_numpy(jconsts, device="cpu",
                                            dtype=torch.float64),
                keys=keys, jstate=jstate,
                state=state_from_numpy(jstate, device="cpu", dtype=torch.float64),
                theta_init=theta_init, thr_init=thr_init)


_SETUPS = {}


def setup_for(C, method="ess"):
    if (C, method) not in _SETUPS:
        _SETUPS[(C, method)] = _setup(C, method)
    return _SETUPS[(C, method)]


def _ess_draws(key, shape, d, rounds=64):
    """draw_threshold's ordinal ESS draws from ``key``: nu (*shape, d),
    logu, eps0 (*shape) and the shrink table (rounds, *shape)."""
    k_nu, k_ess = jax.random.split(key)
    nu = jax.random.normal(k_nu, shape + (d,), _F64)
    return [np.asarray(nu)] + _ess_loop_draws(k_ess, shape, rounds)


def _ess_loop_draws(key, shape, rounds=64):
    """ess_update's own uniforms from ``key``: logu, eps0, rs (rounds, ...)."""
    k_u, k_eps, k_loop = jax.random.split(key, 3)
    logu = jnp.log(jax.random.uniform(k_u, shape, dtype=_F64))
    eps0 = jax.random.uniform(k_eps, shape, dtype=_F64, maxval=_TWO_PI)
    rs, k = [], k_loop
    for _ in range(rounds):
        k, k_r = jax.random.split(k)
        rs.append(jax.random.uniform(k_r, shape, dtype=_F64))
    return [np.asarray(a) for a in (logu, eps0, jnp.stack(rs))]


def _newton_draws(key, shape, d, tries=2):
    """The Newton update's draws from ``key``: z (tries, *shape, d) and
    log u (tries, *shape)."""
    zs, lus = [], []
    for k in range(tries):
        k_z, k_u, key = jax.random.split(jax.random.fold_in(key, k), 3)
        zs.append(np.asarray(jax.random.normal(k_z, shape + (d,), _F64)))
        lus.append(np.log(np.asarray(jax.random.uniform(k_u, shape, _F64))))
    return np.stack(zs), np.stack(lus)


def _stack_lanes(per_lane, axis):
    """Per-chain draws -> one array with the chain axis at ``axis``."""
    return _t(np.stack(per_lane, axis=axis))


# ---------------------------------------------------------------------------
# ess_update
# ---------------------------------------------------------------------------


def _toy():
    """A Gaussian toy likelihood over (3, 5) lanes of dimension 2."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 2))
    nu = rng.standard_normal((3, 5, 2))
    mu = rng.standard_normal((3, 5, 2))
    sd = 0.2 + rng.random((3, 5, 2))
    return x, nu, mu, sd


@pytest.mark.parametrize("rounds", [1, 2, 64])
def test_ess_update_matches_and_ignores_the_exit_policy(rounds, monkeypatch):
    """Against gpirt_tpu.ops.ess.ess_update with max_rounds = R, to 1e-10;
    and the same draws give the same result whether the loop stops at the
    first round with every lane done or, with its exit test stubbed out,
    runs all R rounds."""
    x, nu, mu, sd = _toy()
    key = jax.random.key(5)
    want = j_ess_update(key, jnp.asarray(x), jnp.asarray(nu),
                        lambda v: -0.5 * jnp.sum(((v - mu) / sd) ** 2, axis=-1),
                        max_rounds=rounds)
    logu, eps0, rs = _ess_loop_draws(key, (3, 5), rounds)
    mu_t, sd_t = _t(mu), _t(sd)

    def loglik(v):
        return -0.5 * torch.sum(((v - mu_t) / sd_t) ** 2, dim=-1)

    args = (_t(x), _t(nu), loglik, _t(logu), _t(eps0), _t(rs))
    before = ess_update.rounds
    early = ess_update(*args)
    ran = ess_update.rounds - before
    monkeypatch.setattr(ess, "_any_active", lambda active: True)
    full = ess_update(*args)
    assert ess_update.rounds - before - ran == rounds
    _close(early, want)
    assert torch.equal(early, full)
    kept = (early == _t(x)).all(dim=-1)
    if rounds < 64:
        assert 0 < int(kept.sum()) < kept.numel()  # some lanes hit the cap
    else:
        assert ran < rounds and not bool(kept.any())


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("temp", [None, 4.0])
@pytest.mark.parametrize("C", [3, 5])
def test_z_block_matches_ordinal(C, temp):
    """The generic truncated-normal branch, including far-tail cells that
    take the nearest-bound fallback."""
    s = setup_for(C)
    rng = np.random.default_rng(5)
    g = rng.standard_normal((K, H, n, m)) * 2.0
    g[:, :, 0, :] = 40.0
    g[:, :, 1, :] = -40.0
    thr = np.asarray(s["jstate"].thresholds)
    keys = jax.random.split(jax.random.key(22), K)
    y = jnp.asarray(s["y"])
    want = _per_chain(lambda k, gg, tt: jg.draw_z_truncnorm(k, gg, y, tt, temp),
                      keys, jnp.asarray(g), jnp.asarray(thr))
    u = _t(np.stack([np.asarray(jg._uniform2d(key, (H, n, m), _F64)) for key in keys]))
    got = tg.draw_z_truncnorm(_t(g), s["yt"], _t(thr), u, temp)
    _close(got, want)
    y0 = s["y"][0, 0]  # g = 40: a cell below the top category takes t_y
    tail = (y0 > 0) & (y0 < C)
    hi = np.take_along_axis(thr[:, 0], y0[None, :, None], axis=-1)[..., 0]
    assert tail.any()
    np.testing.assert_array_equal(got.numpy()[:, 0, 0][:, tail], hi[:, tail])


@pytest.mark.parametrize("temp", [None, 4.0])
@pytest.mark.parametrize("C", [3, 5])
def test_threshold_ess_block_matches_ordinal(C, temp):
    s = setup_for(C)
    jstate = s["jstate"]
    rng = np.random.default_rng(8)
    mu = rng.standard_normal((K, H, n, m)) * 0.5
    y = jnp.asarray(s["y"])
    keys = jax.random.split(jax.random.key(25), K)
    want = _per_chain(lambda k, thr, f, mm: jg.draw_threshold(
        k, thr, f, mm, y, s["jcfg"], temp), keys, jstate.thresholds, jstate.f,
        jnp.asarray(mu))
    nu, logu, eps0, rs = zip(*[_ess_draws(k, (H, m), C - 1) for k in keys])
    st = s["state"]
    got = tg.draw_threshold(st.thresholds, st.f, _t(mu), s["yt"], s["cfg"],
                            _stack_lanes(nu, 0), _stack_lanes(logu, 0),
                            _stack_lanes(eps0, 0), _stack_lanes(rs, 1), temp)
    _close(got, want)
    moved = (got != st.thresholds)[..., 1:-1]
    assert float(moved.double().mean()) > 0.8


@pytest.mark.parametrize("temp", [None, 4.0])
@pytest.mark.parametrize("C", [2, 3, 5])
def test_threshold_newton_block_matches(C, temp):
    """_draw_threshold_binary_newton (C = 2) and
    _draw_threshold_newton_ordinal (C = 3, 5) against draw_threshold with
    threshold_method='newton', which hands them its key."""
    s = setup_for(C, "newton")
    jstate = s["jstate"]
    rng = np.random.default_rng(9)
    mu = rng.standard_normal((K, H, n, m)) * 0.5
    y = jnp.asarray(s["y"])
    keys = jax.random.split(jax.random.key(26), K)
    want = _per_chain(lambda k, thr, f, mm: jg.draw_threshold(
        k, thr, f, mm, y, s["jcfg"], temp), keys, jstate.thresholds, jstate.f,
        jnp.asarray(mu))
    z, logu = zip(*[_newton_draws(k, (H, m), C - 1) for k in keys])
    st = s["state"]
    newton = (tg._draw_threshold_binary_newton if C == 2
              else tg._draw_threshold_newton_ordinal)
    launches = binary_threshold_ess.launches
    got = newton(st.thresholds, st.f + _t(mu), s["yt"], _stack_lanes(z, 1),
                 _stack_lanes(logu, 1), tg._temp_scales(temp)[1])
    _close(got, want)
    assert binary_threshold_ess.launches == launches
    moved = (got != st.thresholds)[..., 1:-1]
    assert float(moved.double().mean()) > 0.5


# ---------------------------------------------------------------------------
# whole sweeps and the SMC initialization
# ---------------------------------------------------------------------------


def _sweep_draws(key, q, C, method):
    """One gibbs_sweep's draws, replayed from its key as the JAX conjugate
    branch consumes them (mix_subsweeps = 1)."""
    k_f, _, k_th, k_b, k_t = jax.random.split(key, 5)
    latent = [np.asarray(a) for a in (
        jg._uniform2d(jax.random.fold_in(k_th, 0), (n, N), _F64),
        jg._uniform2d(jax.random.fold_in(k_f, 0), (H, n, m), _F64),
        *_fstar_draws(jax.random.fold_in(k_f, 2), q),
        jax.random.normal(k_b, (H, m, 3), _F64))]
    if method == "newton":
        return latent, _newton_draws(k_t, (H, m), C - 1)
    return latent, _ess_draws(k_t, (H, m), C - 1)


def _port_draws(per_lane, method):
    """Per-chain replayed draws -> SweepDraws with the port's layouts."""
    latent = [_stack_lanes(a, 0) for a in zip(*[p[0] for p in per_lane])]
    cut = list(zip(*[p[1] for p in per_lane]))
    if method == "newton":
        return tg.SweepDraws(*latent, tg.NewtonDraws(_stack_lanes(cut[0], 1),
                                                     _stack_lanes(cut[1], 1)))
    return tg.SweepDraws(*latent, tg.ESSDraws(
        _stack_lanes(cut[0], 0), _stack_lanes(cut[1], 0), _stack_lanes(cut[2], 0),
        _stack_lanes(cut[3], 1)))


@pytest.mark.parametrize("method", ["ess", "newton"])
@pytest.mark.parametrize("C", [3, 5])
def test_three_sweeps_match_ordinal(C, method):
    """Three whole sweeps, state by state and ll by ll: theta exactly, the
    rest to 1e-8."""
    s = setup_for(C, method)
    jcfg, jconsts = s["jcfg"], s["jconsts"]
    y = jnp.asarray(s["y"])
    sweep = jax.jit(jax.vmap(lambda st, k: jg.gibbs_sweep(st, k, y, jconsts, jcfg)))
    jstate, state = s["jstate"], s["state"]
    q = jconsts.U_se.shape[1]
    for it in range(3):
        keys = jax.vmap(lambda k: jax.random.fold_in(k, it))(s["keys"])
        jstate, jll = sweep(jstate, keys)
        draws = _port_draws([_sweep_draws(keys[k], q, C, method) for k in range(K)],
                            method)
        state, ll = tg.gibbs_sweep(state, draws, s["yt"], s["consts"], s["cfg"])
        np.testing.assert_array_equal(state.theta_idx.numpy(),
                                      np.asarray(jstate.theta_idx))
        for name in ("f", "beta", "thresholds", "fstar"):
            _close(getattr(state, name), getattr(jstate, name), 1e-8)
        _close(ll, jll, 1e-10)
    t = state.thresholds[..., 1:-1]
    assert bool((t[..., 1:] > t[..., :-1]).all())


def test_sweep_draws_layouts_and_binary_stream():
    """C > 2 gives nu (K, H, m, C-1); "newton" makes its draws and no ESS
    draws; at C = 2 the generator gives exactly the numbers it gave with nu
    of shape (K, H, m)."""
    consts = setup_for(3)["consts"]

    def draws(C, method):
        cfg = GPIRTConfig(n=n, m=m, C=C, grid_size=N, dtype="float64",
                          threshold_method=method, threshold_mh_tries=3)
        return tg.sweep_draws(torch.Generator().manual_seed(0), K, consts, cfg)

    d = draws(5, "newton").cut
    assert isinstance(d, tg.NewtonDraws)
    assert d.z.shape == (3, K, H, m, 4) and d.logu.shape == (3, K, H, m)
    d = draws(3, "ess").cut
    assert isinstance(d, tg.ESSDraws) and d.nu.shape == (K, H, m, 2)
    d = draws(2, "ess")
    gen = torch.Generator().manual_seed(0)
    shapes = [(K, n, N), (K, H, n, m), (K, H, consts.U_se.shape[1], m), (K, H, 3, m),
              (K, H, N, m), (K, H, n, m), (K, H, m, 3), (K, H, m)]
    old = [torch.rand(shapes[0], generator=gen, dtype=torch.float64),
           torch.rand(shapes[1], generator=gen, dtype=torch.float64)]
    old += [torch.randn(sh, generator=gen, dtype=torch.float64) for sh in shapes[2:]]
    old += [torch.rand((K, H, m), generator=gen, dtype=torch.float64)
            for _ in range(2)]
    assert torch.equal(d.cut.nu[..., 0], old[7])
    assert torch.equal(d.cut.logu, torch.log(old[8]))
    assert torch.equal(d.cut.eps0, old[9] * _TWO_PI)
    for got, want in zip(d[:7], old[:7]):
        assert torch.equal(got, want)


def test_anneal_init_matches_ordinal(monkeypatch):
    """anneal_init at C = 3 against the JAX anneal_init given the same
    draws: its init keys, each step's resample uniform and tempered sweep
    keys are replayed into the port's draw functions. The annealed states
    match (theta exactly, the rest to 1e-8), as do the weight-ESS trace
    and the resample count."""
    C, Ka, steps, t_max = 3, 4, 4, 8.0
    s = setup_for(C)
    jcfg, jconsts, y = s["jcfg"], s["jconsts"], s["y"]
    keys = jax.random.split(jax.random.key(31), Ka)
    theta_init = np.random.default_rng(4).uniform(-1, 1, (Ka, H, n))
    want, jinfo = j_anneal_init(keys, jnp.asarray(y), theta_init, s["thr_init"],
                                jconsts, jcfg, n_steps=steps, max_temp=t_max)

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
        jax.random.fold_in(jax.random.fold_in(k_run[c], i), 0), q, C, "ess")
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


def test_lane_ll_matches_ordinal():
    """The SMC reweight's per-lane tempered ll at C = 5."""
    s = setup_for(5)
    st = s["state"]
    got = smc._lane_ll(st, 3.0, s["yt"], s["consts"])
    theta = np.asarray(s["jconsts"].grid)[np.asarray(s["jstate"].theta_idx)]
    g = np.asarray(s["jstate"].f) + np.einsum(
        "khnp,khpm->khnm", np.stack([np.ones_like(theta), theta, theta ** 2], -1),
        np.asarray(s["jstate"].beta))
    want = [float(jnp.sum(j_ordinal_ll_terms(
        jnp.asarray(g[k]), jnp.asarray(s["y"]), s["jstate"].thresholds[k],
        1.0 / jnp.sqrt(3.0)))) for k in range(K)]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


# ---------------------------------------------------------------------------
# gpirt_mcmc, thresholds and the SDO loader
# ---------------------------------------------------------------------------


def _ordinal_data(C=3, seed=2):
    y = _ordinal_y(C, seed)[0].astype(np.float64)
    y[y == 0] = np.nan
    return y


@pytest.mark.parametrize("method", ["ess", "newton"])
def test_gpirt_mcmc_ordinal_stores_f_and_fstar(method):
    """C = 3 on the CPU: reference layouts; f* stored with its parametric
    mean, so at each respondent's grid point it is f plus mu(theta)."""
    out = gpirt_mcmc(_ordinal_data(), sample_iterations=4, burn_iterations=2,
                     CHAIN=2, vote_codes=None, store_f=True, store_fstar=True,
                     threshold_method=method, dtype="float64", device="cpu")
    for d in out:
        S = 4
        assert d["theta"].shape == (S, n, 1)
        assert d["threshold"].shape == (S, m, 4, 1)
        assert d["f"].shape == (S, n, m, 1)
        assert d["fstar"].shape == (S, 1001, m, 1)
        t = d["threshold"][..., 1:-1, 0]
        assert np.isfinite(d["ll"]).all() and (np.diff(t, axis=-1) > 0).all()
        theta, beta = d["theta"][..., 0], d["beta"][..., 0]  # (S, n), (S, 3, m)
        idx = np.rint((theta + 5.0) / 0.01).astype(int)
        mu = np.einsum("snp,spm->snm",
                       np.stack([np.ones_like(theta), theta, theta ** 2], -1), beta)
        at = np.take_along_axis(d["fstar"][..., 0], idx[..., None], axis=1)
        np.testing.assert_allclose(at, d["f"][..., 0] + mu, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("shape", ["(C+1,)", "(m, C+1)", "(m, C+1, H)"])
def test_gpirt_mcmc_thresholds_argument(shape):
    """Each accepted shape coerces as the JAX package's _coerce_thresholds
    does, and a run started from qnorm(i/C) given that way is the run with
    the default cutpoints, draw for draw."""
    C, mm = 3, m
    base = default_thresholds(C, mm, 1)  # (1, m, C+1)
    thr = {"(C+1,)": base[0, 0], "(m, C+1)": base[0],
           "(m, C+1, H)": np.moveaxis(base, 0, 2)}[shape]
    np.testing.assert_array_equal(_coerce_thresholds(thr, mm, C, 1),
                                  j_coerce_thresholds(thr, mm, C, 1))
    with pytest.raises(ValueError, match="incompatible"):
        _coerce_thresholds(thr, mm, C + 1, 1)
    kw = dict(sample_iterations=2, burn_iterations=1, CHAIN=2, vote_codes=None,
              dtype="float64", device="cpu")
    given = gpirt_mcmc(_ordinal_data(), thresholds=thr, **kw)
    default = gpirt_mcmc(_ordinal_data(), **kw)
    for a, b in zip(given, default):
        for k in ("theta", "beta", "threshold", "ll"):
            np.testing.assert_array_equal(a[k], b[k])


def test_default_thresholds_c5_and_load_sdo():
    np.testing.assert_allclose(default_thresholds(5, 16, 1),
                               j_default_thresholds(5, 16, 1), rtol=1e-14)
    sdo = load_sdo()
    want = j_load_sdo()
    assert sdo.shape == (1500, 16) and sdo.dtype == np.float64
    np.testing.assert_array_equal(np.isnan(sdo), np.isnan(want))
    np.testing.assert_array_equal(sdo[~np.isnan(sdo)], want[~np.isnan(want)])
    assert set(np.unique(sdo[~np.isnan(sdo)])) == {1.0, 2.0, 3.0, 4.0, 5.0}
