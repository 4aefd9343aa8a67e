"""Each sweep block of the port, and whole sweeps, against the JAX package.

Both packages compute from the same constants and state (carried through
``gpirt_tpu_torch.convert``), in float64 on the CPU. The random draws are
made in JAX from the reference's own key splits and handed to the port's
pure block functions, so the two must agree to float rounding. The JAX
side runs ``threshold_ess_twophase=False``: its cutpoint update is then
``ess_update``, whose per-round uniforms are replayed from its split chain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpirt_tpu.models import gibbs as jg
from gpirt_tpu.models.config import GPIRTConfig as JConfig
from gpirt_tpu.models.config import make_constants as j_make_constants
from gpirt_tpu_torch.convert import constants_from_numpy, state_from_numpy
from gpirt_tpu_torch.models import gibbs as tg
from gpirt_tpu_torch.models.config import GPIRTConfig

K, H, n, m, N = 2, 1, 12, 9, 101
_TWO_PI = 6.283185307179586
_F64 = jnp.float64
RTOL = 1e-10  # float64 rounding through a few small solves


def _data(seed=0):
    """Binary responses with masked cells, from a 2PL-like model."""
    rng = np.random.default_rng(seed)
    theta = np.linspace(-1.5, 1.5, n)
    disc = rng.standard_normal(m) * 1.5
    p = 1 / (1 + np.exp(-np.outer(theta, disc)))
    y = np.where(rng.random((n, m)) < p, 2, 1).astype(np.int32)
    y[rng.random((n, m)) < 0.15] = 0
    return y[None]


@pytest.fixture(scope="module")
def setup():
    jcfg = JConfig(n=n, m=m, horizon=H, C=2, grid_size=N, dtype="float64",
                   f_method="conjugate", threshold_ess_twophase=False)
    cfg = GPIRTConfig(n=n, m=m, horizon=H, C=2, grid_size=N, dtype="float64")
    jconsts = j_make_constants(
        jcfg, beta_prior_means=np.zeros((3, m)),
        beta_prior_sds=np.full((3, m), 1.5),
        theta_prior_means=np.zeros((2, n)),
        theta_prior_sds=np.full((2, n), 0.5))
    consts = constants_from_numpy(jconsts, device="cpu", dtype=torch.float64)
    y = _data()
    rng = np.random.default_rng(1)
    theta_init = rng.uniform(-2, 2, (K, H, n))
    thr_init = np.tile(np.array([-np.inf, 0.0, np.inf]), (H, m, 1))
    keys = jax.random.split(jax.random.key(7), K)
    jstate = jax.vmap(lambda k, t: jg.init_state(
        k, t, jnp.asarray(thr_init), jnp.asarray(y), jconsts, jcfg))(
        keys, jnp.asarray(theta_init))
    return dict(jcfg=jcfg, cfg=cfg, jconsts=jconsts, consts=consts, y=y,
                yt=torch.as_tensor(y), keys=keys, jstate=jstate,
                state=state_from_numpy(jstate, device="cpu", dtype=torch.float64),
                theta_init=theta_init, thr_init=thr_init)


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=rtol)


def _per_chain(fn, keys, *chain_args):
    """Run a JAX block chain by chain; stack the results."""
    outs = [fn(keys[k], *[a[k] for a in chain_args]) for k in range(len(keys))]
    if isinstance(outs[0], tuple):
        return tuple(np.stack([np.asarray(o[i]) for o in outs])
                     for i in range(len(outs[0])))
    return np.stack([np.asarray(o) for o in outs])


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _chain_state(jstate, k):
    return jax.tree_util.tree_map(lambda a: a[k], jstate)


def test_init_state_matches(setup):
    s = setup
    jstate = s["jstate"]
    z_beta, z_fstar = [], []
    for key in s["keys"]:
        k_beta, k_f, _ = jax.random.split(key, 3)
        z_beta.append(jax.random.normal(k_beta, (H, 3, m), _F64))
        z_fstar.append(jax.random.normal(k_f, (H, N, m), _F64))
    draws = tg.InitDraws(_t(np.stack(z_beta)), _t(np.stack(z_fstar)))
    got = tg.init_state(_t(s["theta_init"]), _t(s["thr_init"]), s["consts"],
                        s["cfg"], draws)
    assert torch.equal(got.theta_idx, torch.as_tensor(np.array(jstate.theta_idx)).long())
    for name in ("f", "beta", "thresholds", "fstar"):
        _close(getattr(got, name), getattr(jstate, name))


@pytest.mark.parametrize("temp", [None, 4.0])
def test_theta_block_matches(setup, temp):
    """theta indices are exactly equal (same Gumbel uniforms)."""
    s = setup
    jstate, jconsts, jcfg = s["jstate"], s["jconsts"], s["jcfg"]
    y = jnp.asarray(s["y"])
    keys = jax.random.split(jax.random.key(21), K)
    want = np.stack([np.asarray(jg._draw_theta_grid(
        keys[k], _chain_state(jstate, k),
        jg.compute_mu_star(jconsts, jstate.beta[k]), y, jconsts, jcfg, temp))
        for k in range(K)])
    u = _t(np.stack([np.asarray(jg._uniform2d(key, (n, N), _F64)) for key in keys]))
    st = s["state"]
    got = tg._draw_theta_grid(st, tg.compute_mu_star(s["consts"], st.beta),
                              s["yt"], s["consts"], s["cfg"], u, temp)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("temp", [None, 4.0])
def test_z_block_matches(setup, temp):
    """Truncated-normal latents, including far-tail cells that take the
    nearest-bound fallback."""
    s = setup
    rng = np.random.default_rng(5)
    g = rng.standard_normal((K, H, n, m)) * 2.0
    g[:, :, 0, :] = 40.0  # far right tail: y = 1 cells fall back to t_1
    g[:, :, 1, :] = -40.0
    thr = np.asarray(s["jstate"].thresholds)
    keys = jax.random.split(jax.random.key(22), K)
    y = jnp.asarray(s["y"])
    want = _per_chain(lambda k, gg, tt: jg.draw_z_truncnorm(k, gg, y, tt, temp),
                      keys, jnp.asarray(g), jnp.asarray(thr))
    u = _t(np.stack([np.asarray(jg._uniform2d(key, (H, n, m), _F64)) for key in keys]))
    got = tg.draw_z_truncnorm(_t(g), s["yt"], _t(thr), u, temp)
    _close(got, want)


def _fstar_draws(key, q):
    k_u, k_e = jax.random.split(key)
    k_q, k_p, k_n = jax.random.split(k_u, 3)
    return [np.asarray(a) for a in (
        jg._normal2d(k_q, (H, q, m), _F64), jg._normal2d(k_p, (H, 3, m), _F64),
        jg._normal2d(k_n, (H, N, m), _F64), jg._normal2d(k_e, (H, n, m), _F64))]


@pytest.mark.parametrize("temp", [None, 4.0])
def test_fstar_block_matches(setup, temp):
    s = setup
    jstate, jconsts, jcfg = s["jstate"], s["jconsts"], s["jcfg"]
    rng = np.random.default_rng(6)
    z_resid = rng.standard_normal((K, H, n, m))
    keys = jax.random.split(jax.random.key(23), K)
    want = [np.stack([np.asarray(jg.draw_fstar_conjugate(
        keys[k], _chain_state(jstate, k), jnp.asarray(z_resid[k]), jcfg,
        jconsts, temp)[i]) for k in range(K)]) for i in range(2)]
    q = jconsts.U_se.shape[1]
    z_q, z_p, z_n, eps = (_t(np.stack(a)) for a in
                          zip(*[_fstar_draws(key, q) for key in keys]))
    fstar, f = tg.draw_fstar_conjugate(s["state"], _t(z_resid), s["cfg"],
                                       s["consts"], z_q, z_p, z_n, eps, temp)
    _close(fstar, want[0], 1e-9)
    _close(f, want[1], 1e-9)


@pytest.mark.parametrize("temp", [None, 4.0])
def test_beta_block_matches(setup, temp):
    s = setup
    jconsts, jcfg = s["jconsts"], s["jcfg"]
    rng = np.random.default_rng(7)
    theta = np.asarray(s["jconsts"].grid)[np.asarray(s["jstate"].theta_idx)]
    zmf = rng.standard_normal((K, H, n, m)) + 0.3
    keys = jax.random.split(jax.random.key(24), K)
    want = _per_chain(lambda k, th, zz: jg.draw_beta_conjugate(
        k, th, zz, jconsts, jcfg, temp), keys, jnp.asarray(theta), jnp.asarray(zmf))
    zeta = _t(np.stack([np.asarray(jax.random.normal(key, (H, m, 3), _F64))
                        for key in keys]))
    got = tg.draw_beta_conjugate(_t(theta), _t(zmf), s["consts"], s["cfg"], zeta,
                                 temp)
    _close(got, want)


def _ess_draws(key):
    k_nu, k_ess = jax.random.split(key)
    nu = jax.random.normal(k_nu, (H, m, 1), _F64)[..., 0]
    k_u, k_eps, k_loop = jax.random.split(k_ess, 3)
    logu = jnp.log(jax.random.uniform(k_u, (H, m), dtype=_F64))
    eps0 = jax.random.uniform(k_eps, (H, m), dtype=_F64, maxval=_TWO_PI)
    rs, k = [], k_loop
    for _ in range(64):
        k, k_r = jax.random.split(k)
        rs.append(jax.random.uniform(k_r, (H, m), dtype=_F64))
    return [np.asarray(a) for a in (nu, logu, eps0, jnp.stack(rs))]


@pytest.mark.parametrize("temp", [None, 4.0])
def test_threshold_block_matches(setup, temp):
    s = setup
    jstate, jcfg = s["jstate"], s["jcfg"]
    rng = np.random.default_rng(8)
    mu = rng.standard_normal((K, H, n, m)) * 0.5
    y = jnp.asarray(s["y"])
    keys = jax.random.split(jax.random.key(25), K)
    want = _per_chain(lambda k, thr, f, mm: jg.draw_threshold(
        k, thr, f, mm, y, jcfg, temp), keys, jstate.thresholds, jstate.f,
        jnp.asarray(mu))
    nu, logu, eps0, rs = (np.stack(a) for a in zip(*[_ess_draws(k) for k in keys]))
    st = s["state"]
    got = tg.draw_threshold(st.thresholds, st.f, _t(mu), s["yt"], s["cfg"],
                            _t(nu), _t(logu), _t(eps0),
                            _t(rs).transpose(0, 1).contiguous(), temp)
    _close(got, want)


def _sweep_draws(key, q):
    """One gibbs_sweep's draws, replayed from its key exactly as the JAX
    conjugate branch consumes them (mix_subsweeps = 1)."""
    k_f, _, k_th, k_b, k_t = jax.random.split(key, 5)
    u_theta = jg._uniform2d(jax.random.fold_in(k_th, 0), (n, N), _F64)
    u_z = jg._uniform2d(jax.random.fold_in(k_f, 0), (H, n, m), _F64)
    z_q, z_p, z_n, eps = _fstar_draws(jax.random.fold_in(k_f, 2), q)
    zeta = jax.random.normal(k_b, (H, m, 3), _F64)
    nu, logu, eps0, rs = _ess_draws(k_t)
    return [np.asarray(a) for a in
            (u_theta, u_z, z_q, z_p, z_n, eps, zeta, nu, logu, eps0, rs)]


@pytest.mark.parametrize("temp", [None, 4.0])
def test_three_sweeps_match(setup, temp):
    """Three whole sweeps, state by state and ll by ll: theta exactly, the
    rest to 1e-8 (three sweeps compound float64 rounding through the
    equilibrated (q+3)-square f* solves)."""
    s = setup
    jcfg, jconsts = s["jcfg"], s["jconsts"]
    y = jnp.asarray(s["y"])
    sweep = jax.jit(jax.vmap(
        lambda st, k: jg.gibbs_sweep(st, k, y, jconsts, jcfg, temp)))
    jstate, state = s["jstate"], s["state"]
    q = jconsts.U_se.shape[1]
    for it in range(3):
        keys = jax.vmap(lambda k: jax.random.fold_in(k, it))(s["keys"])
        jstate, jll = sweep(jstate, keys)
        per = [_sweep_draws(keys[k], q) for k in range(K)]
        draws = [_t(np.stack(a)) for a in zip(*per)]
        draws[-1] = draws[-1].transpose(0, 1).contiguous()  # rs: (R, K, H, m)
        draws = tg.SweepDraws(*draws[:7], tg.ESSDraws(*draws[7:]))
        state, ll = tg.gibbs_sweep(state, draws, s["yt"], s["consts"], s["cfg"],
                                   temp)
        np.testing.assert_array_equal(state.theta_idx.numpy(),
                                      np.asarray(jstate.theta_idx))
        for name in ("f", "beta", "thresholds", "fstar"):
            _close(getattr(state, name), getattr(jstate, name), 1e-8)
        _close(ll, jll, 1e-10)
