"""The port's grid and shared-IRF sweeps and entry points against the JAX
package: three whole sweeps under each f-method (grid with and without
constant_IRF, conjugate and two-stage under it), a sweep with one
temperature a chain, a replayed SMC anneal, the sweeps' draw layouts, and
gpirt_mcmc, recover_fstar and recover_fstar_batch under constant_IRF.

The setups, the replay of JAX's draws from its keys, the op-by-op
evaluation of JAX's inducing-point f* and the tolerances are
tests/test_torch_constant_irf.py's (its module docstring).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a process)
from gpirt_tpu.api import _recover_one as j_recover_one
from gpirt_tpu.models import gibbs as jg
from gpirt_tpu.models.config import GPIRTConfig as JConfig
from gpirt_tpu.models.config import make_constants as j_make_constants
from gpirt_tpu.parallel.smc import anneal_init as j_anneal_init
from gpirt_tpu_torch import gpirt_mcmc, recover_fstar, recover_fstar_batch
from gpirt_tpu_torch.api import _recover_one, default_thresholds
from gpirt_tpu_torch.convert import constants_from_numpy
from gpirt_tpu_torch.models import gibbs as tg
from gpirt_tpu_torch.models.config import GPIRTConfig
from gpirt_tpu_torch.parallel import smc
from gpirt_tpu_torch.utils.datasets import simulate_dynamic
from gpirt_tpu_torch.utils.response import recode_cube
from test_torch_constant_irf import (  # noqa: F401 (jax_inducing_op_by_op: a fixture)
    _F64,
    VOTES,
    H,
    K,
    N,
    Q,
    _close,
    _close_lanes,
    _draw_f,
    _grid_prior,
    _init,
    _join,
    _spread,
    _sweep,
    _t,
    _y,
    jax_inducing_op_by_op,
    m,
    n,
    setup_for,
)


# ---------------------------------------------------------------------------
# whole sweeps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("f_method, C, method, pooled", [
    ("grid", 2, "ess", True), ("grid", 3, "ess", True), ("grid", 2, "newton", True),
    ("grid", 2, "ess", False), ("conjugate", 2, "ess", True),
    ("two_stage", 2, "ess", True),
])
def test_three_sweeps_match(f_method, C, method, pooled, jax_inducing_op_by_op):
    """Three whole sweeps, state by state and ll by ll: theta exactly, the
    rest to 1e-8 (the two-stage sampler's fields plus four times JAX's own
    spread, f* being the inducing-point draw's); under constant_IRF f* and
    the cutpoints stay one a chain."""
    s = setup_for(f_method, C, method, pooled)
    y = jnp.asarray(s["y"])
    sweep = jax.jit(lambda st, k, c: jax.vmap(
        lambda st1, k1: jg.gibbs_sweep(st1, k1, y, c, s["jcfg"]))(st, k))
    keys = [jax.vmap(lambda k: jax.random.fold_in(k, it))(s["keys"]) for it in range(3)]

    def jax_sweeps(jconsts):
        jstate, out = s["jstate"], []
        for k in keys:
            jstate, jll = sweep(jstate, k, jconsts)
            out.append((jstate, jll))
        return out

    def fields(st, ll):
        return [st.f, st.beta, st.thresholds, st.fstar, ll]

    spread = ([np.zeros(())] * 15 if f_method != "two_stage" else _spread(
        lambda c: [a for out in jax_sweeps(c) for a in fields(*out)], s["jconsts"]))
    state = s["state"]
    for it, (jstate, jll) in enumerate(jax_sweeps(s["jconsts"])):
        draws = _join([_sweep(keys[it][c], f_method, C, method, pooled) for c in range(K)])
        state, ll = tg.gibbs_sweep(state, draws, s["yt"], s["consts"], s["cfg"])
        np.testing.assert_array_equal(state.theta_idx.numpy(), np.asarray(jstate.theta_idx))
        for j, (got, want) in enumerate(zip(fields(state, ll), fields(jstate, jll))):
            _close_lanes(got, want, spread[5 * it + j], 1e-8)
        if pooled:
            assert torch.equal(state.fstar[:, 0], state.fstar[:, -1])
            assert torch.equal(state.thresholds[:, 0], state.thresholds[:, -1])
    assert not bool((state.beta[:, 0] == state.beta[:, -1]).all())  # beta a session
    t = state.thresholds[..., 1:-1]
    assert bool((t[..., 1:] > t[..., :-1]).all())


def test_tempered_pooled_sweep_matches_vmapped_gibbs_sweep():
    """conjugate x constant_IRF with one temperature a chain against
    jax.vmap(gibbs_sweep) over the chains and their temperatures."""
    s = setup_for("conjugate", 2)
    temps = np.array([1.7, 6.0])
    y = jnp.asarray(s["y"])
    keys = jax.vmap(lambda k: jax.random.fold_in(k, 5))(s["keys"])
    jstate, jll = jax.jit(jax.vmap(lambda st, k, t: jg.gibbs_sweep(
        st, k, y, s["jconsts"], s["jcfg"], t)))(s["jstate"], keys, jnp.asarray(temps))
    draws = _join([_sweep(keys[c], "conjugate", 2, "ess", True) for c in range(K)])
    state, ll = tg.gibbs_sweep(s["state"], draws, s["yt"], s["consts"], s["cfg"],
                               temp=_t(temps))
    np.testing.assert_array_equal(state.theta_idx.numpy(), np.asarray(jstate.theta_idx))
    for name in ("f", "fstar", "beta", "thresholds"):
        _close(getattr(state, name), getattr(jstate, name))
    _close(ll, jll)


@pytest.mark.parametrize("f_method", ["grid", "two_stage"])
def test_grid_and_two_stage_refuse_tempering(f_method):
    s = setup_for(f_method, 2)
    d = tg.sweep_draws(torch.Generator().manual_seed(0), K, s["consts"], s["cfg"])
    with pytest.raises(NotImplementedError, match="conjugate"):
        tg.gibbs_sweep(s["state"], d, s["yt"], s["consts"], s["cfg"], temp=4.0)


def test_anneal_init_pooled_matches(monkeypatch):
    """The conjugate constant_IRF anneal_init against JAX's given the same
    draws (init keys, each step's resample uniform and tempered sweep keys
    replayed): states (theta exactly, the rest to 1e-8), the weight-ESS
    trace and the resample count."""
    Ka, steps, t_max = 3, 3, 8.0
    s = setup_for("conjugate", 2)
    keys = jax.random.split(jax.random.key(31), Ka)
    theta_init = np.random.default_rng(4).uniform(-1, 1, (Ka, H, n))
    want, jinfo = j_anneal_init(keys, jnp.asarray(s["y"]), theta_init, s["thr_init"],
                                s["jconsts"], s["jcfg"], n_steps=steps, max_temp=t_max)
    lane = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    k_init, k_run, k_res = lane[:, 0], lane[:, 1], lane[0, 2]
    init = _join([_init(k, "conjugate") for k in k_init])
    ids = list(range(steps + 1, steps + 1 + smc.WARM_STEPS)) + list(range(1, steps))
    us = [jax.random.uniform(jax.random.fold_in(k_res, i), (), _F64)
          for i in ids + [steps + 1]]
    sweeps = [_join([_sweep(jax.random.fold_in(jax.random.fold_in(k_run[c], i), 0),
                            "conjugate", 2, "ess", True) for c in range(Ka)]) for i in ids]
    real_rand = torch.rand

    def resample_u(*a, **kw):
        if a and a[0] == ():
            return _t(us.pop(0))
        return real_rand(*a, **kw)

    monkeypatch.setattr(smc, "init_draws", lambda *a: init)
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


def test_sweep_draws_pooled_layouts():
    """The draws a constant_IRF sweep takes: the shared IRF's with a session
    axis of 1, theta's and beta's a session; the unpooled grid sweep's f*
    ESS one lane a session."""
    shapes = {}
    for f_method in ("grid", "conjugate", "two_stage"):
        cfg = setup_for(f_method, 3)["cfg"]
        consts = setup_for(f_method, 3)["consts"]
        d = tg.sweep_draws(torch.Generator().manual_seed(0), K, consts, cfg)
        assert d.cut.nu.shape == (K, 1, m, 2) and d.cut.rs.shape == (64, K, 1, m)
        assert d.u_theta.shape == (K, H, n, N)
        shapes[f_method] = d
    g, c, ts = shapes["grid"], shapes["conjugate"], shapes["two_stage"]
    assert isinstance(g, tg.GridDraws) and g.fstar.z_n.shape == (K, 1, N, m)
    assert g.ess.rs.shape == (64, K, 1, m) and g.beta.z.shape == (K, H, m, 3)
    assert c.z_q.shape == (K, 1, Q, m) and c.eps_f.shape == (K, H, n, m)
    assert ts.f.z_site.shape == (K, 1, H * n, m) and ts.f.ess.logu.shape == (K, 1, m)
    assert ts.fstar.z_n.shape == (K, 1, N, m)
    s = setup_for("two_stage", 3)
    init = tg.init_draws(torch.Generator(), K, s["consts"], s["cfg"])
    assert init.z_beta.shape == (K, 1, 3, m) and init.z_site.shape == (K, 1, n, m)
    s = setup_for("grid", 2, pooled=False)
    d = tg.sweep_draws(torch.Generator(), K, s["consts"], s["cfg"])
    assert d.fstar.z_n.shape == (K, H, N, m) and d.ess.logu.shape == (K, H, m)
    assert isinstance(d.to("cpu"), tg.GridDraws)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("f_method", ["auto", "conjugate", "two_stage"])
def test_gpirt_mcmc_constant_irf_stores_shared_irfs(f_method):
    """tests/test_api.py::test_constant_irf's case under each f-method: the
    stored f* (S, N, m, H) and cutpoints one a chain across sessions (f*
    with session 0's mean), the sessions' theta and beta their own."""
    _, cube = simulate_dynamic(1, n=12, m=6, horizon=2)
    out = gpirt_mcmc(cube, 4, 1, vote_codes=VOTES, constant_IRF=1, theta_ls=2.0,
                     theta_init=np.linspace(-1, 1, 12), store_fstar=True, f_method=f_method,
                     dtype="float64", grid_size=101, device="cpu", verbose=False)
    m_kept = recode_cube(cube, VOTES, verbose=False).shape[1]
    for d in out:
        fs, t = d["fstar"], d["threshold"]
        assert fs.shape == (4, 101, m_kept, 2) and np.isfinite(fs).all()
        np.testing.assert_allclose(fs[..., 0], fs[..., 1])  # shared IRFs
        np.testing.assert_allclose(t[..., 0], t[..., 1])  # shared cutpoints
        assert not np.allclose(d["beta"][..., 0], d["beta"][..., 1])
        assert np.isfinite(d["ll"]).all()


def test_gpirt_mcmc_grid_runs_without_constant_irf():
    """f_method="grid" alone: one f* a session."""
    _, cube = simulate_dynamic(2, n=10, m=5, horizon=2)
    out = gpirt_mcmc(cube, 3, 1, CHAIN=2, vote_codes=VOTES, f_method="grid", theta_ls=2.0,
                     store_fstar=True, dtype="float64", grid_size=101, device="cpu",
                     verbose=False)
    fs = out[0]["fstar"]
    assert fs.shape[1:] == (101, out[0]["beta"].shape[2], 2) and np.isfinite(fs).all()
    assert not np.allclose(fs[..., 0], fs[..., 1])


def test_recover_fstar_constant_irf_path():
    """tests/test_api.py::test_constant_irf_path's case: one shared f* with
    session 0's mean, so both sessions agree exactly; repeatable under a
    seed; the batch equal to one draw at a time in shape."""
    _, cube = simulate_dynamic(8, n=10, m=5, horizon=2)
    out = gpirt_mcmc(cube, 3, 0, vote_codes=VOTES, constant_IRF=1, theta_ls=2.0,
                     theta_init=np.linspace(-1, 1, 10), store_f=True, dtype="float64",
                     grid_size=101, device="cpu", verbose=False)
    d = out[0]
    m_kept = d["beta"].shape[2]
    rm = recode_cube(cube, VOTES, verbose=False)
    args = (d["f"][-1], rm, d["theta"][-1], d["beta"][-1], d["threshold"][-1])
    kw = dict(constant_IRF=1, dtype="float64", grid_size=101, device="cpu")
    fs = recover_fstar(7, *args, **kw)["fstar"]
    assert fs.shape == (101, m_kept, 2) and np.isfinite(fs).all()
    np.testing.assert_allclose(fs[..., 0], fs[..., 1])
    np.testing.assert_array_equal(fs, recover_fstar(7, *args, **kw)["fstar"])
    batch = recover_fstar_batch(7, d, rm, **kw)
    assert batch.shape == (3, 101, m_kept, 2)
    np.testing.assert_allclose(batch[..., 0], batch[..., 1])


@pytest.mark.parametrize("C", [2, 3])
def test_recover_one_constant_irf_matches(C, jax_inducing_op_by_op):
    """_recover_one of both packages under constant_IRF (pooled draw_f,
    the inducing-point f*, session 0's linear mean) from the same stored
    draws and draws."""
    kw = dict(n=n, m=m, horizon=H, C=C, grid_size=N, dtype="float64", jitter=1e-6,
              mean_degree=1, constant_IRF=True)
    jcfg, cfg = JConfig(**kw), GPIRTConfig(**kw)
    jconsts = j_make_constants(jcfg, beta_prior_means=np.zeros((3, m)),
                               beta_prior_sds=np.full((3, m), 3.0),
                               theta_prior_means=np.zeros((2, n)),
                               theta_prior_sds=np.zeros((2, n)))
    y = _y(C, seed=5)
    rng = np.random.default_rng(C)
    S = 2
    thr = np.broadcast_to(default_thresholds(C, m, H), (S, H, m, C + 1)).copy()
    thr[..., 1:C] += 0.1 * rng.standard_normal((S, 1, m, 1))
    stored = (rng.standard_normal((S, H, n, m)), rng.uniform(-2.5, 2.5, (S, H, n)),
              rng.standard_normal((S, H, 3, m)), thr)
    keys = jax.random.split(jax.random.key(9), S)
    run = jax.jit(lambda c: jax.vmap(lambda k, *a: j_recover_one(
        k, *a, jnp.asarray(y), c, jcfg))(keys, *map(jnp.asarray, stored)))
    want = np.asarray(run(jconsts))
    splits = [jax.random.split(k) for k in keys]
    got = _recover_one(*map(_t, stored), torch.as_tensor(y),
                       constants_from_numpy(jconsts, device="cpu", dtype=torch.float64),
                       cfg, _join([_draw_f(k[0]) for k in splits]),
                       _join([_grid_prior(k[1], True) for k in splits]))
    assert got.shape == (S, H, N, m) and torch.equal(got[:, 0], got[:, -1])
    _close_lanes(got, want, *_spread(run, jconsts))


def test_constant_irf_guards():
    """As in JAX: SMC and tempering need the conjugate sampler, so the grid
    (constant_IRF's "auto") and two-stage paths refuse them."""
    _, cube = simulate_dynamic(1, n=8, m=4, horizon=2)
    kw = dict(vote_codes=VOTES, constant_IRF=1, theta_ls=2.0, dtype="float64",
              grid_size=101, device="cpu", verbose=False)
    for f_method in ("auto", "grid", "two_stage"):
        with pytest.raises(NotImplementedError, match="conjugate"):
            gpirt_mcmc(cube, 2, 1, f_method=f_method, smc_steps=2, **kw)
        with pytest.raises(NotImplementedError, match="conjugate"):
            gpirt_mcmc(cube, 2, 1, f_method=f_method, n_temps=2, **kw)
    out = gpirt_mcmc(cube, 2, 1, CHAIN=2, f_method="conjugate", n_temps=2, **kw)
    np.testing.assert_allclose(out[0]["threshold"][..., 0], out[0]["threshold"][..., 1])
    out = gpirt_mcmc(cube, 2, 1, CHAIN=2, f_method="conjugate", smc_steps=2, **kw)
    assert np.isfinite(out[0]["ll"]).all()
