"""The port's sampler options against the JAX package: the ESS theta update
(``theta_method="ess"``), ``mix_subsweeps``, the collapsed and interleaved
cutpoint draws, the (cutpoint, intercept) shift, and the configuration and
``gpirt_mcmc`` arguments that select them. The affine moves are in
tests/test_torch_affine.py, which shares this file's setups and replay.

As in tests/test_torch_constant_irf.py (whose sizes, responses and draw
replays this file reuses: H = 3 sessions, n = 12, m = 6, a 101-point grid),
both packages compute in float64 on the CPU from the same constants and
state, the random draws made in JAX from its own keys and handed to the
port's pure blocks. The new blocks consume their keys so:

  * the ESS theta update: ``k_nu, k_ess = split(key)``, the prior normals
    (n, 1) in CST and (n, H) in RDM and GP from k_nu, ess_update's from
    k_ess over n lanes (CST, GP) or n H (RDM, respondent-major);
  * the collapsed draw: at C = 2 one uniform (H, m, 1) from the key, at
    C > 2 the cutpoint ESS's draws;
  * the shift: a normal (H, m) from ``fold_in(k_t, 1)``;
  * the affine moves: ``fold_in(k_f, 3 s + 1)`` of pass s, split into the
    orbit's ``k_pick, k_acc`` and the dilation rounds' ``split(k_dil, R)``;
  * pass s of a sweep: theta from ``fold_in(k_th, s)``, on the conjugate
    path z from ``fold_in(k_f, 3 s)`` and f* from ``fold_in(k_f, 3 s + 2)``,
    on the grid path f* from ``fold_in(k_f, s)``, on the two-stage path f*
    from ``fold_in(k_fs, s)``.

The draws of each chain (a chain axis of 1) are joined as the SMC joins
campaigns' (``parallel.smc._cat_lanes``). Tolerances: theta indices
exactly, rtol 1e-10 a block and 1e-8 after three sweeps (the two-stage
fields plus four times JAX's own one-ulp spread, as in
tests/test_torch_two_stage.py).
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
from gpirt_tpu.ops.ess import ess_update as j_ess_update
from gpirt_tpu_torch import api, gpirt_mcmc
from gpirt_tpu_torch.api import default_thresholds
from gpirt_tpu_torch.convert import constants_from_numpy, state_from_numpy
from gpirt_tpu_torch.models import gibbs as tg
from gpirt_tpu_torch.models.config import GPIRTConfig
from gpirt_tpu_torch.ops.ess import ess_update
from gpirt_tpu_torch.ops.likelihood import delta_to_threshold, threshold_to_delta
from gpirt_tpu_torch.parallel import smc
from test_torch_constant_irf import (
    _F64,
    H,
    K,
    N,
    Q,
    _beta,
    _close,
    _close_lanes,
    _conj_fstar,
    _cut,
    _direct,
    _grid_prior,
    _lane,
    _loop,
    _spread,
    _t,
    _theta_uniforms,
    _y,
    m,
    n,
)
from test_torch_ordinal import _ess_loop_draws

LS = {"CST": 10.0, "RDM": 0.05, "GP": 2.0}  # theta_ls of each regime at H = 3


def _setup(regime, C, opts):
    kw = dict(n=n, m=m, horizon=H, C=C, grid_size=N, dtype="float64",
              theta_ls=LS[regime], **dict(opts))
    kw.setdefault("f_method", "conjugate")
    jcfg, cfg = JConfig(threshold_ess_twophase=False, **kw), GPIRTConfig(**kw)
    assert cfg.theta_regime == jcfg.theta_regime == regime
    jconsts = j_make_constants(jcfg, beta_prior_means=np.zeros((3, m)),
                               beta_prior_sds=np.full((3, m), 1.5),
                               theta_prior_means=np.zeros((2, n)),
                               theta_prior_sds=np.full((2, n), 0.5))
    y = _y(C)
    rng = np.random.default_rng(1)
    theta_init = rng.uniform(-2, 2, (K, H, n))
    thr_init = default_thresholds(C, m, H)
    keys = jax.random.split(jax.random.key(7), K)
    jstate = jax.jit(jax.vmap(lambda k, t: jg.init_state(
        k, t, jnp.asarray(thr_init), jnp.asarray(y), jconsts, jcfg)))(
        keys, jnp.asarray(theta_init))
    d = _t(rng.standard_normal((K, H, m, C - 1)) * 0.3)  # cutpoints off qnorm(i/C)
    thr = delta_to_threshold(threshold_to_delta(_t(jstate.thresholds)) + d)
    jstate = jstate._replace(thresholds=jnp.asarray(thr.numpy()))
    return dict(jcfg=jcfg, cfg=cfg, jconsts=jconsts, y=y, yt=torch.as_tensor(y),
                consts=constants_from_numpy(jconsts, device="cpu", dtype=torch.float64),
                keys=keys, jstate=jstate, theta_init=theta_init, thr_init=thr_init,
                state=state_from_numpy(jstate, device="cpu", dtype=torch.float64))


_SETUPS = {}


def setup_for(regime="GP", C=2, **opts):
    key = (regime, C, tuple(sorted(opts.items())))
    if key not in _SETUPS:
        _SETUPS[key] = _setup(regime, C, key[2])
    return _SETUPS[key]


# ---------------------------------------------------------------------------
# JAX's draws from its keys, one chain's, in the port's layouts
# ---------------------------------------------------------------------------


def _theta(key, cfg):
    """The theta update's draws: the grid draw's uniforms or the ESS's."""
    regime = cfg.theta_regime
    if cfg.theta_method == "grid":
        if regime == "GP":
            return _theta_uniforms(key)
        shape = (n, N) if regime == "CST" else (H, n, N)
        return _lane(jg._uniform2d(key, shape, _F64), shape)
    k_nu, k_ess = jax.random.split(key)
    zshape = (n, 1) if regime == "CST" else (n, H)
    lanes = (n, H) if regime == "RDM" else (n,)
    logu, eps0, rs = _ess_loop_draws(k_ess, (int(np.prod(lanes)),))
    return tg.ThetaESSDraws(_lane(jax.random.normal(k_nu, zshape, _F64), zshape),
                            _lane(logu, lanes), _lane(eps0, lanes),
                            _lane(rs, (-1,) + lanes, 1))


def _affine(key, cfg):
    """The affine moves' draws, None when the config has none."""
    if not cfg.affine:
        return None
    W, R = cfg.affine_shift_max, cfg.affine_rounds
    k_shift, k_dil = jax.random.split(key)
    u_pick = u_acc = ell = u_dil = None
    if W:
        k_pick, k_acc = jax.random.split(k_shift)
        u_pick = _lane(jax.random.uniform(k_pick, (1, 2 * W + 1), _F64), (2 * W + 1,))
        u_acc = _lane(jax.random.uniform(k_acc, (), _F64), ())
    if R:
        pairs = [jax.random.split(k) for k in jax.random.split(k_dil, R)]
        ell = _lane([jax.random.normal(kd, (), _F64) for kd, _ in pairs], (R,), 1)
        u_dil = _lane([jax.random.uniform(ku, (), _F64) for _, ku in pairs], (R,), 1)
    return tg.AffineDraws(u_pick, u_acc, ell, u_dil)


def _cut_at(key, cfg, iteration):
    """The cutpoint draws of the update sweep ``iteration`` runs."""
    method = tg._cut_method(cfg, iteration)
    if method == "collapsed" and cfg.C == 2:
        return tg.CollapsedDraws(_lane(jax.random.uniform(key, (H, m, 1), _F64), (H, m)))
    return _cut(key, cfg.C, "newton" if method == "newton" else "ess", False)


def _draw_f(key):
    """The two-stage draw_f's draws, one lane a session."""
    k_nu, k_ess = jax.random.split(key)
    k_u, k_n = jax.random.split(k_nu)
    return tg.FDraws(_lane(jg._normal2d(k_u, (H, Q + 3, m), _F64), (H, Q + 3, m)),
                     _lane(jg._normal2d(k_n, (H, n, m), _F64), (H, n, m)),
                     _loop(k_ess, (H, m), H))


def _sweep(key, cfg, iteration=0):
    """One gibbs_sweep's draws for one chain, replayed from its key as the
    JAX branch of the config's f-method consumes them."""
    k_f, k_fs, k_th, k_b, k_t = jax.random.split(key, 5)
    tail = dict(cut=_cut_at(k_t, cfg, iteration))
    if cfg.threshold_shift:
        tail["shift"] = _lane(jax.random.normal(jax.random.fold_in(k_t, 1), (H, m), _F64),
                              (H, m))

    def passes(one):
        per = [one(s) for s in range(cfg.mix_subsweeps)]
        return {k: tg._stack_passes([p[k] for p in per]) for k in per[0]}

    def theta(s):
        return _theta(jax.random.fold_in(k_th, s), cfg)

    method = cfg.resolved_f_method
    if method == "grid":
        def grid_pass(s):
            fstar, ess = _direct(jax.random.fold_in(k_f, s), False)
            return dict(fstar=fstar, ess=ess, u_theta=theta(s))

        return tg.GridDraws(**passes(grid_pass), beta=_beta(k_b), **tail)
    if method == "two_stage":
        return tg.TwoStageDraws(_draw_f(k_f), **passes(lambda s: dict(
            fstar=_grid_prior(jax.random.fold_in(k_fs, s), False), u_theta=theta(s))),
            beta=_beta(k_b), **tail)

    def conj_pass(s):
        z_q, z_p, z_n, eps = _conj_fstar(jax.random.fold_in(k_f, 3 * s + 2), False)
        u_z = jg._uniform2d(jax.random.fold_in(k_f, 3 * s), (H, n, m), _F64)
        return dict(u_theta=theta(s), u_z=_lane(u_z, (H, n, m)), z_q=z_q, z_p=z_p, z_n=z_n,
                    eps_f=eps, affine=_affine(jax.random.fold_in(k_f, 3 * s + 1), cfg))

    zeta = _lane(jax.random.normal(k_b, (H, m, 3), _F64), (H, m, 3))
    return tg.SweepDraws(**passes(conj_pass), zeta=zeta, **tail)


def sweep_draws_for(s, keys, iteration=0):
    """The K chains' replayed draws of one sweep, joined."""
    return smc._cat_lanes([_sweep(k, s["cfg"], iteration) for k in keys],
                          s["cfg"].mix_subsweeps)


def three_sweeps(s, temps=None, spread=False):
    """Three sweeps of both packages from the setup's state (iterations 0,
    1, 2; ``temps`` None or one temperature a chain, JAX's vmapped with
    them): theta exactly, the rest to 1e-8 (plus four times JAX's own
    spread with ``spread``), ll to 1e-10. Returns the port's last state."""
    jcfg, y = s["jcfg"], jnp.asarray(s["y"])
    t = None if temps is None else jnp.asarray(temps)
    run = jax.jit(lambda st, k, it, c: jax.vmap(
        lambda a, b, tt: jg.gibbs_sweep(a, b, y, c, jcfg, tt, iteration=it),
        in_axes=(0, 0, None if t is None else 0))(st, k, t))
    keys = [jax.vmap(lambda k: jax.random.fold_in(k, it))(s["keys"]) for it in range(3)]

    def jax_sweeps(jconsts):
        jstate, out = s["jstate"], []
        for it, k in enumerate(keys):
            jstate, jll = run(jstate, k, jnp.int32(it), jconsts)
            out.append((jstate, jll))
        return out

    def fields(st, ll):
        return [st.f, st.beta, st.thresholds, st.fstar, ll]

    want = jax_sweeps(s["jconsts"])
    gaps = (_spread(lambda c: [a for out in jax_sweeps(c) for a in fields(*out)],
                    s["jconsts"]) if spread else [np.zeros(())] * 15)
    state = s["state"]
    for it, (jstate, jll) in enumerate(want):
        state, ll = tg.gibbs_sweep(state, sweep_draws_for(s, keys[it], it), s["yt"],
                                   s["consts"], s["cfg"],
                                   None if temps is None else _t(temps), it)
        np.testing.assert_array_equal(state.theta_idx.numpy(), np.asarray(jstate.theta_idx))
        for j, (got, exp) in enumerate(zip(fields(state, ll), fields(jstate, jll))):
            _close_lanes(got, exp, gaps[5 * it + j], 1e-10 if j == 4 else 1e-8)
    t_int = state.thresholds[..., 1:-1]
    assert bool(torch.isfinite(t_int).all()) and bool((t_int[..., 1:] > t_int[..., :-1]).all())
    return state


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


_OPTIONS = ("theta_method", "mix_subsweeps", "threshold_method", "threshold_ess_every",
            "threshold_shift", "affine_rounds", "affine_shift_max", "affine_dilate_sd")


def test_config_defaults_are_jaxs():
    cfg, jcfg = GPIRTConfig(n=5, m=4), JConfig(n=5, m=4)
    for name in _OPTIONS:
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert not cfg.affine


@pytest.mark.parametrize("kw", [
    dict(mix_subsweeps=0), dict(affine_rounds=-1), dict(affine_shift_max=-2),
    dict(affine_rounds=2, affine_dilate_sd=0.0), dict(theta_method="gibbs"),
    dict(threshold_method="box"), dict(threshold_ess_every=0),
    dict(threshold_method="collapsed", f_method="grid"),
    dict(threshold_method="interleave", f_method="two_stage"),
    dict(threshold_method="collapsed", constant_IRF=True),
])
def test_config_raises_where_jax_raises(kw):
    """JAX's ValueErrors, with its messages' subject."""
    with pytest.raises(ValueError) as want:
        JConfig(n=5, m=4, **kw)
    with pytest.raises(ValueError) as got:
        GPIRTConfig(n=5, m=4, **kw)
    assert str(got.value).split()[0] == str(want.value).split()[0]


@pytest.mark.parametrize("kw", [
    dict(threshold_method="collapsed", f_method="conjugate"),
    dict(threshold_method="interleave", C=3), dict(threshold_method="ess", f_method="grid"),
    dict(threshold_method="newton", f_method="two_stage"),
    dict(threshold_method="collapsed", constant_IRF=True, f_method="conjugate"),
    dict(threshold_method="auto", f_method="two_stage"),
])
def test_resolved_threshold_method_matches(kw):
    cfg = GPIRTConfig(n=5, m=4, **kw)
    assert cfg.resolved_threshold_method == JConfig(n=5, m=4, **kw).resolved_threshold_method


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def test_ess_update_transform_matches():
    """ess_update with a clamp on every proposal (the theta update's), lanes
    started at and near the bounds, against JAX's."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(-5, 5, (20, 1)), [[5.0], [-5.0], [4.99]]])
    nu = rng.standard_normal(x.shape) * 3.0
    key = jax.random.key(11)

    def loglik_np(v):
        return -0.5 * np.square(v[..., 0] - 4.0) / 0.3

    def clamp_j(v):
        return jnp.clip(v, -5.0, 5.0)

    want = j_ess_update(key, jnp.asarray(x), jnp.asarray(nu),
                        lambda v: -0.5 * jnp.square(v[..., 0] - 4.0) / 0.3, transform=clamp_j)
    logu, eps0, rs = _ess_loop_draws(key, (x.shape[0],))
    got = ess_update(_t(x), _t(nu), lambda v: _t(loglik_np(v.numpy())), _t(logu), _t(eps0),
                     _t(rs), transform=lambda v: torch.clamp(v, -5.0, 5.0))
    _close(got, want)
    assert float(got.abs().max()) <= 5.0


@pytest.mark.parametrize("regime", ["CST", "RDM", "GP"])
def test_theta_ess_block_matches(regime):
    """The ESS theta update, theta indices exactly; a tempered call refuses."""
    s = setup_for(regime, 2, theta_method="ess")
    keys = jax.random.split(jax.random.key(21), K)
    jstate, jconsts, y = s["jstate"], s["jconsts"], jnp.asarray(s["y"])
    want = jax.vmap(lambda k, st: jg.draw_theta(
        k, st, jg.compute_mu_star(jconsts, st.beta), y, jconsts, s["jcfg"]))(keys, jstate)
    draws = smc._cat_lanes([_theta(k, s["cfg"]) for k in keys])
    st = s["state"]
    mu_star = tg.compute_mu_star(s["consts"], st.beta)
    got = tg.draw_theta(st, mu_star, s["yt"], s["consts"], s["cfg"], draws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not torch.equal(got, st.theta_idx)
    with pytest.raises(NotImplementedError, match="tempering needs theta_method='grid'"):
        tg.draw_theta(st, mu_star, s["yt"], s["consts"], s["cfg"], draws, temp=2.0)


def _latents(s, seed):
    """z drawn by the port inside each cell's current interval (so the
    collapsed box holds the cutpoints)."""
    st = s["state"]
    mu = tg.compute_mu(tg.theta_from_indices(st.theta_idx, s["consts"]), st.beta)
    u = _t(np.random.default_rng(seed).random((K, H, n, m)))
    return tg.draw_z_truncnorm(st.f + mu, s["yt"], st.thresholds, u)


@pytest.mark.parametrize("C, pooled", [(2, False), (3, False), (2, True), (4, True)])
def test_collapsed_block_matches(C, pooled):
    """draw_threshold_collapsed: the exact draw at C = 2 and the box ESS at
    C > 2, per session or pooled over the sessions (constant_IRF)."""
    s = setup_for("GP", C, threshold_method="collapsed", constant_IRF=pooled)
    z = _latents(s, C)
    keys = jax.random.split(jax.random.key(23), K)
    thr = s["jstate"].thresholds
    want = jax.vmap(lambda k, t, zz: jg.draw_threshold_collapsed(
        k, t, zz, jnp.asarray(s["y"]), s["jcfg"]))(keys, thr, jnp.asarray(z.numpy()))
    lead, hi = ((), 1) if pooled else ((H,), H)
    if C == 2:
        cut = [tg.CollapsedDraws(_lane(jax.random.uniform(k, lead + (m, 1), _F64), (hi, m)))
               for k in keys]
    else:
        cut = [_cut(k, C, "ess", pooled) for k in keys]
    got = tg.draw_threshold_collapsed(s["state"].thresholds, z, s["yt"], s["cfg"],
                                      smc._cat_lanes(cut))
    _close(got, want)
    if pooled:
        assert torch.equal(got[:, 0], got[:, -1])
    assert bool((got != s["state"].thresholds)[..., 1:-1].any())


def test_shift_block_matches():
    s = setup_for("GP", 3, threshold_shift=True)
    keys = jax.random.split(jax.random.key(24), K)
    jstate = s["jstate"]
    want = jax.vmap(lambda k, t, b: jg.draw_threshold_shift(k, t, b, s["jconsts"], s["jcfg"]))(
        keys, jstate.thresholds, jstate.beta)
    z = torch.cat([_lane(jax.random.normal(k, (H, m), _F64), (H, m)) for k in keys])
    got = tg.draw_threshold_shift(s["state"].thresholds, s["state"].beta, s["consts"], z)
    for a, b in zip(got, want):
        _close(a, b)


def test_sweep_draws_default_stream_and_option_fields():
    """With the options at their defaults no new field is drawn; the
    options' draws come after the default ones of their pass or sweep, so
    every default field keeps its numbers; passes stack on a leading axis."""
    base = setup_for("GP", 2)
    cfg = base["cfg"]
    consts = base["consts"]

    def draws(c, it=0):
        return tg.sweep_draws(torch.Generator().manual_seed(5), K, consts, c, it)

    d0 = draws(cfg)
    assert d0.affine is None and d0.shift is None and isinstance(d0.cut, tg.ESSDraws)
    aff = draws(GPIRTConfig(**{**_kw(cfg), "affine_shift_max": 3, "affine_rounds": 2}))
    for name in ("u_theta", "u_z", "z_q", "z_p", "z_n", "eps_f"):
        assert torch.equal(getattr(aff, name), getattr(d0, name)), name
    assert aff.affine.u_pick.shape == (K, 7) and aff.affine.ell.shape == (2, K)
    sh = draws(GPIRTConfig(**{**_kw(cfg), "threshold_shift": True}))
    assert all(torch.equal(a, b) for a, b in zip(sh.cut, d0.cut))
    assert sh.shift.shape == (K, H, m)
    two = draws(GPIRTConfig(**{**_kw(cfg), "mix_subsweeps": 2}))
    assert two.u_z.shape == (2, K, H, n, m) and torch.equal(two.u_z[0], d0.u_z)
    assert two.zeta.shape == d0.zeta.shape
    inter = GPIRTConfig(**{**_kw(cfg), "threshold_method": "interleave",
                           "threshold_ess_every": 3})
    assert isinstance(draws(inter, 3).cut, tg.ESSDraws)
    assert isinstance(draws(inter, 4).cut, tg.CollapsedDraws)
    ess = draws(GPIRTConfig(**{**_kw(cfg), "theta_method": "ess"}))
    assert ess.u_theta.z.shape == (K, n, H) and ess.u_theta.rs.shape == (64, K, n)


def _kw(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


def test_cat_lanes_finds_every_lane_axis():
    """Two campaigns' draws with every new field, two passes: each field
    joined along its lane axis."""
    s = setup_for("RDM", 3, theta_method="ess", mix_subsweeps=2, affine_shift_max=2,
                  affine_rounds=3, threshold_shift=True)
    gens = [torch.Generator().manual_seed(i) for i in (1, 2)]
    per = [tg.sweep_draws(g, K, s["consts"], s["cfg"]) for g in gens]
    both = smc._cat_lanes(per, 2)
    assert both.u_theta.rs.shape == (2, 64, 2 * K, n, H)
    assert both.affine.ell.shape == (2, 3, 2 * K) and both.affine.u_pick.shape == (2, 2 * K, 5)
    assert both.u_z.shape == (2, 2 * K, H, n, m) and both.shift.shape == (2 * K, H, m)
    assert torch.equal(both.affine.ell[:, :, K:], per[1].affine.ell)
    assert torch.equal(both.cut.rs[:, :K], per[0].cut.rs)


# ---------------------------------------------------------------------------
# whole sweeps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("regime", ["CST", "RDM", "GP"])
def test_three_sweeps_theta_ess(regime):
    three_sweeps(setup_for(regime, 2, theta_method="ess"))


@pytest.mark.parametrize("method, C", [("collapsed", 2), ("collapsed", 3),
                                       ("interleave", 2), ("interleave", 3)])
def test_three_sweeps_collapsed_and_interleave(method, C):
    """Interleave with k = 2: sweeps 0 and 2 run the y-marginal ESS, sweep
    1 the collapsed draw."""
    three_sweeps(setup_for("GP", C, threshold_method=method, threshold_ess_every=2))


@pytest.mark.parametrize("f_method, C", [("conjugate", 3), ("grid", 2)])
def test_three_sweeps_threshold_shift(f_method, C):
    three_sweeps(setup_for("CST", C, threshold_shift=True, f_method=f_method))


@pytest.mark.parametrize("f_method", ["conjugate", "grid", "two_stage"])
def test_three_sweeps_mix_subsweeps(f_method):
    three_sweeps(setup_for("RDM", 2, mix_subsweeps=2, f_method=f_method),
                 spread=f_method == "two_stage")


def test_theta_ess_on_grid_and_two_stage_paths():
    """The ESS theta update in the other f-methods' sweeps (RDM)."""
    for f_method in ("grid", "two_stage"):
        three_sweeps(setup_for("RDM", 2, theta_method="ess", f_method=f_method),
                     spread=f_method == "two_stage")


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


def _votes(n_=10, m_=6, seed=0):
    rng = np.random.default_rng(seed)
    p = 1 / (1 + np.exp(-np.outer(np.linspace(-2, 2, n_), rng.standard_normal(m_) * 2)))
    v = np.where(rng.random((n_, m_)) < p, 1.0, 6.0)
    v[rng.random((n_, m_)) < 0.1] = 9.0
    return v


@pytest.mark.parametrize("kw", [
    dict(theta_method="ess"), dict(threshold_method="collapsed"),
    dict(threshold_method="interleave", threshold_ess_every=2, mix_subsweeps=2),
    dict(mix_subsweeps=2, f_method="grid"), dict(jitter=1e-4),
    dict(threshold_method="interleave", smc_steps=3),
])
def test_gpirt_mcmc_takes_the_new_arguments(kw):
    out = gpirt_mcmc(_votes(), 4, 2, CHAIN=2, dtype="float64", grid_size=101,
                     device="cpu", verbose=False, **kw)
    assert len(out) == 2 and out[0]["theta"].shape == (4, 10, 1)
    assert all(np.isfinite(d["ll"]).all() for d in out)
    cfg = next(reversed(api._CONSTS_CACHE))[0]
    for name, value in kw.items():
        if name != "smc_steps":
            assert getattr(cfg, name) == value, name


@pytest.mark.parametrize("kw, error", [
    (dict(theta_method="ess", smc_steps=2), NotImplementedError),
    (dict(theta_method="ess", n_temps=2), NotImplementedError),
    (dict(threshold_method="collapsed", f_method="grid"), ValueError),
    (dict(threshold_method="interleave", f_method="two_stage"), ValueError),
    (dict(mix_subsweeps=0), ValueError),
])
def test_gpirt_mcmc_guards_as_jax(kw, error):
    """JAX's refusals: the ESS theta update has no tempered form (SMC and
    parallel tempering temper), and the collapsed and interleaved cutpoints
    need the conjugate sampler."""
    with pytest.raises(error):
        gpirt_mcmc(_votes(), 2, 1, CHAIN=2, dtype="float64", grid_size=101, device="cpu",
                   verbose=False, **kw)


def test_gpirt_campaigns_takes_collapsed_cutpoints():
    from gpirt_tpu_torch import gpirt_campaigns

    out = gpirt_campaigns(_votes(), n_campaigns=2, n_chains=2, sample_iterations=4,
                          burn_iterations=1, smc_steps=2, threshold_method="interleave",
                          verbose=False, device="cpu")
    assert out["schedule"]["threshold_method"] == "interleave"
    assert np.isfinite(out["theta_mean"]).all()
