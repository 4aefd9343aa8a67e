"""The port's two-stage sampler (``f_method="two_stage"``) against the JAX
package.

As in tests/test_torch_ordinal.py, both packages compute in float64 on the
CPU from the same constants and state, the random draws made in JAX from
the reference's own key splits and handed to the port's pure blocks:

  * theta_prior_perturbation: ``k_u, k_n = split(key)``, normals of
    (H, q+3, m) and (H, n, m);
  * draw_f: ``k_nu, k_ess = split(key)``, the perturbation from k_nu and
    ess_update's ``k_u, k_eps, k_loop = split(k_ess, 3)``, one
    ``key, k_r = split(key)`` a round;
  * f* by Matheron: ``k_q, k_p, k_n = split(key, 3)``; by "chol": one
    (H, N, m) normal from the key;
  * draw_beta: ``k_nu, k_ess = split(key)``, a (H, m, 3) normal from k_nu;
  * init_state: ``k_beta, k_f, k_fstar = split(key, 3)``;
  * gibbs_sweep: ``k_f, k_fs, k_th, k_b, k_t = split(key, 5)``, f* and theta
    from ``fold_in(k_fs, 0)`` and ``fold_in(k_th, 0)``.

y has masked cells, and item 0 has no response in the last session (its
beta is kept there). Tolerances: rtol 1e-10 a block, 1e-8 after three
sweeps, theta indices exactly. f*, and after a whole sweep every field
(f is f* at the new theta, and beta, the cutpoints and ll read f), is held
to that rtol plus four times the JAX package's own rounding spread
(:func:`_jax_spread`): both f* | f methods solve against near-singular
matrices (U^T U + 1e-6 I over 12 sites for Matheron's rule, K** - V^T V +
1e-6 I for "chol"), so float64 summation order alone moves f* by up to
~1e-6, in JAX as in the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import default_blas_threads  # noqa: F401  (a fixture)
from gpirt_tpu.models import gibbs as jg
from gpirt_tpu.models.config import GPIRTConfig as JConfig
from gpirt_tpu.models.config import make_constants as j_make_constants
from gpirt_tpu.ops.linalg import chol_with_jitter as j_chol_with_jitter
from gpirt_tpu_torch import gpirt_mcmc
from gpirt_tpu_torch.api import default_thresholds
from gpirt_tpu_torch.convert import constants_from_numpy, state_from_numpy
from gpirt_tpu_torch.models import gibbs as tg
from gpirt_tpu_torch.models.config import GPIRTConfig
from gpirt_tpu_torch.ops import ess
from gpirt_tpu_torch.ops.linalg import chol_with_jitter, double_solve
from gpirt_tpu_torch.ops.threshold_ess import binary_threshold_ess
from test_torch_gibbs import _close, _per_chain, _t
from test_torch_ordinal import _ess_draws, _ess_loop_draws, _newton_draws, _stack_lanes

K, n, m, N = 2, 12, 9, 101
_F64 = jnp.float64


def _y(C, H, seed=0):
    """Responses 1..C over H sessions with ~15% masked cells; item 0 has no
    response in the last session."""
    rng = np.random.default_rng(seed)
    theta = np.linspace(-1.5, 1.5, n)
    latent = (np.outer(theta, rng.standard_normal(m) * 1.5)[None]
              + rng.standard_normal((H, n, m)))
    cuts = np.quantile(latent, np.arange(1, C) / C)
    y = (np.digitize(latent, cuts) + 1).astype(np.int32)
    y[rng.random((H, n, m)) < 0.15] = 0
    y[-1, :, 0] = 0
    return y


def _setup(C, H, fstar_method="matheron", method="ess"):
    jcfg = JConfig(n=n, m=m, horizon=H, C=C, grid_size=N, dtype="float64",
                   f_method="two_stage", fstar_method=fstar_method,
                   threshold_method=method, threshold_ess_twophase=False)
    cfg = GPIRTConfig(n=n, m=m, horizon=H, C=C, grid_size=N, dtype="float64",
                      f_method="two_stage", fstar_method=fstar_method,
                      threshold_method=method)
    jconsts = j_make_constants(
        jcfg, beta_prior_means=np.zeros((3, m)),
        beta_prior_sds=np.full((3, m), 1.5),
        theta_prior_means=np.zeros((2, n)),
        theta_prior_sds=np.full((2, n), 0.5))
    y = _y(C, H)
    rng = np.random.default_rng(1)
    theta_init = rng.uniform(-2, 2, (K, H, n))
    thr_init = default_thresholds(C, m, H)
    keys = jax.random.split(jax.random.key(7), K)
    jstate = jax.jit(jax.vmap(lambda k, t: jg.init_state(
        k, t, jnp.asarray(thr_init), jnp.asarray(y), jconsts, jcfg)))(
        keys, jnp.asarray(theta_init))
    return dict(jcfg=jcfg, cfg=cfg, jconsts=jconsts, y=y, yt=torch.as_tensor(y),
                consts=constants_from_numpy(jconsts, device="cpu", dtype=torch.float64),
                keys=keys, jstate=jstate,
                state=state_from_numpy(jstate, device="cpu", dtype=torch.float64),
                theta_init=theta_init, thr_init=thr_init, H=H)


_SETUPS = {}


def setup_for(C, H, fstar_method="matheron", method="ess"):
    key = (C, H, fstar_method, method)
    if key not in _SETUPS:
        _SETUPS[key] = _setup(*key)
    return _SETUPS[key]


def _k():
    return 32 + 3  # the eigenbasis rank q = 32 plus the 3 polynomial columns


def _perturbation_draws(key, H):
    k_u, k_n = jax.random.split(key)
    return (np.asarray(jg._normal2d(k_u, (H, _k(), m), _F64)),
            np.asarray(jg._normal2d(k_n, (H, n, m), _F64)))


def _f_draws(key, H):
    """draw_f's draws from its key: z_u, z_site, logu, eps0, rs."""
    k_nu, k_ess = jax.random.split(key)
    return _perturbation_draws(k_nu, H) + tuple(_ess_loop_draws(k_ess, (H, m)))


def _fstar_draws(key, H, fstar_method):
    """draw_fstar's normals from its key: (z_q, z_p, z_n)."""
    if fstar_method == "chol":
        z = np.asarray(jg._normal2d(key, (H, N, m), _F64))
        return np.zeros((H, 32, m)), np.zeros((H, 3, m)), z
    k_q, k_p, k_n = jax.random.split(key, 3)
    return tuple(np.asarray(jg._normal2d(k, shape, _F64)) for k, shape in
                 ((k_q, (H, 32, m)), (k_p, (H, 3, m)), (k_n, (H, N, m))))


def _beta_draws(key, H):
    k_nu, k_ess = jax.random.split(key)
    return (np.asarray(jax.random.normal(k_nu, (H, m, 3), _F64)),
            *_ess_loop_draws(k_ess, (H, m)))


def _port_f(per_chain):
    z_u, z_site, logu, eps0, rs = zip(*per_chain)
    return tg.FDraws(_stack_lanes(z_u, 0), _stack_lanes(z_site, 0), tg.ESSLoopDraws(
        _stack_lanes(logu, 0), _stack_lanes(eps0, 0), _stack_lanes(rs, 1)))


def _port_fstar(per_chain):
    return tg.FStarDraws(*(_stack_lanes(a, 0) for a in zip(*per_chain)))


def _port_beta(per_chain):
    z, logu, eps0, rs = zip(*per_chain)
    return tg.BetaDraws(_stack_lanes(z, 0), tg.ESSLoopDraws(
        _stack_lanes(logu, 0), _stack_lanes(eps0, 0), _stack_lanes(rs, 1)))


def _mu(s, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((K, s["H"], n, m)) * 0.5


def _jax_spread(fn, jconsts, *args, reps=3):
    """The JAX package's own rounding spread of ``fn(jconsts, *args)`` (an
    array or a list of arrays): the largest change of each output when the
    eigenbasis U_se, the grid Gram and ``args`` move by about one float64
    rounding (relative N(0, 2.2e-16) noise)."""
    rng = np.random.default_rng(0)

    def ulp(a):
        return jnp.asarray(np.asarray(a) * (1.0 + 2.2e-16 * rng.standard_normal(np.shape(a))))

    def listed(out):
        return [np.asarray(o) for o in (out if isinstance(out, list) else [out])]

    def change(o, b):  # equal entries (the cutpoints' infinite ends) count 0
        d = np.zeros(b.shape)
        np.subtract(o, b, out=d, where=o != b)
        return float(np.abs(d).max())

    base = listed(fn(jconsts, *args))
    spread = [0.0] * len(base)
    for _ in range(reps):
        moved = dataclasses.replace(jconsts, U_se=ulp(jconsts.U_se),
                                    grid_gram=ulp(jconsts.grid_gram))
        out = listed(fn(moved, *(ulp(a) for a in args)))
        spread = [max(sp, change(o, b)) for sp, o, b in zip(spread, out, base)]
    return spread


def _close_spread(got, want, spread, rtol=1e-10):
    """``rtol`` plus four times the JAX package's own spread."""
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=rtol + 4.0 * spread)


# ---------------------------------------------------------------------------
# linear algebra and the config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("normalized", [False, True])
def test_chol_with_jitter_matches(normalized):
    """A gathered theta Gram (duplicated sites included) to 1e-12; and
    double_solve inverts L L^T."""
    s = setup_for(2, 1)
    idx = np.asarray(s["jstate"].theta_idx)
    gram = np.asarray(jg.gather_theta_gram(jnp.asarray(idx[0]), s["jconsts"]))
    want = j_chol_with_jitter(jnp.asarray(gram), 1e-4, normalized=normalized)
    got = chol_with_jitter(_t(gram), 1e-4, normalized=normalized)
    _close(got, want, 1e-12)
    _close(tg.gather_theta_gram(s["state"].theta_idx[0], s["consts"]), gram, 1e-15)
    b = np.random.default_rng(2).standard_normal((n, 3))
    L = np.asarray(want)[0]
    _close(double_solve(got[0], _t(b)), np.linalg.solve(L @ L.T, b), 1e-8)


def test_cholesky_failure_is_nan_not_an_error():
    a = torch.tensor([[[1.0, 2.0], [2.0, 1.0]], [[2.0, 0.0], [0.0, 2.0]]])
    got = chol_with_jitter(a, 0.0)
    assert bool(torch.isnan(got[0]).all()) and bool(torch.isfinite(got[1]).all())


@pytest.mark.parametrize("dtype, n_", [("float64", 12), ("float32", 12),
                                       ("float32", 5000)])
def test_config_two_stage_properties_match(dtype, n_):
    kw = dict(n=n_, m=4, dtype=dtype, f_method="two_stage", jitter=1e-5)
    cfg = GPIRTConfig(**kw)
    jcfg = JConfig(**kw)
    assert cfg.resolved_f_method == jcfg.resolved_f_method == "two_stage"
    assert cfg.resolved_threshold_method == jcfg.resolved_threshold_method == "ess"
    assert cfg.chol_normalized == jcfg.chol_normalized
    assert cfg.device_jitter == jcfg.device_jitter
    assert GPIRTConfig(n=5, m=4).resolved_f_method == "conjugate"
    with pytest.raises(ValueError, match="fstar_method"):
        GPIRTConfig(n=5, m=4, fstar_method="dense")


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

_HC = [(1, 2), (1, 3), (3, 2), (3, 3)]


@pytest.mark.parametrize("H, C", _HC)
def test_theta_prior_perturbation_matches(H, C):
    s = setup_for(C, H)
    keys = jax.random.split(jax.random.key(40), K)
    want = _per_chain(lambda k, idx: jg.theta_prior_perturbation(
        k, idx, s["jconsts"], s["jcfg"], m, _F64), keys, s["jstate"].theta_idx)
    z_u, z_site = zip(*[_perturbation_draws(k, H) for k in keys])
    got = tg.theta_prior_perturbation(s["state"].theta_idx, s["consts"], s["cfg"],
                                      _stack_lanes(z_u, 0), _stack_lanes(z_site, 0))
    _close(got, want)


@pytest.mark.parametrize("H, C", _HC)
def test_draw_f_matches(H, C):
    s = setup_for(C, H)
    jstate = s["jstate"]
    mu = _mu(s, 41)
    keys = jax.random.split(jax.random.key(41), K)
    y = jnp.asarray(s["y"])
    want = _per_chain(lambda k, i, mm: jg.draw_f(
        k, jax.tree_util.tree_map(lambda a: a[i], jstate), mm, y, s["jconsts"],
        s["jcfg"]), keys, np.arange(K), jnp.asarray(mu))
    st = s["state"]
    calls = ess.ess_update.calls
    got = tg.draw_f(st.f, st.theta_idx, st.thresholds, _t(mu), s["yt"], s["consts"],
                    s["cfg"], _port_f([_f_draws(k, H) for k in keys]))
    assert ess.ess_update.calls == calls + 1
    _close(got, want)
    assert float((got != st.f).double().mean()) > 0.8


@pytest.mark.parametrize("fstar_method", ["matheron", "chol"])
@pytest.mark.parametrize("H, C", _HC)
def test_draw_fstar_matches(H, C, fstar_method):
    s = setup_for(C, H, fstar_method)
    jstate = s["jstate"]
    keys = jax.random.split(jax.random.key(42), K)
    def jax_fstar(jconsts, f):
        return _per_chain(lambda k, ff, idx: jg.draw_fstar(k, ff, idx, jconsts, s["jcfg"]),
                          keys, f, jstate.theta_idx)

    want = jax_fstar(s["jconsts"], jstate.f)
    st = s["state"]
    got = tg.draw_fstar(st.f, st.theta_idx, s["consts"], s["cfg"],
                        _port_fstar([_fstar_draws(k, H, fstar_method) for k in keys]))
    assert got.shape == (K, H, N, m)
    _close_spread(got, want, *_jax_spread(jax_fstar, s["jconsts"], jstate.f))


@pytest.mark.parametrize("H, C", _HC)
def test_draw_beta_matches_and_keeps_unobserved_items(H, C):
    s = setup_for(C, H)
    jstate = s["jstate"]
    theta = np.asarray(s["jconsts"].grid)[np.asarray(jstate.theta_idx)]
    keys = jax.random.split(jax.random.key(43), K)
    y = jnp.asarray(s["y"])
    want = _per_chain(lambda k, b, th, f, thr: jg.draw_beta(
        k, b, th, f, thr, y, s["jconsts"], s["jcfg"]), keys, jstate.beta,
        jnp.asarray(theta), jstate.f, jstate.thresholds)
    st = s["state"]
    got = tg.draw_beta(st.beta, _t(theta), st.f, st.thresholds, s["yt"], s["consts"],
                       s["cfg"], _port_beta([_beta_draws(k, H) for k in keys]))
    _close(got, want)
    assert torch.equal(got[:, -1, :, 0], st.beta[:, -1, :, 0])  # no response: kept
    assert bool((got[:, 0, :, 1:] != st.beta[:, 0, :, 1:]).all())


@pytest.mark.parametrize("fstar_method", ["matheron", "chol"])
@pytest.mark.parametrize("H, C", _HC)
def test_init_state_two_stage_matches(H, C, fstar_method):
    s = setup_for(C, H, fstar_method)
    draws = []
    for key in s["keys"]:
        k_beta, k_f, k_fstar = jax.random.split(key, 3)
        draws.append((np.asarray(jax.random.normal(k_beta, (H, 3, m), _F64)),
                      *_perturbation_draws(k_f, H), _fstar_draws(k_fstar, H, fstar_method)))
    z_beta, z_u, z_site, fs = zip(*draws)
    got = tg.init_state(_t(s["theta_init"]), _t(s["thr_init"]), s["consts"], s["cfg"],
                        tg.TwoStageInitDraws(_stack_lanes(z_beta, 0), _stack_lanes(z_u, 0),
                                             _stack_lanes(z_site, 0), _port_fstar(fs)))
    jstate = s["jstate"]
    assert torch.equal(got.theta_idx, torch.as_tensor(np.asarray(jstate.theta_idx)).long())
    for name in ("f", "beta", "thresholds"):
        _close(getattr(got, name), getattr(jstate, name))
    y, thr = jnp.asarray(s["y"]), jnp.asarray(s["thr_init"])
    init = jax.jit(lambda c: jax.vmap(lambda k, t: jg.init_state(
        k, t, thr, y, c, s["jcfg"]))(s["keys"], jnp.asarray(s["theta_init"])).fstar)
    _close_spread(got.fstar, jstate.fstar, *_jax_spread(init, s["jconsts"]))


# ---------------------------------------------------------------------------
# whole sweeps
# ---------------------------------------------------------------------------


def _sweep_draws(key, C, H, fstar_method, method):
    """One two-stage gibbs_sweep's draws, replayed from its key as the JAX
    two-stage branch consumes them (mix_subsweeps = 1), per chain."""
    k_f, k_fs, k_th, k_b, k_t = jax.random.split(key, 5)
    u_theta = np.asarray(jg._uniform2d(jax.random.fold_in(k_th, 0), (n, N), _F64))
    cut = (_newton_draws(k_t, (H, m), C - 1) if method == "newton"
           else _ess_draws(k_t, (H, m), C - 1))
    return (_f_draws(k_f, H), _fstar_draws(jax.random.fold_in(k_fs, 0), H, fstar_method),
            u_theta, _beta_draws(k_b, H), cut)


def _port_sweep_draws(per_chain, method):
    f, fs, u, b, cut = zip(*per_chain)
    cut = list(zip(*cut))
    if method == "newton":
        cut = tg.NewtonDraws(_stack_lanes(cut[0], 1), _stack_lanes(cut[1], 1))
    else:
        cut = tg.ESSDraws(_stack_lanes(cut[0], 0), _stack_lanes(cut[1], 0),
                          _stack_lanes(cut[2], 0), _stack_lanes(cut[3], 1))
    return tg.TwoStageDraws(_port_f(f), _port_fstar(fs), _stack_lanes(u, 0),
                            _port_beta(b), cut)


@pytest.mark.parametrize("fstar_method", ["matheron", "chol"])
@pytest.mark.parametrize("C", [2, 3])
def test_three_two_stage_sweeps_match(C, fstar_method):
    """Three whole sweeps, state by state and ll by ll: theta exactly, the
    rest to 1e-8 plus four times JAX's own spread. At C = 2 the cutpoints go through the kernel's plain
    version (once a sweep), held against the XLA draw_threshold."""
    s = setup_for(C, 1, fstar_method)
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

    def fields(st, ll):  # f is f* at theta; beta, t and ll see f
        return [st.f, st.beta, st.thresholds, st.fstar, ll]

    spread = _jax_spread(lambda c: [a for out in jax_sweeps(c) for a in fields(*out)],
                         s["jconsts"])
    state = s["state"]
    for it, (jstate, jll) in enumerate(jax_sweeps(s["jconsts"])):
        draws = _port_sweep_draws(
            [_sweep_draws(keys[it][c], C, 1, fstar_method, "ess") for c in range(K)], "ess")
        state, ll = tg.gibbs_sweep(state, draws, s["yt"], s["consts"], s["cfg"])
        np.testing.assert_array_equal(state.theta_idx.numpy(), np.asarray(jstate.theta_idx))
        for j, (got, want) in enumerate(zip(fields(state, ll), fields(jstate, jll))):
            _close_spread(got, want, spread[5 * it + j], 1e-10 if j == 4 else 1e-8)
    t = state.thresholds[..., 1:-1]
    assert bool((t[..., 1:] > t[..., :-1]).all())


@pytest.mark.usefixtures("default_blas_threads")  # the constants' bits it was set at
def test_two_stage_sweep_newton_matches():
    """The cutpoints by Newton-proposal MH in a two-stage sweep (C = 3)."""
    s = setup_for(3, 1, "matheron", "newton")
    key = jax.random.split(jax.random.key(44), K)
    want, _ = jax.jit(jax.vmap(lambda st, k: jg.gibbs_sweep(
        st, k, jnp.asarray(s["y"]), s["jconsts"], s["jcfg"])))(s["jstate"], key)
    draws = _port_sweep_draws(
        [_sweep_draws(key[c], 3, 1, "matheron", "newton") for c in range(K)], "newton")
    got, _ = tg.gibbs_sweep(s["state"], draws, s["yt"], s["consts"], s["cfg"])
    np.testing.assert_array_equal(got.theta_idx.numpy(), np.asarray(want.theta_idx))
    for name in ("f", "beta", "thresholds", "fstar"):
        _close(getattr(got, name), getattr(want, name), 1e-8)


def test_sweep_draws_choose_by_f_method():
    """Two-stage draws have their own layout; the conjugate stream is the
    one it was (test_torch_ordinal checks it number by number)."""
    s = setup_for(2, 3)
    cfg = s["cfg"]
    d = tg.sweep_draws(torch.Generator().manual_seed(0), K, s["consts"], cfg)
    assert isinstance(d, tg.TwoStageDraws)
    assert d.f.z_u.shape == (K, 3, 35, m) and d.f.z_site.shape == (K, 3, n, m)
    assert d.f.ess.rs.shape == (64, K, 3, m) and d.beta.z.shape == (K, 3, m, 3)
    assert d.fstar.z_n.shape == (K, 3, N, m) and d.u_theta.shape == (K, n, N)
    assert isinstance(d.cut, tg.ESSDraws) and d.cut.nu.shape == (K, 3, m, 1)
    moved = d.to("cpu")
    assert isinstance(moved.f.ess, tg.ESSLoopDraws) and torch.equal(moved.f.ess.rs, d.f.ess.rs)
    init = tg.init_draws(torch.Generator().manual_seed(0), K, s["consts"], cfg)
    assert isinstance(init, tg.TwoStageInitDraws)
    conj = GPIRTConfig(n=n, m=m, horizon=3, C=2, grid_size=N, dtype="float64")
    assert isinstance(tg.sweep_draws(torch.Generator(), K, s["consts"], conj), tg.SweepDraws)
    assert isinstance(tg.init_draws(torch.Generator(), K, s["consts"], conj), tg.InitDraws)


def test_two_stage_refuses_tempering():
    s = setup_for(2, 1)
    d = tg.sweep_draws(torch.Generator().manual_seed(0), K, s["consts"], s["cfg"])
    with pytest.raises(NotImplementedError, match="conjugate"):
        tg.gibbs_sweep(s["state"], d, s["yt"], s["consts"], s["cfg"], temp=4.0)


# ---------------------------------------------------------------------------
# gpirt_mcmc
# ---------------------------------------------------------------------------


def _data(C=2):
    y = _y(C, 1, seed=3)[0].astype(np.float64)
    y[y == 0] = np.nan
    return y


@pytest.mark.parametrize("fstar_method", ["matheron", "chol"])
def test_gpirt_mcmc_two_stage_shapes_and_stores(fstar_method):
    """Reference layouts, one kernel-wrapper call a sweep at C = 2, and f*
    stored with its parametric mean: at each respondent's grid point it is
    f plus mu(theta)."""
    calls = binary_threshold_ess.launches
    out = gpirt_mcmc(_data(), 4, 2, CHAIN=2, vote_codes=None, f_method="two_stage",
                     fstar_method=fstar_method, store_f=True, store_fstar=True,
                     grid_size=N, dtype="float64", device="cpu")
    assert binary_threshold_ess.launches == calls  # CPU: the plain version
    for d in out:
        assert d["theta"].shape == (4, n, 1) and d["f"].shape == (4, n, m, 1)
        assert d["fstar"].shape == (4, N, m, 1) and d["threshold"].shape == (4, m, 3, 1)
        assert np.isfinite(d["ll"]).all() and np.isfinite(d["f"]).all()
        theta, beta = d["theta"][..., 0], d["beta"][..., 0]
        idx = np.rint((theta + 5.0) / 0.1).astype(int)
        mu = np.einsum("snp,spm->snm",
                       np.stack([np.ones_like(theta), theta, theta ** 2], -1), beta)
        at = np.take_along_axis(d["fstar"][..., 0], idx[..., None], axis=1)
        np.testing.assert_allclose(at, d["f"][..., 0] + mu, rtol=1e-10, atol=1e-10)


def test_gpirt_mcmc_two_stage_guards():
    """SMC needs the conjugate sampler, as in JAX; f_method="grid" and the
    two-stage sampler under constant_IRF run, in the JAX layout."""
    kw = dict(vote_codes=None, device="cpu", dtype="float64", grid_size=N, verbose=False)
    for run in (dict(f_method="grid"), dict(f_method="two_stage", constant_IRF=1,
                                            theta_init=np.linspace(-1, 1, n))):
        d = gpirt_mcmc(_data(), 2, 1, store_fstar=True, **run, **kw)[0]
        assert d["fstar"].shape == (2, N, m, 1) and np.isfinite(d["fstar"]).all()
        assert d["threshold"].shape == (2, m, 3, 1) and np.isfinite(d["ll"]).all()
    with pytest.raises(NotImplementedError, match="conjugate"):
        gpirt_mcmc(_data(), 2, 1, f_method="two_stage", smc_steps=2, **kw)
