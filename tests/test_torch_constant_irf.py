"""The blocks of the port's shared-IRF samplers (``constant_IRF``) and of
the grid f-method (``f_method="grid"``) against the JAX package; whole
sweeps and the entry points are in tests/test_torch_grid.py.

As in tests/test_torch_dynamic.py, both packages compute in float64 on the
CPU from the same constants and state (H = 3 sessions, the GP theta
regime), the random draws made in JAX from its own keys and handed to the
port's pure blocks. Under constant_IRF a block that draws the shared IRF
takes its draws with no session axis in JAX and a session axis of 1 in the
port:

  * draw_fstar_direct: ``k_nu, k_ess = split(key)``; the grid prior draw
    ``k_q, k_p, k_n = split(k_nu, 3)`` of (q, m), (3, m), (N, m), lead ()
    pooled or (H,) otherwise; ess_update's uniforms from k_ess;
  * the pooled cutpoint ESS: nu (m, C-1) from k_nu, lanes (m,); Newton:
    try k's ``k_z, k_u, key = split(fold_in(key, k), 3)``, lanes (m,);
  * the pooled conjugate f*: ``k_u, k_e = split(key)``, the grid prior
    draw from k_u, eps (H, n, m) from k_e;
  * two-stage draw_f: ``k_nu, k_ess``, the perturbation's
    ``k_u, k_n = split(k_nu)`` of (q+3, m) and (H n, m); f* | f: the grid
    prior draw from the key;
  * init_state: ``k_beta, k_f, k_fstar = split(key, 3)``, beta (1, 3, m).

Tolerances: theta indices exactly, rtol 1e-10 a block and 1e-8 after three
sweeps; f* of the two-stage sampler (inducing points: a 100 x 100 Gram plus
1e-6 I, conditioned ~1e10) that plus four times JAX's own one-ulp spread
(:func:`_spread`), as in tests/test_torch_two_stage.py.

The JAX package's inducing-point f* is evaluated op by op, as its source
reads (:func:`jax_inducing_op_by_op`): jit fuses the inducing points
``lo + (hi - lo) k / (p - 1)`` into one multiply-add by 1/(p - 1), which
moves a point by one rounding, and a point that falls on a snapped theta
shared by several sites then reads another of their f values (jnp.interp
at a tie): JAX's jitted and op-by-op f* differ by up to 394 at |f*| 2600
here, while the port is within 4.4e-5 of the op-by-op one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a process)
from gpirt_tpu.models import gibbs as jg
from gpirt_tpu.models.config import GPIRTConfig as JConfig
from gpirt_tpu.models.config import make_constants as j_make_constants
from gpirt_tpu.ops.pallas_threshold import PALLAS_THRESHOLD_ROUNDS, binary_threshold_ess_pallas
from gpirt_tpu_torch.api import default_thresholds
from gpirt_tpu_torch.convert import constants_from_numpy, state_from_numpy
from gpirt_tpu_torch.models import gibbs as tg
from gpirt_tpu_torch.models.config import GPIRTConfig
from gpirt_tpu_torch.ops import ess, linalg
from gpirt_tpu_torch.ops.interp import interp
from gpirt_tpu_torch.ops.likelihood import delta_to_threshold, threshold_to_delta
from gpirt_tpu_torch.ops.threshold_ess import binary_threshold_ess_reference
from test_torch_ordinal import _ess_draws, _ess_loop_draws, _newton_draws

K, H, n, m, N, Q = 2, 3, 12, 6, 101, 32
LS = 2.0  # the GP theta regime at H = 3
_TWO_PI = 6.283185307179586
_C = 0.7071067811865476
_F64 = jnp.float64
RTOL = 1e-10
VOTES = {"yea": 1, "nay": 0, "missing": None}


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=rtol)


def _y(C, seed=0):
    """(H, n, m) responses 1..C with ~15% masked cells from one shared
    response curve a item, the trait drifting over sessions."""
    rng = np.random.default_rng(seed)
    theta = np.linspace(-1.5, 1.5, n)[None] + 0.4 * rng.standard_normal((H, n))
    latent = theta[..., None] * rng.standard_normal(m) * 1.5 + rng.standard_normal((H, n, m))
    cuts = np.quantile(latent, np.arange(1, C) / C)
    y = (np.digitize(latent, cuts) + 1).astype(np.int32)
    y[rng.random((H, n, m)) < 0.15] = 0
    return y


def _setup(f_method, C, method="ess", pooled=True):
    kw = dict(n=n, m=m, horizon=H, C=C, grid_size=N, dtype="float64", f_method=f_method,
              threshold_method=method, theta_ls=LS, constant_IRF=pooled)
    jcfg, cfg = JConfig(threshold_ess_twophase=False, **kw), GPIRTConfig(**kw)
    assert cfg.theta_regime == jcfg.theta_regime == "GP"
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
    # cutpoints off qnorm(i/C), each chain's differently (one vector a chain,
    # shared by the sessions, under constant_IRF)
    d = _t(rng.standard_normal((K, 1 if pooled else H, m, C - 1)) * 0.3)
    thr = delta_to_threshold(threshold_to_delta(_t(jstate.thresholds)) + d)
    jstate = jstate._replace(thresholds=jnp.asarray(thr.numpy()))
    return dict(jcfg=jcfg, cfg=cfg, jconsts=jconsts, y=y, yt=torch.as_tensor(y),
                consts=constants_from_numpy(jconsts, device="cpu", dtype=torch.float64),
                keys=keys, jstate=jstate, theta_init=theta_init, thr_init=thr_init,
                state=state_from_numpy(jstate, device="cpu", dtype=torch.float64))


_SETUPS = {}


def setup_for(f_method, C=2, method="ess", pooled=True):
    key = (f_method, C, method, pooled)
    if key not in _SETUPS:
        _SETUPS[key] = _setup(*key)
    return _SETUPS[key]


# ---------------------------------------------------------------------------
# JAX's draws from its keys, in the port's layouts
# ---------------------------------------------------------------------------


def _join(per_chain):
    """Per-chain port draw tuples, each with a chain axis of 1, joined along
    the chain axis: axis 1 for the per-round and per-try tables (a
    NewtonDraws, or a field named rs), axis 0 otherwise; a field the sweep
    does not draw (None) stays None."""
    first = per_chain[0]
    if torch.is_tensor(first):
        return torch.cat(per_chain, 0)
    fields = []
    for i, name in enumerate(first._fields):
        parts = [d[i] for d in per_chain]
        if parts[0] is None:
            fields.append(None)
        elif isinstance(parts[0], tuple):
            fields.append(_join(parts))
        else:
            axis = 1 if isinstance(first, tg.NewtonDraws) or name == "rs" else 0
            fields.append(torch.cat(parts, axis))
    return type(first)(*fields)


def _lane(a, shape, axis=0):
    """A numpy draw as one chain's port tensor: reshaped to ``shape`` with a
    chain axis of 1 inserted at ``axis``."""
    return _t(np.asarray(a).reshape(shape)).unsqueeze(axis)


def _irf(pooled):
    """(JAX lead shape, the port's session axis) of the shared-IRF draws."""
    return ((), 1) if pooled else ((H,), H)


def _grid_prior(key, pooled):
    lead, hi = _irf(pooled)
    k_q, k_p, k_n = jax.random.split(key, 3)
    return tg.FStarDraws(*(_lane(jg._normal2d(k, lead + s, _F64), (hi,) + s)
                           for k, s in ((k_q, (Q, m)), (k_p, (3, m)), (k_n, (N, m)))))


def _loop(key, lanes, hi):
    logu, eps0, rs = _ess_loop_draws(key, lanes)
    return tg.ESSLoopDraws(_lane(logu, (hi, m)), _lane(eps0, (hi, m)),
                           _lane(rs, (-1, hi, m), 1))


def _direct(key, pooled):
    """draw_fstar_direct's draws: (FStarDraws, ESSLoopDraws)."""
    k_nu, k_ess = jax.random.split(key)
    lead, hi = _irf(pooled)
    return _grid_prior(k_nu, pooled), _loop(k_ess, lead + (m,), hi)


def _cut(key, C, method, pooled):
    lead, hi = _irf(pooled)
    if method == "newton":
        z, logu = _newton_draws(key, lead + (m,), C - 1)
        return tg.NewtonDraws(_lane(z, (-1, hi, m, C - 1), 1), _lane(logu, (-1, hi, m), 1))
    nu, logu, eps0, rs = _ess_draws(key, lead + (m,), C - 1)
    return tg.ESSDraws(_lane(nu, (hi, m, C - 1)), _lane(logu, (hi, m)),
                       _lane(eps0, (hi, m)), _lane(rs, (-1, hi, m), 1))


def _draw_f(key):
    """The pooled two-stage draw_f's draws (one session of H n sites)."""
    k_nu, k_ess = jax.random.split(key)
    k_u, k_n = jax.random.split(k_nu)
    return tg.FDraws(_lane(jg._normal2d(k_u, (Q + 3, m), _F64), (1, Q + 3, m)),
                     _lane(jg._normal2d(k_n, (H * n, m), _F64), (1, H * n, m)),
                     _loop(k_ess, (m,), 1))


def _beta(key):
    k_nu, k_ess = jax.random.split(key)
    return tg.BetaDraws(_lane(jax.random.normal(k_nu, (H, m, 3), _F64), (H, m, 3)),
                        _loop(k_ess, (H, m), H))


def _theta_uniforms(key):
    """The GP regime's uniforms: session h's from split(key, H)[h]."""
    return _lane(np.stack([np.asarray(jg._uniform2d(k, (n, N), _F64))
                           for k in jax.random.split(key, H)]), (H, n, N))


def _conj_fstar(key, pooled=True):
    """The conjugate f*'s draws: (z_q, z_p, z_n, eps)."""
    k_u, k_e = jax.random.split(key)
    return (*_grid_prior(k_u, pooled), _lane(jg._normal2d(k_e, (H, n, m), _F64), (H, n, m)))


def _sweep(key, f_method, C, method, pooled):
    """One gibbs_sweep's draws for one chain, replayed from its key as the
    JAX branch of ``f_method`` consumes them (mix_subsweeps = 1)."""
    k_f, k_fs, k_th, k_b, k_t = jax.random.split(key, 5)
    u_theta = _theta_uniforms(jax.random.fold_in(k_th, 0))
    cut = _cut(k_t, C, method, pooled)
    if f_method == "grid":
        return tg.GridDraws(*_direct(jax.random.fold_in(k_f, 0), pooled), u_theta,
                            _beta(k_b), cut)
    if f_method == "two_stage":
        return tg.TwoStageDraws(_draw_f(k_f), _grid_prior(jax.random.fold_in(k_fs, 0), True),
                                u_theta, _beta(k_b), cut)
    u_z = _lane(jg._uniform2d(jax.random.fold_in(k_f, 0), (H, n, m), _F64), (H, n, m))
    z_q, z_p, z_n, eps = _conj_fstar(jax.random.fold_in(k_f, 2), pooled)
    zeta = _lane(jax.random.normal(k_b, (H, m, 3), _F64), (H, m, 3))
    return tg.SweepDraws(u_theta, u_z, z_q, z_p, z_n, eps, zeta, cut)


def _init(key, f_method):
    """The pooled init_state's draws."""
    k_beta, k_f, k_fstar = jax.random.split(key, 3)
    z_beta = _lane(jax.random.normal(k_beta, (1, 3, m), _F64), (1, 3, m))
    if f_method != "two_stage":
        return tg.InitDraws(z_beta, _lane(jax.random.normal(k_f, (N, m), _F64), (1, N, m)))
    k_u, k_n = jax.random.split(k_f)
    return tg.TwoStageInitDraws(z_beta, _lane(jg._normal2d(k_u, (Q + 3, m), _F64), (1, Q + 3, m)),
                                _lane(jg._normal2d(k_n, (n, m), _F64), (1, n, m)),
                                _grid_prior(k_fstar, True))


def _jax_chains(fn, keys, *args, jit=True):
    """A JAX block vmapped over the chains (keys and each arg's axis 0),
    jitted unless ``jit`` is False (then op by op)."""
    run = jax.vmap(fn)
    return (jax.jit(run) if jit else run)(
        keys, *(jax.tree_util.tree_map(jnp.asarray, a) for a in args))


def _mu(seed):
    return np.random.default_rng(seed).standard_normal((K, H, n, m)) * 0.5


@pytest.fixture
def jax_inducing_op_by_op(monkeypatch):
    """Inside the JAX programs a test jits, the JAX package's own
    _fstar_constant_irf runs op by op through a host callback (its source's
    rounding; see the module docstring)."""
    op_by_op = jg._fstar_constant_irf

    def hooked(key, f, theta_idx, consts, config):
        def host(key_data, f, idx, consts):
            return np.asarray(op_by_op(jax.random.wrap_key_data(key_data), jnp.asarray(f),
                                       jnp.asarray(idx),
                                       jax.tree_util.tree_map(jnp.asarray, consts), config))

        out = jax.ShapeDtypeStruct((config.horizon, config.grid_size, config.m), f.dtype)
        return jax.pure_callback(host, out, jax.random.key_data(key), f, theta_idx, consts,
                                 vmap_method="sequential")

    monkeypatch.setattr(jg, "_fstar_constant_irf", hooked)


def _spread(fn, jconsts, *args, reps=3):
    """tests/test_torch_two_stage.py::_jax_spread with the inducing-point
    Gram's inputs moved too: JAX's largest change of each output of
    ``fn(jconsts, *args)`` when U_se, Psi_grid, the grid Gram, the beta
    prior sds (the ICC kernel's) and ``args`` move by about one float64
    rounding."""
    rng = np.random.default_rng(0)

    def ulp(a):
        return jnp.asarray(np.asarray(a) * (1.0 + 2.2e-16 * rng.standard_normal(np.shape(a))))

    def listed(out):
        return [np.asarray(o) for o in (out if isinstance(out, list) else [out])]

    def change(o, b):  # equal entries (the cutpoints' infinite ends) count 0
        d = np.zeros(b.shape)
        np.subtract(o, b, out=d, where=o != b)
        return np.abs(d)

    base = listed(fn(jconsts, *args))
    spread = [np.zeros(b.shape) for b in base]
    for _ in range(reps):
        moved = dataclasses.replace(jconsts, **{k: ulp(getattr(jconsts, k)) for k in (
            "U_se", "Psi_grid", "grid_gram", "beta_prior_sds")})
        out = listed(fn(moved, *(ulp(a) for a in args)))
        spread = [np.maximum(sp, change(o, b)) for sp, o, b in zip(spread, out, base)]
    return spread


def _close_lanes(got, want, spread, rtol=RTOL):
    """``rtol`` plus four times JAX's own spread, its largest over the
    lane's grid points or sites (axis -2); equal entries (infinite ends)
    pass."""
    got, want = np.asarray(got), np.asarray(want)
    lane = spread.max(axis=-2, keepdims=True) if spread.ndim > 1 else spread
    tol = rtol + rtol * np.abs(want) + 4.0 * lane
    err = np.zeros(want.shape)
    np.subtract(got, want, out=err, where=got != want)
    err = np.abs(err)
    assert (err <= tol).all(), (float(np.max(err / tol)), float(err.max()))


# ---------------------------------------------------------------------------
# configuration and interp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw, resolved", [
    (dict(constant_IRF=True), "grid"), (dict(constant_IRF=True, horizon=3), "grid"),
    (dict(constant_IRF=True, f_method="conjugate"), "conjugate"),
    (dict(constant_IRF=True, f_method="two_stage"), "two_stage"),
    (dict(f_method="grid"), "grid"), (dict(f_method="grid", horizon=3), "grid"),
])
def test_config_resolves_as_jax(kw, resolved):
    """f_method and the cutpoint method resolve as in the JAX package; the
    inducing-point count is JAX's."""
    cfg, jcfg = GPIRTConfig(n=5, m=4, **kw), JConfig(n=5, m=4, **kw)
    assert cfg.resolved_f_method == jcfg.resolved_f_method == resolved
    assert cfg.resolved_threshold_method == jcfg.resolved_threshold_method == "ess"
    assert cfg.n_inducing == jcfg.n_inducing == 100
    newton = dict(kw, threshold_method="newton")
    assert GPIRTConfig(n=5, m=4, **newton).resolved_threshold_method == "newton"
    with pytest.raises(ValueError, match="f_method"):
        GPIRTConfig(n=5, m=4, f_method="dense")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interp_matches_jnp_interp_on_ties(seed):
    """Snapped abscissae with many ties, points on them, between them and
    past both ends: jnp.interp's values, columns and batch included."""
    rng = np.random.default_rng(seed)
    xp = np.sort(np.round(rng.uniform(-2, 2, (3, 40)) * 4) / 4, axis=-1)
    fp = rng.standard_normal((3, 40, 4))
    x = np.concatenate([np.linspace(-2.6, 2.6, 53)[None].repeat(3, 0), xp[:, ::7]], -1)
    want = np.stack([np.stack([np.asarray(jnp.interp(x[b], xp[b], fp[b, :, j]))
                               for j in range(4)], -1) for b in range(3)])
    got = interp(_t(x), _t(xp), _t(fp))
    _close(got, want, 1e-14)
    shared = interp(_t(x), _t(xp[0]), _t(fp[0]).expand(3, 40, 4))
    _close(shared[0], want[0], 1e-14)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("C, pooled", [(2, True), (3, True), (2, False)])
def test_draw_fstar_direct_matches(C, pooled):
    """The grid ESS on f*, pooled (lanes (K, m), the ll summed over all H n
    sites) and one function a session: one ess_update call."""
    s = setup_for("grid", C, pooled=pooled)
    mu = _mu(40)
    keys = jax.random.split(jax.random.key(40), K)
    y = jnp.asarray(s["y"])
    want = _jax_chains(lambda k, st, mm: jg.draw_fstar_direct(
        k, st, mm, y, s["jcfg"], s["jconsts"]), keys, s["jstate"], mu)
    calls = ess.ess_update.calls
    fs, ls = zip(*[_direct(k, pooled) for k in keys])
    got = tg.draw_fstar_direct(s["state"], _t(mu), s["yt"], s["consts"], s["cfg"],
                               _join(fs), _join(ls))
    assert ess.ess_update.calls == calls + 1
    _close(got[0], want[0])
    _close(got[1], want[1])
    assert float((got[0] != s["state"].fstar).double().mean()) > 0.8
    if pooled:
        assert torch.equal(got[0][:, 0], got[0][:, -1])


@pytest.mark.parametrize("C, method, temp", [(2, "ess", None), (2, "ess", 4.0),
                                             (3, "ess", None), (3, "ess", 4.0),
                                             (2, "newton", 4.0), (3, "newton", None)])
def test_pooled_cutpoints_match(C, method, temp):
    """One cutpoint vector a chain, its likelihood summed over all H n sites:
    the ESS (binary through the kernel's plain version on (K, 1, H n, m)
    lanes) and Newton-proposal MH, against JAX's draw_threshold."""
    s = setup_for("conjugate", C, method)
    st = s["jstate"]
    mu = _mu(41)
    keys = jax.random.split(jax.random.key(41), K)
    y = jnp.asarray(s["y"])
    want = _jax_chains(lambda k, thr, f, mm: jg.draw_threshold(
        k, thr, f, mm, y, s["jcfg"], temp), keys, st.thresholds, st.f, mu)
    got = tg._draw_cutpoints(s["state"].thresholds, s["state"].f, _t(mu), s["yt"],
                             s["cfg"], _join([_cut(k, C, method, True) for k in keys]),
                             temp)
    _close(got, want)
    assert got.is_contiguous() and torch.equal(got[:, 0], got[:, -1])
    assert bool((got != s["state"].thresholds)[..., 1:-1].any())


@pytest.mark.parametrize("temp", ["none", "float", "ladder"])
def test_pooled_conjugate_fstar_matches(temp):
    """_fstar_conjugate_pooled's stacked (H n)-site regression at T = None,
    4.0 and one temperature a chain (JAX vmapped over chains)."""
    s = setup_for("conjugate", 2)
    temps = {"none": None, "float": 4.0, "ladder": np.array([1.7, 6.0])}[temp]
    rng = np.random.default_rng(3)
    z_resid = rng.standard_normal((K, H, n, m)) + 0.2
    keys = jax.random.split(jax.random.key(42), K)
    args = (keys, s["jstate"], z_resid)
    if temp == "ladder":
        want = _jax_chains(lambda k, st, zr, t: jg.draw_fstar_conjugate(
            k, st, zr, s["jcfg"], s["jconsts"], t), *args, temps)
        t = _t(temps)
    else:
        want = _jax_chains(lambda k, st, zr: jg.draw_fstar_conjugate(
            k, st, zr, s["jcfg"], s["jconsts"], temps), *args)
        t = temps
    draws = [_conj_fstar(k) for k in keys]
    got = tg.draw_fstar_conjugate(s["state"], _t(z_resid), s["cfg"], s["consts"],
                                  *(torch.cat(a) for a in zip(*draws)), t)
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_two_stage_draw_f_pooled_matches():
    """draw_f on the stacked (H n)-site GP with session 0's cutpoints."""
    s = setup_for("two_stage", 3)
    mu = _mu(43)
    keys = jax.random.split(jax.random.key(43), K)
    y = jnp.asarray(s["y"])
    want = _jax_chains(lambda k, st, mm: jg.draw_f(k, st, mm, y, s["jconsts"], s["jcfg"]),
                       keys, s["jstate"], mu)
    st = s["state"]
    got = tg.draw_f(st.f, st.theta_idx, st.thresholds, _t(mu), s["yt"], s["consts"],
                    s["cfg"], _join([_draw_f(k) for k in keys]))
    assert got.shape == (K, H, n, m) and got.is_contiguous()
    _close(got, want)


def test_fstar_constant_irf_matches():
    """The inducing-point f* | f draw (interp of f and of the grid prior
    draw, the ICC Gram, its jittered Cholesky, two triangular solves)
    against JAX's op by op, to 1e-10 plus four times JAX's own spread; one
    function shared by the sessions."""
    s = setup_for("two_stage", 2)
    jstate = s["jstate"]
    keys = jax.random.split(jax.random.key(44), K)

    def jax_fstar(jconsts, f):
        return _jax_chains(lambda k, ff, idx: jg.draw_fstar(k, ff, idx, jconsts, s["jcfg"]),
                           keys, f, jstate.theta_idx, jit=False)

    want = jax_fstar(s["jconsts"], jstate.f)
    st = s["state"]
    got = tg.draw_fstar(st.f, st.theta_idx, s["consts"], s["cfg"],
                        _join([_grid_prior(k, True) for k in keys]))
    assert got.shape == (K, H, N, m) and torch.equal(got[:, 0], got[:, 2])
    _close_lanes(got, want, *_spread(jax_fstar, s["jconsts"], jstate.f))


@pytest.mark.parametrize("f_method", ["grid", "conjugate", "two_stage"])
def test_init_state_pooled_matches(f_method, jax_inducing_op_by_op):
    """One beta and one f* a chain (two-stage: f from session 0's sites),
    copied to every session, as JAX's init_state."""
    s = setup_for(f_method, 2)
    got = tg.init_state(_t(s["theta_init"]), _t(s["thr_init"]), s["consts"], s["cfg"],
                        _join([_init(k, f_method) for k in s["keys"]]))
    want = jax.jit(jax.vmap(lambda k, t: jg.init_state(
        k, t, jnp.asarray(s["thr_init"]), jnp.asarray(s["y"]), s["jconsts"], s["jcfg"])))(
        s["keys"], jnp.asarray(s["theta_init"]))
    np.testing.assert_array_equal(got.theta_idx.numpy(), np.asarray(want.theta_idx))
    for name in ("f", "beta", "thresholds", "fstar"):
        if f_method == "two_stage" and name == "fstar":
            continue
        _close(getattr(got, name), getattr(want, name))
    assert torch.equal(got.fstar[:, 0], got.fstar[:, -1])
    assert torch.equal(got.beta[:, 0], got.beta[:, -1])
    if f_method == "two_stage":
        init = jax.jit(lambda c: jax.vmap(lambda k, t: jg.init_state(
            k, t, jnp.asarray(s["thr_init"]), jnp.asarray(s["y"]), c, s["jcfg"]))(
            s["keys"], jnp.asarray(s["theta_init"])).fstar)
        _close_lanes(got.fstar, want.fstar, *_spread(init, s["jconsts"]))


def test_pooled_binary_plain_version_equals_pallas_interpret():
    """The kernel's plain version at the pooled layout (g (K, 1, H n, m),
    one t_1 a (chain, item)) against the Pallas kernel in interpret mode on
    the (H n, K m) site rows, fed the same uniforms (1e-10 but for at most
    2 near-tie lanes, the Pallas erf being a polynomial)."""
    rng = np.random.default_rng(5)
    g = rng.standard_normal((K, H, n, m)) * 1.5
    y = _y(2, seed=6)
    t1, nu = rng.standard_normal((2, K, m))
    sgn = np.where(y == 1, 1.0, -1.0) * (y > 0)
    L, sites = K * m, H * n

    def rows(a):  # (K, H, n, m) -> (H n, K m), lane k m + j
        return jnp.asarray(np.broadcast_to(a, (K, H, n, m)).reshape(K, sites, m)
                           .transpose(1, 0, 2).reshape(sites, L))

    key = jax.random.key(12)
    want = np.asarray(binary_threshold_ess_pallas(
        key, jnp.asarray(t1.reshape(L)), jnp.asarray(nu.reshape(L)), rows(g), rows(sgn),
        rows((y > 0).astype(np.float64)), _C, interpret=True))
    k_u, k_eps, k_loop = jax.random.split(key, 3)
    logu = np.log(np.asarray(jax.random.uniform(k_u, (L,), dtype=_F64)))
    eps0 = np.asarray(jax.random.uniform(k_eps, (L,), dtype=_F64, maxval=_TWO_PI))
    rs = np.asarray(jax.random.uniform(k_loop, (PALLAS_THRESHOLD_ROUNDS, L), dtype=_F64))
    got = binary_threshold_ess_reference(
        _t(g).reshape(K, 1, sites, m), torch.as_tensor(y).reshape(1, sites, m),
        *(_t(a).reshape(K, 1, m) for a in (t1, nu, logu, eps0)),
        _t(rs).reshape(-1, K, 1, m), _C)
    err = np.abs(got.numpy().reshape(L) - want)
    assert np.sum(err > 1e-10) <= 2, np.sort(err)[-5:]
    assert np.mean(got.numpy().reshape(L) != t1.reshape(L)) > 0.8


@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("pooled", [True, False])
def test_draw_fstar_direct_matches_in_lane_chunks(pooled, chunk, monkeypatch):
    """The grid f* ESS sums its likelihood over the sites LANE_CHUNK lanes
    at a time (``ops.linalg.lane_chunked``): with the chunk at 1 lane (two
    chunks) and at 3 (one chunk padded from 2 lanes) the block still equals
    JAX's."""
    monkeypatch.setattr(linalg, "LANE_CHUNK", chunk)
    test_draw_fstar_direct_matches(2, pooled)
