"""Geweke (2004) joint-distribution test of the port's sweep.

The pattern of tests/test_geweke.py::_run_geweke_sweep, with the port's
``gibbs_sweep`` in the successive-conditional chain: the prior and the
response redraws come from ``gpirt_tpu.models.generate``, the statistics
from that file's ``_stats``, and states pass between the packages as
numpy. If every block of the port targets its exact conditional, moments
of the chain agree with forward draws from the prior up to MC error.

The oracles run 12,000 sweeps each and are ``slow``: three of one session,
two of two sessions, in the RDM and GP theta regimes with the affine moves,
one of the two-stage sampler (``f_method="two_stage"``), JAX's five
constant_IRF classes over two sessions (the grid sampler with the cutpoint
ESS, binary and ordinal, and with Newton cutpoints, binary and ordinal;
the conjugate sampler's pooled f*), and, at JAX's sizes and seeds and
with its affine moves, TestGewekeTempered, TestGewekeConjugate,
TestGewekeBinaryCollapsed and TestGewekeThresholdShift, plus the ESS theta
update at the binary ESS oracle's sizes. Short chains check finite,
ordered cutpoints in the fast tier.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpirt_tpu.models.config import GPIRTConfig as JConfig
from gpirt_tpu.models.config import make_constants as j_make_constants
from gpirt_tpu.models.generate import sample_prior_state, sample_responses
from gpirt_tpu.models.gibbs import GPIRTState as JState
from gpirt_tpu_torch.convert import constants_from_numpy, state_from_numpy, to_numpy
from gpirt_tpu_torch.models import gibbs as tg
from gpirt_tpu_torch.models.config import GPIRTConfig
from test_geweke import _stats

NAMES = ["th", "th2", "b", "b2", "fs", "fs2", "t1", "t12", "ti", "ti2"]


def _model(n, m, C, method, N=61, H=1, ls=10.0, f_method="conjugate",
           fstar_method="matheron", constant_IRF=False, **options):
    sampler = dict(f_method=f_method, fstar_method=fstar_method,
                   constant_IRF=constant_IRF, **options)
    jcfg = JConfig(n=n, m=m, horizon=H, C=C, grid_size=N, dtype="float64",
                   threshold_method=method, theta_ls=ls, **sampler)
    jconsts = j_make_constants(jcfg, beta_prior_means=np.zeros((3, m)),
                               beta_prior_sds=np.full((3, m), 1.5),
                               theta_prior_means=np.zeros((2, n)),
                               theta_prior_sds=np.zeros((2, n)))
    cfg = GPIRTConfig(n=n, m=m, horizon=H, C=C, grid_size=N, dtype="float64",
                      threshold_method=method, theta_ls=ls, **sampler)
    return jcfg, jconsts, cfg, constants_from_numpy(jconsts, device="cpu",
                                                    dtype=torch.float64)


def _chain(n, m, C, method, sweeps, seed=0, mask=None, temp=None, **model):
    """The successive-conditional chain: the port's sweep given y, then y
    redrawn given the state, both at the temperature ``temp`` (None: 1).
    Returns the (sweeps, 10) statistics, the cutpoints of every sweep and
    the forward model. ``model`` takes the horizon H, the time-GP length
    scale ls, the sampler's f_method, fstar_method and constant_IRF, and
    any further GPIRTConfig field (the affine moves, the shift, the theta
    method)."""
    jcfg, jconsts, cfg, consts = _model(n, m, C, method, **model)
    k0, k1, kr = jax.random.split(jax.random.key(seed + 1), 3)
    st0 = sample_prior_state(k0, jconsts, jcfg)
    y = sample_responses(k1, st0, jconsts, jcfg, mask=mask, temp=temp)
    respond = jax.jit(lambda k, st: sample_responses(k, st, jconsts, jcfg, mask=mask,
                                                     temp=temp))
    stats = jax.jit(lambda st: _stats(st, jconsts))
    state = state_from_numpy({k: np.asarray(v)[None] for k, v in st0._asdict().items()},
                             device="cpu", dtype=torch.float64)
    gen = torch.Generator().manual_seed(seed)
    out, thr = [], []
    for it, key in enumerate(jax.random.split(kr, sweeps)):
        state, _ = tg.gibbs_sweep(state, tg.sweep_draws(gen, 1, consts, cfg, it),
                                  torch.as_tensor(np.array(y)), consts, cfg, temp, it)
        jst = JState(**{k: jnp.asarray(v[0]) for k, v in to_numpy(state).items()})
        y = respond(key, jst)
        out.append(np.asarray(stats(jst)))
        thr.append(state.thresholds[0].numpy())
    return np.stack(out), np.stack(thr), (jcfg, jconsts)


def _run_geweke_sweep(n, m, C, method, seed=0, mask=None, temp=None, **model):
    sc, _, (jcfg, jconsts) = _chain(n, m, C, method, 12000, seed, mask, temp, **model)
    sc = sc[500::3]

    @jax.jit
    def forward(key):
        return _stats(sample_prior_state(key, jconsts, jcfg), jconsts)

    fwd = np.asarray(jax.vmap(forward)(jax.random.split(jax.random.key(seed), 4000)))
    fails = []
    for j, name in enumerate(NAMES):
        mf, vf = fwd[:, j].mean(), fwd[:, j].var() / len(fwd)
        x = sc[:, j]
        nb = len(x) // 40
        bm = x[: nb * 40].reshape(nb, 40).mean(axis=1)
        z = (mf - x.mean()) / np.sqrt(vf + bm.var(ddof=1) / nb + 1e-12)
        if abs(z) > 4.5:
            fails.append((name, float(z)))
    assert not fails, fails


def _mask(seed, n, m, keep=0.3):
    return jnp.asarray(np.random.default_rng(seed).random((1, n, m)) > keep)


@pytest.mark.slow
def test_geweke_binary_ess_masked():
    """The binary cutpoint ESS (the kernel's plain version on the CPU) with
    missing cells: TestGewekeBinaryESS's sizes."""
    _run_geweke_sweep(6, 3, 2, "ess", mask=_mask(11, 6, 3))


@pytest.mark.slow
def test_geweke_ordinal_ess_masked():
    """C = 3, the ordinal ESS and the generic z draw, with missing cells."""
    _run_geweke_sweep(6, 3, 3, "ess", mask=_mask(42, 6, 3, keep=0.4))


@pytest.mark.slow
def test_geweke_ordinal_newton_c5():
    """C = 5 Newton: TestGewekeOrdinalNewton.test_ordinal_newton_c5's sizes."""
    _run_geweke_sweep(6, 3, 5, "newton", seed=7)


AFFINE = dict(affine_shift_max=5, affine_rounds=2)  # JAX's oracles' setting


@pytest.mark.slow
@pytest.mark.parametrize("regime, ls", [("RDM", 0.05), ("GP", 1.0)])
def test_geweke_regimes(regime, ls):
    """Two sessions, C = 3, an independent theta a session (RDM) or the
    time-GP prior (GP), with the affine moves: TestGewekeRegimes'
    test_rdm_conjugate and test_gp_conjugate."""
    assert JConfig(n=5, m=3, horizon=2, theta_ls=ls).theta_regime == regime
    _run_geweke_sweep(5, 3, 3, "auto", H=2, ls=ls, **AFFINE)


@pytest.mark.slow
def test_geweke_tempered():
    """TestGewekeTempered: the tempered model (noise sd sqrt(T), T = 2.5)
    in every block, the affine moves' z-marginal with its T included."""
    _run_geweke_sweep(6, 3, 3, "auto", temp=2.5, **AFFINE)


@pytest.mark.slow
def test_geweke_conjugate_masked():
    """TestGewekeConjugate: the y-marginal cutpoint ESS at C = 3 with
    missing cells, the affine moves on."""
    _run_geweke_sweep(6, 3, 3, "ess", mask=_mask(42, 6, 3, keep=0.4), **AFFINE)


@pytest.mark.slow
def test_geweke_binary_collapsed():
    """TestGewekeBinaryCollapsed: the exact collapsed cutpoint draw at
    C = 2 with missing cells, the affine moves on."""
    _run_geweke_sweep(6, 3, 2, "collapsed", mask=_mask(7, 6, 3), **AFFINE)


@pytest.mark.slow
@pytest.mark.parametrize("C, f_method, seed, masked", [(2, "conjugate", 0, True),
                                                       (3, "grid", 5, False)])
def test_geweke_threshold_shift(C, f_method, seed, masked):
    """TestGewekeThresholdShift: the (cutpoints, beta0) shift on the binary
    conjugate path with missing cells and the ordinal grid path."""
    _run_geweke_sweep(6, 3, C, "auto", seed=seed, mask=_mask(11, 6, 3) if masked else None,
                      f_method=f_method, threshold_shift=True)


@pytest.mark.slow
def test_geweke_theta_ess():
    """The reference code's ESS theta update, at the binary ESS oracle's
    sizes and missing cells."""
    _run_geweke_sweep(6, 3, 2, "ess", mask=_mask(11, 6, 3), theta_method="ess")


@pytest.mark.slow
def test_geweke_two_stage():
    """The two-stage sweep (ESS on f, Matheron's f* | f, ESS on beta, the
    ordinal cutpoint ESS): TestGewekeTwoStage's sizes (tests/test_geweke.py)."""
    _run_geweke_sweep(6, 3, 3, "auto", f_method="two_stage")


@pytest.mark.slow
@pytest.mark.parametrize("C, method, f_method, seed", [
    (3, "auto", "grid", 0), (3, "auto", "conjugate", 5), (2, "auto", "grid", 3),
    (2, "newton", "grid", 3), (3, "newton", "grid", 3),
])
def test_geweke_constant_irf(C, method, f_method, seed):
    """One IRF shared by two sessions: tests/test_geweke.py's
    test_constant_irf_grid, test_constant_irf_conjugate (the pooled f* | z),
    test_binary_ess_constant_irf (the pooled binary ESS, the kernel's plain
    version on one session of 2 n sites), test_binary_newton_constant_irf
    and test_ordinal_newton_constant_irf, at their sizes and seeds."""
    _run_geweke_sweep(5, 3, C, method, seed=seed, H=2, f_method=f_method,
                      constant_IRF=True)


@pytest.mark.parametrize("C, method", [(3, "ess"), (5, "newton")])
def test_successive_conditional_smoke(C, method):
    """200 sweeps of the chain above: finite statistics and finite,
    strictly increasing cutpoints at every sweep."""
    sc, thr, _ = _chain(6, 3, C, method, 200, mask=_mask(42, 6, 3))
    assert np.isfinite(sc).all()
    t = thr[..., 1:-1]
    assert np.isfinite(t).all() and (np.diff(t, axis=-1) > 0).all()
    assert np.std(t[:, :, :, 0], axis=0).min() > 0  # every cutpoint moves


def test_successive_conditional_smoke_gp():
    """200 sweeps of the chain in the GP regime over two sessions: finite
    statistics and finite, strictly increasing cutpoints that move."""
    sc, thr, _ = _chain(5, 3, 3, "auto", 200, H=2, ls=1.0)
    assert np.isfinite(sc).all()
    t = thr[..., 1:-1]
    assert np.isfinite(t).all() and (np.diff(t, axis=-1) > 0).all()
    assert np.std(t[:, :, :, 0], axis=0).min() > 0


@pytest.mark.parametrize("C, fstar_method", [(2, "matheron"), (3, "chol")])
def test_successive_conditional_smoke_two_stage(C, fstar_method):
    """200 sweeps of the chain with the two-stage sampler, binary (the
    cutpoint ESS's plain version) and ordinal: finite statistics and finite,
    strictly increasing cutpoints that move."""
    sc, thr, _ = _chain(6, 3, C, "auto", 200, mask=_mask(42, 6, 3), f_method="two_stage",
                        fstar_method=fstar_method)
    assert np.isfinite(sc).all()
    t = thr[..., 1:-1]
    assert np.isfinite(t).all() and (np.diff(t, axis=-1) > 0).all()
    assert np.std(t[:, :, :, 0], axis=0).min() > 0


@pytest.mark.parametrize("C, f_method", [(2, "grid"), (3, "conjugate")])
def test_successive_conditional_smoke_constant_irf(C, f_method):
    """200 sweeps of the chain with one IRF shared by two sessions: finite
    statistics, one cutpoint vector for the sessions, finite, strictly
    increasing and moving."""
    sc, thr, _ = _chain(5, 3, C, "auto", 200, H=2, f_method=f_method, constant_IRF=True)
    assert np.isfinite(sc).all()
    t = thr[..., 1:-1]
    assert np.isfinite(t).all() and (np.diff(t, axis=-1) > 0).all()
    np.testing.assert_array_equal(t[:, 0], t[:, 1])
    assert np.std(t[:, 0, :, 0], axis=0).min() > 0


def test_successive_conditional_smoke_affine_collapsed():
    """200 sweeps of the chain with the affine moves and the collapsed
    cutpoint draw (C = 2, missing cells): finite statistics and finite
    cutpoints that move; theta moves collectively."""
    sc, thr, _ = _chain(6, 3, 2, "collapsed", 200, mask=_mask(7, 6, 3), **AFFINE)
    assert np.isfinite(sc).all()
    t = thr[..., 1]
    assert np.isfinite(t).all() and np.std(t, axis=0).min() > 0
    assert np.std(sc[:, 0]) > 0
