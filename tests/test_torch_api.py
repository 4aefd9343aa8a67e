"""The port's public surface: import isolation, slice guards, precision
settings, parameter conversion, the entry points' positional parameters,
gpirt_mcmc's output layout and its tempered runs."""

import inspect
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gpirt_tpu.api import default_thresholds as j_default_thresholds
from gpirt_tpu.models import gibbs as jg
from gpirt_tpu.models.config import GPIRTConfig as JConfig
from gpirt_tpu.models.config import make_constants as j_make_constants
from gpirt_tpu_torch import api, gpirt_mcmc
from gpirt_tpu_torch.api import default_thresholds
from gpirt_tpu_torch.convert import constants_from_numpy, state_from_numpy, to_numpy
from gpirt_tpu_torch.models import gibbs
from gpirt_tpu_torch.models.config import GPIRTConfig


def test_import_pulls_in_neither_jax_nor_reference():
    code = ("import sys, gpirt_tpu_torch, gpirt_tpu_torch.convert, "
            "gpirt_tpu_torch.campaigns, gpirt_tpu_torch.parallel.tempering, "
            "gpirt_tpu_torch.parallel.smc, gpirt_tpu_torch.utils.diagnostics, "
            "gpirt_tpu_torch.models.affine, gpirt_tpu_torch.ops.ess; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'gpirt_tpu' or m.startswith('gpirt_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("kw", [
    dict(checkpoint_path="run"), dict(mesh=object()), dict(item_axis="items"),
    dict(respondent_axis="resp"),
])
def test_config_outside_slice_raises(kw):
    """What the port has not taken yet (checkpointing, the mesh and its
    sharded sweeps) is refused by name, before any work."""
    with pytest.raises(NotImplementedError, match="not ported.*" + next(iter(kw))):
        gpirt_mcmc(_votes(), 2, 1, device="cpu", **kw)


@pytest.mark.parametrize("kw, method", [
    ({}, "conjugate"), (dict(f_method="conjugate", threshold_method="ess"), "conjugate"),
    (dict(f_method="two_stage", fstar_method="chol"), "two_stage"),
    (dict(horizon=2, constant_IRF=True), "grid"), (dict(constant_IRF=True), "grid"),
    (dict(f_method="grid"), "grid"),
    (dict(f_method="two_stage", horizon=2, constant_IRF=True), "two_stage"),
    (dict(threshold_method="collapsed"), "conjugate"),
    (dict(threshold_method="interleave"), "conjugate"),
    (dict(theta_method="ess"), "conjugate"),
    (dict(horizon=3, theta_method="ess"), "conjugate"),
])
def test_config_in_slice_accepted_and_validated(kw, method):
    """Each configuration runs, its f-method, theta method and cutpoint
    method resolved as the JAX package resolves them (constant_IRF's "auto"
    is the grid sampler)."""
    cfg = GPIRTConfig(n=5, m=4, **kw)
    jcfg = JConfig(n=5, m=4, **kw)
    assert cfg.grid_step == 0.01
    assert cfg.resolved_f_method == jcfg.resolved_f_method == method
    assert cfg.theta_method == jcfg.theta_method
    assert cfg.resolved_threshold_method == jcfg.resolved_threshold_method
    with pytest.raises(ValueError):
        GPIRTConfig(n=0, m=4, **kw)


@pytest.mark.parametrize("kw, method", [
    (dict(C=3), "ess"),
    (dict(threshold_method="newton"), "newton"),
    (dict(C=5, threshold_method="newton", threshold_mh_tries=3), "newton"),
    (dict(C=5, threshold_method="ess", f_method="conjugate"), "ess"),
])
def test_config_ordinal_and_newton_in_slice(kw, method):
    """C > 2 and threshold_method="newton" are in the slice; "auto"
    resolves to the ESS, as in the JAX package on the conjugate path."""
    cfg = GPIRTConfig(n=5, m=4, **kw)
    assert cfg.resolved_threshold_method == method
    assert JConfig(n=5, m=4, **kw).resolved_threshold_method == method
    with pytest.raises(ValueError, match="threshold_mh_tries"):
        GPIRTConfig(n=5, m=4, **dict(kw, threshold_mh_tries=0))


def _votes(n=10, m=6, seed=0):
    rng = np.random.default_rng(seed)
    p = 1 / (1 + np.exp(-np.outer(np.linspace(-2, 2, n), rng.standard_normal(m) * 2)))
    v = np.where(rng.random((n, m)) < p, 1.0, 6.0)  # Voteview yea / nay
    v[rng.random((n, m)) < 0.1] = 9.0  # abstention -> missing
    return v


def test_gpirt_mcmc_layout_and_precision_flags():
    """Reference layout of every chain dict, finite draws; the entry point
    turns TF32 off for every float32 product."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    out = gpirt_mcmc(_votes(), sample_iterations=6, burn_iterations=2, CHAIN=2,
                     SEED=3, smc_steps=4, smc_max_temp=8.0, dtype="float64",
                     device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    assert len(out) == 2
    for d in out:
        m = d["beta"].shape[2]
        assert d["theta"].shape == (6, 10, 1)
        assert d["beta"].shape == (6, 3, m, 1)
        assert d["threshold"].shape == (6, m, 3, 1)
        assert d["ll"].shape == (6,)
        assert np.isfinite(d["ll"]).all() and np.isfinite(d["theta"]).all()
        assert set(d["seconds"]) == {"smc", "sampling"}


def test_gpirt_mcmc_hands_the_kernel_contiguous_tensors(monkeypatch):
    """The cutpoint kernel takes only contiguous tensors: every tensor the
    sweep passes its wrapper is, from data given in either memory order."""
    seen = []
    wrapper = gibbs.binary_threshold_ess

    def observe(*args):
        seen.append(all(a.is_contiguous() for a in args if torch.is_tensor(a)))
        return wrapper(*args)

    monkeypatch.setattr(gibbs, "binary_threshold_ess", observe)
    for votes in (_votes(), np.asfortranarray(_votes())):
        gpirt_mcmc(votes, 2, 1, CHAIN=2, smc_steps=2, dtype="float64", device="cpu")
    assert len(seen) == 2 * (8 + 1 + 3) and all(seen)


def test_gpirt_mcmc_guards():
    """JAX's guards: tempering with SMC is a ValueError (before any work),
    tempering under the two-stage sampler is not implemented. constant_IRF
    runs, in the JAX layout, one f* and cutpoint vector for the sessions."""
    with pytest.raises(ValueError, match="mutually exclusive"):
        gpirt_mcmc(_votes(), 2, 1, n_temps=2, smc_steps=4, device="cpu")
    with pytest.raises(NotImplementedError, match="conjugate"):
        gpirt_mcmc(_votes(), 2, 1, n_temps=2, f_method="two_stage", dtype="float64",
                   grid_size=101, device="cpu")
    multi = np.random.default_rng(1).integers(1, 4, (8, 5, 2)).astype(float)
    d = gpirt_mcmc(multi, 2, 1, vote_codes=None, constant_IRF=1, store_fstar=True,
                   dtype="float64", grid_size=101, device="cpu", verbose=False)[0]
    assert d["theta"].shape == (2, 8, 2) and d["threshold"].shape == (2, 5, 4, 2)
    assert d["fstar"].shape == (2, 101, 5, 2) and d["beta"].shape == (2, 3, 5, 2)
    np.testing.assert_array_equal(d["threshold"][..., 0], d["threshold"][..., 1])
    np.testing.assert_allclose(d["fstar"][..., 0], d["fstar"][..., 1])


def _positional(fn):
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind == inspect.Parameter.POSITIONAL_OR_KEYWORD]


def test_positional_parameters_are_the_references():
    """A call written for the JAX package binds its positional arguments to
    the same parameters in the port (gpirt_mcmc's end ``theta_init,
    thresholds, SEED, constant_IRF, store_f, store_fstar``)."""
    from gpirt_tpu import api as japi
    from gpirt_tpu import campaigns as jcampaigns
    from gpirt_tpu_torch import api as tapi
    from gpirt_tpu_torch import campaigns as tcampaigns

    for name in ("gpirt_mcmc", "recover_fstar", "recover_fstar_batch"):
        assert _positional(getattr(tapi, name)) == _positional(getattr(japi, name)), name
    assert (_positional(tcampaigns.gpirt_campaigns)
            == _positional(jcampaigns.gpirt_campaigns))
    assert _positional(tapi.gpirt_mcmc)[-6:] == [
        "theta_init", "thresholds", "SEED", "constant_IRF", "store_f", "store_fstar"]


def test_gpirt_mcmc_takes_the_references_positional_call():
    """Cutpoints, SEED and store_f passed by position land where the JAX
    package puts them."""
    v = _votes()
    thr = np.array([-np.inf, 0.4, np.inf])
    args = (v, 3, 1, 1, 2, api.DEFAULT_VOTE_CODES, None, None, None, None, 1.0, 10.0,
            "Matern", None, thr, 5, 0, True)
    pos = gpirt_mcmc(*args, dtype="float64", grid_size=101, device="cpu", verbose=False)
    kw = gpirt_mcmc(v, 3, 1, CHAIN=2, thresholds=thr, SEED=5, store_f=True,
                    dtype="float64", grid_size=101, device="cpu", verbose=False)
    for a, b in zip(pos, kw):
        assert "f" in a
        for k in ("theta", "beta", "threshold", "ll", "f"):
            np.testing.assert_array_equal(a[k], b[k])
    shared = gpirt_mcmc(*args[:16], 1, dtype="float64", grid_size=101, device="cpu",
                        verbose=False)  # constant_IRF by position: one session
    for a, b in zip(shared, kw):
        assert all(a[k].shape == b[k].shape for k in ("theta", "beta", "threshold", "ll"))
        assert np.isfinite(a["ll"]).all() and np.isfinite(a["theta"]).all()


def test_load_sdo_with_names_matches():
    from gpirt_tpu.utils.datasets import load_sdo as j_load_sdo
    from gpirt_tpu_torch.utils.datasets import load_sdo

    mat, names = load_sdo(with_names=True)
    j_mat, j_names = j_load_sdo(with_names=True)
    np.testing.assert_array_equal(mat, j_mat)
    assert names == j_names and len(names) == mat.shape[1] == 16
    np.testing.assert_array_equal(load_sdo(), mat)


def test_gpirt_mcmc_tempered_layout():
    """n_temps > 1: the cold lanes' draws in the reference layout, each
    chain dict carrying the ensemble's swap rate by rung."""
    out = gpirt_mcmc(_votes(), 6, 2, CHAIN=2, n_temps=3, max_temp=4.0, swap_every=1,
                     dtype="float64", grid_size=101, device="cpu", verbose=False)
    assert len(out) == 2
    for d in out:
        m = d["beta"].shape[2]
        assert d["theta"].shape == (6, 10, 1) and d["threshold"].shape == (6, m, 3, 1)
        assert d["ll"].shape == (6,) and np.isfinite(d["ll"]).all()
        assert d["swap_rate"].shape == (2,)
        np.testing.assert_array_equal(d["swap_rate"], out[0]["swap_rate"])
    assert "swap_rate" not in gpirt_mcmc(_votes(), 2, 1, CHAIN=2, dtype="float64",
                                         grid_size=101, device="cpu", verbose=False)[0]


def test_gpirt_mcmc_defaults_to_the_card_and_never_falls_back(monkeypatch):
    """With no ``device`` the run is on CUDA; without a card that raises,
    naming CUDA, rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gpirt_mcmc(_votes(), 2, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        gpirt_mcmc(_votes(), 2, 1, device="cuda")


@pytest.mark.parametrize("C", [2, 3])
def test_default_thresholds_match(C):
    np.testing.assert_allclose(default_thresholds(C, 4, 1),
                               j_default_thresholds(C, 4, 1), rtol=1e-14)


def test_convert_round_trips():
    """One session, and H = 3 in the GP regime, whose constants carry the
    time-GP factor and precision (None outside it); the SE Gram the
    Woodbury factorisation gathers from comes across with the rest."""
    n, m, N, K = 6, 4, 31, 2
    for H, ls in ((1, 10.0), (3, 2.0)):
        jcfg = JConfig(n=n, m=m, horizon=H, grid_size=N, dtype="float64",
                       theta_ls=ls)
        jconsts = j_make_constants(jcfg, np.zeros((3, m)), np.full((3, m), 2.0),
                                   np.zeros((2, n)), np.ones((2, n)))
        consts = constants_from_numpy(jconsts, device="cpu", dtype=torch.float64)
        assert (consts.Lambda_time is None) == (H == 1)
        np.testing.assert_array_equal(consts.grid_gram_se.numpy(),
                                      np.asarray(jconsts.grid_gram_se))
        for name, a in to_numpy(consts).items():
            if a is None:
                assert getattr(jconsts, name) is None
            else:
                np.testing.assert_array_equal(a, np.asarray(getattr(jconsts, name)))
        again = constants_from_numpy(to_numpy(consts), device="cpu",
                                     dtype=torch.float64)
        assert (again.L_time is None) == (H == 1)
        keys = jax.random.split(jax.random.key(0), K)
        y = np.ones((H, n, m), np.int32)
        thr = default_thresholds(2, m, H)
        jstate = jax.vmap(lambda k: jg.init_state(k, np.zeros((H, n)), thr, y,
                                                  jconsts, jcfg))(keys)
        state = state_from_numpy(jstate, device="cpu", dtype=torch.float64)
        assert state.theta_idx.dtype == torch.int64
        for name, a in to_numpy(state).items():
            np.testing.assert_array_equal(a, np.asarray(getattr(jstate, name)))
        again = state_from_numpy(to_numpy(state), device="cpu", dtype=torch.float64)
        assert all(torch.equal(a, b) for a, b in zip(again, state))
