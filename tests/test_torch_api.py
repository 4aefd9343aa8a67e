"""The port's public surface: import isolation, slice guards, precision
settings, parameter conversion and gpirt_mcmc's output layout."""

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
from gpirt_tpu_torch import gpirt_mcmc
from gpirt_tpu_torch.api import default_thresholds
from gpirt_tpu_torch.convert import constants_from_numpy, state_from_numpy, to_numpy
from gpirt_tpu_torch.models.config import GPIRTConfig


def test_import_pulls_in_neither_jax_nor_reference():
    code = ("import sys, gpirt_tpu_torch, gpirt_tpu_torch.convert; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'gpirt_tpu' or m.startswith('gpirt_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("kw", [
    dict(C=3), dict(horizon=2), dict(constant_IRF=True), dict(f_method="grid"),
    dict(f_method="two_stage"), dict(threshold_method="newton"),
    dict(threshold_method="collapsed"), dict(theta_method="ess"),
])
def test_config_outside_slice_raises(kw):
    with pytest.raises(NotImplementedError, match="not ported"):
        GPIRTConfig(n=5, m=4, **kw)


def test_config_in_slice_accepted_and_validated():
    for kw in ({}, dict(f_method="conjugate", threshold_method="ess")):
        assert GPIRTConfig(n=5, m=4, **kw).grid_step == 0.01
    with pytest.raises(ValueError):
        GPIRTConfig(n=0, m=4)


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


def test_gpirt_mcmc_guards():
    with pytest.raises(NotImplementedError, match="store_f"):
        gpirt_mcmc(_votes(), 2, 1, store_f=True, device="cpu")
    with pytest.raises(TypeError):
        gpirt_mcmc(_votes(), 2, 1)  # no silent default device
    ordinal = np.random.default_rng(1).integers(1, 4, (8, 5)).astype(float)
    with pytest.raises(NotImplementedError, match="C=3"):
        gpirt_mcmc(ordinal, 2, 1, vote_codes=None, device="cpu")


@pytest.mark.parametrize("C", [2, 3])
def test_default_thresholds_match(C):
    np.testing.assert_allclose(default_thresholds(C, 4, 1),
                               j_default_thresholds(C, 4, 1), rtol=1e-14)


def test_convert_round_trips():
    n, m, N, K = 6, 4, 31, 2
    jcfg = JConfig(n=n, m=m, grid_size=N, dtype="float64")
    jconsts = j_make_constants(jcfg, np.zeros((3, m)), np.full((3, m), 2.0),
                               np.zeros((2, n)), np.ones((2, n)))
    consts = constants_from_numpy(jconsts, device="cpu", dtype=torch.float64)
    for name, a in to_numpy(consts).items():
        np.testing.assert_array_equal(a, np.asarray(getattr(jconsts, name)))
    keys = jax.random.split(jax.random.key(0), K)
    y = np.ones((1, n, m), np.int32)
    thr = default_thresholds(2, m, 1)
    jstate = jax.vmap(lambda k: jg.init_state(k, np.zeros((1, n)), thr, y,
                                              jconsts, jcfg))(keys)
    state = state_from_numpy(jstate, device="cpu", dtype=torch.float64)
    assert state.theta_idx.dtype == torch.int64
    for name, a in to_numpy(state).items():
        np.testing.assert_array_equal(a, np.asarray(getattr(jstate, name)))
    again = state_from_numpy(to_numpy(state), device="cpu", dtype=torch.float64)
    assert all(torch.equal(a, b) for a, b in zip(again, state))
