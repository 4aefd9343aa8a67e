"""The port's f* recovery (``recover_fstar`` / ``recover_fstar_batch``)
against the JAX package.

``_recover_one`` of both packages runs in float64 on the CPU from the same
constants and stored draws, the port given the draws JAX makes from its
key: ``k_f, k_fs = split(key)``, draw_f's from k_f and Matheron's f* from
k_fs (tests/test_torch_two_stage.py replays both). f* is held to rtol
1e-10 plus four times the JAX package's own rounding spread, as in that
file. The API is checked on the port alone: shapes as JAX's tests state
them (tests/test_api.py), seeds, the batch against one draw at a time, and
the guards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpirt_tpu.api import _recover_one as j_recover_one
from gpirt_tpu.models.config import GPIRTConfig as JConfig
from gpirt_tpu.models.config import make_constants as j_make_constants
from gpirt_tpu_torch import gpirt_mcmc
from gpirt_tpu_torch.api import (
    _recover_one,
    default_thresholds,
    recover_fstar,
    recover_fstar_batch,
)
from gpirt_tpu_torch.convert import constants_from_numpy
from gpirt_tpu_torch.models import gibbs as tg
from gpirt_tpu_torch.models.config import GPIRTConfig, make_constants
from gpirt_tpu_torch.utils.datasets import simulate_2pl
from gpirt_tpu_torch.utils.response import as_response_matrix, encode_categories
from test_torch_gibbs import _t
from test_torch_two_stage import (
    N,
    _close_spread,
    _f_draws,
    _fstar_draws,
    _jax_spread,
    _port_f,
    _port_fstar,
    _y,
    m,
    n,
)

S = 3
_CODES = {"yea": 1, "nay": 0, "missing": None}


def _stored(H, C, seed=0):
    """S stored draws in the internal layouts, theta off the grid: f
    (S, H, n, m), theta (S, H, n), beta (S, H, 3, m), cutpoints
    (S, H, m, C+1)."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((S, H, n, m))
    theta = rng.uniform(-2.5, 2.5, (S, H, n))
    beta = rng.standard_normal((S, H, 3, m)) * np.array([1.0, 0.7, 0.3])[:, None]
    thr = np.broadcast_to(default_thresholds(C, m, H), (S, H, m, C + 1)).copy()
    thr[..., 1:C] += 0.1 * rng.standard_normal((S, H, m, 1))
    return f, theta, beta, thr


@pytest.mark.parametrize("mean_degree", [1, 2])
@pytest.mark.parametrize("H, C", [(1, 2), (3, 3)])
def test_recover_one_matches(H, C, mean_degree):
    """S draws through _recover_one of both packages, the linear-mean quirk
    (mean_degree = 1 zeroes beta's quadratic row) included."""
    kw = dict(n=n, m=m, horizon=H, C=C, grid_size=N, dtype="float64", jitter=1e-6,
              mean_degree=mean_degree)
    jcfg, cfg = JConfig(**kw), GPIRTConfig(**kw)
    priors = dict(beta_prior_means=np.zeros((3, m)), beta_prior_sds=np.full((3, m), 3.0),
                  theta_prior_means=np.zeros((2, n)), theta_prior_sds=np.zeros((2, n)))
    jconsts = j_make_constants(jcfg, **priors)
    y = _y(C, H, seed=5)
    stored = _stored(H, C, seed=mean_degree + H)
    keys = jax.random.split(jax.random.key(9), S)
    run = jax.jit(lambda c: jax.vmap(lambda k, *a: j_recover_one(
        k, *a, jnp.asarray(y), c, jcfg))(keys, *map(jnp.asarray, stored)))
    want = np.asarray(run(jconsts))

    f_rand, fs_rand = [], []
    for key in keys:
        k_f, k_fs = jax.random.split(key)
        f_rand.append(_f_draws(k_f, H))
        fs_rand.append(_fstar_draws(k_fs, H, "matheron"))
    got = _recover_one(*map(_t, stored), torch.as_tensor(y),
                       constants_from_numpy(jconsts, device="cpu", dtype=torch.float64),
                       cfg, _port_f(f_rand), _port_fstar(fs_rand))
    assert got.shape == (S, H, N, m)
    _close_spread(got, want, *_jax_spread(run, jconsts))


def test_constants_from_numpy_carries_grid_gram():
    jcfg = JConfig(n=n, m=m, grid_size=N, dtype="float64")
    jconsts = j_make_constants(jcfg, beta_prior_means=np.zeros((3, m)),
                               beta_prior_sds=np.full((3, m), 3.0),
                               theta_prior_means=np.zeros((2, n)),
                               theta_prior_sds=np.zeros((2, n)))
    consts = constants_from_numpy(jconsts, device="cpu", dtype=torch.float64)
    assert consts.grid_gram.shape == (N, N)
    np.testing.assert_array_equal(consts.grid_gram.numpy(), np.asarray(jconsts.grid_gram))
    port = make_constants(GPIRTConfig(n=n, m=m, grid_size=N, dtype="float64"),
                          np.zeros((3, m)), np.full((3, m), 3.0), np.zeros((2, n)),
                          np.zeros((2, n)), device="cpu")
    np.testing.assert_allclose(port.grid_gram.numpy(), np.asarray(jconsts.grid_gram),
                               rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# the API (port only, float64 on the CPU)
# ---------------------------------------------------------------------------


def _chain(seed, n_=10, m_=5, S_=3):
    """One chain of the port's sampler with f stored, and the response
    matrix recovery reads."""
    _, y = simulate_2pl(seed, n=n_, m=m_)
    d = gpirt_mcmc(y, S_, 0, vote_codes=_CODES, store_f=True, dtype="float64",
                   grid_size=101, device="cpu")[0]
    return d, np.asarray(as_response_matrix(y, _CODES, verbose=False))


def test_recover_fstar_shapes_seeds_and_mean_degree():
    d, rm = _chain(4)
    args = (d["f"][-1], rm, d["theta"][-1], d["beta"][-1], d["threshold"][-1])
    kw = dict(dtype="float64", grid_size=101, device="cpu")
    rec = recover_fstar(7, *args, **kw)
    assert rec["fstar"].shape == (101, d["beta"].shape[2], 1)
    assert np.isfinite(rec["fstar"]).all()
    assert set(rec["seconds"]) == {"constants", "recovery"}
    np.testing.assert_array_equal(rec["fstar"], recover_fstar(7, *args, **kw)["fstar"])
    assert not np.allclose(rec["fstar"], recover_fstar(8, *args, **kw)["fstar"])
    # the reference's linear mean against the sampler's quadratic one
    assert not np.allclose(rec["fstar"], recover_fstar(7, *args, mean_degree=2, **kw)["fstar"])


def test_recover_fstar_batch_is_one_draw_at_a_time():
    """Every stored draw in one pass equals _recover_one on that draw given
    the batch's own draws (lane s of one generator seeded with the seed)."""
    d, rm = _chain(6)
    S_, n_, m_ = d["f"].shape[:3]
    batch = recover_fstar_batch(9, d, rm, dtype="float64", grid_size=101, device="cpu")
    assert batch.shape == (S_, 101, m_, 1) and np.isfinite(batch).all()
    np.testing.assert_array_equal(
        batch, recover_fstar_batch(9, d, rm, dtype="float64", grid_size=101, device="cpu"))
    assert not np.allclose(
        batch, recover_fstar_batch(10, d, rm, dtype="float64", grid_size=101, device="cpu"))

    cfg = GPIRTConfig(n=n_, m=m_, grid_size=101, dtype="float64", jitter=1e-6,
                      mean_degree=1)
    consts = make_constants(cfg, np.zeros((3, m_)), np.full((3, m_), 3.0),
                            np.zeros((2, n_)), np.zeros((2, n_)), device="cpu")
    gen = torch.Generator().manual_seed(9)
    f_rand, fs_rand = tg.f_draws(gen, S_, consts, cfg), tg.fstar_draws(gen, S_, consts, cfg)
    y, _, _ = encode_categories(rm[:, :, None])
    for s in range(S_):
        lane = slice(s, s + 1)
        one = _recover_one(
            _t(d["f"][lane].transpose(0, 3, 1, 2)), _t(d["theta"][lane].transpose(0, 2, 1)),
            _t(d["beta"][lane].transpose(0, 3, 1, 2)),
            _t(d["threshold"][lane].transpose(0, 3, 1, 2)), torch.as_tensor(y), consts, cfg,
            tg.FDraws(f_rand.z_u[lane], f_rand.z_site[lane], tg.ESSLoopDraws(
                f_rand.ess.logu[lane], f_rand.ess.eps0[lane], f_rand.ess.rs[:, lane])),
            tg.FStarDraws(*(a[lane] for a in fs_rand)))
        np.testing.assert_allclose(batch[s], one[0].numpy().transpose(1, 2, 0),
                                   rtol=1e-9, atol=1e-9)


def test_recover_guards(monkeypatch):
    d, rm = _chain(5, S_=2)
    args = (d["f"][-1], rm, d["theta"][-1], d["beta"][-1], d["threshold"][-1])
    shared = recover_fstar(1, *args, constant_IRF=1, dtype="float64", grid_size=101,
                           device="cpu")["fstar"]  # one session: the JAX layout
    assert shared.shape == (101, d["beta"].shape[2], 1) and np.isfinite(shared).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        recover_fstar(1, *args, dtype="float64", grid_size=101)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        recover_fstar_batch(1, d, rm, dtype="float64", grid_size=101)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpirt_mcmc(rm, 2, 0, vote_codes=None, f_method="two_stage", grid_size=101)
