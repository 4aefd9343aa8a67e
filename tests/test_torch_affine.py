"""The port's collective affine theta moves (gpirt_tpu_torch/models/affine.py)
against the JAX package: the dense Woodbury factorisation of B = K(theta) +
T I, the z-marginal pieces, the dilation's interval log q, the compensated
shift map, the shift-orbit draw and the whole moves, one temperature for
every chain or one a chain; three sweeps with the moves on; an SMC anneal
replayed under interleaved cutpoints with the moves; and the mechanics
tests of tests/test_affine.py (interval log q, the irreversible collapse,
the delta against the direct difference, Woodbury against a dense solve,
output on the grid).

The setups and the replay of JAX's draws are tests/test_torch_sampler_options.py's
(its module docstring); the orbit's draws are ``k_pick, k_acc =
split(k_shift)``, the pick's uniforms (1, 2W+1) and the accept's one; a
dilation round's ``k_d, k_du = split(k)``, a normal and a uniform.
Tolerances: theta indices exactly, rtol 1e-10 a block, 1e-8 after three
sweeps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpirt_tpu.models import gibbs as jg
from gpirt_tpu.parallel.smc import anneal_init as j_anneal_init
from gpirt_tpu_torch.models import affine
from gpirt_tpu_torch.models import gibbs as tg
from gpirt_tpu_torch.ops.kernels import icc_gram_np
from gpirt_tpu_torch.parallel import smc
from test_torch_constant_irf import _F64, H, K, N, _close, _lane, _t, m, n
from test_torch_sampler_options import _affine, _sweep, setup_for, three_sweeps

TEMPS = np.array([1.0, 3.5])  # one temperature a chain
W, R = 5, 2  # JAX's Geweke setting: affine_shift_max=5, affine_rounds=2


def _temp_args(temp):
    """(the port's temp, JAX's per-chain temperatures or None)."""
    if temp is None:
        return None, None
    if temp == "chains":
        return _t(TEMPS), jnp.asarray(TEMPS)
    return temp, jnp.full(K, temp, _F64)


def _vmap(fn, *args, temps=None):
    """A JAX block vmapped over the chains, each with its temperature."""
    if temps is None:
        return jax.vmap(lambda *a: fn(*a, None))(*args)
    return jax.vmap(fn)(*args, temps)


def _inputs(s, seed=0):
    """A state's theta indices and beta, and latents z near its means."""
    rng = np.random.default_rng(seed)
    st = s["state"]
    mu = tg.compute_mu(tg.theta_from_indices(st.theta_idx, s["consts"]), st.beta)
    z = st.f + mu + _t(rng.standard_normal((K, H, n, m)))
    return st.theta_idx, z, st.beta


def _j(a):
    return jnp.asarray(np.asarray(a))


# ---------------------------------------------------------------------------
# the Woodbury family and the z-marginal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("temp", [None, 2.5, "chains"])
def test_woodbury_matches(temp):
    s = setup_for("RDM", 2)
    idx, z, _ = _inputs(s)
    t_port, t_jax = _temp_args(temp)
    r = _t(np.random.default_rng(1).standard_normal((K, H, n, m)))
    want = _vmap(lambda i, t: jg.woodbury_factors(i, s["jconsts"], t), _j(idx), temps=t_jax)
    got = affine.woodbury_factors(idx, s["consts"], t_port)
    for name in got._fields:
        _close(getattr(got, name), getattr(want, name))
    _close(affine.woodbury_solve(got, r),
           jax.vmap(jg.woodbury_solve)(want, _j(r)))
    for a, b in zip(affine.woodbury_quad_parts(got, r),
                    jax.vmap(jg.woodbury_quad_parts)(want, _j(r))):
        _close(a, b)


@pytest.mark.parametrize("regime", ["CST", "RDM", "GP"])
def test_z_marginal_pieces_match(regime):
    """_theta_logprior_total, _z_marginal_parts and _z_marginal_delta (with
    one temperature a chain), _beta_shift_map and _beta_logprior_delta."""
    s = setup_for(regime, 2)
    jc, jcfg, consts, cfg = s["jconsts"], s["jcfg"], s["consts"], s["cfg"]
    idx, z, beta = _inputs(s)
    theta = tg.theta_from_indices(idx, consts)
    _close(affine._theta_logprior_total(theta, consts, cfg),
           jax.vmap(lambda th: jg._theta_logprior_total(th, jc, jcfg))(_j(theta)))
    t_port, t_jax = _temp_args("chains")
    idx2 = torch.clamp(idx + 3, 0, N - 1)
    parts = [affine._z_marginal_parts(i, z, beta, consts, cfg, t_port) for i in (idx, idx2)]
    jparts = [jax.vmap(lambda i, zz, b, t: jg._z_marginal_parts(i, zz, b, jc, jcfg, t))(
        _j(i), _j(z), _j(beta), t_jax) for i in (idx, idx2)]
    for got, want in zip(parts, jparts):
        for a, b in zip(got, want):
            _close(a, b)
    _close(affine._z_marginal_delta(*parts), jax.vmap(jg._z_marginal_delta)(*jparts))
    delta = _t([0.07, -0.13])
    shifted = affine._beta_shift_map(beta, delta.reshape(-1, 1, 1))
    _close(shifted, jax.vmap(jg._beta_shift_map)(_j(beta), _j(delta)))
    _close(affine._beta_logprior_delta(shifted, beta, consts),
           jax.vmap(lambda a, b: jg._beta_logprior_delta(a, b, jc))(_j(shifted), _j(beta)))


def test_dilation_interval_logq_matches():
    """Random centred indices and their rounded dilations, sites at the
    centre (reachable or not), a dilation off the grid."""
    rng = np.random.default_rng(4)
    cen, sd = 50.0, 0.05
    d = rng.integers(-45, 46, (4, H, n)).astype(float)
    d[1, 0, :3] = 0.0
    a = np.exp(rng.normal(0, sd, (4, 1, 1)))
    dp = np.round(cen + a * d) - cen
    dp[2, 1, 4] += 1.0  # off the image: an empty interval
    dp[3, 0, 0] = 0.0
    d[3, 0, 0] = 0.0
    for x, xp in ((d, dp), (dp, d)):
        got = affine._dilation_interval_logq(_t(x), _t(xp), sd)
        want = jax.vmap(lambda u, v: jg._dilation_interval_logq(u, v, sd))(_j(x), _j(xp))
        np.testing.assert_array_equal(np.isfinite(got.numpy()), np.isfinite(np.asarray(want)))
        _close(got[torch.isfinite(got)], np.asarray(want)[np.isfinite(np.asarray(want))])


# ---------------------------------------------------------------------------
# the moves
# ---------------------------------------------------------------------------


def _move_draws(s, keys):
    return smc._cat_lanes([_affine(k, s["cfg"]) for k in keys])


@pytest.mark.parametrize("temp", [None, "chains"])
@pytest.mark.parametrize("regime", ["CST", "RDM", "GP"])
def test_shift_orbit_gibbs_matches(regime, temp):
    s = setup_for(regime, 2, affine_shift_max=W)
    jc, jcfg = s["jconsts"], s["jcfg"]
    idx, z, beta = _inputs(s, 2)
    t_port, t_jax = _temp_args(temp)
    keys = jax.random.split(jax.random.key(41), K)
    k_shift = jax.vmap(lambda k: jax.random.split(k)[0])(keys)
    want = _vmap(lambda k, i, zz, b, t: jg.shift_orbit_gibbs(k, i, zz, b, jc, jcfg, t),
                 k_shift, _j(idx), _j(z), _j(beta), temps=t_jax)
    d = _move_draws(s, keys)
    got = affine.shift_orbit_gibbs(idx, z, beta, s["consts"], s["cfg"], d.u_pick, d.u_acc,
                                   t_port)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close(got[1], want[1])


@pytest.mark.parametrize("temp", [None, 2.5, "chains"])
@pytest.mark.parametrize("regime", ["CST", "RDM", "GP"])
def test_affine_theta_moves_match(regime, temp):
    """The orbit draw then two dilation rounds (a wide sd so that rounds
    accept and reject)."""
    s = setup_for(regime, 2, affine_shift_max=W, affine_rounds=R, affine_dilate_sd=0.05)
    jc, jcfg = s["jconsts"], s["jcfg"]
    idx, z, beta = _inputs(s, 3)
    t_port, t_jax = _temp_args(temp)
    keys = jax.random.split(jax.random.key(43), K)
    want = _vmap(lambda k, i, zz, b, t: jg.affine_theta_moves(k, i, zz, b, jc, jcfg, t),
                 keys, _j(idx), _j(z), _j(beta), temps=t_jax)
    got = affine.affine_theta_moves(idx, z, beta, s["consts"], s["cfg"],
                                    _move_draws(s, keys), t_port)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close(got[1], want[1])


@pytest.mark.parametrize("kw", [dict(affine_shift_max=W), dict(affine_rounds=R)])
def test_each_move_alone_matches(kw):
    """The orbit alone (no dilation draws) and the dilations alone (no
    orbit draws)."""
    s = setup_for("CST", 2, **kw)
    idx, z, beta = _inputs(s, 5)
    keys = jax.random.split(jax.random.key(45), K)
    want = jax.vmap(lambda k, i, zz, b: jg.affine_theta_moves(
        k, i, zz, b, s["jconsts"], s["jcfg"]))(keys, _j(idx), _j(z), _j(beta))
    d = _move_draws(s, keys)
    assert (d.u_pick is None) == ("affine_shift_max" not in kw)
    assert (d.ell is None) == ("affine_rounds" not in kw)
    got = affine.affine_theta_moves(idx, z, beta, s["consts"], s["cfg"], d)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close(got[1], want[1])


@pytest.mark.parametrize("temps", [None, TEMPS])
@pytest.mark.parametrize("regime, C", [("CST", 2), ("RDM", 3), ("GP", 2)])
def test_three_sweeps_with_affine_moves(regime, C, temps):
    """JAX's Geweke setting, at T = 1 and with one temperature a chain
    against jax.vmap(gibbs_sweep) over the chains and their temperatures;
    the moves' counters count."""
    affine.counts.update(calls=0, orbit_accepted=0)
    three_sweeps(setup_for(regime, C, affine_shift_max=W, affine_rounds=R), temps)
    assert affine.counts["calls"] == 3
    assert 0 < int(affine.counts["orbit_accepted"]) <= 3 * K


def test_anneal_init_replayed_under_interleave_and_affine(monkeypatch):
    """anneal_init with interleaved cutpoints (k = 2) and the affine moves
    against JAX's given the same draws: the step ids (warm prologue
    n_steps + 1.., then 1..n_steps - 1) pick each step's cutpoint update
    in both packages."""
    Ka, steps, t_max = 3, 3, 8.0
    s = setup_for("CST", 2, threshold_method="interleave", threshold_ess_every=2,
                  affine_shift_max=W, affine_rounds=R)
    keys = jax.random.split(jax.random.key(31), Ka)
    theta_init = np.random.default_rng(4).uniform(-1, 1, (Ka, H, n))
    want, jinfo = j_anneal_init(keys, jnp.asarray(s["y"]), theta_init, s["thr_init"],
                                s["jconsts"], s["jcfg"], n_steps=steps, max_temp=t_max)
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
    sweeps = [smc._cat_lanes([_sweep(jax.random.fold_in(jax.random.fold_in(k_run[c], i), 0),
                                     s["cfg"], i) for c in range(Ka)]) for i in ids]
    assert {type(d.cut) for d in sweeps} == {tg.ESSDraws, tg.CollapsedDraws}
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


# ---------------------------------------------------------------------------
# the mechanics of tests/test_affine.py, on the port
# ---------------------------------------------------------------------------


def test_forward_interval_contains_realized_factor():
    """For idx' = round(cen + a (idx - cen)) on the grid, log q of the
    forward move is finite and at most 0."""
    rng = np.random.default_rng(0)
    cen, sd = 50.0, 0.1
    for _ in range(50):
        idx = rng.integers(5, 96, size=(1, 1, 8))
        a = float(np.exp(rng.normal(0, sd)))
        d = idx.astype(float) - cen
        idxp = np.round(cen + a * d)
        if ((idxp < 0) | (idxp > 100)).any():
            continue
        lq = float(affine._dilation_interval_logq(_t(d), _t(idxp - cen), sd)[0])
        assert np.isfinite(lq) and lq <= 1e-9


def test_collapse_onto_center_is_irreversible():
    d = _t([[[4.0, -3.0, 0.0]]])
    assert float(affine._dilation_interval_logq(torch.zeros_like(d), d, 0.1)[0]) == -np.inf


def _dense_log_post(idx, z, beta, consts, cfg, temp):
    """log p(theta) + log p(z | theta, beta) with f* marginalised, densely
    in float64 (numpy), a chain at a time."""
    out = []
    grid = consts.grid.numpy()
    sds = consts.beta_prior_sds[:, 0].numpy()
    for k in range(idx.shape[0]):
        total = float(affine._theta_logprior_total(
            consts.grid[idx[k:k + 1]], consts, cfg)[0])
        for h in range(idx.shape[1]):
            th = grid[idx[k, h].numpy()]
            B = icc_gram_np(th, th, sds) + temp * np.eye(len(th))
            r = z[k, h].numpy() - (np.stack([np.ones_like(th), th, th * th], -1)
                                   @ beta[k, h].numpy())
            total += -0.5 * np.sum(r * np.linalg.solve(B, r)) \
                - 0.5 * r.shape[1] * np.linalg.slogdet(B)[1]
        out.append(total)
    return np.array(out)


@pytest.mark.parametrize("regime", ["CST", "GP"])
def test_delta_matches_direct_difference(regime):
    """_z_marginal_delta between two states equals the difference of the
    dense log-densities (T = 2), and is antisymmetric."""
    s = setup_for(regime, 2)
    idx, z, beta = _inputs(s, 6)
    idx2 = torch.clamp(idx + 7, 0, N - 1)
    p0, p1 = (affine._z_marginal_parts(i, z, beta, s["consts"], s["cfg"], 2.0)
              for i in (idx, idx2))
    d01 = affine._z_marginal_delta(p1, p0)
    _close(d01, -affine._z_marginal_delta(p0, p1))
    direct = (_dense_log_post(idx2, z, beta, s["consts"], s["cfg"], 2.0)
              - _dense_log_post(idx, z, beta, s["consts"], s["cfg"], 2.0))
    np.testing.assert_allclose(d01.numpy(), direct, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("temp", [None, 2.5])
def test_woodbury_matches_dense(temp):
    """B^{-1} r and logdet B from the rank-3 split against the dense
    K + T I in float64."""
    s = setup_for("RDM", 2)
    consts = s["consts"]
    idx = _t(np.random.default_rng(7).integers(0, N, (K, H, n)), torch.int64)
    r = _t(np.random.default_rng(8).standard_normal((K, H, n, 5)))
    wb = affine.woodbury_factors(idx, consts, temp)
    got = affine.woodbury_solve(wb, r)
    sds = consts.beta_prior_sds[:, 0].numpy()
    for k in range(K):
        for h in range(H):
            th = consts.grid[idx[k, h]].numpy()
            B = icc_gram_np(th, th, sds) + (temp or 1.0) * np.eye(n)
            np.testing.assert_allclose(got[k, h].numpy(), np.linalg.solve(B, r[k, h].numpy()),
                                       rtol=1e-8, atol=1e-10)
            np.testing.assert_allclose(float(wb.logdet[k, h]), np.linalg.slogdet(B)[1],
                                       rtol=1e-10)


def test_output_stays_on_grid():
    """From indices at both grid ends, every move keeps each chain on the
    grid and beta's shape."""
    s = setup_for("CST", 2, affine_shift_max=W, affine_rounds=4, affine_dilate_sd=0.3)
    _, z, beta = _inputs(s, 9)
    idx = _t(np.tile(np.linspace(0, N - 1, n).round(), (K, H, 1)), torch.int64)
    gen = torch.Generator().manual_seed(0)
    for _ in range(5):
        d = tg.sweep_draws(gen, K, s["consts"], s["cfg"]).affine
        idx, beta = affine.affine_theta_moves(idx, z, beta, s["consts"], s["cfg"], d)
        assert int(idx.min()) >= 0 and int(idx.max()) <= N - 1
        assert beta.shape == (K, H, 3, m) and bool(torch.isfinite(beta).all())


def test_config_affine_fields_as_jax():
    cfg = dataclasses.replace(setup_for("CST", 2)["cfg"], affine_rounds=2)
    assert cfg.affine and cfg.affine_dilate_sd == 0.02
