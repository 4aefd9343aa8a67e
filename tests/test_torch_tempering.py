"""The port's parallel tempering against the JAX package: the sweep with
one temperature a chain (block by block and whole, against
``jax.vmap(gibbs_sweep)`` over the temperatures), the kernel's plain
version with one c a chain, the ladder, the lanes' tempered ll, the swap
phase and the tempered run.

Everything runs in float64 on the CPU from the same constants and state,
the random draws made in JAX from the reference's own key splits (the
replay helpers of tests/test_torch_gibbs.py and tests/test_torch_ordinal.py)
and handed to the port. Tolerances: rtol 1e-10 a block, theta indices
exactly; swap decisions exactly, post-swap ll to 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a process)
from gpirt_tpu.models import gibbs as jg
from gpirt_tpu.models.config import GPIRTConfig as JConfig
from gpirt_tpu.ops.pallas_threshold import (
    PALLAS_THRESHOLD_ROUNDS,
    binary_threshold_ess_pallas,
)
from gpirt_tpu.parallel import tempering as jt
from gpirt_tpu_torch.models import gibbs as tg
from gpirt_tpu_torch.models.config import GPIRTConfig, make_constants
from gpirt_tpu_torch.models.sampler import run_chains
from gpirt_tpu_torch.ops.threshold_ess import binary_threshold_ess_reference
from gpirt_tpu_torch.parallel import tempering
from test_torch_gibbs import H, K, N, _close, _fstar_draws, _t, m, n
from test_torch_ordinal import _port_draws, _sweep_draws, setup_for
from test_torch_threshold_ess import _lanes, _replay_ess_draws

_C = 0.7071067811865476
_TWO_PI = 6.283185307179586
_F64 = jnp.float64
TEMPS = np.array([1.7, 6.0])  # one a chain of the K = 2 chains


@pytest.mark.parametrize("n_temps, max_temp", [(1, 5.0), (2, 4.0), (4, 27.0), (7, 64.0)])
def test_temperature_ladder_matches(n_temps, max_temp):
    np.testing.assert_array_equal(tempering.temperature_ladder(n_temps, max_temp),
                                  jt.temperature_ladder(n_temps, max_temp))


# ---------------------------------------------------------------------------
# the kernel's plain version with one c a chain
# ---------------------------------------------------------------------------


def test_plain_kernel_per_chain_c_equals_vmapped_tempered_xla():
    """Four lanes' chains, each at its own temperature: the plain version
    with c a (K,) tensor against JAX's tempered draw_threshold (its XLA
    path, no two-phase compaction) vmapped over the chains and their
    temperatures, to 1e-10."""
    Kc, Hc, nc, mc = 4, 1, 23, 11
    temps = np.array([1.0, 2.5, 9.0, 64.0])
    g, y, t1, _ = _lanes(3, Kc, Hc, nc, mc)
    cfg = JConfig(n=nc, m=mc, C=2, grid_size=11, dtype="float64",
                  f_method="conjugate", threshold_ess_twophase=False)
    thr = np.stack([np.full((Kc, Hc, mc), -np.inf), t1,
                    np.full((Kc, Hc, mc), np.inf)], axis=-1)
    keys = jax.random.split(jax.random.key(300), Kc)
    want = jax.vmap(lambda k, th, gg, t: jg.draw_threshold(
        k, th, gg, jnp.zeros_like(gg), jnp.asarray(y), cfg, temp=t))(
        keys, jnp.asarray(thr), jnp.asarray(g), jnp.asarray(temps))
    nu, logu, eps0, rs = (np.stack(a) for a in
                          zip(*[_replay_ess_draws(key, Hc, mc) for key in keys]))
    c = _C / torch.sqrt(_t(temps))
    got = binary_threshold_ess_reference(
        _t(g), _t(y, torch.int32), _t(t1), _t(nu), _t(logu), _t(eps0),
        _t(rs).transpose(0, 1).contiguous(), c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[..., 1], rtol=1e-10,
                               atol=1e-12)
    assert np.mean(got.numpy() != t1) > 0.8


@pytest.mark.parametrize("temp", [1.0, 64.0])
def test_plain_kernel_one_shared_c_equals_pallas_interpret(temp):
    """c as a (K,) tensor of one value: bit for bit the float c's result,
    and against the Pallas kernel in interpret mode fed the same uniforms
    (tests/test_torch_threshold_ess.py's tolerance: 1e-10 but for at most 2
    near-tie lanes of 130, the Pallas erf being a polynomial)."""
    Kc, Hc, nc, mc = 2, 1, 37, 65
    L = Kc * Hc * mc
    g, y, t1, nu = _lanes(0, Kc, Hc, nc, mc)
    c = _C / np.sqrt(temp)
    sgn = np.where(y == 1, 1.0, -1.0) * (y > 0)

    def rows(a):
        return jnp.asarray(np.broadcast_to(a, (Kc, Hc, nc, mc))
                           .transpose(2, 0, 1, 3).reshape(nc, L))

    key = jax.random.key(11)
    want = np.asarray(binary_threshold_ess_pallas(
        key, jnp.asarray(t1.reshape(L)), jnp.asarray(nu.reshape(L)), rows(g),
        rows(sgn), rows((y > 0).astype(np.float64)), c, interpret=True))
    k_u, k_eps, k_loop = jax.random.split(key, 3)
    logu = jnp.log(jax.random.uniform(k_u, (L,), dtype=_F64))
    eps0 = jax.random.uniform(k_eps, (L,), dtype=_F64, maxval=_TWO_PI)
    rs = jax.random.uniform(k_loop, (PALLAS_THRESHOLD_ROUNDS, L), dtype=_F64)
    args = (_t(g), _t(y, torch.int32), _t(t1), _t(nu), _t(logu).reshape(Kc, Hc, mc),
            _t(eps0).reshape(Kc, Hc, mc), _t(rs).reshape(-1, Kc, Hc, mc))
    got = binary_threshold_ess_reference(*args, torch.full((Kc,), c, dtype=torch.float64))
    assert torch.equal(got, binary_threshold_ess_reference(*args, c))
    err = np.abs(got.numpy().reshape(L) - want)
    assert np.sum(err > 1e-10) <= 2, np.sort(err)[-5:]


def test_plain_kernel_rejects_a_bad_c():
    g, y, t1, nu = (torch.as_tensor(a) for a in _lanes(0, 2, 1, 5, 3))
    lanes = (g, y.int(), t1, nu, t1, t1, t1[None])
    with pytest.raises(ValueError, match="c must be"):
        binary_threshold_ess_reference(*lanes, torch.ones(3, dtype=torch.float64))
    with pytest.raises(ValueError, match="c is"):
        binary_threshold_ess_reference(*lanes, torch.ones(2, dtype=torch.float32))


# ---------------------------------------------------------------------------
# sweep blocks and whole sweeps with one temperature a chain
# ---------------------------------------------------------------------------


def _temps():
    return torch.as_tensor(TEMPS)


@pytest.mark.parametrize("C", [2, 5])
def test_z_block_per_chain_temperature(C):
    s = setup_for(C)
    rng = np.random.default_rng(15)
    g = rng.standard_normal((K, H, n, m)) * 2.0
    g[:, :, 0, :] = 40.0  # far-tail cells take the nearest-bound fallback
    thr = np.asarray(s["jstate"].thresholds)
    keys = jax.random.split(jax.random.key(42), K)
    y = jnp.asarray(s["y"])
    want = jax.vmap(lambda k, gg, tt, t: jg.draw_z_truncnorm(k, gg, y, tt, t))(
        keys, jnp.asarray(g), jnp.asarray(thr), jnp.asarray(TEMPS))
    u = _t(np.stack([np.asarray(jg._uniform2d(key, (H, n, m), _F64)) for key in keys]))
    _close(tg.draw_z_truncnorm(_t(g), s["yt"], _t(thr), u, _temps()), want)


def test_fstar_and_beta_blocks_per_chain_temperature():
    s = setup_for(2)
    jstate, jconsts, jcfg = s["jstate"], s["jconsts"], s["jcfg"]
    rng = np.random.default_rng(16)
    z_resid = rng.standard_normal((K, H, n, m))
    keys = jax.random.split(jax.random.key(43), K)
    want = jax.vmap(lambda k, st, zr, t: jg.draw_fstar_conjugate(
        k, st, zr, jcfg, jconsts, t))(keys, jstate, jnp.asarray(z_resid),
                                      jnp.asarray(TEMPS))
    q = jconsts.U_se.shape[1]
    z_q, z_p, z_n, eps = (_t(np.stack(a)) for a in
                          zip(*[_fstar_draws(key, q) for key in keys]))
    fstar, f = tg.draw_fstar_conjugate(s["state"], _t(z_resid), s["cfg"], s["consts"],
                                       z_q, z_p, z_n, eps, _temps())
    _close(fstar, want[0], 1e-10)
    _close(f, want[1], 1e-10)

    theta = np.asarray(jconsts.grid)[np.asarray(jstate.theta_idx)]
    zmf = rng.standard_normal((K, H, n, m)) + 0.3
    want = jax.vmap(lambda k, th, zz, t: jg.draw_beta_conjugate(
        k, th, zz, jconsts, jcfg, t))(keys, jnp.asarray(theta), jnp.asarray(zmf),
                                     jnp.asarray(TEMPS))
    zeta = _t(np.stack([np.asarray(jax.random.normal(key, (H, m, 3), _F64))
                        for key in keys]))
    _close(tg.draw_beta_conjugate(_t(theta), _t(zmf), s["consts"], s["cfg"], zeta,
                                  _temps()), want)


@pytest.mark.parametrize("C, method", [(2, "ess"), (5, "ess"), (2, "newton"),
                                       (5, "newton")])
def test_tempered_sweep_matches_vmapped_gibbs_sweep(C, method):
    """One sweep with one temperature a chain against jax.vmap(gibbs_sweep)
    over the chains and their temperatures: theta exactly, every block's
    output and the lanes' own tempered ll to 1e-10. At C = 2 by ESS the cutpoints take the kernel's
    plain version with one c a chain."""
    s = setup_for(C, method)
    jcfg, jconsts = s["jcfg"], s["jconsts"]
    y = jnp.asarray(s["y"])
    keys = jax.vmap(lambda k: jax.random.fold_in(k, 5))(s["keys"])
    jstate, jll = jax.vmap(lambda st, k, t: jg.gibbs_sweep(st, k, y, jconsts, jcfg, t))(
        s["jstate"], keys, jnp.asarray(TEMPS))
    q = jconsts.U_se.shape[1]
    draws = _port_draws([_sweep_draws(keys[k], q, C, method) for k in range(K)], method)
    state, ll = tg.gibbs_sweep(s["state"], draws, s["yt"], s["consts"], s["cfg"],
                               temp=_temps())
    np.testing.assert_array_equal(state.theta_idx.numpy(), np.asarray(jstate.theta_idx))
    for name in ("f", "fstar", "beta", "thresholds"):
        _close(getattr(state, name), getattr(jstate, name), 1e-10)
    _close(ll, jll, 1e-10)
    # each chain's own temperature matters: the sweep differs at one shared T
    one, _ = tg.gibbs_sweep(s["state"], draws, s["yt"], s["consts"], s["cfg"],
                            temp=float(TEMPS[0]))
    assert not torch.equal(one.beta[1], state.beta[1])
    assert torch.equal(one.beta[0], state.beta[0])


def test_float_and_none_temperatures_are_unchanged():
    """A (K,) tensor of one temperature gives, block for block, what that
    float gives; a tensor of ones what None gives."""
    s = setup_for(2)
    q = s["jconsts"].U_se.shape[1]
    keys = jax.vmap(lambda k: jax.random.fold_in(k, 6))(s["keys"])
    draws = _port_draws([_sweep_draws(keys[k], q, 2, "ess") for k in range(K)], "ess")
    args = (s["state"], draws, s["yt"], s["consts"], s["cfg"])
    for scalar, tensor in ((4.0, torch.full((K,), 4.0, dtype=torch.float64)),
                           (None, torch.ones(K, dtype=torch.float64))):
        a, lla = tg.gibbs_sweep(*args, temp=scalar)
        b, llb = tg.gibbs_sweep(*args, temp=tensor)
        assert all(torch.equal(x, z) for x, z in zip(a, b))
        assert torch.equal(lla, llb)


# ---------------------------------------------------------------------------
# the lanes' tempered ll and the swap phase
# ---------------------------------------------------------------------------


def _lane_states(G, L):
    """A JAX state of G L lanes (the binary setup's chains, tiled) with
    their per-lane ll at the ladder's temperatures."""
    s = setup_for(2)
    reps = (G * L + K - 1) // K
    jstate = jax.tree_util.tree_map(
        lambda a: jnp.concatenate([a] * reps)[:G * L], s["jstate"])
    # make the lanes differ: shift each lane's f
    shift = jnp.linspace(-0.8, 0.8, G * L)[:, None, None, None]
    jstate = jstate._replace(f=jstate.f + shift)
    temps = np.tile(jt.temperature_ladder(L, 6.0), G)
    return s, jstate, temps


def test_lane_ll_per_lane_temperature_matches():
    s, jstate, temps = _lane_states(2, 3)
    want = jt._lane_ll(jstate, jnp.asarray(temps), jnp.asarray(s["y"]), s["jconsts"])
    from gpirt_tpu_torch.convert import state_from_numpy

    state = state_from_numpy(jstate, device="cpu", dtype=torch.float64)
    got = tempering._lane_ll(state, _t(temps), s["yt"], s["consts"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


@pytest.mark.parametrize("phase", [0, 1])
@pytest.mark.parametrize("L", [1, 2, 4])
def test_swap_matches(L, phase):
    """The even/odd swap phase given the same uniforms (JAX's
    fold_in(k_swap, phase) draw): the same pairs accepted, the same states
    after the swap, the post-swap ll to 1e-12."""
    from gpirt_tpu_torch.convert import state_from_numpy

    G = 2
    s, jstate, temps = _lane_states(G, L)
    y = jnp.asarray(s["y"])
    ll_own = jt._lane_ll(jstate, jnp.asarray(temps), y, s["jconsts"])
    k_swap = jax.random.key(77)
    want_states, want_ll, want_acc = jt._swap(jstate, ll_own, jnp.asarray(temps), k_swap,
                                              phase, G, L, y, s["jconsts"])
    u = jax.random.uniform(jax.random.fold_in(k_swap, phase), (G * L,), _F64)
    state = state_from_numpy(jstate, device="cpu", dtype=torch.float64)
    got_states, got_ll, got_acc = tempering._swap(
        state, _t(ll_own), _t(temps), _t(u), phase, L, s["yt"], s["consts"])
    np.testing.assert_array_equal(got_acc.numpy(), np.asarray(want_acc))
    np.testing.assert_allclose(got_ll.numpy(), np.asarray(want_ll), rtol=1e-12)
    for got, want in zip(got_states, want_states):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if L > 1 and phase == 0:
        assert bool(got_acc.any())  # the test swaps something


# ---------------------------------------------------------------------------
# the tempered run
# ---------------------------------------------------------------------------


def _run_setup(f_method="conjugate"):
    rng = np.random.default_rng(8)
    nn, mm, NN = 8, 5, 41
    theta = np.linspace(-1.5, 1.5, nn)
    p = 1 / (1 + np.exp(-np.outer(theta, rng.standard_normal(mm) * 2)))
    y = torch.as_tensor(np.where(rng.random((nn, mm)) < p, 2, 1).astype(np.int32)[None])
    cfg = GPIRTConfig(n=nn, m=mm, grid_size=NN, dtype="float64", f_method=f_method)
    consts = make_constants(cfg, np.zeros((3, mm)), np.full((3, mm), 3.0),
                            np.zeros((2, nn)), np.zeros((2, nn)), device="cpu")
    thr = torch.as_tensor(np.tile([-np.inf, 0.0, np.inf], (1, mm, 1)))
    ti = torch.as_tensor(rng.uniform(-1, 1, (3, 1, nn)))
    return y, ti, thr, consts, cfg


def test_single_temperature_equals_run_chains():
    """n_temps = 1: no swap is proposed, and the draws equal run_chains'
    from the same generator."""
    y, ti, thr, consts, cfg = _run_setup()
    kw = dict(sample_iterations=5, burn_iterations=2, thin=2)
    got = tempering.run_tempered_chains(torch.Generator().manual_seed(4), y, ti, thr,
                                        consts, cfg, n_temps=1, max_temp=1.0, **kw)
    want = run_chains(torch.Generator().manual_seed(4), y, ti, thr, consts, cfg, **kw)
    assert got["swap_rate"].tolist() == [0.0]
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_tempered_run_layout_and_swap_rates():
    y, ti, thr, consts, cfg = _run_setup()
    out = tempering.run_tempered_chains(
        torch.Generator().manual_seed(5), y, ti, thr, consts, cfg, sample_iterations=12,
        burn_iterations=3, n_temps=3, max_temp=4.0, store_f=True, store_fstar=True)
    G, nn, mm = 3, cfg.n, cfg.m
    assert out["theta"].shape == (G, 12, 1, nn)
    assert out["beta"].shape == (G, 12, 1, 3, mm)
    assert out["threshold"].shape == (G, 12, 1, mm, 3)
    assert out["f"].shape == (G, 12, 1, nn, mm)
    assert out["fstar"].shape == (G, 12, 1, cfg.grid_size, mm)
    assert out["ll"].shape == (G, 12) and bool(torch.isfinite(out["ll"]).all())
    rate = out["swap_rate"]
    assert rate.shape == (2,) and bool(((rate >= 0) & (rate <= 1)).all())
    assert float(rate.sum()) > 0


def test_non_conjugate_tempering_is_refused():
    y, ti, thr, consts, cfg = _run_setup("two_stage")
    with pytest.raises(NotImplementedError, match="conjugate"):
        tempering.run_tempered_chains(torch.Generator(), y, ti, thr, consts, cfg,
                                      sample_iterations=2, burn_iterations=1, n_temps=2)


@pytest.mark.slow
def test_cold_marginal_matches_vanilla():
    """Reflection-invariant moments of the tempered ensemble's cold lanes
    against a long untempered run of the port, within Monte Carlo error
    (|z| <= 5 on batch-means variances), as in tests/test_tempering.py."""
    rng = np.random.default_rng(0)
    nn, mm, C, NN = 8, 5, 3, 61
    theta = np.linspace(-1.5, 1.5, nn)
    p = 1 / (1 + np.exp(-np.outer(theta, rng.standard_normal(mm))))
    u = rng.random((nn, mm))
    y = np.ones((1, nn, mm), np.int32)
    y[0][u < p] = 2
    y[0][u < p * 0.3] = 3
    cfg = GPIRTConfig(n=nn, m=mm, C=C, grid_size=NN, dtype="float64")
    consts = make_constants(cfg, np.zeros((3, mm)), np.full((3, mm), 1.5),
                            np.zeros((2, nn)), np.zeros((2, nn)), device="cpu")
    thr = torch.as_tensor(np.tile([-np.inf, -0.4, 0.6, np.inf], (1, mm, 1)))
    yt = torch.as_tensor(y)

    def moments(d):
        th = d["theta"].numpy()  # (G, S, 1, n)
        return np.stack([(th * th).mean(axis=(2, 3)), th.std(axis=3).mean(axis=2),
                         np.abs(th).mean(axis=(2, 3)), d["ll"].numpy()], -1).reshape(-1, 4)

    van = moments(run_chains(torch.Generator().manual_seed(10), yt,
                             torch.zeros(1, 1, nn, dtype=torch.float64), thr, consts, cfg,
                             sample_iterations=7500, burn_iterations=1500))
    d = tempering.run_tempered_chains(
        torch.Generator().manual_seed(20), yt, torch.zeros(2, 1, nn, dtype=torch.float64),
        thr, consts, cfg, sample_iterations=4000, burn_iterations=1500, n_temps=3,
        max_temp=4.0)
    assert float(d["swap_rate"].min()) > 0.01, d["swap_rate"]
    pt = moments(d)

    def bm_var(x, B=50):
        nb = len(x) // B
        return x[: nb * B].reshape(nb, B).mean(axis=1).var(ddof=1) / nb

    for j, name in enumerate(["th2", "sd", "absth", "ll"]):
        z = (van[:, j].mean() - pt[:, j].mean()) / np.sqrt(
            bm_var(van[:, j]) + bm_var(pt[:, j]) + 1e-12)
        assert abs(z) <= 5.0, (name, z, van[:, j].mean(), pt[:, j].mean())
