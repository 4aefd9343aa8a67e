"""The binary cutpoint ESS kernel module of the port against the JAX package.

The plain PyTorch version of the kernel is held against the Pallas kernel
run in interpret mode and against ``draw_threshold``'s XLA path, each fed
the same uniforms (replayed from the JAX key splits). The CUDA kernel
itself runs only on the card (tests/test_torch_gpu.py).
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
from gpirt_tpu_torch.ops.threshold_ess import (
    binary_threshold_ess,
    binary_threshold_ess_reference,
)

_TWO_PI = 6.283185307179586
_C = 0.7071067811865476


def _lanes(seed, K, H, n, m):
    """g (K, H, n, m), y (H, n, m) with ~20% missing, t1 and nu (K, H, m)."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((K, H, n, m))
    y = rng.choice([0, 1, 2], size=(H, n, m), p=[0.2, 0.4, 0.4]).astype(np.int32)
    t1 = rng.standard_normal((K, H, m))
    nu = rng.standard_normal((K, H, m))
    return g, y, t1, nu


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _pallas_and_plain(K, H, n, m, temp, seed=0, missing_items=(), rounds=None):
    """The Pallas kernel in interpret mode (R = 24) and the plain version
    fed the same uniforms, the wrapper's own split(key, 3) replayed; the
    plain version keeps the first ``rounds`` rows of the shrink table when
    given. Returns (plain, pallas, t1), each flat over the lanes."""
    L = K * H * m
    g, y, t1, nu = _lanes(seed, K, H, n, m)
    y[..., list(missing_items)] = 0
    c = _C / np.sqrt(temp)
    sgn = np.where(y == 1, 1.0, -1.0) * (y > 0)

    def rows(a):  # (K, H, n, m) -> site-major (n, L), lane = (k, h, j)
        return jnp.asarray(np.broadcast_to(a, (K, H, n, m))
                           .transpose(2, 0, 1, 3).reshape(n, L))

    key = jax.random.key(11)
    want = binary_threshold_ess_pallas(
        key, jnp.asarray(t1.reshape(L)), jnp.asarray(nu.reshape(L)), rows(g),
        rows(sgn), rows((y > 0).astype(np.float64)), c, interpret=True)
    k_u, k_eps, k_loop = jax.random.split(key, 3)
    dt = jnp.float64
    logu = jnp.log(jax.random.uniform(k_u, (L,), dtype=dt))
    eps0 = jax.random.uniform(k_eps, (L,), dtype=dt, maxval=_TWO_PI)
    rs = jax.random.uniform(k_loop, (PALLAS_THRESHOLD_ROUNDS, L), dtype=dt)
    got = binary_threshold_ess_reference(
        _t(g), _t(y, torch.int32), _t(t1), _t(nu),
        _t(logu).reshape(K, H, m), _t(eps0).reshape(K, H, m),
        _t(rs[:rounds]).reshape(-1, K, H, m), c)
    return got.numpy().reshape(L), np.asarray(want), t1.reshape(L)


@pytest.mark.parametrize("temp", [1.0, 64.0])
def test_reference_equals_pallas_interpret(temp):
    """Same uniforms (the Pallas wrapper's own split(key, 3), R = 24),
    unaligned n and L. Tolerance: every lane within 1e-10, except at most 2
    of 130 lanes whose accept flipped on a near-tie — the Pallas kernel
    evaluates erf by the A&S 7.1.26 polynomial (|err| <= 1.5e-7), the plain
    version by torch.erf."""
    got, want, t1 = _pallas_and_plain(2, 1, 37, 65, temp)
    err = np.abs(got - want)
    assert np.sum(err > 1e-10) <= 2, np.sort(err)[-5:]
    assert np.mean(got != t1) > 0.8  # the update moves lanes


@pytest.mark.parametrize("temp", [1.0, 64.0])
@pytest.mark.parametrize("case", ["item_without_responses", "one_respondent"])
def test_reference_equals_pallas_interpret_edge_cases(case, temp):
    """Items with no observed response (ll is 0, so the first proposal is
    taken) and n = 1, with the tolerance of the test above."""
    K, H, m = 2, 1, 65
    if case == "item_without_responses":
        missing = (0, 7, 64)
        got, want, t1 = _pallas_and_plain(K, H, 37, m, temp, seed=4,
                                          missing_items=missing)
        lanes = [k * m + j for k in range(K) for j in missing]
        np.testing.assert_allclose(got[lanes], want[lanes], rtol=0, atol=1e-10)
        assert np.all(got[lanes] != t1[lanes])
    else:
        got, want, t1 = _pallas_and_plain(K, H, 1, m, temp, seed=5)
    err = np.abs(got - want)
    assert np.sum(err > 1e-10) <= 2, np.sort(err)[-5:]
    assert np.mean(got != t1) > 0.8


@pytest.mark.parametrize("rounds", [1, 2])
def test_round_cap_keeps_t0_against_pallas(rounds):
    """With the first ``rounds`` rows of the Pallas kernel's own shrink
    table as the cap, a lane that accepts within them takes the Pallas
    kernel's value, and every other lane keeps t0 exactly."""
    got, want, t1 = _pallas_and_plain(2, 1, 37, 65, 1.0, seed=6, rounds=rounds)
    kept = got == t1
    assert 0 < kept.sum() < kept.size
    err = np.abs(got[~kept] - want[~kept])
    assert np.sum(err > 1e-10) <= 2, np.sort(err)[-5:]


@pytest.mark.parametrize("temp", [1.0, 64.0])
@pytest.mark.parametrize("n", [2049, 4099])
def test_reference_equals_pallas_interpret_past_the_register_cap(n, temp):
    """Where the card kernel takes its tile path (n > 2048): the plain
    version against the Pallas kernel in interpret mode, fed the same
    uniforms, with an item that has no response, at the tolerance of
    test_reference_equals_pallas_interpret."""
    K, H, m = 2, 1, 13
    missing = (0,)
    got, want, t1 = _pallas_and_plain(K, H, n, m, temp, seed=n, missing_items=missing)
    err = np.abs(got - want)
    assert np.sum(err > 1e-10) <= 2, np.sort(err)[-5:]
    lanes = [k * m for k in range(K)]
    np.testing.assert_allclose(got[lanes], want[lanes], rtol=0, atol=1e-10)
    assert np.mean(got != t1) > 0.8


def _replay_ess_draws(key, H, m):
    """nu, logu, eps0 and the 64-round shrink table exactly as
    draw_threshold -> ess_update consume them from ``key``; its first R rows
    are what a cap of R rounds consumes."""
    dt = jnp.float64
    k_nu, k_ess = jax.random.split(key)
    nu = jax.random.normal(k_nu, (H, m, 1), dt)[..., 0]
    k_u, k_eps, k_loop = jax.random.split(k_ess, 3)
    logu = jnp.log(jax.random.uniform(k_u, (H, m), dtype=dt))
    eps0 = jax.random.uniform(k_eps, (H, m), dtype=dt, maxval=_TWO_PI)
    rs = []
    k = k_loop
    for _ in range(64):
        k, k_r = jax.random.split(k)
        rs.append(jax.random.uniform(k_r, (H, m), dtype=dt))
    return [np.asarray(a) for a in (nu, logu, eps0, jnp.stack(rs))]


def test_reference_equals_tempered_xla_draw_threshold():
    """The JAX kernel was never run tempered, so at T = 4 the plain version
    is held against draw_threshold's XLA path (ess_update, no two-phase
    compaction), lane for lane, to 1e-10."""
    K, H, n, m = 2, 1, 23, 11
    temp = 4.0
    g, y, t1, _ = _lanes(1, K, H, n, m)
    cfg = JConfig(n=n, m=m, C=2, grid_size=11, dtype="float64",
                  f_method="conjugate", threshold_ess_twophase=False)
    thr = np.stack([np.full((K, H, m), -np.inf), t1,
                    np.full((K, H, m), np.inf)], axis=-1)
    keys = [jax.random.key(100 + k) for k in range(K)]
    want = np.stack([
        np.asarray(jg.draw_threshold(keys[k], jnp.asarray(thr[k]),
                                     jnp.asarray(g[k]), jnp.zeros_like(g[k]),
                                     jnp.asarray(y), cfg, temp=temp))
        for k in range(K)])
    nu, logu, eps0, rs = (np.stack(a) for a in
                          zip(*[_replay_ess_draws(key, H, m) for key in keys]))
    got = binary_threshold_ess_reference(
        _t(g), _t(y, torch.int32), _t(t1), _t(nu), _t(logu), _t(eps0),
        _t(rs).transpose(0, 1).contiguous(), _C / np.sqrt(temp))
    np.testing.assert_allclose(got.numpy(), want[..., 1], rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("rounds", [1, 2])
def test_round_cap_equals_xla_draw_threshold(rounds):
    """draw_threshold's XLA path with ess_max_rounds = R (1 or 2) against the
    plain version with R rows of the same uniforms, lane for lane, to
    1e-10: lanes not accepted within R rounds keep t0 in both."""
    K, H, n, m = 2, 1, 23, 11
    g, y, t1, _ = _lanes(7, K, H, n, m)
    cfg = JConfig(n=n, m=m, C=2, grid_size=11, dtype="float64",
                  f_method="conjugate", threshold_ess_twophase=False,
                  ess_max_rounds=rounds)
    thr = np.stack([np.full((K, H, m), -np.inf), t1,
                    np.full((K, H, m), np.inf)], axis=-1)
    keys = [jax.random.key(200 + k) for k in range(K)]
    want = np.stack([
        np.asarray(jg.draw_threshold(keys[k], jnp.asarray(thr[k]),
                                     jnp.asarray(g[k]), jnp.zeros_like(g[k]),
                                     jnp.asarray(y), cfg))
        for k in range(K)])[..., 1]
    nu, logu, eps0, rs = (np.stack(a) for a in
                          zip(*[_replay_ess_draws(key, H, m) for key in keys]))
    got = binary_threshold_ess_reference(
        _t(g), _t(y, torch.int32), _t(t1), _t(nu), _t(logu), _t(eps0),
        _t(rs[:, :rounds]).transpose(0, 1).contiguous(), _C).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    kept = got == t1
    assert 0 < kept.sum() < kept.size


@pytest.mark.parametrize("temp", [1.0, 4.0])
@pytest.mark.parametrize("n", [2049, 4099])
def test_reference_equals_xla_draw_threshold_past_the_register_cap(n, temp):
    """draw_threshold's XLA path against the plain version fed the same
    uniforms, lane for lane, to 1e-10, at the n where the card kernel takes
    its tile path."""
    K, H, m = 2, 1, 11
    g, y, t1, _ = _lanes(n, K, H, n, m)
    cfg = JConfig(n=n, m=m, C=2, grid_size=11, dtype="float64",
                  f_method="conjugate", threshold_ess_twophase=False)
    thr = np.stack([np.full((K, H, m), -np.inf), t1,
                    np.full((K, H, m), np.inf)], axis=-1)
    keys = [jax.random.key(300 + k) for k in range(K)]
    want = np.stack([
        np.asarray(jg.draw_threshold(keys[k], jnp.asarray(thr[k]),
                                     jnp.asarray(g[k]), jnp.zeros_like(g[k]),
                                     jnp.asarray(y), cfg, temp=temp))
        for k in range(K)])[..., 1]
    nu, logu, eps0, rs = (np.stack(a) for a in
                          zip(*[_replay_ess_draws(key, H, m) for key in keys]))
    got = binary_threshold_ess_reference(
        _t(g), _t(y, torch.int32), _t(t1), _t(nu), _t(logu), _t(eps0),
        _t(rs).transpose(0, 1).contiguous(), _C / np.sqrt(temp)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    assert np.mean(got != t1) > 0.8


def _wrapper_args(dtype=torch.float64, device="cpu", K=2, H=1, n=7, m=5, R=8):
    g, y, t1, nu = _lanes(2, K, H, n, m)
    rng = np.random.default_rng(3)
    logu = np.log(rng.random((K, H, m)))
    eps0 = rng.random((K, H, m)) * _TWO_PI
    rs = rng.random((R, K, H, m))
    return [torch.as_tensor(a, dtype=dtype, device=device)
            for a in (g, y, t1, nu, logu, eps0, rs)]


def test_wrapper_takes_plain_version_on_cpu():
    g, y, t1, nu, logu, eps0, rs = _wrapper_args()
    y = y.to(torch.int32)
    before = binary_threshold_ess.launches
    got = binary_threshold_ess(g, y, t1, nu, logu, eps0, rs, _C)
    want = binary_threshold_ess_reference(g, y, t1, nu, logu, eps0, rs, _C)
    assert torch.equal(got, want)
    assert binary_threshold_ess.launches == before  # no kernel launched


def test_wrapper_rejects_bad_inputs():
    g, y, t1, nu, logu, eps0, rs = _wrapper_args()
    y = y.to(torch.int32)
    with pytest.raises(ValueError, match="y must be"):
        binary_threshold_ess(g, y[:, :-1], t1, nu, logu, eps0, rs, _C)
    with pytest.raises(ValueError, match="rs must be"):
        binary_threshold_ess(g, y, t1, nu, logu, eps0, rs[:, :1], _C)
    with pytest.raises(ValueError, match="integer"):
        binary_threshold_ess(g, y.double(), t1, nu, logu, eps0, rs, _C)
    with pytest.raises(ValueError, match="is torch.float32"):
        binary_threshold_ess(g, y, t1.float(), nu, logu, eps0, rs, _C)
    meta = [a.to("meta") for a in (g, y, t1, nu, logu, eps0, rs)]
    with pytest.raises(ValueError, match="no kernel for device"):
        binary_threshold_ess(*meta, _C)
