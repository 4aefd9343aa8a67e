"""The ordinal cutpoint ESS wrapper of the port on the CPU: its plain version
is the host-looped update the sweep ran before the kernel (ess_update over
the category log-probs summed against the one-hot of y), bit for bit; it
refuses what the kernel cannot take; and draw_threshold routes every
ordinal ESS through it except under a respondent axis. The CUDA kernel
itself runs only on the card (tests/test_torch_gpu.py)."""

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a process)
from gpirt_tpu_torch.models import gibbs
from gpirt_tpu_torch.models.config import GPIRTConfig
from gpirt_tpu_torch.ops.ess import ess_update
from gpirt_tpu_torch.ops.likelihood import delta_to_threshold
from gpirt_tpu_torch.ops.threshold_ess import (
    ordinal_threshold_ess,
    ordinal_threshold_ess_reference,
)

_TWO_PI = 6.283185307179586
_C = 0.7071067811865476


def _inputs(K=5, H=2, n=30, m=7, C=5, R=64, dtype=torch.float64, seed=0):
    """g, y (about a fifth missing), d, nu, logu, eps0, rs."""
    rng = np.random.default_rng(seed)
    y = rng.integers(1, C + 1, (H, n, m))
    y[rng.random((H, n, m)) < 0.2] = 0
    d = np.concatenate([rng.standard_normal((K, H, m, 1)),
                        -0.5 + 0.3 * rng.standard_normal((K, H, m, C - 2))], axis=-1)
    arrays = (rng.standard_normal((K, H, n, m)), d, rng.standard_normal((K, H, m, C - 1)),
              np.log(rng.random((K, H, m))), rng.random((K, H, m)) * _TWO_PI,
              rng.random((R, K, H, m)))
    g, d, nu, logu, eps0, rs = (torch.as_tensor(a, dtype=dtype) for a in arrays)
    return g, torch.as_tensor(y, dtype=torch.int32), d, nu, logu, eps0, rs


def _host_loop(g, y, d, nu, logu, eps0, rs, inv_s):
    """The sweep's ordinal cutpoint update before the kernel, as it was
    written in draw_threshold."""
    C = d.shape[-1] + 1
    onehot = gibbs._onehot(y, C, g.dtype)

    def loglik(x):
        logp = gibbs._category_logprobs(g, delta_to_threshold(x).unsqueeze(-3), C, inv_s)
        return (logp * onehot).sum(dim=(-3, -1))

    return ess_update(d, nu, loglik, logu, eps0, rs)


@pytest.mark.parametrize("R", [1, 3, 64])
@pytest.mark.parametrize("scale", ["one", "a chain"])
@pytest.mark.parametrize("C", [3, 5, 7])
def test_plain_version_is_the_host_loop_bit_for_bit(C, scale, R):
    """At C = 3, 5 and 7, with missing sites, one c or one a chain (the
    tempering ladder's 1/sqrt(T)), and a cap of 1, 3 and 64 rounds; on the
    CPU the wrapper is the plain version and launches nothing."""
    g, y, d, nu, logu, eps0, rs = _inputs(C=C, R=R)
    inv_s = None if scale == "one" else 1.0 / torch.sqrt(torch.tensor([1.0, 2, 4, 8, 16],
                                                                      dtype=g.dtype))
    c = _C if inv_s is None else _C * inv_s
    before = ordinal_threshold_ess.launches
    got = ordinal_threshold_ess(g, y, d, nu, logu, eps0, rs, c)
    assert ordinal_threshold_ess.launches == before
    want = _host_loop(g, y, d, nu, logu, eps0, rs, inv_s)
    assert torch.equal(got, want)
    assert torch.equal(ordinal_threshold_ess_reference(g, y, d, nu, logu, eps0, rs, c), want)
    assert bool((got != d).any())


@pytest.mark.parametrize("R", [1, 2])
def test_plain_version_keeps_lanes_at_the_round_cap(R):
    """A slice level no proposal reaches: the lane keeps its deltas."""
    g, y, d, nu, logu, eps0, rs = _inputs(R=R, dtype=torch.float32)
    logu[:, :, ::2] = 1e30
    got = ordinal_threshold_ess(g, y, d, nu, logu, eps0, rs, _C)
    assert torch.equal(got[:, :, ::2], d[:, :, ::2])
    assert torch.equal(got, _host_loop(g, y, d, nu, logu, eps0, rs, None))


@pytest.mark.parametrize("R", [1, 3, 64])
def test_plain_version_applies_lane_total_to_every_loglik(R):
    """The hook sees every loglik's lane sums: doubling them against a
    doubled log u (both exact in binary floating point) gives the same bits
    as neither, and the hook runs once per loglik, at least twice."""
    g, y, d, nu, logu, eps0, rs = _inputs(R=R)
    seen = []

    def doubled(t):
        seen.append(t.shape)
        return 2.0 * t

    want = ordinal_threshold_ess_reference(g, y, d, nu, logu, eps0, rs, _C)
    got = ordinal_threshold_ess_reference(g, y, d, nu, 2.0 * logu, eps0, rs, _C,
                                          lane_total=doubled)
    assert torch.equal(got, want)
    assert len(seen) >= 2 and set(seen) == {logu.shape}


def test_wrapper_rejects_bad_inputs():
    g, y, d, nu, logu, eps0, rs = _inputs()
    with pytest.raises(ValueError, match="g must be"):
        ordinal_threshold_ess(g[0], y, d, nu, logu, eps0, rs, _C)
    with pytest.raises(ValueError, match="C >= 3"):
        ordinal_threshold_ess(g, y, d[..., :1], nu[..., :1], logu, eps0, rs, _C)
    with pytest.raises(ValueError, match="d must be"):
        ordinal_threshold_ess(g, y, d[:, :, :-1], nu[:, :, :-1], logu, eps0, rs, _C)
    with pytest.raises(ValueError, match="nu must be"):
        ordinal_threshold_ess(g, y, d, nu[..., :-1], logu, eps0, rs, _C)
    with pytest.raises(ValueError, match="y must be"):
        ordinal_threshold_ess(g, y[:, :-1], d, nu, logu, eps0, rs, _C)
    with pytest.raises(ValueError, match="integer"):
        ordinal_threshold_ess(g, y.double(), d, nu, logu, eps0, rs, _C)
    with pytest.raises(ValueError, match="rs must be"):
        ordinal_threshold_ess(g, y, d, nu, logu, eps0, rs[:, :1], _C)
    with pytest.raises(ValueError, match="d is torch.float32"):
        ordinal_threshold_ess(g, y, d.float(), nu, logu, eps0, rs, _C)
    with pytest.raises(ValueError, match="logu is torch.float32"):
        ordinal_threshold_ess(g, y, d, nu, logu.float(), eps0, rs, _C)
    with pytest.raises(ValueError, match="c must be"):
        ordinal_threshold_ess(g, y, d, nu, logu, eps0, rs, torch.ones(3, dtype=g.dtype))
    meta = [a.to("meta") for a in (g, y, d, nu, logu, eps0, rs)]
    with pytest.raises(ValueError, match="no kernel for device"):
        ordinal_threshold_ess(*meta, _C)


def _draw(respondent_group=None, temp=None):
    g, y, d, nu, logu, eps0, rs = _inputs(K=4, H=1, n=25, m=6, C=5)
    thr = delta_to_threshold(d)
    cfg = GPIRTConfig(n=25, m=6, C=5)
    return gibbs.draw_threshold(thr, g, 0.1 * g, y, cfg, nu, logu, eps0, rs, temp,
                                respondent_group)


@pytest.mark.parametrize("temp", [None, 4.0])
def test_draw_threshold_routes_the_ordinal_ess(monkeypatch, temp):
    """Without a respondent axis draw_threshold's ordinal ESS is one call of
    the wrapper; under one, every round's lane totals are summed over the
    group, so the plain round loop runs (here over a group of one rank,
    which gives the wrapper's bits)."""
    calls, groups = [], []
    wrapper = gibbs.ordinal_threshold_ess

    def counted(*args):
        calls.append(args)
        return wrapper(*args)

    def all_sum(t, group):
        groups.append(group)
        return t

    monkeypatch.setattr(gibbs, "ordinal_threshold_ess", counted)
    want = _draw(temp=temp)
    assert len(calls) == 1 and not groups
    monkeypatch.setattr(gibbs, "_all_sum", all_sum)
    got = _draw("respondents", temp)
    assert len(calls) == 1 and groups and set(groups) == {"respondents"}
    assert torch.equal(got, want)
