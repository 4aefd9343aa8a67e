"""What chip_smoke.py computes without a card: the round count that its
kernel bound rests on, and its refusal to run without CUDA."""

import numpy as np
import pytest
import torch

import chip_smoke
from gpirt_tpu_torch.ops.threshold_ess import binary_threshold_ess_reference

_C = 0.7071067811865476
_TWO_PI = 6.283185307179586


def _lanes(K=3, H=2, n=9, m=13, R=6, seed=0):
    rng = np.random.default_rng(seed)
    g = torch.as_tensor(1.5 * rng.standard_normal((K, H, n, m)))
    y = torch.as_tensor(rng.choice([0, 1, 2], size=(H, n, m), p=[0.2, 0.4, 0.4]),
                        dtype=torch.int32)
    t1, nu = torch.as_tensor(rng.standard_normal((2, K, H, m)))
    logu = torch.as_tensor(np.log(rng.random((K, H, m))))
    eps0 = torch.as_tensor(rng.random((K, H, m)) * _TWO_PI)
    rs = torch.as_tensor(rng.random((R, K, H, m)))
    return g, y, t1, nu, logu, eps0, rs


@pytest.mark.parametrize("temp", [1.0, 64.0])
def test_lane_rounds_counts_the_plain_versions_proposals(temp):
    """A lane counted at r proposals takes its final value under a cap of r
    rounds and keeps t0 under any smaller cap; a lane at the cap keeps t0."""
    args = _lanes()
    t1, rs = args[2], args[6]
    R = rs.shape[0]
    c = _C / np.sqrt(temp)
    rounds, capped = chip_smoke.lane_rounds(*args, c)
    final = binary_threshold_ess_reference(*args, c)
    assert torch.equal(final[capped], t1[capped])
    assert bool(((rounds >= 1) & (rounds <= R)).all())
    assert int(rounds.max()) > 1 and int(rounds.min()) == 1
    for r in range(1, R + 1):
        cut = binary_threshold_ess_reference(*args[:6], rs[:r], c)
        done = (rounds <= r) & ~capped
        assert torch.equal(cut[done], final[done])
        assert torch.equal(cut[~done], t1[~done])


def test_refuses_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert "is_available() is false" in out.err


@pytest.mark.parametrize("C", [2, 5])
def test_gp_sweep_check_inputs_stay_clear_of_float32_tails(C):
    """The GP sweep check's inputs: one state shared by the chains and y
    drawn from the model there, so its float32 sweep lies within 1e-4 of
    the same sweep in float64 in f, beta and the cutpoints (and f* within
    1e-3) on the CPU: the card is held to 1e-3 against a margin of 10x."""
    cfg, _, state0, _, y = chip_smoke.sweep_inputs(C, H=3, theta_ls=2.0)
    assert cfg.theta_regime == "GP"
    assert all(torch.equal(a[1:], a[:1].expand_as(a[1:])) for a in state0)
    assert y.shape == (3, 12, 9) and (y[:, 0, :3] == 0).all()
    assert set(np.unique(y[:, 1:])) <= set(range(1, C + 1))
    (s32, _), (s64, _), _, _ = chip_smoke.sweep_vs_float64(C, H=3, theta_ls=2.0)
    assert torch.equal(s32.theta_idx, s64.theta_idx)
    for name, tol in (("f", 1e-4), ("beta", 1e-4), ("thresholds", 1e-4), ("fstar", 1e-3)):
        assert chip_smoke.max_diff(getattr(s32, name), getattr(s64, name))[0] < tol, name
