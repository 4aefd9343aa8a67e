"""What chip_smoke.py computes without a card: the round count that its
kernel bound rests on, its refusal to run without CUDA, and the inputs and
setup of its sweep checks and of the synthetic path at a reduced size."""

import numpy as np
import pytest
import torch

import chip_smoke
from gpirt_tpu_torch import gpirt_mcmc
from gpirt_tpu_torch.models import gibbs
from gpirt_tpu_torch.models.config import make_constants
from gpirt_tpu_torch.ops.threshold_ess import binary_threshold_ess_reference
from gpirt_tpu_torch.utils.datasets import simulate_2pl
from gpirt_tpu_torch.utils.response import as_response_matrix

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


def test_synthetic_run_at_reduced_size():
    """Phase 16's setup and run (bench.py::bench_synthetic's data, one
    permutation of linspace(-3, 3, n) a chain, the conjugate sampler through
    run_chains) at n = 300, m = 40 and 2 chains on the CPU."""
    cpu = torch.device("cpu")
    inputs = chip_smoke.synthetic_inputs(cpu, n=300, m=40, K=2)
    y, ti, thr, _, cfg = inputs
    assert cfg.resolved_f_method == "conjugate" and cfg.C == 2
    assert y.shape == (1, 300, 40) and y.dtype == torch.int32
    assert 0.05 < float((y == 0).double().mean()) < 0.15  # 10% missing
    assert ti.shape == (2, 1, 300) and not torch.equal(ti[0], ti[1])
    for c in range(2):
        np.testing.assert_allclose(np.sort(ti[c, 0].numpy()), np.linspace(-3, 3, 300),
                                   atol=1e-6)
    assert thr.shape == (1, 40, 3)
    out, launches, wall, args = chip_smoke.synthetic_run(cpu, inputs, 2, 3)
    assert launches == 0 and wall > 0  # the CPU runs the plain version
    assert out["ll"].shape == (2, 3) and bool(torch.isfinite(out["ll"]).all())
    assert out["theta"].shape == (2, 3, 1, 300)
    assert bool((out["threshold"][:, -1, ..., 1] != 0).all())
    assert tuple(args[0].shape) == (2, 1, 300, 40) and torch.equal(args[1], y)


@pytest.mark.parametrize("C, fstar_method", [(2, "matheron"), (2, "chol"),
                                             (5, "matheron"), (5, "chol")])
def test_two_stage_sweep_check_inputs_are_finite(C, fstar_method):
    """Phase 12's float32 two-stage sweep on the CPU: every field finite,
    the cutpoints moved, and a finite rounding spread of f and f*."""
    cpu = torch.device("cpu")
    cfg, priors, state0, draws, y = chip_smoke.sweep_inputs(
        C, model_y=True, f_method="two_stage", fstar_method=fstar_method)
    assert isinstance(draws, gibbs.TwoStageDraws)
    consts = make_constants(cfg, *priors, device=cpu)
    state, ll, f = chip_smoke.two_stage_sweep_on(cpu, state0, draws, y, consts, cfg)
    for a in (state.f, state.beta, state.fstar, ll, f):
        assert bool(torch.isfinite(a).all())
    assert float((state.thresholds != state0.thresholds)[..., 1:-1].double().mean()) > 0.2
    spread = chip_smoke.sweep_spread(state0, draws, y, consts, cfg, reps=1)
    assert all(bool(torch.isfinite(s).all()) for s in spread.values())


def test_recovery_check_on_the_cpu(capsys):
    """Phase 14 with the CPU in the card's place, on a small two-stage
    chain: the batch's shape and seed, one draw against itself within its
    own rounding spread."""
    _, votes = simulate_2pl(2, n=20, m=8)
    rm = np.asarray(as_response_matrix(votes, chip_smoke.DYN_VOTES, verbose=False))
    chain = gpirt_mcmc(votes, 3, 2, CHAIN=1, vote_codes=chip_smoke.DYN_VOTES,
                       f_method="two_stage", store_f=True,
                       theta_init=np.linspace(-2, 2, 20), device="cpu")[0]
    chip_smoke.recovery_check(chain, rm, torch.device("cpu"), "cpu")
    assert "draw_f max abs diff 0, f* 0 " in capsys.readouterr().out


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
