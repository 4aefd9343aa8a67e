"""What chip_smoke.py computes without a card: the round count that its
kernel bound rests on, its refusal to run without CUDA, and the inputs and
setup of its sweep checks (the shared-IRF ones too) and of the synthetic
path at a reduced size."""

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


@pytest.mark.parametrize("f_method", ["grid", "conjugate", "two_stage"])
def test_shared_irf_check_inputs(f_method):
    """Phase 23's inputs under constant_IRF: the GP regime over three
    sessions, the shared IRF's draws with a session axis of 1, a float32
    sweep on the CPU that keeps f* and the cutpoints one a chain; the
    two-stage sweep fed its own f* is that sweep."""
    cfg, priors, state0, draws, y = chip_smoke.sweep_inputs(
        2, H=3, theta_ls=chip_smoke.DYN_LS, model_y=True, f_method=f_method,
        constant_IRF=True)
    assert cfg.resolved_f_method == f_method and cfg.theta_regime == "GP"
    assert draws.cut.nu.shape == (3, 1, 9, 1)
    cpu = torch.device("cpu")
    consts = make_constants(cfg, *priors, device=cpu)
    if f_method == "two_stage":
        state, ll, _, fstar = chip_smoke.fed_fstar_sweep(cpu, state0, draws, y, consts, cfg)
        fed = chip_smoke.fed_fstar_sweep(cpu, state0, draws, y, consts, cfg, fstar=fstar)
        assert all(torch.equal(a, b) for a, b in zip(state, fed[0]))
    else:
        state, ll = gibbs.gibbs_sweep(state0, draws, torch.as_tensor(y), consts, cfg)
    assert torch.equal(state.fstar[:, 0], state.fstar[:, -1])
    assert torch.equal(state.thresholds[:, 0], state.thresholds[:, -1])
    assert bool(torch.isfinite(ll).all()) and bool(torch.isfinite(state.fstar).all())


def _small_votes():
    """A 20 x 8 response matrix (1 yea, 0 nay), as senate116_response_matrix
    gives senate116's."""
    _, votes = simulate_2pl(3, n=20, m=8)
    return as_response_matrix(votes, chip_smoke.DYN_VOTES, verbose=False)


def test_per_chain_lane_rounds_and_ladder():
    """Phase 17's ladder (geometric, 1 to 64) and the round count with one
    c a chain: each chain's rounds are those of its own scalar c."""
    temps = chip_smoke.ladder(3)
    np.testing.assert_allclose(temps.numpy(), [1.0, 8.0, 64.0], rtol=1e-6)
    args = _lanes()
    c = chip_smoke.c_of(temps.double())
    rounds, capped = chip_smoke.lane_rounds(*args, c)
    g, y, t1, nu, logu, eps0, rs = args
    for k in range(3):
        one = [a[k:k + 1] for a in (g, t1, nu, logu, eps0)]
        one = one[:1] + [y] + one[1:] + [rs[:, k:k + 1]]
        r_k, cap_k = chip_smoke.lane_rounds(*one, float(c[k]))
        assert torch.equal(rounds[k:k + 1], r_k) and torch.equal(capped[k:k + 1], cap_k)


def test_tempering_path_at_reduced_size(capsys):
    """Phase 19 on the CPU with 2 groups of 4 temperatures: one call of the
    kernel's wrapper a sweep, each with 4 distinct c values, swap rates by
    rung; the plain version runs, so no launch is counted."""
    launches, args, c = chip_smoke.tempering_path(_small_votes(), torch.device("cpu"),
                                                  "cpu", chains=2, burn=2, draws=8)
    assert launches == 0
    assert c.shape == (8,) and torch.unique(c).numel() == 4
    assert tuple(args[0].shape) == (8, 1, 20, 8)
    assert "swap rate by rung" in capsys.readouterr().out


def test_campaigns8_and_chains64_at_reduced_size(capsys):
    """Phases 20 and 21 on the CPU at a few chains and sweeps: campaign
    outputs checked, no kernel launch under Newton cutpoints, and split
    R-hat of the sign-aligned chains."""
    rm = _small_votes()
    cpu = torch.device("cpu")
    out, launches = chip_smoke.campaigns8(rm, cpu, "cpu", n_chains=2, smc_steps=3,
                                          burn_iterations=1, sample_iterations=4)
    assert launches == 0
    assert out["campaign_means"].shape == (chip_smoke.CAMPAIGNS, 20, 1)
    assert out["schedule"]["threshold_method"] == "newton"
    launches, rhat = chip_smoke.chains64(rm, cpu, "cpu", chains=3, burn=1, draws=8)
    assert launches == 0 and rhat >= 1.0
    text = capsys.readouterr().out
    assert "campaigns8 on cpu" in text and "rhat_max" in text


def test_campaign_agreement_rule(tmp_path):
    """Phase 22's rule: a grand mean within its standard errors of the
    fixture's (reflected, which the sign alignment undoes) passes; one that
    is 5 standard errors off for 6 of 100 respondents fails."""
    rng = np.random.default_rng(0)
    jax_means = rng.standard_normal((8, 100)) * 0.05 + np.linspace(-2, 2, 100)
    se = np.full(100, 0.05)
    path = tmp_path / "fixture.npz"
    np.savez(path, campaign_means=jax_means, theta_se=se, n_campaigns=8, n_chains=64,
             smc_steps=160, burn_iterations=25, sample_iterations=100)
    port = -(jax_means.mean(axis=0) + 0.5 * rng.standard_normal(100) * 0.05)
    out = {"theta_mean": port[:, None], "theta_se": se[:, None]}
    r, worst, within = chip_smoke.campaign_agreement(out, path)
    assert r > 0.99 and within >= 95 and worst < 4
    bad = port.copy()
    bad[:6] -= 5 * np.sqrt(2) * 0.05 * np.sign(bad[:6])
    with pytest.raises(RuntimeError, match="within"):
        chip_smoke.campaign_agreement({"theta_mean": bad[:, None],
                                       "theta_se": se[:, None]}, path)


@pytest.mark.parametrize("label, inputs, temp, iteration", chip_smoke.OPTION_CHECKS)
def test_option_checks_on_the_cpu(label, inputs, temp, iteration, capsys):
    """Phase 26 with the CPU in the card's place: every check's float32
    inputs run, the fields finite, the cutpoints moved, and no difference."""
    errs = chip_smoke.option_check(torch.device("cpu"), label, inputs, temp, iteration)
    assert all(v == 0.0 for v in errs.values())
    assert "theta equal in 3 of 3 chains" in capsys.readouterr().out


def test_option_checks_draw_what_each_check_names():
    """The inputs phase 26 names: the ESS theta update in its regime, the
    collapsed draw's draws, interleave's two sweeps, the options' fields."""
    by_label = {label: (inputs, it) for label, inputs, _, it in chip_smoke.OPTION_CHECKS}

    def inputs_of(label):
        inputs, it = by_label[label]
        inputs = dict(inputs)
        return chip_smoke.sweep_inputs(inputs.pop("C", 2), model_y=True, iteration=it,
                                       **inputs)

    for regime in ("CST", "RDM", "GP"):
        cfg, _, _, draws, _ = inputs_of(f"ESS theta, {regime}")
        assert cfg.theta_regime == regime and isinstance(draws.u_theta, gibbs.ThetaESSDraws)
    assert isinstance(inputs_of("collapsed, C=2")[3].cut, gibbs.CollapsedDraws)
    assert isinstance(inputs_of("collapsed, C=5")[3].cut, gibbs.ESSDraws)
    assert inputs_of("collapsed, constant_IRF")[3].cut.u.shape == (3, 1, 9)
    assert isinstance(inputs_of("interleave, ESS sweep")[3].cut, gibbs.ESSDraws)
    assert isinstance(inputs_of("interleave, collapsed sweep")[3].cut, gibbs.CollapsedDraws)
    assert inputs_of("threshold_shift")[3].shift.shape == (3, 1, 9)
    assert inputs_of("mix_subsweeps=2")[3].u_z.shape == (2, 3, 1, 12, 9)
    assert inputs_of("affine, T=1")[3].affine.u_pick.shape == (3, 11)


def test_tie_rule_lets_through_only_a_float32_tie():
    """A chain whose theta differs passes when the CPU's perturbed float32
    runs change it too, and fails when they do not."""
    cfg, _, state0, _, _ = chip_smoke.sweep_inputs(2, model_y=True)
    cpu_state = state0
    card = state0._replace(theta_idx=state0.theta_idx.clone())
    card.theta_idx[1, 0, 4] += 1
    moved = cpu_state.theta_idx.clone()
    moved[1, 0, 4] -= 1

    def run64():
        return cpu_state, None

    keep = chip_smoke.tie_rule("test", cfg, card, cpu_state, None, run64,
                               [(cpu_state.theta_idx, None), (moved, None)])
    assert keep.tolist() == [True, False, True]
    with pytest.raises(RuntimeError, match="float32 tie"):
        chip_smoke.tie_rule("test", cfg, card, cpu_state, None, run64,
                            [(cpu_state.theta_idx, None)])


def test_new_paths_at_reduced_size(capsys):
    """Phases 27-29 on the CPU at 2 chains and 10 sweeps: the ESS theta
    path's one theta ESS a sweep, interleave's kernel calls on every 4th
    sweep, the affine run's counters; the plain version runs, so no launch
    is counted."""
    rm, cpu = _small_votes(), torch.device("cpu")
    launches, args, res = chip_smoke.theta_ess_path(rm, cpu, "cpu", chains=2, burn=2, draws=8)
    assert launches == 0 and res["rounds_per_sweep"] >= 1 and res["syncs_per_sweep"] >= 1
    assert tuple(args[0].shape) == (2, 1, 20, 8)
    launches, rate = chip_smoke.interleave_path(rm, cpu, "cpu", chains=2, burn=2, draws=8)
    assert launches == 0 and rate > 0
    launches, ess_ratio, wall_ratio = chip_smoke.affine_path(rm, cpu, "cpu", chains=2,
                                                             burn=2, draws=8, shift_max=3)
    assert launches == 0 and ess_ratio > 0 and wall_ratio > 0
    text = capsys.readouterr().out
    assert "theta ESS rounds" in text and "orbit accept rate" in text
