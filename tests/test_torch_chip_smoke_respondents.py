"""chip_smoke.py's phases 42-45 (the respondent axis) at a reduced size on
the CPU, in a file of their own so that a parallel run gives their Gloo
worlds a worker of their own."""

import glob
import os

import torch

import _torch_threads  # noqa: F401  (one torch thread a process)
import chip_smoke
from gpirt_tpu_torch.models import gibbs
from test_torch_chip_smoke import _small_votes


def test_respondent_phases_at_reduced_size(capsys, monkeypatch, tmp_path):
    """Phases 42-45 on the CPU at 4 chains of a 20 x 8 matrix, SMC 3 steps,
    burn 2 and 6 draws, through the launcher on Gloo (42-44 as the stages
    of one world of 2 ranks, 45 a world of 4), phase 44 at a 300 x 40
    synthetic configuration of 2 chains, burn 2 and 4 draws: the
    respondent-sharded sweep, with the affine moves off and on (W 3),
    against the unsharded one with beta, the cutpoints and f* the same on
    both ranks; no kernel launch; every site's all_reduce counted; phases
    43 and 45's samplers continued from a state, sharded and not. At this
    size posterior means are noise between two runs, so the r gates of
    phases 43-45 are set to -1 here; the plain version runs, so no launch
    is counted."""
    monkeypatch.setattr(chip_smoke, "MESH_MIN_R", -1.0)
    monkeypatch.setattr(chip_smoke, "CK_DIR", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "SYN_MIN_R", -1.0)
    monkeypatch.setattr(chip_smoke, "AFFINE_W", 3)
    monkeypatch.setattr(chip_smoke, "CONT_DRAWS", 3)
    rm, cpu = _small_votes(), torch.device("cpu")
    small = dict(chains=4, burn=2, draws=6, smc_steps=3)
    means = chip_smoke.theta_means(chip_smoke.main_call(rm, cpu, verbose=False, **small))
    _, cfg, consts = chip_smoke.main_config(rm, cpu)
    state = gibbs.init_state(torch.linspace(-1, 1, 20).expand(4, 1, 20),
                             torch.as_tensor(chip_smoke.default_thresholds(2, 8, 1)),
                             consts, cfg, gibbs.init_draws(torch.Generator().manual_seed(0),
                                                           4, consts, cfg))
    size = dict(n=300, m=40, K=2, burn=2, draws=4)
    syn = chip_smoke.synthetic_inputs(cpu, size["n"], size["m"], size["K"])
    out, _, _, _ = chip_smoke.synthetic_run(cpu, syn, burn=size["burn"], draws=size["draws"])
    syn16 = {"sweeps_per_s": 1.0, "peak_gib": 0.0, "means": chip_smoke.run_means(out["theta"])}
    two = chip_smoke.two_rank_phases(rm, cpu, "cpu", state, None, None, means,
                                     phases=(42, 43, 44), resp={"rates": {"phase 5": 1.0},
                                                                "syn16": syn16,
                                                                "syn_size": size},
                                     mesh_burn=2, mesh_draws=6, **small)
    assert set(two[42]) == {"plain", "affine"}
    for errs in two[42].values():
        assert errs["chains_theta_equal"] == 4 and errs["thresholds"] < 1e-3
    for phase in (43, 44):
        assert two[phase]["launches"] == [0, 0]
    sites = two[43]["allreduce_sites"]
    sweeps = chip_smoke.WARM_STEPS + 3 - 1 + 2 + 6
    assert sites["ll"][0] == 1 and sites["f* U^T r, U^T U"][0] == 1
    assert sites["beta moments"][0] == 2 and sites["beta X^T X, X^T z"][0] == 1
    assert sites["SMC reweight ll"][0] == (3 - 1) / sweeps
    assert sites["cutpoint ESS round"][0] >= 2 and two[43]["ess_rounds"] >= 1
    assert set(two[44]["allreduce_sites"]) == {"ll", "f* U^T r, U^T U", "beta moments",
                                               "beta X^T X, X^T z", "cutpoint ESS round"}
    four = chip_smoke.mesh_2x2(rm, cpu, "cpu", means, phases=(45,), rates={"phase 5": 1.0},
                               state=state, resp_size=(small["burn"], small["draws"]), **small)
    assert four[45]["launches"] == [0] * 4 and "theta table" in four[45]["allreduce_sites"]
    text = capsys.readouterr().out
    assert "respondent-sharded sweep check (affine) on cpu" in text
    assert "phase 43 on cpu: 2 respondent shards" in text
    assert "continued from phase 5's last state for 3 draws" in text
    assert "phase 45 on cpu: 2 x 2 items x respondents mesh, 4 ranks" in text
    assert "phase 44 on cpu: the synthetic configuration (300 x 40" in text
    assert glob.glob(os.path.join(str(tmp_path), ".chip_smoke_ck_*")) == []
