"""chip_smoke.py's phases 46-51 (ESS theta and the affine moves on 2 item
shards, tempering on a chain mesh and on 2 x 2 items x respondents, the
campaigns on a campaign mesh, a resume across shard counts, a sweep's
lanes against its batch, each sweep family on a chain mesh) at a reduced
size on the CPU, in a file of their own so that a parallel run gives their
Gloo worlds a worker of their own."""

import glob
import json
import os

import numpy as np
import torch

import _torch_threads  # noqa: F401  (one torch thread a process)
import chip_smoke
from gpirt_tpu_torch.models import gibbs
from gpirt_tpu_torch.utils.datasets import simulate_dynamic
from test_torch_chip_smoke import _small_votes


def test_later_mesh_phases_at_reduced_size(capsys, monkeypatch, tmp_path):
    """Phases 46-48 and 50 as stages of one world of 2 ranks, phase 49 in a
    world of 4 and phase 51 here, on the CPU at 4 chains of a 20 x 8 matrix
    (phase 19's call at 4 groups of 4 temperatures, burn 2 and 6 draws;
    campaigns8 at 8 campaigns of 2 chains): the item-sharded ESS theta and
    affine (W 3) sweeps against the unsharded ones with theta equal in every
    chain; the ESS theta call alike on both ranks; the tempered chain mesh
    hashing to the unsharded call's draws and swap rates; the campaign mesh
    bit for bit the unsharded call and its one-process reference at the
    ranks' batch; the tempered 2 x 2 mesh continued from a lane state with
    its replicated fields alike; phase 50's run (burn 2, 6 draws, a
    checkpoint every 2 sweeps, cut after sweep 4) resumed without a mesh and
    on 2 respondent shards with its gates; phase 51's 16 lanes against
    batches of 8, every block bit for bit. At this size posterior means are
    noise between two runs, so the r gates are set to -1 here, and phase
    22's agreement rule (senate116's JAX fixture) is replaced by a stub;
    the plain version runs, so no launch is counted."""
    monkeypatch.setattr(chip_smoke, "MESH_MIN_R", -1.0)
    monkeypatch.setattr(chip_smoke, "CK_DIR", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "AFFINE_W", 3)
    monkeypatch.setattr(chip_smoke, "CONT_DRAWS", 3)
    monkeypatch.setattr(chip_smoke, "THETA_EQUAL_MIN", 4)
    monkeypatch.setattr(chip_smoke, "campaign_agreement", lambda out: (1.0, 0.0, 20))
    rm, cpu = _small_votes(), torch.device("cpu")
    pt = dict(chains=4, burn=2, draws=6)
    _, _, _, pt_sha, pt_means = chip_smoke.tempering_path(rm, cpu, "cpu", **pt)
    schedule = dict(n_chains=2, smc_steps=3, burn_iterations=1, sample_iterations=4)
    camp, _ = chip_smoke.campaigns8(rm, cpu, "cpu", **schedule)
    camp_ref = chip_smoke.campaign_blocks_reference(rm, cpu, **schedule)
    _, cfg, consts = chip_smoke.main_config(rm, cpu)
    state = gibbs.init_state(torch.linspace(-1, 1, 20).expand(4, 1, 20),
                             torch.as_tensor(chip_smoke.default_thresholds(2, 8, 1)),
                             consts, cfg, gibbs.init_draws(torch.Generator().manual_seed(0),
                                                           4, consts, cfg))
    two = chip_smoke.two_rank_phases(
        rm, cpu, "cpu", state, None, None, None, chains=4, phases=(46, 47, 48, 50),
        later={"pt_sha": pt_sha, "camp20": camp, "camp_ref": camp_ref, "schedule": schedule},
        mesh2=(2, 4), pt=(2, 6), rc=(2, 6, 2, 4))
    for errs in two[46]["sweeps"].values():
        assert errs["chains_theta_equal"] == 4 and errs["thresholds"] < 1e-3
    assert two[46]["launches"] == [0, 0] and two[46]["flipped"] == 0
    assert two[47]["launches"] == [0, 0] and two[48]["launches"] == [0, 0]
    assert two[50]["launches"] == [{"items2": 0, "items2_cut": 0, "resp2_resumed": 0}] * 2
    assert two[50]["launches_resumed_alone"] == 0 and np.isfinite(two[50]["r_resp2"])
    batch51 = chip_smoke.batch_invariance_phase(rm, cpu, "cpu", chains=2, chunk=8,
                                                families=())
    assert batch51["blocks"] == len(chip_smoke.SWEEP_BLOCKS) + 1
    assert len(batch51["labels"]) == 4
    lanes = gibbs.init_state(torch.linspace(-1, 1, 20).expand(16, 1, 20),
                             torch.as_tensor(chip_smoke.default_thresholds(2, 8, 1)),
                             consts, cfg, gibbs.init_draws(torch.Generator().manual_seed(1),
                                                           16, consts, cfg))
    four = chip_smoke.mesh_2x2(rm, cpu, "cpu", None, chains=4, phases=(49,),
                               tempered={"lanes": lanes, "means": pt_means}, mesh2=(2, 4))
    assert four[49]["launches"] == [0] * 4 and len(four[49]["swap_rate"]) == 3
    assert {"swap ll", "theta table"} <= set(four[49]["allreduce_sites"])
    assert two[46]["allreduce_ms"] > 0
    assert np.isfinite(four[49]["r_continued"])
    keys = chip_smoke.later_keys(two[46], two[47], two[48], four[49])  # the kernels line's
    assert json.loads(json.dumps(keys))["launches_items2_resp2_tempering"] == [0] * 4
    text = capsys.readouterr().out
    assert "phase 46 (theta_ess) on cpu" in text and "phase 46 (affine) on cpu" in text
    assert "phases 46, 47, 48, 50 in one world of 2 ranks" in text
    assert "sha256 = phase 19's on every rank" in text
    assert "every field bit for bit phase 20's batch of all 8" in text
    assert two[48]["bitwise"] and two[48]["reference_bitwise"]
    assert "the one-process reference at the ranks' batch agrees bit for bit" in text
    assert "phase 50 on cpu: phase 5's configuration continued from its last state" in text
    assert "phase 51 on cpu: one sweep of campaigns8's 16 lanes against batches of 8" in text
    assert "phase 49 on cpu: phase 19's tempering on a 2 x 2 items x respondents" in text
    assert glob.glob(os.path.join(str(tmp_path), ".chip_smoke_ck_*")) == []


def _small_families(monkeypatch):
    """The sweep families' SDO and dynamic cells at 20 respondents and 8
    items (C = 5; 3 sessions): their data loaders replaced."""
    rng = np.random.default_rng(4)
    sdo = rng.integers(1, 6, (20, 8)).astype(np.float64)
    sdo[rng.random(sdo.shape) < 0.1] = np.nan
    sdo[0, :5] = np.arange(1, 6)  # every category observed
    truth, raw = simulate_dynamic(0, n=20, m=8, horizon=3, missing=0.1)
    monkeypatch.setattr(chip_smoke, "load_sdo", lambda: sdo)
    monkeypatch.setattr(chip_smoke, "dynamic_inputs",
                        lambda: (truth, raw, chip_smoke.spread_init(20)))


def test_family_phases_at_reduced_size(capsys, monkeypatch, tmp_path):
    """Phase 51's sweep families (FAMILY_CASES) and phase 52 on the CPU at
    reduced cells (a 20 x 8 matrix for senate116's, SDO's and the dynamic
    cube's 20 x 8 x 3): each family's sweep on 8 lanes against batches of
    4, every block bit for bit; each family on a 2-rank chain mesh (4
    chains, burn 2, 6 draws) hashing to the one-process call, and the
    shared-IRF run cut on the mesh after 4 sweeps and resumed here without
    one to the uninterrupted call; the plain version runs, so no launch is
    counted."""
    monkeypatch.setattr(chip_smoke, "CK_DIR", str(tmp_path))
    _small_families(monkeypatch)
    rm, cpu = _small_votes(), torch.device("cpu")
    batch51 = chip_smoke.batch_invariance_phase(rm, cpu, "cpu", chains=2, chunk=8, lanes=8,
                                                chunks=(4,))
    assert set(batch51["families"]) == set(chip_smoke.FAMILIES)
    for name, cases in batch51["families"].items():
        assert len(cases) == len(chip_smoke.FAMILY_CASES[name])
    refs = chip_smoke.family_references(rm, cpu, dict(chains=4, burn=2, draws=6, cut=2))
    two = chip_smoke.two_rank_phases(rm, cpu, "cpu", None, None, None, None, chains=4,
                                     phases=(52,), later={"families": refs})
    assert two[52]["bitwise"] and two[52]["launches_resumed"] == 0
    assert two[52]["launches"] == {name: [0, 0] for name in chip_smoke.FAMILIES}
    text = capsys.readouterr().out
    assert "phase 51, sdo: one sweep of 8 chains against batches of 4" in text
    assert "phase 52 on cpu: 7 sweep families on a chain mesh of 2 ranks" in text
    assert "resumed here without one for 4 sweeps" in text
    assert glob.glob(os.path.join(str(tmp_path), ".chip_smoke_ck_*")) == []
