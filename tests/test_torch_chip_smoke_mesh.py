"""chip_smoke.py's phases 38-41 (the items over 2 ranks, a 2 x 2 chains x
items mesh, a chain mesh) at a reduced size on the CPU, in a file of their
own so that a parallel run gives their Gloo worlds a worker of their own."""

import glob
import os

import pytest
import torch

from _torch_threads import default_blas_threads  # noqa: F401  (a fixture)
import chip_smoke
from gpirt_tpu_torch.models import gibbs
from test_torch_chip_smoke import _small_votes

# the host constants at the BLAS thread count phase 38's check was set at
pytestmark = pytest.mark.usefixtures("default_blas_threads")


def test_mesh_phases_at_reduced_size(capsys, monkeypatch, tmp_path):
    """Phases 38-41 on the CPU at 4 chains of a 20 x 8 matrix, SMC 3 steps,
    burn 2 and 6 draws, through the launcher on Gloo (phases 38, 39 and 41
    as the three stages of one world of 2 ranks, phase 40 a world of 4):
    the item-sharded sweep against the unsharded one, bit for bit; the
    item-sharded and 2 x 2 runs' lanes a rank, theta the same on every
    rank; a chain block's sweep and the chain mesh's draws, cut at 2 draws,
    bit for bit the unsharded ones, and resumed with no mesh to the
    unsharded call's. At this size posterior means are noise between two
    runs, so phases 39-40's r gate is set to -1 here (on the CPU, phase
    41's sha256 is the gate); the plain version runs, so no launch is
    counted."""
    monkeypatch.setattr(chip_smoke, "MESH_MIN_R", -1.0)
    monkeypatch.setattr(chip_smoke, "CK_DIR", str(tmp_path))
    rm, cpu = _small_votes(), torch.device("cpu")
    small = dict(chains=4, burn=2, draws=6, smc_steps=3)
    ref = chip_smoke.main_call(rm, cpu, verbose=False, **small)
    want, means = chip_smoke.draws_sha256(ref), chip_smoke.theta_means(ref)
    want_cut = chip_smoke.draws_sha256([{k: d[k][:2] for k in ("theta", "beta", "threshold",
                                                                "ll")} for d in ref])
    _, cfg, consts = chip_smoke.main_config(rm, cpu)
    gen = torch.Generator().manual_seed(0)
    state = gibbs.init_state(torch.linspace(-1, 1, 20).expand(4, 1, 20),
                             torch.as_tensor(chip_smoke.default_thresholds(2, 8, 1)),
                             consts, cfg, gibbs.init_draws(gen, 4, consts, cfg))
    two = chip_smoke.two_rank_phases(rm, cpu, "cpu", state, want, want_cut, means, cut=2,
                                     every=2, **small)
    (worst, flipped), it2, cm = two[38], two[39], two[41]
    assert (worst, flipped) == (0.0, 0)
    assert it2["launches"] == [0, 0] and it2["lanes"] == 4 * 4
    assert it2["backend"] == "cpu:gloo" and it2["allreduce_bytes"] == 4 * 1001 * 20 * 4
    sweeps = chip_smoke.WARM_STEPS + 3 - 1 + 2 + 6  # one table all_reduce a sweep
    assert it2["allreduce_calls"] == sweeps and it2["allreduce_ms"] > 0
    assert cm["bitwise"] and cm["block_bitwise"] and cm["launches"] == [0, 0]
    mesh = chip_smoke.mesh_2x2(rm, cpu, "cpu", means, **small)[40]
    assert mesh["launches"] == [0] * 4 and mesh["lanes"] == 2 * 4
    text = capsys.readouterr().out
    assert "sharded sweep check on cpu" in text and "bit for bit True" in text
    assert "phase 40 on cpu: 2 x 2 chains x items mesh, 4 ranks" in text
    assert "phases 38, 39, 41 in one world of 2 ranks" in text
    assert glob.glob(os.path.join(str(tmp_path), ".chip_smoke_ck_*")) == []
