"""Tempering and the campaigns on a mesh in the port against its own
unsharded runs, in float64 on the CPU (parallel/tempering.py,
parallel/smc.anneal_init_batched over a campaign axis, campaigns.py).

One world of 2 Gloo ranks (``_torch_mesh_worker.tempering_world``) runs
every case of this module; the unsharded runs it is held to run here. A
chain mesh and a campaign mesh draw every lane's numbers from the one
replicated generator and keep their block, so they equal one process bit
for bit; a model axis draws its shard-local numbers from its own streams,
so there the fields it replicates must be alike on its shards.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a process)
import _torch_dist_worker as w
import _torch_mesh_worker as mw
from gpirt_tpu_torch.parallel import distributed as tdist
from gpirt_tpu_torch.parallel import smc
from gpirt_tpu_torch.utils.checkpoint import CheckpointManager

WORLD = 2
K, n, m = w.K, w.n, w.m


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 2-rank world started in a thread, and the unsharded runs it is
    held to made here meanwhile."""
    tmp = str(tmp_path_factory.mktemp("tempering_world"))
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(tdist.launch, mw.tempering_world, WORLD, (tmp,), device="cpu",
                            timeout=600)
        want = {"pt": mw.tempered_call(),
                "ck": mw.tempered_call(manager=CheckpointManager(
                    os.path.join(tmp, "plain_full.npz")))}
        states, info = smc.anneal_init_batched(mw.anneal_gens(), *w.chain_setup(),
                                               **mw.ANNEAL)
        want["anneal"] = ({k: v.numpy() for k, v in states._asdict().items()}, info)
        want["camp"] = mw.campaign_call()
        assert ranks.result() == list(range(WORLD))
    ranks = [dict(np.load(os.path.join(tmp, f"pt_rank{r}.npz"))) for r in range(WORLD)]
    return want, ranks


def test_tempered_chain_mesh_equals_one_process(world):
    """run_tempered_chains on a 2-rank chain mesh (2 whole groups of 2
    lanes a rank): the cold draws and the swap rates are the unsharded
    run's, bit for bit, on both ranks."""
    want, ranks = world
    for z in ranks:
        for k, v in want["pt"].items():
            np.testing.assert_array_equal(z[f"pt_chain_{k}"], v)
    assert want["pt"]["swap_rate"].sum() > 0


@pytest.mark.parametrize("tag", ["items", "resp"])
def test_tempered_model_shards_stay_replicated(world, tag):
    """A tempered run on 2 item shards or 2 respondent shards: theta alike
    on the item shards, beta, the cutpoints and f* alike on the respondent
    shards, the swap tally alike on both ranks (one decision a group), and
    the gathered draws the same on both, in the unsharded run's layout."""
    want, ranks = world
    a, b = ranks
    fields = ("theta_idx",) if tag == "items" else ("beta", "thresholds", "fstar")
    for f in fields:
        np.testing.assert_array_equal(a[f"blk_{tag}_{f}"], b[f"blk_{tag}_{f}"])
    np.testing.assert_array_equal(a[f"blk_{tag}_acc"], b[f"blk_{tag}_acc"])
    for k, v in want["pt"].items():
        np.testing.assert_array_equal(a[f"pt_{tag}_{k}"], b[f"pt_{tag}_{k}"])
        assert a[f"pt_{tag}_{k}"].shape == v.shape and not np.isnan(a[f"pt_{tag}_{k}"]).any()


@pytest.mark.parametrize("tag", ["items", "resp"])
def test_tempered_model_mesh_equals_unsharded_fed_its_numbers(world, tag):
    """The tempered driver at L = 4 on 2 item shards or 2 respondent
    shards, fed the unsharded run's numbers cut to the rank's items or
    respondents, against the port's unsharded driver from the same state
    and generator, over 6 sweeps each with a swap phase: the swap tally
    exactly, theta exactly, the cold draws and the rank's block of the
    state within 1e-10 (a swap on misaligned temperatures or a sweep's
    numbers cut wrongly shows here)."""
    _, ranks = world
    for z in ranks:
        mw.check_fed_case(z, tag)


@pytest.mark.parametrize("tag", ["chain", "items"])
def test_checkpointed_tempered_mesh_resumes_bit_for_bit(world, tag):
    """run_tempered_chains_checkpointed on a chain mesh and on 2 item
    shards, cut after 2 draws and resumed on the same mesh, equals the
    uninterrupted run (the file holds the whole ensemble, the gathered
    tally and each item shard's generator state); on the chain mesh both
    equal the unsharded checkpointed run."""
    want, ranks = world
    for z in ranks:
        for k, v in want["ck"].items():
            np.testing.assert_array_equal(z[f"ck_resumed_{tag}_{k}"], z[f"ck_full_{tag}_{k}"])
            if tag == "chain":
                np.testing.assert_array_equal(z[f"ck_full_{tag}_{k}"], v)


@pytest.mark.parametrize("tag", ["items", "resp"])
def test_gpirt_mcmc_tempered_on_a_model_mesh(world, tag):
    """gpirt_mcmc(mesh, n_temps=4) with item_axis and with respondent_axis:
    every rank returns the same chain dicts in the reference layout, with
    swap rates."""
    _, ranks = world
    z0 = ranks[0]
    assert z0[f"mcmc_{tag}_theta"].shape == (K, 6, n, 1)
    assert z0[f"mcmc_{tag}_beta"].shape == (K, 6, 3, m, 1)
    assert np.isfinite(z0[f"mcmc_{tag}_ll"]).all()
    for k in ("theta", "beta", "threshold", "ll"):
        np.testing.assert_array_equal(ranks[1][f"mcmc_{tag}_{k}"], z0[f"mcmc_{tag}_{k}"])
    if tag == "resp":
        assert z0["mcmc_resp_swap_rate"].shape == (3,)


def test_theta_ess_and_affine_run_on_item_shards(world):
    """gpirt_mcmc(theta_method="ess") and run_chains with the affine moves
    (W 3, 2 rounds) on 2 item shards, which an item axis refused before:
    both ranks return the same finite draws, and the orbit draws accept."""
    _, ranks = world
    a, b = ranks
    for k in ("theta", "beta", "threshold", "ll"):
        np.testing.assert_array_equal(a[f"mcmc_items_ess_{k}"], b[f"mcmc_items_ess_{k}"])
        np.testing.assert_array_equal(a[f"items_affine_{k}"], b[f"items_affine_{k}"])
    assert a["mcmc_items_ess_theta"].shape == (K, 6, n, 1)
    assert np.isfinite(a["mcmc_items_ess_ll"]).all() and np.isfinite(a["items_affine_ll"]).all()
    assert int(a["affine_orbit_accepted"]) > 0


def test_batched_anneal_over_a_campaign_axis_equals_one_process(world):
    """anneal_init_batched over a 2-rank campaign axis (2 of 4 campaigns a
    rank): each rank's states are the unsharded call's campaigns, and the
    info rows of every campaign, gathered in campaign order, equal its."""
    want, ranks = world
    states, info = want["anneal"]
    for r, z in enumerate(ranks):
        for k, v in states.items():
            np.testing.assert_array_equal(z[f"anneal_{k}"], v[2 * r:2 * r + 2])
        for k, v in info.items():
            np.testing.assert_array_equal(z[f"anneal_info_{k}"], v)
    assert (info["n_resamples"] > 1).any()


def test_gpirt_campaigns_on_a_campaign_mesh_equals_one_process(world):
    """gpirt_campaigns(mesh=make_campaign_mesh()) on 2 ranks: the grand
    mean, its SE, the campaign means, the anneal's final weight ESS and
    resample counts and the draws are the unsharded call's, bit for bit,
    on both ranks, in its layout."""
    want, ranks = world
    c = want["camp"]
    for z in ranks:
        assert list(z["camp_names"]) == ["campaigns"]
        for k in ("theta_mean", "theta_se", "campaign_means", "final_weight_ess",
                  "n_resamples", "ess_campaign"):
            np.testing.assert_array_equal(z[f"camp_{k}"], np.asarray(c[k]))
        for k, v in c["draws"].items():
            np.testing.assert_array_equal(z[f"camp_draws_{k}"], v)
    assert c["campaign_means"].shape == (2, n, 1)


# each case and what it must raise: the refusals JAX still makes on a mesh,
# and (None) a case that runs now
REFUSALS = {"groups_indivisible": ("ValueError", "do not divide over 2 chain shards"),
            "campaigns_indivisible": ("ValueError", "campaigns do not divide"),
            "theta_ess_tempered": ("NotImplementedError",
                                   "tempering needs theta_method='grid'"),
            "resume_other_item_count": None}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_mesh_refusals(world, case):
    """3 tempered groups over 2 chain shards and 3 campaigns over 2
    campaign shards (ValueError, as JAX) and ESS theta under tempering
    (NotImplementedError, as JAX) are refused; a tempered checkpoint of 2
    item shards resumes on a chain mesh of 1 item shard: its cold draws
    alike on both ranks, finite, in the unsharded run's layout
    (``test_torch_resume_counts.py`` checks the streams)."""
    want, ranks = world
    if REFUSALS[case] is None:
        for z in ranks:
            assert str(z[f"refusal_{case}"]) == "no error", str(z[f"refusal_{case}"])
            for k, v in want["pt"].items():
                np.testing.assert_array_equal(z[f"pt_other_count_{k}"],
                                              ranks[0][f"pt_other_count_{k}"])
                assert z[f"pt_other_count_{k}"].shape == v.shape
                if k != "threshold":  # the cutpoints' ends are -inf and inf
                    assert np.isfinite(z[f"pt_other_count_{k}"]).all()
        return
    kind, text = REFUSALS[case]
    for z in ranks:
        got = str(z[f"refusal_{case}"])
        assert got.startswith(kind + ":") and text in got, got
