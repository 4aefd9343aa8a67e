"""The port's multi-process layer (gpirt_tpu_torch/parallel/distributed.py,
parallel/chains.py) on the CPU: the backend rule, the launcher, and chains
over a 2-rank Gloo world against one process.

One world of 2 ranks (``_torch_dist_worker.chains_world``) runs every
case of this module; each case reads its ranks' outputs. The counterpart of
``tests/test_distributed.py``: there the stitched shards agree with a
single process to reduction-order rounding, here the chain mesh is the
unsharded run bit for bit (one generator draws every chain's numbers in the
order one process does, and each CPU operation of a sweep is per chain).
"""

import hashlib
import os

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a process)
import _torch_dist_worker as w
from gpirt_tpu_torch.models.sampler import run_chains
from gpirt_tpu_torch.parallel import distributed as tdist
from gpirt_tpu_torch.utils.diagnostics import effective_sample_size_device

WORLD = 2
CK = dict(checkpoint_every=3, smc_steps=6, smc_max_temp=8.0, item_axis=None)


def _hash(chains):
    h = hashlib.sha256()
    for d in chains:
        for k in ("theta", "beta", "threshold", "ll"):
            h.update(np.ascontiguousarray(d[k]).tobytes())
    return h.hexdigest()


def _stacked(prefix, z):
    return [{k: z[f"{prefix}_{k}"][c] for k in ("theta", "beta", "threshold", "ll")}
            for c in range(w.K)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The unsharded references in this process, an interrupted unsharded
    checkpoint for the ranks to resume, then the 2-rank world."""
    tmp = str(tmp_path_factory.mktemp("chains_world"))
    yt, ti, thr, consts, cfg = w.chain_setup()
    ref = {"rc": run_chains(torch.Generator().manual_seed(3), yt, ti, thr, consts, cfg,
                            **w.RUN),
           **{f"rc_{name}": run_chains(torch.Generator().manual_seed(3),
                                       *w.chain_setup(**fields), **w.RUN)
              for name, fields in w.CHAIN_FAMILIES.items()},
           "mcmc": w._mcmc(None, item_axis=None, smc_steps=6, smc_max_temp=8.0),
           "multihost": run_chains(torch.Generator().manual_seed(5), yt,
                                   ti[0].expand(w.K, 1, w.n), thr, consts, cfg, **w.RUN),
           "full": w._mcmc(None, checkpoint_path=os.path.join(tmp, "plain_full"), **CK)}
    w._mcmc(None, sample_iterations=2, checkpoint_path=os.path.join(tmp, "plain_cut"), **CK)
    ranks = tdist.launch(w.chains_world, WORLD, (tmp,), device="cpu", timeout=300)
    assert ranks == list(range(WORLD))
    ranks = [dict(np.load(os.path.join(tmp, f"chains_rank{r}.npz"))) for r in range(WORLD)]
    return tmp, ref, ranks


def test_initialize_is_a_no_op_in_one_process():
    assert tdist.initialize_distributed(device="cpu") == 1
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("device_type, local_world, cards, backend", [
    ("cpu", 4, 0, "cpu:gloo"),
    ("cuda", 2, 1, "cpu:gloo,cuda:gloo"),
    ("cuda", 4, 4, "cpu:gloo,cuda:nccl"),
])
def test_backend_rule(device_type, local_world, cards, backend):
    """NCCL only where every rank of a host has a card of its own; ranks
    that share a card take Gloo; CPU tensors always Gloo."""
    assert tdist.backend_for(device_type, local_world, cards) == backend


def test_launcher_raises_when_a_rank_fails():
    with pytest.raises(RuntimeError, match=r"(?s)rank 1 of 2 failed.*on purpose"):
        tdist.launch(w.fail_on_rank_one, 2, device="cpu", timeout=120)


def test_launcher_defaults_to_the_card_and_raises_without_one(monkeypatch):
    """With no device named the ranks run on the card; with no card the
    launcher raises before it starts a rank, and never runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a card"):
        tdist.launch(w.fail_on_rank_one, 2, timeout=120)


@pytest.mark.parametrize("stages", [None, (30, 0.5)])
def test_launcher_raises_past_its_timeout(stages):
    """Past the timeout, or past a stage's own (stage 0 ends at once, stage
    1 sleeps past its 0.5 s), every rank is stopped and the parent raises."""
    if stages is None:
        with pytest.raises(TimeoutError, match="not done within 2 s"):
            tdist.launch(w.sleep_past_the_timeout, 2, (60,), device="cpu", timeout=2)
    else:
        with pytest.raises(TimeoutError, match=r"not done within 0.5 s \(stage 1\)"):
            tdist.launch(w.sleep_in_stage, 2, (60,), device="cpu", stages=stages)


def test_chain_mesh_layout(world):
    _, _, ranks = world
    for r, z in enumerate(ranks):
        assert list(z["names"]) == ["chains"] and list(z["global_names"]) == ["chains"]
        assert int(z["world"]) == WORLD
        assert list(z["bounds"]) == [r * w.K // WORLD, (r + 1) * w.K // WORLD]
        assert bool(z["roundtrip"])


def test_chain_mesh_run_chains_is_the_unsharded_run(world):
    """run_chains(mesh=...) on 2 ranks: every rank returns every chain, bit
    for bit the single-process run from the same generator, for the
    conjugate sweep and for a non-conjugate family (the two-stage sweep,
    ``_torch_dist_worker.CHAIN_FAMILIES``)."""
    _, ref, ranks = world
    for z in ranks:
        for run in ["rc"] + [f"rc_{name}" for name in w.CHAIN_FAMILIES]:
            for k, v in ref[run].items():
                np.testing.assert_array_equal(z[f"{run}_{k}"], v.numpy(), err_msg=run)


def test_chain_mesh_smc_pipeline_is_the_unsharded_run(world):
    """gpirt_mcmc(mesh=chain mesh, smc_steps=...): the anneal's weights are
    gathered over the chain shards and a resample gathers the lanes, so
    the run equals the single-process one bit for bit."""
    _, ref, ranks = world
    for z in ranks:
        assert _hash(_stacked("mcmc", z)) == _hash(ref["mcmc"])


def test_run_chains_multihost_matches_run_chains(world):
    """Chain k's numbers come from the one generator seeded 5, as one
    process draws them (the counterpart of JAX's key(seed + k))."""
    _, ref, ranks = world
    for z in ranks:
        np.testing.assert_array_equal(z["multihost_theta"], ref["multihost"]["theta"].numpy())


def test_pooled_ess_multihost_matches_the_whole_draws(world):
    _, _, ranks = world
    draws = torch.as_tensor(np.random.default_rng(2).standard_normal((w.K, 40, 5)))
    want = effective_sample_size_device(draws).numpy()
    for z in ranks:
        np.testing.assert_allclose(z["pooled_ess"], want, rtol=1e-4)


def test_interrupted_on_a_chain_mesh_resumes_without_one(world):
    """A checkpointed run cut on the 2-rank mesh (its SMC on the mesh)
    resumes in one process and hashes to the uninterrupted run."""
    tmp, ref, _ = world
    resumed = w._mcmc(None, checkpoint_path=os.path.join(tmp, "mesh_cut"), **CK)
    assert _hash(resumed) == _hash(ref["full"])


def test_interrupted_without_a_mesh_resumes_on_one(world):
    _, ref, ranks = world
    for z in ranks:
        assert _hash(_stacked("resumed_on_mesh", z)) == _hash(ref["full"])


@pytest.mark.parametrize("block", ["chains", "items"])
def test_a_ranks_kernel_inputs_are_contiguous(block, monkeypatch):
    """A rank's block of a sweep's draws is a view of the draws of all
    chains (and, fed the unsharded draws, of all items); the CUDA kernel
    reads its inputs through raw pointers, so the sweep hands it contiguous
    tensors (on the card the wrapper raises otherwise; here the plain
    version runs under a spy)."""
    from gpirt_tpu_torch.models import gibbs as tg
    from gpirt_tpu_torch.parallel.items import consts_item_block, draws_item_block
    from gpirt_tpu_torch.parallel.smc import lane_block

    yt, ti, thr, consts, cfg = w.chain_setup()
    gen = torch.Generator().manual_seed(0)
    state = tg.init_state(ti, thr, consts, cfg, tg.init_draws(gen, w.K, consts, cfg))
    draws = tg.sweep_draws(gen, w.K, consts, cfg)
    seen = []
    kernel = tg.binary_threshold_ess

    def spy(*args):
        seen.append(all(a.is_contiguous() for a in args[:7]))
        return kernel(*args)

    monkeypatch.setattr(tg, "binary_threshold_ess", spy)
    if block == "chains":
        own = slice(1, 3)
        tg.gibbs_sweep(tg.GPIRTState(*(a[own] for a in state)), lane_block(draws, own), yt,
                       consts, cfg)
    else:
        items = slice(4, 8)
        st = tg.GPIRTState(state.theta_idx, state.f[..., items], state.beta[..., items],
                           state.thresholds[..., items, :], state.fstar[..., items])
        tg.gibbs_sweep(st, draws_item_block(draws, items), yt[..., items].contiguous(),
                       consts_item_block(consts, items),
                       __import__("dataclasses").replace(cfg, m=4))
    assert seen == [True]
