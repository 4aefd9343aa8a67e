"""What the ranks of ``test_torch_resume_counts.py`` run, and the runs the
test makes in its own process, in a module that imports no JAX: a
checkpoint cut on one layout of item and respondent shards (or on none)
and resumed on another, by the stream rule of ``utils/checkpoint.py``; and
a verbose gpirt_mcmc on a mesh, advancing in chunks on every rank.

Sizes are the JAX package's cross-mesh resume test's
(``tests/test_checkpoint.py:330-337``): n 10 respondents, m 8 items,
binary, float64, K 4 chains, a 61-point grid. A run burns 2 sweeps and
keeps 6 draws, checkpointing every 2 sweeps; the cut run keeps CUT draws,
and the second cut, on the resumed layout, CUT2.
"""

import os
import shutil

import numpy as np
import torch
import torch.distributed as dist

import _torch_dist_worker as w
from gpirt_tpu_torch import gpirt_mcmc
from gpirt_tpu_torch.api import default_thresholds
from gpirt_tpu_torch.models.config import GPIRTConfig, make_constants
from gpirt_tpu_torch.models.sampler import (
    Carry,
    advance_chains,
    chain_start,
    run_length,
    sample_schedule,
)
from gpirt_tpu_torch.parallel.chains import Shards, lane_state_block, shards_of
from gpirt_tpu_torch.parallel.items import make_item_mesh
from gpirt_tpu_torch.parallel.respondents import make_respondent_mesh, resume_shard_generators
from gpirt_tpu_torch.parallel.tempering import advance_tempered, tempered_start
from gpirt_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    run_chains_checkpointed,
    run_tempered_chains_checkpointed,
)

n, m, K, N = 10, 8, 4, 61
SEED, BURN, DRAWS, CUT, CUT2, EVERY = 13, 2, 6, 2, 4, 2
TEMPS, MAX_TEMP = 2, 4.0
RESP = "respondents"
WORLD = 4
# the layouts on the 4-rank world: (mesh builder, item axis, respondent axis);
# "none" is one process without a mesh
LAYOUTS = {"none": (None, None, None),
           "items2": (lambda: make_item_mesh(2, 2, device="cpu"), "items", None),
           "resp2": (lambda: make_respondent_mesh(2, n_chain_shards=2, device="cpu"), None,
                     RESP),
           "items2_resp2": (lambda: make_respondent_mesh(2, n_item_shards=2, device="cpu"),
                            "items", RESP)}
# each case: (the layout cut on, the layout resumed on, tempered)
CASES = {"items2_to_none": ("items2", "none", False),
         "none_to_items2": ("none", "items2", False),
         "resp2_to_none": ("resp2", "none", False),
         "none_to_resp2": ("none", "resp2", False),
         "items2_resp2_to_items2": ("items2_resp2", "items2", False),
         "tempered_items2_to_none": ("items2", "none", True)}


def setup():
    """y (1, n, m), theta_init (K, 1, n), thresholds, constants, config."""
    y = w.votes(n=n, m=m)
    yt = torch.as_tensor(np.nan_to_num(y, nan=0.0)[None].astype(np.int32))
    cfg = GPIRTConfig(n=n, m=m, horizon=1, C=2, grid_size=N, dtype="float64")
    consts = make_constants(cfg, np.zeros((3, m)), np.full((3, m), 3.0), np.zeros((2, n)),
                            np.full((2, n), 0.5), device="cpu")
    ti = torch.as_tensor(np.random.default_rng(1).uniform(-1, 1, (K, 1, n)))
    return yt, ti, torch.as_tensor(default_thresholds(2, m, 1)), consts, cfg


def _mesh(layout):
    build, item_axis, resp_axis = LAYOUTS[layout]
    return dict(mesh=None if build is None else build(), item_axis=item_axis,
                respondent_axis=resp_axis)


def run(layout, path, draws, tempered=False):
    """The checkpointed driver on ``layout`` keeping ``draws`` draws, its
    file ``path``; returns its host draws (swap_rate dropped)."""
    gen = torch.Generator().manual_seed(SEED)
    kw = dict(sample_iterations=draws, burn_iterations=BURN, manager=CheckpointManager(path),
              checkpoint_every=EVERY, **_mesh(layout))
    if tempered:
        out = run_tempered_chains_checkpointed(gen, *setup(), n_temps=TEMPS,
                                               max_temp=MAX_TEMP, **kw)
        out.pop("swap_rate")
        return out
    return run_chains_checkpointed(gen, *setup(), **kw)


def fed(layout, path, tempered=False):
    """The resumed layout's driver run from the checkpoint ``path`` by hand:
    its state, the saved replicated generator state, and the shard
    generators of the stream rule (``resume_shard_generators``) at the
    file's sweep, from that sweep to the end of a DRAWS-draw run. Returns
    the draws of those sweeps."""
    ck = CheckpointManager(path).load()
    yt, ti, thr, consts, cfg = setup()
    gen = torch.Generator().manual_seed(SEED)
    it0 = int(ck.meta["iteration"])
    mesh = _mesh(layout)
    sg = None if mesh["mesh"] is None else resume_shard_generators(
        SEED, shards_of(*mesh.values()), it0, "cpu")
    gen.set_state(torch.from_numpy(ck.rng_state))
    sched = sample_schedule(DRAWS, BURN, 1)
    if tempered:
        st = tempered_start(gen, ti, thr, yt, consts, cfg, TEMPS, MAX_TEMP, *mesh.values(),
                            shard_gens=sg)
        shards = Shards() if st.shards is None else st.shards
        carry = Carry(ck.state if shards == Shards() else lane_state_block(ck.state, shards))
        acc = torch.as_tensor(ck.meta["swap_acc"], dtype=torch.int64)[st.lanes]
        _, recs = advance_tempered(gen, carry, acc, st, TEMPS, 1, sched, it0,
                                   run_length(sched, trailing=False))
    else:
        shards, sg, y_l, c_l, cfg_l, _ = chain_start(gen, ti, thr, yt, consts, cfg,
                                                     *mesh.values(), shard_gens=sg)
        carry = Carry(ck.state if shards is None else lane_state_block(ck.state, shards))
        recs = advance_chains(gen, carry, y_l, c_l, cfg_l, sched, it0, run_length(sched),
                              shards=shards, shard_gens=sg)
    return {k: v.numpy() for k, v in recs.items()}


def cut(case, tmp):
    """Cut ``case``'s run on its first layout after CUT draws, and copy the
    file for the resumes: "a" and "b" (two resumes), "c" (the second cut,
    on the resumed layout), "file" (read by the checks)."""
    src, _, tempered = CASES[case]
    base = os.path.join(tmp, case)
    run(src, base + ".npz", CUT, tempered)
    if not dist.is_initialized() or dist.get_rank() == 0:
        for tag in ("a", "b", "c", "file"):
            shutil.copy(base + ".npz", f"{base}_{tag}.npz")
    if dist.is_initialized():
        dist.barrier()


def resume(case, tmp):
    """``case``'s resumes on its second layout: "a" and "b" to the end,
    "c" cut again after CUT2 draws and resumed to the end, and the fed
    driver. Returns {name: host draws}, the same on every rank."""
    _, dst, tempered = CASES[case]
    base = os.path.join(tmp, case)
    out = {"a": run(dst, base + "_a.npz", DRAWS, tempered),
           "b": run(dst, base + "_b.npz", DRAWS, tempered)}
    run(dst, base + "_c.npz", CUT2, tempered)
    out["c"] = run(dst, base + "_c.npz", DRAWS, tempered)
    out["fed"] = fed(dst, base + "_file.npz", tempered)
    return out


def save(res, path):
    np.savez(path, **{f"{k}_{name}": v for k, d in res.items() for name, v in d.items()})


def chunked_mcmc(layout, verbose):
    """gpirt_mcmc on ``layout``, 8 sweeps, ``verbose`` (its progress printed
    on rank 0 at every chunk of 3 sweeps): the chains' stacked draws."""
    out = gpirt_mcmc(w.votes(n=n, m=m), DRAWS, BURN, CHAIN=K, vote_codes=None,
                     dtype="float64", device="cpu", grid_size=N, chunk_iterations=3,
                     verbose=verbose, **_mesh(layout))
    return {k: np.stack([d[k] for d in out]) for k in ("theta", "beta", "threshold", "ll")}


def resume_world(tmp):
    """The 4-rank world: cut every case whose first layout is a mesh, then
    resume every case whose second layout is one (the test cut the others
    without a mesh before it); rank 0 writes each resumed case's draws to
    ``<case>_resumed.npz``."""
    for case, (src, dst, _) in CASES.items():
        if src != "none":
            cut(case, tmp)
    for case, (src, dst, _) in CASES.items():
        if dst != "none":
            res = resume(case, tmp)
            if dist.get_rank() == 0:
                save(res, os.path.join(tmp, f"{case}_resumed.npz"))
    chunked = {str(v): chunked_mcmc("items2", v) for v in (True, False)}
    if dist.get_rank() == 0:
        save(chunked, os.path.join(tmp, "chunked.npz"))
    return dist.get_rank()
