"""Respondent-axis model parallelism: the respondent dimension n over the
``"respondents"`` axis of a ``DeviceMesh``.

Counterpart of ``gpirt_tpu/parallel/respondents.py``, the dual of
``parallel/items.py``. Each rank of a respondent group holds a respondent
block of y, theta, f and the latent z, and draws theta and z on it alone.
beta, the cutpoints and f* are replicated: each is drawn on every rank
from statistics that one ``all_reduce`` over the group completes
(``models/gibbs.py``'s ``respondent_group``): f*'s rank-(q+3) U^T
projection and capacitance, beta's standardisation moments and 3 x 3
regression, the cutpoint update's lane totals (each ESS round's, Newton's
data sums, the collapsed draw's z box), the affine moves' low-rank
z-marginal (``models/affine.py``) and the ll. What crosses the group a
sweep grows with m and q, not with n: the axis divides every (K, H, n, m)
array, the (K, H, N, n) theta table and theta's uniforms, which dominate
memory when n is large (national surveys; the synthetic 5000 x 1000
configuration).

The binary cutpoint ESS leaves the hand-written kernel under this axis, as
JAX leaves its Pallas kernel (``gpirt_tpu/models/gibbs.py:2299-2301``):
the kernel runs a whole round loop in one launch, and every round here
ends in an ``all_reduce``. Every path without a respondent axis still
launches it.

With a ``"chains"`` axis and an ``"items"`` axis beside it
(:func:`make_respondent_mesh`, JAX's 3-D mesh) the chains and the items
shard as well: the theta table's ``all_reduce`` runs over the item group,
the sufficient statistics' over the respondent group, each within its
chain block.

Random numbers follow JAX's rule (``gpirt_tpu/models/gibbs.py:2656-2661``,
``:2688-2689``, ``:677-678``), the dual of the item axis's: the
respondent-local draws come from the shard's own generator
(:func:`respondent_generator`, seeded from the run's seed and the shard),
at width n / S: theta's uniforms (or the ESS theta loop's numbers), z's
uniforms and f*'s observation noise ``eps_f``. Everything else comes from
the replicated generator: f*'s grid draws ``z_q``, ``z_p`` and ``z_n``,
beta's ``zeta``, the cutpoint draws and the affine draws, so every
respondent shard draws the same f*, beta and cutpoints. Under both axes
the draws local to both (z's uniforms, ``eps_f``) come from a generator of
their own for the (item, respondent) cell (:func:`shard_generators`). A
respondent-sharded run is therefore not bitwise the unsharded run, as in
JAX; any assignment of streams is a valid sampler. A run resumed onto other
shard counts than its checkpoint's seeds its shards' generators afresh
(:func:`resume_shard_generators`, ``utils/checkpoint.py``).

Only the conjugate sweep shards its respondents (JAX refuses the others,
``gpirt_tpu/models/gibbs.py:2637-2642``); theta by ESS, the GP and RDM
theta regimes, ``mix_subsweeps``, ``jitter``, ``threshold_shift`` and
``interleave`` run under it, and so do the affine moves, with or without
an item axis beside it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from gpirt_tpu_torch.models.config import GPIRTConfig, GPIRTConstants
from gpirt_tpu_torch.models.gibbs import ShardGenerators, SweepDraws, ThetaESSDraws
from gpirt_tpu_torch.parallel.chains import CHAIN_AXIS, Shards, shards_of
from gpirt_tpu_torch.parallel.items import item_generator, item_inputs

__all__ = [
    "RESPONDENT_AXIS",
    "make_respondent_mesh",
    "consts_respondent_block",
    "draws_respondent_block",
    "respondent_generator",
    "shard_generators",
    "resume_shard_generators",
    "shard_inputs",
    "check_respondent_config",
    "run_chains_respondentsharded",
]

RESPONDENT_AXIS = "respondents"


def make_respondent_mesh(n_resp_shards: int, n_chain_shards: int = 1, n_item_shards: int = 1,
                         device="cuda"):
    """A (chains, items, respondents) ``DeviceMesh`` over the world's
    ``n_chain_shards * n_item_shards * n_resp_shards`` ranks (every rank
    calls it), the axes of size 1 dropped (``gpirt_tpu/parallel/respondents.py:66-83``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    total = n_chain_shards * n_item_shards * n_resp_shards
    if total != world:
        raise ValueError(f"a {n_chain_shards} x {n_item_shards} x {n_resp_shards} mesh needs "
                         f"{total} ranks; the world has {world}")
    axes = [(size, name) for size, name in ((n_chain_shards, CHAIN_AXIS),
                                            (n_item_shards, "items"),
                                            (n_resp_shards, RESPONDENT_AXIS)) if size > 1]
    if not axes:
        axes = [(1, RESPONDENT_AXIS)]
    return init_device_mesh(torch.device(device).type, tuple(a[0] for a in axes),
                            mesh_dim_names=tuple(a[1] for a in axes))


def consts_respondent_block(consts: GPIRTConstants, respondents: slice,
                            items: Optional[slice] = None) -> GPIRTConstants:
    """The constants of a respondent block (and an item block), the
    counterpart of ``consts_mesh_specs``: the (2, n) theta priors sliced
    over the respondents, the (3, m) beta priors over the items, every grid
    and time constant whole."""
    out = dataclasses.replace(
        consts, theta_prior_means=consts.theta_prior_means[:, respondents].contiguous(),
        theta_prior_sds=consts.theta_prior_sds[:, respondents].contiguous())
    if items is not None:
        out = dataclasses.replace(
            out, beta_prior_means=consts.beta_prior_means[:, items].contiguous(),
            beta_prior_sds=consts.beta_prior_sds[:, items].contiguous())
    return out


def draws_respondent_block(draws: SweepDraws, respondents: slice,
                           config: GPIRTConfig) -> SweepDraws:
    """A conjugate sweep's draws for all respondents cut to the block
    ``respondents``, the replicated numbers whole: what a shard's sweep
    reads when it is fed the unsharded sweep's numbers, as the checks of
    the sharded sweep feed it. (A sharded run draws its respondent-local
    numbers at the block's width instead, from its own generator.) The
    respondents are the second-to-last axis of theta's uniforms, z's and
    eps_f, and of the ESS theta draws' normals; the ESS lanes' last axis,
    or second-to-last in the RDM regime (a lane a respondent and
    session)."""
    lane_dim = -2 if config.theta_regime == "RDM" else -1

    def cut(a, dim):
        return a.narrow(dim, respondents.start, respondents.stop - respondents.start)

    u = draws.u_theta
    if isinstance(u, ThetaESSDraws):
        u = ThetaESSDraws(cut(u.z, -2), *(cut(a, lane_dim) for a in u[1:]))
    else:
        u = cut(u, -2)
    return draws._replace(u_theta=u, u_z=cut(draws.u_z, -2), eps_f=cut(draws.eps_f, -2))


def respondent_generator(seed: int, shard: int, device) -> torch.Generator:
    """Respondent shard ``shard``'s generator, seeded from (seed, shard),
    a stream apart from the item shards' (``item_generator``)."""
    return _generator(np.random.SeedSequence([int(seed), int(shard)], spawn_key=(1,)), device)


def _generator(seq: np.random.SeedSequence, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seq.generate_state(1)[0]))
    return gen


def shard_generators(seed: int, shards: Shards, device) -> Optional[ShardGenerators]:
    """This rank's :class:`~gpirt_tpu_torch.models.gibbs.ShardGenerators`
    for a run seeded ``seed``: its item shard's generator, its respondent
    shard's, and for the draws local to both axes the (item, respondent)
    cell's own, or the one sharded axis's; None without a model axis."""
    item = item_generator(seed, shards.item_rank, device) if shards.n_item > 1 else None
    resp = (respondent_generator(seed, shards.resp_rank, device) if shards.n_resp > 1
            else None)
    if item is None and resp is None:
        return None
    cell = item if resp is None else resp if item is None else _generator(
        np.random.SeedSequence([int(seed), shards.item_rank, shards.resp_rank],
                               spawn_key=(2,)), device)
    return ShardGenerators(item=item, resp=resp, cell=cell)


def resume_shard_generators(seed: int, shards: Shards, iteration: int,
                            device) -> Optional[ShardGenerators]:
    """This rank's shard generators for a run resumed at absolute sweep
    ``iteration`` onto other counts of item or respondent shards than its
    checkpoint's (``utils/checkpoint.py``): each seeded afresh from
    (seed, shard, the new count, ``iteration``) with spawn keys of their
    own (items 3, respondents 4, cells 5; a fresh run's are none, 1 and 2),
    so that no stream replays numbers a shard of either layout has drawn.
    The cell's is the one sharded axis's, as in :func:`shard_generators`;
    None without a model axis."""
    it, i, r = int(iteration), shards.item_rank, shards.resp_rank
    ni, nr = shards.n_item, shards.n_resp
    item = (_generator(np.random.SeedSequence([int(seed), i, ni, it], spawn_key=(3,)), device)
            if ni > 1 else None)
    resp = (_generator(np.random.SeedSequence([int(seed), r, nr, it], spawn_key=(4,)), device)
            if nr > 1 else None)
    if item is None and resp is None:
        return None
    cell = item if resp is None else resp if item is None else _generator(
        np.random.SeedSequence([int(seed), i, r, ni, nr, it], spawn_key=(5,)), device)
    return ShardGenerators(item=item, resp=resp, cell=cell)


def check_respondent_config(config: GPIRTConfig, shards: Shards) -> None:
    """What a respondent axis refuses, by name: a sampler other than the
    conjugate one (``gpirt_tpu/models/gibbs.py:2637-2642``)."""
    if shards.n_resp > 1 and config.resolved_f_method != "conjugate":
        raise NotImplementedError("respondent-sharded sweeps need f_method='conjugate' "
                                  f"(got {config.resolved_f_method!r})")


def shard_inputs(y: torch.Tensor, thresholds_init: torch.Tensor, consts: GPIRTConstants,
                 config: GPIRTConfig, shards: Shards):
    """(y, thresholds_init, consts, config) of this rank's item and
    respondent block (``parallel.items.item_inputs`` for the items): y's
    block copied C-contiguous, the theta priors of its respondents, and a
    config whose n and m are the block's, which size the shard's draws.
    One respondent shard returns the item block's as they are."""
    y, thresholds_init, consts, config = item_inputs(y, thresholds_init, consts, config,
                                                     shards)
    if shards.n_resp == 1:
        return y, thresholds_init, consts, config
    check_respondent_config(config, shards)
    r = shards.respondents(config.n)
    return (y[:, r].contiguous(), thresholds_init, consts_respondent_block(consts, r),
            dataclasses.replace(config, n=r.stop - r.start))


def run_chains_respondentsharded(
    gen: torch.Generator,
    y: torch.Tensor,
    theta_init: torch.Tensor,
    thresholds_init: torch.Tensor,
    consts: GPIRTConstants,
    config: GPIRTConfig,
    *,
    sample_iterations: int,
    burn_iterations: int,
    thin: int = 1,
    store_f: bool = False,
    store_fstar: bool = False,
    mesh,
    item_axis: Optional[str] = None,
    respondent_axis: str = RESPONDENT_AXIS,
    initial_states=None,
    shard_gens: Optional[ShardGenerators] = None,
) -> Dict[str, torch.Tensor]:
    """``len(theta_init)`` chains with the respondents sharded over
    ``mesh[respondent_axis]`` (and the items over ``mesh[item_axis]``, the
    chains over ``mesh["chains"]`` where the mesh has them), called on
    every rank with the whole inputs.

    ``gen`` is the replicated generator; ``shard_gens``, this rank's, defaults
    to :func:`shard_generators` of ``gen``'s seed. ``initial_states`` (e.g.
    ``anneal_init(mesh=..., respondent_axis=...)``'s) is this rank's block.
    Returns ``run_chains``' draws, theta and f reassembled from the
    respondent shards, the per-item ones from the item shards, ll once,
    the same on every rank. Raises as JAX does when n does not divide by
    the respondent shards (or m by the item shards, the chains by the chain
    shards), and for a sampler other than the conjugate one.
    """
    from gpirt_tpu_torch.models.sampler import run_chains

    shards_of(mesh, item_axis, respondent_axis)  # the mesh must have the axes
    return run_chains(gen, y, theta_init, thresholds_init, consts, config,
                      sample_iterations=sample_iterations, burn_iterations=burn_iterations,
                      thin=thin, initial_states=initial_states, store_f=store_f,
                      store_fstar=store_fstar, mesh=mesh, item_axis=item_axis,
                      respondent_axis=respondent_axis, shard_gens=shard_gens)
