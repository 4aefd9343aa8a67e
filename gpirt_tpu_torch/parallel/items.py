"""Item-axis model parallelism: the item dimension over the ``"items"``
axis of a ``DeviceMesh``.

Counterpart of ``gpirt_tpu/parallel/items.py``. Each rank of an item group
holds an item block of y, f, f*, beta, the cutpoints and the latent z, and
runs every per-item block of the conjugate sweep on it: z, f* (its
rank-(q+3) capacitance depends on theta only), beta, and the cutpoint ESS,
through the hand-written kernel on the rank's own lanes. The sweep couples
the shards at two points only: one ``all_reduce`` of the (K, H, N, n)
theta log-likelihood table per theta draw, and one of the ll trace
(``models/gibbs.py``'s ``item_group``). With a ``"chains"`` axis beside it
(a 2-D mesh, :func:`make_item_mesh`) the chains shard as well, and the
item collectives stay within each chain group.

Random numbers follow JAX's rule (``gpirt_tpu/models/gibbs.py:2645-2655``):
theta's uniforms come from the replicated generator, so every shard of a
chain group draws the same theta from the same summed table, and the
item-local draws from the shard's own generator (:func:`item_generator`,
seeded from the run's seed and the shard), at width m / S. Every rank
draws the numbers of all K chains and keeps its chains' block, so the
chain layout does not change the draws. An item-sharded run is therefore
not bitwise the unsharded run, as in JAX; any assignment of streams is a
valid sampler.

Only the conjugate sweep shards its items (JAX refuses the others the
same way). Theta by ESS runs under the axis with no collective beyond the
table's: every shard reads the same summed table with the replicated
numbers, so its ESS loop and its host-synced exit test take the same path
on every shard (``gpirt_tpu/models/gibbs.py:1669-1671``). The affine moves
run under it too: their proposals and accepts come from the replicated
generator, and one ``all_reduce`` completes each of their per-item sums
(the z-marginal's quadratic forms, the orbit's, the beta prior's;
``models/affine.py``). Tempering on a mesh is ``parallel/tempering.py``'s;
a respondent axis beside the item axis is ``parallel/respondents.py``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from gpirt_tpu_torch.models.config import GPIRTConfig, GPIRTConstants
from gpirt_tpu_torch.models.gibbs import ShardGenerators, SweepDraws
from gpirt_tpu_torch.parallel.chains import CHAIN_AXIS, Shards, shards_of

__all__ = [
    "make_item_mesh",
    "consts_item_block",
    "draws_item_block",
    "item_generator",
    "item_inputs",
    "check_item_config",
    "run_chains_itemsharded",
]


def make_item_mesh(n_item_shards: int, n_chain_shards: int = 1,
                   item_axis: str = "items", device="cuda"):
    """A (chains, items) 2-D ``DeviceMesh`` over the world's
    ``n_chain_shards * n_item_shards`` ranks (every rank calls it), chain
    groups of consecutive ranks' item shards."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if n_chain_shards * n_item_shards != world:
        raise ValueError(f"a {n_chain_shards} x {n_item_shards} mesh needs "
                         f"{n_chain_shards * n_item_shards} ranks; the world has {world}")
    return init_device_mesh(torch.device(device).type, (n_chain_shards, n_item_shards),
                            mesh_dim_names=(CHAIN_AXIS, item_axis))


def consts_item_block(consts: GPIRTConstants, items: slice) -> GPIRTConstants:
    """The constants of an item block, the counterpart of
    ``consts_item_specs``: the per-item prior arrays (3, m) sliced, every
    grid, respondent and time constant whole."""
    return dataclasses.replace(
        consts, beta_prior_means=consts.beta_prior_means[:, items].contiguous(),
        beta_prior_sds=consts.beta_prior_sds[:, items].contiguous())


# the item axis of each conjugate sweep draw whose last axis is not the
# items' (theta's numbers and the affine moves' have none: they are
# replicated; every other draw has it last)
_ITEM_DIM = {"zeta": -2, "nu": -2, "z": -2}
_REPLICATED = ("u_theta", "affine")


def draws_item_block(draws: SweepDraws, items: slice) -> SweepDraws:
    """A conjugate sweep's draws for all items cut to the item block
    ``items``, theta's and the affine moves' numbers whole: what a shard's sweep reads when it is
    fed the unsharded sweep's numbers, as the checks of the sharded sweep
    feed it. (A sharded run draws its item-local numbers at the block's
    width instead, from its own generator.)"""
    def cut(name, a):
        if a is None:
            return None
        if isinstance(a, tuple):
            return type(a)(*(cut(k, v) for k, v in zip(a._fields, a)))
        d = _ITEM_DIM.get(name, -1) % a.ndim
        return a.narrow(d, items.start, items.stop - items.start)

    return type(draws)(*(a if k in _REPLICATED else cut(k, a)
                         for k, a in zip(draws._fields, draws)))


def item_generator(seed: int, shard: int, device) -> torch.Generator:
    """Item shard ``shard``'s generator, seeded from (seed, shard)."""
    gen = torch.Generator(device=device)
    seq = np.random.SeedSequence([int(seed), int(shard)])
    gen.manual_seed(int(seq.generate_state(1)[0]))
    return gen


def check_item_config(config: GPIRTConfig, shards: Shards) -> None:
    """What an item axis refuses, by name (JAX refuses the non-conjugate
    samplers the same way, ``gpirt_tpu/models/gibbs.py:2637-2643``)."""
    if shards.n_item == 1:
        return
    if config.resolved_f_method != "conjugate":
        raise NotImplementedError("item-sharded sweeps need f_method='conjugate' "
                                  f"(got {config.resolved_f_method!r})")


def item_inputs(y: torch.Tensor, thresholds_init: torch.Tensor, consts: GPIRTConstants,
                config: GPIRTConfig, shards: Shards):
    """(y, thresholds_init, consts, config) of this rank's item block: y's
    block copied C-contiguous (the kernel reads it through a raw pointer),
    and a config whose m is the block's, which sizes the shard's draws.
    One item shard returns them as they are."""
    if shards.n_item == 1:
        return y, thresholds_init, consts, config
    check_item_config(config, shards)
    i = shards.items(config.m)
    return (y[..., i].contiguous(), thresholds_init[..., i, :].contiguous(),
            consts_item_block(consts, i), dataclasses.replace(config, m=i.stop - i.start))


def run_chains_itemsharded(
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
    item_axis: str = "items",
    initial_states=None,
    shard_gens: Optional[ShardGenerators] = None,
) -> Dict[str, torch.Tensor]:
    """``len(theta_init)`` chains with the items sharded over
    ``mesh[item_axis]`` (and the chains over ``mesh["chains"]`` when the
    mesh has it), called on every rank with the whole inputs.

    ``gen`` is the replicated generator (theta's numbers); ``shard_gens``,
    this shard's, defaults to ``parallel.respondents.shard_generators`` of
    ``gen``'s seed (its item shard's :func:`item_generator`).
    ``initial_states`` (e.g. ``anneal_init(mesh=..., item_axis=...)``'s) is
    this rank's block. Returns ``run_chains``' draws, the per-item ones
    reassembled from the shards and theta and ll once, the same on every
    rank. Raises as JAX does when m does not divide by the item shards or
    the chains by the chain shards, and for a sampler other than the
    conjugate one.
    """
    from gpirt_tpu_torch.models.sampler import run_chains

    shards_of(mesh, item_axis)  # the mesh must have the item axis
    return run_chains(gen, y, theta_init, thresholds_init, consts, config,
                      sample_iterations=sample_iterations, burn_iterations=burn_iterations,
                      thin=thin, initial_states=initial_states, store_f=store_f,
                      store_fstar=store_fstar, mesh=mesh, item_axis=item_axis,
                      shard_gens=shard_gens)
