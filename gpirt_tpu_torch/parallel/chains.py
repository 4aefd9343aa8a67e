"""Chains, items and respondents over a ``torch.distributed``
``DeviceMesh``: where a rank sits on the mesh, its block of a lane-stacked
state, and the collectives that reassemble blocks.

Counterpart of the mesh parts of ``gpirt_tpu/parallel/chains.py``
(``make_chain_mesh``, ``lane_state_specs``). Every rank runs the same
program on its block: the chains of its place on the ``"chains"`` axis
(:data:`CHAIN_AXIS`, the one name of the chain axis), and, when items are
sharded (``parallel/items.py``), the items of its place on the item axis,
and when respondents are (``parallel/respondents.py``), the respondents of
its place on the respondent axis. JAX's ``shard_map`` specs become
explicit blocks (:func:`lane_state_block`) and their reassembly
(:func:`assemble_lane_state`).

Collectives are ``all_reduce`` alone, so that one code path serves Gloo
(ranks that share a card, or CPU tensors) and NCCL: a gather is the
``all_reduce(SUM)`` of a zero-filled global buffer into which each rank
has written its own block (x + 0 is exact, so the gather is too). Every
collective here is called by every rank of its group the same number of
times, in the same order.

``canonical_mesh`` has no counterpart: it keys XLA's compiled-program
caches on one ``Mesh`` object, and the port compiles no programs.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.distributed as dist

from gpirt_tpu_torch.models.gibbs import GPIRTState

__all__ = [
    "CHAIN_AXIS",
    "CAMPAIGN_AXIS",
    "Shards",
    "shards_of",
    "campaign_shards",
    "make_chain_mesh",
    "make_campaign_mesh",
    "lane_state_block",
    "assemble_lane_state",
    "gather_chains",
    "gather_items",
    "gather_respondents",
    "gather_draws",
    "check_replicated",
]

CHAIN_AXIS = "chains"  # the mesh axis the chains shard over
CAMPAIGN_AXIS = "campaigns"  # the mesh axis independent campaigns shard over

# the item axis of each per-item state field and stored draw (the chain
# axis is the first); theta and ll hold no item axis
_STATE_ITEM_DIM = {"f": -1, "beta": -1, "thresholds": -2, "fstar": -1}
_DRAW_ITEM_DIM = {"f": -1, "beta": -1, "threshold": -2, "fstar": -1}
# the respondent axis of each per-respondent state field and stored draw;
# beta, the cutpoints, f* and ll hold none (replicated over the respondents)
_STATE_RESP_DIM = {"theta_idx": -1, "f": -2}
_DRAW_RESP_DIM = {"theta": -1, "f": -2}


class Shards(NamedTuple):
    """A rank's place on a (chains, items, respondents) mesh: the count of
    shards on each axis, this rank's index and the axis's process group
    (None where the axis is absent or of size 1). The default is one rank
    holding everything."""

    n_chain: int = 1
    chain_rank: int = 0
    chain_group: Optional[object] = None
    n_item: int = 1
    item_rank: int = 0
    item_group: Optional[object] = None
    n_resp: int = 1
    resp_rank: int = 0
    resp_group: Optional[object] = None

    @staticmethod
    def _block(total: int, n: int, rank: int, what: str) -> slice:
        if total % n:
            raise ValueError(f"{total} {what} do not divide over {n} {what[:-1]} shards")
        k = total // n
        return slice(rank * k, (rank + 1) * k)

    def chains(self, K: int) -> slice:
        """This rank's chains of K."""
        return self._block(K, self.n_chain, self.chain_rank, "chains")

    def items(self, m: int) -> slice:
        """This rank's items of m."""
        return self._block(m, self.n_item, self.item_rank, "items")

    def respondents(self, n: int) -> slice:
        """This rank's respondents of n."""
        return self._block(n, self.n_resp, self.resp_rank, "respondents")


def shards_of(mesh, item_axis: Optional[str] = None,
              respondent_axis: Optional[str] = None) -> Shards:
    """This rank's :class:`Shards` on ``mesh`` (a ``DeviceMesh``, or Shards
    as they are, or None: one rank). The chains shard over
    :data:`CHAIN_AXIS` when the mesh has it; the items over ``item_axis``
    and the respondents over ``respondent_axis`` when given, which the mesh
    must have. Any other axis of more than one rank raises rather than run
    the same work on each of its ranks."""
    if mesh is None:
        return Shards()
    if isinstance(mesh, Shards):
        return mesh
    names = tuple(mesh.mesh_dim_names or ())
    for given in (item_axis, respondent_axis):
        if given is not None and given not in names:
            raise ValueError(f"mesh has no axis named {given!r} (its axes: {names})")
    other = [a for a, size in zip(names, mesh.shape)
             if a not in (CHAIN_AXIS, item_axis, respondent_axis) and size > 1]
    if other:
        raise ValueError(f"mesh axis {other[0]!r} is neither the chain axis "
                         f"{CHAIN_AXIS!r} nor the item axis ({item_axis!r}) nor the "
                         f"respondent axis ({respondent_axis!r}): it would run the same "
                         "chains on each of its ranks")

    def axis(name):
        if name is None or name not in names or mesh.shape[names.index(name)] == 1:
            return 1, 0, None
        size = mesh.shape[names.index(name)]
        return size, mesh.get_local_rank(name), mesh.get_group(name)

    return Shards(*axis(CHAIN_AXIS), *axis(item_axis), *axis(respondent_axis))


def campaign_shards(mesh) -> Shards:
    """This rank's place on a campaign mesh (``gpirt_tpu/campaigns.py:126-129``)
    as chain :class:`Shards`: the campaigns, whole and campaign-major,
    shard over its :data:`CAMPAIGN_AXIS` as a chain mesh shards its chains.
    A mesh without that axis, or with another axis of more than one rank,
    raises ``ValueError``."""
    names = tuple(mesh.mesh_dim_names or ())
    if CAMPAIGN_AXIS not in names:
        raise ValueError(f"mesh has no axis named {CAMPAIGN_AXIS!r} (its axes: {names})")
    other = [a for a, size in zip(names, mesh.shape) if a != CAMPAIGN_AXIS and size > 1]
    if other:
        raise ValueError(f"mesh axis {other[0]!r} is not the campaign axis "
                         f"{CAMPAIGN_AXIS!r}: campaigns shard over that axis alone")
    size = mesh.shape[names.index(CAMPAIGN_AXIS)]
    if size == 1:
        return Shards()
    return Shards(size, mesh.get_local_rank(CAMPAIGN_AXIS), mesh.get_group(CAMPAIGN_AXIS))


def _world_mesh(n_devices: Optional[int], device, axis: str):
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh spans the world: {n_devices} devices asked, "
                         f"{world} ranks")
    return init_device_mesh(torch.device(device).type, (world,), mesh_dim_names=(axis,))


def make_chain_mesh(n_devices: Optional[int] = None, device="cuda"):
    """A 1-D ``DeviceMesh`` named (:data:`CHAIN_AXIS`,) over the ranks of
    the world (every rank calls it); ``n_devices``, when given, must be the
    world's size."""
    return _world_mesh(n_devices, device, CHAIN_AXIS)


def make_campaign_mesh(n_devices: Optional[int] = None, device="cuda"):
    """A 1-D ``DeviceMesh`` named (:data:`CAMPAIGN_AXIS`,) over the ranks of
    the world, for ``gpirt_campaigns(mesh=...)``; as :func:`make_chain_mesh`."""
    return _world_mesh(n_devices, device, CAMPAIGN_AXIS)


def _gather(t: torch.Tensor, n: int, rank: int, group, dim: int) -> torch.Tensor:
    """The blocks of ``t`` along ``dim`` from the ``n`` ranks of ``group``,
    in rank order, on every rank of it."""
    if group is None:
        return t
    dim = dim % t.ndim
    k = t.shape[dim]
    out = t.new_zeros(t.shape[:dim] + (n * k,) + t.shape[dim + 1:])
    if out.numel() == 0:  # every rank's block is empty alike: nothing to send
        return out
    out.narrow(dim, rank * k, k).copy_(t)
    dist.all_reduce(out, group=group)
    return out


def gather_chains(t: torch.Tensor, shards: Shards, dim: int = 0) -> torch.Tensor:
    """All chains of the chain group from each rank's block along ``dim``."""
    return _gather(t, shards.n_chain, shards.chain_rank, shards.chain_group, dim)


def gather_items(t: torch.Tensor, shards: Shards, dim: int = -1) -> torch.Tensor:
    """All items of the item group from each rank's block along ``dim``."""
    return _gather(t, shards.n_item, shards.item_rank, shards.item_group, dim)


def gather_respondents(t: torch.Tensor, shards: Shards, dim: int = -1) -> torch.Tensor:
    """All respondents of the respondent group from each rank's block along
    ``dim``."""
    return _gather(t, shards.n_resp, shards.resp_rank, shards.resp_group, dim)


def gather_draws(draws: Dict[str, torch.Tensor], shards: Shards) -> Dict[str, torch.Tensor]:
    """Stored draws {name: (K_loc, S, ...)} of every rank as the global
    draws, the same on every rank: per-item fields gathered over the item
    group, per-respondent ones over the respondent group, then everything
    over the chain group."""
    out = {}
    for k in sorted(draws):
        v = draws[k]
        if k in _DRAW_ITEM_DIM:
            v = gather_items(v, shards, _DRAW_ITEM_DIM[k])
        if k in _DRAW_RESP_DIM:
            v = gather_respondents(v, shards, _DRAW_RESP_DIM[k])
        out[k] = gather_chains(v, shards)
    return out


def lane_state_block(states: GPIRTState, mesh, item_axis: Optional[str] = None,
                     respondent_axis: Optional[str] = None) -> GPIRTState:
    """This rank's block of a lane-stacked (K, ...) state, the counterpart
    of ``lane_state_specs``: its chains, of the per-item fields (f, beta,
    thresholds, f*) its items when ``item_axis`` is given, and of the
    per-respondent ones (theta, f) its respondents when ``respondent_axis``
    is."""
    shards = shards_of(mesh, item_axis, respondent_axis)
    c = shards.chains(states.theta_idx.shape[0])
    i = shards.items(states.beta.shape[-1])
    r = shards.respondents(states.theta_idx.shape[-1])
    out = {}
    for name, a in states._asdict().items():
        a = a[c]
        for dims, cut in ((_STATE_ITEM_DIM, i), (_STATE_RESP_DIM, r)):
            if name in dims:
                a = a.narrow(dims[name] % a.ndim, cut.start, cut.stop - cut.start)
        out[name] = a.contiguous()
    return GPIRTState(**out)


def assemble_lane_state(block: GPIRTState, mesh, item_axis: Optional[str] = None,
                        respondent_axis: Optional[str] = None) -> GPIRTState:
    """The lane-stacked state from every rank's :func:`lane_state_block`,
    on every rank."""
    shards = shards_of(mesh, item_axis, respondent_axis)
    out = {}
    for name, a in block._asdict().items():
        a = a.contiguous()
        if name in _STATE_ITEM_DIM:
            a = gather_items(a, shards, _STATE_ITEM_DIM[name])
        if name in _STATE_RESP_DIM:
            a = gather_respondents(a, shards, _STATE_RESP_DIM[name])
        out[name] = gather_chains(a, shards)
    return GPIRTState(**out)


def _check_alike(t: torch.Tensor, group, what: str, where: str) -> None:
    if group is None:
        return
    t = t.detach().cpu()
    hi, lo = t.clone(), t.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    if not (torch.equal(hi, t) and torch.equal(lo, t)):
        raise RuntimeError(f"{what} differs between the {where}: the replicated state "
                           "forked")


def check_replicated(state: GPIRTState, shards: Shards) -> None:
    """The replication canary of ``gpirt_tpu/models/gibbs.py:873-883``, or
    this raises: the item shards of a chain and respondent block hold theta
    bit for bit alike (drawn from the one summed table with the same
    numbers), and the respondent shards of a chain and item block hold
    beta, the cutpoints and f* alike (drawn from the same all-reduced
    statistics with the replicated numbers)."""
    _check_alike(state.theta_idx, shards.item_group, "theta",
                 f"item shards of chain shard {shards.chain_rank}")
    for name in ("beta", "thresholds", "fstar"):
        _check_alike(getattr(state, name), shards.resp_group, name,
                     f"respondent shards of chain shard {shards.chain_rank}")
