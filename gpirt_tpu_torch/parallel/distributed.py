"""Multi-process execution: a ``torch.distributed`` world, chains over it,
and a launcher for one host.

Counterpart of ``gpirt_tpu/parallel/distributed.py``. JAX is
single-controller: one program sees every device of a host. PyTorch runs
one process per rank (SPMD), every rank calling the same entry points:

  * :func:`initialize_distributed` is a guarded
    ``dist.init_process_group``: it reads torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR``/``MASTER_PORT``) or takes an explicit address, world
    size and rank, and does nothing when there is one process or a group
    already exists. It picks the rank's device and the backend by
    :func:`backend_for`'s rule and prints both.
  * :func:`global_chain_mesh` is a 1-D ``DeviceMesh`` named ("chains",)
    over the world; :func:`run_chains_multihost` runs the chains over it
    and returns every chain's draws on every rank;
    :func:`pooled_ess_multihost` pools the ESS of the ranks' chain blocks.
  * :func:`launch` (JAX needs none) spawns W ranks of one function on this
    host, with a loopback rendezvous, and raises in the parent when a rank
    fails or the run overruns its timeout.

The backend rule is stated, not a fallback: ``cuda:nccl`` when every rank
on a host has a card of its own, ``cuda:gloo`` when ranks share a card
(NCCL refuses two ranks on one GPU), and ``cpu:gloo`` for CPU tensors
always. Gloo reduces CUDA tensors through host copies and offers only
``broadcast`` and ``all_reduce`` on them, so the port's collectives use
those two alone (``parallel/chains.py``).
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import queue
import socket
import sys
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from gpirt_tpu_torch.models.config import GPIRTConfig, GPIRTConstants
from gpirt_tpu_torch.models.sampler import run_chains
from gpirt_tpu_torch.parallel.chains import gather_chains, make_chain_mesh, shards_of
from gpirt_tpu_torch.utils.diagnostics import effective_sample_size_device

__all__ = [
    "initialize_distributed",
    "backend_for",
    "rank_device",
    "global_chain_mesh",
    "run_chains_multihost",
    "pooled_ess_multihost",
    "broadcast_constants",
    "launch",
]


def backend_for(device_type: str, local_world_size: int, device_count: int) -> str:
    """The process group's backend: Gloo for CPU tensors, and for CUDA
    tensors NCCL when each of the ``local_world_size`` ranks of this host
    has a card of its own, else Gloo (ranks that share a card)."""
    if device_type == "cpu":
        return "cpu:gloo"
    cuda = "nccl" if device_count >= local_world_size else "gloo"
    return f"cpu:gloo,cuda:{cuda}"


def _local_ranks():
    """(local rank, ranks on this host) from torchrun's environment."""
    rank = int(os.environ.get("RANK", 0))
    return (int(os.environ.get("LOCAL_RANK", rank)),
            int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", 1))))


def rank_device(device="cuda") -> torch.device:
    """This rank's device: the CPU when ``device`` says so, else the current
    card, ``cuda:{local_rank % device_count}`` once
    :func:`initialize_distributed` has run."""
    device = torch.device(device)
    if device.type == "cpu":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA rank needs a card, and torch.cuda.is_available() "
                           "is false; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def initialize_distributed(
    address: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    device="cuda",
) -> int:
    """Start this process's rank of the world; returns the world size.

    ``address`` (``tcp://host:port``), ``world_size`` and ``rank`` name the
    rendezvous; without them torchrun's environment does, and without that
    there is one process and nothing is started. An existing default group
    is left as it is. The rank's device (:func:`rank_device`) becomes the
    current CUDA device before the group starts, and the backend follows
    :func:`backend_for` with the ranks on this host (torchrun's
    ``LOCAL_WORLD_SIZE``; the whole world for an explicit address, one
    host). Rank 0 prints the choice."""
    if dist.is_initialized():
        return dist.get_world_size()
    if address is None and "WORLD_SIZE" not in os.environ:
        return 1
    if address is None:
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
        local_rank, local_world = _local_ranks()
        init_method = "env://"
    else:
        if world_size is None or rank is None:
            raise ValueError("an explicit address needs world_size and rank")
        local_rank, local_world = rank, world_size
        init_method = address
    if world_size == 1:
        return 1
    dev = torch.device(device)
    count = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type == "cuda":
        if count == 0:
            raise RuntimeError("a CUDA rank needs a card, and there is none")
        torch.cuda.set_device(local_rank % count)
    backend = backend_for(dev.type, local_world, count)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)
    if rank == 0:
        print(f"[gpirt] distributed: {world_size} ranks, {local_world} on this host, "
              f"{count} card(s) here; backend {backend} ("
              + ("CPU tensors" if dev.type == "cpu" else
                 "a card each" if backend.endswith("nccl") else "ranks share a card")
              + ")", file=sys.stderr)
    return world_size


def global_chain_mesh(device="cuda"):
    """A 1-D ``DeviceMesh`` named ("chains",) over every rank of the world."""
    return make_chain_mesh(device=device)


def _local_shard_bounds(mesh, n_chains: int):
    """[lo, hi) chain indices this rank owns on ``mesh``'s chain axis."""
    sl = shards_of(mesh).chains(n_chains)
    return sl.start, sl.stop


def run_chains_multihost(
    seed: int,
    n_chains: int,
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
    mesh=None,
) -> Dict[str, torch.Tensor]:
    """``n_chains`` chains over the ranks of ``mesh`` (the global chain
    mesh by default), called on every rank: one generator on the consts'
    device seeded ``seed`` draws the numbers of all chains, in the order
    one process draws them, and each rank keeps its block, so the result
    is the single-process ``run_chains`` chain for chain. ``theta_init``
    is (H, n), shared, or (n_chains, H, n). Returns every chain's draws on
    every rank."""
    if mesh is None:
        mesh = global_chain_mesh(consts.grid.device)
    if theta_init.ndim == 2:
        theta_init = theta_init.expand((n_chains,) + tuple(theta_init.shape))
    gen = torch.Generator(device=consts.grid.device)
    gen.manual_seed(seed)
    return run_chains(gen, y, theta_init, thresholds_init, consts, config,
                      sample_iterations=sample_iterations,
                      burn_iterations=burn_iterations, thin=thin, store_f=store_f,
                      store_fstar=store_fstar, mesh=mesh)


def pooled_ess_multihost(theta_block: torch.Tensor, mesh=None) -> torch.Tensor:
    """Chain-pooled ESS of the draws of all ranks' chains, from this rank's
    block ``theta_block`` (K_loc, S, P) of the chains on ``mesh``:
    :func:`~gpirt_tpu_torch.utils.diagnostics.effective_sample_size_device`
    of the whole (K, S, P), gathered over the chain axis (its draws are
    small beside a run's). Returns (P,) on every rank."""
    return effective_sample_size_device(gather_chains(theta_block, shards_of(mesh)))


def broadcast_constants(consts: Optional[GPIRTConstants], device,
                        dtype: torch.dtype) -> GPIRTConstants:
    """Rank 0's constants on every rank (``consts`` there, None elsewhere),
    each field's shape and then its values broadcast. The host LAPACK's
    results depend on its thread count, so constants built on each rank
    need not agree bit for bit; built once and broadcast, they do, and a
    chain mesh draws what one process with rank 0's thread count draws."""
    out = {}
    for f in dataclasses.fields(GPIRTConstants):
        v = None if consts is None else getattr(consts, f.name)
        head = torch.full((3,), -1, dtype=torch.int64)
        if v is not None:
            head[0] = v.ndim
            head[1:1 + v.ndim] = torch.as_tensor(v.shape)
        dist.broadcast(head, 0)
        if int(head[0]) < 0:
            out[f.name] = None
            continue
        shape = tuple(int(d) for d in head[1:1 + int(head[0])])
        t = (v.contiguous() if v is not None
             else torch.empty(shape, dtype=dtype, device=device))
        dist.broadcast(t, 0)
        out[f.name] = t
    return GPIRTConstants(**out)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _threads(world_size: int) -> int:
    """Each rank's torch CPU threads: its share of the host's cores, and no
    more than the launching process runs itself."""
    return max(1, min(torch.get_num_threads(), (os.cpu_count() or 1) // world_size))


def _rank_entry(fn, rank: int, world_size: int, port: int, device: str, args,
                results, staged: bool, threads: int) -> None:
    """One spawned rank: join the world, run ``fn(*args)`` (with a
    ``stage_done`` callable after them when ``staged``), report (rank,
    "ok" or "failed", result or traceback) to the parent, leave the
    world."""
    stage = [0]

    def stage_done():
        results.put((rank, "stage", stage[0]))
        stage[0] += 1

    try:
        torch.set_num_threads(threads)
        initialize_distributed(f"tcp://127.0.0.1:{port}", world_size, rank,
                               device=device)
        out = fn(*args, stage_done) if staged else fn(*args)
        results.put((rank, "ok", out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, "failed", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, world_size: int, args: Sequence = (), *, device="cuda",
           timeout: float = 600.0, stages: Optional[Sequence[float]] = None) -> List:
    """Run ``fn(*args)`` on ``world_size`` ranks of this host and return
    each rank's result, rank by rank.

    The ranks start by the ``spawn`` method (a parent that has touched
    CUDA cannot fork), meet at a loopback address on a free port, and each
    takes :func:`initialize_distributed`'s device and backend for
    ``device``: the card unless the caller names ``device="cpu"``, and
    without a card this raises before any rank starts. ``fn`` must be
    importable by the ranks (a module-level function) and its result
    picklable. When a rank raises, dies, or the ranks are not done within
    ``timeout`` seconds, every rank is stopped and this raises (``RuntimeError``, ``TimeoutError``). ``stages``, a
    list of timeouts in its place, runs several stages in one world (a
    rank's start may cost seconds): ``fn`` then takes one more argument,
    ``stage_done``, which every rank calls at the end of each stage but the
    last, and each stage must end within its own timeout, the first
    counted from the launch. Each rank runs torch's CPU threads on its
    share of the host's cores, and on no more threads than the caller's
    process runs."""
    rank_device(device)  # a CUDA world needs a card
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    limits = [timeout] if stages is None else list(stages)
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world_size, port, str(device), tuple(args), results,
                               stages is not None, _threads(world_size)))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out: Dict[int, object] = {}
    done = [0] * len(limits)
    stage = 0
    deadline = time.monotonic() + limits[0]
    try:
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(out))} "
                                   f"not done within {limits[stage]:g} s"
                                   + (f" (stage {stage})" if stages is not None else ""))
            try:
                rank, kind, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} before reporting")
                continue
            if kind == "failed":
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{payload}")
            if kind == "stage":
                done[payload] += 1
                while stage < len(limits) - 1 and done[stage] == world_size:
                    stage += 1
                    deadline = time.monotonic() + limits[stage]
                continue
            out[rank] = payload
        for p in procs:
            p.join(max(deadline - time.monotonic(), 5.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [out[r] for r in range(world_size)]
