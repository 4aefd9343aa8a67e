"""Checkpoint / resume for long MCMC runs.

Counterpart of ``gpirt_tpu/utils/checkpoint.py``. The reference has no
checkpointing: an interrupt loses the entire run (src/gpirtMCMC.cpp:264,
SURVEY.md section 5.3-5.4). Here the chain state, the progress counter,
the accumulated thinned draws and the random generator's state are saved
atomically every ``checkpoint_every`` sweeps, so an interrupted and
resumed run is bit for bit an uninterrupted one.

The file is the JAX package's layout, format version 3: ``state_<field>``
for the five ``GPIRTState`` fields with a leading chain axis,
``draws_<name>`` in the internal layout (K, S, ...), and ``meta_json``
with ``pre_done``, ``recs_done``, ``total``, ``sample_iterations`` and the
run spec that a resume must match. Each package's manager reads the
other's state and draws.

Randomness. The port draws every number from one sequential
``torch.Generator`` where JAX folds the absolute iteration into its keys,
so the port's file also holds the generator's own state (``rng_state``,
``gen.get_state()`` as uint8) and the absolute sweep count (meta
``iteration``), and a resume restores both. That state is specific to the
device type (the CPU's Mersenne Twister, CUDA's Philox seed and offset,
whose offsets also follow the launch shapes), so the run spec adds
``rng_device`` and a resume across device types raises. The meta records
the device's name and the torch version; a resume where either differs
warns on stderr that the draws are valid but not bitwise those of the
uninterrupted run. A checkpoint written by the JAX package has no
generator state: :meth:`CheckpointManager.load` reads it, and the runs
here refuse to resume from it. Module-level tallies of diagnostics (such
as ``models.affine.counts`` or ``ops.ess.ess_update``'s counters) are not
chain state and are not saved.

On a mesh (``run_chains_checkpointed`` and
``run_tempered_chains_checkpointed`` with ``mesh=..., item_axis=...,
respondent_axis=...``) the file holds the whole run, as one process
would: every rank gathers the lane states and the draws, rank 0 writes the
file, and the ranks meet after it. Under an item axis it also holds each
item shard's generator state (``item_rng_state``, one row a shard) and
meta ``item_shards``; under a respondent axis each respondent shard's
(``resp_rng_state``) and meta ``resp_shards``, and under both each
(item, respondent) cell's (``cell_rng_state``, items by respondents). A
run resumes on any chain layout, or on none, bit for bit onto the same
counts of item and respondent shards.

A resume across those counts (like JAX's, whose checkpoints are
device-layout free, ``gpirt_tpu/utils/checkpoint.py:188-191``) follows
this stream rule:

* the replicated generator continues from its saved state;
* each shard generator of the new layout is seeded afresh from (SEED,
  shard, the new count, the absolute sweep count) with spawn keys of its
  own (``parallel.respondents.resume_shard_generators``; SEED is the
  replicated generator's seed as the resuming call makes it), apart from
  a fresh run's streams: a shard seeded (SEED, shard) again would replay
  numbers the old layout's shard of that index drew, on which the state
  depends;
* with no model axis the sweep draws everything from the replicated
  generator, as a fresh unsharded run does;
* a checkpoint written after such a resume holds the new layout's shard
  states, and resumes onto that layout bit for bit.

The draws after a resume across counts change, as JAX's do; the sampler
stays valid.

Not carried over from the JAX module: ``aligned_records_chunk`` and
``ChunkedPrograms``, which shared one compiled XLA program between chunks
(eager PyTorch has nothing to compile), and ``prng_impl``, JAX's choice of
key implementation. ``chunk_iterations`` is the drivers' chunk without a
manager (:func:`run_chains_checkpointed`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys
import tempfile
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from gpirt_tpu_torch.models.config import GPIRTConfig, GPIRTConstants
from gpirt_tpu_torch.models.gibbs import GPIRTState, ShardGenerators
from gpirt_tpu_torch.models.sampler import (
    Carry,
    advance_chains,
    chain_start,
    run_length,
    sample_schedule,
)
from gpirt_tpu_torch.parallel.chains import (
    Shards,
    assemble_lane_state,
    gather_items,
    gather_respondents,
    lane_state_block,
)
from gpirt_tpu_torch.parallel.respondents import resume_shard_generators
from gpirt_tpu_torch.parallel.tempering import (
    advance_tempered,
    gather_tally,
    swap_rate,
    tempered_start,
)

__all__ = [
    "CHECKPOINT_FORMAT_VERSION",
    "Checkpoint",
    "CheckpointManager",
    "config_digest",
    "run_chain_checkpointed",
    "run_chains_checkpointed",
    "run_tempered_chains_checkpointed",
]

_STATE_FIELDS = GPIRTState._fields

# The JAX package's format version: v2 is one <path>.npz holding all chains
# with pre_done / recs_done meta, v3 adds the run spec that a resume checks.
CHECKPOINT_FORMAT_VERSION = 3


def config_digest(config: GPIRTConfig) -> str:
    """Deterministic cross-process digest of every config field.

    ``hash(config)`` is salted per process (string fields), so the
    checkpoint stores a sha256 of the sorted field dict instead.
    """
    fields = {k: repr(v) for k, v in dataclasses.asdict(config).items()}
    blob = json.dumps(fields, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


# meta keys that must match between the checkpoint and the resuming run: a
# mismatch means the record schedule diverges and the resumed draws would be
# silently wrong. sample_iterations is deliberately not checked: records are
# placed by absolute iteration, so extending (or shrinking) the sampling
# phase on resume is well-defined, and that is how an interrupted run
# continues to the full count. The port's run spec adds rng_device, and
# n_temps in every run (1 for the plain ones), so that a plain run refuses
# a tempered run's G L lanes.
_RUN_SPEC_KEYS = (
    "thin", "burn_iterations", "n_chains",
    "store_f", "store_fstar", "config_digest",
)


def _check_run_spec(meta: dict, spec: dict, path: str) -> None:
    bad = {
        k: (meta.get(k), spec[k])
        for k in spec
        if meta.get(k) != spec[k]
    }
    if bad:
        detail = ", ".join(
            f"{k}: checkpoint={ck!r} vs requested={rq!r}"
            for k, (ck, rq) in bad.items()
        )
        raise ValueError(
            f"checkpoint {path} was written by a run with different "
            f"parameters ({detail}); resuming would silently continue a "
            "mismatched schedule. Delete the checkpoint to start fresh, or "
            "resume with the original parameters."
        )


class Checkpoint(NamedTuple):
    state: GPIRTState
    meta: dict
    draws: Dict[str, np.ndarray]
    rng_state: Optional[np.ndarray]  # uint8; None in a JAX package's file
    item_rng_state: Optional[np.ndarray] = None  # (shards, bytes) uint8 under an item axis
    resp_rng_state: Optional[np.ndarray] = None  # (shards, bytes) under a respondent axis
    cell_rng_state: Optional[np.ndarray] = None  # (item, resp shards, bytes) under both


class CheckpointManager:
    """Atomic .npz checkpoints of (state, meta, accumulated draws, the
    generator's state). ``seconds`` sums the wall time of this manager's
    saves."""

    def __init__(self, path: str):
        self.path = path
        self.seconds = 0.0

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def save(self, state: GPIRTState, meta: dict, draws: Dict[str, np.ndarray],
             rng_state: Optional[torch.Tensor] = None,
             shard_rng_states: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Write the file through a temporary one in its directory and
        ``os.replace``: a failed write leaves the previous checkpoint.
        ``shard_rng_states`` maps "item", "resp" and "cell" to the shards'
        generator states (:class:`Checkpoint`'s fields)."""
        t = time.perf_counter()
        meta = dict(meta, format_version=CHECKPOINT_FORMAT_VERSION)
        payload = {f"state_{k}": v.detach().cpu().numpy()
                   for k, v in state._asdict().items()}
        for k, v in draws.items():
            payload[f"draws_{k}"] = np.asarray(v)
        if rng_state is not None:
            payload["rng_state"] = rng_state.cpu().numpy().astype(np.uint8)
        for k, v in (shard_rng_states or {}).items():
            payload[f"{k}_rng_state"] = v.cpu().numpy().astype(np.uint8)
        payload["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
        os.close(fd)
        try:
            with open(tmp, "wb") as fh:
                np.savez(fh, **payload)
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self.seconds += time.perf_counter() - t

    def load(self, device="cpu") -> Optional[Checkpoint]:
        """The checkpoint, its state on ``device`` (theta_idx as int64), or
        None if the file does not exist. The drivers check its run spec."""
        if not self.exists():
            return None
        with np.load(self.path) as z:
            if "meta_json" not in z.files:
                raise ValueError(
                    f"{self.path} is not a gpirt checkpoint (no meta record); "
                    "refusing to resume from it"
                )
            meta = json.loads(bytes(z["meta_json"]).decode())
            ver = meta.get("format_version")
            if ver != CHECKPOINT_FORMAT_VERSION:
                raise ValueError(
                    f"checkpoint {self.path} has format version {ver!r}; this "
                    f"build reads version {CHECKPOINT_FORMAT_VERSION}. Delete "
                    "the stale checkpoint (or finish the run with the build "
                    "that wrote it)."
                )
            state = GPIRTState(**{
                k: torch.as_tensor(z[f"state_{k}"], device=device,
                                   dtype=torch.int64 if k == "theta_idx" else None)
                for k in _STATE_FIELDS})
            draws = {
                k[len("draws_"):]: z[k] for k in z.files if k.startswith("draws_")
            }
            rngs = [z[k] if k in z.files else None
                    for k in ("rng_state", "item_rng_state", "resp_rng_state",
                              "cell_rng_state")]
        return Checkpoint(state, meta, draws, *rngs)


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _run_spec(gen: torch.Generator, n_chains: int, thin: int, burn_iterations: int,
              store_f: bool, store_fstar: bool, config: GPIRTConfig, n_temps: int = 1,
              **extra) -> dict:
    values = (thin, burn_iterations, int(n_chains), bool(store_f), bool(store_fstar),
              config_digest(config))
    return dict(zip(_RUN_SPEC_KEYS, values), rng_device=gen.device.type,
                n_temps=int(n_temps), **extra)


def _start(manager: Optional[CheckpointManager], spec: dict, gen: torch.Generator,
           config: GPIRTConfig, fresh, shards: Optional[Shards] = None,
           shard_gens: Optional[ShardGenerators] = None):
    """(the state to advance in a :class:`Carry`, the sweeps run, the draws
    so far, the meta): the manager's checkpoint, checked against ``spec``,
    with ``gen`` set to its generator state and the state's shared fields
    made the views the sweep makes (f* under constant_IRF); without one,
    or without a manager, ``fresh()``'s state at sweep 0. On a mesh
    (``shards``) the state is this rank's block, and ``shard_gens`` take
    their shards' saved states, or on other shard counts than the file's
    the states of the module docstring's rule."""
    ck = None if manager is None else manager.load(device=gen.device)
    if ck is None:
        return Carry(fresh()), 0, {}, {}
    if ck.rng_state is None:
        raise ValueError(
            f"checkpoint {manager.path} holds no generator state (rng_state): it "
            "was not written by gpirt_tpu_torch (the JAX package writes none), "
            "and the port cannot continue its random stream. Delete it to start "
            "fresh.")
    shards = Shards() if shards is None else shards
    _check_run_spec(ck.meta, spec, manager.path)
    here = (_device_name(gen.device), torch.__version__)
    there = (ck.meta.get("device_name"), ck.meta.get("torch_version"))
    if here != there:
        print(f"[gpirt] checkpoint {manager.path} was written on {there[0]} with "
              f"torch {there[1]} and resumes on {here[0]} with torch {here[1]}: "
              "the draws are valid, but not bitwise those of the uninterrupted "
              "run", file=sys.stderr)
    seed = gen.initial_seed()
    gen.set_state(torch.from_numpy(np.ascontiguousarray(ck.rng_state, np.uint8)))
    if (int(ck.meta.get("item_shards", 1)), int(ck.meta.get("resp_shards", 1))) == (
            shards.n_item, shards.n_resp):
        for g, saved in _shard_streams(shards, shard_gens, ck):
            g.set_state(torch.from_numpy(np.ascontiguousarray(saved, np.uint8)))
    elif shard_gens is not None:  # another layout: the module docstring's rule
        fresh = resume_shard_generators(seed, shards, int(ck.meta["iteration"]), gen.device)
        for g, new in zip(shard_gens, fresh):
            if g is not None:
                g.set_state(new.get_state())
    state = ck.state
    if shards != Shards():
        state = lane_state_block(state, shards)
    if config.constant_IRF:  # one f* a chain, an expand view over the sessions
        fs = state.fstar[:, :1].contiguous()
        state = state._replace(fstar=fs.expand(state.fstar.shape))
    return Carry(state), int(ck.meta["iteration"]), dict(ck.draws), ck.meta


def _shard_streams(shards: Shards, shard_gens: Optional[ShardGenerators], ck: Checkpoint):
    """(this rank's shard generator, its row of the checkpoint's saved
    states) for each distinct generator of ``shard_gens``."""
    if shard_gens is None:
        return []
    out = []
    if shard_gens.item is not None:
        out.append((shard_gens.item, ck.item_rng_state[shards.item_rank]))
    if shard_gens.resp is not None:
        out.append((shard_gens.resp, ck.resp_rng_state[shards.resp_rank]))
    if _own_cell(shard_gens):
        out.append((shard_gens.cell, ck.cell_rng_state[shards.item_rank, shards.resp_rank]))
    return out


def _own_cell(shard_gens: ShardGenerators) -> bool:
    """Whether the cell's generator is its own (both axes sharded)."""
    return shard_gens.cell is not None and all(
        shard_gens.cell is not g for g in (shard_gens.item, shard_gens.resp))


def _save(manager: CheckpointManager, carry: Carry, meta: dict, draws, gen,
          shards: Optional[Shards], shard_gens: Optional[ShardGenerators]) -> None:
    """Save the run; on a mesh every rank gathers the lane states and the
    shards' generator states, rank 0 writes, and the ranks meet after the
    write."""
    if shards is None:
        manager.save(carry.state, meta, draws, gen.get_state())
        return
    state = assemble_lane_state(carry.state, shards)
    rngs = {}

    def row(g):
        return g.get_state().to(torch.int64)[None]

    if shard_gens is not None:
        if shard_gens.item is not None:
            rngs["item"] = gather_items(row(shard_gens.item), shards, 0)
        if shard_gens.resp is not None:
            rngs["resp"] = gather_respondents(row(shard_gens.resp), shards, 0)
        if _own_cell(shard_gens):
            rngs["cell"] = gather_respondents(gather_items(row(shard_gens.cell)[None], shards,
                                                           0), shards, 1)
    meta = dict(meta, item_shards=shards.n_item, resp_shards=shards.n_resp)
    if dist.get_rank() == 0:
        manager.save(state, meta, draws, gen.get_state(), rngs)
    dist.all_reduce(torch.zeros(1))  # the ranks meet once the file is written


def _drive(manager: Optional[CheckpointManager], gen: torch.Generator, spec: dict,
           carry: Carry, done: int, end: int, draws: Dict[str, np.ndarray], sched,
           total: int, sample_iterations: int, checkpoint_every: int,
           chunk_iterations: Optional[int], on_progress, step, extra=lambda done: {},
           shards: Optional[Shards] = None, shard_gens: Optional[ShardGenerators] = None):
    """Advance ``carry`` from absolute sweep ``done`` to ``end`` in chunks
    of ``checkpoint_every`` sweeps: ``step(start, stop)`` returns the
    chunk's stored draws on the device, which go to host numpy and join
    ``draws``; after each chunk the state is saved with ``extra(done)``'s
    meta (:func:`_save`; on a mesh, ``shards``). Without a manager nothing
    is saved, and the chunks are ``chunk_iterations`` sweeps (None: the
    whole range); on a mesh every rank must chunk alike, since a chunk ends
    in collectives. ``on_progress(done, total)`` is called after each
    chunk. Returns (done, draws)."""
    chunk = checkpoint_every if manager is not None else chunk_iterations
    if chunk is None:
        chunk = max(end - done, 1)
    elif chunk < 1:
        name = "checkpoint_every" if manager is not None else "chunk_iterations"
        raise ValueError(f"{name} must be >= 1, got {chunk}")
    while done < end:
        stop = min(done + chunk, end)
        recs = step(done, stop)
        for k, v in recs.items():
            host = v.cpu().numpy()
            draws[k] = host if k not in draws else np.concatenate([draws[k], host], 1)
        done = stop
        if manager is not None:
            meta = dict(spec, **extra(done), pre_done=min(done, sched.pre_iterations),
                        recs_done=next(iter(draws.values())).shape[1] if draws else 0,
                        sample_iterations=sample_iterations, total=total, iteration=done,
                        device_name=_device_name(gen.device),
                        torch_version=torch.__version__)
            _save(manager, carry, meta, draws, gen, shards, shard_gens)
        if on_progress is not None:
            on_progress(min(done, total), total)
    return done, draws


def run_chains_checkpointed(
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
    manager: Optional[CheckpointManager] = None,
    checkpoint_every: int = 200,
    on_progress=None,
    initial_states: Optional[GPIRTState] = None,
    chunk_iterations: Optional[int] = None,
    mesh=None,
    item_axis: Optional[str] = None,
    respondent_axis: Optional[str] = None,
    shard_gens: Optional[ShardGenerators] = None,
) -> Dict[str, np.ndarray]:
    """:func:`~gpirt_tpu_torch.models.sampler.run_chains`, resumable: the K
    chains advance ``checkpoint_every`` sweeps at a time, and the state,
    the draws so far and ``gen``'s state are saved after each chunk. A
    checkpoint in ``manager`` is resumed (its run spec checked, ``gen``
    set to its state, ``initial_states`` not used); otherwise the run
    starts as ``run_chains`` does. Uninterrupted, or interrupted and
    resumed on the same device type, card and torch build, it draws what
    ``run_chains`` draws from the same generator, bit for bit. Without a
    manager it saves nothing and runs ``chunk_iterations`` sweeps at a time
    (None: the whole range at once; alike on every rank of a mesh), which
    sets only how often ``on_progress`` is called: the draws do not depend
    on it.
    ``on_progress(done, total)`` is called after each chunk (each save).

    On a ``mesh`` (every rank calls this with the whole inputs) the run is
    ``run_chains(mesh=..., item_axis=..., respondent_axis=...)``'s,
    ``initial_states`` this rank's block, and every rank returns the whole
    draws; the file holds the whole run (module docstring).

    Returns host numpy draws with a leading chain axis, ``run_chains``'s
    names and layouts.
    """
    sched = sample_schedule(sample_iterations, burn_iterations, thin)
    spec = _run_spec(gen, theta_init.shape[0], thin, burn_iterations, store_f, store_fstar,
                     config)
    shards, shard_gens, y, consts, config, start_state = chain_start(
        gen, theta_init, thresholds_init, y, consts, config, mesh, item_axis, respondent_axis,
        shard_gens)

    def fresh():
        return start_state() if initial_states is None else initial_states

    carry, done, draws, _ = _start(manager, spec, gen, config, fresh, shards, shard_gens)

    def step(start, stop):
        return advance_chains(gen, carry, y, consts, config, sched, start, stop,
                              store_f=store_f, store_fstar=store_fstar, shards=shards,
                              shard_gens=shard_gens)

    _, draws = _drive(manager, gen, spec, carry, done, run_length(sched), draws, sched,
                      sample_iterations + burn_iterations, sample_iterations,
                      checkpoint_every, chunk_iterations, on_progress, step, shards=shards,
                      shard_gens=shard_gens)
    return {k: v[:, :sched.n_samples] for k, v in draws.items()}


def run_tempered_chains_checkpointed(
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
    n_temps: int = 4,
    max_temp: float = 32.0,
    swap_every: int = 1,
    store_f: bool = False,
    store_fstar: bool = False,
    manager: Optional[CheckpointManager] = None,
    checkpoint_every: int = 200,
    on_progress=None,
    chunk_iterations: Optional[int] = None,
    mesh=None,
    item_axis: Optional[str] = None,
    respondent_axis: Optional[str] = None,
    shard_gens: Optional[ShardGenerators] = None,
) -> Dict[str, np.ndarray]:
    """:func:`~gpirt_tpu_torch.parallel.tempering.run_tempered_chains`,
    resumable as :func:`run_chains_checkpointed` is: the G L lane states,
    the (G L,) tally of accepted swaps (meta ``swap_acc``) and the sweeps
    run (``swaps``, which sets the swap phase's parity and swap_rate's
    count of phases, as JAX's ``run_tempered_chains_checkpointed`` counts
    them) persist with the cold lanes' draws. Uninterrupted, or interrupted
    and resumed, it equals ``run_tempered_chains`` from the same generator,
    swap_rate included. ``chunk_iterations`` and ``on_progress`` are
    :func:`run_chains_checkpointed`'s.

    On a ``mesh`` (every rank calls this with the whole inputs) the run is
    ``run_tempered_chains(mesh=..., item_axis=..., respondent_axis=...)``'s;
    the file holds the whole ensemble and tally, and the shards' generator
    states, as :func:`run_chains_checkpointed`'s does, and resumes as it
    does: bit for bit onto the same shard counts, and onto others by the
    module docstring's stream rule.

    Returns the cold chains' host numpy draws with a leading (G,) chain
    axis, plus "swap_rate" (L - 1,).
    """
    sched = sample_schedule(sample_iterations, burn_iterations, thin)
    G = theta_init.shape[0]
    spec = _run_spec(gen, G, thin, burn_iterations, store_f, store_fstar, config,
                     n_temps, max_temp=float(max_temp), swap_every=int(swap_every))
    st = tempered_start(gen, theta_init, thresholds_init, y, consts, config, n_temps,
                        max_temp, mesh, item_axis, respondent_axis, shard_gens)
    carry, done, draws, meta = _start(manager, spec, gen, st.config, st.fresh, st.shards,
                                      st.shard_gens)
    accepted = torch.as_tensor(meta.get("swap_acc", [0] * (G * int(n_temps))),
                               dtype=torch.int64, device=st.temps.device)[st.lanes]

    def step(start, stop):
        nonlocal accepted
        accepted, recs = advance_tempered(gen, carry, accepted, st, n_temps, swap_every,
                                          sched, start, stop, store_f=store_f,
                                          store_fstar=store_fstar)
        return recs

    done, draws = _drive(manager, gen, spec, carry, done, run_length(sched, trailing=False),
                         draws, sched, sample_iterations + burn_iterations,
                         sample_iterations, checkpoint_every, chunk_iterations, on_progress,
                         step,
                         lambda done: {"swap_acc": gather_tally(accepted, st).cpu().tolist(),
                                       "swaps": done},
                         shards=st.shards, shard_gens=st.shard_gens)
    out = {k: v[:, :sched.n_samples] for k, v in draws.items()}
    out["swap_rate"] = swap_rate(gather_tally(accepted, st).cpu().numpy(), n_temps, done,
                                 swap_every)
    return out


def run_chain_checkpointed(
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
    manager: Optional[CheckpointManager] = None,
    checkpoint_every: int = 200,
    on_progress=None,
) -> Dict[str, np.ndarray]:
    """One chain, resumable: :func:`run_chains_checkpointed` with a chain
    axis of 1 (``theta_init`` (H, n)), its outputs squeezed."""
    draws = run_chains_checkpointed(
        gen, y, theta_init.unsqueeze(0), thresholds_init, consts, config,
        sample_iterations=sample_iterations, burn_iterations=burn_iterations,
        thin=thin, store_f=store_f, store_fstar=store_fstar, manager=manager,
        checkpoint_every=checkpoint_every, on_progress=on_progress)
    return {k: v[0] for k, v in draws.items()}
