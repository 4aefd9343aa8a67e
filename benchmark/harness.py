"""One run of one cell: the port's set-up as ``gpirt_mcmc``'s default call
makes it, a window of sampling sweeps on the host clock, and the
reference's judgement of what the window produced.

Set-up (``setup_s``, from process start to the first timed sweep): the
data set from the benchmark's own copy (``datasets/<name>.py``), the
program's recode and ``encode_categories``, ``make_constants`` on the
device, the configuration's theta inits (``inits/<name>.py``) and a
``torch.Generator`` from ``--seed``, its SMC anneal
(``parallel/smc.anneal_init``) or prior init, and its burn-in through
``models/sampler.advance_chains``; the CUDA kernel's library is built from
``gpirt_tpu_torch/_build/`` there on a checkout's first run. The
configuration's ``program`` settings go to ``GPIRTConfig`` whole, and its
reference (``reference/<name>.py``) refuses settings it does not follow.

The window drives ``advance_chains`` one sweep at a time until
``seconds`` have passed on the host clock; the stored draws of every
``chunk_sweeps`` sweeps, and of the last partial chunk, go to host numpy,
as the default call's chunks do. It counts every sweep over all the
elapsed time, the copies included. The check (``check.py``) judges two
sweeps: the window's first, from a snapshot of the state taken in set-up,
and one more sweep run after the window has closed and the peak memory is
read, through the same objects, from a snapshot taken there.

With ``trace`` the profiler records the window's first
:data:`TRACE_SECONDS`; its stop is left out of the window's time.
"""

from __future__ import annotations

import gc
import resource
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

from benchmark import check
from benchmark import trace as tracing
from benchmark.cells import Cell, load_data, load_module
from gpirt_tpu_torch.api import default_thresholds, full_fp32_matmuls
from gpirt_tpu_torch.models.config import GPIRTConfig, make_constants
from gpirt_tpu_torch.models.sampler import (Carry, advance_chains, chain_start, draw_record,
                                            sample_schedule)
from gpirt_tpu_torch.ops.ess import ess_update
from gpirt_tpu_torch.ops.threshold_ess import binary_threshold_ess
from gpirt_tpu_torch.parallel.smc import anneal_init
from gpirt_tpu_torch.utils.response import (DEFAULT_VOTE_CODES, as_response_matrix,
                                            encode_categories)

TRACE_SECONDS = 3.0
VOTE_CODES = {"voteview": DEFAULT_VOTE_CODES, None: None}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _flush(parts: list, chunks: list, device: torch.device) -> float:
    """Copy a chunk's stored draws (one record dict a sweep, (K, 1, ...)
    each) to host numpy; the seconds of the copy, after the sweeps are done."""
    _sync(device)
    t = time.perf_counter()
    chunks.append({k: torch.cat([p[k] for p in parts], dim=1).cpu().numpy() for k in parts[0]})
    return time.perf_counter() - t


def setup(cell: Cell, seed: int, device: torch.device) -> dict:
    """The program's set-up, burnt in and warm. Returns the run's state."""
    cfg, K = cell.config, cell.traffic["chains"]
    ref = load_module("reference", cfg["reference"])
    raw, y_ref, C_ref = load_data(cfg)
    codes = VOTE_CODES[cfg["vote_codes"]]
    data = raw if codes is None else as_response_matrix(raw, codes, verbose=False)
    y, C, _ = encode_categories(np.asarray(data, dtype=np.float64))
    H, n, m = y.shape
    if cfg.get("rows") is None and cfg.get("cols") is None and \
            (n, m, C, H) != (cfg["n"], cfg["m"], cfg["C"], cfg["H"]):
        raise ValueError(f"{cfg['name']}: the data give n, m, C, H = {(n, m, C, H)}")
    config = GPIRTConfig(n=n, m=m, horizon=H, C=C, **cfg["program"])
    ref.follows(config)
    full_fp32_matmuls()
    t = time.perf_counter()
    consts = make_constants(config, np.zeros((3, m)), np.full((3, m), cfg["beta_prior_sd"]),
                            np.zeros((2, n)), np.zeros((2, n)), device=device)
    _sync(device)
    constants_s = time.perf_counter() - t
    inits = load_module("inits", cfg["inits"]).inits(seed, K, n)
    yt = torch.as_tensor(np.ascontiguousarray(y), dtype=torch.int32, device=device)
    theta_init = torch.as_tensor(inits, dtype=config.tdtype, device=device)
    thr = torch.as_tensor(default_thresholds(C, m, H), dtype=config.tdtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    smc_s = None
    if cfg["smc_steps"] > 0:
        t = time.perf_counter()
        states, _ = anneal_init(gen, yt, theta_init, thr, consts, config,
                                n_steps=cfg["smc_steps"], max_temp=cfg["smc_max_temp"])
        _sync(device)
        smc_s = time.perf_counter() - t
    else:
        states = chain_start(gen, theta_init, thr, yt, consts, config)[-1]()
    carry = Carry(states)
    burn = cfg["burn"]
    sched = sample_schedule(10 ** 12, burn, 1)
    t = time.perf_counter()
    advance_chains(gen, carry, yt, consts, config, sched, 0, burn)
    _sync(device)
    burn_rate = burn / max(time.perf_counter() - t, 1e-9)
    # a chunk's worth of the record path's allocations and its copy, off the
    # window: the caching allocator holds them from the window's first chunk on
    chunk = cell.traffic["chunk_sweeps"]
    rec = draw_record(carry.state, carry.state.beta.new_zeros(K), consts, config, False, False)
    _flush([{k: torch.empty_like(v).unsqueeze(1) for k, v in rec.items()}
            for _ in range(chunk)], [], device)
    del rec
    first = check.snapshot(ref, carry.state, gen)
    # set-up's objects to the permanent generation: a collection in the
    # window then walks only what the window made
    gc.collect()
    gc.freeze()
    return dict(ref=ref, config=config, consts=consts, yt=yt, y=y, y_ref=y_ref, C_ref=C_ref,
                gen=gen, carry=carry, sched=sched, burn=burn, chunk=chunk,
                constants_s=constants_s, smc_s=smc_s, burn_rate=burn_rate, first=first)


class HostWatch:
    """What the host did to the process over the window, for the spread of
    host-bound cells: garbage collections a generation and their seconds,
    and involuntary context switches."""

    def __init__(self):
        self.gc_runs, self.gc_s, self._t = [0, 0, 0], 0.0, None
        gc.callbacks.append(self._gc)
        self._csw = resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_runs[info["generation"]] += 1
            self.gc_s += time.perf_counter() - self._t

    def close(self) -> dict:
        gc.callbacks.remove(self._gc)
        return {"gc_runs": self.gc_runs, "gc_s": round(self.gc_s, 6),
                "invol_csw": resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw - self._csw}


def window(run: dict, seconds: float, device: torch.device, trace: bool) -> dict:
    """The measured window; fills ``run`` with the host draws and counts."""
    gen, carry, config, consts, yt = (run[k] for k in ("gen", "carry", "config", "consts", "yt"))
    sched, burn, chunk = run["sched"], run["burn"], run["chunk"]
    syncs0, launches0 = ess_update.syncs, binary_threshold_ess.launches
    prof = mark = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        mark = torch.profiler.record_function(tracing.WINDOW_MARK)
        mark.__enter__()
    parts, chunks, copy_s, chunk_ends = [], [], [], []
    paused, traced = 0.0, None
    watch = HostWatch()
    t_start = time.perf_counter()
    deadline = t_start + seconds
    it = burn

    def stop_trace():
        nonlocal paused, traced
        _sync(device)
        mark.__exit__(None, None, None)
        t = time.perf_counter()
        prof.stop()
        paused = time.perf_counter() - t
        traced = (it - burn, t - t_start)

    while time.perf_counter() < deadline + paused:
        parts.append(advance_chains(gen, carry, yt, consts, config, sched, it, it + 1))
        it += 1
        if (it - burn) % chunk == 0:
            copy_s.append(_flush(parts, chunks, device))
            chunk_ends.append(time.perf_counter() - t_start - paused)
            parts = []
        if prof is not None and traced is None and \
                time.perf_counter() - t_start >= TRACE_SECONDS:
            stop_trace()
    if parts:
        copy_s.append(_flush(parts, chunks, device))
    _sync(device)
    window_s = time.perf_counter() - t_start - paused
    host_watch = watch.close()
    if prof is not None and traced is None:  # a window shorter than the trace
        stop_trace()
    run.update(
        window_s=window_s, sweeps=it - burn, copy_s=copy_s, chunk_ends=chunk_ends,
        host={k: np.concatenate([c[k] for c in chunks], axis=1) for k in chunks[0]},
        ess_syncs=ess_update.syncs - syncs0,
        kernel_launches=binary_threshold_ess.launches - launches0,
        memory_peak_bytes=torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0,
        prof=prof, traced=traced, host_watch=host_watch, it=it)
    return run


def last_sweep(run: dict) -> tuple:
    """One more sweep after the window, through the window's own objects,
    from where it left the chains: (the snapshot it starts from, its record
    on the host)."""
    gen, carry = run["gen"], run["carry"]
    snap = check.snapshot(run["ref"], carry.state, gen)
    rec = advance_chains(gen, carry, run["yt"], run["consts"], run["config"], run["sched"],
                         run["it"], run["it"] + 1)
    return snap, {k: v[:, 0].cpu().numpy() for k, v in rec.items()}


def judge(cell: Cell, run: dict, device: torch.device, control: bool = False,
          faults=None) -> dict:
    """Run the sweep after the window, free the program's state, and run
    the reference over the window's first sweep and that one."""
    sweeps = [(run.pop("first"), {k: v[:, 0] for k, v in run["host"].items()}),
              last_sweep(run)]
    for k in ("carry", "consts", "yt", "gen"):
        run.pop(k, None)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    replay = check.Replay(run["ref"], cell.config, run["y_ref"], run["C_ref"], device)
    verdict = check.judge_sweeps(replay, sweeps, cell.limits, control, faults)
    verdict["same_data"] = bool(np.array_equal(run["y"][0], run["y_ref"]))
    return verdict


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return proc.stdout.strip() or None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             t0: Optional[float] = None, control: bool = False, faults=None) -> dict:
    """Set-up, window and check of one run. Returns the run's context for
    the metric readers: the counts, the window, the verdict and, with
    ``trace``, the read trace. ``control`` and ``faults`` add the control's
    numbers and those of planted faults to the verdict
    (:func:`check.judge_sweeps`)."""
    device = torch.device(device)
    t0 = time.perf_counter() if t0 is None else t0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run = setup(cell, seed, device)
    _sync(device)
    run["setup_s"] = time.perf_counter() - t0
    try:
        window(run, seconds, device, trace)
    finally:
        gc.unfreeze()
    prof = run.pop("prof")
    run["trace"] = None
    if prof is not None and device.type == "cuda":
        run["trace"] = tracing.read_trace(prof, run["traced"][0])
    del prof
    run["verdict"] = judge(cell, run, device, control, faults)
    run["power"] = power_limit() if device.type == "cuda" else None
    run["cell"] = cell
    ends = np.diff([0.0] + run["chunk_ends"])
    print(f"[bench] {cell.name} seed {seed}: setup {run['setup_s']:.3f} s, window "
          f"{run['window_s']:.3f} s, {run['sweeps']} sweeps, burn-in "
          f"{run['burn_rate']:.2f} sweeps/s, chunk seconds {np.round(ends, 3).tolist()}, "
          f"host {run['host_watch']}, traced (sweeps, s) {run['traced']}, "
          f"card {run['power']}", file=sys.stderr)
    return run
