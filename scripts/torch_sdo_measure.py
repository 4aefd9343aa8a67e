"""The port on one CUDA card: where a sampling sweep's time goes, on SDO,
the dynamic, the shared-IRF, the synthetic, the two-stage, the tempering,
the campaigns8, the ESS theta, the interleave or the affine configuration.

    python3 scripts/torch_sdo_measure.py
        [--config sdo|dynamic|shared_irf|synthetic|two_stage|tempering|campaigns8|
                  theta_ess|interleave|affine]
        [--threshold-method ess|newton] [--trace-dir DIR]

Runs the SDO survey (1500 respondents x 16 items, C = 5), or one of
chip_smoke.py's configurations: ``dynamic`` (150 x 60 x 10 sessions,
binary, GP theta regime), ``shared_irf`` (the same data with one IRF
shared by the sessions, constant_IRF=1: the grid sampler), ``synthetic`` (simulate_2pl 5000 x 1000, 10%
missing, every chain from one spread init), ``two_stage`` (senate116
through f_method="two_stage" from bench.py's spread init) or
``tempering`` (senate116, 4 temperatures to T = 4 a chain: 256 lanes, the
swap phase timed as a block), through gpirt_mcmc with 64 chains, burn 200
and 41 draws; or ``campaigns8`` (senate116 through gpirt_campaigns, 8
campaigns of 64 chains, Newton cutpoints: 512 lanes, with 2 SMC steps and
the same burn and draws); or senate116 as chip_smoke.py's phases 27-29
run it: ``theta_ess`` (theta_method="ess" from bench.py's spread init),
``interleave`` (threshold_ess_every=4, mix_subsweeps=2) and ``affine``
(affine_shift_max=16, affine_rounds=2, through run_chains from spread
inits; the orbit's time is inside the moves'). It observes the sampling
sweeps (through
models.sampler's, or parallel.tempering's, call of gibbs_sweep):

  sweeps 5-19   the wall by the host clock (a synchronise at each end), and
                the rounds and host syncs of ess_update (the cutpoint ESS;
                f and beta under two_stage; f* and beta under shared_irf;
                theta under theta_ess) in them;
  sweeps 20-29  each block of the sweep timed by CUDA events around its
                call (the stream's time from the block's first launch to
                its last, idle gaps included);
  sweeps 30-39  traced with torch.profiler: device time by operator and the
                device's busy share; with --trace-dir the profiler's table
                and its Chrome trace are written into DIR.

Prints the card's name and power limit first.
"""

import argparse
import os
import sys
import time
from collections import defaultdict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from chip_smoke import (  # noqa: E402
    DYN_LS,
    DYN_VOTES,
    K,
    SEED,
    SYN_M,
    SYN_MISSING,
    SYN_N,
    affine_run,
    card,
    dynamic_inputs,
    log,
    spread_init,
)
from gpirt_tpu_torch import gpirt_campaigns, gpirt_mcmc  # noqa: E402
from gpirt_tpu_torch.models import affine, gibbs, sampler  # noqa: E402
from gpirt_tpu_torch.parallel import tempering  # noqa: E402
from gpirt_tpu_torch.ops.ess import ess_update  # noqa: E402
from gpirt_tpu_torch.utils.datasets import (  # noqa: E402
    load_sdo,
    senate116_response_matrix,
    simulate_2pl,
)
from torch_threshold_ess_measure import report_profile  # noqa: E402

BURN, DRAWS = 200, 41
# sampling-sweep indices; report_profile labels the wall window 5-19 and
# divides by a window of ten sweeps, as here
WALL_FROM, BLOCKS_FROM, PROF_FROM, PROF_TO = 5, 20, 30, 40
BLOCKS = [(gibbs, name) for name in (
    "_draw_theta_grid", "_draw_theta_ess", "draw_z_truncnorm", "draw_fstar_conjugate",
    "draw_beta_conjugate", "draw_f", "draw_fstar", "draw_fstar_direct", "draw_beta",
    "draw_threshold", "draw_threshold_collapsed", "draw_threshold_shift",
    "_draw_threshold_binary_newton", "_draw_threshold_newton_ordinal",
    "ordinal_ll_terms")] + [(tempering, "_swap"), (affine, "affine_theta_moves"),
                            (affine, "shift_orbit_gibbs")]


def timed_blocks(events):
    """Wrap the sweep's blocks so that each call records a pair of CUDA
    events into ``events[name]`` while ``events["on"]`` is set."""
    real = {(mod, name): getattr(mod, name) for mod, name in BLOCKS}

    def wrap(name, fn):
        def timed(*args, **kw):
            if not events["on"]:
                return fn(*args, **kw)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kw)
            b.record()
            events[name].append((a, b))
            return out
        return timed

    for (mod, name), fn in real.items():
        setattr(mod, name, wrap(name, fn))
    return real


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="sdo",
                    choices=["sdo", "dynamic", "shared_irf", "synthetic", "two_stage",
                             "tempering", "campaigns8", "theta_ess", "interleave",
                             "affine"])
    ap.add_argument("--threshold-method", default="ess", choices=["ess", "newton"])
    ap.add_argument("--trace-dir", help="where the profiler's table and trace go")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = card()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
    events = defaultdict(list)
    events["on"] = False
    stamps, counts = {}, {}
    chain_loop = tempering if opt.config == "tempering" else sampler
    sweep = chain_loop.gibbs_sweep
    calls = [0]

    def observed(*args, **kw):
        s = calls[0] - BURN
        calls[0] += 1
        if s in (WALL_FROM, BLOCKS_FROM, PROF_FROM):
            torch.cuda.synchronize()
            stamps[s] = time.perf_counter()
            counts[s] = (ess_update.calls, ess_update.rounds, ess_update.syncs)
        events["on"] = BLOCKS_FROM <= s < PROF_FROM
        if s == PROF_FROM:
            prof.start()
        if s == PROF_TO:
            prof.stop()
        return sweep(*args, **kw)

    if opt.config == "sdo":
        data, kw = load_sdo(), dict(vote_codes=None)
    elif opt.config in ("dynamic", "shared_irf"):
        _, data, init = dynamic_inputs()
        kw = dict(vote_codes=DYN_VOTES, theta_ls=DYN_LS, theta_init=init,
                  constant_IRF=int(opt.config == "shared_irf"))
    elif opt.config == "synthetic":
        _, data = simulate_2pl(0, n=SYN_N, m=SYN_M, missing=SYN_MISSING)
        init = np.random.default_rng(0).permutation(np.linspace(-3, 3, SYN_N))
        kw = dict(vote_codes=DYN_VOTES, theta_init=init)
    elif opt.config == "two_stage":
        data, _, _ = senate116_response_matrix()
        kw = dict(f_method="two_stage", theta_init=spread_init(data.shape[0]))
    elif opt.config in ("theta_ess", "interleave", "affine"):
        data, _, _ = senate116_response_matrix()
        kw = {"theta_ess": dict(theta_method="ess", theta_init=spread_init(data.shape[0])),
              "interleave": dict(threshold_method="interleave", threshold_ess_every=4,
                                 mix_subsweeps=2),
              "affine": {}}[opt.config]
    else:  # tempering, campaigns8
        data, _, _ = senate116_response_matrix()
        kw = dict(n_temps=4, max_temp=4.0)

    def run():
        if opt.config == "affine":
            return affine_run(data, torch.device("cuda"), 16, 2, burn=BURN, draws=DRAWS)
        if opt.config == "campaigns8":
            return gpirt_campaigns(np.asarray(data), n_campaigns=8, vote_codes=None,
                                   sample_iterations=DRAWS, burn_iterations=BURN,
                                   smc_steps=2, SEED=SEED, store_draws=False,
                                   verbose=False, device="cuda")
        return gpirt_mcmc(data, DRAWS, BURN, CHAIN=K, SEED=SEED, dtype="float32",
                          device="cuda", verbose=False, **kw)

    kw.setdefault("threshold_method", opt.threshold_method)
    real = timed_blocks(events)
    chain_loop.gibbs_sweep = observed
    try:
        run()
    finally:
        chain_loop.gibbs_sweep = sweep
        for (mod, name), fn in real.items():
            setattr(mod, name, fn)

    n_wall = BLOCKS_FROM - WALL_FROM
    wall_ms = (stamps[BLOCKS_FROM] - stamps[WALL_FROM]) / n_wall * 1e3
    c0, c1 = counts[WALL_FROM], counts[BLOCKS_FROM]
    log(f"{opt.config} sampling sweeps on {smi}, cutpoints by {kw['threshold_method']}: wall "
        f"{wall_ms:.4f} ms a sweep (sweeps {WALL_FROM}-{BLOCKS_FROM - 1}); ess_update "
        f"{(c1[1] - c0[1]) / max(c1[0] - c0[0], 1):.2f} rounds an update, "
        f"{(c1[2] - c0[2]) / n_wall:.2f} host syncs a sweep")
    torch.cuda.synchronize()
    n_blk = PROF_FROM - BLOCKS_FROM
    blk_wall = (stamps[PROF_FROM] - stamps[BLOCKS_FROM]) / n_blk * 1e3
    log(f"blocks, sweeps {BLOCKS_FROM}-{PROF_FROM - 1} (wall {blk_wall:.4f} ms a "
        f"sweep with the events):")
    for _, name in BLOCKS:
        if events[name]:
            ms = sum(a.elapsed_time(b) for a, b in events[name]) / n_blk
            log(f"  block {name}: {ms:.4f} ms a sweep ({len(events[name]) // n_blk} "
                f"calls a sweep)")
    report_profile(prof, wall_ms, smi, opt.trace_dir)
    log(card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
