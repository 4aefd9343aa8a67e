"""Smoke run of the PyTorch port (gpirt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py     # needs one CUDA card and nvcc
    python3 chip_smoke.py --basins [1,2,...]   # only the basin study (basin_study):
                              # where phase 5's call settles at each SEED,
                              # unsharded and on 2 respondent shards
    python3 chip_smoke.py --ess-layouts   # only ess_layouts: the respondent path's
                              # binary cutpoint ESS against one-layout versions

Phases, each of which stops the run with a non-zero exit on failure:
  1. device: a CUDA card is required; its name and power limit are printed;
  2. build: the CUDA kernel is compiled from gpirt_tpu_torch/csrc (timed);
  3. kernel check: the binary cutpoint ESS kernel against its plain PyTorch
     version at the main path's shape (64 chains x senate116's 418 items,
     100 respondents, float32) on random lanes, untempered and at T = 64;
  4. sweep check: one small sweep on the card against the same sweep on
     the CPU, from the same state and draws;
  5. main path: senate116 through gpirt_mcmc with 64 chains, 320 SMC steps
     from T = 64, burn 100 and 500 draws, checked for finite output and for
     one kernel launch per sweep; prints phase times, sweep rate and theta
     ESS per second. The kernel's inputs of the last sweep are kept;
  6. kernel at the main path's state: the check of phase 3 on those inputs,
     each lane's rounds, the work they need and the bound it gives;
  7. ordinal sweep check: one tempered (T = 4) C = 5 sweep on the card
     against the CPU from the same state and draws, with the cutpoints by
     ESS and by Newton-proposal MH, and once more with the card fed the
     CPU's z draw; prints the cells that set the z and f* differences;
  8. SDO path: the ordinal survey (1500 respondents x 16 items, C = 5)
     through gpirt_mcmc with 64 chains, burn 50 and 150 draws (cut from 100,
     250 to fit the time limit), f* stored;
     checked for finite ll and f*, ordered cutpoints that moved, one
     ordinal kernel launch a sweep and no binary one; prints the sweep
     rate, theta ESS and ESS per second, the host-looped ESS updates and
     the host syncs a sweep; then the ordinal cutpoint kernel against its
     plain version by phase 3's rule (a lane's error its largest over its
     C - 1 deltas) on random lanes at the benchmark's sdo-k512 shape (512
     chains x 16 items of 1500 respondents, C = 5, the survey's responses;
     8,192 lanes, where phase 3's 0.1% is 8 lanes), at T = 1 and 64, and on
     the kernel's inputs of the path's last sweep, timed, with each lane's
     rounds, the work they need and the bound it gives;
  9. GP sweep check: the check of phase 4 over three sessions in the GP
     theta regime (theta_ls = 2), at C = 2 and C = 5;
 10. dynamic path: simulate_dynamic's 150 respondents x 60 items x 10
     sessions (binary, 10% missing) through gpirt_mcmc in the GP regime
     with 64 chains, burn 100 and 300 draws; checked for the regime, one
     kernel launch per sweep, finite ll, cutpoints that moved and theta
     that differs between sessions; prints the sweep rate, theta ESS over
     the n H parameters and ESS per second, and the sign-aligned
     correlation of the posterior means with the true trait;
 11. kernel at the dynamic path's state: phase 6 on the inputs of its last
     sweep;
 12. two-stage sweep check: one untempered f_method="two_stage" sweep on the
     card against the CPU at C = 2 and 5, f* by Matheron's rule and by the
     posterior Cholesky, y drawn from the model at a state shared by the
     chains: theta equal, draw_f's f, beta and the cutpoints within 1e-3,
     f* and the f read from it within 1e-3 + 1e-3 |x| plus four times the
     lane's own float32 rounding spread on the CPU, all finite;
 13. two-stage path: senate116 through gpirt_mcmc(f_method="two_stage",
     store_f=True) with 64 chains from bench.py's spread init, burn 100 and
     200 draws, no SMC; checked for one kernel launch per sweep, finite ll
     and f, cutpoints that moved; prints the sweep rate, theta ESS and ESS per second, the ESS
     rounds an update and the host syncs a sweep;
 14. recovery: recover_fstar_batch over one chain's 200 stored draws of
     phase 13 (shape, finite, the same twice under one seed), and one draw's
     _recover_one on the card against the CPU given the same draws (draw_f
     within 1e-3, f* as in phase 12);
 15. fstar10k: bench.py::bench_fstar10k, simulate_2pl(0, n=100, m=50)
     through gpirt_mcmc(2 draws, store_f) and recover_fstar at a 10001-point
     grid twice (seeds 1 and 2), the second timed, the host constants
     apart; checked for one kernel launch per sampling sweep;
 16. synthetic: bench.py::bench_synthetic, simulate_2pl(0, n=5000, m=1000,
     missing=0.1) on the conjugate path with 64 chains from spread inits,
     burn 30 and 150 draws, through run_chains; checked for one kernel
     launch per sweep, finite ll, cutpoints that moved; prints the sweep
     rate, theta ESS per second and the peak device memory, then phase 6 on
     the inputs of its last sweep, where the kernel takes its tile path
     (n > 2048: a tile of items held in shared memory), with the path, the
     tile and the share of the bound printed;
 17. per-chain c: phase 3 on its random lanes with each chain at its own
     temperature on a geometric ladder from 1 to 64, and the kernel timed
     there against the same lanes with one scalar c;
 18. tempered sweep check: phase 4 (and, at C = 5, phase 7) with one
     temperature a chain (1, 4 and 16), at C = 2 and 5: the card against
     the CPU, every field within 1e-3 but f* within 1e-3 + 1e-3 |f*| (the
     untempered chain's f* reaches ~70 at the grid's edge, where float32
     alone moves it by ~1e-3), and its largest distance from the same sweep
     on the CPU in float64 printed;
 19. tempering path: senate116 through gpirt_mcmc(CHAIN=64, n_temps=4,
     max_temp=4.0, swap_every=1), burn 100 and 500 draws, no SMC (256
     lanes); checked for one kernel launch per sweep, each with 4 distinct
     c values, finite cold draws and swap rates; prints the swap rate by
     rung, the cold theta ESS and the sweep rate, then phase 6 on the inputs
     of its last sweep with their per-chain c;
 20. campaigns8: bench.py::bench_campaigns8 on one card, gpirt_campaigns on
     senate116 at campaign_schedule(2) (8 campaigns of 64 chains, SMC 160
     steps from T = 64, burn 25, 100 draws, Newton cutpoints: 512 lanes),
     a warm call (SEED 990001) and the timed one (SEED 100000); checked
     for finite output and no kernel launch; prints the pooled ESS per
     second, the batch wall, the campaign ESS and theta SE medians and the
     final weight ESS;
 21. chains64: bench.py::bench_chains64, 64 chains from spread inits, burn
     100 and 300 draws, no SMC, through run_chains; checked for one kernel
     launch per sweep; prints split R-hat's maximum and the pooled ESS per
     second of the sign-aligned draws;
 22. campaign agreement: phase 20's sign-aligned grand mean against the
     JAX package's (tests/fixtures/campaigns8_senate116_jax.npz, written
     by scripts/jax_campaign_fixture.py): Pearson r >= 0.99 and |z| <= 4
     for at least 95 of the 100 senators, z the difference over the root
     sum of the two campaign-replicated squared standard errors;
 23. shared-IRF sweep checks: one sweep on the card against the CPU over
     three sessions (GP regime, y drawn from the model) for the grid
     sampler with one IRF shared by the sessions (constant_IRF) and
     without, the conjugate one under constant_IRF with one temperature a
     chain (1, 4, 16), and the two-stage one under constant_IRF (f* from
     100 inducing points), at C = 2: theta equal, one kernel launch, every
     field within 1e-3 but f* within 1e-3 + 1e-3 |f*| when tempered, and
     the two-stage f and f* within that plus four times the lane's own
     float32 spread on the CPU; f* and the cutpoints one a chain;
 24. shared-IRF path: simulate_dynamic's 150 x 60 x 10 sessions through
     gpirt_mcmc(constant_IRF=1), the grid sampler (f* by ESS over the
     1001-point grid, the cutpoints by the kernel over one session of
     1500 stacked sites), 64 chains from the dynamic path's spread init,
     burn 100 and 150 draws (cut from 300 to fit the time limit); checked
     for one kernel launch and one f* ESS
     a sweep, finite ll, one cutpoint vector for the sessions, theta that
     differs between sessions and the truth correlation (|r| > 0.5);
     prints the sweep rate, theta ESS, the f* ESS's rounds and host syncs
     a sweep and the peak device memory, then phase 6 at the pooled state;
 25. shared-IRF recovery: recover_fstar(constant_IRF=1) on the card from a
     short shared-IRF run's stored draw (shape, finite, one f* for the
     sessions, repeatable), and that draw's _recover_one on the card
     against the CPU as in phase 14;
 26. sweep checks of the new blocks (OPTION_CHECKS): one sweep on the card
     against the CPU, y drawn from the model, for theta by ESS in the CST,
     RDM and GP regimes over three sessions, the collapsed cutpoints at
     C = 2, 5 and under constant_IRF, interleave on an ESS and a collapsed
     sweep, the (t, beta0) shift, two latent passes, and the affine moves
     untempered and with one temperature a chain: theta equal, or its
     difference a float32 tie by PERF.md section 2's rule, every other
     field within 1e-3 (f* 1e-3 + 1e-3 |f*| when tempered), the kernel
     launched once at C = 2 where the y-marginal ESS runs and never under
     the collapsed draw;
 27. ESS theta path: senate116 through gpirt_mcmc(theta_method="ess") with
     64 chains from bench.py's spread init, burn 100 and 250 draws (cut from
     500 to fit the time limit); checked for one kernel launch and one theta
     ESS a sweep and finite draws;
     prints the sweep rate, theta ESS and ESS per second, the theta ESS's
     rounds and host syncs a sweep, then phase 6 on the inputs of its last
     sweep;
 28. interleave path: senate116 through gpirt_mcmc(threshold_method=
     "interleave", threshold_ess_every=4, mix_subsweeps=2), 64 chains, burn
     100 and 500 draws: the kernel launched on every 4th sweep only (150 of
     600); prints the sweep rate and theta ESS;
 29. affine path: scripts/tune_bench.py's affine_shift_max=16,
     affine_rounds=2 and the moves off, senate116 through run_chains with
     64 chains from spread inits, burn 100 and 250 draws (cut from 500 to
     fit the time limit; tune_bench ran burn 500 and 1000 draws): one
     kernel launch a sweep each; prints each
     run's sweep rate, theta ESS, ESS per second and the moves' accept
     rates, and the ESS and wall ratios of on to off;
 30. past the tile capacity: the kernel at one respondent more than its
     tile path holds (its streaming path), 64 chains x 418 items of random
     lanes (10% missing, item 0 with no response), against its plain
     version at T = 1 and 64, timed, with its bound;
 31. checkpointed main path: phase 5's call with a checkpoint every 100
     sweeps in a temporary directory of this checkout, uninterrupted, and
     interrupted (the same call at 200 draws) then resumed: both hash
     (sha256 of theta, beta, threshold and ll) to phase 5's draws, one
     kernel launch a sweep over the pair, the SMC initialization once;
     prints the sampling sweeps/s against phase 5's, the seconds in the
     saves and the size of the last checkpoint;
 32. checkpointed tempering: phase 19's call interrupted after the burn
     and one chunk of 100 sweeps, then resumed: the cold draws and swap
     rates hash to phase 19's, one kernel launch a sweep;
 33. synthetic checkpoint: phase 16's configuration after one sweep (f
     1.28 GB, f* 256 MB), one CheckpointManager save and one load to the
     card, each timed, the loaded state equal bit for bit;
 34. profile_sweep at the main path's last state (phase 31's checkpoint):
     each block's time by CUDA events, positive, the blocks summing to
     within a factor of 2 of the whole sweep;
 35. utilities: a short run of phase 5's data with f and f* stored,
     posterior_irf of one chain (rows summing to 1) and
     posterior_predictive of every chain's draws on the card (in range,
     and its agreement with the observed votes);
 36. walkthrough: examples/torch_senate116_walkthrough.py's main() at its
     defaults (senate116, 4 chains, burn 500, SEED 1119) but 500 draws
     (2000 by default; cut to fit the time limit), one kernel launch a
     sweep (1000), then phase 6 at its last sweep's state (1,672 lanes) and
     its sign-aligned theta_hat against the JAX run's of the default call
     (tests/fixtures/examples_jax.npz, from
     scripts/jax_examples_fixture.py): |r| >= 0.95; prints JAX's own r
     between two seeds, the ESS and R-hat beside JAX's, the wall and the
     sweeps/s;
 37. SDO example: examples/torch_sdo_ordinal.py's main() at its defaults
     (1500 x 16, C = 5, one chain, burn 300, f* stored) but 300 draws (1000
     by default; cut to fit the time limit, the first 600 sweeps the
     default call's): no
     kernel launch, finite output, every item's cutpoints increasing and
     moved off qnorm(i/5); its one chain's basin depends on the seed (in
     JAX too), so its theta means are held at |r| >= 0.95 against the JAX
     run, of 16 seeds, in the same basin; prints item 1's cutpoints and IRF
     values beside that run's;
 38. sharded sweep check: one sweep of the main path's last state (phase
     31's checkpoint) with the items over 2 ranks that share the card
     through Gloo (parallel/distributed.launch), fed the unsharded sweep's
     draws cut to their items, against the unsharded sweep on the card:
     theta the same on both ranks and equal to the unsharded sweep's, or
     its difference a float32 tie by PERF.md section 2's rule, every other
     field within 1e-3; each rank's kernel against its plain version on its
     13,376 lanes;
 39. item-sharded main path: phase 5's call with mesh=make_item_mesh(2),
     item_axis="items", on 2 ranks of the card: one kernel launch a sweep
     on each rank at 64 x 209 lanes, finite, theta bit for bit the same on
     both ranks, its sign-aligned posterior theta means at r >= 0.999 with
     phase 5's; prints the backend, the sweeps a second, the theta table's
     all_reduce bytes and its ms a sweep, timed inside the run (CUDA
     events on the sweep's stream), each rank's peak memory, and the
     kernel at rank 0's state against its plain version, timed, with its
     bound;
 40. the 2 x 2 chains x items mesh: phase 39's checks on 4 ranks, 32 x 209
     lanes, at phase 5's burn 100 and 500 draws;
 41. chain mesh: one sweep of a 32-chain block of the main path's last
     state against the 64-chain sweep (bit for bit, or held as phase 38),
     phase 5's call on a 2-rank chain mesh checkpointed every 100 sweeps and
     cut at 200 draws, its draws' sha256 beside phase 5's first 200 draws',
     then resumed with no mesh beside phase 5's; bit for bit both hash to
     phase 5's, and where the card's batched products round differently at
     32 chains, that is printed and both are held to phase 5's posterior
     theta means at r >= 0.999; prints what the replicated generator costs
     a sweep at the main path and the synthetic configuration;
 42. respondent-sharded sweep check: phase 38's sweep with the respondents
     over 2 ranks (parallel/respondents.py), fed the unsharded sweep's draws
     cut to their respondents, against the unsharded sweep on the card:
     beta, the cutpoints and f* bit for bit the same on both ranks (the
     replication canary), theta equal or a float32 tie, every other field
     within 1e-3; then the same with the affine moves on (phase 29's W =
     16, 2 rounds), the low-rank z-marginal and orbit against the dense
     forms; no kernel launch (under a respondent axis the cutpoint ESS runs
     its plain round loop, each round's lane totals all-reduced, as JAX
     leaves its kernel there);
 43. respondent-sharded main path: phase 5's call at 40 SMC steps, burn 10
     and 40 draws (cut from 320 steps, burn 25 and 125 draws to fit
     the time limit: the call's r is not gated) with mesh=make_respondent_mesh(2),
     respondent_axis="respondents" (64 chains x 50 respondents a rank): finite, no kernel launch, theta, beta and the
     cutpoints the same on both ranks; its sign-aligned posterior theta
     means' r with phase 5's printed, not gated: senate116's 64-chain SMC
     ensemble settles in one of several basins by its random stream, and a
     respondent shard's streams are its own (`--basins`, basin_study: at
     SEED 2-8 unsharded 3 of 7 runs land in phase 5's basin, on 2
     respondent shards at SEED 1-8 2 of 8; unsharded SEED 6 sits at r 0.295
     with phase 5's, where this call sits; PERF.md §6). The posterior gate
     of phases 39-40, r >= 0.999 with phase 5's means, is held by the
     sharded sampler continued from phase 5's last state (phase 31's
     checkpoint) for CONT_DRAWS (50, cut from 100) draws, beside the unsharded
     continuation's r; prints the
     sweeps a second beside phases 5 and 39, the cutpoint ESS rounds an
     update, each all_reduce site's calls, bytes and ms a sweep (CUDA events
     on the sweep's stream, in the run) and each rank's peak memory;
 44. respondent-sharded synthetic: phase 16's run (5000 x 1000, 64 chains)
     at burn 5, 20 draws (cut from 10, 40) on 2 respondent shards: finite, no kernel launch,
     the same draws on both ranks, its posterior theta means at r >= 0.99
     with phase 16's (two short runs' means, not the truth); prints each
     rank's peak device memory beside phase 16's, the sweeps a second
     beside phase 16's and the all_reduce sites;
 45. the 2 x 2 items x respondents mesh: phase 43's checks on 4 ranks, the
     theta table's all_reduce over the item group and the sufficient
     statistics' over the respondent group, at phase 43's SMC steps, burn and
     draws;
 46. ESS theta and the affine moves on 2 item shards: phase 38's sweep
     with theta by ESS and with the affine moves (phase 29's W = 16, 2
     rounds) against the unsharded one, theta equal in at least 62 of 64
     chains under the tie rule and the rest within 1e-3, the kernel against
     its plain version at a rank's state (timed, its bound); then phase
     27's call on the item shards at burn 10, 40 draws (cut from 20, 80): one launch a
     sweep on each rank, theta the same on both, the table's all_reduce;
 47. phase 19's tempering on a 2-rank chain mesh: its cold draws and swap
     rates hash to phase 19's, one launch a sweep a rank, the kernel at a
     rank's state (timed, its bound);
 48. phase 20's campaigns8 on a 2-rank campaign mesh: the same on both
     ranks and bit for bit phase 20's call in every field of the result
     (no lane's draws depend on its batch, phase 51), phase 22's agreement
     rule; whether the one-process reference at the ranks' batch agrees is
     printed;
 49. phase 19's tempering on the 2 x 2 items x respondents mesh: continued
     from phase 19's last lane states (phase 32's checkpoint) for 100
     draws, the cold chains' means at r >= 0.999 with phase 19's; theta,
     beta, the cutpoints, f* and the swaps alike on the model shards; no
     launch; then its call from scratch at burn 10, 40 draws (cut from 20,
     80), its r and
     swap rates printed, not gated, and its all_reduce sites;
 50. resume across shard counts: phase 5's configuration continued from
     its last state on 2 item shards (burn 20, 60 draws, a checkpoint
     every 20 sweeps; cut from burn 50, 150 draws, every 50), interrupted
     after sweep 40 (cut from 100) and resumed without a
     mesh (twice, in this process) and on 2 respondent shards
     (utils/checkpoint.py's stream rule): each resume begins with the
     file's draws bit for bit, the resume without a mesh is bit for bit
     the unsharded driver fed the file's state and generator, two resumes
     agree, the respondent resume is the same on both ranks, and each
     resume's posterior theta means reach r >= 0.999 with the
     uninterrupted 2-shard run's; the kernel launches on the item shards
     and without a mesh, not under the respondent axis;
 51. a sweep's lanes against its batch: one sweep of campaigns8's 512
     lanes and the same lanes in batches of 64, block by block (theta, z,
     f*, beta, the cutpoints, ll, SMC's reweight ll) and whole, plain, at
     T = 4, at a temperature a lane and with the kernel's cutpoint update;
     then each sweep family (FAMILY_CASES: the SDO ordinal sweep with ESS
     and Newton cutpoints, the dynamic GP theta sweep, the two-stage sweep
     with both f* | f methods, the shared-IRF grid and conjugate sweeps,
     ESS theta, interleave with two passes, the affine moves; plain and,
     where the sweep takes one, at a temperature a lane) at its phase's
     cell, one sweep of 128 chains against the same lanes in batches of 64,
     32 and 16, every block the sweep runs and the whole sweep: every block
     bit for bit;
 52. each sweep family on a 2-rank chain mesh: the cell of each family of
     phase 51 through gpirt_mcmc (the affine moves through run_chains), 64
     chains, burn 10 and 40 draws, 32 chains a rank, against the same call
     in this process: the draws' sha256 equal on every rank, the kernel
     launched once a sweep a rank on the binary families (every fourth sweep
     under interleave) and the ordinal kernel once a sweep a rank on SDO's;
     the shared-IRF run also cut on the mesh after 20
     sweeps with a checkpoint and resumed here without a mesh: bit for bit
     the uninterrupted call.
Phases 38, 39, 41, 42-44, 46-48, 50 and 52 run as the stages of one world of 2
ranks (a rank's start costs seconds on the card's machine), phases 40, 45
and 49 in one of 4; the ranks start by the spawn method, each phase must end within 400
seconds, and a rank that fails ends the run.
Each phase prints its wall time, and a line before the last lines holds
them all with their sum. A kernel time is the mean over 50
back-to-back launches captured in one CUDA graph and timed by CUDA events
after a warm-up ("ms"), and over 50
eager calls, which adds the wrapper's host time where that is the longer
("ms_eager"). The last lines are the kernels as JSON, the card as
nvidia-smi reports it, and {"ok": true, "device": {...}}.
"""

import contextlib
import dataclasses
import hashlib
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

HERE = os.path.dirname(os.path.abspath(__file__))
CK_DIR = HERE  # where the phases' temporary directories go
sys.path.insert(0, HERE)

from gpirt_tpu_torch import api, campaign_schedule, campaigns, gpirt_campaigns, gpirt_mcmc  # noqa: E402
from gpirt_tpu_torch.api import (  # noqa: E402
    _recover_one,
    default_thresholds,
    full_fp32_matmuls,
    recover_fstar,
    recover_fstar_batch,
)
from gpirt_tpu_torch.models import affine, gibbs  # noqa: E402
from gpirt_tpu_torch.models.config import (  # noqa: E402
    GPIRTConfig,
    GPIRTConstants,
    make_constants,
)
from gpirt_tpu_torch.models.generate import (  # noqa: E402
    posterior_predictive,
    response_draws,
)
from gpirt_tpu_torch.models.sampler import (  # noqa: E402
    Carry,
    advance_chains,
    run_chains,
    sample_schedule,
)
from gpirt_tpu_torch.ops import threshold_ess  # noqa: E402
from gpirt_tpu_torch.ops.ess import ess_update  # noqa: E402
from gpirt_tpu_torch.ops.likelihood import (  # noqa: E402
    category_logprobs,
    cutpoint_bounds,
    delta_to_threshold,
    ordinal_ll_terms,
)
from gpirt_tpu_torch.parallel.chains import (  # noqa: E402
    Shards,
    lane_state_block,
    make_campaign_mesh,
    make_chain_mesh,
    shards_of,
)
from gpirt_tpu_torch.parallel.distributed import (  # noqa: E402
    backend_for,
    broadcast_constants,
    launch,
    rank_device,
)
from gpirt_tpu_torch.parallel.items import (  # noqa: E402
    draws_item_block,
    item_inputs,
    make_item_mesh,
)
from gpirt_tpu_torch.parallel.respondents import (  # noqa: E402
    draws_respondent_block,
    make_respondent_mesh,
    shard_inputs,
)
from gpirt_tpu_torch.parallel import smc  # noqa: E402
from gpirt_tpu_torch.parallel.smc import WARM_STEPS, lane_block  # noqa: E402
from gpirt_tpu_torch.parallel.tempering import (  # noqa: E402
    advance_tempered,
    tempered_start,
)
from gpirt_tpu_torch.utils.datasets import (  # noqa: E402
    load_sdo,
    senate116_response_matrix,
    simulate_2pl,
    simulate_dynamic,
)
from gpirt_tpu_torch.utils.checkpoint import (  # noqa: E402
    CheckpointManager,
    run_chains_checkpointed,
)
from gpirt_tpu_torch.utils.diagnostics import (  # noqa: E402
    align_theta_signs,
    effective_sample_size,
    effective_sample_size_device,
    split_rhat,
)
from gpirt_tpu_torch.utils.irf import posterior_irf  # noqa: E402
from gpirt_tpu_torch.utils.profiling import profile_sweep  # noqa: E402
from gpirt_tpu_torch.utils.response import (  # noqa: E402
    as_response_matrix,
    encode_categories,
    recode_cube,
)

K, SMC_STEPS, T_MAX, BURN, DRAWS, SEED = 64, 320, 64.0, 100, 500, 1
# phase 8's depth, cut from bench.py's burn 200 and 500 draws to fit the
# time limit (its checks read no posterior; burn 100, 250 draws before the
# last cut)
SDO_BURN, SDO_DRAWS = 50, 150
# bench.py::bench_dynamic's data, regime and run lengths
DYN_N, DYN_M, DYN_H, DYN_LS, DYN_BURN, DYN_DRAWS = 150, 60, 10, 2.0, 100, 300
DYN_VOTES = {"yea": 1, "nay": 0, "missing": None}
# phase 24's shared-IRF run on those data, cut from phase 10's burn 100 and
# 300 draws to fit the time limit (its truth correlation gate, |r| > 0.5,
# read 0.97 at 300 draws)
SH_BURN, SH_DRAWS = 100, 150
TS_BURN, TS_DRAWS = 100, 200  # the two-stage path on senate116
# bench.py::bench_fstar10k and bench_synthetic (64 chains, not bench's 4:
# those were a 16 GB TPU's limit)
F10K_N, F10K_M, F10K_GRID = 100, 50, 10001
SYN_N, SYN_M, SYN_MISSING, SYN_K, SYN_BURN, SYN_DRAWS = 5000, 1000, 0.1, 64, 30, 150
# phase 30's random lanes past the tile path's capacity: 64 chains, senate116's
# unaligned width
PAST_M = 418
# the tempering path (gpirt_mcmc's n_temps), bench.py::bench_chains64 and
# bench_campaigns8 on senate116
PT_TEMPS, PT_MAX_TEMP, PT_BURN, PT_DRAWS = 4, 4.0, 100, 500
C64_BURN, C64_DRAWS = 100, 300
# phase 29's affine on / off runs' draws each (at phase 5's burn), cut from
# 500 to fit the time limit (its checks read no posterior)
AF_DRAWS = 250
# phase 27's ESS theta run's draws (at phase 5's burn), cut from 500 to fit
# the time limit (its checks read no posterior)
TE_DRAWS = 250
CAMPAIGNS, CAMPAIGN_WARM_SEED, CAMPAIGN_SEED = 8, 990001, 100000
CAMPAIGN_FIXTURE = os.path.join(HERE, "tests", "fixtures", "campaigns8_senate116_jax.npz")
# phases 31-32: a checkpoint every CK_EVERY sweeps, phase 5's call interrupted
# by the same call at CK_CUT draws; phase 34's profile_sweep reps; phase 35's
# short run with f and f* stored (4 draws of 64 chains: f* 428 MB on the host)
CK_EVERY, CK_CUT, PROFILE_REPS = 100, 200, 10
UT_BURN, UT_DRAWS, UT_THIN = 20, 8, 2
# phases 36-37: the port's examples at their defaults (the walkthrough's
# burn + draws sweeps at 4 chains; the SDO example one chain), held to
# |r| >= EXAMPLE_MIN_R (scripts/cross_parity.py's bar) against a JAX run of
# the same calls (scripts/jax_examples_fixture.py)
WALK_SWEEPS, SDO_EX_SWEEPS, EXAMPLE_MIN_R = 500 + 2000, 300 + 1000, 0.95
# the examples' draws, cut to fit the time limit (from their defaults,
# 2000 and 1000 draws; their burn-in stays, so a run's first sweeps are the
# default call's): the sweeps the phases run, against the JAX runs of the
# default calls
WALK_ARGV, SDO_EX_ARGV = ("--iters", "500"), ("--iters", "300")
WALK_RUN, SDO_EX_RUN = 500 + 500, 300 + 300
EXAMPLES_FIXTURE = os.path.join(HERE, "tests", "fixtures", "examples_jax.npz")
# per-chain temperatures of the tempered sweep check's 3 chains
SWEEP_TEMPS = (1.0, 4.0, 16.0)
# The posterior Cholesky of f* in float32 needs a nugget above the rounding
# of K** - V^T V (~n eps32 max K** ~ 8e-3 at the sweep check's n = 12,
# N = 101); at 1e-5 it is NaN on every device, in JAX too.
CHOL_JITTER = 5e-2
REPS = 50
_C = 0.7071067811865476
_TWO_PI = 6.283185307179586
# Peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM bytes
# and FP32 operations outside the tensor cores per second, and results per
# clock of one SM's special-function pipes.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SFU_PER_CLOCK_PER_SM = 16
# One site evaluation, log(0.5 * (1 + erf(sgn * c * (t - g))) + 1e-6) and
# its accumulate: 2 operations for the argument, 3 around erf, ~8 in erff's
# polynomial, ~6 in logf's, 1 to accumulate. Of them, one is a
# special-function result: the build's SASS has one MUFU.EX2 per site (in
# erff) and none in logf, which is a polynomial.
OPS_PER_SITE = 20
SFU_PER_SITE = 1
# The ordinal kernel's site calls erff twice (its category's two CDFs) and
# logf once: OPS_PER_SITE is a floor there, and its special-function
# results are counted as two of the binary site's.
ORDINAL_SFU_PER_SITE = 2 * SFU_PER_SITE


def log(msg):
    print(msg, flush=True)


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi(query):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def card():
    return nvidia_smi("name,power.limit")


def loop_ms(fn, reps=REPS, warmup=3):
    """Mean time of one call over ``reps`` eager back-to-back calls, by
    CUDA events around the loop, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps=REPS):
    """Device time of one call: ``reps`` calls captured in one CUDA graph,
    replayed once to warm up, then timed by CUDA events over one replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def random_lanes(y_dev):
    """Lane inputs at the main path's shape on senate116's responses, with
    random g, cutpoints and uniforms from a seed."""
    H, n, m = y_dev.shape
    dev = y_dev.device
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*s):
        return torch.rand(s, generator=gen, device=dev)

    def randn(*s):
        return torch.randn(s, generator=gen, device=dev)

    return (1.5 * randn(K, H, n, m), y_dev, randn(K, H, m), randn(K, H, m),
            torch.log(rand(K, H, m)), rand(K, H, m) * _TWO_PI, rand(64, K, H, m))


def random_ordinal_lanes(y_dev, K=8 * K, C=5, R=64):
    """The ordinal kernel's lane inputs for K chains on the SDO path's
    responses ``y_dev`` (H, n, m), with random g, deltas (cutpoints about
    0.6 apart) and uniforms from a seed."""
    H, n, m = y_dev.shape
    dev = y_dev.device
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*s):
        return torch.rand(s, generator=gen, device=dev)

    def randn(*s):
        return torch.randn(s, generator=gen, device=dev)

    d = torch.cat([randn(K, H, m, 1), -0.5 + 0.3 * randn(K, H, m, C - 2)], dim=-1)
    return (1.5 * randn(K, H, n, m), y_dev, d, randn(K, H, m, C - 1),
            torch.log(rand(K, H, m)), rand(K, H, m) * _TWO_PI, rand(R, K, H, m))


def is_ordinal(args):
    """Whether ``args`` are the ordinal kernel's: a lane state of C - 1
    deltas (K, H, m, C-1) where the binary kernel's is t_1 (K, H, m)."""
    return args[2].ndim == 4


def kernel_pair(args):
    """(wrapper, plain version) of the kernel that takes ``args``."""
    if is_ordinal(args):
        return (threshold_ess.ordinal_threshold_ess,
                threshold_ess.ordinal_threshold_ess_reference)
    return threshold_ess.binary_threshold_ess, threshold_ess.binary_threshold_ess_reference


def c_of(temp):
    """The kernel's scale 1/sqrt(2 T): a float, or a (K,) tensor of one a
    chain for a (K,) tensor of temperatures."""
    return _C / (torch.sqrt(temp) if torch.is_tensor(temp) else np.sqrt(temp))


def temp_label(temp):
    if torch.is_tensor(temp):
        return f"per chain {float(temp.min()):g} to {float(temp.max()):g}"
    return f"{temp:g}"


def kernel_check(args, label, temps=(1.0, T_MAX), c=None):
    """The kernel (binary or ordinal, :func:`kernel_pair`) against its plain
    version on ``args``: at most 0.1% of lanes over 1e-5 (a near-tie accept
    may flip, the site sum being taken in another order; a lane's error is
    its largest over its C - 1 deltas), finite, and most lanes moved; at
    each of ``temps`` (a temperature may be a (K,) tensor of one a chain),
    or at the scale ``c`` alone when it is given. Returns the largest error
    of the other lanes and the count of lanes over 1e-5."""
    L = args[4].numel()
    kernel, plain = kernel_pair(args)
    worst, flipped = 0.0, 0
    scales = ([(temp_label(t), c_of(t)) for t in temps] if c is None
              else [(f"{temp_label((_C / c) ** 2)} (c as given)", c)])
    for tl, c in scales:
        got = kernel(*args, c)
        torch.cuda.synchronize()
        want = plain(*args, c)
        torch.cuda.synchronize()
        err = (got - want).abs().reshape(L, -1).amax(dim=-1)
        over = int((err > 1e-5).sum())
        check(bool(torch.isfinite(got).all()), f"{label}: kernel output not finite")
        check(over <= 0.001 * L, f"{label} T={tl}: {over} of {L} lanes "
              "differ by more than 1e-5")
        moved = (got != args[2]).reshape(L, -1).any(dim=-1)
        check(float(moved.float().mean()) > 0.8, f"{label}: lanes did not move")
        rest = float(err[err <= 1e-5].max())
        worst, flipped = max(worst, rest), flipped + over
        log(f"kernel check, {label}, T={tl}: lanes={L} over_1e-5={over} "
            f"max_abs_err(rest)={rest:.3g}")
    return worst, flipped


def kernel_times(args, c, plain_reps=10):
    """(graph ms, eager ms, plain ms) of one update of ``args``."""
    kernel, plain_version = kernel_pair(args)
    ms = graph_ms(lambda: kernel(*args, c))
    eager = loop_ms(lambda: kernel(*args, c))
    plain = loop_ms(lambda: plain_version(*args, c), reps=plain_reps)
    return ms, eager, plain


def lane_rounds(g, y, t1, nu, logu, eps0, rs, c):
    """Each lane's proposals up to its accept, R for a lane at the cap, and
    the mask of lanes at the cap: a copy of the plain version's loop
    (gpirt_tpu_torch/ops/threshold_ess.py) that counts, of the binary
    kernel's lanes or, for a (K, H, m, C-1) ``t1`` of deltas, the ordinal
    kernel's; ``c`` a float or a (K,) tensor."""
    if torch.is_tensor(c):
        c = c.reshape(-1, 1, 1, 1)
    if t1.ndim == 4:
        C = t1.shape[-1] + 1
        onehot = (y.unsqueeze(-1) == torch.arange(1, C + 1, device=y.device)).to(g.dtype)

        def ll(d):
            logp = category_logprobs(g, delta_to_threshold(d).unsqueeze(-3), C, c)
            return (logp * onehot).sum(dim=(-3, -1))
    else:
        obs = (y > 0).to(g.dtype)
        sgn = torch.where(y == 1, 1.0, -1.0).to(g.dtype) * obs

        def ll(t):
            x = sgn * (t.unsqueeze(-2) - g) * c
            return torch.sum(torch.log(0.5 * (1.0 + torch.erf(x)) + 1e-6) * obs, dim=-2)

    R = rs.shape[0]
    log_y = ll(t1) + logu
    eps = eps0
    eps_min = eps - _TWO_PI
    eps_max = torch.full_like(eps, _TWO_PI)
    rounds = torch.full(logu.shape, R, dtype=torch.int64, device=t1.device)
    active = torch.ones_like(logu, dtype=torch.bool)
    lane = (...,) + (None,) * (t1.ndim - logu.ndim)  # an angle over a lane's deltas
    for r in range(R):
        if not bool(active.any()):
            break
        prop = t1 * torch.cos(eps)[lane] + nu * torch.sin(eps)[lane]
        accept = ll(prop) > log_y
        rounds = torch.where(active & accept, r + 1, rounds)
        still = active & ~accept
        eps_min = torch.where(still & (eps < 0), eps, eps_min)
        eps_max = torch.where(still & (eps >= 0), eps, eps_max)
        eps = torch.where(still, eps_min + rs[r] * (eps_max - eps_min), eps)
        active = still
    return rounds, active


def kernel_bound(args, c, label="main path's state"):
    """The work this launch needs and the least time the card could take
    for it: each input read once (of rs, the values a shrink uses; c a
    (K,) vector), the output written once, and every observed site
    evaluated once per ll; of the binary kernel or, on its lanes
    (:func:`is_ordinal`), the ordinal one (benchmark/counts/ordinal_kernel.py
    counts alike)."""
    g, y, t1, logu = args[0], args[1], args[2], args[4]
    rounds, capped = lane_rounds(*args, c)
    n_obs = (y > 0).sum(dim=1)  # (H, m), shared by the chains
    site_evals = int(((1 + rounds) * n_obs).sum())
    shrinks = int(torch.where(capped, rounds, rounds - 1).sum())
    L = logu.numel()
    D = t1.shape[-1] if is_ordinal(args) else 1  # floats of a lane's state
    # g, y; a lane's state, prior draw and output (D each), logu and eps0;
    # the shrinks; c
    nbytes = 4 * (g.numel() + y.numel() + (3 * D + 2) * L + shrinks + g.shape[0])
    ops = OPS_PER_SITE * site_evals
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = ops / FP32_OPS_PER_S * 1e3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    sfu = ORDINAL_SFU_PER_SITE if is_ordinal(args) else SFU_PER_SITE
    sfu_ms = sfu * site_evals / (SFU_PER_CLOCK_PER_SM * sms * clock_hz) * 1e3
    rf = rounds.double()
    work = {
        "rounds_mean": float(rf.mean()),
        "rounds_p99": float(torch.quantile(rf.flatten(), 0.99)),
        "rounds_max": int(rounds.max()),
        "lanes_at_cap": int(capped.sum()),
        "site_evals": site_evals,
        "ops": ops,
        "bytes": nbytes,
        "bound_ms": max(mem_ms, op_ms),
        "bound_by": "bytes" if mem_ms >= op_ms else "operations",
        "sfu_bound_ms": sfu_ms,
    }
    log(f"kernel work at the {label}: rounds per lane mean "
        f"{work['rounds_mean']:.3f} p99 {work['rounds_p99']:.0f} max "
        f"{work['rounds_max']} ({work['lanes_at_cap']} at the cap); "
        f"{site_evals} site evaluations, {ops} FP32 operations, {nbytes} bytes; "
        f"bound {work['bound_ms']:.5f} ms by {work['bound_by']} "
        f"(bytes {mem_ms:.5f} ms, operations {op_ms:.5f} ms, special-function "
        f"pipes {sfu_ms:.5f} ms at {sms} SMs x {clock_hz / 1e6:.0f} MHz)")
    return work


def sweep_on(d, state0, draws, y, consts, cfg, temp, z_given=None):
    """One sweep on device ``d``. Its z draw's inputs and result are kept;
    ``z_given``, when given, is used in the draw's place."""
    seen = {}
    draw_z = gibbs.draw_z_truncnorm

    def observe(g, yy, thr, u, t=None):
        z = draw_z(g, yy, thr, u, t) if z_given is None else z_given.to(d)
        seen.update(g=g, thr=thr, u=u, z=z)
        return z

    if torch.is_tensor(temp):
        temp = temp.to(device=d, dtype=cfg.tdtype)
    gibbs.draw_z_truncnorm = observe
    try:
        state, _ = gibbs.gibbs_sweep(
            gibbs.GPIRTState(*(a.to(d) for a in state0)), draws.to(d),
            torch.as_tensor(y, device=d), consts[d], cfg, temp=temp)
    finally:
        gibbs.draw_z_truncnorm = draw_z
    return state, seen


def max_diff(a, b):
    """Largest |a - b| over finite entries and its index."""
    err = torch.nan_to_num(a.cpu().double() - b.cpu().double()).abs()
    i = tuple(int(v) for v in np.unravel_index(int(err.argmax()), err.shape))
    return float(err[i]), i


def model_responses(state, consts, C, rng):
    """(H, n, m) categories 1..C drawn from the model at chain 0 of
    ``state`` (untempered), the first respondent's first 3 items missing."""
    theta = consts.grid[state.theta_idx[0]]
    g = (state.f[0] + gibbs.compute_mu(theta, state.beta[0])).double().numpy()
    z = g + rng.standard_normal(g.shape)
    thr = state.thresholds[0].double().numpy()  # (H, m, C+1)
    y = ((z[..., None] > thr[:, None, :, 1:C]).sum(-1) + 1).astype(np.int32)
    y[:, 0, :3] = 0
    return y


def sweep_inputs(C=2, method="auto", H=1, theta_ls=10.0, model_y=None,
                 f_method="auto", fstar_method="matheron", constant_IRF=False,
                 iteration=0, **options):
    """The sweep check's float32 configuration, priors, state (3 chains on
    the CPU), draws and responses, for the sampler ``f_method`` (f* by
    ``fstar_method`` under "two_stage", with the nugget CHOL_JITTER under
    "chol"), one IRF shared by the sessions with ``constant_IRF``, the
    further GPIRTConfig fields ``options``, and the draws of sweep
    ``iteration``. y is
    uniform over 1..C; with ``model_y`` (by default when
    H > 1) the chains share chain 0's state and y is drawn from the model
    there. Uniform y against prior-drawn
    states (|g| up to ~9) leaves cells whose interval holds under 1e-5 of
    z's mass, where float32 rounding of p moves f past 1e-3 (on the CPU as
    on the card, against float64: scripts/torch_sweep_precision.py), and 3 H
    sessions make such a cell likely."""
    Ks, n, m, N = 3, 12, 9, 101
    rng = np.random.default_rng(1)
    y = rng.integers(1, C + 1, (H, n, m)).astype(np.int32)
    y[:, 0, :3] = 0
    cfg = GPIRTConfig(n=n, m=m, horizon=H, C=C, grid_size=N, dtype="float32",
                      jitter=CHOL_JITTER if fstar_method == "chol" else 1e-5,
                      threshold_method=method, theta_ls=theta_ls, f_method=f_method,
                      fstar_method=fstar_method, constant_IRF=constant_IRF, **options)
    priors = (np.zeros((3, m)), np.full((3, m), 3.0), np.zeros((2, n)),
              np.zeros((2, n)))
    gen = torch.Generator().manual_seed(0)
    consts = make_constants(cfg, *priors, device="cpu")
    state0 = gibbs.init_state(
        torch.as_tensor(rng.uniform(-1, 1, (Ks, H, n))),
        torch.as_tensor(default_thresholds(C, m, H)),
        consts, cfg, gibbs.init_draws(gen, Ks, consts, cfg))
    if H > 1 if model_y is None else model_y:
        state0 = gibbs.GPIRTState(*(a[:1].expand(a.shape).contiguous() for a in state0))
        y = model_responses(state0, consts, C, rng)
    return cfg, priors, state0, gibbs.sweep_draws(gen, Ks, consts, cfg, iteration), y


def sweep_vs_float64(C=2, H=1, theta_ls=10.0, model_y=None, temp=4.0, **sampler):
    """The sweep check's float32 sweep and the same sweep with its state,
    draws and constants in float64, on the CPU: the yardstick for the
    card's differences. ``sampler`` takes f_method and fstar_method (then
    ``temp`` must be None). Returns ((state, z draw) in float32, the same
    in float64, y, the float32 config)."""
    cfg, priors, state0, draws, y = sweep_inputs(C, H=H, theta_ls=theta_ls,
                                                 model_y=model_y, **sampler)
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    cpu = torch.device("cpu")

    def f64(a):
        return a.double() if a.is_floating_point() else a

    out32 = sweep_on(cpu, state0, draws, y,
                     {cpu: make_constants(cfg, *priors, device=cpu)}, cfg, temp)
    out64 = sweep_on(cpu, gibbs.GPIRTState(*map(f64, state0)), draws.to(torch.float64),
                     y, {cpu: make_constants(cfg64, *priors, device=cpu)}, cfg64, temp)
    return out32, out64, y, cfg


def sweep_check(dev, C=2, method="auto", temp=4.0, H=1, theta_ls=10.0):
    """One tempered sweep on the card against the CPU, same state and draws
    (:func:`sweep_inputs`): theta equal, the rest within 1e-3. At C > 2 f*
    is held to 1e-3 given the CPU's z draw, and to 1e-3 + 1e-3 |f*| on its
    own draw; the cells that set both differences are printed. ``H``
    sessions and ``theta_ls`` pick the theta regime; ``temp`` is a float or
    a (3,) tensor of one temperature a chain, and then f* is held to
    1e-3 + 1e-3 |f*| at any C and the card's largest distance from the same
    sweep on the CPU in float64 is printed too."""
    cfg, priors, state0, draws, y = sweep_inputs(C, method, H, theta_ls)
    cpu = torch.device("cpu")
    consts = {d: make_constants(cfg, *priors, device=d) for d in (cpu, dev)}
    args = (state0, draws, y, consts, cfg, temp)
    s_cpu, z_cpu = sweep_on(cpu, *args)
    s_gpu, z_gpu = sweep_on(dev, *args)
    label = f"C={C}, cutpoints by {method}"
    if H > 1:
        label += f", H={H}, {cfg.theta_regime} regime"
    if torch.is_tensor(temp):
        cfg64 = dataclasses.replace(cfg, dtype="float64")
        s64, _ = sweep_on(cpu, gibbs.GPIRTState(*(a.double() if a.is_floating_point()
                                                   else a for a in state0)),
                          draws.to(torch.float64), y,
                          {cpu: make_constants(cfg64, *priors, device=cpu)}, cfg64, temp)
        log(f"tempered sweep (card, float32, T {temp_label(temp)}, {label}) against "
            "the CPU in float64: theta equal "
            f"{torch.equal(s64.theta_idx, s_gpu.theta_idx.cpu())}, max abs diff "
            + ", ".join(f"{k} {max_diff(getattr(s_gpu, k), getattr(s64, k))[0]:.3g}"
                        for k in ("f", "beta", "thresholds", "fstar")))
    check(torch.equal(s_cpu.theta_idx, s_gpu.theta_idx.cpu()), f"sweep theta differs ({label})")
    errs = {k: max_diff(getattr(s_gpu, k), getattr(s_cpu, k))[0]
            for k in ("f", "beta", "thresholds", "fstar")}
    line = ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
    if C > 2:
        fed, _ = sweep_on(dev, *args, z_given=z_cpu["z"])
        errs["fstar_given_cpu_z"], _ = max_diff(fed.fstar, s_cpu.fstar)
        dz, iz = max_diff(z_gpu["z"], z_cpu["z"])
        g, u = float(z_cpu["g"][iz]), float(z_cpu["u"][iz])
        lo, hi, _ = cutpoint_bounds(torch.as_tensor(y), z_cpu["thr"])
        sd = float(temp[iz[0]] if torch.is_tensor(temp) else temp) ** 0.5
        a, b = (float(lo[iz]) - g) / sd, (float(hi[iz]) - g) / sd
        cdf_a, cdf_b = 0.5 * math.erfc(-a / math.sqrt(2)), 0.5 * math.erfc(-b / math.sqrt(2))
        p = cdf_a + u * (cdf_b - cdf_a)
        _, i_f = max_diff(s_gpu.fstar, s_cpu.fstar)
        theta_f = float(consts[cpu].grid[i_f[2]])
        line += (f"; f* given the CPU's z {errs['fstar_given_cpu_z']:.3g}; z differs most, "
                 f"by {dz:.3g}, at cell {iz}: g {g:.4f}, z {float(z_cpu['z'][iz]):.4f} (CPU) "
                 f"{float(z_gpu['z'][iz]):.4f} (card), bounds {a:.4g} and {b:.4g} sd from g, "
                 f"interval mass {cdf_b - cdf_a:.3g}, p {p:.9g}; f* differs most at "
                 f"cell {i_f} (theta {theta_f:.2f}), |f*| {abs(float(s_cpu.fstar[i_f])):.4g}")
    log(f"sweep check (card vs CPU, float32, T={temp_label(temp)}, {label}): max abs "
        "diff " + line)
    # f* by PERF.md's 1e-3 + 1e-3 |f*| where a far-tail cell (C > 2) or an
    # untempered chain's grid edge (one temperature a chain: |f*| ~70 at
    # theta = -5, where float32 alone moves f* by ~1e-3 on the CPU) sets it
    relative_fstar = C > 2 or torch.is_tensor(temp)
    for k, v in errs.items():
        if k != "fstar" or not relative_fstar:
            check(v < 1e-3, f"sweep {k} differs by {v:.3g} ({label})")
    if relative_fstar:
        _, i_f = max_diff(s_gpu.fstar, s_cpu.fstar)
        log(f"sweep check f* ({label}): largest difference at |f*| "
            f"{abs(float(s_cpu.fstar[i_f])):.4g}, held to 1e-3 + 1e-3 |f*|")
        check(bool(torch.isclose(s_gpu.fstar.cpu(), s_cpu.fstar, rtol=1e-3, atol=1e-3).all()),
              f"sweep fstar differs beyond 1e-3 + 1e-3 |f*| ({label})")
    moved = (s_gpu.thresholds.cpu() != state0.thresholds)[..., 1:-1]
    check(float(moved.float().mean()) > 0.2, f"cutpoints did not move ({label})")


def theta_ess(theta, dev):
    """Median over parameters of the within-chain theta ESS summed over the
    chains, and of the pooled ESS: theta (K, S, P)."""
    th = torch.as_tensor(theta, device=dev)
    within = sum(effective_sample_size_device(th[c:c + 1]) for c in range(th.shape[0]))
    within_med = float(np.median(within.cpu().numpy()))
    pooled_med = float(np.median(effective_sample_size_device(th).cpu().numpy()))
    check(np.isfinite(within_med) and within_med > 0, "theta ESS not positive")
    return within_med, pooled_med


def observe_kernel(run, before_call=None, kernel=None, scales=None,
                   name="binary_threshold_ess"):
    """Runs ``run()`` with the sweep's call of the kernel wrapper ``name``
    (through gibbs, once a sweep) observed: ``before_call(i)``, when given,
    runs before the i-th call, ``kernel``, when given, is called in the
    wrapper's place, and each call's c is appended to the list ``scales``
    when one is given. Returns run's result and the inputs of the last
    call."""
    seen = {"calls": 0, "args": None}
    wrapper = getattr(gibbs, name)
    launch = wrapper if kernel is None else kernel

    def observe(*args):
        if before_call is not None:
            before_call(seen["calls"])
        if scales is not None:
            scales.append(args[7])
        seen["calls"] += 1
        seen["args"] = args[:7]
        return launch(*args)

    setattr(gibbs, name, observe)
    try:
        out = run()
    finally:
        setattr(gibbs, name, wrapper)
    return out, seen["args"]


def theta_means(out):
    """gpirt_mcmc's sign-aligned posterior theta means (session 0): each
    chain's mean aligned to chain 0's, then pooled."""
    means = np.stack([d["theta"][:, :, 0].mean(axis=0) for d in out])
    return align_theta_signs(means, reference=means[0]).mean(axis=0)


def draws_sha256(out):
    """sha256 of gpirt_mcmc's chain dicts' theta, beta, threshold and ll,
    chain by chain, and of swap_rate where there is one."""
    h = hashlib.sha256()
    for d in out:
        for k in ("theta", "beta", "threshold", "ll", "swap_rate"):
            if k in d:
                h.update(np.ascontiguousarray(d[k]).tobytes())
    return h.hexdigest()


def main_call(rm, dev, chains=K, burn=BURN, draws=DRAWS, smc_steps=SMC_STEPS, seed=SEED,
              **extra):
    """Phase 5's gpirt_mcmc call on ``rm``, ``draws`` its sample_iterations
    and ``extra`` more of its arguments."""
    return gpirt_mcmc(rm, draws, burn, CHAIN=chains, SEED=seed, smc_steps=smc_steps,
                      smc_max_temp=T_MAX, dtype="float32", device=dev, **extra)


def main_path(rm, dev, smi):
    """Returns the kernel's launches in the run, its inputs at the last
    sweep, the draws' sha256 and the sampling sweeps a second."""
    threshold_ess.binary_threshold_ess.launches = 0
    out, state_args = observe_kernel(lambda: main_call(rm, dev))
    launches = threshold_ess.binary_threshold_ess.launches
    sweeps = WARM_STEPS + SMC_STEPS - 1 + BURN + DRAWS
    check(launches == sweeps, f"{launches} kernel launches for {sweeps} sweeps")
    check(len(out) == K, "one result per chain")
    ll = np.stack([d["ll"] for d in out])
    thr = np.stack([d["threshold"] for d in out])  # (K, S, m, 3, 1)
    theta = np.stack([d["theta"][:, :, 0] for d in out])  # (K, S, n)
    check(ll.shape == (K, DRAWS) and np.isfinite(ll).all(), "ll not finite")
    check(np.isfinite(thr[..., 1, :]).all(), "cutpoints not finite")
    check(np.mean(thr[:, -1, :, 1, 0] != 0.0) > 0.99, "cutpoints did not move")
    check(np.isfinite(theta.mean(axis=1)).all(), "theta posterior means not finite")
    smc_s, samp_s = out[0]["seconds"]["smc"], out[0]["seconds"]["sampling"]
    th = torch.as_tensor(theta, device=dev)
    within = sum(effective_sample_size_device(th[c:c + 1]) for c in range(K))
    within_med = float(np.median(within.cpu().numpy()))
    pooled_med = float(np.median(effective_sample_size_device(th).cpu().numpy()))
    check(np.isfinite(within_med) and within_med > 0, "theta ESS not positive")
    rate = (BURN + DRAWS) / samp_s
    log(f"main path on {smi}: {launches} kernel launches = {sweeps} sweeps; "
        f"smc_sec={smc_s:.3f} ({(WARM_STEPS + SMC_STEPS - 1) / smc_s:.1f} sweeps/s) "
        f"sampling_sec={samp_s:.3f} ({rate:.1f} sweeps/s)")
    log(f"theta ESS on {smi}: median within-chain (summed over {K} chains) "
        f"{within_med:.1f}, pooled {pooled_med:.1f}; "
        f"ess/sec {within_med / (smc_s + samp_s):.2f} (smc + sampling wall)")
    digest = draws_sha256(out)
    cut = draws_sha256([{k: d[k][:CK_CUT] for k in ("theta", "beta", "threshold", "ll")}
                        for d in out])
    log(f"main path draws sha256 {digest} (its first {CK_CUT} draws' {cut})")
    return launches, state_args, digest, rate, theta_means(out), cut


def sdo_path(dev, smi):
    """gpirt_mcmc on the SDO survey, checked (on the card the ordinal
    kernel's one launch a sweep); prints its rates and counts. Returns the
    ordinal kernel's launches, its inputs at the last sweep and the
    rates."""
    launches = threshold_ess.binary_threshold_ess.launches
    ordinal = threshold_ess.ordinal_threshold_ess.launches
    ess_update.calls = ess_update.rounds = ess_update.syncs = 0
    data = load_sdo()
    out, state_args = observe_kernel(
        lambda: gpirt_mcmc(data, SDO_DRAWS, SDO_BURN, CHAIN=K, SEED=SEED, vote_codes=None,
                           store_fstar=True, dtype="float32", device=dev),
        name="ordinal_threshold_ess")
    sweeps = SDO_BURN + SDO_DRAWS
    check(threshold_ess.binary_threshold_ess.launches == launches,
          "the binary kernel was launched on the ordinal path")
    ordinal = threshold_ess.ordinal_threshold_ess.launches - ordinal
    check(ordinal == (sweeps if dev.type == "cuda" else 0),
          f"SDO: {ordinal} ordinal kernel launches in {sweeps} sweeps")
    check(len(out) == K, "one result per chain")
    n, m = data.shape
    C = 5
    ll = np.stack([d["ll"] for d in out])
    thr = np.stack([d["threshold"][..., 0] for d in out])  # (K, S, m, C+1)
    theta = np.stack([d["theta"][:, :, 0] for d in out])  # (K, S, n)
    check(ll.shape == (K, SDO_DRAWS) and np.isfinite(ll).all(), "SDO ll not finite")
    t = thr[..., 1:C]
    check(np.isfinite(t).all(), "SDO cutpoints not finite")
    check(bool((np.diff(t, axis=-1) > 0).all()), "SDO cutpoints not increasing")
    qn = default_thresholds(C, m, 1)[0, :, 1:C]
    check(np.mean(t[:, -1] != qn) > 0.99, "SDO cutpoints did not move off qnorm(i/5)")
    for d in out:
        fs = d["fstar"]
        check(fs.shape == (SDO_DRAWS, 1001, m, 1), f"fstar shape {fs.shape}")
        check(bool(np.isfinite(fs).all()), "fstar not finite")
    samp_s = out[0]["seconds"]["sampling"]
    th = torch.as_tensor(theta, device=dev)
    within = sum(effective_sample_size_device(th[c:c + 1]) for c in range(K))
    within_med = float(np.median(within.cpu().numpy()))
    pooled_med = float(np.median(effective_sample_size_device(th).cpu().numpy()))
    check(np.isfinite(within_med) and within_med > 0, "SDO theta ESS not positive")
    res = {
        "sweeps_per_s": sweeps / samp_s,
        "sampling_s": samp_s,
        "ess_within": within_med,
        "ess_pooled": pooled_med,
        "ess_per_s": within_med / samp_s,
        "syncs_per_sweep": ess_update.syncs / sweeps,
    }
    log(f"SDO path on {smi}: {n} x {m}, C={C}, {K} chains, {sweeps} sweeps in "
        f"{samp_s:.3f} s ({res['sweeps_per_s']:.2f} sweeps/s, f* stored); theta ESS "
        f"median within-chain (summed over {K} chains) {within_med:.1f}, pooled "
        f"{pooled_med:.1f}; ess/sec {res['ess_per_s']:.2f}; cutpoint ESS: {ordinal} "
        f"ordinal kernel launches, {ess_update.calls} host-looped updates, "
        f"{res['syncs_per_sweep']:.2f} host syncs a sweep; binary kernel launches 0")
    return ordinal, state_args, res


def spread_init(n):
    """bench.py's spread theta init: a permutation of linspace(-2, 2, n)."""
    return np.random.default_rng(0).permutation(np.linspace(-2, 2, n))


def dynamic_inputs():
    """bench.py::bench_dynamic's data and the spread theta init of its first
    chain: (truth (n, H), responses (n, m, H) in {0, 1, NaN}, init (n,))."""
    truth, raw = simulate_dynamic(0, n=DYN_N, m=DYN_M, horizon=DYN_H, missing=0.1)
    init = spread_init(DYN_N)
    return truth, raw, init


def dynamic_path(dev, smi):
    """gpirt_mcmc on the dynamic configuration, checked; prints its rates,
    theta ESS and truth correlation. Returns the kernel's launches in the
    run and its inputs at the last sweep."""
    truth, raw, init = dynamic_inputs()
    regimes = set()
    draw_theta = gibbs._draw_theta_grid

    def observe_regime(state, mu_star, y, consts, config, *rest):
        regimes.add(config.theta_regime)
        return draw_theta(state, mu_star, y, consts, config, *rest)

    gibbs._draw_theta_grid = observe_regime
    threshold_ess.binary_threshold_ess.launches = 0
    calls = []  # the sweep's calls of the wrapper, seen through observe_kernel
    try:
        out, state_args = observe_kernel(
            lambda: gpirt_mcmc(raw, DYN_DRAWS, DYN_BURN, CHAIN=K, SEED=SEED,
                               vote_codes=DYN_VOTES, theta_ls=DYN_LS, theta_init=init,
                               dtype="float32", device=dev),
            before_call=calls.append)
    finally:
        gibbs._draw_theta_grid = draw_theta
    launches = threshold_ess.binary_threshold_ess.launches
    sweeps = DYN_BURN + DYN_DRAWS
    check(regimes == {"GP"}, f"theta regimes drawn: {sorted(regimes)}")
    check(launches == len(calls) == sweeps,
          f"{launches} kernel launches ({len(calls)} calls) for {sweeps} sweeps")
    check(len(out) == K, "one result per chain")
    m = out[0]["beta"].shape[2]
    ll = np.stack([d["ll"] for d in out])
    thr = np.stack([d["threshold"] for d in out])  # (K, S, m, 3, H)
    theta = np.stack([d["theta"] for d in out])  # (K, S, n, H)
    check(theta.shape == (K, DYN_DRAWS, DYN_N, DYN_H), f"theta shape {theta.shape}")
    check(ll.shape == (K, DYN_DRAWS) and np.isfinite(ll).all(), "dynamic ll not finite")
    check(np.isfinite(thr[..., 1, :]).all(), "dynamic cutpoints not finite")
    check(np.mean(thr[:, -1, :, 1, :] != 0.0) > 0.99, "dynamic cutpoints did not move")
    varies = np.mean(np.ptp(theta, axis=-1) > 0)
    check(varies > 0.5, f"theta differs between sessions in {varies:.3f} of draws")
    samp_s = out[0]["seconds"]["sampling"]
    th = torch.as_tensor(theta.reshape(K, DYN_DRAWS, -1), device=dev)  # n H parameters
    within = sum(effective_sample_size_device(th[c:c + 1]) for c in range(K))
    within_med = float(np.median(within.cpu().numpy()))
    pooled_med = float(np.median(effective_sample_size_device(th).cpu().numpy()))
    check(np.isfinite(within_med) and within_med > 0, "dynamic theta ESS not positive")
    # sign-aligned posterior means against the truth, as bench_dynamic
    ch_means = theta.mean(axis=1).transpose(0, 2, 1)  # (K, H, n)
    tt = truth.T  # (H, n)
    sign = np.sign(np.sum(ch_means * tt[None], axis=(1, 2), keepdims=True))
    sign[sign == 0] = 1
    r = abs(np.corrcoef((ch_means * sign).mean(axis=0).ravel(), tt.ravel())[0, 1])
    check(np.isfinite(r) and r > 0.5, f"truth correlation {r}")
    rate = sweeps / samp_s
    log(f"dynamic path on {smi}: {DYN_N} x {m} (of {DYN_M}) x {DYN_H} sessions, GP "
        f"regime (theta_ls={DYN_LS:g}), {K} chains, {sweeps} sweeps in {samp_s:.3f} s "
        f"({rate:.2f} sweeps/s); {launches} kernel launches; theta ESS over "
        f"{DYN_N * DYN_H} parameters, median within-chain (summed over {K} chains) "
        f"{within_med:.1f}, pooled {pooled_med:.1f}; ess/sec {within_med / samp_s:.2f} "
        f"(sampling wall); truth correlation {r:.4f} (sign-aligned chain means)")
    return launches, state_args


def two_stage_sweep_on(d, state0, draws, y, consts, cfg):
    """One two-stage sweep on device ``d``: (state, ll, draw_f's output)."""
    seen = {}
    draw_f = gibbs.draw_f

    def observe(*args):
        seen["f"] = draw_f(*args)
        return seen["f"]

    gibbs.draw_f = observe
    try:
        state, ll = gibbs.gibbs_sweep(
            gibbs.GPIRTState(*(a.to(d) for a in state0)), draws.to(d),
            torch.as_tensor(y, device=d), consts, cfg)
    finally:
        gibbs.draw_f = draw_f
    return state, ll, seen["f"]


def rounding_spread(run, f, consts, reps=4, sds=False):
    """The CPU's own float32 spread of ``run(f, consts)``, a dict of
    tensors: the largest change of each, over ``reps`` tries, when f, the
    eigenbasis U_se and the grid Gram (and with ``sds`` the beta prior sds,
    the ICC kernel's of the constant_IRF f* | f) are each moved by about one
    float32 rounding (relative N(0, 1.2e-7) noise, symmetric in the Gram)
    and nothing else changes."""
    gen = torch.Generator().manual_seed(0)
    base = run(f, consts)
    spread = {k: torch.zeros_like(v) for k, v in base.items()}

    def ulp(a):
        return a * (1.0 + 1.2e-7 * torch.randn(a.shape, generator=gen, dtype=a.dtype))

    for _ in range(reps):
        gram = ulp(consts.grid_gram)
        moved = dict(U_se=ulp(consts.U_se), grid_gram=0.5 * (gram + gram.mT))
        if sds:
            moved["beta_prior_sds"] = ulp(consts.beta_prior_sds)
        out = run(ulp(f), dataclasses.replace(consts, **moved))
        for k in spread:
            spread[k] = torch.maximum(spread[k], (out[k] - base[k]).abs())
    return spread


def sweep_spread(state0, draws, y, consts, cfg, reps=4):
    """:func:`rounding_spread` of a two-stage sweep's f and f* on the CPU,
    from the state's f (the beta prior sds moved too under constant_IRF);
    the rounding must not move a theta draw."""
    def run(f, c):
        s, _, _ = two_stage_sweep_on(torch.device("cpu"), state0._replace(f=f), draws, y,
                                     c, cfg)
        return {"theta_idx": s.theta_idx, "f": s.f, "fstar": s.fstar}

    spread = rounding_spread(run, state0.f, consts, reps, sds=cfg.constant_IRF)
    check(not bool(spread.pop("theta_idx").any()), "rounding moved a theta draw")
    return spread


def held_to_spread(got, want, spread):
    """``got`` against ``want`` (the CPU's) under 1e-3 + 1e-3 |want| plus
    four times the CPU's own rounding spread of the lane, its largest over
    the lane's grid points or sites (axis -2; a few random tries estimate
    one point's spread too noisily): (the largest share of that tolerance
    used, the largest widening of the 1e-3 rule)."""
    rule = 1e-3 + 1e-3 * want.abs()
    tol = rule + 4.0 * spread.amax(dim=-2, keepdim=True)
    return (float(((got.cpu() - want).abs() / tol).max()), float((tol / rule).max()))


def two_stage_check(dev, C, fstar_method):
    """One untempered two-stage sweep on the card against the CPU from the
    same state and draws (:func:`sweep_inputs`, y drawn from the model at a
    state shared by the chains): theta equal; draw_f's f, beta and the
    cutpoints within 1e-3; every field finite; at C = 2 one kernel launch.
    f* and the f read from it are held to 1e-3 + 1e-3 |x| plus 4 times the
    lane's own rounding spread on the CPU (:func:`sweep_spread`,
    :func:`held_to_spread`): Matheron's smoother (U^T U + 1e-4 I)^{-1} over
    a site basis of rank below q + 3 = 35 amplifies float32 rounding by up
    to ~1e4, and f* carries it beyond the sites' span; the posterior
    Cholesky of "chol" does the same (PERF.md, section 6). The widening is
    printed."""
    cfg, priors, state0, draws, y = sweep_inputs(
        C, model_y=True, f_method="two_stage", fstar_method=fstar_method)
    cpu = torch.device("cpu")
    consts = {d: make_constants(cfg, *priors, device=d) for d in (cpu, dev)}
    launches = threshold_ess.binary_threshold_ess.launches
    s_cpu, ll_cpu, f_cpu = two_stage_sweep_on(cpu, state0, draws, y, consts[cpu], cfg)
    s_gpu, ll_gpu, f_gpu = two_stage_sweep_on(dev, state0, draws, y, consts[dev], cfg)
    label = f"C={C}, f* by {fstar_method}, jitter {cfg.jitter:g}"
    check(threshold_ess.binary_threshold_ess.launches == launches + (C == 2),
          f"two-stage sweep: kernel launches ({label})")
    for st in (s_cpu, s_gpu):
        for k in ("f", "beta", "fstar"):
            check(bool(torch.isfinite(getattr(st, k)).all()),
                  f"two-stage sweep {k} not finite ({label})")
        check(bool(torch.isfinite(st.thresholds[..., 1:-1]).all()),
              f"two-stage sweep cutpoints not finite ({label})")
    check(torch.equal(s_cpu.theta_idx, s_gpu.theta_idx.cpu()),
          f"two-stage sweep theta differs ({label})")
    errs = {"draw_f": max_diff(f_gpu, f_cpu)[0]}
    errs.update({k: max_diff(getattr(s_gpu, k), getattr(s_cpu, k))[0]
                 for k in ("beta", "thresholds", "f", "fstar")})
    errs["ll"] = max_diff(ll_gpu, ll_cpu)[0]
    spread = sweep_spread(state0, draws, y, consts[cpu], cfg)
    line = []
    for k in ("f", "fstar"):
        ratio, widen = held_to_spread(getattr(s_gpu, k), getattr(s_cpu, k), spread[k])
        check(ratio <= 1.0, f"two-stage sweep {k} beyond its tolerance ({label}): "
              f"{ratio:.3g} of it")
        line.append(f"{k} at {ratio:.3g} of 1e-3 + 1e-3 |{k}| + 4 spread (widened up to "
                    f"{widen:.3g}x)")
    log(f"two-stage sweep check (card vs CPU, float32, T=1, {label}): max abs diff "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + "; " + "; ".join(line))
    for k in ("draw_f", "beta", "thresholds"):
        check(errs[k] < 1e-3, f"two-stage sweep {k} differs by {errs[k]:.3g} ({label})")
    moved = (s_gpu.thresholds.cpu() != state0.thresholds)[..., 1:-1]
    check(float(moved.float().mean()) > 0.2, f"cutpoints did not move ({label})")


def two_stage_path(rm, dev, smi):
    """gpirt_mcmc on senate116 with the two-stage sampler, checked; prints
    its rates and counts. Returns chain 0's draws and the kernel's launches
    in the run."""
    # bench.py's spread senate116 init: from theta = 0 (the default init
    # under zero prior sds) every site is one grid point, U^T U has rank 1,
    # and float32 cannot factor Matheron's capacitance (JAX's f* is NaN there)
    init = spread_init(rm.shape[0])
    ess_update.calls = ess_update.rounds = ess_update.syncs = 0
    threshold_ess.binary_threshold_ess.launches = 0
    out = gpirt_mcmc(rm, TS_DRAWS, TS_BURN, CHAIN=K, SEED=SEED, f_method="two_stage",
                     store_f=True, theta_init=init, dtype="float32", device=dev)
    launches = threshold_ess.binary_threshold_ess.launches
    sweeps = TS_BURN + TS_DRAWS
    check(launches == sweeps, f"two-stage: {launches} kernel launches for {sweeps} sweeps")
    check(len(out) == K, "one result per chain")
    n, m = out[0]["f"].shape[1:3]
    ll = np.stack([d["ll"] for d in out])
    thr = np.stack([d["threshold"] for d in out])  # (K, S, m, 3, 1)
    check(ll.shape == (K, TS_DRAWS) and np.isfinite(ll).all(), "two-stage ll not finite")
    check(np.isfinite(thr[..., 1, :]).all(), "two-stage cutpoints not finite")
    check(np.mean(thr[:, -1, :, 1, 0] != 0.0) > 0.99, "two-stage cutpoints did not move")
    for d in out:
        check(d["f"].shape == (TS_DRAWS, n, m, 1) and bool(np.isfinite(d["f"]).all()),
              "two-stage f not finite")
    samp_s = out[0]["seconds"]["sampling"]
    within, pooled = theta_ess(np.stack([d["theta"][:, :, 0] for d in out]), dev)
    log(f"two-stage path on {smi}: senate116 {n} x {m}, {K} chains, {sweeps} sweeps "
        f"in {samp_s:.3f} s ({sweeps / samp_s:.2f} sweeps/s), f stored; {launches} "
        f"kernel launches; theta ESS median within-chain (summed over {K} chains) "
        f"{within:.1f}, pooled {pooled:.1f}; ess/sec {within / samp_s:.2f} (sampling "
        f"wall); ESS (f, beta, no cutpoint ESS at C=2) {ess_update.calls} updates, "
        f"{ess_update.rounds / ess_update.calls:.2f} rounds an update, "
        f"{ess_update.syncs / sweeps:.2f} host syncs a sweep")
    return out[0], launches


def recovery_check(chain, rm, dev, smi):
    """recover_fstar_batch over one chain's stored draws on the card (shape,
    finite, repeatable under one seed), and one draw's _recover_one on the
    card against the CPU given the same draws: draw_f's f within 1e-3, f*
    within 1e-3 + 1e-3 |f*| plus four times the lane's own rounding spread
    on the CPU (:func:`rounding_spread`, :func:`held_to_spread`; Matheron's
    f* in float32, as in :func:`two_stage_check`)."""
    S, n, m = chain["f"].shape[:3]
    t = time.perf_counter()
    batch = recover_fstar_batch(3, chain, rm, device=dev)
    wall = time.perf_counter() - t
    check(batch.shape == (S, 1001, m, 1), f"recover_fstar_batch shape {batch.shape}")
    check(bool(np.isfinite(batch).all()), "recovered f* not finite")
    check(np.array_equal(batch, recover_fstar_batch(3, chain, rm, device=dev)),
          "recover_fstar_batch differs under one seed")
    y, C, _ = encode_categories(np.asarray(rm))
    cfg = GPIRTConfig(n=n, m=m, C=C, dtype="float32", jitter=1e-5, mean_degree=1)
    priors = (np.zeros((3, m)), np.full((3, m), 3.0), np.zeros((2, n)), np.zeros((2, n)))
    cpu = torch.device("cpu")
    consts = {d: make_constants(cfg, *priors, device=d) for d in (cpu, dev)}
    gen = torch.Generator().manual_seed(4)
    rand = (gibbs.f_draws(gen, 1, consts[cpu], cfg), gibbs.fstar_draws(gen, 1, consts[cpu], cfg))
    stored = [np.ascontiguousarray(chain[k][-1:].transpose(0, 3, 1, 2))
              for k in ("f", "beta", "threshold")]
    stored.insert(1, np.ascontiguousarray(chain["theta"][-1:].transpose(0, 2, 1)))

    def one(d, f=None, c=None):
        """_recover_one on device d: {"fstar", "f": draw_f's output}."""
        args = [torch.as_tensor(a, dtype=torch.float32, device=d) for a in stored]
        seen = {}
        draw_f = api.draw_f

        def observe(*a):
            seen["f"] = draw_f(*a)
            return seen["f"]

        api.draw_f = observe
        try:
            fstar = _recover_one(args[0] if f is None else f, *args[1:],
                                 torch.as_tensor(y, device=d), consts[d] if c is None else c,
                                 cfg, *(gibbs.draws_to(r, d) for r in rand))
        finally:
            api.draw_f = draw_f
        return {"fstar": fstar, "f": seen["f"]}

    want, got = one(cpu), one(dev)
    check(bool(torch.isfinite(got["fstar"]).all()), "recovered f* on the card not finite")
    f_err = max_diff(got["f"], want["f"])[0]
    check(f_err < 1e-3, f"recovery's draw_f card vs CPU differs by {f_err:.3g}")
    spread = rounding_spread(lambda f, c: one(cpu, f, c), torch.as_tensor(stored[0]),
                             consts[cpu])
    err, i = max_diff(got["fstar"], want["fstar"])
    ratio, widen = held_to_spread(got["fstar"], want["fstar"], spread["fstar"])
    check(ratio <= 1.0, f"recovered f* card vs CPU beyond 1e-3 + 1e-3 |f*| + 4 spread "
          f"({ratio:.3g} of it, max abs diff {err:.3g})")
    log(f"recovery on {smi}: recover_fstar_batch over {S} stored draws of one chain, "
        f"f* {batch.shape}, finite, equal under one seed, {wall:.3f} s wall; one draw's "
        f"_recover_one card vs CPU: draw_f max abs diff {f_err:.3g}, f* {err:.3g} at |f*| "
        f"{abs(float(want['fstar'][i])):.4g} (theta {float(consts[cpu].grid[i[2]]):.2f}), "
        f"{ratio:.3g} of 1e-3 + 1e-3 |f*| + 4 spread (widened up to {widen:.3g}x; the "
        f"CPU's own spread of f* up to {float(spread['fstar'].max()):.3g})")


def fstar10k(dev, smi):
    """bench.py::bench_fstar10k on the card: returns the kernel's launches in
    its two sampling sweeps."""
    _, raw = simulate_2pl(0, n=F10K_N, m=F10K_M)
    threshold_ess.binary_threshold_ess.launches = 0
    out = gpirt_mcmc(raw, 2, 0, vote_codes=DYN_VOTES, store_f=True, dtype="float32",
                     device=dev)
    launches = threshold_ess.binary_threshold_ess.launches
    check(launches == 2, f"fstar10k: {launches} kernel launches for 2 sweeps")
    d = out[0]
    rm = np.asarray(as_response_matrix(raw, DYN_VOTES, verbose=False))
    args = (d["f"][-1], rm, d["theta"][-1], d["beta"][-1], d["threshold"][-1])
    t = time.perf_counter()
    first = recover_fstar(1, *args, grid_size=F10K_GRID, device=dev)
    first_wall = time.perf_counter() - t
    t = time.perf_counter()
    rec = recover_fstar(2, *args, grid_size=F10K_GRID, device=dev)
    wall = time.perf_counter() - t
    m = d["beta"].shape[2]
    for r in (first, rec):
        check(r["fstar"].shape == (F10K_GRID, m, 1), f"fstar10k shape {r['fstar'].shape}")
        check(bool(np.isfinite(r["fstar"]).all()), "fstar10k f* not finite")
    check(not np.array_equal(first["fstar"], rec["fstar"]), "seeds 1 and 2 gave one f*")
    log(f"fstar10k host constants at N={F10K_GRID}: {first['seconds']['constants']:.3f} s "
        f"(float64 Gram, Cholesky and eigendecomposition, then to the card)")
    log(f"fstar10k on {smi}: n={F10K_N}, m={m}, N={F10K_GRID}; first call {first_wall:.3f} s "
        f"(constants included), second call {wall:.5f} s wall ({rec['seconds']['recovery']:.5f} "
        f"s recovery, constants cached); f* {rec['fstar'].shape}, finite; {launches} "
        f"kernel launches in its 2 sampling sweeps")
    return launches


def synthetic_inputs(dev, n=SYN_N, m=SYN_M, K=SYN_K, build=True):
    """bench.py::bench_synthetic's data, configuration and inits on ``dev``:
    (y (1, n, m) int32, theta inits (K, 1, n), cutpoints (1, m, 3), constants
    (None without ``build``), config)."""
    _, raw = simulate_2pl(0, n=n, m=m, missing=SYN_MISSING)
    y, C, _ = encode_categories(raw)
    cfg = GPIRTConfig(n=n, m=m, horizon=1, C=C, dtype="float32")
    consts = make_constants(cfg, np.zeros((3, m)), np.full((3, m), 3.0),
                            np.zeros((2, n)), np.zeros((2, n)), device=dev) if build else None
    rng = np.random.default_rng(0)
    ti = np.stack([rng.permutation(np.linspace(-3, 3, n))[None] for _ in range(K)])

    def t32(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)

    return (torch.as_tensor(np.ascontiguousarray(y), dtype=torch.int32, device=dev),
            t32(ti), t32(default_thresholds(C, m, 1)), consts, cfg)


def synthetic_run(dev, inputs, burn=SYN_BURN, draws=SYN_DRAWS):
    """run_chains on the synthetic configuration (:func:`synthetic_inputs`),
    its kernel launches counted from 0: (draws, launches, sampling seconds,
    the kernel's inputs at the last sweep)."""
    y, ti, thr, consts, cfg = inputs
    gen = torch.Generator(device=dev).manual_seed(SEED)
    threshold_ess.binary_threshold_ess.launches = 0
    t = time.perf_counter()
    out, args = observe_kernel(lambda: run_chains(
        gen, y, ti, thr, consts, cfg, sample_iterations=draws, burn_iterations=burn))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return out, threshold_ess.binary_threshold_ess.launches, wall, args


def run_means(theta):
    """run_chains' sign-aligned posterior theta means of session 0 from its
    theta draws (K, S, H, n): each chain's mean aligned to chain 0's, then
    pooled."""
    means = theta[:, :, 0].mean(dim=1).cpu().double().numpy()
    return align_theta_signs(means, reference=means[0]).mean(axis=0)


def synthetic_path(dev, smi):
    """The synthetic configuration at full size, checked; prints its rates,
    theta ESS and peak memory. Returns the kernel's launches, its inputs at
    the last sweep, and the sweep rate, the peak device memory (GiB) and the
    sign-aligned posterior theta means."""
    torch.cuda.reset_peak_memory_stats()
    out, launches, wall, args = synthetic_run(dev, synthetic_inputs(dev))
    peak = torch.cuda.max_memory_allocated()
    sweeps = SYN_BURN + SYN_DRAWS
    check(launches == sweeps, f"synthetic: {launches} kernel launches for {sweeps} sweeps")
    ll, thr = out["ll"].cpu().numpy(), out["threshold"].cpu().numpy()  # (K, S, 1, m, 3)
    check(ll.shape == (SYN_K, SYN_DRAWS) and np.isfinite(ll).all(), "synthetic ll not finite")
    check(np.isfinite(thr[..., 1]).all(), "synthetic cutpoints not finite")
    check(np.mean(thr[:, -1, ..., 1] != 0.0) > 0.99, "synthetic cutpoints did not move")
    within, pooled = theta_ess(out["theta"][:, :, 0], dev)
    rate = sweeps / wall
    log(f"synthetic path on {smi}: {SYN_N} x {SYN_M} binary ({SYN_MISSING:g} missing), "
        f"conjugate, {SYN_K} chains, {sweeps} sweeps in {wall:.3f} s ({sweeps / wall:.3f} "
        f"sweeps/s); {launches} kernel launches; peak device memory "
        f"{peak / 2**30:.3f} GiB (torch.cuda.max_memory_allocated); theta ESS median "
        f"within-chain (summed over {SYN_K} chains) {within:.1f}, pooled {pooled:.1f}; "
        f"ess/sec {within / wall:.3f} within, {pooled / wall:.3f} pooled (sampling wall)")
    return launches, args, {"sweeps_per_s": rate, "peak_gib": peak / 2**30,
                            "means": run_means(out["theta"])}


def plan_label(plan):
    """One line of :func:`threshold_ess.launch_plan`'s answer."""
    return (f"{plan['path']} path, {plan['threads_a_lane']} threads a lane, "
            f"{plan['items_a_block']} items and {plan['threads_a_block']} threads a block, "
            f"{plan['smem_bytes']} bytes of shared memory a block (tile capacity n = "
            f"{plan['tile_capacity']})")


def past_capacity_lanes(dev, n, K=K, m=PAST_M, missing=SYN_MISSING):
    """Random lanes at n respondents (past the tile path's capacity on the
    card): g 1.5 N(0, 1), y yes / no at even odds with ``missing`` of the
    cells missing, item 0 with no response, cutpoints and uniforms from a
    seed."""
    gen = torch.Generator(device=dev).manual_seed(1)

    def rand(*s):
        return torch.rand(s, generator=gen, device=dev)

    u = rand(1, n, m)
    y = torch.where(u < missing, 0, torch.where(u < (1 + missing) / 2, 1, 2)).to(torch.int32)
    y[:, :, 0] = 0
    return (1.5 * torch.randn((K, 1, n, m), generator=gen, device=dev), y,
            torch.randn((K, 1, m), generator=gen, device=dev),
            torch.randn((K, 1, m), generator=gen, device=dev),
            torch.log(rand(K, 1, m)), rand(K, 1, m) * _TWO_PI, rand(64, K, 1, m))


def past_capacity(dev, smi):
    """Phase 30: the kernel's streaming path, at one row past the tile
    path's capacity, on random lanes against its plain version at T = 1 and
    64, timed. Returns (largest error of the other lanes, lanes over 1e-5,
    ms, plain ms, the bound's work, the plan)."""
    n = threshold_ess.launch_plan(SYN_N)["tile_capacity"] + 1
    plan = threshold_ess.launch_plan(n)
    check(plan["path"] == "streaming", f"n = {n} takes the {plan['path']} path")
    args = past_capacity_lanes(dev, n)
    worst, flipped = kernel_check(args, f"past the tile capacity (n={n})")
    ms, eager, plain = kernel_times(args, _C, plain_reps=3)
    work = kernel_bound(args, _C, f"past the tile capacity (n={n})")
    log(f"kernel time past the tile capacity on {smi}, {K} chains x {PAST_M} items x "
        f"n={n}, T=1: {plan_label(plan)}; {ms:.5f} ms (graph), {eager:.5f} ms (eager), "
        f"plain {plain:.4f} ms (3 calls); bound {work['bound_ms']:.5f} ms by "
        f"{work['bound_by']}, {100 * work['bound_ms'] / ms:.2f}% of it")
    return worst, flipped, ms, plain, work, plan


def ladder(K, t_max=T_MAX, dev=None):
    """(K,) float32 temperatures on a geometric ladder from 1 to ``t_max``."""
    return torch.as_tensor(t_max ** (np.arange(K) / (K - 1)), dtype=torch.float32,
                           device=dev)


def per_chain_c(rand_args):
    """Phase 17: the kernel on the random lanes with each chain at its own
    temperature (:func:`ladder`) against its plain version, and its graph
    time there against the same lanes with one scalar c (T = 1). Returns
    (largest error of the other lanes, lanes over 1e-5, per-chain ms,
    scalar ms)."""
    temps = ladder(rand_args[0].shape[0], dev=rand_args[0].device)
    worst, flipped = kernel_check(rand_args, "random lanes", temps=(temps,))
    c = c_of(temps)
    ms_chain = graph_ms(lambda: threshold_ess.binary_threshold_ess(*rand_args, c))
    ms_scalar = graph_ms(lambda: threshold_ess.binary_threshold_ess(*rand_args, _C))
    ms_chain_again = graph_ms(lambda: threshold_ess.binary_threshold_ess(*rand_args, c))
    log(f"kernel time, random lanes: one c a chain (T {temp_label(temps)}) "
        f"{ms_chain:.5f} / {ms_chain_again:.5f} ms (graph, before and after), one "
        f"scalar c (T=1) {ms_scalar:.5f} ms (graph)")
    return worst, flipped, ms_chain, ms_scalar


def cold_draws(out):
    """theta (K, S, n) of session 0 from gpirt_mcmc's chain dicts."""
    return np.stack([d["theta"][:, :, 0] for d in out])


def tempering_call(rm, dev, chains=K, burn=PT_BURN, draws=PT_DRAWS, **extra):
    """Phase 19's gpirt_mcmc call on ``rm``, ``draws`` its sample_iterations
    and ``extra`` more of its arguments."""
    return gpirt_mcmc(rm, draws, burn, CHAIN=chains, SEED=SEED, n_temps=PT_TEMPS,
                      max_temp=PT_MAX_TEMP, swap_every=1, dtype="float32", device=dev,
                      verbose=False, **extra)


def tempering_path(rm, dev, smi, chains=K, burn=PT_BURN, draws=PT_DRAWS):
    """Phase 19: gpirt_mcmc with n_temps on senate116, checked; prints its
    swap rates, cold theta ESS and sweep rate. Returns the kernel's
    launches, the inputs of its last call, that call's per-chain c, the
    draws' sha256 (swap_rate included) and the cold chains' sign-aligned
    posterior theta means."""
    scales = []
    threshold_ess.binary_threshold_ess.launches = 0
    out, args = observe_kernel(lambda: tempering_call(rm, dev, chains, burn, draws),
                               scales=scales)
    launches = threshold_ess.binary_threshold_ess.launches
    sweeps = burn + draws
    check(len(scales) == sweeps and launches == (sweeps if dev.type == "cuda" else 0),
          f"tempering: {launches} kernel launches ({len(scales)} calls) for {sweeps} sweeps")
    lanes = chains * PT_TEMPS
    distinct = {int(torch.unique(c).numel()) for c in scales}
    check(all(torch.is_tensor(c) and c.shape == (lanes,) for c in scales) and
          distinct == {PT_TEMPS}, f"tempering: distinct c values a launch {distinct}")
    check(len(out) == chains, "one result per chain")
    ll = np.stack([d["ll"] for d in out])
    theta = cold_draws(out)
    rate = out[0]["swap_rate"]
    check(ll.shape == (chains, draws) and np.isfinite(ll).all(), "tempering ll not finite")
    check(np.isfinite(theta).all(), "tempering theta not finite")
    check(rate.shape == (PT_TEMPS - 1,) and bool(((rate >= 0) & (rate <= 1)).all()),
          f"tempering swap rates {rate}")
    samp_s = out[0]["seconds"]["sampling"]
    within, pooled = theta_ess(theta, dev)
    log(f"tempering path on {smi}: senate116, {chains} chains x {PT_TEMPS} temperatures "
        f"(ladder to {PT_MAX_TEMP:g}) = {lanes} lanes, {sweeps} sweeps in {samp_s:.3f} s "
        f"({sweeps / samp_s:.2f} sweeps/s); {launches} kernel launches, each with "
        f"{PT_TEMPS} distinct c values; swap rate by rung "
        + ", ".join(f"{r:.4f}" for r in rate)
        + f"; cold theta ESS median within-chain (summed over {chains} chains) {within:.1f}, "
        f"pooled {pooled:.1f}; ess/sec {within / samp_s:.2f} (sampling wall)")
    return launches, args, scales[-1], draws_sha256(out), theta_means(out)


def campaigns8(rm, dev, smi, **schedule):
    """Phase 20: bench.py::bench_campaigns8 on one card, checked; prints its
    rates. ``schedule`` overrides campaign_schedule(2)'s fields. Returns the
    timed call's result and the kernel's launches in it."""
    kw = dict(n_campaigns=CAMPAIGNS, vote_codes=None, store_draws=False,
              verbose=False, device=dev, **schedule)
    data = np.asarray(rm)
    gpirt_campaigns(data, SEED=CAMPAIGN_WARM_SEED, **kw)
    threshold_ess.binary_threshold_ess.launches = 0
    out = gpirt_campaigns(data, SEED=CAMPAIGN_SEED, **kw)
    launches = threshold_ess.binary_threshold_ess.launches
    sched = out["schedule"]
    check(sched == dict(campaign_schedule(2), **schedule, n_campaigns=CAMPAIGNS),
          f"campaigns8 schedule {sched}")
    check(launches == 0, f"campaigns8: {launches} kernel launches under Newton cutpoints")
    n = data.shape[0]
    check(out["theta_mean"].shape == (n, 1) and np.isfinite(out["theta_mean"]).all(),
          "campaigns8 grand mean not finite")
    check(np.isfinite(out["theta_se"]).all() and (out["theta_se"] > 0).all(),
          "campaigns8 standard errors not positive")
    we = out["final_weight_ess"]
    check(we.shape == (CAMPAIGNS,) and np.isfinite(we).all(), "final weight ESS")
    w = out["walls"]["total_sec"]
    pooled = float(np.sum(out["pooled_ess_per_campaign"]))
    log(f"campaigns8 on {smi}: {CAMPAIGNS} campaigns x {sched['n_chains']} chains "
        f"({CAMPAIGNS * sched['n_chains']} lanes), SMC {sched['smc_steps']} steps from "
        f"T={sched['smc_max_temp']:g}, burn {sched['burn_iterations']}, "
        f"{sched['sample_iterations']} draws, cutpoints by {sched['threshold_method']}; "
        f"batch wall {w:.3f} s (smc {out['walls']['smc_sec']:.3f}, sampling "
        f"{out['walls']['sampling_sec']:.3f}); pooled ESS sum {pooled:.1f}, "
        f"{pooled / w:.2f} ESS/s; ess_campaign_median {out['ess_campaign_median']:.2f} "
        f"({out['ess_campaign_median'] / w:.3f}/s); theta_se median "
        f"{float(np.median(out['theta_se'])):.5f}; final weight ESS min/median "
        f"{we.min():.2f}/{np.median(we):.2f} of {sched['n_chains']}; {launches} kernel "
        "launches")
    return out, launches


def spread_run(rm, dev, chains, burn, draws, **options):
    """bench.py::bench_chains64's run: senate116 (``rm``) through run_chains
    with ``chains`` chains, each from its own permutation of linspace(-2, 2,
    n), the GPIRTConfig fields ``options`` set. Returns (theta (K, S, n)
    on the host, ll (K, S), the wall to the host copy, kernel launches)."""
    y, C, _ = encode_categories(np.asarray(rm))
    H, n, m = y.shape
    cfg = GPIRTConfig(n=n, m=m, horizon=H, C=C, dtype="float32", **options)
    consts = make_constants(cfg, np.zeros((3, m)), np.full((3, m), 3.0),
                            np.zeros((2, n)), np.zeros((2, n)), device=dev)
    rng = np.random.default_rng(0)
    ti = np.stack([rng.permutation(np.linspace(-2, 2, n))[None] for _ in range(chains)])

    def t32(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    threshold_ess.binary_threshold_ess.launches = 0
    t = time.perf_counter()
    d = run_chains(gen, torch.as_tensor(np.ascontiguousarray(y), dtype=torch.int32,
                                        device=dev),
                   t32(ti), t32(default_thresholds(C, m, H)), consts, cfg,
                   sample_iterations=draws, burn_iterations=burn)
    theta = d["theta"][:, :, 0].cpu().numpy()  # (K, S, n)
    wall = time.perf_counter() - t
    check(np.isfinite(theta).all() and bool(torch.isfinite(d["ll"]).all()),
          f"draws not finite ({options or 'chains64'})")
    return theta, d["ll"], wall, threshold_ess.binary_threshold_ess.launches


def chains64(rm, dev, smi, chains=K, burn=C64_BURN, draws=C64_DRAWS):
    """Phase 21: bench.py::bench_chains64 on one card, checked; prints split
    R-hat's maximum and the pooled ESS per second. Returns the kernel's
    launches and split R-hat's maximum."""
    theta, _, wall, launches = spread_run(rm, dev, chains, burn, draws)
    sweeps = burn + draws
    check(launches == (sweeps if dev.type == "cuda" else 0),
          f"chains64: {launches} kernel launches for {sweeps} sweeps")
    aligned = np.stack([align_theta_signs(c, reference=theta[0, 0]) for c in theta])
    ess = effective_sample_size(aligned)
    rhat_max = float(np.nanmax(split_rhat(aligned)))
    check(np.isfinite(rhat_max) and rhat_max >= 1.0, f"chains64 rhat_max {rhat_max}")
    log(f"chains64 on {smi}: senate116, {chains} chains, {sweeps} sweeps in {wall:.3f} s "
        f"({sweeps / wall:.2f} sweeps/s); {launches} kernel launches; rhat_max "
        f"{rhat_max:.4f}; pooled theta ESS median {float(np.median(ess)):.1f}, "
        f"{float(np.median(ess)) / wall:.3f} ESS/s (wall of the run)")
    return launches, rhat_max


def campaign_agreement(out, fixture=CAMPAIGN_FIXTURE):
    """Phase 22: the grand mean of a gpirt_campaigns run (``out``) against
    the JAX package's, sign-aligned to it: Pearson r >= 0.99 and at least
    95% of the respondents within |z| <= 4, z the difference over the root
    sum of both squared standard errors. Returns (r, worst |z|, count)."""
    with np.load(fixture) as f:
        jax_mean, jax_se = f["campaign_means"].mean(axis=0), f["theta_se"]
        sched = {k: f[k].item() for k in ("n_campaigns", "n_chains", "smc_steps",
                                          "burn_iterations", "sample_iterations")}
    port = align_theta_signs(out["theta_mean"][:, 0][None], reference=jax_mean)[0]
    z = (port - jax_mean) / np.sqrt(out["theta_se"][:, 0] ** 2 + jax_se ** 2)
    r = float(np.corrcoef(port, jax_mean)[0, 1])
    within = int(np.sum(np.abs(z) <= 4.0))
    n = jax_mean.size
    log(f"campaign agreement with the JAX package ({sched}): Pearson r {r:.5f}, "
        f"|z| <= 4 for {within} of {n}, worst |z| {float(np.abs(z).max()):.3f} "
        f"(respondent {int(np.abs(z).argmax())}), median |z| {float(np.median(np.abs(z))):.3f}")
    check(r >= 0.99, f"campaign grand means correlate at r = {r:.5f} < 0.99")
    check(within >= 0.95 * n, f"only {within} of {n} respondents within |z| <= 4")
    return r, float(np.abs(z).max()), within


def fed_fstar_sweep(d, state0, draws, y, consts, cfg, fstar=None):
    """One two-stage sweep on device ``d`` with its f* | f draw observed, or
    replaced by ``fstar`` when given: (state, ll, draw_f's f, the f*)."""
    seen = {}
    draw_fstar = gibbs.draw_fstar

    def observe(*args):
        seen["fstar"] = draw_fstar(*args) if fstar is None else fstar.to(d)
        return seen["fstar"]

    gibbs.draw_fstar = observe
    try:
        state, ll, f = two_stage_sweep_on(d, state0, draws, y, consts, cfg)
    finally:
        gibbs.draw_fstar = draw_fstar
    return state, ll, f, seen["fstar"]


def shared_irf_check(dev, f_method, constant_IRF=True, temp=None, C=2, H=3):
    """Phase 23: one sweep of ``f_method`` on the card against the CPU from
    the same state and draws (:func:`sweep_inputs` over H sessions in the
    GP regime, y drawn from the model at a state shared by the chains):
    theta equal, one kernel launch at C = 2, every field within 1e-3; f*
    within 1e-3 + 1e-3 |f*| under one temperature a chain (``temp`` a (3,)
    tensor). The two-stage constant_IRF f* interpolates f onto 100 inducing
    points whose float32 Gram is conditioned ~1e6, so the card's own f* can
    move a theta draw: the card's sweep is fed the CPU's f* (then draw_f's
    f and every field within 1e-3), and its own f* | f from the CPU's f is
    held to 1e-3 + 1e-3 |f*| plus four times the lane's own float32 spread
    on the CPU (f, U_se, the grid Gram and the beta prior sds of the
    inducing points' Gram moved by one rounding). Under constant_IRF the
    card's f* and cutpoints are one a chain."""
    cfg, priors, state0, draws, y = sweep_inputs(
        C, H=H, theta_ls=DYN_LS, model_y=True, f_method=f_method, constant_IRF=constant_IRF)
    cpu = torch.device("cpu")
    consts = {d: make_constants(cfg, *priors, device=d) for d in (cpu, dev)}
    label = (f"f_method={cfg.resolved_f_method}, constant_IRF={int(constant_IRF)}, C={C}, "
             f"H={H}, T={temp_label(temp) if temp is not None else 1}")
    launches = threshold_ess.binary_threshold_ess.launches
    exact = ["f", "beta", "thresholds", "fstar"]
    if f_method == "two_stage":
        s_cpu, ll_cpu, f_cpu, fs_cpu = fed_fstar_sweep(cpu, state0, draws, y, consts[cpu], cfg)
        s_gpu, ll_gpu, f_gpu, _ = fed_fstar_sweep(dev, state0, draws, y, consts[dev], cfg,
                                                  fstar=fs_cpu)

        def fstar_on(f, c, d=cpu):
            return {"fstar": gibbs.draw_fstar(f.to(d), state0.theta_idx.to(d), c, cfg,
                                              gibbs.draws_to(draws.fstar, d))}

        own = fstar_on(f_cpu, consts[dev], dev)["fstar"]
        spread = rounding_spread(fstar_on, f_cpu, consts[cpu], sds=True)["fstar"]
        ratio, widen = held_to_spread(own, fs_cpu, spread)
        extra = (f"; the card's own f* | f "
                 f"{max_diff(own, fs_cpu)[0]:.3g}, {ratio:.3g} of 1e-3 + 1e-3 |f*| + 4 spread "
                 f"(widened up to {widen:.3g}x)")
        exact.append("draw_f")
    else:
        def run(d):
            t = temp.to(device=d, dtype=cfg.tdtype) if torch.is_tensor(temp) else temp
            return gibbs.gibbs_sweep(gibbs.GPIRTState(*(a.to(d) for a in state0)),
                                     draws.to(d), torch.as_tensor(y, device=d), consts[d],
                                     cfg, temp=t)

        (s_cpu, ll_cpu), (s_gpu, ll_gpu) = run(cpu), run(dev)
        extra = ""
    check(threshold_ess.binary_threshold_ess.launches == launches + (C == 2),
          f"shared-IRF sweep check: kernel launches ({label})")
    check(torch.equal(s_cpu.theta_idx, s_gpu.theta_idx.cpu()), f"sweep theta differs ({label})")
    for k in ("f", "beta", "fstar"):
        check(bool(torch.isfinite(getattr(s_gpu, k)).all()), f"sweep {k} not finite ({label})")
    errs = {k: max_diff(getattr(s_gpu, k), getattr(s_cpu, k))[0]
            for k in ("f", "beta", "thresholds", "fstar")}
    errs["ll"] = max_diff(ll_gpu, ll_cpu)[0]
    if f_method == "two_stage":
        errs["draw_f"] = max_diff(f_gpu, f_cpu)[0]
    line = ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + extra
    log(f"shared-IRF sweep check (card vs CPU, float32, {label}): max abs diff {line}")
    if f_method == "two_stage":
        check(ratio <= 1.0, f"the card's f* | f beyond its tolerance ({label}): {ratio:.3g}")
    elif torch.is_tensor(temp):
        exact.remove("fstar")
        check(bool(torch.isclose(s_gpu.fstar.cpu(), s_cpu.fstar, rtol=1e-3, atol=1e-3).all()),
              f"sweep fstar differs beyond 1e-3 + 1e-3 |f*| ({label})")
    for k in exact:
        check(errs[k] < 1e-3, f"sweep {k} differs by {errs[k]:.3g} ({label})")
    if constant_IRF:
        check(torch.equal(s_gpu.fstar[:, 0], s_gpu.fstar[:, -1])
              and torch.equal(s_gpu.thresholds[:, 0], s_gpu.thresholds[:, -1]),
              f"f* or cutpoints differ between sessions ({label})")
    moved = (s_gpu.thresholds.cpu() != state0.thresholds)[..., 1:-1]
    check(float(moved.float().mean()) > 0.2, f"cutpoints did not move ({label})")


def shared_irf_path(dev, smi, burn=SH_BURN, draws=SH_DRAWS):
    """Phase 24: the dynamic data through gpirt_mcmc(constant_IRF=1), the
    grid sampler (f* by ESS a (chain, item) over N grid points, the pooled
    cutpoint kernel over H n sites), 64 chains, burn 100 and 300 draws;
    checked for one kernel launch and one f* ESS a sweep, the pooled
    layout at the kernel, finite ll, cutpoints that moved and one a chain
    across sessions, theta that differs between sessions and a truth
    correlation |r| > 0.5. Returns the kernel's launches, its inputs at the
    last sweep and the run's numbers."""
    truth, raw, init = dynamic_inputs()
    fstar_ess = {"calls": 0, "rounds": 0, "syncs": 0}
    direct = gibbs.draw_fstar_direct

    def observe_fstar(*args):
        rounds, syncs = ess_update.rounds, ess_update.syncs
        out = direct(*args)
        fstar_ess["calls"] += 1
        fstar_ess["rounds"] += ess_update.rounds - rounds
        fstar_ess["syncs"] += ess_update.syncs - syncs
        return out

    ess_update.calls = ess_update.rounds = ess_update.syncs = 0
    gibbs.draw_fstar_direct = observe_fstar
    torch.cuda.reset_peak_memory_stats()
    threshold_ess.binary_threshold_ess.launches = 0
    try:
        out, state_args = observe_kernel(
            lambda: gpirt_mcmc(raw, draws, burn, CHAIN=K, SEED=SEED,
                               vote_codes=DYN_VOTES, theta_ls=DYN_LS, theta_init=init,
                               constant_IRF=1, dtype="float32", device=dev))
    finally:
        gibbs.draw_fstar_direct = direct
    peak = torch.cuda.max_memory_allocated()
    launches = threshold_ess.binary_threshold_ess.launches
    sweeps = burn + draws
    check(launches == fstar_ess["calls"] == sweeps,
          f"shared IRF: {launches} kernel launches, {fstar_ess['calls']} f* ESS for "
          f"{sweeps} sweeps")
    m = out[0]["beta"].shape[2]
    g, y = state_args[0], state_args[1]
    check(tuple(g.shape) == (K, 1, DYN_N * DYN_H, m) and tuple(y.shape) == (1, DYN_N * DYN_H, m),
          f"the kernel's pooled layout: g {tuple(g.shape)}, y {tuple(y.shape)}")
    ll = np.stack([d["ll"] for d in out])
    thr = np.stack([d["threshold"] for d in out])  # (K, S, m, 3, H)
    theta = np.stack([d["theta"] for d in out])  # (K, S, n, H)
    check(ll.shape == (K, draws) and np.isfinite(ll).all(), "shared-IRF ll not finite")
    check(np.isfinite(thr[..., 1, :]).all(), "shared-IRF cutpoints not finite")
    check(bool((thr[..., 1, :] == thr[..., 1, :1]).all()), "cutpoints differ between sessions")
    check(np.mean(thr[:, -1, :, 1, 0] != 0.0) > 0.99, "shared-IRF cutpoints did not move")
    varies = np.mean(np.ptp(theta, axis=-1) > 0)
    check(varies > 0.5, f"theta differs between sessions in {varies:.3f} of draws")
    samp_s = out[0]["seconds"]["sampling"]
    within, pooled = theta_ess(theta.reshape(K, draws, -1), dev)
    ch_means = theta.mean(axis=1).transpose(0, 2, 1)  # (K, H, n)
    tt = truth.T
    sign = np.sign(np.sum(ch_means * tt[None], axis=(1, 2), keepdims=True))
    sign[sign == 0] = 1
    r = abs(np.corrcoef((ch_means * sign).mean(axis=0).ravel(), tt.ravel())[0, 1])
    check(np.isfinite(r) and r > 0.5, f"shared-IRF truth correlation {r}")
    res = {
        "sweeps_per_s": sweeps / samp_s,
        "sampling_s": samp_s,
        "ess_within": within,
        "ess_pooled": pooled,
        "truth_r": r,
        "fstar_ess_rounds_per_sweep": fstar_ess["rounds"] / sweeps,
        "fstar_ess_syncs_per_sweep": fstar_ess["syncs"] / sweeps,
        "ess_syncs_per_sweep": ess_update.syncs / sweeps,
        "peak_gib": peak / 2**30,
    }
    log(f"shared-IRF path on {smi}: {DYN_N} x {m} (of {DYN_M}) x {DYN_H} sessions, one IRF "
        f"(constant_IRF=1, f_method grid), GP regime (theta_ls={DYN_LS:g}), {K} chains, "
        f"{sweeps} sweeps in {samp_s:.3f} s ({res['sweeps_per_s']:.2f} sweeps/s); {launches} "
        f"kernel launches ({K * m} lanes of {DYN_N * DYN_H} sites); theta ESS over "
        f"{DYN_N * DYN_H} parameters, median within-chain (summed over {K} chains) "
        f"{within:.1f}, pooled {pooled:.1f}; ess/sec {within / samp_s:.2f} (sampling wall); "
        f"truth correlation {r:.4f}; f* ESS {res['fstar_ess_rounds_per_sweep']:.2f} rounds "
        f"and {res['fstar_ess_syncs_per_sweep']:.2f} host syncs a sweep (all ESS loops "
        f"{res['ess_syncs_per_sweep']:.2f}); peak device memory {res['peak_gib']:.3f} GiB "
        "(torch.cuda.max_memory_allocated)")
    return launches, state_args, res


def shared_irf_recovery(dev, smi):
    """Phase 25: recover_fstar(constant_IRF=1) on the card from one stored
    draw of a short shared-IRF run on the dynamic data (shape, finite, one
    f* for the sessions, the same twice under one seed), and that draw's
    _recover_one on the card against the CPU given the same draws: draw_f
    within 1e-3, f* within 1e-3 + 1e-3 |f*| plus four times the lane's own
    float32 spread on the CPU (the inducing points' Gram moved too)."""
    _, raw, init = dynamic_inputs()
    d = gpirt_mcmc(raw, 2, 1, vote_codes=DYN_VOTES, theta_ls=DYN_LS, theta_init=init,
                   constant_IRF=1, store_f=True, dtype="float32", device=dev,
                   verbose=False)[0]
    rm = recode_cube(raw, DYN_VOTES, verbose=False)
    args = (d["f"][-1], rm, d["theta"][-1], d["beta"][-1], d["threshold"][-1])
    t = time.perf_counter()
    rec = recover_fstar(3, *args, constant_IRF=1, device=dev)
    wall = time.perf_counter() - t
    fs = rec["fstar"]
    m = d["beta"].shape[2]
    check(fs.shape == (1001, m, DYN_H) and bool(np.isfinite(fs).all()),
          f"shared-IRF recovered f* {fs.shape}, finite {bool(np.isfinite(fs).all())}")
    check(bool((fs == fs[..., :1]).all()), "recovered f* differs between sessions")
    check(np.array_equal(fs, recover_fstar(3, *args, constant_IRF=1, device=dev)["fstar"]),
          "recover_fstar differs under one seed")
    y, C, _ = encode_categories(np.asarray(rm))
    cfg = GPIRTConfig(n=DYN_N, m=m, horizon=DYN_H, C=C, dtype="float32", jitter=1e-5,
                      mean_degree=1, constant_IRF=True)
    priors = (np.zeros((3, m)), np.full((3, m), 3.0), np.zeros((2, DYN_N)),
              np.zeros((2, DYN_N)))
    cpu = torch.device("cpu")
    consts = {dv: make_constants(cfg, *priors, device=dv) for dv in (cpu, dev)}
    gen = torch.Generator().manual_seed(4)
    rand = (gibbs.f_draws(gen, 1, consts[cpu], cfg), gibbs.fstar_draws(gen, 1, consts[cpu], cfg))
    stored = [np.ascontiguousarray(d[k][-1:].transpose(0, 3, 1, 2))
              for k in ("f", "beta", "threshold")]
    stored.insert(1, np.ascontiguousarray(d["theta"][-1:].transpose(0, 2, 1)))

    def one(dv, f=None, c=None):
        """_recover_one on device dv: {"fstar", "f": draw_f's output}."""
        a = [torch.as_tensor(v, dtype=torch.float32, device=dv) for v in stored]
        seen = {}
        draw_f = api.draw_f

        def observe(*x):
            seen["f"] = draw_f(*x)
            return seen["f"]

        api.draw_f = observe
        try:
            fstar = _recover_one(a[0] if f is None else f, *a[1:], torch.as_tensor(y, device=dv),
                                 consts[dv] if c is None else c, cfg,
                                 *(gibbs.draws_to(r, dv) for r in rand))
        finally:
            api.draw_f = draw_f
        return {"fstar": fstar, "f": seen["f"]}

    want, got = one(cpu), one(dev)
    f_err = max_diff(got["f"], want["f"])[0]
    spread = rounding_spread(lambda f, c: one(cpu, f, c), torch.as_tensor(stored[0]),
                             consts[cpu], sds=True)
    err, i = max_diff(got["fstar"], want["fstar"])
    ratio, widen = held_to_spread(got["fstar"], want["fstar"], spread["fstar"])
    log(f"shared-IRF recovery on {smi}: recover_fstar(constant_IRF=1) f* {fs.shape}, finite, "
        f"one for the {DYN_H} sessions, equal under one seed, {wall:.3f} s wall "
        f"({rec['seconds']['recovery']:.4f} s recovery); one draw's _recover_one card vs CPU: "
        f"draw_f max abs diff {f_err:.3g}, f* {err:.3g} at |f*| "
        f"{abs(float(want['fstar'][i])):.4g}, {ratio:.3g} of 1e-3 + 1e-3 |f*| + 4 spread "
        f"(widened up to {widen:.3g}x; the CPU's own spread of f* up to "
        f"{float(spread['fstar'].max()):.3g})")
    check(f_err < 1e-3, f"shared-IRF recovery's draw_f card vs CPU differs by {f_err:.3g}")
    check(ratio <= 1.0, f"shared-IRF recovered f* card vs CPU beyond its tolerance ({ratio:.3g})")


# Phase 26's checks: (label, sweep_inputs' arguments, temperature, iteration).
# theta by ESS in the three regimes over 3 sessions, the collapsed cutpoints
# at C = 2, 5 and pooled, interleave on its ESS (iteration 0) and collapsed
# (iteration 1) sweeps, the (t, beta0) shift, two latent passes, and the
# affine moves at JAX's Geweke setting untempered and on the (3,) ladder
OPTION_CHECKS = (
    ("ESS theta, CST", dict(H=3, theta_ls=10.0, theta_method="ess"), None, 0),
    ("ESS theta, RDM", dict(H=3, theta_ls=0.05, theta_method="ess"), None, 0),
    ("ESS theta, GP", dict(H=3, theta_ls=DYN_LS, theta_method="ess"), None, 0),
    ("collapsed, C=2", dict(method="collapsed"), None, 0),
    ("collapsed, C=5", dict(C=5, method="collapsed"), None, 0),
    ("collapsed, constant_IRF", dict(method="collapsed", H=3, theta_ls=DYN_LS,
                                     f_method="conjugate", constant_IRF=True), None, 0),
    ("interleave, ESS sweep", dict(method="interleave"), None, 0),
    ("interleave, collapsed sweep", dict(method="interleave"), None, 1),
    ("threshold_shift", dict(threshold_shift=True), None, 0),
    ("mix_subsweeps=2", dict(mix_subsweeps=2), None, 0),
    ("affine, T=1", dict(affine_shift_max=5, affine_rounds=2), None, 0),
    ("affine, per-chain T", dict(affine_shift_max=5, affine_rounds=2), SWEEP_TEMPS, 0),
)


def option_sweep(d, state0, draws, y, consts, cfg, temp, iteration):
    """One sweep on device ``d`` at ``iteration``: (state, ll, the argument
    of the sweep's last theta snap (the ESS theta update's final one))."""
    seen = {}
    snap = gibbs.snap_indices

    def observe(theta, config):
        seen["theta"] = theta
        return snap(theta, config)

    if temp is not None:
        temp = torch.as_tensor(temp, device=d, dtype=cfg.tdtype)
    gibbs.snap_indices = observe
    try:
        state, ll = gibbs.gibbs_sweep(
            gibbs.GPIRTState(*(a.to(d) for a in state0)), draws.to(d),
            torch.as_tensor(y, device=d), consts, cfg, temp, iteration)
    finally:
        gibbs.snap_indices = snap
    return state, ll, seen.get("theta")


def snap_margin(theta, cfg):
    """Each snapped value's distance, in grid steps, from the rounding
    boundary between two grid points."""
    v = (theta.double() - gibbs.THETA_LO) / cfg.grid_step
    return (v - torch.floor(v) - 0.5).abs()


def tie_rule(label, cfg, s_gpu, s_cpu, snap_cpu, run64, perturbed, float64_decides=False):
    """PERF.md section 2's rule for a theta decision that differs between
    the card and the CPU: the chains whose theta differs are found, the
    float64 run's snap margin of the differing sites is printed (under the
    ESS theta update), and a chain is let through only when the CPU's own
    float32 run, its inputs moved by one rounding (``perturbed``, a list of
    (theta_idx, snap argument)), moves that decision: its theta changes, or
    the snapped value moves by more than the margin. With
    ``float64_decides`` (two float32 forms of one computation, the card's
    the one under test) a chain is also let through when the float64 run
    draws the card's theta: the other form erred. Returns the chains whose
    other fields are compared."""
    differ = (s_gpu.theta_idx.cpu() != s_cpu.theta_idx).flatten(1).any(dim=1)
    if not bool(differ.any()):
        return torch.ones_like(differ)
    s64, snap64 = run64()
    for k in torch.nonzero(differ).flatten().tolist():
        sites = s_gpu.theta_idx[k].cpu() != s_cpu.theta_idx[k]
        flipped = any(bool((t[k] != s_cpu.theta_idx[k]).any()) for t, _ in perturbed)
        line = (f"tie rule ({label}): chain {k} theta differs at {int(sites.sum())} sites; "
                f"float64 agrees with the CPU {torch.equal(s64.theta_idx[k], s_cpu.theta_idx[k])}, "
                f"with the card {torch.equal(s64.theta_idx[k], s_gpu.theta_idx[k].cpu())}; "
                f"the CPU's perturbed float32 runs change it: {flipped}")
        if snap64 is not None and cfg.theta_method == "ess":
            idx = sites if snap64.shape[1:] == sites.shape else sites[0]
            margin = snap_margin(snap64[k], cfg)[idx]
            move = max(float(((p[k].double() - snap_cpu[k].double()) / cfg.grid_step).abs()[idx]
                             .max()) for _, p in perturbed)
            line += (f"; float64 snap margin {float(margin.min()):.3g} steps, the perturbed "
                     f"runs move the snapped value by up to {move:.3g} steps")
            flipped = flipped or move > float(margin.min())
        log(line)
        exact = float64_decides and torch.equal(s64.theta_idx[k], s_gpu.theta_idx[k].cpu())
        check(flipped or exact, f"theta differs beyond a float32 tie ({label}, chain {k})")
    return ~differ


def option_check(dev, label, inputs, temp, iteration):
    """Phase 26: one sweep with a new block on the card against the CPU from
    the same state and draws (:func:`sweep_inputs`, y drawn from the model
    at a state shared by the chains), float32: theta equal, or its
    difference a tie (:func:`tie_rule`); every field of the other chains
    within 1e-3, f* within 1e-3 + 1e-3 |f*| under one temperature a chain;
    the kernel launched once at C = 2 when the sweep's cutpoints are the
    y-marginal ESS, else never. Returns the largest differences."""
    inputs = dict(inputs)
    C = inputs.pop("C", 2)
    cfg, priors, state0, draws, y = sweep_inputs(C, model_y=True, iteration=iteration,
                                                 **inputs)
    cpu = torch.device("cpu")
    consts = {d: make_constants(cfg, *priors, device=d) for d in (cpu, dev)}
    launches = threshold_ess.binary_threshold_ess.launches
    s_cpu, ll_cpu, snap_cpu = option_sweep(cpu, state0, draws, y, consts[cpu], cfg, temp,
                                           iteration)
    s_gpu, ll_gpu, _ = option_sweep(dev, state0, draws, y, consts[dev], cfg, temp, iteration)
    n_launch = threshold_ess.binary_threshold_ess.launches - launches
    want = int(C == 2 and gibbs._cut_method(cfg, iteration) == "ess" and dev.type == "cuda")
    label = f"{label}, C={C}, H={cfg.horizon}, {cfg.theta_regime} regime, T=" + (
        temp_label(torch.tensor(temp)) if temp is not None else "1")
    check(n_launch == want, f"option sweep check: {n_launch} kernel launches ({label})")

    def run64():
        cfg64 = dataclasses.replace(cfg, dtype="float64")
        st = gibbs.GPIRTState(*(a.double() if a.is_floating_point() else a for a in state0))
        out = option_sweep(cpu, st, draws.to(torch.float64), y,
                           make_constants(cfg64, *priors, device=cpu), cfg64, temp, iteration)
        return out[0], out[2]

    gen = torch.Generator().manual_seed(0)

    def ulp(a):
        return a * (1.0 + 1.2e-7 * torch.randn(a.shape, generator=gen, dtype=a.dtype))

    def perturbed_runs(reps=4):
        out = []
        for _ in range(reps):
            c = dataclasses.replace(consts[cpu], U_se=ulp(consts[cpu].U_se),
                                    Psi_grid=ulp(consts[cpu].Psi_grid))
            st = state0._replace(fstar=ulp(state0.fstar), beta=ulp(state0.beta))
            s, _, snap = option_sweep(cpu, st, draws, y, c, cfg, temp, iteration)
            out.append((s.theta_idx, snap))
        return out

    differ = (s_gpu.theta_idx.cpu() != s_cpu.theta_idx).flatten(1).any(dim=1)
    keep = (tie_rule(label, cfg, s_gpu, s_cpu, snap_cpu, run64, perturbed_runs())
            if bool(differ.any()) else ~differ)
    for st in (s_cpu, s_gpu):
        for k in ("f", "beta", "fstar"):
            check(bool(torch.isfinite(getattr(st, k)).all()), f"sweep {k} not finite ({label})")
    check(bool(keep.any()), f"no chain left to compare ({label})")
    errs = {k: max_diff(getattr(s_gpu, k)[keep.to(dev)], getattr(s_cpu, k)[keep])[0]
            for k in ("f", "beta", "thresholds", "fstar")}
    errs["ll"] = max_diff(ll_gpu[keep.to(dev)], ll_cpu[keep])[0]
    log(f"option sweep check (card vs CPU, float32, {label}): theta equal in "
        f"{int(keep.sum())} of {keep.numel()} chains, {n_launch} kernel launches; max abs "
        "diff " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    for k in ("f", "beta", "thresholds"):
        check(errs[k] < 1e-3, f"sweep {k} differs by {errs[k]:.3g} ({label})")
    if temp is None:
        check(errs["fstar"] < 1e-3, f"sweep fstar differs by {errs['fstar']:.3g} ({label})")
    else:
        check(bool(torch.isclose(s_gpu.fstar.cpu()[keep], s_cpu.fstar[keep], rtol=1e-3,
                                 atol=1e-3).all()),
              f"sweep fstar differs beyond 1e-3 + 1e-3 |f*| ({label})")
    moved = (s_gpu.thresholds.cpu() != state0.thresholds)[..., 1:-1]
    check(float(moved.float().mean()) > 0.2, f"cutpoints did not move ({label})")
    return errs


def theta_ess_path(rm, dev, smi, chains=K, burn=BURN, draws=DRAWS):
    """Phase 27: senate116 through gpirt_mcmc(theta_method="ess") from the
    spread init, checked for one kernel launch a sweep and finite draws;
    prints the sweep rate, theta ESS and ESS per second, and the theta
    ESS's rounds and host syncs a sweep. Returns the kernel's launches, the
    inputs of its last call and the rates."""
    ess_update.calls = ess_update.rounds = ess_update.syncs = 0
    threshold_ess.binary_threshold_ess.launches = 0
    out, args = observe_kernel(lambda: gpirt_mcmc(
        rm, draws, burn, CHAIN=chains, SEED=SEED, theta_method="ess",
        theta_init=spread_init(np.asarray(rm).shape[0]), dtype="float32", device=dev,
        verbose=False))
    launches = threshold_ess.binary_threshold_ess.launches
    sweeps = burn + draws
    check(launches == (sweeps if dev.type == "cuda" else 0),
          f"ESS theta path: {launches} kernel launches for {sweeps} sweeps")
    check(ess_update.calls == sweeps, f"ESS theta path: {ess_update.calls} theta ESS updates")
    theta = cold_draws(out)
    ll = np.stack([d["ll"] for d in out])
    check(np.isfinite(theta).all() and np.isfinite(ll).all(), "ESS theta draws not finite")
    samp_s = out[0]["seconds"]["sampling"]
    within, pooled = theta_ess(theta, dev)
    res = {"sweeps_per_s": sweeps / samp_s, "rounds_per_sweep": ess_update.rounds / sweeps,
           "syncs_per_sweep": ess_update.syncs / sweeps, "within": within, "pooled": pooled}
    log(f"ESS theta path on {smi}: senate116, {chains} chains, {sweeps} sweeps in "
        f"{samp_s:.3f} s ({res['sweeps_per_s']:.2f} sweeps/s); {launches} kernel launches; "
        f"theta ESS rounds {res['rounds_per_sweep']:.2f} and host syncs "
        f"{res['syncs_per_sweep']:.2f} a sweep; theta ESS median within-chain (summed over "
        f"{chains} chains) {within:.1f}, pooled {pooled:.1f}; ess/sec {within / samp_s:.2f} "
        "(sampling wall)")
    return launches, args, res


def interleave_path(rm, dev, smi, chains=K, burn=BURN, draws=DRAWS, every=4):
    """Phase 28: senate116 through gpirt_mcmc(threshold_method="interleave",
    threshold_ess_every=4, mix_subsweeps=2): the kernel launched on the
    sweeps whose index is a multiple of 4 only; prints the sweep rate and
    theta ESS. Returns the launches and the rate."""
    threshold_ess.binary_threshold_ess.launches = 0
    calls = []
    out, _ = observe_kernel(lambda: gpirt_mcmc(
        rm, draws, burn, CHAIN=chains, SEED=SEED, threshold_method="interleave",
        threshold_ess_every=every, mix_subsweeps=2, dtype="float32", device=dev,
        verbose=False), before_call=calls.append)
    launches = threshold_ess.binary_threshold_ess.launches
    sweeps = burn + draws
    want = len(range(0, sweeps, every))
    check(len(calls) == want and launches == (want if dev.type == "cuda" else 0),
          f"interleave path: {launches} kernel launches ({len(calls)} calls) for {sweeps} "
          f"sweeps at k = {every}")
    theta = cold_draws(out)
    check(np.isfinite(theta).all() and all(np.isfinite(d["ll"]).all() for d in out),
          "interleave draws not finite")
    samp_s = out[0]["seconds"]["sampling"]
    within, pooled = theta_ess(theta, dev)
    log(f"interleave path on {smi}: senate116, {chains} chains, threshold_ess_every={every}, "
        f"mix_subsweeps=2, {sweeps} sweeps in {samp_s:.3f} s ({sweeps / samp_s:.2f} sweeps/s); "
        f"{launches} kernel launches of {sweeps} sweeps; theta ESS median within-chain "
        f"(summed over {chains} chains) {within:.1f}, pooled {pooled:.1f}; ess/sec "
        f"{within / samp_s:.2f}")
    return launches, sweeps / samp_s


def affine_run(rm, dev, shift_max, rounds, chains=K, burn=BURN, draws=DRAWS):
    """:func:`spread_run` with the affine moves at (affine_shift_max,
    affine_rounds): (theta (K, S, n), wall, kernel launches, orbit accepts,
    orbit moves, dilations accepted)."""
    affine.counts.update(orbit_accepted=0, orbit_moved=0, dilations_accepted=0)
    theta, _, wall, launches = spread_run(rm, dev, chains, burn, draws,
                                          affine_shift_max=shift_max, affine_rounds=rounds)
    return (theta, wall, launches, *(int(affine.counts[k]) for k in (
        "orbit_accepted", "orbit_moved", "dilations_accepted")))


def affine_path(rm, dev, smi, chains=K, burn=BURN, draws=DRAWS, shift_max=16, rounds=2):
    """Phase 29: scripts/tune_bench.py's affine setting (affine_shift_max=16,
    affine_rounds=2) and the moves off, senate116 through run_chains with 64
    chains from spread inits, burn 100 and 500 draws (tune_bench ran burn
    500 and 1000 draws); one kernel launch a sweep each; prints each run's
    sweep rate, theta ESS within and pooled, ESS per second and the moves'
    accept rates, and the ratios on to off. Returns the launches and the
    ratios."""
    sweeps = burn + draws
    res = {}
    for key, (w, r) in (("on", (shift_max, rounds)), ("off", (0, 0))):
        theta, wall, launches, acc, moved, dil = affine_run(rm, dev, w, r, chains, burn, draws)
        check(launches == (sweeps if dev.type == "cuda" else 0),
              f"affine path ({key}): {launches} kernel launches for {sweeps} sweeps")
        within, pooled = theta_ess(theta, dev)
        res[key] = dict(wall=wall, within=within, pooled=pooled, launches=launches)
        rates = ""
        if key == "on":
            lanes = chains * sweeps
            rates = (f"; orbit accept rate {acc / lanes:.4f}, moved {moved / lanes:.4f}; "
                     f"dilation accept rate {dil / (lanes * rounds):.4f}")
        log(f"affine path on {smi} (affine_shift_max={w}, affine_rounds={r}): senate116, "
            f"{chains} chains, {sweeps} sweeps in {wall:.3f} s ({sweeps / wall:.2f} "
            f"sweeps/s); {launches} kernel launches; theta ESS median within-chain (summed "
            f"over {chains} chains) {within:.1f}, pooled {pooled:.1f}; ess/sec "
            f"{within / wall:.2f}{rates}")
    ess_ratio = res["on"]["within"] / res["off"]["within"]
    wall_ratio = res["on"]["wall"] / res["off"]["wall"]
    log(f"affine on / off: within-chain theta ESS x{ess_ratio:.3f}, wall x{wall_ratio:.3f}, "
        f"ESS/s x{ess_ratio / wall_ratio:.3f} (JAX's comment for the TPU: ~1.5x ESS at "
        "~1.7x wall)")
    return res["on"]["launches"], ess_ratio, wall_ratio


def _temporary_dir():
    """A directory under CK_DIR (this checkout) for a phase's checkpoints
    and files, deleted with its contents when the phase ends."""
    return tempfile.TemporaryDirectory(prefix=".chip_smoke_ck_", dir=CK_DIR)


def checkpointed_main_path(rm, dev, smi, want, plain_rate, chains=K, burn=BURN,
                           draws=DRAWS, smc_steps=SMC_STEPS, cut=CK_CUT, every=CK_EVERY):
    """Phase 31: phase 5's call with a checkpoint every ``every`` sweeps,
    uninterrupted, then interrupted (the call at ``cut`` draws) and resumed
    (the full call): both hash (``draws_sha256``) to phase 5's ``want``,
    each counts one kernel launch a sweep, and the SMC initialization runs
    once in the interrupted pair. Prints the sweeps a second against
    phase 5's ``plain_rate``, the seconds in the saves and the size of the
    last checkpoint. Returns the launches of the pair, the last
    checkpoint's state on ``dev`` and the measurements."""
    call = dict(chains=chains, burn=burn, smc_steps=smc_steps, verbose=False,
                checkpoint_every=every)
    sweeps = WARM_STEPS + smc_steps - 1 + burn + draws
    expect = sweeps if dev.type == "cuda" else 0
    anneals = []
    anneal = api.anneal_init

    def counted(*args, **kwargs):
        anneals.append(1)
        return anneal(*args, **kwargs)

    api.anneal_init = counted
    try:
        with _temporary_dir() as tmp:
            threshold_ess.binary_threshold_ess.launches = 0
            full = main_call(rm, dev, draws=draws,
                             checkpoint_path=os.path.join(tmp, "full"), **call)
            full_launches = threshold_ess.binary_threshold_ess.launches
            full_bytes = os.path.getsize(os.path.join(tmp, "full.npz"))
            path = os.path.join(tmp, "cut")
            threshold_ess.binary_threshold_ess.launches = 0
            anneals.clear()
            main_call(rm, dev, draws=cut, checkpoint_path=path, **call)
            cut_bytes = os.path.getsize(path + ".npz")
            resumed = main_call(rm, dev, draws=draws, checkpoint_path=path, **call)
            launches = threshold_ess.binary_threshold_ess.launches
            state = CheckpointManager(path + ".npz").load(device=dev).state
    finally:
        api.anneal_init = anneal
    for label, out in (("uninterrupted", full), ("interrupted and resumed", resumed)):
        digest = draws_sha256(out)
        check(digest == want, f"checkpointed main path, {label}: draws sha256 {digest}, "
              f"phase 5's {want}")
    check(full_launches == expect and launches == expect,
          f"checkpointed main path: {full_launches} and {launches} kernel launches for "
          f"{sweeps} sweeps")
    check(len(anneals) == 1, f"the interrupted pair annealed {len(anneals)} times")
    sec = full[0]["seconds"]
    res = {"sweeps_per_s": (burn + draws) / sec["sampling"],
           "plain_sweeps_per_s": plain_rate, "save_s": sec["checkpoint"],
           "saves": -(-(burn + draws) // every), "bytes_last": full_bytes,
           "resume_save_s": resumed[0]["seconds"]["checkpoint"]}
    log(f"checkpointed main path on {smi}: every {every} sweeps, {res['saves']} saves; "
        f"draws sha256 = phase 5's, uninterrupted and interrupted at {cut} draws "
        f"({cut_bytes} bytes) then resumed; {launches} kernel launches = {sweeps} sweeps "
        f"over the pair, SMC once; sampling {res['sweeps_per_s']:.2f} sweeps/s against "
        f"{plain_rate:.2f} plain ({plain_rate / res['sweeps_per_s']:.3f}x the wall), "
        f"{res['save_s']:.3f} s in the saves ({res['resume_save_s']:.3f} s in the "
        f"resume's); last checkpoint {full_bytes} bytes")
    return launches, state, res


def checkpointed_tempering(rm, dev, smi, want, chains=K, burn=PT_BURN, draws=PT_DRAWS,
                           every=CK_EVERY):
    """Phase 32: phase 19's call with a checkpoint every ``every`` sweeps,
    interrupted after the burn and one chunk and resumed: its cold draws
    and swap rates hash to phase 19's ``want``, with one kernel launch a
    sweep over the pair. Returns the launches and the G L lanes' last
    state, phase 19's (phase 49 continues from it)."""
    call = dict(checkpoint_every=every)
    with _temporary_dir() as tmp:
        path = os.path.join(tmp, "tempered")
        threshold_ess.binary_threshold_ess.launches = 0
        cut = tempering_call(rm, dev, chains, burn, every, checkpoint_path=path, **call)
        out = tempering_call(rm, dev, chains, burn, draws, checkpoint_path=path, **call)
        size = os.path.getsize(path + ".npz")
        lanes = CheckpointManager(path + ".npz").load().state  # on the host
    launches = threshold_ess.binary_threshold_ess.launches
    sweeps = burn + draws
    digest = draws_sha256(out)
    check(digest == want, f"checkpointed tempering: sha256 {digest}, phase 19's {want}")
    check(launches == (sweeps if dev.type == "cuda" else 0),
          f"checkpointed tempering: {launches} kernel launches for {sweeps} sweeps")
    log(f"checkpointed tempering on {smi}: {chains} x {PT_TEMPS} lanes, interrupted at "
        f"{burn + every} sweeps and resumed; cold draws and swap rates sha256 = phase "
        f"19's; {launches} kernel launches = {sweeps} sweeps; saves {cut[0]['seconds']['checkpoint']:.3f} s "
        f"+ {out[0]['seconds']['checkpoint']:.3f} s, last checkpoint {size} bytes")
    return launches, lanes


def synthetic_checkpoint(dev, smi, inputs):
    """Phase 33: one save and one load of the synthetic configuration's
    state (:func:`synthetic_inputs`) after one sweep, each timed; the
    loaded state and generator state equal bit for bit. Returns (save s,
    load s, bytes)."""
    y, ti, thr, consts, cfg = inputs
    gen = torch.Generator(device=dev).manual_seed(SEED)
    carry = Carry(gibbs.init_state(ti, thr, consts, cfg,
                                   gibbs.init_draws(gen, ti.shape[0], consts, cfg)))
    advance_chains(gen, carry, y, consts, cfg, sample_schedule(1, 1, 1), 0, 1)
    state, rng = carry.state, gen.get_state()
    state_bytes = sum(a.numel() * a.element_size() for a in state)
    with _temporary_dir() as tmp:
        mgr = CheckpointManager(os.path.join(tmp, "synthetic.npz"))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        mgr.save(state, {"iteration": 1}, {}, rng)
        save_s = time.perf_counter() - t
        size = os.path.getsize(mgr.path)
        t = time.perf_counter()
        ck = mgr.load(device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        load_s = time.perf_counter() - t
    check(all(torch.equal(a, b) for a, b in zip(ck.state, state)) and
          torch.equal(torch.from_numpy(ck.rng_state), rng),
          "synthetic checkpoint: the loaded state differs")
    log(f"synthetic checkpoint on {smi}: state {state_bytes} bytes on the device "
        f"({tuple(state.f.shape)} f, {tuple(state.fstar.shape)} f*), file {size} bytes; "
        f"save {save_s:.3f} s ({size / save_s / 1e9:.3f} GB/s), load to the device "
        f"{load_s:.3f} s ({size / load_s / 1e9:.3f} GB/s); equal bit for bit")
    return save_s, load_s, size


def main_config(rm, dev, build=True):
    """(y on ``dev`` as int32, config, constants) of phase 5's call on
    ``rm``, with gpirt_mcmc's default priors, as it builds them (None
    without ``build``)."""
    y, C, _ = encode_categories(np.asarray(rm))
    H, n, m = y.shape
    cfg = GPIRTConfig(n=n, m=m, horizon=H, C=C, dtype="float32", jitter=1e-5)
    consts = make_constants(cfg, np.zeros((3, m)), np.full((3, m), 3.0),
                            np.zeros((2, n)), np.zeros((2, n)), device=dev) if build else None
    y_dev = torch.as_tensor(np.ascontiguousarray(y), dtype=torch.int32, device=dev)
    return y_dev, cfg, consts


def main_state_profile(rm, dev, state, reps=PROFILE_REPS):
    """profile_sweep at ``state``, a state of phase 5's configuration on
    ``rm``, the draws from a seed."""
    y_dev, cfg, consts = main_config(rm, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    draws = gibbs.sweep_draws(gen, state.theta_idx.shape[0], consts, cfg)
    return profile_sweep(state, draws, y_dev, consts, cfg, reps)


def profile_phase(rm, dev, smi, state):
    """Phase 34: profile_sweep at the main path's last state (phase 31's
    checkpoint): every block's time positive, the blocks' sum within a
    factor of 2 of the whole sweep. Returns the seconds by block."""
    out = main_state_profile(rm, dev, state)
    blocks = sum(v for k, v in out.items() if k != "full_sweep")
    ratio = blocks / out["full_sweep"] if out["full_sweep"] > 0 else math.inf
    check(all(v > 0 for v in out.values()), f"profile_sweep: a block not positive {out}")
    check(0.5 <= ratio <= 2.0, f"profile_sweep: blocks sum to {ratio:.3f}x the sweep")
    log(f"profile_sweep at the main path's state on {smi} (CUDA events, the slope "
        f"between {PROFILE_REPS} and {5 * PROFILE_REPS} calls): "
        + ", ".join(f"{k} {1e3 * v:.4f} ms" for k, v in out.items())
        + f"; the blocks sum to {ratio:.3f}x the sweep")
    return out


def utilities_phase(rm, dev, smi, chains=K, burn=UT_BURN, draws=UT_DRAWS, thin=UT_THIN):
    """Phase 35: a short run of phase 5's data with f and f* stored;
    posterior_irf of chain 0 (finite, each row's probabilities summing to
    1) and posterior_predictive of every chain's draws on the card
    (replicates 0 exactly where a vote is missing, in 1..C elsewhere), with
    the replicates' agreement with the observed votes. Returns that
    agreement."""
    out = gpirt_mcmc(rm, draws, burn, THIN=thin, CHAIN=chains, SEED=SEED, store_f=True,
                     store_fstar=True, dtype="float32", device=dev, verbose=False)
    t = time.perf_counter()
    irf = posterior_irf(out[0])
    irf_s = time.perf_counter() - t
    S = out[0]["theta"].shape[0]
    check(np.isfinite(irf).all() and irf.shape == (out[0]["fstar"].shape[1],) + irf.shape[1:],
          "posterior_irf not finite")
    check(np.allclose(irf.sum(axis=-1), 1.0, rtol=0, atol=1e-9),
          "posterior_irf rows do not sum to 1")
    y_dev, cfg, consts = main_config(rm, dev)
    C = cfg.C

    def lanes(k, axis):  # chain dicts' (S, ..., H) draws -> (chains S, H, ...)
        a = np.stack([np.moveaxis(d[k], -1, axis) for d in out])
        return torch.as_tensor(a.reshape((-1,) + a.shape[2:]), device=dev)

    draws_int = {"theta": lanes("theta", 1), "f": lanes("f", 1), "beta": lanes("beta", 1),
                 "threshold": lanes("threshold", 1)}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    u = response_draws(gen, chains * S, consts, cfg)
    t = time.perf_counter()
    rep = posterior_predictive(draws_int, consts, cfg, u, y_dev > 0)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    pp_s = time.perf_counter() - t
    observed = (y_dev > 0).expand_as(rep)
    check(bool((rep[~observed] == 0).all()) and
          bool(((rep[observed] >= 1) & (rep[observed] <= C)).all()),
          "posterior_predictive replicates out of range")
    agree = float((rep == y_dev).double()[observed].mean())
    check(agree > 0.6, f"posterior_predictive agrees with {agree:.3f} of the votes")
    log(f"utilities on {smi}: posterior_irf {irf.shape} in {irf_s:.3f} s, rows sum to 1; "
        f"posterior_predictive of {chains} x {S} draws {tuple(rep.shape)} in {pp_s:.4f} s, "
        f"agreeing with {agree:.4f} of the observed votes")
    return agree


def load_example(name):
    """The module ``examples/<name>.py`` of this checkout."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def signed_r(a, ref):
    """Pearson r of posterior means ``a`` with ``ref`` after aligning a's
    sign to ref's (the reflection theta -> -theta)."""
    aligned = align_theta_signs(np.asarray(a)[None], reference=ref)[0]
    return float(np.corrcoef(aligned, ref)[0, 1])


def example_r(port, jax_ref, label, min_r=EXAMPLE_MIN_R):
    """:func:`signed_r` of the port's posterior means ``port`` with the JAX
    run's ``jax_ref``; fails below ``min_r``."""
    r = signed_r(port, jax_ref)
    check(np.isfinite(r) and r >= min_r,
          f"{label}: posterior means correlate with JAX's at r = {r:.5f} < {min_r}")
    return r


def walkthrough_phase(dev, smi, argv=(), sweeps=WALK_SWEEPS):
    """Phase 36: examples/torch_senate116_walkthrough.py's main() with
    ``argv`` (its defaults when empty) on ``dev``, one kernel launch a sweep
    on the card. Returns its result, the launches and the kernel's inputs
    at the last sweep."""
    walk = load_example("torch_senate116_walkthrough")
    threshold_ess.binary_threshold_ess.launches = 0
    out, args = observe_kernel(lambda: walk.main([*argv, "--device", dev.type]))
    launches = threshold_ess.binary_threshold_ess.launches
    check(launches == (sweeps if dev.type == "cuda" else 0),
          f"walkthrough: {launches} kernel launches for {sweeps} sweeps")
    K, n = out["chain_means"].shape
    check(out["theta_hat"].shape == (n,) and np.isfinite(out["theta_hat"]).all(),
          "walkthrough theta_hat not finite")
    check(np.isfinite(out["ess_within"]) and out["ess_within"] > 0,
          "walkthrough theta ESS not positive")
    log(f"walkthrough on {smi}: {K} chains x {n} senators, {sweeps} sweeps in "
        f"{out['seconds']:.3f} s ({sweeps / out['seconds']:.2f} sweeps/s, the whole "
        f"gpirt_mcmc call); {launches} kernel launches")
    return out, launches, args


def walkthrough_agreement(out, fixture=EXAMPLES_FIXTURE):
    """Phase 36's gate: the walkthrough's sign-aligned theta_hat against the
    JAX run's (same call, same seed) at |r| >= EXAMPLE_MIN_R; prints JAX's
    own r between two seeds, each chain's r, and the ESS and R-hat beside
    JAX's. Returns r."""
    with np.load(fixture) as f:
        jx = {k: f[k] for k in f.files}
    check(np.array_equal(out["senators"], jx["walk_senators"]), "walkthrough senators")
    chain_r = [signed_r(c, jx["walk_theta_hat"]) for c in out["chain_means"]]
    log(f"walkthrough against JAX (SEED {int(jx['walk_seed'])}): each chain's r "
        f"{', '.join(f'{r:.5f}' for r in chain_r)}; JAX's own r between SEED "
        f"{int(jx['walk_seed'])} and {int(jx['other_seed'])} {float(jx['walk_r_seeds']):.5f}; "
        f"ESS pooled {out['ess_pooled']:.1f} (JAX {float(jx['walk_ess_pooled']):.1f}), "
        f"within-chain {out['ess_within']:.1f} (JAX {float(jx['walk_ess_within']):.1f}); "
        f"R-hat max {out['rhat_max']:.3f} (JAX {float(jx['walk_rhat_max']):.3f}); JAX's "
        f"call {float(jx['walk_seconds']):.1f} s on the CPU")
    r = example_r(out["theta_hat"], jx["walk_theta_hat"], "walkthrough")
    log(f"walkthrough theta_hat against JAX's: r {r:.5f} (gate {EXAMPLE_MIN_R})")
    return r


def sdo_example_phase(dev, smi, argv=(), sweeps=SDO_EX_SWEEPS):
    """Phase 37: examples/torch_sdo_ordinal.py's main() with ``argv`` (its
    defaults when empty) on ``dev``: no kernel launch (C = 5), and the
    examples' healthy output: finite ll, cutpoints, IRF values
    and theta means, every item's cutpoints increasing and moved off their
    qnorm(i/C) initial values. Returns its result."""
    sdo = load_example("torch_sdo_ordinal")
    threshold_ess.binary_threshold_ess.launches = 0
    out = sdo.main([*argv, "--device", dev.type])
    launches = threshold_ess.binary_threshold_ess.launches
    check(launches == 0, f"SDO example: {launches} binary kernel launches")
    cut = out["cutpoints"]
    m, C = cut.shape[0], cut.shape[1] + 1
    for k in ("cutpoints", "irf", "theta_mean", "ll"):
        check(bool(np.isfinite(out[k]).all()), f"SDO example {k} not finite")
    check(bool((np.diff(cut, axis=-1) > 0).all()), "SDO example cutpoints not increasing")
    qn = default_thresholds(C, m, 1)[0, :, 1:C]
    check(np.mean(cut != qn) > 0.99, "SDO example cutpoints did not move off qnorm(i/C)")
    log(f"SDO example on {smi}: {out['theta_mean'].size} x {m}, C={C}, one chain, "
        f"{sweeps} sweeps in {out['seconds']:.3f} s ({sweeps / out['seconds']:.2f} "
        f"sweeps/s, the whole gpirt_mcmc call, f* stored); binary kernel launches 0")
    return out


def sdo_example_agreement(out, fixture=EXAMPLES_FIXTURE):
    """Phase 37's gate. The SDO example's one chain settles in a basin that
    depends on its seed, in the JAX package too (the fixture's runs at R
    seeds), so its theta means are held to |r| >= EXAMPLE_MIN_R against the
    JAX run in the same basin, the one they correlate with best; prints how
    many of JAX's runs share that basin, JAX's SEED 1 r with its second
    seed, and item 1's cutpoints and IRF values and the mean ll beside that
    run's. Returns r."""
    with np.load(fixture) as f:
        jx = {k: f[k] for k in f.files}
    means = jx["sdo_theta_means"]
    rs = [signed_r(out["theta_mean"], ref) for ref in means]
    j = int(np.argmax(rs))
    basin = sum(signed_r(ref, means[j]) >= EXAMPLE_MIN_R for ref in means)

    def fmt(a):
        return np.array2string(np.asarray(a), precision=3, suppress_small=True)

    log(f"SDO example against JAX's {len(means)} runs (SEEDs "
        f"{', '.join(str(int(s)) for s in jx['sdo_seeds'])}): r "
        f"{', '.join(f'{r:.5f}' for r in rs)}; the best, SEED {int(jx['sdo_seeds'][j])}, "
        f"shares its basin with {basin} of JAX's {len(means)} runs; JAX's own r between "
        f"SEED {int(jx['sdo_seed'])} and {int(jx['other_seed'])} "
        f"{float(jx['sdo_r_seeds']):.5f}; item 1's cutpoints {fmt(out['cutpoints'][0])} "
        f"(JAX {fmt(jx['sdo_cutpoints'][j])}); IRF at theta = -2, 0, +2 {fmt(out['irf'])} "
        f"(JAX {fmt(jx['sdo_irf'][j])}); mean ll {float(np.mean(out['ll'])):.1f} (JAX "
        f"{float(jx['sdo_ll_mean'][j]):.1f}); JAX's call {float(jx['sdo_seconds']):.1f} s "
        f"on the CPU")
    r = example_r(out["theta_mean"], means[j], "SDO example")
    log(f"SDO example theta means against JAX's in the same basin: r {r:.5f} "
        f"(gate {EXAMPLE_MIN_R})")
    return r

# Phases 38-41: the multi-device path on the one card, its ranks sharing it
# through Gloo (parallel/distributed.py): the items over 2 ranks (38-39), a
# 2 x 2 chains x items mesh on 4 ranks (40), the chains over 2 (41). Each
# world of ranks must end within RANK_TIMEOUT seconds; a run's sign-aligned
# posterior theta means are held to phase 5's at r >= MESH_MIN_R; the theta
# table's all_reduce is timed inside the run (TimedAllReduce).
ITEM_SHARDS, RANK_TIMEOUT, MESH_MIN_R = 2, 400, 0.999
# phases 43 and 45's calls' burn, draws and SMC steps (their r with phase 5's
# means is printed, not gated: their gate is the continuation from phase 5's
# last state), cut from phase 5's to fit the time limit: burn 25 and 125
# draws at 320 SMC steps before the cut
MESH_BURN, MESH_DRAWS, MESH_SMC = 10, 40, 40
# Phases 42-45: respondent sharding (parallel/respondents.py) over
# RESP_SHARDS ranks: phase 42's affine sweep at phase 29's W and rounds;
# phase 44's synthetic run (phase 16's size) held to phase 16's sign-aligned
# posterior theta means at r >= SYN_MIN_R (two short runs of 5,000
# respondents: one run's means against another's, not against the truth).
RESP_SHARDS, AFFINE_W, AFFINE_ROUNDS, SYN_MIN_R = 2, 16, 2, 0.99
# phases 43 and 45's samplers continued from phase 5's last state: their
# posterior gate (r 0.99998 at 500, 200 and 100 draws, sharded and not,
# NVIDIA H100 80GB HBM3 at 700 W, PERF.md §6; cut from 100 draws to 50); phase 49's tempered continuation from phase 19's lane states
# (r 0.99964 at 100 draws, its gate 0.999: not cut)
CONT_DRAWS, PT_CONT_DRAWS = 50, 100
# Phases 46-49: phase 46's item-sharded sweeps hold theta equal in at least
# THETA_EQUAL_MIN of 64 chains (the rest ties); its ESS theta call and phase
# 49's tempered call from scratch (neither's posterior gated) run at
# MESH2_BURN and MESH2_DRAWS (cut from burn 20, 80 draws)
THETA_EQUAL_MIN, MESH2_BURN, MESH2_DRAWS = 62, 10, 40
# `chip_smoke.py --basins [s1,s2,...]`: the basin study's seeds, its draws
# (phase 5's burn) and the |r| at which a chain's means count as a basin's
BASIN_SEEDS, BASIN_DRAWS, BASIN_R = tuple(range(1, 9)), 200, 0.99
# phase 44's run, cut from phase 16's burn 30 and 150 draws to fit the time
# limit (burn 10, 40 draws before the last cut, r 0.9998 against its gate
# 0.99; its memory reading and its r gate stay)
SYN_SIZE = dict(n=SYN_N, m=SYN_M, K=SYN_K, burn=5, draws=20)

# Phase 50: phase 5's configuration continued from its last state on 2 item
# shards, RC_BURN burn and RC_DRAWS draws, a checkpoint every RC_EVERY sweeps,
# interrupted after sweep RC_CUT and resumed on no mesh and on 2 respondent
# shards (utils/checkpoint.py's stream rule); its posterior theta means held
# to the uninterrupted 2-shard run's at r >= MESH_MIN_R (burn 50, 150 draws,
# every 50 and cut after 100 before, r 0.999999 both ways)
RC_BURN, RC_DRAWS, RC_EVERY, RC_CUT = 20, 60, 20, 40

# the function of the sweep (or the SMC reweight) that asks for each
# all_reduce, and the name a respondent phase prints it under
ALLREDUCE_SITES = {"_theta_ll_table": "theta table", "_pathwise_fstar": "f* U^T r, U^T U",
                   "_binary_ess_over_respondents": "cutpoint ESS round",
                   "draw_threshold": "cutpoint ESS round",
                   "draw_threshold_collapsed": "collapsed z box",
                   "_draw_threshold_binary_newton": "Newton sums",
                   "_draw_threshold_newton_ordinal": "Newton sums",
                   "draw_beta_conjugate": "beta", "gibbs_sweep": "ll",
                   "anneal_init_batched": "SMC reweight ll", "_swap": "swap ll"}


def _rank_device(device):
    """A rank of phases 38-41: its device (distributed.rank_device), TF32
    off, and on a card the kernel phase 2 built, loaded."""
    dev = rank_device(device)
    full_fp32_matmuls()
    if dev.type == "cuda":
        threshold_ess.build()
    return dev


def _barrier():
    """The ranks meet (an all_reduce of a CPU scalar)."""
    dist.all_reduce(torch.zeros(1))


class TimedAllReduce:
    """``torch.distributed`` as the sweep sees it (``gibbs.dist``), its
    theta table's ``all_reduce`` (the 4-D one) timed where the run makes
    it: on a card by CUDA events on the current stream, which span the
    host copies and the reduce through Gloo as the sweep's stream waits
    for them; on the CPU by the host's clock."""

    def __init__(self, dev):
        self.dev, self.spans, self.bytes = dev, [], 0

    def __getattr__(self, name):
        return getattr(dist, name)

    def all_reduce(self, t, *args, **kwargs):
        if t.ndim != 4:
            return dist.all_reduce(t, *args, **kwargs)
        self.bytes = t.numel() * t.element_size()
        return self._timed(self.spans, t, args, kwargs)

    def _timed(self, spans, t, args, kwargs):
        if self.dev.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = dist.all_reduce(t, *args, **kwargs)
            end.record()
            spans.append((start, end))
            return out
        t0 = time.perf_counter()
        out = dist.all_reduce(t, *args, **kwargs)
        spans.append(1e3 * (time.perf_counter() - t0))
        return out

    def _ms(self, spans):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            return sum(a.elapsed_time(b) for a, b in spans)
        return sum(spans)

    def total_ms(self):
        return self._ms(self.spans)


class SiteAllReduce(TimedAllReduce):
    """:class:`TimedAllReduce` of every all_reduce the sweep (and the SMC
    reweight) makes, each timed the same way under its site
    (:data:`ALLREDUCE_SITES`, the first function up the stack that it
    names; beta's two all_reduces apart)."""

    def __init__(self, dev):
        super().__init__(dev)
        self.sites = {}

    def all_reduce(self, t, *args, **kwargs):
        site = "other"
        frame = sys._getframe(1)
        helper = frame.f_code.co_name
        while frame is not None:
            name = frame.f_code.co_name
            if name in ALLREDUCE_SITES:
                site = ALLREDUCE_SITES[name]
                if name == "draw_beta_conjugate":
                    site += " moments" if helper == "_all_sum" else " X^T X, X^T z"
                break
            frame = frame.f_back
        rec = self.sites.setdefault(site, {"calls": 0, "bytes": 0, "spans": []})
        rec["calls"] += 1
        rec["bytes"] += t.numel() * t.element_size()
        return self._timed(rec["spans"], t, args, kwargs)

    def summary(self, sweeps):
        """{site: (calls, bytes a call, ms)} a sweep over ``sweeps`` sweeps."""
        return {k: (v["calls"] / sweeps, v["bytes"] / max(v["calls"], 1),
                    self._ms(v["spans"]) / sweeps) for k, v in self.sites.items()}


def sites_line(sites):
    """One printed line of :meth:`SiteAllReduce.summary`'s sites."""
    return "; ".join(f"{k}: {c:.2f} calls of {b:,.0f} bytes, {ms:.3f} ms"
                     for k, (c, b, ms) in sorted(sites.items(), key=lambda kv: -kv[1][2]))


def _peak_gib(dev):
    return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0


def _theta_sha(out):
    return hashlib.sha256(np.ascontiguousarray(
        np.stack([d["theta"] for d in out])).tobytes()).hexdigest()


def _perturbed_sweeps(state, draws, y, consts, cfg, reps=4):
    """The sweep from ``state`` with its inputs moved by one float32
    rounding (relative N(0, 1.2e-7) noise on U_se, Psi, f* and beta),
    ``reps`` times, on ``state``'s device (PERF.md section 2's tie rule)."""
    gen = torch.Generator().manual_seed(0)

    def ulp(a):
        return a * (1.0 + 1.2e-7 * torch.randn(a.shape, generator=gen, dtype=a.dtype)
                    ).to(a.device)

    out = []
    for _ in range(reps):
        c = dataclasses.replace(consts, U_se=ulp(consts.U_se), Psi_grid=ulp(consts.Psi_grid))
        st = state._replace(fstar=ulp(state.fstar), beta=ulp(state.beta))
        out.append(gibbs.GPIRTState(*(a.cpu() for a in gibbs.gibbs_sweep(st, draws, y, c,
                                                                          cfg)[0])))
    return out


def _own_spread(want, perturbed, k):
    """The unsharded sweep's own float32 spread of field ``k``: its largest
    change over the perturbed runs whose chain drew the same theta."""
    spread = torch.zeros_like(want[k], dtype=torch.float64)
    for p in perturbed:
        alike = (p.theta_idx == want["theta_idx"]).flatten(1).all(dim=1)
        diff = (getattr(p, k).double() - want[k].double()).abs()
        spread = torch.maximum(spread, torch.where(
            alike.reshape((-1,) + (1,) * (diff.ndim - 1)), diff, 0.0))
    return spread


def sweep_agreement(label, got, want, state, draws, y, consts, cfg, relative=(),
                    float64_decides=False):
    """A sweep ``got`` against the unsharded sweep ``want`` on the card from
    the same state and draws: theta equal or its difference a float32 tie
    (:func:`tie_rule`, the perturbed runs on the card, the float64 run on
    the CPU), every other field of the other chains within 1e-3, those
    named in ``relative`` within 1e-3 + 1e-3 |want| plus four times the
    unsharded sweep's own float32 spread of the lane (its largest over the
    lane's sites or grid points; :func:`held_to_spread`, as the two-stage
    checks hold f*). ``float64_decides`` passes to :func:`tie_rule`.
    Returns (bit for bit, the largest differences)."""
    cpu = torch.device("cpu")
    want = gibbs.GPIRTState(*(a.cpu() for a in want))
    got = gibbs.GPIRTState(*(a.cpu() for a in got))
    same = all(torch.equal(a, b) for a, b in zip(got, want))

    def run64():
        cfg64 = dataclasses.replace(cfg, dtype="float64")
        c64 = make_constants(cfg64, np.zeros((3, cfg.m)), np.full((3, cfg.m), 3.0),
                             np.zeros((2, cfg.n)), np.zeros((2, cfg.n)), device=cpu)
        st = gibbs.GPIRTState(*(a.cpu().double() if a.is_floating_point() else a.cpu()
                                for a in state))
        return gibbs.gibbs_sweep(st, draws.to(cpu).to(torch.float64), y.cpu(), c64,
                                 cfg64)[0], None

    differ = (got.theta_idx != want.theta_idx).flatten(1).any(dim=1)
    keep = ~differ
    perturbed = (_perturbed_sweeps(state, draws, y, consts, cfg)
                 if relative or bool(differ.any()) else [])
    if bool(differ.any()):
        keep = tie_rule(label, cfg, got, want, None, run64,
                        [(p.theta_idx, None) for p in perturbed], float64_decides)
    check(bool(keep.any()), f"no chain left to compare ({label})")
    errs = {k: max_diff(getattr(got, k)[keep], getattr(want, k)[keep])[0]
            for k in ("f", "beta", "thresholds", "fstar")}
    for k, v in errs.items():
        if k not in relative:
            check(v < 1e-3, f"{label}: {k} differs by {v:.3g}")
            continue
        spread = _own_spread(want._asdict(), perturbed, k)[keep]
        g, w = getattr(got, k)[keep].double(), getattr(want, k)[keep].double()
        share, widening = held_to_spread(g, w, spread)
        rule = 1e-3 + 1e-3 * w.abs()
        ratio = (g - w).abs() / rule
        widen = (rule + 4.0 * spread.amax(dim=-2, keepdim=True)) / rule
        log(f"{label}: {k} differs most by {v:.3g}, {share:.3g} of 1e-3 + 1e-3 |x| plus "
            f"four times the unsharded sweep's own float32 spread (the 1e-3 rule widened up "
            f"to {widening:.3g} times, median {float(widen.median()):.3g}); against 1e-3 + "
            f"1e-3 |x| alone: {float(ratio.max()):.3g} of it at most, "
            f"{float((ratio > 1).double().mean()):.3g} of the values over it")
        check(share <= 1.0, f"{label}: {k} differs beyond 1e-3 + 1e-3 |x| + 4 x its spread")
    errs["chains_theta_equal"] = int(keep.sum())
    return same, errs


def sharded_sweep_rank(device, rm, state_path, out_dir, shards=ITEM_SHARDS):
    """Phase 38 on one rank: one sweep of the main path's state on this
    rank's item block, with the parent's constants (both in
    ``state_path``), fed the unsharded sweep's draws cut to it
    (parallel.items.draws_item_block), its result saved in ``out_dir``; on
    a card the kernel against its plain version on this rank's lanes."""
    entered = time.time()
    dev = _rank_device(device)
    y, cfg, _ = main_config(rm, dev, build=False)
    saved = torch.load(state_path, map_location=dev)
    state = gibbs.GPIRTState(*saved["state"])
    consts = GPIRTConstants(**saved["consts"])
    draws = gibbs.sweep_draws(torch.Generator(device=dev).manual_seed(SEED),
                              state.theta_idx.shape[0], consts, cfg)
    sh = shards_of(make_item_mesh(shards, device=dev.type), "items")
    y_b, _, cb, cl = item_inputs(y, state.thresholds[0], consts, cfg, sh)
    (got, ll), args = observe_kernel(lambda: gibbs.gibbs_sweep(
        lane_state_block(state, sh, "items"), draws_item_block(draws, sh.items(cfg.m)),
        y_b, cb, cl, None, 0, sh.item_group))
    torch.save([a.cpu() for a in got] + [ll.cpu()],
               os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))
    worst, flipped = 0.0, 0
    if dev.type == "cuda":
        worst, flipped = kernel_check(args, f"item shard {sh.item_rank}'s lanes")
    return {"lanes": args[2].numel(), "worst": worst, "flipped": flipped,
            "stamps": (entered, time.time())}


def sharded_sweep_inputs(rm, dev, state, tmp):
    """Phase 38's parent side before its ranks: the unsharded sweep of
    ``state`` on ``dev`` from the seeded draws, and the state and
    constants saved for the ranks. Returns (state file, what the check
    needs)."""
    y, cfg, consts = main_config(rm, dev)
    draws = gibbs.sweep_draws(torch.Generator(device=dev).manual_seed(SEED),
                              state.theta_idx.shape[0], consts, cfg)
    want, want_ll = gibbs.gibbs_sweep(state, draws, y, consts, cfg)
    return state_file(rm, dev, state, tmp, consts), (want, want_ll, state, draws, y, consts,
                                                     cfg)


def state_file(rm, dev, state, tmp, consts=None):
    """``state``, a state of phase 5's configuration on ``rm``, and that
    configuration's constants (built here unless given) saved for the
    ranks in ``tmp``; returns the file's path."""
    if consts is None:
        consts = main_config(rm, dev)[2]
    path = os.path.join(tmp, "state.pt")
    torch.save({"state": [a.cpu() for a in state],
                "consts": {k: None if v is None else v.cpu()
                           for k, v in vars(consts).items()}}, path)
    return path


def sharded_sweep_check(smi, ranks, tmp, inputs, shards=ITEM_SHARDS):
    """Phase 38: one item-sharded sweep on ``shards`` ranks of the card
    (``ranks``' results, their blocks in ``tmp``) against the unsharded
    sweep on the card, from the main path's last state (phase 31's
    checkpoint) and the same draws (the shards' cut to their items):
    :func:`sweep_agreement`, theta the same on every shard, and each
    rank's kernel against its plain version on its lanes. Returns the
    kernel's largest error and lanes over 1e-5."""
    want, want_ll, state, draws, y, consts, cfg = inputs
    blocks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(shards)]
    check(all(torch.equal(b[0], blocks[0][0]) for b in blocks),
          "sharded sweep: theta differs between the item shards")
    cat = [torch.cat([b[i] for b in blocks], dim=d) for i, d in ((1, -1), (2, -1),
                                                                 (3, -2), (4, -1))]
    got = gibbs.GPIRTState(blocks[0][0], *cat)
    same, errs = sweep_agreement(f"{shards} item shards against the unsharded sweep", got,
                                 want, state, draws, y, consts, cfg)
    ll_rel = float(((blocks[0][5] - want_ll.cpu()).abs() / want_ll.cpu().abs()).max())
    worst = max(r["worst"] for r in ranks)
    flipped = sum(r["flipped"] for r in ranks)
    log(f"sharded sweep check on {smi} ({shards} ranks sharing the card over Gloo, the "
        f"main path's state, {cfg.m // shards} items a rank): bit for bit {same}; theta "
        f"equal in {errs['chains_theta_equal']} of {got.theta_idx.shape[0]} chains; max abs "
        "diff " + ", ".join(f"{k} {errs[k]:.3g}" for k in ("f", "beta", "thresholds", "fstar"))
        + f"; ll relative {ll_rel:.3g}; the kernel on each rank's "
        f"{ranks[0]['lanes']} lanes: {flipped} over 1e-5, the rest within {worst:.3g}")
    return worst, flipped


def item_mesh_rank(device, rm, n_item, n_chain, burn, draws, smc_steps, chains=K):
    """Phases 39-40 on one rank: phase 5's call on a (n_chain x n_item)
    chains x items mesh, its kernel launches counted from 0 before the
    call; on a card the kernel against its plain version at this rank's
    last state (rank 0 times it and gives its bound while the others wait),
    and the theta table's all_reduce over the item group timed in the
    run (:class:`TimedAllReduce`)."""
    entered = time.time()
    dev = _rank_device(device)
    rank = dist.get_rank()
    mesh = make_item_mesh(n_item, n_chain, device=dev.type)
    sh = shards_of(mesh, "items")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    threshold_ess.binary_threshold_ess.launches = 0
    collectives = TimedAllReduce(dev)
    gibbs.dist = collectives
    try:
        out, args = observe_kernel(lambda: main_call(rm, dev, chains, burn, draws,
                                                     smc_steps, mesh=mesh, item_axis="items"))
    finally:
        gibbs.dist = dist
    ran = time.time()
    res = {"rank": rank, "place": (sh.chain_rank, sh.item_rank),
           "launches": threshold_ess.binary_threshold_ess.launches,
           "lanes": args[2].numel(), "theta_sha": _theta_sha(out), "means": theta_means(out),
           "seconds": out[0]["seconds"], "peak_gib": _peak_gib(dev),
           "finite": bool(all(np.isfinite(d["ll"]).all() for d in out))}
    if dev.type == "cuda":
        res["worst"], res["flipped"] = kernel_check(args, f"rank {rank}'s state")
        _barrier()
        if rank == 0:
            res["ms"], res["ms_eager"], res["plain_ms"] = kernel_times(args, _C)
            res["work"] = kernel_bound(args, _C, "rank 0's state")
        _barrier()
    res["allreduce_total_ms"] = collectives.total_ms()
    res["allreduce_calls"] = len(collectives.spans)
    res["allreduce_bytes"] = collectives.bytes
    res["stamps"] = (entered, ran, time.time())
    return res


def item_mesh_report(rm, dev, smi, want_means, ranks, n_item, n_chain, burn, draws,
                     smc_steps, label, chains=K):
    """Phases 39 (2 item shards) and 40 (a 2 x 2 chains x items mesh):
    phase 5's call, gpirt_mcmc(mesh=make_item_mesh(n_item, n_chain),
    item_axis="items"), on n_item n_chain ranks of the card (``ranks``'
    results): one kernel launch a sweep on every rank at its K / n_chain x
    m / n_item lanes, finite, theta bit for bit the same on every rank,
    and its posterior theta means at r >= MESH_MIN_R with phase 5's.
    Prints the backend, the sweeps a second, the table's all_reduce bytes
    and ms a sweep, each rank's peak memory, and the kernel at rank 0's
    state with its bound. Returns the numbers for the kernels line."""
    world = n_item * n_chain
    sweeps = WARM_STEPS + smc_steps - 1 + burn + draws
    m = np.asarray(rm).shape[1]
    lanes = (chains // n_chain) * (m // n_item)
    for r in ranks:
        check(r["launches"] == (sweeps if dev.type == "cuda" else 0),
              f"phase {label}, rank {r['rank']}: {r['launches']} kernel launches for "
              f"{sweeps} sweeps")
        check(r["lanes"] == lanes, f"phase {label}, rank {r['rank']}: {r['lanes']} lanes, "
              f"{lanes} expected")
        check(r["finite"], f"phase {label}, rank {r['rank']}: ll not finite")
        check(r["theta_sha"] == ranks[0]["theta_sha"],
              f"phase {label}: theta differs between ranks 0 and {r['rank']}")
    r_means = signed_r(ranks[0]["means"], want_means)
    check(np.isfinite(r_means) and r_means >= MESH_MIN_R,
          f"phase {label}: posterior theta means at r {r_means:.5f} with phase 5's")
    sec = ranks[0]["seconds"]
    rate = (burn + draws) / sec["sampling"]
    sweep_ms = 1e3 / rate
    ar = ranks[0]["allreduce_total_ms"] / sweeps  # in the run, its SMC sweeps too
    backend = backend_for(dev.type, world, torch.cuda.device_count() if dev.type == "cuda"
                          else 0)
    res = {"launches": [r["launches"] for r in ranks], "lanes": lanes, "sweeps_per_s": rate,
           "smc_s": sec["smc"], "sampling_s": sec["sampling"], "allreduce_ms": ar,
           "allreduce_bytes": ranks[0]["allreduce_bytes"], "allreduce_share": ar / sweep_ms,
           "allreduce_calls": ranks[0]["allreduce_calls"],
           "peak_gib": [r["peak_gib"] for r in ranks], "r_phase5": r_means,
           "backend": backend}
    if dev.type == "cuda":
        r0 = ranks[0]
        res.update(worst=max(r["worst"] for r in ranks),
                   flipped=sum(r["flipped"] for r in ranks), ms=r0["ms"],
                   ms_eager=r0["ms_eager"], plain_ms=r0["plain_ms"],
                   bound_ms=r0["work"]["bound_ms"], bound_by=r0["work"]["bound_by"])
    log(f"phase {label} on {smi}: {n_chain} x {n_item} chains x items mesh, {world} ranks "
        f"on {'the card' if dev.type == 'cuda' else 'the CPU'}, backend {backend}; "
        f"burn {burn}, {draws} draws; {ranks[0]['launches']} kernel launches = {sweeps} "
        f"sweeps on every rank, {lanes} lanes a launch; theta the same on every rank; "
        f"posterior theta means r {r_means:.5f} with phase 5's; smc {sec['smc']:.3f} s, "
        f"sampling {sec['sampling']:.3f} s ({rate:.2f} sweeps/s, {sweep_ms:.3f} ms a "
        f"sweep); the table's all_reduce {res['allreduce_bytes']} bytes, "
        f"{res['allreduce_calls']} calls in the run, {ar:.3f} ms a sweep timed in the run "
        f"({100 * res['allreduce_share']:.1f}% of a sampling sweep; Gloo through the host, ranks "
        "sharing one card: not a multi-GPU number); peak memory by rank "
        + ", ".join(f"{g:.3f}" for g in res["peak_gib"]) + " GiB")
    if dev.type == "cuda":
        log(f"kernel at rank 0's state ({lanes} lanes): {res['ms']:.5f} ms (graph), "
            f"{res['ms_eager']:.5f} ms (eager), plain {res['plain_ms']:.4f} ms; bound "
            f"{res['bound_ms']:.5f} ms by {res['bound_by']}, "
            f"{100 * res['bound_ms'] / res['ms']:.2f}% of it; {res['flipped']} lanes over "
            f"1e-5 on all ranks")
    return res


def mesh_2x2(rm, dev, smi, want_means, chains=K, burn=BURN, draws=DRAWS,
             smc_steps=SMC_STEPS, phases=(40,), rates=None, state=None, tempered=None,
             mesh2=(MESH2_BURN, MESH2_DRAWS), resp_size=(MESH_BURN, MESH_DRAWS),
             resp_smc=None):
    """Phases 40, 45 and 49 as the stages of one world of 4 ranks
    (``phases``, each checked here): phase 40, :func:`item_mesh_report` of
    phase 5's call on a 2 x 2 chains x items mesh at ``burn`` and
    ``draws``, and phase 45, :func:`resp_mesh_report` of it on a 2 x 2
    items x respondents mesh at ``resp_size`` (burn, draws) and ``resp_smc``
    SMC steps (``smc_steps`` when None); ``rates`` the sweep rates phase 45
    prints beside its own, ``state`` the main path's last state its
    continuation starts from; phase 49, :func:`tempered_mesh_report` of
    phase 19's tempering on the items x respondents mesh, ``tempered``
    giving phase 19's last lane states ("lanes") and posterior means
    ("means"), its call from scratch at ``mesh2`` (burn, draws). Returns
    {phase: its numbers}."""
    resp_smc = smc_steps if resp_smc is None else resp_smc
    with _temporary_dir() as tmp:
        path = state_file(rm, dev, state, tmp) if 45 in phases else None
        pt_path = None
        if 49 in phases:
            os.makedirs(os.path.join(tmp, "pt"))
            pt_path = state_file(rm, dev, tempered["lanes"], os.path.join(tmp, "pt"))
        specs = {40: (item_mesh_rank, (rm, 2, 2, burn, draws, smc_steps, chains)),
                 45: (resp_mesh_rank, (rm, 2, *resp_size, resp_smc, chains, path,
                                       CONT_DRAWS)),
                 49: (tempered_mesh_rank, (rm, pt_path, PT_CONT_DRAWS, chains) + tuple(mesh2))}
        started = time.time()
        ranks = launch(rank_world, 4, (dev.type, [(p,) + specs[p] for p in phases]),
                       device=dev.type, stages=(RANK_TIMEOUT,) * len(phases))
        log(f"phases {', '.join(map(str, phases))} in one world of 4 ranks on {smi}: "
            + stage_ends(started, ranks, phases))
        out = {}
        if 40 in phases:
            out[40] = item_mesh_report(rm, dev, smi, want_means, [r[40] for r in ranks], 2, 2,
                                       burn, draws, smc_steps, "40", chains)
        if 45 in phases:
            out[45] = resp_mesh_report(rm, dev, smi, want_means, [r[45] for r in ranks], 2,
                                       *resp_size, resp_smc, "45", rates or {}, chains,
                                       path)
        if 49 in phases:
            out[49] = tempered_mesh_report(rm, dev, smi, [r[49] for r in ranks],
                                           tempered["means"], pt_path, *mesh2)
    return out


def draws_cost(dev, consts, cfg, chains=K, reps=5):
    """(numbers, ms) of one sweep's draws for ``chains`` chains at ``cfg``'s
    widths on ``dev``: what every rank of a chain mesh generates a sweep to
    keep its block of them (CUDA events over ``reps`` calls on a card)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sizes = []
    gibbs._map_draws(lambda a: sizes.append(a.numel()) or a,
                     gibbs.sweep_draws(gen, chains, consts, cfg))
    return sum(sizes), loop_ms(lambda: gibbs.sweep_draws(gen, chains, consts, cfg), reps, 1)


def chain_mesh_rank(device, rm, chains, burn, cut, smc_steps, path, every):
    """Phase 41 on one rank: phase 5's call at ``cut`` draws on a chain
    mesh over the world, checkpointed every ``every`` sweeps to ``path``,
    its launches counted from 0."""
    entered = time.time()
    dev = _rank_device(device)
    mesh = make_chain_mesh(device=dev.type)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    threshold_ess.binary_threshold_ess.launches = 0
    out = main_call(rm, dev, chains, burn, cut, smc_steps, mesh=mesh, checkpoint_path=path,
                    checkpoint_every=every, verbose=False)
    return {"sha": draws_sha256(out), "means": theta_means(out),
            "launches": threshold_ess.binary_threshold_ess.launches,
            "seconds": out[0]["seconds"], "peak_gib": _peak_gib(dev),
            "stamps": (entered, time.time())}


def chain_mesh_check(rm, dev, smi, want, want_cut, want_means, state, ranks, path,
                     world=2, chains=K, burn=BURN, draws=DRAWS, smc_steps=SMC_STEPS,
                     cut=CK_CUT, every=CK_EVERY):
    """Phase 41: one sweep of a chain block of the main path's last state
    against the whole's (:func:`sweep_agreement`; bit for bit or not,
    printed); phase 5's call on a ``world``-rank chain mesh (``ranks``'
    results), cut at ``cut`` draws and checkpointed there, its sha256
    beside phase 5's first ``cut`` draws' (``want_cut``), then resumed
    with no mesh to phase 5's length, beside phase 5's (``want``). Bit for
    bit, both hash to phase 5's; where the card's batched products round
    differently at K / world chains, that is printed and both are held to
    phase 5's posterior theta means at r >= MESH_MIN_R. One kernel launch
    a sweep on every rank and in the resume. Prints the replicated
    generator's cost a sweep. Returns the numbers for the kernels line."""
    y, cfg, consts = main_config(rm, dev)
    Kst = state.theta_idx.shape[0]
    draws_all = gibbs.sweep_draws(torch.Generator(device=dev).manual_seed(SEED), Kst,
                                  consts, cfg)
    whole, _ = gibbs.gibbs_sweep(state, draws_all, y, consts, cfg)
    own = slice(0, Kst // world)
    block, _ = gibbs.gibbs_sweep(gibbs.GPIRTState(*(a[own] for a in state)),
                                 lane_block(draws_all, own), y, consts, cfg)
    block_same, block_errs = sweep_agreement(
        f"a block of {Kst // world} chains against the sweep of {Kst}", block,
        gibbs.GPIRTState(*(a[own] for a in whole)),
        gibbs.GPIRTState(*(a[own] for a in state)), lane_block(draws_all, own), y, consts,
        cfg)
    threshold_ess.binary_threshold_ess.launches = 0
    t = time.perf_counter()
    resumed = main_call(rm, dev, chains, burn, draws, smc_steps, checkpoint_path=path,
                        checkpoint_every=every, verbose=False)
    resume_s = time.perf_counter() - t
    res_launches = threshold_ess.binary_threshold_ess.launches
    on_card = dev.type == "cuda"
    cut_sweeps = WARM_STEPS + smc_steps - 1 + burn + cut
    for i, r in enumerate(ranks):
        check(r["sha"] == ranks[0]["sha"], f"chain mesh: ranks 0 and {i} return other draws")
        check(r["launches"] == (cut_sweeps if on_card else 0),
              f"chain mesh, rank {i}: {r['launches']} launches for {cut_sweeps} sweeps")
    check(res_launches == (draws - cut if on_card else 0),
          f"chain mesh resume: {res_launches} launches for {draws - cut} sweeps")
    mesh_sha, res_sha = ranks[0]["sha"], draws_sha256(resumed)
    bitwise = mesh_sha == want_cut
    r_mesh = signed_r(ranks[0]["means"], want_means)
    r_res = signed_r(theta_means(resumed), want_means)
    if bitwise:
        check(res_sha == want, f"chain mesh: the resumed run's sha256 {res_sha}, "
              f"phase 5's {want}")
    else:
        for lab, r in (("the chain mesh's", r_mesh), ("the resumed run's", r_res)):
            check(r >= MESH_MIN_R, f"chain mesh: {lab} posterior theta means at r {r:.5f}")
    costs = {}
    if on_card:  # the replicated generator's work a sweep, on every rank
        costs = {"main": draws_cost(dev, consts, cfg, chains),
                 "synthetic": draws_cost(dev, consts,
                                         dataclasses.replace(cfg, n=SYN_N, m=SYN_M), chains)}
        log(f"phase 41 on {smi}: one sweep's numbers for all {chains} chains, as every "
            "rank of a chain mesh draws them: "
            + "; ".join(f"{k} {v[0]:,} numbers in {v[1]:.4f} ms" for k, v in costs.items()))
    sec = ranks[0]["seconds"]
    rate = (burn + cut) / sec["sampling"]
    log(f"phase 41 on {smi}: a {Kst // world}-chain block's sweep against the "
        f"{Kst}-chain sweep: bit for bit {block_same}, theta equal in "
        f"{block_errs['chains_theta_equal']} of {Kst // world} chains, max abs diff "
        + ", ".join(f"{k} {block_errs[k]:.3g}" for k in ("f", "beta", "thresholds", "fstar")))
    log(f"phase 41 on {smi}: chain mesh of {world} ranks, {chains // world} chains each, "
        f"checkpointed every {every} sweeps and cut at {cut} draws: draws sha256 {mesh_sha} "
        f"({'=' if bitwise else 'differs from'} phase 5's first {cut} draws' {want_cut}); "
        f"resumed with no mesh: sha256 {res_sha} ({'=' if res_sha == want else 'differs from'} "
        f"phase 5's {want}); posterior theta means r {r_mesh:.5f} (mesh), {r_res:.5f} "
        f"(resumed) with phase 5's; launches {ranks[0]['launches']} = {cut_sweeps} sweeps a "
        f"rank, {res_launches} in the resume ({resume_s:.1f} s); sampling {rate:.2f} "
        "sweeps/s on the mesh; peak memory by rank "
        + ", ".join(f"{r['peak_gib']:.3f}" for r in ranks) + " GiB")
    return {"launches": [r["launches"] for r in ranks], "bitwise": bitwise,
            "block_bitwise": block_same, "sweeps_per_s": rate,
            "draws_numbers": {k: v[0] for k, v in costs.items()},
            "draws_ms": {k: v[1] for k, v in costs.items()}}


def resp_sweep_configs(cfg, shift_max):
    """Phase 42's two sweeps: the main path's configuration, and with the
    affine moves on at W = ``shift_max`` and AFFINE_ROUNDS rounds."""
    return {"plain": cfg, "affine": dataclasses.replace(
        cfg, affine_shift_max=shift_max, affine_rounds=AFFINE_ROUNDS)}


def resp_sweep_rank(device, rm, state_path, out_dir, shift_max, shards=RESP_SHARDS):
    """Phase 42 on one rank: one sweep of the main path's state on this
    rank's respondent block, with the parent's constants (both in
    ``state_path``), fed the unsharded sweep's draws cut to it
    (parallel.respondents.draws_respondent_block), with the affine moves off
    and on, the results saved in ``out_dir``; the kernel's launches and the
    cutpoint ESS rounds counted."""
    entered = time.time()
    dev = _rank_device(device)
    y, cfg, _ = main_config(rm, dev, build=False)
    saved = torch.load(state_path, map_location=dev)
    state = gibbs.GPIRTState(*saved["state"])
    consts = GPIRTConstants(**saved["consts"])
    sh = shards_of(make_respondent_mesh(shards, device=dev.type), None, "respondents")
    block = lane_state_block(state, sh, None, "respondents")
    threshold_ess.binary_threshold_ess.launches = 0
    ess_update.calls = ess_update.rounds = 0
    for label, c in resp_sweep_configs(cfg, shift_max).items():
        draws = gibbs.sweep_draws(torch.Generator(device=dev).manual_seed(SEED),
                                  state.theta_idx.shape[0], consts, c)
        y_b, _, cb, cl = shard_inputs(y, state.thresholds[0], consts, c, sh)
        got, ll = gibbs.gibbs_sweep(block, draws_respondent_block(draws, sh.respondents(c.n), c),
                                    y_b, cb, cl, None, 0, None, sh.resp_group)
        torch.save([a.cpu() for a in got] + [ll.cpu()],
                   os.path.join(out_dir, f"resp_{label}_rank{dist.get_rank()}.pt"))
    return {"launches": threshold_ess.binary_threshold_ess.launches,
            "ess_rounds": ess_update.rounds, "ess_calls": ess_update.calls,
            "stamps": (entered, time.time())}


def resp_sweep_inputs(rm, dev, state):
    """Phase 42's parent side before its ranks: the unsharded sweeps of
    ``state`` on ``dev`` from the seeded draws, with the affine moves off
    and on. Returns {label: what the check needs}."""
    y, cfg, consts = main_config(rm, dev)
    out = {}
    for label, c in resp_sweep_configs(cfg, AFFINE_W).items():
        draws = gibbs.sweep_draws(torch.Generator(device=dev).manual_seed(SEED),
                                  state.theta_idx.shape[0], consts, c)
        want, want_ll = gibbs.gibbs_sweep(state, draws, y, consts, c)
        out[label] = (want, want_ll, state, draws, y, consts, c)
    return out


def resp_sweep_check(smi, ranks, tmp, inputs, shards=RESP_SHARDS):
    """Phase 42: each respondent-sharded sweep on ``shards`` ranks of the
    card (``ranks``' results, their blocks in ``tmp``) against the unsharded
    sweep on the card from the main path's last state (phase 31's
    checkpoint) and the same draws (the shards' cut to their respondents):
    beta, the cutpoints and f* bit for bit the same on every shard (the
    replication canary), :func:`sweep_agreement`, and no kernel launch
    (the cutpoint ESS runs its plain round loop, its lane totals
    all-reduced). The affine sweep holds the low-rank z-marginal and orbit
    against the dense forms. Returns {label: the largest differences}."""
    out = {}
    for label, (want, want_ll, state, draws, y, consts, cfg) in inputs.items():
        blocks = [torch.load(os.path.join(tmp, f"resp_{label}_rank{r}.pt"))
                  for r in range(shards)]
        for i, name in ((2, "beta"), (3, "thresholds"), (4, "fstar"), (5, "ll")):
            check(all(torch.equal(b[i], blocks[0][i]) for b in blocks),
                  f"respondent-sharded sweep ({label}): {name} differs between the shards")
        got = gibbs.GPIRTState(torch.cat([b[0] for b in blocks], dim=-1),
                               torch.cat([b[1] for b in blocks], dim=-2), *blocks[0][2:5])
        # f* is drawn from sums over the respondents, which each shard count
        # adds in another order, and float32 moves f* by its own rounding
        # spread (up to ~1e-2 near the grid's edges): f* and the f read from it
        # are held to 1e-3 + 1e-3 |x| + 4 x that spread. The affine moves' two
        # forms (low-rank here, dense unsharded) decide in float32 apart
        # where the dense one errs: the float64 run decides.
        same, errs = sweep_agreement(f"{shards} respondent shards against the unsharded "
                                     f"sweep, {label}", got, want, state, draws, y, consts, cfg,
                                     relative=("f", "fstar"), float64_decides=True)
        ll_rel = float(((blocks[0][5] - want_ll.cpu()).abs() / want_ll.cpu().abs()).max())
        log(f"respondent-sharded sweep check ({label}) on {smi} ({shards} ranks sharing the "
            f"card over Gloo, the main path's state, {cfg.n // shards} respondents a rank): "
            f"beta, cutpoints and f* bit for bit the same on every shard; bit for bit the "
            f"unsharded sweep {same}; theta equal in {errs['chains_theta_equal']} of "
            f"{got.theta_idx.shape[0]} chains; max abs diff "
            + ", ".join(f"{k} {errs[k]:.3g}" for k in ("f", "beta", "thresholds", "fstar"))
            + f"; ll relative {ll_rel:.3g}")
        out[label] = errs
    r0 = ranks[0]
    for r in ranks:
        check(r["launches"] == 0, f"respondent-sharded sweep: {r['launches']} kernel launches")
    log(f"phase 42 on {smi}: 0 kernel launches on every rank; the cutpoint ESS "
        f"{r0['ess_rounds'] / max(r0['ess_calls'], 1):.1f} rounds an update (each ending in "
        "an all_reduce of its lane totals)")
    return out


def resp_mesh_rank(device, rm, n_item, burn, draws, smc_steps, chains, state_path,
                   cont_draws):
    """Phases 43 and 45 on one rank: phase 5's call on a respondent mesh of
    RESP_SHARDS (with ``n_item`` item shards beside it,
    make_respondent_mesh(RESP_SHARDS, n_item_shards=n_item)), its kernel
    launches and cutpoint ESS rounds counted from 0 before the call, and
    every all_reduce of the run timed under its site (:class:`SiteAllReduce`);
    then the same mesh's sampler continued from the main path's last state
    (in ``state_path``, with its constants) for ``cont_draws`` draws, its
    posterior theta means."""
    entered = time.time()
    dev = _rank_device(device)
    mesh = make_respondent_mesh(RESP_SHARDS, n_item_shards=n_item, device=dev.type)
    item_axis = "items" if n_item > 1 else None
    sh = shards_of(mesh, item_axis, "respondents")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    threshold_ess.binary_threshold_ess.launches = 0
    ess_update.calls = ess_update.rounds = 0
    sites = SiteAllReduce(dev)
    gibbs.dist = sites
    try:
        out = main_call(rm, dev, chains, burn, draws, smc_steps, mesh=mesh,
                        item_axis=item_axis, respondent_axis="respondents")
    finally:
        gibbs.dist = dist
    ran = time.time()
    sweeps = WARM_STEPS + smc_steps - 1 + burn + draws
    cont = continuation(dev, rm, state_path, cont_draws, mesh, item_axis)
    return {"rank": dist.get_rank(), "place": (sh.item_rank, sh.resp_rank),
            "continued_means": cont,
            "launches": threshold_ess.binary_threshold_ess.launches,
            "ess_rounds": ess_update.rounds, "ess_calls": ess_update.calls,
            "theta_sha": _theta_sha(out), "replicated_sha": _fields_sha(out),
            "means": theta_means(out), "seconds": out[0]["seconds"],
            "peak_gib": _peak_gib(dev), "sites": sites.summary(sweeps),
            "finite": bool(all(np.isfinite(d["ll"]).all() and np.isfinite(d["theta"]).all()
                               for d in out)),
            "stamps": (entered, ran, time.time())}


def resume_counts_run(dev, rm, state_path, rc, path=None, draws=None, mesh=None, axes=None,
                      start=True):
    """Phase 50's run: phase 5's configuration from the state in
    ``state_path`` (with its constants; this rank's block of it on
    ``mesh``, whose item and respondent axes are ``axes``) for ``rc``'s
    (burn, draws, every, cut) burn and draws (or ``draws``), checkpointed
    to ``path`` every ``every`` sweeps (a file there is resumed, and the
    state is not read), the kernel's launches counted from 0. Returns
    (run_chains_checkpointed's host draws, the launches)."""
    burn, n_draws, every, _ = rc
    y, cfg, _ = main_config(rm, dev, build=False)
    saved = torch.load(state_path, map_location=dev)
    state = gibbs.GPIRTState(*saved["state"])
    consts = GPIRTConstants(**saved["consts"])
    K = state.theta_idx.shape[0]
    sharding = {} if mesh is None else dict(mesh=mesh, item_axis=axes[0],
                                            respondent_axis=axes[1])
    if mesh is not None:
        state = lane_state_block(state, mesh, *axes)
    thr = torch.as_tensor(default_thresholds(cfg.C, cfg.m, cfg.horizon), dtype=cfg.tdtype,
                          device=dev)  # unread: the run starts from ``state``
    threshold_ess.binary_threshold_ess.launches = 0
    out = run_chains_checkpointed(
        torch.Generator(device=dev).manual_seed(SEED + 2), y,
        torch.zeros(K, cfg.horizon, cfg.n, device=dev), thr, consts, cfg,
        sample_iterations=n_draws if draws is None else draws, burn_iterations=burn,
        manager=None if path is None else CheckpointManager(path), checkpoint_every=every,
        initial_states=state if start else None, **sharding)
    return out, threshold_ess.binary_threshold_ess.launches


def resume_counts_rank(device, rm, state_path, tmp, rc=(RC_BURN, RC_DRAWS, RC_EVERY, RC_CUT)):
    """Phase 50 on one rank (``rc`` its (burn, draws, every, cut)): the
    uninterrupted run on 2 item shards, the same run interrupted after
    sweep ``cut`` (its file ``rc_cut.npz`` in ``tmp``, copied for the
    resumes: "rc_a1" and "rc_a2" for the parent's, "rc_b" for this
    world's), and its resume on 2 respondent shards. Returns the posterior
    theta means, the launches of each run, whether the resumed draws begin
    with the file's, and the resumed draws' sha256."""
    entered = time.time()
    burn, _, _, cut_at = rc
    dev = _rank_device(device)
    items = make_item_mesh(ITEM_SHARDS, device=dev.type)
    resp = make_respondent_mesh(RESP_SHARDS, device=dev.type)
    full, l_full = resume_counts_run(dev, rm, state_path, rc, mesh=items, axes=("items", None))
    cut = os.path.join(tmp, "rc_cut.npz")
    _, l_cut = resume_counts_run(dev, rm, state_path, rc, cut, cut_at - burn, items,
                                 ("items", None))
    if dist.get_rank() == 0:
        for tag in ("a1", "a2", "b"):
            shutil.copy(cut, os.path.join(tmp, f"rc_{tag}.npz"))
    _barrier()
    res, l_resp = resume_counts_run(dev, rm, state_path, rc, os.path.join(tmp, "rc_b.npz"),
                                    mesh=resp, axes=(None, "respondents"), start=False)
    kept = CheckpointManager(cut).load().draws
    return {"rank": dist.get_rank(), "launches": {"items2": l_full, "items2_cut": l_cut,
                                                   "resp2_resumed": l_resp},
            "means_full": run_means(torch.as_tensor(full["theta"])),
            "means_resp": run_means(torch.as_tensor(res["theta"])),
            "prefix_resp": all(np.array_equal(res[k][:, :cut_at - burn], v)
                               for k, v in kept.items()),
            "sha_resp": draws_sha256_host(res), "stamps": (entered, time.time())}


def draws_sha256_host(draws):
    """The sha256 of a driver's host draws (theta, beta, threshold, ll)."""
    h = hashlib.sha256()
    for k in ("theta", "beta", "threshold", "ll"):
        h.update(np.ascontiguousarray(draws[k]).tobytes())
    return h.hexdigest()


def resume_counts_report(rm, dev, smi, ranks, tmp, state_path,
                         rc=(RC_BURN, RC_DRAWS, RC_EVERY, RC_CUT)):
    """Phase 50's parent side: the file cut on 2 item shards resumed here
    twice without a mesh (each its own copy), against the unsharded driver
    run by hand from the file's state and generator state; then every gate:
    the resumed draws begin with the file's, the resume is the hand-run
    driver bit for bit, two resumes agree, the ranks agree, the kernel ran
    on the item shards and without a mesh (a card's launches; the CPU runs
    the plain version) and not under the respondent axis, and each
    resume's posterior theta means reach r >= MESH_MIN_R with the
    uninterrupted 2-shard run's. Returns the numbers for the kernels line."""
    t = time.perf_counter()
    burn, n_draws, every, cut_at = rc
    ck = CheckpointManager(os.path.join(tmp, "rc_cut.npz")).load(device=dev)
    a1, l_a = resume_counts_run(dev, rm, state_path, rc, os.path.join(tmp, "rc_a1.npz"),
                                start=False)
    a2, _ = resume_counts_run(dev, rm, state_path, rc, os.path.join(tmp, "rc_a2.npz"),
                              start=False)
    y, cfg, _ = main_config(rm, dev, build=False)
    consts = GPIRTConstants(**torch.load(state_path, map_location=dev)["consts"])
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    gen.set_state(torch.from_numpy(ck.rng_state))
    fed = advance_chains(gen, Carry(ck.state), y, consts, cfg,
                         sample_schedule(n_draws, burn, 1), int(ck.meta["iteration"]),
                         burn + n_draws)
    kept = cut_at - burn
    card = dev.type == "cuda"
    for r in ranks:
        check(r["prefix_resp"], f"phase 50, rank {r['rank']}: the resume on 2 respondent "
              "shards does not begin with the file's draws")
        check(r["sha_resp"] == ranks[0]["sha_resp"], "phase 50: the ranks' resumes differ")
        check((r["launches"]["items2"] > 0) == card and r["launches"]["resp2_resumed"] == 0,
              f"phase 50, rank {r['rank']}: launches {r['launches']}")
    for k in ("theta", "beta", "threshold", "ll"):
        check(np.array_equal(a1[k][:, :kept], ck.draws[k]),
              f"phase 50: the resume without a mesh does not begin with the file's {k}")
        check(np.array_equal(a1[k][:, kept:], fed[k].cpu().numpy()),
              f"phase 50: the resume without a mesh is not the unsharded driver fed the "
              f"file's state and generator ({k})")
        check(np.array_equal(a1[k], a2[k]), f"phase 50: two resumes of one file differ ({k})")
    full = ranks[0]["means_full"]
    r_a = signed_r(run_means(torch.as_tensor(a1["theta"])), full)
    r_b = signed_r(ranks[0]["means_resp"], full)
    check(min(r_a, r_b) >= MESH_MIN_R, f"phase 50: r {r_a:.6f} (no mesh), {r_b:.6f} (2 "
          f"respondent shards) against the uninterrupted 2-shard run, gate {MESH_MIN_R}")
    check(l_a == (burn + n_draws - cut_at if card else 0),
          f"phase 50: {l_a} launches in the resume without a mesh")
    log(f"phase 50 on {smi}: phase 5's configuration continued from its last state on "
        f"{ITEM_SHARDS} item shards, burn {burn} and {n_draws} draws, a checkpoint every "
        f"{every} sweeps, interrupted after sweep {cut_at}; the resume without a mesh "
        f"begins with the file's {kept} draws, is bit for bit the unsharded driver fed "
        "the file's state and generator, and two resumes of the file agree; the resume "
        f"on {RESP_SHARDS} respondent shards begins with the file's draws, the same on "
        "both ranks; theta means r against the uninterrupted 2-shard run "
        f"{r_a:.6f} (no mesh), {r_b:.6f} (respondent shards); kernel launches by rank "
        + ", ".join(f"{r['launches']}" for r in ranks) + f", {l_a} in the resume without "
        f"a mesh; {time.perf_counter() - t:.2f} s here")
    return {"launches": [r["launches"] for r in ranks], "launches_resumed_alone": l_a,
            "r_no_mesh": r_a, "r_resp2": r_b}


def continuation(dev, rm, state_path, draws, mesh=None, item_axis=None):
    """The sign-aligned posterior theta means of ``draws`` sweeps of phase
    5's configuration continued from the state in ``state_path`` (with its
    constants), on ``mesh`` with the respondents (and ``item_axis``)
    sharded, or unsharded without one."""
    y, cfg, _ = main_config(rm, dev, build=False)
    saved = torch.load(state_path, map_location=dev)
    state = gibbs.GPIRTState(*saved["state"])
    consts = GPIRTConstants(**saved["consts"])
    K = state.theta_idx.shape[0]
    sharding = {}
    if mesh is not None:
        sharding = dict(mesh=mesh, item_axis=item_axis, respondent_axis="respondents")
        state = lane_state_block(state, mesh, item_axis, "respondents")
    thr = torch.as_tensor(default_thresholds(cfg.C, cfg.m, cfg.horizon), dtype=cfg.tdtype,
                          device=dev)  # unread: the run starts from ``state``
    out = run_chains(torch.Generator(device=dev).manual_seed(SEED + 1), y,
                     torch.zeros(K, cfg.horizon, cfg.n, device=dev), thr, consts, cfg,
                     sample_iterations=draws, burn_iterations=0, initial_states=state,
                     **sharding)
    return run_means(out["theta"])


def _fields_sha(out, fields=("beta", "threshold")):
    return hashlib.sha256(b"".join(np.ascontiguousarray(np.stack([d[k] for d in out]))
                                   .tobytes() for k in fields)).hexdigest()


def resp_mesh_report(rm, dev, smi, want_means, ranks, n_item, burn, draws, smc_steps,
                     label, rates, chains=K, state_path=None):
    """Phases 43 (2 respondent shards) and 45 (2 x 2 items x respondents):
    phase 5's call, gpirt_mcmc(mesh=make_respondent_mesh(2, n_item_shards=
    n_item), respondent_axis="respondents"), on its ranks of the card
    (``ranks``' results): no kernel launch (the cutpoint ESS's rounds end in
    an all_reduce), finite, theta and (bit for bit) beta and the cutpoints
    the same on every rank, its sign-aligned posterior theta means' r with
    phase 5's printed; the sharded sampler continued from the main path's
    last state (``state_path``) at r >= MESH_MIN_R with phase 5's means,
    the unsharded continuation's r beside (module docstring, phase 43).
    Prints the sweeps a second beside ``rates``, the cutpoint ESS rounds an
    update, each all_reduce site's calls, bytes and ms a sweep, timed in
    the run, and each rank's peak memory. Returns the numbers for the
    kernels line."""
    world = RESP_SHARDS * n_item
    for r in ranks:
        check(r["launches"] == 0, f"phase {label}, rank {r['rank']}: {r['launches']} kernel "
              "launches under a respondent axis")
        check(r["finite"], f"phase {label}, rank {r['rank']}: draws not finite")
        check(r["theta_sha"] == ranks[0]["theta_sha"],
              f"phase {label}: theta differs between ranks 0 and {r['rank']}")
        check(r["replicated_sha"] == ranks[0]["replicated_sha"],
              f"phase {label}: beta or the cutpoints differ between ranks 0 and {r['rank']}")
    r_means = signed_r(ranks[0]["means"], want_means)
    r_cont = signed_r(ranks[0]["continued_means"], want_means)
    r_plain = signed_r(continuation(dev, rm, state_path, CONT_DRAWS), want_means)
    check(np.isfinite(r_cont) and r_cont >= MESH_MIN_R,
          f"phase {label}: the sharded sampler continued from phase 5's last state, "
          f"posterior theta means at r {r_cont:.5f} with phase 5's")
    sec = ranks[0]["seconds"]
    rate = (burn + draws) / sec["sampling"]
    rounds = ranks[0]["ess_rounds"] / max(ranks[0]["ess_calls"], 1)
    sites = ranks[0]["sites"]
    ar_ms = sum(v[2] for v in sites.values())
    backend = backend_for(dev.type, world, torch.cuda.device_count() if dev.type == "cuda"
                          else 0)
    mesh = (f"{RESP_SHARDS} respondent shards" if n_item == 1
            else f"{n_item} x {RESP_SHARDS} items x respondents mesh")
    log(f"phase {label} on {smi}: {mesh}, {world} ranks on "
        f"{'the card' if dev.type == 'cuda' else 'the CPU'}, backend {backend}; burn {burn}, "
        f"{draws} draws; 0 kernel launches on every rank; theta, beta and the cutpoints the "
        f"same on every rank; posterior theta means r {r_means:.5f} with phase 5's (SMC's "
        f"basin is the random stream's); continued from phase 5's last state for {CONT_DRAWS} "
        f"draws, r {r_cont:.5f} (unsharded continuation {r_plain:.5f}); smc "
        f"{sec['smc']:.3f} s, sampling {sec['sampling']:.3f} s ({rate:.2f} sweeps/s; "
        + ", ".join(f"{k} {v:.2f}" for k, v in rates.items())
        + f"); the cutpoint ESS {rounds:.2f} rounds an update; all_reduce a sweep (rank 0, "
        f"timed in the run, SMC sweeps included) {ar_ms:.3f} ms: " + sites_line(sites)
        + "; peak memory by rank " + ", ".join(f"{r['peak_gib']:.3f}" for r in ranks)
        + " GiB (Gloo through the host, ranks sharing one card: not a multi-GPU number)")
    return {"launches": [r["launches"] for r in ranks], "sweeps_per_s": rate,
            "means": ranks[0]["means"],
            "smc_s": sec["smc"], "sampling_s": sec["sampling"], "ess_rounds": rounds,
            "allreduce_ms": ar_ms, "allreduce_sites": sites,
            "peak_gib": [r["peak_gib"] for r in ranks], "r_phase5": r_means,
            "r_continued": r_cont, "r_continued_unsharded": r_plain, "backend": backend}


def resp_synthetic_rank(device, size):
    """Phase 44 on one rank: phase 16's run (run_chains of the synthetic
    configuration at ``size``) with its respondents over RESP_SHARDS ranks,
    the constants built on rank 0 and broadcast (the host's eigensolver
    gives other bits at another thread count, and every shard must draw
    the same f*), its kernel launches and cutpoint ESS rounds counted, its
    all_reduces timed by site and the rank's peak memory read."""
    entered = time.time()
    dev = _rank_device(device)
    rank = dist.get_rank()
    y, ti, thr, consts, cfg = synthetic_inputs(dev, size["n"], size["m"], size["K"],
                                               build=rank == 0)
    consts = broadcast_constants(consts, dev, cfg.tdtype)
    mesh = make_respondent_mesh(RESP_SHARDS, device=dev.type)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    threshold_ess.binary_threshold_ess.launches = 0
    ess_update.calls = ess_update.rounds = 0
    sites = SiteAllReduce(dev)
    gibbs.dist = sites
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t = time.perf_counter()
    try:
        out = run_chains(gen, y, ti, thr, consts, cfg, sample_iterations=size["draws"],
                         burn_iterations=size["burn"], mesh=mesh,
                         respondent_axis="respondents")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    finally:
        gibbs.dist = dist
    wall = time.perf_counter() - t
    sweeps = size["burn"] + size["draws"]
    return {"rank": rank, "launches": threshold_ess.binary_threshold_ess.launches,
            "ess_rounds": ess_update.rounds, "ess_calls": ess_update.calls, "wall": wall,
            "peak_gib": _peak_gib(dev), "means": run_means(out["theta"]),
            "theta_sha": hashlib.sha256(out["theta"].cpu().numpy().tobytes()).hexdigest(),
            "replicated_sha": hashlib.sha256(
                torch.cat([out["beta"].flatten(), out["threshold"].flatten()]).cpu().numpy()
                .tobytes()).hexdigest(),
            "finite": bool(torch.isfinite(out["ll"]).all() and torch.isfinite(out["theta"]).all()),
            "sites": sites.summary(sweeps), "stamps": (entered, time.time())}


def resp_synthetic_report(dev, smi, ranks, syn16, size):
    """Phase 44: phase 16's synthetic run on RESP_SHARDS respondent shards
    of the card (``ranks``' results): no kernel launch, finite, theta,
    beta and the cutpoints the same on every rank, and its sign-aligned
    posterior theta means at r >= SYN_MIN_R with phase 16's (``syn16``).
    Prints each rank's peak device memory beside phase 16's, the sweeps a
    second beside phase 16's, the cutpoint ESS rounds an update and the
    all_reduce sites. Returns the numbers for the kernels line."""
    for r in ranks:
        check(r["launches"] == 0, f"phase 44, rank {r['rank']}: {r['launches']} kernel "
              "launches under a respondent axis")
        check(r["finite"], f"phase 44, rank {r['rank']}: draws not finite")
        for k in ("theta_sha", "replicated_sha"):
            check(r[k] == ranks[0][k], f"phase 44: ranks 0 and {r['rank']} return other draws")
    r_means = signed_r(ranks[0]["means"], syn16["means"])
    check(np.isfinite(r_means) and r_means >= SYN_MIN_R,
          f"phase 44: posterior theta means at r {r_means:.5f} with phase 16's")
    sweeps = size["burn"] + size["draws"]
    rate = sweeps / max(r["wall"] for r in ranks)
    rounds = ranks[0]["ess_rounds"] / max(ranks[0]["ess_calls"], 1)
    sites = ranks[0]["sites"]
    log(f"phase 44 on {smi}: the synthetic configuration ({size['n']} x {size['m']}, "
        f"{size['K']} chains, burn {size['burn']}, {size['draws']} draws) on {RESP_SHARDS} "
        f"respondent shards of the card, {size['n'] // RESP_SHARDS} respondents a rank: 0 "
        f"kernel launches; theta, beta and the cutpoints the same on every rank; posterior "
        f"theta means r {r_means:.5f} with phase 16's (gate {SYN_MIN_R}); {rate:.3f} sweeps/s "
        f"(phase 16 {syn16['sweeps_per_s']:.3f}); peak device memory by rank "
        + ", ".join(f"{r['peak_gib']:.3f}" for r in ranks)
        + f" GiB (phase 16, one process: {syn16['peak_gib']:.3f} GiB); the cutpoint ESS "
        f"{rounds:.2f} rounds an update; all_reduce a sweep (rank 0, timed in the run) "
        f"{sum(v[2] for v in sites.values()):.3f} ms: " + sites_line(sites))
    return {"launches": [r["launches"] for r in ranks], "sweeps_per_s": rate,
            "peak_gib": [r["peak_gib"] for r in ranks], "r_phase16": r_means,
            "ess_rounds": rounds, "allreduce_sites": sites}


# ---------------------------------------------------------------------------
# phases 46-49: ESS theta and the affine moves on item shards, tempering on a
# chain mesh and on items x respondents, the campaigns on a campaign mesh
# ---------------------------------------------------------------------------


def item_option_configs(cfg, shift_max):
    """Phase 46's two sweeps: the main path's configuration with theta by
    ESS, and with the affine moves at W = ``shift_max`` (phase 29's) and
    AFFINE_ROUNDS rounds."""
    return {"theta_ess": dataclasses.replace(cfg, theta_method="ess"),
            "affine": dataclasses.replace(cfg, affine_shift_max=shift_max,
                                          affine_rounds=AFFINE_ROUNDS)}


def item_option_rank(device, rm, state_path, out_dir, shift_max, chains, burn, draws,
                     shards=ITEM_SHARDS):
    """Phase 46 on one rank: one sweep of the main path's state on this
    rank's item block (the parent's constants, both in ``state_path``),
    fed the unsharded sweep's draws cut to it, with theta by ESS and with
    the affine moves, the results saved in ``out_dir``; on a card the
    kernel against its plain version on this rank's lanes of the ESS theta
    sweep (rank 0 times it and gives its bound while the other waits); then
    phase 27's gpirt_mcmc(theta_method="ess") from the spread init at ``burn``
    and ``draws`` on the item shards, its launches counted from 0."""
    entered = time.time()
    dev = _rank_device(device)
    rank = dist.get_rank()
    y, cfg, _ = main_config(rm, dev, build=False)
    saved = torch.load(state_path, map_location=dev)
    state = gibbs.GPIRTState(*saved["state"])
    consts = GPIRTConstants(**saved["consts"])
    mesh = make_item_mesh(shards, device=dev.type)
    sh = shards_of(mesh, "items")
    block = lane_state_block(state, sh, "items")
    res = {"rank": rank, "worst": 0.0, "flipped": 0}
    for label, c in item_option_configs(cfg, shift_max).items():
        draws_all = gibbs.sweep_draws(torch.Generator(device=dev).manual_seed(SEED),
                                      state.theta_idx.shape[0], consts, c)
        y_b, _, cb, cl = item_inputs(y, state.thresholds[0], consts, c, sh)
        (got, ll), args = observe_kernel(lambda: gibbs.gibbs_sweep(
            block, draws_item_block(draws_all, sh.items(c.m)), y_b, cb, cl, None, 0,
            sh.item_group))
        torch.save([a.cpu() for a in got] + [ll.cpu()],
                   os.path.join(out_dir, f"items_{label}_rank{rank}.pt"))
        if label == "theta_ess":
            res["lanes"] = args[2].numel()
            if dev.type == "cuda":
                res["worst"], res["flipped"] = kernel_check(args, f"rank {rank}'s ESS theta "
                                                            "sweep state")
                _barrier()
                if rank == 0:
                    res["ms"], res["ms_eager"], res["plain_ms"] = kernel_times(args, _C)
                    res["work"] = kernel_bound(args, _C, "rank 0's ESS theta state")
                _barrier()
    threshold_ess.binary_threshold_ess.launches = 0
    ess_update.calls = ess_update.rounds = 0
    collectives = TimedAllReduce(dev)
    gibbs.dist = collectives
    try:
        out = gpirt_mcmc(rm, draws, burn, CHAIN=chains, SEED=SEED, theta_method="ess",
                         theta_init=spread_init(np.asarray(rm).shape[0]), dtype="float32",
                         device=dev, verbose=False, mesh=mesh, item_axis="items")
    finally:
        gibbs.dist = dist
    res.update({"allreduce_ms": collectives.total_ms() / (burn + draws),
                "allreduce_bytes": collectives.bytes,
                "launches": threshold_ess.binary_threshold_ess.launches,
                "ess_rounds": ess_update.rounds, "ess_calls": ess_update.calls,
                "theta_sha": _theta_sha(out), "seconds": out[0]["seconds"],
                "finite": bool(all(np.isfinite(d["ll"]).all() for d in out)),
                "stamps": (entered, time.time())})
    return res


def item_option_inputs(rm, dev, state):
    """Phase 46's parent side before its ranks: the unsharded sweeps of
    ``state`` on ``dev`` from the seeded draws, with theta by ESS and with
    the affine moves. Returns {label: what the check needs}."""
    y, cfg, consts = main_config(rm, dev)
    out = {}
    for label, c in item_option_configs(cfg, AFFINE_W).items():
        draws = gibbs.sweep_draws(torch.Generator(device=dev).manual_seed(SEED),
                                  state.theta_idx.shape[0], consts, c)
        want, want_ll = gibbs.gibbs_sweep(state, draws, y, consts, c)
        out[label] = (want, want_ll, state, draws, y, consts, c)
    return out


def item_option_check(smi, ranks, tmp, inputs, burn, draws, shards=ITEM_SHARDS):
    """Phase 46: each item-sharded sweep on ``shards`` ranks of the card
    (``ranks``' results, their blocks in ``tmp``) against the unsharded
    sweep on the card from the main path's last state and the same draws:
    theta the same on every item shard, equal to the unsharded sweep's in
    at least THETA_EQUAL_MIN chains under the tie rule (the affine sweep's
    item sums are float64 across the shards, so the float64 run decides
    there), the other fields within 1e-3 (:func:`sweep_agreement`); each
    rank's kernel against its plain version on its lanes (at most 0.1% of
    them over 1e-5); then the ESS theta call on the item shards: one launch
    a sweep on each rank, theta the same on both. Returns the numbers for
    the kernels line."""
    out = {}
    for label, (want, want_ll, state, draws_all, y, consts, cfg) in inputs.items():
        blocks = [torch.load(os.path.join(tmp, f"items_{label}_rank{r}.pt"))
                  for r in range(shards)]
        check(all(torch.equal(b[0], blocks[0][0]) for b in blocks),
              f"phase 46 ({label}): theta differs between the item shards")
        cat = [torch.cat([b[i] for b in blocks], dim=d) for i, d in ((1, -1), (2, -1),
                                                                     (3, -2), (4, -1))]
        got = gibbs.GPIRTState(blocks[0][0], *cat)
        same, errs = sweep_agreement(f"{shards} item shards against the unsharded sweep, "
                                     f"{label}", got, want, state, draws_all, y, consts, cfg,
                                     float64_decides=label == "affine")
        check(errs["chains_theta_equal"] >= THETA_EQUAL_MIN,
              f"phase 46 ({label}): theta equal in {errs['chains_theta_equal']} chains")
        ll_rel = float(((blocks[0][5] - want_ll.cpu()).abs() / want_ll.cpu().abs()).max())
        log(f"phase 46 ({label}) on {smi}: {shards} ranks sharing the card over Gloo, the "
            f"main path's state, {cfg.m // shards} items a rank: bit for bit the unsharded "
            f"sweep {same}; theta the same on every shard, equal in "
            f"{errs['chains_theta_equal']} of {got.theta_idx.shape[0]} chains; max abs diff "
            + ", ".join(f"{k} {errs[k]:.3g}" for k in ("f", "beta", "thresholds", "fstar"))
            + f"; ll relative {ll_rel:.3g}")
        out[label] = errs
    lanes = ranks[0]["lanes"]
    worst = max(r["worst"] for r in ranks)
    flipped = sum(r["flipped"] for r in ranks)
    check(flipped <= 0.001 * lanes * shards,
          f"phase 46: {flipped} of {lanes * shards} lanes over 1e-5")
    on_card = any("ms" in r for r in ranks)
    sweeps = burn + draws
    for r in ranks:
        check(r["launches"] == (sweeps if on_card else 0),
              f"phase 46, rank {r['rank']}: {r['launches']} kernel launches for {sweeps} "
              "sweeps")
        check(r["finite"], f"phase 46, rank {r['rank']}: ll not finite")
        check(r["theta_sha"] == ranks[0]["theta_sha"],
              f"phase 46: theta differs between ranks 0 and {r['rank']}")
    sec = ranks[0]["seconds"]
    rate = sweeps / sec["sampling"]
    rounds = ranks[0]["ess_rounds"] / max(ranks[0]["ess_calls"], 1)
    r0 = next((r for r in ranks if "ms" in r), None)
    timing = "" if r0 is None else (
        f"; the kernel at rank 0's ESS theta state {r0['ms']:.5f} ms (graph), "
        f"{r0['ms_eager']:.5f} ms (eager), plain {r0['plain_ms']:.4f} ms, bound "
        f"{r0['work']['bound_ms']:.5f} ms by {r0['work']['bound_by']}")
    log(f"phase 46 on {smi}: the kernel on each rank's {lanes} lanes: {flipped} over 1e-5, "
        f"the rest within {worst:.3g}{timing}; gpirt_mcmc(theta_method='ess') (no SMC) "
        f"on {shards} item shards, burn {burn}, {draws} draws: {ranks[0]['launches']} "
        f"launches = {sweeps} sweeps a rank, theta the same on both, {rate:.2f} sweeps/s, "
        f"the ESS loops {rounds:.2f} rounds an update, the theta table's all_reduce "
        f"{ranks[0]['allreduce_bytes']} bytes, {ranks[0]['allreduce_ms']:.3f} ms a sweep "
        "(rank 0, timed in the run)")
    res = {"sweeps": out, "launches": [r["launches"] for r in ranks], "lanes": lanes,
           "worst": worst, "flipped": flipped, "sweeps_per_s": rate, "ess_rounds": rounds,
           "allreduce_ms": ranks[0]["allreduce_ms"]}
    if r0 is not None:
        res.update({k: r0[k] for k in ("ms", "ms_eager", "plain_ms")})
        res.update({"bound_ms": r0["work"]["bound_ms"], "bound_by": r0["work"]["bound_by"]})
    return res


def chain_tempering_rank(device, rm, chains, burn, draws):
    """Phase 47 on one rank: phase 19's call on a chain mesh over the world,
    its launches counted from 0; on a card the kernel against its plain
    version at this rank's last state (rank 0 times it and gives its
    bound while the other waits)."""
    entered = time.time()
    dev = _rank_device(device)
    rank = dist.get_rank()
    mesh = make_chain_mesh(device=dev.type)
    threshold_ess.binary_threshold_ess.launches = 0
    scales = []
    out, args = observe_kernel(lambda: tempering_call(rm, dev, chains, burn, draws,
                                                      mesh=mesh), scales=scales)
    res = {"rank": rank, "sha": draws_sha256(out), "seconds": out[0]["seconds"],
           "launches": threshold_ess.binary_threshold_ess.launches,
           "swap_rate": out[0]["swap_rate"], "lanes": args[2].numel(), "worst": 0.0,
           "flipped": 0}
    if dev.type == "cuda":
        res["worst"], res["flipped"] = kernel_check(args, f"rank {rank}'s tempering state",
                                                    c=scales[-1])
        _barrier()
        if rank == 0:
            res["ms"], res["ms_eager"], res["plain_ms"] = kernel_times(args, scales[-1])
            res["work"] = kernel_bound(args, scales[-1], "rank 0's tempering state")
        _barrier()
    res["stamps"] = (entered, time.time())
    return res


def chain_tempering_check(smi, ranks, want, burn, draws, world=ITEM_SHARDS):
    """Phase 47: phase 19's call on a ``world``-rank chain mesh (``ranks``'
    results): its cold draws and swap rates hash to phase 19's (``want``)
    on every rank, one kernel launch a sweep on each, the kernel against
    its plain version at each rank's state. Returns the numbers for the
    kernels line."""
    sweeps = burn + draws
    on_card = any("ms" in r for r in ranks)
    for r in ranks:
        check(r["sha"] == want, f"phase 47, rank {r['rank']}: sha256 {r['sha']}, phase 19's "
              f"{want}")
        check(r["launches"] == (sweeps if on_card else 0),
              f"phase 47, rank {r['rank']}: {r['launches']} kernel launches for {sweeps} "
              "sweeps")
    lanes = ranks[0]["lanes"]
    flipped = sum(r["flipped"] for r in ranks)
    worst = max(r["worst"] for r in ranks)
    check(flipped <= 0.001 * lanes * world,
          f"phase 47: {flipped} of {lanes * world} lanes over 1e-5")
    sec = ranks[0]["seconds"]
    rate = sweeps / sec["sampling"]
    r0 = next((r for r in ranks if "ms" in r), None)
    timing = "" if r0 is None else (
        f"; the kernel at rank 0's state {r0['ms']:.5f} ms (graph), {r0['ms_eager']:.5f} ms "
        f"(eager), plain {r0['plain_ms']:.4f} ms, bound {r0['work']['bound_ms']:.5f} ms by "
        f"{r0['work']['bound_by']}")
    log(f"phase 47 on {smi}: phase 19's tempering on a chain mesh of {world} ranks, "
        f"{K * PT_TEMPS // world} lanes a rank: cold draws and swap rates sha256 = phase "
        f"19's on every rank (swap rates " + ", ".join(f"{v:.4f}" for v in
                                                       ranks[0]["swap_rate"])
        + f"); {ranks[0]['launches']} kernel launches a rank = {sweeps} sweeps; "
        f"{rate:.2f} sweeps/s; the kernel on each rank's {lanes} lanes: {flipped} over 1e-5, "
        f"the rest within {worst:.3g}{timing}")
    res = {"launches": [r["launches"] for r in ranks], "sweeps_per_s": rate,
           "lanes": lanes, "worst": worst, "flipped": flipped}
    if r0 is not None:
        res.update({k: r0[k] for k in ("ms", "ms_eager", "plain_ms")})
        res.update({"bound_ms": r0["work"]["bound_ms"], "bound_by": r0["work"]["bound_by"]})
    return res


# every field of a gpirt_campaigns result but its walls and schedule
CAMPAIGN_FIELDS = ("theta_mean", "theta_se", "campaign_means", "ess_campaign",
                   "pooled_ess_per_campaign", "final_weight_ess", "n_resamples")


def campaign_blocks_reference(rm, dev, world=ITEM_SHARDS, **schedule):
    """Phase 48's reference, in this one process: phase 20's campaigns8
    call with each place of a ``world``-rank campaign axis run in turn as
    its rank runs it (its CAMPAIGNS / world campaigns' anneal and its block
    of the sampling run's lanes, at the rank's batch: ``Shards`` without a
    process group), their info rows and draws joined in campaign order,
    and gpirt_campaigns' estimator on them. Only the collectives are left
    out, so the mesh must equal it bit for bit in every field. Returns
    its result."""
    prob = campaigns._problem(np.asarray(rm), CAMPAIGNS, SEED=CAMPAIGN_SEED, vote_codes=None,
                              device=dev, **schedule)
    t0 = time.perf_counter()
    blocks = [campaigns._campaign_draws(prob, Shards(world, r)) for r in range(world)]
    info = {k: np.concatenate([b[0][k] for b in blocks]) for k in blocks[0][0]}
    draws = {k: torch.cat([b[1][k] for b in blocks]) for k in blocks[0][1]}
    walls = {k: sum(b[2][k] for b in blocks) for k in blocks[0][2]}
    out = campaigns._campaign_result(prob, info, draws, walls, t0, store_draws=False)
    log(f"phase 48's reference on one process: {world} campaign-axis places in turn, "
        f"{CAMPAIGNS // world} campaigns and {CAMPAIGNS // world * out['schedule']['n_chains']} "
        f"lanes each, {out['walls']['total_sec']:.3f} s")
    return out


# One conjugate sweep (one latent pass, no affine moves or shift), block by
# block as gibbs_sweep runs it, and SMC's reweight ll of its result: each
# block a function of the environment of the blocks before it.
SWEEP_BLOCKS = (
    ("mu_star", lambda e: gibbs.compute_mu_star(e["consts"], e["state"].beta)),
    ("theta", lambda e: gibbs.draw_theta(e["state"], e["mu_star"], e["y"], e["consts"],
                                         e["cfg"], e["draws"].u_theta, e["temp"])),
    ("f_at_theta", lambda e: gibbs._rows(e["state"].fstar, e["theta"])),
    ("mu", lambda e: gibbs.compute_mu(gibbs.theta_from_indices(e["theta"], e["consts"]),
                                      e["state"].beta)),
    ("z", lambda e: gibbs.draw_z_truncnorm(e["f_at_theta"] + e["mu"], e["y"],
                                           e["state"].thresholds, e["draws"].u_z,
                                           e["temp"])),
    ("fstar", lambda e: gibbs.draw_fstar_conjugate(
        e["state"]._replace(theta_idx=e["theta"], f=e["f_at_theta"]), e["z"] - e["mu"],
        e["cfg"], e["consts"], e["draws"].z_q, e["draws"].z_p, e["draws"].z_n,
        e["draws"].eps_f, e["temp"])),
    ("beta", lambda e: gibbs.draw_beta_conjugate(
        gibbs.theta_from_indices(e["theta"], e["consts"]), e["z"] - e["fstar"][1],
        e["consts"], e["cfg"], e["draws"].zeta, e["temp"])),
    ("mu_beta", lambda e: gibbs.compute_mu(gibbs.theta_from_indices(e["theta"], e["consts"]),
                                           e["beta"])),
    ("cutpoints", lambda e: gibbs._draw_cutpoints(e["state"].thresholds, e["fstar"][1],
                                                  e["mu_beta"], e["y"], e["cfg"],
                                                  e["draws"].cut, e["temp"])),
    ("ll", lambda e: ordinal_ll_terms(
        e["fstar"][1] + e["mu_beta"], e["y"], e["cutpoints"],
        gibbs._per_chain(gibbs._temp_scales(e["temp"])[1], 4)).sum(dim=(-3, -2, -1))),
    ("smc_ll", lambda e: smc._lane_ll(gibbs.GPIRTState(
        e["theta"], e["fstar"][1], e["beta"], e["cutpoints"], e["fstar"][0]),
        1.0 if e["temp"] is None else e["temp"], e["y"], e["consts"])),
)


def _lanes_cut(v, lanes, L):
    """``v`` of a sweep's environment cut to the lanes ``lanes`` of ``L``:
    a state or a tensor with L leading rows, a draws tuple along its lane
    axes (``lane_block``); anything else as it is."""
    if isinstance(v, gibbs.GPIRTState):
        return gibbs.GPIRTState(*(_lanes_cut(a, lanes, L) for a in v))
    if isinstance(v, tuple) and not hasattr(v, "_fields"):
        return tuple(_lanes_cut(a, lanes, L) for a in v)
    if isinstance(v, tuple):
        return lane_block(v, lanes)
    if torch.is_tensor(v) and v.ndim and v.shape[0] == L:
        return v[lanes]
    return v


def _outputs_apart(got, want):
    """The largest absolute difference of two block outputs (a tensor or a
    tuple of them), 0.0 when every element is equal bit for bit (NaNs
    equal where both are NaN)."""
    if isinstance(want, tuple):
        return max(_outputs_apart(g, w) for g, w in zip(got, want))
    if torch.equal(got, want):
        return 0.0
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    d = torch.where(same, 0.0, (got.double() - want.double()).abs())
    return float(torch.nan_to_num(d, nan=float("inf")).max())


def sweep_blocks(state, draws, y, consts, cfg, temp=None, lanes=None, whole=None):
    """The environment of :data:`SWEEP_BLOCKS` run on ``state``: each
    block's output by name. With ``lanes`` (a slice) and ``whole`` (the
    environment of all L lanes) every block reads ``whole``'s inputs cut to
    those lanes instead of its own blocks' outputs, so that each block is
    compared on the same inputs."""
    env = dict(state=state, draws=draws, y=y, consts=consts, cfg=cfg, temp=temp)
    if whole is not None:
        L = state.theta_idx.shape[0]
        env = {k: _lanes_cut(v, lanes, L) for k, v in whole.items()}
    for name, fn in SWEEP_BLOCKS:
        got = fn(env)
        if whole is None:
            env[name] = got
        else:
            env.setdefault("_out", {})[name] = got
    return env


def sweep_block_check(prob, lanes, chunk, burn=3):
    """Phase 51's check: one conjugate sweep of campaigns8's problem
    ``prob`` (``campaigns._problem``) on ``lanes`` lanes after ``burn``
    sweeps from the prior, plain, at one temperature and at one a lane
    (with ``prob``'s cutpoint update), and plain with the binary cutpoint
    ESS (the kernel's update), block by block on all lanes and on batches of ``chunk`` lanes fed the
    same inputs (:func:`sweep_blocks`), and the whole sweep on each batch
    fed its lanes of the numbers. Returns {label: {block: the largest
    difference from the whole call's lanes, 0.0 bit for bit}}."""
    y, consts, cfg = prob.y, prob.consts, prob.config
    dev = y.device
    gen = torch.Generator(device=dev).manual_seed(prob.seed)
    th = prob.theta_init.repeat(lanes // prob.theta_init.shape[0], 1, 1)
    state = gibbs.init_state(th, prob.thresholds, consts, cfg,
                             gibbs.init_draws(gen, lanes, consts, cfg))
    for it in range(burn):
        state, _ = gibbs.gibbs_sweep(state, gibbs.sweep_draws(gen, lanes, consts, cfg, it),
                                     y, consts, cfg)
    ladder_l = ladder(PT_TEMPS, PT_MAX_TEMP, dev).to(cfg.tdtype).repeat(lanes // PT_TEMPS)
    ess = dataclasses.replace(cfg, threshold_method="ess")  # the kernel's cutpoint update
    out = {}
    for label, cfg, temp in (("T=1", cfg, None), ("T=4", cfg, 4.0),
                             ("T a lane", cfg, ladder_l), ("T=1, ESS cutpoints", ess, None)):
        draws = gibbs.sweep_draws(gen, lanes, consts, cfg, burn)
        whole = sweep_blocks(state, draws, y, consts, cfg, temp)
        apart = {name: 0.0 for name, _ in SWEEP_BLOCKS}
        apart["sweep"] = 0.0
        sw_state, sw_ll = gibbs.gibbs_sweep(state, draws, y, consts, cfg, temp, burn)
        for lo in range(0, lanes, chunk):
            sl = slice(lo, lo + chunk)
            part = sweep_blocks(state, draws, y, consts, cfg, temp, sl, whole)["_out"]
            for name, _ in SWEEP_BLOCKS:
                apart[name] = max(apart[name],
                                  _outputs_apart(part[name], _lanes_cut(whole[name], sl,
                                                                        lanes)))
            st, ll = gibbs.gibbs_sweep(_lanes_cut(state, sl, lanes), lane_block(draws, sl),
                                       y, consts, cfg, _lanes_cut(temp, sl, lanes), burn)
            apart["sweep"] = max(apart["sweep"], _outputs_apart(
                tuple(st) + (ll,), tuple(_lanes_cut(sw_state, sl, lanes)) + (sw_ll[sl],)))
        out[label] = apart
    return out


# The sweep families beyond the conjugate sweep of campaigns8, each at its
# cell's data and options (phases 8, 10, 13, 24, 27, 28 and 29): the cases
# phase 51 checks, each (label, GPIRTConfig fields over the family's, one
# temperature a lane or none, the checked sweep's index).
FAMILY_CASES = {
    "sdo": (("ESS cutpoints", {}, False, 0), ("ESS cutpoints, T a lane", {}, True, 0),
            ("Newton", {"threshold_method": "newton"}, False, 0),
            ("Newton, T a lane", {"threshold_method": "newton"}, True, 0)),
    "dynamic": (("GP theta", {}, False, 0), ("GP theta, T a lane", {}, True, 0)),
    "two_stage": (("f* by Matheron", {}, False, 0),
                  ("f* by Cholesky", {"fstar_method": "chol", "jitter": CHOL_JITTER}, False, 0)),
    "shared_irf": (("grid", {}, False, 0), ("conjugate", {"f_method": "conjugate"}, False, 0),
                   ("conjugate, T a lane", {"f_method": "conjugate"}, True, 0)),
    "theta_ess": (("ESS theta", {}, False, 0),),
    "interleave": (("collapsed sweep", {}, False, 1),
                   ("collapsed sweep, T a lane", {}, True, 1), ("ESS sweep", {}, False, 4)),
    "affine": (("W 16, 2 rounds", {}, False, 0), ("W 16, 2 rounds, T a lane", {}, True, 0)),
}
FAMILIES = tuple(FAMILY_CASES)
# a campaign's lanes, against a 2- and a 4-rank chain mesh's of 64 chains
FAMILY_LANES, FAMILY_CHUNKS = 2 * K, (K, K // 2, K // 4)


def family_call(name, rm):
    """(data, gpirt_mcmc keyword arguments, further GPIRTConfig fields) of
    family ``name``'s cell; ``rm`` is senate116's response matrix."""
    if name == "sdo":
        return load_sdo(), dict(vote_codes=None), {}
    if name in ("dynamic", "shared_irf"):
        _, raw, init = dynamic_inputs()
        kw = dict(vote_codes=DYN_VOTES, theta_ls=DYN_LS, theta_init=init)
        return raw, dict(kw, constant_IRF=1) if name == "shared_irf" else kw, {}
    spread = dict(theta_init=spread_init(np.asarray(rm).shape[0]))
    if name == "two_stage":
        return rm, dict(f_method="two_stage", **spread), {}
    if name == "theta_ess":
        return rm, dict(theta_method="ess", **spread), {}
    if name == "interleave":
        return rm, dict(threshold_method="interleave", threshold_ess_every=4,
                        mix_subsweeps=2), {}
    if name == "affine":  # GPIRTConfig fields only, as in JAX: run through run_chains
        return rm, spread, dict(affine_shift_max=16, affine_rounds=2)
    raise ValueError(f"unknown family {name!r}")


def family_inputs(call, dev):
    """(y on ``dev``, config, theta init (H, n), thresholds init) of a
    family's cell (``call``, :func:`family_call`'s), built as gpirt_mcmc
    builds them at its default priors."""
    data, kw, fields = call
    codes = kw.get("vote_codes", api.DEFAULT_VOTE_CODES)
    if codes is not None:
        data = api._strip_h(data)
        data = (recode_cube(data, codes, verbose=False) if np.asarray(data).ndim == 3
                else as_response_matrix(data, codes, verbose=False))
    y, C, _ = encode_categories(api._as_cube(data))
    H, n, m = y.shape
    names = {f.name for f in dataclasses.fields(GPIRTConfig)}
    opts = {k: bool(v) if k == "constant_IRF" else v for k, v in kw.items() if k in names}
    cfg = GPIRTConfig(n=n, m=m, horizon=H, C=C, dtype="float32", jitter=1e-5, **opts,
                      **fields)
    init = np.zeros(n) if "theta_init" not in kw else np.asarray(kw["theta_init"])
    th = torch.as_tensor(np.broadcast_to(init, (H, n)).copy(), dtype=torch.float32,
                         device=dev)
    thr = torch.as_tensor(np.ascontiguousarray(default_thresholds(C, m, H)),
                          dtype=torch.float32, device=dev)
    return (torch.as_tensor(np.ascontiguousarray(y), dtype=torch.int32, device=dev), cfg,
            th, thr)


_FAMILY_CONSTS = {}


def family_consts(cfg, dev):
    """The constants of ``cfg`` at gpirt_mcmc's default priors, built once
    for the fields make_constants reads (a case's sampler options share its
    family's)."""
    key = (cfg.n, cfg.m, cfg.horizon, cfg.grid_size, cfg.jitter, cfg.dtype, cfg.theta_os,
           cfg.theta_ls, cfg.kernel, str(dev))
    if key not in _FAMILY_CONSTS:
        m, n = cfg.m, cfg.n
        _FAMILY_CONSTS[key] = make_constants(cfg, np.zeros((3, m)), np.full((3, m), 3.0),
                                             np.zeros((2, n)), np.zeros((2, n)), device=dev)
    return _FAMILY_CONSTS[key]


class SweepBlocks:
    """Records the blocks of the sweeps run inside it: each call of a
    block function that ``gibbs_sweep`` (or the grid and two-stage sweeps)
    makes, not those the blocks make, as (name, function, args, kwargs,
    output), a repeated name numbered by its pass."""

    NAMES = ("compute_mu_star", "draw_theta", "compute_mu", "draw_z_truncnorm",
             "draw_fstar_conjugate", "draw_beta_conjugate", "draw_threshold_collapsed",
             "_draw_cutpoints", "_shift", "ordinal_ll_terms", "draw_f", "draw_fstar",
             "draw_fstar_direct", "draw_beta")

    def __init__(self):
        self.calls, self.depth, self.saved = [], 0, []

    def _wrap(self, name, fn):
        def block(*args, **kwargs):
            self.depth += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                self.depth -= 1
            if not self.depth:
                seen = sum(c[0].split(" ")[0] == name for c in self.calls)
                self.calls.append((name if not seen else f"{name} {seen + 1}", fn, args,
                                   kwargs, out))
            return out
        return block

    def __enter__(self):
        targets = [(gibbs, n) for n in self.NAMES] + [(affine, "affine_theta_moves")]
        for mod, name in targets:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))
            setattr(mod, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        self.saved = []


def family_block_check(name, rm, dev, lanes=FAMILY_LANES, chunks=FAMILY_CHUNKS, burn=3,
                       mode=None):
    """Phase 51's check of family ``name`` (:data:`FAMILY_CASES`): for each
    case, one sweep of its cell on ``lanes`` chains after ``burn`` sweeps
    from the prior, and the same lanes in batches of each of ``chunks``:
    every block the sweep runs (:class:`SweepBlocks`), fed the whole
    sweep's inputs cut to the batch's lanes, and the whole sweep on each
    batch fed its lanes of the numbers. ``mode``, a context, is entered
    around the whole-lanes sweep. Returns {"case, batches of c": {block:
    the largest difference from the whole call's lanes, 0.0 bit for
    bit}}."""
    y, base, th, thr = family_inputs(family_call(name, rm), dev)
    out = {}
    for label, fields, lane_temp, it in FAMILY_CASES[name]:
        cfg = dataclasses.replace(base, **fields)
        consts = family_consts(cfg, dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        state = gibbs.init_state(th.expand(lanes, *th.shape), thr, consts, cfg,
                                 gibbs.init_draws(gen, lanes, consts, cfg))
        for i in range(burn):
            state, _ = gibbs.gibbs_sweep(state, gibbs.sweep_draws(gen, lanes, consts, cfg, i),
                                         y, consts, cfg, iteration=i)
        temp = (ladder(PT_TEMPS, PT_MAX_TEMP, dev).repeat(lanes // PT_TEMPS)
                if lane_temp else None)
        draws = gibbs.sweep_draws(gen, lanes, consts, cfg, it)
        with SweepBlocks() as rec, mode or contextlib.nullcontext():
            sw_state, sw_ll = gibbs.gibbs_sweep(state, draws, y, consts, cfg, temp, it)
        for chunk in chunks:
            apart = {key: 0.0 for key, *_ in rec.calls}
            apart["sweep"] = 0.0
            for lo in range(0, lanes, chunk):
                sl = slice(lo, lo + chunk)
                for key, fn, args, kwargs, got in rec.calls:
                    part = fn(*(_lanes_cut(a, sl, lanes) for a in args),
                              **{k: _lanes_cut(v, sl, lanes) for k, v in kwargs.items()})
                    apart[key] = max(apart[key],
                                     _outputs_apart(part, _lanes_cut(got, sl, lanes)))
                st, ll = gibbs.gibbs_sweep(_lanes_cut(state, sl, lanes),
                                           lane_block(draws, sl, cfg.mix_subsweeps), y,
                                           consts, cfg, _lanes_cut(temp, sl, lanes), it)
                apart["sweep"] = max(apart["sweep"], _outputs_apart(
                    tuple(st) + (ll,), tuple(_lanes_cut(sw_state, sl, lanes)) + (sw_ll[sl],)))
            out[f"{label}, batches of {chunk}"] = apart
    return out


def campaign_mesh_rank(device, rm, schedule):
    """Phase 48 on one rank: phase 20's campaigns8 call on a campaign mesh
    over the world, its launches counted from 0."""
    entered = time.time()
    dev = _rank_device(device)
    mesh = make_campaign_mesh(device=dev.type)
    threshold_ess.binary_threshold_ess.launches = 0
    out = gpirt_campaigns(np.asarray(rm), SEED=CAMPAIGN_SEED, n_campaigns=CAMPAIGNS,
                          vote_codes=None, store_draws=False, verbose=False, device=dev,
                          mesh=mesh, **schedule)
    res = {k: np.asarray(out[k]) for k in CAMPAIGN_FIELDS}
    res.update({"rank": dist.get_rank(), "walls": out["walls"],
                "launches": threshold_ess.binary_threshold_ess.launches,
                "stamps": (entered, time.time())})
    return res


def _campaign_differences(got, other):
    """The fields of two campaigns8 results that differ, and a line on how:
    the campaigns whose means agree, each campaign's largest difference,
    the final weight ESS and the resample counts."""
    differ = [k for k in CAMPAIGN_FIELDS if not np.array_equal(got[k], np.asarray(other[k]))]
    cm = np.asarray(other["campaign_means"])
    line = (f"{differ} differ; campaign means equal in campaigns "
            f"{[i for i in range(CAMPAIGNS) if np.array_equal(got['campaign_means'][i], cm[i])]}"
            f", largest difference a campaign "
            f"{np.abs(got['campaign_means'] - cm).reshape(CAMPAIGNS, -1).max(1).tolist()}"
            f"; final weight ESS {np.asarray(got['final_weight_ess']).tolist()} against "
            f"{np.asarray(other['final_weight_ess']).tolist()}; resamples "
            f"{np.asarray(got['n_resamples']).tolist()} against "
            f"{np.asarray(other['n_resamples']).tolist()}")
    return differ, line


def campaign_mesh_check(smi, ranks, ref, want, world=ITEM_SHARDS):
    """Phase 48: phase 20's campaigns8 on a ``world``-rank campaign mesh
    (``ranks``' results): every field the same on every rank and bit for
    bit phase 20's call of all CAMPAIGNS campaigns in one batch (``want``):
    no lane's draws depend on how the lanes are batched. No kernel launch
    (Newton cutpoints), and phase 22's agreement with the JAX package.
    Beside it is printed whether the one-process reference at the ranks'
    batch (``ref``, :func:`campaign_blocks_reference`'s) agrees too.
    Returns the numbers for the kernels line."""
    for r in ranks:
        for k in CAMPAIGN_FIELDS:
            check(np.array_equal(r[k], ranks[0][k]),
                  f"phase 48: {k} differs between ranks 0 and {r['rank']}")
        check(r["launches"] == 0, f"phase 48, rank {r['rank']}: {r['launches']} launches")
    got = ranks[0]
    differ, line = _campaign_differences(got, want)
    if differ:
        log(f"phase 48 against phase 20's batch of all {CAMPAIGNS}: {line}")
    check(not differ, f"phase 48: {differ} differ from phase 20's call")
    ref_differ, ref_line = _campaign_differences(got, ref)
    r_jax, worst_z, within = campaign_agreement(got)
    walls = got["walls"]
    log(f"phase 48 on {smi}: campaigns8 on a campaign mesh of {world} ranks, "
        f"{CAMPAIGNS // world} campaigns a rank: the same on every rank, and every field "
        f"bit for bit phase 20's batch of all {CAMPAIGNS}; the one-process reference at the "
        "ranks' batch " + ("agrees bit for bit" if not ref_differ else ref_line)
        + f"; 0 kernel launches; batch wall {walls['total_sec']:.3f} s (smc "
        f"{walls['smc_sec']:.3f}, sampling {walls['sampling_sec']:.3f}; phase 20 "
        f"{want['walls']['total_sec']:.3f}); the JAX agreement r {r_jax:.5f}, {within} "
        "within |z| <= 4")
    return {"launches": [r["launches"] for r in ranks], "wall_s": walls["total_sec"],
            "r_jax": r_jax, "bitwise": True, "reference_bitwise": not ref_differ}


def batch_invariance_phase(rm, dev, smi, chains=K, chunk=K, families=FAMILIES,
                           lanes=FAMILY_LANES, chunks=FAMILY_CHUNKS):
    """Phase 51: one sweep of campaigns8's CAMPAIGNS x ``chains`` lanes
    (phase 20's problem and seed) against the same lanes in batches of
    ``chunk``, block by block and whole (:func:`sweep_block_check`): plain,
    at one temperature, at one a lane, and with the kernel's cutpoint
    update; then each sweep family of ``families`` at its cell, one sweep
    of ``lanes`` chains against the same lanes in batches of each of
    ``chunks`` (:func:`family_block_check`). Every block must agree bit for
    bit. Returns the labels checked and the number of blocks, and each
    family's cases with their blocks."""
    lanes8 = CAMPAIGNS * chains
    prob = campaigns._problem(np.asarray(rm), CAMPAIGNS, SEED=CAMPAIGN_SEED, n_chains=chains,
                              vote_codes=None, device=dev)
    res = sweep_block_check(prob, lanes8, chunk)
    apart = {label: {k: v for k, v in r.items() if v} for label, r in res.items()}
    apart = {k: v for k, v in apart.items() if v}
    check(not apart, f"phase 51: blocks of a sweep differ across batch sizes: {apart}")
    blocks = len(SWEEP_BLOCKS) + 1
    log(f"phase 51 on {smi}: one sweep of campaigns8's {lanes8} lanes against batches of "
        f"{chunk}: all {blocks} blocks (" + ", ".join(name for name, _ in SWEEP_BLOCKS)
        + ", the whole sweep) bit for bit in each of " + "; ".join(res))
    fams = {}
    for name in families:
        t = time.perf_counter()
        got = family_block_check(name, rm, dev, lanes, chunks)
        apart = {label: {k: v for k, v in r.items() if v} for label, r in got.items()}
        apart = {k: v for k, v in apart.items() if v}
        check(not apart, f"phase 51, {name}: blocks of a sweep differ across batch sizes: "
              f"{apart}")
        cases = {}
        for label, r in got.items():
            cases.setdefault(label.rsplit(", batches of", 1)[0], len(r))
        fams[name] = cases
        log(f"phase 51, {name}: one sweep of {lanes} chains against batches of "
            f"{', '.join(map(str, chunks))}: every block and the whole sweep bit for bit in "
            + "; ".join(f"{c} ({n} blocks)" for c, n in cases.items())
            + f" ({time.perf_counter() - t:.2f} s)")
    return {"labels": list(res), "blocks": blocks, "families": fams}


# Phase 52: each sweep family (FAMILIES) at its cell through gpirt_mcmc, K
# chains, at FAM_SIZE's burn and draws on a 2-rank chain mesh (32 chains a
# rank) against the same call in one process; FAM_RESUME's run also cut on
# the mesh after FAM_SIZE's cut draws (burn + cut sweeps) with a checkpoint
# and resumed without a mesh. FAM_RESUME is the family whose repair was the
# largest: the shared-IRF grid sweep, whose f* ESS sums its likelihood 64
# lanes at a time in every round, and moved f* by 1.4 at 512 lanes before
# (PERF.md section 6).
FAM_SIZE, FAM_RESUME = dict(chains=K, burn=10, draws=40, cut=10), "shared_irf"


def family_run(call, dev, size, draws=None, mesh=None, **extra):
    """A family's cell (``call``, :func:`family_call`'s) at ``size``'s chains
    and burn and ``draws`` (``size``'s by default), from SEED, through
    gpirt_mcmc (``extra``: its further arguments), or, for the affine moves
    (GPIRTConfig fields only, as in JAX), through run_chains from the same
    inputs and constants; the chains over ``mesh``'s chains axis. Returns
    (the draws' sha256, the sampling seconds)."""
    data, kw, fields = call
    chains, burn = size["chains"], size["burn"]
    draws = size["draws"] if draws is None else draws
    if not fields:
        out = gpirt_mcmc(data, draws, burn, CHAIN=chains, SEED=SEED, dtype="float32",
                         device=dev, verbose=False, mesh=mesh, **kw, **extra)
        return draws_sha256(out), out[0]["seconds"]["sampling"]
    y, cfg, th, thr = family_inputs(call, dev)
    if mesh is None or dist.get_rank() == 0:
        consts = family_consts(cfg, dev)
    if mesh is not None:  # built once, the same bits on every rank, as gpirt_mcmc does
        consts = broadcast_constants(consts if dist.get_rank() == 0 else None, dev,
                                     cfg.tdtype)
    t = time.perf_counter()
    d = run_chains(torch.Generator(device=dev).manual_seed(SEED), y,
                   th.expand(chains, *th.shape), thr, consts, cfg, sample_iterations=draws,
                   burn_iterations=burn, mesh=mesh)
    host = {k: d[k].cpu().numpy() for k in ("theta", "beta", "threshold", "ll")}
    return draws_sha256_host(host), time.perf_counter() - t


def _counted(fn, *args, **kwargs):
    """{"sha", "seconds", "launches", "ordinal"} of ``fn``'s run
    (:func:`family_run`), the binary and the ordinal kernel's launches
    counted from 0."""
    threshold_ess.binary_threshold_ess.launches = 0
    threshold_ess.ordinal_threshold_ess.launches = 0
    sha, secs = fn(*args, **kwargs)
    return {"sha": sha, "seconds": secs, "launches": threshold_ess.binary_threshold_ess.launches,
            "ordinal": threshold_ess.ordinal_threshold_ess.launches}


def family_mesh_rank(device, calls, path, size, resume=FAM_RESUME):
    """Phase 52 on one rank: each family's run (``calls``: name ->
    :func:`family_call`'s) on a chain mesh over the world, then
    ``resume``'s run cut after ``size``'s cut draws with a checkpoint at
    ``path``."""
    entered = time.time()
    dev = _rank_device(device)
    mesh = make_chain_mesh(device=dev.type)
    res = {name: _counted(family_run, call, dev, size, mesh=mesh)
           for name, call in calls.items()}
    res["cut"] = _counted(family_run, calls[resume], dev, size, size["cut"], mesh=mesh,
                          checkpoint_path=path, checkpoint_every=size["burn"] + size["cut"])
    return {"families": res, "rank": dist.get_rank(), "stamps": (entered, time.time())}


def family_references(rm, dev, size=None, families=FAMILIES):
    """Phase 52's inputs and one-process calls: {"calls": name ->
    :func:`family_call`'s, "size": the runs' size, "want": name -> its run
    without a mesh (:func:`_counted`)}."""
    size = dict(FAM_SIZE if size is None else size)
    calls = {name: family_call(name, rm) for name in families}
    return {"calls": calls, "size": size,
            "want": {name: _counted(family_run, call, dev, size)
                     for name, call in calls.items()}}


def family_mesh_check(dev, smi, ranks, refs, path, world=ITEM_SHARDS, resume=FAM_RESUME):
    """Phase 52's checks: on every rank each family's draws hash to the
    one-process call's (``refs``, :func:`family_references`') and the
    binary kernel was launched once a sweep on the binary families (on
    every fourth under interleave), the ordinal kernel once a sweep on the
    ordinal SDO and neither elsewhere; the run cut on the mesh, resumed
    here without one, hashes to the uninterrupted one-process call. Returns
    the numbers for the kernels line."""
    size, want, calls = refs["size"], refs["want"], refs["calls"]
    sweeps, cut = size["burn"] + size["draws"], size["burn"] + size["cut"]

    def launched(name, start, stop):  # the binary kernel's sweeps of [start, stop)
        every = calls[name][1].get("threshold_ess_every", 1)  # interleave's ESS sweeps
        binary = name != "sdo" and dev.type == "cuda"
        return len(range(start + -start % every, stop, every)) if binary else 0

    def launched_ordinal(name, start, stop):  # the ordinal kernel's
        return stop - start if name == "sdo" and dev.type == "cuda" else 0

    for name, ref in want.items():
        for r in ranks:
            got = r["families"][name]
            check(got["sha"] == ref["sha"],
                  f"phase 52, {name}, rank {r['rank']}: the chain mesh's draws "
                  f"{got['sha'][:8]}... differ from the one-process call's {ref['sha'][:8]}...")
            check(got["launches"] == launched(name, 0, sweeps),
                  f"phase 52, {name}, rank {r['rank']}: {got['launches']} kernel launches "
                  f"in {sweeps} sweeps")
            check(got["ordinal"] == launched_ordinal(name, 0, sweeps),
                  f"phase 52, {name}, rank {r['rank']}: {got['ordinal']} ordinal kernel "
                  f"launches in {sweeps} sweeps")
    res = _counted(family_run, calls[resume], dev, size, checkpoint_path=path,
                   checkpoint_every=cut)
    check(res["launches"] == launched(resume, cut, sweeps)
          and res["ordinal"] == launched_ordinal(resume, cut, sweeps),
          f"phase 52: {res['launches']} kernel launches ({res['ordinal']} ordinal) in the "
          f"resume's {sweeps - cut} sweeps")
    check(res["sha"] == want[resume]["sha"],
          f"phase 52: {resume}'s run cut on the chain mesh and resumed without one "
          f"{res['sha'][:8]}... differs from the uninterrupted call's "
          f"{want[resume]['sha'][:8]}...")
    launches = {name: [r["families"][name]["launches"] for r in ranks] for name in want}
    ordinal = {name: [r["families"][name]["ordinal"] for r in ranks] for name in want}
    log(f"phase 52 on {smi}: {len(want)} sweep families on a chain mesh of {world} ranks, "
        f"{size['chains'] // world} chains a rank, burn {size['burn']}, {size['draws']} draws: "
        "every rank's draws hash to the one-process call's (" + "; ".join(
            f"{n} {w['sha'][:8]}..., launches {launches[n]} a rank and {w['launches']} in one "
            f"process (ordinal {ordinal[n]} and {w['ordinal']}), "
            f"{sweeps / ranks[0]['families'][n]['seconds']:.2f} sweeps/s a rank "
            f"against {sweeps / w['seconds']:.2f}" for n, w in want.items())
        + f"); {resume} cut on the mesh after {cut} sweeps "
        f"({[r['families']['cut']['launches'] for r in ranks]} launches) and resumed here "
        f"without one for {sweeps - cut} sweeps ({res['launches']} launches): bit for bit "
        "the uninterrupted one-process call")
    return {"launches": launches,
            "launches_one_process": {n: w["launches"] for n, w in want.items()},
            "ordinal_launches": ordinal,
            "ordinal_launches_one_process": {n: w["ordinal"] for n, w in want.items()},
            "launches_cut": [r["families"]["cut"]["launches"] for r in ranks],
            "launches_resumed": res["launches"], "bitwise": True}


def tempered_continuation(dev, rm, state_path, draws, mesh=None):
    """The sign-aligned posterior theta means of the cold lanes of
    ``draws`` tempered sweeps (phase 19's ladder) continued from the lane
    states in ``state_path`` (with their constants), on ``mesh`` with the
    items and respondents sharded, or unsharded without one; and (on a
    mesh) this rank's swap tally and last state block."""
    y, cfg, _ = main_config(rm, dev, build=False)
    saved = torch.load(state_path, map_location=dev)
    state = gibbs.GPIRTState(*saved["state"])
    consts = GPIRTConstants(**saved["consts"])
    G = state.theta_idx.shape[0] // PT_TEMPS
    axes = (None, None) if mesh is None else ("items", "respondents")
    thr = torch.as_tensor(default_thresholds(cfg.C, cfg.m, cfg.horizon), dtype=cfg.tdtype,
                          device=dev)  # unread: the run starts from ``state``
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    st = tempered_start(gen, torch.zeros(G, cfg.horizon, cfg.n, device=dev), thr, y,
                        consts, cfg, PT_TEMPS, PT_MAX_TEMP, mesh, *axes)
    carry = Carry(state if mesh is None else lane_state_block(state, st.shards, *axes))
    acc = torch.zeros(st.temps.shape[0], dtype=torch.int64, device=dev)
    acc, out = advance_tempered(gen, carry, acc, st, PT_TEMPS, 1,
                                sample_schedule(draws, 0, 1), 0, draws)
    digest = hashlib.sha256(b"".join(np.ascontiguousarray(out[k].cpu().numpy()).tobytes()
                                     for k in sorted(out))).hexdigest()
    return run_means(out["theta"]), acc, carry.state, digest


def tempered_mesh_rank(device, rm, state_path, cont_draws, chains, burn, draws):
    """Phase 49 on one rank: phase 19's sampler on a 2 x 2 items x
    respondents mesh continued from its last lane states (in
    ``state_path``) for ``cont_draws`` draws (every model shard's replicated
    fields checked alike at the end, ``parallel.chains.check_replicated``),
    then phase 19's call from scratch on the mesh at ``burn`` and
    ``draws``, its launches counted from 0."""
    entered = time.time()
    dev = _rank_device(device)
    mesh = make_respondent_mesh(RESP_SHARDS, n_item_shards=2, device=dev.type)
    sh = shards_of(mesh, "items", "respondents")
    cont, acc, block, cont_sha = tempered_continuation(dev, rm, state_path, cont_draws, mesh)
    threshold_ess.binary_threshold_ess.launches = 0
    sites = SiteAllReduce(dev)
    gibbs.dist = sites
    try:
        out = tempering_call(rm, dev, chains, burn, draws, mesh=mesh, item_axis="items",
                             respondent_axis="respondents")
    finally:
        gibbs.dist = dist
    return {"sites": sites.summary(burn + draws),"rank": dist.get_rank(), "place": (sh.item_rank, sh.resp_rank),
            "continued_means": cont, "acc": acc.cpu().numpy(), "cont_sha": cont_sha,
            "replicated": {k: getattr(block, k).cpu().numpy()
                           for k in ("theta_idx", "beta", "thresholds", "fstar")},
            "launches": threshold_ess.binary_threshold_ess.launches,
            "sha": draws_sha256(out), "means": theta_means(out),
            "swap_rate": out[0]["swap_rate"], "seconds": out[0]["seconds"],
            "finite": bool(all(np.isfinite(d["ll"]).all() for d in out)),
            "stamps": (entered, time.time())}


def tempered_mesh_report(rm, dev, smi, ranks, want_means, state_path, burn, draws):
    """Phase 49: phase 19's tempering on a 2 x 2 items x respondents mesh
    (``ranks``' results): continued from phase 19's last lane states, the
    cold chains' sign-aligned posterior theta means at r >= MESH_MIN_R with
    phase 19's (``want_means``), the unsharded continuation's r beside;
    theta alike on the item shards of a respondent block, beta, the
    cutpoints and f* on the respondent shards of an item block, the swap
    tally and the draws on every rank; no kernel launch (a respondent axis
    runs the plain cutpoint loop); the call from scratch finite and alike
    on every rank, its r with phase 19's and its swap rates printed, not
    gated (its basin is its stream's). Returns the numbers for the
    kernels line."""
    by_place = {r["place"]: r for r in ranks}
    for (i, rr), r in by_place.items():
        check(np.array_equal(r["replicated"]["theta_idx"],
                             by_place[(1 - i, rr)]["replicated"]["theta_idx"]),
              "phase 49: theta differs between the item shards")
        for k in ("beta", "thresholds", "fstar"):
            check(np.array_equal(r["replicated"][k], by_place[(i, 1 - rr)]["replicated"][k]),
                  f"phase 49: {k} differs between the respondent shards")
    for r in ranks:
        check(np.array_equal(r["acc"], ranks[0]["acc"]) and r["cont_sha"] == ranks[0]["cont_sha"],
              f"phase 49: rank {r['rank']}'s swaps or draws differ from rank 0's")
        check(r["launches"] == 0, f"phase 49, rank {r['rank']}: {r['launches']} launches")
        check(r["finite"] and r["sha"] == ranks[0]["sha"],
              f"phase 49, rank {r['rank']}: the call's draws differ or are not finite")
    r_cont = signed_r(ranks[0]["continued_means"], want_means)
    r_plain = signed_r(tempered_continuation(dev, rm, state_path, PT_CONT_DRAWS)[0],
                       want_means)
    check(np.isfinite(r_cont) and r_cont >= MESH_MIN_R,
          f"phase 49: continued from phase 19's last lane states, r {r_cont:.5f}")
    r_call = signed_r(ranks[0]["means"], want_means)
    sec = ranks[0]["seconds"]
    rate = (burn + draws) / sec["sampling"]
    log(f"phase 49 on {smi}: phase 19's tempering on a 2 x 2 items x respondents mesh, 4 "
        f"ranks: continued from phase 19's last lane states for {PT_CONT_DRAWS} draws, cold "
        f"posterior theta means r {r_cont:.5f} with phase 19's (unsharded continuation "
        f"{r_plain:.5f}); theta alike on the item shards, beta, cutpoints and f* on the "
        f"respondent shards, swaps and draws on every rank; 0 kernel launches; "
        f"gpirt_mcmc(n_temps={PT_TEMPS}, mesh) from scratch, burn {burn}, {draws} draws: "
        f"r {r_call:.5f} with phase 19's (not gated: the basin is the stream's), swap rates "
        + ", ".join(f"{v:.4f}" for v in ranks[0]["swap_rate"])
        + f", {rate:.2f} sweeps/s; all_reduce a sweep (rank 0, timed in the call) "
        f"{sum(v[2] for v in ranks[0]['sites'].values()):.3f} ms: "
        + sites_line(ranks[0]["sites"]))
    return {"launches": [r["launches"] for r in ranks], "r_continued": r_cont,
            "allreduce_sites": ranks[0]["sites"],
            "r_continued_unsharded": r_plain, "r_call": r_call, "sweeps_per_s": rate,
            "swap_rate": [float(v) for v in ranks[0]["swap_rate"]]}


def rank_world(device, stages, stage_done):
    """One rank of one world running ``stages``, (phase, rank function,
    arguments after the device) each, in turn, each a stage of its own
    timeout (a rank's start costs seconds on the card's machine). Returns
    {phase: the rank function's result}."""
    if device == "cpu":  # the reduced sizes' tiny tensors: one thread a rank
        torch.set_num_threads(1)
    out = {}
    for i, (phase, fn, args) in enumerate(stages):
        if i:
            stage_done()
        out[phase] = fn(device, *args)
    return out


def stage_ends(started, ranks, phases):
    """When the ranks reached their functions and when each stage ended,
    from the ranks' stamps, after the launch at ``started``."""
    first = max(r[phases[0]]["stamps"][0] for r in ranks) - started
    ends = [max(r[p]["stamps"][-1] for r in ranks) - started for p in phases]
    walls = np.diff([first] + ends)
    return (f"ranks in their function after {first:.1f} s; "
            + "; ".join(f"phase {p}'s stage ended at {e:.1f} s ({w:.1f} s)"
                        for p, e, w in zip(phases, ends, walls))
            + f"; back in the parent after {time.time() - started:.1f} s")


def two_rank_phases(rm, dev, smi, state, want, want_cut, want_means, chains=K, burn=BURN,
                    draws=DRAWS, smc_steps=SMC_STEPS, cut=CK_CUT, every=CK_EVERY,
                    phases=(38, 39, 41), resp=None, later=None, mesh_burn=MESH_BURN,
                    mesh_draws=MESH_DRAWS, mesh_smc=None, mesh2=(MESH2_BURN, MESH2_DRAWS),
                    pt=(PT_BURN, PT_DRAWS), rc=(RC_BURN, RC_DRAWS, RC_EVERY, RC_CUT)):
    """Phases 38, 39, 41, 42-44, 46-48, 50 and 52 (``phases``) as the stages of
    one world of 2 ranks sharing the card, each with its own timeout
    (RANK_TIMEOUT), then each checked here. ``resp`` gives the respondent
    phases what they are held to and print beside their own: "rates"
    (sweeps a second by label), "syn16" (phase 16's numbers) and
    "syn_size" (phase 44's run); phase 43 runs at ``mesh_burn``,
    ``mesh_draws`` and ``mesh_smc`` SMC steps (``smc_steps`` when None).
    ``later`` gives phases 47-48 theirs: "pt_sha" (phase
    19's), "camp20" (phase 20's result), "camp_ref" (phase 48's reference,
    :func:`campaign_blocks_reference`) and "schedule" (their overrides), and
    phase 52 "families" (:func:`family_references`');
    phase 46's call runs at ``mesh2`` (burn, draws), phase 47 at ``pt`` and
    phase 50 at ``rc`` (burn, draws, every, cut).
    Returns {phase: its numbers}: 38's (worst, flipped), 39's, 41's, 42's
    differences, 43's, 44's, 46's, 47's, 48's, 50's and 52's."""
    resp, later = resp or {}, later or {}
    mesh_smc = smc_steps if mesh_smc is None else mesh_smc
    with _temporary_dir() as tmp:
        # phases 38, 42, 43 and 46 read the state and constants from one file
        path, inputs = (sharded_sweep_inputs(rm, dev, state, tmp)
                        if {38, 42, 43, 46, 50} & set(phases) else (None, None))
        resp_inputs = resp_sweep_inputs(rm, dev, state) if 42 in phases else None
        item_inputs_46 = item_option_inputs(rm, dev, state) if 46 in phases else None
        ck_path, fam_path = os.path.join(tmp, "cut"), os.path.join(tmp, "families")
        specs = {38: (sharded_sweep_rank, (rm, path, tmp)),
                 39: (item_mesh_rank, (rm, ITEM_SHARDS, 1, burn, draws, smc_steps, chains)),
                 41: (chain_mesh_rank, (rm, chains, burn, cut, smc_steps, ck_path, every)),
                 42: (resp_sweep_rank, (rm, path, tmp, AFFINE_W)),
                 43: (resp_mesh_rank, (rm, 1, mesh_burn, mesh_draws, mesh_smc, chains, path,
                                       CONT_DRAWS)),
                 44: (resp_synthetic_rank, (resp.get("syn_size", SYN_SIZE),)),
                 46: (item_option_rank, (rm, path, tmp, AFFINE_W, chains) + tuple(mesh2)),
                 47: (chain_tempering_rank, (rm, chains) + tuple(pt)),
                 48: (campaign_mesh_rank, (rm, later.get("schedule", {}))),
                 50: (resume_counts_rank, (rm, path, tmp, tuple(rc))),
                 52: (family_mesh_rank, (later.get("families", {}).get("calls"), fam_path,
                                         later.get("families", {}).get("size")))}
        started = time.time()
        ranks = launch(rank_world, ITEM_SHARDS,
                       (dev.type, [(p,) + specs[p] for p in phases]), device=dev.type,
                       stages=(RANK_TIMEOUT,) * len(phases))
        log(f"phases {', '.join(map(str, phases))} in one world of {ITEM_SHARDS} ranks on "
            f"{smi}: " + stage_ends(started, ranks, phases))
        out = {}
        if 38 in phases:
            t = time.perf_counter()
            out[38] = sharded_sweep_check(smi, [r[38] for r in ranks], tmp, inputs)
            log(f"phase 38 (its check here): {time.perf_counter() - t:.2f} s wall")
        if 39 in phases:
            out[39] = item_mesh_report(rm, dev, smi, want_means, [r[39] for r in ranks],
                                       ITEM_SHARDS, 1, burn, draws, smc_steps, "39", chains)
        if 41 in phases:
            t = time.perf_counter()
            out[41] = chain_mesh_check(rm, dev, smi, want, want_cut, want_means, state,
                                       [r[41] for r in ranks], ck_path, ITEM_SHARDS, chains,
                                       burn, draws, smc_steps, cut, every)
            log(f"phase 41 (its checks and the resume here): {time.perf_counter() - t:.2f} s "
                "wall")
        if 42 in phases:
            t = time.perf_counter()
            out[42] = resp_sweep_check(smi, [r[42] for r in ranks], tmp, resp_inputs)
            log(f"phase 42 (its checks here): {time.perf_counter() - t:.2f} s wall")
        rates = dict(resp.get("rates", {}))
        if 39 in out:
            rates["phase 39"] = out[39]["sweeps_per_s"]
        if 43 in phases:
            out[43] = resp_mesh_report(rm, dev, smi, want_means, [r[43] for r in ranks], 1,
                                       mesh_burn, mesh_draws, mesh_smc, "43", rates, chains,
                                       path)
        if 44 in phases:
            out[44] = resp_synthetic_report(dev, smi, [r[44] for r in ranks], resp["syn16"],
                                            resp.get("syn_size", SYN_SIZE))
        if 46 in phases:
            out[46] = item_option_check(smi, [r[46] for r in ranks], tmp, item_inputs_46,
                                        *mesh2)
        if 47 in phases:
            out[47] = chain_tempering_check(smi, [r[47] for r in ranks], later["pt_sha"], *pt)
        if 48 in phases:
            out[48] = campaign_mesh_check(smi, [r[48] for r in ranks], later["camp_ref"],
                                          later["camp20"])
        if 50 in phases:
            out[50] = resume_counts_report(rm, dev, smi, [r[50] for r in ranks], tmp, path,
                                           tuple(rc))
        if 52 in phases:
            t = time.perf_counter()
            out[52] = family_mesh_check(dev, smi, [r[52] for r in ranks],
                                        later["families"], fam_path)
            log(f"phase 52 (its checks and the resume here): {time.perf_counter() - t:.2f} s "
                "wall")
    return out


def mesh_keys(tag, res):
    """Phase 39's or 40's numbers (:func:`item_mesh_report`) as keys of the
    kernels line."""
    out = {f"launches_{tag}": res["launches"], f"lanes_{tag}": res["lanes"],
           f"max_abs_err_{tag}": res["worst"], f"lanes_over_1e-5_{tag}": res["flipped"]}
    out.update({f"{k}_{tag}_state": res[k]
                for k in ("ms", "ms_eager", "plain_ms", "bound_ms", "bound_by")})
    out.update({f"{tag}_{k}": res[k] for k in (
        "sweeps_per_s", "smc_s", "sampling_s", "allreduce_ms", "allreduce_bytes",
        "allreduce_calls", "allreduce_share", "peak_gib", "r_phase5", "backend")})
    return out


def resp_keys(tag, res):
    """A respondent phase's numbers (:func:`resp_mesh_report`,
    :func:`resp_synthetic_report`) as keys of the kernels line: the
    kernel's launches there (0: the plain round loop runs under a
    respondent axis) and the run's rates, rounds, all_reduce sites (calls,
    bytes a call, ms, each a sweep) and peak memory by rank."""
    out = {f"launches_{tag}": res["launches"], f"{tag}_sweeps_per_s": res["sweeps_per_s"],
           f"{tag}_ess_rounds_per_update": res["ess_rounds"],
           f"{tag}_allreduce_sites": res["allreduce_sites"], f"{tag}_peak_gib": res["peak_gib"]}
    if "r_phase5" in res:
        out.update({f"{tag}_r_phase5": res["r_phase5"],
                    f"{tag}_r_continued": res["r_continued"],
                    f"{tag}_r_continued_unsharded": res["r_continued_unsharded"]})
    return out


def later_keys(items46, chain47, camp48, pt49):
    """Phases 46-49's numbers as keys of the kernels line: the kernel's
    launches on each rank (phase 46's ESS theta call, phase 47's chain
    mesh; 0 in phases 48-49 by design: Newton cutpoints, and the plain loop
    under a respondent axis), its errors and times at a rank's state of
    phases 46 and 47, the rates and the posterior r."""
    out = {"launches_items2_theta_ess": items46["launches"],
           "launches_chain_mesh_tempering": chain47["launches"],
           "launches_campaign_mesh": camp48["launches"],
           "launches_items2_resp2_tempering": pt49["launches"],
           "items2_option_sweeps_max_abs_diff": {
               k: max(v[f] for f in ("f", "beta", "thresholds", "fstar"))
               for k, v in items46["sweeps"].items()},
           "items2_option_sweeps_theta_equal": {
               k: v["chains_theta_equal"] for k, v in items46["sweeps"].items()},
           "items2_theta_ess_sweeps_per_s": items46["sweeps_per_s"],
           "items2_theta_ess_allreduce_ms": items46["allreduce_ms"],
           "items2_resp2_tempering_allreduce_sites": pt49["allreduce_sites"],
           "chain_mesh_tempering_sweeps_per_s": chain47["sweeps_per_s"],
           "campaign_mesh_wall_s": camp48["wall_s"], "campaign_mesh_r_jax": camp48["r_jax"],
           "campaign_mesh_bitwise_phase20": camp48["bitwise"],
           "campaign_mesh_reference_bitwise": camp48["reference_bitwise"],
           "items2_resp2_tempering_r_continued": pt49["r_continued"],
           "items2_resp2_tempering_r_call": pt49["r_call"],
           "items2_resp2_tempering_swap_rate": pt49["swap_rate"],
           "items2_resp2_tempering_sweeps_per_s": pt49["sweeps_per_s"]}
    for tag, res in (("items2_theta_ess", items46), ("chain_mesh_tempering", chain47)):
        out.update({f"max_abs_err_{tag}": res["worst"], f"lanes_over_1e-5_{tag}": res["flipped"],
                    f"lanes_{tag}": res["lanes"]})
        out.update({f"{k}_{tag}_state": res[k] for k in ("ms", "ms_eager", "plain_ms",
                                                         "bound_ms", "bound_by") if k in res})
    return out


def chain_means(out):
    """Each chain's posterior theta means (session 0), (chains, n), and its
    mean ll over the draws, (chains,)."""
    return (np.stack([d["theta"][:, :, 0].mean(axis=0) for d in out]),
            np.array([float(np.mean(d["ll"])) for d in out]))


def basin_rank(device, rm, seed, chains, burn, draws, smc_steps):
    """One rank of the basin study: phase 5's call at SEED ``seed`` on 2
    respondent shards, its chain_means."""
    entered = time.time()
    dev = _rank_device(device)
    mesh = make_respondent_mesh(RESP_SHARDS, device=dev.type)
    means, ll = chain_means(main_call(rm, dev, chains, burn, draws, smc_steps, seed, mesh=mesh,
                                      respondent_axis="respondents"))
    return {"means": means, "ll": ll, "stamps": (entered, time.time())}


def chain_r(means, ref):
    """Each chain's |r| of its posterior theta means with ``ref`` (the sign
    is the reflection's)."""
    return np.abs([np.corrcoef(c, ref)[0, 1] for c in means])


def basin_study(rm, dev, smi, seeds, chains=K, burn=BURN, draws=BASIN_DRAWS,
                smc_steps=SMC_STEPS):
    """Where senate116's SMC ensemble settles, unsharded and on 2 respondent
    shards, at each SEED in ``seeds``: phase 5's call (draws cut to
    ``draws``) once unsharded and once on a respondent mesh a seed. For each
    run prints the sign-aligned pooled means' r with the first seed's
    unsharded run's (phase 5's basin at SEED 1), the share of its chains
    whose means correlate with those at |r| >= BASIN_R, the share of its
    chains that so match some chain of the unsharded runs at the other
    seeds (the basins the unsharded sampler visits), and the chains' mean
    ll; then the two samplers' shares side by side. A measurement: it
    gates nothing. Returns {"unsharded"/"sharded": [share a seed]}."""
    t = time.perf_counter()
    plain = {s: chain_means(main_call(rm, dev, chains, burn, draws, smc_steps, s))
             for s in seeds}
    log(f"basins: {len(seeds)} unsharded runs in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    ranks = launch(rank_world, RESP_SHARDS,
                   (dev.type, [(s, basin_rank, (rm, s, chains, burn, draws, smc_steps))
                               for s in seeds]),
                   device=dev.type, stages=(RANK_TIMEOUT,) * len(seeds))
    log(f"basins: {len(seeds)} runs on {RESP_SHARDS} respondent shards in "
        f"{time.perf_counter() - t:.1f} s")
    sharded = {s: (ranks[0][s]["means"], ranks[0][s]["ll"]) for s in seeds}
    first = plain[seeds[0]][0]
    ref = align_theta_signs(first, reference=first[0]).mean(axis=0)
    rows, shares = [], {"unsharded": [], "sharded": []}
    for label, runs in (("unsharded", plain), ("sharded", sharded)):
        for s, (means, ll) in runs.items():
            pooled = align_theta_signs(means, reference=means[0]).mean(axis=0)
            others = np.concatenate([plain[o][0] for o in seeds if o != s])
            visited = float(np.mean([chain_r(others, c).max() >= BASIN_R for c in means]))
            r_ref = chain_r(means, ref)
            share = float(np.mean(r_ref >= BASIN_R))
            if label == "sharded" or s != seeds[0]:  # the first is the basin's own run
                shares[label].append(share)
            rows.append(f"{label} SEED {s}: pooled r {signed_r(pooled, ref):.5f}, chains' |r| "
                        f"with phase 5's basin median {np.median(r_ref):.5f} (min "
                        f"{r_ref.min():.5f}), chains in it {share:.3f}, chains in a basin "
                        f"the other seeds' unsharded runs visit {visited:.3f}, mean ll "
                        f"{ll.mean():.3f} (chains {ll.min():.3f} to {ll.max():.3f})")
    log(f"basins on {smi}: senate116, {chains} chains, SMC {smc_steps}, burn {burn}, {draws} "
        f"draws; phase 5's basin: the unsharded SEED {seeds[0]} run's pooled means; a chain "
        f"in a basin at |r| >= {BASIN_R}\n  " + "\n  ".join(rows))
    u, h = shares["unsharded"], shares["sharded"]
    log(f"basins: share of chains in phase 5's basin, mean over seeds: unsharded "
        f"{np.mean(u):.3f} (SEED {seeds[0]}, the basin's own run, left out), sharded "
        f"{np.mean(h):.3f}; runs "
        f"with a majority there: unsharded {sum(x > 0.5 for x in u)} of {len(u)}, sharded "
        f"{sum(x > 0.5 for x in h)} of {len(h)}")
    return shares


def ess_layouts(dev, smi, reps=5, shards=RESP_SHARDS):
    """The respondent path's binary cutpoint ESS (gibbs._binary_ess_over_
    respondents, which gathers the active lanes in every round) against
    three layouts of its per-lane ll on the same inputs: every lane summed
    densely in every round, the active lanes gathered in every round, and
    the dense sum while over half the lanes are active, the gather after
    (two paths chosen by the active share). The inputs are the kernel's at
    the synthetic configuration's state after 40 sweeps (phase 16's run,
    cut), cut to one of ``shards`` respondent blocks, one process, no
    all_reduce. Prints each version's rounds an update, its ms an update
    (median of ``reps``, the versions in turns, CUDA events) and whether
    its cutpoints equal the dense version's."""
    _, _, _, args = synthetic_run(dev, synthetic_inputs(dev), burn=30, draws=10)
    g, y, t1, nu, logu, eps0, rs = args
    K, H, n, m = g.shape
    block = n // shards
    g, y = g[..., :block, :].contiguous(), y[:, :block].contiguous()
    obs = (y > 0).to(g.dtype)
    sgn = torch.where(y == 1, 1.0, -1.0).to(g.dtype) * obs

    def term(x):
        return torch.log(0.5 * (1.0 + torch.erf(x)) + 1e-6)

    def dense(t, active):
        return (term(sgn * (t[..., 0].unsqueeze(-2) - g) * _C) * obs).sum(dim=-2)

    g_rows = g.movedim(-2, -1).reshape(K * H * m, block)
    sgn_rows, obs_rows = (a.movedim(-2, -1).reshape(H * m, block) for a in (sgn, obs))

    def gather(t, active):
        lane = (torch.arange(K * H * m, device=dev) if active is None
                else torch.nonzero(active.flatten()).squeeze(-1))
        site = lane % (H * m)
        x = sgn_rows[site] * (t.flatten()[lane].unsqueeze(-1) - g_rows[lane]) * _C
        total = torch.zeros(K * H * m, dtype=g.dtype, device=dev)
        total[lane] = (term(x) * obs_rows[site]).sum(dim=-1)
        return total.view(K, H, m)

    def split(t, active):  # dense while over half the lanes are active
        if active is None or 2 * int(active.sum()) > active.numel():
            return dense(t, active)
        return gather(t, active)

    def one(ll):
        return lambda: ess_update(t1.unsqueeze(-1), nu.unsqueeze(-1), ll, logu, eps0, rs,
                                  active_only=True)[..., 0]

    versions = {"dense every round": one(dense), "gather every round": one(gather),
                "dense over half active, else gather": one(split),
                "the port's": lambda: gibbs._binary_ess_over_respondents(
                    g, y, t1, nu, logu, eps0, rs, _C, None)}
    times = {k: [] for k in versions}
    out, rounds = {}, {}
    order = list(versions)
    for rep in range(reps):
        for k in (order if rep % 2 == 0 else order[::-1]):
            ess_update.rounds = ess_update.calls = 0
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out[k] = versions[k]()
            end.record()
            torch.cuda.synchronize()
            times[k].append(start.elapsed_time(end))
            rounds[k] = ess_update.rounds / ess_update.calls
    ref = out["dense every round"]
    log(f"binary cutpoint ESS over respondents on {smi}: the synthetic state after 40 sweeps, "
        f"one of {shards} respondent blocks ({K} x {H} x {block} x {m}), float32, no "
        "all_reduce; " + "; ".join(
            f"{k}: {rounds[k]:.0f} rounds, {np.median(times[k]):.3f} ms an update (runs "
            + ", ".join(f"{t:.3f}" for t in times[k]) + f"), cutpoints equal the dense "
            f"version's in {float((out[k] == ref).double().mean()):.6f} of the lanes"
            for k in versions))
    return times, rounds


def ess_layouts_main():
    """``chip_smoke.py --ess-layouts``: :func:`ess_layouts` on the card."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    full_fp32_matmuls()
    smi = card()
    threshold_ess.build()
    ess_layouts(dev, smi)
    log(card())
    return 0


def basins_main(argv):
    """``chip_smoke.py --basins [s1,s2,...]``: :func:`basin_study` on the
    card at BASIN_SEEDS or the seeds given."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    full_fp32_matmuls()
    smi = card()
    threshold_ess.build()
    rm, _, _ = senate116_response_matrix()
    basin_study(rm, dev, smi, [int(x) for x in argv[0].split(",")] if argv else BASIN_SEEDS)
    log(card())
    return 0


# (label, seconds) of each phase main() ran, in order: the table of phase walls
PHASE_WALLS = []


def phase_wall(label, t0):
    """Prints and keeps the wall time of phase ``label``, begun at ``t0``
    (``time.perf_counter``)."""
    secs = time.perf_counter() - t0
    PHASE_WALLS.append((label, secs))
    log(f"phase {label}: {secs:.2f} s wall")


def timed(label, fn, *args, **kwargs):
    """fn(*args), its wall time printed under ``label`` and kept."""
    t = time.perf_counter()
    out = fn(*args, **kwargs)
    phase_wall(label, t)
    return out


def walls_line(walls):
    """The table of phase walls (``walls``: (label, seconds)) on one line,
    with their sum."""
    return ("phase walls (s): " + "; ".join(f"{label} {secs:.2f}" for label, secs in walls)
            + f"; sum {sum(secs for _, secs in walls):.2f}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    full_fp32_matmuls()
    smi = card()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    t = time.perf_counter()
    report = threshold_ess.build(verbose=True)
    log(f"build: {time.perf_counter() - t:.1f} s\n{report.strip()}")

    rm, _, _ = senate116_response_matrix()
    y, _, _ = encode_categories(np.asarray(rm))
    y_dev = torch.as_tensor(np.ascontiguousarray(y), dtype=torch.int32, device=dev)
    rand_args = random_lanes(y_dev)
    worst, flipped = timed("3 (kernel check)", kernel_check, rand_args, "random lanes")
    rand_times = {t: kernel_times(rand_args, _C / np.sqrt(t)) for t in (1.0, T_MAX)}
    for t, (ms, eager, plain) in rand_times.items():
        log(f"kernel time, random lanes, T={t:g}: {ms:.5f} ms (graph), "
            f"{eager:.5f} ms (eager), plain {plain:.4f} ms")
    timed("4 (sweep check)", sweep_check, dev)
    launches, state_args, main_sha, main_rate, main_means, main_cut_sha = timed(
        "5 (main path)", main_path, rm, dev, smi)

    w, f = kernel_check(state_args, "main path's state")
    worst, flipped = max(worst, w), flipped + f
    ms, eager, plain = kernel_times(state_args, _C)
    log(f"kernel time, main path's state, T=1: {ms:.5f} ms (graph), "
        f"{eager:.5f} ms (eager), plain {plain:.4f} ms")
    work = kernel_bound(state_args, _C)
    for method in ("ess", "newton"):
        timed(f"7 (C=5 sweep check, {method})", sweep_check, dev, 5, method)
    sdo_launches, sdo_args, sdo_res = timed("8 (SDO path)", sdo_path, dev, smi)
    t = time.perf_counter()
    ord_rand = random_ordinal_lanes(sdo_args[1])
    ord_worst, ord_flipped = kernel_check(ord_rand, "SDO random lanes")
    ord_rand_times = {temp: kernel_times(ord_rand, _C / np.sqrt(temp))
                      for temp in (1.0, T_MAX)}
    for temp, (o_ms, o_eager, o_plain) in ord_rand_times.items():
        log(f"ordinal kernel time, SDO random lanes ({ord_rand[4].numel()} lanes), "
            f"T={temp:g}: {o_ms:.5f} ms (graph), "
            f"{o_eager:.5f} ms (eager), plain {o_plain:.4f} ms")
    w, f = kernel_check(sdo_args, "SDO path's state")
    ord_worst, ord_flipped = max(ord_worst, w), ord_flipped + f
    ord_plan = threshold_ess.ordinal_launch_plan(sdo_args[0].shape[2], sdo_args[2].shape[-1] + 1)
    ord_ms, ord_eager, ord_plain = kernel_times(sdo_args, _C)
    ord_work = kernel_bound(sdo_args, _C, "SDO path's state")
    log(f"ordinal kernel time, SDO path's state ({sdo_args[4].numel()} lanes of "
        f"{sdo_args[0].shape[2]} sites), T=1: {ord_plan['path']} path, "
        f"{ord_plan['threads_a_lane']} threads a lane; {ord_ms:.5f} ms (graph), "
        f"{ord_eager:.5f} ms (eager), plain {ord_plain:.4f} ms; bound "
        f"{ord_work['bound_ms']:.5f} ms by {ord_work['bound_by']}, "
        f"{100 * ord_work['bound_ms'] / ord_ms:.2f}% of it")
    phase_wall("8 (ordinal kernel at random lanes and the SDO state)", t)
    for C in (2, 5):
        timed(f"9 (GP sweep check, C={C})", sweep_check, dev, C, "auto", 4.0, 3, DYN_LS)
    dyn_launches, dyn_args = timed("10 (dynamic path)", dynamic_path, dev, smi)
    dyn_worst, dyn_flipped = kernel_check(dyn_args, "dynamic path's state")
    dyn_ms, dyn_eager, dyn_plain = kernel_times(dyn_args, _C)
    log(f"kernel time, dynamic path's state, T=1: {dyn_ms:.5f} ms (graph), "
        f"{dyn_eager:.5f} ms (eager), plain {dyn_plain:.4f} ms")
    dyn_work = kernel_bound(dyn_args, _C, "dynamic path's state")
    worst, flipped = max(worst, dyn_worst), flipped + dyn_flipped

    for C in (2, 5):
        for fstar_method in ("matheron", "chol"):
            timed(f"12 (two-stage sweep check, C={C}, {fstar_method})",
                  two_stage_check, dev, C, fstar_method)
    chain, ts_launches = timed("13 (two-stage path)", two_stage_path, rm, dev, smi)
    timed("14 (recovery)", recovery_check, chain, rm, dev, smi)
    del chain
    f10k_launches = timed("15 (fstar10k)", fstar10k, dev, smi)
    syn_launches, syn_args, syn16 = timed("16 (synthetic path)", synthetic_path, dev, smi)
    t = time.perf_counter()
    syn_plan = threshold_ess.launch_plan(syn_args[0].shape[2])
    syn_worst, syn_flipped = kernel_check(syn_args, "synthetic state")
    syn_ms, syn_eager, syn_plain = kernel_times(syn_args, _C, plain_reps=3)
    syn_work = kernel_bound(syn_args, _C, "synthetic state")
    log(f"kernel time, synthetic state (n={SYN_N}), T=1: {plan_label(syn_plan)}; "
        f"{syn_ms:.5f} ms (graph), {syn_eager:.5f} ms (eager), plain {syn_plain:.4f} ms "
        f"(3 calls); bound {syn_work['bound_ms']:.5f} ms by {syn_work['bound_by']}, "
        f"{100 * syn_work['bound_ms'] / syn_ms:.2f}% of it")
    phase_wall("16 (kernel at the synthetic state)", t)
    worst, flipped = max(worst, syn_worst), flipped + syn_flipped

    pc_worst, pc_flipped, ms_pc, ms_scalar = timed("17 (per-chain c)", per_chain_c,
                                                   rand_args)
    worst, flipped = max(worst, pc_worst), flipped + pc_flipped
    sweep_temps = torch.tensor(SWEEP_TEMPS)
    for C in (2, 5):
        timed(f"18 (tempered sweep check, C={C})", sweep_check, dev, C, "auto",
              sweep_temps)
    pt_launches, pt_args, pt_c, pt_sha, pt_means = timed("19 (tempering path)",
                                                         tempering_path, rm, dev, smi)
    t = time.perf_counter()
    pt_worst, pt_flipped = kernel_check(pt_args, "tempering state", c=pt_c)
    pt_ms, pt_eager, pt_plain = kernel_times(pt_args, pt_c)
    log(f"kernel time, tempering state (c per chain, T {temp_label((_C / pt_c) ** 2)}): "
        f"{pt_ms:.5f} ms (graph), {pt_eager:.5f} ms (eager), plain {pt_plain:.4f} ms")
    pt_work = kernel_bound(pt_args, pt_c, "tempering state")
    phase_wall("19 (kernel at the tempering state)", t)
    camp, camp_launches = timed("20 (campaigns8)", campaigns8, rm, dev, smi)
    camp_ref = timed("48's reference (campaigns8 at a rank's batch)",
                     campaign_blocks_reference, rm, dev)
    batch51 = timed("51 (a sweep's lanes against the batch)", batch_invariance_phase, rm,
                    dev, smi)
    c64_launches, _ = timed("21 (chains64)", chains64, rm, dev, smi)
    timed("22 (campaign agreement)", campaign_agreement, camp)

    for f_method, shared, temp in (("grid", True, None), ("grid", False, None),
                                   ("conjugate", True, sweep_temps),
                                   ("two_stage", True, None)):
        timed(f"23 (sweep check, {f_method}, constant_IRF={int(shared)})", shared_irf_check,
              dev, f_method, shared, temp)
    sh_launches, sh_args, sh_res = timed("24 (shared-IRF path)", shared_irf_path, dev, smi)
    t = time.perf_counter()
    sh_worst, sh_flipped = kernel_check(sh_args, "shared-IRF (pooled) state")
    sh_ms, sh_eager, sh_plain = kernel_times(sh_args, _C)
    log(f"kernel time, shared-IRF (pooled) state ({sh_args[2].numel()} lanes of "
        f"{sh_args[0].shape[2]} sites), T=1: {sh_ms:.5f} ms (graph), {sh_eager:.5f} ms "
        f"(eager), plain {sh_plain:.4f} ms")
    sh_work = kernel_bound(sh_args, _C, "shared-IRF (pooled) state")
    phase_wall("24 (kernel at the pooled state)", t)
    worst, flipped = max(worst, sh_worst), flipped + sh_flipped
    del sh_args
    timed("25 (shared-IRF recovery)", shared_irf_recovery, dev, smi)

    t = time.perf_counter()
    opt_errs = {label: option_check(dev, label, inputs, temp, it)
                for label, inputs, temp, it in OPTION_CHECKS}
    phase_wall("26 (sweep checks of the new blocks)", t)
    te_launches, te_args, te_res = timed("27 (ESS theta path)", theta_ess_path, rm, dev, smi,
                                         draws=TE_DRAWS)
    t = time.perf_counter()
    te_worst, te_flipped = kernel_check(te_args, "ESS theta path's state")
    te_ms, te_eager, te_plain = kernel_times(te_args, _C)
    log(f"kernel time, ESS theta path's state, T=1: {te_ms:.5f} ms (graph), "
        f"{te_eager:.5f} ms (eager), plain {te_plain:.4f} ms")
    te_work = kernel_bound(te_args, _C, "ESS theta path's state")
    phase_wall("27 (kernel at the ESS theta state)", t)
    worst, flipped = max(worst, te_worst), flipped + te_flipped
    del te_args
    il_launches, il_rate = timed("28 (interleave path)", interleave_path, rm, dev, smi)
    af_launches, af_ess_ratio, af_wall_ratio = timed("29 (affine path)", affine_path, rm,
                                                     dev, smi, draws=AF_DRAWS)
    past_worst, past_flipped, past_ms, past_plain, past_work, past_plan = timed(
        "30 (past the tile capacity)", past_capacity, dev, smi)
    worst, flipped = max(worst, past_worst), flipped + past_flipped

    ck_launches, main_state, ck_res = timed("31 (checkpointed main path)",
                                            checkpointed_main_path, rm, dev, smi, main_sha,
                                            main_rate)
    ckt_launches, pt_lanes = timed("32 (checkpointed tempering)", checkpointed_tempering, rm,
                                   dev, smi, pt_sha)
    syn_ck = timed("33 (synthetic checkpoint)", synthetic_checkpoint, dev, smi,
                   synthetic_inputs(dev))
    prof = timed("34 (profile_sweep)", profile_phase, rm, dev, smi, main_state)
    timed("35 (utilities)", utilities_phase, rm, dev, smi)

    walk, walk_launches, walk_args = timed("36 (walkthrough example)", walkthrough_phase,
                                           dev, smi, WALK_ARGV, WALK_RUN)
    t = time.perf_counter()
    walk_worst, walk_flipped = kernel_check(walk_args, "walkthrough state")
    walk_ms, walk_eager, walk_plain = kernel_times(walk_args, _C)
    walk_work = kernel_bound(walk_args, _C, "walkthrough state")
    walk_plan = plan_label(threshold_ess.launch_plan(walk_args[0].shape[2]))
    log(f"kernel time, walkthrough state ({walk_args[2].numel()} lanes of "
        f"{walk_args[0].shape[2]} sites), T=1: {walk_plan}; {walk_ms:.5f} ms (graph), {walk_eager:.5f} ms (eager), plain {walk_plain:.4f} ms")
    walk_r = walkthrough_agreement(walk)
    phase_wall("36 (kernel check and agreement)", t)
    worst, flipped = max(worst, walk_worst), flipped + walk_flipped
    sdo_ex = timed("37 (SDO example)", sdo_example_phase, dev, smi, SDO_EX_ARGV, SDO_EX_RUN)
    sdo_r = timed("37 (SDO agreement)", sdo_example_agreement, sdo_ex)

    fam_want = timed("52's references (each sweep family in one process)",
                     family_references, rm, dev)
    torch.cuda.empty_cache()  # the ranks share the card: the parent's cache held back
    two = timed("38, 39, 41-44, 46-48, 50, 52 (one world of 2 ranks)", two_rank_phases, rm,
                dev, smi, main_state, main_sha, main_cut_sha, main_means,
                phases=(38, 39, 41, 42, 43, 44, 46, 47, 48, 50, 52), mesh_smc=MESH_SMC,
                resp={"rates": {"phase 5": main_rate}, "syn16": syn16},
                later={"pt_sha": pt_sha, "camp20": camp, "camp_ref": camp_ref,
                       "families": fam_want})
    (sh_worst, sh_flipped), it2, cm = two[38], two[39], two[41]
    four = timed("40, 45 and 49 (one world of 4 ranks)", mesh_2x2, rm, dev, smi, main_means,
                 phases=(40, 45, 49), resp_smc=MESH_SMC, rates={"phase 5": main_rate,
                                             "phase 39": it2["sweeps_per_s"],
                                             "phase 43": two[43]["sweeps_per_s"]},
                 state=main_state, tempered={"lanes": pt_lanes, "means": pt_means})
    del main_state, pt_lanes
    mesh22 = four[40]
    worst = max(worst, sh_worst, it2["worst"], mesh22["worst"], two[46]["worst"],
                two[47]["worst"])
    flipped += sh_flipped + it2["flipped"] + mesh22["flipped"] + two[46]["flipped"] \
        + two[47]["flipped"]

    log(walls_line(PHASE_WALLS))
    log(json.dumps({"kernels": [{
        "name": "binary_threshold_ess",
        "route": "cuda",
        "source": "gpirt_tpu_torch/csrc/threshold_ess.cu",
        "replaces": "gpirt_tpu/ops/pallas_threshold.py:166",
        "launches": launches,
        "launches_per_main_path": launches,
        "max_abs_err": worst,
        "lanes_over_1e-5": flipped,
        "ms": ms,
        "ms_eager": eager,
        "plain_ms": plain,
        "bound_ms": work["bound_ms"],
        "bound_by": work["bound_by"],
        "share_of_bound": work["bound_ms"] / ms,
        "library_ms": None,
        "ms_random_T1": rand_times[1.0][0],
        "plain_ms_random_T1": rand_times[1.0][2],
        "ms_random_T64": rand_times[T_MAX][0],
        "plain_ms_random_T64": rand_times[T_MAX][2],
        **{k: v for k, v in work.items() if k not in ("bound_ms", "bound_by")},
        "launches_dynamic": dyn_launches,
        "max_abs_err_dynamic": dyn_worst,
        "lanes_over_1e-5_dynamic": dyn_flipped,
        "ms_dynamic_state": dyn_ms,
        "ms_eager_dynamic_state": dyn_eager,
        "plain_ms_dynamic_state": dyn_plain,
        "bound_ms_dynamic_state": dyn_work["bound_ms"],
        "bound_by_dynamic_state": dyn_work["bound_by"],
        "launches_two_stage": ts_launches,
        "launches_fstar10k": f10k_launches,
        "launches_synthetic": syn_launches,
        "max_abs_err_synthetic": syn_worst,
        "lanes_over_1e-5_synthetic": syn_flipped,
        "ms_synthetic_state": syn_ms,
        "ms_eager_synthetic_state": syn_eager,
        "plain_ms_synthetic_state": syn_plain,
        "bound_ms_synthetic_state": syn_work["bound_ms"],
        "bound_by_synthetic_state": syn_work["bound_by"],
        "rounds_mean_synthetic_state": syn_work["rounds_mean"],
        "path_synthetic_state": plan_label(syn_plan),
        "share_of_bound_synthetic_state": syn_work["bound_ms"] / syn_ms,
        "synthetic_sweeps_per_s": syn16["sweeps_per_s"],
        "synthetic_peak_gib": syn16["peak_gib"],
        "ms_random_per_chain_c": ms_pc,
        "ms_random_scalar_c": ms_scalar,
        "max_abs_err_random_per_chain_c": pc_worst,
        "lanes_over_1e-5_random_per_chain_c": pc_flipped,
        "launches_tempering": pt_launches,
        "max_abs_err_tempering": pt_worst,
        "lanes_over_1e-5_tempering": pt_flipped,
        "ms_tempering_state": pt_ms,
        "ms_eager_tempering_state": pt_eager,
        "plain_ms_tempering_state": pt_plain,
        "bound_ms_tempering_state": pt_work["bound_ms"],
        "bound_by_tempering_state": pt_work["bound_by"],
        "launches_campaigns8": camp_launches,
        "launches_chains64": c64_launches,
        "launches_constant_irf": sh_launches,
        "max_abs_err_pooled": sh_worst,
        "lanes_over_1e-5_pooled": sh_flipped,
        "ms_pooled_state": sh_ms,
        "ms_eager_pooled_state": sh_eager,
        "plain_ms_pooled_state": sh_plain,
        "bound_ms_pooled_state": sh_work["bound_ms"],
        "bound_by_pooled_state": sh_work["bound_by"],
        "rounds_mean_pooled_state": sh_work["rounds_mean"],
        "constant_irf_sweeps_per_s": sh_res["sweeps_per_s"],
        "constant_irf_fstar_ess_syncs_per_sweep": sh_res["fstar_ess_syncs_per_sweep"],
        "option_sweep_checks_max_abs_diff": {
            k: max(v[f] for f in ("f", "beta", "thresholds")) for k, v in opt_errs.items()},
        "launches_theta_ess": te_launches,
        "max_abs_err_theta_ess": te_worst,
        "lanes_over_1e-5_theta_ess": te_flipped,
        "ms_theta_ess_state": te_ms,
        "ms_eager_theta_ess_state": te_eager,
        "plain_ms_theta_ess_state": te_plain,
        "bound_ms_theta_ess_state": te_work["bound_ms"],
        "bound_by_theta_ess_state": te_work["bound_by"],
        "theta_ess_sweeps_per_s": te_res["sweeps_per_s"],
        "theta_ess_rounds_per_sweep": te_res["rounds_per_sweep"],
        "launches_interleave": il_launches,
        "interleave_sweeps_per_s": il_rate,
        "launches_affine": af_launches,
        "affine_within_ess_ratio": af_ess_ratio,
        "affine_wall_ratio": af_wall_ratio,
        "path_past_capacity": plan_label(past_plan),
        "max_abs_err_past_capacity": past_worst,
        "lanes_over_1e-5_past_capacity": past_flipped,
        "ms_past_capacity": past_ms,
        "plain_ms_past_capacity": past_plain,
        "bound_ms_past_capacity": past_work["bound_ms"],
        "bound_by_past_capacity": past_work["bound_by"],
        "launches_checkpointed": ck_launches,
        "checkpointed_sweeps_per_s": ck_res["sweeps_per_s"],
        "checkpoint_save_s": ck_res["save_s"],
        "checkpoint_bytes": ck_res["bytes_last"],
        "launches_checkpointed_tempering": ckt_launches,
        "synthetic_checkpoint_save_s": syn_ck[0],
        "synthetic_checkpoint_load_s": syn_ck[1],
        "synthetic_checkpoint_bytes": syn_ck[2],
        "profile_sweep_ms": {k: 1e3 * v for k, v in prof.items()},
        "launches_walkthrough": walk_launches,
        "max_abs_err_walkthrough": walk_worst,
        "lanes_over_1e-5_walkthrough": walk_flipped,
        "ms_walkthrough_state": walk_ms,
        "ms_eager_walkthrough_state": walk_eager,
        "plain_ms_walkthrough_state": walk_plain,
        "bound_ms_walkthrough_state": walk_work["bound_ms"],
        "bound_by_walkthrough_state": walk_work["bound_by"],
        "path_walkthrough_state": walk_plan,
        "walkthrough_sweeps_per_s": WALK_RUN / walk["seconds"],
        "walkthrough_r": walk_r,
        "sdo_example_sweeps_per_s": SDO_EX_RUN / sdo_ex["seconds"],
        "sdo_r": sdo_r,
        "max_abs_err_sharded_sweep_check": sh_worst,
        "lanes_over_1e-5_sharded_sweep_check": sh_flipped,
        **mesh_keys("items2", it2),
        **mesh_keys("mesh2x2", mesh22),
        "launches_chain_mesh": cm["launches"],
        "chain_mesh_draws_equal_phase5": cm["bitwise"],
        "chain_block_sweep_bitwise": cm["block_bitwise"],
        "chain_mesh_sweeps_per_s": cm["sweeps_per_s"],
        "replicated_draws_numbers": cm["draws_numbers"],
        "replicated_draws_ms": cm["draws_ms"],
        "resp_sweep_check_max_abs_diff": {
            k: max(v[f] for f in ("f", "beta", "thresholds", "fstar"))
            for k, v in two[42].items()},
        **resp_keys("resp2", two[43]),
        **resp_keys("resp_synthetic", two[44]),
        "resp_synthetic_r_phase16": two[44]["r_phase16"],
        **resp_keys("items2_resp2", four[45]),
        **later_keys(two[46], two[47], two[48], four[49]),
        "launches_resume_counts": two[50]["launches"],
        "launches_resume_counts_no_mesh": two[50]["launches_resumed_alone"],
        "resume_counts_r_no_mesh": two[50]["r_no_mesh"],
        "resume_counts_r_resp2": two[50]["r_resp2"],
        "batch_invariance_blocks_bitwise": batch51["blocks"],
        "batch_invariance_cases": batch51["labels"],
        "batch_invariance_families": batch51["families"],
        "launches_chain_mesh_families": two[52]["launches"],
        "launches_chain_mesh_families_one_process": two[52]["launches_one_process"],
        "launches_chain_mesh_families_cut": two[52]["launches_cut"],
        "launches_chain_mesh_families_resumed": two[52]["launches_resumed"],
        "chain_mesh_families_bitwise": two[52]["bitwise"],
    }, {
        "name": "ordinal_threshold_ess",
        "route": "cuda",
        "source": "gpirt_tpu_torch/csrc/ordinal_threshold_ess.cu",
        "replaces": "no TPU kernel: ops/ess.py::ess_update's host loop (the JAX package's "
                    "update is jnp, gpirt_tpu/models/gibbs.py:2231)",
        "launches": sdo_launches,
        "launches_per_sdo_path": sdo_launches,
        "path_sdo_state": ord_plan["path"],
        "max_abs_err": ord_worst,
        "lanes_over_1e-5": ord_flipped,
        "ms": ord_ms,
        "ms_eager": ord_eager,
        "plain_ms": ord_plain,
        "bound_ms": ord_work["bound_ms"],
        "bound_by": ord_work["bound_by"],
        "share_of_bound": ord_work["bound_ms"] / ord_ms,
        "library_ms": None,
        "ms_random_T1": ord_rand_times[1.0][0],
        "plain_ms_random_T1": ord_rand_times[1.0][2],
        "ms_random_T64": ord_rand_times[T_MAX][0],
        "plain_ms_random_T64": ord_rand_times[T_MAX][2],
        **{k: v for k, v in ord_work.items() if k not in ("bound_ms", "bound_by")},
        "sdo_sweeps_per_s": sdo_res["sweeps_per_s"],
        "sdo_syncs_per_sweep": sdo_res["syncs_per_sweep"],
        "launches_chain_mesh_families": two[52]["ordinal_launches"],
        "launches_chain_mesh_families_one_process": two[52]["ordinal_launches_one_process"],
    }]}))
    log(card())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--basins"]:
        sys.exit(basins_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--ess-layouts"]:
        sys.exit(ess_layouts_main())
    sys.exit(main())
