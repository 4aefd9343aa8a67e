"""Smoke run of the PyTorch port (gpirt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py     # needs one CUDA card and nvcc

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
     through gpirt_mcmc with 64 chains, burn 200 and 500 draws, f* stored;
     checked for finite ll and f*, ordered cutpoints that moved, and no
     binary kernel launch; prints the sweep rate, theta ESS and ESS per
     second, the ESS rounds per cutpoint update and the host syncs a sweep;
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
     the inputs of its last sweep (the kernel's streaming variant);
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
     burn 100 and 300 draws; checked for one kernel launch and one f* ESS
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
     64 chains from bench.py's spread init, burn 100 and 500 draws; checked
     for one kernel launch and one theta ESS a sweep and finite draws;
     prints the sweep rate, theta ESS and ESS per second, the theta ESS's
     rounds and host syncs a sweep, then phase 6 on the inputs of its last
     sweep;
 28. interleave path: senate116 through gpirt_mcmc(threshold_method=
     "interleave", threshold_ess_every=4, mix_subsweeps=2), 64 chains, burn
     100 and 500 draws: the kernel launched on every 4th sweep only (150 of
     600); prints the sweep rate and theta ESS;
 29. affine path: scripts/tune_bench.py's affine_shift_max=16,
     affine_rounds=2 and the moves off, senate116 through run_chains with
     64 chains from spread inits, burn 100 and 500 draws (tune_bench ran
     burn 500 and 1000 draws): one kernel launch a sweep each; prints each
     run's sweep rate, theta ESS, ESS per second and the moves' accept
     rates, and the ESS and wall ratios of on to off.
Each phase prints its wall time. A kernel time is the mean over 50
back-to-back launches captured in one CUDA graph and timed by CUDA events
after a warm-up ("ms"), and over 50
eager calls, which adds the wrapper's host time where that is the longer
("ms_eager"). The last lines are the kernels as JSON, the card as
nvidia-smi reports it, and {"ok": true, "device": {...}}.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from gpirt_tpu_torch import api, campaign_schedule, gpirt_campaigns, gpirt_mcmc  # noqa: E402
from gpirt_tpu_torch.api import (  # noqa: E402
    _recover_one,
    default_thresholds,
    full_fp32_matmuls,
    recover_fstar,
    recover_fstar_batch,
)
from gpirt_tpu_torch.models import affine, gibbs  # noqa: E402
from gpirt_tpu_torch.models.config import GPIRTConfig, make_constants  # noqa: E402
from gpirt_tpu_torch.models.sampler import run_chains  # noqa: E402
from gpirt_tpu_torch.ops import threshold_ess  # noqa: E402
from gpirt_tpu_torch.ops.ess import ess_update  # noqa: E402
from gpirt_tpu_torch.ops.likelihood import cutpoint_bounds  # noqa: E402
from gpirt_tpu_torch.parallel.smc import WARM_STEPS  # noqa: E402
from gpirt_tpu_torch.utils.datasets import (  # noqa: E402
    load_sdo,
    senate116_response_matrix,
    simulate_2pl,
    simulate_dynamic,
)
from gpirt_tpu_torch.utils.diagnostics import (  # noqa: E402
    align_theta_signs,
    effective_sample_size,
    effective_sample_size_device,
    split_rhat,
)
from gpirt_tpu_torch.utils.response import (  # noqa: E402
    as_response_matrix,
    encode_categories,
    recode_cube,
)

K, SMC_STEPS, T_MAX, BURN, DRAWS, SEED = 64, 320, 64.0, 100, 500, 1
SDO_BURN, SDO_DRAWS = 200, 500
# bench.py::bench_dynamic's data, regime and run lengths
DYN_N, DYN_M, DYN_H, DYN_LS, DYN_BURN, DYN_DRAWS = 150, 60, 10, 2.0, 100, 300
DYN_VOTES = {"yea": 1, "nay": 0, "missing": None}
TS_BURN, TS_DRAWS = 100, 200  # the two-stage path on senate116
# bench.py::bench_fstar10k and bench_synthetic (64 chains, not bench's 4:
# those were a 16 GB TPU's limit)
F10K_N, F10K_M, F10K_GRID = 100, 50, 10001
SYN_N, SYN_M, SYN_MISSING, SYN_K, SYN_BURN, SYN_DRAWS = 5000, 1000, 0.1, 64, 30, 150
# the tempering path (gpirt_mcmc's n_temps), bench.py::bench_chains64 and
# bench_campaigns8 on senate116
PT_TEMPS, PT_MAX_TEMP, PT_BURN, PT_DRAWS = 4, 4.0, 100, 500
C64_BURN, C64_DRAWS = 100, 300
CAMPAIGNS, CAMPAIGN_WARM_SEED, CAMPAIGN_SEED = 8, 990001, 100000
CAMPAIGN_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                                "fixtures", "campaigns8_senate116_jax.npz")
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


def c_of(temp):
    """The kernel's scale 1/sqrt(2 T): a float, or a (K,) tensor of one a
    chain for a (K,) tensor of temperatures."""
    return _C / (torch.sqrt(temp) if torch.is_tensor(temp) else np.sqrt(temp))


def temp_label(temp):
    if torch.is_tensor(temp):
        return f"per chain {float(temp.min()):g} to {float(temp.max()):g}"
    return f"{temp:g}"


def kernel_check(args, label, temps=(1.0, T_MAX), c=None):
    """The kernel against its plain version on ``args``: at most 0.1% of
    lanes over 1e-5 (a near-tie accept may flip, the site sum being taken
    in another order), finite, and most lanes moved; at each of ``temps``
    (a temperature may be a (K,) tensor of one a chain), or at the scale
    ``c`` alone when it is given. Returns the largest error of the other
    lanes and the count of lanes over 1e-5."""
    L = args[2].numel()
    worst, flipped = 0.0, 0
    scales = ([(temp_label(t), c_of(t)) for t in temps] if c is None
              else [(f"{temp_label((_C / c) ** 2)} (c as given)", c)])
    for tl, c in scales:
        got = threshold_ess.binary_threshold_ess(*args, c)
        torch.cuda.synchronize()
        want = threshold_ess.binary_threshold_ess_reference(*args, c)
        torch.cuda.synchronize()
        err = (got - want).abs()
        over = int((err > 1e-5).sum())
        check(bool(torch.isfinite(got).all()), f"{label}: kernel output not finite")
        check(over <= 0.001 * L, f"{label} T={tl}: {over} of {L} lanes "
              "differ by more than 1e-5")
        check(float((got != args[2]).float().mean()) > 0.8, f"{label}: lanes did not move")
        rest = float(err[err <= 1e-5].max())
        worst, flipped = max(worst, rest), flipped + over
        log(f"kernel check, {label}, T={tl}: lanes={L} over_1e-5={over} "
            f"max_abs_err(rest)={rest:.3g}")
    return worst, flipped


def kernel_times(args, c, plain_reps=10):
    """(graph ms, eager ms, plain ms) of one update of ``args``."""
    ms = graph_ms(lambda: threshold_ess.binary_threshold_ess(*args, c))
    eager = loop_ms(lambda: threshold_ess.binary_threshold_ess(*args, c))
    plain = loop_ms(lambda: threshold_ess.binary_threshold_ess_reference(*args, c),
                    reps=plain_reps)
    return ms, eager, plain


def lane_rounds(g, y, t1, nu, logu, eps0, rs, c):
    """Each lane's proposals up to its accept, R for a lane at the cap, and
    the mask of lanes at the cap: a copy of the plain version's loop
    (gpirt_tpu_torch/ops/threshold_ess.py) that counts; ``c`` a float or a
    (K,) tensor."""
    if torch.is_tensor(c):
        c = c.reshape(-1, 1, 1, 1)
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
    rounds = torch.full(t1.shape, R, dtype=torch.int64, device=t1.device)
    active = torch.ones_like(t1, dtype=torch.bool)
    for r in range(R):
        if not bool(active.any()):
            break
        prop = t1 * torch.cos(eps) + nu * torch.sin(eps)
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
    evaluated once per ll."""
    g, y, t1 = args[0], args[1], args[2]
    rounds, capped = lane_rounds(*args, c)
    n_obs = (y > 0).sum(dim=1)  # (H, m), shared by the chains
    site_evals = int(((1 + rounds) * n_obs).sum())
    shrinks = int(torch.where(capped, rounds, rounds - 1).sum())
    L = t1.numel()
    nbytes = 4 * (g.numel() + y.numel() + 5 * L + shrinks + g.shape[0])
    ops = OPS_PER_SITE * site_evals
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = ops / FP32_OPS_PER_S * 1e3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    sfu_ms = SFU_PER_SITE * site_evals / (SFU_PER_CLOCK_PER_SM * sms * clock_hz) * 1e3
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


def observe_kernel(run, before_call=None, kernel=None, scales=None):
    """Runs ``run()`` with the sweep's call of the kernel wrapper (through
    gibbs, once a sweep) observed: ``before_call(i)``, when given, runs
    before the i-th call, ``kernel``, when given, is called in the
    wrapper's place, and each call's c is appended to the list ``scales``
    when one is given. Returns run's result and the inputs of the last
    call."""
    seen = {"calls": 0, "args": None}
    wrapper = gibbs.binary_threshold_ess
    launch = wrapper if kernel is None else kernel

    def observe(*args):
        if before_call is not None:
            before_call(seen["calls"])
        if scales is not None:
            scales.append(args[7])
        seen["calls"] += 1
        seen["args"] = args[:7]
        return launch(*args)

    gibbs.binary_threshold_ess = observe
    try:
        out = run()
    finally:
        gibbs.binary_threshold_ess = wrapper
    return out, seen["args"]


def main_path(rm, dev, smi):
    """Returns the kernel's launches in the run and its inputs at the last
    sweep."""
    threshold_ess.binary_threshold_ess.launches = 0
    out, state_args = observe_kernel(lambda: gpirt_mcmc(
        rm, DRAWS, BURN, CHAIN=K, SEED=SEED, smc_steps=SMC_STEPS,
        smc_max_temp=T_MAX, dtype="float32", device=dev))
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
    return launches, state_args


def sdo_path(dev, smi):
    """gpirt_mcmc on the SDO survey, checked; prints its rates and counts."""
    launches = threshold_ess.binary_threshold_ess.launches
    ess_update.calls = ess_update.rounds = ess_update.syncs = 0
    data = load_sdo()
    out = gpirt_mcmc(data, SDO_DRAWS, SDO_BURN, CHAIN=K, SEED=SEED, vote_codes=None,
                     store_fstar=True, dtype="float32", device=dev)
    sweeps = SDO_BURN + SDO_DRAWS
    check(threshold_ess.binary_threshold_ess.launches == launches,
          "the binary kernel was launched on the ordinal path")
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
        "rounds_per_update": ess_update.rounds / ess_update.calls,
        "syncs_per_sweep": ess_update.syncs / sweeps,
    }
    log(f"SDO path on {smi}: {n} x {m}, C={C}, {K} chains, {sweeps} sweeps in "
        f"{samp_s:.3f} s ({res['sweeps_per_s']:.2f} sweeps/s, f* stored); theta ESS "
        f"median within-chain (summed over {K} chains) {within_med:.1f}, pooled "
        f"{pooled_med:.1f}; ess/sec {res['ess_per_s']:.2f}; cutpoint ESS "
        f"{ess_update.calls} updates, {res['rounds_per_update']:.2f} rounds an update, "
        f"{res['syncs_per_sweep']:.2f} host syncs a sweep; binary kernel launches 0")


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


def synthetic_inputs(dev, n=SYN_N, m=SYN_M, K=SYN_K):
    """bench.py::bench_synthetic's data, configuration and inits on ``dev``:
    (y (1, n, m) int32, theta inits (K, 1, n), cutpoints (1, m, 3), constants,
    config)."""
    _, raw = simulate_2pl(0, n=n, m=m, missing=SYN_MISSING)
    y, C, _ = encode_categories(raw)
    cfg = GPIRTConfig(n=n, m=m, horizon=1, C=C, dtype="float32")
    consts = make_constants(cfg, np.zeros((3, m)), np.full((3, m), 3.0),
                            np.zeros((2, n)), np.zeros((2, n)), device=dev)
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


def synthetic_path(dev, smi):
    """The synthetic configuration at full size, checked; prints its rates,
    theta ESS and peak memory. Returns the kernel's launches and its inputs
    at the last sweep."""
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
    log(f"synthetic path on {smi}: {SYN_N} x {SYN_M} binary ({SYN_MISSING:g} missing), "
        f"conjugate, {SYN_K} chains, {sweeps} sweeps in {wall:.3f} s ({sweeps / wall:.3f} "
        f"sweeps/s); {launches} kernel launches; peak device memory "
        f"{peak / 2**30:.3f} GiB (torch.cuda.max_memory_allocated); theta ESS median "
        f"within-chain (summed over {SYN_K} chains) {within:.1f}, pooled {pooled:.1f}; "
        f"ess/sec {within / wall:.3f} within, {pooled / wall:.3f} pooled (sampling wall)")
    return launches, args


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


def tempering_path(rm, dev, smi, chains=K, burn=PT_BURN, draws=PT_DRAWS):
    """Phase 19: gpirt_mcmc with n_temps on senate116, checked; prints its
    swap rates, cold theta ESS and sweep rate. Returns the kernel's
    launches, the inputs of its last call and that call's per-chain c."""
    scales = []
    threshold_ess.binary_threshold_ess.launches = 0
    out, args = observe_kernel(lambda: gpirt_mcmc(
        rm, draws, burn, CHAIN=chains, SEED=SEED, n_temps=PT_TEMPS,
        max_temp=PT_MAX_TEMP, swap_every=1, dtype="float32", device=dev,
        verbose=False), scales=scales)
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
    return launches, args, scales[-1]


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


def shared_irf_path(dev, smi):
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
            lambda: gpirt_mcmc(raw, DYN_DRAWS, DYN_BURN, CHAIN=K, SEED=SEED,
                               vote_codes=DYN_VOTES, theta_ls=DYN_LS, theta_init=init,
                               constant_IRF=1, dtype="float32", device=dev))
    finally:
        gibbs.draw_fstar_direct = direct
    peak = torch.cuda.max_memory_allocated()
    launches = threshold_ess.binary_threshold_ess.launches
    sweeps = DYN_BURN + DYN_DRAWS
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
    check(ll.shape == (K, DYN_DRAWS) and np.isfinite(ll).all(), "shared-IRF ll not finite")
    check(np.isfinite(thr[..., 1, :]).all(), "shared-IRF cutpoints not finite")
    check(bool((thr[..., 1, :] == thr[..., 1, :1]).all()), "cutpoints differ between sessions")
    check(np.mean(thr[:, -1, :, 1, 0] != 0.0) > 0.99, "shared-IRF cutpoints did not move")
    varies = np.mean(np.ptp(theta, axis=-1) > 0)
    check(varies > 0.5, f"theta differs between sessions in {varies:.3f} of draws")
    samp_s = out[0]["seconds"]["sampling"]
    within, pooled = theta_ess(theta.reshape(K, DYN_DRAWS, -1), dev)
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


def tie_rule(label, cfg, s_gpu, s_cpu, snap_cpu, run64, perturbed):
    """PERF.md section 2's rule for a theta decision that differs between
    the card and the CPU: the chains whose theta differs are found, the
    float64 run's snap margin of the differing sites is printed (under the
    ESS theta update), and a chain is let through only when the CPU's own
    float32 run, its inputs moved by one rounding (``perturbed``, a list of
    (theta_idx, snap argument)), moves that decision: its theta changes, or
    the snapped value moves by more than the margin. Returns the chains
    whose other fields are compared."""
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
        check(flipped, f"theta differs beyond a float32 tie ({label}, chain {k})")
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


def timed(label, fn, *args):
    """fn(*args), its wall time printed under ``label``."""
    t = time.perf_counter()
    out = fn(*args)
    log(f"phase {label}: {time.perf_counter() - t:.2f} s wall")
    return out


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
    launches, state_args = timed("5 (main path)", main_path, rm, dev, smi)

    w, f = kernel_check(state_args, "main path's state")
    worst, flipped = max(worst, w), flipped + f
    ms, eager, plain = kernel_times(state_args, _C)
    log(f"kernel time, main path's state, T=1: {ms:.5f} ms (graph), "
        f"{eager:.5f} ms (eager), plain {plain:.4f} ms")
    work = kernel_bound(state_args, _C)
    for method in ("ess", "newton"):
        timed(f"7 (C=5 sweep check, {method})", sweep_check, dev, 5, method)
    timed("8 (SDO path)", sdo_path, dev, smi)
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
    syn_launches, syn_args = timed("16 (synthetic path)", synthetic_path, dev, smi)
    t = time.perf_counter()
    syn_worst, syn_flipped = kernel_check(syn_args, "synthetic state")
    syn_ms, syn_eager, syn_plain = kernel_times(syn_args, _C, plain_reps=3)
    log(f"kernel time, synthetic state (streaming variant, n={SYN_N}), T=1: "
        f"{syn_ms:.5f} ms (graph), {syn_eager:.5f} ms (eager), plain {syn_plain:.4f} ms "
        f"(3 calls)")
    syn_work = kernel_bound(syn_args, _C, "synthetic state")
    log(f"phase 16 (kernel at the synthetic state): {time.perf_counter() - t:.2f} s wall")
    worst, flipped = max(worst, syn_worst), flipped + syn_flipped

    pc_worst, pc_flipped, ms_pc, ms_scalar = timed("17 (per-chain c)", per_chain_c,
                                                   rand_args)
    worst, flipped = max(worst, pc_worst), flipped + pc_flipped
    sweep_temps = torch.tensor(SWEEP_TEMPS)
    for C in (2, 5):
        timed(f"18 (tempered sweep check, C={C})", sweep_check, dev, C, "auto",
              sweep_temps)
    pt_launches, pt_args, pt_c = timed("19 (tempering path)", tempering_path, rm, dev, smi)
    t = time.perf_counter()
    pt_worst, pt_flipped = kernel_check(pt_args, "tempering state", c=pt_c)
    pt_ms, pt_eager, pt_plain = kernel_times(pt_args, pt_c)
    log(f"kernel time, tempering state (c per chain, T {temp_label((_C / pt_c) ** 2)}): "
        f"{pt_ms:.5f} ms (graph), {pt_eager:.5f} ms (eager), plain {pt_plain:.4f} ms")
    pt_work = kernel_bound(pt_args, pt_c, "tempering state")
    log(f"phase 19 (kernel at the tempering state): {time.perf_counter() - t:.2f} s wall")
    camp, camp_launches = timed("20 (campaigns8)", campaigns8, rm, dev, smi)
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
    log(f"phase 24 (kernel at the pooled state): {time.perf_counter() - t:.2f} s wall")
    worst, flipped = max(worst, sh_worst), flipped + sh_flipped
    del sh_args
    timed("25 (shared-IRF recovery)", shared_irf_recovery, dev, smi)

    t = time.perf_counter()
    opt_errs = {label: option_check(dev, label, inputs, temp, it)
                for label, inputs, temp, it in OPTION_CHECKS}
    log(f"phase 26 (sweep checks of the new blocks): {time.perf_counter() - t:.2f} s wall")
    te_launches, te_args, te_res = timed("27 (ESS theta path)", theta_ess_path, rm, dev, smi)
    t = time.perf_counter()
    te_worst, te_flipped = kernel_check(te_args, "ESS theta path's state")
    te_ms, te_eager, te_plain = kernel_times(te_args, _C)
    log(f"kernel time, ESS theta path's state, T=1: {te_ms:.5f} ms (graph), "
        f"{te_eager:.5f} ms (eager), plain {te_plain:.4f} ms")
    te_work = kernel_bound(te_args, _C, "ESS theta path's state")
    log(f"phase 27 (kernel at the ESS theta state): {time.perf_counter() - t:.2f} s wall")
    worst, flipped = max(worst, te_worst), flipped + te_flipped
    del te_args
    il_launches, il_rate = timed("28 (interleave path)", interleave_path, rm, dev, smi)
    af_launches, af_ess_ratio, af_wall_ratio = timed("29 (affine path)", affine_path, rm,
                                                     dev, smi)

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
    }]}))
    log(card())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
