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
     each lane's rounds, the work they need and the bound it gives.
A kernel time is the mean over 50 back-to-back launches captured in one
CUDA graph and timed by CUDA events after a warm-up ("ms"), and over 50
eager calls, which adds the wrapper's host time where that is the longer
("ms_eager"). The last lines are the kernels as JSON, the card as
nvidia-smi reports it, and {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from gpirt_tpu_torch import gpirt_mcmc  # noqa: E402
from gpirt_tpu_torch.api import full_fp32_matmuls  # noqa: E402
from gpirt_tpu_torch.models import gibbs  # noqa: E402
from gpirt_tpu_torch.models.config import GPIRTConfig, make_constants  # noqa: E402
from gpirt_tpu_torch.ops import threshold_ess  # noqa: E402
from gpirt_tpu_torch.parallel.smc import WARM_STEPS  # noqa: E402
from gpirt_tpu_torch.utils.datasets import senate116_response_matrix  # noqa: E402
from gpirt_tpu_torch.utils.diagnostics import effective_sample_size_device  # noqa: E402
from gpirt_tpu_torch.utils.response import encode_categories  # noqa: E402

K, SMC_STEPS, T_MAX, BURN, DRAWS, SEED = 64, 320, 64.0, 100, 500, 1
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


def kernel_check(args, label, temps=(1.0, T_MAX)):
    """The kernel against its plain version on ``args``: at most 0.1% of
    lanes over 1e-5 (a near-tie accept may flip, the site sum being taken
    in another order), finite, and most lanes moved. Returns the largest
    error of the other lanes and the count of lanes over 1e-5."""
    L = args[2].numel()
    worst, flipped = 0.0, 0
    for temp in temps:
        c = _C / np.sqrt(temp)
        got = threshold_ess.binary_threshold_ess(*args, c)
        torch.cuda.synchronize()
        want = threshold_ess.binary_threshold_ess_reference(*args, c)
        torch.cuda.synchronize()
        err = (got - want).abs()
        over = int((err > 1e-5).sum())
        check(bool(torch.isfinite(got).all()), f"{label}: kernel output not finite")
        check(over <= 0.001 * L,
              f"{label} T={temp:g}: {over} of {L} lanes differ by more than 1e-5")
        check(float((got != args[2]).float().mean()) > 0.8, f"{label}: lanes did not move")
        rest = float(err[err <= 1e-5].max())
        worst, flipped = max(worst, rest), flipped + over
        log(f"kernel check, {label}, T={temp:g}: lanes={L} over_1e-5={over} "
            f"max_abs_err(rest)={rest:.3g}")
    return worst, flipped


def kernel_times(args, c):
    """(graph ms, eager ms, plain ms) of one update of ``args``."""
    ms = graph_ms(lambda: threshold_ess.binary_threshold_ess(*args, c))
    eager = loop_ms(lambda: threshold_ess.binary_threshold_ess(*args, c))
    plain = loop_ms(
        lambda: threshold_ess.binary_threshold_ess_reference(*args, c), reps=10)
    return ms, eager, plain


def lane_rounds(g, y, t1, nu, logu, eps0, rs, c):
    """Each lane's proposals up to its accept, R for a lane at the cap, and
    the mask of lanes at the cap: a copy of the plain version's loop
    (gpirt_tpu_torch/ops/threshold_ess.py) that counts."""
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


def kernel_bound(args, c):
    """The work this launch needs and the least time the card could take
    for it: each input read once (of rs, the values a shrink uses), the
    output written once, and every observed site evaluated once per ll."""
    g, y, t1 = args[0], args[1], args[2]
    rounds, capped = lane_rounds(*args, c)
    n_obs = (y > 0).sum(dim=1)  # (H, m), shared by the chains
    site_evals = int(((1 + rounds) * n_obs).sum())
    shrinks = int(torch.where(capped, rounds, rounds - 1).sum())
    L = t1.numel()
    nbytes = 4 * (g.numel() + y.numel() + 5 * L + shrinks)
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
    log(f"kernel work at the main path's state: rounds per lane mean "
        f"{work['rounds_mean']:.3f} p99 {work['rounds_p99']:.0f} max "
        f"{work['rounds_max']} ({work['lanes_at_cap']} at the cap); "
        f"{site_evals} site evaluations, {ops} FP32 operations, {nbytes} bytes; "
        f"bound {work['bound_ms']:.5f} ms by {work['bound_by']} "
        f"(bytes {mem_ms:.5f} ms, operations {op_ms:.5f} ms, special-function "
        f"pipes {sfu_ms:.5f} ms at {sms} SMs x {clock_hz / 1e6:.0f} MHz)")
    return work


def sweep_check(dev):
    """One tempered sweep on the card against the CPU, same state and draws."""
    Ks, n, m, N = 3, 12, 9, 101
    rng = np.random.default_rng(1)
    y = np.where(rng.random((1, n, m)) < 0.5, 2, 1).astype(np.int32)
    y[0, 0, :3] = 0
    cfg = GPIRTConfig(n=n, m=m, grid_size=N, dtype="float32", jitter=1e-5)
    priors = (np.zeros((3, m)), np.full((3, m), 3.0), np.zeros((2, n)),
              np.zeros((2, n)))
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(0)
    consts = {d: make_constants(cfg, *priors, device=d) for d in (cpu, dev)}
    state0 = gibbs.init_state(
        torch.as_tensor(rng.uniform(-1, 1, (Ks, 1, n))),
        torch.as_tensor(np.tile([-np.inf, 0.0, np.inf], (1, m, 1))),
        consts[cpu], cfg, gibbs.init_draws(gen, Ks, consts[cpu], cfg))
    draws = gibbs.sweep_draws(gen, Ks, consts[cpu], cfg)
    res = {}
    for d in (cpu, dev):
        res[d] = gibbs.gibbs_sweep(
            gibbs.GPIRTState(*(a.to(d) for a in state0)),
            gibbs.SweepDraws(*(a.to(d) for a in draws)),
            torch.as_tensor(y, device=d), consts[d], cfg, temp=4.0)
    torch.cuda.synchronize()
    (s_cpu, _), (s_gpu, _) = res[cpu], res[dev]
    check(torch.equal(s_cpu.theta_idx, s_gpu.theta_idx.cpu()), "sweep theta differs")
    err = max(float((b.cpu() - a).abs().max()) for a, b in zip(s_cpu[1:], s_gpu[1:]))
    check(err < 1e-3, f"sweep state differs by {err}")
    log(f"sweep check (card vs CPU, float32, T=4): theta equal, max abs diff {err:.3g}")


def observe_kernel(run, before_call=None, kernel=None):
    """Runs ``run()`` with the sweep's call of the kernel wrapper (through
    gibbs, once a sweep) observed: ``before_call(i)``, when given, runs
    before the i-th call, and ``kernel``, when given, is called in the
    wrapper's place. Returns run's result and the inputs of the last call."""
    seen = {"calls": 0, "args": None}
    wrapper = gibbs.binary_threshold_ess
    launch = wrapper if kernel is None else kernel

    def observe(*args):
        if before_call is not None:
            before_call(seen["calls"])
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
    worst, flipped = kernel_check(rand_args, "random lanes")
    rand_times = {t: kernel_times(rand_args, _C / np.sqrt(t)) for t in (1.0, T_MAX)}
    for t, (ms, eager, plain) in rand_times.items():
        log(f"kernel time, random lanes, T={t:g}: {ms:.5f} ms (graph), "
            f"{eager:.5f} ms (eager), plain {plain:.4f} ms")
    sweep_check(dev)
    launches, state_args = main_path(rm, dev, smi)

    w, f = kernel_check(state_args, "main path's state")
    worst, flipped = max(worst, w), flipped + f
    ms, eager, plain = kernel_times(state_args, _C)
    log(f"kernel time, main path's state, T=1: {ms:.5f} ms (graph), "
        f"{eager:.5f} ms (eager), plain {plain:.4f} ms")
    work = kernel_bound(state_args, _C)

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
    }]}))
    log(card())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
