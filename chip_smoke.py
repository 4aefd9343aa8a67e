"""Smoke run of the PyTorch port (gpirt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py     # needs one CUDA card and nvcc

Phases, each of which stops the run with a non-zero exit on failure:
  1. device: a CUDA card is required; its name and power limit are printed;
  2. build: the CUDA kernel is compiled from gpirt_tpu_torch/csrc (timed);
  3. kernel check: the binary cutpoint ESS kernel against its plain PyTorch
     version at the main path's shape (64 chains x senate116's 418 items,
     100 respondents, float32), untempered and at T = 64, with both times;
  4. sweep check: one small sweep on the card against the same sweep on
     the CPU, from the same state and draws;
  5. main path: senate116 through gpirt_mcmc with 64 chains, 320 SMC steps
     from T = 64, burn 100 and 500 draws, checked for finite output and for
     one kernel launch per sweep; prints phase times, sweep rate and theta
     ESS per second.
The last two lines are the card as nvidia-smi reports it and
{"ok": true, "device": {...}}.
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
_C = 0.7071067811865476
_TWO_PI = 6.283185307179586


def log(msg):
    print(msg, flush=True)


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def median_ms(fn, reps=20, warmup=2):
    """Median of ``reps`` single-call times by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def kernel_check(y_dev):
    """The kernel against its plain version at the main path's lane shape,
    on senate116's responses and random lane state from a seed."""
    H, n, m = y_dev.shape
    dev = y_dev.device
    gen = torch.Generator(device=dev).manual_seed(0)
    L = K * H * m

    def rand(*s):
        return torch.rand(s, generator=gen, device=dev)

    def randn(*s):
        return torch.randn(s, generator=gen, device=dev)

    g = 1.5 * randn(K, H, n, m)
    args = (g, y_dev, randn(K, H, m), randn(K, H, m), torch.log(rand(K, H, m)),
            rand(K, H, m) * _TWO_PI, rand(64, K, H, m))
    worst, flipped, times = 0.0, 0, {}
    for temp in (1.0, T_MAX):
        c = _C / np.sqrt(temp)
        got = threshold_ess.binary_threshold_ess(*args, c)
        torch.cuda.synchronize()
        want = threshold_ess.binary_threshold_ess_reference(*args, c)
        torch.cuda.synchronize()
        err = (got - want).abs()
        over = int((err > 1e-5).sum())
        check(bool(torch.isfinite(got).all()), "kernel output not finite")
        check(over <= 0.001 * L,
              f"T={temp}: {over} of {L} lanes differ by more than 1e-5")
        check(float((got != args[2]).float().mean()) > 0.8, "lanes did not move")
        worst = max(worst, float(err[err <= 1e-5].max()))
        flipped += over
        ms = median_ms(lambda: threshold_ess.binary_threshold_ess(*args, c))
        plain_ms = median_ms(
            lambda: threshold_ess.binary_threshold_ess_reference(*args, c))
        times[temp] = (ms, plain_ms)
        log(f"kernel check T={temp:g}: lanes={L} over_1e-5={over} "
            f"max_abs_err(rest)={worst:.3g} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
    return worst, flipped, times


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


def main_path(rm, dev, smi):
    threshold_ess.binary_threshold_ess.launches = 0
    out = gpirt_mcmc(rm, DRAWS, BURN, CHAIN=K, SEED=SEED, smc_steps=SMC_STEPS,
                     smc_max_temp=T_MAX, dtype="float32", device=dev)
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
    return launches


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
    worst, flipped, times = kernel_check(y_dev)
    sweep_check(dev)
    launches = main_path(rm, dev, smi)

    ms, plain_ms = times[1.0]
    log(json.dumps({"kernels": [{
        "name": "binary_threshold_ess",
        "route": "cuda",
        "source": "gpirt_tpu_torch/csrc/threshold_ess.cu",
        "replaces": "gpirt_tpu/ops/pallas_threshold.py:166",
        "launches": launches,
        "max_abs_err": worst,
        "lanes_over_1e-5": flipped,
        "ms": ms,
        "plain_ms": plain_ms,
        "ms_T64": times[T_MAX][0],
        "plain_ms_T64": times[T_MAX][1],
    }]}))
    log(card())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
