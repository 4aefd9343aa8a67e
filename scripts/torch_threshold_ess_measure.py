"""The port's binary cutpoint ESS kernel on one CUDA card: an A/B against
other builds of it, where its time goes, and a profile of senate116's
sampling sweeps.

    python3 scripts/torch_threshold_ess_measure.py [--state main|synthetic]
        [--other OTHER.cu ...] [--sass]
        [--end-to-end] [--anatomy] [--profile [--trace-dir DIR]]

With --state main (the default) runs senate116's main path through
gpirt_mcmc (64 chains, 320 SMC steps from T = 64, then 40 sampling sweeps)
and keeps the kernel's inputs of the last sweep. With --state synthetic
runs chip_smoke.py's phase 16 configuration (simulate_2pl(0, 5000, 1000,
missing=0.1), 64 chains, the conjugate sampler through run_chains) for 30
burn and 10 sampling sweeps and keeps the kernel's inputs of the last
sweep, where the kernel takes its tile path; there --other times its
builds at that state (T = 1 and 64), and --anatomy splits the time there
too. Prints the card's name and power limit first.

--profile  times sampling sweeps 6-20 by the host clock (a synchronise at
           each end) and traces sweeps 21-30 with torch.profiler, started
           and stopped at the kernel's calls so that the window is exactly
           ten sweeps; prints device time per sweep by operator and the
           device's busy share, and with --trace-dir writes the profiler's
           table and its Chrome trace into DIR.
--other    builds OTHER.cu, a kernel source with the same C entry
           gpirt_binary_threshold_ess (for example an earlier commit's
           csrc/threshold_ess.cu), into a library of its own and times it
           against this checkout's kernel in turns (other, this, this,
           other), each checked against the plain version first, at the
           main path's state (T = 1) and on random lanes (T = 1 and 64).
           Each time is 50 launches in one CUDA graph, by CUDA events.
           May be given more than once. To time another design of the
           kernel, give it an edited copy of csrc/threshold_ess.cu.
--sass     disassembles this checkout's build (cuobjdump -sass) and, for
           the tile path's kernel, counts the instructions of the loop that
           evaluates the sites (the loop densest in MUFU.EX2, one a site in
           erff) and prints them per site; with --trace-dir writes the
           kernel's SASS there.
--end-to-end  with --other: the main path itself (SMC, then 300 sampling
           sweeps) with each build in turn, eight runs of each in the order
           other, this, this, other, ...; prints the SMC and sampling
           sweeps/s of every run and their medians.
--anatomy  times this kernel at the main path's state (T = 1) as drawn,
           with every lane taking its first proposal (log u = -inf: two
           evaluations of ll a lane), and with no observed site (y = 0: the
           slab is loaded but no site is evaluated), and splits the time
           into a part per evaluation of ll and a part per launch; then
           with the first n' respondents only (n' = 1, 25, 50), and the
           kernel's own device time by torch.profiler over 20 launches.
"""

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    _C,
    K,
    SEED,
    SMC_STEPS,
    SYN_BURN,
    T_MAX,
    card,
    check,
    graph_ms,
    kernel_bound,
    lane_rounds,
    log,
    observe_kernel,
    random_lanes,
    synthetic_inputs,
    synthetic_run,
)
from gpirt_tpu_torch import gpirt_mcmc  # noqa: E402
from gpirt_tpu_torch.ops import threshold_ess  # noqa: E402
from gpirt_tpu_torch.parallel.smc import WARM_STEPS  # noqa: E402
from gpirt_tpu_torch.utils.datasets import senate116_response_matrix  # noqa: E402
from gpirt_tpu_torch.utils.response import encode_categories  # noqa: E402

SAMPLING = 40
SYN_STATE_DRAWS = 10  # sampling sweeps of --state synthetic after its burn
E2E_SWEEPS = 300
WALL_FROM, PROF_FROM, PROF_TO = 5, 20, 30  # sampling-sweep indices


def build_other(src):
    """nvcc ``src`` into its own library under gpirt_tpu_torch/_build/."""
    with open(src, "rb") as fh:
        tag = hashlib.sha256(fh.read()).hexdigest()[:16]
    path = os.path.join(threshold_ess._BUILD, f"libab_{tag}.so")
    t = time.perf_counter()
    threshold_ess.compile_library([src], path)
    log(f"built {src} in {time.perf_counter() - t:.1f} s")
    return threshold_ess.load_library(path)


_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def site_loop_sass(trace_dir=None, kernel="ess_tile_kernel"):
    """The instructions of ``kernel``'s site loop in this checkout's build
    (:func:`threshold_ess.library_path`): of the loops (a branch back to a
    lower address), the one with the most MUFU.EX2 an instruction. Returns
    (instructions, MUFU.EX2) of its body."""
    lib = threshold_ess.library_path()
    tool = os.path.join(os.path.dirname(threshold_ess._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    body = sass[sass.index("Function : ", sass.index(kernel) - 200):]
    body = body[:body.find("Function : ", 20)] if "Function : " in body[20:] else body
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        with open(os.path.join(trace_dir, f"{kernel}.sass"), "w") as fh:
            fh.write(body)
    code = [(int(a, 16), op) for a, op in _SASS_LINE.findall(body)]
    best = (0.0, 0, 0)
    for addr, op in code:
        hit = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", op)
        if hit and int(hit.group(1), 16) < addr:
            loop = [o for a, o in code if int(hit.group(1), 16) <= a <= addr]
            mufu = sum("MUFU.EX2" in o for o in loop)
            best = max(best, (mufu / len(loop), len(loop), mufu))
    return best[1], best[2]


def synthetic_state(dev):
    """The kernel's inputs at the last sweep of a short run of chip_smoke's
    phase 16 configuration."""
    _, launches, wall, args = synthetic_run(dev, synthetic_inputs(dev), burn=SYN_BURN,
                                            draws=SYN_STATE_DRAWS)
    log(f"synthetic state: {launches} sweeps in {wall:.3f} s; the kernel's plan there "
        f"{threshold_ess.launch_plan(args[0].shape[2])}")
    return args


def launcher(lib, args, c):
    """A launch of ``lib``'s kernel (None: this checkout's) on ``args``."""
    return lambda: threshold_ess._launch(*args, c, lib=lib)


def run_main_path(rm, dev, profile):
    """gpirt_mcmc on senate116; returns the kernel's inputs at the last
    sweep, and with ``profile`` the wall per sweep and the profiler."""
    first = WARM_STEPS + SMC_STEPS - 1  # the kernel call of sampling sweep 0
    stamps = {}
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])

    def before_call(i):
        s = i - first
        if s in (WALL_FROM, PROF_FROM):
            torch.cuda.synchronize()
            stamps[s] = time.perf_counter()
        if s == PROF_FROM:
            prof.start()
        if s == PROF_TO:
            prof.stop()

    _, args = observe_kernel(
        lambda: gpirt_mcmc(rm, SAMPLING, 0, CHAIN=K, SEED=SEED, smc_steps=SMC_STEPS,
                           smc_max_temp=T_MAX, dtype="float32", device=dev),
        before_call if profile else None)
    wall = None
    if profile:
        wall = (stamps[PROF_FROM] - stamps[WALL_FROM]) / (PROF_FROM - WALL_FROM) * 1e3
    return args, wall, prof


def report_profile(prof, wall_ms, smi, trace_dir):
    sweeps = PROF_TO - PROF_FROM
    rows = prof.key_averages()

    def dev_us(e):
        return e.self_device_time_total

    kernels = [e for e in rows if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in kernels) / sweeps / 1e3
    ops = sorted(((dev_us(e) / sweeps / 1e3, e.key) for e in rows
                  if e.device_type != torch.autograd.DeviceType.CUDA and dev_us(e) > 0),
                 reverse=True)
    log(f"profile on {smi}: {sweeps} sampling sweeps of {K} chains; wall "
        f"{wall_ms:.4f} ms per sweep unprofiled (sweeps {WALL_FROM}-{PROF_FROM - 1}), "
        f"device busy {busy_ms:.4f} ms per sweep ({100 * busy_ms / wall_ms:.1f}% of that wall)")
    for ms, key in ops[:14]:
        log(f"  op {key}: {ms:.4f} ms per sweep ({100 * ms / busy_ms:.1f}%)")
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        log(f"  kernel {e.key[:90]}: {dev_us(e) / sweeps / 1e3:.4f} ms per sweep, "
            f"{e.count // sweeps} per sweep")
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        with open(os.path.join(trace_dir, "sweep_profile.txt"), "w") as fh:
            fh.write(rows.table(sort_by="self_device_time_total", row_limit=60))
        prof.export_chrome_trace(os.path.join(trace_dir, "sweep_trace.json"))


def ab(other, args, label, c):
    """Times of another build and this one, in turns, on ``args``."""
    want = threshold_ess.binary_threshold_ess_reference(*args, c)
    L = want.numel()
    runs = {"other": launcher(other, args, c), "this": launcher(None, args, c)}
    for name, go in runs.items():
        over = int(((go() - want).abs() > 1e-5).sum())
        check(over <= 0.001 * L, f"{name}, {label}: {over} of {L} lanes over 1e-5")
    times = {"other": [], "this": []}
    for name in ("other", "this", "this", "other"):
        times[name].append(graph_ms(runs[name]))
    log(f"A/B, {label}: other {times['other']} ms, this {times['this']} ms; "
        f"other / this = {np.mean(times['other']) / np.mean(times['this']):.2f}")
    return times


def anatomy(args, smi, label="main path's state", first_n=(1, 25, 50)):
    """The kernel's time against the number of ll evaluations a lane."""
    g, y, t1, nu, logu, eps0, rs = args

    def timed(a):
        return graph_ms(lambda: threshold_ess.binary_threshold_ess(*a, _C))

    rounds, _ = lane_rounds(*args, _C)
    evals = 1 + float(rounds.double().mean())
    t_main = timed(args)
    t_two = timed((g, y, t1, nu, torch.full_like(logu, -float("inf")), eps0, rs))
    t_empty = timed((g, torch.zeros_like(y), t1, nu, logu, eps0, rs))
    per_ll = (t_main - t_two) / (evals - 2)
    log(f"anatomy on {smi}, {label}, T=1: {t_main:.5f} ms at "
        f"{evals:.3f} ll a lane, {t_two:.5f} ms at 2, {t_empty:.5f} ms with no "
        f"observed site; so {per_ll:.5f} ms per ll of every lane and "
        f"{t_two - 2 * per_ll:.5f} ms per launch besides")
    by_n = {}
    for n_sub in first_n:
        sub = (g[:, :, :n_sub].contiguous(), y[:, :n_sub].contiguous(), t1, nu,
               logu, eps0, rs)
        by_n[n_sub] = timed(sub)
    log(f"anatomy, the first n' respondents only: " + ", ".join(
        f"n'={k}: {v:.5f} ms" for k, v in by_n.items()))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            threshold_ess.binary_threshold_ess(*args, _C)
        torch.cuda.synchronize()
    ours = [e for e in prof.key_averages() if "ess_" in e.key]
    device_ms = sum(e.self_device_time_total for e in ours) / 20 / 1e3
    log(f"anatomy, device time of the kernel by torch.profiler: {device_ms:.5f} ms "
        f"a launch (events over a CUDA graph: {t_main:.5f} ms)")
    return {"ms": t_main, "ll_per_lane": evals, "ms_two_ll": t_two,
            "ms_no_sites": t_empty, "ms_per_ll": per_ll,
            "ms_first_n": by_n, "profiler_ms": device_ms}


def end_to_end(name, other, rm, dev, smi):
    """The main path with the sweep's kernel from ``other`` and from this
    checkout, in turns; sweeps/s of the SMC and sampling phases, and the
    sha256 of each run's draws (theta and ll of every chain)."""
    smc_sweeps = WARM_STEPS + SMC_STEPS - 1
    rates = {"other": [], "this": []}
    digests = {"other": set(), "this": set()}

    def other_kernel(*args):
        return threshold_ess._launch(*args, lib=other)

    for who in ("other", "this", "this", "other") * 4:
        out, _ = observe_kernel(
            lambda: gpirt_mcmc(rm, E2E_SWEEPS, 0, CHAIN=K, SEED=SEED,
                               smc_steps=SMC_STEPS, smc_max_temp=T_MAX,
                               dtype="float32", device=dev),
            kernel=other_kernel if who == "other" else None)
        sec = out[0]["seconds"]
        rates[who].append({"smc": smc_sweeps / sec["smc"],
                           "sampling": E2E_SWEEPS / sec["sampling"]})
        digest = hashlib.sha256()
        for d in out:
            for key in ("theta", "ll"):
                digest.update(np.ascontiguousarray(d[key]).tobytes())
        digests[who].add(digest.hexdigest())
    for phase in ("smc", "sampling"):
        runs = {w: [r[phase] for r in rates[w]] for w in rates}
        log(f"end to end on {smi}, {phase} sweeps/s: {name} "
            f"{[round(v, 1) for v in runs['other']]} (median "
            f"{np.median(runs['other']):.1f}), this "
            f"{[round(v, 1) for v in runs['this']]} (median "
            f"{np.median(runs['this']):.1f})")
    log(f"end to end, sha256 of the draws: {name} {sorted(digests['other'])}, this "
        f"{sorted(digests['this'])}; "
        f"{'the same' if digests['other'] == digests['this'] else 'they differ'}")
    return rates


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--state", choices=("main", "synthetic"), default="main")
    ap.add_argument("--other", action="append", default=[],
                    help="a kernel source to time against this one")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--end-to-end", action="store_true")
    ap.add_argument("--anatomy", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--trace-dir", help="where --profile writes its table and trace")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = card()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    threshold_ess.build()
    others = {os.path.basename(src): build_other(src) for src in opt.other}
    if opt.sass:
        instructions, mufu = site_loop_sass(opt.trace_dir)
        log(f"SASS of the tile path's site loop: {instructions} instructions, {mufu} "
            f"MUFU.EX2 (one a site): {instructions / max(mufu, 1):.1f} instructions a site")

    if opt.state == "synthetic":
        if opt.profile or opt.end_to_end:
            ap.error("--profile and --end-to-end run on --state main")
        args = synthetic_state(dev)
        work = kernel_bound(args, _C, "synthetic state")
        if opt.anatomy:
            log(json.dumps({"card": smi, "anatomy": anatomy(
                args, smi, "synthetic state", first_n=(2049, 2500, 4000))}))
        for name, other in others.items():
            result = {"card": smi, "other": name, "bound_ms": work["bound_ms"]}
            for t in (1.0, T_MAX):
                result[f"synthetic_state_T{t:g}"] = ab(
                    other, args, f"{name} vs this, synthetic state, T={t:g}", _C / np.sqrt(t))
            log(json.dumps(result))
        log(card())
        return 0

    rm, _, _ = senate116_response_matrix()
    state_args, wall_ms, prof = run_main_path(rm, dev, opt.profile)
    if opt.profile:
        report_profile(prof, wall_ms, smi, opt.trace_dir)
    if opt.anatomy:
        log(json.dumps({"card": smi, "anatomy": anatomy(state_args, smi)}))
    if others:
        y, _, _ = encode_categories(np.asarray(rm))
        y_dev = torch.as_tensor(np.ascontiguousarray(y), dtype=torch.int32, device=dev)
        rand_args = random_lanes(y_dev)
        cases = [("main_state_T1", state_args, _C)] + [
            (f"random_T{t:g}", rand_args, _C / np.sqrt(t)) for t in (1.0, T_MAX)]
        for name, other in others.items():
            result = {"card": smi, "other": name}
            for case, args, c in cases:
                result[case] = ab(other, args, f"{name} vs this, {case}", c)
            if opt.end_to_end:
                result["end_to_end"] = end_to_end(name, other, rm, dev, smi)
            log(json.dumps(result))
    log(card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
